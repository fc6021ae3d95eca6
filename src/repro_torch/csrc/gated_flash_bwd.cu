// Backward of the write-gated causal attention (gated_flash.cu) for Hopper
// (sm_90a), float32, on the tensor cores (3xTF32 mma.sync).
//
// Replaces: the gradient of src/repro/kernels/gated_flash.py::gated_flash.
// The Pallas kernel is forward-only; the reference trains through
// jax.value_and_grad of its jnp attention (src/repro/models/attention.py,
// attn_train's "gated" bias; src/repro/training/trainer.py), whose
// gradient this computes:
//
//   s_ij  = q_i . k_j / sqrt(hd) + b_ij,  b_ij = 0 if i - j < W (the window)
//           else log(g_j + eps); keys j > i masked
//   P_ij  = exp(s_ij - lse_i)             (lse from the forward, natural log)
//   D_i   = dO_i . O_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dV_j  = sum_i P_ij dO_i     dK_j = sum_i dS_ij q_i / sqrt(hd)
//   dQ_i  = sum_j dS_ij k_j / sqrt(hd)
//   dg_j  = sum_{i : i - j >= W} dS_ij / (g_j + eps)
//
// Layout: q, dO, O, dQ [Nq, S, hd]; k, v, dK, dV [Nq / G, S, hd]; g, dg
// [Nq / G, S]; lse [Nq, S]; all float32, contiguous, 16-byte aligned, hd a
// multiple of 8 and at most 128. Query stream n reads kv stream n / G
// (GQA), so dK, dV and dg sum over the G query streams of their kv stream.
//
// What bounds it on this card: operations. Per causal (query, key) pair
// the gradient needs the scores again (2 hd FLOPs) and dO V^T, dV, dK and
// dQ (2 hd each): 10 hd FLOPs against one read of q, k, v, g, O, lse, dO
// and one write of the gradients, some 2,500 FLOPs per byte at S 2048,
// hd 128; the two kernels below recompute S and dO V^T each, 14 hd. In f32
// on the CUDA cores (67 TFLOP/s) 14 hd FLOPs per pair cannot come within
// 3.4x of the bound at the card's f32 product rate (3xTF32, 495/3 TFLOP/s).
// What the design does about it:
// - Every product runs on mma.sync m16n8k8 in 3xTF32 (flash_mma.cuh's
//   split and mma_3xtf32; within 1e-4 of each gradient's max, where one
//   TF32 pass is not: tests/test_torch_bwd_split.py). A warp owns 16 rows
//   of its products (keys in kernel A, queries in kernel B). S and dO V^T
//   land in accumulator registers, P and dS are formed there, and feed the
//   next products straight from the accumulators as A fragments: the
//   eight columns of a k-step are read in the order (0, 2, 4, 6 | 1, 3, 5,
//   7), so a0..a3 are c0, c2, c1, c3, and the B operand's rows are read in
//   the same order (the forward's P V, flash_mma.cuh).
// - Three kernels, no atomics, each output written once. A prep pass
//   writes D and log2(g + eps), the latter into dg, which kernel A
//   overwrites last. Kernel B, one CTA per (query stream, 128 rows), walks
//   the key tiles up to the diagonal: S = Q K^T, dP = dO V^T, dS, dQ +=
//   dS K. Kernel A, one CTA per (kv stream, 128 keys), walks the G query
//   streams of its kv stream and their 32-row tiles from the diagonal on:
//   S^T = K Q^T, dP^T = V dO^T, P^T and dS^T, dV += P^T dO, dK += dS^T Q;
//   dg is a row sum of dS^T over the pairs outside the window, per thread
//   in walk order, then quad shuffles, divided by g + eps once at the end.
// - K and V (kernel A) and Q and dO (kernel B) stay in shared memory for
//   the CTA; the walked tiles (Q, dO, lse, D; K, V, log2 g) come through a
//   two-stage cp.async ring while the current one is multiplied. Rows are
//   padded to hd + 4 floats, so every fragment load is free of bank
//   conflicts. dK and dV for 16 keys at hd 128 take 128 registers a
//   thread, so operands are read from shared memory and split per use.
// - Masks only where needed, as the forward does: per warp and tile, a
//   block wholly outside the window takes the bias log2(g_j + eps) with no
//   compare, one wholly inside takes no bias and gives no dg, and only the
//   blocks on the diagonal or across i - j = W run the per-pair mask. One
//   pair function (pair_grad) serves both kernels, so they see the same
//   masks. Blocks above the diagonal are skipped.
// - The costliest CTAs launch first (kernel A key tile 0, kernel B the
//   last query tile). At the train shape (S 2048, 16 kv streams, G 2) one
//   CTA per SM in that order keeps 97 % of the ideal balance, so the query
//   walk is not split.
// - hd 64 and 128 (qwen3-0.6b's) run kernels with hd fixed at compile
//   time, so the unrolled loops over hd carry no tests; any other hd up to
//   128 runs the same code with hd at run time. Kernel A at hd 128 holds
//   dK and dV for its 16 keys in 128 registers a thread; with 8 warps and
//   one CTA per SM (about 200 KB of shared memory) nothing spills.
// - Every sum runs in a fixed order: two calls give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using mma::load_a;
using mma::load_kfrag;
using mma::mma_3xtf32;
using mma::split;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;  // cp.async ring
constexpr float LOG2E = 1.4426950408889634f;

template <int HDMAX>
struct Cfg {
  static constexpr int LD = HDMAX + 4;  // smem row (floats), 4 mod 32
  static constexpr int KS = HDMAX / 8;  // k-steps over hd; n-tiles of dK, dV, dQ
  // kernel A: keys per CTA (16 a warp), queries per ring stage; a stage
  // holds Q and dO rows, lse and D
  static constexpr int A_BK = 16 * WARPS;
  static constexpr int A_BQ = 32;
  static constexpr int A_STAGE = 2 * A_BQ * LD + 2 * A_BQ;
  // kernel B: query rows per CTA (16 a warp), keys per ring stage; a stage
  // holds K and V rows and log2(g + eps)
  static constexpr int B_BQ = 16 * WARPS;
  static constexpr int B_BK = 32;
  static constexpr int B_STAGE = 2 * B_BK * LD + B_BK;
  static constexpr size_t smem_a() {
    return (size_t)(2 * A_BK * LD + A_BK + STAGES * A_STAGE) * sizeof(float);
  }
  static constexpr size_t smem_b() {
    return (size_t)(2 * B_BQ * LD + STAGES * B_STAGE) * sizeof(float);
  }
};

// D[n, i] = dO[n, i] . O[n, i], one warp per row; and logg[e] = log2(g[e]
// + eps) for the kv rows (kv <= rows, so the grid covers them).
__global__ void __launch_bounds__(THREADS)
bwd_prep_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                float* __restrict__ dvec, long long rows, int hd,
                const float* __restrict__ g, float* __restrict__ logg,
                long long kv, float eps) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e < kv) logg[e] = log2f(g[e] + eps);
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* a = dout + row * hd;
  const float* b = out + row * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(a[d], b[d], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) dvec[row] = s;
}

// Rows p0 .. p0 + n of stream `stream` of x [*, S, hd] into dst [n][LD] by
// cp.async, zeros past S. The caller commits.
template <int LD>
__device__ __forceinline__ void copy_rows(float* dst, const float* x, size_t stream,
                                          int p0, int n, int S, int hd) {
  const int cpr = hd / 4;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < n * cpr; e += THREADS) {
    const int r = e / cpr;
    const int c = e - r * cpr;
    const bool ok = p0 + r < S;
    const float* src = x + (stream * S + (ok ? p0 + r : 0)) * hd + 4 * c;
    async_copy::cp16_zfill(dst + r * LD + 4 * c, src, ok);
  }
}

// x[stream, p0 .. p0 + n] of x [*, S] into dst by cp.async, zeros past S.
__device__ __forceinline__ void copy_vec(float* dst, const float* x, size_t stream,
                                         int p0, int n, int S) {
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const bool ok = p0 + e < S;
    async_copy::cp4_zfill(dst + e, x + stream * S + (ok ? p0 + e : 0), ok);
  }
}

// ---- masks ----------------------------------------------------------------
enum Mode { INSIDE, OUTSIDE, EDGE };

// The mask a block of pairs needs: query rows i0 .. i0 + ni (those < S
// live), keys j0 .. j0 + nj. -1 if no pair is live (every key above the
// diagonal, or no live row).
__device__ __forceinline__ int block_mode(int i0, int ni, int j0, int nj, int S, int W) {
  const int i_last = min(i0 + ni, S) - 1;
  if (i_last < j0) return -1;
  const bool full = i0 + ni <= S;
  const int dmin = i0 - (j0 + nj - 1);  // least i - j
  if (full && dmin >= W) return OUTSIDE;
  if (full && dmin >= 0 && i_last - j0 < W) return INSIDE;
  return EDGE;
}

// P and dS of pair (i, j) from its scaled score s (base 2, without the
// bias) and dO . v_j (dp): zero above the diagonal and past S. `outside`
// says whether the pair is outside the window, where the bias
// log2(g_j + eps) (logg2) applies and dg reads dS. lse2: the row's lse in
// base 2. MODE is the block's mask: INSIDE and OUTSIDE compare nothing.
struct Pair {
  float p, ds;
  bool outside;
};

template <int MODE>
__device__ __forceinline__ Pair pair_grad(float s, float dp, int i, int j, int S, int W,
                                          float logg2, float lse2, float dd) {
  Pair r{0.f, 0.f, MODE == OUTSIDE};
  if (MODE == EDGE) {
    if (i >= S || j > i) return r;
    r.outside = i - j >= W;
  }
  r.p = exp2f(s + (r.outside ? logg2 : 0.f) - lse2);
  r.ds = r.p * (dp - dd);
  return r;
}

// Kernel A's block: S^T and dP^T accumulators (rows keys kw + g, + 8;
// columns queries qb + 8 nt + 2t + e) become P^T and dS^T; dgp sums dS^T
// over the pairs outside the window, per row.
template <int MODE, int NT>
__device__ __forceinline__ void kv_block(float (&st)[NT][4], float (&dpt)[NT][4],
                                         float (&dgp)[2], int qb, int kw, int lane,
                                         int S, int W, float scale2,
                                         const float* lse_s, const float* d_s,
                                         const float (&lg)[2]) {
  const int gq = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int il = nt * 8 + 2 * tq + e;
      const float l2 = lse_s[il] * LOG2E;
      const float dd = d_s[il];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Pair pr = pair_grad<MODE>(st[nt][2 * h + e] * scale2, dpt[nt][2 * h + e],
                                        qb + il, kw + gq + 8 * h, S, W, lg[h], l2, dd);
        st[nt][2 * h + e] = pr.p;
        dpt[nt][2 * h + e] = pr.ds;
        if (pr.outside) dgp[h] += pr.ds;
      }
    }
  }
}

// Kernel B's block: S and dP accumulators (rows queries i0, i0 + 8;
// columns keys kb + 8 nt + 2t + e) become dS, in sc.
template <int MODE, int NT>
__device__ __forceinline__ void q_block(float (&sc)[NT][4], const float (&dp)[NT][4],
                                        int i0, int kb, int lane, int S, int W,
                                        float scale2, const float* lg_s,
                                        const float (&l2)[2], const float (&dd)[2]) {
  const int tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jl = nt * 8 + 2 * tq + e;
      const float lg = lg_s[jl];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sc[nt][2 * h + e] = pair_grad<MODE>(sc[nt][2 * h + e] * scale2, dp[nt][2 * h + e],
                                            i0 + 8 * h, kb + jl, S, W, lg, l2[h], dd[h]).ds;
    }
  }
}

// acc[nt] += A B for the NO n-tiles of hd: A the NT k-steps of a tile
// (split fragments), B rows [8 NT][LD] in shared memory, read per k-step in
// the order (0, 2, 4, 6 | 1, 3, 5, 7) that A's fragments came in. Each
// n-tile is summed over the tile in fresh accumulators and added in f32:
// the tensor cores truncate what they add to an accumulator, an error that
// grows with the walk when thousands of rows go into one running sum.
// ADD_GROUP n-tiles at a time, each into two accumulators (the 3xTF32
// terms' hi hi and the small ones), so that independent chains of products
// are in flight (1, 2, 4 or 8 n-tiles into one accumulator each were
// slower in one call of an exploratory comparison on the card).
constexpr int ADD_GROUP = 2;

template <int NT, int NO, int LD>
__device__ __forceinline__ void add_product(float (&acc)[NO][4], const uint32_t (&ah)[NT][4],
                                            const uint32_t (&al)[NT][4], const float* b,
                                            int hd, int lane) {
  const float* br = b + 2 * (lane & 3) * LD + (lane >> 2);
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += ADD_GROUP) {
    if (n0 * 8 >= hd) break;
    float t[ADD_GROUP][4], ts[ADD_GROUP][4];
#pragma unroll
    for (int j = 0; j < ADD_GROUP; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[j][e] = ts[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
#pragma unroll
      for (int j = 0; j < ADD_GROUP; ++j) {
        const int nt = n0 + j;
        if (nt < NO && nt * 8 < hd) {
          const float bv[2] = {br[kk * 8 * LD + nt * 8], br[(kk * 8 + 1) * LD + nt * 8]};
          uint32_t bh[2], bl[2];
          split(bv, bh, bl);
          mma_3xtf32(t[j], ts[j], ah[kk], al[kk], bh, bl);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ADD_GROUP; ++j)
      if (n0 + j < NO && (n0 + j) * 8 < hd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + j][e] += ts[j][e] + t[j][e];
  }
}

// The A fragments of k-step kk of a tile from its accumulators: columns
// (0, 2, 4, 6 | 1, 3, 5, 7), so a0..a3 are c0, c2, c1, c3; split.
template <int NT>
__device__ __forceinline__ void acc_frags(const float (&c)[NT][4], uint32_t (&ah)[NT][4],
                                          uint32_t (&al)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    const float a[4] = {c[kk][0], c[kk][2], c[kk][1], c[kk][3]};
    split(a, ah[kk], al[kk]);
  }
}

// Kernel A: one CTA per (kv stream, A_BK keys); dK, dV and dg of its keys.
// `dg` holds log2(g + eps) on entry (the prep pass) and the gradient on
// exit; a CTA reads and writes its own keys only. EXACT: hd is HDMAX, known
// at compile time, so the loops over hd carry no tests.
template <int HDMAX, bool EXACT>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ dout,
              const float* __restrict__ dvec, float* __restrict__ dk,
              float* __restrict__ dv, float* dg, int S, int hd_, int W, int G,
              float eps) {
  using C = Cfg<HDMAX>;
  const int hd = EXACT ? HDMAX : hd_;
  constexpr int LD = C::LD;
  constexpr int BK = C::A_BK;
  constexpr int BQ = C::A_BQ;
  constexpr int NT = BQ / 8;  // n-tiles of S^T; k-steps of dV, dK
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;            // [BK][LD]
  float* v_s = k_s + BK * LD;   // [BK][LD]
  float* lg_s = v_s + BK * LD;  // [BK] log2(g + eps)
  float* ring = lg_s + BK;      // STAGES x {Q, dO [BQ][LD]; lse, D [BQ]}

  const int nk = blockIdx.x;
  const int kb = blockIdx.y * BK;  // key tile 0, the costliest, first
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int kw = kb + 16 * warp;               // the warp's first key
  const int nqt = (S - kb + BQ - 1) / BQ;      // query tiles from the diagonal on
  const int tiles = G * nqt;

  // query tile t of the walk (stream gi of the group, rows qb ..) into stage st
  auto load = [&](int t, int st) {
    const int gi = t / nqt;
    const int qb = kb + (t - gi * nqt) * BQ;
    const size_t n = (size_t)nk * G + gi;
    float* qs = ring + st * C::A_STAGE;
    copy_rows<LD>(qs, q, n, qb, BQ, S, hd);
    copy_rows<LD>(qs + BQ * LD, dout, n, qb, BQ, S, hd);
    copy_vec(qs + 2 * BQ * LD, lse, n, qb, BQ, S);
    copy_vec(qs + 2 * BQ * LD + BQ, dvec, n, qb, BQ, S);
  };

  copy_rows<LD>(k_s, k, nk, kb, BK, S, hd);
  copy_rows<LD>(v_s, v, nk, kb, BK, S, hd);
  copy_vec(lg_s, dg, nk, kb, BK, S);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < tiles) load(st, st);
    async_copy::commit();
  }

  float dka[C::KS][4], dva[C::KS][4];
#pragma unroll
  for (int nt = 0; nt < C::KS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;
  float dgp[2] = {0.f, 0.f};
  const float scale2 = LOG2E / sqrtf((float)hd);
  const float* krow = k_s + (16 * warp + gq) * LD + tq;
  const float* vrow = v_s + (16 * warp + gq) * LD + tq;

  for (int t = 0; t < tiles; ++t) {
    async_copy::wait<STAGES - 2>();
    __syncthreads();  // tile t landed; the stage of tile t - 1 is free
    if (t + STAGES - 1 < tiles) load(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    async_copy::commit();
    const int gi = t / nqt;
    const int qb = kb + (t - gi * nqt) * BQ;
    const int mode = block_mode(qb, BQ, kw, 16, S, W);
    if (mode < 0) continue;
    const float* qs = ring + (t % STAGES) * C::A_STAGE;
    const float* dos = qs + BQ * LD;
    const float* lse_s = dos + BQ * LD;
    const float* d_s = lse_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      if (ks * 8 >= hd) break;
      float a[4];
      uint32_t kh[4], kl[4], vh[4], vl[4];
      load_a<LD>(a, krow + ks * 8);
      split(a, kh, kl);
      load_a<LD>(a, vrow + ks * 8);
      split(a, vh, vl);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float b[2];
        uint32_t bh[2], bl[2];
        load_kfrag(b, qs + (nt * 8 + gq) * LD + ks * 8 + tq);
        split(b, bh, bl);
        mma_3xtf32(st[nt], kh, kl, bh, bl);
        load_kfrag(b, dos + (nt * 8 + gq) * LD + ks * 8 + tq);
        split(b, bh, bl);
        mma_3xtf32(dpt[nt], vh, vl, bh, bl);
      }
    }

    // P^T and dS^T (and dg) under the block's mask
    const float lg[2] = {lg_s[16 * warp + gq], lg_s[16 * warp + gq + 8]};
    if (mode == OUTSIDE)
      kv_block<OUTSIDE>(st, dpt, dgp, qb, kw, lane, S, W, scale2, lse_s, d_s, lg);
    else if (mode == INSIDE)
      kv_block<INSIDE>(st, dpt, dgp, qb, kw, lane, S, W, scale2, lse_s, d_s, lg);
    else
      kv_block<EDGE>(st, dpt, dgp, qb, kw, lane, S, W, scale2, lse_s, d_s, lg);

    // dV += P^T dO, then dK += dS^T Q
    {
      uint32_t ah[NT][4], al[NT][4];
      acc_frags(st, ah, al);
      add_product<NT, C::KS, LD>(dva, ah, al, dos, hd, lane);
    }
    {
      uint32_t ah[NT][4], al[NT][4];
      acc_frags(dpt, ah, al);
      add_product<NT, C::KS, LD>(dka, ah, al, qs, hd, lane);
    }
  }
  async_copy::wait<0>();

  const float dscale = 1.f / sqrtf((float)hd);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = kw + gq + 8 * h;
    if (j < S) {
      float* dkr = dk + ((size_t)nk * S + j) * hd + 2 * tq;
      float* dvr = dv + ((size_t)nk * S + j) * hd + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < C::KS; ++nt) {
        if (nt * 8 >= hd) break;
        mma::store2<float>(dkr + nt * 8, dka[nt][2 * h] * dscale, dka[nt][2 * h + 1] * dscale);
        mma::store2<float>(dvr + nt * 8, dva[nt][2 * h], dva[nt][2 * h + 1]);
      }
    }
    float x = dgp[h];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (tq == 0 && j < S) dg[(size_t)nk * S + j] = x / (g[(size_t)nk * S + j] + eps);
  }
}

// Kernel B: one CTA per (query stream, B_BQ rows); dQ of its rows. logg:
// log2(g + eps) [Nq / G, S] from the prep pass. EXACT as in kernel A.
template <int HDMAX, bool EXACT>
__global__ void __launch_bounds__(THREADS, 1)
bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ logg,
             const float* __restrict__ lse, const float* __restrict__ dout,
             const float* __restrict__ dvec, float* __restrict__ dq, int S,
             int hd_, int W, int G) {
  using C = Cfg<HDMAX>;
  const int hd = EXACT ? HDMAX : hd_;
  constexpr int LD = C::LD;
  constexpr int BQ = C::B_BQ;
  constexpr int BK = C::B_BK;
  constexpr int NT = BK / 8;  // n-tiles of S; k-steps of dQ
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;            // [BQ][LD]
  float* do_s = q_s + BQ * LD;  // [BQ][LD]
  float* ring = do_s + BQ * LD; // STAGES x {K, V [BK][LD]; log2(g + eps) [BK]}

  const int n = blockIdx.x;
  const int nk = n / G;
  const int qb = (gridDim.y - 1 - blockIdx.y) * BQ;  // costliest first
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int qw = qb + 16 * warp;  // the warp's first row
  const int tiles = (min(qb + BQ, S) - 1) / BK + 1;  // key tiles to the diagonal

  auto load = [&](int t, int st) {
    float* ks = ring + st * C::B_STAGE;
    copy_rows<LD>(ks, k, nk, t * BK, BK, S, hd);
    copy_rows<LD>(ks + BK * LD, v, nk, t * BK, BK, S, hd);
    copy_vec(ks + 2 * BK * LD, logg, nk, t * BK, BK, S);
  };

  copy_rows<LD>(q_s, q, n, qb, BQ, S, hd);
  copy_rows<LD>(do_s, dout, n, qb, BQ, S, hd);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < tiles) load(st, st);
    async_copy::commit();
  }

  // the lane's rows i0 and i0 + 8: lse in base 2 and D
  const int i0 = qw + gq;
  float l2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 8 * h;
    l2[h] = i < S ? lse[(size_t)n * S + i] * LOG2E : 0.f;
    dd[h] = i < S ? dvec[(size_t)n * S + i] : 0.f;
  }
  float dqa[C::KS][4];
#pragma unroll
  for (int nt = 0; nt < C::KS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.f;
  const float scale2 = LOG2E / sqrtf((float)hd);
  const float* qrow = q_s + (16 * warp + gq) * LD + tq;
  const float* dorow = do_s + (16 * warp + gq) * LD + tq;

  for (int t = 0; t < tiles; ++t) {
    async_copy::wait<STAGES - 2>();
    __syncthreads();  // tile t landed; the stage of tile t - 1 is free
    if (t + STAGES - 1 < tiles) load(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    async_copy::commit();
    const int kb = t * BK;
    const int mode = block_mode(qw, 16, kb, BK, S, W);
    if (mode < 0) continue;
    const float* ks = ring + (t % STAGES) * C::B_STAGE;
    const float* vs = ks + BK * LD;
    const float* lg_s = vs + BK * LD;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < C::KS; ++kd) {
      if (kd * 8 >= hd) break;
      float a[4];
      uint32_t qh[4], ql[4], oh[4], ol[4];
      load_a<LD>(a, qrow + kd * 8);
      split(a, qh, ql);
      load_a<LD>(a, dorow + kd * 8);
      split(a, oh, ol);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float b[2];
        uint32_t bh[2], bl[2];
        load_kfrag(b, ks + (nt * 8 + gq) * LD + kd * 8 + tq);
        split(b, bh, bl);
        mma_3xtf32(sc[nt], qh, ql, bh, bl);
        load_kfrag(b, vs + (nt * 8 + gq) * LD + kd * 8 + tq);
        split(b, bh, bl);
        mma_3xtf32(dp[nt], oh, ol, bh, bl);
      }
    }

    // dS under the block's mask
    if (mode == OUTSIDE)
      q_block<OUTSIDE>(sc, dp, i0, kb, lane, S, W, scale2, lg_s, l2, dd);
    else if (mode == INSIDE)
      q_block<INSIDE>(sc, dp, i0, kb, lane, S, W, scale2, lg_s, l2, dd);
    else
      q_block<EDGE>(sc, dp, i0, kb, lane, S, W, scale2, lg_s, l2, dd);

    // dQ += dS K
    uint32_t ah[NT][4], al[NT][4];
    acc_frags(sc, ah, al);
    add_product<NT, C::KS, LD>(dqa, ah, al, ks, hd, lane);
  }
  async_copy::wait<0>();

  const float dscale = 1.f / sqrtf((float)hd);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 8 * h;
    if (i >= S) continue;
    float* dqr = dq + ((size_t)n * S + i) * hd + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < C::KS; ++nt) {
      if (nt * 8 >= hd) break;
      mma::store2<float>(dqr + nt * 8, dqa[nt][2 * h] * dscale, dqa[nt][2 * h + 1] * dscale);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

template <int HDMAX, bool EXACT>
int launch(const float* q, const float* k, const float* v, const float* g,
           const float* lse, const float* dout, const float* dvec, float* dq,
           float* dk, float* dv, float* dg, int Nq, int S, int hd, int W, int G,
           float eps, cudaStream_t st) {
  using C = Cfg<HDMAX>;
  const int tiles_a = (S + C::A_BK - 1) / C::A_BK;
  const int tiles_b = (S + C::B_BQ - 1) / C::B_BQ;
  if (tiles_a > 65535 || tiles_b > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_smem(bwd_q_kernel<HDMAX, EXACT>, C::smem_b());
  if (err != cudaSuccess) return (int)err;
  err = set_smem(bwd_kv_kernel<HDMAX, EXACT>, C::smem_a());
  if (err != cudaSuccess) return (int)err;
  // B first: it reads log2(g + eps) from dg, which A then overwrites
  bwd_q_kernel<HDMAX, EXACT><<<dim3(Nq, tiles_b), THREADS, C::smem_b(), st>>>(
      q, k, v, dg, lse, dout, dvec, dq, S, hd, W, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_kv_kernel<HDMAX, EXACT><<<dim3(Nq / G, tiles_a), THREADS, C::smem_a(), st>>>(
      q, k, v, g, lse, dout, dvec, dk, dv, dg, S, hd, W, G, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory (bytes) of kernel A (which 0) or B (which 1) at
// head dim hd.
extern "C" long long gated_flash_bwd_smem_bytes(int hd, int which) {
  if (hd <= 64) return (long long)(which ? Cfg<64>::smem_b() : Cfg<64>::smem_a());
  return (long long)(which ? Cfg<128>::smem_b() : Cfg<128>::smem_a());
}

// Gradients of gated_flash (float32): dq [Nq, S, hd], dk and dv [Nq / G,
// S, hd], dg [Nq / G, S] from q, k, v, g, the forward's output o and lse,
// and do; dvec [Nq, S] is scratch for D. Returns cudaGetLastError() after
// the launches (0 = launched).
extern "C" int gated_flash_bwd(const float* q, const float* k, const float* v,
                               const float* g, const float* o, const float* lse,
                               const float* dout, float* dq, float* dk, float* dv,
                               float* dg, float* dvec, int Nq, int S, int hd, int W,
                               int G, float eps, void* stream) {
  if (Nq <= 0 || S <= 0) return 0;
  if (hd <= 0 || hd > 128 || hd % 8 != 0 || G <= 0 || Nq % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)Nq * S;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_prep_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(dout, o, dvec, rows, hd, g, dg,
                                                        (long long)(Nq / G) * S, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // hd 64 and 128 (qwen3-0.6b's) take kernels with hd fixed at compile time
  if (hd == 64)
    return launch<64, true>(q, k, v, g, lse, dout, dvec, dq, dk, dv, dg, Nq, S, hd, W, G, eps, st);
  if (hd < 64)
    return launch<64, false>(q, k, v, g, lse, dout, dvec, dq, dk, dv, dg, Nq, S, hd, W, G, eps, st);
  if (hd == 128)
    return launch<128, true>(q, k, v, g, lse, dout, dvec, dq, dk, dv, dg, Nq, S, hd, W, G, eps, st);
  return launch<128, false>(q, k, v, g, lse, dout, dvec, dq, dk, dv, dg, Nq, S, hd, W, G, eps, st);
}
