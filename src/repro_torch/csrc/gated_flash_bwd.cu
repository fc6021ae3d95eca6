// Backward of the write-gated causal attention (gated_flash.cu) for Hopper
// (sm_90a), float32, on the CUDA cores.
//
// Replaces: the gradient of src/repro/kernels/gated_flash.py::gated_flash.
// The Pallas kernel is forward-only; the reference trains through
// jax.value_and_grad of its jnp attention (src/repro/models/attention.py,
// attn_train's "gated" bias), whose gradient this computes:
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
// [Nq / G, S]; lse [Nq, S]; all float32, contiguous, hd a multiple of 8
// and at most 128. Query stream n reads kv stream n / G (GQA), so dK, dV
// and dg sum over the G query streams of their kv stream.
//
// What bounds it on this card: operations. Per causal (query, key) pair
// the gradient needs the scores again (2 hd FLOPs) and dO V^T, dV, dK and
// dQ (2 hd each): 10 hd FLOPs against one read of q, k, v, g, O, lse, dO
// and one write of the gradients, some 2,500 FLOPs per byte at S 2048,
// hd 128.
// What the design does about it (a first, simple version; tensor cores,
// wgmma and TMA are later work):
// - Three kernels, no atomics, each output written once: D (one warp per
//   row); kernel A, one CTA per (kv stream, 64-key tile), walks the G
//   query streams of its kv stream and their 64-row query tiles at or
//   below the diagonal and accumulates dK, dV and dg in registers; kernel
//   B, one CTA per (query stream, 64-row tile), walks the key tiles up to
//   the diagonal and accumulates dQ. Both recompute the scores and P, the
//   same masks in both.
// - Register tiles: a thread holds a 4 x 4 block of the 64 x 64 score
//   tile (rows t, t + 16, ...; interleaved so a warp's loads hit distinct
//   banks or broadcast) and a 4 x (hd / 16) block of its outputs. Tiles
//   live in shared memory with rows padded to hd + 1 floats.
// - Tiles above the diagonal are skipped; the costliest CTAs launch first.
// - dg is a column sum of dS over the rows outside the window, reduced in
//   a fixed order through shared memory: two calls give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BT = 64;        // query rows and keys per tile
constexpr int LDP = BT + 1;   // P / dS tile row (floats)

template <int HDMAX>
struct Smem {
  static constexpr int LD = HDMAX + 1;  // q, k, v, dO tile rows (floats)
  static constexpr int TILE = BT * LD;
};

// D[n, i] = dO[n, i] . O[n, i], one warp per row.
__global__ void __launch_bounds__(THREADS)
bwd_dot_kernel(const float* __restrict__ dout, const float* __restrict__ out,
               float* __restrict__ dvec, long long rows, int hd) {
  const long long row = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
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

// Rows p0 .. p0 + BT of stream `stream` of x [*, S, hd] into dst [BT][LD],
// zeros past S.
template <int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* x, int stream,
                                          int p0, int S, int hd) {
  const int c4 = hd / 4;
  for (int e = threadIdx.x; e < BT * c4; e += THREADS) {
    const int r = e / c4;
    const int c = e - r * c4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p0 + r < S)
      val = __ldg(reinterpret_cast<const float4*>(x + ((size_t)stream * S + p0 + r) * hd) + c);
    float* o = dst + r * LD + 4 * c;
    o[0] = val.x;
    o[1] = val.y;
    o[2] = val.z;
    o[3] = val.w;
  }
}

// The scores and dO V^T of a 64 x 64 tile: thread (tq, tk) holds rows
// tq + 16 a and keys tk + 16 b (a, b < 4).
template <int LD>
__device__ __forceinline__ void tile_products(const float* qs, const float* ks,
                                              const float* dos, const float* vs,
                                              int hd, int tq, int tk,
                                              float (&s)[4][4], float (&dp)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float qv[4], kv[4], ov[4], vv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = qs[(tq + 16 * a) * LD + d];
      ov[a] = dos[(tq + 16 * a) * LD + d];
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      kv[b] = ks[(tk + 16 * b) * LD + d];
      vv[b] = vs[(tk + 16 * b) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = fmaf(qv[a], kv[b], s[a][b]);
        dp[a][b] = fmaf(ov[a], vv[b], dp[a][b]);
      }
  }
}

// P and dS of pair (i, j) from its score product s and dO . v_j (dp):
// zero above the diagonal and past S. `outside` says whether the pair is
// outside the window, where the bias log(g_j + eps) applies and dg reads dS.
struct Pair {
  float p, ds;
  bool outside;
};

__device__ __forceinline__ Pair pair_grad(float s, float dp, int i, int j, int S, int W,
                                          float scale, float logg, float lse, float dd) {
  Pair r{0.f, 0.f, false};
  if (i < S && j <= i) {
    r.outside = i - j >= W;
    const float logit = s * scale + (r.outside ? logg : 0.f);
    r.p = expf(logit - lse);
    r.ds = r.p * (dp - dd);
  }
  return r;
}

// Kernel A: one CTA per (kv stream, key tile); dK, dV and dg of its keys.
template <int HDMAX>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ dout,
              const float* __restrict__ dvec, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ dg, int S, int hd,
              int W, int G, float eps, float scale) {
  using C = Smem<HDMAX>;
  constexpr int LD = C::LD;
  constexpr int NC = HDMAX / 16;  // output dims per thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [BT][LD]
  float* vs = ks + C::TILE;
  float* qs = vs + C::TILE;
  float* dos = qs + C::TILE;
  float* ps = dos + C::TILE;      // [BT][LDP]
  float* dss = ps + BT * LDP;     // [BT][LDP]
  float* red = dss + BT * LDP;    // [16][BT] column partials of dS
  float* lse_s = red + 16 * BT;   // [BT]
  float* d_s = lse_s + BT;        // [BT]
  float* logg_s = d_s + BT;       // [BT]

  const int nk = blockIdx.x;
  const int kb = blockIdx.y * BT;  // key tile 0, the costliest, first
  const int tid = threadIdx.x;
  const int t16 = tid & 15;
  const int h16 = tid >> 4;

  load_tile<LD>(ks, k, nk, kb, S, hd);
  load_tile<LD>(vs, v, nk, kb, S, hd);
  if (tid < BT) {
    const int j = kb + tid;
    logg_s[tid] = j < S ? logf(g[(size_t)nk * S + j] + eps) : 0.f;
  }

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[b][c] = dva[b][c] = 0.f;
  float dga = 0.f;  // key kb + tid, for tid < BT

  for (int gi = 0; gi < G; ++gi) {
    const int n = nk * G + gi;
    for (int qb = kb; qb < S; qb += BT) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<LD>(qs, q, n, qb, S, hd);
      load_tile<LD>(dos, dout, n, qb, S, hd);
      if (tid < BT) {
        const int i = qb + tid;
        lse_s[tid] = i < S ? lse[(size_t)n * S + i] : 0.f;
        d_s[tid] = i < S ? dvec[(size_t)n * S + i] : 0.f;
      }
      __syncthreads();

      // scores, P and dS: thread (tq = h16, tk = t16)
      float s[4][4], dp[4][4];
      tile_products<LD>(qs, ks, dos, vs, hd, h16, t16, s, dp);
      float colpart[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int il = h16 + 16 * a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int jl = t16 + 16 * b;
          const Pair pr = pair_grad(s[a][b], dp[a][b], qb + il, kb + jl, S, W, scale,
                                    logg_s[jl], lse_s[il], d_s[il]);
          ps[il * LDP + jl] = pr.p;
          dss[il * LDP + jl] = pr.ds;
          if (pr.outside) colpart[b] += pr.ds;
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) red[h16 * BT + t16 + 16 * b] = colpart[b];
      __syncthreads();

      // dg: column sums of dS outside the window, in row-group order
      if (tid < BT) {
#pragma unroll
        for (int r = 0; r < 16; ++r) dga += red[r * BT + tid];
      }
      // dV += P^T dO, dK += dS^T Q: thread keys t16 + 16 b, dims h16 + 16 c
      const int rows = min(BT, S - qb);
      for (int i = 0; i < rows; ++i) {
        float pv[4], sv[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          pv[b] = ps[i * LDP + t16 + 16 * b];
          sv[b] = dss[i * LDP + t16 + 16 * b];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float ov = dos[i * LD + h16 + 16 * c];
          const float qv = qs[i * LD + h16 + 16 * c];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            dva[b][c] = fmaf(pv[b], ov, dva[b][c]);
            dka[b][c] = fmaf(sv[b], qv, dka[b][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int j = kb + t16 + 16 * b;
    if (j >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = h16 + 16 * c;
      if (d < hd) {
        dk[((size_t)nk * S + j) * hd + d] = dka[b][c] * scale;
        dv[((size_t)nk * S + j) * hd + d] = dva[b][c];
      }
    }
  }
  if (tid < BT && kb + tid < S) {
    const int j = kb + tid;
    dg[(size_t)nk * S + j] = dga / (g[(size_t)nk * S + j] + eps);
  }
}

// Kernel B: one CTA per (query stream, query tile); dQ of its rows.
template <int HDMAX>
__global__ void __launch_bounds__(THREADS, 1)
bwd_q_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ g,
             const float* __restrict__ lse, const float* __restrict__ dout,
             const float* __restrict__ dvec, float* __restrict__ dq, int S,
             int hd, int W, int G, float eps, float scale) {
  using C = Smem<HDMAX>;
  constexpr int LD = C::LD;
  constexpr int NC = HDMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [BT][LD]
  float* dos = qs + C::TILE;
  float* ks = dos + C::TILE;
  float* vs = ks + C::TILE;
  float* dss = vs + C::TILE;      // [BT][LDP]
  float* lse_s = dss + BT * LDP;  // [BT]
  float* d_s = lse_s + BT;        // [BT]
  float* logg_s = d_s + BT;       // [BT]

  const int n = blockIdx.x;
  const int nk = n / G;
  const int qb = (gridDim.y - 1 - blockIdx.y) * BT;  // costliest first
  const int tid = threadIdx.x;
  const int t16 = tid & 15;
  const int h16 = tid >> 4;

  load_tile<LD>(qs, q, n, qb, S, hd);
  load_tile<LD>(dos, dout, n, qb, S, hd);
  if (tid < BT) {
    const int i = qb + tid;
    lse_s[tid] = i < S ? lse[(size_t)n * S + i] : 0.f;
    d_s[tid] = i < S ? dvec[(size_t)n * S + i] : 0.f;
  }

  float dqa[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dqa[a][c] = 0.f;

  const int q_last = min(qb + BT, S) - 1;
  for (int kb = 0; kb <= q_last; kb += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<LD>(ks, k, nk, kb, S, hd);
    load_tile<LD>(vs, v, nk, kb, S, hd);
    if (tid < BT) {
      const int j = kb + tid;
      logg_s[tid] = j < S ? logf(g[(size_t)nk * S + j] + eps) : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_products<LD>(qs, ks, dos, vs, hd, h16, t16, s, dp);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = h16 + 16 * a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jl = t16 + 16 * b;
        const Pair pr = pair_grad(s[a][b], dp[a][b], qb + il, kb + jl, S, W, scale,
                                  logg_s[jl], lse_s[il], d_s[il]);
        dss[il * LDP + jl] = pr.ds;
      }
    }
    __syncthreads();

    // dQ += dS K: thread rows t16 + 16 a, dims h16 + 16 c
    const int keys = min(BT, S - kb);
    for (int j = 0; j < keys; ++j) {
      float sv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = dss[(t16 + 16 * a) * LDP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = ks[j * LD + h16 + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) dqa[a][c] = fmaf(sv[a], kv, dqa[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = qb + t16 + 16 * a;
    if (i >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = h16 + 16 * c;
      if (d < hd) dq[((size_t)n * S + i) * hd + d] = dqa[a][c] * scale;
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

template <int HDMAX>
int launch(const float* q, const float* k, const float* v, const float* g,
           const float* lse, const float* dout, const float* dvec, float* dq,
           float* dk, float* dv, float* dg, int Nq, int S, int hd, int W, int G,
           float eps, cudaStream_t st) {
  using C = Smem<HDMAX>;
  const int tiles = (S + BT - 1) / BT;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf((float)hd);
  const size_t smem_a = (size_t)(4 * C::TILE + 2 * BT * LDP + 16 * BT + 3 * BT) * sizeof(float);
  const size_t smem_b = (size_t)(4 * C::TILE + BT * LDP + 3 * BT) * sizeof(float);
  cudaError_t err = set_smem(bwd_kv_kernel<HDMAX>, smem_a);
  if (err != cudaSuccess) return (int)err;
  err = set_smem(bwd_q_kernel<HDMAX>, smem_b);
  if (err != cudaSuccess) return (int)err;
  bwd_kv_kernel<HDMAX><<<dim3(Nq / G, tiles), THREADS, smem_a, st>>>(
      q, k, v, g, lse, dout, dvec, dk, dv, dg, S, hd, W, G, eps, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_q_kernel<HDMAX><<<dim3(Nq, tiles), THREADS, smem_b, st>>>(
      q, k, v, g, lse, dout, dvec, dq, S, hd, W, G, eps, scale);
  return (int)cudaGetLastError();
}

}  // namespace

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
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bwd_dot_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(dout, o, dvec, rows, hd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (hd <= 64)
    return launch<64>(q, k, v, g, lse, dout, dvec, dq, dk, dv, dg, Nq, S, hd, W, G, eps, st);
  return launch<128>(q, k, v, g, lse, dout, dvec, dq, dk, dv, dg, Nq, S, hd, W, G, eps, st);
}
