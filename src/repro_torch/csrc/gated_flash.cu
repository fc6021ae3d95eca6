// Write-gated causal flash attention for Hopper (sm_90a), on tensor cores.
//
// Replaces: src/repro/kernels/gated_flash.py::gated_flash (Pallas TPU
// kernel, the paper's §3.2 write-gated attention). Query i sees key j <= i
// with the log-space gate bias: 0 inside the local window (i - j < W) and
// log(g[j] + eps) outside it; keys above the diagonal are masked. The
// online softmax is the Pallas kernel's: masked logits NEG_INF, m_safe = 0
// while a row has seen no key, alpha = 0 on its first live tile, output
// acc / max(l, 1e-30).
//
// Layout: q [Nq, S, hd]; k, v [Nq / G, S, hd]; g [Nq / G, S] float32;
// out [Nq, S, hd]; float32 or bfloat16, hd <= 256 with 16-byte rows (a
// multiple of 8). Query stream n reads kv stream n / G (GQA: streams
// ordered (b, kv head, group)). Forward only, as the Pallas kernel is.
//
// What bounds it on this card: operations. Causal attention does
// 4 * hd * S (S + 1) / 2 FLOPs per stream against one read of q, k, v, g
// and one write of the output: at S = 2048, hd = 128 some 1,000 FLOPs per
// byte, far above the card's ratio.
// What the design does about it:
// - Tensor cores (flash_mma.cuh). Each warp owns 16 query rows of the CTA
//   tile (4 warps, 64 rows; 8 warps, 128 rows for f32 at hd 256: Cfg);
//   S = Q K^T and O += P V are mma.sync tiles, S and O in
//   accumulator registers. f32 runs m16n8k8 TF32 with the 3xTF32 split;
//   bf16 runs m16n8k16 with f32 accumulation, and P enters P V as three
//   bf16 terms that sum to its f32 value: P rounded to bf16, as the Pallas
//   kernel rounds it (p.astype(v.dtype)), moved bf16 outputs above 1 by
//   an ulp of the output (1.6e-2 in [2, 4)) against the f32-P plain
//   version, over the 1e-2 limit. Mask and bias go on the S fragments;
//   row max and sum are quad shuffles. P goes from the S accumulators
//   straight into A fragments: in bf16 the layouts agree; in TF32 the
//   eight keys of a k-step are read in the order (0, 2, 4, 6 | 1, 3, 5,
//   7), so a0..a3 are c0, c2, c1, c3, and V's rows are read in the same
//   order. Q fragments stay in registers for the whole key loop at hd <=
//   128; at hd 256 the O accumulators take 128 registers and Q fragments
//   are read from shared memory per key tile.
// - Asynchronous copies. K, V and the gates of the next key tile load by
//   cp.async into a 2-stage ring while the current tile computes; rows
//   are padded (f32: 4, bf16: 8 elements) so fragment loads and V's
//   ldmatrix.trans are free of bank conflicts.
// - GQA. When G divides the tile's rows, they are (position, head) pairs
//   of the G heads of one kv head (row r: position p0 + r / G, head
//   r % G), so each staged K/V tile serves every head of its group (at G
//   16, hd 256: 8 positions x 16 heads). Otherwise rows are positions of
//   one head.
// - Key tiles above the diagonal are skipped, and the costliest query
//   tiles (the last) launch first so the cheap ones fill the last wave.
// Next on this card: wgmma (4-warp 64-row products from shared memory;
// TF32 needs V transposed there) and TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "flash_mma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// Per element type and head-dim bucket: warps (16 rows each) and keys per
// tile, within 227 KB of shared memory. f32 at hd 256 takes 8 warps and
// 16-key tiles (one 200 KB CTA per SM, K/V tiles shared by 128 rows); the
// others take 4 warps and fit two CTAs on an SM.
template <typename T, int HDMAX>
struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int WARPS = (F32 && HDMAX > 128) ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TQ = 16 * WARPS;  // rows per CTA
  static constexpr int BK = F32 ? (HDMAX > 128 ? 16 : 32) : (HDMAX > 128 ? 32 : 64);
  static constexpr int LD = HDMAX + (F32 ? 4 : 8);  // smem row (elements)
  static constexpr int KSTEP = F32 ? 8 : 16;        // mma k along hd
  static constexpr int KS = HDMAX / KSTEP;          // k-steps of Q K^T
  static constexpr int NT = BK / 8;                 // n-tiles of S
  static constexpr int ONT = HDMAX / 8;             // n-tiles of O
  static constexpr bool QREG = HDMAX <= 128;        // Q fragments in registers
  using AReg = typename std::conditional<F32, float, uint32_t>::type;
  static constexpr size_t smem_bytes() {
    return (size_t)(TQ + 4 * BK) * LD * sizeof(T) + 2 * BK * sizeof(float);
  }
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int HDMAX>
__global__ void __launch_bounds__(Cfg<T, HDMAX>::THREADS, HDMAX > 128 ? 1 : 2)
gated_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ g,
                   T* __restrict__ out, int S, int hd, int W, int G, int F,
                   float eps, float scale) {
  using C = Cfg<T, HDMAX>;
  constexpr int LD = C::LD, BK = C::BK, TQ = C::TQ, THREADS = C::THREADS;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // [TQ][LD]
  T* k_s = q_s + TQ * LD;               // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;           // [2][BK][LD]
  float* g_s = reinterpret_cast<float*>(v_s + 2 * BK * LD);  // [2][BK]

  const int P = TQ / F;                // query positions per CTA
  const int n0 = blockIdx.x * F;       // its first query stream (F heads)
  const int nk = n0 / G;               // their kv stream
  const int p0 = (gridDim.y - 1 - blockIdx.y) * P;  // costliest first
  const int p_last = min(p0 + P, S) - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;  // fragment group
  const int tq = lane & 3;   // place in the group
  const int hdp = (hd + 15) & ~15;
  const int cpr = hd / EPC;  // 16-byte chunks per row

  // Q rows (r: stream n0 + r % F, position p0 + r / F), zero past S
  for (int e = tid; e < TQ * cpr; e += THREADS) {
    const int r = e / cpr;
    const int c = e - r * cpr;
    const int pos = p0 + r / F;
    const bool ok = pos < S;
    const T* src = q + ((size_t)(n0 + r % F) * S + (ok ? pos : 0)) * hd + c * EPC;
    async_copy::cp16_zfill(q_s + r * LD + c * EPC, src, ok);
  }
  // columns hd..hdp (zero) of every Q, K and V row; cp.async never writes them
  if (hdp > hd) {
    const int pad = hdp - hd;
    for (int e = tid; e < (TQ + 4 * BK) * pad; e += THREADS)
      q_s[(e / pad) * LD + hd + e % pad] = T(0.f);
  }

  auto issue = [&](int kb, int st) {
    T* ks = k_s + st * BK * LD;
    T* vs = v_s + st * BK * LD;
    for (int e = tid; e < BK * cpr; e += THREADS) {
      const int r = e / cpr;
      const int c = e - r * cpr;
      const int j = kb + r;
      const bool ok = j < S;
      const size_t off = ((size_t)nk * S + (ok ? j : 0)) * hd + c * EPC;
      async_copy::cp16_zfill(ks + r * LD + c * EPC, k + off, ok);
      async_copy::cp16_zfill(vs + r * LD + c * EPC, v + off, ok);
    }
    if (tid < BK) {
      const int j = kb + tid;
      async_copy::cp4_zfill(g_s + st * BK + tid, g + (size_t)nk * S + (j < S ? j : 0),
                            j < S);
    }
  };

  // this lane's two rows: r0 = 16 warp + gq and r0 + 8
  const int r0 = warp * 16 + gq;
  const int i0 = p0 + r0 / F;
  const int i1 = p0 + (r0 + 8) / F;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[C::ONT][4];
#pragma unroll
  for (int nt = 0; nt < C::ONT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  typename C::AReg qf[C::QREG ? C::KS : 1][4];
  const T* q_row = q_s + r0 * LD + (C::F32 ? tq : 2 * tq);

  const int ntiles = (p_last + BK) / BK;  // key tiles 0 .. the diagonal
  issue(0, 0);
  async_copy::commit();  // Q and tile 0
  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    const int kb = it * BK;
    if (it + 1 < ntiles) issue(kb + BK, st ^ 1);
    async_copy::commit();
    async_copy::wait<1>();
    // each of the first BK threads turns the gate it copied into log(g + eps)
    if (tid < BK) g_s[st * BK + tid] = logf(g_s[st * BK + tid] + eps);
    __syncthreads();
    if constexpr (C::QREG) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < C::KS; ++ks)
          if (ks * C::KSTEP < hdp) mma::load_a<LD>(qf[ks], q_row + ks * C::KSTEP);
      }
    }
    const T* kt = k_s + st * BK * LD;
    const T* vt = v_s + st * BK * LD;
    const float* gl = g_s + st * BK;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float sc[C::NT][4];
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      if (ks * C::KSTEP >= hdp) break;
      typename C::AReg a[4];
      if constexpr (C::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        mma::load_a<LD>(a, q_row + ks * C::KSTEP);
      }
      if constexpr (C::F32) {
        uint32_t ah[4], al[4];
        mma::split(a, ah, al);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          float b[2];
          mma::load_kfrag(b, kt + (nt * 8 + gq) * LD + ks * 8 + tq);
          uint32_t bh[2], bl[2];
          mma::split(b, bh, bl);
          mma::mma_3xtf32(sc[nt], ah, al, bh, bl);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          uint32_t b[2];
          mma::load_kfrag(b, kt + (nt * 8 + gq) * LD + ks * 16 + 2 * tq);
          mma::mma_bf16(sc[nt], a, b);
        }
      }
    }

    // logits (mask, window, gate bias), then the online softmax per row
    float mt0 = NEG_INF, mt1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = nt * 8 + 2 * tq + e;
        const int j = kb + jl;
        const float lg = gl[jl];
        const float s0 = sc[nt][e] * scale;
        const float s1 = sc[nt][2 + e] * scale;
        sc[nt][e] = j > i0 ? NEG_INF : (i0 - j < W ? s0 : s0 + lg);
        sc[nt][2 + e] = j > i1 ? NEG_INF : (i1 - j < W ? s1 : s1 + lg);
        mt0 = fmaxf(mt0, sc[nt][e]);
        mt1 = fmaxf(mt1, sc[nt][2 + e]);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, o2));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, o2));
    }
    const float mn0 = fmaxf(m0, mt0);
    const float mn1 = fmaxf(m1, mt1);
    const float ms0 = (mn0 <= NEG_INF * 0.5f) ? 0.f : mn0;
    const float ms1 = (mn1 <= NEG_INF * 0.5f) ? 0.f : mn1;
    const float al0 = (m0 <= NEG_INF * 0.5f) ? 0.f : expf(m0 - ms0);
    const float al1 = (m1 <= NEG_INF * 0.5f) ? 0.f : expf(m1 - ms1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = expf(sc[nt][e] - ms0);
        sc[nt][2 + e] = expf(sc[nt][2 + e] - ms1);
        ps0 += sc[nt][e];
        ps1 += sc[nt][2 + e];
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, o2);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, o2);
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < C::ONT; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }

    // O += P V
    if constexpr (C::F32) {
#pragma unroll
      for (int kk = 0; kk < C::NT; ++kk) {
        // keys kk * 8 + (0, 2, 4, 6 | 1, 3, 5, 7): A is (c0, c2, c1, c3)
        const float pa[4] = {sc[kk][0], sc[kk][2], sc[kk][1], sc[kk][3]};
        uint32_t ah[4], al[4];
        mma::split(pa, ah, al);
        const float* vr = vt + (kk * 8 + 2 * tq) * LD + gq;
#pragma unroll
        for (int nt = 0; nt < C::ONT; ++nt) {
          if (nt * 8 >= hdp) break;
          const float b[2] = {vr[nt * 8], vr[LD + nt * 8]};
          uint32_t bh[2], bl[2];
          mma::split(b, bh, bl);
          mma::mma_3xtf32(o[nt], ah, al, bh, bl);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // P as three bf16 terms (exactly its f32 value), smallest first
        uint32_t t0[3], t1[3], t2[3], t3[3];
        mma::split3_bf16(sc[2 * kk][0], sc[2 * kk][1], t0);
        mma::split3_bf16(sc[2 * kk][2], sc[2 * kk][3], t1);
        mma::split3_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], t2);
        mma::split3_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], t3);
        const T* vr = vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                      (lane >> 4) * 8;
#pragma unroll
        for (int nt = 0; nt < C::ONT; nt += 2) {
          if (nt * 8 >= hdp) break;
          uint32_t r[4];
          mma::ldsm_x4_trans(r, vr + nt * 8);
          const uint32_t b0[2] = {r[0], r[1]};
          const uint32_t b1[2] = {r[2], r[3]};
#pragma unroll
          for (int term = 2; term >= 0; --term) {
            const uint32_t pa[4] = {t0[term], t1[term], t2[term], t3[term]};
            mma::mma_bf16(o[nt], pa, b0);
            mma::mma_bf16(o[nt + 1], pa, b1);
          }
        }
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }
  async_copy::wait<0>();

  const float d0 = 1.f / fmaxf(l0, 1e-30f);
  const float d1 = 1.f / fmaxf(l1, 1e-30f);
  T* o0 = out + ((size_t)(n0 + r0 % F) * S + i0) * hd;
  T* o1 = out + ((size_t)(n0 + (r0 + 8) % F) * S + i1) * hd;
#pragma unroll
  for (int nt = 0; nt < C::ONT; ++nt) {
    const int d = nt * 8 + 2 * tq;
    if (d >= hd) break;
    if (i0 < S) store2<T>(o0 + d, o[nt][0] * d0, o[nt][1] * d0);
    if (i1 < S) store2<T>(o1 + d, o[nt][2] * d1, o[nt][3] * d1);
  }
}

template <typename T, int HDMAX>
int launch(const void* q, const void* k, const void* v, const float* g,
           void* out, int Nq, int S, int hd, int W, int G, float eps,
           cudaStream_t st) {
  using C = Cfg<T, HDMAX>;
  // rows fold (position, head) over the group when it divides the tile
  const int F = C::TQ % G == 0 ? G : 1;
  const int P = C::TQ / F;
  if ((S + P - 1) / P > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = C::smem_bytes();
  if (smem > 48 * 1024) {  // above the default dynamic limit
    const cudaError_t err = cudaFuncSetAttribute(
        gated_flash_kernel<T, HDMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gated_flash_kernel<T, HDMAX><<<dim3(Nq / F, (S + P - 1) / P), C::THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      g, static_cast<T*>(out), S, hd, W, G, F, eps, 1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const float* g,
              void* out, int Nq, int S, int hd, int W, int G, float eps,
              cudaStream_t st) {
  if (hd <= 64) return launch<T, 64>(q, k, v, g, out, Nq, S, hd, W, G, eps, st);
  if (hd <= 128) return launch<T, 128>(q, k, v, g, out, Nq, S, hd, W, G, eps, st);
  return launch<T, 256>(q, k, v, g, out, Nq, S, hd, W, G, eps, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int gated_flash(const void* q, const void* k, const void* v,
                           const float* g, void* out, int Nq, int S, int hd,
                           int W, int G, float eps, int dtype, void* stream) {
  if (Nq <= 0 || S <= 0) return 0;
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || G <= 0 || Nq % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_hd<float>(q, k, v, g, out, Nq, S, hd, W, G, eps, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, g, out, Nq, S, hd, W, G, eps, st);
  return (int)cudaErrorInvalidValue;
}
