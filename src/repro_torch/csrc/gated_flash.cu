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
// ordered (b, kv head, group)). With a non-null lse [Nq, S] float32 it
// also writes each row's log-sum-exp, max + log(sum) of its logits in
// natural log, which the backward (gated_flash_bwd.cu) reads; inference
// passes null. The backward is a kernel of its own, in f32.
//
// What bounds it on this card: operations. Causal attention does
// 4 * hd * S (S + 1) / 2 FLOPs per stream against one read of q, k, v, g
// and one write of the output: at S = 2048, hd = 128 some 1,000 FLOPs per
// byte, far above the card's ratio.
// What the design does about it:
// - Tensor cores: each warp owns 16 query rows of the CTA tile (4 warps,
//   64 rows; 8 warps, 128 rows for f32 at hd 256) and runs the key-tile
//   step of flash_mma.cuh, which it shares with vertical_slash.cu:
//   S = Q K^T and O += P V as mma.sync tiles (f32 in 3xTF32, bf16 with P
//   as two bf16 terms), mask and gate bias on the S fragments.
// - Few instructions beside the products: in bf16 the step is bound by
//   the instructions a warp issues as much as by the tensor cores. K
//   fragments come by ldmatrix, exp is one ex2 (logits in base 2), and
//   a warp masks a tile only where it must: a tile inside every row's
//   window takes the logits as they are, one outside all of them only
//   the gate bias (most tiles at S 2048, W 256).
// - Asynchronous copies. K, V and the gates of the next key tile load by
//   cp.async into a 2-stage ring while the current tile computes.
// - GQA. When G divides the tile's rows, they are (position, head) pairs
//   of the G heads of one kv head (row r: position p0 + r / G, head
//   r % G), so each staged K/V tile serves every head of its group (at G
//   16, hd 256: 8 positions x 16 heads). Otherwise rows are positions of
//   one head.
// - Key tiles above the diagonal are skipped, and the costliest query
//   tiles (the last) launch first so the cheap ones fill the last wave.
// - The hard window (HARD, gated_flash_window): the dense baseline's
//   windowed prefill of local-attention blocks (the reference computes it
//   outside any Pallas kernel, src/repro/models/attention.py:312-330,
//   through the einsum of its sdpa). Query i sees key j iff 0 <= i - j
//   < W: the keys outside the window are masked to NEG_INF where the
//   gated form adds log2(g + eps), and no gate is read. The key loop
//   starts at the first tile the CTA's first row can see, and a warp
//   whose rows see no key of a tile skips it: the work is S * W per
//   stream, not S^2 / 2. The causal form (HARD false) is unchanged.
// Next on this card: wgmma (4-warp 64-row products from shared memory;
// TF32 needs V transposed there) and TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_mma.cuh"

namespace {

using mma::NEG_INF;

// f32 at hd 256 takes 8 warps and 16-key tiles (one 200 KB CTA per SM,
// K/V tiles shared by 128 rows); the others take 4 warps and fit two
// CTAs on an SM.
template <typename T, int HDMAX>
using Cfg = mma::FlashCfg<T, HDMAX, (std::is_same<T, float>::value && HDMAX > 128) ? 8 : 4>;

template <typename T, int HDMAX, bool HARD>
__global__ void __launch_bounds__(Cfg<T, HDMAX>::THREADS, HDMAX > 128 ? 1 : 2)
gated_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ g,
                   T* __restrict__ out, float* __restrict__ lse, int S, int hd,
                   int W, int G, int F, float eps) {
  using C = Cfg<T, HDMAX>;
  constexpr int LD = C::LD, BK = C::BK, TQ = C::TQ, THREADS = C::THREADS;
  constexpr int EPC = C::EPC;
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
  const int cpr = hd / EPC;  // 16-byte chunks per row

  mma::stage_q<C>(q_s, q, n0, F, p0, S, hd);

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
    if (!HARD && tid < BK) {
      const int j = kb + tid;
      async_copy::cp4_zfill(g_s + st * BK + tid, g + (size_t)nk * S + (j < S ? j : 0),
                            j < S);
    }
  };

  // this lane's two rows: r0 = 16 warp + g and r0 + 8; the warp's rows
  // span positions ia..ib
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int i0 = p0 + r0 / F;
  const int i1 = p0 + (r0 + 8) / F;
  const int ia = p0 + (tid >> 5) * 16 / F;
  const int ib = p0 + ((tid >> 5) * 16 + 15) / F;
  mma::FlashRows<C> rows(q_s, r0, hd, lane);

  const int ntiles = (p_last + BK) / BK;  // key tiles .. the diagonal
  // the hard window starts at the tile of the first row's first key
  const int it0 = HARD ? max(p0 - W + 1, 0) / BK : 0;
  issue(it0 * BK, 0);
  async_copy::commit();  // Q and the first tile
  for (int it = it0; it < ntiles; ++it) {
    const int st = (it - it0) & 1;
    const int kb = it * BK;
    if (it + 1 < ntiles) issue(kb + BK, st ^ 1);
    async_copy::commit();
    async_copy::wait<1>();
    // each of the first BK threads turns the gate it copied into the
    // bias in base 2, log2(g + eps)
    if (!HARD && tid < BK) g_s[st * BK + tid] = log2f(g_s[st * BK + tid] + eps);
    __syncthreads();
    if (it == it0) rows.load_q();
    const int ke = kb + BK - 1;
    if constexpr (HARD) {
      // keys outside the window masked. A warp whose rows see no key of
      // the tile leaves its state as a tile of NEG_INF logits would.
      if (kb <= ib && ia - ke < W) {
        rows.scores(k_s + st * BK * LD);
        if (ke > ia || ib - kb >= W) {
          rows.mask([&](int jl, int h, float s) {
            const int i = h ? i1 : i0;
            const int j = kb + jl;
            return (j > i || i - j >= W) ? NEG_INF : s;
          });
        }
        rows.update(v_s + st * BK * LD);
      }
    } else {
      const float* gl = g_s + st * BK;
      rows.scores(k_s + st * BK * LD);
      // causal mask; bias 0 in the window, log2(g + eps) outside it. A
      // tile inside every row's window needs neither; one outside all of
      // them only the bias.
      if (ia - ke >= W) {
        rows.mask([&](int jl, int, float s) { return s + gl[jl]; });
      } else if (ke > ia || ib - kb >= W) {
        rows.mask([&](int jl, int h, float s) {
          const int i = h ? i1 : i0;
          const int j = kb + jl;
          return j > i ? NEG_INF : (i - j < W ? s : s + gl[jl]);
        });
      }
      rows.update(v_s + st * BK * LD);
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }
  async_copy::wait<0>();

  rows.store(out + ((size_t)(n0 + r0 % F) * S + i0) * hd, i0 < S,
             out + ((size_t)(n0 + (r0 + 8) % F) * S + i1) * hd, i1 < S, hd);
  if (lse)
    rows.store_lse(lse + (size_t)(n0 + r0 % F) * S + i0, i0 < S,
                   lse + (size_t)(n0 + (r0 + 8) % F) * S + i1, i1 < S);
}

template <typename T, int HDMAX, bool HARD>
int launch(const void* q, const void* k, const void* v, const float* g,
           void* out, float* lse, int Nq, int S, int hd, int W, int G, float eps,
           cudaStream_t st) {
  using C = Cfg<T, HDMAX>;
  // rows fold (position, head) over the group when it divides the tile
  const int F = C::TQ % G == 0 ? G : 1;
  const int P = C::TQ / F;
  if ((S + P - 1) / P > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = C::tile_bytes() + 2 * C::BK * sizeof(float);
  if (smem > 48 * 1024) {  // above the default dynamic limit
    const cudaError_t err = cudaFuncSetAttribute(
        gated_flash_kernel<T, HDMAX, HARD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  gated_flash_kernel<T, HDMAX, HARD><<<dim3(Nq / F, (S + P - 1) / P), C::THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      g, static_cast<T*>(out), lse, S, hd, W, G, F, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool HARD>
int launch_hd(const void* q, const void* k, const void* v, const float* g,
              void* out, float* lse, int Nq, int S, int hd, int W, int G, float eps,
              cudaStream_t st) {
  if (hd <= 64) return launch<T, 64, HARD>(q, k, v, g, out, lse, Nq, S, hd, W, G, eps, st);
  if (hd <= 128)
    return launch<T, 128, HARD>(q, k, v, g, out, lse, Nq, S, hd, W, G, eps, st);
  return launch<T, 256, HARD>(q, k, v, g, out, lse, Nq, S, hd, W, G, eps, st);
}

int check_args(int Nq, int hd, int G) {
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || G <= 0 || Nq % G != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse may be null. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int gated_flash(const void* q, const void* k, const void* v,
                           const float* g, void* out, float* lse, int Nq, int S,
                           int hd, int W, int G, float eps, int dtype, void* stream) {
  if (Nq <= 0 || S <= 0) return 0;
  if (const int bad = check_args(Nq, hd, G)) return bad;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float, false>(q, k, v, g, out, lse, Nq, S, hd, W, G, eps, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16, false>(q, k, v, g, out, lse, Nq, S, hd, W, G, eps, st);
  return (int)cudaErrorInvalidValue;
}

// The hard window: query i sees key j iff 0 <= i - j < W (W >= 1); no
// gate, no log-sum-exp (forward only). dtype as above.
extern "C" int gated_flash_window(const void* q, const void* k, const void* v,
                                  void* out, int Nq, int S, int hd, int W, int G,
                                  int dtype, void* stream) {
  if (Nq <= 0 || S <= 0) return 0;
  if (const int bad = check_args(Nq, hd, G)) return bad;
  if (W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float, true>(q, k, v, nullptr, out, nullptr, Nq, S, hd, W, G, 0.f, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16, true>(q, k, v, nullptr, out, nullptr, Nq, S, hd, W, G,
                                          0.f, st);
  return (int)cudaErrorInvalidValue;
}
