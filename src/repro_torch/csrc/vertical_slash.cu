// Budgeted vertical-slash prefill attention for Hopper (sm_90a), on
// tensor cores.
//
// Replaces: src/repro/kernels/vertical_slash.py::vertical_slash (Pallas
// TPU kernel, paper §4.2). Query i of a stream sees key j of its own
// sequence iff i - W < j <= i (the slash: the local window) and global
// token c iff gpos[c] <= i - W (the vertical: admitted tokens strictly
// older than the window, pre-gathered into kg/vg outside the kernel),
// all in one softmax. gpos = INT32_MAX is never visible; gpos need not be
// sorted. The online softmax is the Pallas kernel's (m_safe, alpha = 0 on
// a row's first live tile, acc / max(l, 1e-30)).
//
// Layout: q [Nq, S, hd]; k, v [Nq / G, S, hd]; kg, vg [Nq / G, C, hd];
// gpos [Nq / G, C] int32; out [Nq, S, hd]; float32 or bfloat16, hd <= 256
// with 16-byte rows (a multiple of 8). Query stream n reads kv stream
// n / G (GQA: streams ordered (b, kv head, group)), so K, V and the
// globals are never copied G times.
//
// What bounds it on this card. Each query sees about W + C keys for
// 4 * hd FLOPs each. At qwen3-0.6b's prefill shape (16 q heads on 8 kv
// heads, S 4096, hd 128, W 256, C 1024) that is operations: some 2,000
// FLOPs per byte of input. At recurrentgemma-9b's (16 q heads on 1 kv
// head, hd 256, W 2048) it is the K/V staged from L2: every CTA of TQ
// rows stages its band of W + P keys and its live globals, because the
// window is far wider than a tile's P positions, so the CTAs together
// read about (Nq S / TQ) (W + C) hd rows of K and V from L2: TQ FLOPs per
// byte in bf16 (TQ / 2 in f32), below the tensor cores' ratio to L2.
// What the design does about it:
// - Tensor cores: each warp owns 16 rows and runs the key-tile step of
//   flash_mma.cuh, shared with gated_flash.cu (S = Q K^T and O += P V as
//   mma.sync tiles; f32 in 3xTF32, bf16 with P as two bf16 terms; the
//   visibility mask on the S fragments, skipped for a band tile inside
//   every row's window).
// - GQA rows: when G divides the tile's rows, they are (position, head)
//   pairs over the group (row r: position p0 + r / G, head r % G), so
//   each staged K/V tile serves every head of the group (rg: G 16).
//   Otherwise rows are positions of one head.
// - At hd 256 a CTA has 8 warps, 128 rows, halving the L2 traffic of rg's
//   band against 64 rows (one CTA per SM: 200 KB in f32, 135 KB in bf16).
// - Asynchronous copies: band tiles and then the live global tiles load
//   into a 2-stage cp.async ring while the previous tile computes.
// - Before the ring starts, one pass over gpos (C ints) finds the live
//   global tiles: those with a slot visible to the CTA's last row (min
//   gpos <= p_last - W), compacted in order into a list in shared
//   memory, so the ring walks band tiles and that list with one loop and
//   never stalls to decide a skip. Dead tiles would add exactly nothing.
// - The costliest query tiles (the last, which see the most globals)
//   launch first, so the cheap ones fill the last wave.
// Left for wgmma/TMA: 64-row warpgroup products from shared memory, TMA
// loads of the band with one copy per tile, and a CTA that serves
// neighbouring positions' overlapping bands once (a cluster sharing its
// band through distributed shared memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "flash_mma.cuh"

namespace {

using mma::NEG_INF;

// hd 256 takes 8 warps (128 rows; f32 16-key, bf16 32-key tiles); the
// others 4 warps (64 rows), two CTAs on an SM.
template <typename T, int HDMAX>
using Cfg = mma::FlashCfg<T, HDMAX, (HDMAX > 128 ? 8 : 4)>;

// Shared memory: the flash tiles, gpos of the two stages [2][BK], the
// count of live global tiles and their list (one int per global tile).
template <typename T, int HDMAX>
size_t smem_bytes(int C) {
  using F = Cfg<T, HDMAX>;
  return F::tile_bytes() + (size_t)(2 * F::BK + 1 + (C + F::BK - 1) / F::BK) * sizeof(int);
}

template <typename T, int HDMAX>
__global__ void __launch_bounds__(Cfg<T, HDMAX>::THREADS, HDMAX > 128 ? 1 : 2)
vertical_slash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ kg,
                      const T* __restrict__ vg, const int* __restrict__ gpos,
                      T* __restrict__ out, int S, int Cn, int hd, int W,
                      int G, int F) {
  using C = Cfg<T, HDMAX>;
  constexpr int LD = C::LD, BK = C::BK, TQ = C::TQ, THREADS = C::THREADS;
  constexpr int EPC = C::EPC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // [TQ][LD]
  T* k_s = q_s + TQ * LD;               // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;           // [2][BK][LD]
  int* gp_s = reinterpret_cast<int*>(v_s + 2 * BK * LD);  // [2][BK]
  int* n_live_s = gp_s + 2 * BK;        // [1]
  int* live = n_live_s + 1;             // [ceil(C / BK)]

  const int P = TQ / F;                // query positions per CTA
  const int n0 = blockIdx.x * F;       // its first query stream (F heads)
  const int nk = n0 / G;               // their kv stream
  const int p0 = (gridDim.y - 1 - blockIdx.y) * P;  // costliest first
  const int p_last = min(p0 + P, S) - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int cpr = hd / EPC;  // 16-byte chunks per row

  mma::stage_q<C>(q_s, q, n0, F, p0, S, hd);

  // the live global tiles, in order: a tile is live iff one of its slots
  // is visible to the CTA's last row
  const int* gp = gpos + (size_t)nk * Cn;
  const int n_gt = (Cn + BK - 1) / BK;
  for (int t = tid; t < n_gt; t += THREADS) {
    int lo = INT_MAX;
    for (int c = t * BK; c < min(t * BK + BK, Cn); ++c) lo = min(lo, __ldg(gp + c));
    live[t] = lo <= p_last - W;
  }
  __syncthreads();
  if (tid < 32) {  // compact in place: entry t is read before any write reaches it
    int cnt = 0;
    for (int b = 0; b < n_gt; b += 32) {
      const int t = b + lane;
      const bool f = t < n_gt && live[t];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) live[cnt + __popc(m & ((1u << lane) - 1u))] = t;
      cnt += __popc(m);
    }
    if (lane == 0) *n_live_s = cnt;
  }
  __syncthreads();

  // items 0 .. n_band - 1: the band [k_lo, p_last] of this sequence;
  // then n_live global tiles
  const int k_lo = max(0, p0 - W + 1);
  const int n_band = (p_last - k_lo + BK) / BK;
  const int n_live = *n_live_s;
  const int n_items = n_band + n_live;
  const size_t kv_off = (size_t)nk * S * hd;
  const size_t g_off = (size_t)nk * Cn * hd;

  auto issue = [&](int it, int st) {
    T* ks = k_s + st * BK * LD;
    T* vs = v_s + st * BK * LD;
    const bool glob = it >= n_band;
    const int base = glob ? live[it - n_band] * BK : k_lo + it * BK;
    const int end = glob ? Cn : S;  // rows past it are zero
    const T* kb = glob ? kg + g_off : k + kv_off;
    const T* vb = glob ? vg + g_off : v + kv_off;
    for (int e = tid; e < BK * cpr; e += THREADS) {
      const int r = e / cpr;
      const int c = e - r * cpr;
      const int j = base + r;
      const bool ok = j < end;
      const size_t off = (size_t)(ok ? j : 0) * hd + c * EPC;
      async_copy::cp16_zfill(ks + r * LD + c * EPC, kb + off, ok);
      async_copy::cp16_zfill(vs + r * LD + c * EPC, vb + off, ok);
    }
    if (glob && tid < BK) {
      const int c = base + tid;
      if (c < Cn)
        async_copy::cp4_zfill(gp_s + st * BK + tid, gp + c, true);
      else
        gp_s[st * BK + tid] = INT_MAX;  // padding past C: never visible
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

  issue(0, 0);
  async_copy::commit();  // Q and the first tile
  for (int it = 0; it < n_items; ++it) {
    const int st = it & 1;
    if (it + 1 < n_items) issue(it + 1, st ^ 1);
    async_copy::commit();
    async_copy::wait<1>();
    __syncthreads();
    if (it == 0) rows.load_q();
    rows.scores(k_s + st * BK * LD);
    if (it >= n_band) {  // globals: visible iff gpos <= i - W
      const int* gl = gp_s + st * BK;
      rows.mask([&](int jl, int h, float s) {
        return gl[jl] <= (h ? i1 : i0) - W ? s : NEG_INF;
      });
    } else {  // the band; a tile inside every row's window needs no mask
      const int base = k_lo + it * BK;
      if (base + BK - 1 > ia || ib - base >= W) {
        rows.mask([&](int jl, int h, float s) {
          const int i = h ? i1 : i0;
          const int j = base + jl;
          return (j <= i && i - j < W) ? s : NEG_INF;
        });
      }
    }
    rows.update(v_s + st * BK * LD);
    __syncthreads();  // stage st is consumed before it is refilled
  }
  async_copy::wait<0>();

  rows.store(out + ((size_t)(n0 + r0 % F) * S + i0) * hd, i0 < S,
             out + ((size_t)(n0 + (r0 + 8) % F) * S + i1) * hd, i1 < S, hd);
}

template <typename T, int HDMAX>
int launch(const void* q, const void* k, const void* v, const void* kg,
           const void* vg, const int* gpos, void* out, int Nq, int S, int Cn,
           int hd, int W, int G, cudaStream_t st) {
  using C = Cfg<T, HDMAX>;
  // rows fold (position, head) over the group when it divides the tile
  const int F = C::TQ % G == 0 ? G : 1;
  const int P = C::TQ / F;
  if ((S + P - 1) / P > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, HDMAX>(Cn);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // C too large
  if (smem > 48 * 1024) {  // above the default dynamic limit
    const cudaError_t err = cudaFuncSetAttribute(
        vertical_slash_kernel<T, HDMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  vertical_slash_kernel<T, HDMAX><<<dim3(Nq / F, (S + P - 1) / P), C::THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kg), static_cast<const T*>(vg), gpos, static_cast<T*>(out),
      S, Cn, hd, W, G, F);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* kg,
              const void* vg, const int* gpos, void* out, int Nq, int S, int Cn,
              int hd, int W, int G, cudaStream_t st) {
  if (hd <= 64) return launch<T, 64>(q, k, v, kg, vg, gpos, out, Nq, S, Cn, hd, W, G, st);
  if (hd <= 128) return launch<T, 128>(q, k, v, kg, vg, gpos, out, Nq, S, Cn, hd, W, G, st);
  return launch<T, 256>(q, k, v, kg, vg, gpos, out, Nq, S, Cn, hd, W, G, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int vertical_slash(const void* q, const void* k, const void* v,
                              const void* kg, const void* vg, const int* gpos,
                              void* out, int Nq, int S, int C, int hd, int W,
                              int G, int dtype, void* stream) {
  if (Nq <= 0 || S <= 0) return 0;
  if (hd <= 0 || hd > 256 || hd % 8 != 0 || G <= 0 || Nq % G != 0 || W <= 0 ||
      C < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_hd<float>(q, k, v, kg, vg, gpos, out, Nq, S, C, hd, W, G, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, kg, vg, gpos, out, Nq, S, C, hd, W, G, st);
  return (int)cudaErrorInvalidValue;
}
