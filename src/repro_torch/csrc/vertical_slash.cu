// Budgeted vertical-slash prefill attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/vertical_slash.py::vertical_slash (Pallas
// TPU kernel, paper §4.2). Query i of a stream sees key j of its own
// sequence iff i - W < j <= i (the slash: the local window) and global
// token c iff gpos[c] <= i - W (the vertical: admitted tokens strictly
// older than the window, pre-gathered into kg/vg outside the kernel),
// all in one softmax. gpos = INT32_MAX is never visible; gpos need not be
// sorted.
//
// Layout: q [Nq, S, hd]; k, v [Nq / G, S, hd]; kg, vg [Nq / G, C, hd];
// gpos [Nq / G, C] int32; out [Nq, S, hd]; float32 or bfloat16, hd <= 256.
// Query stream n reads kv stream n / G (GQA: streams ordered (b, kv head,
// group)), so K, V and the globals are never copied G times.
//
// What bounds it on this card: operations. At the path shape (16 query
// streams, S = 4096, hd = 128, W = 256, C = 1024) each query sees about
// W + C = 1,280 keys for 4 * hd FLOPs each, against one read of the
// inputs: some 2,000 FLOPs per byte, far above the card's ratio.
// What the design does about it: one CTA per (query stream, 64-row query
// tile): 1,024 CTAs at the path shape, enough to fill 132 SMs. The CTA
// walks the key tiles of its band [q0 - W + 1, q0 + 63] (clipped at 0),
// then the C global tiles, staging each 32-key tile of K/V in shared
// memory once for all 64 rows and reading it with 16-byte loads
// (flash_tile.cuh). A global tile that no row of the CTA can see is
// skipped (exactly: it would add nothing).
// Left on the table by this simple kernel: the products run on the CUDA
// cores in f32 (no wgmma / mma.sync tensor-core tiles, so bf16 gains
// nothing), the tile loads are not overlapped with compute (no cp.async
// or TMA pipeline), the G query streams of a kv head stage the same K/V
// tiles separately, band tiles overlap between neighbouring CTAs, and
// global tiles are skipped only when no row of the CTA sees any of them.
#include "flash_tile.cuh"

#include <limits.h>

namespace {

using namespace flash;

template <typename T, int HDMAX>
__global__ void __launch_bounds__(THREADS)
vertical_slash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ kg,
                      const T* __restrict__ vg, const int* __restrict__ gpos,
                      T* __restrict__ out, int S, int C, int hd, int W,
                      int G, float scale) {
  extern __shared__ float4 smem4[];
  const Dims dm(hd);
  float* q_s = reinterpret_cast<float*>(smem4);  // [TQ][ldk]
  float* k_s = q_s + TQ * dm.ldk;                // [BK][ldk]
  float* v_s = k_s + BK * dm.ldk;                // [BK][hp]
  float* p_s = v_s + BK * dm.hp;                 // [TQ][LDP]
  int* gp_s = reinterpret_cast<int*>(p_s + TQ * LDP);  // [BK]

  // blocks start in index order: the last (costliest) query tiles of
  // every stream first, so the short ones fill in behind them
  const int n = blockIdx.x;
  const int nk = n / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int i = q0 + row;            // this quad's query row
  const int q_last = min(q0 + TQ, S) - 1;

  load_rows(q_s, dm.ldk, q + ((size_t)n * S + q0) * hd, q_last - q0 + 1, TQ,
            dm);
  RowState<HDMAX> st;
  st.init();
  const float* q_row = q_s + row * dm.ldk;
  float* p_row = p_s + row * LDP;

  // Tiles 0 .. n_band-1 are the slash: the band [k_lo, q_last] of this
  // sequence. Tiles n_band .. are the vertical: the gathered globals,
  // visible iff gpos <= i - W. One loop, so the tile update is inlined once.
  const int k_lo = max(0, q0 - W + 1);
  const int n_band = (q_last + 1 - k_lo + BK - 1) / BK;
  const int n_tiles = n_band + (C + BK - 1) / BK;
  const size_t kv_off = (size_t)nk * S * hd;
  const size_t g_off = (size_t)nk * C * hd;
  for (int t = 0; t < n_tiles; ++t) {
    const bool glob = t >= n_band;
    const int base = glob ? (t - n_band) * BK : k_lo + t * BK;
    const int cnt = min(BK, (glob ? C : q_last + 1) - base);
    __syncthreads();  // the previous tile (and gp_s) is consumed
    if (glob) {
      int seen = 0;
      if (tid < BK) {
        gp_s[tid] = tid < cnt ? gpos[(size_t)nk * C + base + tid] : INT_MAX;
        seen = gp_s[tid] <= q_last - W;
      }
      if (!__syncthreads_or(seen)) continue;  // no row of the tile sees it
      load_rows(k_s, dm.ldk, kg + g_off + (size_t)base * hd, cnt, BK, dm);
      load_rows(v_s, dm.hp, vg + g_off + (size_t)base * hd, cnt, BK, dm);
    } else {
      load_rows(k_s, dm.ldk, k + kv_off + (size_t)base * hd, cnt, BK, dm);
      load_rows(v_s, dm.hp, v + kv_off + (size_t)base * hd, cnt, BK, dm);
    }
    __syncthreads();
    tile_update<HDMAX>(q_row, k_s, v_s, p_row, dm, scale,
                       [&](int jl, float s) {
                         if (glob) return gp_s[jl] <= i - W ? s : NEG_INF;
                         const int j = base + jl;
                         return (jl < cnt && j <= i && i - j < W) ? s
                                                                 : NEG_INF;
                       }, st);
  }

  if (i < S) store_row<T, HDMAX>(out + ((size_t)n * S + i) * hd, dm, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int vertical_slash(const void* q, const void* k, const void* v,
                              const void* kg, const void* vg, const int* gpos,
                              void* out, int Nq, int S, int C, int hd, int W,
                              int G, int dtype, void* stream) {
  if (Nq <= 0 || S <= 0) return 0;
  if (!shape_ok(Nq, S, hd, G) || W <= 0 || C < 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(dtype, hd, [&](auto t, auto hdmax) {
    using T = typename decltype(t)::type;
    return launch_tiles(vertical_slash_kernel<T, decltype(hdmax)::value>, Nq,
                        S, hd, /*extra=*/BK, (cudaStream_t)stream,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), static_cast<const T*>(kg),
                        static_cast<const T*>(vg), gpos, static_cast<T*>(out),
                        S, C, hd, W, G, 1.f / sqrtf((float)hd));
  });
}
