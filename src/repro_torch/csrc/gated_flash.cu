// Write-gated causal flash attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gated_flash.py::gated_flash (Pallas TPU
// kernel, the paper's §3.2 write-gated attention). Query i sees key j <= i
// with the log-space gate bias: 0 inside the local window (i - j < W) and
// log(g[j] + eps) outside it; keys above the diagonal are masked. log is
// computed in the kernel, once per staged key.
//
// Layout: q [Nq, S, hd]; k, v [Nq / G, S, hd]; g [Nq / G, S] float32;
// out [Nq, S, hd]; float32 or bfloat16, hd <= 256. Query stream n reads
// kv stream n / G (GQA: streams ordered (b, kv head, group)), so K, V and
// g are never copied G times. Forward only, as the Pallas kernel is.
//
// What bounds it on this card: operations. Causal attention does
// 4 * hd * S (S + 1) / 2 FLOPs per stream against one read of q, k, v, g
// and one write of the output: at S = 2048, hd = 128 some 1,000 FLOPs per
// byte, far above the card's ratio.
// What the design does about it: one CTA per (query stream, 64-row query
// tile) walks the 32-key tiles from key 0 to its diagonal and skips those
// above it, staging each K/V tile (and its log gates) in shared memory
// once for all 64 rows and reading it with 16-byte loads (flash_tile.cuh).
// Every row sees key 0, so no row stays fully masked; the tile loop keeps
// the m_safe guard anyway.
// Left on the table by this simple kernel: the products run on the CUDA
// cores in f32 (no wgmma / mma.sync tensor-core tiles, so bf16 gains
// nothing), the tile loads are not overlapped with compute (no cp.async
// or TMA pipeline), and the G query streams of a kv head stage the same
// K/V tiles separately. (The costlier late query tiles are launched
// first, so the cheap early ones fill the last wave.)
#include "flash_tile.cuh"

namespace {

using namespace flash;

template <typename T, int HDMAX>
__global__ void __launch_bounds__(THREADS)
gated_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ g,
                   T* __restrict__ out, int S, int hd, int W, int G,
                   float eps, float scale) {
  extern __shared__ float4 smem4[];
  const Dims dm(hd);
  float* q_s = reinterpret_cast<float*>(smem4);  // [TQ][ldk]
  float* k_s = q_s + TQ * dm.ldk;                // [BK][ldk]
  float* v_s = k_s + BK * dm.ldk;                // [BK][hp]
  float* p_s = v_s + BK * dm.hp;                 // [TQ][LDP]
  float* logg_s = p_s + TQ * LDP;                // [BK]

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

  const T* k_src = k + (size_t)nk * S * hd;
  const T* v_src = v + (size_t)nk * S * hd;
  const float* g_src = g + (size_t)nk * S;
  const int k_end = q_last + 1;      // tiles past the diagonal are skipped
  for (int kb = 0; kb < k_end; kb += BK) {
    const int cnt = min(BK, k_end - kb);
    __syncthreads();  // the previous tile is consumed
    load_rows(k_s, dm.ldk, k_src + (size_t)kb * hd, cnt, BK, dm);
    load_rows(v_s, dm.hp, v_src + (size_t)kb * hd, cnt, BK, dm);
    if (tid < BK) logg_s[tid] = tid < cnt ? logf(g_src[kb + tid] + eps) : 0.f;
    __syncthreads();
    tile_update<HDMAX>(q_row, k_s, v_s, p_row, dm, scale,
                       [&](int jl, float s) {
                         const int j = kb + jl;
                         if (jl >= cnt || j > i) return NEG_INF;
                         return i - j < W ? s : s + logg_s[jl];
                       }, st);
  }

  if (i < S) store_row<T, HDMAX>(out + ((size_t)n * S + i) * hd, dm, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int gated_flash(const void* q, const void* k, const void* v,
                           const float* g, void* out, int Nq, int S, int hd,
                           int W, int G, float eps, int dtype, void* stream) {
  if (Nq <= 0 || S <= 0) return 0;
  if (!shape_ok(Nq, S, hd, G)) return (int)cudaErrorInvalidValue;
  return dispatch(dtype, hd, [&](auto t, auto hdmax) {
    using T = typename decltype(t)::type;
    return launch_tiles(gated_flash_kernel<T, decltype(hdmax)::value>, Nq, S,
                        hd, /*extra=*/BK, (cudaStream_t)stream,
                        static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), g, static_cast<T*>(out), S,
                        hd, W, G, eps, 1.f / sqrtf((float)hd));
  });
}
