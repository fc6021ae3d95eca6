// Single-query paged decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode.py::paged_decode (Pallas TPU
// kernel). One query row per stream n attends over the stream's pages of a
// [P, page, hd] K/V pool through page_table[n, j], masked to lengths[n]
// tokens, with the Pallas kernel's online softmax: m_safe = 0 while no
// token has been seen, alpha = 0 on the first live page, and the output
// acc / max(l, 1e-30), so a length-0 stream returns 0.
//
// An optional SECOND segment (its own pool, page table and lengths) is
// folded into the same online softmax. The dual cache's decode read uses
// it: segment 1 is the global cache (gcnt tokens), segment 2 the local
// ring (min(t, W) tokens), each viewed as pages of 16 in place — nothing
// is copied into a pool. With no second segment this is exactly
// paged_decode.
//
// The SELECTED variant replaces src/repro/kernels/paged_decode.py::
// paged_decode_selected (Quest read-time selection, paper §5.4): the first
// segment carries sel [N, K] logical page ids (ascending) and n_sel [N].
// Page j of the walk is logical page sel[n, j], read through
// table[n, logical], its tokens at positions logical * page + t masked to
// lengths[n]; the walk stops at min(K, n_sel[n]). It shares the walk below
// with paged_decode, so with the identity ids and K covering every page it
// visits the same pages in the same order and its output is bitwise equal
// to paged_decode's. A selected page at or past the stream's length (or
// outside its table) is skipped: like a page past the length in the full
// walk, it would add exactly 0 (m_safe, zero alpha).
//
// What bounds it on this card: bytes. Each stream reads its live K/V pages
// once (hd * page * 2 values per page) for 4 * hd FLOPs per token, far
// below the card's FLOP/byte ratio. At serving shapes there are only
// slots * 16 streams, so latency of the page loop, not bandwidth, sets the
// time of this simple kernel.
// What the design does about it: one 128-thread block per stream; a warp
// per token computes q.k with coalesced 128-byte reads and a shuffle
// reduction, and each thread owns hd / 128 output dims so V reads
// coalesce too. Pages at or past the stream's length are skipped: they
// contribute exactly 0 to the Pallas recurrence. Splitting a stream
// across blocks (split-K) and sharing K/V loads across a GQA group are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int MAX_HD = 256;
constexpr int DPT = MAX_HD / THREADS;  // output dims per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Segment {
  const void* k;         // [P, page, hd]
  const void* v;
  const int* table;      // [N, max_pages]
  const int* lengths;    // [N]
  int max_pages;
  const int* sel;        // [N, k_pages] logical page ids, or nullptr
  const int* n_sel;      // [N] valid entries of sel
  int k_pages;
};

template <typename T>
__device__ void attend(const Segment& seg, int n, int page, int hd,
                       const float* q_s, float* s_sh, float scale,
                       float& m, float& l, float acc[DPT]) {
  const T* kpool = static_cast<const T*>(seg.k);
  const T* vpool = static_cast<const T*>(seg.v);
  const int* table = seg.table + (size_t)n * seg.max_pages;
  const int len = seg.lengths[n];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* sel =
      seg.sel != nullptr ? seg.sel + (size_t)n * seg.k_pages : nullptr;
  const int n_walk = sel != nullptr
      ? min(seg.k_pages, seg.n_sel[n])
      : (len > 0 ? min(seg.max_pages, (len + page - 1) / page) : 0);
  for (int j = 0; j < n_walk; ++j) {
    const int logical = sel != nullptr ? sel[j] : j;
    // uniform over the block, so no thread skips a barrier alone
    if (logical < 0 || logical >= seg.max_pages || logical * page >= len)
      continue;
    const size_t base = (size_t)table[logical] * page * hd;
    const T* kp = kpool + base;
    const T* vp = vpool + base;
    for (int t = warp; t < page; t += nwarps) {
      float part = 0.f;
      for (int d = lane; d < hd; d += 32) part += q_s[d] * to_f(kp[t * hd + d]);
      for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0)
        s_sh[t] = (logical * page + t < len) ? part * scale : NEG_INF;
    }
    __syncthreads();
    float m_tile = NEG_INF;
    for (int t = 0; t < page; ++t) m_tile = fmaxf(m_tile, s_sh[t]);
    const float m_new = fmaxf(m, m_tile);
    const float m_safe = (m_new <= NEG_INF * 0.5f) ? 0.f : m_new;
    const float alpha = (m <= NEG_INF * 0.5f) ? 0.f : expf(m - m_safe);
    float psum = 0.f;
    float pv[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) pv[i] = 0.f;
    for (int t = 0; t < page; ++t) {
      const float p = expf(s_sh[t] - m_safe);
      psum += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = tid + i * THREADS;
        if (d < hd) pv[i] += p * to_f(vp[t * hd + d]);
      }
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = acc[i] * alpha + pv[i];
    m = m_new;
    __syncthreads();  // s_sh is rewritten by the next page
  }
}

template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q, Segment s1,
                                    Segment s2, int has_second,
                                    T* __restrict__ out, int hd, int page,
                                    float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;        // [hd]
  float* s_sh = smem + hd;  // [page]
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  for (int d = tid; d < hd; d += blockDim.x) q_s[d] = to_f(q[(size_t)n * hd + d]);
  __syncthreads();
  float m = NEG_INF, l = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  attend<T>(s1, n, page, hd, q_s, s_sh, scale, m, l, acc);
  if (has_second) attend<T>(s2, n, page, hd, q_s, s_sh, scale, m, l, acc);
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    const int d = tid + i * THREADS;
    if (d < hd) store(&out[(size_t)n * hd + d], acc[i] / denom);
  }
}

int launch(const void* q, const Segment& s1, const Segment& s2, void* out,
           int N, int hd, int page, int dtype, void* stream) {
  if (N <= 0) return 0;
  if (hd <= 0 || hd > MAX_HD || page <= 0) return (int)cudaErrorInvalidValue;
  const int has_second = s2.k != nullptr ? 1 : 0;
  const size_t smem = (size_t)(hd + page) * sizeof(float);
  const float scale = 1.f / sqrtf((float)hd);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    paged_decode_kernel<float><<<N, THREADS, smem, st>>>(
        static_cast<const float*>(q), s1, s2, has_second,
        static_cast<float*>(out), hd, page, scale);
  } else if (dtype == 1) {
    paged_decode_kernel<__nv_bfloat16><<<N, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), s1, s2, has_second,
        static_cast<__nv_bfloat16*>(out), hd, page, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. k2 == nullptr means one segment.
extern "C" int paged_decode(const void* q,
                            const void* k1, const void* v1, const int* table1,
                            const int* lengths1, int max_pages1,
                            const void* k2, const void* v2, const int* table2,
                            const int* lengths2, int max_pages2,
                            void* out, int N, int hd, int page, int dtype,
                            void* stream) {
  const Segment s1{k1, v1, table1, lengths1, max_pages1, nullptr, nullptr, 0};
  const Segment s2{k2, v2, table2, lengths2, max_pages2, nullptr, nullptr, 0};
  return launch(q, s1, s2, out, N, hd, page, dtype, stream);
}

// The first segment read through sel [N, k_pages] / n_sel [N]; the
// optional second segment (the ring) is read whole, as in paged_decode.
extern "C" int paged_decode_selected(const void* q,
                                     const void* k1, const void* v1,
                                     const int* table1, const int* lengths1,
                                     int max_pages1, const int* sel,
                                     const int* n_sel, int k_pages,
                                     const void* k2, const void* v2,
                                     const int* table2, const int* lengths2,
                                     int max_pages2, void* out, int N, int hd,
                                     int page, int dtype, void* stream) {
  if (sel == nullptr || n_sel == nullptr || k_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const Segment s1{k1, v1, table1, lengths1, max_pages1, sel, n_sel, k_pages};
  const Segment s2{k2, v2, table2, lengths2, max_pages2, nullptr, nullptr, 0};
  return launch(q, s1, s2, out, N, hd, page, dtype, stream);
}
