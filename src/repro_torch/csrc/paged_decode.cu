// Single-query paged decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode.py::paged_decode (Pallas TPU
// kernel). One query row per query stream attends over its kv stream's
// pages of a [P, 16, hd] K/V pool through page_table[kv, j], masked to
// lengths[kv] tokens, with the Pallas kernel's online softmax: m_safe = 0
// while no token has been seen, alpha = 0 on the first live page, and the
// output acc / max(l, 1e-30), so a length-0 stream returns 0. Query stream
// n = kv * G + h reads kv stream kv (GQA, streams ordered (b, kv head,
// group)); G = 1 is the reference's one-table-per-query-stream layout.
//
// An optional SECOND segment (its own pool, page table and lengths) is
// folded into the same softmax. The dual cache's decode read uses it:
// segment 1 is the global cache (gcnt tokens), segment 2 the local ring
// (min(t, W) tokens), each viewed as pages of 16 in place.
//
// The SELECTED variant replaces src/repro/kernels/paged_decode.py::
// paged_decode_selected (Quest read-time selection, paper §5.4): the first
// segment carries sel [Nkv, K] logical page ids (ascending) and n_sel
// [Nkv]. Walk position j < K is logical page sel[kv, j] (read through
// table[kv, logical], its tokens at logical * 16 + t masked to the length)
// when j < n_sel[kv]. A page at or past the length (or outside the table)
// adds exactly 0 to the recurrence (m_safe, zero alpha) and is skipped.
// Both entries share every line below but the resolution of a walk
// position, so at the identity ids with K = every page the selected read
// sees the same splits, live pages and order: bitwise paged_decode.
//
// A START offset (paged_decode with starts1 non-null): the dense
// baseline's windowed read of local-attention blocks (the reference's
// attn_decode_dense(window=), src/repro/models/attention.py:428-453,
// outside any Pallas kernel). Segment 1 of kv stream kv then holds the
// tokens [starts[kv], min(lengths[kv], starts[kv] + span)); its walk
// begins at the page of the start (walk position j is logical page
// starts[kv] / 16 + j) and is `walk1` positions long, enough for span
// tokens from any offset, so the split plan counts only the pages a
// window can touch. The first live page is masked below the start.
// Without starts every line runs as before.
//
// The LOG-SUM-EXP (lse non-null, either entry): besides out, one f32
// per query row, m + log(l) of the read's online softmax (scores already
// scaled by hd^-1/2), -inf for a row that saw no token (out 0). The
// context-parallel decode combines the "data" ranks' reads of their
// blocks of the global cache (or of the dense buffer, or of the Quest-
// selected pages each block holds) by it (src/repro_torch/sharding/comm.py::
// combine_lse); the split combine already holds m and l and writes it.
//
// What bounds it on this card: bytes at long caches (each live K/V page is
// read once per kv stream for 4 * hd * G FLOPs per token, far below the
// card's FLOP/byte ratio), latency at serving sizes (a few dozen pages per
// stream, a few dozen kv streams).
// What the design does about it:
// - Split-K (flash-decoding). The walk [segment 1 positions ‖ segment 2
//   positions] is cut into splits of `pps` positions; one CTA per (kv
//   stream, split, head chunk) walks its split and writes a partial
//   (m, l, acc[heads, hd]) to scratch; combine_kernel merges the partials
//   in a fixed order, its threads splitting the splits between them (no
//   atomics, so two calls agree bitwise). The plan
//   (kernels/paged_decode.py::split_plan) depends on shapes only: lengths
//   and ids stay on the card, and a split with no live page exits early.
//   With one split the walk writes the output itself (the same bits).
// - GQA-shared pages. A CTA serves up to `heads` query heads of its kv
//   stream: their rows sit in shared memory once, each staged page serves
//   all of them, and (head, token) scores are spread over the warps.
// - Loads in flight. The split's live pages (table entries, ids) are
//   resolved and compacted up front; K and V pages then stream through a
//   2-3 stage cp.async ring, so the next page loads while the current one
//   is reduced. Page max and sum are half-warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int PAGE = 16;       // tokens per page
constexpr int THREADS = 128;   // 4 warps x 4 eight-lane segments = 16 tokens
constexpr int MAX_HD = 256;
constexpr int KCH = MAX_HD / 4 / 8;  // 4-element chunks of a K row per lane
constexpr int MAX_ACC = 8;           // float4 accumulators per thread (P.V)
constexpr int COMBINE_THREADS = 512;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Segment {
  const void* k;       // [P, 16, hd]
  const void* v;
  const int* table;    // [Nkv, max_pages]
  const int* lengths;  // [Nkv]
  int max_pages;
  const int* starts;   // [Nkv] first token read, or nullptr (from 0)
  int span;            // with starts: the most tokens read from the start
};

struct Walk {
  Segment s1, s2;
  int p1;              // walk positions of segment 1: max_pages1, or K
  int p2;              // walk positions of segment 2 (0: one segment)
  const int* sel;      // [Nkv, K] logical page ids, or nullptr
  const int* n_sel;    // [Nkv]
};

struct Plan {
  int group;           // query heads per kv stream
  int heads;           // query heads per CTA
  int pps;             // walk positions per split
  int nsplit;
  int hd;
  float scale;
};

// Walk position j of kv stream kv: its physical page, live tokens [lo, nv)
// of the page and segment; false if it adds nothing (past the length,
// below the start, past n_sel, or an id outside the table).
__device__ __forceinline__ bool resolve(const Walk& w, int kv, int j,
                                        int& phys, int& lo, int& nv, int& seg) {
  const Segment& s = j < w.p1 ? w.s1 : w.s2;
  int logical = j < w.p1 ? j : j - w.p1;
  if (j < w.p1 && w.sel != nullptr) {
    if (j >= w.n_sel[kv]) return false;
    logical = w.sel[(size_t)kv * w.p1 + j];
    if (logical < 0 || logical >= s.max_pages) return false;
  }
  int len = s.lengths[kv];
  lo = 0;
  if (s.starts != nullptr) {
    const int first = max(s.starts[kv], 0);
    len = min(len, first + s.span);
    logical += first / PAGE;
    if (logical >= s.max_pages) return false;
    lo = max(first - logical * PAGE, 0);
  }
  if (logical * PAGE >= len) return false;
  nv = min(PAGE, len - logical * PAGE);
  if (lo >= nv) return false;
  phys = s.table[(size_t)kv * s.max_pages + logical];
  seg = j < w.p1 ? 0 : 1;
  return true;
}

template <typename T, int STAGES>
__global__ void __launch_bounds__(THREADS)
split_kernel(const T* __restrict__ q, Walk w, Plan pl, T* __restrict__ out,
             float* __restrict__ lse, float* __restrict__ part_acc,
             float2* __restrict__ part_ml) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = pl.hd;
  const size_t page_bytes = (size_t)PAGE * hd * sizeof(T);
  // [STAGES][K page, V page] | q [heads][hd] | s [heads][16] | alpha, m, l
  // [heads] | live pages [pps] | live count
  unsigned char* stages = smem;
  float* q_s = reinterpret_cast<float*>(smem + STAGES * 2 * page_bytes);
  float* s_sh = q_s + pl.heads * hd;
  float* alpha_sh = s_sh + pl.heads * PAGE;
  float* m_sh = alpha_sh + pl.heads;
  float* l_sh = m_sh + pl.heads;
  int2* live = reinterpret_cast<int2*>(l_sh + pl.heads + (pl.heads & 1));
  int* n_live_sh = reinterpret_cast<int*>(live + pl.pps);

  const int kv = blockIdx.x;
  const int split = blockIdx.y;
  const int h0 = blockIdx.z * pl.heads;
  const int hc = min(pl.heads, pl.group - h0);  // heads of this CTA
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row0 = (size_t)kv * pl.group + h0;  // first query row

  // the split's live pages, compacted in walk order by warp 0
  if (warp == 0) {
    const int j0 = split * pl.pps;
    const int j1 = min(j0 + pl.pps, w.p1 + w.p2);
    int base = 0;
    for (int c = j0; c < j1; c += 32) {
      int phys = 0, lo = 0, nv = 0, seg = 0;
      const bool ok = c + lane < j1 && resolve(w, kv, c + lane, phys, lo, nv, seg);
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (ok)
        live[base + __popc(mask & ((1u << lane) - 1u))] =
            make_int2(phys, nv | (seg << 8) | (lo << 16));
      base += __popc(mask);
    }
    if (lane == 0) *n_live_sh = base;
  }
  for (int e = tid; e < hc * hd; e += THREADS) q_s[e] = to_f(q[row0 * hd + e]);
  for (int h = tid; h < hc; h += THREADS) {
    m_sh[h] = NEG_INF;
    l_sh[h] = 0.f;
  }
  __syncthreads();
  const int n_live = *n_live_sh;

  // P.V ownership: a float4 column of the head dim, heads hg, hg + HG, ...
  const int c4 = hd >> 2;
  const int hgroups = THREADS / c4;
  const int col = tid % c4;
  const int hg = tid / c4;
  float4 acc[MAX_ACC];
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);

  auto issue = [&](int idx) {
    const int2 e = live[idx];
    const Segment& sg = ((e.y >> 8) & 1) ? w.s2 : w.s1;
    const size_t off = (size_t)e.x * page_bytes;
    const unsigned char* ks = static_cast<const unsigned char*>(sg.k) + off;
    const unsigned char* vs = static_cast<const unsigned char*>(sg.v) + off;
    unsigned char* dk = stages + (size_t)(idx % STAGES) * 2 * page_bytes;
    unsigned char* dv = dk + page_bytes;
    for (size_t c = (size_t)tid * 16; c < page_bytes; c += THREADS * 16) {
      async_copy::cp16(dk + c, ks + c);
      async_copy::cp16(dv + c, vs + c);
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_live) issue(s);
    async_copy::commit();
  }

  const int seg8 = lane >> 3;  // this lane's token within the warp's four
  const int j8 = lane & 7;     // and its place among the token's 8 lanes
  const int tok = warp * 4 + seg8;
  for (int idx = 0; idx < n_live; ++idx) {
    async_copy::wait<STAGES - 2>();
    __syncthreads();  // page idx is visible; page idx - 1 is consumed
    if (idx + STAGES - 1 < n_live) issue(idx + STAGES - 1);
    async_copy::commit();
    const T* k_s = reinterpret_cast<const T*>(stages + (size_t)(idx % STAGES) * 2 * page_bytes);
    const T* v_s = reinterpret_cast<const T*>(reinterpret_cast<const unsigned char*>(k_s) + page_bytes);
    const int nv = live[idx].y & 0xff;
    const int lo = live[idx].y >> 16;  // the first live token of the page

    // scores: eight lanes per token split the head dim, every head of the
    // CTA against the token's K row held in registers
    float4 kr[KCH];
#pragma unroll
    for (int i = 0; i < KCH; ++i) {
      const int c = j8 + 8 * i;
      kr[i] = c < c4 ? load4(k_s + tok * hd + 4 * c) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int h = 0; h < hc; ++h) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < KCH; ++i) {
        const int c = j8 + 8 * i;
        if (c < c4) {
          const float4 qv = load4(q_s + h * hd + 4 * c);
          part = fmaf(qv.x, kr[i].x, part);
          part = fmaf(qv.y, kr[i].y, part);
          part = fmaf(qv.z, kr[i].z, part);
          part = fmaf(qv.w, kr[i].w, part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (j8 == 0)
        s_sh[h * PAGE + tok] = (tok < nv && tok >= lo) ? part * pl.scale : NEG_INF;
    }
    __syncthreads();

    // the page's max and sum per head: a half-warp per head
    for (int hb = warp * 2; hb < hc; hb += 8) {
      const int h = hb + (lane >> 4);
      const int t = lane & 15;
      const bool ok = h < hc;
      const float s = ok ? s_sh[h * PAGE + t] : NEG_INF;
      float mt = s;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = ok ? m_sh[h] : NEG_INF;
      const float m_new = fmaxf(m_old, mt);
      const float m_safe = (m_new <= NEG_INF * 0.5f) ? 0.f : m_new;
      const float alpha = (m_old <= NEG_INF * 0.5f) ? 0.f : expf(m_old - m_safe);
      const float p = expf(s - m_safe);
      float ps = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      if (ok) {
        s_sh[h * PAGE + t] = p;
        if (t == 0) {
          l_sh[h] = l_sh[h] * alpha + ps;
          m_sh[h] = m_new;
          alpha_sh[h] = alpha;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V over the page's live tokens
    if (hg < hgroups) {
#pragma unroll
      for (int a = 0; a < MAX_ACC; ++a) {
        const int h = hg + a * hgroups;
        if (h < hc) {
          const float al = alpha_sh[h];
          acc[a].x *= al;
          acc[a].y *= al;
          acc[a].z *= al;
          acc[a].w *= al;
        }
      }
      for (int t = lo; t < nv; ++t) {
        const float4 vv = load4(v_s + t * hd + 4 * col);
#pragma unroll
        for (int a = 0; a < MAX_ACC; ++a) {
          const int h = hg + a * hgroups;
          if (h < hc) {
            const float p = s_sh[h * PAGE + t];
            acc[a].x = fmaf(p, vv.x, acc[a].x);
            acc[a].y = fmaf(p, vv.y, acc[a].y);
            acc[a].z = fmaf(p, vv.z, acc[a].z);
            acc[a].w = fmaf(p, vv.w, acc[a].w);
          }
        }
      }
    }
  }
  async_copy::wait<0>();

  if (hg >= hgroups) return;
  const size_t split_row = ((size_t)kv * pl.nsplit + split) * pl.group + h0;
#pragma unroll
  for (int a = 0; a < MAX_ACC; ++a) {
    const int h = hg + a * hgroups;
    if (h >= hc) continue;
    if (pl.nsplit == 1) {
      const float denom = fmaxf(l_sh[h], 1e-30f);
      T* o = out + (row0 + h) * hd + 4 * col;
      store(o, acc[a].x / denom);
      store(o + 1, acc[a].y / denom);
      store(o + 2, acc[a].z / denom);
      store(o + 3, acc[a].w / denom);
      if (lse != nullptr && col == 0)
        lse[row0 + h] = l_sh[h] > 0.f ? m_sh[h] + logf(l_sh[h]) : -INFINITY;
    } else {
      // a split with no live page leaves m = NEG_INF and its acc unwritten:
      // the combine skips it
      if (n_live > 0)
        *reinterpret_cast<float4*>(part_acc + (split_row + h) * hd + 4 * col) = acc[a];
      if (col == 0) part_ml[split_row + h] = make_float2(m_sh[h], l_sh[h]);
    }
  }
}

// out[row] = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30) with
// w_s = exp(m_s - m_safe), m_safe the max over splits (0 if none saw a
// token); splits with no token (m_s = NEG_INF) add nothing. One block per
// query row: its threads are groups of hd / 4 (one float4 column each);
// group j sums splits j, j + groups, ... in order, and group 0 adds the
// groups' sums in group order, so the result does not vary between calls.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
combine_kernel(const float* __restrict__ part_acc,
               const float2* __restrict__ part_ml, T* __restrict__ out,
               float* __restrict__ lse, int group, int nsplit, int hd) {
  __shared__ float red_m[COMBINE_THREADS];
  __shared__ float red_l[COMBINE_THREADS];
  __shared__ float4 red_a[COMBINE_THREADS];
  const int row = blockIdx.x;
  const int kv = row / group;
  const int h = row - kv * group;
  const int c4 = hd >> 2;
  const int groups = COMBINE_THREADS / c4;
  const int tid = threadIdx.x;
  const int grp = tid / c4;
  const int col = tid - grp * c4;
  const bool active = grp < groups;
  const size_t base = (size_t)kv * nsplit * group + h;
  float m = NEG_INF;
  if (active) {
#pragma unroll 4
    for (int s = grp; s < nsplit; s += groups)
      m = fmaxf(m, part_ml[base + (size_t)s * group].x);
  }
  red_m[tid] = m;
  __syncthreads();
  for (int g2 = 0; g2 < groups; ++g2) m = fmaxf(m, red_m[g2 * c4]);
  const float m_safe = (m <= NEG_INF * 0.5f) ? 0.f : m;
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // branch-free, so the loads of several splits are in flight at once; a
  // dead split's acc (never written) is read but selected away
  if (active) {
#pragma unroll 4
    for (int s = grp; s < nsplit; s += groups) {
      const float2 ml = part_ml[base + (size_t)s * group];
      float4 a = *reinterpret_cast<const float4*>(
          part_acc + (base + (size_t)s * group) * hd + 4 * col);
      const bool live = ml.x > NEG_INF * 0.5f;
      const float wgt = live ? expf(ml.x - m_safe) : 0.f;
      if (!live) a = make_float4(0.f, 0.f, 0.f, 0.f);
      l = fmaf(wgt, live ? ml.y : 0.f, l);
      acc.x = fmaf(wgt, a.x, acc.x);
      acc.y = fmaf(wgt, a.y, acc.y);
      acc.z = fmaf(wgt, a.z, acc.z);
      acc.w = fmaf(wgt, a.w, acc.w);
    }
  }
  red_l[tid] = l;
  red_a[tid] = acc;
  __syncthreads();
  if (grp != 0) return;
  for (int g2 = 1; g2 < groups; ++g2) {
    const float4 a = red_a[g2 * c4 + col];
    l += red_l[g2 * c4 + col];
    acc.x += a.x;
    acc.y += a.y;
    acc.z += a.z;
    acc.w += a.w;
  }
  const float denom = fmaxf(l, 1e-30f);
  T* o = out + (size_t)row * hd + 4 * col;
  store(o, acc.x / denom);
  store(o + 1, acc.y / denom);
  store(o + 2, acc.z / denom);
  store(o + 3, acc.w / denom);
  if (lse != nullptr && col == 0)
    lse[row] = l > 0.f ? m_safe + logf(l) : -INFINITY;
}

size_t smem_bytes(const Plan& pl, int stages, size_t elem) {
  const size_t page_bytes = (size_t)PAGE * pl.hd * elem;
  const size_t floats = (size_t)pl.heads * pl.hd + (size_t)pl.heads * PAGE +
                        3 * (size_t)pl.heads + (pl.heads & 1);
  return stages * 2 * page_bytes + floats * sizeof(float) +
         (size_t)pl.pps * sizeof(int2) + sizeof(int);
}

template <typename T, int STAGES>
int launch_split(const T* q, const Walk& w, const Plan& pl, int nkv, int chunks,
                 T* out, float* lse, float* part_acc, float2* part_ml,
                 cudaStream_t st) {
  const size_t smem = smem_bytes(pl, STAGES, sizeof(T));
  if (smem > 48 * 1024) {  // above the default dynamic limit
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<T, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  split_kernel<T, STAGES><<<dim3(nkv, pl.nsplit, chunks), THREADS, smem, st>>>(
      q, w, pl, out, lse, part_acc, part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || pl.nsplit == 1) return (int)err;
  combine_kernel<T><<<nkv * pl.group, COMBINE_THREADS, 0, st>>>(
      part_acc, part_ml, out, lse, pl.group, pl.nsplit, pl.hd);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const Walk& w, const Plan& pl, int nkv,
                 int chunks, void* out, float* lse, float* part,
                 cudaStream_t st) {
  float* part_acc = part;  // hd is a multiple of 4: part_ml stays aligned
  float2* part_ml = reinterpret_cast<float2*>(
      part + (size_t)nkv * pl.nsplit * pl.group * pl.hd);
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
  if (pl.pps <= 2)
    return launch_split<T, 2>(qt, w, pl, nkv, chunks, ot, lse, part_acc, part_ml, st);
  return launch_split<T, 3>(qt, w, pl, nkv, chunks, ot, lse, part_acc, part_ml, st);
}

// N query rows of hd; G heads per kv stream; `heads` per CTA; `pps` walk
// positions per split. part: Nkv * nsplit * G * (hd + 2) floats of
// scratch, acc then (m, l) (unused, may be null, with one split).
int launch(const void* q, Walk w, void* out, float* lse, float* part, int N,
           int G, int hd, int page, int pps, int heads, int dtype,
           void* stream) {
  if (N <= 0) return 0;
  const size_t elem = dtype == 0 ? 4 : 2;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (page != PAGE || hd <= 0 || hd > MAX_HD || (hd * elem) % 16 != 0 ||
      G <= 0 || N % G != 0 || heads <= 0 || heads > G ||
      pps <= 0 || w.p1 < 0 || w.p2 < 0)
    return (int)cudaErrorInvalidValue;
  // every head of a CTA needs its accumulators: at most MAX_ACC per thread
  if ((heads + THREADS / (hd / 4) - 1) / (THREADS / (hd / 4)) > MAX_ACC)
    return (int)cudaErrorInvalidValue;
  const int walk = w.p1 + w.p2;
  const int nsplit = walk > 0 ? (walk + pps - 1) / pps : 1;
  if (nsplit > 65535 || (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nkv = N / G;
  const int chunks = (G + heads - 1) / heads;
  const Plan pl{G, heads, pps, nsplit, hd, 1.f / sqrtf((float)hd)};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_typed<float>(q, w, pl, nkv, chunks, out, lse, part, st);
  return launch_typed<__nv_bfloat16>(q, w, pl, nkv, chunks, out, lse, part, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. k2 == nullptr means one segment.
// lse: [N] f32 log-sum-exp of each row's read, or nullptr.
// Tables, lengths (and ids, starts) are per kv stream: [N / G, ...].
// starts1 == nullptr: segment 1 from token 0, walk1 ignored (its walk is
// max_pages1). Else segment 1 is read over [starts1, min(lengths1,
// starts1 + span1)) by a walk of walk1 <= max_pages1 positions from the
// start's page (at least the pages span1 tokens can touch).
extern "C" int paged_decode(const void* q,
                            const void* k1, const void* v1, const int* table1,
                            const int* lengths1, int max_pages1,
                            const int* starts1, int span1, int walk1,
                            const void* k2, const void* v2, const int* table2,
                            const int* lengths2, int max_pages2,
                            void* out, float* lse, float* part, int N, int G,
                            int hd, int page, int pps, int heads, int dtype,
                            void* stream) {
  const bool two = k2 != nullptr;
  if (starts1 != nullptr && (span1 <= 0 || walk1 <= 0 || walk1 > max_pages1))
    return (int)cudaErrorInvalidValue;
  const Walk w{{k1, v1, table1, lengths1, max_pages1, starts1, span1},
               {two ? k2 : k1, two ? v2 : v1, table2, lengths2, max_pages2,
                nullptr, 0},
               starts1 != nullptr ? walk1 : max_pages1, two ? max_pages2 : 0,
               nullptr, nullptr};
  return launch(q, w, out, lse, part, N, G, hd, page, pps, heads, dtype,
                stream);
}

// The first segment read through sel [N / G, k_pages] / n_sel [N / G];
// the optional second segment (the ring) is read whole, as in paged_decode.
extern "C" int paged_decode_selected(const void* q,
                                     const void* k1, const void* v1,
                                     const int* table1, const int* lengths1,
                                     int max_pages1, const int* sel,
                                     const int* n_sel, int k_pages,
                                     const void* k2, const void* v2,
                                     const int* table2, const int* lengths2,
                                     int max_pages2, void* out, float* lse,
                                     float* part, int N, int G, int hd,
                                     int page, int pps, int heads, int dtype,
                                     void* stream) {
  if (sel == nullptr || n_sel == nullptr || k_pages <= 0)
    return (int)cudaErrorInvalidValue;
  const bool two = k2 != nullptr;
  const Walk w{{k1, v1, table1, lengths1, max_pages1, nullptr, 0},
               {two ? k2 : k1, two ? v2 : v1, table2, lengths2, max_pages2,
                nullptr, 0},
               k_pages, two ? max_pages2 : 0, sel, n_sel};
  return launch(q, w, out, lse, part, N, G, hd, page, pps, heads, dtype,
                stream);
}
