// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan_pallas (Pallas TPU
// kernel). Computes, for a, b [B, S, D] float32 (contiguous),
//     h[:, t] = a[:, t] * h[:, t-1] + b[:, t],   h[:, -1] = 0,
// into a new h [B, S, D] float32, for any S >= 1, D >= 1 and B >= 1 (the
// Pallas kernel's S % bt and D % bd asserts are tiling artefacts, not part
// of the function).
//
// What bounds it on this card: bytes. It reads a and b and writes h once,
// 12 bytes per element (201 MB at B 1, S 4096, D 4096: 0.060 ms at
// 3.35 TB/s); the arithmetic is two operations per element. The first
// kernel of this port walked t in one thread per (batch, channel): 4096
// threads at recurrentgemma-9b's B 1, D 4096, one warp per SM, bound by
// the loads each thread kept in flight (0.36 ms, 6x the bound).
//
// What the design does about it: a chunked scan in one pass, in a fixed
// order. Time is cut into chunks of L = NSUB x LS = 128 steps; a CTA takes
// one chunk of 32 neighbouring channels (lane = channel, so every load and
// store of a warp is one 128-byte line), and each of its NSUB = 8 warps one
// sub-chunk of LS = 16 steps, whose 32 loads it issues at once.
//  1. Each thread folds its sub-chunk from zero into (A, B), the map
//     h_end = A h_start + B (A the product of a, B the scan of b).
//  2. Warp 0 composes the sub-chunks' maps in order: the map into each
//     sub-chunk, and the chunk's own (A_c, B_c).
//  3. It waits for the carry h at the end of chunk c - 1, published by the
//     CTA of chunk c - 1 and the same channels, and publishes
//     carry_c+1 = A_c carry_c + B_c at once: one hand-off per chunk, S / L
//     in sequence (32 at S 4096), each a 64-bit word {1, value} per channel
//     stored and polled at gpu scope, so no fence is needed.
//  4. Every thread rescans its sub-chunk from its carry-in, from the a and
//     b still in its registers, and writes h.
// CTAs take (chunk, channel block) tickets from an atomic counter in
// chunk-major order, so the CTA a ticket waits for took an earlier ticket
// and is running or done: the wait cannot deadlock, whatever order the
// card starts CTAs in. The carries are folded in the same order on every
// call, so two calls on the same inputs give the same bits; a look-back
// over whichever predecessors are ready would regroup the products by
// timing. The products are regrouped at sub-chunk boundaries against the
// plain loop (each step rounded in turn): a lies in (0, 1), so h moves by
// a few ulps of |h|, within the 5e-5 limit, as the reference's own
// associative scan (models/rglru.py) regroups them too. Steps past S are
// the identity (a 1, b 0) and are not stored. The wrapper allocates the
// ticket counter and the carry words with torch.zeros on every call.
//
// The alternative, three launches in fixed order (per-chunk maps, carries
// over chunks, a fix-up re-reading a and b: 20 bytes per element), was not
// needed: the chained hand-off passes the card's tests.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;        // channels per CTA, one per lane
constexpr int NSUB = 8;       // warps per CTA, one sub-chunk each
constexpr int LS = 16;        // steps per sub-chunk
constexpr int L = NSUB * LS;  // steps per chunk

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// scratch[0]: the ticket counter; scratch[1 + c nch + ch]: {1, h} at the
// end of chunk c for channel ch (0 until published)
__global__ void __launch_bounds__(NSUB * 32)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int D, long long nch,
                  int nblocks, int nchunks, unsigned long long* scratch) {
  __shared__ int ticket_s;
  __shared__ float sA[NSUB][CH], sB[NSUB][CH];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    ticket_s = (int)atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  const int ticket = ticket_s;
  const int c = ticket / nblocks;
  const long long ch = (long long)(ticket - c * nblocks) * CH + lane;
  const bool live = ch < nch;
  const long long bi = live ? ch / D : 0;
  const int d = live ? (int)(ch - bi * D) : 0;
  const int t0 = c * L + w * LS;
  const size_t base = ((size_t)bi * S + t0) * D + d;

  float av[LS], bv[LS];
#pragma unroll
  for (int i = 0; i < LS; ++i) {
    const bool ok = live && t0 + i < S;
    av[i] = ok ? __ldcs(a + base + (size_t)i * D) : 1.f;
    bv[i] = ok ? __ldcs(b + base + (size_t)i * D) : 0.f;
  }
  // 1. the sub-chunk's map from zero
  float A = 1.f, B = 0.f;
#pragma unroll
  for (int i = 0; i < LS; ++i) {
    B = fmaf(av[i], B, bv[i]);
    A *= av[i];
  }
  sA[w][lane] = A;
  sB[w][lane] = B;
  __syncthreads();

  if (w == 0) {
    // 2. the map into each sub-chunk, composed in order; (pa, pb) ends as
    // the chunk's own
    float pa = 1.f, pb = 0.f;
#pragma unroll
    for (int k = 0; k < NSUB; ++k) {
      const float ak = sA[k][lane];
      const float bk = sB[k][lane];
      sA[k][lane] = pa;
      sB[k][lane] = pb;
      pb = fmaf(ak, pb, bk);
      pa *= ak;
    }
    // 3. the carry in, then the carry out
    float carry = 0.f;
    if (c > 0 && live) {
      const unsigned long long* src = scratch + 1 + (size_t)(c - 1) * nch + ch;
      unsigned long long v;
      while (((v = ld_relaxed(src)) >> 32) == 0ull) {
      }
      carry = __uint_as_float((unsigned)v);
    }
    if (c + 1 < nchunks && live)
      st_relaxed(scratch + 1 + (size_t)c * nch + ch,
                 (1ull << 32) | __float_as_uint(fmaf(pa, carry, pb)));
#pragma unroll
    for (int k = 0; k < NSUB; ++k) sB[k][lane] = fmaf(sA[k][lane], carry, sB[k][lane]);
  }
  __syncthreads();

  // 4. the sub-chunk again from its carry in
  float hv = sB[w][lane];
#pragma unroll
  for (int i = 0; i < LS; ++i) {
    hv = fmaf(av[i], hv, bv[i]);
    if (live && t0 + i < S) __stcs(h + base + (size_t)i * D, hv);
  }
}

}  // namespace

// The carry words the wrapper must zero for these shapes (ticket counter
// included), as 64-bit words.
extern "C" long long rglru_scan_scratch_words(int B, int S, int D) {
  const long long nchunks = (S + L - 1) / L;
  return 1 + (nchunks - 1) * (long long)B * D;
}

extern "C" int rglru_scan_f32(const float* a, const float* b, float* h,
                              int B, int S, int D, void* scratch, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  const long long nch = (long long)B * D;
  const long long nblocks = (nch + CH - 1) / CH;
  const long long nchunks = (S + L - 1) / L;
  if (nblocks * nchunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rglru_scan_kernel<<<(unsigned)(nblocks * nchunks), NSUB * 32, 0,
                      (cudaStream_t)stream>>>(
      a, b, h, S, D, nch, (int)nblocks, (int)nchunks,
      static_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}
