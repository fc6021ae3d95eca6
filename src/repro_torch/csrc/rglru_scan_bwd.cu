// Backward of the RG-LRU linear recurrence (rglru_scan.cu) for Hopper
// (sm_90a).
//
// Replaces: the gradient of src/repro/kernels/rglru_scan.py::
// rglru_scan_pallas. The Pallas kernel is forward-only; the reference
// trains through jax.value_and_grad of its associative scan
// (src/repro/models/rglru.py::rglru_scan; src/repro/training/trainer.py),
// whose gradient this computes. For h_t = a_t h_{t-1} + b_t (h_{-1} = 0)
// over a, b, h [B, S, D] float32 and the gradient dy of h:
//
//   dh_t = dy_t + a_{t+1} dh_{t+1}    (dh_S = 0)
//   da_t = dh_t h_{t-1}               (h_{-1} = 0)
//   db_t = dh_t
//
// into new da, db [B, S, D] float32, for any S >= 1, D >= 1, B >= 1. A
// state carried into the forward is folded into b[:, 0] by the caller
// (models/rglru.py), so its gradient is autograd's of that fold.
//
// It reads the forward's h (saved by the autograd Function) rather than
// recompute it: h costs the 4 bytes per element that b would, and
// recomputing h per chunk would need the forward's chained carries again.
// Under torch.utils.checkpoint the forward runs again first; it is
// bitwise repeatable, so the h read here is the h the loss saw.
//
// What bounds it on this card: bytes. It reads a, h and dy and writes da
// and db once, 20 bytes per element (335.5 MB at B 1, S 4096, D 4096:
// 0.100 ms at 3.35 TB/s); the arithmetic is four operations per element.
//
// What the design does about it: the forward's chunked scan run backwards
// in time, in one pass and a fixed order. Chunks of L = NSUB x LS = 128
// steps at the forward's boundaries; a CTA takes one chunk of 32
// neighbouring channels (lane = channel, so every load and store of a
// warp is one 128-byte line), and each of its NSUB = 8 warps one sub-chunk
// of LS = 16 steps, whose 48 loads (a_t, dy_t, h_{t-1}) it issues at once.
// What flows down from step t + 1 into step t is r = a_{t+1} dh_{t+1}:
// step t takes dh_t = dy_t + r and hands on r = a_t dh_t, so a sub-chunk
// needs only its own a's.
//  1. Each thread folds its sub-chunk from r = 0, top step first, into
//     (A, B), the map r_out = A r_in + B (A the product of a).
//  2. Warp 0 composes the sub-chunks' maps from the top one down: the map
//     into each sub-chunk, and the chunk's own (A_c, B_c).
//  3. It waits for the r that chunk c + 1 (same channels) hands down,
//     published by that chunk's CTA, and publishes A_c r + B_c for chunk
//     c - 1 at once: one hand-off per chunk, S / L in sequence, each a
//     64-bit word {1, value} per channel stored and polled at gpu scope.
//  4. Every thread scans its sub-chunk again from its r in, from the
//     values still in its registers, and writes da and db.
// CTAs take (chunk, channel block) tickets from an atomic counter, the
// last chunk first, so the CTA a ticket waits for took an earlier ticket
// and is running or done: the wait cannot deadlock, whatever order the
// card starts CTAs in. The hand-offs are folded in the same order on every
// call, so two calls give the same bits. Within a sub-chunk the steps are
// the plain loop's (kernels/rglru_scan.py::rglru_scan_bwd_plain); only
// the r at sub-chunk boundaries is regrouped, as in the forward (a in
// (0, 1): within 1e-4 of each gradient's largest magnitude). Steps past S
// are the identity (a 1, dy 0) and are not stored. The wrapper allocates
// the ticket counter and the carry words with torch.zeros on every call.
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

// scratch[0]: the ticket counter; scratch[1 + c nch + ch]: {1, r} handed
// from chunk c + 1 down into chunk c for channel ch (0 until published)
__global__ void __launch_bounds__(NSUB * 32)
rglru_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                      const float* __restrict__ dy, float* __restrict__ da,
                      float* __restrict__ db, int S, int D, long long nch, int nblocks,
                      int nchunks, unsigned long long* scratch) {
  __shared__ int ticket_s;
  __shared__ float sA[NSUB][CH], sB[NSUB][CH];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    ticket_s = (int)atomicAdd(reinterpret_cast<unsigned int*>(scratch), 1u);
  __syncthreads();
  const int ticket = ticket_s;
  const int cr = ticket / nblocks;  // chunks from the end
  const int c = nchunks - 1 - cr;
  const long long ch = (long long)(ticket - cr * nblocks) * CH + lane;
  const bool live = ch < nch;
  const long long bi = live ? ch / D : 0;
  const int d = live ? (int)(ch - bi * D) : 0;
  const int t0 = c * L + w * LS;
  const size_t base = ((size_t)bi * S + t0) * D + d;

  // a_t, dy_t and h_{t-1} of the sub-chunk's steps
  float av[LS], gv[LS], hv[LS];
#pragma unroll
  for (int i = 0; i < LS; ++i) {
    const bool ok = live && t0 + i < S;
    av[i] = ok ? __ldcs(a + base + (size_t)i * D) : 1.f;
    gv[i] = ok ? __ldcs(dy + base + (size_t)i * D) : 0.f;
    hv[i] = ok && t0 + i > 0 ? __ldcs(h + base + (size_t)i * D - D) : 0.f;
  }
  // 1. the sub-chunk's map from r = 0, top step first
  float A = 1.f, B = 0.f;
#pragma unroll
  for (int i = LS - 1; i >= 0; --i) {
    B = av[i] * (gv[i] + B);
    A *= av[i];
  }
  sA[w][lane] = A;
  sB[w][lane] = B;
  __syncthreads();

  if (w == 0) {
    // 2. the map into each sub-chunk, composed from the top one down;
    // (pa, pb) ends as the chunk's own
    float pa = 1.f, pb = 0.f;
#pragma unroll
    for (int k = NSUB - 1; k >= 0; --k) {
      const float ak = sA[k][lane];
      const float bk = sB[k][lane];
      sA[k][lane] = pa;
      sB[k][lane] = pb;
      pb = fmaf(ak, pb, bk);
      pa *= ak;
    }
    // 3. the r handed down from chunk c + 1, then the r for chunk c - 1
    float carry = 0.f;
    if (c + 1 < nchunks && live) {
      const unsigned long long* src = scratch + 1 + (size_t)c * nch + ch;
      unsigned long long v;
      while (((v = ld_relaxed(src)) >> 32) == 0ull) {
      }
      carry = __uint_as_float((unsigned)v);
    }
    if (c > 0 && live)
      st_relaxed(scratch + 1 + (size_t)(c - 1) * nch + ch,
                 (1ull << 32) | __float_as_uint(fmaf(pa, carry, pb)));
#pragma unroll
    for (int k = 0; k < NSUB; ++k) sB[k][lane] = fmaf(sA[k][lane], carry, sB[k][lane]);
  }
  __syncthreads();

  // 4. the sub-chunk again from its r in, top step first
  float r = sB[w][lane];
#pragma unroll
  for (int i = LS - 1; i >= 0; --i) {
    const float dh = gv[i] + r;
    r = av[i] * dh;
    if (live && t0 + i < S) {
      __stcs(db + base + (size_t)i * D, dh);
      __stcs(da + base + (size_t)i * D, dh * hv[i]);
    }
  }
}

}  // namespace

// The carry words the wrapper must zero for these shapes (ticket counter
// included), as 64-bit words.
extern "C" long long rglru_scan_bwd_scratch_words(int B, int S, int D) {
  const long long nchunks = (S + L - 1) / L;
  return 1 + (nchunks - 1) * (long long)B * D;
}

// da, db [B, S, D] from a, the forward's h and dy, all float32 and
// contiguous; scratch: rglru_scan_bwd_scratch_words(B, S, D) zeroed 64-bit
// words. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rglru_scan_bwd_f32(const float* a, const float* h, const float* dy,
                                  float* da, float* db, int B, int S, int D,
                                  void* scratch, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  const long long nch = (long long)B * D;
  const long long nblocks = (nch + CH - 1) / CH;
  const long long nchunks = (S + L - 1) / L;
  if (nblocks * nchunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rglru_scan_bwd_kernel<<<(unsigned)(nblocks * nchunks), NSUB * 32, 0,
                          (cudaStream_t)stream>>>(
      a, h, dy, da, db, S, D, nch, (int)nblocks, (int)nchunks,
      static_cast<unsigned long long*>(scratch));
  return (int)cudaGetLastError();
}
