// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan_pallas (Pallas TPU
// kernel). Computes, for a, b [B, S, D] float32 (contiguous),
//     h[:, t] = a[:, t] * h[:, t-1] + b[:, t],   h[:, -1] = 0,
// into a new h [B, S, D] float32, for any S >= 1 and D >= 1 (the Pallas
// kernel's S % bt and D % bd asserts are tiling artefacts, not part of the
// function). Each step is the reference's a*h + b rounded after each
// operation (__fmul_rn then __fadd_rn, which nvcc never contracts into an
// FMA), so the kernel gives the bits of the plain PyTorch loop.
//
// What bounds it on this card: bytes. It reads a and b and writes h once,
// 12 bytes per element (201 MB at B 1, S 4096, D 4096: 0.060 ms at
// 3.35 TB/s); the arithmetic is two operations per element. The recurrence
// is sequential in t, so a first, simple kernel parallelises over (B, D)
// only: at B 1, D 4096 that is 4096 threads, one warp per SM, and the time
// is set by how many loads each thread keeps in flight, not by the bus.
// What the design does about it: one thread per (batch, channel) walks t;
// neighbouring threads take neighbouring channels, so every load and store
// of a warp is one coalesced 128-byte line. CTAs are 32 channels wide when
// B*D is small (128 CTAs at B*D 4096, about one per SM) and 64 otherwise.
// The loads of the next U = 8 steps are issued before the current U steps'
// dependent products (a register double buffer), so each thread has 16
// loads in flight instead of waiting a full load latency per step. The
// time-blocked three-phase scan (per-chunk products and carries in
// parallel over time, then a carry pass and a fix-up) would reach the
// bytes bound at B 1; it is work for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int U = 8;  // time steps per register block

__device__ __forceinline__ void load_block(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           size_t off, size_t stride, int n,
                                           float (&av)[U], float (&bv)[U]) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    if (i < n) {
      av[i] = __ldcs(a + off + (size_t)i * stride);
      bv[i] = __ldcs(b + off + (size_t)i * stride);
    }
  }
}

__global__ void rglru_scan_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ h, int B, int S, int D) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= (long long)B * D) return;
  const int bi = (int)(c / D);
  const int d = (int)(c - (long long)bi * D);
  const size_t stride = (size_t)D;
  const size_t base = (size_t)bi * S * D + d;

  float av[U], bv[U], an[U], bn[U];
  float acc = 0.f;
  load_block(a, b, base, stride, min(U, S), av, bv);
  for (int t0 = 0; t0 < S; t0 += U) {
    const int n = min(U, S - t0);
    const int t1 = t0 + U;
    if (t1 < S) load_block(a, b, base + (size_t)t1 * stride, stride,
                           min(U, S - t1), an, bn);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (i < n) {
        acc = __fadd_rn(__fmul_rn(av[i], acc), bv[i]);
        __stcs(h + base + (size_t)(t0 + i) * stride, acc);
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      av[i] = an[i];
      bv[i] = bn[i];
    }
  }
}

}  // namespace

extern "C" int rglru_scan_f32(const float* a, const float* b, float* h,
                              int B, int S, int D, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return 0;
  const long long n = (long long)B * D;
  const int threads = n >= 64LL * 132 ? 64 : 32;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rglru_scan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      a, b, h, B, S, D);
  return (int)cudaGetLastError();
}
