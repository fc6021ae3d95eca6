// Asynchronous global -> shared copies (cp.async, sm_80 and later) shared
// by the port's decode and prefill attention kernels. A thread issues its
// copies, closes them into a group with cp_async_commit(), and later waits
// until at most N of its groups are still in flight; a __syncthreads()
// after the wait makes every thread's copies visible to the CTA.
#pragma once

#include <cuda_runtime.h>

namespace async_copy {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, bypassing L1 (both addresses 16-byte aligned).
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src));
}

// 16 bytes, or 16 zero bytes when `valid` is false (src is not read then,
// but must still be a valid address).
__device__ __forceinline__ void cp16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, or 4 zero bytes when `valid` is false.
__device__ __forceinline__ void cp4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace async_copy
