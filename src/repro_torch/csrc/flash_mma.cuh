// Tensor-core building blocks (mma.sync, sm_80 and later) for the port's
// prefill attention kernels on Hopper (sm_90a); gated_flash.cu uses them.
//
// Fragments are those of the PTX ISA for one warp, lane = 4 * g + t
// (g = lane >> 2 the group, t = lane & 3 its place in the group):
//
//   m16n8k8 TF32   A (16 x 8, row):  a0 A[g][t]    a1 A[g+8][t]
//                                    a2 A[g][t+4]  a3 A[g+8][t+4]
//                  B (8 x 8, col):   b0 B[t][g]    b1 B[t+4][g]
//   m16n8k16 BF16  A (16 x 16, row): a0 A[g][2t..2t+1]    a1 A[g+8][2t..]
//                                    a2 A[g][2t+8..2t+9]  a3 A[g+8][2t+8..]
//                  B (16 x 8, col):  b0 B[2t..2t+1][g]    b1 B[2t+8..][g]
//   C / D (16 x 8, f32, both):       c0 C[g][2t]  c1 C[g][2t+1]
//                                    c2 C[g+8][2t]  c3 C[g+8][2t+1]
//
// f32 inputs go through the 3xTF32 split: x = hi + lo with hi the TF32
// value of x (its low 13 mantissa bits cleared) and lo = x - hi exactly,
// of which the tensor cores read the top 10 mantissa bits; a * b is
// accumulated as lo_a hi_b + hi_a lo_b + hi_a hi_b (small terms first;
// lo_a lo_b, under 2^-20 of the product, is dropped). One TF32 pass keeps about three decimal digits; the
// split keeps the f32 tolerance of the attention kernels (5e-5).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace mma {

// x = hi + lo as TF32 operands: two instructions, no conversion.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32 from split operands, small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The pair (x, y) as three registers of two bf16 each, t[0] + t[1] + t[2]
// = (x, y) exactly for normal floats (8 significand bits per term),
// largest term first: an f32 operand of a bf16 product.
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t (&t)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    x -= f.x;
    y -= f.y;
  }
}

// Four 8 x 8 bf16 matrices, transposed, from the rows whose addresses
// lanes 0-7, 8-15, 16-23 and 24-31 give (16 bytes each).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(async_copy::smem_addr(p)));
}

// ---- A fragments of a row-major [rows][ld] tile in shared memory -------
// `row` points at element (g, 8 ks + t) for TF32, (g, 16 ks + 2t) for bf16.

template <int LD>
__device__ __forceinline__ void load_a(float (&a)[4], const float* row) {
  a[0] = row[0];
  a[1] = row[8 * LD];
  a[2] = row[4];
  a[3] = row[8 * LD + 4];
}

template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* row) {
  a[0] = lds32(row);
  a[1] = lds32(row + 8 * LD);
  a[2] = lds32(row + 8);
  a[3] = lds32(row + 8 * LD + 8);
}

// ---- B fragments of K^T from a row-major K tile [key][d] ---------------
// `kr` points at K[key n0 + g][8 ks + t] (TF32) or [16 ks + 2t] (bf16).

__device__ __forceinline__ void load_kfrag(float (&b)[2], const float* kr) {
  b[0] = kr[0];
  b[1] = kr[4];
}

__device__ __forceinline__ void load_kfrag(uint32_t (&b)[2], const __nv_bfloat16* kr) {
  b[0] = lds32(kr); b[1] = lds32(kr + 8);
}

}  // namespace mma
