// Tensor-core building blocks (mma.sync, sm_80 and later) for the port's
// kernels on Hopper (sm_90a): the 3xTF32 split and products, which the
// prefill attention kernels and gate_mlp.cu's [tokens, F] . [F, M] use,
// and the flash-attention key-tile step that gated_flash.cu and
// vertical_slash.cu share.
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
// lo_a lo_b, under 2^-20 of the product, is dropped). One TF32 pass keeps
// about three decimal digits; the split keeps the f32 tolerance of the
// attention kernels (5e-5) and of gate_mlp (1e-5; tests/
// test_torch_gate_split.py emulates both on the CPU).
//
// bf16 inputs run m16n8k16 with f32 accumulation. P, an f32 value in the
// accumulators, enters P V as PV_TERMS bf16 terms whose sum is P to
// 2^-16 of itself (two terms). P rounded to one bf16 term, as the Pallas
// kernels round it (p.astype(v.dtype)), moved bf16 outputs in [2, 4) by
// an ulp of the output (1.6e-2) against the f32-P plain versions, over
// the 1e-2 limit; two terms stay at the output's own rounding
// (tests/test_torch_bf16_split.py emulates one, two and three).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The same product into two accumulators: d += hi_a hi_b and ds += lo_a
// hi_b + hi_a lo_b, so two chains of products are in flight instead of
// one; the caller adds ds to d (small terms first) when the sum is done.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], float (&ds)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(ds, al, bh);
  mma_tf32(ds, ah, bl);
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

// The pair (x, y) as N registers of two bf16 each, largest term first:
// each term is the bf16 rounding of what the earlier ones left, so N
// terms carry 8 N significand bits (three are exact for normal floats).
// An f32 operand of a bf16 product.
template <int N>
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    x -= f.x;
    y -= f.y;
  }
}

constexpr int PV_TERMS = 2;  // bf16 terms of P in P V

// Four 8 x 8 bf16 matrices from the rows whose addresses lanes 0-7, 8-15,
// 16-23 and 24-31 give (16 bytes each): lane 4 g + t holds elements 2t,
// 2t + 1 of row g of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(async_copy::smem_addr(p)));
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
  a[0] = lds32(row); a[1] = lds32(row + 8 * LD);
  a[2] = lds32(row + 8); a[3] = lds32(row + 8 * LD + 8);
}

// ---- B fragments of K^T from a row-major K tile [key][d] ---------------
// `kr` points at K[key n0 + g][8 ks + t] (TF32; bf16 takes ldsm_x4).

__device__ __forceinline__ void load_kfrag(float (&b)[2], const float* kr) {
  b[0] = kr[0];
  b[1] = kr[4];
}

// ---- the key-tile step of flash attention -------------------------------

constexpr float NEG_INF = -1e30f;

// Per element type, head-dim bucket and warp count (16 query rows each):
// rows and keys per tile. Shared memory holds Q [TQ][LD] and two stages
// of K and V [BK][LD]; rows are padded (f32: 4, bf16: 8 elements) so the
// fragment loads and V's ldmatrix.trans are free of bank conflicts.
template <typename T_, int HDMAX, int WARPS_>
struct FlashCfg {
  using T = T_;
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int WARPS = WARPS_;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TQ = 16 * WARPS;  // rows per CTA
  static constexpr int BK = F32 ? (HDMAX > 128 ? 16 : 32) : (HDMAX > 128 ? 32 : 64);
  static constexpr int LD = HDMAX + (F32 ? 4 : 8);  // smem row (elements)
  static constexpr int KSTEP = F32 ? 8 : 16;        // mma k along hd
  static constexpr int KS = HDMAX / KSTEP;          // k-steps of Q K^T
  static constexpr int NT = BK / 8;                 // n-tiles of S
  static constexpr int ONT = HDMAX / 8;             // n-tiles of O
  static constexpr int EPC = 16 / sizeof(T);        // elements per 16 bytes
  static constexpr bool QREG = HDMAX <= 128;        // Q fragments in registers
  using AReg = typename std::conditional<F32, float, uint32_t>::type;
  static constexpr size_t tile_bytes() { return (size_t)(TQ + 4 * BK) * LD * sizeof(T); }
};

template <typename T>
__device__ __forceinline__ void store2(T* p, float x, float y);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Q rows of a CTA tile into q_s [TQ][LD] by cp.async (row r: query
// stream n0 + r % F, position p0 + r / F, zero past S), and zeros in
// columns hd..hd rounded up to 16 of the Q rows and of both stages of K
// and V rows, which follow Q in shared memory and which cp.async never
// writes there. The caller commits the copies.
template <class C>
__device__ __forceinline__ void stage_q(typename C::T* q_s, const typename C::T* q,
                                        int n0, int F, int p0, int S, int hd) {
  using T = typename C::T;
  const int cpr = hd / C::EPC;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < C::TQ * cpr; e += C::THREADS) {
    const int r = e / cpr;
    const int c = e - r * cpr;
    const int pos = p0 + r / F;
    const bool ok = pos < S;
    const T* src = q + ((size_t)(n0 + r % F) * S + (ok ? pos : 0)) * hd + c * C::EPC;
    async_copy::cp16_zfill(q_s + r * C::LD + c * C::EPC, src, ok);
  }
  const int pad = ((hd + 15) & ~15) - hd;
  for (int e = threadIdx.x; e < (C::TQ + 4 * C::BK) * pad; e += C::THREADS)
    q_s[(e / pad) * C::LD + hd + e % pad] = T(0.f);
}

// One warp's 16 query rows of a CTA tile, two per lane: row r0 = 16 warp
// + g (h = 0) and r0 + 8 (h = 1). The online softmax is the Pallas
// kernels', in base 2 (log2(e) is folded into the scale, so exp is one
// ex2): masked logits NEG_INF, m_safe = 0 while a row has seen no key,
// alpha = 0 on its first live tile, output acc / max(l, 1e-30). S and O
// live in accumulator registers; row max and sum are quad shuffles. P
// goes from the S accumulators straight into A fragments: in bf16 the
// layouts agree; in TF32 the eight keys of a k-step are read in the
// order (0, 2, 4, 6 | 1, 3, 5, 7), so a0..a3 are c0, c2, c1, c3, and V's
// rows are read in the same order. Q fragments stay in registers for the
// whole key loop at hd <= 128; at hd 256 the O accumulators take 128
// registers and Q fragments are read from shared memory per key tile.
//
// A key tile is three calls: scores(K) sets S = scale Q K^T; the caller
// masks or biases S with mask(logit) where it must (a tile whose keys
// every row of the warp sees unbiased skips it); update(V) runs the
// online softmax and O += P V.
template <class C>
struct FlashRows {
  using T = typename C::T;
  float m[2], l[2];
  float o[C::ONT][4];
  float sc[C::NT][4];
  typename C::AReg qf[C::QREG ? C::KS : 1][4];
  const T* q_row;  // Q row r0 in shared memory, at this lane's column
  float scale;     // log2(e) / sqrt(hd): logits in base 2
  int hdp;         // hd rounded up to 16; Q, K and V are zero past hd
  int lane;

  __device__ __forceinline__ FlashRows(const T* q_s, int r0, int hd, int lane_)
      : q_row(q_s + r0 * C::LD + (C::F32 ? (lane_ & 3) : 2 * (lane_ & 3))),
        scale(1.4426950408889634f / sqrtf((float)hd)),
        hdp((hd + 15) & ~15), lane(lane_) {
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int nt = 0; nt < C::ONT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  }

  // Q fragments into registers (hd <= 128), once Q is in shared memory.
  __device__ __forceinline__ void load_q() {
    if constexpr (C::QREG) {
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks)
        if (ks * C::KSTEP < hdp) load_a<C::LD>(qf[ks], q_row + ks * C::KSTEP);
    }
  }

  // S = scale Q K^T for the tile's BK keys, K rows [BK][LD] in shared memory.
  __device__ __forceinline__ void scores(const T* kt) {
    const int gq = lane >> 2;
    const int tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      if (ks * C::KSTEP >= hdp) break;
      typename C::AReg a[4];
      if constexpr (C::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        load_a<C::LD>(a, q_row + ks * C::KSTEP);
      }
      if constexpr (C::F32) {
        uint32_t ah[4], al[4];
        split(a, ah, al);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          float b[2];
          load_kfrag(b, kt + (nt * 8 + gq) * C::LD + ks * 8 + tq);
          uint32_t bh[2], bl[2];
          split(b, bh, bl);
          mma_3xtf32(sc[nt], ah, al, bh, bl);
        }
      } else {
        // B fragments of n-tiles nt and nt + 1: four 8 x 8 matrices (8
        // keys x 8 dims) at (keys + 0, dims + 0), (+0, +8), (+8, +0), (+8, +8)
        const T* kr = kt + ((lane & 7) + ((lane >> 4) << 3)) * C::LD + ks * 16 +
                      ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int nt = 0; nt < C::NT; nt += 2) {
          uint32_t r[4];
          ldsm_x4(r, kr + nt * 8 * C::LD);
          const uint32_t k0[2] = {r[0], r[1]}, k1[2] = {r[2], r[3]};
          mma_bf16(sc[nt], a, k0);
          mma_bf16(sc[nt + 1], a, k1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] *= scale;
  }

  // S = logit(jl, h, s): the logit of key jl of the tile for row h from
  // its scaled product s (NEG_INF masks the key; a bias is in base 2).
  template <class Logit>
  __device__ __forceinline__ void mask(Logit logit) {
    const int tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = nt * 8 + 2 * tq + e;
        sc[nt][e] = logit(jl, 0, sc[nt][e]);
        sc[nt][2 + e] = logit(jl, 1, sc[nt][2 + e]);
      }
    }
  }

  // The online softmax over the tile's logits, then O += P V, V rows
  // [BK][LD] in shared memory.
  __device__ __forceinline__ void update(const T* vt) {
    const int gq = lane >> 2;
    const int tq = lane & 3;
    float mt0 = NEG_INF, mt1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
      mt0 = fmaxf(mt0, fmaxf(sc[nt][0], sc[nt][1]));
      mt1 = fmaxf(mt1, fmaxf(sc[nt][2], sc[nt][3]));
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, o2));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, o2));
    }
    const float mn0 = fmaxf(m[0], mt0);
    const float mn1 = fmaxf(m[1], mt1);
    const float ms0 = (mn0 <= NEG_INF * 0.5f) ? 0.f : mn0;
    const float ms1 = (mn1 <= NEG_INF * 0.5f) ? 0.f : mn1;
    const float al0 = (m[0] <= NEG_INF * 0.5f) ? 0.f : exp2f(m[0] - ms0);
    const float al1 = (m[1] <= NEG_INF * 0.5f) ? 0.f : exp2f(m[1] - ms1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = exp2f(sc[nt][e] - ms0);
        sc[nt][2 + e] = exp2f(sc[nt][2 + e] - ms1);
        ps0 += sc[nt][e];
        ps1 += sc[nt][2 + e];
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, o2);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, o2);
    }
    l[0] = l[0] * al0 + ps0;
    l[1] = l[1] * al1 + ps1;
    m[0] = mn0;
    m[1] = mn1;
#pragma unroll
    for (int nt = 0; nt < C::ONT; ++nt) {
      o[nt][0] *= al0;
      o[nt][1] *= al0;
      o[nt][2] *= al1;
      o[nt][3] *= al1;
    }

    // O += P V
    if constexpr (C::F32) {
#pragma unroll
      for (int kk = 0; kk < C::NT; ++kk) {
        // keys kk * 8 + (0, 2, 4, 6 | 1, 3, 5, 7): A is (c0, c2, c1, c3)
        const float pa[4] = {sc[kk][0], sc[kk][2], sc[kk][1], sc[kk][3]};
        uint32_t ah[4], al[4];
        split(pa, ah, al);
        const float* vr = vt + (kk * 8 + 2 * tq) * C::LD + gq;
#pragma unroll
        for (int nt = 0; nt < C::ONT; ++nt) {
          if (nt * 8 >= hdp) break;
          const float b[2] = {vr[nt * 8], vr[C::LD + nt * 8]};
          uint32_t bh[2], bl[2];
          split(b, bh, bl);
          mma_3xtf32(o[nt], ah, al, bh, bl);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        // P as PV_TERMS bf16 terms, added smallest first
        uint32_t t0[PV_TERMS], t1[PV_TERMS], t2[PV_TERMS], t3[PV_TERMS];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], t0);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], t1);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], t2);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], t3);
        const T* vr = vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * C::LD +
                      (lane >> 4) * 8;
#pragma unroll
        for (int nt = 0; nt < C::ONT; nt += 2) {
          if (nt * 8 >= hdp) break;
          uint32_t r[4];
          ldsm_x4_trans(r, vr + nt * 8);
          const uint32_t b0[2] = {r[0], r[1]};
          const uint32_t b1[2] = {r[2], r[3]};
#pragma unroll
          for (int term = PV_TERMS - 1; term >= 0; --term) {
            const uint32_t pa[4] = {t0[term], t1[term], t2[term], t3[term]};
            mma_bf16(o[nt], pa, b0);
            mma_bf16(o[nt + 1], pa, b1);
          }
        }
      }
    }
  }

  // The natural log of each row's softmax sum, max + log(sum): l0 (row r0)
  // if w0, l1 (row r0 + 8) if w1, from the quad's first lane. m and l are
  // in base 2, so lse = (m + log2 l) ln 2. Every row has seen a key.
  __device__ __forceinline__ void store_lse(float* l0, bool w0, float* l1, bool w1) const {
    if ((lane & 3) != 0) return;
    if (w0) *l0 = (m[0] + log2f(l[0])) * 0.6931471805599453f;
    if (w1) *l1 = (m[1] + log2f(l[1])) * 0.6931471805599453f;
  }

  // The output rows: o0 (row r0) if w0, o1 (row r0 + 8) if w1.
  __device__ __forceinline__ void store(T* o0, bool w0, T* o1, bool w1, int hd) const {
    const float d0 = 1.f / fmaxf(l[0], 1e-30f);
    const float d1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
    for (int nt = 0; nt < C::ONT; ++nt) {
      const int d = nt * 8 + 2 * (lane & 3);
      if (d >= hd) break;
      if (w0) store2<T>(o0 + d, o[nt][0] * d0, o[nt][1] * d0);
      if (w1) store2<T>(o1 + d, o[nt][2] * d1, o[nt][3] * d1);
    }
  }
};

}  // namespace mma
