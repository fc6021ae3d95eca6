// Shared tile loop of the port's two prefill attention kernels
// (vertical_slash.cu, gated_flash.cu) for Hopper (sm_90a), and the host
// side they share: the shape checks, the dtype / head-dim dispatch and the
// launch over query tiles (at the end of the file).
//
// One CTA of THREADS = 256 threads owns TQ = 64 consecutive query rows of
// one stream; four consecutive threads (one quad of a warp) own a row.
// Key tiles of BK = 32 rows of K and V are staged in shared memory as
// float and shared by the CTA's 64 rows. For each tile a thread computes
// the scores of its row against BK / 4 keys (keys t4, t4 + 4, ...) with
// 16-byte shared loads (one float4 of q and of each key per four FMAs),
// the quad reduces the tile max and sum with two shuffles, the row's
// probabilities go through shared memory, and each thread accumulates its
// own output dims (float4 groups 4 * t4 + 16 * i) over all BK keys, again
// with 16-byte loads of V.
//
// Rows are padded: hd rounds up to a multiple of 4 (zero columns add
// nothing to a dot product), and the q and k rows get 4 more floats so
// that the four keys a quarter-warp reads land on distinct banks.
//
// The online softmax is the Pallas kernels' (f32 throughout, also for
// bf16 inputs): masked scores are NEG_INF, m_safe = 0 while a row has
// seen no key, alpha = 0 on its first live tile, and the output is
// acc / max(l, 1e-30), so a row that sees no key at all returns 0. A tile
// in which every score of a row is masked leaves that row's state exactly
// as it was, so a caller may skip tiles that no row of the CTA can see.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr int TQ = 64;            // query rows per CTA
constexpr int BK = 32;            // keys per tile
constexpr int THREADS = 4 * TQ;   // one quad per row
constexpr int KPT = BK / 4;       // scores per thread per tile
constexpr int LDP = BK + 1;       // probability row stride (bank skew)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Four consecutive elements as float; `p` is 4-element aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

struct Dims {
  int hd;    // real head dim
  int hp;    // hd rounded up to a multiple of 4
  int ldk;   // q and k row stride in shared memory (floats)

  __host__ __device__ explicit Dims(int hd_)
      : hd(hd_), hp((hd_ + 3) & ~3), ldk(((hd_ + 3) & ~3) + 4) {}

  // floats of shared memory: q [TQ][ldk], k [BK][ldk], v [BK][hp],
  // probabilities [TQ][LDP], plus `extra` (a caller's per-key array)
  __host__ __device__ size_t smem_floats(int extra) const {
    return (size_t)TQ * ldk + (size_t)BK * ldk + (size_t)BK * hp
           + (size_t)TQ * LDP + extra;
  }
};

// dst[r * ld + d] = src[r * hd + d] (as float) for r < n_valid and
// d < hd, 0 elsewhere up to n_rows x hp; every thread of the CTA takes
// part. Rows of src are hd elements apart.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const T* __restrict__ src,
                                          int n_valid, int n_rows,
                                          const Dims& dm) {
  const int c4 = dm.hp >> 2;  // float4 chunks per row
  const bool vec = (dm.hd & 3) == 0 &&
                   (reinterpret_cast<size_t>(src) & (4 * sizeof(T) - 1)) == 0;
  for (int e = threadIdx.x; e < n_rows * c4; e += blockDim.x) {
    const int r = e / c4;
    const int d = (e - r * c4) << 2;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) {
      const T* p = src + (size_t)r * dm.hd + d;
      if (vec) {
        x = load4(p);
      } else {
        x.x = d < dm.hd ? to_f(p[0]) : 0.f;
        x.y = d + 1 < dm.hd ? to_f(p[1]) : 0.f;
        x.z = d + 2 < dm.hd ? to_f(p[2]) : 0.f;
        x.w = d + 3 < dm.hd ? to_f(p[3]) : 0.f;
      }
    }
    *reinterpret_cast<float4*>(dst + r * ld + d) = x;
  }
}

template <int HDMAX>
struct RowState {
  static constexpr int NV = HDMAX / 16;  // float4 groups per thread
  float m;
  float l;
  float4 acc[NV];

  __device__ __forceinline__ void init() {
    m = NEG_INF;
    l = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

// Folds one staged key tile into the row state. `logit(jl, s)` maps the
// scaled score s of key jl (0 <= jl < BK, tile-relative) to the logit
// the softmax sees: s, s plus a bias, or NEG_INF where the row may not
// see the key. `p_row` is this row's slice of the probability buffer.
// Every thread of the warp must call this (shuffles).
template <int HDMAX, typename Logit>
__device__ __forceinline__ void tile_update(const float* __restrict__ q_row,
                                            const float* __restrict__ k_s,
                                            const float* __restrict__ v_s,
                                            float* __restrict__ p_row,
                                            const Dims& dm, float scale,
                                            Logit logit, RowState<HDMAX>& st) {
  const int t4 = threadIdx.x & 3;
  float s[KPT];
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) s[jj] = 0.f;
  for (int d = 0; d < dm.hp; d += 4) {
    const float4 q = load4(q_row + d);
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float4 k = load4(k_s + (t4 + 4 * jj) * dm.ldk + d);
      s[jj] = fmaf(q.x, k.x, s[jj]);
      s[jj] = fmaf(q.y, k.y, s[jj]);
      s[jj] = fmaf(q.z, k.z, s[jj]);
      s[jj] = fmaf(q.w, k.w, s[jj]);
    }
  }
  float m_tile = NEG_INF;
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) {
    s[jj] = logit(t4 + 4 * jj, s[jj] * scale);
    m_tile = fmaxf(m_tile, s[jj]);
  }
  m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
  m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 2));
  const float m_new = fmaxf(st.m, m_tile);
  const float m_safe = (m_new <= NEG_INF * 0.5f) ? 0.f : m_new;
  const float alpha = (st.m <= NEG_INF * 0.5f) ? 0.f : expf(st.m - m_safe);
  float psum = 0.f;
#pragma unroll
  for (int jj = 0; jj < KPT; ++jj) {
    const float p = expf(s[jj] - m_safe);
    p_row[t4 + 4 * jj] = p;
    psum += p;
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  psum += __shfl_xor_sync(0xffffffffu, psum, 2);
  st.l = st.l * alpha + psum;
#pragma unroll
  for (int i = 0; i < RowState<HDMAX>::NV; ++i) {
    st.acc[i].x *= alpha;
    st.acc[i].y *= alpha;
    st.acc[i].z *= alpha;
    st.acc[i].w *= alpha;
  }
  __syncwarp();  // the quad's probabilities are in p_row
#pragma unroll 4
  for (int j = 0; j < BK; ++j) {
    const float p = p_row[j];
    const float* vr = v_s + j * dm.hp + 4 * t4;
#pragma unroll
    for (int i = 0; i < RowState<HDMAX>::NV; ++i) {
      if (16 * i + 4 * t4 < dm.hp) {
        const float4 v = load4(vr + 16 * i);
        st.acc[i].x = fmaf(p, v.x, st.acc[i].x);
        st.acc[i].y = fmaf(p, v.y, st.acc[i].y);
        st.acc[i].z = fmaf(p, v.z, st.acc[i].z);
        st.acc[i].w = fmaf(p, v.w, st.acc[i].w);
      }
    }
  }
  st.m = m_new;
}

// out_row[d] = acc / max(l, 1e-30) for this thread's dims d < hd.
template <typename T, int HDMAX>
__device__ __forceinline__ void store_row(T* __restrict__ out_row,
                                          const Dims& dm,
                                          const RowState<HDMAX>& st) {
  const int t4 = threadIdx.x & 3;
  const float denom = fmaxf(st.l, 1e-30f);
#pragma unroll
  for (int i = 0; i < RowState<HDMAX>::NV; ++i) {
    const int d = 16 * i + 4 * t4;
    const float a[4] = {st.acc[i].x, st.acc[i].y, st.acc[i].z, st.acc[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < dm.hd) store(&out_row[d + e], a[e] / denom);
  }
}

// ---- host side: the checks, dispatch and launch both kernels share ------

// Nq query streams of S rows, head dim hd, G query streams per kv stream:
// what the kernels take (grid.y holds one block per query tile).
inline bool shape_ok(int Nq, int S, int hd, int G) {
  return (S + TQ - 1) / TQ <= 65535 && hd > 0 && hd <= 256 && G > 0 &&
         Nq % G == 0;
}

// A type as a value (a tag for the generic lambdas of dispatch), and a
// parameter type that template deduction does not look at.
template <typename T>
struct Id {
  using type = T;
};

// Returns f(Id<T>{}, std::integral_constant<int, HDMAX>{}) for the element
// type T of `dtype` (0 = float32, 1 = bfloat16) and the smallest HDMAX of
// 64, 128 and 256 that holds hd; cudaErrorInvalidValue for another dtype.
template <typename T, typename F>
int dispatch_hd(int hd, F& f) {
  if (hd <= 64) return f(Id<T>{}, std::integral_constant<int, 64>{});
  if (hd <= 128) return f(Id<T>{}, std::integral_constant<int, 128>{});
  return f(Id<T>{}, std::integral_constant<int, 256>{});
}

template <typename F>
int dispatch(int dtype, int hd, F f) {
  if (dtype == 0) return dispatch_hd<float>(hd, f);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(hd, f);
  return (int)cudaErrorInvalidValue;
}

// Launches `kern` on the grid of query tiles, (Nq, ceil(S / TQ)) blocks of
// THREADS, with the shared memory of Dims(hd) plus `extra` floats. Above
// 48 KB that needs the kernel's dynamic shared memory limit raised, which
// is done first. Returns cudaGetLastError() after the launch.
template <typename... P>
int launch_tiles(void (*kern)(P...), int Nq, int S, int hd, int extra,
                 cudaStream_t st, typename Id<P>::type... args) {
  const size_t smem = Dims(hd).smem_floats(extra) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(Nq, (S + TQ - 1) / TQ), THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash
