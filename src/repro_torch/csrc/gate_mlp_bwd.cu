// Backward of the write-gate MLP (gate_mlp.cu) for Hopper (sm_90a),
// float32, on the tensor cores (3xTF32 mma.sync).
//
// Replaces: the gradient of src/repro/kernels/gate_mlp.py::gate_mlp. The
// Pallas kernel is forward-only; the reference trains through
// jax.value_and_grad of its jnp gate (src/repro/core/gate.py;
// src/repro/training/trainer.py), whose gradient this computes. Per row r
// and token s, with h = r % H:
//
//   pre  = x[r, s] @ w1[h] + b1[h]                  (recomputed)
//   dy   = dg[r, s] g[r, s] (1 - g[r, s])           (g saved by the forward)
//   dpre = dy w2[h] * gelu_tanh'(pre)
//   dx[r, s] = dpre @ w1[h]^T
//   dw1[h] += x[r, s]^T dpre    db1[h] += dpre
//   dw2[h] += dy gelu_tanh(pre) db2[h] += dy
//
// x, dx [R, S, F]; w1, dw1 [H, F, M]; b1, db1 [H, M]; w2, dw2 [H, M, 1];
// b2, db2 [H, 1]; g, dg [R, S]; float32, contiguous, x and w1 16-byte
// aligned; F and M multiples of 8 with F M <= 32768 (w1[h] is staged
// whole in shared memory: qwen3-0.6b's 256 x 64, recurrentgemma-9b's
// 512 x 64; a shape whose plan below does not fit is refused).
//
// What bounds it on this card: bytes, at the f32 product rate of the
// tensor cores. Per token the recomputed pre-activation, dx and dw1 are
// 2 F M FLOPs each, 6 F M against 2 F floats of x and dx (about 100 FLOPs
// per byte at F 256, M 64): above the ratio of the CUDA cores (67 TFLOP/s
// over 3.35 TB/s), below that of 3xTF32 (495/3 TFLOP/s).
// What the design does about it:
// - The three F x M products run on mma.sync m16n8k8 in 3xTF32
//   (flash_mma.cuh's split and mma_3xtf32; within 1e-4 of each gradient's
//   max, where one TF32 pass is not: tests/test_torch_bwd_split.py).
// - One CTA of 8 warps per (head, chunk of that head's tokens) walks every
//   row r with r % H = h (gate_mlp_bwd_chunks sizes the grid to fill the
//   SMs once), so each head's weight gradients come out of
//   132 / H CTAs, not one per row and chunk: the partial sums (F M + 2 M +
//   1 floats a CTA) are 8.5 MB at the train shape, against 67 MB of x and
//   dx. A second kernel adds them in a fixed order (chunk by chunk), so
//   there are no atomics and two calls give the same bits.
// - w1[h] comes into shared memory once per CTA; tiles of BT tokens of x
//   (with g and dg) come through a two-stage cp.async ring. Per tile: pre
//   = x w1[h] (warps split tokens by 16 and the hidden units), then dpre
//   (elementwise, in the accumulators; db1 and dw2 summed there per
//   thread), written to shared memory twice, once per operand layout; then
//   dx = dpre w1[h]^T (stored straight from the accumulators) and dw1 +=
//   x^T dpre, whose accumulators stay in registers for the CTA's whole
//   walk (warp w owns the 16-feature tiles w, w + 8, ... of every unit).
//   The second and third products read their k dimension in the order
//   (0, 2, 4, 6 | 1, 3, 5, 7) on both sides, so each fragment load is one
//   conflict-free shared-memory access (row strides: x 4 mod 32 floats in
//   fours, w1[h] and dpre 8 times an odd number).
// - db1, dw2 and db2 are summed per thread in token order, then by
//   shuffles and across the warps in a fixed order.
// - M 64, every config's gate width, runs an instantiation with M fixed
//   at compile time, so the loops over the units unroll and the dw1 tiles'
//   indices fold; other widths run the same code with M at run time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_mma.cuh"

namespace {

using mma::mma_3xtf32;
using mma::split;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ void gelu_tanh_and_grad(float x, float& y, float& dy) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float u = c * (x + 0.044715f * x * x * x);
  const float t = tanhf(u);
  y = 0.5f * x * (1.f + t);
  dy = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * x * x);
}

// floats of one CTA's partial sums (dw1, db1, dw2, db2), rounded up to 16
// bytes: the stride of a CTA's row in the scratch
__host__ __device__ inline long long part_floats(int F, int M) {
  return ((long long)F * M + 2 * M + 1 + 3) / 4 * 4;
}

// The shared-memory plan: BT tokens per tile, `stages` ring stages; row
// strides (floats) of w1[h] [F][ldw], dpre as dx's operand [BT][lda] and
// as dw1's [BT][ldb], x [BT][ldx]. The first plan that fits of (32, 2),
// (16, 2), (16, 1) with padded rows, then (16, 1) with unpadded w1[h] and
// dpre (bank conflicts, for the largest F M).
struct Plan {
  int bt, stages, ldw, lda, ldb, ldx;
  __host__ __device__ size_t floats_stage() const { return (size_t)bt * ldx + 2 * bt; }  // x; g, dg
  __host__ size_t bytes(int F) const {
    return ((size_t)F * ldw + stages * floats_stage() + (size_t)bt * (lda + ldb)) *
           sizeof(float);
  }
};

// padded row strides: 8 x an odd number (w1[h], dpre as dx's operand),
// 4 x an odd number (x)
int pad8_odd(int M) { return (M / 8) % 2 ? M : M + 8; }
int pad_x(int F) { return (F + 15) / 16 * 16 + 4; }

Plan make_plan(int F, int M, size_t max_bytes) {
  const int odd8 = pad8_odd(M);
  const int ldx = pad_x(F);
  const Plan plans[4] = {{32, 2, odd8, odd8, M + 4, ldx},
                         {16, 2, odd8, odd8, M + 4, ldx},
                         {16, 1, odd8, odd8, M + 4, ldx},
                         {16, 1, M, M, M, ldx}};
  for (const Plan& p : plans)
    if (p.bytes(F) <= max_bytes) return p;
  Plan none = plans[3];
  none.bt = 0;
  return none;
}

// One CTA per (head blockIdx.y, chunk blockIdx.x of tch tokens of the
// head): token t of head h is row h + H (t / S), position t % S. ACC: dw1
// accumulator tiles (16 features x 8 units) per warp. MM: M fixed at
// compile time, so the loops over the units unroll and the dw1 tiles'
// indices fold (0: M at run time).
template <int BT, int ACC, int MM = 0>
__global__ void __launch_bounds__(THREADS, 1)
gate_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ g, const float* __restrict__ dg,
                float* __restrict__ dx, float* __restrict__ part, int S, int F,
                int M_, int H, int T, int tch, Plan pl) {
  constexpr int RG = BT / 16;      // warp rows of 16 tokens
  constexpr int CG = WARPS / RG;   // warp columns
  constexpr int NJ = 16 / CG;      // pre n-tiles per warp at M 128
  constexpr int XC = 8;            // dx n-tiles per pass
  extern __shared__ __align__(16) float smem[];
  const int M = MM ? MM : M_;
  const int ldw = pl.ldw, lda = pl.lda, ldb = pl.ldb, ldx = pl.ldx;
  float* w_s = smem;                                   // [F][ldw]
  float* da_s = w_s + (size_t)F * ldw;                 // [BT][lda]
  float* db_s = da_s + BT * lda;                       // [BT][ldb]
  float* ring = db_s + BT * ldb;                       // stages x {x; g; dg}
  const int stage_floats = BT * ldx + 2 * BT;  // x; g, dg

  const int h = blockIdx.y;
  const int c = blockIdx.x;
  const int t_begin = c * tch;
  const int t_end = min(t_begin + tch, T);
  const int ntiles = (t_end - t_begin + BT - 1) / BT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int rw = warp % RG;
  const int cw = warp / RG;
  const int ntm = M / 8;           // n-tiles of the units
  const int nf = F / 8;            // n-tiles of dx
  const int mt = (F + 15) / 16;    // 16-feature tiles of dw1
  const int nu = (mt - warp + WARPS - 1) / WARPS * ntm;  // this warp's dw1 tiles
  const float* W1 = w1 + (size_t)h * F * M;

  // the x row (in floats) of token tt of the head
  auto row_of = [&](int tt) -> size_t {
    const int i = tt / S;
    return ((size_t)(h + H * i) * S + (tt - i * S));
  };
  // tokens t_begin + t BT .. of x, g and dg into stage st, zeros past t_end
  auto load = [&](int t, int st) {
    float* xs = ring + st * stage_floats;
    const int tok0 = t_begin + t * BT;
    const int cpr = F / 4;
    for (int e = tid; e < BT * cpr; e += THREADS) {
      const int r = e / cpr;
      const int cc = e - r * cpr;
      const bool ok = tok0 + r < t_end;
      const float* src = x + (ok ? row_of(tok0 + r) * F + 4 * cc : 0);
      async_copy::cp16_zfill(xs + r * ldx + 4 * cc, src, ok);
    }
    for (int e = tid; e < 2 * BT; e += THREADS) {
      const int r = e % BT;
      const bool ok = tok0 + r < t_end;
      const size_t i = ok ? row_of(tok0 + r) : 0;
      async_copy::cp4_zfill(xs + BT * ldx + e, (e < BT ? g : dg) + i, ok);
    }
  };

  {  // w1[h] whole, with tile 0
    const int cpr = M / 4;
    for (int e = tid; e < F * cpr; e += THREADS) {
      const int f = e / cpr;
      const int cc = e - f * cpr;
      async_copy::cp16(w_s + f * ldw + 4 * cc, W1 + (size_t)f * M + 4 * cc);
    }
  }
  if (pl.stages == 2 && ntiles > 0) load(0, 0);
  async_copy::commit();

  // per thread: b1 and w2 of its pre columns, their db1 and dw2 sums, db2
  float bb[NJ][2], ww[NJ][2], sb1[NJ][2], sw2[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nt = cw + CG * j;
      const int m = nt * 8 + 2 * tq + e;
      bb[j][e] = nt < ntm ? b1[h * M + m] : 0.f;
      ww[j][e] = nt < ntm ? w2[h * M + m] : 0.f;
      sb1[j][e] = sw2[j][e] = 0.f;
    }
  float sb2 = 0.f;
  float acc[ACC][4];
#pragma unroll
  for (int u = 0; u < ACC; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (pl.stages == 1) {
      __syncthreads();  // the previous tile's readers are done
      load(t, 0);
      async_copy::commit();
    }
    async_copy::wait<0>();
    __syncthreads();  // tile t landed; with two stages, tile t - 1's is free
    if (pl.stages == 2 && t + 1 < ntiles) {
      load(t + 1, (t + 1) & 1);
      async_copy::commit();
    }
    const float* xs = ring + (pl.stages == 2 ? (t & 1) : 0) * stage_floats;
    const float* g_s = xs + BT * ldx;
    const float* dg_s = g_s + BT;
    const int tok0 = t_begin + t * BT;

    // pre = x w1[h]: rows 16 rw + g (+ 8), units of n-tiles cw + CG j
    float pre[NJ][4], prs[NJ][4];  // hi hi and the small 3xTF32 terms
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pre[j][e] = prs[j][e] = 0.f;
    const float* xrow = xs + (16 * rw + gq) * ldx + tq;
#pragma unroll 4
    for (int ks = 0; ks < nf; ++ks) {
      const float a[4] = {xrow[ks * 8], xrow[8 * ldx + ks * 8], xrow[ks * 8 + 4],
                          xrow[8 * ldx + ks * 8 + 4]};
      uint32_t ah[4], al[4];
      split(a, ah, al);
      const float* wr = w_s + (ks * 8 + tq) * ldw + gq;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int nt = cw + CG * j;
        if (nt < ntm) {
          const float b[2] = {wr[nt * 8], wr[4 * ldw + nt * 8]};
          uint32_t bh[2], bl[2];
          split(b, bh, bl);
          mma_3xtf32(pre[j], prs[j], ah, al, bh, bl);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pre[j][e] = prs[j][e] + pre[j][e];

    // dpre in the accumulators; db1, dw2, db2 summed per thread
    float dy[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = 16 * rw + gq + 8 * h2;
      const float gv = g_s[r];
      const float dgv = dg_s[r];
      dy[h2] = dgv * gv * (1.f - gv);
    }
    if (cw == 0 && tq == 0) sb2 += dy[0] + dy[1];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nt = cw + CG * j;
      if (nt < ntm) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = 16 * rw + gq + 8 * h2;
          float dp[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float y, dydx;
            gelu_tanh_and_grad(pre[j][2 * h2 + e] + bb[j][e], y, dydx);
            dp[e] = dy[h2] * ww[j][e] * dydx;
            sb1[j][e] += dp[e];
            sw2[j][e] += dy[h2] * y;
          }
          const int m = nt * 8 + 2 * tq;
          *reinterpret_cast<float2*>(da_s + r * lda + m) = make_float2(dp[0], dp[1]);
          db_s[r * ldb + m] = dp[0];
          db_s[r * ldb + m + 1] = dp[1];
        }
      }
    }
    __syncthreads();  // dpre complete

    // dx = dpre w1[h]^T: rows 16 rw + g (+ 8), features of n-tiles cw + CG j,
    // XC n-tiles a pass; units kk 8 + (0, 2, 4, 6 | 1, 3, 5, 7)
    size_t out_row[2];
    bool live[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int tt = tok0 + 16 * rw + gq + 8 * h2;
      live[h2] = tt < t_end;
      out_row[h2] = live[h2] ? row_of(tt) * F : 0;
    }
    const float* arow = da_s + (16 * rw + gq) * lda + 2 * tq;
    for (int j0 = 0; cw + CG * j0 < nf; j0 += XC) {
      float o[XC][4];
#pragma unroll
      for (int u = 0; u < XC; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < ntm; ++kk) {
        const float2 p0 = *reinterpret_cast<const float2*>(arow + kk * 8);
        const float2 p1 = *reinterpret_cast<const float2*>(arow + 8 * lda + kk * 8);
        const float a[4] = {p0.x, p1.x, p0.y, p1.y};
        uint32_t ah[4], al[4];
        split(a, ah, al);
#pragma unroll
        for (int u = 0; u < XC; ++u) {
          const int nt = cw + CG * (j0 + u);
          if (nt < nf) {
            const float2 wv =
                *reinterpret_cast<const float2*>(w_s + (nt * 8 + gq) * ldw + kk * 8 + 2 * tq);
            const float b[2] = {wv.x, wv.y};
            uint32_t bh[2], bl[2];
            split(b, bh, bl);
            mma_3xtf32(o[u], ah, al, bh, bl);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < XC; ++u) {
        const int nt = cw + CG * (j0 + u);
        if (nt < nf) {
          const int f = nt * 8 + 2 * tq;
          if (live[0]) mma::store2<float>(dx + out_row[0] + f, o[u][0], o[u][1]);
          if (live[1]) mma::store2<float>(dx + out_row[1] + f, o[u][2], o[u][3]);
        }
      }
    }

    // dw1 += x^T dpre: warp tiles (features 16 mi, units 8 ni) for mi =
    // warp, warp + 8, ...; tokens kk 8 + (0, 2, 4, 6 | 1, 3, 5, 7)
#pragma unroll
    for (int kk = 0; kk < BT / 8; ++kk) {
      const float* xr = xs + (kk * 8 + 2 * tq) * ldx + gq;
      const float* dr = db_s + (kk * 8 + 2 * tq) * ldb + gq;
      uint32_t ah[4], al[4];
      int mi = warp, ni = 0;
#pragma unroll
      for (int u = 0; u < ACC; ++u) {
        if (u >= nu) break;
        if (ni == 0) {
          const float a[4] = {xr[16 * mi], xr[16 * mi + 8], xr[ldx + 16 * mi],
                              xr[ldx + 16 * mi + 8]};
          split(a, ah, al);
        }
        const float b[2] = {dr[8 * ni], dr[ldb + 8 * ni]};
        uint32_t bh[2], bl[2];
        split(b, bh, bl);
        mma_3xtf32(acc[u], ah, al, bh, bl);
        if (++ni == ntm) {
          ni = 0;
          mi += WARPS;
        }
      }
    }
  }
  async_copy::wait<0>();

  // the CTA's partial sums
  float* pr = part + (size_t)(h * gridDim.x + c) * part_floats(F, M);
  {
    int mi = warp, ni = 0;
#pragma unroll
    for (int u = 0; u < ACC; ++u) {
      if (u >= nu) break;
      const int f = 16 * mi + gq;
      const int m = 8 * ni + 2 * tq;
      if (f < F) mma::store2<float>(pr + (size_t)f * M + m, acc[u][0], acc[u][1]);
      if (f + 8 < F) mma::store2<float>(pr + (size_t)(f + 8) * M + m, acc[u][2], acc[u][3]);
      if (++ni == ntm) {
        ni = 0;
        mi += WARPS;
      }
    }
  }
  // db1, dw2 over the warp's rows (lanes of one tq), then over the RG warp
  // rows in order; db2 likewise
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sb1[j][e] += __shfl_xor_sync(0xffffffffu, sb1[j][e], o);
        sw2[j][e] += __shfl_xor_sync(0xffffffffu, sw2[j][e], o);
      }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) sb2 += __shfl_xor_sync(0xffffffffu, sb2, o);
  __syncthreads();  // the ring is free: [RG][M] db1, [RG][M] dw2, [RG] db2
  float* red = ring;
  if (gq == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int nt = cw + CG * j;
      if (nt < ntm)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = nt * 8 + 2 * tq + e;
          red[rw * M + m] = sb1[j][e];
          red[(RG + rw) * M + m] = sw2[j][e];
        }
    }
    if (cw == 0 && tq == 0) red[2 * RG * M + rw] = sb2;
  }
  __syncthreads();
  const long long FM = (long long)F * M;
  for (int m = tid; m < M; m += THREADS) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      s1 += red[r * M + m];
      s2 += red[(RG + r) * M + m];
    }
    pr[FM + m] = s1;
    pr[FM + M + m] = s2;
  }
  if (tid == 0) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < RG; ++r) s += red[2 * RG * M + r];
    pr[FM + 2 * M] = s;
  }
}

// Sums the partial rows of head blockIdx.y over its chunks, in order.
__global__ void __launch_bounds__(THREADS)
gate_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw1,
                       float* __restrict__ db1, float* __restrict__ dw2,
                       float* __restrict__ db2, int F, int M, int nch) {
  const long long np = part_floats(F, M);
  const long long FM = (long long)F * M;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e > FM + 2 * M) return;  // past db2: the row's padding, never written
  const int h = blockIdx.y;
  float sum = 0.f;
  for (int c = 0; c < nch; ++c) sum += part[((long long)h * nch + c) * np + e];
  if (e < FM) dw1[h * FM + e] = sum;
  else if (e < FM + M) db1[h * M + (e - FM)] = sum;
  else if (e < FM + 2 * M) dw2[h * M + (e - FM - M)] = sum;
  else db2[h] = sum;
}

template <int BT, int ACC, int MM>
cudaError_t launch(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* g, const float* dg, float* dx, float* part, int S,
                   int F, int M, int H, int T, int nch, int tch, const Plan& pl,
                   cudaStream_t st) {
  const size_t smem = pl.bytes(F);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gate_bwd_kernel<BT, ACC, MM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  gate_bwd_kernel<BT, ACC, MM><<<dim3(nch, H), THREADS, smem, st>>>(
      x, w1, b1, w2, g, dg, dx, part, S, F, M, H, T, tch, pl);
  return cudaGetLastError();
}

template <int BT, int MM>
cudaError_t launch_bt(int acc, const float* x, const float* w1, const float* b1,
                      const float* w2, const float* g, const float* dg, float* dx,
                      float* part, int S, int F, int M, int H, int T, int nch, int tch,
                      const Plan& pl, cudaStream_t st) {
  if (acc <= 8) return launch<BT, 8, MM>(x, w1, b1, w2, g, dg, dx, part, S, F, M, H, T, nch, tch, pl, st);
  if (acc <= 16) return launch<BT, 16, MM>(x, w1, b1, w2, g, dg, dx, part, S, F, M, H, T, nch, tch, pl, st);
  if (MM != 0 || acc <= 32)  // at M 64, F M <= 32768 keeps acc <= 32
    return launch<BT, 32, MM>(x, w1, b1, w2, g, dg, dx, part, S, F, M, H, T, nch, tch, pl, st);
  return launch<BT, MM ? 32 : 64, MM>(x, w1, b1, w2, g, dg, dx, part, S, F, M, H, T, nch, tch, pl, st);
}

// tokens per chunk when a head's T tokens are cut into nch chunks of whole
// tiles of bt tokens
int chunk_tokens(int T, int nch, int bt) { return ((T + nch - 1) / nch + bt - 1) / bt * bt; }

// The shapes the backward takes (F and M multiples of 8, F M <= 32768),
// its plan on the current device and the device's SM count; T: tokens per
// head. cudaErrorInvalidValue for a shape it refuses or no plan that fits.
cudaError_t setup(int R, int S, int F, int M, int H, Plan& pl, int& T, int& sms) {
  if (H <= 0 || H > 65535 || R <= 0 || R % H != 0 || F <= 0 || F % 8 != 0 || M <= 0 ||
      M % 8 != 0 || (long long)F * M > 32768 || S <= 0)
    return cudaErrorInvalidValue;
  const long long tokens = (long long)(R / H) * S;
  if (tokens > 0x7fffffffLL) return cudaErrorInvalidValue;
  T = (int)tokens;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  pl = make_plan(F, M, (size_t)max_smem);
  return pl.bt ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory (bytes) of the plan at F, M on the current
// device; 0 if no plan fits.
extern "C" long long gate_mlp_bwd_smem_bytes(int F, int M) {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  const Plan pl = make_plan(F, M, (size_t)max_smem);
  return pl.bt ? (long long)pl.bytes(F) : 0;
}

// Chunks of each head's tokens for gate_mlp_bwd_f32, one CTA each: the H
// heads' CTAs fill the SMs once (one CTA per SM), every chunk whole tiles
// of the plan and none empty. 0 if the shape is refused.
extern "C" int gate_mlp_bwd_chunks(int R, int S, int F, int M, int H) {
  Plan pl;
  int T = 0, sms = 0;
  if (setup(R, S, F, M, H, pl, T, sms) != cudaSuccess) return 0;
  const int n = std::max(1, std::min(sms / H, (T + pl.bt - 1) / pl.bt));
  const int tch = chunk_tokens(T, n, pl.bt);
  return (T + tch - 1) / tch;
}

// Floats of scratch the backward needs for H heads in nch chunks each.
extern "C" long long gate_mlp_bwd_scratch_floats(int H, int F, int M, int nch) {
  return (long long)H * nch * part_floats(F, M);
}

// Gradients of gate_mlp (float32). nch: chunks of each head's tokens, one
// CTA each (gate_mlp_bwd_chunks); part: scratch of
// gate_mlp_bwd_scratch_floats(H, F, M, nch) floats. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int gate_mlp_bwd_f32(const float* x, const float* w1, const float* b1,
                                const float* w2, const float* g, const float* dg,
                                float* dx, float* dw1, float* db1, float* dw2,
                                float* db2, float* part, int R, int S, int F, int M,
                                int H, int nch, void* stream) {
  Plan pl;
  int T = 0, sms = 0;
  cudaError_t err = setup(R, S, F, M, H, pl, T, sms);
  if (err != cudaSuccess) return (int)err;
  if (nch <= 0 || nch > 65535) return (int)cudaErrorInvalidValue;
  const int tch = chunk_tokens(T, nch, pl.bt);
  if ((long long)(nch - 1) * tch >= T) return (int)cudaErrorInvalidValue;
  const int mt = (F + 15) / 16;
  const int acc = (mt + WARPS - 1) / WARPS * (M / 8);  // dw1 tiles of warp 0
  if (acc > 64) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // M 64, the gate width of every config, runs with M fixed at compile time
  err = M == 64 ? (pl.bt == 32 ? launch_bt<32, 64> : launch_bt<16, 64>)(
                      acc, x, w1, b1, w2, g, dg, dx, part, S, F, M, H, T, nch, tch, pl, st)
                : (pl.bt == 32 ? launch_bt<32, 0> : launch_bt<16, 0>)(
                      acc, x, w1, b1, w2, g, dg, dx, part, S, F, M, H, T, nch, tch, pl, st);
  if (err != cudaSuccess) return (int)err;
  const long long np = part_floats(F, M);
  gate_bwd_reduce_kernel<<<dim3((unsigned)((np + THREADS - 1) / THREADS), H), THREADS, 0, st>>>(
      part, dw1, db1, dw2, db2, F, M, nch);
  return (int)cudaGetLastError();
}
