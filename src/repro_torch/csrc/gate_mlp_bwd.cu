// Backward of the write-gate MLP (gate_mlp.cu) for Hopper (sm_90a),
// float32, on the CUDA cores.
//
// Replaces: the gradient of src/repro/kernels/gate_mlp.py::gate_mlp. The
// Pallas kernel is forward-only; the reference trains through
// jax.value_and_grad of its jnp gate (src/repro/core/gate.py), whose
// gradient this computes. Per row r and token s, with h = r % H:
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
// 512 x 64).
//
// What bounds it on this card: operations. Per token, the recomputed
// pre-activation, dx and dw1 are 2 F M FLOPs each, 6 F M against 2 F
// floats of x and dx: about 100 FLOPs per byte at F 256, M 64, above the
// card's ratio for f32 on the CUDA cores (67 TFLOP/s over 3.35 TB/s).
// What the design does about it (a first, simple version):
// - Kernel 1: one CTA per (row, chunk of tokens), 8 warps. w1[h] lives in
//   shared memory for the whole chunk (rows padded to M + 1 floats, so
//   both x w1 and dpre w1^T read distinct banks); tiles of 16 tokens of x
//   come in one after another. Each thread keeps its share of dw1 in
//   registers across the chunk; db1, dw2 and db2 are summed by M threads
//   in token order. At the end the CTA writes its partial sums to a
//   scratch row.
// - Kernel 2 sums the partial rows of each head in a fixed order (row,
//   then chunk), so there are no atomics and two calls give the same bits.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BT = 16;  // tokens per tile

__device__ __forceinline__ void gelu_tanh_and_grad(float x, float& y, float& dy) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  const float u = c * (x + 0.044715f * x * x * x);
  const float t = tanhf(u);
  y = 0.5f * x * (1.f + t);
  dy = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * 0.044715f * x * x);
}

// floats of one CTA's partial sums: dw1, db1, dw2, db2
__host__ __device__ inline long long part_floats(int F, int M) {
  return (long long)F * M + 2 * M + 1;
}

template <int KPT>  // dw1 elements per thread: F M <= THREADS KPT
__global__ void __launch_bounds__(THREADS, 1)
gate_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ g, const float* __restrict__ dg,
                float* __restrict__ dx, float* __restrict__ part, int S, int F,
                int M, int H, int tch) {
  extern __shared__ __align__(16) float smem[];
  const int ldw = M + 1;
  float* w_s = smem;                 // [F][M + 1]
  float* x_s = w_s + F * ldw;        // [BT][F]
  float* dpre_s = x_s + BT * F;      // [BT][M]
  float* gel_s = dpre_s + BT * M;    // [BT][M] dy gelu(pre)
  float* dy_s = gel_s + BT * M;      // [BT]

  const int r = blockIdx.y;
  const int h = r % H;
  const int s_begin = blockIdx.x * tch;
  const int s_end = min(s_begin + tch, S);
  const int tid = threadIdx.x;
  const int FM = F * M;
  const float* W1 = w1 + (size_t)h * FM;

  for (int e = tid; e < FM; e += THREADS) {
    const int f = e / M;
    w_s[f * ldw + (e - f * M)] = W1[e];
  }

  float acc[KPT];
#pragma unroll
  for (int kk = 0; kk < KPT; ++kk) acc[kk] = 0.f;
  float acc_b1 = 0.f, acc_w2 = 0.f, acc_b2 = 0.f;

  for (int s0 = s_begin; s0 < s_end; s0 += BT) {
    const int nt = min(BT, s_end - s0);
    __syncthreads();  // the previous tile's readers are done
    const int f4 = F / 4;
    for (int e = tid; e < BT * f4; e += THREADS) {
      const int t = e / f4;
      const int c = e - t * f4;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < nt)
        val = __ldg(reinterpret_cast<const float4*>(x + ((size_t)r * S + s0 + t) * F) + c);
      reinterpret_cast<float4*>(x_s)[e] = val;
    }
    if (tid < BT) {
      float d = 0.f;
      if (tid < nt) {
        const size_t i = (size_t)r * S + s0 + tid;
        const float gv = g[i];
        d = dg[i] * gv * (1.f - gv);
      }
      dy_s[tid] = d;
    }
    __syncthreads();

    // pre-activations, then dpre and dy gelu(pre)
    for (int e = tid; e < BT * M; e += THREADS) {
      const int t = e / M;
      const int m = e - t * M;
      float pre = b1[h * M + m];
      const float* xr = x_s + t * F;
      for (int f = 0; f < F; ++f) pre = fmaf(xr[f], w_s[f * ldw + m], pre);
      float y, dydx;
      gelu_tanh_and_grad(pre, y, dydx);
      const float dyt = dy_s[t];
      dpre_s[e] = dyt * w2[h * M + m] * dydx;
      gel_s[e] = dyt * y;
    }
    __syncthreads();

    // dx = dpre w1^T
    for (int e = tid; e < nt * F; e += THREADS) {
      const int t = e / F;
      const int f = e - t * F;
      const float* dr = dpre_s + t * M;
      const float* wr = w_s + f * ldw;
      float sum = 0.f;
      for (int m = 0; m < M; ++m) sum = fmaf(dr[m], wr[m], sum);
      dx[((size_t)r * S + s0 + t) * F + f] = sum;
    }
    // dw1 += x^T dpre (rows past the chunk are zeros)
#pragma unroll
    for (int kk = 0; kk < KPT; ++kk) {
      const int e = tid + kk * THREADS;
      if (e < FM) {
        const int f = e / M;
        const int m = e - f * M;
        float a = acc[kk];
        for (int t = 0; t < nt; ++t) a = fmaf(x_s[t * F + f], dpre_s[t * M + m], a);
        acc[kk] = a;
      }
    }
    // db1, dw2, db2 in token order
    if (tid < M) {
      for (int t = 0; t < nt; ++t) {
        acc_b1 += dpre_s[t * M + tid];
        acc_w2 += gel_s[t * M + tid];
      }
    }
    if (tid == 0)
      for (int t = 0; t < nt; ++t) acc_b2 += dy_s[t];
  }

  float* pr = part + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * part_floats(F, M);
#pragma unroll
  for (int kk = 0; kk < KPT; ++kk) {
    const int e = tid + kk * THREADS;
    if (e < FM) pr[e] = acc[kk];
  }
  if (tid < M) {
    pr[FM + tid] = acc_b1;
    pr[FM + M + tid] = acc_w2;
  }
  if (tid == 0) pr[FM + 2 * M] = acc_b2;
}

// Sums the partial rows of head blockIdx.y: rows h, h + H, ..., each over
// its chunks, in that order.
__global__ void __launch_bounds__(THREADS)
gate_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dw1,
                       float* __restrict__ db1, float* __restrict__ dw2,
                       float* __restrict__ db2, int R, int F, int M, int H, int nch) {
  const long long np = part_floats(F, M);
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= np) return;
  const int h = blockIdx.y;
  float sum = 0.f;
  for (int r = h; r < R; r += H)
    for (int c = 0; c < nch; ++c) sum += part[((long long)r * nch + c) * np + e];
  const long long FM = (long long)F * M;
  if (e < FM) dw1[h * FM + e] = sum;
  else if (e < FM + M) db1[h * M + (e - FM)] = sum;
  else if (e < FM + 2 * M) dw2[h * M + (e - FM - M)] = sum;
  else db2[h] = sum;
}

template <int KPT>
cudaError_t launch(const float* x, const float* w1, const float* b1, const float* w2,
                   const float* g, const float* dg, float* dx, float* part, int R,
                   int S, int F, int M, int H, int nch, int tch, cudaStream_t st) {
  const size_t smem = ((size_t)F * (M + 1) + (size_t)BT * F + 2 * BT * M + BT) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gate_bwd_kernel<KPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  gate_bwd_kernel<KPT><<<dim3(nch, R), THREADS, smem, st>>>(x, w1, b1, w2, g, dg, dx, part,
                                                            S, F, M, H, tch);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the backward needs for R rows in nch chunks.
extern "C" long long gate_mlp_bwd_scratch_floats(int R, int F, int M, int nch) {
  return (long long)R * nch * part_floats(F, M);
}

// Gradients of gate_mlp (float32). nch: chunks of tokens per row, one CTA
// each (kernels/gate_mlp.py::bwd_chunks); part: scratch of
// gate_mlp_bwd_scratch_floats(R, F, M, nch) floats. Returns
// cudaGetLastError() after the launches (0 = launched).
extern "C" int gate_mlp_bwd_f32(const float* x, const float* w1, const float* b1,
                                const float* w2, const float* g, const float* dg,
                                float* dx, float* dw1, float* db1, float* dw2,
                                float* db2, float* part, int R, int S, int F, int M,
                                int H, int nch, void* stream) {
  if (H <= 0 || R <= 0 || R % H != 0 || F <= 0 || F % 8 != 0 || M <= 0 || M % 8 != 0 ||
      (long long)F * M > 32768 || S <= 0 || nch <= 0 || nch > 65535 || R > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int tch = ((S + nch - 1) / nch + BT - 1) / BT * BT;  // tokens per chunk
  if ((long long)(nch - 1) * tch >= S) return (int)cudaErrorInvalidValue;
  const int kpt = (F * M + THREADS - 1) / THREADS;
  cudaError_t err;
  if (kpt <= 8) err = launch<8>(x, w1, b1, w2, g, dg, dx, part, R, S, F, M, H, nch, tch, st);
  else if (kpt <= 16) err = launch<16>(x, w1, b1, w2, g, dg, dx, part, R, S, F, M, H, nch, tch, st);
  else if (kpt <= 32) err = launch<32>(x, w1, b1, w2, g, dg, dx, part, R, S, F, M, H, nch, tch, st);
  else if (kpt <= 64) err = launch<64>(x, w1, b1, w2, g, dg, dx, part, R, S, F, M, H, nch, tch, st);
  else err = launch<128>(x, w1, b1, w2, g, dg, dx, part, R, S, F, M, H, nch, tch, st);
  if (err != cudaSuccess) return (int)err;
  const long long np = part_floats(F, M);
  gate_bwd_reduce_kernel<<<dim3((unsigned)((np + THREADS - 1) / THREADS), H), THREADS, 0, st>>>(
      part, dw1, db1, dw2, db2, R, F, M, H, nch);
  return (int)cudaGetLastError();
}
