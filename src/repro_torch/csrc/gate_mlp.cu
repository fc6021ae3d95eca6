// Write-gate MLP for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gate_mlp.py::gate_mlp (Pallas TPU kernel).
// Computes, per row r and token s, with head h = r % H:
//     g[r, s] = sigmoid(w2[h] . gelu_tanh(x[r, s] @ w1[h] + b1[h]) + b2[h])
// x [R, S, F], w1 [H, F, M], b1 [H, M], w2 [H, M, 1], b2 [H, 1], g [R, S],
// all float32, contiguous. Rows index the per-head weights with r % H, so
// a caller folding batch into rows never tiles the weights.
//
// What bounds it on this card: at the serving shapes (R = slots * 8 kv
// heads, S = 1, F = 256, M = 64) the work is a few thousand FMAs per row
// and the launch itself dominates; at long S it is the F*M FMAs per token
// in float32 on the CUDA cores (no tensor cores at M = 64 in a first,
// simple kernel), with x read once.
// What the design does about it: one block per (row, tile of TS tokens)
// stages the token tile in shared memory, so each w1 column is read once
// per tile and the hidden activations never leave the SM; consecutive
// threads take consecutive hidden units, so w1 reads coalesce. The second
// product (M -> 1) is a warp reduction per token over shared memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TS = 8;        // tokens per block
constexpr int THREADS = 128;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__global__ void gate_mlp_kernel(const float* __restrict__ x,
                                const float* __restrict__ w1,
                                const float* __restrict__ b1,
                                const float* __restrict__ w2,
                                const float* __restrict__ b2,
                                float* __restrict__ g,
                                int S, int F, int M, int H) {
  extern __shared__ float smem[];
  float* xs = smem;            // [TS, F]
  float* hs = smem + TS * F;   // [TS, M]
  const int r = blockIdx.y;
  const int s0 = blockIdx.x * TS;
  const int h = r % H;
  const int ns = min(TS, S - s0);
  const int tid = threadIdx.x;

  const float* xr = x + ((size_t)r * S + s0) * F;
  for (int i = tid; i < ns * F; i += blockDim.x) xs[i] = xr[i];
  __syncthreads();

  const float* W1 = w1 + (size_t)h * F * M;
  const float* B1 = b1 + (size_t)h * M;
  const float* W2 = w2 + (size_t)h * M;
  for (int i = tid; i < ns * M; i += blockDim.x) {
    const int t = i / M;
    const int m = i - t * M;
    const float* xt = xs + t * F;
    float a = 0.f;
    for (int f = 0; f < F; ++f) a = fmaf(xt[f], W1[(size_t)f * M + m], a);
    a += B1[m];
    hs[i] = gelu_tanh(a) * W2[m];
  }
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int t = warp; t < ns; t += nwarps) {
    float sum = 0.f;
    for (int m = lane; m < M; m += 32) sum += hs[t * M + m];
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const float y = sum + b2[h];
      g[(size_t)r * S + s0 + t] = 1.f / (1.f + expf(-y));
    }
  }
}

}  // namespace

extern "C" int gate_mlp_f32(const float* x, const float* w1, const float* b1,
                            const float* w2, const float* b2, float* g,
                            int R, int S, int F, int M, int H, void* stream) {
  if (R <= 0 || S <= 0) return 0;
  if (H <= 0 || R % H != 0 || F <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TS * (F + M) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((S + TS - 1) / TS, R);
  gate_mlp_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, w1, b1, w2, b2, g, S, F, M, H);
  return (int)cudaGetLastError();
}
