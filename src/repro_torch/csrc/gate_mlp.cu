// Write-gate MLP for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/gate_mlp.py::gate_mlp (Pallas TPU kernel).
// Computes, per row r and token s, with head h = r % H:
//     g[r, s] = sigmoid(w2[h] . gelu_tanh(x[r, s] @ w1[h] + b1[h]) + b2[h])
// x [R, S, F], w1 [H, F, M], b1 [H, M], w2 [H, M, 1], b2 [H, 1], g [R, S],
// all float32, contiguous, x and w1 16-byte aligned. Rows index the
// per-head weights with r % H, so a caller folding batch into rows never
// tiles the weights. F and M are multiples of 8 (tensor-core tiles and
// 16-byte copies), F <= 2048 and M <= 128 (the shared-memory and register
// tiles below); every config has M = 64 and F = 2 hd in 128..512.
//
// Two paths in this file; the wrapper picks one from the shapes alone
// (kernels/gate_mlp.py::plan: the tokens per head, (R / H) S).
//
// Decode (few tokens per head: serving's S = 1, R = slots x H).
//   Bound on this card: the launch. W1[h] is 64 KB at qwen3-0.6b (128 KB
//   at recurrentgemma-9b's F 512); the bytes bound is 0.16 us (0.04).
//   The first kernel of this port gave each row a block whose threads ran
//   a serial chain of F dependent loads and FMAs: 57 us on the device.
//   Design: one CTA per (head, 8 tokens of that head) serves every row of
//   the head, so W1[h] is read once per call. Its 16 warps split F; lane
//   l owns hidden units l, l + 32, ... . A warp issues the loads of 4 rows
//   of its W1 slice before their FMAs, so the CTA has 64 rows of W1 in
//   flight where the old chain had one load. (8 warps of 8 rows, and 16
//   of 16, were slower in one call of an exploratory comparison on the
//   card.) The warps' partial pre-activations meet
//   in shared memory, summed in warp order (deterministic); then one warp
//   per token adds b1, applies gelu_tanh, multiplies by w2, sums over M,
//   adds b2 and takes the sigmoid.
//   Left: one CTA per head uses 8 SMs at qwen3 (1 at rg); the floor is a
//   few microseconds of launch and L2 latency.
//
// Tensor cores (many tokens per head: prefill, the gated forward, the
//   tau probe). Bound on this card: bytes at the main shapes. In f32 on
//   the CUDA cores the F x M FMAs per token would bound it above the bytes
//   (x[16, 4096, 256]: 0.032 ms at 67 TFLOP/s against 0.020 for bytes); in
//   3xTF32 on the tensor cores the operations take 0.013.
//   Design: a CTA takes BT = 16 RW tokens of one row: 64 where that grid
//   fills the card, else 16 (recurrentgemma-9b's one row of 4096 tokens
//   gets 256 CTAs of 16, where 64 CTAs of 64 would leave half of the SMs
//   idle). Its 4 warps are RW row groups of 16 tokens x MW groups of
//   hidden units (n-tiles mw, mw + MW, ...). The product
//   [BT, F] . [F, M] runs on mma.sync m16n8k8 in 3xTF32 (flash_mma.cuh's
//   split and mma_3xtf32), accumulating in f32 registers. Slices of KF 32
//   features of the x tile and of W1[h] come through a 3-stage cp.async
//   ring, so W1[h] (128 KB at F 512) is never staged whole. The epilogue
//   stays in registers: + b1, gelu_tanh, . w2, a quad shuffle over the
//   warp's units, a sum over the MW warps in a fixed order, + b2, the
//   sigmoid and one store per token. Tokens past S are zero-filled and not
//   stored.
//   Left: wgmma (64-row warpgroup products from shared memory) and fusing
//   the gate features (two RMS norms and the concat) into the x load
//   (ROADMAP Queue 2b item 2).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float sigmoid(float y) { return 1.f / (1.f + expf(-y)); }

// ---- decode: one CTA per (head, DEC_TOK tokens of the head) -------------
constexpr int DEC_WARPS = 16;
constexpr int DEC_TOK = 8;     // tokens per CTA, one warp each in the epilogue
constexpr int DEC_UNROLL = 4;  // W1 rows a warp loads before their FMAs

template <int MJ>  // hidden units per lane: M <= 32 MJ
__global__ void __launch_bounds__(DEC_WARPS * 32)
gate_decode_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ g,
                   int S, int F, int M, int H, int T) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                    // [DEC_TOK][F]
  float* part = smem + DEC_TOK * F;    // [DEC_WARPS][DEC_TOK][32 MJ]
  const int h = blockIdx.x;
  const int t0 = blockIdx.y * DEC_TOK;
  const int nt = min(DEC_TOK, T - t0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // token t of the head is row h + H i, position s, with t = i S + s;
  // tokens past T are zeros
  const int f4 = F / 4;
  for (int e = tid; e < DEC_TOK * f4; e += DEC_WARPS * 32) {
    const int t = e / f4;
    const int c = e - t * f4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < nt) {
      const int tt = t0 + t;
      const int i = tt / S;
      const int s = tt - i * S;
      v = __ldg(reinterpret_cast<const float4*>(
                    x + ((size_t)(h + H * i) * S + s) * F) + c);
    }
    reinterpret_cast<float4*>(xs)[e] = v;
  }
  __syncthreads();

  const float* W1 = w1 + (size_t)h * F * M;
  const int f0 = warp * F / DEC_WARPS;
  const int f1 = (warp + 1) * F / DEC_WARPS;
  float acc[DEC_TOK][MJ];
#pragma unroll
  for (int t = 0; t < DEC_TOK; ++t)
#pragma unroll
    for (int j = 0; j < MJ; ++j) acc[t][j] = 0.f;
  for (int f = f0; f < f1; f += DEC_UNROLL) {
    float wv[DEC_UNROLL][MJ];
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int m = lane + 32 * j;
        wv[u][j] = (f + u < f1 && m < M) ? __ldg(W1 + (size_t)(f + u) * M + m) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < DEC_UNROLL; ++u) {
      const int fr = min(f + u, f1 - 1);  // wv is 0 past the slice
#pragma unroll
      for (int t = 0; t < DEC_TOK; ++t) {
        const float xv = xs[t * F + fr];
#pragma unroll
        for (int j = 0; j < MJ; ++j) acc[t][j] = fmaf(xv, wv[u][j], acc[t][j]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < DEC_TOK; ++t)
#pragma unroll
    for (int j = 0; j < MJ; ++j)
      part[(warp * DEC_TOK + t) * 32 * MJ + 32 * j + lane] = acc[t][j];
  __syncthreads();

  if (warp < nt) {
    const int t = warp;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int m = lane + 32 * j;
      if (m < M) {
        float pre = 0.f;
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w) pre += part[(w * DEC_TOK + t) * 32 * MJ + 32 * j + lane];
        sum += gelu_tanh(pre + b1[h * M + m]) * w2[h * M + m];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const int tt = t0 + t;
      const int i = tt / S;
      const int s = tt - i * S;
      g[(size_t)(h + H * i) * S + s] = sigmoid(sum + b2[h]);
    }
  }
}

// ---- tensor cores: one CTA per (row, BT tokens) ---------------------------
constexpr int MMA_WARPS = 4;
constexpr int KF = 32;         // features per ring stage
constexpr int LDX = KF + 4;    // x tile row (floats): conflict-free A loads
constexpr int NSTAGE = 3;

// W1 slice row (floats): M rounded up to 32, plus 8, so the B fragment
// loads (k = t, n = g) fall in 32 distinct banks
__host__ __device__ inline int w1_ld(int M) { return (M + 31) / 32 * 32 + 8; }

template <int RW>
__host__ __device__ constexpr int tile_floats_x() { return 16 * RW * LDX; }

template <int RW>
size_t mma_smem_bytes(int M) {
  constexpr int MW = MMA_WARPS / RW;
  return ((size_t)NSTAGE * (tile_floats_x<RW>() + KF * w1_ld(M)) + MW * 16 * RW) *
         sizeof(float);
}

template <int RW>  // row groups of 16 tokens; MMA_WARPS / RW groups of units
__global__ void __launch_bounds__(MMA_WARPS * 32)
gate_mma_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, float* __restrict__ g,
                int S, int F, int M, int H) {
  constexpr int MW = MMA_WARPS / RW;
  constexpr int BT = 16 * RW;
  constexpr int THREADS = MMA_WARPS * 32;
  constexpr int NTW = (16 + MW - 1) / MW;  // n-tiles per warp at M = 128
  extern __shared__ __align__(16) float smem[];
  const int ldw = w1_ld(M);
  const int stage = tile_floats_x<RW>() + KF * ldw;
  float* red = smem + NSTAGE * stage;  // [MW][BT]
  const int r = blockIdx.y;
  const int h = r % H;
  const int s0 = blockIdx.x * BT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int rw = warp % RW;
  const int mw = warp / RW;
  const int ntiles = M / 8;
  const int nk = (F + KF - 1) / KF;
  const float* xr = x + (size_t)r * S * F;
  const float* W1 = w1 + (size_t)h * F * M;

  // features kt KF .. + KF of the x tile and of W1[h] into ring stage st,
  // zeros past S and past F
  auto load = [&](int kt, int st) {
    float* xs = smem + st * stage;
    float* ws = xs + tile_floats_x<RW>();
    const int f0 = kt * KF;
    for (int e = tid; e < BT * (KF / 4); e += THREADS) {
      const int row = e / (KF / 4);
      const int c = e - row * (KF / 4);
      const bool ok = s0 + row < S && f0 + 4 * c < F;
      const float* src = ok ? xr + (size_t)(s0 + row) * F + f0 + 4 * c : xr;
      async_copy::cp16_zfill(xs + row * LDX + 4 * c, src, ok);
    }
    const int m4 = M / 4;
    for (int e = tid; e < KF * m4; e += THREADS) {
      const int k = e / m4;
      const int c = e - k * m4;
      const bool ok = f0 + k < F;
      const float* src = ok ? W1 + (size_t)(f0 + k) * M + 4 * c : W1;
      async_copy::cp16_zfill(ws + k * ldw + 4 * c, src, ok);
    }
  };

  float acc[NTW][4];
#pragma unroll
  for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (st < nk) load(st, st);
    async_copy::commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    async_copy::wait<NSTAGE - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is free
    if (kt + NSTAGE - 1 < nk) load(kt + NSTAGE - 1, (kt + NSTAGE - 1) % NSTAGE);
    async_copy::commit();
    const float* xs = smem + (kt % NSTAGE) * stage;
    const float* ws = xs + tile_floats_x<RW>();
    const float* arow = xs + (16 * rw + gq) * LDX + tq;
#pragma unroll
    for (int ks = 0; ks < KF / 8; ++ks) {
      if (kt * KF + ks * 8 >= F) break;
      float a[4];
      mma::load_a<LDX>(a, arow + ks * 8);
      uint32_t ah[4], al[4];
      mma::split(a, ah, al);
      const float* wrow = ws + (ks * 8 + tq) * ldw + gq;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int nt = mw + MW * j;
        if (nt < ntiles) {
          const float b[2] = {wrow[nt * 8], wrow[4 * ldw + nt * 8]};
          uint32_t bh[2], bl[2];
          mma::split(b, bh, bl);
          mma::mma_3xtf32(acc[j], ah, al, bh, bl);
        }
      }
    }
  }
  async_copy::wait<0>();

  // epilogue: rows 16 rw + g (p0) and + 8 (p1), units nt 8 + 2t + e
  float p0 = 0.f, p1 = 0.f;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = mw + MW * j;
    if (nt < ntiles) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nt * 8 + 2 * tq + e;
        const float bb = b1[h * M + n];
        const float ww = w2[h * M + n];
        p0 += gelu_tanh(acc[j][e] + bb) * ww;
        p1 += gelu_tanh(acc[j][2 + e] + bb) * ww;
      }
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    p0 += __shfl_xor_sync(0xffffffffu, p0, o);
    p1 += __shfl_xor_sync(0xffffffffu, p1, o);
  }
  if (tq == 0) {
    red[mw * BT + 16 * rw + gq] = p0;
    red[mw * BT + 16 * rw + gq + 8] = p1;
  }
  __syncthreads();
  for (int i = tid; i < BT; i += THREADS) {
    if (s0 + i < S) {
      float y = 0.f;
#pragma unroll
      for (int w = 0; w < MW; ++w) y += red[w * BT + i];
      g[(size_t)r * S + s0 + i] = sigmoid(y + b2[h]);
    }
  }
}

// Dynamic shared memory above 48 KB needs the kernel's attribute raised.
template <typename Kernel>
cudaError_t launch_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

template <int MJ>
cudaError_t launch_decode(const float* x, const float* w1, const float* b1,
                          const float* w2, const float* b2, float* g, int S,
                          int F, int M, int H, int T, cudaStream_t stream) {
  const size_t smem = (size_t)(DEC_TOK * F + DEC_WARPS * DEC_TOK * 32 * MJ) * sizeof(float);
  const cudaError_t err = launch_smem(gate_decode_kernel<MJ>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(H, (T + DEC_TOK - 1) / DEC_TOK);
  gate_decode_kernel<MJ><<<grid, DEC_WARPS * 32, smem, stream>>>(
      x, w1, b1, w2, b2, g, S, F, M, H, T);
  return cudaGetLastError();
}

template <int RW>
cudaError_t launch_mma(const float* x, const float* w1, const float* b1,
                       const float* w2, const float* b2, float* g, int R,
                       int S, int F, int M, int H, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<RW>(M);
  const cudaError_t err = launch_smem(gate_mma_kernel<RW>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + 16 * RW - 1) / (16 * RW), R);
  gate_mma_kernel<RW><<<grid, MMA_WARPS * 32, smem, stream>>>(
      x, w1, b1, w2, b2, g, S, F, M, H);
  return cudaGetLastError();
}

}  // namespace

// tile: 0 for the decode path, else the tensor-core path's tokens per CTA
// (64 or 16), as kernels/gate_mlp.py::plan chooses.
extern "C" int gate_mlp_f32(const float* x, const float* w1, const float* b1,
                            const float* w2, const float* b2, float* g,
                            int R, int S, int F, int M, int H, int tile,
                            void* stream) {
  if (R <= 0 || S <= 0) return 0;
  if (H <= 0 || R % H != 0 || F <= 0 || F % 8 != 0 || F > 2048 || M <= 0 ||
      M % 8 != 0 || M > 128)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tile == 0) {
    const long long tokens = (long long)(R / H) * S;
    if (tokens > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    switch ((M + 31) / 32) {
      case 1: return (int)launch_decode<1>(x, w1, b1, w2, b2, g, S, F, M, H, (int)tokens, st);
      case 2: return (int)launch_decode<2>(x, w1, b1, w2, b2, g, S, F, M, H, (int)tokens, st);
      case 3: return (int)launch_decode<3>(x, w1, b1, w2, b2, g, S, F, M, H, (int)tokens, st);
      default: return (int)launch_decode<4>(x, w1, b1, w2, b2, g, S, F, M, H, (int)tokens, st);
    }
  }
  if (R > 65535) return (int)cudaErrorInvalidValue;  // grid.y
  switch (tile) {
    case 64: return (int)launch_mma<4>(x, w1, b1, w2, b2, g, R, S, F, M, H, st);
    case 16: return (int)launch_mma<1>(x, w1, b1, w2, b2, g, R, S, F, M, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
