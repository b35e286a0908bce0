// Multi-tenant LoRA projection (BGMV) for Hopper, sm_90a:
//
//     y[m] = x[m] @ W + scale * (x[m] @ A[g]^T) @ B[g]^T,    g = idx[m]
//
// Replaces the TPU kernel grouped_lora_matmul_pallas
// (src/repro/kernels/lora_gather_matmul.py).  Like it, the base product
// x @ W is computed inside the kernel body and the per-row adapter gather
// happens here, so no per-row copy of A or B is ever written to device
// memory.  Where the Pallas kernel had the index scalar-prefetched to steer
// its DMA, each block here reads idx[m] itself.
//
// Shapes: x [M, K], W [K, N], A [G, r, K], B [G, N, r], idx int32 [M],
// y [M, N].  x, W and y share one type (f32 or bf16); A and B share one type
// (f32 or bf16).  Every product accumulates in f32.  Ragged K and N are
// masked here (the Pallas wrapper padded them instead).  An out-of-range
// idx is clamped to [0, G), as a gather clamps.
//
// Design (simple and right first): one block per (row m, tile of 128 output
// columns).  The block stages x[m] in shared memory as f32, reduces the r
// values xa = x[m] . A[g]^T with one warp per rank row (lanes stride along
// K, so A is read coalesced), then each thread owns one output column and
// accumulates sum_k x[k] W[k, n]; neighbouring threads read neighbouring
// columns of W, so every W row is read coalesced.  The low-rank epilogue
// adds scale * sum_j xa[j] B[g, n, j] and the output is stored once.
//
// Bound on the H100: at the serving shapes (M = slots at decode, M =
// slots * chunk at prefill; K = 896, N in {896, 128}, r <= 64) the function
// needs 2MKN + 2Mr(K+N) operations against the bytes of W, x, y and the A/B
// of the distinct adapters in idx, so it is bound by memory at decode.  The
// known weakness of this design: W is read once per row (from L2 after the
// first), and xa is recomputed by every column tile of a row.  That is fine
// at decode, poor at the prefill shape; a row-tiled tensor-core (wgmma/TMA)
// version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;  // one output column per thread
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TX, typename TA>
__global__ void __launch_bounds__(kThreads)
grouped_lora_matmul_kernel(const TX* __restrict__ x, const TX* __restrict__ w,
                           const TA* __restrict__ a, const TA* __restrict__ b,
                           const int* __restrict__ idx, TX* __restrict__ y,
                           int K, int N, int G, int r, float scale) {
  extern __shared__ float smem[];
  float* xs = smem;       // [K] this row of x, as f32
  float* xa = smem + K;   // [r] x[m] . A[g]^T

  const int m = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int g = idx[m];
  g = g < 0 ? 0 : (g >= G ? G - 1 : g);

  const TX* xr = x + (size_t)m * K;
  for (int k = threadIdx.x; k < K; k += kThreads) xs[k] = to_f32(xr[k]);
  __syncthreads();

  // xa[j] = sum_k x[k] A[g, j, k]: one warp per rank row (warp-uniform loop,
  // so every lane takes part in the shuffles)
  const TA* ag = a + (size_t)g * r * K;
  for (int j = warp; j < r; j += kWarps) {
    const TA* arow = ag + (size_t)j * K;
    float s = 0.f;
    for (int k = lane; k < K; k += 32) s += xs[k] * to_f32(arow[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) xa[j] = s;
  }
  __syncthreads();

  if (n >= N) return;  // ragged N edge: no barrier follows

  // base = sum_k x[k] W[k, n], four independent partial sums in flight
  const TX* wc = w + n;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    acc0 += xs[k] * to_f32(wc[(size_t)k * N]);
    acc1 += xs[k + 1] * to_f32(wc[(size_t)(k + 1) * N]);
    acc2 += xs[k + 2] * to_f32(wc[(size_t)(k + 2) * N]);
    acc3 += xs[k + 3] * to_f32(wc[(size_t)(k + 3) * N]);
  }
  for (; k < K; ++k) acc0 += xs[k] * to_f32(wc[(size_t)k * N]);
  const float base = (acc0 + acc1) + (acc2 + acc3);

  // low-rank epilogue: sum_j xa[j] B[g, n, j]
  const TA* bn = b + ((size_t)g * N + n) * r;
  float delta = 0.f;
  for (int j = 0; j < r; ++j) delta += xa[j] * to_f32(bn[j]);

  y[(size_t)m * N + n] = from_f32<TX>(base + scale * delta);
}

template <typename TX, typename TA>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   const void* idx, void* y, int M, int K, int N, int G, int r,
                   float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(K + r) * sizeof(float);
  auto kern = grouped_lora_matmul_kernel<TX, TA>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(M, (N + kThreads - 1) / kThreads);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(w),
      static_cast<const TA*>(a), static_cast<const TA*>(b),
      static_cast<const int*>(idx), static_cast<TX*>(y), K, N, G, r, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes.  x_bf16 / ab_bf16 select bf16 (1) or f32 (0)
// for x/W/y and for A/B.  Returns the cudaError_t of the launch.
extern "C" int grouped_lora_matmul_launch(const void* x, const void* w,
                                          const void* a, const void* b,
                                          const void* idx, void* y, int M,
                                          int K, int N, int G, int r,
                                          float scale, int x_bf16, int ab_bf16,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && ab_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, w, a, b, idx, y, M, K, N, G, r, scale, s);
  if (x_bf16)
    return (int)launch<__nv_bfloat16, float>(x, w, a, b, idx, y, M, K, N, G, r, scale, s);
  if (ab_bf16)
    return (int)launch<float, __nv_bfloat16>(x, w, a, b, idx, y, M, K, N, G, r, scale, s);
  return (int)launch<float, float>(x, w, a, b, idx, y, M, K, N, G, r, scale, s);
}
