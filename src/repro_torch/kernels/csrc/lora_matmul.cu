// Fused LoRA projection for Hopper, sm_90a:
//
//     y = x @ W + scale * (x @ A^T) @ B^T
//
// Replaces the TPU kernel lora_matmul_pallas (src/repro/kernels/lora_matmul.py).
// Like it, the [M, r] activation x @ A^T and the [M, N] delta never go to
// device memory: x @ A^T is summed over all of K beside the base product, in
// registers, and the epilogue adds its product with B^T before y is stored
// once.  Where the Pallas kernel walked K as the innermost (sequential) grid
// axis and kept its two sums in VMEM scratch, each block here owns one
// (row tile, column tile) of y and loops over K itself.
//
// Shapes: x [M, K], W [K, N], A [r, K], B [N, r], y [M, N], all row-major.
// x, W and y share one type (f32 or bf16); A and B share one type (f32 or
// bf16); 1 <= r <= 128.  Every product accumulates in f32 and y is cast once.
// Ragged M, N and K edges are masked here (zeros enter the sums), which gives
// what the Pallas wrapper's zero-padding gives.
//
// Design (simple and right first): a block of 256 threads owns a 64 x 128
// tile of y.  Each step of the K loop stages a 32-deep slice of x, W and A in
// shared memory as f32; thread (ty, tx) keeps 4 rows x 8 columns of the base
// sum (columns tx + 16 j, so neighbouring threads read neighbouring words)
// and 4 rows x ceil(r / 16) ranks of x @ A^T.  After the loop x @ A^T goes to
// shared memory, the B tile is staged beside it, and the epilogue sums
// scale * xa @ B^T into each output.  Like the Pallas kernel, every column
// tile recomputes x @ A^T for its rows (r / 128 more work than the base).
//
// Bound on the H100: 2MN(K + r) + 2MKr operations against the bytes of x, W,
// A, B and y; which of the two bounds it depends on the shape (a narrow N is
// bound by the bytes of x).  This kernel runs on the CUDA cores in f32, so
// it is far from the bf16 tensor-core bound: a wgmma/TMA version is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BM = 64;          // rows of y per block
constexpr int BN = 128;         // columns of y per block
constexpr int BK = 32;          // depth of one staged slice
constexpr int kThreads = 256;   // 16 x 16
constexpr int TM = 4;           // rows per thread: ty * TM + i
constexpr int TN = BN / 16;     // columns per thread: tx + 16 j
constexpr int XS = BM + 1;      // padded stride of the transposed x slice
constexpr int BS = BN + 1;      // padded stride of the transposed B tile

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

// RT: ranks per thread, ceil(r / 16) rounded up to 1, 2, 4 or 8
template <typename TX, typename TA, int RT>
__global__ void __launch_bounds__(kThreads)
lora_matmul_kernel(const TX* __restrict__ x, const TX* __restrict__ w,
                   const TA* __restrict__ a, const TA* __restrict__ b,
                   TX* __restrict__ y, int M, int K, int N, int r,
                   float scale) {
  extern __shared__ float smem[];
  const int ra = r + 1;                 // padded stride of the A slice
  // K loop: x slice [BK][XS] (transposed), W slice [BK][BN], A slice [BK][ra]
  float* xs = smem;
  float* ws = xs + BK * XS;
  float* as = ws + BK * BN;
  // epilogue, over the same memory: xa [r][BM], B tile [r][BS]
  float* xas = smem;
  float* bs = smem + r * BM;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
  float xa[TM][RT];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < RT; ++j) xa[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads read consecutive k of one row of x and of A, and
    // consecutive n of one row of W
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int i = e / BK, kk = e % BK;
      const int m = m0 + i, k = k0 + kk;
      xs[kk * XS + i] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int kk = e / BN, c = e % BN;
      const int k = k0 + kk, n = n0 + c;
      ws[kk * BN + c] = (k < K && n < N) ? to_f32(w[(size_t)k * N + n]) : 0.f;
    }
    for (int e = tid; e < r * BK; e += kThreads) {
      const int j = e / BK, kk = e % BK;
      const int k = k0 + kk;
      as[kk * ra + j] = k < K ? to_f32(a[(size_t)j * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float xv[TM], wv[TN], av[RT];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[kk * XS + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = ws[kk * BN + tx + 16 * j];
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int jr = tx + 16 * j;
        av[j] = jr < r ? as[kk * ra + jr] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += xv[i] * wv[j];
#pragma unroll
        for (int j = 0; j < RT; ++j) xa[i][j] += xv[i] * av[j];
      }
    }
    __syncthreads();   // the slices are overwritten next (or by the epilogue)
  }

  // x @ A^T is complete over K: to shared memory, with the B tile beside it
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      const int jr = tx + 16 * j;
      if (jr < r) xas[jr * BM + ty * TM + i] = xa[i][j];
    }
  }
  for (int e = tid; e < BN * r; e += kThreads) {
    const int c = e / r, j = e % r;
    const int n = n0 + c;
    bs[j * BS + c] = n < N ? to_f32(b[(size_t)n * r + j]) : 0.f;
  }
  __syncthreads();

  float delta[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) delta[i][j] = 0.f;
  }
  for (int jr = 0; jr < r; ++jr) {
    float xv[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) xv[i] = xas[jr * BM + ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = bs[jr * BS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) delta[i][j] += xv[i] * bv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[(size_t)m * N + n] = from_f32<TX>(acc[i][j] + scale * delta[i][j]);
    }
  }
}

size_t smem_bytes(int r) {
  const size_t loop = (size_t)BK * XS + (size_t)BK * BN + (size_t)BK * (r + 1);
  const size_t epilogue = (size_t)r * BM + (size_t)r * BS;
  return (loop > epilogue ? loop : epilogue) * sizeof(float);
}

template <typename TX, typename TA, int RT>
cudaError_t launch_rt(const void* x, const void* w, const void* a,
                      const void* b, void* y, int M, int K, int N, int r,
                      float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(r);
  auto kern = lora_matmul_kernel<TX, TA, RT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TX*>(w),
      static_cast<const TA*>(a), static_cast<const TA*>(b),
      static_cast<TX*>(y), M, K, N, r, scale);
  return cudaGetLastError();
}

template <typename TX, typename TA>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   void* y, int M, int K, int N, int r, float scale,
                   cudaStream_t stream) {
  if (r <= 16) return launch_rt<TX, TA, 1>(x, w, a, b, y, M, K, N, r, scale, stream);
  if (r <= 32) return launch_rt<TX, TA, 2>(x, w, a, b, y, M, K, N, r, scale, stream);
  if (r <= 64) return launch_rt<TX, TA, 4>(x, w, a, b, y, M, K, N, r, scale, stream);
  return launch_rt<TX, TA, 8>(x, w, a, b, y, M, K, N, r, scale, stream);
}

}  // namespace

// C entry bound with ctypes.  x_bf16 / ab_bf16 select bf16 (1) or f32 (0)
// for x/W/y and for A/B.  Returns the cudaError_t of the launch; r outside
// [1, 128] or a grid too tall is refused as cudaErrorInvalidValue.
extern "C" int lora_matmul_launch(const void* x, const void* w, const void* a,
                                  const void* b, void* y, int M, int K, int N,
                                  int r, float scale, int x_bf16, int ab_bf16,
                                  void* stream) {
  if (r < 1 || r > 128 || M < 1 || N < 1 || K < 0
      || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && ab_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, w, a, b, y, M, K, N, r, scale, s);
  if (x_bf16)
    return (int)launch<__nv_bfloat16, float>(x, w, a, b, y, M, K, N, r, scale, s);
  if (ab_bf16)
    return (int)launch<float, __nv_bfloat16>(x, w, a, b, y, M, K, N, r, scale, s);
  return (int)launch<float, float>(x, w, a, b, y, M, K, N, r, scale, s);
}
