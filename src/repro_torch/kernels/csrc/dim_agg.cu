// Dimension-wise aggregation of stacked client LoRA leaves for Hopper,
// sm_90a.  Two kernels:
//
//   dim_agg          FediLoRA Eq. 5: out[l, p, q] = sum_k w[k, d] s_k X[k, l, p, q]
//   dim_agg_trimmed  the dimension-wise trimmed weighted mean over the
//                    clients that cover rank dimension d
//
// They replace the TPU kernels dim_agg_pallas and dim_agg_trimmed_pallas
// (src/repro/kernels/dim_agg.py).  A leaf is read in its native layout
// [K, L, P, Q] and the result is written in the same layout [L, P, Q]:
// rank_axis = 2 for an A leaf ([K, L, r, n], d = p) and rank_axis = 3 for a
// B leaf ([K, L, m, r], d = q).  The Pallas wrapper transposed every B leaf
// to [K, L, r, m] and back; here B is reduced where it lies, so no transposed
// copy is written and the output needs no transpose.
//
// Types: every operand is f32 (adapters train and aggregate in f32), and
// every sum is taken in f32.
//
// Design (simple and right first): one thread per output element, a flat
// 1-D grid over [L, P, Q], so neighbouring threads read neighbouring q and
// every load and store is coalesced in both layouts.
//
// * dim_agg loops k = 0..K-1 in order, acc += (w[k, d] * s_k) * X[k, e], as
//   the Pallas body multiplies the weight row by the scale first.
// * dim_agg_trimmed holds the K values of its element in a local array
//   (K <= 32), counts for each client i how many covering clients lie
//   strictly below it (lo) and above it (hi), ties broken by client index
//   exactly as dim_agg.py:77-78 does, keeps i when lo >= t[d] and
//   hi >= t[d], and writes sum keep p x / max(sum keep p, 1e-12).  The
//   O(K^2) comparison stays in registers and local memory.  Comparisons of
//   equal f32 values are exact, so the kept set is the reference's.
//
// Bound on the H100: each output element reads K inputs and writes one, 4 (K
// + 1) bytes, and does 2K operations (dim_agg) or about 8K^2 (trimmed: the
// comparisons, multiplies and adds of the counting loop).  The card does 20
// f32 operations per byte of memory traffic, so dim_agg is bound by memory,
// (K + 1) * L * P * Q * 4 bytes over 3.35 TB/s, and so is the trimmed mean
// up to K = 10, where the two bounds meet.  At the round's shapes (K = 4,
// L = 12, P*Q = 32 * 768) that is about 1.8 us, less than a launch costs;
// at K = 10, L = 64, r = 32, n = 4096 it is about 0.11 ms.  Not done here
// (later work): vector loads, several elements per thread, one launch for
// all leaves of a round.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClients = 32;

// rank dimension of flat output element e of [L, P, Q]
__device__ __forceinline__ int rank_dim(long long e, int P, int Q, int rank_axis) {
  return rank_axis == 2 ? (int)((e / Q) % P) : (int)(e % Q);
}

__global__ void __launch_bounds__(kThreads)
dim_agg_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ s, float* __restrict__ out, int K, int r,
               long long n_out, int P, int Q, int rank_axis) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_out) return;
  const int d = rank_dim(e, P, Q, rank_axis);
  float acc = 0.f;
  for (int k = 0; k < K; ++k) {
    float wk = w[(size_t)k * r + d];
    if (s != nullptr) wk *= s[k];
    acc += wk * x[(size_t)k * n_out + e];
  }
  out[e] = acc;
}

__global__ void __launch_bounds__(kThreads)
dim_agg_trimmed_kernel(const float* __restrict__ x, const float* __restrict__ p,
                       const float* __restrict__ cover,
                       const float* __restrict__ t, float* __restrict__ out, int K,
                       int r, long long n_out, int P, int Q, int rank_axis) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n_out) return;
  const int d = rank_dim(e, P, Q, rank_axis);
  float xv[kMaxClients];
  for (int k = 0; k < K; ++k) xv[k] = x[(size_t)k * n_out + e];
  const float td = t[d];
  float num = 0.f, den = 0.f;
  for (int i = 0; i < K; ++i) {
    const float xi = xv[i];
    float lo = 0.f, hi = 0.f;
    for (int j = 0; j < K; ++j) {
      const float cj = cover[(size_t)j * r + d];
      const float xj = xv[j];
      lo += cj * (float)((xj < xi) || (xj == xi && j < i));
      hi += cj * (float)((xj > xi) || (xj == xi && j > i));
    }
    const float keep = cover[(size_t)i * r + d] * (float)(lo >= td) * (float)(hi >= td);
    const float kp = keep * p[i];
    num += kp * xi;
    den += kp;
  }
  out[e] = num / fmaxf(den, 1e-12f);
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// C entries bound with ctypes.  x / out: [K, L, P, Q] / [L, P, Q] f32,
// contiguous; s may be null (no per-client scale).  Each returns the
// cudaError_t of its launch (0 on success).

extern "C" int dim_agg_launch(const float* x, const float* w, const float* s,
                              float* out, int K, int L, int P, int Q,
                              int rank_axis, void* stream) {
  const long long n_out = (long long)L * P * Q;
  if (n_out == 0) return 0;
  dim_agg_kernel<<<blocks_for(n_out), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      x, w, s, out, K, rank_axis == 2 ? P : Q, n_out, P, Q, rank_axis);
  return (int)cudaGetLastError();
}

extern "C" int dim_agg_trimmed_launch(const float* x, const float* p,
                                      const float* cover, const float* t,
                                      float* out, int K, int L, int P, int Q,
                                      int rank_axis, void* stream) {
  const long long n_out = (long long)L * P * Q;
  if (n_out == 0) return 0;
  if (K > kMaxClients) return (int)cudaErrorInvalidValue;
  dim_agg_trimmed_kernel<<<blocks_for(n_out), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, p, cover, t, out, K, rank_axis == 2 ? P : Q, n_out, P, Q, rank_axis);
  return (int)cudaGetLastError();
}
