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
// One launch per tree.  Every leaf of a round's stacked tree shares the
// client weights (w [K, r] and the optional scale s [K], or p, cover and t
// for the trimmed mean), so one launch reduces them all: the wrapper packs a
// leaf table (DimAggLeaf, at most kMaxLeaves entries, passed by value as a
// __grid_constant__ parameter) in which each leaf owns a run of tiles of the
// grid, and a block finds its leaf from the tiles' prefix.  The grid is the
// tiles of every leaf, so the round's four leaves (wq.A, wq.B, wv.A, wv.B on
// fedbench-100m: 960 tiles) fill the 132 SMs together where each leaf alone
// left most of them idle behind a launch of its own.
//
// dim_agg.  A block of 256 threads owns a tile of 1024 output elements, 4
// a thread:
//  * the vector route (the leaf's Q % 4 == 0 and 16-byte-aligned bases,
//    picked by the wrapper from those pure inputs): the float4 at tile
//    element 4t, loaded and stored in 16 bytes.  In the A layout its 4
//    elements share one d; in the B layout they are d .. d + 3;
//  * the scalar route (any other leaf, such as a view at an odd element
//    offset): tile elements t + 256 c, so a warp still reads 128
//    contiguous bytes.
// The weights w[k, d] s_k of up to 32 clients at a time are staged in
// shared memory once a block (at most 32 x 256 floats), and each thread
// issues the loads of 4 clients for its 4 elements before their FMAs;
// the first loads go out before the weights are staged, so a small leaf
// waits for one memory round trip, not two.  The leaves are read and the
// outputs written with the streaming cache hint (evict first): each byte
// is touched once, and on the card this took the one-leaf launches below
// those of the earlier one-thread-an-element kernel.
// The arithmetic is that kernel's, which matched the plain einsum bit for
// bit on the card: every output sums k = 0 .. K-1 in order,
// acc = fma(w[k, d] * s_k, x[k, e], acc) from acc = 0, with the weight times
// the scale rounded first, as the Pallas body (_kernel_scaled) multiplies
// the weight row by the scale before the reduction.
//
// dim_agg_trimmed.  Instantiated for each client count K = 1 .. 32, so the
// loops unroll and an element's K values, coverages and counts stay in
// registers (no spill at any K; up to four blocks an SM at K <= 12).  A
// thread takes one element (a tile is 256 elements: more elements a thread
// ran slower on the card, at K = 4 and at K = 10) and issues its K loads,
// with the streaming hint, before the block stages cover [K, r], t [r] and
// p [K] in shared memory.
// Client i's counts among the covering clients, lo (below it) and hi
// (above it), with equal values ordered by client index as dim_agg.py:77-78
// orders them, are taken once per unordered pair j < i, with one
// comparison:
//     x_j <= x_i:  lo_i += c_j, hi_j += c_i
//     otherwise:   hi_i += c_j, lo_j += c_i
// which gives each count its terms in ascending client order (the earlier
// kernel's sums, bit for bit) in K(K-1)/2 steps instead of K^2.  Where no
// client value of the element is NaN, "otherwise" is x_j > x_i and the
// counts are the reference's.  A NaN compares false both ways, so the
// reference counts it in neither direction and this kernel in one; but
// such an element's result is NaN either way, since its NaN term reaches
// the sum as keep * p * NaN whatever is kept.  Client i is kept when
// lo_i >= t[d] and hi_i >= t[d], and the result is
// sum keep p x / max(sum keep p, 1e-12), summed over every client in order,
// the dropped ones included (0 * NaN and 0 * Inf are NaN there, as in the
// reference).  A sorting network would order NaN and ties otherwise, so
// none is used.
//
// Bound on the H100: each output element reads K inputs and writes one, 4 (K
// + 1) bytes, and does 2K operations (dim_agg) or about 8K^2 (the trimmed
// mean as the reference counts it).  The card does 20 f32 operations per
// byte of memory traffic, so dim_agg is bound by memory and so is the
// trimmed mean up to K = 10.  At the round's tree (K = 4, 15.7 MB of client
// leaves and 3.9 MB of output) that is 5.9 us; at K = 10, L = 64, r = 32,
// n = 4096 about 0.11 ms a leaf.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <array>
#include <utility>

// One leaf of a launch as the wrapper packs it (kernels/dim_agg.py mirrors
// this layout in ctypes: 48 bytes).
struct DimAggLeaf {
  const float* x;     // [K, L, P, Q]
  float* out;         // [L, P, Q]
  long long n_out;    // L * P * Q, < 2^31
  int P, Q;
  int rank_axis;      // 2: d = p (A layout); 3: d = q (B layout)
  int vec;            // 1: dim_agg's vector route
  int tile0;          // the leaf's first tile in the launch's grid
  int tiles;          // its tiles
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 32;
constexpr int kMaxClients = 32;    // dim_agg_trimmed
constexpr int kMaxRank = 256;      // the shared-memory rows hold r floats
constexpr int kStage = 32;         // dim_agg: clients staged at a time
constexpr int kTile = kThreads * 4;   // dim_agg: 4 elements a thread
constexpr int kChunk = 4;          // dim_agg: client loads before the FMAs

struct LeafTable {
  DimAggLeaf leaf[kMaxLeaves];
  int n;
};

// the leaf that owns tile b (the table's tile0 ascend from 0)
__device__ __forceinline__ const DimAggLeaf& leaf_of(const LeafTable& T,
                                                     int b) {
  int i = 0;
  while (i + 1 < T.n && T.leaf[i + 1].tile0 <= b) ++i;
  return T.leaf[i];
}

// rank dimension of flat output element e of [L, P, Q]
__device__ __forceinline__ int rank_dim(const DimAggLeaf& L, int e) {
  return L.rank_axis == 2 ? (e / L.Q) % L.P : e % L.Q;
}

template <bool VEC>
__device__ __forceinline__ void dim_agg_tile(const DimAggLeaf& L, int tile,
                                             const float* __restrict__ w,
                                             const float* __restrict__ s,
                                             int K, int r, float* ws) {
  const int n = (int)L.n_out;
  const int base = tile * kTile, t = threadIdx.x;
  const bool rows = L.rank_axis == 2;
  const float* __restrict__ x = L.x;
  // the thread's element c of the tile
  auto elem = [&](int c) -> int {
    return VEC ? base + 4 * t + c : base + t + kThreads * c;
  };
  int d[4];
  bool ok[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    ok[c] = elem(c) < n;
    d[c] = ok[c] ? rank_dim(L, elem(c)) : 0;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int kc = 0; kc < K; kc += kStage) {
    const int nk = min(kStage, K - kc);
    for (int k0 = 0; k0 < nk; k0 += kChunk) {
      float xv[kChunk][4];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const bool live = k0 + c < nk;
        const float* xk = x + (size_t)(kc + k0 + c) * n;
        if (VEC) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live && ok[0])
            v = __ldcs(reinterpret_cast<const float4*>(xk + elem(0)));
          xv[c][0] = v.x;
          xv[c][1] = v.y;
          xv[c][2] = v.z;
          xv[c][3] = v.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xv[c][q] = (live && ok[q]) ? __ldcs(xk + elem(q)) : 0.f;
        }
      }
      if (k0 == 0) {   // stage the weights while the first loads fly
        __syncthreads();   // the previous stage's readers are done
        for (int i = t; i < nk * r; i += kThreads) {
          const int k = kc + i / r;
          float v = w[(size_t)k * r + i % r];
          if (s != nullptr) v *= s[k];
          ws[i] = v;
        }
        __syncthreads();
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (k0 + c < nk) {
          const float* wr = ws + (k0 + c) * r;
          float wv[4];
          if (VEC && rows) {          // 4 elements of one rank row
            wv[0] = wv[1] = wv[2] = wv[3] = wr[d[0]];
          } else if (VEC) {           // rank dimensions d .. d + 3
            const float4 w4 = *reinterpret_cast<const float4*>(wr + d[0]);
            wv[0] = w4.x;
            wv[1] = w4.y;
            wv[2] = w4.z;
            wv[3] = w4.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) wv[q] = wr[d[q]];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaf(wv[q], xv[c][q], acc[q]);
        }
      }
    }
  }
  if (VEC) {
    if (ok[0])
      __stcs(reinterpret_cast<float4*>(L.out + elem(0)),
             make_float4(acc[0], acc[1], acc[2], acc[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (ok[q]) __stcs(L.out + elem(q), acc[q]);
  }
}

__global__ void __launch_bounds__(kThreads, 4)
dim_agg_kernel(const __grid_constant__ LeafTable T,
               const float* __restrict__ w, const float* __restrict__ s,
               int K, int r) {
  extern __shared__ __align__(16) float ws[];   // [min(K, kStage)][r]
  const DimAggLeaf& L = leaf_of(T, blockIdx.x);
  const int tile = blockIdx.x - L.tile0;
  if (L.vec)
    dim_agg_tile<true>(L, tile, w, s, K, r, ws);
  else
    dim_agg_tile<false>(L, tile, w, s, K, r, ws);
}

// The trimmed mean of one element from its K values, at rank dimension d.
template <int K>
__device__ __forceinline__ float trimmed_element(const float (&xv)[K], int r,
                                                 int d, const float* cov_s,
                                                 const float* t_s,
                                                 const float* p_s) {
  float c[K], lo[K], hi[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    c[k] = cov_s[k * r + d];
    lo[k] = 0.f;
    hi[k] = 0.f;
  }
  // each unordered pair once, one comparison: lo_i and hi_i gather their
  // terms in ascending client order
#pragma unroll
  for (int i = 1; i < K; ++i) {
    const float xi = xv[i];
#pragma unroll
    for (int q = 0; q < i; ++q) {
      if (xv[q] <= xi) {
        lo[i] += c[q];
        hi[q] += c[i];
      } else {
        hi[i] += c[q];
        lo[q] += c[i];
      }
    }
  }
  const float td = t_s[d];
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float keep = c[i] * (float)(lo[i] >= td) * (float)(hi[i] >= td);
    const float kp = keep * p_s[i];
    num = fmaf(kp, xv[i], num);
    den += kp;
  }
  return num / fmaxf(den, 1e-12f);
}

// blocks an SM that the K-client instance's registers allow
__host__ __device__ constexpr int trimmed_min_blocks(int K) {
  return K <= 12 ? 4 : K <= 16 ? 3 : K <= 24 ? 2 : 1;
}

template <int K>
__global__ void __launch_bounds__(kThreads, trimmed_min_blocks(K))
dim_agg_trimmed_kernel(const __grid_constant__ LeafTable T,
                       const float* __restrict__ p,
                       const float* __restrict__ cover,
                       const float* __restrict__ tr, int r) {
  extern __shared__ __align__(16) float sm[];
  float* cov_s = sm;              // [K][r]
  float* t_s = sm + K * r;        // [r]
  float* p_s = t_s + r;           // [K]

  const DimAggLeaf& L = leaf_of(T, blockIdx.x);
  const int n = (int)L.n_out;
  const int e = (blockIdx.x - L.tile0) * kThreads + threadIdx.x;
  float xv[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    xv[k] = e < n ? __ldcs(L.x + (size_t)k * n + e) : 0.f;
  // stage the shared operands while the loads fly
  for (int i = threadIdx.x; i < K * r; i += kThreads) cov_s[i] = cover[i];
  for (int i = threadIdx.x; i < r; i += kThreads) t_s[i] = tr[i];
  for (int i = threadIdx.x; i < K; i += kThreads) p_s[i] = p[i];
  __syncthreads();
  if (e < n)
    __stcs(L.out + e,
           trimmed_element(xv, r, rank_dim(L, e), cov_s, t_s, p_s));
}

// Copy the wrapper's leaves into a table and check them: at most kMaxLeaves,
// each leaf's rank dimension r, tiles of `tile` elements numbered from 0 in
// order, and the vector route only where its loads may be 16 bytes wide.
// Returns the grid's tiles, or -1.
int pack(const DimAggLeaf* leaves, int n_leaves, int tile, int r,
         LeafTable* T) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return -1;
  long long tiles = 0;
  for (int i = 0; i < n_leaves; ++i) {
    const DimAggLeaf& L = leaves[i];
    if (L.n_out < 1 || L.n_out >= (1LL << 31) || L.P < 1 || L.Q < 1)
      return -1;
    if ((L.rank_axis == 2 ? L.P : L.rank_axis == 3 ? L.Q : -1) != r)
      return -1;
    if (L.vec && (L.Q % 4 || (uintptr_t)L.x % 16 || (uintptr_t)L.out % 16))
      return -1;
    if (L.tile0 != tiles || L.tiles != (L.n_out + tile - 1) / tile)
      return -1;
    tiles += L.tiles;
    T->leaf[i] = L;
  }
  T->n = n_leaves;
  return tiles < (1LL << 31) ? (int)tiles : -1;
}

template <int K>
int launch_trimmed(const DimAggLeaf* leaves, int n_leaves, const float* p,
                   const float* cover, const float* t, int r,
                   cudaStream_t stream) {
  LeafTable T;
  const int tiles = pack(leaves, n_leaves, kThreads, r, &T);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(K * r + r + K) * sizeof(float);
  dim_agg_trimmed_kernel<K><<<tiles, kThreads, smem, stream>>>(T, p, cover,
                                                                t, r);
  return (int)cudaGetLastError();
}

using TrimmedLaunch = int (*)(const DimAggLeaf*, int, const float*,
                              const float*, const float*, int, cudaStream_t);

// launch_trimmed<1> .. launch_trimmed<kMaxClients>, by K - 1
template <int... I>
constexpr std::array<TrimmedLaunch, sizeof...(I)> trimmed_instances(
    std::integer_sequence<int, I...>) {
  return {&launch_trimmed<I + 1>...};
}
constexpr auto kTrimmed =
    trimmed_instances(std::make_integer_sequence<int, kMaxClients>{});

}  // namespace

// C entries bound with ctypes.  `leaves` is a host array of n_leaves
// entries (the wrapper's packing, checked again here); w [K, r], s [K] (or
// null: no per-client scale), p [K], cover [K, r] and t [r] are f32 on the
// device.  Each returns the cudaError_t of its launch (0 on success).

extern "C" int dim_agg_tree_launch(const DimAggLeaf* leaves, int n_leaves,
                                   const float* w, const float* s, int K,
                                   int r, void* stream) {
  if (K < 1 || r < 1 || r > kMaxRank) return (int)cudaErrorInvalidValue;
  LeafTable T;
  const int tiles = pack(leaves, n_leaves, kTile, r, &T);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(K < kStage ? K : kStage) * r * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim_agg_kernel<<<tiles, kThreads, smem, st>>>(T, w, s, K, r);
  return (int)cudaGetLastError();
}

extern "C" int dim_agg_trimmed_tree_launch(const DimAggLeaf* leaves,
                                           int n_leaves, const float* p,
                                           const float* cover, const float* t,
                                           int K, int r, void* stream) {
  if (K < 1 || K > kMaxClients || r < 1 || r > kMaxRank)
    return (int)cudaErrorInvalidValue;
  return kTrimmed[K - 1](leaves, n_leaves, p, cover, t, r,
                        static_cast<cudaStream_t>(stream));
}
