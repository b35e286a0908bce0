// Fused LoRA projection for Hopper, sm_90a, on the tensor cores in 3xTF32:
//
//     y = x @ W + scale * (x @ A^T) @ B^T
//
// The "tf32x3" route of repro_torch.kernels.lora_matmul (lora_route): f32,
// the two mixed dtype pairs, and bf16 whose strides TMA refuses.  bf16 that
// TMA takes goes to lora_matmul_wgmma.cu.
//
// Replaces the TPU kernel lora_matmul_pallas (src/repro/kernels/lora_matmul.py).
// Like it, the [M, r] activation x @ A^T and the [M, N] delta never go to
// device memory: x @ A^T is summed over K beside the base product, in
// registers, and the epilogue adds its product with B^T before y is stored
// once.  Shapes: x [M, K], W [K, N], A [r, K], B [N, r], y [M, N], all
// row-major; x, W and y share one type (f32 or bf16), A and B share one type
// (f32 or bf16); 1 <= r <= 128.  Every sum is f32 and y is cast once.
//
// Arithmetic.  TF32 keeps 10 mantissa bits, too few for the f32 limit of
// 1e-4, so every f32 operand v is split into big = tf32(v) (round to
// nearest, ties away from zero, as cvt.rna, in two integer operations) and
// small = v - big, whose TF32 part the tensor core reads (it drops the low
// 13 bits), and a product of a and b is taken as a_small . b_big + a_big .
// b_small + a_big . b_big on mma.sync.m16n8k8 with f32 sums (CUTLASS's
// "3xTF32"); the dropped a_small . b_small and the truncation of small
// leave about 2^-20 of each term.  The tensor core rounds its f32 sums
// toward zero, always the same way, so no running sum stays in it for long:
// a stage's base products (32 deep) and each k8 step's x @ A^T products
// start from zero and are added to the running sums in f32 (summed in the
// tensor core over all of K, chip_smoke.py's 2048 x 2048 x 2048 case ends
// outside the f32 limit on the H100).  A bf16 value is a
// TF32 value, so where an operand is bf16 its small part is 0 and those
// products are not issued (templated on the types): bf16 x . W takes one
// mma, a mixed pair two.
//
// Design: a block of 4 warps owns a 64 x 128 tile of y; warp w owns its 64
// rows x columns [32 w, 32 w + 32) (4 x 4 m16n8 tiles).  The K loop stages
// 32-deep slices of x [64][32], W [32][128] and A [r][32] in their own types
// in a 3-stage cp.async ring (16-byte copies where the row stride and base
// allow; element loads with zeros at the ragged edge and past r), padded so
// that every fragment load is free of bank conflicts.  Each fragment is split
// in registers right after its ld.shared.  x @ A^T is an extra column block
// of the same loop: its n8 tiles come in groups of 4, tile 4 q + w to warp w
// (NTA groups at most).  After the loop scale * (x @ A^T) goes to shared
// memory in f32 beside the B tile (as f32), and the epilogue runs its
// product with B^T over the depth r in 3xTF32 into the base sums; y is
// stored once.
//
// Clusters.  The grid is (column tiles, row tiles, split) in clusters of
// (share, 1, split) blocks (launch_n):
//  * split > 1 where the tiles fill fewer than one block a SM: the split
//    blocks of a tile sum parts of K, and part 0 adds the others' partial
//    sums from their shared memory (distributed shared memory, in part
//    order);
//  * share > 1 where r > 32: the share column tiles of a row tile split the
//    groups of x @ A^T between them (one group a block at most) and copy
//    the others' finished tiles; where every column tile recomputed it,
//    x @ A^T cost qwen2-0.5b's wq (r 64) half the base product again.
//
// Instances: x/W f32 or bf16 x A/B f32 or bf16 x NTA = 1, 2, 4 (r <= 32,
// 64, 128).  Shared memory: 3 stages of x, W and 32 NTA rows of A (in f32
// 91.5, 105 and 132 KB), or the epilogue's (64 + 128) x (r + 4) floats if
// larger.  Blocks of 128 threads, two a SM up to NTA = 2, one at NTA = 4;
// ptxas gives the instances 214-255 registers, and the two with f32 x at
// NTA = 4 spill 32-64 bytes.
//
// Bound on the H100: 2MN(K + r) + 2MKr operations against the bytes of x,
// W, A, B and y.  3xTF32 runs three tensor-core products for each f32 one,
// so the operations' bound is their count over max(the f32 CUDA-core peak,
// the TF32 peak / 3).  mma.sync reaches less of the TF32 peak than wgmma
// (chip_smoke.py's probe measures its rate in a register-only loop), and
// wgmma.tf32 would need W in K-major order (W is N-major).
//
// The split, the mma.sync TF32 product and the cp.async copies are
// hopper.cuh's, shared with flash_attention.cu.

#include <cooperative_groups.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMI = 4;          // m16 tiles of a warp: 16 kMI rows
constexpr int BM = 16 * kMI;    // rows of y per block
constexpr int BN = 128;         // columns of y per block: 4 warps x 32
constexpr int BK = 32;          // depth of one stage
constexpr int kThreads = 128;   // 4 warps, one a 32-column slice
constexpr int kStages = 3;
constexpr int kMaxSplit = 4;    // blocks of a cluster that split K
constexpr int kMaxCluster = 8;  // blocks of a cluster (the portable limit)

template <typename T>
__host__ __device__ constexpr bool is_f32() { return sizeof(T) == 4; }
// row strides (elements) of the staged x and A slices and of the W slice:
// 16-byte multiples whose fragment reads hit 32 distinct banks
template <typename T>
__host__ __device__ constexpr int ka_stride() {
  return BK + (is_f32<T>() ? 4 : 8);
}
constexpr int kWStride = BN + 8;

template <typename TX, typename TA, int NTA>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)BM * ka_stride<TX>() * sizeof(TX)
         + (size_t)BK * kWStride * sizeof(TX)
         + (size_t)32 * NTA * ka_stride<TA>() * sizeof(TA);
}

// c[i] += a[i] . b for the kMI m16 tiles i in 3xTF32, the small products
// first; SA / SB: a / b has a small part (is f32).  The tensor core rounds
// its f32 sum toward zero, so summing into c itself would lose up to an ulp
// of |c| a step, always the same way; the products go to a fresh sum of one
// k8 step instead, which is added to c with round-to-nearest.  Each product runs over the tiles before the next,
// so that no mma waits on the one just issued.
template <bool SA, bool SB>
__device__ __forceinline__ void mma3(float (&c)[kMI][4],
                                     const uint32_t (&ab)[kMI][4],
                                     const uint32_t (&as)[kMI][4],
                                     const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  float t[kMI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    if constexpr (SA) mma_tf32_z(t[i], as[i], bb[0], bb[1]);
    else if constexpr (SB) mma_tf32_z(t[i], ab[i], bs[0], bs[1]);
    else mma_tf32_z(t[i], ab[i], bb[0], bb[1]);
  }
  if constexpr (SA && SB) {
#pragma unroll
    for (int i = 0; i < kMI; ++i) mma_tf32(t[i], ab[i], bs[0], bs[1]);
  }
  if constexpr (SA || SB) {
#pragma unroll
    for (int i = 0; i < kMI; ++i) mma_tf32(t[i], ab[i], bb[0], bb[1]);
  }
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] += t[i][e];
}

// t[i] (+)= a[i] . b in 3xTF32 without the final add: the products of one
// stage go into t (from zero at its first k8 step), which is added to the
// running sum once a stage, keeping each tensor-core sum to 32 terms
template <bool SA, bool SB>
__device__ __forceinline__ void mma3_into(float (&t)[kMI][4],
                                          const uint32_t (&ab)[kMI][4],
                                          const uint32_t (&as)[kMI][4],
                                          const uint32_t (&bb)[2],
                                          const uint32_t (&bs)[2],
                                          bool first) {
#pragma unroll
  for (int i = 0; i < kMI; ++i) {
    if constexpr (SA) {
      if (first) mma_tf32_z(t[i], as[i], bb[0], bb[1]);
      else mma_tf32(t[i], as[i], bb[0], bb[1]);
    } else if constexpr (SB) {
      if (first) mma_tf32_z(t[i], ab[i], bs[0], bs[1]);
      else mma_tf32(t[i], ab[i], bs[0], bs[1]);
    } else {
      if (first) mma_tf32_z(t[i], ab[i], bb[0], bb[1]);
      else mma_tf32(t[i], ab[i], bb[0], bb[1]);
    }
  }
  if constexpr (SA && SB) {
#pragma unroll
    for (int i = 0; i < kMI; ++i) mma_tf32(t[i], ab[i], bs[0], bs[1]);
  }
  if constexpr (SA || SB) {
#pragma unroll
    for (int i = 0; i < kMI; ++i) mma_tf32(t[i], ab[i], bb[0], bb[1]);
  }
}

// blocks of this block's cluster along x
__device__ __forceinline__ int cluster_dim_x() {
  uint32_t n;
  asm("mov.u32 %0, %%cluster_nctaid.x;" : "=r"(n));
  return (int)n;
}

// a [rows][COLS] slice at src (row stride ld elements) into dst (row stride
// DS): rows_ok rows and cols_ok columns lie in bounds, zeros elsewhere.
// 16-byte chunks go by cp.async where `vec` (16-byte-aligned base and row
// stride) and the chunk is whole; the rest by element loads.
template <typename T, int COLS, int DS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int ld,
                                          int rows, int rows_ok, int cols_ok,
                                          bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CPR = COLS / V;
  for (int c = threadIdx.x; c < rows * CPR; c += kThreads) {
    const int i = c / CPR, j = (c % CPR) * V;
    T* d = dst + i * DS + j;
    const T* s = src + (size_t)i * ld + j;
    if (vec && i < rows_ok && j + V <= cols_ok) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        d[e] = (i < rows_ok && j + e < cols_ok) ? s[e] : from_f32<T>(0.f);
    }
  }
}

template <typename TX, typename TA, int NTA>
__global__ void __launch_bounds__(kThreads)
lora_tf32x3_kernel(const TX* __restrict__ x, const TX* __restrict__ w,
                   const TA* __restrict__ a, const TA* __restrict__ b,
                   TX* __restrict__ y, int M, int K, int N, int r,
                   float scale) {
  constexpr bool SX = is_f32<TX>(), SA = is_f32<TA>();
  constexpr int XS = ka_stride<TX>(), AS = ka_stride<TA>(), WS = kWStride;
  constexpr size_t XB = (size_t)BM * XS * sizeof(TX);
  constexpr size_t WB = (size_t)BK * WS * sizeof(TX);
  constexpr size_t SB = stage_bytes<TX, TA, NTA>();
  // sum a stage's base products apart (registers allowing, up to NTA = 2),
  // else each k8 step's
  constexpr bool kStageSum = NTA <= 2;
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int r8 = (r + 7) & ~7;
  // the cluster's gridDim.z blocks split the K steps: this block takes
  // [t_lo, t_lo + nk)
  const int nsplit = gridDim.z, part = blockIdx.z;
  const int nk_all = (K + BK - 1) / BK;
  const int t_lo = (int)((long long)nk_all * part / nsplit);
  const int nk = (int)((long long)nk_all * (part + 1) / nsplit) - t_lo;
  const bool vx = (uintptr_t)x % 16 == 0 && K % (16 / sizeof(TX)) == 0;
  const bool vw = (uintptr_t)w % 16 == 0 && N % (16 / sizeof(TX)) == 0;
  const bool va = (uintptr_t)a % 16 == 0 && K % (16 / sizeof(TA)) == 0;
  // x @ A^T: the ncx column tiles of a cluster (the same rows) share it.
  // Its n8 tiles come in groups of 4, one a warp; block cx owns the groups
  // cx, cx + ncx, ..., and its warp w sums tile xa_tile(u) in xacc[u]
  const int nxt = r8 / 8;
  const int ncx = cluster_dim_x(), cx = blockIdx.x % ncx;
  auto xa_tile = [&](int u) -> int { return 4 * (cx + ncx * u) + warp; };
  auto load_stage = [&](int t) {
    uint8_t* st = smem + (t % kStages) * SB;
    const int k0 = (t_lo + t) * BK;
    load_tile<TX, BK, XS>(reinterpret_cast<TX*>(st), x + (size_t)m0 * K + k0,
                          K, BM, M - m0, K - k0, vx);
    load_tile<TX, BN, WS>(reinterpret_cast<TX*>(st + XB),
                          w + (size_t)k0 * N + n0, N, BK, K - k0, N - n0, vw);
    load_tile<TA, BK, AS>(reinterpret_cast<TA*>(st + XB + WB), a + k0, K, r8,
                          r, K - k0, va);
  };

  float acc[4][kMI][4];      // [n8 tile][m16 tile][fragment]
  float xacc[NTA][kMI][4];   // x @ A^T: [u][m16 tile], tile xa_tile(u)
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][i][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NTA; ++j) xacc[j][i][e] = 0.f;
    }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_wait<kStages - 2>();
    __syncthreads();   // stage t landed; stage t - 1 is free for t + 2
    if (t + kStages - 1 < nk) load_stage(t + kStages - 1);
    cp_commit();
    const uint8_t* st = smem + (t % kStages) * SB;
    const TX* xs = reinterpret_cast<const TX*>(st);
    const TX* ws = reinterpret_cast<const TX*>(st + XB);
    const TA* as = reinterpret_cast<const TA*>(st + XB + WB);
    float ts[kStageSum ? 4 : 1][kMI][4];   // this stage's base products
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t xb[kMI][4], xsm[kMI][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        const TX* p = xs + (mi * 16 + g) * XS + kk + tq;
        split<SX>(to_f32(p[0]), xb[mi][0], xsm[mi][0]);
        split<SX>(to_f32(p[8 * XS]), xb[mi][1], xsm[mi][1]);
        split<SX>(to_f32(p[4]), xb[mi][2], xsm[mi][2]);
        split<SX>(to_f32(p[8 * XS + 4]), xb[mi][3], xsm[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const TX* p = ws + (kk + tq) * WS + warp * 32 + ni * 8 + g;
        uint32_t bb[2], bs[2];
        split<SX>(to_f32(p[0]), bb[0], bs[0]);
        split<SX>(to_f32(p[4 * WS]), bb[1], bs[1]);
        if constexpr (kStageSum)
          mma3_into<SX, SX>(ts[ni], xb, xsm, bb, bs, kk == 0);
        else
          mma3<SX, SX>(acc[ni], xb, xsm, bb, bs);
      }
#pragma unroll
      for (int u = 0; u < NTA; ++u) {
        const int jt = xa_tile(u);            // the same in the whole warp
        if (jt >= nxt) continue;
        const TA* p = as + (jt * 8 + g) * AS + kk + tq;
        uint32_t bb[2], bs[2];
        split<SA>(to_f32(p[0]), bb[0], bs[0]);
        split<SA>(to_f32(p[4]), bb[1], bs[1]);
        mma3<SX, SA>(xacc[u], xb, xsm, bb, bs);
      }
    }
    if constexpr (kStageSum) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][i][e] += ts[j][i][e];
    }
  }
  cp_wait<0>();
  __syncthreads();   // every stage is read: the epilogue reuses the memory

  // scale * (x @ A^T) [BM][r8] and the B tile [128][r8] as f32, rows padded
  // to r8 + 4 (a multiple of 4 that is not one of 8: conflict-free reads)
  const int RS = r8 + 4;
  float* xe = reinterpret_cast<float*>(smem);
  float* be = xe + BM * RS;
  auto store_xa = [&]() {
#pragma unroll
    for (int u = 0; u < NTA; ++u) {
      const int jt = xa_tile(u);
      if (jt >= nxt) continue;
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        float* p = xe + (mi * 16 + g) * RS + jt * 8 + 2 * tq;
        p[0] = scale * xacc[u][mi][0];
        p[1] = scale * xacc[u][mi][1];
        p[8 * RS] = scale * xacc[u][mi][2];
        p[8 * RS + 1] = scale * xacc[u][mi][3];
      }
    }
  };

  if (nsplit * ncx == 1) {
    store_xa();
  } else {
    // 1. the blocks with part > 0 leave their partial sums in their shared
    //    memory, and block (cx, part 0) adds them in part order;
    // 2. each part-0 block stores the x @ A^T tiles it owns and copies the
    //    others' from its column neighbours; the part > 0 blocks then exit
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const dim3 bi = cluster.block_index();
    auto rank = [&](int bx, int bz) -> unsigned {
      return bx + ncx * bz;   // the cluster is ncx x 1 x nsplit
    };
    float* part_sums = reinterpret_cast<float*>(smem);
    auto at = [&](int q) -> int { return q * kThreads + threadIdx.x; };
    if (part > 0) {
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            part_sums[at((j * kMI + i) * 4 + e)] = acc[j][i][e];
#pragma unroll
          for (int j = 0; j < NTA; ++j)
            part_sums[at((4 + j) * kMI * 4 + i * 4 + e)] = xacc[j][i][e];
        }
    }
    if (nsplit > 1) cluster.sync();
    if (part == 0) {
      for (int q = 1; q < nsplit; ++q) {
        const float* rp = cluster.map_shared_rank(part_sums, rank(bi.x, q));
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[j][i][e] += rp[at((j * kMI + i) * 4 + e)];
#pragma unroll
            for (int j = 0; j < NTA; ++j)
              xacc[j][i][e] += rp[at((4 + j) * kMI * 4 + i * 4 + e)];
          }
      }
    }
    if (nsplit > 1) cluster.sync();   // the partial sums are read
    if (part == 0) store_xa();
    if (ncx > 1) cluster.sync();      // every owned tile is stored
    if (part == 0 && ncx > 1) {
      for (int c = 0; c < ncx; ++c) {
        if (c == (int)bi.x) continue;
        const float* rx = cluster.map_shared_rank(xe, rank(c, 0));
        for (int j0 = 32 * c; j0 < r8; j0 += 32 * ncx) {
          const int cols = min(32, r8 - j0);   // group c's columns
          for (int e = threadIdx.x; e < BM * cols; e += kThreads) {
            const int i = e / cols, j = j0 + e % cols;
            xe[i * RS + j] = rx[i * RS + j];
          }
        }
      }
    }
    if (ncx > 1) cluster.sync();  // the tiles are copied: blocks may exit
    if (part > 0) return;
  }
  for (int e = threadIdx.x; e < BN * r8; e += kThreads) {
    const int n = e / r8, j = e % r8;
    be[n * RS + j] = (n0 + n < N && j < r)
                         ? to_f32(b[(size_t)(n0 + n) * r + j]) : 0.f;
  }
  __syncthreads();

  for (int kk = 0; kk < r8; kk += 8) {
    uint32_t xb[kMI][4], xsm[kMI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const float* p = xe + (mi * 16 + g) * RS + kk + tq;
      split<true>(p[0], xb[mi][0], xsm[mi][0]);
      split<true>(p[8 * RS], xb[mi][1], xsm[mi][1]);
      split<true>(p[4], xb[mi][2], xsm[mi][2]);
      split<true>(p[8 * RS + 4], xb[mi][3], xsm[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const float* p = be + (warp * 32 + ni * 8 + g) * RS + kk + tq;
      uint32_t bb[2], bs[2];
      split<SA>(p[0], bb[0], bs[0]);
      split<SA>(p[4], bb[1], bs[1]);
      mma3<true, SA>(acc[ni], xb, xsm, bb, bs);
    }
  }

#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + warp * 32 + ni * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mi * 16 + g + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < N)
            y[(size_t)row * N + col + e] =
                from_f32<TX>(acc[ni][mi][2 * h + e]);
      }
    }
}

size_t max_size(size_t p, size_t q) { return p > q ? p : q; }

// blocks of a cluster that split K: doubled while the grid fills less than
// one block a SM and each block keeps at least two stages of K
int k_split(int tiles, int K) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      sms = 1;
  }
  const int nk = (K + BK - 1) / BK;
  int split = 1;
  while (split < kMaxSplit && tiles * split < sms && nk >= 4 * split)
    split *= 2;
  return split;
}

// column tiles of a cluster that share x @ A^T: with two or more groups of
// 4 n8 tiles (r > 32), the fewest that divide the column tiles and leave
// each block one group at most, if they fit beside the split; else 1.  The
// blocks of a cluster wait on each other, so sharing pays only where it
// lowers the most any block sums (a cluster with one group would wait on
// its owner)
int x_share(int tiles_n, int split, int r) {
  const int groups = (r + 31) / 32;
  if (groups < 2) return 1;
  for (int d = groups; d * split <= kMaxCluster; ++d)
    if (tiles_n % d == 0) return d;
  return 1;
}

template <typename TX, typename TA, int NTA>
cudaError_t launch_n(const void* x, const void* w, const void* a,
                     const void* b, void* y, int M, int K, int N, int r,
                     float scale, cudaStream_t stream) {
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + BM - 1) / BM;
  const int split = k_split(tiles_n * tiles_m, K);
  const int share = x_share(tiles_n, split, r);
  size_t smem = max_size(kStages * stage_bytes<TX, TA, NTA>(),
                         (size_t)(BM + BN) * (((r + 7) & ~7) + 4)
                             * sizeof(float));
  if (split > 1)
    smem = max_size(smem, (size_t)(4 + NTA) * kMI * 4 * kThreads
                              * sizeof(float));
  auto kern = lora_tf32x3_kernel<TX, TA, NTA>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_n, tiles_m, split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = share;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const TX*>(x),
                            static_cast<const TX*>(w),
                            static_cast<const TA*>(a),
                            static_cast<const TA*>(b), static_cast<TX*>(y), M,
                            K, N, r, scale);
}

template <typename TX, typename TA>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   void* y, int M, int K, int N, int r, float scale,
                   cudaStream_t stream) {
  if (r <= 32)
    return launch_n<TX, TA, 1>(x, w, a, b, y, M, K, N, r, scale, stream);
  if (r <= 64)
    return launch_n<TX, TA, 2>(x, w, a, b, y, M, K, N, r, scale, stream);
  return launch_n<TX, TA, 4>(x, w, a, b, y, M, K, N, r, scale, stream);
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
