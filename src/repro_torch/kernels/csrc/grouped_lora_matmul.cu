// Multi-tenant LoRA projection (BGMV) for Hopper, sm_90a:
//
//     y[m] = x[m] @ W + scale * (x[m] @ A[g]^T) @ B[g]^T,    g = idx[m]
//
// Replaces the TPU kernel grouped_lora_matmul_pallas
// (src/repro/kernels/lora_gather_matmul.py).  Like it, the per-row adapter
// gather happens inside the kernels, so no per-row copy of A or B is ever
// written to device memory.  Where the Pallas kernel had the index
// scalar-prefetched to steer its DMA, each block reads idx itself.
//
// Shapes: x [M, K], W [K, N], A [G, r, K], B [G, N, r], idx int32 [M],
// y [M, N]; the wrapper's scratch xa [M, r] f32.  x, W and y share one type
// (f32 or bf16); A and B share one type (f32 or bf16).  Every product
// accumulates in f32.  Ragged M, K and N are masked (the Pallas wrapper
// padded them instead).  An out-of-range idx is clamped to [0, G), as a
// gather clamps.
//
// Two kernels behind the one C entry:
//
//  1. shrink: xa[m, :] = x[m] . A[g]^T, once per row (a warp per rank row,
//     lanes reading A along K in 16-byte vectors).  At the prefill shape a
//     block takes 8 rows; when they share an adapter, as the rows of one
//     request's prefill chunk do, each A vector is loaded once for all 8.
//  2. base and expand: a block owns BM rows x BN columns of y.  The x and W
//     tiles stream through shared memory by cp.async in 16-byte copies, in a
//     ring of stages, so W is read once per row tile (not once per row).
//     For bf16 x/W the base product runs on the tensor cores with
//     mma.sync.m16n8k16 (HMMA; ldmatrix feeds it): its 16 rows match the
//     16-slot decode step exactly, where wgmma's minimum of 64 rows would
//     waste three quarters of the unit.  For f32 x/W it stays on FMAs (TF32
//     keeps 10 mantissa bits).  The warps of a block split K, and their
//     partial tiles are summed in shared memory.  The epilogue adds
//     scale * sum_j xa[m, j] B[g, n, j] and stores y once: at decode a
//     thread per output reads its B row in 16-byte vectors; at prefill a
//     pass per distinct adapter of the row tile stages its B columns in
//     shared memory for all the rows that use it.
//
// The second kernel is launched as a programmatic dependent of the first
// (PDL): it streams its x and W tiles while the shrink finishes, and waits
// (griddepcontrol.wait) only before it reads xa.
//
// Tilings: decode (M <= 64): BM = BN = 16, 8 warps splitting K, 4 stages.
// At M = 16, K = N = 896 that is 56 blocks each streaming a 896 x 16 slice
// of W (32-byte rows, one DRAM sector each); 32 columns would leave only 28
// blocks to pull 1.6 MB, and ran slower on the card.  Prefill (M > 64):
// BM = BN = 64, 16 warps (4 row tiles x 4 K splits), 3 stages, so the f32
// tiles of r = 128 fit 227 KB; one block fills an SM, and with 4 warps and
// no split the kernel ran slower on the card (too few warps to hide the
// latency of the epilogue's loads).  Shapes whose rows are not
// 16-byte aligned (K or N not a multiple of 16 bytes' worth of elements)
// are staged by plain loads into the same tiles.
//
// Bound on the H100: 2MKN + 2Mr(K+N) operations against the bytes of W, x,
// y and the A/B of the distinct adapters in idx; at the serving shapes
// (K = 896, N in {896, 128}, M = 16 at decode and 512 at prefill) it is
// bound by memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr size_t kSmemLimit = 232448;
constexpr int kShrinkWarps = 8;
constexpr int kShrinkRows = 8;   // x rows a shrink block takes at prefill

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

__device__ __forceinline__ int clamp_idx(int g, int G) {
  return g < 0 ? 0 : (g >= G ? G - 1 : g);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; bytes past `src_bytes` are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- kernel 1: xa[m, j] = x[m] . A[g, j], rows [blockIdx.x * rb, +rb),
// ranks [blockIdx.y * 8, +8) (one warp each) ----
template <typename TX, typename TA>
__global__ void __launch_bounds__(kShrinkWarps * 32)
shrink_kernel(const TX* __restrict__ x, const TA* __restrict__ a,
              const int* __restrict__ idx, float* __restrict__ xa, int M,
              int K, int G, int r, int rb, int vec) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);   // [rb][K] x rows as f32
  // let the base-and-expand kernel launched after this one start now; it
  // waits for this grid's completion before it reads xa
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const int m_first = blockIdx.x * rb;
  const int rows = min(rb, M - m_first);
  for (int e = threadIdx.x; e < rows * K; e += blockDim.x)
    xs[e] = to_f32(x[(size_t)m_first * K + e]);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.y * kShrinkWarps + warp;
  if (j >= r) return;   // after the only barrier
  constexpr int V = 16 / sizeof(TA);
  // rows of one request's prefill chunk share an adapter: then each A
  // vector is loaded once for all the block's rows
  const int g0 = clamp_idx(idx[m_first], G);
  bool shared = vec && rows == kShrinkRows;
  for (int mm = 1; mm < rows; ++mm)
    shared = shared && clamp_idx(idx[m_first + mm], G) == g0;
  if (shared) {
    const TA* arow = a + ((size_t)g0 * r + j) * K;
    float s[kShrinkRows];
#pragma unroll
    for (int mm = 0; mm < kShrinkRows; ++mm) s[mm] = 0.f;
#pragma unroll 2
    for (int k = lane * V; k < K; k += 32 * V) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(arow + k));
      const TA* av = reinterpret_cast<const TA*>(&raw);
#pragma unroll
      for (int mm = 0; mm < kShrinkRows; ++mm)
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + (size_t)mm * K + k + e);
          s[mm] += xv.x * to_f32(av[e]) + xv.y * to_f32(av[e + 1])
                   + xv.z * to_f32(av[e + 2]) + xv.w * to_f32(av[e + 3]);
        }
    }
#pragma unroll
    for (int mm = 0; mm < kShrinkRows; ++mm) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[mm] += __shfl_xor_sync(0xffffffffu, s[mm], off);
      if (lane == 0) xa[(size_t)(m_first + mm) * r + j] = s[mm];
    }
    return;
  }
  for (int mm = 0; mm < rows; ++mm) {
    const int m = m_first + mm;
    const TA* arow = a + ((size_t)clamp_idx(idx[m], G) * r + j) * K;
    const float* xr = xs + (size_t)mm * K;
    float s = 0.f;
    if (vec) {   // K % V == 0 and A 16-byte aligned
#pragma unroll 4
      for (int k = lane * V; k < K; k += 32 * V) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(arow + k));
        const TA* av = reinterpret_cast<const TA*>(&raw);
#pragma unroll
        for (int e = 0; e < V; e += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + k + e);
          s += xv.x * to_f32(av[e]) + xv.y * to_f32(av[e + 1])
               + xv.z * to_f32(av[e + 2]) + xv.w * to_f32(av[e + 3]);
        }
      }
    } else {
      for (int k = lane; k < K; k += 32) s += xr[k] * to_f32(arow[k]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) xa[(size_t)m * r + j] = s;
  }
}

// ---- kernel 2: y tile = x tile . W tile + scale * xa . B[g]^T ----
template <typename TX, int BM, int BN, int KSPLIT, int BKS, int STAGES>
struct Tiling {
  static constexpr int kWarps = BM / 16 * KSPLIT;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int VE = 16 / sizeof(TX);   // elements per 16 bytes
  static constexpr int XP = BKS + VE;          // padded row pitches
  static constexpr int WP = BN + VE;
  static constexpr size_t kStageBytes = (size_t)(BM * XP + BKS * WP) * sizeof(TX);
  static size_t smem(int r) {
    return STAGES * kStageBytes + (size_t)KSPLIT * BM * BN * 4
           + (size_t)BM * r * 4 + (2 * BM + 1) * 4;
  }
};

template <typename TX, typename TA, int BM, int BN, int KSPLIT, int BKS,
          int STAGES>
__global__ void __launch_bounds__(
    Tiling<TX, BM, BN, KSPLIT, BKS, STAGES>::kThreads, 1)
base_expand_kernel(const TX* __restrict__ x, const TX* __restrict__ w,
                   const TA* __restrict__ b, const int* __restrict__ idx,
                   const float* __restrict__ xa, TX* __restrict__ y, int M,
                   int K, int N, int G, int r, float scale, int vec, int bvec) {
  using T = Tiling<TX, BM, BN, KSPLIT, BKS, STAGES>;
  constexpr bool kBf16 = std::is_same<TX, __nv_bfloat16>::value;
  constexpr int VE = T::VE, XP = T::XP, WP = T::WP;
  static_assert(BKS % (16 * KSPLIT) == 0 && BN % 16 == 0, "tiling");
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  float* red = reinterpret_cast<float*>(smem + STAGES * T::kStageBytes);
  float* xas = red + KSPLIT * BM * BN;           // [BM][r]
  int* gs = reinterpret_cast<int*>(xas + BM * r);  // [BM] each row's adapter
  int* glist = gs + BM;                 // [BM] the distinct ones, then count
  int* ng = glist + BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp % (BM / 16), kw = warp / (BM / 16);
  const int n0 = blockIdx.x * BN;
  const int mtiles = (M + BM - 1) / BM;
  const int ktiles = (K + BKS - 1) / BKS;

  for (int mt = blockIdx.y; mt < mtiles; mt += gridDim.y) {
    const int m0 = mt * BM;
    for (int e = tid; e < BM; e += T::kThreads)
      gs[e] = m0 + e < M ? clamp_idx(idx[m0 + e], G) : -1;
    auto load_stage = [&](int slot, int t) {
      TX* xs = reinterpret_cast<TX*>(smem + slot * T::kStageBytes);
      TX* ws = xs + BM * XP;
      const int k0 = t * BKS;
      if (vec) {   // K and N multiples of VE, x and W 16-byte aligned
        for (int e = tid; e < BM * (BKS / VE); e += T::kThreads) {
          const int row = e / (BKS / VE), c = e % (BKS / VE) * VE;
          const int gm = m0 + row, gk = k0 + c;
          const bool ok = gm < M && gk < K;
          cp_async16(smem_u32(xs + row * XP + c),
                     ok ? x + (size_t)gm * K + gk : x, ok ? 16 : 0);
        }
        for (int e = tid; e < BKS * (BN / VE); e += T::kThreads) {
          const int row = e / (BN / VE), c = e % (BN / VE) * VE;
          const int gk = k0 + row, gn = n0 + c;
          const bool ok = gk < K && gn < N;
          cp_async16(smem_u32(ws + row * WP + c),
                     ok ? w + (size_t)gk * N + gn : w, ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < BM * BKS; e += T::kThreads) {
          const int row = e / BKS, c = e % BKS;
          const int gm = m0 + row, gk = k0 + c;
          xs[row * XP + c] = gm < M && gk < K ? x[(size_t)gm * K + gk]
                                              : from_f32<TX>(0.f);
        }
        for (int e = tid; e < BKS * BN; e += T::kThreads) {
          const int row = e / BN, c = e % BN;
          const int gk = k0 + row, gn = n0 + c;
          ws[row * WP + c] = gk < K && gn < N ? w[(size_t)gk * N + gn]
                                              : from_f32<TX>(0.f);
        }
      }
    };

    // accumulators: bf16, n8 tile i holds (row lane/4 + 8 (q/2), column
    // 8i + 2 (lane%4) + q%2) in acc[i][q]; f32, lane owns rows
    // (lane / LN) * RPL + ri and columns lane % LN + LN ci, flattened
    // (ri CPL + ci) over acc
    constexpr int LN = BN < 32 ? BN : 32;
    constexpr int CPL = BN / LN, RPL = 16 * LN / 32;
    constexpr int NT = (kBf16 ? BN / 2 : RPL * CPL) / 4;
    float acc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

    __syncthreads();   // gs staged; the last row tile's smem is free
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < ktiles) load_stage(s, s);
      cp_async_commit();
    }
    for (int t = 0; t < ktiles; ++t) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      if (t + STAGES - 1 < ktiles)
        load_stage((t + STAGES - 1) % STAGES, t + STAGES - 1);
      cp_async_commit();
      const TX* xs = reinterpret_cast<const TX*>(
          smem + (t % STAGES) * T::kStageBytes);
      const TX* ws = xs + BM * XP;
      if constexpr (kBf16) {
        for (int ks = kw; ks < BKS / 16; ks += KSPLIT) {
          uint32_t af[4];
          ldsm_x4(smem_u32(xs + (rw * 16 + (lane & 15)) * XP + ks * 16
                           + (lane >> 4) * 8), af);
#pragma unroll
          for (int np = 0; np < BN / 16; ++np) {
            uint32_t bf[4];
            ldsm_x4_trans(smem_u32(ws + (ks * 16 + (lane & 15)) * WP
                                   + np * 16 + (lane >> 4) * 8), bf);
            mma_bf16(acc[2 * np], af, bf[0], bf[1]);
            mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
          }
        }
      } else {
        const int row_l = rw * 16 + (lane / LN) * RPL, col_l = lane % LN;
        for (int ks = kw; ks < BKS / 16; ks += KSPLIT) {
#pragma unroll 4
          for (int kk = 0; kk < 16; ++kk) {
            const int k = ks * 16 + kk;
            float wv[CPL];
#pragma unroll
            for (int ci = 0; ci < CPL; ++ci)
              wv[ci] = to_f32(ws[k * WP + col_l + LN * ci]);
#pragma unroll
            for (int ri = 0; ri < RPL; ++ri) {
              const float xv = to_f32(xs[(row_l + ri) * XP + k]);
#pragma unroll
              for (int ci = 0; ci < CPL; ++ci)
                acc[(ri * CPL + ci) / 4][(ri * CPL + ci) % 4] += xv * wv[ci];
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    // xa comes from the shrink kernel, launched just before this one as a
    // programmatic dependency: the base product above overlaps its tail,
    // and this waits for all of it (a no-op when launched plainly)
    asm volatile("griddepcontrol.wait;" ::: "memory");
    for (int e = tid; e < BM * r; e += T::kThreads)
      xas[e] = m0 + e / r < M ? xa[(size_t)m0 * r + e] : 0.f;

    // partial tiles to shared memory, summed over the K split below
    float* rp = red + kw * BM * BN;
    if constexpr (kBf16) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          rp[(rw * 16 + lane / 4 + 8 * (q >> 1)) * BN + 8 * i
             + 2 * (lane & 3) + (q & 1)] = acc[i][q];
    } else {
#pragma unroll
      for (int ri = 0; ri < RPL; ++ri)
#pragma unroll
        for (int ci = 0; ci < CPL; ++ci)
          rp[(rw * 16 + (lane / LN) * RPL + ri) * BN + lane % LN + LN * ci] =
              acc[(ri * CPL + ci) / 4][(ri * CPL + ci) % 4];
    }
    __syncthreads();

    // epilogue: base + scale * sum_j xa[m, j] B[g, n, j], stored once
    if constexpr (BM > 16) {
      // prefill: rows of one request's chunk share an adapter, so a pass
      // per distinct adapter of the tile stages its B[g] columns in shared
      // memory (over the now idle stage ring; pitch r + 1 keeps a warp's
      // 32 columns in 32 banks) and every row with that adapter reads them
      if (warp == 0) {
        int cnt = 0;
        for (int base = 0; base < BM; base += 32) {
          const int mr = base + lane;
          const int g = mr < BM ? gs[mr] : -1;
          bool first = g >= 0;
          for (int q = 0; q < mr && first; ++q) first = gs[q] != g;
          const unsigned bal = __ballot_sync(0xffffffffu, first);
          if (first) glist[cnt + __popc(bal & ((1u << lane) - 1))] = g;
          cnt += __popc(bal);
        }
        if (lane == 0) *ng = cnt;
      }
      float* bs = reinterpret_cast<float*>(smem);   // [BN][r + 1]
      const int rp = r + 1;
      __syncthreads();
      for (int pi = 0; pi < *ng; ++pi) {
        const int g = glist[pi];
        for (int e = tid; e < BN * r; e += T::kThreads) {
          const int nn = e / r, n = n0 + nn;
          bs[nn * rp + e % r] =
              n < N ? to_f32(b[((size_t)g * N + n) * r + e % r]) : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < BM * BN; e += T::kThreads) {
          const int mr = e / BN, nc = e % BN;
          const int m = m0 + mr, n = n0 + nc;
          if (gs[mr] != g || m >= M || n >= N) continue;
          float base = 0.f;
#pragma unroll
          for (int s = 0; s < KSPLIT; ++s) base += red[s * BM * BN + e];
          const float* xr = xas + mr * r;
          const float* br = bs + nc * rp;
          float d4[4] = {0.f, 0.f, 0.f, 0.f};   // 4 chains in flight
          int j = 0;
          for (; j + 4 <= r; j += 4)
#pragma unroll
            for (int q = 0; q < 4; ++q) d4[q] += xr[j + q] * br[j + q];
          for (; j < r; ++j) d4[0] += xr[j] * br[j];
          const float delta = (d4[0] + d4[1]) + (d4[2] + d4[3]);
          y[(size_t)m * N + n] = from_f32<TX>(base + scale * delta);
        }
        __syncthreads();   // before the next pass restages bs
      }
    } else {
      // decode: each row its own adapter, a thread per output reading its
      // B row in 16-byte vectors (a warp's rows are neighbours in memory)
      constexpr int BV = 16 / sizeof(TA);
      for (int e = tid; e < BM * BN; e += T::kThreads) {
        const int mr = e / BN, nc = e % BN;
        const int m = m0 + mr, n = n0 + nc;
        if (m >= M || n >= N) continue;
        float base = 0.f;
#pragma unroll
        for (int s = 0; s < KSPLIT; ++s) base += red[s * BM * BN + e];
        const TA* brow = b + ((size_t)gs[mr] * N + n) * r;
        const float* xr = xas + mr * r;
        float delta = 0.f;
        if (bvec) {   // r % BV == 0 and B 16-byte aligned
#pragma unroll 16
          for (int j = 0; j < r; j += BV) {
            const uint4 raw = __ldg(reinterpret_cast<const uint4*>(brow + j));
            const TA* bv = reinterpret_cast<const TA*>(&raw);
#pragma unroll
            for (int q = 0; q < BV; ++q) delta += xr[j + q] * to_f32(bv[q]);
          }
        } else {
          for (int j = 0; j < r; ++j) delta += xr[j] * to_f32(brow[j]);
        }
        y[(size_t)m * N + n] = from_f32<TX>(base + scale * delta);
      }
    }
    __syncthreads();   // before the next row tile reuses shared memory
  }
}

template <typename TX, typename TA, int BM, int BN, int KSPLIT, int BKS,
          int STAGES>
cudaError_t launch_base_expand(const void* x, const void* w, const void* b,
                               const void* idx, const float* xa, void* y,
                               int M, int K, int N, int G, int r, float scale,
                               int vec, int bvec, cudaStream_t stream) {
  using T = Tiling<TX, BM, BN, KSPLIT, BKS, STAGES>;
  const size_t smem = T::smem(r);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kern = base_expand_kernel<TX, TA, BM, BN, KSPLIT, BKS, STAGES>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int mtiles = (M + BM - 1) / BM;
  dim3 grid((N + BN - 1) / BN, mtiles < 65535 ? mtiles : 65535);
  // programmatic stream serialization: the kernel may start while the
  // shrink kernel before it runs, and waits for it before reading xa
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const TX*>(x), static_cast<const TX*>(w),
      static_cast<const TA*>(b), static_cast<const int*>(idx), xa,
      static_cast<TX*>(y), M, K, N, G, r, scale, vec, bvec);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TX, typename TA>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   const void* idx, float* xa, void* y, int M, int K, int N,
                   int G, int r, float scale, cudaStream_t stream) {
  // 1. shrink: one row a block at decode, 8 at prefill
  int rb = M <= 64 ? 1 : kShrinkRows;
  while (rb > 1 && (size_t)rb * K * 4 > kSmemLimit) rb /= 2;
  const size_t smem1 = (size_t)rb * K * 4;
  if (smem1 > kSmemLimit) return cudaErrorInvalidValue;
  auto shrink = shrink_kernel<TX, TA>;
  if (smem1 > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        shrink, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (e != cudaSuccess) return e;
  }
  const int avec = K % (16 / (int)sizeof(TA)) == 0 && aligned16(a);
  dim3 grid1((M + rb - 1) / rb, (r + kShrinkWarps - 1) / kShrinkWarps);
  shrink<<<grid1, kShrinkWarps * 32, smem1, stream>>>(
      static_cast<const TX*>(x), static_cast<const TA*>(a),
      static_cast<const int*>(idx), xa, M, K, G, r, rb, avec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // 2. base and expand
  const int ve = 16 / (int)sizeof(TX);
  const int vec = K % ve == 0 && N % ve == 0 && aligned16(x) && aligned16(w);
  const int bvec = r % (16 / (int)sizeof(TA)) == 0 && aligned16(b);
  if (M <= 64)
    return launch_base_expand<TX, TA, 16, 16, 8, 128, 4>(
        x, w, b, idx, xa, y, M, K, N, G, r, scale, vec, bvec, stream);
  return launch_base_expand<TX, TA, 64, 64, 4, 64, 3>(
      x, w, b, idx, xa, y, M, K, N, G, r, scale, vec, bvec, stream);
}

}  // namespace

// C entry bound with ctypes.  x_bf16 / ab_bf16 select bf16 (1) or f32 (0)
// for x/W/y and for A/B; xa is the caller's [M, r] f32 scratch.  Launches
// the two kernels on `stream` and returns the first cudaError_t.
extern "C" int grouped_lora_matmul_launch(const void* x, const void* w,
                                          const void* a, const void* b,
                                          const void* idx, void* xa, void* y,
                                          int M, int K, int N, int G, int r,
                                          float scale, int x_bf16, int ab_bf16,
                                          void* stream) {
  if (M < 1 || N < 1 || K < 0 || G < 1 || r < 1 || r > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* xaf = static_cast<float*>(xa);
  if (x_bf16 && ab_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, w, a, b, idx, xaf, y, M, K, N, G, r, scale, s);
  if (x_bf16)
    return (int)launch<__nv_bfloat16, float>(x, w, a, b, idx, xaf, y, M, K, N, G, r, scale, s);
  if (ab_bf16)
    return (int)launch<float, __nv_bfloat16>(x, w, a, b, idx, xaf, y, M, K, N, G, r, scale, s);
  return (int)launch<float, float>(x, w, a, b, idx, xaf, y, M, K, N, G, r, scale, s);
}
