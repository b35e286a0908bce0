// Flash attention (forward) for Hopper, sm_90a, on the tensor cores in
// 3xTF32: online softmax over key tiles, with an optional causal mask and
// sliding window.  The "tf32x3" route of repro_torch.kernels.flash
// (flash_route): f32, and bf16 whose strides or bases TMA refuses (head
// widths that are not multiples of 8, views at an odd element offset).
// bf16 that TMA takes goes to flash_attention_wgmma.cu.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py).  Like it, the [Sq, Sk] score block
// never goes to device memory: each block keeps a running max m, normaliser
// l and f32 output accumulator for its query rows while it walks the key
// tiles, and writes its output once.  Where the Pallas kernel walked the key
// tiles as the innermost (sequential) grid axis, each block here loops over
// them itself.  What differs from the Pallas kernel and its wrapper:
//
//  * layout: q [B, Sq, H, d], k [B, Sk, KV, d], v [B, Sk, KV, dv] and the
//    output [B, Sq, H, dv] as the ops wrapper takes them; query head h reads
//    key/value head h / (H / KV) (grouped-query attention) where the wrapper
//    repeated K and V over the heads;
//  * keys at positions >= Sk are masked here: the Pallas wrapper padded Sk to
//    its tile and left the padded keys unmasked for non-causal queries;
//  * key tiles that the mask hides from every query of the block (beyond the
//    causal diagonal, or before the window) are skipped, and a warp skips
//    the tiles it hides from all of its 16 rows;
//  * a masked pair contributes exactly 0 (its score is -inf) and never enters
//    the running max, so a row whose first tiles are all masked carries
//    nothing into the result.  A row with no valid key at all (with a
//    window, query positions >= Sk + window - 1) averages every value, as
//    the plain version's softmax over scores that are all -1e30 does: a
//    second walk over the keys, taken only by blocks with such rows.
//
// Scores are (q . k) / sqrt(d), kept as (q . k) * log2(e) / sqrt(d) for
// exp2; q, k and v share one type (f32 or bf16), every sum is f32, and the
// output is cast once after dividing by max(l, 1e-30).  d <= 256 and
// dv <= 256 cover every head width of the repository's configurations (32,
// 64, 128, 256, and 192/128).
//
// Arithmetic (as lora_matmul.cu's): TF32 keeps 10 mantissa bits, too few
// for the f32 limit of 1e-4, so every f32 operand is split into big =
// tf32(v) and small = v - big (hopper.cuh), and each product a . b runs as
// a_small . b_big + a_big . b_small + a_big . b_big on
// mma.sync.m16n8k8.tf32 with f32 sums.  The tensor core rounds its sums
// toward zero, so no sum stays in it for long: S = Q.K^T starts from zero
// each key tile and is summed in it over at most 128 of the depth (wider
// heads add their parts in f32), and P.V starts from zero each key tile,
// its 64 (or 32) keys summed in it before O = O * corr + P.V in f32.  The
// probabilities stay f32 (split, not rounded to bf16).  A bf16 value is a
// TF32 value, so its small part is 0 and those products are not issued
// (templated on the type): bf16 Q.K^T takes one mma, P.V two.
//
// Design: FlashAttention-2's layout.  A block of 4 warps (8 for value
// widths above 128) owns 64 (128) query rows of one (batch, head), 16 rows
// to a warp; the grid is (query tiles, H, B), its query tiles walked from
// the last (with the causal mask, the longest) to the first.  The block
// stages its Q tile once, then K and V tiles of BK keys (64 at dv <= 64,
// else 32) through cp.async rings of two stages, both issued a tile ahead.
// Where two stages do not fit in shared memory (f32 at d = dv = 256, whose
// Q tile of 128 rows takes 135 KB), K and V each have one stage and their
// own commit groups: K of the next tile lands while this tile's softmax and
// P.V run, V while its Q.K^T runs.  Copies are 16 bytes where the base and
// the head width allow, 4 bytes of f32 otherwise, plain loads of bf16 at an
// odd element offset; zeros pad the head width to a multiple of 8, the
// value width to whole P.V groups and the keys past Sk.  The row strides
// are padded so that every fragment read is free of bank conflicts: the k8
// steps of Q.K^T read their depth in the permuted order (2t, 2t + 1) for
// the logical (t, t + 4), one 8-byte (f32) or 4-byte (bf16) read a pair.
// The online softmax runs on the score accumulator (a row in the 4 lanes
// of a quad: two shuffles for its max), and the accumulator is P.V's A
// operand as it stands: for each 8-key step, V's rows are read in the order
// that maps the C fragment's columns (2t, 2t + 1) to the A fragment's (t,
// t + 4).  Only the tiles that need it are masked.  P.V runs over groups of
// 8 n8 tiles of the value width, each summed apart and added to O; a group
// reads its V columns with no guard, so the loads of a step issue
// together.
//
// Instances: one per type and value-width bucket (dv <= 32, 64, 128, 256);
// the depth d is a runtime bound.  chip_smoke.py reports each instance's
// registers and spills (ptxas) and counts its TF32 HMMA instructions.
//
// Bound on the H100: 2 (d + dv) operations per valid (query, key) pair and
// head against the bytes of q, k, v and the output; at prefill lengths the
// operations bound it.  3xTF32 runs three tensor-core products for each f32
// one, so f32 work is bounded at max(the f32 CUDA-core peak, the TF32 peak
// / 3); mma.sync reaches less of the TF32 peak than wgmma (chip_smoke.py's
// probe), and wgmma.tf32 would need V in K-major order (V is N-major).

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kDepthChunk = 128;     // S's depth summed in the tensor core
constexpr int kGroup = 8;            // n8 tiles of P.V summed apart
constexpr float kNegInf = -1e30f;    // the running max before any key
constexpr uint32_t kOne = 0x3F800000u;
constexpr size_t kSmemLimit = 232448;

// warps of a block (16 query rows each) and keys per tile of the instance
// for value widths up to 8 nv: the widest heads share each K and V tile
// between 8 warps, where 4 would leave one warp to each SM sub-partition
__host__ __device__ constexpr int warps_of(int nv) { return nv > 16 ? 8 : 4; }
__host__ __device__ constexpr int key_tile(int nv) { return nv <= 8 ? 64 : 32; }
// row stride (elements) of a staged tile of w8 columns read as element
// pairs (Q and K, and bf16 V): 8 or 24 (mod 32), so that the pair reads of
// a fragment hit distinct banks, and rows stay 16-byte aligned
__host__ __device__ constexpr int pair_stride(int w8) {
  return w8 + 8 + (w8 & 8);
}
// row stride of an f32 V tile, read one element at a time down two rows:
// 4 (mod 8)
template <typename T>
__host__ __device__ constexpr int v_stride(int w8) {
  return sizeof(T) == 4 ? w8 + 4 : pair_stride(w8);
}
// n8 tiles of P.V summed apart in one pass, for value widths up to 8 nv
__host__ __device__ constexpr int pv_group(int nv) {
  return nv < kGroup ? nv : kGroup;
}
// the staged value width: dv padded with zeros to whole groups, so that a
// pass reads no column past the tile
__host__ __device__ constexpr int v_width(int dv, int nv) {
  return (dv + 8 * pv_group(nv) - 1) / (8 * pv_group(nv)) * 8 * pv_group(nv);
}

// 2^x, flushing results below 2^-126 to 0 (x <= 0 here: probabilities and
// rescale factors, where such a value is far below the f32 limit)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (p[0], p[1]) as f32
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xFFFF0000u));
}

// one copy of load_rows: `per` elements at row i, column c
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, int ds, const T* src,
                                           size_t ld, int i, int c, bool ok,
                                           bool vec) {
  T* dp = dst + i * ds + c;
  if (vec) {
    if (ok) cp_async16(dp, src + i * ld + c);
    else *reinterpret_cast<uint4*>(dp) = make_uint4(0u, 0u, 0u, 0u);
  } else if constexpr (sizeof(T) == 4) {
    if (ok) cp_async4(dp, src + i * ld + c);
    else *dp = 0.f;
  } else {
    *dp = ok ? src[i * ld + c] : from_f32<T>(0.f);
  }
}

// how the threads copy tiles of w8 columns, w of them in bounds: `per`
// elements a copy (16 bytes where vec: the base and every row start
// 16-byte aligned, w a multiple of 16 bytes; else one element), cpr copies
// a row, walked row-major: this thread's first copy is copy j0 of row i0,
// and its next is di rows and dj copies on.  Worked out once a kernel,
// where each tile would divide by cpr again.
struct Walk {
  int i0, j0, di, dj, cpr, per, w;
  bool vec;
};

template <int NTHR, typename T>
__device__ __forceinline__ Walk make_walk(int w, int w8, bool vec) {
  Walk k;
  k.per = vec ? (int)(16 / sizeof(T)) : 1;
  k.cpr = w8 / k.per;
  k.di = NTHR / k.cpr;
  k.dj = NTHR % k.cpr;
  k.i0 = threadIdx.x / k.cpr;
  k.j0 = threadIdx.x % k.cpr;
  k.w = w;
  k.vec = vec;
  return k;
}

// rows [0, rows) of a head slice into shared memory (row stride ds): row i
// from src + i * ld; rows from rows_ok on and columns from wk.w on are
// zero; 16-byte copies where wk.vec, else 4-byte copies of f32 or plain
// loads of bf16
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ds, const T* src,
                                          size_t ld, int rows, int rows_ok,
                                          const Walk& wk) {
  int i = wk.i0, j = wk.j0;
  if (wk.dj == 0) {   // a thread keeps its column
    const int c = j * wk.per;
    for (; i < rows; i += wk.di)
      copy_chunk(dst, ds, src, ld, i, c, i < rows_ok && c < wk.w, wk.vec);
    return;
  }
  while (i < rows) {
    const int c = j * wk.per;
    copy_chunk(dst, ds, src, ld, i, c, i < rows_ok && c < wk.w, wk.vec);
    i += wk.di;
    j += wk.dj;
    if (j >= wk.cpr) {
      j -= wk.cpr;
      ++i;
    }
  }
}

// key tile `it` (keys from k_lo + it * BK) of K or V into its stage of a
// ring (row stride `stride`)
template <int BK, typename T>
__device__ __forceinline__ void load_key_tile(T* ring, int stride, int stages,
                                              const T* src, size_t ld,
                                              int k_lo, int Sk, int it,
                                              const Walk& wk) {
  const int k0 = k_lo + it * BK;
  load_rows(ring + (it % stages) * BK * stride, stride, src + (size_t)k0 * ld,
            ld, BK, Sk - k0, wk);
}

// s (+)= Q . K^T over the k8 step at depth kk in 3xTF32, for the warp's 16
// rows (qa: Q's row g at column 2t) and the tile's NT n8 key tiles (kr: K's
// row g at column 2t); the step reads its depth in the order (2t, 2t + 1)
// for the logical (t, t + 4), the same in both operands.  ZERO: s starts
// from zero here.
template <typename T, int NT, bool ZERO>
__device__ __forceinline__ void qk_step(float (&s)[NT][4], const T* qa,
                                        const T* kr, int ds, int kk) {
  constexpr bool SP = sizeof(T) == 4;
  const float2 alo = ld_pair(qa + kk), ahi = ld_pair(qa + 8 * ds + kk);
  uint32_t ab[4], as[4];
  split<SP>(alo.x, ab[0], as[0]);
  split<SP>(ahi.x, ab[1], as[1]);
  split<SP>(alo.y, ab[2], as[2]);
  split<SP>(ahi.y, ab[3], as[3]);
  uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b = ld_pair(kr + 8 * j * ds + kk);
    split<SP>(b.x, bb[j][0], bs[j][0]);
    split<SP>(b.y, bb[j][1], bs[j][1]);
  }
  if constexpr (SP) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (ZERO) mma_tf32_z(s[j], as, bb[j][0], bb[j][1]);
      else mma_tf32(s[j], as, bb[j][0], bb[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(s[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(s[j], ab, bb[j][0], bb[j][1]);
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (ZERO) mma_tf32_z(s[j], ab, bb[j][0], bb[j][1]);
      else mma_tf32(s[j], ab, bb[j][0], bb[j][1]);
    }
  }
}

// s = Q . K^T over the depth [c0, c1), summed in the tensor core from zero
template <typename T, int NT>
__device__ __forceinline__ void qk(float (&s)[NT][4], const T* qa,
                                   const T* kr, int ds, int c0, int c1) {
  qk_step<T, NT, true>(s, qa, kr, ds, c0);
  // two steps at a time where a step has few products (NT = 4: the next
  // step's loads then overlap this one's); wider tiles need the registers
#pragma unroll (NT <= 4 ? 2 : 1)
  for (int kk = c0 + 8; kk < c1; kk += 8)
    qk_step<T, NT, false>(s, qa, kr, ds, kk);
}

// O = O * corr + P . V over one staged tile of 8 NT keys (vr: V's row 2t
// at column g; dvw: the staged width, whole groups).  P's A fragment of
// 8-key step j is the score accumulator s[j] as it stands, split: its
// columns (2t, 2t + 1) are the logical (t, t + 4), so V's rows are read in
// that order.  KEYLESS: P is p0 on the row g and p1 on the row g + 8 (1 or
// 0) instead.  The value columns go in groups of G n8 tiles, each summed
// in the tensor core from zero over the tile's keys and added to O in f32.
template <typename T, int NV, int NT, bool KEYLESS>
__device__ __forceinline__ void pv(float (&acc)[NV][4],
                                   const float (&s)[NT][4], uint32_t p0,
                                   uint32_t p1, const T* vr, int vs_stride,
                                   int dvw, float corr0, float corr1) {
  constexpr bool SP = sizeof(T) == 4;
  constexpr int G = pv_group(NV);
#pragma unroll
  for (int n0 = 0; n0 < NV; n0 += G) {
    if (8 * n0 >= dvw) break;
    float u[G][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ab[4], as[4];
      if constexpr (KEYLESS) {
        ab[0] = ab[2] = p0;
        ab[1] = ab[3] = p1;
        as[0] = as[1] = as[2] = as[3] = 0u;
      } else {
        split<true>(s[j][0], ab[0], as[0]);
        split<true>(s[j][2], ab[1], as[1]);
        split<true>(s[j][1], ab[2], as[2]);
        split<true>(s[j][3], ab[3], as[3]);
      }
      const T* pb = vr + 8 * j * vs_stride + 8 * n0;
      uint32_t bb[G][2], bs[G][2];
#pragma unroll
      for (int n = 0; n < G; ++n) {
        split<SP>(to_f32(pb[8 * n]), bb[n][0], bs[n][0]);
        split<SP>(to_f32(pb[8 * n + vs_stride]), bb[n][1], bs[n][1]);
      }
      // the pass's sums start from zero at its first step
#pragma unroll
      for (int n = 0; n < G; ++n) {
        if (j == 0) mma_tf32_z(u[n], as, bb[n][0], bb[n][1]);
        else mma_tf32(u[n], as, bb[n][0], bb[n][1]);
      }
      if constexpr (SP) {
#pragma unroll
        for (int n = 0; n < G; ++n) mma_tf32(u[n], ab, bs[n][0], bs[n][1]);
      }
#pragma unroll
      for (int n = 0; n < G; ++n) mma_tf32(u[n], ab, bb[n][0], bb[n][1]);
    }
#pragma unroll
    for (int n = 0; n < G; ++n) {
      acc[n0 + n][0] = fmaf(acc[n0 + n][0], corr0, u[n][0]);
      acc[n0 + n][1] = fmaf(acc[n0 + n][1], corr0, u[n][1]);
      acc[n0 + n][2] = fmaf(acc[n0 + n][2], corr1, u[n][2]);
      acc[n0 + n][3] = fmaf(acc[n0 + n][3], corr1, u[n][3]);
    }
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(32 * warps_of(NV))
flash_tf32x3_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int Sq,
                    int Sk, int H, int KV, int d, int dv, int causal,
                    int window, float scale_log2, int stages) {
  constexpr int NTHR = 32 * warps_of(NV), BQ = 16 * warps_of(NV);
  constexpr int BK = key_tile(NV), NT = BK / 8;
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (H / KV);
  const int d8 = (d + 7) & ~7, dvw = v_width(dv, NV);
  const int DS = pair_stride(d8), VS = v_stride<T>(dvw);
  T* qs = reinterpret_cast<T*>(smem);   // [BQ][DS]
  T* kring = qs + BQ * DS;              // stages of K [BK][DS]
  T* vring = kring + stages * BK * DS;  // stages of V [BK][VS]

  const size_t q_row = (size_t)H * d, o_row = (size_t)H * dv;
  const size_t k_row = (size_t)KV * d, v_row = (size_t)KV * dv;
  const T* qb = q + (size_t)bi * Sq * q_row + (size_t)h * d;
  const T* kb = k + (size_t)bi * Sk * k_row + (size_t)kvh * d;
  const T* vb = v + (size_t)bi * Sk * v_row + (size_t)kvh * dv;
  T* ob = o + (size_t)bi * Sq * o_row + (size_t)h * dv;
  constexpr int VE = 16 / sizeof(T);
  const bool vq = (uintptr_t)q % 16 == 0 && d % VE == 0;
  const bool vk = (uintptr_t)k % 16 == 0 && d % VE == 0;
  const bool vv = (uintptr_t)v % 16 == 0 && dv % VE == 0;

  // the keys any query of this block may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;
  // this warp's rows: wr0 + g (fragment elements 0, 1) and wr0 + g + 8 (2, 3)
  const int wr0 = q0 + 16 * warp, wr1 = wr0 + 15;
  const T* qa = qs + (16 * warp + g) * DS + 2 * t;

  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // K and V of tile it go to stage it % stages of their own rings.  With
  // two stages, both are waited for at the top of tile it, and both of tile
  // it + 1 are issued then, to land while tile it runs.  With one (the
  // widest heads in f32), K and V are commit groups of their own in the
  // order K0 V0 K1 V1 ...: K of the next tile lands while this tile's
  // softmax and P.V run, V while its Q.K^T runs
  const Walk kwalk = make_walk<NTHR, T>(d, d8, vk);
  const Walk vwalk = make_walk<NTHR, T>(dv, dvw, vv);
  load_rows(qs, DS, qb + (size_t)q0 * q_row, q_row, BQ, Sq - q0,
            make_walk<NTHR, T>(d, d8, vq));
  if (n_tiles > 0)
    load_key_tile<BK>(kring, DS, stages, kb, k_row, k_lo, Sk, 0, kwalk);
  cp_commit();
  if (n_tiles > 0)
    load_key_tile<BK>(vring, VS, stages, vb, v_row, k_lo, Sk, 0, vwalk);
  cp_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * BK;
    const bool next = it + 1 < n_tiles;
    // tiles that hide every key from this warp's rows are skipped, and only
    // tiles that hide some pair are masked
    const bool empty = wr0 >= Sq || (causal && k0 > wr1)
                       || (window > 0 && wr0 - (k0 + BK - 1) >= window);
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > wr0)
                        || (window > 0 && wr1 - k0 >= window);
    if (stages == 2) cp_wait<0>();   // K and V of tile it landed
    else cp_wait<1>();               // K of tile it landed
    __syncthreads();   // ... for every thread; the other stages' reads are
                       // done
    if (stages == 2 && next) {
      load_key_tile<BK>(kring, DS, stages, kb, k_row, k_lo, Sk, it + 1, kwalk);
      load_key_tile<BK>(vring, VS, stages, vb, v_row, k_lo, Sk, it + 1, vwalk);
    }
    const T* ks = kring + (it % stages) * BK * DS;
    float s[NT][4];
    if (!empty) {
      const T* kr = ks + g * DS + 2 * t;
      qk<T, NT>(s, qa, kr, DS, 0, min(d8, kDepthChunk));
      for (int c0 = kDepthChunk; c0 < d8; c0 += kDepthChunk) {
        float u[NT][4];
        qk<T, NT>(u, qa, kr, DS, c0, min(d8, c0 + kDepthChunk));
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += u[j][e];
      }
    }
    if (stages == 1 && next) {
      __syncthreads();   // every warp is done with the one K stage
      load_key_tile<BK>(kring, DS, stages, kb, k_row, k_lo, Sk, it + 1, kwalk);
    }
    cp_commit();
    float corr0 = 1.f, corr1 = 1.f;
    if (!empty) {
      if (masked) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * j + 2 * t + (e & 1);
            const int qi = wr0 + g + 8 * (e >> 1);
            const bool ok = kj < Sk && (!causal || qi >= kj)
                            && (window <= 0 || qi - kj < window);
            if (!ok) s[j][e] = -INFINITY;
          }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      corr0 = exp2_ftz(m0 - mn0);
      corr1 = exp2_ftz(m1 - mn1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2_ftz(fmaf(s[j][0], scale_log2, -mn0));
        s[j][1] = exp2_ftz(fmaf(s[j][1], scale_log2, -mn0));
        s[j][2] = exp2_ftz(fmaf(s[j][2], scale_log2, -mn1));
        s[j][3] = exp2_ftz(fmaf(s[j][3], scale_log2, -mn1));
        rs0 += s[j][0] + s[j][1];
        rs1 += s[j][2] + s[j][3];
      }
      // l stays this thread's part of the row sum until the end
      l0 = l0 * corr0 + rs0;
      l1 = l1 * corr1 + rs1;
      m0 = mn0;
      m1 = mn1;
    }
    if (stages == 1) {
      cp_wait<1>();      // V of tile it landed (K of tile it + 1 may not)
      __syncthreads();
    }
    if (!empty)
      pv<T, NV, NT, false>(acc, s, 0u, 0u,
                           vring + (it % stages) * BK * VS + 2 * t * VS + g,
                           VS, dvw, corr0, corr1);
    if (stages == 1 && next) {
      __syncthreads();   // every warp is done with the one V stage
      load_key_tile<BK>(vring, VS, stages, vb, v_row, k_lo, Sk, it + 1, vwalk);
    }
    cp_commit();
  }
  cp_wait<0>();

  l0 += __shfl_xor_sync(0xFFFFFFFFu, l0, 1);
  l0 += __shfl_xor_sync(0xFFFFFFFFu, l0, 2);
  l1 += __shfl_xor_sync(0xFFFFFFFFu, l1, 1);
  l1 += __shfl_xor_sync(0xFFFFFFFFu, l1, 2);
  // rows that saw no valid key (l is 0 only there: the largest valid score
  // of a row adds exp2(0) = 1) take the plain mean of all Sk values: P = 1
  // on their rows and 0 elsewhere, over every key
  const bool kl0 = wr0 + g < Sq && l0 == 0.f;
  const bool kl1 = wr0 + g + 8 < Sq && l1 == 0.f;
  if (__syncthreads_or(kl0 || kl1)) {
    const float none[NT][4] = {};
    for (int k0 = 0; k0 < Sk; k0 += BK) {
      __syncthreads();
      load_rows(vring, VS, vb + (size_t)k0 * v_row, v_row, BK, Sk - k0,
                vwalk);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      pv<T, NV, NT, true>(acc, none, kl0 ? kOne : 0u, kl1 ? kOne : 0u,
                          vring + 2 * t * VS + g, VS, dvw, 1.f, 1.f);
    }
    if (kl0) l0 = (float)Sk;
    if (kl1) l1 = (float)Sk;
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= dv) continue;
    const int r0 = wr0 + g, r1 = r0 + 8;
    if (r0 < Sq) {
      T* po = ob + (size_t)r0 * o_row + col;
      po[0] = from_f32<T>(acc[n][0] * inv0);
      if (col + 1 < dv) po[1] = from_f32<T>(acc[n][1] * inv0);
    }
    if (r1 < Sq) {
      T* po = ob + (size_t)r1 * o_row + col;
      po[0] = from_f32<T>(acc[n][2] * inv1);
      if (col + 1 < dv) po[1] = from_f32<T>(acc[n][3] * inv1);
    }
  }
}

template <typename T, int NV>
size_t smem_bytes(int d, int dv, int stages) {
  const int d8 = (d + 7) & ~7;
  return ((size_t)16 * warps_of(NV) * pair_stride(d8)
          + (size_t)stages * key_tile(NV)
                * (pair_stride(d8) + v_stride<T>(v_width(dv, NV))))
         * sizeof(T);
}

template <typename T, int NV>
cudaError_t launch_nv(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Sk, int H, int KV, int d, int dv,
                      int causal, int window, cudaStream_t stream) {
  // two stages where they fit, else one
  const int stages = smem_bytes<T, NV>(d, dv, 2) <= kSmemLimit ? 2 : 1;
  const size_t smem = smem_bytes<T, NV>(d, dv, stages);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kern = flash_tf32x3_kernel<T, NV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int bq = 16 * warps_of(NV);
  dim3 grid((Sq + bq - 1) / bq, H, B);
  kern<<<grid, 32 * warps_of(NV), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, d, dv,
      causal, window, (float)(1.4426950408889634 / sqrt((double)d)), stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KV, int d, int dv,
                   int causal, int window, cudaStream_t stream) {
  if (dv <= 32) return launch_nv<T, 4>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, stream);
  if (dv <= 64) return launch_nv<T, 8>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, stream);
  if (dv <= 128) return launch_nv<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, stream);
  return launch_nv<T, 32>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, stream);
}

}  // namespace

// C entry bound with ctypes.  is_bf16 selects bf16 (1) or f32 (0) for q, k,
// v and the output.  Returns the cudaError_t of the launch; shapes the kernel
// does not take are refused as cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KV, int d, int dv,
                                      int causal, int window, int is_bf16,
                                      void* stream) {
  if (B < 1 || Sq < 1 || Sk < 0 || H < 1 || KV < 1 || H % KV != 0 || d < 1
      || d > 256 || dv < 1 || dv > 256 || H > 65535 || B > 65535
      || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, s);
  return (int)launch<float>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, s);
}
