// Flash attention (forward) for Hopper, sm_90a: online softmax over key
// tiles, with an optional causal mask and sliding window.
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
//    causal diagonal, or before the window) are skipped;
//  * a masked pair contributes exactly 0 and never enters the running max, so
//    a row whose first tiles are all masked carries nothing into the result
//    (exp(-1e30 - (-1e30)) = 1 never happens).  A row with no valid key at
//    all (with a window, query positions >= Sk + window - 1) averages every
//    value, as the plain version's softmax over scores that are all -1e30
//    does: a second walk over the keys, taken only by blocks with such rows.
//
// Scores are (q . k) / sqrt(d) in f32; q, k and v share one type (f32 or
// bf16), every sum is f32, and the output is cast once after dividing by
// max(l, 1e-30).  d <= 256 and dv <= 256 cover every head width of the
// repository's configurations (32, 64, 72, 128, 256, and 192/128).
//
// Design (simple and right first): a block of 256 threads owns 64 query rows
// of one (batch, head).  It stages its q tile in shared memory as f32 once,
// then for each 32-key tile stages k and v, and thread (ty, tx) computes the
// scores of rows ty*4 .. ty*4+3 against keys tx and tx + 16; the 16 threads
// of a row group (one half-warp) reduce the row max and row sum by shuffles.
// The probabilities go to shared memory and each thread accumulates its 4
// rows x (columns tx + 16 c) of P @ V in registers.
//
// Bound on the H100: 2 (d + dv) operations per valid (query, key) pair and
// head against the bytes of q, k, v and the output; at prefill lengths the
// operations bound it.  This kernel runs on the CUDA cores in f32, far from
// the bf16 tensor-core bound: a wgmma/TMA version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 32;          // keys per staged tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int TQ = 4;           // query rows per thread: ty * TQ + i
constexpr int TK = BK / 16;     // keys per thread: tx + 16 j
constexpr int PS = BK + 1;      // padded stride of the probability tile
constexpr float kNegInf = -1e30f;

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

// DT: value columns per thread (tx + 16 c), dv <= 16 DT
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Sk, int H, int KV, int d, int dv, int causal,
                       int window, float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;                 // padded row stride of q and k tiles
  float* qs = smem;                     // [BQ][dp]
  float* ks = qs + BQ * dp;             // [BK][dp]
  float* vs = ks + BK * dp;             // [BK][dv]
  float* ps = vs + BK * dv;             // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (H / KV);

  const size_t q_row = (size_t)H * d, o_row = (size_t)H * dv;
  const size_t k_row = (size_t)KV * d, v_row = (size_t)KV * dv;
  const T* qb = q + (size_t)bi * Sq * q_row + (size_t)h * d;
  const T* kb = k + (size_t)bi * Sk * k_row + (size_t)kvh * d;
  const T* vb = v + (size_t)bi * Sk * v_row + (size_t)kvh * dv;
  T* ob = o + (size_t)bi * Sq * o_row + (size_t)h * dv;

  for (int e = tid; e < BQ * d; e += kThreads) {
    const int i = e / d, c = e % d;
    const int qi = q0 + i;
    qs[i * dp + c] = qi < Sq ? to_f32(qb[(size_t)qi * q_row + c]) : 0.f;
  }

  // the keys any query of this block may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  float m[TQ], l[TQ], acc[TQ][DT];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();   // the last tile's reads are done (and q is staged)
    for (int e = tid; e < BK * d; e += kThreads) {
      const int j = e / d, c = e % d;
      const int kj = k0 + j;
      ks[j * dp + c] = kj < Sk ? to_f32(kb[(size_t)kj * k_row + c]) : 0.f;
    }
    for (int e = tid; e < BK * dv; e += kThreads) {
      const int j = e / dv, c = e % dv;
      const int kj = k0 + j;
      vs[j * dv + c] = kj < Sk ? to_f32(vb[(size_t)kj * v_row + c]) : 0.f;
    }
    __syncthreads();

    float s[TQ][TK];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.f;
    }
    for (int c = 0; c < d; ++c) {
      float qv[TQ], kv[TK];
#pragma unroll
      for (int i = 0; i < TQ; ++i) qv[i] = qs[(ty * TQ + i) * dp + c];
#pragma unroll
      for (int j = 0; j < TK; ++j) kv[j] = ks[(tx + 16 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
#pragma unroll
        for (int j = 0; j < TK; ++j) s[i][j] += qv[i] * kv[j];
      }
    }

#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qi = q0 + ty * TQ + i;
      bool ok[TK];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < Sk && (!causal || qi >= kj)
                && (window <= 0 || qi - kj < window);
        s[i][j] *= scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * TQ + i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[i][c] *= corr;
    }
    __syncwarp();      // a row's probabilities come from its own half-warp

    for (int j = 0; j < BK; ++j) {
      float pv[TQ], vv[DT];
#pragma unroll
      for (int i = 0; i < TQ; ++i) pv[i] = ps[(ty * TQ + i) * PS + j];
#pragma unroll
      for (int c = 0; c < DT; ++c) {
        const int col = tx + 16 * c;
        vv[c] = col < dv ? vs[j * dv + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
#pragma unroll
        for (int c = 0; c < DT; ++c) acc[i][c] += pv[i] * vv[c];
      }
    }
  }

  // rows that saw no valid key (l is 0 only there: the largest valid score
  // of a row adds exp(0) = 1) take the plain mean of all Sk values
  bool keyless[TQ], any_keyless = false;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    keyless[i] = q0 + ty * TQ + i < Sq && l[i] == 0.f;
    any_keyless |= keyless[i];
  }
  if (__syncthreads_or(any_keyless)) {
    for (int k0 = 0; k0 < Sk; k0 += BK) {
      __syncthreads();
      for (int e = tid; e < BK * dv; e += kThreads) {
        const int j = e / dv, c = e % dv;
        const int kj = k0 + j;
        vs[j * dv + c] = kj < Sk ? to_f32(vb[(size_t)kj * v_row + c]) : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < min(BK, Sk - k0); ++j) {
#pragma unroll
        for (int c = 0; c < DT; ++c) {
          const int col = tx + 16 * c;
          const float vv = col < dv ? vs[j * dv + col] : 0.f;
#pragma unroll
          for (int i = 0; i < TQ; ++i)
            if (keyless[i]) acc[i][c] += vv;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i)
      if (keyless[i]) l[i] = (float)Sk;
  }

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + ty * TQ + i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DT; ++c) {
      const int col = tx + 16 * c;
      if (col < dv) ob[(size_t)qi * o_row + col] = from_f32<T>(acc[i][c] * inv);
    }
  }
}

size_t smem_bytes(int d, int dv) {
  return ((size_t)(BQ + BK) * (d + 1) + (size_t)BK * dv + (size_t)BQ * PS)
         * sizeof(float);
}

template <typename T, int DT>
cudaError_t launch_dt(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Sk, int H, int KV, int d, int dv,
                      int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, dv);
  auto kern = flash_attention_kernel<T, DT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, d, dv,
      causal, window, 1.f / sqrtf((float)d));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KV, int d, int dv,
                   int causal, int window, cudaStream_t stream) {
  if (dv <= 32) return launch_dt<T, 2>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, stream);
  if (dv <= 64) return launch_dt<T, 4>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, stream);
  if (dv <= 128) return launch_dt<T, 8>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, stream);
  return launch_dt<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, stream);
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
      || window < 0 || smem_bytes(d, dv) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, s);
  return (int)launch<float>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, s);
}
