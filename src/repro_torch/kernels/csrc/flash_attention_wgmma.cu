// Flash attention (forward) in bf16 for Hopper, sm_90a, on the tensor cores:
// TMA loads, an mbarrier ring and wgmma.  The "wgmma" route of
// repro_torch.kernels.flash (flash_route); f32, and bf16 shapes whose strides
// TMA refuses, take the 3xTF32 kernel in flash_attention.cu.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py) for bf16, with every semantic of
// flash_attention.cu: q [B, Sq, H, d], k [B, Sk, KV, d], v [B, Sk, KV, dv],
// o [B, Sq, H, dv]; query head h reads key/value head h / (H / KV) in place;
// keys at or past Sk are masked; key tiles that the causal diagonal or the
// window hide from the whole block are skipped; a masked pair adds 0 and
// never enters the running max; a row with no valid key takes the mean of
// all Sk values; scores are (q . k) / sqrt(d), every sum is f32, and the
// output is divided by max(l, 1e-30) and cast once.  One difference in the
// arithmetic: the probabilities are rounded to bf16 before P.V (the
// tensor cores take bf16 operands), while l sums them in f32.
//
// Design: FlashAttention-3 without ping-pong scheduling or intra-warpgroup
// overlap.  A block of 3 warpgroups owns 128 query rows of one (batch,
// head):
//
//  * warpgroup 2 is the producer.  It gives up its registers (setmaxnreg 24)
//    and one thread issues TMA loads (cp.async.bulk.tensor.4d): the two
//    64-row Q tiles once, then each 64-key K and V tile into a ring of 2-4
//    stages guarded by full and empty mbarriers;
//  * warpgroups 0 and 1 are consumers (setmaxnreg 240), each owning 64 query
//    rows.  S = Q.K^T runs as wgmma m64n64k16 with both operands in shared
//    memory; masking and the online softmax run on the accumulator's own
//    layout (a row's 64 scores sit in the 4 threads of a quad: two shuffles
//    for its max); P is converted to bf16 in registers, where the S
//    accumulator's layout is already wgmma's A-operand layout, and
//    O += P.V runs as wgmma m64n64k16 per 64 value columns with A from
//    registers and V (MN-major) from shared memory.
//
// Layouts.  Each tensor map is 4-D, innermost first: (width, heads, seq,
// batch), so the head width is the innermost dimension and TMA's
// out-of-bounds fill zero-pads it, as it zero-fills keys past Sk and query
// rows past Sq.  A box is 64 columns (128 bytes, the swizzle width) x 1 head
// x 64 rows x 1 batch, written with the 128-byte swizzle; a head wider than
// 64 takes ceil(width / 64) boxes side by side (d = 72 pads to 128 columns
// in shared memory, of which the S loop reads ceil(d / 16) * 16 = 80).
// TMA needs 16-byte-aligned bases and strides that are multiples of 16
// bytes: d * 2 and dv * 2 (the head stride), hence the route's d % 8 == 0
// and dv % 8 == 0; H * d * 2 and the rest follow.  The descriptors: K-major
// Q and K tiles with SBO = 1024 bytes (8 rows of 128 bytes), a k16 step
// advancing the start address by 32 bytes; MN-major V tiles with SBO = 1024
// bytes between 8-key groups, a k16 step advancing by 16 rows (2048 bytes).
//
// Shared memory of each instance (one [64][64] bf16 box is 8 KB; Q takes
// 2 * ceil(d/64) boxes, a stage ceil(d/64) + DVC boxes; stages = as many as
// fit in 227 KB, at most 4, at least 2; plus 1 KB for alignment and the
// barriers): d = dv = 64: 16 + 4 x 16 = 80 KB; d = dv = 128: 32 + 4 x 32 =
// 160 KB; d = 192, dv = 128: 48 + 3 x 40 = 168 KB; d = dv = 256: 64 + 2 x 64
// = 192 KB.  Registers: the O accumulator is 32 x DVC floats a thread (128
// at dv = 256), S 32, P 16 words.
//
// Bound on the H100: 2 (d + dv) operations per valid (query, key) pair and
// head over the bf16 tensor-core peak, against the bytes of q, k, v and o;
// at prefill lengths the operations bound it.
//
// The tensor maps are built on each call by cuTensorMapEncodeTiled (fetched
// at run time, hopper.cuh); the TMA, mbarrier and wgmma helpers are in
// hopper.cuh, shared with lora_matmul_wgmma.cu.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kNWG = 2;                  // consumer warpgroups
constexpr int kBQ = 64;                  // query rows per consumer warpgroup
constexpr int kBK = 64;                  // keys per tile
constexpr int kBox = 64 * 128;           // one [64 rows][64 cols] bf16 box
constexpr int kThreads = (kNWG + 1) * 128;
constexpr int kMaxStages = 4;
constexpr size_t kSmemLimit = 232448;
constexpr float kNegInf = -1e30f;        // the running max before any key

using namespace hopper;

// DVC: 64-column chunks of the value head (dv <= 64 DVC)
template <int DVC>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H,
                   int KV, int d, int dv, int causal, int window,
                   float scale_log2, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nqc = (d + 63) / 64;          // 64-column boxes of a q/k row
  uint8_t* qs = smem;                     // [kNWG][nqc] boxes
  uint8_t* ks = qs + kNWG * nqc * kBox;   // [stages][nqc]
  uint8_t* vs = ks + stages * nqc * kBox; // [stages][DVC]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + stages * DVC * kBox);
  const uint32_t full0 = smem_u32(bars);              // full[s] = full0 + 8s
  const uint32_t empty0 = smem_u32(bars + kMaxStages);
  const uint32_t qbar = smem_u32(bars + 2 * kMaxStages);

  // the last query tiles (the longest causal rows) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * (kNWG * kBQ);
  const int h = blockIdx.y, bi = blockIdx.z;
  const int kvh = h / (H / KV);
  // the keys any query of this block may see
  const int q_last = min(q0 + kNWG * kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kNWG * 128);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kNWG) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kNWG * 128) {
      mbar_expect_tx(qbar, kNWG * nqc * kBox);
      for (int w = 0; w < kNWG; ++w)
        for (int c = 0; c < nqc; ++c)
          tma_load(smem_u32(qs + (w * nqc + c) * kBox), &tq, qbar, c * 64, h,
                   q0 + w * kBQ, bi);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % stages;
        const uint32_t use = t / stages;
        mbar_wait(empty0 + 8 * s, (use & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, (nqc + DVC) * kBox);
        const int k0 = k_lo + t * kBK;
        for (int c = 0; c < nqc; ++c)
          tma_load(smem_u32(ks + (s * nqc + c) * kBox), &tk, full, c * 64,
                   kvh, k0, bi);
#pragma unroll
        for (int c = 0; c < DVC; ++c)
          tma_load(smem_u32(vs + (s * DVC + c) * kBox), &tv, full, c * 64,
                   kvh, k0, bi);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int wq_first = q0 + wg * kBQ;
    const int wq_last = min(wq_first + kBQ, Sq) - 1;
    const int qr0 = wq_first + warp * 16 + lane / 4;   // rows qr0, qr0 + 8
    const int qr1 = qr0 + 8;
    const int nks = (d + 15) / 16;                      // k16 steps of q.k

    float oacc[DVC][32];
#pragma unroll
    for (int c = 0; c < DVC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[c][i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(qbar, 0);
    const uint32_t q_base = smem_u32(qs + wg * nqc * kBox);

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % stages;
      const uint32_t use = t / stages;
      mbar_wait(full0 + 8 * s, use & 1);
      const int k0 = k_lo + t * kBK;
      const uint32_t k_base = smem_u32(ks + s * nqc * kBox);

      // S = Q K^T
      float sacc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
      fence_regs(sacc);
      wgmma_fence();
      for (int kk = 0; kk < nks; ++kk) {
        const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
        Wgmma<64, 0>::ss(sacc, make_desc(q_base + off, 16, 1024),
                         make_desc(k_base + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // mask, then the online softmax in the log2 domain; sacc[4i + j]
      // holds row (j < 2 ? qr0 : qr1), key k0 + 8i + 2 (lane % 4) + (j & 1)
      const bool need_mask =
          !(k0 + kBK <= Sk && (!causal || k0 + kBK - 1 <= wq_first)
            && (window <= 0 || wq_last - k0 < window));
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sv = sacc[4 * i + j] * scale_log2;
          if (need_mask) {
            const int key = k0 + 8 * i + 2 * (lane & 3) + (j & 1);
            const int qp = j < 2 ? qr0 : qr1;
            const bool ok = key < Sk && (!causal || qp >= key)
                            && (window <= 0 || qp - key < window);
            sv = ok ? sv : -INFINITY;   // exp2 gives exactly 0
          }
          sacc[4 * i + j] = sv;
          if (j < 2) mx0 = fmaxf(mx0, sv);
          else mx1 = fmaxf(mx1, sv);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sacc[4 * i + 0] = exp2f(sacc[4 * i + 0] - mn0);
        sacc[4 * i + 1] = exp2f(sacc[4 * i + 1] - mn0);
        sacc[4 * i + 2] = exp2f(sacc[4 * i + 2] - mn1);
        sacc[4 * i + 3] = exp2f(sacc[4 * i + 3] - mn1);
        rs0 += sacc[4 * i + 0] + sacc[4 * i + 1];
        rs1 += sacc[4 * i + 2] + sacc[4 * i + 3];
      }
      // l stays a per-thread partial sum (reduced over the quad at the end)
      l0 = l0 * c0 + rs0;
      l1 = l1 * c1 + rs1;
#pragma unroll
      for (int c = 0; c < DVC; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          oacc[c][4 * i + 0] *= c0;
          oacc[c][4 * i + 1] *= c0;
          oacc[c][4 * i + 2] *= c1;
          oacc[c][4 * i + 3] *= c1;
        }

      // P in bf16: the S accumulator's layout is wgmma's A layout, one
      // k16 step (16 keys) per 8 accumulator registers
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }

      // O += P V
      const uint32_t v_base = smem_u32(vs + s * DVC * kBox);
#pragma unroll
      for (int c = 0; c < DVC; ++c) fence_regs(oacc[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < DVC; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Wgmma<64, 1>::rs(oacc[c], pa[kk],
                           make_desc(v_base + c * kBox + kk * 2048, kBox,
                                     1024), 1);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < DVC; ++c) fence_regs(oacc[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(pa[kk]);
      mbar_arrive(empty0 + 8 * s);   // this stage's K and V are read
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

    // rows that saw no valid key (l is 0 only there: the largest valid score
    // of a row adds exp2(0) = 1) take the plain mean of all Sk values, read
    // straight from device memory: rare, and taken by those threads only
    const bool kl0 = qr0 < Sq && l0 == 0.f, kl1 = qr1 < Sq && l1 == 0.f;
    if (kl0 || kl1) {
      float mean[DVC][16];
#pragma unroll
      for (int c = 0; c < DVC; ++c)
#pragma unroll
        for (int i = 0; i < 16; ++i) mean[c][i] = 0.f;
      for (int j = 0; j < Sk; ++j) {
        const __nv_bfloat16* vr = v + (((size_t)bi * Sk + j) * KV + kvh) * dv;
#pragma unroll
        for (int c = 0; c < DVC; ++c)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int col = c * 64 + 8 * i + 2 * (lane & 3);
            if (col < dv) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(vr + col));
              mean[c][2 * i] += f.x;
              mean[c][2 * i + 1] += f.y;
            }
          }
      }
#pragma unroll
      for (int c = 0; c < DVC; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (kl0) {
            oacc[c][4 * i + 0] = mean[c][2 * i];
            oacc[c][4 * i + 1] = mean[c][2 * i + 1];
          }
          if (kl1) {
            oacc[c][4 * i + 2] = mean[c][2 * i];
            oacc[c][4 * i + 3] = mean[c][2 * i + 1];
          }
        }
      if (kl0) l0 = (float)Sk;
      if (kl1) l1 = (float)Sk;
    }

    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* o0 = o + (((size_t)bi * Sq + qr0) * H + h) * dv;
    __nv_bfloat16* o1 = o0 + (size_t)8 * H * dv;
#pragma unroll
    for (int c = 0; c < DVC; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = c * 64 + 8 * i + 2 * (lane & 3);
        if (col < dv) {
          if (qr0 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
                __floats2bfloat162_rn(oacc[c][4 * i] * inv0,
                                      oacc[c][4 * i + 1] * inv0);
          if (qr1 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
                __floats2bfloat162_rn(oacc[c][4 * i + 2] * inv1,
                                      oacc[c][4 * i + 3] * inv1);
        }
      }
  }
}

// --- host ----------------------------------------------------------------

// a [batch, seq, heads, width] bf16 tensor as a 4-D map, innermost first;
// a box is 64 columns x 1 head x `rows` rows x 1 batch, 128-byte swizzle
bool encode(CUtensorMap* map, const void* base, int batch, int seq, int heads,
            int width, int rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)width * 2,
                                 (cuuint64_t)heads * width * 2,
                                 (cuuint64_t)seq * heads * width * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t smem_bytes(int nqc, int dvc, int stages) {
  return (size_t)(kNWG * nqc + stages * (nqc + dvc)) * kBox + 1024
         + 8 * (2 * kMaxStages + 1);
}

template <int DVC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int H, int KV, int d, int dv,
                   int causal, int window, cudaStream_t stream) {
  const int nqc = (d + 63) / 64;
  int stages = kMaxStages;
  while (stages > 2 && smem_bytes(nqc, DVC, stages) > kSmemLimit) --stages;
  const size_t smem = smem_bytes(nqc, DVC, stages);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, Sq, H, d, kBQ) || !encode(&tk, k, B, Sk, KV, d, kBK)
      || !encode(&tv, v, B, Sk, KV, dv, kBK))
    return cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<DVC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kNWG * kBQ - 1) / (kNWG * kBQ), H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV, d, dv, causal, window,
      1.4426950408889634f / sqrtf((float)d), stages);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes: bf16 q, k, v and o.  Returns the cudaError_t
// of the launch; what the route does not take (a head width that is not a
// multiple of 8 or above 256, an empty key sequence, a base address that is
// not 16-byte aligned, a tensor map that cuTensorMapEncodeTiled refuses) is
// refused as cudaErrorInvalidValue.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, int B,
                                            int Sq, int Sk, int H, int KV,
                                            int d, int dv, int causal,
                                            int window, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV != 0 || d < 8
      || d > 256 || d % 8 != 0 || dv < 8 || dv > 256 || dv % 8 != 0
      || H > 65535 || B > 65535 || window < 0
      || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((dv + 63) / 64) {
    case 1: return (int)launch<1>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, s);
    case 2: return (int)launch<2>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, s);
    case 3: return (int)launch<3>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, s);
    default: return (int)launch<4>(q, k, v, o, B, Sq, Sk, H, KV, d, dv, causal, window, s);
  }
}
