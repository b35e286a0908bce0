// Fused LoRA projection in bf16 for Hopper, sm_90a, on the tensor cores:
//
//     y = x @ W + scale * (x @ A^T) @ B^T
//
// The "wgmma" route of repro_torch.kernels.lora_matmul (lora_route): bf16
// x, W, A and B whose 2-D tensor maps TMA takes (K, N and r multiples of 8,
// so that every row stride is a multiple of 16 bytes; K >= 1).  Every other
// call takes the 3xTF32 kernel in lora_matmul.cu.
//
// Replaces the TPU kernel lora_matmul_pallas (src/repro/kernels/lora_matmul.py)
// for bf16.  Like it, the [M, r] activation x @ A^T and the [M, N] delta
// never go to device memory: x @ A^T is summed over K beside the base
// product, in registers, and the epilogue adds its product with B^T to the
// base sum before y is stored once.  Shapes: x [M, K], W [K, N], A [r, K],
// B [N, r], y [M, N], row-major; 1 <= r <= 128; every sum is f32 and y is
// cast once.
//
// Design: a block of 3 warpgroups owns a 128 x 128 tile of y.
//
//  * warpgroup 2 is the producer.  It gives up its registers (setmaxnreg 24)
//    and one thread issues TMA loads: the B tile [128 n][r] once, then per
//    64-deep step of K the x tile [128 rows][64 k], the W tile [64 k][128 n]
//    and the A tile [R][64 k] into a ring of 2-4 stages guarded by full and
//    empty mbarriers;
//  * warpgroups 0 and 1 are consumers (setmaxnreg 240), each owning 64 rows.
//    Per k16 step: one wgmma m64n128k16 for x . W (W is MN-major, read with
//    the transpose bit) and one wgmma m64nRk16 for x . A^T (A is K-major,
//    since A^T is the operand; R = r rounded up to 8, 16, 32, 64 or 128, the
//    rows past r zero-filled).  Two instructions, because W and A^T differ
//    in majorness.  A stage goes back to the producer once the wgmma group
//    after it has been issued (wait_group 1);
//  * the epilogue takes xa = scale * (x . A^T) from the f32 accumulator, whose
//    layout is wgmma's register A layout, splits it into hi = bf16(xa) and
//    lo = bf16(xa - hi), and runs two register-A wgmma m64n128k16 per k16
//    step of r against the B tile (B^T is K-major: B's rows hold r contiguous
//    values), summing into the base accumulator; y is stored once as bf16.
//    Rounding xa to bf16 once would leave an error near 2^-8 |xa| on each
//    term, which breaks the limit where y is near 0; hi + lo keeps about
//    2^-16 |xa|.
//
// Every box is 64 columns (128 bytes, the swizzle width) wide and written
// with the 128-byte swizzle; ragged M, N, K and r are zero-filled by TMA, so
// nothing is padded in device memory and no mask is needed before the store.
// Descriptors (hopper.cuh): x, A and B K-major (SBO 1024, a k16 step adds 32
// bytes); W MN-major in two [64 k][64 n] boxes (LBO 8192 between them, SBO
// 1024, a k16 step adds 2048 bytes).
//
// Instances, one per R in 8, 16, 32, 64, 128.  Shared memory: a stage is
// x 16 KB + W 16 KB + A R x 128 bytes, the B tile ceil(R / 64) x 16 KB,
// stages as many as fit in 227 KB, at most 4: every instance takes 4, at
// 148, 152, 160, 176 and 225 KB for R = 8, 16, 32, 64, 128 (plus 1 KB for
// alignment and the barriers).  Registers: the base accumulator is 64
// floats a thread, x . A^T R / 2, the hi and lo fragments R / 4 words each;
// ptxas gives every instance 168 at entry (setmaxnreg moves them to 24 and
// 240) and no spills.  Grid: ceil(N / 128) x ceil(M / 128) blocks, one a SM
// (384 threads; at qwen2-0.5b's wq 7 x 16 = 112 blocks for 132 SMs).
//
// Bound on the H100: 2MN(K + r) + 2MKr operations over the bf16 tensor-core
// peak against the bytes of x, W, A, B and y; at the ops phase's shapes the
// operations bind, or the bytes of x where N is narrow.  The kernel does
// 2MKR (N / 128) more for x . A^T recomputed by every column tile.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kNWG = 2;                  // consumer warpgroups
constexpr int kBM = 64 * kNWG;           // rows of y per block
constexpr int kBN = 128;                 // columns of y per block
constexpr int kBK = 64;                  // depth of one stage
constexpr int kThreads = (kNWG + 1) * 128;
constexpr int kMaxStages = 4;
constexpr int kXBytes = kBM * 128;       // x tile: [128 rows][64 k] bf16
constexpr int kWBytes = kBK * kBN * 2;   // W tile: 2 boxes [64 k][64 n]
constexpr int kBBox = kBN * 128;         // one B box: [128 n][64 r] bf16
constexpr size_t kSmemLimit = 232448;

template <int R>
__host__ __device__ constexpr int stage_bytes() {
  return kXBytes + kWBytes + R * 128;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
lora_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  __nv_bfloat16* __restrict__ y, int M, int K, int N,
                  float scale, int stages) {
  constexpr int RC = (R + 63) / 64;      // 64-column boxes of B's rows
  constexpr int KS = (R + 15) / 16;      // k16 steps of the epilogue
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* bs = smem;                                  // [RC] B boxes
  uint8_t* ring = bs + RC * kBBox;                     // [stages] stages
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring
                                               + stages * stage_bytes<R>());
  const uint32_t full0 = smem_u32(bars);               // full[s] = full0 + 8s
  const uint32_t empty0 = smem_u32(bars + kMaxStages);
  const uint32_t bbar = smem_u32(bars + 2 * kMaxStages);

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int nk = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kNWG * 128);
    }
    mbar_init(bbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kNWG) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == kNWG * 128) {
      mbar_expect_tx(bbar, RC * kBBox);
#pragma unroll
      for (int c = 0; c < RC; ++c)
        tma_load(smem_u32(bs + c * kBBox), &tb, bbar, c * 64, n0);
      for (int t = 0; t < nk; ++t) {
        const int s = t % stages;
        const uint32_t use = t / stages;
        mbar_wait(empty0 + 8 * s, (use & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, stage_bytes<R>());
        uint8_t* st = ring + s * stage_bytes<R>();
        const int k0 = t * kBK;
        tma_load(smem_u32(st), &tx, full, k0, m0);
        tma_load(smem_u32(st + kXBytes), &tw, full, n0, k0);
        tma_load(smem_u32(st + kXBytes + kWBytes / 2), &tw, full, n0 + 64,
                 k0);
        tma_load(smem_u32(st + kXBytes + kWBytes), &ta, full, k0, 0);
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    float acc[kBN / 2];
    float xa[R / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < R / 2; ++i) xa[i] = 0.f;

    for (int t = 0; t < nk; ++t) {
      const int s = t % stages;
      mbar_wait(full0 + 8 * s, (t / stages) & 1);
      const uint8_t* st = ring + s * stage_bytes<R>();
      const uint32_t x_base = smem_u32(st) + wg * 64 * 128;
      const uint32_t w_base = smem_u32(st + kXBytes);
      const uint32_t a_base = smem_u32(st + kXBytes + kWBytes);
      fence_regs(acc);
      fence_regs(xa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = make_desc(x_base + kk * 32, 16, 1024);
        Wgmma<kBN, 1>::ss(acc, da,
                          make_desc(w_base + kk * 2048, kWBytes / 2, 1024), 1);
        Wgmma<R, 0>::ss(xa, da, make_desc(a_base + kk * 32, 16, 1024), 1);
      }
      wgmma_commit();
      // the group of step t - 1 is complete: its stage goes back
      wgmma_wait<1>();
      fence_regs(acc);
      fence_regs(xa);
      if (t > 0) mbar_arrive(empty0 + 8 * ((t - 1) % stages));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(xa);

    // scale * xa as bf16 hi + lo fragments: xa[8 ks + 2 q + e] is the k16
    // step ks's fragment word q (rows lane / 4 and + 8, columns 2 (lane % 4)
    // + e and + 8), the layout of wgmma's register A operand
    uint32_t hi[KS][4], lo[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * ks + 2 * q;
        const float v0 = i < R / 2 ? scale * xa[i] : 0.f;
        const float v1 = i < R / 2 ? scale * xa[i + 1] : 0.f;
        const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
        const float2 hf = __bfloat1622float2(h);
        hi[ks][q] = *reinterpret_cast<const uint32_t*>(&h);
        lo[ks][q] = pack_bf16(v0 - hf.x, v1 - hf.y);
      }

    mbar_wait(bbar, 0);
    const uint32_t b_base = smem_u32(bs);
    fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      fence_regs(hi[ks]);
      fence_regs(lo[ks]);
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint64_t db = make_desc(
          b_base + (ks / 4) * kBBox + (ks % 4) * 32, 16, 1024);
      Wgmma<kBN, 0>::rs(acc, hi[ks], db, 1);
      Wgmma<kBN, 0>::rs(acc, lo[ks], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      fence_regs(hi[ks]);
      fence_regs(lo[ks]);
    }

    // acc[4i + j]: row (j < 2 ? r0 : r0 + 8), column 8i + 2 (lane % 4) +
    // (j & 1); N is a multiple of 8, so a pair is all in or all out
    const int tid = threadIdx.x % 128;
    const int r0 = m0 + wg * 64 + (tid / 32) * 16 + (tid % 32) / 4;
    const int c0 = n0 + 2 * (tid % 4);
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int n = c0 + 8 * i;
      if (n >= N) continue;
      if (r0 < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r0 * N + n) =
            __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
      if (r0 + 8 < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(r0 + 8) * N + n) =
            __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

// --- host ----------------------------------------------------------------

template <int R>
size_t smem_bytes(int stages) {
  return (size_t)((R + 63) / 64) * kBBox + (size_t)stages * stage_bytes<R>()
         + 1024 + 8 * (2 * kMaxStages + 1);
}

template <int R>
cudaError_t launch(const void* x, const void* w, const void* a, const void* b,
                   void* y, int M, int K, int N, int r, float scale,
                   cudaStream_t stream) {
  int stages = kMaxStages;
  while (stages > 2 && smem_bytes<R>(stages) > kSmemLimit) --stages;
  const size_t smem = smem_bytes<R>(stages);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  CUtensorMap tx, tw, ta, tb;
  if (!encode_2d(&tx, x, M, K, kBM) || !encode_2d(&tw, w, K, N, kBK)
      || !encode_2d(&ta, a, r, K, R) || !encode_2d(&tb, b, N, r, kBN))
    return cudaErrorInvalidValue;
  auto kern = lora_wgmma_kernel<R>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  kern<<<grid, kThreads, smem, stream>>>(
      tx, tw, ta, tb, static_cast<__nv_bfloat16*>(y), M, K, N, scale, stages);
  return cudaGetLastError();
}

}  // namespace

// C entry bound with ctypes: bf16 x, W, A, B and y.  Returns the cudaError_t
// of the launch; what the route does not take (K, N or r not a multiple of
// 8, r outside [1, 128], K = 0, a base address that is not 16-byte aligned,
// a grid too tall, a tensor map that cuTensorMapEncodeTiled refuses) is
// refused as cudaErrorInvalidValue.
extern "C" int lora_matmul_wgmma_launch(const void* x, const void* w,
                                        const void* a, const void* b, void* y,
                                        int M, int K, int N, int r,
                                        float scale, void* stream) {
  if (M < 1 || N < 1 || K < 1 || r < 1 || r > 128 || K % 8 != 0
      || N % 8 != 0 || r % 8 != 0 || (M + kBM - 1) / kBM > 65535
      || ((uintptr_t)x | (uintptr_t)w | (uintptr_t)a | (uintptr_t)b) % 16
      || (uintptr_t)y % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 8) return (int)launch<8>(x, w, a, b, y, M, K, N, r, scale, s);
  if (r <= 16) return (int)launch<16>(x, w, a, b, y, M, K, N, r, scale, s);
  if (r <= 32) return (int)launch<32>(x, w, a, b, y, M, K, N, r, scale, s);
  if (r <= 64) return (int)launch<64>(x, w, a, b, y, M, K, N, r, scale, s);
  return (int)launch<128>(x, w, a, b, y, M, K, N, r, scale, s);
}
