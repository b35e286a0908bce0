// Fused mixture-of-experts feed-forward for inference, Hopper sm_90a:
//
//     y[t] = sum over t's kept picks k, in ascending expert order, of
//            gate[t, k] * SwiGLU_{e(t, k)}(x[t])  +  SwiGLU_shared(x[t])
//
// Replaces no TPU kernel: the JAX package's MoE (src/repro/models/layers.py,
// moe_forward) is plain jnp, a sort-based capacity dispatch into [E, C, d]
// buffers that XLA compiles.  The port's plain version of that dispatch
// (models/layers.py) launches about 93 small kernels a layer at decode and
// multiplies every expert over all C rows of its buffer: at Granite 4.0-H's
// E = 72, top-10 and capacity factor E/K, C = T, so 7.2 times the routed
// rows.  This file serves inference on one card (no gradient, no mesh) in
// three launches after the router's logits:
//
//  1. route: softmax in f32 and a stable top-K of each token by logit (on
//     equal logits the lower expert first; moe_route's stable sort of the
//     probabilities parts from it only where two different logits round to
//     one f32 probability), the gates renormalised with the same
//     clamp, each pick's place in its expert's queue in token order, the
//     drops (place >= capacity), per-expert kept counts and offsets, the
//     tile table of the grouped kernels, the combine's rows in ascending
//     expert order and the Switch aux loss.  Blocks of 8 tokens route in
//     parallel; the last block to finish (a ticket in device memory, reset
//     by that block) scans the blocks' counts in block order, so every sum
//     is taken in one fixed order.
//  2. up: for each expert, its kept rows of x only (gathered by index),
//     h = silu(x.w1) * (x.w3) in f32, stored in x's type in pick order;
//     the shared expert is one more group over all T rows at its own width.
//  3. down: out = h.w2 per kept pick, and per row for the shared group;
//     then the combine: the last block to finish a column tile (a counter
//     per column tile, reset by that block) sums, for every token, gate *
//     out over its kept picks in ascending expert order, in f32, plus the
//     shared output, over that tile's columns.  No atomic touches a sum, so
//     y is the same bits from run to run.
//
// Bound: the weights.  At decode (T = 128 slots, 1,280 picks over 72
// experts, about 18 rows an expert) every expert is hit, and the layer must
// read each routed weight once, 72 x 3 x 4096 x 768 x 2 bytes = 1.359 GB,
// plus the shared expert's 37.7 MB: 0.417 ms at 3.35 TB/s, while the
// products need about 25 GFLOP, far under the tensor cores' 989 TFLOP/s.
// So the grouped kernels put the weight's output columns on the MMA's
// 16-row side and the expert's tokens on the narrow side, stream each
// (expert, column tile) slice of the weights through a cp.async ring of
// shared-memory stages exactly once for all of that expert's rows (a tile
// of up to BN rows; an expert with more rows takes more tiles, which run
// side by side and share the slice in L2), and keep no padded rows beyond
// one MMA tile: no [E, C, d] buffer and no zero fill.  The column tile is
// the grid's fast axis, so the blocks in flight together read whole rows
// of one expert's matrices rather than 128-byte pieces of many.  The up
// and down kernels launch as programmatic dependents (PDL): up's blocks
// wait in place for the route, and down streams its first weight stages
// while up finishes, then waits for h.  The tiling follows
// the rows an expert gets, T.K/E: BN = 32 token rows at decode, BN = 128 at
// prefill, where the weights are reused across more rows.  Grids are sized
// from shapes alone (at most T.K/BN + E tiles, plus the shared group's);
// tiles that routing left empty exit at once, so nothing waits on the
// host.  The operands are bf16, on mma.sync.m16n8k16 with f32 sums (an f32
// model keeps the plain dispatch).
//
// Shapes: logits f32 [T, E]; x [T, d]; w1, w3 [E, d, ff]; w2 [E, ff, d];
// the shared expert s1, s3 [d, ffs], s2 [ffs, d] (or none); y [T, d].  x,
// the weights and y are bf16.  d, ff and ffs are multiples of 8 elements;
// E <= 256, K <= 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxE = 256;
constexpr int kMaxK = 16;
constexpr int kRouteThreads = 256;
constexpr int kRouteTok = 8;     // tokens a route block takes (a warp each)
constexpr int kBM = 64;          // weight columns a GEMM block owns
constexpr int kMaxColTiles = 1024;   // column tiles of d the counters cover
constexpr size_t kSmemLimit = 232448;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ __nv_bfloat16 from_f32(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// programmatic dependent launch: let the next kernel on the stream start,
// and wait for the previous one's results (no-ops without the attribute)
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
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

// ---------------------------------------------------------------------------
// workspace: one byte buffer, carved the same way by the host and the kernels
// ---------------------------------------------------------------------------

struct Layout {
  size_t ids, pos, kept, gates, src, crow, cgate, counts, offs, tgroup, trow0,
      nactive, pcnt, pbase, ppsum, ptop1, h, hs, out, outs, total;
  int bn, nb, tiles, nsh;
};

// bn: the token rows of a grouped kernel's tile, 32 (decode) or 128
Layout make_layout(int T, int d, int E, int K, int ff, int ffs, int bn) {
  Layout L{};
  const size_t es = 2;   // bf16
  const size_t TK = (size_t)T * K;
  L.bn = bn;
  L.nb = (T + kRouteTok - 1) / kRouteTok;
  L.nsh = ffs > 0 ? (T + L.bn - 1) / L.bn : 0;
  L.tiles = L.nsh + (int)((TK + (size_t)E * (L.bn - 1)) / L.bn);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off += (bytes + 255) / 256 * 256;
    return at;
  };
  L.ids = take(TK * 4);
  L.pos = take(TK * 4);
  L.kept = take(TK);
  L.gates = take(TK * 4);
  L.src = take(TK * 4);
  L.crow = take(TK * 4);
  L.cgate = take(TK * 4);
  L.counts = take((size_t)E * 4);
  L.offs = take((size_t)(E + 1) * 4);
  L.tgroup = take((size_t)L.tiles * 4);
  L.trow0 = take((size_t)L.tiles * 4);
  L.nactive = take(4);
  L.pcnt = take((size_t)L.nb * E * 4);
  L.pbase = take((size_t)L.nb * E * 4);
  L.ppsum = take((size_t)L.nb * E * 4);
  L.ptop1 = take((size_t)L.nb * E * 4);
  L.h = take(TK * ff * es);
  L.hs = take((size_t)T * ffs * es);
  L.out = take(TK * d * es);
  L.outs = take(ffs > 0 ? (size_t)T * d * es : 0);
  L.total = off;
  return L;
}

// ---------------------------------------------------------------------------
// 1. route
// ---------------------------------------------------------------------------

struct RouteArgs {
  const float* logits;
  int* ids;       // [T, K] top-K order
  int* pos;       // [T, K] place in the expert's queue (token order)
  uint8_t* kept;  // [T, K]
  float* gates;   // [T, K] renormalised
  int* src;       // [T*K] token of each kept row, rows grouped by expert
  int* crow;      // [T, K] combine: kept row of t's j-th expert ascending, or -1
  float* cgate;   // [T, K] its gate (0 for a drop)
  int* counts;    // [E] kept rows per expert
  int* offs;      // [E + 1] first row of each expert
  int* tgroup;    // [tiles] a tile's group (expert, E = shared) or -1
  int* trow0;     // [tiles] its first row within the group
  int* nactive;   // [1] tiles with a group
  int* pcnt;      // [nb, E] a block's picks per expert
  int* pbase;     // [nb, E] the picks of each expert in the blocks before
  float* ppsum;   // [nb, E] a block's probability sums
  int* ptop1;     // [nb, E] a block's top-1 counts
  float* aux;     // [1]
  unsigned* ticket;
  int T, E, K, C, bn, tiles, nsh;
  float aux_scale;  // aux_loss_coef * E
};

__global__ void __launch_bounds__(kRouteThreads)
moe_route_kernel(RouteArgs a) {
  constexpr int kWarps = kRouteThreads / 32;
  constexpr int EPL = kMaxE / 32;   // experts a lane holds
  __shared__ unsigned mask_s[kRouteTok][EPL];   // each token's experts
  __shared__ int ids_s[kRouteTok * kMaxK];
  __shared__ float psum_s[kWarps][kMaxE];
  __shared__ int top1_s[kMaxE];
  __shared__ int offs_s[kMaxE + 1];
  __shared__ int tst_s[kMaxE + 1];
  __shared__ float term_s[kMaxE];
  __shared__ int last_s;

  pdl_launch_dependents();   // the up kernel's blocks wait in place
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = a.T, E = a.E, K = a.K;
  const int t0 = blockIdx.x * kRouteTok;
  const int nt = min(kRouteTok, T - t0);
  for (int e = tid; e < E; e += kRouteThreads) top1_s[e] = 0;
  __syncthreads();

  // softmax and top-K, a warp per token
  float ps[EPL];
#pragma unroll
  for (int j = 0; j < EPL; ++j) ps[j] = 0.f;
  for (int tl = warp; tl < nt; tl += kWarps) {
    const int t = t0 + tl;
    const float* row = a.logits + (size_t)t * E;
    float lg[EPL], pr[EPL];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const int e = lane + 32 * j;
      lg[j] = e < E ? row[e] : -INFINITY;
      mx = fmaxf(mx, lg[j]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      pr[j] = lane + 32 * j < E ? expf(lg[j] - mx) : 0.f;
      s += pr[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      pr[j] = pr[j] / s;
      ps[j] += pr[j];
    }
    // top-K by logit (the order of the probabilities), ties to the lower
    // expert: a lane's best over its experts, then a butterfly arg-max
    unsigned taken = 0;
    int my_id = 0, first = 0;
    float my_p = 0.f, gsum = 0.f;
    for (int k = 0; k < K; ++k) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < EPL; ++j) {
        const int e = lane + 32 * j;
        if (e < E && !((taken >> j) & 1u) && (bi == 0x7fffffff || lg[j] > bv)) {
          bv = lg[j];
          bi = e;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (oi != 0x7fffffff &&
            (bi == 0x7fffffff || ov > bv || (ov == bv && oi < bi))) {
          bv = ov;
          bi = oi;
        }
      }
      float pv = 0.f;
#pragma unroll
      for (int j = 0; j < EPL; ++j)
        if ((bi >> 5) == j) pv = pr[j];
      pv = __shfl_sync(0xffffffffu, pv, bi & 31);
      if (lane == (bi & 31)) taken |= 1u << (bi >> 5);
      if (lane == k) {
        my_id = bi;
        my_p = pv;
      }
      if (k == 0) first = bi;
      gsum += pv;
    }
    const float den = fmaxf(gsum, 1e-9f);
    if (lane < K) {
      a.ids[(size_t)t * K + lane] = my_id;
      a.gates[(size_t)t * K + lane] = my_p / den;
      ids_s[tl * K + lane] = my_id;
    }
#pragma unroll
    for (int j = 0; j < EPL; ++j) {
      const unsigned m = __ballot_sync(0xffffffffu, (taken >> j) & 1u);
      if (lane == 0) mask_s[tl][j] = m;
    }
    if (lane == 0) atomicAdd(&top1_s[first], 1);
  }
#pragma unroll
  for (int j = 0; j < EPL; ++j)
    if (lane + 32 * j < E) psum_s[warp][lane + 32 * j] = ps[j];
  __syncthreads();

  // the block's partials; each pick's place among the block's earlier tokens
  const int blk = blockIdx.x;
  for (int e = tid; e < E; e += kRouteThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += psum_s[w][e];
    int c = 0;
    for (int tl = 0; tl < nt; ++tl) c += (mask_s[tl][e >> 5] >> (e & 31)) & 1u;
    a.ppsum[(size_t)blk * E + e] = s;
    a.ptop1[(size_t)blk * E + e] = top1_s[e];
    a.pcnt[(size_t)blk * E + e] = c;
  }
  for (int i = tid; i < nt * K; i += kRouteThreads) {
    const int tl = i / K, e = ids_s[i];
    int c = 0;
    for (int u = 0; u < tl; ++u) c += (mask_s[u][e >> 5] >> (e & 31)) & 1u;
    a.pos[(size_t)t0 * K + i] = c;
  }

  // the last block to finish scans every block's partials in block order
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  const int nb = gridDim.x;
  const float invT = 1.f / (float)T;
  const int* __restrict__ pcnt = a.pcnt;
  const float* __restrict__ ppsum = a.ppsum;
  const int* __restrict__ ptop1 = a.ptop1;
  int* __restrict__ pbase = a.pbase;
  for (int e = tid; e < E; e += kRouteThreads) {
    int run = 0, top1 = 0;
    float s = 0.f;
#pragma unroll 4
    for (int b = 0; b < nb; ++b) {
      const size_t q = (size_t)b * E + e;
      pbase[q] = run;
      run += __ldcg(pcnt + q);
      s += __ldcg(ppsum + q);
      top1 += __ldcg(ptop1 + q);
    }
    offs_s[e] = min(run, a.C);       // kept rows of e (offsets below)
    term_s[e] = (s * invT) * ((float)top1 * invT);
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive scans of kept rows and of tiles over the experts, and the
    // aux loss's sum, each lane over a contiguous run of experts
    const int per = (E + 31) / 32, e0 = lane * per;
    int nsum = 0, tsum = 0;
    float asum = 0.f;
    for (int e = e0; e < min(e0 + per, E); ++e) {
      nsum += offs_s[e];
      tsum += (offs_s[e] + a.bn - 1) / a.bn;
      asum += term_s[e];
    }
    int nx = nsum, tx = tsum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int nu = __shfl_up_sync(0xffffffffu, nx, o);
      const int tu = __shfl_up_sync(0xffffffffu, tx, o);
      if (lane >= o) {
        nx += nu;
        tx += tu;
      }
    }
    int nrun = nx - nsum, trun = tx - tsum;
    for (int e = e0; e < min(e0 + per, E); ++e) {
      const int n = offs_s[e];
      a.counts[e] = n;
      offs_s[e] = nrun;
      tst_s[e] = trun;
      nrun += n;
      trun += (n + a.bn - 1) / a.bn;
    }
    if (lane == 31) {
      offs_s[E] = nx;
      tst_s[E] = tx;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) asum += __shfl_xor_sync(0xffffffffu, asum, o);
    if (lane == 0) a.aux[0] = a.aux_scale * asum;
  }
  __syncthreads();
  for (int e = tid; e <= E; e += kRouteThreads) a.offs[e] = offs_s[e];

  // the grouped kernels' tiles: the shared group first, then each expert's
  for (int i = tid; i < a.tiles; i += kRouteThreads) {
    int g = -1, r0 = 0;
    if (i < a.nsh) {
      g = E;
      r0 = i * a.bn;
    } else if (i - a.nsh < tst_s[E]) {
      const int q = i - a.nsh;
      int lo = 0, hi = E - 1;   // the last expert whose tiles start <= q
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (tst_s[mid] <= q) lo = mid; else hi = mid - 1;
      }
      g = lo;
      r0 = (q - tst_s[lo]) * a.bn;
    }
    a.tgroup[i] = g;
    a.trow0[i] = r0;
  }

  // each pick's place in its expert's whole queue, its drop, its row, and
  // the combine's order (ascending expert), a thread per token
  for (int t = tid; t < T; t += kRouteThreads) {
    const size_t b = (size_t)(t / kRouteTok) * E;
    int me[kMaxK], pl[kMaxK];
    float gv[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) me[k] = k < K ? __ldcg(a.ids + (size_t)t * K + k) : 0x7fffffff;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {   // every load before the stores
      const size_t q = (size_t)t * K + k;
      pl[k] = k < K ? __ldcg(a.pos + q) + __ldcg(a.pbase + b + me[k]) : 0;
      gv[k] = k < K ? __ldcg(a.gates + q) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (k >= K) continue;
      const size_t q = (size_t)t * K + k;
      const int e = me[k];
      const int p = pl[k];
      int rank = 0;
#pragma unroll
      for (int k2 = 0; k2 < kMaxK; ++k2) rank += me[k2] < e;
      a.pos[q] = p;
      a.kept[q] = p < a.C;
      const size_t c = (size_t)t * K + rank;
      if (p < a.C) {
        const int row = offs_s[e] + p;
        a.src[row] = t;
        a.crow[c] = row;
        a.cgate[c] = gv[k];
      } else {
        a.crow[c] = -1;
        a.cgate[c] = 0.f;
      }
    }
  }
  if (tid == 0) {
    *a.nactive = a.nsh + tst_s[E];
    *a.ticket = 0u;   // ready for the next call on this stream
  }
}

// ---------------------------------------------------------------------------
// 2-3. grouped expert GEMMs: dst[row, m] = act[row] . W_g[:, m] per tile
// ---------------------------------------------------------------------------

struct GemmArgs {
  const int* tgroup;
  const int* trow0;
  const int* counts;
  const int* offs;
  const int* src;      // up: a routed row's token (x is gathered)
  const void* act;     // up: x [T, d]; down: h [T*K, ff]
  const void* act_sh;  // up: x; down: hs [T, ffs]
  const void* w;       // up: w1 [E, d, ff]; down: w2 [E, ff, d]
  const void* w3;      // up: w3; down: unused
  const void* w_sh;    // up: s1 [d, ffs]; down: s2 [ffs, d]
  const void* w3_sh;   // up: s3
  void* dst;           // up: h; down: out [T*K, d]
  void* dst_sh;        // up: hs; down: outs [T, d]
  // down: the combine into y [T, d], by the last block of each column tile
  const int* crow;
  const float* cgate;
  const int* nactive;
  unsigned* colcnt;    // [column tiles] blocks finished, 0 between calls
  void* y;
  int T, E, K;
  int Kd, Kd_sh;       // reduction widths (up: d, d; down: ff, ffs)
  int M, M_sh;         // output widths (up: ff, ffs; down: d, d)
};

// A tile's group, rows and widths; false when the block has no work.
struct TileJob {
  bool sh;
  int g, n, grow0, Kd, M;
};

__device__ __forceinline__ bool tile_job(const GemmArgs& a, int tile, int m0,
                                         TileJob& j) {
  j.g = a.tgroup[tile];
  if (j.g < 0) return false;
  const int r0 = a.trow0[tile];
  j.sh = j.g == a.E;
  j.M = j.sh ? a.M_sh : a.M;
  if (m0 >= j.M) return false;
  j.Kd = j.sh ? a.Kd_sh : a.Kd;
  j.n = j.sh ? a.T - r0 : a.counts[j.g] - r0;
  j.grow0 = j.sh ? r0 : a.offs[j.g] + r0;   // first row in h / out (or hs / outs)
  return j.n > 0;
}

// The down kernels' end: once every active tile has written its rows of
// this column tile, the last block to finish sums them into y, for every
// token in ascending expert order (crow / cgate), in f32, plus the shared
// output, and resets the tile's counter.
__device__ void combine_tail(const GemmArgs& a, int m0) {
  using TX = __nv_bfloat16;
  constexpr int VE = 16 / sizeof(TX);
  constexpr int CH = kBM / VE;   // 16-byte chunks of the column tile
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.colcnt + blockIdx.x, 1u) == (unsigned)(*a.nactive - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const TX* out = static_cast<const TX*>(a.dst);
  const TX* outs = static_cast<const TX*>(a.dst_sh);
  TX* y = static_cast<TX*>(a.y);
  const int d = a.M, K = a.K;
  for (int i = threadIdx.x; i < a.T * CH; i += blockDim.x) {
    const int t = i / CH, c = m0 + (i % CH) * VE;
    if (c >= d) continue;
    float acc[VE];
#pragma unroll
    for (int v = 0; v < VE; ++v) acc[v] = 0.f;
    // groups of G picks: their rows' loads all in flight, then the sums
    // in ascending expert order
    constexpr int G = 8;
    for (int k0 = 0; k0 < K; k0 += G) {
      int rows[G];
      float gs[G];
      uint4 raw[G];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const bool in = k0 + u < K;
        rows[u] = in ? a.crow[(size_t)t * K + k0 + u] : -1;
        gs[u] = in ? a.cgate[(size_t)t * K + k0 + u] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < G; ++u)
        if (rows[u] >= 0)
          raw[u] = __ldcg(reinterpret_cast<const uint4*>(out + (size_t)rows[u] * d + c));
#pragma unroll
      for (int u = 0; u < G; ++u) {
        if (rows[u] < 0) continue;
        const TX* ov = reinterpret_cast<const TX*>(&raw[u]);
#pragma unroll
        for (int v = 0; v < VE; ++v) acc[v] += gs[u] * to_f32(ov[v]);
      }
    }
    if (a.M_sh > 0 && a.Kd_sh > 0) {
      const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(outs + (size_t)t * d + c));
      const TX* sv = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int v = 0; v < VE; ++v) acc[v] += to_f32(sv[v]);
    }
    uint4 res;
    TX* rv = reinterpret_cast<TX*>(&res);
#pragma unroll
    for (int v = 0; v < VE; ++v) rv[v] = from_f32(acc[v]);
    *reinterpret_cast<uint4*>(y + (size_t)t * d + c) = res;
  }
  if (threadIdx.x == 0) a.colcnt[blockIdx.x] = 0u;
}

template <bool UP, int BN>
struct MmaTiling {
  static constexpr int BK = 64;
  static constexpr int WN = BN == 32 ? 32 : 64;         // tokens a warp owns
  static constexpr int kWarps = (kBM / 16) * (BN / WN);
  static constexpr int kThreads = kWarps * 32;
  static constexpr int STAGES = BN == 32 ? 4 : 3;
  static constexpr int WP = kBM + 8;                     // padded pitches
  static constexpr int XP = BK + 8;
  static constexpr int kW = BK * WP;                     // elements
  static constexpr int kX = BN * XP;
  static constexpr int kStage = (UP ? 2 : 1) * kW + kX;
  static constexpr size_t kSmem = (size_t)STAGES * kStage * 2;
};

template <bool UP, int BN>
__global__ void __launch_bounds__(MmaTiling<UP, BN>::kThreads)
moe_gemm_mma_kernel(GemmArgs a) {
  using Tl = MmaTiling<UP, BN>;
  using TX = __nv_bfloat16;
  constexpr int BK = Tl::BK, WN = Tl::WN, NT = Tl::kThreads, WP = Tl::WP,
                XP = Tl::XP, STAGES = Tl::STAGES;
  constexpr int XI = BN * (BK / 8) / NT;    // x chunks a thread copies
  constexpr int WI = BK * (kBM / 8) / NT;   // chunks of each weight tile
  static_assert(XI >= 1 && WI >= 1, "tiling");
  extern __shared__ float4 smem4[];
  TX* smem = reinterpret_cast<TX*>(smem4);

  // up waits for the route's tables; down reads them at once (the route
  // finished before any up block got past its wait) and waits for h below
  if constexpr (UP) pdl_wait();
  const int m0 = blockIdx.x * kBM;
  TileJob j;
  if (!tile_job(a, blockIdx.y, m0, j)) return;
  const int n = min(j.n, BN);
  const int Kd = j.Kd, M = j.M;
  const TX* act = static_cast<const TX*>(j.sh ? a.act_sh : a.act);
  const size_t wstride = (size_t)Kd * M;
  const TX* w = j.sh ? static_cast<const TX*>(a.w_sh)
                     : static_cast<const TX*>(a.w) + (size_t)j.g * wstride;
  const TX* w3 = nullptr;
  if constexpr (UP)
    w3 = j.sh ? static_cast<const TX*>(a.w3_sh)
              : static_cast<const TX*>(a.w3) + (size_t)j.g * wstride;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % (kBM / 16), wn = warp / (kBM / 16);
  // this thread's copies: x rows (tid / 8 + i NT / 8) at chunk tid % 8, and
  // weight rows likewise at column chunk tid % 8
  const int cc = (tid & 7) * 8;
  const TX* xr[XI];
#pragma unroll
  for (int i = 0; i < XI; ++i) {
    const int r = (tid >> 3) + i * (NT / 8);
    int arow = -1;
    if (r < n) arow = UP && !j.sh ? a.src[j.grow0 + r] : j.grow0 + r;
    xr[i] = arow < 0 ? nullptr : act + (size_t)arow * Kd;
  }
  const bool mok = m0 + cc < M;
  const int ktiles = (Kd + BK - 1) / BK;

  auto load_w = [&](int slot, int kt) {
    TX* ws = smem + slot * Tl::kStage;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < WI; ++i) {
      const int kr = (tid >> 3) + i * (NT / 8);
      const bool ok = mok && k0 + kr < Kd;
      const size_t go = (size_t)(k0 + kr) * M + m0 + cc;
      cp_async16(smem_u32(ws + kr * WP + cc), ok ? w + go : w, ok ? 16 : 0);
      if constexpr (UP)
        cp_async16(smem_u32(ws + Tl::kW + kr * WP + cc), ok ? w3 + go : w3,
                   ok ? 16 : 0);
    }
  };
  auto load_x = [&](int slot, int kt) {
    TX* xs = smem + slot * Tl::kStage + (UP ? 2 : 1) * Tl::kW;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const int r = (tid >> 3) + i * (NT / 8);
      const bool ok = xr[i] != nullptr && k0 + cc < Kd;
      cp_async16(smem_u32(xs + r * XP + cc), ok ? xr[i] + k0 + cc : act,
                 ok ? 16 : 0);
    }
  };

  // acc[i][q]: column m0 + wm 16 + lane / 4 + 8 (q / 2), row (token)
  // wn WN + 8 i + 2 (lane % 4) + q % 2
  constexpr int NI = WN / 8;
  float acc[NI][4], acc3[UP ? NI : 1][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
#pragma unroll
  for (int i = 0; i < (UP ? NI : 1); ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc3[i][q] = 0.f;

  // the first stages' weights stream before down waits for the up kernel's
  // h (the first commit group holds them all, with the first x tile)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < ktiles) load_w(s, s);
  if constexpr (!UP) pdl_wait();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load_x(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) {
      load_w((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
      load_x((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    }
    cp_async_commit();
    const TX* ws = smem + (kt % STAGES) * Tl::kStage;
    const TX* xs = ws + (UP ? 2 : 1) * Tl::kW;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // A = W^T (16 columns x 16 of k) from the [k][m] tile, transposed
      const int krow = ks * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
      const int mcol = wm * 16 + ((lane >> 3) & 1) * 8;
      uint32_t af[4], af3[4];
      ldsm_x4_trans(smem_u32(ws + krow * WP + mcol), af);
      if constexpr (UP) ldsm_x4_trans(smem_u32(ws + Tl::kW + krow * WP + mcol), af3);
#pragma unroll
      for (int np = 0; np < WN / 16; ++np) {
        uint32_t bf[4];
        const int nrow = wn * WN + np * 16 + ((lane >> 4) & 1) * 8 + (lane & 7);
        ldsm_x4(smem_u32(xs + nrow * XP + ks * 16 + ((lane >> 3) & 1) * 8), bf);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
        if constexpr (UP) {
          mma_bf16(acc3[2 * np], af3, bf[0], bf[1]);
          mma_bf16(acc3[2 * np + 1], af3, bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (UP) pdl_launch_dependents();   // down may start its weights

  TX* dst = static_cast<TX*>(j.sh ? a.dst_sh : a.dst);
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + wm * 16 + (lane >> 2) + (q >> 1) * 8;
      const int r = wn * WN + i * 8 + (lane & 3) * 2 + (q & 1);
      if (r < n && m < M) {
        float v = acc[i][q];
        if constexpr (UP) v = silu(v) * acc3[i][q];
        dst[(size_t)(j.grow0 + r) * M + m] = from_f32(v);
      }
    }
  if constexpr (!UP) combine_tail(a, m0);
}

template <bool UP, int BN>
cudaError_t launch_mma(const GemmArgs& g, int tiles, int cols, cudaStream_t s) {
  using Tl = MmaTiling<UP, BN>;
  auto kern = moe_gemm_mma_kernel<UP, BN>;
  if (Tl::kSmem > kSmemLimit) return cudaErrorInvalidValue;
  if (Tl::kSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmem);
    if (e != cudaSuccess) return e;
  }
  // programmatic stream serialization: the kernel's blocks may start while
  // the one before it finishes, and wait (griddepcontrol) for its results
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((cols + kBM - 1) / kBM, tiles);
  cfg.blockDim = dim3(Tl::kThreads);
  cfg.dynamicSmemBytes = Tl::kSmem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, g);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool UP>
cudaError_t launch_gemm(int bn, const GemmArgs& g, int tiles, int cols,
                        cudaStream_t s) {
  return bn == 32 ? launch_mma<UP, 32>(g, tiles, cols, s)
                  : launch_mma<UP, 128>(g, tiles, cols, s);
}

}  // namespace

// The workspace's size in bytes and, in offs[0..4], the byte offsets of
// ids (int32 [T, K]), pos (int32), kept (uint8) and gates (f32): the views
// a caller may read back.  bn: the grouped kernels' token rows a tile, 32
// (decode) or 128 (prefill).
extern "C" long long moe_fused_workspace(int T, int d, int E, int K, int ff,
                                         int ffs, int bn, long long* offs) {
  const Layout L = make_layout(T, d, E, K, ff, ffs, bn);
  offs[0] = (long long)L.ids;
  offs[1] = (long long)L.pos;
  offs[2] = (long long)L.kept;
  offs[3] = (long long)L.gates;
  return (long long)L.total;
}

// C entry bound with ctypes: launches route, up and down (with the
// combine) on `stream` and returns the first cudaError_t.  s1/s3/s2 null
// (ffs 0): no shared expert.  ticket: 1 + 1024 device ints, 0 between
// calls (the route's ticket, then a counter per column tile of d).
extern "C" int moe_fused_launch(const void* logits, const void* x,
                                const void* w1, const void* w3, const void* w2,
                                const void* s1, const void* s3, const void* s2,
                                void* y, void* aux, void* ws, void* ticket,
                                int T, int d, int E, int K, int ff, int ffs,
                                int C, int bn, float aux_scale, void* stream) {
  if (T < 1 || E < 1 || E > kMaxE || K < 1 || K > kMaxK || K > E || ff < 1 ||
      ffs < 0 || d < 1 || (d + kBM - 1) / kBM > kMaxColTiles ||
      (bn != 32 && bn != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout L = make_layout(T, d, E, K, ff, ffs, bn);
  uint8_t* base = static_cast<uint8_t*>(ws);
  auto at = [&](size_t off) { return static_cast<void*>(base + off); };

  RouteArgs r;
  r.logits = static_cast<const float*>(logits);
  r.ids = static_cast<int*>(at(L.ids));
  r.pos = static_cast<int*>(at(L.pos));
  r.kept = static_cast<uint8_t*>(at(L.kept));
  r.gates = static_cast<float*>(at(L.gates));
  r.src = static_cast<int*>(at(L.src));
  r.crow = static_cast<int*>(at(L.crow));
  r.cgate = static_cast<float*>(at(L.cgate));
  r.counts = static_cast<int*>(at(L.counts));
  r.offs = static_cast<int*>(at(L.offs));
  r.tgroup = static_cast<int*>(at(L.tgroup));
  r.trow0 = static_cast<int*>(at(L.trow0));
  r.nactive = static_cast<int*>(at(L.nactive));
  r.pcnt = static_cast<int*>(at(L.pcnt));
  r.pbase = static_cast<int*>(at(L.pbase));
  r.ppsum = static_cast<float*>(at(L.ppsum));
  r.ptop1 = static_cast<int*>(at(L.ptop1));
  r.aux = static_cast<float*>(aux);
  r.ticket = static_cast<unsigned*>(ticket);
  r.T = T;
  r.E = E;
  r.K = K;
  r.C = C;
  r.bn = L.bn;
  r.tiles = L.tiles;
  r.nsh = L.nsh;
  r.aux_scale = aux_scale;
  moe_route_kernel<<<L.nb, kRouteThreads, 0, s>>>(r);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  GemmArgs g;
  g.tgroup = r.tgroup;
  g.trow0 = r.trow0;
  g.counts = r.counts;
  g.offs = r.offs;
  g.src = r.src;
  g.crow = r.crow;
  g.cgate = r.cgate;
  g.nactive = r.nactive;
  g.colcnt = static_cast<unsigned*>(ticket) + 1;
  g.y = y;
  g.T = T;
  g.E = E;
  g.K = K;
  // up: h = silu(x w1) * (x w3)
  g.act = x;
  g.act_sh = x;
  g.w = w1;
  g.w3 = w3;
  g.w_sh = s1;
  g.w3_sh = s3;
  g.dst = at(L.h);
  g.dst_sh = at(L.hs);
  g.Kd = d;
  g.Kd_sh = d;
  g.M = ff;
  g.M_sh = ffs;
  const int up_cols = ff > ffs ? ff : ffs;
  e = launch_gemm<true>(bn, g, L.tiles, up_cols, s);
  if (e != cudaSuccess) return (int)e;
  // down: out = h w2
  g.act = at(L.h);
  g.act_sh = at(L.hs);
  g.w = w2;
  g.w3 = nullptr;
  g.w_sh = s2;
  g.w3_sh = nullptr;
  g.dst = at(L.out);
  g.dst_sh = at(L.outs);
  g.Kd = ff;
  g.Kd_sh = ffs;
  g.M = d;
  g.M_sh = d;
  return (int)launch_gemm<false>(bn, g, L.tiles, d, s);
}

