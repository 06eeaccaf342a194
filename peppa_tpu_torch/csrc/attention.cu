// Multi-head self-attention, forward and backward, for the wav2vec2
// transformer (sm_90a).
//
// Replaces the TPU kernel peppa_tpu/ops/pallas/attention.py `_fwd_kernel`
// (called from `_attend_fwd`): o = softmax(scale * q k^T, keys >= length[b]
// set to -1e30) v, math in float32, output in q's dtype.
//
// Bound on an H100 at the main path's shapes (B=32, H=12, hd=64, bf16):
// q, k, v and o are read/written once, 4*B*T*H*hd elements (62 MB at
// T=316, 19 us); the work is 4*B*H*T^2*hd operations (9.8 GFLOP at T=316,
// 67 at T=826).  That is about 150 operations per byte at T=316 and 400 at
// T=826 against the card's ~295 in bf16, so bytes bound the short buckets
// and the tensor cores the long ones.  P v with P as a bf16 head and tail
// (below) doubles that product: 1.5x the tensor work of a one-P kernel.
// In practice the bf16 kernel is bound by its instruction stream, not by
// bytes: `mma.sync` plus the softmax and the head/tail split on the CUDA
// cores, which one warp runs in turn (PERF.md, section 6, has the times).
//
// Both forwards are flash-style: the Pallas kernel held the whole (T, T)
// score block of one (batch, head) in VMEM, a block's 227 KB of shared
// memory cannot, so K/V tiles of 64 keys pass through shared memory with an
// online softmax (running max and sum in float32) per row, and q/k/v/o are
// read and written through their (b, t, h, d) strides, so the (B, T, H, hd)
// projections need no transpose copy.  Tiles past the last valid key are
// skipped: their -1e30 scores contribute exp(-1e30 - m) = 0 exactly.  At
// length 0 every key of the row scores -1e30, which averages v over T, as
// the plain PyTorch version does.
//
// bfloat16 (the main path):
// - K/V traffic.  At T=826 the K/V of all (b, h) take 81 MB, more than the
//   50 MB L2.  The grid is head-major (query tile fastest), so the blocks
//   of one (b, h) run together and share its K/V through L2, and a block
//   takes 128 query rows (eight warps of 16), so each (b, h) reads its K/V
//   ceil(T/128) times.
// - Latency.  K/V tiles stream through two shared-memory stages by 16-byte
//   `cp.async` copies (rows past T zero-filled): tile j+1 is in flight
//   while tile j is multiplied.  q comes in the same way once; its A
//   fragments and K's B fragments are read by `ldmatrix`, V's by
//   `ldmatrix.trans`, from rows padded by 8 elements (no bank conflicts);
//   o leaves through shared memory as 16-byte rows.  q/k/v/o views whose
//   d stride is not 1 or whose rows are not 16-byte aligned take a
//   synchronous staging loop instead (template flag VEC).
// - Instructions.  `mma.sync` m16n8k16, ordered so that the products of
//   one k-step are independent.  S = q k^T takes the bf16 inputs, which
//   are exact, and accumulates in float32; the softmax runs in float32
//   registers in log2 units (the raw score times scale*log2(e), rounded,
//   minus the max, and one `ex2.approx` per element; the backward
//   recomputes P from the same rounded x); the mask is applied on the tile
//   holding the last key only; P v splits P into a bf16 head and a bf16
//   remainder
//   (two products, packed conversions), so P keeps ~16 bits and the
//   product stays float32 math to ~1e-5 relative, as the Pallas kernel's
//   float32 p @ v.
// float32 (the aligner's CTC forward, B=1 with key lengths; the float32
// `grsa.Embedder`, B=32; the card-vs-CPU checks): full float32 FMAs on the
// CUDA cores (no TF32: this route is the port's precision reference).
// - Bound: operations at 67 TF/s, 4*B*H*T*n_keys*hd of them: 0.1465 ms
//   at B=32, T=316 and 0.0292 ms at B=1, T=799 (q, k, v, o move 124 and
//   9.8 MB, 37 and 2.9 us at 3.35 TB/s).  The CUDA cores do one FMA per
//   operand pair, so the design counts instruction slots.
// - Instructions.  A register-tiled micro-kernel, as in a SIMT SGEMM: 128
//   threads per 64-row query tile, each owning 4 rows x 8 keys of S and
//   4 rows x HD/8 dims of O, so one 16-byte shared-memory load feeds about
//   11 FMAs (one fed 4 in the kernel this replaced).  P goes through shared
//   memory transposed, for float4 loads in P v; the row max and sum are
//   reduced over a row's eight lanes by shuffles; the softmax runs in log2
//   units (one FMA and one `ex2.approx` per score) with one rescale per
//   64-key tile.
// - Latency.  K/V tiles of 64 keys stream through two shared-memory stages
//   by `cp.async` (zero-filled past T), tile j+1 in flight while tile j is
//   multiplied; 102 KB of dynamic shared memory at hd 64, two blocks per
//   SM.  Views whose rows are not 16-byte vectors stage synchronously
//   (template flag VEC).
// - Small grids.  Where B*H*ceil(T/64) tiles cannot fill 132 SMs (the
//   aligner's B=1: 24-156 tiles), each row's keys are cut into contiguous
//   splits of whole tiles, one block each (`_f32_plan` in
//   ops/cuda/attention.py chooses the count from the shapes); the splits'
//   partial rows are combined by their log-sum-exps by a second kernel, in
//   split order, without atomics, so every launch gives the same bits.
// When the caller asks (autograd needs it), both forwards write the
// float32 log-sum-exp of each row's scaled scores for the backward
// (serving passes null): float32 in natural-log units; bf16 in log2 units,
// lse2 = m + log2(l) over the rounded scaled scores x = s * (scale*log2(e))
// that its softmax exponentiates (2^(x - m)), so the backward's
// 2^(x - lse2) is exactly 1 on a row with one key.
//
// Backward (section "backward" below).  Replaces the TPU kernel
// peppa_tpu/ops/pallas/attention.py `_bwd_kernel` (called from
// `_attend_bwd`): with P recomputed from q, k and the forward's log-sum-exp,
// dV = P^T dO, dP = dO V^T, dS = P o (dP - rowsum(dP o P)), dQ = dS K scale,
// dK = dS^T Q scale; outputs in q's dtype.  Bound on an H100 at the
// training shapes (B=8, H=12, hd=64, bf16): q, k, v, dO read and dQ, dK, dV
// written once, 7*B*T*H*hd elements (27 MB, 8.1 us at T=316); the work is
// 10*B*H*T^2*hd operations (5 products of T^2*hd: 41.9 GFLOP, 42.4 us on
// the tensor cores at T=826), so bytes bound T=316 and operations T=826;
// in float32, operations at 67 TF/s at both.  Two grids without atomics: a
// query-tile grid writes dQ and D, a key-tile grid loops over the query
// tiles for dK and dV.  Both pairs take D = rowsum(dO o O) from the
// forward's output (the bf16 dkdv reads the dq kernel's float32 rowsum(dP
// o P) instead), so S and dP are formed once in each kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;    // rows per block (bf16 kernels)
constexpr int kThreads = kRows * 2;  // eight warps of 16 rows
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kPad = 8;       // bf16 row padding: conflict-free fragments
constexpr float kMaskValue = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kF32Rows = 64;      // query rows per block (float32 forward)
constexpr int kF32Threads = 128;  // 16 row groups x 8 column groups
constexpr int kF32Pad = 4;        // float32 row padding: conflict-free float4
constexpr int kCombineThreads = 256;

struct Strides {
  long long b, t, h, d;
};

// ----------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// P's two bf16 parts: head = bf16(p), tail = bf16(p - head), each pair by
// one packed round-to-nearest conversion (x0 in the low half)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& head,
                                           uint32_t& tail) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  head = as_u32(h);
  tail = as_u32(__floats2bfloat162_rn(x0 - __low2float(h),
                                      x1 - __high2float(h)));
}

// D += A (16x16, row) * B (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two B fragments (k = 16 keys, n = 2 x 8 dims) of a row-major [key][d]
// tile, transposed on the way in.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* ptr) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Eight consecutive d of one (b, t, h) row: one 16-byte load when `vec`
// (d stride 1, 16-byte aligned rows), else eight strided loads.
__device__ __forceinline__ uint4 load8(const bf16* p, long long stride_d,
                                       bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  bf16 x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = p[i * stride_d];
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

// Four A fragments (16 rows x 16 d) or B fragments of a row-major tile,
// as they lie.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* ptr) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes from global to shared memory without registers; zeros when
// !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src,
                                           bool valid) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// `rows` rows from r0 of one (b, h) slice into shared memory (zero at and
// past `limit`), by the whole block: `cp.async` when VEC, else synchronous
// strided loads
template <int HD, bool VEC>
__device__ __forceinline__ void stage_async(bf16 (*dst)[HD + kPad],
                                            const bf16* base, Strides s,
                                            int r0, int rows, int limit) {
  for (int idx = threadIdx.x; idx < rows * HD / 8; idx += kThreads) {
    const int j = idx / (HD / 8);
    const int d = idx % (HD / 8) * 8;
    const int r = r0 + j;
    const bool valid = r < limit;
    if (VEC) {
      cp_async16(&dst[j][d], valid ? base + r * s.t + d : base, valid);
    } else {
      *reinterpret_cast<uint4*>(&dst[j][d]) =
          valid ? load8(base + r * s.t + d * s.d, s.d, false)
                : make_uint4(0, 0, 0, 0);
    }
  }
}

// 2^x in one MUFU op; results below 2^-126 flush to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One K/V tile for one warp's 16 query rows: S = q k^T, the online softmax
// in log2 units, o += P v.  MASK: the tile holds the last key, and keys at
// and past `tile_keys` do not exist for these rows.  `scale_log2` is
// scale*log2(e), or 0 for a row of length 0 (every valid key then weighs
// the same).  The products of one k-step are independent, so the tensor
// cores see up to eight of them in a row.
template <int HD, bool MASK>
__device__ __forceinline__ void fwd_tile(const bf16 (*kt)[HD + kPad],
                                         const bf16 (*vt)[HD + kPad],
                                         const uint32_t (&qa)[HD / 16][4],
                                         float (&acc)[HD / 8][4],
                                         float (&m)[2], float (&l)[2],
                                         int tile_keys, float scale_log2,
                                         int lane) {
  constexpr int kSteps = HD / 16;         // k-steps of q k^T
  constexpr int kDimTiles = HD / 8;       // n-tiles of P v
  constexpr int kKeyTiles = kBlockK / 8;  // n-tiles of q k^T
  const int tq = lane % 4;

  // S = q k^T for 16 rows x 64 keys; one ldmatrix gives the B fragments
  // of key tiles j and j + 1 at one k-step: lanes 0-7 / 8-15 / 16-23 /
  // 24-31 address (keys +0, d +0), (keys +0, d +8), (keys +8, d +0),
  // (keys +8, d +8)
  float s[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j)
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
#pragma unroll
    for (int j = 0; j < kKeyTiles; j += 2) {
      uint32_t bk[4];
      ldmatrix_x4(bk, &kt[(j + lane / 16) * 8 + lane % 8]
                         [st * 16 + (lane / 8 % 2) * 8]);
      mma_bf16(s[j], qa[st], bk[0], bk[1]);
      mma_bf16(s[j + 1], qa[st], bk[2], bk[3]);
    }
  }

  // online softmax in log2 units (a row's four threads share its max);
  // the max is taken on the raw scores, scale_log2 >= 0
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && j * 8 + tq * 2 + (e & 1) >= tile_keys) s[j][e] = -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], __fmul_rn(mx[r], scale_log2));
    corr[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // x = s * scale_log2 rounded (`__fmul_rn` is never fused into an
      // FMA): the x the backward recomputes, and exactly m at the max
      float p = exp2_ftz(__fmul_rn(s[j][e], scale_log2) - m[e >> 1]);
      // a missing key weighs 0 (at length 0, -inf * 0 would be NaN)
      if (MASK && j * 8 + tq * 2 + (e & 1) >= tile_keys) p = 0.f;
      s[j][e] = p;
      l[e >> 1] += p;
    }
  }
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j) {
    acc[j][0] *= corr[0];
    acc[j][1] *= corr[0];
    acc[j][2] *= corr[1];
    acc[j][3] *= corr[1];
  }

  // o += P v, P as head + tail in bf16; S's C fragments are P's A
  // fragments (keys 16*st .. 16*st + 15 are key tiles 2*st, 2*st + 1)
#pragma unroll
  for (int st = 0; st < kBlockK / 16; ++st) {
    uint32_t ph[4], pt[4];
    split_pair(s[2 * st][0], s[2 * st][1], ph[0], pt[0]);
    split_pair(s[2 * st][2], s[2 * st][3], ph[1], pt[1]);
    split_pair(s[2 * st + 1][0], s[2 * st + 1][1], ph[2], pt[2]);
    split_pair(s[2 * st + 1][2], s[2 * st + 1][3], ph[3], pt[3]);
    // lanes 0-7 / 8-15 / 16-23 / 24-31 address matrices (keys +0, dims
    // +0), (keys +8, dims +0), (keys +0, dims +8), (keys +8, dims +8)
    const int key = st * 16 + (lane / 8 % 2) * 8 + lane % 8;
    uint32_t bv[kDimTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kDimTiles; j += 2) {
      ldmatrix_x4_trans(bv[j / 2], &vt[key][(j + lane / 16) * 8]);
    }
#pragma unroll
    for (int j = 0; j < kDimTiles; j += 2) {
      mma_bf16(acc[j], ph, bv[j / 2][0], bv[j / 2][1]);
      mma_bf16(acc[j + 1], ph, bv[j / 2][2], bv[j / 2][3]);
    }
#pragma unroll
    for (int j = 0; j < kDimTiles; j += 2) {
      mma_bf16(acc[j], pt, bv[j / 2][0], bv[j / 2][1]);
      mma_bf16(acc[j + 1], pt, bv[j / 2][2], bv[j / 2][3]);
    }
  }
}

// Shared memory of the bf16 forward: q (128 rows), then two stages of K
// and of V (64 rows each), rows padded to HD + kPad
template <int HD>
constexpr int fwd_smem_bytes() {
  return (kRows + 4 * kBlockK) * (HD + kPad) * sizeof(bf16);
}

// Grid: ceil(T/128) query tiles x B*H, query tile fastest (head-major);
// kThreads threads, fwd_smem_bytes<HD>() of dynamic shared memory.
template <int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse,
                          const int* __restrict__ lengths, int n_heads,
                          int seq, int n_qtiles, Strides sq, Strides sk,
                          Strides sv, Strides so, float scale_log2) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*qs)[kLd] = reinterpret_cast<bf16 (*)[kLd]>(smem);
  bf16 (*ks)[kLd] = qs + kRows;     // stage s: ks + s * kBlockK
  bf16 (*vs)[kLd] = ks + 2 * kBlockK;  // stage s: vs + s * kBlockK

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row
  const int tq = lane % 4;  // fragment column pair
  const int bh = blockIdx.x / n_qtiles;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int q0 = blockIdx.x % n_qtiles * kRows;
  const int wrow = q0 + warp * 16;  // this warp's first row
  const bool live = wrow < seq;     // else it only loads and waits

  const int len = lengths != nullptr ? lengths[b] : seq;
  const bool all_masked = len < 1;
  // keys the rows must visit: the valid ones, or all T when none is valid
  const int n_keys = all_masked ? seq : min(len, seq);
  const int n_tiles = (n_keys + kBlockK - 1) / kBlockK;
  // length 0: every key scores the constant -1e30, so P is uniform; the
  // tiles run with scale 0 and the log-sum-exp adds the constant back
  const float row_scale = all_masked ? 0.f : scale_log2;

  const bf16* kbase = k + b * sk.b + h * sk.h;
  const bf16* vbase = v + b * sv.b + h * sv.h;
  // q and K/V tile 0: group 0
  stage_async<HD, VEC>(qs, q + b * sq.b + h * sq.h, sq, q0, kRows, seq);
  stage_async<HD, VEC>(ks, kbase, sk, 0, kBlockK, seq);
  stage_async<HD, VEC>(vs, vbase, sv, 0, kBlockK, seq);
  cp_async_commit();

  uint32_t qa[HD / 16][4];
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows wrow + g, wrow + g + 8
  float l[2] = {0.f, 0.f};              // this thread's part of the sums

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    // tile t + 1 into the other stage (its last reader, tile t - 1, is
    // done: the barrier that ended the previous step); always commit, so
    // that waiting for all but one group means tile t has landed
    if (t + 1 < n_tiles) {
      const int k1 = (t + 1) * kBlockK;
      stage_async<HD, VEC>(ks + (stage ^ 1) * kBlockK, kbase, sk, k1,
                           kBlockK, seq);
      stage_async<HD, VEC>(vs + (stage ^ 1) * kBlockK, vbase, sv, k1,
                           kBlockK, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      if (t == 0) {
        // q's A fragments of this warp's rows, kept for every tile: lanes
        // 0-15 address rows +0..15 at d +0, lanes 16-31 at d +8
#pragma unroll
        for (int st = 0; st < HD / 16; ++st) {
          ldmatrix_x4(qa[st], &qs[warp * 16 + lane % 16]
                                 [st * 16 + (lane / 16) * 8]);
        }
      }
      const int tile_keys = n_keys - t * kBlockK;
      const bf16 (*kt)[kLd] = ks + stage * kBlockK;
      const bf16 (*vt)[kLd] = vs + stage * kBlockK;
      if (tile_keys < kBlockK) {
        fwd_tile<HD, true>(kt, vt, qa, acc, m, l, tile_keys, row_scale,
                           lane);
      } else {
        fwd_tile<HD, false>(kt, vt, qa, acc, m, l, tile_keys, row_scale,
                            lane);
      }
    }
    __syncthreads();
  }
  if (!live) return;

  // o = acc / sum, staged through this warp's own q rows (no other warp
  // reads them), then written as 16-byte row chunks
  bf16 (*os)[kLd] = qs + warp * 16;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    const int row = wrow + g + r * 8;
    if (lse != nullptr && tq == 0 && row < seq) {
      // log2 units, as the bf16 backward reads it
      lse[bh * seq + row] =
          (all_masked ? kMaskValue * kLog2e : m[r]) + log2f(sum);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(&os[g + r * 8][j * 8 + tq * 2]) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv,
                                acc[j][2 * r + 1] * inv);
    }
  }
  __syncwarp();
  bf16* obase = o + b * so.b + h * so.h;
  for (int idx = lane; idx < 16 * HD / 8; idx += 32) {
    const int r = idx / (HD / 8);
    const int d = idx % (HD / 8) * 8;
    const int row = wrow + r;
    if (row >= seq) continue;
    if (VEC) {
      *reinterpret_cast<uint4*>(obase + row * so.t + d) =
          *reinterpret_cast<const uint4*>(&os[r][d]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        obase[row * so.t + (d + i) * so.d] = os[r][d + i];
      }
    }
  }
}

// ------------------------------------------------------ float32 forward
//
// 128 threads own a 64-row query tile.  Thread (rg, cg), rg = 0..15 (four
// row groups per warp), cg = 0..7 (its lane within the group of eight),
// owns rows rg + 16a (a = 0..3) of S and O: keys cg + 8i (i = 0..7) of
// each 64-key tile of S = q k^T, and HD/8 dims of O.  A step of 4 dims of
// q k^T costs 4 + 8 float4 loads for 128 FMAs, a key of P v 1 + HD/32
// float4 loads for HD/2 FMAs; rows padded by 4 floats put the eight keys
// or four rows that one load touches on distinct banks.  P passes through
// shared memory as P^T, so a key's four rows of one thread are one
// float4.  The row max and the row sum are reduced over the eight lanes
// of a row group by `__shfl_xor_sync`.

// 16 bytes from global to shared memory without registers; zeros when
// !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 64 rows from r0 of one (b, h) slice into shared memory (zero at and past
// `limit`), by the whole block: `cp.async` when VEC, else synchronous
// strided loads
template <int HD, bool VEC>
__device__ __forceinline__ void stage_f32(float (*dst)[HD + kF32Pad],
                                          const float* base, Strides s,
                                          int r0, int limit) {
  for (int idx = threadIdx.x; idx < kF32Rows * HD / 4; idx += kF32Threads) {
    const int j = idx / (HD / 4);
    const int d = idx % (HD / 4) * 4;
    const int r = r0 + j;
    const bool valid = r < limit;
    if (VEC) {
      cp_async16(&dst[j][d], valid ? base + r * s.t + d : base, valid);
    } else {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) {
        const float* p = base + r * s.t + d * s.d;
        x = make_float4(p[0], p[s.d], p[2 * s.d], p[3 * s.d]);
      }
      *reinterpret_cast<float4*>(&dst[j][d]) = x;
    }
  }
}

// dim of this thread's O element e (0 <= e < HD/8): float4 chunks 32
// apart at hd 32 and 64, one float2 at hd 16
template <int HD>
__device__ __forceinline__ int f32_dim(int cg, int e) {
  return HD >= 32 ? e / 4 * 32 + cg * 4 + e % 4 : cg * (HD / 8) + e;
}

// o += P v for key j: the thread's four rows of P^T as one float4, its
// HD/8 dims of V
template <int HD>
__device__ __forceinline__ void f32_pv_key(const float (*pt)[kF32Rows +
                                                             kF32Pad],
                                           const float (*vt)[HD + kF32Pad],
                                           float (&acc)[4][HD / 8], int j,
                                           int rg, int cg) {
  const float4 p4 = *reinterpret_cast<const float4*>(&pt[j][4 * rg]);
  const float p[4] = {p4.x, p4.y, p4.z, p4.w};
  if (HD >= 32) {
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) {
      const float4 vv =
          *reinterpret_cast<const float4*>(&vt[j][32 * c + 4 * cg]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][4 * c + 0] = fmaf(p[a], vv.x, acc[a][4 * c + 0]);
        acc[a][4 * c + 1] = fmaf(p[a], vv.y, acc[a][4 * c + 1]);
        acc[a][4 * c + 2] = fmaf(p[a], vv.z, acc[a][4 * c + 2]);
        acc[a][4 * c + 3] = fmaf(p[a], vv.w, acc[a][4 * c + 3]);
      }
    }
  } else {
    const float2 vv = *reinterpret_cast<const float2*>(&vt[j][2 * cg]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      acc[a][0] = fmaf(p[a], vv.x, acc[a][0]);
      acc[a][1] = fmaf(p[a], vv.y, acc[a][1]);
    }
  }
}

// One K/V tile for the block's 64 rows: S = q k^T, the online softmax in
// log2 units, o += P v.  Keys at and past `tile_keys` do not exist for
// these rows.  `scale_log2` is scale*log2(e), or 0 for a row of length 0
// (every key then weighs the same).  Holds a barrier between P's stores
// and P v.
template <int HD>
__device__ __forceinline__ void f32_tile(const float (*qs)[HD + kF32Pad],
                                         const float (*kt)[HD + kF32Pad],
                                         const float (*vt)[HD + kF32Pad],
                                         float (*pt)[kF32Rows + kF32Pad],
                                         float (&acc)[4][HD / 8],
                                         float (&m)[4], float (&l)[4],
                                         int tile_keys, float scale_log2,
                                         int rg, int cg) {
  float s[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[a][i] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 qv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      qv[a] = *reinterpret_cast<const float4*>(&qs[rg + 16 * a][d]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 kv = *reinterpret_cast<const float4*>(&kt[cg + 8 * i][d]);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        s[a][i] = fmaf(qv[a].x, kv.x, s[a][i]);
        s[a][i] = fmaf(qv[a].y, kv.y, s[a][i]);
        s[a][i] = fmaf(qv[a].z, kv.z, s[a][i]);
        s[a][i] = fmaf(qv[a].w, kv.w, s[a][i]);
      }
    }
  }

  // online softmax in log2 units: the max on the raw scores (scale_log2
  // >= 0), p = 2^(s * scale_log2 - m) by one FMA and one MUFU op; a
  // missing key weighs 0 (at length 0, -inf * 0 would be NaN)
  const bool mask = tile_keys < kBlockK;
  float corr[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (!(mask && cg + 8 * i >= tile_keys)) mx = fmaxf(mx, s[a][i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m[a], mx * scale_log2);
    corr[a] = exp2_ftz(m[a] - m_new);
    m[a] = m_new;
    l[a] *= corr[a];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool gone = mask && cg + 8 * i >= tile_keys;
    float p[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      p[a] = gone ? 0.f : exp2_ftz(fmaf(s[a][i], scale_log2, -m[a]));
      l[a] += p[a];
    }
    *reinterpret_cast<float4*>(&pt[cg + 8 * i][4 * rg]) =
        make_float4(p[0], p[1], p[2], p[3]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int e = 0; e < HD / 8; ++e) acc[a][e] *= corr[a];
  }
  __syncthreads();  // P^T complete

  // o += P v over the tile's keys: a full tile with a fixed trip count
  if (tile_keys == kBlockK) {
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) f32_pv_key<HD>(pt, vt, acc, j, rg, cg);
  } else {
#pragma unroll 4
    for (int j = 0; j < tile_keys; ++j) {
      f32_pv_key<HD>(pt, vt, acc, j, rg, cg);
    }
  }
}

// Shared memory of the float32 forward: q (64 rows), two stages of K and
// of V (64 rows each), rows padded to HD + 4; then P^T (64 keys x 64 rows,
// padded to 68)
template <int HD>
constexpr int f32_smem_bytes() {
  return (5 * kF32Rows * (HD + kF32Pad) + kBlockK * (kF32Rows + kF32Pad)) *
         static_cast<int>(sizeof(float));
}

// Grid: n_splits key splits x ceil(T/64) query tiles x B*H, split fastest
// (head-major); kF32Threads threads, f32_smem_bytes<HD>() of dynamic
// shared memory.  Split s visits keys [s * split_keys, (s + 1) *
// split_keys) of the row's valid keys; a split past them adds nothing
// (m = -inf, l = 0).  One split writes o and the lse; several write their
// unnormalised o, m (log2 units) and l to `part` for the combine kernel.
template <int HD, bool VEC>
__global__ void __launch_bounds__(kF32Threads, 2)
attention_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, float* __restrict__ part,
                         const int* __restrict__ lengths, int n_heads,
                         int seq, int n_qtiles, int n_splits, int split_keys,
                         int n_bh, Strides sq, Strides sk, Strides sv,
                         Strides so, float scale_log2) {
  constexpr int kLd = HD + kF32Pad;
  extern __shared__ __align__(16) unsigned char smem[];
  float (*qs)[kLd] = reinterpret_cast<float (*)[kLd]>(smem);
  float (*ks)[kLd] = qs + kF32Rows;     // stage s: ks + s * kBlockK
  float (*vs)[kLd] = ks + 2 * kBlockK;  // stage s: vs + s * kBlockK
  float (*pt)[kF32Rows + kF32Pad] =
      reinterpret_cast<float (*)[kF32Rows + kF32Pad]>(vs + 2 * kBlockK);

  const int lane = threadIdx.x % 32;
  const int rg = threadIdx.x / 32 * 4 + lane / 8;  // rows rg + 16a
  const int cg = lane % 8;
  const int split = blockIdx.x % n_splits;
  const int tile = blockIdx.x / n_splits;
  const int bh = tile / n_qtiles;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int q0 = tile % n_qtiles * kF32Rows;

  const int len = lengths != nullptr ? lengths[b] : seq;
  const bool all_masked = len < 1;
  // keys the rows must visit: the valid ones, or all T when none is valid
  const int n_keys = all_masked ? seq : min(len, seq);
  const int k_begin = split * split_keys;
  const int k_end = min(k_begin + split_keys, n_keys);
  // length 0: every key scores the constant -1e30, so P is uniform; the
  // tiles run with scale 0 and the log-sum-exp adds the constant back
  const float row_scale = all_masked ? 0.f : scale_log2;

  float acc[4][HD / 8];
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < HD / 8; ++e) acc[a][e] = 0.f;
  }

  if (k_begin < k_end) {
    const float* kbase = k + b * sk.b + h * sk.h;
    const float* vbase = v + b * sv.b + h * sv.h;
    // q and K/V tile 0: group 0
    stage_f32<HD, VEC>(qs, q + b * sq.b + h * sq.h, sq, q0, seq);
    stage_f32<HD, VEC>(ks, kbase, sk, k_begin, seq);
    stage_f32<HD, VEC>(vs, vbase, sv, k_begin, seq);
    cp_async_commit();
    const int n_tiles = (k_end - k_begin + kBlockK - 1) / kBlockK;
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t & 1;
      // tile t has landed, and every thread is done with tile t - 1 (its
      // stage and P^T): tile t + 1 goes into that stage while t runs
      cp_async_wait<0>();
      __syncthreads();
      if (t + 1 < n_tiles) {
        const int k1 = k_begin + (t + 1) * kBlockK;
        stage_f32<HD, VEC>(ks + (stage ^ 1) * kBlockK, kbase, sk, k1, seq);
        stage_f32<HD, VEC>(vs + (stage ^ 1) * kBlockK, vbase, sv, k1, seq);
      }
      cp_async_commit();
      f32_tile<HD>(qs, ks + stage * kBlockK, vs + stage * kBlockK, pt, acc,
                   m, l, min(kBlockK, k_end - k_begin - t * kBlockK),
                   row_scale, rg, cg);
    }
  }

  // the row sums over the eight lanes of a row group (every lane gets the
  // same bits: the butterfly adds commutative pairs)
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 1);
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 2);
    l[a] += __shfl_xor_sync(0xffffffffu, l[a], 4);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + rg + 16 * a;
    if (row >= seq) continue;
    if (n_splits == 1) {
      const float inv = 1.f / l[a];
      float* op = o + b * so.b + row * so.t + h * so.h;
      if (VEC && HD >= 32) {
#pragma unroll
        for (int c = 0; c < HD / 32; ++c) {
          *reinterpret_cast<float4*>(op + 32 * c + 4 * cg) = make_float4(
              acc[a][4 * c] * inv, acc[a][4 * c + 1] * inv,
              acc[a][4 * c + 2] * inv, acc[a][4 * c + 3] * inv);
        }
      } else {
#pragma unroll
        for (int e = 0; e < HD / 8; ++e) {
          op[f32_dim<HD>(cg, e) * so.d] = acc[a][e] * inv;
        }
      }
      if (lse != nullptr && cg == 0) {
        // natural-log units, as the float32 backward reads it
        lse[bh * seq + row] =
            (all_masked ? kMaskValue : m[a] * kLn2) + logf(l[a]);
      }
    } else {
      const long long r =
          (static_cast<long long>(split) * n_bh + bh) * seq + row;
      float* pp = part + r * HD;
#pragma unroll
      for (int e = 0; e < HD / 8; ++e) pp[f32_dim<HD>(cg, e)] = acc[a][e];
      if (cg == 0) {
        float2* ml = reinterpret_cast<float2*>(
            part + static_cast<long long>(n_splits) * n_bh * seq * HD);
        ml[r] = make_float2(m[a], l[a]);
      }
    }
  }
}

// The key splits' partial rows combined by their log-sum-exps, in split
// order: M = max m_s, L = sum l_s 2^(m_s - M), o = sum acc_s 2^(m_s - M)
// / L.  A split with l = 0 (past the row's keys) adds nothing.  One thread
// per row and four dims.
template <int HD, bool VEC>
__global__ void __launch_bounds__(kCombineThreads)
attention_fwd_f32_combine_kernel(const float* __restrict__ part,
                                 float* __restrict__ o,
                                 float* __restrict__ lse,
                                 const int* __restrict__ lengths,
                                 int n_heads, int seq, int n_splits,
                                 int n_bh, Strides so) {
  const long long n_rows = static_cast<long long>(n_bh) * seq;
  const long long idx =
      static_cast<long long>(blockIdx.x) * kCombineThreads + threadIdx.x;
  const long long r = idx / (HD / 4);  // bh * seq + row
  const int d = static_cast<int>(idx % (HD / 4)) * 4;
  if (r >= n_rows) return;
  const float2* ml =
      reinterpret_cast<const float2*>(part + n_splits * n_rows * HD);
  float mx = -INFINITY;
  for (int s = 0; s < n_splits; ++s) {
    const float2 x = ml[s * n_rows + r];
    if (x.y > 0.f) mx = fmaxf(mx, x.x);
  }
  float sum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_splits; ++s) {
    const float2 x = ml[s * n_rows + r];
    if (!(x.y > 0.f)) continue;
    const float w = exp2_ftz(x.x - mx);
    sum = fmaf(x.y, w, sum);
    const float4 p =
        *reinterpret_cast<const float4*>(part + (s * n_rows + r) * HD + d);
    acc.x = fmaf(w, p.x, acc.x);
    acc.y = fmaf(w, p.y, acc.y);
    acc.z = fmaf(w, p.z, acc.z);
    acc.w = fmaf(w, p.w, acc.w);
  }
  const int bh = static_cast<int>(r / seq);
  const int row = static_cast<int>(r % seq);
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const float inv = 1.f / sum;
  float* op = o + b * so.b + row * so.t + h * so.h + d * so.d;
  if (VEC) {
    *reinterpret_cast<float4*>(op) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  } else {
    op[0] = acc.x * inv;
    op[so.d] = acc.y * inv;
    op[2 * so.d] = acc.z * inv;
    op[3 * so.d] = acc.w * inv;
  }
  if (lse != nullptr && d == 0) {
    const bool all_masked = lengths != nullptr && lengths[b] < 1;
    lse[r] = (all_masked ? kMaskValue : mx * kLn2) + logf(sum);
  }
}

// ----------------------------------------------------------- backward
//
// Two kernels for each type, in two grids without atomics: a query-tile
// grid writes dQ (and D for the other grid), a key-tile grid loops over the
// query tiles for dK and dV.  Every output element is written by one
// thread, in a fixed order, so results are bit-identical from run to run.
// The float32 pair has its own section after this one.
//
// bfloat16, on the tensor cores (`mma.sync` m16n8k16, bf16 operands,
// float32 accumulation), built as the bf16 forward is:
//   dq kernel, over query tiles: D_i = dO_i . O_i in float32 from the
//     forward's output O (hd operations a row), then one pass over the
//     keys: S = q k^T, dP = dO V^T, P, dS = P o (dP - D), dQ += dS K;
//     writes dQ and rowsum(dP o P), summed in the same pass;
//   dkdv kernel, over key tiles, one pass over the queries (with their
//     lse2 and rowsum(dP o P)): S^T = k q^T, dP^T = v dO^T, P^T, dS^T,
//     dV += P^T dO, dK += dS^T q.
// P = 2^(x - lse2), x = S * scale*log2(e) rounded, the forward's own
// expression (so a row with one key gets P = 1 exactly).  S and dP take the
// bf16 inputs, which are exact, so P, dP and dS are float32 as in
// `_bwd_kernel`; P and dS enter the products that follow as a bf16 head
// and tail (two products each).  D = dO . O equals rowsum(dP o P) in exact
// arithmetic (O = P V), but O is the forward's bf16 output, so that D
// carries O's rounding (2^-9 relative an element).  dQ_i meets it once,
// scaled by P_i K; dK_j would sum it over every query row (a key of a
// short row sees all T of them): the card tests found 0.024 against the
// 2e-2 tolerance at T=826, hd 16, length 3.  So dkdv reads the float32
// rowsum(dP o P) that the dq kernel sums as it goes, one FMA a score.
// Per backward: 10 products of T^2*hd (dq: S, dP, dS K twice; dkdv: S, dP,
// P^T dO twice, dS^T q twice) where the function needs 5.
//
// What the design does about the first version's faults (two passes over
// the keys in dq and a third S and dP in dkdv; 12 products; synchronous
// staging through registers; 32-bit B-fragment loads; 64-row blocks with
// (b, h) fastest):
// - D from O and dO: no first pass over the keys; S and dP are computed
//   once in each kernel.
// - 128 rows a block (eight warps of 16: query rows in dq, key rows in
//   dkdv) held in shared memory; a head-major 1-D grid, row tile fastest,
//   so the blocks of one (b, h) run together and share its K/V (dq) or
//   Q/dO (dkdv) through L2.
// - The streamed 64-row tiles (K/V; Q, dO, lse2, D) sit in two
//   dynamic-shared-memory stages filled by `cp.async` with zero-fill: tile
//   t + 1 is in flight while tile t is multiplied.  Views whose rows are
//   not 16-byte vectors take a synchronous loop into the same layout
//   (template flag VEC).  Above 48 KB of shared memory at hd 64 (74,752
//   bytes), opted in before each launch.
// - A and B fragments by `ldmatrix`, the B fragments of the products by a
//   streamed tile (dS K, P^T dO, dS^T q) by `ldmatrix.trans`; the eight
//   products of a k-step of S and dP are independent.  Each 64-row tile is
//   taken in steps of 16 rows, so S and dP hold 16 registers a thread.
//   Steps of 32 rows spilled in both kernels at hd 64 (dkdv holds dK and
//   dV, 64 registers); one block per SM instead of two removed the spills
//   and ran slower.
// - dQ, dK and dV leave through shared memory as 16-byte rows.
// Registers and spills (`ptxas -v`, which `chip_smoke.py` phase 2 prints),
// at hd 64 with 16-byte rows: dq 128 registers, no spills; dkdv 128
// registers, 12 bytes spilled (36 loaded); 88-128 registers and no spills
// elsewhere.

constexpr int kStep = 16;  // streamed rows per product step

// 4 bytes from global to shared memory; zero when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// `rows` floats from r0 of one (b, h) row of a (B*H, T) array into shared
// memory (zero at and past `limit`), by the whole block
__device__ __forceinline__ void stage_floats(float* dst, const float* base,
                                             int r0, int rows, int limit) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const bool valid = r0 + i < limit;
    cp_async4(dst + i, valid ? base + r0 + i : base, valid);
  }
}

// c = a b^T and c2 = a2 b2^T for one warp: a, a2 its 16 rows, b, b2 8*NT
// rows (NT n-tiles of 8), all HD wide in shared memory.  Lanes 0-15
// address a's rows +0..15 at d +0, lanes 16-31 at d +8; b as K in the
// forward.  The 2*NT products of a k-step are independent.
template <int HD, int NT>
__device__ __forceinline__ void mma_abt2(float (&c)[NT][4],
                                         const bf16 (*a)[HD + kPad],
                                         const bf16 (*b)[HD + kPad],
                                         float (&c2)[NT][4],
                                         const bf16 (*a2)[HD + kPad],
                                         const bf16 (*b2)[HD + kPad],
                                         int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    c2[j][0] = c2[j][1] = c2[j][2] = c2[j][3] = 0.f;
  }
#pragma unroll
  for (int st = 0; st < HD / 16; ++st) {
    uint32_t fa[4], fa2[4], fb[NT / 2][4], fb2[NT / 2][4];
    ldmatrix_x4(fa, &a[lane % 16][st * 16 + (lane / 16) * 8]);
    ldmatrix_x4(fa2, &a2[lane % 16][st * 16 + (lane / 16) * 8]);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const int row = (j + lane / 16) * 8 + lane % 8;
      const int col = st * 16 + (lane / 8 % 2) * 8;
      ldmatrix_x4(fb[j / 2], &b[row][col]);
      ldmatrix_x4(fb2[j / 2], &b2[row][col]);
    }
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      mma_bf16(c[j], fa, fb[j / 2][0], fb[j / 2][1]);
      mma_bf16(c[j + 1], fa, fb[j / 2][2], fb[j / 2][3]);
      mma_bf16(c2[j], fa2, fb2[j / 2][0], fb2[j / 2][1]);
      mma_bf16(c2[j + 1], fa2, fb2[j / 2][2], fb2[j / 2][3]);
    }
  }
}

// acc (16 rows x HD) += x (16 rows x 8*NT, C fragments, as a bf16 head
// and tail) * tile (8*NT rows x HD); the tile's B fragments by
// ldmatrix.trans, as V's in the forward
template <int HD, int NT>
__device__ __forceinline__ void mma_xb(float (&acc)[HD / 8][4],
                                       const float (&x)[NT][4],
                                       const bf16 (*tile)[HD + kPad],
                                       int lane) {
  constexpr int kDimTiles = HD / 8;
#pragma unroll
  for (int st = 0; st < NT / 2; ++st) {
    uint32_t xh[4], xt[4];
    split_pair(x[2 * st][0], x[2 * st][1], xh[0], xt[0]);
    split_pair(x[2 * st][2], x[2 * st][3], xh[1], xt[1]);
    split_pair(x[2 * st + 1][0], x[2 * st + 1][1], xh[2], xt[2]);
    split_pair(x[2 * st + 1][2], x[2 * st + 1][3], xh[3], xt[3]);
    const int row = st * 16 + (lane / 8 % 2) * 8 + lane % 8;
    uint32_t bt[kDimTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kDimTiles; j += 2) {
      ldmatrix_x4_trans(bt[j / 2], &tile[row][(j + lane / 16) * 8]);
    }
#pragma unroll
    for (int j = 0; j < kDimTiles; j += 2) {
      mma_bf16(acc[j], xh, bt[j / 2][0], bt[j / 2][1]);
      mma_bf16(acc[j + 1], xh, bt[j / 2][2], bt[j / 2][3]);
    }
#pragma unroll
    for (int j = 0; j < kDimTiles; j += 2) {
      mma_bf16(acc[j], xt, bt[j / 2][0], bt[j / 2][1]);
      mma_bf16(acc[j + 1], xt, bt[j / 2][2], bt[j / 2][3]);
    }
  }
}

// kStep keys for one warp's 16 query rows: dQ += dS K, and this
// thread's part of rowsum(dP o P) into dsum.  MASK: keys at and past
// `keys` do not exist for these rows.
template <int HD, bool MASK>
__device__ __forceinline__ void dq_step(const bf16 (*qw)[HD + kPad],
                                        const bf16 (*dow)[HD + kPad],
                                        const bf16 (*kt)[HD + kPad],
                                        const bf16 (*vt)[HD + kPad],
                                        float (&acc)[HD / 8][4],
                                        float (&dsum)[2],
                                        const float (&lse2)[2],
                                        const float (&dd)[2], int keys,
                                        float scale_log2, int lane) {
  constexpr int kNT = kStep / 8;
  const int tq = lane % 4;
  float s[kNT][4], dp[kNT][4];
  mma_abt2<HD, kNT>(s, qw, kt, dp, dow, vt, lane);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = exp2_ftz(__fmul_rn(s[j][e], scale_log2) - lse2[e >> 1]);
      if (MASK && j * 8 + tq * 2 + (e & 1) >= keys) p = 0.f;
      dsum[e >> 1] = fmaf(p, dp[j][e], dsum[e >> 1]);
      s[j][e] = p * (dp[j][e] - dd[e >> 1]);  // dS
    }
  }
  mma_xb<HD, kNT>(acc, s, kt, lane);
}

// kStep queries (with their lse2 and D) for one warp's 16 keys:
// dV += P^T dO, dK += dS^T q.  Query rows past T are zero in qt, dot, lse2
// and D, so they add 0.  At length 0 (`all_masked`) P is `uniform` over the
// T keys and dS = 0.
template <int HD>
__device__ __forceinline__ void dkdv_step(const bf16 (*kw)[HD + kPad],
                                          const bf16 (*vw)[HD + kPad],
                                          const bf16 (*qt)[HD + kPad],
                                          const bf16 (*dot)[HD + kPad],
                                          const float* lse2, const float* dd,
                                          float (&acc_k)[HD / 8][4],
                                          float (&acc_v)[HD / 8][4],
                                          float scale_log2, bool all_masked,
                                          float uniform, int lane) {
  constexpr int kNT = kStep / 8;
  const int tq = lane % 4;
  float s[kNT][4], dp[kNT][4];  // S^T and dP^T, then P^T and dS^T
  mma_abt2<HD, kNT>(s, kw, qt, dp, vw, dot, lane);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = j * 8 + tq * 2;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
    const float2 d2 = *reinterpret_cast<const float2*>(dd + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = uniform, ds = 0.f;
      if (!all_masked) {
        const float x = __fmul_rn(s[j][e], scale_log2);
        p = exp2_ftz(x - ((e & 1) ? l2.y : l2.x));
        ds = p * (dp[j][e] - ((e & 1) ? d2.y : d2.x));
      }
      s[j][e] = p;
      dp[j][e] = ds;
    }
  }
  mma_xb<HD, kNT>(acc_v, s, dot, lane);
  mma_xb<HD, kNT>(acc_k, dp, qt, lane);
}

// Rows g, g + 8 of acc * mul (zero at and past row `valid`) into a warp's
// 16 staging rows
template <int HD>
__device__ __forceinline__ void frag_rows(bf16 (*rows)[HD + kPad],
                                          const float (&acc)[HD / 8][4],
                                          float mul, int valid, int lane) {
  const int g = lane / 4;
  const int tq = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = g + r * 8 < valid;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(&rows[g + r * 8][j * 8 + tq * 2]) =
          __floats2bfloat162_rn(ok ? acc[j][2 * r] * mul : 0.f,
                                ok ? acc[j][2 * r + 1] * mul : 0.f);
    }
  }
}

// A warp's 16 staging rows to rows row0 .. row0 + 15 (those below `limit`)
// of one (b, h) slice, as 16-byte row chunks
template <int HD, bool VEC>
__device__ __forceinline__ void write_rows(bf16* base, Strides s,
                                           const bf16 (*rows)[HD + kPad],
                                           int row0, int limit, int lane) {
  for (int idx = lane; idx < 16 * HD / 8; idx += 32) {
    const int r = idx / (HD / 8);
    const int d = idx % (HD / 8) * 8;
    const int row = row0 + r;
    if (row >= limit) continue;
    if (VEC) {
      *reinterpret_cast<uint4*>(base + row * s.t + d) =
          *reinterpret_cast<const uint4*>(&rows[r][d]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        base[row * s.t + (d + i) * s.d] = rows[r][d + i];
      }
    }
  }
}

// Shared memory of either bf16 backward kernel: 2 x 128 resident rows and
// two stages of two 64-row streamed tiles, rows padded to HD + kPad; then
// (dkdv) two stages of 64 lse2 and 64 D values
template <int HD>
constexpr int bwd_smem_bytes() {
  return (2 * kRows + 4 * kBlockK) * (HD + kPad) * sizeof(bf16) +
         4 * kBlockK * sizeof(float);
}

// Grid: ceil(T/128) query tiles x B*H, query tile fastest; kThreads
// threads, bwd_smem_bytes<HD>() of dynamic shared memory.  Writes dQ and
// rowsum(dP o P) (B*H, T) into delta.
template <int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const bf16* __restrict__ out,
                             const float* __restrict__ lse2,
                             const int* __restrict__ lengths,
                             bf16* __restrict__ dq, float* __restrict__ delta,
                             int n_heads, int seq, int n_tiles, Strides sq,
                             Strides sk, Strides sv, Strides sdo, Strides so,
                             Strides sdq, float scale_log2, float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*qs)[kLd] = reinterpret_cast<bf16 (*)[kLd]>(smem);
  bf16 (*dos)[kLd] = qs + kRows;
  bf16 (*ks)[kLd] = dos + kRows;       // stage s: ks + s * kBlockK
  bf16 (*vs)[kLd] = ks + 2 * kBlockK;  // stage s: vs + s * kBlockK

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int r0 = blockIdx.x % n_tiles * kRows;
  const int wrow = r0 + warp * 16;  // this warp's first row
  const bool live = wrow < seq;     // else it only loads and waits
  const int len = lengths != nullptr ? lengths[b] : seq;
  const int n_keys = min(len, seq);
  // length 0: the scores are the constant -1e30, so dQ = 0 (no key tiles)
  const int n_tiles_k = n_keys > 0 ? (n_keys + kBlockK - 1) / kBlockK : 0;

  const bf16* dobase = dout + b * sdo.b + h * sdo.h;
  const bf16* obase = out + b * so.b + h * so.h;
  // D = dO . O and lse2 of rows wrow + g and wrow + g + 8: each lane of a
  // row sums a quarter of the dims, then the row's four lanes add up in a
  // fixed order
  float dd[2], row_lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + r * 8;
    float sum = 0.f;
    if (row < seq) {
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) {
        const int d = tq * (HD / 4) + i;
        sum = fmaf(__bfloat162float(dobase[row * sdo.t + d * sdo.d]),
                   __bfloat162float(obase[row * so.t + d * so.d]), sum);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dd[r] = sum;
    row_lse2[r] = row < seq ? lse2[bh * seq + row] : 0.f;
  }

  const bf16* kbase = k + b * sk.b + h * sk.h;
  const bf16* vbase = v + b * sv.b + h * sv.h;
  if (n_tiles_k > 0) {  // q, dO and K/V tile 0: group 0
    stage_async<HD, VEC>(qs, q + b * sq.b + h * sq.h, sq, r0, kRows, seq);
    stage_async<HD, VEC>(dos, dobase, sdo, r0, kRows, seq);
    stage_async<HD, VEC>(ks, kbase, sk, 0, kBlockK, n_keys);
    stage_async<HD, VEC>(vs, vbase, sv, 0, kBlockK, n_keys);
  }
  cp_async_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float dsum[2] = {0.f, 0.f};  // this thread's part of rowsum(dP o P)
  for (int t = 0; t < n_tiles_k; ++t) {
    const int stage = t & 1;
    // tile t + 1 into the other stage (its last reader, tile t - 1, is
    // done: the barrier that ended the previous step); always commit
    if (t + 1 < n_tiles_k) {
      const int k1 = (t + 1) * kBlockK;
      stage_async<HD, VEC>(ks + (stage ^ 1) * kBlockK, kbase, sk, k1,
                           kBlockK, n_keys);
      stage_async<HD, VEC>(vs + (stage ^ 1) * kBlockK, vbase, sv, k1,
                           kBlockK, n_keys);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const int tile_keys = n_keys - t * kBlockK;
#pragma unroll
      for (int k1 = 0; k1 < kBlockK; k1 += kStep) {
        const int keys = tile_keys - k1;
        if (keys <= 0) break;
        const bf16 (*kt)[kLd] = ks + stage * kBlockK + k1;
        const bf16 (*vt)[kLd] = vs + stage * kBlockK + k1;
        if (keys < kStep) {
          dq_step<HD, true>(qs + warp * 16, dos + warp * 16, kt, vt, acc,
                            dsum, row_lse2, dd, keys, scale_log2, lane);
        } else {
          dq_step<HD, false>(qs + warp * 16, dos + warp * 16, kt, vt, acc,
                             dsum, row_lse2, dd, keys, scale_log2, lane);
        }
      }
    }
    __syncthreads();
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + r * 8;
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
    if (tq == 0 && row < seq) delta[bh * seq + row] = dsum[r];
  }
  // dQ staged through this warp's own q rows (no other warp reads them)
  frag_rows<HD>(qs + warp * 16, acc, scale, 16, lane);
  __syncwarp();
  write_rows<HD, VEC>(dq + b * sdq.b + h * sdq.h, sdq, qs + warp * 16, wrow,
                      seq, lane);
}

// Grid: ceil(T/128) key tiles x B*H, key tile fastest; kThreads threads,
// bwd_smem_bytes<HD>() of dynamic shared memory.  Reads the dq kernel's
// rowsum(dP o P) as D.
template <int HD, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse2,
                               const float* __restrict__ delta,
                               const int* __restrict__ lengths,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int n_heads, int seq, int n_tiles, Strides sq,
                               Strides sk, Strides sv, Strides sdo,
                               Strides sdk, Strides sdv, float scale_log2,
                               float scale) {
  constexpr int kLd = HD + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16 (*ks)[kLd] = reinterpret_cast<bf16 (*)[kLd]>(smem);
  bf16 (*vs)[kLd] = ks + kRows;
  bf16 (*qs)[kLd] = vs + kRows;         // stage s: qs + s * kBlockK
  bf16 (*dos)[kLd] = qs + 2 * kBlockK;  // stage s: dos + s * kBlockK
  float* ls = reinterpret_cast<float*>(dos + 2 * kBlockK);  // lse2 stages
  float* ds = ls + 2 * kBlockK;                             // D stages

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int k0 = blockIdx.x % n_tiles * kRows;
  const int wkey = k0 + warp * 16;  // this warp's first key
  const bool live = wkey < seq;
  const int len = lengths != nullptr ? lengths[b] : seq;
  const bool all_masked = len < 1;
  // keys the rows attend to: the valid ones, or all T when none is valid;
  // a block past them has dK = dV = 0 exactly (no row attends to its keys)
  const int n_keys = all_masked ? seq : min(len, seq);
  const int n_tiles_q = k0 < n_keys ? (seq + kBlockK - 1) / kBlockK : 0;
  const float uniform = 1.f / seq;  // P of a length-0 row

  const bf16* qbase = q + b * sq.b + h * sq.h;
  const bf16* dobase = dout + b * sdo.b + h * sdo.h;
  const float* lbase = lse2 + bh * seq;
  const float* dbase = delta + bh * seq;
  if (n_tiles_q > 0) {  // K, V and Q/dO/lse2/D tile 0: group 0
    stage_async<HD, VEC>(ks, k + b * sk.b + h * sk.h, sk, k0, kRows, n_keys);
    stage_async<HD, VEC>(vs, v + b * sv.b + h * sv.h, sv, k0, kRows, n_keys);
    stage_async<HD, VEC>(qs, qbase, sq, 0, kBlockK, seq);
    stage_async<HD, VEC>(dos, dobase, sdo, 0, kBlockK, seq);
    stage_floats(ls, lbase, 0, kBlockK, seq);
    stage_floats(ds, dbase, 0, kBlockK, seq);
  }
  cp_async_commit();

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;
  }
  for (int t = 0; t < n_tiles_q; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles_q) {
      const int q1 = (t + 1) * kBlockK;
      const int o = (stage ^ 1) * kBlockK;
      stage_async<HD, VEC>(qs + o, qbase, sq, q1, kBlockK, seq);
      stage_async<HD, VEC>(dos + o, dobase, sdo, q1, kBlockK, seq);
      stage_floats(ls + o, lbase, q1, kBlockK, seq);
      stage_floats(ds + o, dbase, q1, kBlockK, seq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const int tile_rows = seq - t * kBlockK;
#pragma unroll
      for (int q1 = 0; q1 < kBlockK; q1 += kStep) {
        if (tile_rows <= q1) break;
        const int o = stage * kBlockK + q1;
        dkdv_step<HD>(ks + warp * 16, vs + warp * 16, qs + o, dos + o,
                      ls + o, ds + o, acc_k, acc_v, scale_log2, all_masked,
                      uniform, lane);
      }
    }
    __syncthreads();
  }
  if (!live) return;
  // dK, dV staged through this warp's own K and V rows; keys at and past
  // n_keys get 0
  frag_rows<HD>(ks + warp * 16, acc_k, scale, n_keys - wkey, lane);
  frag_rows<HD>(vs + warp * 16, acc_v, 1.f, n_keys - wkey, lane);
  __syncwarp();
  write_rows<HD, VEC>(dk + b * sdk.b + h * sdk.h, sdk, ks + warp * 16, wkey,
                      seq, lane);
  write_rows<HD, VEC>(dv + b * sdv.b + h * sdv.h, sdv, vs + warp * 16, wkey,
                      seq, lane);
}

// ------------------------------------------------- backward, float32
//
// Replaces `_bwd_kernel` for float32 inputs (the float32 training path:
// `training.precision: 32` with `audio.dropout: 0.0`; the card-vs-CPU
// checks).  Full float32 FMAs on the CUDA cores (no TF32: this route is
// the port's precision reference), in the two grids above, built as the
// float32 forward is: 64-row tiles of 128 threads, each thread owning 4
// rows x 8 columns of a 64 x 64 score tile (rows rg + 16a of the block's
// resident tile, columns cg + 8i of the streamed one) and 4 rows x HD/8
// dims of its outputs.
//   dq kernel, over query tiles: D_i = dO_i . O_i from the forward's
//     float32 output (hd FMAs a row; written to `delta` for dkdv), then
//     one pass over the keys: S = q K^T, dP = dO V^T, P, dS = P o (dP -
//     D) into shared memory as dS^T, dQ += dS K;
//   dkdv kernel, over key tiles, one pass over the queries (with their lse
//     and D): S^T = K q^T, P^T into shared memory, dP^T = V dO^T, dS^T,
//     dV += P^T dO, then dS^T into the same buffer, dK += dS^T q.
// 7 products of T^2*hd, where the function needs 5 (S and dP are formed
// in both kernels).  P = 2^(s * scale*log2(e) - lse*log2(e)), one FMA and
// one `ex2.approx` a score, the float32 forward's own expression, from its
// natural-log lse.  O is float32, so D = dO . O carries no rounding for dK
// to sum over T rows (what made the bf16 dkdv read dq's rowsum(dP o P)).
//
// Bound on an H100 at the training shapes (B=8, H=12, hd=64): operations,
// 10*B*H*T^2*hd at 67 TF/s, 0.0916 ms at T=316 and 0.6257 ms at T=826
// (q, k, v, dO in and dQ, dK, dV out move 7*B*T*H*hd floats, 16 us at
// T=316).  The CUDA cores do one FMA per operand pair, so the design
// counts instruction slots and shared-memory loads.
//
// The design:
// - D from O: S and dP once in each kernel, 7 products (D from rowsum(dP
//   o P) would need a pass over the keys before dQ, and a third S and dP).
// - Register micro-tiles: a step of 4 dims of a score product costs 4 + 8
//   float4 loads for 128 FMAs (the A loads are broadcast to a row group's
//   eight lanes); a row of a product by a streamed tile 1 + HD/32 float4
//   loads for HD/2 FMAs.
// - The streamed 64-row tiles (K/V; Q, dO, lse, D) sit in two stages
//   filled by `cp.async` with zero-fill past T or the keys: tile t + 1 is
//   in flight while tile t is multiplied.  Views whose rows are not
//   16-byte vectors stage synchronously into the same layout (template
//   flag VEC).
// - No padding: each tile's 16-byte chunks are XOR-swizzled by row
//   (`swz_key`), so the eight lanes that read one chunk of eight
//   consecutive rows hit eight bank groups.  That keeps dkdv at 113 KB of
//   dynamic shared memory at hd 64 (dq 112 KB), two blocks per SM in its
//   228 KB, opted in before each launch.
// - dkdv holds dK and dV (64 floats a thread at hd 64): S^T becomes P^T in
//   shared memory before dP^T is formed, so one score tile is live in
//   registers at a time; each thread reads its own P back for dS.
// - A head-major 1-D grid, row tile fastest, so the blocks of one (b, h)
//   run together and share its K/V (dq) or Q/dO (dkdv) through L2.
// Registers and spills (`ptxas -v`, printed by `chip_smoke.py` phase 2) at
// hd 64 with 16-byte rows: dq 230, dkdv 230, no spills; so two resident
// blocks per SM for both (`__launch_bounds__(kF32Threads, 2)`: 2 x 128 x
// 230 registers of 65536, and 2 x 113 KB of 228 KB).  Each
// kernel runs at about half of the 67 TF/s for its own products
// (`scripts/attention_f32_ab.py --profile`, B=8, T=826, NVIDIA H100 80GB
// HBM3 at 700 W): 16-byte shared loads cap a 4 x 8 micro-tile near two
// thirds of the FMA rate (PERF.md section 6).

// The XOR key of row r's 16-byte chunks in a tile of rows of W floats
// (chunk c lies at c ^ key).  Rows of 32 or 64 floats span one or two
// 128-byte lines, so the row's low three bits; rows of 16 floats (two a
// line) take bits 1-2.  Either way rows r and r + 8 share a key, and so do
// rows r and r + 16.
template <int W>
__device__ __forceinline__ int swz_key(int r) {
  return W >= 32 ? (r & 7) : ((r >> 1) & 3);
}

// chunk c of row r of a swizzled tile of rows of W floats
template <int W, typename T>
__device__ __forceinline__ T* swz_at(T* tile, int r, int c) {
  return tile + r * W + 4 * (c ^ swz_key<W>(r));
}

// 64 rows from r0 of one (b, h) slice into a swizzled tile of rows of HD
// floats (zero at and past `limit`), by the whole block: `cp.async` when
// VEC, else synchronous strided loads
template <int HD, bool VEC>
__device__ __forceinline__ void stage_swz(float* dst, const float* base,
                                          Strides s, int r0, int limit) {
  for (int idx = threadIdx.x; idx < kF32Rows * HD / 4; idx += kF32Threads) {
    const int j = idx / (HD / 4);
    const int c = idx % (HD / 4);
    const int r = r0 + j;
    const bool valid = r < limit;
    float* d = swz_at<HD>(dst, j, c);
    if (VEC) {
      cp_async16(d, valid ? base + r * s.t + 4 * c : base, valid);
    } else {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) {
        const float* p = base + r * s.t + 4 * c * s.d;
        x = make_float4(p[0], p[s.d], p[2 * s.d], p[3 * s.d]);
      }
      *reinterpret_cast<float4*>(d) = x;
    }
  }
}

// 64 floats from r0 of one (b, h) row of a (B*H, T) array into shared
// memory (zero at and past `limit`)
__device__ __forceinline__ void stage_row_f32(float* dst, const float* base,
                                              int r0, int limit) {
  if (threadIdx.x < kBlockK) {
    const int r = r0 + threadIdx.x;
    cp_async4(dst + threadIdx.x, r < limit ? base + r : base, r < limit);
  }
}

// c[a][i] = A[rg + 16a] . B[cg + 8i]: this thread's 4 x 8 part of the
// 64 x 64 product A B^T of two swizzled 64-row tiles of HD floats
template <int HD>
__device__ __forceinline__ void f32_abt(float (&c)[4][8], const float* A,
                                        const float* B, int rg, int cg) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int i = 0; i < 8; ++i) c[a][i] = 0.f;
  }
  const float* arow = A + rg * HD;
  const float* brow = B + cg * HD;
  const int ka = swz_key<HD>(rg);  // the key of rows rg + 16a
  const int kb = swz_key<HD>(cg);  // and of rows cg + 8i
#pragma unroll 4
  for (int ch = 0; ch < HD / 4; ++ch) {
    float4 av[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      av[a] = *reinterpret_cast<const float4*>(arow + 16 * a * HD +
                                               4 * (ch ^ ka));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 bv =
          *reinterpret_cast<const float4*>(brow + 8 * i * HD + 4 * (ch ^ kb));
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        c[a][i] = fmaf(av[a].x, bv.x, c[a][i]);
        c[a][i] = fmaf(av[a].y, bv.y, c[a][i]);
        c[a][i] = fmaf(av[a].z, bv.z, c[a][i]);
        c[a][i] = fmaf(av[a].w, bv.w, c[a][i]);
      }
    }
  }
}

// x[a] (rows rg + 16a) into column j of the score tile, kept transposed:
// row j, chunk rg, one float4
__device__ __forceinline__ void put_scores(float* xs, int j, int rg,
                                           const float (&x)[4]) {
  *reinterpret_cast<float4*>(swz_at<kF32Rows>(xs, j, rg)) =
      make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ float4 get_scores(const float* xs, int j, int rg) {
  return *reinterpret_cast<const float4*>(swz_at<kF32Rows>(xs, j, rg));
}

// acc[a][e] += X[j][rg + 16a] * T[j][f32_dim(cg, e)] for rows j < `rows`
// of a streamed tile T, X the transposed score tile
template <int HD>
__device__ __forceinline__ void f32_xt_row(const float* xs, const float* tt,
                                           float (&acc)[4][HD / 8], int j,
                                           int rg, int cg) {
  const float4 x4 = get_scores(xs, j, rg);
  const float x[4] = {x4.x, x4.y, x4.z, x4.w};
  if (HD >= 32) {
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) {
      const float4 tv =
          *reinterpret_cast<const float4*>(swz_at<HD>(tt, j, 8 * c + cg));
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][4 * c + 0] = fmaf(x[a], tv.x, acc[a][4 * c + 0]);
        acc[a][4 * c + 1] = fmaf(x[a], tv.y, acc[a][4 * c + 1]);
        acc[a][4 * c + 2] = fmaf(x[a], tv.z, acc[a][4 * c + 2]);
        acc[a][4 * c + 3] = fmaf(x[a], tv.w, acc[a][4 * c + 3]);
      }
    }
  } else {
    const float2 tv = *reinterpret_cast<const float2*>(
        swz_at<HD>(tt, j, cg >> 1) + 2 * (cg & 1));
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      acc[a][0] = fmaf(x[a], tv.x, acc[a][0]);
      acc[a][1] = fmaf(x[a], tv.y, acc[a][1]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void f32_xt(const float* xs, const float* tt,
                                       float (&acc)[4][HD / 8], int rows,
                                       int rg, int cg) {
  if (rows == kBlockK) {
    // a full tile: a fixed trip count, 16 rows deep (4 and 8 ran 1.5-5%
    // slower at B=8, T=826; 32 and 64 slower at T=316)
#pragma unroll 16
    for (int j = 0; j < kBlockK; ++j) f32_xt_row<HD>(xs, tt, acc, j, rg, cg);
  } else {
#pragma unroll 4
    for (int j = 0; j < rows; ++j) f32_xt_row<HD>(xs, tt, acc, j, rg, cg);
  }
}

// this thread's HD/8 dims (f32_dim) of one (b, t, h) row: float4 chunks
// when VEC
template <int HD, bool VEC>
__device__ __forceinline__ void load_dims(float (&x)[HD / 8], const float* p,
                                          long long sd, int cg) {
  if (VEC && HD >= 32) {
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) {
      const float4 t = *reinterpret_cast<const float4*>(p + 32 * c + 4 * cg);
      x[4 * c] = t.x;
      x[4 * c + 1] = t.y;
      x[4 * c + 2] = t.z;
      x[4 * c + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < HD / 8; ++e) x[e] = p[f32_dim<HD>(cg, e) * sd];
  }
}

template <int HD, bool VEC>
__device__ __forceinline__ void store_dims(float* p, long long sd,
                                           const float (&x)[HD / 8],
                                           float mul, int cg) {
  if (VEC && HD >= 32) {
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) {
      *reinterpret_cast<float4*>(p + 32 * c + 4 * cg) =
          make_float4(x[4 * c] * mul, x[4 * c + 1] * mul,
                      x[4 * c + 2] * mul, x[4 * c + 3] * mul);
    }
  } else {
#pragma unroll
    for (int e = 0; e < HD / 8; ++e) p[f32_dim<HD>(cg, e) * sd] = x[e] * mul;
  }
}

// Shared memory of a float32 backward kernel: two resident 64-row tiles,
// two stages of two streamed ones (rows of HD floats, swizzled), the
// 64 x 64 score tile, and (dkdv) two stages of 64 lse and 64 D values
template <int HD>
constexpr int bwd_f32_smem_bytes(bool dkdv) {
  return (6 * kF32Rows * HD + kBlockK * kF32Rows + (dkdv ? 4 * kBlockK : 0)) *
         static_cast<int>(sizeof(float));
}

// Grid: ceil(T/64) query tiles x B*H, query tile fastest; kF32Threads
// threads, bwd_f32_smem_bytes<HD>(false) of dynamic shared memory.
// Writes dQ, and D = dO . O (B*H, T) into delta.
template <int HD, bool VEC>
__global__ void __launch_bounds__(kF32Threads, 2)
attention_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ out,
                            const float* __restrict__ lse,
                            const int* __restrict__ lengths,
                            float* __restrict__ dq, float* __restrict__ delta,
                            int n_heads, int seq, int n_tiles, Strides sq,
                            Strides sk, Strides sv, Strides sdo, Strides so,
                            Strides sdq, float scale_log2, float scale) {
  constexpr int kTile = kF32Rows * HD;  // floats of one 64-row tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kTile;
  float* ks = dos + kTile;     // stage s: ks + s * kTile
  float* vs = ks + 2 * kTile;  // stage s: vs + s * kTile
  float* xs = vs + 2 * kTile;  // dS^T

  const int lane = threadIdx.x % 32;
  const int rg = threadIdx.x / 32 * 4 + lane / 8;  // query rows rg + 16a
  const int cg = lane % 8;                         // keys cg + 8i
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int r0 = blockIdx.x % n_tiles * kF32Rows;
  const int len = lengths != nullptr ? lengths[b] : seq;
  const int n_keys = min(len, seq);
  // length 0: the scores are the constant -1e30, so dQ = 0 (no key tiles)
  const int n_tiles_k = n_keys > 0 ? (n_keys + kBlockK - 1) / kBlockK : 0;

  const float* kbase = k + b * sk.b + h * sk.h;
  const float* vbase = v + b * sv.b + h * sv.h;
  if (n_tiles_k > 0) {  // q, dO and K/V tile 0: group 0
    stage_swz<HD, VEC>(qs, q + b * sq.b + h * sq.h, sq, r0, seq);
    stage_swz<HD, VEC>(dos, dout + b * sdo.b + h * sdo.h, sdo, r0, seq);
    stage_swz<HD, VEC>(ks, kbase, sk, 0, n_keys);
    stage_swz<HD, VEC>(vs, vbase, sv, 0, n_keys);
  }
  cp_async_commit();

  // while group 0 flies: D = dO . O and lse*log2(e) of rows rg + 16a, from
  // device memory; each of a row's eight lanes sums its HD/8 dims, then a
  // butterfly adds the eight (the same bits in each lane)
  float dd[4], lse2[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + rg + 16 * a;
    float sum = 0.f;
    if (row < seq) {
      float x[HD / 8], y[HD / 8];
      load_dims<HD, VEC>(x, dout + b * sdo.b + row * sdo.t + h * sdo.h,
                         sdo.d, cg);
      load_dims<HD, VEC>(y, out + b * so.b + row * so.t + h * so.h, so.d,
                         cg);
#pragma unroll
      for (int e = 0; e < HD / 8; ++e) sum = fmaf(x[e], y[e], sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 4);
    dd[a] = sum;
    lse2[a] = row < seq ? lse[bh * seq + row] * kLog2e : 0.f;
    if (cg == 0 && row < seq) delta[bh * seq + row] = sum;
  }

  float acc[4][HD / 8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int e = 0; e < HD / 8; ++e) acc[a][e] = 0.f;
  }
  for (int t = 0; t < n_tiles_k; ++t) {
    const int stage = t & 1;
    // tile t has landed, and every thread is done with tile t - 1 (its
    // stage and dS^T): tile t + 1 goes into that stage while t runs
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles_k) {
      const int k1 = (t + 1) * kBlockK;
      stage_swz<HD, VEC>(ks + (stage ^ 1) * kTile, kbase, sk, k1, n_keys);
      stage_swz<HD, VEC>(vs + (stage ^ 1) * kTile, vbase, sv, k1, n_keys);
    }
    cp_async_commit();
    const float* kt = ks + stage * kTile;
    const int tile_keys = min(kBlockK, n_keys - t * kBlockK);
    float s[4][8], dp[4][8];
    f32_abt<HD>(s, qs, kt, rg, cg);
    f32_abt<HD>(dp, dos, vs + stage * kTile, rg, cg);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // keys at and past n_keys (zero-filled) weigh 0
      const bool gone = tile_keys < kBlockK && cg + 8 * i >= tile_keys;
      float x[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float p =
            gone ? 0.f : exp2_ftz(fmaf(s[a][i], scale_log2, -lse2[a]));
        x[a] = p * (dp[a][i] - dd[a]);  // dS
      }
      put_scores(xs, cg + 8 * i, rg, x);
    }
    __syncthreads();  // dS^T complete
    f32_xt<HD>(xs, kt, acc, tile_keys, rg, cg);
  }
  float* dqbase = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = r0 + rg + 16 * a;
    if (row < seq) {
      store_dims<HD, VEC>(dqbase + row * sdq.t, sdq.d, acc[a], scale, cg);
    }
  }
}

// Grid: ceil(T/64) key tiles x B*H, key tile fastest; kF32Threads
// threads, bwd_f32_smem_bytes<HD>(true) of dynamic shared memory.  Reads
// the dq kernel's D.
template <int HD, bool VEC>
__global__ void __launch_bounds__(kF32Threads, 2)
attention_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const int* __restrict__ lengths,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int n_heads, int seq, int n_tiles, Strides sq,
                              Strides sk, Strides sv, Strides sdo,
                              Strides sdk, Strides sdv, float scale_log2,
                              float scale) {
  constexpr int kTile = kF32Rows * HD;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kTile;
  float* qs = vs + kTile;               // stage s: qs + s * kTile
  float* dos = qs + 2 * kTile;          // stage s: dos + s * kTile
  float* xs = dos + 2 * kTile;          // P^T, then dS^T
  float* ls = xs + kBlockK * kF32Rows;  // stage s: ls + s * kBlockK
  float* ds = ls + 2 * kBlockK;         // stage s: ds + s * kBlockK

  const int lane = threadIdx.x % 32;
  const int rg = threadIdx.x / 32 * 4 + lane / 8;  // keys rg + 16a
  const int cg = lane % 8;                         // query rows cg + 8i
  const int bh = blockIdx.x / n_tiles;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int k0 = blockIdx.x % n_tiles * kF32Rows;
  const int len = lengths != nullptr ? lengths[b] : seq;
  const bool all_masked = len < 1;
  // keys the rows attend to: the valid ones, or all T when none is valid;
  // a block past them has dK = dV = 0 exactly (no row attends to its keys)
  const int n_keys = all_masked ? seq : min(len, seq);
  const int n_tiles_q = k0 < n_keys ? (seq + kBlockK - 1) / kBlockK : 0;
  const float uniform = 1.f / seq;  // P of a length-0 row
  bool live[4];  // key rg + 16a is valid
#pragma unroll
  for (int a = 0; a < 4; ++a) live[a] = k0 + rg + 16 * a < n_keys;

  const float* qbase = q + b * sq.b + h * sq.h;
  const float* dobase = dout + b * sdo.b + h * sdo.h;
  const float* lbase = lse + bh * seq;
  const float* dbase = delta + bh * seq;
  if (n_tiles_q > 0) {  // K, V and Q/dO/lse/D tile 0: group 0
    stage_swz<HD, VEC>(ks, k + b * sk.b + h * sk.h, sk, k0, n_keys);
    stage_swz<HD, VEC>(vs, v + b * sv.b + h * sv.h, sv, k0, n_keys);
    stage_swz<HD, VEC>(qs, qbase, sq, 0, seq);
    stage_swz<HD, VEC>(dos, dobase, sdo, 0, seq);
    stage_row_f32(ls, lbase, 0, seq);
    stage_row_f32(ds, dbase, 0, seq);
  }
  cp_async_commit();

  float acc_k[4][HD / 8], acc_v[4][HD / 8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int e = 0; e < HD / 8; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;
  }
  for (int t = 0; t < n_tiles_q; ++t) {
    const int stage = t & 1;
    // tile t has landed, and every thread is done with tile t - 1 (its
    // stage and dS^T)
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles_q) {
      const int q1 = (t + 1) * kBlockK;
      const int o = stage ^ 1;
      stage_swz<HD, VEC>(qs + o * kTile, qbase, sq, q1, seq);
      stage_swz<HD, VEC>(dos + o * kTile, dobase, sdo, q1, seq);
      stage_row_f32(ls + o * kBlockK, lbase, q1, seq);
      stage_row_f32(ds + o * kBlockK, dbase, q1, seq);
    }
    cp_async_commit();
    const float* qt = qs + stage * kTile;
    const float* dot = dos + stage * kTile;
    const float* lt = ls + stage * kBlockK;
    const float* dt = ds + stage * kBlockK;
    const int rows = min(kBlockK, seq - t * kBlockK);
    float s[4][8];  // S^T, then dP^T, then dS^T
    f32_abt<HD>(s, ks, qt, rg, cg);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float l2 = lt[cg + 8 * i] * kLog2e;
      float p[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        // length 0: P uniform over the T keys
        p[a] = !live[a]    ? 0.f
               : all_masked ? uniform
                            : exp2_ftz(fmaf(s[a][i], scale_log2, -l2));
      }
      put_scores(xs, cg + 8 * i, rg, p);
    }
    f32_abt<HD>(s, vs, dot, rg, cg);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = dt[cg + 8 * i];
      const float4 p = get_scores(xs, cg + 8 * i, rg);  // this thread's own
      // length 0: the scores do not depend on q or k, so dS = 0
      s[0][i] = all_masked ? 0.f : p.x * (s[0][i] - d);
      s[1][i] = all_masked ? 0.f : p.y * (s[1][i] - d);
      s[2][i] = all_masked ? 0.f : p.z * (s[2][i] - d);
      s[3][i] = all_masked ? 0.f : p.w * (s[3][i] - d);
    }
    __syncthreads();  // P^T complete
    f32_xt<HD>(xs, dot, acc_v, rows, rg, cg);
    __syncthreads();  // every thread is done with P^T
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float x[4] = {s[0][i], s[1][i], s[2][i], s[3][i]};
      put_scores(xs, cg + 8 * i, rg, x);
    }
    __syncthreads();  // dS^T complete
    f32_xt<HD>(xs, qt, acc_k, rows, rg, cg);
  }
  float* dkbase = dk + b * sdk.b + h * sdk.h;
  float* dvbase = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + rg + 16 * a;
    if (key >= seq) continue;
    if (!live[a]) {  // masked keys: exactly zero
#pragma unroll
      for (int e = 0; e < HD / 8; ++e) acc_k[a][e] = acc_v[a][e] = 0.f;
    }
    store_dims<HD, VEC>(dkbase + key * sdk.t, sdk.d, acc_k[a], scale, cg);
    store_dims<HD, VEC>(dvbase + key * sdv.t, sdv.d, acc_v[a], 1.f, cg);
  }
}

// ------------------------------------------------------------- launch

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// rows of 8 bf16 as 16-byte vectors: d contiguous, rows 16-byte aligned
bool vec_rows(const void* p, Strides s) {
  return s.d == 1 && aligned16(p) && (s.b | s.t | s.h) % 8 == 0;
}

template <int HD, bool VEC>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v,
                            void* o, float* lse, const int* lengths,
                            int batch, int seq, int n_heads, Strides sq,
                            Strides sk, Strides sv, Strides so, float scale,
                            cudaStream_t stream) {
  auto kernel = attention_fwd_bf16_kernel<HD, VEC>;
  constexpr int smem = fwd_smem_bytes<HD>();
  // above 48 KB (hd 64) only after this opt-in; without it the launch is
  // refused and cudaGetLastError says so
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (seq + kRows - 1) / kRows;
  kernel<<<n_qtiles * batch * n_heads, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, lengths,
      n_heads, seq, n_qtiles, sq, sk, sv, so, scale * kLog2e);
  return cudaGetLastError();
}

// rows of 4 floats as 16-byte vectors: d contiguous, rows 16-byte aligned
bool vec_rows_f32(const void* p, Strides s) {
  return s.d == 1 && aligned16(p) && (s.b | s.t | s.h) % 4 == 0;
}

template <int HD, bool VEC>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v,
                           void* o, float* lse, float* part,
                           const int* lengths, int batch, int seq,
                           int n_heads, int n_splits, Strides sq, Strides sk,
                           Strides sv, Strides so, float scale,
                           cudaStream_t stream) {
  if (n_splits < 1 || (n_splits > 1 && part == nullptr)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = attention_fwd_f32_kernel<HD, VEC>;
  constexpr int smem = f32_smem_bytes<HD>();
  // above 48 KB (hd 32 and 64) only after this opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (seq + kF32Rows - 1) / kF32Rows;
  const int n_ktiles = (seq + kBlockK - 1) / kBlockK;
  const int split_keys = (n_ktiles + n_splits - 1) / n_splits * kBlockK;
  const int n_bh = batch * n_heads;
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(o);
  kernel<<<n_splits * n_qtiles * n_bh, kF32Threads, smem, stream>>>(
      qf, static_cast<const float*>(k), static_cast<const float*>(v), of,
      lse, part, lengths, n_heads, seq, n_qtiles, n_splits, split_keys, n_bh,
      sq, sk, sv, so, scale * kLog2e);
  if (n_splits == 1) return cudaGetLastError();
  const cudaError_t err2 = cudaGetLastError();
  if (err2 != cudaSuccess) return err2;
  const long long n = static_cast<long long>(n_bh) * seq * (HD / 4);
  auto combine = attention_fwd_f32_combine_kernel<HD, VEC>;
  const unsigned blocks =
      static_cast<unsigned>((n + kCombineThreads - 1) / kCombineThreads);
  combine<<<blocks, kCombineThreads, 0, stream>>>(part, of, lse, lengths,
                                                  n_heads, seq, n_splits,
                                                  n_bh, so);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, const int* lengths, int batch,
                   int seq, int n_heads, Strides sq, Strides sk, Strides sv,
                   Strides so, float scale, int n_splits, float* part,
                   cudaStream_t stream) {
  if (dtype == 0) {
    if (vec_rows_f32(q, sq) && vec_rows_f32(k, sk) && vec_rows_f32(v, sv) &&
        vec_rows_f32(o, so)) {
      return launch_fwd_f32<HD, true>(q, k, v, o, lse, part, lengths, batch,
                                      seq, n_heads, n_splits, sq, sk, sv, so,
                                      scale, stream);
    }
    return launch_fwd_f32<HD, false>(q, k, v, o, lse, part, lengths, batch,
                                     seq, n_heads, n_splits, sq, sk, sv, so,
                                     scale, stream);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  if (vec_rows(q, sq) && vec_rows(k, sk) && vec_rows(v, sv) &&
      vec_rows(o, so)) {
    return launch_fwd_bf16<HD, true>(q, k, v, o, lse, lengths, batch, seq,
                                     n_heads, sq, sk, sv, so, scale, stream);
  }
  return launch_fwd_bf16<HD, false>(q, k, v, o, lse, lengths, batch, seq,
                                    n_heads, sq, sk, sv, so, scale, stream);
}

// s: strides of q, k, v, dout, dq, dk, dv, out
template <int HD, bool VEC>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const void* out,
                            const float* lse, const int* lengths, void* dq,
                            void* dk, void* dv, float* delta, int batch,
                            int seq, int n_heads, const Strides* s,
                            float scale, cudaStream_t stream) {
  auto dq_kernel = attention_bwd_dq_bf16_kernel<HD, VEC>;
  auto dkdv_kernel = attention_bwd_dkdv_bf16_kernel<HD, VEC>;
  constexpr int smem = bwd_smem_bytes<HD>();
  // above 48 KB (hd 64) only after this opt-in, as in launch_fwd_bf16
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  const int n_tiles = (seq + kRows - 1) / kRows;
  const int grid = n_tiles * batch * n_heads;
  // the forward's scale*log2(e), rounded alike
  const float scale_log2 = scale * kLog2e;
  dq_kernel<<<grid, kThreads, smem, stream>>>(
      qb, kb, vb, db, static_cast<const bf16*>(out), lse, lengths,
      static_cast<bf16*>(dq), delta, n_heads, seq, n_tiles, s[0], s[1], s[2],
      s[3], s[7], s[4], scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kThreads, smem, stream>>>(
      qb, kb, vb, db, lse, delta, lengths, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n_heads, seq, n_tiles, s[0], s[1], s[2], s[3],
      s[5], s[6], scale_log2, scale);
  return cudaGetLastError();
}

// s: strides of q, k, v, dout, dq, dk, dv, out
template <int HD, bool VEC>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* out,
                           const float* lse, const int* lengths, void* dq,
                           void* dk, void* dv, float* delta, int batch,
                           int seq, int n_heads, const Strides* s,
                           float scale, cudaStream_t stream) {
  auto dq_kernel = attention_bwd_dq_f32_kernel<HD, VEC>;
  auto dkdv_kernel = attention_bwd_dkdv_f32_kernel<HD, VEC>;
  constexpr int dq_smem = bwd_f32_smem_bytes<HD>(false);
  constexpr int dkdv_smem = bwd_f32_smem_bytes<HD>(true);
  // above 48 KB (hd 32 and 64) only after this opt-in
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem);
  if (err != cudaSuccess) return err;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const int n_tiles = (seq + kF32Rows - 1) / kF32Rows;
  const int grid = n_tiles * batch * n_heads;
  // the forward's scale*log2(e), rounded alike
  const float scale_log2 = scale * kLog2e;
  dq_kernel<<<grid, kF32Threads, dq_smem, stream>>>(
      qf, kf, vf, df, static_cast<const float*>(out), lse, lengths,
      static_cast<float*>(dq), delta, n_heads, seq, n_tiles, s[0], s[1],
      s[2], s[3], s[7], s[4], scale_log2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, kF32Threads, dkdv_smem, stream>>>(
      qf, kf, vf, df, lse, delta, lengths, static_cast<float*>(dk),
      static_cast<float*>(dv), n_heads, seq, n_tiles, s[0], s[1], s[2], s[3],
      s[5], s[6], scale_log2, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const void* out,
                       const float* lse, const int* lengths, void* dq,
                       void* dk, void* dv, float* delta, int batch, int seq,
                       int n_heads, const Strides* s, float scale,
                       cudaStream_t stream) {
  if (dtype == 0) {
    // staged, read (out) and written rows as 16-byte vectors
    bool vec = true;
    const void* ptrs[8] = {q, k, v, dout, dq, dk, dv, out};
    for (int i = 0; i < 8; ++i) vec = vec && vec_rows_f32(ptrs[i], s[i]);
    if (vec) {
      return launch_bwd_f32<HD, true>(q, k, v, dout, out, lse, lengths, dq,
                                      dk, dv, delta, batch, seq, n_heads, s,
                                      scale, stream);
    }
    return launch_bwd_f32<HD, false>(q, k, v, dout, out, lse, lengths, dq,
                                     dk, dv, delta, batch, seq, n_heads, s,
                                     scale, stream);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  // staged and written rows as 16-byte vectors (out is read element-wise)
  bool vec = true;
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  for (int i = 0; i < 7; ++i) vec = vec && vec_rows(ptrs[i], s[i]);
  if (vec) {
    return launch_bwd_bf16<HD, true>(q, k, v, dout, out, lse, lengths, dq,
                                     dk, dv, delta, batch, seq, n_heads, s,
                                     scale, stream);
  }
  return launch_bwd_bf16<HD, false>(q, k, v, dout, out, lse, lengths, dq, dk,
                                    dv, delta, batch, seq, n_heads, s, scale,
                                    stream);
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 16 int64 values, (b, t, h, d)
// for q, k, v, o in elements.  lse: float32 (B*H, T) written when not null
// (the backward's input; natural-log units in float32, log2 units in
// bfloat16).  lengths: int32 (B,) or null.  head_dim: 16, 32 or
// 64.  n_splits: key splits of the float32 forward (1 in bfloat16); with
// more than one, scratch holds n_splits * B*H*T * (head_dim + 2) floats.
// Returns the first failed launch's cudaError_t, else 0.
extern "C" int peppa_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const void* lengths, int dtype, int batch,
                                   int seq, int n_heads, int head_dim,
                                   const long long* strides, float scale,
                                   void* stream, int n_splits,
                                   void* scratch) {
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1);
  const Strides sv = strides_at(strides, 2), so = strides_at(strides, 3);
  const int* lens = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(dtype, q, k, v, o, l, lens, batch, seq, n_heads, sq,
                        sk, sv, so, scale, n_splits, part, s);
    case 32:
      return launch<32>(dtype, q, k, v, o, l, lens, batch, seq, n_heads, sq,
                        sk, sv, so, scale, n_splits, part, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, l, lens, batch, seq, n_heads, sq,
                        sk, sv, so, scale, n_splits, part, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward: dq, dk, dv (q's dtype) from q, k, v, dout, the forward's
// output and its lse (natural-log units in float32, log2 units in
// bfloat16).  strides: 32 int64 values, (b, t, h, d) for q, k, v, dout, dq,
// dk, dv, out.  out: read by the dq kernel for D = rowsum(dout o out)
// (float32: the D of both kernels; bfloat16: the D of dQ alone).  delta: float32 (B*H, T)
// scratch.  Returns the first failed launch's cudaError_t, else 0.
extern "C" int peppa_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* out, const void* lse,
                                   const void* lengths, void* dq, void* dk,
                                   void* dv, void* delta, int dtype,
                                   int batch, int seq, int n_heads,
                                   int head_dim, const long long* strides,
                                   float scale, void* stream) {
  Strides s[8];
  for (int i = 0; i < 8; ++i) s[i] = strides_at(strides, i);
  const float* l = static_cast<const float*>(lse);
  const int* lens = static_cast<const int*>(lengths);
  float* d = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_bwd<16>(dtype, q, k, v, dout, out, l, lens, dq, dk, dv,
                            d, batch, seq, n_heads, s, scale, st);
    case 32:
      return launch_bwd<32>(dtype, q, k, v, dout, out, l, lens, dq, dk, dv,
                            d, batch, seq, n_heads, s, scale, st);
    case 64:
      return launch_bwd<64>(dtype, q, k, v, dout, out, l, lens, dq, dk, dv,
                            d, batch, seq, n_heads, s, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
