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
// float32 (tests and the card-vs-CPU check): grid (B*H, ceil(T/64)), one
// thread per query row on the CUDA cores, full float32 FMAs (no TF32),
// chunks of 16 keys per rescale.  When the caller asks (autograd needs it),
// both write the float32 log-sum-exp of each row's scaled scores for the
// backward (serving passes null): float32 in natural-log units; bf16 in
// log2 units, lse2 = m + log2(l) over the rounded scaled scores
// x = s * (scale*log2(e)) that its softmax exponentiates (2^(x - m)), so the
// backward's 2^(x - lse2) is exactly 1 on a row with one key.
//
// Backward (section "backward" below).  Replaces the TPU kernel
// peppa_tpu/ops/pallas/attention.py `_bwd_kernel` (called from
// `_attend_bwd`): with P recomputed from q, k and the forward's log-sum-exp,
// dV = P^T dO, dP = dO V^T, dS = P o (dP - rowsum(dP o P)), dQ = dS K scale,
// dK = dS^T Q scale; outputs in q's dtype.  Bound on an H100 at the
// training shapes (B=8, H=12, hd=64, bf16): q, k, v, dO read and dQ, dK, dV
// written once, 7*B*T*H*hd elements (27 MB, 8.1 us at T=316); the work is
// 10*B*H*T^2*hd operations (5 products of T^2*hd: 41.9 GFLOP, 42.4 us on
// the tensor cores at T=826), so bytes bound T=316 and operations T=826.
// Two grids without atomics: a query-tile grid writes dQ and D, a key-tile
// grid loops over the query tiles for dK and dV.  The bf16 pair (its own
// section below) takes D = rowsum(dO o O) from the forward's output; the
// float32 pair, on the CUDA cores, computes D = rowsum(dP o P) in a first
// pass over the keys.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block (float32 forward)
constexpr int kRows = 128;    // rows per block (bf16 kernels)
constexpr int kThreads = kRows * 2;  // eight warps of 16 rows
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per online-softmax rescale (float32)
constexpr int kPad = 8;       // bf16 row padding: conflict-free fragments
constexpr float kMaskValue = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, t, h, d;
};

// ------------------------------------------------------------ float32

template <int HD>
__global__ void __launch_bounds__(kBlockQ)
attention_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse,
                         const int* __restrict__ lengths, int n_heads,
                         int seq, Strides sq, Strides sk, Strides sv,
                         Strides so, float scale) {
  __shared__ __align__(16) float ks[kBlockK][HD];
  __shared__ __align__(16) float vs[kBlockK][HD];

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int row = blockIdx.y * kBlockQ + threadIdx.x;
  const bool active = row < seq;

  const int len = lengths != nullptr ? lengths[b] : seq;
  const bool all_masked = len < 1;
  // keys the row must visit: the valid ones, or all T when none is valid
  const int n_keys = all_masked ? seq : min(len, seq);

  float qr[HD];
  float acc[HD];
  if (active) {
    const float* qp = q + b * sq.b + row * sq.t + h * sq.h;
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      qr[d] = qp[d * sq.d] * scale;
      acc[d] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  const float* kbase = k + b * sk.b + h * sk.h;
  const float* vbase = v + b * sv.b + h * sv.h;
  for (int k0 = 0; k0 < n_keys; k0 += kBlockK) {
    for (int idx = threadIdx.x; idx < kBlockK * HD; idx += kBlockQ) {
      const int j = idx / HD;
      const int d = idx % HD;
      const int key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < seq) {
        kv = kbase[key * sk.t + d * sk.d];
        vv = vbase[key * sv.t + d * sv.d];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    __syncthreads();
    if (active) {
      const int tile_keys = min(kBlockK, n_keys - k0);
      for (int c = 0; c < tile_keys; c += kChunk) {
        float s[kChunk];
        float cmax = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const int j = c + jj;
          float dot = 0.f;
          const float4* kr = reinterpret_cast<const float4*>(ks[j]);
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 kk = kr[d4];
            dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
          }
          // keys past n_keys do not exist for this row (exp(-inf) = 0)
          s[jj] = j < tile_keys ? (all_masked ? kMaskValue : dot) : -INFINITY;
          cmax = fmaxf(cmax, s[jj]);
        }
        const float m_new = fmaxf(m, cmax);
        const float corr = expf(m - m_new);
        l *= corr;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= corr;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float4* vr = reinterpret_cast<const float4*>(vs[c + jj]);
#pragma unroll
          for (int d4 = 0; d4 < HD / 4; ++d4) {
            const float4 vv = vr[d4];
            acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
            acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
          }
        }
        m = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float inv = 1.f / l;
    float* op = o + b * so.b + row * so.t + h * so.h;
#pragma unroll
    for (int d = 0; d < HD; ++d) op[d * so.d] = acc[d] * inv;
    if (lse != nullptr) lse[blockIdx.x * seq + row] = m + logf(l);
  }
}

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

// ----------------------------------------------------------- backward
//
// Two kernels for each type.  float32, on the CUDA cores, four threads per
// row (each holds HD/4 dims as float4 chunks part, part + 4, ...; a row's
// dot products are summed over its four lanes by two shuffles):
//   dq kernel, grid (B*H, ceil(T/64)) over query tiles: pass 1 over the
//     keys gives D_i = sum_j P_ij dP_ij, pass 2 accumulates
//     dQ_i = scale * sum_j P_ij (dP_ij - D_i) k_j; writes dQ and D;
//   dkdv kernel, grid (B*H, ceil(T/64)) over key tiles, a loop over all
//     query tiles: dV_j = sum_i P_ij dO_i, dK_j = scale * sum_i dS_ij q_i.
// P_ij = exp(scale q_i.k_j - lse_i) with the forward's natural-log lse.
// bfloat16 on the tensor cores: next section.  No atomics in either: every
// output element is written by one thread, in a fixed order, so results
// are bit-identical from run to run.

constexpr int kParts = 4;                  // threads per row
constexpr int kBwdRows = 64;               // rows per block (float32)
constexpr int kBwdThreads = kBwdRows * kParts;

// sum over the kParts adjacent lanes of a row (identical in all four)
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// dim of element e of this thread's chunk c
__device__ __forceinline__ int dim_of(int part, int c, int e) {
  return (part + kParts * c) * 4 + e;
}

// this thread's HD/4 dims of one (b, t, h) row, as float (0 when !valid)
template <int HD>
__device__ __forceinline__ void load_part(float (&r)[HD / 4], const float* p,
                                          long long stride_d, int part,
                                          bool valid) {
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      r[4 * c + e] = valid ? (p[dim_of(part, c, e) * stride_d]) : 0.f;
    }
  }
}

// partial dot of this thread's dims with a shared-memory row
template <int HD>
__device__ __forceinline__ float dot_part(const float (&r)[HD / 4],
                                          const float* row, int part) {
  const float4* rv = reinterpret_cast<const float4*>(row);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    const float4 x = rv[part + kParts * c];
    acc = fmaf(r[4 * c + 0], x.x, acc);
    acc = fmaf(r[4 * c + 1], x.y, acc);
    acc = fmaf(r[4 * c + 2], x.z, acc);
    acc = fmaf(r[4 * c + 3], x.w, acc);
  }
  return acc;
}

// acc += a * row over this thread's dims
template <int HD>
__device__ __forceinline__ void axpy_part(float (&acc)[HD / 4], float a,
                                          const float* row, int part) {
  const float4* rv = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
    const float4 x = rv[part + kParts * c];
    acc[4 * c + 0] = fmaf(a, x.x, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(a, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(a, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(a, x.w, acc[4 * c + 3]);
  }
}

template <int HD>
__device__ __forceinline__ void store_part(float* p, long long stride_d,
                                           const float (&r)[HD / 4], float mul,
                                           int part) {
#pragma unroll
  for (int c = 0; c < HD / 16; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[dim_of(part, c, e) * stride_d] = (r[4 * c + e] * mul);
    }
  }
}

// rows r0 .. r0 + 63 of one (b, h) slice into shared memory, as float
// (zero past `limit`)
template <int HD>
__device__ __forceinline__ void stage_rows(float (*dst)[HD], const float* base,
                                           Strides s, int r0, int limit) {
  for (int idx = threadIdx.x; idx < kBwdRows * HD; idx += kBwdThreads) {
    const int j = idx / HD;
    const int d = idx % HD;
    const int r = r0 + j;
    dst[j][d] = r < limit ? (base[r * s.t + d * s.d]) : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const int* __restrict__ lengths, float* __restrict__ dq,
                        float* __restrict__ delta, int n_heads, int seq,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, float scale) {
  __shared__ __align__(16) float ks[kBwdRows][HD];
  __shared__ __align__(16) float vs[kBwdRows][HD];

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int part = threadIdx.x % kParts;
  const int row = blockIdx.y * kBwdRows + threadIdx.x / kParts;
  const bool active = row < seq;
  const int len = lengths != nullptr ? lengths[b] : seq;
  const int n_keys = min(len, seq);

  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;
  float* dqp = dq + b * sdq.b + row * sdq.t + h * sdq.h;
  if (n_keys < 1) {
    // length 0: the scores are the constant -1e30, so dQ = 0
    if (active) {
      store_part<HD>(dqp, sdq.d, acc, 0.f, part);
      if (part == 0) delta[blockIdx.x * seq + row] = 0.f;
    }
    return;
  }

  float qr[HD / 4], dor[HD / 4];
  load_part<HD>(qr, q + b * sq.b + row * sq.t + h * sq.h, sq.d, part,
                   active);
  load_part<HD>(dor, dout + b * sdo.b + row * sdo.t + h * sdo.h, sdo.d,
                   part, active);
  const float row_lse = active ? lse[blockIdx.x * seq + row] : 0.f;
  const float* kbase = k + b * sk.b + h * sk.h;
  const float* vbase = v + b * sv.b + h * sv.h;

  // pass 1: D = rowsum(dP o P), in float32 from P and dP
  float dsum = 0.f;
  for (int k0 = 0; k0 < n_keys; k0 += kBwdRows) {
    stage_rows<HD>(ks, kbase, sk, k0, n_keys);
    stage_rows<HD>(vs, vbase, sv, k0, n_keys);
    __syncthreads();
    const int tile = min(kBwdRows, n_keys - k0);
    for (int j = 0; j < tile; ++j) {
      const float s = row_sum(dot_part<HD>(qr, ks[j], part));
      const float dp = row_sum(dot_part<HD>(dor, vs[j], part));
      dsum = fmaf(expf(s * scale - row_lse), dp, dsum);
    }
    __syncthreads();
  }
  // pass 2: dQ = scale * dS K
  for (int k0 = 0; k0 < n_keys; k0 += kBwdRows) {
    stage_rows<HD>(ks, kbase, sk, k0, n_keys);
    stage_rows<HD>(vs, vbase, sv, k0, n_keys);
    __syncthreads();
    const int tile = min(kBwdRows, n_keys - k0);
    for (int j = 0; j < tile; ++j) {
      const float s = row_sum(dot_part<HD>(qr, ks[j], part));
      const float dp = row_sum(dot_part<HD>(dor, vs[j], part));
      const float p = expf(s * scale - row_lse);
      axpy_part<HD>(acc, p * (dp - dsum), ks[j], part);
    }
    __syncthreads();
  }
  if (active) {
    store_part<HD>(dqp, sdq.d, acc, scale, part);
    if (part == 0) delta[blockIdx.x * seq + row] = dsum;
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ lengths, float* __restrict__ dk,
                          float* __restrict__ dv, int n_heads, int seq,
                          Strides sq, Strides sk, Strides sv, Strides sdo,
                          Strides sdk, Strides sdv, float scale) {
  __shared__ __align__(16) float qs[kBwdRows][HD];
  __shared__ __align__(16) float dos[kBwdRows][HD];
  __shared__ float lse_s[kBwdRows];
  __shared__ float delta_s[kBwdRows];

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int part = threadIdx.x % kParts;
  const int key = blockIdx.y * kBwdRows + threadIdx.x / kParts;
  const bool active = key < seq;
  const int len = lengths != nullptr ? lengths[b] : seq;
  const bool all_masked = len < 1;
  // keys the rows attend to: the valid ones, or all T when none is valid
  const int n_keys = all_masked ? seq : min(len, seq);
  const bool valid = key < n_keys;

  float acc_k[HD / 4], acc_v[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc_k[i] = acc_v[i] = 0.f;
  float* dkp = dk + b * sdk.b + key * sdk.t + h * sdk.h;
  float* dvp = dv + b * sdv.b + key * sdv.t + h * sdv.h;
  if (blockIdx.y * kBwdRows >= n_keys) {
    // masked keys: no row attends to them, dK = dV = 0 exactly
    if (active) {
      store_part<HD>(dkp, sdk.d, acc_k, 0.f, part);
      store_part<HD>(dvp, sdv.d, acc_v, 0.f, part);
    }
    return;
  }

  float kr[HD / 4], vr[HD / 4];
  load_part<HD>(kr, k + b * sk.b + key * sk.t + h * sk.h, sk.d, part,
                   valid);
  load_part<HD>(vr, v + b * sv.b + key * sv.t + h * sv.h, sv.d, part,
                   valid);
  const float* qbase = q + b * sq.b + h * sq.h;
  const float* dobase = dout + b * sdo.b + h * sdo.h;
  const float uniform = 1.f / seq;  // P of a length-0 row

  for (int q0 = 0; q0 < seq; q0 += kBwdRows) {
    stage_rows<HD>(qs, qbase, sq, q0, seq);
    stage_rows<HD>(dos, dobase, sdo, q0, seq);
    if (threadIdx.x < kBwdRows) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < seq ? lse[blockIdx.x * seq + r] : 0.f;
      delta_s[threadIdx.x] = r < seq ? delta[blockIdx.x * seq + r] : 0.f;
    }
    __syncthreads();
    const int tile = min(kBwdRows, seq - q0);
    for (int i = 0; i < tile; ++i) {
      const float s = row_sum(dot_part<HD>(kr, qs[i], part));
      const float dp = row_sum(dot_part<HD>(vr, dos[i], part));
      float p, ds;
      if (all_masked) {
        // length 0: P uniform over the T keys; the scores do not depend on
        // q or k, so dS = 0
        p = uniform;
        ds = 0.f;
      } else {
        p = valid ? expf(s * scale - lse_s[i]) : 0.f;
        ds = p * (dp - delta_s[i]);
      }
      axpy_part<HD>(acc_v, p, dos[i], part);
      axpy_part<HD>(acc_k, ds, qs[i], part);
    }
    __syncthreads();
  }
  if (active) {
    store_part<HD>(dkp, sdk.d, acc_k, scale, part);
    store_part<HD>(dvp, sdv.d, acc_v, 1.f, part);
  }
}

// ------------------------------------------------- backward, bfloat16
//
// The same two grids on the tensor cores (`mma.sync` m16n8k16, bf16
// operands, float32 accumulation), built as the bf16 forward is:
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

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, const int* lengths, int batch,
                   int seq, int n_heads, Strides sq, Strides sk, Strides sv,
                   Strides so, float scale, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid(batch * n_heads, (seq + kBlockQ - 1) / kBlockQ);
    attention_fwd_f32_kernel<HD><<<grid, kBlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, lengths,
        n_heads, seq, sq, sk, sv, so, scale);
    return cudaGetLastError();
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

template <int HD>
cudaError_t launch_bwd(int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const void* out,
                       const float* lse, const int* lengths, void* dq,
                       void* dk, void* dv, float* delta, int batch, int seq,
                       int n_heads, const Strides* s, float scale,
                       cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid(batch * n_heads, (seq + kBwdRows - 1) / kBwdRows);
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const float* df = static_cast<const float*>(dout);
    attention_bwd_dq_f32_kernel<HD><<<grid, kBwdThreads, 0, stream>>>(
        qf, kf, vf, df, lse, lengths, static_cast<float*>(dq), delta,
        n_heads, seq, s[0], s[1], s[2], s[3], s[4], scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attention_bwd_dkdv_f32_kernel<HD><<<grid, kBwdThreads, 0, stream>>>(
        qf, kf, vf, df, lse, delta, lengths, static_cast<float*>(dk),
        static_cast<float*>(dv), n_heads, seq, s[0], s[1], s[2], s[3], s[5],
        s[6], scale);
    return cudaGetLastError();
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
// 64.  Returns the launch's cudaError_t.
extern "C" int peppa_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const void* lengths, int dtype, int batch,
                                   int seq, int n_heads, int head_dim,
                                   const long long* strides, float scale,
                                   void* stream) {
  const Strides sq = strides_at(strides, 0), sk = strides_at(strides, 1);
  const Strides sv = strides_at(strides, 2), so = strides_at(strides, 3);
  const int* lens = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(dtype, q, k, v, o, l, lens, batch, seq, n_heads, sq,
                        sk, sv, so, scale, s);
    case 32:
      return launch<32>(dtype, q, k, v, o, l, lens, batch, seq, n_heads, sq,
                        sk, sv, so, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, l, lens, batch, seq, n_heads, sq,
                        sk, sv, so, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The backward: dq, dk, dv (q's dtype) from q, k, v, dout, the forward's
// output and its lse (natural-log units in float32, log2 units in
// bfloat16).  strides: 32 int64 values, (b, t, h, d) for q, k, v, dout, dq,
// dk, dv, out.  out: read in bfloat16 only (D = rowsum(dout o out)).
// delta: float32 (B*H, T) scratch.  Returns the first failed launch's
// cudaError_t, else 0.
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
