// Multi-head self-attention, forward and backward, for the wav2vec2
// transformer (sm_90a).
//
// Replaces the TPU kernel peppa_tpu/ops/pallas/attention.py `_fwd_kernel`
// (called from `_attend_fwd`): o = softmax(scale * q k^T, keys >= length[b]
// set to -1e30) v, math in float32, output in q's dtype.
//
// Bound on an H100 at the main path's shapes (B=32, H=12, hd=64,
// T=316..826, bf16): q, k, v and o are read/written once, 4*B*T*H*hd
// elements (62 MB at T=316); the work is 4*B*H*T^2*hd operations (9.8
// GFLOP).  On the tensor cores that is about 150 operations per byte
// against the card's ~295, so the kernel is bound by bytes (19 us at T=316).
//
// Design.  The Pallas kernel held the whole (T, T) score block of one
// (batch, head) in VMEM; a block's 227 KB of shared memory cannot, so both
// kernels here are flash-style: grid (B*H, ceil(T/64)), 64 query rows per
// block, K/V tiles of 64 keys staged through shared memory, an online
// softmax (running max and sum in float32) per row, and q/k/v/o read and
// written through their (b, t, h, d) strides, so the (B, T, H, hd)
// projections need no transpose copy.  Tiles past the last valid key are
// skipped: their -1e30 scores contribute exp(-1e30 - m) = 0 exactly.  At
// length 0 every key of the row scores -1e30, which averages v over T, as
// the plain PyTorch version does.
//
// bfloat16 (the main path): `mma.sync` m16n8k16 on the tensor cores, four
// warps of 16 query rows each.  S = q k^T takes bf16 operands, which are
// exact, and accumulates in float32; the softmax runs in float32 registers;
// P v splits P into a bf16 head and a bf16 remainder (two products), so P
// keeps ~16 bits and the product stays float32 math to ~1e-5 relative.
// float32: one thread per query row on the CUDA cores, full float32 FMAs
// (no TF32), chunks of 16 keys per rescale.  When the caller asks (autograd
// needs it), both write the float32 log-sum-exp of each row's scaled scores
// for the backward; serving passes null and writes nothing more.
//
// Backward (section "backward" below).  Replaces the TPU kernel
// peppa_tpu/ops/pallas/attention.py `_bwd_kernel` (called from
// `_attend_bwd`): with P recomputed from q, k and the forward's log-sum-exp,
// dV = P^T dO, dP = dO V^T, dS = P o (dP - rowsum(dP o P)), dQ = dS K scale,
// dK = dS^T Q scale; outputs in q's dtype.  Bound on an H100 at the
// training shapes (B=8, H=12, hd=64, T=316, bf16): q, k, v, dO read and dQ,
// dK, dV written once, 7*B*T*H*hd elements (27 MB, 8 us); the work is
// 10*B*H*T^2*hd operations (6.1 GFLOP, 6 us on the tensor cores), so bytes
// bound it.  Design: two grids without atomics (a query-tile grid writes dQ
// and D = rowsum(dP o P), a key-tile grid loops over the query tiles for dK
// and dV), so S and dP are recomputed three times (9 products of T^2*hd
// instead of 5); bf16 on `mma.sync` with P and dS split into two bf16
// parts (P-carrying products cost double), float32 on the CUDA cores.  Far
// from the bound: no `cp.async`/TMA overlap, no `wgmma`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per shared-memory tile
constexpr int kChunk = 16;    // keys per online-softmax rescale (float32)
constexpr int kPad = 8;       // bf16 row padding: conflict-free fragments
constexpr float kMaskValue = -1e30f;  // the TPU kernel's NEG_INF

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

// P's two bf16 parts: head = bf16(p), tail = bf16(p - head)
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& head,
                                           uint32_t& tail) {
  const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  head = pack_bf16(h0, h1);
  tail = pack_bf16(__float2bfloat16(x0 - __bfloat162float(h0)),
                   __float2bfloat16(x1 - __bfloat162float(h1)));
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

template <int HD>
__global__ void __launch_bounds__(kBlockQ * 2)
attention_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse,
                          const int* __restrict__ lengths, int n_heads,
                          int seq, Strides sq, Strides sk, Strides sv,
                          Strides so, float scale, bool vec) {
  constexpr int kThreads = kBlockQ * 2;  // four warps, 16 rows each
  constexpr int kSteps = HD / 16;        // k-steps of q k^T
  constexpr int kDimTiles = HD / 8;      // n-tiles of P v
  constexpr int kKeyTiles = kBlockK / 8; // n-tiles of q k^T
  __shared__ __align__(16) bf16 ks[kBlockK][HD + kPad];
  __shared__ __align__(16) bf16 vs[kBlockK][HD + kPad];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row (and B column)
  const int tq = lane % 4;  // fragment column pair
  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int row0 = blockIdx.y * kBlockQ + warp * 16 + g;  // and row0 + 8

  const int len = lengths != nullptr ? lengths[b] : seq;
  const bool all_masked = len < 1;
  const int n_keys = all_masked ? seq : min(len, seq);

  // q's A fragments, rows row0 / row0 + 8 (zero past T)
  uint32_t qa[kSteps][4];
  {
    const bf16 zero = __float2bfloat16(0.f);
    const bf16* qp = q + b * sq.b + h * sq.h;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + (r & 1) * 8;
        const int col = s * 16 + tq * 2 + (r >> 1) * 8;
        const bf16* p = qp + row * sq.t + col * sq.d;
        qa[s][r] = row < seq ? pack_bf16(p[0], p[sq.d])
                             : pack_bf16(zero, zero);
      }
    }
  }

  float acc[kDimTiles][4];
#pragma unroll
  for (int j = 0; j < kDimTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows row0, row0 + 8
  float l[2] = {0.f, 0.f};              // this thread's part of the sums

  const bf16* kbase = k + b * sk.b + h * sk.h;
  const bf16* vbase = v + b * sv.b + h * sv.h;
  for (int k0 = 0; k0 < n_keys; k0 += kBlockK) {
    for (int idx = threadIdx.x; idx < kBlockK * HD / 8; idx += kThreads) {
      const int j = idx / (HD / 8);
      const int d = idx % (HD / 8) * 8;
      const int key = k0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (key < seq) {
        kv = load8(kbase + key * sk.t + d * sk.d, sk.d, vec);
        vv = load8(vbase + key * sv.t + d * sv.d, sv.d, vec);
      }
      *reinterpret_cast<uint4*>(&ks[j][d]) = kv;
      *reinterpret_cast<uint4*>(&vs[j][d]) = vv;
    }
    __syncthreads();

    // S = q k^T for 16 rows x 64 keys
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const bf16* kr = &ks[j * 8 + g][st * 16 + tq * 2];
        mma_bf16(s[j], qa[st], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, online softmax (a row's four threads share its max)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tq * 2 + (e & 1);
        const float x = key >= n_keys ? -INFINITY
                        : all_masked  ? kMaskValue
                                      : s[j][e] * scale;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
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
#pragma unroll
      for (int j = 0; j < kDimTiles; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, &vs[key][(j + lane / 16) * 8]);
        mma_bf16(acc[j], ph, bv[0], bv[1]);
        mma_bf16(acc[j], pt, bv[0], bv[1]);
        mma_bf16(acc[j + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[j + 1], pt, bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  bf16* obase = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / sum;
    const int row = row0 + r * 8;
    if (row >= seq) continue;
    if (lse != nullptr && tq == 0) {
      lse[blockIdx.x * seq + row] = m[r] + logf(sum);
    }
    bf16* op = obase + row * so.t;
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j) {
      const int col = j * 8 + tq * 2;
      op[col * so.d] = __float2bfloat16(acc[j][2 * r] * inv);
      op[(col + 1) * so.d] = __float2bfloat16(acc[j][2 * r + 1] * inv);
    }
  }
}

// ----------------------------------------------------------- backward
//
// Two kernels; for float32 inputs on the CUDA cores, four threads per row
// (each holds HD/4 dims as float4 chunks part, part + 4, ...; a row's dot
// products are summed over its four lanes by two shuffles); for bfloat16
// on the tensor cores (next section):
//   dq kernel, grid (B*H, ceil(T/64)) over query tiles: pass 1 over the
//     keys gives D_i = sum_j P_ij dP_ij, pass 2 accumulates
//     dQ_i = scale * sum_j P_ij (dP_ij - D_i) k_j; writes dQ and D;
//   dkdv kernel, grid (B*H, ceil(T/64)) over key tiles, a loop over all
//     query tiles: dV_j = sum_i P_ij dO_i, dK_j = scale * sum_i dS_ij q_i.
// P_ij = exp(scale q_i.k_j - lse_i) with the forward's float32 log-sum-exp.
// No atomics: every output element is written by one thread, in a fixed
// order, so results are bit-identical from run to run.

constexpr int kParts = 4;                  // threads per row
constexpr int kBwdRows = 64;               // rows per block
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
// operands, float32 accumulation), four warps of 16 rows each, K/V (dq
// kernel) or Q/dO (dkdv kernel) tiles of 64 rows staged in shared memory.
// S = q k^T and dP = dO V^T take the bf16 inputs, which are exact, so P,
// dP, D and dS are float32 as in `_bwd_kernel`.  P and dS enter the
// products that follow as a bf16 head and a bf16 tail (two products, as P
// in the forward), so they keep about 16 bits.

// rows r0 .. r0 + 63 of one (b, h) slice into shared memory (zero past
// `limit`)
template <int HD>
__device__ __forceinline__ void stage_bf16(bf16 (*dst)[HD + kPad],
                                           const bf16* base, Strides s,
                                           int r0, int limit, bool vec) {
  for (int idx = threadIdx.x; idx < kBwdRows * HD / 8; idx += 128) {
    const int j = idx / (HD / 8);
    const int d = idx % (HD / 8) * 8;
    const int r = r0 + j;
    *reinterpret_cast<uint4*>(&dst[j][d]) =
        r < limit ? load8(base + r * s.t + d * s.d, s.d, vec)
                  : make_uint4(0, 0, 0, 0);
  }
}

// A fragments of 16 rows (row0, row0 + 8 per thread) of one (b, h) slice
template <int HD>
__device__ __forceinline__ void load_a(uint32_t (&a)[HD / 16][4],
                                       const bf16* base, Strides s, int row0,
                                       int tq, int limit) {
  const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
  for (int st = 0; st < HD / 16; ++st) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8;
      const int col = st * 16 + tq * 2 + (r >> 1) * 8;
      const bf16* p = base + row * s.t + col * s.d;
      a[st][r] = row < limit ? pack_bf16(p[0], p[s.d]) : pack_bf16(zero, zero);
    }
  }
}

// c[j] += a (16 rows x HD) * tile^T for the 8 n-tiles of 8 tile rows each
template <int HD>
__device__ __forceinline__ void mma_rows(float (&c)[8][4],
                                         const uint32_t (&a)[HD / 16][4],
                                         const bf16 (*tile)[HD + kPad],
                                         int g, int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int st = 0; st < HD / 16; ++st) {
      const bf16* r = &tile[j * 8 + g][st * 16 + tq * 2];
      mma_bf16(c[j], a[st], *reinterpret_cast<const uint32_t*>(r),
               *reinterpret_cast<const uint32_t*>(r + 8));
    }
  }
}

// acc (16 rows x HD) += x (16 rows x 64, C fragments) * tile (64 x HD),
// x as a bf16 head and tail
template <int HD>
__device__ __forceinline__ void mma_cols(float (&acc)[HD / 8][4],
                                         const float (&x)[8][4],
                                         const bf16 (*tile)[HD + kPad],
                                         int lane) {
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    uint32_t hd[4], tl[4];
    split_pair(x[2 * st][0], x[2 * st][1], hd[0], tl[0]);
    split_pair(x[2 * st][2], x[2 * st][3], hd[1], tl[1]);
    split_pair(x[2 * st + 1][0], x[2 * st + 1][1], hd[2], tl[2]);
    split_pair(x[2 * st + 1][2], x[2 * st + 1][3], hd[3], tl[3]);
    const int row = st * 16 + (lane / 8 % 2) * 8 + lane % 8;
#pragma unroll
    for (int j = 0; j < HD / 8; j += 2) {
      uint32_t bt[4];
      ldmatrix_x4_trans(bt, &tile[row][(j + lane / 16) * 8]);
      mma_bf16(acc[j], hd, bt[0], bt[1]);
      mma_bf16(acc[j], tl, bt[0], bt[1]);
      mma_bf16(acc[j + 1], hd, bt[2], bt[3]);
      mma_bf16(acc[j + 1], tl, bt[2], bt[3]);
    }
  }
}

// rows row0, row0 + 8 of acc * mul into one (b, h) slice
template <int HD>
__device__ __forceinline__ void store_rows(bf16* base, Strides s,
                                           const float (&acc)[HD / 8][4],
                                           float mul, int row0, int tq,
                                           int limit) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= limit) continue;
    bf16* p = base + row * s.t;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + tq * 2;
      p[col * s.d] = __float2bfloat16(acc[j][2 * r] * mul);
      p[(col + 1) * s.d] = __float2bfloat16(acc[j][2 * r + 1] * mul);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const int* __restrict__ lengths,
                             bf16* __restrict__ dq, float* __restrict__ delta,
                             int n_heads, int seq, Strides sq, Strides sk,
                             Strides sv, Strides sdo, Strides sdq,
                             float scale, bool vec) {
  __shared__ __align__(16) bf16 ks[kBwdRows][HD + kPad];
  __shared__ __align__(16) bf16 vs[kBwdRows][HD + kPad];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int row0 = blockIdx.y * kBwdRows + warp * 16 + g;  // and row0 + 8
  const int len = lengths != nullptr ? lengths[b] : seq;
  const int n_keys = min(len, seq);

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  bf16* dqbase = dq + b * sdq.b + h * sdq.h;
  if (n_keys < 1) {
    // length 0: the scores are the constant -1e30, so dQ = 0
    store_rows<HD>(dqbase, sdq, acc, 0.f, row0, tq, seq);
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r * 8;
      if (tq == 0 && row < seq) delta[blockIdx.x * seq + row] = 0.f;
    }
    return;
  }

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  load_a<HD>(qa, q + b * sq.b + h * sq.h, sq, row0, tq, seq);
  load_a<HD>(da, dout + b * sdo.b + h * sdo.h, sdo, row0, tq, seq);
  float row_lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    row_lse[r] = row < seq ? lse[blockIdx.x * seq + row] : 0.f;
  }
  const bf16* kbase = k + b * sk.b + h * sk.h;
  const bf16* vbase = v + b * sv.b + h * sv.h;

  float s[8][4], dp[8][4];
  // pass 1: D = rowsum(dP o P), in float32 from P and dP
  float dsum[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < n_keys; k0 += kBwdRows) {
    stage_bf16<HD>(ks, kbase, sk, k0, n_keys, vec);
    stage_bf16<HD>(vs, vbase, sv, k0, n_keys, vec);
    __syncthreads();
    mma_rows<HD>(s, qa, ks, g, tq);
    mma_rows<HD>(dp, da, vs, g, tq);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tq * 2 + (e & 1);
        const float p =
            key < n_keys ? expf(s[j][e] * scale - row_lse[e >> 1]) : 0.f;
        dsum[e >> 1] = fmaf(p, dp[j][e], dsum[e >> 1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
  }
  // pass 2: dQ = scale * dS K
  for (int k0 = 0; k0 < n_keys; k0 += kBwdRows) {
    stage_bf16<HD>(ks, kbase, sk, k0, n_keys, vec);
    stage_bf16<HD>(vs, vbase, sv, k0, n_keys, vec);
    __syncthreads();
    mma_rows<HD>(s, qa, ks, g, tq);
    mma_rows<HD>(dp, da, vs, g, tq);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tq * 2 + (e & 1);
        const float p =
            key < n_keys ? expf(s[j][e] * scale - row_lse[e >> 1]) : 0.f;
        s[j][e] = p * (dp[j][e] - dsum[e >> 1]);  // dS
      }
    }
    mma_cols<HD>(acc, s, ks, lane);
    __syncthreads();
  }
  store_rows<HD>(dqbase, sdq, acc, scale, row0, tq, seq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (tq == 0 && row < seq) delta[blockIdx.x * seq + row] = dsum[r];
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
attention_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const int* __restrict__ lengths,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int n_heads, int seq, Strides sq, Strides sk,
                               Strides sv, Strides sdo, Strides sdk,
                               Strides sdv, float scale, bool vec) {
  __shared__ __align__(16) bf16 qs[kBwdRows][HD + kPad];
  __shared__ __align__(16) bf16 dos[kBwdRows][HD + kPad];
  __shared__ float lse_s[kBwdRows];
  __shared__ float delta_s[kBwdRows];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x % n_heads;
  const int key0 = blockIdx.y * kBwdRows + warp * 16 + g;  // and key0 + 8
  const int len = lengths != nullptr ? lengths[b] : seq;
  const bool all_masked = len < 1;
  // keys the rows attend to: the valid ones, or all T when none is valid
  const int n_keys = all_masked ? seq : min(len, seq);

  float acc_k[HD / 8][4], acc_v[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;
  }
  bf16* dkbase = dk + b * sdk.b + h * sdk.h;
  bf16* dvbase = dv + b * sdv.b + h * sdv.h;
  if (blockIdx.y * kBwdRows >= n_keys) {
    // masked keys: no row attends to them, dK = dV = 0 exactly
    store_rows<HD>(dkbase, sdk, acc_k, 0.f, key0, tq, seq);
    store_rows<HD>(dvbase, sdv, acc_v, 0.f, key0, tq, seq);
    return;
  }

  // K and V rows of this warp's 16 keys as A fragments (zero past n_keys)
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  load_a<HD>(ka, k + b * sk.b + h * sk.h, sk, key0, tq, n_keys);
  load_a<HD>(va, v + b * sv.b + h * sv.h, sv, key0, tq, n_keys);
  const bf16* qbase = q + b * sq.b + h * sq.h;
  const bf16* dobase = dout + b * sdo.b + h * sdo.h;
  const float uniform = 1.f / seq;  // P of a length-0 row

  float pt[8][4], dst[8][4];  // P^T and dP^T, then dS^T: keys x queries
  for (int q0 = 0; q0 < seq; q0 += kBwdRows) {
    stage_bf16<HD>(qs, qbase, sq, q0, seq, vec);
    stage_bf16<HD>(dos, dobase, sdo, q0, seq, vec);
    if (threadIdx.x < kBwdRows) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < seq ? lse[blockIdx.x * seq + r] : 0.f;
      delta_s[threadIdx.x] = r < seq ? delta[blockIdx.x * seq + r] : 0.f;
    }
    __syncthreads();
    mma_rows<HD>(pt, ka, qs, g, tq);
    mma_rows<HD>(dst, va, dos, g, tq);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tq * 2 + (e & 1);
        const int key = key0 + (e >> 1) * 8;
        const bool live = q0 + col < seq && key < n_keys;
        float p, ds;
        if (all_masked) {
          // length 0: P uniform over the T keys; the scores do not depend
          // on q or k, so dS = 0
          p = live ? uniform : 0.f;
          ds = 0.f;
        } else {
          p = live ? expf(pt[j][e] * scale - lse_s[col]) : 0.f;
          ds = p * (dst[j][e] - delta_s[col]);
        }
        pt[j][e] = p;
        dst[j][e] = ds;
      }
    }
    mma_cols<HD>(acc_v, pt, dos, lane);
    mma_cols<HD>(acc_k, dst, qs, lane);
    __syncthreads();
  }
  store_rows<HD>(dkbase, sdk, acc_k, scale, key0, tq, seq);
  store_rows<HD>(dvbase, sdv, acc_v, 1.f, key0, tq, seq);
}

// ------------------------------------------------------------- launch

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, float* lse, const int* lengths, int batch,
                   int seq, int n_heads, Strides sq, Strides sk, Strides sv,
                   Strides so, float scale, cudaStream_t stream) {
  const dim3 grid(batch * n_heads, (seq + kBlockQ - 1) / kBlockQ);
  if (dtype == 0) {
    attention_fwd_f32_kernel<HD><<<grid, kBlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, lengths,
        n_heads, seq, sq, sk, sv, so, scale);
  } else if (dtype == 1) {
    // K/V rows as 16-byte vectors: d contiguous, rows 16-byte aligned
    const bool vec = sk.d == 1 && sv.d == 1 && aligned16(k) && aligned16(v) &&
                     (sk.b | sk.t | sk.h | sv.b | sv.t | sv.h) % 8 == 0;
    attention_fwd_bf16_kernel<HD><<<grid, kBlockQ * 2, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, lengths,
        n_heads, seq, sq, sk, sv, so, scale, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(int dtype, const void* q, const void* k,
                       const void* v, const void* dout, const float* lse,
                       const int* lengths, void* dq, void* dk, void* dv,
                       float* delta, int batch, int seq, int n_heads,
                       const Strides* s, float scale, cudaStream_t stream) {
  const dim3 grid(batch * n_heads, (seq + kBwdRows - 1) / kBwdRows);
  if (dtype == 0) {
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
  } else if (dtype == 1) {
    const bf16* qb = static_cast<const bf16*>(q);
    const bf16* kb = static_cast<const bf16*>(k);
    const bf16* vb = static_cast<const bf16*>(v);
    const bf16* db = static_cast<const bf16*>(dout);
    // staged rows as 16-byte vectors: d contiguous, rows 16-byte aligned
    bool vec = true;
    const void* ptrs[4] = {q, k, v, dout};
    for (int i = 0; i < 4; ++i) {
      vec = vec && s[i].d == 1 && aligned16(ptrs[i]) &&
            (s[i].b | s[i].t | s[i].h) % 8 == 0;
    }
    attention_bwd_dq_bf16_kernel<HD><<<grid, 128, 0, stream>>>(
        qb, kb, vb, db, lse, lengths, static_cast<bf16*>(dq), delta, n_heads,
        seq, s[0], s[1], s[2], s[3], s[4], scale, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    attention_bwd_dkdv_bf16_kernel<HD><<<grid, 128, 0, stream>>>(
        qb, kb, vb, db, lse, delta, lengths, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), n_heads, seq, s[0], s[1], s[2], s[3], s[5],
        s[6], scale, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 16 int64 values, (b, t, h, d)
// for q, k, v, o in elements.  lse: float32 (B*H, T) written when not null
// (the backward's input).  lengths: int32 (B,) or null.  head_dim: 16, 32 or
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

// The backward: dq, dk, dv (q's dtype) from q, k, v, dout and the forward's
// lse.  strides: 28 int64 values, (b, t, h, d) for q, k, v, dout, dq, dk,
// dv.  delta: float32 (B*H, T) scratch.  Returns the first failed launch's
// cudaError_t, else 0.
extern "C" int peppa_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* lengths,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int dtype, int batch, int seq, int n_heads,
                                   int head_dim, const long long* strides,
                                   float scale, void* stream) {
  Strides s[7];
  for (int i = 0; i < 7; ++i) s[i] = strides_at(strides, i);
  const float* l = static_cast<const float*>(lse);
  const int* lens = static_cast<const int*>(lengths);
  float* d = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_bwd<16>(dtype, q, k, v, dout, l, lens, dq, dk, dv, d,
                            batch, seq, n_heads, s, scale, st);
    case 32:
      return launch_bwd<32>(dtype, q, k, v, dout, l, lens, dq, dk, dv, d,
                            batch, seq, n_heads, s, scale, st);
    case 64:
      return launch_bwd<64>(dtype, q, k, v, dout, l, lens, dq, dk, dv, d,
                            batch, seq, n_heads, s, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
