// Multi-head self-attention forward for the wav2vec2 transformer (sm_90a).
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
// (no TF32), chunks of 16 keys per rescale.

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
    bf16* op = obase + row * so.t;
#pragma unroll
    for (int j = 0; j < kDimTiles; ++j) {
      const int col = j * 8 + tq * 2;
      op[col * so.d] = __float2bfloat16(acc[j][2 * r] * inv);
      op[(col + 1) * so.d] = __float2bfloat16(acc[j][2 * r + 1] * inv);
    }
  }
}

// ------------------------------------------------------------- launch

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int HD>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, const int* lengths, int batch, int seq,
                   int n_heads, Strides sq, Strides sk, Strides sv,
                   Strides so, float scale, cudaStream_t stream) {
  const dim3 grid(batch * n_heads, (seq + kBlockQ - 1) / kBlockQ);
  if (dtype == 0) {
    attention_fwd_f32_kernel<HD><<<grid, kBlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lengths,
        n_heads, seq, sq, sk, sv, so, scale);
  } else if (dtype == 1) {
    // K/V rows as 16-byte vectors: d contiguous, rows 16-byte aligned
    const bool vec = sk.d == 1 && sv.d == 1 && aligned16(k) && aligned16(v) &&
                     (sk.b | sk.t | sk.h | sv.b | sv.t | sv.h) % 8 == 0;
    attention_fwd_bf16_kernel<HD><<<grid, kBlockQ * 2, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lengths, n_heads,
        seq, sq, sk, sv, so, scale, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 16 int64 values, (b, t, h, d)
// for q, k, v, o in elements.  lengths: int32 (B,) or null.  head_dim: 16,
// 32 or 64.  Returns the launch's cudaError_t.
extern "C" int peppa_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o,
                                   const void* lengths, int dtype, int batch,
                                   int seq, int n_heads, int head_dim,
                                   const long long* strides, float scale,
                                   void* stream) {
  const Strides sq{strides[0], strides[1], strides[2], strides[3]};
  const Strides sk{strides[4], strides[5], strides[6], strides[7]};
  const Strides sv{strides[8], strides[9], strides[10], strides[11]};
  const Strides so{strides[12], strides[13], strides[14], strides[15]};
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch<16>(dtype, q, k, v, o, lens, batch, seq, n_heads, sq, sk,
                        sv, so, scale, s);
    case 32:
      return launch<32>(dtype, q, k, v, o, lens, batch, seq, n_heads, sq, sk,
                        sv, so, scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, lens, batch, seq, n_heads, sq, sk,
                        sv, so, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}
