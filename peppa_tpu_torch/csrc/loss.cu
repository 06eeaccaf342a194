// Fused L2-normalise + cosine matrix + two-way margin loss forward (sm_90a).
//
// Replaces the TPU kernel peppa_tpu/ops/pallas/loss.py `_loss_kernel`
// (called from `_fused_loss_fwd_call`):
//   Vn, An = rows of V, A scaled to unit L2 norm in float32 (eps 1e-12)
//   M = Vn An^T
//   loss = sum_{i != j} [max(0, m + M_ij - M_jj) + max(0, m + M_ij - M_ii)] / B^2
//
// Bound on an H100: V and A are read once (2*B*D*4 bytes) and one scalar is
// written; the product is 2*B^2*D float32 operations.  At the eval step's
// B=32, D=512 that is 128 KB against 1 MFLOP, so the kernel is bound by
// bytes and, at this size, by launch latency; at B=1024 the product
// dominates (float32 on the CUDA cores, 67 TFLOP/s).
//
// Design.  The Pallas kernel held both embedding blocks and the whole
// (B, B) score block in VMEM, which capped B at 1024; here nothing of size
// B^2 is kept, so any B works and neither B nor D is padded (edges are
// masked).  Three launches on one stream:
//   1. a row pass, one block per row i, writes Vn_i, An_i (float32 scratch)
//      and the diagonal M_ii = <Vn_i, An_i>;
//   2. a tiled pass, one 32x32 tile of M per block, stages 32-wide slices of
//      Vn and An through shared memory, applies both hinges with the
//      diagonal excluded and writes one partial sum per block;
//   3. one block sums the partials in a fixed order and divides by B^2, so
//      the result is the same from run to run (no atomics).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kTile = 32;       // tile of M per block: kTile x kTile
constexpr int kTileThreads = 256;  // each thread owns 4 entries of the tile
constexpr int kReduceThreads = 1024;

// Sum over the block in a fixed tree order; every thread gets the result.
template <int N>
__device__ float block_sum(float x, float* scratch) {
  scratch[threadIdx.x] = x;
  __syncthreads();
#pragma unroll
  for (int s = N / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) scratch[threadIdx.x] += scratch[threadIdx.x + s];
    __syncthreads();
  }
  const float total = scratch[0];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kRowThreads)
normalize_rows_kernel(const float* __restrict__ v, const float* __restrict__ a,
                      float* __restrict__ vn, float* __restrict__ an,
                      float* __restrict__ diag, int dim) {
  __shared__ float scratch[kRowThreads];
  const int i = blockIdx.x;
  const float* vr = v + static_cast<long long>(i) * dim;
  const float* ar = a + static_cast<long long>(i) * dim;
  float sv = 0.f, sa = 0.f;
  for (int d = threadIdx.x; d < dim; d += kRowThreads) {
    sv = fmaf(vr[d], vr[d], sv);
    sa = fmaf(ar[d], ar[d], sa);
  }
  const float nv = fmaxf(sqrtf(block_sum<kRowThreads>(sv, scratch)), 1e-12f);
  const float na = fmaxf(sqrtf(block_sum<kRowThreads>(sa, scratch)), 1e-12f);
  float dot = 0.f;
  for (int d = threadIdx.x; d < dim; d += kRowThreads) {
    const float x = vr[d] / nv;
    const float y = ar[d] / na;
    vn[static_cast<long long>(i) * dim + d] = x;
    an[static_cast<long long>(i) * dim + d] = y;
    dot = fmaf(x, y, dot);
  }
  const float mii = block_sum<kRowThreads>(dot, scratch);
  if (threadIdx.x == 0) diag[i] = mii;
}

__global__ void __launch_bounds__(kTileThreads)
hinge_tiles_kernel(const float* __restrict__ vn, const float* __restrict__ an,
                   const float* __restrict__ diag, float* __restrict__ partial,
                   int batch, int dim, float margin) {
  __shared__ float vt[kTile][kTile + 1];  // [row i][d], padded: no conflicts
  __shared__ float at[kTile][kTile + 1];  // [row j][d]
  __shared__ float scratch[kTileThreads];
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % kTile;       // column j within the tile
  const int ty = threadIdx.x / kTile;       // rows ty, ty+8, ty+16, ty+24
  constexpr int kRowsPerThread = kTile * kTile / kTileThreads;  // 4
  constexpr int kRowStep = kTileThreads / kTile;                // 8

  float acc[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
  for (int d0 = 0; d0 < dim; d0 += kTile) {
    for (int idx = threadIdx.x; idx < kTile * kTile; idx += kTileThreads) {
      const int r = idx / kTile;
      const int c = idx % kTile;
      const int d = d0 + c;
      const bool dok = d < dim;
      vt[r][c] = (i0 + r < batch && dok)
                     ? vn[static_cast<long long>(i0 + r) * dim + d] : 0.f;
      at[r][c] = (j0 + r < batch && dok)
                     ? an[static_cast<long long>(j0 + r) * dim + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      const float y = at[tx][c];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r)
        acc[r] = fmaf(vt[ty + r * kRowStep][c], y, acc[r]);
    }
    __syncthreads();
  }

  float local = 0.f;
  const int j = j0 + tx;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = i0 + ty + r * kRowStep;
    if (i < batch && j < batch && i != j) {
      const float mij = acc[r];
      local += fmaxf(margin + mij - diag[j], 0.f) +
               fmaxf(margin + mij - diag[i], 0.f);
    }
  }
  const float total = block_sum<kTileThreads>(local, scratch);
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = total;
}

__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const float* __restrict__ partial, int n,
                       float* __restrict__ out, float b2) {
  __shared__ float scratch[kReduceThreads];
  float s = 0.f;
  for (int p = threadIdx.x; p < n; p += kReduceThreads) s += partial[p];
  const float total = block_sum<kReduceThreads>(s, scratch);
  if (threadIdx.x == 0) out[0] = total / b2;
}

}  // namespace

// v, a: (B, D) float32, contiguous.  vn, an: (B, D) float32 scratch;
// diag: (B,); partial: (ceil(B/32)^2,); out: (1,).  Returns cudaError_t.
extern "C" int peppa_triplet_loss_fwd(const void* v, const void* a,
                                      void* vn, void* an, void* diag,
                                      void* partial, void* out, int batch,
                                      int dim, float margin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vp = static_cast<const float*>(v);
  const float* ap = static_cast<const float*>(a);
  float* vnp = static_cast<float*>(vn);
  float* anp = static_cast<float*>(an);
  float* dp = static_cast<float*>(diag);
  float* pp = static_cast<float*>(partial);

  normalize_rows_kernel<<<batch, kRowThreads, 0, s>>>(vp, ap, vnp, anp, dp,
                                                      dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles = (batch + kTile - 1) / kTile;
  hinge_tiles_kernel<<<dim3(tiles, tiles), kTileThreads, 0, s>>>(
      vnp, anp, dp, pp, batch, dim, margin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const float b2 = static_cast<float>(batch) * static_cast<float>(batch);
  reduce_partials_kernel<<<1, kReduceThreads, 0, s>>>(
      pp, tiles * tiles, static_cast<float*>(out), b2);
  return cudaGetLastError();
}
