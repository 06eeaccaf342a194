// Fused triplet loss and its closed-form gradient in one launch (sm_90a).
//
// Replaces the TPU kernel peppa_tpu/ops/pallas/loss.py `_loss_kernel`
// (called from `_fused_loss_fwd_call`) and its `custom_vjp` backward `_bwd`,
// which the JAX package runs as XLA.  With n the row norms (float32, clamped
// at 1e-12), Vn = V / nv, An = A / na, M = Vn An^T and margin m:
//   col_ij = [m + M_ij - M_jj > 0], row_ij = [m + M_ij - M_ii > 0]   (i != j)
//   loss   = sum_{i != j} [max(0, m + M_ij - M_jj) + max(0, m + M_ij - M_ii)] / B^2
//   G_ij   = (col_ij + row_ij) / B^2  (i != j),
//   G_ii   = -(sum_k col_ki + sum_k row_ik) / B^2                  (dloss/dM)
//   dV_i   = (sum_j G_ij An_j - Vn_i s_i) / nv_i,  s_i = <dVn_i, Vn_i> = sum_j G_ij M_ij
//   dA_j   = (sum_i G_ij Vn_i - An_j t_j) / na_j,  t_j = <dAn_j, An_j> = sum_i G_ij M_ij
// The projection terms s and t come from M and G alone, so the gradient is
// one more pass over D, written straight to the outputs.  The gradient is
// for an output gradient of 1; the wrapper scales it.
//
// Bound on an H100: V and A read once, dV and dA written once (4*B*D*4 bytes
// with the gradient, 2*B*D*4 without); 2*B^2*D float32 operations for M and
// 4*B^2*D more for G An and G^T Vn, on the CUDA cores (67 TFLOP/s).  At the
// main paths' B = 8 and 32, D = 512, that is 0.01-0.08 microseconds, far
// below one launch: the time is the launch and the chain of dependent steps
// inside the kernel.
//
// Design.  B <= 64 (every main path: B = 8 in training, 32 in the eval step
// and serving): ONE launch of one thread-block cluster of up to 8 CTAs, each
// owning a slice of (at most) 64 columns of D.  At these sizes the time is
// a chain of latencies (loads, barriers, shared-memory round trips), so each
// step issues all its loads before it uses them.  Each CTA
//   1. loads its slice of V and A into shared memory once and sums the
//      squares of each row; the CTAs exchange these partial sums through
//      distributed shared memory (DSMEM), and each adds them in rank order:
//      the norms;
//   2. scales the slice in place (x / n, as the JAX package rounds) and
//      accumulates its partial M in a register tile with float32 FMAs (no
//      TF32 or bf16 tensor cores, which would round M differently from the
//      plain version); each CTA then adds the cluster's partial Ms in rank
//      order (128-bit DSMEM reads), so all hold the same M;
//   3. in one pass, a warp per row (and, with the gradient, per column):
//      both hinges and the loss (a fixed-order block sum; rank 0 writes
//      it); with the gradient, G, the integer counts of active hinges by
//      ballot, and s and t by warp sums;
//   4. with the gradient, writes its slice of dV (four warps) and dA (the
//      other four) from G and the slice still in shared memory.
// Splitting D, not the rows, keeps steps 3 and 4 local to each CTA: the
// partial sums of squares and the partial M are the only exchanges.
// B > 64 (no main path): a row pass (norms, diagonal), then a grid of 32x32
// tiles of M (loss partials, whose last block to finish adds them in a fixed
// order, and with the gradient the hinge codes of G and per-tile row and
// column sums), then with the gradient a grid of 32-row x 64-column tiles
// of dV and dA.  Its scratch is B^2 bytes of codes and O(B^2 / 32) words,
// never B x D.
// Every float sum runs in a fixed order (no float atomics; the only atomic
// is the tile pass's integer count of finished blocks), so repeated calls
// are bit-identical.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // every kernel: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-12f;

// the one-cluster kernel
constexpr int kSmallB = 64;     // largest batch it takes
constexpr int kSlice = 64;      // columns of D per CTA, and per staged chunk
constexpr int kSliceLd = kSlice + 4;  // 16-byte rows
constexpr int kMaxCluster = 8;  // the portable cluster size

// the tiled path (B > 64)
constexpr int kTile = 32;   // M tile: kTile x kTile
constexpr int kDTile = 64;  // columns of dV / dA per gradient block

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;  // the butterfly gives every lane the same bits
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the block in a fixed order; every thread gets the total.
__device__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// ------------------------------------------------------- one cluster, B <= 64
// Shared memory of the cluster kernel (dynamic): `xs`, this CTA's chunk of
// kSlice columns of V (rows [0, 16 R)) and A (rows [16 R, 32 R)), raw, then
// scaled by 1 / n in place; `part`, this CTA's partial M (row stride
// ldp = B rounded up to 4, for 128-bit reads); `m` and `g`, M and G (odd row
// stride ldm, so a warp reading a column hits 32 banks).
size_t cluster_smem_bytes(int r, int batch) {
  const size_t b = batch, ldp = (b + 3) & ~size_t{3}, ldm = b | 1;
  return sizeof(float) *
         (2 * 16 * static_cast<size_t>(r) * kSliceLd + b * ldp + 2 * b * ldm);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// xs <- columns [d0, d0 + kSlice) of the rows of V and A (0 past d_hi and
// past the batch); every load of the thread is issued before any store.
template <int R>
__device__ __forceinline__ void load_chunk(float* xs,
                                           const float* __restrict__ v,
                                           const float* __restrict__ a,
                                           int batch, int dim, int d0,
                                           int d_hi) {
  constexpr int kRows = 16 * R;
  constexpr int kPer = 2 * kRows * kSlice / kThreads;
  float x[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int r = e / kSlice, d = d0 + e % kSlice;
    const int i = r < kRows ? r : r - kRows;
    const float* src = r < kRows ? v : a;
    x[u] = (i < batch && d < d_hi) ? src[static_cast<long long>(i) * dim + d]
                                   : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads;
    xs[(e / kSlice) * kSliceLd + e % kSlice] = x[u];
  }
}

// xs <- xs / n, row by row (Vn, An: the division the JAX package rounds).
template <int R>
__device__ __forceinline__ void scale_chunk(float* xs, const float* norm) {
  constexpr int kQuads = kSlice / 4;
  constexpr int kPer = 2 * 16 * R * kQuads / kThreads;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int r = e / kQuads;
    float4* p = reinterpret_cast<float4*>(xs + r * kSliceLd) + e % kQuads;
    float4 x = *p;
    const float n = norm[r];
    x.x /= n;
    x.y /= n;
    x.z /= n;
    x.w /= n;
    *p = x;
  }
}

// The 128 threads of warps 0-3 (dV) or 4-7 (dA, kTrans) write
//   out[i][d0 + c] = (sum_k G'_ik x[k][c] - own[i][c] proj[i]) / n[i]
// for rows i = rg + 8 u and columns c = 4 cg .. 4 cg + 3, with G' = G (dV:
// x = An, own = Vn) or G^T (dA: x = Vn, own = An).
template <int R, bool kTrans>
__device__ __forceinline__ void grad_chunk(const float* g, int ldm,
                                           const float* x, const float* own,
                                           const float* proj, const float* n,
                                           float* __restrict__ out, int batch,
                                           int dim, int d0, int d_hi) {
  constexpr int kRowsPerThread = 2 * R;  // 16 R rows over 8 row groups
  const int t = threadIdx.x & 127, c = 4 * (t & 15), rg = t >> 4;
  float acc[kRowsPerThread][4] = {};
#pragma unroll 4
  for (int k = 0; k < batch; ++k) {
    const float4 xk = *reinterpret_cast<const float4*>(x + k * kSliceLd + c);
    float gk[kRowsPerThread];
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      const int i = rg + 8 * u;
      gk[u] = i < batch ? (kTrans ? g[k * ldm + i] : g[i * ldm + k]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRowsPerThread; ++u) {
      acc[u][0] = fmaf(gk[u], xk.x, acc[u][0]);
      acc[u][1] = fmaf(gk[u], xk.y, acc[u][1]);
      acc[u][2] = fmaf(gk[u], xk.z, acc[u][2]);
      acc[u][3] = fmaf(gk[u], xk.w, acc[u][3]);
    }
  }
#pragma unroll
  for (int u = 0; u < kRowsPerThread; ++u) {
    const int i = rg + 8 * u;
    if (i >= batch) continue;
    const float4 o = *reinterpret_cast<const float4*>(own + i * kSliceLd + c);
    const float own_c[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int d = d0 + c + l;
      if (d < d_hi)
        out[static_cast<long long>(i) * dim + d] =
            (acc[u][l] - own_c[l] * proj[i]) / n[i];
    }
  }
}

// R = ceil(B / 16): for M the threads form a 16 x 16 grid, each with an
// R x R tile (rows ty + 16 r, columns tx + 16 q).
template <int R, bool kGrad>
__global__ void __launch_bounds__(kThreads)
loss_cluster_kernel(const float* __restrict__ v, const float* __restrict__ a,
                    float* __restrict__ loss, float* __restrict__ dv,
                    float* __restrict__ da, int batch, int dim,
                    float margin) {
  constexpr int kRows = 16 * R;
  extern __shared__ __align__(16) float dyn[];
  __shared__ float sq[2 * kSmallB];    // partial sums of squares, by xs row
  __shared__ float norm[2 * kSmallB];  // nv (rows < kRows), na, by xs row
  __shared__ float diag[kSmallB];
  __shared__ float proj[2][kSmallB];   // s, t
  __shared__ int count[2][kSmallB];    // active row hinges of row i, column hinges of column i
  __shared__ float red[kWarps];
  const int ldp = (batch + 3) & ~3, ldm = batch | 1;
  float* xs = dyn;
  float* part = xs + 2 * kRows * kSliceLd;
  float* m = part + batch * ldp;
  float* g = m + batch * ldm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nrank = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int per = (dim + nrank - 1) / nrank;
  const int d_lo = min(dim, rank * per);
  const int d_hi = min(dim, d_lo + per);
  const bool resident = per <= kSlice;  // the slice is one chunk: load once

  // 1. the norms: sums of squares over this slice, then over the cluster
  float own_sq = 0.f;  // thread r < 2 kRows: xs row r
  for (int d0 = d_lo; d0 < d_hi; d0 += kSlice) {
    load_chunk<R>(xs, v, a, batch, dim, d0, d_hi);
    __syncthreads();
    if (tid < 2 * kRows) {
      const float4* row = reinterpret_cast<const float4*>(xs + tid * kSliceLd);
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < kSlice / 4; ++q) {
        const float4 x = row[q];
        s[0] = fmaf(x.x, x.x, s[0]);
        s[1] = fmaf(x.y, x.y, s[1]);
        s[2] = fmaf(x.z, x.z, s[2]);
        s[3] = fmaf(x.w, x.w, s[3]);
      }
      own_sq += (s[0] + s[1]) + (s[2] + s[3]);
    }
    __syncthreads();
  }
  if (tid < 2 * kRows) sq[tid] = own_sq;
  cluster.sync();
  if (tid < 2 * kRows) {
    float p[kMaxCluster];
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k)
      p[k] = k < nrank ? *cluster.map_shared_rank(&sq[tid], k) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) s += p[k];
    norm[tid] = fmaxf(sqrtf(s), kEps);
  }
  __syncthreads();

  // 2. this slice's partial M, then M summed over the cluster in rank order
  float acc[R][R] = {};
  for (int d0 = d_lo; d0 < d_hi; d0 += kSlice) {
    if (!resident) {
      load_chunk<R>(xs, v, a, batch, dim, d0, d_hi);
      __syncthreads();
    }
    scale_chunk<R>(xs, norm);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kSlice; c += 4) {
      float4 x[R], y[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        x[r] = *reinterpret_cast<const float4*>(
            xs + (ty + 16 * r) * kSliceLd + c);
        y[r] = *reinterpret_cast<const float4*>(
            xs + (kRows + tx + 16 * r) * kSliceLd + c);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < R; ++q) {
          acc[r][q] = fmaf(x[r].x, y[q].x, acc[r][q]);
          acc[r][q] = fmaf(x[r].y, y[q].y, acc[r][q]);
          acc[r][q] = fmaf(x[r].z, y[q].z, acc[r][q]);
          acc[r][q] = fmaf(x[r].w, y[q].w, acc[r][q]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = ty + 16 * r, j = tx + 16 * q;
      if (i < batch && j < batch) part[i * ldp + j] = acc[r][q];
    }
  cluster.sync();
  {
    // 4 entries of a row per thread and rank, every remote load issued
    // before any store
    constexpr int kPer = (kRows * kRows / 4 + kThreads - 1) / kThreads;
    const int quads = ldp / 4;
    float4 sums[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads;
      sums[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e < batch * quads) {
        float4 p[kMaxCluster];
#pragma unroll
        for (int k = 0; k < kMaxCluster; ++k)
          p[k] = k < nrank ? *cluster.map_shared_rank(
                                 reinterpret_cast<float4*>(part) + e, k)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < kMaxCluster; ++k) {
          sums[u].x += p[k].x;
          sums[u].y += p[k].y;
          sums[u].z += p[k].z;
          sums[u].w += p[k].w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads;
      if (e >= batch * quads) continue;
      const int i = e / quads, j0 = 4 * (e % quads);
      const float s[4] = {sums[u].x, sums[u].y, sums[u].z, sums[u].w};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        if (j0 + l >= batch) continue;
        m[i * ldm + j0 + l] = s[l];
        if (j0 + l == i) diag[i] = s[l];
      }
    }
  }
  // this CTA has read every partial it needs; the wait before leaving keeps
  // its own `part` alive until every CTA has read it
  cluster_arrive();
  __syncthreads();

  // 3. hinges and the loss.  Warp w takes rows i = w, w + 8, ... and, with
  // the gradient, the columns of the same numbers; its lanes run over the
  // other index.  The items are unrolled, so their loads and warp sums
  // overlap.
  constexpr int kItems = 16 * R / kWarps;
  const float b2 = static_cast<float>(batch) * static_cast<float>(batch);
  const float inv_b2 = 1.f / b2;
  const int lanes_end = (batch + 31) & ~31;
  float local = 0.f;
  int n_row[kItems], n_col[kItems];
  float s_row[kItems], t_col[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = warp + kWarps * u;
    n_row[u] = n_col[u] = 0;
    s_row[u] = t_col[u] = 0.f;
    if (i >= batch) continue;
    const float mii = diag[i];
    for (int j = lane; j < lanes_end; j += 32) {
      const bool off = j < batch && j != i;
      const float mjj = j < batch ? diag[j] : 0.f;
      const float mij = j < batch ? m[i * ldm + j] : 0.f;  // row i
      const float hc = margin + mij - mjj, hr = margin + mij - mii;
      if (off) local += fmaxf(hc, 0.f) + fmaxf(hr, 0.f);
      if constexpr (kGrad) {
        n_row[u] += __popc(__ballot_sync(0xffffffffu, off && hr > 0.f));
        const float gij =
            static_cast<float>(off ? (hc > 0.f) + (hr > 0.f) : 0) * inv_b2;
        s_row[u] = fmaf(gij, mij, s_row[u]);
        if (off) g[i * ldm + j] = gij;
        const float mji = j < batch ? m[j * ldm + i] : 0.f;  // column i
        const float hc_t = margin + mji - mii, hr_t = margin + mji - mjj;
        n_col[u] += __popc(__ballot_sync(0xffffffffu, off && hc_t > 0.f));
        const float gji =
            static_cast<float>(off ? (hc_t > 0.f) + (hr_t > 0.f) : 0) *
            inv_b2;
        t_col[u] = fmaf(gji, mji, t_col[u]);
      }
    }
  }
  const float total = block_sum(local, red);
  if (rank == 0 && tid == 0) loss[0] = total / b2;

  if constexpr (kGrad) {
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      s_row[u] = warp_sum(s_row[u]);
      t_col[u] = warp_sum(t_col[u]);
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int i = warp + kWarps * u;
      if (lane == 0 && i < batch) {
        count[0][i] = n_row[u];
        count[1][i] = n_col[u];
        proj[0][i] = s_row[u];
        proj[1][i] = t_col[u];
      }
    }
    __syncthreads();
    // G's diagonal, and its terms of s and t
    for (int i = tid; i < batch; i += kThreads) {
      const float gii =
          static_cast<float>(-(count[0][i] + count[1][i])) * inv_b2;
      g[i * ldm + i] = gii;
      proj[0][i] = fmaf(gii, diag[i], proj[0][i]);
      proj[1][i] = fmaf(gii, diag[i], proj[1][i]);
    }
    __syncthreads();

    // 4. this slice of dV (warps 0-3) and dA (warps 4-7)
    for (int d0 = d_lo; d0 < d_hi; d0 += kSlice) {
      if (!resident) {
        load_chunk<R>(xs, v, a, batch, dim, d0, d_hi);
        __syncthreads();
        scale_chunk<R>(xs, norm);
        __syncthreads();
      }
      if (warp < kWarps / 2)
        grad_chunk<R, false>(g, ldm, xs + kRows * kSliceLd, xs, proj[0], norm,
                             dv, batch, dim, d0, d_hi);
      else
        grad_chunk<R, true>(g, ldm, xs, xs + kRows * kSliceLd, proj[1],
                            norm + kRows, da, batch, dim, d0, d_hi);
      __syncthreads();
    }
  }
  cluster_wait();
}

// ------------------------------------------------------------ tiles, B > 64
// Launch 1: one warp per row: nv_i, na_i and M_ii.  Block 0 clears the count
// of finished tile blocks.
__global__ void __launch_bounds__(kThreads)
loss_rows_kernel(const float* __restrict__ v, const float* __restrict__ a,
                 float* __restrict__ norm, float* __restrict__ diag,
                 unsigned* __restrict__ done, int batch, int dim) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blockIdx.x == 0 && threadIdx.x == 0) *done = 0u;
  if (i >= batch) return;
  const float* vr = v + static_cast<long long>(i) * dim;
  const float* ar = a + static_cast<long long>(i) * dim;
  float sv = 0.f, sa = 0.f;
  for (int d = lane; d < dim; d += 32) {
    sv = fmaf(vr[d], vr[d], sv);
    sa = fmaf(ar[d], ar[d], sa);
  }
  const float nv = fmaxf(sqrtf(warp_sum(sv)), kEps);
  const float na = fmaxf(sqrtf(warp_sum(sa)), kEps);
  float dot = 0.f;
  for (int d = lane; d < dim; d += 32) dot = fmaf(vr[d] / nv, ar[d] / na, dot);
  dot = warp_sum(dot);
  if (lane == 0) {
    norm[i] = nv;
    norm[batch + i] = na;
    diag[i] = dot;
  }
}

// Launch 2: one 32x32 tile of M per block (thread: column tx, rows ty + 8 r).
// Writes the tile's loss partial; the last block to finish adds them all in
// tile order.  With the gradient also: code_ij = col_ij + row_ij, and per
// tile the row sums (count of row hinges, sum of code_ij M_ij over the
// tile's columns) and the column sums (column hinges, code_ij M_ij over its
// rows).
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
loss_tiles_kernel(const float* __restrict__ v, const float* __restrict__ a,
                  const float* __restrict__ norm,
                  const float* __restrict__ diag, float* __restrict__ partial,
                  unsigned* __restrict__ done, float* __restrict__ loss,
                  uint8_t* __restrict__ code, int* __restrict__ count_part,
                  float* __restrict__ proj_part, int batch, int dim,
                  float margin) {
  constexpr int kRowsPerThread = kTile * kTile / kThreads;  // 4
  constexpr int kRowStep = kThreads / kTile;                // 8
  __shared__ float vt[kTile][kTile + 1];
  __shared__ float at[kTile][kTile + 1];
  __shared__ int col_flag[kGrad ? kTile : 1][kTile + 1];
  __shared__ float col_dot[kGrad ? kTile : 1][kTile + 1];
  __shared__ float red[kWarps];
  __shared__ bool last;
  const int tiles = gridDim.x;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const float* nv = norm;
  const float* na = norm + batch;

  float acc[kRowsPerThread] = {};
  for (int d0 = 0; d0 < dim; d0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile, d = d0 + c;
      const bool dok = d < dim;
      vt[r][c] = (i0 + r < batch && dok)
                     ? v[static_cast<long long>(i0 + r) * dim + d] / nv[i0 + r]
                     : 0.f;
      at[r][c] = (j0 + r < batch && dok)
                     ? a[static_cast<long long>(j0 + r) * dim + d] / na[j0 + r]
                     : 0.f;
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

  const int j = j0 + tx;
  const float mjj = j < batch ? diag[j] : 0.f;
  float local = 0.f;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = i0 + ty + r * kRowStep;
    const bool in = i < batch && j < batch;
    const bool off = in && i != j;
    const float mij = acc[r];
    const float hc = margin + mij - mjj;
    const float hr = margin + mij - (i < batch ? diag[i] : 0.f);
    if (off) local += fmaxf(hc, 0.f) + fmaxf(hr, 0.f);
    if constexpr (kGrad) {
      const int col = off && hc > 0.f, row = off && hr > 0.f;
      const float cm = static_cast<float>(col + row) * mij;
      if (in) code[static_cast<long long>(i) * batch + j] =
          static_cast<uint8_t>(col + row);
      const int n_row = warp_sum(row);  // the warp holds row i's 32 columns
      const float s_row = warp_sum(cm);
      if (tx == 0 && i < batch) {
        count_part[blockIdx.x * batch + i] = n_row;
        proj_part[blockIdx.x * batch + i] = s_row;
      }
      col_flag[ty + r * kRowStep][tx] = col;
      col_dot[ty + r * kRowStep][tx] = cm;
    }
  }
  if constexpr (kGrad) {
    __syncthreads();
    if (threadIdx.x < kTile && j < batch) {
      int n_col = 0;
      float s_col = 0.f;
      for (int r = 0; r < kTile; ++r) {
        n_col += col_flag[r][tx];
        s_col += col_dot[r][tx];
      }
      count_part[(tiles + blockIdx.y) * batch + j] = n_col;
      proj_part[(tiles + blockIdx.y) * batch + j] = s_col;
    }
  }

  const float total = block_sum(local, red);
  if (threadIdx.x == 0) {
    partial[blockIdx.y * tiles + blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(done, 1u) == static_cast<unsigned>(tiles * tiles - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.f;
  for (int p = threadIdx.x; p < tiles * tiles; p += kThreads)
    s += __ldcg(partial + p);
  const float sum = block_sum(s, red);
  if (threadIdx.x == 0)
    loss[0] = sum / (static_cast<float>(batch) * static_cast<float>(batch));
}

// Launch 3: blockIdx.z 0 writes a 32-row x 64-column tile of dV, 1 of dA
// (thread: rows ty + 16 r, columns tx + 16 q).  G is rebuilt from the codes
// and the per-tile counts; s and t from the per-tile sums.
__global__ void __launch_bounds__(kThreads)
loss_grad_kernel(const float* __restrict__ v, const float* __restrict__ a,
                 const float* __restrict__ norm,
                 const float* __restrict__ diag,
                 const uint8_t* __restrict__ code,
                 const int* __restrict__ count_part,
                 const float* __restrict__ proj_part, float* __restrict__ dv,
                 float* __restrict__ da, int batch, int dim) {
  __shared__ float gs[kTile][kTile + 1];    // gs[k][i] = G'_{i0+i, k0+k}
  __shared__ float xs[kTile][kDTile + 1];   // (rows k0.. of X) / n
  __shared__ float proj[kTile], gdiag[kTile];
  const bool trans = blockIdx.z == 1;  // dA: G' = G^T, X = Vn, own = An
  const float* own = trans ? a : v;
  const float* other = trans ? v : a;
  const float* n_own = norm + (trans ? batch : 0);
  const float* n_other = norm + (trans ? 0 : batch);
  float* out = trans ? da : dv;
  const int tiles = (batch + kTile - 1) / kTile;
  const int i0 = blockIdx.y * kTile, d0 = blockIdx.x * kDTile;
  const float inv_b2 =
      1.f / (static_cast<float>(batch) * static_cast<float>(batch));
  if (threadIdx.x < kTile) {
    const int i = i0 + threadIdx.x;
    float gii = 0.f, s = 0.f;
    if (i < batch) {
      int n = 0;
      for (int t = 0; t < tiles; ++t) {
        n += count_part[t * batch + i] + count_part[(tiles + t) * batch + i];
        s += proj_part[((trans ? tiles : 0) + t) * batch + i];
      }
      gii = static_cast<float>(-n) * inv_b2;
      s = s * inv_b2 + gii * diag[i];
    }
    gdiag[threadIdx.x] = gii;
    proj[threadIdx.x] = s;
  }
  __syncthreads();

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < batch; k0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;  // c runs along a row of codes
      if (!trans) {  // G'_{ik} = G_{ik}: codes row i = i0 + r, column k0 + c
        const int i = i0 + r, k = k0 + c;
        gs[c][r] = (i < batch && k < batch)
                       ? (i == k ? gdiag[r]
                                 : static_cast<float>(
                                       code[static_cast<long long>(i) * batch +
                                            k]) * inv_b2)
                       : 0.f;
      } else {  // G'_{jk} = G_{kj}: codes row k = k0 + r, column j = i0 + c
        const int k = k0 + r, jj = i0 + c;
        gs[r][c] = (jj < batch && k < batch)
                       ? (jj == k ? gdiag[c]
                                  : static_cast<float>(
                                        code[static_cast<long long>(k) * batch +
                                             jj]) * inv_b2)
                       : 0.f;
      }
    }
    for (int e = threadIdx.x; e < kTile * kDTile; e += kThreads) {
      const int r = e / kDTile, c = e % kDTile, k = k0 + r, d = d0 + c;
      xs[r][c] = (k < batch && d < dim)
                     ? other[static_cast<long long>(k) * dim + d] / n_other[k]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      float gk[2], xk[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) gk[r] = gs[kk][ty + 16 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) xk[q] = xs[kk][tx + 16 * q];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(gk[r], xk[q], acc[r][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + ty + 16 * r, d = d0 + tx + 16 * q;
      if (i < batch && d < dim) {
        const long long at_id = static_cast<long long>(i) * dim + d;
        out[at_id] =
            (acc[r][q] - own[at_id] / n_own[i] * proj[ty + 16 * r]) / n_own[i];
      }
    }
}

template <int R, bool kGrad>
cudaError_t launch_cluster(const float* v, const float* a, float* loss,
                           float* dv, float* da, int batch, int dim,
                           float margin, cudaStream_t s) {
  auto kernel = loss_cluster_kernel<R, kGrad>;
  const size_t smem = cluster_smem_bytes(R, batch);
  // past 48 KB with the static arrays (B > 32) only after this opt-in
  if (smem > 40 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int want = (dim + kSlice - 1) / kSlice;
  const int nrank = want > kMaxCluster ? kMaxCluster : want;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nrank, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nrank;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, v, a, loss, dv, da,
                                             batch, dim, margin);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kGrad>
cudaError_t launch_small(const float* v, const float* a, float* loss,
                         float* dv, float* da, int batch, int dim,
                         float margin, cudaStream_t s) {
  if (batch <= 16)
    return launch_cluster<1, kGrad>(v, a, loss, dv, da, batch, dim, margin, s);
  if (batch <= 32)
    return launch_cluster<2, kGrad>(v, a, loss, dv, da, batch, dim, margin, s);
  return launch_cluster<4, kGrad>(v, a, loss, dv, da, batch, dim, margin, s);
}

long long tiles_of(int batch) { return (batch + kTile - 1) / kTile; }

}  // namespace

// Scratch the kernel needs beyond its outputs, in 4-byte words: 0 for
// B <= 64 (one launch, everything in shared memory).
extern "C" long long peppa_triplet_loss_workspace(int batch, int grad) {
  if (batch <= kSmallB) return 0;
  const long long b = batch, t = tiles_of(batch);
  long long n = 3 * b + t * t + 1;  // norms, diagonal, partials, counter
  if (grad) n += 4 * t * b + (b * b + 3) / 4;  // per-tile sums, codes
  return n;
}

// v, a: (B, D) float32, contiguous, B >= 1, D >= 1.  loss: one float.
// dv, da: (B, D) float32 outputs, or both null for the loss alone.  work:
// peppa_triplet_loss_workspace(B, dv != null) words, 4-byte aligned.
// Returns a cudaError_t.
extern "C" int peppa_triplet_loss(const void* v, const void* a, void* loss,
                                  void* dv, void* da, void* work, int batch,
                                  int dim, float margin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* vp = static_cast<const float*>(v);
  const float* ap = static_cast<const float*>(a);
  float* lp = static_cast<float*>(loss);
  float* dvp = static_cast<float*>(dv);
  float* dap = static_cast<float*>(da);
  const bool grad = dvp != nullptr;
  if (batch <= kSmallB)
    return grad ? launch_small<true>(vp, ap, lp, dvp, dap, batch, dim, margin,
                                     s)
                : launch_small<false>(vp, ap, lp, nullptr, nullptr, batch,
                                      dim, margin, s);

  const long long b = batch;
  const int tiles = static_cast<int>(tiles_of(batch));
  float* w = static_cast<float*>(work);
  float* norm = w;
  float* diag = norm + 2 * b;
  float* partial = diag + b;
  unsigned* done = reinterpret_cast<unsigned*>(partial + tiles * tiles);
  int* count_part = reinterpret_cast<int*>(done + 1);
  float* proj_part = reinterpret_cast<float*>(count_part + 2 * tiles * b);
  uint8_t* code = reinterpret_cast<uint8_t*>(proj_part + 2 * tiles * b);

  loss_rows_kernel<<<(batch + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      vp, ap, norm, diag, done, batch, dim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles, tiles);
  if (grad)
    loss_tiles_kernel<true><<<grid, kThreads, 0, s>>>(
        vp, ap, norm, diag, partial, done, lp, code, count_part, proj_part,
        batch, dim, margin);
  else
    loss_tiles_kernel<false><<<grid, kThreads, 0, s>>>(
        vp, ap, norm, diag, partial, done, lp, nullptr, nullptr, nullptr,
        batch, dim, margin);
  err = cudaGetLastError();
  if (err != cudaSuccess || !grad) return err;
  loss_grad_kernel<<<dim3((dim + kDTile - 1) / kDTile, tiles, 2), kThreads, 0,
                     s>>>(vp, ap, norm, diag, code, count_part, proj_part, dvp,
                          dap, batch, dim);
  return cudaGetLastError();
}
