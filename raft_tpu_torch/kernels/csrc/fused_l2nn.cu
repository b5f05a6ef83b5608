// Kernel B1 (fused L2 nearest neighbour) and kernel B3 (the k-means
// E-step plus the M-step partials) for Hopper (sm_90a).
//
// Replaces raft_tpu/kernels/fused_l2nn.py: fused_l2_nn_pallas (body
// _kernel) and _fused_l2_nn_partials (body _em_kernel).
//
// B1 computes, per row of x, min over rows of y of
//   max(||x||^2 + ||y||^2 - 2 x.y, 0)
// and the index of that row; the LOWEST index wins exact ties.  One block
// owns a 64-row tile of x and streams 64-centroid tiles of y through
// shared memory; each thread keeps a 4x4 block of dot products in
// registers (plain float32 FMA: no TF32, the f32 contract needs true f32
// products), folds them into a running (min, argmin) per row in the
// epilogue, and the 16 threads sharing a row reduce with the same
// (value, index) rule at the end.  The distance tile never reaches device
// memory.  Bound: at d = 128 the work is 2*m*k*d FLOP against 4*(m + k)*d
// bytes, so it is bound by the card's float32 (non-tensor) FMA rate, not
// by memory; the simple register tiling here reaches a fraction of that
// peak, and wgmma-free f32 tiling with a deeper pipeline is later work.
//
// B3 adds the M-step partials (k, d) sum of w*x and (k,) sum of w per
// cluster, without atomics and without sorting the rows by label.  Each
// block sums the rows of its fixed chunk into its own partials; a second
// launch adds the chunks' partials in chunk order.  Every sum is taken in
// an order fixed by the shapes alone, so the partials repeat bit for bit
// from run to run.  Two shapes:
//
// * Narrow rows, d <= EM_MAX_D and k <= EM_MAX_K (the IVF-PQ codebooks:
//   pq_dim subspaces of 262,144 x 2, 256 codewords each), em_small_kernel:
//   E and M fused, every subspace in one launch, grid (row chunks, S).  A
//   block stages its subspace's centres and their norms in shared memory;
//   a thread owns a few rows and keeps them in registers across all
//   centres, with the distance in the operation order of B1's epilogue (a
//   dot from 0 by fmaf in feature order; the norms the same way).  Then
//   32 rows at a time per warp: __match_any_sync groups the lanes of one
//   label, and the group's lowest lane adds its members, in lane (= row)
//   order, into the warp's own partials in shared memory.  The warps'
//   partials are added in warp order.  A subspace's blocks and their order
//   do not depend on S: one launch for S subspaces gives the bits of S
//   launches of one.  B1's 64x64 tile would stage and
//   multiply 30 zero columns of every 32 at d = 2.  Bound: issued float32
//   instructions, about (d + 4) per (row, centre) pair.
// * Wide rows, cluster_partials_kernel after B1's E-step, grid (row
//   chunks, column slabs of CP_SW, cluster ranges of CP_KR): the chunk's
//   rows are staged CP_TILE at a time (the next tile's loads in flight
//   while the current one is summed); the label groups of each 32 rows are
//   matched once per tile, and each warp, owning CP_CPW columns of the
//   slab, adds a label's members in row order into the block's (cluster,
//   column) partials in shared memory.  Bound: one read of x (memory).
//
// Each entry point returns cudaGetLastError() right after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // x rows per block
constexpr int BN = 64;   // centroids per tile
constexpr int BK = 32;   // feature slab per shared-memory stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // centroids per thread
constexpr int COLS = BN / TN;              // 16 threads across a row
constexpr int THREADS = (BM / TM) * COLS;  // 256

__device__ __forceinline__ float operand(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// (v, i) beats (bv, bi): smaller value, or equal value and lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_l2nn_kernel(const float* __restrict__ x, const float* __restrict__ xn,
                  const float* __restrict__ y, const float* __restrict__ yn,
                  float* __restrict__ val, int* __restrict__ idx, int m,
                  int k, int d) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float ys[BK][BN + 1];
  __shared__ float red_v[BM][COLS];
  __shared__ int red_i[BM][COLS];

  const int tid = threadIdx.x;
  const int tx = tid % COLS;
  const int ty = tid / COLS;
  const int row0 = blockIdx.x * BM;

  float xnr[TM];
  float best_v[TM];
  int best_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
    xnr[i] = r < m ? xn[r] : 0.f;
    best_v[i] = INFINITY;
    best_i[i] = INT32_MAX;
  }

  for (int c0 = 0; c0 < k; c0 += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      // coalesced loads: a warp reads 32 consecutive features of one row
#pragma unroll
      for (int l = 0; l < (BM * BK) / THREADS; ++l) {
        const int e = l * THREADS + tid;
        const int r = e / BK, c = e % BK;
        const int gr = row0 + r, gc = k0 + c;
        const float v = (gr < m && gc < d) ? x[(size_t)gr * d + gc] : 0.f;
        xs[c][r] = operand(v, BF16);
      }
#pragma unroll
      for (int l = 0; l < (BN * BK) / THREADS; ++l) {
        const int e = l * THREADS + tid;
        const int r = e / BK, c = e % BK;
        const int gr = c0 + r, gc = k0 + c;
        const float v = (gr < k && gc < d) ? y[(size_t)gr * d + gc] : 0.f;
        ys[c][r] = operand(v, BF16);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ys[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue: a thread visits its centroids in increasing index order
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx * TN + j;
      if (col < k) {
        const float ync = yn[col];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float v = __fsub_rn(__fadd_rn(xnr[i], ync),
                              __fmul_rn(2.f, acc[i][j]));
          v = v < 0.f ? 0.f : v;  // expanded-form rounding can dip below 0
          if (better(v, col, best_v[i], best_i[i])) {
            best_v[i] = v;
            best_i[i] = col;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    red_v[ty * TM + i][tx] = best_v[i];
    red_i[ty * TM + i][tx] = best_i[i];
  }
  __syncthreads();
  if (tid < BM && row0 + tid < m) {
    float bv = red_v[tid][0];
    int bi = red_i[tid][0];
    for (int t = 1; t < COLS; ++t) {
      if (better(red_v[tid][t], red_i[tid][t], bv, bi)) {
        bv = red_v[tid][t];
        bi = red_i[tid][t];
      }
    }
    val[row0 + tid] = bv;
    idx[row0 + tid] = bi == INT32_MAX ? 0 : bi;
  }
}

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------------------
// B3, narrow rows: E-step and M-step partials fused, all subspaces at once
// ---------------------------------------------------------------------------

constexpr int EM_WARPS = 8;
constexpr int EM_THREADS = 32 * EM_WARPS;
constexpr int EM_ROWS = 2048;  // rows per block; fixed, so a subspace's
                               // partials do not depend on how many ride along
constexpr int EM_MAX_D = 16;
constexpr int EM_MAX_K = 256;

template <int DS>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[DS]) {
  if constexpr (DS % 4 == 0) {
#pragma unroll
    for (int j = 0; j < DS; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else if constexpr (DS % 2 == 0) {
#pragma unroll
    for (int j = 0; j < DS; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x; v[j + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < DS; ++j) v[j] = p[j];
  }
}

template <int DS>
__device__ __forceinline__ float sq_norm(const float (&v)[DS]) {
  float a = 0.f;
#pragma unroll
  for (int j = 0; j < DS; ++j) a = fmaf(v[j], v[j], a);
  return a;
}

// shared-memory floats of one em_small_kernel block
__host__ __device__ constexpr int em_smem_floats(int k, int ds) {
  return k * ds + k + EM_WARPS * k * (ds + 1) + EM_WARPS * 32 * (ds + 1) +
         EM_THREADS;
}

// x (S, n, DS), y (S, k, DS), w (S, n) with row stride w_stride (0: shared
// by the subspaces) or null; writes val, idx (S, n) and part (S, chunks, P)
// with P = k*(DS+1) + 1: per cluster DS sums of w*x then the sum of w, then
// the chunk's inertia sum of w*val
template <int DS>
__global__ void __launch_bounds__(EM_THREADS)
em_small_kernel(const float* __restrict__ x, const float* __restrict__ w,
                long long w_stride, const float* __restrict__ y, int n, int k,
                float* __restrict__ val, int* __restrict__ idx,
                float* __restrict__ part) {
  // rows a thread keeps in registers across the centres
  constexpr int RPT = DS <= 4 ? 4 : (DS <= 8 ? 2 : 1);
  constexpr int PASS = EM_THREADS * RPT;
  constexpr int ROW = DS + 1;
  extern __shared__ float sm[];
  float* cy = sm;                              // [k][DS]
  float* cn = cy + k * DS;                     // [k]
  float* acc = cn + k;                         // [EM_WARPS][k][ROW]
  float* stage = acc + EM_WARPS * k * ROW;     // [EM_WARPS][32][ROW]
  float* red = stage + EM_WARPS * 32 * ROW;    // [EM_THREADS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s = blockIdx.y;
  const int chunks = gridDim.x;
  const size_t sn = static_cast<size_t>(s) * n;

  for (int e = tid; e < k * DS; e += EM_THREADS) {
    cy[e] = y[static_cast<size_t>(s) * k * DS + e];
  }
  for (int e = tid; e < EM_WARPS * k * ROW; e += EM_THREADS) acc[e] = 0.f;
  __syncthreads();
  for (int c = tid; c < k; c += EM_THREADS) {
    float v[DS];
    load_vec<DS>(cy + c * DS, v);
    cn[c] = sq_norm<DS>(v);
  }
  __syncthreads();

  float* wacc = acc + warp * k * ROW;
  float* wst = stage + warp * 32 * ROW;
  const float* xs = x + sn * DS;
  const unsigned below = (1u << lane) - 1u;
  float inert = 0.f;
  const int r_begin = blockIdx.x * EM_ROWS;
  const int r_end = min(n, r_begin + EM_ROWS);
  for (int p0 = r_begin; p0 < r_end; p0 += PASS) {
    float xv[RPT][DS], xn[RPT], bv[RPT];
    int bi[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = p0 + (warp * RPT + i) * 32 + lane;
      if (r < r_end) {
        load_vec<DS>(xs + static_cast<size_t>(r) * DS, xv[i]);
      } else {
#pragma unroll
        for (int j = 0; j < DS; ++j) xv[i][j] = 0.f;
      }
      xn[i] = sq_norm<DS>(xv[i]);
      bv[i] = INFINITY;
      bi[i] = 0;
    }
#pragma unroll 2
    for (int c = 0; c < k; ++c) {
      const float ync = cn[c];
      float yc[DS];
      load_vec<DS>(cy + c * DS, yc);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < DS; ++j) dot = fmaf(xv[i][j], yc[j], dot);
        float v = __fsub_rn(__fadd_rn(xn[i], ync), __fmul_rn(2.f, dot));
        v = v < 0.f ? 0.f : v;  // expanded-form rounding can dip below 0
        if (v < bv[i]) {        // strict: the lowest index wins ties
          bv[i] = v;
          bi[i] = c;
        }
      }
    }
    // 32 rows at a time, in row order: the lanes of one label form a group
    // whose lowest lane adds the members into the warp's partials
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = p0 + (warp * RPT + i) * 32 + lane;
      const bool live = r < r_end;
      const float wv = live ? (w ? w[static_cast<size_t>(s) * w_stride + r]
                                 : 1.f)
                            : 0.f;
      if (live) {
        val[sn + r] = bv[i];
        idx[sn + r] = bi[i];
        inert = __fadd_rn(inert, w ? __fmul_rn(wv, bv[i]) : bv[i]);
      }
#pragma unroll
      for (int j = 0; j < DS; ++j) {
        wst[lane * ROW + j] = w ? __fmul_rn(wv, xv[i][j]) : xv[i][j];
      }
      wst[lane * ROW + DS] = wv;
      __syncwarp();
      const unsigned grp = __match_any_sync(FULL, live ? bi[i] : -1);
      if (live && (grp & below) == 0) {
        float a[ROW];
#pragma unroll
        for (int j = 0; j < ROW; ++j) a[j] = wacc[bi[i] * ROW + j];
        for (unsigned b = grp; b; b &= b - 1) {
          const float* src = wst + (__ffs(b) - 1) * ROW;
#pragma unroll
          for (int j = 0; j < ROW; ++j) a[j] = __fadd_rn(a[j], src[j]);
        }
#pragma unroll
        for (int j = 0; j < ROW; ++j) wacc[bi[i] * ROW + j] = a[j];
      }
      __syncwarp();
    }
  }

  // the chunk's partials: the warps' in warp order, inertia by a fixed tree
  red[tid] = inert;
  __syncthreads();
  for (int stride = EM_THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) red[tid] = __fadd_rn(red[tid], red[tid + stride]);
    __syncthreads();
  }
  const int P = k * ROW + 1;
  float* out = part + (static_cast<size_t>(s) * chunks + blockIdx.x) * P;
  for (int e = tid; e < k * ROW; e += EM_THREADS) {
    float a = acc[e];
#pragma unroll
    for (int v = 1; v < EM_WARPS; ++v) a = __fadd_rn(a, acc[v * k * ROW + e]);
    out[e] = a;
  }
  if (tid == 0) out[k * ROW] = red[0];
}

// ---------------------------------------------------------------------------
// B3, wide rows: M-step partials from B1's labels
// ---------------------------------------------------------------------------

constexpr int CP_WARPS = 8;
constexpr int CP_THREADS = 32 * CP_WARPS;
constexpr int CP_CPW = 2;                  // columns per warp
constexpr int CP_SW = CP_WARPS * CP_CPW;   // columns per slab
constexpr int CP_TILE = 128;               // rows staged at a time
constexpr int CP_KR = 1024;                // clusters per block
constexpr int CP_CHUNKS = 64;              // row chunks, at most

// rows per chunk: a function of m alone, so the sums' order is too
__host__ __device__ inline int cp_chunk_rows(int m) {
  const int per = (m + CP_CHUNKS - 1) / CP_CHUNKS;
  const int rows = (per + CP_TILE - 1) / CP_TILE * CP_TILE;
  return rows > CP_TILE ? rows : CP_TILE;
}

__host__ __device__ constexpr int cp_smem_floats(int kr) {
  return kr * CP_SW + kr + CP_TILE * CP_SW + 3 * CP_TILE;
}

// part (chunks, k, d + 1): per cluster the d sums of w*x, then the sum of w
__global__ void __launch_bounds__(CP_THREADS)
cluster_partials_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const int* __restrict__ labels, int m, int k, int d,
                        int chunk_rows, float* __restrict__ part) {
  constexpr int PER = CP_TILE * CP_SW / CP_THREADS;  // tile values a thread
  extern __shared__ float sm[];
  const int kr0 = blockIdx.z * CP_KR;
  const int kr = min(CP_KR, k - kr0);
  float* acc = sm;                        // [kr][CP_SW]
  float* wacc = acc + kr * CP_SW;         // [kr]
  float* tile = wacc + kr;                // [CP_TILE][CP_SW]
  int* tlab = reinterpret_cast<int*>(tile + CP_TILE * CP_SW);  // [CP_TILE]
  float* tw = tile + CP_TILE * CP_SW + CP_TILE;                // [CP_TILE]
  unsigned* gmask = reinterpret_cast<unsigned*>(tw + CP_TILE); // [CP_TILE]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = blockIdx.y * CP_SW;
  const int wc = warp * CP_CPW;
  const bool sum_w = blockIdx.y == 0 && warp == 0;
  const unsigned below = (1u << lane) - 1u;
  for (int e = tid; e < kr * CP_SW + kr; e += CP_THREADS) acc[e] = 0.f;

  const int r_begin = blockIdx.x * chunk_rows;
  const int r_end = min(m, r_begin + chunk_rows);
  // the next tile, in registers: its loads are in flight during the sums
  float nx[PER];
  int nlab = -1;
  float nw = 0.f;
  auto fetch = [&](int t0) {
    const int nt = min(CP_TILE, r_end - t0);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = u * CP_THREADS + tid;
      const int r = e / CP_SW, c = e % CP_SW;
      nx[u] = (r < nt && c0 + c < d)
                  ? x[static_cast<size_t>(t0 + r) * d + c0 + c]
                  : 0.f;
    }
    if (tid < CP_TILE) {
      nlab = tid < nt ? labels[t0 + tid] - kr0 : -1;
      nw = tid < nt ? (w ? w[t0 + tid] : 1.f) : 0.f;
    }
  };
  if (r_begin < r_end) fetch(r_begin);
  for (int t0 = r_begin; t0 < r_end; t0 += CP_TILE) {
    const int nt = min(CP_TILE, r_end - t0);
    __syncthreads();  // the previous tile is consumed, acc is zeroed
#pragma unroll
    for (int u = 0; u < PER; ++u) tile[u * CP_THREADS + tid] = nx[u];
    if (tid < CP_TILE) {
      tlab[tid] = nlab;
      tw[tid] = nw;
    }
    __syncthreads();
    if (t0 + CP_TILE < r_end) fetch(t0 + CP_TILE);
    // once per tile: in each group of 32 rows, the lowest row of each label
    // holds the mask of that label's rows (the others 0)
    if (warp < CP_TILE / 32) {
      const int r = warp * 32 + lane;
      const int lab = tlab[r];
      const bool mine = lab >= 0 && lab < kr;
      const unsigned grp = __match_any_sync(FULL, mine ? lab : -1);
      gmask[r] = (mine && (grp & below) == 0) ? grp : 0u;
    }
    __syncthreads();
    // each warp adds its columns: a label's rows in row order
    for (int g = 0; g < nt; g += 32) {
      const unsigned grp = gmask[g + lane];
      if (grp) {
        const int lab = tlab[g + lane];
        float a[CP_CPW];
#pragma unroll
        for (int j = 0; j < CP_CPW; ++j) a[j] = acc[lab * CP_SW + wc + j];
        float wa = sum_w ? wacc[lab] : 0.f;
        for (unsigned b = grp; b; b &= b - 1) {
          const int rr = g + __ffs(b) - 1;
          const float wv = tw[rr];
#pragma unroll
          for (int j = 0; j < CP_CPW; ++j) {
            const float v = tile[rr * CP_SW + wc + j];
            a[j] = __fadd_rn(a[j], w ? __fmul_rn(wv, v) : v);
          }
          wa = __fadd_rn(wa, wv);
        }
#pragma unroll
        for (int j = 0; j < CP_CPW; ++j) acc[lab * CP_SW + wc + j] = a[j];
        if (sum_w) wacc[lab] = wa;
      }
    }
  }
  __syncthreads();
  float* out = part + static_cast<size_t>(blockIdx.x) * k * (d + 1);
  for (int e = tid; e < kr * CP_SW; e += CP_THREADS) {
    const int c = e / CP_SW, j = e % CP_SW;
    if (c0 + j < d) {
      out[static_cast<size_t>(kr0 + c) * (d + 1) + c0 + j] = acc[e];
    }
  }
  if (blockIdx.y == 0) {
    for (int c = tid; c < kr; c += CP_THREADS) {
      out[static_cast<size_t>(kr0 + c) * (d + 1) + d] = wacc[c];
    }
  }
}

// ---------------------------------------------------------------------------
// the chunks' partials added in chunk order: part (S, chunks, P), P >=
// k*(d+1); element c*(d+1)+j goes to sums (S, k, d) for j < d, to wsum
// (S, k) for j = d, and element k*(d+1), where P has it, to inertia (S,)
// ---------------------------------------------------------------------------

constexpr int RED_THREADS = 256;

__global__ void __launch_bounds__(RED_THREADS)
reduce_partials_kernel(const float* __restrict__ part, int chunks, int P,
                       int k, int d, float* __restrict__ sums,
                       float* __restrict__ wsum, float* __restrict__ inertia) {
  const int s = blockIdx.y;
  const int e = blockIdx.x * RED_THREADS + threadIdx.x;
  if (e >= P) return;
  const float* p = part + static_cast<size_t>(s) * chunks * P + e;
  float a = 0.f;
#pragma unroll 8
  for (int c = 0; c < chunks; ++c) a = __fadd_rn(a, p[static_cast<size_t>(c) * P]);
  const int row = d + 1;
  if (e < k * row) {
    const int c = e / row, j = e % row;
    if (j < d) {
      sums[(static_cast<size_t>(s) * k + c) * d + j] = a;
    } else {
      wsum[static_cast<size_t>(s) * k + c] = a;
    }
  } else {
    inertia[s] = a;
  }
}

template <int DS>
cudaError_t launch_em_small(const float* x, const float* w, long long w_stride,
                            const float* y, int S, int n, int k, float* val,
                            int* idx, float* part, cudaStream_t st) {
  const size_t smem = sizeof(float) * em_smem_floats(k, DS);
  cudaError_t err = cudaFuncSetAttribute(
      em_small_kernel<DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + EM_ROWS - 1) / EM_ROWS, S);
  em_small_kernel<DS><<<grid, EM_THREADS, smem, st>>>(x, w, w_stride, y, n,
                                                      k, val, idx, part);
  return cudaGetLastError();
}

}  // namespace

extern "C" int raft_fused_l2nn(const float* x, const float* xn,
                               const float* y, const float* yn, float* val,
                               int* idx, int m, int k, int d, int bf16_dot,
                               void* stream) {
  if (m == 0) return 0;
  const dim3 grid((m + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_dot) {
    fused_l2nn_kernel<true><<<grid, THREADS, 0, s>>>(x, xn, y, yn, val, idx,
                                                     m, k, d);
  } else {
    fused_l2nn_kernel<false><<<grid, THREADS, 0, s>>>(x, xn, y, yn, val, idx,
                                                      m, k, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// floats of the partials scratch raft_em_small needs
extern "C" long long raft_em_small_scratch(int S, int n, int k, int ds) {
  const long long chunks = (n + EM_ROWS - 1) / EM_ROWS;
  return static_cast<long long>(S) * chunks * (k * (ds + 1) + 1);
}

// B3 at narrow rows, all S subspaces in one launch (plus the ordered
// reduction): x (S, n, ds), y (S, k, ds), w (S, n) of row stride w_stride
// or null; val, idx (S, n); sums (S, k, ds), wsum (S, k), inertia (S,)
extern "C" int raft_em_small(const float* x, const float* w,
                             long long w_stride, const float* y, int S, int n,
                             int k, int ds, float* val, int* idx, float* part,
                             float* sums, float* wsum, float* inertia,
                             void* stream) {
  if (ds < 1 || ds > EM_MAX_D || k < 1 || k > EM_MAX_K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) {
    cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(float) * S * k * ds, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(wsum, 0, sizeof(float) * S * k, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(inertia, 0, sizeof(float) * S, st);
    return static_cast<int>(err);
  }
  cudaError_t err = cudaErrorInvalidValue;
  switch (ds) {
#define RAFT_EM_CASE(D)                                                     \
  case D:                                                                   \
    err = launch_em_small<D>(x, w, w_stride, y, S, n, k, val, idx, part, st); \
    break;
    RAFT_EM_CASE(1) RAFT_EM_CASE(2) RAFT_EM_CASE(3) RAFT_EM_CASE(4)
    RAFT_EM_CASE(5) RAFT_EM_CASE(6) RAFT_EM_CASE(7) RAFT_EM_CASE(8)
    RAFT_EM_CASE(9) RAFT_EM_CASE(10) RAFT_EM_CASE(11) RAFT_EM_CASE(12)
    RAFT_EM_CASE(13) RAFT_EM_CASE(14) RAFT_EM_CASE(15) RAFT_EM_CASE(16)
#undef RAFT_EM_CASE
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (n + EM_ROWS - 1) / EM_ROWS;
  const int P = k * (ds + 1) + 1;
  const dim3 grid((P + RED_THREADS - 1) / RED_THREADS, S);
  reduce_partials_kernel<<<grid, RED_THREADS, 0, st>>>(part, chunks, P, k, ds,
                                                       sums, wsum, inertia);
  return static_cast<int>(cudaGetLastError());
}

// floats of the partials scratch raft_cluster_partials needs
extern "C" long long raft_cluster_partials_scratch(int m, int k, int d) {
  const long long chunks = (m + cp_chunk_rows(m) - 1) / cp_chunk_rows(m);
  return chunks * k * (d + 1);
}

// B3's M-step at wide rows from given labels: sums (k, d), wsum (k,)
extern "C" int raft_cluster_partials(const float* x, const float* w,
                                     const int* labels, int m, int k, int d,
                                     float* part, float* sums, float* wsum,
                                     void* stream) {
  if (k == 0 || d == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m == 0) {
    cudaError_t err = cudaMemsetAsync(sums, 0, sizeof(float) * k * d, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(wsum, 0, sizeof(float) * k, st);
    return static_cast<int>(err);
  }
  const int rows = cp_chunk_rows(m);
  const int chunks = (m + rows - 1) / rows;
  const size_t smem = sizeof(float) * cp_smem_floats(k < CP_KR ? k : CP_KR);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_partials_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(chunks, (d + CP_SW - 1) / CP_SW, (k + CP_KR - 1) / CP_KR);
  cluster_partials_kernel<<<grid, CP_THREADS, smem, st>>>(x, w, labels, m, k,
                                                          d, rows, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = k * (d + 1);
  const dim3 rgrid((P + RED_THREADS - 1) / RED_THREADS, 1);
  reduce_partials_kernel<<<rgrid, RED_THREADS, 0, st>>>(part, chunks, P, k, d,
                                                        sums, wsum, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
