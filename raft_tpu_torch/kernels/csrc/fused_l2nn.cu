// Fused L2 nearest neighbour (kernel B1) and the k-means M-step partials'
// segmented sum (the second half of kernel B3), for Hopper (sm_90a).
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
// The M-step partials are computed from the E-step's labels: the caller
// orders rows stably by label (index bookkeeping), and segment_sums_kernel
// adds each cluster's members IN ROW ORDER, one block per (cluster,
// 128-column slab).  No atomics, so the sums repeat bit for bit from run to
// run, and they equal a sequential row-order sum on the host.  Bound: one
// read of x (memory); a cluster's members are summed by one block, so a
// few huge clusters serialise on few SMs.
//
// Each entry point returns cudaGetLastError() right after its launch.

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

constexpr int SEG_THREADS = 128;
constexpr int SEG_UNROLL = 4;

// sums[c, col] = sum over members r of cluster c, in row order, of w[r]*x[r, col]
__global__ void __launch_bounds__(SEG_THREADS)
segment_sums_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ order,
                    const int* __restrict__ offsets, float* __restrict__ sums,
                    float* __restrict__ wsum, int k, int d) {
  const int c = blockIdx.x;
  const int col = blockIdx.y * SEG_THREADS + threadIdx.x;
  const bool live = col < d;
  const int beg = offsets[c];
  const int end = offsets[c + 1];
  float acc = 0.f;
  float wacc = 0.f;
  int i = beg;
  // loads of SEG_UNROLL rows are issued before their (ordered) adds
  for (; i + SEG_UNROLL <= end; i += SEG_UNROLL) {
    int r[SEG_UNROLL];
    float v[SEG_UNROLL], wv[SEG_UNROLL];
#pragma unroll
    for (int u = 0; u < SEG_UNROLL; ++u) r[u] = order[i + u];
#pragma unroll
    for (int u = 0; u < SEG_UNROLL; ++u) {
      wv[u] = w ? w[r[u]] : 1.f;
      v[u] = live ? x[(size_t)r[u] * d + col] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SEG_UNROLL; ++u) {
      acc = __fadd_rn(acc, w ? __fmul_rn(wv[u], v[u]) : v[u]);
      wacc = __fadd_rn(wacc, wv[u]);
    }
  }
  for (; i < end; ++i) {
    const int r = order[i];
    const float wv = w ? w[r] : 1.f;
    const float v = live ? x[(size_t)r * d + col] : 0.f;
    acc = __fadd_rn(acc, w ? __fmul_rn(wv, v) : v);
    wacc = __fadd_rn(wacc, wv);
  }
  if (live) sums[(size_t)c * d + col] = acc;
  if (blockIdx.y == 0 && threadIdx.x == 0) wsum[c] = wacc;
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

extern "C" int raft_segment_sums(const float* x, const float* w,
                                 const int* order, const int* offsets,
                                 float* sums, float* wsum, int k, int d,
                                 void* stream) {
  if (k == 0) return 0;
  const dim3 grid(k, (d + SEG_THREADS - 1) / SEG_THREADS);
  segment_sums_kernel<<<grid, SEG_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, w, order, offsets, sums, wsum, k, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
