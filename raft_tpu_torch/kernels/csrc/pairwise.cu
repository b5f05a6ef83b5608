// Pairwise accumulation (kernel B5) for Hopper (sm_90a).
//
// Replaces raft_tpu/kernels/pairwise.py: _pairwise_pallas (body _kernel),
// public entry pairwise_accumulate.
//
// out[i, j] = sum (or max) over k of elem(x[i, k], y[j, k]), float32, with
// elem one of
//   0 l1        |a - b|                       sum
//   1 l2        (a - b)^2                     sum
//   2 linf      |a - b|                       max, NaN propagates
//   3 lp        |a - b|^p                     sum
//   4 hamming   a != b ? 1 : 0                sum
//   5 canberra  den > 0 ? |a - b| / den : 0,  den = |a| + |b|    sum
// Only the accumulation runs here; the caller finalises (sqrt, ^1/p, /k).
//
// The design is RAFT's tiled PairwiseDistances
// (distance/detail/pairwise_distance_base.cuh:76 over the smem tiling of
// linalg/detail/contractions.cuh:26): a block of 256 threads owns a 64 x 64
// tile of outputs; for each chunk of 32 k it stages the x rows' and the y
// rows' chunk in shared memory, widened to float32 and transposed to
// k-major, and each thread applies the op to its 4 x 4 register tile of
// outputs (rows ty + 16 r, columns tx + 16 c: a warp reads 16 consecutive
// y values and broadcasts 2 x values, so shared memory has no bank
// conflicts; the +1 padding keeps the transposing stores conflict-free).
// The chunk loop covers any k >= 0: the TPU kernel's k <= 512 was its
// unrolled loop's compile time.  Rows and columns past the edge stage
// zeros and are never written; nothing is padded in memory.
//
// Every output sums its k terms in one fixed order, k = 0, 1, ..., in one
// thread, whatever the grid, the tile or m: a row of x gets the same bits
// in every batch it rides in, which the serving contract "coalesced ==
// solo" rests on.  float32, bfloat16 and float16 inputs are widened to
// float32 as they are staged and summed in float32 (the accum_dtype rule;
// the TPU kernel summed in the input type).  Linf takes the max with an
// explicit compare, since fmaxf drops NaN and jnp.maximum propagates it.
// Built without --use_fast_math, so "/" is IEEE-rounded and powf keeps its
// full-accuracy path.
//
// Bound: at the brute-force scan step (1,024 x 16,384 x 128) the card does
// m * n * k ops (L1: a subtract and an add with an abs modifier, two
// float32 instructions per element) against m * n * 4 output bytes, so it
// is bound by the float32 instruction rate.  Each staged value feeds 64 ops
// from shared memory, and each thread 16 from registers per x and y value
// it reads.  raft_pairwise_accumulate returns cudaGetLastError() right
// after each launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // k per staged chunk
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

enum Op { L1 = 0, L2 = 1, LINF = 2, LP = 3, HAMMING = 4, CANBERRA = 5 };

// acc merged with elem(a, b)
template <int OP>
__device__ __forceinline__ float step(float acc, float a, float b, float p) {
  if constexpr (OP == L1) {
    return acc + fabsf(a - b);
  } else if constexpr (OP == L2) {
    const float d = a - b;
    return fmaf(d, d, acc);
  } else if constexpr (OP == LINF) {
    const float t = fabsf(a - b);
    // jnp.maximum: a NaN on either side wins
    return (t > acc || t != t) ? t : acc;
  } else if constexpr (OP == LP) {
    return acc + powf(fabsf(a - b), p);
  } else if constexpr (OP == HAMMING) {
    return acc + (a != b ? 1.0f : 0.0f);
  } else {
    const float den = fabsf(a) + fabsf(b);
    return acc + (den > 0.0f ? fabsf(a - b) / den : 0.0f);
  }
}

// Stage rows [r0, r0 + R) x k [k0, k0 + BK) of src (rows x k, row-major)
// into dst[BK][R + 1], k-major, float32; zeros past the edges.
template <int R, typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int rows,
                                      int k, int r0, int k0,
                                      float (*dst)[R + 1]) {
  // consecutive threads read consecutive k of one row
  for (int e = threadIdx.x; e < R * BK; e += THREADS) {
    const int r = e / BK;
    const int c = e % BK;
    const int gr = r0 + r;
    const int gc = k0 + c;
    dst[c][r] = (gr < rows && gc < k)
                    ? to_float(src[static_cast<int64_t>(gr) * k + gc])
                    : 0.0f;
  }
}

template <int OP, typename T>
__global__ void __launch_bounds__(THREADS)
pairwise_kernel(const T* __restrict__ x, const T* __restrict__ y,
                float* __restrict__ out, int m, int n, int k, int64_t ldo,
                float p) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float ys[BK][BN + 1];
  const int tx = threadIdx.x % (BN / TN);
  const int ty = threadIdx.x / (BN / TN);
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = 0; k0 < k; k0 += BK) {
    stage<BM>(x, m, k, row0, k0, xs);
    stage<BN>(y, n, k, col0, k0, ys);
    __syncthreads();
    const int kn = min(BK, k - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = xs[kk][ty + r * (BM / TM)];
#pragma unroll
      for (int c = 0; c < TN; ++c) b[c] = ys[kk][tx + c * (BN / TN)];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          acc[r][c] = step<OP>(acc[r][c], a[r], b[c], p);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gr = row0 + ty + r * (BM / TM);
    if (gr >= m) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gc = col0 + tx + c * (BN / TN);
      if (gc < n) out[gr * ldo + gc] = acc[r][c];
    }
  }
}

// columns per launch: grid.y holds at most 65,535 column blocks
constexpr int MAX_COLS = 65535 * BN;

template <int OP, typename T>
int launch_op(const T* x, const T* y, float* out, int m, int n, int k,
              float p, cudaStream_t s) {
  // row blocks on grid.x (no practical limit), column chunks of MAX_COLS
  for (int c0 = 0; c0 < n; c0 += MAX_COLS) {
    const int nc = n - c0 < MAX_COLS ? n - c0 : MAX_COLS;
    const dim3 grid((m + BM - 1) / BM, (nc + BN - 1) / BN);
    pairwise_kernel<OP, T><<<grid, THREADS, 0, s>>>(
        x, y + static_cast<int64_t>(c0) * k, out + c0, m, nc, k, n, p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename T>
int launch(int op, const void* x, const void* y, float* out, int m, int n,
           int k, float p, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  switch (op) {
    case L1: return launch_op<L1, T>(xt, yt, out, m, n, k, p, s);
    case L2: return launch_op<L2, T>(xt, yt, out, m, n, k, p, s);
    case LINF: return launch_op<LINF, T>(xt, yt, out, m, n, k, p, s);
    case LP: return launch_op<LP, T>(xt, yt, out, m, n, k, p, s);
    case HAMMING: return launch_op<HAMMING, T>(xt, yt, out, m, n, k, p, s);
    case CANBERRA: return launch_op<CANBERRA, T>(xt, yt, out, m, n, k, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (m, k) and y (n, k) row-major, both of dtype (0 float32, 1 bfloat16,
// 2 float16); out (m, n) float32
extern "C" int raft_pairwise_accumulate(const void* x, const void* y,
                                        float* out, int m, int n, int k,
                                        int op, float p, int dtype,
                                        void* stream) {
  if (m == 0 || n == 0) return 0;
  if (m < 0 || n < 0 || k < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(op, x, y, out, m, n, k, p, s);
    case 1: return launch<__nv_bfloat16>(op, x, y, out, m, n, k, p, s);
    case 2: return launch<__half>(op, x, y, out, m, n, k, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
