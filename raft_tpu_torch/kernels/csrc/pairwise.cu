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
// The design is RAFT's Contractions_NT (linalg/detail/contractions.cuh:26)
// under PairwiseDistances (distance/detail/pairwise_distance_base.cuh:76):
// a block of 256 threads (16 x 16) owns a BM x 128 tile of outputs and
// each thread a TM x 8 register tile of them, TM = 8 at the 128 x 128
// tile of large batches.  For each chunk of 16 k the block stages the x
// rows' and the y rows' chunk in shared memory, widened to float32 and
// k-major, and a thread reads its x and y values of one k as 16-byte
// float4 loads: at TM = 8 that is 4 shared loads for 64 elementwise ops.
// A thread's columns are tx*4 + {0..3} and 64 + tx*4 + {0..3} (rows
// likewise), so a quarter warp's 16-byte loads cover 128 contiguous bytes
// and shared memory has no bank conflicts.
//
// The k-loop is double-buffered, one __syncthreads per chunk: the global
// loads of chunk c + 1 (16-byte vectors along k where k and the pointers
// allow it, else single elements; bfloat16 and float16 widened to float32
// in registers) are in flight while chunk c is computed, and are stored
// to the other buffer after it.  A warp's loads cover 16 rows x 2 vectors,
// so every 32-byte sector it touches is read whole; the +4 padding of a
// k line keeps the transposing stores free of conflicts at float32.
// There is no per-element divide or modulo: a thread's load slots are
// fixed at compile time.  Rows and columns past the edge stage zeros and
// are never written; nothing is padded in memory.
//
// Tile by bucket: BM = 16 * TM follows m (TM = 8, 4, 2, 1 for m > 64,
// > 32, > 16, <= 16; Lp and Canberra at most 2), so a serving bucket of 8-64 queries does not run a
// 128-row tile mostly empty.  Every output sums its k terms in one fixed
// order, k = 0, 1, ..., in one thread, whatever the grid, the tile or m,
// and the chunk loop adds no term past k: a row of x gets the same bits
// in every batch and under every tile shape, which the serving contract
// "coalesced == solo" rests on.  float32, bfloat16 and float16 inputs are
// summed in float32 (the accum_dtype rule).  Linf takes the max with an
// NaN-propagating max, since fmaxf drops NaN and jnp.maximum keeps it.
// Built without --use_fast_math, so "/" is IEEE-rounded and powf keeps its
// full-accuracy path.
//
// Bound: at the brute-force scan step (1,024 x 16,384 x 128) the card does
// m * n * k elementwise ops against m * n * 4 output bytes, so it is bound
// by the float32 instruction rate: L1 is a subtract and an add with an
// |x| modifier, two instructions per element (tools/b4_b5_probe.py --sass
// counts them in the built library).  The shared loads, the staging and
// the loop overhead are what separates the kernel from that bound; the
// 8 x 8 tile keeps their share of the issue slots small.  Linf's max
// propagates NaN in one instruction (max.NaN).  raft_pairwise_accumulate
// returns cudaGetLastError() right after each launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TX = 16;                 // threads along the columns
constexpr int TY = 16;                 // threads along the rows
constexpr int THREADS = TX * TY;       // 256
constexpr int TN = 8;                  // columns per thread
constexpr int BN = TX * TN;            // 128 columns per block
constexpr int BK = 16;                 // k per staged chunk
constexpr int PAD = 4;                 // floats of padding per k line

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// element i of a 16-byte vector of T, widened to float32 (exact)
template <typename T>
__device__ __forceinline__ float element(const uint4& u, int i) {
  const uint32_t w = (&u.x)[(i * static_cast<int>(sizeof(T))) / 4];
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else {
    const unsigned short h =
        static_cast<unsigned short>((i & 1) ? (w >> 16) : (w & 0xffffu));
    if constexpr (std::is_same<T, __half>::value) {
      return __half2float(__ushort_as_half(h));
    } else {
      return __bfloat162float(__ushort_as_bfloat16(h));
    }
  }
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
    // jnp.maximum: a NaN on either side wins (max.NaN, one instruction)
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(acc), "f"(fabsf(a - b)));
    return r;
  } else if constexpr (OP == LP) {
    return acc + powf(fabsf(a - b), p);
  } else if constexpr (OP == HAMMING) {
    return acc + (a != b ? 1.0f : 0.0f);
  } else {
    const float den = fabsf(a) + fabsf(b);
    return acc + (den > 0.0f ? fabsf(a - b) / den : 0.0f);
  }
}

// A chunk of R rows x BK k of a row-major (rows x k) matrix, held in
// registers between its global load and its shared store.  Vector slot
// e = (rblk * NKV + kv) * 16 + r16 holds row rblk * 16 + r16, k
// [kv * VEC, kv * VEC + VEC) of the chunk: a warp reads 16 rows x 2
// vectors.
template <typename T, int R>
struct Chunk {
  static constexpr int VEC = 16 / sizeof(T);       // elements per vector
  static constexpr int NKV = BK / VEC;             // vectors per row
  static constexpr int SLOTS = R * NKV;
  static constexpr int NL = (SLOTS + THREADS - 1) / THREADS;
  float v[NL][VEC];

  __device__ __forceinline__ void load(const T* __restrict__ src, int rows,
                                       int k, int r0, int k0, bool vec) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int e = threadIdx.x + l * THREADS;
      const int row = (e / (16 * NKV)) * 16 + (e & 15);
      const int gr = r0 + row;
      const int gc = k0 + ((e >> 4) % NKV) * VEC;
      if (e < SLOTS && gr < rows && gc < k) {
        const T* p = src + static_cast<int64_t>(gr) * k + gc;
        if (vec) {   // k % VEC == 0: the whole vector is in range
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[l][i] = element<T>(u, i);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            v[l][i] = gc + i < k ? to_float(p[i]) : 0.0f;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[l][i] = 0.0f;
      }
    }
  }

  __device__ __forceinline__ void store(float (*dst)[R + PAD]) const {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int e = threadIdx.x + l * THREADS;
      if (e < SLOTS) {
        const int row = (e / (16 * NKV)) * 16 + (e & 15);
        const int c = ((e >> 4) % NKV) * VEC;
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[c + i][row] = v[l][i];
      }
    }
  }
};

// r-th of a thread's n values along a tile side (t: its thread index along
// that side): groups of 4 at t*4, the second group 64 further; below 4
// values a thread owns t*n .. t*n + n - 1
template <int N>
__device__ __forceinline__ int owned(int t, int r) {
  if constexpr (N >= 4) {
    return (r >> 2) * 64 + t * 4 + (r & 3);
  } else {
    return t * N + r;
  }
}

template <int N>
__device__ __forceinline__ void read_line(const float* line, int t,
                                          float (&out)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 f = *reinterpret_cast<const float4*>(line + j * 64 + t * 4);
      out[4 * j] = f.x;
      out[4 * j + 1] = f.y;
      out[4 * j + 2] = f.z;
      out[4 * j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < N; ++r) out[r] = line[t * N + r];
  }
}

template <int OP, int TM, int BM>
__device__ __forceinline__ void compute(float (&acc)[TM][TN],
                                        float (*xs)[BM + PAD],
                                        float (*ys)[BN + PAD], int kn,
                                        int tx, int ty, float p) {
  auto one = [&](int kk) {
    float a[TM], b[TN];
    read_line<TM>(xs[kk], ty, a);
    read_line<TN>(ys[kk], tx, b);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = step<OP>(acc[r][c], a[r], b[c], p);
    }
  };
  if (kn == BK) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) one(kk);
  } else {
    for (int kk = 0; kk < kn; ++kk) one(kk);
  }
}

template <int OP, typename T, int TM>
__global__ void __launch_bounds__(THREADS, 2)
pairwise_kernel(const T* __restrict__ x, const T* __restrict__ y,
                float* __restrict__ out, int m, int n, int k, int64_t ldo,
                float p, bool vec) {
  constexpr int BM = TY * TM;
  __shared__ __align__(16) float xs[2][BK][BM + PAD];
  __shared__ __align__(16) float ys[2][BK][BN + PAD];
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
  }

  const int chunks = (k + BK - 1) / BK;
  Chunk<T, BM> cx;
  Chunk<T, BN> cy;
  if (chunks > 0) {
    cx.load(x, m, k, row0, 0, vec);
    cy.load(y, n, k, col0, 0, vec);
    cx.store(xs[0]);
    cy.store(ys[0]);
    __syncthreads();
  }
  for (int c = 0; c < chunks; ++c) {
    const int cur = c & 1;
    const bool more = c + 1 < chunks;
    if (more) {   // chunk c + 1's loads in flight during chunk c
      cx.load(x, m, k, row0, (c + 1) * BK, vec);
      cy.load(y, n, k, col0, (c + 1) * BK, vec);
    }
    compute<OP, TM, BM>(acc, xs[cur], ys[cur], min(BK, k - c * BK), tx, ty,
                        p);
    if (more) {   // the other buffer was last read before the last barrier
      cx.store(xs[cur ^ 1]);
      cy.store(ys[cur ^ 1]);
    }
    __syncthreads();
  }

  const bool vec_out = (ldo & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gr = row0 + owned<TM>(ty, r);
    if (gr >= m) continue;
    float* orow = out + gr * ldo;
#pragma unroll
    for (int j = 0; j < TN / 4; ++j) {
      const int gc = col0 + owned<TN>(tx, 4 * j);
      if (vec_out && gc + 4 <= n) {
        *reinterpret_cast<float4*>(orow + gc) =
            make_float4(acc[r][4 * j], acc[r][4 * j + 1], acc[r][4 * j + 2],
                        acc[r][4 * j + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (gc + i < n) orow[gc + i] = acc[r][4 * j + i];
        }
      }
    }
  }
}

// columns per launch: grid.y holds at most 65,535 column blocks
constexpr int MAX_COLS = 65535 * BN;

template <int OP, typename T, int TM>
int launch_tile(const T* x, const T* y, float* out, int m, int n, int k,
                float p, bool vec, cudaStream_t s) {
  constexpr int BM = TY * TM;
  // row blocks on grid.x (no practical limit), column chunks of MAX_COLS
  for (int c0 = 0; c0 < n; c0 += MAX_COLS) {
    const int nc = n - c0 < MAX_COLS ? n - c0 : MAX_COLS;
    const dim3 grid((m + BM - 1) / BM, (nc + BN - 1) / BN);
    pairwise_kernel<OP, T, TM><<<grid, THREADS, 0, s>>>(
        x, y + static_cast<int64_t>(c0) * k, out + c0, m, nc, k, n, p, vec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// the tile follows the batch: BM = 128, 64, 32 or 16 rows; Lp and
// Canberra, whose powf and division hold many registers and wait on the
// special-function unit, stop at 32 rows (more warps per SM)
template <int OP, typename T>
int launch_op(const T* x, const T* y, float* out, int m, int n, int k,
              float p, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = k % VEC == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  if constexpr (OP == LP || OP == CANBERRA) {
    if (m > 16) return launch_tile<OP, T, 2>(x, y, out, m, n, k, p, vec, s);
    return launch_tile<OP, T, 1>(x, y, out, m, n, k, p, vec, s);
  }
  if (m > 64) return launch_tile<OP, T, 8>(x, y, out, m, n, k, p, vec, s);
  if (m > 32) return launch_tile<OP, T, 4>(x, y, out, m, n, k, p, vec, s);
  if (m > 16) return launch_tile<OP, T, 2>(x, y, out, m, n, k, p, vec, s);
  return launch_tile<OP, T, 1>(x, y, out, m, n, k, p, vec, s);
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
