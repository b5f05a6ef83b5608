// Row-wise select-k (kernel B2) for Hopper (sm_90a), in the style of
// RAFT's warpsort (matrix/detail/select_warpsort.cuh).
//
// Replaces raft_tpu/kernels/select_k.py: _select_k_pallas (body
// _select_kernel), public entry select_k_blockwise.
//
// One warp owns one row.  It keeps the row's best KP = 32*E candidates
// (KP = next power of two >= max(k, 32)) as a sorted run spread over the
// lanes' registers, element i = j*32 + lane in register j.  The row is
// read in KP-wide chunks (coalesced, 4 bytes a lane); a chunk with no
// element better than the run's worst is skipped after one warp vote;
// otherwise the chunk is bitonic-sorted in registers (lane shuffles for
// partners under 32 apart, register swaps above), folded into the run by
// one min against the reversed chunk, and the resulting bitonic sequence
// is merged back into order.
//
// Comparisons are on one 64-bit key per element: the value mapped to an
// order-preserving unsigned integer in the high half (NaN replaced by the
// worst value, -0 by +0, and inverted for select-max), the position in
// the low half.  Keys are distinct, so "smallest key first" is the stable
// order (value, then lowest position) of matrix/select_k.py's plain
// version, and the returned positions equal it bit for bit.  Values are
// gathered from the raw input by position outside the kernel, so a
// selected NaN comes back as NaN.
//
// Bound: the kernel reads each input value once (4 bytes) and writes k
// positions a row, so it is bound by memory; the sort network's shuffles
// run only on chunks that pass the vote.
//
// raft_select_k returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 4;
constexpr uint64_t PAD_KEY = ~0ull;

__device__ __forceinline__ uint64_t make_key(float v, uint32_t p,
                                             bool select_min) {
  if (v != v) v = select_min ? INFINITY : -INFINITY;  // NaN ranks worst
  if (v == 0.f) v = 0.f;                              // -0 ties with +0
  const uint32_t b = __float_as_uint(v);
  uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  if (!select_min) ord = ~ord;
  return (static_cast<uint64_t>(ord) << 32) | p;
}

__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// one bitonic compare-exchange stage over the warp's 32*E elements:
// element i pairs with i ^ stride; regions of `size` alternate direction
// (size >= 64*E makes every region ascend: the merge network)
template <int E>
__device__ __forceinline__ void exchange(uint64_t (&a)[E], int lane,
                                         int size, int stride) {
  if (stride >= 32) {
    const int js = stride >> 5;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if ((j & js) == 0) {
        const int j2 = j | js;
        const bool asc = ((j * 32 + lane) & size) == 0;
        const uint64_t lo = kmin(a[j], a[j2]);
        const uint64_t hi = kmax(a[j], a[j2]);
        a[j] = asc ? lo : hi;
        a[j2] = asc ? hi : lo;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const uint64_t o = __shfl_xor_sync(FULL, a[j], stride);
      const bool lower = (lane & stride) == 0;
      const bool asc = ((j * 32 + lane) & size) == 0;
      a[j] = (lower == asc) ? kmin(a[j], o) : kmax(a[j], o);
    }
  }
}

template <int E>
__device__ __forceinline__ void bitonic_sort(uint64_t (&a)[E], int lane) {
  constexpr int N = 32 * E;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      exchange<E>(a, lane, size, stride);
    }
  }
}

template <int E>
__device__ __forceinline__ void bitonic_merge(uint64_t (&a)[E], int lane) {
  constexpr int N = 32 * E;
#pragma unroll
  for (int stride = N >> 1; stride > 0; stride >>= 1) {
    exchange<E>(a, lane, 2 * N, stride);
  }
}

template <int E>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
select_k_kernel(const float* __restrict__ x, int rows, int n, int k,
                bool select_min, int* __restrict__ pos) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const float* in = x + static_cast<size_t>(row) * n;

  uint64_t best[E];
#pragma unroll
  for (int j = 0; j < E; ++j) best[j] = PAD_KEY;

  for (int base = 0; base < n; base += 32 * E) {
    uint64_t c[E];
    bool any_better = false;
    const uint64_t worst = __shfl_sync(FULL, best[E - 1], 31);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int p = base + j * 32 + lane;
      c[j] = p < n ? make_key(in[p], static_cast<uint32_t>(p), select_min)
                   : PAD_KEY;
      any_better |= c[j] < worst;
    }
    if (!__any_sync(FULL, any_better)) continue;
    bitonic_sort<E>(c, lane);
    // best ascending, chunk reversed (descending): the elementwise min is
    // a bitonic sequence holding the 32*E smallest of the union
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const uint64_t o = __shfl_sync(FULL, c[E - 1 - j], 31 - lane);
      best[j] = kmin(best[j], o);
    }
    bitonic_merge<E>(best, lane);
  }

#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = j * 32 + lane;
    if (i < k) {
      pos[static_cast<size_t>(row) * k + i] =
          static_cast<int>(static_cast<uint32_t>(best[j] & 0xffffffffull));
    }
  }
}

}  // namespace

extern "C" int raft_select_k(const float* x, int rows, int n, int k,
                             int select_min, int* pos, void* stream) {
  if (rows == 0 || k == 0) return 0;
  const dim3 grid((rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  const dim3 block(32 * WARPS_PER_BLOCK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mn = select_min != 0;
  if (k <= 32) {
    select_k_kernel<1><<<grid, block, 0, s>>>(x, rows, n, k, mn, pos);
  } else if (k <= 64) {
    select_k_kernel<2><<<grid, block, 0, s>>>(x, rows, n, k, mn, pos);
  } else if (k <= 128) {
    select_k_kernel<4><<<grid, block, 0, s>>>(x, rows, n, k, mn, pos);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
