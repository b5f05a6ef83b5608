// Row-wise select-k (kernel B2) for Hopper (sm_90a), in the style of
// RAFT's filtered warp sort (matrix/detail/select_warpsort.cuh,
// warp_sort_filtered) with long rows split across the warps of a block.
//
// Replaces raft_tpu/kernels/select_k.py: _select_k_pallas (body
// _select_kernel), public entry select_k_blockwise.
//
// Keys.  Every selected candidate is compared on one 64-bit key: the value
// widened to float32 (exact for float16 and bfloat16) and mapped to an
// order-preserving unsigned integer in the high half (NaN replaced by the
// worst value, -0 by +0, inverted for select-max), the position in the
// low half.  Keys are distinct, so the k smallest keys are one set whatever
// the order in which they are found: the returned positions equal the
// stable order (value, then lowest position) of matrix/select_k.py's plain
// version bit for bit for every split of the row.  Values are read back
// from the raw input at those positions, so a selected NaN stays NaN.
//
// Design.  A warp keeps a sorted run of its best KP = 32*E keys
// (KP = next power of two >= max(k, 32)) in registers, element
// i = j*32 + lane in register j, and a threshold: a value no better than
// the k-th best of some k elements it has seen, so every element of the
// row's top k is at least as good.  It streams its slab of the row with
// 16-byte loads (a scalar head up to the first 16-byte boundary and a
// scalar tail; the next load in flight while the current one is filtered)
// and compares each value with the threshold in float32; the few that
// pass are appended, as keys, to the warp's candidate list in shared
// memory.  Only when the list holds a full run of 32*E, and once at the
// end, does the warp bitonic-sort it in runs of 32*E (lane shuffles for
// partners under 32 apart, register swaps above), merge them into its run
// and tighten the threshold to the run's k-th best.  For k <= 32 the
// threshold starts at the k-th best of the 32 lanes' best values of their
// first load, so the first load is not sorted whole.  A row of n >= 2048
// is split into contiguous slabs over up to MAX_WARPS warps of one block;
// their runs are merged pairwise in a tree through shared memory.  Short
// rows keep one warp each, four rows to a block.
//
// Bound: the kernel reads each input value once and writes k values and
// positions a row, so it is bound by memory.  Float16 and bfloat16 rows
// are read in their own type.
//
// raft_select_k returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t PAD_KEY = ~0ull;
constexpr uint32_t PAD_ORD = 0xffffffffu;  // above every element's image
constexpr int G = 4;              // values filtered per lane per step
constexpr int MAX_WARPS = 8;      // warps of a block (and of one row)
constexpr int ROW_SPLIT = 1024;   // a row takes one warp per this many
constexpr int SHORT_WARPS = 4;    // warps of a block of short rows

// order-preserving image of a value (see the header)
__device__ __forceinline__ uint32_t ord_of(float v, bool select_min) {
  if (v != v) v = select_min ? INFINITY : -INFINITY;  // NaN ranks worst
  if (v == 0.f) v = 0.f;                              // -0 ties with +0
  const uint32_t b = __float_as_uint(v);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return select_min ? o : ~o;
}

// the value whose image is o (o below PAD_ORD)
__device__ __forceinline__ float value_of(uint32_t o, bool select_min) {
  if (!select_min) o = ~o;
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

template <typename K>
__device__ __forceinline__ K kmin(K a, K b) {
  return a < b ? a : b;
}
template <typename K>
__device__ __forceinline__ K kmax(K a, K b) {
  return a < b ? b : a;
}

// one bitonic compare-exchange stage over the warp's 32*E elements:
// element i pairs with i ^ stride; regions of `size` alternate direction
// (size >= 64*E makes every region ascend: the merge network)
template <typename K, int E>
__device__ __forceinline__ void exchange(K (&a)[E], int lane, int size,
                                         int stride) {
  if (stride >= 32) {
    const int js = stride >> 5;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if ((j & js) == 0) {
        const int j2 = j | js;
        const bool asc = ((j * 32 + lane) & size) == 0;
        const K lo = kmin(a[j], a[j2]);
        const K hi = kmax(a[j], a[j2]);
        a[j] = asc ? lo : hi;
        a[j2] = asc ? hi : lo;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const K o = __shfl_xor_sync(FULL, a[j], stride);
      const bool lower = (lane & stride) == 0;
      const bool asc = ((j * 32 + lane) & size) == 0;
      a[j] = (lower == asc) ? kmin(a[j], o) : kmax(a[j], o);
    }
  }
}

template <typename K, int E>
__device__ __forceinline__ void bitonic_sort(K (&a)[E], int lane) {
  constexpr int N = 32 * E;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      exchange<K, E>(a, lane, size, stride);
    }
  }
}

// best (ascending) := the 32*E smallest of best and the ascending chunk c
template <int E>
__device__ __forceinline__ void merge_into(uint64_t (&best)[E],
                                           const uint64_t (&c)[E], int lane) {
  // best ascending, chunk reversed (descending): the elementwise min is a
  // bitonic sequence holding the 32*E smallest of the union
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const uint64_t o = __shfl_sync(FULL, c[E - 1 - j], 31 - lane);
    best[j] = kmin(best[j], o);
  }
  constexpr int N = 32 * E;
#pragma unroll
  for (int stride = N >> 1; stride > 0; stride >>= 1) {
    exchange<uint64_t, E>(best, lane, 2 * N, stride);
  }
}

// a warp's running selection: its sorted run, the threshold (a value
// passes if it is at least as good as thr, or it is NaN and thr is the
// worst value), and the length of its candidate list in shared memory
template <int E>
struct Run {
  uint64_t best[E];
  float thr;
  bool thr_worst;
  int cnt;
};

// tighten the threshold to the value of order image o, if that is better
// (PAD_ORD: no value, so nothing changes)
template <int E>
__device__ __forceinline__ void tighten(Run<E>& r, uint32_t o,
                                       bool select_min) {
  if (o != PAD_ORD) {
    const float v = value_of(o, select_min);
    r.thr = select_min ? fminf(r.thr, v) : fmaxf(r.thr, v);
    r.thr_worst = r.thr == (select_min ? INFINITY : -INFINITY);
  }
}

__device__ __forceinline__ bool passes(float v, float thr, bool thr_worst,
                                       bool select_min) {
  return (select_min ? v <= thr : v >= thr) || (thr_worst && v != v);
}

// sort the candidate list in runs of 32*E, merge them into the run, empty
// the list, and tighten the threshold to the run's k-th best (both are
// the k-th best of k elements seen, so either is a valid threshold)
template <int E>
__device__ __forceinline__ void flush(Run<E>& r, uint64_t* cand, int lane,
                                      int k, bool select_min) {
  __syncwarp();
  for (int c0 = 0; c0 < r.cnt; c0 += 32 * E) {
    uint64_t c[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = c0 + j * 32 + lane;
      c[j] = i < r.cnt ? cand[i] : PAD_KEY;
    }
    bitonic_sort<uint64_t, E>(c, lane);
    merge_into<E>(r.best, c, lane);
  }
  __syncwarp();
  r.cnt = 0;
  const int kk = k - 1;
  uint64_t reg = r.best[0];
#pragma unroll
  for (int j = 1; j < E; ++j) reg = (kk >> 5) == j ? r.best[j] : reg;
  const uint64_t kth = __shfl_sync(FULL, reg, kk & 31);
  tighten<E>(r, static_cast<uint32_t>(kth >> 32), select_min);
}

// offer N values per lane (positions pos0 + i, valid flags) to the run
template <int E, int N>
__device__ __forceinline__ void offer(Run<E>& r, uint64_t* cand,
                                      const float (&v)[N], int pos0,
                                      const bool (&valid)[N], int lane,
                                      int k, bool select_min) {
  bool pass[N];
  bool any = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    pass[i] = valid[i] && passes(v[i], r.thr, r.thr_worst, select_min);
    any |= pass[i];
  }
  if (!__any_sync(FULL, any)) return;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const unsigned m = __ballot_sync(FULL, pass[i]);
    if (pass[i]) {
      cand[r.cnt + __popc(m & below)] =
          (static_cast<uint64_t>(ord_of(v[i], select_min)) << 32) |
          static_cast<uint32_t>(pos0 + i);
    }
    r.cnt += __popc(m);
  }
  if (r.cnt >= 32 * E) flush<E>(r, cand, lane, k, select_min);
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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// candidate-list slots of one warp: under a full run, plus one step's
// (32 lanes x G values, or the head and tail)
template <int E>
__host__ __device__ constexpr int cand_slots() {
  return 32 * E + 32 * G;
}

template <typename T, int E>
__global__ void __launch_bounds__(32 * MAX_WARPS)
select_k_kernel(const T* __restrict__ x, int rows, int n, int k,
                bool select_min, int warps_per_row, int rows_per_block,
                T* __restrict__ out_v, int* __restrict__ out_p) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  __shared__ uint64_t cands[MAX_WARPS][cand_slots<E>()];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int w = warp % warps_per_row;
  const int row = blockIdx.x * rows_per_block + warp / warps_per_row;
  const bool live = row < rows;  // no early return: the block syncs below
  uint64_t* cand = cands[warp];

  Run<E> r;
#pragma unroll
  for (int j = 0; j < E; ++j) r.best[j] = PAD_KEY;
  r.cnt = 0;
  r.thr = select_min ? INFINITY : -INFINITY;  // every value passes
  r.thr_worst = true;
  if (live) {
    const T* in = x + static_cast<size_t>(row) * n;
    // elements before the row's first 16-byte boundary, then whole
    // vectors, then a scalar tail
    const uintptr_t addr = reinterpret_cast<uintptr_t>(in);
    const int head = min(n, static_cast<int>(((16 - (addr & 15)) & 15) /
                                             sizeof(T)));
    const int nvec = (n - head) / VEC;
    const int tail0 = head + nvec * VEC;
    const int per = (nvec + warps_per_row - 1) / warps_per_row;
    const int v0 = min(nvec, w * per);
    const int v1 = min(nvec, v0 + per);
    const uint4* vin = reinterpret_cast<const uint4*>(in + head);

    uint4 cur = make_uint4(0, 0, 0, 0);
    if (v0 + lane < v1) cur = __ldg(vin + v0 + lane);
    if constexpr (E == 1) {
      // the k-th best of the lanes' best values of their first load
      uint32_t o = PAD_ORD;
      if (v0 + lane < v1) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          o = min(o, ord_of(element<T>(cur, i), select_min));
        }
      }
      uint32_t a[1] = {o};
      bitonic_sort<uint32_t, 1>(a, lane);
      tighten<E>(r, __shfl_sync(FULL, a[0], k - 1), select_min);
    }
    for (int base = v0; base < v1; base += 32) {
      const int v = base + lane;
      uint4 nxt = make_uint4(0, 0, 0, 0);
      if (v + 32 < v1) nxt = __ldg(vin + v + 32);
#pragma unroll
      for (int g = 0; g < VEC; g += G) {
        float vals[G];
        bool valid[G];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          vals[i] = element<T>(cur, g + i);
          valid[i] = v < v1;
        }
        offer<E, G>(r, cand, vals, head + v * VEC + g, valid, lane, k,
                    select_min);
      }
      cur = nxt;
    }
    if (w == 0) {  // the head and the tail: fewer than 2*VEC <= 32 elements
      const int p = lane < head ? lane : tail0 + lane - head;
      const bool ok = lane < head + (n - tail0);
      float vals[1] = {ok ? widen(in[p]) : 0.f};
      bool valid[1] = {ok};
      offer<E, 1>(r, cand, vals, p, valid, lane, k, select_min);
    }
    flush<E>(r, cand, lane, k, select_min);
  }

  // the row's runs merged pairwise: warp w takes warp w + h's run
  for (int h = 1; h < warps_per_row; h <<= 1) {
#pragma unroll
    for (int j = 0; j < E; ++j) cand[j * 32 + lane] = r.best[j];
    __syncthreads();
    if (live && w % (2 * h) == 0 && w + h < warps_per_row) {
      uint64_t c[E];
#pragma unroll
      for (int j = 0; j < E; ++j) c[j] = cands[warp + h][j * 32 + lane];
      merge_into<E>(r.best, c, lane);
    }
    __syncthreads();
  }

  if (live && w == 0) {
    const T* in = x + static_cast<size_t>(row) * n;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int i = j * 32 + lane;
      if (i < k) {
        const int p = static_cast<int>(
            static_cast<uint32_t>(r.best[j] & 0xffffffffull));
        out_p[static_cast<size_t>(row) * k + i] = p;
        out_v[static_cast<size_t>(row) * k + i] = in[p];
      }
    }
  }
}

template <typename T>
int launch(const void* x, int rows, int n, int k, bool select_min,
           void* out_v, int* out_p, cudaStream_t s) {
  const int wpr = min(MAX_WARPS, max(1, n / ROW_SPLIT));
  const int rpb = max(1, SHORT_WARPS / wpr);
  const dim3 grid((rows + rpb - 1) / rpb);
  const dim3 block(32 * wpr * rpb);
  const T* in = static_cast<const T*>(x);
  T* ov = static_cast<T*>(out_v);
  if (k <= 32) {
    select_k_kernel<T, 1><<<grid, block, 0, s>>>(in, rows, n, k, select_min,
                                                 wpr, rpb, ov, out_p);
  } else if (k <= 64) {
    select_k_kernel<T, 2><<<grid, block, 0, s>>>(in, rows, n, k, select_min,
                                                 wpr, rpb, ov, out_p);
  } else if (k <= 128) {
    select_k_kernel<T, 4><<<grid, block, 0, s>>>(in, rows, n, k, select_min,
                                                 wpr, rpb, ov, out_p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16; out_v has the input's type
extern "C" int raft_select_k(const void* x, int rows, int n, int k,
                             int select_min, int dtype, void* out_v,
                             int* out_p, void* stream) {
  if (rows == 0 || k == 0) return 0;
  if (k > n) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mn = select_min != 0;
  switch (dtype) {
    case 0:
      return launch<float>(x, rows, n, k, mn, out_v, out_p, s);
    case 1:
      return launch<__half>(x, rows, n, k, mn, out_v, out_p, s);
    case 2:
      return launch<__nv_bfloat16>(x, rows, n, k, mn, out_v, out_p, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
