// The filtered warp select of kernel B2, shared by select_k.cu (B2) and
// ivf_pq_lut.cu (B4's fused per-step top-k): RAFT's warp_sort_filtered
// (matrix/detail/select_warpsort.cuh).
//
// Every candidate is compared on one 64-bit key: the value widened to
// float32 and mapped to an order-preserving unsigned integer in the high
// half (NaN replaced by the worst value, -0 by +0, inverted for
// select-max), its position in the low half.  Keys are distinct, so the k
// smallest keys are one set whatever the order in which they are found.
//
// A warp keeps a sorted run of its best KP = 32*E keys in registers,
// element i = j*32 + lane in register j, and a threshold: a value no
// better than the k-th best of some k elements it has seen.  offer()
// compares values with the threshold in float32 and appends the few that
// pass, as keys, to the warp's candidate list in shared memory; only when
// the list holds a full run of 32*E, and once at the end (flush()), does
// the warp bitonic-sort it in runs of 32*E (lane shuffles for partners
// under 32 apart, register swaps above), merge them into its run and
// tighten the threshold to the run's k-th best.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint64_t PAD_KEY = ~0ull;
constexpr uint32_t PAD_ORD = 0xffffffffu;  // above every element's image
constexpr int G = 4;              // values filtered per lane per step

// order-preserving image of a value (see above)
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

}  // namespace
