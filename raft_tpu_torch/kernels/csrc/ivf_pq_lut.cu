// IVF-PQ LUT scoring (kernel B4) for Hopper (sm_90a): one kernel, two modes.
//
// Replaces raft_tpu/kernels/ivf_pq_lut.py: _lut_score_pallas (body
// _lut_kernel), public entry lut_score.
//
// A candidate's score is sum over m of lut[m * 2^bits + code[m]], the codes
// bit-packed LSB-first, pq_bits (4..8) bits each (at 5-7 bits a code
// straddles two bytes), summed in m order by one thread (in float32, or
// under ACC in float16, below).
//
// Raw mode (raft_lut_score) is the TPU kernel's function: out[q, c] for
// every slot c of the row rows[q] of the index's (n_rows, cap, code_bytes)
// code block, read in place (a row outside the block is clamped into it).
//
// Scan mode (raft_lut_scan) is RAFT's fused IVF scan
// (neighbors/detail/ivf_flat_search.cuh:658-782 carried to PQ codes): in
// one launch per query batch it walks every query's S physical rows (the
// probe scan's steps), scores only the live slots of each (slots below
// phys_sizes[row]; the empty dummy row scores nothing), applies the
// search's epilogue in the PyTorch epilogue's float operations and order
// (score / scale for the fp8 LUT, + base[q, step], + list_csum[row, slot]
// where the list-side term rides per candidate; __fdiv_rn / __fadd_rn, so
// nothing is contracted), and keeps each step's best kk = min(k, cap)
// (value, slot) with B2's filtered warp select (warp_select.cuh).  A step
// with fewer than kk live slots fills the rest with the sentinel and the
// dead slots n_live, n_live + 1, ...: what a stable select over the masked
// (nq, cap) tile gives.  One B2 select over the (nq, S * kk) result then
// gives the top-k in the running merge's tie order.
//
// Tombstones (the mutable index's deletes): given the (n_rows, cap) ids
// and a bitmap of n_words 32-bit words, a live slot whose id has its bit
// set (bit id % 32 of word id / 32, the id clamped into the bitmap) is
// dead like a slot past the live size: it is never offered to the step's
// select, so however many dead candidates a step holds among its best, no
// live one is lost.  A step with fewer than kk candidates then fills the
// rest with the sentinel and slot -1.  The test reads 4 bytes of id per
// live candidate (the bitmap, 128 KB at a million ids, stays in L2);
// without the two inputs nothing of it runs.
//
// Design.  A block owns one query and a group of its steps (all S when
// the batch fills the card; a few queries spread their steps over up to S
// blocks) and walks them in order.  A batch too small to give every SM
// two one-step blocks (a solo query) also splits each step's live slots
// over up to 8 blocks: each leaves its run in global memory, and the last
// to arrive (counted by an atomic) merges the others' runs into its own
// and writes the step's winners.  Its warps split a step's live slots
// into contiguous slabs; each warp copies the packed codes of 32
// candidates at a time into shared memory with cp.async, neighbouring
// lanes on neighbouring 16 bytes, double-buffered across steps (the next
// 32, of this step or the next one, are in flight while these are
// scored); then every lane scores one candidate, reading its codes as
// 16-byte words (rows padded to an odd number of 16 bytes, so those reads
// have no bank conflicts) and extracting bytes at 8 bits, a 64-bit bit
// buffer below.  The query's LUT row lives in dynamic shared memory in
// its own type (64 KB at float32 for pq_dim 64 x 2^8, 16 KB at fp8),
// staged by one cp.async.bulk copy completing on an mbarrier: once per
// block when the LUT does not depend on the step, and double-buffered per
// step (the next probe's table in flight during this step) for the
// per-probe tables of the compressed LUTs; a buffer is refilled only once
// every warp has passed its wait on it and finished reading it.  A LUT row larger than what
// shared memory has left is read from global memory (through L1/L2)
// instead.  A step with live slots costs one barrier: each warp leaves
// its run in shared memory (two buffers, alternating), and warp 0 merges
// them and writes the step's kk winners while the other warps go on to
// the next step; a step with none costs none.  A winner at the worst
// value is scored again from the packed codes, so a NaN score comes back
// NaN, as the plain select's read-back gives it.
//
// Accumulation (acc_mode, the IVF-PQ search's internal_distance_dtype; the
// kernel's ACC template parameter, chosen at launch): 0 sums the float32
// terms in float32; 1 rounds each term to float16, sums in float32 and
// rounds the sum once to float16 (what XLA's float16 reduction on the CPU
// gives, the hoisted search's float16 sum); 2, raw mode only, rounds each
// term to float16 and adds them in float16 with __hadd in m order (the
// legacy search's running float16 sum).  The score leaves as a float32,
// the epilogue following in float32.
//
// Bound: memory.  Scan mode reads each live candidate's code bytes once,
// each query's LUT once, and writes (nq, S, kk) values and slots; raw
// mode reads cap * code_bytes bytes per query and writes nq * cap floats.
// The random LUT lookups are shared-memory gathers (bank conflicts among
// 32 random entries), which is what a block's issue slots go to.
//
// The SM count and the opt-in limit are read once per device, and each
// instantiation opts into a larger shared memory size only when it grows,
// so a launch makes no other runtime call.  Both entry points return
// cudaGetLastError() right after their launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "bulk_copy.cuh"
#include "warp_select.cuh"

namespace {

constexpr int MAX_WARPS = 8;
constexpr int MAX_DEVICES = 64;
constexpr int RAW = 0;   // MODE of raw scoring; scan mode's MODE is its E

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

// ---- the codes' cp.async copies ----
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait(bool keep_one) {
  if (keep_one) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
}

struct Params {
  const uint8_t* codes;   // (n_rows, cap, code_bytes)
  int n_rows, cap, code_bytes, pq_dim, bits;
  const int* rows;        // raw: (nq,); scan: (nq, S) physical rows
  int S;                  // steps per query (raw: 1)
  int steps_per_block;    // scan
  int tiles;              // scan: blocks that split a step's live slots
  uint64_t* scratch;      // scan, tiles > 1: (nq, S, tiles, 32E) runs
  int* counts;            // scan, tiles > 1: (nq, S) zeros, left zeroed
  int slots_per_block;    // raw: slots of a block's tile
  const void* lut;        // (nq, P, F) of the LUT type, F = pq_dim << bits
  int64_t lut_stride;     // elements between two queries' LUTs (P * F)
  int F;
  const int* probe_ord;   // scan: (nq, S) LUT slice of each step, or null
  const int* sizes;       // scan: (n_rows,) live slots of each row
  const float* base;      // scan: (nq, S)
  const float* csum;      // scan: (n_rows, cap) or null
  const float* scale;     // scan: (nq,) or null
  const int* ids;         // scan: (n_rows, cap) ids, or null (no mask)
  const uint32_t* tomb;   // scan: (n_words,) tombstone bitmap, with ids
  int n_words;
  int kk, select_min;
  int acc_mode;           // ACC (header): picks the instantiation
  float* out;             // raw: (nq, cap)
  float* out_v;           // scan: (nq, S, kk)
  int* out_s;             // scan: (nq, S, kk) slots
  int code_stride;        // bytes per staged code row (odd multiple of 16)
  int copy;               // 16, 4 or 1: bytes per copy of the codes
  int lut_bufs;           // LUT buffers in shared memory (0: global)
};

// the running sum of one candidate under ACC (header)
template <int ACC>
struct Acc {
  float s = 0.f;
  __device__ __forceinline__ void add(float v) {
    if constexpr (ACC == 1) {
      s += __half2float(__float2half_rn(v));
    } else {
      s += v;
    }
  }
  __device__ __forceinline__ float get() const {
    if constexpr (ACC == 1) return __half2float(__float2half_rn(s));
    return s;
  }
};
template <>
struct Acc<2> {
  __half s = __float2half_rn(0.f);
  __device__ __forceinline__ void add(float v) {
    s = __hadd(s, __float2half_rn(v));
  }
  __device__ __forceinline__ float get() const { return __half2float(s); }
};

// one candidate's sum over its codes at `row` (16-byte aligned, padded),
// in m order
template <int ACC, bool BYTE, typename T>
__device__ __forceinline__ float score_row(const uint8_t* row, const T* lut,
                                           int pq_dim, int bits) {
  const uint4* rp = reinterpret_cast<const uint4*>(row);
  Acc<ACC> acc;
  if constexpr (BYTE) {
    for (int j = 0; j * 16 < pq_dim; ++j) {
      const uint4 v = rp[j];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int m = j * 16 + t;
        if (m < pq_dim) {
          const uint32_t code = (w[t >> 2] >> (8 * (t & 3))) & 0xffu;
          acc.add(to_float(lut[(m << 8) + code]));
        }
      }
    }
  } else {
    const uint32_t mask = (1u << bits) - 1u;
    uint64_t buf = 0;
    int nb = 0;
    int m = 0;
    for (int j = 0; m < pq_dim; ++j) {
      const uint4 v = rp[j];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (m >= pq_dim) break;
        buf |= static_cast<uint64_t>(w[t]) << nb;
        nb += 32;
        while (nb >= bits && m < pq_dim) {
          acc.add(to_float(lut[(m << bits) + static_cast<int>(buf & mask)]));
          buf >>= bits;
          nb -= bits;
          ++m;
        }
      }
    }
  }
  return acc.get();
}

// the same sum read byte by byte from the packed codes in global memory
template <int ACC, typename T>
__device__ float score_packed(const uint8_t* p, const T* lut, int pq_dim,
                              int bits, int code_bytes) {
  const uint32_t mask = (1u << bits) - 1u;
  Acc<ACC> acc;
  for (int m = 0; m < pq_dim; ++m) {
    const int off = m * bits;
    const int lo = off >> 3;
    uint32_t two = p[lo];
    if (lo + 1 < code_bytes) two |= static_cast<uint32_t>(p[lo + 1]) << 8;
    acc.add(to_float(lut[(m << bits) + ((two >> (off & 7)) & mask)]));
  }
  return acc.get();
}

// copy the codes of candidates [c, c + nc) of a row into `buf` (rows of
// P.code_stride bytes), neighbouring lanes on neighbouring bytes
__device__ __forceinline__ void stage_codes(const Params& P,
                                            const uint8_t* rowp, int c,
                                            int nc, uint8_t* buf, int lane) {
  const int cb = P.code_bytes;
  const uint8_t* src = rowp + static_cast<int64_t>(c) * cb;
  if (P.copy == 16) {
    const int per = cb >> 4;
    for (int e = lane; e < nc * per; e += 32) {
      const int r = e / per;
      const int j = e - r * per;
      cp16(buf + r * P.code_stride + j * 16, src + r * cb + j * 16);
    }
  } else if (P.copy == 4) {
    const int per = cb >> 2;
    for (int e = lane; e < nc * per; e += 32) {
      const int r = e / per;
      const int j = e - r * per;
      cp4(buf + r * P.code_stride + j * 4, src + r * cb + j * 4);
    }
  } else {
    for (int e = lane; e < nc * cb; e += 32) {
      const int r = e / cb;
      buf[r * P.code_stride + (e - r * cb)] = __ldg(src + e);
    }
  }
  cp_commit();
}

// A step split over P.tiles blocks: this block's run `best` (warp 0's,
// ascending) goes to global memory and the block counts itself in; the
// last block to arrive merges every other block's run into `best`, resets
// the count for the next launch and returns true.
template <int E>
__device__ bool join_tiles(const Params& P, uint64_t (&best)[E], int qs,
                           int tile, int lane) {
  using ull = unsigned long long;
  const int64_t run0 = static_cast<int64_t>(qs) * P.tiles;
  uint64_t* mine = P.scratch + (run0 + tile) * 32 * E;
#pragma unroll
  for (int j = 0; j < E; ++j) mine[j * 32 + lane] = best[j];
  __threadfence();
  __syncwarp();
  int prior = 0;
  if (lane == 0) prior = atomicAdd(P.counts + qs, 1);
  prior = __shfl_sync(FULL, prior, 0);
  if (prior != P.tiles - 1) return false;
  __threadfence();
  for (int t = 0; t < P.tiles; ++t) {
    if (t == tile) continue;
    const ull* theirs =
        reinterpret_cast<const ull*>(P.scratch + (run0 + t) * 32 * E);
    uint64_t other[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      other[j] = static_cast<uint64_t>(__ldcg(theirs + j * 32 + lane));
    }
    merge_into<E>(best, other, lane);
  }
  if (lane == 0) P.counts[qs] = 0;
  return true;
}

// A warp's slab of one step: slots [a, b) of the row at rowp.
struct Slab {
  const uint8_t* rowp;
  int row, a, b;
};

template <int ACC, bool BYTE, typename T, int MODE, bool SMEM_LUT>
__global__ void __launch_bounds__(32 * MAX_WARPS, 2)
lut_kernel(const Params P) {
  constexpr bool SCAN = MODE != RAW;
  constexpr int E = SCAN ? MODE : 1;
  constexpr int CAND = 32 * E + 32;   // one run plus one round per lane
  extern __shared__ uint4 smem[];
  __shared__ uint64_t bars[2];
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  // shared memory: [LUT buffers][codes: 2 x 32 rows per warp]
  // [candidate lists: CAND per warp][runs: 2 x 32E per warp]
  const int lut_bytes = P.F * static_cast<int>(sizeof(T));
  uint8_t* base_s = reinterpret_cast<uint8_t*>(smem);
  T* lut_s = reinterpret_cast<T*>(base_s);
  uint8_t* codes_s = base_s + (SMEM_LUT ? P.lut_bufs * lut_bytes : 0);
  const int stride = 32 * P.code_stride;
  uint8_t* cbuf = codes_s + warp * 2 * stride;
  uint64_t* cands = reinterpret_cast<uint64_t*>(codes_s + warps * 2 * stride);
  uint64_t* cand = cands + warp * CAND;
  uint64_t* runs = cands + warps * CAND;   // [2][warps][32E]

  const T* lut_g = static_cast<const T*>(P.lut) + q * P.lut_stride;
  // scan mode: blockIdx.y is (step group, tile of its live slots)
  const int tiles = SCAN ? P.tiles : 1;
  const int tile = SCAN ? blockIdx.y % tiles : 0;
  const int s0 = SCAN ? blockIdx.y / tiles * P.steps_per_block : 0;
  const int s1 = SCAN ? min(P.S, s0 + P.steps_per_block) : 1;
  const bool per_step_lut = SCAN && P.probe_ord != nullptr;
  auto lut_of = [&](int s) {
    return per_step_lut ? lut_g + static_cast<int64_t>(
                                      P.probe_ord[q * P.S + s]) * P.F
                        : lut_g;
  };
  // the LUT of step s into buffer b, by one bulk copy (the wrapper keeps
  // the LUT 16-byte aligned; lut_bytes is a multiple of 16)
  auto stage_lut = [&](int b, int s) {
    if (threadIdx.x == 0) {
      bulk_copy(lut_s + b * P.F, lut_of(s), lut_bytes, &bars[b]);
    }
  };
  uint32_t phases = 0;   // bit b: the parity bars[b] completes next
  if constexpr (SMEM_LUT) {
    if (threadIdx.x == 0) {
      bar_init(&bars[0]);
      bar_init(&bars[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    stage_lut(0, s0);
  }

  // this warp's slots of step s: raw mode a tile of the row rows[q],
  // scan mode this block's share of the live slots of the step's row (in
  // whole rounds of 32), split over the warps
  auto slab_of = [&](int s) {
    Slab sl;
    int lo = 0, hi = 0;
    if constexpr (SCAN) {
      sl.row = min(max(P.rows[q * P.S + s], 0), P.n_rows - 1);
      const int n_live = min(max(P.sizes[sl.row], 0), P.cap);
      const int span = ((n_live + 31) / 32 + tiles - 1) / tiles * 32;
      lo = min(n_live, tile * span);
      hi = min(n_live, lo + span);
    } else {
      sl.row = min(max(P.rows[q], 0), P.n_rows - 1);
      lo = blockIdx.y * P.slots_per_block;
      hi = min(P.cap, lo + P.slots_per_block);
    }
    const int per = ((hi - lo + 31) / 32 + warps - 1) / warps * 32;
    sl.a = min(hi, lo + warp * per);
    sl.b = min(hi, sl.a + per);
    sl.rowp = P.codes + static_cast<int64_t>(sl.row) * P.cap * P.code_bytes;
    return sl;
  };

  // the codes pipeline runs across steps: the round after the current one
  // (this step's next, or the next step's first) is in flight while the
  // current one is scored
  int wbuf = 0;   // buffer the next copy goes to
  int rbuf = 0;   // buffer the next round is read from
  auto issue = [&](const Slab& sl, int c) {
    stage_codes(P, sl.rowp, c, min(32, sl.b - c), cbuf + wbuf * stride, lane);
    wbuf ^= 1;
  };
  Slab cur = slab_of(s0);
  if (cur.b > cur.a) issue(cur, cur.a);
  int ne = 0;   // non-empty steps so far: the runs buffer alternates
  // the last step ended on a block barrier (or there was none): true
  // alike in every warp
  bool synced = true;

  for (int s = s0; s < s1; ++s) {
    const T* lut;
    if constexpr (SMEM_LUT) {
      const int b = per_step_lut ? ((s - s0) & 1) : 0;
      // the next step's table into the other buffer, which held step
      // s - 1's.  A step with live slots ended on a block barrier, which
      // every warp reached after its wait on that buffer and its reads of
      // it, so only warp 0's re-score can still be reading it; after an
      // empty step the block syncs here, so that no warp is still short of
      // its wait when thread 0 arms the buffer's mbarrier again.
      if (per_step_lut && s + 1 < s1) {
        if (synced) {
          __syncwarp();
        } else {
          __syncthreads();
        }
        stage_lut(b ^ 1, s + 1);
      }
      if (per_step_lut || s == s0) {
        bar_wait(&bars[b], (phases >> b) & 1u);
        phases ^= 1u << b;
      }
      lut = lut_s + b * P.F;
    } else {
      lut = lut_of(s);
    }

    Slab next = cur;
    bool have_next = false;
    auto score_rounds = [&](auto use) {
      for (int c0 = cur.a; c0 < cur.b; c0 += 32) {
        bool more = false;
        if (c0 + 32 < cur.b) {
          issue(cur, c0 + 32);
          more = true;
        } else if (s + 1 < s1) {
          next = slab_of(s + 1);
          have_next = true;
          if (next.b > next.a) {
            issue(next, next.a);
            more = true;
          }
        }
        cp_wait(more);
        __syncwarp();
        const int c = c0 + lane;
        const bool valid = c < cur.b;
        float acc = 0.f;
        if (valid) {
          acc = score_row<ACC, BYTE, T>(
              cbuf + rbuf * stride + lane * P.code_stride, lut, P.pq_dim,
              P.bits);
        }
        rbuf ^= 1;
        use(c, valid, acc);
        __syncwarp();   // this buffer is refilled two rounds on
      }
    };

    if constexpr (!SCAN) {
      float* out_q = P.out + static_cast<int64_t>(q) * P.cap;
      score_rounds([&](int c, bool valid, float acc) {
        if (valid) out_q[c] = acc;
      });
    } else {
      const bool mn = P.select_min != 0;
      const int qs = q * P.S + s;
      const int n_live = min(max(P.sizes[cur.row], 0), P.cap);
      const float bq = P.base[qs];
      const float sc = P.scale != nullptr ? P.scale[q] : 1.f;
      const float* csum_row =
          P.csum != nullptr ? P.csum + static_cast<int64_t>(cur.row) * P.cap
                            : nullptr;
      const int* ids_row =
          P.ids != nullptr ? P.ids + static_cast<int64_t>(cur.row) * P.cap
                           : nullptr;
      // a candidate whose id is tombstoned is dead (ids_row given)
      auto dead = [&](int c) {
        int id = max(__ldg(ids_row + c), 0);
        if (static_cast<int64_t>(id) >= static_cast<int64_t>(P.n_words) * 32) {
          id = P.n_words * 32 - 1;
        }
        return ((__ldg(P.tomb + (id >> 5)) >> (id & 31)) & 1u) != 0u;
      };
      auto finish = [&](int c, float acc) {
        float v = acc;
        if (P.scale != nullptr) v = __fdiv_rn(v, sc);
        v = __fadd_rn(v, bq);
        if (csum_row != nullptr) v = __fadd_rn(v, csum_row[c]);
        return v;
      };
      Run<E> run;
#pragma unroll
      for (int j = 0; j < E; ++j) run.best[j] = PAD_KEY;
      run.cnt = 0;
      run.thr = mn ? INFINITY : -INFINITY;   // every value passes
      run.thr_worst = true;
      score_rounds([&](int c, bool valid, float acc) {
        const bool live = valid && (ids_row == nullptr || !dead(c));
        float v[1] = {live ? finish(c, acc) : 0.f};
        bool ok[1] = {live};
        offer<E, 1>(run, cand, v, c, ok, lane, P.kk, mn);
      });

      if (n_live > 0) {   // uniform over the block
        flush<E>(run, cand, lane, P.kk, mn);
        uint64_t* mine = runs + ((ne & 1) * warps + warp) * 32 * E;
#pragma unroll
        for (int j = 0; j < E; ++j) mine[j * 32 + lane] = run.best[j];
        __syncthreads();
        if (warp == 0) {   // the warps' runs merged into warp 0's
          for (int w = 1; w < warps; ++w) {
            const uint64_t* theirs = runs + ((ne & 1) * warps + w) * 32 * E;
            uint64_t other[E];
#pragma unroll
            for (int j = 0; j < E; ++j) other[j] = theirs[j * 32 + lane];
            merge_into<E>(run.best, other, lane);
          }
        }
        ++ne;
      }
      synced = n_live > 0;
      // a split step: the last of its blocks writes the merged winners
      const bool writes =
          warp == 0 && (tiles == 1 || join_tiles<E>(P, run.best, qs, tile,
                                                    lane));
      if (writes) {
        const uint32_t worst = ord_of(mn ? INFINITY : -INFINITY, mn);
        const int64_t o = static_cast<int64_t>(qs) * P.kk;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int i = j * 32 + lane;
          if (i < P.kk) {
            const uint64_t key = run.best[j];
            // past the candidates: a dead slot's sentinel (slot -1 under
            // a tombstone mask, whose dead slots lie among the live ones)
            int slot = ids_row != nullptr ? -1 : i;
            float v = mn ? INFINITY : -INFINITY;
            if (key != PAD_KEY) {
              slot = static_cast<int>(static_cast<uint32_t>(key));
              const uint32_t ord = static_cast<uint32_t>(key >> 32);
              v = value_of(ord, mn);
              if (ord == worst) {   // inf or NaN: the exact value
                v = finish(slot, score_packed<ACC, T>(
                                     cur.rowp + static_cast<int64_t>(slot) *
                                                    P.code_bytes,
                                     lut, P.pq_dim, P.bits, P.code_bytes));
              }
            }
            P.out_v[o + i] = v;
            P.out_s[o + i] = slot;
          }
        }
      }
    }
    if (s + 1 < s1) {
      if (!have_next) {   // this warp scored nothing this step
        next = slab_of(s + 1);
        if (next.b > next.a) issue(next, next.a);
      }
      cur = next;
    }
  }
}

// SM count and opt-in shared memory per block of each device, read once
struct DeviceInfo {
  std::atomic<int> sms{0};
  std::atomic<int> optin{0};
};
DeviceInfo g_devices[MAX_DEVICES];

cudaError_t device_info(int dev, int* sms, int* optin) {
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  DeviceInfo& info = g_devices[dev];
  if (info.sms.load(std::memory_order_relaxed) == 0) {
    int s = 0, o = 0;
    cudaError_t e =
        cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&o, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
    }
    if (e != cudaSuccess) return e;
    info.optin.store(o, std::memory_order_relaxed);
    info.sms.store(s, std::memory_order_relaxed);
  }
  *sms = info.sms.load(std::memory_order_relaxed);
  *optin = info.optin.load(std::memory_order_relaxed);
  return cudaSuccess;
}

template <int ACC, bool BYTE, typename T, int MODE, bool SMEM_LUT>
int launch_kernel(const Params& P, dim3 grid, int warps, int smem, int dev,
                  cudaStream_t s) {
  auto kernel = lut_kernel<ACC, BYTE, T, MODE, SMEM_LUT>;
  // above 48 KB (static and dynamic together) a block gets shared memory
  // only after opting in; this instantiation's opted-in size on each
  // device (set at its first launch, whatever the size)
  static std::atomic<int> opted[MAX_DEVICES];
  if (smem > opted[dev].load(std::memory_order_relaxed)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev].store(smem, std::memory_order_relaxed);
  }
  kernel<<<grid, 32 * warps, smem, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}

template <int ACC, bool BYTE, typename T, int MODE>
int launch_smem(const Params& P, dim3 grid, int warps, int smem, int dev,
                cudaStream_t s) {
  if (P.lut_bufs > 0) {
    return launch_kernel<ACC, BYTE, T, MODE, true>(P, grid, warps, smem, dev,
                                                   s);
  }
  return launch_kernel<ACC, BYTE, T, MODE, false>(P, grid, warps, smem, dev,
                                                  s);
}

template <int ACC, typename T, int MODE>
int launch_bits(const Params& P, dim3 grid, int warps, int smem, int dev,
                cudaStream_t s) {
  if (P.bits == 8) {
    return launch_smem<ACC, true, T, MODE>(P, grid, warps, smem, dev, s);
  }
  return launch_smem<ACC, false, T, MODE>(P, grid, warps, smem, dev, s);
}

// the instantiation of P.acc_mode, P.bits and P.lut_bufs; scan mode has
// ACC 0 and 1 only
template <typename T, int MODE>
int launch_lut(const Params& P, dim3 grid, int warps, int smem, int dev,
               cudaStream_t s) {
  if (P.acc_mode == 1) {
    return launch_bits<1, T, MODE>(P, grid, warps, smem, dev, s);
  }
  if constexpr (MODE == RAW) {
    if (P.acc_mode == 2) {
      return launch_bits<2, T, MODE>(P, grid, warps, smem, dev, s);
    }
  }
  return launch_bits<0, T, MODE>(P, grid, warps, smem, dev, s);
}

// Fill the layout fields of P (code rows, copy width, warps, LUT buffers)
// and return the dynamic shared memory of a block, or -1 on a bad shape.
template <typename T>
int layout(Params& P, int mode_e, int n_lut_bufs, int optin, int* warps) {
  int stride = (P.code_bytes + 15) / 16 * 16;
  if ((stride / 16) % 2 == 0) stride += 16;   // odd: conflict-free rows
  P.code_stride = stride;
  const bool aligned16 = (reinterpret_cast<uintptr_t>(P.codes) & 15) == 0;
  const bool aligned4 = (reinterpret_cast<uintptr_t>(P.codes) & 3) == 0;
  P.copy = (P.code_bytes % 16 == 0 && aligned16) ? 16
           : (P.code_bytes % 4 == 0 && aligned4) ? 4 : 1;
  // scan mode: a candidate list and two runs of 32E keys per warp
  const int cand = mode_e > 0 ? (32 * mode_e + 32 + 2 * 32 * mode_e) * 8 : 0;
  const int per_warp = 2 * 32 * stride + cand;
  int w = MAX_WARPS;
  while (w > 1 && w * per_warp > optin / 2) w /= 2;
  const int rest = w * per_warp;
  if (rest > optin) return -1;
  const int lut_bytes = P.F * static_cast<int>(sizeof(T));
  P.lut_bufs = rest + n_lut_bufs * lut_bytes <= optin ? n_lut_bufs : 0;
  *warps = w;
  return rest + P.lut_bufs * lut_bytes;
}

template <typename T>
int raw(Params P, int nq, int dev, cudaStream_t s) {
  int sms = 0, optin = 0;
  const cudaError_t info = device_info(dev, &sms, &optin);
  if (info != cudaSuccess) return static_cast<int>(info);
  int warps = 0;
  const int smem = layout<T>(P, 0, 1, optin, &warps);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  // one tile of slots per query once the grid fills the card; split the
  // slots of few queries over more blocks
  const int max_tiles = (P.cap + 32 * warps - 1) / (32 * warps);
  int tiles = (4 * sms + nq - 1) / nq;
  tiles = tiles < 1 ? 1 : (tiles > max_tiles ? max_tiles : tiles);
  P.slots_per_block = (P.cap + tiles - 1) / tiles;
  tiles = (P.cap + P.slots_per_block - 1) / P.slots_per_block;
  const dim3 grid(nq, tiles);
  return launch_lut<T, RAW>(P, grid, warps, smem, dev, s);
}

// Blocks per step: one, unless the batch is too small to give every SM two
// blocks of one step each; then up to 8, each with a share of at least 256
// of the row's slots.
int tiles_of(int nq, int S, int cap, int sms) {
  const int64_t blocks = static_cast<int64_t>(nq) * S;
  if (blocks >= 2 * sms) return 1;
  const int want = static_cast<int>((2 * sms + blocks - 1) / blocks);
  const int most = cap / 256 < 1 ? 1 : (cap / 256 > 8 ? 8 : cap / 256);
  return want < most ? want : most;
}

template <typename T, int E>
int scan_e(Params P, int nq, int dev, cudaStream_t s) {
  int sms = 0, optin = 0;
  const cudaError_t info = device_info(dev, &sms, &optin);
  if (info != cudaSuccess) return static_cast<int>(info);
  int warps = 0;
  const int smem =
      layout<T>(P, E, P.probe_ord != nullptr ? 2 : 1, optin, &warps);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  // all of a query's steps in one block once the batch fills the card;
  // a few queries spread their steps over more blocks, and with the
  // caller's tiles (tiles_of) split each step's slots over several
  int groups = (4 * sms + nq - 1) / nq;
  groups = groups < 1 ? 1 : (groups > P.S ? P.S : groups);
  if (P.tiles > 1) groups = P.S;
  P.steps_per_block = (P.S + groups - 1) / groups;
  groups = (P.S + P.steps_per_block - 1) / P.steps_per_block;
  const dim3 grid(nq, groups * P.tiles);
  return launch_lut<T, E>(P, grid, warps, smem, dev, s);
}

template <typename T>
int scan(const Params& P, int nq, int dev, cudaStream_t s) {
  if (P.kk <= 32) return scan_e<T, 1>(P, nq, dev, s);
  if (P.kk <= 64) return scan_e<T, 2>(P, nq, dev, s);
  return scan_e<T, 4>(P, nq, dev, s);
}

// the LUT's bulk copies need 16-byte aligned rows
bool bad_shape(const Params& P) {
  return P.n_rows < 1 || P.bits < 4 || P.bits > 8 || P.acc_mode < 0 ||
         P.acc_mode > 2 ||
         P.code_bytes * 8 < P.pq_dim * P.bits ||
         (reinterpret_cast<uintptr_t>(P.lut) & 15) != 0;
}

}  // namespace

// Raw mode.  lut (nq, pq_dim << pq_bits) of lut_dtype (0 float32,
// 1 bfloat16, 2 float16, 3 float8 e4m3); out (nq, cap) float32; acc_mode
// 0, 1 or 2 (header); device is the CUDA device the stream belongs to
extern "C" int raft_lut_score(const uint8_t* codes, const int* rows,
                              const void* lut, float* out, int nq,
                              int n_rows, int cap, int code_bytes,
                              int pq_dim, int pq_bits, int lut_dtype,
                              int acc_mode, int device, void* stream) {
  if (nq == 0 || cap == 0) return 0;
  Params P = {};
  P.codes = codes;
  P.n_rows = n_rows;
  P.cap = cap;
  P.code_bytes = code_bytes;
  P.pq_dim = pq_dim;
  P.bits = pq_bits;
  P.rows = rows;
  P.S = 1;
  P.lut = lut;
  P.F = pq_dim << pq_bits;
  P.lut_stride = P.F;
  P.out = out;
  P.acc_mode = acc_mode;
  if (bad_shape(P)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lut_dtype) {
    case 0: return raw<float>(P, nq, device, s);
    case 1: return raw<__nv_bfloat16>(P, nq, device, s);
    case 2: return raw<__half>(P, nq, device, s);
    case 3: return raw<__nv_fp8_e4m3>(P, nq, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Scan mode's blocks per step for a batch of nq queries of S steps over
// rows of cap slots on `device` (1 for a batch that fills the card), or a
// negated CUDA error code
extern "C" int raft_lut_scan_tiles(int nq, int S, int cap, int device) {
  int sms = 0, optin = 0;
  const cudaError_t info = device_info(device, &sms, &optin);
  if (info != cudaSuccess) return -static_cast<int>(info);
  return tiles_of(nq, S, cap, sms);
}

// Scan mode.  phys (nq, S) rows; sizes (n_rows,); lut (nq, n_luts, F);
// probe_ord (nq, S) LUT slice per step, null when n_luts == 1; base
// (nq, S); csum (n_rows, cap) and scale (nq,) nullable; out_v and out_s
// (nq, S, kk) with 1 <= kk <= min(128, cap); tiles from
// raft_lut_scan_tiles, and when it is above 1, scratch of
// nq * S * tiles * 128 keys and counts of nq * S zeros (left zeroed);
// ids (n_rows, cap) and tomb (n_words,) both null, or both given (the
// tombstone mask); acc_mode 0 or 1 (header)
extern "C" int raft_lut_scan(const uint8_t* codes, const int* phys,
                             const int* sizes, const void* lut,
                             const int* probe_ord, int n_luts,
                             const float* base, const float* csum,
                             const float* scale, float* out_v, int* out_s,
                             int nq, int S, int n_rows, int cap,
                             int code_bytes, int pq_dim, int pq_bits,
                             int lut_dtype, int kk, int select_min,
                             int tiles, uint64_t* scratch, int* counts,
                             const int* ids, const uint32_t* tomb,
                             int n_words, int acc_mode, int device,
                             void* stream) {
  if (nq == 0 || S == 0) return 0;
  Params P = {};
  P.codes = codes;
  P.n_rows = n_rows;
  P.cap = cap;
  P.code_bytes = code_bytes;
  P.pq_dim = pq_dim;
  P.bits = pq_bits;
  P.rows = phys;
  P.S = S;
  P.lut = lut;
  P.F = pq_dim << pq_bits;
  P.lut_stride = static_cast<int64_t>(n_luts) * P.F;
  P.probe_ord = n_luts > 1 ? probe_ord : nullptr;
  P.sizes = sizes;
  P.base = base;
  P.csum = csum;
  P.scale = scale;
  P.kk = kk;
  P.select_min = select_min;
  P.out_v = out_v;
  P.out_s = out_s;
  P.tiles = tiles;
  P.scratch = scratch;
  P.counts = counts;
  P.ids = ids;
  P.tomb = tomb;
  P.n_words = n_words;
  P.acc_mode = acc_mode;
  if (bad_shape(P) || acc_mode > 1 || kk < 1 || kk > 128 || kk > cap ||
      n_luts < 1 ||
      (ids == nullptr) != (tomb == nullptr) ||
      (tomb != nullptr && n_words < 1) ||
      (n_luts > 1 && probe_ord == nullptr) || tiles < 1 || tiles > 8 ||
      (tiles > 1 && (scratch == nullptr || counts == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lut_dtype) {
    case 0: return scan<float>(P, nq, device, s);
    case 1: return scan<__nv_bfloat16>(P, nq, device, s);
    case 2: return scan<__half>(P, nq, device, s);
    case 3: return scan<__nv_fp8_e4m3>(P, nq, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
