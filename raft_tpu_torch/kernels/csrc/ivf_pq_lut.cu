// IVF-PQ LUT scoring (kernel B4) for Hopper (sm_90a).
//
// Replaces raft_tpu/kernels/ivf_pq_lut.py: _lut_score_pallas (body
// _lut_kernel), public entry lut_score.
//
// out[q, c] = sum over m of lut[q, m * 2^bits + code[q, c, m]], the codes
// bit-packed LSB-first, pq_bits (4..8) bits each, so at 5-7 bits a code
// straddles two bytes.  The sum is taken in float32, in m order.
//
// The TPU kernel contracts a one-hot of the codes against the LUT on the
// matrix unit, which caps the LUT row at 4,096 entries (the one-hot block
// has to fit VMEM).  Hopper gathers instead: one block owns one query and
// a tile of candidate slots, stages the query's LUT row in dynamic shared
// memory in its own type (64 KB at float32 for pq_dim 64 x 2^8, 16 KB at
// fp8), and each thread scores whole candidates: it streams the
// candidate's packed bytes through a 64-bit bit buffer (16-byte loads
// where the rows allow it, else 4-byte, else single bytes) and adds one
// shared-memory entry per subspace.
//
// A row larger than the shared memory one block may opt into (227 KB on
// the H100; pq_dim 480 x 2^8 at float32 is 480 KB) is staged in chunks of
// subspaces, a multiple of 128 so that every chunk starts on a 16-byte
// boundary of the packed codes: each thread carries its candidates' sums
// from chunk to chunk through the output, so the sum stays in m order.
//
// The codes are read in place: the kernel takes the index's whole
// (n_rows, cap, code_bytes) block plus the physical row each query scans
// this step, so the (nq, cap, code_bytes) gather never exists.  A row
// outside the block is clamped into it, as the JAX package's gathers
// clamp.  Padding slots and the empty dummy row are scored like any
// other; the caller's live-slot mask discards them.
//
// Bound: each step reads cap * code_bytes code bytes of each distinct row
// and one LUT row per query and writes nq * cap floats, a few operations
// per byte, so it is bound by memory.  Every block re-stages its query's
// LUT row, so the tiles of a query are kept few (one per query once the
// grid fills the card).
//
// The SM count and the opt-in limit are read once per device, and each
// instantiation opts into a larger shared memory size only when it grows,
// so a launch makes no other runtime call.  raft_lut_score returns
// cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DEVICES = 64;
// subspaces per chunk are a multiple of this: 128 codes of any width end
// on a 16-byte boundary
constexpr int CHUNK_ALIGN = 128;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

// acc plus the sum of one candidate's n_sub LUT entries, read from its
// packed bytes at p.  LOAD is the bytes of one load (16, 4 or 1); p is a
// multiple of it.
template <int BITS, int LOAD, typename T>
__device__ __forceinline__ float score_candidate(const uint8_t* p, int n_sub,
                                                 const T* lut, float acc) {
  constexpr uint32_t MASK = (1u << BITS) - 1u;
  uint64_t buf = 0;
  int nb = 0;
  int m = 0;
  auto feed = [&](uint32_t word, int nbits) {
    if (m >= n_sub) return;
    buf |= static_cast<uint64_t>(word) << nb;
    nb += nbits;
    while (nb >= BITS && m < n_sub) {
      acc += to_float(lut[(m << BITS) + static_cast<int>(buf & MASK)]);
      buf >>= BITS;
      nb -= BITS;
      ++m;
    }
  };
  for (int off = 0; m < n_sub; off += LOAD) {
    if constexpr (LOAD == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + off);
      feed(v.x, 32);
      feed(v.y, 32);
      feed(v.z, 32);
      feed(v.w, 32);
    } else if constexpr (LOAD == 4) {
      feed(*reinterpret_cast<const uint32_t*>(p + off), 32);
    } else {
      feed(p[off], 8);
    }
  }
  return acc;
}

template <int BITS, typename T>
__global__ void __launch_bounds__(THREADS)
lut_score_kernel(const uint8_t* __restrict__ codes,
                 const int* __restrict__ rows, const T* __restrict__ lut,
                 float* __restrict__ out, int n_rows, int cap, int code_bytes,
                 int pq_dim, int chunk_m, int slots_per_block) {
  extern __shared__ uint4 smem_raw[];
  T* lut_s = reinterpret_cast<T*>(smem_raw);
  const int q = blockIdx.x;
  const T* lut_q = lut + static_cast<int64_t>(q) * (pq_dim << BITS);
  const int c0 = blockIdx.y * slots_per_block;
  const int c1 = min(cap, c0 + slots_per_block);
  const int row = min(max(rows[q], 0), n_rows - 1);
  const uint8_t* base = codes + static_cast<int64_t>(row) * cap * code_bytes;
  float* out_q = out + static_cast<int64_t>(q) * cap;
  const bool vec16 = (code_bytes & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const bool vec4 = (code_bytes & 3) == 0 &&
                    (reinterpret_cast<uintptr_t>(codes) & 3) == 0;

  for (int m0 = 0; m0 < pq_dim; m0 += chunk_m) {
    const int mc = min(chunk_m, pq_dim - m0);
    if (m0 > 0) __syncthreads();  // every thread is done with the last chunk
    // stage the chunk's LUT entries: 16-byte copies when they allow them
    const T* src_t = lut_q + (static_cast<int64_t>(m0) << BITS);
    const int len = mc << BITS;
    const int bytes = len * static_cast<int>(sizeof(T));
    if ((reinterpret_cast<uintptr_t>(src_t) & 15) == 0 && (bytes & 15) == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(src_t);
      for (int i = threadIdx.x; i < bytes / 16; i += THREADS) {
        smem_raw[i] = src[i];
      }
    } else {
      for (int i = threadIdx.x; i < len; i += THREADS) lut_s[i] = src_t[i];
    }
    __syncthreads();

    const int byte0 = (m0 * BITS) >> 3;  // a multiple of 16 (CHUNK_ALIGN)
    for (int c = c0 + threadIdx.x; c < c1; c += THREADS) {
      const uint8_t* p = base + static_cast<int64_t>(c) * code_bytes + byte0;
      const float acc = m0 == 0 ? 0.f : out_q[c];
      float s;
      if (vec16) {
        s = score_candidate<BITS, 16>(p, mc, lut_s, acc);
      } else if (vec4) {
        s = score_candidate<BITS, 4>(p, mc, lut_s, acc);
      } else {
        s = score_candidate<BITS, 1>(p, mc, lut_s, acc);
      }
      out_q[c] = s;
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

template <int BITS, typename T>
int launch(const uint8_t* codes, const int* rows, const void* lut, float* out,
           int nq, int n_rows, int cap, int code_bytes, int pq_dim, int dev,
           cudaStream_t s) {
  int sms = 0, optin = 0;
  const cudaError_t info = device_info(dev, &sms, &optin);
  if (info != cudaSuccess) return static_cast<int>(info);
  // the whole row when it fits, else chunks of CHUNK_ALIGN-multiple subspaces
  const size_t sub_bytes = static_cast<size_t>(1 << BITS) * sizeof(T);
  int chunk_m = pq_dim;
  if (static_cast<size_t>(pq_dim) * sub_bytes > static_cast<size_t>(optin)) {
    chunk_m = static_cast<int>(optin / sub_bytes) / CHUNK_ALIGN * CHUNK_ALIGN;
    if (chunk_m == 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(chunk_m * sub_bytes);
  auto kernel = lut_score_kernel<BITS, T>;
  // above 48 KB a block gets dynamic shared memory only after opting in;
  // this instantiation's opted-in size on each device
  static std::atomic<int> opted[MAX_DEVICES];
  if (smem > 48 * 1024 && smem > opted[dev].load(std::memory_order_relaxed)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev].store(smem, std::memory_order_relaxed);
  }
  // one tile of candidates per query once the grid fills the card; split
  // the candidates of few queries over more blocks
  const int want_blocks = 6 * sms;
  const int max_tiles = (cap + THREADS - 1) / THREADS;
  int tiles = (want_blocks + nq - 1) / nq;
  tiles = tiles < 1 ? 1 : (tiles > max_tiles ? max_tiles : tiles);
  const int slots = (cap + tiles - 1) / tiles;
  tiles = (cap + slots - 1) / slots;
  const dim3 grid(nq, tiles);
  kernel<<<grid, THREADS, smem, s>>>(codes, rows, static_cast<const T*>(lut),
                                     out, n_rows, cap, code_bytes, pq_dim,
                                     chunk_m, slots);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bits(const uint8_t* codes, const int* rows, const void* lut,
                float* out, int nq, int n_rows, int cap, int code_bytes,
                int pq_dim, int pq_bits, int dev, cudaStream_t s) {
  switch (pq_bits) {
    case 4: return launch<4, T>(codes, rows, lut, out, nq, n_rows, cap, code_bytes, pq_dim, dev, s);
    case 5: return launch<5, T>(codes, rows, lut, out, nq, n_rows, cap, code_bytes, pq_dim, dev, s);
    case 6: return launch<6, T>(codes, rows, lut, out, nq, n_rows, cap, code_bytes, pq_dim, dev, s);
    case 7: return launch<7, T>(codes, rows, lut, out, nq, n_rows, cap, code_bytes, pq_dim, dev, s);
    case 8: return launch<8, T>(codes, rows, lut, out, nq, n_rows, cap, code_bytes, pq_dim, dev, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// lut_dtype: 0 float32, 1 bfloat16, 2 float16, 3 float8 e4m3; device is
// the CUDA device the stream belongs to
extern "C" int raft_lut_score(const uint8_t* codes, const int* rows,
                              const void* lut, float* out, int nq,
                              int n_rows, int cap, int code_bytes,
                              int pq_dim, int pq_bits, int lut_dtype,
                              int device, void* stream) {
  if (nq == 0 || cap == 0) return 0;
  if (n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (code_bytes * 8 < pq_dim * pq_bits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lut_dtype) {
    case 0: return launch_bits<float>(codes, rows, lut, out, nq, n_rows, cap, code_bytes, pq_dim, pq_bits, device, s);
    case 1: return launch_bits<__nv_bfloat16>(codes, rows, lut, out, nq, n_rows, cap, code_bytes, pq_dim, pq_bits, device, s);
    case 2: return launch_bits<__half>(codes, rows, lut, out, nq, n_rows, cap, code_bytes, pq_dim, pq_bits, device, s);
    case 3: return launch_bits<__nv_fp8_e4m3>(codes, rows, lut, out, nq, n_rows, cap, code_bytes, pq_dim, pq_bits, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
