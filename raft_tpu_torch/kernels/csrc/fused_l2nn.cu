// Kernel B1 (fused L2 nearest neighbour) and kernel B3 (the k-means
// E-step plus the M-step partials) for Hopper (sm_90a).
//
// Replaces raft_tpu/kernels/fused_l2nn.py: fused_l2_nn_pallas (body
// _kernel) and _fused_l2_nn_partials (body _em_kernel).
//
// B1 computes, per row of x, min over rows of y of
//   max(||x||^2 + ||y||^2 - 2 x.y, 0)
// and the index of that row; the LOWEST index wins exact ties, NaN never
// wins, and a row with no candidate gets index 0.  At d = 128 the work is
// 2*m*k*d flop against 4*(m + k)*d bytes: bound by operations, never by
// memory.  Two kernels, chosen by the row width and the product type
// alone (never by m, so a row's bits do not depend on its batch):
//
// * fused_l2nn_tc_kernel (float32 products, 1 <= d <= TC_MAX_D): the products
//   on the tensor cores as 3xTF32.  Each operand is split as hi = tf32(a),
//   lo = tf32(a - hi) (round to nearest), and each 8-deep slice adds
//   lo*hi, hi*lo, then hi*hi into float32 sums: about 21 bits of every
//   product, against one pass's 11, which would flip argmins.  A block
//   is two warpgroups and owns 128 rows of x, copied once into shared
//   memory (zero past m and past d) for its whole loop over the
//   centroids, with their norms (fused multiply-adds in feature order).
//   The centroids stream through a ring of TC_STAGES stages of 128
//   centroids x 16 features, hi and lo parts laid out as wgmma's B operand
//   once per call by tile_y_kernel, so a stage is one bulk copy (TMA
//   engine) completing on its "full" mbarrier; the last of the eight
//   warps to finish a stage (counted by a shared-memory atomic) refills
//   it, so no warp waits for another to refill the ring.  Each
//   warpgroup multiplies its 64 rows by a stage with wgmma.mma_async
//   m64n128k8 (A, x's hi or lo, from registers; B from shared memory),
//   while it splits the next stage's A fragments.  The distances never
//   leave registers: after a tile's last stage each thread folds its 64
//   distances, in B1's float operations and order, into a running (min,
//   argmin) for its two rows, and at the end the four lanes of a row
//   reduce with the same (value, index) rule.  Bounds: three TF32
//   products at the tensor cores' 495 TFLOP/s, 6*m*k*d flop; the float32
//   bound outside the tensor cores, 2*m*k*d flop at 67 TFLOP/s, is what a
//   plain float32 product would take.  The tensor cores beat the FMA
//   kernel at every width down to d = 1, so narrow rows take them too.
// * fused_l2nn_kernel (rows wider than TC_MAX_D, whose 128 rows of x would
//   not fit in shared memory, and bf16_dot, whose bfloat16 products are
//   exact in float32): plain float32 FMA.  One block owns a 64-row tile
//   of x and streams 64-centroid tiles of y through shared memory; each
//   thread keeps a 4x4 block of dot products in registers and folds them
//   into its rows' (min, argmin) in the same epilogue.
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
//   launches of one.  B1's tensor-core kernel would pad d = 2 to 16
//   features a stage.  Bound: issued float32
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

#include "bulk_copy.cuh"

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
// B1 on the tensor cores: 3xTF32 warpgroup products (wgmma, A from
// registers, B from shared memory), x resident, centroid tiles streamed
// through a ring of bulk copies, argmin in the epilogue
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;                  // x rows per block: 2 warpgroups
constexpr int TC_BN = 128;                  // centroids per tile (n128)
constexpr int TC_KC = 16;                   // features per stage (2 k8 steps)
constexpr int TC_PART = TC_BN * TC_KC;      // floats of a stage's hi or lo
constexpr int TC_STAGE = 2 * TC_PART;       // hi then lo: 16 KB
constexpr int TC_STAGES = 3;
constexpr int TC_THREADS = 256;
constexpr int TC_MAX_D = 256;
// the B operand of one k8 step, K-major without swizzle: core matrices of
// 8 centroids x 4 slots (128 bytes), the two K halves 128 bytes apart
// (leading byte offset), the 8-centroid groups 256 bytes apart (stride)
constexpr int TC_LBO = 128;
constexpr int TC_SBO = 256;

// x's row in shared memory: d rounded up to 32 floats (8 16-byte chunks)
__host__ __device__ constexpr int tc_row(int d) { return (d + 31) / 32 * 32; }

// dynamic shared memory of a block: the mbarriers, the ring, x's rows and
// their norms
__host__ __device__ constexpr int tc_smem_bytes(int d) {
  return 128 + 4 * TC_STAGES * TC_STAGE + 4 * TC_BM * tc_row(d) + 4 * TC_BM;
}

// 16 bytes from global to shared memory, asynchronously; the bytes past
// src_bytes (0 or 16) are zero
__device__ __forceinline__ void cp16_zfill(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

// a = hi + lo + (about 2^-22 |a|), hi and lo TF32 (round to nearest)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(a));
  const float rest = __fsub_rn(a, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// feature (within a 16-feature stage) in slot kappa (0..7) of k8 step s8
// (0 or 1): a lane's four consecutive features 4t..4t+3 fill its slots t
// and t+4 of both steps, so one 16-byte load of x feeds two steps
__host__ __device__ constexpr int tc_feature(int s8, int kappa) {
  return 4 * (kappa & 3) + 2 * s8 + (kappa >> 2);
}

// y (k, d) into yt in the ring's order: stage s = tile * nc + slice holds,
// for centroids tile*128 .. +128 and features slice*16 .. +16, the TF32
// hi parts, then the lo parts, each as 2 k8 steps of 16 x 2 core
// matrices; zero past k and past d
__global__ void tile_y_kernel(const float* __restrict__ y, int k, int d,
                              int nc, long long total,
                              float* __restrict__ yt) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= total) return;
  const int s = static_cast<int>(e / TC_STAGE);
  const int part = static_cast<int>(e % TC_STAGE) / TC_PART;
  const int p = static_cast<int>(e % TC_PART);
  const int s8 = p / 1024, q = (p % 1024) / 64, c = (p % 64) / 32;
  const int n = 8 * q + (p % 32) / 4, kappa = 4 * c + p % 4;
  const int row = (s / nc) * TC_BN + n;
  const int col = (s % nc) * TC_KC + tc_feature(s8, kappa);
  const float v =
      (row < k && col < d) ? y[static_cast<size_t>(row) * d + col] : 0.f;
  uint32_t hi, lo;
  split_tf32(v, hi, lo);
  yt[e] = __uint_as_float(part == 0 ? hi : lo);
}

__device__ __forceinline__ uint64_t tc_desc(const float* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(TC_LBO >> 4) << 16 |
         static_cast<uint64_t>(TC_SBO >> 4) << 32;
}

// d (64 x 128 per warpgroup) += a (64 x 8, registers) * b (8 x 128,
// shared memory); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// keep the compiler from moving accesses of v across a wgmma fence or
// wait, or from reusing v's register while a wgmma may still read it
__device__ __forceinline__ void pin(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& v) {
  asm volatile("" : "+r"(v)::"memory");
}

// one stage's A fragments (2 k8 steps of the warp's 16 rows), hi and lo
struct AFrag {
  uint32_t hi[2][4], lo[2][4];
};

__global__ void __launch_bounds__(TC_THREADS, 2)
fused_l2nn_tc_kernel(const float* __restrict__ x, const float* __restrict__ yt,
                     const float* __restrict__ yn, float* __restrict__ val,
                     int* __restrict__ idx, int m, int k, int d, int nc) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  // arrivals at each stage since the start: the eighth of a use refills
  unsigned* done = reinterpret_cast<unsigned*>(full + TC_STAGES);
  float* ring = reinterpret_cast<float*>(smem + 128);
  float* xs = ring + TC_STAGES * TC_STAGE;
  const int dp = tc_row(d);
  float* xns = xs + TC_BM * dp;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  // this thread's rows: ra and ra + 8 (warpgroup warp >> 2 owns 64 rows,
  // its warp warp & 3 the 16 from ra - g)
  const int ra = 64 * (warp >> 2) + 16 * (warp & 3) + g;
  const int row0 = blockIdx.x * TC_BM;
  const int n_iter = (k + TC_BN - 1) / TC_BN * nc;

  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      bar_init(&full[s]);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < TC_STAGES && s < n_iter; ++s) {
      bulk_copy(ring + s * TC_STAGE, yt + static_cast<size_t>(s) * TC_STAGE,
                TC_STAGE * 4, &full[s]);
    }
  }
  // the block's rows of x, once, zero past m and past d; 16-byte chunk c
  // of row r sits at chunk c ^ 4 (r & 1), so the two rows one phase of a
  // 16-byte load reads fall on different banks
  const int q4 = dp / 4;
  if ((d & 3) == 0) {
    for (int e = tid; e < TC_BM * q4; e += TC_THREADS) {
      const int r = e / q4, c = e % q4;
      const int gr = row0 + r;
      const bool in = gr < m && 4 * c < d;
      cp16_zfill(xs + r * dp + 4 * (c ^ ((r & 1) << 2)),
                 in ? x + static_cast<size_t>(gr) * d + 4 * c : x,
                 in ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    for (int e = tid; e < TC_BM * dp; e += TC_THREADS) {
      const int r = e / dp, col = e % dp;
      const int gr = row0 + r;
      xs[r * dp + 4 * ((col >> 2) ^ ((r & 1) << 2)) + (col & 3)] =
          (gr < m && col < d) ? x[static_cast<size_t>(gr) * d + col] : 0.f;
    }
  }
  __syncthreads();
  // squared row norms, fused multiply-adds in feature order (a function
  // of the row alone): each warp takes 16 rows, a lane one of them
  if (lane < 16) {
    const int r = warp * 16 + lane;
    const float* xr = xs + r * dp;
    const int sw = (r & 1) << 2;
    float a = 0.f;
    for (int c = 0; c < q4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(xr + 4 * (c ^ sw));
      a = fmaf(v.x, v.x, a);
      a = fmaf(v.y, v.y, a);
      a = fmaf(v.z, v.z, a);
      a = fmaf(v.w, v.w, a);
    }
    xns[r] = a;
  }
  __syncthreads();
  float xnr[2], best_v[2];
  int best_i[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    xnr[h] = xns[ra + 8 * h];
    best_v[h] = INFINITY;
    best_i[h] = INT32_MAX;
  }

  const float* xa = xs + ra * dp;
  const float* xb = xa + 8 * dp;
  const int sw = (ra & 1) << 2;
  // the A fragments of stage `it`: one 16-byte load per row and k16 half
  auto prep = [&](AFrag& f, int it) {
    const int c = ((it % nc) * 4 + t) ^ sw;
    const float4 va = *reinterpret_cast<const float4*>(xa + 4 * c);
    const float4 vb = *reinterpret_cast<const float4*>(xb + 4 * c);
    const float fa[4] = {va.x, va.y, va.z, va.w};
    const float fb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
    for (int s8 = 0; s8 < 2; ++s8) {
      split_tf32(fa[2 * s8], f.hi[s8][0], f.lo[s8][0]);      // (g, t)
      split_tf32(fb[2 * s8], f.hi[s8][1], f.lo[s8][1]);      // (g + 8, t)
      split_tf32(fa[2 * s8 + 1], f.hi[s8][2], f.lo[s8][2]);  // (g, t + 4)
      split_tf32(fb[2 * s8 + 1], f.hi[s8][3], f.lo[s8][3]);  // (g + 8, t + 4)
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // stage `it` on the tensor cores with f, while the next stage's
  // fragments are formed into nf
  auto step = [&](int it, AFrag& f, AFrag& nf) {
    const int s = it % TC_STAGES;
    const int slice = it % nc;
    bar_wait(&full[s], (it / TC_STAGES) & 1);
    const float* bh = ring + s * TC_STAGE;
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(acc[i]);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int s8 = 0; s8 < 2; ++s8) {
      const uint64_t dh = tc_desc(bh + s8 * 1024);
      const uint64_t dl = tc_desc(bh + TC_PART + s8 * 1024);
      // small terms first; a tile's first product overwrites the sums
      wgmma_tf32(acc, f.lo[s8], dh, slice > 0 || s8 > 0);
      wgmma_tf32(acc, f.hi[s8], dl, 1);
      wgmma_tf32(acc, f.hi[s8], dh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (it + 1 < n_iter) prep(nf, it + 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int i = 0; i < 64; ++i) pin(acc[i]);
#pragma unroll
    for (int s8 = 0; s8 < 2; ++s8)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pin(f.hi[s8][j]);
        pin(f.lo[s8][j]);
      }
    // this warp's products of the stage are done (wait_group): the last
    // warp to say so refills the stage
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      const unsigned before = atomicAdd(&done[s], 1u);
      if (before % (TC_THREADS / 32) == TC_THREADS / 32 - 1 &&
          it + TC_STAGES < n_iter) {
        __threadfence_block();
        bulk_copy(ring + s * TC_STAGE,
                  yt + static_cast<size_t>(it + TC_STAGES) * TC_STAGE,
                  TC_STAGE * 4, &full[s]);
      }
    }
    __syncwarp();
    if (slice == nc - 1) {
      // epilogue: acc[4j + 2h + e] is row ra + 8h, column c0 + 8j + e
      const int c0 = (it / nc) * TC_BN + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + e;
          if (col < k) {
            const float ync = yn[col];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v = __fsub_rn(__fadd_rn(xnr[h], ync),
                                  __fmul_rn(2.f, acc[4 * j + 2 * h + e]));
              v = v < 0.f ? 0.f : v;  // expanded-form rounding dips below 0
              if (better(v, col, best_v[h], best_i[h])) {
                best_v[h] = v;
                best_i[h] = col;
              }
            }
          }
        }
    }
  };
  AFrag f0, f1;
  prep(f0, 0);
  for (int it = 0; it < n_iter; it += 2) {
    step(it, f0, f1);
    if (it + 1 < n_iter) step(it + 1, f1, f0);
  }

  // the four lanes of a row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float bv = best_v[h];
    int bi = best_i[h];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const int r = row0 + ra + 8 * h;
    if (t == 0 && r < m) {
      val[r] = bv;
      idx[r] = bi == INT32_MAX ? 0 : bi;
    }
  }
}

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

// floats of the tiled copy of y the tensor-core kernel streams (k, d)
extern "C" long long raft_fused_l2nn_scratch(int k, int d) {
  const long long nc = (d + TC_KC - 1) / TC_KC;
  return (k + TC_BN - 1) / TC_BN * nc * TC_STAGE;
}

// B1: val, idx (m,) of x (m, d) against y (k, d), yn y's squared row
// norms.  Float32 products at 1 <= d <= TC_MAX_D take the 3xTF32 kernel
// (yt: raft_fused_l2nn_scratch(k, d) floats, and x, 16-byte aligned; x's
// norms formed in the kernel), everything else the float32 FMA kernel
// (xn: x's squared row norms; bf16_dot: bfloat16-rounded operands).
// tensor_cores states which of the two the caller prepared for; it picks
// nothing, and a call whose flag disagrees with the rule fails.
extern "C" int raft_fused_l2nn(const float* x, const float* xn,
                               const float* y, const float* yn, float* val,
                               int* idx, int m, int k, int d, int bf16_dot,
                               int tensor_cores, float* yt, void* stream) {
  const bool tc = !bf16_dot && d >= 1 && d <= TC_MAX_D;
  if (static_cast<bool>(tensor_cores) != tc || k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    const int nc = (d + TC_KC - 1) / TC_KC;
    const long long total = raft_fused_l2nn_scratch(k, d);
    tile_y_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
        y, k, d, nc, total, yt);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int smem = tc_smem_bytes(d);
    err = cudaFuncSetAttribute(fused_l2nn_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    fused_l2nn_tc_kernel<<<(m + TC_BM - 1) / TC_BM, TC_THREADS, smem, s>>>(
        x, yt, yn, val, idx, m, k, d, nc);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((m + BM - 1) / BM);
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
