// The compile probe (kernel B6) for Hopper (sm_90a).
//
// Replaces bench/tpu_session.py:357 add_one, the trivial Pallas kernel of
// pallas_probe_stage (:343), launched by its pl.pallas_call at :361.  That
// stage asked whether the toolchain could compile and run a kernel at all
// before the real fused L2 NN kernel was tried; this file plays the same
// part for nvcc: it is built first and alone, so a broken toolchain fails
// within seconds with nvcc's whole output instead of after the other
// sources' builds.
//
// out[i] = x[i] + 1 over n contiguous float32 values, one element per
// thread, 256 threads a block.  The add is exact IEEE float32 addition, so
// the result equals PyTorch's x + 1 bit for bit.
//
// Bound: it reads n * 4 bytes and writes n * 4 bytes (at the probe's
// 128 x 128: 2 x 65,536 B, 0.04 us at 3.35 TB/s); at that size the launch,
// a few microseconds, is all the time it takes.  raft_add_one returns
// cudaGetLastError() right after the launch.

#include <cuda_runtime.h>

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

extern "C" int raft_add_one(const float* x, float* out, long long n,
                            cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  add_one_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      x, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
