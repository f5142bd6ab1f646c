// Shared by every kernel source: the C export macro and the error-string
// entry point that the Python binding (kernels/build.py) reads.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <utility>

#define REPRO_API extern "C" __attribute__((visibility("default")))

REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace repro {

// Sum of a row's L gathered values in table order j = 0..L-1, with
// __fadd_rn so that nvcc contracts nothing and a plain loop of adds in
// the same order gives the same bits (above 2^24 too).
__device__ __forceinline__ float table_order_sum(const float* g, int L) {
  float s = 0.0f;
#pragma unroll 10
  for (int j = 0; j < L; ++j) s = __fadd_rn(s, g[j]);
  return s;
}

// Exact sum over a full warp of one int64 a lane with |value| < 2^42 (up
// to 2048 int32 counters a lane, so rows of L <= 65535): the low 20 bits
// (< 2^25 over 32 lanes) and the rest (< 2^27) are reduced apart with
// redux.sync.
__device__ __forceinline__ long long warp_sum(long long v) {
  const unsigned lo =
      __reduce_add_sync(0xffffffffu, static_cast<unsigned>(v & 0xFFFFF));
  const int hi = __reduce_add_sync(0xffffffffu, static_cast<int>(v >> 20));
  return static_cast<long long>(hi) * (1LL << 20) + lo;
}

// Let `kernel` take `bytes` of dynamic shared memory a block on the
// current device (bytes < 0: the card's opt-in maximum).  Set once per
// kernel and device, each kernel always with the same bytes: the launches
// sit on host-bound paths.
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev})) return cudaSuccess;
  if (bytes < 0) {
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.insert({kernel, dev});
  return err;
}

}  // namespace repro
