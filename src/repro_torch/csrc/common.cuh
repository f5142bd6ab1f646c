// Shared by every kernel source: the C export macro and the error-string
// entry point that the Python binding (kernels/build.py) reads.
#pragma once

#include <cuda_runtime.h>

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

}  // namespace repro
