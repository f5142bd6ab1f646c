// Shared by every kernel source: the C export macro and the error-string
// entry point that the Python binding (kernels/build.py) reads.
#pragma once

#include <cuda_runtime.h>

#define REPRO_API extern "C" __attribute__((visibility("default")))

REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
