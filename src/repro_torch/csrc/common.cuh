// Shared by every kernel source: the C export macro, the error-string
// entry point that the Python binding (kernels/build.py) reads, the
// count-type trait of the kernels that read or add counters, and the
// operand types of the hash kernels.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include <mutex>
#include <set>
#include <utility>

#define REPRO_API extern "C" __attribute__((visibility("default")))

REPRO_API const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace repro {

// ---------------------------------------------------------------------------
// Count planes of four types: int32, and the reference's int16, int8 and
// float32 (repro.core.sketch COUNT dtypes).  Every entry point that reads
// or adds counters takes the plane as void* and the type's code (the
// order of kernels/build.py COUNT_DTYPES) and instantiates its kernels
// for the type through with_count_type.
// ---------------------------------------------------------------------------
enum CountCode : int { kInt32 = 0, kInt16 = 1, kInt8 = 2, kFloat32 = 3 };

// What a counter reads as (Value: a narrow counter sign-extended to int,
// a float as it is) and what a row of them sums in exactly (Sum: int64,
// or fp64, exact for integer-valued float counters below 2^53).
template <typename T>
struct CountTraits {
  using Value = int;
  using Sum = long long;
};
template <>
struct CountTraits<float> {
  using Value = float;
  using Sum = double;
};

template <typename T>
__device__ __forceinline__ typename CountTraits<T>::Value load_count(
    const T* p) {
  return static_cast<typename CountTraits<T>::Value>(*p);
}

// counter += n, atomically, wrapping in the counter's own type as the
// reference's narrow scatter-add does (int8 127 + 1 -> -128).  The card
// has no 8- or 16-bit atomicAdd: a narrow add is a 32-bit atomicCAS loop
// on the aligned word that holds the counter, shifting by its byte offset
// in the word (the plane must start 4-byte aligned; the wrappers check
// it), so an int8 add retries when any of the word's four counters
// changed under it.  Sums of modular adds do not depend on their order,
// so every count is exact.  Float counters take the float atomicAdd,
// exact while a counter stays below 2^24.
__device__ __forceinline__ void add_count(int* p, int n) { atomicAdd(p, n); }
__device__ __forceinline__ void add_count(float* p, int n) {
  atomicAdd(p, static_cast<float>(n));
}
template <typename N>
__device__ __forceinline__ void add_narrow(N* p, int n) {
  constexpr unsigned int kMask = (1u << (8 * sizeof(N))) - 1u;
  const std::size_t a = reinterpret_cast<std::size_t>(p);
  unsigned int* word = reinterpret_cast<unsigned int*>(a & ~std::size_t{3});
  const unsigned int shift = static_cast<unsigned int>(a & 3) * 8;
  unsigned int old = *word, assumed;
  do {
    assumed = old;
    const unsigned int v =
        ((assumed >> shift) + static_cast<unsigned int>(n)) & kMask;
    old = atomicCAS(word, assumed,
                    (assumed & ~(kMask << shift)) | (v << shift));
  } while (old != assumed);
}
__device__ __forceinline__ void add_count(int16_t* p, int n) {
  add_narrow(p, n);
}
__device__ __forceinline__ void add_count(int8_t* p, int n) {
  add_narrow(p, n);
}

// Call f(T{}) with T the counter type of `code`; false for an unknown
// code.
template <typename F>
inline bool with_count_type(int code, F&& f) {
  switch (code) {
    case kInt32: f(int{}); return true;
    case kInt16: f(int16_t{}); return true;
    case kInt8: f(int8_t{}); return true;
    case kFloat32: f(float{}); return true;
    default: return false;
  }
}

// ---------------------------------------------------------------------------
// Hash operands (x and W) of three types: float32, and the reference's
// bfloat16 and float16 (repro.core.srp.make_projections(dtype=)).  The
// hash kernels take each operand as void* and the type's code (the order
// of core/srp.py OPERAND_DTYPES) and widen every element to float32
// as they load it, as the Pallas kernels' astype(float32) does, so the
// products are float32 products of the widened values.
// ---------------------------------------------------------------------------
enum OperandCode : int { kOpFloat32 = 0, kOpBFloat16 = 1, kOpFloat16 = 2 };

inline bool operand_code_ok(int code) {
  return code == kOpFloat32 || code == kOpBFloat16 || code == kOpFloat16;
}

// A 2-byte element as float32, exactly: bfloat16 is the top half of a
// float32's bits; float16 goes through the conversion intrinsic.
__device__ __forceinline__ float widen16(unsigned short bits, int code) {
  return code == kOpBFloat16
             ? __uint_as_float(static_cast<unsigned int>(bits) << 16)
             : __half2float(__ushort_as_half(bits));
}

// Element i of an operand of type `code`, as float32.
__device__ __forceinline__ float load_operand(const void* p, long long i,
                                              int code) {
  if (code == kOpFloat32) return static_cast<const float*>(p)[i];
  return widen16(static_cast<const unsigned short*>(p)[i], code);
}

__device__ __forceinline__ float sum_to_float(long long s) {
  return __ll2float_rn(s);
}
__device__ __forceinline__ float sum_to_float(double s) {
  return __double2float_rn(s);
}

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

// The fp64 sum over a full warp (float counters): a butterfly of
// shuffles, exact while the values are integers below 2^53.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The mean of row b of a (B, L) scratch of counter values (int32, or
// float for float counters), by the warp that holds the row (every lane
// calls it, lane 0 writes): the exact sum (int64, or fp64), one
// conversion to fp32, then times __frcp_rn(L) = float32(1/L), the
// convention of ace_query_sum.
template <typename V>
__device__ __forceinline__ void warp_row_mean(const V* __restrict__ gathered,
                                              float* __restrict__ scores,
                                              long long b, int L) {
  using Sum = typename CountTraits<V>::Sum;
  const int lane = threadIdx.x % 32;
  const V* g = gathered + b * L;
  Sum part = 0;
  for (int j = lane; j < L; j += 32) part += g[j];
  const Sum s = warp_sum(part);
  if (lane == 0)
    scores[b] = __fmul_rn(sum_to_float(s),
                          __frcp_rn(static_cast<float>(L)));
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
