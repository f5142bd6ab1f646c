// Signed count-sketch point estimates: out[b] = median_r(signs[b, r] *
// plane[r, cols[b, r]]) over the R rows of one attribution level; odd R
// takes the middle order statistic, even R the midpoint 0.5f * (a + b) of
// the two middles.  Replaces the Pallas kernel of
// src/repro/kernels/attr_estimate.py (attr_estimate).
//
// Bound on the H100: launch latency in practice; by bytes, the (B, R) ids
// and signs in, the (B,) estimates out and one read of each plane cell
// touched (the (R, C) plane, 5 KB at R = 5, C = 256, stays in L2).  Design:
// one thread per query b; neighbouring threads read neighbouring ids and
// write neighbouring outputs.  The TPU kernel sorts the R values in
// registers over a static R; here R up to kMaxRegR is a template argument,
// so the values live in registers and a compare-exchange network (fully
// unrolled) sorts them; any larger R takes an exact O(R^2) rank selection
// that keeps no array at all and gathers each value again from L1/L2, so
// no R is refused.
//
// Semantics held bitwise against the plain version (and the reference's
// _median_lastaxis): NaN sorts above every number, as torch.sort and
// jnp.sort put it; the midpoint is __fmul_rn(0.5f, __fadd_rn(a, b)) so
// nvcc contracts nothing.  The median is a value, so ties need no order
// (+0 and -0 compare equal, and either may be returned).  Columns outside
// [0, C) are clamped, as ace_query clamps ids.

#include "common.cuh"

namespace {

constexpr int kMaxRegR = 8;

// a < b in the order of torch.sort: numbers ascending, NaN last.
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (a == a && b != b);
}

__device__ __forceinline__ bool same(float a, float b) {
  return a == b || (a != a && b != b);
}

__device__ __forceinline__ float signed_cell(const float* __restrict__ plane,
                                             const int* __restrict__ cols,
                                             const float* __restrict__ signs,
                                             long long b, int r, int R,
                                             int C) {
  const long long i = b * R + r;
  const int c = min(max(cols[i], 0), C - 1);
  return __fmul_rn(signs[i], plane[static_cast<long long>(r) * C + c]);
}

__device__ __forceinline__ float midpoint(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

template <int R>
__global__ void attr_estimate_reg(const float* __restrict__ plane,
                                  const int* __restrict__ cols,
                                  const float* __restrict__ signs,
                                  float* __restrict__ out, int B, int C) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (b >= B) return;
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = signed_cell(plane, cols, signs, b, r, R,
                                                 C);
  // odd-even transposition sort: R rounds of compare-exchange, every index
  // static after unrolling, so v stays in registers
#pragma unroll
  for (int round = 0; round < R; ++round) {
#pragma unroll
    for (int j = round & 1; j + 1 < R; j += 2) {
      if (before(v[j + 1], v[j])) {
        const float t = v[j];
        v[j] = v[j + 1];
        v[j + 1] = t;
      }
    }
  }
  if constexpr (R & 1) {
    out[b] = v[R / 2];
  } else {
    out[b] = midpoint(v[R / 2 - 1], v[R / 2]);
  }
}

// Any R: the k-th order statistic (0-based) is the value v_i with
// #{j: v_j before v_i} <= k < that count plus #{j: v_j same as v_i}.
__global__ void attr_estimate_rank(const float* __restrict__ plane,
                                   const int* __restrict__ cols,
                                   const float* __restrict__ signs,
                                   float* __restrict__ out, int B, int R,
                                   int C) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (b >= B) return;
  const int hi = R / 2, lo = (R & 1) ? hi : hi - 1;
  float v_lo = 0.0f, v_hi = 0.0f;
  for (int i = 0; i < R; ++i) {
    const float vi = signed_cell(plane, cols, signs, b, i, R, C);
    int less = 0, eq = 0;
    for (int j = 0; j < R; ++j) {
      const float vj = signed_cell(plane, cols, signs, b, j, R, C);
      less += before(vj, vi);
      eq += same(vj, vi);
    }
    if (less <= lo && lo < less + eq) v_lo = vi;
    if (less <= hi && hi < less + eq) v_hi = vi;
  }
  out[b] = (R & 1) ? v_hi : midpoint(v_lo, v_hi);
}

}  // namespace

// plane (R, C) fp32; cols (B, R) int32; signs (B, R) fp32 (±1); out (B,)
// fp32.  B >= 1, R >= 1, C >= 1.
REPRO_API int repro_attr_estimate(const float* plane, const int* cols,
                                  const float* signs, float* out, int B,
                                  int R, int C, void* stream) {
  constexpr int kThreads = 256;
  const unsigned int blocks = static_cast<unsigned int>(
      (static_cast<long long>(B) + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
#define REPRO_ATTR_REG(N)                                                  \
  case N:                                                                  \
    attr_estimate_reg<N><<<blocks, kThreads, 0, s>>>(plane, cols, signs,   \
                                                     out, B, C);           \
    break;
    REPRO_ATTR_REG(1)
    REPRO_ATTR_REG(2)
    REPRO_ATTR_REG(3)
    REPRO_ATTR_REG(4)
    REPRO_ATTR_REG(5)
    REPRO_ATTR_REG(6)
    REPRO_ATTR_REG(7)
    REPRO_ATTR_REG(8)
#undef REPRO_ATTR_REG
    default:
      attr_estimate_rank<<<blocks, kThreads, 0, s>>>(plane, cols, signs, out,
                                                     B, R, C);
  }
  static_assert(kMaxRegR == 8, "one case per register-sorted R");
  return static_cast<int>(cudaGetLastError());
}
