// SRHT meta-hash: pad d -> d_pad = 2^ceil(log2 max(d, 2)), * D1, FWHT,
// * D2, FWHT, sample m = K*L rows, sign, K-bit big-endian pack -> (B, L)
// int32 bucket ids.  Replaces the Pallas kernel of
// src/repro/kernels/srht_hash.py (srht_hash).
//
// Bound on the H100: the FWHT's adds (2 * d_pad * log2(d_pad) a row, at
// 33.5 T adds/s: fp32 at 67 TFLOP/s counts an FMA as two) against the
// bytes of x and the ids; no W is read.  Design: a block owns R whole
// rows (R * d_pad >= 1024 floats, one row from d_pad = 1024 up) in
// shared memory, dynamic above 48 KB (d_pad up to 32768 = 128 KB).  Its
// 512 threads load x with the first sign flip, run the log2(d_pad)
// butterfly stages of one FWHT with a barrier between stages, flip the
// second signs, run the second FWHT, and then one thread per (row, table)
// reads its K sampled rows and packs their signs with integer shifts.
//
// Bitwise agreement with the reference (repro.core.srht.srht_bits): the
// stages run h = 1, 2, 4, ... and write v[i] <- a + b, v[i + h] <- a - b
// as the reference's reshape-and-concatenate does; the sign flips are
// exact multiplies by +-1 (__fmul_rn, so nothing is contracted into an
// FMA); the adds are __fadd_rn/__fsub_rn.  The sign test is v >= 0, so
// the -0.0 of a padded lane (0 * -1) is bit 1 like +0.0 and NaN is bit 0,
// as in repro.core.srp.srp_bits; signbit is never used.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMinElems = 1024;   // floats of shared memory a block fills

__device__ __forceinline__ void fwht_block(float* v, int n_elems,
                                           int log2_pad) {
  const int half = n_elems >> 1;
  for (int s = 0; s < log2_pad; ++s) {
    const int h = 1 << s;
    // pair p of the stage: its 2h-block (p >> s), its offset (p & (h-1));
    // blocks of 2h never straddle a row because d_pad is a multiple of 2h
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int i = ((p >> s) << (s + 1)) | (p & (h - 1));
      const float a = v[i], b = v[i + h];
      v[i] = __fadd_rn(a, b);
      v[i + h] = __fsub_rn(a, b);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
srht_hash_kernel(const float* __restrict__ x, const float* __restrict__ s1,
                 const float* __restrict__ s2, const int* __restrict__ rows,
                 int* __restrict__ out, int B, int d, int log2_pad, int R,
                 int K, int L) {
  extern __shared__ float v[];   // R rows of d_pad floats
  const int d_pad = 1 << log2_pad;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const int n_elems = nrows << log2_pad;

  for (int i = threadIdx.x; i < n_elems; i += blockDim.x) {
    const int r = i >> log2_pad, c = i & (d_pad - 1);
    const float xv =
        c < d ? x[static_cast<long long>(row0 + r) * d + c] : 0.0f;
    v[i] = __fmul_rn(xv, s1[c]);
  }
  __syncthreads();
  fwht_block(v, n_elems, log2_pad);
  for (int i = threadIdx.x; i < n_elems; i += blockDim.x)
    v[i] = __fmul_rn(v[i], s2[i & (d_pad - 1)]);
  __syncthreads();
  fwht_block(v, n_elems, log2_pad);

  for (int i = threadIdx.x; i < nrows * L; i += blockDim.x) {
    const int r = i / L, j = i % L;
    const float* vr = v + (r << log2_pad);
    const int* rj = rows + j * K;
    unsigned int bucket = 0;
    for (int k = 0; k < K; ++k)
      bucket = (bucket << 1) | (vr[__ldg(rj + k)] >= 0.0f ? 1u : 0u);
    out[static_cast<long long>(row0 + r) * L + j] =
        static_cast<int>(bucket);
  }
}

}  // namespace

// x (B, d) fp32; s1, s2 (d_pad,) fp32 of +-1; rows (K*L,) int32 in
// [0, d_pad); out (B, L) int32.  d_pad = 2^log2_pad; needs B >= 1,
// 1 <= K <= 31 and log2_pad <= 15 (the wrapper checks all three).
REPRO_API int repro_srht_hash(const float* x, const float* s1,
                              const float* s2, const int* rows, int* out,
                              int B, int d, int log2_pad, int K, int L,
                              void* stream) {
  if (log2_pad < 1 || log2_pad > 15) return cudaErrorInvalidValue;
  const int d_pad = 1 << log2_pad;
  const int R = d_pad >= kMinElems ? 1 : kMinElems / d_pad;
  const size_t smem = static_cast<size_t>(R) * d_pad * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        srht_hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  srht_hash_kernel<<<(B + R - 1) / R, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, s1, s2, rows, out, B, d, log2_pad, R, K, L);
  return static_cast<int>(cudaGetLastError());
}
