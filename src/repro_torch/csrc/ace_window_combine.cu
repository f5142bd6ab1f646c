// Windowed ACE scoring: the E-way weighted combine of an epoch ring,
//   score_b = (1/L) * sum_e w_e * sum_j C_e[j, b_j]
// or, with table weights, sum_e w_e * sum_j tw_j * C_e[j, b_j].  Replaces
// the Pallas kernel of src/repro/kernels/ace_window_combine.py
// (ace_window_combine, both its "flat" and "unroll" lowerings).
//
// Bound on the H100: memory — the (B, L) ids, the (B,) scores and one read
// of each counter the batch touches in each of the E epochs; there is no
// arithmetic to speak of (E*L adds a row).
//
// Design: two kernels on one stream, as ace_score_fused.cu.
//   Phase 1 (window_gather): one thread per (b, e, j) reads
//     C[(e*L + j) * 2^K + b_j] into a (B, E, L) fp32 scratch; neighbouring
//     threads take neighbouring tables of one row, so the id reads and
//     scratch writes coalesce and only the counter reads scatter.
//   Phase 2 (window_combine): one thread per row sums each epoch's L
//     gathers in table order (weighted with __fmul_rn when table weights
//     are given), multiplies by w_e and accumulates over e in ring-index
//     order with __fadd_rn, then multiplies by float32(1/L) unless
//     weighted: the reference's canonical order (window/ring.py
//     score_from_sums), reproduced op for op by the plain version.
// The TPU kernel's choice between one flat take and a per-epoch unroll
// (choose_mode, FLAT_MAX_COLS) is a lowering choice calibrated on the TPU
// and is not carried over.  Offsets are 64-bit: E*L*2^K may pass 2^31.
// Ids outside [0, 2^K) are clamped, as in ace_query.cu.

#include "common.cuh"

namespace {

__global__ void window_gather(const int* __restrict__ counts,
                              const int* __restrict__ buckets,
                              float* __restrict__ gathered, int B, int E,
                              int L, long long nbuckets) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  const long long EL = static_cast<long long>(E) * L;
  if (i >= static_cast<long long>(B) * EL) return;
  const long long row = i / EL;
  const long long ej = i % EL;           // e * L + j
  const int j = static_cast<int>(ej % L);
  const int b = min(max(buckets[row * L + j], 0),
                    static_cast<int>(nbuckets - 1));
  gathered[i] = static_cast<float>(counts[ej * nbuckets + b]);
}

__global__ void window_combine(const float* __restrict__ gathered,
                               const float* __restrict__ w,
                               const float* __restrict__ tw,
                               float* __restrict__ scores, int B, int E,
                               int L, float inv_l) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const float* g = gathered + static_cast<long long>(row) * E * L;
  float acc = 0.0f;
  for (int e = 0; e < E; ++e, g += L) {
    float s;
    if (tw == nullptr) {
      s = repro::table_order_sum(g, L);
    } else {
      s = 0.0f;
#pragma unroll 10
      for (int j = 0; j < L; ++j) s = __fadd_rn(s, __fmul_rn(g[j], tw[j]));
    }
    acc = __fadd_rn(acc, __fmul_rn(w[e], s));
  }
  scores[row] = tw == nullptr ? __fmul_rn(acc, inv_l) : acc;
}

}  // namespace

// counts (E, L, nbuckets) int32; buckets (B, L) int32; w (E,) fp32 epoch
// weights; tw (L,) fp32 table weights or null; scores (B,) fp32;
// gathered (B, E, L) fp32 is scratch.  nbuckets is 64-bit (2^31 at
// K = 31).  Needs B >= 1.
REPRO_API int repro_ace_window_combine(const int* counts, const int* buckets,
                                       const float* w, const float* tw,
                                       float* gathered, float* scores, int B,
                                       int E, int L, long long nbuckets,
                                       float inv_l, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kThreads = 256;
  const long long n = static_cast<long long>(B) * E * L;
  window_gather<<<static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                  kThreads, 0, s>>>(counts, buckets, gathered, B, E, L,
                                    nbuckets);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_combine<<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      gathered, w, tw, scores, B, E, L, inv_l);
  return static_cast<int>(cudaGetLastError());
}
