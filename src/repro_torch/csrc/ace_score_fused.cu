// Fused ACE scoring: dense SRP hash -> one row-offset gather at
// j * 2^K + b_j -> the row's exact integer sum times float32(1/L), or the
// weighted combine sum_j tw_j * g_j in table order.  Replaces the Pallas
// kernel of src/repro/kernels/ace_score_fused.py (ace_score_fused).
//
// Bound on the H100: fp32 operations of the hash (2*B*d*K*L FLOP; at
// B = 16,384, d = 36 that is 0.88 GFLOP, 13 us at 67 TFLOP/s, against
// 2.5 MB of q and 6.6 MB of counts at most).
//
// Design: two kernels on one stream, as ace_admit_fused.cu.
//   Phase 1 (score_hash_gather): the srp_gemm.cuh hash, as in srp_hash.cu
//     (64-row x table-group tiles, the depth split across a thread-block
//     cluster by the launch plan of kernels/srp_hash.py, so its ids are
//     srp_hash's bits under the same plan), whose epilogue gathers each
//     table's counter counts[j * 2^K + bucket] into a (B, L) int32 scratch
//     (and writes the id when asked, for the tests).
//   Phase 2 (score_warp_rows), the row sum: ace_query_sum's design, a
//     warp a row, lanes over tables, the exact int64 sum of two redux.sync
//     adds, then ace_query_sum's convention: one conversion to fp32, then
//     times __frcp_rn(L) = float32(1/L).  While a row's sum is below 2^24
//     this is the bits of a float sum in any order.
//   The weighted form (table_weights, the degraded path) keeps the (B, L)
//   scratch and one thread a row (score_weighted_rows), which adds
//   __fmul_rn(g_j, tw_j) in table order j = 0..L-1 with __fadd_rn, so nvcc
//   contracts nothing into an FMA and the plain version's
//   multiply-then-add loop gives the same bits.
// The TPU kernel's pack matmul and its (bm, 128) padded output tile are
// not carried over.  Offsets are 64-bit.

#include "srp_gemm.cuh"

namespace {

constexpr int kRowsPerBlock = 8;           // score_warp_rows: a warp a row
constexpr int kRowThreads = 256;           // score_weighted_rows

__global__ void __launch_bounds__(repro::gemm::kThreads,
                                  repro::gemm::kMinBlocks)
score_hash_gather(const int* __restrict__ counts, const float* __restrict__ q,
                  const float* __restrict__ w, int* __restrict__ gathered,
                  int* __restrict__ buckets, int B, int d, int P, int K,
                  int L, repro::gemm::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long nbuckets = 1LL << K;     // 2^31 does not fit an int
  repro::gemm::srp_gemm_tile(
      q, w, B, d, P, K, L, plan, smem, [&](int row, int j, int bucket) {
        const long long o = static_cast<long long>(row) * L + j;
        if (buckets != nullptr) buckets[o] = bucket;
        gathered[o] = counts[j * nbuckets + bucket];
      });
}

__device__ __forceinline__ float mean_of(long long s, int L) {
  return __fmul_rn(__ll2float_rn(s), __frcp_rn(static_cast<float>(L)));
}

__global__ void __launch_bounds__(kRowsPerBlock * 32)
score_warp_rows(const int* __restrict__ gathered, float* __restrict__ scores,
                int B, int L) {
  const int lane = threadIdx.x % 32;
  const long long b =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (b >= B) return;                      // the whole warp leaves
  const int* g = gathered + b * L;
  long long part = 0;
  for (int j = lane; j < L; j += 32) part += g[j];
  const long long s = repro::warp_sum(part);
  if (lane == 0) scores[b] = mean_of(s, L);
}

__global__ void score_weighted_rows(const int* __restrict__ gathered,
                                    const float* __restrict__ tw,
                                    float* __restrict__ scores, int B,
                                    int L) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const int* g = gathered + static_cast<long long>(row) * L;
  float s = 0.0f;
#pragma unroll 10
  for (int j = 0; j < L; ++j)
    s = __fadd_rn(s, __fmul_rn(static_cast<float>(g[j]), tw[j]));
  scores[row] = s;
}

}  // namespace

// counts (L, 2^K) int32; q (B, d), w (d, P) fp32, w 16-byte aligned; tw
// (L,) fp32 or null; gathered (B, L) int32 scratch; scores (B,) fp32;
// buckets (B, L) int32 or null (the ids, for the tests).  The hash's plan
// as in repro_srp_hash.  Needs 1 <= K <= 31, B >= 1, L <= 65535; a plan
// that does not fit returns cudaErrorInvalidValue.
REPRO_API int repro_ace_score_fused(
    const int* counts, const float* q, const float* w, const float* tw,
    int* gathered, int* buckets, float* scores, int B, int d, int P, int K,
    int L, int rows, int row_tiles, int tables, int groups, int splits,
    int b0, int b1, int b2, int b3, int b4, int b5, int b6, int b7, int b8,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bounds[] = {b0, b1, b2, b3, b4, b5, b6, b7, b8};
  const repro::gemm::Plan plan = repro::gemm::make_plan(
      rows, row_tiles, tables, groups, splits, bounds);
  if (!repro::gemm::plan_fits(plan, w, B, d, K, L))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = repro::gemm::launch(
      score_hash_gather, plan, s, counts, q, w, gathered, buckets, B, d, P,
      K, L, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tw != nullptr) {
    score_weighted_rows<<<(B + kRowThreads - 1) / kRowThreads, kRowThreads,
                          0, s>>>(gathered, tw, scores, B, L);
  } else {
    score_warp_rows<<<(B + kRowsPerBlock - 1) / kRowsPerBlock,
                      kRowsPerBlock * 32, 0, s>>>(gathered, scores, B, L);
  }
  return static_cast<int>(cudaGetLastError());
}
