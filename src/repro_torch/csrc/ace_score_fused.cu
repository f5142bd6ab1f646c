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
// Counters are int32, int16, int8 or float32 (common.cuh's count trait):
// the scratch holds each counter's value (int32, narrow ones
// sign-extended; fp32 for float counters) and the row sum is exact in
// int64 (fp64 for float counters, exact for integer values below 2^53).
// The TPU kernel's pack matmul and its (bm, 128) padded output tile are
// not carried over.  Offsets are 64-bit.

#include "srp_gemm.cuh"

namespace {

constexpr int kRowsPerBlock = 8;           // score_warp_rows: a warp a row
constexpr int kRowThreads = 256;           // score_weighted_rows

template <typename Cnt, bool kNarrow>
__global__ void __launch_bounds__(repro::gemm::kThreads,
                                  repro::gemm::min_blocks(kNarrow))
score_hash_gather(const Cnt* __restrict__ counts, repro::gemm::Operands op,
                  typename repro::CountTraits<Cnt>::Value* __restrict__
                      gathered,
                  int* __restrict__ buckets, int B, int d, int P, int K,
                  int L, repro::gemm::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long nbuckets = 1LL << K;     // 2^31 does not fit an int
  repro::gemm::srp_gemm_tile<kNarrow>(
      op, B, d, P, K, L, plan, smem, [&](int row, int j, int bucket) {
        const long long o = static_cast<long long>(row) * L + j;
        if (buckets != nullptr) buckets[o] = bucket;
        gathered[o] = repro::load_count(counts + j * nbuckets + bucket);
      });
}

template <typename V>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
score_warp_rows(const V* __restrict__ gathered, float* __restrict__ scores,
                int B, int L) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (b < B) repro::warp_row_mean(gathered, scores, b, L);
}

template <typename V>
__global__ void score_weighted_rows(const V* __restrict__ gathered,
                                    const float* __restrict__ tw,
                                    float* __restrict__ scores, int B,
                                    int L) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const V* g = gathered + static_cast<long long>(row) * L;
  float s = 0.0f;
#pragma unroll 10
  for (int j = 0; j < L; ++j)
    s = __fadd_rn(s, __fmul_rn(static_cast<float>(g[j]), tw[j]));
  scores[row] = s;
}

}  // namespace

// counts (L, 2^K) of the type `count_type` (repro::CountCode); q (B, d), w
// (d, P) of the types x_type, w_type (fp32, bf16 or fp16), w 16-byte
// aligned; tw (L,) fp32 or null; gathered (B, L) scratch, int32 (fp32 for
// float counters); scores (B,) fp32; buckets (B, L) int32 or null (the ids,
// for the tests).  The hash's plan as in repro_srp_hash.  Needs 1 <= K <= 31,
// B >= 1, L <= 65535; a plan that does not fit returns
// cudaErrorInvalidValue.
REPRO_API int repro_ace_score_fused(
    const void* counts, const void* q, const void* w, const float* tw,
    void* gathered, int* buckets, float* scores, int B, int d, int P, int K,
    int L, int rows, int row_tiles, int tables, int groups, int splits,
    int b0, int b1, int b2, int b3, int b4, int b5, int b6, int b7, int b8,
    int count_type, int x_type, int w_type, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bounds[] = {b0, b1, b2, b3, b4, b5, b6, b7, b8};
  const repro::gemm::Operands op{q, w, x_type, w_type};
  const repro::gemm::Plan plan = repro::gemm::make_plan(
      rows, row_tiles, tables, groups, splits, bounds);
  if (!repro::gemm::plan_fits(plan, op, B, d, K, L))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (!repro::with_count_type(count_type, [&](auto tag) {
        using T = decltype(tag);
        using V = typename repro::CountTraits<T>::Value;
        V* g = static_cast<V*>(gathered);
        err = repro::gemm::launch(
            op, score_hash_gather<T, false>, score_hash_gather<T, true>,
            plan, s, static_cast<const T*>(counts), op, g, buckets, B, d,
            P, K, L, plan);
        if (err != cudaSuccess) return;
        if (tw != nullptr) {
          score_weighted_rows<V><<<(B + kRowThreads - 1) / kRowThreads,
                                   kRowThreads, 0, s>>>(g, tw, scores, B, L);
        } else {
          score_warp_rows<V><<<(B + kRowsPerBlock - 1) / kRowsPerBlock,
                               kRowsPerBlock * 32, 0, s>>>(g, scores, B, L);
        }
        err = cudaGetLastError();
      }))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
