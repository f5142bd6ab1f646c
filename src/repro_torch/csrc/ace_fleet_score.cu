// Fused multi-tenant ACE scoring: dense SRP hash -> one gather per table
// at row tenant_ids[b] * L + j of the (T * L, 2^K) fleet -> the row's
// exact integer sum times float32(1/L).  Replaces the Pallas kernel of
// src/repro/kernels/ace_fleet_score.py (ace_fleet_score).
//
// Bound on the H100: fp32 operations of the hash (2*B*d*K*L FLOP; at
// B = 256, d = 4097, K = 15, L = 50 that is 1.57 GFLOP, 23 us at
// 67 TFLOP/s); the tenant axis adds one integer multiply-add to each
// gather's offset, not a loop.
//
// Design: ace_score_fused.cu's, two kernels on one stream.
//   Phase 1 (fleet_hash_gather): the srp_gemm.cuh hash, as in srp_hash.cu
//     (64-row x table-group tiles, the depth split across a thread-block
//     cluster by the launch plan of kernels/srp_hash.py, so its ids are
//     srp_hash's bits under the same plan), whose epilogue gathers
//     counts[(tid * L + j) * 2^K + bucket] into a (B, L) int32 scratch
//     (and writes the id when asked, for the tests).  The row tile's
//     tenant ids are read into shared memory before the hash, so that
//     each gather waits on one load, not two.
//   Phase 2 (fleet_warp_rows): repro::warp_row_mean, a warp a row: the
//     exact int64 sum, one conversion to fp32, times __frcp_rn(L) --
//     ace_query_sum's convention, so the scores are bitwise srp_hash + the
//     routed ace_query_sum (the SRHT and masked branch of
//     ops.ace_fleet_score), and bitwise a float sum in any order while a
//     row's sum is below 2^24.
// Counters are int32, int16, int8 or float32 (common.cuh's count trait):
// the scratch holds each counter's value (int32, narrow ones
// sign-extended; fp32 for float counters), summed exactly in int64 (fp64
// for float counters), as in ace_score_fused.cu.
// A row whose tenant id lies outside [0, T) gathers zeros: no read leaves
// the fleet (the entry points check ids on the host).  Offsets are 64-bit.

#include "srp_gemm.cuh"

namespace {

constexpr int kRowsPerBlock = 8;           // fleet_warp_rows: a warp a row

template <typename Cnt>
__global__ void __launch_bounds__(repro::gemm::kThreads,
                                  repro::gemm::kMinBlocks)
fleet_hash_gather(const Cnt* __restrict__ counts, const float* __restrict__ q,
                  const float* __restrict__ w,
                  const int* __restrict__ tenant_ids,
                  typename repro::CountTraits<Cnt>::Value* __restrict__
                      gathered,
                  int* __restrict__ buckets,
                  int B, int d, int P, int K, int L, int T,
                  repro::gemm::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tile_tids[repro::gemm::kRows];
  const long long nbuckets = 1LL << K;     // 2^31 does not fit an int
  // the row tile's tenant ids, read now so that the epilogue's gathers
  // wait on one load, not two (srp_gemm_tile's barriers publish them)
  const int row0 = blockIdx.x / plan.splits * repro::gemm::kRows;
  for (int r = threadIdx.x; r < repro::gemm::kRows; r += blockDim.x)
    tile_tids[r] = row0 + r < B ? tenant_ids[row0 + r] : -1;
  repro::gemm::srp_gemm_tile(
      q, w, B, d, P, K, L, plan, smem, [&](int row, int j, int bucket) {
        const long long o = static_cast<long long>(row) * L + j;
        if (buckets != nullptr) buckets[o] = bucket;
        const int t = tile_tids[row - row0];
        gathered[o] = (t < 0 || t >= T)
            ? 0
            : repro::load_count(counts + (static_cast<long long>(t) * L + j)
                                             * nbuckets + bucket);
      });
}

template <typename V>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
fleet_warp_rows(const V* __restrict__ gathered, float* __restrict__ scores,
                int B, int L) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (b < B) repro::warp_row_mean(gathered, scores, b, L);
}

}  // namespace

// counts (T, L, 2^K) of the type `count_type` (repro::CountCode); q (B, d),
// w (d, P) fp32, w 16-byte aligned; tenant_ids (B,) int32; gathered (B, L)
// scratch, int32 (fp32 for float counters); scores (B,) fp32; buckets
// (B, L) int32 or null (the ids, for the tests).  The hash's plan as in
// repro_srp_hash.  Needs 1 <= K <= 31, B >= 1, L <= 65535; a plan that
// does not fit returns cudaErrorInvalidValue.
REPRO_API int repro_ace_fleet_score(
    const void* counts, const float* q, const float* w,
    const int* tenant_ids, void* gathered, int* buckets, float* scores,
    int B, int d, int P, int K, int L, int T, int rows, int row_tiles,
    int tables, int groups, int splits, int b0, int b1, int b2, int b3,
    int b4, int b5, int b6, int b7, int b8, int count_type, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bounds[] = {b0, b1, b2, b3, b4, b5, b6, b7, b8};
  const repro::gemm::Plan plan = repro::gemm::make_plan(
      rows, row_tiles, tables, groups, splits, bounds);
  if (!repro::gemm::plan_fits(plan, w, B, d, K, L))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (!repro::with_count_type(count_type, [&](auto tag) {
        using C = decltype(tag);
        using V = typename repro::CountTraits<C>::Value;
        V* g = static_cast<V*>(gathered);
        err = repro::gemm::launch(fleet_hash_gather<C>, plan, s,
                                  static_cast<const C*>(counts), q, w,
                                  tenant_ids, g, buckets, B, d, P, K, L, T,
                                  plan);
        if (err != cudaSuccess) return;
        fleet_warp_rows<V><<<(B + kRowsPerBlock - 1) / kRowsPerBlock,
                             kRowsPerBlock * 32, 0, s>>>(g, scores, B, L);
        err = cudaGetLastError();
      }))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
