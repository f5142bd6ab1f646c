// Fused multi-tenant ACE scoring: dense SRP hash -> one gather per table
// at row tenant_ids[b] * L + j of the (T * L, 2^K) fleet -> sum over the L
// tables in table order -> times float32(1/L).  Replaces the Pallas kernel
// of src/repro/kernels/ace_fleet_score.py (ace_fleet_score).
//
// Bound on the H100: fp32 operations of the hash (2*B*d*K*L FLOP), as for
// ace_score_fused; the tenant axis adds one integer multiply-add to each
// gather's offset, not a loop.
//
// Design: two kernels on one stream.
//   Phase 1 (fleet_hash_gather): the srp_tile.cuh block hash over
//     (16 rows x one group of tables) blocks, whose epilogue gathers
//     counts[(tid * L + j) * 2^K + bucket] into a (B, L) fp32 scratch;
//     the bucket ids never reach device memory.
//   Phase 2 (fleet_combine): one thread per row sums its L gathers in
//     table order and multiplies by float32(1/L), so the plain version's
//     loop of adds gives the same bits.
// A row whose tenant id lies outside [0, T) gathers zeros: no read leaves
// the fleet (the entry points check ids on the host).  Offsets are 64-bit.

#include "srp_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
fleet_hash_gather(const int* __restrict__ counts, const float* __restrict__ q,
                  const float* __restrict__ w,
                  const int* __restrict__ tenant_ids,
                  float* __restrict__ gathered, int B, int d, int P, int K,
                  int L, int T) {
  __shared__ repro::SrpTileSmem sm;
  const long long nbuckets = 1LL << K;
  repro::srp_tile(
      q, w, B, d, P, K, L, sm, [&](int row, int j, int bucket) {
        const int t = tenant_ids[row];
        const long long o = static_cast<long long>(row) * L + j;
        gathered[o] = (t < 0 || t >= T) ? 0.0f : static_cast<float>(
            counts[(static_cast<long long>(t) * L + j) * nbuckets + bucket]);
      });
}

__global__ void fleet_combine(const float* __restrict__ gathered,
                              float* __restrict__ scores, int B, int L,
                              float inv_l) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  scores[row] = __fmul_rn(
      repro::table_order_sum(gathered + static_cast<long long>(row) * L, L),
      inv_l);
}

}  // namespace

// counts (T, L, 2^K) int32; q (B, d), w (d, P) fp32; tenant_ids (B,)
// int32; scores (B,) fp32; gathered (B, L) fp32 is scratch.  Needs
// 1 <= K <= 31 and B >= 1.
REPRO_API int repro_ace_fleet_score(const int* counts, const float* q,
                                    const float* w, const int* tenant_ids,
                                    float* gathered, float* scores, int B,
                                    int d, int P, int K, int L, int T,
                                    float inv_l, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fleet_hash_gather<<<repro::tile_grid(B, K, L), repro::kThreads, 0, s>>>(
      counts, q, w, tenant_ids, gathered, B, d, P, K, L, T);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  fleet_combine<<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      gathered, scores, B, L, inv_l);
  return static_cast<int>(cudaGetLastError());
}
