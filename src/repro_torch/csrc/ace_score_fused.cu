// Fused ACE scoring: dense SRP hash -> one row-offset gather at
// j * 2^K + b_j -> sum over the L tables in table order -> times
// float32(1/L), or the weighted combine sum_j tw_j * g_j.  Replaces the
// Pallas kernel of src/repro/kernels/ace_score_fused.py (ace_score_fused).
//
// Bound on the H100: fp32 operations of the hash (2*B*d*K*L FLOP; at
// B = 16,384, d = 36 that is 0.88 GFLOP against 2.5 MB of q and 6.6 MB of
// counts at most).
//
// Design: two kernels, launched back to back on one stream, as in
// ace_admit_fused.cu.
//   Phase 1 (score_hash_gather): the srp_tile.cuh hash over (16 rows x
//     one group of tables) blocks, whose epilogue gathers each table's
//     counter, gathered[b, j] = float(counts[j * 2^K + bucket]); the
//     bucket ids never reach device memory.
//   Phase 2 (score_combine): one thread per row sums its L gathers in
//     table order j = 0..L-1 and multiplies by float32(1/L) (the
//     reference's reciprocal), or, with table weights, adds
//     __fmul_rn(g_j, tw_j) in table order with __fadd_rn, so nvcc
//     contracts nothing into an FMA and the plain version's
//     multiply-then-add loop gives the same bits.
// A block holds only a group of tables, so the row sum cannot finish in
// phase 1 without atomics, whose order would make float sums above 2^24
// depend on the schedule; the fixed-order second pass keeps every score
// deterministic.  The TPU kernel's pack matmul and its (bm, 128) padded
// output tile are not carried over.

#include "srp_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
score_hash_gather(const int* __restrict__ counts, const float* __restrict__ q,
                  const float* __restrict__ w, float* __restrict__ gathered,
                  int B, int d, int P, int K, int L) {
  __shared__ repro::SrpTileSmem sm;
  const long long nbuckets = 1LL << K;     // 2^31 does not fit an int
  repro::srp_tile(
      q, w, B, d, P, K, L, sm, [&](int row, int j, int bucket) {
        gathered[static_cast<long long>(row) * L + j] =
            static_cast<float>(counts[j * nbuckets + bucket]);
      });
}

__global__ void score_combine(const float* __restrict__ gathered,
                              const float* __restrict__ tw,
                              float* __restrict__ scores, int B, int L,
                              float inv_l) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const float* g = gathered + static_cast<long long>(row) * L;
  float s = 0.0f;
  if (tw == nullptr) {
#pragma unroll 10
    for (int j = 0; j < L; ++j) s = __fadd_rn(s, g[j]);
    scores[row] = __fmul_rn(s, inv_l);
  } else {
#pragma unroll 10
    for (int j = 0; j < L; ++j) s = __fadd_rn(s, __fmul_rn(g[j], tw[j]));
    scores[row] = s;
  }
}

}  // namespace

// counts (L, 2^K) int32; q (B, d), w (d, P) fp32; tw (L,) fp32 or null;
// scores (B,) fp32; gathered (B, L) fp32 is scratch.  Needs 1 <= K <= 31
// and B >= 1.
REPRO_API int repro_ace_score_fused(const int* counts, const float* q,
                                    const float* w, const float* tw,
                                    float* gathered, float* scores, int B,
                                    int d, int P, int K, int L, float inv_l,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  score_hash_gather<<<repro::tile_grid(B, K, L), repro::kThreads, 0, s>>>(
      counts, q, w, gathered, B, d, P, K, L);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  score_combine<<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      gathered, tw, scores, B, L, inv_l);
  return static_cast<int>(cudaGetLastError());
}
