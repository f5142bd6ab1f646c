// Fused guardrail admission: hash -> PRE-insert score -> threshold ->
// masked insert, counts updated in place.  Replaces the Pallas kernel of
// src/repro/kernels/ace_admit_fused.py (ace_admit_fused).
//
// Bound on the H100: fp32 operations of the hash (2*B*d*K*L FLOP; at
// B = 256, d = 4097 that is 1.57 GFLOP against 12.6 MB of q and W).
//
// Design: two kernels, launched back to back on one stream.
//   Phase 1 (admit_hash_gather): the srp_tile.cuh hash over
//     (16 rows x one group of tables) blocks, as in srp_hash.cu, whose
//     epilogue writes each bucket id and gathers its counter,
//     gathered[b, j] = counts[j, bucket].  No counter is written in this
//     phase, so every gather sees the pre-insert counts.
//   Phase 2 (admit_score_insert): one thread per row sums its gathered
//     counts in table order 0..L-1, multiplies by float32(1/L) (the
//     reference's reciprocal), compares with the threshold read through a
//     device pointer (no host sync), ANDs in row < B and the item mask,
//     writes score and verdict, and for an admitted row atomically adds 1
//     at each of its L buckets.
// Stream order puts every gather of phase 1 before any atomic of phase 2:
// the reference's "score strictly against the PRE-insert counts"
// (ace_admit_fused.py:23-25), which a single launch with many blocks
// could not promise (one block's gathers could see another's atomics).
// The phase-1 hash keeps srp_hash's (rows x table groups) grid
// instead of one block per row; that is why the row sum lives in phase 2.
// The TPU kernel's one-tile batch and its VMEM batch cap do not apply.

#include "srp_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
admit_hash_gather(const int* __restrict__ counts, const float* __restrict__ q,
                  const float* __restrict__ w, int* __restrict__ buckets,
                  float* __restrict__ gathered, int B, int d, int P, int K,
                  int L, int nbuckets) {
  __shared__ repro::SrpTileSmem sm;
  repro::srp_tile(
      q, w, B, d, P, K, L, sm, [&](int row, int j, int bucket) {
        const long long o = static_cast<long long>(row) * L + j;
        buckets[o] = bucket;
        gathered[o] = static_cast<float>(
            counts[static_cast<long long>(j) * nbuckets + bucket]);
      });
}

__global__ void admit_score_insert(int* __restrict__ counts,
                                   const int* __restrict__ buckets,
                                   const float* __restrict__ gathered,
                                   const float* __restrict__ thresh,
                                   const unsigned char* __restrict__ item_mask,
                                   float* __restrict__ scores,
                                   unsigned char* __restrict__ admit, int B,
                                   int L, int nbuckets, float inv_l) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= B) return;
  const long long base = static_cast<long long>(row) * L;
  float s = 0.0f;
#pragma unroll 10
  for (int j = 0; j < L; ++j) s += gathered[base + j];
  s *= inv_l;
  const bool a = s >= *thresh && (item_mask == nullptr || item_mask[row]);
  scores[row] = s;
  admit[row] = a ? 1 : 0;
  if (!a) return;
#pragma unroll 10
  for (int j = 0; j < L; ++j)
    atomicAdd(&counts[static_cast<long long>(j) * nbuckets + buckets[base + j]],
              1);
}

}  // namespace

// counts (L, nbuckets) int32, updated in place; q (B, d), w (d, P) fp32;
// thresh: one fp32 on the device; item_mask (B,) bool or null.
// Outputs: buckets (B, L) int32, scores (B,) fp32, admit (B,) bool;
// gathered (B, L) fp32 is scratch.  Needs 1 <= K <= 31, B >= 1.
REPRO_API int repro_ace_admit_fused(int* counts, const float* q,
                                    const float* w, const float* thresh,
                                    const unsigned char* item_mask,
                                    int* buckets, float* gathered,
                                    float* scores, unsigned char* admit,
                                    int B, int d, int P, int K, int L,
                                    int nbuckets, float inv_l, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  admit_hash_gather<<<repro::tile_grid(B, K, L), repro::kThreads, 0, s>>>(
      counts, q, w, buckets, gathered, B, d, P, K, L, nbuckets);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  admit_score_insert<<<(B + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      counts, buckets, gathered, thresh, item_mask, scores, admit, B, L,
      nbuckets, inv_l);
  return static_cast<int>(cudaGetLastError());
}
