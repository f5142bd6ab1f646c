// Fused guardrail admission: hash -> PRE-insert score -> threshold ->
// masked insert, counts updated in place.  Replaces the Pallas kernel of
// src/repro/kernels/ace_admit_fused.py (ace_admit_fused).
//
// Bound on the H100: fp32 operations of the hash (2*B*d*K*L FLOP; at
// B = 256, d = 4097 that is 1.57 GFLOP against 12.6 MB of q and W).
//
// Design: two kernels, launched back to back on one stream.
//   Phase 1 (admit_hash_gather): the srp_gemm.cuh hash, as in srp_hash.cu
//     (64-row x table-group tiles, the depth split across a thread-block
//     cluster by the launch plan of kernels/srp_hash.py), whose epilogue
//     writes each bucket id and gathers its counter,
//     gathered[b, j] = counts[j, bucket].  No counter is written in this
//     phase, so every gather sees the pre-insert counts.
//   Phase 2 (admit_score_insert): a warp a row.  Lane 0 sums the row's
//     gathered counts in table order 0..L-1, multiplies by float32(1/L)
//     (the reference's reciprocal), compares with the threshold read
//     through a device pointer (no host sync), ANDs in the item mask and
//     writes score and verdict; for an admitted row the warp's lanes then
//     add 1 at its L buckets, a table a lane, so the L atomics of a row
//     (a narrow add's compare-and-swap loop, a load and a CAS each) run
//     side by side, not one after another.
// Stream order puts every gather of phase 1 before any atomic of phase 2:
// the reference's "score strictly against the PRE-insert counts"
// (ace_admit_fused.py:23-25), which a single launch with many blocks
// could not promise (one block's gathers could see another's atomics).
// Counters are int32, int16, int8 or float32 (common.cuh's count trait):
// phase 1 gathers each as fp32 (narrow ones sign-extended, exact), phase 2
// adds 1 in the plane's own type (repro::add_count: narrow adds wrap past
// the dtype max, as the reference's do).  The order above holds for
// every type.
// x and W both bfloat16 or both float16: phase 1 runs the tensor-core
// tile of srp_gemm.cuh (srp_tc_tile), with the same plan and epilogue.
// The phase-1 hash keeps srp_hash's grid instead of one block per row;
// that is why the row sum lives in phase 2.  The TPU kernel's one-tile
// batch and its VMEM batch cap do not apply.

#include "srp_gemm.cuh"

namespace {

template <typename Cnt, bool kNarrow>
__global__ void __launch_bounds__(repro::gemm::kThreads,
                                  repro::gemm::min_blocks(kNarrow))
admit_hash_gather(const Cnt* __restrict__ counts, repro::gemm::Operands op,
                  int* __restrict__ buckets, float* __restrict__ gathered,
                  int B, int d, int P, int K, int L, long long nbuckets,
                  repro::gemm::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  repro::gemm::srp_gemm_tile<kNarrow>(
      op, B, d, P, K, L, plan, smem, [&](int row, int j, int bucket) {
        const long long o = static_cast<long long>(row) * L + j;
        buckets[o] = bucket;
        gathered[o] = static_cast<float>(
            repro::load_count(counts + j * nbuckets + bucket));
      });
}

template <typename Cnt, bool kF16>
__global__ void __launch_bounds__(repro::gemm::kThreads,
                                  repro::gemm::kTcMinBlocks)
admit_hash_gather_tc(const Cnt* __restrict__ counts,
                     repro::gemm::Operands op, int* __restrict__ buckets,
                     float* __restrict__ gathered, int B, int d, int P,
                     int K, int L, long long nbuckets,
                     repro::gemm::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  repro::gemm::srp_tc_tile<kF16>(
      op, B, d, P, K, L, plan, smem, [&](int row, int j, int bucket) {
        const long long o = static_cast<long long>(row) * L + j;
        buckets[o] = bucket;
        gathered[o] = static_cast<float>(
            repro::load_count(counts + j * nbuckets + bucket));
      });
}

constexpr int kInsertRows = 8;             // phase 2: a warp a row

template <typename Cnt>
__global__ void __launch_bounds__(32 * kInsertRows)
admit_score_insert(Cnt* __restrict__ counts,
                                   const int* __restrict__ buckets,
                                   const float* __restrict__ gathered,
                                   const float* __restrict__ thresh,
                                   const unsigned char* __restrict__ item_mask,
                                   float* __restrict__ scores,
                                   unsigned char* __restrict__ admit, int B,
                                   int L, long long nbuckets, float inv_l) {
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kInsertRows + threadIdx.x / 32;
  if (row >= B) return;                    // the whole warp leaves
  const long long base = row * L;
  int a = 0;
  if (lane == 0) {
    float s = 0.0f;
#pragma unroll 10
    for (int j = 0; j < L; ++j) s += gathered[base + j];
    s *= inv_l;
    a = s >= *thresh && (item_mask == nullptr || item_mask[row]);
    scores[row] = s;
    admit[row] = a ? 1 : 0;
  }
  if (!__shfl_sync(0xffffffffu, a, 0)) return;
  for (int j = lane; j < L; j += 32)
    repro::add_count(counts + j * nbuckets + buckets[base + j], 1);
}

}  // namespace

// counts (L, nbuckets) of the type `count_type` (repro::CountCode; int8
// planes 4-byte aligned), updated in place; q (B, d), w (d, P) of the types
// x_type, w_type (fp32, bf16 or fp16), w 16-byte aligned; thresh: one fp32
// on the device; item_mask (B,) bool or null.  Outputs: buckets (B, L) int32,
// scores (B,) fp32, admit (B,) bool; gathered (B, L) fp32 is
// scratch.  nbuckets is 64-bit (2^31 at K = 31).  The hash's plan and
// tile as in repro_srp_hash.  Needs 1 <= K <= 31, B >= 1; a plan that does
// not fit, or a tile that does not take the operand pair, returns
// cudaErrorInvalidValue.
REPRO_API int repro_ace_admit_fused(void* counts, const void* q,
                                    const void* w, const float* thresh,
                                    const unsigned char* item_mask,
                                    int* buckets, float* gathered,
                                    float* scores, unsigned char* admit,
                                    int B, int d, int P, int K, int L,
                                    long long nbuckets, float inv_l,
                                    int rows, int row_tiles, int tables,
                                    int groups, int splits, int b0, int b1,
                                    int b2, int b3, int b4, int b5, int b6,
                                    int b7, int b8, int count_type,
                                    int x_type, int w_type, int tile,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bounds[] = {b0, b1, b2, b3, b4, b5, b6, b7, b8};
  const repro::gemm::Operands op{q, w, x_type, w_type};
  const repro::gemm::Plan plan = repro::gemm::make_plan(
      rows, row_tiles, tables, groups, splits, bounds);
  if (!repro::gemm::plan_fits(plan, op, B, d, K, L) ||
      !repro::gemm::tile_takes(tile, op))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (!repro::with_count_type(count_type, [&](auto tag) {
        using T = decltype(tag);
        T* c = static_cast<T*>(counts);
        err = repro::gemm::launch_tile(
            tile, op, admit_hash_gather<T, false>,
            admit_hash_gather<T, true>, admit_hash_gather_tc<T, false>,
            admit_hash_gather_tc<T, true>, plan, s, c, op, buckets,
            gathered, B, d, P, K, L, nbuckets, plan);
        if (err != cudaSuccess) return;
        admit_score_insert<T><<<(B + kInsertRows - 1) / kInsertRows,
                                32 * kInsertRows, 0, s>>>(
            c, buckets, gathered, thresh, item_mask, scores, admit, B, L,
            nbuckets, inv_l);
        err = cudaGetLastError();
      }))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
