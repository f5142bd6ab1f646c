// ACE count-array insert: counts[j, buckets[b, j]] += 1 for every (b, j),
// in place, or only for the rows b where row_mask[b] when a mask is given
// (the masked insert of the SRHT and degraded admission paths).  With a
// per-row base row, item b's table j is row row_base[b] + j of a stacked
// (R, nbuckets) table: the live epoch of a window ring (cursor * L + j),
// a fleet tenant (tid * L + j), a windowed fleet's live epoch.  Replaces
// the Pallas kernel of src/repro/kernels/ace_update.py (ace_update, both
// its scalar-loop and one-hot-histogram lowerings).
//
// Bound on the H100: memory — reading the (B, L) ids and one
// read-modify-write of each counter the batch touches; there is no
// arithmetic to speak of.  Design: one thread per (b, j) and a global
// int32 atomicAdd, which is exact in any order, so no lowering choice is
// carried over from the TPU.  Clustered data sends many items of a batch
// to one bucket, and atomics on one address serialise; a shared-memory
// histogram per table is the remedy, left for a later change.
//
// Ids outside [0, 2^K) and rows outside [0, R) are dropped, as the
// reference's scatter drops out-of-bounds updates (the hash never
// produces one, and the callers' base rows stay inside the table).
// Offsets are 64-bit: a stacked table may hold more than 2^31 counters.

#include "common.cuh"

namespace {

__global__ void ace_update_kernel(int* __restrict__ counts,
                                  const int* __restrict__ buckets,
                                  const unsigned char* __restrict__ row_mask,
                                  const int* __restrict__ row_base,
                                  int B, int L, int R, int nbuckets) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= static_cast<long long>(B) * L) return;
  const long long item = i / L;
  if (row_mask != nullptr && !row_mask[item]) return;
  const long long r = (row_base != nullptr ? row_base[item] : 0) + i % L;
  const int b = buckets[i];
  if (r < 0 || r >= R || b < 0 || b >= nbuckets) return;
  atomicAdd(&counts[r * nbuckets + b], 1);
}

}  // namespace

// counts (R, nbuckets) int32, updated in place; buckets (B, L) int32;
// row_mask (B,) bool or null (every row); row_base (B,) int32 or null
// (row j for table j, R == L).
REPRO_API int repro_ace_update(int* counts, const int* buckets,
                               const unsigned char* row_mask,
                               const int* row_base, int B, int L, int R,
                               int nbuckets, void* stream) {
  constexpr int kThreads = 256;
  const long long n = static_cast<long long>(B) * L;
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  ace_update_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, buckets, row_mask, row_base, B, L, R, nbuckets);
  return static_cast<int>(cudaGetLastError());
}
