// ACE query: gathered[b, j] = float(counts[j, buckets[b, j]]), (B, L) fp32,
// or counts[row_base[b] + j, buckets[b, j]] of a stacked (R, nbuckets)
// table when a per-row base row is given (see ace_update.cu).  Replaces
// the Pallas kernel of src/repro/kernels/ace_query.py (ace_query).
//
// Bound on the H100: memory — the (B, L) ids in, the (B, L) gather out, and
// one read of each counter the batch touches (the (L, 2^K) table, 6.55 MB
// at K = 15, L = 50, stays in the 50 MB L2 across calls).  Design: one
// thread per (b, j); neighbouring threads read neighbouring ids and write
// neighbouring outputs, so both streams coalesce and only the counter
// reads are scattered.
//
// Ids outside [0, 2^K) and rows outside [0, R) are clamped, as the
// reference's gather clamps out-of-bounds indices (the hash never
// produces one).  Offsets are 64-bit.

#include "common.cuh"

namespace {

__global__ void ace_query_kernel(const int* __restrict__ counts,
                                 const int* __restrict__ buckets,
                                 const int* __restrict__ row_base,
                                 float* __restrict__ out, int B, int L, int R,
                                 int nbuckets) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= static_cast<long long>(B) * L) return;
  long long r = (row_base != nullptr ? row_base[i / L] : 0) + i % L;
  r = r < 0 ? 0 : (r >= R ? R - 1 : r);
  const int b = min(max(buckets[i], 0), nbuckets - 1);
  out[i] = static_cast<float>(counts[r * nbuckets + b]);
}

}  // namespace

// counts (R, nbuckets) int32; buckets (B, L) int32; row_base (B,) int32
// or null (row j for table j, R == L); out (B, L) fp32.
REPRO_API int repro_ace_query(const int* counts, const int* buckets,
                              const int* row_base, float* out, int B, int L,
                              int R, int nbuckets, void* stream) {
  constexpr int kThreads = 256;
  const long long n = static_cast<long long>(B) * L;
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  ace_query_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      counts, buckets, row_base, out, B, L, R, nbuckets);
  return static_cast<int>(cudaGetLastError());
}
