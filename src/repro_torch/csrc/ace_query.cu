// ACE query, two entry points.  Replaces the Pallas kernel of
// src/repro/kernels/ace_query.py (ace_query) together with the mean over L
// that every caller takes right after it.
//
// repro_ace_query_sum — the one every main path launches: each row's
//   gathered counters of the healthy tables, summed as an exact integer,
//   converted to fp32 once and scaled by the caller's one operation
//   (nothing, or x 1/nh; nh the healthy tables, or L unmasked).
//   Nothing of size (B, L) is written.  While a row's sum is below 2^24
//   the fp32 sums of integer-valued floats the callers took before are
//   exact in any order, so the bits are theirs; above it this sum is the
//   exactly rounded one.
// repro_ace_query — gathered[b, j] = float(counts[j, buckets[b, j]]), (B, L)
//   fp32, kept so that diagnostics can see the per-table counts.
// Either reads counts[row_base[b] + j, buckets[b, j]] of a stacked
// (R, nbuckets) table when a per-row base row is given (see ace_update.cu).
//
// Bound on the H100: memory — the (B, L) ids, the (B,) base rows and
// outputs, and one read of each counter the batch touches (the (L, 2^K)
// table, 6.55 MB at K = 15, L = 50, stays in the 50 MB L2 across calls).
// What holds a gather back is latency: base row -> id -> counter are three
// dependent loads.  Design of the sum: one warp a row, lanes over tables
// (j and j + 32, a loop of 64 tables at a time beyond that), so a row's L
// ids are one coalesced run; lane 0 reads the base row and the tenant id
// and broadcasts them with __shfl_sync; each lane issues both counter
// loads before it uses either; the sum is two redux.sync adds (the low 20
// bits and the rest apart, so it is exact for any int32 counters), the
// healthy count a popc of a ballot, and lane 0 writes the row.  8 rows a
// block.  The (B, L) gather is one thread per (b, j): both its streams
// coalesce and only the counter reads scatter.
//
// Counters are int32, int16, int8 or float32 (common.cuh's count trait):
// narrow ones are read sign-extended and summed as exactly as int32;
// float ones sum in fp64 (exact for integer-valued counters below 2^53)
// with one conversion to fp32, so kernel and plain version agree bitwise.
//
// Ids outside [0, 2^K), rows outside [0, R) and tenant ids outside
// [0, T) are clamped, as the reference's gather clamps out-of-bounds
// indices (the hash never produces one).  Offsets are 64-bit.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;           // one row a warp
constexpr int kSumThreads = 32 * kRowsPerBlock;

// How the sum is scaled (kernels/ace_query.py SCALES).
enum Scale : int { kSum = 0, kMean = 1 };

__device__ __forceinline__ long long counter_offset(long long r, int b,
                                                    int R,
                                                    long long nbuckets) {
  r = r < 0 ? 0 : (r >= R ? R - 1 : r);
  return r * nbuckets + min(max(b, 0), static_cast<int>(nbuckets - 1));
}

template <typename Cnt>
__global__ void __launch_bounds__(kSumThreads)
ace_query_sum_kernel(const Cnt* __restrict__ counts,
                     const int* __restrict__ buckets,
                     const int* __restrict__ row_base,
                     const unsigned char* __restrict__ mask,
                     const int* __restrict__ tenant_ids,
                     float* __restrict__ out, float* __restrict__ out_all,
                     int B, int L, int R, long long nbuckets, int T,
                     int scale) {
  const int lane = threadIdx.x % 32;
  const long long b =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (b >= B) return;                      // the whole warp leaves
  const int* ids = buckets + b * L;
  long long base = 0;
  if (row_base != nullptr)
    base = __shfl_sync(kFull, lane == 0 ? row_base[b] : 0, 0);
  const unsigned char* m = nullptr;
  if (mask != nullptr) {
    int t = 0;
    if (tenant_ids != nullptr)
      t = __shfl_sync(kFull, lane == 0 ? tenant_ids[b] : 0, 0);
    m = mask + static_cast<long long>(min(max(t, 0), T - 1)) * L;
  }
  using V = typename repro::CountTraits<Cnt>::Value;
  using S = typename repro::CountTraits<Cnt>::Sum;
  S part = 0, part_all = 0;
  int healthy = 0;
  for (int j0 = 0; j0 < L; j0 += 64) {
    const int ja = j0 + lane, jb = ja + 32;
    const bool va = ja < L, vb = jb < L;
    const int ia = va ? ids[ja] : 0;
    const int ib = vb ? ids[jb] : 0;
    const V ca = va ? repro::load_count(
                          counts + counter_offset(base + ja, ia, R, nbuckets))
                    : V(0);
    const V cb = vb ? repro::load_count(
                          counts + counter_offset(base + jb, ib, R, nbuckets))
                    : V(0);
    const bool ha = va && (m == nullptr || m[ja] != 0);
    const bool hb = vb && (m == nullptr || m[jb] != 0);
    part += static_cast<S>(ha ? ca : V(0)) + static_cast<S>(hb ? cb : V(0));
    part_all += static_cast<S>(ca) + static_cast<S>(cb);
    if (m != nullptr)
      healthy += __popc(__ballot_sync(kFull, ha))
                 + __popc(__ballot_sync(kFull, hb));
  }
  const S s = repro::warp_sum(part);
  const S s_all = out_all != nullptr ? repro::warp_sum(part_all) : S(0);
  if (lane != 0) return;
  const float nh = static_cast<float>(m == nullptr ? L : max(healthy, 1));
  float v = repro::sum_to_float(s);
  if (scale == kMean) v = __fmul_rn(v, __frcp_rn(nh));
  out[b] = v;
  if (out_all != nullptr) out_all[b] = repro::sum_to_float(s_all);
}

template <typename Cnt>
__global__ void ace_query_kernel(const Cnt* __restrict__ counts,
                                 const int* __restrict__ buckets,
                                 const int* __restrict__ row_base,
                                 float* __restrict__ out, int B, int L, int R,
                                 long long nbuckets) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= static_cast<long long>(B) * L) return;
  const long long r = (row_base != nullptr ? row_base[i / L] : 0) + i % L;
  out[i] = static_cast<float>(repro::load_count(
      counts + counter_offset(r, buckets[i], R, nbuckets)));
}

}  // namespace

// counts (R, nbuckets) of the type `count_type` (repro::CountCode);
// buckets (B, L) int32; row_base (B,) int32 or null (row j for table j,
// R == L); mask (T, L) uint8 (nonzero: healthy) or null; tenant_ids (B,)
// int32 picks item b's mask row, or null (row 0); out (B,) fp32, scaled by
// `scale` (Scale); out_all (B,) fp32, the unscaled sum over every table, or
// null.  nbuckets is 64-bit (2^31 at K = 31).  Needs 1 <= L <= 65535.
REPRO_API int repro_ace_query_sum(const void* counts, const int* buckets,
                                  const int* row_base,
                                  const unsigned char* mask,
                                  const int* tenant_ids, float* out,
                                  float* out_all, int B, int L, int R,
                                  long long nbuckets, int T, int scale,
                                  int count_type, void* stream) {
  const unsigned int blocks =
      static_cast<unsigned int>((B + kRowsPerBlock - 1) / kRowsPerBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!repro::with_count_type(count_type, [&](auto tag) {
        using C = decltype(tag);
        ace_query_sum_kernel<C><<<blocks, kSumThreads, 0, s>>>(
            static_cast<const C*>(counts), buckets, row_base, mask,
            tenant_ids, out, out_all, B, L, R, nbuckets, T, scale);
      }))
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

// counts (R, nbuckets) of the type `count_type`; buckets (B, L) int32;
// row_base (B,) int32 or null (row j for table j, R == L); out (B, L) fp32.
REPRO_API int repro_ace_query(const void* counts, const int* buckets,
                              const int* row_base, float* out, int B, int L,
                              int R, long long nbuckets, int count_type,
                              void* stream) {
  constexpr int kThreads = 256;
  const long long n = static_cast<long long>(B) * L;
  const unsigned int blocks =
      static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!repro::with_count_type(count_type, [&](auto tag) {
        using C = decltype(tag);
        ace_query_kernel<C><<<blocks, kThreads, 0, s>>>(
            static_cast<const C*>(counts), buckets, row_base, out, B, L, R,
            nbuckets);
      }))
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
