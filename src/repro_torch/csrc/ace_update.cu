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
// arithmetic to speak of.  What costs beyond that is the atomics: a batch
// of clustered data sends hundreds of its items to one counter, and
// global atomics on one address serialise in L2.  So a block adds its
// items up before it goes global:
//
// - A block takes one table j and 256 rows b, one a thread, so every
//   item it holds may share a counter with any other: a warp's lanes are
//   32 consecutive rows of the same table.
// - Within the warp, two reductions (the smallest and the largest key)
//   find a warp whose items all hold one counter, the clustered case: one
//   lane adds them all.  A third (an OR of one of 32 hash signatures a
//   key) finds a warp of mostly distinct keys (more than 16 signatures
//   taken; 32 random keys take ~20): its lanes add straight to the
//   counts, since there is nothing to merge and one atomic an item costs
//   least.  A block where half the warps are of that kind (or empty) adds
//   all its items straight to the counts and stops there: the admit's
//   and the stream step's batches of distinct ids.
// - Across the block, a shared-memory open-addressing table of 512 slots
//   (twice the block's items; 32-bit keys, a claim is one atomicCAS, a
//   count one atomicAdd) merges the other warps' items.  A key that finds
//   no slot within 8 probes, or does not fit 32 bits, goes straight to a
//   global atomicAdd.
// - Then the block flushes one global atomicAdd per slot it filled: at
//   the fit's 857 hot counters a counter takes at most one atomic from
//   each of 16 blocks instead of one from each of ~240 items.
//
// Earlier forms measured on the way (PERF.md): a block on 32 rows
// of every table with a __match_any_sync merging every group of equal
// lanes and 4096 slots of 64-bit words was 2.7-3.8x slower than one
// atomic an item on batches of distinct ids; this form without the
// signature test 1.3x, and with it decided a warp at a time 1.2x (most
// blocks still held one warp that took the table); without the shared
// table it is slower than one atomic an item on the fit's clustered
// batch.
//
// Counters are int32, int16, int8 or float32 (common.cuh's count trait;
// one instantiation each, picked by the entry point's type code).  A
// flush adds n in the plane's own type: int32 with atomicAdd, int16 and
// int8 with repro::add_count's CAS loops, which wrap past the dtype max
// as the reference's narrow .add does; float32 with the float atomicAdd,
// exact while a counter stays below 2^24.  Modular integer adds in any
// order give the same counts, so every path is exact and no TPU lowering
// choice is carried over.  Ids outside [0, 2^K) and
// rows outside [0, R) are dropped, as the reference's scatter drops
// out-of-bounds updates (the hash never produces one, and the callers'
// base rows stay inside the table).  Offsets are 64-bit: a stacked table
// may hold more than 2^31 counters.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;        // rows b a block, one a thread
constexpr int kSlots = 512;          // the block's table of counters
constexpr int kSlotBits = 9;
constexpr int kProbes = 8;
constexpr int kSpread = 16;          // of a warp's 32 hash signatures
constexpr unsigned int kEmpty = 0xffffffffu;

// Add n to key's slot, claiming one if the key has none; false when no
// slot within kProbes is free or the key's.
__device__ __forceinline__ bool add_shared(unsigned int* keys, int* hits,
                                           unsigned int key, int n) {
  unsigned int s = (key * 0x9E3779B1u) >> (32 - kSlotBits);
  for (int p = 0; p < kProbes; ++p, s = (s + 1) & (kSlots - 1)) {
    unsigned int cur = *static_cast<volatile unsigned int*>(keys + s);
    if (cur == kEmpty) {
      cur = atomicCAS(keys + s, kEmpty, key);
      if (cur == kEmpty) cur = key;
    }
    if (cur == key) {
      atomicAdd(hits + s, n);
      return true;
    }
  }
  return false;
}

template <typename Cnt>
__global__ void __launch_bounds__(kThreads)
ace_update_kernel(Cnt* __restrict__ counts, const int* __restrict__ buckets,
                  const unsigned char* __restrict__ row_mask,
                  const int* __restrict__ row_base, int B, int L, int R,
                  long long nbuckets) {
  __shared__ unsigned int keys[kSlots];
  __shared__ int hits[kSlots];
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long b = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  // the row's mask, base row and id, loaded together
  const bool live = b < B;
  const bool on = live && (row_mask == nullptr || row_mask[b]);
  const long long row = (live && row_base != nullptr ? row_base[b] : 0) + j;
  const int id = live ? buckets[b * L + j] : -1;
  const bool valid = on && row >= 0 && row < R && id >= 0
                     && id <= static_cast<int>(nbuckets - 1);
  const long long key = valid ? row * nbuckets + id : -1;
  const bool fits = valid && key < kEmpty;
  const unsigned int k = fits ? static_cast<unsigned int>(key) : kEmpty;
  const unsigned int in = __ballot_sync(0xffffffffu, fits);
  const unsigned int lo = __reduce_min_sync(0xffffffffu, k);
  const unsigned int hi = __reduce_max_sync(0xffffffffu, fits ? k : 0u);
  const bool same = in != 0 && lo == hi;   // the warp's items, one counter
  // how many of 32 hash signatures the warp's keys take: a warp of mostly
  // distinct keys (batches of unclustered data) has nothing to merge and
  // adds straight to the counts, as one atomic an item costs least there
  const unsigned int seen = __reduce_or_sync(
      0xffffffffu, fits ? 1u << ((k * 0x9E3779B1u) >> 27) : 0u);
  const bool spread = !same && __popc(seen) > kSpread;
  // a block where half the warps have nothing to merge (spread, or no
  // items) adds straight to the counts: its shared table would cost more
  // than it saves
  const bool direct =
      2 * __syncthreads_count(lane == 0 && (spread || in == 0))
      >= kThreads / 32;
  if (direct || spread) {
    if (same) {
      if (lane == __ffs(in) - 1) repro::add_count(counts + lo, __popc(in));
    } else if (fits) {
      repro::add_count(counts + k, 1);
    }
  }
  if (valid && !fits) repro::add_count(counts + key, 1);
  if (direct) return;

  for (int s = threadIdx.x; s < kSlots; s += kThreads) {
    keys[s] = kEmpty;
    hits[s] = 0;
  }
  __syncthreads();
  if (!spread) {
    if (same) {
      if (lane == __ffs(in) - 1 && !add_shared(keys, hits, lo, __popc(in)))
        repro::add_count(counts + lo, __popc(in));
    } else if (fits && !add_shared(keys, hits, k, 1)) {
      repro::add_count(counts + k, 1);
    }
  }
  __syncthreads();

  for (int s = threadIdx.x; s < kSlots; s += kThreads) {
    const unsigned int kk = keys[s];
    if (kk != kEmpty) repro::add_count(counts + kk, hits[s]);
  }
}

}  // namespace

// counts (R, nbuckets) of the type `count_type` (repro::CountCode), updated
// in place (int8 planes 4-byte aligned); buckets (B, L) int32; row_mask
// (B,) bool or null (every row); row_base (B,) int32 or null (row j for
// table j, R == L).  nbuckets is 64-bit: 2^31 at K = 31.  One block a
// table and 256 rows: L must be at most 65535 (the grid's y).
REPRO_API int repro_ace_update(void* counts, const int* buckets,
                               const unsigned char* row_mask,
                               const int* row_base, int B, int L, int R,
                               long long nbuckets, int count_type,
                               void* stream) {
  if (B < 1 || L < 1 || L > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned int>(
                      (static_cast<long long>(B) + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(L));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!repro::with_count_type(count_type, [&](auto tag) {
        using T = decltype(tag);
        ace_update_kernel<T><<<grid, kThreads, 0, s>>>(
            static_cast<T*>(counts), buckets, row_mask, row_base, B, L, R,
            nbuckets);
      }))
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
