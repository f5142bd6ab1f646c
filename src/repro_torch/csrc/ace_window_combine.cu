// Windowed ACE scoring: the E-way weighted combine of an epoch ring,
//   score_b = (1/L) * sum_e w_e * sum_j C_e[j, b_j]
// or, with table weights, sum_e w_e * sum_j tw_j * C_e[j, b_j].  Replaces
// the Pallas kernel of src/repro/kernels/ace_window_combine.py
// (ace_window_combine, both its "flat" and "unroll" lowerings).
//
// Bound on the H100: memory — the (B, L) ids, the (B,) scores and one read
// of each counter the batch touches in each of the E epochs; there is no
// arithmetic to speak of (E*L adds a row).  What holds a row back is
// latency: id -> counter are two dependent loads.
//
// Design: one kernel, a warp a row (ace_query_sum's design, ace_query.cu),
// 8 rows a block; nothing of size (B, E, L) is written.  Lanes take tables
// j and j + 32, 64 tables a pass: a lane loads and clamps its two ids once,
// then issues the counter loads of both tables in up to kEpochs epochs at
// once (16 independent loads in flight), epochs kEpochs at a time.
//   Unweighted: each epoch's sum is exact in int64 (repro::warp_sum, two
//     redux.sync adds), converted to fp32 once; every lane then folds
//     acc = acc + w_e * s_e in ring-index order (__fadd_rn/__fmul_rn, no
//     FMA) and lane 0 writes acc * __frcp_rn(L) = acc * float32(1/L): the
//     reference's canonical order (window/ring.py score_from_sums) with
//     each epoch's table sum exact, which is the bits of a float sum in any
//     order while that sum is below 2^24.
//   Weighted (table_weights, the degraded path): the lanes form the
//     products __fmul_rn(g_j, tw_j) of a pass into the warp's shared tile,
//     one row an epoch, and lane k adds epoch k's products in table order
//     j = 0..L-1 with __fadd_rn, carrying its sum from pass to pass; the
//     epochs' sums then reach every lane by shuffle and fold as above,
//     with no 1/L.  The L adds of the epochs run side by side, one lane
//     each.
// Counters are int32, int16, int8 or float32 (common.cuh's count trait):
// narrow ones are read sign-extended and each epoch's sum is as exact as
// int32's; float ones sum in fp64 (exact for integer values below 2^53)
// and convert once.
// The plain version (kernels/ace_window_combine.py) runs the same
// arithmetic, so the two agree bitwise.  The TPU kernel's choice between
// one flat take and a per-epoch unroll (choose_mode, FLAT_MAX_COLS) is a
// lowering choice calibrated on the TPU and is not carried over.  Offsets
// are 64-bit: E*L*2^K may pass 2^31.  Ids outside [0, 2^K) are clamped,
// as in ace_query.cu.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;           // a warp a row
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kEpochs = 8;                 // epochs whose loads fly together
constexpr int kPass = 64;                  // tables a pass: j and j + 32
constexpr int kTileStride = kPass + 1;     // lane k reads row k: no conflict
// The weighted form's shared tile: a (kEpochs, kPass) row block a warp.
constexpr int kTileBytes =
    static_cast<int>(sizeof(float)) * kRowsPerBlock * kEpochs * kTileStride;

template <typename Cnt, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
window_combine(const Cnt* __restrict__ counts, const int* __restrict__ buckets,
               const float* __restrict__ w, const float* __restrict__ tw,
               float* __restrict__ scores, int B, int E, int L,
               long long nbuckets) {
  extern __shared__ float tile[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long b =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp;
  if (b >= B) return;                      // the whole warp leaves
  float* prod = tile + warp * kEpochs * kTileStride;
  const int* ids = buckets + b * L;
  const int top = static_cast<int>(nbuckets - 1);
  const long long epoch = static_cast<long long>(L) * nbuckets;
  using V = typename repro::CountTraits<Cnt>::Value;
  using S = typename repro::CountTraits<Cnt>::Sum;
  float acc = 0.0f;
  for (int e0 = 0; e0 < E; e0 += kEpochs) {
    const int ne = min(kEpochs, E - e0);   // the same in every lane
    S part[kEpochs];
#pragma unroll
    for (int k = 0; k < kEpochs; ++k) part[k] = 0;
    float run = 0.0f;                      // lane k: epoch e0 + k, weighted
    for (int j0 = 0; j0 < L; j0 += kPass) {
      const int ja = j0 + lane, jb = ja + 32;
      const bool va = ja < L, vb = jb < L;
      const long long oa = e0 * epoch + ja * nbuckets
                           + (va ? min(max(ids[ja], 0), top) : 0);
      const long long ob = e0 * epoch + jb * nbuckets
                           + (vb ? min(max(ids[jb], 0), top) : 0);
      V ca[kEpochs], cb[kEpochs];
#pragma unroll
      for (int k = 0; k < kEpochs; ++k) {
        ca[k] = va && k < ne ? repro::load_count(counts + oa + k * epoch)
                             : V(0);
        cb[k] = vb && k < ne ? repro::load_count(counts + ob + k * epoch)
                             : V(0);
      }
      if constexpr (!kWeighted) {
#pragma unroll
        for (int k = 0; k < kEpochs; ++k)
          part[k] += static_cast<S>(ca[k]) + static_cast<S>(cb[k]);
      } else {
        const float ta = va ? tw[ja] : 0.0f, tb = vb ? tw[jb] : 0.0f;
#pragma unroll
        for (int k = 0; k < kEpochs; ++k) {
          prod[k * kTileStride + lane] =
              __fmul_rn(static_cast<float>(ca[k]), ta);
          prod[k * kTileStride + lane + 32] =
              __fmul_rn(static_cast<float>(cb[k]), tb);
        }
        __syncwarp();
        if (lane < ne) {
          const float* row = prod + lane * kTileStride;
          const int n = min(kPass, L - j0);
#pragma unroll 8
          for (int j = 0; j < n; ++j) run = __fadd_rn(run, row[j]);
        }
        __syncwarp();                      // the tile is free again
      }
    }
#pragma unroll
    for (int k = 0; k < kEpochs; ++k) {
      if (k < ne) {
        float s;
        if constexpr (kWeighted) {
          s = __shfl_sync(kFull, run, k);
        } else {
          s = repro::sum_to_float(repro::warp_sum(part[k]));
        }
        acc = __fadd_rn(acc, __fmul_rn(w[e0 + k], s));
      }
    }
  }
  if (lane == 0)
    scores[b] = kWeighted ? acc
                          : __fmul_rn(acc, __frcp_rn(static_cast<float>(L)));
}

}  // namespace

// counts (E, L, nbuckets) of the type `count_type` (repro::CountCode);
// buckets (B, L) int32; w (E,) fp32 epoch weights; tw (L,) fp32 table
// weights or null; scores (B,) fp32.  nbuckets is 64-bit (2^31 at K = 31).
// Needs B >= 1, 1 <= L <= 65535.
REPRO_API int repro_ace_window_combine(const void* counts, const int* buckets,
                                       const float* w, const float* tw,
                                       float* scores, int B, int E, int L,
                                       long long nbuckets, int count_type,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks =
      static_cast<unsigned int>((B + kRowsPerBlock - 1) / kRowsPerBlock);
  if (!repro::with_count_type(count_type, [&](auto tag) {
        using T = decltype(tag);
        const T* c = static_cast<const T*>(counts);
        if (tw != nullptr) {
          window_combine<T, true><<<blocks, kThreads, kTileBytes, s>>>(
              c, buckets, w, tw, scores, B, E, L, nbuckets);
        } else {
          window_combine<T, false><<<blocks, kThreads, 0, s>>>(
              c, buckets, w, tw, scores, B, E, L, nbuckets);
        }
      }))
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}
