// Fused windowed-fleet admission: hash -> tail and live-epoch gathers ->
// PRE-insert score (tail + live) * (1/L) -> per-tenant threshold -> masked
// insert into each admitted item's tenant's live epoch, ring updated in
// place.  Replaces the Pallas kernel of
// src/repro/kernels/ace_fleet_window_admit.py
// (ace_fleet_window_admit_fused -> _admit_fused_impl).
//
// Bound on the H100: fp32 operations of the hash (2*B*d*K*L FLOP; at
// B = 256, d = 4097, K = 15, L = 50 that is 1.57 GFLOP, 23 us at
// 67 TFLOP/s); the ring (T*E*L*2^K int32) and the tails (T*L*2^K fp32)
// stay where they are and only the counters the batch touches move.
//
// Design: ace_admit_fused.cu's, two kernels on one stream.
//   Phase 1 (fwa_hash_gather): the srp_gemm.cuh hash, as in srp_hash.cu
//     (64-row x table-group tiles, the depth split across a thread-block
//     cluster by the launch plan of kernels/srp_hash.py, so its ids are
//     srp_hash's bits under the same plan), whose epilogue writes each
//     bucket id and gathers, for item b of tenant t with live epoch
//     c = cursor[t], the tail value tail[(t*L + j) * 2^K + bucket] and the
//     live counter ring[((t*E + c)*L + j) * 2^K + bucket].  No counter is
//     written in this phase.
//   Phase 2 (fwa_score_insert): a warp a row.  Lane 0 sums the row's tail
//     and live gathers in table order (__fadd_rn), forms (tail + live) *
//     (1/L) as the reference's ring.score_live does, compares with thr[t]
//     read from device memory (no host sync), gates on the item mask and
//     writes score, verdict and both sums; for an admitted row the warp's
//     lanes then add 1 at its L live-epoch counters, a table a lane.
// Stream order puts every gather before any insert: all scores are taken
// against the ring as it was before the batch, also when copies of one
// row go to one tenant.  The cursor indirection is a read inside the
// kernel, so the host never learns a cursor.  The TPU kernel's one-tile
// batch, lane-broadcast routing blocks and VMEM guard do not apply.
// Rings are int32, int16, int8 or float32 (common.cuh's count trait):
// phase 1 reads each live counter as fp32 (narrow ones sign-extended,
// exact), phase 2 adds 1 in the ring's own type (repro::add_count: narrow
// adds wrap past the dtype max, as the reference's do); the tails are
// fp32 whatever the ring.  A row whose tenant id lies outside [0, T)
// gathers zeros and never inserts: nothing outside the ring is read or
// written.
// Offsets are 64-bit.

#include "srp_gemm.cuh"

namespace {

template <typename Cnt>
__global__ void __launch_bounds__(repro::gemm::kThreads,
                                  repro::gemm::kMinBlocks)
fwa_hash_gather(const Cnt* __restrict__ ring, const float* __restrict__ tail,
                const int* __restrict__ cursor, const float* __restrict__ q,
                const float* __restrict__ w,
                const int* __restrict__ tenant_ids, int* __restrict__ buckets,
                float* __restrict__ tail_g, float* __restrict__ live_g, int B,
                int d, int P, int K, int L, int E, int T,
                repro::gemm::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long nbuckets = 1LL << K;
  repro::gemm::srp_gemm_tile(
      q, w, B, d, P, K, L, plan, smem, [&](int row, int j, int bucket) {
        const long long o = static_cast<long long>(row) * L + j;
        buckets[o] = bucket;
        const int t = tenant_ids[row];
        if (t < 0 || t >= T) {
          tail_g[o] = 0.0f;
          live_g[o] = 0.0f;
          return;
        }
        tail_g[o] = tail[(static_cast<long long>(t) * L + j) * nbuckets
                         + bucket];
        const long long r =
            (static_cast<long long>(t) * E + cursor[t]) * L + j;
        live_g[o] = static_cast<float>(
            repro::load_count(ring + r * nbuckets + bucket));
      });
}

constexpr int kInsertRows = 8;             // phase 2: a warp a row

template <typename Cnt>
__global__ void __launch_bounds__(32 * kInsertRows)
fwa_score_insert(Cnt* __restrict__ ring,
                                 const int* __restrict__ cursor,
                                 const int* __restrict__ tenant_ids,
                                 const int* __restrict__ buckets,
                                 const float* __restrict__ tail_g,
                                 const float* __restrict__ live_g,
                                 const float* __restrict__ thr,
                                 const unsigned char* __restrict__ item_mask,
                                 float* __restrict__ scores,
                                 unsigned char* __restrict__ admit,
                                 float* __restrict__ tail_sums,
                                 float* __restrict__ live_pre, int B, int L,
                                 int E, int T, int K, float inv_l) {
  const int lane = threadIdx.x % 32;
  const long long row =
      static_cast<long long>(blockIdx.x) * kInsertRows + threadIdx.x / 32;
  if (row >= B) return;                    // the whole warp leaves
  const long long base = row * L;
  const int t = tenant_ids[row];
  int a = 0;
  if (lane == 0) {
    const float ts = repro::table_order_sum(tail_g + base, L);
    const float ls = repro::table_order_sum(live_g + base, L);
    const float s = __fmul_rn(__fadd_rn(ts, ls), inv_l);
    a = t >= 0 && t < T && (item_mask == nullptr || item_mask[row])
        && s >= thr[t];
    scores[row] = s;
    tail_sums[row] = ts;
    live_pre[row] = ls;
    admit[row] = a ? 1 : 0;
  }
  if (!__shfl_sync(0xffffffffu, a, 0)) return;
  const long long nbuckets = 1LL << K;
  const long long r0 = (static_cast<long long>(t) * E + cursor[t]) * L;
  for (int j = lane; j < L; j += 32)
    repro::add_count(ring + (r0 + j) * nbuckets + buckets[base + j], 1);
}

}  // namespace

// ring (T, E, L, 2^K) of the type `count_type` (repro::CountCode; int8
// rings 4-byte aligned), updated in place; tail (T, L, 2^K) fp32;
// cursor (T,) int32; q (B, d), w (d, P) fp32, w 16-byte aligned;
// tenant_ids (B,) int32; thr (T,) fp32 per-tenant score-space thresholds;
// item_mask (B,) bool or null.  Outputs: buckets (B, L) int32, scores,
// tail_sums, live_pre (B,) fp32, admit (B,) bool; tail_g and live_g (B, L)
// fp32 are scratch.  The hash's plan as in repro_srp_hash.  Needs
// 1 <= K <= 31, B >= 1; a plan that does not fit returns
// cudaErrorInvalidValue.
REPRO_API int repro_ace_fleet_window_admit(
    void* ring, const float* tail, const int* cursor, const float* q,
    const float* w, const int* tenant_ids, const float* thr,
    const unsigned char* item_mask, int* buckets, float* tail_g,
    float* live_g, float* scores, unsigned char* admit, float* tail_sums,
    float* live_pre, int B, int d, int P, int K, int L, int E, int T,
    float inv_l, int rows, int row_tiles, int tables, int groups,
    int splits, int b0, int b1, int b2, int b3, int b4, int b5, int b6,
    int b7, int b8, int count_type, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bounds[] = {b0, b1, b2, b3, b4, b5, b6, b7, b8};
  const repro::gemm::Plan plan = repro::gemm::make_plan(
      rows, row_tiles, tables, groups, splits, bounds);
  if (!repro::gemm::plan_fits(plan, w, B, d, K, L))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (!repro::with_count_type(count_type, [&](auto tag) {
        using C = decltype(tag);
        C* r = static_cast<C*>(ring);
        err = repro::gemm::launch(fwa_hash_gather<C>, plan, s, r, tail,
                                  cursor, q, w, tenant_ids, buckets, tail_g,
                                  live_g, B, d, P, K, L, E, T, plan);
        if (err != cudaSuccess) return;
        fwa_score_insert<C><<<(B + kInsertRows - 1) / kInsertRows,
                              32 * kInsertRows, 0, s>>>(
            r, cursor, tenant_ids, buckets, tail_g, live_g, thr, item_mask,
            scores, admit, tail_sums, live_pre, B, L, E, T, K, inv_l);
        err = cudaGetLastError();
      }))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}
