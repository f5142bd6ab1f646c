// SRP meta-hash: (B, d) @ (d, P) -> sign -> K-bit big-endian pack -> (B, L)
// int32 bucket ids.  Replaces the Pallas kernel of
// src/repro/kernels/srp_hash.py (srp_hash -> _srp_hash_impl).
//
// Bound on the H100: fp32 operations (2*B*d*K*L FLOP against 67 TFLOP/s
// outside the tensor cores; the bytes of x, W and the ids are small beside
// them).  Design: the register-tiled block hash of srp_gemm.cuh, one
// block per (64 rows x one group of whole tables x one depth split), the
// splits of a tile one thread-block cluster that adds its partial tiles
// through distributed shared memory, with sign and pack fused into the
// epilogue, so the (B, K*L) projection never reaches device memory.  The
// launch plan comes from kernels/srp_hash.py (`hash_plan`).  The TPU
// kernel's PACK matmul is not carried over: the pack is a funnel shift.

#include "srp_gemm.cuh"

namespace {

template <bool kNarrow>
__global__ void __launch_bounds__(repro::gemm::kThreads,
                                  repro::gemm::min_blocks(kNarrow))
srp_hash_kernel(repro::gemm::Operands op, int* __restrict__ out, int B,
                int d, int P, int K, int L, repro::gemm::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  repro::gemm::srp_gemm_tile<kNarrow>(
      op, B, d, P, K, L, plan, smem, [&](int row, int j, int bucket) {
        out[static_cast<long long>(row) * L + j] = bucket;
      });
}

}  // namespace

// x (B, d), w (d, P), each fp32, bf16 or fp16 as x_type and w_type say
// (repro::OperandCode), w 16-byte aligned; out (B, L) int32.  The plan:
// rows, row_tiles, tables, groups, splits, then the splits + 1 depth
// bounds (b0..b8; the unused ones are ignored).  Needs 1 <= K <= 31,
// B >= 1; a plan that does not fit returns cudaErrorInvalidValue.
REPRO_API int repro_srp_hash(const void* x, const void* w, int* out, int B,
                             int d, int P, int K, int L, int rows,
                             int row_tiles, int tables, int groups,
                             int splits, int b0, int b1, int b2, int b3,
                             int b4, int b5, int b6, int b7, int b8,
                             int x_type, int w_type, void* stream) {
  const int bounds[] = {b0, b1, b2, b3, b4, b5, b6, b7, b8};
  const repro::gemm::Operands op{x, w, x_type, w_type};
  const repro::gemm::Plan plan = repro::gemm::make_plan(
      rows, row_tiles, tables, groups, splits, bounds);
  if (!repro::gemm::plan_fits(plan, op, B, d, K, L))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(repro::gemm::launch(
      op, srp_hash_kernel<false>, srp_hash_kernel<true>, plan,
      static_cast<cudaStream_t>(stream), op, out, B, d, P, K, L, plan));
}

// How many clusters of `splits` blocks the card runs at once, each block
// asking for `smem` bytes of dynamic shared memory (at least the
// kernel's); written to *clusters.  The plan's cluster size follows it
// (kernels/srp_hash.py device_clusters).
REPRO_API int repro_srp_hash_max_clusters(int splits, int smem,
                                          int* clusters) {
  const int bounds[repro::gemm::kMaxSplits + 1] = {};
  const repro::gemm::Plan plan = repro::gemm::make_plan(
      repro::gemm::kRows, 1, 1, 1, splits, bounds);
  return static_cast<int>(repro::gemm::max_active_clusters(
      srp_hash_kernel<false>, plan, smem, clusters));
}
