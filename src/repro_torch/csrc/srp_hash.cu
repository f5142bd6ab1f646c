// SRP meta-hash: (B, d) @ (d, P) -> sign -> K-bit big-endian pack -> (B, L)
// int32 bucket ids.  Replaces the Pallas kernel of
// src/repro/kernels/srp_hash.py (srp_hash -> _srp_hash_impl).
//
// Bound on the H100: fp32 operations (2*B*d*K*L FLOP against 67 TFLOP/s
// outside the tensor cores; the bytes of x, W and the ids are small beside
// them).  Design: the block hash of srp_tile.cuh, one block per (16 rows x
// one group of whole tables), with sign and pack fused into the epilogue,
// so the (B, K*L) projection never reaches device memory.  The TPU
// kernel's PACK matmul is not carried over: the pack is integer shifts.

#include "srp_tile.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
srp_hash_kernel(const float* __restrict__ x, const float* __restrict__ w,
                int* __restrict__ out, int B, int d, int P, int K, int L) {
  __shared__ repro::SrpTileSmem sm;
  repro::srp_tile(x, w, B, d, P, K, L, sm, [&](int row, int j, int bucket) {
    out[static_cast<long long>(row) * L + j] = bucket;
  });
}

}  // namespace

// x (B, d), w (d, P) fp32; out (B, L) int32.  Needs 1 <= K <= 31, B >= 1.
REPRO_API int repro_srp_hash(const float* x, const float* w, int* out, int B,
                             int d, int P, int K, int L, void* stream) {
  srp_hash_kernel<<<repro::tile_grid(B, K, L), repro::kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, w, out, B, d, P,
                                                         K, L);
  return static_cast<int>(cudaGetLastError());
}
