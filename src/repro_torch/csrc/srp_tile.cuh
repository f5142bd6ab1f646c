// The dense SRP hash of one block: sign bits of x @ W, packed K bits per
// table, MSB first.  Shared by ace_score_fused.cu and ace_fleet_score.cu;
// the other three dense-hash kernels run on srp_gemm.cuh.
//
// A block covers kBM = 16 rows of x and one group of whole tables: as
// many K-bit tables as fit in kCols = 128 projection columns (8 tables =
// 120 columns at K = 15).  Its 512 threads are 4 k-groups of 128, one
// thread per column in each.  The loop over d stages a (kBK x kBM) slice
// of x in shared memory; k-group g takes depth steps 16g .. 16g+15 of
// each slice, reads its column of W straight from global memory
// (coalesced across the warp) and the 16 rows of x as broadcast float4
// reads, and keeps 16 fp32 FMA sums in registers.  The loop is
// software-pipelined: slice s+1's x values and W steps are loaded into
// registers while slice s is computed (x double-buffered in shared
// memory, one barrier per slice), so the loads' latency hides behind the
// arithmetic even when a small admission batch gives an SM a single
// block, which the four k-groups fill with 16 warps.  Their partial sums
// meet in shared memory and are added in k-group order 0..3, so the
// result is deterministic.  No TF32 anywhere: a TF32 product flips sign
// bits.  Only the first K*L columns of the padded W are read.
//
// The epilogue takes the sign (proj >= 0 -> 1, so sign(0) is bit 1 and
// NaN is bit 0, as in repro.core.srp.srp_bits) into shared memory, and one
// thread per (row, table) packs K bits and hands the bucket id to the
// caller's `emit`.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kCols = 128;                 // projection columns per block
constexpr int kGroups = 4;                 // k-groups of kCols threads
constexpr int kThreads = kCols * kGroups;  // 512
constexpr int kBM = 16;                    // rows of x per block
constexpr int kBK = 64;                    // depth of one staged x slice
constexpr int kKG = kBK / kGroups;         // depth steps per k-group
constexpr int kXStride = kBM + 4;          // float4-aligned, spreads banks
constexpr int kXPer = kBM * kBK / kThreads;  // x values a thread stages

struct SrpTileSmem {
  alignas(16) float xs[2][kBK][kXStride];  // x slices, transposed
  float part[kGroups][kBM][kCols];         // per-k-group partial sums
  unsigned char bits[kBM][kCols];          // sign bits of the block
};

// Tables per block at K bits each (the wrappers keep 1 <= K <= 31).
__host__ __device__ inline int tables_per_block(int K) { return kCols / K; }

// Blocks along each axis of the grid: (row tiles, table groups).
inline dim3 tile_grid(int B, int K, int L) {
  const int tg = tables_per_block(K);
  return dim3((B + kBM - 1) / kBM, (L + tg - 1) / tg);
}

// x (B, d) and w (d, P) row-major fp32.  The block's rows are
// blockIdx.x * kBM ..; its tables blockIdx.y * tables_per_block(K) ..;
// rows >= B and tables >= L are skipped.  emit(row, table, bucket) is
// called once per live (row, table).
template <typename Emit>
__device__ __forceinline__ void srp_tile(const float* __restrict__ x,
                                         const float* __restrict__ w, int B,
                                         int d, int P, int K, int L,
                                         SrpTileSmem& sm, Emit emit) {
  const int tid = threadIdx.x;
  const int col = tid % kCols, g = tid / kCols;
  const int row0 = blockIdx.x * kBM;
  const int table0 = blockIdx.y * tables_per_block(K);
  const int ntab = min(tables_per_block(K), L - table0);
  const bool live = col < ntab * K;
  const float* wcol = w + table0 * K + col;   // W[k, column] = wcol[k * P]

  float acc[kBM];
#pragma unroll
  for (int m = 0; m < kBM; ++m) acc[m] = 0.0f;

  // Slice s covers depth k0 = s * kBK ..; the registers below hold the
  // next slice's x values and W column steps while the current computes.
  float xr[kXPer], wcur[kKG], wnext[kKG];
  const int nslices = (d + kBK - 1) / kBK;
#pragma unroll
  for (int e = 0; e < kXPer; ++e) {
    const int i = tid + e * kThreads, r = i / kBK, k = i % kBK;
    xr[e] = (row0 + r < B && k < d)
                ? x[static_cast<long long>(row0 + r) * d + k] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kKG; ++u) {
    const int k = g * kKG + u;
    wcur[u] = (live && k < d)
                  ? __ldg(wcol + static_cast<long long>(k) * P) : 0.0f;
  }

  for (int s = 0; s < nslices; ++s) {
    float(*xs)[kXStride] = sm.xs[s & 1];
#pragma unroll
    for (int e = 0; e < kXPer; ++e) {
      const int i = tid + e * kThreads;
      xs[i % kBK][i / kBK] = xr[e];
    }
    __syncthreads();
    const int k1 = (s + 1) * kBK;            // the next slice's first step
    if (s + 1 < nslices) {
#pragma unroll
      for (int e = 0; e < kXPer; ++e) {
        const int i = tid + e * kThreads, r = i / kBK, k = k1 + i % kBK;
        xr[e] = (row0 + r < B && k < d)
                    ? x[static_cast<long long>(row0 + r) * d + k] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kKG; ++u) {
        const int k = k1 + g * kKG + u;
        wnext[u] = (live && k < d)
                       ? __ldg(wcol + static_cast<long long>(k) * P) : 0.0f;
      }
    }
    if (live && s * kBK + g * kKG < d) {
#pragma unroll
      for (int u = 0; u < kKG; ++u) {
        const float* xrow = xs[g * kKG + u];
#pragma unroll
        for (int m = 0; m < kBM; m += 4) {
          const float4 a = *reinterpret_cast<const float4*>(xrow + m);
          acc[m + 0] = fmaf(a.x, wcur[u], acc[m + 0]);
          acc[m + 1] = fmaf(a.y, wcur[u], acc[m + 1]);
          acc[m + 2] = fmaf(a.z, wcur[u], acc[m + 2]);
          acc[m + 3] = fmaf(a.w, wcur[u], acc[m + 3]);
        }
      }
    }
    if (s + 1 < nslices) {
#pragma unroll
      for (int u = 0; u < kKG; ++u) wcur[u] = wnext[u];
    }
  }

#pragma unroll
  for (int m = 0; m < kBM; ++m) sm.part[g][m][col] = acc[m];
  __syncthreads();
  if (g == 0) {
#pragma unroll
    for (int m = 0; m < kBM; ++m) {
      float sum = sm.part[0][m][col];
#pragma unroll
      for (int gg = 1; gg < kGroups; ++gg) sum += sm.part[gg][m][col];
      sm.bits[m][col] = sum >= 0.0f ? 1 : 0;
    }
  }
  __syncthreads();

  for (int i = tid; i < kBM * ntab; i += kThreads) {
    const int r = i / ntab, t = i % ntab;
    const int row = row0 + r;
    if (row >= B) continue;
    unsigned int bucket = 0;
    for (int k = 0; k < K; ++k) bucket = (bucket << 1) | sm.bits[r][t * K + k];
    emit(row, table0 + t, static_cast<int>(bucket));
  }
}

}  // namespace repro
