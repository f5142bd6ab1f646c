// The dense SRP hash of one block, redesigned for Hopper: sign bits of
// x @ W, packed K bits per table, MSB first.  Shared by srp_hash.cu,
// ace_admit_fused.cu, ace_fleet_window_admit.cu and ace_score_fused.cu
// (the last dense-hash kernel, ace_fleet_score.cu, still uses
// srp_tile.cuh).
//
// A block covers kRows = 64 rows of x and one group of whole tables (at
// most kCols = 128 projection columns) over one depth range of a launch
// plan made in Python (kernels/srp_hash.py `hash_plan`), which the kernel
// only reads.  Its 128 threads each hold an 8-row x 8-column micro-tile of
// fp32 FMA sums (64 accumulators) fed by 16-byte shared-memory reads, so a
// staged W value feeds 64 FMAs and an x value 128.  What bounds the main
// loop is the shared-memory read rate beside the FMA rate: a thread reads
// 16 floats a depth step for 64 FMAs, which about balances the two (an
// 8 x 4 micro-tile reads 12 floats for 32 FMAs and ran slower at
// d = 4097 with twice the warps).  The registers are held to three blocks
// an SM (~165, no spills): at 128, four an SM, the tile spills and runs
// slower (PERF.md).
//
// Staging: a ring of kStages slices of kBK depth steps in dynamic shared
// memory, filled with cp.async while earlier slices compute (one barrier
// a slice).  W rows are read in 16-byte copies (its row stride P*4 is a
// multiple of 512 and the tile starts on a 4-column boundary); x rows in
// 4-byte copies into a transposed slice, since a row stride of d*4 bytes
// (d = 4097) is no multiple of 16 and the x base need not be 16-byte
// aligned.  Copies past the split's depth, past row B or past column K*L
// are zero-filled and read nothing, so only the first K*L columns of the
// padded W are ever read.
//
// Depth split across a thread-block cluster: the S blocks of a cluster
// (S <= 8, grid x = S * row tiles) take contiguous depth ranges of the
// same (rows, tables) tile, so a skinny d = 4097 shape fills the card.
// At S = 1 (a plain launch, no cluster) the block holds the whole sum and
// takes the signs straight from its registers.  At S > 1 each block
// leaves its partial tile in its shared memory; after
// cluster.sync() block r reduces rows [r*64/S, (r+1)*64/S) by reading the
// partials of ranks 0..S-1 in rank order through distributed shared
// memory (map_shared_rank), takes the signs and packs its rows; a second
// cluster.sync() keeps every block's shared memory alive until all reads
// are done.  The partial projection never reaches device memory and the
// sum order is fixed (k in order inside a split, then ranks in order), so
// the ids are the same bits from run to run.  No TF32 anywhere: a TF32
// product flips sign bits.
//
// Epilogue: proj >= 0 gives bit 1 (sign(0) is bit 1, NaN bit 0, as in
// repro.core.srp.srp_bits).  Eight lanes OR their 4-bit nibbles into one
// 32-bit word of the row's 128-column sign mask (column c at bit
// 31 - c % 32 of word c / 32); each (row, table) then takes its K bits
// with one funnel shift and hands the bucket id to the caller's `emit`.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace repro {
namespace gemm {

constexpr int kRows = 64;                  // rows of x per block
constexpr int kCols = 128;                 // projection columns per block
constexpr int kTM = 8, kTN = 8;            // a thread's micro-tile
constexpr int kThreads = kRows / kTM * (kCols / kTN);   // 128
constexpr int kMinBlocks = 3;              // blocks an SM the registers allow
constexpr int kBK = 16;                    // depth steps of one staged slice
constexpr int kStages = 4;                 // slices in flight
constexpr int kMaxSplits = 8;              // portable cluster size
constexpr int kXStride = kRows + 4;        // transposed x slice row
constexpr int kMaskWords = kCols / 32 + 1; // + a zero word for the shift
// A thread's rows are two runs of 4, kRowStep apart; its columns two runs
// of 4, kColStep apart.
constexpr int kColThreads = kCols / kTN;
constexpr int kRowStep = kRows / 2, kColStep = kCols / 2;

static_assert(kRows * kBK % kThreads == 0 && kBK * kCols / 4 % kThreads == 0,
              "every thread stages the same number of copies");

struct Stage {
  float x[kBK][kXStride];   // x slice, transposed: x[k][row]
  float w[kBK][kCols];      // W slice: w[k][column - tile start]
};

constexpr size_t kRingBytes = sizeof(Stage) * kStages;
constexpr size_t kPartBytes = sizeof(float) * kRows * kCols;
constexpr size_t kMainBytes = kRingBytes > kPartBytes ? kRingBytes
                                                      : kPartBytes;
constexpr size_t kSmemBytes =
    kMainBytes + sizeof(unsigned) * kRows * kMaskWords;

// The launch plan (kernels/srp_hash.py HashPlan), passed by value.  Block
// (x, y) takes row tile x / splits, split x % splits (its cluster rank)
// and tables y * tables .. of the group; split s covers depth
// bounds[s] .. bounds[s + 1].
struct Plan {
  int rows, row_tiles, tables, groups, splits;
  int bounds[kMaxSplits + 1];
};

// True when the plan covers (B, d, K, L) as the kernel assumes: every
// group's live columns fit in one 128-column tile that starts on a
// 4-column boundary, the splits partition [0, d) in order, there are at
// most 8 of them, and W is 16-byte aligned.
inline bool plan_fits(const Plan& p, const float* w, int B, int d, int K,
                      int L) {
  if (reinterpret_cast<unsigned long long>(w) % 16 != 0) return false;
  if (p.rows != kRows || p.row_tiles != (B + kRows - 1) / kRows) return false;
  if (p.splits < 1 || p.splits > kMaxSplits) return false;
  if (p.tables < 1 || p.groups != (L + p.tables - 1) / p.tables ||
      p.groups > 65535)
    return false;
  if (p.bounds[0] != 0 || p.bounds[p.splits] != d) return false;
  for (int s = 0; s < p.splits; ++s)
    if (p.bounds[s] > p.bounds[s + 1]) return false;
  for (int g = 0; g < p.groups; ++g) {
    const int t0 = g * p.tables, n = std::min(p.tables, L - t0);
    if ((t0 * K) % 4 + n * K > kCols) return false;
  }
  return true;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes, or zeros when !valid (nothing is read then).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes of which the first `bytes` are read, the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The sign bits of 4 columns (proj >= 0 gives bit 1), as the nibble at
// `slot` (0 = the top) of their 32-column mask word, ORed with those of
// lanes ^ 1, 2, 4, which hold the word's other 28 columns.
__device__ __forceinline__ unsigned sign_word(float a, float b, float c,
                                              float d, int slot) {
  const unsigned nib = (a >= 0.0f ? 8u : 0u) | (b >= 0.0f ? 4u : 0u) |
                       (c >= 0.0f ? 2u : 0u) | (d >= 0.0f ? 1u : 0u);
  unsigned word = nib << (28 - 4 * slot);
  word |= __shfl_xor_sync(0xffffffffu, word, 1);
  word |= __shfl_xor_sync(0xffffffffu, word, 2);
  word |= __shfl_xor_sync(0xffffffffu, word, 4);
  return word;
}

// x (B, d) and w (d, P) row-major fp32; `smem` holds kSmemBytes of
// dynamic shared memory aligned to 16.  emit(row, table, bucket) is called
// once per live (row, table) of the block's rows.
template <typename Emit>
__device__ __forceinline__ void srp_gemm_tile(const float* __restrict__ x,
                                              const float* __restrict__ w,
                                              int B, int d, int P, int K,
                                              int L, const Plan& plan,
                                              unsigned char* smem,
                                              Emit emit) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = plan.splits;
  const int split = static_cast<int>(cluster.block_rank());  // x % S
  const int row0 = (blockIdx.x / S) * kRows;
  const int table0 = blockIdx.y * plan.tables;
  const int ntab = min(plan.tables, L - table0);
  const int c0 = table0 * K;              // the group's first column
  const int a0 = c0 & ~3;                 // the tile's first column
  const int shift = c0 - a0;
  const int KL = K * L;
  int k_begin = 0, k_end = 0;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s == split) k_begin = plan.bounds[s], k_end = plan.bounds[s + 1];
  const int nslices = (k_end - k_begin + kBK - 1) / kBK;

  Stage* ring = reinterpret_cast<Stage*>(smem);
  const int tid = threadIdx.x;

  auto load_slice = [&](int s) {
    Stage& st = ring[s % kStages];
    const int kb = k_begin + s * kBK;
#pragma unroll
    for (int e = 0; e < kRows * kBK / kThreads; ++e) {
      const int i = tid + e * kThreads, k = i % kBK, r = i / kBK;
      const bool ok = row0 + r < B && kb + k < k_end;
      cp_async4(&st.x[k][r],
                ok ? x + static_cast<long long>(row0 + r) * d + kb + k : x,
                ok);
    }
#pragma unroll
    for (int e = 0; e < kBK * kCols / 4 / kThreads; ++e) {
      const int i = tid + e * kThreads;
      const int k = i / (kCols / 4), c4 = i % (kCols / 4);
      const int col = a0 + 4 * c4;
      const int bytes = kb + k < k_end ? 4 * min(max(KL - col, 0), 4) : 0;
      cp_async16(&st.w[k][4 * c4],
                 bytes ? w + static_cast<long long>(kb + k) * P + col : w,
                 bytes);
    }
  };

  // Thread (ty, tx): rows g * kRowStep + 4 ty .. + 3, columns
  // h * kColStep + 4 tx .. + 3.  A quarter-warp shares ty and takes 8
  // consecutive tx, so its x reads are one broadcast and its W reads 128
  // contiguous bytes: 16-byte reads without bank conflicts.
  const int ty = tid / kColThreads, tx = tid % kColThreads;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslices) load_slice(s);
    cp_async_commit();
  }
  for (int s = 0; s < nslices; ++s) {
    cp_async_wait<kStages - 2>();   // slice s has landed
    __syncthreads();                // and slice s - 1 is no longer read
    if (s + kStages - 1 < nslices) load_slice(s + kStages - 1);
    cp_async_commit();
    const Stage& st = ring[s % kStages];
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int g = 0; g < kTM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            &st.x[k][g * kRowStep + 4 * ty]);
        a[4 * g] = v.x, a[4 * g + 1] = v.y, a[4 * g + 2] = v.z,
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < kTN / 4; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            &st.w[k][h * kColStep + 4 * tx]);
        b[4 * h] = v.x, b[4 * h + 1] = v.y, b[4 * h + 2] = v.z,
        b[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                  // the ring is free for the partial

  unsigned* mask = reinterpret_cast<unsigned*>(smem + kMainBytes);
  const int rb = split * kRows / S, nr = (split + 1) * kRows / S - rb;
  if (S == 1) {
    // The block holds the whole sum: the sign masks come straight from
    // the registers.  Lanes tx ^ 1, 2, 4 share a row and a mask word.
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = (i / 4) * kRowStep + 4 * ty + i % 4;
#pragma unroll
      for (int h = 0; h < kTN / 4; ++h) {
        const unsigned word = sign_word(acc[i][4 * h], acc[i][4 * h + 1],
                                        acc[i][4 * h + 2], acc[i][4 * h + 3],
                                        tx % 8);
        if (tx % 8 == 0)
          mask[r * kMaskWords + (h * kColStep + 4 * tx) / 32] = word;
      }
      if (tx == 0) mask[r * kMaskWords + kCols / 32] = 0u;
    }
    __syncthreads();
  } else {
    float* part = reinterpret_cast<float*>(smem);   // [kRows][kCols]
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int h = 0; h < kTN / 4; ++h)
        *reinterpret_cast<float4*>(
            &part[((i / 4) * kRowStep + 4 * ty + i % 4) * kCols +
                  h * kColStep + 4 * tx]) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    cluster.sync();                 // every rank's partial is written

    // This block's rows, summed over the ranks in order through
    // distributed shared memory, as sign masks.  A row is 32 items of 4
    // columns, one a lane.
    for (int i = tid; i < nr * (kCols / 4); i += kThreads) {
      const int r = rb + i / (kCols / 4), c4 = i % (kCols / 4);
      const int off = r * kCols + 4 * c4;
      float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, 0) + off);
      for (int q = 1; q < S; ++q) {
        const float4 p = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + off);
        v.x = __fadd_rn(v.x, p.x);
        v.y = __fadd_rn(v.y, p.y);
        v.z = __fadd_rn(v.z, p.z);
        v.w = __fadd_rn(v.w, p.w);
      }
      const unsigned word = sign_word(v.x, v.y, v.z, v.w, c4 % 8);
      if (c4 % 8 == 0) mask[r * kMaskWords + c4 / 8] = word;
      if (c4 == 0) mask[r * kMaskWords + kCols / 32] = 0u;
    }
    cluster.sync();                 // all partials read; masks visible
  }

  for (int i = tid; i < nr * ntab; i += kThreads) {
    const int r = rb + i / ntab, t = i % ntab;
    if (row0 + r >= B) continue;
    const int s = shift + t * K;    // the table's first tile column
    const unsigned* m = mask + r * kMaskWords + s / 32;
    const unsigned top = __funnelshift_l(m[1], m[0], s % 32);
    emit(row0 + r, table0 + t, static_cast<int>(top >> (32 - K)));
  }
}

// The launch configuration of the plan: S-block clusters along x.
struct LaunchConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  LaunchConfig(const Plan& plan, int smem, cudaStream_t stream) : cfg{} {
    cfg.gridDim = dim3(plan.splits * plan.row_tiles, plan.groups, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = plan.splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Launch `kernel` (whose parameters the caller passes in `args`) on the
// plan's grid.  Returns the launch's error; the plan must fit.
template <typename... Params, typename... Args>
inline cudaError_t launch(void (*kernel)(Params...), const Plan& plan,
                          cudaStream_t stream, Args&&... args) {
  cudaError_t err = repro::allow_smem(reinterpret_cast<const void*>(kernel),
                                      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  LaunchConfig lc(plan, static_cast<int>(kSmemBytes), stream);
  if (plan.splits == 1) lc.cfg.numAttrs = 0;   // no cluster launch
  return cudaLaunchKernelEx(&lc.cfg, kernel, std::forward<Args>(args)...);
}

// How many of the plan's clusters the card runs at once when a block
// asks for `smem` bytes of dynamic shared memory (at least the kernel's).
// The kernel's own limit is restored before it returns.
template <typename... Params>
inline cudaError_t max_active_clusters(void (*kernel)(Params...),
                                       const Plan& plan, int smem,
                                       int* clusters) {
  smem = std::max(smem, static_cast<int>(kSmemBytes));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  LaunchConfig lc(plan, smem, nullptr);
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &lc.cfg);
  const cudaError_t restore = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  return err != cudaSuccess ? err : restore;
}

// The plan from the C entry points' plain int arguments.
inline Plan make_plan(int rows, int row_tiles, int tables, int groups,
                      int splits, const int* bounds) {
  Plan p{rows, row_tiles, tables, groups, splits, {}};
  for (int s = 0; s <= kMaxSplits; ++s) p.bounds[s] = bounds[s];
  return p;
}

}  // namespace gemm
}  // namespace repro
