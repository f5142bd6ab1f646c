// The dense SRP hash of one block, redesigned for Hopper: sign bits of
// x @ W, packed K bits per table, MSB first.  Shared by every dense-hash
// kernel: srp_hash.cu, ace_admit_fused.cu, ace_score_fused.cu,
// ace_fleet_score.cu and ace_fleet_window_admit.cu.
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
// Operand types: x and W are each float32, bfloat16 or float16 (common.cuh
// OperandCode), as the Pallas kernels take them.  srp_hash.cu and
// ace_admit_fused.cu run a pair of one 2-byte type on the tensor-core tile
// at the end of this file (srp_tc_tile, `route`); every other pair with a
// 2-byte operand, and every one in the other three kernels, runs here:
// every element is widened
// to float32 before it is read, so the slices, the micro-tile, the depth
// split and the epilogue are the float32 kernel's, and the ids of narrow
// operands are the float32 kernel's ids of the widened values.  The tile
// is instantiated twice (kNarrow; `launch` takes both and picks by the
// operand types): the float32 one carries no code of the narrow path, so
// its registers, shared memory and schedule are the float32 kernel's
// alone.  In the narrow one a 2-byte operand is copied raw with cp.async
// into its slice's ring slot, in the same pipeline as a float32 copy, and
// once the slice has landed it is widened into one of two extra float32
// slices (`wide`, past the masks) that the micro-tile reads (a float32
// operand of a mixed pair is copied there): slice s + 1 is widened into
// one while slice s is computed from the other, so the loop keeps one
// barrier a slice and no register is held across the compute.  It runs
// two blocks an SM, not three, so that the staging code fits the
// registers without spills.  W's 4-column pieces are 8-byte copies (the
// row stride P*2 is a multiple of 256, the piece starts on a 4-column
// boundary); an x row's kBK elements are kXWords aligned 4-byte words,
// since a 2-byte row (d = 4097) starts on any 2-byte boundary, below
// cp.async's 4-byte minimum: the word that holds the first element, and
// the next ones.  Bytes past the slice's last element, past row B or past
// column K*L are zero-filled and read nothing.
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
constexpr int kNarrowMinBlocks = 2;        // the same with kNarrow
constexpr int kBK = 16;                    // depth steps of one staged slice
constexpr int kStages = 4;                 // slices in flight
constexpr int kMaxSplits = 8;              // portable cluster size
constexpr int kXStride = kRows + 4;        // transposed x slice row
constexpr int kMaskWords = kCols / 32 + 1; // + a zero word for the shift
// 4-byte words that hold kBK 2-byte elements from any 2-byte boundary.
constexpr int kXWords = kBK / 2 + 1;
constexpr int kXCopies = (kRows * kXWords + kThreads - 1) / kThreads;
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
// Where a 2-byte operand lands before it is widened: x row r's words at
// word kXWords * r of the slot's x slice; W row k's kCols elements at
// element kCols * k of its w slice.
static_assert(sizeof(unsigned) * kRows * kXWords <=
                  sizeof(float) * kBK * kXStride,
              "a raw x slice fits in its float32 slot");

constexpr size_t kRingBytes = sizeof(Stage) * kStages;
constexpr size_t kPartBytes = sizeof(float) * kRows * kCols;
constexpr size_t kMainBytes = kRingBytes > kPartBytes ? kRingBytes
                                                      : kPartBytes;
constexpr size_t kSmemBytes =
    kMainBytes + sizeof(unsigned) * kRows * kMaskWords;
// The launch bounds' blocks an SM of an instantiation: the narrow tile's
// staging code does not fit 168 registers without spills.
constexpr int min_blocks(bool narrow) {
  return narrow ? kNarrowMinBlocks : kMinBlocks;
}

// The narrow instantiation's: two widened slices after the masks.
constexpr size_t kNarrowSmemBytes = kSmemBytes + 2 * sizeof(Stage);
static_assert(kSmemBytes % 16 == 0, "the widened slice is 16-byte aligned");

// The two operands, x (B, d) and W (d, P), row-major, each of the type of
// its code (repro::OperandCode); passed by value.
struct Operands {
  const void* x;
  const void* w;
  int x_type, w_type;
};

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
// most 8 of them, W is 16-byte aligned and both operand types are known.
inline bool plan_fits(const Plan& p, const Operands& op, int B, int d, int K,
                      int L) {
  if (reinterpret_cast<unsigned long long>(op.w) % 16 != 0) return false;
  if (!operand_code_ok(op.x_type) || !operand_code_ok(op.w_type))
    return false;
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

// 4 bytes of which the first `bytes` are read, the rest zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 8 bytes of which the first `bytes` are read, the rest zero-filled.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
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

// The operands x (B, d) and w (d, P); `smem` holds kSmemBytes of dynamic
// shared memory aligned to 16 (kNarrowSmemBytes with kNarrow).
// emit(row, table, bucket) is called once per live (row, table) of the
// block's rows.
template <bool kNarrow, typename Emit>
__device__ __forceinline__ void srp_gemm_tile(const Operands& op, int B,
                                              int d, int P, int K, int L,
                                              const Plan& plan,
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

  const float* __restrict__ xf = static_cast<const float*>(op.x);
  const float* __restrict__ wf = static_cast<const float*>(op.w);
  const unsigned short* __restrict__ x16 =
      static_cast<const unsigned short*>(op.x);
  const unsigned short* __restrict__ w16 =
      static_cast<const unsigned short*>(op.w);
  const bool x_narrow = kNarrow && op.x_type != kOpFloat32;
  const bool w_narrow = kNarrow && op.w_type != kOpFloat32;
  Stage* wide = reinterpret_cast<Stage*>(smem + kSmemBytes);
  // A 4-byte-aligned address for the x copies that read nothing, and the
  // half of its first raw word at which a narrow x row's slice starts:
  // the parity of the element's address in halves (kb = k_begin mod 2).
  const void* x_none = reinterpret_cast<const void*>(
      reinterpret_cast<unsigned long long>(op.x) & ~3ull);
  const int x_par = static_cast<int>(
      (reinterpret_cast<unsigned long long>(op.x) >> 1) + k_begin) & 1;
  auto x_skew = [&](int r) { return (x_par + ((row0 + r) & d)) & 1; };
  auto load_slice = [&](int s) {
    Stage& st = ring[s % kStages];
    const int kb = k_begin + s * kBK;
    if (!x_narrow) {
#pragma unroll
      for (int e = 0; e < kRows * kBK / kThreads; ++e) {
        const int i = tid + e * kThreads, k = i % kBK, r = i / kBK;
        const bool ok = row0 + r < B && kb + k < k_end;
        cp_async4(&st.x[k][r],
                  ok ? xf + static_cast<long long>(row0 + r) * d + kb + k
                     : xf,
                  ok ? 4 : 0);
      }
    } else {
      // Word q of row r holds the row's elements 2q - skew and the next.
      unsigned* raw = reinterpret_cast<unsigned*>(&st.x[0][0]);
      const int live = min(kBK, k_end - kb);
#pragma unroll
      for (int e = 0; e < kXCopies; ++e) {
        const int i = tid + e * kThreads, r = i / kXWords, q = i % kXWords;
        if (i >= kRows * kXWords) break;
        int bytes = 0;
        const void* src = x_none;
        if (row0 + r < B) {
          const int first = 2 * q - x_skew(r);   // -1 .. 2 kXWords - 2
          bytes = first + 1 < live ? 4 : first < live ? 2 : 0;
          if (bytes)
            src = x16 + static_cast<long long>(row0 + r) * d + kb + first;
        }
        cp_async4(raw + i, src, bytes);
      }
    }
#pragma unroll
    for (int e = 0; e < kBK * kCols / 4 / kThreads; ++e) {
      const int i = tid + e * kThreads;
      const int k = i / (kCols / 4), c4 = i % (kCols / 4);
      const int col = a0 + 4 * c4;
      const int n = kb + k < k_end ? min(max(KL - col, 0), 4) : 0;
      const long long at = static_cast<long long>(kb + k) * P + col;
      if (!w_narrow)
        cp_async16(&st.w[k][4 * c4], n ? wf + at : wf, 4 * n);
      else
        cp_async8(reinterpret_cast<unsigned short*>(&st.w[0][0]) +
                      kCols * k + 4 * c4,
                  n ? w16 + at : w16, 2 * n);
    }
  };
  // Slice s into wide[s % 2], where the narrow instantiation's micro-tile
  // reads it: a narrow operand widened from its raw copy, a float32 one
  // (a mixed pair) copied as it is.
  auto widen_slice = [&](int s) {
    const Stage& st = ring[s % kStages];
    Stage* out = wide + s % 2;
    if (!x_narrow) {
#pragma unroll
      for (int e = 0; e < kRows * kBK / 4 / kThreads; ++e) {
        const int i = tid + e * kThreads;
        const int k = i / (kRows / 4), r4 = 4 * (i % (kRows / 4));
        *reinterpret_cast<float4*>(&out->x[k][r4]) =
            *reinterpret_cast<const float4*>(&st.x[k][r4]);
      }
    } else {
      const unsigned short* raw =
          reinterpret_cast<const unsigned short*>(&st.x[0][0]);
      const int r = tid % kRows, skew = row0 + r < B ? x_skew(r) : 0;
#pragma unroll
      for (int e = 0; e < kRows * kBK / kThreads; ++e) {
        const int k = (tid + e * kThreads) / kRows;
        out->x[k][r] = widen16(raw[2 * kXWords * r + skew + k], op.x_type);
      }
    }
    if (!w_narrow) {
#pragma unroll
      for (int e = 0; e < kBK * kCols / 4 / kThreads; ++e) {
        const int i = tid + e * kThreads;
        const int k = i / (kCols / 4), c4 = 4 * (i % (kCols / 4));
        *reinterpret_cast<float4*>(&out->w[k][c4]) =
            *reinterpret_cast<const float4*>(&st.w[k][c4]);
      }
    } else {
      const unsigned short* raw =
          reinterpret_cast<const unsigned short*>(&st.w[0][0]);
#pragma unroll
      for (int e = 0; e < kBK * kCols / 4 / kThreads; ++e) {
        const int i = tid + e * kThreads;
        const int k = i / (kCols / 4), c4 = i % (kCols / 4);
        const uint2 v =
            *reinterpret_cast<const uint2*>(raw + kCols * k + 4 * c4);
        *reinterpret_cast<float4*>(&out->w[k][4 * c4]) = make_float4(
            widen16(static_cast<unsigned short>(v.x), op.w_type),
            widen16(static_cast<unsigned short>(v.x >> 16), op.w_type),
            widen16(static_cast<unsigned short>(v.y), op.w_type),
            widen16(static_cast<unsigned short>(v.y >> 16), op.w_type));
      }
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

  auto compute = [&](const Stage& st) {
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
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslices) load_slice(s);
    cp_async_commit();
  }
  if constexpr (!kNarrow) {
    for (int s = 0; s < nslices; ++s) {
      cp_async_wait<kStages - 2>();   // slice s has landed
      __syncthreads();                // and slice s - 1 is no longer read
      if (s + kStages - 1 < nslices) load_slice(s + kStages - 1);
      cp_async_commit();
      compute(ring[s % kStages]);
    }
  } else {
    // Slice s + 1 is widened into the other wide slice while slice s is
    // computed from its own, so the loop keeps one barrier a slice; the
    // copies run one slice less ahead.
    cp_async_wait<kStages - 2>();     // slice 0 has landed
    __syncthreads();
    if (nslices > 0) widen_slice(0);
    for (int s = 0; s < nslices; ++s) {
      // Slice s + 1 has landed, wide[s % 2] is written, and wide[(s + 1)
      // % 2] and slot s - 1 are no longer read.
      cp_async_wait<kStages - 3>();
      __syncthreads();
      if (s + kStages - 1 < nslices) load_slice(s + kStages - 1);
      cp_async_commit();
      compute(wide[s % 2]);
      if (s + 1 < nslices) widen_slice(s + 1);
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

// ---------------------------------------------------------------------------
// The tensor-core tile: x and W both bfloat16 or both float16.  A 2-byte
// product is exact in fp32, so the tensor cores can take it (a float32
// pair cannot: TF32 flips sign bits).  The block, the plan, the depth
// split and the epilogue are srp_gemm_tile's; what differs is the product
// and its staging.
//
// Product: the block's 4 warps each own 32 rows x 64 columns of the 64 x
// 128 tile, 2 x 8 fragments of mma.sync m16n8k16 (bf16 or f16 in, fp32
// accumulate), 64 accumulators a thread as in the float32 tile.  A slice
// is kTcBK = 32 depth steps, two k16 steps.  B fragments (W) come from
// the staged slice with ldmatrix.x4.trans: W rows are padded to 272 bytes,
// so the 8 rows of an 8 x 8 matrix fall 4 banks apart.  A fragments (x)
// are read as 4-byte words from the raw staged rows: a 2-byte row
// (d = 4097) starts on any 2-byte boundary, so its element k sits at half
// skew + k of its words and a fragment's pair (k, k + 1) is one funnel
// shift of two words by 16 * skew.  A thread's rows (g, g + 8, g + 16,
// g + 24 of its warp's 32) share a parity, so it has one skew; x rows are
// padded to 20 words, so the 32 lanes' reads hit 32 banks.
//
// Staging: the float32 tile's ring, kTcStages slices deep, one barrier a
// slice.  x rows in 4-byte cp.async words as in the widening tile (the
// word that holds the row's first element of the slice, and the next 16);
// W in 16-byte cp.async copies of 8 columns when the tile's first column
// is on an 8-column boundary (every group of the main paths' K = 15,
// L = 50), else 8-byte copies of 4 (the plan only promises 4).  Bytes
// past the split's depth, past row B or past column K*L are zero-filled.
// With the products on the tensor cores, issuing the copies is most of a
// slice's instructions, so each copy's address is worked out once a
// block and moved by the slice's depth: that took the admit shape from
// 0.0316 to 0.0225 ms on an H100 (PERF.md).  Deeper rings and 16-deep
// slices changed nothing measurable.
//
// Sum order: the mma steps in depth order inside a split, then the
// splits' partial tiles in rank order through distributed shared memory,
// as in srp_gemm_tile: a launch gives the same bits every time.  The
// tensor cores do not add in the CUDA-core FMA order, so the ids are held
// to the dense floor (>= 0.999 agreement with the plain version), not to
// the float32 kernel's bits.
// ---------------------------------------------------------------------------
constexpr int kTcBK = 32;                   // depth steps of one slice
constexpr int kTcStages = 5;                // slices in flight
constexpr int kTcMinBlocks = 2;             // the plan's two blocks an SM
constexpr int kTcXWords = kTcBK / 2 + 1;    // a row's words from any half
constexpr int kTcXStride = 20;              // words a staged x row
constexpr int kTcWStride = kCols + 8;       // halves a staged W row
constexpr int kTcPartStride = kCols + 8;    // floats a partial row
constexpr int kTcXCopies = (kRows * kTcXWords + kThreads - 1) / kThreads;
constexpr int kWarpRows = 32, kWarpCols = 64;    // 2 x 2 warps
constexpr int kMTiles = kWarpRows / 16, kNTiles = kWarpCols / 8;

static_assert(kThreads == 4 * 32 && kRows == 2 * kWarpRows &&
                  kCols == 2 * kWarpCols,
              "four warps, 2 x 2 over the tile");
static_assert(kTcXStride >= kTcXWords && kTcXStride % 32 == 20,
              "x rows 20 banks apart: a fragment read hits 32 banks");

struct TcStage {
  unsigned x[kRows][kTcXStride];            // raw x words, row-major
  unsigned short w[kTcBK][kTcWStride];      // W slice: w[k][column]
};
static_assert(sizeof(TcStage) % 16 == 0 &&
                  offsetof(TcStage, w) % 16 == 0,
              "16-byte copies and ldmatrix rows stay aligned");

constexpr size_t kTcRingBytes = sizeof(TcStage) * kTcStages;
constexpr size_t kTcPartBytes = sizeof(float) * kRows * kTcPartStride;
constexpr size_t kTcMainBytes =
    kTcRingBytes > kTcPartBytes ? kTcRingBytes : kTcPartBytes;
constexpr size_t kTcSmemBytes =
    kTcMainBytes + sizeof(unsigned) * kRows * kMaskWords;

// Four 8 x 8 matrices of 2-byte elements, transposed: lane l gives the row
// address of matrix l / 8, row l % 8; register i takes matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a @ b for one m16n8k16 fragment, bf16 (kF16 false) or f16 in, fp32
// accumulated.
template <bool kF16>
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  if constexpr (kF16)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// srp_gemm_tile for x and W both float16 (kF16) or both bfloat16; `smem`
// holds kTcSmemBytes of dynamic shared memory aligned to 16.
template <bool kF16, typename Emit>
__device__ __forceinline__ void srp_tc_tile(const Operands& op, int B, int d,
                                            int P, int K, int L,
                                            const Plan& plan,
                                            unsigned char* smem, Emit emit) {
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
  const int nslices = (k_end - k_begin + kTcBK - 1) / kTcBK;

  TcStage* ring = reinterpret_cast<TcStage*>(smem);
  const int tid = threadIdx.x;
  const unsigned short* __restrict__ x16 =
      static_cast<const unsigned short*>(op.x);
  const unsigned short* __restrict__ w16 =
      static_cast<const unsigned short*>(op.w);
  // As in srp_gemm_tile: an aligned address for the copies that read
  // nothing, and the parity that gives each row's skew.
  const void* x_none = reinterpret_cast<const void*>(
      reinterpret_cast<unsigned long long>(op.x) & ~3ull);
  const int x_par = static_cast<int>(
      (reinterpret_cast<unsigned long long>(op.x) >> 1) + k_begin) & 1;
  // A thread's copies are the same in every slice but for the depth, so
  // their addresses are worked out once.  x copy e is word q of row r
  // (i = tid + e * kThreads = r * kTcXWords + q): its word in a slot, the
  // row's element it starts at (2q - skew; kTcBK for a row past B, so that
  // it never reads) and its source at the split's first depth.  W: column
  // piece wc of depth rows wk, wk + kThreads / pieces, ... of the slice,
  // wn of its columns live; 8-column pieces (16-byte copies) when the
  // tile starts on an 8-column boundary, else 4-column ones.
  int xword[kTcXCopies], xfirst[kTcXCopies];
  const unsigned short* xsrc[kTcXCopies];
#pragma unroll
  for (int e = 0; e < kTcXCopies; ++e) {
    const int i = tid + e * kThreads, r = i / kTcXWords, q = i % kTcXWords;
    const bool row_live = row0 + r < B;
    xword[e] = r * kTcXStride + q;
    xfirst[e] =
        row_live ? 2 * q - ((x_par + ((row0 + r) & d)) & 1) : kTcBK;
    xsrc[e] = x16 + (row_live ? static_cast<long long>(row0 + r) * d +
                                    k_begin + xfirst[e]
                              : 0);
  }
  const bool w_wide = a0 % 8 == 0;
  const int piece = w_wide ? 8 : 4, pieces = kCols / piece;
  const int wk = tid / pieces, wc = tid % pieces * piece;
  const int wn = min(max(KL - (a0 + wc), 0), piece);
  const unsigned short* wsrc =
      w16 + static_cast<long long>(k_begin + wk) * P + a0 + wc;
  const long long wstep = static_cast<long long>(kThreads / pieces) * P;

  auto load_slice = [&](int s) {
    TcStage& st = ring[s % kTcStages];
    const int live = min(kTcBK, k_end - k_begin - s * kTcBK);
    unsigned* xs = &st.x[0][0];
#pragma unroll
    for (int e = 0; e < kTcXCopies; ++e) {
      if (tid + e * kThreads >= kRows * kTcXWords) break;
      const int f = xfirst[e];
      const int bytes = f + 1 < live ? 4 : f < live ? 2 : 0;
      cp_async4(xs + xword[e], bytes ? xsrc[e] + s * kTcBK : x_none, bytes);
    }
    const unsigned short* ws =
        wsrc + static_cast<long long>(s) * kTcBK * P;
    if (w_wide) {
#pragma unroll
      for (int e = 0; e < kTcBK * kCols / 8 / kThreads; ++e) {
        const int k = wk + e * (kThreads / (kCols / 8));
        const int n = k < live ? wn : 0;
        cp_async16(&st.w[k][wc], n ? ws + e * wstep : w16, 2 * n);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kTcBK * kCols / 4 / kThreads; ++e) {
        const int k = wk + e * (kThreads / (kCols / 4));
        const int n = k < live ? wn : 0;
        cp_async8(&st.w[k][wc], n ? ws + e * wstep : w16, 2 * n);
      }
    }
  };

  // Warp (wm, wn) owns rows wm * 32 .. + 31 and columns wn * 64 .. + 63;
  // lane (g, t) = (lane / 4, lane % 4) holds, in fragment (mt, nt), rows
  // 16 mt + g and + 8 and columns 8 nt + 2t and + 1 of those.
  const int warp = tid / 32, lane = tid % 32;
  const int wr = (warp / 2) * kWarpRows, wcol = (warp % 2) * kWarpCols;
  const int g = lane / 4, t = lane % 4;
  const int skew16 = 16 * ((x_par + ((row0 + wr + g) & d)) & 1);
  // This lane's ldmatrix row: depth (lane / 8 % 2) * 8 + lane % 8 of the
  // k16 step, columns (lane / 16) * 8 of the fragment pair.
  const int ldm_k = (lane / 8 % 2) * 8 + lane % 8, ldm_n = lane / 16 * 8;
  float acc[kMTiles][kNTiles][4];
#pragma unroll
  for (int i = 0; i < kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  auto compute = [&](const TcStage& st) {
#pragma unroll
    for (int kk = 0; kk < kTcBK; kk += 16) {
      unsigned a[kMTiles][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        const unsigned* lo = &st.x[wr + 16 * mt + g][kk / 2 + t];
        const unsigned* hi = &st.x[wr + 16 * mt + g + 8][kk / 2 + t];
        a[mt][0] = __funnelshift_r(lo[0], lo[1], skew16);
        a[mt][1] = __funnelshift_r(hi[0], hi[1], skew16);
        a[mt][2] = __funnelshift_r(lo[4], lo[5], skew16);
        a[mt][3] = __funnelshift_r(hi[4], hi[5], skew16);
      }
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        unsigned b[4];
        ldmatrix_x4_trans(b, &st.w[kk + ldm_k][wcol + 16 * np + ldm_n]);
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          mma16816<kF16>(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma16816<kF16>(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nslices) load_slice(s);
    cp_async_commit();
  }
  for (int s = 0; s < nslices; ++s) {
    cp_async_wait<kTcStages - 2>();   // slice s has landed
    __syncthreads();                  // and slice s - 1 is no longer read
    if (s + kTcStages - 1 < nslices) load_slice(s + kTcStages - 1);
    cp_async_commit();
    compute(ring[s % kTcStages]);
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free for the partial

  // Every block leaves its partial tile in its shared memory; at S = 1 it
  // is the whole sum.  Rows 8 floats longer than the tile: a half-warp's
  // 8-byte stores hit 32 banks.
  float* part = reinterpret_cast<float*>(smem);   // [kRows][kTcPartStride]
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      const int r = wr + 16 * mt + g, c = wcol + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(&part[r * kTcPartStride + c]) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(&part[(r + 8) * kTcPartStride + c]) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  if (S > 1)
    cluster.sync();                   // every rank's partial is written
  else
    __syncthreads();

  // srp_gemm_tile's epilogue: this block's rows, summed over the ranks in
  // order, as sign masks (a row is 32 items of 4 columns, one a lane),
  // then each (row, table)'s K bits by one funnel shift.
  unsigned* mask = reinterpret_cast<unsigned*>(smem + kTcMainBytes);
  const int rb = split * kRows / S, nr = (split + 1) * kRows / S - rb;
  const float* rank0 = S > 1 ? cluster.map_shared_rank(part, 0) : part;
  for (int i = tid; i < nr * (kCols / 4); i += kThreads) {
    const int r = rb + i / (kCols / 4), c4 = i % (kCols / 4);
    const int off = r * kTcPartStride + 4 * c4;
    float4 v = *reinterpret_cast<const float4*>(rank0 + off);
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
  if (S > 1)
    cluster.sync();                   // all partials read; masks visible
  else
    __syncthreads();

  for (int i = tid; i < nr * ntab; i += kThreads) {
    const int r = rb + i / ntab, j = i % ntab;
    if (row0 + r >= B) continue;
    const int s = shift + j * K;    // the table's first tile column
    const unsigned* m = mask + r * kMaskWords + s / 32;
    const unsigned top = __funnelshift_l(m[1], m[0], s % 32);
    emit(row0 + r, table0 + j, static_cast<int>(top >> (32 - K)));
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

// Launch the tile kernel for the operands, `narrow` (the tile with
// kNarrow, and its shared memory) when either is 2-byte, else `f32`, on
// the plan's grid; the caller passes the kernel's parameters in `args`.
// Returns the launch's error; the plan must fit.
template <typename... Params, typename... Args>
inline cudaError_t launch(const Operands& op, void (*f32)(Params...),
                          void (*narrow)(Params...), const Plan& plan,
                          cudaStream_t stream, Args&&... args) {
  const bool wide = op.x_type != kOpFloat32 || op.w_type != kOpFloat32;
  void (*kernel)(Params...) = wide ? narrow : f32;
  const int smem = static_cast<int>(wide ? kNarrowSmemBytes : kSmemBytes);
  cudaError_t err =
      repro::allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  LaunchConfig lc(plan, smem, stream);
  if (plan.splits == 1) lc.cfg.numAttrs = 0;   // no cluster launch
  return cudaLaunchKernelEx(&lc.cfg, kernel, std::forward<Args>(args)...);
}

// The tiles a launch of srp_hash or ace_admit_fused can run
// (kernels/srp_hash.py TILES): srp_gemm_tile, srp_gemm_tile with kNarrow
// (the widening tile), srp_tc_tile.
enum TileCode : int { kTileFloat32 = 0, kTileWiden = 1, kTileTensor = 2 };

// The tile an operand pair runs on (kernels/srp_hash.py hash_tile): a
// float32 pair the float32 tile, a same-type 2-byte pair the tensor-core
// tile, a mixed pair the widening tile.
inline int route(const Operands& op) {
  if (op.x_type == kOpFloat32 && op.w_type == kOpFloat32) return kTileFloat32;
  return op.x_type == op.w_type ? kTileTensor : kTileWiden;
}

// Whether `tile` takes the pair: its route, or the widening tile for any
// pair with a 2-byte operand (asked for by name, to time it beside the
// tensor-core tile).
inline bool tile_takes(int tile, const Operands& op) {
  return tile == route(op) ||
         (tile == kTileWiden && route(op) != kTileFloat32);
}

// `launch` for the entry points that also have the tensor-core tile:
// kTileTensor launches `bf16` or `f16` (the operands' type) with its
// shared memory, the other tiles go to `launch`.  The caller has checked
// tile_takes; there is no fallback from one tile to another.
template <typename... Params, typename... Args>
inline cudaError_t launch_tile(int tile, const Operands& op,
                               void (*f32)(Params...),
                               void (*narrow)(Params...),
                               void (*bf16)(Params...),
                               void (*f16)(Params...), const Plan& plan,
                               cudaStream_t stream, Args&&... args) {
  if (tile != kTileTensor)
    return launch(op, f32, narrow, plan, stream,
                  std::forward<Args>(args)...);
  void (*kernel)(Params...) = op.x_type == kOpFloat16 ? f16 : bf16;
  const int smem = static_cast<int>(kTcSmemBytes);
  cudaError_t err =
      repro::allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  LaunchConfig lc(plan, smem, stream);
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
