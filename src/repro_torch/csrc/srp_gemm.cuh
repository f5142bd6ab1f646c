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
// OperandCode), as the Pallas kernels take them; every element is widened
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
