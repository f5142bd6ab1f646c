// SRHT meta-hash: pad d -> d_pad = 2^N (N = ceil(log2 max(d, 2))), * D1,
// FWHT, * D2, FWHT, sample m = K*L rows (with replacement, so m may exceed
// d_pad), sign, K-bit big-endian pack -> (B, L) int32 bucket ids.
// Replaces the Pallas kernel of src/repro/kernels/srht_hash.py
// (srht_hash).
//
// Bound on the H100: the FWHT's adds (2 * d_pad * N a row, at 33.5 T
// adds/s: fp32 at 67 TFLOP/s counts an FMA as two) against the bytes of x
// and the ids; no W is read.  What costs beyond the adds is moving the
// row between the threads that hold it, so the design keeps the row in
// registers and moves it as rarely as it can:
//
// - A team of 2^(N - E) threads owns a row, each thread 2^E of its
//   elements in registers: E = N up to d_pad = 32 (a thread a row),
//   E = ceil(N / 2) up to 512 so that small rows still spread over
//   threads, E = 5 from 1024 up (at d_pad = 8192: 256 threads of 32).
//   The stages run in passes of E: in pass p a thread holds the 2^E
//   elements whose index differs only in bits [lo, lo + E),
//   lo = min(p * E, N - E), so the pass's butterflies are between its own
//   registers.
// - Before each pass the team exchanges the row once through shared
//   memory (each thread stores its elements, one barrier, each loads its
//   next ones): at d_pad = 8192, 5 + 5 + 3 stages and three exchanges an
//   FWHT where a barrier-per-stage design makes 13 round trips.  Rows are
//   padded by one float every 32, so that every exchange from d_pad = 512
//   up is free of bank conflicts; the padded offset splits into a
//   per-thread base plus a compile-time offset per register.  (Two passes
//   of 64 threads holding 128 elements each, two exchanges an FWHT, took
//   255 registers with spills and measured no faster: PERF.md.)
// - A team of up to 32 threads lies inside one warp and exchanges under
//   __syncwarp; from d_pad = 2048 up it spans warps and takes a block
//   barrier.  A block is 128 threads or one row's team; below d_pad =
//   1024 its rows fill one warp and the other three warps only pack, so
//   the pack (K*L sampled signs a row, 750 at K = 15, L = 50, often more
//   than the row's elements) has four threads for each FWHT thread.
// - x is read straight into registers in the last pass's layout (the
//   team's threads on consecutive elements: coalesced, scalar, as the row
//   stride d need not be 16-byte aligned).  The sign diagonals come as
//   bitmaps and are applied in the first pass's layout, where a thread's
//   2^E elements are consecutive: one 32-bit load a thread per diagonal.
//   The row sample (m = K*L indices, up to 1024) is copied to shared
//   memory at the start, so the pack does not wait on it.
// - The final signs go to shared memory once, as bytes; then every thread
//   packs: one thread a (row, table) when a block has at least as many of
//   those as threads, else each warp turns 32 sampled signs at a time into
//   a bitmap word with a ballot and one thread a (row, table) cuts its K
//   bits out of the bitmap.
//
// Bitwise agreement with the reference (repro.core.srht.srht_bits): the
// stages run h = 1, 2, 4, ... and every butterfly writes v[i] <- a + b,
// v[i + h] <- a - b with the reference's operands (which thread holds
// them does not change the sums); the sign flips are exact multiplies by
// +-1 (__fmul_rn, so nothing is contracted into an FMA); the adds are
// __fadd_rn/__fsub_rn.  The sign test is v >= 0, so the -0.0 of a padded
// lane (0 * -1) is bit 1 like +0.0 and NaN is bit 0, as in
// repro.core.srp.srp_bits; signbit is never used.  Every butterfly runs,
// the zero padding's too.

#include "common.cuh"

namespace {

constexpr int kMaxSample = 1024;   // row-sample indices kept in smem

// The launch shape for d_pad = 2^N (kernels/srht_hash.py srht_plan
// mirrors it and the C entry point checks the two agree).
template <int N>
struct Shape {
  static constexpr int kElemsLog = N <= 5 ? N : (N < 10 ? (N + 1) / 2 : 5);
  static constexpr int kElems = 1 << kElemsLog;      // registers a thread
  static constexpr int kTeamLog = N - kElemsLog;
  static constexpr int kTeam = 1 << kTeamLog;        // threads a row
  static constexpr int kThreads = kTeam > 128 ? kTeam : 128;
  // rows a block: a team smaller than a warp shares one warp with other
  // rows' teams, and the block's other warps only pack
  static constexpr int kRows = kTeam < 32 ? 32 / kTeam : kThreads / kTeam;
  static constexpr int kPasses = (N + kElemsLog - 1) / kElemsLog;
  static constexpr int kPad = 1 << N;
  static constexpr int kStride = kPasses > 1 ? kPad + (kPad >> 5) : 0;
  static constexpr int kLast = N - kElemsLog;        // the last pass's lo
  static constexpr size_t kSmem =
      static_cast<size_t>(kRows) * (kStride * sizeof(float) + kPad)
      + kMaxSample * sizeof(int);

  // Lowest index bit a thread holds in registers in pass p.
  static constexpr __host__ __device__ int lo(int p) {
    return p * kElemsLog < kLast ? p * kElemsLog : kLast;
  }
};

// Padded shared-memory offset of element i = b | (r << lo), split into
// the thread's base (from b, its bits outside [lo, lo + E)) and the
// register's offset (from r): pad(i) = i + (i >> 5) = pad(b) + pad(r << lo)
// because the two never carry into each other (see srht_plan's test).
__device__ __forceinline__ int thread_bits(int t, int lo, int elems_log) {
  return (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + elems_log));
}

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <int N>
__device__ __forceinline__ void team_sync() {
  if constexpr (Shape<N>::kTeam <= 32) __syncwarp();
  else __syncthreads();
}

// Butterflies of register bits [k0, k1) in order, between a thread's own
// elements: stage h = 2^(lo + k) pairs register r with r | 2^k.
template <int E>
__device__ __forceinline__ void butterflies(float (&v)[E], int k0, int k1) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k < k0 || k >= k1 || (1 << k) >= E) continue;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (r & (1 << k)) continue;
      const float a = v[r], b = v[r | (1 << k)];
      v[r] = __fadd_rn(a, b);
      v[r | (1 << k)] = __fsub_rn(a, b);
    }
  }
}

// One sign diagonal, then one FWHT of the team's row, from and back to the
// last pass's layout.  The diagonal is applied in the first pass's layout,
// where thread t holds elements t * 2^E + r: bit r of `signs` (that
// stretch of the diagonal's bitmap) is set where the sign is -1.  A
// multiply by -1 or +1 is exact, as the reference's.
template <int N>
__device__ __forceinline__ void signed_fwht(float (&v)[Shape<N>::kElems],
                                            float* row, int t,
                                            unsigned int signs) {
  using S = Shape<N>;
#pragma unroll
  for (int p = 0; p < S::kPasses; ++p) {
    const int lo = S::lo(p);
    if constexpr (S::kPasses > 1) {
      const int from = p == 0 ? S::kLast : S::lo(p - 1);
      float* src = row + padded(thread_bits(t, from, S::kElemsLog));
      float* dst = row + padded(thread_bits(t, lo, S::kElemsLog));
#pragma unroll
      for (int r = 0; r < S::kElems; ++r) src[padded(r << from)] = v[r];
      team_sync<N>();
#pragma unroll
      for (int r = 0; r < S::kElems; ++r) v[r] = dst[padded(r << lo)];
    }
    if (p == 0) {
#pragma unroll
      for (int r = 0; r < S::kElems; ++r)
        v[r] = __fmul_rn(v[r], (signs >> r) & 1u ? -1.0f : 1.0f);
    }
    const int s_end = (p + 1) * S::kElemsLog < N ? (p + 1) * S::kElemsLog : N;
    butterflies(v, p * S::kElemsLog - lo, s_end - lo);
  }
}

template <int N>
__global__ void __launch_bounds__(Shape<N>::kThreads)
srht_hash_kernel(const void* __restrict__ x, int x_type,
                 const unsigned int* __restrict__ sign_words,
                 const int* __restrict__ rows, int* __restrict__ out, int B,
                 int d, int K, int L) {
  using S = Shape<N>;
  extern __shared__ float smem[];
  unsigned char* signs =
      reinterpret_cast<unsigned char*>(smem + S::kRows * S::kStride);
  int* sample = reinterpret_cast<int*>(signs + S::kRows * S::kPad);
  const int m = K * L;
  const int* rp = m <= kMaxSample ? sample : rows;
  if (m <= kMaxSample)
    for (int p = threadIdx.x; p < m; p += S::kThreads) sample[p] = rows[p];

  const long long row0 = static_cast<long long>(blockIdx.x) * S::kRows;
  if (threadIdx.x < S::kRows * S::kTeam) {   // the rows' teams
    const int rloc = threadIdx.x >> S::kTeamLog;      // row in the block
    const int t = threadIdx.x & (S::kTeam - 1);       // thread in the team
    const bool live = row0 + rloc < B;
    const long long xr = (row0 + rloc) * d;   // the row's first element
    // this thread's stretch of each diagonal's bitmap (first-pass layout)
    const int first = t << S::kElemsLog;
    const int words = S::kPad > 32 ? S::kPad >> 5 : 1;
    const unsigned int d1 =
        __ldg(sign_words + (first >> 5)) >> (first & 31);
    const unsigned int d2 =
        __ldg(sign_words + words + (first >> 5)) >> (first & 31);

    // x into registers in the last pass's layout: element t | (r << kLast),
    // a bf16 or fp16 element widened to fp32 as it is loaded
    float v[S::kElems];
#pragma unroll
    for (int r = 0; r < S::kElems; ++r) {
      const int i = t | (r << S::kLast);
      v[r] = live && i < d ? repro::load_operand(x, xr + i, x_type) : 0.0f;
    }
    float* srow = smem + rloc * S::kStride;
    signed_fwht<N>(v, srow, t, d1);
    signed_fwht<N>(v, srow, t, d2);

    unsigned char* sg = signs + rloc * S::kPad;
#pragma unroll
    for (int r = 0; r < S::kElems; ++r)
      sg[t | (r << S::kLast)] = v[r] >= 0.0f ? 1 : 0;
  }
  __syncthreads();

  const long long left = B - row0;
  const int nrows = left < S::kRows ? static_cast<int>(left) : S::kRows;
  const int pairs = nrows * L;
  const int words_m = (m + 31) >> 5;
  if (pairs >= S::kThreads || S::kPasses == 1 || words_m > S::kStride) {
    // one thread a (row, table): its K sample indices loaded at once,
    // then its K signs, MSB first
    for (int pr = threadIdx.x; pr < pairs; pr += S::kThreads) {
      const int r = pr / L, j = pr - r * L;
      const unsigned char* sr = signs + r * S::kPad;
      const int* rj = rp + j * K;
      int at[31];
#pragma unroll
      for (int k = 0; k < 31; ++k) at[k] = k < K ? rj[k] : 0;
      unsigned int bucket = 0;
#pragma unroll
      for (int k = 0; k < 31; ++k)
        if (k < K) bucket = (bucket << 1) | sr[at[k]];
      out[(row0 + r) * L + j] = static_cast<int>(bucket);
    }
  } else {
    // the rows' m sampled signs as bitmaps, 32 a ballot, in the exchange
    // buffer (free since the barrier above); then one thread a (row,
    // table) cuts its K bits out, and a bit reversal makes them big-endian
    unsigned int* bits = reinterpret_cast<unsigned int*>(smem);
    const int lane = threadIdx.x & 31;
    for (int rw = threadIdx.x >> 5; rw < nrows * words_m;
         rw += S::kThreads / 32) {
      const int r = rw / words_m, p = ((rw - r * words_m) << 5) + lane;
      const unsigned int bit = p < m ? signs[r * S::kPad + rp[p]] : 0u;
      const unsigned int word = __ballot_sync(0xffffffffu, bit);
      if (lane == 0) bits[rw] = word;
    }
    __syncthreads();
    for (int pr = threadIdx.x; pr < pairs; pr += S::kThreads) {
      const int r = pr / L, j = pr - r * L, p0 = j * K;
      const unsigned int* w = bits + r * words_m + (p0 >> 5);
      const unsigned long long win =
          w[0] | ((p0 >> 5) + 1 < words_m
                  ? static_cast<unsigned long long>(w[1]) << 32 : 0ull);
      const unsigned int field =
          static_cast<unsigned int>(win >> (p0 & 31)) & ((1u << K) - 1u);
      out[(row0 + r) * L + j] = static_cast<int>(__brev(field) >> (32 - K));
    }
  }
}

template <int N>
int launch(const void* x, int x_type, const unsigned int* sign_words,
           const int* rows, int* out, int B, int d, int K, int L,
           int elems_log, int rows_per_block, cudaStream_t stream) {
  using S = Shape<N>;
  if (elems_log != S::kElemsLog || rows_per_block != S::kRows)
    return cudaErrorInvalidValue;          // the Python plan disagrees
  if (S::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        srht_hash_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (static_cast<long long>(B) + S::kRows - 1)
                           / S::kRows;
  srht_hash_kernel<N><<<static_cast<unsigned int>(blocks), S::kThreads,
                        S::kSmem, stream>>>(x, x_type, sign_words, rows,
                                            out, B, d, K, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, d) fp32, bf16 or fp16 as x_type says (repro::OperandCode);
// sign_words (2, max(d_pad, 32) / 32) int32, the bitmaps of D1 and D2
// (bit i % 32 of word i / 32 set where the sign is -1); rows (K*L,) int32
// in [0, d_pad); out (B, L) int32.  d_pad = 2^log2_pad; needs
// B >= 1, 1 <= K <= 31 and 1 <= log2_pad <= 15 (the wrapper checks all
// three); elems_log and rows_per_block are the wrapper's plan
// (srht_plan), which must be this source's.
REPRO_API int repro_srht_hash(const void* x, const int* sign_words,
                              const int* rows, int* out, int B, int d,
                              int log2_pad, int K, int L, int elems_log,
                              int rows_per_block, int x_type,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!repro::operand_code_ok(x_type)) return cudaErrorInvalidValue;
  const unsigned int* sw = reinterpret_cast<const unsigned int*>(sign_words);
#define REPRO_SRHT_CASE(n)                                                  \
  case n:                                                                   \
    return launch<n>(x, x_type, sw, rows, out, B, d, K, L, elems_log,       \
                     rows_per_block, st);
  switch (log2_pad) {
    REPRO_SRHT_CASE(1) REPRO_SRHT_CASE(2) REPRO_SRHT_CASE(3)
    REPRO_SRHT_CASE(4) REPRO_SRHT_CASE(5) REPRO_SRHT_CASE(6)
    REPRO_SRHT_CASE(7) REPRO_SRHT_CASE(8) REPRO_SRHT_CASE(9)
    REPRO_SRHT_CASE(10) REPRO_SRHT_CASE(11) REPRO_SRHT_CASE(12)
    REPRO_SRHT_CASE(13) REPRO_SRHT_CASE(14) REPRO_SRHT_CASE(15)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_SRHT_CASE
}
