// Signed count-sketch point estimates, two entry points.  Both replace the
// Pallas kernel of src/repro/kernels/attr_estimate.py (attr_estimate);
// the second also takes in the reference's findHH drill-down around its
// estimates (src/repro/attribution/sketch.py find_hh, one lax.scan).
//
// repro_attr_estimate — the batch query: out[b] = median_r(signs[b, r] *
//   plane[r, cols[b, r]]) over the R rows of one attribution level; odd R
//   takes the middle order statistic, even R the midpoint 0.5f * (a + b)
//   of the two middles.  Bound on the H100: launch latency in practice; by
//   bytes, the (B, R) ids and signs in, the (B,) estimates out and one
//   read of each plane cell touched (the (R, C) plane, 5 KB at R = 5,
//   C = 256, stays in L2).  One thread per query b; neighbouring threads
//   read neighbouring ids and write neighbouring outputs.
//
// repro_attr_find_hh — the whole drill-down of one single-channel
//   (NL, R, C) hierarchy in one launch, bitwise the port's plain loop
//   (kernels/attr_estimate.py attr_find_hh_plain).  A beam of
//   W = max(2 topk, 8) nodes descends depths 2..NL: child i of the 2W is
//   2 keys[i] (i < W) or 2 keys[i - W] + 1, valid where its parent is,
//   where it is < 2^depth and where its first coordinate is < dim; its
//   id is clamped into [0, 2^NL); it ranks by |median estimate| at level
//   depth - 1, or -inf where invalid, and the top W keep their slots.
//   After the leaf level the beam (valid where key < dim, estimated at
//   the clamped key) is ranked once more and the top topk written.
//   Bound on the H100: by bytes ~0.007 us (the 2W R table entries a
//   level and the plane cells they name); in practice NL dependent round trips to L2, one a
//   level, and with one warp at work each level's chain of dependent
//   instructions (the loads, the median network, the ranking).  Design:
//   one block, a child a thread: 2W threads rounded up to a warp (32 at
//   topk = 8, one warp; threads loop over children past 1024).  Every
//   level reads the plane from global memory through L1 (staging the
//   hierarchy in shared memory first was 4-5% slower at NL = 13, R = 5,
//   C = 256, and cannot hold it past bits ~11).  A child issues its R
//   column and sign loads together (and asks for its own two children's
//   entries at the next level into L1, so the next level's loads mostly
//   hit there), then reads its plane cells and takes the median with the
//   batch kernel's code.  Its slot is p = #{j ranked above i} + #{j < i tied with i},
//   on integer keys of the ranks (rank_key), from unrolled warp shuffles
//   and one __match_any_sync when 2W <= 32 and from the keys in shared
//   memory otherwise; each child with p < W writes its key, flag and
//   estimate to slot p, then one barrier.  The leaf ranking reuses the
//   last level's estimates of the beam's keys (the same level and nodes).
//   No atomics, no host sync, the result is the same bits run to run.
//   The beam (44 bytes a lane) lives in shared memory, or in a device
//   workspace the wrapper allocates when it does not fit (topk in the
//   thousands).
//
// Ranking: the order of torch.sort(descending=True, stable=True) on the
// CPU and on the card: numbers descending, NaN first (a NaN estimate of a
// valid child ranks above every number), ties (every -inf lane, every NaN)
// to the lower index.
//
// The median, in both: R up to kMaxRegR is a template argument, so the
// values live in registers and a compare-exchange network (fully
// unrolled) sorts them; any larger R takes an exact O(R^2) rank selection
// that keeps no array at all and gathers each value again from L1/L2, so
// no R is refused.  Held bitwise against the plain version (and the
// reference's _median_lastaxis): NaN sorts above every number, as
// torch.sort and jnp.sort put it; the midpoint is
// __fmul_rn(0.5f, __fadd_rn(a, b)) so nvcc contracts nothing.  The median
// is a value, so ties need no order (+0 and -0 compare equal, and either
// may be returned).  Columns outside [0, C) are clamped, as ace_query
// clamps ids.

#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kMaxRegR = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
// A beam lane's shared memory: its key, flag and estimate, and its two
// children's id, flag, estimate and rank, 4 bytes each
// (kernels/attr_estimate.py BEAM_LANE_BYTES).
constexpr int kBeamLaneBytes = 44;

// a < b in the order of torch.sort: numbers ascending, NaN last.
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (a == a && b != b);
}

__device__ __forceinline__ bool same(float a, float b) {
  return a == b || (a != a && b != b);
}

__device__ __forceinline__ float midpoint(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

__device__ __forceinline__ float signed_cell(const float* plane, int col,
                                             float sign, int r, int C) {
  return __fmul_rn(sign, plane[static_cast<long long>(r) * C
                               + min(max(col, 0), C - 1)]);
}

// The median of R values in registers: odd-even transposition sort, R
// rounds of compare-exchange, every index static after unrolling.
template <int R>
__device__ __forceinline__ float median_sorted(float (&v)[R]) {
#pragma unroll
  for (int round = 0; round < R; ++round) {
#pragma unroll
    for (int j = round & 1; j + 1 < R; j += 2) {
      if (before(v[j + 1], v[j])) {
        const float t = v[j];
        v[j] = v[j + 1];
        v[j + 1] = t;
      }
    }
  }
  if constexpr (R & 1) {
    return v[R / 2];
  } else {
    return midpoint(v[R / 2 - 1], v[R / 2]);
  }
}

// Any R: the k-th order statistic (0-based) of value(0..R-1) is the value
// v_i with #{j: v_j before v_i} <= k < that count plus #{j: v_j same as
// v_i}.
template <typename Value>
__device__ __forceinline__ float median_ranked(Value value, int R) {
  const int hi = R / 2, lo = (R & 1) ? hi : hi - 1;
  float v_lo = 0.0f, v_hi = 0.0f;
  for (int i = 0; i < R; ++i) {
    const float vi = value(i);
    int less = 0, eq = 0;
    for (int j = 0; j < R; ++j) {
      const float vj = value(j);
      less += before(vj, vi);
      eq += same(vj, vi);
    }
    if (less <= lo && lo < less + eq) v_lo = vi;
    if (less <= hi && hi < less + eq) v_hi = vi;
  }
  return (R & 1) ? v_hi : midpoint(v_lo, v_hi);
}

// The median estimate from R (column, sign) pairs at cols[e..e+R) and
// signs[e..e+R) over an (R, C) plane.  RR = R (1..kMaxRegR) loads all the
// pairs before it reads a cell; RR = 0 takes the rank selection.
template <int RR>
__device__ __forceinline__ float estimate(const float* plane,
                                          const int* __restrict__ cols,
                                          const float* __restrict__ signs,
                                          long long e, int R, int C) {
  if constexpr (RR > 0) {
    int c[RR];
    float s[RR], v[RR];
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      c[r] = cols[e + r];
      s[r] = signs[e + r];
    }
#pragma unroll
    for (int r = 0; r < RR; ++r) v[r] = signed_cell(plane, c[r], s[r], r, C);
    return median_sorted<RR>(v);
  } else {
    return median_ranked(
        [&](int r) { return signed_cell(plane, cols[e + r], signs[e + r], r,
                                        C); },
        R);
  }
}

template <int RR>
__global__ void attr_estimate_kernel(const float* __restrict__ plane,
                                     const int* __restrict__ cols,
                                     const float* __restrict__ signs,
                                     float* __restrict__ out, int B, int R,
                                     int C) {
  const long long b = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (b >= B) return;
  out[b] = estimate<RR>(plane, cols, signs, b * (RR > 0 ? RR : R),
                        RR > 0 ? RR : R, C);
}

// ---------------------------------------------------------------------------
// The drill-down.
// ---------------------------------------------------------------------------

// A child's rank (|estimate| >= 0, -inf where masked, or NaN) as an
// integer in the order of torch.sort(descending=True): -inf 0, a number
// its bits + 1 (the bits of a float >= 0 order as the float does; fabsf
// gives no -0), NaN the top.  Equal keys are equal ranks.
__device__ __forceinline__ unsigned rank_key(float r) {
  return r != r ? 0xffffffffu : (r < 0.0f ? 0u : __float_as_uint(r) + 1u);
}

// The stable slot of lane i among the keys of lanes 0..n-1 (every lane of
// the warp calls it; lanes past n hold key 0 and come after every real
// lane): #{j: key_j > key_i} + #{j < i: key_j == key_i}.  Unrolled, so
// the 32 shuffles are in flight together (one warp holds the SM, and a
// loop of dependent shuffles would expose each one's latency); the ties
// are one match.
__device__ __forceinline__ int slot_shfl(unsigned key, int i) {
  int p = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) p += __shfl_sync(kFull, key, j) > key;
  const unsigned before_i = (1u << i) - 1u;
  return p + __popc(__match_any_sync(kFull, key) & before_i);
}

// The same over n keys in memory.
__device__ __forceinline__ int slot_mem(const unsigned* keys, int i, int n) {
  const unsigned k = keys[i];
  int p = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    const unsigned kj = keys[j];
    p += kj > k || (j < i && kj == k);
  }
  return p;
}

struct FindHH {
  const float* plane;           // (NL, R, C)
  const int* cols;              // (NL, 2^NL, R)
  const float* signs;           // (NL, 2^NL, R)
  int* coords;                  // (topk,)
  float* ests;                  // (topk,)
  unsigned char* valid;         // (topk,)
  unsigned char* work;          // the beam in device memory, or null
  int NL, R, C, dim, topk, beam;
};

// Ask for the table entries of nodes node0 and node0 + 1 at one level,
// R ints and R floats each, into L1 (fire and forget).
__device__ __forceinline__ void prefetch_entries(const int* cols,
                                                 const float* signs,
                                                 long long e, int R) {
  for (int k = 0; k < 2 * R; k += 32) {
    asm volatile("prefetch.global.L1 [%0];" ::"l"(cols + e + k));
    asm volatile("prefetch.global.L1 [%0];" ::"l"(signs + e + k));
  }
  asm volatile("prefetch.global.L1 [%0];" ::"l"(cols + e + 2 * R - 1));
  asm volatile("prefetch.global.L1 [%0];" ::"l"(signs + e + 2 * R - 1));
}

template <int RR>
__global__ void __launch_bounds__(kMaxThreads)
attr_find_hh_kernel(const FindHH a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = RR > 0 ? RR : a.R, C = a.C, NL = a.NL, W = a.beam;
  const int n = 2 * W, tid = threadIdx.x, nt = blockDim.x;
  const bool one_warp = n <= 32;            // warp 0: a child a lane
  const long long D2 = 1LL << NL, level_cells = static_cast<long long>(R) * C;
  unsigned char* mem = a.work != nullptr ? a.work : smem;
  int* keys = reinterpret_cast<int*>(mem);  // (W,) the beam's nodes
  int* kvalid = keys + W;                   // (W,)
  float* kest = reinterpret_cast<float*>(kvalid + W);  // (W,) estimates
  int* child = reinterpret_cast<int*>(kest + W);       // (2W,) or (W,)
  int* cvalid = child + n;
  float* est = reinterpret_cast<float*>(cvalid + n);
  unsigned* rank = reinterpret_cast<unsigned*>(est + n);
  for (int i = tid; i < W; i += nt) {
    keys[i] = i;
    kvalid[i] = i < 2;                      // depth-1 nodes: {0, 1}
  }
  __syncthreads();

  for (int depth = 2; depth <= NL; ++depth) {
    const int lvl = depth - 1;
    const float* pl = a.plane + lvl * level_cells;
    const long long below = (a.dim - 1) >> (NL - depth);
    // child i: its clamped id, its flag, its estimate and its rank; the
    // entries of its own children at the next level are asked for now,
    // so that the next level's loads find them in L1
    auto expand = [&](int i, int& ci, int& v, float& e, unsigned& r) {
      const int p = i < W ? i : i - W;
      const long long c = 2LL * keys[p] + (i >= W);
      v = kvalid[p] && c < (1LL << depth) && c <= below;
      ci = static_cast<int>(min(max(c, 0LL), D2 - 1));
      if (depth < NL)
        prefetch_entries(a.cols, a.signs,
                         ((lvl + 1) * D2 + min(2LL * ci, D2 - 2)) * R, R);
      e = estimate<RR>(pl, a.cols, a.signs, (lvl * D2 + ci) * R, R, C);
      r = rank_key(v ? fabsf(e) : -CUDART_INF_F);
    };
    if (one_warp) {
      if (tid < 32) {
        int ci = 0, v = 0;
        float e = 0.0f;
        unsigned r = 0u;
        if (tid < n) expand(tid, ci, v, e, r);
        const int p = slot_shfl(r, tid);
        __syncwarp();                       // every parent read
        if (tid < n && p < W) {
          keys[p] = ci;
          kvalid[p] = v;
          kest[p] = e;
        }
      }
    } else {
      for (int i = tid; i < n; i += nt) {
        int ci, v;
        float e;
        unsigned r;
        expand(i, ci, v, e, r);
        child[i] = ci;
        cvalid[i] = v;
        est[i] = e;
        rank[i] = r;
      }
      __syncthreads();                      // every rank written
      for (int i = tid; i < n; i += nt) {
        const int p = slot_mem(rank, i, n);
        if (p < W) {
          keys[p] = child[i];
          kvalid[p] = cvalid[i];
          kest[p] = est[i];
        }
      }
    }
    __syncthreads();                        // the new beam
  }

  // the leaf ranking: valid where the key is a coordinate.  Past one
  // level the beam's keys are the last level's clamped children, whose
  // estimates at level NL - 1 the last level kept: the same bits as
  // estimating them again.
  const float* pl = a.plane + (NL - 1) * level_cells;
  auto leaf = [&](int i, int& key, int& v, float& e, unsigned& r) {
    key = keys[i];
    v = kvalid[i] && key < a.dim;
    if (NL > 1) {
      e = kest[i];
    } else {
      const long long node = min(max(static_cast<long long>(key), 0LL),
                                 D2 - 1);
      e = estimate<RR>(pl, a.cols, a.signs, node * R, R, C);
    }
    r = rank_key(v ? fabsf(e) : -CUDART_INF_F);
  };
  if (one_warp) {
    if (tid < 32) {
      int key = 0, v = 0;
      float e = 0.0f;
      unsigned r = 0u;
      if (tid < W) leaf(tid, key, v, e, r);
      const int p = slot_shfl(r, tid);
      if (tid < W && p < a.topk) {
        a.coords[p] = key;
        a.ests[p] = e;
        a.valid[p] = v;
      }
    }
  } else {
    for (int i = tid; i < W; i += nt) {
      int key, v;
      float e;
      unsigned r;
      leaf(i, key, v, e, r);
      child[i] = key;
      cvalid[i] = v;
      est[i] = e;
      rank[i] = r;
    }
    __syncthreads();
    for (int i = tid; i < W; i += nt) {
      const int p = slot_mem(rank, i, W);
      if (p < a.topk) {
        a.coords[p] = child[i];
        a.ests[p] = est[i];
        a.valid[p] = cvalid[i];
      }
    }
  }
}

template <int RR>
cudaError_t launch_find_hh(const FindHH& a, int threads, size_t smem,
                           cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = repro::allow_smem(
        reinterpret_cast<const void*>(&attr_find_hh_kernel<RR>), -1);
    if (err != cudaSuccess) return err;
  }
  attr_find_hh_kernel<RR><<<1, threads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// plane (R, C) fp32; cols (B, R) int32; signs (B, R) fp32 (±1); out (B,)
// fp32.  B >= 1, R >= 1, C >= 1.
REPRO_API int repro_attr_estimate(const float* plane, const int* cols,
                                  const float* signs, float* out, int B,
                                  int R, int C, void* stream) {
  constexpr int kThreads = 256;
  const unsigned int blocks = static_cast<unsigned int>(
      (static_cast<long long>(B) + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
#define REPRO_ATTR_REG(N)                                                   \
  case N:                                                                   \
    attr_estimate_kernel<N><<<blocks, kThreads, 0, s>>>(plane, cols, signs, \
                                                        out, B, R, C);      \
    break;
    REPRO_ATTR_REG(1)
    REPRO_ATTR_REG(2)
    REPRO_ATTR_REG(3)
    REPRO_ATTR_REG(4)
    REPRO_ATTR_REG(5)
    REPRO_ATTR_REG(6)
    REPRO_ATTR_REG(7)
    REPRO_ATTR_REG(8)
#undef REPRO_ATTR_REG
    default:
      attr_estimate_kernel<0><<<blocks, kThreads, 0, s>>>(plane, cols, signs,
                                                          out, B, R, C);
  }
  static_assert(kMaxRegR == 8, "one case per register-sorted R");
  return static_cast<int>(cudaGetLastError());
}

// plane (NL, R, C) fp32; cols (NL, 2^NL, R) int32; signs (NL, 2^NL, R)
// fp32 (±1); outputs coords (topk,) int32, ests (topk,) fp32, valid
// (topk,) bool.  work: null (the beam in shared memory) or
// 44 * max(2 topk, 8) bytes of device memory.  NL >= 1 with 2^(NL-1) < dim <= 2^NL (or NL = 1), R, C, topk
// >= 1.
REPRO_API int repro_attr_find_hh(const float* plane, const int* cols,
                                 const float* signs, int* coords,
                                 float* ests, unsigned char* valid,
                                 unsigned char* work, int NL, int R, int C,
                                 int dim, int topk, void* stream) {
  const int beam = topk > 4 ? 2 * topk : 8;
  const long long n = 2LL * beam;
  const int threads = static_cast<int>(
      n > kMaxThreads ? kMaxThreads : (n + 31) / 32 * 32);
  const size_t smem =
      work == nullptr ? static_cast<size_t>(kBeamLaneBytes) * beam : 0;
  const FindHH a{plane, cols, signs, coords, ests, valid, work,
                 NL, R, C, dim, topk, beam};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1: return static_cast<int>(launch_find_hh<1>(a, threads, smem, s));
    case 2: return static_cast<int>(launch_find_hh<2>(a, threads, smem, s));
    case 3: return static_cast<int>(launch_find_hh<3>(a, threads, smem, s));
    case 4: return static_cast<int>(launch_find_hh<4>(a, threads, smem, s));
    case 5: return static_cast<int>(launch_find_hh<5>(a, threads, smem, s));
    case 6: return static_cast<int>(launch_find_hh<6>(a, threads, smem, s));
    case 7: return static_cast<int>(launch_find_hh<7>(a, threads, smem, s));
    case 8: return static_cast<int>(launch_find_hh<8>(a, threads, smem, s));
    default:
      return static_cast<int>(launch_find_hh<0>(a, threads, smem, s));
  }
}
