// Inclusive row scans for the planner: one templated kernel, four entries.
//
// Replaces four Pallas kernels of lac_tpu/ops/pallas_kernels.py:
//   split_cumsums_u32 (_split_cumsum_kernel): prefix sums of u >> 16 and
//       u & 0xFFFF from one read of u (the stateful Rice adapter's sums),
//   cumsum_u32 (_cumsum_kernel): u32 prefix sum of the packed micro-window
//       flags,
//   prefix_max_i32 (_prefix_max_kernel): running max (last non-zero index),
//   suffix_min_i32 (_suffix_min_kernel): running min from the right (next
//       non-zero index).
// Sums wrap in uint32 (every sum on the planner's path is <= 2^30).
//
// Bound: device-memory bandwidth: one read and one (or two) writes per
// element, a handful of integer ops between. The TPU kernels rotate
// lanes in log steps (pltpu.roll) inside 2048-wide tiles and carry a
// row's running value across the sequential grid in VMEM scratch. Blocks
// run in no order on Hopper, so a row never spans blocks and its carry
// lives in a register. Two kernels, chosen by row length:
//
// Short rows (n <= LAC_SCAN_SHORT_MAX; the 256-sample probe lanes):
// row_scan_warp. One warp owns a row, a block of 256 threads takes 8
// rows, and nothing leaves the registers:
//   1. a lane loads 8 consecutive elements (two 128-bit loads; 32 lanes
//      x 8 = one 256-sample probe row in one step),
//   2. scans them serially,
//   3. the warp scans the 32 lane totals with five shuffle steps,
//   4. each lane adds its exclusive prefix and the row's carry and
//      stores its 8 results (two 128-bit stores).
// Longer short rows walk in 256-element steps, the carry broadcast from
// lane 31. No shared memory, no block barrier. The reverse direction
// maps scan position p to element n - 1 - p and reverses the four words
// of a vector in registers, so loads and stores stay 128-bit and
// coalesced; the ragged step then lies at the row's left end. The vector
// path needs n % 4 == 0 and 16-byte aligned operands; other rows take
// the same kernel with one load and store per element, masked slots
// holding the op's identity.
//
// Long rows: row_scan_long. One block of 512 threads (16 warps) owns a row
// and takes it in chunks of 16384 elements (one chunk on every path shape),
// registers only:
//   1. a lane issues the chunk's eight 128-bit loads before it uses one, so
//      a row costs one DRAM round trip and 64 KB per block is in flight;
//      the layout makes every load and store instruction of a warp cover 512
//      contiguous bytes: a chunk is 64 pieces of 256 elements, warp w takes
//      pieces w, w + 16, w + 32, w + 48, and in each piece lane l holds
//      elements 4 l .. 4 l + 3 of both 128-element halves,
//   2. each piece: serial scans of the lane's two runs of 4, five shuffle
//      steps over the run totals of each half, the piece total to shared
//      memory,
//   3. one block barrier a chunk; every warp scans the 64 piece totals (two
//      a lane: a serial step and five shuffle steps), which with the row's
//      carry gives each piece its exclusive prefix,
//   4. each lane applies its prefixes and stores with 128-bit stores; a
//      longer row carries the chunk total into the next chunk (the totals
//      are double-buffered by chunk, so one barrier a chunk suffices).
// The reverse direction, the vector condition and the scalar path are
// row_scan_warp's, and a chunk that ends inside the row masks its slots
// with the op's identity. The 4-byte ops fit 64 registers: two blocks an
// SM, 128 KB in flight. Not row_scan_warp's layout (8 consecutive
// elements a lane, 16-byte loads at a 32-byte lane stride): each of its
// instructions covers half of every sector it touches, and with the
// operands in L2 that made this kernel up to 1.8x slower.
//
// Where "short" ends: LAC_SCAN_SHORT_MAX (a build-time macro so that one
// command can time the choices against each other,
// lac_tpu_torch/ab_kernels.py). A warp walks a 2048-element row in 8
// steps while the block kernel would spend a 16384-element chunk on it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#ifndef LAC_SCAN_SHORT_MAX
#define LAC_SCAN_SHORT_MAX 2048
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Pair {
  uint32_t hi, lo;
};

__device__ __forceinline__ uint32_t shfl_up(uint32_t v, int d) { return __shfl_up_sync(kFull, v, d); }
__device__ __forceinline__ int32_t shfl_up(int32_t v, int d) { return __shfl_up_sync(kFull, v, d); }
__device__ __forceinline__ Pair shfl_up(Pair v, int d) {
  return Pair{__shfl_up_sync(kFull, v.hi, d), __shfl_up_sync(kFull, v.lo, d)};
}
__device__ __forceinline__ uint32_t shfl_from(uint32_t v, int l) { return __shfl_sync(kFull, v, l); }
__device__ __forceinline__ int32_t shfl_from(int32_t v, int l) { return __shfl_sync(kFull, v, l); }
__device__ __forceinline__ Pair shfl_from(Pair v, int l) {
  return Pair{__shfl_sync(kFull, v.hi, l), __shfl_sync(kFull, v.lo, l)};
}

// 128-bit store of four results at element offset i (i % 4 == 0, aligned outputs)
__device__ __forceinline__ void store4(void* o0, void*, long long i, uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
  *reinterpret_cast<uint4*>(static_cast<uint32_t*>(o0) + i) = make_uint4(a, b, c, d);
}
__device__ __forceinline__ void store4(void* o0, void*, long long i, int32_t a, int32_t b, int32_t c,
                                       int32_t d) {
  *reinterpret_cast<int4*>(static_cast<int32_t*>(o0) + i) = make_int4(a, b, c, d);
}
__device__ __forceinline__ void store4(void* o0, void* o1, long long i, Pair a, Pair b, Pair c, Pair d) {
  *reinterpret_cast<uint4*>(static_cast<uint32_t*>(o0) + i) = make_uint4(a.hi, b.hi, c.hi, d.hi);
  *reinterpret_cast<uint4*>(static_cast<uint32_t*>(o1) + i) = make_uint4(a.lo, b.lo, c.lo, d.lo);
}

// 128-bit stores of four results at element offset i (i % 4 == 0, aligned
// outputs) for the long-row kernel, one instruction each: nvcc splits one of
// store4's vector stores there into four 32-bit ones (in the reverse
// direction), as it did in row_scan_warp's unrolled loop
__device__ __forceinline__ void stg_v4(void* p, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(a), "r"(b), "r"(c), "r"(d) : "memory");
}
__device__ __forceinline__ void stg4(void* o0, void*, long long i, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  stg_v4(static_cast<uint32_t*>(o0) + i, a, b, c, d);
}
__device__ __forceinline__ void stg4(void* o0, void*, long long i, int32_t a, int32_t b, int32_t c, int32_t d) {
  stg_v4(static_cast<int32_t*>(o0) + i, a, b, c, d);
}
__device__ __forceinline__ void stg4(void* o0, void* o1, long long i, Pair a, Pair b, Pair c, Pair d) {
  stg_v4(static_cast<uint32_t*>(o0) + i, a.hi, b.hi, c.hi, d.hi);
  stg_v4(static_cast<uint32_t*>(o1) + i, a.lo, b.lo, c.lo, d.lo);
}

// Each op: value type T, raw input element type Raw, identity, combine,
// how a raw element becomes a value, how a value is stored.
struct SplitAddU32 {
  using T = Pair;
  using Raw = uint32_t;
  static __device__ __forceinline__ T identity() { return Pair{0u, 0u}; }
  static __device__ __forceinline__ T op(T a, T b) { return Pair{a.hi + b.hi, a.lo + b.lo}; }
  static __device__ __forceinline__ T load(Raw r) { return Pair{r >> 16, r & 0xFFFFu}; }
  static __device__ __forceinline__ void store(void* o0, void* o1, long long i, T v) {
    static_cast<uint32_t*>(o0)[i] = v.hi;
    static_cast<uint32_t*>(o1)[i] = v.lo;
  }
};

struct AddU32 {
  using T = uint32_t;
  using Raw = uint32_t;
  static __device__ __forceinline__ T identity() { return 0u; }
  static __device__ __forceinline__ T op(T a, T b) { return a + b; }
  static __device__ __forceinline__ T load(Raw r) { return r; }
  static __device__ __forceinline__ void store(void* o0, void*, long long i, T v) {
    static_cast<uint32_t*>(o0)[i] = v;
  }
};

struct MaxI32 {
  using T = int32_t;
  using Raw = int32_t;
  static __device__ __forceinline__ T identity() { return INT_MIN; }
  static __device__ __forceinline__ T op(T a, T b) { return a > b ? a : b; }
  static __device__ __forceinline__ T load(Raw r) { return r; }
  static __device__ __forceinline__ void store(void* o0, void*, long long i, T v) {
    static_cast<int32_t*>(o0)[i] = v;
  }
};

struct MinI32 {
  using T = int32_t;
  using Raw = int32_t;
  static __device__ __forceinline__ T identity() { return INT_MAX; }
  static __device__ __forceinline__ T op(T a, T b) { return a < b ? a : b; }
  static __device__ __forceinline__ T load(Raw r) { return r; }
  static __device__ __forceinline__ void store(void* o0, void*, long long i, T v) {
    static_cast<int32_t*>(o0)[i] = v;
  }
};

constexpr int kLaneItems = 8;                // elements a lane holds in one step
constexpr int kWarpStep = 32 * kLaneItems;   // elements a warp scans in one step

// Short rows: one warp per row, registers only (see the header).
template <class Op, bool kReverse, bool kVec>
__global__ void __launch_bounds__(kThreads)
row_scan_warp(const void* __restrict__ in, void* o0, void* o1, long long rows, long long n) {
  using T = typename Op::T;
  using Raw = typename Op::Raw;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave together: the shuffles below stay full-mask
  const long long row_off = row * n;
  const Raw* src = static_cast<const Raw*>(in) + row_off;
  T carry = Op::identity();

  // not unrolled: nvcc's two-step unrolling of the add scan left a remainder
  // step, the only one a 256-sample row runs, with a 128-bit store split
  // into four 32-bit ones
#pragma unroll 1
  for (long long base = 0; base < n; base += kWarpStep) {
    // 1. this lane's run: scan positions p0 .. p0 + 7; position p is
    // element p, or n - 1 - p in the reverse direction
    const long long p0 = base + lane * kLaneItems;
    T v[kLaneItems];
#pragma unroll
    for (int h = 0; h < kLaneItems; h += 4) {
      if (kVec) {
        // n % 4 == 0: a vector lies inside the row whole or not at all
        const long long e = kReverse ? n - 4 - (p0 + h) : p0 + h;  // its first element
        if (p0 + h < n) {
          const int4 q = __ldg(reinterpret_cast<const int4*>(src + e));
          v[h + 0] = Op::load(static_cast<Raw>(kReverse ? q.w : q.x));
          v[h + 1] = Op::load(static_cast<Raw>(kReverse ? q.z : q.y));
          v[h + 2] = Op::load(static_cast<Raw>(kReverse ? q.y : q.z));
          v[h + 3] = Op::load(static_cast<Raw>(kReverse ? q.x : q.w));
        } else {
          v[h + 0] = v[h + 1] = v[h + 2] = v[h + 3] = Op::identity();
        }
      } else {
#pragma unroll
        for (int j = h; j < h + 4; ++j) {
          const long long p = p0 + j;
          v[j] = p < n ? Op::load(src[kReverse ? n - 1 - p : p]) : Op::identity();
        }
      }
    }

    // 2. serial scan of the run
#pragma unroll
    for (int j = 1; j < kLaneItems; ++j) v[j] = Op::op(v[j - 1], v[j]);

    // 3. warp scan of the run totals
    T incl = v[kLaneItems - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = shfl_up(incl, d);
      if (lane >= d) incl = Op::op(y, incl);
    }
    const T excl = shfl_up(incl, 1);
    const T prefix = lane > 0 ? Op::op(carry, excl) : carry;
    carry = Op::op(carry, shfl_from(incl, 31));

    // 4. fix-up and store
#pragma unroll
    for (int j = 0; j < kLaneItems; ++j) v[j] = Op::op(prefix, v[j]);
#pragma unroll
    for (int h = 0; h < kLaneItems; h += 4) {
      if (kVec) {
        if (p0 + h < n) {
          if (kReverse) {
            store4(o0, o1, row_off + n - 4 - (p0 + h), v[h + 3], v[h + 2], v[h + 1], v[h + 0]);
          } else {
            store4(o0, o1, row_off + p0 + h, v[h + 0], v[h + 1], v[h + 2], v[h + 3]);
          }
        }
      } else {
#pragma unroll
        for (int j = h; j < h + 4; ++j) {
          const long long p = p0 + j;
          if (p < n) Op::store(o0, o1, row_off + (kReverse ? n - 1 - p : p), v[j]);
        }
      }
    }
  }
}

// Long rows: one block per row, registers only (see the header).
constexpr int kLongWarps = 16;
constexpr int kLongThreads = 32 * kLongWarps;
constexpr int kHalf = 128;                        // elements a warp's 128-bit load covers: 4 a lane
constexpr int kPiece = 2 * kHalf;                 // a piece: two halves, 8 elements a lane
constexpr int kLongChunk = 16384;                 // elements between two barriers
constexpr int kPieces = kLongChunk / kPiece;      // 64, two a lane in the scan of their totals
constexpr int kLongSteps = kPieces / kLongWarps;  // pieces a warp takes in a chunk: w, w + 16, ...
constexpr int kLongVecs = 2 * kLongSteps;         // 128-bit loads a lane issues for a chunk
constexpr int kLongItems = 4 * kLongVecs;         // elements a lane holds
static_assert(kPieces == 64 && kPieces % kLongWarps == 0, "pieces of a chunk");

// Vector i of this lane (a step's half) starts at scan position p0 + off(i);
// the lane's first one, p0, is chunk base + 256 w + 4 lane.
__device__ __forceinline__ constexpr int long_off(int i) {
  return (i >> 1) * kLongWarps * kPiece + (i & 1) * kHalf;
}

// The chunk's 128-bit loads for this lane, all issued before any value is
// used; n % 4 == 0, so a vector lies inside the row whole or not at all.
// kFull: the chunk lies inside the row, no load needs a guard.
template <class Op, bool kReverse, bool kFull>
__device__ __forceinline__ void load_chunk(const typename Op::Raw* __restrict__ src, int n, int p0,
                                           int4 (&q)[kLongVecs]) {
  using Raw = typename Op::Raw;
  const Raw* at = kReverse ? src + (n - 4 - p0) : src + p0;
#pragma unroll
  for (int i = 0; i < kLongVecs; ++i) {
    const int off = long_off(i);
    q[i] = kFull || p0 + off < n ? __ldg(reinterpret_cast<const int4*>(at + (kReverse ? -off : off)))
                                 : make_int4(0, 0, 0, 0);
  }
}

// Scan and store one chunk of a row from scan position ``base``; its vectors
// are in ``q`` where kVec, else each element is loaded here. ``carry`` is the
// row's value before the chunk; ``tot`` the chunk's piece totals.
template <class Op, bool kReverse, bool kVec, bool kFull>
__device__ __forceinline__ void scan_chunk(const typename Op::Raw* __restrict__ src, void* o0, void* o1,
                                           long long row_off, int n, int base, const int4 (&q)[kLongVecs],
                                           typename Op::T (&tot)[kPieces], typename Op::T& carry) {
  using T = typename Op::T;
  using Raw = typename Op::Raw;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // slot 4 i + k holds scan position p0 + off(i) + k; position p is element
  // p, or n - 1 - p in the reverse direction
  const int p0 = base + warp * kPiece + lane * 4;
  T v[kLongItems];
  if (kVec) {  // a vector's words reversed in the reverse direction
#pragma unroll
    for (int i = 0; i < kLongVecs; ++i) {
      const int4 w = q[i];
      const bool in_row = kFull || p0 + long_off(i) < n;
      v[4 * i + 0] = in_row ? Op::load(static_cast<Raw>(kReverse ? w.w : w.x)) : Op::identity();
      v[4 * i + 1] = in_row ? Op::load(static_cast<Raw>(kReverse ? w.z : w.y)) : Op::identity();
      v[4 * i + 2] = in_row ? Op::load(static_cast<Raw>(kReverse ? w.y : w.z)) : Op::identity();
      v[4 * i + 3] = in_row ? Op::load(static_cast<Raw>(kReverse ? w.x : w.w)) : Op::identity();
    }
  } else {
    const Raw* at = kReverse ? src + (n - 1 - p0) : src + p0;
#pragma unroll
    for (int j = 0; j < kLongItems; ++j) {
      const int off = long_off(j / 4) + j % 4;
      v[j] = kFull || p0 + off < n ? Op::load(at[kReverse ? -off : off]) : Op::identity();
    }
  }

  // 1. each piece: serial scans of the two runs, warp scans of their totals;
  // pre0/pre1 are the lane's exclusive prefixes within the piece, lane 31
  // writes the piece total
  T pre0[kLongSteps], pre1[kLongSteps];
#pragma unroll
  for (int s = 0; s < kLongSteps; ++s) {
    T* r = v + 8 * s;
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      r[k] = Op::op(r[k - 1], r[k]);
      r[4 + k] = Op::op(r[3 + k], r[4 + k]);
    }
    T i0 = r[3], i1 = r[7];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y0 = shfl_up(i0, d), y1 = shfl_up(i1, d);
      if (lane >= d) {
        i0 = Op::op(y0, i0);
        i1 = Op::op(y1, i1);
      }
    }
    const T e0 = shfl_up(i0, 1), e1 = shfl_up(i1, 1);
    const T first = shfl_from(i0, 31);  // the first half's total
    pre0[s] = lane > 0 ? e0 : Op::identity();
    pre1[s] = lane > 0 ? Op::op(first, e1) : first;
    if (lane == 31) tot[s * kLongWarps + warp] = Op::op(first, i1);
  }

  // 2. across pieces: one barrier, then every warp scans the 64 totals, two a
  // lane (a serial step and five shuffle steps)
  __syncthreads();
  const T t0 = tot[2 * lane];
  T incl = Op::op(t0, tot[2 * lane + 1]);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up(incl, d);
    if (lane >= d) incl = Op::op(y, incl);
  }
  const T up = shfl_up(incl, 1);
  const T even = lane > 0 ? Op::op(carry, up) : carry;  // the row before piece 2 lane
  const T odd = Op::op(even, t0);                       // ... and before piece 2 lane + 1
  carry = Op::op(carry, shfl_from(incl, 31));

  // 3. fix-up and 128-bit stores
#pragma unroll
  for (int s = 0; s < kLongSteps; ++s) {
    const int pc = s * kLongWarps + warp;  // the piece: odd or even alike in every lane of the warp
    const T before_even = shfl_from(even, pc >> 1), before_odd = shfl_from(odd, pc >> 1);
    const T before = pc & 1 ? before_odd : before_even;
    const T prefix0 = Op::op(before, pre0[s]), prefix1 = Op::op(before, pre1[s]);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[8 * s + k] = Op::op(k < 4 ? prefix0 : prefix1, v[8 * s + k]);
  }
  if (kVec) {
    const long long at = row_off + (kReverse ? n - 4 - p0 : p0);
#pragma unroll
    for (int i = 0; i < kLongVecs; ++i) {
      const int off = long_off(i);
      const T* r = v + 4 * i;
      if (kFull || p0 + off < n) {
        if (kReverse) {
          stg4(o0, o1, at - off, r[3], r[2], r[1], r[0]);
        } else {
          stg4(o0, o1, at + off, r[0], r[1], r[2], r[3]);
        }
      }
    }
  } else {
    const long long at = row_off + (kReverse ? n - 1 - p0 : p0);
#pragma unroll
    for (int j = 0; j < kLongItems; ++j) {
      const int off = long_off(j / 4) + j % 4;
      if (kFull || p0 + off < n) Op::store(o0, o1, at + (kReverse ? -off : off), v[j]);
    }
  }
}

// Two blocks an SM (64 registers) for the 4-byte ops' vector path; the scalar
// path's 32 element addresses take more registers, and the split sums hold
// two values an element.
template <class Op, bool kReverse, bool kVec>
__global__ void __launch_bounds__(kLongThreads, sizeof(typename Op::T) == 4 && kVec ? 2 : 1)
row_scan_long(const void* __restrict__ in, void* o0, void* o1, int n) {
  using T = typename Op::T;
  using Raw = typename Op::Raw;
  __shared__ T tot[2][kPieces];  // by chunk parity: a warp reads one while the next is written
  const long long row_off = (long long)blockIdx.x * n;
  const Raw* src = static_cast<const Raw*>(in) + row_off;
  const int p0 = (threadIdx.x >> 5) * kPiece + (threadIdx.x & 31) * 4;  // in a chunk
  T carry = Op::identity();
  int4 q[kLongVecs];
  int base = 0, buf = 0;
  for (; base + kLongChunk <= n; base += kLongChunk, buf ^= 1) {
    if (kVec) load_chunk<Op, kReverse, true>(src, n, base + p0, q);
    scan_chunk<Op, kReverse, kVec, true>(src, o0, o1, row_off, n, base, q, tot[buf], carry);
  }
  if (base < n) {
    if (kVec) load_chunk<Op, kReverse, false>(src, n, base + p0, q);
    scan_chunk<Op, kReverse, kVec, false>(src, o0, o1, row_off, n, base, q, tot[buf], carry);
  }
}

__host__ inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class Op, bool kReverse>
int launch(const void* in, void* o0, void* o1, long long rows, long long n, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 4 == 0 && aligned16(in) && aligned16(o0) && aligned16(o1);
  if (n <= LAC_SCAN_SHORT_MAX) {
    const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
    if (vec) {
      row_scan_warp<Op, kReverse, true><<<blocks, kThreads, 0, s>>>(in, o0, o1, rows, n);
    } else {
      row_scan_warp<Op, kReverse, false><<<blocks, kThreads, 0, s>>>(in, o0, o1, rows, n);
    }
  } else if (n > INT_MAX - kLongChunk || rows > INT_MAX) {
    return (int)cudaErrorInvalidValue;  // positions in a row are int, a row is a block
  } else if (vec) {
    row_scan_long<Op, kReverse, true><<<(unsigned)rows, kLongThreads, 0, s>>>(in, o0, o1, (int)n);
  } else {
    row_scan_long<Op, kReverse, false><<<(unsigned)rows, kLongThreads, 0, s>>>(in, o0, o1, (int)n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lac_split_cumsums_u32(const void* u, long long rows, long long n, void* hi, void* lo,
                                     void* stream, int device) {
  return launch<SplitAddU32, false>(u, hi, lo, rows, n, stream, device);
}

extern "C" int lac_cumsum_u32(const void* u, long long rows, long long n, void* out, void* stream,
                              int device) {
  return launch<AddU32, false>(u, out, nullptr, rows, n, stream, device);
}

extern "C" int lac_prefix_max_i32(const void* x, long long rows, long long n, void* out, void* stream,
                                  int device) {
  return launch<MaxI32, false>(x, out, nullptr, rows, n, stream, device);
}

extern "C" int lac_suffix_min_i32(const void* x, long long rows, long long n, void* out, void* stream,
                                  int device) {
  return launch<MinI32, true>(x, out, nullptr, rows, n, stream, device);
}
