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
// Long rows: row_scan. One block owns a row and walks it tile by tile
// (4096 elements, 16 per thread):
//   1. coalesced load of a tile into shared memory (the ragged edge and
//      the reverse direction are handled by the index map, masked slots
//      hold the op's identity),
//   2. each thread scans its contiguous run of kItems elements serially,
//   3. warp shuffles scan the run totals, one warp scans the warp totals,
//   4. each thread applies its exclusive prefix (carry, earlier warps,
//      earlier lanes) to its run, and the tile is stored coalesced.
// Shared-memory slots are padded by one word per 32 so that the serial
// runs of step 2 hit distinct banks.
//
// Where "short" ends: LAC_SCAN_SHORT_MAX (a build-time macro so that one
// command can time the choices against each other,
// lac_tpu_torch/ab_kernels.py). A warp walks a 2048-element row in 8
// steps while the tile kernel would spend a 4096-slot tile on it.

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

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

template <class Op, bool kReverse, int kItems>
__global__ void __launch_bounds__(kThreads)
row_scan(const void* __restrict__ in, void* o0, void* o1, long long n) {
  using T = typename Op::T;
  using Raw = typename Op::Raw;
  constexpr int kTile = kThreads * kItems;
  __shared__ T tile[kTile + kTile / 32];
  __shared__ T warp_tot[kWarps];

  const long long row_off = (long long)blockIdx.x * n;
  const Raw* src = static_cast<const Raw*>(in) + row_off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T carry = Op::identity();

  for (long long base = 0; base < n; base += kTile) {
    // 1. coalesced load; logical position p walks the row in scan order
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const long long p = base + i;
      T v = Op::identity();
      if (p < n) v = Op::load(src[kReverse ? n - 1 - p : p]);
      tile[padded(i)] = v;
    }
    __syncthreads();

    // 2. serial scan of this thread's run
    const int r0 = threadIdx.x * kItems;
    T acc = tile[padded(r0)];
#pragma unroll
    for (int j = 1; j < kItems; ++j) {
      acc = Op::op(acc, tile[padded(r0 + j)]);
      tile[padded(r0 + j)] = acc;
    }

    // 3. scan of run totals: within the warp, then across warps
    T incl = acc;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T y = shfl_up(incl, d);
      if (lane >= d) incl = Op::op(y, incl);
    }
    const T excl_in_warp = shfl_up(incl, 1);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      T w = lane < kWarps ? warp_tot[lane] : Op::identity();
#pragma unroll
      for (int d = 1; d < kWarps; d <<= 1) {
        const T y = shfl_up(w, d);
        if (lane >= d) w = Op::op(y, w);
      }
      if (lane < kWarps) warp_tot[lane] = w;
    }
    __syncthreads();

    // 4. fix-up with the exclusive prefix, then coalesced store
    T prefix = carry;
    if (warp > 0) prefix = Op::op(prefix, warp_tot[warp - 1]);
    if (lane > 0) prefix = Op::op(prefix, excl_in_warp);
#pragma unroll
    for (int j = 0; j < kItems; ++j) tile[padded(r0 + j)] = Op::op(prefix, tile[padded(r0 + j)]);
    carry = Op::op(carry, warp_tot[kWarps - 1]);
    __syncthreads();
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const long long p = base + i;
      if (p < n) Op::store(o0, o1, row_off + (kReverse ? n - 1 - p : p), tile[padded(i)]);
    }
    __syncthreads();  // the next tile reuses tile[] and warp_tot[]
  }
}

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

__host__ inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class Op, bool kReverse>
int launch(const void* in, void* o0, void* o1, long long rows, long long n, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= LAC_SCAN_SHORT_MAX) {
    const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
    if (n % 4 == 0 && aligned16(in) && aligned16(o0) && aligned16(o1)) {
      row_scan_warp<Op, kReverse, true><<<blocks, kThreads, 0, s>>>(in, o0, o1, rows, n);
    } else {
      row_scan_warp<Op, kReverse, false><<<blocks, kThreads, 0, s>>>(in, o0, o1, rows, n);
    }
  } else {
    row_scan<Op, kReverse, 16><<<(unsigned)rows, kThreads, 0, s>>>(in, o0, o1, n);
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
