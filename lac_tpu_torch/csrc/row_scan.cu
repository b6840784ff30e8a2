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
// run in no order on Hopper, so one block owns a whole row and walks it
// tile by tile, keeping the carry in a register:
//   1. coalesced load of a tile into shared memory (the ragged edge and
//      the reverse direction are handled by the index map, masked slots
//      hold the op's identity),
//   2. each thread scans its contiguous run of kItems elements serially,
//   3. warp shuffles scan the run totals, one warp scans the warp totals,
//   4. each thread applies its exclusive prefix (carry, earlier warps,
//      earlier lanes) to its run, and the tile is stored coalesced.
// Shared-memory slots are padded by one word per 32 so that the serial
// runs of step 2 hit distinct banks. Rows of n <= 2048 (probe lanes,
// short tails) use one element per thread, so a 256-sample row is one
// tile with every thread busy.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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

template <class Op, bool kReverse>
int launch(const void* in, void* o0, void* o1, long long rows, long long n, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 2048) {
    row_scan<Op, kReverse, 1><<<(unsigned)rows, kThreads, 0, s>>>(in, o0, o1, n);
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
