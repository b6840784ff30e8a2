// The stateful Rice k-adapter in one pass: u32 codes in, int32 k_after out.
//
// Replaces lac_tpu/ops/pallas_adapt.py:k_after_stateful_fused (kernel body
// _k_after_kernel), which computes adapt.k_after_stateful, the closed form of
// the reference's serial adapter (rice.hpp:45-114). Per sample i of a row,
// count c = i + 1:
//   s = u[0] + ... + u[i] (u64, < 2^46), N = s + (c >> 1),
//   k_base = N < 2c ? 0 : min(31, bit_width(floor(N / c) - 1)), division-free:
//       with M = N - c, k0 = max(bit_width(M) - bit_width(c), 0), k_base is
//       k0 or k0 + 1 as (M >> k0) >= c,
//   drift bias (i >= 256 and N >= c): lm = (s - s[i-256] + 128) >> 8;
//       +1 if lm >= 1 and N < c * (((3 lm - 1) >> 2) + 1),
//       else -1 if N >= c * (floor((4 lm + 3) / 3) + 1),
//   micro bias (c >= 96): q = k_base >= 31 ? 0 : u >> k_base, flags
//       large = q > 3 and zero = q == 0 counted over the last 96 samples from
//       one u32 prefix sum of large + (zero << 16) (counts < 2^16); +1 (at
//       most 1) if 4 large >= 288, else -1 (at least -1) if 5 zero >= 384,
//   k_after = clamp(k_base + bias, 0, 31).
//
// Design for Hopper, not carried over from the Pallas body:
//   * 64-bit integer lanes exist here. Prefix sums and the window products
//     (< 2^47 for rows of at most 16384 samples) stay in uint64_t, and
//     floor(x / 3) is an integer division by a constant. The TPU kernel kept
//     them as base-2^16 limb triples in i32 lanes and divided by 3 in f32,
//     because Mosaic has no 64-bit integer lanes.
//   * Blocks run in no order, so the TPU kernel's sequential column grid with
//     carries in VMEM scratch becomes one block of 256 threads per row that
//     walks the row in tiles of 2048 samples, 8 contiguous samples per thread
//     (two 16-byte loads and stores), with both running sums carried in
//     registers across tiles. Each tile does two block-wide scans: s, then the
//     packed flags, whose k_base needs s.
//   * The windows look back 256 samples (s) and 96 (flag sums), into the
//     previous tile. Shared memory holds the current tile's values behind the
//     previous tile's last 256 s (u64) and last 96 flag sums (u32), padded one
//     slot per 8 so that the 8-sample runs of a warp hit distinct banks:
//     (2304 + 2144) slots * 9/8, 30 KB in all. That stays under the 48 KB of
//     static shared memory. A whole 16384-sample row (192 KB of s and flag
//     sums) would need the dynamic-shared-memory opt-in and would leave one
//     block per SM.
//
// Bound: the bytes, 4 read and 4 written per sample, against the integer
// work, about 100 32-bit integer instructions per sample (64-bit adds,
// compares and shifts count two or more; counted in chip_smoke.py). At the
// path's shape (2816, 16384) that is 369 MB against 4.6 G instructions; the
// larger of the two bounds is stated in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 samples
constexpr int kDrift = 256;               // C.DRIFT_WINDOW
constexpr int kMicro = 96;                // C.MICRO_WINDOW
constexpr int kMaxK = 31;                 // C.MAX_RICE_K
constexpr unsigned kFull = 0xFFFFFFFFu;

__host__ __device__ constexpr int padded(int i) { return i + (i >> 3); }

// Exclusive block-wide sum of one value per thread; ``total`` gets the sum
// of all. ``warp_tot`` is kWarps slots of shared memory that no other thread
// reads between this call and the caller's next __syncthreads.
template <class T>
__device__ __forceinline__ T block_exclusive_sum(T v, T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_tot[lane] : T(0);
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const T y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  total = warp_tot[kWarps - 1];
  return incl - v + (warp > 0 ? warp_tot[warp - 1] : T(0));
}

__device__ __forceinline__ int bit_width64(uint64_t x) { return 64 - __clzll((long long)x); }

__global__ void __launch_bounds__(kThreads)
k_after_kernel(const uint32_t* __restrict__ codes, int32_t* __restrict__ k_after, long long n) {
  // logical slot L of s_sh is s[base + L - kDrift]; of f_sh, the flag sum at base + L - kMicro
  __shared__ unsigned long long s_sh[padded(kDrift + kTile)];
  __shared__ uint32_t f_sh[padded(kMicro + kTile)];
  __shared__ unsigned long long s_tot[kWarps];
  __shared__ uint32_t f_tot[kWarps];

  const uint32_t* src = codes + (long long)blockIdx.x * n;
  int32_t* dst = k_after + (long long)blockIdx.x * n;
  const int j0 = threadIdx.x * kItems;  // this thread's first sample within a tile

  // before the row start both sums are 0
  for (int i = threadIdx.x; i < kDrift; i += kThreads) s_sh[padded(i)] = 0;
  for (int i = threadIdx.x; i < kMicro; i += kThreads) f_sh[padded(i)] = 0;
  unsigned long long s_carry = 0;
  uint32_t f_carry = 0;

  for (long long base = 0; base < n; base += kTile) {
    uint32_t u[kItems];
    const uint4* in = reinterpret_cast<const uint4*>(src + base + j0);
    const uint4 a = in[0], b = in[1];
    u[0] = a.x, u[1] = a.y, u[2] = a.z, u[3] = a.w, u[4] = b.x, u[5] = b.y, u[6] = b.z, u[7] = b.w;

    // 1. prefix sums s
    unsigned long long s[kItems];
    unsigned long long acc = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) s[j] = acc += u[j];
    unsigned long long tile_sum;
    const unsigned long long s_prefix = s_carry + block_exclusive_sum(acc, s_tot, tile_sum);
    s_carry += tile_sum;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      s[j] += s_prefix;
      s_sh[padded(kDrift + j0 + j)] = s[j];
    }
    __syncthreads();

    // 2. k_base, the drift bias and the packed micro-window flags
    int kb[kItems], bias[kItems];
    uint32_t f[kItems];
    uint32_t facc = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned long long c = base + j0 + j + 1;
      const unsigned long long N = s[j] + (c >> 1);
      int k = 0;
      if (N >= 2 * c) {
        const unsigned long long M = N - c;
        const int k0 = max(bit_width64(M) - bit_width64(c), 0);
        k = min(kMaxK, k0 + ((M >> k0) >= c ? 1 : 0));
      }
      int bd = 0;
      if (c > kDrift && N >= c) {
        const unsigned long long lm = (s[j] - s_sh[padded(j0 + j)] + (kDrift >> 1)) >> 8;
        if (lm >= 1 && N < c * (((3 * lm - 1) >> 2) + 1)) {
          bd = 1;
        } else if (N >= c * ((4 * lm + 3) / 3 + 1)) {
          bd = -1;
        }
      }
      kb[j] = k;
      bias[j] = bd;
      const uint32_t q = k >= kMaxK ? 0u : u[j] >> k;
      f[j] = facc += (q > 3u ? 1u : 0u) + (q == 0u ? 1u << 16 : 0u);
    }
    uint32_t tile_flags;
    const uint32_t f_prefix = f_carry + block_exclusive_sum(facc, f_tot, tile_flags);
    f_carry += tile_flags;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      f[j] += f_prefix;
      f_sh[padded(kMicro + j0 + j)] = f[j];
    }
    __syncthreads();

    // 3. the micro-window bias and k_after
    int out[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      int bj = bias[j];
      if (base + j0 + j + 1 >= kMicro) {
        const uint32_t w = f[j] - f_sh[padded(j0 + j)];
        if ((w & 0xFFFFu) * 4 >= kMicro * 3) {
          bj = min(bj + 1, 1);
        } else if ((w >> 16) * 5 >= kMicro * 4) {
          bj = max(bj - 1, -1);
        }
      }
      out[j] = min(max(kb[j] + bj, 0), kMaxK);
    }
    int4* o = reinterpret_cast<int4*>(dst + base + j0);
    o[0] = make_int4(out[0], out[1], out[2], out[3]);
    o[1] = make_int4(out[4], out[5], out[6], out[7]);

    // 4. keep this tile's last 256 s and 96 flag sums for the next look-back
    __syncthreads();
    if (threadIdx.x < kDrift) s_sh[padded(threadIdx.x)] = s_sh[padded(kTile + threadIdx.x)];
    if (threadIdx.x < kMicro) f_sh[padded(threadIdx.x)] = f_sh[padded(kTile + threadIdx.x)];
    __syncthreads();
  }
}

}  // namespace

// codes, k_after: (rows, n) contiguous, 16-byte aligned; n a multiple of
// 2048 in [2048, 16384]; any rows.
extern "C" int lac_k_after_stateful(const void* codes, long long rows, long long n, void* k_after,
                                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < kTile || n > 16384 || n % kTile != 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  k_after_kernel<<<(unsigned)rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), static_cast<int32_t*>(k_after), n);
  return (int)cudaGetLastError();
}
