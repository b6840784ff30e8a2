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
// Bound on the H100: 4 bytes read and 4 written per sample, 0.110 ms at the
// path's shape (2816, 16384), against the integer work, counted at 120
// 32-bit instructions per sample in chip_smoke.py, 0.165 ms at the card's
// peak instruction rate: it is bound by instructions issued, so the design
// cuts serial steps, barriers and 64-bit work.
//
// Design: one block of 256 threads per row walks it in tiles of 2048
// samples, 8 contiguous samples per thread, with s before the tile carried
// in a register. Against the first Hopper version of this kernel:
//   1. The next tile's codes are copied into shared memory (cp.async, two
//      buffers, each thread its own 32 bytes) while the block computes this
//      one, so device-memory latency is off the walk. Scans are per warp
//      only: s and the flag sums are kept as warp-local inclusive sums in
//      shared memory with the warp totals beside them, and a look-back into
//      another warp adds that warp's total (the 256-sample drift window is
//      exactly one warp back). Each tile takes two block barriers (after the
//      sums of s, after the flag sums), not four, and no block-wide scan.
//   2. The previous tile's last warp keeps its sums of s (256 values) and
//      its last 96 flag sums in small double-buffered arrays, so the next
//      tile overwrites its shared memory without a trailing barrier.
//      57-62 registers and 46 KB of static shared memory: 4 blocks per SM.
//   3. 32-bit arithmetic where the ranges allow it. The window sum
//      s - s[i-256] <= 256 (2^32 - 1) < 2^40, so lm < 2^32: lm is a u32,
//      t1 = ((3 lm - 1) >> 2) + 1 < 3 * 2^30 + 1 is a u32 and c * t1 one
//      32x32->64 multiply. t2 = floor((4 lm + 3) / 3) + 1 = lm + floor(lm / 3)
//      + 2 can reach 2^33, so c * t2 is c * lm + c * (floor(lm / 3) + 2),
//      and floor(lm / 3) is the u32 multiply-high by 0xAAAAAAAB shifted right
//      once, exact for every u32 (no 64-bit division). In k_base,
//      M >> k0 < 2^bit_width(c) <= 2^15, so one funnel shift of M's two words
//      gives it for k0 <= 30, and k0 >= 31 gives 31. k_base, the drift bias
//      and the micro bias are computed without branches and selected.
//   4. No flag carry: only s crosses tiles, as a u64 register; the micro
//      window reads the previous tile's last 96 flag sums and flag total.
// A design with one thread-block cluster per row (one block per tile, the
// tile totals and look-backs read over distributed shared memory) was
// measured first and was slower than the one-block-per-row kernel it was to
// replace: its blocks live for one tile, so each waits on its loads and on
// two cluster barriers with little else resident to hide them (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // 2048 samples
constexpr int kMaxTiles = 8;              // rows of at most 16384 samples
constexpr int kDrift = 256;               // C.DRIFT_WINDOW: one warp's samples
constexpr int kMicro = 96;                // C.MICRO_WINDOW
constexpr int kMicroLanes = kMicro / kItems;  // lanes whose micro window starts in the previous warp
constexpr int kMaxK = 31;                 // C.MAX_RICE_K
constexpr unsigned kFull = 0xFFFFFFFFu;

template <class T>
__device__ __forceinline__ T warp_inclusive_sum(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// k_base of a sample with N = s + (c >> 1), 1 <= c <= 16384, without branches
__device__ __forceinline__ int k_base(u64 N, uint32_t c) {
  const u64 M = N - c;  // wraps where N < c, a case the last line discards
  const int k0 = max((64 - __clzll((long long)M)) - (32 - __clz(c)), 0);
  // for k0 <= 30 the low word of M >> k0, which is all of it (< 2^15); for
  // k0 >= 31 the minimum below gives 31 whatever it holds
  const uint32_t q = __funnelshift_r((uint32_t)M, (uint32_t)(M >> 32), k0);
  const int k = min(k0 + (q >= c ? 1 : 0), kMaxK);
  return N < 2ull * c ? 0 : k;
}

// drift bias of a sample with window sum W = s - s[i-256], without branches
// (the caller keeps it where c > 256 and N >= c)
__device__ __forceinline__ int drift_bias(u64 N, uint32_t c, u64 W) {
  const uint32_t lm = (uint32_t)((W + (kDrift >> 1)) >> 8);
  const bool up = lm >= 1 && N < (u64)c * ((uint32_t)((3ull * lm - 1) >> 2) + 1u);
  const uint32_t third = __umulhi(lm, 0xAAAAAAABu) >> 1;  // floor(lm / 3)
  const bool down = N >= (u64)c * lm + (u64)c * (third + 2u);
  return up ? 1 : down ? -1 : 0;
}

// packed micro-window flag of a sample: large in the low half, zero in the high
__device__ __forceinline__ uint32_t flag(uint32_t u, int k) {
  const uint32_t q = k >= kMaxK ? 0u : u >> k;
  return (q > 3u ? 1u : 0u) + (q == 0u ? 1u << 16 : 0u);
}

// 16 bytes from device memory into shared memory, asynchronously
__device__ __forceinline__ void cp_async16(uint4* smem, const uint32_t* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__global__ void __launch_bounds__(kThreads)
k_after_kernel(const uint32_t* __restrict__ codes, int32_t* __restrict__ k_after, int tiles) {
  __shared__ u64 s_sh[kItems][kThreads];       // warp-local inclusive sums of u
  __shared__ uint32_t f_sh[kItems][kThreads];  // warp-local inclusive sums of the flags
  __shared__ u64 s_warp[kWarps];               // warp totals of u
  __shared__ uint32_t f_warp[kWarps];          // warp totals of the flags
  // the last warp's sums of the previous tile, kept apart for warp 0's look-backs
  __shared__ u64 last_s[2][kItems][32];
  __shared__ u64 last_s_tot[2];
  __shared__ uint32_t last_f[2][kItems][kMicroLanes];
  __shared__ uint32_t last_f_tot[2];
  __shared__ uint4 stage[2][2][kThreads];  // the next tile's codes, each thread's own 32 bytes

  const int T = threadIdx.x, lane = T & 31, warp = T >> 5;
  const long long n = (long long)tiles * kTile;
  const uint32_t* src = codes + (long long)blockIdx.x * n + T * kItems;
  int32_t* dst = k_after + (long long)blockIdx.x * n + T * kItems;
  const int j0 = T * kItems;

  cp_async16(&stage[0][0][T], src);
  cp_async16(&stage[0][1][T], src + 4);
  u64 carry = 0;  // s before the tile
  for (int t = 0; t < tiles; ++t) {
    const int p = t & 1;
    const long long base = (long long)t * kTile;
    cp_async_wait_all();
    uint32_t u[kItems];
    {
      const uint4 a = stage[p][0][T], b = stage[p][1][T];
      u[0] = a.x, u[1] = a.y, u[2] = a.z, u[3] = a.w, u[4] = b.x, u[5] = b.y, u[6] = b.z, u[7] = b.w;
    }
    if (t + 1 < tiles) {
      cp_async16(&stage[p ^ 1][0][T], src + base + kTile);
      cp_async16(&stage[p ^ 1][1][T], src + base + kTile + 4);
    }

    // 1. warp-local inclusive sums of u and the warp totals
    u64 a[kItems], acc = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) a[j] = acc += u[j];
    const u64 incl = warp_inclusive_sum(acc);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      a[j] += incl - acc;
      s_sh[j][T] = a[j];
      if (warp == kWarps - 1) last_s[p][j][lane] = a[j];
    }
    if (lane == 31) {
      s_warp[warp] = incl;
      if (warp == kWarps - 1) last_s_tot[p] = incl;
    }
    __syncthreads();

    // 2. s before this warp and the tile's total, from the warp totals
    u64 wt = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const u64 y = __shfl_up_sync(kFull, wt, d);
      if (lane >= d) wt += y;
    }
    const u64 before = __shfl_sync(kFull, wt, (warp + kWarps - 1) & (kWarps - 1));
    const u64 pre = carry + (warp > 0 ? before : 0);
    carry += __shfl_sync(kFull, wt, kWarps - 1);

    // the warp 256 samples back: the previous warp, or the previous tile's
    // last (tile 0's warp 0 has no drift window)
    const u64* back = warp > 0 ? &s_sh[0][T - 32] : &last_s[p ^ 1][0][lane];
    const int back_step = warp > 0 ? kThreads : 32;
    const u64 back_tot = warp > 0 ? s_warp[warp - 1] : last_s_tot[p ^ 1];

    // 3. k_base, the drift bias and the flags
    int kb[kItems], bias[kItems];
    uint32_t f[kItems], facc = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const uint32_t c = (uint32_t)(base + j0 + j + 1);
      const u64 N = pre + a[j] + (c >> 1);
      const int k = k_base(N, c);
      const int bd = drift_bias(N, c, back_tot + a[j] - back[j * back_step]);
      bias[j] = c > kDrift && N >= c ? bd : 0;
      kb[j] = k;
      f[j] = facc += flag(u[j], k);
    }
    const uint32_t fincl = warp_inclusive_sum(facc);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      f[j] += fincl - facc;
      f_sh[j][T] = f[j];
      if (warp == kWarps - 1 && lane >= 32 - kMicroLanes) last_f[p][j][lane - (32 - kMicroLanes)] = f[j];
    }
    if (lane == 31) {
      f_warp[warp] = fincl;
      if (warp == kWarps - 1) last_f_tot[p] = fincl;
    }
    __syncthreads();

    // 4. the micro-window bias and k_after; the flag sum 96 samples back is
    //    12 threads back: this warp, the previous warp, or the previous tile
    int out[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      uint32_t w = f[j];
      if (lane >= kMicroLanes) {
        w -= f_sh[j][T - kMicroLanes];
      } else if (warp > 0) {
        w += f_warp[warp - 1] - f_sh[j][T - kMicroLanes];
      } else if (t > 0) {
        w += last_f_tot[p ^ 1] - last_f[p ^ 1][j][lane];
      }
      const bool on = base + j0 + j + 1 >= kMicro;
      const bool large = (w & 0xFFFFu) * 4 >= kMicro * 3, zero = (w >> 16) * 5 >= kMicro * 4;
      const int bj = !on ? bias[j] : large ? min(bias[j] + 1, 1) : zero ? max(bias[j] - 1, -1) : bias[j];
      out[j] = min(max(kb[j] + bj, 0), kMaxK);
    }
    int4* o = reinterpret_cast<int4*>(dst + base);
    o[0] = make_int4(out[0], out[1], out[2], out[3]);
    o[1] = make_int4(out[4], out[5], out[6], out[7]);
  }
}

}  // namespace

// codes, k_after: (rows, n) contiguous, 16-byte aligned; n a multiple of
// 2048 in [2048, 16384]; any rows.
extern "C" int lac_k_after_stateful(const void* codes, long long rows, long long n, void* k_after,
                                    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < kTile || n > kMaxTiles * kTile || n % kTile != 0 || rows > 0x7FFFFFFFLL) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0) return 0;
  k_after_kernel<<<(unsigned)rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(codes), static_cast<int32_t*>(k_after), (int)(n / kTile));
  return (int)cudaGetLastError();
}
