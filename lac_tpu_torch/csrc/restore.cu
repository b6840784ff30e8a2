// Closed-loop FIR / LPC restore of the device decode backend: one thread
// per (block, channel) lane.
//
// Replaces the vmapped lax.scan of lac_tpu/ops/predictors.py:243
// (recurrence_restore), which is XLA code, not a Pallas kernel. Per lane:
//   x[n] = r[n] + (sum_{i <= min(n, order)} c[i] * x[n - i] >> shift)
// from n >= min_pred_n (before it x[n] = r[n]), for n < valid_len; the
// lane's ok flag clears where a restored sample leaves int32. FIR lanes
// are order 2 with taps {3, -1}, shift 2 and min_pred_n 2; LPC lanes
// order 1..32 with Q15 taps, shift 15 and min_pred_n 0.
//
// Bound: the serial chain. Each sample needs the one before it, and the
// >> truncation breaks superposition, so the work cannot be reassociated
// into a scan: a lane is one dependent chain of L steps, and there are
// only a few hundred lanes (476 of the 970 of a 3-minute stereo file of
// filtered noise; music-like tones code every lane with a fixed
// predictor), against 132 SMs of 4 x 32 lanes. The kernel is
// latency-bound by design; what it does about it:
//   * the taps and the history live in registers: the tap bound H is a
//     template parameter (4, 8, 12, 16 or 32), so the loops unroll fully
//     and no local array is indexed at run time. Each warp picks H from
//     the largest order of its own 32 lanes (a warp-uniform branch), so a
//     warp of FIR lanes runs H = 4 beside a warp of order-32 lanes;
//   * the products are summed oldest first, so the newest sample enters
//     last: one step's dependent chain is one 32x32->64 multiply-add, the
//     64-bit shift, the 64-bit add of r[n], the int32 range test and a
//     select;
//   * one warp per block (one block per SM while lanes <= 132 x 32), and
//     residuals come in through shared memory in tiles of 32 samples per
//     lane: the warp loads the tile row by row (one coalesced 128-byte
//     row per load), each thread then reads its own row from shared
//     memory (padded rows: no bank conflicts), and the next tile's loads
//     are issued before the current tile's steps, so they are in flight
//     while the chain runs. Restored samples leave the same way.
// With one warp per SM nothing hides a step's instructions, so their
// count per sample sets the time, at about 4 cycles each: a tap is one
// signed 32 x 32 -> 64 multiply-add (mad_wide), positions are int and row
// addresses step by n (61 instructions a sample at order 12; a first
// design that left the taps as 64 x 64 multiplies took 95). Times against
// the bound and the serial floor: PERF.md, lac_tpu_torch/ab_kernels.py.
//
// Arithmetic: int64 accumulation, `>>` on a signed long long (arithmetic,
// as jnp's >> on int64). The history only ever holds int32 values (a lane
// stops at the first sample outside int32: its ok flag clears, and that
// sample and every later one is written back as its residual, as the
// numpy reference's row loop leaves them), so with |c| < 2^26 no sum can
// overflow, and every sample written fits the int32 output (the JAX
// scan's int64 output holds the same values in twice the bytes). A lane
// whose order is outside 0..32 or whose shift is outside 0..63 is
// rejected whole (ok false, residuals out).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // lanes of one warp = one block
constexpr int kTile = 32;   // samples of a lane staged per tile
constexpr int kMaxOrder = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Lane {
  const int32_t* res;  // the warp's first row of residuals, (rows, n)
  int32_t* out;        // the warp's first row of restored samples
  int rows;            // rows of this warp that exist (<= kLanes)
  int n;               // samples per row
};

// d = a * b + c, 32 x 32 -> 64 bits signed: one IMAD.WIDE. Written out
// because `c + (long long)a * b` compiled to a 64 x 64 multiply (four
// instructions and a sign extension per tap).
__device__ __forceinline__ long long mad_wide(int32_t a, int32_t b, long long c) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// Thread t takes column n0 + t of every row of the warp's tile: each load
// is one coalesced 128-byte row; the row pointer steps by n.
__device__ __forceinline__ void load_tile(const Lane& L, int n0, int t, int32_t (&pre)[kTile]) {
  const bool col_ok = n0 + t < L.n;
  const int32_t* p = L.res + n0 + t;
#pragma unroll
  for (int r = 0; r < kLanes; ++r, p += L.n) pre[r] = (col_ok && r < L.rows) ? *p : 0;
}

template <int H>
__device__ __forceinline__ bool restore_lane(const Lane& L, const int32_t* taps, int order, int shift, int min_pred,
                                             int valid, bool alive, int32_t (*s_in)[kTile + 1],
                                             int32_t (*s_out)[kTile + 1]) {
  const int t = threadIdx.x;
  int32_t c[H], h[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    c[i] = (alive && i < order) ? taps[1 + i] : 0;
    h[i] = 0;
  }
  int32_t pre[kTile];
  load_tile(L, 0, t, pre);
  for (int n0 = 0; n0 < L.n; n0 += kTile) {
#pragma unroll
    for (int r = 0; r < kLanes; ++r) s_in[r][t] = pre[r];
    __syncwarp();
    if (n0 + kTile < L.n) load_tile(L, n0 + kTile, t, pre);  // in flight during the steps below
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int32_t rn = s_in[t][k];
      long long acc = 0;
#pragma unroll
      for (int i = H - 1; i >= 0; --i) acc = mad_wide(c[i], h[i], acc);  // newest sample last
      const int pos = n0 + k;
      const long long s = (long long)rn + (pos >= min_pred ? (acc >> shift) : 0LL);
      const int32_t lo = (int32_t)s;
      const bool in_range = (int32_t)(s >> 32) == (lo >> 31);  // the high word is the low word's sign
      const bool active = alive && pos < valid;
      alive = alive && (in_range || !active);
      const int32_t v = (active && in_range) ? lo : rn;
      s_out[t][k] = v;
#pragma unroll
      for (int i = H - 1; i > 0; --i) h[i] = h[i - 1];
      h[0] = v;
    }
    __syncwarp();
    const bool col_ok = n0 + t < L.n;
    int32_t* q = L.out + n0 + t;
#pragma unroll
    for (int r = 0; r < kLanes; ++r, q += L.n) {
      if (col_ok && r < L.rows) *q = s_out[r][t];
    }
    __syncwarp();
  }
  return alive;
}

__global__ void __launch_bounds__(kLanes) restore_kernel(const int32_t* __restrict__ res,
                                                         const int32_t* __restrict__ coeffs,
                                                         const int32_t* __restrict__ order,
                                                         const int32_t* __restrict__ shift,
                                                         const int32_t* __restrict__ min_pred,
                                                         const int32_t* __restrict__ valid_len, long long lanes,
                                                         int n, int32_t* __restrict__ out, uint8_t* __restrict__ ok) {
  __shared__ int32_t s_in[kLanes][kTile + 1];
  __shared__ int32_t s_out[kLanes][kTile + 1];
  const int t = threadIdx.x;
  const long long lane0 = (long long)blockIdx.x * kLanes;
  const Lane L{res + lane0 * n, out + lane0 * n, (int)min(lanes - lane0, (long long)kLanes), n};
  const long long g = lane0 + t;
  const bool real = t < L.rows;
  const int od = real ? order[g] : 0;
  const int sh = real ? shift[g] : 0;
  const bool alive = real && od >= 0 && od <= kMaxOrder && sh >= 0 && sh < 64;
  const int mp = real ? min_pred[g] : 0;
  const int valid = real ? min(valid_len[g], n) : 0;
  const int32_t* taps = coeffs + g * (kMaxOrder + 1);
  int wmax = alive ? od : 0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wmax = max(wmax, __shfl_xor_sync(kFull, wmax, o));
  bool good;
  if (wmax <= 4) {
    good = restore_lane<4>(L, taps, od, sh, mp, valid, alive, s_in, s_out);
  } else if (wmax <= 8) {
    good = restore_lane<8>(L, taps, od, sh, mp, valid, alive, s_in, s_out);
  } else if (wmax <= 12) {
    good = restore_lane<12>(L, taps, od, sh, mp, valid, alive, s_in, s_out);
  } else if (wmax <= 16) {
    good = restore_lane<16>(L, taps, od, sh, mp, valid, alive, s_in, s_out);
  } else {
    good = restore_lane<32>(L, taps, od, sh, mp, valid, alive, s_in, s_out);
  }
  if (real) ok[g] = good ? 1 : 0;
}

}  // namespace

// res (lanes, n) int32; coeffs (lanes, 33) int32, index 0 unused; order,
// shift, min_pred_n, valid_len (lanes,) int32; out (lanes, n) int32; ok
// (lanes,) bool. All contiguous on `device`.
extern "C" int lac_recurrence_restore(const void* res, const void* coeffs, const void* order, const void* shift,
                                      const void* min_pred, const void* valid_len, long long lanes, long long n,
                                      void* out, void* ok, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // positions are int: n0 + 2 * kTile must not overflow
  if (lanes < 0 || n < 0 || n > INT_MAX - 2 * kTile || lanes > 0x7FFFFFFFLL * kLanes) {
    return (int)cudaErrorInvalidValue;
  }
  if (lanes == 0) return 0;
  const unsigned blocks = (unsigned)((lanes + kLanes - 1) / kLanes);
  restore_kernel<<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(coeffs), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(shift), static_cast<const int32_t*>(min_pred),
      static_cast<const int32_t*>(valid_len), lanes, (int)n, static_cast<int32_t*>(out), static_cast<uint8_t*>(ok));
  return (int)cudaGetLastError();
}
