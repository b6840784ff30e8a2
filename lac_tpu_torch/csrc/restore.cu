// Closed-loop FIR / LPC restore of the device decode backend: one thread
// per (block, channel) lane, one warp per block.
//
// Replaces the vmapped lax.scan of lac_tpu/ops/predictors.py:243
// (recurrence_restore), which is XLA code, not a Pallas kernel. Per lane:
//   x[n] = r[n] + (sum_{i <= min(n, order)} c[i] * x[n - i] >> shift)
// from n >= min_pred_n (before it x[n] = r[n]), for n < valid_len; the
// lane's ok flag clears where a restored sample leaves int32. FIR lanes
// are order 2 with taps {3, -1}, shift 2 and min_pred_n 2; LPC lanes
// order 1..32 with Q15 taps, shift 15 and min_pred_n 0.
//
// Bound on this card: the slowest warp's thread, in cycles a sample. Each
// sample needs the one before it, and the >> truncation breaks
// superposition, so a lane is one dependent chain of L steps that cannot be
// reassociated into a scan. A decode has a few hundred such lanes (476 of
// the 970 of a 3-minute stereo file of filtered noise), so 15 warps run
// alone on 15 of the 132 SMs and the time is L times the cycles one thread
// spends on a sample: the latency of a step's dependent chain or, with
// many taps, the issue of its float64 instructions (about 2.7 cycles a tap),
// whichever is larger. Bytes (0.02 ms at (476, 16384)) do not matter. The
// design, part by part:
//   * the fast way computes in float64, exactly. The taps are scaled by
//     2^-shift (exact), the history is kept as doubles, and a step is
//       a = sum c'[i] * x[n - i]           (DMUL, then DFMA oldest tap first)
//       z = a + (2^52 * 1.5 + r[n])        (DADD rounding down: the floor)
//       x[n] = z - 2^52 * 1.5, and the int32 sample is z's low word.
//     Every product and partial sum is a multiple of 2^-shift below 2^53,
//     so nothing rounds but the floor, which is the `>>` of the int64 sum.
//     The dependent chain is three instructions (the newest tap's DFMA, the
//     DADD, the DADD back), and a tap costs one DFMA. A 32 x 32 -> 64
//     integer multiply-add costs more to issue, and ptxas splits it into
//     IMAD.WIDE, IADD3 and IADD3.X, two of them on the chain;
//   * fast runs with a deferred range check. A run of samples (whole
//     4-sample groups of a tile) goes the fast way, with no per-sample
//     mask, when every lane of the warp either
//     predicts over the whole run (alive, shift < 32, past min_pred_n and
//     before valid_len) or passes its residuals through over it (a lane
//     past valid_len or stopped: its taps are zeroed, x = r). Each sample
//     ORs x + 2^B into a flag. B is per lane, the largest with sum|c| * 2^B
//     <= (2^31 - 2^B) << shift and sum|c| * 2^B <= 2^52: while every sample
//     so far lies in [-2^B, 2^B), the float64 sums are exact and the
//     prediction is below 2^31 - 2^B, so a step that leaves int32 wraps to a
//     low word outside that range and is flagged (a conservative flag: a
//     sample in int32 but beyond 2^B is flagged too). Q15 taps of any order
//     up to 32 give B >= 24, FIR B = 30: audio samples never flag. A
//     flagged lane replays the run the careful way from the history saved
//     at its start (the tile's residuals are still in shared memory and its
//     samples are stored again). The careful way is
//     the exact per-sample logic (int64 sum, range test, masks); it also
//     takes the 4-sample groups where a lane starts predicting (min_pred_n)
//     or stops (valid_len), a row's last n % 4 samples, and lanes with
//     shift >= 32 or huge taps;
//   * vector-wide copies. Residuals come in tiles of T samples (128; 108
//     for the 12-tap template) through two shared-memory buffers, each row
//     padded to an odd number of 16-byte units (no bank conflicts). The warp
//     issues the next tile's 16-byte cp.async copies before it runs this one
//     (thread t takes the 16-byte column t of every row: one coalesced
//     512-byte row a copy); each thread reads its own row 16 bytes at a time
//     and stores its samples 16 bytes at a time straight to device memory
//     (a store per 4 samples, nothing to drain). Measured and dropped
//     (ab_kernels.py, cycles a sample at order 12, PERF.md): a TMA bulk copy
//     per row and thread (32 requests a tile each way; 130 with integer
//     taps), a drain of the tile through shared memory (79; 57 without it),
//     each thread loading its own row into registers a body ahead with no
//     shared memory (69 against 57), the next tile's copies spread over the
//     runs (67 against 56). A tensor whose rows break
//     16-byte alignment (L % 4 != 0 or an unaligned base) goes the careful
//     way throughout, in device memory;
//   * the history rotates through registers: the fast steps are unrolled
//     in bodies of a multiple of the tap bound H (32 samples; 36 for H =
//     12), so a new sample takes the register of the oldest and no move
//     is issued. H is a template parameter (2 for FIR-only warps, 4, 8, 12,
//     16 or 32), picked per warp from the largest order of its 32 lanes.
// Times against the bound, the measured chain floor (every lane at order
// 1) and the SASS counts: PERF.md, lac_tpu_torch/ab_kernels.py --restore.
//
// Arithmetic of the careful way: int64 accumulation, `>>` on a signed long
// long (arithmetic, as jnp's >> on int64). The history only ever holds
// int32 values (a lane stops at the first sample outside int32: its ok flag
// clears, and that sample and every later one is written back as its
// residual, as the numpy reference's row loop leaves them), so with
// |c| < 2^26 no sum can overflow, and every sample written fits the int32
// output. A lane whose order is outside 0..32 or whose shift is outside
// 0..63 is rejected whole (ok false, residuals out).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // lanes of one warp = one block
constexpr int kMaxOrder = 32;
constexpr int kMaxFastShift = 31;  // (2^31 - 2^B) << shift fits int64
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr long long kMagicBits = 0x4338000000000000LL;  // 1.5 * 2^52: below 2^51 away, the low word is the integer
constexpr double kMagic = 6755399441055744.0;

// samples per unrolled fast body (a multiple of H and of 4), per tile (a
// multiple of the body), and per shared row (the tile padded to an odd
// number of 16-byte units, so 8 threads' 16-byte accesses hit 32 banks once)
__host__ __device__ constexpr int body_len(int H) { return H == 12 ? 36 : 32; }
__host__ __device__ constexpr int tile_len(int H) { return H == 12 ? 108 : 128; }
__host__ __device__ constexpr int row_words(int T) { return (T / 4) % 2 ? T : T + 4; }
constexpr int kMaxRowWords = row_words(128);

// d = a * b + c, 32 x 32 -> 64 bits signed, for the careful way
__device__ __forceinline__ long long mad_wide(int32_t a, int32_t b, long long c) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// Samples go out by these stores only, so that they stay in program order
// (a replay overwrites a run's samples). The 16-byte one is written out
// because ptxas splits a C++ int4 store into four where the values do not
// sit in an aligned register quad: four times the requests.
__device__ __forceinline__ void st_global_v4(int32_t* p, int32_t a, int32_t b, int32_t c, int32_t d) {
  asm volatile("st.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(a), "r"(b), "r"(c), "r"(d));
}
__device__ __forceinline__ void st_global(int32_t* p, int32_t v) {
  asm volatile("st.global.s32 [%0], %1;" ::"l"(p), "r"(v));
}

// 1.5 * 2^52 + r, exactly
__device__ __forceinline__ double biased(int32_t r) { return __longlong_as_double(kMagicBits + r); }

struct LaneState {
  int sh, mp, valid;
  bool alive, pass;  // pass: the lane only passes residuals through from here on (taps zeroed)
  uint32_t bias;     // 2^B
  uint32_t mask;     // bits that flag a sample outside [-2^B, 2^B) (0: never flag)
  double scale;      // 2^sh: a tap c = c' * 2^sh
};

// The fast way over U samples: residuals from `in` (shared memory),
// samples to `out` (device memory; stored only where `store`), no masks,
// the range check deferred to the flag `f`. hd[0] / h[0] is the newest
// sample (as a double and as int32); w[] and wi[] rename the history so
// that the unrolled steps move nothing.
template <int H, int U>
__device__ __forceinline__ void fast_body(const int32_t* in, int32_t* out, bool store, const double (&cd)[H],
                                          double (&hd)[H], int32_t (&h)[H], uint32_t bias, uint32_t& f) {
  double w[H + U];    // w[H + k] is the body's sample k, w[H - 1 - i] = hd[i]
  int32_t wi[H + U];  // the same samples as int32
#pragma unroll
  for (int i = 0; i < H; ++i) {
    w[H - 1 - i] = hd[i];
    wi[H - 1 - i] = h[i];
  }
#pragma unroll
  for (int q = 0; q < U; q += 4) {
    const int4 r = *reinterpret_cast<const int4*>(in + q);
    const int32_t rq[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = H + q + j;
      double a = cd[H - 1] * w[m - H];
#pragma unroll
      for (int i = H - 1; i >= 2; --i) a = fma(cd[i - 1], w[m - i], a);  // off the chain, oldest first
      a = fma(cd[0], w[m - 1], a);                                        // the chain: DFMA, DADD, DADD
      const double z = __dadd_rd(a, biased(rq[j]));                       // 1.5 * 2^52 + r + floor(a)
      w[m] = z - kMagic;
      wi[m] = __double2loint(z);
      f |= (uint32_t)wi[m] + bias;
    }
    if (store) st_global_v4(out + q, wi[H + q], wi[H + q + 1], wi[H + q + 2], wi[H + q + 3]);
  }
#pragma unroll
  for (int i = 0; i < H; ++i) {
    hd[i] = w[H + U - 1 - i];
    h[i] = wi[H + U - 1 - i];
  }
}

// The careful way over samples [k0, k1) of a tile (or a row) that starts
// at n0: the exact per-sample logic, residuals from `src`, samples to `dst`.
template <int H>
__device__ __forceinline__ void careful(const int32_t* src, int32_t* dst, int k0, int k1, int n0,
                                        const double (&cd)[H], double (&hd)[H], int32_t (&h)[H], LaneState& s) {
#pragma unroll 1
  for (int k = k0; k < k1; ++k) {
    const int32_t rn = src[k];
    long long acc = 0;
#pragma unroll
    for (int i = H - 1; i >= 0; --i) acc = mad_wide(__double2int_rn(cd[i] * s.scale), h[i], acc);
    const int pos = n0 + k;
    const long long v64 = (long long)rn + (pos >= s.mp ? (acc >> s.sh) : 0LL);
    const int32_t lo = (int32_t)v64;
    const bool in_range = (int32_t)(v64 >> 32) == (lo >> 31);  // the high word is the low word's sign
    const bool active = s.alive && pos < s.valid;
    s.alive = s.alive && (in_range || !active);
    const int32_t v = (active && in_range) ? lo : rn;
    st_global(dst + k, v);
#pragma unroll
    for (int i = H - 1; i > 0; --i) {
      h[i] = h[i - 1];
      hd[i] = hd[i - 1];
    }
    h[0] = v;
    hd[0] = (double)v;
  }
}

// One tile of `cnt` samples at n0, residuals from `in` (the lane's row of
// the tile in shared memory), samples to `out` (device memory; only a real
// lane stores), in runs: a fast run as long as every lane allows one (whole
// 4-sample groups), else one careful group of 4.
template <int H>
__device__ __forceinline__ void restore_tile(const int32_t* in, int32_t* out, bool real, int n0, int cnt,
                                             double (&cd)[H], double (&hd)[H], int32_t (&h)[H], LaneState& s,
                                             bool capable) {
  constexpr int U = body_len(H);
  int k = 0;
  while (k < cnt) {
    if (!s.pass && (!s.alive || n0 + k >= s.valid)) {  // passes residuals through from here on: x = r
      s.pass = true;
      s.mask = 0;
#pragma unroll
      for (int i = 0; i < H; ++i) cd[i] = 0.0;
    }
    int end;  // the end of the run this lane allows from k
    if (s.pass) {
      end = cnt;
    } else if (capable && n0 + k >= s.mp) {
      end = min(s.valid - n0, cnt);
    } else {
      end = k;
    }
    const int e = k + (((int)__reduce_min_sync(kFull, (unsigned)end) - k) & ~3);
    if (e > k) {
      int32_t hs[H];
      uint32_t f = 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        hs[i] = h[i];
        f |= (uint32_t)h[i] + s.bias;  // the bound needs the history in range too
      }
      int q = k;
#pragma unroll 1
      for (; q + U <= e; q += U) fast_body<H, U>(in + q, out + q, real, cd, hd, h, s.bias, f);
#pragma unroll 1
      for (; q < e; q += 4) fast_body<H, 4>(in + q, out + q, real, cd, hd, h, s.bias, f);
      if (f & s.mask) {  // replay this lane's run the careful way
#pragma unroll
        for (int i = 0; i < H; ++i) {
          h[i] = hs[i];
          hd[i] = (double)hs[i];
        }
        careful<H>(in, out, k, e, n0, cd, hd, h, s);  // a flagged lane is real
      }
      k = e;
    } else {
      const int e1 = min(k + 4, cnt);
      if (real) {
        careful<H>(in, out, k, e1, n0, cd, hd, h, s);
      }
      k = e1;
    }
  }
}

// The warp's copies of tile [n0, n0 + cnt) of its `rows` rows into `buf`
// (row stride RW), committed as one cp.async group: thread t takes the
// 16-byte column t of every row, so each copy is one coalesced row.
template <int RW>
__device__ __forceinline__ void fill(int32_t* buf, const int32_t* res, int rows, int n, int n0, int cnt) {
  const int t = threadIdx.x;
  if (4 * t < cnt) {
    const int32_t* src = res + n0 + 4 * t;
    const uint32_t dst = smem_u32(buf + 4 * t);
#pragma unroll 8
    for (int r = 0; r < rows; ++r, src += n) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst + r * RW * 4), "l"(src) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

struct Args {
  const int32_t* res;   // the warp's first row of residuals, (rows, n)
  const int32_t* taps;  // this lane's 33 coefficients
  int32_t* out;         // the warp's first row of restored samples
  int rows, order, n;
  bool vec;  // rows 16-byte aligned: tiles move by 16-byte copies
};

template <int H>
__device__ bool restore_lane(const Args a, LaneState s, int32_t* smem) {
  constexpr int T = tile_len(H), RW = row_words(T);
  const int t = threadIdx.x;
  double cd[H], hd[H];
  int32_t h[H];
  long long tap_sum = 0;
  s.scale = (double)(1ULL << s.sh);  // exact for 0 <= sh <= 63
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int32_t c = (s.alive && i < a.order) ? a.taps[1 + i] : 0;
    cd[i] = (double)c / s.scale;  // exact: a power of two
    hd[i] = 0.0;
    h[i] = 0;
    tap_sum += c < 0 ? -(long long)c : (long long)c;
  }
  int B = -1;  // the largest B <= 30 with tap_sum * 2^B <= (2^31 - 2^B) << sh and tap_sum * 2^B <= 2^52
  if (s.alive && s.sh <= kMaxFastShift) {
    for (int b = 30; b >= 0; --b) {
      if (tap_sum <= ((((1LL << 31) - (1LL << b)) << s.sh) >> b) && tap_sum <= (1LL << (52 - b))) {
        B = b;
        break;
      }
    }
  }
  const bool capable = B >= 0;
  s.bias = capable ? 1u << B : 0u;
  s.mask = capable ? ~((2u << B) - 1u) : 0u;
  s.pass = !s.alive;

  const int n = a.n;
  const bool real = t < a.rows;
  int32_t* out_row = a.out + (long long)t * n;
  if (!a.vec) {  // rows not 16-byte aligned: the careful way throughout, in device memory
    if (real) careful<H>(a.res + (long long)t * n, out_row, 0, n, 0, cd, hd, h, s);
    return s.alive;
  }
  const int tiles = (n + T - 1) / T;
  fill<RW>(smem, a.res, a.rows, n, 0, min(T, n));
  for (int i = 0; i < tiles; ++i) {
    const int n0 = i * T, cnt = min(T, n - n0);
    if (i + 1 < tiles) {  // the next tile, into the buffer every thread has finished reading
      fill<RW>(smem + ((i + 1) & 1) * kLanes * RW, a.res, a.rows, n, n0 + T, min(T, n - n0 - T));
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncwarp();  // every thread's copies of this tile have landed
    restore_tile<H>(smem + ((i & 1) * kLanes + t) * RW, out_row + n0, real, n0, cnt, cd, hd, h, s, capable);
    __syncwarp();  // every thread has read this tile before its buffer is filled again
  }
  return s.alive;
}

__global__ void __launch_bounds__(kLanes) restore_kernel(const int32_t* __restrict__ res,
                                                         const int32_t* __restrict__ coeffs,
                                                         const int32_t* __restrict__ order,
                                                         const int32_t* __restrict__ shift,
                                                         const int32_t* __restrict__ min_pred,
                                                         const int32_t* __restrict__ valid_len, long long lanes,
                                                         int n, bool vec, int32_t* __restrict__ out,
                                                         uint8_t* __restrict__ ok) {
  __shared__ __align__(16) int32_t smem[2 * kLanes * kMaxRowWords];
  const int t = threadIdx.x;
  const long long lane0 = (long long)blockIdx.x * kLanes;
  const long long g = lane0 + t;
  const bool real = g < lanes;
  const int od = real ? order[g] : 0;
  LaneState s{};
  s.sh = real ? shift[g] : 0;
  s.alive = real && od >= 0 && od <= kMaxOrder && s.sh >= 0 && s.sh < 64;
  if (!s.alive) s.sh = 0;
  s.mp = real ? min_pred[g] : 0;
  s.valid = real ? min(valid_len[g], n) : 0;
  const Args a{res + lane0 * n, coeffs + g * (kMaxOrder + 1), out + lane0 * n,
               (int)min(lanes - lane0, (long long)kLanes), od, n, vec};
  int wmax = s.alive ? od : 0;
  wmax = (int)__reduce_max_sync(kFull, (unsigned)wmax);
  bool good;
#ifdef LAC_RESTORE_ONE_TEMPLATE  // a build for ab_kernels.py's SASS census only: one template's code
  good = restore_lane<LAC_RESTORE_ONE_TEMPLATE>(a, s, smem);
#else
  if (wmax <= 2) {
    good = restore_lane<2>(a, s, smem);
  } else if (wmax <= 4) {
    good = restore_lane<4>(a, s, smem);
  } else if (wmax <= 8) {
    good = restore_lane<8>(a, s, smem);
  } else if (wmax <= 12) {
    good = restore_lane<12>(a, s, smem);
  } else if (wmax <= 16) {
    good = restore_lane<16>(a, s, smem);
  } else {
    good = restore_lane<32>(a, s, smem);
  }
#endif
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
  // positions are int: n0 + 2 * tile must not overflow
  if (lanes < 0 || n < 0 || n > INT_MAX - 2 * tile_len(32) || lanes > 0x7FFFFFFFLL * kLanes) {
    return (int)cudaErrorInvalidValue;
  }
  if (lanes == 0) return 0;
  const bool vec = n % 4 == 0 && ((reinterpret_cast<uintptr_t>(res) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const unsigned blocks = (unsigned)((lanes + kLanes - 1) / kLanes);
  restore_kernel<<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(res), static_cast<const int32_t*>(coeffs), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(shift), static_cast<const int32_t*>(min_pred),
      static_cast<const int32_t*>(valid_len), lanes, (int)n, vec, static_cast<int32_t*>(out),
      static_cast<uint8_t*>(ok));
  return (int)cudaGetLastError();
}
