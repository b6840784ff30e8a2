// Static-Rice scan tokenizer of the device bit-reader experiment (kernel 8):
// one block per lane, the lane's bits parsed by every thread of the block at
// once by a self-synchronising segmented parse.
//
// Replaces the lax.scan of lac_tpu/ops/device_reader.py:122
// (tokenize_static_rice_scan, the scan at :183), which is XLA code, not a
// Pallas kernel: one scan step per token with every lane advancing together.
// Each step of a lane, as the JAX step function (:164-180) computes it in u64:
//   byteidx = min(pos >> 3, max(NBY - 8, 0))
//   w       = the 8 bytes at byteidx, big-endian (every byte index clamped to
//             NBY - 1: JAX clamps an out-of-bounds gather index)
//   w     <<= min(pos - 8 * byteidx, 63)
//   q       = clz64(~w)                     (64 when ~w == 0)
//   rem     = k ? (w << (q + 1)) >> (64 - k) : 0
//   u       = (u32)((q << k) | rem), res = zigzag^-1(u)
//   start   = (int32)pos, valid = start < nbits, pos += q + 1 + k
// with XLA's rule that a u64 shift by 64 or more gives 0 (C++ leaves it
// undefined, so every shift here is guarded). A token past the 57-bit cap
// (q + 1 + k > 57) or past the stream gives the reference's garbage, exactly.
//
// Bound on this card: the bytes (payload in, (L, T) int32 and bool out;
// 0.0084 ms at (256, 16384) at 3.35 TB/s). The step is a pure function of the
// bit position, so a lane is no longer one thread's dependent chain of T
// steps. The design:
//   1. One block of kThreads per lane. The row is staged in shared memory by
//      16-byte cp.async copies of whole aligned blocks (a region of kRegion
//      bytes and a 16-byte halo at a time; a longer row is walked region by
//      region, the entry position carried), then byte-swapped into big-endian
//      words. A parse reads its window by funnel shifts of words kept in
//      registers, the next word loaded a step ahead (the Reader below): a
//      step's chain is a funnel shift, clz, a select, adds and the word
//      selects, with no load on it (a token of over 32 bits reseeks).
//   2. Segments: the head of a region (its bits before the tail) is one
//      chunk, cut into one segment a thread, as wide as that takes (at least
//      kMinSegBits; -DLAC_RICE_SCAN_W=N fixes N bits, chunks of kThreads * N
//      bits, for A/B runs). Speculative pass: each thread parses from
//      kWarmBits before its segment on, not counting (a parse from a wrong
//      bit meets the true one after a few tokens, more as k grows), then
//      from its first start in the segment (thread 0 from the carried entry)
//      until it passes the segment's end, keeping its exit, its count and its
//      first kRec starts. Fixpoint rounds: each thread takes its
//      predecessor's exit as its entry and, if that changed, parses again;
//      it stops as soon as it lands on a kept start (from there the
//      speculative parse was the true one). Rounds repeat until no exit
//      changes (__syncthreads_or). Only the threads whose segment starts
//      below the head's end take part (empty segments would pass an exit on
//      one thread a round).
//      Exact: thread 0's entry is true; once exits stop changing, each entry
//      is its predecessor's true exit, by induction. After round r the first
//      r + 1 segments are right, so it ends; on real data in one or two rounds.
//   3. A block-wide exclusive scan of the counts gives each segment's first
//      token; a last pass parses each segment from its true entry and writes
//      the tokens with index < T into a window of kWindow tokens in shared
//      memory (one pass unless the chunk holds more), at the output row's
//      16-byte phase, which leaves in 16-byte stores. Positions
//      on the fast path are below 2^31, so the head's valid flags are a
//      prefix: the pass finds the first token whose start is not below
//      nbits, and the flags are stored from that cut. The block stops
//      parsing once token T is placed.
//   4. The tail in closed form: from the row's last non-zero byte Z on (read
//      backwards from the row's end while region 0 is in flight), the window
//      is 0 and every token is res 0, 1 + k bits; with no zero byte at the end,
//      from bit 8 * NBY - 1 on the window is the row's last bit b at the top
//      (byte index clamped to NBY - 8, shift to 63), so one constant token of
//      1 + b + k bits, res zigzag^-1(b << k). Tokens there are written as
//      (start = entry + i * stride, res constant).
//   5. Careful lanes take the serial per-lane loop of the previous design, in
//      the same launch (thread 0 of the lane's block): k < 0 (the u64 step can
//      be 0 or wrap), k > kMaxFastK, NBY < 8 (the window clamps from byte 0),
//      rows of 2^28 bytes or more and 2^30 tokens or more (positions and
//      token indices are 32-bit on the fast path).
// The traps, each exercised by bench_device_reader.sync_hostile_batches():
//   - Zero runs never synchronise when k >= 1: in zero bytes every token is
//     1 + k zero bits, and parses k + 1 bits apart stay out of phase, so the
//     rounds walk one segment a round through an interior zero run (exact, if
//     slow); trailing zeros (rows shorter than the batch's longest) are the
//     closed-form tail. -DLAC_RICE_SCAN_DEBUG builds report the rounds.
//   - The JAX window is exactly 8 bytes at byteidx: a token longer than
//     64 - (pos & 7) bits reads zeros (the 57-bit cap garbage). The window is
//     masked to it: ~0 << (pos & 7); past the row the staged bytes are 0,
//     which is the clamp to NBY - 8 for every position below 8 * NBY - 1.
//   - q can be 64 (all ones), so a token can pass a whole segment: a thread
//     whose segment no token starts in has count 0 and passes its entry on.
//   - valid compares the int32 wrap of the u64 start with nbits: kept (u32
//     positions, the tail's start by u32 multiply-add).

#include <cstdint>

#include <cuda_runtime.h>

#ifndef LAC_RICE_SCAN_W
#define LAC_RICE_SCAN_W 0  // bits a segment (a thread's share of a chunk); 0: the lane's own, below
#endif
#ifndef LAC_RICE_SCAN_WARM
#define LAC_RICE_SCAN_WARM 128  // bits a speculative parse runs before its segment
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kMinSegBits = 64;
constexpr uint32_t kWarmBits = LAC_RICE_SCAN_WARM;
constexpr long long kRegion = 32768;  // row bytes staged at once
constexpr long long kHalo = 16;       // bytes staged past a region: a window read at its last bit
constexpr int kBufWords = (int)(kRegion + 64) / 4;
constexpr int kWindow = 16384;  // tokens staged before they are stored
constexpr int kRec = 4;        // token starts the speculative pass keeps: its first
constexpr int kMaxFastK = 63;
constexpr long long kMaxFastBytes = 1LL << 28;
constexpr long long kMaxFastTokens = 1LL << 30;
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

struct Smem {                     // 102,480 bytes: two blocks an SM
  uint32_t row[kBufWords];        // the staged bytes as big-endian words
  int32_t res[kWindow + 4];       // the staged tokens, at the output row's 16-byte phase
  uint32_t exit[2][kThreads];     // the segments' exits, this round's and the last
};

#ifdef LAC_RICE_SCAN_DEBUG
// per lane: chunks, fixpoint rounds in all, the most in one chunk (-1: a
// careful lane), then thread 0's clock64 cycles in each phase (kPhases)
constexpr int kPhases = 6;  // set-up, speculative pass, rounds, scan, write pass, tail
constexpr int kDebugWords = 3 + kPhases;
__device__ long long* g_rounds;
#define LAC_DEBUG_PHASE(i)                       \
  do {                                           \
    const long long now = clock64();             \
    phase[i] += now - mark;                      \
    mark = now;                                  \
  } while (0)
#else
#define LAC_DEBUG_PHASE(i) \
  do {                     \
  } while (0)
#endif

__device__ __forceinline__ uint64_t shl64(uint64_t x, uint64_t s) { return s < 64 ? x << s : 0; }
__device__ __forceinline__ uint64_t shr64(uint64_t x, uint64_t s) { return s < 64 ? x >> s : 0; }
__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int32_t unzigzag(uint32_t u) { return static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u))); }

// The previous design, one thread walking one lane: the careful lanes.
__device__ void serial_lane(const uint8_t* row, long long nby, int32_t k, int32_t nb, long long tokens,
                            int32_t* out, uint8_t* ok) {
  // int32 -> u64 as numpy's astype takes it: sign-extended, so a negative k is huge
  const uint64_t kk = static_cast<uint64_t>(static_cast<int64_t>(k));
  const uint64_t last = static_cast<uint64_t>(nby - 1);
  const uint64_t lim = nby > 8 ? static_cast<uint64_t>(nby - 8) : 0;
  uint64_t pos = 0;
  for (long long t = 0; t < tokens; ++t) {
    const uint64_t byteidx = umin64(pos >> 3, lim);
    uint64_t w = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) w = (w << 8) | __ldg(row + umin64(byteidx + b, last));
    w <<= umin64(pos - (byteidx << 3), 63);
    const uint64_t q = static_cast<uint64_t>(__clzll(static_cast<long long>(~w)));  // __clzll(0) == 64
    const uint64_t rem = kk ? shr64(shl64(w, q + 1), 64 - kk) : 0;
    const uint32_t u = static_cast<uint32_t>(shl64(q, kk) | rem);
    out[t] = unzigzag(u);
    ok[t] = static_cast<int32_t>(static_cast<uint32_t>(pos)) < nb;
    pos += q + 1 + kk;
  }
}

__device__ __forceinline__ uint32_t lds(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// The staged row: bit `pos` of the lane is bit 31 - lb % 32 of word lb / 32,
// lb = pos - bit0. A parse keeps three words from the one holding pos on in
// registers (a..c), pos's bit in a (s) and the word after c (nx), loaded a
// step before a select takes it, so no load waits on the chain of positions.
// A step is straight code: both q candidates and a select (the top 32 bits
// at pos decide unless they are all ones: they lie inside the JAX window,
// which holds at least 57 bits), then the words shifted by selects. A token
// of more than 32 bits reseeks.
struct Reader {
  unsigned base, at;  // shared addresses of word 0 and of word a
  uint32_t bit0, s, a, b, c, nx;

  __device__ __forceinline__ void seek(uint32_t pos) {
    const uint32_t lb = pos - bit0;
    at = base + ((lb >> 5) << 2);
    s = lb & 31;
    a = lds(at);
    b = lds(at + 4);
    c = lds(at + 8);
    nx = lds(at + 12);
  }
  // The step's q at pos, the reader at pos (fast lanes, pos < 8 * NBY - 1),
  // and the JAX window: bits [pos, 8 * (pos >> 3) + 64) of the row at the top
  // of hi:lo, zeros below (the staged bytes are 0 past the row). q is the
  // window's leading ones, 64 for an all-ones window.
  __device__ __forceinline__ uint32_t lead_ones(uint32_t pos, uint32_t& hi, uint32_t& lo) const {
    hi = __funnelshift_l(b, a, s);
    lo = __funnelshift_l(c, b, s) & (0xFFFFFFFFu << (pos & 7));
    const uint32_t q_hi = __clz(~hi), q_lo = 32 + __clz(~lo);
    return hi != 0xFFFFFFFFu ? q_hi : q_lo;
  }
  // The reader from pos onto to = pos + len.
  __device__ __forceinline__ void skip(uint32_t to, uint32_t len) {
    if (len > 32) {
      seek(to);
      return;
    }
    s += len;  // < 64
    const bool next = s >= 32;
    a = next ? b : a;
    b = next ? c : b;
    c = next ? nx : c;
    at += (s >> 5) << 2;
    s &= 31;
    nx = lds(at + 12);
  }
  __device__ __forceinline__ uint32_t next(uint32_t pos, uint32_t k) {
    uint32_t hi, lo;
    const uint32_t len = lead_ones(pos, hi, lo) + 1 + k;
    skip(pos + len, len);
    return pos + len;
  }
};

__device__ __forceinline__ int32_t token_value(uint32_t hi, uint32_t lo, uint32_t q, uint32_t k) {  // k <= 63
  const uint64_t w = (static_cast<uint64_t>(hi) << 32) | lo;
  const uint64_t rem = (k != 0 && q < 63) ? (w << (q + 1)) >> (64 - k) : 0;
  return unzigzag(static_cast<uint32_t>((static_cast<uint64_t>(q) << k) | rem));
}

// Speculative pass, the reader at or before pos: parse while pos < end; the
// exit, the count and its first kRec starts (0xFFFFFFFF: none). A later parse
// that lands on one of them goes on as this one did.
__device__ __forceinline__ uint32_t parse_spec(Reader& rd, uint32_t pos, uint32_t end, uint32_t k, int& count,
                                               uint32_t (&rec)[kRec]) {
  int n = 0;
#pragma unroll
  for (int j = 0; j < kRec; ++j) {
    rec[j] = 0xFFFFFFFFu;
    if (pos < end) {
      rec[j] = pos;
      pos = rd.next(pos, k);
      ++n;
    }
  }
  while (pos < end) {
    pos = rd.next(pos, k);
    ++n;
  }
  count = n;
  return pos;
}

// A fixpoint round's parse from a new entry: as parse_spec, but on landing on
// a start the speculative pass recorded, its exit and the rest of its count.
__device__ __forceinline__ uint32_t parse_sync(Reader& rd, uint32_t pos, uint32_t end, uint32_t k,
                                               const uint32_t (&rec)[kRec], int c0, uint32_t x0, int& count) {
  int n = 0;
  if (pos < end) rd.seek(pos);
  while (pos < end) {
#pragma unroll
    for (int j = 0; j < kRec; ++j) {
      if (pos == rec[j]) {
        count = n + c0 - j;
        return x0;
      }
    }
    pos = rd.next(pos, k);
    ++n;
  }
  count = n;
  return pos;
}

__device__ __forceinline__ int block_excl_scan(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, t, d);
      if (lane >= d) t += y;
    }
    if (lane < kWarps) s_warp[lane] = t;
  }
  __syncthreads();
  total = s_warp[kWarps - 1];
  return (warp ? s_warp[warp - 1] : 0) + x - v;
}

__device__ __forceinline__ uint64_t byte_mask(int from, int to) {  // bytes [from, to) of 8, little-endian
  from = max(from, 0);
  to = min(to, 8);
  if (to <= from) return 0;
  return (to == 8 ? ~0ull : (1ull << (8 * to)) - 1) & (~0ull << (8 * from));
}

// Index + 1 of the row's last non-zero byte (0: an all-zero row), read from
// the row's end backwards, kThreads aligned 16-byte blocks a step (each block
// holds a byte of the row, so no read leaves the row's pages).
__device__ int last_nonzero(const uint8_t* row, long long nby, int* s_last) {
  const uintptr_t ra = reinterpret_cast<uintptr_t>(row), re = ra + nby, first = ra & ~uintptr_t(15);
  const long long nblk = static_cast<long long>((re - 1 - first) >> 4) + 1;
  if (threadIdx.x == 0) *s_last = 0;
  __syncthreads();
  for (long long top = nblk - 1; top >= 0; top -= kThreads) {
    const long long blk = top - threadIdx.x;
    bool hit = false;
    if (blk >= 0) {
      const uintptr_t at = first + 16 * blk;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(at));
      const int from = ra > at ? static_cast<int>(ra - at) : 0, to = static_cast<int>(min(re - at, uintptr_t(16)));
      const uint64_t lo = (v.x | static_cast<uint64_t>(v.y) << 32) & byte_mask(from, to);
      const uint64_t hi = (v.z | static_cast<uint64_t>(v.w) << 32) & byte_mask(from - 8, to - 8);
      const int j = hi ? 8 + (63 - __clzll(static_cast<long long>(hi))) / 8
                       : lo ? (63 - __clzll(static_cast<long long>(lo))) / 8 : -1;
      if (j >= 0) {
        atomicMax(s_last, static_cast<int>(at + j + 1 - ra));
        hit = true;
      }
    }
    if (__syncthreads_or(hit)) break;
  }
  return *s_last;
}

// Row bytes [g0, min(NBY, g0 + kRegion + kHalo)) into buf as the aligned
// 16-byte blocks that hold them (bytes past the row zero-filled by cp.async's
// source size); returns the words written. Completed by stage_finish.
__device__ __forceinline__ int stage_issue(const uint8_t* row, long long nby, long long g0, uint32_t* buf) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(row + g0) & ~uintptr_t(15);
  const uintptr_t end = reinterpret_cast<uintptr_t>(row) + min(nby, g0 + kRegion + kHalo);
  const int nblk = static_cast<int>((end - a0 + 15) >> 4);
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(buf));
  for (int blk = threadIdx.x; blk < nblk; blk += kThreads) {
    const uintptr_t src = a0 + 16 * blk;
    const int bytes = static_cast<int>(min(end - src, uintptr_t(16)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst + 16 * blk), "l"(src), "r"(bytes)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  return 4 * nblk;
}

__device__ __forceinline__ void stage_finish(uint32_t* buf, int words) {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  for (int j = threadIdx.x; j < kBufWords; j += kThreads) buf[j] = j < words ? __byte_perm(buf[j], 0, 0x0123) : 0;
  __syncthreads();
}

__device__ __forceinline__ uint32_t ones_bytes(int n) {  // the first n of 4 bytes 1, the others 0
  n = min(max(n, 0), 4);
  return n == 4 ? 0x01010101u : 0x01010101u & ((1u << (8 * n)) - 1);
}

// A window of n staged tokens to the lane's output from token w0 on (gres,
// gok at w0), o4 being gres's offset in its 16-byte block, the staging's too;
// valid is (index < vcut), vcut relative to w0: the head's starts grow, so its
// valid flags are a prefix. Whole 16-byte blocks go as one store, the two
// edge blocks element by element.
__device__ __forceinline__ void flush(const Smem& s, int n, int o4, int vcut, int32_t* gres, uint8_t* gok) {
  int32_t* ga = gres - o4;
  for (int m = threadIdx.x; m < (o4 + n + 3) >> 2; m += kThreads) {
    const int lo = 4 * m;
    if (lo >= o4 && lo + 4 <= o4 + n) {
      *reinterpret_cast<int4*>(ga + lo) = *reinterpret_cast<const int4*>(s.res + lo);
    } else {
      for (int j = max(lo, o4); j < min(lo + 4, o4 + n); ++j) ga[j] = s.res[j];
    }
  }
  const int o1 = static_cast<int>(reinterpret_cast<uintptr_t>(gok) & 15);
  uint8_t* gb = gok - o1;
  vcut += o1;  // relative to gb
  for (int m = threadIdx.x; m < (o1 + n + 15) >> 4; m += kThreads) {
    const int lo = 16 * m;
    if (lo >= o1 && lo + 16 <= o1 + n) {
      *reinterpret_cast<uint4*>(gb + lo) = make_uint4(ones_bytes(vcut - lo), ones_bytes(vcut - lo - 4),
                                                      ones_bytes(vcut - lo - 8), ones_bytes(vcut - lo - 12));
    } else {
      for (int j = max(lo, o1); j < min(lo + 16, o1 + n); ++j) gb[j] = j < vcut;
    }
  }
}

// The tail's tokens [t0, T) in closed form, stored straight (res constant;
// the u32 start may wrap past 2^31, so each valid flag is its own compare).
__device__ __forceinline__ void store_tail(int t0, int T, int32_t res, uint32_t start0, uint32_t stride, int32_t nb,
                                           int32_t* gres, uint8_t* gok) {
  const auto ok = [&](int idx) { return static_cast<int32_t>(start0 + static_cast<uint32_t>(idx - t0) * stride) < nb; };
  const int o4 = static_cast<int>((reinterpret_cast<uintptr_t>(gres + t0) & 15) >> 2), n = T - t0;
  int32_t* ga = gres + t0 - o4;
  for (int m = threadIdx.x; m < (o4 + n + 3) >> 2; m += kThreads) {
    const int lo = 4 * m;
    if (lo >= o4 && lo + 4 <= o4 + n) {
      *reinterpret_cast<int4*>(ga + lo) = make_int4(res, res, res, res);
    } else {
      for (int j = max(lo, o4); j < min(lo + 4, o4 + n); ++j) ga[j] = res;
    }
  }
  const int o1 = static_cast<int>(reinterpret_cast<uintptr_t>(gok + t0) & 15);
  uint8_t* gb = gok + t0 - o1;
  for (int m = threadIdx.x; m < (o1 + n + 15) >> 4; m += kThreads) {
    const int lo = 16 * m;
    if (lo >= o1 && lo + 16 <= o1 + n) {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) w[q] |= static_cast<uint32_t>(ok(t0 + lo + 4 * q + b - o1)) << (8 * b);
      }
      *reinterpret_cast<uint4*>(gb + lo) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      for (int j = max(lo, o1); j < min(lo + 16, o1 + n); ++j) gb[j] = ok(t0 + j - o1);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) rice_scan_kernel(const uint8_t* __restrict__ payload, long long nby,
                                                                const int32_t* __restrict__ k,
                                                                const int32_t* __restrict__ nbits, long long tokens,
                                                                int32_t* __restrict__ res,
                                                                uint8_t* __restrict__ valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ int s_warp[kWarps];
  __shared__ int s_last, s_vcut;  // s_vcut: the first head token whose start is not below nbits
  const int tid = threadIdx.x;
  const long long lane = blockIdx.x;
  const uint8_t* row = payload + lane * nby;
  const int32_t kv = k[lane], nb = nbits[lane];
  int32_t* gres = res + lane * tokens;
  uint8_t* gok = valid + lane * tokens;
  if (kv < 0 || kv > kMaxFastK || nby < 8 || nby >= kMaxFastBytes || tokens >= kMaxFastTokens) {
    if (tid == 0) {
      serial_lane(row, nby, kv, nb, tokens, gres, gok);
#ifdef LAC_RICE_SCAN_DEBUG
      if (g_rounds) {
        for (int j = 0; j < kDebugWords; ++j) g_rounds[kDebugWords * lane + j] = -1;
      }
#endif
    }
    return;
  }
  const uint32_t kk = static_cast<uint32_t>(kv);
  const int T = static_cast<int>(tokens);
#ifdef LAC_RICE_SCAN_DEBUG
  long long phase[kPhases] = {}, mark = clock64();
#endif

  int words = stage_issue(row, nby, 0, s.row);
  if (tid == 0) s_vcut = T;
  const int zb = last_nonzero(row, nby, &s_last);
  // the tail: from bit ts on, one token of `stride` bits, value tail_res
  uint32_t ts, stride = 1 + kk;
  int32_t tail_res = 0;
  if (zb < nby) {
    ts = 8u * zb;
  } else {
    ts = 8u * static_cast<uint32_t>(nby) - 1;
    if (__ldg(row + nby - 1) & 1) {
      stride = 2 + kk;
      tail_res = unzigzag(static_cast<uint32_t>(1ull << kk));
    }
  }
  stage_finish(s.row, words);
  LAC_DEBUG_PHASE(0);
#ifdef LAC_RICE_SCAN_DEBUG
  int chunks = 0, rounds_all = 0, rounds_most = 0;
#endif

  uint32_t entry = 0;  // the first token start at or after the next chunk
  int base = 0;        // tokens before it
  for (long long g0 = 0; entry < ts && base < T; g0 += kRegion) {
    if (g0) {
      words = stage_issue(row, nby, g0, s.row);
      stage_finish(s.row, words);
      LAC_DEBUG_PHASE(0);
    }
    Reader rd;
    rd.base = static_cast<unsigned>(__cvta_generic_to_shared(s.row));
    rd.bit0 = static_cast<uint32_t>(8 * g0) - 8u * static_cast<uint32_t>(reinterpret_cast<uintptr_t>(row + g0) & 15);
    const uint32_t rend = static_cast<uint32_t>(min(static_cast<long long>(ts), 8 * (g0 + kRegion)));
    // the segment width: the region's head over the block, so one chunk (at
    // least kMinSegBits, whole words): wide segments on long lanes (fewer
    // rounds and chunks), short chains on short lanes
    const uint32_t head = rend - static_cast<uint32_t>(8 * g0);
    const uint32_t seg =
        LAC_RICE_SCAN_W ? LAC_RICE_SCAN_W : max(kMinSegBits, ((head + kThreads - 1) / kThreads + 31) & ~31u);
    for (uint32_t cs = static_cast<uint32_t>(8 * g0); cs < rend && base < T; cs += kThreads * seg) {
      // the threads whose segment starts below rend; the others hold nothing
      const int active = static_cast<int>(min((rend - cs + seg - 1) / seg, uint32_t(kThreads)));
      const uint32_t sb = min(cs + tid * seg, rend), se = min(sb + seg, rend);
      // the speculative entry: thread 0's is true; the others' is the first
      // start at or after sb of a parse begun kWarmBits earlier
      uint32_t my_entry = tid ? sb : entry, rec[kRec];
      if (tid && sb < se) {
        my_entry = sb - min(sb - static_cast<uint32_t>(8 * g0), kWarmBits);
        rd.seek(my_entry);
        while (my_entry < sb) my_entry = rd.next(my_entry, kk);
      } else if (my_entry < se) {
        rd.seek(my_entry);
      }
      int c0;
      const uint32_t x0 = parse_spec(rd, my_entry, se, kk, c0, rec);
      uint32_t x = x0;
      int c = c0, cur = 0, rounds = 0;
      s.exit[0][tid] = x;
      __syncthreads();
      LAC_DEBUG_PHASE(1);
      for (;;) {
        ++rounds;
        const uint32_t e = tid ? s.exit[cur][tid - 1] : entry;
        bool changed = false;
        if (tid < active && e != my_entry) {
          my_entry = e;
          const uint32_t nx = parse_sync(rd, e, se, kk, rec, c0, x0, c);
          changed = nx != x;
          x = nx;
        }
        cur ^= 1;
        s.exit[cur][tid] = x;
        if (!__syncthreads_or(changed)) break;
      }
      LAC_DEBUG_PHASE(2);
#ifdef LAC_RICE_SCAN_DEBUG
      ++chunks;
      rounds_all += rounds;
      rounds_most = max(rounds_most, rounds);
#endif
      const uint32_t next_entry = s.exit[cur][active - 1];
      int total;
      const int first = base + block_excl_scan(c, s_warp, total);
      LAC_DEBUG_PHASE(3);
      // the write pass: the chunk's tokens below T, a window of kWindow at a time
      for (int w0 = base; w0 < min(base + total, T); w0 += kWindow) {
        const int w1 = min(w0 + kWindow, T);
        const int o4 = static_cast<int>((reinterpret_cast<uintptr_t>(gres + w0) & 15) >> 2);
        if (c > 0 && first < w1 && first + c > w0) {
          uint32_t pos = my_entry;
          int cut = T;
          rd.seek(pos);
          for (int idx = first; idx < min(first + c, w1); ++idx) {
            uint32_t hi, lo;
            const uint32_t q = rd.lead_ones(pos, hi, lo), len = q + 1 + kk;
            if (idx >= w0) {
              s.res[o4 + idx - w0] = token_value(hi, lo, q, kk);
              if (static_cast<int32_t>(pos) >= nb) cut = min(cut, idx);
            }
            rd.skip(pos + len, len);
            pos += len;
          }
          if (cut < T) atomicMin(&s_vcut, cut);
        }
        __syncthreads();
        flush(s, min(w1, base + total) - w0, o4, s_vcut - w0, gres + w0, gok + w0);
        __syncthreads();
      }
      LAC_DEBUG_PHASE(4);
      entry = next_entry;
      base += total;
    }
  }
  // the tail in closed form: token base + i starts at entry + i * stride
  if (base < T) store_tail(base, T, tail_res, entry, stride, nb, gres, gok);
#ifdef LAC_RICE_SCAN_DEBUG
  LAC_DEBUG_PHASE(5);
  if (tid == 0 && g_rounds) {
    long long* out = g_rounds + kDebugWords * lane;
    out[0] = chunks;
    out[1] = rounds_all;
    out[2] = rounds_most;
    for (int j = 0; j < kPhases; ++j) out[3 + j] = phase[j];
  }
#endif
}

}  // namespace

// payload (lanes, nby) uint8, k and nbits (lanes,) int32 -> res (lanes, tokens)
// int32 and valid (lanes, tokens) bool, all contiguous. Returns a cudaError_t.
extern "C" int lac_rice_scan_tokenize(const void* payload, long long lanes, long long nby, const void* k,
                                      const void* nbits, long long tokens, void* res, void* valid, void* stream,
                                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 0 || tokens < 0 || nby < 1 || lanes > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (lanes == 0 || tokens == 0) return 0;
  err = cudaFuncSetAttribute(rice_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  rice_scan_kernel<<<(unsigned)lanes, kThreads, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), nby, static_cast<const int32_t*>(k), static_cast<const int32_t*>(nbits),
      tokens, static_cast<int32_t*>(res), static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}

#ifdef LAC_RICE_SCAN_DEBUG
// Debug builds: per lane (chunks, fixpoint rounds in all, the most in one
// chunk, then thread 0's cycles in set-up, speculative pass, rounds, scan,
// write pass and tail) into `out` ((lanes, 9) int64 on the card) at every
// later launch; null stops it.
extern "C" int lac_rice_scan_debug_rounds(void* out, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(g_rounds, &out, sizeof(out));
}
#endif
