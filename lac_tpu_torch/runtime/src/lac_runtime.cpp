// lac_tpu native runtime: parallel v3 block decode + token bit packing.
//
// Design notes (this is a fresh implementation, not a port):
//  * flat C ABI (ctypes-friendly), no classes, no exceptions across the
//    boundary; every function returns 0 on success / negative error code;
//  * the bit reader keeps a 64-bit refill window so multi-bit reads and
//    unary scans are branch-light (the reference reads byte-at-a-time);
//  * blocks of a v3 stream are byte-bounded and independent
//    (reference docs/format.md:18-35), so decode fans out across a
//    std::thread pool with an atomic work index; first error wins.
//
// Wire behaviour matches reference src/codec/block/decoder.cpp and
// src/codec/rice/rice.hpp (canonical validation rules cited inline).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <set>
#include <thread>
#include <vector>

#if defined(__AVX512F__) && defined(__AVX512DQ__)
#include <immintrin.h>
#define LAC_SIMD_LPC 1
// gcc 12's avx512 headers seed results with `__m512i __Y = __Y;`
// (_mm512_undefined_epi32), which trips -Wmaybe-uninitialized whenever a
// cvt/extract intrinsic inlines into a bigger frame — a known header
// false positive (gcc PR105593 family), not a bug in this file.
#pragma GCC diagnostic ignored "-Wmaybe-uninitialized"
#endif

namespace {

// ------------------------------------------------------------------ reader

struct Reader {
  const uint8_t* data;
  uint64_t size_bits;
  uint64_t pos;   // absolute bit position
  bool err;
};

inline void reader_init(Reader& r, const uint8_t* data, uint64_t size_bytes) {
  r.data = data;
  r.size_bits = size_bytes * 8;
  r.pos = 0;
  r.err = false;
}

inline uint64_t bits_remaining(const Reader& r) {
  return r.err ? 0 : r.size_bits - r.pos;
}

// big-endian 64-bit window starting at byte index `byte` (tail-safe:
// bytes past the buffer read as zero, which callers never consume
// because every path bounds itself by size_bits first)
inline uint64_t be_window(const Reader& r, uint64_t byte) {
  const uint64_t total_bytes = (r.size_bits + 7) >> 3;
  if (byte + 8 <= total_bytes) {
    uint64_t w;
    std::memcpy(&w, r.data + byte, 8);
    return __builtin_bswap64(w);
  }
  uint64_t w = 0;
  for (uint64_t i = byte; i < total_bytes; ++i)
    w |= static_cast<uint64_t>(r.data[i]) << (56 - 8 * (i - byte));
  return w;
}

// read n bits MSB-first (n <= 57 so the 8-byte window always covers it)
inline uint64_t read_bits(Reader& r, int n) {
  if (n <= 0) return 0;
  if (r.err || r.pos + static_cast<uint64_t>(n) > r.size_bits) {
    r.err = true;
    return 0;
  }
  const uint64_t window = be_window(r, r.pos >> 3);
  const int off = static_cast<int>(r.pos & 7);
  const uint64_t out = (window << off) >> (64 - n);
  r.pos += static_cast<uint64_t>(n);
  return out;
}

// count leading 1 bits, consume the terminating 0; false on error or
// count > max_ones (reference bit_reader.hpp:140-172). 64-bit strides:
// leading ones of the shifted window = clz of its complement.
inline bool read_unary_ones(Reader& r, uint32_t max_ones, uint32_t& count) {
  count = 0;
  if (r.err || r.pos >= r.size_bits) {
    r.err = true;
    return false;
  }
  while (true) {
    const int off = static_cast<int>(r.pos & 7);
    // low `off` bits shift in as zeros; they sit past `avail` so the
    // all-ones check below never reads them
    const uint64_t window = be_window(r, r.pos >> 3) << off;
    const uint64_t rem = r.size_bits - r.pos;
    const uint32_t avail =
        rem < static_cast<uint64_t>(64 - off) ? static_cast<uint32_t>(rem)
                                              : static_cast<uint32_t>(64 - off);
    const uint64_t inv = ~window;
    const uint32_t ones = inv == 0 ? 64u : static_cast<uint32_t>(__builtin_clzll(inv));
    if (ones >= avail) {
      // every valid bit in the window is a one — keep scanning
      count += avail;
      r.pos += avail;
      if (count > max_ones || r.pos >= r.size_bits) {
        r.err = true;
        return false;
      }
      continue;
    }
    count += ones;
    r.pos += static_cast<uint64_t>(ones) + 1;  // consume the zero too
    if (count > max_ones) {
      r.err = true;
      return false;
    }
    return true;
  }
}

inline bool consume_zero_padding(Reader& r) {
  while (r.pos & 7) {
    if (read_bits(r, 1) != 0 || r.err) {
      r.err = true;
      return false;
    }
  }
  return !r.err;
}

// ------------------------------------------------------------------ rice

inline int32_t zigzag_decode(uint32_t u) {
  return static_cast<int32_t>((u >> 1) ^ (~(u & 1u) + 1u));
}

inline bool read_rice_u(Reader& r, uint32_t k, uint32_t& value) {
  if (k > 31u) return false;
  // fast path: the whole token (q ones, the zero, k remainder bits)
  // inside one 64-bit window — one load, no second read_bits
  if (!r.err && r.pos < r.size_bits) {
    const int off = static_cast<int>(r.pos & 7);
    const uint64_t window = be_window(r, r.pos >> 3) << off;
    const uint64_t inv = ~window;
    const uint32_t ones = inv == 0 ? 64u : static_cast<uint32_t>(__builtin_clzll(inv));
    const uint64_t tok_bits = static_cast<uint64_t>(ones) + 1 + k;
    if (tok_bits + off <= 64 && r.pos + tok_bits <= r.size_bits) {
      if (ones > (0xFFFFFFFFu >> k)) {  // canonical q cap (q << k fits u32)
        r.err = true;
        return false;
      }
      const uint32_t rem =
          k ? static_cast<uint32_t>((window << (ones + 1)) >> (64 - k)) : 0u;
      r.pos += tok_bits;
      value = (ones << k) | rem;
      return true;
    }
  }
  uint32_t q = 0;
  if (!read_unary_ones(r, 0xFFFFFFFFu >> k, q)) return false;
  uint32_t rem = 0;
  if (k > 0) {
    rem = static_cast<uint32_t>(read_bits(r, static_cast<int>(k)));
    if (r.err) return false;
  }
  value = (q << k) | rem;
  return true;
}

// ------------------------------------------------------------- adaptation

// Incremental k tracker (reference semantics: rice.hpp:45-114 and the
// stateless twins block/encoder.cpp:72-77, block/decoder.cpp:90-96 —
// rounded mean (sum+count/2)/count, bit_width(mean-1) bucket, clamp 31;
// equivalence fuzz: scripts/fuzz_adapters.cpp).
// The adapters never need the mean's VALUE —
// only which k-bucket floor(num/count) falls in: k = 0 iff mean <= 1,
// k in [1,30] iff 2^(k-1) < mean <= 2^k, k = 31 iff mean > 2^30
// (k_from_mean below is the spec). Each bucket test cross-multiplies
// into `num vs (count << k) + count`, so the per-sample update is two
// shift+add compares on rarely-taken branches — no division and no
// serial remainder chain (k itself barely moves). Count jumps (zero-run
// bulk skips) just walk the boundary at most 31 steps.
struct KTrack {
  uint32_t k = 0;

  inline uint32_t update(uint64_t num, uint64_t count) {
    // ascend while floor(num/count) >= 2^k + 1
    while (k < 31u && num >= (count << k) + count) ++k;
    // descend while floor(num/count) <= 2^(k-1)
    while (k > 0u && num < (count << (k - 1)) + count) --k;
    return k;
  }
};

// stateful k adapter (reference rice.hpp:45-114 semantics)
struct AdaptK {
  uint64_t prev_sum = 0;
  uint32_t widx = 0, midx = 0, filled = 0;
  uint64_t wsum = 0;
  int32_t large = 0, zero = 0;
  KTrack ktrack;
  uint32_t recent[256];
  uint8_t lflags[96], zflags[96];
  AdaptK() {
    std::memset(recent, 0, sizeof recent);
    std::memset(lflags, 0, sizeof lflags);
    std::memset(zflags, 0, sizeof zflags);
  }
};

inline uint32_t bitwidth64(uint64_t m) {
  return m ? static_cast<uint32_t>(64 - __builtin_clzll(m)) : 0u;
}

inline uint32_t adapt_stateful(AdaptK& st, uint64_t sum, uint32_t count) {
  if (count == 0) return 0;
  const uint64_t cur = sum - st.prev_sum;
  st.prev_sum = sum;
  st.large -= st.lflags[st.midx];
  st.zero -= st.zflags[st.midx];
  if (st.filled < 256) {
    ++st.filled;
  } else {
    st.wsum -= st.recent[st.widx];
  }
  st.recent[st.widx] = static_cast<uint32_t>(cur);
  st.wsum += cur;
  const uint64_t num = sum + (count >> 1);
  const uint32_t k = st.ktrack.update(num, count);
  const uint32_t qb = (k >= 31u) ? 0u : static_cast<uint32_t>(cur >> k);
  const uint8_t il = qb > 3u, iz = qb == 0u;
  st.large += il;
  st.zero += iz;
  st.lflags[st.midx] = il;
  st.zflags[st.midx] = iz;
  int32_t bias = 0;
  // spec: mean = floor(num / count); compare lm against it WITHOUT the
  // division by cross-multiplying (floor(num/count) < t <=> num < t*count,
  // floor(num/count) >= t <=> num >= t*count, t a non-negative integer):
  //   lm*3 > mean*4   <=> mean <= (3*lm - 1)/4       (impossible for lm == 0)
  //   lm*4+3 < mean*3 <=> mean >= ceil((4*lm + 4)/3) == (4*lm + 6)/3
  if (st.filled > 0 && num >= count) {  // mean > 0
    const uint64_t lnum = st.wsum + (st.filled >> 1);
    const uint64_t lm = (st.filled == 256) ? ((st.wsum + 128) >> 8)
                        : (lnum <= 0xFFFFFFFFull)
                            ? (static_cast<uint32_t>(lnum) / st.filled)
                            : (lnum / st.filled);
    if (lm != 0 && num < ((3 * lm - 1) / 4 + 1) * count) bias = 1;
    else if (num >= ((4 * lm + 6) / 3) * count) bias = -1;
  }
  if (st.widx + 1 >= 96 || st.filled >= 96) {
    const uint32_t ws = st.filled >= 96 ? 96 : st.filled;
    if (static_cast<uint32_t>(st.large) * 4 >= ws * 3) bias = bias + 1 > 1 ? 1 : bias + 1;
    else if (static_cast<uint32_t>(st.zero) * 5 >= ws * 4) bias = bias - 1 < -1 ? -1 : bias - 1;
  }
  int32_t bk = static_cast<int32_t>(k) + bias;
  if (bk < 0) bk = 0;
  if (bk > 31) bk = 31;
  st.midx = (st.midx + 1 == 96) ? 0 : st.midx + 1;
  st.widx = (st.widx + 1) & 255;
  return static_cast<uint32_t>(bk);
}

inline uint32_t k_from_mean(uint64_t mean) {
  if (mean <= 1) return 0;
  const uint32_t bw = bitwidth64(mean - 1);
  return bw > 31u ? 31u : bw;
}

inline uint32_t adapt_stateless(uint64_t sum, uint32_t count) {
  if (count == 0) return 0;
  const uint64_t num = sum + (count >> 1);
  const uint64_t mean = (num <= 0xFFFFFFFFull) ? (static_cast<uint32_t>(num) / count)
                                               : (num / count);
  return k_from_mean(mean);
}

// incremental stateless adapter: one KTrack per partition replaces the
// per-sample division (identical results; adapt_stateless is the spec)
inline uint32_t adapt_stateless_inc(KTrack& kt, uint64_t sum, uint32_t count) {
  if (count == 0) return 0;
  return kt.update(sum + (count >> 1), count);
}

// ------------------------------------------------------- residual decode

constexpr uint32_t kZrMinRun = 4, kZrLenK = 2;

bool decode_segment(Reader& r, uint32_t samples, uint32_t initial_k, uint32_t mode,
                    int32_t* out, bool stateless, AdaptK* st) {
  if (mode > 3) return false;
  uint32_t k = initial_k;
  uint64_t sum = 0;
  uint32_t count = 0;
  KTrack md;
  auto step = [&](uint32_t u) {
    sum += u;
    ++count;
    k = stateless ? adapt_stateless_inc(md, sum, count) : adapt_stateful(*st, sum, count);
  };

  if (mode == 0) {  // adaptive rice
    for (uint32_t i = 0; i < samples; ++i) {
      uint32_t u;
      if (!read_rice_u(r, k, u)) return false;
      out[i] = zigzag_decode(u);
      step(u);
    }
    return true;
  }
  if (mode == 1) {  // zero-run
    uint32_t idx = 0;
    while (idx < samples) {
      const uint32_t tag = static_cast<uint32_t>(read_bits(r, 2));
      if (r.err || tag > 2u) return false;
      if (tag == 0) {
        uint32_t u;
        if (!read_rice_u(r, k, u) || idx >= samples) break;
        out[idx++] = zigzag_decode(u);
        step(u);
      } else if (tag == 1) {
        uint32_t enc;
        if (!read_rice_u(r, kZrLenK, enc) || enc > 0xFFFFFFFFu - kZrMinRun) return false;
        const uint32_t run = enc + kZrMinRun;
        if (run > samples - idx) return false;
        std::memset(out + idx, 0, sizeof(int32_t) * run);
        idx += run;
        if (stateless) {
          count += run;
          k = md.update(sum + (count >> 1), count);
        } else {
          for (uint32_t j = 0; j < run; ++j) {
            ++count;
            k = adapt_stateful(*st, sum, count);
          }
        }
      } else {  // escape
        if (idx >= samples) return false;
        const uint32_t zz = static_cast<uint32_t>(read_bits(r, 32));
        if (r.err) break;
        out[idx++] = zigzag_decode(zz);
        step(zz);
      }
    }
    return idx == samples;
  }
  if (mode == 2) {  // bin
    uint32_t idx = 0;
    while (idx < samples) {
      const uint32_t tag = static_cast<uint32_t>(read_bits(r, 2));
      if (r.err) return false;
      int32_t value;
      uint32_t u;
      if (tag == 0) {
        value = 0;
        u = 0;
      } else if (tag == 1 || tag == 2) {
        const uint32_t sign = static_cast<uint32_t>(read_bits(r, 1));
        if (r.err) return false;
        const int32_t mag = tag == 1 ? 1 : 2;
        value = sign ? -mag : mag;
        u = static_cast<uint32_t>(sign ? 2 * mag - 1 : 2 * mag);
      } else {
        if (!read_rice_u(r, k, u)) return false;
        value = zigzag_decode(u);
      }
      out[idx++] = value;
      step(u);
    }
    return idx == samples;
  }
  // static rice
  for (uint32_t i = 0; i < samples; ++i) {
    uint32_t u;
    if (!read_rice_u(r, initial_k, u)) return false;
    out[i] = zigzag_decode(u);
  }
  return true;
}

// ------------------------------------------------------- reconstruction

constexpr int64_t kI32Min = INT32_MIN, kI32Max = INT32_MAX;

// Fixed/FIR restores (reference block/decoder.cpp:308-358): history in
// registers and a sticky overflow flag instead of a per-sample bail-out
// branch — on overflow the stream is rejected and x[] discarded, so
// wrapped continuation values never escape; same verdict, measured
// 2-3x faster (branchless loops pipeline/vectorize).
bool restore_fixed(int32_t* x, uint32_t n, int order) {
  uint64_t bad = 0;
  switch (order) {
    case 0:
      return true;
    case 1: {
      if (n < 2) return true;
      int64_t h1 = x[0];
      for (uint32_t i = 1; i < n; ++i) {
        const int64_t s = static_cast<int64_t>(x[i]) + h1;
        const int32_t w = static_cast<int32_t>(s);
        bad |= static_cast<uint64_t>(s != static_cast<int64_t>(w));
        x[i] = w;
        h1 = w;
      }
      return bad == 0;
    }
    case 2: {
      if (n < 3) return true;
      int64_t h1 = x[1], h2 = x[0];
      for (uint32_t i = 2; i < n; ++i) {
        const int64_t s = static_cast<int64_t>(x[i]) + 2 * h1 - h2;
        const int32_t w = static_cast<int32_t>(s);
        bad |= static_cast<uint64_t>(s != static_cast<int64_t>(w));
        x[i] = w;
        h2 = h1;
        h1 = w;
      }
      return bad == 0;
    }
    case 3: {
      if (n < 4) return true;
      int64_t h1 = x[2], h2 = x[1], h3 = x[0];
      for (uint32_t i = 3; i < n; ++i) {
        const int64_t s = static_cast<int64_t>(x[i]) + 3 * h1 - 3 * h2 + h3;
        const int32_t w = static_cast<int32_t>(s);
        bad |= static_cast<uint64_t>(s != static_cast<int64_t>(w));
        x[i] = w;
        h3 = h2;
        h2 = h1;
        h1 = w;
      }
      return bad == 0;
    }
    case 4: {
      if (n < 5) return true;
      int64_t h1 = x[3], h2 = x[2], h3 = x[1], h4 = x[0];
      for (uint32_t i = 4; i < n; ++i) {
        const int64_t s =
            static_cast<int64_t>(x[i]) + 4 * h1 - 6 * h2 + 4 * h3 - h4;
        const int32_t w = static_cast<int32_t>(s);
        bad |= static_cast<uint64_t>(s != static_cast<int64_t>(w));
        x[i] = w;
        h4 = h3;
        h3 = h2;
        h2 = h1;
        h1 = w;
      }
      return bad == 0;
    }
    default:
      return false;
  }
}

bool restore_fir(int32_t* x, uint32_t n) {
  if (n < 3) return true;
  int64_t h1 = x[1], h2 = x[0];
  uint64_t bad = 0;
  for (uint32_t i = 2; i < n; ++i) {
    const int64_t s = static_cast<int64_t>(x[i]) + ((3 * h1 - h2) >> 2);
    const int32_t w = static_cast<int32_t>(s);
    bad |= static_cast<uint64_t>(s != static_cast<int64_t>(w));
    x[i] = w;
    h2 = h1;
    h1 = w;
  }
  return bad == 0;
}

bool restore_lpc(int32_t* x, uint32_t n, const int16_t* coeffs, int order) {
  const uint32_t warm = n < static_cast<uint32_t>(order) ? n : static_cast<uint32_t>(order);
  for (uint32_t i = 0; i < warm; ++i) {
    int64_t acc = 0;
    for (uint32_t j = 1; j <= i; ++j) acc += static_cast<int64_t>(coeffs[j]) * x[i - j];
    const int64_t s = (acc >> 15) + x[i];
    if (s < kI32Min || s > kI32Max) return false;
    x[i] = static_cast<int32_t>(s);
  }
  if (order == 12 && n > 12) {
    // the encoder's top LPC order (reference restore:
    // block/decoder.cpp:30-55 restore_lpc_known_order_in_place<12>):
    // coefficients and the 12-sample history
    // window live in registers, and the per-sample range check becomes a
    // sticky flag (on overflow the stream is rejected and x[] discarded,
    // so wrapped continuation values never escape; same verdict as the
    // bail-out loop, measured ~15% faster — the 12 i64 multiplies are
    // the throughput wall either way)
    const int64_t c1 = coeffs[1], c2 = coeffs[2], c3 = coeffs[3], c4 = coeffs[4],
                  c5 = coeffs[5], c6 = coeffs[6], c7 = coeffs[7], c8 = coeffs[8],
                  c9 = coeffs[9], c10 = coeffs[10], c11 = coeffs[11], c12 = coeffs[12];
    int64_t h1 = x[11], h2 = x[10], h3 = x[9], h4 = x[8], h5 = x[7], h6 = x[6],
            h7 = x[5], h8 = x[4], h9 = x[3], h10 = x[2], h11 = x[1], h12 = x[0];
    uint64_t bad = 0;
    for (uint32_t i = 12; i < n; ++i) {
      const int64_t acc = c1 * h1 + c2 * h2 + c3 * h3 + c4 * h4 + c5 * h5 +
                          c6 * h6 + c7 * h7 + c8 * h8 + c9 * h9 + c10 * h10 +
                          c11 * h11 + c12 * h12;
      const int64_t s = (acc >> 15) + x[i];
      const int32_t w = static_cast<int32_t>(s);
      bad |= static_cast<uint64_t>(s != static_cast<int64_t>(w));
      x[i] = w;
      h12 = h11; h11 = h10; h10 = h9; h9 = h8; h8 = h7; h7 = h6;
      h6 = h5; h5 = h4; h4 = h3; h3 = h2; h2 = h1; h1 = w;
    }
    return bad == 0;
  }
  for (uint32_t i = warm; i < n; ++i) {
    int64_t acc = 0;
    for (int j = 1; j <= order; ++j) acc += static_cast<int64_t>(coeffs[j]) * x[i - j];
    const int64_t s = (acc >> 15) + x[i];
    if (s < kI32Min || s > kI32Max) return false;
    x[i] = static_cast<int32_t>(s);
  }
  return true;
}

// --------------------------------------------------------- block decode

constexpr uint32_t kMaxBlock = 16384, kMinPartSize = 32;
constexpr uint8_t kMaxPartOrder = 8;

inline uint32_t part_size_at(uint32_t size, uint8_t order, uint32_t i, uint32_t count) {
  if (order == 0) return size;
  const uint32_t base = size >> order;
  return (i + 1 == count) ? size - base * (count - 1) : base;
}

struct BlockMeta {
  uint8_t ptype = 0;
  uint8_t order = 0;
  int16_t coeffs[33] = {0};
};

// canonical-rule citations: reference block/decoder.cpp:407-519
// parse the channel block into residuals; reconstruction is separate so
// the TPU path can run batched restores on device.
bool parse_channel_block(Reader& r, uint32_t block_size, int32_t* out, BlockMeta& meta) {
  if (block_size == 0 || block_size > kMaxBlock) return false;
  const uint32_t ptype = static_cast<uint32_t>(read_bits(r, 8));
  const uint32_t order = static_cast<uint32_t>(read_bits(r, 8));
  if (r.err || ptype > 2) return false;
  if (ptype == 2) {
    if (order == 0 || order > 32 || order >= block_size) return false;
  } else if (ptype == 1) {
    if (order != 2) return false;
  } else if (order > 4) {
    return false;
  }
  meta.ptype = static_cast<uint8_t>(ptype);
  meta.order = static_cast<uint8_t>(order);
  if (ptype == 2) {
    for (uint32_t i = 1; i <= order; ++i) {
      meta.coeffs[i] = static_cast<int16_t>(read_bits(r, 16));
      if (r.err) return false;
    }
  }
  const uint32_t control = static_cast<uint32_t>(read_bits(r, 8));
  if (r.err) return false;
  if (control & 0x10u) return false;  // reserved bit
  const bool pflag = (control & 0x80u) != 0;
  const uint8_t porder = static_cast<uint8_t>(control & 0x0Fu);
  const uint32_t cmode = (control >> 5) & 0x03u;
  if (pflag != (porder != 0)) return false;
  if (porder > kMaxPartOrder) return false;
  if (porder > 0 && (block_size >> porder) < kMinPartSize) return false;
  const uint32_t pcount = porder == 0 ? 1u : (1u << porder);
  if (part_size_at(block_size, porder, pcount - 1, pcount) == 0) return false;

  uint8_t pmodes[256];
  uint8_t pks[256];
  for (uint32_t i = 0; i < pcount; ++i) {
    pmodes[i] = static_cast<uint8_t>(read_bits(r, 2));
    pks[i] = static_cast<uint8_t>(read_bits(r, 5));
    if (r.err || pmodes[i] > 3) return false;
  }
  if (pmodes[0] != cmode) return false;

  const bool stateless = porder > 0;
  uint32_t off = 0;
  for (uint32_t i = 0; i < pcount; ++i) {
    const uint32_t psz = part_size_at(block_size, porder, i, pcount);
    AdaptK fresh;  // adaptation state never crosses a segment boundary
    if (!decode_segment(r, psz, pks[i], pmodes[i], out + off, stateless, &fresh)) return false;
    off += psz;
  }
  if (off != block_size) return false;
  return consume_zero_padding(r);
}

bool restore_block(const BlockMeta& meta, int32_t* out, uint32_t block_size) {
  if (meta.ptype == 0) return restore_fixed(out, block_size, meta.order);
  if (meta.ptype == 1) return restore_fir(out, block_size);
  return restore_lpc(out, block_size, meta.coeffs, meta.order);
}

bool decode_channel_block(Reader& r, uint32_t block_size, int32_t* out) {
  BlockMeta meta;
  if (!parse_channel_block(r, block_size, out, meta)) return false;
  return restore_block(meta, out, block_size);
}

inline bool pcm_in_range(const int32_t* x, uint32_t n, uint32_t depth) {
  const int32_t lo = depth == 16 ? -32768 : -0x800000;
  const int32_t hi = depth == 16 ? 32767 : 0x7FFFFF;
  for (uint32_t i = 0; i < n; ++i)
    if (x[i] < lo || x[i] > hi) return false;
  return true;
}

// post-decode finishing shared by the v3 parallel and v2 serial paths:
// PCM range validation, and in-place mid/side reconstruction
// (l = m + ((s + (s&1)) >> 1); r = l - s, reference lac/decoder.cpp:48-65)
inline bool finish_block_pcm(bool is_stereo, bool mid_side, uint32_t bit_depth,
                             int32_t* lp, int32_t* rp, uint32_t n) {
  if (!is_stereo) return pcm_in_range(lp, n, bit_depth);
  if (mid_side) {
    const int64_t lo = bit_depth == 16 ? -32768 : -0x800000;
    const int64_t hi = bit_depth == 16 ? 32767 : 0x7FFFFF;
    for (uint32_t i = 0; i < n; ++i) {
      const int64_t m = lp[i], s = rp[i];
      const int64_t l = m + ((s + (s & 1)) >> 1);
      const int64_t rr = l - s;
      if (l < lo || l > hi || rr < lo || rr > hi) return false;
      lp[i] = static_cast<int32_t>(l);
      rp[i] = static_cast<int32_t>(rr);
    }
    return true;
  }
  return pcm_in_range(lp, n, bit_depth) && pcm_in_range(rp, n, bit_depth);
}

}  // namespace

// ==================================================================== C API


namespace {
// Measured worker-id collector for --debug-threads (reference
// ThreadCollector, thread_collector.hpp:8-23). Reset by the host before
// an encode/decode; every pool worker notes its own id once.
std::mutex g_tc_mu;
std::set<std::thread::id> g_tc_ids;
inline void tc_note() {
  std::lock_guard<std::mutex> lk(g_tc_mu);
  g_tc_ids.insert(std::this_thread::get_id());
}
}  // namespace

extern "C" {

void lac_thread_collector_reset() {
  std::lock_guard<std::mutex> lk(g_tc_mu);
  g_tc_ids.clear();
}

uint64_t lac_thread_collector_count() {
  std::lock_guard<std::mutex> lk(g_tc_mu);
  return g_tc_ids.size();
}

// decode a batch of byte-bounded v3 block payloads into channel planes.
// returns 0 on success; -(block_index+1) identifies the first failing block.
int lac_decode_v3_blocks(const uint8_t* payload,
                         const uint64_t* payload_offsets,
                         const uint64_t* payload_sizes,
                         const uint32_t* block_sizes,
                         const uint64_t* sample_offsets,
                         uint32_t block_count,
                         uint32_t channels,
                         uint32_t stereo_mode,  // 0 LR, 1 MS, 2 per-block
                         uint32_t bit_depth,
                         int32_t* out_left,
                         int32_t* out_right,
                         int32_t num_threads) {
  const bool is_stereo = channels == 2;
  const bool per_block = is_stereo && stereo_mode == 2;
  const bool force_ms = is_stereo && stereo_mode == 1;

  std::atomic<uint32_t> next{0};
  std::atomic<int> status{0};

  auto worker = [&]() {
    tc_note();
    while (status.load(std::memory_order_relaxed) == 0) {
      const uint32_t bi = next.fetch_add(1, std::memory_order_relaxed);
      if (bi >= block_count) return;
      Reader r;
      reader_init(r, payload + payload_offsets[bi], payload_sizes[bi]);
      bool mid_side = force_ms;
      if (per_block) {
        const uint32_t flag = static_cast<uint32_t>(read_bits(r, 8));
        if (r.err || flag > 1) {
          int expect = 0;
          status.compare_exchange_strong(expect, -static_cast<int>(bi) - 1);
          return;
        }
        mid_side = flag == 1;
      }
      const uint32_t n = block_sizes[bi];
      int32_t* lp = out_left + sample_offsets[bi];
      int32_t* rp = is_stereo ? out_right + sample_offsets[bi] : nullptr;
      bool ok = decode_channel_block(r, n, lp);
      if (ok && is_stereo) ok = decode_channel_block(r, n, rp);
      if (ok && bits_remaining(r) != 0) ok = false;
      if (ok) ok = finish_block_pcm(is_stereo, mid_side, bit_depth, lp, rp, n);
      if (!ok) {
        int expect = 0;
        status.compare_exchange_strong(expect, -static_cast<int>(bi) - 1);
        return;
      }
    }
  };

  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  if (num_threads > 0 && static_cast<unsigned>(num_threads) < hw) hw = static_cast<unsigned>(num_threads);
  if (hw > block_count) hw = block_count;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(hw);
    for (unsigned i = 0; i < hw; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return status.load();
}

// decode a batch of v3 block payloads straight into interleaved
// little-endian WAV PCM bytes — the reference CLI's mmap fast-path analog
// (main.cpp:184-430: workers pack finished blocks at their computed byte
// offsets). Each worker decodes into thread-local scratch and packs while
// the block is cache-hot, so the whole-file int32 channel planes never
// exist and the host skips a separate interleave pass.
// returns 0 on success; -(block_index+1) identifies the first failing block.
int lac_decode_v3_to_pcm(const uint8_t* payload,
                         const uint64_t* payload_offsets,
                         const uint64_t* payload_sizes,
                         const uint32_t* block_sizes,
                         const uint64_t* sample_offsets,
                         uint32_t block_count,
                         uint32_t channels,
                         uint32_t stereo_mode,  // 0 LR, 1 MS, 2 per-block
                         uint32_t bit_depth,
                         uint8_t* out_pcm,
                         int32_t num_threads) {
  const bool is_stereo = channels == 2;
  const bool per_block = is_stereo && stereo_mode == 2;
  const bool force_ms = is_stereo && stereo_mode == 1;
  const uint32_t bytes_per = bit_depth / 8;
  const uint32_t block_align = channels * bytes_per;

  std::atomic<uint32_t> next{0};
  std::atomic<int> status{0};

  auto worker = [&]() {
    tc_note();
    std::vector<int32_t> lbuf(kMaxBlock), rbuf(is_stereo ? kMaxBlock : 0);
    while (status.load(std::memory_order_relaxed) == 0) {
      const uint32_t bi = next.fetch_add(1, std::memory_order_relaxed);
      if (bi >= block_count) return;
      Reader r;
      reader_init(r, payload + payload_offsets[bi], payload_sizes[bi]);
      bool mid_side = force_ms;
      if (per_block) {
        const uint32_t flag = static_cast<uint32_t>(read_bits(r, 8));
        if (r.err || flag > 1) {
          int expect = 0;
          status.compare_exchange_strong(expect, -static_cast<int>(bi) - 1);
          return;
        }
        mid_side = flag == 1;
      }
      const uint32_t n = block_sizes[bi];
      int32_t* lp = lbuf.data();
      int32_t* rp = is_stereo ? rbuf.data() : nullptr;
      bool ok = n <= kMaxBlock && decode_channel_block(r, n, lp);
      if (ok && is_stereo) ok = decode_channel_block(r, n, rp);
      if (ok && bits_remaining(r) != 0) ok = false;
      if (ok) ok = finish_block_pcm(is_stereo, mid_side, bit_depth, lp, rp, n);
      if (!ok) {
        int expect = 0;
        status.compare_exchange_strong(expect, -static_cast<int>(bi) - 1);
        return;
      }
      uint8_t* dst = out_pcm + sample_offsets[bi] * block_align;
      if (bit_depth == 16) {
        if (is_stereo) {
          for (uint32_t i = 0; i < n; ++i) {
            const uint32_t l = static_cast<uint16_t>(lp[i]);
            const uint32_t rr = static_cast<uint16_t>(rp[i]);
            dst[4 * i + 0] = static_cast<uint8_t>(l);
            dst[4 * i + 1] = static_cast<uint8_t>(l >> 8);
            dst[4 * i + 2] = static_cast<uint8_t>(rr);
            dst[4 * i + 3] = static_cast<uint8_t>(rr >> 8);
          }
        } else {
          for (uint32_t i = 0; i < n; ++i) {
            const uint32_t l = static_cast<uint16_t>(lp[i]);
            dst[2 * i + 0] = static_cast<uint8_t>(l);
            dst[2 * i + 1] = static_cast<uint8_t>(l >> 8);
          }
        }
      } else {  // 24-bit: 3-byte little-endian triplets
        if (is_stereo) {
          for (uint32_t i = 0; i < n; ++i) {
            const uint32_t l = static_cast<uint32_t>(lp[i]);
            const uint32_t rr = static_cast<uint32_t>(rp[i]);
            dst[6 * i + 0] = static_cast<uint8_t>(l);
            dst[6 * i + 1] = static_cast<uint8_t>(l >> 8);
            dst[6 * i + 2] = static_cast<uint8_t>(l >> 16);
            dst[6 * i + 3] = static_cast<uint8_t>(rr);
            dst[6 * i + 4] = static_cast<uint8_t>(rr >> 8);
            dst[6 * i + 5] = static_cast<uint8_t>(rr >> 16);
          }
        } else {
          for (uint32_t i = 0; i < n; ++i) {
            const uint32_t l = static_cast<uint32_t>(lp[i]);
            dst[3 * i + 0] = static_cast<uint8_t>(l);
            dst[3 * i + 1] = static_cast<uint8_t>(l >> 8);
            dst[3 * i + 2] = static_cast<uint8_t>(l >> 16);
          }
        }
      }
    }
  };

  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  if (num_threads > 0 && static_cast<unsigned>(num_threads) < hw) hw = static_cast<unsigned>(num_threads);
  if (hw > block_count) hw = block_count;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(hw);
    for (unsigned i = 0; i < hw; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return status.load();
}

// decode a v2 legacy stream: blocks are NOT byte-bounded (no payload-size
// table, reference format.md:40-47), so decode is serial in-order over one
// reader, exactly like the reference library path (lac/decoder.cpp:209-218).
// returns 0 on success, -(block_index+1) for the first failing block, or
// +1 when trailing payload bits remain after the final block.
int lac_decode_v2_stream(const uint8_t* payload,
                         uint64_t payload_bytes,
                         const uint32_t* block_sizes,
                         const uint64_t* sample_offsets,
                         uint32_t block_count,
                         uint32_t channels,
                         uint32_t stereo_mode,  // 0 LR, 1 MS, 2 per-block
                         uint32_t bit_depth,
                         int32_t* out_left,
                         int32_t* out_right) {
  const bool is_stereo = channels == 2;
  const bool per_block = is_stereo && stereo_mode == 2;
  const bool force_ms = is_stereo && stereo_mode == 1;
  Reader r;
  reader_init(r, payload, payload_bytes);
  for (uint32_t bi = 0; bi < block_count; ++bi) {
    bool mid_side = force_ms;
    if (per_block) {
      const uint32_t flag = static_cast<uint32_t>(read_bits(r, 8));
      if (r.err || flag > 1) return -static_cast<int>(bi) - 1;
      mid_side = flag == 1;
    }
    const uint32_t n = block_sizes[bi];
    int32_t* lp = out_left + sample_offsets[bi];
    int32_t* rp = is_stereo ? out_right + sample_offsets[bi] : nullptr;
    bool ok = decode_channel_block(r, n, lp);
    if (ok && is_stereo) ok = decode_channel_block(r, n, rp);
    if (ok) ok = finish_block_pcm(is_stereo, mid_side, bit_depth, lp, rp, n);
    if (!ok) return -static_cast<int>(bi) - 1;
  }
  return bits_remaining(r) != 0 ? 1 : 0;
}

// total bit length of an element stream (unary ones + field bits each)
uint64_t lac_pack_bits(const uint64_t* unary, const uint8_t* field_len, uint64_t count) {
  uint64_t total = 0;
  for (uint64_t i = 0; i < count; ++i) total += unary[i] + field_len[i];
  return total;
}

// pack elements MSB-first into out (caller sizes it via lac_pack_bits;
// final partial byte zero-padded). returns bytes written.
uint64_t lac_pack_stream(const uint64_t* unary,
                         const uint64_t* field_val,
                         const uint8_t* field_len,
                         uint64_t count,
                         uint8_t* out,
                         uint64_t out_capacity) {
  uint64_t acc = 0;  // bit accumulator, MSB-aligned in the low `nacc` bits
  int nacc = 0;
  uint64_t nout = 0;
  auto flush = [&]() {
    while (nacc >= 8) {
      nacc -= 8;
      out[nout++] = static_cast<uint8_t>((acc >> nacc) & 0xFFu);
    }
    acc &= (nacc == 0) ? 0 : ((1ULL << nacc) - 1);
  };
  for (uint64_t i = 0; i < count; ++i) {
    uint64_t ones = unary[i];
    while (ones > 0) {
      const int chunk = ones > 32 ? 32 : static_cast<int>(ones);
      acc = (acc << chunk) | ((1ULL << chunk) - 1);
      nacc += chunk;
      ones -= static_cast<uint64_t>(chunk);
      flush();
    }
    const int fl = field_len[i];  // <= 57 by construction (tokens <= 33)
    if (fl > 0) {
      acc = (acc << fl) | (field_val[i] & ((1ULL << fl) - 1));
      nacc += fl;
      flush();
    }
  }
  if (nout + ((static_cast<uint64_t>(nacc) + 7) / 8) > out_capacity) return 0;
  if (nacc > 0) {
    out[nout++] = static_cast<uint8_t>((acc << (8 - nacc)) & 0xFFu);
  }
  return nout;
}

// tokenize v3 block payloads into residual planes + predictor metadata,
// deferring reconstruction (the TPU decode path restores on device).
// returns 0 or -(block_index+1).
int lac_tokenize_v3_blocks(const uint8_t* payload,
                           const uint64_t* payload_offsets,
                           const uint64_t* payload_sizes,
                           const uint32_t* block_sizes,
                           const uint64_t* sample_offsets,
                           uint32_t block_count,
                           uint32_t channels,
                           uint32_t stereo_mode,
                           int32_t* out_res,      // channel planes, total x channels
                           uint64_t plane_stride,  // samples per plane
                           uint8_t* out_ptype,    // (block_count * channels)
                           uint8_t* out_order,    // (block_count * channels)
                           int16_t* out_coeffs,   // (block_count * channels * 33)
                           uint8_t* out_msflag,   // (block_count)
                           int32_t num_threads) {
  const bool is_stereo = channels == 2;
  const bool per_block = is_stereo && stereo_mode == 2;
  const bool force_ms = is_stereo && stereo_mode == 1;
  std::atomic<uint32_t> next{0};
  std::atomic<int> status{0};

  auto worker = [&]() {
    tc_note();
    while (status.load(std::memory_order_relaxed) == 0) {
      const uint32_t bi = next.fetch_add(1, std::memory_order_relaxed);
      if (bi >= block_count) return;
      Reader r;
      reader_init(r, payload + payload_offsets[bi], payload_sizes[bi]);
      bool mid_side = force_ms;
      bool ok = true;
      if (per_block) {
        const uint32_t flag = static_cast<uint32_t>(read_bits(r, 8));
        if (r.err || flag > 1) ok = false;
        else mid_side = flag == 1;
      }
      const uint32_t n = block_sizes[bi];
      for (uint32_t ch = 0; ok && ch < channels; ++ch) {
        BlockMeta meta;
        int32_t* dst = out_res + ch * plane_stride + sample_offsets[bi];
        ok = parse_channel_block(r, n, dst, meta);
        if (ok) {
          const uint32_t slot = bi * channels + ch;
          out_ptype[slot] = meta.ptype;
          out_order[slot] = meta.order;
          std::memcpy(out_coeffs + slot * 33, meta.coeffs, sizeof meta.coeffs);
        }
      }
      if (ok && bits_remaining(r) != 0) ok = false;
      if (ok) out_msflag[bi] = mid_side ? 1 : 0;
      if (!ok) {
        int expect = 0;
        status.compare_exchange_strong(expect, -static_cast<int>(bi) - 1);
        return;
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  if (num_threads > 0 && static_cast<unsigned>(num_threads) < hw) hw = static_cast<unsigned>(num_threads);
  if (hw > block_count) hw = block_count;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(hw);
    for (unsigned i = 0; i < hw; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return status.load();
}

// --------------------------------------------------------- plan replay

namespace {

struct BitSink {
  uint8_t* out;
  uint64_t cap;
  uint64_t nout = 0;
  uint64_t acc = 0;  // up to 64 pending bits, MSB-first in the low nacc bits
  int nacc = 0;
  bool overflow = false;

  // spill whole bytes; bulk big-endian 32-bit stores on the hot path
  inline void flush() {
    while (nacc >= 32) {
      nacc -= 32;
      uint32_t w32 = static_cast<uint32_t>((acc >> nacc) & 0xFFFFFFFFu);
      if (nout + 4 <= cap) {
        w32 = __builtin_bswap32(w32);
        std::memcpy(out + nout, &w32, 4);
      } else {
        for (int s = 24; s >= 0; s -= 8) {
          if (nout + static_cast<uint64_t>((24 - s) / 8) < cap)
            out[nout + (24 - s) / 8] = static_cast<uint8_t>((w32 >> s) & 0xFFu);
          else
            overflow = true;
        }
      }
      nout += 4;
    }
    while (nacc >= 8) {
      nacc -= 8;
      if (nout < cap) out[nout] = static_cast<uint8_t>((acc >> nacc) & 0xFFu);
      else overflow = true;
      ++nout;
    }
    acc &= (nacc == 0) ? 0 : ((1ULL << nacc) - 1);
  }
  // deferred flush: accumulate until the u64 would overflow (~3x fewer
  // flushes than flushing per call; bytes land in 32-bit stores)
  inline void bits(uint64_t v, int nb) {
    if (nb <= 0) return;
    if (nacc + nb > 64) flush();  // leaves nacc < 8
    acc = (acc << nb) | (v & ((nb >= 64) ? ~0ULL : ((1ULL << nb) - 1)));
    nacc += nb;
  }
  inline void ones(uint64_t count) {
    while (count > 0) {
      const int chunk = count > 32 ? 32 : static_cast<int>(count);
      bits((1ULL << chunk) - 1, chunk);
      count -= static_cast<uint64_t>(chunk);
    }
  }
  inline void pad_to_byte() {
    flush();
    if (nacc > 0) {
      if (nout < cap) out[nout] = static_cast<uint8_t>((acc << (8 - nacc)) & 0xFFu);
      else overflow = true;
      ++nout;
      acc = 0;
      nacc = 0;
    }
  }
};

inline uint32_t zigzag_u(int32_t v) {
  return (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
}

inline void rice_emit(BitSink& w, uint32_t u, uint32_t k) {
  // The shift guard is k >= 32 to mirror the reference *emitter*
  // (Rice::encode, rice.cpp:23), which emits q = u >> 31 at k == 31.
  // The planner's cost model instead forces q = 0 at k >= 31 — that
  // asymmetry is the reference's own (encoder.cpp:68,80,132) and both
  // sides must be reproduced exactly for byte parity.
  const uint32_t q = (k >= 32u) ? 0u : (u >> k);
  const uint32_t total = q + 1 + k;
  if (total <= 57) {  // typical token: one fused bits() call
    const uint64_t tok = (((1ULL << q) - 1) << (k + 1)) |
                         (k ? (u & ((1u << k) - 1u)) : 0u);
    w.bits(tok, static_cast<int>(total));
    return;
  }
  w.ones(q);
  w.bits(0, 1);
  if (k > 0) w.bits(u & ((1u << k) - 1u), static_cast<int>(k));
}

// LPC open-loop residual steady state (i >= order), SIMD when available.
// res[i] = trunc32(x[i] - ((sum_j c[j]*x[i-j]) >> 15)); products <= 2^46
// and 12-tap sums <= 2^50, exact in int64 lanes. The analog of the
// reference's NEON lpc_residual pipeline (simd/neon.cpp:61-264) for the
// AVX-512 hosts this runtime targets. When `bad` is non-null it
// accumulates the int32-range check of lpc_residual_checked.
inline void lpc_residual_steady(const int32_t* x, uint32_t n, const int16_t* coeffs,
                                uint32_t order, int32_t* res, bool* bad) {
  constexpr int64_t i32min = INT32_MIN, i32max = INT32_MAX;
  uint32_t i = order;
#if defined(LAC_SIMD_LPC)
  if (n >= order + 8) {
    __m512i cvec[33];
    for (uint32_t j = 1; j <= order; ++j) cvec[j] = _mm512_set1_epi64(coeffs[j]);
    const __m512i vmin = _mm512_set1_epi64(i32min);
    const __m512i vmax = _mm512_set1_epi64(i32max);
    __mmask8 oob = 0;
    for (; i + 8 <= n; i += 8) {
      __m512i acc = _mm512_setzero_si512();
      for (uint32_t j = 1; j <= order; ++j) {
        const __m512i xv = _mm512_cvtepi32_epi64(
            _mm256_loadu_si256(reinterpret_cast<const __m256i*>(x + i - j)));
        acc = _mm512_add_epi64(acc, _mm512_mullo_epi64(xv, cvec[j]));
      }
      const __m512i xi = _mm512_cvtepi32_epi64(
          _mm256_loadu_si256(reinterpret_cast<const __m256i*>(x + i)));
      const __m512i diff = _mm512_sub_epi64(xi, _mm512_srai_epi64(acc, 15));
      if (bad) {
        oob |= _mm512_cmp_epi64_mask(diff, vmin, _MM_CMPINT_LT);
        oob |= _mm512_cmp_epi64_mask(vmax, diff, _MM_CMPINT_LT);
      }
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(res + i),
                          _mm512_cvtepi64_epi32(diff));
    }
    if (bad && oob) *bad = true;
  }
#endif
  for (; i < n; ++i) {
    int64_t acc = 0;
    for (uint32_t j = 1; j <= order; ++j) acc += static_cast<int64_t>(coeffs[j]) * x[i - j];
    const int64_t diff = x[i] - (acc >> 15);
    if (bad && (diff < i32min || diff > i32max)) *bad = true;
    res[i] = static_cast<int32_t>(diff);
  }
}

// open-loop residual of the chosen predictor (encoder side)
void compute_residual(const int32_t* x, uint32_t n, uint32_t ptype, uint32_t order,
                      const int16_t* coeffs, int32_t* res) {
  if (ptype == 0) {  // fixed
    for (uint32_t i = 0; i < order && i < n; ++i) res[i] = x[i];
    switch (order) {
      case 0:
        for (uint32_t i = 0; i < n; ++i) res[i] = x[i];
        break;
      case 1:
        for (uint32_t i = 1; i < n; ++i) res[i] = static_cast<int32_t>(x[i] - static_cast<int64_t>(x[i - 1]));
        break;
      case 2:
        for (uint32_t i = 2; i < n; ++i) res[i] = static_cast<int32_t>(x[i] - (2LL * x[i - 1] - x[i - 2]));
        break;
      case 3:
        for (uint32_t i = 3; i < n; ++i) res[i] = static_cast<int32_t>(x[i] - (3LL * x[i - 1] - 3LL * x[i - 2] + x[i - 3]));
        break;
      default:
        for (uint32_t i = 4; i < n; ++i) res[i] = static_cast<int32_t>(x[i] - (4LL * x[i - 1] - 6LL * x[i - 2] + 4LL * x[i - 3] - x[i - 4]));
        break;
    }
  } else if (ptype == 1) {  // FIR {3,-1} >> 2
    for (uint32_t i = 0; i < 2 && i < n; ++i) res[i] = x[i];
    for (uint32_t i = 2; i < n; ++i) {
      const int64_t pred = (3LL * x[i - 1] - x[i - 2]) >> 2;
      res[i] = static_cast<int32_t>(x[i] - pred);
    }
  } else {  // LPC open loop, warmup taps limited by index
    const uint32_t warm = order < n ? order : n;
    for (uint32_t i = 0; i < warm; ++i) {
      int64_t acc = 0;
      for (uint32_t j = 1; j <= i; ++j) acc += static_cast<int64_t>(coeffs[j]) * x[i - j];
      res[i] = static_cast<int32_t>(x[i] - (acc >> 15));
    }
    lpc_residual_steady(x, n, coeffs, order, res, nullptr);
  }
}

// emit one residual partition in the given mode (encoder.cpp:585-771)
void emit_partition(BitSink& w, const int32_t* res, uint32_t len, uint32_t mode,
                    uint32_t initial_k, bool stateless) {
  uint32_t k = initial_k;
  uint64_t sum = 0;
  uint32_t count = 0;
  AdaptK st;
  KTrack md;
  auto step = [&](uint32_t u) {
    sum += u;
    ++count;
    k = stateless ? adapt_stateless_inc(md, sum, count) : adapt_stateful(st, sum, count);
  };
  if (mode == 0) {
    for (uint32_t i = 0; i < len; ++i) {
      const uint32_t u = zigzag_u(res[i]);
      rice_emit(w, u, k);
      step(u);
    }
  } else if (mode == 1) {  // zero-run
    uint32_t i = 0;
    while (i < len) {
      uint32_t run = 0;
      while (i + run < len && res[i + run] == 0) ++run;
      if (run >= kZrMinRun) {
        w.bits(0b01, 2);
        rice_emit(w, run - kZrMinRun, kZrLenK);
        if (stateless) {
          count += run;
          k = md.update(sum + (count >> 1), count);
        } else {
          for (uint32_t j = 0; j < run; ++j) {
            ++count;
            k = adapt_stateful(st, sum, count);
          }
        }
        i += run;
        continue;
      }
      const uint32_t u = zigzag_u(res[i]);
      const uint32_t esc_shift = (k + 3u > 24u) ? 24u : k + 3u;
      if (u > (1u << esc_shift)) {
        w.bits(0b10, 2);
        w.bits(u, 32);
      } else {
        w.bits(0b00, 2);
        rice_emit(w, u, k);
      }
      step(u);
      ++i;
    }
  } else if (mode == 2) {  // bin
    for (uint32_t i = 0; i < len; ++i) {
      const int32_t v = res[i];
      const uint32_t u = zigzag_u(v);
      if (v == 0) {
        w.bits(0b00, 2);
      } else if (v == 1 || v == -1) {
        w.bits(0b01, 2);
        w.bits(v < 0 ? 1 : 0, 1);
      } else if (v == 2 || v == -2) {
        w.bits(0b10, 2);
        w.bits(v < 0 ? 1 : 0, 1);
      } else {
        w.bits(0b11, 2);
        rice_emit(w, u, k);
      }
      step(u);
    }
  } else {  // static rice
    for (uint32_t i = 0; i < len; ++i) rice_emit(w, zigzag_u(res[i]), initial_k);
  }
}

}  // namespace

namespace {

// emit one lane's full wire payload from its residual plan; returns
// false on output overflow.
inline bool emit_one_lane(const int32_t* pcm_lane, uint32_t n, uint8_t ptype_b,
                          uint8_t order_b, const int16_t* coeffs_b, uint8_t best_p_b,
                          const uint8_t* modes_b, const uint8_t* ks_b, uint8_t* out_b,
                          uint64_t lane_cap, uint64_t* size_b, int32_t* res) {
  compute_residual(pcm_lane, n, ptype_b, order_b, coeffs_b, res);
  BitSink w{out_b, lane_cap};
  w.bits(ptype_b, 8);
  w.bits(order_b, 8);
  if (ptype_b == 2) {
    for (uint32_t j = 1; j <= order_b; ++j) {
      w.bits(static_cast<uint16_t>(coeffs_b[j]), 16);
    }
  }
  const uint32_t p = best_p_b;
  const uint32_t nparts = p == 0 ? 1u : (1u << p);
  uint32_t control = (modes_b[0] & 3u) << 5;
  if (p > 0) control |= 0x80u | p;
  w.bits(control, 8);
  for (uint32_t i = 0; i < nparts; ++i) {
    w.bits(modes_b[i] & 3u, 2);
    w.bits(ks_b[i] & 31u, 5);
  }
  const uint32_t base = p == 0 ? n : (n >> p);
  uint32_t off = 0;
  for (uint32_t i = 0; i < nparts; ++i) {
    const uint32_t len = (i + 1 == nparts) ? n - off : base;
    emit_partition(w, res + off, len, modes_b[i] & 3u, ks_b[i] & 31u, p > 0);
    off += len;
  }
  w.pad_to_byte();
  if (w.overflow) return false;
  *size_b = w.nout;
  return true;
}

}  // namespace

// replay a chosen encode plan: per lane, compute the winning predictor's
// residual and serially emit the exact wire payload. The device performs
// the candidate/mode/partition *search*; this performs the inherently
// bit-serial *emission* (one pass, thread-parallel over lanes).
// returns 0, or -(lane+1) if a lane overflowed its output slot.
int lac_emit_blocks(const int32_t* pcm,  // (B, n) row-major
                    uint32_t B,
                    uint32_t n,
                    const uint8_t* ptype,    // (B)
                    const uint8_t* order,    // (B) chosen wire order
                    const int16_t* coeffs,   // (B, 33)
                    const uint8_t* best_p,   // (B)
                    const uint8_t* modes,    // (B, 256)
                    const uint8_t* ks,       // (B, 256)
                    uint8_t* out,            // (B, lane_cap)
                    uint64_t lane_cap,
                    uint64_t* out_sizes,     // (B)
                    int32_t num_threads) {
  std::atomic<uint32_t> next{0};
  std::atomic<int> status{0};
  auto worker = [&]() {
    tc_note();
    std::vector<int32_t> res(n);
    while (status.load(std::memory_order_relaxed) == 0) {
      const uint32_t b = next.fetch_add(1, std::memory_order_relaxed);
      if (b >= B) return;
      if (!emit_one_lane(pcm + static_cast<uint64_t>(b) * n, n, ptype[b], order[b],
                         coeffs + static_cast<uint64_t>(b) * 33, best_p[b],
                         modes + static_cast<uint64_t>(b) * 256,
                         ks + static_cast<uint64_t>(b) * 256,
                         out + static_cast<uint64_t>(b) * lane_cap, lane_cap,
                         out_sizes + b, res.data())) {
        int expect = 0;
        status.compare_exchange_strong(expect, -static_cast<int>(b) - 1);
        return;
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  if (num_threads > 0 && static_cast<unsigned>(num_threads) < hw) hw = static_cast<unsigned>(num_threads);
  if (hw > B) hw = B;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(hw);
    for (unsigned i = 0; i < hw; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return status.load();
}

// plane-derived replay: lanes are described as (row, variant, slot,
// start) views into the resident L/R channel planes ((nb, plane_n)
// int16 or int32); the worker materializes each lane's PCM (L, R,
// mid=(l+r)>>1, or side=l-r — neon.cpp:14-30 scalar semantics) in-cache
// and emits as lac_emit_blocks does. Removes the host-side (lanes, n)
// PCM assembly pass entirely.
int lac_emit_blocks_planes(const void* lplane,
                           const void* rplane,      // may equal lplane for mono
                           uint32_t elem_size,      // 2 or 4
                           uint32_t plane_n,        // samples per plane row
                           const int32_t* rows,     // (B) plane row per lane
                           const uint8_t* variants, // (B) 0 = L/R, 1 = M/S
                           const uint8_t* slots,    // (B) 0 primary / 1 secondary
                           const uint32_t* starts,  // (B) sample offset in row
                           uint32_t B,
                           uint32_t n,              // lane length
                           const uint8_t* ptype,
                           const uint8_t* order,
                           const int16_t* coeffs,   // (B, 33)
                           const uint8_t* best_p,
                           const uint8_t* modes,    // (B, 256)
                           const uint8_t* ks,       // (B, 256)
                           uint8_t* out,
                           uint64_t lane_cap,
                           uint64_t* out_sizes,
                           int32_t num_threads) {
  std::atomic<uint32_t> next{0};
  std::atomic<int> status{0};
  auto worker = [&]() {
    tc_note();
    std::vector<int32_t> res(n), lane(n);
    while (status.load(std::memory_order_relaxed) == 0) {
      const uint32_t b = next.fetch_add(1, std::memory_order_relaxed);
      if (b >= B) return;
      const uint64_t off = static_cast<uint64_t>(rows[b]) * plane_n + starts[b];
      const bool ms = variants[b] != 0;
      const bool secondary = slots[b] != 0;
      int32_t* dst = lane.data();
      if (elem_size == 2) {
        const int16_t* lp = static_cast<const int16_t*>(lplane) + off;
        const int16_t* rp = static_cast<const int16_t*>(rplane) + off;
        if (!ms) {
          const int16_t* src = secondary ? rp : lp;
          for (uint32_t i = 0; i < n; ++i) dst[i] = src[i];
        } else if (!secondary) {
          for (uint32_t i = 0; i < n; ++i)
            dst[i] = (static_cast<int32_t>(lp[i]) + rp[i]) >> 1;
        } else {
          for (uint32_t i = 0; i < n; ++i)
            dst[i] = static_cast<int32_t>(lp[i]) - rp[i];
        }
      } else {
        const int32_t* lp = static_cast<const int32_t*>(lplane) + off;
        const int32_t* rp = static_cast<const int32_t*>(rplane) + off;
        if (!ms) {
          std::memcpy(dst, secondary ? rp : lp, sizeof(int32_t) * n);
        } else if (!secondary) {
          for (uint32_t i = 0; i < n; ++i)
            dst[i] = static_cast<int32_t>(
                (static_cast<int64_t>(lp[i]) + rp[i]) >> 1);
        } else {
          for (uint32_t i = 0; i < n; ++i)
            dst[i] = static_cast<int32_t>(static_cast<int64_t>(lp[i]) - rp[i]);
        }
      }
      if (!emit_one_lane(dst, n, ptype[b], order[b],
                         coeffs + static_cast<uint64_t>(b) * 33, best_p[b],
                         modes + static_cast<uint64_t>(b) * 256,
                         ks + static_cast<uint64_t>(b) * 256,
                         out + static_cast<uint64_t>(b) * lane_cap, lane_cap,
                         out_sizes + b, res.data())) {
        int expect = 0;
        status.compare_exchange_strong(expect, -static_cast<int>(b) - 1);
        return;
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  if (num_threads > 0 && static_cast<unsigned>(num_threads) < hw) hw = static_cast<unsigned>(num_threads);
  if (hw > B) hw = B;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(hw);
    for (unsigned i = 0; i < hw; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return status.load();
}

// --------------------------------------------------------- block planner

namespace {

// Native single-pass twin of the batched device planner
// (encoder.plan_group, reference block/encoder.cpp:313-552): candidate
// scoring with the exact cost model, lexicographic selection, and the
// partition sweep with the 5% decode-speed margins. Used for odd-length
// tail blocks and the no-JAX host path, where the numpy array program's
// allocation footprint dominates. Produces the same compact `meta` rows
// the device planner ships (sel, best_p, in_range, modes, ks).

constexpr uint32_t kNumFixed = 5;
constexpr uint32_t kLpcBase = 6;  // 5 fixed + FIR
constexpr uint32_t kLpcCands = 5;
constexpr uint32_t kNumCand = kLpcBase + kLpcCands;  // 11
constexpr uint32_t kInitialScan = 256, kInitialMaxK = 12, kMaxStaticK = 15;
constexpr uint32_t kMinPartition = 32;  // kMaxPartOrder shared (decl above)
constexpr uint32_t kMarginDiv = 20;
constexpr uint8_t kCandPtype[kNumCand] = {0, 0, 0, 0, 0, 1, 2, 2, 2, 2, 2};

inline uint32_t max_part_order(uint32_t n) {
  uint32_t max_p = 0;
  for (uint32_t p = 1; p <= kMaxPartOrder; ++p) {
    if ((n >> p) < kMinPartition) break;
    max_p = p;
  }
  return max_p;
}

inline uint64_t pad8(uint64_t bits) { return bits + ((8 - (bits & 7)) & 7); }

// open-loop LPC residual with int32-range check (lpc.cpp:38-61); taps
// limited by index so zero-padded coefficient sets reproduce lower
// orders exactly. Returns false when any difference leaves int32.
inline bool lpc_residual_checked(const int32_t* x, uint32_t n, const int16_t* coeffs,
                                 uint32_t order, int32_t* res) {
  bool bad = false;
  const uint32_t warm = order < n ? order : n;
  for (uint32_t i = 0; i < warm; ++i) {
    int64_t acc = 0;
    for (uint32_t j = 1; j <= i; ++j) acc += static_cast<int64_t>(coeffs[j]) * x[i - j];
    const int64_t diff = x[i] - (acc >> 15);
    bad |= diff < kI32Min || diff > kI32Max;
    res[i] = static_cast<int32_t>(diff);
  }
  lpc_residual_steady(x, n, coeffs, order, res, &bad);
  return !bad;
}

struct CandScore {
  uint64_t rice_bits = 0, bin_bits = 0, zr_bits = 0, static_bits = 0;
  uint32_t initial_k = 0, static_k = 0;
  bool has_run = false;
};

// ---- vectorized planner primitives ----------------------------------
//
// The cost model is split into (a) embarrassingly parallel per-sample
// sweeps (zigzag, sum(u >> k) for k = 0..15, per-sample mode costs given
// a k sequence) which run 16-wide under AVX-512, and (b) the inherently
// serial adaptation recurrences (adapt_stateful / adapt_stateless_inc)
// which stay scalar but now only record the k *sequence* instead of also
// computing every mode cost inline. The scalar twins below each SIMD
// body are the spec; parity is pinned by tests/test_native_planner.py.

inline void zigzag_fill(const int32_t* res, uint32_t n, uint32_t* u) {
  uint32_t i = 0;
#if defined(LAC_SIMD_LPC)
  for (; i + 16 <= n; i += 16) {
    const __m512i v = _mm512_loadu_si512(res + i);
    const __m512i z =
        _mm512_xor_si512(_mm512_slli_epi32(v, 1), _mm512_srai_epi32(v, 31));
    _mm512_storeu_si512(u + i, z);
  }
#endif
  for (; i < n; ++i) u[i] = zigzag_u(res[i]);
}

// out[k] += sum_{i in [lo, hi)} u[i] >> k, k = 0..15
inline void ksweep16(const uint32_t* u, uint32_t lo, uint32_t hi, uint64_t out[16]) {
  uint32_t i = lo;
#if defined(LAC_SIMD_LPC)
  __m512i acc[16];
  for (int k = 0; k < 16; ++k) acc[k] = _mm512_setzero_si512();
  for (; i + 8 <= hi; i += 8) {
    __m512i v = _mm512_cvtepu32_epi64(
        _mm256_loadu_si256(reinterpret_cast<const __m256i*>(u + i)));
    acc[0] = _mm512_add_epi64(acc[0], v);
    for (int k = 1; k < 16; ++k) {
      v = _mm512_srli_epi64(v, 1);
      acc[k] = _mm512_add_epi64(acc[k], v);
    }
  }
  for (int k = 0; k < 16; ++k)
    out[k] += static_cast<uint64_t>(_mm512_reduce_add_epi64(acc[k]));
#endif
  for (; i < hi; ++i) {
    const uint32_t uu = u[i];
    for (uint32_t k = 0; k < 16; ++k) out[k] += uu >> k;
  }
}

// i-major prefix-sum table: ps[i*16 + k] = sum_{j < i} u[j] >> k
// (row n inclusive, so partition ranges are two row lookups).
inline void psum_build(const uint32_t* u, uint32_t n, uint64_t* ps) {
#if defined(LAC_SIMD_LPC)
  __m512i acc_a = _mm512_setzero_si512();
  __m512i acc_b = _mm512_setzero_si512();
  const __m512i sh_a = _mm512_set_epi64(7, 6, 5, 4, 3, 2, 1, 0);
  const __m512i sh_b = _mm512_set_epi64(15, 14, 13, 12, 11, 10, 9, 8);
  _mm512_storeu_si512(ps, acc_a);
  _mm512_storeu_si512(ps + 8, acc_b);
  for (uint32_t i = 0; i < n; ++i) {
    const __m512i ub = _mm512_set1_epi64(u[i]);
    acc_a = _mm512_add_epi64(acc_a, _mm512_srlv_epi64(ub, sh_a));
    acc_b = _mm512_add_epi64(acc_b, _mm512_srlv_epi64(ub, sh_b));
    _mm512_storeu_si512(ps + static_cast<size_t>(i + 1) * 16, acc_a);
    _mm512_storeu_si512(ps + static_cast<size_t>(i + 1) * 16 + 8, acc_b);
  }
#else
  uint64_t acc[16] = {0};
  std::memcpy(ps, acc, sizeof acc);
  for (uint32_t i = 0; i < n; ++i) {
    const uint32_t uu = u[i];
    for (uint32_t k = 0; k < 16; ++k) acc[k] += uu >> k;
    std::memcpy(ps + static_cast<size_t>(i + 1) * 16, acc, sizeof acc);
  }
#endif
}

struct ModeCosts {
  uint64_t rice = 0, bin = 0, zr_esc = 0;
};

// Per-sample mode costs over [lo, hi) given the per-sample k sequence:
//   rice  += q + 1 + k                     (q = u >> k, forced 0 at k >= 31)
//   bin   += u == 0 ? 2 : u <= 4 ? 3 : 2 + rice_per
//   zr_esc+= covered ? 0 : 2 + (u > 1 << min(k+3, 24) ? 32 : rice_per)
// `covered[i]` marks zeros inside a >= kZrMinRun run (their bits are the
// run token, added by the serial pass). Semantics: encoder.cpp:201-263.
inline void cost_pass(const uint32_t* u, const uint8_t* kseq, const uint8_t* covered,
                      uint32_t lo, uint32_t hi, ModeCosts& mc) {
  uint32_t i = lo;
#if defined(LAC_SIMD_LPC)
  __m512i rice_acc = _mm512_setzero_si512();
  __m512i bin_acc = _mm512_setzero_si512();
  __m512i zr_acc = _mm512_setzero_si512();
  const __m512i zero = _mm512_setzero_si512();
  const __m512i one32 = _mm512_set1_epi32(1);
  const __m512i three32 = _mm512_set1_epi32(3);
  const __m512i four32 = _mm512_set1_epi32(4);
  const __m512i v24 = _mm512_set1_epi32(24);
  const __m512i v31 = _mm512_set1_epi32(31);
  const __m512i two64 = _mm512_set1_epi64(2);
  const __m512i three64 = _mm512_set1_epi64(3);
  const __m512i v34_64 = _mm512_set1_epi64(34);
  for (; i + 16 <= hi; i += 16) {
    const __m512i uv = _mm512_loadu_si512(u + i);
    const __m512i kv = _mm512_cvtepu8_epi32(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(kseq + i)));
    const __mmask16 klt31 = _mm512_cmplt_epu32_mask(kv, v31);
    const __m512i q = _mm512_maskz_srlv_epi32(klt31, uv, kv);
    const __m512i k1 = _mm512_add_epi32(kv, one32);
    const __m512i qa = _mm512_cvtepu32_epi64(_mm512_castsi512_si256(q));
    const __m512i qb = _mm512_cvtepu32_epi64(_mm512_extracti64x4_epi64(q, 1));
    const __m512i ka = _mm512_cvtepu32_epi64(_mm512_castsi512_si256(k1));
    const __m512i kb = _mm512_cvtepu32_epi64(_mm512_extracti64x4_epi64(k1, 1));
    const __m512i rice_a = _mm512_add_epi64(qa, ka);
    const __m512i rice_b = _mm512_add_epi64(qb, kb);
    rice_acc = _mm512_add_epi64(rice_acc, _mm512_add_epi64(rice_a, rice_b));

    const __mmask16 uz = _mm512_cmpeq_epu32_mask(uv, zero);
    const __mmask16 usmall = _mm512_cmple_epu32_mask(uv, four32);
    __m512i bin_a = _mm512_add_epi64(rice_a, two64);
    __m512i bin_b = _mm512_add_epi64(rice_b, two64);
    bin_a = _mm512_mask_mov_epi64(bin_a, static_cast<__mmask8>(usmall), three64);
    bin_b = _mm512_mask_mov_epi64(bin_b, static_cast<__mmask8>(usmall >> 8), three64);
    bin_a = _mm512_mask_mov_epi64(bin_a, static_cast<__mmask8>(uz), two64);
    bin_b = _mm512_mask_mov_epi64(bin_b, static_cast<__mmask8>(uz >> 8), two64);
    bin_acc = _mm512_add_epi64(bin_acc, _mm512_add_epi64(bin_a, bin_b));

    const __m512i esc_shift =
        _mm512_min_epu32(_mm512_add_epi32(kv, three32), v24);
    const __m512i thr = _mm512_sllv_epi32(one32, esc_shift);
    const __mmask16 esc = _mm512_cmpgt_epu32_mask(uv, thr);
    const __mmask16 ncov = _mm512_cmpeq_epu32_mask(
        _mm512_cvtepu8_epi32(
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(covered + i))),
        zero);
    __m512i zr_a = _mm512_add_epi64(rice_a, two64);
    __m512i zr_b = _mm512_add_epi64(rice_b, two64);
    zr_a = _mm512_mask_mov_epi64(zr_a, static_cast<__mmask8>(esc), v34_64);
    zr_b = _mm512_mask_mov_epi64(zr_b, static_cast<__mmask8>(esc >> 8), v34_64);
    zr_a = _mm512_maskz_mov_epi64(static_cast<__mmask8>(ncov), zr_a);
    zr_b = _mm512_maskz_mov_epi64(static_cast<__mmask8>(ncov >> 8), zr_b);
    zr_acc = _mm512_add_epi64(zr_acc, _mm512_add_epi64(zr_a, zr_b));
  }
  mc.rice += static_cast<uint64_t>(_mm512_reduce_add_epi64(rice_acc));
  mc.bin += static_cast<uint64_t>(_mm512_reduce_add_epi64(bin_acc));
  mc.zr_esc += static_cast<uint64_t>(_mm512_reduce_add_epi64(zr_acc));
#endif
  for (; i < hi; ++i) {
    const uint32_t uu = u[i];
    const uint32_t k = kseq[i];
    const uint32_t q = (k >= 31u) ? 0u : (uu >> k);
    const uint64_t rice_per = static_cast<uint64_t>(q) + 1 + k;
    mc.rice += rice_per;
    mc.bin += (uu == 0) ? 2 : ((uu <= 4) ? 3 : 2 + rice_per);
    if (!covered[i]) {
      const uint32_t esc_shift = (k + 3u > 24u) ? 24u : k + 3u;
      mc.zr_esc += 2 + ((uu > (1u << esc_shift)) ? 32 : rice_per);
    }
  }
}

// Exact lower bound on a candidate's best-mode bit cost, computable
// without the serial adaptation pass (the modes and their exact costs
// are the reference's: block/encoder.cpp:201-263; selection + ties
// encoder.cpp:352-407 — the bound only SKIPS work, never changes the
// selected winner). Per sample with u = zigzag(res):
//   u == 0  -> 0   (zero-run coverage can make zeros nearly free)
//   u == 1  -> 2   (rice floor: min_k (u>>k)+1+k = 1 + bitwidth(u))
//   u <= 4  -> 3   (bin mode pays a flat 3 for 0 < u <= 4)
//   else    -> 1 + min(bitwidth(u), 31)   (k >= 31 forces q = 0: cost 32)
// Every mode's true per-sample cost is >= this (rice/static/bin/zero-run,
// incl. run tokens and escapes), so sum(lb) <= min over modes of the
// exact cost that score_candidate would compute.
constexpr uint32_t kScoreChunk = 2048;  // early-abort granularity

// `chunk_lb`, when non-null, receives the bound per kScoreChunk-sample
// chunk ((n + kScoreChunk - 1) / kScoreChunk entries) for the scoring
// early-abort's remaining-cost suffix bounds.
inline uint64_t residual_cost_lb(const int32_t* res, uint32_t n,
                                 uint64_t* chunk_lb = nullptr) {
  uint64_t total = 0;
  for (uint32_t c0 = 0; c0 < n; c0 += kScoreChunk) {
    const uint32_t c1 = c0 + kScoreChunk < n ? c0 + kScoreChunk : n;
    uint64_t sub = 0;
    uint32_t i = c0;
#if defined(LAC_SIMD_LPC) && defined(__AVX512CD__)
    __m512i acc = _mm512_setzero_si512();
    const __m512i one = _mm512_set1_epi32(1);
    const __m512i three = _mm512_set1_epi32(3);
    const __m512i four = _mm512_set1_epi32(4);
    const __m512i v31 = _mm512_set1_epi32(31);
    const __m512i v32 = _mm512_set1_epi32(32);
    for (; i + 16 <= c1; i += 16) {
      const __m512i v = _mm512_loadu_si512(res + i);
      const __m512i u =
          _mm512_xor_si512(_mm512_slli_epi32(v, 1), _mm512_srai_epi32(v, 31));
      const __mmask16 nz = _mm512_test_epi32_mask(u, u);
      const __m512i bw = _mm512_sub_epi32(v32, _mm512_lzcnt_epi32(u));
      __m512i per = _mm512_add_epi32(_mm512_min_epu32(bw, v31), one);
      const __mmask16 small = _mm512_cmple_epu32_mask(u, four);
      per = _mm512_mask_min_epu32(per, small, per, three);
      per = _mm512_maskz_mov_epi32(nz, per);
      acc = _mm512_add_epi64(
          acc, _mm512_add_epi64(
                   _mm512_cvtepu32_epi64(_mm512_castsi512_si256(per)),
                   _mm512_cvtepu32_epi64(_mm512_extracti64x4_epi64(per, 1))));
    }
    sub += static_cast<uint64_t>(_mm512_reduce_add_epi64(acc));
#endif
    for (; i < c1; ++i) {
      const uint32_t u = zigzag_u(res[i]);
      if (u == 0) continue;
      const uint32_t bw = 32u - static_cast<uint32_t>(__builtin_clz(u));
      uint32_t per = 1u + (bw > 31u ? 31u : bw);
      if (u <= 4u && per > 3u) per = 3u;
      sub += per;
    }
    if (chunk_lb) chunk_lb[c0 / kScoreChunk] = sub;
    total += sub;
  }
  return total;
}

// Exact vectorized stateless k sequence over one partition. The
// stateless adapter is memoryless — kseq[i] is a pure function of the
// prefix sum and the count:
//   kseq[s0] = init_k
//   kseq[i]  = k_from_mean(floor((S[i] - S[s0] + ((i-s0) >> 1)) / (i-s0)))
// (S = exclusive prefix sums of u). The f64 division is within one
// integer of the exact floor (operands < 2^53), fixed up with one
// multiply-compare in each direction, so the result is bit-exact.
void stateless_kseq(const uint64_t* S, uint32_t s0, uint32_t e0,
                    uint32_t init_k, uint8_t* kseq) {
  kseq[s0] = static_cast<uint8_t>(init_k);
  uint32_t i = s0 + 1;
#if defined(LAC_SIMD_LPC) && defined(__AVX512CD__)
  const __m512i base = _mm512_set1_epi64(static_cast<long long>(S[s0]));
  const __m512i one = _mm512_set1_epi64(1);
  const __m512i v31 = _mm512_set1_epi64(31);
  const __m512i v64 = _mm512_set1_epi64(64);
  __m512i cnt = _mm512_set_epi64(8, 7, 6, 5, 4, 3, 2, 1);
  for (; i + 8 <= e0; i += 8) {
    const __m512i Sv = _mm512_loadu_si512(S + i);
    const __m512i sum = _mm512_sub_epi64(Sv, base);
    const __m512i num = _mm512_add_epi64(sum, _mm512_srli_epi64(cnt, 1));
    __m512i q = _mm512_cvttpd_epu64(
        _mm512_div_pd(_mm512_cvtepu64_pd(num), _mm512_cvtepu64_pd(cnt)));
    const __mmask8 over =
        _mm512_cmpgt_epu64_mask(_mm512_mullo_epi64(q, cnt), num);
    q = _mm512_mask_sub_epi64(q, over, q, one);
    const __mmask8 under = _mm512_cmple_epu64_mask(
        _mm512_mullo_epi64(_mm512_add_epi64(q, one), cnt), num);
    q = _mm512_mask_add_epi64(q, under, q, one);
    // k = mean <= 1 ? 0 : min(31, bitwidth(mean - 1))
    const __m512i bw =
        _mm512_sub_epi64(v64, _mm512_lzcnt_epi64(_mm512_sub_epi64(q, one)));
    __m512i k = _mm512_min_epu64(bw, v31);
    k = _mm512_maskz_mov_epi64(_mm512_cmpgt_epu64_mask(q, one), k);
    _mm_storel_epi64(reinterpret_cast<__m128i*>(kseq + i),
                     _mm512_cvtepi64_epi8(k));
    cnt = _mm512_add_epi64(cnt, _mm512_set1_epi64(8));
  }
#endif
  for (; i < e0; ++i) {
    const uint64_t cntx = i - s0;
    const uint64_t num = (S[i] - S[s0]) + (cntx >> 1);
    kseq[i] = static_cast<uint8_t>(k_from_mean(num / cntx));
  }
}

// per-lane scratch shared across candidates (sized once per worker)
struct PlanScratch {
  std::vector<int32_t> res, win, last_nz, next_nz;
  std::vector<uint32_t> u, uwin, runlen;
  std::vector<uint8_t> kseq, covered;
  std::vector<uint64_t> psum;  // (n + 1) x 16, i-major
  std::vector<uint64_t> su;    // (n + 1) contiguous prefix sums of uwin
  std::vector<uint64_t> lbpre; // (n + 1) prefix of the winner's per-sample bound
  std::vector<uint64_t> lbc;   // per-candidate per-chunk lower bounds
  explicit PlanScratch(uint32_t n)
      : res(n), win(n), last_nz(n), next_nz(n), u(n), uwin(n), runlen(n),
        kseq(n), covered(n), psum((static_cast<size_t>(n) + 1) * 16),
        su(static_cast<size_t>(n) + 1), lbpre(static_cast<size_t>(n) + 1),
        lbc(static_cast<size_t>(kNumCand) * ((n + kScoreChunk - 1) / kScoreChunk)) {}
};

// One full-block scoring pass: initial/static k sweeps (SIMD), the
// serial stateful-k recurrence recording the per-sample k sequence and
// zero-run coverage, then the vectorized per-sample mode costs — chunked
// so a candidate provably unable to beat `abort_key` stops early.
// `chunk_lb` are residual_cost_lb's per-kScoreChunk bounds; the final
// bit cost is >= min(static_bits, min-mode partial + remaining bound),
// so once that floor exceeds abort_key/4 the candidate can never be
// selected and the rest of the serial pass is skipped. Returns false on
// abort (s is then incomplete and must not be used).
bool score_candidate(const int32_t* res, uint32_t n, CandScore& s, PlanScratch& scr,
                     const uint64_t* chunk_lb = nullptr, uint64_t abort_bits = ~0ULL) {
  uint32_t* u = scr.u.data();
  uint8_t* kseq = scr.kseq.data();
  uint8_t* covered = scr.covered.data();
  uint32_t* runlen = scr.runlen.data();
  zigzag_fill(res, n, u);

  const uint32_t scan = n < kInitialScan ? n : kInitialScan;
  uint64_t sums[16] = {0};
  ksweep16(u, 0, scan, sums);
  uint64_t best = ~0ULL;
  for (uint32_t k = 0; k <= kInitialMaxK; ++k) {
    const uint64_t c = sums[k] + static_cast<uint64_t>(1 + k) * scan;
    if (c < best) { best = c; s.initial_k = k; }
  }
  ksweep16(u, scan, n, sums);  // sums are now full-block totals
  best = ~0ULL;
  for (uint32_t k = 0; k <= kMaxStaticK; ++k) {
    const uint64_t c = sums[k] + static_cast<uint64_t>(1 + k) * n;
    if (c < best) { best = c; s.static_k = k; }
  }
  s.static_bits = best;
  const bool may_abort =
      chunk_lb != nullptr && s.static_bits >= abort_bits;  // static alone can't win

  // backward pass: maximal-run length at each zero sample
  uint32_t run = 0;
  for (uint32_t i = n; i-- > 0;) {
    run = res[i] == 0 ? run + 1 : 0;
    runlen[i] = run;
  }
  // suffix bounds on the not-yet-scored remainder
  const uint32_t nchunks = (n + kScoreChunk - 1) / kScoreChunk;
  uint64_t lb_rem = 0;
  if (may_abort)
    for (uint32_t t = 0; t < nchunks; ++t) lb_rem += chunk_lb[t];

  // serial adaptation pass: k sequence + run tokens/coverage only
  AdaptK st;
  uint64_t sum = 0;
  uint32_t k = s.initial_k;
  bool in_long_run = false;  // current sample covered by a run token
  ModeCosts mc;
  for (uint32_t c0 = 0; c0 < n; c0 += kScoreChunk) {
    const uint32_t c1 = c0 + kScoreChunk < n ? c0 + kScoreChunk : n;
    for (uint32_t i = c0; i < c1; ++i) {
      kseq[i] = static_cast<uint8_t>(k);
      uint8_t cov = 0;
      if (res[i] == 0) {
        if (i == 0 || res[i - 1] != 0) {  // run start: runlen[i] is the full length
          in_long_run = runlen[i] >= kZrMinRun;
          if (in_long_run) {
            s.zr_bits += 2 + ((runlen[i] - kZrMinRun) >> kZrLenK) + 1 + kZrLenK;
            s.has_run = true;
          }
        }
        cov = in_long_run;
      } else {
        in_long_run = false;
      }
      covered[i] = cov;
      sum += u[i];
      k = adapt_stateful(st, sum, i + 1);
    }
    cost_pass(u, kseq, covered, c0, c1, mc);
    if (may_abort && c1 < n) {
      lb_rem -= chunk_lb[c0 / kScoreChunk];
      uint64_t part = mc.rice;  // min over modes of the scored prefix
      if (mc.bin < part) part = mc.bin;
      const uint64_t zr_part = s.zr_bits + mc.zr_esc;
      if (zr_part < part) part = zr_part;
      if (part + lb_rem >= abort_bits) return false;
    }
  }
  s.rice_bits = mc.rice;
  s.bin_bits = mc.bin;
  s.zr_bits += mc.zr_esc;
  return true;
}

}  // namespace

// plan a batch of equal-length channel blocks -> compact meta rows
// (sel_idx, best_p, in_range, modes[max_parts], ks[max_parts]) matching
// encoder.plan_group(emit_fields=False). Returns 0.
int lac_plan_blocks(const int32_t* pcm,      // (B, n)
                    uint32_t B,
                    uint32_t n,
                    const int16_t* lpc_coeffs,  // (5, B, 13) Q15, index 0 unused
                    const uint8_t* lpc_valid,   // (5, B)
                    uint32_t zero_run_enabled,
                    uint32_t partitioning_enabled,
                    int8_t* out_meta,        // (B, 3 + 2*max_parts)
                    int32_t num_threads) {
  const uint32_t max_p =
      (partitioning_enabled && n >= kMinPartition) ? max_part_order(n) : 0;
  const uint32_t max_parts = 1u << max_p;
  const uint64_t meta_stride = 3 + 2 * static_cast<uint64_t>(max_parts);
  std::atomic<uint32_t> next{0};

  auto worker = [&]() {
    tc_note();
    PlanScratch scr(n);
    int32_t* const res = scr.res.data();
    int32_t* const win = scr.win.data();
    int32_t* const last_nz = scr.last_nz.data();
    int32_t* const next_nz = scr.next_nz.data();
    uint32_t* const uwin = scr.uwin.data();
    uint8_t* const kseq = scr.kseq.data();
    uint8_t* const covered = scr.covered.data();
    uint64_t* const psum = scr.psum.data();
    while (true) {
      const uint32_t b = next.fetch_add(1, std::memory_order_relaxed);
      if (b >= B) return;
      const int32_t* x = pcm + static_cast<uint64_t>(b) * n;

      CandScore sc[kNumCand];
      bool in_range = true;

      // phase 1: residual validity + exact lower bounds for every
      // candidate (one SIMD pass each, no serial adaptation)
      auto make_residual = [&](uint32_t c, int32_t* dst) -> int {
        if (c < kLpcBase) {
          compute_residual(x, n, kCandPtype[c], c < kNumFixed ? c : 2,
                           nullptr, dst);
          return 1;
        }
        const uint32_t li = c - kLpcBase;
        if (!lpc_valid[li * B + b]) return 0;
        const int16_t* co = lpc_coeffs + (static_cast<uint64_t>(li) * B + b) * 13;
        return lpc_residual_checked(x, n, co, 12, dst) ? 1 : -1;
      };
      const uint32_t nchunks = (n + kScoreChunk - 1) / kScoreChunk;
      uint64_t lb[kNumCand];
      uint8_t usable[kNumCand];
      for (uint32_t c = 0; c < kNumCand; ++c) {
        const int st_r = make_residual(c, res);
        usable[c] = st_r == 1;
        if (st_r == -1) in_range = false;
        lb[c] = usable[c]
                    ? residual_cost_lb(res, n, scr.lbc.data() + c * nchunks)
                    : ~0ULL;
      }
      // bound-ascending order (stable in c)
      uint32_t order[kNumCand];
      for (uint32_t c = 0; c < kNumCand; ++c) order[c] = c;
      for (uint32_t a = 1; a < kNumCand; ++a) {
        const uint32_t v = order[a];
        uint32_t j = a;
        for (; j > 0 && (lb[order[j - 1]] > lb[v] ||
                         (lb[order[j - 1]] == lb[v] && order[j - 1] > v)); --j)
          order[j] = order[j - 1];
        order[j] = v;
      }

      // phase 2: full scoring, cheapest bound first, branch-and-bound.
      // A candidate whose bound alone exceeds the best key can never
      // win (key = bits*4 + ptype >= bits*4 >= lb*4), so the serial
      // adaptation pass is skipped for it. Ties keep the smallest
      // candidate index, exactly as the plain ascending loop selects.
      uint64_t best_key = ~0ULL;
      uint32_t sel = 0;
      for (uint32_t ci = 0; ci < kNumCand; ++ci) {
        const uint32_t c = order[ci];
        if (!usable[c]) break;  // unusable sort last (lb = ~0)
        if (lb[c] * 4 > best_key) break;
        make_residual(c, res);
        // a candidate needs bits <= best_key / 4 to win (even on ties)
        const uint64_t abort_bits =
            best_key == ~0ULL ? ~0ULL : best_key / 4 + 1;
        if (!score_candidate(res, n, sc[c], scr,
                             scr.lbc.data() + c * nchunks, abort_bits)) {
          sc[c] = CandScore();  // aborted: partial fields are meaningless
          continue;
        }
        const uint64_t zr_eff =
            (zero_run_enabled && sc[c].has_run) ? sc[c].zr_bits : sc[c].rice_bits;
        uint64_t bits = sc[c].rice_bits;
        if (sc[c].static_bits < bits) bits = sc[c].static_bits;
        if (zr_eff < bits) bits = zr_eff;
        if (sc[c].bin_bits < bits) bits = sc[c].bin_bits;
        const uint64_t key = bits * 4 + kCandPtype[c];
        if (key < best_key || (key == best_key && c < sel)) {
          best_key = key;
          sel = c;
        }
      }

      int8_t* meta = out_meta + b * meta_stride;
      std::memset(meta, 0, meta_stride);
      // !in_range lanes still get a full plan (the host ladder replans
      // them; plan_group fills their meta the same way)
      meta[2] = in_range ? 1 : 0;
      meta[0] = static_cast<int8_t>(sel);

      // winner residual + whole-block (p = 0) mode choice
      if (sel < kLpcBase) {
        compute_residual(x, n, kCandPtype[sel], sel < kNumFixed ? sel : 2,
                         nullptr, win);
      } else {
        const uint32_t li = sel - kLpcBase;
        lpc_residual_checked(x, n, lpc_coeffs + (static_cast<uint64_t>(li) * B + b) * 13,
                             12, win);
      }
      const CandScore& ws = sc[sel];
      const bool allow_zr = zero_run_enabled && ws.has_run;
      uint64_t best = ws.rice_bits;
      uint32_t base_mode = 0;
      if (allow_zr && ws.zr_bits <= best) { best = ws.zr_bits; base_mode = 1; }
      if (ws.bin_bits < best) { best = ws.bin_bits; base_mode = 2; }
      uint32_t base_k = ws.initial_k;
      if (ws.static_bits < best) { best = ws.static_bits; base_mode = 3; base_k = ws.static_k; }
      meta[3] = static_cast<int8_t>(base_mode);
      meta[3 + max_parts] = static_cast<int8_t>(base_k);
      uint64_t best_total = pad8(best + 8 + 7);
      uint32_t best_p = 0;
      if (max_p == 0) continue;

      // winner precomputations shared by every sweep stage
      zigzag_fill(win, n, uwin);
      psum_build(uwin, n, psum);
      uint64_t* const su = scr.su.data();
      for (uint32_t i = 0; i <= n; ++i) su[i] = psum[static_cast<size_t>(i) * 16];
      // prefix of the winner's per-sample lower bound (residual_cost_lb
      // semantics), for sweep-stage early aborts
      uint64_t* const lbpre = scr.lbpre.data();
      lbpre[0] = 0;
      for (uint32_t i = 0; i < n; ++i) {
        const uint32_t uu = uwin[i];
        uint32_t per = 0;
        if (uu != 0) {
          const uint32_t bw = 32u - static_cast<uint32_t>(__builtin_clz(uu));
          per = 1u + (bw > 31u ? 31u : bw);
          if (uu <= 4u && per > 3u) per = 3u;
        }
        lbpre[i + 1] = lbpre[i] + per;
      }
      {
        int32_t last = -static_cast<int32_t>(n) - 2;
        for (uint32_t i = 0; i < n; ++i) {
          if (win[i] != 0) last = static_cast<int32_t>(i);
          last_nz[i] = last;
        }
        int32_t nxt = static_cast<int32_t>(n) + 2;
        for (uint32_t i = n; i-- > 0;) {
          if (win[i] != 0) nxt = static_cast<int32_t>(i);
          next_nz[i] = nxt;
        }
      }

      uint8_t modes_s[1u << kMaxPartOrder], ks_s[1u << kMaxPartOrder];
      for (uint32_t p = 1; p <= max_p; ++p) {
        const uint32_t base_sz = n >> p;
        const uint32_t nparts = 1u << p;
        uint64_t total_bits = 0;
        // Every accept clause needs total <= best_total (+ the 5% margin
        // only while best_p == 0), and partitions not yet costed are
        // bounded below by the lbpre prefix — abandon the stage as soon
        // as even that floor cannot be accepted.
        const uint64_t accept_cap =
            best_total + (best_p == 0 ? best_total / kMarginDiv : 0);
        const uint64_t stage_hdr = 8 + 7ull * nparts;
        bool abandoned = false;
        for (uint32_t pi = 0; pi < nparts; ++pi) {
          const uint32_t s0 = pi * base_sz;
          if (total_bits + (lbpre[n] - lbpre[s0]) + stage_hdr > accept_cap) {
            abandoned = true;
            break;
          }
          const uint32_t e0 = (pi + 1 == nparts) ? n : s0 + base_sz;
          const uint32_t len = e0 - s0;
          // head/static k from the prefix-sum rows
          const uint32_t hs = len < kInitialScan ? len : kInitialScan;
          const uint64_t* row_s0 = psum + static_cast<size_t>(s0) * 16;
          const uint64_t* row_hs = psum + static_cast<size_t>(s0 + hs) * 16;
          const uint64_t* row_e0 = psum + static_cast<size_t>(e0) * 16;
          uint64_t bestc = ~0ULL;
          uint32_t init_k = 0;
          for (uint32_t k = 0; k <= kInitialMaxK; ++k) {
            const uint64_t c = row_hs[k] - row_s0[k] + static_cast<uint64_t>(1 + k) * hs;
            if (c < bestc) { bestc = c; init_k = k; }
          }
          bestc = ~0ULL;
          uint32_t static_k = 0;
          for (uint32_t k = 0; k <= kMaxStaticK; ++k) {
            const uint64_t c = row_e0[k] - row_s0[k] + static_cast<uint64_t>(1 + k) * len;
            if (c < bestc) { bestc = c; static_k = k; }
          }
          const uint64_t static_bits = bestc;

          // stateless k is memoryless: the whole sequence vectorizes
          // exactly; the partition-clamped run geometry is per-sample
          // independent too (last_nz/next_nz), so no serial recurrence
          stateless_kseq(su, s0, e0, init_k, kseq);
          uint64_t zr_tok = 0;
          bool has_run = false;
          for (uint32_t i = s0; i < e0; ++i) {
            uint8_t cov = 0;
            if (win[i] == 0) {
              const uint32_t run_first =
                  static_cast<uint32_t>(std::max(last_nz[i] + 1, static_cast<int32_t>(s0)));
              const uint32_t next_break = static_cast<uint32_t>(
                  std::min(next_nz[i], static_cast<int32_t>(e0)));
              const uint32_t rl = next_break - run_first;
              if (rl >= kZrMinRun) {
                cov = 1;
                if (i == run_first) {
                  zr_tok += 2 + ((rl - kZrMinRun) >> kZrLenK) + 1 + kZrLenK;
                  has_run = true;
                }
              }
            }
            covered[i] = cov;
          }
          ModeCosts mc;
          cost_pass(uwin, kseq, covered, s0, e0, mc);
          const uint64_t rice_b = mc.rice;
          const uint64_t bin_b = mc.bin;
          const uint64_t zr_b = zr_tok + mc.zr_esc;

          uint64_t bits = rice_b;
          uint32_t mode = 0, ksel = init_k;
          if (zero_run_enabled && has_run && zr_b < bits) { bits = zr_b; mode = 1; }
          if (bin_b < bits) { bits = bin_b; mode = 2; }
          if (static_bits < bits || static_bits <= bits + bits / kMarginDiv) {
            bits = static_bits; mode = 3; ksel = static_k;
          }
          modes_s[pi] = static_cast<uint8_t>(mode);
          ks_s[pi] = static_cast<uint8_t>(ksel);
          total_bits += bits;
        }
        if (abandoned) continue;  // provably not acceptable; best_* unchanged
        const uint64_t total = pad8(total_bits + 8 + 7ull * nparts);
        const uint64_t margin = best_total / kMarginDiv;
        const bool accept = (total < best_total) ||
                            (total <= best_total + margin && best_p == 0) ||
                            (total == best_total && p < best_p);
        if (accept) {
          best_total = total;
          best_p = p;
          std::memset(meta + 3, 0, 2 * max_parts);
          for (uint32_t pi = 0; pi < nparts; ++pi) {
            meta[3 + pi] = static_cast<int8_t>(modes_s[pi]);
            meta[3 + max_parts + pi] = static_cast<int8_t>(ks_s[pi]);
          }
        }
      }
      meta[1] = static_cast<int8_t>(best_p);
    }
  };

  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  if (num_threads > 0 && static_cast<unsigned>(num_threads) < hw) hw = static_cast<unsigned>(num_threads);
  if (hw > B) hw = B;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(hw);
    for (unsigned i = 0; i < hw; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return 0;
}

// exact int64 autocorrelation lags 0..max_order per lane:
// out[b, k] = sum_i x[b, i] * x[b, i-k]  (reference lpc.cpp:80-96; the
// numpy twin is ops/lpc.py autocorrelation — exact for n <= 2^17 at
// 24-bit inputs). AVX-512 8-wide int64 MACs with a scalar tail.
// gcc's _mm512_undefined_epi32 trips -Wmaybe-uninitialized when the cvt
// intrinsics inline into std::thread invokers (gcc PR105593 family);
// silence that one false positive here.
#pragma GCC diagnostic push
#pragma GCC diagnostic ignored "-Wmaybe-uninitialized"
int lac_autocorr(const int32_t* pcm,  // (B, n)
                 uint32_t B,
                 uint32_t n,
                 uint32_t max_order,
                 int64_t* out,  // (B, max_order + 1)
                 int32_t num_threads) {
  const uint32_t no = max_order + 1;
  std::atomic<uint32_t> next{0};
  auto worker = [&]() {
    tc_note();
    while (true) {
      const uint32_t b = next.fetch_add(1, std::memory_order_relaxed);
      if (b >= B) return;
      const int32_t* x = pcm + static_cast<uint64_t>(b) * n;
      int64_t* o = out + static_cast<uint64_t>(b) * no;
      for (uint32_t k = 0; k < no; ++k) {
        // accumulate in uint64: out-of-domain int32 inputs (the ladder
        // tests drive full ±2^31 samples) can overflow the int64 sum,
        // which is UB signed but defined two's-complement wraparound
        // unsigned — bit-identical to the numpy twin's int64 wrap and
        // to the SIMD lane adds below
        uint64_t acc = 0;
        uint32_t i = k;
        if (k >= n) { o[k] = 0; continue; }
#if defined(LAC_SIMD_LPC)
        __m512i vacc = _mm512_setzero_si512();
        for (; i + 8 <= n; i += 8) {
          const __m512i a = _mm512_cvtepi32_epi64(
              _mm256_loadu_si256(reinterpret_cast<const __m256i*>(x + i)));
          const __m512i c = _mm512_cvtepi32_epi64(
              _mm256_loadu_si256(reinterpret_cast<const __m256i*>(x + i - k)));
          vacc = _mm512_add_epi64(vacc, _mm512_mullo_epi64(a, c));
        }
        alignas(64) int64_t lanes[8];
        _mm512_storeu_si512(lanes, vacc);
        for (int l = 0; l < 8; ++l) acc += static_cast<uint64_t>(lanes[l]);
#endif
        for (; i < n; ++i)
          acc += static_cast<uint64_t>(static_cast<int64_t>(x[i]) * x[i - k]);
        o[k] = static_cast<int64_t>(acc);
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  if (num_threads > 0 && static_cast<unsigned>(num_threads) < hw)
    hw = static_cast<unsigned>(num_threads);
  if (hw > B) hw = B;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(hw);
    for (unsigned i = 0; i < hw; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return 0;
}
#pragma GCC diagnostic pop

// ------------------------------------------------------- stereo estimate

namespace {

// zigzag magnitude of a difference (lac/encoder.cpp:38-41): 2|v|-(v<0)
inline uint64_t zz_mag(int64_t v) {
  return v >= 0 ? static_cast<uint64_t>(2 * v) : static_cast<uint64_t>(-2 * v - 1);
}

// approximate_rice_bits (lac/encoder.cpp:53-57)
inline int64_t approx_rice_bits(int64_t total, int64_t count) {
  if (count <= 0) return 0;
  const int64_t mean = (total + (count >> 1)) / count;
  uint32_t k = 0;
  if (mean > 1) {
    k = bitwidth64(static_cast<uint64_t>(mean - 1));
    if (k > 31u) k = 31u;
  }
  return (total >> k) + count * (k + 1);
}

}  // namespace

// per-block stereo proxy decision for full-valid lanes
// (ops/stereo.estimate_stereo_mode, lac/encoder.cpp:126-197): one
// cache-friendly pass accumulates all 12 channel sums per block.
void lac_stereo_estimate(const int32_t* left,   // (B, n)
                         const int32_t* right,  // (B, n)
                         uint32_t B,
                         uint32_t n,
                         uint8_t* out_choose_ms,
                         uint8_t* out_uncertain,
                         int32_t num_threads) {
  std::atomic<uint32_t> next{0};
  auto worker = [&]() {
    tc_note();
    while (true) {
      const uint32_t b = next.fetch_add(1, std::memory_order_relaxed);
      if (b >= B) return;
      const int32_t* l = left + static_cast<uint64_t>(b) * n;
      const int32_t* r = right + static_cast<uint64_t>(b) * n;
      // sums[ch][0..2] = raw / first-difference / first-anti-difference
      int64_t sums[4][3] = {};
      int32_t prev[4] = {0, 0, 0, 0};
      for (uint32_t i = 0; i < n; ++i) {
        const int32_t ch[4] = {
            l[i], r[i],
            static_cast<int32_t>((l[i] + r[i]) >> 1),
            static_cast<int32_t>(l[i] - r[i]),
        };
        for (int c = 0; c < 4; ++c) {
          const int64_t v = ch[c];
          const uint64_t raw = zz_mag(v);
          sums[c][0] += raw;
          if (i == 0) {
            sums[c][1] += raw;
            sums[c][2] += raw;
          } else {
            sums[c][1] += zz_mag(v - prev[c]);
            sums[c][2] += zz_mag(v + prev[c]);
          }
          prev[c] = ch[c];
        }
      }
      int64_t bits[4];
      bool non_diff_any = false;
      for (int c = 0; c < 4; ++c) {
        const int64_t rb = approx_rice_bits(sums[c][0], n);
        const int64_t db = approx_rice_bits(sums[c][1], n);
        const int64_t ab = approx_rice_bits(sums[c][2], n);
        bits[c] = std::min(std::min(rb, db), ab);
        non_diff_any |= (rb < db) || (ab < db);
      }
      const int64_t lr_bits = bits[0] + bits[1];
      const int64_t ms_bits = bits[2] + bits[3];
      const int64_t smaller = std::min(lr_bits, ms_bits);
      const int64_t difference = lr_bits >= ms_bits ? lr_bits - ms_bits : ms_bits - lr_bits;
      out_choose_ms[b] = ms_bits < lr_bits ? 1 : 0;
      out_uncertain[b] =
          (smaller == 0 || difference == 0 || non_diff_any ||
           difference <= smaller / 100)
              ? 1
              : 0;
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  if (num_threads > 0 && static_cast<unsigned>(num_threads) < hw) hw = static_cast<unsigned>(num_threads);
  if (hw > B) hw = B;
  if (hw <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(hw);
    for (unsigned i = 0; i < hw; ++i) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
}

// ------------------------------------------------------ multi-stream pack

namespace {

inline uint64_t stream_bits_u32(const uint32_t* unary, const uint8_t* field_len, uint64_t count) {
  uint64_t total = 0;
  for (uint64_t i = 0; i < count; ++i) total += static_cast<uint64_t>(unary[i]) + field_len[i];
  return total;
}

inline void pack_one_u32(const uint32_t* unary, const uint32_t* field_val,
                         const uint8_t* field_len, uint64_t count, uint8_t* out) {
  uint64_t acc = 0;
  int nacc = 0;
  uint64_t nout = 0;
  auto flush = [&]() {
    while (nacc >= 8) {
      nacc -= 8;
      out[nout++] = static_cast<uint8_t>((acc >> nacc) & 0xFFu);
    }
    acc &= (nacc == 0) ? 0 : ((1ULL << nacc) - 1);
  };
  for (uint64_t i = 0; i < count; ++i) {
    uint64_t ones = unary[i];
    while (ones > 0) {
      const int chunk = ones > 32 ? 32 : static_cast<int>(ones);
      acc = (acc << chunk) | ((1ULL << chunk) - 1);
      nacc += chunk;
      ones -= static_cast<uint64_t>(chunk);
      flush();
    }
    const int fl = field_len[i];
    if (fl > 0) {
      acc = (acc << fl) | (field_val[i] & ((fl >= 32) ? 0xFFFFFFFFULL : ((1ULL << fl) - 1)));
      nacc += fl;
      flush();
    }
  }
  if (nacc > 0) out[nout++] = static_cast<uint8_t>((acc << (8 - nacc)) & 0xFFu);
}

}  // namespace

// per-stream packed byte sizes for a batch of element streams
void lac_pack_streams_sizes(const uint32_t* unary,
                            const uint8_t* field_len,
                            const uint64_t* elem_offsets,  // (S+1)
                            uint32_t stream_count,
                            uint64_t* out_sizes) {
  for (uint32_t s = 0; s < stream_count; ++s) {
    const uint64_t lo = elem_offsets[s], hi = elem_offsets[s + 1];
    const uint64_t bits = stream_bits_u32(unary + lo, field_len + lo, hi - lo);
    out_sizes[s] = (bits + 7) / 8;
  }
}

// pack a batch of element streams in parallel (one thread per stream
// slice); out_offsets are byte offsets per stream into `out`.
void lac_pack_streams(const uint32_t* unary,
                      const uint32_t* field_val,
                      const uint8_t* field_len,
                      const uint64_t* elem_offsets,
                      uint32_t stream_count,
                      uint8_t* out,
                      const uint64_t* out_offsets,
                      int32_t num_threads) {
  std::atomic<uint32_t> next{0};
  auto worker = [&]() {
    tc_note();
    while (true) {
      const uint32_t s = next.fetch_add(1, std::memory_order_relaxed);
      if (s >= stream_count) return;
      const uint64_t lo = elem_offsets[s];
      pack_one_u32(unary + lo, field_val + lo, field_len + lo,
                   elem_offsets[s + 1] - lo, out + out_offsets[s]);
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 1;
  if (num_threads > 0 && static_cast<unsigned>(num_threads) < hw) hw = static_cast<unsigned>(num_threads);
  if (hw > stream_count) hw = stream_count;
  if (hw <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(hw);
  for (unsigned i = 0; i < hw; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

// benchmark twin for the device bit-reader prototype
// (ops/device_reader.py): parse `count` static-k Rice tokens per lane
// from raw payload bytes with the product reader. Returns 0, or
// -(lane+1) on a read error.
int lac_tokenize_static_rice(const uint8_t* payloads, uint64_t lane_stride,
                             const uint32_t* ks, const uint64_t* nbits,
                             uint32_t lanes, uint32_t count, int32_t* out) {
  for (uint32_t li = 0; li < lanes; ++li) {
    Reader r;
    reader_init(r, payloads + li * lane_stride, lane_stride);
    r.size_bits = nbits[li];
    const uint32_t k = ks[li];
    int32_t* dst = out + static_cast<uint64_t>(li) * count;
    for (uint32_t t = 0; t < count; ++t) {
      uint32_t u = 0;
      if (!read_rice_u(r, k, u)) return -static_cast<int>(li + 1);
      dst[t] = zigzag_decode(u);
    }
  }
  return 0;
}

}  // extern "C"
