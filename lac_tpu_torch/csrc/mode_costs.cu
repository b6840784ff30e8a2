// Whole-block and per-partition mode-cost sums of the planner.
//
// Replaces XLA code of lac_tpu's plan_group that XLA fuses on the TPU and
// that eager PyTorch runs as dozens of passes over (rows, n) int64
// temporaries (no Pallas kernel there):
//   lac_mode_cost_sums (kernel 9): lac_tpu/encoder.py:113 _mode_cost_fields
//     over ops/runs.py:51 run_geometry of each candidate row, with
//     ops/adapt.py:185 k_used_from_after, summed at encoder.py:217-221;
//   lac_partition_cost_sums (kernel 10): the same fields per partition of
//     every order 1..max_p, the loop at lac_tpu/encoder.py:323 with
//     ops/adapt.py:66 k_after_stateless and the per-part sums (:350-388).
//
// Per sample i of a segment [start, end) (the row for kernel 9, a part for
// kernel 10), with u the u32 zigzag code and k the k it is coded with
// (block/encoder.cpp:201-263):
//   rice  = (k >= 31 ? 0 : u >> k) + 1 + k,
//   |v|   = (u >> 1) + (u & 1) (the residual itself is not read),
//   bin   = |v| == 0 ? 2 : |v| <= 2 ? 3 : 2 + rice,
//   token = 2 + (u > 1 << min(k + 3, 24) ? 32 : rice),
//   zero runs on u == 0: first = max(last_nz + 1, start), len =
//     min(next_nz, end) - first; a run of len >= 4 costs
//     2 + ((len - 4) >> 2) + 3 at its first sample and 0 inside,
//   zr    = the run's cost inside a run of >= 4, token elsewhere,
// summed as u64 (each sum < 2^47), with has_run = any run start.
// Kernel 9 codes sample i with k_after[i - 1] (initial_k at i = 0);
// kernel 10 with the part's initial k at its first sample and, after it,
// the stateless k of the samples before i in the part: with c = i - start
// and S their sum (u64), N = S + (c >> 1); k = 0 if N < 2c, else
// min(31, bit_width(floor(N / c) - 1)), division-free as in
// lac_tpu_torch/csrc/k_after.cu. Kernel 9 and kernel 10's general path
// take the per-sample cost through one device function (add_sample).
//
// Bound on the H100. Kernel 9 reads 16 bytes a sample (codes, k_after and
// the two zero breaks, int32 each) and does about 33 integer instructions
// on them (chip_smoke.py counts them): bound by bytes, 0.22 ms at (2816,
// 16384). Kernel 10 reads 12 bytes a sample once and needs 17 integer
// instructions a sample for each of max_p orders where a part sums below
// 2^31, 31 where it does not (chip_smoke.py's PARTITION_OPS): bound by
// instructions, 0.017-0.023 ms at (256, 16384) over 8 orders against 0.015
// ms of bytes.
//
// Design:
//   * Kernel 9: one block of 256 threads per row for rows of 2048 samples
//     or more, one warp per row (8 rows a block) below. 16-byte loads of
//     the four operands, a lane's four samples in registers; k_after[i - 1]
//     of a lane's first sample comes from the lane before it by a shuffle,
//     and lane 0 of a warp reads it (a one-element halo). Rows that are not
//     16-byte aligned, or whose length is not a multiple of 4, take 4-byte
//     loads. Warp shuffles, then shared memory across the warps of a block.
//   * Kernel 10 has two paths, picked by the C entry from n alone
//     (lac_partition_cost_path says which): rows whose length n is a power
//     of two (the planner's 16384 and 256) take partition_cost_chunks,
//     every other row (1000, 1001, 4113, 12288 ...) partition_cost_rows.
//   * partition_cost_chunks (power-of-two n): each lane owns a chunk of R
//     consecutive samples, R = max(8, n / 1024) (16 at n = 16384: a block of
//     1024 lanes a row; 8 at n = 256: a warp a row, 8 rows a block of 256
//     threads; R = 32 and 4, and 4 or 16 rows a block, measured no better on
//     the H100 with the codes staged in shared memory: PERF.md). Every part
//     of every order holds n >> p >= 32 samples, a power-of-two number of
//     chunks, so a chunk lies inside one part of each order: the part, its
//     bounds, its initial k and the prefix at its start are lane constants,
//     and no sample is tested against a part edge. Once a row: the lane reads
//     its codes (16-byte loads), sums them, and finds its zero runs from a
//     bit mask of its zero samples. Runs inside the chunk are the same at
//     every order: a run of 4 or more adds its cost once, as a lane constant.
//     The runs at the chunk's edges (its first and last zero samples; the
//     whole chunk when it is all zeros) are the only ones a part edge can
//     clip: their ends come from last_nz at the chunk's first sample and
//     next_nz at its last (the only break reads: the breaks must be the
//     codes' own, runs.zero_breaks), and they are clipped once an order, a
//     lane at a time. The lane keeps its R codes in registers, and beside
//     them each sample's order-independent class, a byte each, four to a
//     register: w = bit_width(u - 1) - 3, so that u escapes (u > 2^min(k + 3,
//     24)) iff w > k, with 32 when u > 2^24, -3 for a zero code and 33 for a
//     zero sample of a run the lane constants and the edge clip account for;
//     bin adds 3 + q + k iff 0 <= w <= 32. A block scan of the chunk sums
//     puts each chunk's exclusive u64 prefix in shared memory. Per order a
//     lane then walks its R samples with D = S - ceil(c / 2) in a register (S
//     the part's sum before the sample, c its position in the part; the
//     stateless k is the least k with max(D, 0) < c << k, capped at 31,
//     division-free), 32-bit throughout when every part a warp touches sums
//     below 2^31 (a vote), 64-bit otherwise. The lane's sums go to its part
//     by a segmented reduction: a warp's redux (32-bit) or xor shuffles
//     inside groups of n >> p >> log2(R) lanes; a part inside a warp is
//     stored by its first lane, a part over several warps is added by each
//     warp's first lane (shared-memory u64 atomics). One barrier before the
//     sums leave.
//     Resources: a row's shared memory is 8(L + 2) + 32 x parts bytes (L
//     lanes): 24,528 at n = 16384 and max_p = 8, under the default 48 KB. The
//     H100 has 65,536 registers an SM. ptxas gives both widths 64 registers
//     (<16> spills 52 bytes), so a block of 1024 threads takes a whole SM's
//     registers and runs alone there (32 warps), and n = 256 runs four
//     256-thread blocks an SM (32 warps): the registers set the occupancy,
//     not the shared memory. Two 1024-thread blocks an SM would need 32
//     registers a thread, which a lane's 16 codes and 4 class words nearly
//     fill alone. Staging the codes and classes in shared memory instead (152
//     KB a row at n = 16384) measured on the H100 1-4% slower on
//     chip_smoke.py's adversarial codes and from 1.4% faster to 3.5% slower
//     on audio-like ones (PERF.md).
//   * partition_cost_rows (every other n): one block per lane. The block
//     first stages the row's inclusive u64 prefix sums P in dynamic shared
//     memory ((n + 1) x 8 bytes), from a warp scan over each warp's range
//     and the warp totals; u = P[i + 1] - P[i] and S = P[i] - P[start]
//     then cost two shared-memory loads and a broadcast. Every order walks
//     the row in the same warp ranges, 32 samples a step, coalesced; a part
//     holds at least 32 samples (n >> max_p >= 32), so a step spans at most
//     two parts. Each lane accumulates its samples of the warp's current
//     part; where a step crosses into the next part (a vote tells) the warp
//     reduces (three u64 sums by shuffles, has_run by a vote) and lane 0
//     adds the part's sums into shared-memory accumulators (u64 atomics: a
//     part that spans several warps' ranges gets one add from each). One
//     barrier before the sums leave for device memory. The parts' initial k
//     are staged in shared memory too; the zero breaks are read from device
//     memory at every order.
//   * A tally, where the caller passes one (lac_partition_cost_sums_tally):
//     each block counts the parts whose codes sum to 2^31 or more (on the
//     power-of-two path those a warp sums the 64-bit way; a warp whose other
//     parts sum below it takes that way with them) and the parts it sums,
//     each part once (on the power-of-two path by the lane of its first
//     chunk, from the chunk prefixes, before the orders, so that the count
//     holds no register through them; on the general path by the thread
//     that stores the part), reduces them in shared memory and adds them to
//     the tally with two u64 atomics. Without one nothing is counted.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxRiceK = 31;         // MAX_RICE_K
constexpr int kEscapeKOffset = 3;     // ESCAPE_K_OFFSET
constexpr int kEscapeKCap = 24;       // ESCAPE_K_CAP
constexpr int kZeroRunMin = 4;        // ZERO_RUN_MIN_LENGTH
constexpr int kZeroRunK = 2;          // ZERO_RUN_LENGTH_K
constexpr int kMaxOrder = 8;          // MAX_PARTITION_ORDER
constexpr int kMinPart = 32;          // MIN_PARTITION_SIZE
constexpr int kMaxN = 16384;          // MAX_BLOCK_SIZE: kernel 10's shared-memory bound
constexpr int kMaxParts = (2 << kMaxOrder) - 2;
constexpr int kBlock9 = 256;
constexpr int kShortRow = 2048;       // kernel 9: rows below this take a warp each
constexpr int kChunkMinR = 8;         // kernel 10, power-of-two rows: samples a lane owns at least
constexpr int kChunkMaxLanes = 1024;  // ... and lanes a row at most (a row is one block)
constexpr int kChunkBlock = 256;      // ... and threads a block of rows of fewer lanes (several rows a block)
constexpr int kForced = 33;  // the class of a zero sample whose zr the lane constants and the edge clip give

struct Sums {
  unsigned long long rice, bin, zr;
  bool run;
};

__device__ __forceinline__ void clear(Sums& s) {
  s.rice = s.bin = s.zr = 0ull;
  s.run = false;
}

__device__ __forceinline__ void add(Sums& s, const Sums& c) {
  s.rice += c.rice;
  s.bin += c.bin;
  s.zr += c.zr;
  s.run |= c.run;
}

// The cost fields of sample i, coded with k, in the segment [start, end).
__device__ __forceinline__ void add_sample(uint32_t u, int k, int last_nz, int next_nz, int i, int start, int end,
                                           Sums& s) {
  const uint32_t q = k >= kMaxRiceK ? 0u : u >> k;
  const unsigned long long rice = (unsigned long long)q + 1ull + (unsigned)k;
  const uint32_t absv = (u >> 1) + (u & 1u);
  const unsigned long long bin = absv == 0u ? 2ull : (absv <= 2u ? 3ull : 2ull + rice);
  const int esc = min(k + kEscapeKOffset, kEscapeKCap);
  unsigned long long zr = 2ull + (u > (1u << esc) ? 32ull : rice);
  if (u == 0u) {
    const int first = max(last_nz + 1, start);
    const int len = min(next_nz, end) - first;
    if (len >= kZeroRunMin) {
      const bool head = i == first;
      zr = head ? 2ull + (unsigned)((len - kZeroRunMin) >> kZeroRunK) + (1 + kZeroRunK) : 0ull;
      s.run |= head;
    }
  }
  s.rice += rice;
  s.bin += bin;
  s.zr += zr;
}

// The stateless k after c >= 1 samples of sum S (adapt.k_after_stateless),
// division-free.
__device__ __forceinline__ int k_stateless(unsigned long long S, unsigned c) {
  const unsigned long long N = S + (c >> 1);
  if (N < 2ull * c) return 0;
  const unsigned long long M = N - c;  // >= c >= 1
  const int k0 = max((64 - __clzll((long long)M)) - (32 - __clz((int)c)), 0);
  return min(k0 + ((M >> k0) >= c ? 1 : 0), kMaxRiceK);
}

__device__ __forceinline__ void warp_reduce(Sums& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s.rice += __shfl_xor_sync(kFull, s.rice, off);
    s.bin += __shfl_xor_sync(kFull, s.bin, off);
    s.zr += __shfl_xor_sync(kFull, s.zr, off);
  }
  s.run = __any_sync(kFull, s.run);
}

__device__ __forceinline__ void store(long long* out, const Sums& s) {
  out[0] = (long long)s.rice;
  out[1] = (long long)s.bin;
  out[2] = (long long)s.zr;
  out[3] = s.run ? 1 : 0;
}

// ---------------------------------------------------------------- kernel 9

// A row per kGroup threads (256: the block; 32: a warp). kVec: 16-byte loads.
template <int kGroup, bool kVec>
__global__ void __launch_bounds__(kBlock9)
mode_cost_rows(const uint32_t* __restrict__ u, const int* __restrict__ k_after, const int* __restrict__ initial_k,
               const int* __restrict__ last_nz, const int* __restrict__ next_nz, long long rows, int n,
               long long* __restrict__ out) {
  constexpr int kRows = kBlock9 / kGroup;
  __shared__ Sums part[kBlock9 / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = threadIdx.x % kGroup;  // this thread in its row's group
  const long long row = (long long)blockIdx.x * kRows + threadIdx.x / kGroup;
  const bool live_row = row < rows;  // the same for a whole warp
  Sums s;
  clear(s);
  if (live_row) {
    const long long base = row * n;
    const int k0 = __ldg(initial_k + row);
    if (kVec) {
      const int nv = n >> 2;
      const uint4* uv = reinterpret_cast<const uint4*>(u + base);
      const int4* kv = reinterpret_cast<const int4*>(k_after + base);
      const int4* lv = reinterpret_cast<const int4*>(last_nz + base);
      const int4* xv = reinterpret_cast<const int4*>(next_nz + base);
      for (int v0 = t - lane; v0 < nv; v0 += kGroup) {  // warp-uniform trips: the shuffle below
        const int v = v0 + lane;
        const bool live = v < nv;
        uint4 uu = make_uint4(0u, 0u, 0u, 0u);
        int4 ka = make_int4(0, 0, 0, 0), ln = ka, nx = ka;
        if (live) {
          uu = __ldg(uv + v);
          ka = __ldg(kv + v);
          ln = __ldg(lv + v);
          nx = __ldg(xv + v);
        }
        int prev = __shfl_up_sync(kFull, ka.w, 1);  // k_after[4v - 1], from the lane before
        if (lane == 0 && live && v > 0) prev = __ldg(k_after + base + 4 * (long long)v - 1);
        if (live) {
          const int i = 4 * v;
          add_sample(uu.x, v == 0 ? k0 : prev, ln.x, nx.x, i, 0, n, s);
          add_sample(uu.y, ka.x, ln.y, nx.y, i + 1, 0, n, s);
          add_sample(uu.z, ka.y, ln.z, nx.z, i + 2, 0, n, s);
          add_sample(uu.w, ka.z, ln.w, nx.w, i + 3, 0, n, s);
        }
      }
    } else {
      for (int i = t; i < n; i += kGroup) {
        const int k = i == 0 ? k0 : __ldg(k_after + base + i - 1);
        add_sample(__ldg(u + base + i), k, __ldg(last_nz + base + i), __ldg(next_nz + base + i), i, 0, n, s);
      }
    }
  }
  warp_reduce(s);
  if (kGroup == 32) {
    if (lane == 0 && live_row) store(out + row * 4, s);
    return;
  }
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0 && live_row) {
    Sums total = part[0];
    for (int w = 1; w < kBlock9 / 32; ++w) add(total, part[w]);
    store(out + row * 4, total);
  }
}

// --------------------------------------------------------------- kernel 10

// A launch's tally: the parts whose codes sum to 2^31 or more (the 64-bit
// way) and every part summed, added to tally[0] and tally[1] once a block.
// Every thread of the block calls it with its own counts.
__device__ void add_tally(unsigned wide, unsigned parts, unsigned long long* tally) {
  __shared__ unsigned block_sum[2];
  if (threadIdx.x == 0) block_sum[0] = block_sum[1] = 0u;
  __syncthreads();
  wide = __reduce_add_sync(kFull, wide);
  parts = __reduce_add_sync(kFull, parts);
  if ((threadIdx.x & 31) == 0 && (wide | parts) != 0u) {
    atomicAdd(block_sum, wide);
    atomicAdd(block_sum + 1, parts);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(tally, (unsigned long long)block_sum[0]);
    atomicAdd(tally + 1, (unsigned long long)block_sum[1]);
  }
}

// Part e's sums: three u64 accumulators and a run flag in shared memory.
__device__ __forceinline__ void flush(Sums s, unsigned long long* acc, unsigned* run, int e, int lane) {
  warp_reduce(s);
  if (lane == 0) {
    atomicAdd(acc + 3 * e, s.rice);
    atomicAdd(acc + 3 * e + 1, s.bin);
    atomicAdd(acc + 3 * e + 2, s.zr);
    if (s.run) run[e] = 1u;
  }
}

// Sample i of part j of the current order (parts of `base` samples, the
// last one to n), its u and the part's sum before it from the staged P.
__device__ __forceinline__ void part_sample(const unsigned long long* P, const int* __restrict__ last_nz,
                                            const int* __restrict__ next_nz, const int* ik, int i, int j, int base,
                                            int nparts, int n, int off, Sums& s) {
  const int start = j * base;
  const int end = j == nparts - 1 ? n : start + base;
  const unsigned long long pi = P[i];
  const int k = i == start ? ik[off + j] : k_stateless(pi - P[start], (unsigned)(i - start));
  add_sample((uint32_t)(P[i + 1] - pi), k, __ldg(last_nz + i), __ldg(next_nz + i), i, start, end, s);
}

__global__ void __launch_bounds__(1024, 1)
partition_cost_rows(const uint32_t* __restrict__ u, const int* __restrict__ last_nz, const int* __restrict__ next_nz,
                    const int* __restrict__ init_k, int n, int max_p, long long* __restrict__ out,
                    unsigned long long* __restrict__ tally) {
  extern __shared__ unsigned long long smem[];
  __shared__ unsigned long long warp_total[32];
  const int parts = (2 << max_p) - 2;  // orders 1..max_p, order p's parts at 2^p - 2
  unsigned long long* P = smem;        // P[i] = u[0] + ... + u[i - 1]
  unsigned long long* acc = P + n + 1;
  unsigned* run = reinterpret_cast<unsigned*>(acc + 3 * parts);
  int* ik = reinterpret_cast<int*>(run + parts);
  const long long row = blockIdx.x;
  u += row * n;
  last_nz += row * n;
  next_nz += row * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int r0 = (int)((long long)warp * n / warps), r1 = (int)((long long)(warp + 1) * n / warps);

  for (int e = threadIdx.x; e < parts; e += blockDim.x) {
    acc[3 * e] = acc[3 * e + 1] = acc[3 * e + 2] = 0ull;
    run[e] = 0u;
    ik[e] = __ldg(init_k + row * parts + e);
  }
  // the prefix sums: each warp scans its range, then adds the earlier warps' totals
  unsigned long long carry = 0ull;
  for (int s0 = r0; s0 < r1; s0 += 32) {
    const int i = s0 + lane;
    unsigned long long x = i < r1 ? (unsigned long long)__ldg(u + i) : 0ull;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (i < r1) P[i + 1] = carry + x;
    carry += __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) warp_total[warp] = carry;
  __syncthreads();
  unsigned long long before = 0ull;
  for (int w = 0; w < warp; ++w) before += warp_total[w];
  for (int i = r0 + lane; i < r1; i += 32) P[i + 1] += before;
  if (threadIdx.x == 0) P[0] = 0ull;
  __syncthreads();

  for (int p = 1; p <= max_p; ++p) {
    const int nparts = 1 << p, base = n >> p, off = nparts - 2;
    if (r0 >= r1) continue;
    int cur = min(r0 / base, nparts - 1);  // the part of the warp's current step
    int cur_end = cur == nparts - 1 ? n : (cur + 1) * base;
    Sums s;
    clear(s);
    for (int s0 = r0; s0 < r1; s0 += 32) {
      const int i = s0 + lane;
      const bool live = i < r1;
      const bool next = live && i >= cur_end;  // in part cur + 1: a part holds >= 32 samples
      if (!__any_sync(kFull, next)) {
        if (live) part_sample(P, last_nz, next_nz, ik, i, cur, base, nparts, n, off, s);
        continue;
      }
      // the step closes part cur
      Sums c;
      clear(c);
      if (live) part_sample(P, last_nz, next_nz, ik, i, next ? cur + 1 : cur, base, nparts, n, off, c);
      if (!next) add(s, c);
      flush(s, acc, run, off + cur, lane);
      if (next) s = c; else clear(s);
      ++cur;
      cur_end = cur == nparts - 1 ? n : (cur + 1) * base;
    }
    flush(s, acc, run, off + cur, lane);
  }
  __syncthreads();
  long long* dst = out + row * parts * 4;
  unsigned wide = 0u;
  for (int e = threadIdx.x; e < parts; e += blockDim.x) {
    dst[4 * e] = (long long)acc[3 * e];
    dst[4 * e + 1] = (long long)acc[3 * e + 1];
    dst[4 * e + 2] = (long long)acc[3 * e + 2];
    dst[4 * e + 3] = run[e] ? 1 : 0;
    if (tally != nullptr) {
      const int p = 31 - __clz(e + 2), j = e + 2 - (1 << p), base = n >> p;  // part j of order p
      wide += P[j == (1 << p) - 1 ? n : (j + 1) * base] - P[j * base] >= (1ull << 31) ? 1u : 0u;
    }
  }
  if (tally != nullptr) add_tally(wide, threadIdx.x == 0 ? (unsigned)parts : 0u, tally);
}

// ------------------------------------------- kernel 10, power-of-two rows

__device__ __forceinline__ unsigned run_cost(int len) {
  return 2u + (unsigned)((len - kZeroRunMin) >> kZeroRunK) + (1 + kZeroRunK);
}

// A code's class, whatever its k: u escapes (u > 2^min(k + 3, 24)) iff
// class > k, and bin adds 3 + q + k iff 0 <= class <= 32 (u >= 5).
__device__ __forceinline__ int code_class(uint32_t u) {
  return u == 0u ? -3 : (u > (1u << kEscapeKCap) ? 32 : 29 - __clz((int)(u - 1u)));
}

// A row's shared memory: chunk prefixes (L + 2), the parts' three sums,
// run flags and initial k.
__host__ __device__ constexpr size_t chunk_row_bytes(int L, int parts) {
  return 8 * (size_t)(L + 2) + 32 * (size_t)parts;
}
// a row of kChunkMaxLanes lanes at kMaxOrder, alone in its block, is the most a block asks for
static_assert(chunk_row_bytes(kChunkMaxLanes, kMaxParts) <= 48 * 1024, "the default dynamic shared-memory limit");

// Sum a lane's value over aligned groups of G lanes (G a power of two; a
// whole warp from 32 on): every lane of a group gets the group's sum.
__device__ __forceinline__ unsigned group_sum(unsigned v, int G) {
  if (G >= 32) return __reduce_add_sync(kFull, v);
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long group_sum(unsigned long long v, int G) {
  for (int o = min(G, 32) >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One order's sums of a lane's chunk [a, a + R) inside its part [s, e):
// kWide the 64-bit way, else every value below 2^31 (the part sums so).
template <int R, bool kWide>
__device__ __forceinline__ void chunk_order(const uint32_t (&uv)[R], const unsigned (&wp)[R / 4], unsigned long long S0,
                                            int a, int s, int e, int k_first, unsigned bin_c, unsigned zr_c,
                                            int lead, int trail, int La, int Xb, bool run_mid, int G, int off_j,
                                            bool leader, unsigned long long* acc, unsigned* run_flag) {
  using T = typename std::conditional<kWide, unsigned long long, unsigned>::type;
  using DT = typename std::conditional<kWide, long long, int>::type;
  const int c0 = a - s;  // even: a multiple of R
  const int bwc0 = 32 - __clz(c0);  // bit width of c = c0 + r: max(bw(c0), bw(r)) (c0 is 0 or a multiple of R > r)
  // the constants folded in: rice 1 a sample, bin 3 a nonzero code and 2 a zero,
  // zr 3 a sample and -34 a forced one (its 31 below cancelled) and the inner runs' costs
  T rice = R, bin = bin_c, zr = (T)(DT)(int)zr_c;
  DT D = (DT)S0 - (c0 >> 1);  // S - ceil(c / 2) at the chunk's first sample
  int kf[3], kl[3];           // k of the first and the last three samples: the edge runs' tokens
#pragma unroll
  for (int q4 = 0; q4 < R / 4; ++q4) {
    const uint32_t us[4] = {uv[4 * q4], uv[4 * q4 + 1], uv[4 * q4 + 2], uv[4 * q4 + 3]};
    int ws[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ws[i] = (int)(wp[q4] << (24 - 8 * i)) >> 24;  // byte i, sign-extended
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * q4 + i;
      const unsigned c = (unsigned)(c0 + r);
      int k;
      if (kWide) {
        // k0 = max(bw(M) - bw(c), 0) leaves M >> k0 below 2^bw(c) <= 2^14: its low word is exact
        const unsigned long long M = (unsigned long long)(D & ~(D >> 63));  // max(D, 0)
        const unsigned hi = (unsigned)(M >> 32);
        const int bwm = hi ? 64 - __clz((int)hi) : 32 - __clz((int)(unsigned)M);
        const int k0 = max(bwm - max(bwc0, 32 - __clz(r)), 0);  // bw(r) a constant once unrolled
        k = min(k0 + ((unsigned)(M >> k0) >= c ? 1 : 0), kMaxRiceK);
      } else {  // M < 2^31: k <= 31
        const unsigned M = (unsigned)max((int)D, 0);
        const int k0 = max(__clz((int)c) - __clz((int)M), 0);
        k = k0 + ((M >> k0) >= c ? 1 : 0);
      }
      int kc = k;  // k for the escape test and the shift
      if (r == 0 && c0 == 0) {
        k = k_first;
        kc = min(k, kMaxRiceK);
      }
      const uint32_t q = (kWide || r == 0) && kc >= kMaxRiceK ? 0u : us[i] >> kc;
      const uint32_t t = q + (unsigned)k;
      rice += t;
      bin += (unsigned)ws[i] <= 32u ? t : 0u;
      zr += ws[i] > kc ? 31u : t;
      D += (DT)us[i] - ((r & 1) ? 0 : 1);
      if (r < 3) kf[r] = k;
      if (r >= R - 3) kl[r - (R - 3)] = k;
    }
  }
  bool run = run_mid;
  if (lead | trail) {  // the edge runs, clipped to the part
    if (lead == R) {   // all zeros: one run, at least R long
      const int first = max(La, s);
      if (first == a) {
        zr += run_cost(min(Xb, e) - first);
        run = true;
      }
    } else {
      if (lead) {  // [La, a + lead)
        const int first = max(La, s), len = a + lead - first;
        if (len >= kZeroRunMin) {
          if (first == a) {
            zr += run_cost(len);
            run = true;
          }
        } else {  // lead <= len <= 3 tokens of u = 0
          zr += 3u * lead + kf[0] + (lead > 1 ? kf[1] : 0) + (lead > 2 ? kf[2] : 0);
        }
      }
      if (trail) {  // [a + R - trail, Xb)
        const int len = min(Xb, e) - (a + R - trail);
        if (len >= kZeroRunMin) {
          zr += run_cost(len);
          run = true;
        } else {
          zr += 3u * trail + kl[2] + (trail > 1 ? kl[1] : 0) + (trail > 2 ? kl[0] : 0);
        }
      }
    }
  }
  rice = group_sum(rice, G);
  bin = group_sum(bin, G);
  zr = group_sum(zr, G);
  const unsigned ballot = __ballot_sync(kFull, run);
  const int lane = threadIdx.x & 31, gl = min(G, 32);
  const bool any = gl == 32 ? ballot != 0u : ((ballot >> (lane & ~(gl - 1))) & ((1u << gl) - 1u)) != 0u;
  if (leader) {
    unsigned long long* dst = acc + 3 * off_j;
    if (G > 32) {  // one add from each warp of the part
      atomicAdd(dst, (unsigned long long)rice);
      atomicAdd(dst + 1, (unsigned long long)bin);
      atomicAdd(dst + 2, (unsigned long long)zr);
      if (any) run_flag[off_j] = 1u;
    } else {
      dst[0] = rice;
      dst[1] = bin;
      dst[2] = zr;
      run_flag[off_j] = any ? 1u : 0u;
    }
  }
}

template <int R>
__global__ void __launch_bounds__(1024)
partition_cost_chunks(const uint32_t* __restrict__ u, const int* __restrict__ last_nz,
                      const int* __restrict__ next_nz, const int* __restrict__ init_k, long long rows, int log2n,
                      int max_p, long long* __restrict__ out, unsigned long long* __restrict__ tally) {
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  __shared__ unsigned long long warp_sum[32], warp_before[32];
  static_assert(R == 8 || R == 16, "chunk_r gives 8 or 16 for n <= kMaxN");
  constexpr int kLog2R = R == 8 ? 3 : 4;
  constexpr unsigned kAll = (1u << R) - 1u;
  const int n = 1 << log2n, L = n >> kLog2R, Tr = max(L, 32);  // lanes and threads a row
  const int parts = (2 << max_p) - 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ci = threadIdx.x % Tr;  // the chunk
  const long long row = (long long)blockIdx.x * (blockDim.x / Tr) + threadIdx.x / Tr;
  const bool live_row = row < rows, live = live_row && ci < L;
  const int cl = ci < L ? ci : 0;  // the chunk whose part an idle lane follows (it stores nothing)
  unsigned char* base = chunk_smem + (threadIdx.x / Tr) * chunk_row_bytes(L, parts);
  unsigned long long* Pc = reinterpret_cast<unsigned long long*>(base);
  unsigned long long* acc = Pc + L + 2;
  unsigned* run_flag = reinterpret_cast<unsigned*>(acc + 3 * parts);
  int* ik = reinterpret_cast<int*>(run_flag + parts);

  // once a row: the chunk's codes, sum and zero runs
  const int a = ci * R;
  const long long at = row * n + a;
  uint32_t uv[R];
  unsigned zm = 0u;
  unsigned long long sum = 0ull;
#pragma unroll
  for (int r = 0; r < R; ++r) uv[r] = 0u;
  if (live) {
    if (reinterpret_cast<uintptr_t>(u) % 16 == 0) {
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(u + at + r));
        uv[r] = v.x;
        uv[r + 1] = v.y;
        uv[r + 2] = v.z;
        uv[r + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) uv[r] = __ldg(u + at + r);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    sum += uv[r];
    zm |= (uv[r] == 0u ? 1u : 0u) << r;
  }
  if (!live) zm = 0u;
  // zero samples at the chunk's start (lead) and end (trail); R and R when all are zero
  int lead = R, trail = R;
  unsigned edge = zm;
  if (zm != kAll) {
    lead = __ffs(~zm) - 1;
    trail = __clz((int)(~zm & kAll)) - (32 - R);
    edge = ((1u << lead) - 1u) | (trail ? (kAll << (R - trail)) & kAll : 0u);
  }
  const int La = lead ? __ldg(last_nz + at) + 1 : 0;     // the lead run's first sample
  const int Xb = trail ? __ldg(next_nz + at + R - 1) : 0;  // the trail run's end
  // the runs inside the chunk: the same at every order
  const unsigned mid = zm & ~edge;
  const unsigned m4 = mid & (mid >> 1) & (mid >> 2) & (mid >> 3);
  const unsigned longm = m4 | (m4 << 1) | (m4 << 2) | (m4 << 3);
  unsigned heads = longm & ~(longm << 1);
  int cost = 0;
  while (heads) {
    const int h = __ffs(heads) - 1;
    cost += (int)run_cost(__ffs(~(longm >> h)) - 1);
    heads &= heads - 1u;
  }
  const unsigned forced = edge | longm;
  const unsigned bin_c = 3u * R - __popc(zm);
  const unsigned zr_c = 3u * R - 34u * __popc(forced) + (unsigned)cost;
  unsigned wp[R / 4];  // each sample's class in a byte, four to a register
#pragma unroll
  for (int q4 = 0; q4 < R / 4; ++q4) {
    wp[q4] = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int w = (forced >> (4 * q4 + i)) & 1u ? kForced : code_class(uv[4 * q4 + i]);
      wp[q4] |= ((unsigned)w & 0xFFu) << (8 * i);
    }
  }
  // the chunks' exclusive prefixes: a warp scan, then the warps before this one in its row
  unsigned long long x = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  for (int e = ci; e < parts; e += Tr) {
    acc[3 * e] = acc[3 * e + 1] = acc[3 * e + 2] = 0ull;
    run_flag[e] = 0u;
    ik[e] = live_row ? __ldg(init_k + row * parts + e) : 0;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5, wr = Tr >> 5;  // warps a block and a row
    const unsigned long long v = lane < nw ? warp_sum[lane] : 0ull;
    unsigned long long incl = v;
    for (int o = 1; o < wr; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, incl, o);
      if ((lane & (wr - 1)) >= o) incl += y;
    }
    if (lane < nw) warp_before[lane] = incl - v;
  }
  __syncthreads();
  const unsigned long long Pa = warp_before[warp] + x - sum;
  if (ci < L) Pc[ci] = Pa;
  if (ci == L - 1) Pc[L] = Pa + sum;
  __syncthreads();
  if (tally != nullptr) {  // before the orders, so that nothing of it stays live through them
    unsigned wide = 0u, led = 0u;  // the parts whose first chunk is this lane's, each counted once
    for (int p = 1; p <= max_p; ++p) {
      const int G = 1 << (log2n - p - kLog2R);
      if (live && (ci & (G - 1)) == 0) {
        ++led;
        wide += Pc[ci + G] - Pc[ci] >= (1ull << 31) ? 1u : 0u;
      }
    }
    add_tally(wide, led, tally);
  }

  for (int p = 1; p <= max_p; ++p) {
    const int gshift = log2n - p - kLog2R, G = 1 << gshift;  // lanes a part
    const int len = n >> p, off = (1 << p) - 2;
    const int j = cl >> gshift, s = j * len, e = s + len;
    const unsigned long long Ps = Pc[j << gshift], Pe = Pc[(j + 1) << gshift];
    const bool wide = __any_sync(kFull, ci < L && Pe - Ps >= (1ull << 31));
    const int k_first = ci < L && a == s ? ik[off + j] : 0;
    const bool leader = live && (lane & (min(G, 32) - 1)) == 0;
    if (wide) {
      chunk_order<R, true>(uv, wp, Pa - Ps, a, s, e, k_first, bin_c, zr_c, lead, trail, La, Xb,
                           longm != 0u, G, off + j, leader, acc, run_flag);
    } else {
      chunk_order<R, false>(uv, wp, Pa - Ps, a, s, e, k_first, bin_c, zr_c, lead, trail, La, Xb,
                            longm != 0u, G, off + j, leader, acc, run_flag);
    }
  }
  __syncthreads();
  if (live_row) {
    long long* dst = out + row * parts * 4;
    for (int e = ci; e < parts; e += Tr) {
      dst[4 * e] = (long long)acc[3 * e];
      dst[4 * e + 1] = (long long)acc[3 * e + 1];
      dst[4 * e + 2] = (long long)acc[3 * e + 2];
      dst[4 * e + 3] = run_flag[e] ? 1 : 0;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kGroup>
void launch_rows(const uint32_t* u, const int* k_after, const int* initial_k, const int* last_nz, const int* next_nz,
                 long long rows, int n, long long* out, cudaStream_t s) {
  const unsigned blocks = (unsigned)((rows + kBlock9 / kGroup - 1) / (kBlock9 / kGroup));
  if (n % 4 == 0 && aligned16(u) && aligned16(k_after) && aligned16(last_nz) && aligned16(next_nz)) {
    mode_cost_rows<kGroup, true><<<blocks, kBlock9, 0, s>>>(u, k_after, initial_k, last_nz, next_nz, rows, n, out);
  } else {
    mode_cost_rows<kGroup, false><<<blocks, kBlock9, 0, s>>>(u, k_after, initial_k, last_nz, next_nz, rows, n, out);
  }
}

// samples a lane owns on the power-of-two path, or 0: the general path
constexpr int chunk_r(long long n) {
  return n < 1 || (n & (n - 1)) != 0 ? 0 : (int)(n / kChunkMaxLanes > kChunkMinR ? n / kChunkMaxLanes : kChunkMinR);
}

// the largest dynamic shared memory partition_cost_rows asks for, set once
// per card (before a graph captures a launch: the eager warm-up launches
// first); two threads may both set it: the same value
bool g_smem_set[64];

template <int R>
void launch_chunks(const uint32_t* u, const int* last_nz, const int* next_nz, const int* init_k, long long rows,
                   int n, int max_p, long long* out, unsigned long long* tally, cudaStream_t s) {
  const int L = n / R, Tr = L > 32 ? L : 32, threads = Tr > kChunkBlock ? Tr : kChunkBlock;
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  const unsigned blocks = (unsigned)((rows + threads / Tr - 1) / (threads / Tr));
  const size_t smem = (size_t)(threads / Tr) * chunk_row_bytes(L, (2 << max_p) - 2);
  partition_cost_chunks<R><<<blocks, threads, smem, s>>>(u, last_nz, next_nz, init_k, rows, log2n, max_p, out,
                                                         tally);
}

}  // namespace

// u32 codes, k_after, last_nz and next_nz (rows, n) int32 and initial_k
// (rows,) int32, all contiguous -> out (rows, 4) int64: rice, bin and zr
// bits and has_run per row. Returns a cudaError_t.
extern "C" int lac_mode_cost_sums(const void* u, const void* k_after, const void* initial_k, const void* last_nz,
                                  const void* next_nz, long long rows, long long n, void* out, void* stream,
                                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || n < 1 || n > 0x7FFFFFFFLL || rows > 0x7FFFFFFFLL * 8) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* uu = static_cast<const uint32_t*>(u);
  const auto* ka = static_cast<const int*>(k_after);
  const auto* ik = static_cast<const int*>(initial_k);
  const auto* ln = static_cast<const int*>(last_nz);
  const auto* nx = static_cast<const int*>(next_nz);
  auto* o = static_cast<long long*>(out);
  if (n >= kShortRow) {
    launch_rows<kBlock9>(uu, ka, ik, ln, nx, rows, (int)n, o, s);
  } else {
    launch_rows<32>(uu, ka, ik, ln, nx, rows, (int)n, o, s);
  }
  return (int)cudaGetLastError();
}

// Kernel 10's path for rows of n samples: the samples a lane owns on the
// power-of-two path (partition_cost_chunks), 0 on the general path
// (partition_cost_rows). The choice depends on n alone.
extern "C" int lac_partition_cost_path(long long n) { return chunk_r(n); }

// u32 codes, last_nz and next_nz (rows, n) int32 (the breaks the codes'
// own, runs.zero_breaks) and init_k (rows, 2^(max_p+1) - 2) int32 (each
// part's initial k, 0..31, order by order), all contiguous -> out (rows,
// 2^(max_p+1) - 2, 4) int64: rice, bin and zr bits and has_run per part.
// Needs 1 <= max_p <= 8, n >> max_p >= 32 and n <= 16384. With a tally
// (2,) u64, or null: the launch adds to tally[0] its parts whose codes sum
// to 2^31 or more (summed the 64-bit way) and to tally[1] every part it
// sums (rows x (2^(max_p+1) - 2)). Returns a cudaError_t.
extern "C" int lac_partition_cost_sums_tally(const void* u, const void* last_nz, const void* next_nz,
                                             const void* init_k, long long rows, long long n, long long max_p,
                                             void* out, void* tally, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || rows > 0x7FFFFFFFLL || max_p < 1 || max_p > kMaxOrder || n > kMaxN || (n >> max_p) < kMinPart) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* uu = static_cast<const uint32_t*>(u);
  const auto* ln = static_cast<const int*>(last_nz);
  const auto* nx = static_cast<const int*>(next_nz);
  const auto* ik = static_cast<const int*>(init_k);
  auto* o = static_cast<long long*>(out);
  auto* t = static_cast<unsigned long long*>(tally);
  const int r = chunk_r(n);
  if (r == 16) {
    launch_chunks<16>(uu, ln, nx, ik, rows, (int)n, (int)max_p, o, t, s);
  } else if (r == 8) {
    launch_chunks<8>(uu, ln, nx, ik, rows, (int)n, (int)max_p, o, t, s);
  } else {
    if (!g_smem_set[device]) {
      const size_t max_smem = (size_t)(kMaxN + 1) * 8 + (size_t)kMaxParts * (3 * 8 + 4 + 4);
      err = cudaFuncSetAttribute(partition_cost_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
      if (err != cudaSuccess) return (int)err;
      g_smem_set[device] = true;
    }
    const int parts = (2 << max_p) - 2;
    const size_t smem = (size_t)(n + 1) * 8 + (size_t)parts * (3 * 8 + 4 + 4);
    // a warp for each 512 samples, 1..32
    const int warps = (int)(n / 512 < 1 ? 1 : (n / 512 > 32 ? 32 : n / 512));
    partition_cost_rows<<<(unsigned)rows, warps * 32, smem, s>>>(uu, ln, nx, ik, (int)n, (int)max_p, o, t);
  }
  return (int)cudaGetLastError();
}

// lac_partition_cost_sums_tally without a tally: the entry every version of
// this file has, which tools that build another version beside this one call.
extern "C" int lac_partition_cost_sums(const void* u, const void* last_nz, const void* next_nz, const void* init_k,
                                       long long rows, long long n, long long max_p, void* out, void* stream,
                                       int device) {
  return lac_partition_cost_sums_tally(u, last_nz, next_nz, init_k, rows, n, max_p, out, nullptr, stream, device);
}
