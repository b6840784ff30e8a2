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
// lac_tpu_torch/csrc/k_after.cu. Both take the per-sample cost through one
// device function (add_sample).
//
// Bound on the H100. Kernel 9 reads 16 bytes a sample (codes, k_after and
// the two zero breaks, int32 each) and does about 33 integer instructions
// on them (chip_smoke.py counts them): bound by bytes, 0.22 ms at (2816,
// 16384). Kernel 10 reads 12 bytes a sample once and does about 70
// instructions a sample for each of max_p orders: bound by instructions,
// 0.07 ms at (256, 16384) over 8 orders against 0.015 ms of bytes.
//
// Design:
//   * Kernel 9: one block of 256 threads per row for rows of 2048 samples
//     or more, one warp per row (8 rows a block) below. 16-byte loads of
//     the four operands, a lane's four samples in registers; k_after[i - 1]
//     of a lane's first sample comes from the lane before it by a shuffle,
//     and lane 0 of a warp reads it (a one-element halo). Rows that are not
//     16-byte aligned, or whose length is not a multiple of 4, take 4-byte
//     loads. Warp shuffles, then shared memory across the warps of a block.
//   * Kernel 10: one block per lane. The block first stages the row's
//     inclusive u64 prefix sums P in dynamic shared memory ((n + 1) x 8
//     bytes, 128 KB at n = 16384), from a warp scan over each warp's range
//     and the warp totals; u = P[i + 1] - P[i] and S = P[i] - P[start] then
//     cost two shared-memory loads and a broadcast. Every order walks the
//     row in the same warp ranges, 32 samples a step, coalesced; a part
//     holds at least 32 samples (n >> max_p >= 32), so a step spans at most
//     two parts. Each lane accumulates its samples of the warp's current
//     part; where a step crosses into the next part (a vote tells) the warp
//     reduces (three u64 sums by shuffles, has_run by a vote) and lane 0
//     adds the part's sums into shared-memory accumulators (u64 atomics: a
//     part that spans several warps' ranges gets one add from each). One
//     barrier before the sums leave for device memory. The parts' initial k
//     are staged in shared memory too; the zero breaks are read from device
//     memory at every order (L2 serves the repeats: staging them in shared
//     memory as 16-bit pairs beside P, and packing short rows 8 to a block,
//     measured no faster on the H100).

#include <cuda_runtime.h>
#include <stdint.h>

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
                    const int* __restrict__ init_k, int n, int max_p, long long* __restrict__ out) {
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
  for (int e = threadIdx.x; e < parts; e += blockDim.x) {
    dst[4 * e] = (long long)acc[3 * e];
    dst[4 * e + 1] = (long long)acc[3 * e + 1];
    dst[4 * e + 2] = (long long)acc[3 * e + 2];
    dst[4 * e + 3] = run[e] ? 1 : 0;
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

// the largest dynamic shared memory kernel 10 asks for, set once per card
// (before a graph captures a launch: the eager warm-up launches first)
bool g_smem_set[64];

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

// u32 codes, last_nz and next_nz (rows, n) int32 and init_k (rows, 2^(max_p+1)
// - 2) int32 (each part's initial k, order by order), all contiguous -> out
// (rows, 2^(max_p+1) - 2, 4) int64: rice, bin and zr bits and has_run per
// part. Needs 1 <= max_p <= 8, n >> max_p >= 32 and n <= 16384. Returns a
// cudaError_t.
extern "C" int lac_partition_cost_sums(const void* u, const void* last_nz, const void* next_nz, const void* init_k,
                                       long long rows, long long n, long long max_p, void* out, void* stream,
                                       int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 0 || rows > 0x7FFFFFFFLL || max_p < 1 || max_p > kMaxOrder || n > kMaxN || (n >> max_p) < kMinPart) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  const size_t max_smem = (size_t)(kMaxN + 1) * 8 + (size_t)kMaxParts * (3 * 8 + 4 + 4);
  if (!g_smem_set[device]) {
    err = cudaFuncSetAttribute(partition_cost_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
    if (err != cudaSuccess) return (int)err;
    g_smem_set[device] = true;
  }
  const int parts = (2 << max_p) - 2;
  const size_t smem = (size_t)(n + 1) * 8 + (size_t)parts * (3 * 8 + 4 + 4);
  // a warp for each 512 samples, 1..32
  const int warps = (int)(n / 512 < 1 ? 1 : (n / 512 > 32 ? 32 : n / 512));
  partition_cost_rows<<<(unsigned)rows, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(u), static_cast<const int*>(last_nz), static_cast<const int*>(next_nz),
      static_cast<const int*>(init_k), (int)n, (int)max_p, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
