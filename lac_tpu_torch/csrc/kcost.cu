// k-cost row reductions for the Rice cost stacks of the planner.
//
// Replaces lac_tpu/ops/pallas_kernels.py:k_cost_sums (body `_kernel`).
// For a row of u32 zigzag codes the 17 k-cost sums are
//   sums[0]     = sum(u >> 16)
//   sums[1 + k] = sum((u & 0xFFFF) >> k),  k = 0..15
// in wrapping uint32 arithmetic (every sum on the planner's path is
// <= 2^30: at most 16384 samples of 16-bit halves), so any order of
// addition is exact. Two entries:
//
// lac_k_cost_sums: the sums of every row and, from the same read, of
// each row's first `head` samples (the planner wants the initial-k costs
// of the 256-sample head and the static-k costs of the whole row).
//
// lac_k_cost_partition_sums: a row cut into 2^p equal parts for every
// order p = 0..levels, all from one read. The sums are additive over
// samples, so the finest order's segment sums, folded pairwise in shared
// memory, give every coarser order's.
//
// Bound: device-memory bandwidth on long rows (4 bytes per sample
// against 35 integer instructions), and close to the integer rate on
// short rows, where every instruction beside the 35 shows. The TPU's 17
// where-selects into a 128-lane output tile have no counterpart here.
// The design:
//   * 128-bit loads, neighbouring lanes on neighbouring addresses, the
//     17 accumulators in registers. Operands that are not 16-byte
//     aligned, or lengths that are not multiples of 4, take the same
//     kernels with 4-byte loads.
//   * Long rows (k_cost_block_per_row): one block per row. The threads
//     first add the head's samples, copy their accumulators for the head
//     sums, and go on over the rest of the row.
//   * Short rows and partition segments (k_cost_tree): a group of 8
//     lanes owns a segment, so a 32-sample segment is one 128-bit load a
//     lane and a warp reads four segments at once, each a whole 128-byte
//     line. A block's segment sums land in shared memory laid out as the
//     output (order p at entries 2^p - 1 .. 2^(p+1) - 2 of its row), are
//     folded up the orders there, and leave in one coalesced copy. A row
//     of at most 1024 samples is the case levels = 0: 32 rows a block.
//   * Reductions across lanes halve the live values at every step: of m
//     sums a lane keeps one half and gives the other to its partner, so
//     a warp reduces 17 sums in 9 + 5 + 3 + 2 + 1 = 20 shuffles and a
//     group of 8 in 9 + 5 + 3 = 17, not 17 per step.
//
// Rows may be a strided view: row r starts at u + r * ld (ld >= n).

#include <cuda_runtime.h>
#include <stdint.h>

// Build-time choices, macros so that one command can time them against
// each other (lac_tpu_torch/ab_kernels.py): vector loads a thread keeps in
// flight, and the block that takes a row of 64 or more segments (at 64
// registers a thread, two blocks of 512 share an SM where one of 1024
// has it alone, and 256 rows then run in one wave instead of two).
#ifndef LAC_KCOST_UNROLL
#define LAC_KCOST_UNROLL 2
#endif
#ifndef LAC_KCOST_TREE_BLOCK
#define LAC_KCOST_TREE_BLOCK 512
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = LAC_KCOST_UNROLL;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 17;
constexpr int kGroupLanes = 8;
constexpr int kMaxLevels = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void accumulate(uint32_t u, uint32_t (&acc)[kSums + 1]) {
  acc[0] += u >> 16;
  const uint32_t lo = u & 0xFFFFu;
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k + 1] += lo >> k;
}

// Elements lo..hi of row p, shared among `stride` threads of which this is
// number `t`. kVec: p is 16-byte aligned and lo % 4 == 0.
template <bool kVec>
__device__ __forceinline__ void accumulate_span(const uint32_t* __restrict__ p, long long lo, long long hi,
                                                int t, int stride, uint32_t (&acc)[kSums + 1]) {
  long long i = lo + t;
  if (kVec) {
    const long long nv = (hi - lo) >> 2;
    const uint4* q = reinterpret_cast<const uint4*>(p + lo);
#pragma unroll kUnroll
    for (long long v = t; v < nv; v += stride) {
      const uint4 x = __ldg(q + v);
      accumulate(x.x, acc);
      accumulate(x.y, acc);
      accumulate(x.z, acc);
      accumulate(x.w, acc);
    }
    i += nv << 2;
  }
  for (; i < hi; i += stride) accumulate(__ldg(p + i), acc);
}

// One halving step between lanes that differ in lane bit `off`: of the m
// live sums v[0..m) the lane with the bit clear keeps the first
// h = ceil(m / 2) and the other lane the rest (a zero pads an odd m);
// each adds its partner's copy of what it keeps. Afterwards v[0..h) are
// live and v[i] holds the sum of index i (bit clear) or h + i (bit set).
template <int m>
__device__ __forceinline__ void halve(uint32_t (&v)[kSums + 1], int off, bool upper) {
  constexpr int h = (m + 1) / 2;
  if (m & 1) v[m] = 0u;
#pragma unroll
  for (int i = 0; i < h; ++i) {
    const uint32_t keep = upper ? v[i + h] : v[i];
    const uint32_t give = upper ? v[i] : v[i + h];
    v[i] = keep + __shfl_xor_sync(kFull, give, off);
  }
}

// The 17 sums over a warp: lane `lane` ends with the total of one index,
// returned (or -1 for a lane left holding padding), in v[0].
__device__ __forceinline__ int warp_totals(uint32_t (&v)[kSums + 1], int lane) {
  halve<17>(v, 16, lane & 16);
  halve<9>(v, 8, lane & 8);
  halve<5>(v, 4, lane & 4);
  halve<3>(v, 2, lane & 2);
  halve<2>(v, 1, lane & 1);
  const int j3 = ((lane & 2) ? 2 : 0) + (lane & 1);
  const int j2 = ((lane & 4) ? 3 : 0) + j3;
  const int j1 = ((lane & 8) ? 5 : 0) + j2;
  const int k = ((lane & 16) ? 9 : 0) + j1;
  return (j3 < 3 && j2 < 5 && j1 < 9 && k < kSums) ? k : -1;
}

// Long rows: one block per row; head sums (head > 0) from the same read.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
k_cost_block_per_row(const uint32_t* __restrict__ u, long long n, long long ld, long long head,
                     uint32_t* __restrict__ out_head, uint32_t* __restrict__ out) {
  __shared__ uint32_t part[2][kWarps][kSums];
  const long long row = blockIdx.x;
  const uint32_t* p = u + row * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t acc[kSums + 1];
#pragma unroll
  for (int k = 0; k <= kSums; ++k) acc[k] = 0u;
  if (head > 0) {  // the same for every thread of the grid
    accumulate_span<kVec>(p, 0, head, threadIdx.x, kThreads, acc);
    uint32_t hacc[kSums + 1];
#pragma unroll
    for (int k = 0; k < kSums; ++k) hacc[k] = acc[k];
    const int k = warp_totals(hacc, lane);
    if (k >= 0) part[0][warp][k] = hacc[0];
  }
  accumulate_span<kVec>(p, head, n, threadIdx.x, kThreads, acc);
  const int k = warp_totals(acc, lane);
  if (k >= 0) part[1][warp][k] = acc[0];
  __syncthreads();
  const int which = threadIdx.x >> 5;  // warp 0 writes the head sums, warp 1 the row sums
  if (which < 2 && lane < kSums && (which == 1 || head > 0)) {
    uint32_t s = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[which][w][lane];
    (which == 1 ? out : out_head)[row * kSums + lane] = s;
  }
}

// Short rows and partition segments: 8 lanes per segment, the orders
// folded in shared memory (see the header). out is (rows, 2^(levels+1) - 1,
// 17); a block takes one row, or 32 / 2^levels rows where a row has fewer
// segments than the block has groups.
template <int kBlock, bool kVec>
__global__ void __launch_bounds__(kBlock)
k_cost_tree(const uint32_t* __restrict__ u, long long rows, long long n, long long ld, int levels,
            uint32_t* __restrict__ out) {
  extern __shared__ uint32_t sums[];  // [rows of the block][entries][kSums]
  constexpr int kGroups = kBlock / kGroupLanes;
  const int nparts = 1 << levels;
  const int entries = 2 * nparts - 1;
  const long long seg = n >> levels;
  const int block_rows = nparts >= kGroups ? 1 : kGroups / nparts;
  const long long row0 = (long long)blockIdx.x * block_rows;
  const int nseg = block_rows * nparts;  // a multiple of kGroups: every group makes the same number of turns
  const int group = threadIdx.x / kGroupLanes, l = threadIdx.x % kGroupLanes;

  for (int sg = group; sg < nseg; sg += kGroups) {
    const int r = sg >> levels, s = sg & (nparts - 1);
    uint32_t acc[kSums + 1];
#pragma unroll
    for (int k = 0; k <= kSums; ++k) acc[k] = 0u;
    // a row past the end adds nothing, but its lanes stay in the shuffles
    if (row0 + r < rows) accumulate_span<kVec>(u + (row0 + r) * ld + s * seg, 0, seg, l, kGroupLanes, acc);
    halve<17>(acc, 4, l & 4);
    halve<9>(acc, 2, l & 2);
    halve<5>(acc, 1, l & 1);
    // acc[0..3) now hold the group's totals of indices base + 0..2
    uint32_t* dst = sums + ((long long)r * entries + (nparts - 1) + s) * kSums;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int j2 = ((l & 1) ? 3 : 0) + j;
      const int j1 = ((l & 2) ? 5 : 0) + j2;
      const int k = ((l & 4) ? 9 : 0) + j1;
      if (j2 < 5 && j1 < 9 && k < kSums) dst[k] = acc[j];
    }
  }
  __syncthreads();

  // fold: order p's part j is the sum of order p + 1's parts 2j and 2j + 1
  for (int p = levels - 1; p >= 0; --p) {
    const int np = 1 << p;
    const int count = block_rows * np * kSums;
    for (int t = threadIdx.x; t < count; t += kBlock) {
      const int k = t % kSums, e = t / kSums;
      const int r = e >> p, j = e & (np - 1);
      const uint32_t* child = sums + ((long long)r * entries + (2 * np - 1) + 2 * j) * kSums + k;
      sums[((long long)r * entries + (np - 1) + j) * kSums + k] = child[0] + child[kSums];
    }
    __syncthreads();
  }

  const long long live = rows - row0 < block_rows ? rows - row0 : block_rows;
  const long long count = live * entries * kSums;
  uint32_t* dst = out + row0 * entries * kSums;
  for (long long t = threadIdx.x; t < count; t += kBlock) dst[t] = sums[t];
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int kBlock>
int launch_tree(const uint32_t* u, long long rows, long long n, long long ld, int levels, uint32_t* out,
                cudaStream_t s) {
  const int nparts = 1 << levels;
  const int groups = kBlock / kGroupLanes;
  const int block_rows = nparts >= groups ? 1 : groups / nparts;
  const unsigned blocks = (unsigned)((rows + block_rows - 1) / block_rows);
  const size_t smem = (size_t)block_rows * (2 * nparts - 1) * kSums * sizeof(uint32_t);
  if (aligned16(u) && ld % 4 == 0 && (n >> levels) % 4 == 0) {
    k_cost_tree<kBlock, true><<<blocks, kBlock, smem, s>>>(u, rows, n, ld, levels, out);
  } else {
    k_cost_tree<kBlock, false><<<blocks, kBlock, smem, s>>>(u, rows, n, ld, levels, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (rows, 17): the row sums; out_head (rows, 17): the sums of each row's
// first `head` samples (head = 0: none, out_head unused).
extern "C" int lac_k_cost_sums(const void* u, long long rows, long long n, long long ld, long long head,
                               void* out_head, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (head < 0 || n < 0 || ld < n) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  if (head > n) head = n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(u);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (head == 0 && n <= 1024) return launch_tree<kThreads>(in, rows, n, ld, 0, o, s);
  uint32_t* oh = static_cast<uint32_t*>(out_head);
  if (aligned16(u) && ld % 4 == 0 && head % 4 == 0) {
    k_cost_block_per_row<true><<<(unsigned)rows, kThreads, 0, s>>>(in, n, ld, head, oh, o);
  } else {
    k_cost_block_per_row<false><<<(unsigned)rows, kThreads, 0, s>>>(in, n, ld, head, oh, o);
  }
  return (int)cudaGetLastError();
}

// out (rows, 2^(levels+1) - 1, 17): for every order p = 0..levels, at
// entries 2^p - 1 .. 2^(p+1) - 2, the sums of the row's 2^p equal parts.
// n must be a multiple of 2^levels, levels <= 8.
extern "C" int lac_k_cost_partition_sums(const void* u, long long rows, long long n, long long ld,
                                         long long levels, void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (levels < 0 || levels > kMaxLevels || n <= 0 || n % (1LL << levels) || ld < n) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(u);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (levels >= 6) return launch_tree<LAC_KCOST_TREE_BLOCK>(in, rows, n, ld, (int)levels, o, s);
  return launch_tree<kThreads>(in, rows, n, ld, (int)levels, o, s);
}
