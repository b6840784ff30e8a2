// k-cost row reduction for the Rice cost stacks of the planner.
//
// Replaces lac_tpu/ops/pallas_kernels.py:k_cost_sums (body `_kernel`).
// For every row of u32 zigzag codes it computes 17 sums in one pass:
//   out[row, 0]     = sum(u >> 16)
//   out[row, 1 + k] = sum((u & 0xFFFF) >> k),  k = 0..15
// in wrapping uint32 arithmetic (every sum on the planner's path is
// <= 2^30: at most 16384 samples of 16-bit halves).
//
// Bound: device-memory bandwidth. The (B*11, 16384) code stack is read
// exactly once (4 bytes per sample) against 17 shift+add pairs, far
// below Hopper's integer rate. Threads read neighbouring addresses
// (coalesced), keep the 17 accumulators in registers, and reduce them
// with warp shuffles; the TPU's 17 where-selects into a 128-lane output
// tile have no counterpart here. Short rows (probe heads, fine
// partitions: n <= 1024) get one warp each so a block is never mostly
// idle; long rows get a whole block.
//
// Rows may be a strided view: row r starts at u + r * ld (ld >= n).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 17;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void accumulate(uint32_t u, uint32_t (&acc)[kSums]) {
  acc[0] += u >> 16;
  const uint32_t lo = u & 0xFFFFu;
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k + 1] += lo >> k;
}

__device__ __forceinline__ void warp_reduce(uint32_t (&acc)[kSums]) {
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(kFull, acc[k], off);
  }
}

__global__ void __launch_bounds__(kThreads)
k_cost_block_per_row(const uint32_t* __restrict__ u, long long n, long long ld,
                     uint32_t* __restrict__ out) {
  __shared__ uint32_t part[kWarps][kSums];
  const long long row = blockIdx.x;
  const uint32_t* p = u + row * ld;
  uint32_t acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0u;
  for (long long i = threadIdx.x; i < n; i += kThreads) accumulate(p[i], acc);
  warp_reduce(acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    uint32_t s = 0u;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    out[row * kSums + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
k_cost_warp_per_row(const uint32_t* __restrict__ u, long long rows, long long n, long long ld,
                    uint32_t* __restrict__ out) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together: the shuffles below stay full-mask
  const uint32_t* p = u + row * ld;
  uint32_t acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0u;
  for (long long i = lane; i < n; i += 32) accumulate(p[i], acc);
  warp_reduce(acc);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) out[row * kSums + k] = acc[k];
  }
}

}  // namespace

extern "C" int lac_k_cost_sums(const void* u, long long rows, long long n, long long ld,
                               void* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* in = static_cast<const uint32_t*>(u);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (n <= 1024) {
    const long long blocks = (rows + kWarps - 1) / kWarps;
    k_cost_warp_per_row<<<(unsigned)blocks, kThreads, 0, s>>>(in, rows, n, ld, o);
  } else {
    k_cost_block_per_row<<<(unsigned)rows, kThreads, 0, s>>>(in, n, ld, o);
  }
  return (int)cudaGetLastError();
}
