// Static-Rice scan tokenizer of the device bit-reader experiment: one
// thread per lane walks its lane's token stream, one token a step.
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
// Bound on this card: each step needs the position the step before it
// found, so a lane is one dependent chain of T steps (load, clz, shifts,
// add); the lanes are independent. With a few hundred lanes the time is T
// times one step's latency, far above the bytes bound (payload in, (L, T)
// int32 and bool out). The design is the simple one: one thread per lane,
// one warp per block (lanes spread over as many SMs as there are warps, so
// each SM's L1 holds the rows of 32 lanes), the 8-byte window loaded as 8
// bytes through L1, the outputs stored per thread straight to (lane, t):
// strided by T across a warp. A (T, L) store transposed after, and a window
// kept in registers, are the next steps.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;  // lanes (threads) a block

__device__ __forceinline__ uint64_t shl64(uint64_t x, uint64_t s) { return s < 64 ? x << s : 0; }
__device__ __forceinline__ uint64_t shr64(uint64_t x, uint64_t s) { return s < 64 ? x >> s : 0; }
__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) { return a < b ? a : b; }

__global__ void __launch_bounds__(kLanes) rice_scan_kernel(const uint8_t* __restrict__ payload, long long lanes,
                                                            long long nby, const int32_t* __restrict__ k,
                                                            const int32_t* __restrict__ nbits, long long tokens,
                                                            int32_t* __restrict__ res, uint8_t* __restrict__ valid) {
  const long long lane = static_cast<long long>(blockIdx.x) * kLanes + threadIdx.x;
  if (lane >= lanes) return;
  const uint8_t* row = payload + lane * nby;
  // int32 -> u64 as numpy's astype takes it: sign-extended, so a negative k is huge
  const uint64_t kk = static_cast<uint64_t>(static_cast<int64_t>(k[lane]));
  const int32_t nb = nbits[lane];
  const uint64_t last = static_cast<uint64_t>(nby - 1);
  const uint64_t lim = nby > 8 ? static_cast<uint64_t>(nby - 8) : 0;
  int32_t* out = res + lane * tokens;
  uint8_t* ok = valid + lane * tokens;
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
    out[t] = static_cast<int32_t>((u >> 1) ^ (0u - (u & 1u)));
    ok[t] = static_cast<int32_t>(static_cast<uint32_t>(pos)) < nb;
    pos += q + 1 + kk;
  }
}

}  // namespace

// payload (lanes, nby) uint8, k and nbits (lanes,) int32 -> res (lanes, tokens)
// int32 and valid (lanes, tokens) bool, all contiguous. Returns a cudaError_t.
extern "C" int lac_rice_scan_tokenize(const void* payload, long long lanes, long long nby, const void* k,
                                      const void* nbits, long long tokens, void* res, void* valid, void* stream,
                                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 0 || tokens < 0 || nby < 1 || lanes > 0x7FFFFFFFLL * kLanes) return (int)cudaErrorInvalidValue;
  if (lanes == 0 || tokens == 0) return 0;
  const unsigned blocks = (unsigned)((lanes + kLanes - 1) / kLanes);
  rice_scan_kernel<<<blocks, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), lanes, nby, static_cast<const int32_t*>(k),
      static_cast<const int32_t*>(nbits), tokens, static_cast<int32_t*>(res), static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}
