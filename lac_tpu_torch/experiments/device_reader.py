"""Static-Rice partitions parsed on the device (lac_tpu/ops/device_reader.py).

The decode twin of :mod:`.device_pack`, a measured experiment on no
product path: can the token parse, the reference's bit-serial hot loop
(reference block/decoder.cpp:104-306), run batched on the card? Only
static-mode partitions (one k for the whole segment, block/decoder.cpp:
296-303) parse as a pure function of the bits; adaptive modes need every
value decoded before them.

Two formulations:

* :func:`tokenize_static_rice`, no per-token loop, in torch ops: bytes
  become bit planes; ``nz[p]``, the first zero bit at or after ``p``, is a
  reverse running minimum; a token starting at ``p`` ends its unary run
  at ``nz[p]`` and the next starts at ``step[p] = nz[p] + 1 + k``, so the
  token starts are the orbit of 0 under ``step``, found by pointer
  doubling (``log2(max_tokens)`` rounds of ``J = J[J]``, gathers); the
  values come from ``q = nz[s] - s`` and the k remainder bits of a
  gathered 32-bit window, zigzag-decoded;
* ``tokenize_static_rice_scan`` (:func:`..ops.cuda_kernels.tokenize_static_rice_scan`),
  one step per token with every lane advancing together, each step
  loading one 64-bit window per lane: kernel 8 (``csrc/rice_scan.cu``,
  one thread per lane) on the card, its plain version on the CPU. Cap: a
  token must fit one window minus the byte offset, ``q + 1 + k <= 57``;
  past it the result is the reference's garbage.

Wire rules: MSB-first bit order (bit_reader.hpp:92-112), the static
field k (<= MAX_STATIC_K = 15, block/encoder.cpp:160-180), the zigzag map
(format.md:224-236).
"""

import numpy as np
import torch

from ..ops._backend import U32_MASK, cummin_reverse
from ..ops.cuda_kernels import tokenize_static_rice_scan  # noqa: F401  (the scan formulation: kernel 8)


def _bits_from_bytes(payload):
    """(L, NBY) uint8 -> (L, NBY*8) int32 bits, MSB-first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=payload.device)
    bits = (payload.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(payload.shape[0], payload.shape[1] * 8)


def _u32_shl(x, s):
    """u32 ``x << s`` of values held in int64; 0 for s >= 32, as XLA gives."""
    return torch.where(s < 32, (x << s.clamp(0, 31)) & U32_MASK, 0)


def tokenize_static_rice(payload, k, nbits, max_tokens):
    """Parse ``max_tokens`` static-k Rice tokens from each lane.

    ``payload``: (L, NBY) uint8 byte payloads (zero-padded; a zero byte past
    the stream parses as harmless garbage beyond ``max_tokens``). ``k``:
    (L,) int32 static Rice parameter per lane (0..15). ``nbits``: (L,) int32
    valid bit length per lane (token starts at or beyond it are invalid).

    Returns ``(residuals, starts, valid)``: (L, max_tokens) int32
    zigzag-decoded residuals, their bit offsets (int32), and a bool mask.
    """
    L, NBY = payload.shape
    if NBY < 4:  # the 32-bit remainder window
        raise ValueError(f"tokenize_static_rice: want payload rows of at least 4 bytes, got {NBY}")
    NB = NBY * 8
    dev = payload.device
    bits = _bits_from_bytes(payload)
    pos = torch.arange(NB, dtype=torch.int32, device=dev)
    # first zero at or after p (NB when the tail is all ones)
    nz = cummin_reverse(torch.where(bits == 0, pos[None, :], NB))
    # next-token-start map with a fixpoint cell at NB
    step = torch.clamp(nz + 1 + k[:, None], max=NB)
    step = torch.cat([step, torch.full((L, 1), NB, dtype=torch.int32, device=dev)], dim=1).to(torch.int64)

    # orbit of 0 under `step` by doubling start lists (list ranking)
    starts = torch.zeros((L, max_tokens), dtype=torch.int64, device=dev)
    size, J = 1, step
    while size < max_tokens:
        take = min(size, max_tokens - size)
        starts[:, size : size + take] = J.gather(1, starts[:, :take])
        size += take
        if size < max_tokens:
            J = J.gather(1, J)  # double the jump distance

    z = nz.to(torch.int64).gather(1, torch.clamp(starts, max=NB - 1))
    q = (z - starts) & U32_MASK  # u32
    # k remainder bits from a 32-bit window of 4 gathered bytes (an index
    # past the row clamps to its last byte, as JAX clamps a gather)
    bitpos = z + 1
    byteidx = torch.clamp(bitpos >> 3, max=NBY - 4)
    pj = payload.to(torch.int64)
    w = 0
    for j in range(4):
        w = (w << 8) | pj.gather(1, torch.clamp(byteidx + j, max=NBY - 1))
    off = bitpos - (byteidx << 3)
    kk = k.to(torch.int64)[:, None]
    shift = torch.clamp(32 - off - kk, min=0)
    rem = torch.where(shift < 32, w >> shift.clamp(max=31), 0) & (_u32_shl(torch.ones_like(kk), kk) - 1) & U32_MASK
    u = _u32_shl(q, kk) | rem
    r = (u >> 1) ^ torch.where((u & 1) != 0, U32_MASK, 0)
    res = (((r + (1 << 31)) & U32_MASK) - (1 << 31)).to(torch.int32)
    starts = starts.to(torch.int32)
    return res, starts, starts < nbits[:, None]


def _tokenize_np(payload, k, nbits, max_tokens):
    """Scalar spec twin (bit_reader.hpp:92-172 semantics, fixed k)."""
    L = payload.shape[0]
    res = np.zeros((L, max_tokens), np.int32)
    starts = np.zeros((L, max_tokens), np.int32)
    valid = np.zeros((L, max_tokens), bool)
    bits = np.unpackbits(payload, axis=1)
    for li in range(L):
        p = 0
        kk = int(k[li])
        for t in range(max_tokens):
            starts[li, t] = p
            valid[li, t] = p < int(nbits[li])
            q = 0
            while p < bits.shape[1] and bits[li, p]:
                q += 1
                p += 1
            p += 1  # stop bit
            rem = 0
            for _ in range(kk):
                rem = (rem << 1) | (int(bits[li, p]) if p < bits.shape[1] else 0)
                p += 1
            u = (q << kk) | rem
            res[li, t] = (u >> 1) ^ -(u & 1)
            if p >= bits.shape[1]:
                p = bits.shape[1]
    return res, starts, valid


def encode_static_rice_np(residuals, k):
    """Build the wire bytes for a static-k Rice token stream (test +
    bench fixture helper; matches rice.cpp:17-32 emission for k<=15)."""
    out = []
    nbits = 0
    acc = 0
    accn = 0
    for v in residuals:
        u = (int(v) << 1) ^ (int(v) >> 31) if v < 0 else (int(v) << 1)
        u &= 0xFFFFFFFF
        q = u >> k
        for chunk, chunkbits in ((0xFFFFFFFF, 32),) * (q // 32) + ((
            (1 << (q % 32)) - 1, q % 32),):
            acc = (acc << chunkbits) | chunk
            accn += chunkbits
            while accn >= 8:
                out.append((acc >> (accn - 8)) & 0xFF)
                accn -= 8
        acc = (acc << (k + 1)) | (u & ((1 << k) - 1))
        accn += k + 1
        nbits += q + 1 + k
        while accn >= 8:
            out.append((acc >> (accn - 8)) & 0xFF)
            accn -= 8
    if accn:
        out.append((acc << (8 - accn)) & 0xFF)
    return np.asarray(out, np.uint8), nbits
