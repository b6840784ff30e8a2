"""The token body packed on the device: prefix-sum bit offsets and word
scatter-adds, in torch (lac_tpu/ops/device_pack.py).

The host emitter (``lac_emit_blocks_planes``, runtime/src/lac_runtime.cpp)
packs each lane's token stream serially; this is the array-program
formulation of the same emission, a measured experiment on no product
path: element bit lengths prefix-sum into bit offsets, and every element's
bits land in the output words by a bounded number of scatter-adds. The
packed words are bit-identical to ``bitio.pack.pack_stream`` and the
native BitSink.

Element model (as bitio/pack.py): each element is ``unary`` ONE bits
followed by a ``fl``-bit MSB-first field holding ``fv``. A Rice token is
one element: ``unary=q, fl=k+1, fv=remainder`` (the field's leading 0 is
the stop bit; reference rice.cpp:17-32).

Word decomposition (the regions of distinct elements are disjoint, so
scatter-adds compose them without carries):

* field: lands in at most two consecutive words, placed as the two 32-bit
  halves of a 64-bit window;
* unary run [a, b): a partial head word, a span of full 0xFFFFFFFF words
  and a partial tail word. The full span is a range update, +1/-1 into a
  per-word delta array whose prefix sum marks fully covered words, so a
  run longer than 64 bits is never a shift.

u32 words and u64 values are held in int64 (torch has no u64 ``<<`` or
``>>``); ``index_add_`` on int64 is exact in any order. Bit 0 of the stream
is the MSB of word 0 (the native BitSink's bswap32 store order).
"""

import math

import torch

from ..format.zigzag import zigzag_encode
from ..ops._backend import U32_MASK


def words_capacity(max_bits):
    """Output words for a lane whose stream is at most ``max_bits``."""
    return (int(max_bits) + 31) // 32


def _scat(flat, idx, val):
    """``flat[idx] += val``, dropping indices past the end (only zero
    contributions land there: the field low half of a stream that ends
    exactly at 32*W), as the reference's ``mode="drop"``."""
    idx, val = idx.reshape(-1), val.reshape(-1)
    ok = idx < flat.shape[0]
    flat.index_add_(0, idx[ok], val[ok])


def pack_elements(unary, fv, fl, W):
    """Pack element batches into u32 words, MSB-first.

    ``unary``: (..., M) integer leading one-bit counts (>= 0, may exceed 64).
    ``fv``: (..., M) integer field values (< 2**fl, u32).
    ``fl``: (..., M) integer field lengths in [0, 32].
    ``W``: output width in words; bits beyond 32*W must be absent.
    Padding elements are ``unary=0, fl=0``.

    Returns ``(words, total_bits)``: (..., W) int64 holding u32 words and
    (...,) int32.
    """
    lead = tuple(unary.shape[:-1])
    dev = unary.device
    if unary.shape[-1] == 0:
        return (torch.zeros(lead + (W,), dtype=torch.int64, device=dev),
                torch.zeros(lead, dtype=torch.int32, device=dev))
    M = unary.shape[-1]
    B = math.prod(lead)
    unary = unary.to(torch.int64).reshape(B, M)
    fl = fl.to(torch.int64).reshape(B, M)
    fv = fv.to(torch.int64).reshape(B, M)
    elem = unary + fl
    off = torch.cumsum(elem, dim=-1) - elem  # exclusive prefix sum
    total_bits = (off[:, -1] + elem[:, -1]).to(torch.int32)

    W1 = W + 1  # +1 word absorbs the zero spill of field low halves
    lane = torch.arange(B, dtype=torch.int64, device=dev)[:, None] * W1
    flat = torch.zeros(B * W1, dtype=torch.int64, device=dev)

    # ---- fields: bits [sh, sh + fl) of the window over words [w, w + 1]
    s = off + unary
    w = s >> 5
    end = (s & 31) + fl  # <= 63
    hi = torch.where(end <= 32, fv << (32 - end).clamp(min=0), fv >> (end - 32).clamp(min=0)) & U32_MASK
    lo = torch.where(end > 32, (fv << (64 - end).clamp(max=63)) & U32_MASK, 0)
    live = fl > 0
    _scat(flat, lane + w, torch.where(live, hi, 0))
    _scat(flat, lane + w + 1, torch.where(live, lo, 0))

    # ---- unary runs [a, b): head word, full span, tail word
    a, b = off, off + unary
    wa, wb = a >> 5, b >> 5
    abit = a & 31
    len_h = torch.minimum(unary, 32 - abit)
    mask_h = (((1 << len_h) - 1) << (32 - abit - len_h)) & U32_MASK
    _scat(flat, lane + wa, torch.where(len_h > 0, mask_h, 0))
    len_t = b & 31
    mask_t = (U32_MASK << torch.where(len_t > 0, 32 - len_t, 0)) & U32_MASK
    _scat(flat, lane + wb, torch.where((wb > wa) & (len_t > 0), mask_t, 0))

    # full-word span [wa + 1, wb): +1/-1 range update and a prefix sum per
    # lane. A run that ends in its first word lands d[wa + 1] += 1 and
    # d[wa or wa + 1] -= 1: net zero from wa + 1 on, and the -1 at wa never
    # flips a word of a disjoint run.
    delta = torch.zeros(B * W1 + 1, dtype=torch.int64, device=dev)
    _scat(delta, lane + wa + 1, torch.ones_like(wa))
    _scat(delta, lane + wb, -torch.ones_like(wb))
    cover = torch.cumsum(delta[:-1].reshape(B, W1), dim=-1) > 0
    words = (flat.reshape(B, W1) & U32_MASK) | torch.where(cover, U32_MASK, 0)
    return words[:, :W].reshape(lead + (W,)), total_bits.reshape(lead)


def rice_elements(u, k_used):
    """Per-sample Rice token elements (modes 0 and 3; format.md §5.1).

    ``u``: (..., L) integer zigzag codes (u32 values); ``k_used``: (..., L)
    integer per-sample encoding k (0..31). Returns (unary, fv, fl), int64.
    The emitter computes ``q = u >> k`` for every k <= 31 (reference
    rice.cpp:17-32)."""
    u = u.to(torch.int64)
    k = k_used.to(torch.int64)
    return u >> k, u & ((1 << k) - 1), k + 1


def zigzag(res):
    """Signed int32 residuals -> u32 codes in int64 (format.md §5.2)."""
    return zigzag_encode(res)


def pack_rice_lanes(u, k_used, W):
    """Pack whole Rice-coded lanes (one token per sample) into words:
    (words, total_bits) of :func:`pack_elements`."""
    return pack_elements(*rice_elements(u, k_used), W)


def words_to_bytes(words, total_bits):
    """One lane's (W,) u32 words (int64, on the host) -> its stream bytes."""
    nb = (int(total_bits) + 7) // 8
    return words.numpy().astype(">u4").tobytes()[:nb]
