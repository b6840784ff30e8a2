"""Mid/side transform + per-block stereo proxy decision
(lac_tpu/ops/stereo.py:21-131, lac/encoder.cpp:104-197).

On tensors for the plane pipeline; on numpy channels for the host route
(``*_host``) and the decoder (:func:`ms_inverse`).
"""

import numpy as np
import torch

from ..format import constants as C

from ._backend import bit_width, shift_right


def ms_transform(left, right):
    """-> (mid, side) int32: ``mid = (l + r) >> 1``, ``side = l - r``."""
    l64 = left.to(torch.int64)
    r64 = right.to(torch.int64)
    return ((l64 + r64) >> 1).to(torch.int32), (l64 - r64).to(torch.int32)


def ms_transform_host(left, right):
    """numpy channels -> (mid, side) int32 numpy arrays."""
    mid, side = ms_transform(torch.from_numpy(np.asarray(left)), torch.from_numpy(np.asarray(right)))
    return mid.numpy(), side.numpy()


def ms_inverse(mid, side):
    """numpy (mid, side) -> (left, right) int64 (format.md:96-100;
    lac/decoder.cpp:48-65)."""
    m = np.asarray(mid, dtype=np.int64)
    s = np.asarray(side, dtype=np.int64)
    left = m + ((s + (s & 1)) >> 1)
    return left, left - s


def _zigzag_mag(v):
    """``2|v| - (v < 0)`` (lac/encoder.cpp:38-41); <= 2^27 for valid PCM."""
    return (v.abs() << 1) - (v < 0).to(v.dtype)


def _approx_rice_bits(total, count):
    """approximate_rice_bits (lac/encoder.cpp:53-57) in int64; ``//``
    only ever sees non-negative operands."""
    mean = (total + (count >> 1)) // count.clamp(min=1)
    k = torch.where(mean <= 1, 0, bit_width(mean - 1).clamp(max=C.MAX_RICE_K)).to(torch.int64)
    bits = (total >> k) + count * (k + 1)
    return torch.where(count > 0, bits, 0)


def _channel_proxy(raw_sum, diff_sum, anti_sum, count):
    raw_bits = _approx_rice_bits(raw_sum, count)
    diff_bits = _approx_rice_bits(diff_sum, count)
    anti_bits = _approx_rice_bits(anti_sum, count)
    bits = torch.minimum(torch.minimum(raw_bits, diff_bits), anti_bits)
    non_diff = (raw_bits < diff_bits) | (anti_bits < diff_bits)
    return bits, non_diff


def estimate_stereo_mode(left, right, valid):
    """Per-lane stereo decision (lac/encoder.cpp:126-197).

    ``left``/``right``: (..., L) integer PCM; ``valid``: bool mask of the
    same shape. Returns (choose_ms, uncertain) bool tensors of the
    leading shape. Sums are int64 over int32 elementwise math.
    """
    l32 = left.to(torch.int32)
    r32 = right.to(torch.int32)
    m32 = (l32 + r32) >> 1
    s32 = l32 - r32
    w = valid.to(torch.int64)
    count = w.sum(dim=-1)
    first = torch.arange(left.shape[-1], device=left.device) == 0

    bits, non_diff_any = {}, None
    for name, ch in (("l", l32), ("r", r32), ("m", m32), ("s", s32)):
        prev = shift_right(ch, 1)
        raw = _zigzag_mag(ch)
        diff = torch.where(first, raw, _zigzag_mag(ch - prev))
        anti = torch.where(first, raw, _zigzag_mag(ch + prev))
        sums = [(a * w).sum(dim=-1) for a in (raw, diff, anti)]
        bits[name], nd = _channel_proxy(*sums, count)
        non_diff_any = nd if non_diff_any is None else (non_diff_any | nd)

    lr_bits = bits["l"] + bits["r"]
    ms_bits = bits["m"] + bits["s"]
    smaller = torch.minimum(lr_bits, ms_bits)
    difference = (lr_bits - ms_bits).abs()
    choose_ms = ms_bits < lr_bits
    uncertain = (
        (smaller == 0)
        | (difference == 0)
        | non_diff_any
        | (difference <= smaller // C.STEREO_CONFIDENCE_DIVISOR)
    )
    return choose_ms, uncertain


def estimate_stereo_mode_host(left, right):
    """Stereo decision of one block of any size from numpy channels:
    (choose_ms, uncertain) bools (the host route's odd-sized blocks)."""
    lt = torch.from_numpy(np.ascontiguousarray(left, dtype=np.int32))[None]
    rt = torch.from_numpy(np.ascontiguousarray(right, dtype=np.int32))[None]
    cm, un = estimate_stereo_mode(lt, rt, torch.ones_like(lt, dtype=torch.bool))
    return bool(cm[0]), bool(un[0])
