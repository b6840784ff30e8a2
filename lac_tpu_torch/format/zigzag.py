"""Zigzag signed <-> unsigned residual mapping (lac_tpu/format/zigzag.py,
format.md:222-236): on tensors for the planner, on ints for the
decoder's token reader."""

import torch


def zigzag_encode(v):
    """int32 residuals -> u32 codes carried in int64:
    ``(v << 1) ^ (v >> 63)`` is ``2v`` for v >= 0 and ``-2v - 1`` below,
    i.e. ``(u32(v) << 1) ^ (v < 0 ? ~0 : 0)`` for every int32 ``v``."""
    v64 = v.to(torch.int64)
    return (v64 << 1) ^ (v64 >> 63)


def zigzag_decode(u: int) -> int:
    """u32 code -> signed residual: ``(u >> 1) ^ -(u & 1)``."""
    half = u >> 1
    return half if (u & 1) == 0 else -(half + 1)
