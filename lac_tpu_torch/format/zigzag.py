"""Zigzag signed -> unsigned residual mapping on tensors
(lac_tpu/format/zigzag.py:12-18, format.md:222-236)."""

import torch


def zigzag_encode(v):
    """int32 residuals -> u32 codes carried in int64:
    ``(v << 1) ^ (v >> 63)`` is ``2v`` for v >= 0 and ``-2v - 1`` below,
    i.e. ``(u32(v) << 1) ^ (v < 0 ? ~0 : 0)`` for every int32 ``v``."""
    v64 = v.to(torch.int64)
    return (v64 << 1) ^ (v64 >> 63)
