"""Closed-form Rice k-adaptation sequences on tensors (lac_tpu/ops/adapt.py:29-196).

The adaptation state is a pure function of the history of unsigned
residuals, so the whole k sequence is prefix sums plus elementwise
integer math. u32/u64 quantities are carried in int64 (every total is
<= 2^46). On the card, full-width rows (2048 <= n <= 16384, n % 2048 ==
0) take the fused stateful-adapter kernel; other rows take the split
chain, whose two prefix scans run in the split-cumsum and cumsum
kernels (:mod:`.cuda_kernels`).
"""

import math

import torch

from ..format import constants as C
from ._backend import bit_width, shift_right, u32_from_bits
from .cuda_kernels import cumsum_u32, k_after_shape_supported, k_after_stateful_fused, split_cumsums_u32


def _k_base_divfree(N, c, bwc):
    """``min(31, bit_width(mean - 1))`` for ``mean = floor(N/c) >= 2``
    without a division: ``bit_width(mean-1) <= t <=> (N - c) >> t < c``,
    and the smallest such ``t`` is ``bit_width(N-c) - bit_width(c)`` or
    one more (lac_tpu/ops/adapt.py:29-49). ``bwc`` is ``bit_width(c)``.
    Callers gate the ``mean <= 1`` region themselves."""
    M = torch.clamp(N - c, min=1)
    k0 = torch.clamp(bit_width(M) - bwc, min=0)
    q0 = M >> k0
    return torch.clamp(k0 + (q0 >= c).to(torch.int32), max=C.MAX_RICE_K)


def _floordiv3(x):
    """Exact ``floor(x/3)`` for ``0 <= x < 2^35``, division-free
    (lac_tpu/ops/adapt.py:52-63)."""
    xh = x >> 16
    y = xh + (x & 0xFFFF)
    return xh * 21845 + ((y * 699051) >> 21)


def k_after_stateless(seg_sum, pos_in_seg):
    """Stateless adapted k after each sample (block/encoder.cpp:72-77).

    ``seg_sum``: segment-local inclusive prefix sums of u (int64).
    ``pos_in_seg``: 0-based position within the segment (integer tensor).
    """
    count = pos_in_seg.to(torch.int64) + 1
    N = seg_sum + (count >> 1)
    return torch.where(N < (count << 1), 0, _k_base_divfree(N, count, bit_width(count))).to(torch.int32)


def k_after_stateful(u32):
    """Stateful adapted k after each sample of a whole block (rice.hpp:45-114).

    ``u32``: (..., L) int32 view of the u32 codes. Returns int32 (..., L).
    """
    L = u32.shape[-1]
    rows = u32.reshape(math.prod(u32.shape[:-1]), L)
    if u32.is_cuda and k_after_shape_supported(L):
        return k_after_stateful_fused(rows).reshape(u32.shape)
    return k_after_chain(rows, split_cumsums_u32, cumsum_u32).reshape(u32.shape)


def k_after_chain(u32_rows, split_cumsums, cumsum):
    """The stateful adapter as a chain of two prefix scans (given as
    functions of (rows, L) int32) and elementwise torch ops between them."""
    L = u32_rows.shape[-1]
    dev = u32_rows.device
    # prefix sums from the 16-bit-split u32 scans
    cs_hi, cs_lo = split_cumsums(u32_rows)
    s = (u32_from_bits(cs_hi) << 16) + u32_from_bits(cs_lo)
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    count = idx + 1
    bwc = bit_width(count)

    N = s + (count >> 1)
    k_base = torch.where(N < (count << 1), 0, _k_base_divfree(N, count, bwc)).to(torch.int32)

    # drift-window bias (count > 256 regime; identically 0 below)
    window_sum = s - shift_right(s, C.DRIFT_WINDOW)
    lm = (window_sum + (C.DRIFT_WINDOW >> 1)) >> 8
    t1 = ((3 * lm - 1) >> 2) + 1  # meaningless at lm == 0; gated by lm >= 1
    cond_up = (lm >= 1) & (N < count * t1)
    t2 = _floordiv3(4 * lm + 3) + 1
    cond_down = N >= count * t2
    drift_on = (idx >= C.DRIFT_WINDOW) & (N >= count)
    bias = torch.where(
        drift_on & cond_up, 1, torch.where(drift_on & ~cond_up & cond_down, -1, 0)
    ).to(torch.int32)

    # micro window: both flag counts ride one u32 scan, is_large in the
    # low 16 bits and is_zero in the high 16 (L < 2^16)
    u = u32_from_bits(u32_rows)
    q_base = torch.where(k_base >= C.MAX_RICE_K, 0, u >> k_base)
    packed = (q_base > 3).to(torch.int32) + ((q_base == 0).to(torch.int32) << 16)
    cp = u32_from_bits(cumsum(packed))
    wp = cp - shift_right(cp, C.MICRO_WINDOW)
    large_cnt = wp & 0xFFFF
    zero_cnt = wp >> 16
    trigger = count >= C.MICRO_WINDOW
    wsize = torch.clamp(count, max=C.MICRO_WINDOW)
    cond_large = large_cnt * 4 >= wsize * 3
    cond_zero = zero_cnt * 5 >= wsize * 4
    bias = torch.where(
        trigger & cond_large,
        torch.clamp(bias + 1, max=1),
        torch.where(trigger & ~cond_large & cond_zero, torch.clamp(bias - 1, min=-1), bias),
    )
    return torch.clamp(k_base + bias, 0, C.MAX_RICE_K).to(torch.int32)


def k_used_from_after(k_after, initial_k):
    """Shift the post-sample k sequence into the pre-sample (encoding) k;
    ``initial_k`` (leading shape) is the k of each row's first sample."""
    shifted = shift_right(k_after, 1)
    shifted[..., 0] = initial_k
    return shifted.to(torch.int32)
