"""Tensor helpers shared by the port's ops (lac_tpu/ops/_backend.py).

Unsigned 32-bit values (zigzag codes, u32 prefix sums) are carried in
``int64`` by plain code: torch's ``uint32`` has no ``>>``, ``>``, ``+``
or ``argmin``, and every total in the codec stays <= 2^46. Kernels take
the same codes as an ``int32`` view of the u32 bit pattern.
"""

import torch

U32_MASK = 0xFFFFFFFF


def u32_from_bits(x):
    """int32 bit pattern (or any integer tensor) -> its u32 value in int64."""
    return x.to(torch.int64) & U32_MASK


def shift_right(x, n, fill=0):
    """Shift along the last axis by ``n`` towards higher indices, filling
    with ``fill``."""
    if n == 0:
        return x
    out = torch.full_like(x, fill)
    if n < x.shape[-1]:
        out[..., n:] = x[..., :-n]
    return out


def cummax(x):
    """Running maximum along the last axis."""
    return torch.cummax(x, dim=-1).values


def cummin_reverse(x):
    """Running minimum from the right (suffix min) along the last axis."""
    return torch.flip(torch.cummin(torch.flip(x, (-1,)), dim=-1).values, (-1,))


def bit_width(m):
    """``std::bit_width`` of non-negative integers < 2^53 -> int32.

    The float64 exponent of an exactly converted integer is
    ``floor(log2 m) + 1`` (frexp mantissa in [0.5, 1)), the numpy arm of
    lac_tpu/ops/_backend.py:70-73; ``bit_width(0) == 0``.
    """
    _, e = torch.frexp(m.to(torch.float64))
    return torch.where(m == 0, 0, e).to(torch.int32)
