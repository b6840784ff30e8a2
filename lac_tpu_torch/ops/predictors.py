"""Open-loop predictor residuals on tensors (lac_tpu/ops/predictors.py:36-73).

Fixed orders 0-4 (binomial differencing, raw warmup samples), FIR taps
{3,-1} >> 2, and the Q15 LPC dot over preceding original samples with
its int32 in-range flag. Restore (decode) is not part of the port yet.
"""

import torch

from lac_tpu.format import constants as C

from ._backend import shift_right

_FIXED_STENCILS = {
    0: (1,),
    1: (1, -1),
    2: (1, -2, 1),
    3: (1, -3, 3, -1),
    4: (1, -4, 6, -4, 1),
}


def fixed_residual(x, order):
    """Fixed-order residual; first ``order`` samples are raw (int32 in/out)."""
    x64 = x.to(torch.int64)
    acc = torch.zeros_like(x64)
    for i, w in enumerate(_FIXED_STENCILS[order]):
        acc += w * shift_right(x64, i)
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(idx < order, x64, acc).to(torch.int32)


def fir_residual(x):
    """FIR taps {3,-1} >> 2 residual; first 2 samples raw."""
    x64 = x.to(torch.int64)
    pred = (C.FIR_TAPS[0] * shift_right(x64, 1) + C.FIR_TAPS[1] * shift_right(x64, 2)) >> C.FIR_SHIFT
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(idx < C.FIR_ORDER, x64, x64 - pred).to(torch.int32)


def lpc_residual(x, coeffs_q15, order):
    """Open-loop LPC residual (lpc.cpp:38-61).

    ``coeffs_q15``: (..., order+1) int16-valued, index 0 unused.
    Returns (residual int32, in_range bool): ``in_range`` is False when
    any open-loop difference leaves int32 (the host then walks the
    fallback order ladder, lpc.cpp:188-229).
    """
    x64 = x.to(torch.int64)
    acc = torch.zeros_like(x64)
    for i in range(1, order + 1):
        acc += coeffs_q15[..., i, None].to(torch.int64) * shift_right(x64, i)
    diff = x64 - (acc >> 15)
    in_range = ((diff >= C.INT32_MIN) & (diff <= C.INT32_MAX)).all(dim=-1)
    return diff.to(torch.int32), in_range
