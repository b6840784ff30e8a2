"""Predictor residuals and reconstruction (lac_tpu/ops/predictors.py).

Encode side, on tensors (predictors.py:36-73): fixed orders 0-4
(binomial differencing, raw warmup samples), FIR taps {3,-1} >> 2, and
the Q15 LPC dot over preceding original samples with its int32
in-range flag; and, in numpy for one lane on the host,
:func:`lpc_ladder_order`, the order ladder of a lane whose LPC residual
leaves int32.

Decode side (predictors.py:116-240): numpy on the host for the
decoder's Python block reader, which restores one block at a time and
gives the canonical error messages; and :func:`fixed_restore_multi`, the
device decode backend's batched fixed-order restore, on tensors. The
backend's FIR/LPC restore is kernel 7 (:func:`.cuda_kernels.recurrence_restore`).
"""

import numpy as np
import torch

from ..format import constants as C

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


# --------------------------------------------------------------------- decode

# bound on any intermediate difference order of an int32-valued sequence:
# |delta^m x| <= 2^(31+m) <= 2^36 for m <= 5; beyond it the final samples
# cannot all fit int32, so the reference would reject too.
_STAGE_BOUND = 1 << 37


def lpc_ladder_order(x, coeffs_q15, start_order, max_order):
    """Walk the residual-overflow fallback ladder for one lane, in numpy
    int64 (lac_tpu/ops/predictors.py:76; reference ``compute_residual_q15``,
    lpc.cpp:188-229, through build_residual_attempt_orders, lpc.cpp:24-36):
    try ``start_order``, then each ladder order below it, then 0. Returns
    the first order whose open-loop residual stays in int32 (0: the
    candidate is dropped, block/encoder.cpp:401-403).

    Zeroing ``coeffs_q15[o+1:]`` afterwards makes the full-order residual
    the ``o``-tap residual (warmup taps already clamp to ``min(order,
    n)``), so the planner can score truncated coefficient sets as they are.
    """
    start_order = max(0, min(int(start_order), int(max_order)))
    attempts = [start_order]
    attempts += [o for o in C.LPC_FALLBACK_ORDERS if o < start_order and o <= max_order]
    attempts.append(0)
    x64 = np.asarray(x, dtype=np.int64)
    for o in attempts:
        if o <= 0:
            return 0
        acc = np.zeros_like(x64)
        for i in range(1, o + 1):
            acc[i:] += int(coeffs_q15[i]) * x64[:-i]
        diff = x64 - (acc >> 15)
        if diff.size == 0 or (diff.min() >= C.INT32_MIN and diff.max() <= C.INT32_MAX):
            return o
    return 0


def _in_int32(y):
    return (y >= C.INT32_MIN) & (y <= C.INT32_MAX)


def fixed_restore(res, order):
    """Invert a fixed-order predictor via repeated prefix sums.

    ``res``: (..., L) residuals (warmup entries raw). Returns (samples
    int64, ok bool (...,)); ``ok`` is False when reconstruction leaves
    int32 anywhere (block/decoder.cpp:308-342 rejects on the first such
    step; acceptance is equivalent).
    """
    y = np.asarray(res).astype(np.int64)
    if order == 0:
        return y, _in_int32(y).all(axis=-1)
    # map raw warmup samples into the zero-extended difference domain
    L = y.shape[-1]
    warm = np.zeros_like(y)
    for i, wi in enumerate(_FIXED_STENCILS[order][:L]):
        warm[..., i:] += wi * y[..., : L - i]
    idx = np.arange(L)
    y = np.where(idx < order, warm, y)
    ok = np.ones(y.shape[:-1], dtype=bool)
    for _ in range(order):
        y = np.cumsum(y, axis=-1)
        ok &= (np.abs(y) <= _STAGE_BOUND).all(axis=-1)
    return y, ok & _in_int32(y).all(axis=-1)


def _recurrence_restore(res, taps, shift, min_pred_n):
    """Closed-loop restore of (..., L) residuals, one row at a time:
    ``x[n] = r[n] + (sum_i taps[i-1] * x[n-i] >> shift)`` over the
    ``min(n, len(taps))`` available taps, from ``n >= min_pred_n``."""
    y = np.asarray(res).astype(np.int64).copy()
    flat = y.reshape(-1, y.shape[-1])
    ok = np.ones(flat.shape[0], dtype=bool)
    for row in range(flat.shape[0]):
        r = flat[row]
        for n in range(min_pred_n, r.shape[0]):
            acc = sum(int(taps[i - 1]) * int(r[n - i]) for i in range(1, min(len(taps), n) + 1))
            s = int(r[n]) + (acc >> shift)
            if s < C.INT32_MIN or s > C.INT32_MAX:
                ok[row] = False
                break
            r[n] = s
    return y, ok.reshape(y.shape[:-1])


def fir_restore(res):
    """Closed-loop FIR reconstruction (block/decoder.cpp:344-358)."""
    return _recurrence_restore(res, C.FIR_TAPS, C.FIR_SHIFT, C.FIR_ORDER)


def lpc_restore(res, coeffs_q15, order):
    """Closed-loop LPC reconstruction of one lane (block/decoder.cpp:360-403);
    ``coeffs_q15``: (order+1,) with index 0 unused."""
    return _recurrence_restore(res, np.asarray(coeffs_q15)[1 : order + 1], 15, 0)


def fixed_restore_multi(res, order, valid_len=None):
    """Fixed-order restore of many lanes with a *per-lane* order (0..4), in
    torch operations on the lanes' device (predictors.py:202-240): the
    warmup maps each lane's raw samples through its own stencil row, then
    four masked ``cumsum`` rounds apply ``order[l]`` prefix sums to lane
    ``l``. Same acceptance as per-order :func:`fixed_restore`.

    ``res``: (G, L) integer residuals; ``order``, ``valid_len`` (None: L):
    (G,). Returns (samples int64 (G, L), ok bool (G,)).
    """
    y = res.to(torch.int64)
    G, L = y.shape
    dev = y.device
    od = order.to(dev, torch.int64)
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    nv = torch.full((G,), L, dtype=torch.int64, device=dev) if valid_len is None else valid_len.to(dev, torch.int64)
    vmask = idx[None, :] < nv[:, None]

    table = torch.zeros((5, 5), dtype=torch.int64)
    for o, w in _FIXED_STENCILS.items():
        table[o, : len(w)] = torch.tensor(w)
    w_lane = table.to(dev)[od]  # (G, 5) stencil row of each lane
    warm = torch.zeros_like(y)
    for i in range(5):
        warm += w_lane[:, i : i + 1] * shift_right(y, i)
    y = torch.where(idx[None, :] < od[:, None], warm, y)

    ok = torch.ones((G,), dtype=torch.bool, device=dev)
    for r in range(4):
        active = od > r
        y = torch.where(active[:, None], torch.cumsum(torch.where(vmask, y, 0), dim=-1), y)
        ok &= torch.where(vmask, y.abs() <= _STAGE_BOUND, True).all(dim=-1) | ~active
    return y, ok & torch.where(vmask, _in_int32(y), True).all(dim=-1)
