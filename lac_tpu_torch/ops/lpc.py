"""Exact autocorrelation lags on tensors (lac_tpu/ops/lpc.py:41-54).

The lags feed the host's 80-bit Levinson-Durbin
(``lac_tpu.ops.lpc.levinson_durbin_snapshots``, shared, not ported), so
they must be exact: int64 products and sums (|R| < 2^60 for 24-bit
blocks). The JAX package's bf16-limb Gram form (lpc.py:64-134) is exact
only with fp32 accumulation, which cuBLAS bf16 GEMMs need not keep
(``allow_bf16_reduced_precision_reduction``); the int64 form is exact on
any device.
"""

import torch


def autocorrelation(x, max_order):
    """Exact int64 lags 0..max_order: ``R[k] = sum_n x[n] * x[n-k]``.

    ``x``: (..., L) integer. Returns (..., max_order+1) int64.
    """
    x64 = x.to(torch.int64)
    lags = [(x64 * x64).sum(dim=-1)]
    for k in range(1, max_order + 1):
        lags.append((x64[..., k:] * x64[..., :-k]).sum(dim=-1))
    return torch.stack(lags, dim=-1)
