"""LPC analysis: exact autocorrelation lags on tensors and the host's
80-bit Levinson-Durbin with Q15 quantization (lac_tpu/ops/lpc.py).

* The lags must be exact: int64 products and sums (|R| < 2^60 for
  24-bit blocks). The JAX package's bf16-limb Gram form (lpc.py:64-134)
  is exact only with fp32 accumulation, which cuBLAS bf16 GEMMs need not
  keep (``allow_bf16_reduced_precision_reduction``); the int64 form is
  exact on any device.
* Levinson-Durbin runs vectorized over blocks in ``np.longdouble``, the
  x87 80-bit type of the reference's ``long double`` (lpc.cpp:98-186).
  Torch has no 80-bit float, so this stays on the host. One recursion
  to order 12 yields every candidate order as a snapshot.
* Q15 quantization: cast to double, scale by 32768, round half away
  from zero, clamp to int16 (lpc.cpp:73-78).
"""

import numpy as np
import torch

# Byte parity depends on np.longdouble being the x87 80-bit extended type
# (machep -63 <=> 64-bit mantissa); elsewhere it is 64- or 128-bit and
# would give near-but-not-byte-identical streams, so fail loudly.
_LD_MACHEP = np.finfo(np.longdouble).machep


def _require_x87_longdouble():
    if _LD_MACHEP != -63:
        raise RuntimeError(
            "np.longdouble is not the x86 80-bit extended type on this host "
            f"(machep {_LD_MACHEP}, expected -63): Levinson-Durbin would "
            "diverge from the reference's long double and break .lac byte "
            "parity. Run the encoder on an x86-64 host."
        )


def autocorrelation(x, max_order):
    """Exact int64 lags 0..max_order: ``R[k] = sum_n x[n] * x[n-k]``.

    ``x``: (..., L) integer tensor. Returns (..., max_order+1) int64.
    """
    x64 = x.to(torch.int64)
    lags = [(x64 * x64).sum(dim=-1)]
    for k in range(1, max_order + 1):
        lags.append((x64[..., k:] * x64[..., :-k]).sum(dim=-1))
    return torch.stack(lags, dim=-1)


def levinson_durbin_snapshots(R, max_order):
    """Vectorized 80-bit Levinson-Durbin with per-step snapshots.

    ``R``: (B, max_order+1) exact integer lags (any integer dtype or
    longdouble). Returns ``A`` (max_order+1, B, max_order+1) longdouble,
    ``A[i]`` the coefficient state after step ``i``, and ``break_step``
    (B,) int32, the step at which the recursion broke (max_order+1 if it
    completed).

    Numerics follow lpc.cpp:98-154: eps=1e-8, reflection clamp +-0.999,
    inner products accumulated in ascending-j order (FP order matters);
    the caller applies the energy floor R[0] -> max(R[0], 1.0).
    """
    _require_x87_longdouble()
    ld = np.longdouble
    R = np.asarray(R, dtype=ld)
    B = R.shape[0]
    eps = ld("1e-8")

    E = R[:, 0].copy()
    a = np.zeros((B, max_order + 1), dtype=ld)
    prevA = np.zeros((B, max_order + 1), dtype=ld)
    A = np.zeros((max_order + 1, B, max_order + 1), dtype=ld)
    # lanes whose E[0] is non-finite or < eps never start (achieved 0)
    alive = np.isfinite(E) & (E >= eps)
    break_step = np.where(alive, np.int32(max_order + 1), np.int32(1))

    for i in range(1, max_order + 1):
        acc = np.zeros(B, dtype=ld)
        for j in range(1, i):
            acc = acc + prevA[:, j] * R[:, i - j]

        denom = E
        step_alive = alive & np.isfinite(denom) & (denom >= eps)
        safe_denom = np.where(step_alive, denom, ld(1))
        ki = (R[:, i] - acc) / safe_denom
        step_alive = step_alive & np.isfinite(ki)
        ki = np.clip(ki, ld("-0.999"), ld("0.999"))

        e_new = (ld(1) - ki * ki) * E
        dead_at_e = step_alive & (~np.isfinite(e_new) | (e_new < eps))
        step_alive = step_alive & ~dead_at_e

        # a[i] = ki; a[j] = prevA[j] - ki * prevA[i-j] for alive lanes
        new_a = a.copy()
        new_a[:, i] = ki
        for j in range(1, i):
            new_a[:, j] = prevA[:, j] - ki * prevA[:, i - j]
        upd = step_alive
        a = np.where(upd[:, None], new_a, a)
        prevA = np.where(upd[:, None], a, prevA)
        E = np.where(upd, e_new, E)

        newly_dead = alive & ~step_alive
        break_step = np.where(newly_dead, np.int32(i), break_step)
        alive = step_alive
        A[i] = a

    return A, break_step


def achieved_order(break_step, cand_order):
    """Achieved order for a candidate max order (see the snapshots doc)."""
    return np.where(break_step > cand_order, cand_order, break_step - 1).astype(np.int32)


def quantize_q15(coeffs):
    """double -> signed Q15, round half away from zero, clamp (lpc.cpp:73-78)."""
    c = np.asarray(coeffs, dtype=np.float64)
    scaled = c * 32768.0
    rounded = np.trunc(scaled + np.copysign(0.5, scaled))
    return np.clip(rounded, -32768.0, 32767.0).astype(np.int16)


def candidate_coeffs_q15(A, break_step, cand_order):
    """Q15 coefficient set + achieved order for one candidate order.

    Returns (coeffs (B, cand_order+1) int16, used_order (B,) int32,
    stable (B,) bool); coefficients above the achieved order are zero
    (lpc.cpp:176-183).
    """
    B = A.shape[1]
    ach = achieved_order(break_step, cand_order)
    snap = A[ach, np.arange(B), :]  # snapshot at the achieved step, per lane
    q = quantize_q15(snap.astype(np.float64))
    cols = np.arange(A.shape[2])[None, :]
    mask = (cols >= 1) & (cols <= ach[:, None])
    coeffs = np.where(mask, q, np.int16(0)).astype(np.int16)[:, : cand_order + 1]
    return coeffs, ach, ach > 0
