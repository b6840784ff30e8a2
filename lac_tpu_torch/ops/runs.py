"""Zero-run geometry on tensors (lac_tpu/ops/runs.py).

Zero-run tokens group maximal runs of >= ZERO_RUN_MIN_LENGTH zero
residuals inside a partition. A prefix max (last non-zero index at or
before i, kernel 4) and a suffix min (next non-zero index at or after
i, kernel 5) give every run's bounds in parallel; partition clamps are
applied afterwards, so one pair of scans serves every partition order.
"""

import math

import torch

from ..format import constants as C

from .cuda_kernels import prefix_max_i32, suffix_min_i32


def zero_breaks(z):
    """(last_nz, next_nz) int32 for a bool zero mask (..., L); sentinels
    -L-2 / L+2 where no non-zero sample exists on that side."""
    L = z.shape[-1]
    lead = z.shape[:-1]
    rows = math.prod(lead)
    idx = torch.arange(L, dtype=torch.int32, device=z.device)
    a = torch.where(z, -L - 2, idx).to(torch.int32)
    b = torch.where(z, L + 2, idx).to(torch.int32)
    last_nz = prefix_max_i32(a.reshape(rows, L)).reshape(z.shape)
    next_nz = suffix_min_i32(b.reshape(rows, L)).reshape(z.shape)
    return last_nz, next_nz


def run_geometry(z, last_nz, next_nz, pos_in_seg, seg_end_exclusive):
    """(run_len int32, long_run bool, run_start bool) per sample, runs
    clamped to their partition. ``pos_in_seg`` / ``seg_end_exclusive``:
    per-sample position in, and exclusive end of, its partition (integer
    tensors on ``z``'s device; ``seg_end_exclusive`` may be an int)."""
    idx = torch.arange(z.shape[-1], dtype=torch.int32, device=z.device)
    seg_start = idx - pos_in_seg.to(torch.int32)
    run_first = torch.maximum(last_nz + 1, seg_start)
    next_break = torch.clamp(next_nz, max=seg_end_exclusive)
    run_len = torch.where(z, next_break - run_first, 0).to(torch.int32)
    long_run = z & (run_len >= C.ZERO_RUN_MIN_LENGTH)
    run_start = long_run & (idx == run_first)
    return run_len, long_run, run_start
