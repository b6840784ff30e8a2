"""Batched v3 decode on the card: the native tokenizer, then restore on
the device (lac_tpu/device_decode.py).

v3 block payloads are bit-serial, so the native runtime only tokenizes
them (parallel over independent blocks) into residual planes and
per-lane predictor metadata. Every (block, channel) lane is then
restored on the device in two batched calls:

* fixed-predictor lanes (orders 0-4) by masked prefix sums
  (:func:`.ops.predictors.fixed_restore_multi`, torch operations),
* FIR and LPC lanes by kernel 7, the closed-loop recurrence
  (:func:`.ops.cuda_kernels.recurrence_restore`; the ``>> 15`` / ``>> 2``
  truncations make it a genuine recurrence),

and mid/side inversion and the PCM range check run on the host. The lane
gather and scatter are vectorized numpy, as in the reference. The
reference pads lane counts to powers of two so that XLA's executable
shapes stay stable across files; eager torch compiles nothing, so the
port launches at the exact lane counts. Restored lanes come back to the
host as int32 (the reference's are int64).

Each step is a function of its own (:func:`tokenize`,
:func:`lane_operands`, :func:`restore_lanes`, :func:`scatter`,
:func:`finish`), so a profile can time each where it runs.

This is the alternate backend (``FrameDecoder(backend="device")``); the
native decoder stays the default.
"""

import numpy as np
import torch

from . import HostCopy, check_device, upload
from .format import constants as C
from .ops import cuda_kernels, predictors
from .ops.stereo import ms_inverse
from .runtime import native


def lane_operands(res_planes, block_sizes, sample_offsets, ptype, order, coeffs):
    """The tokenizer's arrays -> the two batched calls' numpy operands.

    Returns (fixed, recur): ``fixed`` is (lane indices, residuals (G, L)
    int32, order, valid_len), ``recur`` is (lane indices, residuals,
    coeffs (G, 33) int16, order, shift, min_pred_n, valid_len), the
    vectors int32; lane = block * channels + channel, L the longest
    block, residuals past a lane's block zero."""
    channels = res_planes.shape[0]
    nb = len(block_sizes)
    bsz = np.asarray(block_sizes, np.int64)
    soff = np.asarray(sample_offsets, np.int64)
    lane_b = np.repeat(np.arange(nb), channels)
    lane_c = np.tile(np.arange(channels), nb)
    lane_pt = np.asarray(ptype).reshape(-1)
    lane_od = np.asarray(order).reshape(-1).astype(np.int32)
    lane_sz = bsz[lane_b].astype(np.int32)
    col = np.arange(int(bsz.max()), dtype=np.int64)
    # (lanes, L) gather with clipped indices; the invalid tail is zeroed
    gidx = soff[lane_b][:, None] + np.minimum(col[None, :], lane_sz[:, None] - 1)
    batch = res_planes[lane_c[:, None], gidx]
    batch[col[None, :] >= lane_sz[:, None]] = 0

    fixed = np.flatnonzero(lane_pt == C.PREDICTOR_FIXED)
    recur = np.flatnonzero(lane_pt != C.PREDICTOR_FIXED)
    is_fir = lane_pt[recur] == C.PREDICTOR_FIR
    cs = np.asarray(coeffs).reshape(nb * channels, -1)[recur].astype(np.int16)
    cs[is_fir] = 0
    cs[is_fir, 1], cs[is_fir, 2] = C.FIR_TAPS
    as32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return ((fixed, batch[fixed], lane_od[fixed], lane_sz[fixed]),
            (recur, batch[recur], cs, as32(np.where(is_fir, C.FIR_ORDER, lane_od[recur])),
             as32(np.where(is_fir, C.FIR_SHIFT, 15)), as32(np.where(is_fir, C.FIR_ORDER, 0)), lane_sz[recur]))


def tokenize(hdr, block_sizes, payload_sizes, block_payload, total_samples, thread_count=0):
    """The native tokenizer on a v3 frame's block payloads -> (residual
    planes (C, total) int32, ptype (nb, C), order (nb, C), coeffs (nb, C,
    33) int16, msflag (nb,), sample_offsets (nb,)). Raises
    ValueError("block=N") on a block it rejects."""
    payload_offsets = np.concatenate([[0], np.cumsum(payload_sizes)])[:-1]
    sample_offsets = np.concatenate([[0], np.cumsum(block_sizes)])[:-1]
    res, ptype, order, coeffs, msflag = native.tokenize_v3_blocks(
        block_payload, payload_offsets, payload_sizes, block_sizes, sample_offsets,
        hdr.channels, hdr.stereo_mode, total_samples, thread_count,
    )
    return res, ptype, order, coeffs, msflag, sample_offsets


def restore_lanes(fixed, recur, device):
    """:func:`lane_operands`' two groups restored on ``device``: one
    masked-cumsum program for all fixed-predictor lanes and one kernel-7
    launch for all FIR/LPC lanes. Returns every lane's samples (lanes, L)
    int32 in lane order, or None when a lane left int32. Samples come
    back as int32: every value that can be kept fits, so the copies move
    half the bytes of int64."""
    device = torch.device(device)
    restored = np.empty((len(fixed[0]) + len(recur[0]), fixed[1].shape[1]), dtype=np.int32)
    calls = ((fixed, lambda res, od, nv: predictors.fixed_restore_multi(res, od, valid_len=nv)),
             (recur, cuda_kernels.recurrence_restore))
    for (lanes, *operands), restore in calls:
        if not lanes.size:
            continue
        r, ok = restore(*(upload(a, device) for a in operands))
        r, ok = HostCopy(r.to(torch.int32)), HostCopy(ok)  # a kept sample fits int32; a rejected lane is not read
        if not ok.numpy().all():
            return None
        restored[lanes] = r.numpy()
    return restored


def scatter(res_planes, block_sizes, sample_offsets, restored):
    """Restored lanes (lanes, L) -> int64 planes (C, total): the residual
    planes with each lane's valid region overwritten (vectorized numpy)."""
    out = res_planes.astype(np.int64)
    channels = res_planes.shape[0]
    bsz = np.asarray(block_sizes, np.int64)
    lane_b = np.repeat(np.arange(len(bsz)), channels)
    lane_sz = bsz[lane_b]
    col = np.arange(restored.shape[1], dtype=np.int64)
    valid = col[None, :] < lane_sz[:, None]
    rows = np.broadcast_to(np.tile(np.arange(channels), len(bsz))[:, None], valid.shape)
    cols = np.asarray(sample_offsets, np.int64)[lane_b][:, None] + col[None, :]
    out[rows[valid], np.broadcast_to(cols, valid.shape)[valid]] = restored[valid]
    return out


def _restore_groups(res_planes, block_sizes, sample_offsets, ptype, order, coeffs, device):
    """Restore every (block, channel) lane on ``device``: gather, the two
    batched calls, scatter. Returns (int64 planes (C, total), ok); the
    residual planes when a lane left int32."""
    restored = restore_lanes(*lane_operands(res_planes, block_sizes, sample_offsets, ptype, order, coeffs), device)
    if restored is None:
        return res_planes.astype(np.int64), False
    return scatter(res_planes, block_sizes, sample_offsets, restored), True


def finish(hdr, planes, block_sizes, msflag):
    """Restored int64 planes -> (left, right) int32: mid/side inversion of
    the blocks that carry the flag, then the PCM range check (numpy)."""
    lo, hi = C.pcm_range(hdr.bit_depth)
    left = planes[0]
    if hdr.channels == 2:
        right = planes[1]
        ms_mask = np.repeat(msflag.astype(bool), block_sizes)  # per-sample flag from the per-block flags
        l_ms, r_ms = ms_inverse(left, right)
        left = np.where(ms_mask, l_ms, left)
        right = np.where(ms_mask, r_ms, right)
        if (left.min(initial=0) < lo or left.max(initial=0) > hi or
                right.min(initial=0) < lo or right.max(initial=0) > hi):
            raise ValueError("decoded sample outside PCM bit depth")
        return left.astype(np.int32), right.astype(np.int32)
    if left.min(initial=0) < lo or left.max(initial=0) > hi:
        raise ValueError("decoded sample outside PCM bit depth")
    return left.astype(np.int32), np.empty(0, np.int32)


def decode_v3_device(hdr, block_sizes, payload_sizes, block_payload, total_samples, thread_count=0, device="cuda"):
    """Device-batched v3 decode -> (left, right) int32 arrays: the steps
    :func:`tokenize`, :func:`lane_operands`, :func:`restore_lanes`,
    :func:`scatter` and :func:`finish`. Raises ValueError on invalid input:
    ``block=<i>`` for a block the tokenizer rejects, else the reference's
    messages. A CUDA ``device`` without a card, a failed kernel build or a
    failed launch raises RuntimeError: nothing is decoded on the host
    instead."""
    device = check_device(device)
    res, ptype, order, coeffs, msflag, sample_offsets = tokenize(
        hdr, block_sizes, payload_sizes, block_payload, total_samples, thread_count)
    planes, ok = _restore_groups(res, block_sizes, sample_offsets, ptype, order, coeffs, device)
    if not ok:
        raise ValueError("reconstruction outside int32 range")
    return finish(hdr, planes, block_sizes, msflag)
