"""Batched block planner and frame encoder on PyTorch (lac_tpu/encoder.py).

``plan_group`` is the array program that chooses, for every lane of a
group of equal-length channel blocks, the predictor candidate, the
residual mode and the partitioning with the reference's exact cost
models and tie-breaks (lac_tpu/encoder.py:180-520). It returns the
compact ``meta`` rows, which the native runtime replays on the host into
bytes, and on request the per-sample token codes (``ship``) that the
numpy packer turns into bytes when the native runtime is off.

u32 codes and u64 bit totals are carried in int64 (totals <= 2^46, so
the ordering and every sum are exact); the kernels of
:mod:`.ops.cuda_kernels` take the codes as an int32 view of their bits.

``FrameEncoder.encode`` runs the plane pipeline (:mod:`.device_pipeline`)
for the full-block prefix and the host route for every other lane, or
without the native runtime the group route (:class:`ChannelBlockEncoder`
with a device); ``FrameEncoder.encode_frame`` is the host route, which
plans every block it is given with the native planner. Both assemble the
same frame.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import HostCopy, check_device, resolve_device, upload
from .bitio.pack import pack_stream
from .format import constants as C
from .format.header import FrameHeader
from .format.inspect import parse_block_header
from .format.partitions import control_byte, max_partition_order_for_block
from .format.zigzag import zigzag_encode
from .ops import adapt, lpc, predictors, runs
from .ops._backend import u32_from_bits
from .ops.cuda_kernels import k_cost_partition_sums, k_cost_sums, mode_cost_sums, partition_cost_sums
from .ops.stereo import estimate_stereo_mode, estimate_stereo_mode_host, ms_transform_host
from .parallel.mesh import make_mesh
from .plan_graphs import lags_of, planned
from .runtime import native
from .utils import debug as _dbg
from .utils.debug import debug_log

# candidate table: (predictor_type, order_param), in consideration order
_CANDIDATES = (
    [(C.PREDICTOR_FIXED, o) for o in range(5)]
    + [(C.PREDICTOR_FIR, C.FIR_ORDER)]
    + [(C.PREDICTOR_LPC, o) for o in C.LPC_ORDER_CANDIDATES]
)
_LPC_BASE = 6  # index of the first LPC candidate

# compact token classes of ``plan_group(emit_fields=True)``'s ship codes
CLS_RICE = 0  # rice/static/bin fallback: unary = q, tail = (rem, k + 1)
CLS_HEAD_ONLY = 1  # bin direct tokens: head bits only
CLS_RUN = 2  # zero-run token: payload = run length
CLS_ESCAPE = 3  # 32-bit zigzag escape: tail = (payload, 32)
CLS_SILENT = 4  # inside a run: emits nothing
_INT64_MAX = torch.iinfo(torch.int64).max


def plan_inputs_to_torch(coeffs, lvalid, device):
    """Host LPC candidate set -> planner inputs on ``device``:
    coeffs (5, B, 13) int16 and valid (5, B) bool."""
    device = torch.device(device)
    return upload(np.asarray(coeffs, dtype=np.int16), device), upload(np.asarray(lvalid, dtype=bool), device)


def _pad_to_byte(bits):
    return bits + ((8 - (bits & 7)) & 7)


def _k_costs_from_sums(sums, k_max, width):
    """Rice-cost stack for k in [0, k_max] of rows of ``width`` samples
    from their 17 k-cost sums (..., 17): (..., k_max + 1) int64.

    ``u >> k = ((u >> 16) << (16 - k)) + ((u & 0xFFFF) >> k)`` for k <= 16,
    so the 17 sums of the k-cost kernel give every cost.
    """
    assert k_max <= 16
    sums = u32_from_bits(sums)
    karr = torch.arange(k_max + 1, dtype=torch.int64, device=sums.device)
    shi, slo = sums[..., :1], sums[..., 1 : k_max + 2]
    return (shi << (16 - karr)) + slo + (karr + 1) * width


def _head_and_row_costs(u32):
    """Initial-k costs over the first INITIAL_SCAN_COUNT samples and
    static-k costs over the whole of each row of ``u32`` (..., n), from
    one pass of the k-cost kernel: (..., INITIAL_MAX_K + 1) and
    (..., MAX_STATIC_K + 1) int64."""
    lead, n = u32.shape[:-1], u32.shape[-1]
    head = min(C.INITIAL_SCAN_COUNT, n)
    head_sums, row_sums = k_cost_sums(u32.reshape(-1, n), head=head)
    return (_k_costs_from_sums(head_sums.reshape(lead + (17,)), C.INITIAL_MAX_K, head),
            _k_costs_from_sums(row_sums.reshape(lead + (17,)), C.MAX_STATIC_K, n))


@functools.lru_cache(maxsize=None)
def _partition_geometry(n, p, device):
    """Static geometry of partition order ``p`` on ``device``, uploaded
    once per process and card (a host->device copy inside the planner
    would synchronise the stream). ``device`` is a tensor's, which always
    carries its index, so one card is one key; no bound, so a mesh of
    any size keeps every card's tables."""
    nparts = 1 << p
    starts = np.minimum(np.arange(nparts, dtype=np.int64) * (n >> p), n)
    ends = np.concatenate([starts[1:], [n]])
    sizes = ends - starts
    head_ends = np.minimum(starts + C.INITIAL_SCAN_COUNT, ends)
    geometry = dict(starts=starts, ends=ends, sizes=sizes, head_ends=head_ends, head_sizes=head_ends - starts)
    return {k: upload(v, device) for k, v in geometry.items()}


@functools.lru_cache(maxsize=None)
def _ptype_table(device):
    return torch.tensor([t for t, _ in _CANDIDATES], dtype=torch.int64, device=device)


def plan_group(pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled, emit_fields=False,
               tally=None):
    """pcm (B, n) + LPC candidates -> plan ``meta`` (B, 3 + 2 * max_parts) int8:
    selected candidate, partition order, lane in-range flag, then the
    partition modes and ks (lac_tpu/encoder.py:443-459).

    ``lpc_coeffs``: (5, B, 13) int16 Q15 candidate sets; ``lpc_valid``:
    (5, B) bool. Everything runs on ``pcm``'s device.

    With ``emit_fields`` the result is ``(meta, ship)``: ``ship`` (B, 6n)
    uint8 holds each sample's compact token code, its u32 payload in
    little-endian bytes, then ``headcode = cls | head_val << 3 | head_len
    << 6`` and k (lac_tpu/encoder.py:461-502), what
    :meth:`ChannelBlockEncoder._emit` packs when there is no native replay.

    ``tally``, where given, a (2,) int64 tensor on ``pcm``'s device, gets
    the partition sweep's count of parts summed the 64-bit way and of parts
    summed (``cuda_kernels.partition_cost_sums``); nothing with
    partitioning off.
    """
    dev = pcm.device
    B = pcm.shape[0]
    pcm = pcm.to(torch.int32)

    # ---- candidate residuals (B, ncand, n)
    with _dbg.section("plan_group.residuals"):
        res_list = [predictors.fixed_residual(pcm, o) for o in range(5)]
        res_list.append(predictors.fir_residual(pcm))
        lpc_ok = []
        for li in range(len(C.LPC_ORDER_CANDIDATES)):
            r, in_range = predictors.lpc_residual(pcm, lpc_coeffs[li], 12)
            res_list.append(r)
            lpc_ok.append(in_range)
        residuals = torch.stack(res_list, dim=1)
        del res_list
        lpc_in_range = torch.stack(lpc_ok, dim=0)  # (5, B)
        valid = torch.cat(
            [torch.ones((B, _LPC_BASE), dtype=torch.bool, device=dev), (lpc_valid & lpc_in_range).T], dim=1
        )

    # ---- whole-block stateful scoring per candidate
    with _dbg.section("plan_group.scoring"):
        u = zigzag_encode(residuals)
        u32 = u.to(torch.int32)  # bit view for the kernels
        head_costs, static_costs = _head_and_row_costs(u32)
        initial_k = torch.argmin(head_costs, dim=-1).to(torch.int32)
        k_after = adapt.k_after_stateful(u32)
        last_nz, next_nz = runs.zero_breaks(u32 == 0)
        sums = mode_cost_sums(*(t.reshape(-1, n) for t in (u32, k_after)), initial_k.reshape(-1),
                              *(t.reshape(-1, n) for t in (last_nz, next_nz))).reshape(B, -1, 4)
        del last_nz, next_nz
        rice_bits, bin_bits, zr_bits = sums[..., 0], sums[..., 1], sums[..., 2]
        has_run = sums[..., 3] != 0
        static_bits = static_costs.min(dim=-1).values
        static_k = torch.argmin(static_costs, dim=-1).to(torch.int32)

    # ---- candidate selection: lexicographic (bits, predictor_type, order)
    # as one first-minimum argmin over key = bits * 4 + predictor_type
    with _dbg.section("plan_group.selection"):
        zr_eff = torch.where(has_run, zr_bits, rice_bits) if zero_run_enabled else rice_bits
        best_bits_all = torch.minimum(torch.minimum(rice_bits, static_bits), torch.minimum(zr_eff, bin_bits))
        key = torch.where(valid, best_bits_all * 4 + _ptype_table(dev), _INT64_MAX)
        sel_idx = torch.argmin(key, dim=-1)

        def g2(a):  # (B, ncand) -> the selected candidate's entry
            return a.gather(1, sel_idx[:, None])[:, 0]

        sel3 = sel_idx[:, None, None].expand(B, 1, n)
        v_w = residuals.gather(1, sel3)[:, 0]
        u_w = u.gather(1, sel3)[:, 0]
        k_after_w = k_after.gather(1, sel3)[:, 0] if emit_fields else None  # the winner's stateful k_after
        del residuals, u, u32, k_after
        initial_k_w = g2(initial_k)
        static_k_w = g2(static_k)

    # ---- whole-block residual-mode choice (encoder.cpp:441-456)
    with _dbg.section("plan_group.mode"):
        rice_w, zr_w, bin_w, static_w = g2(rice_bits), g2(zr_eff), g2(bin_bits), g2(static_bits)
        allow_zr = g2(has_run) if zero_run_enabled else torch.zeros((B,), dtype=torch.bool, device=dev)
        best = rice_w
        base_mode = torch.zeros((B,), dtype=torch.int32, device=dev)
        take = allow_zr & (zr_w <= best)
        best = torch.where(take, zr_w, best)
        base_mode = torch.where(take, C.MODE_ZERO_RUN, base_mode)
        take = bin_w < best
        best = torch.where(take, bin_w, best)
        base_mode = torch.where(take, C.MODE_BIN, base_mode)
        take_static = static_w < best
        best = torch.where(take_static, static_w, best)
        base_mode = torch.where(take_static, C.MODE_STATIC, base_mode)
        base_k = torch.where(take_static, static_k_w, initial_k_w)

    # ---- partition sweep
    with _dbg.section("plan_group.sweep"):
        max_p = max_partition_order_for_block(n) if (partitioning_enabled and n >= C.MIN_PARTITION_SIZE) else 0
        max_parts = 1 << max_p
        best_p = torch.zeros((B,), dtype=torch.int32, device=dev)
        best_total = _pad_to_byte(best + (8 + 7))
        sel_modes = torch.zeros((B, max_parts), dtype=torch.int32, device=dev)
        sel_ks = torch.zeros((B, max_parts), dtype=torch.int32, device=dev)
        sel_modes[:, 0] = base_mode
        sel_ks[:, 0] = base_k
        init_k_parts, static_parts = None, []

        if max_p > 0 or emit_fields:
            zw0 = v_w == 0
            last_nz, next_nz = runs.zero_breaks(zw0)
        if max_p > 0:
            # every order's initial and static k first, then every part's mode costs from one launch
            u_w32 = u_w.to(torch.int32)
            init_k_parts, static_parts = _partition_k_costs(u_w, u_w32, max_p)
            part_costs = partition_cost_sums(u_w32, last_nz, next_nz, init_k_parts, max_p, tally=tally)

        for p, sc in enumerate(static_parts, 1):
            nparts = 1 << p
            cols = slice(nparts - 2, 2 * nparts - 2)
            costs = part_costs[:, cols]
            rice_s, bin_s, zr_s = costs[..., 0], costs[..., 1], costs[..., 2]
            has_run_s = costs[..., 3] != 0
            static_s = sc.min(dim=-1).values
            static_k_s = torch.argmin(sc, dim=-1).to(torch.int32)

            mode_s = torch.zeros((B, nparts), dtype=torch.int32, device=dev)
            bits_s = rice_s
            k_s = init_k_parts[:, cols]
            if zero_run_enabled:
                tk = has_run_s & (zr_s < bits_s)
                bits_s = torch.where(tk, zr_s, bits_s)
                mode_s = torch.where(tk, C.MODE_ZERO_RUN, mode_s)
            tk = bin_s < bits_s
            bits_s = torch.where(tk, bin_s, bits_s)
            mode_s = torch.where(tk, C.MODE_BIN, mode_s)
            tk = (static_s < bits_s) | (static_s <= bits_s + bits_s // C.DECODE_SPEED_MARGIN_DIVISOR)
            bits_s = torch.where(tk, static_s, bits_s)
            mode_s = torch.where(tk, C.MODE_STATIC, mode_s)
            k_s = torch.where(tk, static_k_s, k_s)

            total = _pad_to_byte(bits_s.sum(dim=-1) + (8 + 7 * nparts))
            margin = best_total // C.DECODE_SPEED_MARGIN_DIVISOR
            accept = ((total < best_total) | ((total <= best_total + margin) & (best_p == 0))
                      | ((total == best_total) & (p < best_p)))
            best_total = torch.where(accept, total, best_total)
            best_p = torch.where(accept, p, best_p)
            # columns >= nparts are still 0: earlier orders wrote fewer columns
            am = accept[:, None]
            sel_modes[:, :nparts] = torch.where(am, mode_s, sel_modes[:, :nparts])
            sel_ks[:, :nparts] = torch.where(am, k_s, sel_ks[:, :nparts])

    # ---- meta, and the chosen plan's token codes
    with _dbg.section("plan_group.meta"):
        # overflow only matters for candidates actually under consideration
        # (the reference skips unstable/zero-order candidates before ever
        # computing a residual, block/encoder.cpp:395-398)
        lane_in_range = (lpc_in_range | ~lpc_valid).all(dim=0)
        cols = [sel_idx[:, None], best_p[:, None], lane_in_range[:, None], sel_modes, sel_ks]
        meta = torch.cat([c.to(torch.int8) for c in cols], dim=-1)
        if not emit_fields:
            return meta
        fields = _chosen_fields(u_w, zw0, last_nz, next_nz, best_p, sel_modes, sel_ks, init_k_parts,
                                adapt.k_used_from_after(k_after_w, initial_k_w))
        return meta, _ship_fields(v_w, u_w, *fields)


def _partition_k_costs(u_w, u_w32, max_p):
    """Each part's initial k of orders 1..``max_p`` of the winners' codes
    ``u_w`` (B, n) int64 (``u_w32``: their int32 view), order by order,
    (B, 2^(max_p+1) - 2) int32, and each order's static-k cost stack
    (B, 2^p, MAX_STATIC_K + 1)."""
    B, n = u_w.shape
    dev = u_w.device
    # a power-of-two block: every order's parts are equal, and one pass of
    # the k-cost kernel gives every order's sums. The first
    # INITIAL_SCAN_COUNT samples of a longer part are one part of the
    # order whose parts have that length.
    all_orders = n & (n - 1) == 0
    if all_orders:
        part_sums = k_cost_partition_sums(u_w32, max_p)
        head_order = max(n // C.INITIAL_SCAN_COUNT, 1).bit_length() - 1
    if any(n % (1 << p) for p in range(1, max_p + 1)):
        # split cumsums and per-k shifted-low cost cumsums (B, n+1, 16):
        # odd block sizes only (unequal partitions); power-of-two blocks
        # never build them
        csz_hi = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=dev),
                            torch.cumsum(u_w >> 16, dim=-1)], dim=-1)  # (B, n+1)
        lo_k = torch.stack([(u_w & 0xFFFF) >> k for k in range(C.MAX_STATIC_K + 1)], dim=-1)
        csz_lok = torch.cat(
            [torch.zeros((B, 1, C.MAX_STATIC_K + 1), dtype=torch.int64, device=dev),
             torch.cumsum(lo_k, dim=-2)], dim=-2
        )
        karr = torch.arange(C.MAX_STATIC_K + 1, dtype=torch.int64, device=dev)

    def _k_cost_seg(starts, ends, seg_sizes, kmax):
        """Per-partition rice-cost stack from the split cumsums: (B, nparts, kmax+1)."""
        hi_seg = csz_hi[:, ends] - csz_hi[:, starts]
        lo_seg = csz_lok[:, ends, : kmax + 1] - csz_lok[:, starts, : kmax + 1]
        ka = karr[: kmax + 1]
        return (hi_seg[..., None] << (16 - ka)) + lo_seg + (ka + 1) * seg_sizes[..., None]

    init_k, static = [], []
    for p in range(1, max_p + 1):
        base = n >> p
        nparts = 1 << p
        if all_orders:
            row_sums = part_sums[p]
            head_sums = part_sums[head_order][:, :: 1 << (head_order - p)] if p < head_order else row_sums
            hc = _k_costs_from_sums(head_sums, C.INITIAL_MAX_K, min(C.INITIAL_SCAN_COUNT, base))
            sc = _k_costs_from_sums(row_sums, C.MAX_STATIC_K, base)
        elif n % nparts == 0:
            hc, sc = _head_and_row_costs(u_w32.reshape(B, nparts, base))
        else:
            g = _partition_geometry(n, p, dev)
            hc = _k_cost_seg(g["starts"], g["head_ends"], g["head_sizes"], C.INITIAL_MAX_K)
            sc = _k_cost_seg(g["starts"], g["ends"], g["sizes"], C.MAX_STATIC_K)
        init_k.append(torch.argmin(hc, dim=-1).to(torch.int32))  # (B, nparts)
        static.append(sc)
    return torch.cat(init_k, dim=1), static


def _chosen_fields(u_w, zw0, last_nz, next_nz, best_p, sel_modes, sel_ks, init_k_parts, k_whole):
    """Per-sample emission state of each lane's chosen plan, order
    ``best_p``: (adapted k, mode, k field, run length, in a long run, run
    start), each (B, n). ``k_whole`` is the whole block's stateful k (order
    0); a part of a finer order codes its first sample with its initial k
    (``init_k_parts``) and the others with the stateless adapter's k over
    the part's samples before them."""
    B, n = u_w.shape
    idx = torch.arange(n, device=u_w.device)
    bp = best_p.to(torch.int64)[:, None]
    last = (1 << bp) - 1  # the last part of the lane's order
    base = torch.full_like(bp, n) >> bp
    part = torch.minimum(idx // base, last)  # (B, n)
    start = part * base
    end = torch.where(part == last, n, start + base)
    pos = idx - start
    run_len, long_run, run_start = runs.run_geometry(zw0, last_nz, next_nz, pos, end.to(torch.int32))
    k = k_whole
    if init_k_parts is not None:
        cs = torch.cat([torch.zeros((B, 1), dtype=torch.int64, device=u_w.device), torch.cumsum(u_w, dim=-1)], dim=-1)
        k_stateless = adapt.k_after_stateless(cs[:, :n] - cs.gather(1, start), pos - 1)  # pos samples before i
        k_first = init_k_parts.gather(1, (last - 1 + part).clamp(min=0))
        k = torch.where(bp == 0, k_whole, torch.where(pos == 0, k_first, k_stateless))
    return (k.to(torch.int32), sel_modes.gather(1, part), sel_ks.gather(1, part), run_len, long_run, run_start)


def _ship_fields(v_w, u_w, k_adapt, mode, kfield, run_len, long_run, run_start):
    """The chosen plan's compact token codes (lac_tpu/encoder.py:461-502):
    (B, n) per-sample emission state -> ship (B, 6n) uint8."""
    B, n = v_w.shape
    k_eff = torch.where(mode == C.MODE_STATIC, kfield, k_adapt).to(torch.int64)
    is_bin = mode == C.MODE_BIN
    is_zr = mode == C.MODE_ZERO_RUN
    absv = v_w.to(torch.int64).abs()
    sign = (v_w < 0).to(torch.int64)
    escape = is_zr & ~long_run & (u_w > (1 << torch.clamp(k_eff + C.ESCAPE_K_OFFSET, max=C.ESCAPE_K_CAP)))
    zr_run = is_zr & run_start
    silent = is_zr & long_run & ~run_start
    zr_normal = is_zr & ~long_run & ~escape

    zero = torch.zeros_like(absv)
    cls = torch.where(is_bin & (absv <= 2), CLS_HEAD_ONLY, zero)  # CLS_RICE elsewhere
    head_val = torch.where(is_bin & (absv == 0), C.BIN_TAG_ZERO, zero)
    head_len = torch.where(is_bin & (absv == 0), 2, zero)
    for tag, cond in ((C.BIN_TAG_ONE, absv == 1), (C.BIN_TAG_TWO, absv == 2)):
        head_val = torch.where(is_bin & cond, (tag << 1) | sign, head_val)
        head_len = torch.where(is_bin & cond, 3, head_len)
    head_val = torch.where(is_bin & (absv > 2), C.BIN_TAG_FALLBACK, head_val)
    head_len = torch.where(is_bin & (absv > 2), 2, head_len)
    head_val = torch.where(zr_normal, C.ZR_TAG_NORMAL, head_val)
    head_len = torch.where(zr_normal, 2, head_len)
    for cond, c, tag in ((zr_run, CLS_RUN, C.ZR_TAG_RUN), (escape, CLS_ESCAPE, C.ZR_TAG_ESCAPE)):
        cls = torch.where(cond, c, cls)
        head_val = torch.where(cond, tag, head_val)
        head_len = torch.where(cond, 2, head_len)
    cls = torch.where(silent, CLS_SILENT, cls)
    head_val = torch.where(silent, 0, head_val)
    head_len = torch.where(silent, 0, head_len)

    headcode = cls | (head_val << 3) | (head_len << 6)
    payload = torch.where(zr_run, run_len.to(torch.int64), u_w)  # u32 values
    fields = [(payload >> (8 * i)) & 0xFF for i in range(4)] + [headcode, k_eff]
    return torch.stack([f.to(torch.uint8) for f in fields], dim=-1).reshape(B, n * 6)


# ======================================================================= host


def lpc_candidates_from_lags(R, n):
    """Host 80-bit Levinson-Durbin from exact int64 lags (B, 13) ->
    candidate arrays (coeffs (5,B,13) i16, used (5,B) i32, valid (5,B)
    bool, max_valid_order). One order-12 recursion yields every
    candidate order as a snapshot (reference lpc.cpp:98-186)."""
    B = R.shape[0]
    ncl = len(C.LPC_ORDER_CANDIDATES)
    coeffs = np.zeros((ncl, B, 13), dtype=np.int16)
    used = np.zeros((ncl, B), dtype=np.int32)
    valid = np.zeros((ncl, B), dtype=bool)
    max_valid_order = min(32, n - 1) if n > 1 else 0
    Rld = np.asarray(R, dtype=np.longdouble)
    Rld[:, 0] = np.maximum(Rld[:, 0], np.longdouble(1))
    A, break_step = lpc.levinson_durbin_snapshots(Rld, 12)
    for li, cand in enumerate(C.LPC_ORDER_CANDIDATES):
        if cand > max_valid_order:
            continue
        cc, ach, stable = lpc.candidate_coeffs_q15(A, break_step, cand)
        coeffs[li, :, : cand + 1] = cc
        used[li] = ach
        valid[li] = stable
    return coeffs, used, valid, max_valid_order


def expand_plan(meta, coeffs, used, mvo, n, partitioning_enabled):
    """Expand compact plan metadata to the per-lane replay arrays:
    (ptype u8, order u8, coeffs_lane (B,33) i16, best_p u8, modes (B,256)
    u8, ks (B,256) u8).

    Every lane must be in range: a lane whose LPC residual left int32 is
    replanned down the order ladder first (``_GroupJob._ladder_replan``).
    Validated PCM never leaves it: |x| <= 2^24 (a 24-bit side channel) and
    12 Q15 taps give |prediction| < 12 * 2^24.
    """
    B = meta.shape[0]
    sel = meta[:, 0].astype(np.int32)
    best_p = meta[:, 1].astype(np.int32)
    assert np.all(meta[:, 2] != 0), "an LPC residual left int32: such lanes take the ladder replan"
    max_p0 = max_partition_order_for_block(n) if (partitioning_enabled and n >= C.MIN_PARTITION_SIZE) else 0
    max_parts = 1 << max_p0
    modes = np.zeros((B, 256), np.uint8)
    ks = np.zeros((B, 256), np.uint8)
    modes[:, :max_parts] = meta[:, 3 : 3 + max_parts]
    ks[:, :max_parts] = meta[:, 3 + max_parts : 3 + 2 * max_parts]

    pt_tab = np.asarray([t for t, _ in _CANDIDATES], np.uint8)
    op_tab = np.asarray([o for _, o in _CANDIDATES], np.uint8)
    ptype = pt_tab[sel]
    order = op_tab[sel].astype(np.int32)
    lanes = np.arange(B)
    lpc_mask = sel >= _LPC_BASE
    li = np.clip(sel - _LPC_BASE, 0, len(C.LPC_ORDER_CANDIDATES) - 1)
    used_sel = used[li, lanes]
    order = np.where(lpc_mask, np.clip(used_sel, 1, mvo), order).astype(np.uint8)
    coeffs_lane = np.zeros((B, 33), np.int16)
    coeffs_lane[:, :13] = np.where(lpc_mask[:, None], coeffs[li, lanes, :], np.int16(0))
    return ptype, order, coeffs_lane, best_p.astype(np.uint8), modes, ks


def replay_payloads(pcm, meta, coeffs, used, mvo, n, partitioning_enabled, thread_count):
    """Native plan replay: expand plan metadata to per-lane arrays and
    emit the wire payloads in one C++ pass (lac_emit_blocks)."""
    plan = expand_plan(meta, coeffs, used, mvo, n, partitioning_enabled)
    return native.emit_blocks(pcm, *plan, thread_count)


# The default of LAC_TPU_COLD_BLOCKS: the longest input on which the host
# route beat a cold card in every turn, one-shot CLI encodes in fresh
# processes on an H100 host of 8 cores (profile_cold.py: 8-1024 blocks;
# 1536 split the turns, the card won at 2040).
COLD_BLOCKS = 1024


def _cold_route(nblocks):
    """True when an encode of ``nblocks`` blocks on a card should take the
    host route instead, so a one-shot call starts no CUDA context
    (lac_tpu/encoder.py:41-72; the reference CLI is millisecond-class,
    main.cpp:600-709).

    Only while this process has not used the card
    (:func:`.device_pipeline.process_warm`), only for at most
    ``LAC_TPU_COLD_BLOCKS`` blocks (default :data:`COLD_BLOCKS`, about 6.3
    minutes of 44.1 kHz audio; 0 turns routing off), and only with the
    native runtime, which plans at C++ speed. The caller asks only for an
    encoder on a card: a ``device="cpu"`` encoder never routes. The
    streaming route decides once for the whole file, not per chunk.
    """
    try:
        thr = int(os.environ.get("LAC_TPU_COLD_BLOCKS", COLD_BLOCKS))
    except ValueError:
        thr = COLD_BLOCKS
    if thr <= 0 or nblocks > thr:
        return False
    from . import device_pipeline

    return not device_pipeline.process_warm() and native.native_available()


class _GroupJob:
    """One batch of a lane group through three phases, so the frame
    encoder overlaps uploads, device work, device->host copies and host
    packing across groups (lac_tpu/encoder.py:630-840):

    1. ``dispatch_autocorr``: upload the PCM (int16 for 16-bit content)
       and fetch its exact lags, a replay of the captured lags of the
       padded batch (:func:`.plan_graphs.lags_of`);
    2. ``dispatch_plan``: the host's 80-bit Levinson-Durbin on the lags,
       then the plan queued on the device as a replay of the captured
       ``plan_group`` of the padded batch (:func:`.plan_graphs.planned`),
       its ``meta`` (and, with no native replay, its ``ship``) copied back
       without blocking;
    3. ``finish``: payload bytes, by native replay or by the token packer.

    Lanes of the two hot lengths (16384 and the 256-sample probes), or a
    batch of at least 2^22 samples, go to the encoder's device; the
    others take the host route: the native planner and replay or, under
    ``LAC_TPU_NO_NATIVE=1``, ``plan_group`` on CPU tensors (its kernels'
    plain versions) and the token packer.
    """

    _HOT_SHAPES = (C.MAX_BLOCK_SIZE, C.STEREO_PROBE_SIZE)
    _MIN_DEVICE_ELEMS = 1 << 22

    def __init__(self, enc, pcm_np):
        self.enc = enc
        self.pcm_np = pcm_np
        self.B, self.n = pcm_np.shape
        self.on_device = enc.device is not None and (
            self.n in self._HOT_SHAPES or self.B * self.n >= self._MIN_DEVICE_ELEMS)

    def dispatch_autocorr(self):
        if not self.on_device:
            return
        from . import device_pipeline

        enc, B, n = self.enc, self.B, self.n
        self.dev = dev = enc.plan_device()
        # rows pad to a power of two, then to a multiple of the mesh, so that
        # few plan shapes exist, each captured once (lac_tpu/encoder.py:665-670,
        # whose doubling loop this rounding equals for power-of-two meshes)
        nd = len(enc.mesh) if enc.mesh is not None else 1
        self.Bp = -(-(1 << max(0, (B - 1).bit_length())) // nd) * nd
        small = int(self.pcm_np.min(initial=0)) >= -32768 and int(self.pcm_np.max(initial=0)) <= 32767
        with _dbg.phase("h2d_upload"):
            pcm_pad = np.zeros((self.Bp, n), np.int16 if small else np.int32)
            pcm_pad[:B] = self.pcm_np
            self.pcm_pad = pcm_pad  # a mesh's shards (plan_group_sharded)
            self.pcm_dev = upload(pcm_pad[:B], dev)  # lags_of and planned pad it on the card
        self.need_lpc = any(c <= _max_valid_order(n) for c in C.LPC_ORDER_CANDIDATES)
        if self.need_lpc:
            # exact int64 lags of the padded batch on the device (lac_tpu/encoder.py:685-692);
            # the LD that needs them is next
            with _dbg.phase("autocorr_fetch"):
                self.R_np = lags_of(self.pcm_dev, self.Bp).cpu().numpy()
        if dev.type == "cuda":
            device_pipeline.mark_warm()  # this process now uses the card

    def dispatch_plan(self):
        enc, B, n = self.enc, self.B, self.n
        self.replay = native.native_available()
        if not self.on_device:
            with _dbg.phase("plan_numpy"):
                coeffs, used, lvalid, mvo = enc.lpc_analysis(self.pcm_np, n)
                if self.replay:  # the native planner: plan_group's meta rows at C++ speed
                    ship = None
                    meta = native.plan_blocks(self.pcm_np, coeffs, lvalid, enc.zero_run_enabled,
                                              enc.partitioning_enabled, enc.thread_count)
                else:
                    meta, ship = _plan_on_host(self.pcm_np, coeffs, lvalid, n, enc, emit_fields=True)
                self._result = (ship, meta, coeffs, used, lvalid, mvo)
            return
        R = self.R_np if self.need_lpc else None
        with _dbg.phase("host_ld"):
            self.coeffs, self.used, self.lvalid, self.mvo = enc.lpc_analysis(self.pcm_np, n, precomputed_R=R)
        with _dbg.phase("plan_dispatch"):
            if enc.mesh is not None:
                from .parallel.mesh import plan_group_sharded

                pad = self.Bp - B
                coeffs_pad = np.pad(self.coeffs, ((0, 0), (0, pad), (0, 0)))
                lvalid_pad = np.pad(self.lvalid, ((0, 0), (0, pad)))
                self.fut = plan_group_sharded(enc.mesh, self.pcm_pad, coeffs_pad, lvalid_pad, n,
                                              enc.zero_run_enabled, enc.partitioning_enabled,
                                              emit_fields=not self.replay)
                return
            ct, vt = plan_inputs_to_torch(self.coeffs, self.lvalid, self.dev)
            out = planned(self.pcm_dev, ct, vt, n, enc.zero_run_enabled, enc.partitioning_enabled,
                          emit_fields=not self.replay, rows=self.Bp)
            out = (out,) if self.replay else out
            self.copies = dict(zip(("meta", "ship"), (HostCopy(t) for t in out)))

    def _fetched(self, key):
        if self.enc.mesh is not None:
            return self.fut[key][: self.B]
        return self.copies[key].numpy()[: self.B]

    def _ladder_replan(self, pcm_rows, coeffs_rows, used_rows, lvalid_rows, mvo):
        """Replan lanes whose open-loop LPC residual left int32 at some
        candidate order (lpc.cpp:188-229) on the host: each candidate's
        coefficients are cut to the highest ladder order that stays in
        range (order 0 drops the candidate, block/encoder.cpp:401-403),
        then the lanes are planned again with the reference's selection."""
        enc, n = self.enc, self.n
        coeffs2, used2, lvalid2 = coeffs_rows.copy(), used_rows.copy(), lvalid_rows.copy()
        for li, cand in enumerate(C.LPC_ORDER_CANDIDATES):
            for row in range(pcm_rows.shape[0]):
                if not lvalid2[li, row]:
                    continue
                o = predictors.lpc_ladder_order(pcm_rows[row], coeffs2[li, row], used2[li, row], cand)
                if o == 0:
                    lvalid2[li, row] = False
                else:
                    used2[li, row] = o
                    coeffs2[li, row, o + 1 :] = 0
        meta2, ship2 = _plan_on_host(pcm_rows, coeffs2, lvalid2, n, enc, emit_fields=not self.replay)
        assert np.all(meta2[:, 2] != 0), "ladder-truncated lanes must be in range"
        if self.replay:
            return replay_payloads(pcm_rows, meta2, coeffs2, used2, mvo, n, enc.partitioning_enabled,
                                   enc.thread_count)
        return enc._emit(ship2, meta2, coeffs2, used2, mvo, pcm_rows.shape[0], n)

    def _payloads(self, pcm, ship, meta, coeffs, used, lvalid, mvo):
        """Payloads of every lane; lanes whose LPC residual left int32
        (``meta[:, 2] == 0``) go through :meth:`_ladder_replan` and are
        spliced back in order."""
        enc, n = self.enc, self.n
        bad = meta[:, 2] == 0
        out = [None] * pcm.shape[0]
        for rows, is_bad in ((np.nonzero(~bad)[0], False), (np.nonzero(bad)[0], True)):
            if not len(rows):
                continue
            if is_bad:
                with _dbg.phase("ladder_replan"):
                    sub = self._ladder_replan(pcm[rows], coeffs[:, rows], used[:, rows], lvalid[:, rows], mvo)
            elif self.replay:
                with _dbg.phase("native_emit"):
                    sub = replay_payloads(pcm[rows], meta[rows], coeffs[:, rows], used[:, rows], mvo, n,
                                          enc.partitioning_enabled, enc.thread_count)
            else:
                with _dbg.phase("host_emit"):
                    sub = enc._emit(ship[rows], meta[rows], coeffs[:, rows], used[:, rows], mvo, len(rows), n)
            for i, pb in zip(rows, sub):
                out[i] = pb
        return out

    def finish(self):
        if not self.on_device:
            ship, meta, coeffs, used, lvalid, mvo = self._result
            return self._payloads(self.pcm_np, ship, meta, coeffs, used, lvalid, mvo)
        with _dbg.phase("meta_fetch"):
            meta = self._fetched("meta")
        ship = None
        if not self.replay:
            with _dbg.phase("ship_fetch"):
                ship = self._fetched("ship")
        return self._payloads(self.pcm_np, ship, meta, self.coeffs, self.used, self.lvalid, self.mvo)


def _max_valid_order(n):
    return min(32, n - 1) if n > 1 else 0


def _plan_on_host(pcm, coeffs, lvalid, n, enc, emit_fields):
    """``plan_group`` on CPU tensors (the kernels' plain versions) ->
    numpy (meta, ship), ship None without ``emit_fields``."""
    out = plan_group(torch.from_numpy(np.ascontiguousarray(pcm)), torch.from_numpy(coeffs),
                     torch.from_numpy(lvalid), n, enc.zero_run_enabled, enc.partitioning_enabled,
                     emit_fields=emit_fields)
    return (out[0].numpy(), out[1].numpy()) if emit_fields else (out.numpy(), None)


class ChannelBlockEncoder:
    """Groups of equal-length channel blocks -> wire payloads
    (lac_tpu/encoder.py:843-1032).

    ``device`` None (the default) is the host route: native
    autocorrelation, the 80-bit Levinson-Durbin, the native planner and
    native plan replay. With a ``device`` ("cuda", or "cpu" for CPU
    tensors) the hot lengths are planned there by :class:`_GroupJob`,
    over the cards of ``mesh`` when one is given. Under
    ``LAC_TPU_NO_NATIVE=1`` every plan is ``plan_group``'s and every
    payload is packed from its token codes. Output bytes depend on none
    of this, nor on how lanes are batched.
    """

    # device batches: 128 lanes of 16384 samples, 1024 probe lanes
    MAX_DEVICE_ELEMS = 128 * 16384
    GROUP_LANES = 256  # lanes per native host-route call: bounds the emit buffers

    def __init__(self, zero_run_enabled=True, partitioning_enabled=True, thread_count=0, mesh=None, device=None):
        self.zero_run_enabled = bool(zero_run_enabled)
        self.partitioning_enabled = bool(partitioning_enabled)
        self.thread_count = int(thread_count)
        self.mesh = mesh  # spreads device plans over its cards (:func:`.parallel.make_mesh`)
        self.device = check_device(device) if device is not None else None

    def plan_device(self):
        """The device a device-route batch is uploaded and planned on
        (the mesh's first card when there is a mesh); starts the CUDA
        context."""
        self.device = resolve_device(self.mesh[0] if self.mesh is not None else self.device)
        return self.device

    def lpc_analysis(self, pcm, n, precomputed_R=None):
        """(B, n) int32 -> LPC candidate arrays (see :func:`lpc_candidates_from_lags`).
        Lags from ``precomputed_R``, else the native runtime or, without it,
        exact int64 torch on the host."""
        B = pcm.shape[0]
        if not any(c <= _max_valid_order(n) for c in C.LPC_ORDER_CANDIDATES):
            ncl = len(C.LPC_ORDER_CANDIDATES)
            return (np.zeros((ncl, B, 13), np.int16), np.zeros((ncl, B), np.int32),
                    np.zeros((ncl, B), bool), _max_valid_order(n))
        R = precomputed_R
        if R is None:
            R = (native.autocorr(pcm, 12) if native.native_available()
                 else lpc.autocorrelation(torch.from_numpy(pcm), 12).numpy())
        return lpc_candidates_from_lags(R, n)

    def _batch_cap(self, n):
        if self.device is not None:
            cap = max(1, self.MAX_DEVICE_ELEMS // max(n, 1))
            return min(1 << (cap.bit_length() - 1), 1024)
        if native.native_available():
            return self.GROUP_LANES
        # plan_group on the host: keep the (B, 11, n) int64 working set small
        return max(1, (self.MAX_DEVICE_ELEMS // 8) // max(n, 1))

    def make_jobs(self, pcm):
        """Split a group into batch jobs (see :class:`_GroupJob`)."""
        pcm_np = np.ascontiguousarray(pcm, dtype=np.int32)
        step = self._batch_cap(pcm_np.shape[1])
        return [_GroupJob(self, pcm_np[lo : lo + step]) for lo in range(0, max(pcm_np.shape[0], 1), step)]

    def encode_group_async(self, pcm):
        """Dispatch all device work for a (B, n) group; returns a finisher
        that gives the list of payload bytes."""
        jobs = self.make_jobs(pcm)
        for j in jobs:
            j.dispatch_autocorr()
        for j in jobs:
            j.dispatch_plan()
        return lambda: [pb for j in jobs for pb in j.finish()]

    def encode_group(self, pcm):
        """Encode a (B, n) int32 group; returns the list of payload bytes."""
        return self.encode_group_async(pcm)()

    def encode_lanes(self, data_list):
        """Encode channel blocks of any lengths; payloads in order. Lanes
        are grouped by length and every group's jobs go through the three
        phases together, so uploads, device work, copies and host packing
        overlap across groups (lac_tpu/encoder.py:1299-1322)."""
        out = [None] * len(data_list)
        by_len = {}
        for i, d in enumerate(data_list):
            by_len.setdefault(len(d), []).append(i)
        with _dbg.phase("group_stage"):
            staged = [(idxs, self.make_jobs(np.stack([data_list[i] for i in idxs]))) for idxs in by_len.values()]
        for _, jobs in staged:
            for j in jobs:
                j.dispatch_autocorr()
        for _, jobs in staged:
            for j in jobs:
                j.dispatch_plan()
        for idxs, jobs in staged:
            for i, pb in zip(idxs, (pb for j in jobs for pb in j.finish())):
                out[i] = pb
        return out

    def _emit(self, ship, meta, coeffs, used, max_valid_order, B, n):
        """Payload bytes from ``plan_group``'s token codes
        (lac_tpu/encoder.py:915-1032): ``ship`` expands to (head, unary,
        tail) fields, interleaved for every lane at once; each lane's wire
        prefix (predictor header, Q15 coefficients, control byte,
        partition metadata) is a short list; :func:`.bitio.pack.pack_stream`
        packs each lane."""
        if np.any(meta[:, 2] == 0):
            raise ValueError("an LPC residual overflow lane reached _emit: such lanes take the ladder replan")
        sel = meta[:, 0].astype(np.int32)
        best_p = meta[:, 1].astype(np.int32)
        max_p0 = max_partition_order_for_block(n) if (self.partitioning_enabled and n >= C.MIN_PARTITION_SIZE) else 0
        max_parts = 1 << max_p0
        sel_modes = meta[:, 3 : 3 + max_parts]
        sel_ks = meta[:, 3 + max_parts : 3 + 2 * max_parts]

        # compact codes -> (head, unary, tail) token fields
        shipv = ship.reshape(B, n, 6)
        payload = shipv[..., :4].copy().view("<u4")[..., 0]
        headcode = shipv[..., 4]
        k = shipv[..., 5].astype(np.uint32)
        cls = headcode & 7
        head_val = (headcode >> 3) & 7
        head_len = headcode >> 6
        rice_like = cls == CLS_RICE
        is_run = cls == CLS_RUN
        is_esc = cls == CLS_ESCAPE
        q = payload >> k
        rem = payload & ((np.uint32(1) << k) - np.uint32(1))
        rl = payload - np.uint32(C.ZERO_RUN_MIN_LENGTH)
        unary = np.where(rice_like, q, np.where(is_run, rl >> np.uint32(C.ZERO_RUN_LENGTH_K), np.uint32(0)))
        tail_val = np.where(rice_like, rem, np.where(is_run, rl & np.uint32(3), np.where(is_esc, payload, np.uint32(0))))
        tail_len = np.where(rice_like, k + 1, np.where(is_run, 1 + C.ZERO_RUN_LENGTH_K, np.where(is_esc, 32, 0)))

        # (head, unary + tail) element pairs of every lane
        body_u = np.zeros((B, 2 * n), dtype=np.uint32)
        body_v = np.zeros((B, 2 * n), dtype=np.uint32)
        body_l = np.zeros((B, 2 * n), dtype=np.uint8)
        body_v[:, 0::2] = head_val
        body_l[:, 0::2] = head_len
        body_u[:, 1::2] = unary
        body_v[:, 1::2] = tail_val
        body_l[:, 1::2] = tail_len

        out = []
        for row in range(B):
            ci = int(sel[row])
            ptype, oparam = _CANDIDATES[ci]
            pre_vals, pre_lens = [ptype], [8]
            if ptype == C.PREDICTOR_LPC:
                li = ci - _LPC_BASE
                chosen_order = max(1, min(int(used[li, row]), max_valid_order))
                pre_vals.append(chosen_order)
                pre_lens.append(8)
                pre_vals += [int(np.uint16(coeffs[li, row, i])) for i in range(1, chosen_order + 1)]
                pre_lens += [16] * chosen_order
            else:
                pre_vals.append(oparam)
                pre_lens.append(8)
            p = int(best_p[row])
            nparts = 1 << p
            modes, ks = sel_modes[row, :nparts], sel_ks[row, :nparts]
            pre_vals.append(control_byte(int(modes[0]), p))
            pre_lens.append(8)
            pre_vals += [(int(m) << 5) | int(kk) for m, kk in zip(modes, ks)]
            pre_lens += [7] * nparts
            out.append(pack_stream(np.concatenate([np.zeros(len(pre_vals), np.uint32), body_u[row]]),
                                   np.concatenate([np.asarray(pre_vals, np.uint32), body_v[row]]),
                                   np.concatenate([np.asarray(pre_lens, np.uint8), body_l[row]])))
        return out


# ======================================================================= frame


class FrameEncoder:
    """Whole-file encoder on ``device`` ("cuda" by default, or "cpu"):
    the plane pipeline plans the full-block prefix on the device (at
    least ``device_pipeline.MIN_FULL_BLOCKS`` full blocks); the host
    route (:meth:`encode_frame`) plans the other blocks and assembles
    the v3 frame. With ``mesh`` (a :func:`.parallel.make_mesh` tuple) the
    plane pipeline spreads its chunks over the mesh's cards instead of
    ``device``. Same constructor, setters and output bytes as
    ``lac_tpu.encoder.FrameEncoder``."""

    def __init__(self, order=12, stereo_mode=C.STEREO_PER_BLOCK, sample_rate=44100,
                 bit_depth=16, device="cuda", mesh=None):
        self._device = check_device(device)  # a missing card raises here; the context starts on first use
        self.mesh = None
        self.set_mesh(mesh)
        self.order = order
        self.stereo_mode = stereo_mode
        self.sample_rate = sample_rate
        self.bit_depth = bit_depth
        self.zero_run_enabled = True
        self.partitioning_enabled = True
        self.thread_count = 0
        self.debug_lpc = False
        self.debug_stereo_est = False
        self.debug_partitions = False

    @property
    def device(self):
        """The resolved device. A CUDA context starts when this is first
        read, so an input that never reaches the card starts none."""
        self._device = resolve_device(self._device)
        return self._device

    def set_zero_run_enabled(self, enabled):
        self.zero_run_enabled = enabled

    def set_partitioning_enabled(self, enabled):
        self.partitioning_enabled = enabled

    def set_thread_count(self, n):
        self.thread_count = n

    def set_debug_lpc(self, enabled):
        self.debug_lpc = enabled

    def set_debug_stereo_est(self, enabled):
        self.debug_stereo_est = enabled

    def set_debug_partitions(self, enabled):
        self.debug_partitions = enabled

    def set_mesh(self, mesh):
        """Spread the plane pipeline's chunks, and without the native
        runtime the group route's plan batches, over ``mesh`` (a tuple of
        devices, see :func:`.parallel.make_mesh`; None: ``device`` alone).
        Output bytes are those of one device."""
        self.mesh = make_mesh(mesh) if mesh is not None else None

    def _validate(self, left, right):
        if len(left) == 0:
            raise ValueError("left channel must not be empty")
        if len(right) and len(right) != len(left):
            raise ValueError(
                f"right channel size ({len(right)}) must match left channel size ({len(left)})"
            )
        if self.sample_rate not in C.SUPPORTED_SAMPLE_RATES:
            raise ValueError(f"unsupported sample rate: {self.sample_rate}")
        if self.bit_depth not in C.SUPPORTED_BIT_DEPTHS:
            raise ValueError(f"unsupported bit depth: {self.bit_depth}")
        if self.stereo_mode > 2:
            raise ValueError(f"unsupported stereo mode: {self.stereo_mode}")
        lo, hi = C.pcm_range(self.bit_depth)
        for name, ch in (("left", left), ("right", right)):
            if len(ch) and (int(ch.min()) < lo or int(ch.max()) > hi):
                raise ValueError(f"{name} sample is outside the configured PCM bit depth")

    def _channels(self, left, right):
        left = np.ascontiguousarray(left, dtype=np.int32)
        right = np.ascontiguousarray(right, dtype=np.int32) if len(right) else np.empty(0, np.int32)
        with _dbg.phase("validate"):
            self._validate(left, right)
        return left, right

    def encode(self, left, right=()):
        """Encode PCM channel vectors to a complete .lac frame (bytes): the
        plane pipeline for the full-block prefix, the host route for every
        other lane, or without the native runtime the group route on this
        encoder's device. In a process that has not used the card yet, a
        short input takes the host route throughout (:func:`_cold_route`)."""
        with _dbg.device_trace(), _dbg.request("encode"):
            return self._encode(left, right)

    def _encode(self, left, right):
        from . import device_pipeline

        _dbg.timing_reset()
        left, right = self._channels(left, right)
        nblocks = -(-len(left) // C.MAX_BLOCK_SIZE)
        nfull = len(left) // C.MAX_BLOCK_SIZE
        if self._device.type == "cuda" and _cold_route(nblocks):
            out = self._encode_frame(left, right, None)
        else:
            planes = None
            if device_pipeline.applicable(nfull):
                if not len(right):
                    kind = "mono"
                else:
                    kind = {C.STEREO_LR: "lr", C.STEREO_MS: "ms", C.STEREO_PER_BLOCK: "auto"}[self.stereo_mode]
                device = self.device if self.mesh is None else None  # a mesh names its own cards
                with _dbg.phase("plane_pipeline"):
                    planes = device_pipeline.encode_full_blocks(self, left, right, nfull, kind, device,
                                                                mesh=self.mesh)
            # The lanes the plane pipeline leaves (inputs under its minimum,
            # tails, probes) are few: with the native runtime they take the
            # host route, which beat the card's group plans on every such
            # input measured on the H100; without it, the group route.
            group_device = None if native.native_available() else self._device
            out = self._encode_frame(left, right, planes, device=group_device)
        _dbg.timing_report(f"encode {len(left)} frames x{2 if len(right) else 1}ch")
        return out

    def encode_frame(self, left, right=(), planes=None):
        """The host route: plan every block that ``planes`` does not hold
        with the native planner, then assemble the v3 frame
        (lac/encoder.cpp:215-466).

        ``planes``: the plane pipeline's result for the full-block prefix
        (payloads {block: {slot: bytes}}, stereo flags {block: 0|1},
        uncertain {block: bool}), or None to plan every block here.
        """
        return self._encode_frame(*self._channels(left, right), planes)

    def _stereo_decisions(self, left, right, full):
        """(choose_ms, uncertain) of the full blocks ``full`` (a prefix):
        one native pass, or without the native runtime the stereo proxy on
        CPU tensors in chunks of 64 blocks over a thread pool
        (lac_tpu/encoder.py:1210-1239)."""
        N = C.MAX_BLOCK_SIZE
        nf = len(full)
        lmat, rmat = left[: nf * N].reshape(nf, N), right[: nf * N].reshape(nf, N)
        if native.native_available():
            return native.stereo_estimate(lmat, rmat, self.thread_count)

        def decide(lo):
            lt, rt = torch.from_numpy(lmat[lo : lo + 64]), torch.from_numpy(rmat[lo : lo + 64])
            cm, un = estimate_stereo_mode(lt, rt, torch.ones_like(lt, dtype=torch.bool))
            return cm.numpy(), un.numpy()

        bounds = range(0, nf, 64)
        workers = min(self.thread_count or (os.cpu_count() or 4), len(bounds))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            parts = list(ex.map(decide, bounds))
        return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])

    def _encode_frame(self, left, right, planes, device=None):
        """Plan the blocks ``planes`` does not hold and assemble the frame:
        on the host route, or with ``device`` through the group route
        (:class:`ChannelBlockEncoder` on that device and this encoder's mesh)."""
        is_stereo = len(right) > 0
        stereo_mode = self.stereo_mode if is_stereo else 0
        force_ms = is_stereo and stereo_mode == C.STEREO_MS
        per_block = is_stereo and stereo_mode == C.STEREO_PER_BLOCK
        N = C.MAX_BLOCK_SIZE

        n = len(left)
        starts = list(range(0, n, N))
        sizes = [min(N, n - s) for s in starts]
        nblocks = len(starts)
        plane_payloads, plane_flags, plane_uncertain = planes if planes is not None else ({}, {}, {})
        if not all(0 <= b < n // N for b in plane_payloads):
            raise ValueError("plane payloads must cover full blocks of this input only")

        # ---------------- stereo decisions for the blocks planned here
        decisions = [None] * nblocks
        with _dbg.phase("stereo_estimate"):
            if per_block:
                full = [bi for bi, sz in enumerate(sizes) if sz == N and bi not in plane_payloads]
                if full:  # the full-block prefix, whenever the plane pipeline did not run
                    cm, un = self._stereo_decisions(left, right, full)
                    for j, bi in enumerate(full):
                        decisions[bi] = (bool(cm[j]), bool(un[j]))
                for bi, (s, sz) in enumerate(zip(starts, sizes)):
                    if decisions[bi] is None and bi not in plane_payloads:
                        decisions[bi] = estimate_stereo_mode_host(left[s : s + sz], right[s : s + sz])

        # ---------------- lane planning: (block, slot) lanes, probe lanes
        # and speculative full variants for uncertain big blocks, dual
        # full variants for uncertain small blocks
        with _dbg.phase("lane_build"):
            lanes, lane_meta = [], []
            block_flags = [None] * nblocks
            deferred = []
            probe_lanes, dual_lanes, spec_lanes = [], [], []

            def lr_channels(s, sz):
                return [left[s : s + sz], right[s : s + sz]] if is_stereo else [left[s : s + sz]]

            def ms_channels(s, sz):
                return list(ms_transform_host(left[s : s + sz], right[s : s + sz]))

            for bi, (s, sz) in enumerate(zip(starts, sizes)):
                if bi in plane_payloads:
                    if per_block:
                        block_flags[bi] = plane_flags[bi]
                    continue
                if not is_stereo:
                    lanes.append(left[s : s + sz])
                    lane_meta.append((bi, 0))
                elif force_ms or (per_block and not decisions[bi][1] and decisions[bi][0]):
                    if per_block:
                        block_flags[bi] = 1
                    for slot, chd in enumerate(ms_channels(s, sz)):
                        lanes.append(chd)
                        lane_meta.append((bi, slot))
                elif not per_block or not decisions[bi][1]:
                    if per_block:
                        block_flags[bi] = 0
                    for slot, chd in enumerate(lr_channels(s, sz)):
                        lanes.append(chd)
                        lane_meta.append((bi, slot))
                elif sz <= C.STEREO_FULL_COMPARISON_LIMIT:  # uncertain, small
                    for variant, chans in (("lr", lr_channels(s, sz)), ("ms", ms_channels(s, sz))):
                        for slot, chd in enumerate(chans):
                            dual_lanes.append((bi, variant, slot, chd))
                else:  # uncertain, big: probes pick which speculated variant to keep
                    for ps in (s, s + (sz - C.STEREO_PROBE_SIZE) // 2, s + sz - C.STEREO_PROBE_SIZE):
                        for chd in lr_channels(ps, C.STEREO_PROBE_SIZE):
                            probe_lanes.append((bi, "lr", chd))
                        for chd in ms_channels(ps, C.STEREO_PROBE_SIZE):
                            probe_lanes.append((bi, "ms", chd))
                    for variant, chans in (("lr", lr_channels(s, sz)), ("ms", ms_channels(s, sz))):
                        for slot, chd in enumerate(chans):
                            spec_lanes.append((bi, variant, slot, chd))
                    deferred.append(bi)

        enc = ChannelBlockEncoder(self.zero_run_enabled, self.partitioning_enabled, self.thread_count,
                                  mesh=self.mesh if device is not None else None, device=device)
        with _dbg.phase("host_plan"):
            payloads = enc.encode_lanes(
                lanes + [d for *_, d in probe_lanes] + [d for *_, d in dual_lanes] + [d for *_, d in spec_lanes]
            )
        off = len(lanes)
        probe_payloads = payloads[off : off + len(probe_lanes)]
        off += len(probe_lanes)
        dual_payloads = payloads[off : off + len(dual_lanes)]
        spec_payloads = payloads[off + len(dual_lanes) :]

        block_channel_payloads = {bi: {} for bi in range(nblocks)}
        for bi, chans in plane_payloads.items():
            block_channel_payloads[bi].update(chans)
        for (bi, slot), pb in zip(lane_meta, payloads[: len(lanes)]):
            block_channel_payloads[bi][slot] = pb

        # uncertain small blocks: the full dual comparison by bytes
        dual_by_block = {}
        for (bi, variant, slot, _), pb in zip(dual_lanes, dual_payloads):
            dual_by_block.setdefault(bi, {}).setdefault(variant, {})[slot] = pb
        for bi, variants in dual_by_block.items():
            lr_bytes = b"".join(variants["lr"][s] for s in sorted(variants["lr"]))
            ms_bytes = b"".join(variants["ms"][s] for s in sorted(variants["ms"]))
            choose_ms = len(ms_bytes) < len(lr_bytes)
            block_flags[bi] = 1 if choose_ms else 0
            block_channel_payloads[bi].update(variants["ms" if choose_ms else "lr"])

        # uncertain big blocks: probe byte totals pick the speculated variant
        probe_by_block = {}
        for (bi, variant, _), pb in zip(probe_lanes, probe_payloads):
            probe_by_block.setdefault(bi, {"lr": 0, "ms": 0})[variant] += len(pb)
        spec_by_block = {}
        for (bi, variant, slot, _), pb in zip(spec_lanes, spec_payloads):
            spec_by_block.setdefault(bi, {}).setdefault(variant, {})[slot] = pb
        for bi in deferred:
            choose_ms = probe_by_block[bi]["ms"] < probe_by_block[bi]["lr"]
            block_flags[bi] = 1 if choose_ms else 0
            block_channel_payloads[bi].update(spec_by_block[bi]["ms" if choose_ms else "lr"])

        self._debug_report(is_stereo, per_block, force_ms, stereo_mode, sizes, block_flags, decisions,
                           plane_uncertain, block_channel_payloads)

        # ---------------- assembly
        with _dbg.phase("assembly"):
            hdr = FrameHeader(channels=2 if is_stereo else 1, stereo_mode=stereo_mode,
                              sample_rate=self.sample_rate, bit_depth=self.bit_depth, version=C.FORMAT_VERSION)
            parts = []
            block_lens = np.empty(nblocks, np.int64)
            for bi in range(nblocks):
                blen = 0
                if per_block:
                    parts.append(bytes([block_flags[bi]]))
                    blen += 1
                chans = block_channel_payloads[bi]
                for slot in sorted(chans):
                    parts.append(chans[slot])
                    blen += len(chans[slot])
                block_lens[bi] = blen
            if block_lens.min() == 0 or block_lens.max() > 0xFFFFFFFF:
                raise RuntimeError("encoded block size is outside format limits")
            table = np.empty((nblocks, 2), dtype=">u4")
            table[:, 0] = np.asarray(sizes, np.int64)
            table[:, 1] = block_lens
            out = hdr.pack() + nblocks.to_bytes(4, "big") + table.tobytes() + b"".join(parts)
        return out

    def _debug_report(self, is_stereo, per_block, force_ms, stereo_mode, sizes, block_flags, decisions,
                      plane_uncertain, block_channel_payloads):
        """The ``--debug-*`` reports (reference debug-build analogs:
        [stereo-est] lac/encoder.cpp:356-380; [debug-lpc]
        block/encoder.cpp:824-835; [part-plan] block/encoder.cpp:558-582),
        printed from wire data and measured decisions."""
        nblocks = len(sizes)
        if self.debug_stereo_est and is_stereo:
            for bi in range(nblocks):
                chosen = "MS" if (force_ms or block_flags[bi] == 1) else "LR"
                if per_block:
                    if bi in plane_uncertain:
                        un_flag = int(plane_uncertain[bi])
                    else:
                        un_flag = int(decisions[bi][1]) if decisions[bi] else 0
                    debug_log(f"[stereo-est] block={bi} uncertain={un_flag} chosen={chosen}")
                debug_log(f"[stereo-mode] global={stereo_mode} block={bi} mode_used={chosen}")
        if not (self.debug_lpc or self.debug_partitions):
            return
        for bi in range(nblocks):
            chans = block_channel_payloads[bi]
            for slot in sorted(chans):
                info = parse_block_header(chans[slot], sizes[bi])
                if info is None:
                    continue
                if self.debug_lpc:
                    debug_log(f"[debug-lpc] block={sizes[bi]} chosen_order={info['order']}"
                              f" predictor={info['ptype']} part_order={info['partition_order']}"
                              f" bytes={len(chans[slot])}")
                if self.debug_partitions:
                    parts = " ".join(f"[{i} mode={m} k={k} len={ln}]"
                                     for i, (m, k, ln) in enumerate(info["partitions"]))
                    debug_log(f"[part-plan] block={bi} ch={slot} order={info['partition_order']}"
                              f" parts={len(info['partitions'])} {parts}")
