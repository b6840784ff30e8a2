"""Batched block planner and frame encoder on PyTorch (lac_tpu/encoder.py).

``plan_group`` is the array program that chooses, for every lane of a
group of equal-length channel blocks, the predictor candidate, the
residual mode and the partitioning with the reference's exact cost
models and tie-breaks (lac_tpu/encoder.py:180-520). It returns the
compact ``meta`` rows only; the native runtime replays the plan on the
host and writes the bytes.

u32 codes and u64 bit totals are carried in int64 (totals <= 2^46, so
the ordering and every sum are exact); the kernels of
:mod:`.ops.cuda_kernels` take the codes as an int32 view of their bits.

``FrameEncoder`` runs the plane pipeline (:mod:`.device_pipeline`) for
the full-block prefix and hands its payloads to the shared host encoder
(``lac_tpu.encoder.FrameEncoder`` with numpy), which plans the tail
block and assembles the frame.
"""

import functools

import numpy as np
import torch

from lac_tpu.encoder import _CANDIDATES, _LPC_BASE
from lac_tpu.encoder import FrameEncoder as HostFrameEncoder
from lac_tpu.format import constants as C
from lac_tpu.format.partitions import max_partition_order_for_block

from . import resolve_device, upload
from .format.zigzag import zigzag_encode
from .ops import adapt, predictors, runs
from .ops._backend import shift_right, u32_from_bits
from .ops.cuda_kernels import k_cost_sums

_INT64_MAX = torch.iinfo(torch.int64).max


def plan_inputs_to_torch(coeffs, lvalid, device):
    """Host LPC candidate set -> planner inputs on ``device``:
    coeffs (5, B, 13) int16 and valid (5, B) bool."""
    device = torch.device(device)
    return upload(np.asarray(coeffs, dtype=np.int16), device), upload(np.asarray(lvalid, dtype=bool), device)


def _repeat_cols(a, sizes, n):
    """Repeat columns of (B, S) by per-column counts ``sizes`` -> (B, n)."""
    return torch.repeat_interleave(a, sizes, dim=-1, output_size=n)


def _pad_to_byte(bits):
    return bits + ((8 - (bits & 7)) & 7)


def _rice_cost(u, k_used):
    q = torch.where(k_used >= C.MAX_RICE_K, 0, u >> k_used)
    return q + 1 + k_used.to(torch.int64)


def _mode_cost_fields(v, u, k_used, run_len, long_run, run_start):
    """Per-sample bit costs for rice / zr / bin (encoder.cpp:201-263), int64."""
    rice_per = _rice_cost(u, k_used)
    absv = v.to(torch.int64).abs()
    bin_per = torch.where(absv == 0, 2, torch.where(absv <= 2, 3, 2 + rice_per))
    esc = 1 << torch.clamp(k_used + C.ESCAPE_K_OFFSET, max=C.ESCAPE_K_CAP).to(torch.int64)
    token_per = 2 + torch.where(u > esc, 32, rice_per)
    # only read at run starts, where run_len >= ZERO_RUN_MIN_LENGTH
    run_per = 2 + ((run_len.to(torch.int64) - C.ZERO_RUN_MIN_LENGTH) >> C.ZERO_RUN_LENGTH_K) + (
        1 + C.ZERO_RUN_LENGTH_K)
    zr_per = torch.where(run_start, run_per, torch.where(long_run, 0, token_per))
    return rice_per, bin_per, zr_per


def _k_costs_stack(u32, k_max, width=None):
    """Rice-cost sums for k in [0, k_max] over the first ``width``
    samples of each row of ``u32`` (..., n): (..., k_max+1) int64.

    ``u >> k = ((u >> 16) << (16 - k)) + ((u & 0xFFFF) >> k)`` for k <= 16,
    so the 17 row sums of the k-cost kernel give every cost.
    """
    assert k_max <= 16
    lead = u32.shape[:-1]
    rows = u32.reshape(-1, u32.shape[-1])
    if width is not None:
        rows = rows[:, :width]
    sums = u32_from_bits(k_cost_sums(rows)).reshape(lead + (17,))
    karr = torch.arange(k_max + 1, dtype=torch.int64, device=u32.device)
    shi, slo = sums[..., :1], sums[..., 1 : k_max + 2]
    return (shi << (16 - karr)) + slo + (karr + 1) * rows.shape[1]


@functools.lru_cache(maxsize=64)
def _partition_geometry(n, p, device):
    """Static geometry of partition order ``p`` on ``device``, uploaded
    once per process (a host->device copy inside the planner would
    synchronise the stream)."""
    nparts = 1 << p
    starts = np.minimum(np.arange(nparts, dtype=np.int64) * (n >> p), n)
    ends = np.concatenate([starts[1:], [n]])
    sizes = ends - starts
    head_ends = np.minimum(starts + C.INITIAL_SCAN_COUNT, ends)
    pos = np.concatenate([np.arange(sz, dtype=np.int64) for sz in sizes])
    seg_end = np.repeat(ends, sizes)
    geometry = dict(starts=starts, ends=ends, sizes=sizes, head_ends=head_ends,
                    head_sizes=head_ends - starts, pos=pos, seg_end=seg_end)
    return {k: upload(v, device) for k, v in geometry.items()}


@functools.lru_cache(maxsize=8)
def _ptype_table(device):
    return torch.tensor([t for t, _ in _CANDIDATES], dtype=torch.int64, device=device)


def plan_group(pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled):
    """pcm (B, n) + LPC candidates -> plan ``meta`` (B, 3 + 2 * max_parts) int8:
    selected candidate, partition order, lane in-range flag, then the
    partition modes and ks (lac_tpu/encoder.py:443-459).

    ``lpc_coeffs``: (5, B, 13) int16 Q15 candidate sets; ``lpc_valid``:
    (5, B) bool. Everything runs on ``pcm``'s device.
    """
    dev = pcm.device
    B = pcm.shape[0]
    pcm = pcm.to(torch.int32)

    # ---- candidate residuals (B, ncand, n)
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
    u = zigzag_encode(residuals)
    u32 = u.to(torch.int32)  # bit view for the kernels
    head_costs = _k_costs_stack(u32, C.INITIAL_MAX_K, width=min(C.INITIAL_SCAN_COUNT, n))
    initial_k = torch.argmin(head_costs, dim=-1).to(torch.int32)

    k_used = adapt.k_used_from_after(adapt.k_after_stateful(u32), initial_k)
    pos = torch.arange(n, device=dev)
    run_len, long_run, run_start = runs.zero_run_info(residuals == 0, pos, n)
    rice_per, bin_per, zr_per = _mode_cost_fields(residuals, u, k_used, run_len, long_run, run_start)
    del k_used, run_len, long_run
    rice_bits = rice_per.sum(dim=-1)
    bin_bits = bin_per.sum(dim=-1)
    zr_bits = zr_per.sum(dim=-1)
    has_run = run_start.any(dim=-1)
    del rice_per, bin_per, zr_per, run_start

    static_costs = _k_costs_stack(u32, C.MAX_STATIC_K)
    static_bits = static_costs.min(dim=-1).values
    static_k = torch.argmin(static_costs, dim=-1).to(torch.int32)

    # ---- candidate selection: lexicographic (bits, predictor_type, order)
    # as one first-minimum argmin over key = bits * 4 + predictor_type
    zr_eff = torch.where(has_run, zr_bits, rice_bits) if zero_run_enabled else rice_bits
    best_bits_all = torch.minimum(torch.minimum(rice_bits, static_bits), torch.minimum(zr_eff, bin_bits))
    key = torch.where(valid, best_bits_all * 4 + _ptype_table(dev), _INT64_MAX)
    sel_idx = torch.argmin(key, dim=-1)

    def g2(a):  # (B, ncand) -> the selected candidate's entry
        return a.gather(1, sel_idx[:, None])[:, 0]

    sel3 = sel_idx[:, None, None].expand(B, 1, n)
    v_w = residuals.gather(1, sel3)[:, 0]
    u_w = u.gather(1, sel3)[:, 0]
    del residuals, u, u32
    initial_k_w = g2(initial_k)
    static_k_w = g2(static_k)

    # ---- whole-block residual-mode choice (encoder.cpp:441-456)
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
    max_p = max_partition_order_for_block(n) if (partitioning_enabled and n >= C.MIN_PARTITION_SIZE) else 0
    max_parts = 1 << max_p
    best_p = torch.zeros((B,), dtype=torch.int32, device=dev)
    best_total = _pad_to_byte(best + (8 + 7))
    sel_modes = torch.zeros((B, max_parts), dtype=torch.int32, device=dev)
    sel_ks = torch.zeros((B, max_parts), dtype=torch.int32, device=dev)
    sel_modes[:, 0] = base_mode
    sel_ks[:, 0] = base_k

    if max_p > 0:
        zw0 = v_w == 0
        last_nz, next_nz = runs.zero_breaks(zw0)
        u_w32 = u_w.to(torch.int32)
        zero1 = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        csz_hi = torch.cat([zero1, torch.cumsum(u_w >> 16, dim=-1)], dim=-1)  # (B, n+1)
        csz_lo = torch.cat([zero1, torch.cumsum(u_w & 0xFFFF, dim=-1)], dim=-1)
        karr = torch.arange(C.MAX_STATIC_K + 1, dtype=torch.int64, device=dev)
    if any(n % (1 << p) for p in range(1, max_p + 1)):
        # per-k shifted-low cost cumsums (B, n+1, 16): odd block sizes
        # only (unequal partitions); power-of-two blocks never build it
        lo_k = torch.stack([(u_w & 0xFFFF) >> k for k in range(C.MAX_STATIC_K + 1)], dim=-1)
        csz_lok = torch.cat(
            [torch.zeros((B, 1, C.MAX_STATIC_K + 1), dtype=torch.int64, device=dev),
             torch.cumsum(lo_k, dim=-2)], dim=-2
        )

    def _k_cost_seg(starts, ends, seg_sizes, kmax):
        """Per-partition rice-cost stack from the split cumsums: (B, nparts, kmax+1)."""
        hi_seg = csz_hi[:, ends] - csz_hi[:, starts]
        lo_seg = csz_lok[:, ends, : kmax + 1] - csz_lok[:, starts, : kmax + 1]
        ka = karr[: kmax + 1]
        return (hi_seg[..., None] << (16 - ka)) + lo_seg + (ka + 1) * seg_sizes[..., None]

    for p in range(1, max_p + 1):
        base = n >> p
        nparts = 1 << p
        g = _partition_geometry(n, p, dev)

        def rep(a):
            return _repeat_cols(a, g["sizes"], n)

        equal = n % nparts == 0
        if equal:
            u3 = u_w32.reshape(B, nparts, base)
            hc = _k_costs_stack(u3, C.INITIAL_MAX_K, width=min(C.INITIAL_SCAN_COUNT, base))
        else:
            hc = _k_cost_seg(g["starts"], g["head_ends"], g["head_sizes"], C.INITIAL_MAX_K)
        init_k_seg = torch.argmin(hc, dim=-1).to(torch.int32)  # (B, nparts)

        # stateless per-sample k from segment sums of the split cumsums
        seg_hi = csz_hi[:, 1:] - rep(csz_hi[:, g["starts"]])
        seg_lo = csz_lo[:, 1:] - rep(csz_lo[:, g["starts"]])
        k_after_sl = adapt.k_after_stateless((seg_hi << 16) + seg_lo, g["pos"])
        k_used_p = torch.where(g["pos"] == 0, rep(init_k_seg), shift_right(k_after_sl, 1)).to(torch.int32)

        rl_p, long_p, start_p = runs.run_geometry(zw0, last_nz, next_nz, g["pos"], g["seg_end"])
        rice_pp, bin_pp, zr_pp = _mode_cost_fields(v_w, u_w, k_used_p, rl_p, long_p, start_p)
        if equal:
            rice_s = rice_pp.reshape(B, nparts, base).sum(dim=-1)
            bin_s = bin_pp.reshape(B, nparts, base).sum(dim=-1)
            zr_s = zr_pp.reshape(B, nparts, base).sum(dim=-1)
            has_run_s = start_p.reshape(B, nparts, base).any(dim=-1)
            sc = _k_costs_stack(u3, C.MAX_STATIC_K)
        else:
            stacked = torch.stack([rice_pp, bin_pp, zr_pp, start_p.to(torch.int64)], dim=-1)
            cs = torch.cat([torch.zeros((B, 1, 4), dtype=torch.int64, device=dev),
                            torch.cumsum(stacked, dim=-2)], dim=-2)
            seg = cs[:, g["ends"]] - cs[:, g["starts"]]
            rice_s, bin_s, zr_s = seg[..., 0], seg[..., 1], seg[..., 2]
            has_run_s = seg[..., 3] > 0
            sc = _k_cost_seg(g["starts"], g["ends"], g["sizes"], C.MAX_STATIC_K)
        static_s = sc.min(dim=-1).values
        static_k_s = torch.argmin(sc, dim=-1).to(torch.int32)

        mode_s = torch.zeros((B, nparts), dtype=torch.int32, device=dev)
        bits_s = rice_s
        k_s = init_k_seg
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

    # overflow only matters for candidates actually under consideration
    # (the reference skips unstable/zero-order candidates before ever
    # computing a residual, block/encoder.cpp:395-398)
    lane_in_range = (lpc_in_range | ~lpc_valid).all(dim=0)
    cols = [sel_idx[:, None], best_p[:, None], lane_in_range[:, None], sel_modes, sel_ks]
    return torch.cat([c.to(torch.int8) for c in cols], dim=-1)


# ======================================================================= frame


class FrameEncoder:
    """Whole-file encoder on ``device`` ("cpu" or "cuda"): the plane
    pipeline plans the full-block prefix (at least
    ``device_pipeline.MIN_FULL_BLOCKS`` full blocks); the shared host
    encoder plans the tail and assembles the v3 frame. Shorter inputs
    are planned on the host alone. Same constructor, setters and output
    bytes as ``lac_tpu.encoder.FrameEncoder``."""

    def __init__(self, order=12, stereo_mode=C.STEREO_PER_BLOCK, sample_rate=44100,
                 bit_depth=16, device="cpu"):
        self.device = resolve_device(device)
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

    def host_encoder(self):
        """The shared numpy/native ``lac_tpu`` encoder with this encoder's
        settings: it plans the tail and assembles the frame, and on its
        own it is the reference the port's bytes are held to."""
        host = HostFrameEncoder(self.order, self.stereo_mode, self.sample_rate, self.bit_depth, xp=np)
        host.set_zero_run_enabled(self.zero_run_enabled)
        host.set_partitioning_enabled(self.partitioning_enabled)
        host.set_thread_count(self.thread_count)
        host.set_debug_lpc(self.debug_lpc)
        host.set_debug_stereo_est(self.debug_stereo_est)
        host.set_debug_partitions(self.debug_partitions)
        return host

    def encode(self, left, right=()):
        """Encode PCM channel vectors to a complete .lac frame (bytes)."""
        from . import device_pipeline

        left = np.ascontiguousarray(left, dtype=np.int32)
        right = np.ascontiguousarray(right, dtype=np.int32) if len(right) else np.empty(0, np.int32)
        host = self.host_encoder()
        host._validate(left, right)
        nfull = len(left) // C.MAX_BLOCK_SIZE
        if device_pipeline.applicable(nfull):
            if not len(right):
                kind = "mono"
            else:
                kind = {C.STEREO_LR: "lr", C.STEREO_MS: "ms", C.STEREO_PER_BLOCK: "auto"}[self.stereo_mode]
            host._injected_planes = device_pipeline.encode_full_blocks(
                self, left, right, nfull, kind, self.device
            )
        return host.encode(left, right)
