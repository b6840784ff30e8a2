"""Device-resident plane pipeline for full-size blocks
(lac_tpu/device_pipeline.py, single device).

Per chunk of K full blocks:

1. upload the L and R planes (int16 for 16-bit content, else int32),
2. analyze on the device: M/S, the per-block stereo proxy decision
   (lac/encoder.cpp:126-197), the 3 x 256-sample probe slices and exact
   autocorrelation lags of every plane,
3. run the host's 80-bit Levinson-Durbin on the lags, gather the chosen
   block rows on the device and plan them (``encoder.plan_group``); only
   the compact ``meta`` rows come back,
4. replay the plans natively on the host (``lac_emit_blocks_planes``).

Uncertain stereo blocks stay in the pipeline: their probe lanes for both
variants are planned from the plane slices and both full variants are
planned speculatively; the probe byte totals pick the winner.

Chunks flow through a sliding window (analyze chunk j, plan chunk j-2,
emit chunk j-3). Device work is queued asynchronously and device->host
copies start as soon as their producer is queued, so the host's LD and
native emit overlap the device's analyze and plan.
"""

import threading

import numpy as np
import torch

from . import HostCopy, upload
from .encoder import expand_plan, lpc_candidates_from_lags, plan_group, plan_inputs_to_torch
from .format import constants as C
from .ops.lpc import autocorrelation
from .ops.stereo import estimate_stereo_mode, ms_transform
from .runtime import native

N = C.MAX_BLOCK_SIZE
PROBE = C.STEREO_PROBE_SIZE
PROBE_POS = (0, (N - PROBE) // 2, N - PROBE)  # lac/encoder.cpp:336-343
# chunk width: 0 picks from the ladder by file length (the JAX package's
# widths); tests pin a small width by setting this constant
CHUNK_BLOCKS = 0
CHUNK_LADDER = (64, 128, 256)
MIN_FULL_BLOCKS = 8
PIPE_DEPTH = 2  # analyze -> plan gap, in chunks
# One thread at a time queues a chunk's device work. A stage is thousands
# of small torch operators, each of which hands the interpreter lock over
# and takes it back: pipelines on several threads (``batch.encode_batch``)
# that interleave their stages pay a thread switch per operator (measured
# on an H100: 4 threads 3x slower than one; ``ab_batch_threads.py``).
# Emit, the waits on copies and the host route run outside the lock.
_dispatch_lock = threading.Lock()


def chunk_width(nfull):
    if CHUNK_BLOCKS:
        return CHUNK_BLOCKS
    k = CHUNK_LADDER[0]
    for cand in CHUNK_LADDER[1:]:
        if nfull >= cand:
            k = cand
    return k


def plan_batches(total, K):
    """Plan batches for ``total`` full-block lanes at chunk width ``K``:
    one doubled batch where 2K is a ladder width, else K lanes each.
    Yields (lo, nsub, bp); the port plans exactly ``nsub`` rows (it has
    no fixed executable shapes to pad to)."""
    lo = 0
    while lo < total:
        rem = total - lo
        bp = K
        if rem > K and 2 * K in CHUNK_LADDER:
            bp = 2 * K
        yield lo, min(rem, bp), bp
        lo += bp


def applicable(nfull):
    """True when the plane pipeline plans the full-block prefix."""
    return nfull >= MIN_FULL_BLOCKS


def analyze(lmat, rmat, kind):
    """Planes, stereo decisions, probes and exact lags of one chunk.

    ``lmat``/``rmat``: (kc, N) integer PCM on the device. Returns a dict:
    ``planes`` (P*kc, N) int32 plane-major, ``lags`` (P*kc, 13) int64 and,
    for ``kind == "auto"``, ``cm``/``un`` (kc,) bool, ``probes``
    (4*kc*3, PROBE) int32 and ``plags`` (4*kc*3, 13) int64.
    """
    l32 = lmat.to(torch.int32)
    out = {}
    if kind == "mono":
        planes = l32[None]
    else:
        r32 = rmat.to(torch.int32)
        if kind == "lr":
            planes = torch.stack([l32, r32])
        else:
            m32, s32 = ms_transform(l32, r32)
            if kind == "ms":
                planes = torch.stack([m32, s32])
            else:  # auto: per-block proxy decision + probe lanes
                planes = torch.stack([l32, r32, m32, s32])
                out["cm"], out["un"] = estimate_stereo_mode(l32, r32, torch.ones_like(l32, dtype=torch.bool))
                probes = torch.stack([planes[:, :, p : p + PROBE] for p in PROBE_POS], dim=2)
                out["probes"] = probes.reshape(-1, PROBE)  # (4, kc, 3, PROBE) row order
                out["plags"] = autocorrelation(out["probes"], 12)
    out["planes"] = planes.reshape(-1, N)
    out["lags"] = autocorrelation(out["planes"], 12)
    return out


class _ChunkJob:
    """One chunk of kc full blocks through analyze -> plan -> emit."""

    def __init__(self, pipe, c0, kc):
        self.pipe = pipe
        self.c0 = c0  # first block index (within the full-block prefix)
        self.kc = kc  # blocks in this chunk (<= K)

    def _row_of(self, p, i):  # plane p, local block i -> planes row
        return p * self.kc + i

    def _probe_row_of(self, p, i, pos):
        return (p * self.kc + i) * 3 + pos

    # ------------------------------------------------------------ stage 1
    def dispatch_analyze(self):
        pipe = self.pipe
        lmat = upload(pipe.lview[self.c0 : self.c0 + self.kc], pipe.device)
        rmat = upload(pipe.rview[self.c0 : self.c0 + self.kc], pipe.device) if pipe.rview is not None else lmat
        self.dev = analyze(lmat, rmat, pipe.kind)
        self.copies = {k: HostCopy(self.dev[k]) for k in ("cm", "un", "lags", "plags") if k in self.dev}

    # ------------------------------------------------------------ stage 2
    def dispatch_plan(self):
        pipe, K, kc = self.pipe, self.pipe.K, self.kc
        lags = self.copies["lags"].numpy()
        if pipe.kind == "auto":
            cm = self.copies["cm"].numpy()
            un = self.copies["un"].numpy()
        else:
            cm = un = None
        self.cm, self.un = cm, un

        # full-lane rows: (planes row, local block, variant, slot); plane
        # index L=0 R=1 (M=0 S=1 when the kind itself is ms), M=2 S=3 in
        # the 4-plane auto layout
        rows, recs = [], []
        for i in range(kc):
            if pipe.kind == "mono":
                rows += [self._row_of(0, i)]
                recs += [(i, "lr", 0)]
            elif pipe.kind == "lr":
                rows += [self._row_of(0, i), self._row_of(1, i)]
                recs += [(i, "lr", 0), (i, "lr", 1)]
            elif pipe.kind == "ms":
                rows += [self._row_of(0, i), self._row_of(1, i)]
                recs += [(i, "ms", 0), (i, "ms", 1)]
            elif un[i]:
                rows += [self._row_of(p, i) for p in range(4)]
                recs += [(i, "lr", 0), (i, "lr", 1), (i, "ms", 0), (i, "ms", 1)]
            elif cm[i]:
                rows += [self._row_of(2, i), self._row_of(3, i)]
                recs += [(i, "ms", 0), (i, "ms", 1)]
            else:
                rows += [self._row_of(0, i), self._row_of(1, i)]
                recs += [(i, "lr", 0), (i, "lr", 1)]
        self.rows, self.recs = np.asarray(rows, np.int64), recs

        coeffs, used, lvalid, mvo = lpc_candidates_from_lags(lags[self.rows], N)
        self.coeffs, self.used, self.mvo = coeffs, used, mvo
        self.copies_meta = self._plan(self.dev["planes"], self.rows, coeffs, lvalid, N,
                                      plan_batches(len(rows), K))

        if pipe.kind == "auto" and un.any():
            self._dispatch_probe_plan()
        else:
            self.probe_copies = None

    def _plan(self, src, rows, coeffs, lvalid, n, batches):
        """Gather ``rows`` of ``src`` and plan them batch by batch; returns
        the started host copies of the meta rows."""
        pipe = self.pipe
        rows_t = upload(rows, pipe.device)
        ct, vt = plan_inputs_to_torch(coeffs, lvalid, pipe.device)
        copies = []
        for lo, nsub, _ in batches:
            g = src.index_select(0, rows_t[lo : lo + nsub])
            meta = plan_group(g, ct[:, lo : lo + nsub], vt[:, lo : lo + nsub], n,
                              pipe.zero_run, pipe.partitioning)
            copies.append(HostCopy(meta))
        return copies

    def _dispatch_probe_plan(self):
        pipe, K = self.pipe, self.pipe.K
        plags = self.copies["plags"].numpy()
        rows, recs = [], []
        for i in np.nonzero(self.un)[0]:
            for variant, pl0 in (("lr", 0), ("ms", 2)):
                for pl in (pl0, pl0 + 1):
                    for pos in range(3):
                        rows.append(self._probe_row_of(pl, int(i), pos))
                        recs.append((int(i), variant))
        self.probe_rows, self.probe_recs = np.asarray(rows, np.int64), recs
        coeffs, used, lvalid, mvo = lpc_candidates_from_lags(plags[self.probe_rows], PROBE)
        self.probe_coeffs, self.probe_used, self.probe_mvo = coeffs, used, mvo
        cap = 12 * K  # 12 probe lanes per block
        batches = [(lo, min(cap, len(rows) - lo), cap) for lo in range(0, len(rows), cap)]
        self.probe_copies = self._plan(self.dev["probes"], self.probe_rows, coeffs, lvalid, PROBE, batches)

    # ------------------------------------------------------------ stage 3
    def finish(self):
        pipe, kc = self.pipe, self.kc
        metas = [c.numpy() for c in self.copies_meta]
        meta = np.concatenate(metas) if len(metas) > 1 else metas[0]

        # resolve uncertain stereo decisions before full-lane emission:
        # both full variants were planned, only the winner is emitted
        flags, uncertain = {}, {}
        if pipe.kind == "auto":
            for i in range(kc):
                uncertain[i] = bool(self.un[i])
                if not self.un[i]:
                    flags[i] = 1 if self.cm[i] else 0
            if self.un.any():
                self._finish_probes(flags)

        def _wins(i, variant):
            if pipe.kind in ("mono", "lr"):
                return variant == "lr"
            if pipe.kind == "ms":
                return variant == "ms"
            return variant == ("ms" if flags[i] else "lr")

        sel = np.asarray([j for j, (i, v, _) in enumerate(self.recs) if _wins(i, v)], np.intp)
        recs = [self.recs[j] for j in sel]
        rows = np.asarray([self.c0 + i for i, _, _ in recs], np.int32)
        variants = np.asarray([v == "ms" for _, v, _ in recs], np.uint8)
        slots = np.asarray([s for _, _, s in recs], np.uint8)
        starts = np.zeros(len(recs), np.uint32)
        plan = expand_plan(meta[sel], self.coeffs[:, sel], self.used[:, sel], self.mvo, N, pipe.partitioning)
        payloads = native.emit_blocks_planes(
            pipe.lview, pipe.rview, rows, variants, slots, starts, N, *plan, num_threads=pipe.thread_count,
        )

        result = {}
        for (i, _, slot), pb in zip(recs, payloads):
            result.setdefault(self.c0 + i, {})[slot] = pb
        return (
            result,
            {self.c0 + i: f for i, f in flags.items()},
            {self.c0 + i: u for i, u in uncertain.items()},
        )

    def _finish_probes(self, flags):
        pipe = self.pipe
        metas = [c.numpy() for c in self.probe_copies]
        meta = np.concatenate(metas) if len(metas) > 1 else metas[0]
        rows, variants, slots, starts = [], [], [], []
        for i in sorted({i for i, _ in self.probe_recs}):
            for variant in ("lr", "ms"):
                for slot in (0, 1):
                    for pos in PROBE_POS:
                        rows.append(self.c0 + i)
                        variants.append(variant == "ms")
                        slots.append(slot)
                        starts.append(pos)
        plan = expand_plan(meta, self.probe_coeffs, self.probe_used, self.probe_mvo, PROBE, pipe.partitioning)
        payloads = native.emit_blocks_planes(
            pipe.lview, pipe.rview,
            np.asarray(rows, np.int32), np.asarray(variants, np.uint8),
            np.asarray(slots, np.uint8), np.asarray(starts, np.uint32), PROBE,
            *plan, num_threads=pipe.thread_count,
        )
        totals = {}
        for (i, variant), pb in zip(self.probe_recs, payloads):
            t = totals.setdefault(i, {"lr": 0, "ms": 0})
            t[variant] += len(pb)
        for i, t in totals.items():
            flags[i] = 1 if t["ms"] < t["lr"] else 0


class PlanePipeline:
    """The plane pipeline over ``nfull`` full blocks on ``device``.

    The blocks are the leading ones of ``left``/``right`` or, with
    ``views=(lview, rview)``, the rows of prebuilt (nfull, N) plane
    matrices (``rview`` None for mono) that may come from many files
    (:mod:`.pool`): once the planes are cut a block no longer knows its
    file, so the pipeline is the same."""

    def __init__(self, frame_enc, left, right, nfull, kind, device, views=None):
        self.device = device
        self.kind = kind
        self.zero_run = bool(frame_enc.zero_run_enabled)
        self.partitioning = bool(frame_enc.partitioning_enabled)
        self.thread_count = int(frame_enc.thread_count)
        self.K = chunk_width(nfull)
        if views is not None:
            self.lview, self.rview = views
            if self.lview.shape != (nfull, N) or (kind == "mono") != (self.rview is None):
                raise ValueError("views must be (nfull, N) plane matrices, the right one None for mono")
        else:
            dt = np.int16 if frame_enc.bit_depth == 16 else np.int32
            self.lview = np.ascontiguousarray(left[: nfull * N].reshape(nfull, N), dtype=dt)
            self.rview = (
                np.ascontiguousarray(right[: nfull * N].reshape(nfull, N), dtype=dt) if kind != "mono" else None
            )
        self.jobs = [_ChunkJob(self, c0, min(self.K, nfull - c0)) for c0 in range(0, nfull, self.K)]

    def run(self, progress_cb=None):
        """Sliding window: analyze chunk j while planning chunk j-D and
        emitting chunk j-D-1 (D = PIPE_DEPTH). Returns (payloads
        {block: {slot: bytes}}, flags {block: 0|1}, uncertain {block: bool}).

        ``progress_cb(done_blocks, payloads, flags, uncertain)`` fires
        after each chunk's emit with the number of leading blocks that
        are complete (chunks finish in block order) and the very dicts
        this method returns, still filling: a pooled wave hands each
        file's entries over, popping them, while later chunks are on the
        device."""
        payloads, flags, uncertain = {}, {}, {}
        jobs, depth = self.jobs, PIPE_DEPTH

        def _finish(i):
            p, f, u = jobs[i].finish()
            payloads.update(p)
            flags.update(f)
            uncertain.update(u)
            jobs[i].dev = None  # release the chunk's device buffers
            if progress_cb is not None:
                progress_cb(jobs[i].c0 + jobs[i].kc, payloads, flags, uncertain)

        def _dispatch(stage):
            with _dispatch_lock:
                stage()

        for j, job in enumerate(jobs):
            _dispatch(job.dispatch_analyze)
            if j >= depth:
                _dispatch(jobs[j - depth].dispatch_plan)
            if j >= depth + 1:
                _finish(j - depth - 1)
        for i in range(max(len(jobs) - depth, 0), len(jobs)):
            _dispatch(jobs[i].dispatch_plan)
        for i in range(max(len(jobs) - depth - 1, 0), len(jobs)):
            _finish(i)
        return payloads, flags, uncertain


def encode_full_blocks(frame_enc, left, right, nfull, kind, device):
    """Encode the leading ``nfull`` full-size blocks on ``device``; see
    :meth:`PlanePipeline.run` for the result."""
    return PlanePipeline(frame_enc, left, right, nfull, kind, device).run()
