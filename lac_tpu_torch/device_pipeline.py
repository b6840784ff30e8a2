"""Device-resident plane pipeline for full-size blocks
(lac_tpu/device_pipeline.py).

Per chunk of K full blocks:

1. upload the L and R planes (int16 for 16-bit content, else int32) as
   they are: the reference's packed transports (delta, delta24, pack24)
   and its bucket ladder have no counterpart, because on an H100 the
   host packing cost more than the copy it saved (PERF.md §6),
2. analyze on the device as a replay of a captured :func:`analyze`
   (:func:`.plan_graphs.analyzed`), the chunk padded to K blocks of
   zeros as the reference pads it: M/S, the per-block stereo proxy
   decision (lac/encoder.cpp:126-197), the 3 x 256-sample probe slices
   and exact autocorrelation lags of every plane; the decisions and lags
   come back in one packed host buffer,
3. run the host's 80-bit Levinson-Durbin on the lags, gather the chosen
   block rows on the device and plan them in batches padded to a fixed
   lane count, each a replay of a captured ``encoder.plan_group``
   (:func:`.plan_graphs.planned`); only the compact ``meta`` rows come
   back, with the plans' tally of kernel 10's parts summed the 64-bit way
   (the ``meta_fetch`` span's ``wide`` and ``parts``),
4. replay the plans natively on the host (``lac_emit_blocks_planes``).

Uncertain stereo blocks stay in the pipeline: their probe lanes for both
variants are planned from the plane slices and both full variants are
planned speculatively; the probe byte totals pick the winner.

Chunks flow through a sliding window (analyze chunk j, plan chunk j-2,
emit chunk j-3). Device work is queued asynchronously and device->host
copies start as soon as their producer is queued, so the host's LD and
native emit overlap the device's analyze and plan.

A dispatch thread runs the window's analyze and plan stages with its
card as the thread's current device; the calling thread emits every
chunk in block order. On a mesh (:mod:`.parallel.mesh`) chunk j goes to
entry ``j % len(mesh)`` and is uploaded straight to that card, each
entry has a dispatch thread of its own for its chunks, and the entries
take turns by stage (``_dispatch_lock``). The chunk width is one
card's, so every plan shape, and the operators and kernel launches of an
encode, are those of one card. Unlike the reference,
which splits each chunk's blocks over the shards and quietly drops a
mesh that does not divide the chunk width, any mesh size works, and a
failure on any card raises out of :meth:`PlanePipeline.run`.
"""

import threading

import numpy as np
import torch

from . import HostCopy, host_empty, on_card, resolve_device, stage, upload
from .encoder import expand_plan, lpc_candidates_from_lags, plan_inputs_to_torch
from .format import constants as C
from .ops.lpc import autocorrelation
from .ops.stereo import estimate_stereo_mode, ms_transform
from .plan_graphs import analyzed, planned
from .runtime import native
from .utils import debug as _dbg

N = C.MAX_BLOCK_SIZE
PROBE = C.STEREO_PROBE_SIZE
PROBE_POS = (0, (N - PROBE) // 2, N - PROBE)  # lac/encoder.cpp:336-343
# chunk width: 0 picks from the ladder by file length (the JAX package's
# widths); tests pin a small width by setting this constant
CHUNK_BLOCKS = 0
CHUNK_LADDER = (64, 128, 256)
MIN_FULL_BLOCKS = 8
PIPE_DEPTH = 2  # analyze -> plan gap, in chunks

# process warmth: the first encode that reaches a card starts its CUDA
# context and loads the kernels' modules (seconds). Until then,
# ``encoder._cold_route`` sends short inputs to the host route, so a
# one-shot CLI encode of a short file starts no context.
_PROC_WARM = False


def mark_warm():
    global _PROC_WARM
    _PROC_WARM = True


def process_warm():
    return _PROC_WARM


class _TurnLock:
    """A lock that threads take in the order they asked for it, so that
    threads waiting for it get their turns one by one (a plain lock lets its
    last holder take it again at once). A waiter interrupted by an exception
    (KeyboardInterrupt, a signal handler that raises) gives its turn up, so
    the threads behind it are not left waiting for it."""

    def __init__(self):
        self._cv = threading.Condition()
        self._next = 0  # tickets handed out
        self._serving = 0  # ticket that holds the lock
        self._given_up = set()  # tickets of interrupted waiters, not yet passed

    def __enter__(self):
        with self._cv:
            ticket = self._next
            self._next += 1
            try:
                self._cv.wait_for(lambda: self._serving == ticket)
            except BaseException:
                self._given_up.add(ticket)
                self._pass_on()
                raise
        return self

    def __exit__(self, *exc):
        with self._cv:
            self._serving += 1
            self._pass_on()

    def _pass_on(self):  # under _cv: skip the turns that were given up
        while self._serving in self._given_up:
            self._given_up.remove(self._serving)
            self._serving += 1
        self._cv.notify_all()


# One thread at a time issues a stage's device work, whatever its card, and
# waiting threads take turns. A stage is thousands of small torch operators,
# each of which hands the interpreter lock over and takes it back: threads
# that interleave their stages pay a thread switch per operator (on H100s:
# 4 threads on one card 3x slower than one, ``ab_batch_threads.py``, and a
# lock per card made a mesh of 4 cards 1.4-1.8x slower than one card). The
# cards' device work still overlaps: a stage is queued asynchronously, and
# the next turn goes to another card while it runs. Emit, the host route
# and the wait for a chunk's analyze results run outside it.
_dispatch_lock = _TurnLock()


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
    Yields (lo, nsub, bp): ``nsub`` lanes planned as a batch of ``bp``,
    the shape of the captured plan that the batch replays
    (lac_tpu/device_pipeline.py:786-800)."""
    lo = 0
    while lo < total:
        rem = total - lo
        bp = K
        if rem > K and 2 * K in CHUNK_LADDER:
            bp = 2 * K
        yield lo, min(rem, bp), bp
        lo += bp


def applicable(nfull):
    """True when the plane pipeline plans the full-block prefix: from
    MIN_FULL_BLOCKS full blocks on, and only with the native runtime,
    whose plane replay writes its bytes (lac_tpu/device_pipeline.py:101-105)."""
    return nfull >= MIN_FULL_BLOCKS and native.native_available()


def analyze(lmat, rmat, kind):
    """Planes, stereo decisions, probes and exact lags of one chunk
    (lac_tpu/device_pipeline.py:120-199, mesh None): the function that
    :func:`.plan_graphs.analyzed` captures.

    ``lmat``/``rmat``: (K, N) integer PCM on the device. Returns a dict:
    ``planes`` (P*K, N) int32 plane-major, ``hostbuf`` int64, the packed
    host buffer (:func:`unpack_hostbuf`: for ``kind == "auto"`` the
    stereo decisions ``cm`` and ``un`` (K,), then the lags (P*K, 13) of
    the planes, flat) and, for ``kind == "auto"``, ``probes`` (4*K*3,
    PROBE) int32 and their lags ``plags`` (4*K*3, 13) int64.
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
    # what the plan stage waits for rides one buffer, one host copy; plags
    # stays apart, awaited only on the probe path
    parts = [out.pop("cm").to(torch.int64), out.pop("un").to(torch.int64)] if kind == "auto" else []
    parts.append(autocorrelation(out["planes"], 12).reshape(-1))
    out["hostbuf"] = torch.cat(parts)
    return out


def unpack_hostbuf(buf, K, kc, kind):
    """(cm, un, lags) from the packed host buffer of a chunk of ``kc``
    blocks analyzed as K (lac_tpu/device_pipeline.py:706-716): ``cm`` and
    ``un`` (kc,) bool, None unless ``kind == "auto"``; ``lags`` (P*K,
    13) int64, plane-major."""
    cm = un = None
    if kind == "auto":
        cm, un = buf[:kc].astype(bool), buf[K : K + kc].astype(bool)
        buf = buf[2 * K :]
    return cm, un, buf.reshape(-1, 13)


class _ChunkJob:
    """One chunk of kc full blocks through analyze -> plan -> emit."""

    def __init__(self, pipe, c0, kc, device, index):
        self.pipe = pipe
        self.index = index  # the chunk's place in the pipeline
        self.c0 = c0  # first block index (within the full-block prefix)
        self.kc = kc  # blocks in this chunk (<= K)
        self.device = device  # the mesh entry this chunk runs on
        self.card = str(device)

    def phase(self, name):
        """A span of this chunk's stage ``name``, tagged with the chunk and its card."""
        return _dbg.phase(name, chunk=self.index, card=self.card)

    # rows of the analyze outputs, plane-major at the padded width K
    # (lac_tpu/device_pipeline.py:582-596, mesh None)
    def _row_of(self, p, i):  # plane p, local block i -> planes row
        return p * self.pipe.K + i

    def _probe_row_of(self, p, i, pos):
        return (p * self.pipe.K + i) * 3 + pos

    # ------------------------------------------------------------ stage 1
    def dispatch_analyze(self):
        pipe = self.pipe
        with self.phase("plane_upload"):
            lmat = upload(pipe.lhost[self.c0 : self.c0 + self.kc], self.device)
            rmat = upload(pipe.rhost[self.c0 : self.c0 + self.kc], self.device) if pipe.rhost is not None else lmat
        with self.phase("analyze"):
            self.dev = analyzed(lmat, rmat, pipe.K, pipe.kind)
        self.hostbuf = HostCopy(self.dev["hostbuf"])
        self.plags = HostCopy(self.dev["plags"]) if "plags" in self.dev else None

    def await_analyze(self):
        """Wait until the packed host buffer that the plan stage reads is
        on the host (``plags`` is awaited on the probe path alone)."""
        with self.phase("analyze_wait"):
            self.hostbuf.numpy()

    # ------------------------------------------------------------ stage 2
    def dispatch_plan(self):
        pipe, K, kc = self.pipe, self.pipe.K, self.kc
        with self.phase("flags_fetch"):
            cm, un, lags = unpack_hostbuf(self.hostbuf.numpy(), K, kc, pipe.kind)
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

        with self.phase("host_ld"):
            coeffs, used, lvalid, mvo = lpc_candidates_from_lags(lags[self.rows], N)
        self.coeffs, self.used, self.mvo = coeffs, used, mvo
        self.copies_meta, self.tally = self._plan(self.dev["planes"], self.rows, coeffs, lvalid, N,
                                                  plan_batches(len(rows), K))

        if pipe.kind == "auto" and un.any():
            self._dispatch_probe_plan()
        else:
            self.probe_copies = self.probe_tally = None

    def _plan(self, src, rows, coeffs, lvalid, n, batches):
        """Gather ``rows`` of ``src`` and plan them batch by batch, each at
        its padded shape ``bp``; returns the started host copies of the
        meta rows and of the batches' tally (kernel 10's parts summed the
        64-bit way and in all, ``planned``), the tally's queued first so
        that it is on the host once the metas are."""
        pipe = self.pipe
        with self.phase("plan_dispatch"):
            rows_t = upload(rows, self.device)
            ct, vt = plan_inputs_to_torch(coeffs, lvalid, self.device)
            tally = torch.zeros(2, dtype=torch.int64, device=self.device)
            metas = []
            for lo, nsub, bp in batches:
                g = src.index_select(0, rows_t[lo : lo + nsub])
                metas.append(planned(g, ct[:, lo : lo + nsub], vt[:, lo : lo + nsub], n,
                                     pipe.zero_run, pipe.partitioning, rows=bp, tally=tally))
            tally_copy = HostCopy(tally)
            return [HostCopy(meta) for meta in metas], tally_copy

    def _dispatch_probe_plan(self):
        pipe, K = self.pipe, self.pipe.K
        plags = self.plags.numpy()
        rows, recs = [], []
        for i in np.nonzero(self.un)[0]:
            for variant, pl0 in (("lr", 0), ("ms", 2)):
                for pl in (pl0, pl0 + 1):
                    for pos in range(3):
                        rows.append(self._probe_row_of(pl, int(i), pos))
                        recs.append((int(i), variant))
        self.probe_rows, self.probe_recs = np.asarray(rows, np.int64), recs
        with self.phase("host_ld"):
            coeffs, used, lvalid, mvo = lpc_candidates_from_lags(plags[self.probe_rows], PROBE)
        self.probe_coeffs, self.probe_used, self.probe_mvo = coeffs, used, mvo
        # one fixed probe batch shape, 12 probe lanes x K blocks (lac_tpu/device_pipeline.py:859-876)
        cap = 12 * K
        batches = [(lo, min(cap, len(rows) - lo), cap) for lo in range(0, len(rows), cap)]
        self.probe_copies, self.probe_tally = self._plan(self.dev["probes"], self.probe_rows, coeffs, lvalid,
                                                         PROBE, batches)

    # ------------------------------------------------------------ stage 3
    def _fetch_metas(self, copies, tally):
        """The plan batches' meta rows, in one ``meta_fetch`` span that
        records the batches' tally as ``wide`` (kernel 10's parts summed
        the 64-bit way) and ``parts`` (the parts it summed)."""
        with self.phase("meta_fetch") as span:
            metas = [c.numpy() for c in copies]
            if span is not None:
                span.attrs["wide"], span.attrs["parts"] = (int(x) for x in tally.numpy())
        return np.concatenate(metas) if len(metas) > 1 else metas[0]

    def finish(self):
        pipe, kc = self.pipe, self.kc
        meta = self._fetch_metas(self.copies_meta, self.tally)

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
        with self.phase("emit_prep"):
            rows = np.asarray([self.c0 + i for i, _, _ in recs], np.int32)
            variants = np.asarray([v == "ms" for _, v, _ in recs], np.uint8)
            slots = np.asarray([s for _, _, s in recs], np.uint8)
            starts = np.zeros(len(recs), np.uint32)
            plan = expand_plan(meta[sel], self.coeffs[:, sel], self.used[:, sel], self.mvo, N, pipe.partitioning)
        with self.phase("native_emit"):
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
        meta = self._fetch_metas(self.probe_copies, self.probe_tally)
        with self.phase("emit_prep"):
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
        with self.phase("native_emit"):
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


def _planes(x, nfull, dt, alloc):
    """The leading ``nfull`` blocks of channel ``x`` as (nfull, N) planes of
    dtype ``dt``: ``x``'s own memory where it already is such planes, else
    a host tensor from ``alloc`` filled by numpy (:func:`.stage`)."""
    rows = x[: nfull * N].reshape(nfull, N)
    if rows.dtype == dt and rows.flags.c_contiguous:
        return rows
    return stage(rows, dt, alloc)


class PlanePipeline:
    """The plane pipeline over ``nfull`` full blocks on ``device``, or on
    the cards of ``mesh`` (a :func:`.parallel.make_mesh` tuple) when one
    is given.

    The blocks are the leading ones of ``left``/``right`` or, with
    ``views=(lview, rview)``, the rows of prebuilt (nfull, N) plane
    matrices (``rview`` None for mono) that may come from many files
    (:mod:`.pool`): once the planes are cut a block no longer knows its
    file, so the pipeline is the same.

    The plane matrices (``lhost``, ``rhost``) are host tensors in pinned
    memory where they had to be built anyway (a pooled wave's, or 16-bit
    planes cut from int32 channels), so that a chunk's planes go to the
    card without a host copy; channels already in the plane dtype are used
    as they are, and each upload stages its chunk on the dispatch thread.
    The native emit reads numpy views of the same memory (``lview``,
    ``rview``)."""

    def __init__(self, frame_enc, left, right, nfull, kind, device, views=None, mesh=None):
        # resolved here: a dispatch thread's current card is not the caller's
        self.mesh = tuple(mesh) if mesh is not None else (resolve_device(device),)
        self.kind = kind
        self.zero_run = bool(frame_enc.zero_run_enabled)
        self.partitioning = bool(frame_enc.partitioning_enabled)
        self.thread_count = int(frame_enc.thread_count)
        self.K = chunk_width(nfull)
        if views is not None:
            self.lhost, self.rhost = views
            if tuple(self.lhost.shape) != (nfull, N) or (kind == "mono") != (self.rhost is None):
                raise ValueError("views must be (nfull, N) plane matrices, the right one None for mono")
        else:
            dt = np.int16 if frame_enc.bit_depth == 16 else np.int32
            alloc = host_empty(self.mesh)
            self.lhost = _planes(left, nfull, dt, alloc)
            self.rhost = _planes(right, nfull, dt, alloc) if kind != "mono" else None
        self.lview, self.rview = (m.numpy() if isinstance(m, torch.Tensor) else m for m in (self.lhost, self.rhost))
        D = len(self.mesh)
        self.jobs = [_ChunkJob(self, c0, min(self.K, nfull - c0), self.mesh[j % D], j)
                     for j, c0 in enumerate(range(0, nfull, self.K))]

    def run(self, progress_cb=None):
        """Sliding window: analyze chunk j while planning chunk j-D and
        emitting chunk j-D-1 (D = PIPE_DEPTH; on a mesh, j and j-D count
        one entry's chunks, and emits follow block order). Returns
        (payloads {block: {slot: bytes}}, flags {block: 0|1}, uncertain
        {block: bool}).

        ``progress_cb(done_blocks, payloads, flags, uncertain)`` fires on
        the calling thread after each chunk's emit with the number of
        leading blocks that are complete (chunks finish in block order)
        and the very dicts this method returns, still filling: a pooled
        wave hands each file's entries over, popping them, while later
        chunks are on the device."""
        payloads, flags, uncertain = {}, {}, {}
        jobs = self.jobs

        def _finish(i):
            p, f, u = jobs[i].finish()
            payloads.update(p)
            flags.update(f)
            uncertain.update(u)
            jobs[i].dev = None  # release the chunk's device buffers
            if progress_cb is not None:
                progress_cb(jobs[i].c0 + jobs[i].kc, payloads, flags, uncertain)

        self._run(_finish)
        if any(d.type == "cuda" for d in self.mesh):
            mark_warm()  # this process now uses the card
        return payloads, flags, uncertain

    def _run(self, finish):
        """One dispatch thread per mesh entry (one card without a mesh is
        an entry of its own), emits on the calling thread in block order,
        so a chunk's native emit overlaps the dispatch of the chunks
        behind it. An entry analyzes its next chunk only once the chunk
        PIPE_DEPTH + 2 of its own back has been emitted, so each card holds
        the buffers of as many chunks as a window of PIPE_DEPTH + 2. The
        dispatch threads' spans are children of the calling thread's
        innermost span; the emitting thread's wait for a chunk's plan stage
        is its ``plan_wait`` span."""
        jobs, depth, D = self.jobs, PIPE_DEPTH, len(self.mesh)
        parent = _dbg.current()
        window = depth + 2
        cv = threading.Condition()
        state = {"planned": set(), "emitted": 0, "failure": None, "abort": False}

        def go_on(wanted):  # under cv: False once the run is aborted
            cv.wait_for(lambda: state["abort"] or wanted())
            return not state["abort"]

        def shard(s):
            mine = jobs[s::D]  # chunk i of this entry is chunk s + i * D

            def plan(i):
                mine[i].await_analyze()  # the card finishes it while other entries dispatch
                with _dispatch_lock:
                    mine[i].dispatch_plan()
                with cv:
                    state["planned"].add(s + i * D)
                    cv.notify_all()

            try:
                with _dbg.adopt(parent), on_card(self.mesh[s]):
                    for i, job in enumerate(mine):
                        with cv:
                            if not go_on(lambda: i < window or state["emitted"] > s + (i - window) * D):
                                return
                        with _dispatch_lock:
                            job.dispatch_analyze()
                        if i >= depth:
                            plan(i - depth)
                    for i in range(max(len(mine) - depth, 0), len(mine)):
                        with cv:
                            if state["abort"]:
                                return
                        plan(i)
            except BaseException as e:  # noqa: BLE001 — handed to the calling thread, which raises it
                with cv:
                    state["failure"] = e
                    state["abort"] = True
                    cv.notify_all()

        threads = [threading.Thread(target=shard, args=(s,), name=f"lac-dispatch-{s}-{self.mesh[s]}", daemon=True)
                   for s in range(min(D, len(jobs)))]
        for t in threads:
            t.start()
        try:
            for j in range(len(jobs)):
                with cv, jobs[j].phase("plan_wait"):
                    cv.wait_for(lambda: state["failure"] is not None or j in state["planned"])
                    if state["failure"] is not None:
                        raise state["failure"]
                finish(j)
                with cv:
                    state["emitted"] = j + 1
                    cv.notify_all()
        except BaseException:
            with cv:
                state["abort"] = True
                cv.notify_all()
            raise
        finally:
            for t in threads:
                t.join()


def encode_full_blocks(frame_enc, left, right, nfull, kind, device, mesh=None):
    """Encode the leading ``nfull`` full-size blocks on ``device`` (or on
    the cards of ``mesh``); see :meth:`PlanePipeline.run` for the result."""
    return PlanePipeline(frame_enc, left, right, nfull, kind, device, mesh=mesh).run()
