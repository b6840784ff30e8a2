"""Persistent warm-process codec service on the card (lac_tpu/serve.py).

One process stays alive and routes any number of jobs through it: the
native runtime, the built kernels and the CUDA context are made once, so
the Nth file pays no start-up (a fresh process spends seconds importing
torch alone).

Usage:

    python -m lac_tpu_torch.serve [--workers=N] [--warm[=BLOCKS]] [--no-pool]

With ``--workers>1``, queued encode jobs are pooled: their full
16384-sample blocks fill shared device waves (:mod:`.pool`), so many
short files plan in full-width batches. ``--no-pool`` (or
``LAC_TPU_SERVE_POOL=0``) keeps one pipeline per file; ``--pool`` turns
pooling back on.

Protocol (line-oriented, stdin -> stdout, one JSON object per line):

    encode <in.wav> <out.lac> [encode flags...]   # same flags as the CLI
    decode <in.lac> <out.wav> [decode flags...]
    warm [BLOCKS]        # build, start the card and run a synthetic encode now
    wait                 # barrier: responds after all prior jobs finish
    ping                 # liveness probe
    quit                 # drain in-flight jobs, then exit 0 (EOF too)

With ``--workers>1`` jobs run concurrently and finish in any order, so a
piped script whose later jobs read earlier jobs' outputs must put
``wait`` between the phases. Responses (``id`` is the 1-based request
line number; blank and comment lines take none):

    {"id": 1, "ok": true, "rc": 0, "message": "Encoded a.wav -> a.lac (123 bytes)", "ms": 41.7}
    {"id": 2, "ok": false, "rc": 1, "error": "Failed to read WAV: missing.wav", "ms": 0.3}

Jobs reuse the CLI entry point (:func:`.cli.main`), so flags, staged
atomic output, messages and exit codes are the CLI's. Protocol, flags,
messages, response shapes and environment knobs are ``lac_tpu.serve``'s.
Where this module differs, and why:

- Jobs run on ``device`` ("cuda" unless the caller asks for "cpu"), and
  no CUDA context starts until a job needs one. Without a card each
  encode fails as the CLI does (``Error: ...``, rc 1) and the service
  goes on: ``decode`` is host-native. A ``--warm`` that fails answers
  id 0 with the error instead of ending the service.
- :func:`warm_process`'s grid is one of captured plans, not of compiled
  executables: on every card of the default mesh
  (:func:`.parallel.default_mesh`, every visible card when there are two
  or more) it captures the CUDA graphs of ``plan_group`` that an encode
  of up to ``BLOCKS`` full blocks replays (:func:`warm_plan_shapes`),
  then runs the same synthetic encode on the mesh. It has no ``dtypes``
  argument and no ``LAC_TPU_WARM_THREADS``/``LAC_TPU_WARM_EXTRA``: a
  capture takes the card for itself, so the grid is captured in turn,
  and the gather and pad executables those knobs warmed are eager torch
  operators here. Pooled waves and per-job encodes run on the same mesh.
- The device watchdog has no host fallback. The reference forces
  ``LAC_TPU_BACKEND=numpy`` and re-runs stuck jobs natively; the port has
  no such backend, and running them on the host would hide that the card
  failed. A wave past ``LAC_TPU_SERVE_DEVICE_TIMEOUT_S`` (default 600;
  0 disables) marks the service sick for the life of the process, on
  every card it uses (a wave spans the whole mesh): every job of that
  wave and of its batch, and every encode accepted afterwards, is
  answered ``{"ok": false, "rc": 1, "error": "device wave exceeded Ns;
  ..."}`` and none of them runs. ``decode``, ``ping`` and ``wait`` keep
  working.
- The watchdog takes the running wave's start, jobs and sequence number
  as one snapshot under a lock and declares the service sick only if
  that wave is still running (the reference reads the start unlocked, so
  a wave ending at the deadline as the next began could mark a healthy
  service sick). It answers the jobs it rescues itself and never submits
  to the worker pool, which may already be shut down.
- A pooled wave that raises writes one line to stderr and is counted
  (``_PoolBatcher.wave_failures``); its unreleased jobs still take the
  per-job CLI path, on the same device and with the same bytes.
"""

import io
import json
import os
import shlex
import signal
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from . import check_device

__all__ = ["serve", "run_job", "warm_process"]


class _ThreadRouter(io.TextIOBase):
    """A stdout/stderr proxy that routes writes to a per-thread buffer
    when one is registered, else to the real stream. Lets concurrent
    jobs capture their CLI messages without interleaving."""

    def __init__(self, fallback):
        super().__init__()
        self.fallback = fallback
        self.local = threading.local()

    def write(self, s):
        buf = getattr(self.local, "buf", None)
        (self.fallback if buf is None else buf).write(s)
        return len(s)

    def flush(self):
        if getattr(self.local, "buf", None) is None:
            self.fallback.flush()

    def writable(self):
        return True


def run_job(argv, device="cuda"):
    """Run one CLI job vector (e.g. ["encode", "a.wav", "a.lac"]) in
    this process on ``device``; returns (rc, stdout_text, stderr_text)."""
    from . import cli

    out_router = sys.stdout if isinstance(sys.stdout, _ThreadRouter) else None
    err_router = sys.stderr if isinstance(sys.stderr, _ThreadRouter) else None
    out_buf, err_buf = io.StringIO(), io.StringIO()
    if out_router is not None:
        out_router.local.buf = out_buf
    if err_router is not None:
        err_router.local.buf = err_buf
    try:
        if out_router is None:  # direct library use, no serve loop active
            from contextlib import redirect_stderr, redirect_stdout

            with redirect_stdout(out_buf), redirect_stderr(err_buf):
                rc = cli.main(argv, device=device)
        else:
            rc = cli.main(argv, device=device)
    finally:
        if out_router is not None:
            out_router.local.buf = None
        if err_router is not None:
            err_router.local.buf = None
    return rc, out_buf.getvalue(), err_buf.getvalue()


def _chunk_widths(blocks):
    """The chunk widths that an encode of at most ``blocks`` full blocks
    may take: every width of ``CHUNK_LADDER`` up to its own (a pinned
    ``CHUNK_BLOCKS`` alone)."""
    from . import device_pipeline as DP

    if DP.CHUNK_BLOCKS:
        return (DP.CHUNK_BLOCKS,)
    top = DP.chunk_width(max(int(blocks), 1))
    return tuple(k for k in DP.CHUNK_LADDER if k <= top)


def warm_plan_shapes(blocks, mesh_size=1, emit_fields=False):
    """The plan shapes ``(rows, n, emit_fields)`` that an encode of at most
    ``blocks`` full blocks replays on each card, in the order of
    lac_tpu/serve.py:168-300's grid: the plane pipeline's full-width
    batches at every chunk width of ``CHUNK_LADDER`` up to the one such an
    encode takes, with their doubled batches, and its probe batch (12
    lanes a block); then the group route's batches at its caps, split over
    a mesh of ``mesh_size`` cards (``_GroupJob``'s padding). The plane
    pipeline never emits token fields; the group route does without the
    native runtime (``emit_fields``)."""
    from . import device_pipeline as DP
    from .encoder import ChannelBlockEncoder
    from .format import constants as C

    shapes = []
    for k in _chunk_widths(blocks):
        for bp in (k, 2 * k) if 2 * k in DP.CHUNK_LADDER else (k,):
            shapes.append((bp, DP.N, False))
        shapes.append((12 * k, DP.PROBE, False))
    group = ChannelBlockEncoder(device="cpu")
    for n in (C.MAX_BLOCK_SIZE, C.STEREO_PROBE_SIZE):
        cap = group._batch_cap(n)
        shapes.append((-(-cap // mesh_size), n, emit_fields))
    return list(dict.fromkeys(shapes))


def warm_analyze_shapes(blocks, mesh_size=1):
    """The analyze and lag graphs that an encode of at most ``blocks``
    full blocks replays on a card, as ``("analyze", K, kind, dtype)`` and
    ``("lags", rows, n, dtype)``: the plane pipeline's ``auto`` analyze of
    16-bit planes at every chunk width that :func:`warm_plan_shapes`
    warms (lac_tpu/serve.py:242-272 warms these through its probe chain),
    then the group route's lags of 16-bit lanes at its caps. The group
    route computes a batch's lags whole on the mesh's first card and
    splits only its plan, so a lag batch is the cap padded to a multiple
    of ``mesh_size`` (``_GroupJob``'s padding), not a shard of it."""
    from .encoder import ChannelBlockEncoder
    from .format import constants as C

    shapes = [("analyze", k, "auto", "int16") for k in _chunk_widths(blocks)]
    group = ChannelBlockEncoder(device="cpu")
    for n in (C.MAX_BLOCK_SIZE, C.STEREO_PROBE_SIZE):
        shapes.append(("lags", -(-group._batch_cap(n) // mesh_size) * mesh_size, n, "int16"))
    return shapes


def warm_process(blocks=128, device="cuda"):
    """Make this process ready for jobs on ``device`` now: build the
    native runtime and, on the card, the kernels (at once), capture on
    every card of the default mesh the plans, analyzes and lags an encode
    of up to ``blocks`` full blocks replays (:func:`warm_plan_shapes`,
    :func:`warm_analyze_shapes`), then encode
    a synthetic stereo signal of ``blocks`` full blocks and a tail in
    memory, on the mesh (the reference's signal, so the byte count
    equals ``lac_tpu.serve.warm_process``'s). Returns that count.
    ``LAC_TPU_WARM_DEBUG=1`` writes each stage's seconds to stderr."""
    import numpy as np

    from . import device_pipeline, resolve_device
    from .encoder import FrameEncoder
    from .format import constants as C
    from .parallel import default_mesh
    from .plan_graphs import analyzed, lags_of, planned
    from .runtime import native

    dbg = os.environ.get("LAC_TPU_WARM_DEBUG") == "1"
    t_last = [time.perf_counter()]

    def _stage(name):
        if dbg:
            now = time.perf_counter()
            sys.stderr.write(f"warm[{name}] {now - t_last[0]:.1f}s\n")
            sys.stderr.flush()
            t_last[0] = now

    device = check_device(device)
    if device.type == "cuda":
        from .ops import _cuda_lib

        with ThreadPoolExecutor(2) as ex:
            for f in [ex.submit(native.native_available), ex.submit(_cuda_lib.load)]:
                f.result()
    else:
        native.native_available()
    _stage("build")
    device = resolve_device(device)
    mesh = default_mesh() if device.type == "cuda" else None
    if device.type == "cuda":  # every card's context and its graphs, captured on zero inputs
        import torch

        cards = list(dict.fromkeys(mesh)) if mesh is not None else [device]
        mesh_size = len(mesh) if mesh is not None else 1
        ncl = len(C.LPC_ORDER_CANDIDATES)
        for rows, n, emit in warm_plan_shapes(blocks, mesh_size, emit_fields=not native.native_available()):
            for card in cards:
                planned(torch.zeros((rows, n), dtype=torch.int32, device=card),
                        torch.zeros((ncl, rows, 13), dtype=torch.int16, device=card),
                        torch.zeros((ncl, rows), dtype=torch.bool, device=card), n, True, True,
                        emit_fields=emit, rows=rows)
        for what, rows, arg, dtype in warm_analyze_shapes(blocks, mesh_size):
            for card in cards:
                if what == "analyze":
                    planes = torch.zeros((rows, device_pipeline.N), dtype=getattr(torch, dtype), device=card)
                    analyzed(planes, planes, rows, arg)
                else:
                    lags_of(torch.zeros((rows, arg), dtype=getattr(torch, dtype), device=card), rows)
    _stage("graphs")
    # full blocks take the plane pipeline (from device_pipeline.MIN_FULL_BLOCKS
    # on), the tail just under a full block the host route
    n = int(blocks) * C.MAX_BLOCK_SIZE + C.MAX_BLOCK_SIZE - 7
    rng = np.random.RandomState(7)
    left = rng.randint(-(1 << 14), 1 << 14, n).astype(np.int32)
    right = (left // 2 + rng.randint(-(1 << 8), 1 << 8, n)).astype(np.int32)
    if device.type == "cuda":
        device_pipeline.mark_warm()  # the warm-up exists to reach the card: no cold route
    nbytes = len(FrameEncoder(12, C.STEREO_PER_BLOCK, 44100, 16, device=device, mesh=mesh).encode(left, right))
    _stage("encode")
    return nbytes


def _respond(lock, out, obj):
    line = json.dumps(obj, separators=(", ", ": "))
    with lock:
        out.write(line + "\n")
        out.flush()


def _ms(t0):
    return round((time.perf_counter() - t0) * 1e3, 1)


class _PoolBatcher:
    """Cross-file wave batching for encode jobs (:mod:`.pool`).

    Encode jobs queued while a wave runs accumulate; the batcher drains
    them at once, prescreens and reads them (``pool.prepare_encode_job``,
    at most ``pool._MAX_WAVE_BLOCKS`` full blocks resident, the rest
    requeued at the front), pools compatible ones' full blocks into
    shared device waves (``split_waves``, ``run_group_wave``) and releases
    each file to a worker-pool finish task (tail block, frame assembly,
    staged write: the CLI path with the WAV and the planes injected) as
    soon as its blocks have emitted. Jobs that cannot pool (debug flags,
    the streaming route, bad arguments, no card) take the per-job handler,
    which gives every message and exit code as the CLI does.

    Every job is answered exactly once: ``_claim`` decides which of the
    wave's release, the per-job path and the watchdog owns it. The
    watchdog (see the module docstring) marks the service sick when a wave
    outlives ``LAC_TPU_SERVE_DEVICE_TIMEOUT_S`` and answers every job the
    stuck wave and its batch still own with an error.
    """

    def __init__(self, pool, handle, respond, device="cuda"):
        self.pool = pool  # worker ThreadPoolExecutor (per-job path + finishes)
        self.handle = handle  # ordinary job handler(job_id, parts)
        self.respond = respond  # respond(obj)
        self.device = device
        self.cv = threading.Condition()  # pending, closed, busy, fenced
        self.pending = []
        self.closed = False
        self.busy = 0  # accepted jobs not yet answered
        self.fenced = 0  # accepted since the last drain (wait counting)
        try:
            self.device_timeout = float(os.environ.get("LAC_TPU_SERVE_DEVICE_TIMEOUT_S", "600"))
        except ValueError:
            self.device_timeout = 600.0
        # claims and the wave state (taken after cv where both are held)
        self.lock = threading.Lock()
        self.claimed = set()  # job ids routed to exactly one dispatch
        self.wave_seq = 0  # waves begun
        self.wave_start = None  # perf_counter when the running wave began
        self.wave_jobs = ()  # records of the running wave
        self.cur_batch = ()  # batch _loop is processing
        self.device_sick = False
        self.wave_failures = 0
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()
        if self.device_timeout > 0:
            self.monitor = threading.Thread(target=self._monitor, daemon=True)
            self.monitor.start()

    def _claim(self, job_id):
        """Claim the right to dispatch (and so to answer) a job. Exactly
        one dispatch point wins; the rest must skip."""
        with self.lock:
            if job_id in self.claimed:
                return False
            self.claimed.add(job_id)
            return True

    def _sick_error(self):
        return (f"device wave exceeded {self.device_timeout:g}s; the service is marked sick on every card "
                f"its waves use, and encodes fail until it restarts")

    def _refuse(self, job_id, t0):
        """Answer a claimed job with the sick-card error; it does not run."""
        try:
            self.respond({"id": job_id, "ok": False, "rc": 1, "error": self._sick_error(), "ms": _ms(t0)})
        finally:
            self._done_one()

    def _wave_snapshot(self):
        """(sequence number, start, records) of the running wave, taken together."""
        with self.lock:
            return self.wave_seq, self.wave_start, self.wave_jobs

    def _check_deadline(self, now, snapshot=None):
        """Mark the service sick when the wave of ``snapshot`` (default: the
        one running now) has run ``device_timeout`` seconds at ``now`` and
        is still the running wave; then answer every job that wave, its
        batch and the queue still own. Returns whether it did."""
        seq, start, _ = self._wave_snapshot() if snapshot is None else snapshot
        if self.device_timeout <= 0 or start is None or now - start < self.device_timeout:
            return False
        with self.cv, self.lock:
            if self.device_sick or self.wave_seq != seq or self.wave_start is None:
                return False  # that wave ended: the card is not stuck
            self.device_sick = True
            owned = [(rec[1], rec[3]) for rec in self.wave_jobs]
            owned += [(job_id, t0) for job_id, _parts, t0 in (*self.cur_batch, *self.pending)]
            self.pending = []
            rescued = {job_id: t0 for job_id, t0 in owned if job_id not in self.claimed}
            self.claimed.update(rescued)
        sys.stderr.write(f"lac_tpu_torch.serve: device wave exceeded {self.device_timeout:g}s; "
                         f"encodes now fail until restart\n")
        for job_id, t0 in rescued.items():
            self._refuse(job_id, t0)
        return True

    def _monitor(self):
        tick = max(0.05, min(5.0, self.device_timeout / 10.0))
        while not self.device_sick:  # once sick, submit() answers every new encode itself
            time.sleep(tick)
            with self.cv:
                if self.closed and not self.pending and not self.busy:
                    return
            self._check_deadline(time.perf_counter())

    def submit(self, job_id, parts):
        t0 = time.perf_counter()
        with self.cv:
            self.busy += 1
            self.fenced += 1
            if not self.device_sick:
                self.pending.append((job_id, parts, t0))
                self.cv.notify_all()
                return
        if self._claim(job_id):
            self._refuse(job_id, t0)

    def drain(self):
        """Block until every accepted job has been answered; returns the
        number of jobs fenced since the previous drain (the `wait`
        response counts them beside the direct worker futures)."""
        with self.cv:
            while self.busy:
                self.cv.wait()
            n, self.fenced = self.fenced, 0
            return n

    def close(self):
        with self.cv:
            self.closed = True
            self.cv.notify_all()
        # a batcher thread stuck on a sick card never exits; it is a
        # daemon, so stop waiting once the service is marked sick
        while self.thread.is_alive() and not self.device_sick:
            self.thread.join(timeout=1.0)

    def _done_one(self):
        with self.cv:
            self.busy -= 1
            self.cv.notify_all()

    def _loop(self):
        from . import pool as P

        while True:
            with self.cv:
                while not self.pending and not self.closed:
                    self.cv.wait()
                if not self.pending and self.closed:
                    return
                batch, self.pending = self.pending, []
            routed = set()  # batch indices _process dispatched or requeued
            with self.lock:
                self.cur_batch = batch
            try:
                self._process(batch, P, routed)
            except Exception as e:  # noqa: BLE001 — keep the batcher alive
                # _process records every entry it dispatched or requeued in
                # `routed`; only the rest take the per-job path (a second
                # dispatch would answer a job twice)
                sys.stderr.write(f"lac_tpu_torch.serve: batch failed ({_one_line(e)})\n")
                for bi, (job_id, parts, _t0) in enumerate(batch):
                    if bi not in routed and self._claim(job_id):
                        self.pool.submit(self._fallback, job_id, parts)
            finally:
                with self.lock:
                    self.cur_batch = ()

    def _fallback(self, job_id, parts):
        try:
            self.handle(job_id, parts)
        finally:
            self._done_one()

    def _finish(self, job_id, parts, prep, planes, t0):
        from . import cli

        try:
            try:
                cli._set_encode_injection(prep.in_path, prep.wav, planes)
                try:
                    rc, out_text, err_text = run_job(parts, device=self.device)
                finally:
                    cli._pop_encode_injection(prep.in_path)  # defensive clear
                res = {"id": job_id, "ok": rc == 0, "rc": rc}
                if out_text.strip():
                    res["message"] = out_text.strip()
                if err_text.strip():
                    res["error"] = err_text.strip()
            except Exception as e:  # noqa: BLE001 — service boundary
                res = {"id": job_id, "ok": False, "rc": 1, "error": str(e)}
            res["ms"] = _ms(t0)
            self.respond(res)
        finally:
            # ack only AFTER the response is on the wire: drain()/wait
            # promises every accepted job has been answered
            self._done_one()

    def _begin_wave(self, wave):
        with self.lock:
            self.wave_seq += 1
            self.wave_start = time.perf_counter()
            self.wave_jobs = wave

    def _end_wave(self):
        with self.lock:
            self.wave_start = None
            self.wave_jobs = ()

    def _process(self, batch, P, routed):
        try:
            check_device(self.device)
        except (RuntimeError, ValueError):  # no card: the per-job path answers as the CLI does
            for bi, (job_id, parts, _t0) in enumerate(batch):
                routed.add(bi)
                if self._claim(job_id):
                    self.pool.submit(self._fallback, job_id, parts)
            return
        groups = {}
        pooled_blocks = 0
        for bi, (job_id, parts, t0) in enumerate(batch):
            if pooled_blocks >= P._MAX_WAVE_BLOCKS:
                # prescreening reads each WAV whole; cap what is resident
                # at once to about one wave and requeue the rest at the
                # FRONT (order kept; submit already counted busy/fenced)
                with self.cv:
                    self.pending[:0] = batch[bi:]
                routed.update(range(bi, len(batch)))
                break
            try:
                prep = P.prepare_encode_job(parts)
            except Exception:  # noqa: BLE001 — prescreen must never kill a job
                prep = None
            if prep is None:
                routed.add(bi)
                if self._claim(job_id):
                    self.pool.submit(self._fallback, job_id, parts)
            else:
                groups.setdefault(prep.key, []).append((bi, job_id, parts, t0, prep))
                pooled_blocks += prep.nfull
        for jobs in groups.values():
            for wave in P.split_waves(jobs, nfull_of=lambda rec: rec[4].nfull):
                # jobs the watchdog answered while an earlier wave was stuck
                # must not be encoded (or answered) again
                with self.lock:
                    wave = [rec for rec in wave if rec[1] not in self.claimed]
                if not wave:
                    continue
                released = set()

                def done(i, planes, wave=wave, released=released):
                    bi, job_id, parts, t0, prep = wave[i]
                    if not self._claim(job_id):  # the watchdog answered it
                        released.add(i)
                        routed.add(bi)
                        return
                    # submit BEFORE marking released: a failed submit
                    # (executor shutting down) leaves the job to the
                    # unreleased path below, or it would never be answered
                    try:
                        self.pool.submit(self._finish, job_id, parts, prep, planes, t0)
                    except BaseException:
                        with self.lock:
                            self.claimed.discard(job_id)
                        raise
                    released.add(i)
                    routed.add(bi)

                self._begin_wave(wave)
                try:
                    P.run_group_wave([rec[4] for rec in wave], done, device=self.device)
                except Exception as e:  # noqa: BLE001 — wave failed mid-flight
                    self.wave_failures += 1
                    sys.stderr.write(f"lac_tpu_torch.serve: pooled wave of {len(wave)} files failed "
                                     f"({_one_line(e)}); its unreleased files run one by one\n")
                    for i, (bi, job_id, parts, _t0, _p) in enumerate(wave):
                        if i not in released and self._claim(job_id):
                            self.pool.submit(self._fallback, job_id, parts)
                            routed.add(bi)
                finally:
                    self._end_wave()


def _one_line(e):
    return f"{type(e).__name__}: {e}".replace("\n", " ")


def serve(argv=None, stdin=None, stdout=None, device="cuda"):
    """Run the service loop on ``device``; returns the process exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    workers = 1
    warm_blocks = None
    pooling = os.environ.get("LAC_TPU_SERVE_POOL", "1") != "0"
    for flag in argv:
        if flag.startswith("--workers="):
            try:
                workers = max(1, int(flag.split("=", 1)[1]))
            except ValueError:
                sys.stderr.write(f"Bad flag value: {flag}\n")
                return 1
        elif flag == "--warm":
            warm_blocks = 128
        elif flag.startswith("--warm="):
            try:
                warm_blocks = max(1, int(flag.split("=", 1)[1]))
            except ValueError:
                sys.stderr.write(f"Bad flag value: {flag}\n")
                return 1
        elif flag == "--no-pool":
            pooling = False
        elif flag == "--pool":
            pooling = True
        else:
            sys.stderr.write(
                "Usage: python -m lac_tpu_torch.serve [--workers=N] [--warm[=BLOCKS]] [--no-pool]\n"
            )
            return 1

    stdin = sys.stdin if stdin is None else stdin
    lock = threading.Lock()

    # Protocol isolation: clients parse one JSON object per line off our
    # stdout, but _ThreadRouter only intercepts Python-level writes; a
    # native library, g++ or nvcc writing to FILE DESCRIPTOR 1 directly
    # would interleave into the response stream. Dup the real stdout for
    # responses and point fd 1 at stderr for the loop's lifetime.
    fd_saved = None
    if stdout is None:
        real_out = None
        try:
            fd_saved = os.dup(1)
            real_out = os.fdopen(fd_saved, "w")
            sys.stdout.flush()
            os.dup2(sys.stderr.fileno(), 1)
        except (OSError, ValueError, io.UnsupportedOperation):
            # don't leak the dup'd descriptor when a later step fails
            if real_out is not None:
                real_out.close()  # owns and closes fd_saved
            elif fd_saved is not None:
                os.close(fd_saved)
            fd_saved = None
            real_out = sys.stdout
    else:
        real_out = stdout

    def respond(obj):
        _respond(lock, real_out, obj)

    # route job-thread CLI prints into per-job buffers for the lifetime
    # of the loop; responses go to the real stream
    prev_out, prev_err = sys.stdout, sys.stderr
    sys.stdout = _ThreadRouter(prev_out)
    sys.stderr = _ThreadRouter(prev_err)

    def handle(job_id, parts):
        t0 = time.perf_counter()
        try:
            if parts[0] == "warm":
                blocks = int(parts[1]) if len(parts) > 1 else 128
                nbytes = warm_process(blocks, device=device)
                res = {"id": job_id, "ok": True, "warmed_blocks": blocks, "bytes": nbytes}
            else:
                rc, out_text, err_text = run_job(parts, device=device)
                res = {"id": job_id, "ok": rc == 0, "rc": rc}
                if out_text.strip():
                    res["message"] = out_text.strip()
                if err_text.strip():
                    res["error"] = err_text.strip()
        except Exception as e:  # noqa: BLE001 — service boundary
            res = {"id": job_id, "ok": False, "rc": 1, "error": str(e)}
        res["ms"] = _ms(t0)
        respond(res)

    pool = batcher = prev_term = None
    try:
        if warm_blocks is not None:
            t0 = time.perf_counter()
            try:
                warm_process(warm_blocks, device=device)
                respond({"id": 0, "ok": True, "warmed_blocks": warm_blocks, "ms": _ms(t0)})
            except Exception as e:  # noqa: BLE001 — a failed warm-up does not end the service
                respond({"id": 0, "ok": False, "rc": 1, "error": str(e), "ms": _ms(t0)})

        pool = ThreadPoolExecutor(max_workers=workers)
        outstanding = []
        # cross-file batching only with --workers>1: a single-worker
        # service keeps strict job FIFO (piped encode-then-decode scripts
        # rely on it), which batching reorders
        if pooling and workers > 1:
            batcher = _PoolBatcher(pool, handle, respond, device=device)

        # graceful shutdown: SIGTERM behaves like `quit` (stop reading,
        # drain in-flight jobs, exit 0); restored on exit
        def _terminate(_sig, _frame):
            raise KeyboardInterrupt

        if threading.current_thread() is threading.main_thread():
            prev_term = signal.signal(signal.SIGTERM, _terminate)
        job_id = 0
        for raw in stdin:
            job_id += 1
            try:
                parts = shlex.split(raw, comments=True)
            except ValueError as e:
                respond({"id": job_id, "ok": False, "rc": 1, "error": f"bad line: {e}"})
                continue
            if not parts:
                job_id -= 1  # blank/comment lines don't consume an id
                continue
            cmd = parts[0]
            if cmd == "quit":
                break
            if cmd == "ping":
                respond({"id": job_id, "ok": True, "pong": True})
                continue
            if cmd == "wait":
                drained, outstanding[:] = list(outstanding), []
                for fut in drained:
                    fut.result()
                n_drained = len(drained)
                if batcher is not None:
                    n_drained += batcher.drain()
                respond({"id": job_id, "ok": True, "drained": n_drained})
                continue
            if cmd in ("encode", "decode", "warm"):
                if cmd in ("encode", "decode") and len(parts) < 3:
                    respond({"id": job_id, "ok": False, "rc": 1, "error": f"usage: {cmd} <in> <out> [flags...]"})
                    continue
                if cmd == "encode" and batcher is not None:
                    batcher.submit(job_id, parts)
                    continue
                outstanding.append(pool.submit(handle, job_id, parts))
                if len(outstanding) > 4 * workers:  # keep the list bounded
                    outstanding[:] = [f for f in outstanding if not f.done()]
                continue
            respond({"id": job_id, "ok": False, "rc": 1, "error": f"unknown command: {cmd}"})
    except (KeyboardInterrupt, BrokenPipeError):
        pass  # signal or client gone: drain and exit cleanly below
    finally:
        if batcher is not None:
            batcher.close()  # process remaining queued encodes first
        if pool is not None:
            pool.shutdown(wait=True)
        sys.stdout, sys.stderr = prev_out, prev_err
        if fd_saved is not None:
            try:
                real_out.flush()
                os.dup2(fd_saved, 1)  # restore the original stdout fd
            except OSError:
                pass
            real_out.close()  # closes fd_saved; fd 1 already restored
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    return 0


if __name__ == "__main__":
    sys.exit(serve())
