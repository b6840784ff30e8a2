"""Captured plans: ``encoder.plan_group`` as one CUDA graph per padded
batch shape (lac_tpu/encoder.py:529-540 ``_jitted_plan``).

In ``lac_tpu`` the plan is a fixed-shape compiled program: one executable
per ``(n, zero_run, partitioning, emit_fields)`` and batch shape, kept in
a ``functools.lru_cache(maxsize=64)``, and every caller pads its batch to
a fixed lane count so that few shapes exist (the plane pipeline to
``bp``, its probes to ``12 * K``, the group route to ``Bp``). On a card
the counterpart of that executable is a CUDA graph of ``plan_group``,
captured once per ``(card, rows, n, zero_run, partitioning,
emit_fields)`` and replayed: one graph launch in place of the ~2,000
operators that the interpreter would issue one by one for a full-width
plan. ``plan_group`` itself is unchanged: it is what the graph captures,
what CPU tensors run, and the reference the graph is held against.

:func:`planned` is the one entry point. CPU tensors go straight to
``plan_group`` (the port's rule: the plain versions run on the CPU).
CUDA tensors replay the graph of their key, captured on first use; a
capture or a replay that fails raises, and nothing runs the plan eagerly
on the card in its place.

A replay, in order, on the caller's stream (the card's default stream):

1. the batch's rows are copied into the graph's static input buffers;
   rows past the batch are written as ``lac_tpu`` writes its padding
   (pcm 0, coefficients 0, valid False), and rows that an earlier,
   fuller batch left there are zeroed;
2. the graph is replayed;
3. the outputs' rows of the batch are copied out (``clone``) at once.

Why copy out rather than hand the caller the graph's own outputs: the
graphs of one card share one memory pool, so the next replay of *any*
graph of the card may write where this graph's outputs lie, and a caller
(a mesh's futures, a group job's ``ship``) may hold its result for
longer than until its next call. A copy of the batch's ``meta`` is 132
KB at (256, 16384); of its ``ship`` 25 MB, a few microseconds of the
card's time.

All of it, captures included, runs under one process-wide lock: the
steps above must not interleave between threads, CUDA allows only one
capture at a time in a process, and a capture that another thread's
replay interleaved would read half-filled buffers.

Launches: a capture enqueues nothing, so the kernel wrappers it runs
record their launches (``cuda_kernels.recording``) instead of counting
them; each replay adds those launches to ``cuda_kernels.launches`` and
to its card's ``card_launches``. :data:`stats` counts captures, replays
and capture seconds apart.
"""

import collections
import threading
import time

import torch

from .format import constants as C
from .format.partitions import max_partition_order_for_block
from .ops import cuda_kernels

MAX_GRAPHS = 64  # lac_tpu bounds its plan executables alike (lru_cache(maxsize=64))


class Static:
    """A graph's input buffers on one device: pcm (rows, n) int32,
    coefficients (5, rows, 13) int16 and valid (5, rows) bool, all zero
    at first. ``filled`` counts the leading rows that hold an earlier
    batch's data."""

    def __init__(self, rows, n, device):
        ncl = len(C.LPC_ORDER_CANDIDATES)
        self.pcm = torch.zeros((rows, n), dtype=torch.int32, device=device)
        self.coeffs = torch.zeros((ncl, rows, 13), dtype=torch.int16, device=device)
        self.valid = torch.zeros((ncl, rows), dtype=torch.bool, device=device)
        self.filled = 0

    def fill(self, pcm, lpc_coeffs, lpc_valid):
        """Copy a batch of ``pcm.shape[0]`` rows in on the current stream
        and zero the rows past it that an earlier, fuller batch filled."""
        nsub = pcm.shape[0]
        self.pcm[:nsub].copy_(pcm)
        self.coeffs[:, :nsub].copy_(lpc_coeffs)
        self.valid[:, :nsub].copy_(lpc_valid)
        if self.filled > nsub:
            self.pcm[nsub : self.filled].zero_()
            self.coeffs[:, nsub : self.filled].zero_()
            self.valid[:, nsub : self.filled].zero_()
        self.filled = nsub


class Captured:
    """What a capture gives: ``replay()`` reruns the captured work on the
    static buffers (a graph's bound ``replay`` keeps the graph alive),
    ``out`` holds the tensors it writes (``meta``, then ``ship`` with
    ``emit_fields``), ``launches`` the kernel launches of one replay by
    kernel name."""

    def __init__(self, replay, out, launches):
        self.replay = replay
        self.out = tuple(out)
        self.launches = dict(launches)


class GraphCache:
    """Captured plans by key ``(device index, rows, n, zero_run,
    partitioning, emit_fields)``, at most ``maxsize`` of them: the graph
    replayed longest ago goes first.

    ``capture(static, n, zero_run, partitioning, emit_fields)`` makes a
    :class:`Captured` from a key's filled :class:`Static`; on the card it
    is :func:`capture_plan`, in the CPU tests a stand-in."""

    def __init__(self, capture, maxsize=MAX_GRAPHS):
        self.capture = capture
        self.maxsize = maxsize
        self.entries = collections.OrderedDict()  # key -> (Static, Captured)
        self.stats = {"captures": 0, "replays": 0, "capture_s": 0.0}
        self.lock = threading.RLock()

    def plan(self, pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled, emit_fields=False,
             rows=None):
        """``plan_group``'s result for the batch ``pcm`` (nsub, n), planned
        as a batch of ``rows`` lanes (default nsub): ``meta`` (nsub, M),
        with ``emit_fields`` ``(meta, ship)``."""
        nsub = pcm.shape[0]
        rows = nsub if rows is None else int(rows)
        if not 0 < nsub <= rows or pcm.shape[1] != n:
            raise ValueError(f"planned: a batch of {tuple(pcm.shape)} does not fit a plan of ({rows}, {n})")
        dev = pcm.device
        key = (dev.index, rows, n, bool(zero_run_enabled), bool(partitioning_enabled), bool(emit_fields))
        with self.lock:
            entry = self.entries.get(key)
            if entry is None:
                static = Static(rows, n, dev)
                static.fill(pcm, lpc_coeffs, lpc_valid)
                t0 = time.perf_counter()
                captured = self.capture(static, *key[2:])
                self.stats["capture_s"] += time.perf_counter() - t0
                self.stats["captures"] += 1
                entry = self.entries[key] = (static, captured)
                while len(self.entries) > self.maxsize:
                    self.entries.popitem(last=False)
            else:
                self.entries.move_to_end(key)
                static, captured = entry
                static.fill(pcm, lpc_coeffs, lpc_valid)
            captured.replay()
            cuda_kernels.count_replay(captured.launches, dev)
            self.stats["replays"] += 1
            out = tuple(t[:nsub].clone() for t in captured.out)
        return out if emit_fields else out[0]


# ------------------------------------------------------------------ the card

# card index -> the memory pool that card's graphs share, and the side
# stream they are captured on. Sharing one pool is safe only because the
# replays on one card are serialised on one stream (the card's default
# stream, checked at every replay) under GraphCache.lock, and each
# replay's outputs are copied out before the next replay is queued: a
# replay may then overwrite any memory of the pool, another graph's
# outputs included, without a reader left behind.
_pools = {}
_capture_streams = {}

# A capture runs in CUDA's thread_local error mode: another thread's
# kernels, ``.item()``, event and stream syncs, host copies and pinned or
# device allocations leave it whole. A device-wide synchronize does not:
# from another thread it fails there (cudaErrorStreamCaptureUnsupported)
# and invalidates the capture (``chip_smoke.py`` phase 15 runs both on
# the card). Captures hold this lock, and the port's device-wide
# synchronize (:func:`synchronize`) takes it.
capture_lock = threading.RLock()


def synchronize(device=None):
    """``torch.cuda.synchronize(device)``, never while a plan is captured."""
    with capture_lock:
        torch.cuda.synchronize(device)


def _prefill_tables(n, partitioning_enabled, device):
    """Fill what ``plan_group`` caches per card before a capture: its
    partition geometry uploads from a temporary pinned buffer (a replay of
    a captured upload would read freed host memory), and its candidate
    table is a synchronous ``torch.tensor(..., device=)``, which would
    break the capture."""
    from . import encoder

    max_p = max_partition_order_for_block(n) if (partitioning_enabled and n >= C.MIN_PARTITION_SIZE) else 0
    for p in range(1, max_p + 1):
        encoder._partition_geometry(n, p, device)
    encoder._ptype_table(device)


def capture_plan(static, n, zero_run_enabled, partitioning_enabled, emit_fields):
    """Capture ``plan_group`` on ``static``'s card as a CUDA graph.

    Preconditions, met here in order: the kernels are built (a build
    inside a capture would break it); ``plan_group``'s per-card tables
    are filled (:func:`_prefill_tables`); one eager warm-up call runs on
    the side stream, as PyTorch's graph documentation asks. The capture
    runs in ``thread_local`` error mode under :data:`capture_lock`: what
    the pipeline's other threads do meanwhile (emits and their host
    copies, a service's job and finish threads, other cards' dispatch
    waiting on the dispatch lock) cannot break it, and this thread makes
    no unsafe call inside it."""
    from . import encoder
    from .ops import _cuda_lib

    dev = static.pcm.device
    _cuda_lib.load()
    args = (static.pcm, static.coeffs, static.valid, n, zero_run_enabled, partitioning_enabled)
    with torch.cuda.device(dev):
        _prefill_tables(n, partitioning_enabled, dev)
        if dev.index not in _pools:
            _pools[dev.index] = torch.cuda.graph_pool_handle()
            _capture_streams[dev.index] = torch.cuda.Stream(dev)
        side, current = _capture_streams[dev.index], torch.cuda.current_stream(dev)
        side.wait_stream(current)  # the static buffers were filled on the current stream
        with torch.cuda.stream(side):
            encoder.plan_group(*args, emit_fields=emit_fields)  # the warm-up: eager, its launches count
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with capture_lock, cuda_kernels.recording() as launches:
            with torch.cuda.graph(graph, pool=_pools[dev.index], stream=side, capture_error_mode="thread_local"):
                out = encoder.plan_group(*args, emit_fields=emit_fields)
    return Captured(graph.replay, out if emit_fields else (out,), launches)


_CACHE = GraphCache(capture_plan)
stats = _CACHE.stats


def planned(pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled, emit_fields=False, rows=None):
    """``encoder.plan_group`` of the batch ``pcm`` (nsub, n) int32 (or
    int16) with its candidates ``lpc_coeffs`` (5, nsub, 13) int16 and
    ``lpc_valid`` (5, nsub) bool, planned as a batch of ``rows`` lanes
    (the caller's padded shape; default nsub). Returns ``plan_group``'s
    result for the nsub rows: ``meta``, or ``(meta, ship)`` with
    ``emit_fields``.

    CPU tensors run ``plan_group`` on the nsub rows. CUDA tensors replay
    the graph of ``(card, rows, n, zero_run, partitioning, emit_fields)``,
    captured on first use (a warm-up call and the capture, the only eager
    ``plan_group`` calls on the card); a failure raises."""
    if pcm.device.type == "cpu":
        from .encoder import plan_group

        return plan_group(pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled,
                          emit_fields=emit_fields)
    dev = pcm.device
    if torch.cuda.current_stream(dev) != torch.cuda.default_stream(dev):
        raise RuntimeError("planned: plans on a card run on its default stream (its graphs share one memory "
                           "pool, which is safe only while their replays are serialised on one stream)")
    with torch.cuda.device(dev):
        return _CACHE.plan(pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled, emit_fields,
                           rows)


def release():
    """Drop every captured graph: its static buffers are freed and its
    share of its card's pool goes back; the next plan of each shape
    captures anew."""
    with _CACHE.lock:
        _CACHE.entries.clear()


def captured_keys():
    """The keys of the graphs held now, least recently replayed first."""
    with _CACHE.lock:
        return list(_CACHE.entries)
