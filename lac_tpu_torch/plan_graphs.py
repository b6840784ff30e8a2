"""Captured executables: ``lac_tpu``'s compiled programs as CUDA graphs,
one per padded shape, replayed.

In ``lac_tpu`` the device work is fixed-shape compiled programs, each
family in a bounded ``functools.lru_cache``, and every caller pads its
inputs so that few shapes exist. The port captures three of them:

* the plan (lac_tpu/encoder.py:529-540 ``_jitted_plan``, at most 64):
  ``encoder.plan_group`` per ``(card, rows, n, zero_run, partitioning,
  emit_fields)``, its batch padded as ``lac_tpu`` pads it (the plane
  pipeline to ``bp``, its probes to ``12 * K``, the group route to
  ``Bp``) -- :func:`planned`, one graph launch in place of the ~2,000
  operators the interpreter would issue one by one for a full-width plan;
* the per-chunk analyze (lac_tpu/device_pipeline.py:120-199
  ``_jitted_analyze``, at most 16): ``device_pipeline.analyze`` per
  ``(card, K, kind, plane dtype)``, a ragged last chunk padded to K rows
  of zeros (``_jitted_padrows``) -- :func:`analyzed`;
* the group route's lags (lac_tpu/encoder.py:543-553 ``_jitted_autocorr``,
  at most 16): ``ops.lpc.autocorrelation`` per ``(card, Bp, n, pcm
  dtype)`` -- :func:`lags_of`. The port's int64 lags are exact in every
  domain, so the reference's limb count has no counterpart in the key.

Each bound counts one card's graphs, so that a mesh's warm grid does not
evict itself. The captured functions are unchanged: they are what a
graph captures, what CPU tensors run (at the padded shape), and the
reference a graph is held against. CUDA tensors replay the graph of
their key, captured on first use; a capture or a replay that fails
raises, and nothing runs the function eagerly on the card in its place.

A replay, in order, on the caller's stream (the card's default stream):

1. the inputs are copied into the graph's static buffers; rows past them
   are zero, as ``lac_tpu`` pads (pcm 0, coefficients 0, valid False,
   plane rows 0), and rows that an earlier, fuller input left there are
   zeroed;
2. the graph is replayed; a plan graph's tally (kernel 10's parts summed
   the 64-bit way and in all, zeroed inside the graph) is added to the
   caller's where the caller passes one;
3. the outputs are copied out (``clone``) at once, the input's rows of a
   plan or lag batch, the whole K rows of an analyze.

Why copy out rather than hand the caller the graph's own outputs: the
graphs of one card, of every kind, share one memory pool, so the next
replay of *any* graph of the card may write where this graph's outputs
lie, and a caller (a mesh's futures, a group job's ``ship``, a chunk
waiting for its plans) may hold its result for longer than until its
next call. A copy of a plan batch's ``meta`` is 132 KB at (256, 16384),
of its ``ship`` 25 MB, of an auto analyze's planes at K = 256 64 MiB: a
few to some tens of microseconds of the card's time.

All of it, captures included, runs under one process-wide lock, shared
by every kind: the steps above must not interleave between threads, CUDA
allows only one capture at a time in a process, and a capture that
another thread's replay interleaved would read half-filled buffers.

Launches: a capture enqueues nothing, so the kernel wrappers it runs
record their launches (``cuda_kernels.recording``) instead of counting
them; each replay adds those launches to ``cuda_kernels.launches`` and
to its card's ``card_launches`` (an analyze or lag graph launches none
of the port's kernels). Each kind's cache counts its captures, replays
and capture seconds apart (:data:`stats` for plans, ``CACHES[kind].stats``).
"""

import collections
import threading
import time

import torch

from .format import constants as C
from .format.partitions import max_partition_order_for_block
from .ops import cuda_kernels
from .utils import debug as _dbg

MAX_GRAPHS = 64  # plans per card: lac_tpu bounds its plan executables alike (lru_cache(maxsize=64))
MAX_ANALYZE_GRAPHS = 16  # lac_tpu/device_pipeline.py:120 (lru_cache(maxsize=16))
MAX_LAG_GRAPHS = 16  # lac_tpu/encoder.py:543 (lru_cache(maxsize=16))
LAG_ORDER = 12
# what an analyze graph writes: the planes and the packed host buffer, then
# for kind "auto" the probe slices and their lags (device_pipeline.analyze)
ANALYZE_OUT = ("planes", "hostbuf", "probes", "plags")


class Buffers:
    """A graph's static input buffers on one device, zero at first: one
    attribute per ``(name, shape, dtype, row axis)`` of ``specs``, filled
    in that order. ``filled`` counts the leading rows that hold an
    earlier input's data."""

    def __init__(self, specs, device):
        self._axes = []
        for name, shape, dtype, axis in specs:
            setattr(self, name, torch.zeros(shape, dtype=dtype, device=device))
            self._axes.append((name, axis))
        self.filled = 0

    def fill(self, *inputs):
        """Copy ``inputs`` in on the current stream (their rows along each
        buffer's row axis; a narrower integer type is widened) and zero the
        rows past them that an earlier, fuller input filled."""
        nsub = inputs[0].shape[self._axes[0][1]]
        for (name, axis), x in zip(self._axes, inputs):
            buf = getattr(self, name)
            buf.narrow(axis, 0, nsub).copy_(x)
            if self.filled > nsub:
                buf.narrow(axis, nsub, self.filled - nsub).zero_()
        self.filled = nsub


class Static(Buffers):
    """A plan graph's input buffers: pcm (rows, n) int32, coefficients
    (5, rows, 13) int16 and valid (5, rows) bool."""

    def __init__(self, rows, n, device):
        ncl = len(C.LPC_ORDER_CANDIDATES)
        super().__init__((("pcm", (rows, n), torch.int32, 0), ("coeffs", (ncl, rows, 13), torch.int16, 1),
                          ("valid", (ncl, rows), torch.bool, 1)), device)


def analyze_buffers(K, kind, dtype, device):
    """An analyze graph's input buffers: the chunk's L plane ``lmat`` and,
    unless ``kind`` is mono, its R plane ``rmat``, (K, N) of the planes'
    dtype."""
    specs = [("lmat", (K, C.MAX_BLOCK_SIZE), dtype, 0)]
    if kind != "mono":
        specs.append(("rmat", (K, C.MAX_BLOCK_SIZE), dtype, 0))
    return Buffers(specs, device)


def lag_buffers(rows, n, dtype, device):
    """A lag graph's input buffer: ``pcm`` (rows, n) of the batch's dtype."""
    return Buffers([("pcm", (rows, n), dtype, 0)], device)


class Captured:
    """What a capture gives: ``replay()`` reruns the captured work on the
    static buffers (a graph's bound ``replay`` keeps the graph alive),
    ``out`` holds the tensors it writes (a plan's ``meta``, then ``ship``
    with ``emit_fields``; an analyze's :data:`ANALYZE_OUT`; the lags),
    ``launches`` the kernel launches of one replay by kernel name,
    ``tally`` a plan graph's (2,) int64 count of kernel 10's parts summed
    the 64-bit way and in all, which each replay writes anew
    (:func:`capture_plan` sets it; None for the other kinds)."""

    def __init__(self, replay, out, launches):
        self.replay = replay
        self.out = tuple(out)
        self.launches = dict(launches)
        self.tally = None


class GraphCache:
    """The captured graphs of one kind by key, the card's index first; at
    most ``maxsize`` graphs of a card: the one of that card replayed
    longest ago goes first.

    ``capture(static, *key[2:])`` makes a :class:`Captured` from a key's
    filled buffers (the key past the card and the row count, which the
    buffers hold) (on the card :func:`capture_plan`, :func:`capture_analyze`
    or :func:`capture_lags`; in the CPU tests a stand-in). The entry point
    of the cache's kind (:meth:`plan`, :meth:`analyze` or :meth:`lags`)
    builds the key and the buffers; :meth:`run` does the rest. The caches
    of every kind share ``lock``: a card's graphs of every kind share one
    memory pool."""

    def __init__(self, capture, maxsize=MAX_GRAPHS, lock=None):
        self.capture = capture
        self.maxsize = maxsize
        self.entries = collections.OrderedDict()  # key -> (Buffers, Captured)
        self.stats = {"captures": 0, "replays": 0, "capture_s": 0.0}
        self.lock = lock if lock is not None else threading.RLock()

    def run(self, key, buffers, inputs, rows_out, device, kind, tally=None):
        """Fill the graph of ``key`` with ``inputs`` (first made by
        ``buffers()`` and captured), replay it, and return copies of its
        outputs: their first ``rows_out`` rows, or all of them for None.
        ``kind`` names the replay's span (:func:`replay_span`); ``tally``,
        where given, gets the graph's tally added, read before the lock is
        let go and another replay can write it."""
        with self.lock:
            entry = self.entries.get(key)
            if entry is None:
                static = buffers()
                static.fill(*inputs)
                t0 = time.perf_counter()
                captured = self.capture(static, *key[2:])
                self.stats["capture_s"] += time.perf_counter() - t0
                self.stats["captures"] += 1
                self.entries[key] = (static, captured)
                mine = [k for k in self.entries if k[0] == key[0]]
                for old in mine[: max(len(mine) - self.maxsize, 0)]:
                    del self.entries[old]
            else:
                self.entries.move_to_end(key)
                static, captured = entry
                static.fill(*inputs)
            with replay_span(kind, key[1], inputs[0]) as span:
                if span is not None and device.type == "cuda":
                    span.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    span.events[0].record()
                    captured.replay()
                    span.events[1].record()
                else:
                    captured.replay()
            if tally is not None:
                tally += captured.tally
            cuda_kernels.count_replay(captured.launches, device)
            self.stats["replays"] += 1
            return tuple((t if rows_out is None else t[:rows_out]).clone() for t in captured.out)

    def plan(self, pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled, emit_fields=False,
             rows=None, tally=None):
        """``plan_group``'s result for the batch ``pcm`` (nsub, n), planned
        as a batch of ``rows`` lanes (default nsub): ``meta`` (nsub, M),
        with ``emit_fields`` ``(meta, ship)``; ``tally`` as :func:`planned`."""
        nsub = pcm.shape[0]
        rows = nsub if rows is None else int(rows)
        if not 0 < nsub <= rows or pcm.shape[1] != n:
            raise ValueError(f"planned: a batch of {tuple(pcm.shape)} does not fit a plan of ({rows}, {n})")
        dev = pcm.device
        key = (dev.index, rows, n, bool(zero_run_enabled), bool(partitioning_enabled), bool(emit_fields))
        out = self.run(key, lambda: Static(rows, n, dev), (pcm, lpc_coeffs, lpc_valid), nsub, dev, "plan", tally)
        return out if emit_fields else out[0]

    def analyze(self, lmat, rmat, K, kind):
        """``device_pipeline.analyze`` of the chunk ``lmat``/``rmat`` (kc,
        N), analyzed as a chunk of ``K`` blocks: its outputs at K rows."""
        kc, dev = lmat.shape[0], lmat.device
        if not 0 < kc <= K or lmat.shape[1] != C.MAX_BLOCK_SIZE or (kind != "mono" and rmat.shape != lmat.shape):
            raise ValueError(f"analyzed: a chunk of {tuple(lmat.shape)} does not fit an analyze of ({K}, "
                             f"{C.MAX_BLOCK_SIZE})")
        key = (dev.index, int(K), kind, lmat.dtype)
        inputs = (lmat,) if kind == "mono" else (lmat, rmat)
        out = self.run(key, lambda: analyze_buffers(K, kind, lmat.dtype, dev), inputs, None, dev, "analyze")
        return dict(zip(ANALYZE_OUT, out))

    def lags(self, pcm, rows):
        """Exact int64 lags 0..12 of the batch ``pcm`` (B, n), computed as
        a batch of ``rows`` lanes: (B, 13)."""
        B, n = pcm.shape
        if not 0 < B <= rows:
            raise ValueError(f"lags_of: a batch of {tuple(pcm.shape)} does not fit ({rows}, {n})")
        dev = pcm.device
        key = (dev.index, int(rows), n, pcm.dtype)
        return self.run(key, lambda: lag_buffers(rows, n, pcm.dtype, dev), (pcm,), B, dev, "lags")[0]


def replay_span(kind, rows, x):
    """The ``replay`` span of a batch ``x`` (its rows, n) run as a graph of
    ``rows`` rows of ``kind`` (an empty context unless spans are recorded)."""
    return _dbg.phase("replay", kind=kind, rows=int(rows), real=int(x.shape[0]), n=int(x.shape[1]))


# ------------------------------------------------------------------ the card

# card index -> the memory pool that card's graphs share, and the side
# stream they are captured on. Sharing one pool is safe only because the
# replays on one card are serialised on one stream (the card's default
# stream, checked at every replay) under the caches' one lock, and each
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
# the card). Captures hold this lock, and :func:`synchronize`, the
# device-wide synchronize for tools and tests, takes it.
capture_lock = threading.RLock()


def synchronize(device=None):
    """``torch.cuda.synchronize(device)``, never while a graph is captured."""
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


def _capture(dev, run, prefill=None):
    """Capture ``run()`` (a tuple of output tensors) on the card ``dev``
    as a CUDA graph.

    Preconditions, met here in order: the kernels are built (a build
    inside a capture would break it); what ``run`` caches per card is
    filled (``prefill``); one eager warm-up call runs on the side stream,
    as PyTorch's graph documentation asks. The capture runs in
    ``thread_local`` error mode under :data:`capture_lock`: what the
    pipeline's other threads do meanwhile (emits and their host copies, a
    service's job and finish threads, other cards' dispatch waiting on the
    dispatch lock) cannot break it, and ``run`` makes no unsafe call."""
    from .ops import _cuda_lib

    _cuda_lib.load()
    with torch.cuda.device(dev):
        if prefill is not None:
            prefill()
        if dev.index not in _pools:
            _pools[dev.index] = torch.cuda.graph_pool_handle()
            _capture_streams[dev.index] = torch.cuda.Stream(dev)
        side, current = _capture_streams[dev.index], torch.cuda.current_stream(dev)
        side.wait_stream(current)  # the static buffers were filled on the current stream
        with torch.cuda.stream(side):
            run()  # the warm-up: eager, its launches count
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with capture_lock, cuda_kernels.recording() as launches:
            with torch.cuda.graph(graph, pool=_pools[dev.index], stream=side, capture_error_mode="thread_local"):
                out = run()
    return Captured(graph.replay, out, launches)


def capture_plan(static, n, zero_run_enabled, partitioning_enabled, emit_fields):
    """Capture ``encoder.plan_group`` on ``static``'s card, its per-card
    tables filled first (:func:`_prefill_tables`), with its tally: zeroed
    and counted inside the graph."""
    from . import encoder

    dev = static.pcm.device

    def run():
        tally = torch.zeros(2, dtype=torch.int64, device=dev)
        out = encoder.plan_group(static.pcm, static.coeffs, static.valid, n, zero_run_enabled,
                                 partitioning_enabled, emit_fields=emit_fields, tally=tally)
        return (*(out if emit_fields else (out,)), tally)

    captured = _capture(dev, run, lambda: _prefill_tables(n, partitioning_enabled, dev))
    captured.out, captured.tally = captured.out[:-1], captured.out[-1]
    return captured


def _analyze_static(static, kind):
    """``device_pipeline.analyze`` on an analyze graph's buffers, its
    outputs in :data:`ANALYZE_OUT` order."""
    from . import device_pipeline

    out = device_pipeline.analyze(static.lmat, static.lmat if kind == "mono" else static.rmat, kind)
    return tuple(out[k] for k in ANALYZE_OUT if k in out)


def capture_analyze(static, kind, dtype):
    """Capture ``device_pipeline.analyze`` of a (K, N) chunk on
    ``static``'s card (it caches nothing per card)."""
    return _capture(static.lmat.device, lambda: _analyze_static(static, kind))


def capture_lags(static, n, dtype):
    """Capture the exact lags of a (rows, n) batch on ``static``'s card."""
    from .ops import lpc

    return _capture(static.pcm.device, lambda: (lpc.autocorrelation(static.pcm, LAG_ORDER),))


_lock = threading.RLock()
CACHES = {
    "plan": GraphCache(capture_plan, MAX_GRAPHS, _lock),
    "analyze": GraphCache(capture_analyze, MAX_ANALYZE_GRAPHS, _lock),
    "lags": GraphCache(capture_lags, MAX_LAG_GRAPHS, _lock),
}
_CACHE = CACHES["plan"]
stats = _CACHE.stats


def _on_default_stream(dev, name):
    if torch.cuda.current_stream(dev) != torch.cuda.default_stream(dev):
        raise RuntimeError(f"{name}: graphs on a card run on its default stream (they share one memory pool, "
                           f"which is safe only while their replays are serialised on one stream)")


def planned(pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled, emit_fields=False, rows=None,
            tally=None):
    """``encoder.plan_group`` of the batch ``pcm`` (nsub, n) int32 (or
    int16) with its candidates ``lpc_coeffs`` (5, nsub, 13) int16 and
    ``lpc_valid`` (5, nsub) bool, planned as a batch of ``rows`` lanes
    (the caller's padded shape; default nsub). Returns ``plan_group``'s
    result for the nsub rows: ``meta``, or ``(meta, ship)`` with
    ``emit_fields``. ``tally``, where given, a (2,) int64 tensor on the
    batch's device, gets the plan's count of kernel 10's parts summed the
    64-bit way and of parts summed, the padded rows' included on a card
    (``cuda_kernels.partition_cost_sums``), added on the device.

    CPU tensors run ``plan_group`` on the nsub rows. CUDA tensors replay
    the graph of ``(card, rows, n, zero_run, partitioning, emit_fields)``,
    captured on first use (a warm-up call and the capture, the only eager
    ``plan_group`` calls on the card); a failure raises."""
    if pcm.device.type == "cpu":
        from .encoder import plan_group

        with replay_span("plan", pcm.shape[0] if rows is None else rows, pcm):
            return plan_group(pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled,
                              emit_fields=emit_fields, tally=tally)
    dev = pcm.device
    _on_default_stream(dev, "planned")
    with torch.cuda.device(dev):
        return _CACHE.plan(pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled, emit_fields,
                           rows, tally)


def analyzed(lmat, rmat, K, kind):
    """``device_pipeline.analyze`` of one chunk: ``lmat``/``rmat`` (kc, N)
    planes (int16 or int32; ``rmat`` unused for mono) on one device, kc <=
    K, analyzed as a chunk of K blocks whose rows past kc are zero (the
    reference's shape, lac_tpu/device_pipeline.py:610-687). Returns the
    dict of ``analyze`` at K rows: ``planes``, ``hostbuf`` and, for
    ``kind == "auto"``, ``probes`` and ``plags``.

    CPU tensors run ``analyze`` on the padded chunk. CUDA tensors replay
    the graph of ``(card, K, kind, plane dtype)``, captured on first use;
    a failure raises."""
    dev = lmat.device
    if dev.type == "cpu":
        with replay_span("analyze", K, lmat):
            static = analyze_buffers(K, kind, lmat.dtype, dev)
            static.fill(*((lmat,) if kind == "mono" else (lmat, rmat)))
            return dict(zip(ANALYZE_OUT, _analyze_static(static, kind)))
    _on_default_stream(dev, "analyzed")
    with torch.cuda.device(dev):
        return CACHES["analyze"].analyze(lmat, rmat, K, kind)


def lags_of(pcm, rows):
    """Exact int64 lags 0..12 of the batch ``pcm`` (B, n), B <= ``rows``,
    computed as a batch of ``rows`` lanes whose rows past B are zero (the
    group route's padded batch, lac_tpu/encoder.py:659-692): (B, 13).

    CPU tensors run ``autocorrelation`` on the padded batch. CUDA tensors
    replay the graph of ``(card, rows, n, pcm dtype)``, captured on first
    use; a failure raises."""
    dev = pcm.device
    if dev.type == "cpu":
        from .ops import lpc

        with replay_span("lags", rows, pcm):
            static = lag_buffers(rows, pcm.shape[1], pcm.dtype, dev)
            static.fill(pcm)
            return lpc.autocorrelation(static.pcm, LAG_ORDER)[: pcm.shape[0]]
    _on_default_stream(dev, "lags_of")
    with torch.cuda.device(dev):
        return CACHES["lags"].lags(pcm, rows)


def release():
    """Drop every captured graph of every kind: its static buffers are
    freed and its share of its card's pool goes back; the next call of
    each shape captures anew."""
    with _lock:
        for cache in CACHES.values():
            cache.entries.clear()


def captured_keys(kind="plan"):
    """The keys of the graphs of ``kind`` held now, least recently
    replayed first."""
    with _lock:
        return list(CACHES[kind].entries)
