"""Debug output, spans and device traces
(lac_tpu/utils/debug.py; reference utils/logger.hpp:5-53).

The CLI's ``--debug-*`` flags route per-stage summaries through
:func:`debug_log`.

Spans. :func:`phase` records a span of the enclosed block while recording
is on (:func:`recording_on`): while ``LAC_TPU_TIMING`` is set (read once,
at import), while a ``torch.profiler`` profile runs in the process, or
after :func:`recording` ``(True)``. A :class:`Span` holds its name, its id
and its parent's (the innermost open span on its thread, or a span of
another thread handed over with :func:`adopt`), the id of the request it
serves (the ``encode_pooled`` or ``FrameEncoder.encode`` call,
:func:`request`), its thread, its start and end on
``time.perf_counter()``, its attributes and, for a phase opened with
``cpu=True``, the thread's CPU time over it. Closed spans go into a
bounded ring (:data:`RING_SPANS`, the oldest dropped first; an append
takes no lock); :func:`spans` returns those that overlap a host-clock
interval. A span may hold a pair of CUDA timing events (a graph replay's,
:mod:`..plan_graphs`): their elapsed time is read when :func:`spans`
returns the span, never waited for; an event still pending reads as
missing. With recording off a phase is an empty context after one flag
check: no span, no event, no clock read.

``LAC_TPU_TIMING=1`` prints one ``[lac-timing]`` line per frame encode:
each phase's host seconds since :func:`timing_reset`, and
``plan_device`` / ``analyze_device``, the stream seconds of the plan and
analyze replays: from each one's start event to its end event, the card's
time in the graph and, where the card had caught up with the host, its
wait for the graph's launch. Replays whose events are still pending are
counted at the end of the line. Phases synchronize nothing.
``LAC_TPU_PROFILE=<dir>`` wraps each frame encode and each pooled encode
in ``torch.profiler`` and writes a Chrome trace into ``<dir>``; while
sections are on (that variable, or :func:`sections_on`) each span and
each of the planner's sections (:func:`section`) is a ``record_function``
range in the trace, except inside a capture.
"""

import collections
import contextlib
import itertools
import os
import sys
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_TIMING = os.environ.get("LAC_TPU_TIMING") not in (None, "", "0")
_PROFILE_DIR = os.environ.get("LAC_TPU_PROFILE") or ""


def debug_log(msg: str) -> None:
    sys.stderr.write(msg if msg.endswith("\n") else msg + "\n")


# ----------------------------------------------------------------- spans

RING_SPANS = 1 << 16  # about 130 pooled batches of 500 spans each
_RECORDING = [False]
_ring = collections.deque(maxlen=RING_SPANS)
_ids = itertools.count(1)
_tls = threading.local()
_NULL = contextlib.nullcontext()


def recording(on=True) -> None:
    """Record spans from now on whatever else holds (a tool's switch)."""
    _RECORDING[0] = bool(on)


def _profiling():
    """True while a ``torch.profiler`` profile runs in the process, on
    every thread (the C flag ``torch._C._autograd._profiler_enabled()`` is
    the calling thread's alone: a thread started outside the profile reads
    it False)."""
    return _autograd_profiler._is_profiler_enabled


def recording_on() -> bool:
    return _TIMING or _RECORDING[0] or _profiling()


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current():
    """The innermost open span on this thread (None when there is none or
    recording is off): what work handed to another thread names as its
    parent."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def _capturing():
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


class Span:
    """One recorded interval (see the module's docstring). ``cpu_s``: the
    thread's CPU seconds over it, or None where not asked for;
    ``device_ms``: the milliseconds between the span's two ``events`` on
    the card's stream, once read."""

    __slots__ = ("name", "id", "parent", "request", "thread", "t0", "t1", "cpu_s", "attrs", "events",
                 "device_ms", "_cpu0", "_range")

    def __init__(self, name, up, attrs, root=False, cpu=False):
        self.name, self.attrs = name, attrs
        self.cpu_s, self._cpu0 = None, 0 if cpu else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.request = up.request if up is not None else None
        if root and self.request is None:
            self.request = self.id
        self.events = self.device_ms = self._range = None
        self.t0 = self.t1 = None

    def __enter__(self):
        _stack().append(self)
        if _SECTIONS[0] and not _capturing():  # a graph holds no range
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.thread = threading.current_thread().name
        if self._cpu0 is not None:
            self._cpu0 = time.thread_time_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter()
        if self._cpu0 is not None:
            self.cpu_s = (time.thread_time_ns() - self._cpu0) * 1e-9
        if self._range is not None:
            self._range.__exit__(*exc)
        _stack().pop()
        _ring.append(self)
        return False


def phase(name: str, cpu=False, **attrs):
    """A span named ``name`` around the enclosed block while recording is
    on, a child of this thread's innermost open span; an empty context
    otherwise. ``with phase(...) as span``: the :class:`Span`, or None.
    ``cpu``: also read the thread's CPU time over the span (two more clock
    reads; for the spans a metric reads it of)."""
    if not recording_on():
        return _NULL
    return Span(name, current(), attrs, cpu=cpu)


def request(name: str, **attrs):
    """A span whose id becomes the request id of every span under it: an
    entry point's call. Inside another request it is a span of that one."""
    if not recording_on():
        return _NULL
    return Span(name, current(), attrs, root=True)


@contextlib.contextmanager
def adopt(parent):
    """Make ``parent`` (a span open on another thread, or None) this
    thread's innermost span for the enclosed block, so that the spans
    opened here are its children."""
    if parent is None:
        yield
        return
    stack = _stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.pop()


def spans(lo=float("-inf"), hi=float("inf")):
    """The recorded spans that overlap the host-clock interval (lo, hi),
    oldest first, their events' time read where the card has reached
    them (a span whose events are pending keeps them, and no
    ``device_ms``)."""
    out = [s for s in list(_ring) if s.t0 < hi and s.t1 > lo]
    for s in out:
        if s.events is not None and s.events[1].query():
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    return out


# --------------------------------------------------------------- timing line

_reset = [0]
_DEVICE_KINDS = ("plan", "analyze")  # replay kinds the line gives stream time for


def timing_reset() -> None:
    """Start the next ``[lac-timing]`` line's sums: spans opened from now on."""
    _reset[0] = next(_ids)


def _phase_sums():
    """Phase name -> host seconds of the spans opened since the reset (a
    request's own span is the call, not one of its phases), and
    ``<kind>_device`` -> the stream seconds of the plan and analyze
    replays whose events the card has reached."""
    acc = {}
    for s in _since_reset():
        if s.name == "replay":
            if s.device_ms is not None and s.attrs.get("kind") in _DEVICE_KINDS:
                key = f"{s.attrs['kind']}_device"
                acc[key] = acc.get(key, 0.0) + s.device_ms * 1e-3
        elif s.request != s.id:
            acc[s.name] = acc.get(s.name, 0.0) + (s.t1 - s.t0)
    return acc


def _since_reset():
    return [s for s in spans() if s.id > _reset[0]]


def timing_report(label: str) -> None:
    if not _TIMING:
        return
    acc = _phase_sums()
    if acc:
        parts = " ".join(f"{k}={v:.2f}s" for k, v in sorted(acc.items(), key=lambda kv: -kv[1]))
        # replays whose events were pending when read: left out of <kind>_device, and counted here
        pending = sum(s.events is not None and s.attrs.get("kind") in _DEVICE_KINDS for s in _since_reset())
        tail = f"; {pending} replays still on the card" if pending else ""
        debug_log(f"[lac-timing] {label}: {parts} (sum {sum(acc.values()):.2f}s{tail})")


# ---------------------------------------------------------- torch profiler

_SECTIONS = [bool(_PROFILE_DIR)]


def sections_on(on=True) -> None:
    """Mark :func:`section` ranges, and a range for each span, from now on
    (``profile_encode`` turns them on; ``LAC_TPU_PROFILE`` sets them at
    import)."""
    _SECTIONS[0] = bool(on)


@contextlib.contextmanager
def section(name: str):
    """A ``torch.profiler`` range named ``name`` around the enclosed block
    while sections are on (:func:`sections_on`), so that a profile shows
    the device time, operators and launches of each section of the
    planner; a bare ``yield`` otherwise, and always while the current
    stream is being captured into a CUDA graph (a graph holds no range)."""
    if not _SECTIONS[0] or _capturing():
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def device_trace():
    """Profile the enclosed block (CPU, and CUDA when a card is visible)
    into a Chrome trace under ``LAC_TPU_PROFILE``; nothing when unset, and
    nothing inside a profile already running (an encode inside a pooled
    encode's trace)."""
    if not _PROFILE_DIR or _profiling():
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(_PROFILE_DIR, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(_PROFILE_DIR, f"lac-{os.getpid()}-{time.time_ns()}.trace.json")
    prof.export_chrome_trace(path)
