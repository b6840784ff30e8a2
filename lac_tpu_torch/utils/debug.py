"""Debug output, phase timing and device traces
(lac_tpu/utils/debug.py; reference utils/logger.hpp:5-53).

The CLI's ``--debug-*`` flags route per-stage summaries through
:func:`debug_log`.

``LAC_TPU_TIMING=1`` adds up the wall time of each encode phase and
prints one ``[lac-timing]`` line per frame encode. A phase given the
device it queues work on synchronizes that device when it ends, so its
time is the device's as well as the host's. ``LAC_TPU_PROFILE=<dir>``
wraps each frame encode in ``torch.profiler`` and writes a Chrome trace
into ``<dir>``, with the planner's sections (:func:`section`) marked.

Both variables are read once, at import: with them unset a phase is a bare
``yield`` and never synchronizes a device, and a section is a bare
``yield`` unless a profiling tool turns them on (:func:`sections_on`).
"""

import contextlib
import os
import sys
import threading
import time

_TIMING = os.environ.get("LAC_TPU_TIMING") not in (None, "", "0")
_PROFILE_DIR = os.environ.get("LAC_TPU_PROFILE") or ""


def debug_log(msg: str) -> None:
    sys.stderr.write(msg if msg.endswith("\n") else msg + "\n")


# --------------------------------------------------------------- phase timing
# Phases run on the calling thread and on the plane pipeline's dispatch
# threads, so the sums are kept under a lock.

_phase_acc = {}
_phase_lock = threading.Lock()


def timing_reset() -> None:
    with _phase_lock:
        _phase_acc.clear()


@contextlib.contextmanager
def phase(name: str, device=None):
    """Add the wall time of the enclosed block to phase ``name``. With a
    CUDA ``device`` the block's queued work on that card is waited for at
    the end, so the phase counts device time too (only when timing)."""
    if not _TIMING:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if device is not None and device.type == "cuda":
            from ..plan_graphs import synchronize

            synchronize(device)  # not while another thread captures a plan: it would break the capture
        dt = time.perf_counter() - t0
        with _phase_lock:
            _phase_acc[name] = _phase_acc.get(name, 0.0) + dt


def timing_report(label: str) -> None:
    if not _TIMING:
        return
    with _phase_lock:
        acc = dict(_phase_acc)
    if acc:
        parts = " ".join(f"{k}={v:.2f}s" for k, v in sorted(acc.items(), key=lambda kv: -kv[1]))
        debug_log(f"[lac-timing] {label}: {parts} (sum {sum(acc.values()):.2f}s)")


# ---------------------------------------------------------- torch profiler

_SECTIONS = [bool(_PROFILE_DIR)]


def sections_on(on=True) -> None:
    """Mark :func:`section` ranges from now on (``profile_encode`` turns
    them on; ``LAC_TPU_PROFILE`` sets them at import)."""
    _SECTIONS[0] = bool(on)


@contextlib.contextmanager
def section(name: str):
    """A ``torch.profiler`` range named ``name`` around the enclosed block
    while sections are on (:func:`sections_on`), so that a profile shows
    the device time, operators and launches of each section of the
    planner; a bare ``yield`` otherwise, and always while the current
    stream is being captured into a CUDA graph (a graph holds no range)."""
    if not _SECTIONS[0]:
        yield
        return
    import torch

    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        yield
        return
    with torch.profiler.record_function(name):
        yield



@contextlib.contextmanager
def device_trace():
    """Profile the enclosed block (CPU, and CUDA when a card is visible)
    into a Chrome trace under ``LAC_TPU_PROFILE``; nothing when unset."""
    if not _PROFILE_DIR:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(_PROFILE_DIR, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    path = os.path.join(_PROFILE_DIR, f"lac-{os.getpid()}-{time.time_ns()}.trace.json")
    prof.export_chrome_trace(path)
