"""The traced window: ``torch.profiler`` with CUDA activity over the
window, read once it has closed.

A traced run's window closes at the first batch boundary at or after
:data:`TRACE_SECONDS` (or ``--seconds``, where shorter), and every
per-layer metric is read over it.

The host's clock and the trace's are tied by two marker kernels
(``torch.cuda._sleep``), launched with the card idle at the window's
start and end: host spans map onto the device timeline by the offset of
the first. The window on the device is the stretch between the markers.
"""

import time

from . import yardstick

MARK_CYCLES = 200_000  # about 0.1 ms: a marker the trace cannot miss
MARK_NAME = "spin_kernel"  # the device function of torch.cuda._sleep
NAME_CHARS = 100  # longest device function name kept in the breakdown
# A traced window's length at most: the profiler keeps some 2.5 million device
# records (its 128 MB of activity buffers) and drops the rest, the end marker with
# them; a window records up to about 50 thousand a second. A larger buffer through
# the profiler's custom configuration crashed the process.
TRACE_SECONDS = 25


def _sync(devices):
    import torch

    for d in devices:
        torch.cuda.synchronize(d)


class DeviceTrace:
    """``start()`` before the window, ``stop()`` after it; then
    :meth:`summary` gives what the per-layer readers read."""

    def __init__(self, devices):
        self.devices = list(devices)

    def _mark(self):
        import torch

        _sync(self.devices)
        t = time.perf_counter()
        with torch.cuda.device(self.devices[0]):
            torch.cuda._sleep(MARK_CYCLES)
        _sync(self.devices)
        return t

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.host0 = self._mark()

    def stop(self):
        self._mark()
        self.prof.stop()
        self.events = self._events()

    def _events(self):
        """(name, device index, start s, end s) of every device operation."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        out = []
        # the raw events: prof.events() would build a tree of millions of Python objects first
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda and not e.is_user_annotation():
                s = e.start_ns()
                out.append((e.name(), e.device_index(), s * 1e-9, (s + e.duration_ns()) * 1e-9))
        return out

    def summary(self, host_spans=()):
        """What the trace says about the window. ``host_spans``: (label,
        intervals on the host's clock) in priority order, to label the
        device's idle gaps by what the host was doing ("generator": none of
        them, the harness between calls)."""
        marks = sorted((a, b) for name, _, a, b in self.events if MARK_NAME in name)
        if len(marks) < 2:
            raise RuntimeError(f"the trace holds {len(marks)} of the window's two marker kernels")
        lo, hi = marks[0][1], marks[-1][0]
        offset = marks[0][0] - self.host0  # device clock = host clock + offset
        window = hi - lo
        ops = [(name, dev, a, b) for name, dev, a, b in self.events if MARK_NAME not in name and b > lo and a < hi]
        busy, gaps = {}, []
        for d in sorted({dev for _, dev, _, _ in ops}):
            ivs = sorted(yardstick.clipped([(a, b) for _, dev, a, b in ops if dev == d], lo, hi))
            busy[d] = yardstick.union_s(ivs)
            end = lo
            for a, b in ivs + [(hi, hi)]:
                if a > end:
                    gaps.append((a - end, (a + end) / 2))
                end = max(end, b)
        by_name, kernel_s = {}, 0.0
        for name, _, a, b in ops:
            s = min(b, hi) - max(a, lo)
            kernel = yardstick.kernel_of(name)
            key = kernel or name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + s
            if kernel in yardstick.ENCODE_KERNELS:
                kernel_s += s

        def label(mid):
            t = mid - offset
            return next((name for name, ivs in host_spans if any(a <= t <= b for a, b in ivs)), "generator")

        gaps.sort(reverse=True)
        cards = max(len(self.devices), 1)
        return {
            "window_s": window,
            "busy_s": sum(busy.values()) / cards,  # averaged over the cards in use
            "busy_by_card": busy,
            "kernel_device_s": kernel_s,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": [(label(mid), g) for g, mid in gaps[:10]],
            "events": len(ops),
        }
