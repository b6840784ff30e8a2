"""What one run leaves for the metric readers (``metrics/<name>.py``)."""

from dataclasses import dataclass, field


@dataclass
class Record:
    t_start: float  # the host clock when the run's process started work
    window: tuple  # (start, end) of the measured window, host clock (s)
    pcm_bytes: int = 0  # PCM bytes of every input whose encode completed in the window
    stream_bytes: int = 0  # bytes of those inputs' streams
    spans: dict = field(default_factory=dict)  # label -> [(start, end)] on the host clock
    counters: dict = field(default_factory=dict)  # name -> value over the window
    least_s: float = 0.0  # summed least time of the port's kernel launches in the window
    trace: dict = None  # devtrace.DeviceTrace.summary() of a traced run

    @property
    def window_s(self):
        return self.window[1] - self.window[0]


def share_pct(intervals, window):
    """The union of ``intervals`` inside ``window`` as a share of it (%)."""
    from .yardstick import clipped, union_s

    lo, hi = window
    return 100.0 * union_s(clipped(intervals, lo, hi)) / (hi - lo)
