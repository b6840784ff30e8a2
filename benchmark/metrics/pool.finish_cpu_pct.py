"""pool.finish_cpu_pct (program span): the thread CPU time of the port's
``pool_finish`` spans (each file's host finish on its worker thread) over
their summed wall time (%): near 100 where the finishes compute, low where
they wait (for the interpreter lock, for each other). Where the host
charges CPU time by whole scheduler ticks (10 ms on the H100's machine),
each span reads off by up to a tick and the sum over the window's spans
stays unbiased."""

from benchmark.program_spans import window_spans


def read(run):
    spans = [s for s in window_spans(run) or () if s.name == "pool_finish"]
    wall = sum(s.t1 - s.t0 for s in spans)
    return 100.0 * sum(s.cpu_s for s in spans) / wall if wall > 0 else None
