"""pool.wave_pct (program span): the union of the benchmark's spans around
each ``pool.run_group_wave`` over the window (%)."""

from benchmark.record import share_pct


def read(run):
    spans = run.spans.get("wave")
    return share_pct(spans, run.window) if spans else None
