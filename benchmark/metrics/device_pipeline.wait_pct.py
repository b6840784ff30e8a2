"""device_pipeline.wait_pct (program span): the union of the emitting
thread's waits in the plane pipeline, ``plan_wait`` (for a chunk's plan
stage on the dispatch thread) and ``meta_fetch`` (for its plans' rows from
the card), over the window (%)."""

from benchmark.program_spans import union_pct


def read(run):
    return union_pct(run, lambda s: s.name in ("plan_wait", "meta_fetch") and "chunk" in s.attrs)
