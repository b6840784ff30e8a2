"""device_pipeline.emit_pct (program span): the union of the plane
pipeline's ``emit_prep`` and ``native_emit`` spans (a chunk's plan rows
expanded, then its payloads written natively, on the emitting thread;
those tagged with a chunk, not the host route's) over the window (%)."""

from benchmark.program_spans import union_pct


def read(run):
    return union_pct(run, lambda s: s.name in ("emit_prep", "native_emit") and "chunk" in s.attrs)
