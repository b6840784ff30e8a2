"""device_pipeline.ld_pct (program span): the union of the plane pipeline's
``host_ld`` spans (the host's 80-bit Levinson-Durbin of a chunk's lanes and
probes, on the dispatch thread; those tagged with a chunk) over the window
(%)."""

from benchmark.program_spans import union_pct


def read(run):
    return union_pct(run, lambda s: s.name == "host_ld" and "chunk" in s.attrs)
