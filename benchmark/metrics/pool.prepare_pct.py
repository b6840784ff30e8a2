"""pool.prepare_pct (program span): the union of the port's ``pool_prepare``
spans (``encode_pooled`` from its entry to the first wave: the item copies,
the encoders, the range checks, the grouping) and ``wave_views`` spans
(each wave's copy of its files' blocks into plane matrices) over the
window (%)."""

from benchmark.program_spans import union_pct


def read(run):
    return union_pct(run, lambda s: s.name in ("pool_prepare", "wave_views"))
