"""pool.finish_pct (program span): the union of the benchmark's spans
around the ``FrameEncoder.encode_frame`` calls (each file's host finish:
its tail block, frame assembly) over the window (%)."""

from benchmark.record import share_pct


def read(run):
    spans = run.spans.get("finish")
    return share_pct(spans, run.window) if spans else None
