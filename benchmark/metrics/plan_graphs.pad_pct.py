"""plan_graphs.pad_pct (program counter): the padding of the window's plan
batches, full width and probe, from the port's ``replay`` spans of kind
plan: sum of (rows - real) * n over sum of rows * n (%), where ``rows`` is
the graph's row count, ``real`` the rows the batch filled and ``n`` the
samples a row."""

from benchmark.program_spans import window_spans


def read(run):
    spans = [s for s in window_spans(run) or () if s.name == "replay" and s.attrs.get("kind") == "plan"]
    total = sum(s.attrs["rows"] * s.attrs["n"] for s in spans)
    pad = sum((s.attrs["rows"] - s.attrs["real"]) * s.attrs["n"] for s in spans)
    return 100.0 * pad / total if total else None
