"""device_pipeline.upload_staged_pct (program counter): the bytes the port
copied on the host to stage its uploads to the card, over the bytes it sent,
from the window's ``upload`` spans: sum of ``staged`` over sum of ``bytes``
(%). Near 0 where the uploads read pinned memory that is already filled (a
wave's planes); 100 where every upload is first copied. None where the port
records no such spans, or spans without those attributes."""

from benchmark.program_spans import window_spans


def read(run):
    spans = [s for s in window_spans(run) or () if s.name == "upload" and "staged" in s.attrs]
    sent = sum(s.attrs["bytes"] for s in spans)
    return 100.0 * sum(s.attrs["staged"] for s in spans) / sent if sent else None
