"""The reader of ``device_pipeline.upload_staged_pct`` on made-up spans: the
byte-weighted share of staged bytes, and None where the port records no
``upload`` span or records one without the attributes."""

import types

import pytest

from benchmark import spec
from benchmark.record import Record

NAME = "device_pipeline.upload_staged_pct"


def _span(name, t0, t1, **attrs):
    return types.SimpleNamespace(name=name, t0=t0, t1=t1, attrs=attrs)


@pytest.fixture
def port_spans(monkeypatch):
    """Hand the reader these spans as the port's (``debug.spans(lo, hi)``)."""
    from lac_tpu_torch.utils import debug

    held = []
    monkeypatch.setattr(debug, "spans", lambda lo, hi: [s for s in held if s.t0 < hi and s.t1 > lo])
    return held


def read(run):
    return spec.reader(NAME).read(run)


RUN = Record(t_start=0.0, window=(10.0, 20.0))


def test_no_upload_span_reads_none(port_spans):
    assert read(RUN) is None
    port_spans += [_span("plane_upload", 11, 12, chunk=0), _span("native_emit", 12, 13, chunk=0)]
    assert read(RUN) is None


def test_spans_without_the_attributes_read_none(port_spans):
    port_spans += [_span("upload", 11, 12), _span("upload", 12, 13, chunk=3)]
    assert read(RUN) is None


def test_the_share_is_weighted_by_bytes(port_spans):
    port_spans += [
        _span("upload", 11.0, 11.1, bytes=8_388_608, staged=0),  # a plane slice from pinned memory
        _span("upload", 11.2, 11.3, bytes=8_388_608, staged=0),
        _span("upload", 11.4, 11.5, bytes=106_496, staged=106_496),  # coefficients, staged
        _span("upload", 11.6, 11.7, bytes=6_400, staged=6_400),
        _span("upload", 5.0, 6.0, bytes=1_000, staged=1_000),  # outside the window
    ]
    assert read(RUN) == pytest.approx(100.0 * 112_896 / (2 * 8_388_608 + 112_896))
    port_spans[:] = [_span("upload", 11, 12, bytes=10, staged=10)]
    assert read(RUN) == pytest.approx(100.0)


def test_the_metric_is_declared():
    (m,) = [m for m in spec.load()["per_layer"] if m["name"] == NAME]
    assert m == {"name": NAME, "unit": "%", "better": "lower", "source": "program_counter",
                 "layer": "device_pipeline", "moves": "encode_MBps", "workloads": ["cd16.pooled_tracks"]}
