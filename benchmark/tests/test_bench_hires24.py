"""The hires24 deployment and its cell ``hires24.pooled_tracks``: the
configuration states its source and guarantees, the mix lays out the
cell's batches at 96 kHz, a small 24-bit run on the CPU is correct and
the controls are not, and ``kernels.wide_parts_pct`` reads the port's
``meta_fetch`` spans."""

import copy
import json
from types import SimpleNamespace

import pytest

from benchmark import spec, traffic
from benchmark.control import CONTROLS
from benchmark.record import Record

CELL = "hires24.pooled_tracks"
TINY = "hires24.tiny"


def test_the_configuration_states_its_source_and_guarantees():
    bench = spec.load()
    entry = next(c for c in bench["configs"] if c["name"] == "hires24")
    cfg = json.loads((spec.ROOT / entry["file"]).read_text())
    assert entry["reduced"] == [] and entry["source"] == cfg["source"] and "Hi-Res" in cfg["source"]
    assert (cfg["sample_rate"], cfg["bit_depth"], cfg["channels"], cfg["stereo_mode"], cfg["cards"]) == (
        96000, 24, 2, "auto", 1)
    cd16 = json.loads((spec.HERE / "configs" / "cd16.json").read_text())
    assert cfg["guarantees"] == cd16["guarantees"]  # the same three: lossless, the v3 frame, the encoder's plan
    assert "256" in cfg["assumed"]["content"]
    wl = spec.workload(bench, CELL)
    assert (wl["config"], wl["traffic"], wl["chips"]) == ("hires24", "pooled_tracks", 1)


def test_the_mix_lays_out_three_tracks_a_batch():
    """At 96 kHz the pooled mix gives 3 tracks a batch; the four distinct
    batches and the warm-up hold these full blocks, and the pool splits the
    first two and the warm-up into two waves at its 4096-block cap."""
    from lac_tpu_torch import pool

    cfg = spec.config(spec.load(), spec.workload(spec.load(), CELL))
    batches, warm = traffic.pooled_layout(spec.mix("pooled_tracks"), cfg)
    assert [len(b) for b in batches] == [3, 3, 3, 3] and len(warm) == 3
    full = [[f // traffic.N for f in b] for b in batches + [warm]]
    assert [sum(b) for b in full] == [4224, 5142, 3763, 3913, 4934]
    waves = [[sum(w) for w in pool.split_waves(b, nfull_of=lambda x: x)] for b in full]
    assert waves == [[3027, 1197], [3372, 1770], [3763], [3913], [3485, 1449]]


def _tiny_bench():
    bench = copy.deepcopy(spec.load())
    bench["workloads"].append({"name": TINY, "config": "hires24", "traffic": "pooled_tracks", "chips": 1, "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY)
    return bench


@pytest.fixture
def run_hires(cpu_pipeline):
    """The cell's mix at a size the CPU plans in seconds: batches of two
    24-bit tracks of about 7-9 full blocks and a tail."""
    from benchmark import run

    bench = _tiny_bench()
    mix = spec.mix("pooled_tracks")
    mix.update(track_s=[1.2, 1.6], batch_blocks=16, distinct_batches=2,
               judge={"batches": 2, "wave_blocks": 4096, "chunk_blocks": 2, "per_stereo": 2})

    def go(seed=2**31 + 96, control=None):
        return run.run_cell(bench, spec.workload(bench, TINY), seed, 1.0, False, device="cpu", control=control,
                            mix=mix)

    return go


def test_a_small_24_bit_run_is_correct(run_hires):
    res, info = run_hires()
    assert res["correct"] and res["failed"] == 0, info["notes"]
    assert res["checks"] == {name: {"value": 0, "limit": 0} for name in ("files_wrong", "blocks_wrong", "plans_wrong")}
    assert set(res["metrics"]) == {"encode_MBps", "encoded_size_pct", "setup_s"}
    assert 50 < res["metrics"]["encoded_size_pct"]["value"] < 100
    assert info["judged"]["blocks_judged"] > 0


@pytest.mark.parametrize("kind, fails", [("lsb", "blocks_wrong"), ("coarse", "plans_wrong")])
def test_the_controls_fail_at_24_bits(run_hires, kind, fails):
    res, info = run_hires(control=CONTROLS[kind])
    assert not res["correct"] and res["checks"][fails]["value"] > 0, info["notes"]
    if kind == "coarse":
        assert res["checks"]["blocks_wrong"]["value"] == 0 and res["checks"]["files_wrong"]["value"] == 0


def _span(name, t0, **attrs):
    return SimpleNamespace(name=name, t0=t0, t1=t0 + 0.1, attrs=attrs)


def test_wide_parts_pct_reads_the_meta_fetch_spans(monkeypatch):
    from lac_tpu_torch.utils import debug

    reader = spec.reader("kernels.wide_parts_pct")
    run = Record(t_start=0.0, window=(10.0, 20.0))
    spans = []
    monkeypatch.setattr(debug, "spans", lambda lo, hi: [s for s in spans if s.t0 < hi and s.t1 > lo])
    assert reader.read(run) is None  # no spans
    spans += [_span("meta_fetch", 11.0, chunk=0, card="cuda:0"), _span("plan_wait", 11.5, chunk=0)]
    assert reader.read(run) is None  # a port without the tally
    spans += [_span("meta_fetch", 12.0, chunk=1, wide=30, parts=1000),
              _span("meta_fetch", 13.0, chunk=1, wide=0, parts=0),  # plans without partitions
              _span("meta_fetch", 14.0, chunk=2, wide=10, parts=3000),
              _span("meta_fetch", 25.0, chunk=9, wide=999, parts=1000)]  # outside the window
    assert reader.read(run) == pytest.approx(1.0)
    spans[:] = [_span("meta_fetch", 12.0, chunk=1, wide=0, parts=0)]
    assert reader.read(run) is None
