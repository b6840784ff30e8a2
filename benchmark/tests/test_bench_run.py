"""A run as a whole, on the CPU at a small size: the last line's schema,
the verdict on sound runs, on the control and on each planted fault, the
run without a card, and the modules the run and the reference import."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run, spec
from benchmark.control import CONTROLS, planted

ENV = dict(os.environ, PYTHONPATH=str(spec.ROOT), JAX_PLATFORMS="cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "cd16.pooled_tracks", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, env=dict(ENV, CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "cd16.pooled_tracks", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=dict(ENV, PYTHONPATH=""),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "lac_tpu_torch" in out.stderr


def test_sound_run_and_its_line(run_tiny):
    res, info = run_tiny()
    assert list(res) == KEYS  # the compared numbers last
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["metrics"]) == {"encode_MBps", "encoded_size_pct", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in res["metrics"].values())
    assert 20 < res["metrics"]["encoded_size_pct"]["value"] < 100
    assert res["checks"] == {name: {"value": 0, "limit": 0} for name in ("files_wrong", "blocks_wrong", "plans_wrong")}
    assert info["judged"]["files_judged"] == res["attempted"] and info["judged"]["blocks_judged"] > 0
    assert set(info["span_pct"]) == {"wave", "finish"}
    assert run.forbidden_modules() == []
    json.dumps(res)


class _FakeTrace:
    """A trace summary made up for the schema of a traced line."""

    def __init__(self, devices):
        pass

    def start(self):
        pass

    def stop(self):
        pass

    def summary(self, host_spans):
        return {"window_s": 1.0, "busy_s": 0.5, "busy_by_card": {0: 0.5}, "kernel_device_s": 0.1,
                "device_ops": [("k_after_stateful_fused", 0.1)], "idle_gaps": [("finish", 0.2)], "events": 3}


def test_traced_line(run_tiny, monkeypatch):
    import benchmark.devtrace

    monkeypatch.setattr(benchmark.devtrace, "DeviceTrace", _FakeTrace)
    monkeypatch.setattr(run.Context, "open_window", _open_with_fake_card(run.Context.open_window))
    res, _ = run_tiny(traced=True)
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert res["device"]["busy_s"] == 0.5 and res["device"]["window_s"] == 1.0
    assert res["breakdown"] == {"device_ops": [["k_after_stateful_fused", 0.1]], "idle_gaps": [["finish", 0.2]]}
    bench = spec.load()
    want = {m["name"] for m in spec.metrics(bench, "cd16.pooled_tracks", True)}
    assert set(res["metrics"]) <= want and "pool.wave_pct" in res["metrics"]
    assert res["metrics"]["device.idle_pct.batch"]["value"] == pytest.approx(50.0)


def _open_with_fake_card(orig):
    def open_window(self):
        t = orig(self)
        if self.traced:
            import benchmark.devtrace

            self.trace = benchmark.devtrace.DeviceTrace([0])
            self.trace.start()
        return t

    return open_window


@pytest.mark.parametrize("fault", ["unchanged", "half", "token"])
def test_each_fault_makes_the_run_incorrect(run_tiny, fault):
    with planted(fault):
        res, info = run_tiny()
    assert not res["correct"], info["notes"]
    assert res["checks"]["files_wrong"]["value"] + res["checks"]["blocks_wrong"]["value"] > 0


@pytest.mark.parametrize("kind, fails", [("lsb", "blocks_wrong"), ("coarse", "plans_wrong")])
def test_control_is_incorrect(run_tiny, kind, fails):
    """The lsb control breaks losslessness; the coarse one stays lossless,
    writes larger streams and breaks the plan."""
    sound, _ = run_tiny()
    res, info = run_tiny(control=CONTROLS[kind])
    assert not res["correct"]
    assert res["checks"][fails]["value"] > 0, info["notes"]
    if kind == "coarse":
        assert res["checks"]["blocks_wrong"]["value"] == 0 and res["checks"]["files_wrong"]["value"] == 0
        assert res["metrics"]["encoded_size_pct"]["value"] > sound["metrics"]["encoded_size_pct"]["value"]


def test_no_jax_and_a_reference_free_of_the_program():
    """Top-level module names compared whole: lac_tpu_torch passes, lac_tpu
    does not."""
    code = (
        "import sys\n"
        "import benchmark.run, benchmark.reference, benchmark.pooled, benchmark.probes\n"
        "import benchmark.devtrace, benchmark.control\n"
        "import lac_tpu_torch.pool, lac_tpu_torch.encoder, lac_tpu_torch.plan_graphs\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert "lac_tpu_torch" in tops and not tops & {"jax", "jaxlib", "flax", "lac_tpu"}
    code = "import sys, benchmark.reference\nprint(sorted({m.split('.')[0] for m in sys.modules}))\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=ENV, capture_output=True, text=True,
                         timeout=300)
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not tops & {"jax", "jaxlib", "flax", "lac_tpu", "lac_tpu_torch", "torch"}
