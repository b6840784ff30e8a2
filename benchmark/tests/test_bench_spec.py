"""BENCHMARK.json and the files it names: found by name, within the
contract's limits, and extended by new files and entries alone."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_every_name_is_found():
    bench = spec.load()
    for wl in bench["workloads"]:
        cfg = spec.config(bench, wl)
        assert cfg["sample_rate"] in (44100, 48000, 96000, 192000) and cfg["bit_depth"] in (16, 24)
        mix = spec.mix(wl["traffic"])
        assert mix["driver"] == "pooled"
        for traced in (False, True):
            names = [m["name"] for m in spec.metrics(bench, wl["name"], traced)]
            assert names, (wl["name"], traced)
            for name in names:
                assert callable(spec.reader(name).read)


def test_contract_shape():
    bench = spec.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    root = spec.ROOT
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (root / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        for cell in m.get("workloads", cells):  # each cell that reports it reports what it moves
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:  # setup_s, one more end-to-end metric and one per-layer metric in every cell
        assert len(spec.metrics(bench, cell, False)) >= 2 and spec.metrics(bench, cell, True)


def _digest(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_are_new_files_and_entries(tmp_path):
    """In a copy of the benchmark, a new mix, a new per-layer metric and a
    new cell are added as files and entries only; the harness loads them
    and runs the cell (at a small size, on the CPU)."""
    shutil.copytree(spec.HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "benchmark")
    mix = spec.mix("pooled_tracks")
    mix.update(track_s=[1.2, 1.4], batch_blocks=8, distinct_batches=1,
               judge={"batches": 1, "wave_blocks": 4096, "chunk_blocks": 2, "per_stereo": 1})
    (tmp_path / "benchmark" / "traffic" / "short_tracks.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark" / "metrics" / "pool.batches.py").write_text(
        '"""pool.batches (program counter): batches completed in the window."""\n\n\n'
        "def read(run):\n    return run.counters.get('batches')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "cd16.short_tracks", "config": "cd16", "traffic": "short_tracks",
                               "chips": 1, "why": "a cell added by files and entries alone"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "encode_MBps":
            m["workloads"].append("cd16.short_tracks")
    bench["per_layer"].append({"name": "pool.batches", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "pool", "moves": "encode_MBps",
                               "workloads": ["cd16.short_tracks"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, torch\n"
        "from lac_tpu_torch import device_pipeline\n"
        "device_pipeline.CHUNK_BLOCKS = 2\n"
        "torch.set_num_threads(1)\n"
        "from benchmark import run, spec\n"
        "assert spec.HERE.parent.resolve() == __import__('pathlib').Path.cwd().resolve()\n"
        "b = spec.load()\n"
        "wl = spec.workload(b, 'cd16.short_tracks')\n"
        "res, info = run.run_cell(b, wl, 5, 0.5, True, device='cpu')\n"
        "print(json.dumps(res))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["pool.batches"]["value"] >= 1
    after = _digest(tmp_path / "benchmark")
    assert all(after[p] == h for p, h in before.items())  # no file that was there changed


@pytest.mark.parametrize("name", ["cd16"])
def test_configs_state_the_guarantee(name):
    cfg = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    assert cfg["channels"] == 2 and cfg["stereo_mode"] == "auto"
    assert any("lossless" in g for g in cfg["guarantees"]) and any("plan" in g for g in cfg["guarantees"])
    assert Path(spec.HERE / "configs" / f"{name}.json").is_file()
