"""Finds what ``BENCHMARK.json`` names: a cell, its configuration file, its
traffic mix and the reader of each metric, all by name. A new cell, mix,
configuration or metric is a new file and a new entry; nothing here
changes for it."""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench, name):
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise SystemExit(f"benchmark: no workload named {name!r} in BENCHMARK.json")


def config(bench, wl, root=ROOT):
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(Path(root) / entry["file"]) as f:
        cfg = json.load(f)
    cfg["name"] = entry["name"]
    return cfg


def mix(name, here=HERE):
    with open(Path(here) / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics(bench, cell, traced):
    """The metrics a run of ``cell`` reports: its per-layer metrics when
    traced, else its end-to-end ones; a metric without ``workloads`` is
    every cell's."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name, here=HERE):
    """The module that reads metric ``name`` (``metrics/<name>.py``): its
    ``read(run)`` returns the value, or None where the run holds nothing
    to read."""
    path = Path(here) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
