"""Small-size fixtures for the benchmark's CPU tests (no card needed):
run with ``python -m pytest benchmark/tests -q`` from the repository root."""

import copy

import pytest

from benchmark import spec

TINY = "cd16.tiny"


def tiny_mix():
    """The pooled mix at a size the CPU plans in seconds: batches of two
    tracks of about 3-4 full blocks and a tail."""
    mix = spec.mix("pooled_tracks")
    mix.update(track_s=[1.2, 1.6], batch_blocks=8, distinct_batches=2,
               judge={"batches": 2, "wave_blocks": 4096, "chunk_blocks": 2, "per_stereo": 2})
    return mix


def tiny_bench():
    """BENCHMARK.json with one more cell, ``cd16.tiny``, reporting what
    ``cd16.pooled_tracks`` reports."""
    bench = copy.deepcopy(spec.load())
    bench["workloads"].append({"name": TINY, "config": "cd16", "traffic": "pooled_tracks", "chips": 1, "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cd16.pooled_tracks" in m.get("workloads", []):
            m["workloads"].append(TINY)
    return bench


@pytest.fixture
def cpu_pipeline(monkeypatch):
    """The plane pipeline at a chunk width the CPU plans quickly, on one
    torch thread (several pytest workers spin against each other's pools)."""
    import torch

    from lac_tpu_torch import device_pipeline

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def run_tiny(cpu_pipeline):
    """Run the tiny cell on the CPU: run_tiny(seed, traced=False,
    control=None) -> (result line, info); ``control`` as
    ``control.CONTROLS`` gives it."""
    from benchmark import run

    bench = tiny_bench()

    def go(seed=2**31 + 77, traced=False, control=None):
        return run.run_cell(bench, spec.workload(bench, TINY), seed, 1.0, traced, device="cpu", control=control,
                            mix=tiny_mix())

    return go
