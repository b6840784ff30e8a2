"""The traffic: the same seed gives the same inputs, and every seed the
same set of sizes."""

import json

import numpy as np
import pytest

from benchmark import spec, traffic


@pytest.fixture
def cfg():
    bench = spec.load()
    return spec.config(bench, spec.workload(bench, "cd16.pooled_tracks"))


def test_batches_hold_the_issue_s_track_counts():
    mix = spec.mix("pooled_tracks")
    cd16 = json.loads((spec.HERE / "configs" / "cd16.json").read_text())
    hires24 = dict(cd16, sample_rate=96000, bit_depth=24)  # the same mix at 96 kHz
    counts = {name: traffic.tracks_per_batch(mix, c) for name, c in (("cd16", cd16), ("hires24", hires24))}
    assert counts == {"cd16": 6, "hires24": 3}


def test_layout_is_the_seed_s_own_order_of_one_set(cfg):
    mix = spec.mix("pooled_tracks")
    layout, warm = traffic.pooled_layout(mix, cfg)
    assert layout == traffic.pooled_layout(mix, cfg)[0] and len(layout) == mix["distinct_batches"]
    lo, hi = (s * cfg["sample_rate"] for s in mix["track_s"])
    assert all(lo <= f <= hi for batch in layout + [warm] for f in batch)
    blocks = [sum(f // traffic.N for f in batch) for batch in layout]
    assert all(3000 < b < 5000 for b in blocks)
    o1, o2 = traffic.batch_order(2**31 + 5, 4), traffic.batch_order(2**31 + 6, 4)
    assert sorted(o1) == sorted(o2) == list(range(4)) and o1 == traffic.batch_order(2**31 + 5, 4)


def test_content_repeats_for_a_seed(cfg):
    mix = spec.mix("pooled_tracks")
    frames = [20000, 30000, 25000]
    a = traffic.make_tracks(mix, cfg, frames, 2**33 + 1, (1, 0), "cpu")
    b = traffic.make_tracks(mix, cfg, frames, 2**33 + 1, (1, 0), "cpu")
    c = traffic.make_tracks(mix, cfg, frames, 2**33 + 2, (1, 0), "cpu")
    for (l1, r1), (l2, r2), (l3, _), f in zip(a, b, c, frames):
        assert l1.dtype == np.int32 and len(l1) == len(r1) == f
        assert np.array_equal(l1, l2) and np.array_equal(r1, r2) and not np.array_equal(l1, l3)
        assert l1.min() >= -32768 and l1.max() <= 32767
