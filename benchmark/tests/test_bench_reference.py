"""The plain reference on tiny inputs: streams of the port's host route
decode to their inputs with the reference encoder's plans; a broken
stream, a missing one, the lsb control's and a coarser plan's do not;
the vectorised adapter is the decoder's; the sample covers every chunk,
every tail and both stereo routes."""

import numpy as np
import pytest

from benchmark import reference, signals
from benchmark.control import _flip_every_block, lsb_control

CASES = [("tonal", 16, 44100), ("noise", 16, 44100), ("noise", 24, 96000)]
SAMPLE = [(0, 0), (0, 1), (0, 2)]


def _config(depth, rate):
    return {"channels": 2, "sample_rate": rate, "bit_depth": depth, "stereo_mode": "auto"}


def _stream(left, right, depth, rate, **opts):
    from lac_tpu_torch.encoder import FrameEncoder

    enc = FrameEncoder(12, 2, rate, depth, device="cpu")
    for key, value in opts.items():
        getattr(enc, f"set_{key}")(value)
    return enc.encode_frame(left, right)


@pytest.fixture(params=CASES, ids=[f"{r}-{d}" for r, d, _ in CASES])
def case(request):
    recipe, depth, rate = request.param
    left, right = signals.make_track(recipe, 2 * 16384 + 777, rate, depth, 11, "cpu")
    return left, right, depth, rate, _stream(left, right, depth, rate)


def _sparse(frames, seed):
    """Quiet, sparse PCM: zero runs, bin and adaptive-Rice blocks."""
    rng = np.random.default_rng(seed)
    env = 2.0 ** (6 * np.sin(np.arange(frames) / 90.0) + 3)
    left = np.clip(rng.standard_normal(frames) * env, -32768, 32767).astype(np.int32)
    left[rng.random(frames) < 0.6] = 0
    return left, (left // 2).astype(np.int32)


def test_sound_stream_decodes_to_its_input(case):
    left, right, depth, rate, data = case
    got = reference.judge([data], [(left, right)], _config(depth, rate), SAMPLE)
    assert (got["files_wrong"], got["blocks_wrong"], got["plans_wrong"], got["blocks_judged"]) == (0, 0, 0, 3)


def test_sound_plans_of_sparse_and_short_blocks():
    """Every residual mode, a tail under one partition's size and odd tails."""
    for frames in (40, 1000, 3 * 16384 + 517):
        left, right = _sparse(frames, frames)
        data = _stream(left, right, 16, 44100)
        blocks = -(-frames // 16384)
        got = reference.judge([data], [(left, right)], _config(16, 44100), [(0, b) for b in range(blocks)])
        assert (got["blocks_wrong"], got["plans_wrong"]) == (0, 0), got["notes"]


def test_broken_streams_are_caught(case):
    left, right, depth, rate, data = case
    cfg = _config(depth, rate)
    assert reference.judge([_flip_every_block(data)], [(left, right)], cfg, SAMPLE)["blocks_wrong"] == 3
    missing = reference.judge([b""], [(left, right)], cfg, SAMPLE)
    assert missing["files_wrong"] == 1 and missing["blocks_wrong"] == 3
    short = reference.judge([data], [(left[:-1], right[:-1])], cfg, SAMPLE)  # a frame count the input lacks
    assert short["files_wrong"] == 1
    (ctl_l, ctl_r), = lsb_control([(left, right)])
    ctl = reference.judge([_stream(ctl_l, ctl_r, depth, rate)], [(left, right)], cfg, SAMPLE)
    assert ctl["files_wrong"] == 0 and ctl["blocks_wrong"] == 3  # a lossless frame of the wrong samples


@pytest.mark.parametrize("opts", [{"partitioning_enabled": False}, {"zero_run_enabled": False}])
def test_a_coarser_plan_is_caught(opts):
    """Lossless streams coded with less than the reference encoder's
    search: no partition orders, or no zero runs."""
    left, right = _sparse(3 * 16384 + 517, 5)
    data = _stream(left, right, 16, 44100, **opts)
    sample = [(0, b) for b in range(4)]
    got = reference.judge([data], [(left, right)], _config(16, 44100), sample)
    assert got["blocks_wrong"] == 0 and got["plans_wrong"] >= 3, got["notes"]
    assert len(data) > len(_stream(left, right, 16, 44100))


def test_vectorised_adapter_is_the_decoder_s():
    rng = np.random.default_rng(3)
    for trial in range(12):
        n = int(rng.integers(1, 2000))
        u = [rng.integers(0, 4, n), (rng.exponential(1, n) * 2.0 ** rng.integers(0, 20)).astype(np.int64),
             np.where(rng.random(n) < 0.8, 0, rng.integers(0, 1 << 32, n)),
             (rng.exponential(1, n) * 2.0 ** (10 * np.sin(np.arange(n) / 50.0) + 10)).astype(np.int64)][trial % 4]
        u = u.astype(np.int64)
        state, total, want = reference.StatefulK(), 0, []
        for i, x in enumerate(u.tolist()):
            total += x
            want.append(state.adapt(total, i + 1))
        assert reference.stateful_k_after(u).tolist() == want


def test_sample_covers_chunks_tails_and_stereo_routes():
    """Two batches of three files; waves of at most 8 full blocks in chunks
    of 3: one block from each chunk, each file's last block, and both
    stereo routes."""
    rng = np.random.default_rng(3)
    n = 16384
    frames_of = [3 * n + 10, 4 * n, 2 * n + 5, 5 * n + 1, 1 * n + 7, 100]
    batches = [[0, 1, 2], [3, 4, 5]]
    flags = [np.array(f, np.uint8) for f in ([0, 0, 0, 1], [0, 0, 0, 0], [1, 1, 1], [0] * 6, [1, 0], [0])]

    def fake(i):  # a frame whose per-block stereo flags are flags[i]
        nb = len(flags[i])
        offsets = np.arange(nb, dtype=np.int64) * 2
        data = bytearray(2 * nb)
        data[0::2] = flags[i].tobytes()
        hdr = {"channels": 2, "stereo_mode": reference.STEREO_PER_BLOCK}
        return bytes(data), (hdr, None, offsets, None)

    made = [fake(i) for i in range(6)]
    outputs = [d for d, _ in made]
    frames = {i: f for i, (_, f) in enumerate(made)}
    pairs = reference.draw_sample(rng, batches, frames_of, frames, outputs, 2, 8, 3, 2)
    # batch 0: files 0 and 1 (3 + 4 full) one wave, file 2 (2 full) a second; batch 1: files 3 and 4 one
    chunks = [[(0, 0), (0, 1), (0, 2)], [(1, 0), (1, 1), (1, 2)], [(1, 3)], [(2, 0), (2, 1)],
              [(3, 0), (3, 1), (3, 2)], [(3, 3), (3, 4), (4, 0)]]
    assert all(set(c) & set(pairs) for c in chunks)
    assert {(0, 3), (1, 3), (2, 2), (3, 5), (4, 1), (5, 0)} <= set(pairs)  # every file's last block
    for files in batches:
        for route in (0, 1):
            have = [p for p in pairs if p[0] in files and flags[p[0]][p[1]] == route]
            spare = sum(int((flags[i] == route).sum()) for i in files)
            assert len(have) >= min(2, spare)
