"""The port's many-file encode paths on the CPU: ``pool`` (cross-file
pooled waves), ``batch`` and the CLI's injection hooks.

The same PCM, made from seeds, goes through ``lac_tpu_torch`` on
``device="cpu"`` (plain kernel versions, a pinned small chunk width so
that file boundaries fall inside chunks), through ``lac_tpu``'s pooled
encode under ``xp=jax.numpy`` and through its ``xp=numpy`` encode.
Tolerance: none, frames are byte-identical.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from lac_tpu import batch as ref_batch  # noqa: E402
from lac_tpu import pool as ref_pool  # noqa: E402
from lac_tpu.encoder import FrameEncoder as RefEncoder  # noqa: E402
from lac_tpu.io import write_wav  # noqa: E402
from lac_tpu.runtime.native import native_available as ref_native_available  # noqa: E402
from lac_tpu_torch import batch, cli, device_pipeline, pool  # noqa: E402
from lac_tpu_torch import io as port_io  # noqa: E402
from lac_tpu_torch.encoder import FrameEncoder  # noqa: E402
from lac_tpu_torch.ops import cuda_kernels  # noqa: E402

B = 16384


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plane pipeline's CPU operators are small: with the suite's worker processes side by
    side, torch's intra-op thread pools spin against each other and a 2 s test takes minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 4)


def _mix(frames, seed, depth=16):
    """Stereo content whose character changes from block to block
    (correlated / independent / borderline), so pooled waves hit MS, LR
    and the uncertain probe path."""
    rng = np.random.RandomState(seed)
    scale = 1 if depth == 16 else 200
    lim = 1 << (depth - 1)
    t = np.arange(frames, dtype=np.float64)
    sig = (9000 * scale * np.sin(2 * np.pi * 440 * t / 44100)).astype(np.int64)
    left = np.clip(sig + rng.randint(-2000 * scale, 2000 * scale, frames), -lim, lim - 1)
    right = np.empty(frames, np.int64)
    for b0 in range(0, frames, B):
        b1 = min(b0 + B, frames)
        m = (b0 // B) % 3
        if m == 0:
            right[b0:b1] = left[b0:b1] // 2 + rng.randint(-100 * scale, 100 * scale, b1 - b0)
        elif m == 1:
            right[b0:b1] = rng.randint(-9000 * scale, 9000 * scale, b1 - b0)
        else:
            right[b0:b1] = (left[b0:b1] * 0.82).astype(np.int64) + rng.randint(-2500 * scale, 2500 * scale, b1 - b0)
    return left.astype(np.int32), np.clip(right, -lim, lim - 1).astype(np.int32)


def _serial(items, sr, depth, mode):
    return [FrameEncoder(12, mode if r is not None and len(r) else 0, sr, depth, device="cpu").encode(
        l, r if r is not None else ()) for l, r in items]


def _ref_numpy(items, sr, depth, mode):
    return [RefEncoder(12, mode if r is not None and len(r) else 0, sr, depth, xp=np).encode(
        l, r if r is not None else ()) for l, r in items]


# ------------------------------------------------------------ encode_pooled

# lengths mix tails, an exact block multiple, a file under one chunk and a file without a full
# block; at chunk width 4 the 10 full blocks share chunks across file boundaries
AUTO_LENGTHS = (3 * B + 1000, 2 * B, B + 77, 4 * B + B // 2, 5000)
MIXED = (("stereo", 2 * B + 500, 11), ("mono", 3 * B, 12), ("stereo", B + 9, 14), ("mono", 700, 15))


@pytest.fixture(scope="module")
def auto_batch():
    items = [_mix(n, seed) for seed, n in enumerate(AUTO_LENGTHS, 1)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_pipeline, "CHUNK_BLOCKS", 4)
        got = pool.encode_pooled(items, 44100, 16, stereo_mode=2, device="cpu")
        serial = _serial(items, 44100, 16, 2)
    return {"items": items, "port": got, "serial": serial,
            "jnp": ref_pool.encode_pooled(items, 44100, 16, stereo_mode=2, xp=jnp),
            "np": _ref_numpy(items, 44100, 16, 2)}


@pytest.mark.parametrize("i", range(len(AUTO_LENGTHS)), ids=[f"{n}-frames" for n in AUTO_LENGTHS])
def test_encode_pooled_stereo_auto(auto_batch, i):
    got = auto_batch["port"][i]
    assert got == auto_batch["serial"][i], "pooled frame differs from the port's per-item encode"
    assert got == auto_batch["jnp"][i], "pooled frame differs from lac_tpu.pool.encode_pooled(xp=jnp)"
    assert got == auto_batch["np"][i], "pooled frame differs from lac_tpu's numpy encode"


@pytest.fixture(scope="module", params=[0, 1], ids=["lr", "ms"])
def mixed_batch(request):
    mode = request.param
    items = []
    for kind, n, seed in MIXED:
        l, r = _mix(n, seed)
        items.append((l, r if kind == "stereo" else None))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_pipeline, "CHUNK_BLOCKS", 4)
        got = pool.encode_pooled(items, 48000, 16, stereo_mode=mode, device="cpu")
        serial = _serial(items, 48000, 16, mode)
    return {"port": got, "serial": serial, "np": _ref_numpy(items, 48000, 16, mode),
            "jnp": ref_pool.encode_pooled(items, 48000, 16, stereo_mode=mode, xp=jnp) if mode == 1 else None}


@pytest.mark.parametrize("i", range(len(MIXED)), ids=[f"{k}-{n}" for k, n, _ in MIXED])
def test_encode_pooled_mixed_mono_stereo_forced_modes(mixed_batch, i):
    """Mono and stereo items pool into separate waves; forced lr and ms."""
    got = mixed_batch["port"][i]
    assert got == mixed_batch["serial"][i] == mixed_batch["np"][i]
    if mixed_batch["jnp"] is not None:
        assert got == mixed_batch["jnp"][i]


def test_encode_pooled_24bit():
    """24-bit content pools in int32 planes, values beyond int16 included."""
    items = [_mix(2 * B + 9, 13, depth=24), _mix(B, 16, depth=24)]
    assert max(int(np.abs(l).max()) for l, _ in items) > 1 << 16
    got = pool.encode_pooled(items, 96000, 24, stereo_mode=2, device="cpu")
    assert got == _serial(items, 96000, 24, 2) == _ref_numpy(items, 96000, 24, 2)
    assert got == ref_pool.encode_pooled(items, 96000, 24, stereo_mode=2, xp=jnp)


HIRES = ("tonal", "noise", "full-scale")


def _full_scale(frames, seed):
    """A 24-bit track that hits both rails: a sine driven 2% past full
    scale, clipped to -2^23..2^23 - 1, with noise; the right channel its
    negation plus noise of its own."""
    rng = np.random.RandomState(seed)
    lim = 1 << 23
    t = np.arange(frames, dtype=np.float64)
    sig = 1.02 * lim * np.sin(2 * np.pi * 997 * t / 96000) + rng.randint(-4096, 4096, frames)
    left = np.clip(sig, -lim, lim - 1).astype(np.int32)
    right = np.clip(-sig + rng.randint(-(1 << 20), 1 << 20, frames), -lim, lim - 1).astype(np.int32)
    assert left.min() == -lim and left.max() == lim - 1
    return left, right


@pytest.fixture(scope="module")
def hires_batch():
    """Three 96 kHz / 24-bit tracks of 2-3 full blocks and a tail, pooled
    as the benchmark's hires24 cell pools its batches: its tonal and noise
    recipes, and a track at full scale."""
    from benchmark import reference, signals

    frames = (2 * B + 333, 3 * B + 1, 2 * B + 4000)
    items = [signals.make_track(recipe, n, 96000, 24, 23 + i, "cpu") for i, (recipe, n) in
             enumerate(zip(HIRES[:2], frames))]
    items.append(_full_scale(frames[2], 25))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_pipeline, "CHUNK_BLOCKS", 4)
        got = pool.encode_pooled(items, 96000, 24, stereo_mode=2, device="cpu")
    cfg = {"channels": 2, "sample_rate": 96000, "bit_depth": 24, "stereo_mode": "auto"}
    sample = [(i, b) for i, n in enumerate(frames) for b in range(-(-n // B))]
    return {"items": items, "port": got, "np": _ref_numpy(items, 96000, 24, 2),
            "jnp": ref_pool.encode_pooled(items, 96000, 24, stereo_mode=2, xp=jnp),
            "judged": reference.judge(got, items, cfg, sample)}


@pytest.mark.parametrize("i", range(len(HIRES)), ids=HIRES)
def test_encode_pooled_hires24_tracks(hires_batch, i):
    """Bytes equal lac_tpu's (numpy, and its pooled encode under
    jax.numpy), the decode is PCM-exact, and the benchmark's plain
    reference holds every block of every stream to its input and to the
    reference encoder's plan."""
    from lac_tpu_torch.decoder import FrameDecoder

    got = hires_batch["port"][i]
    assert got == hires_batch["np"][i] == hires_batch["jnp"][i]
    left, right, hdr = FrameDecoder().decode(got)
    want_l, want_r = hires_batch["items"][i]
    np.testing.assert_array_equal(left, want_l)
    np.testing.assert_array_equal(right, want_r)
    assert (hdr.sample_rate, hdr.bit_depth) == (96000, 24)
    judged = hires_batch["judged"]
    assert (judged["files_wrong"], judged["blocks_wrong"], judged["plans_wrong"]) == (0, 0, 0), judged["notes"]
    assert judged["blocks_judged"] == 3 + 4 + 3


def test_encode_pooled_empty_list_and_single_item():
    assert pool.encode_pooled([], 44100, 16, device="cpu") == []
    item = _mix(B + 50, 21)
    assert pool.encode_pooled([item], 44100, 16, device="cpu") == _serial([item], 44100, 16, 2)


def test_encode_pooled_encoder_options_and_workers():
    items = [_mix(2 * B + 3, 22), _mix(B, 23), _mix(100, 24)]
    want = [RefEncoder(12, 2, 44100, 16, xp=np) for _ in items]
    for enc in want:
        enc.set_partitioning_enabled(False)
    want = [enc.encode(l, r) for enc, (l, r) in zip(want, items)]
    for workers in (1, 4):
        got = pool.encode_pooled(items, 44100, 16, device="cpu", max_workers=workers, partitioning_enabled=False,
                                 thread_count=2)
        assert got == want
    assert want != _serial(items, 44100, 16, 2)  # the option reached the waves and the host route


def test_encode_pooled_several_waves(monkeypatch):
    """A lowered wave cap splits the batch; the bytes do not change and no wave exceeds the cap
    unless one file alone does."""
    items = [_mix(n, 30 + i) for i, n in enumerate((2 * B + 1, 3 * B, B, 6 * B + 5, B + B // 2))]
    monkeypatch.setattr(pool, "_MAX_WAVE_BLOCKS", 5)
    waves = []
    real = pool.run_group_wave
    monkeypatch.setattr(pool, "run_group_wave", lambda group, *a, **k: waves.append([j.nfull for j in group])
                        or real(group, *a, **k))
    got = pool.encode_pooled(items, 44100, 16, device="cpu")
    assert waves == [[2, 3], [1], [6], [1]]
    assert got == _serial(items, 44100, 16, 2)


def test_encode_pooled_empty_item_raises_as_encode_does():
    with pytest.raises(ValueError, match="left channel must not be empty"):
        pool.encode_pooled([_mix(B, 1), (np.empty(0, np.int32), None)], 44100, 16, device="cpu")


@pytest.mark.parametrize("depth,bad", [(24, 1 << 23), (24, -(1 << 23) - 1), (16, 40000)])
def test_out_of_range_pcm_raises_before_any_wave(monkeypatch, depth, bad):
    """The plane matrices would truncate such a sample: every item is validated before device work."""
    def boom(*a, **k):
        raise AssertionError("a wave ran before the items were validated")

    monkeypatch.setattr(pool, "run_group_wave", boom)
    good = _mix(2 * B, 40, depth)
    left, right = _mix(B + 10, 41, depth)
    right[B // 2] = bad
    with pytest.raises(ValueError, match="right sample is outside the configured PCM bit depth"):
        pool.encode_pooled([good, (left, right)], 96000, depth, device="cpu")
    with pytest.raises(ValueError):
        ref_pool.encode_pooled([good, (left, right)], 96000, depth, xp=np)


# ------------------------------------------------------------ split_waves


class _Job:
    def __init__(self, n):
        self.nfull = n


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.integers(1, 50), max_size=30), st.integers(1, 60))
def test_split_waves_matches_lac_tpu(sizes, cap):
    jobs = [_Job(n) for n in sizes]
    got = pool.split_waves(jobs, max_blocks=cap)
    assert got == ref_pool.split_waves(jobs, max_blocks=cap)
    assert [j for w in got for j in w] == jobs
    assert all(sum(j.nfull for j in w) <= cap or len(w) == 1 for w in got)
    pairs = list(enumerate(jobs))
    assert pool.split_waves(pairs, nfull_of=lambda p: p[1].nfull, max_blocks=cap) == ref_pool.split_waves(
        pairs, nfull_of=lambda p: p[1].nfull, max_blocks=cap)


def test_split_waves_default_cap_is_read_at_call_time(monkeypatch):
    assert pool._MAX_WAVE_BLOCKS == ref_pool._MAX_WAVE_BLOCKS == 4096
    jobs = [_Job(3), _Job(3), _Job(3)]
    assert [len(w) for w in pool.split_waves(jobs)] == [3]
    monkeypatch.setattr(pool, "_MAX_WAVE_BLOCKS", 5)
    assert [len(w) for w in pool.split_waves(jobs)] == [1, 1, 1]
    assert [len(w) for w in pool.split_waves([_Job(10)], max_blocks=4)] == [1]


# ------------------------------------------------------------ the wave and its callbacks


def _prepared(items, kind="auto", depth=16):
    return [pool.PreparedEncode(parts=[], in_path="", wav=(l, r, 0, 44100, depth), kind=kind, nfull=len(l) // B,
                                dt=np.int16 if depth == 16 else np.int32, key=(kind,)) for l, r in items]


def test_progress_cb_fires_in_block_order_with_the_returned_dicts():
    left, right = _mix(10 * B, 50)
    enc = FrameEncoder(12, 2, 44100, 16, device="cpu")
    pipe = device_pipeline.PlanePipeline(enc, left, right, 10, "auto", enc.device)
    seen = []

    def cb(done, payloads, flags, uncertain):
        assert sorted(payloads) == sorted(flags) == sorted(uncertain) == list(range(done))
        seen.append((done, payloads, flags, uncertain))

    result = pipe.run(progress_cb=cb)
    assert [s[0] for s in seen] == [4, 8, 10]  # after each chunk of 4, in order
    assert all(p is result[0] and f is result[1] and u is result[2] for _, p, f, u in seen)
    assert result[0] == device_pipeline.encode_full_blocks(enc, left, right, 10, "auto", enc.device)[0]


def test_views_equal_the_cut_planes_and_are_checked():
    left, right = _mix(9 * B, 51)
    enc = FrameEncoder(12, 1, 44100, 16, device="cpu")
    lview = left.reshape(9, B).astype(np.int16)
    rview = right.reshape(9, B).astype(np.int16)
    got = device_pipeline.PlanePipeline(enc, None, None, 9, "ms", enc.device, views=(lview, rview)).run()
    assert got == device_pipeline.PlanePipeline(enc, left, right, 9, "ms", enc.device).run()
    with pytest.raises(ValueError, match="views"):
        device_pipeline.PlanePipeline(enc, None, None, 8, "ms", enc.device, views=(lview, rview))
    with pytest.raises(ValueError, match="views"):
        device_pipeline.PlanePipeline(enc, None, None, 9, "mono", enc.device, views=(lview, rview))


def test_release_hands_files_over_in_group_order_with_the_dicts_popped(monkeypatch):
    items = [_mix(n, 60 + i) for i, n in enumerate((3 * B, B, 5 * B, 2 * B))]  # 11 blocks: chunks of 4, 4, 3
    group = _prepared(items)
    enc = FrameEncoder(12, 2, 44100, 16, device="cpu")
    returned, progress = [], []
    real_run = device_pipeline.PlanePipeline.run

    def run(self, progress_cb=None):
        def cb(done, *dicts):
            progress_cb(done, *dicts)
            progress.append((done, len(released), sorted(dicts[0])))

        returned.append(real_run(self, progress_cb=cb))
        return returned[-1]

    monkeypatch.setattr(device_pipeline.PlanePipeline, "run", run)
    released = []
    pool.run_group_wave(group, lambda i, planes: released.append((i, planes)), template_enc=enc)
    assert [i for i, _ in released] == [0, 1, 2, 3]
    # after 4 blocks files 0 and 1 are whole, after 8 no further file, after 11 all; what was
    # handed over has left the pipeline's dicts, the blocks of an unfinished file stay
    assert progress == [(4, 2, []), (8, 2, [4, 5, 6, 7]), (11, 4, [])]
    assert returned == [({}, {}, {})]
    for (i, (pp, fl, un)), (left, right) in zip(released, items):
        nf = len(left) // B
        assert sorted(pp) == sorted(fl) == sorted(un) == list(range(nf))  # file-local block numbers
        assert enc.encode_frame(left, right, (pp, fl, un)) == enc.encode(left, right)


def test_run_group_wave_builds_its_encoder_from_the_first_job(tmp_path):
    """Without a template the wave takes format and knobs from the first job's options (the
    serving loop's form): PreparedEncode jobs from WAV files, frames through the CLI hook."""
    paths, items = [], []
    for i, n in enumerate((2 * B + 30, B + 1)):
        l, r = _mix(n, 70 + i)
        p = str(tmp_path / f"w{i}.wav")
        assert write_wav(p, l, r, 2, 44100, 16)
        paths.append(p)
        items.append((l, r))
    jobs = [pool.prepare_encode_job(["encode", p, p + ".lac", "--no-partitioning"]) for p in paths]
    assert jobs[0].key == jobs[1].key
    planes = {}
    pool.run_group_wave(jobs, planes.__setitem__, device="cpu")
    for job, (l, r) in zip(jobs, items):
        cli._set_encode_injection(job.in_path, job.wav, planes[jobs.index(job)])
        assert cli.main(job.parts, device="cpu") == 0
        want = RefEncoder(12, 2, 44100, 16, xp=np)
        want.set_partitioning_enabled(False)
        with open(job.parts[2], "rb") as f:
            assert f.read() == want.encode(l, r)


# ------------------------------------------------------------ prepare_encode_job


@pytest.fixture
def job_wav(tmp_path, monkeypatch):
    monkeypatch.setenv("LAC_TPU_BACKEND", "jax")  # lac_tpu pools on its JAX backend only
    monkeypatch.delenv("LAC_TPU_STREAM_BLOCKS", raising=False)
    l, r = _mix(B + 200, 31)
    wav, tiny, mono = (str(tmp_path / n) for n in ("p.wav", "tiny.wav", "mono.wav"))
    assert write_wav(wav, l, r, 2, 48000, 16)
    assert write_wav(tiny, l[:5000], r[:5000], 2, 48000, 16)
    assert write_wav(mono, l, np.empty(0, np.int32), 1, 96000, 24)
    return {"wav": wav, "tiny": tiny, "mono": mono, "out": str(tmp_path / "p.lac"),
            "missing": str(tmp_path / "nope.wav")}


JOBS = {  # name -> (job vector with placeholders, expected (kind, nfull, dtype, key, effective_mode) or None)
    "auto": (["encode", "{wav}", "{out}"], ("auto", 1, np.int16, ("auto", "<i2", True), 2)),
    "ms-no-partitioning": (["encode", "{wav}", "{out}", "--stereo-mode=ms", "--no-partitioning"],
                           ("ms", 1, np.int16, ("ms", "<i2", False), 1)),
    "lr-threads": (["encode", "{wav}", "{out}", "--stereo-mode=lr", "--threads=3"],
                   ("lr", 1, np.int16, ("lr", "<i2", True), 0)),
    "mono-24bit": (["encode", "{mono}", "{out}", "--stereo-mode=ms"], ("mono", 1, np.int32, ("mono", "<i4", True), 0)),
    "debug-zr": (["encode", "{wav}", "{out}", "--debug-zr"], None),
    "debug-threads": (["encode", "{wav}", "{out}", "--debug-threads"], None),
    "debug-lpc": (["encode", "{wav}", "{out}", "--debug-lpc"], None),
    "bad-flag": (["encode", "{wav}", "{out}", "--bogus"], None),
    "missing-input": (["encode", "{missing}", "{out}"], None),
    "same-path": (["encode", "{wav}", "{wav}"], None),
    "no-full-block": (["encode", "{tiny}", "{out}"], None),
    "decode-job": (["decode", "{wav}", "{out}"], None),
    "too-short": (["encode", "{wav}"], None),
}


@pytest.mark.parametrize("name", sorted(JOBS))
def test_prepare_encode_job_matches_lac_tpu(job_wav, name):
    template, want = JOBS[name]
    parts = [p.format(**job_wav) for p in template]
    got = pool.prepare_encode_job(parts)
    ref = ref_pool.prepare_encode_job(parts) if ref_native_available() else None
    if want is None:
        assert got is None and ref is None
        return
    assert (got.kind, got.nfull, got.dt, got.key, got.effective_mode) == want
    assert got.parts == parts and got.in_path == parts[1] and len(got.wav[0]) == B + 200
    if ref is not None:  # lac_tpu pools only where its native runtime is built
        assert (ref.kind, ref.nfull, ref.dt, ref.key, ref.effective_mode) == want
        assert got.opts == ref.opts
        assert all(np.array_equal(a, b) for a, b in zip(got.wav, ref.wav))


def test_prepare_encode_job_streaming_route_is_screened_from_the_scan(job_wav, monkeypatch):
    """A file headed for the streaming route is turned away from the WAV scan alone, never read whole."""
    parts = ["encode", job_wav["wav"], job_wav["out"]]
    monkeypatch.setenv("LAC_TPU_STREAM_BLOCKS", "2")

    def boom(path):
        raise AssertionError("the prescreen read a streaming-route WAV whole")

    monkeypatch.setattr(port_io, "read_wav", boom)
    assert pool.prepare_encode_job(parts) is None  # 2 blocks (one full, one partial) reach the threshold
    monkeypatch.setenv("LAC_TPU_STREAM_BLOCKS", "0")  # 0: no streaming route, the job pools
    with pytest.raises(AssertionError, match="read a streaming-route WAV"):
        pool.prepare_encode_job(parts)


# ------------------------------------------------------------ batch


@pytest.fixture(scope="module")
def batch_items():
    return [_mix(9 * B + 10, 80), (_mix(2 * B, 81)[0], None), _mix(700, 82), _mix(B + 5, 83)]


@pytest.mark.parametrize("workers", [1, 4])
def test_encode_batch_matches_serial_and_lac_tpu(batch_items, workers):
    """One item reaches the plane pipeline (9 full blocks), the others the host route."""
    got = batch.encode_batch(batch_items, 44100, 16, stereo_mode=2, device="cpu", max_workers=workers)
    assert got == _serial(batch_items, 44100, 16, 2)
    assert got == ref_batch.encode_batch(batch_items, 44100, 16, stereo_mode=2, xp=np, max_workers=workers)
    assert got == pool.encode_pooled(batch_items, 44100, 16, stereo_mode=2, device="cpu", max_workers=workers)


def test_encode_batch_threads_queue_device_work_one_at_a_time(monkeypatch):
    """Two pipelines on two threads: their dispatch stages never overlap (interleaved operator
    streams thrash the interpreter lock on the card), and the bytes are the serial ones."""
    items = [_mix(8 * B + 11, 86), _mix(8 * B, 87)]
    state = {"inside": 0, "most": 0, "stages": 0, "threads": set()}
    guard = threading.Lock()

    def watched(stage):
        def run(self):
            with guard:
                state["inside"] += 1
                state["most"] = max(state["most"], state["inside"])
                state["stages"] += 1
                state["threads"].add(threading.current_thread())
            try:
                return stage(self)
            finally:
                with guard:
                    state["inside"] -= 1
        return run

    for name in ("dispatch_analyze", "dispatch_plan"):
        monkeypatch.setattr(device_pipeline._ChunkJob, name, watched(getattr(device_pipeline._ChunkJob, name)))
    got = batch.encode_batch(items, 44100, 16, device="cpu", max_workers=2)
    assert got == _serial(items, 44100, 16, 2)
    # _serial ran the same stages again: 2 files x 2 chunks x 2 stages, twice; every pipeline
    # dispatches from a thread of its own (2 in the batch, side by side, and 2 in _serial)
    assert state == {"inside": 0, "most": 1, "stages": 16, "threads": state["threads"]} and len(state["threads"]) == 4
    assert all(t.name == "lac-dispatch-0-cpu" for t in state["threads"])


def test_encode_batch_options_and_empty():
    assert batch.encode_batch([], 44100, 16, device="cpu") == []
    items = [_mix(B + 3, 84), _mix(2 * B, 85)]
    got = batch.encode_batch(items, 44100, 16, stereo_mode=1, device="cpu", zero_run_enabled=False)
    assert got == ref_batch.encode_batch(items, 44100, 16, stereo_mode=1, xp=np, zero_run_enabled=False)


@pytest.mark.parametrize("workers", [1, 8])
def test_decode_batch_matches_serial_and_lac_tpu(batch_items, workers):
    frames = _ref_numpy(batch_items, 44100, 16, 2)
    got = batch.decode_batch(frames, max_workers=workers)
    want = ref_batch.decode_batch(frames, max_workers=workers)
    for (gl, gr, gh), (wl, wr, wh), (l, r) in zip(got, want, batch_items):
        assert np.array_equal(gl, wl) and np.array_equal(gr, wr) and np.array_equal(gl, l)
        assert np.array_equal(gr, r if r is not None else np.empty(0, np.int32))
        assert vars(gh) == vars(wh)
    assert batch.decode_batch([]) == []


# ------------------------------------------------------------ the CLI's injection hook


def test_injection_encodes_without_reading_the_wav_again(tmp_path, capsys, monkeypatch):
    left, right = _mix(9 * B + 321, 90)
    wav, out = str(tmp_path / "in.wav"), str(tmp_path / "out.lac")
    assert write_wav(wav, left, right, 2, 44100, 16)
    argv = ["encode", wav, out]
    assert cli.main(argv, device="cpu") == 0
    want_msg = capsys.readouterr().out
    with open(out, "rb") as f:
        want = f.read()
    enc = FrameEncoder(12, 2, 44100, 16, device="cpu")
    planes = device_pipeline.encode_full_blocks(enc, left, right, 9, "auto", enc.device)

    def boom(*a, **k):
        raise AssertionError("the injected encode touched the input or planned the full blocks again")

    monkeypatch.setattr(port_io, "read_wav", boom)
    monkeypatch.setattr(device_pipeline, "encode_full_blocks", boom)
    cli._set_encode_injection(wav, (left, right, 2, 44100, 16), planes)
    assert cli.main(argv, device="cpu") == 0
    assert capsys.readouterr().out == want_msg
    with open(out, "rb") as f:
        assert f.read() == want
    # consumed: the next encode of the same path reads the file again
    assert cli.main(argv, device="cpu") == 1 and "touched the input" in capsys.readouterr().err


def test_injection_is_per_path_and_per_thread():
    cli._set_encode_injection("a.wav", ("wav",), ("planes",))
    seen = []
    t = threading.Thread(target=lambda: seen.append(cli._pop_encode_injection("a.wav")))
    t.start()
    t.join(timeout=30)
    assert seen == [None]  # another thread's hand-over is not this thread's
    assert cli._pop_encode_injection("b.wav") is None  # another path leaves it in place
    assert cli._pop_encode_injection("a.wav") == ("a.wav", ("wav",), ("planes",))
    assert cli._pop_encode_injection("a.wav") is None


def test_injection_without_planes_plans_the_file_anew(tmp_path, monkeypatch):
    left, right = _mix(B + 9, 91)
    wav, out = str(tmp_path / "in.wav"), str(tmp_path / "out.lac")
    monkeypatch.setattr(port_io, "read_wav", lambda p: pytest.fail("read the WAV"))
    cli._set_encode_injection(wav, (left, right, 2, 44100, 16), None)
    assert cli.main(["encode", wav, out], device="cpu") == 0
    with open(out, "rb") as f:
        assert f.read() == FrameEncoder(12, 2, 44100, 16, device="cpu").encode(left, right)


# ------------------------------------------------------------ the card by default; exact counts from threads


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs (chip_smoke.py covers it)")


@pytest.mark.parametrize("call", ["encode_pooled", "encode_batch", "encode_pooled-empty", "encode_batch-empty",
                                  "run_group_wave"])
def test_batch_entry_points_default_to_the_card(no_card, call):
    items = [] if call.endswith("-empty") else [_mix(B + 1, 95)]
    with pytest.raises(RuntimeError, match="cuda"):
        if call.startswith("encode_pooled"):
            pool.encode_pooled(items, 44100, 16)
        elif call.startswith("encode_batch"):
            batch.encode_batch(items, 44100, 16)
        else:
            group = _prepared(items)
            group[0].opts = {"partitioning": True, "thread_count": 0}
            pool.run_group_wave(group, lambda i, planes: None)


def test_launch_counts_are_exact_from_many_threads():
    """``encode_batch`` launches kernels from several threads: a lost update would undercount."""
    before = dict(cuda_kernels.launches)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                cuda_kernels._count("cumsum_u32")
                cuda_kernels._count("k_cost_sums")

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert cuda_kernels.launches["cumsum_u32"] - before["cumsum_u32"] == 32000
        assert cuda_kernels.launches["k_cost_sums"] - before["k_cost_sums"] == 32000
    finally:
        sys.setswitchinterval(interval)
        for name, n in before.items():
            cuda_kernels.launches[name] = n
