"""The port's group route (``lac_tpu_torch.encoder``: ``_GroupJob``,
``ChannelBlockEncoder(device=)``, ``plan_group(emit_fields=True)``,
``_emit``, the LPC ladder replan and the cold route) on the CPU.

Every comparison is exact, against ``lac_tpu``: its
``ChannelBlockEncoder`` under ``xp=jax.numpy`` (its own ``_GroupJob`` on
the CPU backend) and ``xp=numpy`` (the native planner and replay, its
own ladder), its numpy ``plan_group(emit_fields=True)``, and its
``FrameEncoder``. Lanes outside the 24-bit domain walk the order ladder;
the reference's own block encoder (``.refbuild``) is not needed: the
JAX package's ladder is held to it by tests/test_ladder.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lac_tpu import encoder as ref_encoder  # noqa: E402
from lac_tpu_torch import cli, device_pipeline, encoder  # noqa: E402
from lac_tpu_torch.encoder import ChannelBlockEncoder, FrameEncoder  # noqa: E402
from lac_tpu_torch.ops.lpc import autocorrelation  # noqa: E402
from lac_tpu_torch.parallel import make_mesh, mesh as mesh_mod, plan_group_sharded  # noqa: E402

N = 16384


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lanes(B, n, seed):
    """Noise, silence, sparse bursts, 24-bit noise, a random walk and
    small values with rare outliers: every token class occurs
    (rice, bin direct, zero-run, escape, silent)."""
    rng = np.random.RandomState(seed)
    kinds = [
        rng.randint(-3000, 3000, n),
        np.zeros(n, np.int64),
        np.where(rng.rand(n) < 0.03, rng.randint(-200000, 200000, n), 0),
        rng.randint(-(1 << 23), 1 << 23, n),
        np.clip(np.cumsum(rng.randint(-3, 4, n)), -(1 << 15), 1 << 15),
        rng.choice([0, 0, 0, 1, -1, 2, -2, 5000], n),
    ]
    return np.stack([kinds[(i + seed) % len(kinds)] for i in range(B)]).astype(np.int32)


def _glitched_sine(seed, n=2048):
    """tests/test_ladder.py's lane: a big sine with one full-scale glitch,
    whose open-loop LPC residual leaves int32 at high orders."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    f = rng.uniform(0.002, 0.3)
    x = np.sin(2 * np.pi * f * t + rng.uniform(0, 6)) * rng.uniform(1.5e9, 2.1e9)
    x += rng.standard_normal(n) * rng.uniform(1e3, 1e6)
    pcm = np.clip(x, -2**31, 2**31 - 1).astype(np.int64).astype(np.int32)
    j = rng.randint(100, n - 20)
    pcm[j] = np.int32(rng.choice([-2**31, 2**31 - 1]))
    return pcm


def _full_overflow_lane():
    """tests/test_ladder.py::test_full_overflow_drops_lpc_candidate's lane:
    every ladder order overflows, so the LPC candidates are dropped."""
    a = 1_600_000_000
    pcm = np.full(2048, a, np.int32)
    pcm[1::2] = a - 1000
    pcm[-7:] = -a
    return pcm


def _out_of_domain_16384():
    """tests/test_ladder.py::test_out_of_domain_jax_group_matches_numpy's
    lane: filtered noise at 1.9e9, a hot length outside the 24-bit domain."""
    rng = np.random.RandomState(99)
    x = rng.standard_normal(N)
    for _ in range(3):
        x = 0.7 * x + 0.3 * np.concatenate([[0.0], x[:-1]])
    return np.clip(x * 1.9e9, -2**31, 2**31 - 1).astype(np.int64).astype(np.int32)


# ------------------------------------------------------------------ _GroupJob


@pytest.mark.parametrize("B,n", [(3, N), (24, 256), (5, 1000)])
@pytest.mark.parametrize("zero_run,partitioning", [(True, True), (False, False)])
def test_group_route_matches_lac_tpu(B, n, zero_run, partitioning):
    """Hot shapes plan on the (CPU) device, a length that is not hot takes
    the host route; both against lac_tpu under jax.numpy and numpy."""
    pcm = _lanes(B, n, seed=n + B)
    want = ref_encoder.ChannelBlockEncoder(zero_run, partitioning, xp=np).encode_group(pcm)
    assert ref_encoder.ChannelBlockEncoder(zero_run, partitioning, xp=jnp).encode_group(pcm) == want
    enc = ChannelBlockEncoder(zero_run, partitioning, device="cpu")
    jobs = enc.make_jobs(pcm)
    assert [j.on_device for j in jobs] == [n in (N, 256)] * len(jobs)
    assert enc.encode_group(pcm) == want
    assert ChannelBlockEncoder(zero_run, partitioning).encode_group(pcm) == want


def test_batch_caps_and_padding(monkeypatch):
    """The device caps are the JAX package's (128 lanes at 16384, 1024 at
    256); rows pad to a power of two, then to a multiple of the mesh (the
    JAX package's padding, so that few plan shapes exist)."""
    enc = ChannelBlockEncoder(device="cpu")
    assert enc._batch_cap(N) == 128 and enc._batch_cap(256) == 1024 and enc._batch_cap(4096) == 512
    assert ChannelBlockEncoder()._batch_cap(N) == ChannelBlockEncoder.GROUP_LANES
    pcm = _lanes(5, 256, seed=1)
    job = ChannelBlockEncoder(device="cpu", mesh=make_mesh(["cpu"] * 2)).make_jobs(pcm)[0]
    job.dispatch_autocorr()
    assert job.Bp == 8
    job = ChannelBlockEncoder(device="cpu").make_jobs(pcm)[0]
    job.dispatch_autocorr()
    assert job.Bp == 8


def test_group_route_on_a_mesh_matches_one_device():
    pcm = _lanes(5, 256, seed=4)
    want = ChannelBlockEncoder(device="cpu").encode_group(pcm)
    assert ChannelBlockEncoder(device="cpu", mesh=make_mesh(["cpu"] * 2)).encode_group(pcm) == want


# ------------------------------------------------------------------ ship fields


@pytest.mark.parametrize("n", [256, 1000, 4096])
@pytest.mark.parametrize("zero_run,partitioning", [(True, True), (True, False), (False, True)])
def test_plan_group_ship_and_meta_match_lac_tpu(n, zero_run, partitioning):
    pcm = _lanes(6, n, seed=n)
    R = autocorrelation(torch.from_numpy(pcm), 12).numpy()
    coeffs, used, lvalid, mvo = encoder.lpc_candidates_from_lags(R, n)
    want = ref_encoder.plan_group(pcm, coeffs, lvalid, n, zero_run, partitioning, np, emit_fields=True)
    meta, ship = encoder.plan_group(torch.from_numpy(pcm), torch.from_numpy(coeffs), torch.from_numpy(lvalid),
                                    n, zero_run, partitioning, emit_fields=True)
    assert ship.dtype == torch.uint8 and ship.shape == (6, 6 * n)
    assert np.array_equal(meta.numpy(), want["meta"])
    assert np.array_equal(ship.numpy(), want["ship"])
    assert torch.equal(meta, encoder.plan_group(torch.from_numpy(pcm), torch.from_numpy(coeffs),
                                                torch.from_numpy(lvalid), n, zero_run, partitioning))
    classes = set(np.unique(ship.numpy().reshape(6, n, 6)[..., 4] & 7).tolist())
    if zero_run:
        expected = {encoder.CLS_RICE, encoder.CLS_RUN, encoder.CLS_ESCAPE, encoder.CLS_SILENT}
    else:
        expected = {encoder.CLS_RICE, encoder.CLS_HEAD_ONLY}
    assert expected <= classes, classes


@pytest.mark.parametrize("n", [256, 4096])
def test_emit_matches_native_replay(n):
    """The token packer writes the native plan replay's bytes."""
    pcm = _lanes(6, n, seed=7 * n)
    enc = ChannelBlockEncoder()
    coeffs, used, lvalid, mvo = enc.lpc_analysis(pcm, n)
    meta, ship = encoder._plan_on_host(pcm, coeffs, lvalid, n, enc, emit_fields=True)
    replay = encoder.replay_payloads(pcm, meta, coeffs, used, mvo, n, True, 0)
    assert enc._emit(ship, meta, coeffs, used, mvo, 6, n) == replay


def test_emit_refuses_an_overflow_lane():
    pcm = _full_overflow_lane()[None]
    enc = ChannelBlockEncoder()
    coeffs, used, lvalid, mvo = enc.lpc_analysis(pcm, pcm.shape[1])
    meta, ship = encoder._plan_on_host(pcm, coeffs, lvalid, pcm.shape[1], enc, emit_fields=True)
    assert meta[0, 2] == 0
    with pytest.raises(ValueError, match="ladder"):
        enc._emit(ship, meta, coeffs, used, mvo, 1, pcm.shape[1])


# ------------------------------------------------------------------ the ladder


def test_full_overflow_lane_takes_the_ladder():
    """The port raised ``AssertionError: an LPC residual left int32`` here;
    lac_tpu writes 6,271 bytes."""
    pcm = _full_overflow_lane()[None]
    want = ref_encoder.ChannelBlockEncoder().encode_group(pcm)
    assert len(want[0]) == 6271
    assert ChannelBlockEncoder().encode_group(pcm) == want
    assert ChannelBlockEncoder(device="cpu").encode_group(pcm) == want


@pytest.mark.parametrize("seed", [10, 17, 27, 36, 133, 141])
def test_glitched_sines_walk_the_ladder(seed):
    pcm = _glitched_sine(seed)[None]
    assert ChannelBlockEncoder().encode_group(pcm) == ref_encoder.ChannelBlockEncoder().encode_group(pcm)


def test_the_ladder_lands_below_the_analysis_order():
    """Seeds whose ladder stops at an order below the analysis order, so
    truncated coefficient sets are planned and emitted."""
    from lac_tpu_torch.ops import predictors

    enc, walked = ChannelBlockEncoder(), 0
    for seed in (10, 17, 27, 36, 133, 141):
        pcm = _glitched_sine(seed)
        coeffs, used, lvalid, _ = enc.lpc_analysis(pcm[None], len(pcm))
        for li, cand in enumerate((4, 6, 8, 10, 12)):
            if lvalid[li, 0]:
                walked += predictors.lpc_ladder_order(pcm, coeffs[li, 0], used[li, 0], cand) != used[li, 0]
    assert walked > 0


@pytest.mark.parametrize("device", [None, "cpu"])
def test_mixed_group_splices_ladder_lanes(device):
    rng = np.random.RandomState(3)
    normal = rng.randint(-20000, 20000, (3, 2048)).astype(np.int32)
    group = np.stack([normal[0], _glitched_sine(27), normal[1], normal[2]])
    assert ChannelBlockEncoder(device=device).encode_group(group) == ref_encoder.ChannelBlockEncoder().encode_group(group)


def test_out_of_domain_hot_lane_matches_lac_tpu():
    """A 16384-sample lane past the 24-bit domain on the (CPU) device:
    int32 upload, exact int64 lags, then the ladder if it overflows."""
    pcm = _out_of_domain_16384()
    rng = np.random.RandomState(8)
    group = np.stack([pcm, rng.randint(-3000, 3000, N).astype(np.int32), _glitched_sine(10, N)])
    want = ref_encoder.ChannelBlockEncoder().encode_group(group)
    assert ref_encoder.ChannelBlockEncoder(xp=jnp).encode_group(group) == want
    assert ChannelBlockEncoder(device="cpu").encode_group(group) == want


# ------------------------------------------------------------------ cold route


def test_cold_route_decision_matrix(monkeypatch):
    monkeypatch.setattr(device_pipeline, "_PROC_WARM", False)
    monkeypatch.delenv("LAC_TPU_COLD_BLOCKS", raising=False)
    monkeypatch.delenv("LAC_TPU_NO_NATIVE", raising=False)
    assert encoder.COLD_BLOCKS == 1024
    assert encoder._cold_route(10) and encoder._cold_route(1024)
    assert not encoder._cold_route(1025)  # above the default threshold
    monkeypatch.setenv("LAC_TPU_COLD_BLOCKS", "2000")
    assert encoder._cold_route(1025)
    monkeypatch.setenv("LAC_TPU_COLD_BLOCKS", "256")
    assert encoder._cold_route(256) and not encoder._cold_route(257)
    monkeypatch.setenv("LAC_TPU_COLD_BLOCKS", "0")
    assert not encoder._cold_route(10)
    monkeypatch.setenv("LAC_TPU_COLD_BLOCKS", "junk")
    assert encoder._cold_route(1024) and not encoder._cold_route(1025)
    monkeypatch.delenv("LAC_TPU_COLD_BLOCKS")
    monkeypatch.setattr(device_pipeline, "_PROC_WARM", True)  # a warm process never routes
    assert not encoder._cold_route(10)
    monkeypatch.setattr(device_pipeline, "_PROC_WARM", False)
    monkeypatch.setenv("LAC_TPU_NO_NATIVE", "1")  # no native planner: never routes
    assert not encoder._cold_route(10)


def _stereo(frames, seed):
    rng = np.random.RandomState(seed)
    left = (np.sin(np.arange(frames) / 11.0) * 9000 + rng.randint(-300, 300, frames)).astype(np.int32)
    right = (np.roll(left, 3) // 2 + rng.randint(-500, 500, frames)).astype(np.int32)
    return left, right


def test_cold_routed_encode_takes_the_host_route(monkeypatch):
    """An encoder on a card in a cold process plans an input of 8 full
    blocks (one the plane pipeline takes) on the host and never resolves
    its device (no CUDA context); the bytes are the host route's. The
    encoder stands on the CPU with a card's device name, so a device route
    would fail here, as it does once the process is warm (as the service's
    warm-up marks it)."""
    monkeypatch.setattr(device_pipeline, "_PROC_WARM", False)
    monkeypatch.delenv("LAC_TPU_COLD_BLOCKS", raising=False)
    left, right = _stereo(8 * N + 777, seed=3)
    enc = FrameEncoder(12, 2, 44100, 16, device="cpu")
    host = enc.encode_frame(left, right)
    enc._device = torch.device("cuda")
    assert enc.encode(left, right) == host
    assert not device_pipeline.process_warm()
    assert enc._device == torch.device("cuda")  # never resolved
    device_pipeline.mark_warm()
    with pytest.raises((RuntimeError, AssertionError)):
        enc.encode(left, right)


@pytest.mark.parametrize("cold_blocks,reaches_card", [(25, False), (12, True)])
def test_streaming_takes_the_cold_route_for_the_whole_file(tmp_path, monkeypatch, cold_blocks, reaches_card):
    """The streaming route decides the cold route once, by the whole
    file's blocks: a 20-block file in 10-block chunks stays on the host
    under a threshold of 25 blocks and goes to the card under one of 12,
    though each chunk is under it. The encoder stands on the CPU with a
    card's device name, so reaching the card fails here."""
    from lac_tpu_torch import stream
    from lac_tpu_torch.io import write_wav

    monkeypatch.setattr(device_pipeline, "_PROC_WARM", False)
    monkeypatch.setenv("LAC_TPU_COLD_BLOCKS", str(cold_blocks))
    left, right = _stereo(19 * N + 500, seed=5)
    wav, lac = str(tmp_path / "in.wav"), str(tmp_path / "out.lac")
    assert write_wav(wav, left, right, 2, 44100, 16)
    enc = FrameEncoder(12, 2, 44100, 16, device="cpu")
    want = enc.encode_frame(left, right)
    enc._device = torch.device("cuda")
    if reaches_card:
        with pytest.raises((RuntimeError, AssertionError)):
            stream.encode_wav_to_lac(wav, lac, chunk_blocks=10, encoder=enc)
        assert device_pipeline.process_warm()
    else:
        assert stream.encode_wav_to_lac(wav, lac, chunk_blocks=10, encoder=enc) == len(want)
        with open(lac, "rb") as f:
            assert f.read() == want
        assert not device_pipeline.process_warm() and enc._device == torch.device("cuda")


def test_a_cpu_encoder_never_routes(monkeypatch):
    calls = []
    monkeypatch.setattr(encoder, "_cold_route", lambda nblocks: calls.append(nblocks) or True)
    left, right = _stereo(N + 5, seed=4)
    FrameEncoder(12, 2, 44100, 16, device="cpu").encode(left, right)
    assert calls == []


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the behaviour without a card")
def test_a_card_encoder_without_a_card_raises_at_construction():
    with pytest.raises(RuntimeError, match="cuda"):
        FrameEncoder(12, 2, 44100, 16, device="cuda")


# ------------------------------------------------------------------ FrameEncoder


def _encode_recording_routes(monkeypatch, left, right):
    """FrameEncoder(device="cpu").encode, and whether each job of its group
    route was planned on the device."""
    on_device = []
    make_jobs = ChannelBlockEncoder.make_jobs

    def recording(enc, pcm):
        jobs = make_jobs(enc, pcm)
        on_device.extend(j.on_device for j in jobs)
        return jobs

    monkeypatch.setattr(ChannelBlockEncoder, "make_jobs", recording)
    return FrameEncoder(12, 2, 44100, 16, device="cpu").encode(left, right), on_device


_SHORT = pytest.mark.parametrize("frames", [7 * N + 1234, 2 * N + 5000, 9000],
                                 ids=["7-full-blocks", "3-blocks", "no-full-block"])


@_SHORT
def test_frame_encoder_short_inputs_match_lac_tpu(monkeypatch, frames):
    """Inputs under the plane pipeline's 8 full blocks in a warm process:
    with the native runtime every lane takes the host route, and the
    encoder's device plans none."""
    monkeypatch.setattr(device_pipeline, "_PROC_WARM", True)
    left, right = _stereo(frames, seed=frames % 97)
    want = ref_encoder.FrameEncoder(12, 2, 44100, 16, xp=np).encode(left, right)
    if frames < 7 * N:
        assert ref_encoder.FrameEncoder(12, 2, 44100, 16, xp=jnp).encode(left, right) == want
    got, on_device = _encode_recording_routes(monkeypatch, left, right)
    assert got == want and not any(on_device)


@_SHORT
def test_frame_encoder_short_inputs_without_native_match_lac_tpu(monkeypatch, frames):
    """The same inputs under LAC_TPU_NO_NATIVE=1 go through the group route:
    full-block lanes, probe and speculative lanes on the (CPU) device, the
    tail on the host, every payload from the token packer."""
    monkeypatch.setattr(device_pipeline, "_PROC_WARM", True)
    left, right = _stereo(frames, seed=frames % 97)
    want = ref_encoder.FrameEncoder(12, 2, 44100, 16, xp=np).encode(left, right)
    monkeypatch.setenv("LAC_TPU_NO_NATIVE", "1")
    got, on_device = _encode_recording_routes(monkeypatch, left, right)
    assert got == want and any(on_device) == (frames >= N)


@pytest.mark.parametrize("mode", [0, 1])
def test_frame_encoder_forced_modes_and_mono(mode):
    left, right = _stereo(3 * N + 11, seed=9 + mode)
    want = ref_encoder.FrameEncoder(12, mode, 44100, 16, xp=np).encode(left, right)
    assert FrameEncoder(12, mode, 44100, 16, device="cpu").encode(left, right) == want
    want = ref_encoder.FrameEncoder(12, 0, 44100, 16, xp=np).encode(left)
    assert FrameEncoder(12, 0, 44100, 16, device="cpu").encode(left) == want


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("n", [256, 1000])
def test_plan_group_sharded_emit_fields(n):
    pcm = _lanes(4, n, seed=n + 1)
    R = autocorrelation(torch.from_numpy(pcm), 12).numpy()
    coeffs, _, lvalid, _ = encoder.lpc_candidates_from_lags(R, n)
    meta, ship = encoder.plan_group(torch.from_numpy(pcm), torch.from_numpy(coeffs), torch.from_numpy(lvalid), n,
                                    True, True, emit_fields=True)
    got = plan_group_sharded(make_mesh(["cpu"] * 2), pcm, coeffs, lvalid, n, emit_fields=True)
    assert np.array_equal(got["meta"], meta.numpy()) and np.array_equal(got["ship"], ship.numpy())
    shipv = ship.numpy().reshape(4, n, 6)
    payload = shipv[..., :4].copy().view("<u4")[..., 0].astype(np.int64)
    k = shipv[..., 5].astype(np.int64)
    rice_like = (shipv[..., 4] & 7) == 0
    assert got["total_token_bits"] == int(np.where(rice_like, (payload >> k) + k + 1, 2).sum())
    assert plan_group_sharded(make_mesh(["cpu"] * 2), pcm, coeffs, lvalid, n)["total_token_bits"] == 4


# ------------------------------------------------------------------ the CLI's cards


def _four_cards(monkeypatch, warm=True):
    """Four visible cards (a patched device count; ``default_mesh`` counts
    them afresh and starts no context)."""
    monkeypatch.setattr(device_pipeline, "_PROC_WARM", warm)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(mesh_mod, "_DEFAULT_MESH_CACHE", [])


@pytest.mark.parametrize("frames,streaming", [(8 * N, False), (1000 * N, False), (2100 * N + 4321, True)])
@pytest.mark.parametrize("env", [None, "0", "mesh off"])
def test_one_shot_cli_takes_one_card(monkeypatch, frames, streaming, env):
    """Four visible cards: a one-shot encode runs on one card unless
    LAC_TPU_CLI_MESH=1 asks for the mesh, and LAC_TPU_MESH=0 (one card for
    the pool and the service) overrides that too."""
    _four_cards(monkeypatch)
    monkeypatch.delenv("LAC_TPU_MESH", raising=False)
    if env is None:
        monkeypatch.delenv("LAC_TPU_CLI_MESH", raising=False)
    elif env == "mesh off":
        monkeypatch.setenv("LAC_TPU_CLI_MESH", "1")
        monkeypatch.setenv("LAC_TPU_MESH", "0")
    else:
        monkeypatch.setenv("LAC_TPU_CLI_MESH", env)
    assert cli._one_shot_mesh(frames, streaming) is None


@pytest.mark.parametrize("frames,streaming,cards", [
    (8 * N, False, 1),  # one 64-wide chunk
    (60 * N, False, 1),
    (100 * N, False, 2),  # two 64-wide chunks
    (300 * N + 7, False, 2),  # two 256-wide chunks
    (600 * N, False, 3),
    (1000 * N, False, 4),
    (2100 * N + 4321, True, 2),  # a 512-block stream chunk: two 256-wide chunks
])
def test_one_shot_cli_mesh_takes_no_more_cards_than_chunks(monkeypatch, frames, streaming, cards):
    _four_cards(monkeypatch)
    monkeypatch.delenv("LAC_TPU_MESH", raising=False)
    monkeypatch.setenv("LAC_TPU_CLI_MESH", "1")
    got = cli._one_shot_mesh(frames, streaming)
    assert (len(got) if got is not None else 1) == cards
    if got is not None:
        assert got == tuple(torch.device("cuda", i) for i in range(cards))


def test_one_shot_cli_mesh_cold_and_one_card(monkeypatch):
    _four_cards(monkeypatch, warm=False)
    monkeypatch.delenv("LAC_TPU_MESH", raising=False)
    monkeypatch.setenv("LAC_TPU_CLI_MESH", "1")
    monkeypatch.delenv("LAC_TPU_COLD_BLOCKS", raising=False)
    assert cli._one_shot_mesh(1000 * N, False) is None  # the cold route keeps it on the host
    assert cli._one_shot_mesh(1100 * N, False) is not None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)  # one visible card
    monkeypatch.setattr(mesh_mod, "_DEFAULT_MESH_CACHE", [])
    assert cli._one_shot_mesh(1100 * N, False) is None
