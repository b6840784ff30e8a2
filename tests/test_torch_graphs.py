"""The port's captured plans (``lac_tpu_torch.plan_graphs``) on the CPU.

A CUDA graph runs only on the card, where ``chip_smoke.py`` phase 15
holds every captured shape bit-exact against eager ``plan_group``. Here:

* ``planned`` on CPU tensors against ``lac_tpu``'s ``_jitted_plan``
  called the way ``lac_tpu/device_pipeline.py:786-800`` calls it: a
  ragged batch padded to ``bp`` (the pad rows gather row 0 there, their
  candidates zero), ``meta[:nsub]`` exact, and ``ship`` with
  ``emit_fields``;
* the static-buffer fill: a batch's rows in, the rows that a fuller
  earlier batch left behind zeroed;
* the graph cache with a stand-in for the capture that runs on the CPU:
  its keys, its bound, the copy-out, the replay accounting, and a failed
  capture that raises and caches nothing;
* the padded shapes that the plane pipeline, the group route and the
  warm-up ask for.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu import encoder as ref_enc  # noqa: E402
from lac_tpu.ops import lpc as ref_lpc  # noqa: E402
from lac_tpu_torch import device_pipeline, encoder, plan_graphs, serve  # noqa: E402
from lac_tpu_torch.encoder import ChannelBlockEncoder, FrameEncoder, plan_group, plan_inputs_to_torch  # noqa: E402
from lac_tpu_torch.ops import cuda_kernels  # noqa: E402
from lac_tpu_torch.profile_encode import gliding_stereo  # noqa: E402

N = 16384
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """plan_group's CPU operators beside the suite's other workers: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planes(rows, n, seed):
    """Noise, a tone, sparse bursts, silence, 24-bit extremes and a quiet
    noisy tone: every branch of the planner."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    kinds = [
        rng.randint(-30000, 30000, n),
        (np.sin(t / 9.0) * 20000).astype(np.int64),
        np.where(rng.rand(n) < 0.03, rng.randint(-3, 4, n), 0),
        np.zeros(n, np.int64),
        np.where(t % 2, (1 << 23) - 1, -(1 << 23)),
        (np.sin(t / 40.0) * 300 + rng.randint(-4, 5, n)).astype(np.int64),
    ]
    return np.stack([kinds[(i + seed) % len(kinds)] for i in range(rows)]).astype(np.int32)


def _batch(n, nsub, seed):
    """A plane matrix, the rows of one batch gathered from it (out of
    order), and their candidates from the host Levinson-Durbin."""
    rng = np.random.RandomState(seed)
    src = _planes(nsub + 3, n, seed)
    sub = rng.permutation(len(src))[:nsub].astype(np.int32)
    coeffs, _, lvalid, _ = ref_enc.lpc_candidates_from_lags(ref_lpc.autocorrelation(src[sub], 12), n)
    return src, sub, coeffs, lvalid


def _lac_tpu_padded(src, sub, coeffs, lvalid, n, bp, zero_run, partitioning, emit_fields):
    """lac_tpu/device_pipeline.py:786-800: the rows padded with row 0, the
    candidates with zeros, then the jitted plan of the ``bp`` lanes."""
    nsub = len(sub)
    rows = np.concatenate([sub, np.zeros(bp - nsub, np.int32)])
    cpad = np.zeros((coeffs.shape[0], bp, 13), np.int16)
    cpad[:, :nsub] = coeffs
    vpad = np.zeros((lvalid.shape[0], bp), bool)
    vpad[:, :nsub] = lvalid
    out = ref_enc._jitted_plan(n, zero_run, partitioning, emit_fields)(src[rows], cpad, vpad)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("n,nsub,bp,zero_run,partitioning", [
    (256, 17, 24, True, True),
    (256, 17, 24, False, True),
    (256, 17, 24, True, False),
    (N, 3, 4, True, True),
])
def test_planned_equals_lac_tpu_padded_batch(n, nsub, bp, zero_run, partitioning):
    src, sub, coeffs, lvalid = _batch(n, nsub, seed=n + nsub)
    want = _lac_tpu_padded(src, sub, coeffs, lvalid, n, bp, zero_run, partitioning, False)["meta"]
    ct, vt = plan_inputs_to_torch(coeffs, lvalid, CPU)
    before = dict(plan_graphs.stats)
    meta = plan_graphs.planned(torch.from_numpy(src[sub]), ct, vt, n, zero_run, partitioning, rows=bp)
    assert plan_graphs.stats == before, "CPU tensors run plan_group itself: no graph, no replay"
    assert meta.shape == (nsub, want.shape[1])
    np.testing.assert_array_equal(meta.numpy(), want[:nsub])


@pytest.mark.parametrize("n,nsub,bp", [(256, 5, 8), (N, 2, 4)])
def test_planned_emit_fields_equals_lac_tpu_padded_batch(n, nsub, bp):
    src, sub, coeffs, lvalid = _batch(n, nsub, seed=7 * nsub)
    want = _lac_tpu_padded(src, sub, coeffs, lvalid, n, bp, True, True, True)
    ct, vt = plan_inputs_to_torch(coeffs, lvalid, CPU)
    meta, ship = plan_graphs.planned(torch.from_numpy(src[sub]), ct, vt, n, True, True, emit_fields=True, rows=bp)
    np.testing.assert_array_equal(meta.numpy(), want["meta"][:nsub])
    np.testing.assert_array_equal(ship.numpy(), want["ship"][:nsub])


# ------------------------------------------------------------------ the fill


def _inputs(rows, n, seed, dtype=np.int32):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(-30000, 30000, (rows, n)).astype(dtype)),
            torch.from_numpy(rng.randint(-(1 << 15), 1 << 15, (5, rows, 13)).astype(np.int16)),
            torch.ones((5, rows), dtype=torch.bool))


def test_static_buffers_start_zero():
    st = plan_graphs.Static(8, 16, CPU)
    assert st.pcm.dtype == torch.int32 and st.coeffs.dtype == torch.int16 and st.valid.dtype == torch.bool
    assert st.pcm.shape == (8, 16) and st.coeffs.shape == (5, 8, 13) and st.valid.shape == (5, 8)
    assert not st.pcm.any() and not st.coeffs.any() and not st.valid.any() and st.filled == 0


def test_fill_zeroes_the_rows_a_fuller_batch_left():
    st = plan_graphs.Static(8, 16, CPU)
    full = _inputs(8, 16, 1)
    st.fill(*full)
    for got, want in zip((st.pcm, st.coeffs, st.valid), full):
        assert torch.equal(got, want)
    ragged = _inputs(3, 16, 2)
    st.fill(*ragged)
    assert torch.equal(st.pcm[:3], ragged[0]) and not st.pcm[3:].any()
    assert torch.equal(st.coeffs[:, :3], ragged[1]) and not st.coeffs[:, 3:].any()
    assert torch.equal(st.valid[:, :3], ragged[2]) and not st.valid[:, 3:].any()
    more = _inputs(5, 16, 3)
    st.fill(*more)
    assert torch.equal(st.pcm[:5], more[0]) and not st.pcm[5:].any() and st.filled == 5
    assert torch.equal(st.valid[:, :5], more[2]) and not st.valid[:, 5:].any()


def test_fill_widens_int16_pcm():
    st = plan_graphs.Static(4, 16, CPU)
    pcm, coeffs, valid = _inputs(4, 16, 4, dtype=np.int16)
    st.fill(pcm, coeffs, valid)
    assert st.pcm.dtype == torch.int32 and torch.equal(st.pcm, pcm.to(torch.int32))


# ------------------------------------------------------------------ the cache

LAUNCHES = {"k_cost_sums": 2, "prefix_max_i32": 1, "suffix_min_i32": 1}


def _stand_in(log, fail=False):
    """A capture that runs on the CPU: ``replay`` reruns plan_group on the
    static buffers into the captured outputs, as a graph would."""

    def capture(static, n, zero_run, partitioning, emit_fields):
        log.append((static.pcm.shape[0], n, zero_run, partitioning, emit_fields))
        if fail:
            raise RuntimeError("capture failed")

        def run():
            out = plan_group(static.pcm, static.coeffs, static.valid, n, zero_run, partitioning,
                             emit_fields=emit_fields)
            return out if emit_fields else (out,)

        out = run()

        def replay():
            for o, fresh in zip(out, run()):
                o.copy_(fresh)

        return plan_graphs.Captured(replay, out, LAUNCHES)

    return capture


def _probe_batch(nsub, seed):
    src, sub, coeffs, lvalid = _batch(256, nsub, seed)
    ct, vt = plan_inputs_to_torch(coeffs, lvalid, CPU)
    return torch.from_numpy(src[sub]), ct, vt


def test_one_capture_per_key_then_replays():
    log = []
    cache = plan_graphs.GraphCache(_stand_in(log))
    for nsub, seed in ((24, 1), (9, 2), (24, 3)):
        pcm, ct, vt = _probe_batch(nsub, seed)
        got = cache.plan(pcm, ct, vt, 256, True, True, rows=24)
        assert torch.equal(got, plan_group(pcm, ct, vt, 256, True, True))
    assert log == [(24, 256, True, True, False)]
    assert list(cache.entries) == [(None, 24, 256, True, True, False)]
    assert cache.stats["captures"] == 1 and cache.stats["replays"] == 3


def test_keys_tell_shapes_and_flags_apart():
    log = []
    cache = plan_graphs.GraphCache(_stand_in(log))
    pcm, ct, vt = _probe_batch(6, 4)
    calls = [(8, True, True, False), (16, True, True, False), (8, False, True, False), (8, True, False, False),
             (8, True, True, True), (8, True, True, False)]
    for rows, zr, part, emit in calls:
        cache.plan(pcm, ct, vt, 256, zr, part, emit_fields=emit, rows=rows)
    assert list(cache.entries) == [(None, rows, 256, zr, part, emit) for rows, zr, part, emit in calls[1:5]] + [
        (None, 8, 256, True, True, False)]
    assert cache.stats["captures"] == 5 and cache.stats["replays"] == 6


def test_the_cache_is_bounded_least_recently_replayed_first():
    log = []
    cache = plan_graphs.GraphCache(_stand_in(log), maxsize=2)
    pcm, ct, vt = _probe_batch(4, 5)
    for rows in (4, 8, 4, 16, 8):
        cache.plan(pcm, ct, vt, 256, True, True, rows=rows)
    # 4 captured, 8 captured, 4 replayed (8 is now the oldest), 16 evicts 8, 8 captured again evicts 4
    assert [r for r, *_ in log] == [4, 8, 16, 8]
    assert [k[1] for k in cache.entries] == [16, 8]
    assert plan_graphs.MAX_GRAPHS == 64 and plan_graphs.GraphCache(_stand_in([])).maxsize == 64


def test_results_outlive_the_next_replay():
    """The batch's rows are copied out: a caller holds its result across
    the next replay of the same graph."""
    cache = plan_graphs.GraphCache(_stand_in([]))
    first = _probe_batch(12, 6)
    got1 = cache.plan(*first, 256, True, True, emit_fields=True, rows=16)
    keep = [t.clone() for t in got1]
    second = _probe_batch(16, 7)
    got2 = cache.plan(*second, 256, True, True, emit_fields=True, rows=16)
    for held, kept, static in zip(got1, keep, cache.entries[(None, 16, 256, True, True, True)][1].out):
        assert torch.equal(held, kept) and held.data_ptr() != static.data_ptr()
    want = plan_group(*second, 256, True, True, emit_fields=True)
    assert all(torch.equal(g, w) for g, w in zip(got2, want))
    assert got1[0].shape[0] == 12 and got2[1].shape == (16, 6 * 256)


def test_replays_count_the_launches_taken_down_at_capture():
    cache = plan_graphs.GraphCache(_stand_in([]))
    pcm, ct, vt = _probe_batch(5, 8)
    cuda_kernels.reset_launches()
    try:
        for _ in range(3):
            cache.plan(pcm, ct, vt, 256, True, True, rows=8)
        assert {k: cuda_kernels.launches[k] for k in LAUNCHES} == {k: 3 * v for k, v in LAUNCHES.items()}
        assert cuda_kernels.launches["k_after_stateful_fused"] == 0
        assert cuda_kernels.card_launches == {}  # CPU tensors have no card
        cuda_kernels.count_replay(LAUNCHES, torch.device("cuda", 1))
        assert cuda_kernels.card_launches == {1: LAUNCHES}
    finally:
        cuda_kernels.reset_launches()


def test_recording_takes_launches_down_instead_of_counting_them():
    cuda_kernels.reset_launches()
    try:
        with cuda_kernels.recording() as recorded:
            cuda_kernels._count("k_cost_sums", torch.device("cuda", 0))
            cuda_kernels._count("k_cost_sums", torch.device("cuda", 0))
            cuda_kernels._count("cumsum_u32")
        assert recorded == {"k_cost_sums": 2, "cumsum_u32": 1}
        assert not any(cuda_kernels.launches.values()) and cuda_kernels.card_launches == {}
        cuda_kernels._count("cumsum_u32")  # outside: counted again
        assert cuda_kernels.launches["cumsum_u32"] == 1
    finally:
        cuda_kernels.reset_launches()


def test_a_failed_capture_raises_and_caches_nothing():
    log = []
    cache = plan_graphs.GraphCache(_stand_in(log, fail=True))
    pcm, ct, vt = _probe_batch(4, 9)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            cache.plan(pcm, ct, vt, 256, True, True, rows=4)
    assert len(log) == 2 and not cache.entries
    assert cache.stats["captures"] == 0 and cache.stats["replays"] == 0


@pytest.mark.parametrize("rows,shape", [(3, (4, 256)), (4, (4, 255)), (4, (0, 256))])
def test_a_batch_that_does_not_fit_its_plan_raises(rows, shape):
    cache = plan_graphs.GraphCache(_stand_in([]))
    pcm = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        cache.plan(pcm, torch.zeros((5, shape[0], 13), dtype=torch.int16), torch.zeros((5, shape[0]), dtype=torch.bool),
                   256, True, True, rows=rows)


# ------------------------------------------------------------------ the shapes asked for


def test_plane_pipeline_plans_at_bp_and_the_probe_shape(monkeypatch):
    """Full-width batches at ``bp`` (the doubled batch where 2K is a ladder
    width), probe batches at 12 K: the shapes of the graphs replayed."""
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 4)
    monkeypatch.setattr(device_pipeline, "CHUNK_LADDER", (4, 8))
    seen = []
    real = device_pipeline.planned

    def recorded(pcm, *args, rows=None, **kwargs):
        seen.append((pcm.shape[0], pcm.shape[1], rows))
        return real(pcm, *args, rows=rows, **kwargs)

    monkeypatch.setattr(device_pipeline, "planned", recorded)
    left, right = gliding_stereo(9 * N + 300, 44100, 16, 11)
    enc = FrameEncoder(12, 2, 44100, 16, device="cpu")
    got = enc.encode(left, right)
    assert got == enc.encode_frame(left, right)
    full = [s for s in seen if s[1] == N]
    probe = [s for s in seen if s[1] == 256]
    assert full and all(rows in (4, 8) and nsub <= rows for nsub, _, rows in full)
    assert any(rows == 8 for _, _, rows in full), "want a doubled batch"
    assert probe and all(rows == 12 * 4 and nsub <= rows for nsub, _, rows in probe)


def test_group_route_plans_at_its_padded_shape(monkeypatch):
    seen = []
    real = encoder.planned

    def recorded(pcm, *args, rows=None, **kwargs):
        seen.append((pcm.shape[0], rows))
        return real(pcm, *args, rows=rows, **kwargs)

    monkeypatch.setattr(encoder, "planned", recorded)
    rng = np.random.RandomState(12)
    pcm = rng.randint(-3000, 3000, (5, 256)).astype(np.int32)
    assert ChannelBlockEncoder(device="cpu").encode_group(pcm) == ChannelBlockEncoder().encode_group(pcm)
    assert seen == [(5, 8)]


def test_warm_grid_shapes():
    """The chunk widths up to the one an encode of BLOCKS takes, their
    doubled batches, their probe shapes, then the group caps (split over
    a mesh)."""
    assert serve.warm_plan_shapes(128) == [(64, N, False), (128, N, False), (768, 256, False), (256, N, False),
                                           (1536, 256, False), (1024, 256, False)]
    assert serve.warm_plan_shapes(484) == serve.warm_plan_shapes(128)[:5] + [(3072, 256, False), (1024, 256, False)]
    assert serve.warm_plan_shapes(8) == [(64, N, False), (128, N, False), (768, 256, False), (1024, 256, False)]
    assert serve.warm_plan_shapes(8, mesh_size=4, emit_fields=True) == [
        (64, N, False), (128, N, False), (768, 256, False), (32, N, True), (256, 256, True)]
