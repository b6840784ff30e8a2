"""The port's captured executables (``lac_tpu_torch.plan_graphs``) on
the CPU: plans, and since the analyze and lag graphs joined them, the
cache of every kind.

A CUDA graph runs only on the card, where ``chip_smoke.py`` phase 15
holds every captured shape bit-exact against the eager function. Here:

* ``planned`` on CPU tensors against ``lac_tpu``'s ``_jitted_plan``
  called the way ``lac_tpu/device_pipeline.py:786-800`` calls it: a
  ragged batch padded to ``bp`` (the pad rows gather row 0 there, their
  candidates zero), ``meta[:nsub]`` exact, and ``ship`` with
  ``emit_fields``;
* the static-buffer fill: a batch's rows in, the rows that a fuller
  earlier batch left behind zeroed;
* the graph cache with a stand-in for the capture that runs on the CPU:
  its keys, its bound, the copy-out, the replay accounting, and a failed
  capture that raises and caches nothing; the same for analyze and lag
  graphs, whose caches keep apart, each bounded per card, with outputs
  that outlive another graph's replay in the same pool;
* the padded shapes that the plane pipeline, the group route and the
  warm-up ask for (``warm_plan_shapes``, ``warm_analyze_shapes``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu import encoder as ref_enc  # noqa: E402
from lac_tpu.ops import lpc as ref_lpc  # noqa: E402
from lac_tpu_torch import device_pipeline, encoder, plan_graphs, serve  # noqa: E402
from lac_tpu_torch.encoder import ChannelBlockEncoder, FrameEncoder, plan_group, plan_inputs_to_torch  # noqa: E402
from lac_tpu_torch.ops import cuda_kernels, lpc  # noqa: E402
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


def test_each_replay_adds_its_graph_tally():
    """A plan graph zeroes and fills its own tally at each replay (here a
    stand-in that reruns plan_group on the padded buffers), and each replay
    adds it to the caller's: kernel 10's wide parts and parts, the padded
    rows' included."""

    def capture(static, n, zero_run, partitioning, emit_fields):
        tally = torch.zeros(2, dtype=torch.int64)

        def run():
            tally.zero_()
            return (plan_group(static.pcm, static.coeffs, static.valid, n, zero_run, partitioning, tally=tally),)

        out = run()

        def replay():
            for o, fresh in zip(out, run()):
                o.copy_(fresh)

        captured = plan_graphs.Captured(replay, out, {})
        captured.tally = tally
        return captured

    cache = plan_graphs.GraphCache(capture)
    pcm, ct, vt = _probe_batch(12, 31)
    # a loud noise row: its codes near 2^27, so its parts sum past 2^31
    pcm[0] = torch.from_numpy(np.random.RandomState(31).randint(-(1 << 27), 1 << 27, 256).astype(pcm.numpy().dtype))
    mine = torch.tensor([5, 6])
    for _ in range(2):
        got = cache.plan(pcm, ct, vt, 256, True, True, rows=16, tally=mine)
        assert torch.equal(got, plan_group(pcm, ct, vt, 256, True, True))
    one = torch.zeros(2, dtype=torch.int64)
    plan_group(pcm, ct, vt, 256, True, True, tally=one)
    assert one[0] > 0 and one[1] == 12 * cuda_kernels.partition_parts(3)
    assert mine.tolist() == [5 + 2 * int(one[0]), 6 + 2 * 16 * cuda_kernels.partition_parts(3)]


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


# ------------------------------------------------------------------ analyze and lag graphs


def _stand_in_of(run_of, log, fail=False, pool=None):
    """A capture of any kind that runs on the CPU: ``run_of(static, *key)``
    gives the eager outputs, ``replay`` copies a fresh run into the
    captured ones. With ``pool`` (a list) every graph writes its outputs
    into the same tensors, as graphs that share a card's pool may."""

    def capture(static, *key):
        log.append(key)
        if fail:
            raise RuntimeError("capture failed")
        out = run_of(static, *key)
        if pool is not None:
            if not pool:
                pool.extend(t.clone() for t in out)
            out = tuple(p.view(-1)[: t.numel()].view(t.shape) for p, t in zip(pool, out))

        def replay():
            for o, fresh in zip(out, run_of(static, *key)):
                o.copy_(fresh)

        replay()
        return plan_graphs.Captured(replay, out, {})

    return capture


def _analyze_run(static, kind, dtype):
    return plan_graphs._analyze_static(static, kind)


def _lags_run(static, n, dtype):
    return (_eager_lags(static.pcm),)


def _eager_lags(pcm):
    return lpc.autocorrelation(pcm, 12)


def _chunk(kc, seed, dtype=np.int16):
    rng = np.random.RandomState(seed)
    left = rng.randint(-3000, 3000, (kc, N)).astype(dtype)
    right = (left // 2 + rng.randint(-50, 50, (kc, N))).astype(dtype)
    return torch.from_numpy(left), torch.from_numpy(right)


def _eager_analyze(lmat, rmat, K, kind):
    """``device_pipeline.analyze`` of the chunk zero-padded to K rows."""
    pad = [torch.cat([m, torch.zeros((K - m.shape[0], N), dtype=m.dtype)]) for m in (lmat, rmat)]
    return device_pipeline.analyze(*pad, kind)


def test_one_capture_per_analyze_key_then_replays():
    log = []
    cache = plan_graphs.GraphCache(_stand_in_of(_analyze_run, log), plan_graphs.MAX_ANALYZE_GRAPHS)
    for kc, seed in ((4, 1), (2, 2), (4, 3)):
        lmat, rmat = _chunk(kc, seed)
        got = cache.analyze(lmat, rmat, 4, "auto")
        want = _eager_analyze(lmat, rmat, 4, "auto")
        assert set(got) == set(want) == set(plan_graphs.ANALYZE_OUT)
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert log == [("auto", torch.int16)]
    assert list(cache.entries) == [(None, 4, "auto", torch.int16)]
    assert cache.stats["captures"] == 1 and cache.stats["replays"] == 3


def test_analyze_keys_tell_width_kind_and_dtype_apart():
    log = []
    cache = plan_graphs.GraphCache(_stand_in_of(_analyze_run, log), plan_graphs.MAX_ANALYZE_GRAPHS)
    lmat, rmat = _chunk(2, 4)
    calls = [(4, "auto", np.int16), (2, "auto", np.int16), (4, "mono", np.int16), (4, "lr", np.int16),
             (4, "ms", np.int16), (4, "auto", np.int32), (4, "auto", np.int16)]
    for K, kind, dt in calls:
        lm, rm = (m.to(getattr(torch, np.dtype(dt).name)) for m in (lmat, rmat))
        got = cache.analyze(lm, rm, K, kind)
        want = _eager_analyze(lm, rm, K, kind)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert len(log) == 6 and cache.stats["replays"] == 7
    assert list(cache.entries)[-1] == (None, 4, "auto", torch.int16)


def test_one_capture_per_lag_key_then_replays():
    log = []
    cache = plan_graphs.GraphCache(_stand_in_of(_lags_run, log), plan_graphs.MAX_LAG_GRAPHS)
    rng = np.random.RandomState(5)
    for B, dt in ((7, np.int16), (3, np.int16), (7, np.int32), (8, np.int16)):
        pcm = torch.from_numpy(rng.randint(-3000, 3000, (B, 256)).astype(dt))
        got = cache.lags(pcm, 8)
        assert torch.equal(got, _eager_lags(pcm)) and got.shape == (B, 13)
    assert log == [(256, torch.int16), (256, torch.int32)]
    assert cache.stats["captures"] == 2 and cache.stats["replays"] == 4


def test_kinds_do_not_evict_each_other_and_share_one_lock():
    """Each kind has a cache of its own, under the one lock that serialises
    a card's replays."""
    caches = plan_graphs.CACHES
    assert set(caches) == {"plan", "analyze", "lags"}
    assert len({id(c.lock) for c in caches.values()}) == 1
    assert (caches["plan"].maxsize, caches["analyze"].maxsize, caches["lags"].maxsize) == (64, 16, 16)
    assert plan_graphs.stats is caches["plan"].stats and plan_graphs._CACHE is caches["plan"]
    lock = plan_graphs.threading.RLock()
    plan = plan_graphs.GraphCache(_stand_in([]), maxsize=1, lock=lock)
    analyze = plan_graphs.GraphCache(_stand_in_of(_analyze_run, []), maxsize=1, lock=lock)
    lags = plan_graphs.GraphCache(_stand_in_of(_lags_run, []), maxsize=1, lock=lock)
    pcm, ct, vt = _probe_batch(4, 10)
    plan.plan(pcm, ct, vt, 256, True, True, rows=4)
    analyze.analyze(*_chunk(2, 11), 2, "lr")
    lags.lags(pcm, 4)
    assert [len(c.entries) for c in (plan, analyze, lags)] == [1, 1, 1]


@pytest.mark.parametrize("maxsize", [plan_graphs.MAX_ANALYZE_GRAPHS, 2])
def test_the_bound_counts_each_card_apart(maxsize):
    """maxsize + 1 keys on each of two cards: each card drops its own
    oldest graph, and the other card's stay."""
    log = []
    cache = plan_graphs.GraphCache(_stand_in_of(lambda static, *key: (static.pcm.sum(1),), log), maxsize)
    pcm = torch.ones((2, 8), dtype=torch.int32)
    for i in range(maxsize + 1):
        for card in (0, 1):
            out = cache.run((card, i), lambda: plan_graphs.lag_buffers(4, 8, torch.int32, CPU), (pcm,), 2, CPU,
                            "lags")
            assert torch.equal(out[0], torch.full((2,), 8))
    assert len(log) == 2 * (maxsize + 1)
    assert sorted(cache.entries) == sorted((card, i) for card in (0, 1) for i in range(1, maxsize + 1))


def test_outputs_outlive_the_next_replay_of_another_graph():
    """Graphs that share a pool write their outputs into the same memory:
    what a caller holds is its own copy."""
    pool = []
    cache = plan_graphs.GraphCache(_stand_in_of(_analyze_run, [], pool=pool), plan_graphs.MAX_ANALYZE_GRAPHS)
    first = _chunk(4, 12)
    got1 = cache.analyze(*first, 4, "lr")
    keep = {k: v.clone() for k, v in got1.items()}
    second = _chunk(2, 13)
    got2 = cache.analyze(*second, 2, "lr")  # another graph, the same pool
    static_out = cache.entries[(None, 4, "lr", torch.int16)][1].out
    assert not torch.equal(static_out[0][: 2 * 2], keep["planes"][: 2 * 2]), "the pool was overwritten"
    for k in keep:
        assert torch.equal(got1[k], keep[k])
    want = _eager_analyze(*second, 2, "lr")
    assert all(torch.equal(got2[k], want[k]) for k in want)


def test_a_ragged_chunk_zeroes_the_rows_a_fuller_chunk_left():
    cache = plan_graphs.GraphCache(_stand_in_of(_analyze_run, []), plan_graphs.MAX_ANALYZE_GRAPHS)
    full = _chunk(4, 14)
    cache.analyze(*full, 4, "auto")
    ragged = _chunk(1, 15)
    got = cache.analyze(*ragged, 4, "auto")
    static = cache.entries[(None, 4, "auto", torch.int16)][0]
    assert torch.equal(static.lmat[:1], ragged[0]) and not static.lmat[1:].any()
    assert torch.equal(static.rmat[:1], ragged[1]) and not static.rmat[1:].any() and static.filled == 1
    want = _eager_analyze(*ragged, 4, "auto")
    assert all(torch.equal(got[k], want[k]) for k in want)
    mono = plan_graphs.analyze_buffers(4, "mono", torch.int32, CPU)
    assert not hasattr(mono, "rmat") and mono.lmat.shape == (4, N) and mono.lmat.dtype == torch.int32


@pytest.mark.parametrize("kind", ["analyze", "lags"])
def test_a_failed_analyze_or_lag_capture_raises_and_caches_nothing(kind):
    log = []
    run = _analyze_run if kind == "analyze" else _lags_run
    cache = plan_graphs.GraphCache(_stand_in_of(run, log, fail=True), 16)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            if kind == "analyze":
                cache.analyze(*_chunk(2, 16), 4, "ms")
            else:
                cache.lags(torch.zeros((3, 256), dtype=torch.int16), 4)
    assert len(log) == 2 and not cache.entries
    assert cache.stats["captures"] == 0 and cache.stats["replays"] == 0


@pytest.mark.parametrize("what,args", [("analyze", ((9, N), 8)), ("analyze", ((2, 255), 8)),
                                       ("lags", ((5, 256), 4))])
def test_an_input_that_does_not_fit_its_graph_raises(what, args):
    cache = plan_graphs.GraphCache(_stand_in_of(_analyze_run if what == "analyze" else _lags_run, []), 16)
    shape, rows = args
    x = torch.zeros(shape, dtype=torch.int16)
    with pytest.raises(ValueError, match="does not fit"):
        cache.analyze(x, x, rows, "lr") if what == "analyze" else cache.lags(x, rows)


def test_warm_analyze_shapes():
    """``auto`` analyze of 16-bit planes at every chunk width that the plan
    grid warms, then the group route's lags at its caps, whole on one
    card (a mesh only rounds the batch up to a multiple of its size)."""
    lags = [("lags", 128, N, "int16"), ("lags", 1024, 256, "int16")]
    for blocks in (8, 128, 484):
        widths = [rows for rows, n, _ in serve.warm_plan_shapes(blocks) if n == 256 and rows != 1024]
        assert [k for _, k, _, _ in serve.warm_analyze_shapes(blocks)[:-2]] == [w // 12 for w in widths]
    assert serve.warm_analyze_shapes(8) == [("analyze", 64, "auto", "int16")] + lags
    assert serve.warm_analyze_shapes(128) == [("analyze", k, "auto", "int16") for k in (64, 128)] + lags
    assert serve.warm_analyze_shapes(484) == [("analyze", k, "auto", "int16") for k in (64, 128, 256)] + lags
    assert serve.warm_analyze_shapes(8, mesh_size=4) == serve.warm_analyze_shapes(8)
    assert serve.warm_analyze_shapes(8, mesh_size=3)[-2:] == [("lags", 129, N, "int16"), ("lags", 1026, 256, "int16")]


def test_warm_analyze_shapes_follow_a_pinned_chunk_width(monkeypatch):
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 8)
    assert serve.warm_analyze_shapes(484)[0] == ("analyze", 8, "auto", "int16")
    assert len(serve.warm_analyze_shapes(484)) == 3
