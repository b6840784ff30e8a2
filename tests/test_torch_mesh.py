"""The port's mesh on the CPU: ``parallel.mesh`` and every entry point
that spreads the plane pipeline's chunks over a mesh.

A stand-in mesh repeats one device (``make_mesh(["cpu"] * 4)``): each
entry still gets its own dispatch thread and its own chunks. The same
PCM, made from numpy seeds, goes through ``lac_tpu_torch`` with and
without a mesh, through ``lac_tpu.parallel.plan_group_sharded`` on the
virtual CPU mesh that ``tests/conftest.py`` sets up, and through
``lac_tpu``'s numpy encoder. Tolerance: none, meta rows and frames are
identical.
"""

import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu import encoder as ref_enc  # noqa: E402
from lac_tpu import parallel as ref_parallel  # noqa: E402
from lac_tpu.encoder import FrameEncoder as RefEncoder  # noqa: E402
from lac_tpu.ops import lpc as ref_lpc  # noqa: E402
from lac_tpu_torch import batch, cli, device_pipeline, encoder, pool, serve  # noqa: E402
from lac_tpu_torch.encoder import ChannelBlockEncoder, FrameEncoder, plan_group  # noqa: E402
from lac_tpu_torch.parallel import default_mesh, make_mesh, mesh as mesh_mod, plan_group_sharded  # noqa: E402

B = 16384
CPU4 = ("cpu",) * 4


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
    """Chunks of 2 blocks, so that a file of a few blocks has chunks on every entry of the mesh."""
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 2)


def _stereo(frames, seed):
    """A tone with noise; the right channel swings between correlated and independent."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames)
    left = (np.sin(t * 0.013) * 9000).astype(np.int32) + rng.randint(-600, 600, frames).astype(np.int32)
    mix = (np.arange(frames) // B) % 3
    right = np.where(mix == 0, left // 2, np.where(mix == 1, 0, left)) + rng.randint(-900, 900, frames)
    return left, np.clip(right, -(1 << 15), (1 << 15) - 1).astype(np.int32)


def _pcm(rows, n, seed):
    """Noise, a tone, sparse bursts, silence and a constant: lanes that take different predictors."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    kinds = [rng.randint(-30000, 30000, n), (np.sin(t / 9.0) * 20000).astype(np.int64),
             np.where(rng.rand(n) < 0.03, rng.randint(-3, 4, n), 0), np.zeros(n, np.int64), np.full(n, 1234)]
    return np.stack([kinds[(i + seed) % len(kinds)] for i in range(rows)]).astype(np.int32)


# ------------------------------------------------------------ plan_group_sharded


@pytest.mark.parametrize("rows,n", [(16, 512), (8, 256)], ids=["B16-n512", "B8-n256"])
def test_plan_group_sharded_equals_plan_group_and_lac_tpu(rows, n):
    pcm = _pcm(rows, n, rows)
    coeffs, _, lvalid, _ = ref_enc.lpc_candidates_from_lags(ref_lpc.autocorrelation(pcm, 12), n)
    got = plan_group_sharded(make_mesh(CPU4), pcm, coeffs, lvalid, n)
    whole = plan_group(torch.from_numpy(pcm), torch.from_numpy(coeffs), torch.from_numpy(lvalid), n, True, True)
    devices = jax.devices()
    assert len(devices) >= 4, "tests/conftest.py sets up a virtual mesh of 8 CPU devices"
    ref = ref_parallel.plan_group_sharded(ref_parallel.make_mesh(devices[:4]), pcm, coeffs, lvalid, n,
                                          emit_fields=False)
    assert got["meta"].dtype == np.int8 and got["meta"].shape == tuple(whole.shape)
    np.testing.assert_array_equal(got["meta"], whole.numpy())
    np.testing.assert_array_equal(got["meta"], np.asarray(ref["meta"]))
    assert got["total_token_bits"] == int(ref["total_token_bits"]) == rows


def test_plan_group_sharded_uneven_batch_raises():
    pcm = _pcm(6, 256, 3)
    with pytest.raises(ValueError, match="does not split evenly"):
        plan_group_sharded(make_mesh(CPU4), pcm, np.zeros((5, 6, 13), np.int16), np.zeros((5, 6), bool), 256)


def test_make_mesh():
    assert make_mesh(["cpu", torch.device("cpu")]) == (torch.device("cpu"),) * 2
    assert make_mesh(CPU4) == make_mesh(list(CPU4))  # meshes compare by value
    with pytest.raises(ValueError, match="at least one"):
        make_mesh([])
    with pytest.raises(ValueError, match="unsupported device"):
        make_mesh(["meta"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(["cuda:0", "cuda:0"])


# ------------------------------------------------------------ default_mesh


@pytest.fixture
def fake_cards(monkeypatch):
    """torch.cuda reporting ``n`` cards; starting a CUDA context raises."""
    monkeypatch.setattr(mesh_mod, "_DEFAULT_MESH_CACHE", [])

    def lazy_init():
        raise AssertionError("a CUDA context was started")

    monkeypatch.setattr(torch.cuda, "_lazy_init", lazy_init)

    def cards(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

    return cards


@pytest.mark.parametrize("cards,env,want", [
    (4, "0", None), (1, None, None), (1, "1", None), (0, None, None), (2, None, 2), (4, "1", 4)],
    ids=["off-4-cards", "one-card", "one-card-on", "no-card", "two-cards", "four-cards-on"])
def test_default_mesh(fake_cards, monkeypatch, cards, env, want):
    fake_cards(cards)
    if env is None:
        monkeypatch.delenv("LAC_TPU_MESH", raising=False)
    else:
        monkeypatch.setenv("LAC_TPU_MESH", env)
    got = default_mesh()
    assert got == (None if want is None else tuple(torch.device("cuda", i) for i in range(want)))
    assert default_mesh() is got  # cached
    assert not torch.cuda.is_initialized()


def test_default_mesh_on_this_cpu(monkeypatch):
    monkeypatch.setattr(mesh_mod, "_DEFAULT_MESH_CACHE", [])
    monkeypatch.delenv("LAC_TPU_MESH", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present (chip_smoke.py covers it)")
    assert default_mesh() is None
    assert not torch.cuda.is_initialized()


def test_cpu_entry_points_never_ask_for_the_default_mesh(tmp_path, monkeypatch):
    """The CLI, a pooled wave and the service's warm-up take ``default_mesh`` only on a card."""
    from lac_tpu_torch import parallel

    def refused():
        raise AssertionError("default_mesh asked for on the CPU")

    monkeypatch.setattr(parallel, "default_mesh", refused)
    left, right = _stereo(8 * B + 3, 31)
    wav, lac = str(tmp_path / "a.wav"), str(tmp_path / "a.lac")
    from lac_tpu_torch.io import write_wav

    assert write_wav(wav, left, right, 2, 44100, 16)
    assert cli.main(["encode", wav, lac], device="cpu") == 0
    with open(lac, "rb") as f:
        assert f.read() == FrameEncoder(12, 2, 44100, 16, device="cpu").encode_frame(left, right)
    group = [pool.prepare_encode_job(["encode", wav, lac])]
    released = []
    pool.run_group_wave(group, lambda i, planes: released.append(i), device="cpu")
    assert released == [0]
    assert serve.warm_process(8, device="cpu") > 0


# ------------------------------------------------------------ the encoder on a mesh


@pytest.mark.parametrize("kind", ["auto", "lr", "ms", "mono"])
def test_frame_encoder_mesh_bytes(kind):
    """12 full blocks and a tail: 6 chunks over 4 entries, bytes those of one device and of lac_tpu."""
    left, right = _stereo(12 * B + 4321, 40)
    mode = {"auto": 2, "lr": 0, "ms": 1, "mono": 0}[kind]
    if kind == "mono":
        right = ()
    enc = FrameEncoder(12, mode, 44100, 16, device="cpu", mesh=make_mesh(CPU4))
    assert enc.mesh == (torch.device("cpu"),) * 4
    got = enc.encode(left, right)
    assert got == FrameEncoder(12, mode, 44100, 16, device="cpu").encode(left, right)
    assert got == RefEncoder(12, mode, 44100, 16, xp=np).encode(left, right)


def test_set_mesh_and_the_host_route():
    enc = FrameEncoder(device="cpu")
    assert enc.mesh is None
    enc.set_mesh(["cpu", "cpu"])
    assert enc.mesh == (torch.device("cpu"),) * 2
    enc.set_mesh(None)
    assert enc.mesh is None
    assert ChannelBlockEncoder(mesh=make_mesh(CPU4)).mesh == make_mesh(CPU4)


def test_chunks_go_round_robin_at_one_devices_widths(monkeypatch):
    """Chunk j is planned on entry j % 4's thread; the plan batches are one device's, shape for shape
    (one device dispatches from a thread of its own too)."""
    left, right = _stereo(10 * B + 5, 41)
    seen = []
    real = device_pipeline.planned

    def recorded(pcm, *args, **kwargs):
        seen.append((threading.current_thread().name, tuple(pcm.shape)))
        return real(pcm, *args, **kwargs)

    monkeypatch.setattr(device_pipeline, "planned", recorded)
    enc = FrameEncoder(12, 0, 44100, 16, device="cpu")
    one = device_pipeline.PlanePipeline(enc, left, right, 10, "lr", enc.device)
    want = one.run()
    shapes_one = sorted(s for _, s in seen)
    assert {t for t, _ in seen} == {"lac-dispatch-0-cpu"}  # one device: one dispatch thread of its own
    seen.clear()
    pipe = device_pipeline.PlanePipeline(enc, left, right, 10, "lr", None, mesh=make_mesh(CPU4))
    assert [job.c0 for job in pipe.jobs] == [0, 2, 4, 6, 8]
    assert pipe.run() == want
    assert sorted(s for _, s in seen) == shapes_one
    per_chunk = len(shapes_one) // 5  # plan batches of one chunk
    assert sorted(t for t, _ in seen) == sorted(f"lac-dispatch-{j % 4}-cpu" for j in range(5) for _ in range(per_chunk))


def test_progress_cb_under_a_mesh_fires_in_block_order_on_the_calling_thread():
    left, right = _stereo(9 * B, 42)
    enc = FrameEncoder(12, 2, 44100, 16, device="cpu")
    seen = []

    def cb(done, payloads, flags, uncertain):
        assert threading.current_thread() is threading.main_thread()
        assert sorted(payloads) == sorted(flags) == sorted(uncertain) == list(range(done))
        assert all(sorted(payloads[b]) == [0, 1] for b in range(done))
        seen.append(done)

    pipe = device_pipeline.PlanePipeline(enc, left, right, 9, "auto", None, mesh=make_mesh(("cpu",) * 3))
    got = pipe.run(progress_cb=cb)
    assert seen == [2, 4, 6, 8, 9]
    assert got == device_pipeline.PlanePipeline(enc, left, right, 9, "auto", enc.device).run()


def test_a_failure_on_one_card_raises_and_stops_every_dispatch_thread(monkeypatch):
    left, right = _stereo(12 * B, 43)
    real = device_pipeline._ChunkJob.dispatch_plan

    def failing(job):
        if job.c0 == 6:  # chunk 3: the second chunk of entry 1
            raise RuntimeError("card lost")
        return real(job)

    monkeypatch.setattr(device_pipeline._ChunkJob, "dispatch_plan", failing)
    enc = FrameEncoder(12, 0, 44100, 16, device="cpu", mesh=make_mesh(("cpu",) * 2))
    with pytest.raises(RuntimeError, match="card lost"):
        enc.encode(left, right)
    assert not [t for t in threading.enumerate() if t.name.startswith("lac-dispatch-")]


def test_mesh_threads_issue_one_stage_at_a_time(monkeypatch):
    """The dispatch threads of a mesh take turns by whole stages (interleaved operator streams cost
    a thread switch per operator, whatever the card), while emits run beside them."""
    left, right = _stereo(8 * B + 9, 44)
    state = {"inside": 0, "most": 0, "threads": set()}
    guard = threading.Lock()

    def watched(stage):
        def run(self):
            with guard:
                state["inside"] += 1
                state["most"] = max(state["most"], state["inside"])
                state["threads"].add(threading.current_thread().name)
            try:
                return stage(self)
            finally:
                with guard:
                    state["inside"] -= 1
        return run

    for name in ("dispatch_analyze", "dispatch_plan"):
        monkeypatch.setattr(device_pipeline._ChunkJob, name, watched(getattr(device_pipeline._ChunkJob, name)))
    got = FrameEncoder(12, 2, 44100, 16, device="cpu", mesh=make_mesh(CPU4)).encode(left, right)
    assert got == FrameEncoder(12, 2, 44100, 16, device="cpu").encode_frame(left, right)
    assert state["most"] == 1 and {f"lac-dispatch-{s}-cpu" for s in range(4)} <= state["threads"]


def test_dispatch_turns_follow_the_order_of_asking():
    """Threads waiting for the dispatch lock take it in the order they asked (a plain lock lets
    its last holder take it again at once, and one entry of a mesh could dispatch all its
    stages while the other cards idle)."""
    lock = device_pipeline._TurnLock()
    order = []

    def take(i):
        with lock:
            order.append(i)

    threads = []
    with lock:
        for i in range(6):
            asked = lock._next
            threads.append(threading.Thread(target=take, args=(i,), daemon=True))
            threads[-1].start()
            for _ in range(2000):  # until thread i holds its ticket
                if lock._next > asked:
                    break
                threading.Event().wait(0.001)
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert order == list(range(6))


@pytest.mark.parametrize("when", ["waiting", "at its turn"])
def test_an_interrupted_waiter_gives_its_turn_up(when):
    """A waiter that an exception interrupts (KeyboardInterrupt, a signal handler that raises) while it
    waits behind another thread, or just as its turn comes, gives the turn up: the thread behind it
    still gets the lock, and the lock is free afterwards."""
    lock = device_pipeline._TurnLock()
    real_wait = lock._cv.wait
    victim_ticket = 1

    def wait(timeout=None):  # where a signal lands in Condition.wait_for
        if threading.current_thread().name == "victim":
            if when == "waiting":
                raise KeyboardInterrupt
            woke = real_wait(timeout)
            if lock._serving == victim_ticket:
                raise KeyboardInterrupt
            return woke
        return real_wait(timeout)

    lock._cv.wait = wait
    caught, order = [], []

    def take(i):
        try:
            with lock:
                order.append(i)
        except BaseException as e:  # noqa: BLE001 — recorded for the test's thread
            caught.append((i, type(e)))

    def start(name, i):
        asked = lock._next
        t = threading.Thread(target=take, args=(i,), name=name, daemon=True)
        t.start()
        for _ in range(2000):  # until the thread holds its ticket
            if lock._next > asked:
                break
            threading.Event().wait(0.001)
        return t

    with lock:
        threads = [start("victim", 1), start("behind", 2)]
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert caught == [(1, KeyboardInterrupt)] and order == [2]
    again = threading.Thread(target=take, args=(3,), daemon=True)
    again.start()
    again.join(timeout=10)
    assert not again.is_alive() and order == [2, 3] and not lock._given_up


# ------------------------------------------------------------ batch and pool


ITEMS = ((3 * B + 1000, 51), (2 * B, 52), (B + 77, 53), (5 * B + 9, 54), (5000, 55))


@pytest.fixture(scope="module")
def items():
    return [_stereo(n, seed) for n, seed in ITEMS]


@pytest.mark.parametrize("call", ["encode_batch", "encode_pooled"])
def test_batch_and_pool_on_a_mesh_equal_the_unmeshed_results(items, call):
    fn = getattr(batch if call == "encode_batch" else pool, call)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device_pipeline, "CHUNK_BLOCKS", 2)
        got = fn(items, 44100, 16, device="cpu", mesh=make_mesh(CPU4))
        want = fn(items, 44100, 16, device="cpu")
    assert got == want
    assert got == [FrameEncoder(12, 2, 44100, 16, device="cpu").encode_frame(l, r) for l, r in items]


def test_encode_pooled_never_puts_meshed_and_unmeshed_items_in_one_wave(items, monkeypatch):
    stand_in = make_mesh(("cpu",) * 2)
    made = []

    class EveryOtherMeshed(FrameEncoder):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if len(made) % 2:
                self.set_mesh(stand_in)
            made.append(self)

    waves = []
    real_wave = pool.run_group_wave

    def recorded(group, file_done, template_enc=None, device="cuda"):
        lefts = [id(job.wav[0]) for job in group]
        waves.append((template_enc.mesh, [next(i for i, (l, _) in enumerate(items) if id(l) == x) for x in lefts]))
        return real_wave(group, file_done, template_enc=template_enc, device=device)

    monkeypatch.setattr(encoder, "FrameEncoder", EveryOtherMeshed)
    monkeypatch.setattr(pool, "run_group_wave", recorded)
    got = pool.encode_pooled(items, 44100, 16, device="cpu")
    assert sorted(mesh is None for mesh, _ in waves) == [False, True]
    for mesh, idxs in waves:
        assert all(made[i].mesh == mesh for i in idxs)
    assert sorted(i for _, idxs in waves for i in idxs) == [0, 1, 2, 3]  # item 4 has no full block
    assert got == [FrameEncoder(12, 2, 44100, 16, device="cpu").encode_frame(l, r) for l, r in items]


def test_sharded_window_under_thread_stress(monkeypatch):
    """The mesh's scheduler alone (stages replaced by bookkeeping), 96 chunks over 8 entries with
    the interpreter switching threads as often as it can and emits slower than dispatch: every
    chunk is analyzed, planned and emitted once, emits follow block order on the calling thread,
    and no entry holds more than PIPE_DEPTH + 2 chunks that are analyzed and not yet emitted."""
    import sys
    import time

    guard = threading.Lock()
    caller = {}
    log = {"analyzed": set(), "planned": set(), "emitted": [], "live": {}, "most": 0}

    def analyze(job):
        with guard:
            log["analyzed"].add(job.c0)
            n = log["live"][job.device_slot] = log["live"].get(job.device_slot, 0) + 1
            log["most"] = max(log["most"], n)

    def plan(job):
        with guard:
            assert job.c0 in log["analyzed"]
            log["planned"].add(job.c0)

    def finish(job):
        assert threading.current_thread() is caller["thread"]
        time.sleep(0.001)  # the entries run ahead of the emits: only the window holds them back
        with guard:
            assert job.c0 in log["planned"]
            log["emitted"].append(job.c0)
            log["live"][job.device_slot] -= 1
        return {}, {}, {}

    monkeypatch.setattr(device_pipeline._ChunkJob, "dispatch_analyze", analyze)
    monkeypatch.setattr(device_pipeline._ChunkJob, "await_analyze", lambda job: None)
    monkeypatch.setattr(device_pipeline._ChunkJob, "dispatch_plan", plan)
    monkeypatch.setattr(device_pipeline._ChunkJob, "finish", finish)
    left = np.zeros(192 * B, np.int32)
    pipe = device_pipeline.PlanePipeline(FrameEncoder(12, 0, 44100, 16, device="cpu"), left, (), 192, "mono", None,
                                         mesh=make_mesh(("cpu",) * 8))
    for j, job in enumerate(pipe.jobs):
        job.device_slot = j % 8
    errors = []

    def drive():
        caller["thread"] = threading.current_thread()
        try:
            pipe.run()
        except BaseException as e:  # noqa: BLE001 — handed to the test's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=drive)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive() and not errors, errors
    assert log["emitted"] == [2 * j for j in range(96)]
    assert device_pipeline.PIPE_DEPTH + 1 <= log["most"] <= device_pipeline.PIPE_DEPTH + 2
    assert not [t for t in threading.enumerate() if t.name.startswith("lac-dispatch-")]
