"""Host staging of the port's uploads on the CPU: ``lac_tpu_torch.stage``,
``upload`` and the pooled wave's plane matrices.

On a card every upload reads pinned memory that numpy filled (or nothing
filled: a pinned source goes as it is), so no torch CPU operator runs and
torch's intra-op thread pool stays asleep. Pinned memory needs a card, so
these tests hand the staging an allocator of plain host tensors, and
stand in for the card's copy where an upload's span is checked.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import lac_tpu_torch  # noqa: E402
from lac_tpu_torch import pool, stage, upload  # noqa: E402
from lac_tpu_torch.utils import debug  # noqa: E402

N = 16384


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _source(dtype, layout, shape=(96, 700)):
    r = np.random.default_rng(7)
    if dtype is bool:
        a = r.integers(0, 2, shape).astype(bool)
    else:
        info = np.iinfo(dtype)
        a = r.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)
    return {"contiguous": a, "strided": a[::3, 1::2], "transposed": a.T}[layout]


@pytest.mark.parametrize("layout", ["contiguous", "strided", "transposed"])
@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.int64, bool])
def test_staged_bytes_equal_the_source(dtype, layout):
    a = _source(dtype, layout)
    t = stage(a, alloc=lac_tpu_torch.pageable_empty)
    assert t.dtype == lac_tpu_torch.torch_dtype(dtype) and tuple(t.shape) == a.shape and t.is_contiguous()
    assert np.array_equal(t.numpy(), a) and t.numpy().tobytes() == np.ascontiguousarray(a).tobytes()


def test_staging_casts_to_the_dtype_asked_for():
    a = np.arange(-40000, 40000, 7, dtype=np.int32).reshape(-1, 1)
    a = a[(a >= -32768) & (a <= 32767)]
    t = stage(a, np.int16, alloc=lac_tpu_torch.pageable_empty)
    assert t.dtype == torch.int16 and np.array_equal(t.numpy(), a.astype(np.int16))


@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_staging_runs_no_torch_copy(layout):
    """A staging of over 32,768 elements (where ATen splits a copy over its
    OpenMP pool) records no copy operator; the same bytes through torch do."""
    a = _source(np.int16, layout, shape=(512, 1024))
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        stage(a, alloc=lac_tpu_torch.pageable_empty)
    names = {e.name for e in prof.events()}
    assert not names & {"aten::copy_", "aten::_to_copy"}, names
    with torch.profiler.profile(activities=acts) as prof:
        torch.from_numpy(np.ascontiguousarray(a)).clone()
    assert "aten::copy_" in {e.name for e in prof.events()}  # the profiler sees a torch copy


def test_upload_to_the_cpu_is_unchanged():
    cpu = torch.device("cpu")
    a = _source(np.int32, "contiguous")
    t = upload(a, cpu)
    assert np.shares_memory(t.numpy(), a) and np.array_equal(t.numpy(), a)
    s = _source(np.int16, "strided")
    assert np.array_equal(upload(s, cpu).numpy(), s)
    host = torch.from_numpy(a)
    assert upload(host, cpu) is host


@pytest.fixture
def stand_in_card(monkeypatch):
    """An upload to a "card" on the CPU: staging from plain host tensors,
    the copy to the card an identity; ``pinned`` says which tensors count
    as pinned. Spans are recorded."""
    pinned = set()
    monkeypatch.setattr(lac_tpu_torch, "pinned_empty", lac_tpu_torch.pageable_empty)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: self.data_ptr() in pinned)
    monkeypatch.setattr(torch.Tensor, "to", lambda self, device, non_blocking=False: self)
    debug.recording(True)
    yield types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"), pinned=pinned)
    debug.recording(False)


def test_upload_to_a_card_records_what_it_staged(stand_in_card):
    card = stand_in_card.device
    t0 = debug.spans()[-1].id if debug.spans() else 0
    a = _source(np.int16, "strided")
    assert np.array_equal(upload(a, card).numpy(), a)
    pinned = torch.zeros((4, 100), dtype=torch.int16)
    stand_in_card.pinned.add(pinned.data_ptr())
    assert upload(pinned, card) is pinned  # sent as it is
    plain = torch.ones((3, 5), dtype=torch.int32)
    sent = upload(plain, card)
    assert sent is not plain and torch.equal(sent, plain)
    got = [(s.attrs["bytes"], s.attrs["staged"]) for s in debug.spans() if s.name == "upload" and s.id > t0]
    assert got == [(a.nbytes, a.nbytes), (800, 0), (60, 60)]


def _job(left, right, kind="lr", dt=np.int16):
    return pool.PreparedEncode(parts=[], in_path="", wav=(left, right, 0, 44100, 16), kind=kind,
                               nfull=len(left) // N, dt=dt, key=(kind,))


@pytest.mark.parametrize("kind, dt", [("lr", np.int16), ("mono", np.int16), ("auto", np.int32)])
def test_wave_views_equal_the_concatenation(kind, dt):
    r = np.random.default_rng(11)
    lens = (3 * N + 100, N, 2 * N + N // 2)
    items = [(r.integers(-32768, 32768, n).astype(np.int32),
              r.integers(-32768, 32768, n).astype(np.int32) if kind != "mono" else np.empty(0, np.int32))
             for n in lens]
    asked = []

    def alloc(shape, dtype):
        asked.append((shape, dtype))
        return lac_tpu_torch.pageable_empty(shape, dtype)

    lmat, rmat, spans = pool._build_views([_job(lt, rt, kind, dt) for lt, rt in items], alloc)
    assert spans == [(0, 3), (3, 1), (4, 2)]
    assert asked == [((6, N), lac_tpu_torch.torch_dtype(dt))] * (1 if kind == "mono" else 2)
    want_l = np.concatenate([lt[: (len(lt) // N) * N].reshape(-1, N) for lt, _ in items]).astype(dt)
    assert lmat.numpy().dtype == dt and np.array_equal(lmat.numpy(), want_l)
    if kind == "mono":
        assert rmat is None
    else:
        want_r = np.concatenate([rt[: (len(rt) // N) * N].reshape(-1, N) for _, rt in items]).astype(dt)
        for row in range(6):
            assert np.array_equal(rmat[row].numpy(), want_r[row])


def test_the_pipeline_emits_from_views_of_the_wave_matrices(monkeypatch):
    """Host tensors as a wave's views: the native emit reads numpy views of
    the same memory, and the streams equal those of numpy views."""
    from lac_tpu_torch import device_pipeline
    from lac_tpu_torch.encoder import FrameEncoder

    if not device_pipeline.applicable(device_pipeline.MIN_FULL_BLOCKS):
        pytest.skip("the plane pipeline needs the native runtime")
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 4)
    r = np.random.default_rng(5)
    lview = (r.standard_normal((9, N)) * 3000).astype(np.int16)
    rview = (lview // 2 + r.integers(-200, 200, (9, N))).astype(np.int16)
    enc = FrameEncoder(12, 2, 44100, 16, device="cpu")
    lmat, rmat = torch.from_numpy(lview.copy()), torch.from_numpy(rview.copy())
    pipe = device_pipeline.PlanePipeline(enc, None, None, 9, "auto", enc.device, views=(lmat, rmat))
    assert np.shares_memory(pipe.lview, lmat.numpy()) and np.shares_memory(pipe.rview, rmat.numpy())
    got = pipe.run()
    assert got == device_pipeline.PlanePipeline(enc, None, None, 9, "auto", enc.device, views=(lview, rview)).run()


def test_one_file_planes_are_staged_only_where_they_are_built():
    """A channel already in the plane dtype is used as it is (each upload
    stages its chunk); one that must be cut to int16 is built in memory from
    the pipeline's allocator."""
    from lac_tpu_torch import device_pipeline

    r = np.random.default_rng(3)
    x = r.integers(-32768, 32768, 3 * N + 7).astype(np.int32)
    same = device_pipeline._planes(x, 3, np.int32, lac_tpu_torch.pageable_empty)
    assert isinstance(same, np.ndarray) and np.shares_memory(same, x) and same.shape == (3, N)
    cut = device_pipeline._planes(x, 3, np.int16, lac_tpu_torch.pageable_empty)
    assert isinstance(cut, torch.Tensor) and cut.dtype == torch.int16
    assert np.array_equal(cut.numpy(), x[: 3 * N].reshape(3, N).astype(np.int16))
