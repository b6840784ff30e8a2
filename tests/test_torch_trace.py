"""The port's span recorder (``lac_tpu_torch.utils.debug``) and the spans
and counters the encode paths open, on the CPU.

Off, a phase records nothing, reads no clock, makes no event and
synchronizes nothing; ``LAC_TPU_TIMING``, a running ``torch.profiler``
and ``debug.recording(True)`` each turn it on. A pooled encode's spans are
linked across the dispatch, emitting and finish threads; the ring is
bounded; the ``replay`` spans give the batch shapes the plane pipeline
plans at (``plan_batches`` and the 12 K probe batches); only a span that
asks for it reads the thread's CPU time; a graph replay on a card holds two
timing events, read lazily, and the timing line counts those still
pending; and the benchmark's readers of the spans give shares on a small
CPU run.
"""

import collections
import os
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from lac_tpu_torch import device_pipeline, plan_graphs, pool
from lac_tpu_torch.encoder import FrameEncoder
from lac_tpu_torch.utils import debug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16384
NEW_METRICS = ("pool.prepare_pct", "pool.finish_cpu_pct", "device_pipeline.ld_pct", "device_pipeline.emit_pct",
               "device_pipeline.wait_pct", "plan_graphs.pad_pct")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plane pipeline on the CPU: one intra-op thread (several pytest workers side by side)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def recorded(monkeypatch):
    """Recording on for the test alone, with a ring of its own."""
    monkeypatch.setattr(debug, "_ring", collections.deque(maxlen=debug.RING_SPANS))
    debug.recording(True)
    yield
    debug.recording(False)


@pytest.fixture
def unrecorded(monkeypatch):
    monkeypatch.setattr(debug, "_TIMING", False)
    monkeypatch.setattr(debug, "_ring", collections.deque(maxlen=debug.RING_SPANS))
    debug.recording(False)
    assert not debug.recording_on()


def _items(seed, blocks=(3, 4, 2)):
    """Stereo tracks of ``blocks`` full blocks and a tail, correlated enough
    that some blocks are uncertain (the probe plans run)."""
    rng = np.random.RandomState(seed)
    out = []
    for nb in blocks:
        n = nb * N + 77 * nb
        left = (3000 * np.sin(np.arange(n) * 0.01)).astype(np.int32) + rng.randint(-300, 300, n).astype(np.int32)
        right = np.roll(left, 3) + rng.randint(-900, 900, n).astype(np.int32)
        out.append((left, right))
    return out


def _pooled(items, monkeypatch, chunk=2):
    """Encode ``items`` pooled on the CPU at ``chunk`` blocks a chunk; the
    spans recorded meanwhile."""
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", chunk)
    frames = pool.encode_pooled(items, 44100, 16, device="cpu")
    got = debug.spans()
    want = [FrameEncoder(12, 2, 44100, 16, device="cpu").encode_frame(left, right) for left, right in items]
    assert frames == want
    return got


class _NoClock:
    """Stands in for ``time`` in the recorder: any clock read fails."""

    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read with recording off")


def _raise(*args, **kwargs):
    raise AssertionError("called with recording off")


# ------------------------------------------------------------------ off and on


def test_recording_off_keeps_nothing_and_makes_no_event(unrecorded, monkeypatch):
    monkeypatch.setattr(debug, "time", _NoClock())
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    monkeypatch.setattr(plan_graphs, "synchronize", _raise)
    assert debug.phase("x", chunk=0) is debug.phase("y") is debug.request("z")
    with debug.phase("x") as span:
        assert span is None and debug.current() is None
    _pooled(_items(3, (2, 1)), monkeypatch)
    cache = plan_graphs.GraphCache(_stand_in)
    cache.run((0, 4, 8), lambda: _buffers(4, 8), (torch.ones(3, 8, dtype=torch.int32),), 3, torch.device("cuda", 0),
              "plan")
    assert debug.spans() == [] and len(debug._ring) == 0


def test_timing_variable_turns_recording_on():
    code = "from lac_tpu_torch.utils import debug; print(debug.recording_on())"
    env = {k: v for k, v in os.environ.items() if k not in ("LAC_TPU_TIMING", "LAC_TPU_PROFILE")}
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    got = [subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          env=dict(env, **extra)).stdout.split() for extra in ({}, {"LAC_TPU_TIMING": "1"})]
    assert got == [["False"], ["True"]]


def test_a_running_profiler_turns_recording_on(unrecorded):
    """On every thread: the pipeline's dispatch threads and the finish
    workers do not inherit the profiler's thread-local state."""
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(30)
        with debug.phase("other thread"):
            pass
        done.set()

    thread = threading.Thread(target=worker)
    thread.start()  # before the profile starts
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert debug.recording_on()
        with debug.phase("inside", k=1):
            go.set()
            assert done.wait(30)
    thread.join(30)
    assert not thread.is_alive() and not debug.recording_on()
    with debug.phase("after"):
        pass
    assert sorted((s.name, s.attrs) for s in debug.spans()) == [("inside", {"k": 1}), ("other thread", {})]


def test_recording_switch_turns_recording_on(unrecorded):
    debug.recording(True)
    try:
        with debug.phase("a") as a, debug.phase("b") as b:
            assert debug.current() is b
    finally:
        debug.recording(False)
    got = debug.spans()
    assert [s.name for s in got] == ["b", "a"]  # closed innermost first
    assert b.parent == a.id and a.parent is None and a.t0 <= b.t0 <= b.t1 <= a.t1
    assert debug.spans(a.t1 + 1, a.t1 + 2) == [] and debug.spans(b.t0, b.t1) == got


def test_the_ring_is_bounded(recorded, monkeypatch):
    assert debug._ring.maxlen == debug.RING_SPANS
    monkeypatch.setattr(debug, "_ring", collections.deque(maxlen=8))
    for i in range(20):
        with debug.phase("s", i=i):
            pass
    assert [s.attrs["i"] for s in debug.spans()] == list(range(12, 20))


# ------------------------------------------------------------------ a pooled encode


def test_spans_link_the_dispatch_emitting_and_finish_threads(recorded, monkeypatch):
    got = _pooled(_items(5), monkeypatch)
    by_id = {s.id: s for s in got}
    (root,) = [s for s in got if s.name == "encode_pooled"]
    assert root.request == root.id and root.parent is None
    assert all(s.request == root.id for s in got)  # one request throughout
    for s in got:  # every parent is a span of this request
        if s is not root:
            assert s.parent in by_id, s
    names = collections.Counter(s.name for s in got)
    for name in ("pool_prepare", "pool_wave", "wave_views", "plane_upload", "analyze", "analyze_wait",
                 "flags_fetch", "host_ld", "plan_dispatch", "plan_wait", "meta_fetch", "emit_prep", "native_emit",
                 "pool_finish", "validate", "stereo_estimate", "lane_build", "host_plan", "assembly", "replay"):
        assert names[name], name
    assert names["pool_prepare"] == 1 and names["pool_finish"] == 3

    (wave,) = [s for s in got if s.name == "pool_wave"]
    threads = collections.defaultdict(set)
    for s in got:
        threads[s.name].add(s.thread)
    dispatch = {t for t in threads["analyze"]}
    assert len(dispatch) == 1 and next(iter(dispatch)).startswith("lac-dispatch-0-")
    emits = {s.thread for s in got if s.name == "native_emit" and "chunk" in s.attrs}
    assert threads["plan_wait"] == emits == {root.thread}  # the emitting thread: the caller's
    finishers = threads["pool_finish"]
    assert root.thread not in finishers  # three items: a worker pool
    for s in got:
        if s.name == "pool_finish":
            assert s.parent == root.id
        if s.thread in dispatch and s.name != "replay":
            assert s.parent == wave.id, s  # adopted across the thread
        if s.name == "assembly":
            assert by_id[s.parent].name == "pool_finish" and s.thread in finishers

    stages = [s for s in got if "chunk" in s.attrs]
    chunks = {s.attrs["chunk"] for s in stages}
    assert chunks == set(range(len(chunks))) and len(chunks) == 5  # 9 full blocks at 2 a chunk
    assert {s.attrs["card"] for s in stages} == {"cpu"}
    for s in got:
        if s.name == "replay":
            assert by_id[s.parent].name in ("analyze", "plan_dispatch")


@pytest.mark.parametrize("chunk, ladder", [(2, (64, 128, 256)), (4, (4, 8))])
def test_replay_spans_give_the_plan_batches(recorded, monkeypatch, chunk, ladder):
    """Per chunk, in order: one analyze at K rows (the chunk's blocks
    real), the full-width batches of ``plan_batches`` (doubled where 2K is
    a ladder width) and the probe batches of 12 K rows."""
    monkeypatch.setattr(device_pipeline, "CHUNK_LADDER", ladder)
    finished = {}
    real_finish = device_pipeline._ChunkJob.finish

    def finish(job):
        out = real_finish(job)
        finished[job.index] = (job.kc, job.pipe.K, sum(job.un) if job.un is not None else 0)
        return out

    monkeypatch.setattr(device_pipeline._ChunkJob, "finish", finish)
    got = _pooled(_items(7, (5, 4)), monkeypatch, chunk=chunk)
    by_id = {s.id: s for s in got}
    per_chunk = collections.defaultdict(list)
    for s in got:
        if s.name == "replay":
            per_chunk[by_id[s.parent].attrs["chunk"]].append((s.attrs["kind"], s.attrs["rows"], s.attrs["real"],
                                                              s.attrs["n"]))
    assert sorted(per_chunk) == sorted(finished)
    probes = 0
    for c, (kc, K, un) in finished.items():
        want = [("analyze", K, kc, N)]
        want += [("plan", bp, nsub, N) for _, nsub, bp in device_pipeline.plan_batches(2 * kc + 2 * un, K)]
        want += [("plan", 12 * K, min(12 * K, 12 * un - lo), 256) for lo in range(0, 12 * un, 12 * K)]
        assert per_chunk[c] == want, c
        probes += un
    assert probes > 0  # the probe plans ran
    if ladder == (4, 8):
        assert any(rows == 8 for kind, rows, _, n in sum(per_chunk.values(), []) if kind == "plan" and n == N)


@pytest.mark.parametrize("depth", [16, 24])
def test_meta_fetch_spans_carry_the_plans_tally(recorded, monkeypatch, depth):
    """Each chunk's ``meta_fetch`` spans, one for its full-width plans and
    one for its probe plans, carry the tally of their batches: ``parts``,
    every part kernel 10 summed (510 a full-width row, orders 1..8; 14 a
    probe row, orders 1..3), and ``wide``, those whose codes reach 2^31:
    none at 16 bits, some in loud 24-bit blocks."""
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 2)
    rng = np.random.RandomState(depth)
    items = _items(depth, (2, 3))
    if depth == 24:  # noise near full scale: residual codes about 2^24
        items[1] = tuple(rng.randint(-(1 << 23), 1 << 23, len(x)).astype(np.int32) for x in items[1])
    pool.encode_pooled(items, 96000 if depth == 24 else 44100, depth, device="cpu")
    fetches = [s for s in debug.spans() if s.name == "meta_fetch"]
    assert fetches and all({"chunk", "card", "wide", "parts"} <= set(s.attrs) for s in fetches)
    by_chunk = collections.defaultdict(list)
    for s in fetches:
        by_chunk[s.attrs["chunk"]].append(s)
    assert sorted(by_chunk) == [0, 1, 2]
    probes = 0
    for spans in by_chunk.values():
        full, *probe = spans
        assert full.attrs["parts"] > 0 and full.attrs["parts"] % 510 == 0
        for s in probe:
            assert s.attrs["parts"] > 0 and s.attrs["parts"] % 14 == 0
            probes += 1
        assert all(0 <= s.attrs["wide"] <= s.attrs["parts"] for s in spans)
    wide = sum(s.attrs["wide"] for s in fetches)
    assert wide == 0 if depth == 16 else wide > 0
    assert probes > 0  # the probe plans ran and were tallied apart


# ------------------------------------------------------------------ replays on a card


class _Event:
    made = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done, self.at = False, None
        _Event.made.append(self)

    def record(self):
        self.at = len(_Event.made)

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return 2.5


def _stand_in(static, *key):
    out = (static.pcm.sum(1),)
    return plan_graphs.Captured(lambda: None, out, {})


def _buffers(rows, n):
    return plan_graphs.Buffers([("pcm", (rows, n), torch.int32, 0)], "cpu")


def test_a_card_replay_holds_timing_events_read_lazily(recorded, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made = []
    cache = plan_graphs.GraphCache(_stand_in)
    out = cache.run((0, 4, 8), lambda: _buffers(4, 8), (torch.ones(3, 8, dtype=torch.int32),), 3,
                    torch.device("cuda", 0), "analyze")
    assert out[0].tolist() == [8, 8, 8]
    (span,) = debug.spans()
    assert span.attrs == {"kind": "analyze", "rows": 4, "real": 3, "n": 8}
    assert len(_Event.made) == 2 and all(e.at is not None for e in _Event.made)
    assert span.device_ms is None and span.events is not None  # pending: not waited for, read again later
    for e in _Event.made:
        e.done = True
    (span,) = debug.spans()
    assert span.device_ms == 2.5 and span.events is None
    # a CPU replay has no events
    cache.run((0, 4, 8), lambda: _buffers(4, 8), (torch.ones(2, 8, dtype=torch.int32),), 2, torch.device("cpu"), "plan")
    assert len(_Event.made) == 2 and debug.spans()[-1].attrs["real"] == 2


def test_timing_line_gives_the_replays_device_time(recorded, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(debug, "_TIMING", True)
    _Event.made = []
    debug.timing_reset()
    cache = plan_graphs.GraphCache(_stand_in)
    with debug.phase("plan_dispatch"):
        for kind in ("plan", "analyze", "lags"):
            cache.run((0, 4, 8), lambda: _buffers(4, 8), (torch.ones(3, 8, dtype=torch.int32),), 3,
                      torch.device("cuda", 0), kind)
    for e in _Event.made:
        e.done = True
    sums = debug._phase_sums()
    assert set(sums) == {"plan_dispatch", "plan_device", "analyze_device"}
    assert sums["plan_device"] == pytest.approx(2.5e-3) and sums["analyze_device"] == pytest.approx(2.5e-3)
    debug.timing_report("label")
    line = capsys.readouterr().err
    assert "plan_device=0.00s" in line and "still on the card" not in line


def test_timing_line_counts_replays_still_on_the_card(recorded, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(debug, "_TIMING", True)
    _Event.made = []
    debug.timing_reset()
    cache = plan_graphs.GraphCache(_stand_in)
    with debug.phase("plan_dispatch"):
        for kind in ("plan", "plan", "analyze", "lags"):
            cache.run((0, 4, 8), lambda: _buffers(4, 8), (torch.ones(3, 8, dtype=torch.int32),), 3,
                      torch.device("cuda", 0), kind)
    for e in _Event.made[:2]:  # the first plan replay has run; the others are pending
        e.done = True
    assert set(debug._phase_sums()) == {"plan_dispatch", "plan_device"}
    debug.timing_report("label")
    line = capsys.readouterr().err.strip()
    assert line.startswith("[lac-timing] label: ") and line.endswith("; 2 replays still on the card)"), line


def test_only_a_span_that_asks_reads_thread_cpu(recorded, monkeypatch):
    reads = []
    monkeypatch.setattr(debug, "time", types.SimpleNamespace(
        perf_counter=time.perf_counter, thread_time_ns=lambda: reads.append(1) or time.thread_time_ns()))
    with debug.phase("plain") as plain, debug.request("req") as req:
        pass
    assert reads == [] and plain.cpu_s is None and req.cpu_s is None
    with debug.phase("counted", cpu=True, item=3) as counted:
        sum(range(20000))
    assert len(reads) == 2 and counted.cpu_s >= 0 and counted.attrs == {"item": 3}
    got = _pooled(_items(11, (2, 1)), monkeypatch)
    assert {s.name for s in got if s.cpu_s is not None and s.id > counted.id} == {"pool_finish"}


# ------------------------------------------------------------------ the benchmark's readers


def test_each_new_reader_reads_a_cpu_run(recorded, monkeypatch):
    import copy

    from benchmark import run, spec

    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 2)
    bench = copy.deepcopy(spec.load())
    for m in bench["per_layer"]:
        if m["name"] in NEW_METRICS:
            assert m["workloads"] == ["cd16.pooled_tracks", "hires24.pooled_tracks"] and m["moves"] == "encode_MBps"
    mix = spec.mix("pooled_tracks")
    mix.update(track_s=[1.2, 1.6], batch_blocks=8, distinct_batches=2,
               judge={"batches": 2, "wave_blocks": 4096, "chunk_blocks": 2, "per_stereo": 2})
    records = []
    make = run.Record
    monkeypatch.setattr(run, "Record", lambda **kw: records.append(make(**kw)) or records[-1])
    res, _ = run.run_cell(bench, spec.workload(bench, "cd16.pooled_tracks"), 2**31 + 5, 1.0, False, device="cpu",
                          mix=mix)
    assert res["correct"]
    (rec,) = records
    got = {name: spec.reader(name).read(rec) for name in NEW_METRICS}
    for name, value in got.items():
        assert value is not None and 0 <= value <= 100, (name, value)
