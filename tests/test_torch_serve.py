"""The port's warm-process service (``lac_tpu_torch.serve``) on the CPU.

The same job script, over the same WAVs made from seeds, goes through
``lac_tpu.serve.serve`` (numpy backend) and the port's ``serve`` on
``device="cpu"`` (plain kernel versions, a pinned small chunk width):
responses equal by id except ``ms``, output files byte-identical, decodes
equal to the input. The batcher's scheduling contract, the watchdog
without a host fallback and the repair of its two races run against
fake waves. Tolerance: none.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from io import StringIO

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu import serve as ref_serve  # noqa: E402
from lac_tpu.io import read_wav, write_wav  # noqa: E402
from lac_tpu_torch import cli, device_pipeline  # noqa: E402
from lac_tpu_torch import pool as port_pool  # noqa: E402
from lac_tpu_torch import serve as port_serve  # noqa: E402

B = 16384
REPO = pathlib.Path(__file__).resolve().parent.parent


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


def _stereo(frames, seed, depth=16):
    """Stereo content that changes character from block to block, so waves hit MS, LR and the
    uncertain-block probe plans."""
    rng = np.random.RandomState(seed)
    scale = 1 if depth == 16 else 200
    lim = 1 << (depth - 1)
    t = np.arange(frames, dtype=np.float64)
    left = (9000 * scale * np.sin(2 * np.pi * 440 * t / 44100)).astype(np.int64)
    left += rng.randint(-2000 * scale, 2000 * scale, frames)
    right = np.empty(frames, np.int64)
    for b0 in range(0, frames, B):
        b1 = min(b0 + B, frames)
        noise = rng.randint(-100 * scale, 100 * scale, b1 - b0)
        right[b0:b1] = (left[b0:b1] // 2 if (b0 // B) % 2 == 0 else -left[b0:b1] // 3) + noise * ((b0 // B) % 3 + 1)
    return np.clip(left, -lim, lim - 1).astype(np.int32), np.clip(right, -lim, lim - 1).astype(np.int32)


# name -> (frames, channels, sample rate, depth, encode flags)
FILES = {
    "ms": (2 * B + 500, 2, 44100, 16, ["--stereo-mode=ms"]),
    "mono": (B + B // 2, 1, 48000, 16, []),
    "hires": (B + 901, 2, 96000, 24, ["--no-partitioning"]),
    "eight": (8 * B + 3000, 2, 44100, 16, ["--threads=2"]),
    "short": (5000, 2, 44100, 16, []),
}


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    (root / "in").mkdir()
    for seed, (name, (frames, ch, sr, depth, _flags)) in enumerate(FILES.items(), 40):
        left, right = _stereo(frames, seed, depth)
        assert write_wav(str(root / "in" / f"{name}.wav"), left, right if ch == 2 else np.empty(0, np.int32),
                         ch, sr, depth)
    return root


def _script():
    lines = ["ping"]
    for name, (*_, flags) in FILES.items():
        lines.append(" ".join(["encode", f"../in/{name}.wav", f"{name}.lac", *flags]))
        if name == "mono":
            lines += ["# a comment takes no id", ""]
    lines += ["encode ../in/missing.wav missing.lac", "frobnicate a b", "encode ../in/ms.wav",
              'encode "../in/ms.wav ms2.lac', "warm 1", "wait"]
    lines += [f"decode {name}.lac {name}-back.wav" for name in FILES]
    lines += ["wait", "ping"]  # EOF without quit
    return "".join(line + "\n" for line in lines)


def _run(fn, run_dir, monkeypatch, argv, **kwargs):
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    out = StringIO()
    assert fn(argv, stdin=StringIO(_script()), stdout=out, **kwargs) == 0
    lines = out.getvalue().splitlines()
    res = [json.loads(line) for line in lines]
    by_id = {r["id"]: r for r in res}
    assert len(by_id) == len(res), "an id was answered twice"
    return by_id


@pytest.mark.parametrize("workers", [1, 3])
def test_serve_matches_lac_tpu(wav_dir, monkeypatch, workers):
    """Responses (all but ``ms``), output bytes and decodes equal ``lac_tpu.serve``'s."""
    monkeypatch.setenv("LAC_TPU_BACKEND", "numpy")
    tag = f"w{workers}"
    argv = [f"--workers={workers}"]
    want = _run(ref_serve.serve, wav_dir / f"ref-{tag}", monkeypatch, argv)
    waves, run_wave = [], port_pool.run_group_wave

    def counted(group, *args, **kwargs):
        waves.append(os.path.basename(group[0].in_path))
        return run_wave(group, *args, **kwargs)

    monkeypatch.setattr(port_pool, "run_group_wave", counted)
    got = _run(port_serve.serve, wav_dir / f"port-{tag}", monkeypatch, argv, device="cpu")
    # pooled with several workers: one wave per key (the file without a full block takes the CLI)
    assert sorted(waves) == ([] if workers == 1 else ["eight.wav", "hires.wav", "mono.wav", "ms.wav"])
    assert sorted(got) == sorted(want) == list(range(1, len(want) + 1))

    def strip(r):
        return {k: v for k, v in r.items() if k != "ms"}

    for i in want:
        assert strip(got[i]) == strip(want[i]), f"response {i}"
    kinds = [r.get("message", r.get("error", "")) for r in got.values()]
    assert sum(k.startswith("Encoded ") for k in kinds) == len(FILES)
    assert sum(k.startswith("Decoded ") for k in kinds) == len(FILES)
    assert any(r.get("error") == "Failed to read WAV: ../in/missing.wav" for r in got.values())
    assert any(r.get("error") == "unknown command: frobnicate" for r in got.values())
    assert any(r.get("error") == "usage: encode <in> <out> [flags...]" for r in got.values())
    assert any(r.get("error", "").startswith("bad line: ") for r in got.values())
    warm = [r for r in got.values() if "warmed_blocks" in r]
    assert len(warm) == 1 and warm[0]["bytes"] > 0
    for name in FILES:
        port_dir, ref_dir = wav_dir / f"port-{tag}", wav_dir / f"ref-{tag}"
        assert (port_dir / f"{name}.lac").read_bytes() == (ref_dir / f"{name}.lac").read_bytes(), name
        back, src = read_wav(str(port_dir / f"{name}-back.wav")), read_wav(str(wav_dir / "in" / f"{name}.wav"))
        assert all(np.array_equal(a, b) for a, b in zip(back[:2], src[:2])) and back[2:] == src[2:], name
    assert not (wav_dir / f"port-{tag}" / "missing.lac").exists()


# ------------------------------------------------------------ the batcher against fake waves


def _fake_prepare(parts):
    if parts[1] == "fallback.wav":
        return None
    return port_pool.PreparedEncode(parts=list(parts), in_path=parts[1], wav=None, kind="auto", nfull=1,
                                    dt=np.int16, key=("auto", "<i2", True))


class _Responses:
    def __init__(self):
        self.lock = threading.Lock()
        self.items = []

    def __call__(self, obj):
        with self.lock:
            self.items.append(dict(obj))

    def snapshot(self):
        with self.lock:
            return list(self.items)

    def wait_for(self, n, timeout=10.0):
        end = time.perf_counter() + timeout
        while time.perf_counter() < end:
            if len(self.snapshot()) >= n:
                return True
            time.sleep(0.01)
        return False


def _until(pred, timeout=10.0):
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if pred():
            return True
        time.sleep(0.01)
    return False


def test_batcher_requeue_fallback_and_drain(monkeypatch):
    """A drained batch whose pooled blocks pass ``pool._MAX_WAVE_BLOCKS`` is split across loop
    passes in order; jobs that cannot pool take the per-job path; every job is answered once;
    ``drain()`` returns only after the responses are on the wire."""
    monkeypatch.setattr(port_pool, "_MAX_WAVE_BLOCKS", 2)
    gate = threading.Event()  # holds wave 0 so later submits pile up
    waves_run = []

    def fake_wave(group, file_done, device):
        assert device == "cpu"
        if not waves_run:
            gate.wait(timeout=60)
        waves_run.append([g.in_path for g in group])
        for i in range(len(group)):
            file_done(i, ({}, {}, {}))

    monkeypatch.setattr(port_pool, "prepare_encode_job", _fake_prepare)
    monkeypatch.setattr(port_pool, "run_group_wave", fake_wave)
    monkeypatch.setattr(port_serve, "run_job", lambda argv, device: (0, f"Encoded {argv[1]}", ""))
    responses = _Responses()

    def handle(job_id, parts):
        responses({"id": job_id, "ok": True, "message": "fallback"})

    pool = ThreadPoolExecutor(2)
    b = port_serve._PoolBatcher(pool, handle, responses, device="cpu")
    try:
        b.submit(1, ["encode", "w1.wav", "o1"])
        assert _until(lambda: b._wave_snapshot()[1] is not None)  # the batcher is inside wave 0
        for jid, path in ((2, "w2.wav"), (3, "w3.wav"), (4, "fallback.wav"), (5, "w5.wav"), (6, "w6.wav"),
                          (7, "w7.wav")):
            b.submit(jid, ["encode", path, f"o{jid}"])
        gate.set()
        assert b.drain() == 7
        got = responses.snapshot()
        assert sorted(r["id"] for r in got) == [1, 2, 3, 4, 5, 6, 7]
        assert waves_run == [["w1.wav"], ["w2.wav", "w3.wav"], ["w5.wav", "w6.wav"], ["w7.wav"]]
        assert [r["id"] for r in got if r["message"] == "fallback"] == [4]
        assert b.wave_failures == 0
    finally:
        gate.set()
        b.close()
        pool.shutdown(wait=True)


def test_batcher_failed_wave_runs_its_unreleased_files_one_by_one_and_says_so(monkeypatch, capsys):
    def failing_wave(group, file_done, device):
        file_done(0, ({}, {}, {}))
        raise RuntimeError("wave broke\nsecond line")

    monkeypatch.setattr(port_pool, "prepare_encode_job", _fake_prepare)
    monkeypatch.setattr(port_pool, "run_group_wave", failing_wave)
    monkeypatch.setattr(port_serve, "run_job", lambda argv, device: (0, f"Encoded {argv[1]}", ""))
    responses = _Responses()
    pool = ThreadPoolExecutor(2)
    b = port_serve._PoolBatcher(pool, lambda job_id, parts: responses({"id": job_id, "message": "per-job"}),
                                responses, device="cpu")
    try:
        with b.cv:  # one batch of three
            for jid in (1, 2, 3):
                b.busy += 1
                b.fenced += 1
                b.pending.append((jid, ["encode", f"w{jid}.wav", f"o{jid}"], time.perf_counter()))
            b.cv.notify_all()
        assert b.drain() == 3
        got = {r["id"]: r["message"] for r in responses.snapshot()}
        assert got == {1: "Encoded w1.wav", 2: "per-job", 3: "per-job"}
        assert b.wave_failures == 1
    finally:
        b.close()
        pool.shutdown(wait=True)
    err = capsys.readouterr().err
    assert "pooled wave of 3 files failed (RuntimeError: wave broke second line)" in err


def _wedged_batcher(monkeypatch, timeout):
    """A batcher whose waves block on their gate (one per wave, in order); finished jobs answer
    "pooled", per-job ones "per-job" (never expected)."""
    monkeypatch.setenv("LAC_TPU_SERVE_DEVICE_TIMEOUT_S", timeout)
    gates, late_done = [threading.Event() for _ in range(4)], []
    waves = []

    def wedged_wave(group, file_done, device):
        gate = gates[len(waves)]
        waves.append([g.in_path for g in group])
        gate.wait(timeout=60)
        for i in range(len(group)):
            file_done(i, ({}, {}, {}))
            late_done.append(group[i].in_path)

    monkeypatch.setattr(port_pool, "prepare_encode_job", _fake_prepare)
    monkeypatch.setattr(port_pool, "run_group_wave", wedged_wave)
    monkeypatch.setattr(port_serve, "run_job", lambda argv, device: (0, "pooled", ""))
    responses = _Responses()
    per_job = []

    def handle(job_id, parts):
        per_job.append(job_id)
        responses({"id": job_id, "ok": True, "message": "per-job"})

    pool = ThreadPoolExecutor(2)
    return port_serve._PoolBatcher(pool, handle, responses, device="cpu"), pool, gates, waves, late_done, \
        responses, per_job


def test_batcher_watchdog_answers_without_running_anything(monkeypatch):
    """A wave past the deadline marks the card sick: its jobs, the ones queued behind it and every
    later encode are answered once with the sick error and none runs (no per-job reroute, no host
    fallback); the stuck wave's late completions are suppressed; the worker pool still serves
    other jobs (decode); ``close()`` returns."""
    b, pool, gates, waves, late_done, responses, per_job = _wedged_batcher(monkeypatch, "0.3")
    try:
        b.submit(1, ["encode", "w1.wav", "o1"])
        assert _until(lambda: b._wave_snapshot()[1] is not None)
        b.submit(2, ["encode", "w2.wav", "o2"])  # queued behind the stuck wave
        b.submit(3, ["encode", "w3.wav", "o3"])
        assert responses.wait_for(3)
        assert b.device_sick
        b.submit(4, ["encode", "w4.wav", "o4"])  # sick: answered at once
        assert b.drain() == 4
        got = responses.snapshot()
        assert sorted(r["id"] for r in got) == [1, 2, 3, 4]
        for r in got:
            assert r["ok"] is False and r["rc"] == 1 and r["ms"] >= 0
            assert r["error"].startswith("device wave exceeded 0.3s; ")
        assert per_job == [] and waves == [["w1.wav"]]
        assert pool.submit(lambda: "decoded").result(timeout=10) == "decoded"
        gates[0].set()  # the wedge clears: the late completion must not answer job 1 again
        assert _until(lambda: late_done == ["w1.wav"])
        time.sleep(0.1)
        assert len(responses.snapshot()) == 4
        t0 = time.perf_counter()
        b.close()
        assert time.perf_counter() - t0 < 10.0
    finally:
        for g in gates:
            g.set()
        b.close()
        pool.shutdown(wait=True)


def test_watchdog_race_a_wave_that_ended_at_its_deadline_is_not_stuck(monkeypatch):
    """The monitor's snapshot is of wave 1; wave 1 ends and wave 2 begins before the check at
    wave 1's deadline: the card is not marked sick and wave 2's job is not answered. The same
    check on wave 2's own snapshot past its deadline does mark it."""
    b, pool, gates, waves, _late, responses, per_job = _wedged_batcher(monkeypatch, "1000")
    try:
        b.submit(1, ["encode", "w1.wav", "o1"])
        assert _until(lambda: b._wave_snapshot()[1] is not None)
        snap1 = b._wave_snapshot()
        gates[0].set()
        assert responses.wait_for(1)
        b.submit(2, ["encode", "w2.wav", "o2"])
        assert _until(lambda: b._wave_snapshot()[0] == snap1[0] + 1 and b._wave_snapshot()[1] is not None)
        assert not b._check_deadline(snap1[1] + b.device_timeout + 0.5, snap1)
        assert not b.device_sick
        assert [r["id"] for r in responses.snapshot()] == [1]
        snap2 = b._wave_snapshot()
        assert not b._check_deadline(snap2[1] + b.device_timeout - 0.5, snap2)
        assert b._check_deadline(snap2[1] + b.device_timeout + 0.5, snap2)
        assert b.device_sick and b.drain() == 2
        got = responses.snapshot()
        assert got[0]["message"] == "pooled" and got[1]["id"] == 2 and got[1]["error"].startswith("device wave")
        assert per_job == []
    finally:
        for g in gates:
            g.set()
        b.close()
        pool.shutdown(wait=True)


def test_watchdog_race_a_rescue_after_pool_shutdown_still_answers(monkeypatch):
    """The worker pool is shut down (the service is closing) while a wave is stuck: the rescue
    answers the stuck jobs itself and submits nothing to the pool."""
    b, pool, gates, _waves, _late, responses, per_job = _wedged_batcher(monkeypatch, "1000")
    try:
        b.submit(1, ["encode", "w1.wav", "o1"])
        assert _until(lambda: b._wave_snapshot()[1] is not None)
        pool.shutdown(wait=True)
        with pytest.raises(RuntimeError):
            pool.submit(print)
        assert b._check_deadline(b._wave_snapshot()[1] + b.device_timeout + 0.5)
        assert b.drain() == 1
        got = responses.snapshot()
        assert [r["id"] for r in got] == [1] and got[0]["error"].startswith("device wave exceeded 1000s")
        assert per_job == []
    finally:
        for g in gates:
            g.set()
        b.close()


def test_serve_watchdog_keeps_decode_ping_and_wait(wav_dir, monkeypatch):
    """In the service: a stuck wave's job and the one queued behind it are answered with the
    sick error, a later encode too, no output is written; decode, ping and wait are served and
    the service exits at EOF although the wave is still stuck."""
    monkeypatch.setenv("LAC_TPU_SERVE_DEVICE_TIMEOUT_S", "0.3")
    wedged, gate = threading.Event(), threading.Event()
    ran = []

    def stuck_wave(group, file_done, device):
        wedged.set()
        gate.wait(timeout=60)
        for i in range(len(group)):
            file_done(i, ({}, {}, {}))

    run_dir = wav_dir / "watchdog"
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    assert cli.main(["encode", "../in/ms.wav", "ms.lac"], device="cpu") == 0
    monkeypatch.setattr(port_pool, "run_group_wave", stuck_wave)
    real_run_job = port_serve.run_job

    def recorded(argv, device):
        ran.append(argv[0])
        return real_run_job(argv, device)

    monkeypatch.setattr(port_serve, "run_job", recorded)

    def lines():
        yield "encode ../in/eight.wav a.lac\n"
        assert wedged.wait(10)
        yield "encode ../in/ms.wav b.lac\n"
        yield "wait\n"
        yield "encode ../in/mono.wav c.lac\n"
        yield "decode ms.lac back.wav\n"
        yield "wait\n"
        yield "ping\n"

    out = StringIO()
    t0 = time.perf_counter()
    try:
        assert port_serve.serve(["--workers=2"], stdin=lines(), stdout=out, device="cpu") == 0
        assert time.perf_counter() - t0 < 30.0
        res = {r["id"]: r for r in map(json.loads, out.getvalue().splitlines())}
        assert sorted(res) == [1, 2, 3, 4, 5, 6, 7]
        for i in (1, 2, 4):
            assert res[i]["rc"] == 1 and res[i]["error"].startswith("device wave exceeded 0.3s; ")
        assert res[3] == {"id": 3, "ok": True, "drained": 2}
        assert res[5]["ok"] and res[5]["message"].startswith("Decoded ms.lac -> back.wav")
        assert res[6] == {"id": 6, "ok": True, "drained": 2}
        assert res[7] == {"id": 7, "ok": True, "pong": True}
        assert ran == ["decode"]
        assert not any((run_dir / f).exists() for f in ("a.lac", "b.lac", "c.lac"))
    finally:
        gate.set()


# ------------------------------------------------------------ no card, library use, a real process


@pytest.mark.parametrize("workers", [1, 2])
def test_without_a_card_encodes_fail_as_the_cli_does_and_decode_runs(wav_dir, monkeypatch, workers):
    run_dir = wav_dir / f"nocard-{workers}"
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    assert cli.main(["encode", "../in/mono.wav", "mono.lac"], device="cpu") == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    script = "encode ../in/eight.wav e.lac\nencode ../in/short.wav s.lac\nwarm 1\nwait\ndecode mono.lac back.wav\n"
    out = StringIO()
    assert port_serve.serve([f"--workers={workers}", "--warm=1"], stdin=StringIO(script), stdout=out) == 0
    res = {r["id"]: r for r in map(json.loads, out.getvalue().splitlines())}
    assert sorted(res) == [0, 1, 2, 3, 4, 5]
    for i in (0, 1, 2, 3):
        assert res[i]["ok"] is False and res[i]["rc"] == 1 and "torch.cuda.is_available() is False" in res[i]["error"]
    for i in (1, 2):
        assert res[i]["error"].startswith("Error: device 'cuda' requested")
    assert res[5]["ok"] and res[5]["message"].startswith("Decoded mono.lac")
    assert not (run_dir / "e.lac").exists() and not (run_dir / "s.lac").exists()


def test_run_job_library_capture():
    """run_job works outside the serve loop (plain redirect capture)."""
    rc, out, err = port_serve.run_job(["decode", "/nonexistent.lac", "/nonexistent.wav"], device="cpu")
    assert rc == 1 and "Failed to read LAC file" in err and out == ""


def test_warm_process_bytes_equal_lac_tpu(monkeypatch):
    monkeypatch.setenv("LAC_TPU_BACKEND", "numpy")
    assert port_serve.warm_process(1, device="cpu") == ref_serve.warm_process(1)


@pytest.mark.parametrize("argv", [["--workers=x"], ["--warm=y"], ["--bogus"]])
def test_bad_flags(argv, capsys):
    assert port_serve.serve(argv, stdin=StringIO(""), stdout=StringIO(), device="cpu") == 1
    err = capsys.readouterr().err
    assert ("Bad flag value" in err) if argv[0] != "--bogus" else err.startswith("Usage: python -m lac_tpu_torch.serve")


CHILD = """
import os, sys
from lac_tpu_torch import serve
real = serve.run_job

def noisy(argv, device):
    os.write(1, b"raw write to fd 1 from a job\\n")
    print("a print from a job")
    return real(argv, device)

serve.run_job = noisy
sys.exit(serve.serve(sys.argv[1:], device="cpu"))
"""


def test_a_process_keeps_fd1_for_responses_and_drains_on_sigterm(wav_dir):
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    out_dir = wav_dir / "child"
    out_dir.mkdir()
    p = subprocess.Popen([sys.executable, "-c", CHILD, "--workers=2"], stdin=subprocess.PIPE,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, bufsize=1, env=env, cwd=REPO)
    guard = threading.Timer(120, p.kill)  # a hung child must not hang the suite on readline()
    guard.start()
    try:
        for name in ("mono", "short"):
            p.stdin.write(f"encode {wav_dir / 'in' / (name + '.wav')} {out_dir / (name + '.lac')}\n")
        p.stdin.write("wait\nping\n")
        p.stdin.flush()
        first = [json.loads(p.stdout.readline()) for _ in range(4)]
        assert sorted(r["id"] for r in first) == [1, 2, 3, 4]
        assert all(r["ok"] for r in first), first
        p.send_signal(signal.SIGTERM)
        rest, err = p.communicate(timeout=60)
        assert p.returncode == 0, err
    finally:
        guard.cancel()
        if p.poll() is None:
            p.kill()
            p.wait()
    assert [json.loads(line) for line in rest.splitlines()] == []
    assert err.count("raw write to fd 1 from a job") == 2
    assert (out_dir / "mono.lac").stat().st_size > 0 and (out_dir / "short.lac").stat().st_size > 0
