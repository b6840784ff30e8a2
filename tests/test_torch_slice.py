"""The port's full-block encode path end to end on the CPU.

``lac_tpu_torch.encoder.FrameEncoder(device="cpu")`` runs the plane
pipeline with torch CPU tensors (kernels take their plain versions) and
must write the same bytes as ``lac_tpu``'s FrameEncoder under
``xp=jax.numpy`` (its own plane pipeline) and ``xp=numpy`` (host
planner). The port's CLI must match ``lac_tpu.cli``; importing and
running the port must not import JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import lac_tpu_torch  # noqa: E402
from lac_tpu import cli as ref_cli  # noqa: E402
from lac_tpu.decoder import FrameDecoder  # noqa: E402
from lac_tpu.encoder import FrameEncoder as RefEncoder  # noqa: E402
from lac_tpu.io import write_wav  # noqa: E402
from lac_tpu_torch import cli, device_pipeline  # noqa: E402
from lac_tpu_torch.encoder import FrameEncoder  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16384


def _gliding(frames, depth=16, seed=0xC0DEC):
    """Music-like gliding sines under an envelope: certain-LR,
    certain-MS and uncertain (probe-resolved) blocks all occur."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames, dtype=np.float64) / 44100
    sig = np.zeros(frames)
    for f0, f1, amp in ((220, 440, 0.3), (880, 860, 0.2), (3520, 3300, 0.08)):
        sig += amp * np.sin(2 * np.pi * np.cumsum(np.linspace(f0, f1, frames)) / 44100)
    noise = rng.standard_normal(frames)
    for _ in range(2):
        noise = 0.5 * noise + 0.5 * np.concatenate([[0.0], noise[:-1]])
    sig += 0.05 * noise
    env = 0.5 * (1 + np.sin(2 * np.pi * 0.37 * t))
    scale, lim = (1, 1 << 15) if depth == 16 else (256, 1 << 23)
    left = np.clip(sig * env * 28000 * scale, -lim, lim - 1).astype(np.int32)
    right = np.clip(np.roll(sig, 7) * env * 26500 * scale, -lim, lim - 1).astype(np.int32)
    return left, right


@pytest.fixture
def small_chunks(monkeypatch):
    """Chunk width 4: 9 full blocks make three chunks, so the sliding
    window, several plan batches and several probe batches all run."""
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 4)


def _all_three(mode, depth, left, right=()):
    port = FrameEncoder(12, mode, 44100, depth, device="cpu").encode(left, right)
    jax_bytes = RefEncoder(12, mode, 44100, depth, xp=jnp).encode(left, right)
    np_bytes = RefEncoder(12, mode, 44100, depth, xp=np).encode(left, right)
    return port, jax_bytes, np_bytes


def test_auto_stereo_with_tail(small_chunks):
    left, right = _gliding(N * 9 + 5000)
    from lac_tpu_torch.ops.stereo import estimate_stereo_mode

    lm = torch.from_numpy(left[: 9 * N].reshape(9, N))
    _, un = estimate_stereo_mode(lm, torch.from_numpy(right[: 9 * N].reshape(9, N)), torch.ones_like(lm, dtype=torch.bool))
    assert 0 < int(un.sum()) < 9, "corpus regressed: want a mix of certain/uncertain blocks"
    port, jax_bytes, np_bytes = _all_three(2, 16, left, right)
    assert port == jax_bytes == np_bytes
    dl, dr, _ = FrameDecoder().decode(port)
    assert np.array_equal(dl, left) and np.array_equal(dr, right)


@pytest.mark.parametrize("kind", ["lr", "ms", "mono"])
def test_forced_modes_and_mono(small_chunks, kind):
    left, right = _gliding(N * 9 + 77, seed=4)
    mode = {"lr": 0, "ms": 1, "mono": 0}[kind]
    args = (left,) if kind == "mono" else (left, right)
    port, jax_bytes, np_bytes = _all_three(mode, 16, *args)
    assert port == jax_bytes == np_bytes


def test_24bit_auto(small_chunks):
    left, right = _gliding(N * 8 + 100, depth=24, seed=5)
    port, jax_bytes, np_bytes = _all_three(2, 24, left, right)
    assert port == jax_bytes == np_bytes


def test_doubled_plan_batches(monkeypatch):
    """Where 2K is a ladder width, one plan batch holds two chunks' worth
    of lanes; bytes do not depend on batching."""
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 4)
    monkeypatch.setattr(device_pipeline, "CHUNK_LADDER", (4, 8))
    assert list(device_pipeline.plan_batches(10, 4)) == [(0, 8, 8), (8, 2, 4)]
    left, right = _gliding(N * 8 + 900, seed=6)
    port = FrameEncoder(12, 2, 44100, 16, device="cpu").encode(left, right)
    assert port == RefEncoder(12, 2, 44100, 16, xp=np).encode(left, right)


def test_short_input_is_planned_on_the_host():
    """Below MIN_FULL_BLOCKS full blocks the plane pipeline does not run
    and the port's host route plans every block (the JAX package's
    small-file device planner is not ported yet)."""
    left, right = _gliding(N * 2 + 999, seed=7)
    assert not device_pipeline.applicable(len(left) // N)
    port = FrameEncoder(12, 2, 44100, 16, device="cpu").encode(left, right)
    assert port == RefEncoder(12, 2, 44100, 16, xp=np).encode(left, right)


def test_cli_matches_lac_tpu_cli(tmp_path, capsys, small_chunks):
    left, right = _gliding(N * 8 + 321, seed=8)
    wav = str(tmp_path / "in.wav")
    out = str(tmp_path / "out.lac")
    assert write_wav(wav, left, right, 2, 44100, 16)
    for argv in (["encode", wav, out], ["encode", wav, out, "--stereo-mode=ms", "--threads=2"]):
        assert ref_cli.main(argv) == 0
        want_msg = capsys.readouterr()
        with open(out, "rb") as f:
            want = f.read()
        os.remove(out)
        assert cli.main(argv, device="cpu") == 0
        got_msg = capsys.readouterr()
        with open(out, "rb") as f:
            assert f.read() == want
        assert got_msg.out == want_msg.out and got_msg.out.startswith("Encoded ")
    back = str(tmp_path / "back.wav")
    assert cli.main(["decode", out, back], device="cpu") == 0
    assert cli.main(["encode", wav], device="cpu") == 1  # usage error, as lac_tpu.cli
    assert cli.main(["encode", wav, out, "--bogus"], device="cpu") == 1
    assert cli.main(["encode", str(tmp_path / "missing.wav"), out], device="cpu") == 1
    assert "Failed to read WAV" in capsys.readouterr().err


def test_port_never_imports_jax():
    code = (
        "import sys, numpy as np\n"
        "import lac_tpu_torch, lac_tpu_torch.cli, lac_tpu_torch.device_pipeline\n"
        "from lac_tpu_torch.encoder import FrameEncoder\n"
        "rng = np.random.RandomState(0)\n"
        "x = (np.sin(np.arange(16384 * 8 + 10) / 5.0) * 9000).astype(np.int32)\n"
        "y = (x // 2 + rng.randint(-50, 50, x.size)).astype(np.int32)\n"
        "assert len(FrameEncoder(12, 2, 44100, 16, device='cpu').encode(x, y)) > 0\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py covers the card")
    with pytest.raises(RuntimeError, match="cuda"):
        FrameEncoder(device="cuda")
    with pytest.raises(ValueError):
        lac_tpu_torch.resolve_device("meta")
