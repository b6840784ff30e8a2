"""The port under ``LAC_TPU_NO_NATIVE=1`` (the JAX package's switch,
lac_tpu/runtime/native.py:68), after tests/test_no_native.py.

With the switch the port builds nothing: ``plan_group`` on tensors plans
every lane, its token codes (``emit_fields=True``) are packed in numpy,
the stereo proxy runs on tensors and the Python reader decodes. The
bytes must be the goldens' and the decodes PCM-exact. Without the
switch a failed native build still raises: the switch is an explicit
request, never a fallback.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu_torch import decoder, device_pipeline, pool  # noqa: E402
from lac_tpu_torch.encoder import FrameEncoder  # noqa: E402
from lac_tpu_torch.runtime import native  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"

_SCRIPT = r"""
import pathlib, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, str(pathlib.Path(sys.argv[1]) / "tests"))
from lac_tpu_torch.runtime import native
native.BUILD_DIR = pathlib.Path(sys.argv[3])  # an empty directory: nothing may be built into it
assert not native.native_available()
try:
    native.get_native()
    raise SystemExit("get_native() must refuse under LAC_TPU_NO_NATIVE=1")
except RuntimeError:
    pass
from lac_tpu_torch.decoder import FrameDecoder
from lac_tpu_torch.encoder import FrameEncoder
from signals import cases

golden_dir = pathlib.Path(sys.argv[2])
for name in sys.argv[4:]:
    left, right, sr, depth, smode = cases()[name]
    want = (golden_dir / f"{name}.lac").read_bytes()
    got = FrameEncoder(12, smode if len(right) else 0, sr, depth, device="cpu").encode(left, right)
    assert got == want, name
    dl, dr, _ = FrameDecoder().decode(got)
    assert np.array_equal(dl, left) and np.array_equal(dr, right), name
assert not any(native.BUILD_DIR.iterdir()), list(native.BUILD_DIR.iterdir())
assert "lac_tpu" not in sys.modules and "jax" not in sys.modules
print(f"no-native parity ok on {len(sys.argv) - 4} goldens")
"""


@pytest.mark.parametrize("names", [("sine-auto", "sparse", "noise24", "silence"), ("correlated", "multiblock")],
                         ids=["four-goldens", "full-blocks"])
def test_no_native_encodes_the_goldens_and_builds_nothing(tmp_path, names):
    """The four goldens of tests/test_no_native.py, and two with full
    blocks, whose 16384-sample lanes take the group route's device half
    (CPU tensors here)."""
    if not (GOLDEN / "sine-auto.lac").exists():
        pytest.skip("golden fixtures missing")
    build = tmp_path / "build"
    build.mkdir()
    env = {**os.environ, "LAC_TPU_NO_NATIVE": "1", "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(REPO), str(GOLDEN), str(build), *names],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert f"no-native parity ok on {len(names)} goldens" in r.stdout
    assert not any(build.iterdir())


def test_failed_build_raises_without_the_switch(monkeypatch, tmp_path):
    monkeypatch.delenv("LAC_TPU_NO_NATIVE", raising=False)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.get_native()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.native_available()


def test_the_switch_reaches_every_reader(monkeypatch):
    """The plane pipeline, pooling, the decoder's native backend and the
    thread collector each step aside under the switch."""
    monkeypatch.setenv("LAC_TPU_NO_NATIVE", "1")
    assert not native.native_available()
    assert not device_pipeline.applicable(1000)
    assert pool.prepare_encode_job(["encode", "/nonexistent.wav", "/tmp/out.lac"]) is None
    assert not decoder.FrameDecoder().native
    native.thread_collector_reset()
    assert native.thread_collector_count() == 0
    monkeypatch.delenv("LAC_TPU_NO_NATIVE")
    assert native.native_available() and device_pipeline.applicable(1000)
    assert decoder.FrameDecoder().native


def test_encode_pooled_without_native_encodes_each_item(monkeypatch):
    monkeypatch.setenv("LAC_TPU_NO_NATIVE", "1")
    rng = np.random.RandomState(2)
    items = [(rng.randint(-2000, 2000, n).astype(np.int32), rng.randint(-2000, 2000, n).astype(np.int32))
             for n in (16384 + 99, 5000)]
    got = pool.encode_pooled(items, 44100, 16, device="cpu")
    monkeypatch.delenv("LAC_TPU_NO_NATIVE")
    assert got == [FrameEncoder(12, 2, 44100, 16, device="cpu").encode_frame(*it) for it in items]
