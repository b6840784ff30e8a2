"""The port stands alone: ``lac_tpu_torch`` and ``chip_smoke.py`` import
torch, numpy and the standard library, never ``jax`` and nothing of
``lac_tpu``; its entry points run on the card unless asked for the CPU;
the wire-format constants it carries equal the JAX package's.
"""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from lac_tpu.format import constants as ref_constants  # noqa: E402
from lac_tpu_torch import cli  # noqa: E402
from lac_tpu_torch.encoder import FrameEncoder  # noqa: E402
from lac_tpu_torch.format import constants  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "lac_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
PORT_MODULES = [
    ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT_FILES
]
assert {"lac_tpu_torch.stream", "lac_tpu_torch.batch", "lac_tpu_torch.pool", "lac_tpu_torch.experiments",
        "lac_tpu_torch.experiments.device_pack", "lac_tpu_torch.experiments.device_reader"} <= set(PORT_MODULES)
CONSTANT_NAMES = sorted(n for n in vars(ref_constants) if not n.startswith("_"))


def _forbidden(name):
    return name == "jax" or name.startswith("jax.") or name == "lac_tpu" or name.startswith("lac_tpu.")


def test_importing_the_port_and_chip_smoke_loads_neither_jax_nor_lac_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'\n"
        "             or m == 'lac_tpu' or m.startswith('lac_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'chip_smoke' in sys.modules and 'lac_tpu_torch.runtime.native' in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_import_of_jax_or_lac_tpu_in_the_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module and _forbidden(node.module):
            bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            bad += [a.value for a in node.args if isinstance(a, ast.Constant) and _forbidden(str(a.value))]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("name", CONSTANT_NAMES)
def test_wire_constants_equal_the_jax_package(name):
    got = getattr(constants, name)
    want = getattr(ref_constants, name)
    if callable(want):  # pcm_range
        for depth in (16, 24):
            assert got(depth) == want(depth)
    else:
        assert got == want


def test_the_port_carries_no_extra_constant():
    assert sorted(n for n in vars(constants) if not n.startswith("_")) == CONSTANT_NAMES


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs (chip_smoke.py covers it)")


def test_frame_encoder_defaults_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        FrameEncoder()
    assert FrameEncoder(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("argv", [["encode", "in.wav", "out.lac"], ["selftest"]], ids=["encode", "selftest"])
def test_cli_defaults_to_the_card(no_card, capsys, argv):
    """Without a card the default device is an error at the CLI boundary,
    never a silent run on the CPU."""
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert err.startswith("Error: device 'cuda' requested") and "is_available() is False" in err


def test_cli_starts_the_card_only_for_an_input_that_reaches_it(tmp_path, capsys, monkeypatch):
    """With a card present (simulated), a one-shot encode of an input under
    ``device_pipeline.MIN_FULL_BLOCKS`` full blocks is planned on the host
    and never resolves the device (what starts the CUDA context). So is an
    input of 8 full blocks in a process that has not used the card (at
    most ``LAC_TPU_COLD_BLOCKS`` blocks: the cold route); with the cold
    route off (``LAC_TPU_COLD_BLOCKS=0``) it reaches the card."""
    import numpy as np

    import lac_tpu_torch
    from lac_tpu_torch import device_pipeline, encoder
    from lac_tpu_torch.io import write_wav

    resolved = []

    def resolve(device):
        resolved.append(str(device))
        raise RuntimeError("the card was resolved")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(device_pipeline, "_PROC_WARM", False)
    monkeypatch.delenv("LAC_TPU_COLD_BLOCKS", raising=False)
    rng = np.random.RandomState(3)
    short, long_, out = (str(tmp_path / n) for n in ("short.wav", "long.wav", "out.lac"))
    for path, frames in ((short, 16384 * 7 + 100), (long_, 16384 * 8)):
        pcm = rng.randint(-3000, 3000, frames).astype(np.int32)
        assert write_wav(path, pcm, pcm // 2, 2, 44100, 16)
    want = {path: FrameEncoder(12, 2, 44100, 16, device="cpu").encode_frame(*_pcm(path)) for path in (short, long_)}
    monkeypatch.setattr(encoder, "resolve_device", resolve)
    assert lac_tpu_torch.check_device("cuda").type == "cuda"
    for path in (short, long_):
        assert cli.main(["encode", path, out]) == 0 and resolved == []
        with open(out, "rb") as f:
            assert f.read() == want[path]
        assert capsys.readouterr().out.startswith("Encoded ")
    monkeypatch.setenv("LAC_TPU_COLD_BLOCKS", "0")
    assert cli.main(["encode", short, out]) == 0 and resolved == []
    with open(out, "rb") as f:
        assert f.read() == want[short]
    assert capsys.readouterr().out.startswith("Encoded ")
    assert cli.main(["encode", long_, out]) == 1 and resolved == ["cuda"]
    assert capsys.readouterr().err == "Error: the card was resolved\n"
    assert not device_pipeline.process_warm()


def _pcm(path):
    from lac_tpu_torch.io import read_wav

    left, right, *_ = read_wav(path)
    return left, right
