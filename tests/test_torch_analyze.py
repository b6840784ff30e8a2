"""The port's per-chunk analyze and the group route's lags at the
reference's padded shapes, on the CPU.

On the card both are CUDA graphs (``lac_tpu_torch.plan_graphs.analyzed``
and ``lags_of``), held bit-exact against their eager functions by
``chip_smoke.py`` phase 15. Here CPU tensors run those functions on the
padded input, which is what the graph captures, against ``lac_tpu``:

* ``analyze`` of a chunk of kc blocks zero-padded to K against
  ``lac_tpu.device_pipeline._jitted_analyze(K, kind, dtype)`` on every
  output and on the packed host buffer;
* the row helpers against ``lac_tpu``'s ``_ChunkJob`` (mesh None);
* the group route's lags of a padded batch against
  ``lac_tpu.encoder._jitted_autocorr(12, nlimbs)`` in every domain;
* a plane pipeline whose last chunk is ragged against the port's host
  route and ``lac_tpu``'s encoder.

Tolerance: none; every output is an integer.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu import device_pipeline as ref_dp  # noqa: E402
from lac_tpu import encoder as ref_enc  # noqa: E402
from lac_tpu.encoder import FrameEncoder as RefEncoder  # noqa: E402
from lac_tpu_torch import device_pipeline, encoder, plan_graphs  # noqa: E402
from lac_tpu_torch.encoder import ChannelBlockEncoder, FrameEncoder  # noqa: E402

N = 16384
KINDS = ("mono", "lr", "ms", "auto")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """analyze's and the planner's CPU operators beside the suite's other workers: one intra-op thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chunk(kc, dtype, seed):
    """(kc, N) L and R planes: noise, a tone with its echo, L = R, silence
    and the type's extremes, so that certain-LR, certain-MS and uncertain
    blocks all occur."""
    rng = np.random.RandomState(seed)
    lo, hi = (-(1 << 15), (1 << 15) - 1) if dtype == "int16" else (-(1 << 23), (1 << 23) - 1)
    t = np.arange(N)
    tone = np.sin(t / 23.0) * hi * 0.6
    rows = [
        (rng.randint(lo // 2, hi // 2, N), rng.randint(lo // 2, hi // 2, N)),
        (tone, np.roll(tone, 5) * 0.9 + rng.randint(-40, 40, N)),
        (tone, tone),
        (np.zeros(N), np.zeros(N)),
        (np.where(t % 2, hi, lo), np.where(t % 2, lo, hi)),
        (tone * 0.01 + rng.randint(-3, 4, N), -tone * 0.01),
    ]
    pick = [rows[(i + seed) % len(rows)] for i in range(kc)]
    left = np.clip(np.stack([a for a, _ in pick]), lo, hi).astype(dtype)
    right = np.clip(np.stack([b for _, b in pick]), lo, hi).astype(dtype)
    return left, right


def _padded(m, K):
    out = np.zeros((K, N), m.dtype)
    out[: len(m)] = m
    return out


@pytest.mark.parametrize("kc", [8, 5, 1])
@pytest.mark.parametrize("dtype", ["int16", "int32"])
@pytest.mark.parametrize("kind", KINDS)
def test_analyze_equals_lac_tpu_jitted_analyze(kind, dtype, kc):
    K = 8
    left, right = _chunk(kc, dtype, seed=kc + 10 * KINDS.index(kind))
    ref = ref_dp._jitted_analyze(K, kind, dtype)(_padded(left, K), _padded(right, K))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = plan_graphs.analyzed(torch.from_numpy(left), torch.from_numpy(right), K, kind)
    want_keys = {"planes", "hostbuf"} | ({"probes", "plags"} if kind == "auto" else set())
    assert set(got) == set(ref) == want_keys
    for key in want_keys:
        assert got[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(got[key].numpy(), ref[key], err_msg=key)
    assert got["planes"].dtype == torch.int32 and got["hostbuf"].dtype == torch.int64
    # the pieces the plan stage reads, unpacked the port's way from both buffers
    for full in (K, kc):
        cm, un, lags = device_pipeline.unpack_hostbuf(got["hostbuf"].numpy(), K, full, kind)
        rcm, run_, rlags = device_pipeline.unpack_hostbuf(ref["hostbuf"], K, full, kind)
        np.testing.assert_array_equal(lags, rlags)
        assert lags.shape == ({"mono": 1, "auto": 4}.get(kind, 2) * K, 13)
        if kind == "auto":
            assert cm.dtype == un.dtype == bool and cm.shape == un.shape == (full,)
            np.testing.assert_array_equal(cm, rcm)
            np.testing.assert_array_equal(un, run_)
        else:
            assert cm is un is rcm is run_ is None
    if kind == "auto":
        un = device_pipeline.unpack_hostbuf(got["hostbuf"].numpy(), K, K, kind)[1]
        assert un[kc:].all(), "the zero rows past kc are uncertain, as in lac_tpu"


@pytest.mark.parametrize("K,kc", [(8, 8), (8, 5), (256, 228), (64, 1)])
def test_row_helpers_equal_lac_tpu(K, kc):
    ours = device_pipeline._ChunkJob(types.SimpleNamespace(K=K), 0, kc, torch.device("cpu"), 0)
    ref = ref_dp._ChunkJob(types.SimpleNamespace(K=K, mesh=None), 0, kc)
    for p in range(4):
        for i in range(kc):
            assert ours._row_of(p, i) == ref._row_of(p, i) == p * K + i
            for pos in range(3):
                assert ours._probe_row_of(p, i, pos) == ref._probe_row_of(p, i, pos)


def _group_pcm(B, n, nlimbs, seed):
    """A lane group in one lag domain: 16-bit content (4 limbs), 24-bit
    content with the extremes (5), and int32 outside the 24-bit domain (0)."""
    rng = np.random.RandomState(seed)
    hi = {4: (1 << 15) - 1, 5: (1 << 23) - 1, 0: (1 << 27) - 1}[nlimbs]
    pcm = rng.randint(-hi - 1, hi + 1, (B, n)).astype(np.int64)
    pcm[0] = np.where(np.arange(n) % 2, hi, -hi - 1)
    pcm[1] = (np.sin(np.arange(n) / 7.0) * hi).astype(np.int64)
    return pcm.astype(np.int16 if nlimbs == 4 else np.int32)


@pytest.mark.parametrize("nlimbs", [4, 5, 0])
@pytest.mark.parametrize("B,rows,n", [(5, 8, 256), (3, 4, N)])
def test_group_lags_equal_lac_tpu_jitted_autocorr(nlimbs, B, rows, n):
    pcm = _group_pcm(B, n, nlimbs, seed=B + nlimbs)
    pad = np.zeros((rows, n), pcm.dtype)
    pad[:B] = pcm
    want = np.asarray(ref_enc._jitted_autocorr(12, nlimbs)(pad))[:B]
    got = plan_graphs.lags_of(torch.from_numpy(pcm), rows)
    assert got.dtype == torch.int64 and got.shape == (B, 13)
    np.testing.assert_array_equal(got.numpy(), want)


def test_group_route_takes_its_lags_at_the_padded_shape(monkeypatch):
    seen = []
    real = encoder.lags_of

    def recorded(pcm, rows):
        seen.append((pcm.shape[0], rows, pcm.dtype))
        return real(pcm, rows)

    monkeypatch.setattr(encoder, "lags_of", recorded)
    pcm = _group_pcm(5, 256, 5, seed=31)
    assert ChannelBlockEncoder(device="cpu").encode_group(pcm) == ChannelBlockEncoder().encode_group(pcm)
    assert seen == [(5, 8, torch.int32)]


def _stereo(frames, seed):
    """A tone with noise; the right channel swings between correlated and independent."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames)
    left = (np.sin(t * 0.013) * 9000).astype(np.int32) + rng.randint(-600, 600, frames).astype(np.int32)
    mix = (t // N) % 3
    right = np.where(mix == 0, left // 2, np.where(mix == 1, 0, left)) + rng.randint(-900, 900, frames)
    return left, np.clip(right, -(1 << 15), (1 << 15) - 1).astype(np.int32)


@pytest.mark.parametrize("mode", [2, 1], ids=["auto", "ms"])
def test_ragged_last_chunk_bytes_equal_host_route_and_lac_tpu(monkeypatch, mode):
    """13 full blocks in chunks of 8: the last chunk's 5 blocks are analyzed
    as 8, the rows past them zero, and the bytes do not move."""
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 8)
    seen = []
    real = device_pipeline.analyzed

    def recorded(lmat, rmat, K, kind):
        seen.append((lmat.shape[0], K, kind))
        return real(lmat, rmat, K, kind)

    monkeypatch.setattr(device_pipeline, "analyzed", recorded)
    left, right = _stereo(13 * N + 777, 7 + mode)
    enc = FrameEncoder(12, mode, 44100, 16, device="cpu")
    got = enc.encode(left, right)
    kind = "auto" if mode == 2 else "ms"
    assert seen == [(8, 8, kind), (5, 8, kind)]
    assert got == enc.encode_frame(left, right), "the plane pipeline differs from the port's host route"
    assert got == RefEncoder(12, mode, 44100, 16, xp=np).encode(left, right), "the port differs from lac_tpu"
