"""The port's array ops (lac_tpu_torch/ops) against lac_tpu's, bit-exact.

Each op runs on CPU tensors and is held against the JAX package's same
function under ``xp=jax.numpy`` (CPU) and ``xp=numpy``, on inputs made
from ``np.random.RandomState``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from lac_tpu.format import constants as C  # noqa: E402
from lac_tpu.format.zigzag import zigzag_encode as ref_zigzag  # noqa: E402
from lac_tpu.ops import _backend as ref_backend  # noqa: E402
from lac_tpu.ops import adapt as ref_adapt  # noqa: E402
from lac_tpu.ops import lpc as ref_lpc  # noqa: E402
from lac_tpu.ops import predictors as ref_pred  # noqa: E402
from lac_tpu.ops import runs as ref_runs  # noqa: E402
from lac_tpu.ops import stereo as ref_stereo  # noqa: E402
from lac_tpu_torch.format.zigzag import zigzag_encode  # noqa: E402
from lac_tpu_torch.ops import _backend, adapt, lpc, predictors, runs, stereo  # noqa: E402

XPS = pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])


def _ref(fn, xp, *args, **kw):
    """Run a lac_tpu op under ``xp`` on numpy inputs; numpy outputs."""
    conv = (lambda a: jnp.asarray(a) if isinstance(a, np.ndarray) else a) if xp is jnp else (lambda a: a)
    out = fn(*[conv(a) for a in args], xp=xp, **kw)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) else np.asarray(out)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if hasattr(got, "numpy") else got, want)


def _pcm(rows, n, seed, bits=24):
    """PCM rows: noise, a smooth tone, silence with bursts, and extremes."""
    rng = np.random.RandomState(seed)
    lim = 1 << (bits - 1)
    x = rng.randint(-lim, lim, (rows, n)).astype(np.int64)
    t = np.arange(n)
    x[1 % rows] = (np.sin(t / 7.0) * (lim - 1)).astype(np.int64)
    x[2 % rows] = 0
    x[2 % rows, ::97] = lim - 1
    x[3 % rows, :8] = [-lim, lim - 1, -lim, lim - 1, 0, -1, 1, -lim]
    return x.astype(np.int32)


def _codes(rows, n, seed):
    """u32 codes: geometric-ish audio codes, escape-range codes, zero
    runs, and a level change after the adapter's 96/256 windows."""
    rng = np.random.RandomState(seed)
    u = rng.geometric(0.02, (rows, n)).astype(np.uint64)
    u[1 % rows] = rng.randint(1 << 31, 1 << 32, n, dtype=np.uint64)
    u[2 % rows, 100:900] = 0
    u[3 % rows, 300:] = rng.randint(0, 4, n - 300)
    u[4 % rows] = 0xFFFFFFFF
    return u.astype(np.uint32)


# ---------------------------------------------------------------- helpers


@XPS
def test_zigzag_and_bit_width(xp):
    v = _pcm(4, 300, 1, bits=32)
    v[0, :4] = [C.INT32_MIN, C.INT32_MAX, -1, 0]
    want = _ref(lambda a, xp: ref_zigzag(a), xp, v).astype(np.int64)
    _eq(zigzag_encode(_t(v)), want)
    m = np.random.RandomState(2).randint(0, 1 << 52, 500, dtype=np.int64)
    m[:6] = [0, 1, 2, 3, (1 << 52) - 1, 1 << 51]
    _eq(_backend.bit_width(_t(m)), _ref(ref_backend.bit_width, xp, m.astype(np.uint64)))


def test_shift_and_scans_match_numpy():
    x = np.random.RandomState(3).randint(-1000, 1000, (3, 50)).astype(np.int32)
    for n in (0, 1, 7, 50, 60):
        _eq(_backend.shift_right(_t(x), n, fill=-5), ref_backend.shift_right(x, n, fill=-5))
    _eq(_backend.cummax(_t(x)), ref_backend.cummax(x))
    _eq(_backend.cummin_reverse(_t(x)), ref_backend.cummin_reverse(x))


# ---------------------------------------------------------------- predictors


@XPS
@pytest.mark.parametrize("order", range(5))
def test_fixed_residual(xp, order):
    x = _pcm(5, 700, 10 + order)
    _eq(predictors.fixed_residual(_t(x), order), _ref(ref_pred.fixed_residual, xp, x, order))


@XPS
def test_fir_residual(xp):
    x = _pcm(5, 700, 20)
    _eq(predictors.fir_residual(_t(x)), _ref(ref_pred.fir_residual, xp, x))


@XPS
def test_lpc_residual_and_in_range_flag(xp):
    rng = np.random.RandomState(21)
    x = _pcm(6, 600, 22)
    x[5] = rng.randint(-(1 << 30), 1 << 30, 600)  # leaves int32 at high gain
    coeffs = rng.randint(-32768, 32768, (6, 13)).astype(np.int16)
    coeffs[5] = 32767
    res, ok = predictors.lpc_residual(_t(x), _t(coeffs), 12)
    want_res, want_ok = _ref(ref_pred.lpc_residual, xp, x, coeffs, 12)
    _eq(res, want_res)
    _eq(ok, want_ok)
    assert not want_ok[5] and want_ok[:5].all()


# ---------------------------------------------------------------- stereo


@XPS
def test_ms_transform(xp):
    left, right = _pcm(3, 500, 30), _pcm(3, 500, 31)
    m, s = stereo.ms_transform(_t(left), _t(right))
    wm, ws = _ref(ref_stereo.ms_transform, xp, left, right)
    _eq(m, wm)
    _eq(s, ws)


@XPS
def test_estimate_stereo_mode(xp):
    rng = np.random.RandomState(32)
    n = 2048
    t = np.arange(n)
    base = (np.sin(t / 11.0) * 20000).astype(np.int32)
    left = np.stack([
        base, base, rng.randint(-30000, 30000, n), np.zeros(n), base, base + 3,
    ]).astype(np.int32)
    right = np.stack([
        base, -base, rng.randint(-30000, 30000, n), np.zeros(n), (base * 0.7).astype(np.int32),
        base + rng.randint(-2, 3, n),
    ]).astype(np.int32)
    for valid in (np.ones_like(left, bool), rng.rand(*left.shape) < 0.7):
        cm, un = stereo.estimate_stereo_mode(_t(left), _t(right), _t(valid))
        wcm, wun = _ref(ref_stereo.estimate_stereo_mode, xp, left, right, valid)
        _eq(cm, wcm)
        _eq(un, wun)
    assert wun.any() and not wun.all()


# ---------------------------------------------------------------- lags


@XPS
def test_autocorrelation_exact(xp):
    x = _pcm(6, 4096, 40)
    x[4] = (1 << 23) - 1
    x[5] = -(1 << 23)
    _eq(lpc.autocorrelation(_t(x), 12), _ref(ref_lpc.autocorrelation, xp, x, 12))


# ---------------------------------------------------------------- adaptation


@XPS
@pytest.mark.parametrize("n", [300, 3000])
def test_k_after_stateful(xp, n):
    u = _codes(6, n, 50 + n)
    got = adapt.k_after_stateful(_t(u.view(np.int32)))
    _eq(got, _ref(ref_adapt.k_after_stateful, xp, u.astype(np.uint64)))


@XPS
def test_k_after_stateless_and_k_used(xp):
    n, p = 2000, 3
    u = _codes(4, n, 60).astype(np.int64)
    starts = np.minimum(np.arange(1 << p) * (n >> p), n)
    sizes = np.diff(np.concatenate([starts, [n]]))
    pos = np.concatenate([np.arange(s) for s in sizes]).astype(np.int64)
    cs = np.cumsum(u, -1)
    seg_sum = cs - np.repeat(cs[:, starts] - u[:, starts], sizes, axis=-1)
    got = adapt.k_after_stateless(_t(seg_sum), _t(pos))
    _eq(got, _ref(ref_adapt.k_after_stateless, xp, seg_sum.astype(np.uint64), pos))

    k_after = np.random.RandomState(61).randint(0, 32, (4, 5, 300)).astype(np.int32)
    init = np.random.RandomState(62).randint(0, 13, (4, 5)).astype(np.int32)
    _eq(adapt.k_used_from_after(_t(k_after), _t(init)), _ref(ref_adapt.k_used_from_after, xp, k_after, init))


@XPS
def test_k_base_divfree_and_floordiv3(xp):
    rng = np.random.RandomState(63)
    c = rng.randint(1, 16385, 4000).astype(np.int64)
    N = c * rng.randint(2, 1 << 31, 4000, dtype=np.int64) + rng.randint(0, 16384, 4000)
    bwc = np.frexp(c.astype(np.float64))[1].astype(np.int32)
    got = adapt._k_base_divfree(_t(N), _t(c), _t(bwc))
    want = _ref(lambda N, c, bwc, xp: ref_adapt._k_base_divfree(N, c, bwc, xp),
                xp, N.astype(np.uint64), c.astype(np.uint64), bwc)
    _eq(got, want)
    x = rng.randint(0, 1 << 35, 4000, dtype=np.int64)
    _eq(adapt._floordiv3(_t(x)), x // 3)


# ---------------------------------------------------------------- runs


@XPS
def test_zero_runs(xp):
    rng = np.random.RandomState(70)
    n = 1000
    v = rng.randint(-3, 4, (5, n)) * (rng.rand(5, n) < 0.4)
    v[0] = 0
    v[1, :500] = 0
    v[2, 97:512] = 0
    z = v == 0
    a_got = runs.zero_breaks(_t(z))
    a_want = _ref(ref_runs.zero_breaks, xp, z)
    for g, w in zip(a_got, a_want):
        _eq(g, w)
    # partition order 3 geometry: breaks clamp to partition bounds
    starts = np.arange(8) * (n >> 3)
    sizes = np.diff(np.concatenate([starts, [n]]))
    pos = np.concatenate([np.arange(s) for s in sizes]).astype(np.int64)
    seg_end = np.repeat(np.concatenate([starts[1:], [n]]), sizes).astype(np.int64)
    got = runs.run_geometry(_t(z), *a_got, _t(pos), _t(seg_end))
    want = _ref(ref_runs.run_geometry, xp, z, *a_want, pos, seg_end)
    for g, w in zip(got, want):
        _eq(g, w)
    got = runs.run_geometry(_t(z), *runs.zero_breaks(_t(z)), torch.arange(n), n)  # the whole block's
    want = _ref(ref_runs.zero_run_info, xp, z, np.arange(n, dtype=np.int64), np.int64(n))
    for g, w in zip(got, want):
        _eq(g, w)
