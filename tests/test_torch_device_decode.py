"""The port's device decode backend on the CPU: kernel 7's plain version
(``cuda_kernels.recurrence_restore``), ``predictors.fixed_restore_multi``,
``device_decode._restore_groups`` and ``FrameDecoder``'s three backends
with ``decode_range``.

The same inputs, made from seeds with numpy, go through ``lac_tpu``
(``xp=numpy`` and ``xp=jax.numpy``; the decoder's Python backend) and
through ``lac_tpu_torch`` on ``device="cpu"``. Streams are encoded and
tokenized by the port's own runtime: ``lac_tpu.runtime.native`` is never
called here. Tolerance: none, every comparison is exact. The CUDA kernel
itself is held against the same plain version on the card by
chip_smoke.py.
"""

import os
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu import device_decode as ref_device_decode  # noqa: E402
from lac_tpu.decoder import DecodeError as RefDecodeError  # noqa: E402
from lac_tpu.decoder import FrameDecoder as RefDecoder  # noqa: E402
from lac_tpu.ops import predictors as ref_predictors  # noqa: E402
from lac_tpu_torch import device_decode  # noqa: E402
from lac_tpu_torch.decoder import DecodeError, FrameDecoder  # noqa: E402
from lac_tpu_torch.encoder import FrameEncoder  # noqa: E402
from lac_tpu_torch.format import constants as C  # noqa: E402
from lac_tpu_torch.ops import cuda_kernels as K  # noqa: E402
from lac_tpu_torch.ops import predictors  # noqa: E402
from lac_tpu_torch.runtime import native  # noqa: E402

from .signals import lcg_noise, sine  # noqa: E402

N = 16384
XPS = pytest.mark.parametrize("xp", [np, jnp], ids=["numpy", "jax"])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Kernel 7's plain version is a loop of small operators: with the suite's worker processes
    side by side, torch's intra-op thread pools would spin against each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _taps(rng, order, stable=True):
    """Q15 taps 1..order (index 0 unused): contractive (sum |c| < 0.9 * 2^15,
    so the restored lane stays near its residuals) or any int16."""
    c = np.zeros(33, np.int64)
    if stable:
        a = int(0.9 * (1 << 15) / order)
        c[1 : order + 1] = rng.randint(-a, a + 1, order)
    else:
        c[1 : order + 1] = rng.randint(-(1 << 15), 1 << 15, order)
    return c


def _restore_lanes(L=160, seed=11):
    """Lanes for kernel 7: LPC orders 1..32 (contractive taps), FIR lanes,
    ragged valid lengths (0, 1, the order, L), 24-bit-range residuals, lanes
    with any int16 taps that leave int32 early, in the middle and at the
    last valid sample, and the order-1 doubling lane of
    tests/test_restore_multi.py:69 (tap 2^16)."""
    rng = np.random.RandomState(seed)
    lanes = []  # (res, coeffs, order, shift, min_pred, valid)
    for od in range(1, 33):
        res = rng.randint(-3000, 3000, L)
        lanes.append((res, _taps(rng, od), od, 15, 0, [L, od, 1, 0, L - 7][od % 5]))
    for valid in (L, L, 1, 2, 3, 0):  # FIR
        c = np.zeros(33, np.int64)
        c[1], c[2] = C.FIR_TAPS
        lanes.append((rng.randint(-5000, 5000, L), c, C.FIR_ORDER, C.FIR_SHIFT, C.FIR_ORDER, valid))
    for od in (8, 12, 32):  # 24-bit residuals
        lanes.append((rng.randint(-(1 << 23), 1 << 23, L), _taps(rng, od), od, 15, 0, L))
    for od in (1, 2, 16, 31):  # any int16 taps: most of these leave int32
        lanes.append((rng.randint(-(1 << 20), 1 << 20, L), _taps(rng, od, stable=False), od, 15, 0, L))
    for at in (3, L // 2, L - 1):  # a lane that leaves int32 exactly at sample `at`
        res = np.zeros(L, np.int64)
        res[0] = 1
        res[at] = C.INT32_MAX
        c = np.zeros(33, np.int64)
        c[1] = 1 << 15  # x[n] = x[n - 1] + r[n]
        lanes.append((res, c, 1, 15, 0, L))
    res = np.zeros(L, np.int64)
    res[0] = 1 << 24
    c = np.zeros(33, np.int64)
    c[1] = 2 << 15  # doubles every step
    lanes.append((res, c, 1, 15, 0, L))
    res, cs, od, sh, mp, nv = (np.asarray(v) for v in zip(*lanes))
    return res.astype(np.int32), cs, od, sh, mp, nv


@XPS
def test_recurrence_restore_matches_lac_tpu(xp):
    res, cs, od, sh, mp, nv = _restore_lanes()
    got, ok = K.recurrence_restore(_t(res), _t(cs), _t(od), _t(sh), _t(mp), _t(nv))
    got, ok = got.numpy(), ok.numpy()
    want, w_ok = ref_predictors.recurrence_restore(xp.asarray(res), xp.asarray(cs), xp.asarray(od), xp.asarray(sh),
                                                   xp.asarray(mp), valid_len=xp.asarray(nv), xp=xp)
    want, w_ok = np.asarray(want), np.asarray(w_ok)
    np.testing.assert_array_equal(ok, w_ok)
    assert 0 < (~ok).sum() < len(ok) // 4, "want a few rejected lanes"
    assert not ok[-4:].any(), "the three exact-overflow lanes and the doubling lane leave int32"
    if xp is np:  # the row loop stops at a rejected lane's first bad sample, as kernel 7 does
        np.testing.assert_array_equal(got, want)
    else:  # the scan runs on past it: rejected lanes' tails are unspecified
        np.testing.assert_array_equal(got[ok], want[ok])


def test_recurrence_restore_default_valid_len_and_empty_lanes():
    res, cs, od, sh, mp, _ = _restore_lanes(L=40, seed=5)
    got, ok = K.recurrence_restore(_t(res), _t(cs), _t(od), _t(sh), _t(mp))
    want, w_ok = ref_predictors.recurrence_restore(res, cs, od, sh, mp, xp=np)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ok.numpy(), w_ok)
    empty, e_ok = K.recurrence_restore(_t(res[:0]), _t(cs[:0]), _t(od[:0]), _t(sh[:0]), _t(mp[:0]))
    assert empty.shape == (0, 40) and e_ok.shape == (0,)


def test_recurrence_restore_rejects_lanes_outside_the_kernels_range():
    """An order outside 0..32 or a shift outside 0..63 rejects the lane whole:
    ok is False and its residuals pass through."""
    rng = np.random.RandomState(2)
    res = rng.randint(-100, 100, (4, 50)).astype(np.int32)
    cs = np.stack([_taps(rng, 4)] * 4)
    got, ok = K.recurrence_restore(_t(res), _t(cs), _t(np.array([4, 33, -1, 4])), _t(np.array([15, 15, 15, 64])),
                                   _t(np.zeros(4, np.int64)))
    assert ok.tolist() == [True, False, False, False]
    np.testing.assert_array_equal(got.numpy()[1:], res[1:])


def test_recurrence_restore_validates_operands():
    res = torch.zeros((3, 8), dtype=torch.int32)
    vec = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError):
        K.recurrence_restore(res.to(torch.int64), torch.zeros((3, 33)), vec, vec, vec)
    with pytest.raises(ValueError):
        K.recurrence_restore(res, torch.zeros((3, 12), dtype=torch.int16), vec, vec, vec)
    with pytest.raises(ValueError):
        K.recurrence_restore(res, torch.zeros((3, 33), dtype=torch.int16), vec[:2], vec, vec)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain-version fallback
        K.recurrence_restore(res.to("meta"), torch.zeros((3, 33), dtype=torch.int16, device="meta"),
                             vec.to("meta"), vec.to("meta"), vec.to("meta"))


def test_kernel7_on_a_cpu_tensor_takes_the_plain_version():
    res, cs, od, sh, mp, nv = _restore_lanes(L=48, seed=9)
    K.reset_launches()
    got = K.recurrence_restore(_t(res), _t(cs), _t(od), _t(sh), _t(mp), _t(nv))
    want = K.recurrence_restore_plain(_t(res), _t(cs), _t(od), _t(sh), _t(mp), _t(nv))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].dtype == torch.int32  # every kept value fits: half the bytes of the JAX function's int64
    assert K.launches == dict.fromkeys(K.launches, 0)


# ---- a numpy model of csrc/restore.cu's walk over a row

WARP = 32
RESTORE_CU = pathlib.Path(K.__file__).resolve().parent.parent / "csrc" / "restore.cu"


def _wrap32(v):
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _flag_bound(tap_sum, sh):
    """csrc/restore.cu's B: the largest b <= 30 with tap_sum * 2^b <= (2^31 - 2^b) << sh and
    tap_sum * 2^b <= 2^52, else -1. While a lane's samples lie in [-2^b, 2^b), its float64 sums
    are exact and a step that leaves int32 wraps outside that range."""
    return next((b for b in range(30, -1, -1)
                 if tap_sum <= (((1 << 31) - (1 << b)) << sh) >> b and tap_sum <= 1 << (52 - b)), -1)


def _kernel7_model(res, coeffs, order, shift, min_pred, valid, tile):
    """numpy model of csrc/restore.cu: each warp of 32 lanes walks its rows
    in tiles of ``tile`` samples. Inside a tile, a fast run covers the whole
    4-sample groups over which every lane of the warp either predicts
    (alive, shift < 32, flag bound found, past min_pred_n, before
    valid_len) or passes residuals through (stopped or past valid_len: taps
    zeroed); it keeps low words only and ORs x + 2^B into a flag. A flagged
    lane replays the run the careful way from the history saved at its
    start. Anything else is one careful group of 4 (the exact per-sample
    logic). Rows whose length is not a multiple of 4 go the careful way
    throughout. Returns (samples int64, ok, counts of fast, careful and
    replayed samples)."""
    res = np.asarray(res, np.int64)
    lanes, n = res.shape
    out, ok = res.copy(), np.zeros(lanes, bool)
    counts = dict.fromkeys(("fast", "careful", "replayed"), 0)
    for w0 in range(0, lanes, WARP):
        sl = slice(w0, min(w0 + WARP, lanes))
        od, sh, mp = (np.asarray(v[sl], np.int64) for v in (order, shift, min_pred))
        nv = np.minimum(np.asarray(valid[sl], np.int64), n)
        alive = (od >= 0) & (od <= 32) & (sh >= 0) & (sh < 64)
        sh = np.where(alive, sh, 0)
        c = np.where(alive[:, None] & (np.arange(32)[None, :] < od[:, None]),
                     np.asarray(coeffs[sl], np.int64)[:, 1:33], 0)
        B = np.array([_flag_bound(int(np.abs(ci).sum()), int(s)) if a and s < 32 else -1
                      for ci, s, a in zip(c, sh, alive)])
        bias = np.where(B >= 0, np.left_shift(1, np.maximum(B, 0)), 0)
        mask = np.where(B >= 0, ~(np.left_shift(2, np.maximum(B, 0)) - 1) & 0xFFFFFFFF, 0)
        passing, h = ~alive, np.zeros_like(c)  # h[:, 0] is the newest sample
        rows = res[sl]

        def careful(sel, src, k0, k1, n0, row):
            nonlocal alive
            for j in range(k0, k1):
                rn = src[:, j]
                acc = (c * h).sum(axis=1)
                s = rn + np.where(n0 + j >= mp, acc >> sh, 0)
                in_range = (s >= C.INT32_MIN) & (s <= C.INT32_MAX)
                active = alive & (n0 + j < nv)
                alive = np.where(sel, alive & (in_range | ~active), alive)
                v = np.where(active & in_range, s, rn)
                row[sel, j] = v[sel]
                h[sel] = np.concatenate([v[:, None], h[:, :-1]], axis=1)[sel]

        if n % 4:  # no 16-byte copies: the careful way throughout
            row = rows.copy()
            careful(np.ones(len(od), bool), rows, 0, n, 0, row)
            counts["careful"] += n * len(od)
            out[sl], ok[sl] = row, alive
            continue
        for n0 in range(0, n, tile):
            cnt = min(tile, n - n0)
            row = rows[:, n0 : n0 + cnt].copy()  # the tile's samples
            k = 0
            while k < cnt:
                stops = ~passing & (~alive | (n0 + k >= nv))
                passing |= stops
                c[stops], mask[stops] = 0, 0
                end = np.where(passing, cnt, np.where((B >= 0) & (n0 + k >= mp), np.minimum(nv - n0, cnt), k))
                e = k + ((int(end.min()) - k) & ~3)
                if e > k:
                    hs = h.copy()
                    f = np.bitwise_or.reduce((h + bias[:, None]) & 0xFFFFFFFF, axis=1)
                    for j in range(k, e):
                        x = _wrap32(row[:, j] + _wrap32((c * h).sum(axis=1) >> sh))
                        row[:, j] = x
                        f |= (x + bias) & 0xFFFFFFFF
                        h = np.concatenate([x[:, None], h[:, :-1]], axis=1)
                    counts["fast"] += e - k
                    bad = (f & mask) != 0
                    if bad.any():
                        h[bad] = hs[bad]
                        careful(bad, rows[:, n0:], k, e, n0, row)
                        counts["replayed"] += (e - k) * int(bad.sum())
                    k = e
                else:
                    careful(np.ones(len(od), bool), row, k, min(k + 4, cnt), n0, row)
                    counts["careful"] += min(k + 4, cnt) - k
                    k = min(k + 4, cnt)
            out[sl, n0 : n0 + cnt] = row
        ok[sl] = alive
    return out, ok, counts


def _step_lane(L, at, value):
    """x[n] = x[n - 1] + r[n] from x[0] = 1: leaves int32 at ``at`` when ``value`` is 2^31 - 1."""
    res = np.zeros(L, np.int64)
    res[0], res[at] = 1, value
    c = np.zeros(33, np.int64)
    c[1] = 1 << 15
    return res, c, 1, 15, 0, L


def _wrap_lane(L, at):
    """x[n] = 32 x[n - 1] + r[n] with x[at - 1] = 2^27 - 1: x[at] is 2^32 - 32, whose low word -32
    lies in range. Only a flag bound no larger than the source's (B = 25 here) sees it coming."""
    res = np.zeros(L, np.int64)
    res[at - 1] = (1 << 27) - 1
    c = np.zeros(33, np.int64)
    c[1] = 1 << 20
    return res, c, 1, 15, 0, L


def _fir_lane(rng, L, valid):
    c = np.zeros(33, np.int64)
    c[1], c[2] = C.FIR_TAPS
    return rng.randint(-30000, 30000, L), c, C.FIR_ORDER, C.FIR_SHIFT, C.FIR_ORDER, valid


def _lpc_lane(rng, L, od, valid=None, scale=3000):
    taps = _taps(rng, od) if od else np.zeros(33, np.int64)
    return rng.randint(-scale, scale, L), taps, od, 15, 0, L if valid is None else valid


def _tile_edge_lanes(case, T, L, seed=3):
    """Lanes whose events sit on the model's tile edges (tile ``T``; L a few
    tiles and a ragged last one)."""
    rng = np.random.RandomState(seed)
    edges = (2 * T - 1, 2 * T, 2 * T + 1)
    if case == "leaves int32":  # at a tile's first sample, its last, inside it; and in range but flagged
        lanes = [_step_lane(L, at, C.INT32_MAX) for at in (2 * T, 2 * T - 1, 2 * T + T // 2 + 1, L - 1)]
        lanes += [_wrap_lane(L, at) for at in (2 * T, 3 * T - 1)]
        lanes += [_step_lane(L, at, (1 << 30) + 5) for at in (T, 3 * T - 1)]  # flags, replays, stays alive
        lanes += [_lpc_lane(rng, L, od) for od in (3, 8)]
    elif case == "valid_len":  # at k*T - 1, k*T, k*T + 1; FIR at 0, 1 and 2 (min_pred 2)
        lanes = [_lpc_lane(rng, L, od, v) for od in (2, 12) for v in edges]
        lanes += [_fir_lane(rng, L, v) for v in (0, 1, 2, 3, 4, 5, *edges, L)]
    elif case == "shift >= 32":  # the careful way until these lanes stop, then fast
        lanes = []
        for sh, nv in zip((31, 32, 40, 63), (L, *edges)):
            res, c, od, _, mp, _ = _lpc_lane(rng, L, 4, scale=1 << 23)
            c[1:5] = rng.randint(-(1 << 25), 1 << 25, 4)
            lanes.append((res, c, od, sh, mp, nv))
        lanes += [_lpc_lane(rng, L, 6), _fir_lane(rng, L, L)]
    elif case == "orders 0..32":
        lanes = [_lpc_lane(rng, L, od, (L, 2 * T, od, 0)[od % 4]) for od in range(33)]
    else:  # any int16 taps and 24-bit residuals: most of these leave int32 somewhere
        lanes = [(rng.randint(-(1 << 23), 1 << 23, L), _taps(rng, od, stable=False), od, 15, 0, L)
                 for od in (1, 2, 5, 12, 16, 31)]
        lanes += [_lpc_lane(rng, L, 12, scale=1 << 23) for _ in range(3)]
    res, cs, od, sh, mp, nv = (np.asarray(v) for v in zip(*lanes))
    return res.astype(np.int32), cs, od, sh, mp, nv


@pytest.mark.parametrize("ragged", [4, 3], ids=["L%4==0", "L%4==3"])
@pytest.mark.parametrize("T", [16, 32])
@pytest.mark.parametrize("case", ["leaves int32", "valid_len", "shift >= 32", "orders 0..32", "any int16 taps"])
def test_kernel7_tile_walk_model_matches_plain_and_lac_tpu(case, T, ragged):
    """The kernel's walk (fast runs, deferred flag, careful replay, first and
    ragged tiles; the careful way throughout for L % 4 != 0) gives the plain
    version's samples and ok flags, and lac_tpu's numpy row loop's. L is
    never a multiple of T."""
    res, cs, od, sh, mp, nv = _tile_edge_lanes(case, T, 5 * T + ragged)
    got, ok, counts = _kernel7_model(res, cs, od, sh, mp, nv, T)
    want, w_ok = K.recurrence_restore_plain(_t(res), _t(cs), _t(od), _t(sh), _t(mp), _t(nv))
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(ok, w_ok.numpy())
    ref, r_ok = ref_predictors.recurrence_restore(res, cs, od, sh, mp, valid_len=nv, xp=np)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ok, r_ok)
    if ragged % 4:
        assert counts["fast"] == 0 and counts["careful"] == res.size
    else:
        assert counts["fast"] > 0
        assert counts["careful"] > 0 or case not in ("valid_len", "shift >= 32", "orders 0..32")
    if case in ("leaves int32", "any int16 taps"):
        assert counts["replayed"] > 0 or ragged % 4
        assert 0 < (~ok).sum() < len(ok)
    if case == "leaves int32":
        assert ok.tolist() == [False] * 6 + [True] * 4


def test_kernel7_flag_bound_covers_audio_taps():
    """Q15 taps of any order up to 32 leave room for 24-bit samples (B >= 24), FIR's for B = 30;
    a shift of 32 or more, or taps too large for any B, never run the fast way."""
    assert _flag_bound(32 * ((1 << 15) - 1), 15) >= 24
    assert _flag_bound(sum(abs(t) for t in C.FIR_TAPS), C.FIR_SHIFT) == 30
    assert _flag_bound(1 << 15, 15) == 30 and _flag_bound(0, 0) == 30
    assert _flag_bound(1 << 40, 2) == -1


def test_kernel7_tiles_mirror_the_source():
    """cuda_kernels.RESTORE_TEMPLATES / RESTORE_TILE (chip_smoke.py's tile-edge lanes) are the source's."""
    src = RESTORE_CU.read_text()
    tile = re.search(r"constexpr int tile_len\(int H\) \{ return H == (\d+) \? (\d+) : (\d+); \}", src)
    assert tile, "tile_len not found in restore.cu"
    special, t_special, t_other = map(int, tile.groups())
    assert K.RESTORE_TILE == {h: t_special if h == special else t_other for h in K.RESTORE_TEMPLATES}
    picks = [int(m) for m in re.findall(r"restore_lane<(\d+)>\(a, s, smem\)", src)]
    assert tuple(picks) == K.RESTORE_TEMPLATES


@XPS
def test_fixed_restore_multi_matches_lac_tpu(xp):
    rng = np.random.RandomState(3)
    L = 96
    res = rng.randint(-4000, 4000, (14, L)).astype(np.int32)
    res[10] = rng.randint(-(1 << 23), 1 << 23, L)
    res[11:13] = (1 << 30) + rng.randint(0, 1000, (2, L))  # orders 3 and 4 leave the stage bound
    res[13, 50] = C.INT32_MAX  # order 1 leaves int32 at sample 50
    order = np.asarray([0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 4, 3, 4, 1])
    lens = np.asarray([L, L, L, L, L, 40, 17, 5, 1, 0, L, L, L, L])
    got, ok = predictors.fixed_restore_multi(_t(res), _t(order), valid_len=_t(lens))
    want, w_ok = ref_predictors.fixed_restore_multi(xp.asarray(res), xp.asarray(order), valid_len=xp.asarray(lens),
                                                    xp=xp)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(w_ok))
    assert not ok[11:].any() and ok[:4].all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got, ok = predictors.fixed_restore_multi(_t(res[:10]), _t(order[:10]))  # valid_len None: whole rows
    want, w_ok = ref_predictors.fixed_restore_multi(res[:10], order[:10], xp=np)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ok.numpy(), w_ok)


# ------------------------------------------------------------ lane grouping


def _synthetic_tokens(seed, overflow=False):
    """Tokenizer-shaped arrays: 2 channels, blocks of 300 and a 137-sample
    tail, every predictor kind, LPC orders up to 32."""
    rng = np.random.RandomState(seed)
    sizes = np.array([300, 300, 300, 300, 137])
    nb, ch = len(sizes), 2
    offs = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    res = rng.randint(-3000, 3000, (ch, sizes.sum())).astype(np.int32)
    ptype = rng.randint(0, 3, (nb, ch)).astype(np.uint8)
    ptype[0] = (C.PREDICTOR_FIR, C.PREDICTOR_LPC)
    order = np.zeros((nb, ch), np.uint8)
    coeffs = np.zeros((nb, ch, 33), np.int16)
    for b in range(nb):
        for c in range(ch):
            if ptype[b, c] == C.PREDICTOR_FIXED:
                order[b, c] = rng.randint(0, 5)
            elif ptype[b, c] == C.PREDICTOR_FIR:
                order[b, c] = C.FIR_ORDER
            else:
                order[b, c] = 32 if (b, c) == (0, 1) else rng.randint(1, 33)
                coeffs[b, c] = _taps(rng, int(order[b, c]))
    for b in range(nb):  # fixed lanes of higher orders stay in int32 only with small residuals
        for c in range(ch):
            if ptype[b, c] == C.PREDICTOR_FIXED and order[b, c] >= 2:
                lim = {2: 50, 3: 2, 4: 1}[int(order[b, c])]
                res[c, offs[b] : offs[b] + sizes[b]] = rng.randint(-lim, lim + 1, sizes[b])
    if overflow:
        ptype[2, 0], order[2, 0] = C.PREDICTOR_LPC, 1
        coeffs[2, 0, 1] = 32767
        res[0, offs[2] : offs[2] + 300] = 1 << 29
    return res, sizes, offs, ptype, order, coeffs


def _tokenize(bs):
    dec = FrameDecoder()
    hdr, br, payload, sizes, psizes = dec._parse_frame(bs)
    body = dec._v3_payload(br, payload, psizes)
    poffs = np.concatenate([[0], np.cumsum(psizes)])[:-1]
    offs = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    res, ptype, order, coeffs, _ = native.tokenize_v3_blocks(body, poffs, psizes, sizes, offs, hdr.channels,
                                                             hdr.stereo_mode, sum(sizes))
    return res, np.asarray(sizes), offs, ptype, order, coeffs


def _stereo(frames, seed, depth=16):
    """Tone, ramp, silence and noise: fixed and LPC lanes."""
    amp = 20000 if depth == 16 else 5_000_000
    q = frames // 4
    parts = [sine(q, 44100, 440.0, amp), (np.arange(q) * 5 % 4000).astype(np.int32), np.zeros(q, np.int32),
             lcg_noise(frames - 3 * q, amp, seed)]
    left = np.concatenate(parts)
    right = np.concatenate([lcg_noise(frames - 3 * q, amp // 3, seed + 1)] + parts[:3])
    return left, right


def _fir_friendly(frames, seed):
    """x[n] = e[n] + ((3 x[n-1] - x[n-2]) >> 2): white noise through the FIR
    predictor's own filter, which the encoder codes with FIR lanes."""
    e = np.random.RandomState(seed).randint(-3000, 3000, frames)
    x = np.zeros(frames, np.int64)
    for i in range(frames):
        x[i] = e[i] + ((C.FIR_TAPS[0] * x[i - 1] + C.FIR_TAPS[1] * x[i - 2]) >> C.FIR_SHIFT if i >= 2 else 0)
    return x.astype(np.int32)


MONO = np.empty(0, np.int32)
STREAM = _stereo(N + 2345, 3)
FIR_MONO = _fir_friendly(N + 3000, 1)
SHORT = _stereo(9000, 8, depth=24)


def _streams():
    enc = FrameEncoder(12, 2, 44100, 16, device="cpu").encode
    return {
        "stereo auto": (STREAM, enc(*STREAM)),
        "mono, FIR lanes": ((FIR_MONO, MONO), FrameEncoder(12, 0, 48000, 16, device="cpu").encode(FIR_MONO)),
        "24-bit forced ms": (SHORT, FrameEncoder(12, 1, 96000, 24, device="cpu").encode(*SHORT)),
        "forced lr": ((STREAM[0][:5000], STREAM[1][:5000]),
                      FrameEncoder(12, 0, 44100, 16, device="cpu").encode(STREAM[0][:5000], STREAM[1][:5000])),
    }


STREAMS = _streams()
STREAM_BYTES = STREAMS["stereo auto"][1]


@pytest.mark.parametrize("case", ["synthetic", "synthetic, a lane leaves int32", "stereo auto", "mono, FIR lanes"])
def test_restore_groups_matches_lac_tpu(case):
    tokens = _tokenize(STREAMS[case][1]) if case in STREAMS else _synthetic_tokens(4, "int32" in case)
    got, ok = device_decode._restore_groups(*tokens, "cpu")
    want, w_ok = ref_device_decode._restore_groups(*tokens, jnp)
    assert ok == w_ok == ("int32" not in case)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["24-bit forced ms", "forced lr"])
def test_device_decode_steps_give_the_input_pcm(name):
    """decode_v3_device is its steps, which a profile calls one by one:
    tokenize, lane_operands, restore_lanes (int32 samples back), scatter,
    finish."""
    (left, right), bs = STREAMS[name]
    dec = FrameDecoder()
    hdr, br, payload, sizes, psizes = dec._parse_frame(bs)
    sizes = np.asarray(sizes)
    res, ptype, order, coeffs, msflag, offs = device_decode.tokenize(
        hdr, sizes, np.asarray(psizes), dec._v3_payload(br, payload, psizes), int(sizes.sum()))
    restored = device_decode.restore_lanes(*device_decode.lane_operands(res, sizes, offs, ptype, order, coeffs), "cpu")
    assert restored.dtype == np.int32 and restored.shape == (len(sizes) * hdr.channels, sizes.max())
    got_l, got_r = device_decode.finish(hdr, device_decode.scatter(res, sizes, offs, restored), sizes, msflag)
    np.testing.assert_array_equal(got_l, left)
    np.testing.assert_array_equal(got_r, right)


@pytest.mark.parametrize("kind", ["LPC", "fixed"])
def test_restore_lanes_gives_none_when_a_lane_leaves_int32(kind):
    """A lane outside int32, kernel 7's or the masked cumsums', fails the
    whole restore, as in lac_tpu (whose int64 samples would hold it; the
    port's int32 copy never carries it)."""
    tokens = _synthetic_tokens(4, overflow=kind == "LPC")
    res, sizes, offs, ptype, order, coeffs = tokens
    if kind == "fixed":
        ptype[3, 1], order[3, 1] = C.PREDICTOR_FIXED, 4
        res[1, offs[3] : offs[3] + sizes[3]] = 1 << 29
    assert device_decode.restore_lanes(*device_decode.lane_operands(*tokens), "cpu") is None
    assert device_decode._restore_groups(*tokens, "cpu")[1] is False
    assert ref_device_decode._restore_groups(*tokens, np)[1] is False


def test_the_streams_reach_every_predictor_kind():
    kinds = set()
    for name in ("stereo auto", "mono, FIR lanes"):
        kinds |= set(_tokenize(STREAMS[name][1])[3].ravel().tolist())
    assert kinds == {C.PREDICTOR_FIXED, C.PREDICTOR_FIR, C.PREDICTOR_LPC}


def test_tokenizer_rejects_a_bad_block():
    bs = bytearray(STREAM_BYTES)
    bs[-1] ^= 0xFF
    with pytest.raises(ValueError, match=r"^block=1$"):
        _tokenize(bytes(bs))


# ------------------------------------------------------------ the decoder's backends


def _decoders():
    return {"native": FrameDecoder(), "python": FrameDecoder(backend="python"),
            "no native": FrameDecoder(use_native=False), "device": FrameDecoder(backend="device", device="cpu")}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_every_backend_decodes_the_input_pcm(name):
    (left, right), bs = STREAMS[name]
    want_l, want_r, _ = RefDecoder(backend="python").decode(bs)
    np.testing.assert_array_equal(want_l, left)
    np.testing.assert_array_equal(want_r, right)
    for label, dec in _decoders().items():
        got_l, got_r, hdr = dec.decode(bs)
        assert got_l.dtype == got_r.dtype == np.int32, label
        np.testing.assert_array_equal(got_l, left, err_msg=label)
        np.testing.assert_array_equal(got_r, right, err_msg=label)


def _v2(sig):
    """A v2 stream (no payload-size table) of one block, as tests/test_decode_range.py makes it."""
    bs = FrameEncoder(12, 0, 44100, 16, device="cpu").encode(sig)
    v2 = bytearray(bs[:10])
    v2[2] = 2
    return bytes(v2 + (1).to_bytes(4, "big") + len(sig).to_bytes(4, "big") + bs[22:])


def test_v2_streams_decode_on_every_backend():
    sig = lcg_noise(700, 2500, 3)
    v2 = _v2(sig)
    for label, dec in _decoders().items():
        got, _, hdr = dec.decode(v2)
        assert hdr.version == 2
        np.testing.assert_array_equal(got, sig, err_msg=label)
        part, _, _ = dec.decode_range(v2, 100, 50)
        np.testing.assert_array_equal(part, sig[100:150], err_msg=label)
    trailing = v2 + b"\x00"
    for label, dec in _decoders().items():
        with pytest.raises(DecodeError) as got:
            dec.decode(trailing)
        with pytest.raises(RefDecodeError) as want:
            RefDecoder(backend="python").decode(trailing)
        assert str(got.value) == str(want.value) == "[decode-error] trailing frame payload", label


def _ranges(total, seed, count):
    """Seeded (start, count) pairs: most cross a block edge, some lie inside a block, the head and the tail."""
    rng = np.random.RandomState(seed)
    edges = np.arange(N, total, N)
    out = [(0, 100), (total - 77, 77), (5, 0)]
    for _ in range(count):
        e = int(rng.choice(edges))
        a, b = rng.randint(1, 3000, 2)
        start = e - int(a)
        out.append((start, min(int(a + b), total - start)) if rng.rand() < 0.75
                   else (int(rng.randint(0, total - 500)), 400))
    return out


@pytest.mark.parametrize("backend", ["native", "python", "device"])
def test_decode_range_equals_slices(backend):
    (left, right), bs = STREAMS["stereo auto"]
    dec = FrameDecoder(backend=backend, device="cpu")
    ranges = _ranges(len(left), 21, 8 if backend == "native" else 3)
    for start, count in ranges:
        got_l, got_r, _ = dec.decode_range(bs, start, count)
        np.testing.assert_array_equal(got_l, left[start : start + count])
        np.testing.assert_array_equal(got_r, right[start : start + count])
    want_l, want_r, _ = RefDecoder(backend="python").decode_range(bs, *ranges[-1])
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_r, want_r)
    (mono, _), mbs = STREAMS["mono, FIR lanes"]
    got, empty, _ = dec.decode_range(mbs, N - 10, 20)
    np.testing.assert_array_equal(got, mono[N - 10 : N + 10])
    assert empty.size == 0
    for start, count in ((-1, 5), (0, len(left) + 1), (len(left), 1), (3, -1)):
        with pytest.raises(ValueError, match="outside stream"):
            dec.decode_range(bs, start, count)


def _corruptions():
    """(label, corrupt bytes, the block the corruption lies in): the last
    byte of each block's payload, a byte inside block 0, the first byte of
    block 0 (its per-block stereo flag)."""
    dec = FrameDecoder()
    hdr, br, payload, sizes, psizes = dec._parse_frame(STREAM_BYTES)
    base = len(STREAM_BYTES) - sum(psizes)
    end0 = base + psizes[0]
    out = []
    for label, at, block in (("block 1 last byte", len(STREAM_BYTES) - 1, 1), ("block 0 middle", end0 - 300, 0),
                             ("block 0 first byte", base, 0), ("block 0 last byte", end0 - 1, 0)):
        bs = bytearray(STREAM_BYTES)
        bs[at] ^= 0xFF
        out.append((label, bytes(bs), block))
    return out


CORRUPTIONS = _corruptions()


@pytest.mark.parametrize("case", range(len(CORRUPTIONS)), ids=[c[0] for c in CORRUPTIONS])
def test_corrupt_streams_give_the_reference_messages(case):
    _, bs, block = CORRUPTIONS[case]
    ref = RefDecoder(backend="python")
    with pytest.raises(RefDecodeError) as want:
        ref.decode(bs)
    for dec in (FrameDecoder(), FrameDecoder(backend="python")):
        with pytest.raises(DecodeError) as got:
            dec.decode(bs)
        assert str(got.value) == str(want.value)
    with pytest.raises(DecodeError) as got:
        FrameDecoder(backend="device", device="cpu").decode(bs)
    assert str(got.value) == f"[decode-error] block={block}"
    start = max(0, block * N - 10)  # a range over the corrupt block, and one in the other block
    clean = N + 100 if block == 0 else 0
    with pytest.raises(RefDecodeError) as want:
        ref.decode_range(bs, start, 20)
    for backend in ("native", "python", "device"):
        dec = FrameDecoder(backend=backend, device="cpu")
        with pytest.raises(DecodeError) as got:
            dec.decode_range(bs, start, 20)
        assert str(got.value) == str(want.value)
        got_l, _, _ = dec.decode_range(bs, clean, 100)
        np.testing.assert_array_equal(got_l, STREAM[0][clean : clean + 100])


def test_device_backend_reports_reconstruction_outside_int32(monkeypatch):
    monkeypatch.setattr(device_decode, "_restore_groups", lambda res, *args: (res.astype(np.int64), False))
    with pytest.raises(DecodeError, match=r"^\[decode-error\] reconstruction outside int32 range$"):
        FrameDecoder(backend="device", device="cpu").decode(STREAM_BYTES)


@pytest.mark.parametrize("backend", ["native", "python", "device"])
def test_decode_to_wav_on_every_backend(backend, tmp_path):
    _, bs = STREAMS["24-bit forced ms"]
    paths = []
    for i, dec in enumerate((FrameDecoder(), FrameDecoder(backend=backend, device="cpu"))):
        paths.append(os.path.join(tmp_path, f"{i}.wav"))
        frames, hdr = dec.decode_to_wav(bs, paths[-1])
        assert frames == len(SHORT[0])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def test_backends_and_devices():
    with pytest.raises(ValueError, match="backend"):
        FrameDecoder(backend="gpu")
    assert FrameDecoder(backend="python").use_native is False
    assert FrameDecoder(device="meta").device is None  # the native backend never touches the device
    with pytest.raises(ValueError):
        FrameDecoder(backend="device", device="meta")


def test_device_backend_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py covers the card")
    with pytest.raises(RuntimeError, match="cuda"):
        FrameDecoder(backend="device")
    with pytest.raises(RuntimeError, match="cuda"):
        FrameDecoder(backend="device", device="cuda:0")
    # the default backend decodes on a host without a card
    got, _, _ = FrameDecoder().decode(STREAMS["forced lr"][1])
    np.testing.assert_array_equal(got, STREAM[0][:5000])
