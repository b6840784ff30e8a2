"""The port's kernel wrappers (lac_tpu_torch/ops/cuda_kernels.py) on the CPU.

On CPU tensors each wrapper takes its plain PyTorch version. Here every
plain version is held bit-exact against the Pallas kernel it replaces,
run in interpret mode as tests/test_pallas.py and tests/test_pallas_adapt.py
run it, and against numpy, on adversarial inputs (all 0xFFFFFFFF, codes
>= 2^31, long zero runs, the adapter's window edges 95/96/255/256, tile
edges). Odd row lengths have no Pallas tiling and are held against numpy
only. The CUDA kernels themselves are held against the same plain
versions on the card by chip_smoke.py.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from lac_tpu.ops import adapt as ref_adapt  # noqa: E402
from lac_tpu.ops import device_reader as ref_reader  # noqa: E402
from lac_tpu.ops import pallas_adapt as pa  # noqa: E402
from lac_tpu.ops import pallas_kernels as pk  # noqa: E402
from lac_tpu_torch.ops import _cuda_lib  # noqa: E402
from lac_tpu_torch.ops import cuda_kernels as K  # noqa: E402

ROWS = 16
NS = [256, 6144, 1001]  # probe width, three 2048-wide scan tiles, odd


def _codes(rows, n, seed):
    """u32 codes, one adversarial pattern per row (row % 6)."""
    rng = np.random.RandomState(seed)
    u = np.zeros((rows, n), np.uint64)
    pat = np.arange(rows) % 6
    u[pat == 0] = rng.randint(0, 1 << 32, ((pat == 0).sum(), n), dtype=np.uint64)
    u[pat == 1] = 0xFFFFFFFF
    u[pat == 2] = rng.randint(1 << 31, 1 << 32, ((pat == 2).sum(), n), dtype=np.uint64)
    u[pat == 3] = rng.randint(0, 64, ((pat == 3).sum(), n))
    u[pat == 4] = rng.randint(1, 1 << 20, ((pat == 4).sum(), n)) * (rng.rand((pat == 4).sum(), n) < 0.01)
    edges = [e for e in (95, 96, 255, 256, n - 1) if e < n]
    u[np.ix_(pat == 5, edges)] = 7
    return u.astype(np.uint32)


def _breaks(u, reverse, seed):
    """zero_breaks operands from the codes' zero pattern; rows of patterns
    0-2 carry arbitrary int32."""
    n = u.shape[1]
    x = np.where(u == 0, np.int32(n + 2 if reverse else -n - 2), np.arange(n, dtype=np.int32)).astype(np.int32)
    rand = np.arange(u.shape[0]) % 6 < 3
    x[rand] = np.random.RandomState(seed).randint(-(1 << 31), 1 << 31, (rand.sum(), n), dtype=np.int64)
    return x


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i32(a):
    return jax.lax.bitcast_convert_type(jnp.asarray(a), "int32")


def _scan_call(kernel, n, outs, scratch, reverse=False):
    """Pallas scan kernel in interpret mode over (ROWS, n): 2048-wide
    column tiles where n allows, else one tile per row block."""
    tc = pk._SCAN_TC if n % pk._SCAN_TC == 0 else n
    ncols = n // tc
    cmap = (lambda i, j: (i, jnp.int32(ncols - 1) - j)) if reverse else (lambda i, j: (i, j))
    spec = pl.BlockSpec((pk._SCAN_TR, tc), cmap, memory_space=pltpu.VMEM)
    return pl.pallas_call(
        kernel,
        grid=(ROWS // pk._SCAN_TR, ncols),
        in_specs=[spec],
        out_specs=[spec] * outs if outs > 1 else spec,
        out_shape=[jax.ShapeDtypeStruct((ROWS, n), jnp.int32)] * outs if outs > 1
        else jax.ShapeDtypeStruct((ROWS, n), jnp.int32),
        scratch_shapes=[pltpu.VMEM((pk._SCAN_TR, 1), jnp.int32)] * scratch,
        interpret=True,
    )


def _numpy_kcost(u):
    hi = (u >> 16).astype(np.uint64)
    lo = (u & 0xFFFF).astype(np.uint64)
    s = np.stack([hi.sum(-1)] + [(lo >> k).sum(-1) for k in range(16)], axis=-1)
    return (s % (1 << 32)).astype(np.uint32)


@pytest.mark.parametrize("n", NS)
def test_k_cost_sums_plain(n):
    u = _codes(ROWS, n, 1)
    got = K.k_cost_sums(_t(u.view(np.int32))).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, _numpy_kcost(u))
    if n % 128 == 0:
        call = pl.pallas_call(
            pk._kernel,
            out_shape=jax.ShapeDtypeStruct((ROWS, 128), jnp.int32),
            in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            interpret=True,
        )
        want = np.asarray(call(_i32(u)))[:, :17].view(np.uint32)
        np.testing.assert_array_equal(got, want)


def test_k_cost_sums_strided_head_view():
    """The planner reduces the 256-sample head of each row in place."""
    u = _codes(ROWS, 6144, 2)
    view = _t(u.view(np.int32))[:, :256]
    assert view.stride() == (6144, 1)
    np.testing.assert_array_equal(K.k_cost_sums(view).numpy().view(np.uint32), _numpy_kcost(u[:, :256]))


@pytest.mark.parametrize("n", NS)
def test_split_cumsums_plain(n):
    u = _codes(ROWS, n, 3)
    hi, lo = K.split_cumsums_u32(_t(u.view(np.int32)))
    hi, lo = hi.numpy().view(np.uint32), lo.numpy().view(np.uint32)
    np.testing.assert_array_equal(hi, np.cumsum(u >> 16, -1, dtype=np.uint32))
    np.testing.assert_array_equal(lo, np.cumsum(u & 0xFFFF, -1, dtype=np.uint32))
    if n % 128 == 0:
        phi, plo = _scan_call(pk._split_cumsum_kernel, n, outs=2, scratch=2)(_i32(u))
        np.testing.assert_array_equal(hi, np.asarray(phi).view(np.uint32))
        np.testing.assert_array_equal(lo, np.asarray(plo).view(np.uint32))


@pytest.mark.parametrize("n", NS)
def test_cumsum_plain(n):
    u = _codes(ROWS, n, 4)
    # the adapter's packed micro-window flags, and raw codes (u32 wrap)
    flags = (u >> 31) + ((u & 1) << 16)
    for x in (flags.astype(np.uint32), u):
        got = K.cumsum_u32(_t(x.view(np.int32))).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, np.cumsum(x, -1, dtype=np.uint32))
        if n % 128 == 0:
            want = np.asarray(_scan_call(pk._cumsum_kernel, n, outs=1, scratch=1)(_i32(x)))
            np.testing.assert_array_equal(got, want.view(np.uint32))


@pytest.mark.parametrize("which", ["prefix_max", "suffix_min"])
@pytest.mark.parametrize("n", NS)
def test_break_scans_plain(which, n):
    reverse = which == "suffix_min"
    x = _breaks(_codes(ROWS, n, 5), reverse, 6)
    if reverse:
        got = K.suffix_min_i32(_t(x)).numpy()
        np.testing.assert_array_equal(got, np.flip(np.minimum.accumulate(np.flip(x, -1), -1), -1))
        kernel = pk._suffix_min_kernel
    else:
        got = K.prefix_max_i32(_t(x)).numpy()
        np.testing.assert_array_equal(got, np.maximum.accumulate(x, -1))
        kernel = pk._prefix_max_kernel
    if n % 128 == 0:
        want = np.asarray(_scan_call(kernel, n, outs=1, scratch=1, reverse=reverse)(jnp.asarray(x)))
        np.testing.assert_array_equal(got, want)


def _edge_rows(n):
    """Rows zero except at the adapter's window edges, every warp edge
    (256m - 1, 256m) and the start of every micro window that reaches back
    over one (256m - 97, 256m - 96), so every 2048-wide tile edge, or zero
    only there, as chip_smoke.py's kernel-6 cases."""
    pos = sorted({p for m in range(256, n, 256) for p in (m - 97, m - 96, m - 1, m)} | {95, 96, 255, 256})
    u = np.zeros((4, n), np.uint32)
    u[:3, pos] = np.array([7, 0xFFFFFFFF, 1 << 20], np.uint32)[:, None]
    u[3] = 3
    u[3, pos] = 0
    return u


def _near_threshold_rows(n, seed):
    """Codes that are zero with probability 0.75-0.84, so that the micro
    window's zero count (threshold 77 of 96) crosses its threshold often."""
    rng = np.random.RandomState(seed)
    dens = np.array([0.75, 0.78, 0.81, 0.84])[:, None]
    return (rng.randint(1, 1 << 16, (4, n)) * (rng.rand(4, n) >= dens)).astype(np.uint32)


def _k6_rows(n, seed):
    """16 rows (two of the Pallas kernel's row tiles): the six adversarial
    patterns, four rows near the micro window's zero threshold (where a
    look-back one sample off shows) and four window/warp/tile-edge rows."""
    return np.concatenate([_codes(8, n, seed), _near_threshold_rows(n, seed), _edge_rows(n)])


def _bit_width(x):
    """bit_width of uint64 values < 2^53 (exact in float64)."""
    return np.frexp(x.astype(np.float64))[1].astype(np.int64)


def _tile_k_base(N, c):
    """csrc/k_after.cu's k_base: one funnel shift gives M >> k0 for k0 <= 30."""
    M = np.where(N >= 2 * c, N - c, c)  # the else branch is masked below
    k0 = np.maximum(_bit_width(M) - _bit_width(c), 0)
    shifted = M >> np.minimum(k0, 30).astype(np.uint64)
    assert (shifted[k0 < 31] < (1 << 15)).all()  # so the low word, all the kernel keeps, is all of it
    q = shifted & np.uint64(0xFFFFFFFF)
    k = np.where(k0 >= 31, 31, k0 + (q >= c))
    return np.where(N < 2 * c, 0, k).astype(np.int64)


def _tile_drift(N, c, W):
    """csrc/k_after.cu's drift bias with its 32-bit ranges asserted."""
    lm = (W + np.uint64(128)) >> np.uint64(8)
    assert (lm < (1 << 32)).all()
    t1 = ((np.uint64(3) * lm - np.uint64(1)) >> np.uint64(2)) + np.uint64(1)  # only read where lm >= 1
    assert (t1[lm >= 1] < (1 << 32)).all()
    third = (lm * np.uint64(0xAAAAAAAB)) >> np.uint64(33)  # umulhi(lm, 0xAAAAAAAB) >> 1
    assert ((third + 2) < (1 << 31)).all()
    up = (lm >= 1) & (N < c * t1)
    down = N >= c * lm + c * (third + np.uint64(2))
    return np.where(up, 1, np.where(down, -1, 0))


def _tile_flags(u, k):
    q = np.where(k >= 31, 0, u >> np.minimum(k, 31).astype(np.uint64))
    return (q > 3).astype(np.uint64) + ((q == 0).astype(np.uint64) << np.uint64(16))


def _k_after_by_tiles(u):
    """numpy model of csrc/k_after.cu: one block walks each row in tiles of
    2048 samples (8 warps of 256) and computes a tile's k_after from what it
    holds: the tile's codes, the s carried before the tile, and of the
    previous tile only its last warp's 256 warp-local sums of u and its last
    96 warp-local flag sums, with that warp's totals."""
    rows, n = u.shape
    u = u.astype(np.uint64)
    out = np.zeros((rows, n), np.int64)
    carry = np.zeros(rows, np.uint64)  # s before the tile
    last = None  # the previous tile's last warp: (s total, s sums, flag total, last 96 flag sums)
    for base in range(0, n, 2048):
        ut = u[:, base : base + 2048].reshape(rows, 8, 256)  # warp w holds samples 256w..256w+255
        swl = np.cumsum(ut, axis=-1, dtype=np.uint64)
        wtot = swl[..., -1]
        pre = carry[:, None] + np.cumsum(wtot, -1, dtype=np.uint64) - wtot  # s before each warp
        c = (base + np.arange(2048, dtype=np.uint64) + 1).reshape(8, 256)
        N = pre[..., None] + swl + (c >> np.uint64(1))
        kb = _tile_k_base(N, c)
        # the warp 256 samples back: the previous warp, or the previous tile's last
        back_swl = np.zeros_like(swl)
        back_tot = np.zeros_like(wtot)
        back_swl[:, 1:], back_tot[:, 1:] = swl[:, :-1], wtot[:, :-1]
        if last is not None:
            back_tot[:, 0], back_swl[:, 0] = last[0], last[1]
        W = back_tot[..., None] + swl - back_swl
        bias = np.where((c > 256) & (N >= c), _tile_drift(N, c, W), 0)
        fl = np.cumsum(_tile_flags(ut, kb), axis=-1, dtype=np.uint64)
        ftot = fl[..., -1]
        # the flag sum 96 samples back: this warp, the previous warp, or the previous tile
        w = np.empty_like(fl)
        w[..., 96:] = fl[..., 96:] - fl[..., :-96]
        w[:, 1:, :96] = fl[:, 1:, :96] + ftot[:, :-1, None] - fl[:, :-1, 160:]
        w[:, 0, :96] = fl[:, 0, :96] + (0 if last is None else last[2][:, None] - last[3])
        large, zero = w & np.uint64(0xFFFF), w >> np.uint64(16)
        on = c >= 96
        bias = np.where(on & (large * 4 >= 288), np.minimum(bias + 1, 1),
                        np.where(on & ~(large * 4 >= 288) & (zero * 5 >= 384), np.maximum(bias - 1, -1), bias))
        out[:, base : base + 2048] = np.clip(kb + bias, 0, 31).reshape(rows, 2048)
        carry = carry + wtot.sum(-1)
        last = (wtot[:, 7], swl[:, 7], ftot[:, 7], fl[:, 7, 160:])
    return out


@pytest.mark.parametrize("n", [2048, 4096, 16384])
def test_k_after_stateful_fused_plain(n):
    """Kernel 6's plain version against the fused Pallas kernel
    (interpret mode), the numpy closed form, and a numpy model of the CUDA
    kernel's tile and warp decomposition with its 32-bit range arguments
    asserted."""
    u = _k6_rows(n, 8)
    assert pa.shape_supported(*u.shape)
    got = K.k_after_stateful_fused(_t(u.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref_adapt.k_after_stateful(u.astype(np.uint64), xp=np))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pa.k_after_stateful_fused(u, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), _k_after_by_tiles(u))


# ---- numpy models of the redesigned scan and k-cost kernels
# (csrc/row_scan.cu: row_scan_warp, row_scan_long; csrc/kcost.cu: halve, warp_totals,
# k_cost_block_per_row, k_cost_tree). Each repeats the kernel's own
# decomposition, lane by lane, and is held against the plain version.

_SCAN_OPS = {  # name -> (combine, identity, dtype, the wrapper's direction is reverse)
    "split_cumsums_u32": (np.add, 0, np.uint32, False),
    "cumsum_u32": (np.add, 0, np.uint32, False),
    "prefix_max_i32": (np.maximum, np.iinfo(np.int32).min, np.int32, False),
    "suffix_min_i32": (np.minimum, np.iinfo(np.int32).max, np.int32, True),
}


def _warp_scan_model(x, combine, identity, reverse):
    """row_scan_warp on (rows, n): one warp per row walks 256-element steps;
    a lane holds scan positions p0..p0+7 (position p is element p, or
    n - 1 - p in reverse), as two 4-word vectors where n % 4 == 0 (words
    reversed in registers in the reverse direction) and element by element
    otherwise; serial scan, five shuffle-up steps over the lane totals, the
    exclusive prefix and the row's carry added, the carry taken from lane 31."""
    rows, n = x.shape
    out = np.zeros_like(x)
    written = np.zeros(n, np.int64)
    carry = np.full(rows, identity, x.dtype)
    lanes = np.arange(32)
    vec = n % 4 == 0
    with np.errstate(over="ignore"):
        for base in range(0, n, 256):
            v = np.full((rows, 32, 8), identity, x.dtype)
            elem = np.full((32, 8), -1, np.int64)  # which element each slot holds
            for lane in lanes:
                p0 = base + lane * 8
                for h in (0, 4):
                    if vec:
                        if p0 + h < n:
                            e = n - 4 - (p0 + h) if reverse else p0 + h
                            assert e >= 0 and e % 4 == 0 and e + 4 <= n  # an aligned vector inside the row
                            words = np.arange(e, e + 4)
                            elem[lane, h : h + 4] = words[::-1] if reverse else words
                    else:
                        for j in range(h, h + 4):
                            if p0 + j < n:
                                elem[lane, j] = n - 1 - (p0 + j) if reverse else p0 + j
            live = elem >= 0
            v[:, live] = x[:, elem[live]]
            for j in range(1, 8):
                v[..., j] = combine(v[..., j - 1], v[..., j])
            incl = v[..., 7].copy()
            for d in (1, 2, 4, 8, 16):
                y = np.roll(incl, d, axis=1)  # shfl_up: lanes < d read their own value and ignore it
                incl = np.where(lanes >= d, combine(y, incl), incl)
            excl = np.roll(incl, 1, axis=1)
            prefix = np.where(lanes > 0, combine(carry[:, None], excl), carry[:, None])
            carry = combine(carry, incl[:, 31])
            v = combine(prefix[..., None], v)
            out[:, elem[live]] = v[:, live]
            written[elem[live]] += 1
    assert (written == 1).all()  # every element stored exactly once
    return out


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", [256, 264, 1001, 2048])
@pytest.mark.parametrize("name", sorted(_SCAN_OPS))
def test_warp_scan_decomposition(name, n, reverse):
    """The warp-per-row scan's decomposition, for every op in both
    directions, against numpy, the plain version (in the wrapper's own
    direction) and the Pallas kernel (interpret mode, where it tiles)."""
    combine, identity, dtype, wrapper_reverse = _SCAN_OPS[name]
    u = _codes(ROWS, n, 11)
    x = u if dtype == np.uint32 else _breaks(u, reverse, 12)
    halves = [x >> 16, x & 0xFFFF] if name == "split_cumsums_u32" else [x]
    got = [_warp_scan_model(h, combine, identity, reverse) for h in halves]
    flip = (lambda a: np.flip(a, -1)) if reverse else (lambda a: a)
    for g, h in zip(got, halves):
        np.testing.assert_array_equal(g, flip(combine.accumulate(flip(h), axis=-1, dtype=dtype)))
    if reverse != wrapper_reverse:
        return
    plain = getattr(K, name)(_t(x.view(np.int32)))
    plain = plain if isinstance(plain, tuple) else (plain,)
    for g, w in zip(got, plain):
        np.testing.assert_array_equal(g.view(np.int32), w.numpy())
    if n % 128 == 0:
        kernel, outs, scratch = {"split_cumsums_u32": (pk._split_cumsum_kernel, 2, 2),
                                 "cumsum_u32": (pk._cumsum_kernel, 1, 1),
                                 "prefix_max_i32": (pk._prefix_max_kernel, 1, 1),
                                 "suffix_min_i32": (pk._suffix_min_kernel, 1, 1)}[name]
        want = _scan_call(kernel, n, outs=outs, scratch=scratch, reverse=reverse)(_i32(x.view(np.uint32)))
        want = want if isinstance(want, (tuple, list)) else (want,)
        for w, pw in zip(plain, want):
            np.testing.assert_array_equal(w.numpy(), np.asarray(pw))


# csrc/row_scan.cu: row_scan_long, the long-row kernel (n > LAC_SCAN_SHORT_MAX)
_LONG_CHUNK = 16384


def _long_scan_model(x, combine, identity, reverse):
    """row_scan_long on (rows, n): one block (16 warps) per row takes chunks
    of 16384 scan positions, 64 pieces of 256; warp w takes pieces w, w + 16,
    w + 32, w + 48, and in each piece lane l the positions 4 l .. 4 l + 3 of
    both 128-position halves (position p is element p, or n - 1 - p in
    reverse), as 4-word vectors where n % 4 == 0 (words reversed in
    registers in the reverse direction) and element by element otherwise.
    Per piece: serial scans of the two runs, five shuffle-up steps over the
    run totals of each half, the lane's exclusive prefixes kept and the
    piece total written; after the barrier every warp scans the 64 totals,
    two a lane (a serial step, five shuffle steps), the row's carry in front;
    a piece takes its prefix from lane piece // 2 (even or odd piece), and
    the chunk total is carried into the next chunk."""
    rows, n = x.shape
    out = np.zeros_like(x)
    written = np.zeros(n, np.int64)
    carry = np.full(rows, identity, x.dtype)
    lanes = np.arange(32)
    vec = n % 4 == 0

    def warp_scan(t):  # inclusive shuffle-up scan over the lanes (last axis)
        for d in (1, 2, 4, 8, 16):
            y = np.roll(t, d, axis=-1)  # shfl_up: lanes < d read their own value and ignore it
            t = np.where(lanes >= d, combine(y, t), t)
        return t

    with np.errstate(over="ignore"):
        for base in range(0, n, _LONG_CHUNK):
            tot = np.full((rows, 64), identity, x.dtype)
            parts = []
            for w in range(16):
                for s in range(4):
                    pc = 16 * s + w
                    elem = np.full((32, 8), -1, np.int64)  # which element each slot holds
                    for lane in lanes:
                        for h in (0, 1):
                            p = base + 256 * pc + 128 * h + 4 * lane
                            if vec:
                                if p < n:
                                    e = n - 4 - p if reverse else p
                                    assert e >= 0 and e % 4 == 0 and e + 4 <= n  # an aligned vector inside the row
                                    words = np.arange(e, e + 4)
                                    elem[lane, 4 * h : 4 * h + 4] = words[::-1] if reverse else words
                            else:
                                for k in range(4):
                                    if p + k < n:
                                        elem[lane, 4 * h + k] = n - 1 - (p + k) if reverse else p + k
                    live = elem >= 0
                    v = np.full((rows, 32, 8), identity, x.dtype)
                    v[:, live] = x[:, elem[live]]
                    for k in range(1, 4):
                        v[..., k] = combine(v[..., k - 1], v[..., k])
                        v[..., 4 + k] = combine(v[..., 3 + k], v[..., 4 + k])
                    i0, i1 = warp_scan(v[..., 3].copy()), warp_scan(v[..., 7].copy())
                    first = i0[:, 31:]
                    pre0 = np.where(lanes > 0, np.roll(i0, 1, axis=-1), identity)
                    pre1 = np.where(lanes > 0, combine(first, np.roll(i1, 1, axis=-1)), first)
                    tot[:, pc] = combine(first[:, 0], i1[:, 31])  # lane 31 writes the piece total
                    parts.append((pc, elem, live, v, pre0, pre1))
            t0 = tot[:, 0::2]
            incl = warp_scan(combine(t0, tot[:, 1::2]))
            even = np.where(lanes > 0, combine(carry[:, None], np.roll(incl, 1, axis=-1)), carry[:, None])
            odd = combine(even, t0)
            for pc, elem, live, v, pre0, pre1 in parts:
                before = (odd if pc & 1 else even)[:, pc >> 1, None]
                v[..., :4] = combine(combine(before, pre0)[..., None], v[..., :4])
                v[..., 4:] = combine(combine(before, pre1)[..., None], v[..., 4:])
                out[:, elem[live]] = v[:, live]
                written[elem[live]] += 1
            carry = combine(carry, incl[:, 31])
    assert (written == 1).all()  # every element stored exactly once
    return out


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("n", [2052, 4096, 6144, 16384, 16390, 20480])
@pytest.mark.parametrize("name", sorted(_SCAN_OPS))
def test_long_scan_decomposition(name, n, reverse):
    """The long-row block scan's decomposition, for every op in both
    directions, against numpy, the plain version (in the wrapper's own
    direction) and the Pallas kernel (interpret mode, where it tiles). Rows
    over 16384 cross a chunk (the carry); 16390 takes the scalar path."""
    combine, identity, dtype, wrapper_reverse = _SCAN_OPS[name]
    u = _codes(ROWS, n, 13)
    x = u if dtype == np.uint32 else _breaks(u, reverse, 14)
    halves = [x >> 16, x & 0xFFFF] if name == "split_cumsums_u32" else [x]
    got = [_long_scan_model(h, combine, identity, reverse) for h in halves]
    flip = (lambda a: np.flip(a, -1)) if reverse else (lambda a: a)
    for g, h in zip(got, halves):
        np.testing.assert_array_equal(g, flip(combine.accumulate(flip(h), axis=-1, dtype=dtype)))
    if reverse != wrapper_reverse:
        return
    plain = getattr(K, name)(_t(x.view(np.int32)))
    plain = plain if isinstance(plain, tuple) else (plain,)
    for g, w in zip(got, plain):
        np.testing.assert_array_equal(g.view(np.int32), w.numpy())
    if n % pk._SCAN_TC == 0:
        kernel, outs, scratch = {"split_cumsums_u32": (pk._split_cumsum_kernel, 2, 2),
                                 "cumsum_u32": (pk._cumsum_kernel, 1, 1),
                                 "prefix_max_i32": (pk._prefix_max_kernel, 1, 1),
                                 "suffix_min_i32": (pk._suffix_min_kernel, 1, 1)}[name]
        want = _scan_call(kernel, n, outs=outs, scratch=scratch, reverse=reverse)(_i32(x.view(np.uint32)))
        want = want if isinstance(want, (tuple, list)) else (want,)
        for g, pw in zip(got, want):
            np.testing.assert_array_equal(g.view(np.int32), np.asarray(pw))


def _halve(v, m, off):
    """kcost.cu's halve<m> over the lanes of the second-last axis: of m live
    sums the lane with bit ``off`` clear keeps the first ceil(m / 2), its
    partner (lane ^ off) the rest, zero-padded; each adds the other's copy."""
    h = (m + 1) // 2
    v = v.copy()
    if m & 1:
        v[..., m] = 0
    lanes = np.arange(v.shape[-2])
    upper = ((lanes & off) != 0)[:, None]
    keep = np.where(upper, v[..., h : 2 * h], v[..., :h])
    give = np.where(upper, v[..., :h], v[..., h : 2 * h])
    v[..., :h] = keep + give[..., lanes ^ off, :]
    return v


def _warp_totals(v):
    """kcost.cu's warp_totals on (..., 32, 18): the 17 totals over the 32 lanes."""
    for m, off in ((17, 16), (9, 8), (5, 4), (3, 2), (2, 1)):
        v = _halve(v, m, off)
    out = np.zeros(v.shape[:-2] + (17,), np.uint32)
    seen = []
    for lane in range(32):
        j3 = (2 if lane & 2 else 0) + (lane & 1)
        j2 = (3 if lane & 4 else 0) + j3
        j1 = (5 if lane & 8 else 0) + j2
        k = (9 if lane & 16 else 0) + j1
        if j3 < 3 and j2 < 5 and j1 < 9 and k < 17:
            out[..., k] = v[..., lane, 0]
            seen.append(k)
    assert sorted(seen) == list(range(17))  # every sum leaves through exactly one lane
    return out


def _group_totals(v):
    """k_cost_tree's reduction on (..., 8, 18): the 17 totals over a group of
    8 lanes, three values left in each lane."""
    for m, off in ((17, 4), (9, 2), (5, 1)):
        v = _halve(v, m, off)
    out = np.zeros(v.shape[:-2] + (17,), np.uint32)
    seen = []
    for lane in range(8):
        for j in range(3):
            j2 = (3 if lane & 1 else 0) + j
            j1 = (5 if lane & 2 else 0) + j2
            k = (9 if lane & 4 else 0) + j1
            if j2 < 5 and j1 < 9 and k < 17:
                out[..., k] = v[..., lane, j]
                seen.append(k)
    assert sorted(seen) == list(range(17))
    return out


def _lane_partials(u, lo, hi, stride, vec):
    """accumulate_span: elements lo..hi of each row shared among ``stride``
    threads (whole 4-word vectors first where ``vec``, then single words):
    (rows, stride, 18) partial sums, slot 17 unused."""
    rows = u.shape[0]
    acc = np.zeros((rows, stride, 18), np.uint32)
    owner = np.empty(hi - lo, np.int64)
    nv = (hi - lo) // 4 if vec else 0
    owner[: 4 * nv] = np.repeat(np.arange(nv) % stride, 4)
    owner[4 * nv :] = np.arange(hi - lo - 4 * nv) % stride
    for t in range(stride):
        mine = u[:, lo:hi][:, owner == t]
        acc[:, t, :17] = _numpy_kcost(mine)
    return acc


def _block_per_row_model(u, head):
    """k_cost_block_per_row: 256 threads add the head's samples, copy their
    accumulators for the head sums, go on over the rest of the row; each
    warp's totals meet in shared memory."""
    vec = head % 4 == 0 and u.shape[1] % 4 == 0  # 16-byte aligned rows and head
    acc = _lane_partials(u, 0, head, 256, vec)
    head_sums = _warp_totals(acc.reshape(-1, 8, 32, 18)).sum(axis=1, dtype=np.uint32)
    acc = acc + _lane_partials(u, head, u.shape[1], 256, vec)
    return head_sums, _warp_totals(acc.reshape(-1, 8, 32, 18)).sum(axis=1, dtype=np.uint32)


def _tree_model(u, levels, block=256):
    """k_cost_tree: groups of 8 lanes reduce the finest order's segments into a
    block's shared memory, laid out as the output (order p at entries
    2^p - 1 .. 2^(p+1) - 2 of its row); the orders are folded pairwise there;
    a block takes 32 / 2^levels rows where a row has fewer segments than the
    block has groups."""
    rows, n = u.shape
    nparts, seg, groups = 1 << levels, n >> levels, block // 8
    entries = 2 * nparts - 1
    block_rows = 1 if nparts >= groups else groups // nparts
    out = np.zeros((rows, entries, 17), np.uint32)
    for row0 in range(0, rows, block_rows):
        sums = np.zeros((block_rows, entries, 17), np.uint32)
        assert (block_rows * nparts) % groups == 0  # every group makes the same number of turns
        for sg in range(block_rows * nparts):
            r, s = sg >> levels, sg & (nparts - 1)
            acc = np.zeros((1, 8, 18), np.uint32)
            if row0 + r < rows:
                acc = _lane_partials(u[row0 + r : row0 + r + 1, s * seg : (s + 1) * seg], 0, seg, 8, seg % 4 == 0)
            sums[r, nparts - 1 + s] = _group_totals(acc)[0]
        for p in range(levels - 1, -1, -1):
            np_ = 1 << p
            for r in range(block_rows):
                for j in range(np_):
                    sums[r, np_ - 1 + j] = sums[r, 2 * np_ - 1 + 2 * j] + sums[r, 2 * np_ - 1 + 2 * j + 1]
        live = min(block_rows, rows - row0)
        out[row0 : row0 + live] = sums[:live]
    return [out[:, (1 << p) - 1 : (2 << p) - 1] for p in range(levels + 1)]


def _pallas_kcost(u):
    call = pl.pallas_call(
        pk._kernel,
        out_shape=jax.ShapeDtypeStruct((u.shape[0], 128), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(call(_i32(np.ascontiguousarray(u))))[:, :17].view(np.uint32)


@pytest.mark.parametrize("n,head", [(16384, 256), (4096, 256), (2048, 128), (1001, 256), (500, 256), (300, 7),
                                    (256, 256), (64, 256)])
def test_k_cost_head_and_row_pass(n, head):
    """Head sums and row sums from one pass: the wrapper's ``head``
    argument and the block-per-row kernel's decomposition against numpy and,
    where it tiles, the Pallas kernel on the head window and on the row."""
    u = _codes(ROWS, n, 13)
    h = min(head, n)
    got_head, got_row = (t.numpy().view(np.uint32) for t in K.k_cost_sums(_t(u.view(np.int32)), head=head))
    np.testing.assert_array_equal(got_head, _numpy_kcost(u[:, :h]))
    np.testing.assert_array_equal(got_row, _numpy_kcost(u))
    np.testing.assert_array_equal(got_row, K.k_cost_sums(_t(u.view(np.int32))).numpy().view(np.uint32))
    model_head, model_row = _block_per_row_model(u, h)
    np.testing.assert_array_equal(model_head, got_head)
    np.testing.assert_array_equal(model_row, got_row)
    if n % 128 == 0 and h % 128 == 0:
        np.testing.assert_array_equal(got_head, _pallas_kcost(u[:, :h]))
        np.testing.assert_array_equal(got_row, _pallas_kcost(u))


@pytest.mark.parametrize("rows,n,levels", [(5, 16384, 8), (8, 4096, 7), (37, 256, 3), (37, 64, 1), (3, 12288, 8),
                                           (16, 1000, 3), (37, 1001, 0), (70, 256, 0), (9, 2048, 6), (6, 8192, 5)])
def test_k_cost_partition_sums(rows, n, levels):
    """Every partition order from one read: the plain version against numpy
    and the Pallas kernel (on the orders whose parts it tiles), the segment
    tree's decomposition against the plain version, and the heads of
    min(256, n >> p) samples as the planner slices them from the order
    whose parts are 256 long."""
    u = _codes(rows, n, 14)
    plain = K.k_cost_partition_sums(_t(u.view(np.int32)), levels)
    assert [tuple(t.shape) for t in plain] == [(rows, 1 << p, 17) for p in range(levels + 1)]
    model = _tree_model(u, levels, block=512 if levels >= 6 else 256)
    for p in range(levels + 1):
        parts = u.reshape(rows << p, n >> p)
        got = plain[p].numpy().view(np.uint32)
        np.testing.assert_array_equal(got.reshape(-1, 17), _numpy_kcost(parts))
        np.testing.assert_array_equal(model[p], got)
        if (n >> p) % 128 == 0:
            np.testing.assert_array_equal(got.reshape(-1, 17), _pallas_kcost(parts))
    if n & (n - 1) == 0:
        head_order = max(n // 256, 1).bit_length() - 1
        for p in range(1, levels + 1):
            heads = plain[head_order][:, :: 1 << (head_order - p)] if p < head_order else plain[p]
            want = _numpy_kcost(u.reshape(rows << p, n >> p)[:, :256])
            np.testing.assert_array_equal(heads.numpy().view(np.uint32).reshape(-1, 17), want)


def test_k_cost_partition_sums_rejects_unequal_parts():
    with pytest.raises(ValueError):
        K.k_cost_partition_sums(torch.zeros((4, 1000), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        K.k_cost_partition_sums(torch.zeros((4, 1024), dtype=torch.int32), 9)
    with pytest.raises(ValueError):
        K.k_cost_sums(torch.zeros((4, 1024), dtype=torch.int32), head=0)


def test_k_after_routing_by_shape():
    """Full-width rows are what the kernel takes; probe and odd rows keep
    the split chain (kernels 2 and 3 on the card)."""
    assert all(K.k_after_shape_supported(n) for n in (2048, 4096, 16384))
    assert not any(K.k_after_shape_supported(n) for n in (256, 1001, 1024, 3000, 32768))


def test_cpu_tensors_never_count_a_launch():
    K.reset_launches()
    u = _t(_codes(8, 300, 7).view(np.int32))
    K.k_cost_sums(u)
    K.split_cumsums_u32(u)
    K.cumsum_u32(u)
    K.prefix_max_i32(u)
    K.suffix_min_i32(u)
    K.k_after_stateful_fused(_t(_codes(8, 2048, 7).view(np.int32)))
    K.tokenize_static_rice_scan(_t(_codes(8, 64, 7).view(np.uint8)), torch.zeros(8, dtype=torch.int32),
                                torch.zeros(8, dtype=torch.int32), 5)
    assert K.launches == dict.fromkeys(K.launches, 0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        K.cumsum_u32(torch.zeros((4, 8), dtype=torch.int64))
    with pytest.raises(TypeError):
        K.prefix_max_i32(torch.zeros((8,), dtype=torch.int32))
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain-version fallback
        K.k_cost_sums(torch.zeros((4, 8), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        K.k_after_stateful_fused(torch.zeros((4, 2048), dtype=torch.int32, device="meta"))
    meta = {"dtype": torch.int32, "device": "meta"}
    with pytest.raises(ValueError):
        K.tokenize_static_rice_scan(torch.zeros((4, 8), dtype=torch.uint8, device="meta"), torch.zeros(4, **meta),
                                    torch.zeros(4, **meta), 3)


def test_kernel_build_without_nvcc_raises(monkeypatch):
    """A missing CUDA toolkit is an error, never a silent fallback."""
    monkeypatch.setattr(_cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setattr(_cuda_lib, "BUILD_DIR", _cuda_lib.BUILD_DIR / "_absent_for_test")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_lib.build_library()


# ---------------------------------------------------------------- kernel 8


def _rice_scan_model(payload, k, nbits, T):
    """csrc/rice_scan.cu's serial lane (its careful lanes), one lane at a time,
    in Python integers taken modulo 2^64 (the JAX step function of
    device_reader.py:164-180)."""
    M64 = (1 << 64) - 1
    lanes, nby = payload.shape
    res = np.zeros((lanes, T), np.int32)
    valid = np.zeros((lanes, T), bool)

    def shl(x, s):
        return (x << s) & M64 if s < 64 else 0

    def shr(x, s):
        return x >> s if s < 64 else 0

    for li in range(lanes):
        row = [int(b) for b in payload[li]]
        kk = int(k[li]) & M64  # numpy's int32 -> u64: sign-extended
        pos = 0
        for t in range(T):
            byteidx = min(pos >> 3, max(nby - 8, 0))
            w = 0
            for b in range(8):
                w = (w << 8) | row[min(byteidx + b, nby - 1)]
            w = shl(w, min(pos - (byteidx << 3), 63))
            nw = ~w & M64
            q = 64 - nw.bit_length()
            rem = shr(shl(w, q + 1), (64 - kk) & M64) if kk else 0
            u = (shl(q, kk) | rem) & 0xFFFFFFFF
            r = (u >> 1) ^ (0xFFFFFFFF if u & 1 else 0)
            res[li, t] = r - (1 << 32) if r >> 31 else r
            start = pos & 0xFFFFFFFF
            valid[li, t] = (start - (1 << 32) if start >> 31 else start) < int(nbits[li])
            pos = (pos + q + 1 + kk) & M64
    return res, valid


def _rice_scan_cases():
    from lac_tpu_torch.experiments import bench_device_reader

    cases = [(label, pay, ks, nb, T) for label, pay, ks, nb, T in bench_device_reader.adversarial_batches()]
    rng = np.random.RandomState(12)
    ks, vals = bench_device_reader.make_lanes(rng, 4, 96)
    pay, nb = bench_device_reader.pack_lanes(vals, ks, torch.device("cpu"))
    cases.append(("real lanes (4, 96), and 24 tokens past them", pay.numpy(), ks, nb.numpy(), 120))
    return cases


@pytest.mark.parametrize("case", range(5))
def test_tokenize_static_rice_scan_plain(case):
    """Kernel 8's plain version against a scalar model of its thread on hard
    lanes (k = 0, 15, 31 and -1, the 57-bit cap, q = 64, NBY < 8, nbits = 0)
    and real ones, every output element."""
    label, pay, ks, nb, T = _rice_scan_cases()[case]
    res, valid = K.tokenize_static_rice_scan_plain(_t(pay), _t(ks), _t(nb), T)
    want_res, want_valid = _rice_scan_model(pay, ks, nb, T)
    np.testing.assert_array_equal(res.numpy(), want_res, err_msg=label)
    np.testing.assert_array_equal(valid.numpy(), want_valid, err_msg=label)


def _kernel8_design():
    """csrc/rice_scan.cu's build-time constants, read from the source so the
    model below runs at the kernel's own."""
    src = (pathlib.Path(K.__file__).resolve().parent.parent / "csrc" / "rice_scan.cu").read_text()

    def num(pattern):
        return int(re.search(pattern, src).group(1))

    return {"threads": num(r"kThreads = (\d+);"), "W": num(r"#define LAC_RICE_SCAN_W (\d+)"),
            "warm": num(r"#define LAC_RICE_SCAN_WARM (\d+)"), "min_seg": num(r"kMinSegBits = (\d+);"),
            "region": num(r"kRegion = (\d+);"), "halo": num(r"kHalo = (\d+);"), "window": num(r"kWindow = (\d+);"),
            "rec": num(r"kRec = (\d+);"), "max_k": num(r"kMaxFastK = (\d+);")}


def _rice_scan_segmented_model(payload, k, nbits, T, threads, W, region, window, warm=0, rec=4, halo=16, max_k=63,
                               min_seg=64):
    """csrc/rice_scan.cu's block, one lane at a time: the row staged region by
    region, the speculative pass (each from ``warm`` bits before its segment,
    not counted), the fixpoint rounds (every thread reads the last round's
    exits), the scan of counts, the write pass into windows of
    ``window`` tokens from each chunk's first token on (each token written
    once, a window stored only once all its tokens are staged; the head's
    valid flags from the first start not below nbits), the closed-form
    tail, and the serial loop on careful lanes.
    W = 0 takes the kernel's own segment width: a region's head over the
    block (one chunk), at least ``min_seg`` bits, whole words. Returns (res,
    valid, rounds): rounds[lane] is the list of fixpoint rounds of each
    chunk, None for a careful lane."""
    M64 = (1 << 64) - 1
    lanes, nby = payload.shape
    res = np.zeros((lanes, T), np.int32)
    valid = np.zeros((lanes, T), bool)
    rounds = []

    def unzigzag(u):
        r = (u >> 1) ^ (0xFFFFFFFF if u & 1 else 0)
        return r - (1 << 32) if r >> 31 else r

    def i32(x):
        x &= 0xFFFFFFFF
        return x - (1 << 32) if x >> 31 else x

    for li in range(lanes):
        kk, nb = int(k[li]), int(nbits[li])
        if kk < 0 or kk > max_k or nby < 8:
            r, v = _rice_scan_model(payload[li : li + 1], k[li : li + 1], nbits[li : li + 1], T)
            res[li], valid[li] = r[0], v[0]
            rounds.append(None)
            continue
        row = bytes(payload[li])
        nz = np.flatnonzero(payload[li])
        zb = int(nz[-1]) + 1 if len(nz) else 0
        if zb < nby:
            ts, stride, tail_res = 8 * zb, 1 + kk, 0
        elif row[-1] & 1:
            ts, stride, tail_res = 8 * nby - 1, 2 + kk, unzigzag((1 << kk) & 0xFFFFFFFF)
        else:
            ts, stride, tail_res = 8 * nby - 1, 1 + kk, 0
        staged = {"g0": None, "buf": b""}

        def window_at(pos):
            """Bits [pos, pos + 64) of the staged bytes (zeros past them), masked
            to the JAX window: the read must stay inside the staged region."""
            lb = pos - 8 * staged["g0"]
            assert 0 <= lb < 8 * region, "a parse left its staged region"
            v = int.from_bytes(staged["buf"][lb >> 3 : (lb >> 3) + 9], "big")
            return (v >> (8 - (lb & 7))) & M64 & (M64 << (pos & 7))

        def token(pos):
            w = window_at(pos)
            q = 64 - ((~w) & M64).bit_length()
            rem = ((w << (q + 1)) & M64) >> (64 - kk) if kk and q < 63 else 0
            return q + 1 + kk, unzigzag((((q << kk) & M64) | rem) & 0xFFFFFFFF)

        def parse(pos, end, recs=None, sync=None):
            """From pos while pos < end: (exit, count). ``recs`` keeps the
            first ``rec`` starts {index: start}; ``sync`` = (those, count,
            exit) of the speculative parse: landing on one of its kept
            starts, it goes on as that parse did."""
            n = 0
            while pos < end:
                if sync is not None and pos in sync[0].values():
                    j = next(i for i, p in sync[0].items() if p == pos)
                    return sync[2], n + sync[1] - j
                if recs is not None and n < rec:
                    recs[n] = pos
                pos += token(pos)[0]
                n += 1
            return pos, n

        lane_rounds, out = [], {}
        entry, base, vcut = 0, 0, T
        g0 = 0
        while entry < ts and base < T:
            stop = min(nby, g0 + region + halo)
            staged["g0"], staged["buf"] = g0, row[g0:stop] + bytes(8 * region + 32)
            rend = min(ts, 8 * (g0 + region))
            seg = W or max(min_seg, (-(-(rend - 8 * g0) // threads) + 31) & ~31)
            cs = 8 * g0
            while cs < rend and base < T:
                active = min(-(-(rend - cs) // seg), threads)  # segments that start below rend
                sb = [min(cs + i * seg, rend) for i in range(threads)]
                se = [min(s + seg, rend) for s in sb]
                entries = [entry] + sb[1:]
                for i in range(1, active):  # the first start at or after sb of a parse begun `warm` bits earlier
                    entries[i] = max(sb[i] - warm, 8 * g0)
                    while entries[i] < sb[i]:
                        entries[i] += token(entries[i])[0]
                recs = [{} for _ in range(threads)]
                spec = [parse(entries[i], se[i], recs=recs[i]) for i in range(threads)]
                exits, counts = [x for x, _ in spec], [c for _, c in spec]
                n_rounds = 0
                while True:
                    n_rounds += 1
                    new = [entry] + exits[:-1]  # every thread reads the last round's exits
                    changed = False
                    for i in range(1, active):
                        if new[i] != entries[i]:
                            entries[i] = new[i]
                            x, counts[i] = parse(new[i], se[i], sync=(recs[i], spec[i][1], spec[i][0]))
                            changed |= x != exits[i]
                            exits[i] = x
                    if not changed:
                        break
                lane_rounds.append(n_rounds)
                assert all(entries[i] == exits[i - 1] for i in range(1, active))
                assert not any(counts[active:])
                firsts = list(base + np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int))
                total = sum(counts)
                for w0 in range(base, min(base + total, T), window):  # the write pass, a window at a time
                    w1, staging = min(w0 + window, T), {}
                    for i in range(threads):
                        if counts[i] and firsts[i] < w1 and firsts[i] + counts[i] > w0:
                            pos = entries[i]
                            for idx in range(firsts[i], min(firsts[i] + counts[i], w1)):
                                length, value = token(pos)
                                if idx >= w0:
                                    assert idx not in staging and idx not in out
                                    staging[idx] = value
                                    if i32(pos) >= nb:
                                        vcut = min(vcut, idx)
                                pos += length
                    assert sorted(staging) == list(range(w0, min(w1, base + total))), "a window stored part-filled"
                    out.update({idx: (value, idx < vcut) for idx, value in staging.items()})
                entry, base = exits[active - 1], base + total
                cs += threads * seg
            g0 += region
        for idx in range(base, T):  # the tail in closed form
            out[idx] = (tail_res, i32(entry + (idx - base) * stride) < nb)
        assert sorted(out) == list(range(T))
        res[li] = [out[i][0] for i in range(T)]
        valid[li] = [out[i][1] for i in range(T)]
        rounds.append(lane_rounds)
    return res, valid, rounds


def _segmented_cases():
    from lac_tpu_torch.experiments import bench_device_reader

    cases = [(label, pay, ks, nb, T) for label, pay, ks, nb, T in bench_device_reader.adversarial_batches()]
    cases += bench_device_reader.sync_hostile_batches()
    ks, vals = bench_device_reader.make_lanes(np.random.RandomState(12), 4, 300)
    pay, nb = bench_device_reader.pack_lanes(vals, ks, torch.device("cpu"))
    cases.append(("real lanes (4, 300), and 24 tokens past them", pay.numpy(), ks, nb.numpy(), 324))
    return cases


# (threads, W bits, region bytes, window tokens, warm-up bits): the kernel's
# own; small blocks whose rows span many chunks, regions and windows, with a
# warm-up; W = 1 bit, where a segment holds at most one token start, without
SEGMENT_DESIGNS = {"kernel": None, "small": (8, 16, 64, 16, 24), "one-bit segments": (8, 1, 8, 8, 0)}


def _segmented_run(case, design):
    label, pay, ks, nb, T = _segmented_cases()[case]
    if SEGMENT_DESIGNS[design] is None:
        d = _kernel8_design()
        args = {key: d[key] for key in ("threads", "W", "region", "window", "warm", "rec", "halo", "max_k",
                                        "min_seg")}
    else:
        args = dict(zip(("threads", "W", "region", "window", "warm"), SEGMENT_DESIGNS[design]))
    return label, pay, ks, nb, T, _rice_scan_segmented_model(pay, ks, nb, T, **args)


@pytest.mark.parametrize("design", list(SEGMENT_DESIGNS))
@pytest.mark.parametrize("case", range(7))
def test_kernel_8_segmented_model_equals_the_jax_scan(case, design):
    """The model of csrc/rice_scan.cu's segmented parse equals the JAX scan
    (lac_tpu's tokenize_static_rice_scan on the CPU) and the plain version on
    every output element: hard lanes, sync-hostile lanes, real lanes, at the
    kernel's segment width and block, at small ones and at W = 1 bit."""
    label, pay, ks, nb, T, (res, valid, _) = _segmented_run(case, design)
    want_res, want_valid = jax.device_get(ref_reader.tokenize_static_rice_scan(jnp.asarray(pay), ks, nb, T))
    np.testing.assert_array_equal(res, np.asarray(want_res), err_msg=label)
    np.testing.assert_array_equal(valid, np.asarray(want_valid), err_msg=label)
    plain = K.tokenize_static_rice_scan_plain(_t(pay), _t(ks), _t(nb), T)
    np.testing.assert_array_equal(res, plain[0].numpy(), err_msg=label)
    np.testing.assert_array_equal(valid, plain[1].numpy(), err_msg=label)


def test_kernel_8_model_rounds_where_they_are_known():
    """At the kernel's design, real and hard lanes end in one or two fixpoint
    rounds a chunk (the speculative pass already met the true parse, or one
    segment had not); an interior zero run (k >= 1) or the two-phase lane walks
    one segment a round through its 2400 bits; the trailing zeros of short
    lanes cost nothing (closed form); careful lanes (k = -1, k = 64) run the
    serial loop."""
    seg = _kernel8_design()["min_seg"]  # these rows are short: every lane takes the least segment width
    for case in (0, 6):  # adversarial lanes, real lanes
        label, _, ks, _, _, (_, _, rounds) = _segmented_run(case, "kernel")
        for kv, r in zip(ks, rounds):
            assert (r is None) == (kv < 0) and (r is None or max(r, default=1) <= 2), (label, kv, r)
    label, _, ks, _, _, (_, _, rounds) = _segmented_run(4, "kernel")
    assert list(ks) == [1, 3, 15, 4, 7, 0, 5, 2, 64]
    for lane in (0, 1, 2, 7):  # zero runs at k = 1, 3, 15; the two-phase lane
        # one round a segment through the run: its whole segments but the partial one at each end
        assert max(rounds[lane]) >= 2400 // seg - 2, (label, lane, rounds[lane])
    assert [max(rounds[lane]) for lane in (3, 4)] == [1, 1]  # short lanes
    assert rounds[8] is None


def test_sync_hostile_lanes_cover_what_they_claim():
    from lac_tpu_torch.experiments import bench_device_reader

    (_, pay, ks, nb, T), (_, ends, ks2, nb2, T2) = bench_device_reader.sync_hostile_batches()
    nz = [np.flatnonzero(row) for row in pay]
    assert [int(v[-1]) + 1 < pay.shape[1] // 4 for v in nz[3:5]] == [True, True]  # far shorter than the longest
    for lane, k in enumerate((1, 3, 15)):  # a zero run of 2400 bits inside the stream
        ones = np.flatnonzero(np.unpackbits(pay[lane])[: nb[lane]])
        assert ks[lane] == k and (np.diff(ones) - 1).max() >= 2400
    assert ks[8] > _kernel8_design()["max_k"]
    assert list(ends[:, -1] & 1) == [1, 1, 0, 0] and (ends[:, -1] != 0).all()
    res, valid = K.tokenize_static_rice_scan(_t(ends), _t(ks2), _t(nb2), T2)
    assert not valid.all() and valid.any()  # tokens past the rows
