"""Kernels 9 and 10, the planner's mode-cost sums (csrc/mode_costs.cu).

``cuda_kernels.mode_cost_sums`` (whole rows) and
``cuda_kernels.partition_cost_sums`` (every part of partition orders
1..max_p) on CPU tensors take their plain versions. Here those are held
bit for bit against numpy models of the CUDA source's row algorithms (a
thread's four contiguous samples with the k_after[i - 1] hand-over from
the lane before; kernel 10's general path: u64 prefix sums staged per
row, each warp's range walked 32 samples a step with a flush where a step
crosses into the next part; its power-of-two path: a lane's chunk of R
samples inside one part of every order, lane constants, edge zero runs
clipped per order, 32-bit or 64-bit lanes, a segmented reduction) and
against lac_tpu's own pieces under ``xp=numpy``:
``encoder._mode_cost_fields``, ``ops.runs.run_geometry`` /
``zero_breaks``, ``ops.adapt.k_used_from_after`` /
``k_after_stateless``, on rows that reach every branch (all zeros, zero
runs of 3, 4 and 5 across part edges, u = 2^32 - 1, codes at the escape
threshold and one above, k = 31, initial k 0 and 12). Integers: every
comparison is exact. The card's kernels are held to the same plain
versions by chip_smoke.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu import encoder as ref_enc  # noqa: E402
from lac_tpu.ops import adapt as ref_adapt  # noqa: E402
from lac_tpu.ops import runs as ref_runs  # noqa: E402
from lac_tpu.ops._backend import shift_right as ref_shift_right  # noqa: E402
from lac_tpu_torch.format import constants as C  # noqa: E402
from lac_tpu_torch.ops import cuda_kernels as K  # noqa: E402

SOURCE = Path(__file__).resolve().parent.parent / "lac_tpu_torch" / "csrc" / "mode_costs.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


# ------------------------------------------------------------------ inputs


def _codes(rows, n, seed):
    """(rows, n) u32 codes, one pattern a row: noise of several widths,
    all zeros, all 2^32 - 1, sparse bursts with zero runs of 3, 4 and 5
    placed across every power-of-two edge, codes of both parities near the
    escape thresholds 2^3..2^24, and 24-bit-sized codes."""
    rng = np.random.RandomState(seed)
    u = np.zeros((rows, n), np.uint64)
    for r in range(rows):
        kind = r % 7
        if kind == 0:
            u[r] = rng.randint(0, 1 << (4 + 3 * (r % 5)), n)
        elif kind == 2:
            u[r] = (1 << 32) - 1
        elif kind == 3:
            u[r] = rng.randint(1, 9, n)
            for edge in range(32, n, 32):
                length = 3 + (edge // 32) % 3  # runs of 3, 4, 5
                at = edge - length // 2 - (edge // 64) % 2
                u[r, max(at, 0) : at + length] = 0
        elif kind == 4:
            e = rng.randint(3, 25, n).astype(np.uint64)
            u[r] = (np.uint64(1) << e) + rng.randint(0, 2, n).astype(np.uint64)
        elif kind == 5:
            u[r] = rng.randint(0, 1 << 25, n) * (rng.rand(n) < 0.3)
        elif kind == 6:
            u[r] = rng.randint(0, 1 << 32, n, dtype=np.uint64)
    return u.astype(np.uint32).view(np.int32)


def _k_after(codes, seed):
    """k_after rows for kernel 9: the stateful adapter's on most rows, all
    31 on one, random 0..31 on another."""
    rng = np.random.RandomState(seed)
    u = codes.view(np.uint32).astype(np.uint64)
    k = np.asarray(ref_adapt.k_after_stateful(u, xp=np)).astype(np.int32)
    k[1 % len(k)] = 31
    if len(k) > 7:
        k[7] = rng.randint(0, 32, k.shape[1])
    return k


def _escape_rows(k_after, initial_k, rng):
    """Codes at each sample's escape threshold 2^min(k + 3, 24), or one above."""
    k_used = np.concatenate([initial_k[:, None], k_after[:, :-1]], axis=1).astype(np.int64)
    thr = np.uint64(1) << np.minimum(k_used + 3, 24).astype(np.uint64)
    return (thr + rng.randint(0, 2, k_used.shape).astype(np.uint64)).astype(np.uint32).view(np.int32)


def _breaks(codes):
    last, nxt = ref_runs.zero_breaks(codes == 0, xp=np)
    return np.asarray(last, np.int32), np.asarray(nxt, np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ numpy models of csrc/mode_costs.cu


def _bit_length(x):
    """bit_width of non-negative integers < 2^53 (exact in float64)."""
    return np.where(x == 0, 0, np.frexp(x.astype(np.float64))[1]).astype(np.int64)


def _add_sample(u, k, last, nxt, i, start, end):
    """add_sample on arrays: (rice, bin, zr) uint64 and the run-start flag."""
    u = u.astype(np.uint64)
    k = k.astype(np.int64)
    q = np.where(k >= 31, np.uint64(0), u >> np.minimum(k, 31).astype(np.uint64))
    rice = q + np.uint64(1) + k.astype(np.uint64)
    absv = (u >> np.uint64(1)) + (u & np.uint64(1))
    bin_ = np.where(absv == 0, np.uint64(2), np.where(absv <= 2, np.uint64(3), np.uint64(2) + rice))
    esc = np.uint64(1) << np.minimum(k + 3, 24).astype(np.uint64)
    zr = np.uint64(2) + np.where(u > esc, np.uint64(32), rice)
    first = np.maximum(last.astype(np.int64) + 1, start)
    length = np.minimum(nxt.astype(np.int64), end) - first
    in_run = (u == 0) & (length >= 4)
    head = in_run & (i == first)
    run_cost = (2 + ((length - 4) >> 2) + 3).astype(np.uint64)
    zr = np.where(in_run, np.where(head, run_cost, np.uint64(0)), zr)
    return rice, bin_, zr, head


def _k_stateless(S, c):
    """k_stateless: the stateless k after c >= 1 samples of sum S (u64)."""
    c = c.astype(np.uint64)
    N = S + (c >> np.uint64(1))
    M = np.maximum(N, c) - c
    k0 = np.maximum(_bit_length(M) - _bit_length(c), 0)
    k = np.minimum(k0 + ((M >> k0.astype(np.uint64)) >= c), 31)
    return np.where(N < np.uint64(2) * c, 0, k)


def model_mode_cost_sums(codes, k_after, initial_k, last, nxt):
    """Kernel 9 as written: a row per group of 256 threads (n >= 2048) or
    32; 16-byte loads when n % 4 == 0, a lane's first sample coded with the
    previous vector's last k_after (shuffle, or the halo at a warp's lane
    0), the vector at 0 with initial_k; per-thread partial sums, then the
    group's total."""
    R, n = codes.shape
    u = codes.view(np.uint32)
    group = 256 if n >= _constant("kShortRow") else 32
    i = np.broadcast_to(np.arange(n), (R, n))
    if n % 4 == 0:
        k4 = k_after.reshape(R, n // 4, 4)
        prev = np.concatenate([initial_k[:, None], k4[:, :-1, 3]], axis=1)  # the hand-over
        k_used = np.concatenate([prev[..., None], k4[..., :3]], axis=-1).reshape(R, n)
        thread = (np.arange(n) // 4) % group
    else:
        k_used = np.concatenate([initial_k[:, None], k_after[:, :-1]], axis=1)
        thread = np.arange(n) % group
    rice, bin_, zr, head = _add_sample(u, k_used, last, nxt, i, 0, n)
    out = np.zeros((R, 4), np.uint64)
    for t in range(group):  # each thread's partial sums, then the reduction
        mine = thread == t
        out[:, 0] += rice[:, mine].sum(axis=1, dtype=np.uint64)
        out[:, 1] += bin_[:, mine].sum(axis=1, dtype=np.uint64)
        out[:, 2] += zr[:, mine].sum(axis=1, dtype=np.uint64)
        out[:, 3] |= head[:, mine].any(axis=1).astype(np.uint64)
    return out.astype(np.int64)


def model_partition_cost_sums(codes, last, nxt, init_k, max_p):
    """Kernel 10 as written: the row's u64 prefix sums P, warp ranges of
    n / warps samples walked 32 a step for every order, each lane's sums
    of the warp's current part flushed (warp sum, added into the part's
    accumulator) where a step crosses into the next part and at the end of
    the range."""
    R, n = codes.shape
    u = codes.view(np.uint32).astype(np.uint64)
    P = np.zeros((R, n + 1), np.uint64)
    P[:, 1:] = np.cumsum(u, axis=1, dtype=np.uint64)
    warps = min(max(n // 512, 1), 32)
    parts = (2 << max_p) - 2
    acc = np.zeros((R, parts, 3), np.uint64)
    run = np.zeros((R, parts), bool)
    lanes = np.arange(32)
    rows = np.arange(R)[:, None]

    def flush(s, srun, e):
        acc[:, e] += s.sum(axis=1, dtype=np.uint64)
        run[:, e] |= srun.any(axis=1)

    for p in range(1, max_p + 1):
        nparts, base = 1 << p, n >> p
        off = nparts - 2
        for w in range(warps):
            r0, r1 = w * n // warps, (w + 1) * n // warps
            cur = min(r0 // base, nparts - 1)
            cur_end = n if cur == nparts - 1 else (cur + 1) * base
            s = np.zeros((R, 32, 3), np.uint64)
            srun = np.zeros((R, 32), bool)
            for s0 in range(r0, r1, 32):
                i = s0 + lanes
                live = i < r1
                step_next = live & (i >= cur_end)
                j = np.where(step_next, cur + 1, cur)
                start = j * base
                end = np.where(j == nparts - 1, n, start + base)
                ii = np.minimum(i, n - 1)
                pi = P[:, ii]
                c = np.maximum(ii - start, 1)
                k = np.where(ii == start, init_k[rows, off + j], _k_stateless(pi - P[:, start], c))
                rice, bin_, zr, head = _add_sample(P[:, ii + 1] - pi, k, last[:, ii], nxt[:, ii], ii, start, end)
                cost = np.stack([rice, bin_, zr], axis=-1) * live[None, :, None]
                head = head & live
                if step_next.any():
                    keep = ~step_next
                    flush(s + cost * keep[None, :, None], srun | (head & keep), off + cur)
                    s = cost * step_next[None, :, None]
                    srun = head & step_next
                    cur += 1
                    cur_end = n if cur == nparts - 1 else (cur + 1) * base
                else:
                    s = s + cost
                    srun = srun | head
            flush(s, srun, off + cur)
    return np.concatenate([acc, run[..., None].astype(np.uint64)], axis=-1).astype(np.int64)


def _chunk_r(n):
    """Samples a lane owns on kernel 10's power-of-two path, max(8, n / 1024)
    (a row is at most one block of 1024 lanes), 0 for the general path."""
    return 0 if n & (n - 1) else max(8, n // 1024)


def _run_cost(length):
    return 2 + ((length - 4) >> 2) + 3


def model_partition_chunks(codes, last, nxt, init_k, max_p):
    """Kernel 10 as written: partition_cost_chunks for power-of-two n,
    partition_cost_rows (``model_partition_cost_sums``) for every other n.
    On the power-of-two path each lane owns a chunk of R samples: its sum,
    its zero runs from its bit mask (the edge runs' ends read from last_nz
    at its first sample and next_nz at its last), the order-independent
    class of each sample, the lane constants, the chunks' exclusive u64
    prefixes; per order the lane walks its samples with D = S - ceil(c/2),
    32-bit (values wrapping mod 2^32) where no part of its warp sums to
    2^31 and 64-bit elsewhere, clips its edge runs to its part, and the
    part's sums are a segmented reduction over its lanes (per warp, then
    u64 across the warps of a part)."""
    B, n = codes.shape
    R = _chunk_r(n)
    if R == 0:
        return model_partition_cost_sums(codes, last, nxt, init_k, max_p)
    L = n // R
    u = codes.view(np.uint32).astype(np.uint64).reshape(B, L, R)
    z = u == 0
    rr = np.arange(R)
    a = np.arange(L) * R  # chunk starts
    # edge runs: the zero samples at the chunk's start and end (all zeros: R and R)
    lead = np.cumprod(z, axis=-1).sum(-1)
    trail = np.cumprod(z[..., ::-1], axis=-1).sum(-1)
    edge = (rr < lead[..., None]) | (rr >= R - trail[..., None])
    La = np.where(lead > 0, last[:, a] + 1, 0).astype(np.int64)
    Xb = np.where(trail > 0, nxt[:, a + R - 1], 0).astype(np.int64)
    # inner runs: the same at every order; runs of >= 4 cost at their head
    mid = z & ~edge
    pad = np.zeros((B, L, 3), bool)
    m4 = mid & np.concatenate([mid[..., 1:], pad[..., :1]], -1) & np.concatenate([mid[..., 2:], pad[..., :2]], -1) \
        & np.concatenate([mid[..., 3:], pad], -1)
    longm = m4.copy()
    for sh in (1, 2, 3):
        longm[..., sh:] |= m4[..., :-sh]
    to_end = np.zeros((B, L, R + 1), np.int64)  # long samples from r on
    for r in range(R - 1, -1, -1):
        to_end[..., r] = np.where(longm[..., r], to_end[..., r + 1] + 1, 0)
    heads = longm & ~np.concatenate([np.zeros((B, L, 1), bool), longm[..., :-1]], -1)
    cost = np.where(heads, _run_cost(to_end[..., :R]), 0).sum(-1)
    forced = (edge & z) | longm
    bu = _bit_length(np.where(z, 0, u - 1))
    cls = np.where(z, -3, np.where(u > (1 << 24), 32, bu - 3))
    w = np.where(forced, 33, cls)
    bin_c = 3 * R - z.sum(-1)
    zr_c = 3 * R - 34 * forced.sum(-1) + cost
    run_mid = longm.any(-1)
    sums = u.sum(-1, dtype=np.uint64)
    Pc = np.zeros((B, L + 1), np.uint64)
    Pc[:, 1:] = np.cumsum(sums, axis=1, dtype=np.uint64)
    out = np.zeros((B, (2 << max_p) - 2, 4), np.uint64)
    rows = np.arange(B)[:, None]
    for p in range(1, max_p + 1):
        G, length, off = L >> p, n >> p, (1 << p) - 2
        j = np.arange(L) // G
        s = j * length
        e = s + length
        c0 = a - s
        Ps, Pe = Pc[:, j * G], Pc[:, (j + 1) * G]
        S0 = Pc[:, :L] - Ps
        warps = np.arange(L) // 32
        big = (Pe - Ps) >= np.uint64(1 << 31)
        wide = np.zeros((B, L), bool)
        for wi in range(warps.max() + 1):
            wide[:, warps == wi] = big[:, warps == wi].any(axis=1, keepdims=True)
        k_first = init_k[rows, off + j]
        D = S0.astype(np.int64) - (c0 >> 1)
        rice = np.full((B, L), R, np.uint64)
        bin_ = bin_c.astype(np.uint64)
        zr = zr_c.astype(np.int64).astype(np.uint64)  # mod 2^64
        ks = []
        for r in range(R):
            c = (c0 + r).astype(np.uint64)
            M = np.maximum(D, 0).astype(np.uint64)
            assert (M[~wide] < (1 << 31)).all() and (u[..., r][~wide] < (1 << 31)).all()
            bwc = np.maximum(_bit_length(c0), _bit_length(np.int64(r)))  # bw(c0 + r), c0 0 or a multiple of R
            k0 = np.maximum(_bit_length(M) - bwc, 0)
            low = (M >> k0.astype(np.uint64)) & np.uint64(0xFFFFFFFF)  # the shifted M's low word
            k = np.minimum(k0 + (low >= c), 31)
            kc = k
            if r == 0:
                k = np.where(c0 == 0, k_first, k)
                kc = np.minimum(k, 31)
            q = np.where(kc >= 31, np.uint64(0), u[..., r] >> np.minimum(kc, 31).astype(np.uint64))
            t = q + k.astype(np.uint64)
            wr = w[..., r]
            rice += t
            bin_ += np.where((wr >= 0) & (wr <= 32), t, np.uint64(0))
            zr += np.where(wr > kc, np.uint64(31), t)
            D += u[..., r].astype(np.int64) - (1 - (r & 1))
            ks.append(k)
        # the edge runs, clipped to the part
        allz = lead == R
        first = np.maximum(La, s)
        run = run_mid.copy()
        hit = allz & (first == a)
        zr += np.where(hit, _run_cost(np.minimum(Xb, e) - first), 0).astype(np.uint64)
        run |= hit
        llen = a + lead - first
        some = ~allz & (lead > 0)
        hit = some & (llen >= 4) & (first == a)
        zr += np.where(hit, _run_cost(llen), 0).astype(np.uint64)
        run |= hit
        ksum = sum(np.where(lead > i, ks[i], 0) for i in range(3))
        zr += np.where(some & (llen < 4), 3 * lead + ksum, 0).astype(np.uint64)
        tlen = np.minimum(Xb, e) - (a + R - trail)
        some = ~allz & (trail > 0)
        hit = some & (tlen >= 4)
        zr += np.where(hit, _run_cost(tlen), 0).astype(np.uint64)
        run |= hit
        ksum = sum(np.where(trail > i, ks[R - 1 - i], 0) for i in range(3))
        zr += np.where(some & (tlen < 4), 3 * trail + ksum, 0).astype(np.uint64)
        # 32-bit lanes wrap mod 2^32 (their part sums are below it); per warp, then u64 across warps
        lane_sums = [np.where(wide, f, f & np.uint64(0xFFFFFFFF)) for f in (rice, bin_, zr)]
        span = min(G, 32)
        for f, v in enumerate(lane_sums):
            per = v.reshape(B, L // span, span).sum(-1, dtype=np.uint64)
            narrow = ~wide.reshape(B, L // span, span)[..., 0]
            per = np.where(narrow, per & np.uint64(0xFFFFFFFF), per)
            out[:, off : off + (1 << p), f] = per.reshape(B, 1 << p, -1).sum(-1, dtype=np.uint64)
        out[:, off : off + (1 << p), 3] = run.reshape(B, 1 << p, G).any(-1)
    return out.astype(np.int64)


# ------------------------------------------------------------------ lac_tpu's pieces under numpy


def ref_mode_cost_sums(codes, k_after, initial_k, last, nxt):
    n = codes.shape[1]
    u = codes.view(np.uint32)
    v = codes.view(np.uint32).astype(np.int64)
    v = np.where(v & 1, -(v >> 1) - 1, v >> 1).astype(np.int32)
    k_used = ref_adapt.k_used_from_after(k_after, initial_k, xp=np)
    rl, lr, rs = ref_runs.run_geometry(u == 0, last, nxt, np.arange(n, dtype=np.int64), np.int64(n), xp=np)
    rice, bin_, zr = ref_enc._mode_cost_fields(v, u, k_used, rl, lr, rs, np)
    return np.stack([rice.sum(-1), bin_.sum(-1), zr.sum(-1), rs.any(-1)], axis=-1).astype(np.int64)


def ref_partition_cost_sums(codes, last, nxt, init_k, max_p, xp=np):
    """lac_tpu/encoder.py's sweep (:323-388) for orders 1..max_p, each
    part's sums from its own pieces, computed with ``xp`` (numpy or
    jax.numpy) and summed by part in numpy."""
    B, n = codes.shape
    u = codes.view(np.uint32)
    u64 = u.astype(np.uint64)
    v = np.where(u64 & 1, -(u64 >> 1).astype(np.int64) - 1, (u64 >> 1).astype(np.int64)).astype(np.int32)
    cs = np.concatenate([np.zeros((B, 1), np.uint64), np.cumsum(u64, axis=1, dtype=np.uint64)], axis=1)
    out = []
    for p in range(1, max_p + 1):
        nparts, base = 1 << p, n >> p
        starts = np.minimum(np.arange(nparts, dtype=np.int64) * base, n)
        ends = np.concatenate([starts[1:], [n]])
        sizes = ends - starts
        pos = np.concatenate([np.arange(sz, dtype=np.int64) for sz in sizes])
        seg_end = np.repeat(ends, sizes)
        seg_sum = cs[:, 1:] - np.repeat(cs[:, starts], sizes, axis=1)
        k_after_sl = np.asarray(ref_adapt.k_after_stateless(xp.asarray(seg_sum), xp.asarray(pos), xp=xp))
        init_seg = init_k[:, nparts - 2 : 2 * nparts - 2]
        k_used = np.where(pos == 0, np.repeat(init_seg, sizes, axis=1), ref_shift_right(k_after_sl, 1, xp=np))
        rl, lr, rs = ref_runs.run_geometry(*(xp.asarray(a) for a in (u == 0, last, nxt, pos, seg_end)), xp=xp)
        rice, bin_, zr = (np.asarray(f) for f in ref_enc._mode_cost_fields(
            *(xp.asarray(a) for a in (v, u, k_used.astype(np.int32), rl, lr, rs)), xp))
        rs = np.asarray(rs)
        per = [np.add.reduceat(f.astype(np.uint64), starts, axis=1) for f in (rice, bin_, zr)]
        per.append(np.logical_or.reduceat(rs, starts, axis=1).astype(np.uint64))
        out.append(np.stack(per, axis=-1))
    return np.concatenate(out, axis=1).astype(np.int64)


# ------------------------------------------------------------------ kernel 9


@pytest.mark.parametrize("n", [256, 4096, 4096 + 17])
@pytest.mark.parametrize("initial", [0, 12])
def test_mode_cost_sums_plain_model_and_lac_tpu_agree(n, initial):
    rng = np.random.RandomState(n + initial)
    codes = _codes(9, n, seed=n)
    initial_k = np.full(len(codes), initial, np.int32)
    initial_k[3] = 31 - initial  # k = 31 at the first sample too
    k_after = _k_after(codes, seed=n)
    codes = np.concatenate([codes, _escape_rows(k_after[:2], initial_k[:2], rng)])
    k_after = np.concatenate([k_after, k_after[:2]])
    initial_k = np.concatenate([initial_k, initial_k[:2]])
    last, nxt = _breaks(codes)
    got = K.mode_cost_sums(_t(codes), _t(k_after), _t(initial_k), _t(last), _t(nxt))
    assert got.dtype == torch.int64 and got.shape == (len(codes), 4)
    want = ref_mode_cost_sums(codes, k_after, initial_k, last, nxt)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(model_mode_cost_sums(codes, k_after, initial_k, last, nxt), want)
    assert got[:, 3].tolist().count(1) > 0 and got[:, 3].tolist().count(0) > 0


def test_mode_cost_sums_all_zero_rows_are_one_run():
    n = 300
    codes = np.zeros((2, n), np.int32)
    k_after = np.zeros((2, n), np.int32)
    initial_k = np.array([0, 12], np.int32)
    last, nxt = _breaks(codes)
    got = K.mode_cost_sums(_t(codes), _t(k_after), _t(initial_k), _t(last), _t(nxt)).numpy()
    run = 2 + ((n - 4) >> 2) + 3
    np.testing.assert_array_equal(got[:, 2], [run, run])
    np.testing.assert_array_equal(got[:, 3], [1, 1])
    np.testing.assert_array_equal(got[:, 1], [2 * n, 2 * n])
    np.testing.assert_array_equal(got[:, 0], [n, n + 12])  # u = 0: 1 + k bits, k = 12 at the first sample
    np.testing.assert_array_equal(got, model_mode_cost_sums(codes, k_after, initial_k, last, nxt))


@pytest.mark.parametrize("bad", ["dtype", "shape", "initial"])
def test_mode_cost_sums_refuses_bad_operands(bad):
    x = torch.zeros((3, 64), dtype=torch.int32)
    args = [x, x.clone(), torch.zeros(3, dtype=torch.int32), x.clone(), x.clone()]
    if bad == "dtype":
        args[1] = args[1].to(torch.int64)
    elif bad == "shape":
        args[3] = torch.zeros((3, 63), dtype=torch.int32)
    else:
        args[2] = torch.zeros((3, 1), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        K.mode_cost_sums(*args)


# ------------------------------------------------------------------ kernel 10


def _init_k(B, max_p, seed):
    """Each part's initial k: 0 and 12 on the first two rows, 0..12 elsewhere."""
    k = np.random.RandomState(seed).randint(0, 13, (B, K.partition_parts(max_p))).astype(np.int32)
    k[0], k[1 % B] = 0, 12
    return k


@pytest.mark.parametrize("n", [256, 4096, 4096 + 17, 64, 16384])
@pytest.mark.parametrize("max_p", range(9))
def test_partition_cost_sums_plain_model_and_lac_tpu_agree(n, max_p):
    codes = _codes(7, n, seed=3 * n + max_p)
    last, nxt = _breaks(codes)
    init_k = _init_k(len(codes), max(max_p, 1), seed=max_p)
    args = (_t(codes), _t(last), _t(nxt), _t(init_k))
    if max_p == 0 or (n >> max_p) < C.MIN_PARTITION_SIZE:
        with pytest.raises(ValueError):  # plan_group never asks for these
            K.partition_cost_sums(*args, max_p)
        return
    got = K.partition_cost_sums(*args, max_p)
    assert got.dtype == torch.int64 and got.shape == (len(codes), (2 << max_p) - 2, 4)
    want = ref_partition_cost_sums(codes, last, nxt, init_k, max_p)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(model_partition_cost_sums(codes, last, nxt, init_k, max_p), want)
    np.testing.assert_array_equal(model_partition_chunks(codes, last, nxt, init_k, max_p), want)
    assert got[..., 3].any() and not got[..., 3].all()


def test_partition_cost_sums_order_8():
    """The deepest order the format allows, 256 parts of 32 samples, and
    a u = 2^32 - 1 row whose stateless k reaches 31."""
    n, max_p = 8192, 8
    codes = _codes(3, n, seed=8)
    last, nxt = _breaks(codes)
    init_k = _init_k(3, max_p, seed=8)
    got = K.partition_cost_sums(_t(codes), _t(last), _t(nxt), _t(init_k), max_p).numpy()
    want = ref_partition_cost_sums(codes, last, nxt, init_k, max_p)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(model_partition_cost_sums(codes, last, nxt, init_k, max_p), want)
    np.testing.assert_array_equal(model_partition_chunks(codes, last, nxt, init_k, max_p), want)


def _k_stateless_int(S, c):
    N = S + (c >> 1)
    if N < 2 * c:
        return 0
    M = N - c
    k0 = max(M.bit_length() - c.bit_length(), 0)
    return min(k0 + ((M >> k0) >= c), 31)


def _escape_row(n, p, init_k_row, rng):
    """Codes at each sample's escape threshold 2^min(k + 3, 24) at order p
    (k the part's initial k, then the stateless k), or one above."""
    base, row = n >> p, np.zeros(n, np.uint64)
    for j in range(1 << p):
        S = 0
        for c in range(base):
            k = int(init_k_row[(1 << p) - 2 + j]) if c == 0 else _k_stateless_int(S, c)
            row[j * base + c] = (1 << min(k + 3, 24)) + rng.randint(0, 2)
            S += int(row[j * base + c])
    return row


def _edge_rows(n, R, rng):
    """Rows whose zero runs sit at the edges of the R-sample chunks: runs of
    1..6 that end at, start at or straddle a chunk edge (every part edge is
    one), all-zero chunks beside nonzero ones, a run over several parts."""
    rows = []
    row = rng.randint(1, 50, n).astype(np.uint64)
    for i, edge in enumerate(range(R, n, R)):
        length, shift = 1 + i % 6, (i // 6) % 3  # before, across, after the edge
        at = edge - length if shift == 0 else (edge - length // 2 if shift == 1 else edge)
        row[at : at + length] = 0
    rows.append(row)
    row = rng.randint(1, 1 << 20, n).astype(np.uint64)
    for c in range(0, n // R, 3):
        row[c * R : (c + 1) * R] = 0  # an all-zero chunk every third
    row[n // 4 - 3 : 3 * n // 4 + 2] = 0  # a run across the middle parts
    rows.append(row)
    return rows


@pytest.mark.parametrize("n, max_p", [(256, 3), (16384, 8), (1024, 5)])
def test_partition_cost_chunks_edge_cases(n, max_p):
    """Rows aimed at the power-of-two path: an all-zero row, u = 2^32 - 1 (k
    reaches 31, every part 64-bit), small codes then huge ones (32-bit and
    64-bit warps in one row), codes at the escape threshold of every order's
    k and one above, zero runs of 1-6 at chunk and part edges, all-zero
    chunks, a run across parts."""
    R = _chunk_r(n)
    assert R and (n >> max_p) % R == 0
    rng = np.random.RandomState(n + max_p)
    init_k = _init_k(4 + max_p + 2, max_p, seed=n)
    init_k[2] = 31  # the format's largest k at a part's first sample
    rows = [np.zeros(n, np.uint64), np.full(n, (1 << 32) - 1, np.uint64),
            np.concatenate([rng.randint(0, 1 << 10, n // 2), rng.randint(1 << 31, 1 << 32, n // 2, dtype=np.uint64)])]
    rows += [np.minimum(_escape_row(n, p, init_k[3 + p], rng), (1 << 32) - 1) for p in range(1, max_p + 1)]
    rows += _edge_rows(n, R, rng)
    codes = np.stack(rows).astype(np.uint32).view(np.int32)
    last, nxt = _breaks(codes)
    init_k = init_k[: len(codes)]
    want = ref_partition_cost_sums(codes, last, nxt, init_k, max_p)
    np.testing.assert_array_equal(model_partition_chunks(codes, last, nxt, init_k, max_p), want)
    np.testing.assert_array_equal(
        K.partition_cost_sums(_t(codes), _t(last), _t(nxt), _t(init_k), max_p).numpy(), want)
    assert want[0, :, 3].all() and not want[1, :, 3].any()


def test_partition_cost_chunk_path_is_the_power_of_two_rows():
    """The main path's rows take the chunk path and other lengths the general
    one; on the chunk path every part of every order the kernel takes is a
    whole number of chunks, and a row fits one block."""
    assert _chunk_r(16384) == 16 and _chunk_r(256) == 8
    for n in (1000, 1001, 2044, 4113, 12288):
        assert _chunk_r(n) == 0
    for n in (1 << e for e in range(6, 15)):
        R = _chunk_r(n)
        assert n // R <= 1024
        for max_p in range(1, C.MAX_PARTITION_ORDER + 1):
            if (n >> max_p) >= C.MIN_PARTITION_SIZE:
                assert (n >> max_p) % R == 0


def test_partition_bound_counts_each_part_at_its_width():
    """chip_smoke.py's kernel-10 bound counts each part of orders 1..max_p
    at the 32-bit count where the part sums below 2^31 and at the 64-bit
    count elsewhere; the last part runs to n."""
    import chip_smoke

    narrow, wide = chip_smoke.PARTITION_OPS
    n, max_p = 1001, 3
    codes = np.ones((2, n), np.uint32)
    codes[1, -1] = (1 << 32) - 1  # only each order's last part sums past 2^31
    x = (_t(codes.view(np.int32)), None, None, torch.zeros((2, K.partition_parts(max_p)), dtype=torch.int32))
    last = [n - ((1 << p) - 1) * (n >> p) for p in range(1, max_p + 1)]  # 501, 251, 126
    assert chip_smoke.partition_ops(x) == narrow * n * max_p + sum(wide * m + narrow * (n - m) for m in last)


def _tally_rows(level, n, seed):
    """(rows, n) u32 codes at a level: ``16-bit``, codes of 16-bit audio's
    residuals (below 2^17, zero runs among them: no part reaches 2^31);
    ``threshold``, constant rows whose order-1 halves sum to 2^31 - n / 2,
    exactly 2^31, and 2^31 in one half and 2^31 - 1 in the other;
    ``24-bit``, codes of loud 24-bit audio's residuals, 2^19..2^20 (the
    halves and quarters sum past 2^31, the eighths below it), one row with
    silences."""
    rng = np.random.RandomState(seed)
    if level == "16-bit":
        rows = [rng.randint(0, 1 << 17, n), rng.randint(0, 1 << 17, n) * (rng.rand(n) < 0.5)]
    elif level == "threshold":
        at = np.full(n, (1 << 31) // (n // 2), np.uint64)
        last_less = at.copy()
        last_less[-1] -= 1
        rows = [at - 1, at, last_less]
    else:
        loud = rng.randint(1 << 19, 1 << 20, n)
        quiet = loud.copy()
        quiet[n // 3 : n // 3 + 700] = 0
        rows = [loud, quiet]
    return np.stack(rows).astype(np.uint32).view(np.int32)


def _parts_past(codes, max_p):
    """A numpy count of the parts of orders 1..max_p that sum to 2^31 or more."""
    B, n = codes.shape
    cs = np.concatenate([np.zeros((B, 1), np.uint64), np.cumsum(codes.view(np.uint32), 1, dtype=np.uint64)], 1)
    count = 0
    for p in range(1, max_p + 1):
        edges = np.append(np.arange(1 << p) * (n >> p), n)
        count += int((cs[:, edges[1:]] - cs[:, edges[:-1]] >= 1 << 31).sum())
    return count


@pytest.mark.parametrize("level", ["16-bit", "threshold", "24-bit"])
@pytest.mark.parametrize("max_p", [1, 2, 3, 8])
def test_partition_cost_sums_tallies_the_parts_summed_the_64_bit_way(level, max_p):
    """At the planner's width, codes of 24-bit residuals whose order-1 and
    order-2 parts reach 2^31 (the kernel's 64-bit parts): the sums equal
    lac_tpu's under numpy and jax.numpy, and the tally counts the parts
    that reach 2^31, adding to what it holds, and every part summed."""
    import jax.numpy as jnp

    n = C.MAX_BLOCK_SIZE
    codes = _tally_rows(level, n, seed=max_p)
    last, nxt = _breaks(codes)
    init_k = _init_k(len(codes), max_p, seed=max_p)
    tally = torch.tensor([5, 7], dtype=torch.int64)
    got = K.partition_cost_sums(_t(codes), _t(last), _t(nxt), _t(init_k), max_p, tally=tally).numpy()
    for xp in (np, jnp):
        np.testing.assert_array_equal(got, ref_partition_cost_sums(codes, last, nxt, init_k, max_p, xp=xp))
    wide = _parts_past(codes, max_p)
    assert tally.tolist() == [5 + wide, 7 + len(codes) * K.partition_parts(max_p)]
    # threshold: the second row's halves and the third row's first; 24-bit: both rows' halves and quarters
    assert wide == {"16-bit": 0, "threshold": 3, "24-bit": 4 + (8 if max_p >= 2 else 0)}[level]
    np.testing.assert_array_equal(got, K.partition_cost_sums(_t(codes), _t(last), _t(nxt), _t(init_k), max_p))


def test_partition_cost_sums_refuses_a_bad_tally():
    x = torch.zeros((2, 256), dtype=torch.int32)
    k = torch.zeros((2, K.partition_parts(3)), dtype=torch.int32)
    for tally in (torch.zeros(2, dtype=torch.int32), torch.zeros(3, dtype=torch.int64)):
        with pytest.raises(ValueError):
            K.partition_cost_sums(x, x, x, k, 3, tally=tally)


def test_partition_cost_sums_refuses_a_wrong_part_table():
    x = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        K.partition_cost_sums(x, x, x, torch.zeros((2, 13), dtype=torch.int32), 3)


def test_model_constants_match_the_source():
    """The models read the source's shape rules; the format's limits are the kernel's."""
    assert _constant("kMaxOrder") == C.MAX_PARTITION_ORDER
    assert _constant("kMinPart") == C.MIN_PARTITION_SIZE
    assert _constant("kMaxN") == C.MAX_BLOCK_SIZE
    assert (_constant("kChunkMinR"), _constant("kChunkMaxLanes")) == (8, 1024)  # _chunk_r's rule
    assert _constant("kZeroRunMin") == C.ZERO_RUN_MIN_LENGTH
    assert _constant("kZeroRunK") == C.ZERO_RUN_LENGTH_K
    assert (_constant("kEscapeKOffset"), _constant("kEscapeKCap")) == (C.ESCAPE_K_OFFSET, C.ESCAPE_K_CAP)
