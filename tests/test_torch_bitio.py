"""The port's numpy packer, the planner's cost fields and the timing hooks.

``lac_tpu_torch.bitio.pack.pack_stream`` against ``lac_tpu.bitio`` on
random fields and against ``lac_tpu``'s serial ``BitWriter``, whose Rice
codes the port's ``BitReader`` reads back; the cost
fields of the port's planner (``cuda_kernels.mode_cost_fields``, the
plain version of its mode-cost kernels, and ``encoder._head_and_row_costs``) against ``lac_tpu.ops.costs``, the
readable cost spec, and against the scalar spec of
tests/test_costs_spec.py; ``lac_tpu_torch.utils.debug``'s
``[lac-timing]`` line and ``LAC_TPU_PROFILE`` trace in fresh processes,
and their cost when unset. All comparisons are exact.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu.bitio import pack as ref_pack  # noqa: E402
from lac_tpu.bitio.writer import BitWriter as RefBitWriter  # noqa: E402
from lac_tpu.ops import costs as ref_costs  # noqa: E402
from lac_tpu_torch import encoder  # noqa: E402
from lac_tpu_torch.bitio import BitReader, pack  # noqa: E402
from lac_tpu_torch.format import constants as C  # noqa: E402
from lac_tpu_torch.format.zigzag import zigzag_encode  # noqa: E402
from lac_tpu_torch.ops import adapt, cuda_kernels, runs  # noqa: E402
from lac_tpu_torch.utils import debug  # noqa: E402

from .oracle import zigzag  # noqa: E402
from .signals import lcg_noise  # noqa: E402
from .test_costs_spec import scalar_mode_costs  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ bitio


def _fields(seed, count):
    """Random elements: unary runs (some long), fields of 0..32 bits."""
    rng = np.random.RandomState(seed)
    unary = np.where(rng.rand(count) < 0.1, rng.randint(0, 200, count), rng.randint(0, 4, count))
    field_len = rng.randint(0, 33, count)
    field_val = rng.randint(0, 1 << 32, count, dtype=np.uint64)
    field_val &= (np.uint64(1) << field_len.astype(np.uint64)) - np.uint64(1)
    return unary, field_val, field_len


@pytest.mark.parametrize("seed,count", [(0, 1), (1, 7), (2, 500), (3, 4096), (4, 20000), (5, 3)])
def test_pack_stream_matches_lac_tpu_and_the_writer(seed, count):
    unary, field_val, field_len = _fields(seed, count)
    got = pack.pack_stream(unary, field_val, field_len)
    assert got == ref_pack.pack_stream(unary, field_val, field_len)
    w = RefBitWriter()  # the serial writer: one element at a time
    for u, v, ln in zip(unary, field_val, field_len):
        w.write_unary_ones(int(u))
        w.write_bits(int(v), int(ln))
    w.flush_to_byte()
    assert got == w.getvalue()


def test_pack_stream_empty():
    assert pack.pack_stream([], [], []) == b""
    assert pack.pack_stream([0, 0], [0, 0], [0, 0]) == b""


@pytest.mark.parametrize("k", [0, 1, 7, 15, 28, 31])
def test_bit_reader_reads_lac_tpus_rice_codes(k):
    """Signed Rice codes, a 40-bit field and whole bytes written by
    ``lac_tpu``'s serial ``BitWriter`` read back by the port's ``BitReader``
    (cases of tests/test_rice_tokens.py)."""
    vals = [0, 1, -1, 5, -5, 1000, -1000, 123456, -654321, C.INT32_MAX, C.INT32_MIN]
    if k < 28:
        vals = vals[:-2]
    w = RefBitWriter()
    for v in vals:
        u = zigzag(v)
        w.write_unary_ones(u >> k)
        w.write_bit(0)
        if k:
            w.write_bits(u & ((1 << k) - 1), k)
    w.write_bits(0xDEADBEEFCAFE, 40)  # > 32 bits: the value's low 32 bits, zero-extended
    w.write_bytes(b"\x01\x02")
    w.flush_to_byte()
    r = BitReader(w.getvalue())
    for v in vals:
        q = r.read_unary_ones(1 << 31)  # the ones and the stop bit
        u = (q << k) | (r.read_bits(k) if k else 0)
        assert (u >> 1) ^ -(u & 1) == v
    assert r.read_bits(8) == 0 and r.read_bits(32) == 0xBEEFCAFE and r.read_bits(16) == 0x0102


# ------------------------------------------------------------------ the planner's cost fields


def _cases():
    return [
        np.asarray(lcg_noise(700, 40, 1), np.int32),
        np.asarray(lcg_noise(700, 5000, 2), np.int32),
        np.concatenate([np.zeros(100, np.int32), np.asarray(lcg_noise(200, 3, 3), np.int32),
                        np.zeros(64, np.int32)]),
    ]


def _planner_fields(v, k_used):
    """Zero-run geometry and the planner's per-sample cost fields of
    whole-block residual rows ``v`` (B, n) coded with ``k_used``."""
    n = v.shape[-1]
    vt = torch.from_numpy(v)
    rl, lr_, rs = runs.run_geometry(vt == 0, *runs.zero_breaks(vt == 0), torch.arange(n), n)
    return (rl, lr_, rs), cuda_kernels.mode_cost_fields(vt, zigzag_encode(vt), k_used, rl, lr_, rs)


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("stateless", [False, True])
def test_mode_costs_match_the_scalar_spec(case, stateless):
    """tests/test_costs_spec.py's scalar transcription of
    block/encoder.cpp:201-263, with the whole block's stateful adapter and
    with the partition sweep's stateless one (k = 5 at the first sample),
    against the sums of the planner's per-sample fields."""
    v = _cases()[case]
    n = len(v)
    ut = zigzag_encode(torch.from_numpy(v[None, :]))
    if stateless:
        k_after = adapt.k_after_stateless(torch.cumsum(ut, -1), torch.arange(n))
        k_used = torch.cat([torch.full((1, 1), 5, dtype=torch.int32), k_after[:, :-1]], dim=1)
    else:
        k_used = adapt.k_used_from_after(adapt.k_after_stateful(ut.to(torch.int32)), torch.tensor([5]))
    (_, _, rs), (rice, bin_, zr) = _planner_fields(v[None, :], k_used)
    want = scalar_mode_costs(v, 5, stateless)
    assert (int(rice.sum()), int(zr.sum()), int(bin_.sum()), bool(rs.any())) == want


def test_segment_estimators_match_reference_rules():
    """Initial k over the first 256 samples (k <= 12) and static k over the
    row (k <= 15) from the k-cost kernel's sums
    (``encoder._head_and_row_costs``), against the brute-force rules of
    block/encoder.cpp."""
    v = np.asarray(lcg_noise(1024, 900, 9), np.int32).reshape(2, 512)
    head, row = encoder._head_and_row_costs(zigzag_encode(torch.from_numpy(v)).to(torch.int32))
    for b in range(2):
        seg = [zigzag(int(x)) for x in v[b]]
        assert head[b].tolist() == [sum((uu >> k) + 1 + k for uu in seg[:256]) for k in range(13)]
        assert row[b].tolist() == [sum((uu >> k) + 1 + k for uu in seg) for k in range(16)]


@pytest.mark.parametrize("n", [256, 1000, 4096])
def test_costs_match_the_planners_cost_fields(n):
    """The spec and the planner's own layouts agree: lac_tpu.ops.costs'
    whole-block mode costs against ``cuda_kernels.mode_cost_fields``' sums,
    its initial and static k against the k-cost kernel's sums
    (``encoder._head_and_row_costs``)."""
    rng = np.random.RandomState(n)
    v = np.stack([rng.randint(-3000, 3000, n), np.where(rng.rand(n) < 0.05, rng.randint(-9, 9, n), 0),
                  rng.randint(-(1 << 23), 1 << 23, n)]).astype(np.int32)
    B = v.shape[0]
    u = zigzag_encode(torch.from_numpy(v))
    head, row = encoder._head_and_row_costs(u.to(torch.int32))
    initial = torch.argmin(head, dim=-1).to(torch.int32)
    k_used = adapt.k_used_from_after(adapt.k_after_stateful(u.to(torch.int32)), initial)
    (rl, lr_, rs), (rice, bin_, zr) = _planner_fields(v, k_used)
    un = u.numpy().astype(np.uint64)
    seg_id = np.zeros(n, np.int64)
    ones = np.ones((B, n), bool)
    spec = ref_costs.mode_costs(v, un, k_used.numpy(), ones, rl.numpy(), lr_.numpy(), rs.numpy(), seg_id, 1)
    assert np.array_equal(np.asarray(spec["rice"])[:, 0], rice.sum(-1).numpy())
    assert np.array_equal(np.asarray(spec["bin"])[:, 0], bin_.sum(-1).numpy())
    assert np.array_equal(np.asarray(spec["zr"])[:, 0], zr.sum(-1).numpy())
    assert np.array_equal(np.asarray(spec["has_run"])[:, 0], rs.any(-1).numpy())
    pos = np.broadcast_to(np.arange(n), (B, n))
    assert np.array_equal(ref_costs.initial_k(un, pos, ones, seg_id, 1)[:, 0], initial.numpy())
    sk, sb = ref_costs.static_k_and_bits(un, ones, seg_id, 1)
    assert np.array_equal(sk[:, 0], torch.argmin(row, dim=-1).numpy())
    assert np.array_equal(sb[:, 0], row.min(dim=-1).values.numpy())


def test_rice_cost_per_sample_caps_q_at_k31():
    """The planner's per-sample Rice cost (``cuda_kernels.rice_cost``) drops
    the quotient at k >= MAX_RICE_K, as lac_tpu.ops.costs does."""
    u = torch.tensor([0, 5, (1 << 32) - 1], dtype=torch.int64)
    for k in (0, 3, 30, 31):
        kk = torch.full((3,), k, dtype=torch.int32)
        want = [(0 if k >= C.MAX_RICE_K else int(x) >> k) + 1 + k for x in u]
        assert cuda_kernels.rice_cost(u, kk).tolist() == want
        assert ref_costs.rice_cost_per_sample(u.numpy().astype(np.uint64), kk.numpy()).tolist() == want


# ------------------------------------------------------------------ timing hooks

_ENCODE = r"""
import sys, numpy as np, torch
torch.set_num_threads(1)
from lac_tpu_torch.encoder import FrameEncoder
from lac_tpu_torch.utils import debug
rng = np.random.RandomState(1)
n = 16384 * 2 + 300
left = rng.randint(-3000, 3000, n).astype(np.int32)
right = np.roll(left, 5)
FrameEncoder(12, 2, 44100, 16, device="cpu").encode(left, right)
print("PHASES", sorted({s.name for s in debug.spans()}))
"""


def _child(env_extra):
    env = {k: v for k, v in os.environ.items() if k not in ("LAC_TPU_TIMING", "LAC_TPU_PROFILE", "LAC_TPU_NO_NATIVE")}
    env.update(env_extra)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    r = subprocess.run([sys.executable, "-c", _ENCODE], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    return r


def _phases(r):
    lines = [ln for ln in r.stderr.splitlines() if ln.startswith("[lac-timing]")]
    assert len(lines) == 1, r.stderr
    m = re.fullmatch(r"\[lac-timing\] encode 33068 frames x2ch: (.*) \(sum (\d+\.\d\d)s\)", lines[0])
    assert m, lines[0]
    phases = dict(p.split("=") for p in m.group(1).split())
    assert all(re.fullmatch(r"\d+\.\d\ds", v) for v in phases.values())
    return set(phases)


def test_timing_line_names_the_encode_phases():
    """Two full blocks (under the plane pipeline's minimum) and a tail:
    with the native runtime every lane takes the host route."""
    assert _phases(_child({"LAC_TPU_TIMING": "1"})) == {
        "validate", "stereo_estimate", "lane_build", "host_plan", "group_stage", "plan_numpy", "native_emit",
        "assembly"}


def test_timing_line_names_the_group_route_phases():
    """The same input under LAC_TPU_NO_NATIVE=1: the group route plans the
    full blocks' lanes on the (CPU) device and the token packer emits."""
    assert _phases(_child({"LAC_TPU_TIMING": "1", "LAC_TPU_NO_NATIVE": "1"})) == {
        "validate", "stereo_estimate", "lane_build", "host_plan", "group_stage", "h2d_upload", "autocorr_fetch",
        "host_ld", "plan_dispatch", "meta_fetch", "ship_fetch", "host_emit", "plan_numpy", "assembly"}


def test_timing_off_prints_nothing_and_keeps_no_phase_state():
    r = _child({})
    assert "[lac-timing]" not in r.stderr
    assert "PHASES []" in r.stdout


def test_phase_and_device_trace_are_no_ops_when_unset(monkeypatch):
    monkeypatch.setattr(debug, "_TIMING", False)
    monkeypatch.setattr(debug, "_PROFILE_DIR", "")
    debug.timing_reset()
    with debug.phase("x", card="cuda"):  # records nothing, synchronizes nothing
        pass
    assert debug._phase_sums() == {}
    with debug.device_trace():
        pass
    debug.timing_report("nothing")


def test_phase_sums_and_report_format(monkeypatch, capsys):
    monkeypatch.setattr(debug, "_TIMING", True)
    debug.timing_reset()
    for _ in range(2):
        with debug.phase("a", card="cpu"):
            pass
    with debug.phase("b"):
        pass
    assert sorted(debug._phase_sums()) == ["a", "b"]
    debug.timing_report("label")
    err = capsys.readouterr().err
    assert re.fullmatch(r"\[lac-timing\] label: (a|b)=\d+\.\d\ds (a|b)=\d+\.\d\ds \(sum \d+\.\d\ds\)\n", err), err
    debug.timing_reset()
    assert debug._phase_sums() == {}


def test_profile_dir_gets_a_chrome_trace(tmp_path):
    _child({"LAC_TPU_PROFILE": str(tmp_path)})
    traces = list(tmp_path.glob("lac-*.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
