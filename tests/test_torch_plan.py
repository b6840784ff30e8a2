"""The port's planner (lac_tpu_torch.encoder.plan_group) against lac_tpu's.

The ``meta`` rows the port's planner returns on CPU tensors must equal
the jitted ``lac_tpu.encoder.plan_group(xp=jax.numpy)`` and the numpy
``plan_group`` bit for bit: full 16384-sample blocks, 256-sample stereo
probes (with the zero-run and partitioning switches) and an odd length
whose partitions are unequal. Both planners get the same LPC candidate
set from the host Levinson-Durbin, made from the same PCM. The
planner's profiler ranges appear only while a profiling tool turns them
on.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu import encoder as ref_enc  # noqa: E402
from lac_tpu.ops import lpc as ref_lpc  # noqa: E402
from lac_tpu_torch import encoder as port_enc  # noqa: E402
from lac_tpu_torch.encoder import plan_group, plan_inputs_to_torch  # noqa: E402


def _pcm(rows, n, seed):
    """Lanes that reach every branch of the planner: noise, a tone (LPC
    wins), silence with bursts (zero runs, bin mode), all-zero and
    constant lanes (every candidate ties), 24-bit extremes (escape
    codes), a quiet noisy tone."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    kinds = [
        rng.randint(-30000, 30000, n),
        (np.sin(t / 9.0) * 20000).astype(np.int64),
        np.where(rng.rand(n) < 0.03, rng.randint(-3, 4, n), 0),
        np.zeros(n, np.int64),
        np.full(n, 1234),
        np.where(t % 2, (1 << 23) - 1, -(1 << 23)),
        (np.sin(t / 40.0) * 300 + rng.randint(-4, 5, n)).astype(np.int64),
    ]
    return np.stack([kinds[(i + seed) % len(kinds)] for i in range(rows)]).astype(np.int32)


def _plans(pcm, zero_run, partitioning):
    """(port meta, jitted JAX meta, numpy meta) for one group."""
    B, n = pcm.shape
    coeffs, _, lvalid, _ = ref_enc.lpc_candidates_from_lags(ref_lpc.autocorrelation(pcm, 12), n)
    ct, vt = plan_inputs_to_torch(coeffs, lvalid, "cpu")
    port = plan_group(torch.from_numpy(pcm), ct, vt, n, zero_run, partitioning).numpy()
    jit = ref_enc._jitted_plan(n, zero_run, partitioning, False)(pcm, coeffs, lvalid)
    ref_np = ref_enc.plan_group(pcm, coeffs, lvalid, n, zero_run, partitioning, np, emit_fields=False)
    return port, np.asarray(jit["meta"]), np.asarray(ref_np["meta"])


def test_full_blocks():
    port, jit, ref_np = _plans(_pcm(4, 16384, 0), True, True)
    assert port.dtype == np.int8 and port.shape == (4, 3 + 2 * 256)
    np.testing.assert_array_equal(port, jit)
    np.testing.assert_array_equal(port, ref_np)


@pytest.mark.parametrize("zero_run,partitioning", [(True, True), (False, True), (True, False)])
def test_probe_lanes(zero_run, partitioning):
    port, jit, ref_np = _plans(_pcm(24, 256, 1), zero_run, partitioning)
    np.testing.assert_array_equal(port, jit)
    np.testing.assert_array_equal(port, ref_np)


def test_odd_length_unequal_partitions():
    port, jit, ref_np = _plans(_pcm(3, 1000, 2), True, True)
    assert port[:, 1].max() > 0, "want a lane that accepts an (unequal) partitioning"
    np.testing.assert_array_equal(port, jit)
    np.testing.assert_array_equal(port, ref_np)


def test_ties_take_the_first_candidate():
    """Silent lanes give every fixed/FIR candidate equal bits: the
    lexicographic key picks the lowest predictor type, first in order."""
    pcm = np.zeros((24, 256), np.int32)
    pcm[12:] = _pcm(12, 256, 3)
    port, jit, ref_np = _plans(pcm, True, True)
    assert (port[:12, 0] == 0).all()
    np.testing.assert_array_equal(port, jit)
    np.testing.assert_array_equal(port, ref_np)


@pytest.mark.parametrize("n,stack_calls,order_calls", [
    (64, 1, 1),  # one partition order, every part shorter than the 256-sample head
    (256, 1, 1),  # probe lanes: the head is the row, orders 1..3 from one read
    (4096, 1, 1),  # power of two: heads of orders 1..3 are parts of order 4
    (12288, 9, 0),  # equal parts at every order but no power of two: one head-and-row call per order
    (1000, 4, 0),  # equal parts at orders 1..3, unequal at 4: the cumsum route
    (3000, 4, 0),  # 375-sample parts at order 3, unequal from order 4 on
])
def test_k_cost_call_sites(monkeypatch, n, stack_calls, order_calls):
    """The planner's k-cost calls by block length: head and row sums of
    the candidate stack from one call, every partition order of a
    power-of-two block from one more; other lengths take one call per equal
    order and the cumsum route for unequal ones. The meta equals lac_tpu's
    on every route."""
    calls = {"k_cost_sums": 0, "k_cost_partition_sums": 0}

    def counted(name):
        fn = getattr(port_enc, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return wrapper

    for name in calls:
        monkeypatch.setattr(port_enc, name, counted(name))
    port, jit, ref_np = _plans(_pcm(7, n, 4), True, True)
    assert calls == {"k_cost_sums": stack_calls, "k_cost_partition_sums": order_calls}
    assert port[:, 1].max() > 0, "want a lane that accepts a partitioning"
    np.testing.assert_array_equal(port, jit)
    np.testing.assert_array_equal(port, ref_np)


@pytest.mark.parametrize("on", [False, True])
def test_section_ranges_only_while_turned_on(on):
    """The planner's six profiler ranges (``debug.section``) appear in a
    profile only while a profiling tool turns them on; the plan is the same."""
    from lac_tpu_torch.utils import debug

    pcm = _pcm(3, 256, 5)
    coeffs, _, lvalid, _ = ref_enc.lpc_candidates_from_lags(ref_lpc.autocorrelation(pcm, 12), 256)
    ct, vt = plan_inputs_to_torch(coeffs, lvalid, "cpu")
    want = plan_group(torch.from_numpy(pcm), ct, vt, 256, True, True)
    debug.sections_on(on)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            got = plan_group(torch.from_numpy(pcm), ct, vt, 256, True, True)
    finally:
        debug.sections_on(False)
    names = {e.name for e in prof.events() if e.name.startswith("plan_group.")}
    sections = {f"plan_group.{s}" for s in ("residuals", "scoring", "selection", "mode", "sweep", "meta")}
    assert names == (sections if on else set())
    assert torch.equal(got, want)
