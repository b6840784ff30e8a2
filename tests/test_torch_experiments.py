"""The port's experiments (``lac_tpu_torch.experiments``: the device
bit-packer and bit-reader, and their bench scripts) on the CPU.

The same element streams and payloads, made from seeds, go through the
port and through ``lac_tpu.ops.device_pack`` / ``lac_tpu.ops.device_reader``
under ``xp=numpy`` and ``xp=jax.numpy`` (the scan variant under CPU JAX),
and through ``bitio.pack.pack_stream``: the cases of
tests/test_device_pack.py and tests/test_device_reader.py, and kernel 8's
hard inputs through its plain version. Tolerance: none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu.bitio.pack import pack_stream  # noqa: E402
from lac_tpu.ops import adapt as ref_adapt  # noqa: E402
from lac_tpu.ops import device_pack as ref_pack  # noqa: E402
from lac_tpu.ops import device_reader as ref_reader  # noqa: E402
from lac_tpu.runtime import native as ref_native  # noqa: E402
from lac_tpu_torch.bitio.pack import pack_stream as port_pack_stream  # noqa: E402
from lac_tpu_torch.experiments import bench_device_pack, bench_device_reader  # noqa: E402
from lac_tpu_torch.experiments import device_pack as dp  # noqa: E402
from lac_tpu_torch.experiments import device_reader as dr  # noqa: E402
from lac_tpu_torch.ops import cuda_kernels as K  # noqa: E402
from lac_tpu_torch.runtime import native  # noqa: E402


@pytest.fixture(autouse=True)
def reference_packer_in_numpy(monkeypatch):
    """lac_tpu's pack_stream would build lac_tpu's native runtime, which no
    port test calls: its numpy packer (the same bytes) answers instead."""
    monkeypatch.setattr(ref_native, "pack_stream_native", lambda *args: None)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ device pack


def check(unary, fv, fl):
    """The port's words == lac_tpu's numpy words, and the bytes == pack_stream's."""
    unary = np.asarray(unary, np.int64)
    fv = np.asarray(fv, np.uint32)
    fl = np.asarray(fl, np.int64)
    W = max(dp.words_capacity(int((unary + fl).sum())), 1)
    words, tb = dp.pack_elements(_t(unary), _t(fv.astype(np.int64)), _t(fl), W)
    want_w, want_tb = ref_pack.pack_elements(unary, fv, fl, W, xp=np)
    np.testing.assert_array_equal(words.numpy(), want_w.astype(np.int64))
    assert int(tb) == int(want_tb) == int((unary + fl).sum())
    ref = pack_stream(unary, fv.astype(np.uint64), fl)
    assert dp.words_to_bytes(words, tb) == ref == port_pack_stream(unary, fv.astype(np.uint64), fl)


@pytest.mark.parametrize("unary,fv,fl", [
    ([0, 3, 0], [0b101, 0b0, 0b11], [3, 1, 2]),  # simple
    ([0, 0, 0], [0, 0, 0], [0, 0, 0]),  # empty fields
    ([5], [0], [0]),  # pure unary, no field
    ([100, 0, 64, 31, 33], [0, 1, 2, 3, 0], [0, 1, 2, 5, 0]),  # runs across many words
    ([32], [0], [0]),
    ([31], [1], [1]),  # run + stop bit exactly one word
    ([200, 70, 64, 65], [1, 0, 3, 0], [1, 2, 2, 0]),  # runs past 64 bits: range updates, never shifts
])
def test_pack_elements_cases(unary, fv, fl):
    check(unary, fv, fl)


@pytest.mark.parametrize("pre", range(33))
def test_pack_elements_word_alignment_sweep(pre):
    check([0, 0], [0x5A5A5A5A & ((1 << pre) - 1) if pre else 0, 0xDEADBEEF], [pre, 32])


def _random_elements(rng, shape, long_p, long_add, max_fl):
    unary = (rng.geometric(0.3, shape) - 1).astype(np.int64)
    unary[rng.rand(*shape) < long_p] += long_add
    fl = rng.randint(0, max_fl + 1, shape).astype(np.int64)
    fv = (rng.randint(0, 1 << 30, shape).astype(np.uint64) | (rng.randint(0, 4, shape).astype(np.uint64) << 30))
    fv = (fv & ((np.uint64(1) << fl.astype(np.uint64)) - np.uint64(1))).astype(np.uint32)
    return unary, fv, fl


@pytest.mark.parametrize("trial", range(6))
def test_pack_elements_random_streams(trial):
    rng = np.random.RandomState(7 + trial)
    check(*_random_elements(rng, (rng.randint(1, 200),), 0.1, rng.randint(30, 90), 32))


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_pack_matches_per_lane_and_lac_tpu_under_jnp(seed):
    rng = np.random.RandomState(11 + seed)
    unary, fv, fl = _random_elements(rng, (5, 64), 0.05, 70, 32)
    W = dp.words_capacity(int((unary + fl).sum(axis=1).max()))
    words, tb = dp.pack_elements(_t(unary), _t(fv.astype(np.int64)), _t(fl), W)
    wj, tj = jax.jit(lambda a, b, c: ref_pack.pack_elements(a, b, c, W, xp=jnp))(unary, fv, fl)
    np.testing.assert_array_equal(words.numpy(), np.asarray(wj).astype(np.int64))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(tj))
    for b in range(5):
        assert dp.words_to_bytes(words[b], tb[b]) == pack_stream(unary[b], fv[b].astype(np.uint64), fl[b])


def test_rice_lanes_match_pack_stream_and_lac_tpu():
    rng = np.random.RandomState(3)
    res = rng.laplace(0, 40, (2, 512)).astype(np.int64).astype(np.int32)
    res[1, :7] = (-(1 << 31), (1 << 31) - 1, 0, -1, 1, 1 << 22, -(1 << 22))
    u_ref = ref_pack.zigzag(res, xp=np)
    u = dp.zigzag(_t(res))
    np.testing.assert_array_equal(u.numpy(), u_ref.astype(np.int64))
    k_used = ref_adapt.k_used_from_after(ref_adapt.k_after_stateful(u_ref, xp=np), 4, xp=np)
    elems = dp.rice_elements(u, _t(k_used))
    for got, want in zip(elems, ref_pack.rice_elements(u_ref, k_used, xp=np)):
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    unary, fv, fl = (e.numpy() for e in elems)
    W = dp.words_capacity(int((unary + fl).sum(axis=1).max()))
    words, tb = dp.pack_rice_lanes(u, _t(k_used), W)
    want_w, want_tb = ref_pack.pack_rice_lanes(u_ref, k_used, W, xp=np)
    np.testing.assert_array_equal(words.numpy(), want_w.astype(np.int64))
    np.testing.assert_array_equal(tb.numpy(), want_tb)
    offs = np.asarray([0, 512, 1024], np.uint64)
    streams = native.pack_streams(unary.reshape(-1), fv.reshape(-1), fl.reshape(-1), offs)
    for b in range(2):
        assert dp.words_to_bytes(words[b], tb[b]) == pack_stream(unary[b], fv[b].astype(np.uint64), fl[b]) \
            == streams[b]


def test_pack_of_no_elements():
    words, tb = dp.pack_elements(torch.zeros((3, 0), dtype=torch.int64), torch.zeros((3, 0), dtype=torch.int64),
                                 torch.zeros((3, 0), dtype=torch.int64), 4)
    assert tuple(words.shape) == (3, 4) and not words.any() and not tb.any()


# ------------------------------------------------------------ device reader


def _lanes(rng, specs, T):
    """[(k, values)] -> (payload (L, NBY) uint8, k, nbits, values)."""
    enc = [(k, v, *dr.encode_static_rice_np(v, k)) for k, v in specs]
    nby = max(len(p) for *_, p, _ in enc) + 8
    pay = np.zeros((len(enc), nby), np.uint8)
    for i, (_, _, p, _) in enumerate(enc):
        pay[i, : len(p)] = p
    return (pay, np.asarray([k for k, *_ in enc], np.int32), np.asarray([nb for *_, nb in enc], np.int32),
            [v for _, v, _, _ in enc])


def test_encode_static_rice_np_equals_lac_tpu():
    rng = np.random.RandomState(2)
    for k in (0, 3, 15):
        v = rng.randint(-3000, 3000, 200).astype(np.int32)
        got, want = dr.encode_static_rice_np(v, k), ref_reader.encode_static_rice_np(v, k)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_device_reader_matches_spec_and_lac_tpu(seed):
    rng = np.random.RandomState(seed)
    T = 256
    specs = [(k, rng.randint(-max(1, 2 << k), max(1, 2 << k) + 1, T).astype(np.int32)) for k in (0, 1, 3, 7, 11, 15)]
    specs.append((2, np.zeros(T, np.int32)))  # q = 0 runs
    specs.append((0, rng.randint(-2000, 2000, T).astype(np.int32)))  # long unary runs
    pay, ks, nb, vals = _lanes(rng, specs, T)
    res, starts, valid = dr.tokenize_static_rice(_t(pay), _t(ks), _t(nb), T)
    res_np, starts_np, valid_np = dr._tokenize_np(pay, ks, nb, T)
    for got, want in zip(dr._tokenize_np(pay, ks, nb, T), ref_reader._tokenize_np(pay, ks, nb, T)):
        np.testing.assert_array_equal(got, want)
    res_j, starts_j, valid_j = (np.asarray(a) for a in ref_reader.tokenize_static_rice(
        jnp.asarray(pay), jnp.asarray(ks), jnp.asarray(nb), T, xp=jnp))
    # every element, garbage past the streams included, equals the JAX formulation
    np.testing.assert_array_equal(res.numpy(), res_j)
    np.testing.assert_array_equal(starts.numpy(), starts_j)
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    np.testing.assert_array_equal(valid.numpy(), valid_np)
    np.testing.assert_array_equal(starts.numpy()[valid_np], starts_np[valid_np])
    np.testing.assert_array_equal(res.numpy()[valid_np], res_np[valid_np])
    for i, v in enumerate(vals):
        assert valid_np[i].all()
        np.testing.assert_array_equal(res_np[i], v)


def test_device_reader_matches_native_tokenizer():
    rng = np.random.RandomState(7)
    T, k = 1024, 5
    pay, ks, nb, (vals,) = _lanes(rng, [(k, rng.randint(-40, 40, T).astype(np.int32))], T)
    res, _, valid = dr.tokenize_static_rice(_t(pay), _t(ks), _t(nb), T)
    assert valid.all()
    np.testing.assert_array_equal(res[0].numpy(), vals)
    np.testing.assert_array_equal(native.tokenize_static_rice(pay, ks, nb, T)[0], vals)
    with pytest.raises(ValueError, match="lane=0"):  # one token more than the stream holds
        native.tokenize_static_rice(pay, ks, nb, T + 1)


def _jax_scan(pay, ks, nb, T):
    res, valid = ref_reader.tokenize_static_rice_scan(jnp.asarray(pay), ks, nb, T)
    return np.asarray(res), np.asarray(valid)


def test_scan_reader_matches_spec_and_the_jax_scan():
    rng = np.random.RandomState(3)
    T = 200
    specs = [(k, rng.randint(-max(1, 1 << k), max(1, 1 << k) + 1, T).astype(np.int32)) for k in (0, 2, 5, 9, 15)]
    pay, ks, nb, vals = _lanes(rng, specs, T)
    res, valid = dr.tokenize_static_rice_scan(_t(pay), _t(ks), _t(nb), T)
    assert valid.all()
    for i, v in enumerate(vals):
        np.testing.assert_array_equal(res[i].numpy(), v)
    want_res, want_valid = _jax_scan(pay, ks, nb, T)
    np.testing.assert_array_equal(res.numpy(), want_res)
    np.testing.assert_array_equal(valid.numpy(), want_valid)


@pytest.mark.parametrize("batch", range(4))
def test_kernel_8_plain_version_equals_the_jax_scan_on_hard_lanes(batch):
    """k = 0 and 15, unary runs at and past the 57-bit cap, all-ones tails
    (q = 64), nbits = 0, tokens past the streams, rows under 8 bytes: every
    output element equals the JAX scan's, garbage included."""
    label, pay, ks, nb, T = bench_device_reader.adversarial_batches()[batch]
    res, valid = K.tokenize_static_rice_scan(_t(pay), _t(ks), _t(nb), T)
    want_res, want_valid = _jax_scan(pay, ks, nb, T)
    np.testing.assert_array_equal(res.numpy(), want_res, err_msg=label)
    np.testing.assert_array_equal(valid.numpy(), want_valid, err_msg=label)


def test_hard_lanes_cover_what_they_claim():
    batches = bench_device_reader.adversarial_batches()
    _, pay, ks, nb, T = batches[0]
    assert {0, 15, 31, -1} <= set(ks.tolist()) and (nb == 0).any()
    assert [b[1].shape[1] for b in batches[1:]] == [1, 5, 7]
    res, valid = K.tokenize_static_rice_scan(_t(pay), _t(ks), _t(nb), T)
    assert not valid.all() and valid.any()  # tokens past the streams


def test_scan_wrapper_checks_its_operands():
    pay, k, nb = torch.zeros((2, 8), dtype=torch.uint8), torch.zeros(2, dtype=torch.int32), torch.zeros(2,
                                                                                                          dtype=torch.int32)
    with pytest.raises(TypeError):
        K.tokenize_static_rice_scan(pay.to(torch.int32), k, nb, 4)
    with pytest.raises(TypeError):
        K.tokenize_static_rice_scan(torch.zeros((2, 0), dtype=torch.uint8), k, nb, 4)
    with pytest.raises(ValueError):
        K.tokenize_static_rice_scan(pay, k[:1], nb, 4)
    with pytest.raises(ValueError):
        K.tokenize_static_rice_scan(pay, k, nb.to(torch.int64), 4)
    with pytest.raises(ValueError):
        dr.tokenize_static_rice(pay[:, :3], k, nb, 4)


# ------------------------------------------------------------ the bench scripts


def test_bench_device_reader_runs_on_the_cpu():
    out = bench_device_reader.run(lanes=3, tokens=48, reps=1, device="cpu")
    assert out["lanes"] == 3 and out["tokens_per_lane"] == 48 and out["scan_s"] > 0


def test_bench_device_pack_runs_on_the_cpu():
    before = K.launches["k_after_stateful_fused"]
    out = bench_device_pack.run(lanes=2, reps=1, device="cpu")
    assert out["W"] * 32 >= out["payload_bytes"] * 8 // 2
    assert K.launches["k_after_stateful_fused"] == before  # the CPU takes the plain version


@pytest.mark.parametrize("bench", [bench_device_pack, bench_device_reader])
def test_bench_scripts_raise_without_a_card(bench, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
