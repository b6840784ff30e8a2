"""The port's own host layers against their ``lac_tpu`` counterparts.

Each case runs the port's module and the JAX package's (under numpy) on
the same inputs, made from a seed or from tests/signals.py, and holds
them bit-for-bit or byte-for-byte: the frame header, partitions and
control byte, WAV bytes, the 80-bit Levinson-Durbin and its candidate
sets, plan expansion, the native runtime's planner and emit, the host
route's frames, the decoder on every golden, and the CLI's exit codes
and messages.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu import cli as ref_cli  # noqa: E402
from lac_tpu import decoder as ref_decoder  # noqa: E402
from lac_tpu import encoder as ref_encoder  # noqa: E402
from lac_tpu.format import header as ref_header  # noqa: E402
from lac_tpu.format import partitions as ref_partitions  # noqa: E402
from lac_tpu.io import wav as ref_wav  # noqa: E402
from lac_tpu.ops import lpc as ref_lpc  # noqa: E402
from lac_tpu_torch import cli, decoder, encoder  # noqa: E402
from lac_tpu_torch.format import header, partitions  # noqa: E402
from lac_tpu_torch.io import wav  # noqa: E402
from lac_tpu_torch.ops import lpc  # noqa: E402
from lac_tpu_torch.runtime import native  # noqa: E402
from tests.signals import cases as golden_cases  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDENS = golden_cases()
N = 16384


def _pcm(rows, n, seed, bits=16):
    """Lanes that reach the planner's branches: noise, a tone, sparse
    bursts, silence, full-scale square, a quiet noisy tone."""
    rng = np.random.RandomState(seed)
    t = np.arange(n)
    lim = 1 << (bits - 1)
    kinds = [
        rng.randint(-lim, lim, n),
        (np.sin(t / 9.0) * (lim * 0.6)).astype(np.int64),
        np.where(rng.rand(n) < 0.03, rng.randint(-3, 4, n), 0),
        np.zeros(n, np.int64),
        np.where(t % 2, lim - 1, -lim),
        (np.sin(t / 40.0) * 300 + rng.randint(-4, 5, n)).astype(np.int64),
    ]
    return np.stack([kinds[(i + seed) % len(kinds)] for i in range(rows)]).astype(np.int32)


def _stereo(frames, seed, bits=16):
    """A correlated stereo pair (certain and uncertain blocks both occur)."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames)
    lim = (1 << (bits - 1)) - 1
    base = np.sin(t / 23.0) * 0.5 + np.sin(t / 3.1) * 0.2 * np.sin(t / 5000.0)
    left = np.clip(base * lim * 0.8 + rng.randint(-40, 41, frames), -lim, lim).astype(np.int32)
    right = np.clip(np.roll(base, 5) * lim * 0.7 + rng.randint(-40, 41, frames), -lim, lim).astype(np.int32)
    return left, right


# ---------------------------------------------------------------- format


@pytest.mark.parametrize("fields", [
    dict(), dict(channels=1, stereo_mode=0), dict(sample_rate=192000, bit_depth=24),
    dict(version=2, stereo_mode=1), dict(sync=0x1234), dict(reserved=3), dict(channels=1, stereo_mode=2),
])
def test_frame_header(fields):
    got, want = header.FrameHeader(**fields), ref_header.FrameHeader(**fields)
    assert got.pack() == want.pack()
    assert got.validate() == want.validate()
    parsed, ref_parsed = header.FrameHeader.parse(got.pack()), ref_header.FrameHeader.parse(want.pack())
    assert (parsed is None) == (ref_parsed is None)
    if parsed is not None:
        assert vars(parsed[0]) == vars(ref_parsed[0]) and parsed[1] == ref_parsed[1]
    assert header.FrameHeader.parse(got.pack()[:9]) is None


@pytest.mark.parametrize("size", [1, 31, 32, 63, 64, 255, 256, 1000, 4097, 8191, 16384])
def test_partition_geometry(size):
    assert partitions.max_partition_order_for_block(size) == ref_partitions.max_partition_order_for_block(size)
    for p in range(9):
        assert partitions.partition_sizes(size, p) == ref_partitions.partition_sizes(size, p)


def test_control_byte_every_value():
    for b in range(256):
        assert partitions.parse_control_byte(b) == ref_partitions.parse_control_byte(b)
    for mode in range(4):
        for p in range(9):
            assert partitions.control_byte(mode, p) == ref_partitions.control_byte(mode, p)


@pytest.mark.parametrize("channels,rate,depth", [(1, 44100, 16), (2, 48000, 16), (1, 96000, 24), (2, 192000, 24)])
def test_wav_write_and_read_bytes(tmp_path, channels, rate, depth):
    rng = np.random.RandomState(channels * depth)
    lim = 1 << (depth - 1)
    left = rng.randint(-lim, lim, 999).astype(np.int32)
    left[:2] = [-lim, lim - 1]
    right = rng.randint(-lim, lim, 999).astype(np.int32) if channels == 2 else np.empty(0, np.int32)
    a, b = str(tmp_path / "port.wav"), str(tmp_path / "ref.wav")
    assert wav.write_wav(a, left, right, channels, rate, depth)
    assert ref_wav.write_wav(b, left, right, channels, rate, depth)
    assert open(a, "rb").read() == open(b, "rb").read()
    got, want = wav.read_wav(a), ref_wav.read_wav(b)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    too_loud = left.copy()
    too_loud[0] = lim
    assert wav.write_wav(a, too_loud, right, channels, rate, depth) == ref_wav.write_wav(
        b, too_loud, right, channels, rate, depth)


@pytest.mark.parametrize("corrupt", ["riff", "size", "fmt_len", "format", "rate", "align", "no_data", "odd"])
def test_wav_reader_rejects_what_the_reference_rejects(tmp_path, corrupt):
    path = str(tmp_path / "in.wav")
    assert ref_wav.write_wav(path, np.arange(10, dtype=np.int32), np.arange(10, dtype=np.int32), 2, 44100, 16)
    data = bytearray(open(path, "rb").read())
    if corrupt == "riff":
        data[0:4] = b"RIFX"
    elif corrupt == "size":
        data[4] += 1
    elif corrupt == "fmt_len":
        data[16] = 18
    elif corrupt == "format":
        data[20] = 3
    elif corrupt == "rate":
        data[24:28] = (22050).to_bytes(4, "little")
    elif corrupt == "align":
        data[32] = 3
    elif corrupt == "no_data":
        data = data[:36]
        data[4:8] = (28).to_bytes(4, "little")
    else:  # a data chunk that is not a whole number of frames
        data += b"\x00\x00"
        data[40:44] = (42).to_bytes(4, "little")
        data[4:8] = (len(data) - 8).to_bytes(4, "little")
    open(path, "wb").write(bytes(data))
    assert wav.read_wav(path) is None and ref_wav.read_wav(path) is None


# ---------------------------------------------------------------- LPC


@pytest.mark.parametrize("n", [5, 13, 256, 4096, N])
def test_levinson_durbin_and_candidates(n):
    pcm = _pcm(12, n, n % 7, bits=24 if n > 1000 else 16)
    R = ref_lpc.autocorrelation(pcm, 12)
    np.testing.assert_array_equal(native.autocorr(pcm, 12), R)
    Rld = np.asarray(R, dtype=np.longdouble)
    Rld[:, 0] = np.maximum(Rld[:, 0], np.longdouble(1))
    A, brk = lpc.levinson_durbin_snapshots(Rld, 12)
    rA, rbrk = ref_lpc.levinson_durbin_snapshots(Rld, 12)
    assert A.dtype == np.longdouble and np.array_equal(A, rA) and np.array_equal(brk, rbrk)
    for got, want in zip(encoder.lpc_candidates_from_lags(R, n), ref_encoder.lpc_candidates_from_lags(R, n)):
        np.testing.assert_array_equal(got, want)


def test_q15_quantization_rounds_half_away_from_zero():
    c = np.array([0.5 / 32768, -0.5 / 32768, 1.5 / 32768, -2.5 / 32768, 0.99999, -1.0, 1.0, 2.0, -3.0])
    np.testing.assert_array_equal(lpc.quantize_q15(c), ref_lpc.quantize_q15(c))


# ---------------------------------------------------------------- planner, emit


@pytest.mark.parametrize("n,zero_run,partitioning", [
    (N, True, True), (256, True, True), (256, False, True), (256, True, False), (1000, True, True), (40, True, True),
])
def test_native_planner_meta(n, zero_run, partitioning):
    """The native planner's meta rows equal the JAX package's numpy
    plan_group (the definition both planners are held to)."""
    pcm = _pcm(6, n, 3)
    coeffs, _, lvalid, _ = ref_encoder.lpc_candidates_from_lags(ref_lpc.autocorrelation(pcm, 12), n)
    got = native.plan_blocks(pcm, coeffs, lvalid, zero_run, partitioning)
    want = ref_encoder.plan_group(pcm, coeffs, lvalid, n, zero_run, partitioning, np, emit_fields=False)["meta"]
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("n,partitioning", [(N, True), (256, True), (1000, False)])
def test_expand_plan(n, partitioning):
    rng = np.random.RandomState(n)
    pcm = _pcm(8, n, 4)
    coeffs, used, lvalid, mvo = ref_encoder.lpc_candidates_from_lags(ref_lpc.autocorrelation(pcm, 12), n)
    meta = native.plan_blocks(pcm, coeffs, lvalid, True, partitioning)
    meta[:, 0] = rng.randint(0, 11, 8)  # every candidate kind, LPC included
    for got, want in zip(encoder.expand_plan(meta, coeffs, used, mvo, n, partitioning),
                         ref_encoder.expand_plan(meta, coeffs, used, mvo, n, partitioning)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,zero_run,partitioning,bits", [
    (N, True, True, 16), (N, True, True, 24), (256, True, True, 16), (4097, False, True, 16), (300, True, False, 24),
    (3, True, True, 16),
])
def test_channel_block_payloads(n, zero_run, partitioning, bits):
    """Native autocorrelation, LD, planner and emit: the payload bytes of
    a group equal the JAX package's numpy/native ChannelBlockEncoder."""
    pcm = _pcm(7, n, 5, bits)
    got = encoder.ChannelBlockEncoder(zero_run, partitioning).encode_group(pcm)
    want = ref_encoder.ChannelBlockEncoder(zero_run, partitioning, xp=np).encode_group(pcm)
    assert got == want


# ---------------------------------------------------------------- host route


@pytest.mark.parametrize("mode,depth,frames", [
    ("mono", 16, 3 * N + 777), ("lr", 16, 2 * N + 5), ("ms", 16, N + 4096), ("auto", 16, 5 * N + 3000),
    ("mono", 24, 2 * N + 1), ("lr", 24, N), ("ms", 24, 3000), ("auto", 24, 4 * N + 4100), ("auto", 16, 1),
])
def test_host_route_frames(mode, depth, frames):
    left, right = _stereo(frames, frames % 97, depth)
    smode = {"mono": 0, "lr": 0, "ms": 1, "auto": 2}[mode]
    args = (left,) if mode == "mono" else (left, right)
    got = encoder.FrameEncoder(12, smode, 48000, depth, device="cpu").encode(*args)
    assert got == ref_encoder.FrameEncoder(12, smode, 48000, depth, xp=np).encode(*args)


@pytest.mark.parametrize("knob", ["no_zero_run", "no_partitioning", "threads"])
def test_host_route_knobs(knob):
    left, right = _stereo(2 * N + 900, 11)
    port = encoder.FrameEncoder(12, 2, 44100, 16, device="cpu")
    ref = ref_encoder.FrameEncoder(12, 2, 44100, 16, xp=np)
    for enc in (port, ref):
        if knob == "no_zero_run":
            enc.set_zero_run_enabled(False)
        elif knob == "no_partitioning":
            enc.set_partitioning_enabled(False)
        else:
            enc.set_thread_count(2)
    assert port.encode(left, right) == ref.encode(left, right)


@pytest.mark.parametrize("bad", ["empty", "length", "range", "rate", "depth"])
def test_validation_messages(bad):
    left, right, rate, depth = np.zeros(10, np.int32), np.zeros(10, np.int32), 44100, 16
    if bad == "empty":
        left = right = np.empty(0, np.int32)
    elif bad == "length":
        right = np.zeros(9, np.int32)
    elif bad == "range":
        left = left + 40000
    elif bad == "rate":
        rate = 8000
    else:
        depth = 8
    msgs = []
    for enc in (encoder.FrameEncoder(12, 2, rate, depth, device="cpu"),
                ref_encoder.FrameEncoder(12, 2, rate, depth, xp=np)):
        with pytest.raises(ValueError) as e:
            enc.encode(left, right)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------- decoder


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_decoder_on_goldens(name):
    data = open(os.path.join(GOLDEN, f"{name}.lac"), "rb").read()
    left, right, *_ = GOLDENS[name]
    dl, dr, hdr = decoder.FrameDecoder().decode(data)
    rl, rr, rhdr = ref_decoder.FrameDecoder().decode(data)
    assert np.array_equal(dl, left) and np.array_equal(dr, right)
    assert np.array_equal(dl, rl) and np.array_equal(dr, rr) and vars(hdr) == vars(rhdr)


def _v2(data):
    """The same frame as a v2 stream: version 2, no payload-size column,
    block payloads concatenated (each is byte-padded already)."""
    nb = int.from_bytes(data[10:14], "big")
    table = np.frombuffer(data, ">u4", count=2 * nb, offset=14)
    return (data[:2] + b"\x02" + data[3:14] + table[0::2].astype(">u4").tobytes() + data[14 + 8 * nb:])


def _corrupt(data, how):
    if how == "v2":
        return _v2(data)
    if how == "v2_trailing":
        return _v2(data) + b"\x00"
    if how == "v2_payload":
        d = bytearray(_v2(data))
        d[len(d) // 2] ^= 0xFF
        return bytes(d)
    if how == "header":
        return b"\x00" + data[1:]
    if how == "count":
        return data[:10] + b"\x00\x00\x00\x00" + data[14:]
    if how == "truncated":
        return data[: len(data) - 7]
    if how == "trailing":
        return data + b"\x00"
    if how == "payload":
        d = bytearray(data)
        d[len(d) // 2] ^= 0xFF
        return bytes(d)
    if how == "last_byte":
        d = bytearray(data)
        d[-1] ^= 0x01
        return bytes(d)
    raise ValueError(how)


@pytest.mark.parametrize("name", ["multiblock", "sine-auto", "noise24", "sparse"])
@pytest.mark.parametrize("how", ["v2", "v2_trailing", "v2_payload", "header", "count", "truncated", "trailing",
                                 "payload", "last_byte"])
def test_decoder_errors_and_v2(name, how):
    """Corrupted and v2 streams: the same samples or the same DecodeError
    message as the JAX package's decoder."""
    data = _corrupt(open(os.path.join(GOLDEN, f"{name}.lac"), "rb").read(), how)
    results = []
    for dec, err in ((decoder.FrameDecoder(), decoder.DecodeError),
                     (ref_decoder.FrameDecoder(), ref_decoder.DecodeError)):
        try:
            left, right, hdr = dec.decode(data)
            results.append(("ok", left.tobytes(), right.tobytes(), hdr.version))
        except err as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]


@pytest.mark.parametrize("name", ["multiblock", "sine-mono", "noise24", "silence"])
def test_decode_to_wav_bytes(tmp_path, name):
    data = open(os.path.join(GOLDEN, f"{name}.lac"), "rb").read()
    for blob in (data, _v2(data)):
        a, b = str(tmp_path / "port.wav"), str(tmp_path / "ref.wav")
        got = decoder.FrameDecoder().decode_to_wav(blob, a)
        want = ref_decoder.FrameDecoder().decode_to_wav(blob, b)
        assert got[0] == want[0] and vars(got[1]) == vars(want[1])
        assert open(a, "rb").read() == open(b, "rb").read()


# ---------------------------------------------------------------- CLI

_THREADS = re.compile(r"^(Decoder thread usage|Thread usage): \d+ threads\n(WARNING: .*\n)?", re.M)
_MICROS = re.compile(r"\(\d+us decode\)")


def _run(main, argv, capsys, outputs):
    for p in outputs:
        if os.path.exists(p):
            os.remove(p)
    rc = main(argv)
    out, err = capsys.readouterr()
    files = [open(p, "rb").read() if os.path.exists(p) else None for p in outputs]
    return rc, _MICROS.sub("(us decode)", _THREADS.sub("<threads>\n", out)), err, files


@pytest.fixture
def cli_files(tmp_path):
    left, right = _stereo(2 * N + 321, 8)
    w = str(tmp_path / "in.wav")
    assert wav.write_wav(w, left, right, 2, 44100, 16)
    mono = str(tmp_path / "mono24.wav")
    assert wav.write_wav(mono, _stereo(N + 10, 9, 24)[0], np.empty(0, np.int32), 1, 96000, 24)
    lac = str(tmp_path / "good.lac")
    assert ref_cli.main(["encode", w, lac]) == 0
    # frame-level faults: the message comes from the table parse on every
    # decode route (a fault inside a block reads "block=<i> channel=primary"
    # on the native route and names the rule on the Python one)
    good = open(lac, "rb").read()
    bad = str(tmp_path / "bad.lac")
    open(bad, "wb").write(good[:-5])
    bad_header = str(tmp_path / "bad_header.lac")
    open(bad_header, "wb").write(b"\x00" + good[1:])
    junk = str(tmp_path / "junk.wav")
    open(junk, "wb").write(b"RIFF1234WAVEjunk")
    return dict(wav=w, mono=mono, lac=lac, bad=bad, bad_header=bad_header, junk=junk, out=str(tmp_path / "out.lac"),
                back=str(tmp_path / "back.wav"), missing=str(tmp_path / "missing.wav"))


CLI_CASES = {
    "encode": ["encode", "{wav}", "{out}"],
    "encode_lr_threads": ["encode", "{wav}", "{out}", "--stereo-mode=lr", "--threads=2"],
    "encode_ms_no_partitioning": ["encode", "{wav}", "{out}", "--stereo-mode=ms", "--no-partitioning"],
    "encode_mono24": ["encode", "{mono}", "{out}"],
    "encode_debug": ["encode", "{wav}", "{out}", "--debug-lpc", "--debug-partitions", "--debug-stereo-est",
                     "--debug-zr", "--debug-threads"],
    "decode": ["decode", "{lac}", "{back}", "--threads=3", "--debug-threads"],
    "selftest": ["selftest"],
    "same_path": ["encode", "{wav}", "{wav}"],
    "bad_flag": ["encode", "{wav}", "{out}", "--bogus"],
    "bad_threads": ["encode", "{wav}", "{out}", "--threads=0"],
    "unreadable_wav": ["encode", "{junk}", "{out}"],
    "missing_wav": ["encode", "{missing}", "{out}"],
    "missing_lac": ["decode", "{missing}", "{back}"],
    "corrupt_lac": ["decode", "{bad}", "{back}"],
    "corrupt_lac_header": ["decode", "{bad_header}", "{back}"],
    "decode_bad_flag": ["decode", "{lac}", "{back}", "--stereo-mode=lr"],
    "usage_empty": [],
    "usage_short": ["encode", "{wav}"],
    "usage_mode": ["transcode", "{wav}", "{out}"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_matches_lac_tpu_cli(cli_files, capsys, case):
    argv = [a.format(**cli_files) for a in CLI_CASES[case]]
    outputs = [cli_files["out"], cli_files["back"]]
    got = _run(lambda a: cli.main(a, device="cpu"), argv, capsys, outputs)
    want = _run(ref_cli.main, argv, capsys, outputs)
    assert got == want
    assert (got[0] == 0) == (case in ("encode", "encode_lr_threads", "encode_ms_no_partitioning", "encode_mono24",
                                      "encode_debug", "decode", "selftest"))
