"""The port's streaming (bounded-memory) encode on the CPU.

``lac_tpu_torch.stream`` against ``lac_tpu.stream`` (``xp=numpy``) and
against the port's own in-memory encode: the same WAV files, made from
seeds, must give the same bytes, the same scan results and the same
messages. Tolerance: none. The plane pipeline runs at a pinned small
chunk width where a streamed chunk holds at least
``device_pipeline.MIN_FULL_BLOCKS`` full blocks (kernels take their plain
versions on CPU tensors).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from lac_tpu import cli as ref_cli  # noqa: E402
from lac_tpu import stream as ref_stream  # noqa: E402
from lac_tpu.decoder import FrameDecoder as RefDecoder  # noqa: E402
from lac_tpu.io import write_wav  # noqa: E402
from lac_tpu_torch import cli, device_pipeline, stream  # noqa: E402
from lac_tpu_torch.encoder import FrameEncoder  # noqa: E402
from lac_tpu_torch.format import constants as C  # noqa: E402
from lac_tpu_torch.io import read_wav  # noqa: E402

from .signals import EMPTY, lcg_noise, sine  # noqa: E402

B = C.MAX_BLOCK_SIZE


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plane pipeline's CPU operators are small: with the suite's worker processes side by
    side, torch's intra-op thread pools spin against each other and a 2 s test takes minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def small_chunks(monkeypatch):
    monkeypatch.setattr(device_pipeline, "CHUNK_BLOCKS", 4)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _mixed_signal(n, seed, amp=24000):
    """Blocks of different character (tone, noise, sparse and silent
    stretches), so chunking crosses real decision boundaries."""
    out = np.zeros(n, np.int32)
    third = n // 3
    out[:third] = sine(third, 44100, 440.0, amp)[:third]
    out[third : 2 * third] = lcg_noise(third, amp // 2, seed)
    tail = np.zeros(n - 2 * third, np.int32)
    tail[::53] = seed % 700 + 1
    out[2 * third :] = tail
    return out


def _make_wav(path, frames, channels, sr, depth, seed=11):
    amp = 24000 if depth == 16 else 2**22
    left = _mixed_signal(frames, seed, amp)
    right = left + lcg_noise(frames, max(1, amp // 64), seed + 12) if channels == 2 else EMPTY
    if depth == 16 and channels == 2:
        right = np.clip(right, -0x8000, 0x7FFF)
    assert write_wav(path, left, right, channels, sr, depth)
    return left, right


CASES = [
    # (name, frames, channels, sample_rate, depth, stereo_mode, chunk_blocks)
    ("auto-5blocks-tail", 5 * B + 1234, 2, 44100, 16, 2, 2),
    ("lr-3blocks", 3 * B, 2, 44100, 16, 0, 2),
    ("ms-2blocks-tail", 2 * B + 7, 2, 48000, 16, 1, 2),
    ("mono-4blocks-tail", 4 * B + 999, 1, 44100, 16, 0, 2),
    ("auto24-3blocks-tail", 3 * B + 321, 2, 96000, 24, 2, 2),
    ("single-partial-block", 5000, 2, 44100, 16, 2, 2),
    # chunks of 9 blocks run the plane pipeline; the last chunk (2 full blocks and a tail) takes the host route
    ("auto-20blocks-tail-pipeline", 20 * B + 77, 2, 44100, 16, 2, 9),
    ("mono-exact-9blocks-pipeline", 9 * B, 1, 44100, 16, 0, 9),
]


@pytest.mark.parametrize("name,frames,channels,sr,depth,mode,chunk_blocks", CASES, ids=[c[0] for c in CASES])
def test_stream_matches_in_memory_and_lac_tpu(tmp_path, name, frames, channels, sr, depth, mode, chunk_blocks):
    wav = str(tmp_path / "in.wav")
    left, right = _make_wav(wav, frames, channels, sr, depth)
    out, ref_out = str(tmp_path / "port.lac"), str(tmp_path / "ref.lac")
    nbytes = stream.encode_wav_to_lac(wav, out, mode, chunk_blocks=chunk_blocks, device="cpu")
    assert ref_stream.encode_wav_to_lac(wav, ref_out, mode, chunk_blocks=chunk_blocks, xp=np) == nbytes
    streamed = _read(out)
    assert nbytes == len(streamed)
    assert streamed == _read(ref_out)
    assert streamed == FrameEncoder(12, mode if channels == 2 else 0, sr, depth, device="cpu").encode(left, right)
    dl, dr, _ = RefDecoder().decode(streamed)
    assert np.array_equal(dl, left) and np.array_equal(dr, right)


@pytest.fixture(scope="module")
def invariance_wav(tmp_path_factory):
    wav = str(tmp_path_factory.mktemp("inv") / "inv.wav")
    left = _mixed_signal(4 * B + 100, 5)
    right = lcg_noise(4 * B + 100, 9000, 6)
    assert write_wav(wav, left, right, 2, 44100, 16)
    return wav, FrameEncoder(12, 2, 44100, 16, device="cpu").encode_frame(left, right)


@pytest.mark.parametrize("chunk_blocks", [1, 3, 512])
def test_stream_chunk_size_invariance(tmp_path, invariance_wav, chunk_blocks):
    wav, want = invariance_wav
    out = str(tmp_path / "inv.lac")
    assert stream.encode_wav_to_lac(wav, out, 2, chunk_blocks=chunk_blocks, device="cpu") == len(want)
    assert _read(out) == want


def test_default_chunk_blocks_reads_the_environment(monkeypatch):
    monkeypatch.delenv("LAC_TPU_STREAM_CHUNK_BLOCKS", raising=False)
    assert stream._default_chunk_blocks() == ref_stream._default_chunk_blocks() == 512
    for value in ("7", "zzz"):
        monkeypatch.setenv("LAC_TPU_STREAM_CHUNK_BLOCKS", value)
        assert stream._default_chunk_blocks() == ref_stream._default_chunk_blocks()


def test_stream_encoder_reuse_and_mismatch(tmp_path):
    left = lcg_noise(B + 50, 8000, 3)
    wav = str(tmp_path / "m.wav")
    assert write_wav(wav, left, EMPTY, 1, 44100, 16)
    enc = FrameEncoder(12, 0, 44100, 16, device="cpu")
    for i in range(2):  # the same encoder serves several files
        out = str(tmp_path / f"m{i}.lac")
        assert stream.encode_wav_to_lac(wav, out, 0, chunk_blocks=1, encoder=enc)
        assert _read(out) == enc.encode(left)
    for bad in (FrameEncoder(12, 0, 48000, 16, device="cpu"), FrameEncoder(12, 0, 44100, 24, device="cpu"),
                FrameEncoder(12, 1, 44100, 16, device="cpu")):
        with pytest.raises(ValueError, match="does not match the WAV input"):
            stream.encode_wav_to_lac(wav, str(tmp_path / "bad.lac"), 0, encoder=bad)
    assert not (tmp_path / "bad.lac").exists()


def _wav_mutations():
    """name -> bytes: one valid WAV and malformed variants of it."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "base.wav")
        assert write_wav(p, sine(3000, 44100, 440.0, 20000), sine(3000, 44100, 443.0, 19000), 2, 44100, 16)
        raw = _read(p)

    def patched(edit, blob=raw):
        b = bytearray(blob)
        edit(b)
        return bytes(b)

    def set_riff(b):
        b[4:8] = (len(b) - 8).to_bytes(4, "little")

    cases = {
        "valid": raw,
        "riff-size": patched(lambda b: b.__setitem__(4, b[4] ^ 1)),
        "wave-tag": patched(lambda b: b.__setitem__(slice(8, 12), b"WAVX")),
        "format-tag": patched(lambda b: b.__setitem__(20, 3)),
        "channels": patched(lambda b: b.__setitem__(22, 5)),
        "rate": patched(lambda b: b.__setitem__(slice(24, 28), (12345).to_bytes(4, "little"))),
        "align": patched(lambda b: b.__setitem__(32, 9)),
        "truncated": raw[: len(raw) // 2],
        "tiny": raw[:10],
        "empty": b"",
        "trailing-chunk": patched(set_riff, raw + b"junk" + (4).to_bytes(4, "little") + b"ABCD"),
        "odd-chunk-padded": patched(set_riff, raw + b"junk" + (3).to_bytes(4, "little") + b"ABC\0"),
        "trailing-garbage": patched(set_riff, raw + b"xy"),
    }
    b = bytearray(raw)  # data size not a multiple of block_align: shrink the data chunk by one byte
    b[40:44] = (int.from_bytes(b[40:44], "little") - 1).to_bytes(4, "little")
    b[4:8] = (len(b) - 8 - 1).to_bytes(4, "little")
    cases["data-align"] = bytes(b[:-1])
    return cases


WAV_MUTATIONS = _wav_mutations()


@pytest.mark.parametrize("name", sorted(WAV_MUTATIONS))
def test_scan_wav_matches_lac_tpu_and_read_wav(tmp_path, name):
    p = str(tmp_path / "case.wav")
    with open(p, "wb") as f:
        f.write(WAV_MUTATIONS[name])
    scanned, want, parsed = stream.scan_wav(p), ref_stream.scan_wav(p), read_wav(p)
    assert (scanned is None) == (want is None) == (parsed is None)
    assert (scanned is not None) == (name in ("valid", "trailing-chunk", "odd-chunk-padded"))
    if scanned is not None:
        assert vars(scanned) == vars(want) and scanned.block_align == want.block_align
        left, _, channels, sr, depth = parsed
        assert (scanned.frames, scanned.channels, scanned.sample_rate, scanned.bit_depth) == (
            len(left), channels, sr, depth)


def test_scan_wav_missing_file(tmp_path):
    assert stream.scan_wav(str(tmp_path / "missing.wav")) is None
    assert stream.encode_wav_to_lac(str(tmp_path / "missing.wav"), str(tmp_path / "o.lac"), device="cpu") is None


@pytest.mark.parametrize("channels,depth", [(1, 16), (2, 16), (1, 24), (2, 24)])
def test_read_pcm_frames_matches_lac_tpu(tmp_path, channels, depth):
    wav = str(tmp_path / "r.wav")
    left, right = _make_wav(wav, 3000, channels, 48000, depth, seed=3)
    if depth == 24:  # the extremes of the 24-bit range survive the sign extension
        left[:2] = (-0x800000, 0x7FFFFF)
        assert write_wav(wav, left, right, channels, 48000, depth)
    info = stream.scan_wav(wav)
    with open(wav, "rb") as f:
        got = stream.read_pcm_frames(f, info, 100, 2500)
        want = ref_stream.read_pcm_frames(f, ref_stream.scan_wav(wav), 100, 2500)
        with pytest.raises(stream.WavReadError):
            stream.read_pcm_frames(f, info, 2000, 1001)
    for g, w, src in zip(got, want, (left, right)):
        assert g.dtype == w.dtype == np.int32 and np.array_equal(g, w) and np.array_equal(g, src[100:2600])
    with open(wav, "rb") as f:
        assert np.array_equal(stream.read_pcm_frames(f, info, 0, 2)[0], left[:2])


def test_stream_rejects_malformed(tmp_path):
    p = str(tmp_path / "bad.wav")
    with open(p, "wb") as f:
        f.write(b"RIFF\x00\x00\x00\x00WAVE")
    assert stream.encode_wav_to_lac(p, str(tmp_path / "bad.lac"), device="cpu") is None
    assert not (tmp_path / "bad.lac").exists()


def test_stream_failure_never_clobbers_output(tmp_path):
    """An input that fails mid-encode leaves an existing output as it was and no temp file."""
    left = lcg_noise(B + 70, 9000, 41)
    wav = str(tmp_path / "ok.wav")
    assert write_wav(wav, left, EMPTY, 1, 44100, 16)
    info = stream.scan_wav(wav)
    # a copy cut short inside the data chunk, with the whole file's scan result: the chunked read hits the end
    cut = str(tmp_path / "cut.wav")
    with open(cut, "wb") as f:
        f.write(_read(wav)[:-1000])
    out = str(tmp_path / "out.lac")
    with open(out, "wb") as f:
        f.write(b"precious bytes")
    with pytest.raises(stream.WavReadError):
        stream.encode_wav_to_lac(cut, out, 0, chunk_blocks=1, info=info, device="cpu")
    assert issubclass(stream.WavReadError, OSError)
    assert _read(out) == b"precious bytes"
    assert [p.name for p in tmp_path.iterdir() if ".tmp-" in p.name] == []


def test_stream_info_param_skips_rescan(tmp_path, monkeypatch):
    left = lcg_noise(2 * B, 7000, 8)
    wav = str(tmp_path / "i.wav")
    assert write_wav(wav, left, EMPTY, 1, 44100, 16)
    info = stream.scan_wav(wav)

    def boom(path):
        raise AssertionError("encode_wav_to_lac scanned the WAV again")

    monkeypatch.setattr(stream, "scan_wav", boom)
    out = str(tmp_path / "i.lac")
    nbytes = stream.encode_wav_to_lac(wav, out, 0, chunk_blocks=1, info=info, device="cpu")
    assert nbytes == len(_read(out))
    assert _read(out) == FrameEncoder(12, 0, 44100, 16, device="cpu").encode(left)


@pytest.fixture
def cli_wav(tmp_path):
    wav = str(tmp_path / "in.wav")
    pcm = _make_wav(wav, 3 * B + 500, 2, 44100, 16, seed=31)
    return wav, pcm


@pytest.mark.parametrize("flags", [[], ["--stereo-mode=ms", "--threads=2"], ["--no-partitioning"]],
                         ids=["auto", "ms-threads", "no-partitioning"])
def test_cli_streaming_route_matches_lac_tpu_cli(tmp_path, capsys, monkeypatch, cli_wav, flags):
    """From ``LAC_TPU_STREAM_BLOCKS`` blocks on, the CLI streams: same stdout and bytes as
    ``lac_tpu.cli`` on its streaming route and as the port's in-memory route."""
    wav, _ = cli_wav
    called = []
    real = stream.encode_wav_to_lac
    monkeypatch.setattr(stream, "encode_wav_to_lac", lambda *a, **k: called.append(1) or real(*a, **k))
    out = str(tmp_path / "out.lac")

    def run(main, threshold, **kw):
        monkeypatch.setenv("LAC_TPU_STREAM_BLOCKS", threshold)
        monkeypatch.setenv("LAC_TPU_STREAM_CHUNK_BLOCKS", "2")
        assert main(["encode", wav, out] + flags, **kw) == 0
        data = _read(out)
        os.remove(out)
        return data, capsys.readouterr().out

    want = run(ref_cli.main, "2")
    assert not called
    assert run(cli.main, "2", device="cpu") == want and called == [1]
    assert run(cli.main, "0", device="cpu") == want and called == [1]  # 0: the in-memory route
    assert run(cli.main, "5", device="cpu") == want and called == [1]  # 4 blocks: under the threshold
    assert run(cli.main, "abc", device="cpu") == want and called == [1]  # malformed: the default, 2048
    assert want[1].startswith("Encoded ")


def test_cli_streaming_route_debug_flags_stay_in_memory(tmp_path, capsys, monkeypatch, cli_wav):
    wav, _ = cli_wav
    monkeypatch.setenv("LAC_TPU_STREAM_BLOCKS", "2")

    def boom(*a, **k):
        raise AssertionError("a debug flag took the streaming route")

    monkeypatch.setattr(stream, "encode_wav_to_lac", boom)
    out = str(tmp_path / "o.lac")
    argv = ["encode", wav, out, "--debug-zr"]
    assert ref_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert cli.main(argv, device="cpu") == 0
    assert capsys.readouterr().out == want and "[debug-zr]" in want


def test_cli_streaming_route_failures(tmp_path, capsys, monkeypatch, cli_wav):
    """Messages and exit codes of the streaming route: a WAV that breaks mid-encode is a read
    failure, an output that cannot be written a write failure; neither leaves an output."""
    wav, _ = cli_wav
    monkeypatch.setenv("LAC_TPU_STREAM_BLOCKS", "2")
    out = str(tmp_path / "o.lac")

    def raising(exc):
        def fn(*a, **k):
            raise exc
        return fn

    for exc, msg in ((stream.WavReadError("cut"), f"Failed to read WAV: {wav}\n"),
                     (OSError("disk full"), f"Failed to write LAC file: {out}\n")):
        monkeypatch.setattr(stream, "encode_wav_to_lac", raising(exc))
        assert cli.main(["encode", wav, out], device="cpu") == 1
        assert capsys.readouterr().err == msg
        assert not os.path.exists(out)
    monkeypatch.setattr(stream, "encode_wav_to_lac", lambda *a, **k: None)
    assert cli.main(["encode", wav, out], device="cpu") == 1
    assert capsys.readouterr().err == f"Failed to read WAV: {wav}\n"
    missing_dir = str(tmp_path / "no" / "such" / "o.lac")
    assert cli.main(["encode", wav, missing_dir], device="cpu") == 1
    assert capsys.readouterr().err == f"Failed to write LAC file: {missing_dir}\n"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.wav"]


def test_streaming_defaults_to_the_card(tmp_path, capsys, monkeypatch, cli_wav):
    """Without a card the default device raises, from the library call and at the CLI boundary."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs (chip_smoke.py covers it)")
    wav, _ = cli_wav
    out = str(tmp_path / "o.lac")
    with pytest.raises(RuntimeError, match="cuda"):
        stream.encode_wav_to_lac(wav, out, 2)
    monkeypatch.setenv("LAC_TPU_STREAM_BLOCKS", "2")
    assert cli.main(["encode", wav, out]) == 1
    assert capsys.readouterr().err.startswith("Error: device 'cuda' requested")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["in.wav"]
