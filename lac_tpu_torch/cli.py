"""``lac_cli``-compatible command line on the port (lac_tpu/cli.py,
main.cpp:593-918).

    python -m lac_tpu_torch.cli encode input.wav output.lac [--stereo-mode=lr|ms] [--threads=N]
            [--debug-threads] [--debug-lpc] [--debug-stereo-est] [--debug-zr]
            [--debug-partitions] [--no-partitioning]
    python -m lac_tpu_torch.cli decode input.lac output.wav [--threads=N] [--debug-threads]
    python -m lac_tpu_torch.cli selftest

Same subcommands, flags, env resolution (``LAC_THREADS``), staged atomic
output, messages and exit codes as ``lac_tpu.cli``. ``encode`` and
``selftest`` plan on the CUDA card; :func:`main` takes ``device="cpu"``
from a caller that wants the CPU (the tests). Without a card the default
is an error, reported as ``Error: ...`` with exit code 1; ``decode`` is
host-native (the native runtime) and needs no card. The
whole input is read into memory (the JAX package streams inputs of
2048 blocks or more; not ported yet).
"""

import math
import os
import sys
import time

import numpy as np

from . import resolve_device
from .format import constants as C
from .utils.staged_output import StagedOutputFile, paths_refer_to_same_file
from .utils.threads import parse_thread_limit, parse_threads_flag


def _usage():
    sys.stderr.write("Usage:\n")
    sys.stderr.write(
        "  lac_cli encode input.wav output.lac [--stereo-mode=lr|ms] [--threads=N] "
        "[--debug-threads] [--debug-lpc] [--debug-stereo-est] [--debug-zr] "
        "[--debug-partitions] [--no-partitioning]\n"
    )
    sys.stderr.write("  lac_cli decode input.lac output.wav [--threads=N] [--debug-threads]\n")
    sys.stderr.write("  lac_cli selftest\n")


def _resolve_threads(explicit: int) -> int:
    if explicit > 0:
        return explicit
    return parse_thread_limit(os.environ.get("LAC_THREADS"))


def _load_file(path: str):
    try:
        if os.path.getsize(path) > C.MAX_LAC_INPUT_BYTES:
            return None
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


_ENCODE_SWITCHES = {
    "--debug-threads": ("debug_threads", True),
    "--debug-zr": ("debug_zr", True),
    "--debug-lpc": ("debug_lpc", True),
    "--debug-stereo-est": ("debug_stereo_est", True),
    "--debug-partitions": ("debug_partitions", True),
    "--no-partitioning": ("partitioning", False),
    "--stereo-mode=lr": ("stereo_mode", C.STEREO_LR),
    "--stereo-mode=ms": ("stereo_mode", C.STEREO_MS),
}


def _parse_encode_flags(flags_argv):
    """Parse encode trailing flags; returns an options dict or None on a bad flag."""
    opts = {
        "stereo_mode": C.STEREO_PER_BLOCK,
        "partitioning": True,
        "thread_count": 0,
        "debug_threads": False,
        "debug_zr": False,
        "debug_lpc": False,
        "debug_stereo_est": False,
        "debug_partitions": False,
    }
    for flag in flags_argv:
        if flag in _ENCODE_SWITCHES:
            key, value = _ENCODE_SWITCHES[flag]
            opts[key] = value
        else:
            n = parse_threads_flag(flag)
            if n is None:
                return None
            opts["thread_count"] = n
    return opts


def _report_threads(debug_threads: bool, label="Thread usage", warning="Multi-threading not active "
                    "(single-threaded execution)."):
    if not debug_threads:
        return
    from .runtime.native import thread_collector_count

    # measured distinct worker ids of the native pools (reference
    # ThreadCollector, main.cpp:699-708)
    workers = max(1, thread_collector_count())
    sys.stdout.write(f"{label}: {workers} threads\n")
    if workers <= 1:
        sys.stdout.write(f"WARNING: {warning}\n")


def _cmd_encode(argv, device) -> int:
    from .encoder import FrameEncoder
    from .io import read_wav

    in_path, out_path = argv[0], argv[1]
    if paths_refer_to_same_file(in_path, out_path):
        sys.stderr.write("Input and output paths must be different\n")
        return 1
    opts = _parse_encode_flags(argv[2:])
    if opts is None:
        _usage()
        return 1
    thread_count = _resolve_threads(opts["thread_count"])
    wav = read_wav(in_path)
    if wav is None:
        sys.stderr.write(f"Failed to read WAV: {in_path}\n")
        return 1
    left, right, channels, sample_rate, bit_depth = wav
    effective_mode = 0 if channels == 1 else opts["stereo_mode"]

    def make_encoder():
        enc = FrameEncoder(12, effective_mode, sample_rate, bit_depth, device=device)
        enc.set_partitioning_enabled(opts["partitioning"])
        enc.set_thread_count(thread_count)
        return enc

    encoder = make_encoder()
    encoder.set_debug_lpc(opts["debug_lpc"])
    encoder.set_debug_stereo_est(opts["debug_stereo_est"])
    encoder.set_debug_partitions(opts["debug_partitions"])
    if opts["debug_threads"]:
        from .runtime.native import thread_collector_reset

        thread_collector_reset()
    bitstream = encoder.encode(left, right)
    if opts["debug_zr"]:
        baseline = make_encoder()
        baseline.set_zero_run_enabled(False)
        baseline_bs = baseline.encode(left, right)
        gain = (1.0 - len(bitstream) / len(baseline_bs)) * 100.0 if baseline_bs else 0.0
        sys.stdout.write(
            f"[debug-zr] baseline_bytes={len(baseline_bs)} zr_bytes={len(bitstream)} gain={gain:g}%\n"
        )

    with StagedOutputFile(out_path) as staged:
        ok = staged.is_ready()
        if ok:
            try:
                with open(staged.path(), "wb") as f:
                    f.write(bitstream)
            except OSError:
                ok = False
        if not ok or not staged.publish(in_path):
            sys.stderr.write(f"Failed to write LAC file: {out_path}\n")
            return 1
    sys.stdout.write(f"Encoded {in_path} -> {out_path} ({len(bitstream)} bytes)\n")
    _report_threads(opts["debug_threads"])
    return 0


def _cmd_decode(argv) -> int:
    from .decoder import DecodeError, FrameDecoder

    in_path, out_path = argv[0], argv[1]
    if paths_refer_to_same_file(in_path, out_path):
        sys.stderr.write("Input and output paths must be different\n")
        return 1
    thread_count = 0
    debug_threads = False
    for flag in argv[2:]:
        if flag == "--debug-threads":
            debug_threads = True
        else:
            n = parse_threads_flag(flag)
            if n is None:
                _usage()
                return 1
            thread_count = n
    thread_count = _resolve_threads(thread_count)

    data = _load_file(in_path)
    if data is None:
        sys.stderr.write(f"Failed to read LAC file: {in_path}\n")
        return 1

    with StagedOutputFile(out_path) as staged:
        if not staged.is_ready():
            sys.stderr.write(f"Failed to write WAV: {out_path}\n")
            return 1
        if debug_threads:
            from .runtime.native import thread_collector_reset

            thread_collector_reset()
        decoder = FrameDecoder()
        decoder.set_thread_count(thread_count)
        try:
            res = decoder.decode_to_wav(data, staged.path())
        except DecodeError as e:
            sys.stderr.write(f"Decode failed: {str(e).replace('[decode-error] ', '')}\n")
            return 1
        if res is None:
            sys.stderr.write(f"Failed to write WAV: {out_path}\n")
            return 1
        samples_per_channel, _ = res
        if samples_per_channel == 0:
            sys.stderr.write("Decode failed or produced no samples\n")
            return 1
        if not staged.publish(in_path):
            sys.stderr.write(f"Failed to write WAV: {out_path}\n")
            return 1
    sys.stdout.write(f"Decoded {in_path} -> {out_path} ({samples_per_channel} samples per channel)\n")
    _report_threads(debug_threads, "Decoder thread usage", "Decoder multi-threading may not be active.")
    return 0


def _cmd_selftest(device) -> int:
    from .decoder import FrameDecoder
    from .encoder import FrameEncoder

    def generate(sample_rate, bit_depth, frames):
        amp = 0x7FFFFF // 3 if bit_depth == 24 else 30000
        t = np.arange(frames, dtype=np.float64) / sample_rate
        left = (np.sin(2.0 * math.pi * 440.0 * t) * amp).astype(np.int32)
        right = (np.sin(2.0 * math.pi * 443.0 * t) * (amp * 0.95)).astype(np.int32)
        return left, right

    def roundtrip(name, mode, sample_rate, bit_depth, dec, left, right=()):
        bs = FrameEncoder(12, mode, sample_rate, bit_depth, device=device).encode(left, right)
        t0 = time.perf_counter()
        dl, dr, hdr = dec.decode(bs)
        us = int((time.perf_counter() - t0) * 1e6)
        want_r = right if len(right) else np.empty(0, np.int32)
        if not (np.array_equal(dl, left) and np.array_equal(dr, want_r)):
            sys.stderr.write(f"{name} roundtrip mismatch for sr={sample_rate} depth={bit_depth}\n")
            return None
        return bs, us, hdr

    def run_pair(sample_rate, bit_depth) -> bool:
        src_l, src_r = generate(sample_rate, bit_depth, max(sample_rate // 20, 2048))
        dec = FrameDecoder()
        lr = roundtrip("LR", 0, sample_rate, bit_depth, dec, src_l, src_r)
        if lr is None:
            return False
        bs_lr, lr_us, hdr = lr
        if hdr.sample_rate != sample_rate or hdr.bit_depth != bit_depth:
            sys.stderr.write(f"LR header mismatch sr={hdr.sample_rate} depth={hdr.bit_depth}\n")
            return False
        ms = roundtrip("MS", 1, sample_rate, bit_depth, dec, src_l, src_r)
        if ms is None:
            return False
        bs_ms, ms_us, hdr = ms
        if hdr.sample_rate != sample_rate or hdr.bit_depth != bit_depth:
            sys.stderr.write(f"MS header mismatch sr={hdr.sample_rate} depth={hdr.bit_depth}\n")
            return False
        auto = roundtrip("Auto-stereo", 2, sample_rate, bit_depth, dec, src_l, src_r)
        if auto is None:
            return False
        if auto[2].stereo_mode != 2:
            sys.stderr.write(f"Auto-stereo header mismatch stereo_mode={auto[2].stereo_mode}\n")
            return False
        mono = roundtrip("Mono", 0, sample_rate, bit_depth, dec, src_l)
        if mono is None:
            return False
        if mono[2].channels != 1:
            sys.stderr.write(f"Mono header mismatch channels={mono[2].channels}\n")
            return False
        smaller = "smaller" if len(bs_ms) < len(bs_lr) else "not smaller"
        sys.stdout.write(
            f"Selftest sr={sample_rate}Hz depth={bit_depth}"
            f" LR={len(bs_lr)} bytes ({lr_us}us decode)"
            f" MS={len(bs_ms)} bytes ({ms_us}us decode)"
            f" -> MS is {smaller}\n"
        )
        return True

    for sr, depth in ((44100, 16), (48000, 24), (96000, 24), (192000, 24)):
        if not run_pair(sr, depth):
            return 1
    sys.stdout.write("Selftest complete: adaptive block tests passed.\n")
    return 0


def main(argv=None, device="cuda") -> int:
    """Run one CLI command; returns the exit code. ``device``: where
    ``encode`` and ``selftest`` plan ("cuda", or "cpu" when the caller
    asks for it)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        mode = argv[0] if argv else None
        if mode not in ("encode", "decode", "selftest") or (mode != "selftest" and len(argv) < 3):
            _usage()
            return 1
        if mode == "decode":  # host-native: no device work
            return _cmd_decode(argv[1:])
        device = resolve_device(device)
        if mode == "encode":
            return _cmd_encode(argv[1:], device)
        return _cmd_selftest(device)
    except Exception as e:  # noqa: BLE001 — CLI boundary (main.cpp:914-917)
        sys.stderr.write(f"Error: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
