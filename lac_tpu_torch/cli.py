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
host-native (the native runtime) and needs no card.

``encode`` scans the WAV before it reads it. An input of at least
``LAC_TPU_STREAM_BLOCKS`` blocks (default 2048; 0 turns the route off)
streams through :func:`.stream.encode_wav_to_lac` into the staged
output, ``LAC_TPU_STREAM_CHUNK_BLOCKS`` blocks at a time (default 512),
in bounded memory; the debug flags keep the in-memory path. The card is
checked for at once and its CUDA context starts only when the input
reaches it: in a process that has not used the card, an input of at
most ``LAC_TPU_COLD_BLOCKS`` blocks (default 1024) is planned on the host
and starts none (``encoder._cold_route``). A one-shot encode runs on
one card: on four H100s the 13-minute WAV took longer through the CLI
on the two cards its chunks reach than on one (each card pays its first
use). ``LAC_TPU_CLI_MESH=1`` asks for the mesh: the cards of
:func:`.parallel.default_mesh`, no more than the input has plane-pipeline
chunks in flight (:func:`_one_shot_mesh`); counting the cards starts no
context. The pool and the service take the default mesh
(``LAC_TPU_MESH=0`` keeps them, and the CLI's opt-in, on one card).
"""

import math
import os
import sys
import threading
import time

import numpy as np

from . import check_device
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


def _stream_threshold() -> int:
    """Blocks from which ``encode`` streams (``LAC_TPU_STREAM_BLOCKS``; 0: never)."""
    try:
        return int(os.environ.get("LAC_TPU_STREAM_BLOCKS", "2048"))
    except ValueError:
        return 2048


# pooled-encode injection (:mod:`.pool`): a batcher pre-reads the WAV and
# plans a file's full blocks inside a shared device wave, then replays
# the ordinary CLI encode with both handed over thread-locally: the CLI
# path (flags, staged output, messages, exit codes) stays the single
# source of truth and the WAV is never read twice.
_inject_tls = threading.local()


def _set_encode_injection(in_path, wav, planes):
    """Hand the next ``encode`` of ``in_path`` on this thread its WAV
    (``read_wav``'s tuple) and its full blocks' planes (what
    ``FrameEncoder.encode_frame`` takes, or None to plan them anew)."""
    _inject_tls.data = (in_path, wav, planes)


def _pop_encode_injection(in_path):
    d = getattr(_inject_tls, "data", None)
    if d is not None and d[0] == in_path:
        _inject_tls.data = None
        return d
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


def _one_shot_mesh(frames, streaming):
    """The cards a one-shot encode of ``frames`` frames takes: one (None)
    unless ``LAC_TPU_CLI_MESH=1`` asks for the mesh; then those of
    :func:`.parallel.default_mesh`, but no more than the plane-pipeline
    chunks it has in flight at once (``ceil(nfull / chunk_width(nfull))``
    in memory, one stream chunk's on the streaming route), since every
    card costs its first use; None again for one card, for an input the
    plane pipeline does not take, or one the cold route keeps on the host."""
    from . import device_pipeline
    from .encoder import _cold_route
    from .parallel import default_mesh

    if os.environ.get("LAC_TPU_CLI_MESH") != "1":
        return None
    nfull = frames // C.MAX_BLOCK_SIZE
    if streaming:
        from .stream import _default_chunk_blocks

        nfull = min(nfull, max(1, _default_chunk_blocks()))
    if _cold_route(-(-frames // C.MAX_BLOCK_SIZE)) or not device_pipeline.applicable(nfull):
        return None
    mesh = default_mesh()
    if mesh is None:
        return None
    cards = min(len(mesh), -(-nfull // device_pipeline.chunk_width(nfull)))
    return mesh[:cards] if cards > 1 else None


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

    # bounded-memory routing: inputs of at least LAC_TPU_STREAM_BLOCKS
    # blocks stream a chunk of blocks at a time instead of loading the
    # whole PCM; output bytes are identical. Debug flags print per-block
    # data, so they keep the single-pass in-memory path.
    any_debug = opts["debug_zr"] or opts["debug_lpc"] or opts["debug_stereo_est"] or opts["debug_partitions"]
    # pooled handoff: a batcher already read this WAV and planned its
    # full blocks in a shared device wave: reuse both (a re-read could
    # differ from the planned planes if the file changed)
    inject = _pop_encode_injection(in_path)
    stream_info = None
    stream_threshold = _stream_threshold()
    if inject is None and not any_debug and stream_threshold > 0:
        from .stream import scan_wav

        info = scan_wav(in_path)
        if info is not None and -(-info.frames // C.MAX_BLOCK_SIZE) >= stream_threshold:
            stream_info = info

    if stream_info is not None:
        left = right = None
        channels, sample_rate, bit_depth = stream_info.channels, stream_info.sample_rate, stream_info.bit_depth
    elif inject is not None:
        left, right, channels, sample_rate, bit_depth = inject[1]
    else:
        wav = read_wav(in_path)
        if wav is None:
            sys.stderr.write(f"Failed to read WAV: {in_path}\n")
            return 1
        left, right, channels, sample_rate, bit_depth = wav
    effective_mode = 0 if channels == 1 else opts["stereo_mode"]
    frames = stream_info.frames if stream_info is not None else len(left)
    mesh = _one_shot_mesh(frames, stream_info is not None) if device.type == "cuda" else None

    def make_encoder():
        enc = FrameEncoder(12, effective_mode, sample_rate, bit_depth, device=device, mesh=mesh)
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
    if stream_info is not None:
        return _encode_streaming(in_path, out_path, encoder, stream_info, opts["debug_threads"])
    if inject is not None and inject[2] is not None:
        bitstream = encoder.encode_frame(left, right, inject[2])
    else:
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


def _encode_streaming(in_path, out_path, encoder, info, debug_threads) -> int:
    """``encode`` through the bounded-memory route, into the staged output."""
    from .stream import WavReadError, encode_wav_to_lac

    with StagedOutputFile(out_path) as staged:
        if not staged.is_ready():
            sys.stderr.write(f"Failed to write LAC file: {out_path}\n")
            return 1
        try:
            nbytes = encode_wav_to_lac(in_path, staged.path(), encoder.stereo_mode, encoder=encoder, info=info)
        except WavReadError:
            nbytes = None  # the input broke or changed mid-encode: a read failure
        except OSError:
            sys.stderr.write(f"Failed to write LAC file: {out_path}\n")
            return 1
        if nbytes is None:
            sys.stderr.write(f"Failed to read WAV: {in_path}\n")
            return 1
        if not staged.publish(in_path):
            sys.stderr.write(f"Failed to write LAC file: {out_path}\n")
            return 1
    sys.stdout.write(f"Encoded {in_path} -> {out_path} ({nbytes} bytes)\n")
    _report_threads(debug_threads)
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
        device = check_device(device)  # a missing card is an error now; its context starts on first use
        if mode == "encode":
            return _cmd_encode(argv[1:], device)
        return _cmd_selftest(device)
    except Exception as e:  # noqa: BLE001 — CLI boundary (main.cpp:914-917)
        sys.stderr.write(f"Error: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
