"""``lac_cli``-compatible command line on the port (lac_tpu/cli.py).

    python -m lac_tpu_torch.cli encode input.wav output.lac [--stereo-mode=lr|ms] [--threads=N]
            [--debug-threads] [--debug-lpc] [--debug-stereo-est] [--debug-zr]
            [--debug-partitions] [--no-partitioning]

``encode`` plans on the CUDA card when torch sees one, else on the CPU;
flags, staged atomic output, messages and exit codes are those of
``lac_tpu.cli``. The whole input is read into memory (the JAX package's
bounded-memory streaming of very long inputs is not ported yet).
``decode`` and ``selftest`` are host-native and run ``lac_tpu.cli``.
"""

import sys

import torch

from lac_tpu import cli as host_cli
from lac_tpu.io import read_wav
from lac_tpu.utils.staged_output import StagedOutputFile, paths_refer_to_same_file


def _cmd_encode(argv) -> int:
    from .encoder import FrameEncoder

    in_path, out_path = argv[0], argv[1]
    if paths_refer_to_same_file(in_path, out_path):
        sys.stderr.write("Input and output paths must be different\n")
        return 1
    opts = host_cli._parse_encode_flags(argv[2:])
    if opts is None:
        host_cli._usage()
        return 1
    thread_count = host_cli._resolve_threads(opts["thread_count"])
    wav = read_wav(in_path)
    if wav is None:
        sys.stderr.write(f"Failed to read WAV: {in_path}\n")
        return 1
    left, right, channels, sample_rate, bit_depth = wav
    effective_mode = 0 if channels == 1 else opts["stereo_mode"]
    device = "cuda" if torch.cuda.is_available() else "cpu"

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
        from lac_tpu.runtime.native import thread_collector_reset

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
    host_cli._report_threads(opts["debug_threads"])
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "encode":
        return host_cli.main(argv)
    if len(argv) < 3:
        host_cli._usage()
        return 1
    try:
        return _cmd_encode(argv[1:])
    except Exception as e:  # noqa: BLE001 — CLI boundary, as lac_tpu.cli.main
        sys.stderr.write(f"Error: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
