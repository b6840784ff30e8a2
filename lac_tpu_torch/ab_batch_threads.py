"""``batch.encode_batch`` on the card: threads against a serial loop, with
and without the plane pipeline's dispatch lock.

    python -m lac_tpu_torch.ab_batch_threads [--clips N]

Encodes ``N`` stereo 44.1 kHz 16-bit clips of 5-35 s (made from a seed)
serially, then through ``encode_batch`` with 2 and 4 threads, each with
``device_pipeline._dispatch_lock`` as shipped and replaced by a lock that
does nothing, twice over in turns; every result is held to the serial
one. Prints the wall and frames/s of each beside the card's name and
power limit.
"""

import argparse
import contextlib
import subprocess
import time

import numpy as np
import torch

from . import device_pipeline
from .batch import encode_batch
from .encoder import FrameEncoder
from .profile_encode import filtered_noise_stereo, gliding_stereo


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clips", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_batch_threads: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    device_pipeline.mark_warm()  # the card's path, not the cold route's host route
    rng = np.random.RandomState(60)
    clips = [(filtered_noise_stereo if i % 3 == 2 else gliding_stereo)(int(s * 44100), 44100, 16, 1000 + i)
             for i, s in enumerate(rng.uniform(5, 35, args.clips))]
    frames = sum(len(left) for left, _ in clips)

    def serial():
        return [FrameEncoder(12, 2, 44100, 16, device="cuda").encode(left, right) for left, right in clips]

    want = serial()  # cold: kernel build, CUDA context
    print(f"{len(clips)} clips, {frames} frames, {sum(len(left) // 16384 for left, _ in clips)} full blocks")
    shipped = device_pipeline._dispatch_lock
    runs = [("serial loop", True, serial)]
    for threads in (4, 2):
        for locked in (False, True):
            runs.append((f"encode_batch, {threads} threads, {'dispatch lock' if locked else 'no lock'}", locked,
                         lambda threads=threads: encode_batch(clips, 44100, 16, max_workers=threads)))
    try:
        for turn in (runs, runs[::-1]):
            for name, locked, fn in turn:
                device_pipeline._dispatch_lock = shipped if locked else contextlib.nullcontext()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if got != want:
                    raise RuntimeError(f"{name}: frames differ from the serial loop's")
                print(f"{name:44s} {wall:.3f} s = {frames / wall:,.0f} frames/s", flush=True)
    finally:
        device_pipeline._dispatch_lock = shipped


if __name__ == "__main__":
    main()
