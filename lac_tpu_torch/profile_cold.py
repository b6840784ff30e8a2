"""Where the cold route should end: one-shot CLI encodes in fresh
processes, the host route against the card, by input length.

    python -m lac_tpu_torch.profile_cold [--blocks 8,32,64,128,192,256] [--turns 1]

For each length (full blocks of 44.1 kHz 16-bit stereo, the music-like
recipe of :func:`.profile_encode.gliding_stereo`, plus 100 frames) a WAV
goes through ``cli.main`` in fresh processes, in turns host, card,
card, host: on the host route (``LAC_TPU_COLD_BLOCKS`` at the length, so
the cold route takes it and no CUDA context starts) and on the card
(``LAC_TPU_COLD_BLOCKS=0``: the context, the kernels' first loads and
the plane pipeline). The kernels and the native runtime are built once,
before the first child. Prints the card's name and power limit, then per
child the ``import torch`` time, the ``cli.main`` time and the process
wall; every output is held to the first one of its length (sha256), and
each child's route is checked by ``torch.cuda.is_initialized()``.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

CHILD = r"""
import hashlib, json, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
from lac_tpu_torch import cli
rc = cli.main(["encode", sys.argv[1], sys.argv[2]])
t2 = time.perf_counter()
with open(sys.argv[2], "rb") as f:
    digest = hashlib.sha256(f.read()).hexdigest()
print("COLD " + json.dumps({"rc": rc, "import_s": t1 - t0, "cli_s": t2 - t1, "sha256": digest,
                            "cuda": torch.cuda.is_initialized()}))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", default="8,32,64,128,192,256", help="input lengths in full blocks, comma-separated")
    ap.add_argument("--turns", type=int, default=1, help="turns of host, card, card, host per length")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_cold: needs a card")
    from .io import write_wav
    from .ops import _cuda_lib
    from .profile_encode import gliding_stereo
    from .runtime import native

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    native.native_available()
    _cuda_lib.load()
    env = {k: v for k, v in os.environ.items() if not k.startswith("LAC_TPU_")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        wav, lac = os.path.join(tmp, "in.wav"), os.path.join(tmp, "out.lac")
        for blocks in (int(b) for b in args.blocks.split(",")):
            left, right = gliding_stereo(blocks * 16384 + 100, 44100, 16, 11)
            if not write_wav(wav, left, right, 2, 44100, 16):
                raise SystemExit("profile_cold: WAV write failed")
            want = None
            for _ in range(args.turns):
                for route in ("host", "card", "card", "host"):
                    cold = str(blocks + 1) if route == "host" else "0"
                    t0 = time.perf_counter()
                    proc = subprocess.run([sys.executable, "-c", CHILD, wav, lac], capture_output=True, text=True,
                                          env={**env, "LAC_TPU_COLD_BLOCKS": cold})
                    wall = time.perf_counter() - t0
                    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("COLD ")), None)
                    if proc.returncode != 0 or line is None:
                        raise SystemExit(f"profile_cold: a child failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
                    got = json.loads(line[5:])
                    want = want or got["sha256"]
                    if got["rc"] != 0 or got["sha256"] != want or got["cuda"] != (route == "card"):
                        raise SystemExit(f"profile_cold: {blocks} blocks, {route}: wrong route or bytes: {got}")
                    rows.append({"blocks": blocks, "route": route, "import_s": got["import_s"],
                                 "cli_s": got["cli_s"], "wall_s": wall})
                    print(f"{blocks:4d} blocks, {route}: import torch {got['import_s']:.3f} s, "
                          f"cli.main {got['cli_s']:.3f} s, process {wall:.3f} s", flush=True)
    print("PROFILE_COLD " + json.dumps(rows))


if __name__ == "__main__":
    main()
