"""Where a card's first use goes, in fresh processes on two or more cards.

    python -m lac_tpu_torch.profile_first_use [--turns N] [--cli-only]

Each child is a fresh process that builds nothing (the kernels and the
native runtime are built once, before the first child) and runs with
torch's default lazy module loading (``CUDA_MODULE_LOADING=LAZY``) or
with ``EAGER``:

* per card: every card's CUDA context started first (timed), then the
  3-minute 44.1 kHz 16-bit stereo file encoded on card 0 cold and warm,
  on card 1 cold and warm, and with three or more cards on card 2 cold
  and warm under ``torch.profiler``: the CUDA runtime calls that took the
  most host time in the cold encode, beside the same calls in the warm one;
* the 13-minute WAV (2,100 full blocks: the CLI's streaming route, two
  256-block chunks per 512-block stream chunk) through ``cli.main``, with
  the contexts of the cards it reaches started first, on one card
  (the CLI's default) and on the cards that
  ``LAC_TPU_CLI_MESH=1`` gives it (``cli._one_shot_mesh``: as many as the
  input has chunks in flight), ``N`` times in turns; ``--cli-only`` runs
  this part alone.

Every output is held to the first one of its input (sha256). Prints the
cards' names and power limits first.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

CARDS_CHILD = r"""
import hashlib, json, time
import torch
from lac_tpu_torch.encoder import FrameEncoder
from lac_tpu_torch.profile_encode import gliding_stereo

left, right = gliding_stereo(7_938_000, 44100, 16, 1)
cards = list(range(min(3, torch.cuda.device_count())))
out = {"context_s": {}, "cold_s": {}, "warm_s": {}, "calls": {}}
for i in range(torch.cuda.device_count()):
    t = time.perf_counter()
    torch.zeros(1, device=f"cuda:{i}")
    torch.cuda.synchronize(i)
    out["context_s"][i] = time.perf_counter() - t
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
for i in cards:
    for turn in ("cold_s", "warm_s"):
        prof = torch.profiler.profile(activities=acts) if i == 2 else None
        if prof is not None:
            prof.start()
        t = time.perf_counter()
        got = FrameEncoder(12, 2, 44100, 16, device=f"cuda:{i}").encode(left, right)
        torch.cuda.synchronize(i)
        out[turn][i] = time.perf_counter() - t
        if prof is not None:
            prof.stop()
            out["calls"][turn] = {e.key: [e.count, e.cpu_time_total / 1e6] for e in prof.key_averages()
                                  if e.key.startswith("cu")}
        out.setdefault("sha256", hashlib.sha256(got).hexdigest())
        assert out["sha256"] == hashlib.sha256(got).hexdigest(), f"card {i}: bytes differ from card 0's"
print("FIRST " + json.dumps(out))
"""

CLI_CHILD = r"""
import hashlib, json, sys, time
t0 = time.perf_counter()
import torch
from lac_tpu_torch import cli
from lac_tpu_torch.ops import cuda_kernels
from lac_tpu_torch.cli import _one_shot_mesh
from lac_tpu_torch.stream import scan_wav
t1 = time.perf_counter()
mesh = _one_shot_mesh(scan_wav(sys.argv[1]).frames, True)
for i in range(len(mesh) if mesh else 1):  # the cards the CLI takes
    torch.zeros(1, device=f"cuda:{i}")
    torch.cuda.synchronize(i)
t2 = time.perf_counter()
rc = cli.main(["encode", sys.argv[1], sys.argv[2]])
t3 = time.perf_counter()
with open(sys.argv[2], "rb") as f:
    digest = hashlib.sha256(f.read()).hexdigest()
print("CLI " + json.dumps({"rc": rc, "import_s": t1 - t0, "contexts_s": t2 - t1, "cli_s": t3 - t2, "sha256": digest,
                           "launches": {k: sum(v.values()) for k, v in sorted(cuda_kernels.card_launches.items())}}))
"""


def _child(code, args, env, tag):
    proc = subprocess.run([sys.executable, "-c", code, *args], env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"profile_first_use: a child failed ({proc.returncode}):\n{proc.stdout[-4000:]}\n"
                         f"{proc.stderr[-4000:]}")
    return json.loads(next(line for line in proc.stdout.splitlines() if line.startswith(tag + " "))[len(tag) + 1:])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=1, help="turns of one card and the mesh through the CLI")
    ap.add_argument("--cli-only", action="store_true", help="only the long WAV through the CLI")
    args = ap.parse_args(argv)
    import torch

    if torch.cuda.device_count() < 2:
        raise SystemExit("profile_first_use: needs two or more cards")
    from .io import write_wav
    from .ops import _cuda_lib
    from .profile_encode import gliding_stereo
    from .runtime import native

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    native.native_available()
    _cuda_lib.load()
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_MODULE_LOADING", "LAC_TPU_MESH", "LAC_TPU_CLI_MESH")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    want = None
    for loading in () if args.cli_only else ("LAZY", "EAGER"):
        got = _child(CARDS_CHILD, [], {**env, "CUDA_MODULE_LOADING": loading, "LAC_TPU_COLD_BLOCKS": "0"}, "FIRST")
        want = want or got["sha256"]
        if got["sha256"] != want:
            raise SystemExit("profile_first_use: the 3-minute file's bytes differ between children")
        for i, s in got["context_s"].items():
            print(f"{loading:5s} card {i}: context {s:.3f} s", end="")
            if i in got["cold_s"]:
                print(f"; 3-minute file cold {got['cold_s'][i]:.3f} s, warm {got['warm_s'][i]:.3f} s", end="")
            print()
        if got["calls"]:
            cold, warm = got["calls"]["cold_s"], got["calls"].get("warm_s", {})
            print(f"{loading:5s} card 2, CUDA calls by host time, cold encode (warm encode): "
                  + "; ".join(f"{k} {n} calls {s:.3f} s ({warm.get(k, [0, 0.0])[0]} calls "
                              f"{warm.get(k, [0, 0.0])[1]:.3f} s)"
                              for k, (n, s) in sorted(cold.items(), key=lambda kv: -kv[1][1])[:8]))

    with tempfile.TemporaryDirectory() as tmp:
        left, right = gliding_stereo(2100 * 16384 + 4321, 44100, 16, 5)
        wav, lac = os.path.join(tmp, "long.wav"), os.path.join(tmp, "long.lac")
        if not write_wav(wav, left, right, 2, 44100, 16):
            raise SystemExit("profile_first_use: WAV write failed")
        del left, right
        want = None
        for loading in ("LAZY",) if args.cli_only else ("LAZY", "EAGER"):
            for _ in range(args.turns):
                for mesh in ("0", "1", "1", "0"):
                    got = _child(CLI_CHILD, [wav, lac],
                                 {**env, "CUDA_MODULE_LOADING": loading, "LAC_TPU_CLI_MESH": mesh}, "CLI")
                    want = want or got["sha256"]
                    if got["rc"] != 0 or got["sha256"] != want:
                        raise SystemExit(f"profile_first_use: the long WAV through the CLI failed or differs: {got}")
                    print(f"{loading:5s} long WAV through cli.main, {'mesh    ' if mesh == '1' else 'one card'}: "
                          f"import {got['import_s']:.2f} s, contexts {got['contexts_s']:.2f} s, "
                          f"cli.main {got['cli_s']:.2f} s; launches per card {got['launches']}", flush=True)


if __name__ == "__main__":
    main()
