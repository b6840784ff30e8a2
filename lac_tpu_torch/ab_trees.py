"""Time the one-card encode paths of this checkout against another
checkout of the port, in turns, each turn in a fresh process.

    python -m lac_tpu_torch.ab_trees OTHER_ROOT [--runs N]

``OTHER_ROOT`` is the root of another checkout of the repo (for example
the parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists). The turns are other, this, this, other; each
process imports its own checkout's package (and builds its kernels
there once), makes the inputs from a seed, encodes each once cold and
then ``N`` times warm, on one card (``LAC_TPU_MESH=0``; with
``LAC_TPU_COLD_BLOCKS=0`` no input takes the cold route's host route):

* the 3-minute 44.1 kHz 16-bit stereo file, ``FrameEncoder.encode``;
* the 60 s 96 kHz 24-bit stereo file, the same way;
* the clip batch (84 stereo clips, the one ``chip_smoke.py`` makes),
  ``pool.encode_pooled``;
* the same clips through ``batch.encode_batch(max_workers=4)``;
* the same clips as WAV files through ``serve.serve(["--workers=4"])``,
  from the call to the ``wait`` answer.

Every output of every turn is held to the first turn's (sha256). Prints
the card's name and power limit, then each wall.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys

CHILD = r"""
import hashlib, io, json, os, sys, tempfile, time
from concurrent.futures import ThreadPoolExecutor
import numpy as np
import torch
from lac_tpu_torch.batch import encode_batch
from lac_tpu_torch.encoder import FrameEncoder
from lac_tpu_torch.io import write_wav
from lac_tpu_torch.pool import encode_pooled
from lac_tpu_torch.profile_encode import filtered_noise_stereo, gliding_stereo
from lac_tpu_torch import serve

RUNS = int(sys.argv[1])
B = 16384
rng = np.random.RandomState(60)
frames = [int(s * 44100) for s in rng.uniform(5, 35, 80)]
for at, n in ((5, 40 * B), (20, 7 * B + 5000), (41, B - 1000), (60, 3 * B + 77)):
    frames.insert(at, n)
with ThreadPoolExecutor(8) as ex:
    clips = list(ex.map(lambda i: (filtered_noise_stereo if i % 3 == 2 else gliding_stereo)(
        frames[i], 44100, 16, 1000 + i), range(len(frames))))
left, right = gliding_stereo(7_938_000, 44100, 16, 1)
hi_left, hi_right = gliding_stereo(5_760_000, 96000, 24, 2)


class Wire:
    def __init__(self):
        self.t0, self.buf, self.at = time.perf_counter(), "", {}

    def write(self, text):
        self.buf += text
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.at[json.loads(line)["id"]] = time.perf_counter() - self.t0
        return len(text)

    def flush(self):
        pass


tmp = tempfile.mkdtemp()
wavs = [os.path.join(tmp, f"c{i}.wav") for i in range(len(clips))]
for w, (l, r) in zip(wavs, clips):
    assert write_wav(w, l, r, 2, 44100, 16)


def served():
    outs = [os.path.join(tmp, f"c{i}.lac") for i in range(len(clips))]
    script = "".join(f"encode {w} {o}\n" for w, o in zip(wavs, outs)) + "wait\n"
    wire = Wire()
    assert serve.serve(["--workers=4"], stdin=io.StringIO(script), stdout=wire, device="cuda") == 0
    got = []
    for o in outs:
        with open(o, "rb") as f:
            got.append(f.read())
        os.remove(o)
    return got, wire.at[len(clips) + 1]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


work = {
    "3-minute file": lambda: timed(lambda: [FrameEncoder(12, 2, 44100, 16).encode(left, right)]),
    "60 s 96 kHz 24-bit file": lambda: timed(lambda: [FrameEncoder(12, 2, 96000, 24).encode(hi_left, hi_right)]),
    "clips pooled": lambda: timed(lambda: encode_pooled(clips, 44100, 16)),
    "clips, encode_batch 4 threads": lambda: timed(lambda: encode_batch(clips, 44100, 16, max_workers=4)),
    "clips served, --workers=4": served,
}
result = {}
for name, fn in work.items():
    out, cold = fn()
    walls = [fn()[1] for _ in range(RUNS)]
    result[name] = {"cold": cold, "warm": walls, "sha256": hashlib.sha256(b"".join(out)).hexdigest()}
print("AB " + json.dumps(result))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--runs", type=int, default=3, help="warm runs of each workload per turn")
    args = ap.parse_args(argv)
    here = pathlib.Path(__file__).resolve().parent.parent
    other = pathlib.Path(args.other).resolve()
    if not (other / "lac_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"ab_trees: {other} holds no lac_tpu_torch package")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["LAC_TPU_MESH"] = "0"
    env["LAC_TPU_COLD_BLOCKS"] = "0"  # the card's paths, not the cold route's host route
    first = None
    for label, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        proc = subprocess.run([sys.executable, "-c", CHILD, str(args.runs)], cwd=root, env=env,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"ab_trees: the {label} checkout's turn failed ({proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        got = json.loads(next(line for line in proc.stdout.splitlines() if line.startswith("AB "))[3:])
        first = first or got
        for name, r in got.items():
            if r["sha256"] != first[name]["sha256"]:
                raise SystemExit(f"ab_trees: {name}: the {label} checkout's output differs from the first turn's")
            warm = ", ".join(f"{w:.3f}" for w in r["warm"])
            print(f"{label:5s} {name:30s} cold {r['cold']:.3f} s, warm {warm} s", flush=True)


if __name__ == "__main__":
    main()
