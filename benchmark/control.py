"""The controls and the planted faults that ``correct`` has to catch.

The configurations state two guarantees: losslessness at the input's
width, and every block coded with the reference encoder's plan. Each
control breaks one of them (:data:`CONTROLS`):

- ``lsb``: the program is handed every input with its lowest bit cleared
  (15 of 16 bits, 23 of 24: the next precision below the stated one), and
  its streams are judged against the true inputs (``blocks_wrong``).
- ``coarse``: the program's own coarser plan search, switched on
  (``partitioning_enabled=False``: no partition orders are tried); its
  streams stay lossless and grow, and are judged against the reference
  encoder's plan (``plans_wrong``).

The faults, planted in the program's timed path (context managers that
wrap it, for the tests in ``benchmark/tests`` and for runs by hand):
``unchanged`` (the per-file finish hands back the stream of its previous
call: a step that returns its state unchanged), ``half`` (every other
file left out: its finish gives no stream), ``token`` (one bit of every
block's payload flipped where the stream is produced). All three sit in
``FrameEncoder.encode_frame``, which the pool's per-file finishes call.

Run a control on the card at a cell's own size, seeds in one process:

    python3 -m benchmark.control --workload <cell> --kind lsb|coarse|sound --seeds 1,2,3 --seconds <s>
"""

import contextlib

import numpy as np


def lsb_control(batch):
    return [(left & ~1, right & ~1) for left, right in batch]


CONTROLS = {"lsb": {"inputs": lsb_control}, "coarse": {"opts": {"partitioning_enabled": False}}, "sound": None}


def _flip_every_block(stream):
    """The stream with one bit flipped in the middle of each block's payload."""
    data = bytearray(stream)
    count = int.from_bytes(data[10:14], "big")
    tbl = np.frombuffer(bytes(data[14 : 14 + 8 * count]), dtype=">u4").astype(np.int64)
    offsets = 14 + 8 * count + np.concatenate([[0], np.cumsum(tbl[1::2])[:-1]])
    for off, size in zip(offsets.tolist(), tbl[1::2].tolist()):
        data[off + size // 2] ^= 0x10
    return bytes(data)


@contextlib.contextmanager
def planted(name):
    """Break the program's timed path with fault ``name`` while inside."""
    import threading

    from lac_tpu_torch.encoder import FrameEncoder

    orig = FrameEncoder.encode_frame
    lock = threading.Lock()
    state = {"last": None, "calls": 0}

    def unchanged(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        with lock:
            prev, state["last"] = state["last"], out
        return out if prev is None else prev

    def half(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        with lock:
            state["calls"] += 1
            return b"" if state["calls"] % 2 == 0 else out

    def token(self, *args, **kwargs):
        return _flip_every_block(orig(self, *args, **kwargs))

    faults = {"unchanged": unchanged, "half": half, "token": token}
    if name not in faults:
        raise ValueError(f"unknown fault {name!r}")
    FrameEncoder.encode_frame = faults[name]
    try:
        yield
    finally:
        FrameEncoder.encode_frame = orig


def main(argv=None):
    import argparse
    import json
    import sys

    from . import run, spec

    ap = argparse.ArgumentParser(description="the control's readings of one cell, seeds in one process")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--kind", choices=sorted(CONTROLS), required=True, help="sound: the program as it is")
    args = ap.parse_args(argv)
    bench = spec.load()
    wl = spec.workload(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, info = run.run_cell(bench, wl, seed, args.seconds, False, control=CONTROLS[args.kind])
        print(json.dumps({"seed": seed, "kind": args.kind, "correct": result["correct"], "checks": result["checks"],
                          "judged": info["judged"], "reference_s": info["reference_s"], "notes": info["notes"][:2],
                          "metrics": result["metrics"]}))
        sys.stdout.flush()


if __name__ == "__main__":
    main()
