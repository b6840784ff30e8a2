"""The token body packed on the card against the native packer (the port's
counterpart of scripts/bench_device_pack.py).

    python -m lac_tpu_torch.experiments.bench_device_pack [--lanes 256] [--reps 4] [--device cuda|cpu]

Lanes of 16384 Laplacian residuals (lane-varying scale, like LPC output,
from a seed) are coded as adaptive Rice tokens: zigzag, the stateful k
sequence (``ops.adapt.k_after_stateful``, kernel 6 on the card at
(lanes, 16384)), then ``experiments.device_pack.pack_rice_lanes``. Every
lane's packed bytes are held to ``bitio.pack.pack_stream`` and the native
``pack_streams`` of the same elements before anything is timed. Then, on
the device (host clock, the card synchronized): the residuals' upload,
the emit and the words' fetch; the emit alone; the pack alone; beside the
native packer (host threads) from the elements. Prints the card's name and
power limit and one JSON line. Runs on the card, raises without one.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import check_device
from ..bitio.pack import pack_stream
from ..ops import adapt
from ..runtime import native
from .device_pack import pack_rice_lanes, rice_elements, words_capacity, words_to_bytes, zigzag

N = 16384
INITIAL_K = 4


def make_lanes(lanes, seed=5):
    """(lanes, N) int32 Laplacian residuals, lane-varying scale (as the
    reference's bench)."""
    rng = np.random.RandomState(seed)
    scales = np.exp(rng.uniform(np.log(2), np.log(400), lanes))
    res = rng.laplace(0, scales[:, None], (lanes, N)).astype(np.int64)
    return np.clip(res, -(1 << 22), (1 << 22) - 1).astype(np.int32)


def rice_codes(res):
    """Residuals on the device -> (u, k_used): zigzag codes and the stateful
    per-sample encoding k (kernel 6 on the card)."""
    u = zigzag(res)
    return u, adapt.k_used_from_after(adapt.k_after_stateful(u.to(torch.int32)), INITIAL_K)


def emit(res, W):
    """Residuals -> (words, total_bits): zigzag, k sequence, Rice pack."""
    return pack_rice_lanes(*rice_codes(res), W)


def check_lanes(words, tb, unary, fv, fl):
    """Every lane's packed bytes against ``pack_stream`` and the native
    packer of the same elements (host arrays). Returns the native streams."""
    lanes = words.shape[0]
    offs = np.arange(lanes + 1, dtype=np.uint64) * np.uint64(unary.shape[1])
    streams = native.pack_streams(unary.reshape(-1), fv.reshape(-1), fl.reshape(-1), offs)
    for b in range(lanes):
        got = words_to_bytes(words[b], tb[b])
        if got != streams[b] or got != pack_stream(unary[b], fv[b].astype(np.uint64), fl[b]):
            raise AssertionError(f"device pack, lane {b}: bytes differ from pack_stream / the native packer")
    return streams


def run(lanes=256, reps=4, device="cuda"):
    """Check and time; returns a dict of the results (seconds, bytes)."""
    dev = check_device(device)
    res = make_lanes(lanes)
    res_d = torch.from_numpy(res).to(dev)
    u, k_used = rice_codes(res_d)
    unary, fv, fl = (t.cpu().numpy() for t in rice_elements(u, k_used))
    max_bits = int((unary + fl).sum(axis=1).max())
    W = words_capacity(max_bits)
    words, tb = emit(res_d, W)
    check_lanes(words.cpu(), tb.cpu(), unary, fv, fl)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def best(fn):
        t = float("inf")
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            t = min(t, time.perf_counter() - t0)
        return t

    def round_trip():
        w, b = emit(torch.from_numpy(res).to(dev), W)
        w.cpu(), b.cpu()

    un32, fv32, fl8 = unary.reshape(-1).astype(np.uint32), fv.reshape(-1).astype(np.uint32), fl.reshape(-1)
    offs = np.arange(lanes + 1, dtype=np.uint64) * np.uint64(N)
    out = {
        "lanes": lanes, "n": N, "W": W, "fetch_bytes": lanes * W * 4,
        "payload_bytes": int(tb.sum()) // 8,
        "upload_emit_fetch_s": best(round_trip),
        "emit_s": best(lambda: emit(res_d, W)),
        "pack_s": best(lambda: pack_rice_lanes(u, k_used, W)),
        "native_pack_s": best(lambda: native.pack_streams(un32, fv32, fl8.astype(np.uint8), offs)),
    }
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
    out = run(args.lanes, args.reps, args.device)
    print("parity ok: every lane's device words == pack_stream == the native packer")
    print(json.dumps({"metric": "device_pack", "device": str(dev), **out}))


if __name__ == "__main__":
    main()
