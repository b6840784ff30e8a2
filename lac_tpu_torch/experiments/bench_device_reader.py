"""Static-Rice token parse on the card against the native product reader
(the port's counterpart of scripts/bench_device_reader.py).

    python -m lac_tpu_torch.experiments.bench_device_reader [--lanes 64] [--tokens 4096] [--reps 5] [--device cuda|cpu]

Parses L lanes x T static-k Rice tokens (k 2..12 per lane, from a seed)
with the native reader (``runtime.native.tokenize_static_rice``, the
decode's ``read_rice_u``), with pointer doubling in torch ops
(``device_reader.tokenize_static_rice``) and with kernel 8
(``device_reader.tokenize_static_rice_scan``). The payloads are packed
by the port's ``device_pack.pack_rice_lanes``, a few lanes held to
``encode_static_rice_np``; every output is held to the encoded values
before anything is timed (host clock, the card synchronized; best of
``--reps``). Prints the card's name and power limit and one JSON line.
Runs on the card, raises without one.
"""

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import check_device
from ..runtime import native
from .device_pack import pack_elements, rice_elements, words_capacity, zigzag
from .device_reader import encode_static_rice_np, tokenize_static_rice, tokenize_static_rice_scan

SLACK = 16  # zero bytes after the longest lane's stream


def make_lanes(rng, L, T):
    """(ks (L,) int32 in 2..12, values (L, T) int32 at a scale of 2^k)."""
    ks = rng.randint(2, 13, L).astype(np.int32)
    vals = np.stack([(rng.standard_normal(T) * (1 << int(k)) * 0.6).astype(np.int32) for k in ks])
    return ks, vals.reshape(L, T)


def long_lanes(rng, L=4, T=13000):
    """(ks, values) as make_lanes gives them, at k = 20, 22, 24, 26: rows of
    35-45 KB at T = 13000, longer than the 32 KB kernel 8 stages at once."""
    ks = np.asarray([20 + 2 * (i % 4) for i in range(L)], np.int32)
    return ks, np.stack([(rng.standard_normal(T) * (1 << int(k)) * 0.6).astype(np.int32) for k in ks])


def pack_lanes(vals, ks, device):
    """Static-k Rice payloads of ``vals`` packed on ``device``: (payload
    (L, NBY) uint8, nbits (L,) int32), the words' bytes big-endian."""
    v = torch.from_numpy(np.ascontiguousarray(vals)).to(device)
    k = torch.from_numpy(np.ascontiguousarray(ks)).to(device)[:, None].expand_as(v)
    unary, fv, fl = rice_elements(zigzag(v), k)
    W = words_capacity(int((unary + fl).sum(dim=1).max()))
    words, nbits = pack_elements(unary, fv, fl, W)
    be = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)], dim=-1).reshape(len(vals), 4 * W)
    payload = torch.zeros((len(vals), 4 * W + SLACK), dtype=torch.uint8, device=device)
    payload[:, : 4 * W] = be.to(torch.uint8)
    return payload, nbits


def check_against_spec(payload, nbits, vals, ks, lanes):
    """The packed payloads of ``lanes`` equal ``encode_static_rice_np``'s bytes."""
    for li in lanes:
        want, want_bits = encode_static_rice_np(vals[li], int(ks[li]))
        row = payload[li].cpu().numpy()
        if int(nbits[li]) != want_bits or not (np.array_equal(row[: len(want)], want) and not row[len(want):].any()):
            raise AssertionError(f"lane {li}: pack_rice_lanes payload differs from encode_static_rice_np")


def adversarial_batches(seed=8):
    """Kernel 8's hard inputs: [(label, payload (L, NBY) uint8, k (L,) int32,
    nbits (L,) int32, tokens)]. k = 0 and 15 on real content, unary runs at
    and past the 57-bit cap (q + 1 + k = 57 and 58, at several bit offsets)
    and far past it, an all-ones tail (q = 64), nbits = 0, an all-zero and a
    random payload, k = 31 and a negative k, more tokens than the streams
    hold; rows of 1, 5 and 7 bytes (NBY < 8)."""
    rng = np.random.RandomState(seed)

    def zz_inv(u):
        return (u >> 1) ^ -(u & 1)

    def cap(k, q):  # a value whose token is q + 1 + k bits
        return zz_inv((q << k) | (int(rng.randint(0, 1 << k)) if k else 0))

    lanes = []  # (payload bytes, k, nbits)
    for k, spread in ((0, 3), (15, 1 << 15)):
        p, nb = encode_static_rice_np(rng.randint(-spread, spread + 1, 30).astype(np.int32), k)
        lanes.append((p, k, nb))
    for k in (0, 15):  # at the cap, past it, at offsets 1..7 after short tokens
        vals = []
        for lead in range(1, 8):
            vals += [0] * lead + [cap(k, 56 - k), cap(k, 57 - k)]
        p, nb = encode_static_rice_np(np.asarray(vals, np.int64).astype(np.int32), k)
        lanes.append((p, k, nb))
    p, nb = encode_static_rice_np(np.asarray([5, cap(0, 200), -3, cap(0, 90)], np.int32), 0)
    lanes.append((p, 0, nb))  # unary runs of 200 and 90 bits
    p, nb = encode_static_rice_np(np.asarray([1, -2, 3], np.int32), 2)
    lanes.append((np.concatenate([p, np.full(20, 0xFF, np.uint8)]), 2, nb))  # all-ones tail: q = 64
    p, nb = encode_static_rice_np(rng.randint(-9, 10, 30).astype(np.int32), 3)
    lanes.append((p, 3, 0))  # nbits = 0: no token is valid
    lanes.append((np.zeros(24, np.uint8), 3, 150))
    lanes.append((rng.randint(0, 256, 40).astype(np.uint8), 7, 320))
    lanes.append((rng.randint(0, 256, 40).astype(np.uint8), 31, 320))
    lanes.append((rng.randint(0, 256, 40).astype(np.uint8), -1, 320))
    nby = max(len(p) for p, _, _ in lanes) + 8
    pay = np.zeros((len(lanes), nby), np.uint8)
    for i, (p, _, _) in enumerate(lanes):
        pay[i, : len(p)] = p
    batches = [("adversarial lanes", pay, np.asarray([k for _, k, _ in lanes], np.int32),
                np.asarray([nb for _, _, nb in lanes], np.int32), 48)]
    for nby in (1, 5, 7):
        short = rng.randint(0, 256, (6, nby)).astype(np.uint8)
        short[0] = 0xFF
        short[1] = 0
        batches.append((f"rows of {nby} bytes", short, np.asarray([0, 3, 15, 1, 0, 7], np.int32),
                        np.asarray([0, 5, 8 * nby, 3, 8 * nby + 9, 11], np.int32), 10))
    return batches


def sync_hostile_batches(seed=9):
    """Lanes that slow or defeat a segmented parse (kernel 8 starts a parse
    near every segment's first bit and relies on it meeting the true parse):
    the same (label, payload, k, nbits, tokens) tuples as adversarial_batches().

    Batch 1, rows zero-padded to the longest: interior zero runs (runs of the
    value 0, 1 + k zero bits a token, where parses k + 1 bits apart never
    meet) at k = 1, 3 and 15; two lanes far shorter than the longest (their
    rows end in trailing zero bytes); unary runs of 20-56 bits across
    segment bounds at k = 0 and 5; a periodic lane whose two phases never
    meet (k = 2, the bits "10" repeated: parses at 0 and 2 mod 4 both hold,
    and a prefix token of 6 bits puts the true parse at 2 mod 4); a lane of
    k = 64, above the fast path's limit. Batch 2, rows without zero bytes
    at the end (the last bit 1 and 0: from bit 8 * NBY - 1 on every token is
    the same), more tokens than they hold, nbits past the row (so the tail's
    token starts decide valid)."""
    rng = np.random.RandomState(seed)

    def real(n, k):
        return (rng.standard_normal(n) * (1 << k) * 0.6).astype(np.int32)

    def zz_inv(u):
        return (u >> 1) ^ -(u & 1)

    lanes = []  # (values, k)
    for k, zeros in ((1, 1200), (3, 600), (15, 150)):
        lanes.append((np.concatenate([real(200, k), np.zeros(zeros, np.int32), real(200, k)]), k))
    lanes += [(real(20, 4), 4), (real(30, 7), 7)]
    for k in (0, 5):
        vals = []
        for i in range(40):  # a few short tokens, then q = 20..56 - k (q + 1 + k <= 57: under the cap)
            q = 20 + (7 * i) % (37 - k)
            vals += list(real(1 + i % 5, max(k, 1))) + [zz_inv((q << k) | int(rng.randint(0, 1 << k)))]
        lanes.append((np.asarray(vals, np.int32), k))
    # zigzag(3) = 6 = q 1, rem 2: "1010"; the prefix -7 (u 13 = q 3, rem 1) is 6 bits
    lanes.append((np.asarray([-7] + [3] * 600, np.int32), 2))
    enc = [(*encode_static_rice_np(v, k), k, len(v)) for v, k in lanes]
    enc.append((rng.randint(0, 256, 200).astype(np.uint8), 1600, 64, 0))
    nby = max(len(p) for p, _, _, _ in enc) + 8
    pay = np.zeros((len(enc), nby), np.uint8)
    for i, (p, _, _, _) in enumerate(enc):
        pay[i, : len(p)] = p
    tokens = max(n for _, _, _, n in enc) + 24
    batches = [("sync-hostile lanes", pay, np.asarray([k for _, _, k, _ in enc], np.int32),
                np.asarray([nb for _, nb, _, _ in enc], np.int32), tokens)]
    ends = rng.randint(1, 256, (4, 300)).astype(np.uint8)
    ends[:, -1] = [0x01, 0x81, 0x02, 0xFE]  # last bit 1, 1, 0, 0
    batches.append(("rows whose last byte is set", ends, np.asarray([0, 3, 0, 9], np.int32),
                    8 * 300 + np.asarray([37, 300, 0, 999], np.int32), 1600))
    return batches


def run(lanes=64, tokens=4096, reps=5, device="cuda", seed=11):
    """Check and time; returns a dict of the results (seconds, tokens)."""
    dev = check_device(device)
    ks, vals = make_lanes(np.random.RandomState(seed), lanes, tokens)
    payload, nbits = pack_lanes(vals, ks, dev)
    check_against_spec(payload, nbits, vals, ks, sorted({0, lanes // 2, lanes - 1}))
    pay_h, nb_h = payload.cpu().numpy(), nbits.cpu().numpy()
    np.testing.assert_array_equal(native.tokenize_static_rice(pay_h, ks, nb_h, tokens), vals)
    k_d = torch.from_numpy(ks).to(dev)

    def jump():
        return tokenize_static_rice(payload, k_d, nbits, tokens)

    def scan():
        return tokenize_static_rice_scan(payload, k_d, nbits, tokens)

    for name, fn in (("pointer doubling", jump), ("kernel 8", scan)):
        out = fn()
        if not (np.array_equal(out[0].cpu().numpy(), vals) and bool(out[-1].all())):
            raise AssertionError(f"{name}: tokens differ from the encoded values")

    def best(fn):
        t = float("inf")
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = min(t, time.perf_counter() - t0)
        return t

    return {"lanes": lanes, "tokens_per_lane": tokens, "payload_bytes": int(payload.numel()),
            "native_s": best(lambda: native.tokenize_static_rice(pay_h, ks, nb_h, tokens)),
            "jump_s": best(jump), "scan_s": best(scan)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
    out = run(args.lanes, args.tokens, args.reps, args.device)
    print("parity ok: native == pointer doubling == kernel 8 == the encoded values")
    tokens = out["lanes"] * out["tokens_per_lane"]
    print(json.dumps({"metric": "static_rice_tokenize", "device": str(dev), **out,
                      **{f"{k[:-2]}_tokens_per_s": tokens / out[k] for k in ("native_s", "jump_s", "scan_s")}}))


if __name__ == "__main__":
    main()
