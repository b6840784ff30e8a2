#!/usr/bin/env python3
"""Smoke run of the lac_tpu_torch port on one CUDA card.

    python3 chip_smoke.py

1. device: the card's name and power limit; the host must be x86-64
   (80-bit long double for Levinson-Durbin);
2. builds the port's native runtime (g++) and its CUDA kernels from
   ``lac_tpu_torch/csrc`` (one nvcc per source, all at once);
3. holds every kernel bit-exact against its plain PyTorch version on the
   card at the planner's shapes, adversarial inputs included, and times
   both at every shape the main path launches the kernel with (CUDA
   graphs between CUDA events), beside the kernel's bound and, where one
   PyTorch call computes the same function, that call's time; checks
   that ``torch.argmin`` returns the first minimum on the card (the
   planner's tie-breaks rely on it);
4. encodes a 3-minute 44.1 kHz 16-bit stereo file and a 60 s 96 kHz
   24-bit stereo file (made from a seed) with the port's FrameEncoder on
   the card, counting kernel launches and plan batches (the timed shapes
   must account for every launch; each kernel's launches x (time -
   bound) per file is printed), and holds the bytes to the port's host
   route (the native planner, plane pipeline off); runs the port's CLI
   encode and decode on both and holds the decoded PCM to the input;
5. encodes the 16 golden signals (tests/signals.py) through the port's
   CLI on the card and holds them byte-for-byte to tests/golden/*.lac,
   and decodes every golden with the port's decoder, PCM-exact;
6. checks that neither jax nor any lac_tpu module was imported.

Every phase raises on failure (non-zero exit, no result line). The line
before the last is the kernel record, the last line the device record.
Exits non-zero without a CUDA card.
"""

import json
import os
import pathlib
import platform
import subprocess
import sys
import tempfile
import time
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lac_tpu_torch import cli, device_pipeline
from lac_tpu_torch.decoder import FrameDecoder
from lac_tpu_torch.encoder import FrameEncoder
from lac_tpu_torch.io import write_wav as write_wav_port
from lac_tpu_torch.ops import _cuda_lib
from lac_tpu_torch.ops import cuda_kernels as K
from lac_tpu_torch.ops._backend import u32_from_bits
from lac_tpu_torch.ops.stereo import estimate_stereo_mode
from lac_tpu_torch.profile_encode import gliding_stereo
from lac_tpu_torch.runtime import native
from tests.signals import cases as golden_cases

REPO = pathlib.Path(__file__).resolve().parent

BLOCK = 16384
LANES = 256  # plan batch at chunk width K = 256
ROWS = LANES * 11  # candidate rows of one plan batch
PROBE_ROWS = 12 * LANES * 11  # probe plan batch (12 probe lanes per block)

KERNELS = {  # name -> (source, the Pallas function it replaces)
    "k_cost_sums": ("lac_tpu_torch/csrc/kcost.cu", "lac_tpu/ops/pallas_kernels.py:81"),
    "split_cumsums_u32": ("lac_tpu_torch/csrc/row_scan.cu", "lac_tpu/ops/pallas_kernels.py:205"),
    "cumsum_u32": ("lac_tpu_torch/csrc/row_scan.cu", "lac_tpu/ops/pallas_kernels.py:218"),
    "prefix_max_i32": ("lac_tpu_torch/csrc/row_scan.cu", "lac_tpu/ops/pallas_kernels.py:319"),
    "suffix_min_i32": ("lac_tpu_torch/csrc/row_scan.cu", "lac_tpu/ops/pallas_kernels.py:325"),
    "k_after_stateful_fused": ("lac_tpu_torch/csrc/k_after.cu", "lac_tpu/ops/pallas_adapt.py:333"),
}

# Bounds (NVIDIA H100 SXM data sheet): 3.35 TB/s of device memory;
# 32-bit integer instructions at 132 SMs x 128 lanes x 1.98 GHz =
# 33.45 T/s, the lanes behind the sheet's 67 TFLOP/s float32 figure
# counted once per instruction (an upper limit for integer work, so the
# bound stays a lower limit on time).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# 32-bit integer instructions per input element, counted from each
# kernel's source (64-bit adds, compares and shifts count 2, a 64-bit
# multiply 3, the u64 divide by 3 about 6):
#   k_cost_sums: >>16, &0xFFFF, the hi add, 16 shifts and 16 adds;
#   split_cumsums_u32: split (2), two serial adds, two fix-up adds, the
#     shuffle scans of run totals amortised;
#   cumsum/prefix max/suffix min: one serial op, one fix-up, amortised scans;
#   k_after_stateful_fused: prefix sum of s (6), k_base (29), drift bias
#     (50), flags (9), flag prefix and micro bias (18), amortised block
#     scans (7), store (1).
OPS_PER_ELEMENT = {
    "k_cost_sums": 35,
    "split_cumsums_u32": 8,
    "cumsum_u32": 4,
    "prefix_max_i32": 4,
    "suffix_min_i32": 4,
    "k_after_stateful_fused": 120,
}
# one PyTorch call computing the same function, timed as a yardstick only
LIBRARY_CALLS = {
    "cumsum_u32": lambda x: torch.cumsum(x, -1, dtype=torch.int32),
    "prefix_max_i32": lambda x: torch.cummax(x, -1).values,
}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


# ------------------------------------------------------------ kernel inputs


def adversarial_codes(rows, n, rng):
    """(rows, n) u32 codes, one pattern per row (row % 6): uniform u32,
    all 0xFFFFFFFF, escape-range codes >= 2^31, audio-sized codes, long
    zero runs, and zeros except at the adapter's window edges."""
    u = np.zeros((rows, n), np.uint64)
    pat = np.arange(rows) % 6
    u[pat == 0] = rng.randint(0, 1 << 32, ((pat == 0).sum(), n), dtype=np.uint64)
    u[pat == 1] = 0xFFFFFFFF
    u[pat == 2] = rng.randint(1 << 31, 1 << 32, ((pat == 2).sum(), n), dtype=np.uint64)
    u[pat == 3] = rng.randint(0, 64, ((pat == 3).sum(), n))
    sparse = rng.randint(1, 1 << 20, ((pat == 4).sum(), n)) * (rng.rand((pat == 4).sum(), n) < 0.002)
    u[pat == 4] = sparse
    edges = [e for e in (95, 96, 255, 256, n - 1) if e < n]
    u[np.ix_(pat == 5, edges)] = 7
    return u.astype(np.uint32).view(np.int32)


def window_edge_codes(rows, n):
    """(rows, n) u32 codes that are non-zero only at the adapter's window
    edges (95/96, 255/256), every 256-sample warp edge (256m - 1, 256m) and
    the start of every micro window that reaches back over one
    (256m - 97, 256m - 96), so every 2048-sample tile edge of kernel 6, or
    zero only there (row % 4 == 3)."""
    pos = sorted({p for m in range(256, n, 256) for p in (m - 97, m - 96, m - 1, m)} | {95, 96, 255, 256})
    u = np.zeros((rows, n), np.uint32)
    for r in range(rows):
        if r % 4 == 3:
            u[r] = 3
            u[r, pos] = 0
        else:
            u[r, pos] = (7, 0xFFFFFFFF, 1 << 20)[r % 4]
    return u.view(np.int32)


def near_threshold_codes(rows, n, rng):
    """(rows, n) u32 codes that are zero with probability 0.75-0.84 (by
    row), so that the adapter's micro-window zero count (threshold 77 of 96)
    crosses its threshold often: a look-back one sample off shows there."""
    dens = 0.75 + 0.03 * (np.arange(rows) % 4)[:, None]
    return (rng.randint(1, 1 << 16, (rows, n)) * (rng.rand(rows, n) >= dens)).astype(np.uint32).view(np.int32)


def k_after_codes(rows, n, rng):
    """adversarial_codes with four near-threshold and four window-edge rows at the end."""
    return np.concatenate([adversarial_codes(rows - 8, n, rng), near_threshold_codes(4, n, rng),
                           window_edge_codes(4, n)])


def break_indices(codes, rng, reverse):
    """zero_breaks-style scan operands: where(z, sentinel, index) from the
    codes' zero pattern; rows of patterns 0-2 carry arbitrary int32."""
    n = codes.shape[1]
    idx = np.arange(n, dtype=np.int32)
    x = np.where(codes == 0, np.int32(n + 2 if reverse else -n - 2), idx).astype(np.int32)
    rand = np.arange(codes.shape[0]) % 6 < 3
    x[rand] = rng.randint(-(1 << 31), 1 << 31, (rand.sum(), n), dtype=np.int64).astype(np.int32)
    return x


def kernel_cases(rng, dev):
    """name -> list of (label, operand on ``dev``, timing[, call]). Every
    case is held bit-exact to the plain version; ``timing`` is None or (plan
    kind, launches per plan of that kind) for a shape at which the main path
    launches the kernel (B = 256 lanes of a full-width plan, 12 x 256 of a
    probe plan), first the shape whose time the kernel record carries.
    ``call`` is the (kernel, plain) pair of functions of the operand where
    the case is not the wrapper with its default arguments."""

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    stack = adversarial_codes(ROWS, BLOCK, rng)  # (B*11, 16384) candidate codes
    winners = stack[:LANES]  # (B, 16384) selected-candidate codes
    probes = adversarial_codes(PROBE_ROWS, 256, rng)  # (12B*11, 256) probe candidate codes
    probe_winners = probes[: 12 * LANES]
    odd = adversarial_codes(37, 1001, rng)
    stack_t, winners_t, probes_t, pw_t = up(stack), up(winners), up(probes), up(probe_winners)
    full, probe = ("full", 1), ("probe", 1)

    def with_head(head):  # head sums and row sums from one launch
        return (lambda x: K.k_cost_sums(x, head=head)), (lambda x: K.k_cost_sums_plain(x, head=head))

    def orders(max_p):  # every partition order's sums from one launch
        return (lambda x: K.k_cost_partition_sums(x, max_p)), (lambda x: K.k_cost_partition_sums_plain(x, max_p))

    # the planner's launches: the candidate stack (head and row sums), then the winners (every order)
    kcost = [("(B*11, 16384), head 256 + row", stack_t, full, with_head(256)),
             ("winners (B, 16384), orders 0..8", winners_t, full, orders(8)),
             ("probe (12B*11, 256), head = row", probes_t, probe, with_head(256)),
             ("probe winners (12B, 256), orders 0..3", pw_t, probe, orders(3)),
             # what blocks of other lengths launch, and what the planner no longer does
             ("(B*11, 16384), row only", stack_t, None),
             ("strided head view (B*11, 256 of 16384)", stack_t[:, :256], None),
             ("strided (B*11, 1024 of 16384), head 256", stack_t[:, :1024], None, with_head(256)),
             ("strided (B*11, 1000 of 16384), head 6", stack_t[:, :1000], None, with_head(6)),
             ("strided winners (B, 4096 of 16384), orders 0..7", winners_t[:, :4096], None, orders(7)),
             ("misaligned (B, 4092 of 16384), row only", winners_t[:, 1:4093], None),
             ("misaligned (B, 512 of 16384), orders 0..4", winners_t[:, 3:515], None, orders(4)),
             ("parts (2B, 8192), head 256", winners_t.reshape(-1, 8192), None, with_head(256)),
             ("parts (256B, 64)", winners_t.reshape(-1, 64), None),
             ("probe parts (96B, 32)", pw_t.reshape(-1, 32), None),
             ("parts (16B, 1024)", winners_t.reshape(-1, 1024), None),
             ("(B, 12288 of 16384), orders 0..8 (48-sample segments)", winners_t[:, :12288], None, orders(8)),
             ("odd (37, 1001)", up(odd), None), ("odd (37, 1001), head 256", up(odd), None, with_head(256)),
             ("odd (37, 1000), orders 0..3 (125-sample segments)", up(odd[:, :1000]), None, orders(3)),
             ("(37, 64), orders 0..1", up(odd[:, :64]), None, orders(1))]
    flags = (probes.view(np.uint32) >> 31) + ((probes.view(np.uint32) & 1) << 16)
    # short rows beside the probe shape: a ragged step (264), the longest short row (2048), the
    # shortest long row (2052), a row without 128-bit loads (1001)
    extra = [(f"(37, {n})", adversarial_codes(37, n, rng), None) for n in (264, 2048, 2052)]
    extra.append(("odd (37, 1001)", odd, None))
    scans = [("(B*11, 16384)", stack, full), ("(B, 16384)", winners, full),
             ("probe (12B*11, 256)", probes, probe), ("probe (12B, 256)", probe_winners, probe)] + extra
    extra_t = [(lbl, up(a), tm) for lbl, a, tm in extra]
    return {
        "k_cost_sums": kcost,
        "split_cumsums_u32": [("probe (12B*11, 256)", probes_t, probe), ("(B*11, 16384)", stack_t, None)] + extra_t,
        "cumsum_u32": [("probe flags (12B*11, 256)", up(flags.astype(np.uint32).view(np.int32)), probe),
                       ("adversarial (B*11, 16384)", stack_t, None)] + extra_t,
        "prefix_max_i32": [(lbl, up(break_indices(a, rng, False)), tm) for lbl, a, tm in scans],
        "suffix_min_i32": [(lbl, up(break_indices(a, rng, True)), tm) for lbl, a, tm in scans],
        "k_after_stateful_fused": [(f"({ROWS}, {BLOCK})", up(k_after_codes(ROWS, BLOCK, rng)), full)]
        + [(f"(37, {n}), {n // 2048} tiles", up(k_after_codes(37, n, rng)), None)
           for n in range(2048, BLOCK + 1, 2048)],
    }


def as_values(name, out):
    """Kernel output -> int64 values (u32 sums, i32 scans) for the diff."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    conv = (lambda t: t.to(torch.int64)) if name.endswith("_i32") else u32_from_bits
    return [conv(t) for t in outs]


def bound(name, x, out):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (input read once, outputs written once) over the memory rate and
    its integer instructions over the peak instruction rate."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    outs = list({o.data_ptr(): o for o in outs}.values())  # a result returned twice is written once
    nbytes = x.numel() * x.element_size() + sum(o.numel() * o.element_size() for o in outs)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = OPS_PER_ELEMENT[name] * x.numel() / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, x, iters=20):
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed between two CUDA events (no host launch gaps, so small shapes
    are timed on the card and not on the host)."""
    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(x)
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def check_kernels(rng):
    """Every case bit-exact; every path shape timed (plain, kernel, kernel,
    plain). Returns (the kernel records, name -> list of per-shape times)."""
    records, shapes = {}, {}
    for name, cases in kernel_cases(rng, torch.device("cuda")).items():
        lib = LIBRARY_CALLS.get(name)
        err = 0
        shapes[name] = []
        for label, x, timing, *call in cases:
            kern, plain = call[0] if call else (getattr(K, name), getattr(K, name + "_plain"))
            got, want = as_values(name, kern(x)), as_values(name, plain(x))
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                err = max(err, int((g - w).abs().max().item()) if g.numel() else 0)
            check(err == 0, f"{name} {label}: kernel differs from its plain version (max |diff| {err})")
            print(f"  {name:22s} {label:56s} exact")
            if timing is None:
                continue
            t = [time_ms(plain, x), time_ms(kern, x), time_ms(kern, x), time_ms(plain, x)]
            library_ms = min(time_ms(lib, x), time_ms(lib, x)) if lib else None
            bound_ms, bound_by = bound(name, x, kern(x))
            rec = {"kind": timing[0], "per_plan": timing[1], "ms": min(t[1], t[2]),
                   "plain_ms": min(t[0], t[3]), "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}
            shapes[name].append(rec)
            lib_txt = f"{library_ms:.4f} ms" if lib else "none"
            print(f"    {label} ({timing[0]} plan x{timing[1]}): kernel {t[1]:.4f} / {t[2]:.4f} ms, "
                  f"plain {t[0]:.4f} / {t[3]:.4f} ms, library {lib_txt}, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{100 * bound_ms / rec['ms']:.0f}% of bound (CUDA graph of 20 launches, CUDA events)")
        first = shapes[name][0]
        records[name] = {"max_abs_err": float(err), **{k: first[k] for k in
                                                       ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
    return records, shapes


def per_encode(shapes, plans):
    """Each kernel's launches and its time over its bound at the path
    shapes, for plan batch counts ``plans`` {"full": F, "probe": P}."""
    out = {}
    for name, recs in shapes.items():
        n = sum(plans[r["kind"]] * r["per_plan"] for r in recs)
        ms = sum(plans[r["kind"]] * r["per_plan"] * r["ms"] for r in recs)
        excess = sum(plans[r["kind"]] * r["per_plan"] * (r["ms"] - r["bound_ms"]) for r in recs)
        out[name] = (n, ms, excess)
    return out


def check_argmin_ties(rng):
    for shape, hi in (((ROWS, 17), 3), ((LANES, 11), 2), ((LANES * 256, 16), 2)):
        x = rng.randint(0, hi, shape).astype(np.int64)
        got = torch.argmin(torch.from_numpy(x).cuda(), dim=-1).cpu().numpy()
        check(np.array_equal(got, np.argmin(x, axis=-1)), f"torch.argmin on the card is not first-minimum {shape}")
    print("  torch.argmin: first minimum on ties (3 shapes)")


# ------------------------------------------------------------ audio


def write_wav(path, left, right, sample_rate, depth):
    inter = np.stack([left, right], axis=1).reshape(-1)
    if depth == 16:
        data = inter.astype("<i2").tobytes()
    else:
        data = inter.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(depth // 8)
        w.setframerate(sample_rate)
        w.writeframes(data)


def read_wav(path):
    with wave.open(path, "rb") as w:
        ch, width, frames = w.getnchannels(), w.getsampwidth(), w.getnframes()
        data = w.readframes(frames)
    if width == 2:
        x = np.frombuffer(data, "<i2").astype(np.int32)
    else:
        b = np.frombuffer(data, np.uint8).reshape(-1, 3).astype(np.int32)
        x = ((b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)) ^ 0x800000) - 0x800000
    return x.reshape(-1, ch)


FILES = (
    ("3 min 44.1 kHz 16-bit stereo", 44100, 16, 7_938_000, 1),
    ("60 s 96 kHz 24-bit stereo", 96000, 24, 5_760_000, 2),
)


MODE_FLAG = {0: "--stereo-mode=lr", 1: "--stereo-mode=ms", 2: None}  # as tests/make_goldens.py


def check_goldens(tmp):
    """The golden signals through the port's CLI on the card, byte-for-byte
    against tests/golden/*.lac; every golden decoded by the port, PCM-exact."""
    signals = golden_cases()
    for name, (left, right, sr, depth, smode) in sorted(signals.items()):
        ch = 2 if len(right) else 1
        wav, lac = os.path.join(tmp, f"{name}.wav"), os.path.join(tmp, f"{name}.lac")
        check(write_wav_port(wav, left, right, ch, sr, depth), f"golden {name}: WAV write failed")
        flag = MODE_FLAG[smode if ch == 2 else 0]
        check(cli.main(["encode", wav, lac] + ([flag] if flag else [])) == 0, f"golden {name}: CLI encode failed")
        want = (REPO / "tests" / "golden" / f"{name}.lac").read_bytes()
        with open(lac, "rb") as f:
            check(f.read() == want, f"golden {name}: port bytes differ from tests/golden/{name}.lac")
        dl, dr, _ = FrameDecoder().decode(want)
        check(np.array_equal(dl, left) and np.array_equal(dr, right), f"golden {name}: decoded PCM differs")
    print(f"goldens: {len(signals)} signals encode byte-identical to tests/golden/*.lac through the port's CLI "
          f"on the card; all decode PCM-exact")


def count_plan_batches():
    """Wrap the plane pipeline's planner: plan batches counted by row length."""
    calls = {}
    plan = device_pipeline.plan_group

    def counted(pcm, *args):
        calls[pcm.shape[1]] = calls.get(pcm.shape[1], 0) + 1
        return plan(pcm, *args)

    device_pipeline.plan_group = counted
    return calls


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: this smoke run needs a CUDA card")

    # 1. device and host
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    x87 = np.finfo(np.longdouble).machep == -63
    print(f"host: machine={platform.machine()} x87_long_double={x87} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    check(platform.machine() == "x86_64" and x87, "the host LD needs x86-64's 80-bit long double")

    # 2. build: the native runtime (g++) beside the kernels (one nvcc per source)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(native.get_native), ex.submit(_cuda_lib.load)]:
            f.result()
    info = _cuda_lib.build_info
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc {info['seconds'] or 0:.1f} s) -> {info['path']}")
    kernel = None
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.strip()}")

    # 3. kernels against their plain versions
    rng = np.random.RandomState(20261016)
    print("kernels vs plain versions (bit-exact):")
    records, shapes = check_kernels(rng)
    check_argmin_ties(rng)

    # 4. real-size encodes through the port's main path, held to the port's host route
    audio = [(label, sr, depth, gliding_stereo(frames, sr, depth, seed))
             for label, sr, depth, frames, seed in FILES]
    refs = []
    for label, sr, depth, (left, right) in audio:
        nfull = len(left) // BLOCK
        lm = torch.from_numpy(left[: nfull * BLOCK].reshape(nfull, BLOCK)).cuda()
        rm = torch.from_numpy(right[: nfull * BLOCK].reshape(nfull, BLOCK)).cuda()
        _, un = estimate_stereo_mode(lm, rm, torch.ones_like(lm, dtype=torch.bool))
        n_un = int(un.sum())
        check(0 < n_un < nfull, f"{label}: want certain and uncertain blocks, got {n_un}/{nfull} uncertain")
        t0 = time.perf_counter()
        refs.append(FrameEncoder(12, 2, sr, depth, device="cuda").encode_frame(left, right))
        print(f"{label}: {len(left)} frames, {nfull} full blocks ({n_un} uncertain); "
              f"host route (native planner) {time.perf_counter() - t0:.2f} s, {len(refs[-1])} bytes")

    batches = count_plan_batches()
    K.reset_launches()
    per_file = []
    plans_per_file = []
    for (label, sr, depth, (left, right)), ref in zip(audio, refs):
        before, plans_before = dict(K.launches), dict(batches)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = FrameEncoder(12, 2, sr, depth, device="cuda").encode(left, right)
        torch.cuda.synchronize()
        per_file.append((time.perf_counter() - t0, {k: K.launches[k] - before[k] for k in before},
                         torch.cuda.max_memory_allocated()))
        plans_per_file.append({kind: batches.get(width, 0) - plans_before.get(width, 0)
                               for kind, width in (("full", BLOCK), ("probe", 256))})
        check(got == ref, f"{label}: port bytes differ from the port's host route")
    launches = dict(K.launches)
    full, probe = batches.get(BLOCK, 0), batches.get(256, 0)
    print(f"main path: {full} full-width and {probe} probe plan batches; launches {launches}")
    check(all(v > 0 for v in launches.values()), f"a kernel of the path never launched: {launches}")
    check(launches["k_after_stateful_fused"] == full, "kernel 6 must run once on every full-width plan batch")
    check(launches["split_cumsums_u32"] == launches["cumsum_u32"] == probe,
          "kernels 2 and 3 must run only on probe plan batches")
    # the timed shapes are every shape the path launches: they account for every launch
    for (label, *_), (_, counts, _), plans in zip(FILES, per_file, plans_per_file):
        model = per_encode(shapes, plans)
        check(all(model[k][0] == counts[k] for k in counts),
              f"{label}: launches {counts} differ from the timed shapes' {({k: v[0] for k, v in model.items()})}")
        print(f"{label}: {plans['full']} full-width and {plans['probe']} probe plans; per kernel, launches, "
              f"time at the timed shapes and launches x (time - bound), largest first:")
        for name, (n, ms, excess) in sorted(model.items(), key=lambda kv: -kv[1][2]):
            print(f"  {name:22s} {n:4d} launches, {ms:.4f} ms, {excess:.4f} ms over the bound")

    with tempfile.TemporaryDirectory() as tmp:
        for (label, sr, depth, (left, right)), ref, (first_s, counts, peak) in zip(audio, refs, per_file):
            t0 = time.perf_counter()
            again = FrameEncoder(12, 2, sr, depth, device="cuda").encode(left, right)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            check(again == ref, f"{label}: second port encode differs")
            wav, lac, back = (os.path.join(tmp, f) for f in ("in.wav", "out.lac", "back.wav"))
            write_wav(wav, left, right, sr, depth)
            check(cli.main(["encode", wav, lac]) == 0, f"{label}: CLI encode failed")
            with open(lac, "rb") as f:
                check(f.read() == ref, f"{label}: CLI bytes differ from the port's host route")
            check(cli.main(["decode", lac, back]) == 0, f"{label}: CLI decode failed")
            pcm = read_wav(back)
            check(np.array_equal(pcm[:, 0], left) and np.array_equal(pcm[:, 1], right),
                  f"{label}: decoded PCM differs from the input")
            print(f"{label}: port bytes == host route; decode PCM-exact; "
                  f"encode {first_s:.3f} s first, {warm_s:.3f} s second = {len(left) / warm_s:,.0f} frames/s; "
                  f"peak device memory {peak / 2**30:.2f} GiB; launches {counts}")

        # 5. the goldens (all under 8 full blocks: the host route against the reference binary's bytes)
        check_goldens(tmp)

    # 6. the port stands alone
    check("jax" not in sys.modules, "jax was imported")
    ref_mods = sorted(m for m in sys.modules if m == "lac_tpu" or m.startswith("lac_tpu."))
    check(not ref_mods, f"lac_tpu modules were imported: {ref_mods}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": launches[name], **records[name]} for name in KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
