"""Profile warm encodes of the 3-minute 44.1 kHz 16-bit stereo file on the card.

    python -m lac_tpu_torch.profile_encode [--runs N] [--mesh N] [--file 3min|60s]
    python -m lac_tpu_torch.profile_encode --sections [--runs N]

The file is the music-like corpus that chip_smoke.py encodes
(:func:`gliding_stereo`, from a seed; ``--file 60s``: its 60 s 96 kHz
24-bit stereo file instead). After one cold encode, it
prints, beside the card's name and power limit:

* the first (cold) encode's wall and the plan graphs it captured
  (:mod:`.plan_graphs`: captures, capture seconds), then the warm encode
  wall (host clock to ``torch.cuda.synchronize()``), median and range
  over ``N`` runs;
* for the full-width (16384) and probe (256) plan batches of one encode:
  the calls and the host time spent issuing them in all and per call (a
  plan returns before the device finishes), the graph replays and
  captures of the profiled encode, and, where the profiler sees a call's
  range (only on the thread that started it; the plane pipeline plans on
  a dispatch thread of its own), the torch operators each call issues
  with the kernel and graph launches among them (``cudaLaunchKernel``
  and ``cudaGraphLaunch`` calls);
* for each chunk's analyze (``device_pipeline.analyzed``, a replay of
  the chunk's analyze graph; ``analyze``, eager, in an older checkout):
  its blocks, the host time spent issuing it and its device time (CUDA
  events around the call on the dispatch thread's stream), each call
  under a ``record_function("analyze")`` range;
* peak device memory over one warm encode, allocated and reserved (the
  graphs' pool is reserved, and only in part allocated);
* device busy: the union of device-activity intervals over the
  profiled encode's wall (``torch.profiler`` with CUDA activity), and
  device time and launch count of each of the planner's kernels, by the name
  of its device function, and of everything else;
* the plane uploads of one more encode (:class:`PlaneUploads`): bytes
  and copy time per chunk (the planes cross raw: the port has no packed
  transport).

With ``--mesh N`` the encode spreads its chunks over a mesh of N
entries (:mod:`.parallel.mesh`): cards 0..N-1 when that many are
visible, else N stand-ins that take the visible cards in turn (two on
one card share it). Device busy, device time and the port's kernel
launches are then also printed per card.

With ``--sections`` it profiles the planner alone instead: one eager
``encoder.plan_group`` at the plane pipeline's two plan shapes, (256,
16384) and (3072, 256) (gliding-sine and filtered-noise lanes, silent and
sparse lanes and 24-bit extremes, their candidates from the host
Levinson-Durbin), with the planner's section ranges on
(:func:`.utils.debug.section`), and prints for each section (candidate
residuals, whole-block scoring, selection, mode choice, partition sweep,
meta) its device time, its torch operators and its kernel launches,
median over ``N`` profiled calls; then the device time of one replay of
the shape's plan graph (CUDA events, median of ``N``).

The script runs on a checkout whose plane pipeline plans or analyzes
eagerly too: copied into an older checkout's package, it times that
checkout's ``plan_group`` and ``analyze`` calls the same way, for turns
against a parent commit. The wrappers exist only in this script: an
encode outside it pays nothing for them.
"""

import argparse
import statistics
import subprocess
import time

import numpy as np
import torch

from . import device_pipeline
from . import encoder as encoder_mod
from .encoder import FrameEncoder, lpc_candidates_from_lags, plan_inputs_to_torch
from .ops import cuda_kernels
from .parallel import make_mesh
from .runtime import native
from .utils import debug


def gliding_stereo(frames, sample_rate, depth, seed):
    """Music-like gliding sines under a slow envelope, made from ``seed``
    (certain-LR, certain-MS and uncertain stereo blocks all occur)."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames, dtype=np.float64) / sample_rate
    sig = np.zeros(frames)
    for f0, f1, amp in ((220, 440, 0.3), (880, 860, 0.2), (3520, 3300, 0.08)):
        sig += amp * np.sin(2 * np.pi * np.cumsum(np.linspace(f0, f1, frames)) / sample_rate)
    noise = rng.standard_normal(frames)
    for _ in range(2):
        noise = 0.5 * noise + 0.5 * np.concatenate([[0.0], noise[:-1]])
    sig += 0.05 * noise
    env = 0.5 * (1 + np.sin(2 * np.pi * 0.37 * t))
    scale, lim = (1, 1 << 15) if depth == 16 else (256, 1 << 23)
    left = np.clip(sig * env * 28000 * scale, -lim, lim - 1).astype(np.int32)
    right = np.clip(np.roll(sig, 7) * env * 26500 * scale, -lim, lim - 1).astype(np.int32)
    return left, right


def filtered_noise_stereo(frames, sample_rate, depth, seed):
    """Low-passed noise and no tone, made from ``seed``: the noise part of
    the recipe above (white noise through the same moving blend, six
    passes) at music level under the same envelope. The right channel is
    the left delayed by three samples plus noise of its own whose level
    swells and fades, so correlated and independent stretches both occur."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames, dtype=np.float64) / sample_rate

    def lowpassed(x, passes):
        for _ in range(passes):
            x = 0.5 * x + 0.5 * np.concatenate([[0.0], x[:-1]])
        return x

    base = lowpassed(rng.standard_normal(frames), 6)
    own = lowpassed(rng.standard_normal(frames), 2) * 0.5 * (1 + np.sin(2 * np.pi * 0.11 * t))
    env = 0.25 + 0.75 * 0.5 * (1 + np.sin(2 * np.pi * 0.37 * t))
    scale, lim = (1, 1 << 15) if depth == 16 else (256, 1 << 23)
    left = np.clip(base * env * 24000 * scale, -lim, lim - 1).astype(np.int32)
    right = np.clip((0.9 * np.roll(base, 3) + 0.6 * own) * env * 24000 * scale, -lim, lim - 1).astype(np.int32)
    return left, right


# chip_smoke.py's two files: frames, sample rate, bit depth, seed
FILES = {"3min": (7_938_000, 44100, 16, 1), "60s": (5_760_000, 96000, 24, 2)}

# the planner's kernels by the names of their device functions (csrc/*.cu; row_scan
# is one template, told apart by its op type; SplitAddU32 before AddU32)
_KERNEL_MARKS = (
    ("k_cost_sums", "k_cost_"),
    ("split_cumsums_u32", "SplitAddU32"),
    ("cumsum_u32", "AddU32"),
    ("prefix_max_i32", "MaxI32"),
    ("suffix_min_i32", "MinI32"),
    ("k_after_stateful_fused", "k_after_kernel"),
    ("mode_cost_sums", "mode_cost_rows"),
    ("partition_cost_sums", "partition_cost_"),  # partition_cost_chunks (power-of-two rows) or _rows
)
KERNEL_NAMES = tuple(name for name, _ in _KERNEL_MARKS)


def kernel_of(device_name):
    """The port's kernel that a device function belongs to, else "other"."""
    return next((name for name, mark in _KERNEL_MARKS if mark in device_name), "other")


def _union_us(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


class PlaneUploads:
    """The plane uploads of a stretch of the run (``device_pipeline.upload``
    wrapped on entry, restored on exit): the bytes and time of each upload
    of (kc, 16384) plane rows, the card synchronized before and after it, so
    the time is the pinned copy alone. While it is on, uploads no longer
    overlap other chunks' device work: time no wall with it."""

    def __enter__(self):
        self.uploads = []
        self.real = real = device_pipeline.upload

        def timed(a, device):
            if getattr(a, "ndim", 0) != 2 or a.shape[1] != device_pipeline.N:
                return real(a, device)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = real(a, device)
            torch.cuda.synchronize(device)
            self.uploads.append((a.shape[0], a.nbytes, time.perf_counter() - t0))
            return out

        device_pipeline.upload = timed
        return self

    def __exit__(self, *exc):
        device_pipeline.upload = self.real

    def text(self, planes):
        """Per chunk of ``planes`` uploads: rows, bytes and milliseconds."""
        u = self.uploads
        chunks = [(u[i][0], sum(b for _, b, _ in u[i : i + planes]), sum(t for *_, t in u[i : i + planes]))
                  for i in range(0, len(u), planes)]
        nbytes, secs = sum(c[1] for c in chunks), sum(c[2] for c in chunks)
        return (f"{len(chunks)} chunks, {nbytes:,} bytes in {secs * 1e3:.2f} ms ({nbytes / secs / 1e9:.2f} GB/s); "
                f"per chunk (blocks, bytes, ms): "
                + "; ".join(f"{rows} {b:,} {t * 1e3:.3f}" for rows, b, t in chunks))


# the planner's sections (encoder.plan_group's ``debug.section`` ranges), in order
SECTIONS = ("residuals", "scoring", "selection", "mode", "sweep", "meta")


def plan_batch(rows, n, seed):
    """``rows`` lanes of ``n`` samples on the card with their candidates from
    the host Levinson-Durbin: gliding-sine and filtered-noise lanes, silent
    lanes, sparse bursts and 24-bit extremes."""
    rng = np.random.RandomState(seed)
    frames = rows * n // 2 + n
    planes = [np.concatenate(fn(frames, 44100, 16, seed))[: rows * n].reshape(rows, n)
              for fn in (gliding_stereo, filtered_noise_stereo)]
    pcm = np.where((np.arange(rows) % 3 == 2)[:, None], planes[1], planes[0]).astype(np.int32)
    pcm[5::8] = 0
    pcm[6::8] = np.where(rng.rand(len(pcm[6::8]), n) < 0.02, rng.randint(-300, 300, (len(pcm[6::8]), n)), 0)
    pcm[7::16] = np.where(np.arange(n) % 2, (1 << 23) - 1, -(1 << 23))
    coeffs, _, lvalid, _ = lpc_candidates_from_lags(native.autocorr(pcm, 12), n)
    dev = torch.device("cuda", torch.cuda.current_device())
    return (torch.from_numpy(pcm).to(dev), *plan_inputs_to_torch(coeffs, lvalid, dev))


def _device_us(ev):
    """Device time of the kernels an event's operators launched (us)."""
    return ev.device_time_total if hasattr(ev, "device_time_total") else ev.cuda_time_total


def _top_ops(ev):
    """The torch operators called directly under a range (not those that an
    operator calls), through nested ranges."""
    return sum(1 if c.name.startswith("aten::") else _top_ops(c) for c in ev.cpu_children)


def _count(ev, name):
    return sum(_count(c, name) for c in ev.cpu_children) + ev.name.startswith(name)


def profile_sections(runs):
    """Per section of one eager plan at the pipeline's two plan shapes:
    device ms, operators and launches (median over ``runs`` profiled
    calls), and one replay's device ms."""
    cpu = torch.autograd.DeviceType.CPU
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        from . import plan_graphs
    except ImportError:
        plan_graphs = None
    for rows, n, seed in ((256, 16384, 21), (3072, 256, 22)):
        pcm, ct, vt = plan_batch(rows, n, seed)

        def plan():
            return encoder_mod.plan_group(pcm, ct, vt, n, True, True)

        plan()
        torch.cuda.synchronize()
        got = {name: [] for name in (*SECTIONS, "plan")}
        debug.sections_on()
        try:
            for _ in range(runs):
                with torch.profiler.profile(activities=acts) as prof:
                    with torch.profiler.record_function("plan"):
                        plan()
                    torch.cuda.synchronize()
                events = [e for e in prof.events() if e.device_type == cpu]
                for name in got:
                    ev = next(e for e in events if e.name == (name if name == "plan" else f"plan_group.{name}"))
                    got[name].append((_device_us(ev) / 1e3, _top_ops(ev), _count(ev, "cudaLaunchKernel")))
        finally:
            debug.sections_on(False)
        total = statistics.median(d for d, _, _ in got["plan"])
        print(f"plan_group sections, eager ({rows}, {n}), zero runs and partitioning on, median of {runs} "
              f"profiled calls: device {total:.3f} ms, {got['plan'][0][1]} operators, {got['plan'][0][2]} launches")
        for name in SECTIONS:
            d = statistics.median(x for x, _, _ in got[name])
            print(f"  {name:10s} device {d:8.3f} ms ({100 * d / max(total, 1e-9):5.1f}%), "
                  f"{got[name][0][1]:5d} operators, {got[name][0][2]:5d} launches")
        if plan_graphs is None:
            continue
        times = []
        for _ in range(runs + 1):
            torch.cuda.synchronize()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            plan_graphs.planned(pcm, ct, vt, n, True, True, rows=rows)
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop))
        print(f"  one replay of its plan graph: device {statistics.median(times[1:]):.3f} ms (CUDA events, median "
              f"of {runs} after the capture)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--mesh", type=int, default=0, help="mesh entries (0: one card, no mesh)")
    ap.add_argument("--file", choices=sorted(FILES), default="3min")
    ap.add_argument("--sections", action="store_true", help="profile the planner's sections alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_encode: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.sections:
        profile_sections(args.runs)
        return
    device_pipeline.mark_warm()  # the card's path, not the cold route's host route
    frames, rate, depth, seed = FILES[args.file]
    left, right = gliding_stereo(frames, rate, depth, seed)
    cards = torch.cuda.device_count()
    mesh = make_mesh([f"cuda:{i % cards}" for i in range(args.mesh)]) if args.mesh else None
    devices = sorted({d.index for d in mesh}) if mesh else [torch.cuda.current_device()]

    def synchronize():
        for i in devices:
            torch.cuda.synchronize(i)

    def encode():
        synchronize()
        t0 = time.perf_counter()
        FrameEncoder(12, 2, rate, depth, device="cuda", mesh=mesh).encode(left, right)
        synchronize()
        return time.perf_counter() - t0

    try:
        from . import plan_graphs
    except ImportError:  # an older checkout: every plan eager
        plan_graphs = None
    cold = encode()  # kernel build, CUDA contexts, plan graphs
    where = f"a mesh of {len(mesh)} on cards {devices}" if mesh else "one card"
    graphs = (f"{plan_graphs.stats['captures']} plan graphs captured in {plan_graphs.stats['capture_s']:.2f} s"
              if plan_graphs else "no plan graphs (eager plans)")
    print(f"cold encode, {where}: {cold * 1e3:.1f} ms (kernel build, CUDA context); {graphs}")
    walls = [encode() for _ in range(args.runs)]
    for i in devices:
        torch.cuda.reset_peak_memory_stats(i)
    encode()
    print("peak device memory over a warm encode: " + "; ".join(
        f"card {i} {torch.cuda.max_memory_allocated(i) / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_reserved(i) / 2**30:.2f} GiB reserved" for i in devices))
    print(f"warm encode, {args.file} file ({rate} Hz, {depth}-bit stereo), {where}: "
          f"median {statistics.median(walls) * 1e3:.1f} ms ({min(walls) * 1e3:.1f}-{max(walls) * 1e3:.1f}, "
          f"{args.runs} runs)")

    # the plan batches timed on the host over one encode (a plan returns before the card finishes it), then
    # one encode profiled with each plan batch marked
    attr = "planned" if plan_graphs else "plan_group"
    plan = getattr(device_pipeline, attr)
    host_s = {}

    def timed(pcm, *rest, **kwargs):
        n = pcm.shape[1]
        with torch.profiler.record_function(f"plan_group[{n}]"):
            t0 = time.perf_counter()
            out = plan(pcm, *rest, **kwargs)
            host_s.setdefault(n, []).append(time.perf_counter() - t0)
        return out

    an_attr = "analyzed" if hasattr(device_pipeline, "analyzed") else "analyze"
    analyze = getattr(device_pipeline, an_attr)
    chunks = []

    def timed_analyze(lmat, *rest, **kwargs):
        with torch.profiler.record_function("analyze"):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = analyze(lmat, *rest, **kwargs)
            host = time.perf_counter() - t0
            stop.record()
        chunks.append((lmat.shape[0], host, start, stop))
        return out

    setattr(device_pipeline, attr, timed)
    setattr(device_pipeline, an_attr, timed_analyze)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        encode()
        dispatch = {n: list(t) for n, t in host_s.items()}
        per_chunk = [(kc, host * 1e3, start.elapsed_time(stop)) for kc, host, start, stop in chunks]
        stats0 = dict(plan_graphs.stats) if plan_graphs else None
        cuda_kernels.reset_launches()
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("encode"):
                wall = encode()
    finally:
        setattr(device_pipeline, attr, plan)
        setattr(device_pipeline, an_attr, analyze)
    if plan_graphs:
        print(f"plan graphs in the profiled encode: {plan_graphs.stats['replays'] - stats0['replays']} replays, "
              f"{plan_graphs.stats['captures'] - stats0['captures']} captures")
    # with CUDA activity each record_function range also appears on the
    # device timeline as an annotation: keep the host ranges, and count
    # only kernels and copies as device activity
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges_of = {e.name for e in events if e.name in ("encode", "analyze") or e.name.startswith("plan_group[")}

    def launches(ev, name):
        return sum(launches(c, name) for c in ev.cpu_children) + ev.name.startswith(name)

    for n, label in ((16384, "full-width"), (256, "probe")):
        if n not in dispatch:
            continue
        # the profiler sees these ranges only where the plans run on the thread that started it
        ranges = [e for e in events if e.name == f"plan_group[{n}]" and e.device_type == cpu]
        ops = (f"; per call {statistics.mean(len(e.cpu_children) for e in ranges):.0f} torch operators, "
               f"{statistics.mean(launches(e, 'cudaLaunchKernel') for e in ranges):.0f} kernel launches, "
               f"{statistics.mean(launches(e, 'cudaGraphLaunch') for e in ranges):.0f} graph launches"
               if ranges else "")
        print(f"plan_group {label} (n={n}): {len(dispatch[n])} calls, host dispatch {sum(dispatch[n]) * 1e3:.1f} ms "
              f"in all, {statistics.mean(dispatch[n]) * 1e3:.2f} ms per call (an encode without the profiler){ops}")
    how = "a replay of its graph" if an_attr == "analyzed" else "eager"
    print(f"analyze ({how}), {len(per_chunk)} chunks (an encode without the profiler): host dispatch "
          f"{sum(h for _, h, _ in per_chunk):.2f} ms in all, device {sum(d for *_, d in per_chunk):.3f} ms in all; "
          f"per chunk (blocks, host ms, device ms): "
          + "; ".join(f"{kc} {h:.3f} {d:.3f}" for kc, h, d in per_chunk))
    enc_range = next(e for e in events if e.name == "encode" and e.device_type == cpu)
    lo, hi = enc_range.time_range.start, enc_range.time_range.end
    dev = [(max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in events
           if e.device_type == cuda and e.name not in ranges_of and e.time_range.end > lo and e.time_range.start < hi]
    busy = _union_us(dev) / 1e3
    device_ms, count = dict.fromkeys(KERNEL_NAMES + ("other",), 0.0), dict.fromkeys(KERNEL_NAMES + ("other",), 0)
    for e in events:
        if e.device_type == cuda and e.name not in ranges_of:
            key = kernel_of(e.name)
            device_ms[key] += (e.time_range.end - e.time_range.start) / 1e3
            count[key] += 1
    for key in KERNEL_NAMES:
        print(f"device time {key}: {device_ms[key]:.4f} ms in {count[key]} launches "
              f"({device_ms[key] / max(count[key], 1):.4f} ms each)")
    print(f"device time, everything else: {device_ms['other']:.1f} ms in {count['other']} launches")
    print(f"device busy over the profiled encode: {busy:.1f} / {(hi - lo) / 1e3:.1f} ms = "
          f"{100 * busy / ((hi - lo) / 1e3):.1f}% ({len(dev)} device events; host wall {wall * 1e3:.1f} ms)")
    span_ms = (hi - lo) / 1e3
    for i in devices:
        on = [e for e in events if e.device_type == cuda and e.name not in ranges_of and e.device_index == i]
        card_busy = _union_us([(max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in on
                               if e.time_range.end > lo and e.time_range.start < hi]) / 1e3
        card_ms = sum(e.time_range.end - e.time_range.start for e in on) / 1e3
        print(f"card {i}: busy {card_busy:.1f} / {span_ms:.1f} ms = {100 * card_busy / span_ms:.1f}%, "
              f"device time {card_ms:.1f} ms in {len(on)} device events, "
              f"launches of the port's kernels {cuda_kernels.card_launches.get(i, {})}")
    with PlaneUploads() as log:
        encode()
    print(f"plane uploads of one encode (raw int16, L and R planes a chunk, pinned copies, the card "
          f"synchronized around each): {log.text(2)}")


if __name__ == "__main__":
    main()
