"""Run one cell of the benchmark of ``lac_tpu_torch`` once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port. The run loads, warms up,
measures for ``--seconds``, judges what the window produced against the
plain reference (:mod:`.reference`), and prints one JSON object as the last
line of its standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, over a window of at most ``devtrace.TRACE_SECONDS``),
``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit (also the last lines of
standard error). It fails, and prints no result, without as many CUDA
cards as the cell asks for, and when the process holds a module of
``jax``, ``jaxlib``, ``flax`` or ``lac_tpu`` once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import spec  # noqa: E402
from .record import Record, share_pct  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lac_tpu")
# exact: every stream decodes to its input, with the reference encoder's plan
LIMITS = {"files_wrong": 0, "blocks_wrong": 0, "plans_wrong": 0}
DRIVERS = {"pooled": "benchmark.pooled"}


class Context:
    """What a driver gets: the cell's configuration and mix, the seed, the
    window's length, and the means to open and close the window."""

    def __init__(self, config, mix, seed, seconds, traced, device, control=None):
        import torch

        from .probes import Probes

        from .devtrace import TRACE_SECONDS

        self.config, self.mix, self.seed, self.traced = config, mix, seed, traced
        self.seconds = min(seconds, TRACE_SECONDS) if traced else seconds
        self.device = device
        self.control = control
        self.probes = Probes().install()
        self.counters = {}
        self.notes = []
        self.host_spans = []
        self.cards = [torch.cuda.current_device()] if torch.device(device).type == "cuda" else []
        self.trace = None
        self.result = {}

    def note(self, text):
        self.notes.append(text)

    def open_window(self):
        import torch

        for d in self.cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        if self.traced and self.cards:
            from .devtrace import DeviceTrace

            self.trace = DeviceTrace(self.cards)
            self.trace.start()
            self.probes.tallying = True
        self.host0 = _host_use()
        return time.perf_counter()

    def close_window(self):
        import torch

        t1 = time.perf_counter()
        for d in self.cards:
            torch.cuda.synchronize(d)
        self.counters["host"] = {k: round(v - self.host0[k], 3) for k, v in _host_use().items()}
        if self.trace is not None:
            self.probes.tallying = False
            self.trace.stop()
        return t1

    def finish(self, window, pcm_bytes, attempted, failed, stream_bytes=0):
        """The window's figures, taken before the reference runs."""
        import torch

        self.result = {"window": window, "pcm_bytes": pcm_bytes, "attempted": attempted, "failed": failed,
                       "stream_bytes": stream_bytes,
                       "memory_peak_bytes": max((torch.cuda.max_memory_reserved(d) for d in self.cards), default=0)}


def _host_use():
    """This process's user and system CPU seconds: the host work of the
    program and of what it waits on (spinning threads read as system
    time), against which a run's rate is read."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"proc_user_s": ru.ru_utime, "proc_sys_s": ru.ru_stime}


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(bench, wl, seed, seconds, traced, device="cuda", control=None, t_start=T_START, mix=None):
    """Run cell ``wl`` once -> (result line, what else the run saw).
    ``control``, where given (:data:`.control.CONTROLS`), changes what the
    program is handed (``"inputs"``: a batch of (left, right) inputs ->
    what stands in for them) or how it is called (``"opts"``: encoder
    options); the judge always holds the streams to the true inputs and
    the default plan. ``mix`` stands in for the cell's mix file (the
    tests' small sizes)."""
    import importlib

    import torch

    cfg = spec.config(bench, wl)
    mix = spec.mix(wl["traffic"]) if mix is None else mix
    driver = importlib.import_module(DRIVERS[mix["driver"]])
    ctx = Context(cfg, mix, seed, seconds, traced, device, control)
    try:
        verdict = driver.run(ctx)
    finally:
        ctx.probes.uninstall()
    res = ctx.result
    summary = None
    if ctx.trace is not None:
        summary = ctx.trace.summary(ctx.host_spans)
    spans = {k: list(v) for k, v in ctx.probes.spans.items()}
    rec = Record(t_start=t_start, window=res["window"], pcm_bytes=res["pcm_bytes"], stream_bytes=res["stream_bytes"],
                 spans=spans, counters=dict(ctx.counters), least_s=sum(ctx.probes.least_s.values()), trace=summary)
    metrics = {}
    for m in spec.metrics(bench, wl["name"], traced):
        value = spec.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {name: {"value": verdict[name], "limit": limit} for name, limit in LIMITS.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if ctx.cards else "cpu",
           "kind": torch.cuda.get_device_name(ctx.cards[0]) if ctx.cards else "cpu",
           "count": len(ctx.cards), "memory_peak_bytes": res["memory_peak_bytes"]}
    if ctx.cards:
        dev["power_limit_w"] = _power_limit()
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"], "metrics": metrics,
              "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in summary["device_ops"]],
                               "idle_gaps": [list(x) for x in summary["idle_gaps"]]}
    result["checks"] = checks
    lo, hi = res["window"]
    batches = [(round(a - lo, 3), round(b - a, 3)) for a, b in spans.get("batch", []) if a >= lo]
    # the host spans' shares in every run, traced or not: tracing slows the host
    shares = {label: round(share_pct(spans[label], res["window"]), 3) for label in ("wave", "finish")
              if spans.get(label)}
    info = {"counters": ctx.counters, "judged": {k: verdict[k] for k in ("files_judged", "blocks_judged")},
            "span_pct": shares, "reference_s": round(verdict["seconds"], 3),
            "batches": batches, "wave_s": [round(b - a, 3) for a, b in spans.get("wave", []) if a >= lo],
            "notes": verdict["notes"] + ctx.notes, "launches": dict(ctx.probes.launches),
            "least_s": dict(ctx.probes.least_s)}
    if summary is not None:
        info["trace"] = {k: summary[k] for k in ("events", "kernel_device_s", "busy_by_card")}
    return result, info


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load()
    wl = spec.workload(bench, args.workload)

    import torch

    import lac_tpu_torch  # noqa: F401 — the system under test: a checkout without it gives no result

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        sys.stderr.write(f"benchmark: cell {wl['name']} needs {wl['chips']} CUDA card(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible\n")
        return 2
    result, info = run_cell(bench, wl, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"benchmark: the process holds modules it must not: {', '.join(found)}\n")
        return 3
    sys.stderr.write(json.dumps(info) + "\n")
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name}: {c['value']} (limit {c['limit']})\n")
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
