"""The closed-loop driver: batches of tracks handed to
``pool.encode_pooled`` one after another, as an archive or ingest job
hands them to the library (mix key ``"driver": "pooled"``)."""

import time
import traceback

from . import reference, traffic


def run(ctx):
    """Set up, warm up, measure for ``ctx.seconds`` (closing at the first
    batch boundary at or after it), then judge. Returns the run's
    :class:`.record.Record` fields through ``ctx``."""
    from lac_tpu_torch import plan_graphs, pool

    cfg, mix = ctx.config, ctx.mix
    layout, warm_frames = traffic.pooled_layout(mix, cfg)
    batches = [traffic.make_tracks(mix, cfg, frames, ctx.seed, (1, b), ctx.device) for b, frames in enumerate(layout)]
    warm = traffic.make_tracks(mix, cfg, warm_frames, ctx.seed, (2,), ctx.device)
    control = ctx.control or {}
    fed = [control["inputs"](b) for b in batches] if "inputs" in control else batches
    opts = control.get("opts", {})

    def encode(items):
        return pool.encode_pooled(items, cfg["sample_rate"], cfg["bit_depth"],
                                  stereo_mode=reference.STEREO_MODES[cfg["stereo_mode"]], device=ctx.device, **opts)

    encode(warm)  # builds, captures the graphs one batch replays, marks the process warm
    order = traffic.batch_order(ctx.seed, len(batches))

    def captures():
        return sum(cache.stats["captures"] for cache in plan_graphs.CACHES.values())

    c0 = captures()
    outputs, attempted, failed, done_bytes = [], 0, 0, 0
    t0 = ctx.open_window()
    i = 0
    while True:
        b = order[i % len(order)]
        i += 1
        attempted += len(batches[b])
        tb = time.perf_counter()
        try:
            frames = encode(fed[b])
        except Exception:  # noqa: BLE001 — a failed batch is counted and ends the window
            failed += len(batches[b])
            ctx.note(f"batch {b} failed:\n{traceback.format_exc()}")
            break
        ctx.probes.span("batch", tb, time.perf_counter())
        outputs.append((b, frames))
        done_bytes += sum(traffic.pcm_bytes(len(left), cfg) for left, _ in batches[b])
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    t1 = ctx.close_window()
    ctx.counters["plan_graphs.captures"] = captures() - c0
    ctx.counters["batches"] = len(outputs)
    ctx.host_spans = [("finish", ctx.probes.spans["finish"]), ("wave", ctx.probes.spans["wave"]),
                      ("batch preparation", ctx.probes.spans["batch"])]
    streams = [f for _, frames in outputs for f in frames]
    ctx.finish(window=(t0, t1), pcm_bytes=done_bytes, attempted=attempted, failed=failed,
               stream_bytes=sum(len(f) for f in streams if isinstance(f, (bytes, bytearray))))

    # the judge: every stream of the window's frame; the sample's blocks decoded whole and their plans
    tj = time.perf_counter()
    inputs = [track for b, _ in outputs for track in batches[b]]
    groups, k = [], 0
    for b, _ in outputs:
        groups.append(list(range(k, k + len(batches[b]))))
        k += len(batches[b])
    frames = reference.check_frames(streams, inputs, cfg)
    j = mix["judge"]
    sample = reference.draw_sample(traffic.rng(ctx.seed, 13), groups, [len(left) for left, _ in inputs], frames[0],
                                   streams, j["batches"], j["wave_blocks"], j["chunk_blocks"], j["per_stereo"])
    verdict = reference.judge(streams, inputs, cfg, sample, frames=frames)
    verdict["seconds"] = time.perf_counter() - tj
    return verdict
