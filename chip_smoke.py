#!/usr/bin/env python3
"""Smoke run of the lac_tpu_torch port on one CUDA card, and of its mesh
on every card.

    python3 chip_smoke.py           # phases 1-15; one card is enough
    python3 chip_smoke.py --mesh    # phases 1-3 and 12 alone, on every visible card
    python3 chip_smoke.py --phase14 # phases 1-3 and 14 alone
    python3 chip_smoke.py --phase15 # phases 1-3 and 15 alone

1. device: the card's name and power limit; the host must be x86-64
   (80-bit long double for Levinson-Durbin);
2. builds the port's native runtime (g++) and its CUDA kernels from
   ``lac_tpu_torch/csrc`` (one nvcc per source, all at once);
3. holds every kernel bit-exact against its plain PyTorch version on the
   card at the planner's shapes, adversarial inputs included, and times
   both at every shape the main path launches the kernel with (CUDA
   graphs between CUDA events), beside the kernel's bound and, where one
   PyTorch call computes the same function, that call's time (kernels 9
   and 10, the planner's mode costs, on the candidate stacks' and the
   winners' operands with k = 31 rows, codes at the escape threshold and
   zero runs of 3-5 across part edges); checks
   that ``torch.argmin`` returns the first minimum on the card (the
   planner's tie-breaks rely on it);
4. runs a service's warm-up (``serve.warm_process``), which captures the
   plan, analyze and lag graphs (:mod:`lac_tpu_torch.plan_graphs`) that
   an encode of up to 484 full blocks replays; then encodes a 3-minute
   44.1 kHz 16-bit stereo file and a 60 s 96 kHz 24-bit stereo file (made
   from a seed) with the port's FrameEncoder on the card, counting kernel
   launches, plan batches and graph replays (every plan and every chunk's
   analyze a replay, no capture after the warm-up; the timed shapes must
   account for every launch, replays included, here and in phases 6, 7,
   10, 12 and 13, where each capture adds one eager warm-up plan and is
   the only eager ``plan_group`` call on the card besides the capture
   itself, every analyze and group-route lag batch on the card is a
   replay, and the only eager ``analyze`` and ``autocorrelation`` calls on
   the card are a capture's warm-up and the capture; each kernel's launches x
   (time - bound) per file is printed), and holds the bytes to the port's host
   route (the native planner, plane pipeline off); runs the port's CLI
   encode and decode on both and holds the decoded PCM to the input;
   then a mono, a forced-ms, a forced-lr, a filtered-noise and a 30 s
   (chunk width 64) file the same way;
5. encodes the 16 golden signals (tests/signals.py) through the port's
   CLI on the card and holds them byte-for-byte to tests/golden/*.lac,
   and decodes every golden with the port's decoder, PCM-exact;
6. the many-file path at real size: 84 stereo 44.1 kHz 16-bit clips
   (5-35 s and a few shorter; more than ``pool._MAX_WAVE_BLOCKS`` full
   blocks, so two waves) through ``pool.encode_pooled``, file by file
   through ``FrameEncoder.encode`` and through
   ``batch.encode_batch(max_workers=4)``: every frame equal to the port's
   host route and PCM-exact on decode; launches and plan batches of the
   pooled run accounted for by the timed shapes; the threaded run's
   launch counts equal to the file-by-file run's; warm wall, frames/s
   and peak device memory of each; a mono batch, a 96 kHz 24-bit batch
   and a wave of under 8 blocks; a fresh process whose first call is a
   threaded ``encode_batch`` that builds both libraries (with
   ``LAC_TPU_COLD_BLOCKS=0``: its clips would take the host route);
7. the long-file path: a 2100-block WAV through the CLI's streaming route
   (in this process for the launch counts, then ``python -m
   lac_tpu_torch.cli encode`` in a fresh process), bytes equal to the
   in-memory ``FrameEncoder.encode``, CLI decode PCM-exact; wall, frames/s
   and the child's peak RSS beside the in-memory route
   (``LAC_TPU_STREAM_BLOCKS=0``);
8. the cold CLI: a golden-size WAV through ``python -m lac_tpu_torch.cli
   encode`` in a fresh process starts no CUDA context (wall and peak RSS
   beside the same call with the context started first), and neither does
   an input of 8 full blocks (the cold route: at most
   ``LAC_TPU_COLD_BLOCKS`` blocks, ``encoder.COLD_BLOCKS`` by default,
   stay on the host in a process that has not used the card); the
   8-block input with ``LAC_TPU_COLD_BLOCKS=0`` and an input of one block
   more than the default start one;
9. checks that neither jax nor any lac_tpu module was imported (at the end);
10. the service (``serve.py``) on the card: phase 6's clips written as WAVs
    and encoded through ``serve.serve`` in this process (every plan graph
    dropped first, so that the first turn captures them inside the
    service while its other threads run, and the second replays), pooled
    (``--workers=4``), ``--workers=4 --no-pool`` and ``--workers=1``, two
    turns each (every id answered once, every output equal to the host
    route, decodes through the service PCM-exact, launches accounted for,
    no wave failed, waves and their walls printed beside phase 6's), and
    as a diagnostic pooled with each file's finish held until no wave
    runs (does host work beside a wave slow its dispatch?); a
    mixed batch (mono, 96 kHz 24-bit, forced lr, ``--debug-threads``, a
    clip without a full block and phase 7's WAV, which streams); fresh
    ``python -m lac_tpu_torch.serve --workers=4`` processes with and
    without ``--warm`` (time to the warm-up's and the wait's answers, the
    first job's ms, peak RSS) and one with nothing built, so g++ and nvcc
    run inside the service while every stdout line stays JSON; the
    watchdog on a real wave in a fresh process (a deadline of a tenth of
    the longest wave: released jobs' bytes, the rest answered with the
    sick-card error and no output, decode and ping still served, exit 0);
11. decode on the card (``FrameDecoder(backend="device")``): kernel 7, the
    FIR/LPC restore, bit-exact against its plain version at the path's
    shapes (the FIR/LPC lanes of the noise files below, timed beside its
    bound, its chain floor measured with every lane at order 1 and the
    floor estimated from the source) and on adversarial lanes (every LPC
    order 1..32 so that every template runs, FIR lanes, ragged valid
    lengths, lanes that leave int32, 24-bit residuals) and tile-edge lanes
    (events at the kernel's tile edges, shift 40, rows whose length is not
    a multiple of 4); phase 4's seven
    files and a 3-minute file of filtered noise through the device
    backend, PCM-equal to the input and to the native decode (launches
    per decode, warm walls of both backends, where a decode's time goes,
    peak device memory); phase 6's clips through the device backend
    beside the native ``decode_batch``; the goldens through all three
    backends; ``decode_range`` on the 3-minute noise file, 20 seeded
    ranges on every backend; a corrupt block named by the device
    backend's error. The gliding sines of phase 4 code every lane with a
    fixed predictor, so kernel 7's path shape is the 3-minute noise file
    (476 of its 970 lanes FIR/LPC) and phase 4's 100 s of filtered noise;
12. the mesh (``parallel.mesh``): on a stand-in mesh of two entries on
    card 0, ``plan_group_sharded`` at the (256, 16384) and (3072, 256) plan
    shapes equal to ``plan_group``, the 3-minute file through
    ``FrameEncoder(mesh=)`` equal to one card's bytes with one card's
    launches and plans, phase 6's clips through ``encode_pooled`` with the
    stand-in mesh as template (frames equal to the host route, decodes
    PCM-exact, launches accounted for by the timed shapes); and
    ``default_mesh()`` None with one card. With two or more cards, the
    mesh over all of them: the 3-minute file and the clips pooled (walls
    in turns one card, mesh, mesh, one card; launches per card; CUDA
    events around every chunk's stages, put on the host clock, must show
    chunks on different cards overlapping in time; peak device memory per
    card; busy share per card from torch.profiler), the clips through
    ``serve.serve(["--workers=4"])`` on the default mesh against
    ``LAC_TPU_MESH=0``, and the long WAV through the CLI's streaming route
    in fresh processes with ``LAC_TPU_CLI_MESH=1`` (the CLI's one-shot
    encode runs on one card unless asked) and ``0``;

13. the group route (``encoder._GroupJob``: the lanes the plane pipeline
    does not take, planned on the card) in this warm process: phase 4's
    inputs cut under 8 full blocks and the clip batch's three clips under
    8 full blocks through ``FrameEncoder.encode``, which leaves their
    lanes to the host route while the native runtime is there (bytes equal
    to ``encode_frame``'s, no plan and no launch on the card, one wall
    each); the same lanes through ``ChannelBlockEncoder(device="cuda")``
    ``.encode_lanes``, bytes equal to the host route's, launches
    accounted for by the group route's timed shapes (``"group"`` in
    ``launches_by_path``), walls beside the host route's;
    one batch at each device cap (128 lanes of 16384, 1024 of 256) the
    same way; the 16 goldens through ``FrameEncoder.encode``;
    16384-sample lane groups outside the 24-bit domain through
    ``ChannelBlockEncoder(device="cuda")`` (the order ladder), equal to
    the host route's; a fresh process with ``LAC_TPU_NO_NATIVE=1`` and
    ``LAC_TPU_TIMING=1`` that encodes the 3-minute file, the cuts and four
    goldens through the group route and the token packer on the card,
    bytes equal to this process's, one ``[lac-timing]`` line per encode
    with the group route's phases, and decodes them with the Python
    reader, PCM-exact (walls, ``ship`` bytes copied back per batch, peak
    device memory); a fresh process with ``LAC_TPU_TIMING=1`` whose
    plane-pipeline and host-route encodes print their phases;
14. kernel 8 and the experiments: kernel 8, the static-Rice scan
    tokenizer, bit-exact against its plain version on every output element
    at the reader bench's (64, 4096) and at (256, 16384) (payloads packed by
    the port's ``pack_rice_lanes``, a few lanes held to
    ``encode_static_rice_np``, its tokens equal to the native tokenizer's)
    and on adversarial lanes, timed beside its bound, a one-lane chain floor
    and the native tokenizer; the reader experiment
    (``bench_device_reader``) and the pack experiment
    (``bench_device_pack``: (256, 16384) lanes under kernel 6's k sequence,
    every lane's bytes equal to ``pack_stream`` and the native packer) with
    their launches counted;
15. the captured executables: every plan shape a one-card encode replays (full
    width at K = 64, 128 and 256 with the doubled batches, the three probe
    shapes, the group route's 1024 x 256 cap), with and without
    ``emit_fields``, under each of the four flag combinations: the replay
    bit-exact against eager ``plan_group`` on the same inputs, then a
    ragged batch on the same graph, exact, with the rows the full batch
    left zeroed; each graph launches kernel 9 once and, with partitioning,
    kernel 10 once; captured while another thread uses the card (kernels,
    ``.item()``, host copies, pinned buffers, ``synchronize``); captures,
    replays, capture seconds, device memory with every graph held; host
    dispatch and device time of one plan eager and replayed, in turns; a
    batch's rows into the static buffer gathered then copied, or gathered
    into it; the analyze graphs of K = 64, 128 and 256, every kind, int16
    and int32 planes, and the lag graphs at the group route's caps, int16
    and int32, and on lanes out of the 24-bit domain, the same way
    (bit-exact, a ragged input after the full one, captured beside the
    other thread); host dispatch and device time of one auto chunk
    analyzed eagerly at its kc rows and replayed at K = 256, in turns;
    in fresh processes, a second thread that synchronizes the card
    during captures with ``torch.cuda.synchronize()`` (which CUDA refuses
    beside a capture) and with ``plan_graphs.synchronize()`` (which waits
    out a capture: every capture exact).

Every phase raises on failure (non-zero exit, no result line) and prints
its seconds on a line of its own. The line before the last is the
kernel record, the last line the device record.
Exits non-zero without a CUDA card.
"""

import io
import json
import os
import pathlib
import platform
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import wave
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from lac_tpu_torch import HostCopy, cli, device_decode, device_pipeline, plan_graphs, pool, serve, stream
from lac_tpu_torch import encoder as encoder_mod
from lac_tpu_torch.batch import decode_batch, encode_batch
from lac_tpu_torch.decoder import DecodeError, FrameDecoder
from lac_tpu_torch.device_pipeline import analyze as eager_analyze
from lac_tpu_torch.encoder import (ChannelBlockEncoder, FrameEncoder, lpc_candidates_from_lags, plan_group,
                                   plan_inputs_to_torch)
from lac_tpu_torch.experiments import bench_device_pack, bench_device_reader
from lac_tpu_torch.io import write_wav as write_wav_port
from lac_tpu_torch.ops import _cuda_lib, adapt, runs
from lac_tpu_torch.ops import cuda_kernels as K
from lac_tpu_torch.ops import lpc as lpc_mod
from lac_tpu_torch.ops._backend import u32_from_bits
from lac_tpu_torch.ops.lpc import autocorrelation as eager_lags
from lac_tpu_torch.ops.stereo import estimate_stereo_mode
from lac_tpu_torch.parallel import default_mesh, make_mesh, mesh as mesh_mod, plan_group_sharded
from lac_tpu_torch.profile_encode import filtered_noise_stereo, gliding_stereo, plan_batch
from lac_tpu_torch.runtime import native
from tests.signals import cases as golden_cases

REPO = pathlib.Path(__file__).resolve().parent

BLOCK = 16384
LANES = 256  # plan batch at chunk width K = 256
ROWS = LANES * 11  # candidate rows of one plan batch
PROBE_ROWS = 12 * LANES * 11  # probe plan batch (12 probe lanes per block)
GROUP_LANES = 128  # the group route's device batch cap at 16384 samples (encoder.ChannelBlockEncoder)
GROUP_PROBE_LANES = 1024  # ... and at 256
# plan batches on the card by (caller, row length): the plane pipeline's and the group route's
PLAN_KINDS = {("pipe", BLOCK): "full", ("pipe", 256): "probe",
              ("group", BLOCK): "group-full", ("group", 256): "group-probe"}

KERNELS = {  # name -> (source, the Pallas function it replaces)
    "k_cost_sums": ("lac_tpu_torch/csrc/kcost.cu", "lac_tpu/ops/pallas_kernels.py:81"),
    "split_cumsums_u32": ("lac_tpu_torch/csrc/row_scan.cu", "lac_tpu/ops/pallas_kernels.py:205"),
    "cumsum_u32": ("lac_tpu_torch/csrc/row_scan.cu", "lac_tpu/ops/pallas_kernels.py:218"),
    "prefix_max_i32": ("lac_tpu_torch/csrc/row_scan.cu", "lac_tpu/ops/pallas_kernels.py:319"),
    "suffix_min_i32": ("lac_tpu_torch/csrc/row_scan.cu", "lac_tpu/ops/pallas_kernels.py:325"),
    "k_after_stateful_fused": ("lac_tpu_torch/csrc/k_after.cu", "lac_tpu/ops/pallas_adapt.py:333"),
    # port-added: replaces XLA code, a lax.scan, that eager torch cannot run as one launch
    "recurrence_restore": ("lac_tpu_torch/csrc/restore.cu", "lac_tpu/ops/predictors.py:243 (lax.scan)"),
    "tokenize_static_rice_scan": ("lac_tpu_torch/csrc/rice_scan.cu",
                                  "lac_tpu/ops/device_reader.py:122 (lax.scan :183)"),
    # port-added: replace XLA fusions of plan_group that eager torch runs as dozens of int64 passes
    "mode_cost_sums": ("lac_tpu_torch/csrc/mode_costs.cu",
                       "lac_tpu/encoder.py:113 (_mode_cost_fields with ops/runs.py:51, summed at :217-221)"),
    "partition_cost_sums": ("lac_tpu_torch/csrc/mode_costs.cu",
                            "lac_tpu/encoder.py:323 (the partition sweep's mode costs, :323-388)"),
}
RESTORE = "recurrence_restore"
SCAN = "tokenize_static_rice_scan"
ENCODE_KERNELS = tuple(name for name in KERNELS if name not in (RESTORE, SCAN))  # the planner's six
OWN_PATH = {RESTORE: "decode", SCAN: "reader"}  # the path that launches a kernel that no encode launches

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
#     scans (7), store (1);
#   mode_cost_sums, per sample: rice (q's compare, select and shift 3, the
#     u64 sum 4), |v| (3), bin (compares and u64 selects 6), the escape
#     threshold (3), token (compare, u64 select and add 5), the zero test
#     (1), three u64 accumulations (6), the k hand-over and four 16-byte
#     loads amortised (2);
#   partition_cost_sums: PARTITION_OPS below, per sample and order.
OPS_PER_ELEMENT = {
    "k_cost_sums": 35,
    "split_cumsums_u32": 8,
    "cumsum_u32": 4,
    "prefix_max_i32": 4,
    "suffix_min_i32": 4,
    "k_after_stateful_fused": 120,
    "mode_cost_sums": 33,
    # per restored sample on csrc/restore.cu's fast way, besides its taps, in
    # int32-instruction equivalents (a float64 instruction issues at half
    # that rate: 64 lanes an SM, so it counts 2): the floor and the float64
    # sample (two DADDs, 4), the biased residual (2), the flag (add and or),
    # the 16-byte shared-memory load and device store a quarter each, the
    # tile's copies and the run's set-up amortised (1)
    RESTORE: 9,
    # per token, the least a parse of the stream needs (a 64-bit window held
    # in registers, where csrc/rice_scan.cu reloads eight bytes a token):
    # the window's funnel shift (2) and its refill amortised (2), clz of ~w
    # (3), the remainder's shifts (4), u (2), the zigzag (3), the position
    # (2), the valid compare (1) and the two stores (2)
    SCAN: 21,
}
# partition_cost_sums, per sample and partition order: the integer
# instructions its arithmetic needs once what does not depend on the order
# (u, its class, the zero runs, the prefix at the part's start) is done once
# a sample. Where the part sums below 2^31: the running sum (1), its clamp
# (1), two bit widths (2), k0 (1), the shift (1), the compare (1) and the
# add (1) of the stateless k; the quotient (1), t = q + k (1) and its sum
# (1); bin's test and add (2); the escape test, its select and zr's add (3):
# 17. With 64-bit values: the running sum (2), the clamp (4), the bit width
# of M (5) and of c (1), k0 (1), the shift (2), the compare (2), the cap
# (1) and the add (1); the quotient with its cap (2), t (1) and its sum (2);
# bin (3); escape and zr (4): 31. Counted over what these inputs need:
# each part at the count its sum calls for (partition_ops).
PARTITION_OPS = (17, 31)
# kernel 7, per tap of a restored sample: one float64 multiply-add (2 int32
# equivalents); the history rotates through registers (no move). The work
# counted is each lane's valid samples times its own order, what the data needs
OPS_PER_TAP = 2
# kernel 7's serial floor: one step's dependent chain in csrc/restore.cu's fast
# way is the newest tap's DFMA, the DADD that floors and the DADD back to the
# sample, 3 dependent float64 instructions at about 8 cycles each at the 1.98
# GHz boost clock (an estimate from the source; check_restore also measures
# the chain: every lane at order 1)
SERIAL_CYCLES_PER_STEP = 3 * 8
SM_CLOCK_HZ = 1.98e9
# one PyTorch call computing the same function, timed as a yardstick only
LIBRARY_CALLS = {
    "cumsum_u32": lambda x: torch.cumsum(x, -1, dtype=torch.int32),
    "prefix_max_i32": lambda x: torch.cummax(x, -1).values,
}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase_seconds(label, t0):
    """One line a phase: its seconds since ``t0``."""
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s")


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


def short_runs(codes):
    """``codes`` with every 7th row (from row 3) holding zero runs of 3, 4
    and 5 samples across every 32-sample edge (every part edge of every
    partition order), codes 1..8 between them."""
    codes = codes.copy()
    rows, n = codes.shape
    for r in range(3, rows, 7):
        row = (np.arange(n) % 8 + 1).astype(np.int32)
        for edge in range(32, n, 32):
            length = 3 + (edge // 32) % 3
            at = edge - length // 2 - (edge // 64) % 2
            row[at : at + length] = 0
        codes[r] = row
    return codes


def mode_cost_operands(codes, rng, dev):
    """Kernel 9's operands for u32 ``codes`` (rows, n): k_after from the
    stateful adapter (every 7th row from row 1 all 31), initial k 0..12 (0
    and 12 on the first two rows), every 7th row from row 4 recoded at each
    sample's escape threshold 2^min(k + 3, 24) or one above (by the code's
    parity), and the zero breaks of the final codes (kernels 4 and 5)."""
    rows = len(codes)
    x = torch.from_numpy(np.ascontiguousarray(short_runs(codes))).to(dev)
    k_after = adapt.k_after_stateful(x)
    k_after[1::7] = 31
    initial = torch.from_numpy(rng.randint(0, 13, rows).astype(np.int32)).to(dev)
    initial[:2] = torch.tensor([0, 12], dtype=torch.int32)
    k_used = adapt.k_used_from_after(k_after, initial).to(torch.int64)
    u = u32_from_bits(x)
    thr = (1 << torch.clamp(k_used + 3, max=24)) + (u & 1)
    x = torch.where((torch.arange(rows, device=dev) % 7 == 4)[:, None], thr, u).to(torch.int32)
    last, nxt = runs.zero_breaks(x == 0)
    return x, k_after, initial, last, nxt


def partition_cost_operands(codes, max_p, rng, dev):
    """Kernel 10's operands for winners' u32 ``codes`` (B, n): the codes
    with short zero runs across part edges, their zero breaks, and each
    part's initial k, 0..12 (all 0 and all 12 on the first two rows)."""
    x = torch.from_numpy(np.ascontiguousarray(short_runs(codes))).to(dev)
    last, nxt = runs.zero_breaks(x == 0)
    init_k = rng.randint(0, 13, (len(codes), K.partition_parts(max_p))).astype(np.int32)
    init_k[0], init_k[1] = 0, 12
    return x, last, nxt, torch.from_numpy(init_k).to(dev)


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
    gfull, gprobe = ("group-full", 1), ("group-probe", 1)  # the group route's batches at its caps
    g_rows, gp_rows = GROUP_LANES * 11, GROUP_PROBE_LANES * 11

    def with_head(head):  # head sums and row sums from one launch
        return (lambda x: K.k_cost_sums(x, head=head)), (lambda x: K.k_cost_sums_plain(x, head=head))

    def orders(max_p):  # every partition order's sums from one launch
        return (lambda x: K.k_cost_partition_sums(x, max_p)), (lambda x: K.k_cost_partition_sums_plain(x, max_p))

    # the planner's launches: the candidate stack (head and row sums), then the winners (every order)
    kcost = [("(B*11, 16384), head 256 + row", stack_t, full, with_head(256)),
             ("winners (B, 16384), orders 0..8", winners_t, full, orders(8)),
             ("probe (12B*11, 256), head = row", probes_t, probe, with_head(256)),
             ("probe winners (12B, 256), orders 0..3", pw_t, probe, orders(3)),
             ("group (128*11, 16384), head 256 + row", stack_t[:g_rows], gfull, with_head(256)),
             ("group winners (128, 16384), orders 0..8", winners_t[:GROUP_LANES], gfull, orders(8)),
             ("group probe (1024*11, 256), head = row", probes_t[:gp_rows], gprobe, with_head(256)),
             ("group probe winners (1024, 256), orders 0..3", pw_t[:GROUP_PROBE_LANES], gprobe, orders(3)),
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
             ("probe (12B*11, 256)", probes, probe), ("probe (12B, 256)", probe_winners, probe),
             ("group (128*11, 16384)", stack[:g_rows], gfull), ("group (128, 16384)", winners[:GROUP_LANES], gfull),
             ("group probe (1024*11, 256)", probes[:gp_rows], gprobe),
             ("group probe (1024, 256)", probe_winners[:GROUP_PROBE_LANES], gprobe)] + extra
    extra_t = [(lbl, up(a), tm) for lbl, a, tm in extra]
    flags_t = up(flags.astype(np.uint32).view(np.int32))
    k_after_t = up(k_after_codes(ROWS, BLOCK, rng))
    # long rows beside the path's 16384, from their own seed (the cases above keep their data): a
    # ragged chunk (16388), the scalar path (16390), two chunks and the carry (20480), one block
    # alone (1, 16384), four chunks (3, 65536)
    lrng = np.random.RandomState(16388)
    long_rows = [(f"({rows}, {n})", adversarial_codes(rows, n, lrng))
                 for rows, n in ((37, 16388), (37, 16390), (37, 20480), (1, 16384), (3, 65536))]
    long_t = [(lbl, up(a), None) for lbl, a in long_rows]
    long_max, long_min = ([(lbl, up(break_indices(a, lrng, rev)), None) for lbl, a in long_rows]
                          for rev in (False, True))
    # kernels 9 and 10: the candidate stacks and the winners above, with their operands; shapes beside the
    # path's from their own seed: a row length the 16-byte loads cannot take (1001), the two sides of the
    # block-per-row cut (2044, 2048), unequal parts (1000, 4113) and equal parts of no power of two (12288)
    mrng = np.random.RandomState(9)
    mode_call = (lambda x: K.mode_cost_sums(*x)), (lambda x: K.mode_cost_sums_plain(*x))
    stack_m = mode_cost_operands(stack, mrng, dev)
    probes_m = mode_cost_operands(probes, mrng, dev)
    modes = [("(B*11, 16384)", stack_m, full, mode_call), ("probe (12B*11, 256)", probes_m, probe, mode_call),
             ("group (128*11, 16384)", tuple(t[:g_rows] for t in stack_m), gfull, mode_call),
             ("group probe (1024*11, 256)", tuple(t[:gp_rows] for t in probes_m), gprobe, mode_call)]
    modes += [(f"(37, {n})", mode_cost_operands(adversarial_codes(37, n, mrng), mrng, dev), None, mode_call)
              for n in (1001, 2044, 2048)]

    def part_call(max_p):
        return ((lambda x: K.partition_cost_sums(*x, max_p)), (lambda x: K.partition_cost_sums_plain(*x, max_p)))

    parts = [("winners (B, 16384), orders 1..8", partition_cost_operands(winners, 8, mrng, dev), full, part_call(8)),
             ("probe winners (12B, 256), orders 1..3", partition_cost_operands(probe_winners, 3, mrng, dev), probe,
              part_call(3))]
    parts += [(f"group winners ({rows}, {ops[0].shape[1]}), orders 1..{max_p}", tuple(t[:rows] for t in ops), kind,
               part_call(max_p)) for (_, ops, _, _), rows, max_p, kind
              in zip(list(parts), (GROUP_LANES, GROUP_PROBE_LANES), (8, 3), (gfull, gprobe))]
    parts += [(f"(37, {n}), orders 1..{max_p}", partition_cost_operands(adversarial_codes(37, n, mrng), max_p, mrng,
                                                                         dev), None, part_call(max_p))
              for n, max_p in ((1000, 4), (4113, 7), (12288, 8), (64, 1))]
    # the full width at every deepest order, from its own seed: each order's part edges on the chunk path
    prng = np.random.RandomState(16384)
    wide_rows = adversarial_codes(37, BLOCK, prng)
    parts += [(f"(37, {BLOCK}), orders 1..{max_p}", partition_cost_operands(wide_rows, max_p, prng, dev), None,
               part_call(max_p)) for max_p in range(1, 9)]
    # which of kernel 10's paths (csrc/mode_costs.cu) each shape takes: the main path's rows the chunk path
    paths = {n: K.partition_cost_path(n) for n in {ops[0].shape[1] for _, ops, _, _ in parts}}
    check(paths[BLOCK][0] == paths[256][0] == "chunks", f"partition_cost_sums: the main path's rows take {paths}")
    paths = {n: f"{kind}, R = {r}" if r else kind for n, (kind, r) in paths.items()}
    parts = [(f"{label} [{paths[ops[0].shape[1]]}]", ops, tm, call) for label, ops, tm, call in parts]
    return {
        "k_cost_sums": kcost,
        "split_cumsums_u32": [("probe (12B*11, 256)", probes_t, probe),
                              ("group probe (1024*11, 256)", probes_t[:gp_rows], gprobe),
                              ("(B*11, 16384)", stack_t, None)] + extra_t + long_t,
        "cumsum_u32": [("probe flags (12B*11, 256)", flags_t, probe),
                       ("group probe flags (1024*11, 256)", flags_t[:gp_rows], gprobe),
                       ("adversarial (B*11, 16384)", stack_t, None)] + extra_t + long_t,
        "prefix_max_i32": [(lbl, up(break_indices(a, rng, False)), tm) for lbl, a, tm in scans] + long_max,
        "suffix_min_i32": [(lbl, up(break_indices(a, rng, True)), tm) for lbl, a, tm in scans] + long_min,
        "k_after_stateful_fused": [(f"({ROWS}, {BLOCK})", k_after_t, full),
                                   (f"group ({g_rows}, {BLOCK})", k_after_t[:g_rows], gfull)]
        + [(f"(37, {n}), {n // 2048} tiles", up(k_after_codes(37, n, rng)), None)
           for n in range(2048, BLOCK + 1, 2048)],
        "mode_cost_sums": modes,
        "partition_cost_sums": parts,
    }


def as_values(name, out):
    """Kernel output -> int64 values (u32 sums, i32 scans, int64 bit sums) for the diff."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [t.to(torch.int64) if name.endswith("_i32") or t.dtype == torch.int64 else u32_from_bits(t)
            for t in outs]


def bound(name, x, out, ops=None):
    """(bound_ms, bound_by): the larger of the bytes the function must
    move (inputs read once, outputs written once) over the memory rate and
    its integer instructions (``ops``, else OPS_PER_ELEMENT per element of
    the first input) over the peak instruction rate."""
    ins = x if isinstance(x, (tuple, list)) else (x,)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    outs = list({o.data_ptr(): o for o in outs}.values())  # a result returned twice is written once
    nbytes = sum(t.numel() * t.element_size() for t in (*ins, *outs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if ops is None:
        ops = partition_ops(ins) if name == "partition_cost_sums" else OPS_PER_ELEMENT[name] * ins[0].numel()
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def partition_ops(x):
    """PARTITION_OPS over the samples of every part of orders 1..max_p of
    kernel 10's operands ``x`` (codes, breaks, initial k): the 32-bit count
    in a part that sums below 2^31, the 64-bit one elsewhere."""
    u = u32_from_bits(x[0])
    B, n = u.shape
    total = 0
    for p in range(1, (x[3].shape[1] + 2).bit_length() - 1):  # 2^(max_p+1) - 2 parts
        part = torch.clamp(torch.arange(n, device=u.device) // (n >> p), max=(1 << p) - 1)  # the last to n
        sums = torch.zeros((B, 1 << p), dtype=torch.int64, device=u.device).index_add_(1, part, u)
        ops = torch.where(sums >= 1 << 31, PARTITION_OPS[1], PARTITION_OPS[0])
        total += int((ops * torch.bincount(part, minlength=1 << p)).sum().item())
    return total


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


def check_tally(label, x):
    """Kernel 10's tally of operands ``x`` (codes, breaks, initial k)
    against its plain version's, each added to a tally already holding
    counts; returns the kernel's count."""
    max_p = (x[3].shape[1] + 2).bit_length() - 2  # 2^(max_p+1) - 2 parts
    tallies = [torch.tensor([3, 4], dtype=torch.int64, device=x[0].device) for _ in range(2)]
    K.partition_cost_sums(*x, max_p, tally=tallies[0])
    K.partition_cost_sums_plain(*x, max_p, tallies[1])
    got, want = (t.tolist() for t in tallies)
    check(got == want, f"partition_cost_sums {label}: tally {got}, the plain version's {want}")
    return [got[0] - 3, got[1] - 4]


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
            if name == "partition_cost_sums":
                print(f"    tally (parts summed the 64-bit way, parts): {check_tally(label, x)}")
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
    shapes, for plan batch counts ``plans`` by kind (``PLAN_KINDS``). A
    group-route batch is timed at its cap: its launches are exact, its
    time an upper estimate."""
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
    """Wrap the planner where the plane pipeline, the group route and the
    mesh call it (``planned``): plan batches on the card counted by kind
    (``PLAN_KINDS``; a row length that no timed shape covers raises), and
    under ``("captured", kind)`` the graphs those calls captured, each of
    which ran one eager warm-up plan on the card first. ``plan_group``
    is wrapped where the captures call it: its calls on CUDA tensors
    count under ``"eager"`` (a capture's warm-up and the capture itself;
    nothing else may run a plan eagerly on the card). Likewise the
    analyze and lag graphs: ``"analyzed"`` and ``"lags_of"`` count the
    chunks and lag batches on the card (``device_pipeline.analyzed``,
    ``encoder.lags_of``), ``"eager-analyze"`` and ``"eager-lags"`` the
    calls on CUDA tensors of what their captures run
    (``device_pipeline.analyze``, ``ops.lpc.autocorrelation``)."""
    calls = {}
    guard = threading.Lock()  # a mesh plans from one thread per entry
    mine = threading.local()  # this thread's eager calls: a capture runs in the thread that plans

    def add(key, k=1):
        with guard:
            calls[key] = calls.get(key, 0) + k

    def wrap(module, caller):
        plan = module.planned

        def counted(pcm, *args, **kwargs):
            if not pcm.is_cuda:
                return plan(pcm, *args, **kwargs)
            kind = PLAN_KINDS[(caller, pcm.shape[1])]
            before = getattr(mine, "eager", 0)
            out = plan(pcm, *args, **kwargs)
            add(kind)
            add(("captured", kind), (getattr(mine, "eager", 0) - before) // 2)
            return out

        module.planned = counted

    eager = encoder_mod.plan_group

    def counted_eager(pcm, *args, **kwargs):
        if pcm.is_cuda:
            mine.eager = getattr(mine, "eager", 0) + 1
            add("eager")
        return eager(pcm, *args, **kwargs)

    encoder_mod.plan_group = counted_eager
    wrap(device_pipeline, "pipe")
    wrap(encoder_mod, "group")
    wrap(mesh_mod, "group")

    def counting(module, attr, key):
        real = getattr(module, attr)

        def counted_call(x, *args, **kwargs):
            if x.is_cuda:
                add(key)
            return real(x, *args, **kwargs)

        setattr(module, attr, counted_call)

    counting(device_pipeline, "analyzed", "analyzed")
    counting(encoder_mod, "lags_of", "lags_of")
    counting(device_pipeline, "analyze", "eager-analyze")
    counting(lpc_mod, "autocorrelation", "eager-lags")
    return calls


class Counted:
    """Kernel launches, plan batches and captured plans of a stretch of the
    run: the launch counts are set to 0 on entry (unless ``reset`` is
    False) and what the stretch added is read on exit (``launches``), the
    plan batches of the stretch by kind (``plans``), the captures they
    made by kind (``captured``), and ``graphs``: ``plan_graphs.stats``'
    replays, captures and capture seconds, and the eager ``plan_group``
    calls on the card; ``analyze`` and ``lags`` the same of the analyze
    and lag graphs, with ``calls``, the chunks and batches on the card."""

    def __init__(self, batches, reset=True):
        self.batches, self.reset = batches, reset

    def __enter__(self):
        if self.reset:
            K.reset_launches()
        self.before = dict(K.launches), dict(self.batches), dict(plan_graphs.stats)
        self.before_kinds = {kind: dict(plan_graphs.CACHES[kind].stats) for kind in ("analyze", "lags")}
        return self

    def __exit__(self, *exc):
        launches, batches, stats = self.before

        def added(key):
            return self.batches.get(key, 0) - batches.get(key, 0)

        self.launches = {k: v - launches[k] for k, v in K.launches.items()}
        self.plans = {kind: added(kind) for kind in PLAN_KINDS.values()}
        self.captured = {kind: added(("captured", kind)) for kind in PLAN_KINDS.values()}
        self.graphs = {k: v - stats[k] for k, v in plan_graphs.stats.items()}
        self.graphs["eager"] = added("eager")
        for kind, calls in (("analyze", "analyzed"), ("lags", "lags_of")):
            before = self.before_kinds[kind]
            got = {k: v - before[k] for k, v in plan_graphs.CACHES[kind].stats.items()}
            got.update(calls=added(calls), eager=added(f"eager-{kind}"))
            setattr(self, kind, got)


def check_accounting(label, shapes, c):
    """The timed shapes are every shape the path launches: with the plan
    batches of a stretch ``c`` (a :class:`Counted`), and the one eager
    warm-up plan of each capture, they account for every counted launch,
    replays included. Every plan on the card is a replay, and the only
    eager ``plan_group`` calls on the card are a capture's warm-up and the
    capture. Returns the model (name -> launches, ms, ms over the bound)."""
    counts, g = c.launches, c.graphs
    plans = {kind: c.plans[kind] + c.captured[kind] for kind in c.plans}
    model = per_encode(shapes, plans)
    check(all(model[k][0] == counts[k] for k in model) and counts[RESTORE] == counts[SCAN] == 0,
          f"{label}: launches {counts} differ from the timed shapes' {({k: v[0] for k, v in model.items()})}")
    check(counts["k_after_stateful_fused"] == plans["full"] + plans["group-full"] and
          counts["split_cumsums_u32"] == counts["cumsum_u32"] == plans["probe"] + plans["group-probe"],
          f"{label}: kernel 6 runs once per full-width plan, kernels 2 and 3 once per probe plan: {counts}, {plans}")
    check(counts["mode_cost_sums"] == counts["partition_cost_sums"] == sum(plans.values()),
          f"{label}: kernels 9 and 10 run once per plan: {counts}, {plans}")
    check(g["replays"] == sum(c.plans.values()) and g["captures"] == sum(c.captured.values())
          and g["eager"] == 2 * g["captures"],
          f"{label}: plans {c.plans}, captures {c.captured}, graphs {g}: every plan on the card must be a replay, "
          f"and every eager plan_group call on the card a capture's warm-up or the capture")
    for kind in ("analyze", "lags"):
        a = getattr(c, kind)
        check(a["replays"] == a["calls"] and a["eager"] == 2 * a["captures"],
              f"{label}: {kind} graphs {a}: every {kind} on the card must be a replay, and every eager call on the "
              f"card a capture's warm-up or the capture")
    return model


class WaveLog:
    """Each pooled wave of a stretch of the run: its full blocks and its wall
    (``pool.run_group_wave`` wrapped on entry, restored on exit)."""

    def __enter__(self):
        self.walls = []
        self.real = real = pool.run_group_wave

        def timed(group, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(group, *args, **kwargs)
            finally:
                self.walls.append((sum(job.nfull for job in group), time.perf_counter() - t0))

        pool.run_group_wave = timed
        return self

    def __exit__(self, *exc):
        pool.run_group_wave = self.real

    def blocks(self):
        return [b for b, _ in self.walls]

    def text(self):
        return ", ".join(f"{b} blocks {s:.3f} s" for b, s in self.walls)


def timed_on_card(fn):
    """(result, wall s, peak device bytes) of ``fn()``, the card idle before and after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


PAGE_KB = os.sysconf("SC_PAGE_SIZE") // 1024


def run_child(args, env=None, limit_s=300):
    """``python3 <args>`` from the checkout in a fresh process, killed after
    ``limit_s``. Returns (exit code, output, wall s, peak RSS in MiB). The
    peak is the largest resident size seen in /proc/<pid>/statm, read every
    20 ms while the child runs: ``ru_maxrss`` would not do, a child starts
    with its parent's peak, and this process holds gigabytes."""
    with tempfile.TemporaryFile() as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, *args], cwd=REPO, env=child_env(env), stdout=out,
                                stderr=subprocess.STDOUT)
        peak_kb = watch(proc, t0, limit_s)
        wall = time.perf_counter() - t0
        out.seek(0)
        return proc.returncode, out.read().decode(errors="replace"), wall, peak_kb / 1024


def child_env(env):
    out = {k: v for k, v in os.environ.items() if not k.startswith("LAC_TPU_STREAM")}
    out.update(env or {})
    return out


def watch(proc, t0, limit_s):
    """Peak resident KiB of ``proc`` from /proc/<pid>/statm, read every 20 ms
    until it exits; killed after ``limit_s``."""
    peak_kb = 0
    try:
        while proc.poll() is None:
            if time.perf_counter() - t0 > limit_s:
                proc.kill()
            try:
                with open(f"/proc/{proc.pid}/statm") as f:
                    peak_kb = max(peak_kb, int(f.read().split()[1]) * PAGE_KB)
            except (OSError, IndexError, ValueError):  # the child has just gone
                pass
            time.sleep(0.02)
    finally:
        proc.kill()
        proc.wait()
    return peak_kb


def run_serve_child(args, script, expect, env=None, linger_s=0.0, limit_s=300):
    """``python3 <args>`` from the checkout with ``script`` on its stdin, which
    stays open until ``expect`` lines are out and ``linger_s`` more seconds
    have passed. Returns (exit code, [(s since start, parsed stdout line)],
    stderr, wall s, peak RSS in MiB); a stdout line that is not JSON fails."""
    with tempfile.TemporaryFile() as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, *args], cwd=REPO, env=child_env(env), stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=err, text=True)
        raw = []

        def read():
            for line in proc.stdout:
                raw.append((time.perf_counter() - t0, line))

        def feed():
            try:
                proc.stdin.write(script)
                proc.stdin.flush()
                while len(raw) < expect and proc.poll() is None and time.perf_counter() - t0 < limit_s:
                    time.sleep(0.05)
                time.sleep(linger_s)
                proc.stdin.close()
            except OSError:  # the child has gone
                pass

        threads = [threading.Thread(target=fn, daemon=True) for fn in (read, feed)]
        for t in threads:
            t.start()
        peak_kb = watch(proc, t0, limit_s)
        wall = time.perf_counter() - t0
        for t in threads:
            t.join(timeout=10)
        err.seek(0)
        errors = err.read().decode(errors="replace")
    lines = []
    for at, line in raw:
        try:
            lines.append((at, json.loads(line)))
        except ValueError:
            raise RuntimeError(f"chip_smoke: {args}: a stdout line is not JSON: {line!r}\n{errors[-4000:]}") from None
    return proc.returncode, lines, errors, wall, peak_kb / 1024


def gib(nbytes):
    return f"{nbytes / 2**30:.2f} GiB"


# ------------------------------------------------------------ the other plane kinds


def check_kinds(audio, shapes, batches):
    """The ``kind`` branches of ``device_pipeline.analyze`` other than auto
    on gliding sines, a filtered-noise file (all at chunk width 256) and
    the 30 s corpus (chunk width 64), bytes against the port's host route.
    Returns [(label, frame, left, right)]."""
    left, right = audio[0][3]
    cut = 269 * BLOCK + 1234
    out = []
    cases = [("mono, 3 min", 0, left, ()),
             ("forced ms, 100 s", 1, left[:cut], right[:cut]),
             ("forced lr, 100 s", 0, left[:cut], right[:cut]),
             ("filtered noise, 100 s, auto", 2, *filtered_noise_stereo(cut, 44100, 16, 3)),
             ("gliding sines, 30 s, auto, chunk width 64", 2, *gliding_stereo(30 * 44100, 44100, 16, 0xC0DEC))]
    for label, mode, l, r in cases:
        ref = FrameEncoder(12, mode, 44100, 16, device="cuda").encode_frame(l, r)
        with Counted(batches) as c:
            got, wall, peak = timed_on_card(lambda: FrameEncoder(12, mode, 44100, 16, device="cuda").encode(l, r))
        check(got == ref, f"{label}: port bytes differ from the port's host route")
        check(c.plans["full"] > 0, f"{label}: the plane pipeline did not run")
        check_accounting(label, shapes, c)
        dl, dr, _ = FrameDecoder().decode(got)
        check(np.array_equal(dl, l) and np.array_equal(dr, np.asarray(r, np.int32)), f"{label}: decoded PCM differs")
        print(f"{label}: {len(l) // BLOCK} full blocks, port bytes == host route, decode PCM-exact; "
              f"{c.plans['full']} full-width and {c.plans['probe']} probe plans; first encode {wall:.3f} s; "
              f"peak device memory {gib(peak)}")
        out.append((label, got, l, np.asarray(r, np.int32)))
    return out


# ------------------------------------------------------------ many files


CLIP_RATE = 44100
COLD_BATCH_CHILD = """
import pathlib, sys
from lac_tpu_torch.ops import _cuda_lib
from lac_tpu_torch.runtime import native
root = pathlib.Path(sys.argv[1])
root.mkdir()
_cuda_lib.BUILD_DIR = root / "kernels"  # nothing built yet: the threads build both
native.BUILD_DIR = root / "runtime"
from lac_tpu_torch.batch import encode_batch
from lac_tpu_torch.encoder import (ChannelBlockEncoder, FrameEncoder, lpc_candidates_from_lags, plan_group,
                                   plan_inputs_to_torch)
from lac_tpu_torch.profile_encode import gliding_stereo
items = [gliding_stereo(9 * 16384 + 100 * i, 44100, 16, 70 + i) for i in range(4)]
got = encode_batch(items, 44100, 16, max_workers=4)
assert got == [FrameEncoder(12, 2, 44100, 16).encode_frame(l, r) for l, r in items], "bytes differ"
print("built in this process: nvcc %.1f s" % _cuda_lib.build_info["seconds"])
"""


def make_clips():
    """84 stereo clips from a seed: 80 of 5-35 s and four special ones (an
    exact multiple of the block, under 8 full blocks, no full block, three
    blocks), gliding sines and every third filtered noise."""
    rng = np.random.RandomState(60)
    frames = [int(s * CLIP_RATE) for s in rng.uniform(5, 35, 80)]
    for at, n in ((5, 40 * BLOCK), (20, 7 * BLOCK + 5000), (41, BLOCK - 1000), (60, 3 * BLOCK + 77)):
        frames.insert(at, n)

    def make(i):
        recipe = filtered_noise_stereo if i % 3 == 2 else gliding_stereo
        return recipe(frames[i], CLIP_RATE, 16, 1000 + i)

    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(make, range(len(frames))))


def check_decodes(label, frames, items):
    for i, ((dl, dr, _), (l, r)) in enumerate(zip(decode_batch(frames), items)):
        want_r = r if r is not None else np.empty(0, np.int32)
        check(np.array_equal(dl, l) and np.array_equal(dr, want_r), f"{label}: clip {i} decodes to other PCM")


def check_batch_paths(tmp, shapes, batches):
    """The clip batch pooled, file by file and threaded; small pooled batches of the other formats."""
    t0 = time.perf_counter()
    clips = make_clips()
    nfull = [len(l) // BLOCK for l, _ in clips]
    total, frames = sum(nfull), sum(len(l) for l, _ in clips)
    check(total > pool._MAX_WAVE_BLOCKS, f"the clips hold {total} full blocks: want more than one wave")
    check(0 in nfull and any(0 < n < device_pipeline.MIN_FULL_BLOCKS for n in nfull)
          and any(len(l) % BLOCK == 0 for l, _ in clips), "the special clips are missing")
    t1 = time.perf_counter()
    refs = [FrameEncoder(12, 2, CLIP_RATE, 16, device="cuda").encode_frame(l, r) for l, r in clips]
    print(f"clip batch: {len(clips)} clips, {frames} frames, {total} full blocks (made in {t1 - t0:.1f} s); "
          f"host route (native planner) {time.perf_counter() - t1:.2f} s")
    check_decodes("clip batch", refs, clips)

    paths = {
        "pooled": lambda: pool.encode_pooled(clips, CLIP_RATE, 16),
        "file by file": lambda: [FrameEncoder(12, 2, CLIP_RATE, 16, device="cuda").encode(l, r) for l, r in clips],
        "encode_batch, 4 threads": lambda: encode_batch(clips, CLIP_RATE, 16, max_workers=4),
    }
    runs = {name: [] for name in paths}
    with WaveLog() as log:
        for turn in range(2):
            for name, fn in paths.items():
                with Counted(batches) as c:
                    got, wall, peak = timed_on_card(fn)
                check(got == refs, f"clip batch, {name}: frames {[i for i, (g, w) in enumerate(zip(got, refs)) if g != w]}"
                                   f" differ from the port's host route")
                runs[name].append((wall, peak, c))
    waves = log.blocks()
    check(len(waves) >= 4 and waves[: len(waves) // 2] == waves[len(waves) // 2:] and sum(waves) == 2 * total
          and max(waves) <= pool._MAX_WAVE_BLOCKS, f"clip batch: want two or more waves under the cap, got {waves}")
    pooled = runs["pooled"][0][2]
    check(all(pooled.launches[k] > 0 for k in ENCODE_KERNELS), f"clip batch: a kernel never launched: {pooled.launches}")
    for name, turns in runs.items():
        for _, _, c in turns:
            check_accounting(f"clip batch, {name}", shapes, c)
    # the counts are exact from any number of threads: four threads launch what one does
    check(all(runs["encode_batch, 4 threads"][t][2].launches == runs["file by file"][t][2].launches for t in (0, 1)),
          "clip batch: the threaded run's launch counts differ from the file-by-file run's")
    print(f"clip batch: every frame == host route and decodes PCM-exact, pooled, file by file and threaded; "
          f"pooled in {len(waves) // 2} waves of {waves[: len(waves) // 2]} blocks; wave walls {log.text()}")
    for name, turns in runs.items():
        (w0, p0, c), (w1, p1, _) = turns
        print(f"  {name:24s} {w0:.3f} s first, {w1:.3f} s second = {frames / w1:,.0f} frames/s; "
              f"{c.plans['full']} full-width and {c.plans['probe']} probe plans; "
              f"peak device memory {gib(p0)} / {gib(p1)}; launches {c.launches}")

    small = {
        "6 mono clips": (CLIP_RATE, 16, [(l, None) for l, _ in clips[:6]]),
        "5 clips at 96 kHz 24-bit": (96000, 24, [
            (filtered_noise_stereo if i % 2 else gliding_stereo)(int(s * 96000), 96000, 24, 2000 + i)
            for i, s in enumerate((5.0, 12.3, 20.0, 1.2, 8.0))]),
        "a wave of under 8 blocks": (CLIP_RATE, 16, [clips[60], clips[41], gliding_stereo(2 * BLOCK, CLIP_RATE, 16, 9)]),
    }
    wants = {}
    for label, (rate, depth, items) in small.items():
        want = wants[label] = [
            FrameEncoder(12, 2 if r is not None else 0, rate, depth, device="cuda").encode_frame(l, r if r is not None else ())
            for l, r in items]
        with Counted(batches) as c:
            got, wall, peak = timed_on_card(lambda: pool.encode_pooled(items, rate, depth))
        check(got == want, f"pooled, {label}: frames differ from the port's host route")
        check(c.plans["full"] > 0, f"pooled, {label}: no wave reached the card")
        check_accounting(f"pooled, {label}", shapes, c)
        check_decodes(f"pooled, {label}", got, items)
        print(f"pooled, {label}: {sum(len(l) // BLOCK for l, _ in items)} full blocks, frames == host route, decode "
              f"PCM-exact; {c.plans['full']} full-width and {c.plans['probe']} probe plans; {wall:.3f} s; "
              f"peak device memory {gib(peak)}")

    # its clips are under LAC_TPU_COLD_BLOCKS: with the cold route off they reach the card, so the threads
    # build both libraries
    rc, out, wall, rss = run_child(["-c", COLD_BATCH_CHILD, os.path.join(tmp, "cold-build")],
                                   {"LAC_TPU_COLD_BLOCKS": "0"})
    check(rc == 0, f"a fresh process whose first call is a threaded encode_batch failed ({rc}):\n{out}")
    print(f"cold encode_batch (fresh process, nothing built, 4 threads, LAC_TPU_COLD_BLOCKS=0): bytes == host "
          f"route; {out.strip()}; wall {wall:.1f} s, peak RSS {rss:.0f} MiB")
    return {"launches": pooled.launches, "clips": clips, "refs": refs, "frames": frames,
            "mono": (small["6 mono clips"][2][0][0], wants["6 mono clips"][0]),
            "hires": (small["5 clips at 96 kHz 24-bit"][2][0], wants["5 clips at 96 kHz 24-bit"][0]),
            "pooled_s": runs["pooled"][1][0], "file_by_file_s": runs["file by file"][1][0],
            "pooled_waves": log.walls[: len(waves) // 2]}


# ------------------------------------------------------------ one long file


STREAM_BLOCKS = 2100  # over the CLI's default threshold of 2048 blocks: about 13 minutes


def check_stream(tmp, shapes, batches):
    """A WAV over the CLI's streaming threshold: the route in this process
    (counted) and in fresh processes (peak RSS), beside the in-memory route."""
    for knob in ("LAC_TPU_STREAM_BLOCKS", "LAC_TPU_STREAM_CHUNK_BLOCKS"):
        os.environ.pop(knob, None)
    frames = STREAM_BLOCKS * BLOCK + 4321
    left, right = gliding_stereo(frames, CLIP_RATE, 16, 5)
    wav, lac, back = (os.path.join(tmp, f) for f in ("long.wav", "long.lac", "long-back.wav"))
    check(write_wav_port(wav, left, right, 2, CLIP_RATE, 16), "long file: WAV write failed")
    info = stream.scan_wav(wav)
    check(info is not None and info.frames == frames and -(-frames // BLOCK) >= cli._stream_threshold() > 0,
          "long file: the scan failed or the file is under the streaming threshold")
    mem, mem_s, mem_peak = timed_on_card(lambda: FrameEncoder(12, 2, CLIP_RATE, 16, device="cuda").encode(left, right))
    print(f"long file: {frames} frames, {frames // BLOCK} full blocks, {os.path.getsize(wav) / 1e6:.0f} MB of WAV; "
          f"FrameEncoder.encode in memory {mem_s:.3f} s, {len(mem)} bytes, peak device memory {gib(mem_peak)}")

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    streamed = []
    real = stream.encode_wav_to_lac

    def counted_stream(*args, **kwargs):
        streamed.append(1)
        return real(*args, **kwargs)

    stream.encode_wav_to_lac = counted_stream
    walls = {"streaming": [], "in-memory": []}
    try:
        for route in ("streaming", "in-memory", "in-memory", "streaming"):
            if route == "in-memory":
                os.environ["LAC_TPU_STREAM_BLOCKS"] = "0"
            with Counted(batches) as c:
                rc, wall, peak = timed_on_card(lambda: cli.main(["encode", wav, lac]))
            os.environ.pop("LAC_TPU_STREAM_BLOCKS", None)
            check(rc == 0 and read(lac) == mem, f"long file, {route} route of the CLI: bytes differ from the in-memory encode")
            check(all(c.launches[k] > 0 for k in ENCODE_KERNELS), f"long file, {route} route: a kernel never launched")
            check_accounting(f"long file, {route} route", shapes, c)
            walls[route].append((wall, peak, c))
    finally:
        stream.encode_wav_to_lac = real
    check(len(streamed) == 2, f"the streaming route ran {len(streamed)} times in 4 CLI encodes, want 2")
    for route, turns in walls.items():
        best = min(w for w, _, _ in turns)
        print(f"  CLI encode in this process, {route} route: {' / '.join(f'{w:.3f}' for w, _, _ in turns)} s = "
              f"{frames / best:,.0f} frames/s; {turns[0][2].plans['full']} full-width and {turns[0][2].plans['probe']} "
              f"probe plans; peak device memory {gib(max(p for _, p, _ in turns))}")

    for route, env in (("streaming", {}), ("in-memory", {"LAC_TPU_STREAM_BLOCKS": "0"})):
        os.remove(lac)
        rc, out, wall, rss = run_child(["-m", "lac_tpu_torch.cli", "encode", wav, lac], env)
        check(rc == 0 and read(lac) == mem, f"long file, {route} route in a fresh process ({rc}): bytes differ\n{out}")
        print(f"  python -m lac_tpu_torch.cli encode, {route} route, fresh process: wall {wall:.2f} s = "
              f"{frames / wall:,.0f} frames/s, peak RSS {rss:.0f} MiB")
    rc, out, wall, rss = run_child(["-m", "lac_tpu_torch.cli", "decode", lac, back])
    check(rc == 0, f"long file: CLI decode failed ({rc}):\n{out}")
    pcm = read_wav(back)
    check(np.array_equal(pcm[:, 0], left) and np.array_equal(pcm[:, 1], right), "long file: decoded PCM differs")
    print(f"  streamed bytes == in-memory encode; CLI decode PCM-exact (fresh process: {wall:.2f} s, peak RSS {rss:.0f} MiB)")
    return walls["streaming"][0][2].launches, wav, mem


# ------------------------------------------------------------ the cold CLI


COLD_CLI_CHILD = """
import sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
if sys.argv[1] == "context-first":  # start the CUDA context whatever the input needs
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
t2 = time.perf_counter()
from lac_tpu_torch import cli
rc = cli.main(sys.argv[2:])
t3 = time.perf_counter()
print("import torch %.2f s, context %.2f s, cli.main %.2f s, cuda_initialized=%s"
      % (t1 - t0, t2 - t1, t3 - t2, torch.cuda.is_initialized()))
sys.exit(rc)
"""


def check_cold_cli(tmp):
    """One-shot CLI encodes in fresh processes: an input of at most
    ``LAC_TPU_COLD_BLOCKS`` (``encoder.COLD_BLOCKS``) blocks takes the host
    route and starts no CUDA context, a golden-size WAV and one of 8 full
    blocks alike; one block more, or the 8-block input with
    ``LAC_TPU_COLD_BLOCKS=0``, start one."""
    left, right, sr, depth, _ = golden_cases()["correlated"]
    want = (REPO / "tests" / "golden" / "correlated.lac").read_bytes()
    wav, lac = os.path.join(tmp, "cold.wav"), os.path.join(tmp, "cold.lac")
    check(write_wav_port(wav, left, right, 2, sr, depth), "cold CLI: WAV write failed")

    def encode(args, label, initialized=None, env=None):
        if os.path.exists(lac):
            os.remove(lac)
        rc, out, wall, rss = run_child(args, env)
        with open(lac, "rb") as f:
            check(rc == 0 and f.read() == want, f"cold CLI, {label} ({rc}): bytes differ\n{out}")
        if initialized is not None:
            check(f"cuda_initialized={initialized}" in out, f"cold CLI, {label}: want cuda_initialized={initialized}:\n{out}")
        inner = "; ".join(line for line in out.splitlines() if "cuda_initialized" in line)
        print(f"  {label}: wall {wall:.2f} s, peak RSS {rss:.0f} MiB{'; ' + inner if inner else ''}")

    print(f"cold CLI: {len(left)} frames ({len(left) // BLOCK} full blocks: the host route alone), fresh processes, in turns:")
    probe = ["-c", COLD_CLI_CHILD]
    encode(["-m", "lac_tpu_torch.cli", "encode", wav, lac], "python -m lac_tpu_torch.cli encode")
    encode(probe + ["context-first", "encode", wav, lac], "the same encode after a CUDA context was started", True)
    encode(probe + ["context-first", "encode", wav, lac], "the same encode after a CUDA context was started", True)
    encode(probe + ["as-is", "encode", wav, lac], "the same encode as the CLI runs it: the card never touched", False)

    over = encoder_mod.COLD_BLOCKS + 1
    for blocks in (8, over):
        left, right = gliding_stereo(blocks * BLOCK + 100, 44100, 16, 11)
        want = FrameEncoder(12, 2, 44100, 16, device="cuda").encode_frame(left, right)
        check(write_wav_port(wav, left, right, 2, 44100, 16), "cold CLI: WAV write failed")
        if blocks == 8:
            encode(probe + ["as-is", "encode", wav, lac], "an input of 8 full blocks (the cold route: host)", False)
            encode(probe + ["as-is", "encode", wav, lac], "the same input with LAC_TPU_COLD_BLOCKS=0 (the plane "
                   "pipeline runs)", True, {"LAC_TPU_COLD_BLOCKS": "0"})
        else:
            encode(probe + ["as-is", "encode", wav, lac], f"an input of {over} full blocks (over LAC_TPU_COLD_BLOCKS: "
                   "the plane pipeline runs)", True)


# ------------------------------------------------------------ the service


COLD_SERVE_CHILD = """
import pathlib, sys
from lac_tpu_torch.ops import _cuda_lib
from lac_tpu_torch.runtime import native
root = pathlib.Path(sys.argv[1])
root.mkdir()
_cuda_lib.BUILD_DIR = root / "kernels"  # nothing built yet: the service's first jobs build both
native.BUILD_DIR = root / "runtime"
from lac_tpu_torch import serve
rc = serve.serve(sys.argv[2:])
sys.stderr.write("built in the service: nvcc %.1f s\\n" % _cuda_lib.build_info["seconds"])
sys.exit(rc)
"""


class Wire:
    """A ``serve()`` stdout that keeps each response with its arrival time (s since creation)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.lines = []
        self.buf = ""

    def write(self, text):
        self.buf += text
        while "\n" in self.buf:
            line, self.buf = self.buf.split("\n", 1)
            self.lines.append((time.perf_counter() - self.t0, json.loads(line)))
        return len(text)

    def flush(self):
        pass


def answered(label, lines, n):
    """id -> response of ``lines`` [(s, response)]; every id 1..n answered exactly once."""
    got = {}
    for _, r in lines:
        check(r["id"] not in got, f"{label}: id {r['id']} answered twice")
        got[r["id"]] = r
    check(sorted(got) == list(range(1, n + 1)), f"{label}: answered ids {sorted(got)}, want 1..{n}")
    return got


def at_id(lines, job_id):
    return next(at for at, r in lines if r["id"] == job_id)


def take(path):
    """The file's bytes; the file is deleted (temp space stays small)."""
    with open(path, "rb") as f:
        data = f.read()
    os.remove(path)
    return data


def check_serve(tmp, shapes, batches, batch, long_file):
    """The service on the card: the clip batch through ``serve.serve`` in this
    process, pooled (--workers=4), --workers=4 --no-pool and --workers=1, two
    turns each; a mixed batch; fresh service processes (warm, not warm,
    nothing built); the watchdog on a real wave. Returns the launches of the
    first pooled run."""
    clips, refs, frames = batch["clips"], batch["refs"], batch["frames"]
    d = os.path.join(tmp, "serve")
    os.mkdir(d)
    wavs = [os.path.join(d, f"clip{i}.wav") for i in range(len(clips))]
    with ThreadPoolExecutor(8) as ex:
        check(all(ex.map(lambda i: write_wav_port(wavs[i], *clips[i], 2, CLIP_RATE, 16), range(len(clips)))),
              "service: clip WAV write failed")
    n = len(clips)

    def clip_script(tag, decode=False):
        outs = [os.path.join(d, f"{tag}{i}.lac") for i in range(n)]
        lines = [f"encode {w} {o}" for w, o in zip(wavs, outs)] + ["wait"]
        backs = [os.path.join(d, f"{tag}{i}.wav") for i in range(n)] if decode else []
        lines += [f"decode {o} {b}" for o, b in zip(outs, backs)] + (["wait"] if decode else [])
        return "".join(line + "\n" for line in lines), outs, backs

    def check_outputs(label, outs, backs=(), skip=()):
        bad = [i for i, o in enumerate(outs) if i not in skip and take(o) != refs[i]]
        check(not bad, f"{label}: outputs of clips {bad} differ from the host route")
        for i, b in enumerate(backs):
            pcm = read_wav(b)
            os.remove(b)
            check(np.array_equal(pcm[:, 0], clips[i][0]) and np.array_equal(pcm[:, 1], clips[i][1]),
                  f"{label}: clip {i} decodes through the service to other PCM")

    batchers = []
    real_batcher = serve._PoolBatcher

    class Recorded(real_batcher):
        """The batcher, recorded; with ``hold`` set, a released file's finish
        (tail, assembly, write) waits until no wave runs: a diagnostic that
        keeps host work in Python off the interpreter lock while a wave
        dispatches."""

        hold = False

        def __init__(self, *args, **kwargs):
            self.idle = threading.Event()
            self.idle.set()
            super().__init__(*args, **kwargs)
            batchers.append(self)

        def _begin_wave(self, wave):
            self.idle.clear()
            super()._begin_wave(wave)

        def _end_wave(self):
            super()._end_wave()
            self.idle.set()

        def _finish(self, *args):
            if self.hold:
                self.idle.wait()
            super()._finish(*args)

    serve._PoolBatcher = Recorded  # restored at the end of the mixed batch
    # no graph held: the first turn's waves capture their plans inside the service, its job, batcher, dispatch
    # and finish threads running (check_accounting holds every capture to one warm-up and one capture call)
    plan_graphs.release()
    modes = {"pooled, --workers=4": ["--workers=4"], "--workers=4 --no-pool": ["--workers=4", "--no-pool"],
             "--workers=1": ["--workers=1"], "pooled, finishes held": ["--workers=4"]}
    runs = {name: [] for name in modes}
    try:
        for turn in range(2):
            for name, argv in modes.items():
                Recorded.hold = name.endswith("held")
                script, outs, backs = clip_script(f"t{turn}-", decode=turn == 0)
                wire = Wire()
                with Counted(batches) as c, WaveLog() as waves:
                    rc, _, peak = timed_on_card(lambda: serve.serve(argv, stdin=io.StringIO(script), stdout=wire,
                                                                    device="cuda"))
                check(rc == 0, f"service, {name}: exit code {rc}")
                got = answered(f"service, {name}", wire.lines, 2 * n + 2 if backs else n + 1)
                check(all(r["ok"] for r in got.values()),
                      f"service, {name}: a job failed: {[r for r in got.values() if not r['ok']][:3]}")
                check_outputs(f"service, {name}", outs, backs)
                check_accounting(f"service, {name}", shapes, c)
                pooled = name.startswith("pooled")
                check(bool(waves.walls) == pooled, f"service, {name}: waves {waves.text()}")
                runs[name].append({"wait_s": at_id(wire.lines, n + 1), "peak": peak, "c": c, "waves": waves.walls,
                                   "first_ms": got[1]["ms"]})
    except BaseException:
        serve._PoolBatcher = real_batcher
        raise
    Recorded.hold = False
    captures = [[r["c"].graphs["captures"] for r in turns] for turns in zip(*runs.values())]
    check(sum(captures[0]) > 0 and not any(captures[1]),
          f"service: want the first turn to capture the plan graphs and the second to replay them: {captures}")
    pooled = runs["pooled, --workers=4"]
    check(all(pooled[0]["c"].launches[k] > 0 for k in ENCODE_KERNELS),
          f"service: a kernel never launched: {pooled[0]['c'].launches}")
    print(f"service in this process ({n} clips, {frames} frames, encodes then wait; decodes through the service "
          f"PCM-exact on the first turn; every output == host route; every id answered once; no wave failed):")
    for name, turns in runs.items():
        r0, r1 = turns
        print(f"  {name:22s} {r0['wait_s']:.3f} s first, {r1['wait_s']:.3f} s second = {frames / r1['wait_s']:,.0f} "
              f"frames/s; first job {r0['first_ms']:.1f} / {r1['first_ms']:.1f} ms; {r1['c'].plans['full']} full-width "
              f"and {r1['c'].plans['probe']} probe plans; plan graphs captured {r0['c'].graphs['captures']} / "
              f"{r1['c'].graphs['captures']} ({r0['c'].graphs['capture_s']:.2f} s), replayed "
              f"{r0['c'].graphs['replays']} / {r1['c'].graphs['replays']}; peak device memory {gib(r0['peak'])} / "
              f"{gib(r1['peak'])}")
        for r in turns:
            if r["waves"]:
                print(f"    waves: {', '.join(f'{b} blocks {s:.3f} s' for b, s in r['waves'])}")
    print(f"  encode_pooled in phase 6: {batch['pooled_s']:.3f} s, waves "
          f"{', '.join(f'{b} blocks {s:.3f} s' for b, s in batch['pooled_waves'])}; file by file {batch['file_by_file_s']:.3f} s")

    # a mixed batch: keys of their own, the per-job path, the host route and the streaming route
    (mono, mono_ref), ((hl, hr), hires_ref) = batch["mono"], batch["hires"]
    long_wav, long_ref = long_file
    sub = next(i for i, (l, _) in enumerate(clips) if len(l) < BLOCK)
    mono_wav, hires_wav = os.path.join(d, "mono.wav"), os.path.join(d, "hires.wav")
    check(write_wav_port(mono_wav, mono, np.empty(0, np.int32), 1, CLIP_RATE, 16)
          and write_wav_port(hires_wav, hl, hr, 2, 96000, 24), "service: mixed batch WAV write failed")
    lr_ref = FrameEncoder(12, 0, CLIP_RATE, 16, device="cuda").encode_frame(*clips[4])
    jobs = [(mono_wav, mono_ref, []), (hires_wav, hires_ref, []), (wavs[2], refs[2], []), (wavs[3], refs[3], []),
            (wavs[1], refs[1], ["--debug-threads"]), (wavs[sub], refs[sub], []), (long_wav, long_ref, []),
            (wavs[4], lr_ref, ["--stereo-mode=lr"])]
    outs = [os.path.join(d, f"mixed{i}.lac") for i in range(len(jobs))]
    script = "".join(" ".join(["encode", w, o, *flags]) + "\n" for (w, _, flags), o in zip(jobs, outs)) + "wait\n"
    streamed = []
    real_stream = stream.encode_wav_to_lac

    def counted_stream(*args, **kwargs):
        streamed.append(1)
        return real_stream(*args, **kwargs)

    stream.encode_wav_to_lac = counted_stream
    try:
        wire = Wire()
        with Counted(batches) as c, WaveLog() as waves:
            rc, wall, peak = timed_on_card(lambda: serve.serve(["--workers=4"], stdin=io.StringIO(script), stdout=wire,
                                                               device="cuda"))
    finally:
        stream.encode_wav_to_lac = real_stream
        serve._PoolBatcher = real_batcher
    check(len(batchers) == 5 and all(b.wave_failures == 0 and not b.device_sick for b in batchers),
          f"service: a pooled wave failed ({[b.wave_failures for b in batchers]})")
    got = answered("service, mixed batch", wire.lines, len(jobs) + 1)
    check(rc == 0 and all(r["ok"] for r in got.values()), f"service, mixed batch: {got}")
    bad = [i for i, ((_, want, _), o) in enumerate(zip(jobs, outs)) if take(o) != want]
    check(not bad, f"service, mixed batch: jobs {bad} differ from their references")
    check("Thread usage: " in got[5]["message"], f"service, mixed batch: --debug-threads printed {got[5]}")
    check(len(streamed) == 1, f"service, mixed batch: the streaming route ran {len(streamed)} times, want 1")
    check(len(waves.walls) >= 4, f"service, mixed batch: want a wave per key (4), got {waves.text()}")
    check_accounting("service, mixed batch", shapes, c)
    print(f"service, mixed batch (mono, 96 kHz 24-bit, 16-bit auto and lr clips, --debug-threads, a clip without a "
          f"full block, the 2,100-block WAV): every output == its reference, the long WAV streamed; {wall:.3f} s; "
          f"waves {waves.text()}; peak device memory {gib(peak)}")

    # fresh service processes: warm, not warm, and with nothing built
    script, outs, _ = clip_script("child-")
    stats = {}
    for label, args in (("--warm", ["--warm"]), ("not warm", [])):
        rc, lines, err, wall, rss = run_serve_child(["-m", "lac_tpu_torch.serve", "--workers=4", *args],
                                                    script + "quit\n", n + 1 + bool(args))
        check(rc == 0, f"service process, {label}: exit code {rc}\n{err[-4000:]}")
        got = answered(f"service process, {label}", [(at, r) for at, r in lines if r["id"] != 0], n + 1)
        check(all(r["ok"] for r in got.values()), f"service process, {label}: a job failed")
        check_outputs(f"service process, {label}", outs)
        warm_s = at_id(lines, 0) if args else None
        check(not args or next(r for _, r in lines if r["id"] == 0)["ok"], f"service process, {label}: warm-up failed")
        stats[label] = (warm_s, got[1]["ms"], at_id(lines, n + 1), wall, rss)
    for label, (warm_s, first_ms, wait_s, wall, rss) in stats.items():
        warm_txt = f"warm-up answered at {warm_s:.2f} s, " if warm_s is not None else ""
        print(f"service process, --workers=4 {label}: {warm_txt}first job {first_ms:.1f} ms, wait answered at "
              f"{wait_s:.2f} s ({frames / (wait_s - (warm_s or 0)):,.0f} frames/s after the warm-up), "
              f"wall {wall:.2f} s, peak RSS {rss:.0f} MiB")

    few = min(8, n)
    script = "".join(f"encode {wavs[i]} {outs[i]}\n" for i in range(few)) + "wait\n"
    script += f"decode {outs[0]} {os.path.join(d, 'cold-back.wav')}\nwait\nquit\n"
    rc, lines, err, wall, rss = run_serve_child(["-c", COLD_SERVE_CHILD, os.path.join(tmp, "serve-build"),
                                                 "--workers=4"], script, few + 3)
    check(rc == 0 and "built in the service" in err, f"service with nothing built: exit code {rc}\n{err[-4000:]}")
    got = answered("service with nothing built", lines, few + 3)
    check(all(r["ok"] for r in got.values()), f"service with nothing built: a job failed: {got}")
    check_outputs("service with nothing built", outs[:few], [os.path.join(d, "cold-back.wav")])
    built = next(line for line in err.splitlines() if "built in the service" in line)
    print(f"service with nothing built (g++ and nvcc inside the service, fresh process): every stdout line JSON, "
          f"{few} clips == host route, decode PCM-exact; {built}; wall {wall:.2f} s, peak RSS {rss:.0f} MiB")

    # the watchdog on a real wave: a deadline well under the largest wave's wall
    longest = max(s for r in pooled for _, s in r["waves"])
    timeout = f"{longest / 10:.3f}"
    ref_lac = os.path.join(d, "wd-ref.lac")
    with open(ref_lac, "wb") as f:
        f.write(refs[0])
    back = os.path.join(d, "wd-back.wav")
    script, outs, _ = clip_script("wd-")
    script += f"decode {ref_lac} {back}\nping\n"
    rc, lines, err, wall, rss = run_serve_child(["-m", "lac_tpu_torch.serve", "--workers=4"], script, n + 3,
                                                env={"LAC_TPU_SERVE_DEVICE_TIMEOUT_S": timeout},
                                                linger_s=2 * longest + 5)
    check(rc == 0, f"watchdog: the service exited with {rc}\n{err[-4000:]}")
    got = answered("watchdog", lines, n + 3)
    sick = [i for i in range(n) if not got[i + 1]["ok"]]
    check(sick and all(got[i + 1]["rc"] == 1 and got[i + 1]["error"].startswith(f"device wave exceeded {float(timeout):g}s; ")
                       and not os.path.exists(outs[i]) for i in sick),
          f"watchdog: want sick-card errors and no output for the jobs not released: {[got[i + 1] for i in sick][:3]}")
    check_outputs("watchdog", outs, skip=sick)
    check(got[n + 2]["ok"] and got[n + 3] == {"id": n + 3, "ok": True, "pong": True}, "watchdog: decode or ping failed")
    pcm = read_wav(back)
    check(np.array_equal(pcm[:, 0], clips[0][0]) and np.array_equal(pcm[:, 1], clips[0][1]), "watchdog: decode differs")
    check("device wave exceeded" in err, "watchdog: no stderr line")
    print(f"watchdog (fresh process, deadline {timeout} s, a tenth of the longest wave): {n - len(sick)} jobs released "
          f"before it fired (bytes == host route), {len(sick)} answered with the sick-card error and no output; decode "
          f"PCM-exact and ping answered after it; exit 0, wall {wall:.2f} s, peak RSS {rss:.0f} MiB")
    return pooled[0]["c"].launches

# ------------------------------------------------------------ decode on the card


def restore_operands(frame):
    """Kernel 7's operands for a v3 frame's FIR/LPC lanes, as the device
    backend builds them: (res, coeffs, order, shift, min_pred_n, valid_len)."""
    dec = FrameDecoder()
    hdr, br, payload, sizes, psizes = dec._parse_frame(frame)
    sizes = np.asarray(sizes)
    res, ptype, order, coeffs, _, soffs = device_decode.tokenize(
        hdr, sizes, np.asarray(psizes), dec._v3_payload(br, payload, psizes), int(sizes.sum()))
    _, recur = device_decode.lane_operands(res, sizes, soffs, ptype, order, coeffs)
    return recur[1:]


def q15_taps(rng, order, stable):
    """Taps 1..order of a 33-wide row: contractive (sum |c| < 0.9 * 2^15) or any int16."""
    c = np.zeros(33, np.int32)
    a = int(0.9 * (1 << 15) / order) if stable else (1 << 15) - 1
    c[1 : order + 1] = rng.randint(-a, a + 1, order)
    return c


def adversarial_restore_lanes(L, rng):
    """Kernel 7's operands: five warps of LPC lanes whose orders lie in one
    tap-bound band each (1-4, 5-8, 9-12, 13-16, 17-32: every template runs,
    every order 1..32 is there), half with contractive taps and half with
    any int16 taps, 24-bit residuals in every seventh lane, valid lengths
    L, the order, 1, 0 and L - 5; a warp of FIR lanes with ragged lengths;
    lanes that leave int32 at sample 3, L / 2 and L - 1 and one that doubles
    every step; and five more lanes, so the last warp is ragged."""
    lanes = []
    for lo, hi in ((1, 4), (5, 8), (9, 12), (13, 16), (17, 32)):
        for j in range(32):
            od = lo + j % (hi - lo + 1)
            scale = 1 << 23 if j % 7 == 3 else 3000
            lanes.append((rng.randint(-scale, scale, L), q15_taps(rng, od, j % 2 == 0), od, 15, 0,
                          (L, L, od, 1, 0, L - 5, L)[j % 7]))
    fir = np.zeros(33, np.int32)
    fir[1:3] = (3, -1)
    for j in range(32):
        lanes.append((rng.randint(-30000, 30000, L), fir, 2, 2, 2, (L, 1, 2, 0, L - 3)[j % 5]))
    step = np.zeros(33, np.int32)
    step[1] = 1 << 15  # x[n] = x[n - 1] + r[n]
    for at in (3, L // 2, L - 1):
        res = np.zeros(L, np.int64)
        res[0], res[at] = 1, (1 << 31) - 1
        lanes.append((res, step, 1, 15, 0, L))
    res = np.zeros(L, np.int64)
    res[0] = 1 << 24
    lanes.append((res, step * 2, 1, 15, 0, L))  # x[n] = 2 x[n - 1]
    for od in (3, 9, 14, 21, 32):
        lanes.append((rng.randint(-3000, 3000, L), q15_taps(rng, od, True), od, 15, 0, L))
    res, cs, od, sh, mp, nv = (np.asarray(v) for v in zip(*lanes))
    return res.astype(np.int32), cs.astype(np.int32), *(v.astype(np.int32) for v in (od, sh, mp, nv))


def tile_edge_restore_lanes(L, rng):
    """Kernel 7's operands with events on its tile edges: a warp of the
    12-tap template (tiles of ``K.RESTORE_TILE[12]`` samples), then one of
    the 8-tap template. In each: lanes that leave int32 at a tile's first
    sample, at its last and inside it; one flagged in range (replayed, stays
    alive); one whose step wraps back into int32 (x = 2^32 - 32, caught by
    the flag bound only); LPC lanes with valid lengths k*T - 1, k*T and k*T +
    1; FIR lanes with valid lengths 0, 1, 2 and k*T + 1 (min_pred 2); a lane
    with shift 40 (the careful way) that stops at T + 1; contractive LPC
    lanes up to the template's order for the rest."""
    lanes = []
    step, wrap, fir, big = (np.zeros(33, np.int32) for _ in range(4))
    step[1], wrap[1], fir[1:3] = 1 << 15, 1 << 20, (3, -1)  # x[n] = x[n - 1] + r[n]; 32 x[n - 1] + r[n]
    for h in (12, 8):
        T, warp = K.RESTORE_TILE[h], []
        for at, value in ((3 * T, (1 << 31) - 1), (3 * T - 1, (1 << 31) - 1), (3 * T + T // 2 + 1, (1 << 31) - 1),
                          (2 * T, (1 << 30) + 5)):
            res = np.zeros(L, np.int64)
            res[0], res[at] = 1, value
            warp.append((res, step, 1, 15, 0, L))
        res = np.zeros(L, np.int64)
        res[4 * T - 1] = (1 << 27) - 1
        warp.append((res, wrap, 1, 15, 0, L))
        warp += [(rng.randint(-3000, 3000, L), q15_taps(rng, h, True), h, 15, 0, v)
                 for v in (5 * T - 1, 5 * T, 5 * T + 1)]
        warp += [(rng.randint(-30000, 30000, L), fir, 2, 2, 2, v) for v in (0, 1, 2, 5 * T + 1)]
        big[1:5] = rng.randint(-(1 << 25), 1 << 25, 4)
        warp.append((rng.randint(-(1 << 23), 1 << 23, L), big.copy(), 4, 40, 0, T + 1))
        while len(warp) < 32:
            od = 1 + len(warp) % h
            warp.append((rng.randint(-3000, 3000, L), q15_taps(rng, od, True), od, 15, 0, L))
        lanes += warp
    res, cs, od, sh, mp, nv = (np.asarray(v) for v in zip(*lanes))
    return res.astype(np.int32), cs.astype(np.int32), *(v.astype(np.int32) for v in (od, sh, mp, nv))


def template_of(order, alive):
    """csrc/restore.cu's template of each warp: the tap bound of its live lanes' largest order."""
    return [next(h for h in K.RESTORE_TEMPLATES if h >= int(np.where(alive, order, 0)[w : w + 32].max()))
            for w in range(0, len(order), 32)]


def check_restore(files, rng):
    """Kernel 7 bit-exact against its plain version (every lane's samples and
    ok flag) at the path's shapes, the FIR/LPC lanes of each of ``files``
    [(label, frame)], and on adversarial and tile-edge lanes; the path's
    shapes timed (CUDA graph of 20 launches between CUDA events; the plain
    version once, without a graph, as it is a loop of L steps) beside the
    bound, the chain floor (the same residuals with every lane at order 1,
    measured) and the serial floor estimated from the source (both printed,
    not in the record). Returns the kernel record (the first file's lanes)."""
    cases = [(f"{label}: FIR/LPC lanes", restore_operands(frame), True) for label, frame in files]
    cases += [("adversarial lanes at L = 4096", adversarial_restore_lanes(4096, rng), False),
              ("adversarial lanes at L = 1001", adversarial_restore_lanes(1001, rng), False),
              ("tile-edge lanes at L = 4096", tile_edge_restore_lanes(4096, rng), False),
              ("tile-edge lanes at L = 4098 (rows not 16-byte aligned)", tile_edge_restore_lanes(4098, rng), False)]
    err, shapes = 0, []  # the timed shapes, the record's first
    for label, ops, timed in cases:
        t = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in ops]
        t[1] = t[1].to(torch.int32)  # the wrapper then converts nothing: the graph holds kernel 7 alone
        (got, ok), (want, w_ok) = K.recurrence_restore(*t), K.recurrence_restore_plain(*t)
        torch.cuda.synchronize()
        lanes, L = t[0].shape
        check(torch.equal(ok, w_ok), f"{RESTORE} {label}: ok flags differ from the plain version")
        err = max(err, int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item()))
        check(err == 0, f"{RESTORE} {label}: kernel differs from its plain version (max |diff| {err})")
        order, valid = ops[2], np.minimum(ops[5], L)
        alive = (order >= 0) & (order <= K.MAX_ORDER) & (ops[3] >= 0) & (ops[3] < 64)
        bands = sorted(set(template_of(order, alive)))
        print(f"  {RESTORE:22s} {label} ({lanes}, {L}): exact on every lane; {int((~ok).sum())} lanes rejected; "
              f"templates {bands}")
        if label.startswith("tile-edge"):
            check(bands == [8, 12] and int((~ok).sum()) == 8, f"{label}: want templates 8 and 12 and 8 lanes that "
                  f"leave int32")
            continue
        if not timed:
            check(bands == list(K.RESTORE_TEMPLATES) and 0 < int((~ok).sum()) < lanes, f"{label}: want every "
                  f"template run and some rejected lanes")
            continue
        check(bool(ok.all()), f"{label}: a lane of a real file was rejected")
        kern = lambda _: K.recurrence_restore(*t)  # noqa: E731
        ms = min(time_ms(kern, None), time_ms(kern, None))
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        K.recurrence_restore_plain(*t)
        stop.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(stop)
        ops_count = int((valid.astype(np.int64) * (OPS_PER_ELEMENT[RESTORE] + OPS_PER_TAP * order)).sum())
        bound_ms, bound_by = bound(RESTORE, t, (got, ok), ops=ops_count)
        floor_ms = L * SERIAL_CYCLES_PER_STEP / SM_CLOCK_HZ * 1e3  # an estimate, printed only
        # the measured chain floor: the same residuals with every lane at order 1 (its chain and nothing else)
        one = q15_taps(rng, 1, True)
        chain = [t[0], torch.from_numpy(np.tile(one, (lanes, 1))).cuda(),
                 *(torch.full_like(t[2], v) for v in (1, 15, 0)), t[5]]
        check(all(torch.equal(a, b) for a, b in zip(K.recurrence_restore(*chain), K.recurrence_restore_plain(*chain))),
              f"{label}, every lane at order 1: kernel differs from its plain version")
        chain_ms = min(time_ms(lambda _: K.recurrence_restore(*chain), None) for _ in range(2))
        shapes.append({"label": label, "lanes": lanes, "L": L, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by})
        print(f"    kernel {ms:.4f} ms = {ms * 1e-3 * SM_CLOCK_HZ / L:.1f} cycles a sample at "
              f"{SM_CLOCK_HZ / 1e9:.2f} GHz, plain {plain_ms:.1f} ms (one call, no graph), bound {bound_ms:.4f} ms "
              f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound; chain floor measured {chain_ms:.4f} ms (every "
              f"lane at order 1, bit-exact: {chain_ms * 1e-3 * SM_CLOCK_HZ / L:.1f} cycles a sample), "
              f"{100 * chain_ms / ms:.0f}% of it; estimated {floor_ms:.4f} ms ({L} steps x {SERIAL_CYCLES_PER_STEP} "
              f"cycles, from the source), {100 * floor_ms / ms:.0f}% of it (CUDA graph of 20 launches, CUDA events)")
    return {"max_abs_err": float(err), "library_ms": None,
            **{k: shapes[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}


def decode_breakdown(dec, frame):
    """Where a warm device-backend decode of ``frame`` spends its wall: the
    steps of ``dec.decode``'s v3 device route called one by one and each
    timed where it runs (host clock, the card synchronised after each),
    beside the wall of one whole ``dec.decode(frame)``."""
    steps = {}

    def step(label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[label] = time.perf_counter() - t0
        return out

    def parse():
        hdr, br, payload, sizes, psizes = dec._parse_frame(frame)
        return hdr, np.asarray(sizes), np.asarray(psizes), dec._v3_payload(br, payload, psizes)

    hdr, sizes, psizes, body = step("frame parse (host)", parse)
    res, ptype, order, coeffs, msflag, offs = step(
        "tokenize (native, host threads)", lambda: device_decode.tokenize(hdr, sizes, psizes, body, int(sizes.sum())))
    lanes = step("lane gather (numpy)", lambda: device_decode.lane_operands(res, sizes, offs, ptype, order, coeffs))
    restored = step("restore: uploads, masked cumsums and kernel 7 on the card, int32 copies back",
                    lambda: device_decode.restore_lanes(*lanes, dec.device))
    planes = step("scatter (numpy)", lambda: device_decode.scatter(res, sizes, offs, restored))
    step("mid/side inverse, PCM range check (numpy)", lambda: device_decode.finish(hdr, planes, sizes, msflag))
    _, wall, _ = timed_on_card(lambda: dec.decode(frame))
    return steps, wall


def check_decode(files, batch, batches):
    """The device decode backend on phase 4's files, phase 6's clips, the
    goldens, ``decode_range`` and a corrupt block. Returns the launches of
    the device decodes of phase 4's files (the decode path)."""
    device, native_dec = FrameDecoder(backend="device"), FrameDecoder()

    def equal(got, left, right):
        return np.array_equal(got[0], left) and np.array_equal(got[1], right)

    with Counted(batches) as path:
        per_file = []
        for label, frame, left, right in files:
            before = K.launches[RESTORE]
            got, wall, peak = timed_on_card(lambda: device.decode(frame))
            check(equal(got, left, right), f"device decode, {label}: PCM differs from the input")
            per_file.append((K.launches[RESTORE] - before, wall, peak))
    check(path.launches[RESTORE] > 0 and all(path.launches[k] == 0 for k in ENCODE_KERNELS),
          f"device decode: want kernel 7 and no planner kernel, got {path.launches}")
    print(f"device decode ({len(files)} files, PCM-equal to the input and to the native decode; walls of the second "
          f"pass, native then device; frames/s):")
    for (label, frame, left, right), (n, first_s, peak) in zip(files, per_file):
        walls = {}
        for name, dec in (("native", native_dec), ("device", device), ("device", device), ("native", native_dec)):
            got, wall, _ = timed_on_card(lambda: dec.decode(frame))
            check(equal(got, left, right), f"{name} decode, {label}: PCM differs from the input")
            walls.setdefault(name, []).append(wall)
        nat, dev = min(walls["native"]), min(walls["device"])
        print(f"  {label:44s} {len(left)} frames: native {nat:.3f} s = {len(left) / nat:,.0f} frames/s, device "
              f"{dev:.3f} s = {len(left) / dev:,.0f} frames/s (first {first_s:.3f} s), device/native {dev / nat:.2f}; "
              f"kernel 7 launches {n}; peak device memory {gib(peak)}")
    steps, wall = decode_breakdown(device, files[0][1])
    print(f"  where a warm device decode of the {files[0][0]} goes (each step alone, host clock, card synchronised "
          f"after each): " + "; ".join(f"{k} {v:.3f} s" for k, v in steps.items())
          + f"; sum {sum(steps.values()):.3f} s, one whole decode {wall:.3f} s")

    # the clip batch
    clips, refs, frames = batch["clips"], batch["refs"], batch["frames"]
    walls = {"native decode_batch": [], "device, file by file": []}
    for turn in range(2):
        got, wall, peak = timed_on_card(lambda: decode_batch(refs))
        check(all(equal(g, l, r) for g, (l, r) in zip(got, clips)), "clip batch: native decode_batch differs")
        walls["native decode_batch"].append(wall)
        with Counted(batches) as c:
            got, wall, peak = timed_on_card(lambda: [device.decode(f) for f in refs])
        check(all(equal(g, l, r) for g, (l, r) in zip(got, clips)), "clip batch: a device decode differs")
        walls["device, file by file"].append(wall)
    print(f"clip batch through the device backend: {len(clips)} clips PCM-exact; kernel 7 launches {c.launches[RESTORE]}; "
          f"peak device memory {gib(peak)}; "
          + "; ".join(f"{k} {w[0]:.3f} s first, {w[1]:.3f} s second = {frames / w[1]:,.0f} frames/s"
                      for k, w in walls.items()))

    # the goldens through all three backends
    decoders = {"native": native_dec, "python": FrameDecoder(backend="python"), "device": device}
    signals = golden_cases()
    for name, (left, right, *_) in sorted(signals.items()):
        frame = (REPO / "tests" / "golden" / f"{name}.lac").read_bytes()
        for backend, dec in decoders.items():
            check(equal(dec.decode(frame), left, right), f"golden {name}: the {backend} backend's PCM differs")
    print(f"goldens: {len(signals)} decode PCM-exact through the native, python and device backends")

    # decode_range on the 3-minute file of filtered noise
    label, frame, left, right = files[0]
    rng = np.random.RandomState(81)
    edges = rng.choice(np.arange(BLOCK, len(left), BLOCK), 20, replace=False)
    ranges = [(int(e) - int(a), min(int(a + b), len(left) - int(e) + int(a)))
              for e, (a, b) in zip(edges, rng.randint(1, 4000, (20, 2)))]
    for backend, dec in decoders.items():
        t0 = time.perf_counter()
        for start, count in ranges:
            got = dec.decode_range(frame, start, count)
            check(equal(got, left[start : start + count], right[start : start + count]),
                  f"decode_range [{start}, {start + count}), {backend} backend: differs from the slice")
        print(f"decode_range, {label}: 20 seeded ranges across block edges, {backend} backend == slices of the "
              f"full decode ({time.perf_counter() - t0:.2f} s)")

    # a corrupt block is named by the device backend's error
    hdr, br, payload, sizes, psizes = native_dec._parse_frame(frame)
    bad = len(sizes) // 2
    at = len(frame) - sum(psizes) + sum(psizes[:bad]) + 1  # after the stereo flag: the predictor type, now > 2
    corrupt = bytearray(frame)
    corrupt[at] ^= 0xFF
    try:
        device.decode(bytes(corrupt))
        raise RuntimeError(f"chip_smoke: device decode accepted a corrupt block {bad}")
    except DecodeError as e:
        check(str(e) == f"[decode-error] block={bad}", f"device decode of a corrupt block {bad}: {e}")
        print(f"corrupt stream: the device backend raises DecodeError('{e}')")
    return path.launches


# ------------------------------------------------------------ the group route


GROUP_BLOCKS = 7  # full blocks of phase 13's cuts: under device_pipeline.MIN_FULL_BLOCKS
NO_NATIVE_GOLDENS = ("sine-auto", "sparse", "noise24", "silence")  # as tests/test_no_native.py


def group_inputs(with_3min=False):
    """Phase 4's inputs cut under 8 full blocks (the plane pipeline leaves them
    to the group route), made from their seeds: [(label, stereo mode, rate,
    depth, left, right)]; the whole 3-minute file first with ``with_3min``."""
    label, sr, depth, frames, seed = FILES[0]
    left, right = gliding_stereo(frames, sr, depth, seed)
    hl, hr = gliding_stereo(5 * BLOCK + 9000, 96000, 24, FILES[1][4])
    nl, nr = filtered_noise_stereo(GROUP_BLOCKS * BLOCK + 5555, 44100, 16, 3)
    cl, cr = gliding_stereo(30 * 44100, 44100, 16, 0xC0DEC)
    cut = GROUP_BLOCKS * BLOCK + 1234
    out = [(label, 2, sr, depth, left, right)] if with_3min else []
    out += [("3 min file, first 7 blocks + 1234, auto", 2, sr, depth, left[:cut], right[:cut]),
            ("60 s 96 kHz 24-bit recipe, 5 blocks + 9000, auto", 2, 96000, 24, hl, hr),
            ("mono, 7 blocks + 1234", 0, sr, depth, left[:cut], ()),
            ("forced ms, 7 blocks + 1234", 1, sr, depth, left[:cut], right[:cut]),
            ("forced lr, 7 blocks + 1234", 0, sr, depth, left[:cut], right[:cut]),
            ("filtered noise, 7 blocks + 5555, auto", 2, 44100, 16, nl, nr),
            ("30 s corpus, first 3 blocks + 777, auto", 2, 44100, 16, cl[:3 * BLOCK + 777], cr[:3 * BLOCK + 777])]
    return out


def out_of_domain_groups():
    """16384-sample lane groups outside the 24-bit domain, after
    tests/test_ladder.py: filtered noise at 1.9e9, glitched sines (a
    full-scale glitch in a 2e9 sine) and a group that mixes them with
    16-bit noise, so that in-range and ladder lanes are spliced."""
    rng = np.random.RandomState(99)
    x = rng.standard_normal(BLOCK)
    for _ in range(3):
        x = 0.7 * x + 0.3 * np.concatenate([[0.0], x[:-1]])
    ood = np.clip(x * 1.9e9, -2**31, 2**31 - 1).astype(np.int64).astype(np.int32)

    def glitched(seed):
        r = np.random.RandomState(seed)
        t = np.arange(BLOCK)
        y = np.sin(2 * np.pi * r.uniform(0.002, 0.3) * t + r.uniform(0, 6)) * r.uniform(1.5e9, 2.1e9)
        y += r.standard_normal(BLOCK) * r.uniform(1e3, 1e6)
        pcm = np.clip(y, -2**31, 2**31 - 1).astype(np.int64).astype(np.int32)
        pcm[r.randint(100, BLOCK - 20)] = np.int32(r.choice([-2**31, 2**31 - 1]))
        return pcm

    sines = np.stack([glitched(s) for s in (10, 17, 27, 36, 133, 141)])
    noise = np.random.RandomState(3).randint(-20000, 20000, (3, BLOCK)).astype(np.int32)
    return [("out of the 24-bit domain (1 lane)", ood[None]), ("glitched sines (6 lanes)", sines),
            ("mixed (noise, glitched, noise, noise, out of domain)",
             np.stack([noise[0], sines[2], noise[1], noise[2], ood]))]


NO_NATIVE_CHILD = r"""
import json, pathlib, sys, time
import numpy as np
import torch
import chip_smoke as cs
from lac_tpu_torch import encoder
from lac_tpu_torch.decoder import FrameDecoder
from lac_tpu_torch.encoder import FrameEncoder
from lac_tpu_torch.runtime import native
from tests.signals import cases as golden_cases

assert not native.native_available(), "LAC_TPU_NO_NATIVE=1 must turn the native runtime off"
want = pathlib.Path(sys.argv[1])
ships = []  # bytes of every ship copy: one per device batch
fetched = encoder._GroupJob._fetched

def counted(job, key):
    out = fetched(job, key)
    if key == "ship":
        ships.append(out.nbytes)
    return out

encoder._GroupJob._fetched = counted
inputs = [(lbl, m, sr, d, l, r) for lbl, m, sr, d, l, r in cs.group_inputs(with_3min=True)]
goldens = golden_cases()
inputs += [("golden " + n, goldens[n][4] if len(goldens[n][1]) else 0, goldens[n][2], goldens[n][3],
            goldens[n][0], goldens[n][1]) for n in cs.NO_NATIVE_GOLDENS]
for i, (label, mode, sr, depth, left, right) in enumerate(inputs):
    del ships[:]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got = FrameEncoder(12, mode, sr, depth, device="cuda").encode(left, right)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    assert got == (want / f"{i}.lac").read_bytes(), f"{label}: bytes differ from the native route's"
    t0 = time.perf_counter()
    dl, dr, _ = FrameDecoder().decode(got)
    dec_s = time.perf_counter() - t0
    assert np.array_equal(dl, left) and np.array_equal(dr, np.asarray(right, np.int32)), f"{label}: decode differs"
    print("NONATIVE " + json.dumps({"label": label, "encode_s": enc_s, "decode_s": dec_s, "ship_bytes": list(ships),
                                    "peak": torch.cuda.max_memory_allocated()}), flush=True)
assert "lac_tpu" not in sys.modules and "jax" not in sys.modules
"""

TIMING_CHILD = r"""
import chip_smoke as cs
from lac_tpu_torch.encoder import FrameEncoder
from lac_tpu_torch.profile_encode import gliding_stereo
left, right = gliding_stereo(30 * 44100, 44100, 16, 0xC0DEC)
FrameEncoder(12, 2, 44100, 16, device="cuda").encode(left, right)  # the plane pipeline
label, mode, sr, depth, left, right = cs.group_inputs()[0]
FrameEncoder(12, mode, sr, depth, device="cuda").encode(left, right)  # 7 blocks: the host route
"""
PIPELINE_PHASES = ("plane_pipeline", "plane_upload", "analyze", "flags_fetch", "host_ld", "plan_dispatch",
                   "meta_fetch", "emit_prep", "native_emit", "stereo_estimate", "lane_build", "assembly")
HOST_PHASES = ("stereo_estimate", "lane_build", "group_stage", "plan_numpy", "native_emit", "assembly")
GROUP_PHASES = ("stereo_estimate", "lane_build", "group_stage", "h2d_upload", "autocorr_fetch", "host_ld",
                "plan_dispatch", "meta_fetch", "ship_fetch", "host_emit", "assembly")  # the no-native child's


def check_group_route(tmp, shapes, batches):
    """Phase 13: the group route on the card. Returns its launches."""
    t13 = time.perf_counter()
    clips = make_clips()
    inputs = group_inputs() + [(f"clip of {len(l)} frames ({len(l) // BLOCK} full blocks)", 2, CLIP_RATE, 16, l, r)
                               for l, r in clips if len(l) // BLOCK < device_pipeline.MIN_FULL_BLOCKS]
    launches = {k: 0 for k in K.launches}
    group_plans = {"group-full": 0, "group-probe": 0}

    def add(c):
        for k in launches:
            launches[k] += c.launches[k]
        for k in group_plans:
            group_plans[k] += c.plans[k]

    # FrameEncoder.encode leaves these inputs' lanes to the host route while the native runtime is
    # there: no plan and no launch on the card. The lanes themselves go through the group route on the
    # card, ChannelBlockEncoder(device="cuda").encode_lanes, against the host route's encode_lanes.
    real_lanes = ChannelBlockEncoder.encode_lanes
    seen = []

    def recording(enc, data_list):
        out = real_lanes(enc, data_list)
        seen.append((list(data_list), out))
        return out

    print("inputs under 8 full blocks, warm, host then card: FrameEncoder.encode against "
          "encode_frame; their lanes through the group route on the card (ChannelBlockEncoder(device='cuda')."
          "encode_lanes) against the host route (ChannelBlockEncoder().encode_lanes):")
    for label, mode, sr, depth, left, right in inputs:
        walls = {"frame host": [], "frame card": [], "lanes host": [], "lanes card": []}
        del seen[:]
        ChannelBlockEncoder.encode_lanes = recording
        try:
            ref = FrameEncoder(12, mode, sr, depth, device="cuda").encode_frame(left, right)
        finally:
            ChannelBlockEncoder.encode_lanes = real_lanes
        check(len(seen) == 1, f"{label}: want one encode_lanes call on the host route, got {len(seen)}")
        lanes, want = seen[0]
        for route in ("host", "card"):
            enc = FrameEncoder(12, mode, sr, depth, device="cuda")
            fn = enc.encode_frame if route == "host" else enc.encode
            with Counted(batches) as c:
                got, wall, _ = timed_on_card(lambda: fn(left, right))
            walls[f"frame {route}"].append(wall)
            check(got == ref, f"{label}: FrameEncoder.encode bytes differ from the host route's ({route})")
            check(sum(c.plans.values()) == 0 and not any(c.launches.values()),
                  f"{label}: FrameEncoder.{fn.__name__} used the card: {c.plans}, {c.launches}")
            cbe = ChannelBlockEncoder(device="cuda") if route == "card" else ChannelBlockEncoder()
            with Counted(batches) as c:
                got, wall, peak = timed_on_card(lambda: cbe.encode_lanes(lanes))
            walls[f"lanes {route}"].append(wall)
            check(got == want, f"group route, {label}: lane bytes differ from the host route's ({route})")
            if route == "card":
                check(c.plans["full"] == c.plans["probe"] == 0, f"{label}: the plane pipeline ran: {c.plans}")
                check(c.plans["group-full"] + c.plans["group-probe"] > 0, f"{label}: no group plan on the card")
                check_accounting(f"group route, {label}", shapes, c)
                add(c)
                first = (c.plans, peak)
        lens = sorted({len(x) for x in lanes})
        print(f"  {label}: {len(left)} frames, {len(lanes)} lanes of {lens} samples; bytes == host route; "
              f"group plans {first[0]['group-full']} full-width, {first[0]['group-probe']} probe, peak device "
              f"memory {gib(first[1])}; FrameEncoder.encode {' / '.join(f'{w:.3f}' for w in walls['frame card'])} "
              f"s, encode_frame {' / '.join(f'{w:.3f}' for w in walls['frame host'])} s; lanes on the card "
              f"{' / '.join(f'{w:.3f}' for w in walls['lanes card'])} s, on the host "
              f"{' / '.join(f'{w:.3f}' for w in walls['lanes host'])} s")

    # full batches at the device caps, 128 lanes of 16384 and 1024 probe lanes of 256 (the 3-minute
    # recipe's first blocks): where the card's group plans would have to win
    left, right = gliding_stereo(64 * BLOCK, FILES[0][1], FILES[0][2], FILES[0][4])
    caps = [("128 lanes of 16384", np.concatenate([left, right]).reshape(128, BLOCK)),
            ("1024 lanes of 256", left[: 1024 * 256].reshape(1024, 256))]
    for label, group in caps:
        walls = {"host": [], "card": []}
        for route in ("host", "card"):
            cbe = ChannelBlockEncoder(device="cuda") if route == "card" else ChannelBlockEncoder()
            with Counted(batches) as c:
                got, wall, peak = timed_on_card(lambda: cbe.encode_group(group))
            walls[route].append(wall)
            if route == "host":
                want = got
                continue
            check(got == want, f"group route, {label}: bytes differ from the host route's ({route})")
            if route == "card":
                check(sum(c.plans[k] for k in group_plans) == 1, f"group route, {label}: want one batch: {c.plans}")
                check_accounting(f"group route, {label}", shapes, c)
                add(c)
                cap_peak = peak
        print(f"  one batch at the cap, {label}: bytes == host route; card "
              f"{' / '.join(f'{w:.3f}' for w in walls['card'])} s, host {' / '.join(f'{w:.3f}' for w in walls['host'])}"
              f" s; peak device memory {gib(cap_peak)}")
    check(all(launches[k] > 0 for k in ENCODE_KERNELS), f"group route: a kernel never launched: {launches}")
    print(f"group route: {group_plans['group-full']} full-width and {group_plans['group-probe']} probe plan "
          f"batches; launches {launches}")

    goldens = golden_cases()
    for name, (left, right, sr, depth, smode) in sorted(goldens.items()):
        got = FrameEncoder(12, smode if len(right) else 0, sr, depth, device="cuda").encode(left, right)
        check(got == (REPO / "tests" / "golden" / f"{name}.lac").read_bytes(),
              f"group route, golden {name}: bytes differ from tests/golden/{name}.lac")
    print(f"group route: the {len(goldens)} goldens through FrameEncoder.encode on the card == tests/golden/*.lac")

    # lanes outside the 24-bit domain: int32 upload, exact lags, the order ladder
    replanned = []
    real_replan = encoder_mod._GroupJob._ladder_replan

    def counted_replan(job, pcm_rows, *args):
        if job.on_device:
            replanned.append(pcm_rows.shape[0])
        return real_replan(job, pcm_rows, *args)

    encoder_mod._GroupJob._ladder_replan = counted_replan
    try:
        for label, group in out_of_domain_groups():
            want = ChannelBlockEncoder().encode_group(group)
            del replanned[:]
            with Counted(batches) as c:
                got = ChannelBlockEncoder(device="cuda").encode_group(group)
            check(got == want, f"group route, {label}: bytes differ from the host route's")
            check(sum(replanned) > 0, f"group route, {label}: no lane of the card's batch walked the ladder")
            check(c.plans["group-full"] == 1, f"group route, {label}: want one plan batch on the card, got {c.plans}")
            check_accounting(f"group route, {label}", shapes, c)
            for k in launches:
                launches[k] += c.launches[k]
            print(f"  ChannelBlockEncoder(device='cuda'), {label}: bytes == host route ({sum(map(len, got))} bytes); "
                  f"{sum(replanned)} of {len(group)} lanes replanned down the order ladder")
    finally:
        encoder_mod._GroupJob._ladder_replan = real_replan

    # a fresh process with LAC_TPU_NO_NATIVE=1: the token route, bytes those of the native route above
    want_dir = pathlib.Path(tmp) / "no-native"
    want_dir.mkdir()
    nn_inputs = group_inputs(with_3min=True)
    nn_inputs += [(n, goldens[n][4] if len(goldens[n][1]) else 0, goldens[n][2], goldens[n][3], goldens[n][0],
                   goldens[n][1]) for n in NO_NATIVE_GOLDENS]
    for i, (label, mode, sr, depth, left, right) in enumerate(nn_inputs):
        (want_dir / f"{i}.lac").write_bytes(FrameEncoder(12, mode, sr, depth, device="cuda").encode(left, right))
    rc, out, wall, rss = run_child(["-c", NO_NATIVE_CHILD, str(want_dir)],
                                   {"LAC_TPU_NO_NATIVE": "1", "LAC_TPU_TIMING": "1"}, limit_s=400)
    rows = [json.loads(line[9:]) for line in out.splitlines() if line.startswith("NONATIVE ")]
    check(rc == 0 and len(rows) == len(nn_inputs), f"LAC_TPU_NO_NATIVE=1 child failed ({rc}):\n{out[-4000:]}")
    timing = [line for line in out.splitlines() if line.startswith("[lac-timing] ")]
    have = {p.split("=")[0] for line in timing for p in line.split(": ", 1)[1].split(" (sum")[0].split()}
    check(len(timing) == len(nn_inputs) and set(GROUP_PHASES) <= have,
          f"LAC_TPU_NO_NATIVE=1 with LAC_TPU_TIMING=1: want one [lac-timing] line per encode with "
          f"{sorted(set(GROUP_PHASES) - have)} too:\n{out[-4000:]}")
    print(f"LAC_TPU_NO_NATIVE=1 and LAC_TPU_TIMING=1, fresh process on the card: {len(rows)} inputs == the "
          f"native route's bytes, Python-reader decodes PCM-exact; wall {wall:.1f} s, peak RSS {rss:.0f} MiB; "
          f"the group route's timing line of the 3-minute file: {timing[0] if timing else None}")
    for r in rows:
        ships = r["ship_bytes"]
        ship_txt = f"{len(ships)} ship copies of {min(ships)}-{max(ships)} bytes" if ships else "no ship copy"
        print(f"  {r['label']}: encode {r['encode_s']:.3f} s, decode {r['decode_s']:.3f} s; {ship_txt}; "
              f"peak device memory {gib(r['peak'])}")

    # LAC_TPU_TIMING=1: one [lac-timing] line per encode, with the phases of each route
    # LAC_TPU_COLD_BLOCKS=0: the fresh process's first encode (81 blocks) must reach the card
    rc, out, wall, _ = run_child(["-c", TIMING_CHILD], {"LAC_TPU_TIMING": "1", "LAC_TPU_COLD_BLOCKS": "0"})
    lines = [line for line in out.splitlines() if line.startswith("[lac-timing] ")]
    check(rc == 0 and len(lines) == 2, f"LAC_TPU_TIMING=1: want two [lac-timing] lines ({rc}):\n{out[-4000:]}")
    for line, names in zip(lines, (PIPELINE_PHASES, HOST_PHASES)):
        have = {p.split("=")[0] for p in line.split(": ", 1)[1].split(" (sum")[0].split()}
        check(set(names) <= have, f"LAC_TPU_TIMING=1: {sorted(set(names) - have)} missing from {line}")
        print(f"  {line}")
    print(f"phase 13 (the group route): {time.perf_counter() - t13:.1f} s")
    return launches


# ------------------------------------------------------------ the mesh


MESH_CLI_CHILD = """
import json, os, sys, time
t0 = time.perf_counter()
import torch
from lac_tpu_torch import cli
from lac_tpu_torch.ops import cuda_kernels as K
from lac_tpu_torch.parallel import default_mesh
t1 = time.perf_counter()
mesh = default_mesh() if os.environ.get("LAC_TPU_CLI_MESH") == "1" else None  # what the CLI may take
if sys.argv[1] == "contexts-first":  # start the cards' CUDA contexts before the encode
    for i in range(min(2, torch.cuda.device_count()) if mesh else 1):
        torch.zeros(1, device=f"cuda:{i}")
        torch.cuda.synchronize(i)
t2 = time.perf_counter()
rc = cli.main(sys.argv[2:])
t3 = time.perf_counter()
print("MESH " + json.dumps({"mesh": [str(d) for d in mesh or ()],
                            "card_launches": {str(k): sum(v.values()) for k, v in sorted(K.card_launches.items())},
                            "import_s": t1 - t0, "contexts_s": t2 - t1, "cli_s": t3 - t2}))
sys.exit(rc)
"""


class ChunkTimeline:
    """CUDA events around every chunk's analyze and plan stages, by card, put
    on the host's clock: each card gets an origin event recorded on its idle
    stream at a known host time (``_ChunkJob``'s stages wrapped on entry,
    restored on exit)."""

    def __init__(self, cards):
        self.cards = cards

    def __enter__(self):
        self.marks = []
        self.origins = {}
        for i in self.cards:
            torch.cuda.synchronize(i)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(i))
            torch.cuda.synchronize(i)
            self.origins[i] = (ev, time.perf_counter())
        guard = threading.Lock()
        self.real = {name: getattr(device_pipeline._ChunkJob, name) for name in ("dispatch_analyze", "dispatch_plan")}

        def wrap(name, real):
            def run(job):
                stream = torch.cuda.current_stream(job.device)
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record(stream)
                out = real(job)
                stop.record(stream)
                with guard:
                    self.marks.append((id(job), job.device.index, name, start, stop))
                return out
            return run

        for name, real in self.real.items():
            setattr(device_pipeline._ChunkJob, name, wrap(name, real))
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(device_pipeline._ChunkJob, name, real)

    def chunks(self):
        """[(card, start s, end s)] per chunk, analyze start to plan end, on the host clock."""
        for i in self.cards:
            torch.cuda.synchronize(i)
        spans = {}
        for key, card, name, start, stop in self.marks:
            origin, at = self.origins[card]
            s, e = at + origin.elapsed_time(start) / 1e3, at + origin.elapsed_time(stop) / 1e3
            lo, hi = spans.get(key, (card, s, e))[1:]
            spans[key] = (card, min(lo, s), max(hi, e))
        return list(spans.values())


def overlap_report(chunks):
    """(overlapping pairs of chunks on different cards, seconds with two or
    more cards inside a chunk, seconds with any card inside one)."""
    pairs = sum(1 for i, (c1, s1, e1) in enumerate(chunks) for c2, s2, e2 in chunks[i + 1:]
                if c1 != c2 and min(e1, e2) > max(s1, s2))
    points = sorted({t for _, s, e in chunks for t in (s, e)})
    both = anyone = 0.0
    for a, b in zip(points, points[1:]):
        inside = {c for c, s, e in chunks if s <= a and e >= b}
        anyone += (b - a) if inside else 0.0
        both += (b - a) if len(inside) >= 2 else 0.0
    return pairs, both, anyone


def busy_by_card(fn, cards):
    """(``fn()``'s result, wall s, card -> device-busy seconds) of a run under
    torch.profiler with CUDA activity: the union of each card's kernel and copy
    intervals. Only a profiler that cannot start is let pass (busy None, the
    run unprofiled); whatever ``fn`` raises goes to the caller."""
    try:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    except Exception as e:  # noqa: BLE001 — a measurement, not a check: say it was not measured
        print(f"  busy share not measured (torch.profiler did not start: {type(e).__name__}: {e})")
        prof = None
    t0 = time.perf_counter()
    try:
        out = fn()
        for i in cards:
            torch.cuda.synchronize(i)
        wall = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.stop()
    if prof is None:
        return out, wall, None
    cuda = torch.autograd.DeviceType.CUDA
    busy = {}
    for i in cards:
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == cuda and e.device_index == i)
        total, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                total, end = total + b - a, b
            elif b > end:
                total, end = total + b - end, b
        busy[i] = total / 1e6
    return out, wall, busy


def mesh_inputs(tmp):
    """Phase 12's inputs when it runs alone: the 3-minute file, the clips and
    the long WAV, each with its one-card bytes."""
    label, sr, depth, frames, seed = FILES[0]
    left, right = gliding_stereo(frames, sr, depth, seed)
    cd = (left, right, FrameEncoder(12, 2, sr, depth, device="cuda").encode_frame(left, right))
    clips = make_clips()
    refs = [FrameEncoder(12, 2, CLIP_RATE, 16, device="cuda").encode_frame(l, r) for l, r in clips]
    long_left, long_right = gliding_stereo(STREAM_BLOCKS * BLOCK + 4321, CLIP_RATE, 16, 5)
    wav = os.path.join(tmp, "long.wav")
    check(write_wav_port(wav, long_left, long_right, 2, CLIP_RATE, 16), "long file: WAV write failed")
    long_ref = FrameEncoder(12, 2, CLIP_RATE, 16, device="cuda").encode(long_left, long_right)
    return cd, {"clips": clips, "refs": refs, "frames": sum(len(l) for l, _ in clips)}, (wav, long_ref)


def check_mesh(tmp, shapes, batches, cd, batch, long_file):
    """Phase 12: the plane pipeline on a mesh. On every machine a stand-in
    mesh of two entries on card 0; with two or more cards, the real mesh over
    all of them, walls in turns against one card. Returns the stand-in runs'
    launches (the mesh path)."""
    t12 = time.perf_counter()
    left, right, cd_ref = cd
    clips, refs = batch["clips"], batch["refs"]
    stand_in = make_mesh(["cuda:0", "cuda:0"])
    D = len(stand_in)

    # plan_group_sharded against plan_group at the path's two plan shapes
    for rows, n in ((LANES, BLOCK), (12 * LANES, 256)):
        pcm = np.ascontiguousarray(left[: rows * n].reshape(rows, n))
        coeffs, _, lvalid, _ = lpc_candidates_from_lags(native.autocorr(pcm, 12), n)
        ct, vt = plan_inputs_to_torch(coeffs, lvalid, torch.device("cuda", 0))
        whole = plan_group(torch.from_numpy(pcm).cuda(), ct, vt, n, True, True).cpu().numpy()
        with Counted(batches) as c:
            got = plan_group_sharded(stand_in, pcm, coeffs, lvalid, n)
        check(np.array_equal(got["meta"], whole) and got["total_token_bits"] == rows,
              f"plan_group_sharded ({rows}, {n}) on the stand-in mesh differs from plan_group")
        kind = "group-full" if n == BLOCK else "group-probe"
        check(c.plans == {k: D if k == kind else 0 for k in PLAN_KINDS.values()},
              f"plan_group_sharded ({rows}, {n}): want one plan per shard, got {c.plans}")
        check_accounting(f"plan_group_sharded ({rows}, {n})", shapes, c)
        print(f"  plan_group_sharded ({rows}, {n}) on a stand-in mesh of {D}: meta == plan_group's, "
              f"{got['total_token_bits']} lanes counted, launches {c.launches}")

    # the 3-minute file, then the clips pooled with the stand-in mesh as template
    with Counted(batches) as one:
        FrameEncoder(12, 2, 44100, 16, device="cuda").encode(left, right)
    with Counted(batches) as c_cd:
        got = FrameEncoder(12, 2, 44100, 16, device="cuda", mesh=stand_in).encode(left, right)
        torch.cuda.synchronize()
    check(got == cd_ref, "3-minute file on the stand-in mesh: bytes differ from one card's")
    check_accounting("3-minute file on the stand-in mesh", shapes, c_cd)
    check_accounting("3-minute file on one card", shapes, one)
    # the plane pipeline's plans are one card's; the group route splits each of its batches over the shards
    check(all(c_cd.plans[k] == (D if k.startswith("group") else 1) * one.plans[k] for k in PLAN_KINDS.values()),
          f"3-minute file: the stand-in mesh planned {c_cd.plans}, one card {one.plans}")
    with Counted(batches) as c_clips:
        got, wall, peak = timed_on_card(lambda: pool.encode_pooled(clips, CLIP_RATE, 16, mesh=stand_in))
    bad = [i for i, (g, w) in enumerate(zip(got, refs)) if g != w]
    check(not bad, f"clips pooled on the stand-in mesh: frames {bad} differ from the host route")
    check_decodes("clips pooled on the stand-in mesh", got, clips)
    check_accounting("clips pooled on the stand-in mesh", shapes, c_clips)
    if torch.cuda.device_count() == 1:
        check(default_mesh() is None, "default_mesh() with one visible card must be None")
    mesh_launches = {k: c_cd.launches[k] + c_clips.launches[k] for k in K.launches}
    print(f"mesh, stand-in ({D} entries on cuda:0): 3-minute file == one card's bytes, launches {c_cd.launches} "
          f"(one card: {one.launches}); {len(clips)} clips pooled == host route and decode PCM-exact, {wall:.3f} s, "
          f"{c_clips.plans['full']} full-width and {c_clips.plans['probe']} probe plans, peak device memory "
          f"{gib(peak)}; default_mesh() = {default_mesh()}; phase 12 (stand-in) {time.perf_counter() - t12:.1f} s")
    if torch.cuda.device_count() >= 2:
        check_real_mesh(tmp, shapes, batches, cd, batch, long_file)
    return mesh_launches


def per_card_launches():
    """(card -> launches of every kernel, card -> {kernel: launches}) since the last reset."""
    by_kernel = {i: dict(sorted(d.items())) for i, d in sorted(K.card_launches.items())}
    return {i: sum(d.values()) for i, d in by_kernel.items()}, by_kernel


def check_real_mesh(tmp, shapes, batches, cd, batch, long_file):
    """Every card: the 3-minute file, the clips pooled and served, the long WAV
    through the CLI's streaming route in fresh processes; bytes against one
    card's, launches on every card, chunks on different cards overlapping in
    time, walls in turns (one card, mesh, mesh, one card)."""
    t0 = time.perf_counter()
    mesh = make_mesh()
    cards = [d.index for d in mesh]
    left, right, cd_ref = cd
    clips, refs, frames = batch["clips"], batch["refs"], batch["frames"]
    print(f"mesh over {len(mesh)} cards: {', '.join(torch.cuda.get_device_name(i) for i in cards)}")

    def on_all(fn):
        for i in cards:
            torch.cuda.synchronize(i)
            torch.cuda.reset_peak_memory_stats(i)
        t = time.perf_counter()
        out = fn()
        for i in cards:
            torch.cuda.synchronize(i)
        return out, time.perf_counter() - t, [torch.cuda.max_memory_allocated(i) for i in cards]

    runs = {
        "3-minute file": (lambda m: FrameEncoder(12, 2, 44100, 16, device="cuda", mesh=m).encode(left, right),
                          lambda got: got == cd_ref, -(-(len(left) // BLOCK) // 256)),
        "84 clips pooled": (lambda m: pool.encode_pooled(clips, CLIP_RATE, 16, mesh=m),
                            lambda got: got == refs, len(mesh)),
    }
    for label, (fn, ok, used) in runs.items():
        walls = []
        for turn, m in enumerate((None, mesh, mesh, None)):
            with Counted(batches) as c, ChunkTimeline(cards) as tl:
                got, wall, peaks = on_all(lambda: fn(m))
            check(ok(got), f"{label}, {'mesh' if m else 'one card'}: bytes differ from one card's")
            check_accounting(f"{label}, {'mesh' if m else 'one card'}", shapes, c)
            cl, by_kernel = per_card_launches()
            walls.append(f"{'mesh' if m else 'one card'} {wall:.3f} s")
            if m is None:
                check(set(cl) == {0}, f"{label}, one card: launches on cards {cl}")
                continue
            # the plane pipeline's chunks reach ``used`` cards; the group route spreads a
            # tail's plan batch over every card of the mesh
            check(len([i for i in cards if cl.get(i, 0) > 0]) >= min(len(mesh), used),
                  f"{label}, mesh: want launches on at least {min(len(mesh), used)} cards, got {cl}")
            pairs, both, anyone = overlap_report(tl.chunks())
            if used > 1:
                check(pairs > 0, f"{label}, mesh: no two chunks on different cards overlap in time")
            print(f"  {label}, mesh turn {turn}: launches per card {cl} ({by_kernel}); {len(tl.chunks())} chunks, "
                  f"{pairs} pairs on different cards overlap; two or more cards inside a chunk for {both:.3f} of "
                  f"{anyone:.3f} s; peak device memory per card {', '.join(gib(p) for p in peaks)}")
        print(f"  {label}: walls in turns {', '.join(walls)}")
        for m in (None, mesh):
            where = "mesh" if m else "one card"
            got, wall, busy = busy_by_card(lambda: fn(m), cards)
            check(ok(got), f"{label}, {where} (profiled): bytes differ from one card's")
            if busy is None:
                continue
            print(f"  {label}, {where} (profiled, torch.profiler CUDA activity): wall {wall:.3f} s; "
                  f"busy share per card {', '.join(f'{i}: {100 * b / wall:.1f}%' for i, b in busy.items())}")

    # the clips through the service, pooled, --workers=4
    d = os.path.join(tmp, "mesh-serve")
    os.mkdir(d)
    wavs = [os.path.join(d, f"clip{i}.wav") for i in range(len(clips))]
    with ThreadPoolExecutor(8) as ex:
        check(all(ex.map(lambda i: write_wav_port(wavs[i], *clips[i], 2, CLIP_RATE, 16), range(len(clips)))),
              "mesh, service: clip WAV write failed")
    walls = []
    for turn, on in enumerate((False, True, True, False)):
        outs = [os.path.join(d, f"t{turn}-{i}.lac") for i in range(len(clips))]
        script = "".join(f"encode {w} {o}\n" for w, o in zip(wavs, outs)) + "wait\n"
        wire = Wire()
        if not on:
            os.environ["LAC_TPU_MESH"] = "0"
        try:
            with Counted(batches) as c:
                rc, wall, peaks = on_all(lambda: serve.serve(["--workers=4"], stdin=io.StringIO(script), stdout=wire,
                                                             device="cuda"))
        finally:
            os.environ.pop("LAC_TPU_MESH", None)
        got = answered("mesh, service", wire.lines, len(clips) + 1)
        check(rc == 0 and all(r["ok"] for r in got.values()), "mesh, service: a job failed")
        bad = [i for i, o in enumerate(outs) if take(o) != refs[i]]
        check(not bad, f"mesh, service, {'mesh' if on else 'one card'}: outputs {bad} differ from one card's")
        check_accounting("mesh, service", shapes, c)
        cl, by_kernel = per_card_launches()
        check(set(cl) == (set(cards) if on else {0}), f"mesh, service: launches on cards {cl}")
        walls.append(f"{'mesh' if on else 'one card'} {at_id(wire.lines, len(clips) + 1):.3f} s")
        if on:
            print(f"  84 clips served (--workers=4), mesh turn {turn}: launches per card {cl} ({by_kernel}); peak "
                  f"device memory per card {', '.join(gib(p) for p in peaks)}")
    print(f"  84 clips served (--workers=4): wait answered, in turns {', '.join(walls)}")

    # the long WAV through the CLI's streaming route, in this process and in fresh ones
    wav, long_ref = long_file
    lac = os.path.join(tmp, "mesh-long.lac")
    walls = []
    for on in (False, True, True, False):
        os.environ["LAC_TPU_CLI_MESH"] = "1" if on else "0"  # the CLI's one-shot encode takes the mesh only when asked
        try:
            with Counted(batches) as c:
                rc, wall, _ = on_all(lambda: cli.main(["encode", wav, lac]))
        finally:
            os.environ.pop("LAC_TPU_CLI_MESH", None)
        check(rc == 0 and take(lac) == long_ref, "mesh, long WAV through the CLI in this process: bytes differ")
        check_accounting("mesh, long WAV through the CLI", shapes, c)
        walls.append(f"{'mesh' if on else 'one card'} {wall:.3f} s")
    print(f"  long WAV through the CLI's streaming route in this process: walls in turns {', '.join(walls)}")
    walls = []
    for on, first in ((False, False), (True, False), (True, False), (False, False),
                      (False, True), (True, True), (True, True), (False, True)):
        env = {"LAC_TPU_CLI_MESH": "1" if on else "0"}
        rc, out, wall, rss = run_child(["-c", MESH_CLI_CHILD, "contexts-first" if first else "as-is", "encode", wav,
                                        lac], env)
        check(rc == 0 and take(lac) == long_ref, f"mesh, long WAV through the CLI ({rc}): bytes differ\n{out}")
        info = json.loads(next(line for line in out.splitlines() if line.startswith("MESH "))[5:])
        cl = {int(k): v for k, v in info["card_launches"].items()}
        check(len(info["mesh"]) == (len(mesh) if on else 0) and len(cl) == (min(len(mesh), 2) if on else 1),
              f"mesh, long WAV through the CLI: {info}")
        walls.append(f"{'mesh' if on else 'one card'}{', contexts first' if first else ''} {wall:.2f} s (import "
                     f"{info['import_s']:.2f}, contexts {info['contexts_s']:.2f}, cli.main {info['cli_s']:.2f})")
        if on and not first:
            print(f"  long WAV ({STREAM_BLOCKS} blocks, streaming route, 512-block stream chunks of two 256-block "
                  f"pipeline chunks each), fresh process: launches per card {cl}, peak RSS {rss:.0f} MiB")
    print(f"  long WAV through the CLI in fresh processes, in turns: {'; '.join(walls)}")
    print(f"mesh over {len(mesh)} cards: every output == one card's bytes; {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ kernel 8 and the experiments


def rice_scan_record(label, operands, tokens, plain_ms):
    """Kernel 8 timed at one real shape: the kernel (CUDA graph of 20
    launches) beside its plain version's one call (``plain_ms``), its
    bound, the longest lane's block alone (the same kernel on that lane: one
    block on one SM, the floor of a block-per-lane design when the card has
    an SM for every lane) and the native tokenizer (host clock)."""
    payload, k, nbits = operands
    lanes = payload.shape[0]
    kern = lambda _: K.tokenize_static_rice_scan(payload, k, nbits, tokens)  # noqa: E731
    ms = min(time_ms(kern, None), time_ms(kern, None))
    longest = int(nbits.argmax())
    one = (payload[longest : longest + 1], k[longest : longest + 1], nbits[longest : longest + 1])
    block_ms = min(time_ms(lambda _: K.tokenize_static_rice_scan(*one, tokens), None) for _ in range(2))
    bound_ms, bound_by = bound(SCAN, (payload, k, nbits), kern(None), ops=OPS_PER_ELEMENT[SCAN] * lanes * tokens)
    pay_h, k_h, nb_h = (t.cpu().numpy() for t in operands)
    native_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        native.tokenize_static_rice(pay_h, k_h, nb_h, tokens)
        native_s = min(native_s, time.perf_counter() - t0)
    print(f"    {label}: kernel {ms:.4f} ms ({ms * 1e-3 * SM_CLOCK_HZ / tokens:.0f} cycles a token at "
          f"{SM_CLOCK_HZ / 1e9:.2f} GHz), plain {plain_ms:.1f} ms (one call, no graph), bound {bound_ms:.4f} ms "
          f"({bound_by}), {100 * bound_ms / ms:.1f}% of bound; the longest lane's block alone {block_ms:.4f} ms "
          f"({100 * block_ms / ms:.0f}% of the kernel); native tokenizer {native_s * 1e3:.3f} ms (host, one thread); "
          f"{lanes * tokens / ms / 1e6:.1f} G tokens/s on the card (CUDA graph of 20 launches, CUDA events)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "block_ms": block_ms, "native_ms": native_s * 1e3}


READER_SHAPES = ((64, 4096), (256, 16384))  # (lanes, tokens): the reader bench's default, a plan batch's lanes


def check_rice_scan():
    """Kernel 8 bit-exact against its plain version on every output element
    at the reader bench's (64, 4096), at (256, 16384), on rows longer than
    the 32 KB it stages at once, on adversarial and on sync-hostile lanes;
    its tokens equal the native tokenizer's on the real lanes. Returns the
    record of (256, 16384)."""
    dev = torch.device("cuda")
    err, record = 0, None
    cases = [(label, *(torch.from_numpy(a).to(dev) for a in (pay, k, nb)), T, None)
             for label, pay, k, nb, T in (bench_device_reader.adversarial_batches()
                                          + bench_device_reader.sync_hostile_batches())]
    real = [("rows over 32 KB, packed by pack_rice_lanes", bench_device_reader.long_lanes(np.random.RandomState(13)))]
    real += [(f"({lanes}, {tokens}), packed by pack_rice_lanes",
              bench_device_reader.make_lanes(np.random.RandomState(11), lanes, tokens))
             for lanes, tokens in READER_SHAPES]
    for label, (ks, vals) in real:
        lanes, tokens = vals.shape
        payload, nbits = bench_device_reader.pack_lanes(vals, ks, dev)
        bench_device_reader.check_against_spec(payload, nbits, vals, ks, sorted({0, lanes // 2, lanes - 1}))
        want = native.tokenize_static_rice(payload.cpu().numpy(), ks, nbits.cpu().numpy(), tokens)
        check(np.array_equal(want, vals), f"native tokenizer ({lanes}, {tokens}): differs from the encoded values")
        cases.append((label, payload, torch.from_numpy(ks).to(dev), nbits, tokens, want))
    for label, payload, k, nbits, tokens, native_res in cases:
        got = K.tokenize_static_rice_scan(payload, k, nbits, tokens)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = K.tokenize_static_rice_scan_plain(payload, k, nbits, tokens)
        stop.record()
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]), f"{SCAN} {label}: valid flags differ from the plain version")
        err = max(err, int((got[0].to(torch.int64) - want[0].to(torch.int64)).abs().max().item()))
        check(err == 0, f"{SCAN} {label}: kernel differs from its plain version (max |diff| {err})")
        line = f"  {SCAN:22s} {label} {tuple(payload.shape)}, {tokens} tokens: exact on every element"
        if native_res is None:
            print(line)
            continue
        check(bool(got[1].all()) and np.array_equal(got[0].cpu().numpy(), native_res),
              f"{SCAN} {label}: tokens differ from the native tokenizer's")
        print(line + "; every token valid and == the native tokenizer's")
        if (payload.shape[0], tokens) in READER_SHAPES:  # the last, (256, 16384), is the kernel's record
            record = rice_scan_record(label, (payload, k, nbits), tokens, start.elapsed_time(stop))
    return {"max_abs_err": float(err), **{key: record[key] for key in
                                          ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def check_experiments(batches):
    """The reader and the pack experiments through their bench scripts, launches
    counted. Returns (the reader path's launches, the pack path's)."""
    with Counted(batches) as reader:
        for lanes, tokens in READER_SHAPES:
            out = bench_device_reader.run(lanes=lanes, tokens=tokens, reps=3, device="cuda")
            print(f"  bench_device_reader ({lanes}, {tokens}): native == pointer doubling == kernel 8 == the values; "
                  f"best of 3, host clock: native {out['native_s'] * 1e3:.3f} ms, pointer doubling "
                  f"{out['jump_s'] * 1e3:.3f} ms, kernel 8 {out['scan_s'] * 1e3:.3f} ms")
    check(reader.launches[SCAN] == 8 and all(reader.launches[k] == 0 for k in KERNELS if k != SCAN),
          f"the reader experiment: want 8 launches of kernel 8 and no other, got {reader.launches}")
    with Counted(batches) as packed:
        out = bench_device_pack.run(lanes=LANES, reps=3, device="cuda")
    print(f"  bench_device_pack ({LANES}, {bench_device_pack.N}), W = {out['W']}: every lane == pack_stream == the native packer; best of 3, "
          f"host clock: upload + emit + fetch {out['upload_emit_fetch_s'] * 1e3:.3f} ms, emit {out['emit_s'] * 1e3:.3f} "
          f"ms, pack alone {out['pack_s'] * 1e3:.3f} ms, native packer {out['native_pack_s'] * 1e3:.3f} ms (host "
          f"threads); {out['payload_bytes']:,} bytes of payload, {out['fetch_bytes']:,} fetched")
    fused = "k_after_stateful_fused"
    check(packed.launches[fused] == 8 and all(packed.launches[k] == 0 for k in KERNELS if k != fused),
          f"the pack experiment: want 8 launches of kernel 6 and no other, got {packed.launches}")
    return reader.launches, packed.launches


def check_phase14(batches, records, by_path):
    t14 = time.perf_counter()
    print("kernel 8 vs its plain version (bit-exact):")
    records[SCAN] = check_rice_scan()
    print("the experiments:")
    by_path["reader"], by_path["pack"] = check_experiments(batches)
    print(f"phase 14 (kernel 8, the experiments): {time.perf_counter() - t14:.1f} s")


# ------------------------------------------------------------ the captured plans


# every plan shape a one-card encode replays: full-width batches at K = 64, 128 and 256 and their doubled
# batches, the probe batch of each K, and the group route's caps (128 x 16384 is the K = 64 doubled batch)
GRAPH_SHAPES = [(64, BLOCK), (128, BLOCK), (256, BLOCK), (768, 256), (1536, 256), (3072, 256), (GROUP_PROBE_LANES, 256)]
GRAPH_FLAGS = [(True, True), (False, True), (True, False), (False, False)]  # (zero_run, partitioning)


def graph_equal(got, want):
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    return all(torch.equal(g, w) for g, w in zip(got, want))


class CardNoise(threading.Thread):
    """A thread that uses card 0 while plans are captured, the way the
    pipeline's other threads do: kernels on the default stream, ``.item()``,
    stream syncs, new device memory, pinned buffers and host copies (every
    one a call a capture in global mode forbids), and the port's
    device-wide synchronize, which waits until no plan is being captured."""

    def __init__(self):
        super().__init__(name="chip-smoke-card-noise", daemon=True)
        self.stop, self.rounds, self.failure = threading.Event(), 0, None

    def run(self):
        try:
            with torch.cuda.device(0):
                while not self.stop.is_set():
                    x = torch.arange(1 << 20, device="cuda", dtype=torch.int64) * (self.rounds + 1)
                    check(int(x.sum().item()) == (self.rounds + 1) * ((1 << 20) * ((1 << 20) - 1) // 2),
                          "card noise: wrong sum")
                    HostCopy(x[:1024]).numpy()
                    torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True)
                    torch.cuda.current_stream().synchronize()
                    plan_graphs.synchronize()  # the port's device-wide synchronize: it waits out a capture
                    self.rounds += 1
        except BaseException as e:  # noqa: BLE001 — raised by the caller after join
            self.failure = e


# a fresh process: a (64, 16384) plan captured three times while a second thread synchronizes the card
# without a pause, with torch.cuda.synchronize ("raw") or with plan_graphs.synchronize ("locked")
SYNC_CHILD = r"""
import json, sys, threading
import numpy as np
import torch
from lac_tpu_torch import plan_graphs
from lac_tpu_torch.encoder import lpc_candidates_from_lags, plan_group, plan_inputs_to_torch
from lac_tpu_torch.runtime import native

mode = sys.argv[1]
pcm = np.random.RandomState(3).randint(-3000, 3000, (64, 16384)).astype(np.int32)
coeffs, _, lvalid, _ = lpc_candidates_from_lags(native.autocorr(pcm, 12), 16384)
pt = torch.from_numpy(pcm).cuda()
ct, vt = plan_inputs_to_torch(coeffs, lvalid, pt.device)
want = plan_group(pt, ct, vt, 16384, True, True)
torch.cuda.synchronize()
stop, rounds, errors = threading.Event(), [0], []


def noise():
    while not stop.is_set():
        try:
            torch.cuda.synchronize() if mode == "raw" else plan_graphs.synchronize()
            rounds[0] += 1
        except Exception as e:
            errors.append(type(e).__name__)


t = threading.Thread(target=noise, daemon=True)
t.start()
exact = 0
try:
    for _ in range(3):
        plan_graphs.release()
        exact += bool(torch.equal(plan_graphs.planned(pt, ct, vt, 16384, True, True, rows=64), want))
    result = f"{exact} of 3 captures exact"
except Exception as e:
    result = f"capture failed: {type(e).__name__}: {(str(e).splitlines() or [''])[0]}"
stop.set()
t.join()
print("SYNC " + json.dumps({"mode": mode, "result": result, "rounds": rounds[0], "noise_errors": errors[:3]}))
"""


def check_sync_during_capture():
    """Why the port's device-wide synchronize takes the capture lock: in a
    fresh process, a second thread's ``torch.cuda.synchronize()`` beside a
    capture (printed, not required to fail: it races the capture), then
    ``plan_graphs.synchronize()`` (the captures must all be exact)."""
    for mode in ("raw", "locked"):
        rc, out, wall, _ = run_child(["-c", SYNC_CHILD, mode], limit_s=240)
        line = next((line for line in out.splitlines() if line.startswith("SYNC ")), None)
        check(line is not None, f"sync-during-capture child ({mode}) printed no result ({rc}):\n{out[-3000:]}")
        got = json.loads(line[5:])
        if mode == "locked":
            check(rc == 0 and got["result"] == "3 of 3 captures exact" and not got["noise_errors"],
                  f"captures beside plan_graphs.synchronize: {got}")
        print(f"  a second thread synchronizing the card during captures, {mode}: {got['result']}; "
              f"{got['rounds']} synchronizes, errors {got['noise_errors']} (fresh process, {wall:.1f} s)")


def check_graphs(batches):
    """Phase 15: the captured plans. Every shape a one-card encode replays,
    with and without token fields, under every flag combination: the
    replay bit-exact against eager ``plan_group`` on the same inputs, then
    a ragged batch on the same graph (the rows a fuller batch left zeroed),
    captured while another thread uses the card; captures, replays and
    capture seconds; host dispatch and device time of one plan, eager and
    replayed; the gather into the static buffer; memory with every graph
    held. Returns the launches of the replays."""
    t15 = time.perf_counter()
    inputs = {BLOCK: plan_batch(256, BLOCK, 21), 256: plan_batch(3072, 256, 22)}  # on card 0
    plan_graphs.release()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    noise = CardNoise()
    noise.start()
    firsts = {}
    try:
        with Counted(batches) as c:
            for rows, n in GRAPH_SHAPES:
                pcm, ct, vt = inputs[n]
                pcm, ct, vt = pcm[:rows], ct[:, :rows], vt[:, :rows]
                nsub = rows * 3 // 8 + 1
                for emit in (False, True):
                    for zr, part in GRAPH_FLAGS:
                        want = plan_group(pcm, ct, vt, n, zr, part, emit_fields=emit)
                        t0 = time.perf_counter()
                        got = plan_graphs.planned(pcm, ct, vt, n, zr, part, emit_fields=emit, rows=rows)
                        torch.cuda.synchronize()
                        firsts[(rows, n, zr, part, emit)] = time.perf_counter() - t0
                        label = f"({rows}, {n}), zero_run={zr}, partitioning={part}, emit_fields={emit}"
                        check(graph_equal(got, want), f"plan graph {label}: the replay differs from plan_group")
                        ragged = plan_graphs.planned(pcm[:nsub], ct[:, :nsub], vt[:, :nsub], n, zr, part,
                                                     emit_fields=emit, rows=rows)
                        eager = plan_group(pcm[:nsub], ct[:, :nsub], vt[:, :nsub], n, zr, part, emit_fields=emit)
                        check(graph_equal(ragged, eager),
                              f"plan graph {label}: a ragged batch of {nsub} after the full one differs from eager")
                        static = plan_graphs._CACHE.entries[(0, rows, n, zr, part, emit)][0]
                        check(not static.pcm[nsub:].any() and not static.coeffs[:, nsub:].any()
                              and not static.valid[:, nsub:].any(),
                              f"plan graph {label}: rows {nsub}.. of the full batch were carried into the ragged one")
    finally:
        noise.stop.set()
        noise.join()
    if noise.failure is not None:
        raise noise.failure
    torch.cuda.synchronize()
    peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.memory_reserved()
    g = c.graphs
    keys = len(GRAPH_SHAPES) * 2 * len(GRAPH_FLAGS)
    check(g["captures"] == keys and g["replays"] == 2 * keys and len(plan_graphs.captured_keys()) == keys,
          f"phase 15: want {keys} captures and {2 * keys} replays, got {g}")
    check(noise.rounds > 0, "phase 15: the card-noise thread never ran")
    check(all(c.launches[k] > 0 for k in ENCODE_KERNELS), f"phase 15: a kernel never launched: {c.launches}")
    for key, (_, captured) in plan_graphs._CACHE.entries.items():
        _, rows, n, zr, part, emit = key
        got = {k: captured.launches.get(k, 0) for k in ("mode_cost_sums", "partition_cost_sums")}
        check(got == {"mode_cost_sums": 1, "partition_cost_sums": int(part)},
              f"plan graph {key[1:]}: want one launch of kernel 9 and, with partitioning, one of kernel 10: {got}")
    print(f"plan graphs: {keys} shapes x flags x emit_fields captured, each replay bit-exact against plan_group and "
          f"a ragged batch after the full one exact with the stale rows zeroed; {g['captures']} captures in "
          f"{g['capture_s']:.2f} s, {g['replays']} replays; another thread used the card meanwhile "
          f"({noise.rounds} rounds of kernels, .item(), host copies, pinned buffers and synchronize)")
    for rows, n in GRAPH_SHAPES:
        times = [firsts[(rows, n, True, True, emit)] for emit in (False, True)]
        print(f"  ({rows}, {n}): first call (warm-up, capture, replay) {times[0]:.3f} s, with emit_fields "
              f"{times[1]:.3f} s")
    print(f"  device memory: {gib(reserved0)} reserved before, {gib(reserved)} with the {keys} graphs held "
          f"(their static buffers and one pool); peak allocated {gib(peak)}")

    # one plan at the pipeline's two shapes: host dispatch (the call returns before the card finishes) and
    # device time (CUDA events), eager and replayed, in turns
    for rows, n in ((256, BLOCK), (3072, 256)):
        pcm, ct, vt = inputs[n]
        pcm, ct, vt = pcm[:rows], ct[:, :rows], vt[:, :rows]
        rec = {"eager": [], "replay": []}
        for name in ("eager", "replay", "replay", "eager") * 3:
            fn = (lambda: plan_group(pcm, ct, vt, n, True, True)) if name == "eager" else (
                lambda: plan_graphs.planned(pcm, ct, vt, n, True, True, rows=rows))
            torch.cuda.synchronize()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            host = time.perf_counter() - t0
            stop.record()
            torch.cuda.synchronize()
            rec[name].append((host * 1e3, start.elapsed_time(stop)))
        txt = "; ".join(f"{name} host dispatch {statistics.median(h for h, _ in r):.3f} ms, device "
                        f"{statistics.median(d for _, d in r):.3f} ms" for name, r in rec.items())
        print(f"  one plan of ({rows}, {n}), median of 6 in turns: {txt}")

    # the rows of a batch into the static buffer: gathered first and copied, or gathered into it
    src = torch.from_numpy(np.ascontiguousarray(np.tile(inputs[BLOCK][0].cpu().numpy(), (4, 1)))).cuda()
    idx = torch.from_numpy(np.random.RandomState(23).permutation(len(src))[:256]).cuda()
    static = torch.empty((256, BLOCK), dtype=torch.int32, device="cuda")
    ways = {"index_select, then copy_ into the buffer": lambda _: static.copy_(src.index_select(0, idx)),
            "index_select(out=buffer)": lambda _: torch.index_select(src, 0, idx, out=static)}
    times = {k: [] for k in ways}
    for k in (*ways, *reversed(list(ways))):
        times[k].append(time_ms(ways[k], None))
    print("  a (256, 16384) batch into the static buffer from (1024, 16384) planes (CUDA graph of 20, in turns): "
          + "; ".join(f"{k} {min(t):.4f} ms" for k, t in times.items()))
    check_analyze_graphs()
    check_sync_during_capture()
    print(f"phase 15 (the captured plans, analyzes and lags): {time.perf_counter() - t15:.1f} s")
    return c.launches


ANALYZE_WIDTHS = (64, 128, 256)  # the chunk widths of CHUNK_LADDER
ANALYZE_KINDS = ("mono", "lr", "ms", "auto")


def analyze_inputs(dtype, seed):
    """(256, 16384) L and R planes of ``dtype`` on card 0: gliding sines
    and filtered noise (16-bit content at 44.1 kHz for int16, 24-bit at
    96 kHz for int32), silent blocks and the type's extremes."""
    rate, depth = (44100, 16) if dtype == torch.int16 else (96000, 24)
    hi = (1 << (depth - 1)) - 1
    K = ANALYZE_WIDTHS[-1]
    sines, noise = (fn(K * BLOCK, rate, depth, seed) for fn in (gliding_stereo, filtered_noise_stereo))
    odd = (np.arange(K) % 3 == 2)[:, None]
    alt = np.where(np.arange(BLOCK) % 2, hi, -hi - 1)
    planes = []
    for c in (0, 1):
        m = np.where(odd, noise[c].reshape(K, BLOCK), sines[c].reshape(K, BLOCK))
        m[5::8] = 0
        m[7::16] = alt if c == 0 else -alt - 1
        planes.append(torch.from_numpy(m.astype(np.int16 if depth == 16 else np.int32)).cuda())
    return planes


def padded(m, K):
    """``m`` (kc, n) with K - kc rows of zeros below it."""
    return torch.cat([m, m.new_zeros((K - m.shape[0], m.shape[1]))])


def check_analyze_graphs():
    """Phase 15, the analyze and lag graphs: every analyze graph a one-card
    encode replays (K = 64, 128 and 256, the four kinds, int16 and int32
    planes) and the group route's lag graphs at its caps, int16 and int32,
    each held bit-exact against its eager function on the same inputs,
    then a ragged input on the same graph against the eager function on
    the zero-padded input, with the rows the full input left zeroed; an
    out-of-domain int32 batch on the int32 lag graph; captured while
    another thread uses the card. Captures, replays, capture seconds and
    memory with the graphs held; host dispatch and device time of one auto
    chunk analyzed eagerly at its kc rows (the parent's way) and replayed
    at K, in turns."""
    plan_graphs.release()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reserved0 = torch.cuda.memory_reserved()
    inputs = {dt: analyze_inputs(dt, 30 + i) for i, dt in enumerate((torch.int16, torch.int32))}
    analyze_cache, lag_cache = plan_graphs.CACHES["analyze"], plan_graphs.CACHES["lags"]
    s0 = {kind: dict(plan_graphs.CACHES[kind].stats) for kind in ("analyze", "lags")}
    noise = CardNoise()
    noise.start()
    try:
        for dt, (lm, rm) in inputs.items():
            for K in ANALYZE_WIDTHS:
                kc = K * 3 // 8 + 1
                for kind in ANALYZE_KINDS:
                    label = f"analyze graph (K={K}, {kind}, {dt})"
                    want = eager_analyze(lm[:K], rm[:K], kind)
                    got = plan_graphs.analyzed(lm[:K], rm[:K], K, kind)
                    check(set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want),
                          f"{label}: the replay differs from analyze")
                    ragged = plan_graphs.analyzed(lm[:kc], rm[:kc], K, kind)
                    want = eager_analyze(padded(lm[:kc], K), padded(rm[:kc], K), kind)
                    check(all(torch.equal(ragged[k], want[k]) for k in want),
                          f"{label}: a ragged chunk of {kc} after the full one differs from analyze, zero-padded")
                    static, captured = analyze_cache.entries[(0, K, kind, dt)]
                    check(not static.lmat[kc:].any() and (kind == "mono" or not static.rmat[kc:].any()),
                          f"{label}: rows {kc}.. of the full chunk were carried into the ragged one")
                    check(not captured.launches, f"{label}: analyze launched the port's kernels {captured.launches}")
        t_lags = time.perf_counter()
        for rows, n in ((GROUP_LANES, BLOCK), (GROUP_PROBE_LANES, 256)):
            for dt, (lm, _) in inputs.items():
                pcm = lm.reshape(-1)[: rows * n].reshape(rows, n)
                nsub = rows * 3 // 8 + 1
                label = f"lag graph ({rows}, {n}, {dt})"
                check(torch.equal(plan_graphs.lags_of(pcm, rows), eager_lags(pcm, 12)),
                      f"{label}: the replay differs from autocorrelation")
                check(torch.equal(plan_graphs.lags_of(pcm[:nsub], rows), eager_lags(pcm[:nsub], 12)),
                      f"{label}: a ragged batch of {nsub} after the full one differs from autocorrelation")
                check(not lag_cache.entries[(0, rows, n, dt)][0].pcm[nsub:].any(),
                      f"{label}: rows {nsub}.. of the full batch were carried into the ragged one")
        ood = torch.from_numpy(np.concatenate([pcm for _, pcm in out_of_domain_groups()])).cuda()
        check(torch.equal(plan_graphs.lags_of(ood, GROUP_LANES), eager_lags(ood, 12)),
              f"lag graph ({GROUP_LANES}, {BLOCK}, int32): {len(ood)} lanes out of the 24-bit domain differ")
        lag_s = time.perf_counter() - t_lags
    finally:
        noise.stop.set()
        noise.join()
    if noise.failure is not None:
        raise noise.failure
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    got = {kind: {k: plan_graphs.CACHES[kind].stats[k] - s0[kind][k] for k in s0[kind]} for kind in s0}
    keys = len(inputs) * len(ANALYZE_WIDTHS) * len(ANALYZE_KINDS)
    check(got["analyze"]["captures"] == keys and got["analyze"]["replays"] == 2 * keys,
          f"phase 15: want {keys} analyze captures and {2 * keys} replays, got {got['analyze']}")
    check(len(plan_graphs.captured_keys("analyze")) == plan_graphs.MAX_ANALYZE_GRAPHS,
          f"phase 15: {len(plan_graphs.captured_keys('analyze'))} analyze graphs held, want the bound's 16")
    check(got["lags"]["captures"] == 4 and got["lags"]["replays"] == 9, f"phase 15: lag graphs {got['lags']}")
    print(f"analyze graphs: {keys} (K x kind x plane dtype) captured, each replay bit-exact against analyze and a "
          f"ragged chunk after the full one exact with the stale rows zeroed, none launching a kernel; "
          f"{got['analyze']['captures']} captures in {got['analyze']['capture_s']:.2f} s, "
          f"{got['analyze']['replays']} replays, {len(plan_graphs.captured_keys('analyze'))} held (the bound); lag "
          f"graphs at the group caps, int16 and int32, the same way, and {len(ood)} lanes out of the 24-bit domain: "
          f"{got['lags']['captures']} captures in {got['lags']['capture_s']:.2f} s, {got['lags']['replays']} "
          f"replays ({lag_s:.2f} s); another thread used the card meanwhile ({noise.rounds} rounds)")
    print(f"  device memory: {gib(reserved0)} reserved before (the plan graphs dropped), {gib(reserved)} with these "
          f"graphs held; most reserved meanwhile {gib(torch.cuda.max_memory_reserved())}")

    # one auto chunk: analyze eagerly at its kc rows (the parent's way) against the K = 256 graph's replay
    for dt, kcs in ((torch.int16, (256, 228)), (torch.int32, (256, 95))):
        lm, rm = inputs[dt]
        for kc in kcs:
            rec = {"eager": [], "replay": []}
            for name in ("eager", "replay", "replay", "eager") * 3:
                fn = (lambda: eager_analyze(lm[:kc], rm[:kc], "auto")) if name == "eager" else (
                    lambda: plan_graphs.analyzed(lm[:kc], rm[:kc], 256, "auto"))
                torch.cuda.synchronize()
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                fn()
                host = time.perf_counter() - t0
                stop.record()
                torch.cuda.synchronize()
                rec[name].append((host * 1e3, start.elapsed_time(stop)))
            txt = "; ".join(f"{name} host dispatch {statistics.median(h for h, _ in r):.3f} ms, device "
                            f"{statistics.median(d for _, d in r):.3f} ms" for name, r in rec.items())
            print(f"  one auto chunk of {kc} blocks, {dt} planes, eager at {kc} rows against the K = 256 graph, "
                  f"median of 6 in turns: {txt}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    mesh_only, phase14_only, phase15_only = (sys.argv[1:] == [flag] for flag in ("--mesh", "--phase14", "--phase15"))
    if sys.argv[1:] and not (mesh_only or phase14_only or phase15_only):
        raise SystemExit("usage: python3 chip_smoke.py [--mesh | --phase14 | --phase15]")
    t_start = time.perf_counter()

    # 1. device and host
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)  # one line per card
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

    phase_seconds("1-2 (device, build)", t_start)

    # 3. kernels against their plain versions
    t3 = time.perf_counter()
    rng = np.random.RandomState(20261016)
    print("kernels vs plain versions (bit-exact):")
    records, shapes = check_kernels(rng)
    check_argmin_ties(rng)
    phase_seconds("3 (the kernels against their plain versions)", t3)
    restore_rng = np.random.RandomState(20261017)  # phase 11's kernel inputs, apart from the others' stream
    # phase 3 ran every kernel on the card: from here on this process is warm, so the cold route
    # (in-memory inputs of at most encoder.COLD_BLOCKS blocks on the host) never takes phase 4's files
    # or phase 6's clips off the card; phase 8 drives it in fresh processes
    device_pipeline.mark_warm()

    if mesh_only:  # phase 12 alone, on every visible card
        batches = count_plan_batches()
        with tempfile.TemporaryDirectory() as tmp:
            by_path = {"mesh": check_mesh(tmp, shapes, batches, *mesh_inputs(tmp))}
        finish(t_start, records, by_path, "mesh", ENCODE_KERNELS)
        return

    if phase14_only:  # phase 14 alone: kernel 8 and kernel 6, the kernels of the experiments' paths
        by_path = {}
        check_phase14(count_plan_batches(), records, by_path)
        finish(t_start, records, by_path, "pack", [SCAN, "k_after_stateful_fused"])
        return

    if phase15_only:  # phase 15 alone: the captured plans
        by_path = {"graphs": check_graphs(count_plan_batches())}
        finish(t_start, records, by_path, "graphs", ENCODE_KERNELS)
        return

    # 4. real-size encodes through the port's main path, held to the port's host route
    t4 = time.perf_counter()
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
    # the warm-up a service process runs (serve.warm_process): the build, then on the card the plan graphs an
    # encode of up to the 3-minute file's 484 full blocks replays, then a synthetic encode
    with Counted(batches) as w:
        _, warm_s, _ = timed_on_card(lambda: serve.warm_process(FILES[0][3] // BLOCK, device="cuda"))
    warmed = w.graphs
    print(f"warm-up (serve.warm_process({FILES[0][3] // BLOCK})): {warm_s:.2f} s; {warmed['captures']} plan graphs "
          f"captured in {warmed['capture_s']:.2f} s, {warmed['replays']} replays; {w.analyze['captures']} analyze "
          f"graphs in {w.analyze['capture_s']:.2f} s and {w.lags['captures']} lag graphs in "
          f"{w.lags['capture_s']:.2f} s; graphs held {[k[1:3] for k in plan_graphs.captured_keys()]}, analyze "
          f"{[k[1:] for k in plan_graphs.captured_keys('analyze')]}, lags "
          f"{[k[1:] for k in plan_graphs.captured_keys('lags')]}; device memory reserved "
          f"{gib(torch.cuda.memory_reserved())}, most reserved during the warm-up "
          f"{gib(torch.cuda.max_memory_reserved())}")
    check(warmed["captures"] >= 7, f"the warm-up captured {warmed['captures']} plan graphs, want the grid's 7")
    check(w.analyze["captures"] >= 3 and w.lags["captures"] >= 2,
          f"the warm-up captured {w.analyze} analyze and {w.lags} lag graphs, want the grid's 3 and 2")
    K.reset_launches()
    per_file, counted = [], []
    for (label, sr, depth, (left, right)), ref in zip(audio, refs):
        with Counted(batches, reset=False) as c:
            got, wall, peak = timed_on_card(lambda: FrameEncoder(12, 2, sr, depth, device="cuda").encode(left, right))
        per_file.append((wall, c.launches, peak, torch.cuda.max_memory_reserved()))
        counted.append(c)
        check(got == ref, f"{label}: port bytes differ from the port's host route")
        check(c.graphs["captures"] == 0, f"{label}: after the warm-up every plan must replay a graph of the "
                                         f"grid, but {c.graphs['captures']} were captured: {c.captured}")
        # the grid holds the auto analyze of 16-bit planes, as lac_tpu's warms int16 alone
        # (lac_tpu/serve.py:242-272): 24-bit planes capture their one int32 graph (K = 256) here
        fresh = 0 if depth == 16 else 1
        check(c.analyze["captures"] == fresh and c.lags["captures"] == 0 and c.analyze["replays"] > 0,
              f"{label}: after the warm-up the analyze graphs of {depth}-bit planes must capture {fresh}: "
              f"{c.analyze}, lags {c.lags}")
    launches = dict(K.launches)
    # the group route plans the lanes of the tail blocks (an uncertain tail's probe lanes)
    full = sum(c.plans["full"] + c.plans["group-full"] for c in counted)
    probe = sum(c.plans["probe"] + c.plans["group-probe"] for c in counted)
    replays = sum(c.graphs["replays"] for c in counted)
    analyzes = sum(c.analyze["replays"] for c in counted)
    print(f"main path: {full} full-width and {probe} probe plan batches, {replays} plan graph replays and "
          f"{analyzes} analyze graph replays (one a chunk), no plan capture, the 24-bit file's int32 analyze "
          f"graph its one capture; launches {launches}")
    check(all(launches[k] > 0 for k in ENCODE_KERNELS), f"a kernel of the path never launched: {launches}")
    check(launches["k_after_stateful_fused"] == full, "kernel 6 must run once on every full-width plan batch")
    check(launches["split_cumsums_u32"] == launches["cumsum_u32"] == probe,
          "kernels 2 and 3 must run only on probe plan batches")
    check(launches["mode_cost_sums"] == launches["partition_cost_sums"] == full + probe,
          "kernels 9 and 10 must run once on every plan batch")
    # the timed shapes are every shape the path launches: they account for every launch
    for (label, *_), c in zip(FILES, counted):
        model = check_accounting(label, shapes, c)
        plans = c.plans
        print(f"{label}: {plans['full']} full-width and {plans['probe']} probe plans, and the group route's "
              f"{plans['group-full']} and {plans['group-probe']}, each a graph replay; per kernel, launches, "
              f"time at the timed shapes and launches x (time - bound), largest first:")
        for name, (n, ms, excess) in sorted(model.items(), key=lambda kv: -kv[1][2]):
            print(f"  {name:22s} {n:4d} launches, {ms:.4f} ms, {excess:.4f} ms over the bound")

    with tempfile.TemporaryDirectory() as tmp:
        for (label, sr, depth, (left, right)), ref, (first_s, counts, peak, reserved) in zip(audio, refs, per_file):
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
                  f"peak device memory {peak / 2**30:.2f} GiB allocated, {reserved / 2**30:.2f} GiB reserved (the "
                  f"plan graphs' pool included); launches {counts}")

        kinds = check_kinds(audio, shapes, batches)
        phase_seconds("4 (the main path: real-size encodes)", t4)

        # 5. the goldens (all under 8 full blocks: the host route against the reference binary's bytes)
        t5 = time.perf_counter()
        check_goldens(tmp)
        phase_seconds("5 (the goldens)", t5)

        # 6-8. many files, one long file, the cold CLI
        t6 = time.perf_counter()
        batch = check_batch_paths(tmp, shapes, batches)
        phase_seconds("6 (many files)", t6)
        t7 = time.perf_counter()
        stream_launches, long_wav, long_lac = check_stream(tmp, shapes, batches)
        phase_seconds("7 (one long file)", t7)
        t8 = time.perf_counter()
        check_cold_cli(tmp)
        phase_seconds("8 (the cold CLI)", t8)

        # 10. the service
        t10 = time.perf_counter()
        by_path = {"files": launches, "pooled": batch["launches"], "stream": stream_launches,
                   "serve": check_serve(tmp, shapes, batches, batch, (long_wav, long_lac))}
        phase_seconds("10 (the service)", t10)

        # 11. decode on the card: phase 4's files, and a 3-minute file whose lanes are half FIR/LPC
        # (the gliding sines code every lane with a fixed predictor: kernel 7 has nothing to do there)
        t11 = time.perf_counter()
        noise = filtered_noise_stereo(FILES[0][3], 44100, 16, 4)
        files = [("3 min 44.1 kHz 16-bit stereo filtered noise",
                  FrameEncoder(12, 2, 44100, 16, device="cuda").encode_frame(*noise), *noise)]
        files += [(label, ref, left, right) for (label, _, _, (left, right)), ref in zip(audio, refs)] + kinds
        print("kernel 7 vs its plain version (bit-exact):")
        records[RESTORE] = check_restore([f[:2] for f in files if "noise" in f[0]], restore_rng)
        by_path["decode"] = check_decode(files, batch, batches)
        print(f"phase 11 (decode on the card): {time.perf_counter() - t11:.1f} s")

        # 12. the mesh: a stand-in of two entries on card 0, and every card when there are two or more
        t12 = time.perf_counter()
        by_path["mesh"] = check_mesh(tmp, shapes, batches, (*audio[0][3], refs[0]), batch, (long_wav, long_lac))
        phase_seconds("12 (the mesh)", t12)

        # 13. the group route: inputs under 8 full blocks, lanes outside the 24-bit domain, no native runtime
        by_path["group"] = check_group_route(tmp, shapes, batches)

        # 14. kernel 8 and the experiments
        check_phase14(batches, records, by_path)

        # 15. the captured plans: every shape bit-exact against eager plan_group
        by_path["graphs"] = check_graphs(batches)

    finish(t_start, records, by_path, "files", KERNELS)


def finish(t_start, records, by_path, path, names):
    """9. the port stands alone; then the kernel record (``launches`` from
    ``path``, kernels 7's and 8's from their own, ``OWN_PATH``) and the
    device record."""
    check("jax" not in sys.modules, "jax was imported")
    ref_mods = sorted(m for m in sys.modules if m == "lac_tpu" or m.startswith("lac_tpu."))
    check(not ref_mods, f"lac_tpu modules were imported: {ref_mods}")
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0], "replaces": KERNELS[name][1],
         "launches": by_path[OWN_PATH.get(name, path)][name],  # each kernel's own path
         "launches_by_path": {p: n[name] for p, n in by_path.items()},
         **records[name]} for name in names
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
