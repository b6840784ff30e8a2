"""Time the port's kernels against other sources of them on one card, in turns.

    python -m lac_tpu_torch.ab_kernels [--kcost OTHER_KCOST_CU] [--row-scan OTHER_ROW_SCAN_CU ...]
        [--k-after OTHER_K_AFTER_CU] [--restore OTHER_RESTORE_CU ...] [--rice-scan OTHER_RICE_SCAN_CU]
        [--mode-costs [OTHER_MODE_COSTS_CU ...]] [--sass DIR]

Run from the repository root, on a machine with a CUDA card and nvcc.
Each ``OTHER_*`` is another version of that source with the same C
entries, for example the parent commit's, unpacked with ``git archive``
into a directory that ``.gitignore`` lists. For each option given, the
script builds this tree's source and the other ones, each alone into its
own shared library with the port's nvcc flags, all in parallel, prints
every kernel's ptxas report (registers, spill, shared memory) and, for
kernels 6 and 7, the SASS instruction count (``cuobjdump -sass``, NOPs
left out; ``--sass DIR`` writes each library's SASS there), holds every
timed call bit-exact against the plain version, and times in turns (the
sources in order, then in reverse; a CUDA graph of 20 launches between
CUDA events, as chip_smoke.py times) beside chip_smoke.py's bound, under
the card's name and power limit.

``--row-scan`` (kernels 2-5; the other sources first in the turns: others,
this, this, others): the four scans at the probe shapes (33792,
256) and (3072, 256), at 512, 1024 and 2048 samples a row, and at the long
rows' path shapes (2816, 16384), (256, 16384), (1408, 16384) and (128,
16384); this tree's source is also built with ``-DLAC_SCAN_SHORT_MAX=256``
and ``=1024`` (where the warp-per-row kernel hands over to the block
kernel; timed at 512-2048 samples a row), ``torch.cumsum`` /
``torch.cummax`` and a copy of the operand (``clone``: the same bytes
moved by PyTorch's copy kernel) are timed in the same turns. At the long
shapes kernels 4 and 5 of every source are also timed on one operand in
the same turns (the forward operand, then the reverse one), so that a gap
between them shows as data or direction.

``--kcost`` (kernel 1): this tree's source is also built with its
build-time choices set otherwise (``KCOST_VARIANTS``); the row sums at the
shapes both sources take (an older source has no ``head`` argument and no
partition entry: it is called through its five-argument entry), then one
plan's worth of k-cost work three ways: the other source's launches (head
and row apart, every partition order apart, as the planner called an
older source), this source with one launch per partition order (head and
row sums together), and this source's two launches (candidate stack;
winners, every order from one read).

``--k-after`` (kernel 6): at (2816, 16384) on chip_smoke.py's kernel-6
rows (adversarial, near-threshold and window-, warp- and tile-edge rows)
and on audio-like codes (geometric, mean 1000).

``--restore`` (kernel 7): the other sources first in the turns (other,
this, this, other); on the FIR/LPC lanes of chip_smoke.py's 3-minute
filtered-noise file, on chip_smoke.py's adversarial and tile-edge lanes,
and on the same file's residuals with every lane at one order (1: the
chain alone; 2, 4, 8, 12, 16 and 32: one template each), beside
chip_smoke.py's estimated serial floor and with the cycles one restored
sample takes at the 1.98 GHz boost clock; and the warm device-backend
decode of that file with each source's kernel 7 in turns. This tree's
source is also built once per template (``-DLAC_RESTORE_ONE_TEMPLATE``) for
a SASS census: the instructions a sample on the fast way and on the careful
way.

``--rice-scan`` (kernel 8): the other source first in the turns (other,
this, this, other); at the reader's (64, 4096) and (256, 16384), on rows
longer than the 32 KB the kernel stages at once, and on the hard and the
sync-hostile lanes of ``bench_device_reader``, with the cycles a token of
one lane takes at the 1.98 GHz boost clock. This tree's source is also
built with fixed segment widths and other warm-ups (``RICE_SCAN_VARIANTS``)
and once with ``-DLAC_RICE_SCAN_DEBUG``, whose fixpoint rounds a chunk and
thread 0's cycles by phase (slowest lane and mean) are printed per input
(that build is checked, not timed). The other source must have the same C
entry, as the parent's does.

``--mode-costs`` (kernels 9 and 10; other sources optional, first in the
turns): the SASS instruction counts of ``mode_cost_rows`` and of every
kernel-10 function of each source (``partition_cost_rows``, the general
path, and ``partition_cost_chunks<R>``, the power-of-two path); kernel 9
at (2816, 16384) and (33792, 256) on chip_smoke.py's operands; kernel 10
at its four path shapes (256, 16384) and (128, 16384) over orders 1..8,
(3072, 256) and (1024, 256) over orders 1..3, on chip_smoke.py's operands
and on audio-like codes, every source in turns, beside chip_smoke.py's
bound; then each source's kernel 10 at (256, 16384) over orders 1..p for
p = 1..8, each bit-exact, what each order adds and its SM cycles a
sample. A variant of the source (another chunk width, block shape or
layout) is timed as one more source.
"""

import argparse
import ctypes
import os
import pathlib
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .ops import _cuda_lib
from .ops import cuda_kernels as K

LANES, BLOCK = 256, 16384
K_AFTER_ROWS = 2816  # kernel 6's plan batch: 256 lanes x 11 candidates
# build-time choices of csrc/kcost.cu timed beside its defaults
KCOST_VARIANTS = (("-DLAC_KCOST_UNROLL=4",), ("-DLAC_KCOST_TREE_BLOCK=1024",))
CSRC = pathlib.Path(_cuda_lib.__file__).parent.parent / "csrc"


def _build(src, out, defines=()):
    """nvcc ``src`` alone into ``out``; returns one ptxas line per kernel."""
    nvcc = _cuda_lib._nvcc()
    proc = subprocess.run([nvcc, *_cuda_lib.NVCC_FLAGS, *defines, "-shared", "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    filt = os.path.join(os.path.dirname(nvcc), "cu++filt")
    report, name, spill = [], None, ""
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            if os.path.exists(filt):
                name = subprocess.run([filt, name], capture_output=True, text=True).stdout.strip() or name
            name = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\(bool\)", "", name).removeprefix("void ")
            name = name.split(">(")[0] + ">" if ">(" in name else name.split("(")[0]
        elif "spill" in line:
            spill = line.split("ptxas info    :")[-1].strip()
        elif "Used" in line and "registers" in line:
            report.append(f"    {name}: {line.split('ptxas info    :')[-1].strip()}; {spill}")
    return "\n".join(report)


def _sass_counts(lib, mark):
    """{function: instructions (NOPs left out)} of every function of
    ``lib`` whose name holds ``mark``, or None without cuobjdump."""
    tool = os.path.join(os.path.dirname(_cuda_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    counts = {}
    for fn in sass.split("Function :")[1:]:
        name = fn.splitlines()[0].strip()
        if mark in name:
            ops = re.findall(r"^\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);", fn, re.M)
            counts[name] = sum(1 for op in ops if not op.strip().startswith("NOP"))
    return counts


def _sass_count(lib, kernel):
    """Instructions of ``kernel`` in ``lib`` (NOPs left out), or None without cuobjdump."""
    counts = _sass_counts(lib, kernel)
    if counts is None:
        return None
    if not counts:
        raise RuntimeError(f"no {kernel} in the SASS of {lib}")
    return next(iter(counts.values()))


def _build_all(tag, builds, out_dir, sass_dir, kernel=None):
    """Build every side {side: (source, defines)} alone, in parallel, and
    print each one's ptxas lines (and the SASS instruction count of
    ``kernel``); with ``sass_dir``, write each library's SASS there.
    Returns {side: library path}."""
    libs = {side: out_dir / f"{tag}_{i}.so" for i, side in enumerate(builds)}
    with ThreadPoolExecutor(len(builds)) as ex:
        logs = list(ex.map(lambda side: _build(builds[side][0], libs[side], builds[side][1]), builds))
    for side, log in zip(builds, logs):
        print(f"{tag}, {side}: {builds[side][0]} {' '.join(builds[side][1])}\n{log}")
        if kernel:
            print(f"    SASS instructions of {kernel}: {_sass_count(libs[side], kernel)}")
        if sass_dir:
            sass_dir.mkdir(parents=True, exist_ok=True)
            tool = os.path.join(os.path.dirname(_cuda_lib._nvcc()), "cuobjdump")
            sass = subprocess.run([tool, "-sass", str(libs[side])], capture_output=True, text=True, check=True)
            (sass_dir / f"{tag}_{libs[side].stem}.sass").write_text(sass.stdout)
    return libs


def _bind(lib, name, kinds):
    fn = getattr(lib, name)
    types = {"p": ctypes.c_void_p, "i": ctypes.c_longlong}
    fn.argtypes = [types[k] for k in kinds] + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int

    def call(x, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream, x.device.index)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    return call


def _scan_entries(path):
    """name -> function of a (rows, n) int32 tensor, for one row_scan library."""
    lib = ctypes.CDLL(str(path))

    def one(entry):
        fn = _bind(lib, entry, "piip")

        def run(x):
            out = torch.empty_like(x)
            fn(x, x.data_ptr(), x.shape[0], x.shape[1], out.data_ptr())
            return out

        return run

    split = _bind(lib, "lac_split_cumsums_u32", "piipp")

    def run_split(x):
        hi, lo = torch.empty_like(x), torch.empty_like(x)
        split(x, x.data_ptr(), x.shape[0], x.shape[1], hi.data_ptr(), lo.data_ptr())
        return hi, lo

    return {"split_cumsums_u32": run_split, "cumsum_u32": one("lac_cumsum_u32"),
            "prefix_max_i32": one("lac_prefix_max_i32"), "suffix_min_i32": one("lac_suffix_min_i32")}


def _kcost_entries(path):
    """(sums(x, head=0), partition_sums(x, max_p) or None) for one kcost library."""
    lib = ctypes.CDLL(str(path))
    if not hasattr(lib, "lac_k_cost_partition_sums"):  # an older source: row sums only
        old = _bind(lib, "lac_k_cost_sums", "piiip")

        def sums_old(x, head=0):
            assert head == 0
            out = torch.empty((x.shape[0], 17), dtype=torch.int32, device=x.device)
            old(x, x.data_ptr(), x.shape[0], x.shape[1], max(x.stride(0), x.shape[1]), out.data_ptr())
            return out

        return sums_old, None
    new = _bind(lib, "lac_k_cost_sums", "piiiipp")
    part = _bind(lib, "lac_k_cost_partition_sums", "piiiip")

    def sums(x, head=0):
        out = torch.empty((x.shape[0], 17), dtype=torch.int32, device=x.device)
        out_head = torch.empty_like(out) if head else None
        new(x, x.data_ptr(), x.shape[0], x.shape[1], max(x.stride(0), x.shape[1]), head,
            out_head.data_ptr() if head else None, out.data_ptr())
        return (out_head, out) if head else out

    def partition_sums(x, max_p):
        out = torch.empty((x.shape[0], (2 << max_p) - 1, 17), dtype=torch.int32, device=x.device)
        part(x, x.data_ptr(), x.shape[0], x.shape[1], max(x.stride(0), x.shape[1]), max_p, out.data_ptr())
        return out

    return sums, partition_sums


def _equal(got, want):
    got, want = (t if isinstance(t, (tuple, list)) else (t,) for t in (got, want))
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _turns(chip_smoke, label, x, sides, want, bound_ms, extra=""):
    """Check every side against ``want`` and time them in turns: the sides in order, then reversed."""
    for name, fn in sides.items():
        if want is not None:
            chip_smoke.check(_equal(fn(x), want), f"{label}: {name} differs from the plain version")
    order = list(sides) + list(reversed(sides))
    t = {}
    for name in order:
        t.setdefault(name, []).append(chip_smoke.time_ms(sides[name], x))
    txt = "; ".join(f"{name} {a:.4f} / {b:.4f} ms" + (f" ({100 * bound_ms / min(a, b):.0f}%)" if bound_ms else "")
                    for name, (a, b) in t.items())
    bound_txt = f"; bound {bound_ms:.4f} ms" if bound_ms else ""
    print(f"  {label}: {txt}{bound_txt}{extra}")
    return {name: min(v) for name, v in t.items()}


def ab_row_scan(chip_smoke, others, out_dir, rng, sass_dir):
    this = CSRC / "row_scan.cu"
    names = [src.stem for src in others]  # several others are told apart by their file names
    if len(others) == 1 or len(set(names)) < len(names) or "this" in names:
        names = [f"other{i}" if len(others) > 1 else "other" for i in range(1, len(others) + 1)]
    builds = {name: (src, ()) for name, src in zip(names, others)}
    builds.update({"this": (this, ()), "this, short <= 256": (this, ("-DLAC_SCAN_SHORT_MAX=256",)),
                   "this, short <= 1024": (this, ("-DLAC_SCAN_SHORT_MAX=1024",))})
    libs = _build_all("row_scan", builds, out_dir, sass_dir)
    entries = {side: _scan_entries(lib) for side, lib in libs.items()}
    library = {"cumsum_u32": lambda x: torch.cumsum(x, -1, dtype=torch.int32),
               "prefix_max_i32": lambda x: torch.cummax(x, -1).values}
    group = chip_smoke.GROUP_LANES
    shapes = [(12 * LANES * 11, 256), (12 * LANES, 256), (6 * LANES * 11, 512), (3 * LANES * 11, 1024),
              (3 * LANES * 11 // 2, 2048), (LANES * 11, BLOCK), (LANES, BLOCK), (group * 11, BLOCK), (group, BLOCK)]

    def timed_here(side, n):  # a variant is timed only where it differs from "this"
        return "short" not in side or 256 < n <= 2048

    for rows, n in shapes:
        codes = chip_smoke.adversarial_codes(rows, n, rng)
        operands = {}
        for name in entries["this"]:
            if name.endswith("_i32"):
                x = torch.from_numpy(chip_smoke.break_indices(codes, rng, name == "suffix_min_i32")).cuda()
                operands[name] = x
            else:
                x = torch.from_numpy(codes).cuda()
            want = getattr(K, name + "_plain")(x)
            sides = {side: e[name] for side, e in entries.items() if timed_here(side, n)}
            if name in library:
                chip_smoke.check(_equal(library[name](x), want), f"{name}: the library call differs")
                sides["library call"] = library[name]
            for side, fn in sides.items():
                chip_smoke.check(_equal(fn(x), want), f"{name} ({rows}, {n}): {side} differs from the plain version")
            if n > 2048:  # the same bytes through PyTorch's copy kernel
                sides["copy (clone)"] = torch.clone
            _turns(chip_smoke, f"{name} ({rows}, {n})", x, sides, None, chip_smoke.bound(name, x, want)[0])
            if name == "cumsum_u32" and n == 256:  # the same launch on zeros: does the time depend on the data?
                zeros = torch.zeros_like(x)
                _turns(chip_smoke, f"{name} ({rows}, {n}), all zeros", zeros, sides, zeros,
                       chip_smoke.bound(name, x, want)[0])
        if n <= 2048:
            continue
        # kernels 4 and 5 on one operand in the same turns: is a gap between them data or direction?
        for label, x in (("the forward operand", operands["prefix_max_i32"]),
                         ("the reverse operand", operands["suffix_min_i32"])):
            sides = {}
            for side in [k for k in entries if "short" not in k]:
                for name in ("prefix_max_i32", "suffix_min_i32"):
                    fn = entries[side][name]
                    chip_smoke.check(_equal(fn(x), getattr(K, name + "_plain")(x)), f"{side} {name} differs")
                    sides[f"{side} {name}"] = fn
            want = K.prefix_max_i32_plain(x)
            _turns(chip_smoke, f"kernels 4 and 5 on {label} ({rows}, {n})", x, sides, None,
                   chip_smoke.bound("prefix_max_i32", x, want)[0])


def ab_kcost(chip_smoke, other, out_dir, rng, sass_dir):
    this = CSRC / "kcost.cu"
    builds = {"other": (other, ()), "this": (this, ())}
    builds.update({f"this, {' '.join(d)}": (this, d) for d in KCOST_VARIANTS})
    libs = _build_all("kcost", builds, out_dir, sass_dir)
    entries = {side: _kcost_entries(lib) for side, lib in libs.items()}
    (o_sums, o_part), (t_sums, t_part) = entries["other"], entries["this"]
    row_sums = {side: e[0] for side, e in entries.items()}

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    stack = up(chip_smoke.adversarial_codes(LANES * 11, BLOCK, rng))
    probes = up(chip_smoke.adversarial_codes(12 * LANES * 11, 256, rng))
    winners, probe_winners = stack[:LANES], probes[: 12 * LANES]
    print("row sums at the shapes both sources take:")
    for label, x in (("(B*11, 16384)", stack), ("strided head (B*11, 256 of 16384)", stack[:, :256]),
                     ("probe (12B*11, 256)", probes), ("parts (2B, 8192)", winners.reshape(-1, 8192)),
                     ("parts (16B, 1024)", winners.reshape(-1, 1024)), ("parts (64B, 256)", winners.reshape(-1, 256)),
                     ("parts (256B, 64)", winners.reshape(-1, 64)), ("probe parts (96B, 32)", probe_winners.reshape(-1, 32))):
        want = K.k_cost_sums_plain(x)
        _turns(chip_smoke, label, x, row_sums, want, chip_smoke.bound("k_cost_sums", x, want)[0])

    print("the k-cost work of one plan (candidate stack, then the winners cut into 2^p parts, p = 1..max_p):")
    for label, cand, win, max_p in (("full-width plan", stack, winners, 8), ("probe plan", probes, probe_winners, 3)):
        n = cand.shape[1]
        head = min(256, n)

        def apart(pair, sums=o_sums):  # head and row apart, every order apart: an older source's launches
            cand, win = pair
            out = [sums(cand[:, :head]), sums(cand)]
            for p in range(1, max_p + 1):
                part = win.reshape(-1, n >> p)
                out += [sums(part[:, :head]), sums(part)]
            return out

        def per_order(pair, sums=t_sums):  # head and row sums together, one launch per order
            cand, win = pair
            return [sums(cand, head if head < n else 0)] + [
                sums(win.reshape(-1, n >> p), head if head < n >> p else 0) for p in range(1, max_p + 1)]

        def one_read(pair):  # this source's two launches
            cand, win = pair
            return [t_sums(cand, head if head < n else 0), t_part(win, max_p)]

        def one_read_other(pair):
            cand, win = pair
            return [o_sums(cand, head if head < n else 0), o_part(win, max_p)]

        # bit-exact: every order's row sums and heads against the plain version
        tree = t_part(win, max_p)
        for p in range(max_p + 1):
            want = K.k_cost_sums_plain(win.reshape(-1, n >> p)).reshape(win.shape[0], 1 << p, 17)
            chip_smoke.check(torch.equal(tree[:, (1 << p) - 1 : (2 << p) - 1], want), f"{label}: order {p} differs")
        for got, x in zip(per_order((cand, win)), [cand] + [win.reshape(-1, n >> p) for p in range(1, max_p + 1)]):
            want = K.k_cost_sums_plain(x, head) if head < x.shape[1] else K.k_cost_sums_plain(x)
            chip_smoke.check(_equal(got, want), f"{label}: per-order sums differ at {tuple(x.shape)}")
        sides = {"other, its launches": one_read_other if o_part else apart,
                 "this, one launch per order": per_order, "this, two launches": one_read}
        counts = {"other, its launches": 2 if o_part else 2 + 2 * max_p, "this, one launch per order": 1 + max_p,
                  "this, two launches": 2}
        for side, (v_sums, v_part) in entries.items():
            if side not in ("other", "this"):
                sides[f"{side}, two launches"] = (lambda pair, a=v_sums, b=v_part:
                                                  [a(pair[0], head if head < n else 0), b(pair[1], max_p)])
        _turns(chip_smoke, label, (cand, win), sides, None, 0.0,
               extra="; launches " + ", ".join(f"{k}: {v}" for k, v in counts.items()))


def ab_k_after(chip_smoke, other, out_dir, rng, sass_dir):
    libs = _build_all("k_after", {"other": (other, ()), "this": (CSRC / "k_after.cu", ())}, out_dir, sass_dir,
                      "k_after_kernel")

    def entry(path):
        fn = _bind(ctypes.CDLL(str(path)), "lac_k_after_stateful", "piip")

        def run(x):
            out = torch.empty_like(x)
            fn(x, x.data_ptr(), x.shape[0], x.shape[1], out.data_ptr())
            return out

        return run

    sides = {side: entry(lib) for side, lib in libs.items()}
    inputs = {"kernel-6 rows": chip_smoke.k_after_codes(K_AFTER_ROWS, BLOCK, rng),
              "audio-like codes": rng.geometric(1e-3, (K_AFTER_ROWS, BLOCK)).astype(np.uint32).view(np.int32)}
    for label, codes in inputs.items():
        x = torch.from_numpy(codes).cuda()
        want = K.k_after_stateful_fused_plain(x)
        _turns(chip_smoke, f"{label} ({K_AFTER_ROWS}, {BLOCK})", x, sides, want,
               chip_smoke.bound("k_after_stateful_fused", x, want)[0])


def _sass_loops(lib, kernel):
    """The loops of ``kernel`` in ``lib``'s SASS (a branch back to an earlier
    instruction): [(instructions, float64 multiplies (DFMA, DMUL), IMAD.WIDE
    count, opcode counts)], NOPs left out."""
    tool = os.path.join(os.path.dirname(_cuda_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    fn = next(f for f in sass.split("Function :")[1:] if kernel in f.splitlines()[0])
    instrs, labels = [], {}
    for line in fn.splitlines():
        label = re.match(r"^\s*(\.L_x_\d+):", line)
        if label:
            labels[label.group(1)] = len(instrs)
            continue
        m = re.match(r"^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m and not m.group(2).strip().startswith("NOP"):
            instrs.append((int(m.group(1), 16), re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())))
    at = {addr: i for i, (addr, _) in enumerate(instrs)}
    loops = []
    for i, (_, text) in enumerate(instrs):
        target = re.match(r"BRA[.\w]*\s+(?:!?U?P\w+,\s*)?(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", text)
        if not target:
            continue
        name = target.group(1)
        j = labels.get(name) if name.startswith(".L") else at.get(int(name, 16))
        if j is not None and j <= i:
            ops = [t.split()[0] for _, t in instrs[j : i + 1]]
            fmul = sum(op.startswith(("DFMA", "DMUL")) for op in ops)
            loops.append((len(ops), fmul, ops.count("IMAD.WIDE"), {op: ops.count(op) for op in set(ops)}))
    return loops


def restore_sass_census(out_dir):
    """Per template of this tree's csrc/restore.cu (one library each, built
    with -DLAC_RESTORE_ONE_TEMPLATE=H): SASS instructions a sample on the
    fast way (the unrolled body: the loop with the most IMAD.WIDE), in the
    4-sample fast groups and on the careful way (one sample an iteration),
    with the fast body's opcodes a sample. Each is the innermost loop (the
    fewest instructions) with the multiplies of its kind: H float64 ones a
    sample for at least 32 samples (the body) or for 4 (a group), H
    IMAD.WIDE for one (a careful step)."""
    builds = {f"H = {h}": (CSRC / "restore.cu", (f"-DLAC_RESTORE_ONE_TEMPLATE={h}",)) for h in K.RESTORE_TEMPLATES}
    libs = _build_all("restore_census", builds, out_dir, None)
    print("SASS instructions a sample, this tree's restore.cu, by template (fast body / fast 4-sample group / "
          "careful step):")
    for h, (side, lib) in zip(K.RESTORE_TEMPLATES, libs.items()):
        loops = _sass_loops(lib, "restore_kernel")

        def innermost(kind, lo, hi):
            return min((lp for lp in loops if lo <= lp[kind] < hi), key=lambda lp: lp[0], default=None)

        body, quad, step = innermost(1, 32 * h, 1 << 30), innermost(1, 4 * h, 4 * h + 4), innermost(2, h, 2 * h)
        samples = body[1] // h
        ops = ", ".join(f"{op} {n / samples:.2f}" for op, n in sorted(body[3].items(), key=lambda kv: -kv[1]))
        print(f"  {side}: fast body {body[0] / samples:.2f} ({samples} samples, {body[0]} instructions), "
              f"fast group {quad[0] / 4 if quad else float('nan'):.2f}, careful {step[0] if step else 'n/a'}; "
              f"fast body a sample: {ops}")


class _WithRestore:
    """The port's kernel library with another source's kernel 7 entry."""

    def __init__(self, base, entry):
        self._base, self.lac_recurrence_restore = base, entry

    def __getattr__(self, name):
        return getattr(self._base, name)


def restore_decode_walls(chip_smoke, libs, frame, left, right):
    """Warm walls of ``FrameDecoder(backend="device").decode(frame)`` with each
    library's kernel 7 in turns (the sides, then reversed), PCM held to the input."""
    from .decoder import FrameDecoder

    base, dec, entries = _cuda_lib.load(), FrameDecoder(backend="device"), {}
    for side, path in libs.items():
        fn = ctypes.CDLL(str(path)).lac_recurrence_restore
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int]
        fn.restype = ctypes.c_int
        entries[side] = fn
    walls = {}
    try:
        for side in list(entries) + list(reversed(entries)):
            _cuda_lib._lib = _WithRestore(base, entries[side])
            dec.decode(frame)
            got, wall, _ = chip_smoke.timed_on_card(lambda: dec.decode(frame))
            chip_smoke.check(np.array_equal(got[0], left) and np.array_equal(got[1], right),
                             f"device decode with {side}'s kernel 7: PCM differs from the input")
            walls.setdefault(side, []).append(wall)
    finally:
        _cuda_lib._lib = base
    print("  device decode of the 3-minute noise file, warm, PCM-exact (s): "
          + "; ".join(f"{side} {a:.4f} / {b:.4f}" for side, (a, b) in walls.items()))


def ab_restore(chip_smoke, others, out_dir, rng, sass_dir):
    from .encoder import FrameEncoder
    from .profile_encode import filtered_noise_stereo

    builds = {f"other{i}": (src, ()) for i, src in enumerate(others, 1)}
    builds["this"] = (CSRC / "restore.cu", ())  # turns: the others, this, this, the others
    libs = _build_all("restore", builds, out_dir, sass_dir, "restore_kernel")
    restore_sass_census(out_dir)

    def entry(path):
        fn = _bind(ctypes.CDLL(str(path)), "lac_recurrence_restore", "ppppppiipp")

        def run(t):
            res = t[0]
            out = torch.empty(res.shape, dtype=torch.int32, device=res.device)
            ok = torch.empty(res.shape[0], dtype=torch.bool, device=res.device)
            fn(res, *(a.data_ptr() for a in t), res.shape[0], res.shape[1], out.data_ptr(), ok.data_ptr())
            return out, ok

        return run

    sides = {side: entry(lib) for side, lib in libs.items()}
    noise = filtered_noise_stereo(7_938_000, 44100, 16, 4)
    frame = FrameEncoder(12, 2, 44100, 16, device="cuda").encode_frame(*noise)
    restore_decode_walls(chip_smoke, libs, frame, *noise)
    path = chip_smoke.restore_operands(frame)
    inputs = {"3 min filtered noise, FIR/LPC lanes": path,
              "adversarial lanes": chip_smoke.adversarial_restore_lanes(4096, rng),
              "tile-edge lanes": chip_smoke.tile_edge_restore_lanes(4096, rng)}
    for h in (1, *K.RESTORE_TEMPLATES):  # order 1: the chain and nothing else; then every template
        res = path[0]
        cs = np.stack([chip_smoke.q15_taps(rng, h, True) for _ in range(len(res))])
        vec = np.full(len(res), h, np.int32)
        inputs[f"the same residuals, every lane order {h}"] = (
            res, cs, vec, np.full_like(vec, 15), np.zeros_like(vec), np.full_like(vec, res.shape[1]))
    for label, ops in inputs.items():
        t = tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda() for a in ops)
        want = K.recurrence_restore_plain(*t)
        lanes, L = t[0].shape
        valid = np.minimum(ops[5], L).astype(np.int64)
        work = int((valid * (chip_smoke.OPS_PER_ELEMENT[chip_smoke.RESTORE] + chip_smoke.OPS_PER_TAP * ops[2])).sum())
        floor_ms = L * chip_smoke.SERIAL_CYCLES_PER_STEP / chip_smoke.SM_CLOCK_HZ * 1e3
        best = _turns(chip_smoke, f"{label} ({lanes}, {L})", t, sides, want,
                      chip_smoke.bound(chip_smoke.RESTORE, t, want, ops=work)[0],
                      extra=f"; serial floor {floor_ms:.4f} ms (an estimate from the source)")
        print("    cycles per sample: " + ", ".join(f"{side} {ms * 1e-3 * chip_smoke.SM_CLOCK_HZ / L:.1f}"
                                                     for side, ms in best.items()))


# this tree's kernel 8 built with fixed segment widths (bits a thread's segment; by default a lane's head
# over the block) and other warm-ups (bits a speculative parse runs before its segment)
RICE_SCAN_VARIANTS = (("-DLAC_RICE_SCAN_W=128",), ("-DLAC_RICE_SCAN_W=256",), ("-DLAC_RICE_SCAN_WARM=0",),
                      ("-DLAC_RICE_SCAN_WARM=256",))


def _rice_scan_entry(path, debug=False):
    """One rice_scan library's kernel 8 as a function of (payload, k, nbits,
    tokens); with ``debug``, also (lanes, 9) int64 per lane of (chunks,
    fixpoint rounds in all, the most in one chunk, thread 0's cycles in
    set-up, speculative pass, rounds, scan, write pass, tail) from a
    -DLAC_RICE_SCAN_DEBUG build."""
    lib = ctypes.CDLL(str(path))
    fn = _bind(lib, "lac_rice_scan_tokenize", "piippipp")

    def run(t):
        payload, k, nbits, tokens = t
        res = torch.empty((payload.shape[0], tokens), dtype=torch.int32, device=payload.device)
        valid = torch.empty((payload.shape[0], tokens), dtype=torch.bool, device=payload.device)
        fn(payload, payload.data_ptr(), payload.shape[0], payload.shape[1], k.data_ptr(), nbits.data_ptr(), tokens,
           res.data_ptr(), valid.data_ptr())
        return res, valid

    if not debug:
        return run
    set_rounds = lib.lac_rice_scan_debug_rounds
    set_rounds.argtypes, set_rounds.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int

    def rounds(t):
        out = torch.full((t[0].shape[0], 9), -2, dtype=torch.int64, device=t[0].device)
        err = set_rounds(out.data_ptr(), t[0].device.index)
        got = run(t)
        torch.cuda.synchronize()
        set_rounds(None, t[0].device.index)
        if err:
            raise RuntimeError(f"lac_rice_scan_debug_rounds: CUDA error {err}")
        return got, out.cpu().numpy()

    return run, rounds


def rice_scan_inputs():
    """Kernel 8's inputs, label -> (payload, k, nbits, tokens) on the card: the
    reader's two shapes, rows over one staged region, the hard and the
    sync-hostile batches."""
    from .experiments import bench_device_reader as bdr

    dev = torch.device("cuda")
    inputs = {}
    for label, (ks, vals) in (("(64, 4096)", bdr.make_lanes(np.random.RandomState(11), 64, 4096)),
                              ("(256, 16384)", bdr.make_lanes(np.random.RandomState(11), 256, 16384)),
                              ("rows over 32 KB (4, 13000)", bdr.long_lanes(np.random.RandomState(13)))):
        payload, nbits = bdr.pack_lanes(vals, ks, dev)
        inputs[label] = (payload, torch.from_numpy(ks).to(dev), nbits, vals.shape[1])
    for label, pay, ks, nb, tokens in bdr.adversarial_batches() + bdr.sync_hostile_batches():
        inputs[label] = (*(torch.from_numpy(a).to(dev) for a in (pay, ks, nb)), tokens)
    return inputs


def ab_rice_scan(chip_smoke, other, out_dir, rng, sass_dir):
    this = CSRC / "rice_scan.cu"
    builds = {"other": (other, ()), "this": (this, ())}
    builds.update({f"this, {' '.join(d)}": (this, d) for d in RICE_SCAN_VARIANTS})
    builds["this, rounds"] = (this, ("-DLAC_RICE_SCAN_DEBUG",))
    libs = _build_all("rice_scan", builds, out_dir, sass_dir)
    _, rounds = _rice_scan_entry(libs.pop("this, rounds"), debug=True)
    sides = {side: _rice_scan_entry(lib) for side, lib in libs.items()}
    clock = chip_smoke.SM_CLOCK_HZ
    for label, t in rice_scan_inputs().items():
        payload, k, nbits, tokens = t
        want = K.tokenize_static_rice_scan_plain(*t)
        got, per_lane = rounds(t)
        chip_smoke.check(_equal(got, want), f"{label}: the rounds build differs from the plain version")
        fast = per_lane[per_lane[:, 0] >= 0]
        most = fast[:, 2].max() if len(fast) else 0
        print(f"  {label}: {len(fast)} fast lanes of {len(per_lane)}, chunks {int(fast[:, 0].sum())}, fixpoint "
              f"rounds a chunk: mean {fast[:, 1].sum() / max(fast[:, 0].sum(), 1):.3f}, most {int(most)}; "
              f"lanes by their most: {dict(zip(*(v.tolist() for v in np.unique(fast[:, 2], return_counts=True))))}")
        if len(fast):
            cycles = fast[:, 3:]
            slow = cycles[cycles.sum(axis=1).argmax()]
            names = ("set-up", "speculative", "rounds", "scan", "write", "tail")
            print("    thread 0's cycles by phase (the rounds build), slowest lane / mean: " + ", ".join(
                f"{n} {int(a)} / {b:.0f}" for n, a, b in zip(names, slow, cycles.mean(axis=0)))
                  + f"; total {int(slow.sum())} / {cycles.sum(axis=1).mean():.0f}")
        lanes = payload.shape[0]
        bound = chip_smoke.bound(chip_smoke.SCAN, (payload, k, nbits), want,
                                 ops=chip_smoke.OPS_PER_ELEMENT[chip_smoke.SCAN] * lanes * tokens)[0]
        best = _turns(chip_smoke, f"{label} ({lanes} lanes, {tokens} tokens, {payload.shape[1]} B rows)", t, sides,
                      want, bound)
        print("    cycles per token of a lane: " + ", ".join(f"{side} {ms * 1e-3 * clock / tokens:.1f}"
                                                          for side, ms in best.items()))


def _mode_cost_entries(path):
    """(mode_cost_sums(ops), partition_cost_sums(ops, max_p)) for one mode_costs library."""
    lib = ctypes.CDLL(str(path))
    rows_fn = _bind(lib, "lac_mode_cost_sums", "pppppiip")
    parts_fn = _bind(lib, "lac_partition_cost_sums", "ppppiiip")

    def mode(ops):
        x = ops[0]
        out = torch.empty((x.shape[0], 4), dtype=torch.int64, device=x.device)
        rows_fn(x, *(t.data_ptr() for t in ops), x.shape[0], x.shape[1], out.data_ptr())
        return out

    def parts(ops, max_p):
        x = ops[0]
        out = torch.empty((x.shape[0], K.partition_parts(max_p), 4), dtype=torch.int64, device=x.device)
        parts_fn(x, *(t.data_ptr() for t in ops), x.shape[0], x.shape[1], max_p, out.data_ptr())
        return out

    return mode, parts


# kernel 10 at the main path's shapes: (rows, n, max_p) of a full-width plan, a probe plan, and the group route's caps
PARTITION_SHAPES = ((LANES, BLOCK, 8), (12 * LANES, 256, 3), (128, BLOCK, 8), (1024, 256, 3))


def ab_mode_costs(chip_smoke, others, out_dir, rng, sass_dir):
    builds = {f"other {i}" if len(others) > 1 else "other": (src, ()) for i, src in enumerate(others)}
    builds["this"] = (CSRC / "mode_costs.cu", ())
    libs = _build_all("mode_costs", builds, out_dir, sass_dir)
    for side, lib in libs.items():
        kernel10 = _sass_counts(lib, "partition_cost_") or {}
        short = (re.search(r"partition_cost_(?:rows|chunks)(?:ILi\d+E)?", name)[0] for name in kernel10)
        named = sorted(zip((re.sub(r"ILi(\d+)E", r"<\1>", name) for name in short), kernel10.values()))
        print(f"    {side}: SASS instructions of mode_cost_rows<256, true> (long rows, 16-byte loads) "
              f"{_sass_count(lib, 'mode_cost_rowsILi256ELb1E')}; of "
              + ", ".join(f"{name} {count}" for name, count in named))
    entries = {side: _mode_cost_entries(lib) for side, lib in libs.items()}
    dev = torch.device("cuda")
    for rows, n in ((K_AFTER_ROWS, BLOCK), (12 * K_AFTER_ROWS, 256)):
        ops = chip_smoke.mode_cost_operands(chip_smoke.adversarial_codes(rows, n, rng), rng, dev)
        want = K.mode_cost_sums_plain(*ops)
        _turns(chip_smoke, f"kernel 9 ({rows}, {n})", ops, {side: e[0] for side, e in entries.items()}, want,
               chip_smoke.bound("mode_cost_sums", ops, want)[0])
    print(f"  kernel 10's path: {', '.join(f'n = {n} {K.partition_cost_path(n)}' for n in (BLOCK, 256))} (this)")
    for rows, n, max_p in PARTITION_SHAPES:
        audio = rng.geometric(1e-3, (rows, n)).astype(np.uint32).view(np.int32)
        for label, c in (("adversarial", chip_smoke.adversarial_codes(rows, n, rng)), ("audio-like", audio)):
            ops = chip_smoke.partition_cost_operands(c, max_p, rng, dev)
            want = K.partition_cost_sums_plain(*ops, max_p)
            sides = {side: (lambda o, f=e[1], m=max_p: f(o, m)) for side, e in entries.items()}
            _turns(chip_smoke, f"kernel 10, {label} ({rows}, {n}), orders 1..{max_p}", ops, sides, want,
                   chip_smoke.bound("partition_cost_sums", ops, want)[0])
    ops = chip_smoke.partition_cost_operands(chip_smoke.adversarial_codes(LANES, BLOCK, rng), 8, rng, dev)
    cycles = chip_smoke.SM_CLOCK_HZ * torch.cuda.get_device_properties(dev).multi_processor_count / (LANES * BLOCK)
    for side, (_, parts) in entries.items():
        times = []
        for max_p in range(1, 9):
            cut = (*ops[:3], ops[3][:, : K.partition_parts(max_p)].contiguous())
            want = K.partition_cost_sums_plain(*cut, max_p)
            chip_smoke.check(torch.equal(parts(cut, max_p), want), f"kernel 10, {side}, orders 1..{max_p}: differs")
            times.append(min(chip_smoke.time_ms(lambda o, m=max_p: parts(o, m), cut) for _ in range(2)))
        adds = [b - a for a, b in zip(times, times[1:])]
        print(f"  kernel 10 ({LANES}, {BLOCK}), {side}, orders 1..p for p = 1..8: "
              + ", ".join(f"{t:.4f}" for t in times) + " ms; each order adds "
              + ", ".join(f"{d:.4f}" for d in adds) + " ms, SM cycles a sample and order "
              + ", ".join(f"{d * 1e-3 * cycles:.3f}" for d in adds) + " (at the 1.98 GHz boost clock)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kcost", type=pathlib.Path, help="the other kcost.cu")
    ap.add_argument("--row-scan", type=pathlib.Path, nargs="+", help="other row_scan.cu sources")
    ap.add_argument("--k-after", type=pathlib.Path, help="the other k_after.cu")
    ap.add_argument("--restore", type=pathlib.Path, nargs="+", help="other restore.cu sources")
    ap.add_argument("--rice-scan", type=pathlib.Path, help="the other rice_scan.cu")
    ap.add_argument("--mode-costs", type=pathlib.Path, nargs="*", help="other mode_costs.cu sources (none: this)")
    ap.add_argument("--sass", type=pathlib.Path, help="write each library's SASS into this directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA card")
    import chip_smoke  # the repository root's kernel inputs, timing and bound

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out_dir = _cuda_lib.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(20261016)
    if args.row_scan:
        ab_row_scan(chip_smoke, [src.resolve() for src in args.row_scan], out_dir, rng, args.sass)
    if args.kcost:
        ab_kcost(chip_smoke, args.kcost.resolve(), out_dir, rng, args.sass)
    if args.k_after:
        ab_k_after(chip_smoke, args.k_after.resolve(), out_dir, rng, args.sass)
    if args.restore:
        ab_restore(chip_smoke, [src.resolve() for src in args.restore], out_dir, rng, args.sass)
    if args.rice_scan:
        ab_rice_scan(chip_smoke, args.rice_scan.resolve(), out_dir, rng, args.sass)
    if args.mode_costs is not None:
        ab_mode_costs(chip_smoke, [src.resolve() for src in args.mode_costs], out_dir, rng, args.sass)


if __name__ == "__main__":
    main()
