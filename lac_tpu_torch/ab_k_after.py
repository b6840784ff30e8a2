"""Time kernel 6 (csrc/k_after.cu) against another source of it on one card, in turns.

    python -m lac_tpu_torch.ab_k_after OTHER_K_AFTER_CU

Run from the repository root, on a machine with a CUDA card and nvcc.
``OTHER_K_AFTER_CU`` is another version of the source with the same C
entry, for example the parent commit's, unpacked with ``git archive``
into a directory that ``.gitignore`` lists. The script

* builds this tree's ``csrc/k_after.cu`` and the other source, each alone
  into its own shared library with the port's nvcc flags, in parallel, and
  prints each one's ptxas report and the SASS instruction count of its
  ``k_after_kernel`` (``cuobjdump -sass``, NOPs left out);
* holds both bit-exact against kernel 6's plain version at (2816, 16384),
  on chip_smoke.py's kernel-6 rows (adversarial, near-threshold and
  window-, warp- and tile-edge rows) and on audio-like codes (geometric,
  mean 1000);
* times both on each input in turns (other, this, this, other; a CUDA
  graph of 20 launches between CUDA events, as chip_smoke.py times) beside
  chip_smoke.py's bound, under the card's name and power limit.
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

ROWS, N = 2816, 16384


def _build(src, out):
    proc = subprocess.run([_cuda_lib._nvcc(), *_cuda_lib.NVCC_FLAGS, "-shared", "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return "\n".join(line.strip() for line in (proc.stdout + proc.stderr).splitlines()
                     if "registers" in line or "spill" in line or "smem" in line)


def _sass_count(lib):
    """Instructions of k_after_kernel in ``lib`` (NOPs left out), or None without cuobjdump."""
    tool = os.path.join(os.path.dirname(_cuda_lib._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    for fn in sass.split("Function :")[1:]:
        if "k_after_kernel" in fn.splitlines()[0]:
            ops = re.findall(r"^\s*/\*[0-9a-f]{4,}\*/\s+([^;]*);", fn, re.M)
            return sum(1 for op in ops if not op.strip().startswith("NOP"))
    raise RuntimeError(f"no k_after_kernel in the SASS of {lib}")


def _entry(lib):
    fn = ctypes.CDLL(str(lib)).lac_k_after_stateful
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int

    def run(x):
        out = torch.empty_like(x)
        err = fn(x.data_ptr(), x.shape[0], x.shape[1], out.data_ptr(), torch.cuda.current_stream().cuda_stream,
                 x.device.index)
        if err != 0:
            raise RuntimeError(f"{lib.name}: CUDA error {err}")
        return out

    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=pathlib.Path, help="the other k_after.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_k_after: no CUDA card")
    import chip_smoke  # the repository root's kernel inputs, timing and bound

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out_dir = _cuda_lib.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    sides = {"other": args.other.resolve(), "this": pathlib.Path(_cuda_lib.__file__).parent.parent / "csrc" / "k_after.cu"}
    libs = {side: out_dir / f"k_after_{side}.so" for side in sides}
    with ThreadPoolExecutor(2) as ex:
        logs = dict(zip(sides, ex.map(_build, sides.values(), libs.values())))
    run = {}
    for side, src in sides.items():
        print(f"{side}: {src}")
        print(f"  ptxas: {logs[side]}")
        print(f"  SASS instructions of k_after_kernel: {_sass_count(libs[side])}")
        run[side] = _entry(libs[side])

    rng = np.random.RandomState(20261016)
    inputs = {
        "kernel-6 rows": chip_smoke.k_after_codes(ROWS, N, rng),
        "audio-like codes": rng.geometric(1e-3, (ROWS, N)).astype(np.uint32).view(np.int32),
    }
    for label, codes in inputs.items():
        x = torch.from_numpy(codes).cuda()
        want = K.k_after_stateful_fused_plain(x)
        for side in sides:
            chip_smoke.check(torch.equal(run[side](x), want), f"{side} differs from the plain version on {label}")
        t = [chip_smoke.time_ms(run[s], x) for s in ("other", "this", "this", "other")]
        bound_ms, bound_by = chip_smoke.bound("k_after_stateful_fused", x, want)
        print(f"{label} ({ROWS}, {N}): both bit-exact; other {t[0]:.4f} / {t[3]:.4f} ms, "
              f"this {t[1]:.4f} / {t[2]:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}): "
              f"other {100 * bound_ms / min(t[0], t[3]):.1f}%, this {100 * bound_ms / min(t[1], t[2]):.1f}% of it")


if __name__ == "__main__":
    main()
