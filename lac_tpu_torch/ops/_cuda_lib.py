"""Build and load the port's CUDA kernels (``lac_tpu_torch/csrc/*.cu``).

``nvcc`` compiles the sources into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: seconds to
build, not minutes). Each source compiles in its own ``nvcc`` process,
all started together, then one link. The library is built on first use
into ``lac_tpu_torch/build/``, keyed by a hash of the sources and flags,
under an ``fcntl.flock`` on ``build/.lock`` with per-process temp names,
as :mod:`..runtime.native` does for the g++ runtime. A missing toolkit
or a failed build raises: there is no silent fallback.
"""

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name
                for name in ("kcost.cu", "row_scan.cu", "k_after.cu", "restore.cu", "rice_scan.cu", "mode_costs.cu"))
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# C entry -> its leading argument kinds ("p" pointer, "i" long long); every
# entry then takes (stream, device index) and returns a cudaError_t
_ENTRIES = {
    "lac_k_cost_sums": ("p", "i", "i", "i", "i", "p", "p"),
    "lac_k_cost_partition_sums": ("p", "i", "i", "i", "i", "p"),
    "lac_split_cumsums_u32": ("p", "i", "i", "p", "p"),
    "lac_cumsum_u32": ("p", "i", "i", "p"),
    "lac_prefix_max_i32": ("p", "i", "i", "p"),
    "lac_suffix_min_i32": ("p", "i", "i", "p"),
    "lac_k_after_stateful": ("p", "i", "i", "p"),
    "lac_recurrence_restore": ("p", "p", "p", "p", "p", "p", "i", "i", "p", "p"),
    "lac_rice_scan_tokenize": ("p", "i", "i", "p", "p", "i", "p", "p"),
    "lac_mode_cost_sums": ("p", "p", "p", "p", "p", "i", "i", "p"),
    "lac_partition_cost_sums_tally": ("p", "p", "p", "p", "i", "i", "i", "p", "p"),
}
# C entry -> argument kinds of the entries that launch nothing (no stream, no
# device) and return an int
_QUERIES = {
    "lac_partition_cost_path": ("i",),
}

_lock = threading.Lock()
_lib = None
# filled by the build that ran in this process: seconds and nvcc's output
# (ptxas register / shared-memory report)
build_info = {"seconds": None, "log": "", "path": None}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): cannot build the lac_tpu_torch CUDA kernels")


def build_library():
    """Compile the kernels if no library for these sources exists; return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"lac_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        build_info["path"] = str(out)
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building the same library
        if not out.exists():
            _compile_and_link(nvcc, out)
    build_info["path"] = str(out)
    return out


def _compile_and_link(nvcc, out):
    t0 = time.perf_counter()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for src, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    try:
        for src, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_info.update(seconds=time.perf_counter() - t0, log="".join(logs))


def load():
    """The loaded ctypes library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            kinds = {"p": ctypes.c_void_p, "i": ctypes.c_longlong}
            for name, args in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = [kinds[a] for a in args] + [ctypes.c_void_p, ctypes.c_int]
                fn.restype = ctypes.c_int
            for name, args in _QUERIES.items():
                fn = getattr(lib, name)
                fn.argtypes = [kinds[a] for a in args]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
