"""Build and load the port's CUDA kernels (``lac_tpu_torch/csrc/*.cu``).

``nvcc`` compiles every source into one shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers: seconds to
build, not minutes). The library is built on first use into
``lac_tpu_torch/build/``, keyed by a hash of the sources and flags, as
``lac_tpu/runtime/native.py`` does for the g++ runtime. A missing
toolkit or a failed build raises: there is no silent fallback.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "kcost.cu", _PKG / "csrc" / "row_scan.cu")
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# C entry -> its leading argument kinds ("p" pointer, "i" long long); every
# entry then takes (stream, device index) and returns a cudaError_t
_ENTRIES = {
    "lac_k_cost_sums": ("p", "i", "i", "i", "p"),
    "lac_split_cumsums_u32": ("p", "i", "i", "p", "p"),
    "lac_cumsum_u32": ("p", "i", "i", "p"),
    "lac_prefix_max_i32": ("p", "i", "i", "p"),
    "lac_suffix_min_i32": ("p", "i", "i", "p"),
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
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=time.perf_counter() - t0, log=proc.stdout + proc.stderr, path=str(out))
    return out


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
            _lib = lib
        return _lib
