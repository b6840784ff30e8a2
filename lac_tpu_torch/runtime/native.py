"""ctypes loader for the port's native runtime (``src/lac_runtime.cpp``,
a verbatim copy of lac_tpu/runtime/src/lac_runtime.cpp).

The shared library is built with g++ on first use into
``runtime/build/``, keyed by a hash of the source and flags. The build
holds an ``fcntl.flock`` on ``build/.lock``, compiles to a temp name
carrying the pid and finishes with ``os.replace``, so concurrent
processes neither race on one temp file nor load a half-written
library. A missing compiler or a failed build raises: a build that
fails is never taken as a reason to run without the runtime.

``LAC_TPU_NO_NATIVE=1`` (the JAX package's switch,
lac_tpu/runtime/native.py:68) is the explicit request to run without
it: nothing is built, :func:`native_available` is False and the callers
take their numpy/torch paths (the plan replay gives way to the token
fields of ``encoder.plan_group(emit_fields=True)`` and the numpy packer,
native decode to the Python reader). The switch is read when a function
here is called, so a test may set it for one process.

Only the entries the port calls are bound: plan replay
(``lac_emit_blocks_planes``, ``lac_emit_blocks``), the host planner
(``lac_plan_blocks``), autocorrelation, the stereo estimate, the three
decoders, the v3 tokenizer of the device decode backend and the thread
collector, and the experiments' twins: the batched element packer
(``lac_pack_streams``) and the static-Rice tokenizer
(``lac_tokenize_static_rice``).
"""

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "src" / "lac_runtime.cpp"
BUILD_DIR = _HERE / "build"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i8p = ctypes.POINTER(ctypes.c_int8)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_vp = ctypes.c_void_p
_u32, _u64, _i32 = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int32

# entry -> (restype, argtypes)
_ENTRIES = {
    "lac_thread_collector_reset": (None, []),
    "lac_thread_collector_count": (_u64, []),
    "lac_decode_v3_blocks": (ctypes.c_int, [_u8p, _u64p, _u64p, _u32p, _u64p, _u32, _u32, _u32, _u32,
                                            _i32p, _i32p, _i32]),
    "lac_decode_v3_to_pcm": (ctypes.c_int, [_u8p, _u64p, _u64p, _u32p, _u64p, _u32, _u32, _u32, _u32,
                                            _u8p, _i32]),
    "lac_decode_v2_stream": (ctypes.c_int, [_u8p, _u64, _u32p, _u64p, _u32, _u32, _u32, _u32, _i32p, _i32p]),
    "lac_tokenize_v3_blocks": (ctypes.c_int, [_u8p, _u64p, _u64p, _u32p, _u64p, _u32, _u32, _u32, _i32p, _u64,
                                              _u8p, _u8p, _i16p, _u8p, _i32]),
    "lac_emit_blocks": (ctypes.c_int, [_i32p, _u32, _u32, _u8p, _u8p, _i16p, _u8p, _u8p, _u8p,
                                       _u8p, _u64, _u64p, _i32]),
    "lac_emit_blocks_planes": (ctypes.c_int, [_vp, _vp, _u32, _u32, _i32p, _u8p, _u8p, _u32p, _u32, _u32,
                                              _u8p, _u8p, _i16p, _u8p, _u8p, _u8p, _u8p, _u64, _u64p, _i32]),
    "lac_plan_blocks": (ctypes.c_int, [_i32p, _u32, _u32, _i16p, _u8p, _u32, _u32, _i8p, _i32]),
    "lac_autocorr": (ctypes.c_int, [_i32p, _u32, _u32, _u32, _i64p, _i32]),
    "lac_stereo_estimate": (None, [_i32p, _i32p, _u32, _u32, _u8p, _u8p, _i32]),
    "lac_pack_streams_sizes": (None, [_u32p, _u8p, _u64p, _u32, _u64p]),
    "lac_pack_streams": (None, [_u32p, _u32p, _u8p, _u64p, _u32, _u8p, _u64p, _i32]),
    "lac_tokenize_static_rice": (ctypes.c_int, [_u8p, _u64, _u32p, _u64p, _u32, _u32, _i32p]),
}


def build_library():
    """Compile the runtime if no library for this source exists; return its path."""
    tag = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"lac_runtime-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building the same library
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True, text=True)
        except FileNotFoundError:
            raise RuntimeError("g++ not found: cannot build the lac_tpu_torch native runtime") from None
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}) building the native runtime:\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def disabled() -> bool:
    """True when ``LAC_TPU_NO_NATIVE=1`` asks for no native runtime."""
    return os.environ.get("LAC_TPU_NO_NATIVE") == "1"


def native_available() -> bool:
    """False under ``LAC_TPU_NO_NATIVE=1`` (nothing is built); else the
    runtime is built and loaded if it was not yet, and True. A failed
    build raises, as :func:`get_native` does."""
    if disabled():
        return False
    get_native()
    return True


def get_native():
    """The loaded ctypes library (built on first use); raises when it cannot
    be built, or when ``LAC_TPU_NO_NATIVE=1`` turned it off."""
    global _lib
    if disabled():
        raise RuntimeError("the native runtime is turned off (LAC_TPU_NO_NATIVE=1)")
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, (restype, argtypes) in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def thread_collector_reset() -> None:
    """Clear the native pools' measured worker-id set (reference
    ThreadCollector analog, thread_collector.hpp:8-23); nothing under
    ``LAC_TPU_NO_NATIVE=1``."""
    if not disabled():
        get_native().lac_thread_collector_reset()


def thread_collector_count() -> int:
    """Distinct worker threads observed by native pools since the last
    reset; 0 under ``LAC_TPU_NO_NATIVE=1`` (no native pool ran)."""
    return 0 if disabled() else int(get_native().lac_thread_collector_count())


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype=dtype)


def _emit_loop(n, count, call):
    """Run an emit entry with a growing per-lane byte capacity; payloads."""
    lane_cap = n * 6 + 4096
    while True:
        out = np.zeros((count, lane_cap), dtype=np.uint8)
        sizes = np.zeros(count, dtype=np.uint64)
        if call(out, lane_cap, sizes) == 0:
            return [out[b, : int(sizes[b])].tobytes() for b in range(count)]
        lane_cap *= 4  # pathological unary runs: retry with more room
        if lane_cap > (1 << 31):
            raise RuntimeError("native emit: payload exceeds 2 GiB per lane")


def _plan_args(ptype, order, coeffs, best_p, modes, ks):
    """Plan arrays -> ctypes pointers (each pointer keeps its array alive)."""
    return [_ptr(_c(ptype, np.uint8), ctypes.c_uint8), _ptr(_c(order, np.uint8), ctypes.c_uint8),
            _ptr(_c(coeffs, np.int16), ctypes.c_int16), _ptr(_c(best_p, np.uint8), ctypes.c_uint8),
            _ptr(_c(modes, np.uint8), ctypes.c_uint8), _ptr(_c(ks, np.uint8), ctypes.c_uint8)]


def emit_blocks(pcm, ptype, order, coeffs, best_p, modes, ks, num_threads=0):
    """Replay a chosen encode plan to per-lane wire payloads.

    ``pcm``: (B, n) int32; plan arrays as :func:`..encoder.expand_plan`
    gives them (modes and ks padded to 256 columns)."""
    lib = get_native()
    pcm = _c(pcm, np.int32)
    B, n = pcm.shape
    plan = _plan_args(ptype, order, coeffs, best_p, modes, ks)
    return _emit_loop(n, B, lambda out, cap, sizes: lib.lac_emit_blocks(
        _ptr(pcm, ctypes.c_int32), B, n, *plan, _ptr(out, ctypes.c_uint8), cap,
        _ptr(sizes, ctypes.c_uint64), num_threads))


def emit_blocks_planes(lview, rview, rows, variants, slots, starts, n,
                       ptype, order, coeffs, best_p, modes, ks, num_threads=0):
    """Plane-derived plan replay: lanes are (row, variant, slot, start)
    views into the resident channel planes; M/S derivation happens
    in-cache in C++."""
    lib = get_native()
    lview = np.ascontiguousarray(lview)
    assert lview.dtype in (np.int16, np.int32)
    rview = np.ascontiguousarray(rview) if rview is not None else lview
    B = len(rows)
    rows, variants = _c(rows, np.int32), _c(variants, np.uint8)
    slots, starts = _c(slots, np.uint8), _c(starts, np.uint32)
    plan = _plan_args(ptype, order, coeffs, best_p, modes, ks)
    return _emit_loop(n, B, lambda out, cap, sizes: lib.lac_emit_blocks_planes(
        lview.ctypes.data_as(ctypes.c_void_p), rview.ctypes.data_as(ctypes.c_void_p),
        lview.dtype.itemsize, lview.shape[-1],
        _ptr(rows, ctypes.c_int32), _ptr(variants, ctypes.c_uint8), _ptr(slots, ctypes.c_uint8),
        _ptr(starts, ctypes.c_uint32), B, n, *plan,
        _ptr(out, ctypes.c_uint8), cap, _ptr(sizes, ctypes.c_uint64), num_threads))


def plan_blocks(pcm, lpc_coeffs, lpc_valid, zero_run_enabled, partitioning_enabled, num_threads=0):
    """Native block planner: (B, n) pcm + LPC candidates -> compact meta
    rows, the same as :func:`..encoder.plan_group` returns
    ((B, 3 + 2*max_parts) int8)."""
    from ..format import constants as C
    from ..format.partitions import max_partition_order_for_block

    lib = get_native()
    pcm = _c(pcm, np.int32)
    B, n = pcm.shape
    lpc_coeffs, lpc_valid = _c(lpc_coeffs, np.int16), _c(lpc_valid, np.uint8)
    max_p = max_partition_order_for_block(n) if (partitioning_enabled and n >= C.MIN_PARTITION_SIZE) else 0
    meta = np.zeros((B, 3 + 2 * (1 << max_p)), dtype=np.int8)
    status = lib.lac_plan_blocks(
        _ptr(pcm, ctypes.c_int32), B, n, _ptr(lpc_coeffs, ctypes.c_int16), _ptr(lpc_valid, ctypes.c_uint8),
        1 if zero_run_enabled else 0, 1 if partitioning_enabled else 0, _ptr(meta, ctypes.c_int8), num_threads,
    )
    if status != 0:
        raise RuntimeError(f"lac_plan_blocks failed ({status})")
    return meta


def autocorr(pcm, max_order=12, num_threads=0):
    """Exact int64 autocorrelation lags 0..max_order per lane (reference
    lpc.cpp:80-96): (B, max_order+1) int64."""
    lib = get_native()
    pcm = _c(pcm, np.int32)
    B, n = pcm.shape
    out = np.empty((B, max_order + 1), dtype=np.int64)
    status = lib.lac_autocorr(_ptr(pcm, ctypes.c_int32), B, n, max_order, _ptr(out, ctypes.c_int64), num_threads)
    if status != 0:
        raise RuntimeError(f"lac_autocorr failed ({status})")
    return out


def stereo_estimate(left, right, num_threads=0):
    """Per-block stereo proxy decisions for full-valid (B, n) planes
    (:func:`..ops.stereo.estimate_stereo_mode` semantics):
    (choose_ms, uncertain) bool arrays."""
    lib = get_native()
    left, right = _c(left, np.int32), _c(right, np.int32)
    B, n = left.shape
    cm = np.zeros(B, np.uint8)
    un = np.zeros(B, np.uint8)
    lib.lac_stereo_estimate(_ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32), B, n,
                            _ptr(cm, ctypes.c_uint8), _ptr(un, ctypes.c_uint8), num_threads)
    return cm.astype(bool), un.astype(bool)


def _table(payload, payload_offsets, payload_sizes, block_sizes, sample_offsets):
    return (np.frombuffer(payload, dtype=np.uint8), _c(payload_offsets, np.uint64), _c(payload_sizes, np.uint64),
            _c(block_sizes, np.uint32), _c(sample_offsets, np.uint64))


def _table_ptrs(pay, po, ps, bs, so):
    return (_ptr(pay, ctypes.c_uint8), _ptr(po, ctypes.c_uint64), _ptr(ps, ctypes.c_uint64),
            _ptr(bs, ctypes.c_uint32), _ptr(so, ctypes.c_uint64))


def decode_v3_blocks(payload, payload_offsets, payload_sizes, block_sizes, sample_offsets,
                     channels, stereo_mode, bit_depth, total_samples, num_threads=0):
    """Parallel v3 block decode -> (left, right) int32; ValueError
    ``block=<i>`` on a bad block."""
    lib = get_native()
    tbl = _table(payload, payload_offsets, payload_sizes, block_sizes, sample_offsets)
    left = np.zeros(total_samples, dtype=np.int32)
    right = np.zeros(total_samples if channels == 2 else 0, dtype=np.int32)
    status = lib.lac_decode_v3_blocks(
        *_table_ptrs(*tbl), len(tbl[3]), channels, stereo_mode, bit_depth,
        _ptr(left, ctypes.c_int32), _ptr(right if channels == 2 else left, ctypes.c_int32), num_threads,
    )
    if status != 0:
        raise ValueError(f"block={-status - 1}")
    return left, right


def decode_v3_to_pcm(payload, payload_offsets, payload_sizes, block_sizes, sample_offsets,
                     channels, stereo_mode, bit_depth, total_samples, num_threads=0):
    """Parallel v3 decode straight into interleaved little-endian WAV PCM
    bytes (uint8 array); ValueError ``block=<i>`` on a bad block."""
    lib = get_native()
    tbl = _table(payload, payload_offsets, payload_sizes, block_sizes, sample_offsets)
    out = np.empty(total_samples * channels * (bit_depth // 8), dtype=np.uint8)
    status = lib.lac_decode_v3_to_pcm(
        *_table_ptrs(*tbl), len(tbl[3]), channels, stereo_mode, bit_depth, _ptr(out, ctypes.c_uint8), num_threads,
    )
    if status != 0:
        raise ValueError(f"block={-status - 1}")
    return out


def tokenize_v3_blocks(payload, payload_offsets, payload_sizes, block_sizes, sample_offsets,
                       channels, stereo_mode, total_samples, num_threads=0):
    """Parallel v3 block tokenize, no reconstruction: -> (residual planes
    (C, total) int32, ptype (nb, C) uint8, order (nb, C) uint8, coeffs
    (nb, C, 33) int16, ms flags (nb,) uint8); ValueError ``block=<i>``
    on a bad block."""
    lib = get_native()
    tbl = _table(payload, payload_offsets, payload_sizes, block_sizes, sample_offsets)
    nb = len(tbl[3])
    res = np.zeros((channels, total_samples), dtype=np.int32)
    ptype = np.zeros((nb, channels), dtype=np.uint8)
    order = np.zeros((nb, channels), dtype=np.uint8)
    coeffs = np.zeros((nb, channels, 33), dtype=np.int16)
    msflag = np.zeros(nb, dtype=np.uint8)
    status = lib.lac_tokenize_v3_blocks(
        *_table_ptrs(*tbl), nb, channels, stereo_mode, _ptr(res, ctypes.c_int32), total_samples,
        _ptr(ptype, ctypes.c_uint8), _ptr(order, ctypes.c_uint8), _ptr(coeffs, ctypes.c_int16),
        _ptr(msflag, ctypes.c_uint8), num_threads,
    )
    if status != 0:
        raise ValueError(f"block={-status - 1}")
    return res, ptype, order, coeffs, msflag


def decode_v2_stream(payload, block_sizes, sample_offsets, channels, stereo_mode, bit_depth, total_samples):
    """Serial v2 legacy-stream decode (lac/decoder.cpp:209-218) ->
    (left, right) int32; ValueError ``block=<i>`` on a bad block or
    ``trailing`` on leftover payload."""
    lib = get_native()
    pay = np.frombuffer(payload, dtype=np.uint8)
    bs, so = _c(block_sizes, np.uint32), _c(sample_offsets, np.uint64)
    left = np.zeros(total_samples, dtype=np.int32)
    right = np.zeros(total_samples if channels == 2 else 0, dtype=np.int32)
    status = lib.lac_decode_v2_stream(
        _ptr(pay, ctypes.c_uint8), len(pay), _ptr(bs, ctypes.c_uint32), _ptr(so, ctypes.c_uint64),
        len(bs), channels, stereo_mode, bit_depth,
        _ptr(left, ctypes.c_int32), _ptr(right if channels == 2 else left, ctypes.c_int32),
    )
    if status > 0:
        raise ValueError("trailing")
    if status != 0:
        raise ValueError(f"block={-status - 1}")
    return left, right


def pack_streams(unary, field_val, field_len, elem_offsets, num_threads=0):
    """Pack a batch of element streams (bitio/pack.py's element model) with
    the native BitSink, a thread per stream slice; returns a list of bytes.

    ``unary``/``field_val``: uint32, ``field_len``: uint8, concatenated
    across streams; ``elem_offsets``: (S+1,) uint64 element boundaries."""
    lib = get_native()
    unary, field_val = _c(unary, np.uint32), _c(field_val, np.uint32)
    field_len, elem_offsets = _c(field_len, np.uint8), _c(elem_offsets, np.uint64)
    S = len(elem_offsets) - 1
    sizes = np.zeros(S, dtype=np.uint64)
    lib.lac_pack_streams_sizes(_ptr(unary, ctypes.c_uint32), _ptr(field_len, ctypes.c_uint8),
                               _ptr(elem_offsets, ctypes.c_uint64), S, _ptr(sizes, ctypes.c_uint64))
    out_offsets = np.zeros(S + 1, dtype=np.uint64)
    np.cumsum(sizes, out=out_offsets[1:])
    out = np.zeros(int(out_offsets[-1]), dtype=np.uint8)
    lib.lac_pack_streams(_ptr(unary, ctypes.c_uint32), _ptr(field_val, ctypes.c_uint32),
                         _ptr(field_len, ctypes.c_uint8), _ptr(elem_offsets, ctypes.c_uint64), S,
                         _ptr(out, ctypes.c_uint8), _ptr(out_offsets, ctypes.c_uint64), num_threads)
    raw = out.tobytes()
    return [raw[int(out_offsets[i]) : int(out_offsets[i + 1])] for i in range(S)]


def tokenize_static_rice(payloads, ks, nbits, count):
    """Parse ``count`` static-k Rice tokens per lane with the product reader
    (the twin of :mod:`..experiments.device_reader`): ``payloads`` (L, NBY)
    uint8 -> (L, count) int32 residuals. ValueError ``lane=<i>`` on a short
    or malformed lane."""
    lib = get_native()
    pay = _c(payloads, np.uint8)
    ks, nb = _c(ks, np.uint32), _c(nbits, np.uint64)
    L = pay.shape[0]
    out = np.empty((L, int(count)), dtype=np.int32)
    status = lib.lac_tokenize_static_rice(_ptr(pay, ctypes.c_uint8), pay.shape[1], _ptr(ks, ctypes.c_uint32),
                                          _ptr(nb, ctypes.c_uint64), L, int(count), _ptr(out, ctypes.c_int32))
    if status != 0:
        raise ValueError(f"lane={-status - 1}")
    return out
