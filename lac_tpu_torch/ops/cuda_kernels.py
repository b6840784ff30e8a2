"""The port's ten hand-written Hopper kernels, each beside its plain
PyTorch version: the planner's six that replace Pallas kernels
(lac_tpu/ops/pallas_kernels.py, lac_tpu/ops/pallas_adapt.py), the device
decode backend's FIR/LPC restore (the ``lax.scan`` of
lac_tpu/ops/predictors.py:243), the bit-reader experiment's static-Rice
scan tokenizer (the ``lax.scan`` of lac_tpu/ops/device_reader.py:122),
and the planner's whole-block and per-partition mode-cost sums (XLA
fusions of lac_tpu/encoder.py's ``plan_group``).

Codes travel as an ``int32`` view of the u32 bit pattern; sums wrap in
u32 exactly as on the TPU (every sum on the planner's path is <= 2^30),
except the mode-cost sums of kernels 9 and 10, u64 (< 2^47) in int64.

Dispatch rule, for every wrapper: a tensor on the CPU takes the plain
version; a tensor on a CUDA device launches the kernel (built from
``lac_tpu_torch/csrc`` on first use) or raises. There is no fallback
from a CUDA tensor to the plain version. ``launches[name]`` counts the
kernel launches of each wrapper and nothing else, so a run can show
that its path went through the kernels, and ``card_launches[index][name]``
the same on each card; the counts are exact from any number of host
threads (one lock around each increment). A CUDA graph's capture
launches nothing: inside :func:`recording` a thread's wrappers record
their launches instead, and each replay of the graph counts them
(:func:`count_replay`, :mod:`..plan_graphs`).
"""

import contextlib
import threading

import torch

from ..format import constants as C
from ..format.constants import INT32_MAX, INT32_MIN
from ._backend import U32_MASK, bit_width, cummax, cummin_reverse, shift_right, u32_from_bits

launches = {
    "k_cost_sums": 0,
    "split_cumsums_u32": 0,
    "cumsum_u32": 0,
    "prefix_max_i32": 0,
    "suffix_min_i32": 0,
    "k_after_stateful_fused": 0,
    "recurrence_restore": 0,
    "tokenize_static_rice_scan": 0,
    "mode_cost_sums": 0,
    "partition_cost_sums": 0,
}


# card index -> {kernel name: launches} (a mesh's cards each count their own)
card_launches = {}

_count_lock = threading.Lock()


def reset_launches():
    with _count_lock:
        for name in launches:
            launches[name] = 0
        card_launches.clear()


_capturing = threading.local()


@contextlib.contextmanager
def recording():
    """While a CUDA graph is captured on this thread: the wrappers that
    this thread calls record their launches in the dict this yields (name
    -> launches) and count none, since a capture launches nothing."""
    _capturing.launches = recorded = {}
    try:
        yield recorded
    finally:
        _capturing.launches = None


def count_replay(recorded, device):
    """Count one replay of a captured graph on ``device``: the launches
    that :func:`recording` took down at its capture."""
    with _count_lock:
        for name, k in recorded.items():
            launches[name] += k
            if device.index is not None:
                on_card = card_launches.setdefault(device.index, {})
                on_card[name] = on_card.get(name, 0) + k


def _count(name, device=None):
    recorded = getattr(_capturing, "launches", None)
    if recorded is not None:
        recorded[name] = recorded.get(name, 0) + 1
        return
    with _count_lock:  # += on a dict entry is a read and a write: not atomic between threads
        launches[name] += 1
        if device is not None:
            on_card = card_launches.setdefault(device.index, {})
            on_card[name] = on_card.get(name, 0) + 1


def _on_cpu(x, name, contiguous=True):
    """Validate a (rows, n) int32 operand; True when it lies on the CPU."""
    if x.dtype != torch.int32 or x.dim() != 2:
        raise TypeError(f"{name}: want a 2-D int32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.stride(1) != 1 or (contiguous and not x.is_contiguous()):
        raise ValueError(f"{name}: operand layout not supported by the kernel: strides {x.stride()}")
    return False


def _launch(entry, x, *args):
    from . import _cuda_lib

    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(_cuda_lib.load(), entry)(*args, stream, x.device.index)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err}")


def _wrap_u32(x):
    """int64 totals -> int32 view of their u32 value (mod 2^32)."""
    return (x & U32_MASK).to(torch.int32)


# ---------------------------------------------------------------- kernel 1
# csrc/kcost.cu; replaces pallas_kernels.k_cost_sums (pallas_kernels.py:81)


def k_cost_sums_plain(u32_rows, head=None):
    def sums(rows):
        u = u32_from_bits(rows)
        lo = u & 0xFFFF
        cols = [(u >> 16).sum(dim=-1)] + [(lo >> k).sum(dim=-1) for k in range(16)]
        return _wrap_u32(torch.stack(cols, dim=-1))

    if head is None:
        return sums(u32_rows)
    return sums(u32_rows[:, :head]), sums(u32_rows)


def k_cost_sums(u32_rows, head=None):
    """(rows, n) u32 codes -> (rows, 17): [sum(u >> 16), sum((u & 0xFFFF) >> k), k = 0..15].

    With ``head`` (a sample count >= 1) the result is the pair (sums of
    each row's first ``head`` samples, sums of the whole rows), both from
    one read of the rows: one launch. Rows may be a strided view
    (``stride(1) == 1``).
    """
    if head is not None and head < 1:
        raise ValueError(f"k_cost_sums: head must be at least 1, got {head}")
    if _on_cpu(u32_rows, "k_cost_sums", contiguous=False):
        return k_cost_sums_plain(u32_rows, head)
    rows, n = u32_rows.shape
    if head is not None and head >= n:  # the head is the row
        sums = k_cost_sums(u32_rows)
        return sums, sums
    out = torch.empty((rows, 17), dtype=torch.int32, device=u32_rows.device)
    out_head = torch.empty_like(out) if head else None
    _launch("lac_k_cost_sums", u32_rows, u32_rows.data_ptr(), rows, n, max(u32_rows.stride(0), n), head or 0,
            out_head.data_ptr() if head else None, out.data_ptr())
    _count("k_cost_sums", u32_rows.device)
    return (out_head, out) if head else out


def k_cost_partition_sums_plain(u32_rows, max_p):
    rows, n = u32_rows.shape
    return [k_cost_sums_plain(u32_rows.reshape(rows << p, n >> p)).reshape(rows, 1 << p, 17)
            for p in range(max_p + 1)]


def k_cost_partition_sums(u32_rows, max_p):
    """(rows, n) u32 codes -> for every partition order p = 0..max_p the
    k-cost sums of each row's 2^p equal parts, a list of (rows, 2^p, 17),
    from one read of the rows: one launch of kernel 1's second entry
    (views into one output). ``n`` must be a multiple of ``2^max_p``,
    ``max_p <= 8``."""
    on_cpu = _on_cpu(u32_rows, "k_cost_partition_sums", contiguous=False)
    rows, n = u32_rows.shape
    if not 0 <= max_p <= 8 or n == 0 or n % (1 << max_p):
        raise ValueError(f"k_cost_partition_sums: want 0 <= max_p <= 8 and n a positive multiple of 2^max_p, "
                         f"got max_p={max_p}, shape {tuple(u32_rows.shape)}")
    if on_cpu:
        return k_cost_partition_sums_plain(u32_rows, max_p)
    out = torch.empty((rows, (2 << max_p) - 1, 17), dtype=torch.int32, device=u32_rows.device)
    _launch("lac_k_cost_partition_sums", u32_rows, u32_rows.data_ptr(), rows, n, max(u32_rows.stride(0), n),
            max_p, out.data_ptr())
    _count("k_cost_sums", u32_rows.device)
    return [out[:, (1 << p) - 1 : (2 << p) - 1] for p in range(max_p + 1)]


# ---------------------------------------------------------------- kernels 2-5
# csrc/row_scan.cu; replace pallas_kernels.split_cumsums_u32 (:205),
# cumsum_u32 (:218), prefix_max_i32 (:319), suffix_min_i32 (:325)


def split_cumsums_u32_plain(u32_rows):
    u = u32_from_bits(u32_rows)
    return (_wrap_u32(torch.cumsum(u >> 16, dim=-1)),
            _wrap_u32(torch.cumsum(u & 0xFFFF, dim=-1)))


def split_cumsums_u32(u32_rows):
    """(rows, n) u32 -> (cumsum(u >> 16), cumsum(u & 0xFFFF)), both u32 as int32."""
    if _on_cpu(u32_rows, "split_cumsums_u32"):
        return split_cumsums_u32_plain(u32_rows)
    rows, n = u32_rows.shape
    hi = torch.empty_like(u32_rows)
    lo = torch.empty_like(u32_rows)
    _launch("lac_split_cumsums_u32", u32_rows, u32_rows.data_ptr(), rows, n, hi.data_ptr(), lo.data_ptr())
    _count("split_cumsums_u32", u32_rows.device)
    return hi, lo


def cumsum_u32_plain(u32_rows):
    return _wrap_u32(torch.cumsum(u32_from_bits(u32_rows), dim=-1))


def cumsum_u32(u32_rows):
    """(rows, n) u32 inclusive prefix sum along the last axis (as int32)."""
    if _on_cpu(u32_rows, "cumsum_u32"):
        return cumsum_u32_plain(u32_rows)
    rows, n = u32_rows.shape
    out = torch.empty_like(u32_rows)
    _launch("lac_cumsum_u32", u32_rows, u32_rows.data_ptr(), rows, n, out.data_ptr())
    _count("cumsum_u32", u32_rows.device)
    return out


def prefix_max_i32_plain(x_rows):
    return cummax(x_rows)


def prefix_max_i32(x_rows):
    """(rows, n) int32 running maximum along the last axis."""
    if _on_cpu(x_rows, "prefix_max_i32"):
        return prefix_max_i32_plain(x_rows)
    rows, n = x_rows.shape
    out = torch.empty_like(x_rows)
    _launch("lac_prefix_max_i32", x_rows, x_rows.data_ptr(), rows, n, out.data_ptr())
    _count("prefix_max_i32", x_rows.device)
    return out


def suffix_min_i32_plain(x_rows):
    return cummin_reverse(x_rows)


def suffix_min_i32(x_rows):
    """(rows, n) int32 running minimum from the right."""
    if _on_cpu(x_rows, "suffix_min_i32"):
        return suffix_min_i32_plain(x_rows)
    rows, n = x_rows.shape
    out = torch.empty_like(x_rows)
    _launch("lac_suffix_min_i32", x_rows, x_rows.data_ptr(), rows, n, out.data_ptr())
    _count("suffix_min_i32", x_rows.device)
    return out


# ---------------------------------------------------------------- kernel 6
# csrc/k_after.cu; replaces pallas_adapt.k_after_stateful_fused (pallas_adapt.py:333)


def k_after_shape_supported(n):
    """Row lengths the fused kernel takes (the TPU kernel's rule,
    pallas_adapt.shape_supported, without its rows % 8)."""
    return n % 2048 == 0 and 2048 <= n <= 16384


def k_after_stateful_fused_plain(u32_rows):
    """The split chain of :func:`.adapt.k_after_stateful` with the plain scans."""
    from .adapt import k_after_chain

    return k_after_chain(u32_rows, split_cumsums_u32_plain, cumsum_u32_plain)


def k_after_stateful_fused(u32_rows):
    """(rows, n) u32 codes (int32 view) -> (rows, n) int32 stateful k_after,
    in one pass. On the card ``n`` must meet :func:`k_after_shape_supported`."""
    if _on_cpu(u32_rows, "k_after_stateful_fused"):
        return k_after_stateful_fused_plain(u32_rows)
    rows, n = u32_rows.shape
    if not k_after_shape_supported(n) or u32_rows.data_ptr() % 16:
        raise ValueError(f"k_after_stateful_fused: the kernel takes n % 2048 == 0, 2048 <= n <= 16384 "
                         f"and 16-byte aligned rows, got n={n}")
    out = torch.empty_like(u32_rows)
    _launch("lac_k_after_stateful", u32_rows, u32_rows.data_ptr(), rows, n, out.data_ptr())
    _count("k_after_stateful_fused", u32_rows.device)
    return out


# ---------------------------------------------------------------- kernel 7
# csrc/restore.cu; replaces the vmapped lax.scan of predictors.recurrence_restore
# (lac_tpu/ops/predictors.py:243), XLA code that eager torch cannot run as one launch

TAP_BOUNDS = (4, 8, 12, 16, 32)  # the JAX scan's static tap bounds
MAX_ORDER = TAP_BOUNDS[-1]
# csrc/restore.cu's per-warp templates (the tap bound H, from the largest order of the warp's
# 32 lanes; 2 for FIR-only warps) and the tile of samples each walks a row in (tile_len)
RESTORE_TEMPLATES = (2, *TAP_BOUNDS)
RESTORE_TILE = {h: 108 if h == 12 else 128 for h in RESTORE_TEMPLATES}


def _restore_operands(res, coeffs, order, shift, min_pred_n, valid_len):
    """Validate kernel 7's operands; returns the per-lane vectors with
    ``valid_len`` filled in (full rows when None)."""
    if res.dtype != torch.int32 or res.dim() != 2:
        raise TypeError(f"recurrence_restore: want 2-D int32 residuals, got {res.dtype} {tuple(res.shape)}")
    lanes, _ = res.shape
    if valid_len is None:
        valid_len = torch.full((lanes,), res.shape[1], dtype=torch.int32, device=res.device)
    vecs = (order, shift, min_pred_n, valid_len)
    if coeffs.dim() != 2 or coeffs.shape[0] != lanes or coeffs.shape[1] < MAX_ORDER + 1 or any(
            v.dim() != 1 or v.shape[0] != lanes for v in vecs):
        raise ValueError(f"recurrence_restore: want coeffs ({lanes}, >= {MAX_ORDER + 1}) and four ({lanes},) "
                         f"vectors, got {tuple(coeffs.shape)} and {[tuple(v.shape) for v in vecs]}")
    for t in (coeffs, *vecs):
        if t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool:
            raise TypeError(f"recurrence_restore: want integer operands, got {t.dtype}")
        if t.device != res.device:
            raise ValueError(f"recurrence_restore: operands on {t.device} and {res.device}")
    return vecs


def recurrence_restore_plain(res, coeffs, order, shift, min_pred_n, valid_len=None):
    """Kernel 7's plain version: a loop over samples, vectorized over lanes,
    with the JAX step function's masks (predictors.py:290-301). H is the
    smallest tap bound at or above the largest order, as predictors.py:281
    picks it; a lane's history is the H samples before ``n`` of its own
    output row, which starts H zeros early. Every value it keeps fits int32:
    a restored sample outside int32 is replaced by its residual."""
    order, shift, min_pred_n, valid_len = _restore_operands(res, coeffs, order, shift, min_pred_n, valid_len)
    lanes, n = res.shape
    dev = res.device
    od, sh, mp, nv = (v.to(torch.int64) for v in (order, shift, min_pred_n, valid_len))
    alive = (od >= 0) & (od <= MAX_ORDER) & (sh >= 0) & (sh < 64)
    od, sh = torch.where(alive, od, 0), torch.where(alive, sh, 0)
    H = next(h for h in TAP_BOUNDS if h >= (int(od.max()) if lanes else 0))
    taps = torch.arange(H, device=dev)
    # oldest first, to line up with the history window y[:, n : n + H]
    c = torch.where(taps[None, :] < od[:, None], coeffs[:, 1 : H + 1].to(torch.int64), 0).flip(1)
    idx = torch.arange(n, device=dev)
    predicts = idx[None, :] >= mp[:, None]
    in_block = idx[None, :] < nv[:, None]
    y = torch.zeros((lanes, H + n), dtype=torch.int64, device=dev)
    y[:, H:] = res
    for i in range(n):
        r = y[:, H + i]  # read before the column is overwritten below
        s = r + torch.where(predicts[:, i], (y[:, i : i + H] * c).sum(dim=-1) >> sh, 0)
        active = alive & in_block[:, i]
        take = active & (s >= INT32_MIN) & (s <= INT32_MAX)
        alive = alive & (take | ~active)
        y[:, H + i] = torch.where(take, s, r)
    return y[:, H:].to(torch.int32), alive


def recurrence_restore(res, coeffs, order, shift, min_pred_n, valid_len=None):
    """Closed-loop FIR/LPC restore of every lane: ``x[n] = r[n] +
    (sum_{i <= min(n, order)} coeffs[:, i] * x[n - i] >> shift)`` from
    ``n >= min_pred_n`` and for ``n < valid_len``.

    ``res`` (lanes, L) int32 residuals; ``coeffs`` (lanes, >= 33) integer
    taps with index 0 unused (int16 on the wire; |c| < 2^26 keeps every
    int64 sum exact); ``order`` (0..32), ``shift`` (0..63), ``min_pred_n``
    and ``valid_len`` (None: L) per lane. Returns (samples (lanes, L)
    int32, ok (lanes,) bool): the values of the JAX function's int64
    output, in half the bytes. A lane stops at its first sample outside
    int32: ok clears, and that sample and the rest of the row are its
    residuals, as the numpy reference leaves them. A lane with an order or
    shift outside its range is rejected whole. Beyond ``valid_len`` the
    residuals pass through.
    """
    vecs = _restore_operands(res, coeffs, order, shift, min_pred_n, valid_len)
    if _on_cpu(res, "recurrence_restore"):
        return recurrence_restore_plain(res, coeffs, *vecs)
    lanes, n = res.shape
    res = res.contiguous()  # the kernel steps rows by n
    cs = coeffs[:, : MAX_ORDER + 1].to(torch.int32).contiguous()
    order, shift, min_pred_n, valid_len = (v.to(torch.int32).contiguous() for v in vecs)
    out = torch.empty((lanes, n), dtype=torch.int32, device=res.device)
    ok = torch.empty((lanes,), dtype=torch.bool, device=res.device)
    _launch("lac_recurrence_restore", res, res.data_ptr(), cs.data_ptr(), order.data_ptr(), shift.data_ptr(),
            min_pred_n.data_ptr(), valid_len.data_ptr(), lanes, n, out.data_ptr(), ok.data_ptr())
    _count("recurrence_restore", res.device)
    return out, ok


# ---------------------------------------------------------------- kernel 8
# csrc/rice_scan.cu; replaces the lax.scan of device_reader.tokenize_static_rice_scan
# (lac_tpu/ops/device_reader.py:122, the scan at :183), XLA code that eager torch
# would run as one launch per token. u64 values are held in int64 (same bits);
# every shift is guarded, as XLA gives 0 for a u64 shift by 64 or more.

_I64_MIN = -(1 << 63)


def _ult(a, b):
    """Unsigned a < b of u64 bit patterns held in int64."""
    return (a ^ _I64_MIN) < (b ^ _I64_MIN)


def _umin(a, b):
    return torch.where(_ult(a, b), a, b)


def _shl64(x, s):
    """u64 ``x << s``; 0 for s >= 64 (s a u64 bit pattern)."""
    return torch.where(_ult(s, torch.full_like(s, 64)), x << s.clamp(0, 63), 0)


def _shr64(x, s):
    """Logical u64 ``x >> s``; 0 for s >= 64 (``>>`` on int64 is arithmetic:
    the mask clears the sign's copies)."""
    sc = s.clamp(0, 63)
    mask = torch.where(sc == 0, -1, ~(torch.full_like(sc, -1) << (64 - sc.clamp(min=1))))
    return torch.where(_ult(s, torch.full_like(s, 64)), (x >> sc) & mask, 0)


def _clz64(x):
    """Leading zeros of a u64 (64 for 0), from the bit widths of its halves as
    the JAX step's ``clz64`` takes them (device_reader.py:146-158)."""
    hi, lo = _shr64(x, torch.full_like(x, 32)), x & U32_MASK
    return torch.where(hi != 0, 32 - bit_width(hi), 64 - bit_width(lo)).to(torch.int64)


def _rice_scan_operands(payload, k, nbits, max_tokens):
    if payload.dtype != torch.uint8 or payload.dim() != 2 or payload.shape[1] < 1:
        raise TypeError(f"tokenize_static_rice_scan: want a (lanes, >= 1) uint8 payload, got {payload.dtype} "
                        f"{tuple(payload.shape)}")
    lanes = payload.shape[0]
    for name, v in (("k", k), ("nbits", nbits)):
        if v.dtype != torch.int32 or tuple(v.shape) != (lanes,) or v.device != payload.device:
            raise ValueError(f"tokenize_static_rice_scan: want {name} ({lanes},) int32 on {payload.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")
    if max_tokens < 0:
        raise ValueError(f"tokenize_static_rice_scan: max_tokens must be >= 0, got {max_tokens}")


def tokenize_static_rice_scan_plain(payload, k, nbits, max_tokens):
    """Kernel 8's plain version: the JAX step function (device_reader.py:164-180)
    in a loop over tokens, vectorized over lanes."""
    _rice_scan_operands(payload, k, nbits, max_tokens)
    lanes, nby = payload.shape
    dev = payload.device
    pj = payload.to(torch.int64)
    kk = k.to(torch.int64)  # sign-extended: numpy's int32 -> u64
    lim = torch.full((lanes,), max(nby - 8, 0), dtype=torch.int64, device=dev)
    three = torch.full((lanes,), 3, dtype=torch.int64, device=dev)
    window = torch.arange(8, device=dev)
    res = torch.empty((lanes, max_tokens), dtype=torch.int32, device=dev)
    starts = torch.empty((lanes, max_tokens), dtype=torch.int64, device=dev)
    pos = torch.zeros(lanes, dtype=torch.int64, device=dev)
    for t in range(max_tokens):
        byteidx = _umin(_shr64(pos, three), lim)
        got = pj.gather(1, torch.clamp(byteidx[:, None] + window, max=nby - 1))  # JAX clamps the gather
        w = torch.zeros_like(pos)
        for b in range(8):
            w = (w << 8) | got[:, b]
        w = w << _umin(pos - (byteidx << 3), torch.full_like(pos, 63))
        q = _clz64(~w)
        rem = torch.where(kk != 0, _shr64(_shl64(w, q + 1), 64 - kk), 0)
        u = (_shl64(q, kk) | rem) & U32_MASK
        r = (u >> 1) ^ torch.where((u & 1) != 0, U32_MASK, 0)
        res[:, t] = (((r + (1 << 31)) & U32_MASK) - (1 << 31)).to(torch.int32)
        starts[:, t] = pos
        pos = pos + q + 1 + kk
    start32 = ((starts + (1 << 31)) & U32_MASK) - (1 << 31)  # astype(int32) wraps
    return res, start32 < nbits.to(torch.int64)[:, None]


def tokenize_static_rice_scan(payload, k, nbits, max_tokens):
    """Parse ``max_tokens`` static-k Rice tokens from each lane, one token a
    step: ``payload`` (lanes, NBY) uint8 (NBY >= 1), ``k`` and ``nbits``
    (lanes,) int32. Returns (residuals (lanes, max_tokens) int32, valid
    (lanes, max_tokens) bool: the token starts before ``nbits``), the
    values of the JAX scan, garbage past the stream and past the 57-bit
    cap (q + 1 + k > 57) included."""
    _rice_scan_operands(payload, k, nbits, max_tokens)
    if payload.device.type == "cpu":
        return tokenize_static_rice_scan_plain(payload, k, nbits, max_tokens)
    if payload.device.type != "cuda":
        raise ValueError(f"tokenize_static_rice_scan: unsupported device {payload.device}")
    lanes, nby = payload.shape
    payload, k, nbits = payload.contiguous(), k.contiguous(), nbits.contiguous()
    res = torch.empty((lanes, max_tokens), dtype=torch.int32, device=payload.device)
    valid = torch.empty((lanes, max_tokens), dtype=torch.bool, device=payload.device)
    _launch("lac_rice_scan_tokenize", payload, payload.data_ptr(), lanes, nby, k.data_ptr(), nbits.data_ptr(),
            max_tokens, res.data_ptr(), valid.data_ptr())
    _count("tokenize_static_rice_scan", payload.device)
    return res, valid


# ---------------------------------------------------------------- kernels 9 and 10
# csrc/mode_costs.cu; replace XLA fusions of lac_tpu/encoder.py's plan_group:
# _mode_cost_fields (:113) with run_geometry over each candidate row, summed at
# :217-221 (kernel 9), and the same fields per part of every partition order,
# the loop at :323 (kernel 10). Their plain versions are the planner's torch
# code that computed them.


def rice_cost(u, k_used):
    """Per-sample Rice bits of u32 codes ``u`` (int64) coded with ``k_used``."""
    q = torch.where(k_used >= C.MAX_RICE_K, 0, u >> k_used)
    return q + 1 + k_used.to(torch.int64)


def mode_cost_fields(v, u, k_used, run_len, long_run, run_start):
    """Per-sample bit costs for rice / zr / bin (encoder.cpp:201-263), int64."""
    rice_per = rice_cost(u, k_used)
    absv = v.to(torch.int64).abs()
    bin_per = torch.where(absv == 0, 2, torch.where(absv <= 2, 3, 2 + rice_per))
    esc = 1 << torch.clamp(k_used + C.ESCAPE_K_OFFSET, max=C.ESCAPE_K_CAP).to(torch.int64)
    token_per = 2 + torch.where(u > esc, 32, rice_per)
    # only read at run starts, where run_len >= ZERO_RUN_MIN_LENGTH
    run_per = 2 + ((run_len.to(torch.int64) - C.ZERO_RUN_MIN_LENGTH) >> C.ZERO_RUN_LENGTH_K) + (
        1 + C.ZERO_RUN_LENGTH_K)
    zr_per = torch.where(run_start, run_per, torch.where(long_run, 0, token_per))
    return rice_per, bin_per, zr_per


def _residuals(u):
    """u32 codes (int64) -> the signed residuals they code (zigzag decode)."""
    return (u >> 1) ^ -(u & 1)


def _mode_cost_operands(name, rows, *vecs):
    """Validate (rows, n) int32 operands and (rows[, m]) int32 vectors on one
    device; True when they lie on the CPU."""
    on_cpu = _on_cpu(rows[0], name)
    for t in (*rows, *vecs):
        if t.dtype != torch.int32 or t.device != rows[0].device:
            raise TypeError(f"{name}: want int32 operands on {rows[0].device}, got {t.dtype} on {t.device}")
        if not on_cpu and not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous, got strides {t.stride()}")
    if any(t.shape != rows[0].shape for t in rows) or any(t.shape[0] != rows[0].shape[0] for t in vecs):
        raise ValueError(f"{name}: operand shapes differ: {[tuple(t.shape) for t in (*rows, *vecs)]}")
    return on_cpu


def mode_cost_sums_plain(u32_rows, k_after_rows, initial_k, last_nz, next_nz):
    from .adapt import k_used_from_after
    from .runs import run_geometry

    n = u32_rows.shape[-1]
    u = u32_from_bits(u32_rows)
    k_used = k_used_from_after(k_after_rows, initial_k)
    run_len, long_run, run_start = run_geometry(u == 0, last_nz, next_nz, torch.arange(n, device=u.device), n)
    rice_per, bin_per, zr_per = mode_cost_fields(_residuals(u), u, k_used, run_len, long_run, run_start)
    return torch.stack([rice_per.sum(dim=-1), bin_per.sum(dim=-1), zr_per.sum(dim=-1),
                        run_start.any(dim=-1).to(torch.int64)], dim=-1)


def mode_cost_sums(u32_rows, k_after_rows, initial_k, last_nz, next_nz):
    """Whole-row mode costs of (R, n) u32 codes (int32 view): each sample
    coded with the k before it (``initial_k`` (R,) at the first sample,
    ``k_after_rows[:, i - 1]`` after it, the stateful adapter's output),
    zero runs from the rows' zero breaks ``last_nz`` / ``next_nz`` (kernels
    4 and 5). Returns (R, 4) int64: rice, bin and zero-run bits and
    has_run (0 or 1) per row. Operands are int32 and, on the card,
    contiguous."""
    if initial_k.dim() != 1:
        raise ValueError(f"mode_cost_sums: want initial_k (rows,), got {tuple(initial_k.shape)}")
    rows = (u32_rows, k_after_rows, last_nz, next_nz)
    if _mode_cost_operands("mode_cost_sums", rows, initial_k):
        return mode_cost_sums_plain(u32_rows, k_after_rows, initial_k, last_nz, next_nz)
    R, n = u32_rows.shape
    out = torch.empty((R, 4), dtype=torch.int64, device=u32_rows.device)
    if n == 0:
        return out.zero_()
    _launch("lac_mode_cost_sums", u32_rows, *(t.data_ptr() for t in (u32_rows, k_after_rows, initial_k, last_nz,
                                                                       next_nz)), R, n, out.data_ptr())
    _count("mode_cost_sums", u32_rows.device)
    return out


def partition_parts(max_p):
    """Parts of orders 1..max_p, order p's at columns 2^p - 2 .. 2^(p+1) - 3."""
    return (2 << max_p) - 2


def partition_cost_sums_plain(u32_w, last_nz_w, next_nz_w, init_k_parts, max_p, tally=None):
    from .adapt import k_after_stateless
    from .runs import run_geometry

    B, n = u32_w.shape
    dev = u32_w.device
    u = u32_from_bits(u32_w)
    v, zw0 = _residuals(u), u == 0
    zero1 = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    csz_hi = torch.cat([zero1, torch.cumsum(u >> 16, dim=-1)], dim=-1)  # (B, n+1)
    csz_lo = torch.cat([zero1, torch.cumsum(u & 0xFFFF, dim=-1)], dim=-1)
    idx = torch.arange(n, device=dev)
    out = []
    wide = []  # per order: parts whose codes sum to 2^31 or more
    for p in range(1, max_p + 1):
        nparts, base = 1 << p, n >> p
        # the geometry on the device (a host copy would break a graph capture): the
        # last part takes the remainder
        part = torch.clamp(idx // base, max=nparts - 1)  # each sample's part
        starts = torch.arange(nparts, device=dev) * base
        ends = torch.cat([starts[1:], starts.new_full((1,), n)])
        pos, seg_end = idx - starts[part], ends[part]

        def rep(a):
            return a[:, part]

        init_k_seg = init_k_parts[:, nparts - 2 : 2 * nparts - 2]
        if tally is not None:
            part_sum = ((csz_hi[:, ends] - csz_hi[:, starts]) << 16) + csz_lo[:, ends] - csz_lo[:, starts]
            wide.append((part_sum >= 1 << 31).sum())
        # stateless per-sample k from segment sums of the split cumsums
        seg_hi = csz_hi[:, 1:] - rep(csz_hi[:, starts])
        seg_lo = csz_lo[:, 1:] - rep(csz_lo[:, starts])
        k_after_sl = k_after_stateless((seg_hi << 16) + seg_lo, pos)
        k_used_p = torch.where(pos == 0, rep(init_k_seg), shift_right(k_after_sl, 1)).to(torch.int32)
        rl_p, long_p, start_p = run_geometry(zw0, last_nz_w, next_nz_w, pos, seg_end)
        rice_pp, bin_pp, zr_pp = mode_cost_fields(v, u, k_used_p, rl_p, long_p, start_p)
        if n % nparts == 0:
            sums = [f.reshape(B, nparts, base).sum(dim=-1) for f in (rice_pp, bin_pp, zr_pp)]
            has_run_s = start_p.reshape(B, nparts, base).any(dim=-1)
        else:
            stacked = torch.stack([rice_pp, bin_pp, zr_pp, start_p.to(torch.int64)], dim=-1)
            cs = torch.cat([torch.zeros((B, 1, 4), dtype=torch.int64, device=dev),
                            torch.cumsum(stacked, dim=-2)], dim=-2)
            seg = cs[:, ends] - cs[:, starts]
            sums = [seg[..., 0], seg[..., 1], seg[..., 2]]
            has_run_s = seg[..., 3] > 0
        out.append(torch.stack([*sums, has_run_s.to(torch.int64)], dim=-1))
    if tally is not None:  # device ops alone, as the rest
        tally[0] += sum(wide)
        tally[1] += B * partition_parts(max_p)
    return torch.cat(out, dim=1)


def partition_cost_path(n):
    """The path kernel 10 takes for rows of ``n`` samples, as the built
    library decides it (from ``n`` alone): ("chunks", R) for the
    power-of-two path, each lane owning R samples, ("rows", 0) for the
    general path. Needs the library (a CUDA toolkit)."""
    from . import _cuda_lib

    r = _cuda_lib.load().lac_partition_cost_path(n)
    return ("chunks", r) if r else ("rows", 0)


def partition_cost_sums(u32_w, last_nz_w, next_nz_w, init_k_parts, max_p, *, tally=None):
    """Mode costs of every part of partition orders 1..``max_p`` of (B, n)
    u32 codes (int32 view): order p cuts a row into 2^p parts of ``n >> p``
    samples, the last part taking the remainder; each part's first sample
    is coded with its initial k (``init_k_parts`` (B, 2^(max_p+1) - 2)
    int32, order by order), later ones with the stateless adapter's k over
    the part's samples before them; zero runs from the rows' zero breaks
    (kernels 4 and 5: ``runs.zero_breaks`` of the codes; the card's
    power-of-two path reads them only at its chunks' edges), clamped to the
    part. Returns (B, 2^(max_p+1) - 2, 4) int64: rice, bin and zero-run
    bits and has_run (0 or 1) per part. Needs 1 <= max_p <= 8, parts of at
    least MIN_PARTITION_SIZE samples, n <= MAX_BLOCK_SIZE and, on the card,
    initial k in 0..31 (the planner's are 0..INITIAL_MAX_K).

    ``tally``, where given, is a (2,) int64 tensor on the codes' device to
    which the call adds the parts whose codes sum to 2^31 or more (those
    the card's kernel sums the 64-bit way) and the parts it sums, B x
    (2^(max_p+1) - 2). The card adds them in the kernel, so a captured
    graph counts at each replay."""
    B, n = u32_w.shape if u32_w.dim() == 2 else (None, None)
    if (not 1 <= max_p <= C.MAX_PARTITION_ORDER or n is None or n > C.MAX_BLOCK_SIZE
            or (n >> max_p) < C.MIN_PARTITION_SIZE):
        raise ValueError(f"partition_cost_sums: want 1 <= max_p <= {C.MAX_PARTITION_ORDER}, parts of at least "
                         f"{C.MIN_PARTITION_SIZE} samples and n <= {C.MAX_BLOCK_SIZE}, got max_p={max_p}, "
                         f"shape {tuple(u32_w.shape)}")
    if init_k_parts.dim() != 2 or init_k_parts.shape[1] != partition_parts(max_p):
        raise ValueError(f"partition_cost_sums: want init_k_parts (B, {partition_parts(max_p)}), got "
                         f"{tuple(init_k_parts.shape)}")
    if tally is not None and (tally.dtype != torch.int64 or tuple(tally.shape) != (2,) or not tally.is_contiguous()
                              or tally.device != u32_w.device):
        raise ValueError(f"partition_cost_sums: want a contiguous (2,) int64 tally on {u32_w.device}, got "
                         f"{tally.dtype} {tuple(tally.shape)} on {tally.device}")
    if _mode_cost_operands("partition_cost_sums", (u32_w, last_nz_w, next_nz_w), init_k_parts):
        return partition_cost_sums_plain(u32_w, last_nz_w, next_nz_w, init_k_parts, max_p, tally)
    out = torch.empty((B, partition_parts(max_p), 4), dtype=torch.int64, device=u32_w.device)
    _launch("lac_partition_cost_sums_tally", u32_w,
            *(t.data_ptr() for t in (u32_w, last_nz_w, next_nz_w, init_k_parts)), B, n, max_p, out.data_ptr(),
            tally.data_ptr() if tally is not None else None)
    _count("partition_cost_sums", u32_w.device)
    return out
