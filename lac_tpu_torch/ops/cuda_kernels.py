"""The planner's six hand-written Hopper kernels, each beside its plain
PyTorch version (lac_tpu/ops/pallas_kernels.py, lac_tpu/ops/pallas_adapt.py).

Codes travel as an ``int32`` view of the u32 bit pattern; sums wrap in
u32 exactly as on the TPU (every sum on the planner's path is <= 2^30).

Dispatch rule, for every wrapper: a tensor on the CPU takes the plain
version; a tensor on a CUDA device launches the kernel (built from
``lac_tpu_torch/csrc`` on first use) or raises. There is no fallback
from a CUDA tensor to the plain version. ``launches[name]`` counts the
kernel launches of each wrapper and nothing else, so a run can show
that its path went through the kernels; the counts are exact from any
number of host threads (one lock around each increment).
"""

import threading

import torch

from ._backend import U32_MASK, cummax, cummin_reverse, u32_from_bits

launches = {
    "k_cost_sums": 0,
    "split_cumsums_u32": 0,
    "cumsum_u32": 0,
    "prefix_max_i32": 0,
    "suffix_min_i32": 0,
    "k_after_stateful_fused": 0,
}


_count_lock = threading.Lock()


def reset_launches():
    with _count_lock:
        for name in launches:
            launches[name] = 0


def _count(name):
    with _count_lock:  # += on a dict entry is a read and a write: not atomic between threads
        launches[name] += 1


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
    _count("k_cost_sums")
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
    _count("k_cost_sums")
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
    _count("split_cumsums_u32")
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
    _count("cumsum_u32")
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
    _count("prefix_max_i32")
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
    _count("suffix_min_i32")
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
    _count("k_after_stateful_fused")
    return out
