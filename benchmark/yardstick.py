"""The benchmark's frozen yardstick: the card's peaks, each kernel's least
time counted from the function it computes, the union of device
intervals and the table that names the port's kernels in a trace.

Everything here is a copy that later changes to the program cannot move.
The least time of a launch is keyed by the function it computes (the
``lac_tpu`` function or XLA fusion that the port's kernel replaces), never
by how a kernel computes it, so it reads the same work whatever implements
the function:

    least time = max(bytes / HBM_BYTES_PER_S, operations / INT32_OPS_PER_S)

with each input byte read once and each output byte written once, and the
operations those of the function's own arithmetic. Where no count of the
function's arithmetic is firm, the bytes bound stands alone (``OPS`` has
no entry), which keeps the least time a floor.
"""

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3; 32-bit integer instructions
# at 132 SMs x 128 lanes x 1.98 GHz = 33.45 T/s, an upper limit for integer
# work, so the least time stays a floor. Copied from chip_smoke.py:266-267.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9

# Integer operations per input element of each function, from its own
# arithmetic (the plain versions in lac_tpu_torch/ops/cuda_kernels.py state
# the functions):
#   k_cost_sums (lac_tpu/ops/pallas_kernels.py:81): u >> 16, u & 0xFFFF and
#     the add of the high sum (3), then (lo >> k) and its add for k = 0..15
#     (32): 35. A head's sums are the row's first partial sums: no more.
#   k_cost_partition_sums (kernel 1's second entry): the finest parts' sums
#     at 35 an element; coarser orders add parts (17 adds a part, below).
#   split_cumsums_u32 (:205): the split (2) and two running adds (2): 4.
#   cumsum_u32 (:218), prefix_max_i32 (:319), suffix_min_i32 (:325): one
#     running add, max or min: 1.
#   partition_cost_sums (lac_tpu/encoder.py:323-388): 17 a sample and
#     order, chip_smoke.py:306-318's PARTITION_OPS for a part that sums
#     below 2^31 (31 elsewhere). A replayed graph shows no values, so the
#     lesser count stands for every part: the least time stays a floor.
# Bytes alone:
#   k_after_stateful_fused (lac_tpu/ops/pallas_adapt.py:333): a sample's
#     adapted k takes the running total over the count, a 64-bit division
#     whose instruction count depends on how it is done (a reciprocal, a
#     bit-width search as adapt._k_base_divfree does, a loop): no count
#     follows from the function alone. chip_smoke.py's 120 was counted from
#     the kernel's source.
#   mode_cost_sums (lac_tpu/encoder.py:113, :217-221): its bytes bound (16
#     bytes an element) is above its operations bound at any count below
#     about 160 an element; chip_smoke.py's 33 mixed in the kernel's loads.
OPS = {
    "k_cost_sums": 35,
    "k_cost_partition_sums": 35,
    "split_cumsums_u32": 4,
    "cumsum_u32": 1,
    "prefix_max_i32": 1,
    "suffix_min_i32": 1,
}
PARTITION_OPS = 17
KCOST_COLUMNS = 17  # sum(u >> 16) and sum((u & 0xFFFF) >> k) for k = 0..15

# the functions the benchmark's wrappers record, by the name the port gives them
FUNCTIONS = ("k_cost_sums", "k_cost_partition_sums", "split_cumsums_u32", "cumsum_u32", "prefix_max_i32",
             "suffix_min_i32", "k_after_stateful_fused", "mode_cost_sums", "partition_cost_sums")


def work(name, rows, n, param=0):
    """(bytes, operations) of one launch of function ``name`` on ``rows``
    rows of ``n`` samples; ``param`` is the head for ``k_cost_sums`` (0:
    none) and max_p for the partition functions. None for an unknown name."""
    e = rows * n
    if name == "k_cost_sums":
        outs = 2 if 0 < param < n else 1  # a head as long as the row is the row's sums, written once
        return 4 * e + outs * 4 * KCOST_COLUMNS * rows, OPS[name] * e
    if name == "k_cost_partition_sums":
        parts = (2 << param) - 1  # orders 0..max_p
        return 4 * e + 4 * KCOST_COLUMNS * rows * parts, OPS[name] * e + KCOST_COLUMNS * rows * (parts - 1)
    if name == "split_cumsums_u32":
        return 3 * 4 * e, OPS[name] * e
    if name in ("cumsum_u32", "prefix_max_i32", "suffix_min_i32"):
        return 2 * 4 * e, OPS[name] * e
    if name == "k_after_stateful_fused":
        return 2 * 4 * e, 0
    if name == "mode_cost_sums":  # codes, k_after and the two zero breaks; initial k; (rows, 4) int64
        return 4 * 4 * e + 4 * rows + 8 * 4 * rows, 0
    if name == "partition_cost_sums":  # codes and the two zero breaks; initial k a part; (rows, parts, 4) int64
        parts = (2 << param) - 2  # orders 1..max_p
        return 3 * 4 * e + 4 * rows * parts + 8 * 4 * rows * parts, PARTITION_OPS * e * param
    return None


def least_s(name, rows, n, param=0):
    """The least time of one launch, in seconds (None for an unknown name)."""
    w = work(name, rows, n, param)
    if w is None:
        return None
    nbytes, ops = w
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


# The port's kernels by the names of their device functions (csrc/*.cu;
# row_scan is one template, told apart by its op type; SplitAddU32 before
# AddU32). Copied from lac_tpu_torch/profile_encode.py:113-122, with kernels
# 7 and 8 (csrc/restore.cu, csrc/rice_scan.cu), which no encode launches.
KERNEL_MARKS = (
    ("k_cost_sums", "k_cost_"),
    ("split_cumsums_u32", "SplitAddU32"),
    ("cumsum_u32", "AddU32"),
    ("prefix_max_i32", "MaxI32"),
    ("suffix_min_i32", "MinI32"),
    ("k_after_stateful_fused", "k_after_kernel"),
    ("mode_cost_sums", "mode_cost_rows"),
    ("partition_cost_sums", "partition_cost_"),
    ("recurrence_restore", "restore_kernel"),
    ("tokenize_static_rice_scan", "rice_scan_kernel"),
)


ENCODE_KERNELS = tuple(name for name, _ in KERNEL_MARKS[:8])


def kernel_of(device_name):
    """The port's kernel that a device function belongs to, else None."""
    return next((name for name, mark in KERNEL_MARKS if mark in device_name), None)


def union_s(intervals):
    """Length of the union of (start, end) intervals. Copied from
    lac_tpu_torch/profile_encode.py:144-153 (``_union_us``)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def clipped(intervals, lo, hi):
    """The parts of ``intervals`` inside [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]

