"""Partition geometry + residual-control byte (format.md:180-216; the
port's copy of lac_tpu/format/partitions.py)."""

from . import constants as C


def max_partition_order_for_block(block_size: int) -> int:
    """Largest p with ``block_size >> p >= MIN_PARTITION_SIZE`` capped at
    MAX_PARTITION_ORDER (block/encoder.cpp:93-101)."""
    max_p = 0
    for p in range(1, C.MAX_PARTITION_ORDER + 1):
        if (block_size >> p) < C.MIN_PARTITION_SIZE:
            break
        max_p = p
    return max_p


def partition_sizes(block_size: int, partition_order: int):
    """Per-partition sample counts: all partitions ``base = size >> p`` except
    the final one, which absorbs the remainder (format.md:199-205)."""
    if partition_order == 0:
        return [block_size]
    base = block_size >> partition_order
    if base == 0:
        return [block_size]
    n = 1 << partition_order
    sizes = [base] * n
    sizes[-1] = block_size - base * (n - 1)
    return sizes


def control_byte(residual_mode: int, partition_order: int) -> int:
    """Pack the residual-control byte (format.md:182-189, encoder.cpp:773-778)."""
    b = (residual_mode & C.RESIDUAL_MODE_MASK) << C.RESIDUAL_MODE_SHIFT
    if partition_order > 0:
        b |= C.PARTITION_FLAG
        b |= (partition_order & C.PARTITION_ORDER_MASK) << C.PARTITION_ORDER_SHIFT
    return b


def parse_control_byte(control: int):
    """Validate + unpack control byte -> (mode, partition_order) or None.

    Mirrors the canonical rules in block/decoder.cpp:427-438.
    """
    if control & C.RESIDUAL_RESERVED_MASK:
        return None
    partition_flag = bool(control & C.PARTITION_FLAG)
    partition_order = (control & C.PARTITION_ORDER_MASK) >> C.PARTITION_ORDER_SHIFT
    mode = (control >> C.RESIDUAL_MODE_SHIFT) & C.RESIDUAL_MODE_MASK
    if mode > C.MODE_STATIC:
        return None
    if partition_flag and partition_order == 0:
        return None
    if not partition_flag and partition_order != 0:
        return None
    if partition_order > C.MAX_PARTITION_ORDER:
        return None
    return mode, partition_order
