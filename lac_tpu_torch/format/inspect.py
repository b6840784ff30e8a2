"""Wire-level block-header inspection (debug observability; the port's
copy of lac_tpu/format/inspect.py).

Parses the leading plan fields of an emitted channel-block payload —
predictor type/order, Q15 coefficients, control byte, per-partition
(mode, k) metadata — exactly as the decoder would
(block/decoder.cpp:407-475), without touching the token stream. Used by
the CLI ``--debug-lpc`` / ``--debug-partitions`` reports so they print
*actual wire data*, never planner-side estimates.
"""

from ..bitio import BitReader
from . import constants as C
from .partitions import parse_control_byte, partition_sizes


def parse_block_header(payload, block_size):
    """-> dict(ptype, order, coeffs, mode, partition_order, partitions)
    or None if the prefix is malformed. ``partitions`` is a list of
    (mode, k, length)."""
    br = BitReader(payload)
    ptype = br.read_bits(8)
    coeffs = []
    if ptype == C.PREDICTOR_LPC:
        order = br.read_bits(8)
        for _ in range(order):
            c = br.read_bits(16)
            coeffs.append(c - 0x10000 if c >= 0x8000 else c)
    else:
        order = br.read_bits(8)
    control = br.read_bits(8)
    if br.has_error():
        return None
    parsed = parse_control_byte(control)
    if parsed is None:
        return None
    mode, p = parsed
    parts = []
    sizes = partition_sizes(block_size, p)
    for length in sizes:
        meta = br.read_bits(7)
        if br.has_error():
            return None
        parts.append(((meta >> 5) & 0x3, meta & 0x1F, length))
    return {
        "ptype": ptype,
        "order": order,
        "coeffs": coeffs,
        "mode": mode,
        "partition_order": p,
        "partitions": parts,
    }
