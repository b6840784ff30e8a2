"""Vectorized MSB-first bit packing (prefix-sum + scatter), in numpy
(lac_tpu/bitio/pack.py).

The packer of the encoder's token route (``ChannelBlockEncoder._emit``),
which runs when the native plan replay is off. Every emitted element
is ``unary`` one-bits followed by a ``field_len``-bit field. Bit offsets
come from an exclusive prefix sum of element lengths; unary runs become
a +1/-1 difference array whose running sum marks one-regions; field
bits scatter to computed positions.
(The reference emits the same stream serially: bit_writer.cpp:15-111,
rice.cpp:17-32.)

Any Rice token ``(q ones, 0 stop bit, k remainder bits)`` is one element:
``unary=q, field=(remainder in low k bits of a (k+1)-bit field)`` — the
leading 0 of the field is the stop bit. Tags/signs/escapes/headers are
elements with ``unary=0``.
"""

import numpy as np


def pack_stream(unary, field_val, field_len) -> bytes:
    """Pack elements of (unary ones + MSB-first field) into bytes.

    The final partial byte is zero-padded (canonical block padding,
    format.md:388-391).
    """
    unary = np.asarray(unary, dtype=np.int64)
    field_val = np.asarray(field_val, dtype=np.uint64)
    field_len = np.asarray(field_len, dtype=np.int64)
    if unary.size == 0:
        return b""

    elem_bits = unary + field_len
    offsets = np.concatenate(([0], np.cumsum(elem_bits)))
    total_bits = int(offsets[-1])
    if total_bits == 0:
        return b""
    nbytes = (total_bits + 7) // 8

    bits = np.zeros(nbytes * 8, dtype=np.uint8)

    # unary runs via difference array
    has_unary = unary > 0
    if has_unary.any():
        starts = offsets[:-1][has_unary]
        ends = starts + unary[has_unary]
        delta = np.zeros(nbytes * 8 + 1, dtype=np.int32)
        np.add.at(delta, starts, 1)
        np.add.at(delta, ends, -1)
        bits |= (np.cumsum(delta[:-1]) > 0).astype(np.uint8)

    # field bits: scatter one MSB-relative bit plane at a time
    max_len = int(field_len.max()) if field_len.size else 0
    field_starts = offsets[:-1] + unary
    for j in range(max_len):
        sel = field_len > j
        if not sel.any():
            continue
        fl = field_len[sel]
        vals = field_val[sel]
        bitvals = ((vals >> (fl - 1 - j).astype(np.uint64)) & np.uint64(1)).astype(np.uint8)
        bits[field_starts[sel] + j] = bitvals

    return np.packbits(bits).tobytes()

