"""Frame + channel-block decoder with strict canonical validation
(lac_tpu/decoder.py).

By default the native runtime decodes (v3 blocks in parallel, v2
streams serially). The Python block reader below mirrors every rejection
rule of the reference decoder (block/decoder.cpp:57-520,
lac/decoder.cpp:76-303): when the native decoder rejects a block, it
decodes that block again to give the canonical error message; it is also
the whole of the ``"python"`` backend. The ``"device"`` backend restores
v3 blocks on the card (:mod:`.device_decode`).
"""

import numpy as np

from . import check_device
from .bitio import BitReader
from .format import constants as C
from .format.header import FrameHeader
from .format.partitions import parse_control_byte
from .format.zigzag import zigzag_decode
from .io.wav import write_wav_unchecked_samples
from .ops import predictors
from .ops.stereo import ms_inverse
from .runtime import native

DECODE_CHUNK_SAMPLES = 1 << 22  # samples per channel per native call in decode_to_wav


class DecodeError(Exception):
    pass


def _partition_size_at(size, order, index, count):
    if order == 0:
        return size
    base = size >> order
    return (size - base * (count - 1)) if index + 1 == count else base


def _read_rice_unsigned(r: BitReader, k: int):
    if k > 31:
        return None
    max_q = 0xFFFFFFFF >> k
    q = r.read_unary_ones(max_q)
    if q is None:
        return None
    rem = r.read_bits(k) if k > 0 else 0
    if r.has_error():
        return None
    return (q << k) | rem


class _StatefulK:
    """Incremental adapter of the serial token decode (rice.hpp:45-114)."""

    def __init__(self):
        self.prev_sum = 0
        self.widx = 0
        self.midx = 0
        self.filled = 0
        self.wsum = 0
        self.large = 0
        self.zero = 0
        self.recent = [0] * C.DRIFT_WINDOW
        self.lflags = [0] * C.MICRO_WINDOW
        self.zflags = [0] * C.MICRO_WINDOW

    def adapt(self, total, count):
        if count == 0:
            return 0
        cur = total - self.prev_sum
        self.prev_sum = total
        mi = self.midx
        self.large -= self.lflags[mi]
        self.zero -= self.zflags[mi]
        if self.filled < C.DRIFT_WINDOW:
            self.filled += 1
        else:
            self.wsum -= self.recent[self.widx]
        self.recent[self.widx] = cur & 0xFFFFFFFF
        self.wsum += cur
        mean = (total + (count >> 1)) // count
        k = 0 if mean <= 1 else min(31, (mean - 1).bit_length())
        qb = 0 if k >= 31 else (cur >> k)
        il = 1 if qb > 3 else 0
        iz = 1 if qb == 0 else 0
        self.large += il
        self.zero += iz
        self.lflags[mi] = il
        self.zflags[mi] = iz
        bias = 0
        if self.filled > 0 and mean > 0:
            if self.filled == C.DRIFT_WINDOW:
                lm = (self.wsum + 128) >> 8
            else:
                lm = (self.wsum + (self.filled >> 1)) // self.filled
            if lm * 3 > mean * 4:
                bias = 1
            elif lm * 4 + 3 < mean * 3:
                bias = -1
        if self.widx + 1 >= C.MICRO_WINDOW or self.filled >= C.MICRO_WINDOW:
            ws = C.MICRO_WINDOW if self.filled >= C.MICRO_WINDOW else self.filled
            if self.large * 4 >= ws * 3:
                bias = min(bias + 1, 1)
            elif self.zero * 5 >= ws * 4:
                bias = max(bias - 1, -1)
        self.midx = 0 if self.midx + 1 == C.MICRO_WINDOW else self.midx + 1
        self.widx = (self.widx + 1) & (C.DRIFT_WINDOW - 1)
        return max(0, min(31, k + bias))


def _adapt_stateless(total, count):
    if count == 0:
        return 0
    mean = (total + (count >> 1)) // count
    if mean <= 1:
        return 0
    return min(31, (mean - 1).bit_length())


def _decode_residual_segment(r, samples, initial_k, mode, out, offset, stateless):
    if mode > C.MODE_STATIC:
        return False
    k = initial_k
    total = 0
    count = 0
    state = None if stateless else _StatefulK()

    def step(u):
        nonlocal total, count, k
        total += u
        count += 1
        k = _adapt_stateless(total, count) if stateless else state.adapt(total, count)

    if mode == C.MODE_RICE:
        for i in range(samples):
            u = _read_rice_unsigned(r, k)
            if u is None:
                return False
            out[offset + i] = zigzag_decode(u)
            step(u)
        return True

    if mode == C.MODE_ZERO_RUN:
        idx = 0
        while idx < samples:
            tag = r.read_bits(2)
            if r.has_error() or tag > C.ZR_TAG_ESCAPE:
                return False
            if tag == C.ZR_TAG_NORMAL:
                u = _read_rice_unsigned(r, k)
                if u is None or idx >= samples:
                    break
                out[offset + idx] = zigzag_decode(u)
                idx += 1
                step(u)
            elif tag == C.ZR_TAG_RUN:
                enc = _read_rice_unsigned(r, C.ZERO_RUN_LENGTH_K)
                if enc is None or enc > 0xFFFFFFFF - C.ZERO_RUN_MIN_LENGTH:
                    return False
                run = enc + C.ZERO_RUN_MIN_LENGTH
                if run > samples - idx:
                    return False
                out[offset + idx : offset + idx + run] = 0
                idx += run
                if stateless:
                    count += run
                    k = _adapt_stateless(total, count)
                else:
                    for _ in range(run):
                        count += 1
                        k = state.adapt(total, count)
            else:  # escape
                if idx >= samples:
                    return False
                zz = r.read_bits(32)
                if r.has_error():
                    break
                out[offset + idx] = zigzag_decode(zz)
                idx += 1
                step(zz)
        return idx == samples

    if mode == C.MODE_BIN:
        idx = 0
        while idx < samples:
            tag = r.read_bits(2)
            if r.has_error():
                return False
            if tag == C.BIN_TAG_ZERO:
                value, u = 0, 0
            elif tag in (C.BIN_TAG_ONE, C.BIN_TAG_TWO):
                sign = r.read_bit()
                if r.has_error():
                    return False
                mag = 1 if tag == C.BIN_TAG_ONE else 2
                value = mag if sign == 0 else -mag
                u = 2 * mag if sign == 0 else 2 * mag - 1
            else:  # fallback
                u = _read_rice_unsigned(r, k)
                if u is None:
                    return False
                value = zigzag_decode(u)
            out[offset + idx] = value
            idx += 1
            step(u)
        return idx == samples

    # static rice
    for i in range(samples):
        u = _read_rice_unsigned(r, initial_k)
        if u is None:
            return False
        out[offset + i] = zigzag_decode(u)
    return True


def decode_channel_block(r: BitReader, block_size: int):
    """Decode one channel block -> int64 array, or None on any
    non-canonical input (block/decoder.cpp:64-520)."""
    if block_size == 0 or block_size > C.MAX_BLOCK_SIZE:
        return None
    predictor_type = r.read_bits(8)
    order = r.read_bits(8)
    if r.has_error():
        return None
    if predictor_type > 2:
        return None
    if predictor_type == C.PREDICTOR_LPC:
        if order <= 0 or order > 32 or order >= block_size:
            return None
    elif predictor_type == C.PREDICTOR_FIR:
        if order != 2:
            return None
    elif order > 4:
        return None

    coeffs = np.zeros(33, dtype=np.int64)
    if predictor_type == C.PREDICTOR_LPC:
        for i in range(1, order + 1):
            cv = r.read_bits(16)
            if r.has_error():
                return None
            coeffs[i] = cv - 0x10000 if cv >= 0x8000 else cv

    control = r.read_bits(8)
    if r.has_error():
        return None
    parsed = parse_control_byte(control)
    if parsed is None:
        return None
    control_mode, partition_order = parsed
    if partition_order > 0 and (block_size >> partition_order) < C.MIN_PARTITION_SIZE:
        return None
    partition_count = 1 if partition_order == 0 else (1 << partition_order)
    if _partition_size_at(block_size, partition_order, partition_count - 1, partition_count) == 0:
        return None

    part_modes, part_k = [], []
    for _ in range(partition_count):
        m = r.read_bits(2)
        k = r.read_bits(5)
        if r.has_error() or m > C.MODE_STATIC:
            return None
        part_modes.append(m)
        part_k.append(k)
    if part_modes[0] != control_mode:
        return None

    out = np.zeros(block_size, dtype=np.int64)
    stateless = partition_order > 0
    offset = 0
    for i in range(partition_count):
        psz = _partition_size_at(block_size, partition_order, i, partition_count)
        if not _decode_residual_segment(r, psz, part_k[i], part_modes[i], out, offset, stateless):
            return None
        offset += psz
    if offset != block_size:
        return None
    if not r.consume_zero_padding_to_byte():
        return None

    res = out.astype(np.int32)[None, :]
    if predictor_type == C.PREDICTOR_FIXED:
        samples, ok = predictors.fixed_restore(res, order)
    elif predictor_type == C.PREDICTOR_FIR:
        samples, ok = predictors.fir_restore(res)
    else:
        samples, ok = predictors.lpc_restore(res, coeffs, order)
    if not bool(ok[0]):
        return None
    return samples[0]


def _validate_pcm_range(samples, bit_depth):
    lo, hi = C.pcm_range(bit_depth)
    return bool(samples.size == 0 or (samples.min() >= lo and samples.max() <= hi))


class FrameDecoder:
    """Whole-frame decoder (lac/decoder.cpp:76-303), with lac_tpu's three
    backends:

    * ``"native"`` (the default): the native runtime decodes, v3 blocks in
      parallel; a rejected block is decoded again by the Python reader for
      the canonical error message;
    * ``"python"`` (or ``use_native=False``): the Python block reader
      decodes every block;
    * ``"device"``: v3 streams are tokenized by the native runtime and
      restored on ``device`` (:mod:`.device_decode`, kernel 7 on a CUDA
      card); v2 streams and :meth:`decode_range` use the Python reader, as
      in lac_tpu. A CUDA ``device`` without a card raises here, at
      construction. Nothing falls back to the host.

    The native and Python backends never touch ``device``.
    """

    BACKENDS = ("native", "python", "device")

    def __init__(self, use_native=True, backend="native", device="cuda"):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown decode backend {backend!r}: use one of {self.BACKENDS}")
        self.thread_count = 0
        self.use_native = use_native and backend != "python"
        self.backend = backend
        # the native runtime decodes whole blocks; under LAC_TPU_NO_NATIVE=1
        # the Python reader does (lac_tpu/decoder.py:659-667)
        self.native = self.use_native and backend == "native" and native.native_available()
        self.device = check_device(device) if backend == "device" else None

    def set_thread_count(self, n):
        self.thread_count = n

    def _parse_frame(self, data: bytes):
        """Parse+validate the frame header and block table
        (lac/decoder.cpp:76-148,220-234). Returns ``(hdr, br, payload,
        block_sizes, payload_sizes)`` with ``br`` positioned after the
        table; ``payload_sizes`` is empty for v2 streams. Raises
        DecodeError on any invalid input."""
        if not data:
            raise DecodeError("[decode-error] empty input")
        parsed = FrameHeader.parse(data)
        if parsed is None:
            raise DecodeError("[decode-error] invalid frame header")
        hdr, header_bytes = parsed
        payload = memoryview(data)[header_bytes:]
        br = BitReader(payload)

        block_count = br.read_bits(32)
        if br.has_error() or block_count == 0 or block_count > C.MAX_BLOCK_COUNT:
            raise DecodeError("[decode-error] invalid block count")
        has_sizes = hdr.version >= 3
        words = 2 if has_sizes else 1
        if block_count > br.bits_remaining() // (32 * words):
            raise DecodeError("[decode-error] truncated block size table")

        # vectorized table parse; reports the scalar loop's FIRST failing
        # check: per row size -> running-sample total -> compressed size
        # -> running-payload total
        tbl = np.frombuffer(payload, dtype=">u4", count=words * block_count, offset=4)
        sizes = (tbl[0::2] if has_sizes else tbl).astype(np.int64)
        bad = (sizes == 0) | (sizes > C.MAX_BLOCK_SIZE)
        if block_count > 1:
            bad = bad | np.concatenate([sizes[:-1] < C.MIN_CANONICAL_NON_FINAL_BLOCK_SIZE, [False]])
        checks = [(bad, "invalid block size"), (sizes.cumsum() > C.MAX_TOTAL_SAMPLES, "total samples exceed maximum")]
        if has_sizes:
            psizes = tbl[1::2].astype(np.int64)
            checks += [(psizes == 0, "invalid compressed block size"),
                       (psizes.cumsum() > len(payload), "compressed block sizes exceed frame payload")]
        first = None  # (row, check_order, message)
        for order, (mask, msg) in enumerate(checks):
            rows = np.flatnonzero(mask)
            if rows.size and (first is None or (int(rows[0]), order) < first[:2]):
                first = (int(rows[0]), order, msg)
        if first is not None:
            raise DecodeError(f"[decode-error] {first[2]}")
        br.skip_bits(32 * words * block_count)
        block_sizes = sizes.tolist()
        payload_sizes = psizes.tolist() if has_sizes else []
        total_samples = int(sizes.sum())

        if total_samples * hdr.channels * 4 > C.MAX_DECODED_PCM_BYTES:
            raise DecodeError("[decode-error] decoded PCM allocation exceeds maximum")
        wav_data = total_samples * hdr.channels * (hdr.bit_depth // 8)
        if 36 + wav_data + (wav_data & 1) > 0xFFFFFFFF:
            raise DecodeError("[decode-error] decoded WAV data exceeds RIFF limit")
        return hdr, br, payload, block_sizes, payload_sizes

    def _read_block(self, hdr, i, reader, size):
        """Python read of block ``i`` from ``reader``: (a, b, mid_side),
        the channels' int64 samples before mid/side inversion (b None for
        mono); raises DecodeError with the canonical message."""
        is_stereo = hdr.channels == 2
        mid_side = is_stereo and hdr.stereo_mode == C.STEREO_MS
        if is_stereo and hdr.stereo_mode == C.STEREO_PER_BLOCK:
            flag = reader.read_bits(8)
            if reader.has_error() or flag > 1:
                raise DecodeError("[decode-error] invalid per-block stereo flag")
            mid_side = flag == 1
        a = decode_channel_block(reader, size)
        if a is None:
            raise DecodeError(f"[decode-error] block={i} channel=primary")
        b = None
        if is_stereo:
            b = decode_channel_block(reader, size)
            if b is None:
                raise DecodeError(f"[decode-error] block={i} channel=secondary")
        return a, b, mid_side

    @staticmethod
    def _finish_block(hdr, a, b, mid_side):
        """Mid/side inversion and the PCM range check of a read block."""
        if mid_side:
            a, b = ms_inverse(a, b)
        for ch in (a, b):
            if ch is not None and not _validate_pcm_range(ch, hdr.bit_depth):
                raise DecodeError("[decode-error] decoded sample outside PCM bit depth")
        return a, b

    def _decode_block(self, hdr, i, reader, size):
        """Python decode of block ``i`` from ``reader``: (left, right)
        int64 samples; raises DecodeError with the canonical message."""
        return self._finish_block(hdr, *self._read_block(hdr, i, reader, size))

    def _v3_payload(self, br, payload, payload_sizes):
        if br.bits_remaining() % 8 != 0:
            raise DecodeError("[decode-error] unaligned compressed block payload")
        avail = br.bits_remaining() // 8
        if sum(payload_sizes) != avail:
            raise DecodeError("[decode-error] compressed block sizes do not match frame payload")
        return payload[len(payload) - avail :]

    def _explain_v3(self, hdr, bad, block_payload, payload_offsets, payload_sizes, block_sizes):
        """The native decoder rejected block ``bad``: decode it in Python
        for the canonical message (raises DecodeError)."""
        lo = int(payload_offsets[bad])
        reader = BitReader(block_payload[lo : lo + payload_sizes[bad]])
        self._decode_block(hdr, bad, reader, block_sizes[bad])
        if reader.bits_remaining() != 0:
            raise DecodeError(f"[decode-error] block={bad} channel=trailing-payload")
        raise DecodeError(f"[decode-error] block={bad} channel=primary")

    def _python_decode(self, hdr, block_sizes, offsets, reader_for):
        """Every block through the Python reader -> (left, right) int32.
        ``reader_for(i)`` gives block ``i``'s reader: its own on v3, where
        it must end with the block, or the stream's one reader on v2."""
        total = int(offsets[-1])
        left = np.zeros(total, dtype=np.int32)
        right = np.zeros(total if hdr.channels == 2 else 0, dtype=np.int32)
        for i, size in enumerate(block_sizes):
            reader = reader_for(i)
            a, b = self._decode_block(hdr, i, reader, size)
            if hdr.version >= 3 and reader.bits_remaining() != 0:
                raise DecodeError(f"[decode-error] block={i} channel=trailing-payload")
            off = int(offsets[i])
            left[off : off + size] = a
            if b is not None:
                right[off : off + size] = b
        return left, right

    def decode(self, data: bytes):
        """-> (left int32 array, right int32 array, FrameHeader).

        Raises DecodeError on any invalid input.
        """
        hdr, br, payload, block_sizes, payload_sizes = self._parse_frame(data)
        total_samples = sum(block_sizes)
        offsets = np.concatenate([[0], np.cumsum(block_sizes)]).astype(np.int64)

        if hdr.version < 3:
            # v2 legacy: no payload-size table, so blocks are not
            # byte-bounded and decode serially (lac/decoder.cpp:209-218)
            if not self.native:
                left, right = self._python_decode(hdr, block_sizes, offsets, lambda i: br)
                if br.bits_remaining() != 0:
                    raise DecodeError("[decode-error] trailing frame payload")
            else:
                # the table parse leaves br on a byte boundary
                pos = len(payload) - br.bits_remaining() // 8
                try:
                    left, right = native.decode_v2_stream(payload[pos:], block_sizes, offsets[:-1], hdr.channels,
                                                          hdr.stereo_mode, hdr.bit_depth, total_samples)
                except ValueError as e:
                    if str(e) == "trailing":
                        raise DecodeError("[decode-error] trailing frame payload") from None
                    # re-decode serially in Python for the canonical message
                    for i, size in enumerate(block_sizes):
                        self._decode_block(hdr, i, br, size)
                    raise DecodeError(f"[decode-error] block={int(str(e).split('=')[1])} channel=primary") from None
        else:
            block_payload = self._v3_payload(br, payload, payload_sizes)
            payload_offsets = np.concatenate([[0], np.cumsum(payload_sizes)])[:-1]
            if self.backend == "device":
                from .device_decode import decode_v3_device

                try:
                    left, right = decode_v3_device(hdr, np.asarray(block_sizes), np.asarray(payload_sizes),
                                                   block_payload, total_samples, self.thread_count, self.device)
                except ValueError as e:
                    raise DecodeError(f"[decode-error] {e}") from None
            elif not self.native:
                left, right = self._python_decode(hdr, block_sizes, offsets, lambda i: BitReader(
                    block_payload[int(payload_offsets[i]) : int(payload_offsets[i]) + payload_sizes[i]]))
            else:
                try:
                    left, right = native.decode_v3_blocks(
                        block_payload, payload_offsets, payload_sizes, block_sizes, offsets[:-1], hdr.channels,
                        hdr.stereo_mode, hdr.bit_depth, total_samples, self.thread_count,
                    )
                except ValueError as e:
                    self._explain_v3(hdr, int(str(e).split("=")[1]), block_payload, payload_offsets,
                                     payload_sizes, block_sizes)

        if hdr.channels == 2 and len(right) != len(left):
            raise DecodeError("[decode-error] stereo channel size mismatch")
        return left, right, hdr

    def decode_range(self, data: bytes, start: int, count: int):
        """Random-access decode of ``count`` frames from frame ``start`` ->
        (left, right, FrameHeader), arrays of length ``count``
        (lac_tpu/decoder.py:523-634).

        v3 streams decode only the blocks that overlap the range: the
        per-block compressed-size table makes every block independently
        decodable, so a seek costs O(range) and corruption outside the
        range is never read. The native backend decodes those blocks in
        the native runtime; the Python and device backends read them with
        the Python reader, as lac_tpu does. v2 streams have no payload-size
        table: a full decode, then a slice.

        Raises DecodeError on invalid input inside the decoded blocks and
        ValueError on a range outside the stream.
        """
        hdr, br, payload, block_sizes, payload_sizes = self._parse_frame(data)
        total = sum(block_sizes)
        if start < 0 or count < 0 or start + count > total:
            raise ValueError(f"range [{start}, {start + count}) outside stream of {total} samples")
        is_stereo = hdr.channels == 2
        empty = np.empty(0, np.int32)
        if count == 0:
            return empty, (empty.copy() if is_stereo else empty), hdr
        if hdr.version < 3:
            left, right, hdr = self.decode(data)
            return left[start : start + count], (right[start : start + count] if is_stereo else right), hdr

        block_payload = self._v3_payload(br, payload, payload_sizes)
        sample_off = np.concatenate([[0], np.cumsum(np.asarray(block_sizes, np.int64))])
        payload_off = np.concatenate([[0], np.cumsum(np.asarray(payload_sizes, np.int64))])
        b0 = int(np.searchsorted(sample_off, start, side="right") - 1)
        b1 = int(np.searchsorted(sample_off, start + count, side="left"))
        nsub = int(sample_off[b1] - sample_off[b0])
        sub_sizes = block_sizes[b0:b1]
        sub_psizes = payload_sizes[b0:b1]
        # the blocks' bytes, a view into the frame: never a copy of the whole payload
        sub_payload = block_payload[int(payload_off[b0]) : int(payload_off[b1])]
        sub_poff = payload_off[b0:b1] - payload_off[b0]
        sub_soff = sample_off[b0:b1] - sample_off[b0]

        def decode_one(ib, out_l, out_r):
            """Python decode of range block ``ib`` (canonical messages; the
            trailing-payload check comes before the PCM range check here)."""
            lo = int(sub_poff[ib])
            reader = BitReader(sub_payload[lo : lo + sub_psizes[ib]])
            a, b, mid_side = self._read_block(hdr, b0 + ib, reader, sub_sizes[ib])
            if reader.bits_remaining() != 0:
                raise DecodeError(f"[decode-error] block={b0 + ib} channel=trailing-payload")
            a, b = self._finish_block(hdr, a, b, mid_side)
            off = int(sub_soff[ib])
            out_l[off : off + sub_sizes[ib]] = a
            if b is not None:
                out_r[off : off + sub_sizes[ib]] = b

        if self.native:
            try:
                left, right = native.decode_v3_blocks(sub_payload, sub_poff, sub_psizes, sub_sizes, sub_soff,
                                                      hdr.channels, hdr.stereo_mode, hdr.bit_depth, nsub,
                                                      self.thread_count)
            except ValueError as e:
                bad = int(str(e).split("=")[1])
                decode_one(bad, np.zeros(nsub, np.int32), np.zeros(nsub, np.int32))
                raise DecodeError(f"[decode-error] block={b0 + bad} channel=primary") from None
        else:
            left = np.zeros(nsub, np.int32)
            right = np.zeros(nsub if is_stereo else 0, np.int32)
            for ib in range(b1 - b0):
                decode_one(ib, left, right)
        lo = start - int(sample_off[b0])
        return left[lo : lo + count], (right[lo : lo + count] if is_stereo else right), hdr

    def decode_to_wav(self, data: bytes, path: str):
        """Memory-bounded decode straight into a WAV file at ``path``.

        Analog of the reference CLI's mmap fast path (main.cpp:184-430):
        v3 payloads decode chunk-of-blocks at a time through the native
        parallel decoder, straight to interleaved PCM bytes, and stream
        into the file, so peak memory is O(input bytes + one chunk). v2
        streams decode in memory and go through the canonical writer, as
        the reference falls back to its library decoder for v2
        (main.cpp:769-784); so do the Python and device backends.

        Returns ``(samples_per_channel, FrameHeader)``, or ``None`` when
        the file could not be written. Raises DecodeError on any invalid
        input (callers publish via staged output, so a partial file never
        clobbers anything).
        """
        hdr, br, payload, block_sizes, payload_sizes = self._parse_frame(data)
        if hdr.version < 3 or not self.native:
            left, right, hdr = self.decode(data)
            ok = write_wav_unchecked_samples(path, left, right, hdr.channels, hdr.sample_rate, hdr.bit_depth)
            return (len(left), hdr) if ok else None

        block_payload = self._v3_payload(br, payload, payload_sizes)
        total_samples = sum(block_sizes)
        block_align = hdr.channels * (hdr.bit_depth // 8)
        data_size = total_samples * block_align
        data_padding = data_size & 1
        bs = np.asarray(block_sizes, dtype=np.int64)
        ps = np.asarray(payload_sizes, dtype=np.int64)
        sample_off = np.concatenate([[0], np.cumsum(bs)])
        payload_off = np.concatenate([[0], np.cumsum(ps)])
        chunk_target = max(DECODE_CHUNK_SAMPLES, C.MAX_BLOCK_SIZE)

        try:
            with open(path, "wb") as f:
                f.write(b"RIFF" + (36 + data_size + data_padding).to_bytes(4, "little") + b"WAVE")
                f.write(b"fmt " + (16).to_bytes(4, "little") + (1).to_bytes(2, "little")
                        + hdr.channels.to_bytes(2, "little") + hdr.sample_rate.to_bytes(4, "little")
                        + (hdr.sample_rate * block_align).to_bytes(4, "little")
                        + block_align.to_bytes(2, "little") + hdr.bit_depth.to_bytes(2, "little"))
                f.write(b"data" + data_size.to_bytes(4, "little"))
                nb = len(block_sizes)
                b0 = 0
                while b0 < nb:
                    b1 = b0 + 1
                    while b1 < nb and sample_off[b1 + 1] - sample_off[b0] <= chunk_target:
                        b1 += 1
                    try:
                        pcm = native.decode_v3_to_pcm(
                            block_payload[int(payload_off[b0]) : int(payload_off[b1])],
                            payload_off[b0:b1] - payload_off[b0], ps[b0:b1], bs[b0:b1],
                            sample_off[b0:b1] - sample_off[b0], hdr.channels, hdr.stereo_mode, hdr.bit_depth,
                            int(sample_off[b1] - sample_off[b0]), self.thread_count,
                        )
                    except ValueError as e:
                        bad = b0 + int(str(e).split("=")[1])
                        raise DecodeError(f"[decode-error] block={bad} channel=primary") from None
                    f.write(pcm)
                    b0 = b1
                if data_padding:
                    f.write(b"\x00")
        except OSError:
            return None
        return total_samples, hdr
