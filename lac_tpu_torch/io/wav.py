"""Strict RIFF/WAV reader and canonical writer (numpy, host-side; the
port's copy of lac_tpu/io/wav.py).

Validation rules mirror the reference WAV layer (io/wav_io.cpp:162-344):
exact RIFF size, a single 16-byte PCM ``fmt `` before a single non-empty
``data`` chunk, block_align/byte_rate consistency, odd-chunk pad skip,
1 GiB decoded-PCM cap, and an odd-payload zero pad on write.
"""

import numpy as np

from ..format import constants as C


def _sign_extend(raw: np.ndarray, bits: int) -> np.ndarray:
    shift = 32 - bits
    return (raw.astype(np.int32) << shift) >> shift


def read_wav(path: str):
    """Read a WAV file -> (left, right, channels, sample_rate, bit_depth).

    ``right`` is an empty array for mono. Returns None on any malformed
    input (matching the reference's boolean failure).
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    file_size = len(data)
    if file_size < 12:
        return None
    if data[0:4] != b"RIFF":
        return None
    riff_size = int.from_bytes(data[4:8], "little")
    if riff_size + 8 != file_size:
        return None
    if data[8:12] != b"WAVE":
        return None

    pos = 12
    remaining = file_size - 12
    got_fmt = got_data = False
    channels = sample_rate = bit_depth = block_align = 0
    left = right = None

    while remaining > 0:
        if remaining < 8:
            return None
        chunk_id = data[pos : pos + 4]
        chunk_size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        pos += 8
        remaining -= 8
        padded = chunk_size + (chunk_size & 1)
        if padded > remaining:
            return None

        if chunk_id == b"fmt ":
            if got_fmt or got_data or chunk_size != 16:
                return None
            fmt = data[pos : pos + 16]
            audio_format = int.from_bytes(fmt[0:2], "little")
            channels = int.from_bytes(fmt[2:4], "little")
            sample_rate = int.from_bytes(fmt[4:8], "little")
            byte_rate = int.from_bytes(fmt[8:12], "little")
            block_align = int.from_bytes(fmt[12:14], "little")
            bits_per_sample = int.from_bytes(fmt[14:16], "little")
            if audio_format != 1:
                return None
            if bits_per_sample not in C.SUPPORTED_BIT_DEPTHS:
                return None
            if sample_rate not in C.SUPPORTED_SAMPLE_RATES:
                return None
            if channels not in (1, 2):
                return None
            expected_align = channels * (bits_per_sample // 8)
            if block_align != expected_align:
                return None
            if byte_rate != sample_rate * expected_align:
                return None
            bit_depth = bits_per_sample
            got_fmt = True
        elif chunk_id == b"data":
            if not got_fmt or got_data or chunk_size == 0:
                return None
            if chunk_size % block_align != 0:
                return None
            frames = chunk_size // block_align
            if frames * channels * 4 > C.MAX_DECODED_PCM_BYTES:
                return None
            if bit_depth == 16:
                flat = np.frombuffer(data, dtype="<i2", count=frames * channels, offset=pos)
                samples = flat.astype(np.int32).reshape(frames, channels)
            else:  # 24-bit: combine little-endian byte triples
                payload = np.frombuffer(data, dtype=np.uint8, count=chunk_size, offset=pos)
                b3 = payload.reshape(-1, 3)
                acc = (
                    b3[:, 0].astype(np.uint32)
                    | (b3[:, 1].astype(np.uint32) << np.uint32(8))
                    | (b3[:, 2].astype(np.uint32) << np.uint32(16))
                )
                samples = _sign_extend(acc, 24).reshape(frames, channels)
            left = np.ascontiguousarray(samples[:, 0])
            right = np.ascontiguousarray(samples[:, 1]) if channels == 2 else np.empty(0, np.int32)
            got_data = True
        # unknown chunks: skip
        pos += padded
        remaining -= padded

    if not (got_fmt and got_data):
        return None
    return left, right, channels, sample_rate, bit_depth


def _pcm_bytes(left, right, channels, bit_depth) -> bytes:
    frames = len(left)
    if bit_depth == 16:
        inter = np.empty((frames, channels), dtype="<i2")
        inter[:, 0] = np.asarray(left, dtype=np.int32).astype(np.int16)
        if channels == 2:
            inter[:, 1] = np.asarray(right, dtype=np.int32).astype(np.int16)
        return inter.tobytes()
    inter = np.empty((frames, channels), dtype=np.uint32)
    inter[:, 0] = np.asarray(left, dtype=np.int32).view(np.uint32)
    if channels == 2:
        inter[:, 1] = np.asarray(right, dtype=np.int32).view(np.uint32)
    flat = inter.reshape(-1)
    out = np.empty((frames * channels, 3), dtype=np.uint8)
    out[:, 0] = (flat & np.uint32(0xFF)).astype(np.uint8)
    out[:, 1] = ((flat >> np.uint32(8)) & np.uint32(0xFF)).astype(np.uint8)
    out[:, 2] = ((flat >> np.uint32(16)) & np.uint32(0xFF)).astype(np.uint8)
    return out.tobytes()


def _write_wav_impl(path, left, right, channels, sample_rate, bit_depth, validate) -> bool:
    left = np.asarray(left, dtype=np.int32)
    right = np.asarray(right, dtype=np.int32) if len(right) else np.empty(0, np.int32)
    if channels not in (1, 2):
        return False
    if sample_rate not in C.SUPPORTED_SAMPLE_RATES:
        return False
    if bit_depth not in C.SUPPORTED_BIT_DEPTHS:
        return False
    if len(left) == 0:
        return False
    if channels == 1 and len(right) != 0:
        return False
    if channels == 2 and len(left) != len(right):
        return False
    if validate:
        lo, hi = C.pcm_range(bit_depth)
        for ch in (left, right):
            if len(ch) and (ch.min() < lo or ch.max() > hi):
                return False

    block_align = channels * (bit_depth // 8)
    data_size = len(left) * block_align
    data_padding = data_size & 1
    riff_size = 36 + data_size + data_padding
    if riff_size > 0xFFFFFFFF:
        return False

    try:
        with open(path, "wb") as f:
            f.write(b"RIFF")
            f.write(riff_size.to_bytes(4, "little"))
            f.write(b"WAVE")
            f.write(b"fmt ")
            f.write((16).to_bytes(4, "little"))
            f.write((1).to_bytes(2, "little"))
            f.write(channels.to_bytes(2, "little"))
            f.write(sample_rate.to_bytes(4, "little"))
            f.write((sample_rate * block_align).to_bytes(4, "little"))
            f.write(block_align.to_bytes(2, "little"))
            f.write(bit_depth.to_bytes(2, "little"))
            f.write(b"data")
            f.write(data_size.to_bytes(4, "little"))
            f.write(_pcm_bytes(left, right, channels, bit_depth))
            if data_padding:
                f.write(b"\x00")
    except OSError:
        return False
    return True


def write_wav(path, left, right, channels, sample_rate, bit_depth) -> bool:
    return _write_wav_impl(path, left, right, channels, sample_rate, bit_depth, True)


def write_wav_unchecked_samples(path, left, right, channels, sample_rate, bit_depth) -> bool:
    return _write_wav_impl(path, left, right, channels, sample_rate, bit_depth, False)
