"""Streaming (bounded-memory) WAV -> .lac encode (lac_tpu/stream.py).

The encode-side counterpart of ``FrameDecoder.decode_to_wav``: the
reference CLI loads the entire WAV into memory (main.cpp:658, behind
its 1 GiB input cap) and assembles the whole frame in memory before
writing (lac/encoder.cpp:445-465). Because every 16384-sample block of
the v3 format is encoded independently (stereo decisions, probes,
partition plans and adaptation state never cross a block boundary;
lac/encoder.cpp:59-69), a chunked encoder can:

1. walk the RIFF structure without loading the ``data`` payload
   (``scan_wav``),
2. write the frame header plus a placeholder v3 block table,
3. encode a chunk of blocks at a time through the ordinary
   ``FrameEncoder`` (each chunk is split on a block boundary, so its
   per-block payload bytes are those of the whole-file encode),
   streaming each chunk's payload straight to the file,
4. seek back and write the real table.

Peak resident memory is O(chunk), not O(file); output bytes are
identical to ``FrameEncoder.encode`` by block independence. Each chunk
is one ``FrameEncoder.encode`` call: with at least
``device_pipeline.MIN_FULL_BLOCKS`` full blocks it runs its own plane
pipeline on the encoder's device, or over its mesh's cards (the CLI's
encoder takes :func:`.parallel.default_mesh`), a shorter last chunk
takes the host route.
"""

import itertools
import os
from dataclasses import dataclass

import numpy as np

from .format import constants as C
from .format.header import FrameHeader
from .io.wav import _sign_extend

_TMP_SEQ = itertools.count()  # per-call temp-name uniqueness (thread-safe)


class WavReadError(OSError):
    """The WAV input failed or changed mid-encode (truncated read, or
    the re-encoded chunk no longer matches the scanned layout)."""


@dataclass
class WavInfo:
    """Result of a streaming RIFF walk: where the PCM lives."""

    data_offset: int  # file offset of the first PCM byte
    frames: int  # samples per channel
    channels: int
    sample_rate: int
    bit_depth: int

    @property
    def block_align(self) -> int:
        return self.channels * (self.bit_depth // 8)


def scan_wav(path: str):
    """Validate a WAV file and locate its PCM without reading it.

    Applies exactly the rules of ``io.wav.read_wav`` (which mirror the
    reference's reader, io/wav_io.cpp:162-278): exact RIFF size, one
    16-byte PCM ``fmt `` before one non-empty ``data``, align/rate
    consistency, odd-chunk padding, supported formats, 1 GiB decoded
    cap. Returns a ``WavInfo`` or None on any malformed input.
    ``tests/test_torch_stream.py`` pins scan_wav == read_wav on a
    malformed-input corpus so the two walkers cannot drift.
    """
    try:
        f = open(path, "rb")
    except OSError:
        return None
    with f:
        try:
            f.seek(0, os.SEEK_END)
            file_size = f.tell()
            f.seek(0)
            head = f.read(12)
        except OSError:
            return None
        if file_size < 12 or len(head) < 12:
            return None
        if head[0:4] != b"RIFF":
            return None
        riff_size = int.from_bytes(head[4:8], "little")
        if riff_size + 8 != file_size:
            return None
        if head[8:12] != b"WAVE":
            return None

        pos = 12
        remaining = file_size - 12
        got_fmt = got_data = False
        channels = sample_rate = bit_depth = block_align = 0
        info = None

        while remaining > 0:
            if remaining < 8:
                return None
            f.seek(pos)
            chdr = f.read(8)
            if len(chdr) < 8:
                return None
            chunk_id = chdr[0:4]
            chunk_size = int.from_bytes(chdr[4:8], "little")
            pos += 8
            remaining -= 8
            padded = chunk_size + (chunk_size & 1)
            if padded > remaining:
                return None

            if chunk_id == b"fmt ":
                if got_fmt or got_data or chunk_size != 16:
                    return None
                fmt = f.read(16)
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
                info = WavInfo(pos, frames, channels, sample_rate, bit_depth)
                got_data = True
            # unknown chunks: skip without reading
            pos += padded
            remaining -= padded

        if not (got_fmt and got_data):
            return None
        return info


def read_pcm_frames(f, info: WavInfo, start: int, count: int):
    """Read ``count`` frames starting at frame ``start`` -> (left, right).

    Same sample decode as ``io.wav.read_wav`` (sign-extended int32;
    io/wav_io.cpp:72-102); ``right`` is empty for mono.
    """
    align = info.block_align
    f.seek(info.data_offset + start * align)
    raw = f.read(count * align)
    if len(raw) != count * align:
        raise WavReadError("WAV data chunk truncated mid-read")
    if info.bit_depth == 16:
        flat = np.frombuffer(raw, dtype="<i2", count=count * info.channels)
        samples = flat.astype(np.int32).reshape(count, info.channels)
    else:
        b3 = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        acc = (
            b3[:, 0].astype(np.uint32)
            | (b3[:, 1].astype(np.uint32) << np.uint32(8))
            | (b3[:, 2].astype(np.uint32) << np.uint32(16))
        )
        samples = _sign_extend(acc, 24).reshape(count, info.channels)
    left = np.ascontiguousarray(samples[:, 0])
    right = (
        np.ascontiguousarray(samples[:, 1])
        if info.channels == 2
        else np.empty(0, np.int32)
    )
    return left, right


def _default_chunk_blocks() -> int:
    try:
        return int(os.environ.get("LAC_TPU_STREAM_CHUNK_BLOCKS", "512"))
    except ValueError:
        return 512


def encode_wav_to_lac(
    in_path: str,
    out_path: str,
    stereo_mode: int = C.STEREO_PER_BLOCK,
    *,
    chunk_blocks: int = 0,
    encoder=None,
    thread_count: int = 0,
    zero_run_enabled: bool = True,
    partitioning_enabled: bool = True,
    device="cuda",
    mesh=None,
    info=None,
):
    """Encode a WAV file into a .lac file with O(chunk) memory.

    ``chunk_blocks`` (default ``LAC_TPU_STREAM_CHUNK_BLOCKS`` or 512 =
    8.4M samples/channel per chunk) sets the residency/latency
    trade-off; any value >= 1 yields byte-identical output. Pass a
    preconfigured ``FrameEncoder`` via ``encoder`` to reuse it across
    files (its sample_rate/bit_depth/stereo_mode must match the input;
    its device and mesh are the ones used). When omitted, one is built on
    ``device`` ("cuda" unless the caller asks for "cpu"; a missing card
    raises), or over the cards of ``mesh``, from the WAV header and the
    keyword settings. ``info``
    skips the RIFF walk when the caller already holds this path's
    ``scan_wav`` result.

    Returns the total number of .lac bytes written, or None when the
    input is not a valid WAV (mirror of ``read_wav``'s failure). Raises
    the same errors as ``FrameEncoder.encode`` for out-of-range PCM,
    ``WavReadError`` when the input breaks or changes mid-encode, and
    OSError on write failure. Output is written to a same-directory
    temp file and atomically renamed onto ``out_path`` only on success,
    so a failed encode never leaves a partial or corrupt output.
    """
    from . import device_pipeline
    from .encoder import FrameEncoder, _cold_route

    if info is None:
        info = scan_wav(in_path)
    if info is None:
        return None
    if chunk_blocks <= 0:
        chunk_blocks = max(1, _default_chunk_blocks())

    effective_mode = stereo_mode if info.channels == 2 else 0
    if encoder is None:
        encoder = FrameEncoder(12, effective_mode, info.sample_rate, info.bit_depth, device=device, mesh=mesh)
        encoder.set_zero_run_enabled(zero_run_enabled)
        encoder.set_partitioning_enabled(partitioning_enabled)
        encoder.set_thread_count(thread_count)
    else:
        if (
            encoder.sample_rate != info.sample_rate
            or encoder.bit_depth != info.bit_depth
            or encoder.stereo_mode != effective_mode
        ):
            raise ValueError("provided encoder's format does not match the WAV input")

    nblocks = -(-info.frames // C.MAX_BLOCK_SIZE)
    if encoder._device.type == "cuda" and not _cold_route(nblocks):
        # the whole file decides the cold route, not each chunk (every
        # chunk may be short enough for it): the chunks go to the card
        device_pipeline.mark_warm()
    hdr = FrameHeader(
        channels=info.channels,
        stereo_mode=effective_mode,
        sample_rate=info.sample_rate,
        bit_depth=info.bit_depth,
        version=C.FORMAT_VERSION,
    )
    table = np.zeros((nblocks, 2), dtype=">u4")
    table[:, 0] = C.MAX_BLOCK_SIZE
    table[nblocks - 1, 0] = info.frames - (nblocks - 1) * C.MAX_BLOCK_SIZE

    total = 0
    # unique per call, not just per process: concurrent encodes of the
    # same out_path inside one process (worker threads on the direct
    # API) must never clobber/unlink each other's temp file
    tmp_path = f"{out_path}.tmp-{os.getpid()}-{next(_TMP_SEQ)}"
    try:
        with open(in_path, "rb") as fin, open(tmp_path, "wb") as fout:
            head = hdr.pack() + nblocks.to_bytes(4, "big")
            fout.write(head)
            table_pos = len(head)
            fout.write(table.tobytes())  # placeholder: compressed sizes 0
            total = table_pos + table.nbytes

            for b0 in range(0, nblocks, chunk_blocks):
                b1 = min(b0 + chunk_blocks, nblocks)
                s0 = b0 * C.MAX_BLOCK_SIZE
                s1 = min(b1 * C.MAX_BLOCK_SIZE, info.frames)
                left, right = read_pcm_frames(fin, info, s0, s1 - s0)
                frame = encoder.encode(left, right)

                # the chunk is itself a well-formed mini-frame; keep
                # only its per-block payloads and table rows (any
                # mismatch means the input changed under us)
                nb = int.from_bytes(frame[C.HEADER_BYTES : C.HEADER_BYTES + 4], "big")
                if nb != b1 - b0:
                    raise WavReadError("chunk encode produced an unexpected block count")
                sub = np.frombuffer(
                    frame, dtype=">u4", count=2 * nb, offset=C.HEADER_BYTES + 4
                ).reshape(nb, 2)
                if not np.array_equal(sub[:, 0], table[b0:b1, 0]):
                    raise WavReadError("chunk encode produced unexpected block sizes")
                # zero-copy view: the chunk payload is several MB
                payload = memoryview(frame)[C.HEADER_BYTES + 4 + 8 * nb :]
                if int(sub[:, 1].sum()) != len(payload):
                    raise WavReadError("chunk table does not cover its payload")
                table[b0:b1, 1] = sub[:, 1]
                fout.write(payload)
                total += len(payload)

            fout.seek(table_pos)
            fout.write(table.tobytes())
        os.replace(tmp_path, out_path)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise
    return total
