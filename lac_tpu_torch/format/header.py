"""Frame header pack/parse (80 bits; format.md:49-71, frame_header.hpp:7-78;
the port's copy of lac_tpu/format/header.py)."""

from dataclasses import dataclass

from . import constants as C


@dataclass
class FrameHeader:
    sync: int = C.SYNC_WORD
    version: int = C.FORMAT_VERSION
    channels: int = 2
    stereo_mode: int = C.STEREO_PER_BLOCK
    sample_rate: int = 44100
    bit_depth: int = 16
    reserved: int = 0

    def pack(self) -> bytes:
        """Serialize to the 10-byte wire layout (frame_header.hpp:25-36)."""
        return bytes(
            [
                (self.sync >> 8) & 0xFF,
                self.sync & 0xFF,
                self.version & 0xFF,
                self.channels & 0xFF,
                self.stereo_mode & 0xFF,
                # sample_rate_low is a 16-bit big-endian *field* of the low
                # 16 bits, followed by the high 8 bits in their own field.
                (self.sample_rate >> 8) & 0xFF,
                self.sample_rate & 0xFF,
                (self.sample_rate >> 16) & 0xFF,
                self.bit_depth & 0xFF,
                self.reserved & 0xFF,
            ]
        )

    @classmethod
    def unpack(cls, data: bytes) -> "FrameHeader":
        """Parse 10 header bytes without validation (frame_header.hpp:38-48)."""
        if len(data) < C.HEADER_BYTES:
            raise ValueError("frame header truncated")
        b = data[: C.HEADER_BYTES]
        return cls(
            sync=(b[0] << 8) | b[1],
            version=b[2],
            channels=b[3],
            stereo_mode=b[4],
            sample_rate=((b[5] << 8) | b[6]) | (b[7] << 16),
            bit_depth=b[8],
            reserved=b[9],
        )

    def validate(self) -> bool:
        """Canonical-header rules (frame_header.hpp:50-59)."""
        if self.sync != C.SYNC_WORD:
            return False
        if self.version not in (C.LEGACY_VERSION, C.FORMAT_VERSION):
            return False
        if self.channels not in (1, 2):
            return False
        if self.channels == 1 and self.stereo_mode != 0:
            return False
        if self.stereo_mode not in (0, 1, 2):
            return False
        if self.sample_rate not in C.SUPPORTED_SAMPLE_RATES:
            return False
        if self.bit_depth not in C.SUPPORTED_BIT_DEPTHS:
            return False
        if self.reserved != 0:
            return False
        return True

    @classmethod
    def parse(cls, data: bytes):
        """Parse + validate; returns (header, header_bytes) or None."""
        if len(data) < C.HEADER_BYTES:
            return None
        hdr = cls.unpack(data)
        if not hdr.validate():
            return None
        return hdr, C.HEADER_BYTES
