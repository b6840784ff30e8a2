"""MSB-first bit reader with a sticky error flag (the port's copy of
lac_tpu/bitio/reader.py).

Semantics match the reference BitReader (bit_reader.hpp:7-202): reads
past the end set the error flag and return 0; ``read_unary_ones`` guards
against overlong runs; ``consume_zero_padding_to_byte`` enforces
canonical zero padding.
"""


class BitReader:
    __slots__ = ("_data", "_bitpos", "_nbits", "_error")

    def __init__(self, data: bytes):
        self._data = data
        self._bitpos = 0
        self._nbits = len(data) * 8
        self._error = False

    def has_error(self) -> bool:
        return self._error

    def mark_error(self) -> None:
        self._error = True

    def bits_remaining(self) -> int:
        return 0 if self._error else self._nbits - self._bitpos

    def read_bit(self) -> int:
        if self._error or self._bitpos >= self._nbits:
            self._error = True
            return 0
        byte = self._data[self._bitpos >> 3]
        bit = (byte >> (7 - (self._bitpos & 7))) & 1
        self._bitpos += 1
        return bit

    def skip_bits(self, nbits: int) -> None:
        """Advance the cursor without decoding (error past the end,
        like every read)."""
        if self._error or self._bitpos + nbits > self._nbits:
            self._error = True
            return
        self._bitpos += nbits

    def read_bits(self, nbits: int) -> int:
        if nbits <= 0:
            return 0
        if self._error or self._bitpos + nbits > self._nbits:
            self._error = True
            return 0
        pos, out = self._bitpos, 0
        data = self._data
        # leading partial byte
        first_byte = pos >> 3
        offset = pos & 7
        end = pos + nbits
        last_byte = (end - 1) >> 3
        chunk = int.from_bytes(data[first_byte : last_byte + 1], "big")
        total_bits = (last_byte - first_byte + 1) * 8
        out = (chunk >> (total_bits - offset - nbits)) & ((1 << nbits) - 1)
        self._bitpos = end
        return out

    def read_unary_ones(self, max_ones: int):
        """Count consecutive 1 bits, consume the terminating 0.

        Returns the count, or None on error / count exceeding ``max_ones``
        (bit_reader.hpp:140-172).
        """
        count = 0
        while True:
            if self._error or self._bitpos >= self._nbits:
                self._error = True
                return None
            # fast path: scan remaining bits of the current byte
            byte = self._data[self._bitpos >> 3]
            avail = 8 - (self._bitpos & 7)
            window = byte & ((1 << avail) - 1)
            if window == (1 << avail) - 1:
                count += avail
                self._bitpos += avail
                if count > max_ones:
                    self._error = True
                    return None
                continue
            # a zero exists within this byte
            for _ in range(avail):
                bit = self.read_bit()
                if bit == 0:
                    if count > max_ones:
                        self._error = True
                        return None
                    return count
                count += 1
                if count > max_ones:
                    self._error = True
                    return None

    def consume_zero_padding_to_byte(self) -> bool:
        """Consume up to 7 pad bits; all must be zero (bit_reader.hpp:180-185)."""
        while self._bitpos & 7:
            if self.read_bit() != 0 or self._error:
                self._error = True
                return False
        return not self._error
