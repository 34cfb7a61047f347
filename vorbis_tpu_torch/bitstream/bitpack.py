"""Vorbis bit-packing (the "oggpack" convention).

Vorbis I packs fields LSB-first: the first bit written becomes bit 0 of
byte 0, values are written least-significant-bit first, and multi-byte
values therefore read back in little-endian bit order.  (Reference
behavior: lib/bitwise.c in libogg; semantics normative in
doc/Vorbis_I_spec / section "Bitpacking convention".)

Copy of vorbis_tpu/bitstream/bitpack.py, kept line-aligned with it:
`BitReader` / `BitWriter` — simple, branchy, host-side readers used for
header parsing and for the adaptive Huffman paths.  Clarity first.  The
port packs audio packets on the device (ops/encdevice.py), so the
source's host packers (`FieldWriter`, `pack_bits_array` and its native
branch) are not copied.
"""

from __future__ import annotations

import numpy as np

_MASK = [(1 << i) - 1 for i in range(65)]


class EndOfPacket(Exception):
    """Raised when a read runs off the end of the packet.

    A truncated packet is a *normal* stop condition in Vorbis residue
    decode (reference: lib/res0.c "a truncated packet here just means
    'stop working'"), so callers catch this rather than treating it as
    a hard error.
    """


def ilog(v: int) -> int:
    """Number of bits needed to represent v (ilog(0)=0, ilog(1)=1, ilog(7)=3).

    Mirrors the codec's ilog/ilog2 convention used for field widths
    (reference: lib/sharedbook.c `_ilog`).
    """
    ret = 0
    while v > 0:
        ret += 1
        v >>= 1
    return ret


class BitReader:
    """LSB-first bit reader over a bytes-like packet."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data):
        # int view for speed; numpy frombuffer avoids a copy
        self.data = np.frombuffer(bytes(data), dtype=np.uint8)
        self.nbits = len(self.data) * 8
        self.pos = 0  # absolute bit position

    def bits_remaining(self) -> int:
        return self.nbits - self.pos

    def readbytes(self, n: int) -> bytes:
        """Read n whole bytes (8 bits each, LSB-first stream order)."""
        if self.pos & 7 == 0:
            byte = self.pos >> 3
            if self.pos + 8 * n > self.nbits:
                self.pos = self.nbits
                raise EndOfPacket
            out = self.data[byte:byte + n].tobytes()
            self.pos += 8 * n
            return out
        return bytes(self.read(8) for _ in range(n))

    def read(self, n: int) -> int:
        """Read n bits (0..64) LSB-first; raises EndOfPacket on overrun."""
        if n == 0:
            return 0
        pos = self.pos
        if pos + n > self.nbits:
            self.pos = self.nbits
            raise EndOfPacket
        byte = pos >> 3
        bit = pos & 7
        # gather enough bytes to cover n+7 bits
        nbytes = (bit + n + 7) >> 3
        acc = 0
        d = self.data
        for i in range(nbytes - 1, -1, -1):
            acc = (acc << 8) | int(d[byte + i])
        self.pos = pos + n
        return (acc >> bit) & _MASK[n]

    def read1(self) -> int:
        pos = self.pos
        if pos >= self.nbits:
            raise EndOfPacket
        self.pos = pos + 1
        return (int(self.data[pos >> 3]) >> (pos & 7)) & 1

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        if v & (1 << (n - 1)):
            v -= 1 << n
        return v

    def look(self, n: int) -> int:
        """Peek up to n bits; bits past the end read as 0 (oggpack_look
        semantics needed by the treeless Huffman decoder's first-stage
        table, which over-reads near packet end)."""
        pos = self.pos
        byte = pos >> 3
        bit = pos & 7
        d = self.data
        acc = 0
        nbytes = (bit + n + 7) >> 3
        for i in range(nbytes - 1, -1, -1):
            b = int(d[byte + i]) if (byte + i) < len(d) else 0
            acc = (acc << 8) | b
        return (acc >> bit) & _MASK[n]

    def advance(self, n: int) -> None:
        self.pos += n

    def read_bytes(self, n: int) -> bytes:
        """Read n whole bytes (used for UTF-8 comment strings)."""
        out = bytearray()
        for _ in range(n):
            out.append(self.read(8))
        return bytes(out)


class BitWriter:
    """LSB-first bit writer producing a bytes packet."""

    __slots__ = ("_acc", "_accbits", "_bytes")

    def __init__(self):
        self._acc = 0
        self._accbits = 0
        self._bytes = bytearray()

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        self._acc |= (value & _MASK[n]) << self._accbits
        self._accbits += n
        while self._accbits >= 8:
            self._bytes.append(self._acc & 0xFF)
            self._acc >>= 8
            self._accbits -= 8

    @property
    def bitpos(self) -> int:
        """Bits written so far (the reference's oggpack_bits)."""
        return len(self._bytes) * 8 + self._accbits

    def write_bytes(self, data: bytes) -> None:
        for b in data:
            self.write(b, 8)

    def bit_length(self) -> int:
        return len(self._bytes) * 8 + self._accbits

    def getvalue(self) -> bytes:
        """Flush (zero-pad final partial byte) and return the packet."""
        out = bytearray(self._bytes)
        if self._accbits:
            out.append(self._acc & 0xFF)
        return bytes(out)
