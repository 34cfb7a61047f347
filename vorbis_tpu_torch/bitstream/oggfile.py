"""Ogg transport framing: page parse/emit, CRC, packet assembly.

Host-side replacement for the external libogg dependency of the
reference (reference links libogg for ogg_stream_*/ogg_sync_*; see
lib/vorbisfile.c).  Implemented from the Ogg framing spec (RFC 3533):

  page = "OggS" | version(0) | header_type | granulepos(le64) |
         serialno(le32) | pageno(le32) | crc(le32) | nsegs | lacing[nsegs]
         | body

CRC is the unreflected CRC-32 with polynomial 0x04c11db7, initial value
0 and no final xor, computed over the whole page with the CRC field
zeroed.

Copy of vorbis_tpu/bitstream/oggfile.py, kept line-aligned with it; the
CRC runs in the port's own host C (`ogg_crc`), with no fall-back to the
Python loop, which stays as `ogg_crc_plain`.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..native import ogg_crc as _host_ogg_crc


def _make_crc_table() -> np.ndarray:
    tbl = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7) if (r & 0x80000000) else (r << 1)
            r &= 0xFFFFFFFF
        tbl[i] = r
    return tbl


_CRC_TABLE = _make_crc_table()


def ogg_crc(data: bytes, crc: int = 0) -> int:
    """The page CRC in the port's own host C (csrc/host_ogg.c, built at
    first use by vorbis_tpu_torch.native); raises when it cannot be
    built."""
    return _host_ogg_crc(data, crc)


def ogg_crc_plain(data: bytes, crc: int = 0) -> int:
    """The same CRC as a Python loop: the plain version ogg_crc is held
    against (tests/test_torch_hostcopy.py)."""
    tbl = _CRC_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(tbl[((crc >> 24) & 0xFF) ^ b])
    return crc


CONTINUED = 0x01
BOS = 0x02
EOS = 0x04


@dataclass
class OggPage:
    header_type: int
    granulepos: int
    serialno: int
    pageno: int
    segments: list  # list[bytes] lacing-delimited segments
    # derived
    @property
    def continued(self):
        return bool(self.header_type & CONTINUED)

    @property
    def bos(self):
        return bool(self.header_type & BOS)

    @property
    def eos(self):
        return bool(self.header_type & EOS)

    def to_bytes(self) -> bytes:
        lacing = bytearray()
        body = bytearray()
        for seg in self.segments:
            lacing.append(len(seg))
            body += seg
        hdr = struct.pack(
            "<4sBBqII", b"OggS", 0, self.header_type,
            self.granulepos & 0xFFFFFFFFFFFFFFFF if self.granulepos >= 0 else self.granulepos,
            self.serialno & 0xFFFFFFFF, self.pageno,
        )
        pre_crc = hdr + b"\x00\x00\x00\x00" + bytes([len(lacing)]) + bytes(lacing) + bytes(body)
        crc = ogg_crc(pre_crc)
        return pre_crc[:22] + struct.pack("<I", crc) + pre_crc[26:]


def parse_page(buf: bytes, off: int):
    """Parse one page at buf[off:]. Returns (OggPage, next_off) or None
    if there aren't enough bytes / bad capture.  Raises ValueError on CRC
    mismatch (caller resyncs)."""
    if buf[off:off + 4] != b"OggS":
        return None
    if off + 27 > len(buf):
        return None
    (_, version, htype, gp, serial, pageno, crc, nsegs) = struct.unpack(
        "<4sBBqIIIB", buf[off:off + 27])
    if version != 0:
        raise ValueError("bad ogg version")
    if off + 27 + nsegs > len(buf):
        return None
    lacing = buf[off + 27:off + 27 + nsegs]
    body_len = sum(lacing)
    total = 27 + nsegs + body_len
    if off + total > len(buf):
        return None
    page_bytes = bytearray(buf[off:off + total])
    page_bytes[22:26] = b"\x00\x00\x00\x00"
    if ogg_crc(bytes(page_bytes)) != crc:
        raise ValueError("ogg page crc mismatch")
    segments = []
    p = off + 27 + nsegs
    for l in lacing:
        segments.append(buf[p:p + l])
        p += l
    return OggPage(htype, gp, serial, pageno, segments), off + total


class OggStreamReader:
    """Pull packets (with granulepos bookkeeping) out of an Ogg byte
    stream for one logical stream (first BOS serial by default).

    Mirrors the role of ogg_sync/ogg_stream in the reference decode loop
    (reference: examples/decoder_example.c flow), including resync across
    damaged pages (reported as holes).
    """

    def __init__(self, data: bytes, serialno: int | None = None):
        self.data = data
        self.serialno = serialno
        self.pages: list[OggPage] = []
        self._scan()

    def _scan(self):
        buf, off = self.data, 0
        n = len(buf)
        while off < n:
            idx = buf.find(b"OggS", off)
            if idx < 0:
                break
            try:
                res = parse_page(buf, idx)
            except ValueError:
                off = idx + 1
                continue
            if res is None:
                off = idx + 1
                continue
            page, off = res
            if self.serialno is None and page.bos:
                self.serialno = page.serialno
            if self.serialno is not None and page.serialno == self.serialno:
                self.pages.append(page)

    def packets(self):
        """Yield (packet_bytes, granulepos_of_page_end_or_None, eos)."""
        partial = bytearray()
        have_partial = False
        for page in self.pages:
            segs = page.segments
            i = 0
            if page.continued and not have_partial:
                # hole: skip continuation segments we can't complete
                while i < len(segs) and len(segs[i]) == 255:
                    i += 1
                if i < len(segs):
                    i += 1  # drop the terminating segment too
                partial = bytearray()
            cur = partial
            n_complete_on_page = sum(1 for s in segs[i:] if len(s) < 255)
            emitted = 0
            for j in range(i, len(segs)):
                cur += segs[j]
                if len(segs[j]) < 255:
                    emitted += 1
                    last_on_page = emitted == n_complete_on_page
                    gp = page.granulepos if last_on_page and not any(
                        len(s) == 255 for s in segs[j + 1:]) else None
                    # granulepos applies to the last packet *completed* on the page
                    yield bytes(cur), (page.granulepos if last_on_page else None), (
                        page.eos and last_on_page)
                    cur = bytearray()
            partial = cur
            have_partial = len(partial) > 0 or (len(segs) > 0 and len(segs[-1]) == 255)


class OggStreamWriter:
    """Accumulate packets and emit pages (libogg packetin/pageout model)."""

    MAX_BODY_SEGS = 255

    def __init__(self, serialno: int):
        self.serialno = serialno
        self.pageno = 0
        self._segs: list[bytes] = []          # pending lacing segments
        # granulepos of the packet each segment COMPLETES (None on
        # non-final segments) — libogg keeps the same per-lacing
        # granule_vals so spilled pages can stamp the last packet
        # completed on them
        self._seg_gp: list = []
        self._granule = -1
        self._continued_next = False
        self._bos_pending = True
        self._eos_pending = False
        self._pages: list[bytes] = []

    def _lace(self, packet: bytes, granulepos: int):
        n = len(packet)
        off = 0
        while True:
            take = min(255, n - off)
            self._segs.append(packet[off:off + take])
            self._seg_gp.append(None)
            off += take
            if take < 255:
                break
            if off == n:
                self._segs.append(b"")  # exact multiple of 255 → empty terminator
                self._seg_gp.append(None)
                break
        self._seg_gp[-1] = granulepos

    def packetin(self, packet: bytes, granulepos: int, eos: bool = False):
        self._lace(packet, granulepos)
        self._granule = granulepos
        self._eos_pending = eos
        # spill full pages as they fill
        while len(self._segs) >= self.MAX_BODY_SEGS:
            head = self._segs[:self.MAX_BODY_SEGS]
            head_gp = [g for g in self._seg_gp[:self.MAX_BODY_SEGS]
                       if g is not None]
            ends_packet = len(head[-1]) < 255
            self._emit(head, head_gp[-1] if head_gp else -1, eos=False)
            self._segs = self._segs[self.MAX_BODY_SEGS:]
            self._seg_gp = self._seg_gp[self.MAX_BODY_SEGS:]
            self._continued_next = not ends_packet

    def _emit(self, segs, granulepos, eos):
        htype = 0
        if self._continued_next:
            htype |= CONTINUED
        if self._bos_pending:
            htype |= BOS
            self._bos_pending = False
        if eos:
            htype |= EOS
        page = OggPage(htype, granulepos, self.serialno, self.pageno, list(segs))
        self.pageno += 1
        self._pages.append(page.to_bytes())
        self._continued_next = False

    def flush(self, eos: bool = False):
        """Force all pending segments onto pages.  The final emitted page
        carries the EOS flag if requested here or if the last packetin()
        was marked eos."""
        while self._segs:
            head = self._segs[:self.MAX_BODY_SEGS]
            head_gp = [g for g in self._seg_gp[:self.MAX_BODY_SEGS]
                       if g is not None]
            self._segs = self._segs[self.MAX_BODY_SEGS:]
            self._seg_gp = self._seg_gp[self.MAX_BODY_SEGS:]
            last = not self._segs
            ends_packet = len(head[-1]) < 255
            self._emit(head, head_gp[-1] if head_gp else -1,
                       eos=(eos or self._eos_pending) and last)
            self._continued_next = not ends_packet
        if eos or self._eos_pending:
            self._eos_pending = False

    def pageout_all(self) -> bytes:
        out = b"".join(self._pages)
        self._pages = []
        return out
