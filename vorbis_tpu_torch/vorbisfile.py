"""vorbisfile-equivalent streaming/seek layer (reference:
lib/vorbisfile.c).

`OggVorbisFile` mirrors the `ov_*` API over the in-repo decoder, with
the reference's INCREMENTAL architecture: the source is a seekable
byte stream accessed through page-capture primitives (no whole-buffer
slurp), chained-stream discovery runs as serialno bisection over byte
offsets (_bisect_forward_serialno, vorbisfile.c:474), and pcm seeking
is interpolated granulepos bisection over byte offsets
(ov_pcm_seek_page, vorbisfile.c:1409).  Memory stays bounded by the
page size during streaming reads regardless of stream length.

API map (reference file:line):
  ov_open_callbacks 998 -> OggVorbisFile(file_or_bytes_or_path)
  ov_read/ov_read_float 2252/2271 -> read / read_float
  ov_pcm_seek/_page 1680/1409 -> pcm_seek / pcm_seek_page
  ov_raw_seek 1238 -> raw_seek;  ov_time_seek 1780 -> time_seek
  ov_bitrate 1105 / ov_bitrate_instant 1152 -> bitrate / bitrate_instant
  ov_crosslap 2413 -> crosslap;  ov_halfrate 1030 -> halfrate

Error taxonomy (reference include/vorbis/codec.h:221-235): hard
failures raise typed OVError subclasses; recoverable stream damage is
OV_HOLE semantics — the decoder resynchronizes, `hole_count` ticks up,
and only the codec's own validation errors are swallowed (anything
else propagates as a real bug).

Copy of vorbis_tpu/vorbisfile.py, kept line-aligned with it.  The port's
one difference is `device`, read as decode_ogg_fast reads it
(models/fastdec.py `_device`): `OggVorbisFile(src, device="cuda")` and
`decode_file(src, device="cuda")` decode on the card by default and
raise without one.  The chunked reads (read_float, read, the seeks,
halfrate) run FastStreamDecoder's staged chunk there, and
read_all_float's whole-link drain runs FastDecoder.decode_packets on the
device (csrc/imdct.cu and csrc/lap.cu; device="cpu" their plain
versions).  device=False is the JAX package's host path.  The scalar
Decoder stays for crosslap's lap tail and for the stream shapes the
fast path refuses (FastDecodeUnsupported), as in the JAX package.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

from .bitstream.oggfile import parse_page
from .codec import headers as H
from .codec.codebook import BadHeaderError
from .bitstream.bitpack import EndOfPacket
from .codec.decoder import BadPacketError, Decoder, NotAudioPacket


class OVError(Exception):
    """Base of the OV_* error taxonomy."""


class OVNotVorbisError(OVError):
    """OV_ENOTVORBIS: no recognizable Vorbis stream."""


class OVBadHeaderError(OVError):
    """OV_EBADHEADER: malformed header packets."""


class OVInvalidError(OVError):
    """OV_EINVAL: invalid argument/state (bad seek target etc.)."""


# codec-level exceptions that mean "damaged packet" (OV_HOLE /
# OV_EBADPACKET semantics: resync, don't crash).  Only the codec's own
# TYPED validation errors qualify — a bare ValueError/KeyError from
# inside the decoder is a genuine bug and propagates
_HOLE_ERRORS = (NotAudioPacket, BadPacketError, EndOfPacket,
                BadHeaderError)

_MAX_PAGE = 65307 + 282          # max Ogg page + header slack


class _Source:
    """Seekable byte source with page-capture primitives (the role of
    the reference's ov_callbacks + ogg_sync layer)."""

    CHUNK = 65536

    def __init__(self, src):
        if isinstance(src, (bytes, bytearray, memoryview)):
            self.f = io.BytesIO(bytes(src))
        elif hasattr(src, "read") and hasattr(src, "seek"):
            self.f = src
        elif isinstance(src, str):
            self.f = open(src, "rb")
        else:
            raise OVInvalidError("unsupported source type")
        self.f.seek(0, 2)
        self.size = self.f.tell()

    def read_at(self, off: int, n: int) -> bytes:
        if off >= self.size or n <= 0:
            return b""
        self.f.seek(off)
        return self.f.read(n)

    def capture_at(self, off: int, end: int | None = None):
        """Scan forward from byte `off` for the next valid page.
        Returns (page, page_off, next_off) or None.  `end` bounds the
        page START offset."""
        end = self.size if end is None else min(end, self.size)
        while off < end:
            win = self.read_at(off, self.CHUNK)
            idx = win.find(b"OggS")
            if idx < 0:
                if len(win) < self.CHUNK:
                    return None
                off += self.CHUNK - 3
                continue
            poff = off + idx
            if poff >= end:
                return None
            # ensure the whole page is in the parse window
            win2 = self.read_at(poff, _MAX_PAGE)
            try:
                res = parse_page(win2, 0)
            except ValueError:
                off = poff + 1
                continue
            if res is None:          # truncated at EOF
                off = poff + 1
                continue
            page, consumed = res
            return page, poff, poff + consumed
        return None

    def prev_page(self, before: int, begin: int = 0, serialno=None):
        """Last valid page starting before byte `before` (optionally
        restricted to serialno).  Returns (page, page_off, next_off)
        or None.  Mirrors the reference's _get_prev_page backward
        chunk scan."""
        hi = before
        step = self.CHUNK
        while hi > begin:
            lo = max(begin, hi - step)
            best = None
            off = lo
            while True:
                cap = self.capture_at(off, end=hi)
                if cap is None:
                    break
                page, poff, noff = cap
                if serialno is None or page.serialno == serialno:
                    best = (page, poff, noff)
                off = noff
                if off >= hi:
                    break
            if best is not None:
                return best
            hi = lo
            step = min(step * 2, 1 << 20)
        return None


@dataclass
class _Link:
    serialno: int
    vi: H.VorbisInfo = None
    vendor: str = ""
    comments: list = field(default_factory=list)
    begin: int = 0               # byte offset of the link's first page
    audio_begin: int = 0         # byte offset of the first audio page
    end: int = 0                 # byte offset past the link's last page
    pcm_start: int = 0           # absolute pcm offset of link start
    pcm_total: int = 0
    serials: tuple = ()          # all serialnos in the BOS group


def _parse_comment(packet: bytes):
    from .bitstream.bitpack import BitReader
    br = BitReader(packet)
    if br.read(8) != 3 or bytes(br.readbytes(6)) != b"vorbis":
        raise OVBadHeaderError("not a comment header")
    vlen = br.read(32)
    vendor = bytes(br.readbytes(vlen)).decode("utf-8", "replace")
    n = br.read(32)
    comments = []
    for _ in range(n):
        clen = br.read(32)
        comments.append(bytes(br.readbytes(clen)).decode("utf-8",
                                                         "replace"))
    return vendor, comments


class OggVorbisFile:
    """Pull-based decoder over an Ogg source (ov_open + ov_read* +
    ov_*_seek family).  Accepts bytes, a seekable binary file object,
    or a path."""

    def __init__(self, src, device="cuda"):
        from .models.fastdec import _device
        self._device = device
        self._dev = _device(device)   # None: the JAX package's host path
        self._src = _Source(src)
        self.links: list[_Link] = []
        self.hole_count = 0
        self.fast_fallbacks = 0      # scalar-path fallbacks (visible
        #                              speed cliff; see _read_all_batched)
        self._discover_links()
        if not self.links:
            raise OVNotVorbisError("no Vorbis stream found")
        self._cur_link = 0
        self._decoder = None
        self._pkt_iter = None
        self._pcm_offset = 0      # absolute (cross-link) next sample
        self._pending = None      # (ch, k) decoded not yet returned
        self._inst_bits = 0       # ov_bitrate_instant accounting
        self._inst_samples = 0
        self._open_link(0)

    # ---- chain discovery (reference: _bisect_forward_serialno) -------
    def _read_link_headers(self, begin: int):
        """Parse one link's BOS group + Vorbis headers starting at
        byte `begin`.  Returns a _Link (end fields unset) or None."""
        src = self._src
        # scan forward to the next BOS page (begin may sit inside the
        # previous link's final page after an inexact boundary)
        off = begin
        while True:
            cap = src.capture_at(off)
            if cap is None:
                return None
            if cap[0].bos:
                break
            off = cap[2]
        serials = []
        first_off = cap[1]
        off = first_off
        # collect the BOS group
        while True:
            cap = src.capture_at(off)
            if cap is None or not cap[0].bos:
                break
            serials.append(cap[0].serialno)
            off = cap[2]
        if not serials:
            return None
        # find the Vorbis stream among the group
        for sn in serials:
            try:
                pkts = []
                audio_begin = None
                for pk, _, _, _, noff in self._raw_packets(
                        first_off, sn, limit_packets=3):
                    pkts.append(pk)
                    audio_begin = noff
                    if len(pkts) == 3:
                        break
                if len(pkts) < 3:
                    continue
                vi = H.parse_headers(pkts)
                vendor, comments = _parse_comment(pkts[1])
                return _Link(serialno=sn, vi=vi, vendor=vendor,
                             comments=comments, begin=first_off,
                             audio_begin=audio_begin,
                             serials=tuple(serials))
            except (OVError, *_HOLE_ERRORS):
                continue
        return None

    def _discover_links(self):
        src = self._src
        begin = 0
        while begin < src.size:
            link = self._read_link_headers(begin)
            if link is None:
                break
            # does this link run to EOF?
            last = src.prev_page(src.size, begin=link.begin)
            if last is not None and last[0].serialno in link.serials:
                link.end = src.size
            else:
                # serialno bisection for the link boundary
                # (vorbisfile.c:474 _bisect_forward_serialno).  lo is
                # always the END offset of a PROVEN page of this link;
                # a capture from any mid above the link's true last
                # page either hits the next link or nothing, shrinking
                # hi, until lo converges to the last page's end.
                lo, hi = link.audio_begin, src.size
                while hi - lo > 1:
                    mid = (lo + hi) // 2
                    cap = src.capture_at(mid)
                    if (cap is not None
                            and cap[0].serialno in link.serials
                            and not cap[0].bos):
                        lo = cap[2]
                    else:
                        hi = mid
                cap = src.capture_at(lo)
                link.end = cap[1] if cap is not None else src.size
            # pcm_total from the last granulepos-bearing page of the
            # Vorbis serial
            lastv = src.prev_page(link.end, begin=link.begin,
                                  serialno=link.serialno)
            gp = 0
            while lastv is not None:
                g = lastv[0].granulepos
                if g is not None and g >= 0:
                    gp = g
                    break
                lastv = src.prev_page(lastv[1], begin=link.begin,
                                      serialno=link.serialno)
            link.pcm_total = int(gp)
            self.links.append(link)
            begin = link.end
        acc = 0
        for lk in self.links:
            lk.pcm_start = acc
            acc += lk.pcm_total

    # ---- packet extraction ------------------------------------------
    def _raw_packets(self, from_off: int, serialno: int,
                     end: int | None = None, limit_packets=None):
        """Yield (packet, granulepos_or_None, eos, page_off, next_off)
        assembling packets page by page from byte offsets.  Resyncs
        across damaged pages (hole accounting by the caller)."""
        src = self._src
        partial = bytearray()
        have_partial = False
        lastpageno = None
        off = from_off
        count = 0
        while True:
            cap = src.capture_at(off, end=end)
            if cap is None:
                return
            page, poff, off = cap
            if page.serialno != serialno:
                continue
            segs = page.segments
            i = 0
            if lastpageno is not None and page.pageno != lastpageno + 1:
                # page gap: OV_HOLE — drop any partial packet
                self.hole_count += 1
                partial = bytearray()
                have_partial = False
            lastpageno = page.pageno
            if page.continued and not have_partial:
                while i < len(segs) and len(segs[i]) == 255:
                    i += 1
                if i < len(segs):
                    i += 1
                partial = bytearray()
            cur = partial
            n_complete = sum(1 for s in segs[i:] if len(s) < 255)
            emitted = 0
            for j in range(i, len(segs)):
                cur += segs[j]
                if len(segs[j]) < 255:
                    emitted += 1
                    last = emitted == n_complete
                    yield (bytes(cur),
                           page.granulepos if last else None,
                           page.eos and last, poff, off)
                    count += 1
                    if limit_packets and count >= limit_packets:
                        return
                    cur = bytearray()
            partial = cur
            have_partial = len(partial) > 0 or (
                len(segs) > 0 and len(segs[-1]) == 255)

    def _link_packets(self, link: _Link, from_off=None):
        start = link.audio_begin if from_off is None else from_off
        for pk, gp, eos, poff, noff in self._raw_packets(
                start, link.serialno, end=link.end):
            yield pk, gp, eos, poff

    # ---- ov_info / ov_comment ----------------------------------------
    def info(self, link=-1) -> H.VorbisInfo:
        return self.links[self._cur_link if link < 0 else link].vi

    def comment(self, link=-1):
        lk = self.links[self._cur_link if link < 0 else link]
        return lk.vendor, lk.comments

    @property
    def nstreams(self):
        return len(self.links)

    @property
    def seekable(self):
        return True

    # ---- totals -------------------------------------------------------
    def pcm_total(self, link=-1) -> int:
        if link < 0:
            return sum(lk.pcm_total for lk in self.links)
        return self.links[link].pcm_total

    def time_total(self, link=-1) -> float:
        if link < 0:
            return sum(lk.pcm_total / lk.vi.rate for lk in self.links)
        lk = self.links[link]
        return lk.pcm_total / lk.vi.rate

    def raw_total(self, link=-1) -> int:
        if link < 0:
            return self._src.size
        lk = self.links[link]
        return lk.end - lk.begin

    # ---- bitrate (ov_bitrate / ov_bitrate_instant) -------------------
    def bitrate(self, link=-1) -> int:
        """Average bitrate of a link (or the whole file): compressed
        audio bytes over duration (vorbisfile.c:1105)."""
        if link < 0:
            t = self.time_total()
            if t <= 0:
                return 0
            raw = sum(lk.end - lk.audio_begin for lk in self.links)
            return int(8 * raw / t)
        lk = self.links[link]
        if lk.pcm_total <= 0:
            return 0
        return int(8 * (lk.end - lk.audio_begin)
                   / (lk.pcm_total / lk.vi.rate))

    def bitrate_instant(self) -> int:
        """Bits consumed per second of audio since the last call
        (vorbisfile.c:1152); 0 when nothing was decoded since."""
        if self._inst_samples <= 0:
            return 0
        rate = self.info().rate
        v = int(self._inst_bits * rate / self._inst_samples)
        self._inst_bits = 0
        self._inst_samples = 0
        return v

    # ---- decode state -------------------------------------------------
    def _open_link(self, link, from_off=None):
        lk = self.links[link]
        self._cur_link = link
        self._decoder = Decoder(lk.vi,
                                halfrate=bool(getattr(self, "_hs", 0)))
        self._pkt_iter = self._link_packets(lk, from_off)
        self._pending = None
        self._fast = self._make_fast(lk)

    def _make_fast(self, lk):
        """Chunked fast stream decoder for incremental reads (K
        packets per fused native call, lap/granulepos state carried —
        models/fastdec.py FastStreamDecoder); None -> the per-packet
        scalar path.  The heavy per-stream tables (FastDecoder) are
        cached on the link, so seeks re-enter at drain speed."""
        from .models.fastdec import (FastDecodeUnsupported,
                                     FastDecoder, FastStreamDecoder)
        try:
            fd = getattr(lk, "_fastdec", None)
            if fd is None:
                fd = FastDecoder(lk.vi)
                lk._fastdec = fd
            return FastStreamDecoder(fd, hs=getattr(self, "_hs", 0),
                                     device=self._device)
        except FastDecodeUnsupported:
            return None

    def _granulepos(self):
        """Granulepos of the active decode state (fast chunked or
        scalar), -1 until a label has been seen."""
        if getattr(self, "_fast", None) is not None:
            return self._fast.granulepos
        return self._decoder.granulepos

    def _lap_tail(self):
        """Lap tail for crosslap: when the chunked fast path is
        active, prime the scalar decoder's rolling buffer with the
        last processed packets first (the lap depends only on the
        final blocks; same trick as _read_all_batched)."""
        fast = getattr(self, "_fast", None)
        if fast is not None:
            for pk in fast.last_packets():
                try:
                    blk, Wb = self._decoder.synthesize(pk)
                    self._decoder.blockin(blk, Wb, None, False)
                except _HOLE_ERRORS:
                    pass
            self._decoder.pcm_returned = self._decoder.pcm_current
        return self._decoder.lapout()

    _FAST_K = 256            # packets per fused chunk once warmed

    def _decode_next_fast(self):
        """Chunked fast _decode_next: pull up to K packets, decode
        them in one fused native call.  The first post-(re)open chunk
        is small (seek latency), later chunks grow to _FAST_K (drain
        throughput)."""
        fast = self._fast
        while True:
            K = fast._K0
            fast._K0 = min(self._FAST_K, K * 4)
            batch = []
            for _ in range(K):
                try:
                    pk, gp, eos, _ = next(self._pkt_iter)
                except StopIteration:
                    break
                self._inst_bits += 8 * len(pk)
                batch.append((pk, gp, eos))
                if eos:
                    break
            if not batch:
                out = fast.flush()
                self.hole_count += fast.take_holes()
                if out.shape[1]:
                    self._inst_samples += out.shape[1]
                    return out
                if self._cur_link + 1 < len(self.links):
                    self._open_link(self._cur_link + 1)
                    fast = self._fast
                    if fast is None:
                        return self._decode_next()
                    continue
                return None
            out = fast.feed(batch)
            self.hole_count += fast.take_holes()
            if out.shape[1]:
                self._inst_samples += out.shape[1]
                return out

    def _decode_next(self):
        """Decode packets until PCM appears; returns (ch, k) or None at
        end of link/chain (advancing links automatically)."""
        if getattr(self, "_fast", None) is not None:
            return self._decode_next_fast()
        while True:
            try:
                pk, gp, eos, _ = next(self._pkt_iter)
            except StopIteration:
                if self._cur_link + 1 < len(self.links):
                    self._open_link(self._cur_link + 1)
                    continue
                return None
            try:
                out = self._decoder.decode_packet(pk, gp, eos)
            except _HOLE_ERRORS as e:
                if not isinstance(e, NotAudioPacket):
                    self.hole_count += 1   # damaged packet: OV_HOLE
                continue
            self._inst_bits += 8 * len(pk)
            if out is not None and out.shape[1]:
                self._inst_samples += out.shape[1]
                return out

    # ---- reads ---------------------------------------------------------
    def read_float(self, nsamples: int) -> np.ndarray:
        """ov_read_float: up to nsamples per channel as float32
        (ch, k); k == 0 at EOF.  Like the reference, returns what is
        conveniently available, never crossing a link boundary."""
        if self._pcm_offset is None:
            self._establish_position()
        if self._pending is not None and self._pending.shape[1]:
            chunk = self._pending
        else:
            chunk = self._decode_next()
            if chunk is None:
                return np.zeros((self.info().channels, 0), np.float32)
        k = min(nsamples, chunk.shape[1])
        out, self._pending = chunk[:, :k], chunk[:, k:]
        if self._pending.shape[1] == 0:
            self._pending = None
        # positions stay in full-rate units under halfrate
        self._pcm_offset += k << getattr(self, "_hs", 0)
        return out

    def read(self, nsamples: int, word: int = 2, signed: bool = True,
             bigendian: bool = False) -> np.ndarray:
        """ov_read (vorbisfile.c:2252): integer PCM output.  word=2 ->
        int16 (+-32768 scale), word=1 -> 8-bit; conversion mirrors
        vorbis_ftoi round-to-nearest + clamp."""
        f = self.read_float(nsamples)
        if word == 1:
            v = np.clip(np.rint(f.astype(np.float64) * 128.0),
                        -128, 127)
            if signed:
                return v.astype(np.int8)
            return (v + 128).astype(np.uint8)
        if word != 2:
            raise OVInvalidError("word size must be 1 or 2")
        v = np.clip(np.rint(f.astype(np.float64) * 32768.0),
                    -32768, 32767)
        if not signed:
            v = v + 32768
            dt = ">u2" if bigendian else "<u2"
        else:
            dt = ">i2" if bigendian else "<i2"
        return v.astype(dt)

    def read_all_float(self) -> np.ndarray:
        """Decode everything from the current position.  At a link
        start (no halfrate) the batched drain amortizes the whole
        pipeline across all packets of each link."""
        if self._pcm_offset is None:
            self._establish_position()
        at_start = (self._pcm_offset
                    == self.links[self._cur_link].pcm_start
                    and self._pending is None)
        if at_start and not getattr(self, "_hs", 0):
            return self._read_all_batched()
        out = []
        while True:
            c = self.read_float(1 << 20)
            if c.shape[1] == 0:
                break
            out.append(c)
        if not out:
            return np.zeros((self.info().channels, 0), np.float32)
        return np.concatenate(out, axis=1)

    def _read_all_batched(self) -> np.ndarray:
        from .ops.mdct import imdct
        out = []
        for li in range(self._cur_link, len(self.links)):
            self._open_link(li)
            link_pkts = [(pk, gp, eos)
                         for pk, gp, eos, _ in self._pkt_iter]
            self._inst_bits += sum(8 * len(p) for p, _, _ in link_pkts)
            # native whole-link fast drain (C packet parse + batched
            # synthesis, bit-exact); falls back to the per-packet path
            # for stream shapes it doesn't cover
            try:
                from .models.fastdec import (FastDecodeUnsupported,
                                             FastDecoder)
                fd = FastDecoder(self.links[li].vi)
                out.append(fd.decode_packets(link_pkts, device=self._dev))
                # prime the scalar decoder's lap state with the final
                # packets so lapout()/crosslap see the true stream-end
                # buffer (the lap depends only on the last blocks)
                for pk, gp, eos in link_pkts[-3:]:
                    try:
                        blk, Wb = self._decoder.synthesize(pk)
                        self._decoder.blockin(blk, Wb, gp, eos)
                    except _HOLE_ERRORS:
                        pass
                self._decoder.pcm_returned = self._decoder.pcm_current
                continue
            except FastDecodeUnsupported as e:
                # visible cliff: the scalar per-packet path is orders
                # of magnitude slower — count it and warn once
                import warnings
                self.fast_fallbacks += 1
                warnings.warn(
                    f"vorbis_tpu: falling back to the scalar decode "
                    f"path ({e})", RuntimeWarning, stacklevel=2)
            dec = self._decoder
            parsed = []            # (spec, W, gp, eos)
            for pk, gp, eos in link_pkts:
                try:
                    spec, W = dec.parse_packet(pk)
                except _HOLE_ERRORS as e:
                    if not isinstance(e, NotAudioPacket):
                        self.hole_count += 1
                    continue
                parsed.append([spec, W, gp, eos])
            # batch the IMDCT per blocksize group
            for W in (0, 1):
                idx = [k for k, p in enumerate(parsed) if p[1] == W]
                if not idx:
                    continue
                n = dec.bs[W]
                stack = np.stack([parsed[k][0] for k in idx])
                pcm = np.asarray(imdct(
                    stack.reshape(-1, n // 2), n)).reshape(
                        len(idx), -1, n)
                for j, k in enumerate(idx):
                    parsed[k][0] = pcm[j]
            for spec, W, gp, eos in parsed:
                got = dec.blockin(spec, W, gp, eos)
                if got is not None and got.shape[1]:
                    out.append(got)
        if not out:
            return np.zeros((self.info().channels, 0), np.float32)
        full = np.concatenate(out, axis=1)
        total = self.pcm_total()
        self._inst_samples += full.shape[1]
        self._pcm_offset = total
        self._pkt_iter = iter(())
        return full

    # ---- tells ---------------------------------------------------------
    def pcm_tell(self) -> int:
        if self._pcm_offset is None:
            self._establish_position()
        return self._pcm_offset

    def time_tell(self) -> float:
        lk = self.links[self._cur_link]
        rel = self.pcm_tell() - lk.pcm_start
        t = sum(l.pcm_total / l.vi.rate
                for l in self.links[:self._cur_link])
        return t + rel / lk.vi.rate

    # ---- seeking --------------------------------------------------------
    def raw_seek(self, byte_off: int):
        """ov_raw_seek: position at the page at/after byte_off inside
        its link and resynchronize; pcm position derives lazily from
        the next granulepos."""
        if not 0 <= byte_off <= self._src.size:
            raise OVInvalidError("raw_seek out of range")
        link = 0
        for li, lk in enumerate(self.links):
            if byte_off < lk.end or li == len(self.links) - 1:
                link = li
                break
        lk = self.links[link]
        off = max(byte_off, lk.audio_begin)
        self._seek_to_offset(link, off)

    def _seek_to_offset(self, link: int, byte_off: int):
        self._cur_link = link
        lk = self.links[link]
        self._decoder = Decoder(lk.vi,
                                halfrate=bool(getattr(self, "_hs", 0)))
        self._pkt_iter = self._link_packets(lk, byte_off)
        self._pending = None
        self._fast = self._make_fast(lk)
        # position resolves lazily from the next page granulepos
        # (reference re-derives it after any raw sync)
        self._pcm_offset = None

    def _establish_position(self):
        """Decode forward until the decoder learns its granulepos, then
        back-date the absolute offset of the buffered output."""
        if self._pcm_offset is not None:
            return
        lk = self.links[self._cur_link]
        chunks = []
        total = 0
        while self._granulepos() == -1:
            c = self._decode_next()
            if c is None:
                self._pcm_offset = lk.pcm_start + lk.pcm_total
                return
            chunks.append(c)
            total += c.shape[1] << getattr(self, "_hs", 0)
        frontier = lk.pcm_start + self._granulepos()
        self._pcm_offset = frontier - total
        if chunks:
            self._pending = np.concatenate(chunks, axis=1)

    def pcm_seek_page(self, pos: int):
        """ov_pcm_seek_page: byte-offset bisection by granulepos,
        landing on the page boundary at or before pos (absolute
        sample position across links)."""
        if not 0 <= pos <= self.pcm_total():
            raise OVInvalidError("seek out of range")
        link = 0
        for li, lk in enumerate(self.links):
            if pos < lk.pcm_start + lk.pcm_total or li == len(
                    self.links) - 1:
                link = li
                break
        lk = self.links[link]
        rel = pos - lk.pcm_start
        src = self._src
        lo, hi = lk.audio_begin, lk.end
        best = lk.audio_begin
        # bisection over byte offsets: find the last page whose
        # granulepos < rel (vorbisfile.c:1409-1679)
        while hi - lo > _Source.CHUNK // 16:
            mid = (lo + hi) // 2
            cap = src.capture_at(mid, end=hi)
            # find a granulepos-bearing page of our serial from mid
            gp = None
            while cap is not None:
                page, poff, noff = cap
                if (page.serialno == lk.serialno
                        and page.granulepos is not None
                        and page.granulepos >= 0):
                    gp = page.granulepos
                    break
                cap = src.capture_at(noff, end=hi)
            if cap is None:
                hi = mid
                continue
            if gp < rel:
                best = max(best, cap[1])
                lo = cap[2]
            else:
                hi = cap[1]
        self._seek_to_offset(link, best)

    def pcm_seek(self, pos: int):
        """ov_pcm_seek: page seek then packet-accurate skip forward
        (reference: vorbisfile.c:1680)."""
        self.pcm_seek_page(pos)
        self._establish_position()
        while self._pcm_offset < pos:
            if self._pending is not None and self._pending.shape[1]:
                chunk, self._pending = self._pending, None
            else:
                chunk = self._decode_next()
                if chunk is None:
                    break
            hs = getattr(self, "_hs", 0)
            k = chunk.shape[1] << hs
            if self._pcm_offset + k > pos:
                self._pending = chunk[:, (pos - self._pcm_offset) >> hs:]
                self._pcm_offset = pos
                return
            self._pcm_offset += k

    def time_seek(self, seconds: float):
        """ov_time_seek: map time to pcm across links then pcm_seek."""
        t = 0.0
        for lk in self.links:
            dur = lk.pcm_total / lk.vi.rate
            if seconds < t + dur:
                rel = int((seconds - t) * lk.vi.rate)
                return self.pcm_seek(lk.pcm_start + rel)
            t += dur
        return self.pcm_seek(self.pcm_total())

    # ---- crosslap -------------------------------------------------------
    def crosslap(self, other: "OggVorbisFile"):
        """ov_crosslap (vorbisfile.c:2413): window-splice this
        stream's lap tail into the start of `other`.  Reference
        semantics: n = min short-blocksize half of the two streams,
        the SHORT window of the smaller stream provides the crossfade
        (wd = w[i]^2; out = head*wd + tail*(1-wd)), and the splice
        lands on the first n not-yet-returned samples of `other`."""
        from .codec.decoder import window_half
        vi1, vi2 = self.info(), other.info()
        if vi1.channels != vi2.channels:
            raise OVInvalidError("channel mismatch")
        hs1 = getattr(self, "_hs", 0)
        hs2 = getattr(other, "_hs", 0)
        n1 = vi1.blocksizes[0] >> (1 + hs1)
        n2 = vi2.blocksizes[0] >> (1 + hs2)
        n = min(n1, n2)
        w = (window_half(vi1.blocksizes[0] >> hs1) if n1 <= n2
             else window_half(vi2.blocksizes[0] >> hs2))[:n]
        tail = self._lap_tail() if self._decoder is not None else None
        if tail is None:
            return
        lap = np.zeros((vi1.channels, n), np.float32)
        k = min(n, tail.shape[1])
        lap[:, :k] = tail[:, :k]
        # gather exactly n head samples from `other`
        heads = []
        got = 0
        while got < n:
            c = other.read_float(n - got)
            if c.shape[1] == 0:
                break
            heads.append(c)
            got += c.shape[1]
        head = (np.concatenate(heads, axis=1) if heads
                else np.zeros((vi2.channels, 0), np.float32))
        m = head.shape[1]
        wd = (w[:m] * w[:m]).astype(np.float32)
        spliced = (head * wd + lap[:, :m]
                   * (np.float32(1.0) - wd)).astype(np.float32)
        # put the spliced samples back in front of whatever decoded
        # PCM is still pending (the reference splices in place inside
        # the synthesis buffer, so nothing after the lap is dropped)
        left = other._pending
        if left is not None and left.shape[1]:
            spliced = np.concatenate([spliced, left], axis=1)
        other._pending = spliced
        other._pcm_offset -= m << hs2

    def halfrate(self, flag: bool):
        """ov_halfrate (vorbisfile.c:1030): decode at half the sample
        rate via half-size IMDCT/windows; pcm positions/totals remain
        in FULL-rate units, and the playback position is preserved
        across the decoder reinit."""
        if flag and min(lk.vi.blocksizes[0] for lk in self.links) <= 64:
            raise OVInvalidError("blocksize too small for halfrate")
        pos = self.pcm_tell()
        self._hs = 1 if flag else 0
        self._open_link(self._cur_link)
        lk = self.links[self._cur_link]
        self._pcm_offset = lk.pcm_start
        if pos != lk.pcm_start:
            self.pcm_seek(pos)

    def halfrate_p(self) -> bool:
        return bool(getattr(self, "_hs", 0))


# convenience mirroring ov_fopen + full drain
def decode_file(src, device="cuda"):
    """Decode an entire (possibly chained) stream: returns
    (pcm (ch, n) float32, OggVorbisFile)."""
    vf = OggVorbisFile(src, device=device)
    return vf.read_all_float(), vf
