"""Vorbis decoder: packet -> PCM.

This is the *reference-exact host path*: scalar/numpy synthesis whose
float operation order reproduces libvorbis decode bit-for-bit
(packet dispatch per lib/synthesis.c; mapping inverse per
lib/mapping0.c mapping0_inverse; lapped overlap-add and granulepos
bookkeeping per lib/block.c vorbis_synthesis_blockin/pcmout).

Copy of vorbis_tpu/codec/decoder.py, kept line-aligned with it: the
port's own host decoder, which reads back what the port encodes and
holds the fast decode (models/fastdec.py) bit for bit.  It decodes
floor1 and floor0 streams.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from ..bitstream.bitpack import BitReader, EndOfPacket, ilog
from ..ops.mdct import imdct
from . import headers as H
from .floor0_codec import Floor0Look, decode_floor0, floor0_curve
from .floor1_codec import Floor1Look, decode_floor1, floor1_curve
from .residue_codec import ResidueLook, decode_residue

_DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@lru_cache(maxsize=1)
def _windows():
    return dict(np.load(os.path.join(_DATA, "windows.npz")))


def window_half(n: int) -> np.ndarray:
    """Right half of the Vorbis window for block size n (transcribed
    literal tables; they differ from the analytic formula by ~1 ulp)."""
    return _windows()[f"vwin{n}"]


class NotAudioPacket(ValueError):
    pass


class BadPacketError(ValueError):
    """OV_EBADPACKET: structurally invalid audio packet (bad mode
    number etc.).  Typed so the vorbisfile hole handling can catch
    exactly the codec's own validation failures without swallowing
    genuine bugs that raise bare ValueError."""


class Decoder:
    """Stateful single-stream decoder mirroring the libvorbis dsp/block
    state machine."""

    def __init__(self, vi: H.VorbisInfo, halfrate: bool = False):
        self.vi = vi
        self.ch = vi.channels
        bs0, bs1 = vi.blocksizes
        self.bs = vi.blocksizes
        # halfrate decode (reference: vorbis_synthesis_halfrate,
        # synthesis.c:166 + the >>hs lapping in block.c): same bit
        # syntax, half-size IMDCT/windows, half-unit buffer positions,
        # full-rate granulepos accounting
        if halfrate and bs0 <= 64:
            raise ValueError("blocksize too small for halfrate "
                             "(synthesis.c:170)")
        self.hs = 1 if halfrate else 0
        self.modebits = ilog(len(vi.modes) - 1)
        self.floor_looks = [Floor1Look(f) if t == 1 else Floor0Look(f)
                            for t, f in zip(vi.floor_types, vi.floors)]
        self.residue_looks = [ResidueLook(res, vi.books)
                              for res in vi.residues]
        # blockin state
        n1 = bs1 // 2
        self.buf = np.zeros((self.ch, 2 * n1), dtype=np.float32)
        self.centerW = 0
        self.W = 0            # becomes lW on next blockin
        self.first = True
        self.pcm_returned = -1
        self.pcm_current = 0
        self.granulepos = -1
        self.sample_count = -1
        # bit-usage accounting (reference vorbis_block
        # glue/floor/res_bits, codec.h:112-115)
        self.bit_stats = {"packets": 0, "glue_bits": 0,
                          "floor_bits": 0, "res_bits": 0}

    # ---- packet-level synthesis ----------------------------------------
    def synthesize(self, packet: bytes):
        """Decode one audio packet to its raw n-point block (ch, n)
        float32 plus (W, mode).  Raises NotAudioPacket for non-audio."""
        spec, W = self._synthesize_spectrum(packet)
        n = self.bs[W]
        if self.hs:
            # half-size transform reads the first n/4 bins
            nh = n >> self.hs
            pcm = np.asarray(imdct(spec[:, :nh // 2], nh))
        else:
            pcm = np.asarray(imdct(spec, n))
        return pcm, W

    def _synthesize_spectrum(self, packet: bytes):
        vi = self.vi
        r = BitReader(packet)
        if r.read1() != 0:
            raise NotAudioPacket
        mode = r.read(self.modebits)
        if mode >= len(vi.modes):
            raise BadPacketError("bad packet mode (OV_EBADPACKET)")
        minfo = vi.modes[mode]
        W = minfo.blockflag
        if W:
            r.read1()  # lW window hint (decode uses actual history)
            r.read1()  # nW
        n = self.bs[W]
        mapping = vi.maps[minfo.mapping]
        spec = np.zeros((self.ch, n // 2), dtype=np.float32)
        glue_end = r.pos

        # floors
        floor_fits = []
        nonzero = np.zeros(self.ch, dtype=bool)
        for c in range(self.ch):
            submap = mapping.chmuxlist[c]
            fl_idx = mapping.floorsubmap[submap]
            look = self.floor_looks[fl_idx]
            if vi.floor_types[fl_idx] == 0:
                fit = decode_floor0(r, look, vi.books)
            else:
                fit = decode_floor1(r, look, vi.books)
            floor_fits.append(fit)
            nonzero[c] = fit is not None

        floor_end = r.pos

        # coupling dirties nonzero
        for m, a in zip(mapping.coupling_mag, mapping.coupling_ang):
            if nonzero[m] or nonzero[a]:
                nonzero[m] = True
                nonzero[a] = True

        # residue per submap
        for s in range(mapping.submaps):
            chans = [c for c in range(self.ch) if mapping.chmuxlist[c] == s]
            res_idx = mapping.residuesubmap[s]
            bundle = spec[chans]
            decode_residue(r, self.residue_looks[res_idx], bundle,
                           ~nonzero[chans], n // 2,
                           vi.residue_types[res_idx])
            spec[chans] = bundle

        st = self.bit_stats
        st["packets"] += 1
        st["glue_bits"] += glue_end
        st["floor_bits"] += floor_end - glue_end
        st["res_bits"] += r.pos - floor_end

        # inverse coupling (reverse order)
        for m, a in zip(reversed(mapping.coupling_mag),
                        reversed(mapping.coupling_ang)):
            mag = spec[m]
            ang = spec[a]
            new_m = np.where(
                mag > 0,
                np.where(ang > 0, mag, mag + ang),
                np.where(ang > 0, mag, mag - ang))
            new_a = np.where(
                mag > 0,
                np.where(ang > 0, mag - ang, mag),
                np.where(ang > 0, mag + ang, mag))
            spec[m] = new_m
            spec[a] = new_a

        # floor multiply
        for c in range(self.ch):
            if floor_fits[c] is not None:
                submap = mapping.chmuxlist[c]
                fl_idx = mapping.floorsubmap[submap]
                look = self.floor_looks[fl_idx]
                if vi.floor_types[fl_idx] == 0:
                    curve = floor0_curve(floor_fits[c], look, n // 2)
                else:
                    curve = floor1_curve(floor_fits[c], look, n // 2)
                spec[c] = (spec[c] * curve).astype(np.float32)
            else:
                spec[c] = 0.0

        return spec, W

    def parse_packet(self, packet: bytes):
        """synthesize minus the IMDCT: decode one packet to its
        spectral-domain block (ch, n/2) plus W.  Lets callers batch the
        transform across many packets (decode_ogg's batched path)."""
        return self._synthesize_spectrum(packet)

    # ---- lapped overlap-add state machine --------------------------------
    def blockin(self, block: np.ndarray, W: int, granulepos: int,
                eos: bool) -> np.ndarray:
        """Feed one decoded block; returns newly available PCM (ch, k)."""
        hs = self.hs
        bs0, bs1 = self.bs[0] >> hs, self.bs[1] >> hs
        n = (self.bs[W] >> hs) // 2
        n0, n1 = bs0 // 2, bs1 // 2
        lW = self.W
        self.W = W
        buf = self.buf

        if self.centerW:
            thisCenter, prevCenter = n1, 0
        else:
            thisCenter, prevCenter = 0, n1

        w_long = window_half(bs1)
        w_short = window_half(bs0)
        for c in range(self.ch):
            p = block[c]
            if lW:
                if W:  # long/long
                    w = w_long
                    seg = buf[c, prevCenter:prevCenter + n1]
                    buf[c, prevCenter:prevCenter + n1] = (
                        seg * w[::-1] + p[:n1] * w)
                else:  # long/small
                    w = w_short
                    o = prevCenter + n1 // 2 - n0 // 2
                    seg = buf[c, o:o + n0]
                    buf[c, o:o + n0] = seg * w[::-1] + p[:n0] * w
            else:
                if W:  # small/large
                    w = w_short
                    off = n1 // 2 - n0 // 2
                    seg = buf[c, prevCenter:prevCenter + n0]
                    buf[c, prevCenter:prevCenter + n0] = (
                        seg * w[::-1] + p[off:off + n0] * w)
                    buf[c, prevCenter + n0:prevCenter + n1 // 2 + n0 // 2] = \
                        p[off + n0:off + n1 // 2 + n0 // 2]
                else:  # small/small
                    w = w_short
                    seg = buf[c, prevCenter:prevCenter + n0]
                    buf[c, prevCenter:prevCenter + n0] = (
                        seg * w[::-1] + p[:n0] * w)
            # copy second half for next overlap
            buf[c, thisCenter:thisCenter + n] = block[c, n:2 * n]

        self.centerW = 0 if self.centerW else n1

        if self.pcm_returned == -1:
            self.pcm_returned = thisCenter
            self.pcm_current = thisCenter
        else:
            self.pcm_returned = prevCenter
            self.pcm_current = prevCenter + (
                (self.bs[lW] // 4 + self.bs[W] // 4) >> hs)

        # granulepos tracking / end trimming (reference block.c:1023-1157)
        # sample_count/granulepos stay in FULL-rate units; buffer
        # positions are half units under halfrate (the >>hs, mirroring
        # block.c:1062/1115/1150)
        if self.sample_count == -1:
            self.sample_count = 0
        else:
            self.sample_count += self.bs[lW] // 4 + self.bs[W] // 4

        vgp = granulepos if granulepos is not None else -1
        if self.granulepos == -1:
            if vgp != -1:
                self.granulepos = vgp
                if self.sample_count > vgp:
                    extra = self.sample_count - vgp
                    extra = max(0, extra) >> hs
                    if eos:
                        extra = min(extra,
                                    self.pcm_current - self.pcm_returned)
                        self.pcm_current -= extra
                    else:
                        self.pcm_returned = min(self.pcm_returned + extra,
                                                self.pcm_current)
        else:
            self.granulepos += self.bs[lW] // 4 + self.bs[W] // 4
            if vgp != -1 and self.granulepos != vgp:
                if self.granulepos > vgp:
                    extra = (self.granulepos - vgp) >> hs
                    if extra and eos:
                        extra = min(extra,
                                    self.pcm_current - self.pcm_returned)
                        extra = max(0, extra)
                        self.pcm_current -= extra
                self.granulepos = vgp

        out = buf[:, self.pcm_returned:self.pcm_current].copy()
        self.pcm_returned = self.pcm_current
        return out

    def lapout(self) -> np.ndarray:
        """Pending lap tail beyond the returned PCM (reference:
        vorbis_synthesis_lapout, block.c:1193): the half-window of
        buffered, not-yet-finalized samples used for crosslap splicing.
        Returns (ch, k) with k <= blocksizes[1]//2 (unwindowed tail)."""
        k = (self.bs[self.W] >> self.hs) // 2
        lo = self.pcm_returned if self.pcm_returned >= 0 else 0
        return self.buf[:, lo:lo + k].copy()

    def decode_packet(self, packet: bytes, granulepos=None,
                      eos: bool = False) -> np.ndarray:
        """One-call packet -> newly available PCM (ch, k)."""
        pcm, W = self.synthesize(packet)
        return self.blockin(pcm, W, granulepos, eos)


def decode_ogg(data: bytes) -> tuple[np.ndarray, H.VorbisInfo]:
    """Decode a complete single-stream Ogg Vorbis byte stream."""
    from ..bitstream.oggfile import OggStreamReader
    rd = OggStreamReader(data)
    pkts = list(rd.packets())
    vi = H.parse_headers([p for p, _, _ in pkts[:3]])
    dec = Decoder(vi)
    out = []
    for packet, gp, eos in pkts[3:]:
        try:
            out.append(dec.decode_packet(packet, gp, eos))
        except NotAudioPacket:
            continue
    pcm = (np.concatenate(out, axis=1) if out
           else np.zeros((vi.channels, 0), np.float32))
    return pcm, vi
