"""High-throughput batched decoder: native packet parse + vectorized
synthesis.

This is the decode mirror of models/fastenc.py.  The serial half
(Huffman bit I/O for floors and residues of every packet) runs in ONE
native C call (csrc/host_decode.c vn_parse_packets); everything
numeric — floor curve render, inverse coupling, floor multiply, IMDCT,
and the lapped overlap-add — runs vectorized across all packets of the
stream at once.  Output is bit-exact with the scalar Decoder (and the
reference libvorbis): every float op preserves the reference's
per-sample operation order (reference decode chain: lib/mapping0.c
mapping0_inverse -> lib/floor1.c floor1_inverse2 -> lib/mdct.c
mdct_backward -> lib/block.c vorbis_synthesis_blockin).

Design note (lapping): vorbis_synthesis_blockin's 4-case overlap-add is
equivalent to multiplying each raw IMDCT block by its hybrid window
(zeros / rise / flat-1 / fall / zeros, ops/window.py) and scatter-adding
the blocks at their center-aligned offsets (consecutive centers advance
by n_lW/4 + n_W/4).  Flat regions multiply by exactly 1.0f and overlap
regions see the identical (prev*w_rev + cur*w) multiply-add, so the
composition is bitwise identical.

Copy of vorbis_tpu/models/fastdec.py (`_win_table`,
`FastDecodeUnsupported`, `FastDecoder`, `_decoder_for`, `decode_ogg_fast`,
`_decode_batch_device`, `decode_ogg_fast_batch`), kept line-aligned with
it where the text is the same.  The port's differences:
- the host C is the port's own (csrc/host_decode.c through native.py and
  codec/nativeparse.py), with no numpy fall-back for the IMDCT or the
  lap;
- the device stage is two hand-written CUDA kernels on a CUDA device,
  their plain PyTorch versions on the CPU (`_decode_jobs`): one H2D copy
  of every stream's spectra, one IMDCT launch a blocksize for the whole
  batch (ops/imdct_cuda.py, csrc/imdct.cu, rows read through a row
  table), one launch of the windowed lap with the granulepos trim
  (ops/lap_cuda.py, csrc/lap.cu), and a D2H copy of each stream's
  trimmed (ch, N) PCM into pinned memory;
- the entry points run on the card unless the caller asks otherwise:
  device="cuda" (the default, or True, or a CUDA torch.device) runs the
  IMDCT and the lap on the card and raises without one; device="cpu"
  runs the same staged path with the plain versions on the CPU;
  device=False is the fused host-C drain (vn_decode_stream), the JAX
  package's default;
- `FastStreamDecoder` (the chunked decode of vorbisfile.py) takes the
  same `device`: its staged chunk (`_synth_device`) runs one IMDCT launch
  a blocksize and one lap launch a chunk, full rate and halfrate, with
  the previous chunk's lap tail kept on the device as the next lap's
  initial values;
- `_render_curves` (which nothing calls) stays behind.
"""

from __future__ import annotations

import time
from functools import lru_cache

import numpy as np
import torch

from ..codec import headers as H
from ..codec.floor1_codec import fromdB_lookup
from ..codec.nativeparse import (StreamParseTables, decode_stream,
                                 parse_packet_arrays, parse_packets, scan_W)
from ..native import decode_library, imdct_batch, ogg_scan
from ..ops.imdct_cuda import imdct
from ..ops.lap_cuda import LapPlan, lap
from ..ops.window import hybrid_window

_WIN_CACHE = {}


def _win_table(bs0, bs1):
    """Concatenated hybrid windows for all 8 (lW, W, nW) ids plus the
    per-id offsets (the vn_decode_stream window table)."""
    key = (bs0, bs1)
    if key not in _WIN_CACHE:
        wins, offs = [], []
        acc = 0
        for wid in range(8):
            l, w, nx = (wid >> 2) & 1, (wid >> 1) & 1, wid & 1
            arr = hybrid_window(bs0, bs1, l, w, nx)
            offs.append(acc)
            wins.append(arr)
            acc += len(arr)
        _WIN_CACHE[key] = (
            np.ascontiguousarray(np.concatenate(wins), np.float32),
            np.asarray(offs, np.int64))
    return _WIN_CACHE[key]


class FastDecodeUnsupported(Exception):
    """Stream shape the native path doesn't cover (floor type 0 or a
    missing native lib; multi-submap mappings like 5.1 ARE supported)
    — caller falls back to the scalar Decoder."""


class FastDecoder:
    """Whole-stream batched decoder for one VorbisInfo."""

    def __init__(self, vi: H.VorbisInfo):
        self.vi = vi
        self.tables = StreamParseTables(vi)
        if not self.tables.ok:
            raise FastDecodeUnsupported(
                f"stream not native-decodable: {self.tables.why}")
        self.fromdB = fromdB_lookup()

    @staticmethod
    def _native_lap(groups, gidx, W, lW, nW, offs, wins, out, bs0, bs1):
        """Drive vn_lap_add (the per-sample multiply/add order of the
        JAX package's numpy lap)."""
        import ctypes as C

        L = decode_library()
        npkt = len(W)
        ch, outlen = out.shape
        blocksL = groups.get(1)
        blocksS = groups.get(0)
        zero = np.zeros(1, np.float32)
        keys = sorted(wins.keys())
        wcat = np.ascontiguousarray(
            np.concatenate([wins[k] for k in keys]).astype(np.float32))
        woff = {}
        acc = 0
        for k in keys:
            woff[k] = acc
            acc += len(wins[k])
        win_off = np.asarray(
            [woff[(int(a), int(b), int(c))]
             for a, b, c in zip(lW, W, nW)], np.int64)
        winid = np.arange(npkt, dtype=np.int32)   # one entry per packet
        # vn_lap_add indexes win_off by winid; give it identity ids
        which = W.astype(np.int32)
        offs64 = offs.astype(np.int64)

        def ptr(a):
            return C.c_void_p(a.ctypes.data if a is not None else None)

        L.vn_lap_add(
            ptr(blocksL if blocksL is not None else zero),
            ptr(blocksS if blocksS is not None else zero),
            C.c_int(ch), C.c_int(bs1), C.c_int(bs0), C.c_long(npkt),
            ptr(which), ptr(np.ascontiguousarray(gidx)),
            ptr(winid), ptr(offs64),
            ptr(wcat), ptr(np.ascontiguousarray(win_off)),
            ptr(out), C.c_long(outlen))

    def _lap_and_trim(self, W, groups, gidx, gps, eoss):
        """Windowed scatter-add lapping + granulepos trim from the
        per-group IMDCT blocks of the host C (vn_lap_add)."""
        vi = self.vi
        ch = vi.channels
        bs0, bs1 = vi.blocksizes
        npkt = len(W)
        lW = np.concatenate([[0], W[:-1]])
        nW = np.concatenate([W[1:], [W[-1]]])
        ns = np.where(W == 1, bs1, bs0).astype(np.int64)
        adv = np.zeros(npkt, np.int64)          # center advance
        adv[1:] = ns[:-1] // 4 + ns[1:] // 4
        centers = np.cumsum(adv)
        starts = centers - ns // 2
        base = starts.min()
        total_len = int(max(centers[-1] + ns[-1] // 2,
                            (starts + ns).max()) - base)
        out = np.zeros((ch, total_len + 8), np.float32)
        wins = {}
        for key in {(int(a), int(b), int(c))
                    for a, b, c in zip(lW, W, nW)}:
            l, w, nx = key
            wins[key] = hybrid_window(bs0, bs1, l, w, nx)
        self._native_lap(groups, gidx, W, lW, nW, starts - base,
                         wins, out, bs0, bs1)
        gp_arr = np.asarray([-1 if g is None else int(g)
                             for g in gps], np.int64)
        eos_arr = np.asarray(eoss, bool)
        lo, hi = self._trim_range(centers, base, gp_arr, eos_arr)
        return out[:, lo:hi]

    def decode_packets(self, pkts, device=None) -> np.ndarray:
        """pkts: list of (packet_bytes, granulepos_or_None, eos).
        Returns (ch, N) float32 PCM, trimmed exactly like the scalar
        blockin/granulepos state machine.  device=None runs the IMDCT and
        the lap in the host C; a torch.device runs them there, as the
        entry points do (_decode_jobs)."""
        vi = self.vi
        ch = vi.channels
        bs0, bs1 = vi.blocksizes
        packets = [p for p, _, _ in pkts]
        if not packets:
            return np.zeros((ch, 0), np.float32)
        W, mode, posts, nonzero, res = parse_packets(self.tables, packets)
        ok = W >= 0
        if not ok.all():
            raise FastDecodeUnsupported("bad packet in stream")
        gps = [g for _, g, _ in pkts]
        eoss = [e for _, _, e in pkts]
        npkt = len(packets)

        # inverse coupling AND floor render+multiply already happened
        # inside the native parse (mapping0_inverse order: residue ->
        # coupling -> floor1_inverse2); `res` IS the final spectrum
        spec = res            # (npkt, ch, n2max) float32

        # ---- on a device: the batch path's kernels (or their plain
        # versions) ----
        if device is not None:
            return _decode_jobs([(self, W, spec, gps, eoss)], device)[0][0]

        # ---- IMDCT per W group (host C bit-exact kernel) ----
        groups = {}          # Wv -> (blocks (G, ch, n), group idx)
        gidx = np.zeros(npkt, np.int32)
        for Wv in (0, 1):
            idx = np.where(W == Wv)[0]
            if not len(idx):
                continue
            n = bs1 if Wv else bs0
            stack = np.ascontiguousarray(
                spec[idx][:, :, :n // 2].reshape(-1, n // 2))
            blocks = imdct_batch(stack, n)
            blocks = np.ascontiguousarray(
                blocks.reshape(len(idx), ch, n))
            groups[Wv] = blocks
            gidx[idx] = np.arange(len(idx), dtype=np.int32)

        return self._lap_and_trim(W, groups, gidx, gps, eoss)

    @staticmethod
    def _trim_range(centers, base, gps, eoss):
        """Vectorized granulepos walk (same semantics as the scalar
        blockin/granulepos state machine): the first label sets the
        start trim (or end cut at eos), every later label's expected-
        vs-actual overshoot cuts the tail only at eos — run_gp resets
        at each label, so consecutive label pairs decide
        independently."""
        first_out = int(centers[0] - base)      # center of block 0
        last_out = int(centers[-1] - base)      # center of last block
        start_trim = 0
        end_cut = 0
        lbl = np.flatnonzero(gps >= 0)
        if len(lbl):
            k = int(lbl[0])
            g0 = int(gps[k])
            sc = int(centers[k] - centers[0])
            if sc > g0:
                if eoss[k]:
                    end_cut = sc - g0
                else:
                    start_trim = sc - g0
            if len(lbl) > 1:
                run = gps[lbl[:-1]] + (centers[lbl[1:]]
                                       - centers[lbl[:-1]])
                over = run - gps[lbl[1:]]
                m = (over > 0) & eoss[lbl[1:]]
                if m.any():
                    end_cut = max(end_cut, int(over[m].max()))
        lo = first_out + start_trim
        hi = max(lo, last_out - end_cut)
        return lo, hi

    def decode_arrays(self, blob, off, lens, gps, eoss,
                      CH=128) -> np.ndarray:
        """Fused native whole-stream decode from dense packet arrays
        (the vn_ogg_scan output form): ONE native call runs Huffman
        parse, residue accumulate, inverse coupling, floor render,
        IMDCT and the windowed lapped overlap-add, chunked CH packets
        at a time so every intermediate stays cache-resident.
        Bit-exact with decode_packets (same expression trees; see
        vn_imdct16_rows on scatter-add order)."""
        vi = self.vi
        ch = vi.channels
        bs0, bs1 = vi.blocksizes
        npkt = len(off)
        if npkt == 0:
            return np.zeros((ch, 0), np.float32)
        bits = lens * 8
        W = scan_W(self.tables, blob, off, bits)
        if (W < 0).any():
            raise FastDecodeUnsupported("bad packet in stream")
        ns = np.where(W == 1, bs1, bs0).astype(np.int64)
        adv = np.zeros(npkt, np.int64)
        adv[1:] = ns[:-1] // 4 + ns[1:] // 4
        centers = np.cumsum(adv)
        starts = centers - ns // 2
        base = starts.min()
        # every block's full span (a long block just before a short
        # final block overhangs centers[-1] + ns[-1]//2)
        total_len = int(max(centers[-1] + ns[-1] // 2,
                            (starts + ns).max()) - base)
        lW = np.concatenate([[0], W[:-1]])
        nW = np.concatenate([W[1:], [W[-1]]])
        winid = (lW * 4 + W * 2 + nW).astype(np.int32)
        wins, win_off = _win_table(bs0, bs1)
        out = np.zeros((ch, total_len + 8), np.float32)
        decode_stream(self.tables, blob, off, bits,
                      np.ascontiguousarray(starts - base),
                      np.ascontiguousarray(winid), wins, win_off,
                      out, W, CH=CH)
        lo, hi = self._trim_range(centers, base,
                                  np.asarray(gps, np.int64),
                                  np.asarray(eoss, bool))
        return out[:, lo:hi]


class FastStreamDecoder:
    """Stateful CHUNKED fast decode: K packets per native call with the
    lap tail + granulepos state carried across calls — the incremental
    mirror of FastDecoder.decode_arrays, serving `ov_read`-style
    streaming reads, post-seek reads, and halfrate at drain speed
    (reference: the rolling synthesis buffer in
    lib/block.c:1023-1157 vorbis_synthesis_blockin + the read loop in
    lib/vorbisfile.c:1680-1779,2252).

    Each feed() decodes its packets through ONE fused native call
    (vn_decode_stream: Huffman parse, residue, coupling, floor render,
    IMDCT, windowed lap) into a buffer pre-initialized with the
    previous chunk's windowed lap tail; the scatter-add is linear, so
    chunked accumulation is bitwise-identical to the whole-stream
    drain.  The LAST packet of every feed is held back until the next
    call reveals its successor's block flag (the right-half window of
    block k needs nW = W[k+1]); EOS packets flush immediately.

    halfrate (hs=1) runs the staged variant: native packet parse
    (vn_parse_packets) + batched half-size IMDCT + numpy windowed
    scatter-add with half-unit geometry — same math as the scalar
    halfrate Decoder, batched.

    Granulepos semantics mirror the scalar blockin exactly: the first
    label sets the position (start-trim / eos end-cut within the
    current window), later labels only cut at EOS; damaged packets
    (scan_W < 0 with an audio-type first byte) are dropped and counted
    in `holes` — non-audio packets are dropped silently, like the
    scalar loop's NotAudioPacket skip.

    The port adds `device`, as decode_ogg_fast reads it: "cuda" (the
    default, or True, or a CUDA torch.device) and "cpu" run every chunk,
    full rate and halfrate, through the staged device chunk
    (`_synth_device`: csrc/imdct.cu and csrc/lap.cu on a card, their
    plain versions on the CPU); device=False is the JAX package's
    chunk above (vn_decode_stream, or _synth_staged under halfrate)."""

    def __init__(self, dec: FastDecoder, hs: int = 0, device="cuda"):
        vi = dec.vi
        if hs and vi.blocksizes[0] <= 64:
            raise FastDecodeUnsupported("blocksize too small for "
                                        "halfrate")
        self.device = _device(device)
        self._tail = None             # device: the lap tail, on it
        self._pinned = {}             # device: staging buffers, by name
        self.dec = dec
        self.vi = vi
        self.ch = vi.channels
        self.bs = vi.blocksizes
        self.hs = hs
        # carry state
        self.prev_W = -1              # W of last processed packet
        self.tail = np.zeros((self.ch, 0), np.float32)
        self.pend = None              # held-back (bytes, gp, eos)
        self.granulepos = -1
        self.sample_count = -1
        self.holes = 0                # damaged packets dropped
        self._K0 = 32                 # first-feed parse size (grows)
        self._last = []               # last <=3 processed packets
        self._flushed = False

    def take_holes(self) -> int:
        h, self.holes = self.holes, 0
        return h

    def last_packets(self):
        """Raw bytes of the last <=3 processed packets (for priming a
        scalar Decoder's lap state, e.g. crosslap)."""
        return list(self._last)

    def feed(self, pkts) -> np.ndarray:
        """pkts: list of (packet_bytes, granulepos_or_None, eos).
        Returns newly final PCM (ch, k) — empty until enough packets
        have arrived."""
        allp = ([self.pend] if self.pend is not None else []) + \
            list(pkts)
        self.pend = None
        if not allp:
            return np.zeros((self.ch, 0), np.float32)
        if allp[-1][2]:               # eos: no holdback, nW=W (same
            return self._process(allp, None)   # as the whole-stream drain)
        if len(allp) == 1:
            self.pend = allp[0]
            return np.zeros((self.ch, 0), np.float32)
        self.pend = allp[-1]
        # successor W of the last processed packet, from the held-back
        # packet (so every right-half window is the true one)
        nW_last = self._scan_one_W(self.pend[0])
        return self._process(allp[:-1], nW_last)

    def flush(self) -> np.ndarray:
        """End of packet stream without an EOS flag (truncated
        stream): process the held-back packet with nW = its own W."""
        if self.pend is None:
            return np.zeros((self.ch, 0), np.float32)
        p, self.pend = self.pend, None
        return self._process([p], None)

    # ---- internals ---------------------------------------------------
    def _scan_one_W(self, pk: bytes):
        from ..codec.nativeparse import scan_W
        blob = np.frombuffer(pk + b"\x00" * 8, np.uint8)
        w = scan_W(self.dec.tables, blob, np.zeros(1, np.int64),
                   np.asarray([len(pk) * 8], np.int64))
        return int(w[0])

    def _process(self, pkts, nW_last):
        from ..codec.nativeparse import scan_W
        ch, hs = self.ch, self.hs
        bs0, bs1 = self.bs
        sizes = np.asarray([len(p) for p, _, _ in pkts], np.int64)
        off = np.zeros(len(pkts), np.int64)
        np.cumsum(sizes[:-1], out=off[1:])
        blob = np.frombuffer(
            b"".join(p for p, _, _ in pkts) + b"\x00" * 8, np.uint8)
        W = scan_W(self.dec.tables, blob, off, sizes * 8)
        good = W >= 0
        if not good.all():
            for i in np.flatnonzero(~good):
                if not (pkts[i][0][:1] and pkts[i][0][0] & 1):
                    self.holes += 1   # audio-type packet, bad syntax
            keep = np.flatnonzero(good)
            if not len(keep):
                return np.zeros((ch, 0), np.float32)
            pkts = [pkts[i] for i in keep]
            sizes, off, W = sizes[keep], off[keep], W[keep]
        m = len(pkts)
        self._last = ([p for p, _, _ in pkts[-3:]]
                      if m >= 3 else (self._last
                                      + [p for p, _, _ in pkts])[-3:])

        # local geometry, in half units under halfrate
        ns = np.where(W == 1, bs1, bs0).astype(np.int64)
        lW = np.concatenate([[max(self.prev_W, 0)], W[:-1]])
        advf = ns // 4 + np.where(lW == 1, bs1, bs0) // 4  # full-rate
        adv = advf >> hs
        first_ever = self.prev_W < 0
        fg = bs1 >> hs                # front guard (window reach-back)
        if first_ever:
            cum = np.concatenate([[0], np.cumsum(adv[1:])])
            centers = fg + (ns[0] >> (1 + hs)) + cum
        else:
            centers = fg + np.cumsum(adv)
        starts = centers - (ns >> (1 + hs))
        assert starts.min() >= 0, starts.min()
        # cover every block's full span: a long block right before a
        # short final block overhangs the last center + half block
        outlen = int(max(centers[-1] + (ns[-1] >> (1 + hs)),
                         (starts + (ns >> hs)).max())) + 8
        out = (np.zeros((ch, outlen), np.float32) if self.device is None
               else None)
        tl = self.tail.shape[1]
        if tl:
            out[:, fg:fg + tl] = self.tail
        nWv = np.concatenate([W[1:], [W[-1] if nW_last is None
                                      or nW_last < 0 else nW_last]])
        winid = (lW * 4 + W * 2 + nWv).astype(np.int32)
        if self.device is not None:
            out = self._synth_device(blob, off, sizes * 8, W, winid,
                                     starts, centers, first_ever)
        elif hs:
            self._synth_staged(blob, off, sizes * 8, W, lW, nWv,
                               starts, out)
        else:
            from ..codec.nativeparse import decode_stream
            wins, win_off = _win_table(bs0, bs1)
            decode_stream(self.dec.tables, blob, off, sizes * 8,
                          np.ascontiguousarray(starts),
                          np.ascontiguousarray(winid), wins, win_off,
                          out, np.ascontiguousarray(W))

        # ---- granulepos walk (scalar blockin semantics) ----
        emit_from = int(centers[0]) if first_ever else fg
        emit_to = int(centers[-1])
        cuts = []
        win_lo = emit_from            # current window start
        for i in range(m):
            cur = int(centers[i])
            if self.sample_count < 0:
                self.sample_count = 0
            else:
                self.sample_count += int(advf[i])
            gp_i, eos_i = pkts[i][1], pkts[i][2]
            vgp = -1 if gp_i is None else int(gp_i)
            if self.granulepos == -1:
                if vgp != -1:
                    self.granulepos = vgp
                    if self.sample_count > vgp:
                        extra = (self.sample_count - vgp) >> hs
                        extra = min(extra, cur - win_lo)
                        if eos_i:
                            cuts.append((cur - extra, cur))
                        else:
                            cuts.append((win_lo, win_lo + extra))
            else:
                self.granulepos += int(advf[i])
                if vgp != -1 and self.granulepos != vgp:
                    if self.granulepos > vgp:
                        extra = (self.granulepos - vgp) >> hs
                        if extra and eos_i:
                            extra = min(extra, cur - win_lo)
                            cuts.append((cur - extra, cur))
                    self.granulepos = vgp
            win_lo = cur

        self.prev_W = int(W[-1])
        self.tail = out[:, emit_to:emit_to
                        + (int(ns[-1]) >> (1 + hs))].copy()
        if not cuts:
            return out[:, emit_from:emit_to]
        keepers, pos = [], emit_from
        for a, b in sorted(cuts):
            a, b = max(a, pos), min(b, emit_to)
            if a > pos:
                keepers.append(out[:, pos:a])
            pos = max(pos, b)
        if pos < emit_to:
            keepers.append(out[:, pos:emit_to])
        if not keepers:
            return np.zeros((ch, 0), np.float32)
        return np.concatenate(keepers, 1)

    def _synth_staged(self, blob, off, bits, W, lW, nWv, starts, out):
        """Halfrate chunk synthesis: native parse -> batched half-size
        IMDCT -> windowed scatter-add at half-unit geometry (the
        batched mirror of the scalar halfrate blockin,
        reference: lib/synthesis.c:166 vorbis_synthesis_halfrate)."""
        from ..codec.nativeparse import parse_packet_arrays
        bs0, bs1 = self.bs
        hs = self.hs
        _, _, _, _, res = parse_packet_arrays(
            self.dec.tables, blob, off, bits)
        m = len(W)
        pcm = [None] * m
        for Wv in (0, 1):
            idx = np.flatnonzero(W == Wv)
            if not len(idx):
                continue
            nh = (bs1 if Wv else bs0) >> hs
            stack = np.ascontiguousarray(
                res[idx][:, :, :nh // 2].reshape(-1, nh // 2))
            from ..native import imdct_batch
            blocks = imdct_batch(stack, nh)
            blocks = blocks.reshape(len(idx), self.ch, nh)
            for j, k in enumerate(idx):
                pcm[k] = blocks[j]
        for k in range(m):
            key = (int(lW[k]), int(W[k]), int(nWv[k]))
            wv = hybrid_window(bs0 >> hs, bs1 >> hs, *key)
            o = int(starts[k])
            out[:, o:o + len(wv)] += pcm[k] * wv

    def _staging(self, name, size, dtype):
        """`size` elements of this decoder's pinned host buffer `name`,
        grown (doubling) to the largest chunk, so a chunk allocates no
        pinned memory once the stream has warmed."""
        buf = self._pinned.get(name)
        if buf is None or buf.numel() < size:
            old = 0 if buf is None else buf.numel()
            buf = torch.empty(max(size, 2 * old), dtype=dtype,
                              pin_memory=True)
            self._pinned[name] = buf
        return buf[:size]

    def _synth_device(self, blob, off, bits, W, winid, starts, centers,
                      first_ever):
        """The port's staged chunk on self.device, full rate and halfrate:
        the packet parse in the host C, one H2D copy of the chunk's padded
        spectra (and one of the tables), one IMDCT launch a blocksize
        present at n >> hs (under halfrate each row's first n/4 floats, as
        _synth_staged reads them), one lap launch with the window table of
        (bs0 >> hs, bs1 >> hs), the PCM back through the decoder's pinned
        buffer.  Returns a (ch, emit_to) array holding [emit_from,
        emit_to) of _process's local geometry; the columns before
        emit_from are not written.

        The JAX chunk adds its blocks into a buffer that holds the
        previous chunk's tail at fg: its sum past its last center, over
        half the last block.  The lap's trim here runs that far past
        emit_to, so its output ends with the tail, which stays on the
        device (`_tail`) and is the next chunk's lap's initial values:
        the kernel writes (tail + a) + b, the JAX chunk's sum, whatever
        window the carried block had (a damaged held-back packet leaves
        it the long-long window, which reaches past the next center)."""
        ch, hs, dev = self.ch, self.hs, self.device
        cuda = dev.type == "cuda"
        bs0, bs1 = self.bs
        _, _, _, _, res = parse_packet_arrays(
            self.dec.tables, blob, off, bits)
        n = np.where(W == 1, bs1, bs0).astype(np.int64) >> hs
        lo = int(centers[0]) if first_ever else bs1 >> hs   # emit_from
        hi = int(centers[-1])                               # emit_to
        end = hi + int(n[-1]) // 2                          # + the tail
        # the blocks, a group a blocksize
        base = 0
        blk = np.zeros(len(W), np.int64)
        rows = {}
        for nb in map(int, np.unique(n)):
            idx = np.flatnonzero(n == nb)
            blk[idx] = base + np.arange(len(idx)) * (ch * nb)
            rows[nb] = (base, ((idx[:, None] * ch + np.arange(ch))
                               * res.shape[2]).reshape(-1))
            base += len(idx) * ch * nb
        woff = _win_table(bs0 >> hs, bs1 >> hs)[1]
        tail = self._tail                    # (PCM, offset, stride, length)
        plan = LapPlan([(ch, n, starts, blk, woff[winid], lo, end)],
                       [None if tail is None
                        else (tail[1], tail[2], bs1 >> hs, tail[3])])
        tabs = np.concatenate([r for _, r in rows.values()]
                              + [plan.pk.reshape(-1), plan.st.reshape(-1)])
        if cuda:
            tabs_h = self._staging("tables", len(tabs), torch.int64)
            tabs_h.numpy()[:] = tabs
            tabs_d = tabs_h.to(dev, non_blocking=True)
        else:
            tabs_d = torch.from_numpy(tabs)
        spec = torch.from_numpy(res.reshape(-1)).to(dev)
        blocks = torch.empty(base, dtype=torch.float32, device=dev)
        t = 0
        for nb, (b0, offs) in rows.items():
            R = len(offs)
            imdct(spec, nb, rows=offs, out=blocks[b0:b0 + R * nb].view(R, nb),
                  rows_dev=tabs_d[t:t + R])
            t += R
        npk = plan.pk.size
        wins = _batch_windows(((bs0 >> hs, bs1 >> hs),), dev)
        out = lap(blocks, wins, plan,
                  tables=(tabs_d[t:t + npk], tabs_d[t + npk:]),
                  tails=None if tail is None else tail[0])
        self._tail = (out, hi - lo, end - lo, end - hi)
        pcm = np.empty((ch, hi), np.float32)
        v = plan.out_view(out, 0)
        if cuda:
            h = self._staging("pcm", v.numel(), torch.float32)
            h.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
            v = h.view(ch, end - lo)
        pcm[:, lo:hi] = v[:, :hi - lo].numpy()
        return pcm


_DEC_CACHE = {}                  # header bytes -> FastDecoder
_DEC_CACHE_MAX = 16


def _decoder_for(header_pkts):
    """FastDecoder memoized by the id+setup header bytes: codebook
    construction (~40 ms) dominates short-stream decode and every
    stream from one encoder config shares it."""
    key = (header_pkts[0], header_pkts[2])
    dec = _DEC_CACHE.get(key)
    if dec is None:
        vi = H.parse_headers(list(header_pkts))
        dec = FastDecoder(vi)
        if len(_DEC_CACHE) >= _DEC_CACHE_MAX:
            _DEC_CACHE.pop(next(iter(_DEC_CACHE)))
        _DEC_CACHE[key] = dec
    return dec



def _device(device):
    """device= of the entry points (decode_ogg_fast, FastStreamDecoder,
    OggVorbisFile) -> None (the host-C path) or the torch.device whose
    IMDCT and lap the staged path runs."""
    if device is False:
        return None
    if device is True:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the fast decode (decode_ogg_fast, OggVorbisFile) runs the "
                "IMDCT and the lap on the card by default and no CUDA "
                "device is available: pass device=\"cpu\" (their plain "
                "PyTorch versions on the CPU) or device=False (the host-C "
                "path)")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"fast decode: unsupported device {device!r}")


def _scan_job(data):
    """One stream's host half of the staged decode: the page walk and
    the packet parse in the host C.  Returns (decoder, W, spectra, gp,
    eos), or None when the stream has no three header packets."""
    blob, off, lens, gp, eos, _serial = ogg_scan(data)
    if len(off) < 3:
        return None
    hdrs = tuple(blob[off[i]:off[i] + lens[i]].tobytes()
                 for i in range(3))
    dec = _decoder_for(hdrs)
    W, _, _, _, res = parse_packet_arrays(
        dec.tables, blob, off[3:], lens[3:] * 8)
    if (W < 0).any():
        raise FastDecodeUnsupported("bad packet in stream")
    return dec, W, res, gp[3:], eos[3:]


def decode_ogg_fast(data: bytes, device="cuda"):
    """Whole-stream fast decode; returns (pcm, vi).  Raises
    FastDecodeUnsupported on a bad packet.

    device="cuda" (the default; True and a CUDA torch.device alike) runs
    the device stages on the card: the page walk and packet parse in the
    host C, the IMDCT in csrc/imdct.cu, the lap and trim in csrc/lap.cu,
    the PCM back in pinned memory.  device="cpu" runs the same stages
    with the plain versions on the CPU.
    device=False is the FUSED host-C drain: vn_ogg_scan (page walk ->
    packet arrays) + vn_decode_stream (parse/IMDCT/lap in one chunked
    call), the JAX package's default."""
    dev = _device(device)
    if dev is None:
        blob, off, lens, gp, eos, _serial = ogg_scan(data)
        if len(off) >= 3:
            hdrs = tuple(
                blob[off[i]:off[i] + lens[i]].tobytes()
                for i in range(3))
            dec = _decoder_for(hdrs)
            return dec.decode_arrays(blob, off[3:], lens[3:],
                                     gp[3:], eos[3:]), dec.vi
    else:
        job = _scan_job(data)
        if job is not None:
            return _decode_jobs([job], dev)[0]
    from ..bitstream.oggfile import OggStreamReader
    rd = OggStreamReader(data)
    pkts = list(rd.packets())
    dec = _decoder_for(tuple(p for p, _, _ in pkts[:3]))
    return dec.decode_packets(pkts[3:], device=dev), dec.vi


def _lap_geometry(W, bs0, bs1, gps, eoss):
    """One stream's lap in the coordinates of _lap_and_trim and
    decode_arrays (the earliest block start at 0): each packet's
    blocksize, block start and window id (lW * 4 + W * 2 + nW, as
    _win_table orders them), and the trim [lo, hi)."""
    npkt = len(W)
    ns = np.where(W == 1, bs1, bs0).astype(np.int64)
    adv = np.zeros(npkt, np.int64)
    adv[1:] = ns[:-1] // 4 + ns[1:] // 4
    centers = np.cumsum(adv)
    starts = centers - ns // 2
    base = starts.min()
    lW = np.concatenate([[0], W[:-1]])
    nW = np.concatenate([W[1:], [W[-1]]])
    winid = (lW * 4 + W * 2 + nW).astype(np.int64)
    gp_arr = (gps.astype(np.int64) if isinstance(gps, np.ndarray) else
              np.asarray([-1 if g is None else int(g) for g in gps],
                         np.int64))
    lo, hi = FastDecoder._trim_range(centers, base, gp_arr,
                                     np.asarray(eoss, bool))
    return ns, starts - base, winid, lo, hi


@lru_cache(maxsize=None)
def _batch_windows(pairs, device):
    """The hybrid windows of each (bs0, bs1) of `pairs`, one _win_table
    after another, on `device`."""
    return torch.from_numpy(np.concatenate(
        [_win_table(*bs)[0] for bs in pairs])).to(device)


class _BatchPlan:
    """The device stages' layout of a batch of jobs, made on the host:
    `rows[n]` the (stream, packet indices) of blocksize n in order;
    `group[n]` its first element in the blocks buffer and its row count
    (blocksize groups one after another; in a group each stream's packets
    in order, a packet's channels on consecutive rows); `nblocks` the
    buffer's floats; `pairs` the batch's (bs0, bs1) in the order of the
    window buffer (_batch_windows); `plan` the lap (ops/lap_cuda.py)."""

    def __init__(self, jobs):
        pairs, wbase, geo, rows = [], {}, [], {}
        for k, (dec, W, _, gp, eos) in enumerate(jobs):
            bs = tuple(dec.vi.blocksizes)
            if bs not in wbase:
                wbase[bs] = sum(len(_win_table(*p)[0]) for p in pairs)
                pairs.append(bs)
            if not len(W):
                geo.append(None)
                continue
            geo.append(_lap_geometry(W, *bs, gp, eos))
            for n in np.unique(geo[-1][0]):
                rows.setdefault(int(n), []).append(
                    (k, np.flatnonzero(geo[-1][0] == n)))
        blk = [np.zeros(len(j[1]), np.int64) for j in jobs]
        group, base = {}, 0
        for n in sorted(rows):
            r0 = 0
            for k, idx in rows[n]:
                ch = jobs[k][0].vi.channels
                blk[k][idx] = base + (r0 + np.arange(len(idx)) * ch) * n
                r0 += len(idx) * ch
            group[n] = (base, r0)
            base += r0 * n
        streams = []
        for k, (dec, *_rest) in enumerate(jobs):
            ch = dec.vi.channels
            if geo[k] is None:
                e = np.zeros(0, np.int64)
                streams.append((ch, e, e, e, e, 0, 0))
                continue
            ns, pos, winid, lo, hi = geo[k]
            bs = tuple(dec.vi.blocksizes)
            streams.append((ch, ns, pos, blk[k],
                            wbase[bs] + _win_table(*bs)[1][winid], lo, hi))
        self.rows, self.group, self.nblocks = rows, group, base
        self.pairs = tuple(pairs)
        self.plan = LapPlan(streams)


def _decode_jobs(jobs, device, profile=None):
    """The device half of the staged decode, for every stream of a batch
    at once: each stream's padded (npkt, ch, n2max) spectra to `device`
    as the parse left them, one IMDCT launch a blocksize reading its rows
    there through a row table (the blocks of all streams in one buffer),
    one lap launch that writes every stream's trimmed PCM, then each
    stream's (ch, N) PCM to the host (pinned memory on a card).  On the
    CPU the same plan runs the plain versions.  Returns [(pcm, vi)] in
    job order.  A `profile` dict receives the host seconds of the plan
    and the row tables, the rows a blocksize, the lap's arguments
    (blocks, windows, plan, tables) and, on a card, the device ms of the
    H2D copies, each IMDCT launch, the lap and the D2H copies.

    Copying the spectra as they are moves up to n2max / (n/2) times the
    rows' bytes (8x for a short block at 256 / 2048); packing each
    blocksize's rows on the host first (np.take into pinned memory) moves
    only the rows but costs a host copy of all of them: on an H100 the
    copy in place took 0.0712 s against 0.1699 s for the device half of
    16 x 60 s of tonal streams and 0.1527 s against 0.1757 s on the click
    train, whose rows are mostly short (chip_smoke.py phase 6)."""
    cuda = device.type == "cuda"
    t0 = time.perf_counter()
    bp = _BatchPlan(jobs)
    plan, rows, group = bp.plan, bp.rows, bp.group
    t_plan = time.perf_counter() - t0

    # each row's offset in the spectra of all streams, one after another
    t0 = time.perf_counter()
    sbase = np.cumsum([0] + [res.size for _, _, res, _, _ in jobs])
    offs = {n: np.concatenate([
        sbase[k] + ((idx[:, None] * jobs[k][0].vi.channels
                     + np.arange(jobs[k][0].vi.channels))
                    * jobs[k][2].shape[2]).reshape(-1)
        for k, idx in grp]) for n, grp in rows.items()}
    # the row tables and the lap's tables in one copy
    tabs = np.concatenate([offs[n] for n in sorted(rows)]
                          + [plan.pk.reshape(-1), plan.st.reshape(-1)])
    t_tabs = time.perf_counter() - t0

    timed = cuda and profile is not None
    ev = []

    def mark():
        if timed:
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()

    mark()
    if cuda:
        tabs_h = torch.empty(len(tabs), dtype=torch.int64, pin_memory=True)
        tabs_h.numpy()[:] = tabs
        tabs_d = tabs_h.to(device, non_blocking=True)
    else:
        tabs_d = torch.from_numpy(tabs)
    # each stream's spectra straight from the parse's (pageable) buffer
    # into its place on the device
    spec = torch.empty(int(sbase[-1]), dtype=torch.float32, device=device)
    for k, (_, _, res, _, _) in enumerate(jobs):
        spec[sbase[k]:sbase[k + 1]].copy_(torch.from_numpy(
            np.ascontiguousarray(res).reshape(-1)), non_blocking=True)
    mark()
    blocks = torch.empty(bp.nblocks, dtype=torch.float32, device=device)
    t = 0
    for n in sorted(rows):
        b0, R = group[n]
        imdct(spec, n, rows=offs[n],
              out=blocks[b0:b0 + R * n].view(R, n),
              rows_dev=tabs_d[t:t + R])
        t += R
        mark()
    npk = plan.pk.size
    wins = _batch_windows(bp.pairs, device)
    lap_tabs = (tabs_d[t:t + npk], tabs_d[t + npk:])
    out = lap(blocks, wins, plan, tables=lap_tabs)
    mark()
    pcm = []
    for k in range(len(jobs)):
        v = plan.out_view(out, k)
        if cuda:
            h = torch.empty(v.shape, dtype=torch.float32, pin_memory=True)
            h.copy_(v, non_blocking=True)
            v = h
        pcm.append(v)
    if cuda:
        done = torch.cuda.Event()
        done.record()
        mark()
        done.synchronize()
    if profile is not None:
        profile.update(plan=t_plan, tables=t_tabs, rows={
            n: group[n][1] for n in sorted(rows)},
            lap_args=(blocks, wins, plan, lap_tabs))
        if timed:
            ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
            profile.update(h2d_ms=ms[0], imdct_ms=ms[1:-2], lap_ms=ms[-2],
                           d2h_ms=ms[-1])
    return [(p.numpy(), dec.vi) for p, (dec, *_r) in zip(pcm, jobs)]


def _decode_batch_device(streams, device):
    """Multi-stream DEVICE decode: every stream's packets are parsed
    natively, then ALL streams ride one IMDCT launch a blocksize and one
    lap launch on the device (_decode_jobs).  Bit-exact with the
    per-stream paths."""
    jobs = [_scan_job(data) for data in streams]
    if any(j is None for j in jobs):
        return [decode_ogg_fast(s, device=device) for s in streams]
    return _decode_jobs(jobs, device)


def decode_ogg_fast_batch(streams, threads=None, device="cuda"):
    """Decode MANY independent Ogg streams concurrently.

    device="cuda" (the default) or "cpu" routes ALL streams' packets
    through one IMDCT launch a blocksize and one lap launch on that
    device (_decode_batch_device).  device=False runs each stream through two
    whole-stream host C calls (vn_ogg_scan + vn_decode_stream) that
    release the GIL for their entire duration, so a thread pool scales
    the drain across host cores the way the reference would need one
    process per file (libvorbis is single-threaded; SURVEY.md §2
    'Parallelism strategies').  Returns a list of (pcm, vi) in input
    order."""
    dev = _device(device)
    if dev is not None and len(streams) > 1:
        return _decode_batch_device(streams, dev)
    from concurrent.futures import ThreadPoolExecutor
    if threads is None:
        import os
        # honor the cgroup/affinity mask: os.cpu_count() reports the
        # machine's cores, not the cores THIS process may run on, and a
        # thread pool wider than the mask only buys GIL churn (25%+
        # aggregate loss measured on a 1-core mask)
        try:
            cores = len(os.sched_getaffinity(0))
        except AttributeError:
            cores = os.cpu_count() or 1
        threads = min(8, cores, max(1, len(streams)))
    if threads <= 1 or len(streams) <= 1:
        return [decode_ogg_fast(s, device=device) for s in streams]
    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(
            lambda s: decode_ogg_fast(s, device=device), streams))
