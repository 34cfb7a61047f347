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
- the device stage is the hand-written CUDA IMDCT (ops/imdct_cuda.py,
  csrc/imdct.cu) on a CUDA device, its plain PyTorch version on the CPU:
  per wave one host gather into pinned memory, one H2D copy, one launch
  on the current stream and an asynchronous D2H copy into pinned memory,
  every stream's waves dispatched before any is drained;
- the entry points run on the card unless the caller asks otherwise:
  device="cuda" (the default, or True, or a CUDA torch.device) runs the
  IMDCT on the card and raises without one; device="cpu" runs the same
  staged path with the plain IMDCT on the CPU; device=False is the fused
  host-C drain (vn_decode_stream), the JAX package's default;
- `_render_curves` (which nothing calls) and `FastStreamDecoder` (whose
  caller, vorbis_tpu/vorbisfile.py, is not ported) stay behind.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec import headers as H
from ..codec.floor1_codec import fromdB_lookup
from ..codec.nativeparse import (StreamParseTables, decode_stream,
                                 parse_packet_arrays, parse_packets, scan_W)
from ..native import decode_library, imdct_batch, ogg_scan
from ..ops.imdct_cuda import imdct
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

    def _device_imdct_dispatch(self, spec, W, bs0, bs1, device,
                               waves=None):
        """Dispatch the IMDCT of both W groups to `device` (async on a
        card); returns a pending handle for _device_imdct_drain.
        Dispatching EVERY stream's waves before draining any is what
        lets the multi-stream device batch overlap all transfers and
        compute (decode_ogg_fast_batch(device="cuda")).  On a card a
        wave is one gather into pinned host memory, one H2D copy, one
        kernel launch on the current stream and one asynchronous D2H
        copy into pinned memory; on the CPU it is the plain IMDCT.  A
        `waves` list receives each card wave's (n, rows, timing events
        before the H2D copy, after it, after the kernel, after the
        D2H)."""
        cuda = device.type == "cuda"
        pending = []
        for Wv in (0, 1):
            idx = np.where(W == Wv)[0]
            if not len(idx):
                continue
            n = bs1 if Wv else bs0
            G = len(idx) * spec.shape[1]
            if not cuda:
                stack = np.ascontiguousarray(
                    spec[idx][:, :, :n // 2].reshape(-1, n // 2))
                pending.append((Wv, idx, n, G,
                                (imdct(torch.from_numpy(stack), n), None)))
                continue
            host = torch.empty((G, n // 2), dtype=torch.float32,
                               pin_memory=True)
            np.take(spec[:, :, :n // 2], idx, axis=0,
                    out=host.numpy().reshape(len(idx), -1, n // 2))
            timed = waves is not None
            ev = [torch.cuda.Event(enable_timing=timed)
                  for _ in range(4 if timed else 1)]
            if timed:
                ev[0].record()
            rows = host.to(device, non_blocking=True)
            if timed:
                ev[1].record()
            blocks = imdct(rows, n)
            if timed:
                ev[2].record()
            out = torch.empty((G, n), dtype=torch.float32, pin_memory=True)
            out.copy_(blocks, non_blocking=True)
            ev[-1].record()
            if timed:
                waves.append((n, G, ev))
            pending.append((Wv, idx, n, G, (out, ev[-1])))
        return pending

    @staticmethod
    def _device_imdct_drain(pending, npkt):
        """Collect dispatched IMDCT waves into the `groups`/`gidx`
        layout the lap stage consumes."""
        groups = {}
        gidx = np.zeros(npkt, np.int32)
        for Wv, idx, n, G, (out, done) in pending:
            if done is not None:
                done.synchronize()
            blocks = np.ascontiguousarray(
                out.numpy().reshape(len(idx), -1, n))
            groups[Wv] = blocks
            gidx[idx] = np.arange(len(idx), dtype=np.int32)
        return groups, gidx

    def _device_imdct(self, spec, W, bs0, bs1, device):
        """IMDCT on `device` for both W groups, batched over packets
        (bit-exact with the host C: csrc/imdct.cu and the plain version
        keep the reference op order).  Returns the same `groups`/`gidx`
        layout the host-C path produces."""
        return self._device_imdct_drain(
            self._device_imdct_dispatch(spec, W, bs0, bs1, device), len(W))

    def _lap_and_trim(self, W, groups, gidx, gps, eoss):
        """Windowed scatter-add lapping + granulepos trim from the
        per-group IMDCT blocks (shared by the staged single-stream
        path and the multi-stream device batch)."""
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
        blockin/granulepos state machine.  device=None runs the IMDCT in
        the host C; a torch.device runs it there (see _device_imdct)."""
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

        # ---- IMDCT per W group (host C bit-exact kernel, or the
        # device's: the CUDA kernel or its plain version) ----
        if device is not None:
            groups, gidx = self._device_imdct(spec, W, bs0, bs1, device)
        else:
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
    """device= of the entry points -> None (the fused host-C drain) or
    the torch.device whose IMDCT the staged path runs."""
    if device is False:
        return None
    if device is True:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "decode_ogg_fast runs the IMDCT on the card by default and "
                "no CUDA device is available: pass device=\"cpu\" (the "
                "IMDCT in plain PyTorch on the CPU) or device=False (the "
                "fused host-C drain)")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"decode_ogg_fast: unsupported device {device!r}")


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
    the IMDCT stage on the card: the page walk and packet parse in the
    host C, the IMDCT in csrc/imdct.cu, the lap and trim in the host C.
    device="cpu" runs the same stages with the plain IMDCT on the CPU.
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


def _decode_jobs(jobs, device):
    """The device half of the staged decode: every stream's IMDCT waves
    are dispatched before any stream's lap/trim drains."""
    pendings = [
        dec._device_imdct_dispatch(res, W, *dec.vi.blocksizes, device)
        for dec, W, res, _, _ in jobs]
    outs = []
    for (dec, W, res, gp, eos), pend in zip(jobs, pendings):
        if not len(W):
            outs.append((np.zeros((dec.vi.channels, 0), np.float32),
                         dec.vi))
            continue
        groups, gidx = dec._device_imdct_drain(pend, len(W))
        outs.append((dec._lap_and_trim(W, groups, gidx, gp, eos),
                     dec.vi))
    return outs


def _decode_batch_device(streams, device):
    """Multi-stream DEVICE decode: every stream's packets are parsed
    natively, then ALL streams' spectra ride one IMDCT dispatch wave
    on the device (transfers and compute of different streams
    overlap, like encode_batch's chip-filling batches) before any
    stream's lap/trim drains.  Bit-exact with the per-stream paths."""
    jobs = [_scan_job(data) for data in streams]
    if any(j is None for j in jobs):
        return [decode_ogg_fast(s, device=device) for s in streams]
    return _decode_jobs(jobs, device)


def decode_ogg_fast_batch(streams, threads=None, device="cuda"):
    """Decode MANY independent Ogg streams concurrently.

    device="cuda" (the default) or "cpu" routes ALL streams' packets
    through one IMDCT dispatch wave on that device
    (_decode_batch_device).  device=False runs each stream through two
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
