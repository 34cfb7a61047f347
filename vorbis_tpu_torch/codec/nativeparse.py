"""Marshal a stream's decode configuration for the native whole-stream
packet parser (native/vorbisnative.c vn_parse_packets) and drive it.

The parser is the serial half of the decode drain: Huffman bit I/O for
floors and residues of EVERY audio packet in one C call (reference hot
loop: lib/mapping0.c mapping0_inverse floor/residue reads through
lib/codebook.c decode_packed_entry_number).  It emits dense arrays —
unwrapped floor posts, per-channel used flags, and fully accumulated
float32 residue vectors — that the batched synthesis (models/fastdec.py)
consumes without any per-packet Python.

Eligibility: floor type 1 everywhere (every standard encoder template;
multi-submap mappings like the 5.1 templates are supported).  Floor
type 0 (legacy LSP streams) -> caller uses the scalar Decoder path;
the fallback is counted/logged by the caller so the speed cliff is
visible (see models/fastdec.py fallback_reason).

Copy of vorbis_tpu/codec/nativeparse.py, kept line-aligned with it: it
drives the port's own host C (csrc/host_decode.c, built and bound by
vorbis_tpu_torch/native.py `decode_library`), which parses floor0 and
floor1 alike.  A failed build raises, so `_check` has no "native library
unavailable" reason.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

from ..bitstream.bitpack import ilog
from . import headers as H

_MAXCH = 64


class StreamParseTables:
    """Per-VorbisInfo flattened config + book tables (built once per
    stream, reused across calls)."""

    def __init__(self, vi: H.VorbisInfo):
        self.vi = vi
        self.why = self._check(vi)
        self.ok = self.why is None
        if self.ok:
            self._build()

    @staticmethod
    def _check(vi):
        """Returns None when native-decodable, else a human-readable
        reason (surfaced by the caller so the scalar-speed fallback is
        never silent).  Floor types 0 AND 1 both ride the native
        drain."""
        if vi.channels > _MAXCH:
            return f"{vi.channels} channels > {_MAXCH}"
        if len(vi.books) > 512:
            return f"{len(vi.books)} codebooks > 512"
        for t, f in zip(vi.floor_types, vi.floors):
            if t == 0 and f.order + 8 > 500:
                return f"floor0 order {f.order} too large"
        return None

    def _build(self):
        vi = self.vi
        from ..native import HuffDecoder

        # ---- books: two-level Huffman tables + value tables ----
        t1s, secs, soffs = [], [], []
        secbase, soffbase, k2s = [], [], []
        vals, valbase, dims = [], [], []
        sec_acc = 0
        soff_acc = 0
        val_acc = 0
        for b in vi.books:
            hd = HuffDecoder(b.codewords, b.lengths)
            assert hd.ok
            t1s.append(hd.t1)
            secs.append(hd.sec)
            soffs.append(hd.offs)
            secbase.append(sec_acc)
            soffbase.append(soff_acc)
            k2s.append(hd.K2)
            sec_acc += len(hd.sec)
            soff_acc += len(hd.offs)
            v = b.values
            if v is None:
                v = np.zeros((1, 1), np.float32)
            vals.append(np.ascontiguousarray(v, np.float32).reshape(-1))
            valbase.append(val_acc)
            val_acc += vals[-1].size
            dims.append(b.dim if b.values is not None else 1)
        self.t1_all = np.ascontiguousarray(np.concatenate(t1s), np.int32)
        self.sec_all = np.ascontiguousarray(np.concatenate(secs), np.int32)
        self.soff_all = np.ascontiguousarray(np.concatenate(soffs), np.int64)
        self.book_secbase = np.asarray(secbase, np.int64)
        self.book_soffbase = np.asarray(soffbase, np.int64)
        self.book_K2 = np.asarray(k2s, np.int32)
        self.vals_all = np.ascontiguousarray(np.concatenate(vals), np.float32)
        self.book_valbase = np.asarray(valbase, np.int64)
        self.book_dim = np.asarray(dims, np.int32)

        # ---- floor configs (type-tagged: cfg[0] = floor type) ----
        from .floor0_codec import Floor0Look
        from .floor1_codec import Floor1Look
        fl_flat, fl_off = [], []
        self.floor_looks = []
        acc = 0
        Pmax = 1
        n2_0 = vi.blocksizes[0] // 2
        n2_1 = vi.blocksizes[1] // 2
        for ftype, info in zip(vi.floor_types, vi.floors):
            if ftype == 0:
                look = Floor0Look(info)
                self.floor_looks.append(look)
                cfg = [0, look.m, info.ampbits, info.ampdB,
                       len(info.books)]
                cfg += list(info.books)
                cfg += [look.ln]
                cfg += [int(v) for v in look.get_map(n2_0)]
                cfg += [int(v) for v in look.get_map(n2_1)]
                Pmax = max(Pmax, look.m + 1)
            else:
                look = Floor1Look(info)
                self.floor_looks.append(look)
                P = look.posts
                nclasses = (max(info.partitionclass) + 1
                            if info.partitions else 0)
                cfg = [1, P, ilog(look.quant_q - 1), info.partitions,
                       look.quant_q, nclasses]
                cfg += list(info.partitionclass)
                for cl in range(nclasses):
                    sub = list(info.class_subbook[cl]) + [-1] * 8
                    cfg += [info.class_dim[cl], info.class_subs[cl],
                            info.class_book[cl]] + sub[:8]
                cfg += list(info.postlist)
                cfg += list(look.loneighbor)
                cfg += list(look.hineighbor)
                cfg += [info.mult]
                cfg += list(look.forward_index)
                Pmax = max(Pmax, P)
            fl_off.append(acc)
            fl_flat.extend(cfg)
            acc += len(cfg)
        self.flcfg = np.asarray(fl_flat, np.int32)
        self.flcfg_off = np.asarray(fl_off, np.int64)
        self.Pmax = Pmax
        from .floor1_codec import fromdB_lookup
        self.fromdB = np.ascontiguousarray(fromdB_lookup(), np.float32)

        # ---- residue configs ----
        from .residue_codec import ResidueLook
        self.res_looks = [ResidueLook(r, vi.books) for r in vi.residues]
        rs_flat, rs_off = [], []
        acc = 0
        for rt, info, look in zip(vi.residue_types, vi.residues,
                                  self.res_looks):
            possible = info.partitions
            stages = look.stages
            cfg = [rt, info.begin, info.end, info.grouping, possible,
                   stages, info.groupbook, look.dim, info.partvals]
            cfg += list(info.secondstages)
            pb = []
            for cl in range(possible):
                for s in range(stages):
                    b = look.partbooks[cl][s]
                    pb.append(-1 if b is None else
                              vi.books.index(b))
            cfg += pb
            rs_off.append(acc)
            rs_flat.extend(cfg)
            acc += len(cfg)
        self.rescfg = np.asarray(rs_flat, np.int32)
        self.rescfg_off = np.asarray(rs_off, np.int64)

        # ---- mode + mapping tables ----
        nmodes = len(vi.modes)
        nmaps = len(vi.maps)
        ch = vi.channels
        self.nmodes = nmodes
        self.nmaps = nmaps
        self.modebits = ilog(nmodes - 1)
        self.mode_blockflag = np.asarray(
            [m.blockflag for m in vi.modes], np.int32)
        self.mode_map = np.asarray(
            [m.mapping for m in vi.modes], np.int32)
        submax = max((m.submaps for m in vi.maps), default=1)
        maxcpl = max(max((m.coupling_steps for m in vi.maps), default=0),
                     1)
        self.submax = submax
        self.maxcpl = maxcpl
        self.map_submaps = np.asarray(
            [m.submaps for m in vi.maps], np.int32)
        chmux = np.zeros((nmaps, ch), np.int32)
        fsub = np.zeros((nmaps, submax), np.int32)
        rsub = np.zeros((nmaps, submax), np.int32)
        cc = np.zeros(nmaps, np.int32)
        cm = np.zeros((nmaps, maxcpl), np.int32)
        ca = np.zeros((nmaps, maxcpl), np.int32)
        for mi, m in enumerate(vi.maps):
            chmux[mi] = m.chmuxlist
            fsub[mi, :m.submaps] = m.floorsubmap
            rsub[mi, :m.submaps] = m.residuesubmap
            cc[mi] = m.coupling_steps
            for k in range(m.coupling_steps):
                cm[mi, k] = m.coupling_mag[k]
                ca[mi, k] = m.coupling_ang[k]
        self.map_chmux = np.ascontiguousarray(chmux)
        self.map_floorsub = np.ascontiguousarray(fsub)
        self.map_ressub = np.ascontiguousarray(rsub)
        self.cpl_count = cc
        self.cpl_mag = np.ascontiguousarray(cm)
        self.cpl_ang = np.ascontiguousarray(ca)

        # scratch sizing: worst-case partwords per channel
        pwmax = 64
        for info, look in zip(vi.residues, self.res_looks):
            pv = max(0, (info.end - info.begin)) // info.grouping
            pw = (pv + look.dim - 1) // look.dim * look.dim
            pwmax = max(pwmax, pw + look.dim)
        self.pwmax = int(pwmax)


def _ptr(a):
    return C.c_void_p(a.ctypes.data)


def _cfg_args(tables: StreamParseTables):
    """The flat stream-config ctypes argument list shared by
    vn_parse_packets / vn_scan_W / vn_decode_stream (everything after
    data/off/bits/npkt up through the blocksizes)."""
    vi = tables.vi
    return [
        C.c_int(vi.channels), C.c_int(tables.modebits),
        C.c_int(tables.nmodes),
        C.c_int(tables.nmaps), C.c_int(tables.submax),
        _ptr(tables.mode_blockflag), _ptr(tables.mode_map),
        _ptr(tables.map_submaps), _ptr(tables.map_chmux),
        _ptr(tables.map_floorsub), _ptr(tables.map_ressub),
        _ptr(tables.cpl_count), _ptr(tables.cpl_mag),
        _ptr(tables.cpl_ang), C.c_int(tables.maxcpl),
        _ptr(tables.t1_all), _ptr(tables.sec_all),
        _ptr(tables.soff_all),
        _ptr(tables.book_secbase), _ptr(tables.book_soffbase),
        _ptr(tables.book_K2),
        _ptr(tables.vals_all), _ptr(tables.book_valbase),
        _ptr(tables.book_dim), C.c_int(len(vi.books)),
        _ptr(tables.flcfg), _ptr(tables.flcfg_off),
        _ptr(tables.rescfg), _ptr(tables.rescfg_off),
        _ptr(tables.fromdB),
        C.c_int(vi.blocksizes[0]), C.c_int(vi.blocksizes[1])]


def parse_packets(tables: StreamParseTables, packets: list[bytes]):
    """Parse all audio packets natively (list-of-bytes entry; see
    parse_packet_arrays for the dense-array form)."""
    sizes = np.asarray([len(p) for p in packets], np.int64)
    npkt = len(packets)
    off = np.zeros(npkt, np.int64)
    np.cumsum(sizes[:-1], out=off[1:])
    blob = np.frombuffer(b"".join(packets) + b"\x00" * 8, np.uint8)
    return parse_packet_arrays(tables, blob, off, sizes * 8)


def parse_packet_arrays(tables: StreamParseTables, blob, off, bits):
    """Parse all audio packets natively from a dense byte blob +
    per-packet offsets/bit counts (the vn_ogg_scan output form).

    Returns (W (npkt,) int32 with -1 for bad/non-audio, posts
    (npkt, ch, Pmax) int32, nonzero (npkt, ch) uint8, res
    (npkt, ch, n2max) float32 accumulated residues).
    """
    from ..native import decode_library
    L = decode_library()
    vi = tables.vi
    ch = vi.channels
    npkt = len(off)
    n2max = vi.blocksizes[1] // 2

    out_W = np.empty(npkt, np.int32)
    out_mode = np.empty(npkt, np.int32)
    out_posts = np.zeros((npkt, ch, tables.Pmax), np.int32)
    out_nonzero = np.zeros((npkt, ch), np.uint8)
    out_res = np.zeros((npkt, ch, n2max), np.float32)
    scratch = np.zeros(ch * tables.pwmax, np.int32)

    fn = L.vn_parse_packets

    rc = fn(_ptr(blob), _ptr(off), _ptr(bits), C.c_long(npkt),
            *_cfg_args(tables),
            _ptr(out_W), _ptr(out_mode), _ptr(out_posts),
            _ptr(out_nonzero), _ptr(out_res),
            C.c_int(tables.Pmax), C.c_int(n2max),
            _ptr(scratch), C.c_int(tables.pwmax))
    if rc != 0:
        raise RuntimeError("vn_parse_packets failed")
    return out_W, out_mode, out_posts, out_nonzero, out_res


def scan_W(tables: StreamParseTables, blob, off, bits):
    """Per-packet block flags only (vn_scan_W): -1 = bad packet."""
    from ..native import decode_library
    L = decode_library()
    npkt = len(off)
    out_W = np.empty(npkt, np.int32)
    L.vn_scan_W(_ptr(blob), _ptr(off), _ptr(bits), C.c_long(npkt),
                C.c_int(tables.modebits), C.c_int(tables.nmodes),
                _ptr(tables.mode_blockflag), _ptr(out_W))
    return out_W


def decode_stream(tables: StreamParseTables, blob, off, bits,
                  offs, winid, wins, win_off, out, out_W, CH=128):
    """Fused whole-stream decode (vn_decode_stream): Huffman parse +
    residue accumulate + coupling + floor render + IMDCT + windowed
    lapped overlap-add, chunked for cache locality, in ONE native
    call.  out (ch, outlen) float32 accumulates the lapped PCM at the
    caller-computed per-packet offsets."""
    from ..native import decode_library, imdct_tab
    L = decode_library()
    vi = tables.vi
    npkt = len(off)
    tab0 = imdct_tab(vi.blocksizes[0])
    tab1 = imdct_tab(vi.blocksizes[1])
    rc = L.vn_decode_stream(
        _ptr(blob), _ptr(off), _ptr(bits), C.c_long(npkt),
        *_cfg_args(tables),
        C.c_int(tables.Pmax), C.c_int(vi.blocksizes[1] // 2),
        C.c_int(tables.pwmax),
        _ptr(offs), _ptr(winid), _ptr(wins), _ptr(win_off),
        C.byref(tab0), C.byref(tab1),
        _ptr(out), C.c_long(out.shape[1]),
        _ptr(out_W), C.c_int(CH))
    if rc != 0:
        raise RuntimeError(f"vn_decode_stream failed ({rc})")
