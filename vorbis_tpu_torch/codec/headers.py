"""Vorbis header packets: identification, comment, setup.

Pack/unpack of the three header packets, with the decode-side strict
validation contract of the reference (lib/info.c _vorbis_unpack_info /
_vorbis_unpack_books; lib/floor1.c floor1_unpack; lib/res0.c
res0_unpack; lib/mapping0.c mapping0_unpack).  The setup header is the
entire decoder configuration — arbitrary books/floors/residues must
parse from it.

Copy of vorbis_tpu/codec/headers.py (the vendor string included, so the
port's header packets equal the JAX package's byte for byte).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..bitstream.bitpack import BitReader, BitWriter, ilog
from .codebook import BadHeaderError, Codebook, StaticCodebook

VENDOR = "vorbis_tpu (aoTuV-compatible TPU-native encoder)"


@dataclass
class Floor0Info:
    order: int
    rate: int
    barkmap: int
    ampbits: int
    ampdB: int
    books: list


@dataclass
class Floor1Info:
    partitions: int
    partitionclass: list
    class_dim: list
    class_subs: list
    class_book: list
    class_subbook: list      # list of lists, -1 = none
    mult: int
    rangebits: int
    postlist: list           # full list incl. [0, 1<<rangebits] at front
    # encoder-side tuning (from mode templates, not in stream):
    maxover: float = 0.0
    maxunder: float = 0.0
    maxerr: float = 0.0
    twofitweight: float = 0.0
    twofitatten: float = 0.0

    @property
    def posts(self) -> int:
        return len(self.postlist)


@dataclass
class ResidueInfo:
    restype: int
    begin: int
    end: int
    grouping: int
    partitions: int
    groupbook: int
    secondstages: list
    booklist: list
    partvals: int = 0
    # encoder-side classification metrics (templates only):
    classmetric1: list | None = None
    classmetric2: list | None = None


@dataclass
class MappingInfo:
    submaps: int
    coupling_mag: list
    coupling_ang: list
    chmuxlist: list
    floorsubmap: list
    residuesubmap: list

    @property
    def coupling_steps(self):
        return len(self.coupling_mag)


@dataclass
class ModeInfo:
    blockflag: int
    windowtype: int
    transformtype: int
    mapping: int


@dataclass
class VorbisInfo:
    channels: int = 0
    rate: int = 0
    bitrate_upper: int = 0
    bitrate_nominal: int = 0
    bitrate_lower: int = 0
    blocksizes: tuple = (0, 0)
    # setup
    static_books: list = field(default_factory=list)
    books: list = field(default_factory=list)       # runtime Codebook
    floor_types: list = field(default_factory=list)
    floors: list = field(default_factory=list)
    residue_types: list = field(default_factory=list)
    residues: list = field(default_factory=list)
    maps: list = field(default_factory=list)
    modes: list = field(default_factory=list)
    # comment
    vendor: str = VENDOR
    comments: list = field(default_factory=list)


def _check_header_prefix(r: BitReader, packtype: int):
    if r.read(8) != packtype:
        raise BadHeaderError(f"not header type {packtype}")
    if r.read_bytes(6) != b"vorbis":
        raise BadHeaderError("missing vorbis signature")


def parse_id_header(packet: bytes) -> VorbisInfo:
    r = BitReader(packet)
    _check_header_prefix(r, 1)
    if r.read(32) != 0:
        raise BadHeaderError("bad vorbis version")
    vi = VorbisInfo()
    vi.channels = r.read(8)
    vi.rate = r.read(32)
    vi.bitrate_upper = r.read_signed(32)
    vi.bitrate_nominal = r.read_signed(32)
    vi.bitrate_lower = r.read_signed(32)
    bs0 = 1 << r.read(4)
    bs1 = 1 << r.read(4)
    vi.blocksizes = (bs0, bs1)
    if vi.rate < 1 or vi.channels < 1:
        raise BadHeaderError("bad rate/channels")
    if bs0 < 64 or bs1 < bs0 or bs1 > 8192:
        raise BadHeaderError("bad blocksizes")
    if r.read1() != 1:
        raise BadHeaderError("missing framing bit")
    return vi


def parse_comment_header(packet: bytes, vi: VorbisInfo) -> None:
    r = BitReader(packet)
    _check_header_prefix(r, 3)
    vlen = r.read(32)
    vi.vendor = r.read_bytes(vlen).decode("utf-8", errors="replace")
    n = r.read(32)
    vi.comments = []
    for _ in range(n):
        clen = r.read(32)
        vi.comments.append(
            r.read_bytes(clen).decode("utf-8", errors="replace"))
    if r.read1() != 1:
        raise BadHeaderError("missing framing bit")


def _unpack_floor0(r: BitReader, vi: VorbisInfo) -> Floor0Info:
    order = r.read(8)
    rate = r.read(16)
    barkmap = r.read(16)
    ampbits = r.read(6)
    ampdB = r.read(8)
    numbooks = r.read(4) + 1
    books = [r.read(8) for _ in range(numbooks)]
    if order < 1 or rate < 1 or barkmap < 1:
        raise BadHeaderError("bad floor0 config")
    for b in books:
        if b >= len(vi.books):
            raise BadHeaderError("floor0 book out of range")
        if vi.books[b].sb.maptype == 0 or vi.books[b].dim < 1:
            raise BadHeaderError("floor0 book unusable")
    return Floor0Info(order, rate, barkmap, ampbits, ampdB, books)


def _unpack_floor1(r: BitReader, vi: VorbisInfo) -> Floor1Info:
    nbooks = len(vi.books)
    partitions = r.read(5)
    partitionclass = [r.read(4) for _ in range(partitions)]
    maxclass = max(partitionclass) if partitionclass else -1
    class_dim, class_subs, class_book, class_subbook = [], [], [], []
    for _ in range(maxclass + 1):
        dim = r.read(3) + 1
        subs = r.read(2)
        book = r.read(8) if subs else 0
        if book >= nbooks:
            raise BadHeaderError("floor1 class book out of range")
        subbooks = []
        for _ in range(1 << subs):
            sb = r.read(8) - 1
            if sb < -1 or sb >= nbooks:
                raise BadHeaderError("floor1 subbook out of range")
            subbooks.append(sb)
        class_dim.append(dim)
        class_subs.append(subs)
        class_book.append(book)
        class_subbook.append(subbooks)
    mult = r.read(2) + 1
    rangebits = r.read(4)
    postlist = [0, 1 << rangebits]
    count = 0
    for j in range(partitions):
        count += class_dim[partitionclass[j]]
        if count > 63:
            raise BadHeaderError("too many floor1 posts")
        while len(postlist) - 2 < count:
            t = r.read(rangebits)
            postlist.append(t)
    if len(set(postlist)) != len(postlist):
        raise BadHeaderError("duplicate floor1 posts")
    return Floor1Info(partitions, partitionclass, class_dim, class_subs,
                      class_book, class_subbook, mult, rangebits, postlist)


def _pack_floor0(w: BitWriter, info: Floor0Info) -> None:
    """floor0_pack (reference lib/floor0.c layout mirror of
    _unpack_floor0; no modern encoder template emits it, but legacy
    setups round-trip through it)."""
    w.write(info.order, 8)
    w.write(info.rate, 16)
    w.write(info.barkmap, 16)
    w.write(info.ampbits, 6)
    w.write(info.ampdB, 8)
    w.write(len(info.books) - 1, 4)
    for b in info.books:
        w.write(b, 8)


def _pack_floor1(w: BitWriter, info: Floor1Info) -> None:
    w.write(info.partitions, 5)
    maxclass = -1
    for j in range(info.partitions):
        w.write(info.partitionclass[j], 4)
        maxclass = max(maxclass, info.partitionclass[j])
    for j in range(maxclass + 1):
        w.write(info.class_dim[j] - 1, 3)
        w.write(info.class_subs[j], 2)
        if info.class_subs[j]:
            w.write(info.class_book[j], 8)
        for k in range(1 << info.class_subs[j]):
            w.write(info.class_subbook[j][k] + 1, 8)
    w.write(info.mult - 1, 2)
    maxposit = info.postlist[1]
    rangebits = ilog(maxposit - 1)
    w.write(rangebits, 4)
    count = 0
    k = 0
    for j in range(info.partitions):
        count += info.class_dim[info.partitionclass[j]]
        while k < count:
            w.write(info.postlist[k + 2], rangebits)
            k += 1


def _unpack_residue(r: BitReader, vi: VorbisInfo, restype: int) -> ResidueInfo:
    begin = r.read(24)
    end = r.read(24)
    grouping = r.read(24) + 1
    partitions = r.read(6) + 1
    groupbook = r.read(8)
    secondstages = []
    for _ in range(partitions):
        cascade = r.read(3)
        if r.read1():
            cascade |= r.read(5) << 3
        secondstages.append(cascade)
    acc = sum(bin(c).count("1") for c in secondstages)
    booklist = [r.read(8) for _ in range(acc)]
    if groupbook >= len(vi.books):
        raise BadHeaderError("residue groupbook out of range")
    for b in booklist:
        if b >= len(vi.books):
            raise BadHeaderError("residue book out of range")
        if vi.books[b].sb.maptype == 0:
            raise BadHeaderError("residue book has no values")
    gb = vi.books[groupbook]
    if gb.dim < 1:
        raise BadHeaderError("bad groupbook dim")
    partvals = 1
    for _ in range(gb.dim):
        partvals *= partitions
        if partvals > gb.entries:
            raise BadHeaderError("impossible residue partitioning")
    info = ResidueInfo(restype, begin, end, grouping, partitions,
                       groupbook, secondstages, booklist)
    info.partvals = partvals
    return info


def _pack_residue(w: BitWriter, info: ResidueInfo) -> None:
    w.write(info.begin, 24)
    w.write(info.end, 24)
    w.write(info.grouping - 1, 24)
    w.write(info.partitions - 1, 6)
    w.write(info.groupbook, 8)
    for c in info.secondstages:
        if ilog(c) > 3:
            w.write(c & 7, 3)
            w.write(1, 1)
            w.write(c >> 3, 5)
        else:
            w.write(c, 4)
    for b in info.booklist:
        w.write(b, 8)


def _unpack_mapping(r: BitReader, vi: VorbisInfo) -> MappingInfo:
    ch = vi.channels
    submaps = (r.read(4) + 1) if r.read1() else 1
    mags, angs = [], []
    if r.read1():
        steps = r.read(8) + 1
        bits = ilog(ch - 1)
        for _ in range(steps):
            m = r.read(bits)
            a = r.read(bits)
            if m == a or m >= ch or a >= ch:
                raise BadHeaderError("bad coupling pair")
            mags.append(m)
            angs.append(a)
    if r.read(2) != 0:
        raise BadHeaderError("nonzero mapping reserved bits")
    if submaps > 1:
        chmux = [r.read(4) for _ in range(ch)]
        for m in chmux:
            if m >= submaps:
                raise BadHeaderError("bad chmux")
    else:
        chmux = [0] * ch
    floorsub, ressub = [], []
    for _ in range(submaps):
        r.read(8)  # unused time submap
        f = r.read(8)
        if f >= len(vi.floors):
            raise BadHeaderError("mapping floor out of range")
        rs = r.read(8)
        if rs >= len(vi.residues):
            raise BadHeaderError("mapping residue out of range")
        floorsub.append(f)
        ressub.append(rs)
    return MappingInfo(submaps, mags, angs, chmux, floorsub, ressub)


def _pack_mapping(w: BitWriter, info: MappingInfo, channels: int) -> None:
    if info.submaps > 1:
        w.write(1, 1)
        w.write(info.submaps - 1, 4)
    else:
        w.write(0, 1)
    if info.coupling_steps > 0:
        w.write(1, 1)
        w.write(info.coupling_steps - 1, 8)
        bits = ilog(channels - 1)
        for m, a in zip(info.coupling_mag, info.coupling_ang):
            w.write(m, bits)
            w.write(a, bits)
    else:
        w.write(0, 1)
    w.write(0, 2)
    if info.submaps > 1:
        for c in range(channels):
            w.write(info.chmuxlist[c], 4)
    for s in range(info.submaps):
        w.write(0, 8)
        w.write(info.floorsubmap[s], 8)
        w.write(info.residuesubmap[s], 8)


def parse_setup_header(packet: bytes, vi: VorbisInfo) -> None:
    r = BitReader(packet)
    _check_header_prefix(r, 5)
    nbooks = r.read(8) + 1
    vi.static_books = [StaticCodebook.unpack(r) for _ in range(nbooks)]
    vi.books = [Codebook(sb) for sb in vi.static_books]
    # time backends (placeholder zeros)
    ntimes = r.read(6) + 1
    for _ in range(ntimes):
        if r.read(16) != 0:
            raise BadHeaderError("nonzero time backend")
    nfloors = r.read(6) + 1
    vi.floor_types, vi.floors = [], []
    for _ in range(nfloors):
        t = r.read(16)
        vi.floor_types.append(t)
        if t == 0:
            vi.floors.append(_unpack_floor0(r, vi))
        elif t == 1:
            vi.floors.append(_unpack_floor1(r, vi))
        else:
            raise BadHeaderError(f"bad floor type {t}")
    nres = r.read(6) + 1
    vi.residue_types, vi.residues = [], []
    for _ in range(nres):
        t = r.read(16)
        if t not in (0, 1, 2):
            raise BadHeaderError(f"bad residue type {t}")
        vi.residue_types.append(t)
        vi.residues.append(_unpack_residue(r, vi, t))
    nmaps = r.read(6) + 1
    vi.maps = []
    for _ in range(nmaps):
        if r.read(16) != 0:
            raise BadHeaderError("bad mapping type")
        vi.maps.append(_unpack_mapping(r, vi))
    nmodes = r.read(6) + 1
    vi.modes = []
    for _ in range(nmodes):
        m = ModeInfo(r.read1(), r.read(16), r.read(16), r.read(8))
        if m.windowtype != 0 or m.transformtype != 0 or m.mapping >= nmaps:
            raise BadHeaderError("bad mode")
        vi.modes.append(m)
    if r.read1() != 1:
        raise BadHeaderError("missing framing bit")


def parse_headers(packets: list) -> VorbisInfo:
    """Parse the 3 header packets in sequence."""
    if len(packets) < 3:
        raise BadHeaderError(
            f"need 3 header packets, got {len(packets)} (OV_EBADHEADER)")
    vi = parse_id_header(packets[0])
    parse_comment_header(packets[1], vi)
    parse_setup_header(packets[2], vi)
    return vi


# ---- encode side -----------------------------------------------------------

def pack_id_header(vi: VorbisInfo) -> bytes:
    w = BitWriter()
    w.write(1, 8)
    w.write_bytes(b"vorbis")
    w.write(0, 32)
    w.write(vi.channels, 8)
    w.write(vi.rate, 32)
    w.write(vi.bitrate_upper & 0xFFFFFFFF, 32)
    w.write(vi.bitrate_nominal & 0xFFFFFFFF, 32)
    w.write(vi.bitrate_lower & 0xFFFFFFFF, 32)
    w.write(ilog(vi.blocksizes[0]) - 1, 4)
    w.write(ilog(vi.blocksizes[1]) - 1, 4)
    w.write(1, 1)
    return w.getvalue()


def pack_comment_header(vi: VorbisInfo) -> bytes:
    w = BitWriter()
    w.write(3, 8)
    w.write_bytes(b"vorbis")
    vend = vi.vendor.encode("utf-8")
    w.write(len(vend), 32)
    w.write_bytes(vend)
    w.write(len(vi.comments), 32)
    for c in vi.comments:
        cb = c.encode("utf-8")
        w.write(len(cb), 32)
        w.write_bytes(cb)
    w.write(1, 1)
    return w.getvalue()


def pack_setup_header(vi: VorbisInfo) -> bytes:
    w = BitWriter()
    w.write(5, 8)
    w.write_bytes(b"vorbis")
    w.write(len(vi.static_books) - 1, 8)
    for sb in vi.static_books:
        sb.pack(w)
    w.write(0, 6)   # one time backend
    w.write(0, 16)
    w.write(len(vi.floors) - 1, 6)
    for t, fl in zip(vi.floor_types, vi.floors):
        w.write(t, 16)
        if t == 1:
            _pack_floor1(w, fl)
        else:
            _pack_floor0(w, fl)
    w.write(len(vi.residues) - 1, 6)
    for t, res in zip(vi.residue_types, vi.residues):
        w.write(t, 16)
        _pack_residue(w, res)
    w.write(len(vi.maps) - 1, 6)
    for m in vi.maps:
        w.write(0, 16)
        _pack_mapping(w, m, vi.channels)
    w.write(len(vi.modes) - 1, 6)
    for m in vi.modes:
        w.write(m.blockflag, 1)
        w.write(m.windowtype, 16)
        w.write(m.transformtype, 16)
        w.write(m.mapping, 8)
    w.write(1, 1)
    return w.getvalue()
