"""Lattice codebook construction and tuning (reference:
vq/latticebuild.c, vq/latticetune.c).

latticebuild: given per-dimension quantized levels, produce a
maptype-1 static codebook (the cartesian-product lattice whose entry
values are `minval + delta * seq` per sharedbook.c _book_unquantize).

latticetune: assign Huffman lengths to lattice entries from their hit
counts on training data (each vector mapped to its nearest entry —
batched distance matmul instead of the scalar scan)."""

from __future__ import annotations

import numpy as np

from ..codec.codebook import StaticCodebook
from .huffbuild import huffbuild


def latticebuild(quantlist: np.ndarray, dim: int, minval: float,
                 delta: float, sequencep: int = 0) -> StaticCodebook:
    """Build a maptype-1 lattice book.  quantlist holds the quantized
    per-dimension level codes (ints >= 0); entries = len(quantlist)^dim
    with values unquantized like sharedbook.c:216."""
    quantlist = np.asarray(quantlist, np.int64)
    quantvals = len(quantlist)
    entries = quantvals ** dim
    sb = StaticCodebook(
        dim=dim, entries=entries,
        lengthlist=np.ones(entries, np.int64),
        maptype=1,
        q_min=_float32_pack(minval), q_delta=_float32_pack(delta),
        q_quant=int(max(1, np.ceil(np.log2(max(int(quantlist.max()), 1)
                                           + 1)))),
        q_sequencep=sequencep,
        quantlist=quantlist)
    return sb


def _float32_pack(v: float) -> int:
    """sharedbook.c:51 _float32_pack: Vorbis packed float
    (sign | (exp+768)<<21 | 21-bit mantissa)."""
    import math
    sign = 0
    if v < 0:
        sign = 0x80000000
        v = -v
    if v == 0:
        return 0
    exp = int(math.floor(math.log2(v) + 0.001))
    mant = int(round(v * 2.0 ** (20 - exp)))
    while mant >= (1 << 21):       # rint overflow guard
        mant >>= 1
        exp += 1
    return sign | (((exp + 768) & 0x3FF) << 21) | (mant & 0x1FFFFF)


def latticetune(sb: StaticCodebook, training: np.ndarray,
                guard: int = 1) -> StaticCodebook:
    """Assign Huffman lengths from nearest-entry hit counts
    (latticetune.c main loop, vectorized: the (points x entries)
    distances are one matmul)."""
    from .vqgen import _pairwise_sq
    values = sb.unquantize()
    assert values is not None, "lattice book must carry values"
    pts = np.asarray(training, np.float32)
    hits = np.full(sb.entries, guard, np.int64)
    B = 65536
    for i in range(0, len(pts), B):
        d = _pairwise_sq(pts[i:i + B], values, np)
        a = np.argmin(d, axis=1)
        hits += np.bincount(a, minlength=sb.entries)
        hits -= 0  # keep guard floor
    lengths = huffbuild(hits)
    lengths[lengths == 0] = 1  # lattice books keep every entry codable
    out = StaticCodebook(
        dim=sb.dim, entries=sb.entries, lengthlist=lengths,
        maptype=sb.maptype, q_min=sb.q_min, q_delta=sb.q_delta,
        q_quant=sb.q_quant, q_sequencep=sb.q_sequencep,
        quantlist=sb.quantlist)
    return out
