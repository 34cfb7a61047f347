"""Floor 1 bit codec + curve synthesis.

Decode side (reference: lib/floor1.c floor1_inverse1/floor1_inverse2,
render_point/render_line): unpack wrapped post deltas via class/subclass
Huffman books, reconstruct posts by neighbor prediction, then render the
piecewise-linear curve with an integer DDA into dB-lookup gains.

The curve render here is closed-form vectorized: for a segment the DDA
y value at step k is y0 + trunc(dy/adx)*k + sign(dy)*floor(k*ady'/adx),
which reproduces the reference's incremental error accumulator exactly
in integer math (so the decode stays bit-exact end to end).

Copy of the decode half of vorbis_tpu/codec/floor1_codec.py (:1-162),
kept line-aligned with it; the scalar encoder's fit and pack stay behind.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from ..bitstream.bitpack import BitReader, EndOfPacket, ilog
from .headers import Floor1Info

_DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@lru_cache(maxsize=1)
def fromdB_lookup() -> np.ndarray:
    return np.load(os.path.join(_DATA, "floor_tables.npz"))["fromdB_lookup"]


QUANT_Q = {1: 256, 2: 128, 3: 86, 4: 64}


class Floor1Look:
    """Precomputed sort order and prediction neighbors for a floor1
    config (reference: floor1_look)."""

    def __init__(self, info: Floor1Info):
        self.info = info
        post = np.array(info.postlist, dtype=np.int64)
        n = len(post)
        self.posts = n
        self.n = info.postlist[1]
        self.quant_q = QUANT_Q[info.mult]
        self.forward_index = np.argsort(post, kind="stable").astype(np.int64)
        self.sorted_x = post[self.forward_index]
        lo = np.zeros(n - 2, dtype=np.int64)
        hi = np.ones(n - 2, dtype=np.int64)
        for i in range(n - 2):
            lx, hx = 0, self.n
            cx = post[i + 2]
            for j in range(i + 2):
                x = post[j]
                if lx < x < cx:
                    lo[i], lx = j, x
                if cx < x < hx:
                    hi[i], hx = j, x
        self.loneighbor = lo
        self.hineighbor = hi


def render_point(x0: int, x1: int, y0: int, y1: int, x: int) -> int:
    y0 &= 0x7FFF
    y1 &= 0x7FFF
    dy = y1 - y0
    adx = x1 - x0
    err = abs(dy) * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def decode_floor1(r: BitReader, look: Floor1Look, books) -> np.ndarray | None:
    """Decode one channel's floor posts.  Returns int array of posts
    (bit 15 set = unused/interpolated post) or None (unused channel)."""
    info = look.info
    try:
        if not r.read1():
            return None
        qbits = ilog(look.quant_q - 1)
        fit = np.zeros(look.posts, dtype=np.int64)
        fit[0] = r.read(qbits)
        fit[1] = r.read(qbits)
        j = 2
        for i in range(info.partitions):
            cls = info.partitionclass[i]
            cdim = info.class_dim[cls]
            csubbits = info.class_subs[cls]
            csub = 1 << csubbits
            cval = 0
            if csubbits:
                cval = books[info.class_book[cls]].decode(r)
            for k in range(cdim):
                book = info.class_subbook[cls][cval & (csub - 1)]
                cval >>= csubbits
                fit[j + k] = books[book].decode(r) if book >= 0 else 0
            j += cdim
    except EndOfPacket:
        return None
    # unwrap predicted deltas
    for i in range(2, look.posts):
        lo_i = look.loneighbor[i - 2]
        hi_i = look.hineighbor[i - 2]
        predicted = render_point(info.postlist[lo_i], info.postlist[hi_i],
                                 int(fit[lo_i]), int(fit[hi_i]),
                                 info.postlist[i])
        hiroom = look.quant_q - predicted
        loroom = predicted
        room = min(hiroom, loroom) << 1
        val = int(fit[i])
        if val:
            if val >= room:
                val = (val - loroom) if hiroom > loroom else (-1 - (val - hiroom))
            else:
                val = -((val + 1) >> 1) if (val & 1) else (val >> 1)
            fit[i] = (val + predicted) & 0x7FFF
            fit[lo_i] &= 0x7FFF
            fit[hi_i] &= 0x7FFF
        else:
            fit[i] = predicted | 0x8000
    return fit


def render_floor_indices(fit: np.ndarray, look: Floor1Look, n: int) -> np.ndarray:
    """Render quantized-dB indices (0..255) for bins [0, n) from decoded
    posts — exact integer DDA, vectorized per segment."""
    info = look.info
    mult = info.mult
    out = np.zeros(n, dtype=np.int64)
    lx = 0
    ly = int(fit[0]) * mult
    ly = min(255, max(0, ly))
    hx = 0
    for j in range(1, look.posts):
        current = int(look.forward_index[j])
        hy = int(fit[current]) & 0x7FFF
        if hy == fit[current]:  # step flag not set -> used post
            hx = info.postlist[current]
            hy = min(255, max(0, hy * mult))
            # render_line(n, lx, hx, ly, hy, out)
            dy = hy - ly
            adx = hx - lx
            # C integer division truncates toward zero
            base = (dy // adx) if dy >= 0 else -((-dy) // adx)
            ady = abs(dy) - abs(base) * adx
            end = min(n, hx)
            if lx < n:
                out[lx] = ly
            if end > lx + 1:
                k = np.arange(1, end - lx, dtype=np.int64)
                s = 1 if dy >= 0 else -1
                out[lx + 1:end] = ly + base * k + s * ((k * ady) // adx)
            lx, ly = hx, hy
    if hx < n:
        out[hx:] = ly
    return out


def floor1_curve(fit: np.ndarray, look: Floor1Look, n: int) -> np.ndarray:
    """Float32 gain curve = fromdB lookup of the rendered indices."""
    return fromdB_lookup()[render_floor_indices(fit, look, n)]
