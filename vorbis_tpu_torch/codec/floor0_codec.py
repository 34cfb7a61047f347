"""Floor 0 (LSP spectral envelope) decode — legacy floor used by old
encoders; our encoder never emits it but the decoder must accept it
(reference: lib/floor0.c + lib/lsp.c vorbis_lsp_to_curve, the
non-lookup float variant lsp.c:248-281, which is what the reference
builds: FLOAT_LOOKUP/INT_LOOKUP are #undef'd at lsp.c:56-57).

Copy of vorbis_tpu/codec/floor0_codec.py, kept line-aligned with it:
the port's scalar decoder (codec/decoder.py) and the floor0 tables of
the host-C parse (codec/nativeparse.py) read it."""

from __future__ import annotations

import math

import numpy as np

from ..bitstream.bitpack import BitReader, EndOfPacket, ilog
from .headers import Floor0Info

f32 = np.float32


def _toBARK(n: float) -> float:
    """scales.h:78 toBARK macro with a float argument (double math on
    f32-rounded products, like the C expression)."""
    nf = float(f32(n))
    return (13.1 * math.atan(float(f32(0.00074 * nf)))
            + 2.24 * math.atan(float(f32(nf * nf * 1.85e-8)))
            + 1e-4 * nf)


class Floor0Look:
    """Lazy per-blocksize bark linearmap (reference:
    floor0_map_lazy_init, floor0.c:113-143)."""

    def __init__(self, info: Floor0Info):
        self.info = info
        self.m = info.order
        self.ln = info.barkmap
        self.linearmap = {}   # n -> int32 map of length n+1

    def get_map(self, n: int) -> np.ndarray:
        mp = self.linearmap.get(n)
        if mp is not None:
            return mp
        info = self.info
        # float scale = look->ln / toBARK(info->rate/2.f)
        scale = float(f32(self.ln / _toBARK(info.rate / 2.0)))
        half = float(f32(info.rate / 2.0))
        mp = np.empty(n + 1, np.int64)
        for j in range(n):
            # (int)floor( toBARK((rate/2.f)/n*j) * scale )
            arg = float(f32(f32(half / n) * j))
            val = int(math.floor(_toBARK(arg) * scale))
            if val >= self.ln:
                val = self.ln - 1
            mp[j] = val
        mp[n] = -1
        self.linearmap[n] = mp
        return mp


def decode_floor0(r: BitReader, look: Floor0Look, books):
    """floor0_inverse1 (floor0.c:162-198): returns the LSP memo
    (m coefficients + amp) or None."""
    info = look.info
    try:
        ampraw = r.read(info.ampbits)
    except EndOfPacket:
        return None
    if ampraw <= 0:
        return None
    maxval = (1 << info.ampbits) - 1
    amp = float(f32(f32(ampraw / maxval) * info.ampdB))
    try:
        booknum = r.read(ilog(len(info.books)))
    except EndOfPacket:
        return None
    if booknum >= len(info.books):
        return None
    b = books[info.books[booknum]]
    m = look.m
    lsp = np.zeros(m + int(b.dim) + 1, np.float32)
    # vorbis_book_decodev_set: sequential vector decode, then per-group
    # cumulative "last" add
    try:
        i = 0
        while i < m:
            v = b.decode_vector(r)
            lsp[i:i + len(v)] = v
            i += len(v)
    except EndOfPacket:
        return None
    last = f32(0.0)
    j = 0
    while j < m:
        for _ in range(int(b.dim)):
            if j >= m:
                break
            lsp[j] = f32(lsp[j] + last)
            j += 1
        last = lsp[j - 1]
    out = np.empty(m + 1, np.float32)
    out[:m] = lsp[:m]
    out[m] = amp
    return out


def floor0_curve(memo: np.ndarray, look: Floor0Look, n: int) -> np.ndarray:
    """floor0_inverse2 + vorbis_lsp_to_curve (lsp.c:248-281): render
    the LSP envelope multiplier curve of length n (float32-exact)."""
    info = look.info
    m = look.m
    amp = float(memo[m])
    ampoffset = float(info.ampdB)
    mp = look.get_map(n)
    wdel = float(f32(math.pi / look.ln))
    lsp = np.array([f32(2.0 * math.cos(float(v))) for v in memo[:m]],
                   np.float32)
    curve = np.ones(n, np.float32)
    i = 0
    while i < n:
        k = int(mp[i])
        p = f32(0.5)
        q = f32(0.5)
        # C: 2.f*cos(wdel*k) — wdel*k is a float multiply, cos double
        w = f32(2.0 * math.cos(float(f32(wdel * k))))
        j = 1
        while j < m:
            q = f32(q * f32(w - lsp[j - 1]))
            p = f32(p * f32(w - lsp[j]))
            j += 2
        if j == m:
            # odd order
            q = f32(q * f32(w - lsp[j - 1]))
            p = f32(p * f32(p * f32(4.0 - f32(w * w))))
            q = f32(q * q)
        else:
            p = f32(p * f32(p * f32(2.0 - w)))
            q = f32(q * f32(q * f32(2.0 + w)))
        # q = fromdB(amp/sqrt(p+q) - ampoffset): p+q is a FLOAT add,
        # the rest is double; fromdB is exp(x*.11512925f) in double,
        # stored once to float.  p+q is always >= 0 (both end as
        # squares times nonnegative factors); p+q == 0 divides to
        # +inf in C (amp > 0 here), which exp carries to +inf.
        pq = float(f32(p + q))
        if pq > 0.0:
            val = amp / math.sqrt(pq) - ampoffset
        else:
            val = math.inf
        try:
            ev = math.exp(val * float(f32(0.11512925)))
        except OverflowError:           # C exp() overflows to inf
            ev = math.inf
        with np.errstate(over="ignore"):
            qv = f32(ev)                # may round to inf like C
        curve[i] = f32(curve[i] * qv)
        i += 1
        while i < n and int(mp[i]) == k:
            curve[i] = f32(curve[i] * qv)
            i += 1
    return curve
