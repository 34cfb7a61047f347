"""FFTPACK-style real FFT used for tone-estimation analysis
(reference: lib/smallft.c drft_forward / drftf1 / dradf2 / dradf4 /
drfti1).

The encoder's tone mask feeds off the *exact* float32 spectrum this
transform produces (Fortran-order packing: [dc, re1, im1, re2, im2,
..., nyquist]), so the radix passes here reproduce the reference's
float32 op order element-by-element while staying vectorized over a
frame batch (power-of-2 sizes use only radix-4 and radix-2 passes).

Copy of vorbis_tpu/ops/rdft.py, kept line-aligned with it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

f32 = np.float32
HSQT2 = f32(0.70710678118654752)


@lru_cache(maxsize=None)
def _drft_tables(n: int):
    """Factorization + float32 twiddles (reference: drfti1)."""
    # factor n into 4s then a leading 2 (power-of-2 sizes)
    nl = n
    factors = []
    for ntry in (4, 2, 3, 5):
        while nl % ntry == 0:
            factors.append(ntry)
            nl //= ntry
            if ntry == 2 and len(factors) > 1:
                factors = [2] + factors[:-1]
        if nl == 1:
            break
    assert nl == 1, f"unsupported drft size {n}"
    tpi = float(f32(6.28318530717958648))
    argh = f32(tpi / n)
    wa = np.zeros(n, np.float32)
    is_ = 0
    l1 = 1
    for k1 in range(len(factors) - 1):
        ip = factors[k1]
        ld = 0
        l2 = l1 * ip
        ido = n // l2
        for j in range(ip - 1):
            ld += l1
            i = is_
            argld = f32(np.float32(ld) * argh)
            fi = f32(0.0)
            for ii in range(2, ido, 2):
                fi = f32(fi + 1.0)
                arg = f32(fi * argld)
                wa[i] = f32(np.cos(np.float64(arg)))
                wa[i + 1] = f32(np.sin(np.float64(arg)))
                i += 2
            is_ += ido
        l1 = l2
    return factors, wa


def _dradf2(ido, l1, cc, ch, wa1):
    """cc, ch: (..., n) float32; wa1: float32 twiddles (offset view)."""
    t0 = l1 * ido
    k = np.arange(l1)
    t1 = k * ido
    t2 = t0 + k * ido
    ch[..., t1 << 1] = cc[..., t1] + cc[..., t2]
    ch[..., (t1 << 1) + (ido << 1) - 1] = cc[..., t1] - cc[..., t2]
    if ido < 2:
        return
    if ido > 2:
        i = np.arange(2, ido, 2)
        for kk in range(l1):
            b1 = kk * ido
            t3 = t0 + b1 + i
            t4 = (b1 << 1) + (ido << 1) - i
            t5 = b1 + i
            t6 = 2 * b1 + i
            tr2 = (wa1[i - 2] * cc[..., t3 - 1]
                   + wa1[i - 1] * cc[..., t3]).astype(np.float32)
            ti2 = (wa1[i - 2] * cc[..., t3]
                   - wa1[i - 1] * cc[..., t3 - 1]).astype(np.float32)
            ch[..., t6] = cc[..., t5] + ti2
            ch[..., t4] = ti2 - cc[..., t5]
            ch[..., t6 - 1] = cc[..., t5 - 1] + tr2
            ch[..., t4 - 1] = cc[..., t5 - 1] - tr2
        if ido % 2 == 1:
            return
    t1 = ido + k * (ido << 1)
    t2 = ido - 1 + t0 + k * ido
    t3 = ido - 1 + k * ido
    ch[..., t1] = -cc[..., t2]
    ch[..., t1 - 1] = cc[..., t3]


def _dradf4(ido, l1, cc, ch, wa1, wa2, wa3):
    t0 = l1 * ido
    k = np.arange(l1)
    t1 = t0 + k * ido
    t2 = 3 * t0 + k * ido
    t3 = k * ido
    t4 = 2 * t0 + k * ido
    tr1 = (cc[..., t1] + cc[..., t2]).astype(np.float32)
    tr2 = (cc[..., t3] + cc[..., t4]).astype(np.float32)
    t5 = t3 << 2
    ch[..., t5] = tr1 + tr2
    ch[..., (ido << 2) + t5 - 1] = tr2 - tr1
    t5b = t5 + (ido << 1)
    ch[..., t5b - 1] = cc[..., t3] - cc[..., t4]
    ch[..., t5b] = cc[..., t2] - cc[..., t1]

    if ido < 2:
        return
    if ido > 2:
        i = np.arange(2, ido, 2)
        for kk in range(l1):
            t1b = kk * ido
            t2v = t1b + i
            t4v = (t1b << 2) + i
            t6 = ido << 1
            t5v = t6 + (t1b << 2) - i + 2
            # t5 starts at (ido<<1)+(t1<<2) then -=2 per i step; at
            # i=2: t5 = t6+t4start... replicate: t5 = t6+(t1<<2)+2-...
            t5v = (t6 + (t1b << 2)) - (i - 2) - 2
            t3v = t2v + t0
            cr2 = (wa1[i - 2] * cc[..., t3v - 1]
                   + wa1[i - 1] * cc[..., t3v]).astype(np.float32)
            ci2 = (wa1[i - 2] * cc[..., t3v]
                   - wa1[i - 1] * cc[..., t3v - 1]).astype(np.float32)
            t3v = t3v + t0
            cr3 = (wa2[i - 2] * cc[..., t3v - 1]
                   + wa2[i - 1] * cc[..., t3v]).astype(np.float32)
            ci3 = (wa2[i - 2] * cc[..., t3v]
                   - wa2[i - 1] * cc[..., t3v - 1]).astype(np.float32)
            t3v = t3v + t0
            cr4 = (wa3[i - 2] * cc[..., t3v - 1]
                   + wa3[i - 1] * cc[..., t3v]).astype(np.float32)
            ci4 = (wa3[i - 2] * cc[..., t3v]
                   - wa3[i - 1] * cc[..., t3v - 1]).astype(np.float32)
            tr1 = (cr2 + cr4).astype(np.float32)
            tr4 = (cr4 - cr2).astype(np.float32)
            ti1 = (ci2 + ci4).astype(np.float32)
            ti4 = (ci2 - ci4).astype(np.float32)
            ti2 = (cc[..., t2v] + ci3).astype(np.float32)
            ti3 = (cc[..., t2v] - ci3).astype(np.float32)
            tr2 = (cc[..., t2v - 1] + cr3).astype(np.float32)
            tr3 = (cc[..., t2v - 1] - cr3).astype(np.float32)
            ch[..., t4v - 1] = tr1 + tr2
            ch[..., t4v] = ti1 + ti2
            ch[..., t5v - 1] = tr3 - ti4
            ch[..., t5v] = tr4 - ti3
            ch[..., t4v + t6 - 1] = ti4 + tr3
            ch[..., t4v + t6] = tr4 + ti3
            ch[..., t5v + t6 - 1] = tr2 - tr1
            ch[..., t5v + t6] = ti1 - ti2
        if ido & 1:
            return
    t1 = t0 + ido - 1 + k * ido
    t2 = t1 + (t0 << 1)
    t4 = ido + k * (ido << 2)
    t6 = ido - 1 + k * ido
    t5 = ido << 1
    ti1 = (-HSQT2 * (cc[..., t1] + cc[..., t2])).astype(np.float32)
    tr1 = (HSQT2 * (cc[..., t1] - cc[..., t2])).astype(np.float32)
    ch[..., t4 - 1] = tr1 + cc[..., t6]
    ch[..., t4 + t5 - 1] = cc[..., t6] - tr1
    ch[..., t4] = ti1 - cc[..., t1 + t0]
    ch[..., t4 + t5] = ti1 + cc[..., t1 + t0]


def drft_forward(data, n: int, xp=np):
    """Batched forward real FFT, FFTPACK packing, float32-exact vs the
    reference.  data: (..., n) float32 -> (..., n)."""
    factors, wa = _drft_tables(n)
    nf = len(factors)
    c = np.array(data, dtype=np.float32, copy=True)
    ch = np.empty_like(c)
    na = 1
    l2 = n
    iw = n
    for k1 in range(nf):
        ip = factors[nf - 1 - k1]
        l1 = l2 // ip
        ido = n // l2
        iw -= (ip - 1) * ido
        na = 1 - na
        if ip == 4:
            ix2 = iw + ido
            ix3 = ix2 + ido
            if na != 0:
                _dradf4(ido, l1, ch, c, wa[iw - 1:], wa[ix2 - 1:],
                        wa[ix3 - 1:])
            else:
                _dradf4(ido, l1, c, ch, wa[iw - 1:], wa[ix2 - 1:],
                        wa[ix3 - 1:])
        elif ip == 2:
            if na == 0:
                _dradf2(ido, l1, c, ch, wa[iw - 1:])
            else:
                _dradf2(ido, l1, ch, c, wa[iw - 1:])
        else:
            raise NotImplementedError("only radix 2/4 (power-of-2 sizes)")
        l2 = l1
    if na == 1:
        return c
    return ch
