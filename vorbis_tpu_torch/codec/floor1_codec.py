"""Floor 1 bit codec + curve synthesis.

Decode side (reference: lib/floor1.c floor1_inverse1/floor1_inverse2,
render_point/render_line): unpack wrapped post deltas via class/subclass
Huffman books, reconstruct posts by neighbor prediction, then render the
piecewise-linear curve with an integer DDA into dB-lookup gains.

The curve render here is closed-form vectorized: for a segment the DDA
y value at step k is y0 + trunc(dy/adx)*k + sign(dy)*floor(k*ady'/adx),
which reproduces the reference's incremental error accumulator exactly
in integer math (so the decode stays bit-exact end to end).

Copy of vorbis_tpu/codec/floor1_codec.py, kept line-aligned with it:
the decode half, and the encode half (floor1_fit,
floor1_interpolate_fit, floor1_encode with its TRAIN_FLOOR1 hook into
the port's vq/training.py) that the port's golden encoder runs.
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


# ---------------------------------------------------------------------------
# encode side (reference: floor1.c floor1_fit / floor1_interpolate_fit /
# floor1_encode)
# ---------------------------------------------------------------------------

f32 = np.float32


def dBquant(x) -> int:
    """int(x*7.3142857f+1023.5f) clamped to [0,1023] (float32 math)."""
    i = int(f32(f32(x) * f32(7.3142857) + f32(1023.5)))
    if i > 1023:
        return 1023
    if i < 0:
        return 0
    return i


def dBquant_vec(x: np.ndarray) -> np.ndarray:
    v = (x.astype(np.float32) * f32(7.3142857) + f32(1023.5)).astype(
        np.int64)
    return np.clip(v, 0, 1023)


class _FitAcc:
    __slots__ = ("x0", "x1", "xa", "ya", "x2a", "y2a", "xya", "an",
                 "xb", "yb", "x2b", "y2b", "xyb", "bn")


def _accumulate_fit(flr, mdct, x0, x1, n, info, quant, above):
    """One lsfit_acc for [x0, x1] using precomputed dB quantization and
    above-floor mask (vectorized)."""
    a = _FitAcc()
    a.x0 = x0
    a.x1 = x1
    hi = min(x1, n - 1)
    i = np.arange(x0, hi + 1)
    q = quant[x0:hi + 1]
    used = q != 0
    am = used & above[x0:hi + 1]
    bm = used & ~above[x0:hi + 1]
    ia = i[am]
    qa = q[am]
    ib = i[bm]
    qb = q[bm]
    a.xa = int(ia.sum())
    a.ya = int(qa.sum())
    a.x2a = int((ia * ia).sum())
    a.y2a = int((qa * qa).sum())
    a.xya = int((ia * qa).sum())
    a.an = len(ia)
    a.xb = int(ib.sum())
    a.yb = int(qb.sum())
    a.x2b = int((ib * ib).sum())
    a.y2b = int((qb * qb).sum())
    a.xyb = int((ib * qb).sum())
    a.bn = len(ib)
    return a


def _fit_line(accs, y0, y1, info):
    """Weighted two-class least squares; returns (y0, y1, degenerate)."""
    xb = yb = x2b = y2b = xyb = bn = 0.0
    x0 = accs[0].x0
    x1 = accs[-1].x1
    tw = f32(info.twofitweight)
    for a in accs:
        # C: (a->bn+a->an)*info->twofitweight/(a->an+1)+1.
        # int*float and float/int stay f32; only the +1. is double.
        weight = float(f32(f32((a.bn + a.an) * tw) / f32(a.an + 1))) + 1.0
        xb += a.xb + a.xa * weight
        yb += a.yb + a.ya * weight
        x2b += a.x2b + a.x2a * weight
        y2b += a.y2b + a.y2a * weight
        xyb += a.xyb + a.xya * weight
        bn += a.bn + a.an * weight
    if y0 >= 0:
        xb += x0
        yb += y0
        x2b += x0 * x0
        y2b += y0 * y0
        xyb += y0 * x0
        bn += 1
    if y1 >= 0:
        xb += x1
        yb += y1
        x2b += x1 * x1
        y2b += y1 * y1
        xyb += y1 * x1
        bn += 1
    denom = bn * x2b - xb * xb
    if denom > 0.0:
        av = (yb * x2b - xyb * xb) / denom
        bv = (bn * xyb - xb * yb) / denom
        ny0 = int(np.rint(av + bv * x0))
        ny1 = int(np.rint(av + bv * x1))
        ny0 = min(max(ny0, 0), 1023)
        ny1 = min(max(ny1, 0), 1023)
        return ny0, ny1, 0
    return 0, 0, 1


def _inspect_error(x0, x1, y0, y1, quant, above, info, n_unused):
    """Error-bound check over a rendered segment (reference:
    inspect_error) using the closed-form integer DDA."""
    dy = y1 - y0
    adx = x1 - x0
    base = (dy // adx) if dy >= 0 else -((-dy) // adx)
    ady = abs(dy) - abs(base) * adx
    k = np.arange(x1 - x0)
    s = 1 if dy >= 0 else -1
    y = y0 + base * k + s * ((k * ady) // adx)
    val = quant[x0:x1]
    mse = int(((y - val) * (y - val)).sum())
    cnt = x1 - x0
    ab = above[x0:x1]
    used = val != 0
    used[0] = True  # first sample checked regardless of val
    chk = ab & used
    maxover = info.maxover
    maxunder = info.maxunder
    if np.any((y[chk] + maxover < val[chk])
              | (y[chk] - maxunder > val[chk])):
        return 1
    # C: info->maxover*info->maxover/n — float mul and float/int div
    if f32(f32(f32(maxover) * f32(maxover)) / f32(cnt)) > f32(info.maxerr):
        return 0
    if f32(f32(f32(maxunder) * f32(maxunder)) / f32(cnt)) > f32(info.maxerr):
        return 0
    if mse // cnt > info.maxerr:  # C int division
        return 1
    return 0


def _post_Y(A, B, pos):
    if A[pos] < 0:
        return B[pos]
    if B[pos] < 0:
        return A[pos]
    return (A[pos] + B[pos]) >> 1


def floor1_fit(look: Floor1Look, logmdct, logmask):
    """Greedy floor post fitting (reference: floor1_fit).  Returns an
    int post array (bit 15 set = interpolated) or None (unused)."""
    info = look.info
    n = look.n  # = postlist[1] (the fit domain)
    posts = look.posts
    quant = dBquant_vec(logmask)
    above = (logmdct + f32(info.twofitatten)) >= logmask

    fits = []
    nonzero = 0
    for i in range(posts - 1):
        a = _accumulate_fit(logmask, logmdct, int(look.sorted_x[i]),
                            int(look.sorted_x[i + 1]), n, info, quant,
                            above)
        nonzero += a.an
        fits.append(a)
    if not nonzero:
        return None

    fitA = [-200] * posts
    fitB = [-200] * posts
    loneighbor = [0] * posts
    hineighbor = [1] * posts
    memo = [-1] * posts

    y0, y1, _ = _fit_line(fits[0:posts - 1], -200, -200, info)
    fitA[0] = fitB[0] = y0
    fitA[1] = fitB[1] = y1

    reverse_index = np.argsort(look.forward_index, kind="stable")
    for i in range(2, posts):
        sortpos = int(reverse_index[i])
        ln = loneighbor[sortpos]
        hn = hineighbor[sortpos]
        if memo[ln] == hn:
            continue
        lsortpos = int(reverse_index[ln])
        hsortpos = int(reverse_index[hn])
        memo[ln] = hn
        lx = info.postlist[ln]
        hx = info.postlist[hn]
        ly = _post_Y(fitA, fitB, ln)
        hy = _post_Y(fitA, fitB, hn)
        if _inspect_error(lx, hx, ly, hy, quant, above, info, n):
            ly0, ly1, ret0 = _fit_line(fits[lsortpos:sortpos], -200, -200,
                                       info)
            hy0, hy1, ret1 = _fit_line(fits[sortpos:hsortpos], -200, -200,
                                       info)
            if ret0:
                ly0 = ly
                ly1 = hy0
            if ret1:
                hy0 = ly1
                hy1 = hy
            if ret0 and ret1:
                fitA[i] = -200
                fitB[i] = -200
            else:
                fitB[ln] = ly0
                if ln == 0:
                    fitA[ln] = ly0
                fitA[i] = ly1
                fitB[i] = hy0
                fitA[hn] = hy1
                if hn == 1:
                    fitB[hn] = hy1
                if ly1 >= 0 or hy0 >= 0:
                    for j in range(sortpos - 1, -1, -1):
                        if hineighbor[j] == hn:
                            hineighbor[j] = i
                        else:
                            break
                    for j in range(sortpos + 1, posts):
                        if loneighbor[j] == ln:
                            loneighbor[j] = i
                        else:
                            break
        else:
            fitA[i] = -200
            fitB[i] = -200

    output = np.zeros(posts, dtype=np.int64)
    output[0] = _post_Y(fitA, fitB, 0)
    output[1] = _post_Y(fitA, fitB, 1)
    for i in range(2, posts):
        ln = int(look.loneighbor[i - 2])
        hn = int(look.hineighbor[i - 2])
        predicted = render_point(info.postlist[ln], info.postlist[hn],
                                 int(output[ln]), int(output[hn]),
                                 info.postlist[i])
        vx = _post_Y(fitA, fitB, i)
        if vx >= 0 and predicted != vx:
            output[i] = vx
        else:
            output[i] = predicted | 0x8000
    return output


def floor1_interpolate_fit(look: Floor1Look, A, B, delta):
    if A is None or B is None:
        return None
    out = ((65536 - delta) * (A & 0x7FFF) + delta * (B & 0x7FFF)
           + 32768) >> 16
    out |= np.where(((A & 0x8000) != 0) & ((B & 0x8000) != 0), 0x8000, 0)
    return out


def floor1_encode(w, look: Floor1Look, books, sbooks, post, n2) -> np.ndarray:
    """Pack one channel's floor; returns ilogmask int array (len n2)
    and writes bits.  Returns (nonzero, ilogmask)."""
    info = look.info
    posts = look.posts
    ilogmask = np.zeros(n2, dtype=np.int64)
    if post is None:
        w.write(0, 1)
        return 0, ilogmask
    post = np.array(post, dtype=np.int64)
    val = post & 0x7FFF
    if info.mult == 1:
        val >>= 2
    elif info.mult == 2:
        val >>= 3
    elif info.mult == 3:
        val //= 12
    else:
        val >>= 4
    post = val | (post & 0x8000)

    out = np.zeros(posts, dtype=np.int64)
    out[0] = post[0]
    out[1] = post[1]
    for i in range(2, posts):
        ln = int(look.loneighbor[i - 2])
        hn = int(look.hineighbor[i - 2])
        predicted = render_point(info.postlist[ln], info.postlist[hn],
                                 int(post[ln]), int(post[hn]),
                                 info.postlist[i])
        if (post[i] & 0x8000) or predicted == post[i]:
            post[i] = predicted | 0x8000
            out[i] = 0
        else:
            headroom = min(look.quant_q - predicted, predicted)
            v = int(post[i]) - predicted
            if v < 0:
                v = (headroom - v - 1) if v < -headroom else (-1 - (v << 1))
            else:
                v = (v + headroom) if v >= headroom else (v << 1)
            out[i] = v
            post[ln] &= 0x7FFF
            post[hn] &= 0x7FFF

    from ..bitstream.bitpack import ilog
    w.write(1, 1)
    qb = ilog(look.quant_q - 1)
    w.write(int(out[0]), qb)
    w.write(int(out[1]), qb)

    j = 2
    for i in range(info.partitions):
        cls = info.partitionclass[i]
        cdim = info.class_dim[cls]
        csubbits = info.class_subs[cls]
        csub = 1 << csubbits
        bookas = [0] * 8
        cval = 0
        cshift = 0
        if csubbits:
            maxval = []
            for k in range(csub):
                booknum = info.class_subbook[cls][k]
                maxval.append(1 if booknum < 0
                              else sbooks[booknum].entries)
            for k in range(cdim):
                for l in range(csub):
                    if out[j + k] < maxval[l]:
                        bookas[k] = l
                        break
                cval |= bookas[k] << cshift
                cshift += csubbits
            from ..vq import training as _T
            if _T.TRAINER is not None:
                # TRAIN_FLOOR1: class-word symbol stream
                # (floor1.c:904-938 dump hook)
                _T.TRAINER.add_floor(f"fc{cls}", cval)
            books[info.class_book[cls]].encode(w, cval)
        for k in range(cdim):
            book = info.class_subbook[cls][bookas[k]]
            if book >= 0 and out[j + k] < books[book].entries:
                books[book].encode(w, int(out[j + k]))
        j += cdim

    # render the quantized floor (decoder-equivalent ilogmask)
    hx = 0
    lx = 0
    ly = int(post[0]) * info.mult
    for jj in range(1, posts):
        current = int(look.forward_index[jj])
        hy = int(post[current]) & 0x7FFF
        if hy == post[current]:
            hy *= info.mult
            hx = info.postlist[current]
            dy = hy - ly
            adx = hx - lx
            base = (dy // adx) if dy >= 0 else -((-dy) // adx)
            ady = abs(dy) - abs(base) * adx
            end = min(n2, hx)
            if lx < n2:
                ilogmask[lx] = ly
            if end > lx + 1:
                k = np.arange(1, end - lx)
                s = 1 if dy >= 0 else -1
                ilogmask[lx + 1:end] = ly + base * k + s * ((k * ady) // adx)
            lx, ly = hx, hy
    ilogmask[hx:] = ly
    return 1, ilogmask
