"""aoTuV psychoacoustic model (noise/tone masking, M1-M9 modules,
coupling/quantization/normalization).

Faithful reimplementation of the reference model (lib/psy.c): tone
masking via octave-seeded empirical curves (EHMER 56-point), noise
masking via two-pass Bark-windowed weighted linear regression over
prefix sums, noise companding, aoTuV modules M1 (MDCT scaling), M2
(post-noise), M3 (impulse noise control), M4 (floor-boost guard), M5
(loud-noise compand), M6 (dynamic lossless promotion), M7 (ntfix), M8
(npeak), M9 (epeak), and point-stereo coupling with noise
normalization.

The heavy per-bin math (bark regression, companding, offset/mix) is
vectorized over bins in float32 with the reference's exact rounding
path; the TPU batched path reuses these formulations with jax.numpy
over (frames, channels) once per-function parity is proven against the
compiled reference (tests/test_psy.py).

Copy of vorbis_tpu/ops/psy.py, kept line-aligned with it; its import
of `unitnorm` takes the numpy one (`unitnorm_np`).  The whole scalar
model runs in the port's golden encoder (codec/encoder.py); the device
analysis (ops/torchdsp.py) builds its tables from `_tables`, `PsyLook`
and `_setup_tone_curves`.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np

from ..utils.scales import fromOC, toBARK, toOC, unitnorm_np as unitnorm

_DATA = os.path.join(os.path.dirname(__file__), "..", "data")

P_BANDS = 17
P_LEVELS = 8
P_LEVEL_0 = 30.0
P_NOISECURVES = 3
EHMER_MAX = 56
EHMER_OFFSET = 16
NOISE_COMPAND_LEVELS = 40
NEGINF = np.float32(-9999.0)
M3C = 3

f32 = np.float32


@lru_cache(maxsize=1)
def _tables():
    return dict(np.load(os.path.join(_DATA, "psy_tables.npz")))


# stn_compand / freq_bfn / stereo thresholds are small tuning constants
# of the psy model (reference: lib/psy.c top); transcribed via
# tools/transcribe_tables.py into psy_tables.npz along with ATH and the
# tonemask curves.


class PsyLook:
    """Per-(blocktype, n) psychoacoustic lookup state (reference:
    _vp_psy_init)."""

    def __init__(self, vi, gi, n: int, rate: int):
        t = _tables()
        self.vi = vi
        self.gi = gi
        self.n = n
        self.rate = rate
        self.eighth_octave_lines = gi["eighth_octave_lines"]
        self.shiftoc = int(round(math.log2(gi["eighth_octave_lines"] * 8.0))) - 1
        self.firstoc = int(toOC(0.25 * rate * 0.5 / n)
                           * (1 << (self.shiftoc + 1))) \
            - gi["eighth_octave_lines"]
        maxoc = int(toOC((n + 0.25) * rate * 0.5 / n)
                    * (1 << (self.shiftoc + 1)) + 0.5)
        self.total_octave_lines = maxoc - self.firstoc + 1

        # aoTuV positions
        self.n25p = n // 4
        self.n33p = n // 3
        self.n75p = self.n25p * 3
        self.nn25pt = vi["normal_partition"] // 4
        self.nn50pt = 2 * self.nn25pt
        self.nn75pt = 3 * self.nn25pt

        select = -1
        if rate < 26000:
            self.m_val = 0.0
            self.m3n = np.zeros(M3C, np.int64)
        elif rate < 38000:
            self.m_val = 0.93
            sel = {128: 0, 256: 1, 1024: 2, 2048: 3}.get(n, -1)
            select = sel
            self.m3n = (t["m3n32"] if n == 128 else t["m3n32x2"]
                        if n == 256 else np.zeros(M3C, np.int64))
        elif rate > 46000:
            self.m_val = 1.205
            select = {128: 4, 256: 5, 1024: 6, 2048: 7}.get(n, -1)
            self.m3n = (t["m3n48"] if n == 128 else t["m3n48x2"]
                        if n == 256 else np.zeros(M3C, np.int64))
        else:
            self.m_val = 1.0
            select = {128: 8, 256: 9, 1024: 10, 2048: 11}.get(n, -1)
            self.m3n = (t["m3n44"] if n == 128 else t["m3n44x2"]
                        if n == 256 else np.zeros(M3C, np.int64))
        if select < 0:
            self.tonecomp_endp = 0
            self.tonecomp_thres = 0.25
            self.min_nn_lp = 0
            self.tonefix_end = 0
        else:
            pre = t["aotuv_preset"][select]
            self.tonecomp_endp = int(pre[0])
            self.tonecomp_thres = float(t["aotuv_preset_thres"][select])
            self.min_nn_lp = int(pre[2])
            self.tonefix_end = int(pre[3])

        # ATH interpolation onto bins
        ATH = t["ATH"]
        MAX_ATH = len(ATH)
        ath = np.zeros(n, np.float32)
        j = 0
        for i in range(MAX_ATH - 1):
            endpos = int(round(fromOC((i + 1) * 0.125 - 2.0) * 2 * n / rate))
            base = f32(ATH[i])
            if j < endpos:
                delta = f32((ATH[i + 1] - base) / (endpos - j))
                while j < endpos and j < n:
                    ath[j] = f32(base + 100.0)
                    base = f32(base + delta)
                    j += 1
        if j < n:
            cs = np.float64(ath[j - 1])
            dsv = np.float64(ath[j - 1]) - np.float64(ath[j - 2])
            for i in range(j, n):
                ath[i] = f32(cs)
                cs += dsv
        self.ath = ath

        # bark window bounds.  NB: the reference computes the per-bin
        # frequency with C integer division (rate/(2*n)) and stores the
        # center bark as float32 — both are load-bearing for the exact
        # window extents.
        lo = -99
        hi = 1
        bark = np.zeros(n, np.int64)
        hzper = rate // (2 * n)
        wlo = f32(vi["noisewindowlo"])
        whi = f32(vi["noisewindowhi"])
        for i in range(n):
            bk = f32(toBARK(hzper * i))
            # C compares double toBARK(...) against the float32 sum
            # promoted to double — keep both sides as Python floats
            # (numpy would otherwise demote the comparison to float32)
            blo = float(f32(bk - wlo))
            bhi = float(f32(bk + whi))
            while (lo + vi["noisewindowlomin"] < i
                   and toBARK(hzper * lo) < blo):
                lo += 1
            while (hi <= n and (hi < i + vi["noisewindowhimin"]
                                or toBARK(hzper * hi) < bhi)):
                hi += 1
            bark[i] = ((lo - 1) << 16) + (hi - 1)
        self.bark = bark

        # octave mapping (one extra element is read by max_seeds)
        oc = np.zeros(n + 1, np.int64)
        for i in range(n + 1):
            oc[i] = int(toOC((i + 0.25) * 0.5 * rate / n)
                        * (1 << (self.shiftoc + 1)) + 0.5)
        self.octave = oc

        self.tonecurves = _setup_tone_curves(
            np.asarray(vi["toneatt"], np.float64), rate * 0.5 / n, n,
            vi["tone_centerboost"], vi["tone_decay"])

        # noise offsets per curve per bin.  The psy params live in
        # float32 struct fields in the reference and halfoc/del are
        # float32 — replicate that rounding.
        self.noiseoffset = np.zeros((P_NOISECURVES, n), np.float32)
        self.ntfix_noiseoffset = np.zeros(n, np.float32)
        ntfix_off = t["ntfix_offset"].astype(np.float32)
        noiseoff = np.asarray(vi["noiseoff"], np.float32)
        for i in range(n):
            halfoc = f32(toOC((i + 0.5) * rate / (2.0 * n)) * 2.0)
            halfoc = min(max(halfoc, f32(0.0)), f32(P_BANDS - 1))
            inthalfoc = int(halfoc)
            up = min(inthalfoc + 1, P_BANDS - 1)
            del32 = f32(halfoc - inthalfoc)
            del64 = np.float64(del32)
            # C: a*(1.-del) promotes to double (1. is a double literal)
            # but b*del is a float*float product rounded to float32
            for j in range(P_NOISECURVES):
                self.noiseoffset[j, i] = f32(
                    np.float64(noiseoff[j][inthalfoc]) * (1.0 - del64)
                    + np.float64(f32(noiseoff[j][up] * del32)))
            self.ntfix_noiseoffset[i] = f32(
                np.float64(ntfix_off[inthalfoc]) * (1.0 - del64)
                + np.float64(f32(ntfix_off[up] * del32)))


def _setup_tone_curves(curveatt_dB, binHz, n, center_boost,
                       center_decay_rate):
    """Build composited tone-mask curves (reference: setup_tone_curves).
    Returns float32 array (P_BANDS, P_LEVELS, EHMER_MAX+2) where
    [:, :, 0:2] are the fencepost indices."""
    t = _tables()
    ATH = t["ATH"].astype(np.float64)
    MAX_ATH = len(ATH)
    tonemasks = t["tonemasks"].astype(np.float64)  # (17, 6, 56)
    # float32 working arrays with double-evaluated addends, matching the
    # reference's float storage at every step
    workc = np.zeros((P_BANDS, P_LEVELS, EHMER_MAX), np.float32)
    athc = np.zeros((P_LEVELS, EHMER_MAX), np.float32)
    ret = np.zeros((P_BANDS, P_LEVELS, EHMER_MAX + 2), np.float32)
    center_boost = np.float64(f32(center_boost))
    center_decay_rate = np.float64(f32(center_decay_rate))
    curveatt_dB = np.asarray(curveatt_dB, np.float32)

    for i in range(P_BANDS):
        ath_offset = i * 4
        ath = np.zeros(EHMER_MAX, np.float32)
        for j in range(EHMER_MAX):
            mn = f32(999.0)
            for k in range(4):
                idx = j + k + ath_offset
                v = f32(ATH[idx] if idx < MAX_ATH else ATH[MAX_ATH - 1])
                if v < mn:
                    mn = v
            ath[j] = mn
        for j in range(6):
            workc[i, j + 2] = tonemasks[i, j]
        workc[i, 0] = tonemasks[i, 0]
        workc[i, 1] = tonemasks[i, 0]
        for j in range(P_LEVELS):
            k = np.arange(EHMER_MAX)
            # all-float32 chain in C: int*float and float+float products
            adj = (f32(center_boost)
                   + (np.abs(EHMER_OFFSET - k).astype(np.float32)
                      * f32(center_decay_rate))).astype(np.float32)
            adj = np.where((adj < 0) & (center_boost > 0), f32(0.0), adj)
            adj = np.where((adj > 0) & (center_boost < 0), f32(0.0), adj)
            workc[i, j] = (workc[i, j] + adj).astype(np.float32)
        for j in range(P_LEVELS):
            # attenuate_curve takes att as a float parameter: the double
            # expression rounds to float32 at the call, and the per-
            # element add is float32
            att = f32(np.float64(curveatt_dB[i]) + 100.0
                      - (2 if j < 2 else j) * 10.0 - P_LEVEL_0)
            workc[i, j] = (workc[i, j] + att).astype(np.float32)
            att2 = f32(100.0 - np.float64(f32(j * 10.0)) - P_LEVEL_0)
            athc[j] = (ath + att2).astype(np.float32)
            athc[j] = np.maximum(athc[j], workc[i, j])
        for j in range(1, P_LEVELS):
            athc[j] = np.minimum(athc[j], athc[j - 1])
            workc[i, j] = np.minimum(workc[i, j], athc[j])

    for i in range(P_BANDS):
        bin_ = int(fromOC(i * 0.5) / binHz)
        lo_curve = math.ceil(toOC(bin_ * binHz + 1) * 2)
        hi_curve = math.floor(toOC((bin_ + 1) * binHz) * 2)
        lo_curve = min(lo_curve, i)
        lo_curve = max(lo_curve, 0)
        hi_curve = min(hi_curve, P_BANDS - 1)

        for m in range(P_LEVELS):
            brute = np.full(n, 999.0, np.float64)

            def render(k, center_i):
                l = 0
                for j in range(EHMER_MAX):
                    lo_bin = int(fromOC(j * 0.125 + center_i * 0.5 - 2.0625)
                                 / binHz)
                    hi_bin = int(fromOC(j * 0.125 + center_i * 0.5 - 1.9375)
                                 / binHz) + 1
                    lo_bin = min(max(lo_bin, 0), n)
                    if lo_bin < l:
                        l = lo_bin
                    hi_bin = min(max(hi_bin, 0), n)
                    while l < hi_bin and l < n:
                        if brute[l] > workc[k, m, j]:
                            brute[l] = workc[k, m, j]
                        l += 1
                while l < n:
                    if brute[l] > workc[k, m, EHMER_MAX - 1]:
                        brute[l] = workc[k, m, EHMER_MAX - 1]
                    l += 1

            for k in range(lo_curve, hi_curve + 1):
                render(k, k)
            if i + 1 < P_BANDS:
                render(i + 1, i)

            for j in range(EHMER_MAX):
                bn = int(fromOC(j * 0.125 + i * 0.5 - 2.0) / binHz)
                ret[i, m, j + 2] = (-999.0 if bn < 0 or bn >= n
                                    else brute[bn])
            j = 0
            while j < EHMER_OFFSET and ret[i, m, j + 2] <= -200.0:
                j += 1
            ret[i, m, 0] = j
            j = EHMER_MAX - 1
            while j > EHMER_OFFSET + 1 and ret[i, m, j + 2] <= -200.0:
                j -= 1
            ret[i, m, 1] = j
    return ret


# ---------------------------------------------------------------------------
# noise masking
# ---------------------------------------------------------------------------

def bark_noise_hybridmp(n, bark, fvec, offset, fixed):
    """Bark-windowed weighted least-squares line fit per bin, exactly
    replicating the incremental float32 prefix sums of the reference
    (psy.c bark_noise_hybridmp scalar)."""
    f = np.asarray(fvec, np.float32)
    x = np.arange(n, dtype=np.float32)
    y = np.maximum(f + f32(offset), f32(1.0))
    w = (y * y).astype(np.float32)
    w0_half = f32(w[0] * f32(0.5))
    wx = (w * x).astype(np.float32)
    wxx = (wx * x).astype(np.float32)
    wy = (w * y).astype(np.float32)
    wxy = (wx * y).astype(np.float32)
    # the first element enters with weight w/2 and x=0
    wfirst = w.copy()
    wfirst[0] = w0_half
    wyfirst = wy.copy()
    wyfirst[0] = f32(w0_half * y[0])
    N = np.cumsum(wfirst, dtype=np.float32)
    X = np.cumsum(wx, dtype=np.float32)
    X[0] = w0_half  # tX starts at w (x=0 notionally contributes w*0... )
    # reference: tX += w at i=0 (x treated as 0 for X? no: tX += w)
    # Actually: tX += w; so X[0] = w/2, then X[i] = X[0] + sum wx[1..i]
    X = np.cumsum(np.concatenate([[w0_half], wx[1:]]), dtype=np.float32)
    XX = np.cumsum(np.concatenate([[f32(0.0)], wxx[1:]]), dtype=np.float32)
    Y = np.cumsum(wyfirst, dtype=np.float32)
    XY = np.cumsum(np.concatenate([[f32(0.0)], wxy[1:]]), dtype=np.float32)

    noise = np.zeros(n, np.float32)
    lo = (bark >> 16).astype(np.int64)
    hi = (bark & 0xFFFF).astype(np.int64)

    # region 1: window clipped at the low end (lo < 0)
    # region 2: full window
    # region 3: window clipped at the high end (hi >= n) -> extrapolate
    idx = np.arange(n)
    r1 = (lo < 0) & (-lo < n) & (hi < n)
    # find first index where r1 stops holding (reference breaks at first
    # failure, then region 2 until its condition fails, then region 3)
    i1 = 0
    while i1 < n and r1[i1]:
        i1 += 1
    i2 = i1
    while i2 < n and lo[i2] >= 0 and lo[i2] < n and hi[i2] < n:
        i2 += 1

    A_last = f32(0.0)
    B_last = f32(0.0)
    D_last = f32(1.0)
    if i1 > 0:
        s = slice(0, i1)
        tN = N[hi[s]] + N[-lo[s]]
        tX = X[hi[s]] - X[-lo[s]]
        tXX = XX[hi[s]] + XX[-lo[s]]
        tY = Y[hi[s]] + Y[-lo[s]]
        tXY = XY[hi[s]] - XY[-lo[s]]
        A = tY * tXX - tX * tXY
        B = tN * tXY - tX * tY
        D = tN * tXX - tX * tX
        R = ((A + x[s] * B) / D).astype(np.float32)
        noise[s] = np.maximum(R, f32(0.0)) - f32(offset)
    if i2 > i1:
        s = slice(i1, i2)
        tN = N[hi[s]] - N[lo[s]]
        tX = X[hi[s]] - X[lo[s]]
        tXX = XX[hi[s]] - XX[lo[s]]
        tY = Y[hi[s]] - Y[lo[s]]
        tXY = XY[hi[s]] - XY[lo[s]]
        A = tY * tXX - tX * tXY
        B = tN * tXY - tX * tY
        D = tN * tXX - tX * tX
        R = ((A + x[s] * B) / D).astype(np.float32)
        noise[s] = np.maximum(R, f32(0.0)) - f32(offset)
        A_last, B_last, D_last = A[-1], B[-1], D[-1]
    elif i1 > 0:
        A_last, B_last, D_last = A[-1], B[-1], D[-1]
    if i2 < n:
        s = slice(i2, n)
        R = ((A_last + x[s] * B_last) / D_last).astype(np.float32)
        noise[s] = np.maximum(R, f32(0.0)) - f32(offset)

    if fixed <= 0:
        return noise

    hi_f = idx + fixed // 2
    lo_f = hi_f - fixed
    j1 = 0
    while j1 < n and hi_f[j1] < n and lo_f[j1] < 0:
        j1 += 1
    j2 = j1
    while j2 < n and hi_f[j2] < n and lo_f[j2] >= 0:
        j2 += 1
    A_last = f32(0.0)
    B_last = f32(0.0)
    D_last = f32(1.0)
    if j1 > 0:
        s = slice(0, j1)
        tN = N[hi_f[s]] + N[-lo_f[s]]
        tX = X[hi_f[s]] - X[-lo_f[s]]
        tXX = XX[hi_f[s]] + XX[-lo_f[s]]
        tY = Y[hi_f[s]] + Y[-lo_f[s]]
        tXY = XY[hi_f[s]] - XY[-lo_f[s]]
        A = tY * tXX - tX * tXY
        B = tN * tXY - tX * tY
        D = tN * tXX - tX * tX
        R = ((A + x[s] * B) / D).astype(np.float32)
        noise[s] = np.minimum(noise[s], R - f32(offset))
        A_last, B_last, D_last = A[-1], B[-1], D[-1]
    if j2 > j1:
        s = slice(j1, j2)
        tN = N[hi_f[s]] - N[lo_f[s]]
        tX = X[hi_f[s]] - X[lo_f[s]]
        tXX = XX[hi_f[s]] - XX[lo_f[s]]
        tY = Y[hi_f[s]] - Y[lo_f[s]]
        tXY = XY[hi_f[s]] - XY[lo_f[s]]
        A = tY * tXX - tX * tXY
        B = tN * tXY - tX * tY
        D = tN * tXX - tX * tX
        R = ((A + x[s] * B) / D).astype(np.float32)
        noise[s] = np.minimum(noise[s], R - f32(offset))
        A_last, B_last, D_last = A[-1], B[-1], D[-1]
    if j2 < n:
        s = slice(j2, n)
        R = ((A_last + x[s] * B_last) / D_last).astype(np.float32)
        noise[s] = np.minimum(noise[s], R - f32(offset))
    return noise


def ntfix(p: PsyLook, spectral, noise, block_mode):
    """aoTuV M7: compensate tone components underestimated by the noise
    fit (reference: psy.c ntfix)."""
    n = p.n
    nx = p.tonefix_end
    if not nx:
        return
    limit = abs(p.noiseoffset[1][0])
    temp = np.zeros(256, np.float32)

    if block_mode <= 1:
        freq_upc = 3
        freq_unc = 4
        nxplus = nx + freq_unc
        tolerance = 15.0 if n == 256 else 9.0
        strength = 0.6
        if nxplus > n:
            nx = n
            nxplus = n - freq_unc
        inmod = np.zeros(256, np.float32)
        sp = spectral
        m = np.arange(nxplus)
        inmod[:nxplus] = np.where(sp[:nxplus] < -70,
                                  f32(-70) + (sp[:nxplus] + f32(70))
                                  * f32(0.1),
                                  sp[:nxplus])
        i = freq_unc
        while i < nx:
            if sp[i] > sp[i - 1] and sp[i] > sp[i + 1]:
                ps = i - 1
                pe = i + 1
                upper = i - freq_upc
                under = i + freq_unc
                j = ps
                while j > upper:
                    if sp[j + 1] < sp[j]:
                        break
                    ps = j
                    j -= 1
                j = pe
                while j < under:
                    if sp[j - 1] < sp[j]:
                        break
                    pe = j
                    j += 1
                ss = max(f32(inmod[i] - inmod[ps]), f32(inmod[i] - inmod[pe]))
                if ss > tolerance:
                    if sp[i] > noise[i]:
                        ss = f32((ss - f32(tolerance)) * f32(strength))
                    temp[ps:pe + 1] = np.maximum(ss, temp[ps:pe + 1])
                    temp[ps:pe + 1] = np.maximum(temp[ps:pe + 1], f32(0.0))
                i = pe
            i += 1
        k = np.arange(freq_unc - 1, nx)
        test = np.minimum(p.ntfix_noiseoffset[k],
                          p.noiseoffset[1][k] + f32(limit))
        tt = np.minimum(temp[k], test)
        noise[k] -= tt
    elif block_mode == 2:
        # the averaging loop runs while i<nx (ceil(nx/8) averages, the
        # last possibly spanning past nx), but the peak scan stops at
        # nx/8 — the extra average still participates as temp[i+1]
        navg = (nx + 7) // 8
        nx8 = nx // 8
        temp = np.zeros(256, np.float32)
        for i in range(navg):
            na = 0.0  # C: sequential double accumulation of float terms
            for v in noise[8 * i:8 * i + 8]:
                na += float(v)
            temp[i] = f32(na / 8)
        i = 3
        while i < nx8:
            if temp[i] > temp[i - 1] and temp[i] > temp[i + 1]:
                if temp[i - 1] > temp[i - 2]:
                    thres = temp[i - 2]
                    a = i - 3
                else:
                    thres = temp[i - 1]
                    a = i - 2
                b = i + 3
                thres = f32(temp[i] - thres)
                if thres > 2.0:
                    eightimes = i * 8
                    test = min(p.ntfix_noiseoffset[eightimes],
                               f32(p.noiseoffset[1][eightimes] + f32(limit)))
                    thres = min(f32(thres - 2), test)
                    noise[a * 8:b * 8 + 1] -= thres
            i += 1


def noisemask(p: PsyLook, noise_compand_level, logmdct, lastmdct,
              poste, block_mode):
    """_vp_noisemask: returns (logmask, epeak, npeak)."""
    t = _tables()
    stn_compand = t["stn_compand"].astype(np.float32)
    n = p.n
    vi = p.vi
    partition = vi["normal_partition"] if vi["normal_p"] else 16

    logmask = bark_noise_hybridmp(n, p.bark, logmdct, 140.0, -1)
    work = (logmdct - logmask).astype(np.float32)
    logmask = bark_noise_hybridmp(n, p.bark, work, 0.0,
                                  vi["noisewindowfixed"])
    work = (logmdct - work).astype(np.float32)

    ntfix(p, logmdct, work, block_mode)

    epeak = np.zeros(n, np.float32)
    newmask = np.zeros(n, np.float32)
    # C: int dB = logmask[i]+.5 — the add is double (double literal),
    # the cast truncates toward zero
    dB = (logmask.astype(np.float64) + 0.5).astype(np.int64)
    np.clip(dB, 0, NOISE_COMPAND_LEVELS - 1, out=dB)
    nc = np.asarray(vi["noisecompand"], np.float32)
    nch = np.asarray(vi["noisecompand_high"], np.float32)
    i0 = 0
    if noise_compand_level > 0:
        i0 = p.n33p
        s = slice(0, i0)
        epeak[s] = work[s] + stn_compand[dB[s]]
        # C association: (work + nc[dB]) - ((nc[dB]-nch[dB]) * level)
        newmask[s] = ((work[s] + nc[dB[s]])
                      - ((nc[dB[s]] - nch[dB[s]])
                         * f32(noise_compand_level))).astype(np.float32)
    s = slice(i0, n)
    epeak[s] = work[s] + stn_compand[dB[s]]
    newmask[s] = work[s] + nc[dB[s]]
    logmask = newmask

    nparts = max((n + partition - 1) // partition, 1)
    npeak = np.zeros(nparts, np.float32)

    # M2 post-echo reduction
    if poste > 0:
        k = 0
        i = 0
        while i < p.min_nn_lp:
            temp = min(min(poste, 30.0), p.noiseoffset[1][i] + 30.0)
            if temp > 0:
                npeak[k] = -1.0
                logmask[i:i + partition] -= f32(temp)
            i += partition
            k += 1

    # M8: per-partition floor store for noise normalization
    k = 0
    i = 0
    nt = 4.0
    while i < p.min_nn_lp:
        o = p.noiseoffset[1][i + partition - 1] + 6
        if o > 0 and npeak[k] >= -0.5:
            seg_md = logmdct[i:i + partition]
            me = np.max((seg_md - logmask[i:i + partition]).astype(np.float32))
            me = max(f32(0.0), me)
            avge = np.sum(seg_md.astype(np.float64))
            if avge >= (-95 * partition):
                if me < nt:
                    npeak[k] = min(o, nt - me) / nt
        i += partition
        k += 1

    # M9: peak impulse for coupling stereo
    i = 0
    if block_mode > 1:
        end = p.tonecomp_endp
        seg = slice(0, end)
        temp = (logmdct[seg] - epeak[seg]).astype(np.float32)
        mi = (logmdct[seg] - lastmdct[seg]).astype(np.float32)
        epeak[seg] = np.where((temp >= 12.0) & (mi >= 1), mi, f32(0.0))
        i = end
    epeak[i:] = 0.0
    return logmask, epeak, npeak


def lb_loudnoise_fix(p: PsyLook, noise_compand_level, logmdct,
                     block_mode, lW_block_mode):
    """aoTuV M5."""
    if p.m_val < 0.5:
        return -1.0
    if p.vi["normal_thresh"] > 0.45:
        return -1.0
    if not ((block_mode == 2 and lW_block_mode == 3)
            or (block_mode == 3 and lW_block_mode == 2)):
        return noise_compand_level
    seg = logmdct[p.n25p:p.n75p].astype(np.float64)
    hi_th = np.sum(np.maximum(seg, -130.0)) / p.n
    if hi_th > -40.0:
        return -1.0
    if hi_th < -50.0:
        return 1.0
    return 1.0 - ((hi_th + 50) / 10)


def postnoise_detection(pcm, nn, mode, lw_mode):
    """aoTuV M2 pre-detection on raw (unwindowed) PCM."""
    if mode != 2 or lw_mode != 0 or nn < 2048:
        return -1.0
    sn = nn >> 2
    mn = sn + sn
    en = sn + (nn >> 1)
    upt = float(np.sum(np.abs(pcm[sn:mn]).astype(np.float64)))
    unt = float(np.sum(np.abs(pcm[mn:en]).astype(np.float64)))
    if unt / sn > 0.01:
        return -1.0
    upt *= upt
    unt *= unt
    unt *= 15
    if upt > unt:
        ret = upt - unt
        return -1.0 if ret < 0.1 else ret
    return -1.0


# ---------------------------------------------------------------------------
# tone masking
# ---------------------------------------------------------------------------

def tonemask(p: PsyLook, logfft, global_specmax, local_specmax):
    """_vp_tonemask: ATH floor + octave-seeded tone curves."""
    n = p.n
    vi = p.vi
    seed = np.full(p.total_octave_lines, NEGINF, np.float32)
    att = f32(local_specmax + vi["ath_adjatt"])
    if att < vi["ath_maxatt"]:
        att = f32(vi["ath_maxatt"])
    logmask = (p.ath + att).astype(np.float32)

    _seed_loop(p, logfft, logmask, seed, global_specmax)
    _max_seeds(p, seed, logmask)
    return logmask


def _seed_loop(p: PsyLook, f, flr, seed, specmax):
    vi = p.vi
    n = p.n
    dBoffset = f32(vi["max_curve_dB"] - specmax)
    curves = p.tonecurves
    linesper = p.eighth_octave_lines
    total = p.total_octave_lines
    i = 0
    while i < n:
        mx = f[i]
        oc0 = p.octave[i]
        while i + 1 < n and p.octave[i + 1] == oc0:
            i += 1
            if f[i] > mx:
                mx = f[i]
        if f32(mx + 6.0) > flr[i]:
            oc = oc0 >> p.shiftoc
            oc = min(max(oc, 0), P_BANDS - 1)
            _seed_curve(seed, curves[oc], mx, oc0 - p.firstoc,
                        total, linesper, dBoffset)
        i += 1


def _seed_curve(seed, curves, amp, oc, n, linesper, dBoffset):
    choice = int(f32(f32(amp + dBoffset) - f32(P_LEVEL_0)) * f32(0.1))
    choice = min(max(choice, 0), P_LEVELS - 1)
    posts = curves[choice]
    curve = posts[2:]
    post0 = int(posts[0])
    post1 = int(posts[1])
    seedptr = oc + (post0 - EHMER_OFFSET) * linesper - (linesper >> 1)
    for i in range(post0, post1):
        if seedptr > 0:
            lin = f32(amp + curve[i])
            if seed[seedptr] < lin:
                seed[seedptr] = lin
        seedptr += linesper
        if seedptr >= n:
            break


def _seed_chase(seeds, linesper, n):
    posstack = np.zeros(n, np.int64)
    ampstack = np.zeros(n, np.float32)
    stack = 0
    for i in range(n):
        if stack < 2:
            posstack[stack] = i
            ampstack[stack] = seeds[i]
            stack += 1
        else:
            while True:
                if seeds[i] < ampstack[stack - 1]:
                    posstack[stack] = i
                    ampstack[stack] = seeds[i]
                    stack += 1
                    break
                else:
                    if i < posstack[stack - 1] + linesper:
                        if (stack > 1
                                and ampstack[stack - 1] <= ampstack[stack - 2]
                                and i < posstack[stack - 2] + linesper):
                            stack -= 1
                            continue
                    posstack[stack] = i
                    ampstack[stack] = seeds[i]
                    stack += 1
                    break
    pos = 0
    for i in range(stack):
        if i < stack - 1 and ampstack[i + 1] > ampstack[i]:
            endpos = posstack[i + 1]
        else:
            endpos = posstack[i] + linesper + 1
        endpos = min(endpos, n)
        if endpos > pos:
            seeds[pos:endpos] = ampstack[i]
            pos = endpos


def _max_seeds(p: PsyLook, seed, flr):
    n = p.total_octave_lines
    linesper = p.eighth_octave_lines
    _seed_chase(seed, linesper, n)
    linpos = 0
    pos = p.octave[0] - p.firstoc - (linesper >> 1)
    while linpos + 1 < p.n:
        minV = seed[pos]
        end = ((p.octave[linpos] + p.octave[linpos + 1]) >> 1) - p.firstoc
        if minV > p.vi["tone_abs_limit"]:
            minV = f32(p.vi["tone_abs_limit"])
        while pos + 1 <= end:
            pos += 1
            if (seed[pos] > NEGINF and seed[pos] < minV) or minV == NEGINF:
                minV = seed[pos]
        end = pos + p.firstoc
        while linpos < p.n and p.octave[linpos] <= end:
            if flr[linpos] < minV:
                flr[linpos] = minV
            linpos += 1
    minV = seed[p.total_octave_lines - 1]
    flr[linpos:] = np.maximum(flr[linpos:], minV)


# ---------------------------------------------------------------------------
# offset & mix (aoTuV M1 / M3 / M4)
# ---------------------------------------------------------------------------

class Mod3State:
    __slots__ = ("sw", "mdctbuf_flag", "noise_rate", "noise_rate_low",
                 "noise_center", "tone_rate")

    def __init__(self):
        self.sw = 0
        self.mdctbuf_flag = 0
        self.noise_rate = f32(0.0)
        self.noise_rate_low = f32(0.0)
        self.noise_center = f32(0.0)
        self.tone_rate = f32(0.0)


def _set_m3p(mp, lW_no, impadnum, n, hs_rate, toneatt, logmdct, lastmdct,
             tempmdct, block_mode, lW_block_mode, bit_managed,
             offset_select):
    """aoTuV M3 preparation: sets impulse noise-control parameters and
    maintains the tempmdct echo buffer (reference: psy.c set_m3p)."""
    t = _tables()
    if not hs_rate:
        mp.sw = 0
        mp.mdctbuf_flag = 0
        return
    if (not bit_managed) or offset_select == 2:
        mp.mdctbuf_flag = 1
    else:
        mp.mdctbuf_flag = 0
        if offset_select == 0:
            mp.sw = 0
            return
    if block_mode:
        mp.sw = 0
        return

    if n == 128:
        bfn = t["freq_bfn128"]
        count = 2 if toneatt < 3 else 3
        if not lW_block_mode:
            if lW_no < 8:
                mp.noise_rate = f32(0.7 - np.float64(
                    f32(np.float32(lW_no - 1) / np.float32(17))))
                mp.noise_center = f32(lW_no * count)
                mp.tone_rate = f32(8 - lW_no)
            else:
                mp.noise_rate = f32(0.3)
                mp.noise_center = f32(25)
                mp.tone_rate = f32(0)
                if (lW_no * count) < 24:
                    mp.noise_center = f32(lW_no * count)
            if mp.mdctbuf_flag == 1:
                tempmdct[:n] -= f32(5)
        else:
            mp.noise_rate = f32(0.7)
            mp.noise_center = f32(0)
            mp.tone_rate = f32(8.0)
            if mp.mdctbuf_flag == 1:
                tempmdct[:n] = lastmdct[:n] - f32(5)
        mp.noise_rate_low = f32(0)
        mp.sw = 1
        if impadnum:
            mp.noise_rate = f32(np.float64(mp.noise_rate)
                                * (impadnum * 0.125))
        _m3_tempmdct_update(n, bfn, logmdct, tempmdct, mp.mdctbuf_flag,
                            f32(5.0))
    elif n == 256:
        bfn = t["freq_bfn256"]
        if not lW_block_mode:
            count = 6
            if lW_no < 4:
                mp.noise_rate = f32(0.4 - np.float64(
                    f32(np.float32(lW_no - 1) / np.float32(11))))
                mp.noise_center = f32(lW_no * count + 12)
                mp.tone_rate = f32(8 - lW_no * 2)
            else:
                mp.noise_rate = f32(0.2)
                mp.noise_center = f32(30)
                mp.tone_rate = f32(0)
            if mp.mdctbuf_flag == 1:
                tempmdct[:n] -= f32(10)
        else:
            mp.noise_rate = f32(0.6)
            mp.noise_center = f32(12)
            mp.tone_rate = f32(8.0)
            if mp.mdctbuf_flag == 1:
                tempmdct[:n] = lastmdct[:n] - f32(10)
        mp.noise_rate_low = f32(0)
        mp.sw = 1
        if impadnum:
            mp.noise_rate = f32(np.float64(mp.noise_rate)
                                * (impadnum * 0.0625))
        _m3_tempmdct_update(n, bfn, logmdct, tempmdct, mp.mdctbuf_flag,
                            f32(10.0))
    else:
        mp.sw = 0
    if bit_managed and offset_select == 0 and mp.sw:
        mp.noise_rate = f32(np.float64(mp.noise_rate) * 0.2)


def _m3_tempmdct_update(n, bfn, logmdct, tempmdct, flag, base):
    """Sequential echo-spreading update of tempmdct (loop-carried)."""
    for i in range(n):
        nb = int(bfn[i])
        cell = f32(np.float32(75) / np.float32(nb))
        for j in range(1, nb):
            freqbuf = f32(logmdct[i] - f32(cell * np.float32(j)))
            if tempmdct[i + j] < freqbuf and flag == 1:
                tempmdct[i + j] = f32(
                    np.float64(tempmdct[i + j])
                    + np.float64(base) / np.float64(np.float32(bfn[i + j])))


def offset_and_mix(p: PsyLook, noise, tone, offset_select, bit_managed,
                   mdct, logmdct, lastmdct, tempmdct, low_compand,
                   npeak, end_block, block_mode, nW_modenumber,
                   lW_block_mode, lW_no, impadnum):
    """_vp_offset_and_mix: combine noise+tone masks with aoTuV M1
    (MDCT scaling), M3 (impulse noise control), M4 (floor boost guard).
    Mutates mdct, lastmdct, tempmdct, npeak; returns logmask."""
    n = p.n
    vi = p.vi
    hsrate = 0 if p.rate < 26000 else 1
    partition = vi["normal_partition"] if vi["normal_p"] else 16
    toneatt = f32(vi["tone_masteratt"][offset_select])

    mp3 = Mod3State()
    m4_start = vi["normal_start"]
    m4_end = p.tonecomp_endp
    m4_thres = f32(p.tonecomp_thres)
    m4_lp_pos = 9999
    m4_end_block = end_block

    low_compand = f32(low_compand)
    if low_compand < 0 or toneatt < 25.0:
        low_compand = f32(0.0)
    else:
        low_compand = f32(np.float64(low_compand)
                          * (np.float64(toneatt) - 25.0))

    _set_m3p(mp3, lW_no, impadnum, n, hsrate, toneatt, logmdct, lastmdct,
             tempmdct, block_mode, lW_block_mode, bit_managed,
             offset_select)

    m4_end_block += vi["normal_partition"]
    if m4_end_block > n:
        m4_end_block = n
    if not hsrate:
        m4_end = m4_end_block
    else:
        if vi["normal_thresh"] > 1.0:
            m4_start = 9999
        else:
            m4_lp_pos = m4_end if m4_end > m4_end_block else m4_end_block

    logmask = np.zeros(n, np.float32)
    noff = p.noiseoffset[offset_select]
    nms = f32(vi["noisemaxsupp"])
    m3n = p.m3n
    m_val = f32(p.m_val)

    # elementwise base values
    val_v = (noise + noff).astype(np.float32)
    np.minimum(val_v, nms, out=val_v)
    tval_v = (tone + toneatt).astype(np.float32)
    # low_compand applies to i<=m4_start
    if low_compand != 0.0 and m4_start >= 0:
        lim = min(m4_start + 1, n)
        tval_v[:lim] = tval_v[:lim] - low_compand

    for i in range(n):
        val = val_v[i]
        tval = tval_v[i]

        # M3 main: dynamic impulse-block noise control
        if mp3.sw and val > tval:
            if val > lastmdct[i] and logmdct[i] > f32(tempmdct[i]
                                                     + mp3.noise_center):
                toneac = 0
                if mp3.mdctbuf_flag == 1:
                    tempmdct[i] = logmdct[i]
                if logmdct[i] > lastmdct[i]:
                    rate_mod = mp3.noise_rate
                else:
                    rate_mod = mp3.noise_rate_low
                if (not impadnum) and i < p.tonecomp_endp \
                        and f32(val - lastmdct[i]) > 20.0:
                    dBsub = f32(logmdct[i] - lastmdct[i])
                    if dBsub > 25.0:
                        toneac = 1
                        if tval > -100.0 and f32(logmdct[i] - tval) < 48.0:
                            tr_cur = mp3.tone_rate
                            if dBsub < 35.0:
                                tr_cur = f32(np.float64(tr_cur)
                                             * np.float64(f32(f32(35.0 - dBsub)
                                                              * f32(0.1))))
                            tval = f32(tval - tr_cur)
                            if tval < -100.0:
                                tval = f32(-100.0)
                            if f32(logmdct[i] - tval) > 48.0:
                                tval = f32(logmdct[i] - f32(48.0))
                if i > m3n[0]:
                    mainth = f32(30.0)
                elif i > m3n[1]:
                    mainth = f32(20.0)
                elif i > m3n[2]:
                    mainth = f32(10.0)
                    rate_mod = f32(rate_mod * f32(0.5))
                else:
                    mainth = f32(10.0)
                    rate_mod = f32(rate_mod * f32(0.3))
                if f32(val - tval) > mainth:
                    valmask = f32(f32(f32(f32(f32(val - tval) - mainth)
                                          * f32(0.1)) + mainth) * rate_mod)
                else:
                    valmask = f32(f32(val - tval) * rate_mod)
                if f32(val - valmask) > lastmdct[i]:
                    val = f32(val - valmask)
                else:
                    val = lastmdct[i]
                if toneac:
                    temp = f32(val - max(lastmdct[i], f32(-140.0)))
                    if temp > 20.0:
                        val = f32(val - f32(f32(temp - f32(20.0))
                                            * f32(0.2)))
                if toneac == 1:
                    npeak[i // partition] = -1.0
                elif npeak[i // partition] > 0:
                    npeak[i // partition] = 0.0

        # M4: floor boost guard
        if val > tval:
            logmask[i] = val
        elif m4_start < i < m4_end:
            if logmdct[i] < tval:
                if logmdct[i] < val:
                    tval = f32(tval - f32(f32(tval - val) * m4_thres))
                else:
                    tval = logmdct[i]
            logmask[i] = tval
        else:
            logmask[i] = tval

        # M1: relative MDCT compensation
        if offset_select == 1:
            m1_coeffi = f32(-17.2)
            val = f32(val - logmdct[i])
            if val > m1_coeffi:
                m1_de = f32(1.0 - (np.float64(f32(val - m1_coeffi))
                                   * 0.005 * np.float64(m_val)))
                if m1_de < 0:
                    m1_de = f32(0.0001)
            else:
                m1_de = f32(1.0 - (np.float64(f32(val - m1_coeffi))
                                   * 0.0003 * np.float64(m_val)))
            mdct[i] = f32(mdct[i] * m1_de)

    # M3: set lastmdct for the next frame
    if mp3.mdctbuf_flag == 1:
        mag = 8
        if block_mode in (0, 1):
            if nW_modenumber:
                lastmdct[:n * mag] = np.repeat(logmdct[:n], mag)
            else:
                lastmdct[:n] = logmdct[:n]
        elif block_mode == 2:
            if not nW_modenumber:
                nsh = n >> 3
                lastmdct[:nsh] = np.min(
                    logmdct[:nsh * mag].reshape(nsh, mag), axis=1)
            else:
                lastmdct[:n] = logmdct[:n]
        elif block_mode == 3:
            lastmdct[:n] = logmdct[:n]
    return logmask


# ---------------------------------------------------------------------------
# coupling / quantization / noise normalization (reference:
# _vp_couple_quantize_normalize and helpers)
# ---------------------------------------------------------------------------

def _flag_lossless(limit, prepoint, postpoint, prepoint_r, postpoint_r,
                   res, mdct_seg, enpeak_seg, floor_seg, flag, i, jn):
    pointlimit = limit - i
    ps = 0
    ps1 = ps2 = f32(0.0)
    if pointlimit > 0:
        point1 = prepoint
        point2 = prepoint_r
        if (pointlimit - jn) <= 0:
            ps1 = f32(f32(postpoint - prepoint) / np.float32(jn))
            ps2 = f32(f32(postpoint_r - prepoint_r) / np.float32(jn))
            ps = 1
    else:
        point1 = postpoint
        point2 = postpoint_r
    for j in range(jn):
        if ps == 1:
            point1 = f32(point1 + ps1)
            point2 = f32(point2 + ps2)
        bakp1 = point1
        res[j] = f32(mdct_seg[j] / floor_seg[j])
        r = abs(float(res[j]))
        point1 = f32(point1 - enpeak_seg[j])
        if point1 < prepoint:
            point1 = prepoint
        if r < point1:
            flag[j] = 0 if r < point2 else -1
        else:
            flag[j] = 1
        point1 = bakp1


def _lossless_coupling_i(A, B):
    if abs(A) > abs(B):
        ang = A - B if A > 0 else B - A
        mag = A
    else:
        ang = A - B if B > 0 else B - A
        mag = B
    if ang >= abs(mag) * 2:
        ang = -ang
        mag = -mag
    return mag, ang


def _lossless_coupling_f(A, B):
    if abs(float(A)) > abs(float(B)):
        ang = f32(A - B) if A > 0 else f32(B - A)
        mag = A
    else:
        ang = f32(A - B) if B > 0 else f32(B - A)
        mag = B
    if float(ang) >= abs(float(mag)) * 2:
        ang = f32(-ang)
        mag = f32(-mag)
    return mag, ang


def _min_indemnity_dipole_hypot(a, b, threv):
    thnor = f32(0.94)
    a2 = f32(abs(f32(a * thnor)))
    b2 = f32(abs(f32(b * thnor)))
    if a > 0.0:
        if b > 0.0:
            return f32(a2 + b2)
        if a > -b:
            return f32(a2 - f32(b2 * threv))
        return f32(-(f32(b2 - f32(a2 * threv))))
    if b < 0.0:
        return f32(-(f32(a2 + b2)))
    if -a > b:
        return f32(-(f32(a2 - f32(b2 * threv))))
    return f32(b2 - f32(a2 * threv))


def _ssort_indices(vals, count, bthresh):
    """Replicates the reference's partial selection sort over pointers:
    after the call, order[k] for k<bthresh hold the largest values in
    descending order (first-found wins ties); the rest are the partially
    swapped remainder.  Returns the full order list."""
    order = list(range(count))
    if count < bthresh:
        bthresh = count
    for i in range(bthresh):
        large = i
        for j in range(i + 1, count):
            if vals[order[large]] < vals[order[j]]:
                large = j
        order[i], order[large] = order[large], order[i]
    return order


def _noise_normalize(p: PsyLook, limit, r, q, f, res, flags, acc, nepeak,
                     i, n, out):
    """reference: noise_normalize.  Mutates q, res, out; returns acc."""
    vi = p.vi
    start = (vi["normal_start"] - i) if vi["normal_p"] else n
    if start > n or nepeak < -0.5:
        start = n
    acc = f32(0.0)
    sort_idx = []
    j = 0
    if flags is None:
        while j < start:
            out[j] = int(np.rint(np.float64(res[j])))
            j += 1
    else:
        while j < start:
            if flags[j] != 1:
                ve = f32(math.sqrt(np.float64(f32(q[j] / f[j]))))
                if r[j] < 0:
                    out[j] = -int(np.rint(np.float64(ve)))
                    res[j] = f32(-ve)
                else:
                    out[j] = int(np.rint(np.float64(ve)))
                    res[j] = ve
            j += 1

    if flags is not None:
        while j < n:
            if flags[j] != 1:
                ve = f32(q[j] / f[j])
                if ve < 0.25 and j >= limit - i:
                    acc = f32(acc + ve)
                    sort_idx.append(j)
                    sv = f32(math.sqrt(np.float64(ve)))
                    res[j] = f32(-sv) if r[j] < 0 else sv
                else:
                    ve = f32(math.sqrt(np.float64(ve)))
                    if r[j] < 0:
                        out[j] = -int(np.rint(np.float64(ve)))
                        res[j] = f32(-ve)
                    else:
                        out[j] = int(np.rint(np.float64(ve)))
                        res[j] = ve
                    q[j] = f32(f32(np.float32(out[j]) * np.float32(out[j]))
                               * f[j])
            j += 1
    else:
        while j < n:
            ve = f32(res[j] * res[j])
            if ve < 0.25:
                acc = f32(acc + ve)
                sort_idx.append(j)
            else:
                out[j] = int(np.rint(np.float64(res[j])))
                q[j] = f32(f32(np.float32(out[j]) * np.float32(out[j]))
                           * f[j])
            j += 1

    acc = f32(acc + f32(f32(acc * nepeak) * nepeak))

    count = len(sort_idx)
    if count:
        iacc = int(acc) + 1
        if iacc > n:
            iacc = n
        order = _ssort_indices([float(q[e]) for e in sort_idx], count, iacc)
        thresh = vi["normal_thresh"]
        for k in range(count):
            e = sort_idx[order[k]]
            if acc >= thresh:
                out[e] = int(unitnorm(f32(r[e])))
                acc = f32(acc - 1.0)
                q[e] = f[e]
            else:
                out[e] = 0
                q[e] = f32(0.0)
    return acc


def couple_quantize_normalize(blobno, g, p: PsyLook, mapping, mdct,
                              enpeak, nepeak, iwork, nonzero,
                              sliding_lowpass, ch, lowpassr):
    """reference: _vp_couple_quantize_normalize.  iwork holds the floor
    indices on input (ilogmask) and the quantized residue ints on
    output; nonzero and nepeak are updated in place."""
    t = _tables()
    fromdB = _fromdB_lookup()
    st = t["stereo_threshholds"]
    stX = t["stereo_threshholds_X"]
    n = p.n
    vi = p.vi
    partition = vi["normal_partition"] if vi["normal_p"] else 16
    limit = g["coupling_pointlimit"][vi["blockflag"]][blobno]
    prepoint = f32(st[g["coupling_prepointamp"][blobno]])
    postpoint = f32(st[g["coupling_postpointamp"][blobno]])
    prepoint_x = f32(stX[g["coupling_prepointamp"][blobno]])
    postpoint_x = f32(stX[g["coupling_postpointamp"][blobno]])
    steps = mapping.coupling_steps

    if prepoint_x < prepoint:
        prepoint_x = prepoint
    if postpoint_x < prepoint:
        postpoint_x = prepoint

    side_resdef = [f32(-1.0)] * steps
    prae = 0.34 if steps == 1 else 0.825

    raw = np.zeros((ch, partition), np.float32)
    quant = np.zeros((ch, partition), np.float32)
    floor_e = np.zeros((ch, partition), np.float32)
    res = np.zeros((ch, partition), np.float32)
    flag = np.zeros((ch, partition), np.int64)

    i = 0
    pi = 0
    while i < lowpassr:
        jn = partition if partition <= n - i else n - i
        nz = list(nonzero)
        track = 0
        flag[:] = 0
        for k in range(ch):
            iout = iwork[k]
            if nz[k]:
                for j in range(jn):
                    floor_e[k][j] = fromdB[iout[i + j]]
                _flag_lossless(limit, prepoint, postpoint, prepoint_x,
                               postpoint_x, res[k], mdct[k][i:],
                               enpeak[k][i:], floor_e[k], flag[k], i, jn)
                for j in range(jn):
                    v = f32(mdct[k][i + j] * mdct[k][i + j])
                    quant[k][j] = v
                    raw[k][j] = f32(-v) if mdct[k][i + j] < 0.0 else v
                    floor_e[k][j] = f32(floor_e[k][j] * floor_e[k][j])
                outview = iout[i:i + jn]
                _noise_normalize(p, limit, raw[k], quant[k], floor_e[k],
                                 res[k], None, f32(0.0), nepeak[k][pi], i,
                                 jn, outview)
            else:
                floor_e[k][:jn] = 1e-10
                raw[k][:jn] = 0.0
                quant[k][:jn] = 0.0
                res[k][:jn] = 0.0
                flag[k][:jn] = 0
                iwork[k][i:i + jn] = 0
            track += 1

        for step in range(steps):
            Mi = mapping.coupling_mag[step]
            Ai = mapping.coupling_ang[step]
            if not (nz[Mi] or nz[Ai]):
                continue
            nz[Mi] = nz[Ai] = 1
            iM = iwork[Mi]
            iA = iwork[Ai]
            reM, reA = raw[Mi], raw[Ai]
            qeM, qeA = quant[Mi], quant[Ai]
            floorM, floorA = floor_e[Mi], floor_e[Ai]
            resM, resA = res[Mi], res[Ai]
            fM, fA = flag[Mi], flag[Ai]
            pointflag = 0

            # M6: dynamic lossless promotion
            if p.tonefix_end > i:
                rp = pp = 0
                residue_def = 0.0
                for j in range(jn):
                    if (resM[j] < -0.5 or resM[j] >= 0.5
                            or resA[j] < -0.5 or resA[j] >= 0.5):
                        if ((reM[j] > 0.0 and reA[j] < 0.0)
                                or (reA[j] > 0.0 and reM[j] < 0.0)):
                            rp += 1
                        else:
                            pp += 1
                        residue_def = f32(residue_def
                                          + f32(abs(f32(abs(float(resM[j]))
                                                        - abs(float(resA[j]))))))
                ap = rp + pp
                if ap != 0:
                    temp_def = residue_def = f32(residue_def
                                                 / np.float32(ap))
                    if side_resdef[step] > 0:
                        residue_def = f32(np.float64(temp_def) * 0.5
                                          + np.float64(side_resdef[step])
                                          * 0.5)
                    side_resdef[step] = temp_def
                    if residue_def > 1.0:
                        for j in range(jn):
                            if fM[j] == -1 or fA[j] == -1:
                                fM[j] = 1
                    if np.float32(rp) / np.float32(ap) >= prae:
                        for j in range(jn):
                            if (fM[j] == -1 or fA[j] == -1) and (
                                    (reM[j] > 0.0 and reA[j] < 0.0)
                                    or (reA[j] > 0.0 and reM[j] < 0.0)):
                                fM[j] = 1
                else:
                    side_resdef[step] = f32(-1.0)

            for j in range(jn):
                if j < sliding_lowpass - i:
                    if fM[j] == 1 or fA[j] == 1:
                        # lossless coupling
                        reM[j] = f32(abs(float(reM[j]))
                                     + abs(float(reA[j])))
                        qeM[j] = f32(qeM[j] + qeA[j])
                        fM[j] = fA[j] = 1
                        resM[j], resA[j] = _lossless_coupling_f(
                            resM[j], resA[j])
                        iM[i + j], iA[i + j] = _lossless_coupling_i(
                            int(iM[i + j]), int(iA[i + j]))
                    else:
                        # lossy (point) coupling
                        if steps == 1 or step == 3:
                            hpL, hpH = f32(0.18), f32(0.12)
                        else:
                            hpL, hpH = f32(0.18), f32(0.04)
                        if j < limit - i:
                            reM[j] = _min_indemnity_dipole_hypot(
                                reM[j], reA[j], hpL)
                        else:
                            reM[j] = _min_indemnity_dipole_hypot(
                                reM[j], reA[j], hpH)
                        qeM[j] = f32(abs(float(reM[j])))
                        reA[j] = qeA[j] = 0.0
                        fA[j] = 1
                        iA[i + j] = 0
                        resA[j] = 0.0
                        if nepeak[Mi][pi] < -0.5 or nepeak[Ai][pi] < -0.5:
                            nepeak[Mi][pi] = -1.0
                        else:
                            nepeak[Mi][pi] = min(nepeak[Mi][pi],
                                                 nepeak[Ai][pi])
                        pointflag |= 1
                floorM[j] = floorA[j] = f32(floorM[j] + floorA[j])
            if pointflag:
                _noise_normalize(p, limit, raw[Mi], quant[Mi],
                                 floor_e[Mi], res[Mi], flag[Mi],
                                 f32(0.0), nepeak[Mi][pi], i, jn,
                                 iM[i:i + jn])
            track += 1
        i += partition
        pi += 1

    if lowpassr < n:
        for k in range(ch):
            iwork[k][lowpassr:n] = 0

    for step in range(steps):
        if nonzero[mapping.coupling_mag[step]] \
                or nonzero[mapping.coupling_ang[step]]:
            nonzero[mapping.coupling_mag[step]] = 1
            nonzero[mapping.coupling_ang[step]] = 1


@lru_cache(maxsize=1)
def _fromdB_lookup():
    return dict(np.load(os.path.join(_DATA, "floor_tables.npz")))[
        "fromdB_lookup"]


def ampmax_decay(amp, rate, n2, att_per_sec):
    """reference: _vp_ampmax_decay — decay the running amplitude cap by
    ampmax_att_per_sec over one block hop."""
    secs = f32(np.float32(n2) / np.float32(rate))
    amp = f32(amp + f32(secs * f32(att_per_sec)))
    if amp < -9999:
        amp = f32(-9999)
    return amp
