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

Copy of vorbis_tpu/ops/psy.py :1-303, kept line-aligned with it: the
constants, `_tables`, `PsyLook` and `_setup_tone_curves`, which the
port's device analysis (ops/torchdsp.py) builds its tables from.  The
scalar `_vp_*` model stays behind.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np

from ..utils.scales import fromOC, toBARK, toOC

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
