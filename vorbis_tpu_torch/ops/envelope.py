"""Transient/envelope detector driving long/short block switching
(reference: lib/envelope.c).

Per 64-sample step, a 128-point MDCT is taken per channel; 12
sin^2-weighted bands are tracked through a 17-slot amplitude history;
pre/post-echo threshold triggers produce the mark array consumed by the
block-switching state machine, with "stretch" hysteresis lengthening
the pre-trigger context after impulses.

Copy of vorbis_tpu/ops/envelope.py, kept line-aligned with it; its
import of `todB` takes the numpy one (`todB_np`).  The scalar detector
(EnvelopeLookup, envelope_search) runs in the port's golden encoder
(codec/encoder.py); the batched detector (ops/torchdsp.DeviceEnvelope)
and the exact stretch rescue (models/fastenc) read the band layout and
the stretch constants.
"""

from __future__ import annotations

import math

import numpy as np

from ..utils.scales import todB_np as todB
from .mdct import mdct_forward

f32 = np.float32

VE_PRE = 16
VE_WIN = 4
VE_POST = 2
VE_AMP = VE_PRE + VE_POST - 1
VE_BANDS = 12
VE_NEARDC = 15
VE_MINSTRETCH = 2
VE_MAXSTRETCH = 12

BAND_BEGIN = [2, 4, 6, 9, 13, 17, 22, 12, 8, 3, 2, 1]
BAND_END = [4, 5, 6, 8, 8, 8, 8, 4, 4, 3, 2, 4]


class _FilterState:
    __slots__ = ("ampbuf", "ampptr", "nearDC", "nearDC_acc",
                 "nearDC_partialacc", "nearptr")

    def __init__(self):
        self.ampbuf = np.zeros(VE_AMP, np.float32)
        self.ampptr = 0
        self.nearDC = np.zeros(VE_NEARDC, np.float32)
        self.nearDC_acc = f32(0.0)
        self.nearDC_partialacc = f32(0.0)
        self.nearptr = 0


class EnvelopeLookup:
    def __init__(self, gi, blocksizes, channels):
        self.gi = gi
        self.winlength = 128
        self.searchstep = 64
        self.minenergy = f32(gi["preecho_minenergy"])
        self.ch = channels
        self.storage = 128
        self.cursor = blocksizes[1] // 2
        self.blocksizes = blocksizes
        n = self.winlength
        i = np.arange(n)
        t = np.sin(i / (n - 1.0) * math.pi).astype(np.float32)
        self.mdct_win = (t * t).astype(np.float32)
        self.band_win = []
        self.band_total = []
        for j in range(VE_BANDS):
            bn = BAND_END[j]
            wv = np.sin((np.arange(bn) + 0.5) / bn * math.pi).astype(
                np.float32)
            tot = f32(0.0)
            for v in wv:
                tot = f32(tot + v)
            self.band_win.append(wv)
            self.band_total.append(f32(np.float64(1.0) / np.float64(tot)))
        self.filters = [[_FilterState() for _ in range(VE_BANDS)]
                        for _ in range(channels)]
        self.mark = np.zeros(self.storage, np.int64)
        self.stretch = 0
        self.current = 0
        self.curmark = 0


def _ve_amp(ve: EnvelopeLookup, gi, data, ch):
    n = ve.winlength
    ret = 0
    minV = ve.minenergy
    stretch = max(VE_MINSTRETCH, ve.stretch // 2)
    penalty = f32(f32(gi["stretch_penalty"])
                  - (ve.stretch // 2 - VE_MINSTRETCH))
    if penalty < 0.0:
        penalty = f32(0.0)
    if penalty > gi["stretch_penalty"]:
        penalty = f32(gi["stretch_penalty"])

    vec = (data[:n] * ve.mdct_win).astype(np.float32)
    vec = np.asarray(mdct_forward(vec[None, :], n))[0]

    filters0 = ve.filters[ch][0]
    temp = f32(np.float64(f32(vec[0] * vec[0]))
               + 0.7 * np.float64(vec[1]) * np.float64(vec[1])
               + 0.2 * np.float64(vec[2]) * np.float64(vec[2]))
    ptr = filters0.nearptr
    if ptr == 0:
        decay = filters0.nearDC_acc = f32(filters0.nearDC_partialacc + temp)
        filters0.nearDC_partialacc = temp
    else:
        decay = filters0.nearDC_acc = f32(filters0.nearDC_acc + temp)
        filters0.nearDC_partialacc = f32(filters0.nearDC_partialacc + temp)
    filters0.nearDC_acc = f32(filters0.nearDC_acc - filters0.nearDC[ptr])
    filters0.nearDC[ptr] = temp
    decay = f32(np.float64(decay) * (1.0 / (VE_NEARDC + 1)))
    filters0.nearptr += 1
    if filters0.nearptr >= VE_NEARDC:
        filters0.nearptr = 0
    decay = f32(np.float64(todB(decay)) * 0.5 - 15.0)

    # spread/limit/smooth (sequential decay chain)
    half = n // 2
    sp = np.empty(n // 4, np.float32)
    d = decay
    for i in range(0, half, 2):
        val = f32(f32(vec[i] * vec[i]) + f32(vec[i + 1] * vec[i + 1]))
        val = f32(todB(val) * f32(0.5))
        if val < d:
            val = d
        if val < minV:
            val = minV
        sp[i >> 1] = val
        d = f32(np.float64(d) - 8.0)

    for j in range(VE_BANDS):
        fs = ve.filters[ch][j]
        acc = f32(0.0)
        w = ve.band_win[j]
        b0 = BAND_BEGIN[j]
        for i in range(BAND_END[j]):
            acc = f32(acc + f32(sp[i + b0] * w[i]))
        acc = f32(acc * ve.band_total[j])

        this = fs.ampptr
        p = this - 1
        if p < 0:
            p += VE_AMP
        postmax = max(acc, fs.ampbuf[p])
        postmin = min(acc, fs.ampbuf[p])
        premax = f32(-99999.0)
        premin = f32(99999.0)
        for i in range(stretch):
            p -= 1
            if p < 0:
                p += VE_AMP
            premax = max(premax, fs.ampbuf[p])
            premin = min(premin, fs.ampbuf[p])
        valmin = f32(postmin - premin)
        valmax = f32(postmax - premax)
        fs.ampbuf[this] = acc
        fs.ampptr += 1
        if fs.ampptr >= VE_AMP:
            fs.ampptr = 0

        if valmax > f32(f32(gi["preecho_thresh"][j]) + penalty):
            ret |= 1 | 4
        if valmin < f32(f32(gi["postecho_thresh"][j]) - penalty):
            ret |= 2
    return ret


def envelope_search(ve: EnvelopeLookup, pcm, pcm_current, centerW, W):
    """reference: _ve_envelope_search.  pcm: (ch, pcm_current) float32.
    Returns 1 (next long ok), 0 (next short), -1 (need more data)."""
    gi = ve.gi
    bs = ve.blocksizes
    first = ve.current // ve.searchstep
    last = pcm_current // ve.searchstep - VE_WIN
    if first < 0:
        first = 0
    if last + VE_WIN + VE_POST > ve.storage:
        ve.storage = last + VE_WIN + VE_POST
        newmark = np.zeros(ve.storage, np.int64)
        newmark[:len(ve.mark)] = ve.mark
        ve.mark = newmark

    for j in range(first, last):
        ret = 0
        ve.stretch += 1
        if ve.stretch > VE_MAXSTRETCH * 2:
            ve.stretch = VE_MAXSTRETCH * 2
        for i in range(ve.ch):
            ret |= _ve_amp(ve, gi, pcm[i][ve.searchstep * j:], i)
        ve.mark[j + VE_POST] = 0
        if ret & 1:
            ve.mark[j] = 1
            ve.mark[j + 1] = 1
        if ret & 2:
            ve.mark[j] = 1
            if j > 0:
                ve.mark[j - 1] = 1
        if ret & 4:
            ve.stretch = -1

    ve.current = last * ve.searchstep

    testW = centerW + bs[W] // 4 + bs[1] // 2 + bs[0] // 4
    j = ve.cursor
    while j < ve.current - ve.searchstep:
        if j >= testW:
            return 1
        ve.cursor = j
        if ve.mark[j // ve.searchstep]:
            if j > centerW:
                ve.curmark = j
                if j >= testW:
                    return 1
                return 0
        j += ve.searchstep
    return -1


def envelope_mark(ve: EnvelopeLookup, centerW, W, lW, nW):
    bs = ve.blocksizes
    beginW = centerW - bs[W] // 4
    endW = centerW + bs[W] // 4
    if W:
        beginW -= bs[lW] // 4
        endW += bs[nW] // 4
    else:
        beginW -= bs[0] // 4
        endW += bs[0] // 4
    if beginW <= ve.curmark < endW:
        return 1
    first = beginW // ve.searchstep
    last = endW // ve.searchstep
    for i in range(first, last):
        if ve.mark[i]:
            return 1
    return 0


def envelope_shift(ve: EnvelopeLookup, shift):
    smallsize = ve.current // ve.searchstep + VE_POST
    smallshift = shift // ve.searchstep
    ve.mark[:smallsize - smallshift] = ve.mark[smallshift:smallsize]
    ve.current -= shift
    if ve.curmark >= 0:
        ve.curmark -= shift
    ve.cursor -= shift
