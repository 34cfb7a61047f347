"""Torch counterpart of vorbis_tpu/ops/jaxdsp.py: the encoder's device
analysis spine (window -> MDCT -> log spectrum -> bark noise fit ->
tone mask -> stateless offset/mix), batched over frames and channels,
and the roundtrip pipeline's synthesis (DeviceSynthesis: the decode's
IMDCT and lap kernels).

Same formulas and float32 op order as the JAX module, in torch idiom:
static index tables are tensor gathers, `segment_max` is
`scatter_reduce(..., "amax")` and the one-hot curve-row matmul (a TPU
workaround) is a plain row index.  The MDCT GEMM and bark_fit's prefix
sums accumulate in float64 and round once to float32, so the card and
the CPU give the same values (an fp32 GEMM or scan rounds in its
library's order, which differs between them).  Float results agree
with JAX to float reassociation (the sums and FFT orders differ);
tests/test_torch_analysis.py states the bounds.

Reference behavior being reproduced (file:line of the reference tree):
- bark_noise_hybridmp least-squares noise fit: lib/psy.c:3480
- noise companding: lib/psy.c _vp_noisemask
- window + forward MDCT + log spectrum: lib/mdct.c, lib/scales.h:43-52
- IMDCT + window + overlap-add: lib/mdct.c mdct_backward, lib/block.c
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import device_tables
from ..utils.scales import todB
from . import psy as PSY
from .imdct_cuda import imdct
from .lap_cuda import LapPlan, lap
from .mdct import mdct_basis_np
from .window import hybrid_window

f32 = np.float32
NEGINF = float(PSY.NEGINF)


def _c(v) -> float:
    """A float32-rounded constant as a Python scalar (torch casts it to
    the tensor dtype exactly)."""
    return float(f32(v))


def log_spectrum(mdct_coef: torch.Tensor) -> torch.Tensor:
    """logmdct = todB(mdct) + .345 (aoTuV M1 compensation add,
    reference: lib/mapping0.c logmdct computation)."""
    return todB(mdct_coef) + _c(0.345)


def _ls_terms(N, X, XX, Y, XY, lo, hi, neg_lo):
    """Windowed least-squares line-fit terms via prefix-sum gathers.
    neg_lo: True for the low-clipped region (reference adds the
    reflected prefix instead of subtracting)."""
    if neg_lo:
        tN = N[..., hi] + N[..., -lo]
        tX = X[..., hi] - X[..., -lo]
        tXX = XX[..., hi] + XX[..., -lo]
        tY = Y[..., hi] + Y[..., -lo]
        tXY = XY[..., hi] - XY[..., -lo]
    else:
        tN = N[..., hi] - N[..., lo]
        tX = X[..., hi] - X[..., lo]
        tXX = XX[..., hi] - XX[..., lo]
        tY = Y[..., hi] - Y[..., lo]
        tXY = XY[..., hi] - XY[..., lo]
    A = tY * tXX - tX * tXY
    B = tN * tXY - tX * tY
    D = tN * tXX - tX * tX
    return A, B, D


def _cumsum64(x):
    """Prefix sums over the last axis, accumulated in float64 and rounded
    once to float32: the card's scan and the CPU's loop add in other
    orders, and in float64 both round to the same float32 except where
    the sum's error meets a float32 rounding boundary."""
    return torch.cumsum(x.double(), -1).float()


def bark_fit(fvec, bark_lo, bark_hi, offset, fixed, i1, i2, j1, j2):
    """Batched bark-windowed weighted LS line fit (reference:
    lib/psy.c bark_noise_hybridmp).  fvec: (..., n) f32; bark_lo/hi
    long index tensors on fvec's device; the region boundaries are
    static."""
    n = fvec.shape[-1]
    dev = fvec.device
    x = torch.arange(n, dtype=torch.float32, device=dev)
    y = torch.clamp_min(fvec + _c(offset), 1.0)
    w = y * y
    w0_half = w[..., :1] * 0.5
    wx = w * x
    wxx = wx * x
    wy = w * y
    wxy = wx * y
    zero = torch.zeros_like(w0_half)
    N = _cumsum64(torch.cat([w0_half, w[..., 1:]], -1))
    X = _cumsum64(torch.cat([w0_half, wx[..., 1:]], -1))
    XX = _cumsum64(torch.cat([zero, wxx[..., 1:]], -1))
    Y = _cumsum64(torch.cat([w0_half * y[..., :1], wy[..., 1:]], -1))
    XY = _cumsum64(torch.cat([zero, wxy[..., 1:]], -1))

    def fit_regions(lo, hi, k1, k2):
        A1, B1, D1 = _ls_terms(N, X, XX, Y, XY, lo[:k1], hi[:k1], True)
        A2, B2, D2 = _ls_terms(N, X, XX, Y, XY, lo[k1:k2], hi[k1:k2],
                               False)
        A = torch.cat([A1, A2], -1)
        B = torch.cat([B1, B2], -1)
        D = torch.cat([D1, D2], -1)
        if k2 < n:
            # extrapolate the last in-range fit across the tail
            tail = A.shape[:-1] + (n - k2,)
            Al = A[..., k2 - 1:k2] if k2 > 0 else zero
            Bl = B[..., k2 - 1:k2] if k2 > 0 else zero
            Dl = D[..., k2 - 1:k2] if k2 > 0 else torch.ones_like(zero)
            A = torch.cat([A, Al.expand(tail)], -1)
            B = torch.cat([B, Bl.expand(tail)], -1)
            D = torch.cat([D, Dl.expand(tail)], -1)
        return (A + x * B) / D

    R = fit_regions(bark_lo, bark_hi, i1, i2)
    noise = torch.clamp_min(R, 0.0) - _c(offset)
    if fixed > 0:
        idx = np.arange(n)
        hi_f = torch.as_tensor(np.minimum(idx + fixed // 2, n - 1),
                               device=dev)
        lo_f = torch.as_tensor(idx + fixed // 2 - fixed, device=dev)
        Rf = fit_regions(lo_f, hi_f, j1, j2)
        noise = torch.minimum(noise, torch.clamp_min(Rf, 0.0) - _c(offset))
    return noise


class DeviceAnalysis:
    """Batched encoder analysis spine on `device`: window -> MDCT ->
    log spectrum -> two-pass bark noise fit -> companded noise mask.

    Mirrors mapping0_forward's per-channel front half
    (lib/mapping0.c + _vp_noisemask) for the long-block path.  Host
    setup is line-aligned with jaxdsp.DeviceAnalysis.__init__."""

    def __init__(self, setup, blocktype=3, rate=44100, W=1, *, device):
        self.device = torch.device(device)
        bs = setup.vi.blocksizes
        self.W = W
        self.n = bs[W]
        n2 = self.n // 2
        self.n2 = n2
        look = PSY.PsyLook(setup.psy_params[blocktype], setup.psy_global,
                           n2, rate)
        self.look = look
        # aoTuV M4 (floor boost guard) static region + M1 scale factor
        # (reference: psy.c _vp_offset_and_mix mp4 setup, psy.c:4304-4330
        # and the M1 block psy.c:4434-4459)
        vi_p = look.vi
        ff = setup.floor_full
        end_block = int(ff[W if len(ff) > 1 else 0]["n"])
        hsrate = 0 if rate < 26000 else 1
        m4_end_block = min(end_block + int(vi_p["normal_partition"]), n2)
        if not hsrate:
            m4_end = m4_end_block
        else:
            m4_end = look.tonecomp_endp
        m4_start = int(vi_p["normal_start"])
        if hsrate and vi_p["normal_thresh"] > 1.0:
            m4_start = 9999
        self.m4_start = m4_start
        self.m4_end = m4_end
        self.m4_thres = f32(look.tonecomp_thres)
        self.m_val = f32(look.m_val)
        self.hsrate = hsrate
        tabs = {}
        if W:
            # windows for the 4 (lW, nW) neighbor shapes; index
            # wid = lW*2 + nW selects per frame (block switching)
            tabs["windows4"] = np.stack(
                [hybrid_window(bs[0], bs[1], l, 1, nw)
                 for l in (0, 1) for nw in (0, 1)]).astype(np.float32)
            tabs["window"] = tabs["windows4"][3]
        else:
            tabs["window"] = np.asarray(
                hybrid_window(bs[0], bs[1], 0, 0, 0), np.float32)
        bark = np.asarray(look.bark)
        tabs["bark_lo"] = (bark >> 16).astype(np.int64)
        self.bark_hi_raw = (bark & 0xFFFF).astype(np.int32)
        tabs["bark_hi"] = np.minimum(self.bark_hi_raw, n2 - 1).astype(
            np.int64)
        lo = (bark >> 16).astype(np.int64)
        hi = self.bark_hi_raw.astype(np.int64)
        i1 = 0
        while i1 < n2 and lo[i1] < 0 and -lo[i1] < n2 and hi[i1] < n2:
            i1 += 1
        i2 = i1
        while i2 < n2 and 0 <= lo[i2] < n2 and hi[i2] < n2:
            i2 += 1
        self.i1, self.i2 = i1, i2
        fixed = int(look.vi["noisewindowfixed"])
        self.fixed = fixed
        idx = np.arange(n2)
        hi_f = idx + fixed // 2
        lo_f = hi_f - fixed
        j1 = 0
        while j1 < n2 and hi_f[j1] < n2 and lo_f[j1] < 0:
            j1 += 1
        j2 = j1
        while j2 < n2 and hi_f[j2] < n2 and lo_f[j2] >= 0:
            j2 += 1
        self.j1, self.j2 = j1, j2
        tabs["noisecompand"] = np.asarray(look.vi["noisecompand"],
                                          np.float32)
        tabs["noiseoffsets"] = np.asarray(look.noiseoffset,
                                          np.float32)[:, :n2]
        # per-frame blocktype support: the ONLY psy param that differs
        # between the paired blocktypes (impulse vs padding,
        # transition vs long) in EVERY reference template is the
        # noise-bias curve, so mixed-blocktype batches reduce to
        # selecting between two noiseoffset rows per frame (the
        # trans/impulse flag rides the finish step)
        alt_bt = {0: 1, 1: 0, 2: 3, 3: 2}.get(blocktype, blocktype)
        alt_bt = min(alt_bt, len(setup.psy_params) - 1)
        if alt_bt != blocktype:
            alt_look = PSY.PsyLook(setup.psy_params[alt_bt],
                                   setup.psy_global, n2, rate)
            tabs["noiseoffsets_alt"] = np.asarray(
                alt_look.noiseoffset, np.float32)[:, :n2]
        else:
            tabs["noiseoffsets_alt"] = tabs["noiseoffsets"]
        tabs["ath"] = np.asarray(look.ath, np.float32)
        tabs["mdct_basis"] = mdct_basis_np(self.n)
        # M4 region as a static bin mask
        bins = np.arange(n2)
        tabs["in_m4"] = (bins > m4_start) & (bins < m4_end)
        vars(self).update(device_tables(tabs, self.device))
        # the MDCT accumulates in float64 (mdct)
        self.mdct_basis64 = self.mdct_basis.double()
        self.noiseoffset = self.noiseoffsets[1]
        self.noisemaxsupp = _c(look.vi["noisemaxsupp"])
        self.toneatts = [_c(a) for a in look.vi["tone_masteratt"]]
        self.toneatt1 = self.toneatts[1]
        self.tonemask = DeviceToneMask(look, self.device)

    def windowed(self, frames, wid=None):
        """wid: optional per-row window-shape id (lW*2+nW, long mode)."""
        if wid is None:
            return frames * self.window
        return frames * self.windows4[wid.long()]

    def mdct(self, w):
        """Forward MDCT of windowed frames: one GEMM against the basis,
        accumulated in float64 and rounded once to float32.  An fp32
        GEMM rounds in its library's reduction order, which differs
        between the card (cuBLAS picks it by shape) and the CPU; the
        float64 sum rounds to the same float32 on both except where its
        error meets a float32 rounding boundary.  The JAX module runs
        the butterfly, which rounds otherwise
        (tests/test_torch_analysis.py bounds the difference)."""
        return torch.matmul(w.double(), self.mdct_basis64).float()

    def spectra(self, frames, wid=None, with_fft=False):
        """The per-frame DSP front: window -> MDCT -> log spectrum ->
        two-pass bark noise fit.  Returns (md, logmdct, fit1, dB
        [, logfft]): fit1 is the first fit exactly as _vp_noisemask
        leaves its `work` buffer, dB the clipped compand index from the
        second fit.  The stateful finish pass
        (ops/psydevice.noisemask_tail) consumes these."""
        w = self.windowed(frames, wid)
        md = self.mdct(w)                          # (..., n/2)
        logmdct = log_spectrum(md)
        # pass 1: wide bark window, offset 140
        mask = bark_fit(logmdct, self.bark_lo, self.bark_hi, 140.0, -1,
                        self.i1, self.i2, self.j1, self.j2)
        work = logmdct - mask
        # pass 2: refit of the residual with the fixed window minimum
        mask2 = bark_fit(work, self.bark_lo, self.bark_hi, 0.0,
                         self.fixed, self.i1, self.i2, self.j1, self.j2)
        fit1 = logmdct - work
        # companding index (lib/psy.c: dB = logmask+.5 int index)
        dB = torch.clamp((mask2 + 0.5).to(torch.int32), 0,
                         PSY.NOISE_COMPAND_LEVELS - 1)
        if not with_fft:
            return md, logmdct, fit1, dB
        return md, logmdct, fit1, dB, self.logfft(w)

    def logfft(self, w):
        """Tone-analysis log spectrum of the windowed frames
        (reference uses drft; |rfft|^2 gives the same power)."""
        sp = torch.fft.rfft(w, dim=-1)[..., :self.n2]
        power = sp.real * sp.real + sp.imag * sp.imag
        scale = f32(4.0 / self.n)
        return (todB(power * float(scale * scale)) * 0.5
                + _c(0.345) + _c(0.345))

    def __call__(self, frames):
        """frames: (..., n) f32 PCM -> (mdct, logmdct, noise_mask)."""
        md, logmdct, fit1, dB = self.spectra(frames)
        noise = fit1 + self.noisecompand[dB.long()]
        return md, logmdct, noise + self.noiseoffset

    def offset_and_mix(self, md, logmdct, noise, tone, select=1):
        """The stateless core of _vp_offset_and_mix (psy.c:4274-4502)
        for one offset_select: noise/tone mix with the aoTuV M4 floor
        boost guard and (select 1 only) the M1 relative-MDCT scaling.
        Returns (scaled_md, mask)."""
        val = torch.clamp_max(noise + self.noiseoffsets[select],
                              self.noisemaxsupp)
        tval = tone + self.toneatts[select]
        return self.mix_m4_m1(md, logmdct, val, tval, select)

    def mix_m4_m1(self, md, logmdct, val, tval, select):
        """M4 + (select 1) M1 tail of offset_and_mix."""
        # M4 (psy.c:4411-4423): where the tone curve governs inside
        # [m4_start, m4_end], pull it toward the noise val when the
        # spectrum itself sits below it
        adj = torch.where(logmdct < val,
                          tval - (tval - val) * float(self.m4_thres),
                          logmdct)
        tval_m4 = torch.where(self.in_m4 & (logmdct < tval), adj, tval)
        mask = torch.where(val > tval, val, tval_m4)
        if select == 1:
            # M1 (psy.c:4434-4459): scale the MDCT line by how far the
            # mask sits above the spectrum
            v2 = val - logmdct
            m1c = _c(-17.2)
            de_hi = 1.0 - (v2 - m1c) * float(f32(0.005) * self.m_val)
            de_lo = 1.0 - (v2 - m1c) * float(f32(0.0003) * self.m_val)
            de_hi = torch.where(de_hi < 0, _c(0.0001), de_hi)
            de = torch.where(v2 > m1c, de_hi, de_lo)
            md = md * de
        return md, mask

    def full_mask(self, frames, wid=None):
        """Complete fast-path masking chain: MDCT + FFT spectra, noise
        fit, tone seeding, and the stateless _vp_offset_and_mix core
        (offset_select=1 path with M1/M4).  wid: optional per-row
        window-shape id (long mode).  Returns (mdct, logmdct,
        final_mask)."""
        md, logmdct, noise, tone = self.mask_components(frames, wid)
        md, mask = self.offset_and_mix(md, logmdct, noise, tone, 1)
        return md, logmdct, mask

    def mask_components(self, frames, wid=None):
        """(mdct, logmdct, noise_base, tone): noise_base excludes the
        per-offset noiseoffset row."""
        md, logmdct, fit1, dB, logfft = self.spectra(frames, wid,
                                                     with_fft=True)
        noise = fit1 + self.noisecompand[dB.long()]
        local_max = torch.clamp_max(logfft.amax(-1), 0.0)
        global_max = local_max  # stateless: no cross-block ampmax decay
        tone = self.tonemask(logfft, global_max, local_max)
        return md, logmdct, noise, tone

    def managed_masks(self, frames, wid=None):
        """(mdct, logmdct, masks (..., 3, n2)): the three
        offset_select mask variants that anchor the 15 packetblob
        interpolation ladder (reference: mapping0.c:1090-1181)."""
        md, logmdct, noise, tone = self.mask_components(frames, wid)
        # select order mirrors the reference (mapping0.c:1090-1181):
        # mask1 first -- its M1 pass rescales the mdct used by every blob
        md, m1 = self.offset_and_mix(md, logmdct, noise, tone, 1)
        _, m2 = self.offset_and_mix(md, logmdct, noise, tone, 2)
        _, m0 = self.offset_and_mix(md, logmdct, noise, tone, 0)
        return md, logmdct, torch.stack([m0, m1, m2], dim=-2)


class DeviceToneMask:
    """Batched fast-path tone masking (reference: lib/psy.c
    _vp_tonemask / seed_loop / seed_chase / max_seeds); host setup is
    line-aligned with jaxdsp.DeviceToneMask.__init__.

      - per-octave-group spectral max  -> scatter_reduce amax
      - curve seeding                  -> 56 static gathers + running
        max (amplitude picks the curve row by a plain index)
      - seed chase                     -> sliding-window max over
        eighth-octave lines
      - linear-domain windowed min     -> sparse-table range min + ATH
    """

    def __init__(self, look, device):
        self.device = torch.device(device)
        self.look = look
        n = look.n
        octave = np.asarray(look.octave[:n], np.int64)
        self.linesper = int(look.eighth_octave_lines)
        self.total = int(look.total_octave_lines)
        # octave groups (seed_loop's i runs over equal-octave spans)
        group_id = np.concatenate([[0], np.cumsum(octave[1:]
                                                  != octave[:-1])])
        self.n_groups = int(group_id[-1]) + 1
        first = np.searchsorted(group_id, np.arange(self.n_groups))
        group_oc0 = octave[first]
        # static per-(group, ehmer k) seed target lines; because group
        # base lines are unique, the deposit is a static GATHER per k:
        # line t takes its value from group g where
        # t == base_g + (k-16)*linesper - linesper/2
        oc_rel = group_oc0 - look.firstoc
        line2group = np.full(self.total, -1, np.int64)
        in_range = (oc_rel >= 0) & (oc_rel < self.total)
        line2group[oc_rel[in_range]] = np.nonzero(in_range)[0]
        ks = np.arange(PSY.EHMER_MAX)
        offs = (ks - PSY.EHMER_OFFSET) * self.linesper \
            - (self.linesper >> 1)
        lines = np.arange(self.total)
        src_line = lines[None, :] - offs[:, None]        # (E, T)
        ok = (src_line >= 0) & (src_line < self.total) \
            & (lines[None, :] > 0)
        srcg = np.where(ok, line2group[np.clip(src_line, 0,
                                               self.total - 1)], -1)
        # curves: (P_BANDS, P_LEVELS, 2+EHMER) -> rows indexed by
        # oc_band*P_LEVELS + level
        oc_band = np.clip(group_oc0 >> look.shiftoc, 0, PSY.P_BANDS - 1)
        curves = np.asarray(look.tonecurves, np.float32)
        self.p_levels = curves.shape[1]
        # linear-domain windows (max_seeds): reproduce the scalar walk
        # statically
        starts = np.empty(n, np.int64)
        ends = np.empty(n, np.int64)
        pos = octave[0] - look.firstoc - (self.linesper >> 1)
        linpos = 0
        while linpos + 1 < n:
            end = ((octave[linpos] + octave[linpos + 1]) >> 1) \
                - look.firstoc
            seg_start = pos
            pos = max(pos, min(end, self.total - 1))
            end_oc = pos + look.firstoc
            j = linpos
            while j < n and octave[j] <= end_oc:
                starts[j] = max(seg_start, 0)
                ends[j] = max(pos, 0)
                j += 1
            linpos = j
        starts[linpos:] = self.total - 1
        ends[linpos:] = self.total - 1
        self.win_start = starts
        self.win_end = ends
        # sparse-table plan (static): level k_j and the two lookups per
        # bin
        wlen = ends - starts + 1
        self.kmax = int(np.floor(np.log2(wlen.max()))) if wlen.max() > 1 \
            else 0
        k_j = np.floor(np.log2(np.maximum(wlen, 1))).astype(np.int64)
        self.levels_used = [k for k in range(self.kmax + 1)
                            if (k_j == k).any()]
        tabs = dict(
            group_id=group_id.astype(np.int64),
            group_first=first.astype(np.int64),
            group_band=oc_band.astype(np.int64),
            seed_src=np.clip(srcg, 0, None).astype(np.int64),  # (E, T)
            seed_ok=srcg >= 0,
            curve_rows=curves.reshape(-1, curves.shape[-1]),
            ath=np.asarray(look.ath, np.float32),
            k_mask=np.stack([k_j == k for k in range(self.kmax + 1)]),
            win_lo=starts.astype(np.int64),
            win_hi=np.stack([np.maximum(ends - (1 << k) + 1, 0)
                             for k in range(self.kmax + 1)]),
        )
        vars(self).update(device_tables(tabs, self.device))
        self.tone_abs_limit = _c(look.vi["tone_abs_limit"])
        self.ath_adjatt = _c(look.vi["ath_adjatt"])
        self.ath_maxatt = _c(look.vi["ath_maxatt"])
        self.max_curve_dB = _c(look.vi["max_curve_dB"])

    def __call__(self, logfft, global_specmax, local_specmax):
        """logfft: (R, n); specmax (R,) tensors."""
        att = torch.clamp_min(local_specmax + self.ath_adjatt,
                              self.ath_maxatt)
        flr = self.ath + att[..., None]
        # per-group max
        lead = logfft.shape[:-1]
        gmax = torch.full(lead + (self.n_groups,), -float("inf"),
                          dtype=torch.float32, device=logfft.device)
        gmax = gmax.scatter_reduce(-1, self.group_id.expand(logfft.shape),
                                   logfft, "amax", include_self=True)
        dBoffset = self.max_curve_dB - global_specmax[..., None]
        level = torch.clamp(((gmax + dBoffset - _c(PSY.P_LEVEL_0))
                             * _c(0.1)).to(torch.int32),
                            0, self.p_levels - 1)
        rows = self.group_band * self.p_levels + level      # (R, G)
        curves = self.curve_rows[rows]                      # (R, G, 2+E)
        post0 = curves[..., 0].to(torch.int32)
        post1 = curves[..., 1].to(torch.int32)
        audible = gmax + 6.0 > flr[..., self.group_first]
        # seed deposit: 56 static gathers + running max
        seed = torch.full(lead + (self.total,), NEGINF,
                          dtype=torch.float32, device=logfft.device)
        for k in range(PSY.EHMER_MAX):
            vk = gmax + curves[..., 2 + k]
            act = (k >= post0) & (k < post1) & audible
            vk = torch.where(act, vk, NEGINF)
            contrib = vk[..., self.seed_src[k]]
            contrib = torch.where(self.seed_ok[k], contrib, NEGINF)
            seed = torch.maximum(seed, contrib)
        # chase: extend seeds across one eighth-octave (sliding max)
        ext = seed
        for s in range(1, self.linesper):
            shifted = torch.nn.functional.pad(seed[..., :-s], (s, 0),
                                              value=NEGINF)
            ext = torch.maximum(ext, shifted)
        # windowed min over [start_j, end_j] back in the linear domain:
        # sparse-table (dyadic) range-min
        run = torch.where(ext > NEGINF, ext, float("inf"))
        levels = [run]
        for k in range(self.kmax):
            prev = levels[-1]
            sh = 1 << k
            levels.append(torch.minimum(prev, torch.nn.functional.pad(
                prev[..., sh:], (0, sh), value=float("inf"))))
        minv = torch.full(flr.shape, float("inf"), dtype=torch.float32,
                          device=logfft.device)
        for k in self.levels_used:
            a = levels[k][..., self.win_lo]
            b = levels[k][..., self.win_hi[k]]
            minv = torch.where(self.k_mask[k], torch.minimum(a, b), minv)
        # seedless windows must stay at the ATH floor
        minv = torch.where(torch.isfinite(minv),
                           torch.clamp_max(minv, self.tone_abs_limit),
                           NEGINF)
        return torch.maximum(flr, minv)


class DeviceSynthesis:
    """Batched decoder back half on `device`: spectrum -> IMDCT ->
    window -> overlap-add (reference: lib/mdct.c mdct_backward +
    lib/block.c vorbis_synthesis_blockin lapping), counterpart of
    jaxdsp.DeviceSynthesis.

    On the card it is the decode's two kernels and nothing between
    them: one launch of csrc/imdct.cu for every row of the batch, then
    one of csrc/lap.cu, each leading index one stream whose frame f is a
    long-long block at f*n/2, trimmed to [0, F*n/2).  On the CPU the
    same two wrappers run their plain versions.  The lap sums every
    sample from +0 ((+0 + prev) + cur), where the JAX module leaves
    frame 0's first half unsummed: a -0.0 there reads +0.0, equal in
    value.  `tail` and `with_halo` carry the one cross-frame dependency
    between shards of the frame axis (parallel/mesh.py): a shard's
    `with_halo` also returns its last frame's windowed second half (the
    lap run n/2 past the trim), which the next shard takes as `tail`,
    its streams' initial values over [0, n/2)."""

    def __init__(self, n=2048, *, device):
        self.n = n
        self.device = torch.device(device)
        self.window = torch.from_numpy(
            hybrid_window(n // 8, n, 1, 1, 1)).to(self.device)
        self._plans = {}

    def __call__(self, spec, tail=None):
        """spec: (..., F, n/2) -> pcm (..., F*n/2) long-block stream;
        tail: (..., n/2), added under frame 0's first half."""
        return self._synth(spec, tail, False)[0]

    def with_halo(self, spec, tail=None):
        """(pcm (..., F*n/2), halo (..., n/2)): the halo is the last
        frame's windowed second half, the next shard's `tail`."""
        return self._synth(spec, tail, True)

    def _plan(self, S, F, tail, halo):
        """The lap of S streams of F frames (LapPlan, with its tables on
        the device), made once for each shape."""
        key = (S, F, tail, halo)
        if key not in self._plans:
            n, n2 = self.n, self.n // 2
            f = np.arange(F, dtype=np.int64)
            plan = LapPlan(
                [(1, np.full(F, n), f * n2, (k * F + f) * n,
                  np.zeros(F, np.int64), 0, F * n2 + (n2 if halo else 0))
                 for k in range(S)],
                tails=[(k * n2, n2, 0, n2) for k in range(S)] if tail
                else None)
            tables = (None if self.device.type == "cpu" else tuple(
                torch.from_numpy(a).to(self.device) for a in (plan.pk,
                                                              plan.st)))
            self._plans[key] = (plan, tables)
        return self._plans[key]

    def _synth(self, spec, tail, halo):
        n, n2 = self.n, self.n // 2
        lead, F = spec.shape[:-2], spec.shape[-2]
        S = int(np.prod(lead, dtype=np.int64))
        blocks = imdct(spec.reshape(S * F, n2).contiguous(), n)
        plan, tables = self._plan(S, F, tail is not None, halo)
        out = lap(blocks.reshape(-1), self.window, plan, tables=tables,
                  tails=None if tail is None
                  else tail.reshape(S * n2).contiguous())
        out = out.reshape(S, -1)
        pcm = out[:, :F * n2].reshape(lead + (F * n2,))
        return pcm, (out[:, F * n2:].reshape(lead + (n2,)) if halo
                     else None)


def block_cumsum(x, base=16):
    """Prefix sum over the last axis in the summation order of the JAX
    package's `jnp.cumsum` on the CPU (XLA rewrites the cumulative
    reduce-window into blocks of `base`): a sequential sum inside each
    block, the blocks' totals scanned the same way recursively, and
    each block's exclusive prefix added to its elements.  Written as
    explicit adds, so the card rounds exactly as the CPU does (a
    library scan would sum in its own order)."""
    n = x.shape[-1]
    if n == 0:
        return x
    m = -(-n // base) * base
    blk = torch.nn.functional.pad(x, (0, m - n)).reshape(
        x.shape[:-1] + (m // base, base))
    cols = [blk[..., 0]]
    for k in range(1, base):
        cols.append(cols[-1] + blk[..., k])
    inner = torch.stack(cols, -1)
    if m // base > 1:
        pre = block_cumsum(inner[..., -1], base)
        excl = torch.nn.functional.pad(pre[..., :-1], (1, 0))
        inner = inner + excl[..., None]
    return inner.reshape(x.shape[:-1] + (m,))[..., :n]


class DeviceEnvelope:
    """Batched transient detector for the fast encoder's block
    switching (reference: lib/envelope.c _ve_envelope_search/_ve_amp),
    counterpart of jaxdsp.DeviceEnvelope (`__init__`, `marks`,
    `marks_nd`; host setup line for line).

    Per 64-sample step: a sin^2-windowed 128-point MDCT per channel
    (one fp32 GEMM against the basis, TF32 off), 12 weighted bands
    through pre/post-echo threshold triggers, at the FIXED
    steady-state stretch (VE_MAXSTRETCH) and its penalty; the exact
    serial stretch is restored around candidate marks by
    FastEncoder._stretch_rescue."""

    def __init__(self, gi, ch, *, device):
        from .envelope import (BAND_BEGIN, BAND_END, VE_BANDS,
                               VE_MAXSTRETCH, VE_NEARDC)
        import math as _m
        self.device = torch.device(device)
        self.ch = ch
        n = 128
        i = np.arange(n)
        t = np.sin(i / (n - 1.0) * _m.pi).astype(np.float32)
        tabs = {"mdct_win": (t * t).astype(np.float32),
                "mdct_basis": mdct_basis_np(n)}
        # band matrix (32 sp bins -> 12 bands, weights * 1/total)
        Bm = np.zeros((32, VE_BANDS), np.float32)
        for j in range(VE_BANDS):
            bn = BAND_END[j]
            wv = np.sin((np.arange(bn) + 0.5) / bn * _m.pi)
            Bm[BAND_BEGIN[j]:BAND_BEGIN[j] + bn, j] = \
                (wv / wv.sum()).astype(np.float32)
        tabs["Bm"] = Bm
        self.minV = _c(gi["preecho_minenergy"])
        self.stretch = VE_MAXSTRETCH
        pen = max(0.0, float(gi["stretch_penalty"])
                  - (VE_MAXSTRETCH - 2))
        tabs["pre_thr"] = (np.asarray(gi["preecho_thresh"], np.float32)
                           + f32(pen))
        tabs["post_thr"] = (np.asarray(gi["postecho_thresh"], np.float32)
                            - f32(pen))
        vars(self).update(device_tables(tabs, self.device))
        self.neardc = VE_NEARDC

    def marks(self, x):
        """x: (ch, S) f32 PCM (S multiple of 64) -> (S//64 - 1,) bool
        mark flags, one per 64-sample search window."""
        return self.marks_nd(x[:, None, :])[0]

    def band_amps(self, frames):
        """Per-step band amplitudes: frames (..., steps, 128) f32 ->
        (..., steps, 12), the math of jaxdsp's marks_nd up to its band
        einsum (the stretch rescue's trigger tables reuse it)."""
        vec = torch.matmul(frames * self.mdct_win, self.mdct_basis)
        temp = (vec[..., 0] * vec[..., 0]
                + _c(0.7) * vec[..., 1] * vec[..., 1]
                + _c(0.2) * vec[..., 2] * vec[..., 2])
        cs = block_cumsum(temp)
        w = self.neardc + 1
        win = cs - torch.nn.functional.pad(cs[..., :-w], (w, 0))
        decay = todB(win * _c(1.0 / w)) * _c(0.5) - _c(15.0)
        pairs = (vec[..., 0::2] * vec[..., 0::2]
                 + vec[..., 1::2] * vec[..., 1::2])[..., :32]
        kk = torch.arange(32, dtype=torch.float32, device=frames.device)
        d = decay[..., None] - 8.0 * kk
        sp = torch.clamp_min(torch.maximum(todB(pairs) * _c(0.5), d),
                             self.minV)
        return torch.matmul(sp, self.Bm)

    def marks_nd(self, x):
        """Batched variant: x (ch, NC, S) -> (NC, S//64 - 1) bool.
        The chunk axis lets one dispatch cover every envelope window
        of a whole batch of streams (encode_batch)."""
        ch, NC, S = x.shape
        x64 = x.reshape(ch, NC, S // 64, 64)
        frames = torch.cat([x64[..., :-1, :], x64[..., 1:, :]], -1)
        acc = self.band_amps(frames)                    # (ch,NC,st,12)
        prev = torch.nn.functional.pad(acc[:, :, :-1], (0, 0, 1, 0),
                                       value=-99999.0)
        postmax = torch.maximum(acc, prev)
        postmin = torch.minimum(acc, prev)
        premax = torch.full_like(acc, -99999.0)
        premin = torch.full_like(acc, 99999.0)
        for s in range(2, 2 + self.stretch):
            sh = torch.nn.functional.pad(acc[:, :, :-s], (0, 0, s, 0),
                                         value=-99999.0)
            premax = torch.maximum(premax, sh)
            premin = torch.minimum(premin, torch.where(
                sh <= -99998.0, 99999.0, sh))
        trig1 = ((postmax - premax) > self.pre_thr).any(-1).any(0)
        trig2 = ((postmin - premin) < self.post_thr).any(-1).any(0)
        t1p = torch.nn.functional.pad(trig1[:, :-1], (1, 0))
        t2n = torch.nn.functional.pad(trig2[:, 1:], (0, 1))
        return trig1 | t1p | trig2 | t2n
