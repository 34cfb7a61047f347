"""Torch counterpart of vorbis_tpu/ops/managed.py: the managed (ABR/CBR)
fast encode, the 15-packetblob pass on the device.

Reference behavior (lib/mapping0.c:1090-1313 + lib/bitrate.c:73-227):
under bitrate management every block computes THREE floor fits (the
offset_select 0/1/2 psy masks), interpolates them into 15 candidate
post ladders, fully encodes all 15 packet variants (floor wrap coding,
per-blob coupling thresholds and sliding lowpass, residue VQ, Huffman),
and the reservoir "floater" picks which blob to emit, truncating or
zero-padding at the hard min/max walls.

The 15 variants are data-parallel: the blob axis folds into the frame
batch as rows (F, blob, ch), so one finish step encodes (F x 15)
packets; the host runs only the serial reservoir walk over the (F, 15)
sizes and fetches just the chosen packets by a device gather (1/15th of
the packet bytes cross to the host).

Differences from the JAX module, all exact:
  * the three floor fits of a batch run as ONE fit of 3*F*ch rows (the
    CUDA kernels csrc/floor_prepare.cu and csrc/floor_fit.cu on the
    card, one launch each): the selects' rows are stacked before the
    prepare; rows are independent, so the posts equal three fits;
  * the M3 scan of each select is the short ctx's m3_scan (the kernel
    csrc/m3_scan.cu on the card), three calls as JAX makes them.
ReservoirChooser (the host floater) is a verbatim copy of the JAX
module's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import device_tables

PACKETBLOBS = 15


def _interp_posts(pA, pB, uA, uB, delta):
    """floor1_interpolate_fit on device (floor1.c:752): int post
    interpolation in the raw fit domain, 0x8000 only when both ends
    interpolate.  int32 throughout, as JAX wraps; delta may be a
    tensor that broadcasts against the posts."""
    out = ((65536 - delta) * (pA & 0x7FFF) + delta * (pB & 0x7FFF)
           + 32768) >> 16
    flag = ((pA & 0x8000) != 0) & ((pB & 0x8000) != 0)
    return torch.where(flag, out | 0x8000, out), uA & uB


def _blob_ladder(ps, us):
    """The 15-way post ladder from the three offset_select fits
    (floor1_interpolate_fit; endpoints gated on the middle fit like
    the reference blob loop, mapping0.c:1204-1313), all 15 blobs in
    one pass: blobs 0-6 interpolate fits 0 and 1 at k/7, blobs 7-14
    fits 1 and 2 at (k-7)/7, then blobs 0, 7 and 14 take the fits
    themselves and blob 7 the middle fit's used flag.  Returns (posts
    (15, R, P) int32, used (15, R))."""
    k = torch.arange(PACKETBLOBS, device=ps[0].device)
    lo = (k >= 7).long()                        # the pair's first fit
    delta = (torch.where(k < 7, k, k - 7) * 65536 // 7).to(torch.int32)
    p3, u3 = torch.stack(ps), torch.stack(us)
    lad, ul = _interp_posts(p3[lo], p3[lo + 1], u3[lo], u3[lo + 1],
                            delta[:, None, None])
    lad[0], lad[7], lad[14] = p3[0], p3[1], p3[2]
    ul[7] = u3[1]
    return lad, ul


def floor3(floor, logmdct, masks):
    """The three offset_select fits of one batch as one fit of 3*R
    rows: masks [m0, m1, m2], each (R, n2).  Returns ([posts] * 3,
    [used] * 3).  The prepare and the fit (one kernel launch each on
    the card) treat every row alone, so the stacked rows give what three
    fits give."""
    R = logmdct.shape[0]
    quant, above, prefix, used = floor.prepare(
        torch.cat([logmdct] * 3), torch.cat(masks))
    posts = floor.fit(quant, above, prefix)
    return list(posts.split(R)), list(used.split(R))


class DeviceManagedEncode:
    """Managed encode steps on fe.device: frames -> 15 packed packet
    variants per frame + their bit counts."""

    def __init__(self, fe, W=1):
        from ..models.fastenc import _couple_params
        self.fe = fe
        # share the encoder's per-W DeviceFastEncode (same plans and
        # tables the unmanaged pipeline uses)
        self.dev = fe._dev_for(W)
        self.W = W
        ctx = self.dev.ctx
        self.ctx = ctx
        n2 = ctx.n // 2
        self.n2 = n2
        g = fe.setup.psy_global
        # psy blocktype for this block mode: impulse (0) for the short
        # pipeline of a switching encoder, the encoder's main
        # blocktype otherwise
        bt = fe.blocktype if W == fe.W_main else 0
        self.blocktype = bt
        tabs = {}
        # per-blob coupling thresholds (res2 streams)
        if self.dev.res_type == 2:
            thr1 = np.zeros((PACKETBLOBS, n2), np.float32)
            threv = np.zeros((PACKETBLOBS, n2), np.float32)
            limit = np.zeros(PACKETBLOBS, np.int64)
            for k in range(PACKETBLOBS):
                cp = _couple_params(fe.setup, bt, W, n2, blob=k)
                thr1[k] = cp["thr1"]
                threv[k] = cp["threv"]
                limit[k] = cp["limit"]
            self.thr1_15 = thr1
            self.threv_15 = threv
            bins = np.arange(n2)
            self.inlimit_15 = (bins[None, :]
                               >= limit[:, None])          # (15, n2)
            tabs.update(thr1_15=thr1, threv_15=threv,
                        inlimit_15=self.inlimit_15)
        # per-blob sliding lowpass (bins), capped at n2
        sl = np.asarray(g["sliding_lowpass"][1 if W else 0],
                        np.int64)[:PACKETBLOBS]
        self.lowpass_15 = np.minimum(sl, n2).astype(np.int32)
        tabs["lowpass_15"] = self.lowpass_15
        self.t = device_tables(tabs, fe.device)

    # -- the shared tail: ladder, blob fold, per-blob tables -------------
    def ladder_rows(self, ps, us, F):
        """The 15-way ladder of the three fits, the blob axis folded
        into the frame batch as rows (F, blob, ch): (posts (F*15*ch, P),
        used (F*15*ch,))."""
        ch, NB, P = self.dev.ch, PACKETBLOBS, ps[0].shape[-1]
        lad, ul = _blob_ladder(ps, us)             # (NB, F*ch, ...)
        p15 = lad.reshape(NB, F, ch, P).transpose(0, 1) \
            .reshape(F * NB * ch, P)
        u15 = ul.reshape(NB, F, ch).transpose(0, 1).reshape(F * NB * ch)
        return p15, u15

    def blob_rows(self, F, md, epeak=None, npeak=None, wid=None):
        """md and the per-row finish arguments over the rows (F, blob,
        ch): each frame's rows repeated for its 15 blobs, with each
        blob's sliding lowpass and (res2) the 15 blobs' coupling rows,
        which the coupling reads by frame % 15.  Returns (md rows
        (F*15*ch, n2), finish_from_posts keyword arguments)."""
        ch, NB = self.dev.ch, PACKETBLOBS

        def bcast(x):
            return x.reshape(F, 1, ch, x.shape[-1]).expand(
                F, NB, ch, x.shape[-1]).reshape(F * NB * ch, x.shape[-1])

        kw = dict(lowpass=self.t["lowpass_15"][None, :, None].expand(
            F, NB, ch).reshape(F * NB * ch))
        if epeak is not None:
            kw.update(epeak=bcast(epeak), npeak=bcast(npeak))
        if self.dev.res_type == 2:
            # (15, n2) rows: frame f of the F*15 reads blob f % 15's
            kw.update(thr1=self.t["thr1_15"], threv=self.t["threv_15"],
                      inlimit=self.t["inlimit_15"])
        if wid is not None:
            kw["wid"] = torch.repeat_interleave(wid, NB * ch)
        return bcast(md), kw

    def _finish15(self, F, wb, logmdct, masks, md, epeak=None,
                  npeak=None, wid=None):
        """Three fits -> the 15-way ladder -> rows (F, blob, ch) ->
        finish_from_posts on F*15 frames.  Returns (packets (F, 15, wb)
        uint8, nbits (F, 15) int32)."""
        ps, us = floor3(self.ctx.floor, logmdct, masks)
        p15, u15 = self.ladder_rows(ps, us, F)
        mdr, kw = self.blob_rows(F, md, epeak, npeak, wid)
        pk, nb = self.dev.finish_from_posts(mdr, p15, u15,
                                            F * PACKETBLOBS, wb, **kw)
        return pk.reshape(F, PACKETBLOBS, -1), nb.reshape(F, PACKETBLOBS)

    def _flat(self, frames, F):
        if frames.dtype != torch.float32:
            frames = frames.to(torch.float32) / 32768.0
        return frames.reshape(F * self.dev.ch, self.dev.n)

    def make_framed_step(self, F, wb=None):
        """Stateless step: frames (F, ch, n) -> (packets (F, 15, wb)
        uint8, nbits (F, 15) int32)."""
        wb = wb or self.dev.plan.wb

        def step(frames):
            md, logmdct, masks3 = self.ctx.analysis.managed_masks(
                self._flat(frames, F))
            return self._finish15(F, wb, logmdct, masks3.unbind(-2), md)

        return step

    # -- stateful two-phase (cross-frame psy state) -------------------------
    def make_probe_step(self, F):
        """Phase A for the long-only managed path: frames (F, ch, n) ->
        spectra kept on the device + lam for the host recurrence.  The
        long-only managed path's live cross-frame states are the ampmax
        decay (tone mask) and the M9 lastmdct epeak; lastmdct is the
        previous frame's logmdct verbatim (lmode 0)."""
        da = self.ctx.analysis

        def step(frames):
            md, logmdct, fit1, dB, logfft = da.spectra(
                self._flat(frames, F), None, with_fft=True)
            lam = torch.clamp_max(logfft.amax(-1), 0.0)
            return md, logmdct, logfft, fit1, dB, lam

        return step

    def make_finish_step(self, F, wb=None):
        """Phase B: spectra + per-frame state (ampmax (F,), lastmdct
        rows (F*ch, n2)) -> 15 packed packet variants: the stateful
        noise tail (M7/M8/M9) and the ampmax-aware tone mask, then the
        three offset_select masks, as the unmanaged two-phase path."""
        from . import psydevice as PD
        da = self.ctx.analysis
        look = da.look
        wb = wb or self.dev.plan.wb
        ch = self.dev.ch

        def step(md, logmdct, logfft, fit1, dB, lastmdct, lam, ampmax):
            R = F * ch
            neg1 = torch.full((R,), -1.0, device=md.device)
            logmask, epeak, npeak = PD.noisemask_tail(
                look, logmdct, fit1, dB, neg1, neg1, lastmdct, "long",
                trans_active=torch.zeros(R, dtype=torch.bool,
                                         device=md.device))
            tone = da.tonemask(logfft, torch.repeat_interleave(ampmax, ch),
                               lam)
            # select order mirrors the reference (mapping0.c:1090-
            # 1181): mask1 first -- its M1 pass rescales the mdct used
            # by every blob
            md1, m1 = da.offset_and_mix(md, logmdct, logmask, tone, 1)
            _, m2 = da.offset_and_mix(md1, logmdct, logmask, tone, 2)
            _, m0 = da.offset_and_mix(md1, logmdct, logmask, tone, 0)
            return self._finish15(F, wb, logmdct, (m0, m1, m2), md1,
                                  epeak, npeak)

        return step

    def make_finish_step15(self, F, wb=None):
        """Stateful 15-blob finish for the SWITCHED managed pipeline.

        The per-frame state contract of DeviceFastEncode.make_finish_step
        (fstate packs ampmax / lowcomp / poste / trans / wid; m3vec the
        short-mode M3 fields), but every frame emits all 15 packetblob
        variants: the three offset_select val/tval curves each run the
        M-module machinery (M5 low_compand, M3 echo control on short
        blocks -- the reference runs _vp_offset_and_mix once per
        select, psy.c:4274-4502 via mapping0.c:1090-1181), select 1's
        M1 pass rescales the mdct every blob consumes, then the floor
        fit ladder and per-blob coupling thresholds / sliding lowpass
        finish as in make_finish_step."""
        from . import psydevice as PD
        ctx = self.ctx
        da = ctx.analysis
        look = da.look
        wb = wb or self.dev.plan.wb
        ch = self.dev.ch
        n2 = self.n2

        def step(md, logmdct, logfft, fit1, dB, lastmdct, lam, fstate,
                 m3vec=None):
            o = 0
            ampmax = fstate[o:o + F]
            o += F
            lowcomp = fstate[o:o + F * ch]
            o += F * ch
            poste = fstate[o:o + F * ch]
            o += F * ch
            trans = fstate[o:o + F] > 0.5
            o += F
            wid = fstate[o:o + F].to(torch.int32)
            m3 = None
            if m3vec is not None:
                m3 = dict(sw=m3vec[0] > 0.5, noise_rate=m3vec[1],
                          noise_center=m3vec[2], tone_rate=m3vec[3],
                          reset=m3vec[4] > 0.5,
                          impad_zero=m3vec[5] > 0.5)
            kind = "long" if self.W else "short"
            trans_r = torch.repeat_interleave(trans, ch)
            logmask, epeak, npeak = PD.noisemask_tail(
                look, logmdct, fit1, dB, lowcomp, poste, lastmdct, kind,
                trans_active=trans_r if self.W else None)
            tone = da.tonemask(logfft, torch.repeat_interleave(ampmax, ch),
                               lam)
            alt = trans_r[:, None]

            def val_tval(sel):
                noff = torch.where(alt, da.noiseoffsets_alt[sel],
                                   da.noiseoffsets[sel])
                val = torch.clamp_max(logmask + noff, da.noisemaxsupp)
                tval = tone + da.toneatts[sel]
                tval = PD.lowcompand_tval(look, tval, lowcomp, sel)
                if not self.W and m3 is not None:
                    shp = (F, ch, n2)
                    lm3 = logmdct[:, :n2].reshape(shp)
                    last3 = lastmdct.reshape(F, ch, -1)
                    temps = ctx.m3_scan(lm3, last3, val.reshape(shp),
                                        tval.reshape(shp), m3)
                    v2, t2, npk2 = PD.m3_apply(
                        look, val.reshape(shp), tval.reshape(shp), lm3,
                        last3, temps, npeak.reshape((F, ch, -1)), m3,
                        m3["impad_zero"])
                    return (v2.reshape(F * ch, n2),
                            t2.reshape(F * ch, n2),
                            npk2.reshape(F * ch, -1))
                return val, tval, npeak

            # select order mirrors the reference: 1 first (M1 rescale
            # feeds every blob), then 2, 0; masks are md-independent
            v1, t1, npk1 = val_tval(1)
            md1, m1 = da.mix_m4_m1(md, logmdct, v1, t1, 1)
            v2, t2, _ = val_tval(2)
            _, m2 = da.mix_m4_m1(md1, logmdct, v2, t2, 2)
            v0, t0, _ = val_tval(0)
            _, m0 = da.mix_m4_m1(md1, logmdct, v0, t0, 0)
            return self._finish15(F, wb, logmdct, (m0, m1, m2), md1,
                                  epeak, npk1,
                                  wid=wid if self.W else None)

        return step

    @staticmethod
    def gather(pk, choices):
        """(packets (F, 15, wb), choices (F,) on the device) -> (F, wb):
        only the chosen blob's bytes, gathered on the device."""
        return pk[torch.arange(pk.shape[0], device=pk.device),
                  choices.long()]


# ---------------------------------------------------------------------------
# host side: the per-stream reservoir walk and the chosen packets'
# compaction (the floater itself, ReservoirChooser, is below)

def reservoir_walk(chooser, sizes, Ws):
    """One stream's floater walk in frame order, mixing block sizes
    (vorbis_bitrate_addblock scales bitsper by each packet's W,
    lib/bitrate.c:92-99).  sizes: (F, 15) byte sizes, Ws: (F,) block
    flags.  Returns (choices (F,), (truncate, pad) (F, 2))."""
    F = len(sizes)
    cf = np.empty(F, np.int64)
    tf = np.empty((F, 2), np.int64)
    for f in range(F):
        c, t, p = chooser.choose(sizes[f], int(Ws[f]))
        cf[f] = c
        tf[f] = (t, p)
    return cf, tf


def compact_chosen(batches, chosen, tps):
    """The chosen packets as one dense byte buffer, with each packet's
    truncate and zero pad applied (bitrate.c:167-190).  batches: host
    (B, width) uint8 rows of the gathered packets, batch after batch in
    packet order (a batch redone at the worst-case budget is wider);
    chosen: (F,) byte sizes of the chosen blobs; tps: (F, 2) (truncate,
    pad).  Returns (blob, off (F,), final sizes (F,))."""
    F = len(chosen)
    keep = chosen - tps[:, 0]
    fin = keep + tps[:, 1]
    off = np.cumsum(fin) - fin
    blob = np.zeros(int(fin.sum()), np.uint8)
    g = 0
    for rows in batches:
        b = min(rows.shape[0], F - g)
        cols = np.arange(rows.shape[1])[None, :]
        valid = cols < keep[g:g + b, None]
        blob[(off[g:g + b, None] + cols)[valid]] = rows[:b][valid]
        g += b
    return blob, off, fin


# --------------------------------------------------------------------------
# the host floater: a verbatim copy of vorbis_tpu/ops/managed.py's
# ReservoirChooser (tests/test_torch_hostcopy.py compares the two classes'
# text)
# --------------------------------------------------------------------------

class ReservoirChooser:
    """vorbis_bitrate_addblock's floater/reservoir state machine
    (lib/bitrate.c:73-227), operating on per-blob byte sizes.  Exact
    port of the golden path's _bitrate_choose (codec/encoder.py),
    shared by the managed fast path."""

    def __init__(self, setup, rate, blocksizes):
        hi = setup.hi
        self.hi = hi
        self.rate = rate
        self.bs = blocksizes
        # vorbis_bitrate_init (bitrate.c:58-70): bitsper counts are per
        # SHORT half-block; choose() scales long blocks by
        # short_per_long
        half = (blocksizes[0] >> 1) / rate
        self.short_per_long = blocksizes[1] // blocksizes[0]
        self.avg_bitsper = int(np.rint(1.0 * hi.bitrate_av * half))
        self.min_bitsper = int(np.rint(1.0 * hi.bitrate_min * half))
        self.max_bitsper = int(np.rint(1.0 * hi.bitrate_max * half))
        self.avgfloat = float(PACKETBLOBS // 2)
        desired = hi.bitrate_reservoir * hi.bitrate_reservoir_bias
        self.minmax_reservoir = desired
        self.avg_reservoir = desired

    def choose(self, sizes, W):
        """sizes: (15,) byte sizes.  Returns (choice, out_bytes_fn)
        where out_bytes_fn(data) applies truncate/pad."""
        hi = self.hi
        choice = int(np.rint(self.avgfloat))
        this_bits = int(sizes[choice]) * 8
        min_tb = self.min_bitsper * (self.short_per_long if W else 1)
        max_tb = self.max_bitsper * (self.short_per_long if W else 1)
        samples = self.bs[W] >> 1
        desired = hi.bitrate_reservoir * hi.bitrate_reservoir_bias
        if self.avg_bitsper > 0:
            avg_tb = self.avg_bitsper * (self.short_per_long
                                         if W else 1)
            slewlimit = 15.0 / hi.bitrate_av_damp
            if self.avg_reservoir + (this_bits - avg_tb) > desired:
                while (choice > 0 and this_bits > avg_tb
                       and self.avg_reservoir + (this_bits - avg_tb)
                       > desired):
                    choice -= 1
                    this_bits = int(sizes[choice]) * 8
            elif self.avg_reservoir + (this_bits - avg_tb) < desired:
                while (choice + 1 < PACKETBLOBS and this_bits < avg_tb
                       and self.avg_reservoir + (this_bits - avg_tb)
                       < desired):
                    choice += 1
                    this_bits = int(sizes[choice]) * 8
            slew = np.rint(choice - self.avgfloat) / samples * self.rate
            slew = min(max(slew, -slewlimit), slewlimit)
            self.avgfloat += slew / self.rate * samples
            choice = int(np.rint(self.avgfloat))
            this_bits = int(sizes[choice]) * 8
        if self.min_bitsper > 0 and this_bits < min_tb:
            while self.minmax_reservoir - (min_tb - this_bits) < 0:
                choice += 1
                if choice >= PACKETBLOBS:
                    break
                this_bits = int(sizes[choice]) * 8
        if self.max_bitsper > 0 and this_bits > max_tb:
            while self.minmax_reservoir + (this_bits - max_tb) \
                    > hi.bitrate_reservoir:
                choice -= 1
                if choice < 0:
                    break
                this_bits = int(sizes[choice]) * 8
        truncate = pad = 0
        if choice < 0:
            maxsize = (max_tb + (hi.bitrate_reservoir
                                 - self.minmax_reservoir)) // 8
            choice = 0
            if int(sizes[0]) > maxsize:
                truncate = int(sizes[0]) - int(maxsize)
            this_bits = (int(sizes[0]) - truncate) * 8
        else:
            minsize = (min_tb - self.minmax_reservoir + 7) // 8
            if choice >= PACKETBLOBS:
                choice = PACKETBLOBS - 1
            pad = max(0, int(minsize) - int(sizes[choice]))
            this_bits = (int(sizes[choice]) + pad) * 8
        # reservoir updates (bitrate.c:192-225)
        if self.min_bitsper > 0 or self.max_bitsper > 0:
            if max_tb > 0 and this_bits > max_tb:
                self.minmax_reservoir += this_bits - max_tb
            elif min_tb > 0 and this_bits < min_tb:
                self.minmax_reservoir += this_bits - min_tb
            else:
                if self.minmax_reservoir > desired:
                    if max_tb > 0:
                        self.minmax_reservoir += this_bits - max_tb
                        if self.minmax_reservoir < desired:
                            self.minmax_reservoir = desired
                    else:
                        self.minmax_reservoir = desired
                else:
                    if min_tb > 0:
                        self.minmax_reservoir += this_bits - min_tb
                        if self.minmax_reservoir > desired:
                            self.minmax_reservoir = desired
                    else:
                        self.minmax_reservoir = desired
        if self.avg_bitsper > 0:
            avg_tb = self.avg_bitsper * (self.short_per_long
                                         if W else 1)
            self.avg_reservoir += this_bits - avg_tb
        return choice, truncate, pad
