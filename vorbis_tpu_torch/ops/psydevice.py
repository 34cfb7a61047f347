"""Torch counterpart of vorbis_tpu/ops/psydevice.py: the cross-frame
psychoacoustic state of the batched fast encoder.

The reference encoder threads per-channel state from frame to frame
(reference file:line):

  * ampmax        — global amplitude cap with -att/sec decay feeding
                    the tone-curve level choice (psy.c:4504,
                    _vp_tonemask psy.c:4076)
  * lastmdct      — previous frame's log spectrum, resampled on block
                    size changes (psy.c:4462-4501), read by M9 postecho
                    peaks (psy.c:4060-4072) and M3 (psy.c:4345-4400)
  * noise compand — M5's loud-noise latch (lb_loudnoise_fix,
    level         psy.c:5152-5180)
  * lW_no/impadnum/lW_block_mode — block-sequence counters driving
                    set_m3p (mapping0.c:1297-1305)

The pipeline keeps the per-frame stages batched and isolates the serial
couplings:

  1. a batched device PROBE pass computes each frame's spectra plus
     the tiny per-frame reductions the recurrences need (local
     amplitude max, M5's band average, M2's PCM sums) and the frame's
     lastmdct CONTRIBUTION row (frame f reads a pure resampling of
     frame f-1's log spectrum, so it batches as a row gather);
  2. the HOST runs the exact scalar recurrences over the stream-order
     frame sequence (a few floats per frame): the numpy half of this
     module, a line-aligned copy of the JAX module's (lines 51-252);
  3. a batched device FINISH pass consumes the per-frame state values
     and completes masking -> floor -> VQ -> packets: the torch half
     (noisemask_tail, M2/M7/M8/M9, lowcompand_tval) in the JAX float32
     op order, up to the reduction order of a few sums
     (tests/test_torch_psystate.py counts the decisions that flip).

M3 (m3_tempmdct_scan, m3_apply) acts on the impulse short blocks that
block switching schedules: the scan's plain version is here, and the
short finish step runs it through ops/m3_cuda.make_m3_scan (the CUDA
kernel csrc/m3_scan.cu on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from . import psy as PSY

f32 = np.float32


# ---------------------------------------------------------------------------
# host-side frame annotations + scalar recurrences
# ---------------------------------------------------------------------------

def annotate_frames_nd(Ws, impulse):
    """Batched annotate_frames: Ws/impulse (S, F) -> dict of (S, F)
    arrays.  The per-step state updates are elementwise, so lanes
    (streams) evolve independently and identically to the scalar
    recurrence (block.c:620-638 + mapping0.c:1297-1305)."""
    Ws = np.asarray(Ws, np.int64)
    S, F = Ws.shape
    one = np.ones((S, 1), np.int64)
    lW = np.concatenate([one, Ws[:, :-1]], 1)
    nW = np.concatenate([Ws[:, 1:], Ws[:, -1:]], 1)
    bm = np.where(Ws == 1, np.where((lW == 1) & (nW == 1), 3, 2),
                  np.where(impulse, 0, 1))
    lW_bm = np.concatenate([np.zeros((S, 1), np.int64), bm[:, :-1]], 1)
    # closed-form recurrences (the scalar loop is, per frame:
    #   lW_no[f] = no; impad[f] = ip;
    #   if m >= 2: ip = 0
    #   if prev != 0 and m == 1: ip = 1
    #   elif ip and ip < 8: ip += 1
    #   no = no + 1 if prev == m else 1; prev = m
    # — the reference runs them once per blob at the tail of the blob
    # loop; unmanaged = once per frame):
    ar = np.arange(F, dtype=np.int64)[None, :]
    # no after frame f = length of the equal-bm run ending at f
    # (initial no=0 means even a virtual-prev match restarts at 1)
    chg = np.concatenate([np.ones((S, 1), bool),
                          bm[:, 1:] != bm[:, :-1]], 1)
    run_start = np.maximum.accumulate(np.where(chg, ar, 0), 1)
    no_after = ar - run_start + 1
    lW_no = np.concatenate([np.zeros((S, 1), np.int64),
                            no_after[:, :-1]], 1)
    # ip after frame f: 0 unless a trigger (m==1 following a nonzero
    # bm) happened after the last m>=2 frame; then frames-since-
    # trigger + 1, saturating at 8
    trig = (bm == 1) & (lW_bm != 0)
    kill = bm >= 2
    t_last = np.maximum.accumulate(np.where(trig, ar, -1), 1)
    k_last = np.maximum.accumulate(np.where(kill, ar, -1), 1)
    ip_after = np.where(t_last > k_last,
                        np.minimum(8, ar - t_last + 1), 0)
    impad = np.concatenate([np.zeros((S, 1), np.int64),
                            ip_after[:, :-1]], 1)
    return dict(bm=bm, lW_bm=lW_bm, lW_no=lW_no, impadnum=impad,
                nW=nW, lW=lW)


def annotate_frames(Ws, impulse):
    """Per-frame block-sequence annotations in stream order.

    Ws: (F,) 0/1 window flags; impulse: (F,) bool (short blocks whose
    span contains an envelope mark).  Returns dict of int arrays:
    block_mode (== blocktype: 0 impulse, 1 padding, 2 transition,
    3 long), lW_bm, lW_no, impadnum, nW, lW."""
    nd = annotate_frames_nd(np.asarray(Ws, np.int64)[None, :],
                            np.asarray(impulse, bool)[None, :])
    return {k: v[0] for k, v in nd.items()}


def ampmax_seq_nd(lam, Ws, blocksizes, rate, att_per_sec):
    """Batched _vp_ampmax_decay: lam/Ws (S, F) -> (S, F).  Per-step
    float32 math is elementwise, so each lane reproduces the scalar
    recurrence exactly (psy.c:4504)."""
    lam = np.asarray(lam, np.float32)
    Ws = np.asarray(Ws, np.int64)
    S, F = lam.shape
    out = np.empty((S, F), np.float32)
    amp = np.full(S, f32(-9999.0), np.float32)
    att = f32(att_per_sec)
    secs = np.array([f32(np.float32(blocksizes[w] // 2)
                         / np.float32(rate)) for w in (0, 1)], np.float32)
    dec = np.array([f32(secs[0] * att), f32(secs[1] * att)], np.float32)
    floor = np.float32(-9999.0)
    for fi in range(F):
        amp = amp + dec[Ws[:, fi]]
        np.maximum(amp, floor, out=amp)
        np.maximum(amp, lam[:, fi], out=amp)
        out[:, fi] = amp
    return out


def ampmax_seq(lam, Ws, blocksizes, rate, att_per_sec):
    """Exact _vp_ampmax_decay recurrence over one stream's frames.
    lam: (F,) per-frame local amplitude max (over channels);
    returns (F,) the global ampmax each frame's tonemask sees."""
    return ampmax_seq_nd(np.asarray(lam, np.float32)[None, :],
                         np.asarray(Ws, np.int64)[None, :],
                         blocksizes, rate, att_per_sec)[0]


def lowcomp_seq_nd(hi_th, bm, lW_bm, looks_mnt):
    """Batched M5 latch: hi_th/bm/lW_bm (R, F) -> (R, F) (rows are
    (stream, channel) pairs; channels of one stream share bm)."""
    hi_th = np.asarray(hi_th, np.float32)
    R, F = hi_th.shape
    mv4 = np.array([looks_mnt[i][0] for i in range(4)], np.float64)
    nt4 = np.array([looks_mnt[i][1] for i in range(4)], np.float64)
    reset = (mv4[bm] < 0.5) | (nt4[bm] > 0.45)       # (R, F)
    trans = ((bm == 2) & (lW_bm == 3)) | ((bm == 3) & (lW_bm == 2))
    h = hi_th
    lat = np.where(h > -40.0, -1.0,
                   np.where(h < -50.0, 1.0, 1.0 - ((h + 50) / 10)))
    out = np.empty((R, F), np.float32)
    lc = np.zeros(R, np.float64)
    for fi in range(F):
        lc = np.where(reset[:, fi], -1.0,
                      np.where(trans[:, fi], lat[:, fi], lc))
        out[:, fi] = lc
    return out


def lowcomp_seq(hi_th, ann, looks_mnt):
    """Exact M5 latch (lb_loudnoise_fix) over one stream's frames for
    one channel.  hi_th: (F,) the probe's clamped band average
    sum(max(logmdct[n25p:n75p], -130))/n; looks_mnt: per block_mode
    (4,) tuples (m_val, normal_thresh) from the frame's psy params."""
    return lowcomp_seq_nd(np.asarray(hi_th, np.float32)[None, :],
                          np.asarray(ann["bm"])[None, :],
                          np.asarray(ann["lW_bm"])[None, :],
                          looks_mnt)[0]


def poste_seq(upt, unt, ann, n):
    """M2 post-echo pre-detection from the probe's |pcm| segment sums
    (postnoise_detection, exact formula; gating mode==2 && lW
    impulse)."""
    sn = n >> 2
    gate = (ann["bm"] == 2) & (ann["lW_bm"] == 0) & (n >= 2048)
    u = upt.astype(np.float64)
    v = unt.astype(np.float64)
    quiet = v / sn > 0.01
    u2 = u * u
    v2 = v * v * 15
    ret = np.where(u2 > v2, u2 - v2, -1.0)
    ret = np.where(ret < 0.1, -1.0, ret)
    return np.where(gate & ~quiet, ret, -1.0).astype(np.float32)


def m3_param_seq(ann, n2s, toneatt, hsrate, managed=False):
    """Per-frame M3 (set_m3p) parameters for the SHORT-block frames,
    in stream order.  Pure elementwise math: ann arrays of any shape
    ((F,) or batched (S, F)) give same-shaped outputs (only meaningful
    where sw=1, i.e. impulse blocks at hsrate)."""
    bm = np.asarray(ann["bm"])
    lW_bm = np.asarray(ann["lW_bm"])
    lW_no = np.asarray(ann["lW_no"], np.int64)
    impad = np.asarray(ann["impadnum"], np.int64)
    shape = bm.shape
    base = f32(5.0) if n2s == 128 else f32(10.0)
    zf = np.zeros(shape, np.float32)
    if not hsrate or n2s not in (128, 256):
        return dict(sw=np.zeros(shape, bool), noise_rate=zf,
                    noise_center=zf.copy(), tone_rate=zf.copy(),
                    reset=np.zeros(shape, bool), base=base)
    sw = bm == 0
    no = lW_no
    prev_imp = lW_bm == 0
    if n2s == 128:
        count = 2 if toneatt < 3 else 3
        ramp = (np.float64(0.7)
                - (((no - 1).astype(np.float32) / np.float32(17))
                   .astype(np.float64))).astype(np.float32)
        nr = np.where(prev_imp,
                      np.where(no < 8, ramp, np.float32(0.3)),
                      np.float32(0.7))
        nc = np.where(prev_imp,
                      np.where((no < 8) | (no * count < 24),
                               (no * count).astype(np.float32),
                               np.float32(25)),
                      np.float32(0))
        tr = np.where(prev_imp,
                      np.where(no < 8, (8 - no).astype(np.float32),
                               np.float32(0)),
                      np.float32(8.0))
        nr = np.where(impad != 0,
                      (nr.astype(np.float64)
                       * (impad * 0.125)).astype(np.float32), nr)
    else:
        ramp = (np.float64(0.4)
                - (((no - 1).astype(np.float32) / np.float32(11))
                   .astype(np.float64))).astype(np.float32)
        nr = np.where(prev_imp,
                      np.where(no < 4, ramp, np.float32(0.2)),
                      np.float32(0.6))
        nc = np.where(prev_imp,
                      np.where(no < 4, (no * 6 + 12).astype(np.float32),
                               np.float32(30)),
                      np.float32(12))
        tr = np.where(prev_imp,
                      np.where(no < 4, (8 - no * 2).astype(np.float32),
                               np.float32(0)),
                      np.float32(8.0))
    reset = sw & ~prev_imp
    if managed:
        nr = (nr.astype(np.float64) * 0.2).astype(np.float32)
    nr = np.where(sw, nr, 0).astype(np.float32)
    nc = np.where(sw, nc, 0).astype(np.float32)
    tr = np.where(sw, tr, 0).astype(np.float32)
    return dict(sw=sw, noise_rate=nr, noise_center=nc, tone_rate=tr,
                reset=reset, base=base)


# ---------------------------------------------------------------------------
# device pieces
# ---------------------------------------------------------------------------

def _const(look, name, arr, device):
    """A static table of `look` on `device`, uploaded once and kept on
    the look (the finish step runs once a batch; a fresh host copy per
    call would be one more synchronous transfer each time)."""
    tabs = look.__dict__.setdefault("_device_tables", {})
    key = (name, str(device))
    if key not in tabs:
        tabs[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return tabs[key]


def _part(look):
    return look.vi["normal_partition"] if look.vi["normal_p"] else 16


def noisemask_tail(look, logmdct, fit1, dB, lowcomp, poste, lastmdct,
                   kind, trans_active=None):
    """The stateful tail of _vp_noisemask after the two bark fits:
    M7 ntfix, companding with the M5 level, M2 post-echo, M8 npeak
    store, M9 epeak.  fit1: the first bark fit (the C's `work` after
    `logmdct - work`); dB: clipped int compand index from the second
    fit; lowcomp/poste: (...,) per row; lastmdct: (..., >=n).
    kind: 'short' (block_mode<=1), 'long' (W=1 batch; trans_active
    rows get the block_mode==2 ntfix and all rows get M9).
    Returns (logmask, epeak, npeak)."""
    t = PSY._tables()
    n = look.n
    part = _part(look)
    nparts = max((n + part - 1) // part, 1)
    dev = logmdct.device
    work = fit1
    if kind == "short":
        work = ntfix_short(look, logmdct, work)
    elif trans_active is not None:
        work = ntfix_trans(look, logmdct, work, trans_active)
    nc = _const(look, "noisecompand", np.asarray(
        look.vi["noisecompand"], np.float32), dev)
    nch = _const(look, "noisecompand_high", np.asarray(
        look.vi["noisecompand_high"], np.float32), dev)
    stn = _const(look, "stn_compand",
                 t["stn_compand"].astype(np.float32), dev)
    dBl = dB.long()
    ncd = nc[dBl]
    nchd = nch[dBl]
    stnd = stn[dBl]
    epeak = work + stnd
    plain = work + ncd
    blend = plain - (ncd - nchd) * lowcomp[..., None]
    low = _const(look, "n33p", np.arange(work.shape[-1]) < look.n33p,
                 dev) & (lowcomp > 0)[..., None]
    logmask = torch.where(low, blend, plain)
    npeak = torch.zeros(work.shape[:-1] + (nparts,), dtype=torch.float32,
                        device=dev)
    logmask, npeak = m2_apply(look, logmask, npeak, poste)
    npeak = m8_npeak(look, logmdct, logmask, npeak)
    if kind == "short":
        epeak = torch.zeros_like(epeak)
    else:
        act = torch.ones(work.shape[:-1], dtype=torch.bool, device=dev)
        epeak = m9_epeak(look, logmdct, epeak, lastmdct, act)
    return logmask, epeak, npeak


def ntfix_short(look, logmdct, work):
    """aoTuV M7, block_mode<=1 branch (psy.c ntfix), batched exact:
    the plateau walks extend at most 2 left / 3 right, so every branch
    is a bounded elementwise select; overlapping temp writes are
    max-accumulated (order-free like the C)."""
    n = look.n
    nx = look.tonefix_end
    if not nx:
        return work
    dev = work.device
    inf = float("inf")
    limit = f32(abs(look.noiseoffset[1][0]))
    freq_unc = 4
    nxplus = nx + freq_unc
    tolerance = float(f32(15.0) if n == 256 else f32(9.0))
    strength = float(f32(0.6))
    if nxplus > n:
        nx = n
    sp = logmdct
    inmod = torch.where(sp < -70, -70.0 + (sp + 70.0) * float(f32(0.1)),
                        sp)
    # local maxima in [freq_unc, nx)
    spm = torch.nn.functional.pad(sp, (1, 1), value=inf)
    ispeak = (sp > spm[..., :-2]) & (sp > spm[..., 2:])
    bins = np.arange(work.shape[-1])
    ispeak = ispeak & _const(look, f"ns_peak{nx}",
                             (bins >= freq_unc) & (bins < nx), dev)

    def sh(a, k):
        """a shifted so out[i] = a[i+k] (edges -> -inf sentinel)."""
        return _shift(a, k, -inf)

    # ps = i-2 if sp[i-1] >= sp[i-2] else i-1 (never reaches upper)
    ps_is2 = sh(sp, -1) >= sh(sp, -2)
    in_ps = torch.where(ps_is2, sh(inmod, -2), sh(inmod, -1))
    # pe walk: extends right while non-increasing, up to i+3
    pe2 = sh(sp, 1) >= sh(sp, 2)
    pe3 = pe2 & (sh(sp, 2) >= sh(sp, 3))
    pe_off = torch.where(pe3, 3, torch.where(pe2, 2, 1))
    in_pe = torch.where(pe3, sh(inmod, 3),
                        torch.where(pe2, sh(inmod, 2), sh(inmod, 1)))
    ss = torch.maximum(inmod - in_ps, inmod - in_pe)
    ssc = torch.where(sp > work, (ss - tolerance) * strength, ss)
    ss = torch.where(ss > tolerance, ssc, -inf)
    ss = torch.where(ispeak, ss, -inf)
    # temp[ps..pe] = max(ss, 0): for each target offset d in [-2, 3],
    # take the max over source peaks i = k - d that cover k
    temp = torch.full_like(work, -inf)
    for d in range(-2, 4):
        src = sh(ss, -d)
        if d < 0:
            cov = torch.where(ps_is2, -2, -1) <= d
            cov = sh(cov.to(torch.float32), -d) > 0.5
            temp = torch.maximum(temp, torch.where(cov, src, -inf))
        elif d == 0:
            temp = torch.maximum(temp, src)
        else:
            cov = sh((pe_off >= d).to(torch.float32), -d) > 0.5
            temp = torch.maximum(temp, torch.where(cov, src, -inf))
    temp = torch.clamp_min(temp, 0.0)
    temp = torch.where(torch.isfinite(temp), temp, 0.0)
    k = np.arange(work.shape[-1])
    test = np.minimum(look.ntfix_noiseoffset[:work.shape[-1]],
                      look.noiseoffset[1][:work.shape[-1]] + limit)
    appl = _const(look, f"ns_appl{nx}", (k >= freq_unc - 1) & (k < nx),
                  dev)
    tt = torch.minimum(temp, _const(look, "ns_test",
                                    test.astype(np.float32), dev))
    return work - torch.where(appl, tt, 0.0)


def _shift(a, o, fill=0):
    """out[..., c] = a[..., c + o], `fill` at the edges."""
    if o >= 0:
        return torch.nn.functional.pad(a[..., o:], (0, o), value=fill)
    return torch.nn.functional.pad(a[..., :o], (-o, 0), value=fill)


def ntfix_trans(look, logmdct, work, active):
    """aoTuV M7, block_mode==2 branch, batched exact: 8-bin averages,
    peak triples, bounded subtraction spans (order-free accumulation).
    active: (...,) bool per frame row."""
    n = look.n
    nx = look.tonefix_end
    if not nx:
        return work
    dev = work.device
    limit = f32(abs(look.noiseoffset[1][0]))
    navg = (nx + 7) // 8
    nx8 = nx // 8
    ncell = n // 8
    lead = work.shape[:-1]
    w8 = work[..., :navg * 8].reshape(lead + (navg, 8))
    temp = torch.nn.functional.pad(w8.sum(-1) * float(f32(1.0 / 8.0)),
                                   (0, ncell + 1 - navg))
    tm1 = _shift(temp, -1)
    tm2 = _shift(temp, -2)
    tp1 = _shift(temp, 1)
    cells = np.arange(ncell + 1)
    isp = (temp > tm1) & (temp > tp1) \
        & _const(look, "nt_cells", (cells >= 3) & (cells < nx8), dev)
    a_is3 = tm1 > tm2          # a = i-3 and thres vs temp[i-2]
    thres = temp - torch.where(a_is3, tm2, tm1)
    eightimes = np.minimum(np.arange(ncell + 1) * 8, n - 1)
    est = np.minimum(look.ntfix_noiseoffset[eightimes],
                     look.noiseoffset[1][eightimes] + limit)
    sub = torch.minimum(thres - 2.0, _const(
        look, "nt_est", est.astype(np.float32), dev))
    sub = torch.where(isp & (thres > 2.0) & active[..., None], sub, 0.0)
    # peak at cell i subtracts sub_i over bins [a*8, (i+3)*8]; at cell
    # granularity that is cells a..i+2 plus the first bin of cell i+3.
    # cell c is covered by peak i when o = i-c is in [-2, 3], o == 3
    # only if that peak's a == i-3.
    cell_sub = torch.zeros(lead + (ncell + 1,), dtype=torch.float32,
                           device=dev)
    for o in range(-2, 4):
        contrib = _shift(sub, o)
        if o == 3:
            contrib = torch.where(_shift(a_is3, o), contrib, 0.0)
        cell_sub = cell_sub + contrib
    width = work.shape[-1]
    per_bin = torch.repeat_interleave(cell_sub[..., :ncell], 8,
                                      dim=-1)[..., :width]
    # first bin of cell c additionally gets sub from the peak at c-3
    tail = torch.repeat_interleave(_shift(sub, -3)[..., :ncell], 8,
                                   dim=-1)[..., :width]
    tail_first = _const(look, "nt_first", (np.arange(width) % 8) == 0,
                        dev)
    per_bin = per_bin + torch.where(tail_first, tail, 0.0)
    return work - per_bin


def m8_npeak(look, logmdct, logmask, npeak):
    """M8's per-partition floor store (psy.c:4034-4053), batched.
    npeak: (..., nparts) carried from M2."""
    part = _part(look)
    n = look.n
    # the C loops `while i < min_nn_lp` stepping by partition: a
    # partial final partition still processes in full
    kmax = min(-(-look.min_nn_lp // part), n // part)
    if kmax <= 0:
        return npeak
    dev = logmdct.device
    nt = float(f32(4.0))
    lm = logmdct[..., :kmax * part].reshape(
        logmdct.shape[:-1] + (kmax, part))
    mk = logmask[..., :kmax * part].reshape(
        logmask.shape[:-1] + (kmax, part))
    o = look.noiseoffset[1][np.arange(kmax) * part + part - 1] + 6
    me = torch.clamp_min((lm - mk).amax(-1), 0.0)
    avge = lm.sum(-1)
    val = torch.minimum(_const(look, "m8_o", o.astype(np.float32), dev),
                        nt - me) / nt
    ok = _const(look, "m8_opos", o > 0, dev) \
        & (npeak[..., :kmax] >= -0.5) \
        & (avge >= float(f32(-95.0 * part))) & (me < nt)
    return torch.cat([torch.where(ok, val, npeak[..., :kmax]),
                      npeak[..., kmax:]], -1)


def m2_apply(look, logmask, npeak, poste):
    """M2 post-echo reduction (psy.c _postnoise part of _vp_noisemask):
    lower the noise mask on the low partitions after a detected
    post-echo; poste: (...,) per frame row (-1 = inactive)."""
    part = _part(look)
    kmax = min(-(-look.min_nn_lp // part), look.n // part)
    if kmax <= 0:
        return logmask, npeak
    dev = logmask.device
    o = look.noiseoffset[1][np.arange(kmax) * part]
    pmin = torch.minimum(torch.clamp_max(poste[..., None], 30.0),
                         _const(look, "m2_o30", o.astype(np.float32)
                                + f32(30.0), dev))
    act = (poste[..., None] > 0) & (pmin > 0)       # (..., kmax)
    npeak = torch.cat([torch.where(act, -1.0, npeak[..., :kmax]),
                       npeak[..., kmax:]], -1)
    sub = torch.where(act, pmin, 0.0)
    per_bin = torch.repeat_interleave(sub, part, dim=-1)
    width = per_bin.shape[-1]
    logmask = torch.cat([logmask[..., :width] - per_bin,
                         logmask[..., width:]], -1)
    return logmask, npeak


def m9_epeak(look, logmdct, epeak_base, lastmdct, active):
    """M9 peak-impulse store for coupling (psy.c:4060-4072): on
    long/transition frames the post-echo epeak becomes the frame-to-
    frame spectral rise where it exceeds the stored envelope."""
    end = look.tonecomp_endp
    n = look.n
    if end <= 0:
        return torch.zeros_like(epeak_base)
    temp = logmdct - epeak_base
    mi = logmdct - lastmdct[..., :n]
    ep = torch.where((temp >= 12.0) & (mi >= 1), mi, 0.0)
    inend = _const(look, "m9_end", np.arange(n) < end, logmdct.device)
    return torch.where(inend & active[..., None], ep, 0.0)


def m3_tables(look):
    """Static M3 spread tables of a short look: (bfn (n,) int, cell
    (n,) f32, incr (n,) f32, base f32) as set_m3p builds them."""
    n = look.n
    t = PSY._tables()
    bfn = np.asarray(t["freq_bfn128"] if n == 128 else t["freq_bfn256"],
                     np.int64)
    cell = (f32(75.0) / bfn.astype(np.float32)).astype(np.float32)
    base = f32(5.0) if n == 128 else f32(10.0)   # set_m3p constants
    incr_tab = (base / bfn.astype(np.float32)).astype(np.float32)
    return bfn, cell, incr_tab, base


def m3_tempmdct_scan(look, logmdct, lastmdct, val, tval, params):
    """Sequential M3 echo buffer over a batch of short frames in
    stream order (set_m3p's tempmdct maintenance + the main loop's
    write-back).  logmdct/val/tval: (F, ch, n), lastmdct (F, ch, >=n);
    params: sw, reset (F,) bool and noise_center (F,) f32 tensors.
    Returns tempmdct (F, ch, n) as each frame's main loop sees it.

    The plain version of the scan: a Python loop over the frames, the
    spread's 24 (n = 128) or 50 (n = 256) shifted compares per frame in
    the JAX module's order, the carry starting at zero on every call
    (ops/m3_cuda.py holds the CUDA kernel to it).

    Deviation from the C: the spread update's conditions are evaluated
    against the pre-update buffer (the C applies them bin-serially);
    increments are fractions of a dB."""
    n = look.n
    bfn, cell, incr_tab, base = m3_tables(look)
    maxnb = int(bfn.max())
    dev = logmdct.device
    F, ch, _ = logmdct.shape
    js = np.arange(1, maxnb)
    # per shift j: cell[i]*j rounded once (the JAX product) and j < bfn[i]
    cellj = _const(look, "m3_cellj",
                   (cell[None, :] * js[:, None].astype(np.float32))
                   .astype(np.float32), dev)
    jlt = _const(look, "m3_jlt", js[:, None] < bfn[None, :], dev)
    incr_j = _const(look, "m3_incr", incr_tab, dev)
    base = float(base)

    def spread(temp, lm):
        # for j in 1..maxnb-1: temp[i+j] += base/bfn[i+j]
        #   if temp[i+j] < lm[i] - cell[i]*j  (and j < bfn[i]),
        # the conditions on the pre-update buffer; the increments land
        # on the buffer one by one in j order, as XLA:CPU compiles the
        # JAX module's `temp + add` (its adds fold onto temp)
        out = temp.clone()
        for j in range(1, maxnb):
            freq = lm[..., :-j] - cellj[j - 1, :-j]
            cond = (temp[..., j:] < freq) & jlt[j - 1, :-j]
            out[..., j:] += torch.where(cond, incr_j[j:], 0.0)
        return out

    sw = params["sw"].to(dev)
    reset = params["reset"].to(dev)
    ncen = params["noise_center"].to(dev)
    carry = torch.zeros((ch, n), dtype=torch.float32, device=dev)
    outs = []
    for f in range(F):
        lm, last = logmdct[f], lastmdct[f, :, :n]
        tm = torch.where(reset[f], last - base, carry - base)
        tm = spread(tm, lm)
        trig = sw[f] & (val[f] > tval[f]) & (val[f] > last) \
            & (lm > tm + ncen[f])
        tm = torch.where(trig, lm, tm)
        carry = torch.where(sw[f], tm, carry)
        outs.append(carry)
    return torch.stack(outs) if outs else torch.zeros_like(logmdct)


def m3_apply(look, val, tval, logmdct, lastmdct, tempmdct, npeak,
             params, impad_zero):
    """The M3 main loop (psy.c:4345-4400) applied elementwise over a
    batch of short frames.  Returns (val', tval', npeak').
    impad_zero: (F,) bool — impadnum==0 (the tone-accent branch only
    runs then)."""
    n = look.n
    m3n = look.m3n
    part = _part(look)
    dev = val.device
    sw = params["sw"][:, None, None]
    nrate = params["noise_rate"][:, None, None]
    ncen = params["noise_center"][:, None, None]
    trate = params["tone_rate"][:, None, None]
    iz = impad_zero[:, None, None]

    last = lastmdct[..., :n]
    m3cond = sw & (val > tval) & (val > last) \
        & (logmdct > tempmdct + ncen)
    # rate_mod by region (noise_rate_low is always 0 in set_m3p)
    rate_mod = torch.where(logmdct > last, nrate, 0.0)
    # tone accent (only when impadnum==0, low bins, sharp rise)
    dBsub = logmdct - last
    toneac = m3cond & iz & _const(look, "m3_tonecomp",
                                  np.arange(n) < look.tonecomp_endp, dev) \
        & (val - last > 20.0) & (dBsub > 25.0)
    tr_cur = torch.where(dBsub < 35.0,
                         trate * ((35.0 - dBsub) * float(f32(0.1))), trate)
    tv_ac = torch.clamp_min(tval - tr_cur, -100.0)
    tv_ac = torch.where(logmdct - tv_ac > 48.0, logmdct - 48.0, tv_ac)
    apply_ac = toneac & (tval > -100.0) & (logmdct - tval < 48.0)
    tval2 = torch.where(apply_ac, tv_ac, tval)
    # regional main threshold
    b = np.arange(n)
    mainth = _const(look, "m3_mainth", np.where(
        b > int(m3n[0]), f32(30.0),
        np.where(b > int(m3n[1]), f32(20.0), f32(10.0))), dev)
    rmod = torch.where(
        _const(look, "m3_hi", b > int(m3n[1]), dev), rate_mod,
        torch.where(_const(look, "m3_mid", b > int(m3n[2]), dev),
                    rate_mod * 0.5, rate_mod * float(f32(0.3))))
    diff = val - tval2
    valmask = torch.where(diff > mainth,
                          ((diff - mainth) * float(f32(0.1)) + mainth) * rmod,
                          diff * rmod)
    vnew = torch.maximum(val - valmask, last)
    # tone-accent post pull-down
    temp2 = vnew - torch.clamp_min(last, -140.0)
    vnew = torch.where(toneac & (temp2 > 20.0),
                       vnew - (temp2 - 20.0) * float(f32(0.2)), vnew)
    val_out = torch.where(m3cond, vnew, val)
    tval_out = torch.where(m3cond, tval2, tval)
    # npeak: -1 where any toneac bin in the partition; else 0 where
    # any m3 bin hit and npeak>0
    nparts = npeak.shape[-1]
    kmax = min(nparts, n // part)
    ta = toneac            # npeak -1 follows toneac alone (psy.c)
    ta_p = ta[..., :kmax * part].reshape(
        ta.shape[:-1] + (kmax, part)).any(-1)
    hit_p = m3cond[..., :kmax * part].reshape(
        m3cond.shape[:-1] + (kmax, part)).any(-1)
    cur = npeak[..., :kmax]
    cur = torch.where(hit_p & (cur > 0), 0.0, cur)
    cur = torch.where(ta_p, -1.0, cur)
    npeak = torch.cat([cur, npeak[..., kmax:]], -1)
    return val_out, tval_out, npeak


def lowcompand_tval(look, tval, lowcomp, select):
    """The low_compand tval reduction at the head of offset_and_mix
    (psy.c:4331-4338): active when the M5 latch is positive and the
    select's tone_masteratt >= 25."""
    toneatt = float(look.vi["tone_masteratt"][select])
    if toneatt < 25.0:
        return tval
    m4_start = int(look.vi["normal_start"])
    lim = min(m4_start + 1, tval.shape[-1])
    if lim <= 0:
        return tval
    lc = torch.clamp_min(lowcomp, 0.0) * float(f32(toneatt - 25.0))
    inlim = _const(look, f"lc_lim{lim}", np.arange(tval.shape[-1]) < lim,
                   tval.device)
    return tval - torch.where(inlim, lc[..., None], 0.0)
