"""Coupling rows for the stereo coupling kernel's checks
(ops/couple_cuda.py, csrc/couple_quantize.cu), shared by
tests/test_torch_couple.py, tests/test_torch_cuda.py::
test_couple_quantize_equals_plain_on_cuda and chip_smoke.py phase 3o.  No
JAX: the card test and the chip phase import it.

A case is a dict: F and the numpy keyword arguments of `couple_quantize`
(md and curve (2F, n2) float32, used (2F,) bool; optionally epeak (2F,
n2), npeak (2F, ncols), lowpass (2F,) int32 and the thr1, threv and
inlimit rows).  `config(dev)` reads a stereo DeviceFastEncode's coupling
tables; `replay(cfg, case)` is the kernel's schedule in numpy (a warp
four partitions of a frame, BPT bins a thread, the partition sums as the
kernel's chains, folds and shuffles, counts as ballots, M6 only below
tonefix_end with the carry's recount, the normalize's rank by
counting).
"""

import numpy as np
import torch

f32 = np.float32
SUM_LANES_SITES = ("m6", "normalize", "normalize_m6")


def lanes_sum(v, lanes):
    """numpy partition sum of a 1-D partition in xla_f32.partition_sum's
    order (lanes accumulators, folds in halves; 1: left to right)."""
    v = np.asarray(v, f32)
    if lanes == 1:
        a = v[0]
        for x in v[1:]:
            a = f32(a + x)
        return f32(a)
    acc = v[:lanes].copy()
    for k in range(lanes, len(v), lanes):
        acc = (acc + v[k:k + lanes]).astype(f32)
    while len(acc) > 1:
        h = len(acc) // 2
        acc = (acc[:h] + acc[h:]).astype(f32)
    return acc[0]


def _orders(part):
    """Every order a partition's sum might be taken in: the lanes the
    port knows and torch's own CPU sum (the order before the repair)."""
    out = {L: (lambda v, L=L: lanes_sum(v, L))
           for L in (1, 2, 8, 16) if L <= part}
    out["torch"] = lambda v: f32(torch.from_numpy(np.asarray(v, f32)).sum())
    return out


# the encoders whose coupling configs reach every instantiation of the
# kernel (ops/couple_cuda.py INSTANCES), with the padded rows:
# name -> FastEncoder's positional and keyword arguments
ENCODERS = {"q0.5": ((2, 44100, 0.5), {}), "q0.2": ((2, 44100, 0.2), {}),
            "16 kHz": ((2, 16000, 0.5), {}), "32 kHz": ((2, 32000, 0.5), {}),
            "managed": ((2, 44100), dict(bitrate=(-1, 128000, -1)))}


def config(dev):
    """The coupling tables and constants of a stereo DeviceFastEncode."""
    from vorbis_tpu_torch.ops.xla_f32 import SUM_LANES
    cp, nm = dev.ctx.couple, dev.ctx.normal
    n2 = dev.n // 2

    def tab(name, default=None):
        t = getattr(dev, name, None)
        return default if t is None else t.cpu().numpy()[:n2]
    return dict(
        n2=n2, part=int(cp["partition"]), tfe=int(cp.get("tonefix_end", 0)),
        limit=int(cp["limit"]), start=int(nm["start"]),
        prepoint=f32(cp["prepoint"]), thresh=f32(nm["thresh"]),
        normalize=nm["thresh"] < 9000.0, thr1=tab("thr1_t"),
        thr2=tab("thr2_t"), threv=tab("threv_t"),
        nm_inreg=tab("nm_inreg_t", np.zeros(n2, bool)),
        nm_start=tab("nm_start_t", np.zeros(n2, bool)),
        lanes={s: SUM_LANES[s, int(cp["partition"])]
               for s in SUM_LANES_SITES})


def _straddle(rng, part, vef, lo, hi, bounds, decide, want):
    """Values in [lo, hi) of one partition (m -> the summed values
    vef(m)) whose sum decides otherwise in order `want` than in at
    least one other order (at 32 values torch's sum among them, where
    one is found)."""
    orders = _orders(part)
    vlo, vhi = vef(np.array([lo], f32))[0], vef(np.array([hi], f32))[0]
    for attempt in range(200000):
        m = rng.uniform(lo, hi, part).astype(f32)
        ve = vef(m)
        k = rng.randint(part)
        need = bounds[rng.randint(len(bounds))] - (
            np.float64(ve.sum()) - ve[k])
        if not vlo < need < vhi:
            continue
        a, c = lo, hi
        for _ in range(60):
            mid = (a + c) / 2
            if vef(np.array([mid], f32))[0] < need:
                a = mid
            else:
                c = mid
        for d in range(-8, 9):
            w = m.copy()
            w[k] = f32(a)
            for _ in range(abs(d)):
                w[k] = np.nextafter(w[k], f32(np.inf if d > 0 else -np.inf))
            v = vef(w)
            mine = decide(orders[want](v))
            other = [decide(o(v)) != mine for key, o in orders.items()
                     if key != want]
            # at 32 values, rows that torch's sum decides otherwise (at
            # 8 it sums left to right, as XLA mostly does)
            if other[-1] or ((part < 32 or attempt > 2000) and any(other)):
                return w
    raise RuntimeError("no straddling partition found")


def _empty(F, n2):
    return dict(F=F, md=np.zeros((2 * F, n2), f32),
                curve=np.ones((2 * F, n2), f32),
                used=np.ones(2 * F, bool))


def m6_partition(cfg):
    """The last partition below tonefix_end whose every bin flags -1 at
    |r| in [0.55, 1) (thr2 <= 0.55 <= 1 <= thr1): its start."""
    P, thr1, thr2 = cfg["part"], cfg["thr1"], cfg["thr2"]
    ok = [p * P for p in range(cfg["n2"] // P)
          if p * P < cfg["tfe"] and (thr2[p * P:(p + 1) * P] <= 0.55).all()
          and (thr1[p * P:(p + 1) * P] >= 1).all()]
    return ok[-1]


def m6_rows(cfg, F, seed, pad=0):
    """F frames whose M6 partition's mean imbalance sits on 1.0: the
    magnitude channel holds values in [0.55, 1.45) summing across 32.0
    (or 8.0) in one order and not in another, the angle channel zeros,
    curve 1, epeak zeros (M6 on), the partitions around it silent.  `pad`
    bins are cut from n2.  Also returns the partition's start and the
    values (F, part)."""
    rng = np.random.RandomState(seed)
    P = cfg["part"]
    p0 = m6_partition(cfg)
    n2 = cfg["n2"] - pad
    lanes = 1 if n2 % P else cfg["lanes"]["m6"]
    rows = np.stack([_straddle(rng, P, lambda m: m, 0.55, 1.45, [float(P)],
                               lambda s: bool(s > P), lanes)
                     for _ in range(F)])
    c = _empty(F, n2)
    c["md"][0::2, p0:p0 + P] = rows
    c["epeak"] = np.zeros_like(c["md"])
    return c, p0, rows


def ve_of(m):
    """ve of a bin whose magnitude channel holds m >= 0 and whose angle
    channel holds 0, both curves 1: |m^2 * 0.94| / 2."""
    return f32(f32(f32(m * m) * f32(0.94)) / f32(2.0))


def normalize_decision(cfg):
    def decide(acc):
        acc, th = f32(acc), cfg["thresh"]
        n = int(np.floor(f32(acc - th))) + 1 if acc >= th else 0
        return min(n, int(acc) + 1)
    return decide


def normalize_partition(cfg):
    """The first partition inside the normalize region (above the point
    limit and the region's start) whose thr1 keeps |r| < 0.72 off the
    lossless path: its start."""
    P, thr1 = cfg["part"], cfg["thr1"]
    lim = max(cfg["limit"], cfg["start"])
    return [p * P for p in range(cfg["n2"] // P)
            if p * P >= lim and (thr1[p * P:(p + 1) * P] > 0.72).all()][0]


def normalize_rows(cfg, F, seed, pad=0, epeak=False, npeak=False):
    """F frames whose normalize budget sits on a decision's edge: the
    partition's candidates' energies sum across thresh + k (the floor's
    step) or across an integer k (acc's truncation) in one order and
    not in another.  epeak zeros turn M6 on (the budget then sums in
    the M6 fusion's order); npeak zeros keep the budget as it is."""
    rng = np.random.RandomState(seed)
    P = cfg["part"]
    p0 = normalize_partition(cfg)
    n2 = cfg["n2"] - pad
    site = "normalize_m6" if epeak and cfg["tfe"] > 0 else "normalize"
    lanes = 1 if n2 % P else cfg["lanes"][site]
    th = float(cfg["thresh"])
    kmax = P // 4
    bounds = [th + k for k in range(kmax)] + list(range(1, kmax))
    rows = np.stack([_straddle(rng, P, ve_of, 0.05, 0.7, bounds,
                               normalize_decision(cfg), lanes)
                     for _ in range(F)])
    c = _empty(F, n2)
    c["md"][0::2, p0:p0 + P] = rows
    if epeak:
        c["epeak"] = np.zeros_like(c["md"])
    if npeak:
        c["npeak"] = np.zeros((2 * F, -(-n2 // P)), f32)
    return c, p0, rows


def seeded(cfg, F, seed, epeak=False, npeak=False, lowpass=False, pad=0):
    """F frames of seeded spectra against seeded curves: about half the
    bins below the point fold's unit energy (normalize candidates), a
    run of bins a frame repeated (equal energies rank by bin), frame 1's
    angle channel and frame 2's magnitude channel unused, frame 3 unused
    on both; epeak sparse M9 peaks, npeak the M8 store with about a
    fifth of its partitions at -1; lowpass a per-row bin limit; `pad`
    bins cut from n2."""
    rng = np.random.RandomState(seed)
    n2, P = cfg["n2"] - pad, cfg["part"]
    md = (rng.randn(2 * F, n2) * 2.0).astype(f32)
    curve = ((np.abs(md) * 0.6 + 1e-3)
             * np.exp(rng.randn(2 * F, n2) * 0.3)).astype(f32)
    quiet = rng.rand(2 * F, n2) < 0.5
    md = np.where(quiet, md * f32(0.15), md).astype(f32)
    for f in range(F):
        i0 = rng.randint(n2 - 8)
        for r in (2 * f, 2 * f + 1):
            md[r, i0 + 1:i0 + 6] = md[r, i0]
            curve[r, i0 + 1:i0 + 6] = curve[r, i0]
    used = np.ones(2 * F, bool)
    if F > 3:
        used[[3, 4, 6, 7]] = False
    c = dict(F=F, md=md, curve=curve, used=used)
    if epeak:
        c["epeak"] = np.where(rng.rand(2 * F, n2) < 0.1,
                              rng.rand(2 * F, n2) * 4, 0).astype(f32)
    if npeak:
        np_ = -(-n2 // P)
        c["npeak"] = np.where(rng.rand(2 * F, np_) < 0.2, -1.0,
                              rng.rand(2 * F, np_)).astype(f32)
    if lowpass:
        c["lowpass"] = rng.randint(n2 // 2, n2 + 1, 2 * F).astype(np.int32)
    return c


def carry_rows(cfg, F, seed):
    """F frames whose M6 decision in the first partition of a warp (bin
    128 k, below tonefix_end) turns on the carry, the previous warp's
    last partition's mean imbalance: the first partition's magnitude
    channel holds values in [max thr2, min thr1) there, at most 0.5 wide
    (every bin flags -1), mean m; the previous partition's, a level drawn
    a frame around 2 - m, so rdef = (m + the carry) / 2 crosses 1 on
    about half the frames; curve 1, epeak zeros (M6 on), the angle
    channel zeros.
    Returns (case, the partition's start), or None where no warp's first
    partition can flag -1."""
    P, thr1, thr2 = cfg["part"], cfg["thr1"], cfg["thr2"]
    for p0 in range(128, min(cfg["n2"], cfg["tfe"]), 128):
        lo = max(float(thr2[p0:p0 + P].max()), 0.5)
        hi = min(float(thr1[p0:p0 + P].min()), lo + 0.5)
        if hi > lo * 1.001:
            break
    else:
        return None
    rng = np.random.RandomState(seed)
    c = _empty(F, cfg["n2"])
    rows = rng.uniform(lo, hi, (F, P)).astype(f32)
    lvl = np.maximum(2.0 - rows.mean(1, keepdims=True)
                     + rng.uniform(-0.5, 0.5, (F, 1)), 0.6)
    c["md"][0::2, p0 - P:p0] = (lvl * rng.uniform(0.95, 1.05, (F, P))) \
        .astype(f32)
    c["md"][0::2, p0:p0 + P] = rows
    c["epeak"] = np.zeros_like(c["md"])
    return c, p0


def instance_rows(cfg, seed):
    """label -> case: seeded rows with and without the M9 peaks, padded
    and not, plain and with the M8 store and a lowpass, so that every
    instantiation this config's launches pick runs (with the carry's
    rows where a warp's first partition lies below tonefix_end)."""
    out = {}
    for k, (ep, pad) in enumerate((e, d) for e in (False, True)
                                  for d in (0, cfg["part"] // 4)):
        out[f"epeak {ep}, pad {pad}"] = seeded(cfg, 8, seed + 2 * k,
                                               epeak=ep, pad=pad)
        out[f"epeak {ep}, pad {pad}, M8 lowpass"] = seeded(
            cfg, 8, seed + 2 * k + 1, epeak=ep, npeak=True, lowpass=True,
            pad=pad)
    carry = carry_rows(cfg, 16, seed + 9)
    if carry is not None:
        out["carry"] = carry[0]
    return out


def torch_case(case, device="cpu"):
    """The case's arrays as tensors on `device` (F as it is)."""
    return {k: (v if k == "F" else torch.from_numpy(np.ascontiguousarray(v))
                .to(device)) for k, v in case.items()}


# ---------------------------------------------------------------------------
# the kernel's schedule in numpy

def _psum(v, part, lanes):
    """csrc/couple_quantize.cu psum over (..., PPW, TPP, BPT) values, v[...,
    l, j] bin l + TPP j of the partition: with lanes >= TPP a thread's
    accumulators chain its own slots and fold in halves, then the
    threads' fold by shuffles; one lane is a left-to-right chain of
    shuffled values.  Returns (..., PPW), the sum each thread gets."""
    tpp, bpt = v.shape[-2:]
    if lanes == 1:
        acc = v[..., 0, 0]
        for b in range(1, part):
            acc = (acc + v[..., b % tpp, b // tpp]).astype(f32)
        return acc
    m = lanes // tpp
    acc = v[..., :m].copy()
    for j in range(m, bpt, m):
        acc = (acc + v[..., j:j + m]).astype(f32)
    h = m // 2
    while h >= 1:
        acc = (acc[..., :h] + acc[..., h:2 * h]).astype(f32)
        h //= 2
    a = acc[..., 0]                    # (..., PPW, TPP): a thread's
    h = tpp // 2
    while h >= 1:                      # __shfl_down_sync(a, h, TPP)
        a = (a[..., :h] + a[..., h:2 * h]).astype(f32)
        h //= 2
    return a[..., 0]


def _count(x):
    """the partition's bins set, as the kernel's ballots and popc"""
    return x.sum((-1, -2))


def _rows(t, default, F, n2):
    t = default if t is None else np.asarray(t)
    t = t[None] if t.ndim == 1 else t
    return t[np.arange(F) % t.shape[0]][:, :n2]


def schedule(n2, part):
    """(bins (W, PPW, TPP, BPT), live (W, PPW), partitions (W, PPW)) of
    a frame's warps: warp w, partition q of the warp, thread l of the
    partition, slot j -> bin (w PPW + q) part + l + TPP j, with BPT the
    kernel's bins a thread at this width (ops/couple_cuda.py BPT)."""
    from vorbis_tpu_torch.ops.couple_cuda import BPT
    bpt = BPT[part]
    tpp = part // bpt
    ppw = 32 // tpp
    npt = -(-n2 // part)
    W = -(-npt // ppw)
    p = np.arange(W)[:, None] * ppw + np.arange(ppw)[None]
    bins = (p[..., None, None] * part + np.arange(tpp)[:, None]
            + tpp * np.arange(bpt)[None])
    return bins, p < npt, p


def _load(a, bins, real, fill):
    """a (F, n2) at the schedule's bins, `fill` where not real."""
    return np.where(real[None], a[:, np.minimum(bins, a.shape[1] - 1)],
                    fill).astype(a.dtype)


def replay(cfg, case):
    """(res (F, 2 n2) float32, any_used (F,) bool) of the case as
    csrc/couple_quantize.cu computes it: a warp four partitions of a
    frame, BPT bins a thread strided by its partition's threads, held
    from load to store, M6 only in warps holding a partition below
    tonefix_end with the warp's first partition's carry from a recount
    of the previous partition, the sums in the kernel's chains and
    folds, counts as ballots, the normalize's rank over each thread's
    keys and the partition's shuffled ones (skipped where no thread can
    promote)."""
    F = case["F"]
    md = np.asarray(case["md"], f32)
    n2 = md.shape[-1]
    P = cfg["part"]
    bins, live, pidx = schedule(n2, P)
    W, ppw = live.shape
    bpt = bins.shape[-1]
    tpp = P // bpt
    real = live[..., None, None] & (bins < n2)
    tfe = cfg["tfe"]
    epeak, npeak = case.get("epeak"), case.get("npeak")
    m6 = epeak is not None and tfe > 0
    padded = n2 % P != 0
    lm = 1 if padded else cfg["lanes"]["m6"]
    ln = 1 if padded else cfg["lanes"][
        "normalize_m6" if m6 else "normalize"]
    used = np.asarray(case["used"], bool).reshape(F, 2)
    uM, uA = (used[:, k].reshape(F, 1, 1, 1, 1) for k in (0, 1))
    anyu = uM | uA
    lp = np.full((F, 2), n2)
    if case.get("lowpass") is not None:
        lp = np.asarray(case["lowpass"]).reshape(F, 2)
    cv = np.asarray(case["curve"], f32)

    def res_of(b, r):
        """md (lowpassed), curve and residues of both channels at bins b
        (real r), as load_res and the kernel's divides."""
        mM = np.where(b[None] < lp[:, 0, None, None, None, None],
                      _load(md[0::2], b, r, f32(0)), f32(0))
        mA = np.where(b[None] < lp[:, 1, None, None, None, None],
                      _load(md[1::2], b, r, f32(0)), f32(0))
        cM = np.where(uM, _load(cv[0::2], b, r, f32(1)), f32(1e-10))
        cA = np.where(uA, _load(cv[1::2], b, r, f32(1)), f32(1e-10))
        with np.errstate(divide="ignore", invalid="ignore"):
            rM = np.where(uM, mM / cM, f32(0)).astype(f32)
            rA = np.where(uA, mA / cA, f32(0)).astype(f32)
        return mM, mA, cM, cA, rM, rA

    mM, mA, cM, cA, rM, rA = res_of(bins, real)
    t1 = _load(_rows(case.get("thr1"), cfg["thr1"], F, n2), bins, real,
               f32(0))
    thM = thA = t1
    if epeak is not None:
        ep = np.asarray(epeak, f32)
        thM = np.maximum((t1 - _load(ep[0::2], bins, real, f32(0)))
                         .astype(f32), cfg["prepoint"])
        thA = np.maximum((t1 - _load(ep[1::2], bins, real, f32(0)))
                         .astype(f32), cfg["prepoint"])
    f1M = real & (np.abs(rM) >= thM)
    f1A = real & (np.abs(rA) >= thA)
    lossless = f1M | f1A
    sq = lambda x: np.where(x < 0, -(x * x), x * x).astype(f32)  # noqa

    def stats(rM, rA, r):
        act = r & ((np.abs(rM) >= 0.5) | (np.abs(rA) >= 0.5))
        imb = np.where(act, np.abs((np.abs(rM) - np.abs(rA)).astype(f32)),
                       f32(0)).astype(f32)
        return act, imb

    if m6:
        m6w = np.arange(W) * 32 * bpt < tfe          # warps that run M6
        t2 = _load(np.asarray(cfg["thr2"], f32)[None, :n2], bins,
                   real & m6w[:, None, None, None], f32(0))
        fm1 = real & (((~f1M) & (np.abs(rM) >= t2))
                      | ((~f1A) & (np.abs(rA) >= t2)))
        xM, xA = sq(mM), sq(mA)
        opp = ((xM > 0) & (xA < 0)) | ((xA > 0) & (xM < 0))
        act, imb = stats(rM, rA, real)
        ap, rp = _count(act), _count(act & opp)
        rdsum = _psum(imb, P, lm)
        apf = np.maximum(ap.astype(f32), f32(1))
        td = (rdsum / apf).astype(f32)
        nz = live[None] & (ap > 0) & (pidx * P < tfe)[None]
        c2 = nz & ((rp.astype(f32) / apf).astype(f32) >= f32(0.34))
        # the carry: a shuffle from the previous partition of the warp,
        # the warp's first partition's a recount of the previous warp's
        # last one (where it gates)
        carry = np.full_like(td, f32(-1))
        carry[..., 1:] = np.where(nz, td, f32(-1))[..., :-1]
        for w in range(1, W):
            pp = w * ppw - 1
            if not (m6w[w] and pp * P < tfe):
                continue
            b = pp * P + np.arange(tpp)[:, None] + tpp * np.arange(bpt)
            b = b[None, None]
            r = b < n2
            *_, qM, qA = res_of(b, r)
            a_, i_ = stats(qM, qA, r)
            n_ = _count(a_)[:, 0, 0]
            s_ = _psum(i_, P, lm)[:, 0, 0]
            m_ = (s_ / np.maximum(n_.astype(f32), f32(1))).astype(f32)
            carry[:, w, 0] = np.where(n_ > 0, m_, f32(-1))
        rdef = np.where(carry > 0, (td * f32(0.5) + carry * f32(0.5))
                        .astype(f32), td)
        rdef = np.where(nz, rdef, f32(0))
        c1 = nz & (rdef > 1)
        g = lambda x: x[..., None, None]  # noqa: E731
        prom = fm1 & ~lossless & (g(c1) | (g(c2) & opp))
        lossless = lossless | (prom & m6w[None, :, None, None, None])
    qM, qA = np.rint(rM), np.rint(rA)
    c1 = np.abs(qM) > np.abs(qA)
    mag = np.where(c1, qM, qA)
    ang = np.where(c1, np.where(qM > 0, qM - qA, qA - qM),
                   np.where(qA > 0, qM - qA, qA - qM)).astype(f32)
    flip = ang >= (np.abs(mag) * f32(2)).astype(f32)
    mag = np.where(flip, -mag, mag)
    ang = np.where(flip, -ang, ang)
    mm = np.where(uM, mM, f32(0))
    ma = np.where(uA, mA, f32(0))
    rwM, rwA = sq(mm), sq(ma)
    a2 = np.abs((rwM * f32(0.94)).astype(f32))
    b2 = np.abs((rwA * f32(0.94)).astype(f32))
    tv = _load(_rows(case.get("threv"), cfg["threv"], F, n2), bins, real,
               f32(0))
    hyp = np.where(
        rwM > 0,
        np.where(rwA > 0, a2 + b2,
                 np.where(mm > -ma, a2 - (b2 * tv).astype(f32),
                          -(b2 - (a2 * tv).astype(f32)))),
        np.where(rwA < 0, -(a2 + b2),
                 np.where(-mm > ma, -(a2 - (b2 * tv).astype(f32)),
                          b2 - (a2 * tv).astype(f32)))).astype(f32)
    fsum = ((cM * cM).astype(f32) + (cA * cA).astype(f32)).astype(f32)
    ve = (np.abs(hyp) / fsum).astype(f32)
    mpt = np.rint(np.sqrt(ve))
    mpt = np.where(hyp < 0, -mpt, mpt)
    outM = np.where(lossless, mag, mpt).astype(f32)
    outA = np.where(lossless, ang, f32(0)).astype(f32)
    if cfg["normalize"]:
        if case.get("inlimit") is None:
            inreg = _load(np.asarray(cfg["nm_inreg"])[None, :n2], bins, real,
                          False)
        else:
            inreg = _load(np.asarray(cfg["nm_start"])[None, :n2]
                          & _rows(case["inlimit"], None, F, n2), bins,
                          real, False)
        cand = real & ~lossless & (ve < f32(0.25)) & inreg & anyu
        npk = np.zeros((F, W, ppw), f32)
        if npeak is not None:
            nk = np.asarray(npeak, f32)
            ok = pidx < nk.shape[1]
            pc = np.minimum(pidx, nk.shape[1] - 1)
            pM = np.where(ok, nk[0::2][:, pc], f32(0))
            pA = np.where(ok, nk[1::2][:, pc], f32(0))
            npk = np.where((pM < -0.5) | (pA < -0.5), f32(-1),
                           np.minimum(pM, pA)).astype(f32)
            cand = cand & (npk > -0.5)[..., None, None]
        acc = _psum(np.where(cand, ve, f32(0)), P, ln)
        if npeak is not None:
            acc = (acc + ((acc * npk).astype(f32) * npk).astype(f32)) \
                .astype(f32)
        th = cfg["thresh"]
        with np.errstate(invalid="ignore"):
            npro = np.where(acc >= th, np.floor((acc - th).astype(f32))
                            .astype(np.int64) + 1, 0)
            npro = np.minimum(npro, acc.astype(np.int64) + 1)
        npro = npro[..., None, None]
        key = np.where(cand, np.abs(hyp), f32(-np.inf))
        rank = np.zeros(key.shape, np.int64)
        pos = np.arange(tpp)[:, None] + tpp * np.arange(bpt)[None]
        for s_ in range(tpp):
            for k in range(bpt):
                kk = key[..., s_:s_ + 1, k:k + 1]
                rank += (kk > key) | ((kk == key) & (pos[s_, k] < pos))
        # a warp where no thread can promote skips the rank
        want = (cand & (npro > 0)).any((2, 3, 4))
        sel = cand & (rank < npro) & want[:, :, None, None, None]
        outM = np.where(sel, np.where(hyp < 0, f32(-1), f32(1)), outM)
    outM = np.where(anyu, outM, f32(0)).astype(f32)
    outA = np.where(anyu, outA, f32(0)).astype(f32)
    res = np.zeros((F, n2, 2), f32)
    rb = real.reshape(-1)
    res[:, bins.reshape(-1)[rb], 0] = outM.reshape(F, -1)[:, rb]
    res[:, bins.reshape(-1)[rb], 1] = outA.reshape(F, -1)[:, rb]
    return res.reshape(F, 2 * n2), anyu.reshape(F)
