"""Coupling rows for the stereo coupling kernel's checks
(ops/couple_cuda.py, csrc/couple_quantize.cu), shared by
tests/test_torch_couple.py, tests/test_torch_cuda.py::
test_couple_quantize_equals_plain_on_cuda and chip_smoke.py phase 3o.  No
JAX: the card test and the chip phase import it.

A case is a dict: F and the numpy keyword arguments of `couple_quantize`
(md and curve (2F, n2) float32, used (2F,) bool; optionally epeak (2F,
n2), npeak (2F, ncols), lowpass (2F,) int32 and the thr1, threv and
inlimit rows).  `config(dev)` reads a stereo DeviceFastEncode's coupling
tables; `replay(cfg, case)` is the kernel's schedule in numpy (slots of
a frame in warps, the partition sums as the kernel's shuffles, counts
as ballots, M6's two passes, the normalize's rank by counting).
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


def seeded(cfg, F, seed, epeak=False, npeak=False, lowpass=False):
    """F frames of seeded spectra against seeded curves: about half the
    bins below the point fold's unit energy (normalize candidates), a
    run of bins a frame repeated (equal energies rank by bin), frame 1's
    angle channel and frame 2's magnitude channel unused, frame 3 unused
    on both; epeak sparse M9 peaks, npeak the M8 store with about a
    fifth of its partitions at -1; lowpass a per-row bin limit."""
    rng = np.random.RandomState(seed)
    n2, P = cfg["n2"], cfg["part"]
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


def torch_case(case, device="cpu"):
    """The case's arrays as tensors on `device` (F as it is)."""
    return {k: (v if k == "F" else torch.from_numpy(np.ascontiguousarray(v))
                .to(device)) for k, v in case.items()}


# ---------------------------------------------------------------------------
# the kernel's schedule in numpy

def _shfl(v, k, width):
    """__shfl_sync(v, k, width) over the last axis (32 lanes)."""
    lane = np.arange(32)
    return v[..., (lane // width) * width + k]


def _shfl_down(v, d, width):
    lane = np.arange(32)
    src = np.where(lane % width + d < width, lane + d, lane)
    return v[..., src]


def _part_sum(v, part, lanes):
    if lanes == 1:
        acc = _shfl(v, 0, part)
        for k in range(1, part):
            acc = (acc + _shfl(v, k, part)).astype(f32)
        return acc
    a = v.copy()
    for k in range(lanes, part, lanes):
        a = (a + _shfl_down(v, k, part)).astype(f32)
    h = lanes // 2
    while h >= 1:
        a = (a + _shfl_down(a, h, part)).astype(f32)
        h //= 2
    return _shfl(a, 0, part)


def _count(x, part):
    """the partition's lanes set, as the kernel's ballot and popc"""
    g = x.reshape(x.shape[:-1] + (32 // part, part)).sum(-1)
    return np.repeat(g, part, -1)


def _rows(t, default, F, n2):
    t = default if t is None else np.asarray(t)
    t = t[None] if t.ndim == 1 else t
    return t[np.arange(F) % t.shape[0]][:, :n2]


def replay(cfg, case):
    """(res (F, 2 n2) float32, any_used (F,) bool) of the case as
    csrc/couple_quantize.cu computes it: each frame's bins in slots of
    whole warps (bins past n2 zero), the partition sums, counts and
    ranks on 32-lane words."""
    F = case["F"]
    md = np.asarray(case["md"], f32)
    n2 = md.shape[-1]
    P = cfg["part"]
    npt = -(-n2 // P)
    slots = -(-npt * P // 32) * 32
    W = slots // 32
    epeak, npeak = case.get("epeak"), case.get("npeak")
    m6 = epeak is not None and cfg["tfe"] > 0
    padded = n2 % P != 0
    lm = 1 if padded else cfg["lanes"]["m6"]
    ln = 1 if padded else cfg["lanes"][
        "normalize_m6" if m6 else "normalize"]
    used = np.asarray(case["used"], bool).reshape(F, 2)
    uM, uA = used[:, 0, None], used[:, 1, None]
    anyu = uM | uA

    def slot(x, fill=0):
        out = np.full((F, slots), fill, x.dtype)
        out[:, :n2] = x
        return out
    real = slot(np.ones((F, n2), bool), False)
    mM, mA = slot(md[0::2]), slot(md[1::2])
    if case.get("lowpass") is not None:
        lp = np.asarray(case["lowpass"]).reshape(F, 2)
        b = np.arange(slots)
        mM = np.where(b < lp[:, :1], mM, f32(0))
        mA = np.where(b < lp[:, 1:], mA, f32(0))
    cv = np.asarray(case["curve"], f32)
    cM = np.where(uM, slot(cv[0::2], f32(1)), f32(1e-10))
    cA = np.where(uA, slot(cv[1::2], f32(1)), f32(1e-10))
    with np.errstate(divide="ignore", invalid="ignore"):
        rM = np.where(uM, mM / cM, f32(0)).astype(f32)
        rA = np.where(uA, mA / cA, f32(0)).astype(f32)
    t1 = slot(_rows(case.get("thr1"), cfg["thr1"], F, n2))
    thM = thA = t1
    if epeak is not None:
        ep = np.asarray(epeak, f32)
        thM = np.maximum((t1 - slot(ep[0::2])).astype(f32), cfg["prepoint"])
        thA = np.maximum((t1 - slot(ep[1::2])).astype(f32), cfg["prepoint"])
    f1M = real & (np.abs(rM) >= thM)
    f1A = real & (np.abs(rA) >= thA)
    lossless = f1M | f1A
    sq = lambda x: np.where(x < 0, -(x * x), x * x).astype(f32)  # noqa
    if m6:
        t2 = slot(np.asarray(cfg["thr2"], f32)[:n2])
        flagm1 = real & (((~f1M) & (np.abs(rM) >= t2))
                         | ((~f1A) & (np.abs(rA) >= t2)))
        rwM, rwA = sq(mM), sq(mA)
        opp = ((rwM > 0) & (rwA < 0)) | ((rwA > 0) & (rwM < 0))
        act = real & ((np.abs(rM) >= 0.5) | (np.abs(rA) >= 0.5))
        imb = np.where(act, np.abs((np.abs(rM) - np.abs(rA)).astype(f32)),
                       f32(0)).astype(f32)
        w = lambda x: x.reshape(F, W, 32)  # noqa: E731
        ap = _count(w(act), P).reshape(F, slots)
        rp = _count(w(act & opp), P).reshape(F, slots)
        rd = _part_sum(w(imb), P, lm).reshape(F, slots)
        # the lane at each partition's start writes shared memory
        first = np.arange(0, npt * P, P)
        apf = np.maximum(ap[:, first].astype(f32), f32(1))
        tdef = (rd[:, first] / apf).astype(f32)
        nz = (ap[:, first] > 0) & (first < cfg["tfe"])[None]
        c2 = nz & ((rp[:, first].astype(f32) / apf).astype(f32)
                   >= f32(0.34))
        carry = np.full_like(tdef, -1.0)
        carry[:, 1:] = np.where(nz[:, :-1], tdef[:, :-1], f32(-1))
        rdef = np.where(carry > 0, (tdef * f32(0.5) + carry * f32(0.5))
                        .astype(f32), tdef)
        rdef = np.where(nz, rdef, f32(0))
        c1 = nz & (rdef > 1)
        pidx = np.minimum(np.arange(slots) // P, npt - 1)
        inpart = np.arange(slots) < npt * P
        prom = flagm1 & ~lossless & inpart & (
            c1[:, pidx] | (c2[:, pidx] & opp))
        lossless = lossless | prom
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
    tv = slot(_rows(case.get("threv"), cfg["threv"], F, n2))
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
            inreg = slot(np.asarray(cfg["nm_inreg"])[:n2][None]
                         .repeat(F, 0), False)
        else:
            inreg = slot(np.asarray(cfg["nm_start"])[:n2][None]
                         & _rows(case["inlimit"], None, F, n2), False)
        cand = real & ~lossless & (ve < f32(0.25)) & inreg & anyu
        pidx = np.arange(slots) // P
        npk = np.zeros((F, slots), f32)
        if npeak is not None:
            nk = np.asarray(npeak, f32)
            ok = pidx < nk.shape[1]
            pc = np.minimum(pidx, nk.shape[1] - 1)
            pM = np.where(ok, nk[0::2][:, pc], f32(0))
            pA = np.where(ok, nk[1::2][:, pc], f32(0))
            npk = np.where((pM < -0.5) | (pA < -0.5), f32(-1),
                           np.minimum(pM, pA)).astype(f32)
            cand = cand & (npk > -0.5)
        w = lambda x: x.reshape(F, W, 32)  # noqa: E731
        acc = _part_sum(w(np.where(cand, ve, f32(0))), P, ln) \
            .reshape(F, slots)
        if npeak is not None:
            acc = (acc + ((acc * npk).astype(f32) * npk).astype(f32)) \
                .astype(f32)
        th = cfg["thresh"]
        npro = np.where(acc >= th, np.floor((acc - th).astype(f32))
                        .astype(np.int64) + 1, 0)
        npro = np.minimum(npro, acc.astype(np.int64) + 1)
        key = w(np.where(cand, np.abs(hyp), f32(-np.inf)))
        j = np.arange(32) % P
        rank = np.zeros(key.shape, np.int64)
        for k in range(P):
            kk = _shfl(key, k, P)
            rank += (kk > key) | ((kk == key) & (k < j))
        sel = cand & (rank.reshape(F, slots) < npro)
        outM = np.where(sel, np.where(hyp < 0, f32(-1), f32(1)), outM)
    outM = np.where(anyu, outM, f32(0))[:, :n2]
    outA = np.where(anyu, outA, f32(0))[:, :n2]
    res = np.stack([outM, outA], -1).reshape(F, 2 * n2).astype(f32)
    return res, anyu[:, 0]
