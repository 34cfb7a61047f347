"""Residue rows for the residue kernel's checks (ops/residue_encode_cuda.py,
csrc/residue_encode.cu), shared by tests/test_torch_residue_encode.py,
tests/test_torch_cuda.py::test_residue_encode_on_cuda and chip_smoke.py
phase 3l.  No JAX: the card test and the chip phase import it.

A config is a finish config of the port's DeviceFastEncode (the device
step itself, or a submap's namespace of a 5.1 layout) with `res_enc`.
Its rows are laid out as the kernel reads them: F * res_ch rows of
row_len(cfg, n2) float32 values (the interleaved channels of a type-2
row, one channel's n2 bins of a type-1 row), with used (F, res_ch).
Every value is integral, as the finish's rounded residues are.
"""

import numpy as np

# large enough to pass every stage's widest lattice (the stage-0 books
# reach +-7448) and to clamp the digits; small enough that a
# partition's int32 |x| sum cannot wrap
STRESS = 1 << 20


def row_len(cfg, n2):
    return n2 * cfg.res_enc.nch


def _thresholds(cfg):
    """(cm1, cm2) of the config's classes."""
    ri = cfg.ri
    return (np.asarray(ri.classmetric1, np.int64)[:cfg.possible],
            np.asarray(ri.classmetric2, np.int64)[:cfg.possible])


def _spread(rng, n, peak):
    """n integral values in [-peak, peak], one of them at +-peak."""
    v = rng.randint(-peak, peak + 1, n).astype(np.float64) if peak else \
        np.zeros(n)
    v[rng.randint(n)] = peak * (1 if rng.rand() < 0.5 else -1)
    return v


def _entropy(s, spp):
    """_classify's entropy of a partition whose |x| sums to s."""
    scale = np.float32(np.float32(100.0) / np.float32(spp))
    return int(np.float32(np.float32(s) * scale))


def _on_threshold(cfg, rng, k, d1, d2):
    """One partition's spp values whose statistics sit on class k's
    thresholds moved by d1 and d2: type 2, channel 0's max |x| at cm1[k]
    + d1 and the other channels' at cm2[k] + d2; type 1, the max at
    cm1[k] + d1 and the entropy at cm2[k] + d2 where one reaches it."""
    spp, nch = cfg.spp, cfg.res_enc.nch
    cm1, cm2 = _thresholds(cfg)
    a = max(int(cm1[k]) + d1, 0)
    out = np.zeros(spp)
    if cfg.res_type == 2:
        b = max(int(cm2[k]) + d2, 0)
        out[0::nch] = _spread(rng, spp // nch, a)
        other = np.concatenate([np.arange(c, spp, nch)
                                for c in range(1, nch)])
        out[other] = _spread(rng, len(other), b)
        return out
    out[:] = _spread(rng, spp, a)
    if cm2[k] >= 0 and a > 0:
        want = int(cm2[k]) + d2
        sums = [s for s in range(a, a * spp + 1)
                if _entropy(s, spp) == want]
        if sums:
            rest = sums[0] - a
            v = np.zeros(spp)
            v[0] = a
            for i in range(1, spp):
                v[i] = min(rest, a)
                rest -= v[i]
            sign = np.where(rng.rand(spp) < 0.5, -1.0, 1.0)
            out[:] = rng.permutation(v) * sign
    return out


def inputs(cfg, n2, seed, frames=16):
    """(res (frames * res_ch, row_len) float32, used (frames, res_ch)
    bool): seeded typical frames (each partition at a random scale),
    then the edge frames: every class's thresholds, on and one either
    side; an all-zero frame; an unused frame of typical values."""
    rng = np.random.RandomState(seed)
    rc, L, spp = cfg.res_ch, row_len(cfg, n2), cfg.spp
    begin, parts = cfg.ri.begin, cfg.partvals
    scales = np.array([0, 0.4, 1, 2, 3, 6, 12, 30, 80, 300, 1500, 6000])
    rows = []
    for _ in range(frames * rc):
        lap = rng.laplace(size=L) * scales[rng.randint(len(scales), size=L
                                                       // spp + 1)
                                           ].repeat(spp)[:L]
        rows.append(np.rint(lap))
    typical = np.asarray(rows)
    edge = []
    for k in range(cfg.possible - 1):
        for d1, d2 in ((0, 0), (1, 0), (0, 1), (-1, -1), (-1, 1)):
            edge.append(_on_threshold(cfg, rng, k, d1, d2))
    # threshold partitions, a row's worth at a time
    nrow = -(-len(edge) // parts)
    thr = np.zeros((max(nrow, 1), L))
    for j, part in enumerate(edge):
        r, p = divmod(j, parts)
        thr[r, begin + p * spp:begin + (p + 1) * spp] = part
    thr = np.concatenate([thr, np.zeros((-len(thr) % rc, L))])
    zero = np.zeros((rc, L))
    unused = typical[:rc]
    res = np.concatenate([typical, thr, zero, unused]).astype(np.float32)
    F = len(res) // rc
    used = rng.rand(F, rc) < 0.9
    used[:frames // 2] = True
    used[frames:F - 2] = True           # the thresholds' rows
    used[F - 2] = True                  # the zero frame
    used[F - 1] = False                 # the unused frame
    return np.ascontiguousarray(res), used


def stress_rows(cfg, n2, seed, frames=4):
    """Frames of large magnitudes (up to STRESS) that reach every stage
    and clamp the digits, every partition in the widest class, all
    used."""
    rng = np.random.RandomState(seed)
    rc, L = cfg.res_ch, row_len(cfg, n2)
    mags = rng.choice([STRESS, 40000, 9000, 3000],
                      size=(frames * rc, L))
    res = np.rint((rng.rand(frames * rc, L) * 2 - 1) * mags)
    return (np.ascontiguousarray(res.astype(np.float32)),
            np.ones((frames, rc), bool))


def cast_rows(cfg, n2, seed, frames=2):
    """Frames of typical values with three partitions of zeros holding a
    quarter of their values at the edge of int32: +3e9 and +inf, which
    XLA's convert saturates to INT_MAX (the widest class, digits
    clamped) and torch's own CPU cast takes to INT_MIN, and NaN, which
    XLA converts to 0.  All used.  (Values past -2^31 convert to INT_MIN
    both ways.)"""
    rng = np.random.RandomState(seed)
    rc, L, spp = cfg.res_ch, row_len(cfg, n2), cfg.spp
    begin = cfg.ri.begin
    res = np.rint(rng.laplace(size=(frames * rc, L)) * 30)
    for r in range(frames * rc):
        for v in (3e9, np.inf, np.nan):
            lo = begin + rng.randint(cfg.partvals) * spp
            res[r, lo:lo + spp] = 0
            pick = lo + rng.choice(spp, size=max(spp // 4, 1), replace=False)
            res[r, pick] = v
    return (np.ascontiguousarray(res.astype(np.float32)),
            np.ones((frames, rc), bool))


def int_min_rows(cfg, n2, seed, frames=2):
    """Frames of typical values with partitions holding a quarter of their
    values at -3e9 and at -inf (both convert to INT_MIN) and the rest at
    +-3000, so that every such partition takes the widest class (type 2:
    channel 0's magnitude; type 1: the +-3000 values' max, the INT_MIN
    ones wrapping to INT_MIN under abs).  INT_MIN then reaches the
    widest class's lattice divide at every stage, the remainder staying
    below -2^31.  All used."""
    rng = np.random.RandomState(seed)
    rc, L, spp = cfg.res_ch, row_len(cfg, n2), cfg.spp
    begin = cfg.ri.begin
    res = np.rint(rng.laplace(size=(frames * rc, L)) * 30)
    for r in range(frames * rc):
        for v in (-3e9, -np.inf):
            for p in rng.choice(cfg.partvals, size=min(3, cfg.partvals),
                                replace=False):
                lo = begin + p * spp
                res[r, lo:lo + spp] = rng.choice([-3000.0, 3000.0], spp)
                pick = lo + rng.choice(spp, size=max(spp // 4, 1),
                                       replace=False)
                res[r, pick] = v
    return (np.ascontiguousarray(res.astype(np.float32)),
            np.ones((frames, rc), bool))


class LatticeVariant:
    """A residue config whose widest class has lattice steps `steps` at
    its first stages with a book (every other field its base config's):
    no shipped book has a step of 2, and a step of 3 only in a class that
    INT_MIN's partitions never take, so the INT_MIN divide at those steps
    is reached through this variant.  Works for the port's configs and
    the JAX package's alike (the base's attributes are read through)."""

    def __init__(self, base, steps=(2, 3)):
        self._base = base
        top = base.possible - 1
        books = [list(row) for row in base.res_books]
        todo = list(steps)
        for s, row in enumerate(books):
            if todo and row[top] is not None:
                row[top] = dict(row[top], delta=todo.pop(0))
        if todo:
            raise ValueError("residue config: too few stages with a book "
                             "for the variant's steps")
        self.res_books = books

    def __getattr__(self, name):
        return getattr(self._base, name)
