"""The schedules of the analysis front's two kernels, replayed on the CPU
(csrc/bark_fit.cu and csrc/mdct_fwd.cu run only on the card:
tests/test_torch_cuda.py, chip_smoke.py phase 3i), bitwise against
their plain versions, no tolerance.

  * bark_fit: numpy float32 through the kernel's own maps: md read in
    the fit's order into W and XY's slots of a team's swizzled shared
    slice, the block sweeps (thread t of a team of TT owns blocks t,
    t + TT, ...: sixteen summands summed in turn, the totals into the
    padded t1), the level-1 chains (one thread a (array, row, 16
    blocks)), the level-2 chains into t2, the second sweep's exclusive
    adds into Q (a bin's N, X, XX, Y one 16-byte word) and XY, and the
    fit on bins t + TT j with fit1 written in pass 1 and work carried to
    pass 2 in W.  On the five configurations of test_torch_mdct.py's
    test_front_bitwise_against_spectra and on the bark windows of every
    n/2 = 32-4096, with one row a team and with full groups of rows (and
    a part-filled last group), teams of one warp and of four.
  * mdct_fwd: the cp.async staging offsets of the frames and their
    windows (at n < 1024 the fold reads the same 16-byte words from
    global memory), the fold's two 16-byte chunks a lane, the twiddles
    gathered from T, two radix-2 stages a pass, the tails one chunk a
    lane through the XOR swizzle and the final stage's coalesced
    stores, at n = 64-8192; and the bank maps: no two lanes of one
    shared access on one bank.

The arithmetic is xla_f32's (flush-to-zero, the exact fma); only the
order and the maps are the kernels'.
"""

import numpy as np
import pytest
import torch

from tests import oracle
from vorbis_tpu_torch.models import encsetup
from vorbis_tpu_torch.ops import psy as PSY
from vorbis_tpu_torch.ops.bark_cuda import (TODB_C140, bark_fit_plain,
                                            bark_tables)
from vorbis_tpu_torch.ops.mdct import _imdct_index_tables
from vorbis_tpu_torch.ops.mdct_cuda import (TODB_C345, TODB_SCALE,
                                            MdctFwdKernel, _bf32_xla,
                                            mdct_fwd_plain)
from vorbis_tpu_torch.ops.torchdsp import DeviceAnalysis, bark_regions
from vorbis_tpu_torch.ops.xla_f32 import fma as _fma

# one torch thread a pytest-xdist worker (tests/test_torch_analysis.py)
torch.set_num_threads(1)

F = np.float32
FLT_MIN = F(2.0 ** -126)
FOUR = np.arange(4)


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def ftz(x):
    x = np.asarray(x, F)
    return np.where(np.abs(x) < FLT_MIN, x * F(0), x)


def add(a, b):
    return ftz(np.add(a, b, dtype=F))


def sub(a, b):
    return ftz(np.subtract(a, b, dtype=F))


def mul(a, b):
    return ftz(np.multiply(a, b, dtype=F))


def div(a, b):
    with np.errstate(all="ignore"):
        return ftz(np.divide(a, b, dtype=F))


def fma(a, b, c):
    t = [torch.from_numpy(np.ascontiguousarray(np.asarray(v, F)))
         for v in (a, b, c)]
    return _fma(*t).numpy()


def xmax(a, b):
    a = np.asarray(a, F)
    return np.where(np.isnan(a) | (a > b), a, F(b)).astype(F)


def xmin(a, b):
    a = np.asarray(a, F)
    return np.where(np.isnan(a) | (a < b), a, b).astype(F)


def todb_u(v):
    return (np.ascontiguousarray(v, F).view(np.int32) & 0x7FFFFFFF) \
        .astype(F)


# -- csrc/bark_fit.cu ---------------------------------------------------

def _sw(e):
    """The bin arrays' swizzle: word e of each aligned 32 at
    e ^ 4((e >> 5) & 3)."""
    return e ^ (((e >> 5) & 3) << 2)


def _qs(e):
    """The 16-byte words' swizzle: word e of each aligned 16 at
    e ^ ((e >> 4) & 7)."""
    return e ^ ((e >> 4) & 7)


def _t1p(q):
    return q + (q >> 4)


def bark_layout(n2, G):
    """The kernel's Layout: blocks a row, the padded row, the five
    arrays' length, the level-1 chains a row, t1's padded words."""
    NB = -(-n2 // 16)
    t1n = 5 * G * NB
    return dict(NB=NB, n2p=16 * NB, R=G * 16 * NB, nc=-(-NB // 16),
                t1w=t1n + (t1n >> 4) + 1)


def bark_gmax(n2, TT):
    """The most rows a team of TT threads takes: every thread a block."""
    NB = -(-n2 // 16)
    return 1 if NB >= TT else TT // NB


def _summands(y, i):
    w = mul(y, y)
    x = i.astype(F)
    wx = mul(w, x)
    h = mul(w, F(0.5))
    first = i == 0
    return [np.where(first, h, w), np.where(first, h, wx),
            np.where(first, F(0), mul(wx, x)),
            np.where(first, mul(h, y), mul(w, y)),
            np.where(first, F(0), mul(wx, y))]


def _fit(Q, XY, rb, i, n2, tab, fixed, k1, k2):
    """fit() of the kernel on bins i of the row at rb, gathered from the
    swizzled arrays Q ((N, X, XX, Y) a 16-byte word) and XY."""
    if k2 == 0:
        return div(fma(i.astype(F), F(0), F(0)), F(1))
    k = np.minimum(i, k2 - 1)
    if tab is not None:
        t = tab[k]
        l = (t & 0xFFFF).astype(np.uint16).view(np.int16).astype(np.int64)
        h = (t >> 16).astype(np.int64)
    else:
        h = np.minimum(k + fixed // 2, n2 - 1)
        l = k + fixed // 2 - fixed
    neg = k < k1
    eh, el = rb + h, rb + np.where(neg, -l, l)
    qh, ql = Q[_qs(eh)], Q[_qs(el)]
    tN = np.where(neg, add(qh[:, 0], ql[:, 0]), sub(qh[:, 0], ql[:, 0]))
    tX = sub(qh[:, 1], ql[:, 1])
    tXX = np.where(neg, add(qh[:, 2], ql[:, 2]), sub(qh[:, 2], ql[:, 2]))
    tY = np.where(neg, add(qh[:, 3], ql[:, 3]), sub(qh[:, 3], ql[:, 3]))
    tXY = sub(XY[_sw(eh)], XY[_sw(el)])
    D = np.where(neg & (k1 <= 8), fma(-tX, tX, mul(tN, tXX)),
                 fma(tN, tXX, -mul(tX, tX)))
    A = fma(tY, tXX, -mul(tX, tXY))
    B = fma(tN, tXY, -mul(tX, tY))
    return div(fma(i.astype(F), B, A), D)


def bark_replay(md, tabs, G, TT):
    """csrc/bark_fit.cu's schedule on md (rows, n2) float32 with G rows a
    team of TT threads: (fit1, dB, stats) where stats holds the thread
    maps the kernel uses (checked by the callers)."""
    rows, n2 = md.shape
    L = bark_layout(n2, G)
    NB, n2p, R, nc = L["NB"], L["n2p"], L["R"], L["nc"]
    lo = tabs["bark_lo32"].numpy().astype(np.int64)
    hi = tabs["bark_hi32"].numpy().astype(np.int64)
    tab = ((lo & 0xFFFF) | (hi << 16)).astype(np.int32)
    i1, i2, j1, j2, fixed = (tabs[k] for k in ("i1", "i2", "j1", "j2",
                                               "fixed"))
    fit1 = np.full((rows, n2), np.nan, F)
    dB = np.full((rows, n2), -1, np.int32)
    # the sweeps' slots: thread s % TT owns slot s = (row s // NB, block)
    slot = np.arange(G * NB)
    sr, sb = slot // NB, slot % NB
    k16 = np.arange(16)
    sidx = _sw((sr * n2p + 16 * sb)[:, None] + 4 * (k16 // 4)) + k16 % 4
    bins = 16 * sb[:, None] + k16
    it = np.arange(5 * G * nc)
    car, cc = it // nc, it % nc
    q0, ln = car * NB + 16 * cc, np.minimum(16, NB - 16 * cc)
    for grp in range(-(-rows // G)):
        row0 = grp * G
        nr = min(G, rows - row0)
        Q = np.full((R, 4), np.nan, F)
        XY = np.full(R, np.nan, F)
        W = np.full(R, np.nan, F)
        t1 = np.full(L["t1w"], np.nan, F)
        t2 = np.full(5 * G * nc, np.nan, F)
        i = np.arange(n2)
        for r in range(nr):
            u = todb_u(md[row0 + r])
            W[_sw(r * n2p + i)] = fma(u, F(TODB_SCALE), F(TODB_C345))
            XY[_sw(r * n2p + i)] = xmax(fma(u, F(TODB_SCALE),
                                            F(TODB_C140)), 1.0)
        for pas in (1, 2):
            # (the team's threads sync here: each phase reads what other
            # threads wrote)
            src = XY if pas == 1 else W
            y = src[sidx].copy()              # read before sweep B writes
            if pas == 2:
                y = xmax(y, 1.0)
            y = np.where(bins >= n2, F(0), y)
            e = _summands(y, bins)
            S = np.empty((5, len(slot), 16), F)
            for a in range(5):
                S[a, :, 0] = e[a][:, 0]
                for k in range(1, 16):
                    S[a, :, k] = add(S[a, :, k - 1], e[a][:, k])
                t1[_t1p((a * G + sr) * NB + sb)] = S[a, :, 15]
            # level 1: each chain summed in turn, in place
            acc = t1[_t1p(q0)]
            for k in range(1, 16):
                m = k < ln
                acc = np.where(m, add(acc, t1[_t1p(np.where(m, q0 + k,
                                                            q0))]), acc)
                t1[_t1p(q0 + k)[m]] = acc[m]
            # level 2: the chains' last values in turn, into t2
            if nc > 1:
                ar = np.arange(5 * G)
                acc = None
                for c in range(nc - 1):
                    v = t1[_t1p(ar * NB + 16 * c + 15)]
                    acc = v if c == 0 else add(acc, v)
                    t2[ar * nc + c] = acc
            # sweep B: the exclusive prefix, one add, into Q and XY
            out = []
            for a in range(5):
                ar = a * G + sr
                bp = np.maximum(sb - 1, 0)
                ex = t1[_t1p(ar * NB + bp)]
                c = bp >> 4
                ex = np.where(c > 0, add(ex, t2[ar * nc + np.maximum(c - 1,
                                                                     0)]),
                              ex)
                out.append(np.where(sb[:, None] > 0, add(S[a], ex[:, None]),
                                    S[a]))
            Q[_qs((sr * n2p + 16 * sb)[:, None] + k16)] = np.stack(out[:4],
                                                                   -1)
            XY[sidx] = out[4]
            # the fit: bin i on thread i % TT
            for r in range(nr):
                rb = r * n2p
                Rv = _fit(Q, XY, rb, i, n2, tab, 0, i1, i2)
                if pas == 1:
                    mask = add(xmax(Rv, 0.0), F(-140.0))
                    lm = W[_sw(rb + i)]
                    work = sub(lm, mask)
                    fit1[row0 + r] = sub(lm, work)
                    W[_sw(rb + i)] = work
                else:
                    mask2 = xmax(Rv, 0.0)
                    if fixed > 0:
                        mask2 = xmin(mask2, xmax(
                            _fit(Q, XY, rb, i, n2, None, fixed, j1, j2), 0.0))
                    v = add(mask2, F(0.5))
                    with np.errstate(invalid="ignore"):
                        dB[row0 + r] = np.where(np.isnan(v), 0, np.clip(
                            np.trunc(np.nan_to_num(v)), 0, 39))
    stats = dict(slot_lane=slot % TT, sidx=sidx, chains=(q0, ln),
                 qidx=_qs((sr * n2p + 16 * sb)[:, None] + k16),
                 tab_lo=(tab & 0xFFFF).astype(np.uint16).view(np.int16),
                 tab_hi=tab >> 16, lo=lo, hi=hi)
    return fit1, dB, stats


def _look_tables(setup, bt, n2, rate):
    """bark_tables of blocktype bt's psy look at n2 bins."""
    look = PSY.PsyLook(setup.psy_params[bt], setup.psy_global, n2, rate)
    reg = bark_regions(look, n2)
    return bark_tables(*(reg[k] for k in ("bark_lo", "bark_hi", "i1", "i2",
                                          "j1", "j2", "fixed")), "cpu")


def _spectra_rows(rows, n2, seed):
    """MDCT-like rows over eight decades, with +-0, subnormals, a huge
    value and a row of zeros."""
    rng = np.random.RandomState(seed)
    md = (rng.randn(rows, n2) * 10.0 ** rng.uniform(-6, 2, (rows, n2))
          ).astype(F)
    md[0, :6] = [0.0, -0.0, 1e-45, -1e-40, 3e38, -7.0]
    md[-1] = 0.0
    return md


def _check_bark(md, tabs, G, TT):
    fit1, dB, st = bark_replay(md, tabs, G, TT)
    want = bark_fit_plain(torch.from_numpy(md), tabs)
    assert np.array_equal(_bits(fit1), _bits(want[0].numpy()))
    assert np.array_equal(dB, want[1].numpy())
    # the packed windows unpack to the tables
    assert np.array_equal(st["tab_lo"], st["lo"])
    assert np.array_equal(st["tab_hi"], st["hi"])
    return st


# (channels, rate, quality, W): test_torch_mdct.py's FRONT_CASES
FRONT_CASES = [(2, 44100, 0.5, 1), (2, 44100, 0.5, 0), (2, 44100, -0.1, 0),
               (2, 16000, 0.3, 1), (1, 8000, 0.2, 0)]


@pytest.mark.parametrize("case", FRONT_CASES)
def test_bark_schedule_on_front_cases(case):
    """The replay on the MDCT of the oracle signal (mdct_fwd_plain) with
    each configuration's tables, one row a warp and full groups."""
    ch, rate, q, W = case
    setup = encsetup.setup_vbr_staged(ch, rate, q).init()
    bt = min(3 if W else 0, len(setup.psy_params) - 1)
    da = DeviceAnalysis(setup, blocktype=bt, rate=rate, W=W, device="cpu")
    n, n2 = da.n, da.n2
    pcm = oracle.make_test_signal(rate=rate, seconds=0.25, ch=1)[0]
    x = np.concatenate([np.zeros(n, F), pcm.astype(F)])
    hop = n // 2
    rows = min(9, (len(x) - n) // hop)
    fr = np.stack([x[f * hop:f * hop + n] for f in range(rows)])
    md = mdct_fwd_plain(torch.from_numpy(fr), da.window)[0].numpy()
    for TT in (32, 128):
        for G in sorted({1, bark_gmax(n2, TT)}):
            _check_bark(md, da.bark, G, TT)


@pytest.mark.parametrize("n2", [32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_bark_schedule_every_size(n2):
    """The replay at every n/2 the kernel takes from a blocksize, on the
    bark windows of 44.1 kHz long and short looks (reflected regions of
    several sizes, fixed windows and none), with one row a team and with
    full groups and a part-filled last one, teams of one warp and of
    four; the thread maps: every block one thread's, a quarter-warp's
    sixteen-byte sweep accesses on distinct banks, the level-1 chains'
    reads on distinct banks."""
    setup = encsetup.setup_vbr_staged(2, 44100, 0.5).init()
    for bt, TT in ((0, 32), (len(setup.psy_params) - 1, 128)):
        gmax = bark_gmax(n2, TT)
        tabs = _look_tables(setup, bt, n2, 44100)
        rows = 2 * gmax + 1 if n2 < 2048 else 2
        md = _spectra_rows(rows, n2, n2 + bt)
        for G in sorted({1, gmax}):
            st = _check_bark(md, tabs, G, TT)
            lanes = st["slot_lane"]
            # every block of the group on one thread, each thread at
            # most ceil(blocks / TT)
            assert np.bincount(lanes, minlength=TT).max() == \
                -(-len(lanes) // TT)
            # a quarter-warp's 16-byte loads and stores of one step:
            # eight distinct bank groups (XY and W four bins a word, N,
            # X, XX, Y a bin a word)
            for s0 in range(0, len(lanes), 8):
                for q in range(4):
                    words = st["sidx"][s0:s0 + 8, 4 * q]
                    assert len(set((words // 4) % 8)) == len(words)
                for k in range(16):
                    qw = st["qidx"][s0:s0 + 8, k]
                    assert len(set(qw % 8)) == len(qw)
            # the level-1 chains' k-th reads: distinct banks
            q0, ln = st["chains"]
            if bark_layout(n2, G)["NB"] % 16 == 0:
                for s0 in range(0, len(q0), 32):
                    for k in range(16):
                        banks = _t1p(q0[s0:s0 + 32] + k) % 32
                        assert len(set(banks)) == len(banks)


def test_bark_swizzle_is_a_bank_free_permutation():
    """_sw permutes each aligned 32 words onto itself and keeps 16-byte
    words whole, so 32 lanes reading neighbouring bins of one aligned
    run hit 32 banks, and a block's 16-byte words stay in order; _qs
    permutes each aligned 16 16-byte words, so eight lanes reading
    neighbouring bins of one aligned run hit eight bank groups."""
    e = np.arange(1 << 14)
    s = _sw(e)
    assert np.array_equal(np.sort(s), e)
    assert np.array_equal(s >> 5, e >> 5)
    assert np.array_equal(s % 4, e % 4)
    for base in range(0, 1 << 14, 32):
        assert len(set(s[base:base + 32] % 32)) == 32
    q = _qs(e)
    assert np.array_equal(np.sort(q), e)
    assert np.array_equal(q >> 4, e >> 4)
    for base in range(0, 1 << 14, 8):
        assert len(set(q[base:base + 8] % 8)) == 8


# -- csrc/mdct_fwd.cu ---------------------------------------------------

def _ys(e):
    """The working vector's swizzle: word i of 32-float chunk k at
    i ^ 4(k & 7)."""
    return e ^ (((e >> 5) & 7) << 2)


def mdct_gmax(n):
    return 2048 // n if n <= 2048 else 1


def _brev(m, logn):
    out = np.zeros_like(m)
    for b in range(32):
        out |= ((m >> b) & 1) << (31 - b)
    return out >> (33 - logn)


def fold_chunks(n):
    """Item k of the fold: (cA, cB, neg0, neg1); a0 and a2 are words 2
    and 0 of 16-byte chunk cA, a1 and a3 words 1 and 3 of chunk cB."""
    n2, n4, n8 = n >> 1, n >> 2, n >> 3
    k = np.arange(n4)
    r1, r2 = k < n8 // 2, k < (n2 - n8) // 2
    cA = np.where(r2, (n2 + n4) // 4 - k - 1,
                  n // 4 - (k - (n2 - n8) // 2) - 1)
    cB = np.where(r1, (n2 + n4) // 4 + k, k - n8 // 2)
    return cA, cB, ~r2, ~r1


def out_positions(n):
    """Item m of the final stage: the md positions of (f, bk, f2, bk2)
    and the pair each comes from (pair i: md[i] = front, md[n/2-1-i] =
    back)."""
    n2, n4 = n >> 1, n >> 2
    m = np.arange(n >> 3)
    pos = dict(f=m, bk=n2 - 1 - m, f2=n4 - 1 - m, bk2=n4 + m)
    pair = dict(f=m, bk=m, f2=n4 - 1 - m, bk2=n4 - 1 - m)
    return pos, pair


def _tw(n):
    """The twiddle pairs the kernel stages from T, stage after stage."""
    T = MdctFwdKernel.table(n, torch.device("cpu")).numpy()
    n2 = n >> 1
    nst = n.bit_length() - 7
    tw = np.zeros((max(0, n2 // 2 - 16), 2), F)
    ts = []
    for s in range(nst):
        nc = (n2 >> s) >> 2
        j = np.arange(nc)
        t = (4 << s) * (nc - 1 - j)
        off = n2 // 2 - (n2 >> (s + 1))
        tw[off + j] = np.stack([T[t], T[t + 1]], 1)
        ts.append(t)
    return T, tw, ts


def _bfly(lo, hi, w):
    r0, r1 = sub(hi[:, 0], lo[:, 0]), sub(hi[:, 1], lo[:, 1])
    nh = np.stack([add(hi[:, 0], lo[:, 0]), add(hi[:, 1], lo[:, 1])], 1)
    nl = np.stack([fma(r1, w[:, 1], mul(r0, w[:, 0])),
                   fma(r1, w[:, 0], -mul(r0, w[:, 1]))], 1)
    return nl, nh


def mdct_replay(frames, win, wid, G):
    """csrc/mdct_fwd.cu's schedule on frames (R, n) with G rows a warp:
    (md, logmdct, writes) with the count of stores each output got."""
    R, n = frames.shape
    logn = n.bit_length() - 1
    n2, n4, n8 = n >> 1, n >> 2, n >> 3
    nst = logn - 6
    T, tw, _ = _tw(n)
    md = np.full((R, n2), np.nan, F)
    lg = np.full((R, n2), np.nan, F)
    writes = np.zeros((R, n2), np.int64)
    flat = frames.reshape(-1)
    cA, cB, neg0, neg1 = fold_chunks(n)
    pos, pair = out_positions(n)
    for grp in range(-(-R // G)):
        # staging: chunk q of the group from row g G + q / (n/4)
        buf = np.full(G * n, np.nan, F)
        wbuf = np.full(G * n, np.nan, F)
        q = np.arange(G * n4)
        row = grp * G + q // n4
        ok = row < R
        src = row[ok] * n + 4 * (q[ok] % n4)
        buf[(4 * q[ok])[:, None] + FOUR] = flat[src[:, None] + FOUR]
        # and the rows' windows
        wsrc = ((0 if wid is None else wid[row[ok]] * n)
                + 4 * (q[ok] % n4))
        wbuf[(4 * q[ok])[:, None] + FOUR] = win.reshape(-1)[wsrc[:, None]
                                                             + FOUR]
        # the fold, from the staged chunks
        u = np.arange(G * n4)
        r, k = u // n4, u % n4
        ok = grp * G + r < R
        r, k = r[ok], k[ok]
        fa = buf[(r * n + 4 * cA[k])[:, None] + FOUR]
        fb = buf[(r * n + 4 * cB[k])[:, None] + FOUR]
        wa = wbuf[(r * n + 4 * cA[k])[:, None] + FOUR]
        wb = wbuf[(r * n + 4 * cB[k])[:, None] + FOUR]
        x0, x2 = mul(ftz(fa[:, 2]), wa[:, 2]), mul(ftz(fa[:, 0]), wa[:, 0])
        x1, x3 = mul(ftz(fb[:, 1]), wb[:, 1]), mul(ftz(fb[:, 3]), wb[:, 3])
        n0, n1 = neg0[k], neg1[k]
        r0 = add(np.where(n0, -x0, x0), np.where(n1, -x1, x1))
        r1 = add(np.where(n0, -x2, x2), np.where(n1, -x3, x3))
        t = n2 - 2 * (k + 1)
        y = np.full(G * n2, np.nan, F)
        e = _ys(r * n2 + 2 * k)
        y[e] = fma(r1, T[t + 1], mul(r0, T[t]))
        y[e + 1] = fma(r1, T[t], -mul(r0, T[t + 1]))

        def pr(e):
            return _ys(e)[:, None] + np.arange(2)

        s = 0
        while s + 1 < nst:
            P, off0 = n2 >> s, n2 // 2 - (n2 >> (s + 1))
            off1 = n2 // 2 - (n2 >> (s + 2))
            nm = P >> 3
            u = np.arange(G * (n2 >> 3))
            rr, kk = u // (n2 >> 3), u % (n2 >> 3)
            b, m = kk // nm, kk % nm
            q0 = rr * n2 + b * P + 2 * m
            qs = [q0, q0 + P // 4, q0 + P // 2, q0 + 3 * P // 4]
            v = [y[pr(qq)] for qq in qs]
            v[0], v[2] = _bfly(v[0], v[2], tw[off0 + m])
            v[1], v[3] = _bfly(v[1], v[3], tw[off0 + m + nm])
            v[0], v[1] = _bfly(v[0], v[1], tw[off1 + m])
            v[2], v[3] = _bfly(v[2], v[3], tw[off1 + m])
            for qq, vv in zip(qs, v):
                y[pr(qq)] = vv
            s += 2
        if s < nst:
            P, off = n2 >> s, n2 // 2 - (n2 >> (s + 1))
            nc = P >> 2
            u = np.arange(G * (n2 >> 2))
            rr, kk = u // (n2 >> 2), u % (n2 >> 2)
            b, m = kk // nc, kk % nc
            lo = rr * n2 + b * P + 2 * m
            a, c = _bfly(y[pr(lo)], y[pr(lo + P // 2)], tw[off + m])
            y[pr(lo)], y[pr(lo + P // 2)] = a, c
        # the tails: chunk c on lane c % 32, its 16-byte words swizzled
        c = np.arange(G * (n2 >> 5))
        widx = (32 * c[:, None, None]
                + 4 * (np.arange(8)[None, :, None] ^ (c[:, None, None] & 7))
                + FOUR).reshape(len(c), 32)
        y[widx] = _bf32_xla(torch.from_numpy(y[widx])).numpy()
        # the final stage: item (r, m) on lane m % 32
        u = np.arange(G * n8)
        r, m = u // n8, u % n8
        e1 = _brev(m, logn)
        e0 = ((~e1) & (n2 - 1)) - 1
        Ay, Ax = y[_ys(r * n2 + e0) + 1], y[_ys(r * n2 + e0)]
        By, Bx = y[_ys(r * n2 + e1) + 1], y[_ys(r * n2 + e1)]
        cC, sC = T[n + 2 * m], T[n + 2 * m + 1]
        cD, sD = T[n2 + 2 * m], T[n2 + 2 * m + 1]
        cR, sR = T[n - 2 - 2 * m], T[n - 1 - 2 * m]
        rr0, rr1 = sub(Ay, By), add(Ax, Bx)
        rr2 = fma(rr1, cC, mul(rr0, sC))
        rr3 = fma(rr1, sC, -mul(rr0, cC))
        sm, d = add(Ay, By), sub(Ax, Bx)
        scale = F(4.0 / n)
        w0, w1 = fma(F(0.5), sm, rr2), fma(F(0.5), d, rr3)
        val = dict(f=mul(fma(w0, cD, mul(w1, sD)), scale),
                   bk=mul(fma(w0, sD, -mul(w1, cD)), scale))
        w0, w1 = fma(F(0.5), sm, -rr2), fma(F(-0.5), d, rr3)
        val["f2"] = mul(fma(w0, cR, mul(w1, sR)), scale)
        val["bk2"] = mul(fma(w0, sR, -mul(w1, cR)), scale)
        row = grp * G + r
        ok = row < R
        for key in ("f", "bk", "f2", "bk2"):
            p = pos[key][m[ok]]
            md[row[ok], p] = val[key][ok]
            lg[row[ok], p] = fma(todb_u(val[key][ok]), F(TODB_SCALE),
                                 F(TODB_C345))
            np.add.at(writes, (row[ok], p), 1)
    return md, lg, writes


def _mdct_frames(n, rows, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, n) * 10.0 ** rng.uniform(-3, 1, (rows, 1))
         ).astype(F)
    x[0, :6] = [0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39]
    x[1] = 0.0
    x[2::5] *= F(1e-38)
    return x


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_mdct_schedule_emulated(n):
    """The kernel's schedule with one window and with per-row window
    ids, G = 1 and the full groups (a part-filled last one), bitwise
    against mdct_fwd_plain; every output written once."""
    gmax = mdct_gmax(n)
    rows = 2 * gmax + 1 if n <= 1024 else 3
    fr = _mdct_frames(n, rows, n)
    rng = np.random.RandomState(n + 1)
    wins = rng.rand(4, n).astype(F)
    wid = rng.randint(0, 4, rows).astype(np.int32)
    for w, ids in ((wins[3], None), (wins, wid)):
        want = mdct_fwd_plain(torch.from_numpy(fr), torch.from_numpy(w),
                              None if ids is None else torch.from_numpy(ids))
        for G in sorted({1, gmax}):
            md, lg, writes = mdct_replay(fr, w, ids, G)
            assert (writes == 1).all()
            assert np.array_equal(_bits(md), _bits(want[0].numpy()))
            assert np.array_equal(_bits(lg), _bits(want[1].numpy()))


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_mdct_lane_and_bank_maps(n):
    """The twiddles staged from T equal the plain version's stage
    tables; with G = 2048/n rows a warp (one above) every lane owns one
    tail of a group (two, four at n = 4096, 8192); the fold's chunk
    reads, its pair stores, the stages' pair accesses and the tails'
    16-byte accesses put no two lanes of one shared-memory phase (8
    lanes for 16 bytes, 16 for 8) on one bank."""
    n2, n4 = n >> 1, n >> 2
    G = mdct_gmax(n)
    _, _, ts = _tw(n)
    stages = _imdct_index_tables(n)["stages"]
    assert [P for P, _ in stages] == [n2 >> s for s in range(len(ts))]
    for t, (_, tc) in zip(ts, stages):
        assert np.array_equal(t, np.asarray(tc)[:len(t)])
        assert np.array_equal(np.asarray(tc).reshape(-1, len(t)),
                              np.broadcast_to(t, (len(tc) // len(t),
                                                  len(t))))
    tails = np.bincount(np.arange(G * (n2 >> 5)) % 32, minlength=32)
    assert (tails == max(1, n // 2048)).all()

    def distinct(words, width):
        """Each phase of a warp access (lanes of `width` words) on
        distinct bank groups."""
        per = {4: 8, 2: 16}[width]
        for s0 in range(0, len(words), 32):
            w = words[s0:s0 + 32]
            for p0 in range(0, len(w), per):
                g = (w[p0:p0 + per] // width) % (32 // width)
                if len(set(g)) != len(g):
                    return False
        return True

    cA, cB, _, _ = fold_chunks(n)
    k = np.arange(n4)
    # the fold's chunk reads away from its region seams
    for run in np.split(k, [n // 16, (n2 - n // 8) // 2]):
        for s0 in range(0, len(run) - len(run) % 8, 8):
            assert len(set(cA[run[s0:s0 + 8]] % 8)) == 8
            assert len(set(cB[run[s0:s0 + 8]] % 8)) == 8
    # the fold's pair stores, a warp of consecutive k
    assert distinct(_ys(2 * k), 2)
    # the stages' pair accesses
    s = 0
    nst = n.bit_length() - 7
    while s + 1 < nst:
        P, nm = n2 >> s, (n2 >> s) >> 3
        u = np.arange(G * (n2 >> 3))
        kk = u % (n2 >> 3)
        q0 = (u // (n2 >> 3)) * n2 + (kk // nm) * P + 2 * (kk % nm)
        for off in (0, P // 4, P // 2, 3 * P // 4):
            assert distinct(_ys(q0 + off), 2), (n, s, off)
        s += 2
    if s < nst:
        P = n2 >> s
        nc = P >> 2
        u = np.arange(G * (n2 >> 2))
        kk = u % (n2 >> 2)
        lo = (u // (n2 >> 2)) * n2 + (kk // nc) * P + 2 * (kk % nc)
        assert distinct(_ys(lo), 2) and distinct(_ys(lo + P // 2), 2)
    # the tails' 16-byte words
    c = np.arange(G * (n2 >> 5))
    for kw in range(8):
        assert distinct(32 * c + 4 * (kw ^ (c & 7)), 4)
    # the staging: every frame chunk once, at 16-byte aligned offsets
    q = np.arange(G * n4)
    assert np.array_equal(np.sort((q // n4) * n + 4 * (q % n4)),
                          np.arange(0, G * n, 4))
    # the stores: neighbouring lanes on neighbouring words (up or down),
    # every position once, md[i] the front of pair i and md[n/2-1-i] its
    # back
    pos, pair = out_positions(n)
    allp = np.concatenate([pos[key] for key in pos])
    assert np.array_equal(np.sort(allp), np.arange(n2))
    for key in pos:
        assert (np.abs(np.diff(pos[key])) == 1).all()
    for key in ("f", "f2"):
        assert np.array_equal(pos[key], pair[key])
    for key in ("bk", "bk2"):
        assert np.array_equal(pos[key], n2 - 1 - pair[key])
