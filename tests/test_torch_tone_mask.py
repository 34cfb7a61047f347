"""The tone mask (vorbis_tpu_torch/ops/tone_mask_cuda.py, csrc/tone_mask.cu)
against vorbis_tpu/ops/jaxdsp.py DeviceToneMask, both on the CPU, on the
same numpy inputs, at every psy look the encoders run: 44.1 kHz q0.5,
48 kHz 5.1 q0.4, 16 and 32 kHz q0.5, each long and short.

Tolerances: bitwise everywhere.  The plain version takes the JAX
package's adds, subtract and multiply in its order and the rest are
max, min, gathers and selects, exact in any order; the numpy replay of
the kernel's schedule takes the same float32 operations, its maxima on
ordered integer words as the kernel's atomics do.

Rows: tests/tone_mask_cases.py's seeded and edge rows.  The kernel
itself needs a CUDA device: tests/test_torch_cuda.py::test_tone_mask_kernel_on_cuda holds it to
tone_mask_plain on these looks, and chip_smoke.py phase 3k on the main
path's inputs.
"""

import numpy as np
import pytest
import torch

import jax

from vorbis_tpu.models import encsetup as J_encsetup
from vorbis_tpu.ops import jaxdsp as J
from vorbis_tpu.ops import psy as J_psy
from vorbis_tpu_torch.ops.tone_mask_cuda import (NEGINF, PIECE, blob_tables,
                                                 seed_deposits, tone_mask,
                                                 tone_mask_plain,
                                                 window_pieces)
from tests.tone_mask_cases import (LOOKS, ROWS, SHAPES, inputs, port_look,
                                   psy_look, stress_rows)

# one torch thread a pytest-xdist worker (see test_torch_analysis.py)
torch.set_num_threads(1)

f32 = np.float32


@pytest.fixture(scope="session")
def looks():
    """{look: (JAX DeviceToneMask, port DeviceToneMask, inputs, the
    jitted JAX tone mask of the inputs)}, JAX compiled once a look."""
    out = {}
    for case in LOOKS:
        ch, rate, q, W = case
        js = J_encsetup.setup_vbr_staged(ch, rate, q).init()
        jt = J.DeviceToneMask(psy_look(J_psy, js, W, rate))
        tt = port_look(case, "cpu")
        args = inputs(tt.look.n, 17 + len(out))
        want = np.asarray(jax.jit(jt)(*args))
        out[case] = (jt, tt, args, want)
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("case", LOOKS)
def test_plain_bitwise_against_jax(looks, case):
    """tone_mask_plain, and the wrapper on CPU tensors, equal the jitted
    JAX tone mask bit for bit at every look, edge rows included; the
    edge rows reach what they stand for."""
    jt, tt, (lf, gs, ls), want = looks[case]
    assert (tt.look.n, tt.total, tt.n_groups) == SHAPES[case]
    before = tone_mask.launches
    got = tone_mask(tt, _t(lf), _t(gs), _t(ls)).numpy()
    assert tone_mask.launches == before
    plain = tone_mask_plain(tt, _t(lf), _t(gs), _t(ls)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(plain.view(np.int32), want.view(np.int32))
    # the silent row stays on the ATH floor; the level ones saturate
    st = _state(blob_tables(tt.blob), lf, gs, ls)
    assert not st["audible"][ROWS].any()
    assert (st["level"][ROWS + 2] == tt.p_levels - 1).all()
    assert (st["level"][ROWS + 3] == 0).all()
    assert st["audible"][:ROWS].any(1).all()


def _ordered(f):
    b = np.asarray(f, f32).view(np.int32)
    return np.where(b >= 0, b, b ^ np.int32(0x7FFFFFFF))


def _unordered(e):
    e = np.asarray(e, np.int32)
    return np.where(e >= 0, e, e ^ np.int32(0x7FFFFFFF)).view(f32)


ORD_INF = np.int32(0x7F800000)          # _ordered(+inf)
INT_MAX = np.iinfo(np.int32).max


def _state(tb, lf, gs, ls):
    """The kernel's steps 1-2 (csrc/tone_mask.cu) on the blob's tables:
    the group maxima 4 bins a thread (each run of one group in a quad
    carries its max back to its first bin, whose word takes the max), as
    ordered words (gmax), and each group's floor, audibility, level and
    curve row."""
    R, n = lf.shape
    G = tb["G"]
    v = _ordered(lf).reshape(R, n // 4, 4)
    g = tb["bin_group"].reshape(n // 4, 4)
    for k in (2, 1, 0):
        same = g[:, k] == g[:, k + 1]
        v[:, :, k] = np.where(same, np.maximum(v[:, :, k], v[:, :, k + 1]),
                              v[:, :, k])
    first = np.ones_like(g, bool)
    first[:, 1:] = g[:, 1:] != g[:, :-1]
    gmax = np.full((G, R), _ordered(f32(-np.inf)), np.int32)
    np.maximum.at(gmax, g[first], v[:, first].T)
    gmax = gmax.T
    att = np.maximum(ls + tb["ath_adjatt"], tb["ath_maxatt"])
    dboff = tb["max_curve_dB"] - gs
    gm = _unordered(gmax)
    flr = tb["group_static"][:, 0].view(f32)[None, :] + att[:, None]
    audible = (gm + f32(6.0)) > flr
    level = ((((gm + dboff[:, None]) - f32(30.0)) * f32(0.1))
             .astype(np.int32))
    level = np.clip(level, 0, tb["p_levels"] - 1)
    return dict(gmax=gmax, gm=gm, att=att, audible=audible, level=level,
                row=tb["group_band"][None, :] * tb["p_levels"] + level)


def _deposits(tb, st):
    """A group's deposits in the first design's step 3: (its curve rows
    (R, G, 58), each step's line (1, G, EHMER_MAX), the steps it deposits:
    its curve row's [post0, post1), lines 1..T-1, audible groups that own
    a line)."""
    T_, lp = tb["T"], tb["linesper"]
    c = tb["curves"][st["row"]]                       # (R, G, 58)
    k = np.arange(tb["ehmer_max"])
    k0 = np.maximum(c[..., 0].astype(np.int32), 0)[..., None]
    k1 = np.minimum(c[..., 1].astype(np.int32), tb["ehmer_max"])[..., None]
    base = tb["group_base"][None, :, None]
    t = base - tb["ehmer_offset"] * lp - (lp >> 1) + k * lp
    act = ((k >= k0) & (k < k1) & st["audible"][..., None] & (base >= 0)
           & (t >= 1) & (t < T_))
    return c, t, act


def _listing(tb, st):
    """The kernel's step 2 after the group maxima: each group's count of
    in-range deposits (R, G) from its static and posts words at its
    level, and its word (first curve index | first line << 16)."""
    static = tb["group_static"].astype(np.int64)
    g = np.arange(tb["G"])[None, :]
    k0 = tb["group_k0"][g, st["level"]]
    k1 = tb["group_k1"][g, st["level"]]
    live = st["audible"] & (k1 > k0)
    count = np.where(live, k1 - k0, 0)
    word = ((static[:, 1][None, :] + st["level"] * tb["curve_w"] + 2 + k0)
            | ((static[:, 2][None, :] + k0 * tb["linesper"]) << 16))
    return count, np.where(live, word, 0)


def _assign(off, count):
    """The deposit phase's assignment as the kernel makes it, on one
    row's depositing groups' exclusive offsets off and counts: each
    group sets its start's bit in its 32-deposit chunk's word (but at a
    chunk's first deposit) and names itself the first group of each
    chunk whose first deposit it holds; a deposit's group is its chunk's
    first plus the starts at or below its lane.  Returns the group of
    each deposit."""
    N = int(off[-1] + count[-1]) if len(off) else 0
    nch = -(-N // 32)
    starts = np.zeros(nch, np.int64)
    first = np.full(nch, -1, np.int64)
    for k, (o, c) in enumerate(zip(off, count)):
        if o & 31:
            assert not starts[o >> 5] >> (o & 31) & 1
            starts[o >> 5] |= 1 << (o & 31)
        first[(o + 31) >> 5:((o + c - 1) >> 5) + 1] = k
    assert (first >= 0).all()
    i = np.arange(N)
    bits = (starts[i >> 5][:, None] >> np.arange(32)) & 1
    return first[i >> 5] + (bits * (np.arange(32) <= (i & 31)[:, None])
                            ).sum(1)


def _columns(line, T_):
    """A line's word in the kernel's seed buffer: a column a residue mod
    8, column 0 the padding below line 0."""
    cols = ((T_ + 7) >> 3) + 1
    return (line & 7) * cols + (line >> 3) + 1


def _chase(seed, lp):
    """The chase as the kernel's threads run it, 8 lines a thread: line
    8a + s takes the prefix max of block a's columns 0..s and the suffix
    max of block a - 1's columns s + 1..7 (ordered NEGINF below line 0
    and from T up); ordered +inf where no seed reached."""
    assert lp == 8          # the kernel's kLinesPer
    R, T_ = seed.shape
    neg = _ordered(f32(NEGINF))
    A = (T_ + 7) >> 3
    blocks = np.full((R, A + 1, 8), neg, np.int32)   # block -1 first
    blocks.reshape(R, -1)[:, 8:8 + T_] = seed
    p = np.maximum.accumulate(blocks[:, 1:], axis=2)
    q = np.maximum.accumulate(blocks[:, :-1, ::-1], axis=2)[:, :, ::-1]
    run = p.copy()
    run[:, :, :7] = np.maximum(p[:, :, :7], q[:, :, 1:])
    run = run.reshape(R, 8 * A)[:, :T_]
    return np.where(run > neg, run, ORD_INF)


def replay(tb, lf, gs, ls):
    """The kernel's schedule in numpy, read from the blob by its offsets:
    the warp-segment group max, the listing of the depositing groups by
    an exclusive scan of their counts, the deposits as the chunk words
    assign them (_assign), from each group's curve index and line less
    its offset, as a max of ordered words, the chase 4 lines a thread,
    each window's pieces merged by an ordered min, then the clamp and
    the floor a bin."""
    R, n = lf.shape
    T_, lp = tb["T"], tb["linesper"]
    st = _state(tb, lf, gs, ls)
    count, word = _listing(tb, st)
    curves = tb["curves"].reshape(-1)
    cols = ((T_ + 7) >> 3) + 1
    words = np.full((R, 8 * cols), _ordered(f32(NEGINF)), np.int32)
    for r in range(R):
        live = np.nonzero(count[r])[0]
        cnt = count[r, live]
        off = np.cumsum(cnt) - cnt
        group = _assign(off, cnt)
        i = np.arange(len(group))
        wd = word[r, live]
        curve = ((wd & 0xFFFF) - off)[group] + i
        at = (_columns(wd >> 16, T_) - off)[group] + i
        vals = _ordered(st["gm"][r, live][group] + curves[curve])
        np.maximum.at(words[r], at, vals)
    # the columns read back by line: a group's deposits t + 8 i are its
    # column's consecutive words
    seed = words[:, _columns(np.arange(T_), T_)]
    run = _chase(seed, lp)
    plo, phi = tb["piece_lo"], tb["piece_hi"]
    m = np.full((R, len(plo)), ORD_INF, np.int32)
    for i in range(PIECE):
        m = np.where(plo + i <= phi,
                     np.minimum(m, run[:, np.minimum(plo + i, T_ - 1)]), m)
    win = np.full((tb["W"], R), ORD_INF, np.int32)
    np.minimum.at(win, tb["piece_win"], m.T)
    win = win.T
    value = np.where(win == ORD_INF, f32(NEGINF),
                     np.minimum(_unordered(win), tb["tone_abs_limit"]))
    flr = tb["ath"][None, :] + st["att"][:, None]
    return np.maximum(flr, value[:, tb["bin_win"]])


@pytest.mark.parametrize("case", LOOKS)
def test_kernel_schedule_replay(looks, case):
    """The kernel's schedule, replayed in numpy on the blob read back by
    its offsets, equals the plain version bit for bit; the deposits it
    drops (lines 0 and >= T, steps outside [post0, post1)) are the
    gathers' seed_ok."""
    _, tt, (lf, gs, ls), _ = looks[case]
    got = replay(blob_tables(tt.blob), lf, gs, ls)
    want = tone_mask_plain(tt, _t(lf), _t(gs), _t(ls)).numpy()
    assert got.dtype == f32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("case", LOOKS)
def test_kernel_schedule_replay_on_stress_rows(case):
    """The replay equals the plain version bit for bit on
    tests/tone_mask_cases.py's stress rows: every group audible at its
    widest in-range span (the most deposits a row of this look can
    make: each group's count at that row is the largest over its curve
    levels) and a row where a single group deposits."""
    tt = port_look(case, "cpu")
    tb = blob_tables(tt.blob)
    lf, gs, ls = stress_rows(tt)
    got = replay(tb, lf, gs, ls)
    want = tone_mask_plain(tt, _t(lf), _t(gs), _t(ls)).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    st = _state(tb, lf, gs, ls)
    count = _listing(tb, st)[0]
    assert st["audible"][0].all()
    # the most deposits of each group over its levels, counted as the
    # first design's schedule does (_deposits) from its own tables
    best = np.zeros(tb["G"], np.int64)
    for v in range(tb["p_levels"]):
        lv = dict(st, level=np.full_like(st["level"], v),
                  audible=np.ones_like(st["audible"]),
                  row=tb["group_band"][None, :] * tb["p_levels"] + v)
        best = np.maximum(best, _deposits(tb, lv)[2][0].sum(-1))
    assert np.array_equal(count[0], best)
    assert (count[1] > 0).sum() == 1


@pytest.mark.parametrize("case", LOOKS)
def test_scanned_offsets_count_seed_deposits(looks, case):
    """The deposits that the block scan lists (the sum of the listed
    groups' counts a row) are exactly seed_deposits' count, a row and in
    all, and each group's count is its deposits in the first design's
    schedule; the chunk words give each deposit its own group, and the
    blob's chunk count holds every row's chunks."""
    _, tt, (lf, gs, ls), _ = looks[case]
    tb = blob_tables(tt.blob)
    st = _state(tb, lf, gs, ls)
    count = _listing(tb, st)[0]
    act = _deposits(tb, st)[2]
    assert np.array_equal(count, act.sum(-1))
    for r in range(len(lf)):
        cnt = count[r, np.nonzero(count[r])[0]]
        group = _assign(np.cumsum(cnt) - cnt, cnt)
        assert np.array_equal(group, np.repeat(np.arange(len(cnt)), cnt))
        assert seed_deposits(tt, _t(lf[r:r + 1]), _t(gs[r:r + 1]),
                             _t(ls[r:r + 1])) == cnt.sum()
        assert -(-cnt.sum() // 32) <= tb["chunks"]
    assert seed_deposits(tt, _t(lf), _t(gs), _t(ls)) == int(count.sum())


@pytest.mark.parametrize("case", LOOKS)
def test_window_pieces_cover_each_window_once(case):
    """The blob's window pieces, read back by blob_tables, cover each
    window's lines [lo, hi] exactly once, in order, each piece of at most
    PIECE lines, and are window_pieces of the blob's windows."""
    tb = blob_tables(port_look(case, "cpu").blob)
    plo, phi, pw = tb["piece_lo"], tb["piece_hi"], tb["piece_win"]
    assert tb["pieces"] == len(plo) > 0
    assert ((phi >= plo) & (phi - plo < PIECE)).all()
    assert (np.diff(pw) >= 0).all()
    for w, (lo, hi) in enumerate(zip(tb["win_lo"], tb["win_hi"])):
        mine = pw == w
        lines = np.concatenate([np.arange(a, b + 1) for a, b in
                                zip(plo[mine], phi[mine])])
        assert np.array_equal(lines, np.arange(lo, hi + 1))
    want = window_pieces(tb["win_lo"], tb["win_hi"])
    for got, w in zip((plo, phi, pw), want):
        assert np.array_equal(got, w)


@pytest.mark.parametrize("case", LOOKS)
def test_seed_deposits_count_the_schedule_deposits(looks, case):
    """seed_deposits, the data-dependent work of chip_smoke.py's tone-mask
    bound, counts the deposits that the kernel's schedule makes on these
    rows."""
    _, tt, (lf, gs, ls), _ = looks[case]
    tb = blob_tables(tt.blob)
    act = _deposits(tb, _state(tb, lf, gs, ls))[2]
    assert seed_deposits(tt, _t(lf), _t(gs), _t(ls)) == int(act.sum()) > 0


@pytest.mark.parametrize("case", LOOKS)
def test_blob_tables_equal_the_jax_look(looks, case):
    """The blob's tables, read back by its offsets, are the JAX look's:
    each bin's group, the groups' first bins and bands, the ATH, each
    bin's window, the curve rows and constants; each group's owned line
    gives exactly the JAX deposit's gathers (seed_src where seed_ok);
    the tables hold no -0.0 (csrc/tone_mask.cu's note on signed zeros)."""
    jt, tt, _, _ = looks[case]
    tb = blob_tables(tt.blob)
    n = tt.look.n
    assert (tb["n"], tb["T"], tb["G"]) == (n, jt.total, jt.n_groups)
    assert (tb["linesper"], tb["p_levels"]) == (jt.linesper, jt.p_levels)
    assert tb["W"] == len(set(zip(np.asarray(jt.win_start).tolist(),
                                  np.asarray(jt.win_end).tolist())))
    assert tb["words"] == tt.blob.numel()
    assert np.array_equal(tb["bin_group"], np.asarray(jt.group_id))
    assert np.array_equal(tb["group_first"], np.asarray(jt.group_first))
    assert np.array_equal(tb["group_band"], np.asarray(jt.group_band))
    assert np.array_equal(tb["ath"].view(np.int32),
                          np.asarray(jt.ath).view(np.int32))
    assert np.array_equal(tb["win_lo"][tb["bin_win"]],
                          np.asarray(jt.win_start))
    assert np.array_equal(tb["win_hi"][tb["bin_win"]],
                          np.asarray(jt.win_end))
    assert np.array_equal(tb["curves"].view(np.int32),
                          np.asarray(jt.curve_rows).view(np.int32))
    for k in ("tone_abs_limit", "ath_adjatt", "ath_maxatt",
              "max_curve_dB"):
        assert tb[k].view(np.int32) == f32(getattr(jt, k)).view(np.int32)
    lp, T_ = jt.linesper, jt.total
    offs = ((np.arange(tb["ehmer_max"]) - tb["ehmer_offset"]) * lp
            - (lp >> 1))
    got_ok = np.zeros_like(jt.seed_ok)
    got_src = np.zeros_like(jt.seed_src)
    for g, b in enumerate(tb["group_base"]):
        if b < 0:
            continue
        for k, o in enumerate(offs):
            if 1 <= b + o < T_:
                assert not got_ok[k, b + o]
                got_ok[k, b + o], got_src[k, b + o] = True, g
    assert np.array_equal(got_ok, jt.seed_ok)
    assert np.array_equal(got_src[got_ok], jt.seed_src[got_ok])
    for a in (tb["ath"], tb["curves"]):
        assert not (np.signbit(a) & (a == 0)).any()
    # the redesign's group tables, from the same look: the ATH at the
    # first bin, the curve rows' base, step 0's line and at each level
    # the steps that deposit in range, counted from seed_ok's lines
    static = tb["group_static"]
    assert np.array_equal(static[:, 0],
                          tb["ath"][tb["group_first"]].view(np.int32))
    assert np.array_equal(static[:, 1],
                          tb["group_band"] * jt.p_levels * tb["curve_w"])
    owned = tb["group_base"] >= 0
    assert np.array_equal(static[owned, 2], tb["group_base"][owned]
                          + offs[0])
    for v in range(jt.p_levels):
        post = tb["curves"][tb["group_band"] * jt.p_levels + v, :2]
        k = np.arange(tb["ehmer_max"])
        dep = ((k >= post[:, :1].astype(np.int32))
               & (k < post[:, 1:].astype(np.int32)) & owned[:, None]
               & (got_ok[k[None, :], np.clip(tb["group_base"][:, None]
                                              + offs, 0, T_ - 1)])
               & (tb["group_base"][:, None] + offs >= 1)
               & (tb["group_base"][:, None] + offs < T_))
        k0, k1 = tb["group_k0"][:, v], tb["group_k1"][:, v]
        assert np.array_equal(np.maximum(k1 - k0, 0), dep.sum(1))
        has = dep.any(1)
        assert np.array_equal(k0[has], dep[has].argmax(1))
