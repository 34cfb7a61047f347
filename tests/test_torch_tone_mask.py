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
from vorbis_tpu_torch.ops.tone_mask_cuda import (NEGINF, blob_tables,
                                                 seed_deposits, tone_mask,
                                                 tone_mask_plain)
from tests.tone_mask_cases import (LOOKS, ROWS, SHAPES, inputs, port_look,
                                   psy_look)

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


def _state(tb, lf, gs, ls):
    """The kernel's steps 1-2 (csrc/tone_mask.cu) on the blob's tables:
    the group maxima by warp segments, as ordered words (gmax), and each
    group's floor, audibility, level and curve row."""
    R, n = lf.shape
    G = tb["G"]
    gmax = np.full((R, G), _ordered(f32(-np.inf)), np.int32)
    lane = np.arange(32)
    for base in range(0, n, 32):
        j = base + lane
        inn = j < n
        v = np.where(inn, _ordered(lf[:, np.minimum(j, n - 1)]),
                     np.iinfo(np.int32).min)
        gid = np.where(inn, tb["bin_group"][np.minimum(j, n - 1)], -1)
        for d in (1, 2, 4, 8, 16):       # shuffles read the old values
            ov = np.concatenate([v[:, :d], v[:, :-d]], 1)
            og = np.concatenate([gid[:d], gid[:-d]])
            v = np.where((lane >= d) & (og == gid), np.maximum(v, ov), v)
        nxt = np.concatenate([gid[1:], gid[:1]])
        for ln in np.nonzero(inn & ((lane == 31) | (j == n - 1)
                                    | (nxt != gid)))[0]:
            g = gid[ln]
            gmax[:, g] = np.maximum(gmax[:, g], v[:, ln])
    att = np.maximum(ls + tb["ath_adjatt"], tb["ath_maxatt"])
    dboff = tb["max_curve_dB"] - gs
    gm = _unordered(gmax)
    flr = tb["ath"][tb["group_first"]][None, :] + att[:, None]
    audible = (gm + f32(6.0)) > flr
    level = ((((gm + dboff[:, None]) - f32(30.0)) * f32(0.1))
             .astype(np.int32))
    level = np.clip(level, 0, tb["p_levels"] - 1)
    return dict(gmax=gmax, gm=gm, att=att, audible=audible, level=level,
                row=tb["group_band"][None, :] * tb["p_levels"] + level)


def _deposits(tb, st):
    """A group's deposits in the kernel's step 3: (its curve rows (R, G,
    58), each step's line (1, G, EHMER_MAX), the steps it deposits: its
    curve row's [post0, post1), lines 1..T-1, audible groups that own a
    line)."""
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


def replay(tb, lf, gs, ls):
    """The kernel's schedule in numpy, read from the blob by its offsets:
    the warp-segment group max, a group's deposits (_deposits) as a max
    of ordered words, the chase a line over the linesper lines at and
    below it, the min over each window's lines, then the clamp and the
    floor a bin."""
    R, n = lf.shape
    T_, lp = tb["T"], tb["linesper"]
    st = _state(tb, lf, gs, ls)
    c, t, act = _deposits(tb, st)
    vals = _ordered(st["gm"][..., None] + c[..., 2:])
    seed = np.full((R, T_), _ordered(f32(NEGINF)), np.int32)
    r, g, kk = np.nonzero(act)
    np.maximum.at(seed, (r, np.broadcast_to(t, act.shape)[r, g, kk]),
                  vals[r, g, kk])
    m = seed.copy()
    for s in range(1, lp):
        m[:, s:] = np.maximum(m[:, s:], seed[:, :-s])
    e = _unordered(m)
    run = np.where(e > f32(NEGINF), e, f32(np.inf)).astype(f32)
    win = np.empty((R, tb["W"]), f32)
    for w, (lo, hi) in enumerate(zip(tb["win_lo"], tb["win_hi"])):
        mv = run[:, lo:min(hi, T_ - 1) + 1].min(1)
        win[:, w] = np.where(np.isfinite(mv),
                             np.minimum(mv, tb["tone_abs_limit"]),
                             f32(NEGINF))
    flr = tb["ath"][None, :] + st["att"][:, None]
    return np.maximum(flr, win[:, tb["bin_win"]])


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
