"""The M3 tempmdct scan's segment schedule (vorbis_tpu_torch/csrc/m3_scan.cu)
held to the port's plain `m3_tempmdct_scan` on the CPU, by bit pattern.

The kernel cannot run here, so its algorithm is emulated in numpy
(`_emulate`, this file only): the batch split at frames with sw and reset
into segments that each start from a zero carry, and per frame the
spread's compares counted against the pre-update buffer, then the count's
increments added one by one in float32, from the same static table the
kernel gets (`ops/m3_cuda.py` `spread_table`).  Every case must give the
plain version's float32 bit patterns exactly (0 differing values,
measured and asserted), signed zeros included; one seeded case is also
held to the JAX package's `m3_tempmdct_scan` (JAX is imported by that
test alone, so the file also runs where only the port is installed).
The card test holds the kernel itself to the plain version on the same
cases.  `m3_case` is the one definition of the cases: `chip_smoke.py`
phase 3b builds the same kinds at F = 256, n = 128 and 256, and checks
the kernel on them on every chip run.
"""

import types

import numpy as np
import pytest
import torch

from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import psydevice as TPD
from vorbis_tpu_torch.ops.m3_cuda import M3ScanCuda, make_m3_scan, \
    spread_table

KEYS = ("sw", "reset", "noise_center")


@pytest.fixture(scope="session", autouse=True)
def one_torch_thread():
    """One torch thread a pytest-xdist worker (see
    test_torch_switching.py); a fixture, so that chip_smoke.py can import
    the cases without it."""
    torch.set_num_threads(1)


@pytest.fixture(scope="session")
def looks():
    """The port's short look (n = 128) and one at n = 256 that shares
    its psy settings (freq_bfn256 drives the n = 256 spread)."""
    look = TFE(2, 44100, 0.5, device="cpu").ctx(0).analysis.look
    return {128: look, 256: types.SimpleNamespace(n=256, m3n=look.m3n,
                                                  vi=look.vi)}


def _seeded(F, n, seed):
    """test_torch_switching.py's seeded inputs: (logmdct, lastmdct rows
    of 1024, val, tval) with M3 triggers firing, and (sw, reset,
    noise_center) from m3_param_seq on a seeded switched sequence."""
    rng = np.random.RandomState(seed)
    lm = (rng.randn(F, 2, n) * 15 - 60).astype(np.float32)
    last = (rng.randn(F, 2, 1024) * 15 - 75).astype(np.float32)
    val = (lm + rng.randn(F, 2, n) * 8 + 6).astype(np.float32)
    tval = (lm + rng.randn(F, 2, n) * 8 - 6).astype(np.float32)
    Ws = np.where(rng.rand(1, F) < 0.7, 0, 1)
    imp = (rng.rand(1, F) < 0.6) & (Ws == 0)
    ann = TPD.annotate_frames_nd(Ws, imp)
    pr = TPD.m3_param_seq({k: v[0] for k, v in ann.items()}, n, 2.0, True)
    return [lm, last, val, tval], {k: np.asarray(pr[k]) for k in KEYS}


def _impulse_run(F, n):
    """m3_param_seq of F impulse short frames in a row: sw throughout, no
    reset, noise_center ramping as the run grows."""
    ann = TPD.annotate_frames_nd(np.zeros((1, F), int),
                                 np.ones((1, F), bool))
    pr = TPD.m3_param_seq({k: v[0] for k, v in ann.items()}, n, 2.0, True)
    return {k: np.asarray(pr[k]) for k in KEYS}


# the kinds of case m3_case builds; all but "seeded" are the segment
# schedule's edge cases
KINDS = ("seeded", "chain", "reset_every_impulse", "no_sw", "reset_off_sw",
         "mid_run", "signed_zero")


def m3_case(kind, n, F):
    """([logmdct, lastmdct, val, tval], params) of a kind of case at n
    bins and F frames, as numpy arrays."""
    if kind == "seeded":
        return _seeded(F, n, F + n)
    if kind == "chain":
        # one segment: every frame impulse, no reset, carry from zero
        args, _ = _seeded(F, n, 11)
        return args, _impulse_run(F, n)
    args, pr = _seeded(F, n, 12)
    rng = np.random.RandomState(13)
    if kind == "reset_every_impulse":
        pr["reset"] = pr["sw"].copy()
    elif kind == "no_sw":
        # reset without sw passes the carry through: no segment starts
        pr["sw"] = np.zeros_like(pr["sw"])
        pr["reset"] = rng.rand(F) < 0.5
        pr["noise_center"] = np.zeros_like(pr["noise_center"])
    elif kind == "reset_off_sw":
        # reset flags on frames without sw: they pass the carry through
        # and split nothing
        pr["reset"] = pr["reset"] | (~pr["sw"] & (rng.rand(F) < 0.5))
    elif kind == "mid_run":
        # the batch opens inside a run of impulse frames: carry zero
        pr["sw"][:4] = True
        pr["reset"][:4] = False
        pr["noise_center"][:4] = np.float32(9.0)
    elif kind == "signed_zero":
        # triggers on logmdct = -0.0: the buffer becomes -0.0, and the
        # next frame's tm = -0.0 - base
        lm, last, val, tval = args
        lm[:, :, ::2] = np.float32(-0.0)
        last[:] = np.float32(-100.0)
        val[:] = np.float32(10.0)
        tval[:] = np.float32(0.0)
        pr = _impulse_run(F, n)
        pr["reset"][0] = True
    else:
        raise ValueError(f"no m3 case {kind!r}")
    return args, pr


# the CPU cases: name -> (kind, n, F)
CASES = {"seeded_1_128": ("seeded", 128, 1),
         "seeded_3_128": ("seeded", 128, 3),
         "seeded_64_128": ("seeded", 128, 64),
         "seeded_256_128": ("seeded", 128, 256),
         "seeded_16_256": ("seeded", 256, 16),
         "chain": ("chain", 128, 256),
         "chain_n256": ("chain", 256, 64),
         "reset_every_impulse": ("reset_every_impulse", 128, 256),
         "no_sw": ("no_sw", 128, 256),
         "reset_off_sw": ("reset_off_sw", 128, 256),
         "mid_run": ("mid_run", 128, 256),
         "signed_zero": ("signed_zero", 128, 8)}


def _case(name):
    """(n, [logmdct, lastmdct, val, tval], params) of a named case."""
    kind, n, F = CASES[name]
    return (n,) + m3_case(kind, n, F)


def _segments(pr):
    """Frames that start a segment: frame 0 and every frame with sw and
    reset."""
    F = len(pr["sw"])
    return [0] + [f for f in range(1, F)
                  if pr["sw"][f] and pr["reset"][f]]


def _emulate(table, base, args, pr):
    """The kernel's schedule in numpy float32: independent segments
    (reset read at a segment's first frame only: a later frame with sw
    and reset starts the next one), and per frame compare, count, then
    add."""
    lm, last, val, tval = args
    F, ch, n = lm.shape
    J = table.shape[0] - 1
    thr, incr = table[:J], table[J]
    base = np.float32(base)
    sw, reset, ncen = (pr[k] for k in KEYS)
    out = np.empty((F, ch, n), np.float32)
    starts = _segments(pr)
    for s, e in zip(starts, starts[1:] + [F]):
        carry = np.zeros((ch, n), np.float32)
        for f in range(s, e):
            if sw[f]:
                lastf = last[f, :, :n]
                tm = (lastf if f == s and reset[f] else carry) - base
                row = np.concatenate([np.zeros((ch, J), np.float32),
                                      lm[f]], -1)
                k = np.zeros((ch, n), np.int64)
                for j in range(1, J + 1):
                    k += tm < row[:, J - j:J - j + n] - thr[j - 1]
                for q in range(int(k.max(initial=0))):
                    tm = np.where(k > q, tm + incr, tm)
                trig = ((val[f] > tval[f]) & (val[f] > lastf)
                        & (lm[f] > tm + np.float32(ncen[f])))
                carry = np.where(trig, lm[f], tm)
            out[f] = carry
    return out


def _plain(look, args, pr):
    prm = {k: torch.from_numpy(np.array(v)) for k, v in pr.items()}
    return make_m3_scan(look, "cpu")(*map(torch.from_numpy, args),
                                     prm).numpy()


@pytest.fixture(scope="session")
def tables(looks):
    return {n: (spread_table(lk), TPD.m3_tables(lk)[3])
            for n, lk in looks.items()}


@pytest.mark.parametrize("name", CASES)
def test_segment_schedule_equals_plain_bitwise(looks, tables, name):
    n, args, pr = _case(name)
    want = _plain(looks[n], args, pr)
    got = _emulate(*tables[n], args, pr)
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    F = len(pr["sw"])
    segs = _segments(pr)
    if name in ("chain", "chain_n256", "no_sw"):
        assert segs == [0]
    if name == "reset_every_impulse":
        assert len(segs) == 1 + int(pr["sw"][1:].sum()) > F // 4
    if name == "mid_run":
        assert pr["sw"][0] and not pr["reset"][0] and len(segs) > 10
    if name == "no_sw":
        assert not want.any() and pr["reset"].any()
    if name == "reset_off_sw":
        # a carried buffer crosses a reset frame without sw
        off = np.flatnonzero(pr["reset"] & ~pr["sw"])
        assert want[off[off > 0] - 1].any()
    if name == "signed_zero":
        negz = (want == 0) & np.signbit(want)
        assert negz.any() and negz[1:].any()
    if F > 3 and name != "no_sw":
        assert (want == args[0]).any()   # triggers fired


def test_segment_schedule_equals_jax(looks, tables):
    jax = pytest.importorskip("jax")
    from vorbis_tpu.ops import psydevice as JPD
    n, args, pr = _case("seeded_64_128")
    want = np.asarray(jax.jit(lambda *a: JPD.m3_tempmdct_scan(
        looks[n], *a[:4], dict(zip(KEYS, a[4:]))))(
            *args, *(pr[k] for k in KEYS)))
    got = _emulate(*tables[n], args, pr)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert len(_segments(pr)) > 5


@pytest.mark.parametrize("n", [128, 256])
def test_spread_table_is_the_plain_versions(looks, n):
    """Row j - 1 of the kernel's table is m3_cellj[j - 1] shifted to its
    target bin where m3_jlt holds (and j <= t), +inf elsewhere; the
    last row is incr; maxnb - 1 rows of shifts (24 and 50)."""
    bfn, cell, incr, _ = TPD.m3_tables(looks[n])
    tab = spread_table(looks[n])
    J = int(bfn.max()) - 1
    assert tab.dtype == np.float32 and tab.shape == (J + 1, n)
    assert J == {128: 24, 256: 50}[n]
    assert np.array_equal(tab[J], incr)
    for j in range(1, J + 1):
        cellj = (cell * np.float32(j)).astype(np.float32)
        row = np.full(n, np.inf, np.float32)
        ok = j < bfn[:n - j]
        row[j:][ok] = cellj[:n - j][ok]
        assert np.array_equal(tab[j - 1], row), j


def test_omitted_zero_adds_change_no_bit():
    """The kernel skips the spread's +0.0 adds.  x + 0.0 == x bit for bit
    unless x is -0.0, and the buffer never is: tm = x - base (base 5 or
    10) and tm + incr (incr > 0) are never -0.0 in round-to-nearest, for
    special values and for 2^20 random bit patterns."""
    rng = np.random.RandomState(0)
    bits = rng.randint(-2**31, 2**31 - 1, size=2**20, dtype=np.int64)
    x = np.concatenate([
        bits.astype(np.int32).view(np.float32),
        np.array([0.0, -0.0, 5.0, -5.0, 10.0, -10.0, np.inf, -np.inf,
                  1e-45, -1e-45, np.finfo(np.float32).max,
                  np.nextafter(np.float32(5), np.float32(6))],
                 np.float32)])
    with np.errstate(invalid="ignore", over="ignore"):
        for base in (np.float32(5.0), np.float32(10.0)):
            tm = x - base
            assert not ((tm == 0) & np.signbit(tm)).any()
            for incr in (np.float32(0.2), base):
                up = tm + incr
                assert not ((up == 0) & np.signbit(up)).any()
                ok = ~np.isnan(tm)
                assert np.array_equal((tm + np.float32(0.0))[ok]
                                      .view(np.int32), tm[ok].view(np.int32))


@pytest.mark.cuda
def test_m3_scan_cases_on_cuda(looks):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    for name in CASES:
        n, args, pr = _case(name)
        scan = M3ScanCuda(looks[n], "cuda")
        ta = [torch.from_numpy(a).cuda() for a in args]
        tp = {k: torch.from_numpy(np.array(v)).cuda() for k, v in pr.items()}
        got = scan(*ta, tp)
        want = scan.plain(*ta, tp)
        torch.cuda.synchronize()
        assert scan.launches == 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            name
