"""The stereo coupling (vorbis_tpu_torch/ops/couple_cuda.py, its plain
version and the schedule of csrc/couple_quantize.cu) against vorbis_tpu's
jitted `_couple_quantize`, `_m6_promote` and `_normalize_promote`, both
on the CPU.

The partition sums.  M6's mean imbalance (against rdef > 1) and the
normalize budget (against floor(acc - thresh) and acc's truncation)
are float sums whose order decides integers.  XLA:CPU's order is its
fusion's (ops/xla_f32.py `SUM_LANES`): a 32-value partition in 8 lanes
(M6; the normalize after M6) or 16 (the normalize alone), folded in
halves; an 8-value one left to right (M6, the normalize alone) or in
8 lanes folded (the normalize after M6); a padded row left to right.
torch's own CPU sum, the port's order before, agrees with XLA on about
half of random 32-value partitions.  The fault's rows sit on those
edges: every row's partition decides one way in XLA's order and the
other way in at least one other order (torch's, where one could be
found), so each row fails a wrong order.  The direct jitted
`_normalize_promote` sums left to right (its own fusion), so the
normalize's rows are held inside the jitted coupling, where the
finish runs them.

Tolerance: none.  The plain version runs the JAX package's float
operations one by one, so every residue and flag is compared bitwise
(measured: 0 differing values on every case below).
"""

import numpy as np
import pytest
import torch

import jax

from tests import couple_cases as CC
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu.ops import managed as JM
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import xla_f32
from vorbis_tpu_torch.ops.couple_cuda import (couple_quantize,
                                              couple_quantize_plain)

# The suite runs under pytest-xdist with several workers to the host's
# cores; one torch thread a worker keeps torch's OpenMP pools from
# oversubscribing them.
torch.set_num_threads(1)

F = 16
ABR = (-1, 128000, -1)


@pytest.fixture(scope="module")
def q05():
    return JFE(2, 44100, 0.5), TFE(2, 44100, 0.5, device="cpu")


@pytest.fixture(scope="module")
def q02():
    return JFE(2, 44100, 0.2), TFE(2, 44100, 0.2, device="cpu")


def _jax_couple(jd, case):
    """The JAX package's coupling of a case, with finish_from_posts'
    lowpass and interleave: (res (F, 2 n2), any_used (F,))."""
    F_ = case["F"]
    md = np.asarray(case["md"], np.float32)
    n2 = md.shape[-1]
    if case.get("lowpass") is not None:
        md = np.where(np.arange(n2)[None] < case["lowpass"][:, None], md,
                      np.float32(0))
    kw = {}
    for k in ("thr1", "threv", "inlimit"):
        if case.get(k) is not None:
            t = np.asarray(case[k])
            kw[k] = t[np.arange(F_) % t.shape[0]][:, :n2]
    for k in ("epeak", "npeak"):
        if case.get(k) is not None:
            kw[k] = case[k]
    keys = sorted(kw)
    out2, anyu = jax.jit(lambda a, b, c, *r: jd._couple_quantize(
        a, b, c, F_, **dict(zip(keys, r))))(
        md, case["curve"], case["used"], *[kw[k] for k in keys])
    out2 = np.asarray(out2)
    return out2.transpose(0, 2, 1).reshape(F_, -1), np.asarray(anyu)


def _port(td, case, fn=couple_quantize):
    tc = CC.torch_case(case)
    r, u = fn(td, tc.pop("md"), tc.pop("curve"), tc.pop("used"),
              tc.pop("F"), **tc)
    return r.numpy(), u.numpy()


def _bitwise(got, want):
    """Rows of (res, any_used) that differ in any bit."""
    (r, u), (rw, uw) = got, want
    assert r.shape == rw.shape and r.dtype == rw.dtype == np.float32
    bad = (r.view(np.int32) != rw.view(np.int32)).any(1) | (u != uw)
    return int(bad.sum())


def _parent_sum(x, part):
    """The order before the repair: torch's CPU sum of each partition."""
    return x.reshape(x.shape[:-1] + (-1, part)).sum(-1)


# ---------------------------------------------------------------------------
# the summation orders

@pytest.mark.parametrize("part", [8, 32])
def test_partition_sum_lanes(part):
    rng = np.random.RandomState(part)
    x = (rng.rand(64, 4 * part) * 3).astype(np.float32)
    for lanes in (1, 2, 8, 16):
        if lanes > part:
            continue
        got = xla_f32.partition_sum(torch.from_numpy(x), part, lanes)
        want = [[CC.lanes_sum(x[r, p * part:(p + 1) * part], lanes)
                 for p in range(4)] for r in range(64)]
        assert np.array_equal(got.numpy(), np.asarray(want, np.float32))
    with pytest.raises(ValueError):
        xla_f32.partition_sum(torch.from_numpy(x), part, 3)
    with pytest.raises(ValueError):
        xla_f32.part_sum(torch.from_numpy(x), 16, "m6")


# ---------------------------------------------------------------------------
# the fault's rows

@pytest.mark.parametrize("W", [1, 0])
def test_m6_promote_straddling_rows_equal_jax(q05, W):
    """64 partitions whose 32 (8) imbalances sum across 32.0 (8.0) in
    one order and not another: the plain _m6_promote equals the jitted
    one on every row; torch's sum, the order before the repair, decides
    some of them otherwise."""
    jfe, tfe = q05
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    cfg = CC.config(td)
    P = cfg["part"]
    case, p0, rows = CC.m6_rows(cfg, 64, seed=10 + W)
    rM = case["md"][0::2]
    z = np.zeros_like(rM)
    flag = np.ones(rM.shape, bool)
    args = (rM, z, rM * rM, z, flag)
    want = np.asarray(jax.jit(lambda *a: jd._m6_promote(*a, 64))(*args))
    got = td._m6_promote(*map(torch.from_numpy, args), 64).numpy()
    assert np.array_equal(got, want)
    promoted = want[:, p0]
    assert 0 < promoted.sum() < 64
    parent = _parent_sum(torch.from_numpy(rows), P).numpy()[:, 0] > P
    print(f"M6 {P}-bin rows: {int(promoted.sum())} of 64 promoted; the "
          f"parent's torch sum decides {int((parent != promoted).sum())} "
          f"otherwise")
    if P == 32:
        assert (parent != promoted).sum() >= 16


@pytest.mark.parametrize("W", [1, 0])
@pytest.mark.parametrize("pad", [False, True])
def test_m6_rows_in_the_coupling_equal_jax(q05, W, pad):
    """The same edge inside the jitted _couple_quantize, whose fusion
    sums a padded row (n2 not a multiple of the partition) left to
    right."""
    jfe, tfe = q05
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    cfg = CC.config(td)
    case, p0, rows = CC.m6_rows(cfg, F, seed=20 + W,
                                pad=cfg["part"] // 4 if pad else 0)
    want = _jax_couple(jd, case)
    assert _bitwise(_port(td, case), want) == 0
    # the edge shows: some rows promote the partition's -1 bins
    ang = want[0][:, 1::2][:, p0:p0 + cfg["part"]]
    flagged = (rows > 0.5) & (rows < 1)
    assert 0 < ((ang != 0) & flagged).any(1).sum() < F


@pytest.mark.parametrize("W", [1, 0])
@pytest.mark.parametrize("kind", ["alone", "npeak", "m6", "m6_npeak", "pad"])
def test_normalize_rows_in_the_coupling_equal_jax(q02, W, kind):
    """Partitions whose candidates' energies sum across thresh + k or an
    integer k in one order and not another, with the normalize alone,
    with the M8 store, after M6 (epeak given) and on a padded row."""
    jfe, tfe = q02
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    cfg = CC.config(td)
    assert cfg["normalize"]
    case, p0, _ = CC.normalize_rows(
        cfg, F, seed=30 + W, pad=4 if kind == "pad" else 0,
        epeak=kind.startswith("m6"), npeak=kind.endswith("npeak"))
    want = _jax_couple(jd, case)
    assert _bitwise(_port(td, case), want) == 0
    assert (want[0][:, 0::2] != 0).sum() > 0


def test_normalize_promote_straddling_rows_equal_jax(q02):
    """_normalize_promote on the fault's energies at the site whose order
    the direct jitted call takes (left to right: the uncoupled
    branch's), and the coupled sites' orders deciding otherwise on some
    rows."""
    jfe, tfe = q02
    jd, td = jfe._dev_for(1), tfe._dev_for(1)
    cfg = CC.config(td)
    case, p0, rows = CC.normalize_rows(cfg, 64, seed=40)
    ve = np.zeros((64, cfg["n2"]), np.float32)
    ve[:, p0:p0 + cfg["part"]] = CC.ve_of(rows)
    out = np.zeros_like(ve)
    args = (out, ve, ve * 2, ve > 0, np.ones_like(ve))
    want = np.asarray(jax.jit(lambda *a: jd._normalize_promote(*a))(*args))
    ta = [torch.from_numpy(a) for a in args]
    got = td._normalize_promote(*ta, site="normalize_uncoupled").numpy()
    assert np.array_equal(got, want)
    other = td._normalize_promote(*ta, site="normalize").numpy()
    assert (other != want).any(1).sum() > 0


# ---------------------------------------------------------------------------
# the plain version against JAX, and the kernel's schedule

def _cases(cfg, tm=None):
    """name -> case: the seeded rows of each kind this config runs."""
    out = {"stateless": CC.seeded(cfg, F, 1),
           "epeak": CC.seeded(cfg, F, 2, epeak=True),
           "epeak_npeak": CC.seeded(cfg, F, 3, epeak=True, npeak=True),
           "npeak": CC.seeded(cfg, F, 4, npeak=True)}
    if tm is not None:
        c = CC.seeded(cfg, 30, 5, epeak=True, npeak=True, lowpass=True)
        c.update(thr1=tm.thr1_15, threv=tm.threv_15,
                 inlimit=tm.inlimit_15)
        out["managed"] = c
    return out


@pytest.mark.parametrize("q,W", [(0.5, 1), (0.5, 0), (0.2, 1), (0.2, 0)])
def test_couple_quantize_plain_equals_jax(q05, q02, q, W):
    """couple_quantize_plain against the jitted _couple_quantize with
    finish_from_posts' lowpass and interleave: n2 = 1,024 and 128, with
    and without the M9 and M8 stores, unused channels and frames, equal
    energies; the kernel's schedule in numpy equals the plain version on
    the same rows."""
    jfe, tfe = q05 if q == 0.5 else q02
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    cfg = CC.config(td)
    for name, case in _cases(cfg).items():
        want = _jax_couple(jd, case)
        got = _port(td, case, couple_quantize_plain)
        assert _bitwise(got, want) == 0, name
        assert _bitwise(CC.replay(cfg, case), want) == 0, name
        assert not want[1][3] and want[1][1] and want[1][2], name
        assert (want[0][3] == 0).all(), name


@pytest.fixture(scope="module")
def managed():
    jfe = JFE(2, 44100, bitrate=ABR)
    tfe = TFE(2, 44100, bitrate=ABR, device="cpu")
    return jfe, tfe


@pytest.mark.parametrize("W", [1, 0])
def test_managed_rows_equal_jax(managed, W):
    """The managed pass's per-row coupling: 30 frames reading the 15
    blobs' thr1, threv and inlimit rows by frame % 15, each row's
    lowpass, the M9 and M8 stores; blob_rows passes the (15, n2) tables
    as they are."""
    jfe, tfe = managed
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    tm = tfe._managed_dev_for(W)
    jm = JM.DeviceManagedEncode(jfe, W=W)
    assert np.array_equal(tm.thr1_15, jm.thr1_15)
    cfg = CC.config(td)
    case = _cases(cfg, tm)["managed"]
    want = _jax_couple(jd, case)
    assert _bitwise(_port(td, case, couple_quantize_plain), want) == 0
    assert _bitwise(CC.replay(cfg, case), want) == 0
    _, kw = tm.blob_rows(1, torch.zeros((2, cfg["n2"])))
    assert kw["thr1"].shape == (15, cfg["n2"])
    assert kw["inlimit"].dtype == torch.bool


def test_replay_on_the_fault_rows(q05, q02):
    """The kernel's schedule on the straddling rows (padded too)."""
    for (jfe, tfe), build in ((q05, CC.m6_rows), (q02, CC.normalize_rows)):
        for W in (1, 0):
            td = tfe._dev_for(W)
            cfg = CC.config(td)
            for pad in (0, cfg["part"] // 4):
                kw = dict(epeak=True) if build is CC.normalize_rows else {}
                case = build(cfg, 8, 50 + W + pad, pad=pad, **kw)[0]
                assert _bitwise(CC.replay(cfg, case),
                                _port(td, case, couple_quantize_plain)) == 0


def test_wrapper_takes_the_plain_version_on_the_cpu(q05):
    _, tfe = q05
    td = tfe._dev_for(1)
    case = CC.seeded(CC.config(td), 4, 6, epeak=True)
    n0 = couple_quantize.launches
    assert _bitwise(_port(td, case), _port(td, case,
                                           couple_quantize_plain)) == 0
    assert couple_quantize.launches == n0
