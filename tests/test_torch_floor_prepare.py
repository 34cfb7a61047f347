"""The floor fit's prepare (vorbis_tpu_torch/ops/floor_cuda.py:
`floor_prepare`, csrc/floor_prepare.cu; plain version
`DeviceFloorFit.prepare`) on the CPU, at every look the encoders make:
FastEncoder(2, 44100, 0.5) long and short (P = 29 over n = 1,024, 19
over 128), the 5.1 encoder's short and LFE looks (13 over 128, 2 over
12), 16 kHz (19 over 512, 9 over 256), 8 kHz (6 over 256), q -0.1's
long look (29 over 2,048) and the pipeline's (65 over 1,024).

  * The plain prepare's quant, above and used are held bitwise to the
    JAX package's DeviceFloorFit (its jitted fit, quant and above taken
    where it hands them to `_moments`), on chip_smoke.py's
    `_prepare_rows` (seeded spectra, nothing above, everything above,
    nothing used, a saturated mask, NaN and -inf in the mask, NaN and
    +-inf in logmdct, +inf in the mask: XLA's convert saturates it to
    1023, and so does the plain version's `to_int32`).  Its prefix is held to
    JAX's `_moments` within test_torch_floor.py::test_moments_close's
    tolerance, 4 float32 ulp relative, on the seeded rows of the looks
    up to its own (P <= 29, n <= 1,024), the spectra that bound is
    stated for: JAX sums the moments in float32 by a matmul and a cumsum,
    the port exactly and in float64 (ROADMAP §3).  JAX's float32 sums
    drift further over longer windows, more segments and larger moments
    (measured: 5.40 ulp at P = 29 over n = 2,048, 5.53 at the pipeline's
    P = 65, 6.01 on its edge rows, 4.88 on the edge rows at P = 29 over
    n = 1,024), so on every row of every look the prefix is held to JAX
    within 8 ulp: the largest reading with two ulp of room, loose enough
    for JAX's float32 order and tight enough that a moment summed over
    a wrong window (a bin off at either end moves a moment by far more)
    fails.  The replay below, which sums exactly, holds the prefix
    bitwise besides.
  * A numpy replay of the kernel's schedule (quant by a single-rounding
    fma and a saturating truncation, above by one add; a lane a run of
    `bins_a_lane(n)` bins summing the features in uint32 in bin order,
    recording the sums at the look's window edges as it passes them,
    the records raised by the scan of the lanes' totals, a window's
    sums the uint32 difference of its edges; each sum rounded once to
    float32, the weight and the weighted moments one float32 rounding an
    operation; the prefix in float64 in segment order, rounded once) is
    held bitwise to the plain version, and the look's edge table, each
    lane's edges and the launch's geometry are checked at every look.  The cast saturates everywhere: a +inf mask quantizes to
    1023 in JAX, in the replay, on the card and in the plain version
    (torch's own CPU cast would give INT_MIN, clamped to 0).
  * The wrapper takes the plain version on CPU tensors; the managed
    path's three offset_select fits prepare their stacked rows in one
    call, equal to three calls.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from chip_smoke import _prepare_rows
from vorbis_tpu.codec import headers as JH
from vorbis_tpu.codec.floor1_codec import Floor1Look as JLook
from vorbis_tpu.ops.floor_device import DeviceFloorFit as JFit
from vorbis_tpu_torch.codec.encoder import Encoder
from vorbis_tpu_torch.models import encsetup
from vorbis_tpu_torch.ops import floor_cuda
from vorbis_tpu_torch.ops.floor_device import (QUANT_OFFSET, QUANT_SCALE,
                                               DeviceFloorFit)

# one torch thread a pytest-xdist worker (see test_torch_switching.py)
torch.set_num_threads(1)

f32 = np.float32
EPS = np.finfo(np.float32).eps
CONFIGS = ((2, 44100, 0.5), (6, 48000, 0.4), (2, 16000, 0.5),
           (1, 8000, 0.5), (2, 44100, -0.1))


@pytest.fixture(scope="session")
def looks():
    """(P, n) -> the port's Floor1Look, every distinct look of CONFIGS'
    encoders and the pipeline's."""
    from vorbis_tpu_torch.models.pipeline import TorchCodecPipeline
    out = {}
    for args in CONFIGS:
        for lk in Encoder(encsetup.setup_vbr(*args)).floor_looks:
            out.setdefault((lk.posts, lk.n), lk)
    pipe = TorchCodecPipeline(2, 44100, 0.5, device="cpu").floor_fit.look
    out[pipe.posts, pipe.n] = pipe
    return out


LOOKS = [(29, 1024), (19, 128), (13, 128), (2, 12), (19, 512), (9, 256),
         (6, 256), (29, 2048), (65, 1024)]


def test_every_look_is_covered(looks):
    assert sorted(looks) == sorted(LOOKS)


def _jax_prepare(look):
    """The JAX package's fit on the same look, jitted: (quant, above,
    prefix, used) as its __call__ computes them (quant and above where it
    hands them to _moments, prefix what _moments returns)."""
    info = JH.Floor1Info(**dataclasses.asdict(look.info))
    jfit = JFit(JLook(info))

    def run(lm, mk):
        box = {}
        real = jfit._moments

        def spy(quant, above):
            box["qa"] = (quant, above)
            box["m"] = real(quant, above)
            return box["m"]
        jfit._moments = spy
        try:
            _, used = jfit(lm, mk)
        finally:
            del jfit._moments
        return (*box["qa"], box["m"][0], used)
    return jax.jit(run)


def _plain(look, lm, mk):
    fit = DeviceFloorFit(look, "cpu")
    return tuple(t.numpy() for t in fit.prepare(torch.from_numpy(lm),
                                                torch.from_numpy(mk)))


@pytest.mark.parametrize("P,n", LOOKS)
def test_plain_prepare_equals_jax(looks, P, n):
    lm, mk = _prepare_rows(n, 24, 7 * P + n)
    quant, above, prefix, used = _plain(looks[P, n], lm, mk)
    jq, ja, jp, ju = map(np.asarray, _jax_prepare(looks[P, n])(lm, mk))
    assert np.array_equal(quant, jq)
    assert np.array_equal(above, ja)
    assert np.array_equal(used, ju)
    assert not used[24 + 2] and used[:24].all()
    assert prefix.shape == jp.shape == (len(lm), P, 6)
    ulp = np.abs(prefix - jp) / np.maximum(EPS * np.abs(jp), 1e-30)
    if P <= 29 and n <= 1024:
        # test_moments_close's bound, on the spectra it states it for
        assert ulp[:24].max() <= 4
    # every look and every row: JAX's float32 drift, measured up to 6.01
    assert ulp.max() <= 8
    print(f"P={P} n={n}: prefix against JAX's float32 sums, largest "
          f"relative difference {ulp[:24].max():.2f} ulp (seeded rows), "
          f"{ulp[24:].max():.2f} ulp (edge rows)")


def _fma32(a, b, c):
    """float32 a * b + c rounded once (a, b, c float32): the product is
    exact in float64, the sum's error by Knuth's two-sum, and an inexact
    sum whose last bit is even steps one float64 ulp toward the exact
    value (round to odd), so the float32 rounding sees the true sum."""
    p = a.astype(np.float64) * np.float64(b)
    c = np.float64(c)
    with np.errstate(invalid="ignore", over="ignore"):
        s = p + c
        bb = s - p
        e = (p - (s - bb)) + (c - bb)
        bits = s.view(np.int64)
        odd = (e != 0) & ((bits & 1) == 0) & np.isfinite(s)
        step = np.where((e > 0) == (s > 0), 1, -1)
        s = np.where(odd, (bits + step).view(np.float64), s)
        return s.astype(np.float32)


def _cast_sat(x):
    """float32 -> int32 as the card casts: truncate, saturate, NaN 0."""
    with np.errstate(invalid="ignore"):
        out = np.trunc(np.nan_to_num(x.astype(np.float64), nan=0.0,
                                     posinf=2.0 ** 31, neginf=-2.0 ** 31))
    return np.clip(out, -2 ** 31, 2 ** 31 - 1).astype(np.int32)


def _lane_edges(edges, bpl):
    """csrc/floor_prepare.cu: each lane's edges [e0, e1): those in its
    bins [l bpl, (l + 1) bpl), and the last lane's also the edge past
    every lane's bins."""
    x0 = np.arange(32) * bpl
    e0 = (edges[None, :] < x0[:, None]).sum(1)
    e1 = (edges[None, :] < (x0 + bpl)[:, None]).sum(1)
    e1[31] = len(edges)
    return e0, e1


def replay(look, lm, mk):
    """csrc/floor_prepare.cu's schedule in numpy, a warp's row at a time:
    quant and above a lane a 4-bin chunk; the moments a lane a run of
    bins_a_lane(n) bins in uint32, recorded at the look's window edges
    (floor_cuda.prepare_table) as the lane passes them, the records
    raised by a scan of the lanes' totals, a window's sums the uint32
    difference of its two edges; a lane a segment's weight and moments
    in float32; six lanes' prefix in float64 in segment order."""
    fit = DeviceFloorFit(look, "cpu")
    B, n = lm.shape
    P, S = fit.posts, fit.posts - 1
    tw, atten = f32(fit.tw), f32(fit.twofitatten)
    tab = floor_cuda.prepare_table(fit.seg_lo, fit.seg_hi)
    nE = len(tab) - 2 * S
    edges, lo_e, hi_e = tab[:nE], tab[nE:nE + S], tab[nE + S:]
    bpl = floor_cuda.bins_a_lane(n)
    e0, e1 = _lane_edges(edges, bpl)
    # quant and above: a lane a 4-bin chunk, elementwise
    quant = np.clip(_cast_sat(_fma32(mk, QUANT_SCALE, QUANT_OFFSET)), 0,
                    1023)
    with np.errstate(invalid="ignore"):
        above = (lm + atten).astype(np.float32) >= mk
    prefix = np.zeros((B, P, 6), np.float32)
    used = np.zeros(B, bool)
    x = np.arange(32 * bpl).reshape(32, bpl)        # lane, its j-th bin
    inrow = x < n
    xc = np.minimum(x, n - 1)
    for r in range(B):
        q = np.where(inrow, quant[r][xc], 0).astype(np.uint32)
        up = np.where(inrow, above[r][xc], False)
        u = q != 0
        ux = x.astype(np.uint32)
        f = np.stack([ux, q, ux * ux, q * q, ux * q,
                      np.ones_like(ux)])                # (6, 32, bpl)
        T = np.where(u, f, np.uint32(0))
        A = np.where(u & up, f, np.uint32(0))
        run = np.concatenate([T, A])                    # (12, 32, bpl)
        # the sums before each bin, and the lane's total past its last
        before = np.concatenate(
            [np.zeros((12, 32, 1), np.uint32),
             np.cumsum(run, 2, dtype=np.uint32)], 2)    # (12, 32, bpl+1)
        ex = np.concatenate([np.zeros((12, 1), np.uint32), np.cumsum(
            before[:, :, -1], 1, dtype=np.uint32)[:, :-1]], 1)
        rec = np.zeros((nE, 12), np.uint32)
        for lane in range(32):
            for e in range(e0[lane], e1[lane]):
                j = edges[e] - lane * bpl
                assert 0 <= j <= bpl and (j < bpl or lane == 31)
                rec[e] = before[:, lane, j] + ex[:, lane]
        hi, lo = rec[hi_e], rec[lo_e]
        at = hi[:, 6:] - lo[:, 6:]
        a = at.astype(np.float32)                        # __uint2float_rn
        b = (hi[:, :6] - lo[:, :6] - at).astype(np.float32)
        w = f32(1) + ((b[:, 5] + a[:, 5]) * tw) / (a[:, 5] + f32(1))
        wm = b + a * w[:, None].astype(np.float32)
        prefix[r, 1:] = np.cumsum(wm.astype(np.float64), 0).astype(
            np.float32)
        used[r] = (at[:, 5] != 0).any()
    return quant, above, prefix, used


@pytest.mark.parametrize("P,n", LOOKS)
def test_kernel_replay_equals_plain(looks, P, n):
    B = 6 if n >= 1024 else 16
    lm, mk = _prepare_rows(n, B, 3 * P + n)
    got = replay(looks[P, n], lm, mk)
    want = _plain(looks[P, n], lm, mk)
    for name, g, w in zip(("quant", "above", "prefix", "used"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name


@pytest.mark.parametrize("P,n", LOOKS)
def test_prepare_table_and_geometry(looks, P, n):
    """floor_cuda.prepare_table: the sorted distinct edges in [0, n], each
    window [lo, hi) of DeviceFloorFit read back through its two edge
    indices; every edge owned by exactly one lane (the last lane also the
    end of every lane's bins); a warp's shared words fit a block; and a
    window's six sums below 2^32 at the largest n the kernel takes (a
    full row of bins at q = 1023), so the uint32 differences are exact."""
    fit = DeviceFloorFit(looks[P, n], "cpu")
    S = P - 1
    tab = floor_cuda.prepare_table(fit.seg_lo, fit.seg_hi)
    assert tab.dtype == np.int32
    nE = len(tab) - 2 * S
    edges = tab[:nE]
    assert 2 <= nE <= 2 * S and (np.diff(edges) > 0).all()
    assert edges[0] >= 0 and edges[-1] <= n
    assert np.array_equal(edges[tab[nE:nE + S]], fit.seg_lo)
    assert np.array_equal(edges[tab[nE + S:]], fit.seg_hi)
    bpl = floor_cuda.bins_a_lane(n)
    assert bpl % 4 == 0 and 32 * bpl >= n and (bpl == 4 or 32 * (bpl - 4)
                                                < n)
    e0, e1 = _lane_edges(edges, bpl)
    owned = np.concatenate([np.arange(a, b) for a, b in zip(e0, e1)])
    assert np.array_equal(owned, np.arange(nE))
    for B in (1, 512, 4096):
        g = floor_cuda.prepare_geometry(n, P, nE, B, 132)
        assert 1 <= g["wpb"] <= min(floor_cuda.PREPARE_WARPS, -(-B // 132))
        assert g["smem"] <= floor_cuda.PREPARE_SHARED and g["bpl"] == bpl
    m = floor_cuda.PREPARE_MAX_N
    x = np.arange(m, dtype=np.int64)
    assert max(x.sum(), (x * x).sum(), 1023 * m, 1023 ** 2 * m,
               1023 * x.sum(), m) < 2 ** 32


def test_card_cast_saturates(looks):
    """The +inf row: +inf in the mask quantizes to 1023 in the kernel's
    replay (the card's cast saturates), in the plain version (whose cast
    saturates as XLA's does) and in JAX; the row agrees everywhere."""
    lm, mk = _prepare_rows(128, 2, 5)
    row = slice(len(lm) - 1, len(lm))
    got = replay(looks[19, 128], lm[row], mk[row])
    want = _plain(looks[19, 128], lm[row], mk[row])
    jq = np.asarray(_jax_prepare(looks[19, 128])(lm[row], mk[row])[0])
    inf = np.isposinf(mk[row])
    assert inf.any()
    assert (got[0][inf] == 1023).all() and (want[0][inf] == 1023).all()
    assert np.array_equal(jq, want[0])
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8))


def test_cpu_wrapper_and_managed_stack(looks):
    """floor_prepare on CPU tensors is the plain version and launches
    nothing; ops/managed.py floor3 prepares the three masks' stacked rows
    in one call, equal to three fits."""
    from vorbis_tpu_torch.ops import managed
    look = looks[29, 1024]
    fit = DeviceFloorFit(look, "cpu")
    lm, mk = (torch.from_numpy(a) for a in _prepare_rows(1024, 8, 9))
    before = floor_cuda.floor_prepare.launches
    got = floor_cuda.floor_prepare(fit, lm, mk)
    want = fit.prepare(lm, mk)
    assert floor_cuda.floor_prepare.launches == before
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    masks = [mk, mk - 6.0, mk - 3.0]
    calls = []
    real = fit.prepare
    fit.prepare = lambda *a: calls.append(a) or real(*a)
    try:
        ps, us = managed.floor3(fit, lm, masks)
    finally:
        del fit.prepare
    assert len(calls) == 1 and calls[0][0].shape[0] == 3 * lm.shape[0]
    for m, p, u in zip(masks, ps, us):
        wp, wu = fit(lm, m)
        assert torch.equal(p, wp) and torch.equal(u, wu)
