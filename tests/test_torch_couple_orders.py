"""The partition sums' order at the sites outside the stereo pair's
kernel (vorbis_tpu_torch/ops/xla_f32.py `SUM_LANES`), against vorbis_tpu
on the CPU: the 5.1 chained coupling's M6 and normalize (`_couple_multi`,
jitted) and the uncoupled branch's normalize (`finish_from_posts`,
jitted whole).  XLA:CPU's fusion decides each site's order, so each is
held where the JAX package runs it, on rows whose decision turns on the
order (tests/couple_cases.py `_straddle`).

Tolerance: none; outputs and packets bitwise (measured: every row equal,
and a wrong order moves some of them).
"""

import numpy as np
import pytest
import torch

import jax

from tests import couple_cases as CC
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import xla_f32
from vorbis_tpu_torch.ops.floor_encode_cuda import floor_encode

# one torch thread a pytest-xdist worker (see test_torch_couple.py)
torch.set_num_threads(1)

f32 = np.float32
F = 24


def _moved(site, part, run, want):
    """Rows of run() that differ from `want` with the site's lanes set to
    each other order: some must (the rows sit on the order's edge)."""
    keep = xla_f32.SUM_LANES[site, part]
    moved = 0
    try:
        for lanes in (1, 2, 8, 16):
            if lanes == keep or lanes > part:
                continue
            xla_f32.SUM_LANES[site, part] = lanes
            moved = max(moved, int((run() != want).reshape(F, -1)
                                   .any(1).sum()))
    finally:
        xla_f32.SUM_LANES[site, part] = keep
    return moved


def _multi(jd, td, md, kw):
    ks = sorted(kw)
    used = np.ones(md.shape[:2], bool)
    cur = np.ones_like(md)
    want = np.asarray(jax.jit(lambda a, b, c, *r: jd._couple_multi(
        a, b, c, F, **dict(zip(ks, r)))[0])(md, cur, used,
                                             *[kw[k] for k in ks]))

    def run():
        return td._couple_multi(
            torch.from_numpy(md), torch.from_numpy(cur),
            torch.from_numpy(used), F,
            **{k: torch.from_numpy(v) for k, v in kw.items()})[0].numpy()
    return run, want


@pytest.fixture(scope="module")
def q04():
    return JFE(6, 48000, 0.4), TFE(6, 48000, 0.4, device="cpu")


@pytest.fixture(scope="module")
def q02():
    return JFE(6, 48000, 0.2), TFE(6, 48000, 0.2, device="cpu")


@pytest.mark.parametrize("W", [1, 0])
def test_multi_m6_order(q04, W):
    """M6's imbalance sums on 32.0 (8.0) at the first chained step
    (channels 0 and 2): 8 lanes at 32 values, left to right at 8."""
    jfe, tfe = q04
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    cfg = CC.config(td)
    P = cfg["part"]
    p0 = CC.m6_partition(cfg)
    rng = np.random.RandomState(60 + W)
    md = np.zeros((F, 5, cfg["n2"]), f32)
    for f in range(F):
        md[f, 0, p0:p0 + P] = CC._straddle(
            rng, P, lambda m: m, 0.55, 1.45, [float(P)],
            lambda s: bool(s > P), xla_f32.SUM_LANES["m6", P])
    run, want = _multi(jd, td, md, {"epeak": np.zeros_like(md)})
    assert np.array_equal(run(), want)
    promoted = (want[:, 2, p0:p0 + P] != 0).any(1)
    assert 0 < promoted.sum() < F
    assert _moved("m6", P, run, want) > 0


def _ve4(m):
    """ve of channel 0's bin at the last chained step (0, 3), the other
    channels 0 and every curve 1: the signed energy folded at (0, 2),
    (0, 1) and (0, 3), each fold times 0.94, over the summed floor
    energies 5."""
    h = f32(m * m)
    for _ in range(3):
        h = f32(h * f32(0.94))
    return f32(h / f32(5.0))


@pytest.mark.parametrize("W", [1, 0])
def test_multi_normalize_order(q02, W):
    """The chained coupling's normalize budget on its edges at the last
    step: 8 lanes at 32 values and 8 lanes folded at 8."""
    jfe, tfe = q02
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    cfg = CC.config(td)
    P = cfg["part"]
    lim = max(cfg["limit"], cfg["start"])
    p0 = [p * P for p in range(cfg["n2"] // P)
          if p * P >= lim and (cfg["thr1"][p * P:(p + 1) * P] > 1.2).all()][0]
    th = float(cfg["thresh"])
    bounds = [th + k for k in range(P // 4)] + list(range(1, P // 4))
    rng = np.random.RandomState(70 + W)
    md = np.zeros((F, 5, cfg["n2"]), f32)
    for f in range(F):
        md[f, 0, p0:p0 + P] = CC._straddle(
            rng, P, _ve4, 0.1, 1.2, bounds, CC.normalize_decision(cfg),
            xla_f32.SUM_LANES["normalize_multi", P])
    kw = {"epeak": np.zeros_like(md),
          "npeak": np.zeros((F, 5, cfg["n2"] // P), f32)}
    run, want = _multi(jd, td, md, kw)
    assert np.array_equal(run(), want)
    assert (want[:, 0] != 0).any()
    assert _moved("normalize_multi", P, run, want) > 0


@pytest.fixture(scope="module")
def mono():
    return (JFE(1, 44100, 0.2, coupling=False),
            TFE(1, 44100, 0.2, coupling=False, device="cpu"))


@pytest.mark.parametrize("W", [1, 0])
def test_uncoupled_normalize_order(mono, W):
    """The uncoupled branch of the jitted finish_from_posts sums the
    normalize budget left to right, at 32 values and at 8: the packets
    of straddling rows equal JAX's."""
    jfe, tfe = mono
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    assert td.res_type != 2 and td.ctx.normal["thresh"] < 1
    n2, P = td.n // 2, td.ctx.normal["partition"]
    rng = np.random.RandomState(80 + W)
    lg = torch.from_numpy((rng.randn(F, n2) * 3 - 40).astype(f32))
    posts, used = td.ctx.floor(lg, torch.full((F, n2), -90.0))
    curve = floor_encode(td, posts, used)[0].numpy()
    cfg = dict(thresh=f32(td.ctx.normal["thresh"]))
    th = float(cfg["thresh"])
    bounds = [th + k for k in range(P // 4)] + list(range(1, P // 4))
    p0 = -(-td.ctx.normal["start"] // P) * P + P
    md = np.zeros((F, n2), f32)
    for f in range(F):
        c = curve[f, p0:p0 + P]

        def vef(m, c=c):
            r = f32(f32(m * c) / c)
            return f32(r * r)
        m = CC._straddle(rng, P, vef, 0.05, 0.45, bounds,
                         CC.normalize_decision(cfg),
                         xla_f32.SUM_LANES["normalize_uncoupled", P])
        md[f, p0:p0 + P] = f32(m * c)
    wb = td.plan.wb
    pk, nb = jax.jit(lambda a, b, c: jd.finish_from_posts(a, b, c, F, wb))(
        md, posts.numpy(), used.numpy())
    want = np.concatenate([np.asarray(pk), np.asarray(nb)[:, None]
                           .view(np.uint8)], 1)

    def run():
        p, n = td.finish_from_posts(torch.from_numpy(md), posts, used, F, wb)
        return np.concatenate([p.numpy(), n.numpy()[:, None].view(np.uint8)],
                              1)
    assert np.array_equal(run(), want)
    assert _moved("normalize_uncoupled", P, run, want) > 0
