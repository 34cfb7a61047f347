"""The port's analysis spine (vorbis_tpu_torch/ops/torchdsp.py,
ops/mdct.py, utils/scales.py) against vorbis_tpu/ops/jaxdsp.py, both on
the CPU, on the same numpy inputs.

Tolerances, as measured on this comparison and why they hold:
  * todB / unitnorm: bitwise against the numpy reference.  XLA:CPU
    contracts todB's `u * scale - bias` into an FMA, so JAX's
    log_spectrum sits up to 2 ulp (6.1e-5 dB measured) off numpy and
    the port.
  * MDCT: the port multiplies by the dense basis, JAX runs the
    butterfly; they agree to 2.2e-7 of the spectrum's peak (1e-6
    asserted).  Near-zero bins differ relatively, so logmdct of the
    whole chain is compared only where |mdct| > 1e-4 of the peak.
  * bark_fit on the same input: float reassociation (cumsum order, FMA)
    through the least-squares cancellation: 0.0087 dB (offset 140) and
    0.043 dB (offset 0) max measured; 0.1 dB max asserted, 0.01 dB at
    the 99th percentile.
  * tone mask on the same input: max/min/gather plus the same adds in
    the same order -> bitwise.
  * full chain (frames -> mask): the floor quantizes the mask as
    int(mask * 7.31 + 1023.5); measured 452 of 65536 quanta (0.7%) flip,
    10 of them (0.015%) by more than one quantum, where a near-zero MDCT
    line moves an M4/M1 decision; 1.5% and 0.05% asserted, and the
    99.9th percentile of |mask diff| (0.0064 dB measured) < 0.05 dB.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import oracle
from vorbis_tpu.models import encsetup
from vorbis_tpu.ops import jaxdsp as J
from vorbis_tpu.ops.mdct import mdct_forward
from vorbis_tpu.utils import scales as S
from vorbis_tpu_torch.ops import torchdsp as T
from vorbis_tpu_torch.utils import scales as TS

# The suite runs under pytest-xdist with several workers to the host's
# cores; one torch thread a worker keeps torch's OpenMP pools from
# oversubscribing them (the port's test files took 672 s with 6 workers
# on 8 cores at torch's default, 70 s at one thread).
torch.set_num_threads(1)

N = 2048
HOP = 1024


@pytest.fixture(scope="module")
def pair():
    setup = encsetup.setup_vbr_staged(2, 44100, 0.5).init()
    ja = J.DeviceAnalysis(setup, blocktype=3, rate=44100, W=1)
    ta = T.DeviceAnalysis(setup, blocktype=3, rate=44100, W=1,
                          device="cpu")
    return ja, ta


@pytest.fixture(scope="module")
def frames():
    """32 stereo frames (64 rows) of the oracle test signal."""
    pcm = oracle.make_test_signal(seconds=1.0)
    x = np.concatenate([np.zeros((2, HOP), np.float32), pcm], 1)
    fr = np.stack([x[:, f * HOP:f * HOP + N] for f in range(32)], 1)
    return np.ascontiguousarray(fr.reshape(64, N).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_todB_and_unitnorm_bitwise():
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * 10.0 ** rng.uniform(-40, 4, 4096)) \
        .astype(np.float32)
    x[:8] = [0.0, -0.0, 1e-45, -1e-45, 1.0, -1.0, 3e38, -3e38]
    assert np.array_equal(TS.todB(_t(x)).numpy(), S.todB(x))
    assert np.array_equal(TS.unitnorm(_t(x)).numpy(), S.unitnorm(x))
    # JAX's todB differs from both only by XLA's FMA contraction
    jd = np.asarray(jax.jit(lambda a: S.todB(a, xp=jnp))(x))
    assert np.abs(jd - S.todB(x)).max() <= 1.25e-4


def test_mdct_matmul_close(pair, frames):
    ja, ta = pair
    w = frames * np.asarray(ja.window)
    want = np.asarray(jax.jit(lambda a: mdct_forward(a, N, xp=jnp))(w))
    got = torch.matmul(_t(w), ta.mdct_basis).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    # the basis is the jax package's own, bit for bit
    assert np.array_equal(ta.mdct_basis.numpy(), J._mdct_basis(N))


def test_bark_fit_close(pair, frames):
    ja, ta = pair
    w = frames * np.asarray(ja.window)
    lm = np.asarray(jax.jit(lambda a: J.log_spectrum(
        mdct_forward(a, N, xp=jnp)))(w))
    ij = (ja.i1, ja.i2, ja.j1, ja.j2)
    assert ij == (ta.i1, ta.i2, ta.j1, ta.j2)
    inp = lm
    for offset, fixed in ((140.0, -1), (0.0, ja.fixed)):
        want = np.asarray(jax.jit(lambda v: J.bark_fit(
            v, ja.bark_lo, ja.bark_hi, offset, fixed, *ij))(inp))
        got = T.bark_fit(_t(inp), ta.bark_lo, ta.bark_hi, offset, fixed,
                         *ij).numpy()
        d = np.abs(got - want)
        assert d.max() <= 0.1, (offset, d.max())
        assert np.percentile(d, 99) <= 0.01, (offset,
                                              np.percentile(d, 99))
        # pass 2 refits the residual of pass 1 (spectra())
        inp = lm - want


def test_tonemask_bitwise_on_same_input(pair):
    ja, ta = pair
    rng = np.random.RandomState(1)
    lf = (rng.randn(16, ta.n2) * 12 - 40).astype(np.float32)
    gm = np.minimum(lf.max(-1), 0.0).astype(np.float32)
    want = np.asarray(jax.jit(ja.tonemask)(lf, gm, gm))
    got = ta.tonemask(_t(lf), _t(gm), _t(gm)).numpy()
    assert np.array_equal(got, want)


def test_full_mask_close(pair, frames):
    ja, ta = pair
    mdj, lmj, mj = map(np.asarray, jax.jit(ja.full_mask)(frames))
    mdt, lmt, mt = (a.numpy() for a in ta.full_mask(_t(frames)))
    assert mdt.shape == mdj.shape == (64, N // 2)
    assert np.isfinite(mt).all() and np.isfinite(mdt).all()
    # logmdct where the MDCT line is not near zero
    big = np.abs(mdj) > 1e-4 * np.abs(mdj).max()
    assert np.abs(lmt - lmj)[big].max() <= 0.05
    d = np.abs(mt - mj)
    assert np.percentile(d, 99.9) < 0.05, np.percentile(d, 99.9)

    def quant(m):
        return np.clip((m * np.float32(7.3142857) + np.float32(1023.5))
                       .astype(np.int32), 0, 1023)
    dq = np.abs(quant(mt) - quant(mj))
    flips = int((dq > 0).sum())
    wide = int((dq > 1).sum())
    print(f"floor quant flips: {flips}/{dq.size}, {wide} by more than one")
    assert flips <= 0.015 * dq.size and wide <= 0.0005 * dq.size


def test_mask_components_and_call(pair, frames):
    """The noise-mask entry points the step does not use stay in step
    with their JAX counterparts."""
    ja, ta = pair
    _, _, nj = map(np.asarray, jax.jit(ja.__call__)(frames))
    _, _, nt = (a.numpy() for a in ta(_t(frames)))
    assert np.percentile(np.abs(nt - nj), 99) < 0.05


ANALYSIS_TABLES = ["window", "windows4", "bark_lo", "bark_hi",
                   "noisecompand", "noiseoffsets", "noiseoffsets_alt",
                   "ath"]
TONE_TABLES = ["group_id", "group_first", "group_band", "curve_rows",
               "ath"]


@pytest.mark.parametrize("name", ANALYSIS_TABLES)
def test_device_tables_analysis(pair, name):
    ja, ta = pair
    assert np.array_equal(getattr(ta, name).numpy(),
                          np.asarray(getattr(ja, name)))


@pytest.mark.parametrize("name", TONE_TABLES)
def test_device_tables_tonemask(pair, name):
    ja, ta = pair
    assert np.array_equal(getattr(ta.tonemask, name).numpy(),
                          np.asarray(getattr(ja.tonemask, name)))


def test_device_tables_tonemask_seed_plan(pair):
    ja, ta = pair
    assert np.array_equal(ta.tonemask.seed_src.numpy(),
                          ja.tonemask.seed_src)
    assert np.array_equal(ta.tonemask.seed_ok.numpy(), ja.tonemask.seed_ok)
    assert np.array_equal(ta.tonemask.win_lo.numpy(),
                          np.asarray(ja.tonemask.win_start))
