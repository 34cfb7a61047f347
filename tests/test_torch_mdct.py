"""The port's analysis front (vorbis_tpu_torch/ops/mdct_cuda.py,
ops/bark_cuda.py, ops/xla_f32.py) against the JAX package's jitted code,
both on the CPU, on the same numpy inputs: bitwise, no tolerance.

  * xla_f32.fma: the exact float32 fma equals XLA:CPU's contraction of
    `a*b + c`, and flush-to-zero matches its subnormal handling.
  * mdct_fwd_plain (md, logmdct) against jax.jit(mdct_forward) followed
    by log_spectrum at n = 128 to 2048, on the oracle signal and on
    seeded noise with +-0, subnormals and inputs small enough that the
    transform's own values underflow.
  * The whole front (md, logmdct, fit1, dB) against the jitted
    DeviceAnalysis.spectra, at long and short blocks, with windows4 ids,
    on one configuration of each bark region shape the modes make
    (reflected low regions of 4, 11 and 21 bins; fixed windows of 15,
    100 and none).
  * The kernels' index arithmetic (csrc/mdct_fwd.cu's fold, its 16-byte
    chunks, and bit reversal) replayed in numpy against ops/mdct.py's
    tables; the kernels themselves run in tests/test_torch_cuda.py and
    chip_smoke.py, their schedules in tests/test_torch_front_schedule.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import oracle
from vorbis_tpu.models import encsetup as J_encsetup
from vorbis_tpu.ops import jaxdsp as J
from vorbis_tpu.ops.mdct import mdct_forward
from vorbis_tpu_torch.models import encsetup as T_encsetup
from vorbis_tpu_torch.ops import torchdsp as T
from vorbis_tpu_torch.ops.bark_cuda import bark_fit
from vorbis_tpu_torch.ops.mdct import (_imdct_index_tables,
                                       _mdct_forward_index_tables)
from vorbis_tpu_torch.ops.mdct_cuda import mdct_fwd
from vorbis_tpu_torch.ops.xla_f32 import fma, ftz

# one torch thread a pytest-xdist worker (tests/test_torch_analysis.py)
torch.set_num_threads(1)

ROWS = 64
SIZES = (128, 256, 512, 1024, 2048)


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _inputs(n):
    """{kind: (ROWS, n) float32}: the oracle signal's frames; noise with
    zeros of both signs and subnormals; noise scaled so small that the
    transform's products and sums underflow."""
    pcm = oracle.make_test_signal(seconds=1.0)
    hop = n // 2
    x = np.concatenate([np.zeros((2, hop), np.float32), pcm], 1)
    fr = np.stack([x[:, f * hop:f * hop + n] for f in range(ROWS // 2)], 1)
    rng = np.random.RandomState(n)
    noise = rng.randn(ROWS, n).astype(np.float32)
    noise[0, :8] = [0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 0.0, -0.0]
    noise[1] = 0.0
    noise[2, ::3] = np.float32(7e-42)
    noise[3::4] *= np.float32(1e-38)
    tiny = rng.randn(ROWS, n).astype(np.float32) * np.float32(2e-37)
    return {"signal": fr.reshape(ROWS, n).astype(np.float32),
            "noise": noise, "underflow": tiny}


@pytest.fixture(scope="session")
def jax_mdct():
    """{(n, kind): (window, frames, md, logmdct)} from the jitted JAX
    transform, one compile a size."""
    out = {}
    for n in SIZES:
        win = np.sin(np.arange(n) / n * np.pi).astype(np.float32)
        f = jax.jit(lambda a, w: (lambda m: (m, J.log_spectrum(m)))(
            mdct_forward(a * w, n, xp=jnp)))
        for kind, fr in _inputs(n).items():
            md, lm = map(np.asarray, f(fr, win))
            out[n, kind] = (win, fr, md, lm)
    return out


# (channels, rate, quality, W): each bark region shape of the modes
FRONT_CASES = [(2, 44100, 0.5, 1),      # n 2048: i1 11, fixed 100, ids
               (2, 44100, 0.5, 0),      # n 256: i1 4, fixed 15
               (2, 44100, -0.1, 0),     # n 512: i1 4, fixed 15
               (2, 16000, 0.3, 1),      # n 1024: i1 21, no fixed window
               (1, 8000, 0.2, 0)]       # n 512: i1 11, no fixed window


@pytest.fixture(scope="session")
def jax_front():
    """{case: (port DeviceAnalysis, frames, wid, spectra outputs)}."""
    out = {}
    for case in FRONT_CASES:
        ch, rate, q, W = case
        setup = J_encsetup.setup_vbr_staged(ch, rate, q).init()
        bt = min(3 if W else 0, len(setup.psy_params) - 1)
        ja = J.DeviceAnalysis(setup, blocktype=bt, rate=rate, W=W)
        ta = T.DeviceAnalysis(T_encsetup.setup_vbr_staged(ch, rate, q)
                              .init(), blocktype=bt, rate=rate, W=W,
                              device="cpu")
        fr = _inputs(ja.n)["signal"]
        wid = (np.random.RandomState(ja.n).randint(0, 4, ROWS)
               .astype(np.int32) if W else None)
        args = (fr,) if wid is None else (fr, wid)
        out[case] = (ta, fr, wid,
                     [np.asarray(a) for a in jax.jit(ja.spectra)(*args)])
    return out


def test_fma_and_flush_equal_xla():
    rng = np.random.RandomState(0)
    a, b, c = (rng.randn(1 << 16).astype(np.float32) for _ in range(3))
    c[:4096] = -(a[:4096] * b[:4096])          # near-total cancellation
    a[4096:8192] *= np.float32(1e-19)           # products near FLT_MIN
    b[4096:8192] *= np.float32(1e-19)
    c[4096:8192] *= np.float32(1e-38)
    want = np.asarray(jax.jit(lambda p, q, r: p * q + r)(a, b, c))
    # XLA reads subnormal operands as zero; the callers of fma flush
    # their inputs once (every later operand is a flushed result)
    got = fma(*(ftz(torch.from_numpy(v)) for v in (a, b, c))).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    # the product rounded first differs: the contraction is real
    assert not np.array_equal(a * b + c, want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", ["signal", "noise", "underflow"])
def test_mdct_fwd_plain_bitwise(jax_mdct, n, kind):
    win, fr, md, lm = jax_mdct[n, kind]
    got_md, got_lm = mdct_fwd(torch.from_numpy(fr), torch.from_numpy(win))
    assert np.array_equal(_bits(got_md.numpy()), _bits(md))
    assert np.array_equal(_bits(got_lm.numpy()), _bits(lm))


@pytest.mark.parametrize("case", FRONT_CASES)
def test_front_bitwise_against_spectra(jax_front, case):
    """md, logmdct, fit1 and dB of the port's spectra (both kernels'
    plain versions) against the JAX package's jitted spectra."""
    ta, fr, wid, want = jax_front[case]
    got = ta.spectra(torch.from_numpy(fr),
                     None if wid is None else torch.from_numpy(wid))
    for name, g, w in zip(("md", "logmdct", "fit1", "dB"), got, want):
        assert g.shape == w.shape, name
        assert np.array_equal(_bits(g.numpy()), _bits(w)), name
    # the bark fit alone, on the JAX MDCT
    fit1, dB = bark_fit(torch.from_numpy(np.array(want[0])), ta.bark)
    assert np.array_equal(_bits(fit1.numpy()), _bits(want[2]))
    assert np.array_equal(dB.numpy(), want[3])


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048, 4096, 8192])
def test_kernel_index_arithmetic(n):
    """csrc/mdct_fwd.cu computes the fold's gathers and signs, as two
    16-byte chunks an item (a0, a2 words 2, 0 of chunk cA; a1, a3 words
    1, 3 of chunk cB), and stage C's bit reversal from the item index;
    replayed here against the tables the plain version gathers with
    (tests/test_torch_front_schedule.py replays the whole schedule)."""
    tf = _mdct_forward_index_tables(n)
    tb = _imdct_index_tables(n)
    n2, n4, n8 = n >> 1, n >> 2, n >> 3
    log2n = n.bit_length() - 1
    for k in range(n4):
        if k < n8 // 2:
            a = (n2 + n4 - 4 * k - 2, n2 + n4 + 4 * k + 1,
                 n2 + n4 - 4 * k - 4, n2 + n4 + 4 * k + 3)
            s = (1.0, 1.0)
        elif k < (n2 - n8) // 2:
            j = k - n8 // 2
            a = (n2 + n4 - 4 * k - 2, 1 + 4 * j, n2 + n4 - 4 * k - 4,
                 3 + 4 * j)
            s = (1.0, -1.0)
        else:
            m, j = k - (n2 - n8) // 2, k - n8 // 2
            a = (n - 4 * m - 2, 1 + 4 * j, n - 4 * m - 4, 3 + 4 * j)
            s = (-1.0, -1.0)
        assert a == tuple(int(tf[f"a{i}"][k]) for i in range(4)), k
        assert s == (tf["s0"][k], tf["s1"][k]), k
        assert tf["tix"][k] == n2 - 2 * (k + 1)
        # the kernel's chunks: region by region as above
        if k < n8 // 2:
            cA, cB = (n2 + n4) // 4 - k - 1, (n2 + n4) // 4 + k
        elif k < (n2 - n8) // 2:
            cA, cB = (n2 + n4) // 4 - k - 1, k - n8 // 2
        else:
            cA, cB = n // 4 - (k - (n2 - n8) // 2) - 1, k - n8 // 2
        assert a == (4 * cA + 2, 4 * cB + 1, 4 * cA, 4 * cB + 3), k
    for m in range(n8):
        e1 = int(f"{m:032b}"[::-1], 2) >> (33 - log2n)
        e0 = ((~e1) & (n2 - 1)) - 1
        assert (e0, e1) == (tb["e0"][m], tb["e1"][m]), m
        assert tb["tC"][m] == n + 2 * m
    assert np.array_equal(tb["tD"], n2 + 2 * np.arange(n4))
