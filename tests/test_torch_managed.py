"""The port's managed (ABR/CBR) units (vorbis_tpu_torch/ops/managed.py: the
post ladder, the stacked floor fits, the per-blob tables, ReservoirChooser;
ops/torchdsp.py: managed_masks) against vorbis_tpu/ops/managed.py and
vorbis_tpu/ops/jaxdsp.py, both on the CPU.  The 15-blob finish steps on
identical inputs and the streams against JAX's are in
test_torch_managed_switched.py (the switched path),
test_torch_managed_long.py (the long-only stateful path) and
test_torch_managed_stateless.py (the stateless step), so that each file
pays for its own JAX step compiles; the port's whole streams against the
stock libvorbis are in test_torch_managed_stream.py.

Tolerances, each with its cause and the count measured on these inputs:
  * the ladder (_interp_posts, _blob_ladder): int32 arithmetic, exact, on
    random posts with the 0x8000 flag at neither, one or both ends and on
    real fits.
  * the three fits stacked into one fit of 3*R rows against three fits:
    the rows are independent, exact.
  * ReservoirChooser on seeded size sequences with long and short blocks
    mixed (ABR, CBR and a min/max window): Python ints and float64 in
    the same order, exact choices, truncates and pads.
  * the per-blob tables (thr1, threv, inlimit, lowpass for all 15 blobs,
    long and short): exact.
  * managed_masks (the three offset_select masks of the stateless
    managed step) on 32 frames of the click train: the causes and bounds
    of test_torch_analysis.py's full mask (the MDCT GEMM against JAX's
    butterfly, bark_fit's sum order, XLA:CPU's FMAs; the floor quantizes
    each mask as int(mask * 7.31 + 1023.5)).  Measured: 244, 276 and 299
    of 65,536 quanta flip (selects 0, 1, 2), 9, 14 and 15 of them by more
    than one, 99.9th percentile of |mask diff| 0.0066 dB.
    Asserted for each select: <= 1.5% of quanta flip, <= 0.05% by more
    than one, the 99.9th percentile of |mask diff| < 0.05 dB; logmdct
    within 0.05 dB where the line is not near zero (0.0041 dB measured);
    the MDCT after select 1's M1/M4 rescale within 1e-3 of its peak
    (4.8e-4 measured: a rescale decision that flips moves a whole line).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import _click_train
from vorbis_tpu.models import encsetup as J_setup
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu.ops import managed as JM
from vorbis_tpu_torch.models import encsetup as T_setup
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import managed as TM

# The suite runs under pytest-xdist with several workers to the host's
# cores; one torch thread a worker keeps torch's OpenMP pools from
# oversubscribing them (the port's test files took 672 s with 6 workers
# on 8 cores at torch's default, 70 s at one thread).
torch.set_num_threads(1)

B = 32
ABR = (-1, 128000, -1)
CBR = (128000, 128000, 128000)
WINDOW = (192000, 128000, 64000)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="session")
def encs():
    return (JFE(2, 44100, bitrate=ABR),
            TFE(2, 44100, bitrate=ABR, device="cpu"))


# ---------------------------------------------------------------------------
# the post ladder and the stacked fits

def _ladders(ps, us):
    """Both packages' ladders on the same posts: ((15 posts, 15 used)
    JAX, the same port)."""
    lj, uj = JM._blob_ladder([jnp.asarray(p) for p in ps],
                             [jnp.asarray(u) for u in us])
    lt, ut = TM._blob_ladder([_t(p) for p in ps], [_t(u) for u in us])
    return ([np.asarray(a) for a in lj], [np.asarray(a) for a in uj]), \
        ([a.numpy() for a in lt], [a.numpy() for a in ut])


def test_ladder_bitwise_on_random_posts():
    """Posts over the full 15-bit range with the interpolation flag at
    neither, one or both ends of each pair, and mixed used flags."""
    rng = np.random.RandomState(5)
    R, P = 512, 29
    ps = [(rng.randint(0, 0x8000, (R, P))
           | np.where(rng.rand(R, P) < 0.5, 0x8000, 0)).astype(np.int32)
          for _ in range(3)]
    us = [rng.rand(R) < 0.8 for _ in range(3)]
    (lj, uj), (lt, ut) = _ladders(ps, us)
    for k in range(TM.PACKETBLOBS):
        assert lt[k].dtype == np.int32
        assert np.array_equal(lt[k], lj[k]), k
        assert np.array_equal(ut[k], uj[k]), k
    flags = [(p & 0x8000) != 0 for p in ps]
    for a, b in ((0, 1), (1, 2)):
        both = flags[a] & flags[b]
        one = flags[a] ^ flags[b]
        assert both.any() and one.any() and (~(flags[a] | flags[b])).any()
    # the flag survives only where both ends carry it
    mid = lt[3]
    assert np.array_equal((mid & 0x8000) != 0, flags[0] & flags[1])


def test_stacked_fits_equal_three_fits_and_ladder_on_real_fits(encs):
    """The three offset_select fits of real masks (the port's
    managed_masks on 32 frames of the click train) as one stacked fit
    equal three separate fits bit for bit; the ladder on them equals
    JAX's."""
    _, tfe = encs
    pcm = _click_train(1.0, 44100, 0).astype(np.float32) / 32768.0
    frames = tfe._frame(pcm)[:B].contiguous()
    md, lm, masks = tfe.analysis.managed_masks(frames.reshape(2 * B, -1))
    ms = masks.unbind(-2)
    ps, us = TM.floor3(tfe.floor, lm, ms)
    for k in range(3):
        p1, u1 = tfe.floor(lm, ms[k])
        assert torch.equal(ps[k], p1) and torch.equal(us[k], u1)
    assert not torch.equal(ps[0], ps[2])
    (lj, uj), (lt, ut) = _ladders([p.numpy() for p in ps],
                                  [u.numpy() for u in us])
    assert all(np.array_equal(a, b) for a, b in zip(lt + ut, lj + uj))


# ---------------------------------------------------------------------------
# the reservoir floater

def _sizes(seed, F, W):
    """Seeded (F, 15) packet byte sizes rising along the blob axis around
    the 128 kbps budget of each block size, with loud and silent runs
    that push a CBR floater onto its walls."""
    rng = np.random.RandomState(seed)
    base = np.where(W == 1, 371.5, 46.4) * rng.lognormal(0.0, 0.5, F)
    # runs of 400 frames: as loud as 4x the budget, then near silence
    run = np.arange(F) // 400 % 4
    base *= np.choose(run, [1.0, 4.0, 1.0, 0.02])
    ladder = 1.09 ** (np.arange(TM.PACKETBLOBS) - 7)
    return np.maximum(1, np.rint(base[:, None] * ladder[None, :])
                      ).astype(np.int64)


@pytest.mark.parametrize("br", [ABR, CBR, WINDOW],
                         ids=["abr", "cbr", "minmax"])
def test_reservoir_chooser_equals_jax(br):
    rng = np.random.RandomState(sum(br) // 1000)
    F = 3000
    W = (rng.rand(F) < 0.3).astype(np.int64)
    sizes = _sizes(7, F, W)
    js = J_setup.setup_managed(2, 44100, *br)
    ts = T_setup.setup_managed(2, 44100, *br)
    jc = JM.ReservoirChooser(js, 44100, js.vi.blocksizes)
    tc = TM.ReservoirChooser(ts, 44100, ts.vi.blocksizes)
    want = np.array([jc.choose(sizes[f], int(W[f])) for f in range(F)])
    cf, tp = TM.reservoir_walk(tc, sizes, W)
    got = np.column_stack([cf, tp])
    assert np.array_equal(got, want)
    assert (tc.avgfloat, tc.avg_reservoir, tc.minmax_reservoir) == \
        (jc.avgfloat, jc.avg_reservoir, jc.minmax_reservoir)
    print(f"{br}: choices {np.bincount(cf, minlength=15).tolist()}, "
          f"truncates {(tp[:, 0] > 0).sum()}, pads {(tp[:, 1] > 0).sum()}")
    assert len(set(cf.tolist())) > 3
    if br == CBR:
        assert (tp[:, 0] > 0).any() and (tp[:, 1] > 0).any()


def test_compact_chosen_truncates_and_pads():
    """The dense buffer holds each chosen packet cut by its truncate and
    followed by its zero pad, across batches of two widths."""
    rng = np.random.RandomState(2)
    b1 = rng.randint(1, 256, (3, 8)).astype(np.uint8)
    b2 = rng.randint(1, 256, (2, 12)).astype(np.uint8)
    chosen = np.array([8, 5, 2, 12, 1])
    tps = np.array([[3, 0], [0, 4], [0, 0], [2, 1], [1, 2]])
    blob, off, fin = TM.compact_chosen([b1, b2], chosen, tps)
    want = [b1[0, :5], b1[1, :5], [0] * 4, b1[2, :2], b2[0, :10], [0],
            [0, 0]]
    assert np.array_equal(blob, np.concatenate(want).astype(np.uint8))
    assert fin.tolist() == [5, 9, 2, 11, 2]
    assert off.tolist() == [0, 5, 14, 16, 27]


# ---------------------------------------------------------------------------
# the per-blob tables and the override plumbing

@pytest.mark.parametrize("W", [1, 0])
def test_per_blob_tables_equal(encs, W):
    jfe, tfe = encs
    jm, tm = JM.DeviceManagedEncode(jfe, W=W), tfe._managed_dev_for(W)
    for k in ("thr1_15", "threv_15", "inlimit_15", "lowpass_15"):
        a, b = getattr(tm, k), getattr(jm, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
        assert np.array_equal(tm.t[k].numpy(), b), k
    # the blobs' coupling differs (at 128 kbps every lowpass is n2)
    assert len({r.tobytes() for r in tm.thr1_15}) > 1
    assert tm.dev is tfe._dev_for(W)


def test_overrides_at_the_middle_blob_change_nothing(encs):
    """finish_from_posts with blob 7's coupling rows and a lowpass at n2
    gives the packets of the unmanaged call (the per-row overrides reach
    the same arithmetic)."""
    _, tfe = encs
    dev, tm = tfe.dev, tfe._managed_dev_for(1)
    pcm = _click_train(1.0, 44100, 1).astype(np.float32) / 32768.0
    flat = tfe._frame(pcm)[:B].reshape(2 * B, -1)
    md, lm, mask = tfe.analysis.full_mask(flat)
    posts, used = tfe.floor(lm, mask)
    n2 = md.shape[-1]
    rows = {k: tm.t[k + "_15"][7].expand(B, n2)
            for k in ("thr1", "threv", "inlimit")}
    got = dev.finish_from_posts(md, posts, used, B, dev.plan.wb,
                                lowpass=torch.full((2 * B,), n2), **rows)
    want = dev.finish_from_posts(md, posts, used, B, dev.plan.wb)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the stateless step's three masks

def _quant(m):
    """The floor's quantization of a mask (floor1 fit input)."""
    return np.clip((m * np.float32(7.3142857) + np.float32(1023.5))
                   .astype(np.int32), 0, 1023)


def test_managed_masks_close(encs):
    jfe, tfe = encs
    pcm = _click_train(1.0, 44100, 2).astype(np.float32) / 32768.0
    flat = tfe._frame(pcm)[:B].reshape(2 * B, -1).numpy()
    mdj, lmj, mj = map(np.asarray,
                       jax.jit(jfe.analysis.managed_masks)(flat))
    mdt, lmt, mt = (a.numpy() for a in tfe.analysis.managed_masks(
        _t(flat)))
    assert mt.shape == mj.shape == (2 * B, 3, flat.shape[1] // 2)
    assert np.isfinite(mt).all() and np.isfinite(mdt).all()
    # logmdct where the MDCT line is not near zero; the MDCT after the
    # M1/M4 rescale of select 1
    big = np.abs(mdj) > 1e-4 * np.abs(mdj).max()
    assert np.abs(lmt - lmj)[big].max() <= 0.05
    assert np.abs(mdt - mdj).max() <= 1e-3 * np.abs(mdj).max()
    for sel in range(3):
        d = np.abs(mt[:, sel] - mj[:, sel])
        dq = np.abs(_quant(mt[:, sel]) - _quant(mj[:, sel]))
        flips, wide = int((dq > 0).sum()), int((dq > 1).sum())
        print(f"managed mask {sel}: {flips}/{dq.size} quanta flip, {wide} "
              f"by more than one, 99.9th pct {np.percentile(d, 99.9):.2e}")
        assert np.percentile(d, 99.9) < 0.05
        assert flips <= 0.015 * dq.size and wide <= 0.0005 * dq.size
    # the selects differ: three distinct anchors for the ladder
    assert not np.array_equal(_quant(mt[:, 0]), _quant(mt[:, 2]))
