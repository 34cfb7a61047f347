"""The port's roundtrip pipeline and its sharded step
(vorbis_tpu_torch/models/pipeline.py, parallel/mesh.py, graft.py and
DeviceSynthesis in ops/torchdsp.py) against the JAX package on the CPU,
on the same numpy inputs, and sharded against unsharded on a mesh that
repeats the CPU.  The framed encode step and its sharding are in
test_torch_framed.py (a JAX compile each keeps both files under 60 s).

Tolerances, each beside its check:
- DeviceSynthesis against the JAX module's, eager: equal in value.  The
  lap sums every sample from +0, where JAX leaves frame 0's first half
  unsummed, so a -0.0 there may read +0.0: compared with
  np.array_equal (-0 == +0), not by bit pattern.  (Under jax.jit,
  XLA:CPU contracts the IMDCT's products into FMAs and moves the
  samples by up to 2.7e-5: the eager module is the one that rounds
  each op once, as the port does.)
- roundtrip_step against JAX's jitted step: pcm within 1e-5 of its
  scale, err within 1e-6: the bark fit's sums round in another order
  (ROADMAP §3), on loud tones whose keep decisions sit far from the
  mask.
- sharded against unsharded (the port's, on the CPU): pcm equal in
  value, err within 1e-6 relative (the shards' float64 sums of squares
  are added in another order);
- encode_quantize_step against JAX's: >= 90% of rows equal (qposts,
  residues): the plain floor fit is bitwise JAX's on equal spectra, and
  the masks round otherwise.
"""

import jax
import numpy as np
import pytest
import torch

from tests import oracle
from vorbis_tpu.models.pipeline import TpuCodecPipeline
from vorbis_tpu.ops.jaxdsp import DeviceSynthesis as JSynth
from vorbis_tpu.ops.mdct import imdct as J_imdct
from vorbis_tpu.ops.window import hybrid_window
from vorbis_tpu_torch import graft
from vorbis_tpu_torch.models.pipeline import (TorchCodecPipeline,
                                              make_sharded_step)
from vorbis_tpu_torch.ops.torchdsp import DeviceSynthesis as TSynth
from vorbis_tpu_torch.parallel import make_codec_mesh, shard_frames

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="session")
def pipes():
    return (TpuCodecPipeline(ch=2, rate=44100, quality=0.5),
            TorchCodecPipeline(ch=2, rate=44100, quality=0.5,
                               device="cpu"))


@pytest.fixture(scope="session")
def tones(pipes):
    """test_pipeline.py's loud-tone frames (4, 2, 8, n): their bins clear
    the mask by tens of dB, the masked-out bins sit tens of dB under."""
    n = pipes[0].n
    rng = np.random.RandomState(0)
    t = np.arange(n)
    base = (0.5 * np.sin(2 * np.pi * 0.013 * t)
            + 0.25 * np.sin(2 * np.pi * 0.071 * t)).astype(np.float32)
    frames = np.broadcast_to(
        base, (4, 2, 8, n)).astype(np.float32).copy()
    frames *= (1.0 + 0.01 * rng.randn(4, 2, 8, 1).astype(np.float32))
    return frames


@pytest.fixture(scope="session")
def roundtrip(pipes, tones):
    """The port's unsharded roundtrip of the tones: (pcm, err)."""
    pcm, err = pipes[1].roundtrip_step(tones)
    return pcm.numpy(), float(err)


def test_device_synthesis_equals_jax(pipes):
    n = pipes[0].n
    spec = np.random.RandomState(1).randn(5, n // 2).astype(np.float32)
    want = np.asarray(JSynth(n)(spec))
    got = TSynth(n, device="cpu")(torch.from_numpy(spec)).numpy()
    assert got.shape == want.shape == (5 * n // 2,)
    assert np.array_equal(got, want)           # in value: -0 == +0


@pytest.mark.parametrize("shape", [(5,), (3, 5), (2, 2, 3)],
                         ids=["F5", "S3xF5", "S2xC2xF3"])
def test_device_synthesis_serial_lapping(pipes, shape):
    """Any leading axes: each is a stream, equal in value to
    test_pipeline.py's serial lapping of the numpy IMDCT."""
    n = pipes[0].n
    spec = np.random.RandomState(len(shape)).randn(
        *shape, n // 2).astype(np.float32)
    got = TSynth(n, device="cpu")(torch.from_numpy(spec)).numpy()
    w = hybrid_window(n // 8, n, 1, 1, 1)
    pcm = np.asarray(J_imdct(spec, n)) * w
    lapped = pcm[..., :n // 2].copy()
    lapped[..., 1:, :] += pcm[..., :-1, n // 2:]
    assert got.shape == shape[:-1] + (shape[-1] * n // 2,)
    assert np.array_equal(got, lapped.reshape(got.shape))


@pytest.mark.parametrize("cuts", [(1,), (3,), (2, 5), (1, 2, 3, 4, 5, 6)])
def test_synthesis_halo_carries_the_lap(cuts):
    """Cut the frame axis anywhere: each piece starts from the previous
    piece's halo, and the pieces equal the whole in value."""
    n = 256
    spec = torch.from_numpy(np.random.RandomState(7).randn(
        2, 7, n // 2).astype(np.float32))
    syn = TSynth(n, device="cpu")
    whole = syn(spec)
    bounds = (0,) + cuts + (7,)
    parts, tail = [], None
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b < 7:
            pcm, tail_next = syn.with_halo(spec[:, a:b], tail)
        else:
            pcm, tail_next = syn(spec[:, a:b], tail), None
        parts.append(pcm)
        tail = tail_next
    assert torch.equal(torch.cat(parts, -1), whole)


def test_pipeline_frame_equals_jax(pipes):
    pcm = oracle.make_test_signal(seconds=0.3)
    assert np.array_equal(pipes[1].frame(pcm), pipes[0].frame(pcm))


def test_mask_step_shapes(pipes):
    """test_pipeline.py's checks of mask_step on the port, and
    encode_step's shapes: the mask is finite and sits at or above the
    ATH floor everywhere."""
    tp = pipes[1]
    fr = tp.frame(oracle.make_test_signal(seconds=0.3))[0]
    md, logmdct, mask = (x.numpy() for x in tp.mask_step(fr))
    assert md.shape == logmdct.shape == mask.shape \
        == (fr.shape[0], tp.n // 2)
    assert np.isfinite(mask).all()
    att = max(float(np.minimum(logmdct.max(), 0.0))
              + tp.analysis.look.vi["ath_adjatt"],
              tp.analysis.look.vi["ath_maxatt"])
    assert mask.min() >= tp.analysis.ath.numpy().min() + att - 1.0
    md2, logmdct2, noise = (x.numpy() for x in tp.encode_step(fr))
    assert noise.shape == md2.shape == md.shape
    assert np.array_equal(logmdct2, logmdct) and np.isfinite(noise).all()


def test_roundtrip_step_vs_jax(pipes, tones, roundtrip):
    pj, ej = map(np.asarray, jax.jit(pipes[0].roundtrip_step)(tones))
    pt, et = roundtrip
    assert pt.shape == pj.shape == (4, 2, 8 * pipes[0].n // 2)
    assert np.abs(pt - pj).max() <= 1e-5 * np.abs(pj).max()
    assert abs(et - float(ej)) < 1e-6, (et, float(ej))


def test_encode_quantize_step_vs_jax(pipes):
    """Floor posts and rint residues of a 0.6 s test signal's frames: the
    plain floor fit is bitwise JAX's on equal spectra; the masks round
    otherwise (bark_fit), so >= 90% of rows, as the card-vs-CPU phases."""
    jp, tp = pipes
    fr = jp.frame(oracle.make_test_signal(seconds=0.6))[0]
    qj, rj = map(np.asarray, jax.jit(jp.encode_quantize_step)(fr))
    qt, rt = (x.numpy() for x in tp.encode_quantize_step(fr))
    assert qt.dtype == rt.dtype == np.int32
    assert qt.shape == qj.shape and rt.shape == rj.shape
    assert (qt == qj).all(1).mean() >= 0.9
    assert (rt == rj).all(1).mean() >= 0.9


@pytest.mark.parametrize("n_dev,shape", [(8, (2, 4)), (6, (2, 3)),
                                         (4, (2, 2)), (3, (1, 3)),
                                         (1, (1, 1))])
def test_make_codec_mesh_squarest(n_dev, shape):
    mesh = make_codec_mesh(devices=CPU8[:n_dev])
    assert mesh.devices.shape == shape and mesh.size == n_dev
    assert mesh.shape == {"dp": shape[0], "sp": shape[1]}
    assert mesh.distinct() == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="9 devices asked for"):
        make_codec_mesh(9, devices=CPU8)


def test_shard_frames_layout(tones):
    mesh = make_codec_mesh(devices=CPU8)
    grid = shard_frames(mesh, tones)
    assert len(grid) == 2 and all(len(r) == 4 for r in grid)
    for i in range(2):
        for j in range(4):
            assert np.array_equal(grid[i][j].numpy(),
                                  tones[2 * i:2 * i + 2, :, 2 * j:2 * j + 2])
    with pytest.raises(ValueError, match="do not split"):
        shard_frames(mesh, tones[:3])


@pytest.mark.parametrize("n_dev", [8, 2])
def test_sharded_roundtrip_equals_unsharded(pipes, tones, roundtrip, n_dev,
                                           monkeypatch):
    # every shard runs the caller's pipeline: its device is the mesh's
    monkeypatch.setattr(TorchCodecPipeline, "to",
                        lambda self, d: pytest.fail("pipeline rebuilt"))
    mesh = make_codec_mesh(devices=CPU8[:n_dev])
    pcm, err = make_sharded_step(pipes[1], mesh)(tones)
    want, want_err = roundtrip
    assert np.array_equal(pcm.numpy(), want)   # in value: -0 == +0
    assert abs(float(err) - want_err) <= 1e-6 * want_err


def test_graft_dryrun_on_cpu_mesh():
    graft.dryrun_multichip(8, devices=CPU8)
    fn, (frames,) = graft.entry(device="cpu")
    pk, nb = fn(frames)
    assert pk.dtype == torch.uint8 and pk.shape[0] == frames.shape[0]
    assert tuple(nb.shape) == (pk.shape[0],) and bool((nb > 0).all())
