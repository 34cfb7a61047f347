"""The port's framed encode step (DeviceFastEncode.make_framed_step,
ops/encdevice.py), its sharding over a device list
(parallel/mesh.sharded_encode_step) against the JAX package on the
CPU, on the same numpy inputs.

Tolerances, each beside its check:
- make_framed_step against JAX's: >= 90% byte-identical packets and
  bits within 0.5%, the bound of test_torch_encode.py's slice test (the
  port's MDCT GEMM and bark_fit sums round otherwise, ROADMAP §3);
- sharded against the port's single step: packets and nbits bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu.ops.encdevice import DeviceFastEncode as JD
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops.encdevice import DeviceFastEncode as TD
from vorbis_tpu_torch.parallel import make_codec_mesh, sharded_encode_step

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
F_ENC = 64          # frames of the framed-step parity test


@pytest.fixture(scope="session")
def encoders():
    jfe = JFE(2, 44100, 0.5)
    tfe = TFE(2, 44100, 0.5, device="cpu")
    return (jfe, JD(jfe, chunk_packets=F_ENC),
            tfe, TD(tfe, chunk_packets=F_ENC))


def _noise_frames(F, n, seed=0):
    """The dry run's input: randn * 0.1 frames (F, 2, n)."""
    return (np.random.RandomState(seed).randn(F, 2, n)
            * 0.1).astype(np.float32)


def test_framed_step_vs_jax(encoders):
    """64 noise frames: one packet is 1.6% of the count.  The 3 that
    differ all lie among the first 16 (16 frames alone read 13/16)."""
    jfe, jd, tfe, td = encoders
    frames = _noise_frames(F_ENC, jfe.n)
    pj, nj = map(np.asarray, jax.jit(jd.make_framed_step(F_ENC))(frames))
    pt, nt = (x.numpy() for x in
              td.make_framed_step(F_ENC)(torch.from_numpy(frames)))
    assert pt.shape == pj.shape == (F_ENC, td.plan.wb)
    assert pt.dtype == np.uint8 and nt.dtype == np.int32
    same = sum(bool(nj[f] == nt[f] and np.array_equal(
        pj[f, :(nj[f] + 7) // 8], pt[f, :(nt[f] + 7) // 8]))
        for f in range(F_ENC))
    assert same >= 0.9 * F_ENC, same
    assert abs(int(nt.sum()) - int(nj.sum())) <= 0.005 * int(nj.sum())
    assert (nt <= 8 * td.plan.wb).all()        # no packet cut at wb


@pytest.mark.parametrize("n_dev", [8, 4])
def test_sharded_encode_bitwise(encoders, n_dev, monkeypatch):
    _, _, tfe, td = encoders
    # every shard runs the caller's encoder: its device is the mesh's
    monkeypatch.setattr(TFE, "to",
                        lambda self, d: pytest.fail("encoder rebuilt"))
    F = 16
    frames = _noise_frames(F, tfe.n, seed=1)
    mesh = make_codec_mesh(devices=CPU8[:n_dev])
    pk, nb = sharded_encode_step(td, mesh, F)(frames)
    pk1, nb1 = td.make_framed_step(F)(torch.from_numpy(frames))
    assert torch.equal(pk, pk1) and torch.equal(nb, nb1)
    assert bool((nb > 0).all())
    with pytest.raises(ValueError, match="does not split"):
        sharded_encode_step(td, mesh, F + 1)
