"""The port's stateless managed step (vorbis_tpu_torch/ops/managed.py
make_framed_step: psy_state=False, long-only) against the JAX package's
get_step, both on the CPU: the step on identical frames, and a batch of two
whole ABR streams through FastEncoder._encode_managed_long, whose JAX
encode reuses the step compiled for the first test (chunk = B).

Tolerances, each with its cause and the count measured on these inputs:
  * the step on identical frames (B = 32 frames, so 32 x 15 packets):
    the masks of managed_masks (test_torch_managed.py: the MDCT GEMM,
    bark_fit's sum order, XLA:CPU's FMAs; a flipped floor quantum moves a
    post, and a moved post every blob of the ladder built on it).
    Measured: 438 of 480 rows equal in bits and bytes, 1,029,863 bits
    against 1,029,654 (458 of 480 with the MDCT as an fp32 GEMM, which
    rounds nearer the butterfly here; the float64-accumulated GEMM keeps
    the card and the CPU equal); asserted: >= 90% of rows, total bits
    within 0.5%.
  * two whole ABR streams in one batch (1.0 s and 0.7 s of the click
    train, chunks of B frames): 15,410 vs 15,415 and 9,510 vs 9,512
    audio bytes, 42 of 45 and 28 of 32 packets identical, measured;
    asserted: each stream's audio bytes within 5% of JAX's, both in
    100-165 kbps.  No chosen packet passes the step's byte budget, so no
    chunk is redone (asserted; test_torch_managed_long.py says why that
    matters).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import _click_train, _rows_equal
from vorbis_tpu.bitstream.oggfile import OggStreamReader
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE

# The suite runs under pytest-xdist with several workers to the host's
# cores; one torch thread a worker keeps torch's OpenMP pools from
# oversubscribing them (the port's test files took 672 s with 6 workers
# on 8 cores at torch's default, 70 s at one thread).
torch.set_num_threads(1)

B = 32
ABR = (-1, 128000, -1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def encs():
    return (JFE(2, 44100, bitrate=ABR, psy_state=False),
            TFE(2, 44100, bitrate=ABR, psy_state=False, device="cpu"))


def test_framed_step_on_identical_inputs(encs):
    """frames -> managed_masks -> three fits -> the ladder -> 15 packets
    a frame."""
    jfe, tfe = encs
    pcm = _click_train(1.0, 44100, 4).astype(np.float32) / 32768.0
    frames = tfe._frame(pcm)[:B].contiguous().numpy()
    pj, nj = map(np.asarray,
                 jfe._managed_dev_for(1).get_step(B)(jnp.asarray(frames)))
    pt, nt = (a.numpy() for a in tfe._managed_dev_for(1).make_framed_step(
        B)(_t(frames)))
    assert pt.shape == pj.shape and nt.shape == nj.shape == (B, 15)
    same = _rows_equal(pj, nj, pt, nt)
    print(f"framed step: {same}/{nj.size} rows equal in bits and bytes; "
          f"bits {nt.sum()} vs {nj.sum()} (JAX)")
    assert same >= 0.9 * nj.size
    assert abs(int(nt.sum()) - int(nj.sum())) <= 0.005 * nj.sum()
    assert (nt[:, 0] < nt[:, 14]).mean() > 0.8


def _audio_packets(ogg):
    return [p for p, _, _ in OggStreamReader(ogg).packets()][3:]


def test_stateless_abr_streams_against_jax(encs):
    jfe, tfe = encs
    pcms = [_click_train(1.0, 44100, 0),
            np.ascontiguousarray(_click_train(1.0, 44100, 3)[:, :30870])]
    wb = tfe._managed_dev_for(1).dev.plan.wb
    assert wb == jfe._managed_dev_for(1).dev.plan.wb
    outs = {name: [_audio_packets(o) for o in fe.encode_managed_batch(
        pcms, switching=False, chunk=B)] for name, fe in
        (("jax", jfe), ("port", tfe))}
    for k, (pj, pt) in enumerate(zip(outs["jax"], outs["port"])):
        assert len(pj) == len(pt)
        assert max(map(len, pj + pt)) <= wb          # no chunk redone
        bj, bt = sum(map(len, pj)), sum(map(len, pt))
        kbps = [b * 8 / (pcms[k].shape[1] / 44100) / 1000 for b in (bt, bj)]
        same = sum(a == b for a, b in zip(pj, pt))
        print(f"stateless ABR stream {k} vs JAX: audio bytes {bt} vs {bj} "
              f"({kbps[0]:.1f} vs {kbps[1]:.1f} kbps); identical packets "
              f"{same}/{len(pj)}")
        assert abs(bt - bj) <= 0.05 * bj
        assert all(100 <= r <= 165 for r in kbps)
