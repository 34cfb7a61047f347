"""The port's long-only stateful managed path (vorbis_tpu_torch/ops/managed.py
make_probe_step + make_finish_step, FastEncoder._encode_managed_long with
switching=False) against the JAX package's, both on the CPU: the 15-blob
finish on identical inputs (JAX's probe outputs, lastmdct rows and ampmax
lane), and a batch of two whole ABR streams.  The stream's JAX encode
reuses the finish compiled for the first test (chunk = B).  The stateless
step is held to JAX in test_torch_managed_stateless.py.

Tolerances, each with its cause and the count measured on these inputs:
  * the finish on identical inputs (B = 32 frames, so 32 x 15 packets):
    the causes of the switched finish (test_torch_managed_switched.py):
    XLA:CPU's FMAs in the floor quantization and fit_line, M1's scale; a
    moved post moves every blob of the ladder built on it.  Measured: 473
    of 480 rows equal in bits and bytes, 1,120,814 bits against
    1,120,877; asserted: >= 90% of rows, total bits within 0.5%.
  * two whole ABR streams in one batch (1.0 s and 0.7 s of the click
    train, chunks of B frames: the second stream's first chunk follows
    the first stream's last in the batch, so a lastmdct row or an ampmax
    lane that crossed streams would move its packets): 14,466 vs 14,481
    and 9,469 vs 9,468 audio bytes, 41 of 45 and 28 of 32 packets
    identical, measured; asserted: each stream's audio bytes within 5% of
    JAX's, both in 100-165 kbps.  At 128 kbps no chosen packet passes the
    finish's byte budget, so no chunk is redone (asserted): JAX's
    long-only path emits only the budget's bytes of such a packet, where
    the port redoes the chunk (ROADMAP §3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import _click_train, _rows_equal
from vorbis_tpu.bitstream.oggfile import OggStreamReader
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu.ops import psydevice as JPD
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
    return (JFE(2, 44100, bitrate=ABR),
            TFE(2, 44100, bitrate=ABR, device="cpu"))


@pytest.fixture(scope="module")
def case(encs):
    """B long frames of the click train, JAX's probe of them, the
    lastmdct rows and the ampmax lane the long-only path builds from that
    probe (the first frame reads the zero row), and JAX's finish: (probe
    outputs, lastmdct, ampmax, (packets, nbits))."""
    jfe, tfe = encs
    jm = jfe._managed_dev_for(1)
    ch = 2
    pcm = _click_train(1.0, 44100, 5).astype(np.float32) / 32768.0
    frames = tfe._frame(pcm)[:B].contiguous().numpy()
    oj = [np.asarray(a)
          for a in jm.get_probe_step(B)(jnp.asarray(frames))]
    lamf = oj[5].reshape(B, ch).max(-1)
    amp = JPD.ampmax_seq_nd(
        lamf[None], np.full((1, B), 1, np.int64), jfe.vi.blocksizes, 44100,
        jfe.setup.psy_global["ampmax_att_per_sec"])[0].astype(np.float32)
    lastm = np.concatenate([np.zeros((ch, oj[1].shape[1]), np.float32),
                            oj[1][:-ch]])
    out = tuple(map(np.asarray, jm.get_finish_step(B)(
        *oj[:5], lastm, oj[5], amp)))
    return oj, lastm, amp, out


def test_finish_on_identical_inputs(encs, case):
    _, tfe = encs
    oj, lastm, amp, (pj, nj) = case
    assert (amp > lastm.min()).all() and np.abs(lastm).max() > 0
    pt, nt = (a.numpy() for a in tfe._managed_dev_for(1).make_finish_step(
        B)(*map(_t, oj[:5]), _t(lastm), _t(oj[5]), _t(amp)))
    assert pt.shape == pj.shape and nt.shape == nj.shape == (B, 15)
    same = _rows_equal(pj, nj, pt, nt)
    print(f"long-only finish: {same}/{nj.size} rows equal in bits and "
          f"bytes; bits {nt.sum()} vs {nj.sum()} (JAX)")
    assert same >= 0.9 * nj.size
    assert abs(int(nt.sum()) - int(nj.sum())) <= 0.005 * nj.sum()
    assert (nt[:, 0] < nt[:, 14]).mean() > 0.8


def _audio_packets(ogg):
    return [p for p, _, _ in OggStreamReader(ogg).packets()][3:]


def test_long_only_abr_streams_against_jax(encs, case):
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
        print(f"long-only ABR stream {k} vs JAX: audio bytes {bt} vs {bj} "
              f"({kbps[0]:.1f} vs {kbps[1]:.1f} kbps); identical packets "
              f"{same}/{len(pj)}")
        assert abs(bt - bj) <= 0.05 * bj
        assert all(100 <= r <= 165 for r in kbps)
