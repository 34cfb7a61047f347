"""The port's switched managed path (vorbis_tpu_torch/ops/managed.py
make_finish_step15, FastEncoder.encode_managed_batch with switching)
against the JAX package's, both on the CPU: the 15-blob finish of a long
and a short batch on identical inputs, and one whole ABR stream.  JAX's two
finish compiles (one per block size, about 35 s each on the CPU) run
together in two threads; the stream's encode reuses them
(B_long = B_short = B).

Tolerances, each with its cause and the count measured on these inputs:
  * the 15-blob finish on identical inputs (JAX's probe outputs and
    state; a long batch and a short batch with m3vec, B = 32 frames, so
    32 x 15 packets each): what moves a packet is what moves the
    unmanaged finish (test_torch_psystate.py, test_torch_switching.py):
    XLA:CPU contracts the floor quantization mask*7.31 + 1023.5 and
    fit_line's products into FMAs where torch rounds each product
    (test_torch_floor.py), and M1's scale rounds once more here; a moved
    post moves every blob of the ladder built on it.  Measured: long 478
    of 480 rows equal in bits and bytes (total bits equal), short 476 of
    480 (269,345 bits against 269,348); asserted: >= 90% of rows, total
    bits within 0.5% (the bounds of the unmanaged finish tests).
  * one whole ABR stream (1.0 s of the click train) against JAX's:
    16,411 vs 16,413 audio bytes, 104 of 115 packets and 115 of 115
    choices equal, measured; asserted: bytes within 5%, both in
    100-165 kbps.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import _click_train, _rows_equal
from vorbis_tpu.bitstream.oggfile import OggStreamReader
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu.ops import managed as JM
from vorbis_tpu.ops import psydevice as JPD
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import managed as TM

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
def batches(encs):
    """JAX's probe outputs and state for the first B long and the first
    B short frames of a switched 1 s click train (the JAX side's own
    schedule), and JAX's 15-blob finish of each: {W: (inputs, (packets,
    nbits))}."""
    jfe, _ = encs
    xj, perj = jfe._prepare_switched([_click_train(1.0, 44100, 0)], True)
    rec = perj[0]
    ins = {}
    ann = JPD.annotate_frames(rec["Ws"], rec["impulse"])
    rng = np.random.RandomState(3)
    for W, idx in ((1, rec["li"]), (0, rec["si"])):
        assert len(idx) >= B
        idx = idx[:B]
        wd = rec["wid"][idx] if W else np.zeros(B, np.int64)
        sv = np.stack([rec["starts"][idx], wd, np.zeros(B)]).astype(np.int32)
        oj = [np.asarray(a) for a in jfe._probe_step(W, B)(
            xj, jnp.asarray(sv))]
        n2L = oj[5].shape[1]
        lastm = np.concatenate([np.zeros((2, n2L), np.float32), oj[5][:-2]])
        amp = oj[6].reshape(B, 2).max(1)
        lc = np.where(rng.rand(2 * B) < 0.5, -1.0, rng.rand(2 * B))
        po = np.where(rng.rand(2 * B) < 0.7, -1.0, rng.rand(2 * B) * 40)
        if not W:
            po[:] = -1.0
        tr = (ann["bm"][idx] == (2 if W else 1)).astype(np.float32)
        fstate = np.concatenate([amp, lc, po, tr, wd]).astype(np.float32)
        m3vec = None
        if not W:
            sub = {k: ann[k][idx]
                   for k in ("bm", "lW_bm", "lW_no", "impadnum")}
            pr = JPD.m3_param_seq(sub, 128, 2.0, True, managed=True)
            assert pr["sw"].sum() > 5
            m3vec = np.stack([pr["sw"], pr["noise_rate"],
                              pr["noise_center"], pr["tone_rate"],
                              pr["reset"], sub["impadnum"] == 0]
                             ).astype(np.float32)
        ins[W] = (oj, lastm, fstate, m3vec)

    steps = {W: jfe._managed_finish_step(W, B) for W in ins}

    def finish(W):
        oj, lastm, fstate, m3vec = ins[W]
        return tuple(map(np.asarray, steps[W](
            *oj[:5], lastm, oj[6], fstate,
            None if m3vec is None else jnp.asarray(m3vec))))

    # the two XLA compiles overlap: XLA releases the GIL while it compiles
    with ThreadPoolExecutor(2) as pool:
        outs = dict(zip(ins, pool.map(finish, ins)))
    return {W: (ins[W], outs[W]) for W in ins}


@pytest.mark.parametrize("W", [1, 0], ids=["long", "short_m3"])
def test_finish15_on_identical_inputs(encs, batches, W):
    _, tfe = encs
    (oj, lastm, fstate, m3vec), (pj, nj) = batches[W]
    pt, nt = (a.numpy() for a in tfe._managed_finish_step(W, B)(
        *map(_t, oj[:5]), _t(lastm), _t(oj[6]), _t(fstate),
        None if m3vec is None else _t(m3vec)))
    assert pt.shape == pj.shape and nt.shape == nj.shape == (B, 15)
    same = _rows_equal(pj, nj, pt, nt)
    print(f"finish15 W={W}: {same}/{nj.size} rows equal in bits and bytes; "
          f"bits {nt.sum()} vs {nj.sum()} (JAX); blob sizes rise: "
          f"{(np.diff(nt, axis=1) >= 0).mean():.2f}")
    assert same >= 0.9 * nj.size
    assert abs(int(nt.sum()) - int(nj.sum())) <= 0.005 * nj.sum()
    # the ladder spans real rates: the lowest blob is smaller than the
    # highest on most frames
    assert (nt[:, 0] < nt[:, 14]).mean() > 0.8


# ---------------------------------------------------------------------------
# one whole ABR stream against JAX's (the JAX steps compiled above are
# the ones its encode runs: the same encoder, B_long = B_short = B)

def _audio_packets(ogg):
    return [p for p, _, _ in OggStreamReader(ogg).packets()][3:]


def test_abr_stream_bytes_against_jax(encs, batches):
    """The floater's choice follows the bytes of every earlier packet
    (one byte moves avgfloat), so a packet that moves can move every
    later choice: the identical packets and equal choices are printed,
    not gated.  Audio bytes within 5% of JAX's, both streams in
    100-165 kbps."""
    jfe, tfe = encs
    pcm = _click_train(1.0, 44100, 0)
    outs, logs = {}, {}
    for name, fe, mod in (("jax", jfe, JM), ("port", tfe, TM)):
        log = logs[name] = []
        choose = mod.ReservoirChooser.choose

        def rec(self, sizes, W, choose=choose, log=log):
            out = choose(self, sizes, W)
            log.append(out[0])
            return out
        mod.ReservoirChooser.choose = rec
        try:
            outs[name] = _audio_packets(fe.encode_managed_batch(
                [pcm], B_long=B, B_short=B)[0])
        finally:
            mod.ReservoirChooser.choose = choose
    pj, pt = outs["jax"], outs["port"]
    assert len(pj) == len(pt) == len(logs["jax"]) == len(logs["port"])
    bj, bt = sum(map(len, pj)), sum(map(len, pt))
    same = sum(a == b for a, b in zip(pj, pt))
    chosen = sum(a == b for a, b in zip(logs["jax"], logs["port"]))
    kbps = [b * 8 / 1000 for b in (bt, bj)]       # 1.0 s of audio
    print(f"ABR stream vs JAX: audio bytes {bt} vs {bj} ({kbps[0]:.1f} vs "
          f"{kbps[1]:.1f} kbps); identical packets {same}/{len(pj)}; "
          f"equal choices {chosen}/{len(pj)}; port choices "
          f"{np.bincount(logs['port'], minlength=15).tolist()}")
    assert abs(bt - bj) <= 0.05 * bj
    assert all(100 <= k <= 165 for k in kbps)
    assert len(set(logs["port"])) > 1
