"""Whole managed (ABR/CBR) streams of the port
(vorbis_tpu_torch FastEncoder(bitrate=...).encode_managed_batch) against
the stock libvorbis (tests/oracle.py), on the CPU: bench.py's click train
(two streams: 1.0 s and 0.7 s), switched at B_long = B_short = 32, and the
long-only stateful and stateless managed paths.  The bytes against the
JAX package's streams are in test_torch_managed_switched.py,
test_torch_managed_long.py and test_torch_managed_stateless.py, whose
modules compile JAX's managed steps at these shapes anyway; this file
imports no JAX.

Tolerances, each with its cause and the count measured on this input:
  * every stream decodes under the stock libvorbis to the exact input
    length with finite samples; CBR across its pads (0.4 s of silence
    under the wall: 15 padded packets measured; truncation needs even
    blob 0 over the wall with a full reservoir, which full-scale noise
    did not reach at 64 or 128 kbps -- test_torch_managed.py holds the
    floater's truncates to JAX's).
  * ABR at 128 kbps: the audio packets' rate (headers excluded) lands in
    100-165 kbps (the band of tests/test_fastenc.py's ABR gate).
  * encode_managed_batch([a, b])[0] equals encode(a) byte for byte: each
    stream's floater and lastmdct rows are its own.
"""

import numpy as np
import pytest
import torch

from chip_smoke import _click_train
from tests import oracle
from vorbis_tpu_torch.bitstream.oggfile import OggStreamReader
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE

# The suite runs under pytest-xdist with several workers to the host's
# cores; one torch thread a worker keeps torch's OpenMP pools from
# oversubscribing them (the port's test files took 672 s with 6 workers
# on 8 cores at torch's default, 70 s at one thread).
torch.set_num_threads(1)

B = 32
ABR = (-1, 128000, -1)
CBR = (128000, 128000, 128000)


def _packets(ogg):
    return [p for p, _, _ in OggStreamReader(ogg).packets()][3:]


def _kbps(ogg, ns, rate=44100):
    """The audio packets' rate, headers excluded."""
    return sum(map(len, _packets(ogg))) * 8 / (ns / rate) / 1000


def _decode(tmp_path, name, ogg, pcm):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(ogg)
    got, rate = oracle.decode_float(path)
    assert rate == 44100 and got.shape == pcm.shape
    assert np.isfinite(got).all()
    return got


@pytest.fixture(scope="module")
def pcms():
    return [_click_train(1.0, 44100, 0),
            np.ascontiguousarray(_click_train(1.0, 44100, 3)[:, :30870])]


@pytest.fixture(scope="module")
def tfe():
    return TFE(2, 44100, bitrate=ABR, device="cpu")


@pytest.fixture(scope="module")
def streams(pcms, tfe):
    """The port's ABR batch of both inputs."""
    return tfe.encode_managed_batch(pcms, B_long=B, B_short=B)


def test_abr_streams_decode_at_the_rate(pcms, streams, tmp_path):
    for k, (ogg, pcm) in enumerate(zip(streams, pcms)):
        _decode(tmp_path, f"abr{k}.ogg", ogg, pcm)
        kbps = _kbps(ogg, pcm.shape[1])
        print(f"ABR stream {k}: {kbps:.1f} kbps")
        assert 100 <= kbps <= 165


def test_batch_equals_single(pcms, streams, tfe):
    # encode -> encode_managed -> encode_managed_batch of the one stream
    assert tfe.encode(pcms[0]) == streams[0]


def test_cbr_decodes_across_pads(pcms, tmp_path):
    """0.4 s of silence, then the click train: the silent packets are
    padded up to the CBR wall."""
    fe = TFE(2, 44100, bitrate=CBR, device="cpu")
    pcm = pcms[0].copy()
    pcm[:, :17640] = 0
    ogg = fe.encode_managed_batch([pcm], B_long=B, B_short=B)[0]
    _decode(tmp_path, "cbr.ogg", ogg, pcm)
    lm = fe.last_managed
    kbps = _kbps(ogg, pcm.shape[1])
    print(f"CBR: {kbps:.1f} kbps, truncates {lm['truncates']}, pads "
          f"{lm['pads']}, {lm}")
    assert lm["pads"] > 0
    assert 115 <= kbps <= 141


@pytest.mark.parametrize("psy_state", [True, False],
                         ids=["stateful", "stateless"])
def test_long_only_managed_paths(pcms, tfe, psy_state, tmp_path):
    """switching=False: the long-only pipeline in chunks, two-phase with
    the ampmax and lastmdct state, or the stateless framed step."""
    tfe.psy_state = psy_state
    try:
        oggs = tfe.encode_managed_batch(pcms, switching=False, chunk=B)
    finally:
        tfe.psy_state = True
    for k, (ogg, pcm) in enumerate(zip(oggs, pcms)):
        _decode(tmp_path, f"long{k}.ogg", ogg, pcm)
        kbps = _kbps(ogg, pcm.shape[1])
        print(f"long-only psy_state={psy_state} stream {k}: {kbps:.1f} "
              f"kbps")
        assert 100 <= kbps <= 165
        assert all(p[0] >> 1 & 1 for p in _packets(ogg))   # all long


def test_long_only_redoes_oversized_chosen_packets(tmp_path):
    """At 320 kbps nearly every chosen long packet of the signal passes
    the 768-byte budget of the finish step: the long-only path encodes
    such a chunk again at the worst-case budget, so the stream carries
    the whole packets and decodes to the exact length.  Half a second
    of silence first, in chunks of 16 frames: chunks at both budgets
    in one stream.  (The JAX package's long-only path emits the
    budget's 768 bytes of each such packet; ROADMAP §3.)"""
    fe = TFE(2, 44100, bitrate=(-1, 320000, -1), device="cpu")
    sig = oracle.make_test_signal(seconds=1.0)
    pcm = np.concatenate([np.zeros((2, 22050), np.float32), sig], 1)
    ogg = fe.encode_managed_batch([pcm], switching=False, chunk=16)[0]
    wb = fe._managed_dev_for(1).dev.plan.wb
    sizes = [len(p) for p in _packets(ogg)]
    print(f"320 kbps long-only: budget {wb} bytes, "
          f"{sum(s > wb for s in sizes)} of {len(sizes)} packets longer, "
          f"largest {max(sizes)}")
    assert sum(s > wb for s in sizes) > len(sizes) // 2
    _decode(tmp_path, "l320.ogg", ogg, pcm)
