"""The port's golden encoder against the JAX package's on
tests/test_encoder.py's longer managed stream
(test_golden_packets_long_stream: 1.5 s of the mix signal, seed 11,
ABR 128 kbps): deeper psy history (lastmdct, tempmdct, impadnum, lW_no
chains) and real bitrate-reservoir dynamics.  Each side takes about
50 s here, so the JAX side runs in a child process (spawned, numpy
only) on the same array while the port encodes in this one, which
keeps the file under about 60 s alone.  Exact: packets, header
packets, bit_stats."""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import torch

from tests import oracle
from tests.golden_pair import SIDES, run, setup_for

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

MANAGED = setup_for(2, 44100, 0.0, 128)


def _encode(side, pcm):
    """One package's encode: (packets, header packets, bit_stats)."""
    enc_mod, setup_mod = SIDES[side]
    enc = enc_mod.Encoder(MANAGED(setup_mod))
    return run(enc, pcm), enc.header_packets(), enc.bit_stats


def test_golden_packets_long_stream_equal_jax():
    pcm = oracle.make_test_signal(seconds=1.5, seed=11)
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        jax_side = ex.submit(_encode, 0, pcm)
        got = _encode(1, pcm)
        want = jax_side.result()
    assert len(got[0]) == len(want[0]) > 60
    for i, (a, b) in enumerate(zip(want[0], got[0])):
        assert a == b, f"packet {i} differs"
    assert got[1:] == want[1:]
