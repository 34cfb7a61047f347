"""The port's golden encoder against the JAX package's on the stereo
rows of tests/test_encoder.py's GOLDEN_MATRIX at rates other than 44.1
kHz (48 kHz q0.8, 32 kHz q1.0, 96 kHz q0.5), each on its own clip; the
rest of the matrix is in test_torch_golden.py, test_torch_golden_51.py
and test_torch_golden_managed.py.  Also the all-zero input of
test_golden_packets_silence.  Exact: packets, header packets, bit_stats
(tests/golden_pair.py)."""

import numpy as np
import pytest
import torch

from tests import oracle
from tests.golden_pair import assert_pair_equal, encode_pair, setup_for
from tests.test_encoder import GOLDEN_MATRIX

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

ROWS = [r for r in GOLDEN_MATRIX if r[0] == 2 and r[1] != 44100]


@pytest.mark.parametrize("ch,rate,q,kbps,secs", ROWS)
def test_golden_packets_equal_jax(ch, rate, q, kbps, secs):
    pcm = oracle.make_test_signal(rate=rate, seconds=secs, ch=ch)
    assert_pair_equal(encode_pair(setup_for(ch, rate, q, kbps), pcm))


def test_silence_equal_jax():
    """test_golden_packets_silence's all-zero input (the dynamic-range
    floor and lossless promotion paths)."""
    pcm = np.zeros((2, 12000), np.float32)
    assert_pair_equal(encode_pair(setup_for(2, 44100, 0.4, 0), pcm))
