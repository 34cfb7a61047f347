"""The port's golden encoder against the JAX package's on the 5.1 rows
of tests/test_encoder.py's GOLDEN_MATRIX (44.1 and 48 kHz, 0.2 s):
the multi-submap mapping, the LFE's floor and the chained coupling of
the scalar path.  Exact: packets, header packets, bit_stats
(tests/golden_pair.py)."""

import pytest
import torch

from tests import oracle
from tests.golden_pair import assert_pair_equal, encode_pair, setup_for
from tests.test_encoder import GOLDEN_MATRIX

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

ROWS = [r for r in GOLDEN_MATRIX if r[0] == 6]


@pytest.mark.parametrize("ch,rate,q,kbps,secs", ROWS)
def test_golden_packets_equal_jax(ch, rate, q, kbps, secs):
    pcm = oracle.make_test_signal(rate=rate, seconds=secs, ch=ch)
    assert_pair_equal(encode_pair(setup_for(ch, rate, q, kbps), pcm))
