"""The port's golden encoder against the JAX package's on the last two
cases of tests/test_encoder.py's CTL_MATRIX (the coupling toggle, and
lowpass with the impulse noisetune); see test_torch_golden_ctl.py."""

import pytest
import torch

from tests.test_encoder import CTL_MATRIX
from tests.test_torch_golden_ctl import run_ctl

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

HERE = CTL_MATRIX[2:]


@pytest.mark.parametrize("ctl", HERE, ids=[",".join(c) for c in HERE])
def test_golden_packets_with_ctl_equal_jax(ctl):
    run_ctl(ctl)
