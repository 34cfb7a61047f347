"""The port's golden encoder against the JAX package's through
OV_ECTL_RATEMANAGE2_SET: tests/test_encoder.py
test_golden_packets_ratemanage2_vbr_to_managed's conversion of a VBR
setup (q0.4) to managed ABR 128 kbps before init, on 0.3 s of the mix
signal.  Exact: packets, header packets, bit_stats
(tests/golden_pair.py)."""

import torch

from tests import oracle
from tests.golden_pair import assert_pair_equal, encode_pair

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)


def test_ratemanage2_vbr_to_managed_equal_jax():
    def make(S):
        b = S.setup_vbr_staged(2, 44100, 0.4)
        b.ctl_ratemanage2_set({
            "management_active": True,
            "bitrate_limit_min_kbps": -1,
            "bitrate_limit_max_kbps": -1,
            "bitrate_average_kbps": 128,
            "bitrate_average_damping": 1.4,
            "bitrate_limit_reservoir_bits": 131072,
            "bitrate_limit_reservoir_bias": 0.2,
        })
        return b.init()
    pair = encode_pair(make, oracle.make_test_signal(seconds=0.3))
    assert pair[1][0].managed
    assert_pair_equal(pair)
