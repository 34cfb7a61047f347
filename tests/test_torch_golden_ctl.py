"""The port's golden encoder against the JAX package's through the
vorbis_encode_ctl paths: tests/test_encoder.py's four CTL_MATRIX cases
(lowpass, impulse noisetune, coupling toggle, applied between setup and
init through setup_vbr_staged(...).ctl_*_set): the first two here,
the other two in test_torch_golden_ctl2.py (each file stays under
about 60 s alone); test_torch_golden_ratemanage.py holds
ctl_ratemanage2_set.  Exact: packets, header packets, bit_stats
(tests/golden_pair.py)."""

import pytest
import torch

from tests import oracle
from tests.golden_pair import assert_pair_equal, encode_pair
from tests.test_encoder import CTL_MATRIX

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)


def _staged(ctl):
    def make(S):
        b = S.setup_vbr_staged(2, 44100, 0.4)
        if "lowpass" in ctl:
            b.ctl_lowpass_set(ctl["lowpass"])
        if "iblock" in ctl:
            b.ctl_iblock_set(ctl["iblock"])
        if "coupling" in ctl:
            b.ctl_coupling_set(bool(ctl["coupling"]))
        return b.init()
    return make


HERE = CTL_MATRIX[:2]


def test_files_cover_ctl_matrix():
    from tests.test_torch_golden_ctl2 import HERE as HERE2
    assert HERE + HERE2 == CTL_MATRIX


def run_ctl(ctl):
    """test_golden_packets_with_ctl's input (0.3 s of the mix signal,
    stereo, 44.1 kHz, q0.4) and ctl calls, on both packages."""
    pcm = oracle.make_test_signal(seconds=0.3)
    assert_pair_equal(encode_pair(_staged(ctl), pcm))


@pytest.mark.parametrize("ctl", HERE, ids=[",".join(c) for c in HERE])
def test_golden_packets_with_ctl_equal_jax(ctl):
    run_ctl(ctl)
