"""The port's scalar golden encoder (vorbis_tpu_torch.codec.encoder, a
line-aligned copy of vorbis_tpu/codec/encoder.py and the host modules it
runs) against the JAX package's, on the rows of
tests/test_encoder.py's GOLDEN_MATRIX with the same clips: the VBR
rows in mono (8-22.05 kHz) and in stereo at 44.1 kHz here, the other
rows in test_torch_golden_rates.py, test_torch_golden_51.py and
test_torch_golden_managed.py (each file stays under about 60 s alone).
Both sides run in this process on the same numpy input; every packet's
payload, granulepos and EOS flag, the header packets and bit_stats must
be equal, exactly.  Also: bit accounting port against port (the
encoder's bit_stats against the port decoder's)."""

import pytest
import torch

from tests import oracle
from tests.golden_pair import assert_pair_equal, encode_pair, setup_for
from tests.test_encoder import GOLDEN_MATRIX

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

# GOLDEN_MATRIX's VBR rows in mono, and in stereo at 44.1 kHz
ROWS = [r for r in GOLDEN_MATRIX if not r[3]
        and (r[0] == 1 or (r[0] == 2 and r[1] == 44100))]


@pytest.fixture(scope="module")
def pairs():
    """GOLDEN_MATRIX row -> encode_pair of its clip, each row encoded once
    in this file (test_bit_usage_accounting reads the first row's)."""
    done = {}

    def get(ch, rate, q, kbps, secs):
        key = (ch, rate, q, kbps, secs)
        if key not in done:
            pcm = oracle.make_test_signal(rate=rate, seconds=secs, ch=ch)
            done[key] = encode_pair(setup_for(ch, rate, q, kbps), pcm)
        return done[key]
    return get


def test_rows_cover_the_matrix():
    """This file's rows, test_torch_golden_rates.py's,
    test_torch_golden_51.py's and test_torch_golden_managed.py's are
    GOLDEN_MATRIX, each row once."""
    from tests.test_torch_golden_51 import ROWS as R51
    from tests.test_torch_golden_managed import ROWS as RM
    from tests.test_torch_golden_rates import ROWS as RR
    assert sorted(ROWS + RR + R51 + RM) == sorted(GOLDEN_MATRIX)
    assert len(ROWS) == 5


@pytest.mark.parametrize("ch,rate,q,kbps,secs", ROWS)
def test_golden_packets_equal_jax(pairs, ch, rate, q, kbps, secs):
    assert_pair_equal(pairs(ch, rate, q, kbps, secs))


def test_bit_usage_accounting(pairs):
    """tests/test_encoder.py test_bit_usage_accounting, port against
    port: the glue/floor/res counters of the port's encoder equal the
    port decoder's (codec/decoder.py) on the same stream (GOLDEN_MATRIX's
    first row: 0.3 s stereo, q0.4)."""
    from vorbis_tpu_torch.codec import headers as H
    from vorbis_tpu_torch.codec.decoder import Decoder
    assert GOLDEN_MATRIX[0] == (2, 44100, 0.4, 0, 0.30)
    _, (enc, pkts) = pairs(*GOLDEN_MATRIX[0])
    st = enc.bit_stats
    assert st["packets"] == len(pkts)
    assert st["res_bits"] > st["floor_bits"] > 0
    total = st["glue_bits"] + st["floor_bits"] + st["res_bits"]
    assert total <= st["packet_bits"]
    dec = Decoder(H.parse_headers(list(enc.header_packets())))
    for data, gp, eos in pkts:
        dec.decode_packet(data, gp, eos)
    for k in ("packets", "glue_bits", "floor_bits", "res_bits"):
        assert dec.bit_stats[k] == st[k], k
