"""The port's golden encoder against the JAX package's on
tests/test_encoder.py GOLDEN_MATRIX's ABR row (128 kbps, q0.0, 0.3 s),
and encode_vbr_stream's Ogg bytes with comments=, held to the digests
chip_smoke.py pins for its phase 8 (the stream's and each stage's that
utils/analysis_dump.py dumps).  Exact: packets, header packets,
bit_stats (tests/golden_pair.py), Ogg bytes."""

import pytest
import torch

import chip_smoke
from tests import oracle
from tests.golden_pair import assert_pair_equal, encode_pair, setup_for
from tests.test_encoder import GOLDEN_MATRIX

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

ROWS = [r for r in GOLDEN_MATRIX if r[3]]


@pytest.mark.parametrize("ch,rate,q,kbps,secs", ROWS)
def test_golden_packets_equal_jax(ch, rate, q, kbps, secs):
    pcm = oracle.make_test_signal(rate=rate, seconds=secs, ch=ch)
    assert_pair_equal(encode_pair(setup_for(ch, rate, q, kbps), pcm))


def test_encode_vbr_stream_bytes_and_pinned_digests(tmp_path):
    """encode_vbr_stream(pcm, 44100, 0.4, comments=...) gives the same Ogg
    bytes in both packages, and those are the stream chip_smoke.py pins
    (GOLDEN_SHA256); each analysis stage's dump is equal too, and equal
    to GOLDEN_STAGE_SHA256, so a chip run whose stream differs can name
    the first stage that moved."""
    import vorbis_tpu.codec.encoder as J
    import vorbis_tpu.utils.analysis_dump as J_dump
    import vorbis_tpu_torch.codec.encoder as T
    import vorbis_tpu_torch.utils.analysis_dump as T_dump
    want = chip_smoke._golden_digests(J.encode_vbr_stream, J_dump,
                                      str(tmp_path / "jax"))
    got = chip_smoke._golden_digests(T.encode_vbr_stream, T_dump,
                                     str(tmp_path / "port"))
    assert got == want
    assert want == (chip_smoke.GOLDEN_SHA256, chip_smoke.GOLDEN_STAGE_SHA256)
    assert chip_smoke._first_stage_differing(got[1]) is None
    assert len(got[1]) == 8
    moved = dict(got[1], noise_ch1="0", tone_ch0="0")
    assert chip_smoke._first_stage_differing(moved) == "noise_ch1"
    # and the comments land in the stream
    import vorbis_tpu_torch.bitstream.oggfile as O
    pkts = [p for p, _, _ in O.OggStreamReader(
        T.encode_vbr_stream(chip_smoke._make_test_signal(seconds=0.05),
                            44100, 0.4,
                            comments=list(chip_smoke.GOLDEN_COMMENTS)))
            .packets()]
    assert all(c.encode() in pkts[1] for c in chip_smoke.GOLDEN_COMMENTS)
