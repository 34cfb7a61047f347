"""Shared by tests/test_torch_golden*.py: one encode through the JAX
package's scalar golden encoder (vorbis_tpu.codec.encoder.Encoder) and
one through the port's line-aligned copy (vorbis_tpu_torch.codec.encoder),
in this process, on the same numpy input.  Both are host numpy; neither
runs JAX.

The comparison is exact: every packet's payload, granulepos and EOS
flag, the three header packets and the encoder's bit_stats."""

import numpy as np

import vorbis_tpu.codec.encoder as J_enc
import vorbis_tpu.models.encsetup as J_setup
import vorbis_tpu_torch.codec.encoder as T_enc
import vorbis_tpu_torch.models.encsetup as T_setup

SIDES = ((J_enc, J_setup), (T_enc, T_setup))


def run(enc, pcm):
    """write, end_of_stream, pump: the packets as (data, granulepos,
    eos) tuples."""
    enc.write(pcm)
    enc.end_of_stream()
    return [(p.data, p.granulepos, bool(p.eos)) for p in enc.pump()]


def encode_pair(make_setup, pcm):
    """make_setup(encsetup module) -> EncoderSetup, called once for each
    package; returns [(encoder, packets)] for JAX, then the port."""
    out = []
    for enc_mod, setup_mod in SIDES:
        enc = enc_mod.Encoder(make_setup(setup_mod))
        out.append((enc, run(enc, np.array(pcm, copy=True))))
    return out


def setup_for(ch, rate, q, kbps):
    """GOLDEN_MATRIX's setup: VBR at q, or managed at kbps (min = avg =
    max, as tests/test_encoder.py _my_encode does)."""
    if kbps:
        return lambda S: S.setup_managed(ch, rate, kbps * 1000, kbps * 1000,
                                         kbps * 1000)
    return lambda S: S.setup_vbr(ch, rate, q)


def assert_pair_equal(pair):
    """The port's packets, header packets and bit_stats equal JAX's."""
    (je, jp), (te, tp) = pair
    assert len(tp) == len(jp) > 0, (len(tp), len(jp))
    for i, (a, b) in enumerate(zip(jp, tp)):
        assert a[0] == b[0], f"packet {i} payload differs"
        assert a[1] == b[1], f"packet {i} granulepos differs"
        assert a[2] == b[2], f"packet {i} eos differs"
    assert je.header_packets() == te.header_packets()
    assert je.bit_stats == te.bit_stats
    assert te.bit_stats["packets"] == len(tp)
