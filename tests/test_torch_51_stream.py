"""Whole 5.1 streams from the port's encoder (vorbis_tpu_torch
FastEncoder(6, 48000, 0.4).encode_batch) against the JAX package's, both
on the CPU: one switched stream (block switching and the psy state, the
defaults) of a 1 s 5.1 click train and one long-only (switching=False)
stream of 1 s of the 5.1 tones of tests/test_fastenc.py's
test_fast_51_coupled, at B_long = B_short = 64 on both sides, so the
long-only stream reuses the switched stream's JAX step compiles.  The JAX
streams are themselves held to the golden encoder by
tests/test_fastenc.py::test_fast_51_coupled and
tests/test_quality_gates.py::test_51_gate_relative_to_golden.

Tolerances, each with its cause: the stock libvorbis (tests/oracle.py)
decodes every stream to the exact input length (exact); the packets move
where the finish steps move them (tests/test_torch_51.py: the floor
quantization's and fit_line's FMA contraction in XLA:CPU), and the port's
MDCT (a GEMM against the basis) rounds otherwise than JAX's butterfly
(ROADMAP §2.9), so whole streams are held to >= 80% of audio packets
byte-identical, bytes within 2% and an RMS error within 1.05x of JAX's
(measured: 135 of 144 and 44 of 49 packets, bytes within 0.02%, RMS
error equal to 5 digits); the counts are printed.
"""

import numpy as np
import pytest
import torch

from chip_smoke import _click_train51, _signal51
from tests import oracle
from vorbis_tpu.bitstream.oggfile import OggStreamReader
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE

# one torch thread a pytest-xdist worker (see test_torch_switching.py)
torch.set_num_threads(1)

B = 64
RATE = 48000


def _packets(ogg):
    return [p for p, _, _ in OggStreamReader(ogg).packets()][3:]


@pytest.fixture(scope="session")
def streams():
    """{case: (pcm int16, JAX stream, port stream)} for the switched
    click train and the long-only tones."""
    jfe, tfe = JFE(6, RATE, 0.4), TFE(6, RATE, 0.4, device="cpu")
    out = {}
    for case, pcm, sw in (
            ("switched", _click_train51(1.0, RATE, 0), True),
            ("long_only", _signal51(1.0, RATE, 0), False)):
        oj = jfe.encode_batch([pcm], switching=sw, B_long=B, B_short=B)[0]
        ot = tfe.encode_batch([pcm], switching=sw, B_long=B, B_short=B)[0]
        out[case] = (pcm, oj, ot)
    return out


@pytest.mark.parametrize("case", ["switched", "long_only"])
def test_51_stream_against_jax(streams, case, tmp_path):
    pcm, oj, ot = streams[case]
    x = pcm.astype(np.float32) / 32768.0
    rms = {}
    for name, ogg in (("jax", oj), ("port", ot)):
        path = str(tmp_path / f"{name}.ogg")
        with open(path, "wb") as f:
            f.write(ogg)
        got, rate = oracle.decode_float(path)
        assert rate == RATE and got.shape == x.shape
        assert np.isfinite(got).all()
        rms[name] = float(np.sqrt(np.mean((got - x) ** 2)))
    pj, pt = _packets(oj), _packets(ot)
    assert len(pj) == len(pt)
    same = sum(a == b for a, b in zip(pj, pt))
    shorts = [sum(len(p) > 0 and not (p[0] >> 1) & 1 for p in pk)
              for pk in (pj, pt)]
    print(f"5.1 {case}: identical packets {same}/{len(pj)}; bytes "
          f"{len(ot)} vs {len(oj)} (JAX); RMS error {rms['port']:.6f} vs "
          f"{rms['jax']:.6f}; short blocks {shorts[1]} vs {shorts[0]}")
    assert same >= 0.8 * len(pj)
    assert abs(len(ot) - len(oj)) <= 0.02 * len(oj)
    assert rms["port"] <= 1.05 * rms["jax"]
    if case == "switched":
        assert shorts[0] == shorts[1] > 30
