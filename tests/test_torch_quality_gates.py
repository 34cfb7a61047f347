"""The corpus gate of tests/test_quality_gates.py on the port: `_gate`
(the same function, bounds and signals) run on the port's
FastEncoder(2, rate, q, device="cpu") against the port's own golden
encoder, vorbis_tpu_torch.encode_vbr_stream, with the stock libvorbis
decoding both streams (tests/oracle.py).  CASES are
test_corpus_gate_rungs_and_rates's four configurations, each on the mix
signal and on quiet-after-loud; this file holds q0.1 at 44.1 kHz, and
test_torch_quality_gates_mix.py, _qal.py, _32k.py and _51.py the rest
and the 5.1 relative gate (each file stays under about 60 s alone).

Bounds (test_quality_gates.py:67-101): RMS error below rms_ratio times
the golden stream's (1.2 at q0.1, 1.1 at q0.8, 1.1 at 16 kHz, 1.3 at
32 kHz), segmental SNR within 2 dB of it, size ratio in [0.65, 1.2];
5.1: error below 1.3 times, size ratio in [0.65, 1.25].  Each test
prints its measured ratios (pytest -s)."""

import pytest
import torch

import tests.test_quality_gates as QG
from chip_smoke import GATES
from tests import oracle
from vorbis_tpu_torch import encode_vbr_stream
from vorbis_tpu_torch.models.fastenc import FastEncoder

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

CASES = [g + (kind,) for g in GATES for kind in ("mix", "qal")]


@pytest.fixture
def port_golden(monkeypatch):
    """_gate's golden encoder is the port's own."""
    monkeypatch.setattr(QG, "encode_vbr_stream", encode_vbr_stream)


@pytest.fixture(scope="module")
def encoders():
    """(q, rate) -> FastEncoder(2, rate, q, device="cpu"), one a
    configuration in a file, as test_corpus_gate_rungs_and_rates uses
    one for both signals."""
    done = {}

    def get(q, rate):
        if (q, rate) not in done:
            done[q, rate] = FastEncoder(2, rate, q, device="cpu")
        return done[q, rate]
    return get


def run_gate(tmp_path, fe, q, rate, rms_ratio, kind):
    """_gate of `fe` on the mix signal or on quiet-after-loud, as
    test_corpus_gate_rungs_and_rates runs it; returns (rms ratio, SNR
    delta)."""
    pcm = (oracle.make_test_signal(rate=rate, kind="mix") if kind == "mix"
           else QG._quiet_after_loud(rate))
    got = QG._gate(tmp_path, fe, pcm, rate, q, f"{kind} q{q}@{rate}",
                   rms_ratio=rms_ratio)
    print(f"[gate] {kind} q{q}@{rate}: rms ratio {got[0]:.4f} (bound "
          f"{rms_ratio}), SNR delta {got[1]:+.3f} dB")
    return got


def test_cases_are_test_quality_gates_and_cover_all():
    """GATES (chip_smoke.py phase 8's) are the (q, rate, rms_ratio) of
    test_corpus_gate_rungs_and_rates, and this file's CASES with those
    of test_torch_quality_gates_mix.py, _qal.py and _32k.py cover every
    (case, signal) once."""
    from tests import (test_torch_quality_gates_32k as F32,
                       test_torch_quality_gates_mix as FM,
                       test_torch_quality_gates_qal as FQ)
    marks = QG.test_corpus_gate_rungs_and_rates.pytestmark
    cases = next(m.args[1] for m in marks if m.name == "parametrize")
    assert [tuple(c) for c in cases] == GATES
    assert sorted(HERE + FM.HERE + FQ.HERE + F32.HERE) == sorted(CASES)


def test_chip_smoke_copies_equal_the_test_helpers():
    """Phase 8 runs on a machine without the system libvorbis, so
    chip_smoke.py carries copies of make_test_signal, _quiet_after_loud
    and _seg_snr: equal to the originals, bit for bit."""
    import numpy as np
    import chip_smoke as C
    for kw in ({}, {"rate": 16000}, {"rate": 48000, "seconds": 0.6,
                                     "ch": 6}, {"seconds": 0.3}):
        assert np.array_equal(C._make_test_signal(**kw),
                              oracle.make_test_signal(**kw))
    for rate in (16000, 32000, 44100):
        assert np.array_equal(C._quiet_after_loud(rate),
                              QG._quiet_after_loud(rate))
    x = oracle.make_test_signal(seconds=0.5)
    y = x + np.random.RandomState(0).randn(*x.shape).astype(np.float32) * 0.01
    assert C._seg_snr(x, y) == QG._seg_snr(x, y)


HERE = CASES[:2]


@pytest.mark.parametrize("q,rate,rms_ratio,kind", HERE)
def test_corpus_gate(tmp_path, port_golden, encoders, q, rate, rms_ratio,
                     kind):
    run_gate(tmp_path, encoders(q, rate), q, rate, rms_ratio, kind)
