"""The corpus gate of tests/test_quality_gates.py on the port: quiet-
after-loud at q0.8 (lossless stereo coupling) and at 16 kHz (the
512/1024 blocksizes, hsrate psy off), against the port's own golden
encoder; see test_torch_quality_gates.py for the bounds."""

import pytest
import torch

from tests.test_torch_quality_gates import (  # noqa: F401 (fixtures)
    CASES, encoders, port_golden, run_gate)

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

# q0.8 at 44.1 kHz and q0.5 at 16 kHz
HERE = [c for c in CASES[2:6] if c[3] == "qal"]


@pytest.mark.parametrize("q,rate,rms_ratio,kind", HERE)
def test_corpus_gate(tmp_path, port_golden, encoders, q, rate, rms_ratio,
                     kind):
    run_gate(tmp_path, encoders(q, rate), q, rate, rms_ratio, kind)
