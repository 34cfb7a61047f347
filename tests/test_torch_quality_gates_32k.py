"""The corpus gate of tests/test_quality_gates.py on the port at 32 kHz
(the lowest hsrate: the gate's one open tuning gap), on the mix signal
and on quiet-after-loud, against the port's own golden encoder; see
test_torch_quality_gates.py for the bounds."""

import pytest
import torch

from tests.test_torch_quality_gates import (  # noqa: F401 (fixtures)
    CASES, encoders, port_golden, run_gate)

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)

HERE = [c for c in CASES if c[1] == 32000]


@pytest.mark.parametrize("q,rate,rms_ratio,kind", HERE)
def test_corpus_gate(tmp_path, port_golden, encoders, q, rate, rms_ratio,
                     kind):
    run_gate(tmp_path, encoders(q, rate), q, rate, rms_ratio, kind)
