"""The 5.1 relative gate of tests/test_quality_gates.py on the port:
FastEncoder(6, 48000, 0.4, device="cpu") against the port's own golden
encoder, both streams decoded by the stock libvorbis.  The golden
stream (about 25 s of one core) runs in a spawned child process while
the fast encoder runs in this one, which keeps the file under about
60 s alone."""

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from tests import oracle
from tests.test_quality_gates import _decode
from vorbis_tpu_torch import encode_vbr_stream
from vorbis_tpu_torch.models.fastenc import FastEncoder

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)


def test_51_gate_relative_to_golden(tmp_path):
    """test_quality_gates.py test_51_gate_relative_to_golden on the port:
    0.6 s, 48 kHz, q0.4; error below 1.3 times the golden stream's, size
    ratio in [0.65, 1.25]."""
    rate = 48000
    pcm = oracle.make_test_signal(rate=rate, seconds=0.6, ch=6)
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        golden = ex.submit(encode_vbr_stream, pcm, rate, 0.4)
        f = FastEncoder(6, rate, 0.4, device="cpu").encode(pcm)
        g = golden.result()
    df = _decode(tmp_path, "f6.ogg", f)
    dg = _decode(tmp_path, "g6.ogg", g)
    m = min(df.shape[1], dg.shape[1], pcm.shape[1])
    ef = np.sqrt(np.mean((df[:, :m] - pcm[:, :m]) ** 2))
    eg = np.sqrt(np.mean((dg[:, :m] - pcm[:, :m]) ** 2))
    print(f"[gate] 5.1: rms ratio {ef / eg:.4f}, size ratio "
          f"{len(f) / len(g):.4f}")
    assert ef < 1.3 * eg, (ef, eg)
    assert 0.65 <= len(f) / len(g) <= 1.25, (len(f), len(g))
