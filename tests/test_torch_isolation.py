"""The port imports no JAX: its package and chip_smoke.py never name
jax, and a process in which `import jax` fails can still import the
port's encoder and encode on the CPU (the GPU machine has no JAX)."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import sys
preloaded = {{m for m in sys.modules if m == "jax" or m.startswith("jax.")}}
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {root!r})
import numpy as np
from vorbis_tpu_torch.models.fastenc import FastEncoder
from vorbis_tpu.vorbisfile import OggVorbisFile
fe = FastEncoder(2, 44100, 0.5, switching=False, psy_state=False,
                 device="cpu")
t = np.arange(8820) / 44100
pcm = np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                0.3 * np.sin(2 * np.pi * 660 * t)]).astype(np.float32)
out = OggVorbisFile(fe.encode(pcm)).read_all_float()
assert out.shape == pcm.shape, out.shape
bad = sorted(m for m in sys.modules if m.startswith("jax.")
             and m not in preloaded)
assert not bad, bad
print("ok", out.shape)
"""


def test_port_runs_without_jax():
    r = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().endswith("ok (2, 8820)"), r.stdout


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "vorbis_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    hits = [f for f in files if pat.search(open(f).read())]
    assert not hits, hits
