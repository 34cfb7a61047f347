"""The port stands alone: its package and chip_smoke.py import neither jax
nor the JAX package vorbis_tpu, and a process in which both imports fail
can still encode with the port on the CPU (stateless, the default
encoder with block switching and the cross-frame psy state, and managed
ABR) and decode with the port's own decoders, the fast decode and the
`ov_*` layer among them (the GPU machine has no JAX), and run a sharded
roundtrip of the pipeline; the test files that hold the card tests
import in such a process too, and so do the package's exports of its
encoders (`FastEncoder`, the golden `encode_vbr_stream`).  The encoder,
the fast decode, the pipeline, the mesh and LBG training run on the
card unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from vorbis_tpu_torch.models.fastenc import FastEncoder as FastEncoderT

# The suite runs under pytest-xdist with several workers to the host's
# cores; one torch thread a worker keeps torch's OpenMP pools from
# oversubscribing them (the port's test files took 672 s with 6 workers
# on 8 cores at torch's default, 70 s at one thread).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import sys
preloaded = {{m for m in sys.modules if m == "jax" or m.startswith("jax.")}}
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["vorbis_tpu"] = None   # and so does `import vorbis_tpu...`
sys.path.insert(0, {root!r})
import numpy as np
from vorbis_tpu_torch.codec.decoder import decode_ogg
from vorbis_tpu_torch.models.fastenc import FastEncoder
fe = FastEncoder(2, 44100, 0.5, switching=False, psy_state=False,
                 device="cpu")
t = np.arange(8820) / 44100
pcm = np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                0.3 * np.sin(2 * np.pi * 660 * t)]).astype(np.float32)
out, vi = decode_ogg(fe.encode(pcm))
assert out.shape == pcm.shape, out.shape
assert np.isfinite(out).all()
# the default encoder: block switching and the cross-frame psy state
fs = FastEncoder(2, 44100, 0.5, device="cpu")
assert fs.switching and fs.psy_state
out, vi = decode_ogg(fs.encode(pcm))
assert out.shape == pcm.shape, out.shape
assert np.isfinite(out).all()
# managed ABR (ops/managed.py), on the long-only path: it imports every
# module of the switched managed path but the envelope, run above
fm = FastEncoder(2, 44100, bitrate=(-1, 128000, -1), device="cpu")
ogg = fm.encode_managed(pcm, switching=False)
out, vi = decode_ogg(ogg)
assert out.shape == pcm.shape, out.shape
# the fast decode: the host-C drain and the staged plain IMDCT
from vorbis_tpu_torch import decode_ogg_fast
for device in (False, "cpu"):
    fast, _ = decode_ogg_fast(ogg, device=device)
    assert np.array_equal(fast, out), device
# the ov_* layer (vorbisfile.py): the whole-link drain and chunked reads
from vorbis_tpu_torch import OggVorbisFile
vf = OggVorbisFile(ogg, device="cpu")
assert np.array_equal(vf.read_all_float(), out)
vf.pcm_seek(1000)
assert np.array_equal(vf.read_float(4096), out[:, 1000:5096])
# the roundtrip pipeline, sharded over a mesh that repeats the CPU, and
# the modules of the dry run and VQ training
import torch
import vorbis_tpu_torch.graft
import vorbis_tpu_torch.vq
from vorbis_tpu_torch.models.pipeline import TorchCodecPipeline
from vorbis_tpu_torch.parallel import make_codec_mesh, sharded_roundtrip_step
pipe = TorchCodecPipeline(2, 44100, 0.5, device="cpu")
frames = np.random.RandomState(0).randn(1, 2, 4, pipe.n).astype(np.float32)
mesh = make_codec_mesh(devices=[torch.device("cpu")] * 2)
pcm, err = sharded_roundtrip_step(pipe, mesh)(frames)
want, want_err = pipe.roundtrip_step(frames)
assert torch.equal(pcm, want) and pcm.shape == (1, 2, 2 * pipe.n), pcm.shape
assert abs(float(err) - float(want_err)) <= 1e-6 * float(want_err)
bad = sorted(m for m in sys.modules if m.startswith("jax.")
             and m not in preloaded)
assert not bad, bad
ref = sorted(m for m in sys.modules if m.startswith("vorbis_tpu.")
             and sys.modules[m] is not None)
assert not ref, ref
print("ok", out.shape)
"""


def test_port_runs_without_jax():
    r = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "JAX_PLATFORMS": "cpu",
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().endswith("ok (2, 8820)"), r.stdout


def test_port_sources_never_import_jax():
    """Neither jax nor vorbis_tpu (vorbis_tpu_torch is the port)."""
    pat = re.compile(r"^\s*(import|from) (jax|vorbis_tpu)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "vorbis_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    hits = [f for f in files if pat.search(open(f).read())]
    assert not hits, hits
    assert pat.search("from vorbis_tpu.codec import x\n")
    assert pat.search("import vorbis_tpu\n")
    assert not pat.search("from vorbis_tpu_torch.codec import x\n")


def test_fast_encoder_defaults_to_the_card():
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    if torch.cuda.is_available():
        fe = FastEncoder(2, 44100, 0.5, switching=False, psy_state=False)
        assert fe.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FastEncoder(2, 44100, 0.5, switching=False, psy_state=False)


def test_fast_decoder_defaults_to_the_card():
    """decode_ogg_fast, decode_ogg_fast_batch and the ov_* layer
    (OggVorbisFile, decode_file) run the IMDCT on the card unless asked
    otherwise: with no card the default raises and names device="cpu";
    the CPU is never taken silently."""
    from tests import oracle
    from vorbis_tpu_torch.models.fastdec import (decode_ogg_fast,
                                                 decode_ogg_fast_batch)
    from vorbis_tpu_torch.ops.imdct_cuda import imdct
    from vorbis_tpu_torch.vorbisfile import OggVorbisFile, decode_file
    fe = FastEncoderT(2, 44100, 0.5, switching=False, psy_state=False,
                      device="cpu")
    ogg = fe.encode(oracle.make_test_signal(seconds=0.3))
    want, _ = decode_ogg_fast(ogg, device=False)
    if torch.cuda.is_available():
        before = imdct.launches
        got, _ = decode_ogg_fast(ogg)
        assert imdct.launches > before
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert OggVorbisFile(ogg)._fast.device.type == "cuda"
        return
    for call in (lambda: decode_ogg_fast(ogg),
                 lambda: decode_ogg_fast(ogg, device=True),
                 lambda: decode_ogg_fast_batch([ogg, ogg]),
                 lambda: OggVorbisFile(ogg),
                 lambda: decode_file(ogg)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_pipeline_mesh_and_lbg_default_to_the_card():
    """TorchCodecPipeline, make_codec_mesh and lbg_train take the card
    by default: with no card each raises and names the way to the CPU,
    and the mesh takes no CPU in its place."""
    from vorbis_tpu_torch.models.pipeline import TorchCodecPipeline
    from vorbis_tpu_torch.parallel import make_codec_mesh
    from vorbis_tpu_torch.vq import lbg_train
    pts = np.random.RandomState(0).randn(64, 2).astype(np.float32)
    if torch.cuda.is_available():
        assert TorchCodecPipeline().device.type == "cuda"
        mesh = make_codec_mesh()
        assert mesh.size == torch.cuda.device_count()
        assert all(d.type == "cuda" for d in mesh.flat)
        with pytest.raises(RuntimeError, match="devices asked for"):
            make_codec_mesh(torch.cuda.device_count() + 1)
        lbg_train(pts, 4, iters=4)
        return
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TorchCodecPipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_codec_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_codec_mesh(4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lbg_train(pts, 4, iters=4)


CARD_PROBE = r"""
import importlib.util, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["vorbis_tpu"] = None   # and so does `import vorbis_tpu...`
sys.path.insert(0, {root!r})
for path in {paths!r}:
    spec = importlib.util.spec_from_file_location("card_tests", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("ok", len({paths!r}))
"""


def test_card_test_files_import_without_jax():
    """Every tests/test_torch_*.py that holds a card test (`*_on_cuda`)
    imports in a process where jax and vorbis_tpu cannot be imported:
    the GPU machine, where those tests run, has no JAX."""
    tests = os.path.join(ROOT, "tests")
    pat = re.compile(r"^def test_\w*_on_cuda\(", re.M)
    paths = sorted(
        os.path.join(tests, n) for n in os.listdir(tests)
        if n.startswith("test_torch_") and n.endswith(".py")
        and pat.search(open(os.path.join(tests, n)).read()))
    assert os.path.join(tests, "test_torch_cuda.py") in paths
    r = subprocess.run([sys.executable, "-c",
                        CARD_PROBE.format(root=ROOT, paths=paths)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip() == f"ok {len(paths)}", r.stdout


EXPORTS = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["vorbis_tpu"] = None   # and so does `import vorbis_tpu...`
sys.path.insert(0, {root!r})
import vorbis_tpu_torch
from vorbis_tpu_torch.codec.encoder import encode_vbr_stream
from vorbis_tpu_torch.models.fastenc import FastEncoder
assert vorbis_tpu_torch.encode_vbr_stream is encode_vbr_stream
assert vorbis_tpu_torch.FastEncoder is FastEncoder
assert "encode_vbr_stream" in vorbis_tpu_torch.__doc__
assert "FastEncoder" in vorbis_tpu_torch.__doc__
import numpy as np     # and the golden encoder runs (its lazy imports)
t = np.arange(4000) / 8000
ogg = encode_vbr_stream(np.sin(2 * np.pi * 440 * t)[None].astype(np.float32),
                        8000, 0.2)
assert ogg[:4] == b"OggS" and len(ogg) > 3000, len(ogg)
bad = sorted(m for m in sys.modules if (m == "jax" or m.startswith("jax.")
             or m.startswith("vorbis_tpu.")) and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def test_package_exports_golden_and_fast_encoders():
    """vorbis_tpu_torch.encode_vbr_stream and vorbis_tpu_torch.FastEncoder
    resolve (as vorbis_tpu exports them), and the golden encoder encodes,
    in a process where jax and vorbis_tpu cannot be imported."""
    r = subprocess.run([sys.executable, "-c", EXPORTS.format(root=ROOT)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip() == "ok", r.stdout
