"""Whole streams from the port's encoder (vorbis_tpu_torch FastEncoder,
long-only stateless slice) on the CPU: the stock libvorbis decodes them
to the exact input length, the quality gate of tests/test_fastenc.py:37
holds, and the paths later slices port raise NotImplementedError naming
their ROADMAP item.  No JAX on this side: the slice's packet-level
comparison with the JAX package is tests/test_torch_encode.py."""

import copy

import numpy as np
import pytest
import torch

from tests import oracle
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE


@pytest.fixture(scope="module")
def tfe():
    return TFE(2, 44100, 0.5, switching=False, psy_state=False,
               device="cpu")


def test_stream_decodes_to_exact_length(tfe, tmp_path):
    from vorbis_tpu.vorbisfile import OggVorbisFile
    pcm = oracle.make_test_signal(seconds=1.0)
    ogg = tfe.encode(pcm)
    path = str(tmp_path / "port.ogg")
    with open(path, "wb") as f:
        f.write(ogg)
    got, rate = oracle.decode_float(path)
    assert rate == 44100 and got.shape == pcm.shape
    assert np.isfinite(got).all()
    ours = OggVorbisFile(ogg).read_all_float()
    assert ours.shape == pcm.shape
    # int16 from host and a resident tensor give the same stream
    p16 = np.clip(np.rint(pcm * 32767), -32768, 32767).astype(np.int16)
    assert tfe.encode(p16) == tfe.encode(torch.from_numpy(p16))


def test_quality_on_tonal_content(tfe, tmp_path):
    """tests/test_fastenc.py:37's gate for the port: on steady tonal
    content the stream is within 1.2x the golden encoder's RMS error."""
    from vorbis_tpu.codec.encoder import encode_vbr_stream
    t = np.arange(44100) / 44100
    pcm = np.stack([
        0.4 * np.sin(2 * np.pi * 440 * t)
        + 0.2 * np.sin(2 * np.pi * 1873 * t),
        0.4 * np.sin(2 * np.pi * 523 * t)
        + 0.2 * np.sin(2 * np.pi * 2093 * t)]).astype(np.float32)
    pf = str(tmp_path / "f.ogg")
    pg = str(tmp_path / "g.ogg")
    with open(pf, "wb") as f:
        f.write(tfe.encode(pcm))
    with open(pg, "wb") as f:
        f.write(encode_vbr_stream(pcm, 44100, 0.5))
    gf, _ = oracle.decode_float(pf)
    gg, _ = oracle.decode_float(pg)
    ef = np.sqrt(np.mean((gf - pcm[:, :gf.shape[1]]) ** 2))
    eg = np.sqrt(np.mean((gg - pcm[:, :gg.shape[1]]) ** 2))
    assert ef < 1.2 * eg, (ef, eg)


def test_unported_paths_raise(tfe):
    pcm = np.zeros((2, 4410), np.float32)
    with pytest.raises(NotImplementedError, match="1.7"):
        tfe.encode(pcm, switching=True)
    stateful = copy.copy(tfe)
    stateful.psy_state = True
    with pytest.raises(NotImplementedError, match="1.6"):
        stateful.encode(pcm)
    with pytest.raises(NotImplementedError, match="1.9"):
        TFE(2, 44100, bitrate=(192000, 128000, 64000), device="cpu")
