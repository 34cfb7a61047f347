"""Whole streams from the port's encoder (vorbis_tpu_torch FastEncoder,
long-only slices, stateless and with the cross-frame psy state) on the
CPU: the stock libvorbis decodes them to the exact input length, the
quality gate of tests/test_fastenc.py:37 holds, block switching runs on
every entry point, 5.1 encodes, and managed 5.1, which the JAX package
lacks, raises NotImplementedError.  No
JAX on this side: the packet-level comparisons with the JAX package are
tests/test_torch_encode.py (stateless) and test_torch_psystate.py."""

import copy

import numpy as np
import pytest
import torch

from tests import oracle
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE

# The suite runs under pytest-xdist with several workers to the host's
# cores; one torch thread a worker keeps torch's OpenMP pools from
# oversubscribing them (the port's test files took 672 s with 6 workers
# on 8 cores at torch's default, 70 s at one thread).
torch.set_num_threads(1)


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


@pytest.fixture(scope="module")
def stateful():
    return TFE(2, 44100, 0.5, switching=False, device="cpu")


@pytest.fixture(scope="module")
def tonal(tmp_path_factory):
    """Steady tonal content and the golden encoder's RMS error on it."""
    from vorbis_tpu.codec.encoder import encode_vbr_stream
    t = np.arange(44100) / 44100
    pcm = np.stack([
        0.4 * np.sin(2 * np.pi * 440 * t)
        + 0.2 * np.sin(2 * np.pi * 1873 * t),
        0.4 * np.sin(2 * np.pi * 523 * t)
        + 0.2 * np.sin(2 * np.pi * 2093 * t)]).astype(np.float32)
    pg = str(tmp_path_factory.mktemp("golden") / "g.ogg")
    with open(pg, "wb") as f:
        f.write(encode_vbr_stream(pcm, 44100, 0.5))
    gg, _ = oracle.decode_float(pg)
    return pcm, np.sqrt(np.mean((gg - pcm[:, :gg.shape[1]]) ** 2))


def _rms_error(fe, pcm, path):
    with open(path, "wb") as f:
        f.write(fe.encode(pcm))
    gf, _ = oracle.decode_float(path)
    assert gf.shape == pcm.shape
    return np.sqrt(np.mean((gf - pcm) ** 2))


def test_quality_on_tonal_content(tfe, tonal, tmp_path):
    """tests/test_fastenc.py:37's gate for the port: on steady tonal
    content the stream is within 1.2x the golden encoder's RMS error."""
    pcm, eg = tonal
    ef = _rms_error(tfe, pcm, str(tmp_path / "f.ogg"))
    assert ef < 1.2 * eg, (ef, eg)


def test_stateful_quality_on_tonal_content(stateful, tonal, tmp_path):
    """The same gate for the default encoder, whose encode runs the
    two-phase pipeline (encode_batch at B_long=1024) with the
    cross-frame psy state (measured: 0.00315 against the golden
    0.00302)."""
    pcm, eg = tonal
    stateful.last_profile = None
    ef = _rms_error(stateful, pcm, str(tmp_path / "s.ogg"))
    assert stateful.last_profile.keys() == {
        "probe_dispatch", "probe_wait", "host_midpass", "finish"}
    print(f"RMS error stateful {ef:.6g}, golden {eg:.6g}")
    assert ef < 1.2 * eg, (ef, eg)


def test_stateful_encode_input_kinds_agree(stateful):
    """Host int16 and a tensor give the same stateful stream, which
    the port's own decoder reads to the exact length."""
    from vorbis_tpu_torch.codec.decoder import decode_ogg
    pcm = oracle.make_test_signal(seconds=0.7)
    p16 = np.clip(np.rint(pcm * 32767), -32768, 32767).astype(np.int16)
    ogg = stateful.encode_batch([p16], B_long=64)[0]
    assert ogg == stateful.encode_batch([torch.from_numpy(p16)],
                                        B_long=64)[0]
    out, _ = decode_ogg(ogg)
    assert out.shape == pcm.shape and np.isfinite(out).all()


def test_stateful_single_blocksize_template(tmp_path):
    """8 kHz mono has one block size: every frame runs the short-mode
    psy state (ntfix_short, no M9); the stock libvorbis reads the
    stream to the exact length (tests/test_fastenc.py:150's template)."""
    fe = TFE(1, 8000, 0.2, switching=False, device="cpu")
    assert fe.W_main == 0
    pcm = oracle.make_test_signal(rate=8000, seconds=0.5, ch=1)
    path = str(tmp_path / "s8k.ogg")
    with open(path, "wb") as f:
        f.write(fe.encode(pcm))
    got, rate = oracle.decode_float(path)
    assert rate == 8000 and got.shape == pcm.shape
    assert np.isfinite(got).all()


def test_unported_paths_raise(tfe, stateful):
    """Block switching (§1.7) runs on every entry point, stateless and
    stateful, managed bitrate (§1.9) builds an encoder, and the 5.1
    layouts (§1.10) encode; managed 5.1, which the JAX package lacks
    (its managed finish has no multi-submap branch), raises
    NotImplementedError naming that gap."""
    pcm = np.zeros((2, 4410), np.float32)
    switching = copy.copy(stateful)
    switching.switching = True
    for ogg in (stateful.encode(pcm, switching=True),
                tfe.encode_batch([pcm], switching=True, B_long=64,
                                 B_short=64)[0],
                switching.encode_batch([pcm], B_long=64, B_short=64)[0]):
        assert ogg[:4] == b"OggS"
    fm = TFE(2, 44100, bitrate=(192000, 128000, 64000), device="cpu")
    assert fm.managed and fm.setup.hi.bitrate_av == 128000
    # stateless: the stateful encode pads its one batch to 1024 frames
    # of six channels (20 s on one CPU thread); tests/test_torch_51*.py
    # hold the stateful and switched 5.1 paths to the JAX package
    ogg = TFE(6, 48000, 0.4, switching=False, psy_state=False,
              device="cpu").encode(np.zeros((6, 4800), np.float32))
    assert ogg[:4] == b"OggS"
    f51 = TFE(6, 48000, bitrate=(-1, 320000, -1), device="cpu")
    with pytest.raises(NotImplementedError, match="multi-submap"):
        f51.encode(np.zeros((6, 4800), np.float32))


def test_managed_encoder_builds_and_encodes():
    """TFE(2, 44100, bitrate=...) on the CPU: the managed setup (its own
    books and a reservoir of twice the nominal rate), and encode routes
    to encode_managed; an unmanaged encoder refuses encode_managed_batch."""
    fm = TFE(2, 44100, bitrate=(-1, 128000, -1), device="cpu")
    hi = fm.setup.hi
    assert (hi.bitrate_av, hi.bitrate_reservoir) == (128000, 256000)
    assert fm.switching and fm.psy_state
    pcm = np.zeros((2, 4410), np.float32)
    ogg = fm.encode(pcm, switching=False)
    assert ogg == fm.encode_managed(pcm, switching=False)
    assert ogg[:4] == b"OggS"
    with pytest.raises(ValueError, match="bitrate"):
        TFE(2, 44100, 0.5, switching=False,
            device="cpu").encode_managed_batch([pcm])
