"""The port's chunked fast decode (vorbis_tpu_torch.models.fastdec
FastStreamDecoder) against the JAX package's on the same bytes, on the
CPU, bitwise (float32 by bit pattern): the cases of
tests/test_faststream.py, each through both devices the CPU has,
device="cpu" (the staged chunk: host-C parse, the IMDCT and the lap's
plain versions, the previous chunk's lap tail as the lap's initial
values) and device=False (the JAX package's fused host-C chunk).

The lap kernel (csrc/lap.cu) cannot run here, so the staged chunk is
also run with the kernel's span ownership replayed in numpy
(tests/test_torch_lap.py `lap_replay`) in place of the plain lap: the
kernel starts the samples of the carried tail from it and every other
sample from +0, which gives the JAX chunk's sum into its carried tail.

Streams come from the stock libvorbis (tests/oracle.py encode_vbr), so
no JAX is imported and nothing compiles.  The JAX package's chunk fails
(numpy broadcast ValueError) when a chunk of one to three packets holds
a short block after a long one: its output buffer does not cover the
long block's tail.  For those feed sizes the test holds the port's
device=False to the same error and device="cpu" to the JAX package's
whole-stream decode of the same bytes.
"""

import numpy as np
import pytest
import torch

from tests import oracle
from tests.test_torch_lap import lap_replay
from vorbis_tpu.codec import headers as J_H
from vorbis_tpu.models import fastdec as J_fd
from vorbis_tpu_torch.bitstream.oggfile import OggStreamReader
from vorbis_tpu_torch.codec import headers as T_H
from vorbis_tpu_torch.models import fastdec as T_fd
from vorbis_tpu_torch.vorbisfile import OggVorbisFile

# one torch thread a pytest-xdist worker (see test_torch_switching.py)
torch.set_num_threads(1)

DEVICES = ["cpu", False]
FEEDS = [1, 2, 7, 32, 256]


def _same(a, b):
    """Equal dtype, shape and bit pattern."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """tests/test_faststream.py's block-switching stream (clicks force
    short/long mixes), from the stock encoder: (ogg, header packets,
    audio packets, each packet's W)."""
    rate = 44100
    t = np.arange(2 * rate) / rate
    mono = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    for k in range(16):
        mono[int((k + 0.5) * rate / 8)] = 0.9
    pcm = np.stack([mono, mono * 0.8])
    ogg = oracle.encode_vbr(pcm, rate, 0.4,
                            str(tmp_path_factory.mktemp("fs") / "s.ogg"))
    pkts = list(OggStreamReader(ogg).packets())
    hdr = [p for p, _, _ in pkts[:3]]
    sd = T_fd.FastStreamDecoder(T_fd.FastDecoder(T_H.parse_headers(hdr)),
                                device=False)
    W = [sd._scan_one_W(p) for p, _, _ in pkts[3:]]
    assert 0 in W and 1 in W
    return ogg, hdr, pkts[3:], W


@pytest.fixture(scope="module")
def decoders(stream):
    _, hdr, _, _ = stream
    return (J_fd.FastDecoder(J_H.parse_headers(hdr)),
            T_fd.FastDecoder(T_H.parse_headers(hdr)))


def _feed(dec, pkts, sizes, flush=True):
    """Feed `pkts` in chunks of `sizes` (cycled); the list of outputs."""
    outs, i, j = [], 0, 0
    while i < len(pkts):
        n = sizes[j % len(sizes)]
        outs.append(dec.feed(pkts[i:i + n]))
        i, j = i + n, j + 1
    if flush:
        outs.append(dec.flush())
    return outs


def _jax(dec_j, pkts, sizes, hs=0, flush=True):
    """The JAX package's outputs and decoder, or the error it raises."""
    d = J_fd.FastStreamDecoder(dec_j, hs=hs)
    try:
        return _feed(d, pkts, sizes, flush), None, d
    except ValueError as e:
        return None, e, d


def _port(dec_t, pkts, sizes, device, hs=0, flush=True):
    d = T_fd.FastStreamDecoder(dec_t, hs=hs, device=device)
    return _feed(d, pkts, sizes, flush), d


def _all_same(a, b):
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


@pytest.fixture
def replayed(monkeypatch):
    """The staged chunk with csrc/lap.cu's span ownership replayed in
    numpy in place of the plain lap."""

    def kernel(blocks, wins, plan, tables=None, tails=None):
        out, writes = lap_replay(blocks.numpy(), wins.numpy(), plan,
                                 None if tails is None else tails.numpy())
        assert (writes == 1).all()
        return torch.from_numpy(out)

    monkeypatch.setattr(T_fd, "lap", kernel)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("K", FEEDS)
def test_feeds_equal_jax(stream, decoders, K, device):
    """Feeds of K packets: every call's PCM equal to the JAX package's;
    where its chunk raises, device=False raises the same and device="cpu"
    equals its whole-stream decode."""
    ogg, _, audio, _ = stream
    want, err, _ = _jax(decoders[0], audio, [K])
    if err is None:
        got, _ = _port(decoders[1], audio, [K], device)
        assert _all_same(got, want)
        return
    assert K <= 3
    if device is False:
        with pytest.raises(ValueError, match=str(err)[:40]):
            _port(decoders[1], audio, [K], device)
        return
    got, _ = _port(decoders[1], audio, [K], device)
    assert _same(np.concatenate(got, 1), J_fd.decode_ogg_fast(ogg)[0])


@pytest.mark.parametrize("hs", [0, 1])
def test_kernel_replay_equals_jax(stream, decoders, replayed, hs):
    """The staged chunk with the lap kernel's span ownership (replayed)
    gives the JAX chunk's bits, full rate and halfrate, in feeds that
    grow as vorbisfile's do (32, 128, 256) and in odd sizes."""
    _, _, audio, _ = stream
    for sizes in ([32, 128, 256], [7, 33, 5]):
        want, err, _ = _jax(decoders[0], audio, sizes, hs)
        assert err is None
        got, _ = _port(decoders[1], audio, sizes, "cpu", hs)
        assert _all_same(got, want), sizes


@pytest.mark.parametrize("device", DEVICES)
def test_flush_without_eos(stream, decoders, device):
    """A stream cut before its EOS packet: flush() ends it with the held
    packet's own W.  The cut is the last one, five or more packets
    before the end, whose small final chunk the JAX chunk decodes."""
    _, _, audio, _ = stream
    for c in range(len(audio) - 5, 0, -1):
        cut = [(p, g, False) for p, g, _ in audio[:c]]
        want, err, _ = _jax(decoders[0], cut, [32])
        if err is None:
            break
    assert c > len(audio) - 40 and want[-1].shape[1] > 0
    got, _ = _port(decoders[1], cut, [32], device)
    assert _all_same(got, want)


@pytest.mark.parametrize("device", ["cpu", "cpu-replay", False])
def test_damaged_packet_holes(stream, decoders, device, request):
    """An empty audio packet held back after a long block whose successor
    is short: dropped and counted in `holes`, with the JAX chunk's bits
    (its tail keeps the long block's guessed long-long window, which
    reaches past the short block's center); a non-audio packet is
    dropped without a hole.  cpu-replay: the staged chunk with the lap
    kernel's span ownership, whose samples there have three
    contributors: the tail and two blocks."""
    if device == "cpu-replay":
        request.getfixturevalue("replayed")
        device = "cpu"
    _, _, audio, W = stream
    i = next(k for k in range(10, len(W) - 1) if W[k] == 1 and W[k + 1] == 0)
    bad = audio[:i + 1] + [(b"", None, False)] + audio[i + 1:]
    chunks = [bad[:i + 2], bad[i + 2:i + 40], bad[i + 40:]]
    jd = J_fd.FastStreamDecoder(decoders[0])
    want = [jd.feed(c) for c in chunks] + [jd.flush()]
    td = T_fd.FastStreamDecoder(decoders[1], device=device)
    got = [td.feed(c) for c in chunks] + [td.flush()]
    assert _all_same(got, want)
    assert td.holes == jd.holes == 1
    assert td.take_holes() == 1 and td.holes == 0
    # a header-type (odd first byte) packet mid-stream: no hole
    odd = audio[:50] + [(b"\x03vorbis", None, False)] + audio[50:]
    jd = J_fd.FastStreamDecoder(decoders[0])
    td = T_fd.FastStreamDecoder(decoders[1], device=device)
    assert _all_same(_feed(td, odd, [32]), _feed(jd, odd, [32]))
    assert td.holes == jd.holes == 0


@pytest.mark.parametrize("hs", [0, 1])
@pytest.mark.parametrize("device", DEVICES)
def test_first_label_mid_stream(stream, decoders, device, hs):
    """Packets taken after a seek: the first chunk starts at packet k
    (first_ever geometry), and the first granulepos label falls in mid
    chunk, so its start trim cuts the middle of the emitted range."""
    _, _, audio, _ = stream
    labels = [k for k, (_, g, _) in enumerate(audio) if g is not None]
    for k in (labels[1] + 1, labels[2] - 3, 40):
        for sizes in ([32], [5, 64]):
            want, err, jd = _jax(decoders[0], audio[k:], sizes, hs)
            assert err is None
            got, d = _port(decoders[1], audio[k:], sizes, device, hs)
            assert _all_same(got, want), (k, sizes)
            assert (d.granulepos, d.sample_count) == (jd.granulepos,
                                                      jd.sample_count)


@pytest.mark.parametrize("device", DEVICES)
def test_halfrate_feeds(stream, decoders, device):
    """halfrate (hs=1): the staged chunk at n/2 (IMDCT of each row's
    first n/4 floats, the half-size windows, half-unit positions)."""
    _, _, audio, _ = stream
    for sizes in ([7], [32], [256]):
        want, err, _ = _jax(decoders[0], audio, sizes, hs=1)
        assert err is None
        got, d = _port(decoders[1], audio, sizes, device, hs=1)
        assert _all_same(got, want), sizes
        assert sum(g.shape[1] for g in got) == 44100


@pytest.mark.parametrize("device", DEVICES)
def test_incremental_reads_equal_whole_stream(stream, device):
    """OggVorbisFile's chunked reads (odd sizes) concatenate to the
    port's whole-stream decode_ogg_fast(device="cpu")."""
    ogg, _, _, _ = stream
    whole, _ = T_fd.decode_ogg_fast(ogg, device="cpu")
    vf = OggVorbisFile(ogg, device=device)
    assert vf._fast is not None and vf._fast.device == (
        None if device is False else torch.device(device))
    parts, sizes, i = [], [1000, 313, 4097, 64, 20000], 0
    while True:
        c = vf.read_float(sizes[i % len(sizes)])
        i += 1
        if c.shape[1] == 0:
            break
        parts.append(c)
    assert _same(np.concatenate(parts, 1), whole)


def test_staged_chunk_layout(stream, decoders, monkeypatch):
    """One IMDCT call a blocksize present and one lap call a chunk, each
    reading its rows through the row table (offsets multiples of 4, the
    cp.async alignment); the lap's output runs half the last block past
    the emitted range, and that tail is the next lap's initial values."""
    _, _, audio, _ = stream
    calls = []
    real_imdct, real_lap = T_fd.imdct, T_fd.lap

    def imdct(spec, n, rows=None, out=None, rows_dev=None):
        assert rows is not None and not (np.asarray(rows) & 3).any()
        calls.append(("imdct", n))
        return real_imdct(spec, n, rows=rows, out=out, rows_dev=rows_dev)

    def lap(blocks, wins, plan, tables=None, tails=None):
        calls.append(("lap", len(plan.pk), tails))
        return real_lap(blocks, wins, plan, tables=tables, tails=tails)

    monkeypatch.setattr(T_fd, "imdct", imdct)
    monkeypatch.setattr(T_fd, "lap", lap)
    for hs in (0, 1):
        d = T_fd.FastStreamDecoder(decoders[1], hs=hs, device="cpu")
        calls.clear()
        d.feed(audio[:33])            # 32 processed, one held back
        sizes = {c[1] for c in calls if c[0] == "imdct"}
        assert sizes <= {256 >> hs, 2048 >> hs}
        assert len(sizes) == len(calls) - 1
        assert calls[-1] == ("lap", 32, None)
        out, at, stride, length = d._tail
        assert out.numel() == 2 * stride and length in (128 >> hs,
                                                        1024 >> hs)
        calls.clear()
        d.feed(audio[33:40])          # 7 processed, from the tail
        assert calls[-1][:2] == ("lap", 7) and calls[-1][2] is out
