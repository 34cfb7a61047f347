"""The port's `ov_*` layer (vorbis_tpu_torch.vorbisfile) against the JAX
package's (vorbis_tpu.vorbisfile) on the same bytes, on the CPU: the
cases of tests/test_vorbisfile.py, each through device="cpu" (the staged
decode with the IMDCT and lap kernels' plain versions) and device=False
(the JAX package's host-C path).  PCM is compared bit for bit (float32
by bit pattern, integer reads by bytes), with equal pcm_tell, pcm_total,
time_tell, hole_count and bitrates.

Streams come from the stock libvorbis (tests/oracle.py encode_vbr), so
no JAX is imported and nothing compiles.  The card tests of this layer
are in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import vorbis_tpu.vorbisfile as JV
import vorbis_tpu_torch.vorbisfile as TV
from tests import oracle

# one torch thread a pytest-xdist worker (see test_torch_switching.py)
torch.set_num_threads(1)

DEVICES = ["cpu", False]


def _same(a, b):
    """Equal dtype, shape and bytes."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _pair(data, device):
    return JV.OggVorbisFile(data), TV.OggVorbisFile(data, device=device)


def _reads(vf, sizes, word=None):
    """Reads of `sizes` (cycled) to the end: the list of chunks."""
    out, i = [], 0
    while True:
        n = sizes[i % len(sizes)]
        c = vf.read_float(n) if word is None else vf.read(n, word=word)
        i += 1
        if c.shape[1] == 0:
            return out
        out.append(c)


def _all_same(a, b):
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 1 s stereo stream, a 0.5 s mono one (another serialno), a 0.5 s
    stereo one at q0.2 (a third), as tests/test_vorbisfile.py's; paths
    and bytes."""
    d = tmp_path_factory.mktemp("vf")
    out = {}
    for name, pcm, q, sn in (
            ("a", oracle.make_test_signal(seconds=1.0), 0.4, 777),
            ("mono", oracle.make_test_signal(seconds=0.5, seed=3, ch=1),
             0.2, 999),
            ("b", oracle.make_test_signal(seconds=0.5, seed=7), 0.2, 321)):
        path = str(d / f"{name}.ogg")
        out[name] = (path, oracle.encode_vbr(pcm, 44100, q, path,
                                             serialno=sn), pcm)
    return out


@pytest.mark.parametrize("device", DEVICES)
def test_open_info_totals_comments_bitrates(files, device):
    _, ogg, pcm = files["a"]
    j, t = _pair(ogg, device)
    assert t.nstreams == j.nstreams == 1 and t.seekable
    ti, ji = t.info(), j.info()
    assert (ti.channels, ti.rate, tuple(ti.blocksizes)) == (
        ji.channels, ji.rate, tuple(ji.blocksizes)) == (2, 44100, (256, 2048))
    assert t.pcm_total() == j.pcm_total() == pcm.shape[1]
    assert t.time_total() == j.time_total()
    assert t.raw_total() == j.raw_total() and t.raw_total(0) == j.raw_total(0)
    assert t.comment() == j.comment()
    assert t.bitrate() == j.bitrate() > 0
    assert t.bitrate(0) == j.bitrate(0)
    assert t.bitrate_instant() == j.bitrate_instant() == 0
    assert _same(t.read_float(4096), j.read_float(4096))
    assert t.bitrate_instant() == j.bitrate_instant() > 0
    assert t.bitrate_instant() == 0


@pytest.mark.parametrize("device", DEVICES)
def test_drain_and_integer_reads(files, device):
    """read_all_float, chunked float reads, then ov_read's int16, 8-bit,
    unsigned and big-endian forms."""
    _, ogg, pcm = files["a"]
    j, t = _pair(ogg, device)
    full = t.read_all_float()
    assert _same(full, j.read_all_float()) and full.shape == pcm.shape
    assert t.pcm_tell() == j.pcm_tell() == pcm.shape[1]
    j, t = _pair(ogg, device)
    assert _all_same(_reads(t, [577]), _reads(j, [577]))
    for kw in ({}, {"word": 1}, {"word": 1, "signed": False},
               {"signed": False, "bigendian": True}, {"bigendian": True}):
        j, t = _pair(ogg, device)
        a, b = t.read(1024, **kw), j.read(1024, **kw)
        assert _same(a, b), kw
    j, t = _pair(ogg, device)
    assert _all_same(_reads(t, [999], word=2), _reads(j, [999], word=2))
    with pytest.raises(TV.OVInvalidError):
        t.read(10, word=3)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("pos", [0, 1, 12345, 22050, 44099])
def test_pcm_seek(files, pos, device):
    _, ogg, _ = files["a"]
    j, t = _pair(ogg, device)
    jf, tf = j.read_all_float(), t.read_all_float()
    assert _same(tf, jf)
    j.pcm_seek(pos)
    t.pcm_seek(pos)
    assert t.pcm_tell() == j.pcm_tell() == pos
    got = t.read_float(512)
    assert _same(got, j.read_float(512))
    assert _same(got, tf[:, pos:pos + got.shape[1]])
    assert t.pcm_tell() == j.pcm_tell()
    assert _all_same(_reads(t, [4000]), _reads(j, [4000]))


@pytest.mark.parametrize("device", DEVICES)
def test_time_seek_and_raw_seek(files, device):
    _, ogg, _ = files["a"]
    j, t = _pair(ogg, device)
    j.time_seek(0.25)
    t.time_seek(0.25)
    assert _same(t.read_float(512), j.read_float(512))
    assert t.time_tell() == j.time_tell()
    j.raw_seek(len(ogg) // 2)
    t.raw_seek(len(ogg) // 2)
    assert t.pcm_tell() == j.pcm_tell()
    assert _all_same(_reads(t, [3001]), _reads(j, [3001]))


@pytest.mark.parametrize("device", DEVICES)
def test_chained_links(files, device):
    """Two links with different channel counts (stereo then mono): totals,
    link info, reads across the boundary, a seek across it; and a chain
    of two stereo links drained by read_all_float (the JAX package's
    drain concatenates links, so it refuses mixed channel counts: both
    raise the same ValueError).  In the stereo chain the JAX package's
    link bisection ends the first link one page early (34,752 of its
    44,100 samples: the capture from a midpoint inside the link's last
    page finds the next link's BOS page), and the port, a copy, does
    the same."""
    a, mono, b = (files[k][1] for k in ("a", "mono", "b"))
    chain = a + mono
    j, t = _pair(chain, device)
    assert t.nstreams == j.nstreams == 2
    assert [t.pcm_total(k) for k in (-1, 0, 1)] == [
        j.pcm_total(k) for k in (-1, 0, 1)] == [66150, 44100, 22050]
    assert t.info(1).channels == j.info(1).channels == 1
    assert _all_same(_reads(t, [7777]), _reads(j, [7777]))
    for pos in (44100 + 11025, 44000, 66149):
        j, t = _pair(chain, device)
        j.pcm_seek(pos)
        t.pcm_seek(pos)
        assert t.pcm_tell() == j.pcm_tell() == pos
        assert _all_same(_reads(t, [400]), _reads(j, [400]))
    j, t = _pair(chain, device)
    with pytest.raises(ValueError) as ej:
        j.read_all_float()
    with pytest.raises(ValueError) as et:
        t.read_all_float()
    assert str(et.value) == str(ej.value)
    j, t = _pair(a + b, device)
    full = t.read_all_float()
    assert _same(full, j.read_all_float())
    assert full.shape[1] == t.pcm_total() == j.pcm_total()


@pytest.mark.parametrize("device", DEVICES)
def test_halfrate_reads_and_tells(files, device):
    _, ogg, pcm = files["a"]
    j, t = _pair(ogg, device)
    j.halfrate(True)
    t.halfrate(True)
    assert t.halfrate_p() and t._fast is not None and t._fast.hs == 1
    full = t.read_all_float()
    assert _same(full, j.read_all_float())
    assert full.shape == (2, pcm.shape[1] // 2)
    j, t = _pair(ogg, device)
    j.halfrate(True)
    t.halfrate(True)
    k = t.read_float(256).shape[1]
    assert t.pcm_tell() == j.read_float(256).shape[1] * 2 == 2 * k
    t.pcm_seek(40000)
    j.pcm_seek(40000)
    assert _all_same(_reads(t, [1000]), _reads(j, [1000]))
    j, t = _pair(ogg, device)
    j.read_float(3000)
    t.read_float(3000)
    j.halfrate(True)
    t.halfrate(True)
    assert t.pcm_tell() == j.pcm_tell()
    assert _all_same(_reads(t, [2048]), _reads(j, [2048]))
    t.halfrate(False)
    assert not t.halfrate_p()


@pytest.mark.parametrize("device", DEVICES)
def test_hole_count_on_corrupt_page(files, device):
    _, ogg, _ = files["a"]
    bad = bytearray(ogg)
    bad[len(bad) // 2] ^= 0xFF
    j, t = _pair(bytes(bad), device)
    assert _all_same(_reads(t, [1 << 16]), _reads(j, [1 << 16]))
    assert t.hole_count == j.hole_count >= 1


@pytest.mark.parametrize("device", DEVICES)
def test_crosslap(files, device):
    """ov_crosslap after a full drain and after a seek: the spliced head
    of the second stream bitwise equal to the JAX package's."""
    a, b = files["a"][1], files["b"][1]
    for prep in ("drain", "seek"):
        j1, t1 = _pair(a, device)
        j2, t2 = _pair(b, device)
        if prep == "drain":
            j1.read_all_float()
            t1.read_all_float()
        else:
            j1.pcm_seek(30011)
            t1.pcm_seek(30011)
            j1.read_float(2000)
            t1.read_float(2000)
        j1.crosslap(j2)
        t1.crosslap(t2)
        assert t2.pcm_tell() == j2.pcm_tell()
        assert _all_same(_reads(t2, [1 << 14]), _reads(j2, [1 << 14]))


class _TrackingFile:
    """A seekable file that records the largest single read."""

    def __init__(self, path):
        self.f = open(path, "rb")
        self.max_read = 0

    def read(self, n=-1):
        b = self.f.read(n)
        self.max_read = max(self.max_read, len(b))
        return b

    def seek(self, off, whence=0):
        return self.f.seek(off, whence)

    def tell(self):
        return self.f.tell()


@pytest.mark.parametrize("device", DEVICES)
def test_file_object_bounded_reads(files, device):
    """Streaming and seeks through a file object (and a path): every
    read of the source stays page-bounded, the PCM equal to the JAX
    package's."""
    path, ogg, _ = files["a"]
    tf, jf = _TrackingFile(path), _TrackingFile(path)
    t = TV.OggVorbisFile(tf, device=device)
    j = JV.OggVorbisFile(jf)
    assert _all_same(_reads(t, [4096]), _reads(j, [4096]))
    total = t.pcm_total()
    for pos in (0, total // 3, total - 4096, total // 2, 1000):
        t.pcm_seek(pos)
        j.pcm_seek(pos)
        assert t.pcm_tell() == pos
        assert _same(t.read_float(1024), j.read_float(1024))
    assert tf.max_read == jf.max_read <= 1 << 17
    tf.f.close()
    jf.f.close()
    out, vf = TV.decode_file(path, device=device)
    assert _same(out, JV.decode_file(path)[0]) and vf.pcm_total() == total


@pytest.mark.parametrize("device", DEVICES)
def test_garbage_rejected(device):
    """The same OVError subclass as the JAX package's."""
    data = b"not an ogg stream at all" * 10
    with pytest.raises(JV.OVError) as ej:
        JV.OggVorbisFile(data)
    with pytest.raises(TV.OVError) as et:
        TV.OggVorbisFile(data, device=device)
    assert type(et.value).__name__ == type(ej.value).__name__ \
        == "OVNotVorbisError"
