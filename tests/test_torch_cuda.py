"""Tests that need the card: the port's CUDA kernels (csrc/floor_fit.cu,
csrc/m3_scan.cu, csrc/imdct.cu, csrc/lap.cu) against their plain PyTorch
versions (the floor fit on the 5.1 looks too, M3 on six channels, the
IMDCT at every blocksize and the lap at every blocksize and on -0.0 and
subnormal products, both against the host C), the managed 15-blob
finish on the card against the same step on the CPU, the fast
decode on the card against the host-C drain, the sharded encode
step, the roundtrip pipeline and LBG training on the card, and one
configuration of the corpus gate that holds the card's FastEncoder to
the port's golden encoder (chip_smoke.py phase 8).  A CUDA
kernel has no CPU mode, so each test here skips without a card.

The GPU machine has no JAX, so this file imports neither jax nor
vorbis_tpu (test_torch_isolation.py checks) and builds every input from
the port alone.  On the card (tests/conftest.py imports jax unless
VORBIS_TPU_TESTS is set):

    VORBIS_TPU_TESTS=1 python -m pytest tests/test_torch_cuda.py \\
        tests/test_torch_m3.py -m cuda

Tolerances: each kernel against its plain version bitwise (M3 by bit
pattern: a -0.0 against a +0.0 differs); the stacked floor fit of the
managed path against three fits and the plain fit bitwise; the managed
finish on the card against the CPU on the same inputs in >= 90% of the
(F, 15) rows, the bound of chip_smoke.py's card-vs-CPU phases (cuBLAS
and the CPU sum the floor moments in other orders).
"""

import numpy as np
import pytest
import torch

from chip_smoke import _click_train, _rows_equal, _signal
from vorbis_tpu_torch.codec.encoder import Encoder
from vorbis_tpu_torch.models import encsetup
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import psydevice as TPD
from vorbis_tpu_torch.ops.floor_cuda import make_floor_fit
from vorbis_tpu_torch.ops.m3_cuda import M3ScanCuda
from vorbis_tpu_torch.ops.managed import floor3

# one torch thread a pytest-xdist worker (see test_torch_switching.py)
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

B = 32


@pytest.fixture
def cuda():
    """Decided in the test, never at import: every xdist worker must
    collect the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.fixture(scope="module")
def look():
    """The long-block floor of FastEncoder(2, 44100, 0.5)."""
    setup = encsetup.setup_vbr_staged(2, 44100, 0.5).init()
    vi = setup.vi
    mode = next(m for m in vi.modes if m.blockflag == 1)
    mapping = vi.maps[mode.mapping]
    return Encoder(setup).floor_looks[
        mapping.floorsubmap[mapping.chmuxlist[0]]]


def _random(look, B, seed):
    rng = np.random.RandomState(seed)
    lm = (rng.randn(B, look.n) * 20 - 60).astype(np.float32)
    mk = (lm + rng.randn(B, look.n) * 6 - 3).astype(np.float32)
    return lm, mk


def _m3_inputs(F, n, seed, ch=2):
    """Seeded (logmdct, lastmdct, val, tval) with M3 triggers firing, and
    params from m3_param_seq on a switched frame sequence."""
    rng = np.random.RandomState(seed)
    lm = (rng.randn(F, ch, n) * 15 - 60).astype(np.float32)
    last = (rng.randn(F, ch, 1024) * 15 - 75).astype(np.float32)
    val = (lm + rng.randn(F, ch, n) * 8 + 6).astype(np.float32)
    tval = (lm + rng.randn(F, ch, n) * 8 - 6).astype(np.float32)
    Ws = np.where(rng.rand(1, F) < 0.7, 0, 1)
    imp = (rng.rand(1, F) < 0.6) & (Ws == 0)
    ann = TPD.annotate_frames_nd(Ws, imp)
    pr = TPD.m3_param_seq({k: v[0] for k, v in ann.items()}, n, 2.0, True)
    return lm, last, val, tval, pr


def test_kernel_matches_plain_on_cuda(cuda, look):
    """csrc/floor_fit.cu against the plain version, bitwise."""
    kf = make_floor_fit(look, "cuda")
    for B_, seed in ((4096, 7), (37, 8)):
        lm, mk = _random(look, B_, seed)
        q, a, p, _ = kf.prepare(torch.from_numpy(lm).cuda(),
                                torch.from_numpy(mk).cuda())
        assert torch.equal(kf.fit(q, a, p), kf.fit_plain(q, a, p))
    assert kf.launches == 2


def test_m3_scan_on_cuda(cuda):
    """csrc/m3_scan.cu against the plain scan by bit pattern, on stereo
    rows and on the six channels of a 5.1 short batch."""
    look = TFE(2, 44100, 0.5, device="cpu").ctx(0).analysis.look
    scan = M3ScanCuda(look, "cuda")
    for ch, seed in ((2, 1), (6, 2)):
        lm, last, val, tval, pr = _m3_inputs(256, look.n, seed, ch)
        args = [torch.from_numpy(a).cuda() for a in (lm, last, val, tval)]
        prm = {k: torch.from_numpy(np.asarray(pr[k])).cuda()
               for k in ("sw", "reset", "noise_center")}
        scan.launches = 0
        got = scan(*args, prm)
        torch.cuda.synchronize()
        assert scan.launches == 1
        want = scan.plain(*args, prm)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_floor_kernel_51_looks_on_cuda(cuda):
    """csrc/floor_fit.cu against the plain fit, bitwise, on the three
    floor looks of FastEncoder(6, 48000, 0.4) (the 5.1 templates): the
    long look (29 posts over 1024 bins), the short look (13 over 128) and
    the LFE's (2 over 12), at the batches of one 5.1 finish (B = 256 * 5
    rows of the coupled submap, B = 256 of the LFE)."""
    looks = Encoder(encsetup.setup_vbr_staged(6, 48000, 0.4).init()
                    ).floor_looks
    shapes = sorted({(lk.posts, lk.n) for lk in looks})
    assert shapes == [(2, 12), (13, 128), (29, 1024)]
    for lk in looks:
        kf = make_floor_fit(lk, "cuda")
        for B_, seed in ((256 * 5, 31), (256, 32)):
            lm, mk = _random(lk, B_, seed)
            q, a, p, _ = kf.prepare(torch.from_numpy(lm).cuda(),
                                    torch.from_numpy(mk).cuda())
            assert torch.equal(kf.fit(q, a, p), kf.fit_plain(q, a, p))
        assert kf.launches == 2


def test_managed_finish15_on_cuda(cuda):
    """A long and a short 15-blob finish batch of a 1 s click train
    through the port's own probe on the card: the three offset_select
    fits run as one launch that equals three launches and the plain fit;
    a short batch launches the M3 kernel once a select; the finish on the
    card equals the CPU step on the same inputs in >= 90% of rows."""
    abr = (-1, 128000, -1)
    fc = TFE(2, 44100, bitrate=abr)
    fp = TFE(2, 44100, bitrate=abr, device="cpu")
    pcm = _click_train(1.0, 44100, 0)
    x64, per = fc._prepare_switched([torch.from_numpy(pcm).cuda()], True)
    rec = per[0]
    ann = TPD.annotate_frames(rec["Ws"], rec["impulse"])
    for W, idx in ((1, rec["li"][:B]), (0, rec["si"][:B])):
        assert len(idx) == B
        wd = rec["wid"][idx] if W else np.zeros(B, np.int64)
        sv = torch.from_numpy(np.stack([rec["starts"][idx], wd,
                                        np.zeros(B)]).astype(np.int32))
        o = fc._probe_step(W, B)(x64, sv.cuda())
        # the stacked fits on this batch's real masks
        ctx = fc.ctx(W)
        fl = ctx.floor
        masks = [ctx.analysis.offset_and_mix(o[0], o[1], o[1] - 6.0,
                                             o[1] - 3.0, s)[1]
                 for s in (0, 1, 2)]
        fl.launches = 0
        ps, us = floor3(fl, o[1], masks)
        torch.cuda.synchronize()
        assert fl.launches == 1
        for m, p in zip(masks, ps):
            q, a, pf, _ = fl.prepare(o[1], m)
            assert torch.equal(p, fl.fit(q, a, pf))
            assert torch.equal(p, fl.fit_plain(q, a, pf))
        # the finish, card against CPU on the same inputs
        lastm = torch.cat([torch.zeros_like(o[5][:2]), o[5][:-2]])
        amp = o[6].reshape(B, 2).amax(1)
        tr = torch.from_numpy(ann["bm"][idx] == (2 if W else 1)).cuda()
        fstate = torch.cat([amp, torch.full((4 * B,), -1.0, device="cuda"),
                            tr.float(), torch.from_numpy(wd).cuda().float()])
        m3vec = None
        if not W:
            sub = {k: ann[k][idx]
                   for k in ("bm", "lW_bm", "lW_no", "impadnum")}
            pr = TPD.m3_param_seq(sub, 128, 2.0, True, managed=True)
            m3vec = torch.from_numpy(np.stack(
                [pr["sw"], pr["noise_rate"], pr["noise_center"],
                 pr["tone_rate"], pr["reset"], sub["impadnum"] == 0]
            ).astype(np.float32)).cuda()
            fc.ctx(0).m3_scan.launches = 0
        args = (*o[:5], lastm, o[6], fstate, m3vec)
        fl.launches = 0
        pk, nb = (t.cpu().numpy()
                  for t in fc._managed_finish_step(W, B)(*args))
        assert fl.launches == 1
        if not W:
            assert fc.ctx(0).m3_scan.launches == 3
        pc, nc = (t.numpy() for t in fp._managed_finish_step(W, B)(
            *(None if a is None else a.cpu() for a in args)))
        same = _rows_equal(pk, nb, pc, nc)
        print(f"finish15 W={W} card vs CPU: {same}/{nb.size} rows equal")
        assert same >= 0.9 * nb.size


def test_imdct_kernel_matches_plain_on_cuda(cuda):
    """csrc/imdct.cu against its plain version on the card and the host
    C (vn_imdct_batch), bitwise, at every blocksize 64-8192, on packed
    rows and through a row table that reorders and spaces them, with one
    launch a call."""
    from vorbis_tpu_torch.native import imdct_batch
    from vorbis_tpu_torch.ops.imdct_cuda import imdct, imdct_plain
    for k, n in enumerate((64, 128, 256, 512, 1024, 2048, 4096, 8192)):
        rng = np.random.RandomState(k)
        R = 300
        spec = (rng.randn(R, n // 2)
                * 10.0 ** rng.uniform(-3, 3, (R, 1))).astype(np.float32)
        slot = rng.permutation(R).astype(np.int64) * (n // 2 + 4)
        flat = np.zeros(int(slot.max()) + n // 2, np.float32)
        flat[slot[:, None] + np.arange(n // 2)] = spec
        x = torch.from_numpy(spec).cuda()
        want = imdct_batch(spec, n).view(np.uint32)
        assert np.array_equal(want, imdct_plain(x, n).cpu().numpy()
                              .view(np.uint32)), n
        for got in (imdct(x, n),
                    imdct(torch.from_numpy(flat).cuda(), n, rows=slot)):
            torch.cuda.synchronize()
            assert np.array_equal(got.cpu().numpy().view(np.uint32),
                                  want), n
        before = imdct.launches
        imdct(x, n)
        assert imdct.launches == before + 1


def test_lap_kernel_matches_plain_on_cuda(cuda):
    """csrc/lap.cu against its plain version on the card and the host C
    (vn_lap_add and the trim), bitwise: tests/test_torch_lap.py's seeded
    streams at every blocksize 64-8192 in one batch, its case of -0.0
    and subnormal products, and the seeded streams again with tails and
    the spans before the first and after the last center (the chunked
    decode's lap), with one launch a call."""
    from chip_smoke import _lap_cases
    from vorbis_tpu_torch.ops.lap_cuda import lap, lap_plain
    tl = _lap_cases()
    batch = [tl.lap_case(bs0, bs1, 60, (1, 2, 6)[k % 3], k, trim=k % 2 == 0)
             for k, (bs0, bs1) in enumerate(tl.CASE_PAIRS)]
    for cases in (batch, [tl.signed_zero_case()], "tails"):
        if cases == "tails":
            flat, wins, plan, tails, wants = tl.tail_inputs(
                [tl.lap_case(bs0, bs1, 30, (1, 2, 6)[k % 3], k, trim=False)
                 for k, (bs0, bs1) in enumerate(tl.CASE_PAIRS)], seed=3)
            tails = torch.from_numpy(tails).cuda()
        else:
            (flat, wins, plan, wants), tails = tl.lap_inputs(cases), None
        args = (torch.from_numpy(flat).cuda(), torch.from_numpy(wins).cuda(),
                plan)
        before = lap.launches
        got = lap(*args, tails=tails)
        assert lap.launches == before + 1
        plain = lap_plain(*args, tails)
        for k, want in enumerate(wants):
            bits = want.view(np.uint32)
            for o in (got, plain):
                g = plan.out_view(o, k).cpu().numpy()
                assert g.shape == want.shape
                assert np.array_equal(g.view(np.uint32), bits), k


def test_decode_device_matches_host_drain_on_cuda(cuda):
    """decode_ogg_fast on the card (the default) and
    decode_ogg_fast_batch of three streams equal the host-C drain
    (device=False) bit for bit; a card call launches the IMDCT once a
    blocksize present (two: every stream opens with a short block) and
    the lap once."""
    from chip_smoke import _signal
    from vorbis_tpu_torch.models.fastdec import (decode_ogg_fast,
                                                 decode_ogg_fast_batch)
    from vorbis_tpu_torch.ops.imdct_cuda import imdct
    from vorbis_tpu_torch.ops.lap_cuda import lap
    fe = TFE(2, 44100, 0.5)
    oggs = fe.encode_batch([torch.from_numpy(_signal(3 + k, 44100, k)).cuda()
                            for k in range(3)])
    want = [decode_ogg_fast(o, device=False)[0] for o in oggs]
    got = []
    for call in (lambda: [decode_ogg_fast(oggs[0])[0]],
                 lambda: [g for g, _ in decode_ogg_fast_batch(oggs)]):
        i0, l0 = imdct.launches, lap.launches
        got += call()
        assert (imdct.launches - i0, lap.launches - l0) == (2, 1)
    for g, w in zip(got, want[:1] + want):
        assert g.shape == w.shape
        assert np.array_equal(g.view(np.uint32), w.view(np.uint32))


def _reads(vf, sizes):
    """Reads of `sizes` (cycled) to the end: the list of chunks."""
    out, i = [], 0
    while True:
        c = vf.read_float(sizes[i % len(sizes)])
        i += 1
        if c.shape[1] == 0:
            return out
        out.append(c)


def _bits_equal(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x.view(np.uint32),
                                              y.view(np.uint32))
        for x, y in zip(a, b))


class _ChunkLaunches:
    """Per staged chunk of FastStreamDecoder: (IMDCT launches, blocksizes
    present, lap launches).  chip_smoke.py phase 6b uses it too (with a
    pytest.MonkeyPatch of its own)."""

    def __init__(self, monkeypatch):
        from vorbis_tpu_torch.models import fastdec
        from vorbis_tpu_torch.ops.imdct_cuda import imdct
        from vorbis_tpu_torch.ops.lap_cuda import lap
        self.rows = []
        real = fastdec.FastStreamDecoder._synth_device

        def counted(dec, blob, off, bits, W, *rest):
            i0, l0 = imdct.launches, lap.launches
            pcm = real(dec, blob, off, bits, W, *rest)
            self.rows.append((imdct.launches - i0, len(np.unique(W)),
                              lap.launches - l0))
            return pcm

        monkeypatch.setattr(fastdec.FastStreamDecoder, "_synth_device",
                            counted)

    def bad(self):
        """The chunks that did not launch the IMDCT once a blocksize
        present and the lap once."""
        return [r for r in self.rows if r[0] != r[1] or r[2] != 1]

    def check(self):
        assert self.rows and not self.bad()


def test_vorbisfile_reads_on_cuda(cuda, monkeypatch):
    """OggVorbisFile on the card (the default) against device=False, bit
    for bit: odd-size chunked reads, pcm_seeks with their reads and tells,
    halfrate reads and read_all_float, on a switched click-train stream;
    every staged chunk launches the IMDCT once a blocksize present and the
    lap once, and the whole-link drain two IMDCT launches and one lap."""
    from vorbis_tpu_torch.ops.imdct_cuda import imdct
    from vorbis_tpu_torch.ops.lap_cuda import lap
    from vorbis_tpu_torch.vorbisfile import OggVorbisFile
    fe = TFE(2, 44100, 0.5)
    ogg = fe.encode_batch([torch.from_numpy(_click_train(4, 44100, 0))
                           .cuda()])[0]
    chunks = _ChunkLaunches(monkeypatch)
    card, host = OggVorbisFile(ogg), OggVorbisFile(ogg, device=False)
    assert card._fast.device.type == "cuda" and host._fast.device is None
    got = _reads(card, [4096, 313, 20000, 64])
    assert _bits_equal(got, _reads(host, [4096, 313, 20000, 64]))
    total = card.pcm_total()
    assert sum(c.shape[1] for c in got) == total == 4 * 44100
    for pos in (0, 1, 30011, 2 * 44100 + 5, total - 100):
        card.pcm_seek(pos)
        host.pcm_seek(pos)
        assert card.pcm_tell() == host.pcm_tell() == pos
        assert _bits_equal([card.read_float(4096)], [host.read_float(4096)])
    for vf in (card, host):
        vf.halfrate(True)
        vf.pcm_seek(0)
    assert _bits_equal(_reads(card, [3000]), _reads(host, [3000]))
    chunks.check()
    card, host = OggVorbisFile(ogg), OggVorbisFile(ogg, device=False)
    i0, l0 = imdct.launches, lap.launches
    full = card.read_all_float()
    assert (imdct.launches - i0, lap.launches - l0) == (2, 1)
    assert _bits_equal([full], [host.read_all_float()])


def test_faststream_halfrate_on_cuda(cuda, monkeypatch):
    """FastStreamDecoder(hs=1) on the card against device=False, bit for
    bit, in feeds of 32, 128 and 256 packets (vorbisfile's) and of 7:
    each chunk one IMDCT launch a blocksize present at n/2 and one lap."""
    from vorbis_tpu_torch.bitstream.oggfile import OggStreamReader
    from vorbis_tpu_torch.models.fastdec import (FastStreamDecoder,
                                                 _decoder_for)
    fe = TFE(2, 44100, 0.5)
    ogg = fe.encode_batch([torch.from_numpy(_click_train(4, 44100, 1))
                           .cuda()])[0]
    pkts = list(OggStreamReader(ogg).packets())
    dec = _decoder_for(tuple(p for p, _, _ in pkts[:3]))
    audio = pkts[3:]
    chunks = _ChunkLaunches(monkeypatch)
    for sizes in ([32, 128, 256], [7]):
        outs = []
        for device in ("cuda", False):
            d = FastStreamDecoder(dec, hs=1, device=device)
            out, i, j = [], 0, 0
            while i < len(audio):
                n = sizes[min(j, len(sizes) - 1)]
                out.append(d.feed(audio[i:i + n]))
                i, j = i + n, j + 1
            outs.append(out + [d.flush()])
        assert _bits_equal(*outs)
        assert sum(o.shape[1] for o in outs[0]) == 2 * 44100
    chunks.check()
    assert any(sizes == 2 for _, sizes, _ in chunks.rows)


def damaged_holdback(ogg, device):
    """FastStreamDecoder fed an empty audio packet held back after a long
    block whose successor is short (the carried tail keeps the long
    block's long-long window, which reaches past the short block's
    center), in chunks that end on it: the outputs and the holes."""
    from vorbis_tpu_torch.bitstream.oggfile import OggStreamReader
    from vorbis_tpu_torch.models.fastdec import (FastStreamDecoder,
                                                 _decoder_for)
    pkts = list(OggStreamReader(ogg).packets())
    dec = _decoder_for(tuple(p for p, _, _ in pkts[:3]))
    audio = pkts[3:]
    d = FastStreamDecoder(dec, device=False)
    W = [d._scan_one_W(p) for p, _, _ in audio]
    i = next(k for k in range(10, len(W) - 1) if W[k] == 1 and W[k + 1] == 0)
    bad = audio[:i + 1] + [(b"", None, False)] + audio[i + 1:]
    d = FastStreamDecoder(dec, device=device)
    outs = [d.feed(c) for c in (bad[:i + 2], bad[i + 2:i + 40],
                                bad[i + 40:])]
    return outs + [d.flush()], d.holes


def test_faststream_damaged_holdback_on_cuda(cuda, monkeypatch):
    """A damaged held-back packet between a long block and a short one:
    on the card the chunk after it starts its lap from the carried tail
    (three contributors to a sample: the tail and two blocks), bit for
    bit equal to device=False, one hole, every chunk one IMDCT launch a
    blocksize present and one lap launch, and no plain lap."""
    from vorbis_tpu_torch.ops import lap_cuda
    fe = TFE(2, 44100, 0.5)
    ogg = fe.encode_batch([torch.from_numpy(_click_train(4, 44100, 2))
                           .cuda()])[0]
    chunks = _ChunkLaunches(monkeypatch)
    plain = []
    real_plain = lap_cuda.lap_plain
    monkeypatch.setattr(lap_cuda, "lap_plain",
                        lambda *a: plain.append(1) or real_plain(*a))
    got, holes = damaged_holdback(ogg, "cuda")
    want, holes_h = damaged_holdback(ogg, False)
    assert _bits_equal(got, want) and holes == holes_h == 1
    assert sum(g.shape[1] for g in got) > 3 * 44100
    chunks.check()
    assert not plain


def _cuda_mesh(size):
    """A mesh of `size` entries that repeats cuda:0 (one card stands in
    for several), and one over every card where there are several."""
    from vorbis_tpu_torch.parallel import make_codec_mesh
    meshes = [make_codec_mesh(devices=[torch.device("cuda", 0)] * size)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_codec_mesh())
    return meshes


def test_sharded_encode_on_cuda(cuda):
    """The framed encode step split over a mesh on the card, bitwise
    equal to one device's step, each shard one floor-kernel launch."""
    from vorbis_tpu_torch.ops.encdevice import DeviceFastEncode
    from vorbis_tpu_torch.parallel import sharded_encode_step
    fe = TFE(2, 44100, 0.5)
    F = 64
    dev = DeviceFastEncode(fe, chunk_packets=F)
    frames = torch.from_numpy((np.random.RandomState(0).randn(
        F, 2, fe.n) * 0.1).astype(np.float32)).cuda()
    pk1, nb1 = dev.make_framed_step(F)(frames)
    assert bool((nb1 > 0).all()) and int(nb1.max()) <= 8 * dev.plan.wb
    for mesh in _cuda_mesh(4):
        step = sharded_encode_step(dev, mesh, F)
        fe.floor.launches = 0
        pk, nb = step(frames)
        torch.cuda.synchronize()
        assert torch.equal(pk, pk1) and torch.equal(nb, nb1)
        assert fe.floor.launches == sum(d == torch.device("cuda", 0)
                                        for d in mesh.flat)


def test_roundtrip_on_cuda(cuda, monkeypatch):
    """The roundtrip sharded 2 x 4 on the card equal in value to the
    unsharded step (err within 1e-6 relative), two IMDCT and two lap
    launches a shard and no plain version; DeviceSynthesis on the card
    equal in value to imdct_plain + lap_plain on the same spectra."""
    from vorbis_tpu_torch.models.pipeline import TorchCodecPipeline
    from vorbis_tpu_torch.ops import imdct_cuda, lap_cuda
    from vorbis_tpu_torch.ops.imdct_cuda import imdct, imdct_plain
    from vorbis_tpu_torch.ops.lap_cuda import lap, lap_plain
    from vorbis_tpu_torch.parallel import sharded_roundtrip_step
    pipe = TorchCodecPipeline(2, 44100, 0.5)
    n, n2 = pipe.n, pipe.n // 2
    x = torch.from_numpy((np.random.RandomState(1).randn(
        4, 2, 16, n) * 0.1).astype(np.float32)).cuda()
    md, logmdct, mask = pipe.analysis.full_mask(x)
    quant = torch.where(logmdct >= mask, md, 0.0)
    got = pipe.synthesis(quant)
    plan = pipe.synthesis._plan(8, 16, False, False)[0]
    want = lap_plain(imdct_plain(quant.reshape(-1, n2), n).reshape(-1),
                     pipe.synthesis.window, plan).reshape(got.shape)
    assert torch.equal(got, want)
    plain = []
    monkeypatch.setattr(imdct_cuda, "imdct_plain",
                        lambda *a: plain.append("imdct"))
    monkeypatch.setattr(lap_cuda, "lap_plain",
                        lambda *a: plain.append("lap"))
    pcm1, err1 = pipe.roundtrip_step(x)
    for mesh in _cuda_mesh(8):
        imdct.launches = lap.launches = 0
        pcm, err = sharded_roundtrip_step(pipe, mesh)(x)
        torch.cuda.synchronize()
        assert (imdct.launches, lap.launches) == (2 * mesh.size,) * 2
        assert torch.equal(pcm, pcm1)
        assert abs(float(err) - float(err1)) <= 1e-6 * float(err1)
    assert not plain


def test_lbg_on_cuda(cuda):
    """LBG on the card (the default) within 25% of the numpy path's final
    MSE; one step's assignments and counts equal to the CPU step's on
    clustered points, the codes within an ulp (float64 atomics sum a
    cell in any order, then round once)."""
    from vorbis_tpu_torch.vq import lbg_train
    from vorbis_tpu_torch.vq.vqgen import _make_step
    rng = np.random.RandomState(0)
    centers = rng.randn(64, 4).astype(np.float32) * 3
    pts = (centers[rng.randint(0, 64, 8192)]
           + rng.randn(8192, 4).astype(np.float32) * 0.25).astype(np.float32)
    _, _, hc = lbg_train(pts, 64, iters=20)
    _, _, hn = lbg_train(pts, 64, iters=20, use_torch=False)
    assert abs(hc[-1] - hn[-1]) / hn[-1] < 0.25
    codes = centers + rng.randn(64, 4).astype(np.float32) * 0.05
    c, a, n, _, _ = _make_step("cuda")(pts, codes.copy())
    cc, ac, nc, _, _ = _make_step("cpu")(pts, codes.copy())
    assert np.array_equal(a, ac) and np.array_equal(n, nc)
    assert np.abs(c.view(np.int32).astype(np.int64)
                  - cc.view(np.int32).astype(np.int64)).max() <= 1


def test_mixed_device_mesh_on_cuda(cuda):
    """A mesh of the card and the CPU: each shard runs on its own
    device's copy of the encoder and the pipeline (FastEncoder.to,
    TorchCodecPipeline.to) and the halo crosses devices.  Card and CPU
    round otherwise (cuFFT, cuBLAS), so the bounds of the card-vs-CPU
    phases: >= 90% of packets equal; the roundtrip's pcm within 1e-5 of
    its scale and err within 1e-4 relative of the card's own step."""
    from vorbis_tpu_torch.models.pipeline import TorchCodecPipeline
    from vorbis_tpu_torch.ops.encdevice import DeviceFastEncode
    from vorbis_tpu_torch.parallel import (make_codec_mesh,
                                           sharded_encode_step,
                                           sharded_roundtrip_step)
    mesh = make_codec_mesh(devices=["cuda", "cpu"])
    assert mesh.distinct() == [torch.device("cuda", 0), torch.device("cpu")]
    fe = TFE(2, 44100, 0.5)
    pipe = TorchCodecPipeline(2, 44100, 0.5)
    F = 16
    dev = DeviceFastEncode(fe, chunk_packets=F)
    fr = [pipe.frame(_signal(1, 44100, s).astype(np.float32) / 32768.0)
          for s in (0, 1)]                  # (2, 42, n) each
    frames = torch.from_numpy(np.ascontiguousarray(
        fr[0][:, :F].transpose(1, 0, 2)))
    pk, nb = sharded_encode_step(dev, mesh, F)(frames)
    pk1, nb1 = dev.make_framed_step(F)(frames.cuda())
    assert pk.device == pk1.device and nb.device == nb1.device
    same = (pk == pk1).all(1) & (nb == nb1)
    assert float(same.float().mean()) >= 0.9
    assert torch.equal(pk[:F // 2], pk1[:F // 2])       # the card's half
    x = torch.from_numpy(np.stack([f[:, :8] for f in fr]))
    pcm, err = sharded_roundtrip_step(pipe, mesh)(x)
    pcm1, err1 = pipe.roundtrip_step(x.cuda())
    assert pcm.device == pcm1.device
    assert float((pcm - pcm1).abs().max()) <= 1e-5 * float(pcm1.abs().max())
    assert abs(float(err) - float(err1)) <= 1e-4 * float(err1)


def test_golden_gate_on_cuda(cuda):
    """One configuration of chip_smoke.py phase 8: FastEncoder(2, 16000,
    0.5) on the card (the 512/1024 blocksizes) on 1 s of the mix signal
    and on quiet-after-loud, held to the port's golden encoder by
    tests/test_quality_gates.py _gate's bounds (RMS error below 1.1 times
    the golden stream's, segmental SNR within 2 dB, size ratio in
    [0.65, 1.2]), both streams decoded on the card; the encodes launch
    the floor kernel, the decodes the IMDCT and lap kernels."""
    from chip_smoke import GATES, _gate_one, _gate_signal
    from vorbis_tpu_torch import encode_vbr_stream
    from vorbis_tpu_torch.ops.imdct_cuda import imdct
    from vorbis_tpu_torch.ops.lap_cuda import lap
    q, rate, ratio = GATES[2]
    assert rate == 16000
    fe = TFE(2, rate, q)
    i0, l0 = imdct.launches, lap.launches
    for kind in ("mix", "qal"):
        pcm = _gate_signal(kind, rate, 1.0, 2)
        _gate_one(kind, pcm, fe.encode(pcm), encode_vbr_stream(pcm, rate, q),
                  ratio, (0.65, 1.2))
    assert fe.floor.launches > 0
    assert imdct.launches > i0 and lap.launches > l0
