"""The port's fast decode (vorbis_tpu_torch.models.fastdec, its host C
csrc/host_decode.c and the IMDCT of ops/imdct_cuda.py) against the JAX
package's (vorbis_tpu.models.fastdec and native/vorbisnative.c), on the
CPU.  Every comparison is bitwise (float32 arrays by bit pattern, NaNs
included): the port parses, transforms and laps in the reference's
order of operations, and eager PyTorch rounds every op as the C and
numpy do.

Streams: tests/test_fastdec.py's seven configurations at 0.6 s, its two
ABR streams (truncated packets), one stream of the port's own encoder
and two floor0 streams (tests/test_floor0.py's crafted LSP streams),
all built once a module.  The card tests of this slice
(test_imdct_kernel_matches_plain_on_cuda,
test_decode_device_matches_host_drain_on_cuda) are in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import vorbis_tpu.native as J_native
from tests import oracle
from vorbis_tpu.codec import headers as J_H
from vorbis_tpu.codec import nativeparse as J_np
from vorbis_tpu.codec.decoder import decode_ogg as J_decode_ogg
from vorbis_tpu.models import fastdec as J_fd
from vorbis_tpu.ops.mdct import _bf32 as J_bf32
from vorbis_tpu.ops.mdct import imdct as J_imdct
from vorbis_tpu_torch import native as T_native
from vorbis_tpu_torch.codec import headers as T_H
from vorbis_tpu_torch.codec import nativeparse as T_np
from vorbis_tpu_torch.codec.decoder import decode_ogg as T_decode_ogg
from vorbis_tpu_torch.models import fastdec as T_fd
from vorbis_tpu_torch.ops.imdct_cuda import ImdctKernel, imdct, imdct_plain
from vorbis_tpu_torch.ops.mdct import _imdct_index_tables

# one torch thread a pytest-xdist worker (see test_torch_switching.py)
torch.set_num_threads(1)

NS = [64, 128, 256, 512, 1024, 2048, 4096, 8192]
CONFIGS = [(0.5, 44100, 2), (0.3, 44100, 2), (-0.1, 44100, 2),
           (1.0, 44100, 2), (0.2, 8000, 1), (0.4, 48000, 6),
           (0.5, 96000, 2)]
STREAMS = ([f"q{q}-{r}-{c}ch" for q, r, c in CONFIGS]
           + ["abr96", "abr64", "port"])


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.dtype, a.shape, a.view(np.uint8).tobytes()


def _same(a, b):
    """Equal dtype, shape and bit pattern."""
    return _bits(a) == _bits(b)


def _spectra(n, B, seed):
    """Seeded spectra over six decades, with exact zeros and -0.0."""
    rng = np.random.RandomState(seed)
    s = rng.randn(B, n // 2) * 10.0 ** rng.uniform(-3, 3, (B, 1))
    s[rng.rand(B, n // 2) < 0.2] = 0.0
    s[rng.rand(B, n // 2) < 0.05] = -0.0
    return s.astype(np.float32)


def make_streams(d):
    """The ten streams of STREAMS, written under the directory `d`
    (tests/test_torch_lap.py builds the same)."""
    out = {}
    for (q, rate, ch), name in zip(CONFIGS, STREAMS):
        pcm = oracle.make_test_signal(rate=rate, seconds=0.6, ch=ch)
        out[name] = oracle.encode_vbr(pcm, rate, q, str(d / f"{name}.ogg"))
    pcm = oracle.make_test_signal(seconds=0.6)
    for kbps in (96, 64):
        out[f"abr{kbps}"] = oracle.encode_vbr(
            pcm, 44100, 0.0, str(d / f"abr{kbps}.ogg"), managed_kbps=kbps)
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    fe = FastEncoder(2, 44100, 0.5, device="cpu")
    out["port"] = fe.encode_batch([oracle.make_test_signal(seconds=0.6)],
                                  B_long=64, B_short=64)[0]
    return out


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    return make_streams(tmp_path_factory.mktemp("fastdec"))


@pytest.mark.parametrize("n", NS)
def test_imdct_plain_and_host_c_bitwise(n):
    """imdct_plain on the CPU, the port's host C (16-lane and scalar) and
    the JAX package's numpy transform and host C agree bit for bit."""
    spec = _spectra(n, 37, n)
    want = np.asarray(J_imdct(spec, n))
    assert _same(imdct_plain(torch.from_numpy(spec), n).numpy(), want)
    assert _same(imdct(torch.from_numpy(spec), n).numpy(), want)
    # 37 rows: 32 through the 16-lane kernel, 5 through the scalar one
    assert _same(T_native.imdct_batch(spec, n), want)
    assert _same(T_native.imdct_batch(spec[32:], n), want[32:])
    assert _same(J_native.imdct_batch(spec, n), want)


def _brev(m, bits):
    """m's low `bits` bits reversed (the kernel's __brev(m) >> (32 - bits))."""
    out = np.zeros_like(m)
    for k in range(bits):
        out |= ((m >> k) & 1) << (bits - 1 - k)
    return out


def _kernel_schedule(flat, rowoff, n):
    """csrc/imdct.cu's schedule replayed in numpy float32: the rows read
    through the row table `rowoff` (element offsets into `flat`), G =
    2048/n rows a warp (one above 2048) staged with the 16-byte chunk
    swizzle, stage A's items (r, t) with computed gathers and negated
    signs, stage B two radix-2 stages a pass on four pairs (one radix-2
    pass when their count is odd) through the twiddle table, the
    32-point tails one chunk a lane through the working vector's swizzle,
    and stages C and D fused, four m an item, with computed bit reversal
    and 16-byte stores in the kernel's element order; the kernel's
    tables (ImdctKernel.tables on the CPU).  Each pass is vectorized over
    a warp's items, which the kernel runs in any order."""
    f = np.float32
    tab = ImdctKernel.tables(n, torch.device("cpu"))
    T, tw = tab["T"].numpy(), tab["tw"].numpy()
    tw = tw[:len(tw) // 2 * 2].reshape(-1, 2)
    logn = n.bit_length() - 1
    n2, n4, n8 = n >> 1, n >> 2, n >> 3
    G = 2048 // n if n <= 2048 else 1
    nst = logn - 6
    four = np.arange(4)

    def ys(e):
        return e ^ (((e >> 5) & 7) << 2)

    def xs(q):
        return q ^ ((q >> 3) & 1)

    def tw_off(s):
        return (n2 >> 1) - (n2 >> (s + 1))

    def pair(e):
        return ys(e)[:, None] + np.arange(2)

    def bfly(lo, hi, w):
        r0, r1 = hi[:, 0] - lo[:, 0], hi[:, 1] - lo[:, 1]
        nh = np.stack([hi[:, 0] + lo[:, 0], hi[:, 1] + lo[:, 1]], 1)
        nl = np.stack([r1 * w[:, 1] + r0 * w[:, 0],
                       r1 * w[:, 0] - r0 * w[:, 1]], 1)
        return nl, nh

    R = len(rowoff)
    out = np.zeros((R, n), f)
    o = out.reshape(R, n // 4, 4)
    for grp in range(-(-R // G)):
        # the group's spectra, 16-byte chunks through the swizzle
        x = np.zeros(G * n2, f)
        q = np.arange(G * n2 // 4)
        r, j = q // (n2 // 4), q % (n2 // 4)
        ok = grp * G + r < R
        src = rowoff[grp * G + r[ok]] + 4 * j[ok]
        x[(4 * xs(q[ok]))[:, None] + four] = flat[src[:, None] + four]
        y = np.zeros(G * n2, f)
        # stage A: item (r, t) reads the 8 floats at n2 - 8 - 8t
        u = np.arange(G * n2 // 8)
        r, t = u // (n2 // 8), u % (n2 // 8)
        qq = r * (n2 // 4) + n2 // 4 - 2 - 2 * t
        x0, x1, x2, x3 = x[(4 * xs(qq))[:, None] + four].T
        x4, x5, x6, x7 = x[(4 * xs(qq + 1))[:, None] + four].T
        t1 = T[(n4 + 4 * t)[:, None] + four].T
        t2 = T[(n4 - 4 * (t + 1))[:, None] + four].T
        y[ys(r * n2 + n4 - 4 * (t + 1))[:, None] + four] = np.stack(
            [-x3 * t1[3] + -x1 * t1[2], x1 * t1[3] + -x3 * t1[2],
             -x7 * t1[1] + -x5 * t1[0], x5 * t1[1] + -x7 * t1[0]], 1)
        y[ys(r * n2 + n4 + 4 * t)[:, None] + four] = np.stack(
            [x4 * t2[3] + x6 * t2[2], x4 * t2[2] + -x6 * t2[3],
             x0 * t2[1] + x2 * t2[0], x0 * t2[0] + -x2 * t2[1]], 1)
        # stage B: two stages a pass on pairs q0 + {0, 1, 2, 3} P/4
        s = 0
        while s + 1 < nst:
            P = n2 >> s
            nm = P >> 3
            u = np.arange(G * n2 // 8)
            r, k = u // (n2 // 8), u % (n2 // 8)
            b, m = k // nm, k % nm
            q0 = r * n2 + b * P + 2 * m
            qs = [q0 + i * (P // 4) for i in range(4)]
            v = [y[pair(e)] for e in qs]
            v[0], v[2] = bfly(v[0], v[2], tw[tw_off(s) + m])
            v[1], v[3] = bfly(v[1], v[3], tw[tw_off(s) + m + nm])
            w = tw[tw_off(s + 1) + m]
            v[0], v[1] = bfly(v[0], v[1], w)
            v[2], v[3] = bfly(v[2], v[3], w)
            for e, vv in zip(qs, v):
                y[pair(e)] = vv
            s += 2
        if s < nst:
            P = n2 >> s
            nc = P >> 2
            u = np.arange(G * n2 // 4)
            r, k = u // (n2 // 4), u % (n2 // 4)
            b, m = k // nc, k % nc
            lo = r * n2 + b * P + 2 * m
            hi = lo + P // 2
            vl, vh = bfly(y[pair(lo)], y[pair(hi)], tw[tw_off(s) + m])
            y[pair(lo)], y[pair(hi)] = vl, vh
        # the tails: chunk c's float4 k at k ^ (c & 7)
        c = np.arange(G * n2 // 32)
        idx = (32 * c[:, None, None]
               + 4 * (np.arange(8)[None, :, None] ^ (c[:, None, None] & 7))
               + four).reshape(len(c), 32)
        y[idx] = J_bf32(y[idx], np)
        # stages C and D: item (r, v) takes m = 4v .. 4v+3
        u = np.arange(G * n8 // 4)
        r, v = u // (n8 // 4), u % (n8 // 4)
        row = grp * G + r
        tc = T[(n + 8 * v)[:, None] + np.arange(8)].T
        td = T[(n2 + 8 * v)[:, None] + np.arange(8)].T
        tr = T[(n - 8 - 8 * v)[:, None] + np.arange(8)].T
        a, bb, a2, b2 = [], [], [], []
        for jj in range(4):
            e1 = _brev(4 * v + jj, logn - 1)
            e0 = ((~e1) & (n2 - 1)) - 1
            a0, a1 = y[pair(r * n2 + e0)].T
            b0, b1 = y[pair(r * n2 + e1)].T
            cC, sC = tc[2 * jj], tc[2 * jj + 1]
            cD, sD = td[2 * jj], td[2 * jj + 1]
            cR, sR = tr[6 - 2 * jj], tr[7 - 2 * jj]     # pair n4-1-m
            r0, r1 = a1 - b1, a0 + b0
            r2, r3 = r1 * cC + r0 * sC, r1 * sC - r0 * cC
            r0h, r1h = f(0.5) * (a1 + b1), f(0.5) * (a0 - b0)
            z0, z1 = r0h + r2, r1h + r3
            a.append(z0 * sD - z1 * cD)
            bb.append(-(z0 * cD + z1 * sD))
            z0, z1 = r0h - r2, r3 - r1h
            a2.append(z0 * sR - z1 * cR)
            b2.append(-(z0 * cR + z1 * sR))
        ok = row < R
        a, bb, a2, b2 = (np.stack(z, 1)[ok] for z in (a, bb, a2, b2))
        rr, vv = row[ok], v[ok]
        o[rr, n4 // 4 - 1 - vv] = a[:, ::-1]
        o[rr, n4 // 4 + vv] = -a
        o[rr, (n2 + n4) // 4 - 1 - vv] = bb[:, ::-1]
        o[rr, (n2 + n4) // 4 + vv] = bb
        o[rr, vv] = a2
        o[rr, n2 // 4 - 1 - vv] = -a2[:, ::-1]
        o[rr, n2 // 4 + vv] = b2
        o[rr, n // 4 - 1 - vv] = b2[:, ::-1]
    return out


@pytest.mark.parametrize("n", NS)
def test_imdct_kernel_schedule_emulated(n):
    """The CUDA kernel's schedule and tables, replayed in numpy through a
    row table that reorders and spaces the rows (and leaves a partial
    last row group), give the reference transform bit for bit (the kernel
    itself runs only on the card: test_torch_cuda.py, chip_smoke.py phase
    6)."""
    R = (2048 // n if n <= 2048 else 1) * 2 + 1
    spec = _spectra(n, R, 100 + n)
    rng = np.random.RandomState(n)
    slot = rng.permutation(R) * (n // 2 + 4 * rng.randint(0, 3))
    flat = np.full(slot.max() + n // 2 + 8, np.nan, np.float32)
    for k in range(R):
        flat[slot[k]:slot[k] + n // 2] = spec[k]
    tab = ImdctKernel.tables(n, torch.device("cpu"))
    assert tab["T"].numel() == n + n // 4
    assert tab["tw"].numel() == max(1, n // 2 - 32)
    assert len(_imdct_index_tables(n)["stages"]) == n.bit_length() - 7
    got = _kernel_schedule(flat, slot.astype(np.int64), n)
    assert _same(got, np.asarray(J_imdct(spec, n)))
    # the row-table form of the wrapper, on the CPU (its plain version)
    assert _same(imdct(torch.from_numpy(flat), n, rows=slot).numpy(), got)


def _tables_fields(tb):
    keys = ("t1_all", "sec_all", "soff_all", "book_secbase",
            "book_soffbase", "book_K2", "vals_all", "book_valbase",
            "book_dim", "flcfg", "flcfg_off", "fromdB", "rescfg",
            "rescfg_off", "mode_blockflag", "mode_map", "map_submaps",
            "map_chmux", "map_floorsub", "map_ressub", "cpl_count",
            "cpl_mag", "cpl_ang")
    return ({k: getattr(tb, k) for k in keys},
            (tb.ok, tb.why, tb.Pmax, tb.nmodes, tb.nmaps, tb.modebits,
             tb.submax, tb.maxcpl, tb.pwmax))


@pytest.mark.parametrize("name", STREAMS)
def test_parse_tables_and_arrays_equal(streams, name):
    """StreamParseTables field for field, and parse_packet_arrays' W,
    mode, posts, nonzero and accumulated residues, port against JAX."""
    data = streams[name]
    scan = T_native.ogg_scan(data)
    jscan = J_native.ogg_scan(data)
    # off, lens, gp, eos, serial; the blob up to its last packet's end
    # (its tail is scratch)
    assert all(_same(a, b) for a, b in zip(scan[1:5], jscan[1:5]))
    assert scan[5] == jscan[5]
    blob, off, lens = scan[:3]
    end = int(off[-1] + lens[-1])
    assert _same(blob[:end], jscan[0][:end])
    hdrs = [blob[off[i]:off[i] + lens[i]].tobytes() for i in range(3)]
    tt = T_np.StreamParseTables(T_H.parse_headers(hdrs))
    jt = J_np.StreamParseTables(J_H.parse_headers(hdrs))
    (ta, tm), (ja, jm) = _tables_fields(tt), _tables_fields(jt)
    assert tm == jm and tt.ok
    for k in ta:
        assert _same(ta[k], ja[k]), k
    got = T_np.parse_packet_arrays(tt, blob, off[3:], lens[3:] * 8)
    want = J_np.parse_packet_arrays(jt, blob, off[3:], lens[3:] * 8)
    for k, a, b in zip(("W", "mode", "posts", "nonzero", "res"), got, want):
        assert _same(a, b), k
    assert (got[0] >= 0).all() and len(got[0]) >= 20
    assert _same(T_np.scan_W(tt, blob, off[3:], lens[3:] * 8), got[0])


@pytest.mark.parametrize("name", STREAMS)
def test_decode_equals_jax(streams, name):
    """decode_ogg_fast with the fused host-C drain (device=False) and the
    staged path with the plain IMDCT (device="cpu") against the JAX
    package's decode_ogg_fast."""
    data = streams[name]
    want, jvi = J_fd.decode_ogg_fast(data)
    for device in (False, "cpu"):
        got, vi = T_fd.decode_ogg_fast(data, device=device)
        assert _same(got, want), device
        assert (vi.channels, vi.rate) == (jvi.channels, jvi.rate)
    assert want.shape[1] > 0 and np.isfinite(want).all()


def test_decode_packets_and_batch_paths(streams):
    """FastDecoder.decode_packets with the host-C IMDCT and with the
    plain one; decode_ogg_fast_batch on the CPU (one dispatch wave for
    every stream) against each stream alone, and threads=3 with the
    host-C drain."""
    from vorbis_tpu_torch.bitstream.oggfile import OggStreamReader
    names = ["q0.5-44100-2ch", "q0.2-8000-1ch", "q0.4-48000-6ch", "abr64",
             "port"]
    data = [streams[k] for k in names]
    want = [J_fd.decode_ogg_fast(s)[0] for s in data]
    pkts = list(OggStreamReader(data[0]).packets())
    dec = T_fd._decoder_for(tuple(p for p, _, _ in pkts[:3]))
    assert _same(dec.decode_packets(pkts[3:]), want[0])
    assert _same(dec.decode_packets(pkts[3:], torch.device("cpu")), want[0])
    got = T_fd.decode_ogg_fast_batch(data, device="cpu")
    assert len(got) == len(want)
    assert all(_same(g, w) for (g, _), w in zip(got, want))
    got = T_fd.decode_ogg_fast_batch(data, threads=3, device=False)
    assert all(_same(g, w) for (g, _), w in zip(got, want))


def test_decode_mixed_batch(streams):
    """A batch of 5.1, mono and stereo streams (three blocksize pairs) on
    the CPU: one plan for all of them, rows grouped by blocksize across
    streams, each stream's PCM bitwise equal to device=False and to the
    JAX package's decode_ogg_fast."""
    names = ["q0.4-48000-6ch", "q0.2-8000-1ch", "q0.5-44100-2ch",
             "q-0.1-44100-2ch", "q0.2-8000-1ch"]
    data = [streams[k] for k in names]
    want = [J_fd.decode_ogg_fast(s)[0] for s in data]
    jobs = [T_fd._scan_job(s) for s in data]
    bp = T_fd._BatchPlan(jobs)
    assert bp.pairs == ((256, 2048), (512, 512), (512, 4096))
    assert sorted(bp.group) == [256, 512, 2048, 4096]
    assert len(bp.plan.out_off) == len(data)
    assert sum(R for _, R in bp.group.values()) == sum(
        len(W) * dec.vi.channels for dec, W, *_ in jobs)
    got = T_fd.decode_ogg_fast_batch(data, device="cpu")
    host = T_fd.decode_ogg_fast_batch(data, device=False)
    for (g, vi), (h, _), w, name in zip(got, host, want, names):
        assert _same(g, w) and _same(h, w), name
        assert vi.channels == w.shape[0]


@pytest.fixture(scope="module")
def floor0_streams():
    from tests.test_floor0 import _craft_floor0_stream
    return {seed: _craft_floor0_stream(seed) for seed in (0, 3)}


@pytest.mark.parametrize("path", ["fast", "scalar"])
@pytest.mark.parametrize("seed", [0, 3])
def test_floor0_stream_bitwise(floor0_streams, seed, path):
    """Floor0 (LSP) streams: the port's fast decode (the host-C drain and
    the staged plain IMDCT) or its scalar decoder against the JAX
    package's scalar decoder and fast drain, by bit pattern: inf floor
    gains times zero residue give NaNs on every path
    (tests/test_floor0.py:220-223)."""
    data = floor0_streams[seed]
    want, _ = J_decode_ogg(data)
    assert _same(J_fd.decode_ogg_fast(data)[0], want)
    if path == "fast":
        got = [T_fd.decode_ogg_fast(data, device=d)[0]
               for d in (False, "cpu")]
    else:
        got = [T_decode_ogg(data)[0]]
    assert all(_same(g, want) for g in got)
    assert want.shape[1] > 0


def test_corrupt_and_truncated_streams_dont_crash(streams):
    """Mid-stream corruption and truncation: each path either decodes
    or raises the typed FastDecodeUnsupported, as the JAX package's
    (tests/test_fastdec.py:63, :83); where both decode, they agree."""
    data = streams["q0.5-44100-2ch"]
    rng = np.random.RandomState(1)
    cases = []
    for k in range(3):
        bad = bytearray(data)
        for _ in range(8):
            bad[rng.randint(len(bad) // 2, len(bad))] ^= 0xFF
        cases.append(bytes(bad))
    cases += [data[:len(data) // 3], data[:len(data) * 2 // 3]]
    decoded = 0
    for bad in cases:
        try:
            want = J_fd.decode_ogg_fast(bad)[0]
        except J_fd.FastDecodeUnsupported:
            want = None
        for device in (False, "cpu"):
            try:
                got = T_fd.decode_ogg_fast(bad, device=device)[0]
            except T_fd.FastDecodeUnsupported:
                assert want is None, device
                continue
            assert want is not None and _same(got, want), device
            decoded += 1
    assert decoded >= 4
    # garbage, bit-flipped and cut packets through the parser
    blob, off, lens = T_native.ogg_scan(data)[:3]
    hdrs = [blob[off[i]:off[i] + lens[i]].tobytes() for i in range(3)]
    tb = T_np.StreamParseTables(T_H.parse_headers(hdrs))
    audio = [blob[o:o + n].tobytes() for o, n in zip(off[3:], lens[3:])]
    for _ in range(5):
        junk = [bytes(rng.randint(0, 256, rng.randint(1, 900),
                                  dtype=np.uint8))
                for _ in range(rng.randint(1, 20))]
        T_np.parse_packets(tb, junk)
        cut = [p[:rng.randint(0, len(p))] or b"\x00" for p in audio]
        W = T_np.parse_packets(tb, cut)[0]
        assert len(W) == len(audio)


def test_decode_library_has_no_fallback(monkeypatch):
    """A missing host compiler raises; the decode never falls back to a
    numpy IMDCT or lap."""
    T_native.decode_library.cache_clear()
    monkeypatch.setenv("CC", "")
    monkeypatch.setattr(T_native.shutil, "which", lambda _: None)
    monkeypatch.setattr(T_native, "BUILD_DIR",
                        T_native.BUILD_DIR.parent / "no-such-build")
    try:
        with pytest.raises(RuntimeError, match="host C compiler"):
            T_native.imdct_batch(np.zeros((1, 32), np.float32), 64)
    finally:
        T_native.decode_library.cache_clear()


def test_imdct_wrapper_refuses_bad_input():
    """The wrapper takes its plain version only for a CPU tensor; its
    checks raise on what the kernel does not take."""
    with pytest.raises(ValueError, match="blocksize"):
        imdct(torch.zeros(2, 48), 96)
    with pytest.raises(ValueError, match="unsupported device"):
        imdct(torch.zeros(2, 32, device="meta"), 64)
    k = ImdctKernel()
    k(torch.zeros(3, 32), 64)
    assert k.launches == 0              # the plain version launches nothing
