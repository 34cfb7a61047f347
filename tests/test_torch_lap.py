"""The decode's windowed lap with the granulepos trim
(vorbis_tpu_torch/ops/lap_cuda.py, csrc/lap.cu) on the CPU, bitwise.

The kernel cannot run here, so its span ownership is replayed in numpy
(`lap_replay`, this file only): a CTA owns [c_{p-1}, c_p) n [lo, hi) of a
stream (c_p packet p's center), or [lo, c_0) before its first packet, or
[c_last, hi) after its last, and writes each sample once as
(t + block p-1 x window) + block p x window, t the stream's tail there
(its initial values) or +0.  The replay and `lap_plain` (the
packet-order slice add into a buffer that holds the tail) are held, by
bit pattern, to the port's host C (vn_lap_add, then _trim_range) and to
the JAX package's lap on the IMDCT blocks of the ten streams of
tests/test_torch_fastdec.py, on seeded cases at every blocksize 64-8192
with both trims, on a crafted case of -0.0 and subnormal products, and
on seeded cases with tails and the spans before the first and after the
last center (the chunked decode's lap, `tail_inputs`).  A second test
shows the premise: no sample has more than two blocks with a nonzero
window, and before the first center or after the last only one, for
every (lW, W, nW) transition of each blocksize pair the modes use.  JAX
is imported by the one test that compares with it, so `lap_case`,
`lap_inputs` and `tail_inputs` (the cases of chip_smoke.py phase 6)
load where only the port is installed.
"""

import types

import numpy as np
import pytest
import torch

from vorbis_tpu_torch.models import fastdec as T_fd
from vorbis_tpu_torch.native import imdct_batch
from vorbis_tpu_torch.ops.lap_cuda import LapKernel, LapPlan, lap, lap_plain
from vorbis_tpu_torch.ops.window import hybrid_window

# one torch thread a pytest-xdist worker (see test_torch_switching.py)
torch.set_num_threads(1)

# tests/test_torch_fastdec.py STREAMS (checked in the fixture)
STREAMS = ["q0.5-44100-2ch", "q0.3-44100-2ch", "q-0.1-44100-2ch",
           "q1.0-44100-2ch", "q0.2-8000-1ch", "q0.4-48000-6ch",
           "q0.5-96000-2ch", "abr96", "abr64", "port"]
# the (short, long) blocksizes of models/modes.py's setup templates
MODE_PAIRS = [(256, 2048), (512, 512), (512, 1024), (512, 4096),
              (1024, 1024)]
# pairs that put every blocksize 64-8192 through the lap
CASE_PAIRS = [(64, 128), (128, 1024), (256, 2048), (512, 4096),
              (2048, 8192), (512, 512)]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def _same(a, b):
    return a.shape == b.shape and np.array_equal(_bits(a), _bits(b))


def _fake_decoder(ch, bs0, bs1):
    """A FastDecoder with only the fields the lap reads."""
    dec = T_fd.FastDecoder.__new__(T_fd.FastDecoder)
    dec.vi = types.SimpleNamespace(channels=ch, blocksizes=(bs0, bs1))
    return dec


def lap_case(bs0, bs1, npkt, ch, seed, trim=True):
    """A seeded stream for the lap: (decoder, W, gps, eoss, blocks), with
    runs of both blocksizes, (ch, n) blocks over six decades with exact
    zeros and -0.0, and labels that cut the start and (at eos) the end."""
    rng = np.random.RandomState(seed)
    W = np.zeros(npkt, np.int32)
    for p in range(1, npkt):
        W[p] = W[p - 1] if rng.rand() < 0.7 else 1 - W[p - 1]
    dec = _fake_decoder(ch, bs0, bs1)
    ns, pos, _, _, _ = T_fd._lap_geometry(
        W, bs0, bs1, np.full(npkt, -1), np.zeros(npkt, bool))
    centers = pos + ns // 2
    gps = np.full(npkt, -1, np.int64)
    eoss = np.zeros(npkt, bool)
    if trim:
        k = min(3, npkt - 2)
        g0 = int(centers[k] - centers[0]) - rng.randint(1, 200)
        gps[k] = g0
        gps[-1] = g0 + int(centers[-1] - centers[k]) - rng.randint(1, 300)
        eoss[-1] = True
    blocks = []
    for n in ns:
        b = rng.randn(ch, n) * 10.0 ** rng.uniform(-3, 3, (ch, 1))
        b[rng.rand(ch, n) < 0.05] = 0.0
        b[rng.rand(ch, n) < 0.05] = -0.0
        blocks.append(b.astype(np.float32))
    return dec, W, gps, eoss, blocks


def signed_zero_case():
    """A lap_case stream (64 / 256, stereo, no trim) whose blocks hold
    only -0.0, +0.0, the smallest subnormals, subnormals and tiny
    normals: products of -0.0 and subnormal products everywhere."""
    rng = np.random.RandomState(5)
    dec, W, gps, eoss, _ = lap_case(64, 256, 24, 2, 7, trim=False)
    vals = np.array([-0.0, 0.0, -1e-45, 1e-45, -3e-39, 3e-39, -1e-38,
                     2e-38], np.float32)
    ns = np.where(W == 1, 256, 64)
    return dec, W, gps, eoss, [vals[rng.randint(0, len(vals), (2, n))]
                               for n in ns]


def lap_inputs(cases):
    """(blocks, wins, plan, wants) of a batch of lap_case streams: the
    flat blocks in the device path's layout (fastdec._BatchPlan), the
    window buffer, the plan, and each stream's PCM from the host C
    (vn_lap_add, then the trim: FastDecoder._lap_and_trim)."""
    jobs = [(dec, W, None, gps, eoss) for dec, W, gps, eoss, _ in cases]
    bp = T_fd._BatchPlan(jobs)
    flat = np.zeros(bp.nblocks, np.float32)
    wants = []
    for k, (dec, W, gps, eoss, blocks) in enumerate(cases):
        blk = bp.plan.streams[k][3]
        for p, b in enumerate(blocks):
            flat[blk[p]:blk[p] + b.size] = b.reshape(-1)
        groups, gidx = _host_groups(W, blocks)
        wants.append(dec._lap_and_trim(W, groups, gidx, gps, eoss))
    wins = np.concatenate([T_fd._win_table(*bs)[0] for bs in bp.pairs])
    return flat, wins, bp.plan, wants


def _host_groups(W, blocks):
    """The host C lap's layout: blocks (G, ch, n) a W group, gidx."""
    groups, gidx = {}, np.zeros(len(W), np.int32)
    for Wv in (0, 1):
        idx = np.flatnonzero(W == Wv)
        if len(idx):
            groups[Wv] = np.ascontiguousarray(
                np.stack([blocks[p] for p in idx]))
            gidx[idx] = np.arange(len(idx), dtype=np.int32)
    return groups, gidx


def tail_inputs(cases, seed=0):
    """(blocks, wins, plan, tails, wants) of a batch of lap_case streams
    whose lap starts from a tail, as a chunk of the chunked decode does:
    each stream's seeded initial values from at or before its first
    center to past its second (as a carried block's long-long window
    reaches past the next center), in a flat buffer with a channel
    stride longer than the tail, and its trim from before its first
    center to half its last block past its last (the spans before c_0
    and after c_last).  Each want is the host C's vn_lap_add into a
    buffer that holds the tail, then the cut."""
    flat, wins, plan0, _ = lap_inputs(cases)
    rng = np.random.RandomState(seed)
    streams, tails, data, wants, at = [], [], [], [], 0
    for (dec, W, _, _, blocks), s in zip(cases, plan0.streams):
        ch, n, pos, blk, win, _, _ = s
        n, pos = np.asarray(n, np.int64), np.asarray(pos, np.int64)
        c = pos + n // 2
        lo = max(0, int(c[0]) - rng.randint(1, 100))
        hi = int(c[-1] + n[-1] // 2)
        t_pos = max(0, int(c[0]) - rng.randint(0, 50))
        t_len = int(c[1] + n[1] // 4) - t_pos + rng.randint(0, 9)
        stride = t_len + 3
        t = (rng.randn(ch, stride)
             * 10.0 ** rng.uniform(-3, 3, (ch, 1))).astype(np.float32)
        t[rng.rand(ch, stride) < 0.05] = 0.0
        streams.append((ch, n, pos, blk, win, lo, hi))
        tails.append((at, stride, t_pos, t_len))
        data.append(t.reshape(-1))
        at += t.size
        bs0, bs1 = dec.vi.blocksizes
        out = np.zeros((ch, max(hi, t_pos + t_len, int((pos + n).max()))
                        + 8), np.float32)
        out[:, t_pos:t_pos + t_len] = t[:, :t_len]
        lW = np.concatenate([[0], W[:-1]])
        nW = np.concatenate([W[1:], [W[-1]]])
        keys = {(int(a), int(b), int(d)) for a, b, d in zip(lW, W, nW)}
        groups, gidx = _host_groups(W, blocks)
        dec._native_lap(groups, gidx, W, lW, nW, pos,
                        {k: hybrid_window(bs0, bs1, *k) for k in keys},
                        out, bs0, bs1)
        wants.append(out[:, lo:hi].copy())
    return flat, wins, LapPlan(streams, tails), np.concatenate(data), wants


def lap_replay(blocks, wins, plan, tails=None):
    """csrc/lap.cu replayed in numpy float32: a CTA per span s in
    [0, packets] between packets s - 1 and s, which writes [c_{s-1}, c_s)
    n [lo, hi) of their stream, or, where they lie in two streams (or
    one is missing), [c_{s-1}, hi) of the first and [lo, c_s) of the
    second; each sample once as (t + a) + b, t its tail value or +0, a
    and b added where their block covers it.  Returns the flat output
    and the number of writes a sample got."""
    f = np.float32
    out = np.zeros(plan.total, f)
    writes = np.zeros(plan.total, np.int64)
    pk, st = plan.pk, plan.st

    def span(A, B, S):
        lo, hi, ch, o, t_off, t_stride, t_pos, t_len = S
        nA = A[3] & 0xffff if A is not None else 0
        nB = B[3] & 0xffff if B is not None else 0
        a = max(A[1] + nA // 2, lo) if A is not None else lo
        b = min(B[1] + nB // 2, hi) if B is not None else hi
        if a >= b:
            return
        i = np.arange(b - a)
        for c in range(ch):
            v = np.zeros(b - a, f)
            if t_len:
                jt = a - t_pos + i
                ok = (jt >= 0) & (jt < t_len)
                v[ok] = tails[t_off + c * t_stride + jt[ok]]
            if A is not None:
                ja = a - A[1] + i
                ok = ja < nA
                v[ok] = v[ok] + (blocks[A[0] + c * nA + ja[ok]]
                                 * wins[A[2] + ja[ok]])
            if B is not None:
                jb = a - B[1] + i
                ok = jb >= 0
                v[ok] = v[ok] + (blocks[B[0] + c * nB + jb[ok]]
                                 * wins[B[2] + jb[ok]])
            at = o + c * (hi - lo) + (a - lo) + i
            out[at] = v
            writes[at] += 1

    for s in range(len(pk) + 1):
        A = pk[s - 1] if s > 0 else None
        B = pk[s] if s < len(pk) else None
        if A is not None and B is not None and A[3] >> 16 == B[3] >> 16:
            span(A, B, st[B[3] >> 16])
            continue
        if A is not None:
            span(A, None, st[A[3] >> 16])
        if B is not None:
            span(None, B, st[B[3] >> 16])
    return out, writes


def _check_all(flat, wins, plan, wants, tails=None):
    tt = None if tails is None else torch.from_numpy(tails)
    got_plain = lap_plain(torch.from_numpy(flat), torch.from_numpy(wins),
                          plan, tt)
    got_wrap = lap(torch.from_numpy(flat), torch.from_numpy(wins), plan,
                   tails=tt)
    got_replay, writes = lap_replay(flat, wins, plan, tails)
    assert (writes == 1).all()          # every sample, once
    for k, want in enumerate(wants):
        for got in (got_plain, got_wrap, torch.from_numpy(got_replay)):
            assert _same(plan.out_view(got, k).numpy(), want), k


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    from tests.test_torch_fastdec import STREAMS as names, make_streams
    assert names == STREAMS
    return make_streams(tmp_path_factory.mktemp("lap"))


@pytest.mark.parametrize("name", STREAMS)
def test_lap_matches_host_c_and_jax(streams, name):
    """On a stream's host-C IMDCT blocks: the replay, lap_plain and the
    CPU wrapper equal vn_lap_add + _trim_range bit for bit, and so does
    the JAX package's lap (its FastDecoder._lap_and_trim)."""
    from vorbis_tpu.models import fastdec as J_fd
    dec, W, res, gp, eos = T_fd._scan_job(streams[name])
    bs0, bs1 = dec.vi.blocksizes
    ch = dec.vi.channels
    blocks = []
    for p, Wv in enumerate(W):
        n = bs1 if Wv else bs0
        blocks.append(imdct_batch(np.ascontiguousarray(
            res[p, :, :n // 2]), n))
    cases = [(dec, W, gp, eos, blocks)]
    flat, wins, plan, wants = lap_inputs(cases)
    _check_all(flat, wins, plan, wants)
    jdec = J_fd.FastDecoder.__new__(J_fd.FastDecoder)
    jdec.vi = types.SimpleNamespace(channels=ch, blocksizes=(bs0, bs1))
    groups, gidx = _host_groups(W, blocks)
    assert _same(jdec._lap_and_trim(W, groups, gidx, gp, eos), wants[0])
    assert wants[0].shape[1] > 0


def test_lap_seeded_cases_every_blocksize():
    """Seeded streams of every blocksize pair in CASE_PAIRS (n = 64-8192),
    one, two and six channels, with start and end trims, in one batch
    (per-stream output offsets, mixed window tables): replay, plain and
    wrapper against the host C."""
    cases = [lap_case(bs0, bs1, 40, (1, 2, 6)[k % 3], k, trim=k % 2 == 0)
             for k, (bs0, bs1) in enumerate(CASE_PAIRS)]
    _check_all(*lap_inputs(cases))


def test_lap_tails_and_edge_spans():
    """The chunked decode's lap: seeded streams of every blocksize pair
    in CASE_PAIRS whose lap starts from a tail that reaches past the
    second center, trimmed from before the first center to half the last
    block past the last, in one batch: replay, plain and wrapper against
    the host C's sum into a buffer that holds the tail."""
    cases = [lap_case(bs0, bs1, 30, (1, 2, 6)[k % 3], k, trim=False)
             for k, (bs0, bs1) in enumerate(CASE_PAIRS)]
    flat, wins, plan, tails, wants = tail_inputs(cases, seed=3)
    _check_all(flat, wins, plan, wants, tails)
    for (_, n, pos, _, _, lo, hi), s in zip(plan.streams, plan.st):
        assert lo < pos[0] + n[0] // 2 and s[6] + s[7] > pos[1] + n[1] // 2
    # one packet: its two edge spans only
    flat, wins, plan, tails, wants = tail_inputs(
        [lap_case(256, 2048, 2, 2, 9, trim=False)], seed=4)
    one = LapPlan([(ch, n[:1], pos[:1], blk[:1], win[:1], lo,
                    int(pos[0] + n[0]))
                   for ch, n, pos, blk, win, lo, _ in plan.streams],
                  [tuple(plan.st[0, 4:])])
    got, writes = lap_replay(flat, wins, one, tails)
    plain = lap_plain(torch.from_numpy(flat), torch.from_numpy(wins), one,
                      torch.from_numpy(tails))
    assert (writes == 1).all() and _same(got, plain.numpy())


def test_lap_signed_zero_and_subnormal_products():
    """Products that are -0.0 (a -0.0 sample, or a negative subnormal
    times a window that rounds it away) and products that are subnormal:
    the output starts from +0 as the host C's buffer does, so a -0.0 sum
    never appears, and subnormals survive; held bitwise to the host C."""
    dec, W, gps, eoss, blocks = signed_zero_case()
    flat, wins, plan, wants = lap_inputs([(dec, W, gps, eoss, blocks)])
    _check_all(flat, wins, plan, wants)
    bits = _bits(wants[0])
    assert (bits == 0x80000000).sum() == 0          # no -0.0 at all
    assert (bits == 0).sum() > 100                  # +0.0 from -0.0 sums
    tiny = (bits & 0x7f800000) == 0
    assert (tiny & ((bits & 0x7fffffff) != 0)).sum() > 100   # subnormals
    # the case has samples whose two products are both -0.0
    got, _ = lap_replay(flat, wins, plan)
    f = np.float32
    neg0 = 0
    for p in range(1, len(W)):
        A, B = plan.pk[p - 1], plan.pk[p]
        nA, nB = A[3] & 0xffff, B[3] & 0xffff
        a, b = A[1] + nA // 2, B[1] + nB // 2
        i = np.arange(a, b)
        ok = (i - A[1] < nA) & (i - B[1] >= 0)
        ja, jb = (i - A[1])[ok], (i - B[1])[ok]
        pa = flat[A[0] + ja] * wins[A[2] + ja]
        pb = flat[B[0] + jb] * wins[B[2] + jb]
        neg0 += int(((_bits(pa) == 0x80000000)
                     & (_bits(pb) == 0x80000000)).sum())
    assert neg0 > 10 and f(0) + f(-0.0) + f(-0.0) == 0


@pytest.mark.parametrize("pair", MODE_PAIRS)
def test_at_most_two_nonzero_contributors(pair):
    """For every (lW, W, nW) transition (a de Bruijn sequence of W holds
    all eight), a sample has a nonzero window in at most two blocks, in
    [c_{p-1}, c_p) only in blocks p-1 and p, before the first center only
    in block 0 and after the last only in the last block: the premise of
    the kernel's span ownership."""
    bs0, bs1 = pair
    W = np.array([0, 0, 0, 1, 0, 1, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0],
                 np.int32)
    trip = {tuple(W[p - 1:p + 2]) for p in range(1, len(W) - 1)}
    assert len(trip) == 8
    ns, pos, winid, _, _ = T_fd._lap_geometry(
        W, bs0, bs1, np.full(len(W), -1), np.zeros(len(W), bool))
    length = int((pos + ns).max())
    nz = np.zeros((len(W), length), bool)
    for p in range(len(W)):
        wid = int(winid[p])
        w = hybrid_window(bs0, bs1, (wid >> 2) & 1, (wid >> 1) & 1, wid & 1)
        nz[p, pos[p]:pos[p] + ns[p]] = w != 0
    assert nz.sum(0).max() <= 2
    centers = pos + ns // 2
    for p in range(1, len(W)):
        span = nz[:, centers[p - 1]:centers[p]]
        others = np.delete(span, [p - 1, p], axis=0)
        assert not others.any(), p
    assert not nz[1:, :centers[0]].any()
    assert not nz[:-1, centers[-1]:].any()


def test_lap_wrapper_refuses_bad_input():
    """The wrapper takes the plain version only for a CPU tensor; its
    checks refuse a plan that reads outside blocks or windows."""
    flat, wins, plan, _ = lap_inputs([lap_case(256, 2048, 12, 2, 3)])
    k = LapKernel()
    k(torch.from_numpy(flat), torch.from_numpy(wins), plan)
    assert k.launches == 0              # the plain version launches nothing
    with pytest.raises(ValueError, match="unsupported device"):
        k(torch.zeros(4, device="meta"), torch.zeros(4), plan)
    with pytest.raises(ValueError, match="outside `blocks`"):
        LapKernel._checked(plan, len(flat) - 1, len(wins))
    with pytest.raises(ValueError, match="outside `wins`"):
        LapKernel._checked(plan, len(flat), len(wins) - 1)
    flat, wins, plan, tails, _ = tail_inputs([lap_case(256, 2048, 12, 2, 3)])
    LapKernel._checked(plan, len(flat), len(wins), len(tails))
    with pytest.raises(ValueError, match="outside `tails`"):
        LapKernel._checked(plan, len(flat), len(wins), len(tails) - 4)
