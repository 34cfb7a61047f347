"""The port's cross-frame psy state and long-only encode_batch
(vorbis_tpu_torch/ops/psydevice.py, the two-phase steps of
ops/encdevice.py, models/fastenc.py encode_batch, the host C pager and
blockout schedule) against vorbis_tpu, both on the CPU.

Tolerances, each with its cause and the count measured on this input:
  * host copies (annotations, ampmax/lowcomp/poste recurrences, M3
    parameters, LPC edge pads) and the host C (schedule, pager): exact.
  * device half on identical inputs (noisemask_tail long and short with
    ntfix_trans/ntfix_short, M2, M8, M9, the low-compand tval,
    _m6_promote, _normalize_promote at q0.2): the float ops run in the
    JAX order; what could differ is the order of a few sums (the
    8-bin mean of ntfix_trans, M8's lm.sum(-1) >= -95*part) and
    XLA:CPU's FMA contraction (normalize's acc + acc*npk*npk).  M6's
    imbalance sums (against rdef > 1) and normalize's acc (against
    floor(acc - thresh)) sum in XLA:CPU's order at each site
    (ops/xla_f32.py SUM_LANES, tests/test_torch_couple.py); the direct
    jitted _normalize_promote below sums left to right, its own
    fusion's order, where the port's coupled site takes 16 lanes.
    Measured: every stage bitwise equal, 0 flips,
    but for ntfix_short, whose inmod = -70 + (sp + 70) * 0.1 XLA:CPU
    contracts into an FMA: 131 of 16384 short logmask values differ,
    by at most 1.5e-5 dB.  Asserted: at most 0.1% of the outputs
    differ (2% and 1e-4 dB for the short tail).
  * make_probe_step on identical frames: md, logmdct, fit1, dB and the
    lastmdct rows L are bitwise equal (the analysis front runs in
    XLA:CPU's rounding, tests/test_torch_mdct.py); the tone analysis's
    FFT rounds otherwise, and the four reductions the host reads (lam,
    hi_th, upt, unt) sum in another order: equal to 1e-4 relative, and
    the host decisions they feed (M5 latch h > -40 / h < -50, M2's
    u^2 > 15 v^2, the per-frame ampmax) counted: 0 flips measured, at
    most 1% asserted.
  * make_finish_step on identical probe outputs and fstate: 63 of 64
    packets byte-identical measured and asserted; the floor's
    bin -> segment moments sum in another order than XLA's f32 dot
    (test_torch_floor.py) and move the last.
  * whole slice (two streams, 1.0 s and 0.7 s of the oracle signal,
    B_long=64 on both sides): 75 of 77 packets byte-identical measured
    and asserted, bytes within 0.01%; with the JAX package's floor
    moments swapped into the port, 77 of 77: nothing else moves a
    packet.
The stateful stream's quality gate and input kinds are in
test_torch_stream.py, beside the stateless ones.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import oracle
from vorbis_tpu.bitstream.oggfile import OggStreamReader
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu.ops import psydevice as JPD
from vorbis_tpu.utils import lpc as J_lpc
from vorbis_tpu_torch import native as T_native
from vorbis_tpu_torch.bitstream.oggfile import OggStreamWriter
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import psydevice as TPD
from vorbis_tpu_torch.utils import lpc as T_lpc

# The suite runs under pytest-xdist with several workers to the host's
# cores; one torch thread a worker keeps torch's OpenMP pools from
# oversubscribing them (the port's test files took 672 s with 6 workers
# on 8 cores at torch's default, 70 s at one thread).
torch.set_num_threads(1)

B = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _packets(ogg):
    return [p for p, _, _ in OggStreamReader(ogg).packets()][3:]


# ---------------------------------------------------------------------------
# host copies, bit for bit

def _ann_inputs(seed, S=3, F=200):
    rng = np.random.RandomState(seed)
    Ws = (rng.rand(S, F) < 0.8).astype(np.int64)
    imp = (rng.rand(S, F) < 0.3) & (Ws == 0)
    return Ws, imp


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def test_annotate_frames_host_copy():
    Ws, imp = _ann_inputs(0)
    want = JPD.annotate_frames_nd(Ws, imp)
    got = TPD.annotate_frames_nd(Ws, imp)
    assert want.keys() == got.keys()
    assert all(_same(got[k], want[k]) for k in want)
    one = TPD.annotate_frames(Ws[1], imp[1])
    assert all(_same(one[k], JPD.annotate_frames(Ws[1], imp[1])[k])
               for k in one)


def test_ampmax_lowcomp_poste_host_copy():
    Ws, imp = _ann_inputs(1)
    rng = np.random.RandomState(2)
    lam = (rng.randn(*Ws.shape) * 10 - 20).astype(np.float32)
    assert _same(TPD.ampmax_seq_nd(lam, Ws, (256, 2048), 44100, -6.0),
                 JPD.ampmax_seq_nd(lam, Ws, (256, 2048), 44100, -6.0))
    ann = JPD.annotate_frames_nd(Ws, imp)
    bm, lwbm = ann["bm"], ann["lW_bm"]
    hi = (rng.randn(*Ws.shape) * 8 - 45).astype(np.float32)
    mnt = [(0.93, 9999.0), (0.93, 0.3), (1.0, 9999.0), (1.0, 0.2)]
    assert _same(TPD.lowcomp_seq_nd(hi, bm, lwbm, mnt),
                 JPD.lowcomp_seq_nd(hi, bm, lwbm, mnt))
    up = np.abs(rng.randn(*Ws.shape) * 50).astype(np.float32)
    un = np.abs(rng.randn(*Ws.shape) * 20).astype(np.float32)
    a = {"bm": bm, "lW_bm": lwbm}
    assert _same(TPD.poste_seq(up, un, a, 2048),
                 JPD.poste_seq(up, un, a, 2048))


@pytest.mark.parametrize("n2s,managed", [(128, False), (256, False),
                                         (128, True), (512, False)])
def test_m3_param_seq_host_copy(n2s, managed):
    Ws, imp = _ann_inputs(3)
    ann = JPD.annotate_frames_nd(Ws, imp)
    for toneatt in (2.0, 4.0):
        got = TPD.m3_param_seq(ann, n2s, toneatt, True, managed)
        want = JPD.m3_param_seq(ann, n2s, toneatt, True, managed)
        assert got.keys() == want.keys()
        assert all(_same(got[k], want[k]) for k in want)


def test_lpc_extrapolate_host_copy():
    x = oracle.make_test_signal(seconds=0.2)[0]
    for order, n in ((16, 1024), (32, 6144), (32, 0)):
        assert _same(T_lpc.lpc_extrapolate(x, order, n),
                     J_lpc.lpc_extrapolate(x, order, n))
    assert _same(T_lpc.lpc_from_data(x[:512], 8),
                 J_lpc.lpc_from_data(x[:512], 8))


# ---------------------------------------------------------------------------
# host C against its plain versions

@pytest.mark.parametrize("density,n0,n1", [
    (0.0, 256, 2048), (0.003, 256, 2048), (0.3, 256, 2048),
    (0.02, 512, 4096), (0.05, 1024, 1024)])
def test_schedule_host_c_equals_plain_walk(density, n0, n1):
    rng = np.random.RandomState(int(density * 1000) + n0)
    for ns in (44100, 100003, 5000):
        nmk = (ns + 5 * (n1 // 2) + 63) // 64
        marks = rng.rand(nmk) < density
        got = T_native.schedule(marks, ns, n0, n1)
        want = TFE._schedule_plain(marks, ns, n0, n1)
        assert len(got[0]) > ns // n1
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_ogg_pages_host_c_equals_plain_pager():
    rng = np.random.RandomState(6)
    sizes = rng.choice([0, 1, 254, 255, 256, 600, 3000, 70], 400)
    blob = rng.randint(0, 256, int(sizes.sum()), dtype=np.uint8)
    off = np.cumsum(sizes) - sizes
    gps = np.cumsum(rng.randint(100, 1100, 400)).astype(np.int64)
    w0, w1 = OggStreamWriter(1234), OggStreamWriter(1234)
    for w in (w0, w1):
        w.packetin(b"\x01vorbis", 0)
        w.flush()
    pages, w0.pageno = T_native.ogg_pages(
        blob, np.zeros(0, np.uint8), off, np.zeros(400, np.uint8), sizes,
        gps, 1234, w0.pageno)
    w0._pages.append(pages)
    TFE._write_audio_pages(
        w1, lambda i: blob[off[i]:off[i] + sizes[i]].tobytes(), sizes, gps)
    out = w0.pageout_all()
    assert out == w1.pageout_all() and w0.pageno == w1.pageno > 20
    got = [p for p, _, _ in OggStreamReader(out).packets()][1:]
    assert got == [blob[o:o + s].tobytes() for o, s in zip(off, sizes)]


def test_host_c_has_no_python_fallback(monkeypatch):
    """A missing host compiler raises for the pager and the schedule;
    neither falls back to its plain version."""
    native = T_native
    native.host_library.cache_clear()
    monkeypatch.setenv("CC", "")
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    monkeypatch.setattr(native, "BUILD_DIR",
                        native.BUILD_DIR.parent / "no-such-build")
    try:
        with pytest.raises(RuntimeError, match="host C compiler"):
            native.schedule(np.zeros(100, bool), 4000, 256, 2048)
        with pytest.raises(RuntimeError, match="host C compiler"):
            native.ogg_pages(np.zeros(4, np.uint8), np.zeros(0, np.uint8),
                             np.zeros(1, np.int64), np.zeros(1, np.uint8),
                             np.ones(1, np.int64), np.ones(1, np.int64),
                             1, 0)
    finally:
        native.host_library.cache_clear()


# ---------------------------------------------------------------------------
# the slice: both encoders, both pipelines, one JAX compile

@pytest.fixture(scope="module")
def encs():
    return (JFE(2, 44100, 0.5, switching=False),
            TFE(2, 44100, 0.5, switching=False, device="cpu"))


@pytest.fixture(scope="module")
def pcms():
    pcm = oracle.make_test_signal(seconds=1.0)
    return [pcm, np.ascontiguousarray(pcm[:, :30870])]


@pytest.fixture(scope="module")
def streams(encs, pcms):
    """Both packages' encode_batch of the two streams at B_long=64 (the
    one XLA compile of the JAX two-phase steps in this module)."""
    jfe, tfe = encs
    return (jfe.encode_batch(pcms, B_long=B),
            tfe.encode_batch(pcms, B_long=B))


@pytest.fixture(scope="module")
def probe(encs, pcms, streams):
    """One 64-frame long batch through both probe steps on the same
    frames (x64 from each package's own set-up, checked equal)."""
    jfe, tfe = encs
    xj, perj = jfe._prepare_switched(pcms, False)
    xt, pert = tfe._prepare_switched(pcms, False)
    st = np.concatenate([r["starts"][r["li"]] for r in perj])[:B]
    wd = np.concatenate([r["wid"][r["li"]] for r in perj])[:B]
    sv = np.stack([st, wd, np.zeros(B, np.int64)]).astype(np.int32)
    oj = [np.asarray(a) for a in jfe._probe_step(1, B)(xj, jnp.asarray(sv))]
    ot = [a.numpy() for a in tfe._probe_step(1, B)(xt, _t(sv))]
    return dict(xj=np.asarray(xj), xt=xt.numpy(), perj=perj, pert=pert,
                wd=wd, oj=oj, ot=ot)


def _state(probe, seed=0):
    """Per-row finish inputs on the probe's frames: real ampmax, mixed
    lowcomp / poste / trans flags, lastmdct = the previous frame's row."""
    oj = probe["oj"]
    rng = np.random.RandomState(seed)
    amp = oj[6].reshape(B, 2).max(1)
    lc = np.where(rng.rand(2 * B) < 0.5, -1.0,
                  rng.rand(2 * B)).astype(np.float32)
    po = np.where(rng.rand(2 * B) < 0.7, -1.0,
                  rng.rand(2 * B) * 40).astype(np.float32)
    tr = rng.rand(B) < 0.3
    lastm = np.concatenate([np.zeros((2, 1024), np.float32), oj[5][:-2]])
    return amp, lc, po, tr, lastm


def test_prepare_layout_and_schedule_equal(probe):
    assert _same(probe["xt"], probe["xj"])     # LPC edge pads included
    for rj, rt in zip(probe["perj"], probe["pert"]):
        for k in ("cs", "Ws", "li", "si", "starts", "wid", "rows"):
            assert np.array_equal(rt[k], rj[k]), k
        assert rt["Ws"][0] == 0 and rt["Ws"][1:].all()


def _close(name, got, want, rel=0.0, atol=0.0, limit=0.001):
    d = np.abs(got.astype(np.float64) - want)
    bad = d > atol + rel * np.abs(want.astype(np.float64))
    print(f"{name}: {bad.sum()}/{bad.size} differ, max {d.max():.3g}")
    assert bad.sum() <= limit * bad.size, name
    return bad.sum()


def test_noisemask_tail_long_and_short(encs, probe):
    jfe, tfe = encs
    oj = probe["oj"]
    amp, lc, po, tr, lastm = _state(probe)
    trr = np.repeat(tr, 2)
    lj, lt = jfe.analysis.look, tfe.analysis.look
    args = (oj[1], oj[3], oj[4], lc, po, lastm)
    want = jax.jit(lambda *a: JPD.noisemask_tail(
        lj, *a[:-1], "long", trans_active=a[-1]))(*args, trr)
    got = TPD.noisemask_tail(lt, *map(_t, args), "long",
                             trans_active=_t(trr))
    for nm, g, w in zip(("logmask", "epeak", "npeak"), got, want):
        _close(f"long {nm}", g.numpy(), np.asarray(w))
    assert (np.asarray(want[1]) > 0).any() and trr.any() and (~trr).any()
    # the short kind (ntfix_short, no M9) on the short look
    sj, st = jfe.ctx(0).analysis.look, tfe.ctx(0).analysis.look
    n = sj.n
    sargs = (oj[1][:, :n], oj[3][:, :n], oj[4][:, :n], lc, po, lastm)
    want = jax.jit(lambda *a: JPD.noisemask_tail(sj, *a, "short"))(*sargs)
    got = TPD.noisemask_tail(st, *map(_t, sargs), "short")
    for nm, g, w in zip(("logmask", "epeak", "npeak"), got, want):
        _close(f"short {nm}", g.numpy(), np.asarray(w), limit=0.02)
        # ntfix_short's inmod = -70 + (sp + 70) * 0.1 is FMA-contracted
        # by XLA:CPU (emulating the FMA here makes it bitwise equal)
        _close(f"short {nm}", g.numpy(), np.asarray(w), atol=1e-4,
               limit=0.0)


def test_m2_m8_m9_lowcompand(encs, probe):
    jfe, tfe = encs
    oj = probe["oj"]
    amp, lc, po, tr, lastm = _state(probe, 1)
    lj, lt = jfe.analysis.look, tfe.analysis.look
    logmask = oj[3] + 6.0
    npk = np.zeros((2 * B, 32), np.float32)
    mj, nj = jax.jit(lambda a, b, c: JPD.m2_apply(lj, a, b, c))(
        logmask, npk, po)
    mt, nt = TPD.m2_apply(lt, _t(logmask), _t(npk), _t(po))
    _close("m2 mask", mt.numpy(), np.asarray(mj))
    _close("m2 npeak", nt.numpy(), np.asarray(nj))
    assert (np.asarray(nj) < 0).any()
    w = jax.jit(lambda a, b, c: JPD.m8_npeak(lj, a, b, c))(
        oj[1], np.asarray(mj), np.asarray(nj))
    g = TPD.m8_npeak(lt, _t(oj[1]), mt, nt)
    _close("m8", g.numpy(), np.asarray(w))
    assert (np.asarray(w) > 0).any()
    act = np.arange(2 * B) % 3 > 0
    w = jax.jit(lambda a, b, c, d: JPD.m9_epeak(lj, a, b, c, d))(
        oj[1], oj[3], lastm, act)
    g = TPD.m9_epeak(lt, *map(_t, (oj[1], oj[3], lastm, act)))
    _close("m9", g.numpy(), np.asarray(w))
    tval = oj[2] - 40.0
    w = jax.jit(lambda a, b: JPD.lowcompand_tval(lj, a, b, 1))(tval, lc)
    g = TPD.lowcompand_tval(lt, _t(tval), _t(lc), 1)
    _close("lowcompand", g.numpy(), np.asarray(w))


def test_m6_promote(encs, probe):
    jfe, tfe = encs
    jd, td = jfe._dev_for(1), tfe._dev_for(1)
    rng = np.random.RandomState(7)
    rM = (rng.randn(B, 1024) * 1.5).astype(np.float32)
    rA = (rng.randn(B, 1024) * 1.2).astype(np.float32)
    reM = np.where(rng.rand(B, 1024) < 0.5, -1, 1).astype(np.float32) \
        * rM * rM
    reA = np.where(rng.rand(B, 1024) < 0.5, -1, 1).astype(np.float32) \
        * rA * rA
    flag = rng.rand(B, 1024) < 0.4
    w = np.asarray(jax.jit(lambda *a: jd._m6_promote(*a, B))(
        rM, rA, reM, reA, flag))
    g = td._m6_promote(*map(_t, (rM, rA, reM, reA, flag)), B).numpy()
    assert 100 < w.sum() < flag.sum()
    _close("m6", g, w)


@pytest.fixture(scope="module")
def q02():
    jfe = JFE(2, 44100, 0.2, switching=False)
    tfe = TFE(2, 44100, 0.2, switching=False, device="cpu")
    return jfe._dev_for(1), tfe._dev_for(1)


def test_normalize_promote_q02(q02):
    """Active at q0.2 (normal_thresh 0.35): the coupled and the
    per-channel candidates, with and without the M8 store."""
    jd, td = q02
    assert td.ctx.normal["thresh"] < 1
    rng = np.random.RandomState(8)
    F, n2 = 16, 1024
    ve = (rng.rand(F, n2) ** 2 * 0.3).astype(np.float32)
    qe = (rng.rand(F, n2) * 4).astype(np.float32)
    qe[:, 100:140] = 1.5                       # ties rank by bin
    out = np.round(rng.randn(F, n2)).astype(np.float32)
    cand = (ve < 0.25) & (rng.rand(F, n2) < 0.8)
    sgn = rng.randn(F, n2).astype(np.float32)
    npk = np.where(rng.rand(F, 32) < 0.2, -1.0,
                   rng.rand(F, 32)).astype(np.float32)
    for npeak in (None, npk):
        w = np.asarray(jax.jit(lambda *a: jd._normalize_promote(
            *a, npeak=npeak))(out, ve, qe, cand, sgn))
        g = td._normalize_promote(*map(_t, (out, ve, qe, cand, sgn)),
                                  npeak=None if npeak is None
                                  else _t(npeak)).numpy()
        assert (w != out).sum() > 50
        _close("normalize", g, w)


def test_couple_quantize_stateful_q02(q02, encs, probe):
    """_couple_quantize with the M9 store (threshold lowering + M6) and
    the normalize promotion gated by the pairwise npeak merge, on the
    probe's real spectra."""
    jd, td = q02
    oj = probe["oj"]
    rng = np.random.RandomState(9)
    md = oj[0]
    curve = (np.abs(md) * 0.6 + 1e-3).astype(np.float32) \
        * np.exp(rng.randn(*md.shape).astype(np.float32) * 0.3)
    used = rng.rand(2 * B) < 0.95
    ep = np.where(rng.rand(*md.shape) < 0.1, rng.rand(*md.shape) * 4,
                  0).astype(np.float32)
    npk = np.where(rng.rand(2 * B, 32) < 0.2, -1.0,
                   rng.rand(2 * B, 32)).astype(np.float32)
    w = jax.jit(lambda a, b, c, d, e: jd._couple_quantize(
        a, b, c, B, epeak=d, npeak=e))(md, curve, used, ep, npk)
    g = td._couple_quantize(*map(_t, (md, curve, used)), B,
                            epeak=_t(ep), npeak=_t(npk))
    assert np.array_equal(g[1].numpy(), np.asarray(w[1]))
    _close("couple stateful", g[0].numpy(), np.asarray(w[0]))


def test_probe_step_close(probe):
    oj, ot = probe["oj"], probe["ot"]
    names = "md logmdct logfft fit1 dB L lam hi_th upt unt".split()
    for nm, g, w in zip(names, ot, oj):
        assert g.shape == w.shape and g.dtype == w.dtype, nm
    # the analysis front and the lastmdct rows: bitwise
    for i in (0, 1, 3, 4, 5):
        assert np.array_equal(ot[i].view(np.int32), oj[i].view(np.int32)), \
            names[i]
    for i in (6, 7, 8, 9):
        _close(names[i], ot[i], oj[i], rel=1e-4, limit=0.0)


def test_probe_host_decisions(encs, probe):
    """The host recurrences fed by the port's and the JAX probe agree
    on every decision they latch."""
    jfe, _ = encs
    oj, ot = probe["oj"], probe["ot"]
    bm = np.full((1, B), 3)
    bm[0, ::5] = 2                  # transition longs, as after a short
    lwbm = np.roll(bm, 1, 1)
    lwbm[0, ::7] = 0
    mnt = [(1.0, 9999.0)] * 4
    outs = []
    for o in (oj, ot):
        lc = TPD.lowcomp_seq_nd(o[7].reshape(B, 2).T,
                                np.repeat(bm, 2, 0), np.repeat(lwbm, 2, 0),
                                mnt)
        po = TPD.poste_seq(o[8].reshape(B, 2).T, o[9].reshape(B, 2).T,
                           {"bm": np.repeat(bm, 2, 0),
                            "lW_bm": np.repeat(lwbm, 2, 0)}, 2048)
        amp = TPD.ampmax_seq(o[6].reshape(B, 2).max(1), np.ones(B, int),
                             (256, 2048), 44100, -6.0)
        outs.append((np.sign(lc), po > 0, amp))
    flips = sum(int((a != b).sum()) for a, b in zip(outs[0][:2],
                                                   outs[1][:2]))
    print(f"host decisions flipped: {flips}")
    assert flips <= 0.01 * 4 * B
    assert np.abs(outs[0][2] - outs[1][2]).max() < 1e-3


def test_finish_step_on_identical_inputs(encs, probe):
    jfe, tfe = encs
    oj = probe["oj"]
    amp, lc, po, tr, lastm = _state(probe, 2)
    fstate = np.concatenate([amp, lc, po, tr.astype(np.float32),
                             probe["wd"].astype(np.float32)]) \
        .astype(np.float32)
    pj, nj = jfe._finish_step(1, B)(*oj[:5], lastm, oj[6], fstate, None)
    pt, nt = tfe._finish_step(1, B)(*map(_t, oj[:5]), _t(lastm),
                                    _t(oj[6]), _t(fstate))
    pj, nj, pt, nt = map(np.asarray, (pj, nj, pt, nt))
    same = sum(bool(nj[f] == nt[f]) and np.array_equal(
        pj[f, :(nj[f] + 7) // 8], pt[f, :(nt[f] + 7) // 8])
        for f in range(B))
    print(f"finish packets byte-identical: {same}/{B}; bits {nt.sum()} "
          f"vs {nj.sum()}")
    assert same >= 63
    assert abs(int(nt.sum()) - int(nj.sum())) <= 0.005 * nj.sum()


def _agreement(oj, ot):
    same = tot = bj = bt = 0
    for a, b in zip(oj, ot):
        pa, pb = _packets(a), _packets(b)
        assert len(pa) == len(pb)
        same += sum(x == y for x, y in zip(pa, pb))
        tot += len(pa)
        bj += sum(map(len, pa))
        bt += sum(map(len, pb))
    return same, tot, bj, bt


def test_slice_streams_vs_jax(streams):
    same, tot, bj, bt = _agreement(*streams)
    print(f"stream packets byte-identical {same}/{tot}; bytes {bt} vs "
          f"{bj} (JAX)")
    assert (same, tot) >= (75, 77) and tot == 77
    assert abs(bt - bj) <= 0.005 * bj


def test_slice_streams_vs_jax_with_its_mdct(encs, pcms, streams,
                                            monkeypatch):
    """With the JAX package's floor moments (its f32 dot's summation
    order, the one stage left that rounds otherwise) swapped into the
    port, the port's stateful stream equals the JAX stream on every
    packet: the analysis front (the butterfly MDCT and the bark fit) and
    the rest of the pipeline round as the JAX package does."""
    from vorbis_tpu.ops.floor_device import DeviceFloorFit as JFit
    from vorbis_tpu_torch.ops.floor_device import DeviceFloorFit as TFit
    _, tfe = encs
    jitted = {}

    def moments(self, quant, above):
        if id(self) not in jitted:
            jitted[id(self)] = jax.jit(JFit(self.look)._moments)
        return tuple(_t(np.asarray(a)) for a in jitted[id(self)](
            quant.numpy(), above.numpy()))

    monkeypatch.setattr(TFit, "_moments", moments)
    same, tot, _, _ = _agreement(streams[0],
                                 tfe.encode_batch(pcms, B_long=B))
    print(f"with the JAX floor moments: {same}/{tot}")
    assert same == tot == 77


def test_oversized_packets_are_redone(pcms, streams):
    """A batch holding a packet past the byte budget is encoded again at
    the static worst case: with budgets too small for every packet the
    stream is the same."""
    tfe = TFE(2, 44100, 0.5, switching=False, device="cpu")
    for W, wb in ((1, 96), (0, 16)):
        plan = tfe._dev_for(W).plan
        assert plan.worst_bytes > wb
        plan.wb = wb
    assert tfe.encode_batch(pcms[1:], [779], B_long=B)[0] == streams[1][1]


def test_slice_streams_decode_to_exact_length(streams, pcms, tmp_path):
    for k, (ogg, pcm) in enumerate(zip(streams[1], pcms)):
        path = str(tmp_path / f"s{k}.ogg")
        with open(path, "wb") as f:
            f.write(ogg)
        got, rate = oracle.decode_float(path)
        assert rate == 44100 and got.shape == pcm.shape
        assert np.isfinite(got).all()


def test_stateless_encode_batch_decodes(encs, pcms, tmp_path):
    """encode_batch(psy_state=False): the gather step for long and short
    frames."""
    tfe = copy.copy(encs[1])
    tfe.psy_state = False
    outs = tfe.encode_batch(pcms, B_long=B)
    for k, (ogg, pcm) in enumerate(zip(outs, pcms)):
        path = str(tmp_path / f"g{k}.ogg")
        with open(path, "wb") as f:
            f.write(ogg)
        got, _ = oracle.decode_float(path)
        assert got.shape == pcm.shape
