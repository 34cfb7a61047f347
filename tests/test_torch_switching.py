"""The port's block switching (vorbis_tpu_torch: ops/torchdsp.py
DeviceEnvelope, models/fastenc.py envelope pass + exact stretch rescue +
switched schedule, the host C rescue walk, ops/psydevice.py M3 scan and
apply, the short finish step's m3vec) against vorbis_tpu, both on the
CPU, on bench.py's click train (two streams: 1.0 s and 0.7 s).

Tolerances, each with its cause and the count measured on this input:
  * envelope marks (marks_nd on 12 s of click train and of bench.py's
    tonal signal, and the chunked multi-stream pass): the port sums the
    prefix in XLA:CPU's order (block_cumsum) and its MDCT and band GEMMs
    round like Eigen's on these inputs: 0 flipped steps measured, 0
    asserted.
  * rescue trigger tables, the rescue walk (host C, its plain lockstep
    version and the JAX walk), the force-serial walk, the per-stream
    schedules (cs/Ws/impulse/starts/wid/rows) and the x64 layout: exact.
  * m3_tempmdct_scan (plain) on identical inputs (F = 1, 3, 64 at
    n = 128, F = 16 at n = 256): bitwise.  XLA folds cell * j into a
    constant, and it compiles the JAX `temp + add` as adds landing on
    temp one by one, which the port does too (0 differing values).
  * m3_apply after its own scan moves nothing on either side (ROADMAP
    §3).  On a buffer lowered by 10 dB, where it does move values
    (3,927 of 16,384 at F = 64): XLA:CPU contracts val - valmask
    (valmask = (...) * rmod) and the tone-accent pull-down
    vnew - (temp2 - 20) * 0.2 into FMAs, rounding once where torch
    rounds twice; emulating the first FMA reproduces 65% of the
    differing values.  Measured 268 of 16,384 val values differ (1.6%),
    by at most 7.6e-6 dB; tval and npeak equal.  Asserted at most 3%,
    by at most 1e-4 dB.
  * the short finish step with m3vec on identical probe outputs: 64 of
    64 packets byte-identical measured, >= 90% asserted (the floor
    quantization is FMA-contracted by XLA:CPU, test_torch_floor.py);
    without m3vec the port's packets are the same (the apply moves
    nothing after the scan).
  * whole switched streams at B_long = B_short = 64: 190 of 204 packets
    byte-identical measured (93%), asserted >= 85%: the MDCT GEMM's
    rounding (not the switching) moves single packets, as
    test_torch_psystate.py shows for the long-only path, and which ones
    moves with the BLAS build, so 85% leaves 14 packets of room; bytes
    34,993 vs 35,000 measured, within 0.5% asserted; the same
    short-block count (148 of the 204 packets).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import oracle
from vorbis_tpu.bitstream.oggfile import OggStreamReader
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu.ops import psydevice as JPD
from vorbis_tpu_torch import native as T_native
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import psydevice as TPD
from vorbis_tpu_torch.ops.m3_cuda import make_m3_scan

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


def _click_train(secs, rate, seed):
    """bench.py:53's transient leg: a decaying click every ~90 ms over a
    quiet tonal bed."""
    n = int(secs * rate)
    t = np.arange(n) / rate
    rng = np.random.RandomState(1000 + seed)
    x = 0.05 * np.sin(2 * np.pi * (330 + 11 * seed) * t)
    step = int(0.09 * rate)
    for o in range(step // 2, n - 400, step):
        env = np.exp(-np.arange(256) / 40.0)
        x[o:o + 256] += 0.75 * env * rng.randn(256)
    pcmf = np.stack([x, np.roll(x, 7)])
    return np.clip(np.rint(pcmf * 32768.0), -32768,
                   32767).astype(np.int16)


def _metas(fe, pcms):
    """encode_batch's (ns, base_row, Si) per stream with switching."""
    hop = fe.n // 2
    out, base = [], 0
    for pcm in pcms:
        ns = pcm.shape[1]
        Si = max(((ns + 5 * hop + 63) // 64) * 64 + 64,
                 (fe._ENV_STEPS + 1) * 64)
        out.append((ns, base, Si))
        base += Si // 64
    return out


@pytest.fixture(scope="module")
def encs():
    return (JFE(2, 44100, 0.5),
            TFE(2, 44100, 0.5, device="cpu"))


@pytest.fixture(scope="module")
def pcms():
    return [_click_train(1.0, 44100, 0),
            np.ascontiguousarray(_click_train(1.0, 44100, 3)[:, :30870])]


@pytest.fixture(scope="module")
def prepared(encs, pcms):
    """Both packages' switched set-up of the two streams; the JAX
    side's first trigger-table call (its rescue jobs and tables) is
    recorded for the rescue tests."""
    jfe, tfe = encs
    rec = {}
    orig = jfe._rescue_trig_tables

    def record(x64, jobs):
        T1, T2 = orig(x64, jobs)
        if "jobs" not in rec:
            rec.update(jobs=[list(j) for j in jobs], T1=T1, T2=T2)
        return T1, T2

    jfe._rescue_trig_tables = record
    try:
        xj, perj = jfe._prepare_switched(pcms, True)
    finally:
        del jfe._rescue_trig_tables
    xt, pert = tfe._prepare_switched(pcms, True)
    return dict(xj=np.asarray(xj), xt=xt, perj=perj, pert=pert, **rec)


@pytest.fixture(scope="module")
def streams(encs, pcms, prepared):
    """Both packages' switched encode_batch at B_long = B_short = 64 (the
    one XLA compile of the JAX two-phase steps in this module)."""
    jfe, tfe = encs
    return (jfe.encode_batch(pcms, B_long=B, B_short=B),
            tfe.encode_batch(pcms, B_long=B, B_short=B))


# ---------------------------------------------------------------------------
# envelope marks and the stretch rescue

def test_envelope_marks_equal(encs):
    """The chunked multi-stream pass (marks_nd in chunks of 8192 steps
    with a 32-step overlap) on 12 s of click train and of a tonal
    signal, two streams of two chunks each."""
    jfe, tfe = encs
    t = np.arange(12 * 44100) / 44100
    tonal = np.stack([0.3 * np.sin(2 * np.pi * 440 * t),
                      0.1 * np.sin(2 * np.pi * 1873 * t)])
    pcms = [_click_train(12, 44100, 5).astype(np.float32) / 32768.0,
            tonal.astype(np.float32)]
    metas = _metas(tfe, pcms)
    x = np.zeros((2, sum(Si for _, _, Si in metas)), np.float32)
    for pcm, (ns, base, _) in zip(pcms, metas):
        x[:, base * 64:base * 64 + ns] = pcm
    x64 = x.reshape(2, -1, 64)
    want = jfe._envelope_marks_multi(jnp.asarray(x64), metas)
    got = tfe._envelope_marks_multi(_t(x64), metas)
    for g, w in zip(got, want):
        print(f"marks {g.sum()} vs {w.sum()}, flips {(g != w).sum()}")
        assert np.array_equal(g, w)
    assert got[0].sum() > 200 and len(got[0]) > tfe._ENV_STEPS


def test_block_cumsum_in_xla_order():
    from vorbis_tpu_torch.ops.torchdsp import block_cumsum
    rng = np.random.RandomState(0)
    for n in (1, 16, 17, 255, 8192):
        x = (rng.rand(2, 3, n) ** 4 * 1000).astype(np.float32)
        want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x))
        assert np.array_equal(block_cumsum(_t(x)).numpy(), want), n


def test_multi_stream_marks_equal(encs, pcms, prepared):
    jfe, tfe = encs
    metas = _metas(tfe, pcms)
    want = jfe._envelope_marks_multi(jnp.asarray(prepared["xj"]), metas)
    got = tfe._envelope_marks_multi(prepared["xt"], metas)
    for g, w in zip(got, want):
        assert np.array_equal(g, w) and g.sum() > 10


def test_rescue_trig_tables_bitwise(encs, prepared):
    _, tfe = encs
    jobs = [list(j) for j in prepared["jobs"]]
    T1, T2 = tfe._rescue_trig_tables(prepared["xt"], jobs)
    assert len(jobs) == 2 and T1.any() and T2.any()   # one merged
    # cluster a stream: clicks every ~62 steps, PAD = 30
    assert np.array_equal(T1, prepared["T1"])
    assert np.array_equal(T2, prepared["T2"])


def test_rescue_walk_host_c_equals_plain_and_jax(encs, prepared):
    """native.rescue_walk against the port's numpy lockstep and the JAX
    module's walk, on the recorded tables and on random dense ones
    (triggers near the window ends set retrig)."""
    jfe, _ = encs
    smax = 24
    rng = np.random.RandomState(5)
    cases = [(prepared["T1"], prepared["T2"], prepared["jobs"])]
    for dens in (0.02, 0.2):
        T1 = rng.rand(13, 40, 300) < dens
        T2 = rng.rand(13, 40, 300) < dens
        w0 = rng.randint(0, 20, 40)
        jobs = [[None, 0, 0, 0, int(a), int(a) + int(w)]
                for a, w in zip(w0, rng.randint(1, 280, 40))]
        cases.append((T1, T2, jobs))
    for T1, T2, jobs in cases:
        wlen = np.asarray([j[5] - j[4] for j in jobs])
        got = T_native.rescue_walk(T1, T2, wlen, smax)
        plain = TFE._rescue_walk_plain(T1, T2, wlen, smax)
        want = jfe._rescue_walk_batch(T1, T2, jobs)
        for g, p, w in zip(got, plain, want):
            assert np.array_equal(g, p) and np.array_equal(g, w)
    assert got[1].any() and got[0].any()


def test_rescue_force_serial_equals_lockstep():
    """The lockstep walk equals the all-serial reference walk on a 2 s
    click train (tests/test_fastenc.py:348 for the port)."""
    pcm = _click_train(2, 44100, 7)
    ser = TFE(2, 44100, 0.5, device="cpu")
    ser._rescue_force_serial = True
    lock = TFE(2, 44100, 0.5, device="cpu")
    (_, a), (_, b) = (fe._prepare_switched([pcm], True)
                      for fe in (ser, lock))
    for k in ("cs", "Ws", "impulse"):
        assert np.array_equal(a[0][k], b[0][k]), k
    assert (a[0]["Ws"] == 0).sum() > 20


def test_prepare_switched_equal(prepared):
    assert np.array_equal(prepared["xt"].numpy(), prepared["xj"])
    for rj, rt in zip(prepared["perj"], prepared["pert"]):
        for k in ("cs", "Ws", "impulse", "starts", "wid", "rows", "li",
                  "si"):
            assert np.array_equal(rt[k], rj[k]), k
        assert (rt["Ws"] == 0).sum() > 30 and rt["impulse"].sum() > 20


# ---------------------------------------------------------------------------
# M3 on impulse short blocks

def _m3_inputs(F, n, seed):
    """Seeded (logmdct, lastmdct, val, tval) with M3 triggers firing, and
    params from m3_param_seq on a switched frame sequence."""
    rng = np.random.RandomState(seed)
    lm = (rng.randn(F, 2, n) * 15 - 60).astype(np.float32)
    last = (rng.randn(F, 2, 1024) * 15 - 75).astype(np.float32)
    val = (lm + rng.randn(F, 2, n) * 8 + 6).astype(np.float32)
    tval = (lm + rng.randn(F, 2, n) * 8 - 6).astype(np.float32)
    Ws = np.where(rng.rand(1, F) < 0.7, 0, 1)
    imp = (rng.rand(1, F) < 0.6) & (Ws == 0)
    ann = JPD.annotate_frames_nd(Ws, imp)
    pr = JPD.m3_param_seq({k: v[0] for k, v in ann.items()}, n, 2.0, True)
    return lm, last, val, tval, pr, ann["impadnum"][0] == 0


def _short_look(tfe, n):
    look = tfe.ctx(0).analysis.look
    if n == look.n:
        return look, look
    fake = dict(n=n, m3n=look.m3n, vi=look.vi,
                tonecomp_endp=look.tonecomp_endp)
    return (types.SimpleNamespace(**fake), types.SimpleNamespace(**fake))


@pytest.mark.parametrize("F,n", [(1, 128), (3, 128), (64, 128), (16, 256)])
def test_m3_scan_and_apply_bitwise(encs, F, n):
    jfe, tfe = encs
    lj, lt = _short_look(tfe, n)
    lm, last, val, tval, pr, iz = _m3_inputs(F, n, F + n)
    keys = ("sw", "reset", "noise_center")
    want = np.asarray(jax.jit(lambda *a: JPD.m3_tempmdct_scan(
        lj, *a[:4], dict(zip(keys, a[4:]))))(
            lm, last, val, tval, *(pr[k] for k in keys)))
    tp = {k: _t(v) for k, v in pr.items() if k != "base"}
    got = make_m3_scan(lt, "cpu")(*map(_t, (lm, last, val, tval)), tp)
    assert np.array_equal(got.numpy(), want)
    if F > 3:
        assert (want == lm).any() and pr["reset"].any()
    npk = np.where(np.random.RandomState(F).rand(F, 2, n // 16) < 0.5,
                   0.5, -1.0).astype(np.float32)
    ak = ("sw", "noise_rate", "noise_center", "tone_rate")
    japply = jax.jit(lambda *a: JPD.m3_apply(
        lj, *a[:6], dict(zip(ak, a[6:10])), a[10]))
    # after its own scan the apply moves nothing (the scan's trigger is
    # the apply's condition and sets tempmdct = logmdct where it holds;
    # ROADMAP §3), so the apply's math is held on a lowered buffer
    for temps, live in ((want, False), (want - 10.0, F > 1)):
        wj = japply(val, tval, lm, last, temps, npk,
                    *(pr[k] for k in ak), iz)
        wt = TPD.m3_apply(lt, *map(_t, (val, tval, lm, last, temps, npk)),
                          {k: _t(pr[k]) for k in ak}, _t(iz))
        moved = 0
        for nm, g, w, x in zip(("val", "tval", "npeak"), wt, wj,
                               (val, tval, npk)):
            g, w = g.numpy(), np.asarray(w)
            d = np.abs(g.astype(np.float64) - w)
            print(f"m3_apply {nm}: {(d > 0).sum()}/{d.size} differ, "
                  f"max {d.max():.3g}, moved {(w != x).sum()}")
            assert (d > 0).sum() <= 0.03 * d.size and d.max() <= 1e-4
            moved += int((w != x).sum())
        assert (moved > 0) == live or F == 1


def test_short_finish_step_with_m3vec(encs, prepared, streams):
    """One 64-frame short batch (click-train impulse blocks) through both
    finish steps with the same probe outputs, state and m3vec."""
    jfe, tfe = encs
    perj = prepared["perj"]
    st = np.concatenate([r["starts"][r["si"]] for r in perj])[:B]
    sv = np.stack([st, np.zeros(B), np.zeros(B)]).astype(np.int32)
    oj = [np.asarray(a) for a in jfe._probe_step(0, B)(
        jnp.asarray(prepared["xj"]), jnp.asarray(sv))]
    Ws = [r["Ws"] for r in perj]
    anns = [JPD.annotate_frames(w, r["impulse"]) for w, r in zip(Ws, perj)]
    sub = {k: np.concatenate([a[k][r["si"]] for a, r in zip(anns, perj)])
           [:B] for k in ("bm", "lW_bm", "lW_no", "impadnum")}
    pr = JPD.m3_param_seq(sub, 128, 2.0, True)
    m3vec = np.stack([pr["sw"], pr["noise_rate"], pr["noise_center"],
                      pr["tone_rate"], pr["reset"],
                      sub["impadnum"] == 0]).astype(np.float32)
    assert pr["sw"].sum() > 10
    lastm = np.concatenate([np.zeros((2, 1024), np.float32), oj[5][:-2]])
    amp = oj[6].reshape(B, 2).max(1)
    fstate = np.concatenate([amp, np.full(4 * B, -1.0),
                             (sub["bm"] == 1).astype(np.float32),
                             np.zeros(B)]).astype(np.float32)
    pj, nj = map(np.asarray, jfe._finish_step(0, B)(
        *oj[:5], lastm, oj[6], fstate, m3vec))
    step = tfe._finish_step(0, B)
    targs = (*map(_t, oj[:5]), _t(lastm), _t(oj[6]), _t(fstate))
    pt, nt = (a.numpy() for a in step(*targs, _t(m3vec)))
    p0, n0 = (a.numpy() for a in step(*targs))

    def same(pa, na, pb, nb):
        return sum(bool(na[f] == nb[f]) and np.array_equal(
            pa[f, :(na[f] + 7) // 8], pb[f, :(nb[f] + 7) // 8])
            for f in range(B))

    s = same(pj, nj, pt, nt)
    print(f"short finish with m3vec: {s}/{B} packets byte-identical; "
          f"without M3 {same(p0, n0, pt, nt)}/{B} equal to with")
    assert s >= 0.9 * B
    # M3's apply after its own scan changes no packet (ROADMAP §3)
    assert same(p0, n0, pt, nt) == B


# ---------------------------------------------------------------------------
# whole switched streams

def test_switched_streams_vs_jax(streams):
    same = tot = bj = bt = 0
    for a, b in zip(*streams):
        pa, pb = _packets(a), _packets(b)
        assert len(pa) == len(pb)
        same += sum(x == y for x, y in zip(pa, pb))
        tot += len(pa)
        bj += len(a)
        bt += len(b)
        shorts = [sum(len(p) and not (p[0] >> 1) & 1 for p in pk)
                  for pk in (pa, pb)]
        assert shorts[0] == shorts[1] > 30
    print(f"switched packets byte-identical {same}/{tot}; bytes {bt} vs "
          f"{bj} (JAX)")
    assert same >= 0.85 * tot
    assert abs(bt - bj) <= 0.005 * bj


def test_switched_streams_decode_to_exact_length(streams, pcms, tmp_path):
    for k, (ogg, pcm) in enumerate(zip(streams[1], pcms)):
        path = str(tmp_path / f"s{k}.ogg")
        with open(path, "wb") as f:
            f.write(ogg)
        got, rate = oracle.decode_float(path)
        assert rate == 44100 and got.shape == pcm.shape
        assert np.isfinite(got).all()


def test_pre_echo_below_long_only(tmp_path):
    """tests/test_fastenc.py:61's clicks on a tone: the port's switched
    stream has less pre-echo than its long-only one, and is smaller."""
    rate = 44100
    t = np.arange(rate) / rate
    mono = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    clicks = [int((k + 0.5) * rate / 8) for k in range(8)]
    for c in clicks:
        mono[c] = 0.9
    pcm = np.stack([mono, mono])
    fe = TFE(2, rate, 0.5, device="cpu")
    sw, lo = (fe.encode_batch([pcm], switching=s, B_long=B, B_short=B)[0]
              for s in (True, False))

    def decode(name, data):
        path = str(tmp_path / name)
        with open(path, "wb") as f:
            f.write(data)
        out, _ = oracle.decode_float(path)
        assert out.shape == pcm.shape
        return out

    def pre_echo(got):
        return float(np.mean([np.sqrt(np.mean(
            (got[:, c - 900:c - 20] - pcm[:, c - 900:c - 20]) ** 2))
            for c in clicks]))

    pe_sw = pre_echo(decode("sw.ogg", sw))
    pe_lo = pre_echo(decode("lo.ogg", lo))
    print(f"pre-echo switched {pe_sw:.3g}, long-only {pe_lo:.3g}")
    assert pe_sw < pe_lo
    assert len(sw) < len(lo)
