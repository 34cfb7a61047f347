"""The port's 5.1 multi-submap encode (vorbis_tpu_torch/ops/encdevice.py
_prepare_multi, _couple_multi, _finish_multi) against the JAX package's,
both on the CPU: the prepared tables and column plans, the four-step
chained coupling, M6 at the multi-step prae, the LFE's floor fit, and the
long and short finish steps and the stateless gather step on identical
inputs.  FastEncoder(6, 48000, 0.4): submap 0 = channels 0-4 coupled under
res2 through the steps (0,2) (3,4) (0,1) (0,3), submap 1 = the LFE under
res1 with its own 2-post floor over 12 bins.  JAX's five step compiles
(two probes, two finishes, one gather step) run in three threads.

Tolerances, each with its cause and the count measured on these inputs:
  * tables and plans: host numpy, equal.
  * _couple_multi and _m6_promote (seeded F = 16 inputs, jitted on the
    JAX side): equal.  XLA:CPU may contract the fold's a2 - b2*threv and
    the promotion budget's acc + acc*npeak^2 into FMAs where torch rounds
    each product, which could move a rint tie; measured: no bin moves on
    these inputs (out, used_out and the promoted bins all equal),
    asserted equal.
  * the LFE's plain fit (P = 2, n = 12), as tests/test_torch_floor.py
    holds the long look's: XLA:CPU contracts fit_line's
    products-differences into FMAs (in the Pallas kernel's interpret mode
    and in DeviceFloorFit), torch rounds each product.  With the
    contraction emulated the plain fit equals the Pallas kernel bit for
    bit (asserted); as written it differs from JAX's DeviceFloorFit on 2
    of 512 posts, by one quantum (measured; asserted <= 1%, <= 1
    quantum).
  * the long and the short finish (JAX's probe outputs, lastmdct, fstate
    and m3vec as inputs, B = 32) and the stateless gather step (the same
    x64 rows, starts and wid): what moves a packet is what moves the
    stereo finish (test_torch_psystate.py, test_torch_switching.py):
    XLA:CPU contracts the floor quantization mask*7.31 + 1023.5 and
    fit_line into FMAs where torch rounds each product.  Asserted: >= 90%
    of packets byte-identical, total bits within 0.5%; the measured
    counts are printed.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import _click_train51
from tests.test_torch_floor import _FmaFit, _pallas_posts
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu.ops import psydevice as JPD
from vorbis_tpu.ops.floor_device import DeviceFloorFit as JFit
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops.floor_device import DeviceFloorFit as TFit

# one torch thread a pytest-xdist worker (see test_torch_switching.py)
torch.set_num_threads(1)

B = 32
RATE = 48000
CH = 6
f32 = np.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(pa, na, pb, nb):
    """Packets equal in bit count and bytes."""
    return sum(bool(na[f] == nb[f]) and np.array_equal(
        pa[f, :(na[f] + 7) // 8], pb[f, :(nb[f] + 7) // 8])
        for f in range(len(na)))


@pytest.fixture(scope="session")
def encs():
    return JFE(CH, RATE, 0.4), TFE(CH, RATE, 0.4, device="cpu")


@pytest.mark.parametrize("W", [1, 0], ids=["long", "short"])
def test_prepared_multi_tables_equal_jax(encs, W):
    """_prepare_multi and _prepare_columns_multi: groups, coupling steps,
    each submap's floor and residue config and the packet column plan
    equal JAX's; the LFE has its own floor fit, the coupled submap shares
    the mode's."""
    jfe, tfe = encs
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    assert jd.multi and td.multi
    assert td.coupling == jd.coupling == [(0, 2), (3, 4), (0, 1), (0, 3)]
    assert [g.channels for g in td.groups] == [
        g.channels for g in jd.groups] == [[0, 1, 2, 3, 4], [5]]
    for gj, gt in zip(jd.groups, td.groups):
        for k in ("res_type", "res_ch", "P", "qb", "spp", "partvals",
                  "ppw", "nchunks", "possible", "stages", "fl_bits"):
            assert getattr(gt, k) == getattr(gj, k), k
        assert gt.fl.n == gj.fl.n
        assert np.array_equal(gt.ph_cl, gj.ph_cl)
        for sj, st in zip(gj.stage_tabs, gt.stage_tabs):
            assert np.array_equal(st["cw"], sj["cw"])
            assert np.array_equal(st["cl"], sj["cl"])
    lfe = td.groups[1]
    assert (td.groups[0].res_type, lfe.res_type) == (2, 1)
    assert (lfe.P, lfe.fl.n) == (2, 12)
    assert td.groups[0].floor is tfe.ctx(W).floor
    assert lfe.floor is not tfe.ctx(W).floor
    pj, pt = jd.plan, td.plan
    assert np.array_equal(pt.gidx, pj.gidx)
    assert (pt.n_cols, pt.wb, pt.worst_bytes) == (pj.n_cols, pj.wb,
                                                  pj.worst_bytes)
    print(f"W={W}: floors P={[g.P for g in td.groups]} n="
          f"{[g.fl.n for g in td.groups]}; plan {pt.n_cols} columns, wb "
          f"{pt.wb}, worst {pt.worst_bytes} bytes")
    assert pt.wb == min(pt.worst_bytes, 2048)
    assert pt.worst_bytes == (15521 if W else 2088)


def _couple_inputs(tfe, F, seed):
    """Seeded (md, curve, used, epeak, npeak) for the five coupled
    channels at the long block: residues md/curve of either sign, a tenth
    of them large (lossless), the rest near the point thresholds; M9 peaks
    on a fifth of the bins; M8 stores of -1 (off), 0 and positive
    boosts."""
    rng = np.random.RandomState(seed)
    C, n2 = 5, tfe.n // 2
    curve = np.exp(rng.randn(F, C, n2) * 0.7 - 4).astype(f32)
    res = rng.randn(F, C, n2) * np.where(rng.rand(F, C, n2) < 0.1, 6.0,
                                         0.6)
    # half the bins of channels 1-4 follow channel 0, so steps see
    # parallel and opposed pairs
    lead = rng.rand(F, 1, n2) < 0.5
    res[:, 1:] = np.where(lead, res[:, :1] * rng.choice(
        [-1.0, 1.0], (F, C - 1, n2)) + 0.2 * res[:, 1:], res[:, 1:])
    md = (res * curve).astype(f32)
    used = rng.rand(F, C) > 0.1
    epeak = np.where(rng.rand(F, C, n2) < 0.2, rng.rand(F, C, n2) * 3,
                     0.0).astype(f32)
    npt = -(-n2 // tfe.normal["partition"])
    npeak = rng.choice([-1.0, 0.0, 0.5, 1.5], (F, C, npt)).astype(f32)
    return md, curve, used, epeak, npeak


@pytest.mark.parametrize("state", [True, False],
                         ids=["psy_state", "stateless"])
def test_couple_multi_equal_jax(encs, state):
    """The four chained coupling steps on the same seeded inputs: the
    integer residues and the used flags equal JAX's (with the M9 peaks
    and M8 stores of the psy-state path, and without)."""
    jfe, tfe = encs
    F = 16
    md, curve, used, epeak, npeak = _couple_inputs(tfe, F, 11)
    ep, npk = (epeak, npeak) if state else (None, None)
    jd, td = jfe.dev, tfe.dev
    oj, uj = map(np.asarray, jax.jit(
        lambda *a: jd._couple_multi(*a[:3], F, epeak=a[3], npeak=a[4]))(
            md, curve, used, ep, npk))
    ot, ut = td._couple_multi(_t(md), _t(curve), _t(used), F,
                              epeak=None if ep is None else _t(ep),
                              npeak=None if npk is None else _t(npk))
    ot, ut = ot.numpy(), ut.numpy()
    diff = int((ot != oj).sum())
    print(f"_couple_multi ({'psy state' if state else 'stateless'}): "
          f"{diff}/{oj.size} bins differ; nonzero {int((ot != 0).sum())}, "
          f"|out| max {np.abs(ot).max()}")
    assert np.array_equal(ut, uj)
    assert np.array_equal(ot, oj)
    # the inputs reach every branch: lossless (|out| > 1), point zeros
    # on the angle channels, and unused channels
    assert np.abs(ot).max() > 1 and (ot == 0).mean() > 0.2
    assert not used.all()


def test_m6_promote_multi_prae_equal_jax(encs):
    """M6 at the multi-step prae 0.825 on one seeded coupled pair."""
    jfe, tfe = encs
    F = 16
    md, curve, _, _, _ = _couple_inputs(tfe, F, 12)
    rM, rA = md[:, 0] / curve[:, 0], md[:, 1] / curve[:, 1]
    reM = np.where(md[:, 0] < 0, -(md[:, 0] * md[:, 0]), md[:, 0] ** 2)
    reA = np.where(md[:, 1] < 0, -(md[:, 1] * md[:, 1]), md[:, 1] ** 2)
    flagm1 = np.random.RandomState(13).rand(*rM.shape) < 0.5
    args = [a.astype(f32) for a in (rM, rA, reM, reA)] + [flagm1]
    cp = jfe.dev.ctx.couple
    pj = np.asarray(jax.jit(lambda *a: jfe.dev._m6_promote(
        *a, F, prae=0.825, couple=cp))(*args))
    pt = tfe.dev._m6_promote(*map(_t, args), F, prae=0.825).numpy()
    p34 = tfe.dev._m6_promote(*map(_t, args), F).numpy()
    print(f"M6 at prae 0.825: {int(pt.sum())} bins promoted (JAX "
          f"{int(pj.sum())}); at 0.34: {int(p34.sum())}")
    assert np.array_equal(pt, pj)
    assert 0 < pt.sum() < p34.sum()


def test_lfe_floor_fit_equal_jax(encs):
    """The LFE's plain fit (2 posts over 12 bins) as tests/test_torch_floor.py
    holds the long look's: with XLA:CPU's FMA contraction of fit_line
    emulated it equals the Pallas kernel (interpret mode) on the same
    quant/above/prefix bit for bit; as written it differs from JAX's
    DeviceFloorFit (make_floor_fit's CPU path) end to end only at
    near-ties, by one quantum (2 of 512 posts on these inputs)."""
    jfe, tfe = encs
    look_t = tfe.dev.groups[1].fl_look
    look_j = jfe.dev.groups[1].fl_look
    assert (look_t.posts, look_t.n) == (look_j.posts, look_j.n) == (2, 12)
    rng = np.random.RandomState(21)
    lm = (rng.randn(256, 12) * 20 - 60).astype(f32)
    mk = (lm + rng.randn(256, 12) * 6 - 3).astype(f32)
    mk[::16] = -160.0                     # quant 0: unused frames
    tf = TFit(look_t, "cpu")
    quant, above, prefix, used = tf.prepare(_t(lm), _t(mk))
    want = _pallas_posts(look_t, quant.numpy(), above.numpy(),
                         prefix.numpy())
    fma = _FmaFit(look_t, "cpu").fit(quant, above, prefix).numpy()
    assert np.array_equal(fma, want)
    pt, ut = tf(_t(lm), _t(mk))
    pt, ut = pt.numpy(), ut.numpy()
    pj, uj = map(np.asarray, jax.jit(JFit(look_j))(lm, mk))
    differ = int((pt != pj).sum())
    print(f"LFE fit: {int(ut.sum())}/256 frames used; plain vs JAX "
          f"DeviceFloorFit differ on {differ}/{pt.size} posts, vs Pallas "
          f"(same inputs) on {int((pt != want).sum())}")
    assert np.array_equal(ut, uj) and ut.any() and not ut.all()
    assert np.abs((pt & 0x7FFF) - (pj & 0x7FFF)).max() <= 1
    assert differ <= 0.01 * pt.size


@pytest.fixture(scope="session")
def batches(encs):
    """JAX's probe outputs and state for the first B long and the first B
    short frames of a switched 1.5 s 5.1 click train (the port's schedule;
    both sides read the same x64 rows), JAX's finish of each, and JAX's
    stateless gather step on the long frames: {W: (inputs, (packets,
    nbits))}, plus {"gather": ((x64, starts, wid), (packets, nbits))}."""
    jfe, tfe = encs
    x64t, per = tfe._prepare_switched([_click_train51(1.5, RATE, 0)], True)
    x64 = x64t.numpy()
    rec = per[0]
    ann = JPD.annotate_frames(rec["Ws"], rec["impulse"])
    sel = {1: rec["li"][:B], 0: rec["si"][:B]}
    assert all(len(idx) == B for idx in sel.values())

    def probe_finish(W):
        # a generator a thread: the draws do not depend on the threads'
        # order
        rng = np.random.RandomState(3 + W)
        idx = sel[W]
        wd = rec["wid"][idx] if W else np.zeros(B, np.int64)
        sv = np.stack([rec["starts"][idx], wd, np.zeros(B)]).astype(np.int32)
        oj = [np.asarray(a) for a in jfe._probe_step(W, B)(
            jnp.asarray(x64), jnp.asarray(sv))]
        n2L = oj[5].shape[1]
        lastm = np.concatenate([np.zeros((CH, n2L), f32), oj[5][:-CH]])
        amp = oj[6].reshape(B, CH).max(1)
        lc = np.where(rng.rand(CH * B) < 0.5, -1.0, rng.rand(CH * B))
        po = np.where(rng.rand(CH * B) < 0.7, -1.0, rng.rand(CH * B) * 40)
        if not W:
            po[:] = -1.0
        tr = (ann["bm"][idx] == (2 if W else 1)).astype(f32)
        fstate = np.concatenate([amp, lc, po, tr, wd]).astype(f32)
        m3vec = None
        if not W:
            sub = {k: ann[k][idx]
                   for k in ("bm", "lW_bm", "lW_no", "impadnum")}
            pr = JPD.m3_param_seq(sub, 128, 2.0, True)
            assert pr["sw"].sum() > 5
            m3vec = np.stack([pr["sw"], pr["noise_rate"],
                              pr["noise_center"], pr["tone_rate"],
                              pr["reset"], sub["impadnum"] == 0]
                             ).astype(f32)
        ins = (oj, lastm, fstate, m3vec)
        out = tuple(map(np.asarray, jfe._finish_step(W, B)(
            *oj[:5], lastm, oj[6], fstate,
            None if m3vec is None else jnp.asarray(m3vec))))
        return ins, out

    def gather():
        idx = sel[1]
        args = (x64, rec["starts"][idx].astype(np.int32),
                rec["wid"][idx].astype(np.int32))
        out = tuple(map(np.asarray, jfe._gather_step(1, B)(
            *map(jnp.asarray, args))))
        return args, out

    # the XLA compiles overlap: XLA releases the GIL while it compiles
    with ThreadPoolExecutor(3) as pool:
        futs = {W: pool.submit(probe_finish, W) for W in (1, 0)}
        futs["gather"] = pool.submit(gather)
        return {k: f.result() for k, f in futs.items()}


@pytest.mark.parametrize("W", [1, 0], ids=["long", "short_m3"])
def test_finish_step_on_identical_inputs(encs, batches, W):
    _, tfe = encs
    (oj, lastm, fstate, m3vec), (pj, nj) = batches[W]
    pt, nt = (a.numpy() for a in tfe._finish_step(W, B)(
        *map(_t, oj[:5]), _t(lastm), _t(oj[6]), _t(fstate),
        None if m3vec is None else _t(m3vec)))
    assert pt.shape[0] == nt.shape[0] == B and pt.shape == pj.shape
    s = _same(pj, nj, pt, nt)
    print(f"5.1 finish W={W}: {s}/{B} packets byte-identical; bits "
          f"{int(nt.sum())} vs {int(nj.sum())} (JAX); largest packet "
          f"{(nt.max() + 7) // 8} bytes")
    assert s >= 0.9 * B
    assert abs(int(nt.sum()) - int(nj.sum())) <= 0.005 * nj.sum()


def test_stateless_gather_step_on_identical_frames(encs, batches):
    """The stateless step (encode_flat through make_gather_step) on the
    same x64 rows, starts and window-shape ids."""
    _, tfe = encs
    args, (pj, nj) = batches["gather"]
    pt, nt = (a.numpy() for a in tfe._gather_step(1, B)(*map(_t, args)))
    s = _same(pj, nj, pt, nt)
    print(f"5.1 stateless gather step: {s}/{B} packets byte-identical; "
          f"bits {int(nt.sum())} vs {int(nj.sum())} (JAX)")
    assert s >= 0.9 * B
    assert abs(int(nt.sum()) - int(nj.sum())) <= 0.005 * nj.sum()
