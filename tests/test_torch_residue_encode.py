"""The residue path (vorbis_tpu_torch/ops/residue_encode_cuda.py,
csrc/residue_encode.cu) against the JAX package, both on the CPU.

`residue_encode` on CPU tensors is its plain version: the finish's
classifier (`_classify2` on the interleaved rows of residue type 2,
`_classify` for type 1), `_vq_stages` and `_residue_fields`.  Its classes
and VQ entries must equal the JAX package's jitted stages bit for bit
(integer work after one exact float subtract and add a value), its
lengths too, and its values wherever a length is non-zero (the JAX
one-hot lookups leave stale values in dead columns, which carry no
bits; the port writes 0 there), at the configs of FastEncoder(2, 44100,
0.5) long and short, FastEncoder(6, 48000, 0.4)'s coupled submap long
and short and its LFE, and FastEncoder(2, 44100, 0.5, coupling=False)
(residue type 1 over two channels), on tests/residue_encode_cases.py's
seeded, threshold, zero, unused and stress rows and its rows at
int32's edge (+3e9, +inf and NaN residues, which the JAX package's
converts saturate or take to 0).  A numpy replay of the
kernel's schedule (`replay`: the blob read through its header, a block
of whole frames, a thread a (row, partition) with its values carried
from stage to stage, the entries in a slot a thread, then a column a
thread) must equal the plain version on the same rows, values
included, so a layout, offset or schedule fault shows here, where no
kernel runs.  The kernel itself needs a card:
tests/test_torch_cuda.py::test_residue_encode_on_cuda and chip_smoke.py
phase 3l hold it to the plain version there.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.residue_encode_cases import cast_rows, inputs, stress_rows
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import residue_encode_cuda as REC
from vorbis_tpu_torch.ops.residue_encode_cuda import (classify_rows,
                                                      residue_encode)

# one torch thread a pytest-xdist worker (see test_torch_encode.py)
torch.set_num_threads(1)

# config -> (FastEncoder arguments, keywords, W, submap)
LOOKS = {"44k_long": ((2, 44100, 0.5), (), 1, 0),
         "44k_short": ((2, 44100, 0.5), (), 0, 0),
         "51_long": ((6, 48000, 0.4), (), 1, 0),
         "51_short": ((6, 48000, 0.4), (), 0, 0),
         "51_lfe": ((6, 48000, 0.4), (), 1, 1),
         "44k_uncoupled": ((2, 44100, 0.5), (("coupling", False),), 1, 0)}


@lru_cache(maxsize=None)
def _encoders(args, kw):
    return JFE(*args, **dict(kw)), TFE(*args, device="cpu", **dict(kw))


def _config(name):
    """(JAX step, JAX config or None, port step, port config)."""
    args, kw, W, sm = LOOKS[name]
    jfe, tfe = _encoders(args, kw)
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    if td.multi:
        return jd, jd.groups[sm], td, td.groups[sm]
    return jd, None, td, td


def _rows(td, cfg, seed):
    """The seeded and edge rows, the stress rows, then the rows at
    int32's edge (the port's converts saturate as XLA's do)."""
    n2 = td.n // 2
    r1, u1 = inputs(cfg, n2, seed)
    r2, u2 = stress_rows(cfg, n2, seed + 1)
    r3, u3 = cast_rows(cfg, n2, seed + 2)
    return np.concatenate([r1, r2, r3]), np.concatenate([u1, u2, u3])


@pytest.fixture(scope="module", params=list(LOOKS))
def case(request):
    jd, jarg, td, cfg = _config(request.param)
    res, used = _rows(td, cfg, 11 + list(LOOKS).index(request.param))
    F, rc = used.shape
    jcfg = jarg if jarg is not None else jd
    nch = cfg.res_enc.nch

    @jax.jit
    def stages(res, used):
        if cfg.res_type == 2:
            absA = jnp.abs(res[:, 1::nch]) if nch == 2 else jnp.stack(
                [jnp.abs(res[:, c::nch]) for c in range(1, nch)], 1).max(1)
            pw = jd._classify2(jnp.abs(res[:, 0::nch]), absA, cfg=jarg,
                               nch=nch)
        else:
            pw = jd._classify(res, cfg=jarg)
        entries = jd._vq_stages(res, pw, cfg=jarg)
        vals, lens = jd._residue_fields(
            pw.reshape(F, rc, -1),
            [e.reshape(F, rc, jcfg.partvals, -1) for e in entries], used,
            cfg=jarg)
        return pw, entries, vals, lens

    return dict(name=request.param, td=td, cfg=cfg, res=res, used=used,
                jax=jax.tree_util.tree_map(np.asarray, stages(res, used)))


def test_plain_equals_jax(case):
    """Classes, entries and lengths bitwise, values where live."""
    td, cfg = case["td"], case["cfg"]
    res, used = torch.from_numpy(case["res"]), torch.from_numpy(case["used"])
    jpw, jent, jvals, jlens = case["jax"]
    if cfg.res_type == 2:
        pw = classify_rows(td, res, cfg.res_enc.nch, cfg)
    else:
        pw = td._classify(res, cfg=cfg)
    assert np.array_equal(pw.numpy(), jpw)
    # every class occurs, and the stress rows reach the last
    assert len(np.unique(jpw)) == cfg.possible
    ent = td._vq_stages(res, pw, cfg=cfg)
    assert len(ent) == len(jent) == cfg.stages
    for a, b in zip(ent, jent):
        assert np.array_equal(a.numpy(), b)
    vals, lens = residue_encode(cfg, res, used)
    assert vals.dtype == torch.int64 and lens.dtype == torch.int32
    assert np.array_equal(lens.numpy(), jlens)
    live = jlens > 0
    assert live.sum() > 100
    assert np.array_equal(vals.numpy()[live],
                          jvals.astype(np.int64)[live])
    assert not vals.numpy()[~live].any()


# -- the kernel's schedule, replayed in numpy ------------------------------

def _f2i(x):
    """__float2int_rz: truncate, saturate to int32, NaN -> 0."""
    x = np.asarray(x, np.float64)
    return np.where(np.isnan(x), 0, np.clip(np.trunc(np.nan_to_num(x)),
                                             -2 ** 31, 2 ** 31 - 1)
                    ).astype(np.int64)


def _i32(a):
    """Wrap int64 values to int32 as the kernel's int arithmetic does."""
    return (np.asarray(a, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31


def _bits(word):
    return np.asarray(word, np.int32).view(np.float32)


def _trunc_div(v, delta, magic, shift):
    """csrc/residue_encode.cu trunc_div: |v| by the magic number, the
    sign put back (uint32 arithmetic)."""
    a = np.where(v < 0, -v, v).astype(np.uint64)         # |INT_MIN| = 2^31
    t = (magic.astype(np.uint64) & 0xFFFFFFFF) * a >> np.uint64(32)
    q = (t + ((a - t) >> np.uint64(1))) >> shift.astype(np.uint64)
    q = np.where(delta == 1, a, q).astype(np.int64)
    return _i32(np.where(v < 0, -q, q))


def replay(blob, res, used, sms=132):
    """The kernel's walk over `blob` for rows res (F * res_ch, L) float32
    and used (F, res_ch), launched on a card of `sms` SMs: every block's
    phase-1 threads side by side (axis 0 the block, axis 1 the thread),
    the shared entry slots as an array, then the column walk, four
    columns a thread a round.  -> (vals (F, RC) int64, lens (F, RC)
    int32)."""
    b = np.asarray(blob, np.int32)
    h = REC.blob_tables(b)
    F, rc_ch = used.shape
    L = res.shape[1]
    S, P, spp = h["stages"], h["possible"], h["spp"]
    g = REC.geometry(b, F, sms)
    fpb, T, pp = g["fpb"], g["p1"], h["parts_pad"]
    recs = h["recs"].astype(np.int64)
    nblk = -(-F // fpb)
    blk = np.arange(nblk)[:, None]
    tid = np.arange(T)[None, :]
    nf = np.minimum(fpb, F - blk * fpb)
    row, p = tid // pp, tid % pp
    live = (row < nf * rc_ch) & (p < h["partvals"])
    grow = np.where(live, blk * fpb * rc_ch + row, 0)
    i = np.arange(REC.MAX_SPP)
    at = h["begin"] + p[..., None] * spp + i
    ok = live[..., None] & (i < spp) & (at < L)
    w = np.where(ok, res[grow[..., None], np.minimum(at, L - 1)],
                 np.float32(0)).astype(np.float32)
    # the class
    cls = np.full(live.shape, P - 1, np.int64)
    if h["type"] == 2:
        a = np.abs(w)
        ch0 = (i % h["nch"] == 0) & (i < spp)
        rest = (i % h["nch"] != 0) & (i < spp)
        mag = np.where(ch0, a, 0).max(-1)
        ang = np.where(rest, a, 0).max(-1)
        for k in range(P - 2, -1, -1):
            hit = (mag <= np.float32(h["cm1"][k])) & (
                ang <= np.float32(h["cm2"][k]))
            cls = np.where(hit, k, cls)
    else:
        v = _i32(np.abs(_f2i(w)))
        mx = np.where(i < spp, v, -2 ** 31).max(-1)
        tot = _i32(np.where(i < spp, v, 0).sum(-1))
        ent = _f2i(tot.astype(np.float32) * _bits(h["scale"]))
        for k in range(P - 2, -1, -1):
            c2 = h["cm2"][k]
            hit = (mx <= h["cm1"][k]) & ((c2 < 0) | (ent < c2))
            cls = np.where(hit, k, cls)
    cls = np.where(live, cls, 0)
    # every stage, the values in registers, the entries in slots
    ent_slots = np.zeros((nblk, h["sument"], T), np.int64)
    for s in range(S):
        r = recs[s][cls]                        # (nblk, T, REC)
        dim, qv, steps = (r[..., REC.R[k]] for k in ("dim", "qv", "steps"))
        delta, remap = r[..., REC.R["delta"]], r[..., REC.R["remap"]]
        mg, sh = r[..., REC.R["magic"]], r[..., REC.R["shift"]]
        has = live & (dim > 0)
        carry = s + 1 < S
        dim1, qv1, delta1 = (np.maximum(x, 1) for x in (dim, qv, delta))
        minval = _bits(r[..., REC.R["minval"]])
        add = _bits(r[..., REC.R["add"]])
        deltaf = _bits(r[..., REC.R["deltaf"]])
        ze = qv >> 1
        o = np.zeros_like(dim)
        k = np.zeros_like(dim)
        acc = np.zeros_like(dim)
        pw = np.ones_like(dim)
        for j in range(REC.MAX_SPP):
            act = has & (j < spp)
            t = (w[..., j] - minval) + add
            v = _trunc_div(_f2i(t), delta1, mg, sh)
            m = _i32(np.where(v < ze, ((ze - v) << 1) - 1, (v - ze) << 1))
            m = np.minimum(np.maximum(m, 0), qv1 - 1)
            if carry:
                # an identity book's remainder, a digit as it comes
                zz = np.where(m & 1, -((m + 1) >> 1), m >> 1)
                rem = w[..., j] - deltaf * zz.astype(np.float32)
                w[..., j] = np.where(act & (remap < 0), rem, w[..., j])
            acc = np.where(act, acc + m * pw, acc)
            o = np.where(act, o + 1, o)
            done = act & (o == dim)
            rmp = np.where(remap >= 0, b[np.clip(remap + acc, 0,
                                                 len(b) - 1)], acc)
            e = np.where(remap >= 0, rmp, acc)
            bi, ti_ = np.nonzero(done)
            ent_slots[bi, h["soff"][s] + k[bi, ti_], ti_] = e[bi, ti_]
            k = np.where(done, k + 1, k)
            pw = np.where(done, 1, np.where(act, pw * qv1, pw))
            acc = np.where(done, 0, acc)
            o = np.where(done, 0, o)
        if not carry:
            break
        # a remapped book's remainder: the remapped entries' digits
        o = np.zeros_like(dim)
        k = np.zeros_like(dim)
        q = ent_slots[:, h["soff"][s], :].copy()
        for j in range(REC.MAX_SPP):
            act = has & (j < spp) & (remap >= 0)
            d = q % qv1
            q = np.where(act, q // qv1, q)
            zz = np.where(d & 1, -((d + 1) >> 1), d >> 1)
            rem = w[..., j] - deltaf * zz.astype(np.float32)
            w[..., j] = np.where(act, rem, w[..., j])
            o = np.where(act, o + 1, o)
            nxt = act & (o == dim)
            o = np.where(nxt, 0, o)
            k = np.where(nxt, k + 1, k)
            kk = np.minimum(k, h["ms"][s] - 1)
            fresh = np.take_along_axis(
                ent_slots[:, h["soff"][s]:h["soff"][s] + h["ms"][s], :],
                kk[:, None, :], 1)[:, 0, :]
            q = np.where(nxt & (k < steps), fresh, q)
    # the column walk: a column a thread, in order
    RC = h["rc"]
    cols = h["cols"].astype(np.int64)
    vals = np.zeros((nblk * fpb, RC), np.int64)
    lens = np.zeros((nblk * fpb, RC), np.int32)
    usedp = np.zeros((nblk * fpb, rc_ch), bool)
    usedp[:F] = used
    fr = np.arange(fpb)[:, None]
    word = cols[None, :]
    chn = (word >> REC.COL_CHAN) & 0x3FF
    part = (word >> REC.COL_PART) & 0xFFF
    st = word & 63
    s_ = (word >> REC.COL_STAGE) & 7
    phrase = np.asarray(h["cols"], np.int32)[None, :] < 0
    rr = fr * rc_ch + chn                       # (fpb, RC)
    t = rr * pp + part
    for bk in range(nblk):
        c = cls[bk]
        ok = usedp[bk * fpb + fr[:, 0]][np.arange(fpb)[:, None], chn]
        pv = np.zeros(t.shape, np.int64)
        for q in range(h["ppw"]):
            pv = pv * P + c[np.minimum(t + q, T - 1)]
        ok_ph = ok & (pv < h["phr_entries"])
        rec = recs[s_, c[t]]
        ok_st = ok & (part < h["partvals"]) & (rec[..., REC.R["dim"]] > 0) \
            & (st < rec[..., REC.R["steps"]])
        e = ent_slots[bk][np.minimum(np.asarray(h["soff"])[s_] + st,
                                     h["sument"] - 1), t]
        okc = np.where(phrase, ok_ph, ok_st)
        book = np.where(phrase, h["phr"], rec[..., REC.R["book"]])
        idx = np.where(okc, book + 2 * np.where(phrase, pv, e), 0)
        vals[bk * fpb:(bk + 1) * fpb] = np.where(
            okc, b[idx].view(np.uint32).astype(np.int64), 0)
        lens[bk * fpb:(bk + 1) * fpb] = np.where(okc, b[idx + 1], 0)
    return vals[:F], lens[:F]


@pytest.mark.parametrize("name", list(LOOKS))
def test_kernel_schedule_replay(name):
    """The replayed kernel equals the plain version, values included."""
    _, _, td, cfg = _config(name)
    res, used = _rows(td, cfg, 40 + list(LOOKS).index(name))
    rv, rl = replay(cfg.res_enc.blob_np, res, used)
    pv, pl = residue_encode(cfg, torch.from_numpy(res),
                            torch.from_numpy(used))
    assert np.array_equal(rl, pl.numpy())
    assert np.array_equal(rv, pv.numpy())
    assert (rl > 0).sum() > 100
    # the kernel's output does not depend on its launch geometry
    for sms in (1, 8):
        gv, gl = replay(cfg.res_enc.blob_np, res, used, sms)
        assert np.array_equal(gv, rv) and np.array_equal(gl, rl)


def test_magic_division_is_exact():
    """trunc_div's magic numbers (REC.magic) give C's truncating division
    at every lattice step of the configs and a spread of other divisors,
    on dividends near 0, near each multiple of the divisor up to 2^20,
    near +-2^31 and at random."""
    rng = np.random.RandomState(9)
    deltas = {1, 2, 3, 7, 255, 357, 625, 931, 1875, 65535, 65537,
              (1 << 30) + 1}
    for name in LOOKS:
        cfg = _config(name)[3]
        deltas |= {int(d["delta"]) for row in cfg.res_books for d in row
                   if d is not None}
    for d in sorted(deltas):
        m, sh = REC.magic(d)
        near = np.arange(0, 1 << 20, d)[:, None] + np.arange(-1, 2)
        v = np.concatenate([np.arange(-4096, 4096), near.ravel(),
                            -near.ravel(), rng.randint(-2 ** 31, 2 ** 31,
                                                       20000),
                            [-2 ** 31, -2 ** 31 + 1, 2 ** 31 - 1,
                             2 ** 31 - 2]]).astype(np.int64)
        v = v[(v >= -2 ** 31) & (v < 2 ** 31)]
        want = _i32(np.where(v >= 0, v // d, -((-v) // d)))
        got = _trunc_div(v, np.full(v.shape, d), np.full(v.shape, m,
                                                         np.int64),
                         np.full(v.shape, sh))
        assert np.array_equal(got, want), d


def test_pack_blob_layout():
    """pack_blob's header, records, columns and books, read back, against
    the config's tables (44.1 kHz long and the 5.1 LFE)."""
    for name in ("44k_long", "51_lfe"):
        _, _, td, cfg = _config(name)
        blob = cfg.res_enc.blob_np
        h = REC.blob_tables(blob)
        assert blob.dtype == np.int32 and len(blob) == h["words"]
        assert (h["type"], h["res_ch"], h["spp"], h["partvals"], h["ppw"],
                h["nck"], h["parts_pad"], h["possible"], h["stages"]) == (
            cfg.res_type, cfg.res_ch, cfg.spp, cfg.partvals, cfg.ppw,
            cfg.nchunks, cfg.parts_pad, cfg.possible, cfg.stages)
        ms = [st["max_steps"] for st in cfg.stage_tabs]
        assert h["ms"] == ms and h["soff"] == list(np.cumsum([0] + ms)[:-1])
        assert h["rc"] == cfg.nchunks * cfg.res_ch * (
            1 + cfg.ppw * sum(ms))
        assert h["per_frame"] == cfg.res_ch * cfg.parts_pad
        big = REC.geometry(blob, 1 << 20, 132)
        assert big["fpb"] == h["fpb"] and big["smem"] == h["smem"]
        assert big["p1"] <= REC.THREADS or h["fpb"] == 1
        assert big["threads"] <= REC.MAX_THREADS
        small = REC.geometry(blob, 256, 132)
        assert small["fpb"] == 1 and small["threads"] >= REC.MIN_THREADS
        assert np.array_equal(h["cm1"], np.asarray(
            cfg.ri.classmetric1)[:cfg.possible])
        # the columns: stage 0's phrase words first in each chunk
        cols = h["cols"]
        assert (cols < 0).sum() == cfg.nchunks * cfg.res_ch
        first = cfg.res_ch * (1 + cfg.ppw * ms[0])
        assert (cols[:cfg.res_ch] < 0).all()
        assert (cols[first] < 0) == (cfg.nchunks > 1)
        assert (cols[cfg.res_ch] & 63) == 0
        assert ((cols[cfg.res_ch + 1] >> REC.COL_STEP) & 63) == (
            1 if ms[0] > 1 else 0)
        ph = blob[h["phr"]:h["phr"] + 2 * cfg.phrasebook.entries]
        assert np.array_equal(ph[0::2].view(np.uint32), cfg.ph_cw)
        assert np.array_equal(ph[1::2], cfg.ph_cl)
        for s in range(cfg.stages):
            for c, d in enumerate(cfg.res_books[s]):
                r = h["recs"][s, c]
                if d is None:
                    assert r[REC.R["dim"]] == 0
                    continue
                assert (r[REC.R["dim"]], r[REC.R["qv"]], r[REC.R["steps"]],
                        r[REC.R["delta"]], r[REC.R["entries"]]) == (
                    d["dim"], d["qv"], cfg.spp // d["dim"], d["delta"],
                    d["entries"])
                assert _bits(r[REC.R["minval"]]) == np.float32(d["minval"])
                assert (int(r[REC.R["magic"]]) & 0xFFFFFFFF,
                        r[REC.R["shift"]]) == REC.magic(int(d["delta"]))
                assert r[REC.R["book"]] % 2 == 0
                E = d["entries"]
                bk = blob[r[REC.R["book"]]:r[REC.R["book"]] + 2 * E]
                st = cfg.stage_tabs[s]
                assert np.array_equal(bk[0::2].view(np.uint32),
                                      st["cw"][c, :E])
                assert np.array_equal(bk[1::2], st["cl"][c, :E])
                if d["ident"]:
                    assert r[REC.R["remap"]] == -1
                else:
                    rm = blob[r[REC.R["remap"]]:r[REC.R["remap"]] + E]
                    assert np.array_equal(rm, d["book"].remap_np)


@pytest.mark.parametrize("name", ["44k_long", "51_long"])
def test_type2_classifier_from_interleaved_rows(name):
    """The type-2 classes from the interleaved rows equal _classify2 on
    the (absM, absA) that the finish step took from the (F, nch, n2)
    residues before the kernel (nch = 2 and 5)."""
    _, _, td, cfg = _config(name)
    nch, n2 = cfg.res_enc.nch, td.n // 2
    res, _ = inputs(cfg, n2, 3)
    out = torch.from_numpy(res.reshape(-1, n2, nch).transpose(0, 2, 1)
                           .copy())                 # (F, nch, n2)
    absA = torch.abs(out[:, 1]) if nch == 2 else \
        torch.abs(out[:, 1:]).amax(1)
    want = td._classify2(torch.abs(out[:, 0]), absA, nch=nch, cfg=cfg)
    inter = out.transpose(1, 2).reshape(len(out), -1)
    assert torch.equal(inter, torch.from_numpy(res))
    assert torch.equal(classify_rows(td, inter, nch, cfg), want)
    assert len(torch.unique(want)) > 2
