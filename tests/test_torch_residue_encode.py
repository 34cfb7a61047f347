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
seeded, threshold, zero, unused and stress rows, its rows at int32's
edge (+3e9, +inf and NaN residues, which the JAX package's converts
saturate or take to 0) and its INT_MIN rows (-3e9 and -inf residues,
which JAX's divide takes to +ceil(2^31 / step); also at each config's
LatticeVariant, whose widest class has lattice steps 2 and 3).  A numpy
replay of the kernel's schedule (`replay`: the blob read through its
header, a warp an item of chunks of a frame, a lane a unit of whole
entries with its values carried from stage to stage, the class from the
partition's lanes, the entries' pair offsets in the warp's column
array in the item's column order, then the item's columns a stage's run
at a time) must equal the plain version on the same rows, values
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

from tests.residue_encode_cases import (LatticeVariant, cast_rows,
                                        int_min_rows, inputs, stress_rows)
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
    int32's edge (the port's converts saturate as XLA's do) and the rows
    of INT_MIN residues (-3e9 and -inf)."""
    n2 = td.n // 2
    r1, u1 = inputs(cfg, n2, seed)
    r2, u2 = stress_rows(cfg, n2, seed + 1)
    r3, u3 = cast_rows(cfg, n2, seed + 2)
    r4, u4 = int_min_rows(cfg, n2, seed + 3)
    return (np.concatenate([r1, r2, r3, r4]),
            np.concatenate([u1, u2, u3, u4]))


def _jax_trio(jd, jarg, cfg, res, used, fields=True):
    """The JAX package's jitted classify, VQ and (with `fields`) fields on
    rows res and used at the JAX config `jarg` (None: the step itself),
    laid out as the port's config `cfg` reads them: (classes, entries,
    vals, lens) in numpy (vals and lens None without `fields`)."""
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
        if not fields:
            return pw, entries, None, None
        vals, lens = jd._residue_fields(
            pw.reshape(F, rc, -1),
            [e.reshape(F, rc, jcfg.partvals, -1) for e in entries], used,
            cfg=jarg)
        return pw, entries, vals, lens

    return jax.tree_util.tree_map(np.asarray, stages(res, used))


@pytest.fixture(scope="module", params=list(LOOKS))
def case(request):
    jd, jarg, td, cfg = _config(request.param)
    res, used = _rows(td, cfg, 11 + list(LOOKS).index(request.param))
    return dict(name=request.param, td=td, cfg=cfg, res=res, used=used,
                jax=_jax_trio(jd, jarg, cfg, res, used))


def _holds_to_jax(td, cfg, res, used, want):
    """The plain version's classes, entries and lengths bitwise against
    the JAX package's `want`, its values where live (where `want` has
    them: the fields are a function of the classes and entries alone);
    -> (vals, lens)."""
    res, used = torch.from_numpy(res), torch.from_numpy(used)
    jpw, jent, jvals, jlens = want
    if cfg.res_type == 2:
        pw = classify_rows(td, res, cfg.res_enc.nch, cfg)
    else:
        pw = td._classify(res, cfg=cfg)
    assert np.array_equal(pw.numpy(), jpw)
    ent = td._vq_stages(res, pw, cfg=cfg)
    assert len(ent) == len(jent) == cfg.stages
    for a, b in zip(ent, jent):
        assert np.array_equal(a.numpy(), b)
    vals, lens = residue_encode(cfg, res, used)
    assert vals.dtype == torch.int64 and lens.dtype == torch.int32
    if jlens is None:
        return vals.numpy(), lens.numpy()
    assert np.array_equal(lens.numpy(), jlens)
    live = jlens > 0
    assert np.array_equal(vals.numpy()[live],
                          jvals.astype(np.int64)[live])
    assert not vals.numpy()[~live].any()
    return vals.numpy(), lens.numpy()


def test_plain_equals_jax(case):
    """Classes, entries and lengths bitwise, values where live."""
    _, lens = _holds_to_jax(case["td"], case["cfg"], case["res"],
                            case["used"], case["jax"])
    # every class occurs, and the stress rows reach the last
    assert len(np.unique(case["jax"][0])) == case["cfg"].possible
    assert (lens > 0).sum() > 100


@pytest.fixture(scope="module", params=list(LOOKS))
def int_min_case(request):
    """tests/residue_encode_cases.py's INT_MIN rows at the config and at
    its LatticeVariant (the widest class's first two stages with a book
    at lattice steps 2 and 3), with the JAX package's outputs at both."""
    jd, jarg, td, cfg = _config(request.param)
    var = LatticeVariant(cfg)
    var.res_enc = REC.ResidueEncodeConfig(var, cfg.res_enc.nch, td)
    jvar = LatticeVariant(jarg if jarg is not None else jd)
    res, used = int_min_rows(cfg, td.n // 2,
                             70 + list(LOOKS).index(request.param))
    return dict(td=td, cfg=cfg, var=var, res=res, used=used,
                jax=_jax_trio(jd, jvar, var, res, used, fields=False))


def test_int_min_divide_equals_jax(int_min_case):
    """A residue of -3e9 or -inf converts to INT_MIN, which the JAX
    package's divide, jnp.where(ti >= 0, ti // di, -((-ti) // di)),
    takes to +ceil(2^31 / d) (its negation wraps) where a truncating
    divide gives -trunc(2^31 / d).  At the variant's step of 2 the
    zigzag digits differ as well (the truncated quotient's doubling
    wraps, its digit clamps to 0 where JAX's clamps to qv - 1).  The
    plain version's classes and entries hold to JAX there (its fields
    are those of test_plain_equals_jax's code on them), and the kernel's
    replay (vq_div) to the plain version, values and lengths."""
    td, var = int_min_case["td"], int_min_case["var"]
    res, used = int_min_case["res"], int_min_case["used"]
    jpw = int_min_case["jax"][0]
    top = var.possible - 1
    steps = [d[top]["delta"] for d in var.res_books if d[top] is not None]
    assert steps[:2] == [2, 3] and (jpw == top).sum() >= 2
    vals, lens = _holds_to_jax(td, var, res, used, int_min_case["jax"])
    rv, rl = replay(var.res_enc.blob_np, res, used)
    assert np.array_equal(rl, lens) and np.array_equal(rv, vals)
    # the shipped config on the same rows: its own steps
    cfg = int_min_case["cfg"]
    pv, pl = residue_encode(cfg, torch.from_numpy(res),
                            torch.from_numpy(used))
    rv, rl = replay(cfg.res_enc.blob_np, res, used)
    assert np.array_equal(rl, pl.numpy()) and np.array_equal(rv, pv.numpy())


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


def _udiv(a, magic, shift, one):
    """csrc/residue_encode.cu udiv: a // d for 0 <= a < 2^32 by the magic
    number (uint32 arithmetic), a itself where d = 1."""
    a = np.asarray(a, np.int64).astype(np.uint64)
    t = (np.asarray(magic, np.int64).astype(np.uint64) & 0xFFFFFFFF) * a \
        >> np.uint64(32)
    q = (t + ((a - t) >> np.uint64(1))) >> np.asarray(
        shift, np.int64).astype(np.uint64)
    return np.where(one, a, q).astype(np.int64)


def _vq_div(v, delta, magic, shift):
    """csrc/residue_encode.cu vq_div: |v| by the magic number, the sign
    put back, INT_MIN's quotient +ceil(2^31 / delta) as the JAX
    package's wrapping negation gives it."""
    v = np.asarray(v, np.int64)
    a = np.abs(v)                                   # |INT_MIN| = 2^31
    q = _udiv(a, magic, shift, delta == 1)
    up = _i32(q + (q * delta != a))
    return _i32(np.where(v == -2 ** 31, up, np.where(v < 0, -q, q)))


def _jax_div(v, d):
    """The JAX package's divide, jnp.where(v >= 0, v // d, -((-v) // d)),
    in int32 (-INT_MIN wraps to INT_MIN)."""
    v = np.asarray(v, np.int64)
    return _i32(np.where(v >= 0, v // d, -(_i32(-v) // d)))


def replay(blob, res, used, sms=132):
    """The kernel's walk over `blob` for rows res (F * res_ch, L) float32
    and used (F, res_ch), launched on a card of `sms` SMs: every item
    (axis 0; `cpw` chunks of a frame, every channel) and lane (axis 1; a
    unit of `unit` values of a partition) side by side: the unit's
    partial statistics combined over its partition's lanes into the
    class, every stage's lattice quantization on the unit's values with
    the remainder carried, the entries' pair offsets and the phrase
    words written into the warp's column array in the item's column
    order (an unwritten column fails), then the item's columns a stage's
    run at a time.  -> (vals (F, RC) int64, lens (F, RC) int32)."""
    b = np.asarray(blob, np.int32)
    h = REC.blob_tables(b)
    F, rc_ch = used.shape
    L = res.shape[1]
    S, P, spp = h["stages"], h["possible"], h["spp"]
    U, unit, cpw, nck, ppw = h["units"], h["unit"], h["cpw"], h["nck"], \
        h["ppw"]
    g = REC.geometry(b, F, sms)
    assert g["items"] == F * -(-nck // cpw) and g["wpb"] <= REC.WARPS
    recs, rec2 = h["recs"].astype(np.int64), h["rec2"].astype(np.int64)
    it = np.arange(g["items"])[:, None]
    lane = np.arange(32)[None, :]
    ps, u = lane // U, lane % U
    cl = ps // (ppw * rc_ch)
    k, c = ps // rc_ch - cl * ppw, ps % rc_ch
    ipf = -(-nck // cpw)
    f, c0a = it // ipf, (it % ipf) * cpw
    nc = np.minimum(cpw, nck - c0a)
    on = cl < nc
    p = (c0a + cl) * ppw + k
    row = f * rc_ch + c
    use = on & used[f, np.minimum(c, rc_ch - 1)]
    live = use & (p < h["partvals"])
    i = np.arange(unit)
    at = h["begin"] + (p * spp + u * unit)[..., None] + i
    ok = live[..., None] & (at < L)
    w = np.where(ok, res[np.where(live, row, 0)[..., None],
                         np.minimum(at, L - 1)], np.float32(0)) \
        .astype(np.float32)
    # the class: the lanes' partial statistics, then the partition's
    grp = np.minimum(ps[..., None] * U + np.arange(U), 31)   # (1, 32, U)
    if h["type"] == 2:
        a = np.abs(w)
        ch0 = i % h["nch"] == 0

        def nanmax(x, axis):
            return np.where(np.isnan(x).any(axis), np.nan,
                            np.nanmax(np.where(np.isnan(x), -1, x), axis))
        mag = nanmax(np.where(ch0, a, 0), -1)
        ang = nanmax(np.where(~ch0, a, 0), -1)
        mag = nanmax(mag[:, grp[0]], -1)
        ang = nanmax(ang[:, grp[0]], -1)
        cls = np.full(live.shape, P - 1, np.int64)
        for q in range(P - 2, -1, -1):
            hit = (mag <= np.float32(h["cm1"][q])) & (
                ang <= np.float32(h["cm2"][q]))
            cls = np.where(hit, q, cls)
    else:
        v = _i32(np.abs(_f2i(w)))
        mx = v.max(-1)[:, grp[0]].max(-1)
        tot = _i32(_i32(v.sum(-1))[:, grp[0]].sum(-1))
        ent = _f2i(tot.astype(np.float32) * _bits(h["scale"]))
        cls = np.full(live.shape, P - 1, np.int64)
        for q in range(P - 2, -1, -1):
            c2 = h["cm2"][q]
            hit = (mx <= h["cm1"][q]) & ((c2 < 0) | (ent < c2))
            cls = np.where(hit, q, cls)
    cls = np.where(live, cls, 0)
    # every stage: the entries' pair offsets in the column array
    col = np.full((g["items"], h["item_cols"]), -2, np.int64)
    II = np.broadcast_to(it, live.shape)
    ib = np.zeros_like(nc)
    ms = h["ms"]
    for s in range(S):
        cs = (rc_ch if s == 0 else 0) + ppw * rc_ch * ms[s]
        base = ib + cl * cs + (rc_ch if s == 0 else 0) + (k * rc_ch + c) \
            * ms[s]
        ib = ib + nc * cs
        r = recs[s][cls]
        r2 = rec2[s][cls]
        dim = np.where(live, r[..., REC.R["dim"]], 0)
        qv, steps = r[..., REC.R["qv"]], r[..., REC.R["steps"]]
        delta, remap = r[..., REC.R["delta"]], r[..., REC.R["remap"]]
        book = r[..., REC.R["book"]]
        mg, sh = r[..., REC.R["magic"]], r[..., REC.R["shift"]]
        minval, add = _bits(r[..., REC.R["minval"]]), _bits(
            r[..., REC.R["add"]])
        deltaf = _bits(r[..., REC.R["deltaf"]])
        has = on & (dim > 0)
        dim1, qv1 = np.maximum(dim, 1), np.maximum(qv, 1)
        carry = s + 1 < S
        ze = qv >> 1
        e0 = u * r2[..., REC.R2["per"]]
        o = np.zeros_like(dim)
        kk = e0.copy()
        acc = np.zeros_like(dim)
        pw = np.ones_like(dim)
        for j in range(unit):
            t = (w[..., j] - minval) + add
            v = _vq_div(_f2i(t), np.maximum(delta, 1), mg, sh)
            m = _i32(np.where(v < ze, ((ze - v) << 1) - 1, (v - ze) << 1))
            m = np.minimum(np.maximum(m, 0), qv1 - 1)
            if carry:
                zz = np.where(m & 1, -((m + 1) >> 1), m >> 1)
                rem = w[..., j] - deltaf * zz.astype(np.float32)
                w[..., j] = np.where(has & (remap < 0), rem, w[..., j])
            acc = acc + m * pw
            o = o + 1
            done = has & (o == dim1)
            e = np.where(remap >= 0, b[np.clip(remap + acc, 0, len(b) - 1)],
                         acc)
            col[II[done], (base + kk)[done]] = (book + 2 * e)[done]
            kk = np.where(done, kk + 1, kk)
            pw = np.where(done, 1, pw * qv1)
            acc = np.where(done, 0, acc)
            o = np.where(done, 0, o)
        if carry:
            # a remapped book's remainder: the remapped entries' digits
            rm = has & (remap >= 0)
            qm, qs = r2[..., REC.R2["qmagic"]], r2[..., REC.R2["qshift"]]
            o = np.zeros_like(dim)
            kk = e0.copy()
            q = np.where(rm, (col[II, np.where(rm, base + kk, 0)] - book)
                         >> 1, 0)
            for j in range(unit):
                nq = _udiv(q, qm, qs, qv1 == 1)
                d = q - nq * qv1
                q = nq
                zz = np.where(d & 1, -((d + 1) >> 1), d >> 1)
                rem = w[..., j] - deltaf * zz.astype(np.float32)
                w[..., j] = np.where(rm, rem, w[..., j])
                o = o + 1
                nxt = rm & (o == dim1)
                o = np.where(nxt, 0, o)
                kk = np.where(nxt, kk + 1, kk)
                fresh = rm & nxt & (kk < e0 + r2[..., REC.R2["per"]])
                q = np.where(fresh, (col[II, np.where(fresh, base + kk, 0)]
                                     - book) >> 1, q)
        # dead slots: a lane's steps u, u + U, ... past the class's
        first = np.where(has, steps, 0)
        for st in range(ms[s]):
            dead = on & (st >= first) & ((st - first) % U == u)
            col[II[dead], (base + st)[dead]] = -1
    # the phrase words
    lead = on & (u == 0) & (k == 0)
    pv = np.zeros(live.shape, np.int64)
    for q in range(ppw):
        # partition slot ps + q res_ch's class, from its first lane
        pv = pv * P + cls[:, np.minimum((ps[0] + q * rc_ch) * U, 31)]
    hs = rc_ch + ppw * rc_ch * ms[0]
    phr = np.where(use & (pv < h["phr_entries"]), h["phr"] + 2 * pv, -1)
    pos = np.broadcast_to(cl * hs + c, live.shape)
    col[II[lead], pos[lead]] = phr[lead]
    # the item's columns, a stage's run at a time
    RC = h["rc"]
    vals = np.zeros((F, RC), np.int64)
    lens = np.zeros((F, RC), np.int32)
    gb, ib = 0, np.zeros(g["items"], np.int64)
    for s in range(S):
        cs = (rc_ch if s == 0 else 0) + ppw * rc_ch * ms[s]
        for t in range(g["items"]):
            n = int(nc[t, 0]) * cs
            a = col[t, ib[t]:ib[t] + n]
            assert (a >= -1).all(), "a column no lane wrote"
            g0 = gb + int(c0a[t, 0]) * cs
            ft = int(f[t, 0])
            live_c = a >= 0
            aa = np.where(live_c, a, 0)
            vals[ft, g0:g0 + n] = np.where(live_c, b[aa].view(np.uint32)
                                           .astype(np.int64), 0)
            lens[ft, g0:g0 + n] = np.where(live_c, b[aa + 1], 0)
            ib[t] += n
        gb += nck * cs
    return vals, lens


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
    """vq_div's magic numbers (REC.magic) give the JAX package's division
    (C's truncating division, INT_MIN's quotient +ceil(2^31 / d)) at
    every lattice step of the configs and a spread of other divisors, on
    dividends near 0, near each multiple of the divisor up to 2^20, near
    +-2^31 and at random; and udiv gives a remapped book's digits at every
    qv of the configs."""
    rng = np.random.RandomState(9)
    deltas = {1, 2, 3, 7, 255, 357, 625, 931, 1875, 65535, 65537,
              (1 << 30) + 1}
    qvs = set()
    for name in LOOKS:
        cfg = _config(name)[3]
        deltas |= {int(d["delta"]) for row in cfg.res_books for d in row
                   if d is not None}
        qvs |= {int(d["qv"]) for row in cfg.res_books for d in row
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
        got = _vq_div(v, np.full(v.shape, d), np.full(v.shape, m, np.int64),
                      np.full(v.shape, sh))
        assert np.array_equal(got, _jax_div(v, d)), d
    assert _jax_div(-2 ** 31, 2) == 2 ** 30
    assert _jax_div(-2 ** 31, 3) == 715827883
    for qv in sorted(qvs):
        m, sh = REC.magic(qv)
        q = np.arange(1 << 16)
        assert np.array_equal(_udiv(q, m, sh, qv == 1), q // qv), qv


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
        assert big["wpb"] == REC.WARPS and big["smem"] <= REC.MAX_SHARED
        assert big["warps"] >= big["items"] > big["warps"] - REC.WARPS
        small = REC.geometry(blob, 1, 132)
        assert small["wpb"] == 1 and small["blocks"] == small["items"]
        # a unit holds whole entries of every book (and whole channel
        # rounds of a type-2 row); a chunk of every channel fits a warp
        assert h["unit"] * h["units"] == cfg.spp
        assert all(h["unit"] % d["dim"] == 0 for row in cfg.res_books
                   for d in row if d is not None)
        assert h["unit"] % cfg.res_enc.nch == 0
        assert h["units"] * cfg.ppw * cfg.res_ch * h["cpw"] <= 32
        assert h["item_cols"] == h["cpw"] * (h["rc"] // cfg.nchunks)
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
                r2 = h["rec2"][s, c]
                assert (int(r2[REC.R2["qmagic"]]) & 0xFFFFFFFF,
                        r2[REC.R2["qshift"]]) == REC.magic(int(d["qv"]))
                assert r2[REC.R2["per"]] * d["dim"] == h["unit"]
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
