"""The port's encode step (vorbis_tpu_torch/ops/encdevice.py,
models/fastenc.py) against vorbis_tpu's DeviceFastEncode, both on the
CPU, stage by stage on identical inputs and as a whole slice.

Stage tolerances: every stage below takes integer or integer-valued
inputs and does integer math, table lookups or single-rounding float ops
in the JAX order, so it is bitwise equal.  Two notes:
  * the JAX codeword lookups (one-hot MXU matmuls) return stale values
    for columns whose length is 0; the port's plain gathers return other
    stale values there.  Zero-length columns carry no bits (merge_columns
    and the packer mask them), so residue field values are compared
    where their length is non-zero, lengths everywhere.
  * _couple_quantize divides and takes square roots, and XLA:CPU may
    contract the floor-energy sum into an FMA, so a rint tie could move a
    residue by one: counted (0 of 131072 measured) and bounded at 0.1%.
Slice tolerances (2 s of the oracle test signal, two 64-packet chunks):
the port's MDCT is the basis matmul (accumulated in float64) where the
JAX step runs the butterfly, and its bark-fit sums round in another
order (test_torch_analysis.py); measured 123 of 128 packets
byte-identical and total bits within 0.02%.  Asserted: >= 90% and within 0.5%.
The port's whole streams are tested in test_torch_stream.py.
"""

import numpy as np
import pytest
import torch

import jax

from tests import oracle
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu.ops import encdevice as JE
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import encdevice as TE

# The suite runs under pytest-xdist with several workers to the host's
# cores; one torch thread a worker keeps torch's OpenMP pools from
# oversubscribing them (the port's test files took 672 s with 6 workers
# on 8 cores at torch's default, 70 s at one thread).
torch.set_num_threads(1)

CP = 64


@pytest.fixture(scope="module")
def enc():
    jfe = JFE(2, 44100, 0.5, switching=False, psy_state=False)
    tfe = TFE(2, 44100, 0.5, switching=False, psy_state=False,
              device="cpu")
    return (jfe, JE.DeviceFastEncode(jfe, chunk_packets=CP),
            tfe, TE.DeviceFastEncode(tfe, chunk_packets=CP))


@pytest.fixture(scope="module")
def chunks(enc):
    """Two 64-packet chunks covering 2 s of the oracle test signal."""
    jd = enc[1]
    pcm = oracle.make_test_signal(seconds=2.0)
    hop = jd.hop
    x = np.zeros((2, 2 * CP * hop + hop), np.float32)
    x[:, hop:hop + pcm.shape[1]] = pcm
    return [np.ascontiguousarray(x[:, c * CP * hop:
                                   c * CP * hop + jd.chunk_samples])
            for c in range(2)]


@pytest.fixture(scope="module")
def mid(enc, chunks):
    """Intermediate values of the port's step on chunk 0, as numpy."""
    _, _, tfe, td = enc
    F = CP
    x = torch.from_numpy(chunks[0])
    flat = x.unfold(1, td.n, td.hop)[:, :F].transpose(0, 1) \
        .reshape(F * 2, td.n)
    md, logmdct, mask = tfe.analysis.full_mask(flat)
    posts, used = tfe.floor(logmdct, mask)
    codes, qposts = td._floor_wrap(posts)
    curve = tfe.floor.render(qposts, tfe.fromdB)
    out2, any_used = td._couple_quantize(md, curve, used, F)
    return dict(md=md.numpy(), posts=posts.numpy(), used=used.numpy(),
                codes=codes.numpy(), curve=curve.numpy(),
                out2=out2.numpy(), any_used=any_used.numpy())


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.array(t)


def test_floor_wrap_bitwise(enc, mid):
    _, jd, _, td = enc
    cj, qj = jax.jit(jd._floor_wrap)(mid["posts"], mid["used"])
    ct, qt = td._floor_wrap(torch.from_numpy(mid["posts"]))
    assert np.array_equal(_np(ct), _np(cj))
    assert np.array_equal(_np(qt), _np(qj))


def test_floor_fields_bitwise(enc, mid):
    _, jd, _, td = enc
    vj, lj = jax.jit(jd._floor_fields)(mid["codes"], mid["used"])
    vt, lt = td._floor_fields(torch.from_numpy(mid["codes"]),
                              torch.from_numpy(mid["used"]))
    assert np.array_equal(_np(lt), _np(lj))
    assert np.array_equal(_np(vt), _np(vj).astype(np.int64))


def test_couple_quantize_close(enc, mid):
    _, jd, _, td = enc
    args = (mid["md"], mid["curve"], mid["used"])
    oj, uj = jax.jit(lambda a, b, c: jd._couple_quantize(a, b, c, CP))(
        *args)
    ot, ut = td._couple_quantize(*map(torch.from_numpy, args), CP)
    assert np.array_equal(_np(ut), _np(uj))
    d = np.abs(_np(ot) - _np(oj))
    print(f"coupled residues differing: {(d > 0).sum()}/{d.size}")
    assert d.max() <= 1 and (d > 0).sum() <= 0.001 * d.size


def test_classify2_vq_and_residue_fields_bitwise(enc, mid):
    _, jd, _, td = enc
    out2 = mid["out2"]
    absM, absA = np.abs(out2[:, 0]), np.abs(out2[:, 1])
    pj = np.array(jax.jit(jd._classify2)(absM, absA))
    pt = td._classify2(torch.from_numpy(absM), torch.from_numpy(absA))
    assert np.array_equal(_np(pt), pj)
    inter = np.ascontiguousarray(out2.transpose(0, 2, 1).reshape(CP, -1))
    ej = jax.jit(jd._vq_stages)(inter, pj)
    et = td._vq_stages(torch.from_numpy(inter),
                       torch.from_numpy(pj.copy()))
    assert len(et) == len(ej) == td.stages
    for a, b in zip(et, ej):
        assert np.array_equal(_np(a), _np(b))
    pw_p = pj.reshape(CP, 1, -1)
    ent_p = [_np(e).reshape(CP, 1, td.partvals, -1) for e in ej]
    used_p = mid["any_used"].reshape(CP, 1)
    vj, lj = jax.jit(jd._residue_fields)(pw_p, ent_p, used_p)
    vt, lt = td._residue_fields(torch.from_numpy(pw_p),
                                [torch.from_numpy(e) for e in ent_p],
                                torch.from_numpy(used_p))
    lj, lt = _np(lj), _np(lt)
    assert np.array_equal(lt, lj)
    live = lj > 0
    assert live.sum() > 1000
    assert np.array_equal(_np(vt)[live], _np(vj).astype(np.int64)[live])


def test_classify_uncoupled_bitwise(enc):
    """The res0/res1 classifier (the coupling=False layout)."""
    _, jd, _, td = enc
    rng = np.random.RandomState(5)
    res = rng.randint(-20, 21, (8, 2 * td.partvals * td.spp)) \
        .astype(np.float32)
    kj = np.asarray(jax.jit(jd._classify)(res))
    kt = td._classify(torch.from_numpy(res))
    assert np.array_equal(_np(kt), kj)


def _random_residues(n, B=6, seed=0):
    """tests/test_residue_device.py's residues: wide values, then a
    quiet tail."""
    rng = np.random.RandomState(seed)
    res = rng.randint(-20, 21, (B, n)).astype(np.int64)
    res[:, n - 648:] = rng.randint(-2, 3, (B, 648))
    return res


def test_residue_vq_classify_and_encode_bitwise(enc):
    """ops/residue_device.py: DeviceResidueVQ.classify and the
    multi-stage DeviceLatticeBook.encode cascade, as
    tests/test_residue_device.py:28,38 hold the JAX side."""
    jfe, _, tfe, _ = enc
    jv, tv = jfe.dvq, tfe.dvq
    res = _random_residues(jv.end)
    pj = np.array(jax.jit(jv.classify)(res))
    pt = tv.classify(torch.from_numpy(res))
    assert np.array_equal(_np(pt), pj)
    resf = res.astype(np.float32)
    ej, rj = jax.jit(jv.encode)(resf, pj)
    et, rt = tv.encode(torch.from_numpy(resf), torch.from_numpy(pj))
    assert len(et) == len(ej) == jv.stages
    for a, b in zip(et, ej):
        assert np.array_equal(_np(a), _np(b))
    assert np.array_equal(_np(rt), _np(rj))


@pytest.fixture(scope="module")
def columns(enc, mid):
    """The raw (value, length) columns of chunk 0's packets."""
    _, _, _, td = enc
    F = CP
    fv, fl = td._floor_fields(torch.from_numpy(mid["codes"]),
                              torch.from_numpy(mid["used"]))
    out2 = torch.from_numpy(mid["out2"])
    pw = td._classify2(out2[:, 0].abs(), out2[:, 1].abs())
    ent = td._vq_stages(out2.transpose(1, 2).reshape(F, -1), pw)
    rv, rl = td._residue_fields(
        pw.reshape(F, 1, -1),
        [e.reshape(F, 1, td.partvals, -1) for e in ent],
        torch.from_numpy(mid["any_used"]).reshape(F, 1))
    hv = torch.tensor([[0, td.ctx.mode_idx, 1, 1]] * F,
                      dtype=torch.int64)
    vals = torch.cat([hv, fv.reshape(F, -1), rv], 1)
    lens = torch.cat([td.hdr_l_t.expand(F, 4), fl.reshape(F, -1), rl], 1)
    assert vals.shape[1] == td.plan.n_cols
    return vals, lens


def test_merge_columns_bitwise(enc, columns):
    _, jd, _, td = enc
    vals, lens = columns
    vj, lj = jax.jit(lambda v, l: JE.merge_columns(v, l, jd.plan))(
        vals.numpy().astype(np.uint32), lens.numpy())
    vt, lt = TE.merge_columns(vals, lens, td.gidx_t)
    assert np.array_equal(_np(lt), _np(lj))
    assert np.array_equal(_np(vt), _np(vj).astype(np.int64))


def _pack_both(vals, lens, wb):
    pj, nj = jax.jit(lambda v, l: JE.pack_bits_device(v, l, wb))(
        vals.astype(np.uint32), lens.astype(np.int32))
    pt, nt = TE.pack_bits(torch.from_numpy(vals.astype(np.int64)),
                          torch.from_numpy(lens.astype(np.int32)), wb)
    return (_np(pt), _np(nt)), (np.asarray(pj), np.asarray(nj))


def test_pack_bits_bitwise_real_plan(enc, columns):
    _, jd, _, td = enc
    mv, ml = TE.merge_columns(*columns, td.gidx_t)
    (pt, nt), (pj, nj) = _pack_both(mv.numpy(), ml.numpy(), td.plan.wb)
    assert np.array_equal(nt, nj)
    assert np.array_equal(pt, pj)


@pytest.mark.parametrize("wb", [96, 40])
def test_pack_bits_bitwise_random_columns(wb):
    """Random widths 0..32 with values below 2^width; wb=40 also cuts
    packets short (bytes past the budget are dropped on both sides)."""
    rng = np.random.RandomState(wb)
    lens = rng.randint(0, 33, (16, 23))
    lens[:, 5] = 0
    vals = rng.randint(0, 2 ** 32, (16, 23), dtype=np.uint64) \
        & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))
    vals[:, 5] = 12345          # stale value in a zero-width column
    (pt, nt), (pj, nj) = _pack_both(vals, lens, wb)
    assert np.array_equal(nt, nj)
    assert np.array_equal(pt, pj)


def test_slice_packets_vs_jax(enc, chunks):
    _, jd, _, td = enc
    jstep = jax.jit(jd.make_step())
    tstep = td.make_step()
    same = tot = 0
    bits_j = bits_t = 0
    for ch in chunks:
        pj, nj = map(np.asarray, jstep(ch))
        pt, nt = (t.numpy() for t in tstep(torch.from_numpy(ch)))
        assert pt.shape == pj.shape and nt.shape == nj.shape
        for f in range(len(nj)):
            a = pj[f, :(nj[f] + 7) // 8].tobytes()
            b = pt[f, :(nt[f] + 7) // 8].tobytes()
            same += bool(nj[f] == nt[f] and a == b)
            tot += 1
        bits_j += int(nj.sum())
        bits_t += int(nt.sum())
    print(f"byte-identical packets {same}/{tot}; bits {bits_t} vs "
          f"{bits_j} (JAX)")
    assert same >= 0.9 * tot
    assert abs(bits_t - bits_j) <= 0.005 * bits_j


def _jax_tables(jfe, jd):
    tabs = {"fromdB": np.asarray(jfe.fromdB),
            "gidx": np.where(jd.plan.gidx < 0, jd.plan.n_cols,
                             jd.plan.gidx),
            "ph_cw": jd.ph_cw, "ph_cl": jd.ph_cl,
            "thr1": jfe.couple["thr1"], "thr2": jfe.couple["thr2"],
            "threv": jfe.couple["threv"]}
    for s, st in enumerate(jd.stage_tabs):
        tabs[f"cw{s}"], tabs[f"cl{s}"] = st["cw"], st["cl"]
        for c, d in enumerate(jd.res_books[s]):
            if d is not None and not d["ident"]:
                tabs[f"rd{s}_{c}"] = d["remap_digits"]
    for c, row in enumerate(jfe.dvq.books):
        for s, b in enumerate(row):
            if b is not None:
                for k in ("values", "remap", "sub_values"):
                    tabs[f"book{c}_{s}_{k}"] = np.asarray(getattr(b, k))
    return tabs


def _port_tables(tfe, td):
    tabs = {"fromdB": tfe.fromdB, "gidx": td.gidx_t, "ph_cw": td.ph_cw_t,
            "ph_cl": td.ph_cl_t, "thr1": td.thr1_t, "thr2": td.thr2_t,
            "threv": td.threv_t}
    for s, st in enumerate(td.stage_tabs):
        tabs[f"cw{s}"], tabs[f"cl{s}"] = st["t"]["cw"], st["t"]["cl"]
        for c, d in enumerate(td.res_books[s]):
            if d is not None and not d["ident"]:
                tabs[f"rd{s}_{c}"] = d["rd_t"]
    for c, row in enumerate(tfe.dvq.books):
        for s, b in enumerate(row):
            if b is not None:
                for k in ("values", "remap", "sub_values"):
                    tabs[f"book{c}_{s}_{k}"] = getattr(b, k)
    return tabs


def test_device_tables_encode_bitwise(enc):
    """Every encode-step table the port moved through device_tables
    equals the JAX package's constant, value for value."""
    jfe, jd, tfe, td = enc
    want = _jax_tables(jfe, jd)
    got = _port_tables(tfe, td)
    assert sorted(want) == sorted(got) and len(got) > 20
    for k in want:
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == w.shape, k
        assert np.array_equal(g, w.astype(g.dtype)), k
        assert np.array_equal(g.astype(w.dtype), w), k
