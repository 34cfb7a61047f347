"""The port's VQ training toolchain (vorbis_tpu_torch/vq/: vqgen.py's LBG
on a torch device, and the line-aligned copies huffbuild.py,
latticebuild.py and training.py) on test_vq.py's cases, with the port's
own codebook and bit layers, one LBG step against the JAX package's,
and the encode-dump-retrain loop of test_vq.py on the port's golden
encoder, whose TRAINER hooks must collect what the JAX package's
encoder collects on the same clip.  JAX is imported only inside the
LBG test (the JAX package's encoder and collector are numpy).

Tolerances: the LBG cases keep test_vq.py's assertions (the torch step
on the CPU in place of JAX's: final MSE within 25% of the numpy path's);
one step against JAX's on clustered inputs (no argmin near a tie):
assignments and counts equal, the port's codes equal to the float64
mean of each cell rounded once to float32 (0 ulp: its sums are float64),
and JAX's codes within their own float32 summation bound of it (a cell
of m points sums with an error of at most (m - 1) * 2^-24 * sum|x|; 7
ulp on these inputs).  metrics and distribution on a shipped residue
book: equal to the JAX package's; per-cell distortion and MSE within
the float32 cancellation of |p|^2 - 2pc + |c|^2 (and JAX's float32 sums)
of the float64 distances."""

import numpy as np
import pytest
import torch

from vorbis_tpu_torch.bitstream.bitpack import BitReader, BitWriter
from vorbis_tpu_torch.codec.codebook import Codebook, make_codewords
from vorbis_tpu_torch.vq import (huffbuild, latticebuild, latticetune,
                                 lbg_train, occupancy_from_entries)
from vorbis_tpu_torch.vq.huffbuild import lengths_to_bits
from vorbis_tpu_torch.vq.vqgen import _make_step

# one torch thread a pytest-xdist worker (see test_torch_isolation.py)
torch.set_num_threads(1)


def _clusters(seed=0, per=200):
    rng = np.random.RandomState(seed)
    centers = rng.randn(8, 4).astype(np.float32) * 5
    pts = np.concatenate([c + rng.randn(per, 4).astype(np.float32) * 0.3
                          for c in centers])
    return centers, pts


def test_lbg_train_converges():
    centers, pts = _clusters()
    codes, assign, hist = lbg_train(pts, 8, iters=25, use_torch=False)
    assert hist[-1] < hist[0] * 0.2
    # every trained code lands near a true center
    d = np.sqrt(((codes[:, None, :] - centers[None]) ** 2).sum(-1))
    assert (d.min(1) < 1.0).all()


def test_lbg_train_torch_matches_numpy_quality():
    rng = np.random.RandomState(1)
    pts = rng.randn(1500, 2).astype(np.float32)
    c1, _, h1 = lbg_train(pts, 16, iters=15, device="cpu")
    c2, _, h2 = lbg_train(pts, 16, iters=15, use_torch=False)
    assert abs(h1[-1] - h2[-1]) / h2[-1] < 0.25


def test_huffbuild_kraft_valid():
    """Length lists must form decodable prefix codes: make_codewords
    (the sharedbook _make_words equivalent) accepts them."""
    rng = np.random.RandomState(2)
    for _ in range(10):
        n = int(rng.randint(2, 300))
        hist = rng.randint(0, 1000, n)
        if (hist > 0).sum() < 2:
            hist[:2] = 1
        lengths = huffbuild(hist)
        assert (lengths[hist == 0] == 0).all()
        assert (lengths[hist > 0] > 0).all()
        assert make_codewords(lengths) is not None
        # optimality sanity: huffman beats fixed-width
        used = int((hist > 0).sum())
        fixed = int(np.ceil(np.log2(used))) * int(
            np.maximum(hist - 1, 0).sum())
        assert lengths_to_bits(lengths, hist) <= fixed + used


def test_occupancy_guard():
    h = occupancy_from_entries(np.array([0, 0, 3]), 5, guard=1)
    assert list(h) == [3, 1, 1, 2, 1]


def test_lattice_build_tune_roundtrip():
    """Build a lattice, tune lengths on training data, and use the
    result as a real codebook: encode + decode entries."""
    quantlist = np.array([0, 1, 2, 3, 4])
    sb = latticebuild(quantlist, dim=2, minval=-2.0, delta=1.0)
    assert sb.entries == 25 and sb.maptype == 1
    vals = sb.unquantize()
    assert vals is not None and vals.shape == (25, 2)
    # unquantized lattice spans [-2, 2]^2
    assert vals.min() == -2.0 and vals.max() == 2.0
    rng = np.random.RandomState(3)
    train = rng.randn(5000, 2).astype(np.float32)
    tuned = latticetune(sb, train)
    assert make_codewords(tuned.lengthlist) is not None
    book = Codebook(tuned)
    # frequent central entries get shorter codes than corner entries
    center = np.argmin((vals ** 2).sum(1))
    corner = np.argmax((vals ** 2).sum(1))
    assert tuned.lengthlist[center] <= tuned.lengthlist[corner]
    # encode/decode roundtrip through the bit layer
    w = BitWriter()
    entries = rng.randint(0, 25, 64)
    for e in entries:
        w.write(int(book.codewords[e]), int(book.lengths[e]))
    r = BitReader(w.getvalue())
    got = [book.decode(r) for _ in entries]
    assert np.array_equal(got, entries)


def _ulp(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_lbg_step_vs_jax():
    import jax  # noqa: F401  (the JAX package's step below is jitted)
    from vorbis_tpu.vq.vqgen import _make_step as j_make_step

    centers, pts = _clusters()
    codes = centers + np.random.RandomState(4).randn(8, 4).astype(
        np.float32) * 0.5
    jc, ja, jn, jdist, jmse = j_make_step(True)(pts, codes.copy())
    tc, ta, tn, tdist, tmse = _make_step("cpu")(pts, codes.copy())
    assert np.array_equal(ta, ja) and ta.dtype == np.int64
    assert np.array_equal(tn, jn) and tn.dtype == np.float32
    assert tc.dtype == np.float32 and tc.shape == codes.shape
    exact = np.stack([pts[ta == k].astype(np.float64).mean(0)
                      for k in range(8)]).astype(np.float32)
    assert _ulp(tc, exact).max() == 0
    m = tn[:, None].astype(np.float64)
    sum_abs = np.stack([np.abs(pts[ta == k]).astype(np.float64).sum(0)
                        for k in range(8)])
    bound = (m - 1) * 2.0 ** -24 * sum_abs / m
    assert (np.abs(jc.astype(np.float64) - exact) <= bound
            + np.spacing(np.abs(exact))).all()
    # per-cell distortion and MSE: both steps take |p|^2 - 2pc + |c|^2
    # in float32, which cancels; each point's distance lies within
    # 4 * 2^-24 * (|p|^2 + 2|pc| + |c|^2) of the float64 one
    p64, c64 = pts.astype(np.float64), codes[ta].astype(np.float64)
    own = ((p64 - c64) ** 2).sum(-1)
    err = 4 * 2.0 ** -24 * ((p64 ** 2).sum(-1) + 2 * np.abs(p64 * c64)
                            .sum(-1) + (c64 ** 2).sum(-1))
    want, tol = np.bincount(ta, own, 8), np.bincount(ta, err, 8)
    assert (np.abs(tdist - want) <= tol).all()
    assert (np.abs(jdist - want) <= tol + (tn - 1) * 2.0 ** -24 * want).all()
    assert abs(tmse - own.mean()) <= err.mean()
    assert abs(jmse - own.mean()) <= err.mean() \
        + (len(pts) - 1) * 2.0 ** -24 * own.mean()


def test_lbg_step_empty_cell_keeps_its_code():
    _, pts = _clusters()
    codes = np.concatenate([pts[:1], np.full((1, 4), 1e3, np.float32)])
    for device in ("cpu", None):
        c, a, n, dist, _ = _make_step(device)(pts, codes.copy())
        assert n[1] == 0 and (a == 0).all() and dist[1] == 0
        assert np.array_equal(c[1], codes[1])


@pytest.fixture(scope="module")
def residue_books():
    """A shipped residue book of FastEncoder(2, 44100, 0.4)'s setup, in
    the port and in the JAX package, and seeded integer vectors in its
    range."""
    from vorbis_tpu.codec.residue_codec import ResidueLook as JLook
    from vorbis_tpu.models import encsetup as J_setup
    from vorbis_tpu_torch.codec.residue_codec import ResidueLook
    from vorbis_tpu_torch.models import encsetup
    setup = encsetup.setup_vbr(2, 44100, 0.4)
    jsetup = J_setup.setup_vbr(2, 44100, 0.4)
    look = ResidueLook(setup.vi.residues[0], setup.vi.books)
    jlook = JLook(jsetup.vi.residues[0], jsetup.vi.books)
    cls, st = next((c, s) for c, row in enumerate(look.partbooks)
                   for s, b in enumerate(row)
                   if b is not None and b.entries > 16)
    book, jbook = look.partbooks[cls][st], jlook.partbooks[cls][st]
    rng = np.random.RandomState(5)
    vals = book.values
    lim = max(1, int(np.abs(vals).max()) + 2)
    vecs = rng.randint(-lim, lim + 1, (500, book.dim)).astype(np.float32)
    return book, jbook, vecs


def test_metrics_and_distribution_on_a_shipped_book(residue_books):
    from vorbis_tpu.vq import training as JT
    from vorbis_tpu_torch.vq import training as T
    book, jbook, vecs = residue_books
    m, jm = T.metrics(book, vecs), JT.metrics(jbook, vecs)
    assert m["count"] == 500 and np.isfinite(m["mse"])
    assert m["used_cells"] > 0
    assert np.array_equal(m["occupancy"], jm["occupancy"])
    assert (m["mse"], m["worst"], m["used_cells"]) == \
        (jm["mse"], jm["worst"], jm["used_cells"])
    d, jd = T.distribution(vecs), JT.distribution(vecs)
    assert d["count"] == vecs.size and d["hist"].sum() == d["count"]
    assert np.array_equal(d["hist"], jd["hist"])
    assert np.array_equal(d["edges"], jd["edges"])
    lengths = T.regenerate_huff_lengths(m["occupancy"].nonzero()[0],
                                        book.entries)
    assert make_codewords(lengths) is not None
    nb = T.rebuild_book(book, lengths)
    assert np.array_equal(nb.lengths, lengths)


def test_training_collector_dump(tmp_path):
    from vorbis_tpu_torch.vq import training as T
    col = T.TrainingCollector()
    col.add_res("c1_s0", np.array([1.0, -2.0]))
    col.add_resaux("g0", 3)
    col.add_floor("f0", 7)
    files = col.dump_vqd(str(tmp_path / "train"))
    assert len(files) == 3
    assert open(files[0]).read() == "1, -2,\n"
    assert T.TRAINER is None


def _collect(enc_mod, setup_mod, training, pcm):
    """The training streams one encode of `pcm` (stereo, 44.1 kHz, q0.4)
    feeds a package's collector through its codec's TRAINER hooks."""
    enc = enc_mod.Encoder(setup_mod.setup_vbr(2, 44100, 0.4))
    training.TRAINER = training.TrainingCollector()
    try:
        enc.write(pcm)
        enc.end_of_stream()
        enc.pump()
    finally:
        col, training.TRAINER = training.TRAINER, None
    return col


def test_training_loop_closure(tmp_path):
    """test_vq.py test_training_loop_closure on the port: the port's
    golden encoder feeds vorbis_tpu_torch.vq.training.TRAINER through the
    copied hooks; its res, resaux and floor streams (keys, symbols and
    vectors) equal those the JAX package's encoder gives its own
    collector on the same 1 s mix clip; then the .vqd dump, the
    regenerated phrasebook (a valid canonical tree, a cost within 15% of
    the shipped book's, usable for encode) and metrics/distribution over
    a residue book's dump, as there."""
    import vorbis_tpu.codec.encoder as JE
    import vorbis_tpu.models.encsetup as JS
    import vorbis_tpu.vq.training as JT
    from tests import oracle
    from vorbis_tpu_torch.codec import encoder as E
    from vorbis_tpu_torch.codec.residue_codec import ResidueLook
    from vorbis_tpu_torch.models import encsetup
    from vorbis_tpu_torch.vq import training as T

    pcm = oracle.make_test_signal(seconds=1.0, kind="mix")
    col = _collect(E, encsetup, T, pcm)
    jcol = _collect(JE, JS, JT, pcm)
    assert col.resaux and col.res and col.floor
    for name in ("resaux", "floor"):
        assert dict(getattr(col, name)) == dict(getattr(jcol, name)), name
    assert col.res.keys() == jcol.res.keys()
    for k in col.res:
        assert len(col.res[k]) == len(jcol.res[k]), k
        assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes()
                   for a, b in zip(col.res[k], jcol.res[k])), k

    # .vqd dump round (the reference's file interchange)
    files = col.dump_vqd(str(tmp_path / "train"))
    assert files and all(len(open(f).read()) > 0 for f in files)

    # regenerate the phrasebook lengths from the port's own stream
    setup = encsetup.setup_vbr(2, 44100, 0.4)
    gkey, syms = max(col.resaux.items(), key=lambda kv: len(kv[1]))
    shipped = setup.vi.books[int(gkey[1:])]
    lengths = T.regenerate_huff_lengths(syms, shipped.entries)
    assert make_codewords(lengths) is not None      # valid tree
    hist = occupancy_from_entries(np.asarray(syms, np.int64),
                                  shipped.entries, guard=0)
    cost_new = lengths_to_bits(lengths, hist)
    cost_shipped = int((np.asarray(shipped.lengths)[
        np.asarray(syms, np.int64)]).sum())
    assert cost_new <= 1.15 * cost_shipped, (cost_new, cost_shipped)
    nb = T.rebuild_book(shipped, lengths)
    assert all(nb.lengths[s] > 0 for s in set(syms))

    # metrics/distribution equivalents run over a residue book's dump
    rkey, vecs = max(col.res.items(), key=lambda kv: len(kv[1]))
    cls, st = (int(x[1:]) for x in rkey.split("_")[1:])
    look = ResidueLook(setup.vi.residues[0], setup.vi.books)
    book = look.partbooks[cls][st]
    m = T.metrics(book, np.stack(vecs[:500]))
    assert m["count"] > 0 and np.isfinite(m["mse"])
    assert m["used_cells"] > 0
    d = T.distribution(np.stack(vecs[:500]))
    assert d["count"] > 0 and d["hist"].sum() == d["count"]
