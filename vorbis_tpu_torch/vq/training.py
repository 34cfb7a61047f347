"""Training-data capture + book regeneration: closes the VQ training
loop (reference: the TRAIN_RES/TRAIN_RESAUX dump hooks in
lib/res0.c:380-405 and TRAIN_FLOOR1 in lib/floor1.c:904-938, consumed
by vq/huffbuild.c, vq/distribution.c, vq/metrics.c).

Flow: attach a `TrainingCollector` (set `training.TRAINER`), run the
golden encoder over a corpus, then

  * `resaux` streams (phrase-word symbols per residue groupbook) +
    `huffbuild` regenerate phrasebook Huffman length lists,
  * `res` streams (pre-quantization residual sub-vectors per stage
    book) feed `latticetune`/`lbg_train` retraining and `metrics`,
  * `floor` streams (class-word symbols per floor class book)
    regenerate floor Huffman books,

and `distribution`/`metrics` provide the vq/ toolchain's analysis
equivalents.

Copy of vorbis_tpu/vq/training.py, kept line-aligned with it.  The
port's golden encoder feeds it through the codec's copied hooks
(codec/residue_codec.py encodepart and res01_forward, codec/
floor1_codec.py floor1_encode).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

# module-level active collector (None = hooks disabled; the reference
# gates its dumps on compile-time TRAIN_* defines)
TRAINER = None


class TrainingCollector:
    """Accumulates encoder-side training streams, keyed the way the
    reference names its .vqd dump files."""

    def __init__(self):
        self.res = defaultdict(list)     # book_key -> list[(dim,) vec]
        self.resaux = defaultdict(list)  # groupbook_key -> symbols
        self.floor = defaultdict(list)   # classbook_key -> symbols

    # -- hooks (called from the codec when TRAINER is set) -------------
    def add_res(self, book_key, vec):
        self.res[book_key].append(np.asarray(vec, np.float32).copy())

    def add_resaux(self, group_key, symbol):
        self.resaux[group_key].append(int(symbol))

    def add_floor(self, class_key, symbol):
        self.floor[class_key].append(int(symbol))

    # -- dump/restore in the reference's .vqd text shape ---------------
    def dump_vqd(self, path_prefix: str):
        """Write captured streams as .vqd text files (one vector per
        line, comma-separated) like the reference's dumps."""
        import os
        outs = []
        for key, vecs in self.res.items():
            p = f"{path_prefix}_res_{key}.vqd"
            with open(p, "w") as f:
                for v in vecs:
                    f.write(", ".join(f"{x:g}" for x in v) + ",\n")
            outs.append(p)
        for name, streams in (("resaux", self.resaux),
                              ("floor", self.floor)):
            for key, syms in streams.items():
                p = f"{path_prefix}_{name}_{key}.vqd"
                with open(p, "w") as f:
                    f.write(", ".join(str(s) for s in syms) + ",\n")
                outs.append(p)
        return outs


def distribution(vectors: np.ndarray, bins: int = 64):
    """vq/distribution.c equivalent: value histogram + range stats of
    a training stream."""
    v = np.asarray(vectors, np.float64).reshape(-1)
    if v.size == 0:
        return dict(count=0)
    hist, edges = np.histogram(v, bins=bins)
    return dict(count=int(v.size), min=float(v.min()),
                max=float(v.max()), mean=float(v.mean()),
                hist=hist, edges=edges)


def metrics(book, vectors: np.ndarray):
    """vq/metrics.c equivalent: quantization error statistics of a
    codebook over training vectors — per-cell occupancy, total/worst
    mean-squared error."""
    from ..codec.residue_codec import local_book_besterror
    vecs = np.asarray(vectors, np.float32)
    if vecs.ndim == 1:
        vecs = vecs.reshape(-1, book.dim)
    occupancy = np.zeros(book.entries, np.int64)
    mse = 0.0
    worst = 0.0
    for v in vecs:
        work = v.astype(np.int64).copy()
        entry = local_book_besterror(book, work, 0)
        occupancy[entry] += 1
        err = float(np.sum(work[: book.dim].astype(np.float64) ** 2))
        mse += err
        worst = max(worst, err)
    n = max(1, len(vecs))
    return dict(count=int(len(vecs)), occupancy=occupancy,
                mse=mse / n, worst=worst,
                used_cells=int(np.count_nonzero(occupancy)))


def regenerate_huff_lengths(symbols, n_entries: int, guard: int = 1):
    """Symbols stream -> canonical Huffman length list (the
    huffbuild.c pipeline over a TRAIN_RESAUX/TRAIN_FLOOR1 dump)."""
    from .huffbuild import huffbuild, occupancy_from_entries
    hist = occupancy_from_entries(np.asarray(symbols, np.int64),
                                  n_entries, guard=guard)
    return huffbuild(hist)


def rebuild_book(book, lengths):
    """New runtime Codebook: the shipped book's lattice values with a
    regenerated Huffman length list (the final latticetune step)."""
    from ..codec.codebook import Codebook, StaticCodebook
    sb = book.sb
    nsb = StaticCodebook(
        dim=sb.dim, entries=sb.entries,
        lengthlist=np.asarray(lengths, np.int32),
        maptype=sb.maptype, q_min=sb.q_min, q_delta=sb.q_delta,
        q_quant=sb.q_quant, q_sequencep=sb.q_sequencep,
        quantlist=sb.quantlist)
    return Codebook(nsb)
