"""Residue bit codec (types 0/1/2), decode side.

Reference semantics: lib/res0.c _01inverse / res2_inverse with the
vector-add flavors of lib/codebook.c (decodevs_add stride-interleaved
for type 0, decodev_add sequential for type 1, decodevv_add
channel-interleaved for type 2).  Bits for stage s of all partitions
are grouped after stage s-1 (phrase words interleave with stage 0).
A truncated packet mid-residue is a normal stop: everything decoded so
far is kept.

Copy of vorbis_tpu/codec/residue_codec.py, kept line-aligned with it:
the decode side, `_enc_book_fields` (the device VQ), the search
`local_book_besterror` (vq/training.py) and the golden encoder's
classify and pack (`res_class`, `res_forward`, with the TRAIN_RES and
TRAIN_RESAUX hooks into the port's vq/training.py).
"""

from __future__ import annotations

import numpy as np

from ..bitstream.bitpack import BitReader, EndOfPacket, ilog
from .headers import ResidueInfo


class ResidueLook:
    def __init__(self, info: ResidueInfo, books):
        self.info = info
        self.books = books
        self.phrasebook = books[info.groupbook]
        self.dim = self.phrasebook.dim
        self.partvals = info.partvals
        # partition-class digit expansion of a phrase word, MSD first
        pv = np.arange(self.partvals, dtype=np.int64)
        digits = []
        mult = self.partvals // info.partitions
        val = pv.copy()
        for _ in range(self.dim):
            digits.append(val // mult)
            val = val - (val // mult) * mult
            mult //= info.partitions
        self.decodemap = np.stack(digits, axis=1)  # (partvals, dim)
        # stage books per partition class
        self.stages = max((ilog(s) for s in info.secondstages), default=0)
        self.partbooks = [[None] * self.stages for _ in range(info.partitions)]
        acc = 0
        for j in range(info.partitions):
            st = ilog(info.secondstages[j])
            for k in range(st):
                if info.secondstages[j] & (1 << k):
                    self.partbooks[j][k] = books[info.booklist[acc]]
                    acc += 1


def _decodev_add(book, a, offset, n, r):
    """decodev_add: sequential add (residue type 1).  The whole run of
    same-book codewords decodes in one decode_run call."""
    dim = book.dim
    count = (n + dim - 1) // dim
    ents, got = book.decode_run(r, count)
    if got:
        v = book.values[ents[:got]].reshape(-1)[:min(got * dim, n)]
        a[offset:offset + len(v)] += v
    if got < count:
        raise EndOfPacket


def _decodevs_add(book, a, offset, n, r):
    """decodevs_add: stride-interleaved add (residue type 0).  All
    step codewords are read first, then scattered."""
    step = n // book.dim
    entries, got = book.decode_run(r, step)
    if got < step:
        raise EndOfPacket
    v = book.values[entries]          # (step, dim)
    for d in range(book.dim):
        o = offset + d * step
        a[o:o + step] += v[:, d]


def decode_residue(r: BitReader, look: ResidueLook, spec: np.ndarray,
                   do_not_decode: np.ndarray, n2: int, restype: int) -> None:
    """Decode one submap's residue into spec (ch, n2) float32.

    spec rows are the channels of this submap bundle (already filtered
    to chmux==submap); do_not_decode marks channels whose floor was
    unused (they still participate in res2's single interleaved
    vector).
    """
    info = look.info
    ch = spec.shape[0]
    if restype == 2:
        if not np.any(~do_not_decode):
            return
        maxv = n2 * ch
        end = min(info.end, maxv)
        n = end - info.begin
        if n <= 0:
            return
        partvals = n // info.grouping
        flat = spec.T.reshape(-1)     # channel-interleaved view (copy)
        try:
            _res2_decode(r, look, flat, partvals, ch)
        except EndOfPacket:
            pass
        spec[:] = flat.reshape(-1, ch).T
        return

    # types 0/1: per-channel vectors, excluding do-not-decode channels
    used = np.where(~do_not_decode)[0]
    if len(used) == 0:
        return
    end = min(info.end, n2)
    n = end - info.begin
    if n <= 0:
        return
    partvals = n // info.grouping
    ppw = look.dim
    partwords = (partvals + ppw - 1) // ppw
    partword = np.zeros((len(used), partwords, ppw), dtype=np.int64)
    decodefn = _decodevs_add if restype == 0 else _decodev_add
    try:
        for s in range(look.stages):
            i = 0
            l = 0
            while i < partvals:
                if s == 0:
                    for j in range(len(used)):
                        temp = look.phrasebook.decode(r)
                        if temp >= look.partvals:
                            raise EndOfPacket
                        partword[j, l] = look.decodemap[temp]
                k = 0
                while k < ppw and i < partvals:
                    for j, cj in enumerate(used):
                        offset = info.begin + i * info.grouping
                        pcls = int(partword[j, l, k])
                        if info.secondstages[pcls] & (1 << s):
                            book = look.partbooks[pcls][s]
                            if book is not None:
                                decodefn(book, spec[cj], offset,
                                         info.grouping, r)
                    k += 1
                    i += 1
                l += 1
    except EndOfPacket:
        pass


def _res2_decode(r: BitReader, look: ResidueLook, flat: np.ndarray,
                 partvals: int, ch: int) -> None:
    info = look.info
    ppw = look.dim
    partwords = (partvals + ppw - 1) // ppw
    partword = np.zeros((partwords, ppw), dtype=np.int64)
    vals_tbl = None
    for s in range(look.stages):
        i = 0
        l = 0
        while i < partvals:
            if s == 0:
                temp = look.phrasebook.decode(r)
                if temp >= look.partvals:
                    raise EndOfPacket
                partword[l] = look.decodemap[temp]
            k = 0
            while k < ppw and i < partvals:
                pcls = int(partword[l, k])
                if info.secondstages[pcls] & (1 << s):
                    book = look.partbooks[pcls][s]
                    if book is not None:
                        offset = info.begin + i * info.grouping
                        # decodevv_add: starts at (offset/ch)*ch and ends
                        # at ((offset+n)/ch)*ch (C integer-division walk)
                        j = (offset // ch) * ch
                        end = ((offset + info.grouping) // ch) * ch
                        cnt = (end - j + book.dim - 1) // book.dim
                        ents, got = book.decode_run(r, cnt)
                        if got:
                            v = book.values[ents[:got]].reshape(-1)
                            v = v[:min(got * book.dim, end - j)]
                            flat[j:j + len(v)] += v
                        if got < cnt:
                            raise EndOfPacket
                k += 1
                i += 1
            l += 1


# ---------------------------------------------------------------------------
# encode side (reference: res0.c _01class/_2class/_01forward/_encodepart/
# local_book_besterror; encoder book fields per sharedbook.c
# vorbis_book_init_encode)
# ---------------------------------------------------------------------------

def _enc_book_fields(book):
    """minval/delta/quantvals for the integer lattice fast path."""
    if not hasattr(book, "_enc_fields"):
        from .codebook import float32_unpack, maptype1_quantvals
        sb = book.sb
        minval = int(np.rint(np.float64(float32_unpack(sb.q_min))))
        delta = int(np.rint(np.float64(float32_unpack(sb.q_delta))))
        qv = maptype1_quantvals(sb.entries, sb.dim)
        book._enc_fields = (minval, delta, qv)
    return book._enc_fields


def local_book_besterror(book, a, off):
    """Nearest-entry search with error feed-forward: quantizes a[off:
    off+dim] in place (subtracting the chosen entry's values) and
    returns the entry index."""
    dim = book.dim
    minval, delta, qv = _enc_book_fields(book)
    ze = qv >> 1
    index = 0
    p = [0] * dim
    for o in range(dim - 1, -1, -1):
        if delta != 1:
            v = (int(a[off + o]) - minval + (delta >> 1)) // delta \
                if (int(a[off + o]) - minval + (delta >> 1)) >= 0 else \
                -((-(int(a[off + o]) - minval + (delta >> 1))) // delta)
        else:
            v = int(a[off + o]) - minval
        m = ((ze - v) << 1) - 1 if v < ze else ((v - ze) << 1)
        index = index * qv + (0 if m < 0 else (qv - 1 if m >= qv else m))
        p[o] = v * delta + minval
    if book.lengths[index] <= 0:
        # lattice miss: brute-force scan following the vq tool's value
        # patterning
        best = -1
        # C uses a fixed e[8]; the odometer walk can step one past the
        # active dims on the final iteration (res0.c:363-367), so keep
        # guard slots like the C array does
        e = [0] * (dim + 2)
        maxval = minval + delta * (qv - 1)
        for i in range(book.entries):
            if book.lengths[i] > 0:
                this = 0
                for j in range(dim):
                    val = e[j] - int(a[off + j])
                    this += val * val
                if best == -1 or this < best:
                    p = list(e)
                    best = this
                    index = i
            j = 0
            while e[j] >= maxval:
                e[j] = 0
                j += 1
            if e[j] >= 0:
                e[j] += delta
            e[j] = -e[j]
    if index > -1:
        for i in range(dim):
            a[off + i] -= p[i]
    return index


def encodepart(w, vec, off, n, book, train_key=None):
    from ..vq import training as _T
    step = n // book.dim
    for i in range(step):
        if _T.TRAINER is not None and train_key is not None:
            # TRAIN_RES: pre-quantization residual sub-vector
            # (res0.c:380-405 dump hook)
            _T.TRAINER.add_res(train_key,
                               vec[off + i * book.dim:
                                   off + (i + 1) * book.dim])
        entry = local_book_besterror(book, vec, off + i * book.dim)
        book.encode(w, entry)


def res01_class(look: ResidueLook, in_ch, ch):
    info = look.info
    spp = info.grouping
    n = info.end - info.begin
    partvals = n // spp
    scale = np.float32(100.0) / np.float32(spp)
    partword = np.zeros((ch, partvals), dtype=np.int64)
    cm1 = info.classmetric1
    cm2 = info.classmetric2
    for j in range(ch):
        seg = np.abs(np.asarray(in_ch[j][info.begin:info.begin
                                         + partvals * spp],
                                dtype=np.int64)).reshape(partvals, spp)
        mx = seg.max(axis=1)
        ent = (seg.sum(axis=1).astype(np.float64)
               * np.float64(scale)).astype(np.int64)
        for i in range(partvals):
            k = 0
            while k < info.partitions - 1:
                if mx[i] <= cm1[k] and (cm2[k] < 0 or ent[i] < cm2[k]):
                    break
                k += 1
            partword[j][i] = k
    return partword


def res2_class(look: ResidueLook, in_ch, ch):
    info = look.info
    spp = info.grouping
    n = info.end - info.begin
    partvals = n // spp
    partword = np.zeros((1, partvals), dtype=np.int64)
    cm1 = info.classmetric1
    cm2 = info.classmetric2
    l = info.begin // ch
    for i in range(partvals):
        magmax = 0
        angmax = 0
        for j in range(0, spp, ch):
            v = abs(int(in_ch[0][l]))
            if v > magmax:
                magmax = v
            for k in range(1, ch):
                v = abs(int(in_ch[k][l]))
                if v > angmax:
                    angmax = v
            l += 1
        j = 0
        while j < info.partitions - 1:
            if magmax <= cm1[j] and angmax <= cm2[j]:
                break
            j += 1
        partword[0][i] = j
    return partword


def res01_forward(w, look: ResidueLook, in_ch, ch, partword,
                  entries=None):
    """Encode residues (types 0/1 layout; res2 calls with the
    interleaved single vector).

    entries: optional precomputed VQ decisions (e.g. from the device
    fast path, ops/residue_device.py): entries[j][s][i] is an int
    array of the partition's per-value entry numbers with each
    sub-vector's entry at index t*book.dim; when given, the
    local_book_besterror scans are skipped and the codewords are
    emitted directly."""
    info = look.info
    spp = info.grouping
    possible = info.partitions
    ppw = look.dim
    n = info.end - info.begin
    partvals = n // spp
    stages = look.stages
    for s in range(stages):
        i = 0
        while i < partvals:
            if s == 0:
                for j in range(ch):
                    val = int(partword[j][i])
                    for k in range(1, ppw):
                        val *= possible
                        if i + k < partvals:
                            val += int(partword[j][i + k])
                    if val < look.phrasebook.entries:
                        from ..vq import training as _T
                        if _T.TRAINER is not None:
                            # TRAIN_RESAUX: phrase-word symbol stream
                            _T.TRAINER.add_resaux(
                                f"g{info.groupbook}", val)
                        look.phrasebook.encode(w, val)
            k = 0
            while k < ppw and i < partvals:
                offset = i * spp + info.begin
                for j in range(ch):
                    cls = int(partword[j][i])
                    if info.secondstages[cls] & (1 << s):
                        book = look.partbooks[cls][s]
                        if book is not None:
                            if entries is not None:
                                row = np.asarray(entries[j][s][i])
                                ents = row[::book.dim]
                                if hasattr(w, "write_array"):
                                    w.write_array(
                                        book.codewords[ents],
                                        book.lengths[ents])
                                else:
                                    for e in ents:
                                        book.encode(w, int(e))
                            else:
                                encodepart(w, in_ch[j], offset, spp,
                                           book,
                                           f"g{info.groupbook}"
                                           f"_c{cls}_s{s}")
                k += 1
                i += 1


def res_forward(w, look: ResidueLook, bundle, nonzero, restype,
                partword=None):
    """Top-level residue forward pass for a channel bundle of int
    residue vectors (numpy int64, mutated by error feed-forward)."""
    if restype == 2:
        n2 = len(bundle[0])
        ch = len(bundle)
        if not any(nonzero):
            return
        work = np.empty(n2 * ch, dtype=np.int64)
        for i, v in enumerate(bundle):
            work[i::ch] = v
        res01_forward(w, look, [work], 1, partword)
        return
    used = [bundle[i] for i in range(len(bundle)) if nonzero[i]]
    if used:
        res01_forward(w, look, used, len(used), partword)


def res_class(look: ResidueLook, bundle, nonzero, restype):
    if restype == 2:
        if not any(nonzero):
            return None
        # _2class walks the per-channel vectors directly (the
        # interleave only happens in the forward pass)
        return res2_class(look, bundle, len(bundle))
    used = [bundle[i] for i in range(len(bundle)) if nonzero[i]]
    if not used:
        return None
    return res01_class(look, used, len(used))
