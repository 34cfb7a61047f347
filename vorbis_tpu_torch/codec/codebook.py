"""Vorbis codebook engine: header (de)serialization, canonical Huffman
codeword assignment, VQ lattice reconstruction, and fast table decode.

Semantics mirror the Vorbis I spec (codebook sync 0x564342, LSB-first
transmission, canonical "lowest codeword first" Huffman assignment) as
implemented by the reference (lib/codebook.c vorbis_staticbook_unpack,
lib/sharedbook.c _make_words/_book_unquantize); the code here is an
independent reimplementation designed for array-at-a-time use.

Copy of vorbis_tpu/codec/codebook.py, kept line-aligned with it, without
the native Huffman decoder: `decode_run` takes the Python per-symbol
path.

Entropy coding stays on the host by design: the TPU pipeline emits
dense arrays of codebook entry indices; this module turns indices into
bits (encode) and bits into indices (decode).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..bitstream.bitpack import BitReader, BitWriter, EndOfPacket, ilog


class BadHeaderError(ValueError):
    pass


def float32_unpack(raw: int) -> np.float32:
    """Vorbis' non-IEEE packed float: 21-bit unnormalized mantissa,
    10-bit exponent biased by 768, sign in bit 31."""
    mant = float(raw & 0x1FFFFF)
    if raw & 0x80000000:
        mant = -mant
    exp = ((raw & 0x7FE00000) >> 21) - 20 - 768
    exp = max(-63, min(63, exp))
    return np.float32(math.ldexp(mant, exp))


def maptype1_quantvals(entries: int, dim: int) -> int:
    """Greatest vals with vals**dim <= entries (integer-exact)."""
    if entries < 1 or dim < 1:
        return 0
    vals = max(1, int(entries ** (1.0 / dim)))
    while (vals + 1) ** dim <= entries:
        vals += 1
    while vals ** dim > entries:
        vals -= 1
    return max(1, vals)


def make_codewords(lengths: np.ndarray) -> np.ndarray | None:
    """Canonical Huffman assignment: entries (in order) get the lowest
    available codeword of their length.  Returns uint32 codewords in
    *transmission* bit order (first-sent bit in bit 0, matching the
    LSB-first packer), or None if the length spec is over/under-
    populated (single 1-bit entry allowed per the spec retcon).
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    n = len(lengths)
    out = np.zeros(n, dtype=np.uint32)
    # marker[L] = lowest still-available codeword of length L (MSB-first
    # int).  Claiming a node must (a) advance the claimed length's
    # marker past the node's subtree, (b) advance shorter markers that
    # sat on the claimed path, (c) re-dangle longer markers that hung
    # below the claimed node onto the next free branch.  This is the
    # canonical "lowest codeword first" assignment of the Vorbis I spec.
    marker = [0] * 33
    used = 0
    for i in range(n):
        L = int(lengths[i])
        if L <= 0:
            continue
        if L > 32:
            return None
        entry = marker[L]
        if L < 32 and (entry >> L):
            return None  # overpopulated tree
        used += 1
        # (a)+(b): walk toward the root; even marker -> advance to its
        # sibling and keep walking is wrong — an even (left-child)
        # marker's sibling is free, so advance and stop at the first
        # odd marker, which completes its parent and must jump to the
        # next branch at that depth.
        for j in range(L, 0, -1):
            if marker[j] & 1:
                if j == 1:
                    marker[1] += 1
                else:
                    marker[j] = marker[j - 1] << 1
                break
            marker[j] += 1
        # (c): longer markers that dangled below the claimed node now
        # dangle from the updated branch.
        prev = entry
        for j in range(L + 1, 33):
            if (marker[j] >> 1) == prev:
                prev = marker[j]
                marker[j] = marker[j - 1] << 1
            else:
                break
        # store transmission-order (bit-reversed) codeword
        rev = 0
        cc = entry
        for _ in range(L):
            rev = (rev << 1) | (cc & 1)
            cc >>= 1
        out[i] = rev
    if used == 0:
        return out
    # underpopulated trees rejected, except the single-entry retcon
    # (one used entry of length 1 -> codeword '0').
    if not (used == 1 and marker[2] == 2):
        for j in range(1, 33):
            if marker[j] & ((0xFFFFFFFF) >> (32 - j)):
                return None
    return out


@dataclass
class StaticCodebook:
    dim: int
    entries: int
    lengthlist: np.ndarray          # int array, 0 = unused entry
    maptype: int = 0
    q_min: int = 0                  # raw packed-float longs
    q_delta: int = 0
    q_quant: int = 0
    q_sequencep: int = 0
    quantlist: np.ndarray | None = None

    # ---- bit syntax ----------------------------------------------------
    @classmethod
    def unpack(cls, r: BitReader) -> "StaticCodebook":
        if r.read(24) != 0x564342:
            raise BadHeaderError("bad codebook sync")
        dim = r.read(16)
        entries = r.read(24)
        if ilog(dim) + ilog(entries) > 24:
            raise BadHeaderError("codebook dim*entries overflow")
        ordered = r.read1()
        lengths = np.zeros(entries, dtype=np.int32)
        if not ordered:
            sparse = r.read1()
            if sparse:
                for i in range(entries):
                    if r.read1():
                        lengths[i] = r.read(5) + 1
            else:
                for i in range(entries):
                    lengths[i] = r.read(5) + 1
        else:
            length = r.read(5) + 1
            i = 0
            while i < entries:
                num = r.read(ilog(entries - i))
                if length > 32 or num > entries - i or (
                        num > 0 and (num - 1) >> (length - 1) > 1):
                    raise BadHeaderError("bad ordered codebook lengths")
                lengths[i:i + num] = length
                i += num
                length += 1
        maptype = r.read(4)
        q_min = q_delta = q_quant = q_seq = 0
        quantlist = None
        if maptype in (1, 2):
            q_min = r.read(32)
            q_delta = r.read(32)
            q_quant = r.read(4) + 1
            q_seq = r.read1()
            if maptype == 1:
                nq = maptype1_quantvals(entries, dim) if dim else 0
            else:
                nq = entries * dim
            quantlist = np.array([r.read(q_quant) for _ in range(nq)],
                                 dtype=np.int64)
        elif maptype != 0:
            raise BadHeaderError(f"bad maptype {maptype}")
        return cls(dim, entries, lengths, maptype, q_min, q_delta,
                   q_quant, q_seq, quantlist)

    def pack(self, w: BitWriter) -> None:
        w.write(0x564342, 24)
        w.write(self.dim, 16)
        w.write(self.entries, 24)
        lengths = self.lengthlist
        # choose ordered encoding when lengths are monotonically
        # nondecreasing and all used (matches reference heuristic)
        all_used = bool(np.all(lengths > 0)) and self.entries > 0
        ordered = all_used and bool(np.all(np.diff(lengths) >= 0))
        if ordered:
            w.write(1, 1)
            w.write(int(lengths[0]) - 1, 5)
            i = 0
            cur = int(lengths[0])
            while i < self.entries:
                run = int(np.searchsorted(lengths, cur, side="right")) - i
                w.write(run, ilog(self.entries - i))
                i += run
                cur += 1
        else:
            w.write(0, 1)
            if all_used:
                w.write(0, 1)
                for L in lengths:
                    w.write(int(L) - 1, 5)
            else:
                w.write(1, 1)
                for L in lengths:
                    if L > 0:
                        w.write(1, 1)
                        w.write(int(L) - 1, 5)
                    else:
                        w.write(0, 1)
        w.write(self.maptype, 4)
        if self.maptype in (1, 2):
            w.write(self.q_min, 32)
            w.write(self.q_delta, 32)
            w.write(self.q_quant - 1, 4)
            w.write(self.q_sequencep, 1)
            for q in self.quantlist:
                w.write(int(q), self.q_quant)

    # ---- value reconstruction -------------------------------------------
    def unquantize(self) -> np.ndarray | None:
        """Reconstruct the (entries, dim) float32 VQ value table
        (maptype 1 lattices / maptype 2 explicit), replicating the
        reference's float32 evaluation order so decode stays exact."""
        if self.maptype not in (1, 2) or self.dim == 0:
            return None
        # The reference evaluates `fabs(q)*delta+mindel+last` in double
        # (C promotion via fabs) and rounds ONCE to float per element,
        # with `last` being the previously *stored* float.  Replicate
        # that: double accumulate, single float32 round per dim step.
        mindel = np.float64(float32_unpack(self.q_min))
        delta = np.float64(float32_unpack(self.q_delta))
        q = np.abs(self.quantlist.astype(np.float64))
        if self.maptype == 1:
            nq = maptype1_quantvals(self.entries, self.dim)
            j = np.arange(self.entries, dtype=np.int64)
            cols = []
            indexdiv = 1
            for k in range(self.dim):
                idx = (j // indexdiv) % nq
                cols.append(q[idx])
                indexdiv *= nq
            base = np.stack(cols, axis=1)  # (entries, dim) double
        else:
            base = q.reshape(self.entries, self.dim)
        base = base * delta + mindel
        vals = np.empty((self.entries, self.dim), dtype=np.float32)
        if self.q_sequencep:
            last = np.zeros(self.entries, dtype=np.float32)
            for k in range(self.dim):
                v = (base[:, k] + last.astype(np.float64)).astype(np.float32)
                vals[:, k] = v
                last = v
        else:
            vals[:] = base.astype(np.float32)
        return vals


class Codebook:
    """Runtime codebook: Huffman encode table + fast table decoder +
    unquantized values.  Built either from a StaticCodebook parsed out
    of a stream header (decode) or from our transcribed static tables
    (encode)."""

    FAST_BITS = 10

    def __init__(self, sb: StaticCodebook):
        self.sb = sb
        self.dim = sb.dim
        self.entries = sb.entries
        codes = make_codewords(sb.lengthlist)
        if codes is None:
            raise BadHeaderError("invalid codebook length spec")
        self.codewords = codes          # transmission order ints
        self.lengths = sb.lengthlist.astype(np.int32)
        self.values = sb.unquantize()   # (entries, dim) float32 or None
        self.used_entries = int(np.count_nonzero(self.lengths))
        self._build_decode_table()

    def _build_decode_table(self):
        K = self.FAST_BITS
        table = np.zeros(1 << K, dtype=np.int32)  # (entry<<6)|len, 0=invalid
        table[:] = -1
        long_codes = {}
        for e in range(self.entries):
            L = int(self.lengths[e])
            if L == 0:
                continue
            c = int(self.codewords[e])
            if L <= K:
                # fills all slots whose low L bits == c
                step = 1 << L
                table[c::step] = (e << 6) | L
            else:
                long_codes.setdefault(c & ((1 << K) - 1), []).append(
                    (c, L, e))
        self.fast_table = table
        self.long_codes = long_codes

    # -- scalar decode (host hot path; C extension candidate) -------------
    def decode(self, r: BitReader) -> int:
        """Read one Huffman symbol; raises EndOfPacket at true end."""
        K = self.FAST_BITS
        word = r.look(K)
        t = int(self.fast_table[word])
        if t >= 0:
            L = t & 63
            if r.bits_remaining() < L:
                r.advance(r.bits_remaining() + 1)
                raise EndOfPacket
            r.advance(L)
            return t >> 6
        cands = self.long_codes.get(word & ((1 << K) - 1))
        if cands:
            big = r.look(32)
            for c, L, e in cands:
                if (big & ((1 << L) - 1)) == c:
                    if r.bits_remaining() < L:
                        break
                    r.advance(L)
                    return e
        # no match: invalid/truncated stream
        r.advance(r.bits_remaining() + 1)
        raise EndOfPacket

    def decode_vector(self, r: BitReader) -> np.ndarray:
        e = self.decode(r)
        return self.values[e]

    # -- encode ------------------------------------------------------------
    def encode(self, w: BitWriter, entry: int) -> int:
        L = int(self.lengths[entry])
        w.write(int(self.codewords[entry]), L)
        return L

    def decode_run(self, r: BitReader, count: int):
        """Decode `count` consecutive symbols of THIS book on the Python
        per-symbol path.  Returns (entries, got); got < count means the
        packet ran out (caller raises EndOfPacket after applying what was
        decoded, like the reference's partial-residue behavior and the
        source's native decoder)."""
        out = np.empty(count, np.int64)
        for i in range(count):
            try:
                out[i] = self.decode(r)
            except EndOfPacket:
                return out[:i], i
        return out, count
