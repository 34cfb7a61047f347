"""Torch counterpart of vorbis_tpu/ops/residue_device.py: batched
residue VQ (reference: lib/res0.c local_book_besterror / _encodepart).

The lattice path is elementwise math plus a digit dot product; the miss
fallback is a static remap table (nearest used entry, precomputed on the
host); error feed-forward across stages subtracts the gathered entry
values.  Host setup is line-aligned with the JAX module."""

from __future__ import annotations

import numpy as np
import torch

from ..convert import device_tables

f32 = np.float32


class DeviceLatticeBook:
    """One maptype-1 lattice book prepared for device encode."""

    def __init__(self, book, device):
        from ..codec.residue_codec import _enc_book_fields
        self.device = torch.device(device)
        self.dim = int(book.dim)
        self.entries = int(book.entries)
        minval, delta, qv = _enc_book_fields(book)
        self.minval, self.delta, self.qv = minval, delta, qv
        values = book.values
        assert values is not None
        # entry -> quantized per-dim reconstruction (the p[] the C code
        # subtracts): for lattice entries p = v*delta+minval per digit
        lengths = np.asarray(book.lengths)
        used = lengths > 0
        # static remap: unused lattice index -> nearest used entry
        vals_np = np.asarray(values, np.float64)
        remap = np.arange(self.entries, dtype=np.int64)
        if (~used).any():
            uidx = np.nonzero(used)[0]
            uv = vals_np[uidx]
            for e in np.nonzero(~used)[0]:
                d = ((uv - vals_np[e]) ** 2).sum(-1)
                remap[e] = uidx[int(np.argmin(d))]
        # host copies for the encode step's table builders
        self.values_np = np.asarray(values, np.float32)
        self.remap_np = remap
        vars(self).update(device_tables(dict(
            values=self.values_np,
            remap=remap,
            # the values actually subtracted after remap
            sub_values=vals_np[remap].astype(np.float32),
        ), self.device))

    def encode(self, a):
        """a: (..., dim) float residuals -> (entry (...,) int32,
        remainder (..., dim))."""
        minval, delta, qv = self.minval, self.delta, self.qv
        ze = qv >> 1
        x = a.to(torch.float32)
        if delta != 1:
            # exact trunc division in int32 (the C reference divides in
            # IEEE f32 and truncates; t is integer-valued and delta
            # integral for every lattice book)
            t = (x - float(minval) + float(delta >> 1)).to(torch.int32)
            v = torch.div(t, delta, rounding_mode="trunc")
        else:
            v = (x - float(minval)).to(torch.int32)
        m = torch.where(v < ze, ((ze - v) << 1) - 1, (v - ze) << 1)
        m = torch.clamp(m, 0, qv - 1)
        # index = sum over dims (reversed significance): C builds
        # index = index*qv + digit iterating o = dim-1 .. 0
        idx = torch.zeros(a.shape[:-1], dtype=torch.int32, device=a.device)
        for o in range(self.dim - 1, -1, -1):
            idx = idx * qv + m[..., o]
        entry = self.remap[torch.clamp(idx, 0, self.entries - 1).long()]
        rec = self.sub_values[entry]
        return entry.to(torch.int32), a - rec


class DeviceResidueVQ:
    """Multi-stage partitioned VQ over a flat residue vector
    (res01_forward's encodepart cascade, batched)."""

    def __init__(self, info, books, partbooks, device):
        """info: ResidueInfo; partbooks: [partition][stage] book or
        None (from ResidueLook.partbooks)."""
        self.device = torch.device(device)
        self.info = info
        self.begin, self.end = info.begin, info.end
        self.grouping = info.grouping
        self.partitions = info.partitions
        self.cm1 = np.asarray(info.classmetric1, np.int64)
        self.cm2 = np.asarray(info.classmetric2, np.int64)
        self.stages = max((len(s) for s in partbooks), default=0)
        self.books = [[(DeviceLatticeBook(b, device) if b is not None
                        else None) for b in row] for row in partbooks]

    def classify(self, res):
        """res: (B, n) int residues -> partword (B, parts) int32
        (res01_class, vectorized threshold walk)."""
        spp = self.grouping
        n = self.end - self.begin
        partvals = n // spp
        seg = torch.abs(res[..., self.begin:self.begin + partvals * spp]
                        .reshape(res.shape[:-1] + (partvals, spp)))
        mx = seg.amax(-1)
        scale = float(f32(f32(100.0) / f32(spp)))
        # C: ent = (int)(int_sum * (float)scale), truncating
        ent = (seg.sum(-1).to(torch.float32) * scale).to(torch.int32)
        k = torch.full(mx.shape, self.partitions - 1, dtype=torch.int32,
                       device=res.device)
        # C walks k upward and stops at the first class whose limits
        # hold; emulate by scanning downward and keeping the lowest
        for kk in range(self.partitions - 2, -1, -1):
            ok = (mx <= int(self.cm1[kk])) & (bool(self.cm2[kk] < 0)
                                              | (ent < int(self.cm2[kk])))
            k = torch.where(ok, kk, k)
        return k

    def encode(self, res, partword):
        """res: (B, n) float residuals, partword: (B, parts) ->
        list over stages of entries (B, parts, spp) int32 (-1 where
        the class has no book at that stage) + final remainder."""
        spp = self.grouping
        n = self.end - self.begin
        partvals = n // spp
        work = res[..., self.begin:self.begin + partvals * spp] \
            .to(torch.float32).reshape(res.shape[:-1] + (partvals, spp))
        out_stages = []
        for s in range(self.stages):
            stage_entries = torch.full(work.shape[:-1] + (spp,), -1,
                                       dtype=torch.int32,
                                       device=work.device)
            new_work = work
            for cls in range(self.partitions):
                book = (self.books[cls][s]
                        if s < len(self.books[cls]) else None)
                if book is None:
                    continue
                dim = book.dim
                steps = spp // dim
                a = work.reshape(work.shape[:-1] + (steps, dim))
                ent, rem = book.encode(a)
                rem = rem.reshape(work.shape)
                sel = (partword == cls)
                new_work = torch.where(sel[..., None], rem, new_work)
                ent_full = torch.repeat_interleave(ent, dim, dim=-1)
                stage_entries = torch.where(sel[..., None], ent_full,
                                            stage_entries)
            work = new_work
            out_stages.append(stage_entries)
        return out_stages, work
