"""Torch counterpart of vorbis_tpu/ops/encdevice.py: the on-device
encode step, raw PCM chunk -> packed packets (reference hot loop:
lib/mapping0.c mapping0_forward + lib/floor1.c floor1_encode +
lib/res0.c _01forward + lib/codebook.c vorbis_book_encode + libogg
oggpack_write):

  framing -> window/MDCT/FFT -> psy mask -> floor1 fit (CUDA kernel)
  -> post wrap coding -> floor curve render -> stereo coupling ->
  residue classify + lattice VQ -> codeword lookup -> bit-field
  columns -> LSB-first bit packing

The host receives only (packed packet bytes, bit counts).  The port
covers the stateless step (`make_step`), the frame-gather step
(`make_gather_step`) and the two-phase psy-state steps
(`make_probe_step`, `make_finish_step`, with M6/M9 coupling, the
noise-normalize promotion and, on short blocks, M3).  A single-submap
layout finishes through `finish_from_posts`, which the managed
15-packetblob pass (ops/managed.py) shares; a multi-submap layout (the
5.1 templates) through `_finish_multi`: a floor fit per submap (the
LFE's own look), the chained multi-step coupling (`_couple_multi`) and
a residue block per submap, each stage reading its submap's tables
(`cfg`).

Differences from the JAX module, all exact:
  * bit fields ride int64 (torch has no uint32 shifts/comparisons on
    every backend); values < 2^32 are exact;
  * the one-hot MXU table lookups (a TPU workaround for serial gathers)
    are plain gathers from the same tables;
  * bit packing scatter-adds the byte planes of each (value << off&7)
    onto the (F, wb) packet bytes.  Fields occupy disjoint bit ranges,
    so integer addition equals bitwise OR and the bytes are exact.
Host numpy (PackPlan, the _prepare_* table builders) is copied
line-aligned with the JAX module.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream.bitpack import ilog
from ..convert import device_tables

f32 = np.float32
i32 = torch.int32
i64 = torch.int64


# ---------------------------------------------------------------------------
# static column plan

@dataclass
class PackPlan:
    gidx: np.ndarray        # (C1, Gmax) int32 indices into columns, -1 pad
    n_cols: int             # raw column count C
    wb: int                 # packet byte budget
    worst_bytes: int        # true static worst case

    @staticmethod
    def build(maxbits, wb_cap=768):
        maxbits = np.asarray(maxbits, np.int64)
        C = len(maxbits)
        groups = []
        cur = []
        acc = 0
        for i in range(C):
            mb = int(maxbits[i])
            # 0-width columns are legal (e.g. modebits==0 for a
            # single-mode template, window flags on W=0 packets)
            assert 0 <= mb <= 32, mb
            if acc + mb > 32:
                groups.append(cur)
                cur = []
                acc = 0
            cur.append(i)
            acc += mb
        if cur:
            groups.append(cur)
        gmax = max(len(g) for g in groups)
        gidx = np.full((len(groups), gmax), -1, np.int32)
        for gi, g in enumerate(groups):
            gidx[gi, :len(g)] = g
        worst = (int(maxbits.sum()) + 7) // 8
        return PackPlan(gidx=gidx, n_cols=C,
                        wb=min(worst + 4, wb_cap), worst_bytes=worst + 4)


def merge_columns(vals, lens, gidx):
    """(F, C) columns -> (F, C1) merged columns per the static plan.
    gidx: (C1, Gmax) long tensor, pads pointing at column C."""
    F = vals.shape[0]
    v = torch.cat([vals, vals.new_zeros((F, 1))], 1)
    l = torch.cat([lens, lens.new_zeros((F, 1))], 1)
    vg = v[:, gidx]                     # (F, C1, Gmax) static gather
    lg = l[:, gidx]
    # zero-length columns may carry stale values (masked lookups);
    # they must contribute no bits to the OR-merge
    vg = torch.where(lg > 0, vg, 0)
    acc_v = vg[..., 0]
    acc_l = lg[..., 0]
    for k in range(1, gidx.shape[1]):
        # plan guarantees acc_l <= 32 - maxbits_k < 32 whenever column
        # k can be non-empty, so the shift stays in range
        acc_v = acc_v | (vg[..., k] << torch.clamp_max(acc_l, 31))
        acc_l = acc_l + lg[..., k]
    # uint32 semantics: bits shifted past 32 are dropped
    return acc_v & 0xFFFFFFFF, acc_l


def pack_bits(vals, lens, wb):
    """(F, C1) merged (value, nbits) columns -> (F, wb) packed bytes
    uint8 + (F,) total bit counts int32.  LSB-first like
    oggpack_write; bytes past wb are dropped (the caller redoes an
    oversized packet with the worst-case budget)."""
    F, C1 = vals.shape
    lens = lens.to(i64)
    off = torch.cumsum(lens, dim=1) - lens
    total = off[:, -1] + lens[:, -1]
    width = torch.bitwise_left_shift(torch.ones_like(lens), lens) - 1
    v = torch.where(lens > 0, vals & width, 0)
    base = off >> 3
    shifted = v << (off & 7)                     # <= 39 bits
    out = torch.zeros((F, wb + 1), dtype=i32, device=vals.device)
    for j in range(5):
        # column wb collects every byte past the budget
        idx = torch.clamp_max(base + j, wb)
        out.scatter_add_(1, idx, ((shifted >> (8 * j)) & 0xFF).to(i32))
    return out[:, :wb].to(torch.uint8), total.to(i32)


# ---------------------------------------------------------------------------
# the encoder step

class DeviceFastEncode:
    """PCM -> packets step for the long-block fast path, on fe.device.

    Construction pulls every static table out of a FastEncoder's looks
    (floor neighbours, class/sub books, residue lattice parameters,
    codeword tables) and precomputes the column/merge/pack plan.
    """

    def __init__(self, fe, chunk_packets=1024, W=1):
        self.fe = fe
        self.device = fe.device
        self.ctx = fe.ctx(W) if hasattr(fe, "ctx") else fe
        self.W = W
        self.ch = fe.ch
        # residue-domain channel count: res2 codes ONE interleaved
        # vector over the coupled bundle
        self.res_type = getattr(self.ctx, "res_type", 1)
        self.res_ch = 1 if self.res_type == 2 else fe.ch
        self.n = self.ctx.n
        self.hop = self.n // 2
        self.chunk_packets = chunk_packets
        self.chunk_samples = chunk_packets * self.hop + self.hop
        mapping = getattr(self.ctx, "mapping", None)
        self.multi = mapping is not None and (
            mapping.submaps > 1 or mapping.coupling_steps > 1)
        if self.multi:
            self._prepare_multi(mapping)
        else:
            self._prepare_floor()
            self._prepare_residue()
            self._prepare_columns()
        self._prepare_device()
        self._step_cache = {}

    def _prepare_multi(self, mapping):
        """Multi-submap / multi-step coupling layout (e.g. the 5.1
        templates, reference lib/modes/residue_44p51.h: submap 0 =
        five coupled channels under res2 with four chained coupling
        steps, submap 1 = the LFE under res1).  Builds one
        floor+residue config namespace per submap plus the absolute
        coupling step list."""
        from types import SimpleNamespace

        from .floor_cuda import make_floor_fit
        from .residue_device import DeviceResidueVQ
        fe = self.fe
        vi = fe.vi
        self.mapping = mapping
        self.coupling = [(mapping.coupling_mag[s],
                          mapping.coupling_ang[s])
                         for s in range(mapping.coupling_steps)]
        self.groups = []
        for sm in range(mapping.submaps):
            chans = [c for c in range(self.ch)
                     if mapping.chmuxlist[c] == sm]
            assert chans == list(range(chans[0],
                                       chans[0] + len(chans))), \
                "submap channels must be contiguous"
            g = SimpleNamespace()
            g.channels = chans
            fl_idx = mapping.floorsubmap[sm]
            res_idx = mapping.residuesubmap[sm]
            g.fl_look = fe.enc.floor_looks[fl_idx]
            g.res_look = fe.enc.residue_looks[res_idx]
            g.res_type = vi.residue_types[res_idx]
            g.res_ch = 1 if g.res_type == 2 else len(chans)
            g.dvq = DeviceResidueVQ(g.res_look.info, g.res_look.books,
                                    g.res_look.partbooks, self.device)
            if (getattr(self.ctx, "fl_look", None) is g.fl_look
                    and getattr(self.ctx, "floor", None) is not None):
                g.floor = self.ctx.floor
            else:
                g.floor = make_floor_fit(g.fl_look, self.device)
            self._prepare_floor(look=g.fl_look, tgt=g)
            self._prepare_residue(look=g.res_look, dvq=g.dvq, tgt=g,
                                  res_ch=g.res_ch)
            self.groups.append(g)
        self._prepare_columns_multi()

    def _prepare_columns_multi(self):
        """Packet column plan for the multi-submap layout: header,
        then every channel's floor (its submap's config), then each
        submap's residue block (mapping0_forward emission order)."""
        fe = self.fe
        maxbits = [1, fe.modebits, 1, 1]
        for g in self.groups:
            fl_bits = [1, g.qb, g.qb]
            for p in g.fl_parts:
                if p["csubbits"]:
                    fl_bits.append(int(np.max(p["classbook"].lengths)))
                for k in range(p["cdim"]):
                    ml = max((int(np.max(b.lengths))
                              for b in p["subbooks"] if b is not None),
                             default=1)
                    fl_bits.append(max(ml, 1))
            g.fl_bits = fl_bits
        for c in range(self.ch):
            g = next(g for g in self.groups if c in g.channels)
            maxbits.extend(g.fl_bits)
        for g in self.groups:
            ph_maxlen = int(g.ph_cl.max())
            for s in range(g.stages):
                st = g.stage_tabs[s]
                ms = st["max_steps"]
                pos_ml = np.zeros(ms, np.int64)
                for cc, d in enumerate(g.res_books[s]):
                    if d is None:
                        continue
                    sc = g.spp // d["dim"]
                    ml = int(np.max(np.asarray(
                        g.res_look.partbooks[cc][s].lengths)))
                    pos_ml[:sc] = np.maximum(pos_ml[:sc], ml)
                pos_ml = np.maximum(pos_ml, 1)
                for c0 in range(g.nchunks):
                    if s == 0:
                        maxbits.extend([ph_maxlen] * g.res_ch)
                    for _ in range(g.ppw):
                        for _ in range(g.res_ch):
                            maxbits.extend(pos_ml.tolist())
        self.plan = PackPlan.build(maxbits, wb_cap=2048)

    # -- static preparation ------------------------------------------------
    def _prepare_floor(self, look=None, tgt=None):
        """Extract one floor config's static tables onto tgt (default:
        self — the single-submap fast path)."""
        fe = self.fe
        tgt = tgt if tgt is not None else self
        look = look if look is not None else self.ctx.fl_look
        self = tgt
        info = look.info
        self.fl = look
        self.P = look.posts
        self.quant_q = look.quant_q
        self.qb = ilog(look.quant_q - 1)
        self.lo_static = np.asarray(look.loneighbor, np.int64)
        self.hi_static = np.asarray(look.hineighbor, np.int64)
        self.postlist = np.asarray(info.postlist, np.int64)
        self.mult = info.mult
        # per-partition class metadata + codeword tables
        vb = fe.vi.books
        sb = fe.vi.static_books
        self.fl_parts = []
        for i in range(info.partitions):
            cls = info.partitionclass[i]
            cdim = info.class_dim[cls]
            csubbits = info.class_subs[cls]
            csub = 1 << csubbits
            subs = [info.class_subbook[cls][k] for k in range(csub)]
            maxval = np.asarray(
                [1 if s < 0 else sb[s].entries for s in subs], np.int64)
            cb = vb[info.class_book[cls]] if csubbits else None
            subbooks = [(None if s < 0 else vb[s]) for s in subs]
            self.fl_parts.append(dict(
                cls=cls, cdim=cdim, csubbits=csubbits, csub=csub,
                maxval=maxval, classbook=cb, subbooks=subbooks))

    def _prepare_residue(self, look=None, dvq=None, tgt=None,
                         res_ch=None):
        """Extract one residue config's static tables onto tgt
        (default: self)."""
        fe = self.fe
        tgt = tgt if tgt is not None else self
        look = look if look is not None else self.ctx.res_look
        dvq = dvq if dvq is not None else self.ctx.dvq
        self = tgt
        self.res_look_ = look
        self.dvq_ = dvq
        if res_ch is not None:
            self.res_ch = res_ch
        info = look.info
        self.ri = info
        self.spp = info.grouping
        self.partvals = (info.end - info.begin) // self.spp
        self.ppw = look.dim
        self.nchunks = (self.partvals + self.ppw - 1) // self.ppw
        self.parts_pad = self.nchunks * self.ppw
        self.possible = info.partitions
        self.stages = look.stages
        self.sec = np.asarray(info.secondstages, np.int64)
        self.phrasebook = look.phrasebook
        # per (stage, class): lattice params (books are exact zigzag
        # lattices: value(m) = delta * zz(m), verified at init)
        self.res_books = []          # [stage][class] dict or None
        for s in range(self.stages):
            row = []
            for c in range(self.possible):
                b = (dvq.books[c][s]
                     if s < len(dvq.books[c]) else None)
                if b is None or not (self.sec[c] >> s) & 1:
                    row.append(None)
                    continue
                vals_np = np.asarray(b.values_np, np.float64)
                qv, dim, E = b.qv, b.dim, b.entries
                assert qv ** dim == E, "expected a full lattice"
                # verify zigzag-separable values
                ok = True
                for k in range(dim):
                    vmap = vals_np[(np.arange(qv) * qv ** k), k]
                    zz = np.where(np.arange(qv) % 2,
                                  -((np.arange(qv) + 1) // 2),
                                  np.arange(qv) // 2)
                    if not np.array_equal(vmap, b.delta * zz):
                        ok = False
                    dig = (np.arange(E) // qv ** k) % qv
                    if not np.array_equal(vals_np[:, k], vmap[dig]):
                        ok = False
                assert ok, f"non-lattice residue book c{c} s{s}"
                # the exact-int32 trunc division in _vq_stages needs
                # integral lattice params
                assert float(b.delta).is_integer(), b.delta
                assert float(b.minval).is_integer(), b.minval
                remap = np.asarray(b.remap_np)
                ident = bool(np.all(remap == np.arange(E)))
                rdig = None
                if not ident:
                    rdig = np.stack(
                        [((remap // qv ** k) % qv) for k in range(dim)],
                        1).astype(np.int8)
                row.append(dict(book=b, qv=qv, dim=dim, entries=E,
                                minval=b.minval, delta=b.delta,
                                ident=ident, remap_digits=rdig))
            self.res_books.append(row)
        # per-stage codeword tables: per-class (cw, cl) pairs for the
        # width-grouped lookup plus the stacked padded form
        self.stage_tabs = []
        for s in range(self.stages):
            maxent = max((d["entries"] for d in self.res_books[s]
                          if d is not None), default=1)
            cw = np.zeros((self.possible, maxent), np.uint32)
            cl = np.zeros((self.possible, maxent), np.int32)
            steps = np.ones(self.possible, np.int64)
            cls_books = []
            for c, d in enumerate(self.res_books[s]):
                if d is None:
                    cls_books.append(None)
                    continue
                bk = look.partbooks[c][s]
                bcw = np.asarray(bk.codewords, np.uint64) \
                    .astype(np.uint32)
                bcl = np.asarray(bk.lengths, np.int32)
                cls_books.append((bcw, bcl))
                cw[c, :d["entries"]] = bcw
                cl[c, :d["entries"]] = bcl
                steps[c] = self.spp // d["dim"]
            max_steps = int(steps[[d is not None
                                   for d in self.res_books[s]]].max()
                            if any(d is not None
                                   for d in self.res_books[s]) else 1)
            self.stage_tabs.append(dict(
                cw=cw, cl=cl, steps=steps, max_steps=max_steps,
                maxent=maxent, cls_books=cls_books,
                maxlen=[int(cl[:, :].max())]))
        # phrase codewords
        ph = self.phrasebook
        self.ph_cw = np.asarray(ph.codewords, np.uint64) \
            .astype(np.uint32)
        self.ph_cl = np.asarray(ph.lengths, np.int32)

    def _prepare_columns(self):
        """Static per-column worst-case widths, in exact packet
        emission order (must mirror _assemble_columns)."""
        fe = self.fe
        maxbits = [1, fe.modebits, 1, 1]
        # floor per channel
        fl_bits = [1, self.qb, self.qb]
        for p in self.fl_parts:
            if p["csubbits"]:
                fl_bits.append(int(np.max(p["classbook"].lengths)))
            for k in range(p["cdim"]):
                ml = max((int(np.max(b.lengths))
                          for b in p["subbooks"] if b is not None),
                         default=1)
                fl_bits.append(max(ml, 1))
        for _ in range(self.ch):
            maxbits.extend(fl_bits)
        self.fl_ncols = len(fl_bits)
        # residue stages
        ph_maxlen = int(self.ph_cl.max())
        self.res_ncols = []
        for s in range(self.stages):
            st = self.stage_tabs[s]
            ms = st["max_steps"]
            # per step position: max codeword length over classes
            # whose stage-s book still has that step
            pos_ml = np.zeros(ms, np.int64)
            for c, d in enumerate(self.res_books[s]):
                if d is None:
                    continue
                sc = self.spp // d["dim"]
                ml = int(np.max(np.asarray(
                    self.ctx.res_look.partbooks[c][s].lengths)))
                pos_ml[:sc] = np.maximum(pos_ml[:sc], ml)
            pos_ml = np.maximum(pos_ml, 1)
            ncols = 0
            for c0 in range(self.nchunks):
                if s == 0:
                    maxbits.extend([ph_maxlen] * self.res_ch)
                    ncols += self.res_ch
                for _ in range(self.ppw):
                    for _ in range(self.res_ch):
                        maxbits.extend(pos_ml.tolist())
                        ncols += ms
            self.res_ncols.append(ncols)
        self.plan = PackPlan.build(maxbits)

    def _prepare_device(self):
        """Every table the device stages read, through device_tables:
        each floor+residue config's (self, or each submap's), then the
        shared ones."""
        dev = self.device
        for cfg in (self.groups if self.multi else [self]):
            self._prepare_config_device(cfg)
        gidx = np.where(self.plan.gidx < 0, self.plan.n_cols,
                        self.plan.gidx).astype(np.int64)
        tabs = dict(gidx=gidx,
                    hdr_l=np.array([1, self.fe.modebits,
                                    1 if self.W else 0,
                                    1 if self.W else 0], np.int32))
        n2 = self.n // 2
        bins = np.arange(n2)
        nm = getattr(self.ctx, "normal", None)
        if nm is not None:
            # noise-normalize promotion region (coupled: above the
            # point limit too)
            inreg = bins >= nm["start"]
            # the region's start alone: the managed pass ands in its
            # per-blob point limits (inlimit), and a multi-submap
            # layout's uncoupled submap promotes from there
            tabs["nm_start"] = inreg.copy()
            if self.res_type == 2:
                inreg &= bins >= self.ctx.couple["limit"]
            tabs["nm_inreg"] = inreg
        if self.res_type == 2:
            cp = self.ctx.couple
            # M6 runs on the partitions that start below tonefix_end
            part = cp["partition"]
            npt = (n2 + part - 1) // part
            tabs["m6_gate"] = np.arange(npt) * part < int(
                cp.get("tonefix_end", 0))
            tabs["thr1"] = np.asarray(cp["thr1"], np.float32)
            tabs["thr2"] = np.asarray(cp["thr2"], np.float32)
            tabs["threv"] = np.asarray(cp["threv"], np.float32)
            if self.multi:
                # the chained coupling's intermediate steps fold with a
                # .04 high ratio (psy.c; the last step keeps .12)
                tabs["threv04"] = np.where(
                    bins < cp["limit"], np.float32(0.18),
                    np.float32(0.04)).astype(np.float32)
        vars(self).update({f"{k}_t": v for k, v in
                           device_tables(tabs, dev).items()})

    def _prepare_config_device(self, cfg):
        """One floor+residue config's tables (cfg: self or a submap's
        namespace), onto cfg."""
        dev = self.device
        for p in cfg.fl_parts:
            tabs = dict(maxval=p["maxval"].astype(np.int32))
            if p["csubbits"]:
                cb = p["classbook"]
                tabs["cb_cw"] = np.asarray(cb.codewords, np.uint64) \
                    .astype(np.uint32)
                tabs["cb_cl"] = np.asarray(cb.lengths, np.int32)
            for l, bk in enumerate(p["subbooks"]):
                if bk is None:
                    continue
                tabs[f"sub_cw{l}"] = np.asarray(bk.codewords, np.uint64) \
                    .astype(np.uint32)
                tabs[f"sub_cl{l}"] = np.asarray(bk.lengths, np.int32)
            p["t"] = device_tables(tabs, dev)
        for s, st in enumerate(cfg.stage_tabs):
            st["t"] = device_tables(dict(
                cw=st["cw"], cl=st["cl"],
                steps=st["steps"].astype(np.int32)), dev)
            for d in cfg.res_books[s]:
                if d is not None and not d["ident"]:
                    d["rd_t"] = device_tables(
                        {"rd": d["remap_digits"].astype(np.int32)},
                        dev)["rd"]
        vars(cfg).update({f"{k}_t": v for k, v in device_tables(dict(
            sec=cfg.sec.astype(np.int32), ph_cw=cfg.ph_cw,
            ph_cl=cfg.ph_cl), dev).items()})

    # -- device stages -------------------------------------------------------
    def _floor_wrap(self, posts, cfg=None):
        """Raw fit posts (B, P) -> (codes (B, P), qposts (B, P)) — the
        floor1_encode quantization + predictive wrap coding
        (floor1.c:774-935), vectorized over frames.  cfg: the floor
        config (default self; a submap's in a multi-submap layout), as
        for every stage below."""
        cfg = cfg if cfg is not None else self
        P = cfg.P
        post = posts.to(i32)
        val = post & 0x7FFF
        m = cfg.mult
        val = (val >> 2 if m == 1 else val >> 3 if m == 2
               else torch.div(val, 12, rounding_mode="floor") if m == 3
               else val >> 4)
        post = val | (post & 0x8000)
        outs = [post[:, 0] & 0x7FFF, post[:, 1] & 0x7FFF]
        cols = [post[:, i] for i in range(P)]
        qq = cfg.quant_q
        for i in range(2, P):
            ln = int(cfg.lo_static[i - 2])
            hn = int(cfg.hi_static[i - 2])
            y0 = cols[ln] & 0x7FFF
            y1 = cols[hn] & 0x7FFF
            dy = y1 - y0
            adx = int(cfg.postlist[hn] - cfg.postlist[ln])
            err = torch.abs(dy) * int(cfg.postlist[i]
                                      - cfg.postlist[ln])
            offp = torch.div(err, adx, rounding_mode="floor")
            predicted = torch.where(dy < 0, y0 - offp, y0 + offp)
            flag = ((cols[i] & 0x8000) != 0) | (predicted == cols[i])
            headroom = torch.minimum(qq - predicted, predicted)
            v = cols[i] - predicted
            vneg = torch.where(v < -headroom, headroom - v - 1,
                               -1 - (v << 1))
            vpos = torch.where(v >= headroom, v + headroom, v << 1)
            code = torch.where(v < 0, vneg, vpos)
            outs.append(torch.where(flag, 0, code))
            cols[i] = torch.where(flag, predicted | 0x8000, cols[i])
            unflag = ~flag
            cols[ln] = torch.where(unflag, cols[ln] & 0x7FFF, cols[ln])
            cols[hn] = torch.where(unflag, cols[hn] & 0x7FFF, cols[hn])
        return torch.stack(outs, 1), torch.stack(cols, 1)

    def _floor_fields(self, codes, used, cfg=None):
        """codes (B, P) + used (B,) -> (vals (B, FC) int64,
        lens (B, FC) int32) for one batch of channels."""
        cfg = cfg if cfg is not None else self
        B = codes.shape[0]
        dev = codes.device
        vals = [used.to(i64)]
        lens = [torch.ones((B,), dtype=i32, device=dev)]
        qbl = torch.where(used, cfg.qb, 0).to(i32)
        vals += [codes[:, 0].to(i64), codes[:, 1].to(i64)]
        lens += [qbl, qbl]
        j = 2
        for p in cfg.fl_parts:
            t = p["t"]
            cdim = p["cdim"]
            seg = codes[:, j:j + cdim]                 # (B, cdim)
            cond = seg[:, :, None] < t["maxval"][None, None, :]
            anyc = cond.any(-1)
            # first sub-book whose range holds the code
            bookas = torch.where(anyc, cond.to(torch.uint8).argmax(-1), 0)
            if p["csubbits"]:
                shifts = torch.arange(cdim, device=dev) * p["csubbits"]
                cval = (bookas << shifts[None, :]).sum(-1)
                vals.append(t["cb_cw"][cval])
                lens.append(torch.where(used, t["cb_cl"][cval], 0))
            for k in range(cdim):
                v_k = torch.zeros((B,), dtype=i64, device=dev)
                l_k = torch.zeros((B,), dtype=i32, device=dev)
                ok = torch.zeros((B,), dtype=torch.bool, device=dev)
                for l, bk in enumerate(p["subbooks"]):
                    if bk is None:
                        continue
                    idx = torch.clamp(seg[:, k], 0, bk.entries - 1).long()
                    sel = (bookas[:, k] == l) & (seg[:, k] < bk.entries)
                    v_k = torch.where(sel, t[f"sub_cw{l}"][idx], v_k)
                    l_k = torch.where(sel, t[f"sub_cl{l}"][idx], l_k)
                    ok = ok | sel
                vals.append(v_k)
                lens.append(torch.where(ok & used, l_k, 0))
            j += cdim
        return torch.stack(vals, 1), torch.stack(lens, 1)

    def _pad_to(self, x, need):
        if need > x.shape[-1]:
            x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
        return x

    def _classify(self, res, cfg=None):
        """res (B, n) float (already rint'ed) -> partword
        (B, partvals) int32 (res01_class)."""
        cfg = cfg if cfg is not None else self
        ri = cfg.ri
        spp = cfg.spp
        need = ri.begin + cfg.partvals * spp
        res = self._pad_to(res, need)
        seg = torch.abs(res[..., ri.begin:need].to(i32)) \
            .reshape(res.shape[:-1] + (cfg.partvals, spp))
        mx = seg.amax(-1)
        scale = float(f32(f32(100.0) / f32(spp)))
        ent = (seg.sum(-1, dtype=i32).to(torch.float32) * scale).to(i32)
        cm1 = np.asarray(ri.classmetric1, np.int64)
        cm2 = np.asarray(ri.classmetric2, np.int64)
        k = torch.full(mx.shape, cfg.possible - 1, dtype=i32,
                       device=res.device)
        for kk in range(cfg.possible - 2, -1, -1):
            okk = mx <= int(cm1[kk])
            if cm2[kk] >= 0:
                okk = okk & (ent < int(cm2[kk]))
            k = torch.where(okk, kk, k)
        return k

    def _vq_stages(self, res, pw, cfg=None):
        """res (B, n) float residuals, pw (B, partvals) -> per stage
        entries (B, partvals, max_steps) int32 (-1 where inactive).
        Pure elementwise zigzag-lattice math (res0.c _encodepart with
        the lattice fast path; value reconstruction is delta*zz(m))."""
        cfg = cfg if cfg is not None else self
        spp = cfg.spp
        need = cfg.ri.begin + cfg.partvals * spp
        res = self._pad_to(res, need)
        work = res[..., cfg.ri.begin:need].to(torch.float32) \
            .reshape(res.shape[:-1] + (cfg.partvals, spp))
        dev = res.device
        out = []
        for s in range(cfg.stages):
            st = cfg.stage_tabs[s]
            ents = torch.full(work.shape[:-1] + (st["max_steps"],), -1,
                              dtype=i32, device=dev)
            new_work = work
            dims = sorted({d["dim"] for d in cfg.res_books[s]
                           if d is not None})
            for dim in dims:
                steps = spp // dim
                a = work.reshape(work.shape[:-1] + (steps, dim))
                classes = [c for c, d in enumerate(cfg.res_books[s])
                           if d is not None and d["dim"] == dim]
                # per-partition scalar params via where-ladder
                mvv = torch.zeros(pw.shape, dtype=torch.float32, device=dev)
                dl = torch.ones(pw.shape, dtype=torch.float32, device=dev)
                addv = torch.zeros(pw.shape, dtype=torch.float32,
                                   device=dev)
                qvv = torch.ones(pw.shape, dtype=i32, device=dev)
                act = torch.zeros(pw.shape, dtype=torch.bool, device=dev)
                for c in classes:
                    d = cfg.res_books[s][c]
                    selc = pw == c
                    mvv = torch.where(selc, float(d["minval"]), mvv)
                    dl = torch.where(selc, float(d["delta"]), dl)
                    # C: +(delta>>1) before the divide, but only for
                    # delta != 1 (res0.c local_book_besterror)
                    addf = float(d["delta"] >> 1) if d["delta"] != 1 \
                        else 0.0
                    addv = torch.where(selc, addf, addv)
                    qvv = torch.where(selc, d["qv"], qvv)
                    act = act | selc
                mv4 = mvv[..., None, None]
                dl4 = dl[..., None, None]
                qv4 = qvv[..., None, None]
                ze4 = qv4 >> 1
                t = a - mv4 + addv[..., None, None]
                # exact int32 trunc division (C: IEEE f32 divide +
                # truncate; every delta is integral and t integer-valued)
                ti = t.to(i32)
                di = dl4.to(i32)
                v = torch.div(ti, di, rounding_mode="trunc")
                m = torch.where(v < ze4, ((ze4 - v) << 1) - 1,
                                (v - ze4) << 1)
                m = torch.minimum(torch.clamp_min(m, 0), qv4 - 1)
                # entry index: digit o has significance qv^o
                idx = torch.zeros(a.shape[:-1], dtype=i32, device=dev)
                for o in range(dim - 1, -1, -1):
                    idx = idx * qv4[..., 0] + m[..., o]
                mdig = m
                # non-identity remaps (unused lattice entries)
                for c in classes:
                    d = cfg.res_books[s][c]
                    if d["ident"]:
                        continue
                    rd = d["rd_t"][torch.clamp(idx, 0, d["entries"] - 1)
                                   .long()]
                    selc = (pw == c)[..., None, None]
                    mdig = torch.where(selc, rd, mdig)
                    idx2 = torch.zeros(a.shape[:-1], dtype=i32, device=dev)
                    for o in range(dim - 1, -1, -1):
                        idx2 = idx2 * d["qv"] + rd[..., o]
                    idx = torch.where(selc[..., 0], idx2, idx)
                zz = torch.where((mdig & 1) == 1, -((mdig + 1) >> 1),
                                 mdig >> 1)
                rec = dl4 * zz.to(torch.float32)
                sel = act[..., None]
                rem = (a - rec).reshape(work.shape)
                new_work = torch.where(sel, rem, new_work)
                ents[..., :steps] = torch.where(sel, idx,
                                                ents[..., :steps])
            work = new_work
            out.append(ents)
        return out

    def _residue_fields(self, pw, entries, used, cfg=None):
        """pw (F, ch, partvals), entries per stage
        (F, ch, partvals, max_steps), used (F, ch) -> (vals, lens)
        (F, RC) in res01_forward emission order."""
        cfg = cfg if cfg is not None else self
        F = pw.shape[0]
        ch = cfg.res_ch
        ppw = cfg.ppw
        nck = cfg.nchunks
        dev = pw.device
        pwl = pw.long()
        vals_blocks = []
        lens_blocks = []
        padn = cfg.parts_pad - cfg.partvals
        pwp = torch.nn.functional.pad(pw, (0, padn)) if padn else pw
        for s in range(cfg.stages):
            st = cfg.stage_tabs[s]
            t = st["t"]
            ms = st["max_steps"]
            e = entries[s]
            ent_act = e >= 0
            act = (((cfg.sec_t[pwl] >> s) & 1) == 1) & used[..., None]
            nsteps = t["steps"][pwl]                   # (F, ch, parts)
            krange = torch.arange(ms, dtype=i32, device=dev)
            inr = (krange < nsteps[..., None]) & act[..., None] & ent_act
            # codeword lookup: a plain gather from the stacked
            # (class, entry) tables
            e_in = torch.where(inr, e, 0).long()
            ev = t["cw"][pwl[..., None], e_in]
            el = torch.where(inr, t["cl"][pwl[..., None], e_in], 0)
            # pad partitions to nchunks*ppw
            if padn:
                ev = torch.nn.functional.pad(ev, (0, 0, 0, padn))
                el = torch.nn.functional.pad(el, (0, 0, 0, padn))
            # (F, ch, nck, ppw, ms) -> (F, nck, ppw, ch, ms)
            ev = ev.reshape(F, ch, nck, ppw, ms).permute(0, 2, 3, 1, 4)
            el = el.reshape(F, ch, nck, ppw, ms).permute(0, 2, 3, 1, 4)
            if s == 0:
                # phrase words: digit-pack ppw partwords, MSB first
                ph_v = torch.zeros((F, ch, nck), dtype=i32, device=dev)
                for k in range(ppw):
                    ph_v = ph_v * cfg.possible \
                        + pwp[..., k::ppw][..., :nck]
                ph_ok = (ph_v < cfg.phrasebook.entries) \
                    & used[..., None]
                ph_idx = torch.where(ph_ok, ph_v, 0).long()
                ph_cw = cfg.ph_cw_t[ph_idx]
                ph_cl = torch.where(ph_ok, cfg.ph_cl_t[ph_idx], 0)
                # (F, ch, nck) -> (F, nck, ch)
                blk_v = torch.cat([ph_cw.permute(0, 2, 1),
                                   ev.reshape(F, nck, ppw * ch * ms)], -1)
                blk_l = torch.cat([ph_cl.permute(0, 2, 1),
                                   el.reshape(F, nck, ppw * ch * ms)], -1)
            else:
                blk_v = ev.reshape(F, nck, ppw * ch * ms)
                blk_l = el.reshape(F, nck, ppw * ch * ms)
            vals_blocks.append(blk_v.reshape(F, -1))
            lens_blocks.append(blk_l.reshape(F, -1))
        return torch.cat(vals_blocks, 1), torch.cat(lens_blocks, 1)

    # -- channel coupling (res2 / coupled stereo) ---------------------------
    def _classify2(self, absM, absA, nch=2, cfg=None):
        """res2 classification (_2class, res0.c:473): per interleaved
        partition, the magnitude channel's max and the angle channels'
        max walk the classmetric thresholds.  absM: (F, n2) channel-0
        abs ints; absA: (F, n2) the elementwise max over the other
        channels."""
        cfg = cfg if cfg is not None else self
        ri = cfg.ri
        spp = cfg.spp
        per = spp // nch
        b0 = ri.begin // nch
        need = b0 + cfg.partvals * per

        def seg(x):
            x = self._pad_to(x, need)
            return x[..., b0:need].reshape(
                x.shape[:-1] + (cfg.partvals, per))
        magmax = seg(absM).amax(-1)
        angmax = seg(absA).amax(-1)
        cm1 = np.asarray(ri.classmetric1, np.int64)
        cm2 = np.asarray(ri.classmetric2, np.int64)
        k = torch.full(magmax.shape, cfg.possible - 1, dtype=i32,
                       device=absM.device)
        for kk in range(cfg.possible - 2, -1, -1):
            ok = (magmax <= int(cm1[kk])) & (angmax <= int(cm2[kk]))
            k = torch.where(ok, kk, k)
        return k

    def _m6_promote(self, rM, rA, reM, reA, flagm1, F, prae=0.34,
                    couple=None):
        """aoTuV M6 dynamic lossless promotion (psy.c:5007-5047), one
        coupling step: per partition below tonefix_end, count
        sign-opposed vs parallel active bins and the mean |res|
        imbalance; an EMA of the imbalance across partitions (the
        side_resdef carry) promotes flag==-1 bins to lossless when the
        imbalance exceeds 1 or the opposed fraction exceeds prae (0.34
        single-step, 0.825 multi-step); couple: the coupling parameter
        dict (default the ctx's).
        The JAX side carries the EMA through a lax.scan whose carry is
        only the previous partition's temp_def (or -1 when that
        partition is off), so here it is one shifted where with the
        same float operations.  rM/rA: the pair's residue values
        (F, n2); reM/reA the signed raw energies; flagm1: (F, n2) bins
        flagged -1 on either channel.  Returns promoted (F, n2)."""
        cp = couple if couple is not None else self.ctx.couple
        tfe = int(cp.get("tonefix_end", 0))
        n2 = rM.shape[-1]
        if tfe <= 0:
            return torch.zeros((F, n2), dtype=torch.bool, device=rM.device)
        part = cp["partition"]
        npt = (n2 + part - 1) // part
        padn = npt * part - n2
        gate = (self.m6_gate_t[:npt] if cp is self.ctx.couple
                else torch.from_numpy(np.arange(npt) * part < tfe).to(
                    rM.device))

        def p4(a):
            return torch.nn.functional.pad(a, (0, padn)) if padn else a
        active = (torch.abs(rM) >= 0.5) | (torch.abs(rA) >= 0.5)
        opposed = ((reM > 0) & (reA < 0)) | ((reA > 0) & (reM < 0))
        imb = torch.abs(torch.abs(rM) - torch.abs(rA))
        act_p = p4(active.to(torch.float32)).reshape(F, npt, part)
        opp_p = p4((active & opposed).to(torch.float32)) \
            .reshape(F, npt, part)
        imb_p = p4(torch.where(active, imb, 0.0)).reshape(F, npt, part)
        ap = act_p.sum(-1)
        rp = opp_p.sum(-1)
        rdsum = imb_p.sum(-1)
        temp_def = rdsum / torch.clamp_min(ap, 1.0)
        nz = (ap > 0) & gate
        carry = torch.nn.functional.pad(
            torch.where(nz, temp_def, -1.0)[:, :-1], (1, 0), value=-1.0)
        rdef = torch.where(carry > 0, temp_def * 0.5 + carry * 0.5,
                           temp_def)
        rdef = torch.where(nz, rdef, 0.0)
        c1 = nz & (rdef > 1.0)
        c2 = nz & (rp / torch.clamp_min(ap, 1.0) >= float(f32(prae)))
        c1b = torch.repeat_interleave(c1, part, dim=-1)[:, :n2]
        c2b = torch.repeat_interleave(c2, part, dim=-1)[:, :n2]
        return flagm1 & (c1b | (c2b & opposed))

    def _couple_quantize(self, md, curve, used, F, thr1=None,
                         threv=None, inlimit=None, epeak=None,
                         npeak=None):
        """Stereo channel coupling + quantization (reference:
        _vp_couple_quantize_normalize, psy.c:4858-5142): per-bin
        lossless flags from the stereo point thresholds, integer
        mag/ang lossless transform, min_indemnity_dipole_hypot point
        fold with energy requantization, and (at rungs where
        normal_thresh enables it) the noise-normalize promotion.
        epeak (F*2, n2) / npeak (F*2, nparts): the psy-state path's M9
        peak store (lowers the lossless threshold, feeds the M6
        promotion) and M8 partition store (gates the promotion
        budget).  md/curve: (F*2, n2); returns integer-valued
        (F, 2, n2) float32 residues.

        thr1/threv/inlimit may override the single-blob static
        threshold profiles with per-frame (F, n2) rows -- the managed
        15-packetblob pass varies prepoint/postpoint/pointlimit per
        blob (psy.c blob loop, mapping0.c:1204-1313)."""
        cp = self.ctx.couple
        n2 = md.shape[-1]
        mdc = md.reshape(F, 2, n2)
        us = used.reshape(F, 2)
        cur = curve.reshape(F, 2, n2)
        cur = torch.where(us[..., None], cur, float(f32(1e-10)))
        res = torch.where(us[..., None], mdc / cur, 0.0)
        if thr1 is None:
            thr1 = self.thr1_t[:n2]
        r = torch.abs(res)
        if epeak is not None:
            # M9: the stored post-echo peaks lower the lossless
            # threshold per bin (flag_lossless's point1 -= enpeak,
            # clamped at prepoint)
            prep = float(f32(cp["prepoint"]))
            ep = epeak.reshape(F, 2, n2)
            thrM = torch.clamp_min(thr1 - ep[:, 0], prep)
            thrA = torch.clamp_min(thr1 - ep[:, 1], prep)
        else:
            thrM = thrA = thr1
        f1M = r[:, 0] >= thrM
        f1A = r[:, 1] >= thrA
        lossless = f1M | f1A
        if epeak is not None and int(cp.get("tonefix_end", 0)) > 0:
            # flag -1 (point2 threshold) feeds the M6 promotion
            thr2 = self.thr2_t[:n2]
            flagm1 = ((~f1M) & (r[:, 0] >= thr2)) \
                | ((~f1A) & (r[:, 1] >= thr2))
            rawM = torch.where(mdc[:, 0] < 0, -(mdc[:, 0] * mdc[:, 0]),
                               mdc[:, 0] * mdc[:, 0])
            rawA = torch.where(mdc[:, 1] < 0, -(mdc[:, 1] * mdc[:, 1]),
                               mdc[:, 1] * mdc[:, 1])
            promoted = self._m6_promote(res[:, 0], res[:, 1], rawM,
                                        rawA, flagm1 & ~lossless, F)
            lossless = lossless | promoted
        qi = torch.round(res)
        qiM, qiA = qi[:, 0], qi[:, 1]
        # integer lossless mag/ang (psy.c lossless_coupling)
        c1 = torch.abs(qiM) > torch.abs(qiA)
        mag = torch.where(c1, qiM, qiA)
        ang = torch.where(c1,
                          torch.where(qiM > 0, qiM - qiA, qiA - qiM),
                          torch.where(qiA > 0, qiM - qiA, qiA - qiM))
        flip = ang >= torch.abs(mag) * 2
        mag = torch.where(flip, -mag, mag)
        ang = torch.where(flip, -ang, ang)
        # point-stereo fold on the signed energy domain
        thnor = float(f32(0.94))
        mm = torch.where(us[:, 0, None], mdc[:, 0], 0.0)
        ma = torch.where(us[:, 1, None], mdc[:, 1], 0.0)
        rawM = torch.where(mm < 0, -(mm * mm), mm * mm)
        rawA = torch.where(ma < 0, -(ma * ma), ma * ma)
        if threv is None:
            threv = self.threv_t[:n2]
        a2 = torch.abs(rawM * thnor)
        b2 = torch.abs(rawA * thnor)
        hyp = torch.where(
            rawM > 0,
            torch.where(rawA > 0, a2 + b2,
                        torch.where(mm > -ma, a2 - b2 * threv,
                                    -(b2 - a2 * threv))),
            torch.where(rawA < 0, -(a2 + b2),
                        torch.where(-mm > ma, -(a2 - b2 * threv),
                                    b2 - a2 * threv)))
        floorsum = cur[:, 0] * cur[:, 0] + cur[:, 1] * cur[:, 1]
        ve = torch.abs(hyp) / floorsum
        mag_pt = torch.round(torch.sqrt(ve))
        mag_pt = torch.where(hyp < 0, -mag_pt, mag_pt)
        outM = torch.where(lossless, mag, mag_pt)
        outA = torch.where(lossless, ang, 0.0)
        any_used = us[:, 0] | us[:, 1]
        nm = getattr(self.ctx, "normal", None)
        if nm is not None and nm["thresh"] < 9000.0:
            inreg = (self.nm_inreg_t[:n2] if inlimit is None
                     else self.nm_start_t[:n2] & inlimit)
            cand = (~lossless) & (ve < float(f32(0.25))) & inreg \
                & any_used[:, None]
            npk_m = None
            if npeak is not None:
                # point-coupled partitions take the pairwise npeak
                # merge (negative wins)
                npk2 = npeak.reshape(F, 2, -1)
                neg = (npk2[:, 0] < -0.5) | (npk2[:, 1] < -0.5)
                npk_m = torch.where(neg, -1.0,
                                    torch.minimum(npk2[:, 0], npk2[:, 1]))
            outM = self._normalize_promote(outM, ve, torch.abs(hyp),
                                           cand, hyp, npeak=npk_m)
        outM = torch.where(any_used[:, None], outM, 0.0)
        outA = torch.where(any_used[:, None], outA, 0.0)
        return torch.stack([outM, outA], 1), any_used

    def _couple_multi(self, md_g, curve_g, used_g, F, epeak=None,
                      npeak=None):
        """General multi-step channel coupling for the coupled submap
        (reference: the coupling_steps loop of
        _vp_couple_quantize_normalize, psy.c:4858-5142 — e.g. the 5.1
        templates couple five channels through FOUR chained steps:
        (0,2) (3,4) (0,1) (0,3), so later steps read the folded
        outputs of earlier ones).  md_g/curve_g: (F, C, n2); used_g:
        (F, C); epeak (F, C, n2) / npeak (F, C, nparts) as in
        _couple_quantize.  Each channel's state is an (F, n2) tensor
        in a list, updated step by step in the JAX module's order of
        operations.  Returns (out (F, C, n2) integer-valued float32,
        used_out (F, C))."""
        cp = self.ctx.couple
        nsteps = len(self.coupling)
        prae = 0.34 if nsteps == 1 else 0.825
        n2 = md_g.shape[-1]
        C = md_g.shape[1]
        us = used_g
        cur = torch.where(us[..., None], curve_g, float(f32(1e-10)))
        res = torch.where(us[..., None], md_g / cur, 0.0)
        r = torch.abs(res)
        thr1 = self.thr1_t[:n2]
        thr2 = self.thr2_t[:n2]
        if epeak is not None:
            # M9: the stored post-echo peaks lower the lossless threshold
            thr1 = torch.clamp_min(thr1 - epeak, float(f32(cp["prepoint"])))
        tfe = int(cp.get("tonefix_end", 0))
        nm = getattr(self.ctx, "normal", None)
        promote_on = nm is not None and nm["thresh"] < 9000.0

        # per-channel mutable state (lists of (F, n2) tensors)
        f1 = [r[:, c] >= (thr1[:, c] if epeak is not None else thr1)
              for c in range(C)]
        fm1 = [(~f1[c]) & (r[:, c] >= thr2) for c in range(C)]
        out = [torch.round(res[:, c]) for c in range(C)]
        raw0 = torch.where(md_g < 0, -(md_g * md_g), md_g * md_g)
        raw0 = torch.where(us[..., None], raw0, 0.0)
        re_ = [raw0[:, c] for c in range(C)]
        fl_e = [cur[:, c] * cur[:, c] for c in range(C)]
        rs = [res[:, c] for c in range(C)]
        usc = [us[:, c] for c in range(C)]
        npk = ([npeak[:, c] for c in range(C)] if npeak is not None
               else None)
        thnor = float(f32(0.94))

        for si, (Mi, Ai) in enumerate(self.coupling):
            pair_used = usc[Mi] | usc[Ai]
            pu = pair_used[:, None]
            # M6 on the CURRENT residues/energies of the pair
            if tfe > 0:
                flagm1 = (fm1[Mi] | fm1[Ai]) & ~(f1[Mi] | f1[Ai])
                promoted = self._m6_promote(rs[Mi], rs[Ai], re_[Mi],
                                            re_[Ai], flagm1, F,
                                            prae=prae, couple=cp)
            else:
                promoted = torch.zeros((F, n2), dtype=torch.bool,
                                       device=md_g.device)
            lossless = (f1[Mi] | f1[Ai] | promoted) & pu
            point = (~lossless) & pu
            # point fold thresholds (psy.c: steps==1 or step==3 keep
            # the .12 high ratio, intermediate steps use .04)
            threv = (self.threv_t if (nsteps == 1 or si == 3)
                     else self.threv04_t)[:n2]
            rM, rA = re_[Mi], re_[Ai]
            a2 = torch.abs(rM * thnor)
            b2 = torch.abs(rA * thnor)
            hyp = torch.where(
                rM > 0,
                torch.where(rA > 0, a2 + b2,
                            torch.where(rM > -rA, a2 - b2 * threv,
                                        -(b2 - a2 * threv))),
                torch.where(rA < 0, -(a2 + b2),
                            torch.where(-rM > rA, -(a2 - b2 * threv),
                                        b2 - a2 * threv)))
            floorsum = fl_e[Mi] + fl_e[Ai]
            ve = torch.abs(hyp) / floorsum
            sq = torch.sqrt(ve)
            mag_pt = torch.where(hyp < 0, -torch.round(sq), torch.round(sq))
            # lossless integer mag/ang transform on the current ints
            qiM, qiA = out[Mi], out[Ai]
            c1 = torch.abs(qiM) > torch.abs(qiA)
            magi = torch.where(c1, qiM, qiA)
            angi = torch.where(c1,
                               torch.where(qiM > 0, qiM - qiA, qiA - qiM),
                               torch.where(qiA > 0, qiM - qiA, qiA - qiM))
            flip = angi >= torch.abs(magi) * 2
            magi = torch.where(flip, -magi, magi)
            angi = torch.where(flip, -angi, angi)
            # float residue transform (feeds later steps' M6)
            cf = torch.abs(rs[Mi]) > torch.abs(rs[Ai])
            magf = torch.where(cf, rs[Mi], rs[Ai])
            angf = torch.where(cf,
                               torch.where(rs[Mi] > 0, rs[Mi] - rs[Ai],
                                           rs[Ai] - rs[Mi]),
                               torch.where(rs[Ai] > 0, rs[Mi] - rs[Ai],
                                           rs[Ai] - rs[Mi]))
            flipf = angf >= torch.abs(magf) * 2
            magf = torch.where(flipf, -magf, magf)
            angf = torch.where(flipf, -angf, angf)
            sqs = torch.where(hyp < 0, -sq, sq)
            # point-side promotion on the folded magnitude channel
            out_pt = mag_pt
            if promote_on:
                cand = point & (ve < float(f32(0.25))) \
                    & self.nm_inreg_t[:n2]
                npk_m = None
                if npk is not None:
                    neg = (npk[Mi] < -0.5) | (npk[Ai] < -0.5)
                    npk_m = torch.where(neg, -1.0,
                                        torch.minimum(npk[Mi], npk[Ai]))
                    npk[Mi] = torch.where(pu, npk_m, npk[Mi])
                out_pt = self._normalize_promote(
                    mag_pt, ve, torch.abs(hyp), cand, hyp, npeak=npk_m)
            # commit the pair's new state (the C's quant energies are
            # not read by any later stage of this path and are not kept)
            out[Mi] = torch.where(lossless, magi,
                                  torch.where(point, out_pt, out[Mi]))
            out[Ai] = torch.where(lossless, angi,
                                  torch.where(point, 0.0, out[Ai]))
            re_[Mi] = torch.where(lossless, torch.abs(rM) + torch.abs(rA),
                                  torch.where(point, hyp, re_[Mi]))
            rs[Mi] = torch.where(lossless, magf,
                                 torch.where(point, sqs, rs[Mi]))
            rs[Ai] = torch.where(lossless, angf,
                                 torch.where(point, 0.0, rs[Ai]))
            fsum = torch.where(pu, fl_e[Mi] + fl_e[Ai], fl_e[Mi])
            fl_e[Ai] = torch.where(pu, fsum, fl_e[Ai])
            fl_e[Mi] = fsum
            f1[Mi] = lossless | (f1[Mi] & ~pu)
            f1[Ai] = pu | f1[Ai]
            # point bins keep a -1 flag on the mag channel (the C only
            # sets fA=1 there), so later steps' M6 can still promote
            fm1[Mi] = fm1[Mi] & ~lossless
            fm1[Ai] = fm1[Ai] & ~pu
            both = usc[Mi] | usc[Ai]
            usc[Mi] = both
            usc[Ai] = both
        out_g = torch.stack(out, 1)
        used_out = torch.stack(usc, 1)
        out_g = torch.where(used_out[..., None], out_g, 0.0)
        return out_g, used_out

    def _finish_multi(self, md, logmdct, mask, F, wb, wid=None,
                      epeak=None, npeak=None):
        """Multi-submap encode tail (5.1 layouts): per-submap floor fit
        (each submap's own floor kernel) + wrap coding, the chained
        coupling on the coupled submap, per-submap residue VQ, one
        packet assembly.  md/logmdct/mask: (F*ch, n2); wid, epeak and
        npeak as in finish_from_posts."""
        ch = self.ch
        n2 = md.shape[-1]
        md3 = md.reshape(F, ch, n2)
        lg3 = logmdct.reshape(F, ch, n2)
        mk3 = mask.reshape(F, ch, n2)
        ep3 = epeak.reshape(F, ch, n2) if epeak is not None else None
        npk3 = (npeak.reshape(F, ch, -1) if npeak is not None
                else None)
        nm = getattr(self.ctx, "normal", None)
        bins = torch.arange(n2, device=md.device)
        fl_cols_v = [None] * ch
        fl_cols_l = [None] * ch
        res_blocks = []
        for g in self.groups:
            c0 = g.channels[0]
            nc = len(g.channels)
            gs = slice(c0, c0 + nc)
            # the submap's floor may cover fewer bins than the block
            # (e.g. the LFE floor); fit/render at its width, zero the
            # residue above it (mapping0 codes nothing past floor n).
            # The floor kernel takes contiguous (B, n) rows.
            fln = g.fl.n
            posts, used = g.floor(
                lg3[:, gs, :fln].reshape(F * nc, fln).contiguous(),
                mk3[:, gs, :fln].reshape(F * nc, fln).contiguous())
            codes, qposts = self._floor_wrap(posts, cfg=g)
            curve = g.floor.render(qposts, self.ctx.fromdB)
            if fln < n2:
                curve = torch.nn.functional.pad(curve, (0, n2 - fln),
                                                value=1e-10)
            inband = bins < fln
            fv, fl = self._floor_fields(codes, used, cfg=g)
            fv = fv.reshape(F, nc, -1)
            fl = fl.reshape(F, nc, -1)
            for j, c in enumerate(g.channels):
                fl_cols_v[c] = fv[:, j]
                fl_cols_l[c] = fl[:, j]
            mdg = md3[:, gs]
            curg = curve.reshape(F, nc, n2)
            usedg = used.reshape(F, nc)
            if g.res_type == 2:
                out_g, used_o = self._couple_multi(
                    mdg, curg, usedg, F,
                    epeak=ep3[:, gs] if ep3 is not None else None,
                    npeak=npk3[:, gs] if npk3 is not None else None)
                out_g = torch.where(inband, out_g, 0.0)
                inter = out_g.transpose(1, 2).reshape(F, -1)
                absA = torch.abs(out_g[:, 1]) if nc == 2 else \
                    torch.abs(out_g[:, 1:]).amax(1)
                pw = self._classify2(torch.abs(out_g[:, 0]), absA,
                                     nch=nc, cfg=g)
                entries = self._vq_stages(inter, pw, cfg=g)
                pw_p = pw.reshape(F, 1, -1)
                ent_p = [e.reshape(F, 1, g.partvals, -1)
                         for e in entries]
                used_p = used_o.any(-1).reshape(F, 1)
            else:
                curg2 = torch.where(usedg[..., None], curg,
                                    float(f32(1e-10)))
                rr = mdg / curg2
                res = torch.round(rr)
                res = torch.where(usedg[..., None] & inband, res, 0.0)
                R = F * nc
                if nm is not None and nm["thresh"] < 9000.0:
                    ve = rr * rr
                    cand = (ve < float(f32(0.25))) \
                        & self.nm_start_t[:n2] & usedg[..., None]
                    npk_g = (npk3[:, gs].reshape(R, -1)
                             if npk3 is not None else None)
                    res = self._normalize_promote(
                        res.reshape(R, n2), ve.reshape(R, n2),
                        torch.abs(mdg * mdg).reshape(R, n2),
                        cand.reshape(R, n2), rr.reshape(R, n2),
                        npeak=npk_g).reshape(F, nc, n2)
                pw = self._classify(res.reshape(R, n2), cfg=g)
                entries = self._vq_stages(res.reshape(R, n2), pw, cfg=g)
                pw_p = pw.reshape(F, nc, -1)
                ent_p = [e.reshape(F, nc, g.partvals, -1)
                         for e in entries]
                used_p = usedg
            res_blocks.append(self._residue_fields(pw_p, ent_p, used_p,
                                                   cfg=g))
        hdr_v, hdr_l = self._header(F, wid, md.device)
        vals = torch.cat([hdr_v] + fl_cols_v
                         + [rv for rv, _ in res_blocks], 1)
        lens = torch.cat([hdr_l] + fl_cols_l
                         + [rl for _, rl in res_blocks], 1)
        mv, ml = merge_columns(vals, lens, self.gidx_t)
        return pack_bits(mv, ml, wb)

    def _header(self, F, wid, dev):
        """The packet header columns (F, 4): packet-type bit, mode, and
        (long blocks only) the lW/nW window-shape flags -- the frame's
        neighbour flags when the caller passes wid (F*ch,), else 1/1
        (all-long stream).  Bit fields ride int64 (no uint32 shifts in
        torch)."""
        if self.W and wid is not None:
            wf = wid.reshape(F, self.ch)[:, 0].to(i64)
            lw_v = (wf >> 1) & 1
            nw_v = wf & 1
        else:
            lw_v = torch.ones((F,), dtype=i64, device=dev)
            nw_v = lw_v
        hdr_v = torch.stack([torch.zeros_like(lw_v),
                             torch.full_like(lw_v, self.ctx.mode_idx),
                             lw_v, nw_v], 1)
        return hdr_v, self.hdr_l_t.expand(F, 4)

    def _normalize_promote(self, out, ve, qe, cand, sgn, npeak=None):
        """noise_normalize's energy-budget promotion (psy.c:4732-4854),
        batched per partition: candidate bins (sub-unity energy) sort
        by raw energy descending; while the accumulated energy budget
        exceeds normal_thresh, the next-largest candidate becomes +-1
        (one unit of energy each); the rest stay 0.  npeak (F, nparts):
        the M8 per-partition store -- negative disables the partition,
        positive boosts its budget (acc += acc*npeak^2).  Both sorts
        are stable, as jnp.argsort is: candidates of equal energy rank
        by bin."""
        nm = self.ctx.normal
        thresh = float(f32(nm["thresh"]))
        part = nm["partition"]
        F, n2 = out.shape
        npad = (-n2) % part
        if npad:
            def pad(a, v):
                return torch.nn.functional.pad(a, (0, npad), value=v)
            out2, ve2 = pad(out, 0.0), pad(ve, 0.0)
            qe2, c2 = pad(qe, 0.0), pad(cand, False)
            s2 = pad(sgn, 0.0)
        else:
            out2, ve2, qe2, c2, s2 = out, ve, qe, cand, sgn
        np_ = out2.shape[-1] // part
        if npeak is not None:
            npk = npeak[:, :np_]
            if npk.shape[-1] < np_:
                npk = torch.nn.functional.pad(
                    npk, (0, np_ - npk.shape[-1]))
            gate = torch.repeat_interleave(
                npk > -0.5, part, dim=-1)[:, :out2.shape[-1]]
            c2 = c2 & gate
        vp = torch.where(c2, ve2, 0.0).reshape(F, np_, part)
        acc = vp.sum(-1)
        if npeak is not None:
            acc = acc + acc * npk * npk
        npro = torch.where(acc >= thresh,
                           torch.floor(acc - thresh).to(i32) + 1, 0)
        npro = torch.minimum(npro, acc.to(i32) + 1)
        key = torch.where(c2, qe2, -float("inf")).reshape(F, np_, part)
        order = torch.argsort(-key, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        sel = (rank < npro[..., None]) & c2.reshape(F, np_, part)
        sel = sel.reshape(F, -1)[:, :n2]
        unit = torch.where(s2[:, :n2] < 0, -1.0, 1.0)
        return torch.where(sel, unit, out)

    # -- the full step -------------------------------------------------------
    def encode_flat(self, flat, F, wb, wid=None):
        """The post-framing encode body: flat (F*ch, n) raw PCM frames
        in frame-major (F, ch) order, wid (F*ch,) the window-shape ids
        (long mode; None for an all-long stream) -> (packets (F, wb)
        uint8, nbits (F,) int32).  Per-frame math only (no cross-frame
        dependency)."""
        ctx = self.ctx
        md, logmdct, mask = ctx.analysis.full_mask(flat, wid)
        if self.multi:
            return self._finish_multi(md, logmdct, mask, F, wb, wid)
        posts, used = ctx.floor(logmdct, mask)
        return self.finish_from_posts(md, posts, used, F, wb, wid=wid)

    def finish_from_posts(self, md, posts, used, F, wb, wid=None,
                          thr1=None, threv=None, inlimit=None,
                          lowpass=None, epeak=None, npeak=None):
        """Post-fit encode body: raw fit posts -> packed packets.
        Shared by the single-blob path and the managed 15-blob pass
        (ops/managed.py), which feeds interpolated post ladders, per-row
        coupling thresholds thr1/threv/inlimit (F, n2) and the per-row
        sliding lowpass (F*ch,) bins.  wid (F*ch,): per-row
        window-shape id (lW*2+nW) for the header flags; epeak/npeak:
        the psy-state path's M9 peak store (F*ch, n2) and M8 partition
        store (F*ch, nparts) feeding flag_lossless, M6 and the
        noise-normalize budget."""
        ctx = self.ctx
        ch = self.ch
        codes, qposts = self._floor_wrap(posts)
        curve = ctx.floor.render(qposts, ctx.fromdB)
        if lowpass is not None:
            # per-row sliding lowpass: zero residues at and above the
            # blob's bin limit (psy.c:5126-5131)
            bins = torch.arange(md.shape[-1], dtype=torch.int32,
                                device=md.device)
            md = torch.where(bins[None, :] < lowpass[:, None], md, 0.0)
        if self.res_type == 2:
            out2, any_used = self._couple_quantize(
                md, curve, used, F, thr1=thr1, threv=threv,
                inlimit=inlimit, epeak=epeak, npeak=npeak)
            # interleave the coupled pair: flat[i] = out2[:, i%2, i//2]
            inter = out2.transpose(1, 2).reshape(F, -1)
            pw = self._classify2(torch.abs(out2[:, 0]),
                                 torch.abs(out2[:, 1]))
            entries = self._vq_stages(inter, pw)
            used_p = any_used.reshape(F, 1)
        else:
            rr = md / curve
            res = torch.round(rr)
            res = torch.where(used[:, None], res, 0.0)
            nm = getattr(ctx, "normal", None)
            if nm is not None and nm["thresh"] < 9000.0:
                # per-channel noise_normalize promotion (active rungs)
                ve = rr * rr
                cand = (ve < float(f32(0.25))) & self.nm_inreg_t \
                    & used[:, None]
                res = self._normalize_promote(res, ve, torch.abs(md * md),
                                              cand, rr, npeak=npeak)
            pw = self._classify(res)
            entries = self._vq_stages(res, pw)
            used_p = used.reshape(F, ch)
        fv, fl = self._floor_fields(codes, used)
        hdr_v, hdr_l = self._header(F, wid, md.device)
        fv = fv.reshape(F, -1)
        fl = fl.reshape(F, -1)
        rc = self.res_ch
        pw_p = pw.reshape(F, rc, -1)
        ent_p = [e.reshape(F, rc, self.partvals, -1) for e in entries]
        rv, rl = self._residue_fields(pw_p, ent_p, used_p)
        vals = torch.cat([hdr_v, fv, rv], 1)
        lens = torch.cat([hdr_l, fl, rl], 1)
        mv, ml = merge_columns(vals, lens, self.gidx_t)
        return pack_bits(mv, ml, wb)

    def make_step(self, wb=None):
        """Returns a callable pcm_chunk (ch, F*hop + hop) on the device
        -> (packets (F, wb) uint8, nbits (F,) int32).  int16 PCM is
        scaled by 1/32768 on the device."""
        wb = wb or self.plan.wb
        n, hop, ch = self.n, self.hop, self.ch

        def step(pcm):
            if pcm.dtype != torch.float32:
                x = pcm.to(torch.float32) / 32768.0
            else:
                x = pcm
            F = pcm.shape[1] // hop - 1
            frames = x.unfold(1, n, hop)[:, :F]      # (ch, F, n) view
            flat = frames.transpose(0, 1).reshape(F * ch, n)
            return self.encode_flat(flat, F, wb)

        return step

    def make_framed_step(self, F, wb=None):
        """Returns a callable frames (F, ch, n) float32 on the device ->
        (packets (F, wb) uint8, nbits (F,) int32) for pre-framed input:
        the shardable entry point (the frame axis splits over a mesh,
        parallel/mesh.sharded_encode_step).  Rows are wb bytes
        (plan.wb by default): a packet longer than that is cut, as in
        the JAX step; the encoder's own redo at worst_bytes
        (models/fastenc.py _drain) is not this step's."""
        wb = wb or self.plan.wb
        n, ch = self.n, self.ch

        def step(frames):
            flat = frames.reshape(F * ch, n)
            return self.encode_flat(flat, F, wb)

        return step

    def _gather_frames(self, x64, starts, F):
        """(ch, R, 64) PCM rows + (F,) 64-aligned sample offsets ->
        flat (F*ch, n) float32 frames in frame-major (F, ch) order;
        int16 PCM is scaled by 1/32768."""
        n, ch = self.n, self.ch
        rows = (torch.div(starts.long(), 64, rounding_mode="floor")[:, None]
                + torch.arange(n // 64, device=x64.device)[None, :])
        fr = x64[:, rows]                          # (ch, F, n/64, 64)
        if fr.dtype != torch.float32:
            fr = fr.to(torch.float32) / 32768.0
        return fr.reshape(ch, F, n).transpose(0, 1).reshape(F * ch, n)

    def make_gather_step(self, F, wb=None):
        """Returns a callable (x64, starts, wid) -> (packets, nbits):
        frames gathered at arbitrary 64-sample-aligned offsets from the
        device-resident stream (encode_batch's stateless path).  x64:
        (ch, R, 64) PCM (f32 or i16/32768), starts: (F,) int32 sample
        offsets (64-aligned), wid: (F,) int32 window-shape id (lW*2+nW,
        long mode only)."""
        wb = wb or self.plan.wb
        ch = self.ch

        def step(x64, starts, wid):
            flat = self._gather_frames(x64, starts, F)
            w = torch.repeat_interleave(wid, ch) if self.W else None
            return self.encode_flat(flat, F, wb, wid=w)

        return step

    # -- stateful two-phase pipeline (cross-frame psy state) ---------------
    def make_probe_step(self, F, n2L):
        """Phase A of the stateful path: frames -> spectra plus the
        per-frame reductions the host recurrences need and the frame's
        lastmdct contribution row (resampled per lmode: 0 identity,
        1 repeat x8 (short, nW long), 2 min-pool /8 (long, nW short);
        psy.c:4462-4501).

        step(x64, svec): svec (3, F) int32 = (starts, wid, lmode).
        Returns (keep on the device..., fetch to the host...):
          md, logmdct, logfft, fit1, dB   (F*ch, n2)   device
          L                                (F*ch, n2L)  device
          lam, hi_th, upt, unt             (F*ch,)      host
        """
        n, ch = self.n, self.ch
        n2 = n // 2
        da = self.ctx.analysis
        look = da.look

        def step(x64, svec):
            starts, wid, lmode = svec[0], svec[1], svec[2]
            flat = self._gather_frames(x64, starts, F)
            w = torch.repeat_interleave(wid, ch) if self.W else None
            md, logmdct, fit1, dB, logfft = da.spectra(flat, w,
                                                       with_fft=True)
            lam = torch.clamp_max(logfft.amax(-1), 0.0)
            # M5 probe: clamped band average (lb_loudnoise_fix)
            seg = logmdct[:, look.n25p:look.n75p]
            hi_th = torch.clamp_min(seg, -130.0).sum(-1) \
                / float(f32(look.n))
            # M2 probe: |pcm| segment sums on the raw frames
            sn = n >> 2
            ab = torch.abs(flat)
            upt = ab[:, sn:2 * sn].sum(-1)
            unt = ab[:, 2 * sn:sn + (n >> 1)].sum(-1)
            # lastmdct contribution row.  The reference resamples with
            # a FIXED mag=8 (psy.c:4462-4501) because the machinery is
            # gated to hsrate templates whose block ratio IS 8
            # (256/2048); low-rate templates never consume lastmdct, so
            # their rows pass through as identity.
            lm = torch.repeat_interleave(lmode, ch)
            if not self.W and n2 * 8 == n2L:
                # short mode, ratio 8: identity | repeat x8
                ident = torch.nn.functional.pad(logmdct, (0, n2L - n2))
                rep = torch.repeat_interleave(logmdct, 8, dim=-1)
                L = torch.where((lm == 1)[:, None], rep, ident)
            elif self.W and n2 == n2L and n2 % 8 == 0:
                # long mode: identity | min-pool /8
                n8 = n2 // 8
                minp = logmdct.reshape(-1, n8, 8).amin(-1)
                minp = torch.nn.functional.pad(minp, (0, n2L - n8))
                L = torch.where((lm == 2)[:, None], minp, logmdct)
            else:
                # non-hsrate ratios: rows are never read back
                L = torch.nn.functional.pad(logmdct, (0, n2L - n2))
            return md, logmdct, logfft, fit1, dB, L, lam, hi_th, \
                upt, unt

        return step

    def make_finish_step(self, F, wb=None):
        """Phase B of the stateful path: spectra + per-frame state ->
        packed packets.  step(md, logmdct, logfft, fit1, dB, lastmdct,
        lam, fstate, m3vec=None): per-row inputs (F*ch) lastmdct
        (gathered from the global L buffer) and lam; fstate packs
        [ampmax (F), lowcomp (F*ch), poste (F*ch), trans (F), wid (F)]
        as ONE float32 vector per batch (trans: block_mode==2 in long
        mode, a padding block (bm==1) in short mode); m3vec (6, F)
        likewise packs the short-mode M3 fields [sw, noise_rate,
        noise_center, tone_rate, reset, impad_zero]: the tempmdct scan
        (the short ctx's m3_scan, the CUDA kernel on the card) and
        m3_apply run on it."""
        wb = wb or self.plan.wb
        ch = self.ch
        da = self.ctx.analysis
        look = da.look
        from . import psydevice as PD

        def step(md, logmdct, logfft, fit1, dB, lastmdct, lam, fstate,
                 m3vec=None):
            o = 0
            ampmax = fstate[o:o + F]
            o += F
            lowcomp = fstate[o:o + F * ch]
            o += F * ch
            poste = fstate[o:o + F * ch]
            o += F * ch
            trans = fstate[o:o + F] > 0.5
            o += F
            wid = fstate[o:o + F].to(i32)
            kind = "long" if self.W else "short"
            trans_r = torch.repeat_interleave(trans, ch)
            logmask, epeak, npeak = PD.noisemask_tail(
                look, logmdct, fit1, dB, lowcomp, poste, lastmdct,
                kind, trans_active=trans_r if self.W else None)
            amp_rows = torch.repeat_interleave(ampmax, ch)
            tone = da.tonemask(logfft, amp_rows, lam)
            # per-frame blocktype: trans flags transitional longs
            # (blocktype 2 vs 3) / padding shorts (1 vs 0); the noise
            # bias curve is the only psy param that differs between the
            # paired blocktypes in every reference template
            noff = torch.where(trans_r[:, None], da.noiseoffsets_alt[1],
                               da.noiseoffsets[1])
            val = torch.clamp_max(logmask + noff, da.noisemaxsupp)
            tval = tone + da.toneatt1
            tval = PD.lowcompand_tval(look, tval, lowcomp, 1)
            if not self.W and m3vec is not None:
                m3 = dict(sw=m3vec[0] > 0.5, noise_rate=m3vec[1],
                          noise_center=m3vec[2], tone_rate=m3vec[3],
                          reset=m3vec[4] > 0.5,
                          impad_zero=m3vec[5] > 0.5)
                n2 = look.n
                shp = (F, ch, n2)
                lm3 = logmdct[:, :n2].reshape(shp)
                last3 = lastmdct.reshape(F, ch, -1)
                temps = self.ctx.m3_scan(lm3, last3, val.reshape(shp),
                                         tval.reshape(shp), m3)
                v2, t2, npk2 = PD.m3_apply(
                    look, val.reshape(shp), tval.reshape(shp), lm3, last3,
                    temps, npeak.reshape((F, ch, -1)), m3,
                    m3["impad_zero"])
                val = v2.reshape(F * ch, n2)
                tval = t2.reshape(F * ch, n2)
                npeak = npk2.reshape(F * ch, -1)
            md2, mask = da.mix_m4_m1(md, logmdct, val, tval, 1)
            w = torch.repeat_interleave(wid, ch) if self.W else None
            if self.multi:
                return self._finish_multi(md2, logmdct, mask, F, wb,
                                          wid=w, epeak=epeak,
                                          npeak=npeak)
            posts, used = self.ctx.floor(logmdct, mask)
            return self.finish_from_posts(md2, posts, used, F, wb,
                                          wid=w, epeak=epeak,
                                          npeak=npeak)

        return step

    def get_step(self, wb=None):
        wb = wb or self.plan.wb
        if wb not in self._step_cache:
            self._step_cache[wb] = self.make_step(wb)
        return self._step_cache[wb]
