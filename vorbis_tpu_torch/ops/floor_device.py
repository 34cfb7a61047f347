"""Torch counterpart of vorbis_tpu/ops/floor_device.py: batched floor1
fitting and rendering (reference: lib/floor1.c floor1_fit /
accumulate_fit / fit_line / inspect_error / render_line).

`DeviceFloorFit.fit` is the plain PyTorch version of the floor-fit
kernel (ops/floor_cuda.py, csrc/floor_fit.cu): the greedy post loop
over the static sort positions, with every per-frame value in (B,) or
(B, P) tensors.  Its arithmetic is the JAX module's, op for op, with
fit_line's three products-differences fused as XLA:CPU fuses them, so
the posts equal the Pallas kernel's bit for bit given the same inputs
(tests/test_torch_floor.py).  The stages split as:

  prepare(logmdct, logmask) -> quant, above, prefix, used
      dB quantization, above/below classes, the per-segment moment
      matmul (exact, in float64) and its prefix sum in float64; the
      plain version of the prepare kernel (ops/floor_cuda.py
      `floor_prepare`, csrc/floor_prepare.cu)
  fit(quant, above, prefix) -> posts (B, P) int32 with 0x8000 flags
      the plain version of the fit kernel (csrc/floor_fit.cu)

On the card both stages are kernels (`DeviceFloorFitCuda`), so a fit is
two launches from the spectra.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.floor1_codec import Floor1Look
from ..convert import device_tables
from .xla_f32 import fma, to_int32

f32 = np.float32
NEG = -200
# the mask's dB quantization, quant = logmask * QUANT_SCALE + QUANT_OFFSET
QUANT_SCALE = f32(7.3142857)
QUANT_OFFSET = f32(1023.5)


def _render_point(x0, x1, y0, y1, x):
    """floor1.c render_point: integer DDA closed form (vector ints).
    The division runs as f32 divide + trunc, which is exact here:
    err <= 1023*1024 < 2^21 and adx <= 1024 are exact in f32 and the
    quotient sits >= 0.5/adx away from every integer.  Callers mask
    x < x0.  x0/x1/x may be Python ints (static post positions)."""
    x0, x1, x = (v if torch.is_tensor(v) else
                 torch.tensor(v, dtype=torch.int32, device=y0.device)
                 for v in (x0, x1, x))
    y0 = y0 & 0x7FFF
    y1 = y1 & 0x7FFF
    dy = y1 - y0
    adx = x1 - x0
    err = torch.abs(dy) * (x - x0)
    off = ((err.to(torch.float32) + 0.5)
           / torch.clamp_min(adx, 1).to(torch.float32)).to(torch.int32)
    return torch.where(dy < 0, y0 - off, y0 + off)


class DeviceFloorFit:
    def __init__(self, look: Floor1Look, device):
        self.device = torch.device(device)
        info = look.info
        self.look = look
        self.posts = look.posts
        self.n = look.n
        n = self.n
        P = self.posts
        sx = np.asarray(look.sorted_x, np.int64)
        self.sorted_x = sx
        self.postlist = np.asarray(info.postlist, np.int64)
        self.forward_index = np.asarray(look.forward_index, np.int64)
        self.reverse_index = np.argsort(self.forward_index,
                                        kind="stable")
        self.lo_static = np.asarray(look.loneighbor, np.int64)
        self.hi_static = np.asarray(look.hineighbor, np.int64)
        self.tw = f32(info.twofitweight)
        self.twofitatten = f32(info.twofitatten)
        self.maxover = f32(info.maxover)
        self.maxunder = f32(info.maxunder)
        self.maxerr = f32(info.maxerr)
        # accumulate_fit windows are INCLUSIVE of both endpoints
        # (floor1.c: for(i=x0; i<=x1 && i<n; i++)): boundary bins count
        # in both adjacent segments, so per-segment sums come from
        # bin-level windows [sx[s], min(sx[s+1], n-1)+1)
        self.n_segs = P - 1
        self.seg_lo = np.minimum(sx[:-1], n - 1)
        self.seg_hi = np.minimum(sx[1:], n - 1) + 1
        t = np.arange(n)[:, None]
        seg_mat = ((t >= self.seg_lo[None, :])
                   & (t < self.seg_hi[None, :])).astype(np.float32)
        # bin t -> sorted interval j with xs[j] <= t < xs[j+1] (render)
        iv = np.searchsorted(sx, np.arange(n), side="right") - 1
        vars(self).update(device_tables(dict(
            seg_mat=seg_mat,                                   # (n, S)
            xg=np.arange(n, dtype=np.int32),
            rev_t=self.reverse_index.astype(np.int64),
            postlist_t=self.postlist.astype(np.int32),
            sx_t=self.sorted_x.astype(np.int32),
            fwd_t=self.forward_index,
            iv_t=np.clip(iv, 0, P - 1).astype(np.int64),
        ), self.device))
        # the moments sum in float64 (_moments)
        self.seg_mat64 = self.seg_mat.double()

    # -- stage 1: quantization + per-segment moments -------------------
    def _weighted_moments(self, quant, above):
        """quant (B, n) int32, above (B, n) bool -> each segment's
        weighted moments (B, S, 6) float32 and above count (B, S), the
        terms _moments sums.  The bin -> segment reduction is one matmul
        in float64: every feature is an integer below 2^20 and a segment
        sums at most n of them, so the float64 sums are exact (as the
        reference's integer accumulate_fit) and round once to float32,
        the same on the card and the CPU; an fp32 matmul would round in
        its library's order."""
        q = quant.to(torch.float32)
        x = self.xg.to(torch.float32).expand(q.shape)
        used = quant != 0
        am = used & above
        bm = used & ~above
        ones = torch.ones_like(q)
        feats = torch.stack([x, q, x * x, q * q, x * q, ones], 1)  # B6n

        def seg_moments(mask):
            vals = torch.where(mask[:, None, :], feats, 0.0)
            return torch.matmul(vals.double(), self.seg_mat64).float() \
                .transpose(1, 2)

        A = seg_moments(am)                                # (B, S, 6)
        Bv = seg_moments(bm)
        an = A[..., 5]
        bn = Bv[..., 5]
        # fit_line weight: (bn+an)*tw/(an+1)+1 per segment (f32)
        w = ((bn + an) * float(self.tw) / (an + 1.0) + 1.0)[..., None]
        return Bv + A * w, an

    def _moments(self, quant, above):
        """quant (B, n) int32, above (B, n) bool -> weighted prefix
        moments (B, S+1, 6) float32 and per-segment above counts
        (B, S)."""
        wm, an = self._weighted_moments(quant, above)
        # the prefix sums in float64, one segment after another, rounded
        # once: on the CPU torch.cumsum of float32 accumulates so, where
        # the card's would add in float32
        prefix = torch.cumsum(wm.double(), dim=-2).float()
        zero = torch.zeros_like(prefix[..., :1, :])
        return torch.cat([zero, prefix], dim=-2), an

    def prepare(self, logmdct, logmask):
        """(B, n) spectra -> (quant (B, n) int32, above (B, n) bool,
        prefix (B, P, 6) f32, used (B,) bool)."""
        # XLA:CPU fuses the JAX package's logmask * 7.31 + 1023.5, and
        # its convert saturates (a +inf mask quantizes to 1023)
        quant = torch.clamp(to_int32(fma(logmask, float(QUANT_SCALE),
                                         float(QUANT_OFFSET))), 0, 1023)
        above = (logmdct + float(self.twofitatten)) >= logmask
        prefix, an = self._moments(quant, above)
        used = an.sum(-1) > 0
        return quant, above, prefix, used

    def _fit_line(self, prefix, s0, s1, x0, x1):
        """Weighted LS fit over segments [s0, s1) -> (y0, y1, bad).
        s0/s1/x0/x1: (B,) ints."""
        bidx = torch.arange(prefix.shape[0], device=prefix.device)
        m = prefix[bidx, s1] - prefix[bidx, s0]
        xb, yb, x2b, y2b, xyb, bn = m.unbind(-1)
        # p*q - r*s as XLA:CPU contracts it in the JAX package's fit:
        # fma(p, q, -(r*s)) (the moments are never subnormal)
        denom = fma(bn, x2b, -(xb * xb))
        bad = denom <= 0.0
        d = torch.where(bad, 1.0, denom)
        a = fma(yb, x2b, -(xyb * xb)) / d
        b = fma(bn, xyb, -(xb * yb)) / d
        y0 = torch.clamp(torch.round(a + b * x0), 0, 1023).to(torch.int32)
        y1 = torch.clamp(torch.round(a + b * x1), 0, 1023).to(torch.int32)
        y0 = torch.where(bad, 0, y0)
        y1 = torch.where(bad, 0, y1)
        return y0, y1, bad

    def _inspect(self, quant, above, lx, hx, ly, hy):
        """inspect_error over dynamic ranges [lx, hx): (B,) verdict."""
        x = self.xg
        inr = (x[None, :] >= lx[:, None]) & (x[None, :] < hx[:, None])
        y = _render_point(lx[:, None], hx[:, None], ly[:, None],
                          hy[:, None], x[None, :])
        diff = y - quant
        # integer mse: |diff| <= 1023, n <= 1024 -> fits int32 exactly
        mse = torch.where(inr, diff * diff, 0).sum(-1, dtype=torch.int32)
        first = x[None, :] == lx[:, None]
        chk = inr & above & (first | (quant != 0))
        yf = y.to(torch.float32)
        qf = quant.to(torch.float32)
        over = chk & ((yf + float(self.maxover) < qf)
                      | (yf - float(self.maxunder) > qf))
        hard = over.any(-1)
        cnti = torch.clamp_min(hx - lx, 1)
        cnt = cnti.to(torch.float32)
        rough_ok = ((float(self.maxover * self.maxover) / cnt
                     > float(self.maxerr))
                    | (float(self.maxunder * self.maxunder) / cnt
                       > float(self.maxerr)))
        # C: mse/n > maxerr (int division, truncating)
        mse_bad = torch.div(mse, cnti, rounding_mode="floor") \
            .to(torch.float32) > float(self.maxerr)
        return hard | (~rough_ok & mse_bad)

    # -- the greedy fit: plain version of csrc/floor_fit.cu ------------
    def fit(self, quant, above, prefix):
        """Greedy post fit + final walk -> posts (B, P) int32 with the
        0x8000 interpolation flag (floor1.c:599-750)."""
        B = quant.shape[0]
        P = self.posts
        dev = quant.device
        i32 = dict(dtype=torch.int32, device=dev)
        fitA = torch.full((B, P), NEG, **i32)
        fitB = torch.full((B, P), NEG, **i32)
        lon = torch.zeros((B, P), **i32)
        hin = torch.ones((B, P), **i32)
        memo = torch.full((B, P), -1, **i32)
        bidx = torch.arange(B, device=dev)
        ar = torch.arange(P, device=dev)

        full = torch.full((B,), self.n_segs, dtype=torch.long, device=dev)
        x0g = torch.full((B,), int(self.postlist[0]), **i32)
        x1g = torch.full((B,), int(self.sorted_x[-1]), **i32)
        y0, y1, _ = self._fit_line(prefix, torch.zeros_like(full), full,
                                   x0g, x1g)
        fitA[:, 0] = y0
        fitB[:, 0] = y0
        fitA[:, 1] = y1
        fitB[:, 1] = y1

        def post_Y(idx):
            a = fitA[bidx, idx]
            b = fitB[bidx, idx]
            return torch.where(a < 0, b, torch.where(b < 0, a,
                                                     (a + b) >> 1))

        for i in range(2, P):
            sortpos = int(self.reverse_index[i])
            ln = lon[:, sortpos].long()
            hn = hin[:, sortpos].long()
            already = memo[bidx, ln] == hn
            lsort = self.rev_t[ln]
            hsort = self.rev_t[hn]
            memo[bidx, ln] = hn.to(torch.int32)
            lx = self.postlist_t[ln]
            hx = self.postlist_t[hn]
            ly = post_Y(ln)
            hy = post_Y(hn)
            bad = self._inspect(quant, above, lx, hx, ly, hy)
            act = bad & ~already
            sp = torch.full((B,), sortpos, dtype=torch.long, device=dev)
            sp_x = torch.full((B,), int(self.sorted_x[sortpos]), **i32)
            ly0, ly1, ret0 = self._fit_line(prefix, lsort, sp, lx, sp_x)
            hy0, hy1, ret1 = self._fit_line(prefix, sp, hsort, sp_x, hx)
            # degenerate handling (floor1.c:668-684)
            ly0 = torch.where(ret0, ly, ly0)
            ly1 = torch.where(ret0, hy0, ly1)
            hy0 = torch.where(ret1, ly1, hy0)
            hy1 = torch.where(ret1, hy, hy1)
            both = ret0 & ret1
            upd = act & ~both
            fitB[bidx, ln] = torch.where(upd, ly0, fitB[bidx, ln])
            fitA[:, 0] = torch.where(upd & (ln == 0), ly0, fitA[:, 0])
            fitA[:, i] = torch.where(upd, ly1, fitA[:, i])
            fitB[:, i] = torch.where(upd, hy0, fitB[:, i])
            fitA[bidx, hn] = torch.where(upd, hy1, fitA[bidx, hn])
            fitB[bidx, hn] = torch.where(upd & (hn == 1), hy1,
                                         fitB[bidx, hn])
            neg = act & both
            fitA[:, i] = torch.where(neg, NEG, fitA[:, i])
            fitB[:, i] = torch.where(neg, NEG, fitB[:, i])
            # neighbor propagation: the contiguous runs of matching
            # neighbours adjacent to sortpos take post i (a position
            # joins iff no non-matching one lies between it and sortpos)
            prop = (upd & ((ly1 >= 0) | (hy0 >= 0)))[:, None]
            below = ar[None, :] < sortpos
            match = hin == hn[:, None]
            lastgap = torch.where(below & ~match, ar, -1).amax(
                1, keepdim=True)
            hin = torch.where(prop & below & match & (ar > lastgap), i,
                              hin)
            abv = ar[None, :] > sortpos
            matchl = lon == ln[:, None]
            firstgap = torch.where(abv & ~matchl, ar, P).amin(
                1, keepdim=True)
            lon = torch.where(prop & abv & matchl & (ar < firstgap), i,
                              lon)

        # final output walk (floor1.c:735-750) with the static
        # decode-side neighbours
        out = torch.zeros((B, P), **i32)
        out[:, 0] = post_Y(torch.zeros_like(bidx))
        out[:, 1] = post_Y(torch.ones_like(bidx))
        for i in range(2, P):
            ln0 = int(self.lo_static[i - 2])
            hn0 = int(self.hi_static[i - 2])
            pred = _render_point(int(self.postlist[ln0]),
                                 int(self.postlist[hn0]),
                                 out[:, ln0], out[:, hn0],
                                 int(self.postlist[i]))
            vx = post_Y(torch.full_like(bidx, i))
            keep = (vx >= 0) & (pred != vx)
            out[:, i] = torch.where(keep, vx, pred | 0x8000)
        return out

    def __call__(self, logmdct, logmask):
        """(B, n) spectra -> (posts (B, P) int32 with the 0x8000
        interpolation flag, used (B,) bool)."""
        quant, above, prefix, used = self.prepare(logmdct, logmask)
        return self.fit(quant, above, prefix), used

    # -- rendering (reference: floor1_encode post quantization +
    # render_line / FLOOR1_fromdB_LOOKUP) -------------------------------
    def quantize_posts(self, posts):
        """fit posts (B, P) -> stream-quantized posts with flags
        (floor1_encode's mult division + prediction re-flagging)."""
        info = self.look.info
        val = posts & 0x7FFF
        if info.mult == 1:
            val = val >> 2
        elif info.mult == 2:
            val = val >> 3
        elif info.mult == 3:
            val = torch.div(val, 12, rounding_mode="floor")
        else:
            val = val >> 4
        post = val | (posts & 0x8000)
        out = torch.zeros_like(post)
        out[:, 0] = post[:, 0]
        out[:, 1] = post[:, 1]
        for i in range(2, self.posts):
            ln0 = int(self.lo_static[i - 2])
            hn0 = int(self.hi_static[i - 2])
            pred = _render_point(int(self.postlist[ln0]),
                                 int(self.postlist[hn0]),
                                 out[:, ln0], out[:, hn0],
                                 int(self.postlist[i]))
            flag = ((post[:, i] & 0x8000) != 0) | (pred == post[:, i])
            out[:, i] = torch.where(flag, pred | 0x8000, post[:, i])
            # an explicitly-coded post anchors its neighbors: clear
            # their interpolation flags exactly like the wrap coder and
            # the decoder do (floor1.c floor1_encode post[ln]&=0x7fff /
            # floor1_inverse1)
            unflag = ~flag
            out[:, ln0] = torch.where(unflag, out[:, ln0] & 0x7FFF,
                                      out[:, ln0])
            out[:, hn0] = torch.where(unflag, out[:, hn0] & 0x7FFF,
                                      out[:, hn0])
        return out

    def render(self, qposts, fromdB_table):
        """Quantized posts (B, P) -> gain curve (B, n) float32, the
        same curve the decoder renders (render_line + fromdB): per
        sorted post, the previous/next used post by a running max/min
        over the tiny P axis, then one static bin -> interval gather."""
        mult = self.look.info.mult
        n = self.n
        B = qposts.shape[0]
        P = self.posts
        q = qposts[:, self.fwd_t]
        ys = torch.clamp((q & 0x7FFF) * mult, 0, 255)
        used = (q & 0x8000) == 0
        used[:, 0] = True   # post 0 always anchors
        jar = torch.arange(P, dtype=torch.int32, device=qposts.device)
        # previous used sorted index at-or-before j (inclusive)
        lastu = torch.cummax(torch.where(used, jar, -1), dim=1).values
        lastu = torch.clamp_min(lastu, 0).long()
        # next used sorted index strictly after j (P when none)
        nxt = torch.where(used, jar, P)
        nextu = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1)
                           .values, [1])
        nextu_after = torch.cat(
            [nextu[:, 1:], torch.full_like(nextu[:, :1], P)], 1)
        rzp = torch.clamp_max(nextu_after, P - 1).long()
        lxp = self.sx_t[lastu]
        lyp = torch.gather(ys, 1, lastu)
        hxp = self.sx_t[rzp]
        hyp = torch.gather(ys, 1, rzp)
        hasr = nextu_after < P
        # static bin expansion
        lx = lxp[:, self.iv_t]
        ly = lyp[:, self.iv_t]
        hx = hxp[:, self.iv_t]
        hy = hyp[:, self.iv_t]
        hr = hasr[:, self.iv_t]
        t = self.xg.expand(B, n)
        # past the last used post the curve holds ly; at the exact post
        # bin render_line writes ly
        seg = hr & (hx > lx) & (t >= lx)
        y = torch.where(seg, _render_point(lx, hx, ly, hy, t), ly)
        y = torch.clamp(y, 0, 255)
        return fromdB_table[y.long()]
