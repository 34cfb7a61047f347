"""The encoder's forward MDCT and log spectrum as a hand-written Hopper
kernel (counterpart of `mdct_forward(w, n, xp=jnp)` and `log_spectrum`
inside the jitted `DeviceAnalysis.spectra` of vorbis_tpu/ops/jaxdsp.py
:253-271, the transform of vorbis_tpu/ops/mdct.py:383).

`csrc/mdct_fwd.cu` computes, for each row of frames, the windowed
frame's MDCT `md` (n/2 floats) and `logmdct = todB(md) + .345`, rounding
as XLA:CPU compiles the JAX code (ops/xla_f32.py: flush-to-zero, and a
fused multiply-add wherever LLVM contracts one):

- the fold of the windowed input into the n/2 working vector is exact
  (products by +-1);
- the first rotation and every radix-2 stage compute `r1*Ts + r0*Tc` as
  fma(r1, Ts, r0*Tc) and `r1*Tc - r0*Ts` as fma(r1, Tc, -(r0*Ts));
- the 32-point tail follows XLA's fusions, one an output position: each
  product by cos(pi/4) that feeds the next butterfly's add is fused into
  it, and n9 = r1d*c3 + r0d*c1 fuses r0d*c1 for positions 0-7 and r1d*c3
  for 8-31 (`_bf32_xla`);
- the bitreverse stage fuses its half-scaled sums (`0.5*(a1 + b1) +
  r2`), the final rotation its first product, then the 4/n scale;
- todB's `u*7.17711438e-7 - 764.6161886` and the `+ .345` become one
  fma with the constants folded (XLA folds `(x + c1) + c2`).

`mdct_fwd_plain` is the same order in eager PyTorch: on the CPU it
equals the JAX package's jitted spectra bitwise (tests/test_torch_mdct.py)
and on the card the kernel bitwise (chip_smoke.py).  `mdct_fwd(frames,
win, wid)` runs the plain version on a CPU tensor and launches the
kernel on a CUDA tensor or raises; `mdct_fwd.launches` counts launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..native import PKG, build_library
from ..utils.scales import _TODB_BIAS, _TODB_SCALE
from .floor_cuda import NVCC_FLAGS, nvcc
from .mdct import (_imdct_index_tables, _mdct_forward_index_tables, cPI1_8,
                   cPI2_8, cPI3_8)
from .xla_f32 import add, fma, ftz, mul, sub

SOURCE = PKG / "csrc" / "mdct_fwd.cu"
f32 = np.float32
# todB(md) + .345 as XLA folds it: u*scale + (-bias + .345)
TODB_C345 = float(f32(f32(-_TODB_BIAS) + f32(0.345)))
TODB_SCALE = float(_TODB_SCALE)


def build() -> tuple[Path, str]:
    """Compile the kernel library unless this source's build exists.
    Returns (path, ptxas report); the report is empty when cached."""
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "libmdctfwd",
                         extra=("-Xptxas=-v",))


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_mdct_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_long, ctypes.c_int]
                   + [ctypes.c_void_p] * 2)
    return lib


def _check_n(n):
    if n < 64 or n > 8192 or n & (n - 1):
        raise ValueError(f"mdct_fwd: blocksize {n} (a power of two in "
                         f"64..8192)")


@lru_cache(maxsize=None)
def _plain_tables(n: int, device: torch.device) -> dict:
    """ops/mdct.py's forward and butterfly tables as tensors."""
    tb = _imdct_index_tables(n)
    tf = _mdct_forward_index_tables(n)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {k: dev(tf[k]) for k in ("a0", "a1", "a2", "a3", "s0", "s1",
                                   "tix")}
    out.update({k: dev(tb[k]) for k in ("T", "e0", "e1", "tC", "tD")})
    out["stages"] = [(P, dev(tc)) for P, tc in tb["stages"]]
    return out


def _bf8_xla(x, prod):
    """8-point tail on (..., 8); `prod` holds, for each of x0, x1, x4,
    x5 that is an unrounded product by cos(pi/4), its factor: the add or
    subtract it feeds fuses it."""
    c2 = float(cPI2_8)
    x0, x1, x2, x3, x4, x5, x6, x7 = (x[..., i] for i in range(8))

    def pm(i, j, sign):
        # x_i + sign * x_j with x_i, x_j both products: the first fused
        if prod is None:
            return add(x[..., i], x[..., j]) if sign > 0 else \
                sub(x[..., i], x[..., j])
        return fma(prod[i], c2, x[..., j] if sign > 0 else -x[..., j])

    r0 = add(x6, x2)
    r1 = sub(x6, x2)
    r2 = pm(4, 0, 1)
    r3 = pm(4, 0, -1)
    n6 = add(r0, r2)
    n4 = sub(r0, r2)
    s0 = pm(5, 1, -1)
    s2 = sub(x7, x3)
    n0 = add(r1, s0)
    n2 = sub(r1, s0)
    u0 = pm(5, 1, 1)
    u1 = add(x7, x3)
    n3 = add(s2, r3)
    n1 = sub(s2, r3)
    n7 = add(u1, u0)
    n5 = sub(u1, u0)
    return torch.stack([n0, n1, n2, n3, n4, n5, n6, n7], dim=-1)


def _bf16_xla(g, prod):
    """16-point tail on (..., 16) -> (..., 16), each half through
    _bf8_xla.  `prod` (or None): the factors of g2, g3, g10, g11, which
    are unrounded products by cos(pi/4) in the first half of _bf32."""
    c2 = float(cPI2_8)

    def gp(i, j, sign):
        if prod is None:
            return add(g[..., i], g[..., j]) if sign > 0 else \
                sub(g[..., i], g[..., j])
        return fma(prod[i], c2, g[..., j] if sign > 0 else -g[..., j])

    r0 = sub(g[..., 1], g[..., 9])
    r1 = sub(g[..., 0], g[..., 8])
    n8 = add(g[..., 8], g[..., 0])
    n9 = add(g[..., 9], g[..., 1])
    p0 = add(r0, r1)
    p1 = sub(r0, r1)
    n2 = gp(3, 11, -1)
    n3 = gp(10, 2, -1)
    n10 = gp(10, 2, 1)
    n11 = gp(11, 3, 1)
    r0c = sub(g[..., 12], g[..., 4])
    r1c = sub(g[..., 13], g[..., 5])
    n12 = add(g[..., 12], g[..., 4])
    n13 = add(g[..., 13], g[..., 5])
    p4 = sub(r0c, r1c)
    p5 = add(r0c, r1c)
    n6 = sub(g[..., 14], g[..., 6])
    n7 = sub(g[..., 15], g[..., 7])
    n14 = add(g[..., 14], g[..., 6])
    n15 = add(g[..., 15], g[..., 7])
    lo = torch.stack([mul(p0, c2), mul(p1, c2), n2, n3, mul(p4, c2),
                      mul(p5, c2), n6, n7], dim=-1)
    hi = torch.stack([n8, n9, n10, n11, n12, n13, n14, n15], dim=-1)
    return torch.cat([_bf8_xla(lo, {0: p0, 1: p1, 4: p4, 5: p5}),
                      _bf8_xla(hi, None)], dim=-1)


def _bf32_xla(x):
    """32-point butterfly tail (ops/mdct.py _bf32) on (..., 32) in
    XLA:CPU's per-output-position fusions."""
    c1, c2, c3 = float(cPI1_8), float(cPI2_8), float(cPI3_8)
    g = [x[..., i] for i in range(32)]
    y = [None] * 32
    y[30], y[31] = add(g[30], g[14]), add(g[31], g[15])
    y[14], y[15] = sub(g[30], g[14]), sub(g[31], g[15])
    r0b, r1b = sub(g[28], g[12]), sub(g[29], g[13])
    y[28], y[29] = add(g[28], g[12]), add(g[29], g[13])
    y[12] = fma(r0b, c1, -mul(r1b, c3))
    y[13] = fma(r0b, c3, mul(r1b, c1))
    r0c, r1c = sub(g[26], g[10]), sub(g[27], g[11])
    y[26], y[27] = add(g[26], g[10]), add(g[27], g[11])
    p10, p11 = sub(r0c, r1c), add(r0c, r1c)          # times c2
    r0d, r1d = sub(g[24], g[8]), sub(g[25], g[9])
    y[24], y[25] = add(g[24], g[8]), add(g[25], g[9])
    y[8] = fma(r0d, c3, -mul(r1d, c1))
    y[9] = fma(r1d, c3, mul(r0d, c1))                # positions 8-31
    y9_lo = fma(r0d, c1, mul(r1d, c3))               # positions 0-7
    y[22], y[23] = add(g[22], g[6]), add(g[23], g[7])
    y[6], y[7] = sub(g[7], g[23]), sub(g[22], g[6])
    r0f, r1f = sub(g[4], g[20]), sub(g[5], g[21])
    y[20], y[21] = add(g[20], g[4]), add(g[21], g[5])
    y[4] = fma(r1f, c1, mul(r0f, c3))
    y[5] = fma(r1f, c3, -mul(r0f, c1))
    r0g, r1g = sub(g[2], g[18]), sub(g[3], g[19])
    y[18], y[19] = add(g[18], g[2]), add(g[19], g[3])
    p2, p3 = add(r1g, r0g), sub(r1g, r0g)            # times c2
    r0h, r1h = sub(g[0], g[16]), sub(g[1], g[17])
    y[16], y[17] = add(g[16], g[0]), add(g[17], g[1])
    y[0] = fma(r1h, c3, mul(r0h, c1))
    y[1] = fma(r1h, c1, -mul(r0h, c3))
    y[2], y[3] = mul(p2, c2), mul(p3, c2)
    y[10], y[11] = mul(p10, c2), mul(p11, c2)
    prod = {2: p2, 3: p3, 10: p10, 11: p11}
    lo = torch.stack(y[:16], dim=-1)
    lo9 = torch.stack(y[:9] + [y9_lo] + y[10:16], dim=-1)
    hi = torch.stack(y[16:], dim=-1)
    a = _bf16_xla(lo9, prod)[..., :8]
    b = _bf16_xla(lo, prod)[..., 8:]
    return torch.cat([a, b, _bf16_xla(hi, None)], dim=-1)


def _windowed(frames, win, wid):
    x = ftz(frames)
    return mul(x, win if wid is None else win[wid.long()])


def mdct_fwd_plain(frames: torch.Tensor, win: torch.Tensor,
                   wid: torch.Tensor | None = None):
    """(md, logmdct), each (..., n/2) float32, of frames (..., n) float32
    windowed by `win` (n,) or, with `wid` (...,) window ids, by the rows
    `win[wid]` of `win` (k, n).  The op order and the fused multiply-adds
    of XLA:CPU's compile of the JAX package's spectra (module doc)."""
    n = frames.shape[-1]
    _check_n(n)
    tbl = _plain_tables(n, frames.device)
    T = tbl["T"]
    n2, n4 = n >> 1, n >> 2
    x = _windowed(frames, win, wid)
    r0 = add(tbl["s0"] * x[..., tbl["a0"]], tbl["s1"] * x[..., tbl["a1"]])
    r1 = add(tbl["s0"] * x[..., tbl["a2"]], tbl["s1"] * x[..., tbl["a3"]])
    Tc = T[tbl["tix"]]
    Ts = T[tbl["tix"] + 1]
    w_e = fma(r1, Ts, mul(r0, Tc))
    w_o = fma(r1, Tc, -mul(r0, Ts))
    y = torch.stack([w_e, w_o], dim=-1).reshape(x.shape[:-1] + (n2,))

    for P, tc in tbl["stages"]:
        nblk = n2 // P
        yv = y.reshape(y.shape[:-1] + (nblk, P))
        lo = yv[..., :P // 2]
        hi = yv[..., P // 2:]
        new_hi = add(hi, lo)
        rr0 = sub(hi[..., 0::2], lo[..., 0::2])
        rr1 = sub(hi[..., 1::2], lo[..., 1::2])
        Tcs = T[tc]
        Tss = T[tc + 1]
        lo_e = fma(rr1, Tss, mul(rr0, Tcs))
        lo_o = fma(rr1, Tcs, -mul(rr0, Tss))
        new_lo = torch.stack([lo_e, lo_o], dim=-1).reshape(lo.shape)
        y = torch.cat([new_lo, new_hi], dim=-1).reshape(y.shape)
    y = _bf32_xla(y.reshape(y.shape[:-1] + (n2 // 32, 32))) \
        .reshape(y.shape)

    a0v = y[..., tbl["e0"]]
    a1v = y[..., tbl["e0"] + 1]
    b0v = y[..., tbl["e1"]]
    b1v = y[..., tbl["e1"] + 1]
    Tc = T[tbl["tC"]]
    Ts = T[tbl["tC"] + 1]
    rr0 = sub(a1v, b1v)
    rr1 = add(a0v, b0v)
    rr2 = fma(rr1, Tc, mul(rr0, Ts))
    rr3 = fma(rr1, Ts, -mul(rr0, Tc))
    s = add(a1v, b1v)
    t = sub(a0v, b0v)
    lo = torch.stack([fma(0.5, s, rr2), fma(0.5, t, rr3)], dim=-1) \
        .reshape(y.shape[:-1] + (n4,))
    hi = torch.stack([fma(0.5, s, -rr2), fma(-0.5, t, rr3)], dim=-1)
    hi = hi.flip(-2).reshape(y.shape[:-1] + (n4,))
    w = torch.cat([lo, hi], dim=-1)

    scale = float(4.0 / n)
    w0 = w[..., 0::2]
    w1 = w[..., 1::2]
    Tc = T[tbl["tD"]]
    Ts = T[tbl["tD"] + 1]
    front = mul(fma(w0, Tc, mul(w1, Ts)), scale)
    back = mul(fma(w0, Ts, -mul(w1, Tc)), scale)
    md = torch.cat([front, back.flip(-1)], dim=-1)
    return md, log_spectrum_plain(md)


def todB_u(md: torch.Tensor) -> torch.Tensor:
    """|md|'s bits as a float32 (todB's integer), exactly."""
    return (md.view(torch.int32) & 0x7FFFFFFF).to(torch.float32)


def log_spectrum_plain(md: torch.Tensor) -> torch.Tensor:
    """todB(md) + .345 as one fma, the constants folded (module doc)."""
    return fma(todB_u(md), TODB_SCALE, TODB_C345)


class MdctFwdKernel:
    """`self(frames, win, wid=None)` -> (md, logmdct) of frames (R, n)
    float32, as mdct_fwd_plain: on a CPU tensor the plain version; on a
    CUDA tensor one launch of csrc/mdct_fwd.cu on the current stream, or
    an exception.  `wid` (R,) ids must index rows of `win` (k, n): the
    kernel does not check them.  `launches` counts the kernel's
    launches (and nothing else)."""

    def __init__(self):
        self.launches = 0

    @staticmethod
    @lru_cache(maxsize=None)
    def table(n: int, device: torch.device) -> torch.Tensor:
        """ops/mdct.py's trig table T (n + n/4 floats) on `device`."""
        T = np.asarray(_imdct_index_tables(n)["T"], np.float32)
        return torch.from_numpy(np.ascontiguousarray(T)).to(device)

    def __call__(self, frames: torch.Tensor, win: torch.Tensor,
                 wid: torch.Tensor | None = None):
        n = frames.shape[-1]
        _check_n(n)
        if frames.device.type == "cpu":
            return mdct_fwd_plain(frames, win, wid)
        if frames.device.type != "cuda":
            raise ValueError(f"mdct_fwd: unsupported device {frames.device}")
        if frames.dim() != 2 or frames.dtype != torch.float32 \
                or not frames.is_contiguous():
            raise ValueError(f"mdct_fwd: frames must be a contiguous "
                             f"float32 (R, n) tensor, got "
                             f"{tuple(frames.shape)} {frames.dtype}")
        want = (n,) if wid is None else (win.shape[0], n)
        if (win.dtype != torch.float32 or not win.is_contiguous()
                or tuple(win.shape) != want or win.device != frames.device):
            raise ValueError(f"mdct_fwd: win must be a contiguous float32 "
                             f"{want} tensor on {frames.device}")
        R = frames.shape[0]
        if wid is not None:
            if wid.shape != (R,) or wid.device != frames.device:
                raise ValueError(f"mdct_fwd: wid must be ({R},) on "
                                 f"{frames.device}")
            wid = wid.to(torch.int32).contiguous()
        # the kernel copies frames and reads windows 16 bytes at a time
        if frames.data_ptr() % 16:
            frames = frames.clone()
        if win.data_ptr() % 16:
            win = win.clone()
        md = torch.empty((R, n // 2), dtype=torch.float32,
                         device=frames.device)
        lm = torch.empty_like(md)
        if R == 0:
            return md, lm
        rc = load_library().vtt_mdct_fwd(
            frames.data_ptr(), win.data_ptr(),
            None if wid is None else wid.data_ptr(), md.data_ptr(),
            lm.data_ptr(), R, n, self.table(n, frames.device).data_ptr(),
            torch.cuda.current_stream(frames.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mdct_fwd kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        return md, lm


mdct_fwd = MdctFwdKernel()
