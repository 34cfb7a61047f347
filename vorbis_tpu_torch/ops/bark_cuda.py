"""Both passes of the encoder's bark noise fit as a hand-written Hopper
kernel (counterpart of the two `bark_fit` calls inside the jitted
`DeviceAnalysis.spectra` of vorbis_tpu/ops/jaxdsp.py:273-284; reference
lib/psy.c bark_noise_hybridmp and _vp_noisemask).

`csrc/bark_fit.cu` takes a row's MDCT `md` (n/2 floats) and returns the
first fit `fit1` and the clipped compand index `dB`, rounding as XLA:CPU
compiles the JAX spectra (ops/xla_f32.py):

- pass 1 reads y = max(todB(md) + .345 + 140, 1) as one fma with the
  three constants folded (XLA folds `(x + c1) + c2`); the logmdct that
  pass 2 and fit1 subtract from is the fma with .345 alone
  (ops/mdct_cuda.py);
- the five prefix sums (N, X, XX, Y, XY) add in `jnp.cumsum`'s CPU
  order, blocks of 16 summed in turn, the block totals scanned the same
  way, each block's exclusive prefix added last (xla_f32.block_cumsum;
  every value summed is 0 or at least 1/2, so no sum is subnormal);
- the line-fit terms: A = fma(tY, tXX, -(tX*tXY)) and B = fma(tN, tXY,
  -(tX*tY)) everywhere; D = tN*tXX - tX*tX fuses tN*tXX, except in a
  reflected low region of at most 8 bins, where the square is fused:
  fma(-tX, tX, tN*tXX).  Measured on every region size the modes make:
  4 and 8 bins (the 256- and 512-sample short blocks) fuse the square,
  11, 21 and 50 bins do not.  Then (A + x*B) / D as fma(x, B, A) and an
  IEEE division;
- pass 1's mask is max(R, 0) - 140, work = logmdct - mask, pass 2 fits
  max(work, 1) with the fixed-window minimum (offset 0, so no
  subtraction), fit1 = logmdct - work, dB = clip(int(mask2 + .5), 0, 39).

`bark_fit_plain` is the same order in eager PyTorch (on the CPU it
equals the JAX package's jitted spectra bitwise, tests/test_torch_mdct.py;
on the card the kernel, chip_smoke.py).  `bark_fit(md, tabs)` with one
DeviceAnalysis's region tables (`bark_tables`) runs the plain version on
a CPU tensor and launches the kernel on a CUDA tensor or raises;
`bark_fit.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..native import PKG, build_library
from .floor_cuda import NVCC_FLAGS, nvcc
from .mdct_cuda import TODB_C345, TODB_SCALE, log_spectrum_plain, todB_u
from .xla_f32 import add, block_cumsum, div, fma, mul, sub, to_int32

SOURCE = PKG / "csrc" / "bark_fit.cu"
f32 = np.float32
# todB(md) + .345 + 140, folded as XLA folds it
TODB_C140 = float(f32(f32(TODB_C345) + f32(140.0)))
NOISE_COMPAND_LEVELS = 40
# a reflected low region of at most this many bins fuses D's square
SQUARE_FUSED_MAX = 8


def build() -> tuple[Path, str]:
    """Compile the kernel library unless this source's build exists.
    Returns (path, ptxas report); the report is empty when cached."""
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "libbarkfit",
                         extra=("-Xptxas=-v",))


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_bark_fit
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_long]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def _terms(P, lo, hi, neg):
    """The line-fit terms (A, B, D) of the bins with windows [lo, hi]
    from the prefix sums P = (N, X, XX, Y, XY); `neg` for the reflected
    low region (jaxdsp._ls_terms), whose D fuses the square when the
    region holds at most SQUARE_FUSED_MAX bins (module doc)."""
    N, X, XX, Y, XY = P
    if neg:
        tN = add(N[..., hi], N[..., -lo])
        tX = sub(X[..., hi], X[..., -lo])
        tXX = add(XX[..., hi], XX[..., -lo])
        tY = add(Y[..., hi], Y[..., -lo])
        tXY = sub(XY[..., hi], XY[..., -lo])
        D = (fma(-tX, tX, mul(tN, tXX)) if len(lo) <= SQUARE_FUSED_MAX
             else fma(tN, tXX, -mul(tX, tX)))
    else:
        tN = sub(N[..., hi], N[..., lo])
        tX = sub(X[..., hi], X[..., lo])
        tXX = sub(XX[..., hi], XX[..., lo])
        tY = sub(Y[..., hi], Y[..., lo])
        tXY = sub(XY[..., hi], XY[..., lo])
        D = fma(tN, tXX, -mul(tX, tX))
    A = fma(tY, tXX, -mul(tX, tXY))
    B = fma(tN, tXY, -mul(tX, tY))
    return A, B, D


def _fit(P, lo, hi, k1, k2, n):
    """R = (A + x*B) / D over every bin: regions [0, k1) reflected,
    [k1, k2) plain, the last plain fit extrapolated across [k2, n)."""
    A1, B1, D1 = _terms(P, lo[:k1], hi[:k1], True)
    A2, B2, D2 = _terms(P, lo[k1:k2], hi[k1:k2], False)
    A, B, D = (torch.cat(t, -1) for t in ((A1, A2), (B1, B2), (D1, D2)))
    if k2 < n:
        tail = A.shape[:-1] + (n - k2,)
        if k2 > 0:
            A, B, D = (torch.cat([t, t[..., k2 - 1:k2].expand(tail)], -1)
                       for t in (A, B, D))
        else:
            z = A.new_zeros(tail)
            A, B, D = (torch.cat([A, z], -1), torch.cat([B, z], -1),
                       torch.cat([D, torch.ones_like(z)], -1))
    x = torch.arange(n, dtype=torch.float32, device=A.device)
    return div(fma(x, B, A), D)


def _prefix(y):
    """The five prefix sums of one pass on y (..., n) (>= 1)."""
    n = y.shape[-1]
    x = torch.arange(n, dtype=torch.float32, device=y.device)
    w = mul(y, y)
    w0_half = mul(w[..., :1], 0.5)
    wx = mul(w, x)
    wxx = mul(wx, x)
    wy = mul(w, y)
    wxy = mul(wx, y)
    zero = torch.zeros_like(w0_half)
    return tuple(block_cumsum(torch.cat([h, t[..., 1:]], -1)) for h, t in
                 ((w0_half, w), (w0_half, wx), (zero, wxx),
                  (mul(w0_half, y[..., :1]), wy), (zero, wxy)))


def bark_fit_plain(md: torch.Tensor, tabs: dict):
    """(fit1 float32, dB int32), each (..., n/2), of the MDCT rows md
    (..., n/2), in XLA:CPU's order (module doc); tabs from bark_tables."""
    n = md.shape[-1]
    dev = md.device
    u = todB_u(md)
    lm = log_spectrum_plain(md)
    lo, hi = tabs["bark_lo"], tabs["bark_hi"]
    # pass 1: the wide bark window at offset 140
    y1 = torch.clamp_min(fma(u, TODB_SCALE, TODB_C140), 1.0)
    R = _fit(_prefix(y1), lo, hi, tabs["i1"], tabs["i2"], n)
    mask = add(torch.clamp_min(R, 0.0), -140.0)
    work = sub(lm, mask)
    # pass 2: the residual, offset 0, with the fixed-window minimum
    P2 = _prefix(torch.clamp_min(work, 1.0))
    mask2 = torch.clamp_min(_fit(P2, lo, hi, tabs["i1"], tabs["i2"], n),
                            0.0)
    fixed = tabs["fixed"]
    if fixed > 0:
        idx = torch.arange(n, device=dev)
        hi_f = torch.clamp_max(idx + fixed // 2, n - 1)
        lo_f = idx + fixed // 2 - fixed
        Rf = _fit(P2, lo_f, hi_f, tabs["j1"], tabs["j2"], n)
        mask2 = torch.minimum(mask2, torch.clamp_min(Rf, 0.0))
    fit1 = sub(lm, work)
    return fit1, torch.clamp(to_int32(add(mask2, 0.5)), 0,
                             NOISE_COMPAND_LEVELS - 1)


def bark_tables(bark_lo, bark_hi, i1, i2, j1, j2, fixed, device) -> dict:
    """One DeviceAnalysis's region tables for the fit: the bark windows
    (numpy, int) as long tensors for the plain version and int32 ones for
    the kernel, the region bounds and the fixed window's width."""
    t = dict(i1=int(i1), i2=int(i2), j1=int(j1), j2=int(j2),
             fixed=int(fixed))
    for k, v in (("bark_lo", bark_lo), ("bark_hi", bark_hi)):
        v = np.ascontiguousarray(v)
        t[k] = torch.from_numpy(v.astype(np.int64)).to(device)
        t[k + "32"] = torch.from_numpy(v.astype(np.int32)).to(device)
    return t


class BarkFitKernel:
    """`self(md, tabs)` -> (fit1, dB) of the MDCT rows md (R, n/2) float32
    with the region tables `tabs` (bark_tables), as bark_fit_plain: on a
    CPU tensor the plain version; on a CUDA tensor one launch of
    csrc/bark_fit.cu on the current stream, or an exception.
    `launches` counts the kernel's launches (and nothing else)."""

    MAX_N2 = 4096

    def __init__(self):
        self.launches = 0

    def __call__(self, md: torch.Tensor, tabs: dict):
        if md.device.type == "cpu":
            return bark_fit_plain(md, tabs)
        if md.device.type != "cuda":
            raise ValueError(f"bark_fit: unsupported device {md.device}")
        if md.dim() != 2 or md.dtype != torch.float32 \
                or not md.is_contiguous():
            raise ValueError(f"bark_fit: md must be a contiguous float32 "
                             f"(R, n/2) tensor, got {tuple(md.shape)} "
                             f"{md.dtype}")
        R, n2 = md.shape
        lo, hi = tabs["bark_lo32"], tabs["bark_hi32"]
        if not 0 < n2 <= self.MAX_N2 or lo.shape != (n2,) \
                or hi.shape != (n2,) or lo.device != md.device:
            raise ValueError(f"bark_fit: n/2 = {n2} (at most "
                             f"{self.MAX_N2}) with ({n2},) tables on "
                             f"{md.device}")
        fit1 = torch.empty_like(md)
        dB = torch.empty((R, n2), dtype=torch.int32, device=md.device)
        if R == 0:
            return fit1, dB
        rc = load_library().vtt_bark_fit(
            md.data_ptr(), lo.data_ptr(), hi.data_ptr(), fit1.data_ptr(),
            dB.data_ptr(), R, n2, tabs["i1"], tabs["i2"], tabs["j1"],
            tabs["j2"], tabs["fixed"],
            torch.cuda.current_stream(md.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"bark_fit kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        return fit1, dB


bark_fit = BarkFitKernel()
