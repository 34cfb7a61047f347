"""Batched IMDCT as a hand-written Hopper kernel (counterpart of the
jitted `imdct(s, n, xp=jnp)` of vorbis_tpu/models/fastdec.py:210, the
transform of vorbis_tpu/ops/mdct.py:261).

`csrc/imdct.cu` runs libvorbis's mdct_backward on float32 rows read
through a row table (each row's n/2 floats at an element offset of one
spectra buffer), persistent CTAs whose warps own whole rows, the trig
table and stage B's twiddles staged once a CTA in shared memory, the
next rows' spectra staged by cp.async while the current ones compute,
every product and sum an explicit round-to-nearest intrinsic in the C's
operand order (nvcc -fmad=false as well): its output equals the host C
(`native.imdct_batch`, vn_imdct_batch) and the numpy `ops.mdct.imdct`
bit for bit, at every blocksize 64-8192.  `imdct_plain` is the same
transform in eager PyTorch: each op rounds once, so on the CPU it too
equals the numpy transform bitwise, and the tests hold it there.

`imdct(spec, n)` -> (R, n) and `imdct(spec, n, rows=offsets, out=...)`
are the wrapper's two forms: on a CPU tensor it runs `imdct_plain`; on a
CUDA tensor it launches the kernel or raises (no fall-back).
`imdct.launches` counts the kernel's launches and nothing else.  The
library is compiled by nvcc at first use into build/vorbis_tpu_torch/
(keyed by a hash of the source and flags, vorbis_tpu_torch.native) and
bound with ctypes.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..native import PKG, build_library
from .floor_cuda import NVCC_FLAGS, nvcc
from .mdct import _bf32, _imdct_index_tables

SOURCE = PKG / "csrc" / "imdct.cu"


def build() -> tuple[Path, str]:
    """Compile the kernel library unless this source's build exists.
    Returns (path, ptxas report); the report is empty when cached."""
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "libimdct",
                         extra=("-Xptxas=-v",))


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_imdct
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)
    return lib


class _TorchXp:
    """The two array functions ops/mdct.py's butterfly tails call through
    `xp`, for torch tensors."""

    @staticmethod
    def stack(ts, axis):
        return torch.stack(ts, dim=axis)

    @staticmethod
    def concatenate(ts, axis):
        return torch.cat(ts, dim=axis)


def _check_n(n):
    if n < 64 or n > 8192 or n & (n - 1):
        raise ValueError(f"imdct: blocksize {n} (a power of two in "
                         f"64..8192)")


@lru_cache(maxsize=None)
def _plain_tables(n: int, device: torch.device) -> dict:
    """ops/mdct.py's index and trig tables as tensors on `device`."""
    tbl = _imdct_index_tables(n)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {k: dev(tbl[k]) for k in ("T", "ia", "ib", "ta", "tb", "sa",
                                    "sb", "e0", "e1", "tC", "tD")}
    out["stages"] = [(P, dev(tc)) for P, tc in tbl["stages"]]
    return out


def imdct_plain(spec: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse MDCT, batched: spec (..., n//2) float32 -> (..., n).  A
    transcription of vorbis_tpu_torch/ops/mdct.py imdct (the reference's
    mdct_backward) into eager PyTorch on spec's device: the same gathers
    and elementwise ops in the same order, each rounded once."""
    _check_n(n)
    tbl = _plain_tables(n, spec.device)
    T = tbl["T"]
    n2, n4 = n >> 1, n >> 2
    x = spec

    # stage A: pre-rotation
    y = (tbl["sa"] * x[..., tbl["ia"]] * T[tbl["ta"]]
         + tbl["sb"] * x[..., tbl["ib"]] * T[tbl["tb"]])

    # stage B: butterfly cascade
    for P, tc in tbl["stages"]:
        nblk = n2 // P
        yv = y.reshape(y.shape[:-1] + (nblk, P))
        lo = yv[..., :P // 2]
        hi = yv[..., P // 2:]
        new_hi = hi + lo
        r0 = hi[..., 0::2] - lo[..., 0::2]
        r1 = hi[..., 1::2] - lo[..., 1::2]
        Tc = T[tc]
        Ts = T[tc + 1]
        lo_e = r1 * Ts + r0 * Tc
        lo_o = r1 * Tc - r0 * Ts
        new_lo = torch.stack([lo_e, lo_o], dim=-1).reshape(lo.shape)
        y = torch.cat([new_lo, new_hi], dim=-1).reshape(y.shape)
    nblk = n2 // 32
    y = _bf32(y.reshape(y.shape[:-1] + (nblk, 32)), _TorchXp) \
        .reshape(y.shape)

    # stage C: bitreverse + half-angle rotation
    half = np.float32(0.5)
    a0 = y[..., tbl["e0"]]
    a1 = y[..., tbl["e0"] + 1]
    b0 = y[..., tbl["e1"]]
    b1 = y[..., tbl["e1"] + 1]
    Tc = T[tbl["tC"]]
    Ts = T[tbl["tC"] + 1]
    r0 = a1 - b1
    r1 = a0 + b0
    r2 = r1 * Tc + r0 * Ts
    r3 = r1 * Ts - r0 * Tc
    r0h = half * (a1 + b1)
    r1h = half * (a0 - b0)
    lo = torch.stack([r0h + r2, r1h + r3], dim=-1) \
        .reshape(y.shape[:-1] + (n4,))
    # upper half is written top-down in complex pairs: reverse pair order
    # but keep (even, odd) order within each pair
    hi = torch.stack([r0h - r2, r3 - r1h], dim=-1)        # (..., n8, 2)
    hi = hi.flip(-2).reshape(y.shape[:-1] + (n4,))
    z = torch.cat([lo, hi], dim=-1)

    # stage D: final rotation + symmetric expansion
    z0 = z[..., 0::2]
    z1 = z[..., 1::2]
    Tc = T[tbl["tD"]]
    Ts = T[tbl["tD"] + 1]
    a = z0 * Ts - z1 * Tc
    b = -(z0 * Tc + z1 * Ts)
    return torch.cat([a.flip(-1), -a, b.flip(-1), b], dim=-1)


class ImdctKernel:
    """`self(spec, n)`: the IMDCT of (R, n/2) float32 rows -> (R, n);
    `self(spec, n, rows=offsets, out=None)`: of the rows at the element
    offsets `offsets` (an int64 numpy array, multiples of 4) of the 1-D
    float32 `spec`, into `out` (R, n) when given.  On a CPU tensor the
    plain version; on a CUDA tensor one launch of csrc/imdct.cu on the
    current stream, or an exception.  `launches` counts the kernel's
    launches (and nothing else)."""

    def __init__(self):
        self.launches = 0

    @staticmethod
    @lru_cache(maxsize=None)
    def tables(n: int, device: torch.device) -> dict:
        """The kernel's tables for blocksize n on `device`, made once: the
        trig table T (n + n/4 floats) and stage B's twiddles, stage after
        stage, (T[tc], T[tc + 1]) for each butterfly index m of a stage
        (n/2 - 32 floats; one unused float at n = 64)."""
        tbl = _imdct_index_tables(n)
        T = np.asarray(tbl["T"], np.float32)
        tw = [np.stack([T[tc], T[tc + 1]], axis=1).reshape(-1)
              for _, tc in tbl["stages"]]
        arrs = dict(T=T, tw=(np.concatenate(tw) if tw
                             else np.zeros(1, np.float32)))
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in arrs.items()}

    def __call__(self, spec: torch.Tensor, n: int, rows=None, out=None,
                 rows_dev=None) -> torch.Tensor:
        """`rows_dev`, the offsets already on the card, saves their copy."""
        _check_n(n)
        n2 = n // 2
        if rows is None:
            if spec.dim() != 2 or spec.shape[1] != n2:
                raise ValueError(f"imdct: spec must be (R, {n2}), got "
                                 f"{tuple(spec.shape)}")
            R = spec.shape[0]
            offs = None
        else:
            offs = np.ascontiguousarray(rows, np.int64).reshape(-1)
            R = len(offs)
            if spec.dim() != 1:
                raise ValueError("imdct: with rows, spec must be 1-D")
            if R and (offs.min() < 0 or offs.max() + n2 > spec.numel()
                      or (offs & 3).any()):
                raise ValueError("imdct: row offsets must be multiples of "
                                 "4 with every row inside spec")
        if spec.device.type == "cpu":
            x = spec if offs is None else spec[
                torch.from_numpy(offs)[:, None] + torch.arange(n2)]
            got = imdct_plain(x, n)
            if out is None:
                return got
            out.copy_(got)
            return out
        if spec.device.type != "cuda":
            raise ValueError(f"imdct: unsupported device {spec.device}")
        if spec.dtype != torch.float32 or not spec.is_contiguous():
            raise ValueError(f"imdct: spec must be contiguous float32, got "
                             f"{spec.dtype}")
        if out is None:
            out = torch.empty((R, n), dtype=torch.float32,
                              device=spec.device)
        elif (out.shape != (R, n) or out.dtype != torch.float32
              or not out.is_contiguous() or out.device != spec.device
              or out.data_ptr() % 16):
            raise ValueError(f"imdct: out must be a 16-byte aligned "
                             f"contiguous float32 ({R}, {n}) tensor on "
                             f"{spec.device}")
        if R == 0:
            return out
        if offs is None:
            offs_dev = torch.arange(R, dtype=torch.int64,
                                    device=spec.device) * n2
        elif rows_dev is None:
            offs_dev = torch.from_numpy(offs).to(spec.device)
        else:
            offs_dev = rows_dev
        if spec.data_ptr() % 16:
            raise ValueError("imdct: spec must be 16-byte aligned")
        tabs = self.tables(n, spec.device)
        rc = load_library().vtt_imdct(
            spec.data_ptr(), offs_dev.data_ptr(), out.data_ptr(), R, n,
            tabs["T"].data_ptr(), tabs["tw"].data_ptr(),
            torch.cuda.current_stream(spec.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"imdct kernel launch failed: cudaError {rc}")
        self.launches += 1
        return out


imdct = ImdctKernel()
