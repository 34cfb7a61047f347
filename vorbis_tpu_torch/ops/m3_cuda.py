"""M3 tempmdct scan as a hand-written Hopper kernel (counterpart of the
`lax.scan` in vorbis_tpu/ops/psydevice.py:498 m3_tempmdct_scan).

The scan carries each (channel, bin) column's echo buffer from short
frame to short frame; the spread of frame f reads only the frame's own
log spectrum and the column's pre-update carry, so no carry crosses
columns.  `csrc/m3_scan.cu` runs one thread per column and loops over
the frames in order (one block per channel), with the frames' rows
staged in shared memory; eager PyTorch would issue the plain version's
~80 small kernels per frame.  The library is compiled by nvcc at first
use into build/vorbis_tpu_torch/ (keyed by a hash of the source and
flags, vorbis_tpu_torch.native) and bound with ctypes.  On a CUDA tensor
the kernel is the only path: a failed build or launch raises.  On a CPU
tensor the plain version (psydevice.m3_tempmdct_scan) runs.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..convert import device_tables
from ..native import PKG, build_library
from .floor_cuda import NVCC_FLAGS, nvcc
from .psydevice import m3_tables, m3_tempmdct_scan

SOURCE = PKG / "csrc" / "m3_scan.cu"


def build() -> tuple[Path, str]:
    """Compile the kernel library unless this source's build exists.
    Returns (path, ptxas report); the report is empty when cached."""
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "libm3scan",
                         extra=("-Xptxas=-v",))


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_m3_scan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    return lib


class M3Scan:
    """The scan of one short look: `scan(logmdct, lastmdct, val, tval,
    params)` -> tempmdct (F, ch, n), the plain version on any tensor."""

    def __init__(self, look, device):
        self.look = look
        self.device = torch.device(device)
        self.n = look.n

    def __call__(self, logmdct, lastmdct, val, tval, params):
        return m3_tempmdct_scan(self.look, logmdct, lastmdct, val, tval,
                                params)


class M3ScanCuda(M3Scan):
    """M3Scan whose scan is the CUDA kernel on a CUDA tensor.
    `launches` counts kernel launches (and nothing else)."""

    def __init__(self, look, device):
        super().__init__(look, device)
        bfn, cell, incr, base = m3_tables(look)
        self.maxnb = int(bfn.max())
        self.base = float(base)
        tabs = np.stack([bfn.astype(np.float32), cell, incr])
        self.tabs = device_tables({"tabs": tabs}, self.device)["tabs"]
        self.launches = 0

    def __call__(self, logmdct, lastmdct, val, tval, params):
        if logmdct.device.type == "cpu":
            return super().__call__(logmdct, lastmdct, val, tval, params)
        if logmdct.device.type != "cuda":
            raise ValueError(f"m3 scan: unsupported device {logmdct.device}")
        F, ch, n = logmdct.shape
        dev = self.tabs.device
        if n != self.n:
            raise ValueError(f"m3 scan: n={n}, expected {self.n}")
        for name, t, shape in (("logmdct", logmdct, (F, ch, n)),
                               ("val", val, (F, ch, n)),
                               ("tval", tval, (F, ch, n)),
                               ("lastmdct", lastmdct,
                                (F, ch, lastmdct.shape[-1]))):
            if (t.device != dev or t.dtype != torch.float32
                    or tuple(t.shape) != shape):
                raise ValueError(
                    f"m3 scan: {name} must be float32 {shape} on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"m3 scan: {name} is not contiguous")
        if lastmdct.shape[-1] < n:
            raise ValueError("m3 scan: lastmdct rows shorter than n")
        # per-frame scalars [sw, reset, noise_center] as (3, F) float32
        prm = torch.stack([params["sw"].to(torch.float32),
                           params["reset"].to(torch.float32),
                           params["noise_center"].to(torch.float32)])
        if prm.device != dev or tuple(prm.shape) != (3, F):
            raise ValueError(f"m3 scan: params must be (F,) on {dev}")
        out = torch.empty((F, ch, n), dtype=torch.float32, device=dev)
        if F == 0:
            return out
        rc = load_library().vtt_m3_scan(
            logmdct.data_ptr(), lastmdct.data_ptr(), val.data_ptr(),
            tval.data_ptr(), prm.data_ptr(), self.tabs.data_ptr(),
            out.data_ptr(), F, ch, n, lastmdct.shape[-1], self.maxnb,
            self.base, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"m3_scan kernel launch failed: cudaError "
                               f"{rc}")
        self.launches += 1
        return out

    def plain(self, logmdct, lastmdct, val, tval, params):
        """The plain PyTorch version on the same tensors (for checks)."""
        return M3Scan.__call__(self, logmdct, lastmdct, val, tval, params)


def make_m3_scan(look, device):
    """The CUDA kernel for a CUDA device, the plain version for the
    CPU.  Both produce bitwise-identical tempmdct."""
    device = torch.device(device)
    if device.type == "cuda":
        return M3ScanCuda(look, device)
    if device.type == "cpu":
        return M3Scan(look, device)
    raise ValueError(f"no m3 scan for device {device}")
