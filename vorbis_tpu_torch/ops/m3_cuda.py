"""M3 tempmdct scan as a hand-written Hopper kernel (counterpart of the
`lax.scan` in vorbis_tpu/ops/psydevice.py:498 m3_tempmdct_scan).

The scan carries each (channel, bin) column's echo buffer from short
frame to short frame; the spread of frame f reads only the frame's own
log spectrum and the column's pre-update carry, so no carry crosses
columns.  A frame with sw and reset starts its buffer from lastmdct
alone, so the batch splits there into independent segments (the first
at frame 0, carry zero).  `csrc/m3_scan.cu` runs one block per
(segment, channel) and one thread per bin: the block of a frame that
starts no segment exits at once, every other walks its segment's frames
in order, with a ring of frames staged in shared memory.  Per frame the
spread's compares (all against the pre-update buffer) are counted and
the count's increments then land one by one; `spread_table` gives the
kernel each column's products `cell[t-j] * j`, rounded once.  The
kernel reads the per-frame parameters as the caller holds them (sw and
reset bool rows, noise_center a float32 row), so a call on the main path
is one launch.  Eager PyTorch would issue the plain version's ~80 small
kernels per frame.
The library is compiled by nvcc at first use into build/vorbis_tpu_torch/
(keyed by a hash of the source and flags, vorbis_tpu_torch.native) and
bound with ctypes.  On a CUDA tensor the kernel is the only path: a
failed build or launch raises.  On a CPU tensor the plain version
(psydevice.m3_tempmdct_scan) runs.
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


def spread_table(look) -> np.ndarray:
    """The kernel's static table, (maxnb, n) float32.  Row j - 1
    (j = 1..maxnb-1) holds, at target bin t, the plain version's
    `m3_cellj[j - 1, t - j]` (cell[t-j] * j rounded once) where the
    shift applies (j <= t and j < bfn[t-j]) and +inf where it does not:
    lm - inf is -inf (or NaN), below no buffer, so the shift never
    adds.  The last row holds incr[t]."""
    bfn, cell, incr, _ = m3_tables(look)
    n = look.n
    js = np.arange(1, int(bfn.max()))[:, None]
    src = np.arange(n)[None, :] - js                 # the shift's source
    srcc = np.clip(src, 0, None)
    prod = (cell[srcc] * js.astype(np.float32)).astype(np.float32)
    ok = (src >= 0) & (js < bfn[srcc])
    thr = np.where(ok, prod, np.float32(np.inf)).astype(np.float32)
    return np.concatenate([thr, incr[None, :].astype(np.float32)])


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_m3_scan
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
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
        if self.n not in (128, 256):
            raise ValueError(f"m3 scan kernel: n={self.n}, built for 128 "
                             f"and 256 (freq_bfn128/256)")
        bfn, _, _, base = m3_tables(look)
        self.maxnb = int(bfn.max())
        self.base = float(base)
        self.tabs = device_tables({"tabs": spread_table(look)},
                                  self.device)["tabs"]
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
            if t.data_ptr() % 16:
                raise ValueError(f"m3 scan: {name} is not 16-byte aligned "
                                 f"(the kernel stages rows 16 bytes a copy)")
        if lastmdct.shape[-1] < n or lastmdct.shape[-1] % 4:
            raise ValueError("m3 scan: lastmdct rows shorter than n or not "
                             "a multiple of 4 floats")
        rows = self.param_rows(params, F)
        out = torch.empty((F, ch, n), dtype=torch.float32, device=dev)
        if F == 0:
            return out
        self.launch(logmdct, lastmdct, val, tval, *rows, out)
        return out

    def param_rows(self, params, F):
        """(sw, reset, noise_center) as the kernel reads them: (F,)
        bool, bool and float32 rows on the device, contiguous and 4-byte
        aligned (the kernel stages the aligned word that holds a frame's
        flag).  The main path's rows already are: no copy, no launch."""
        rows = []
        for key, dtype in (("sw", torch.bool), ("reset", torch.bool),
                           ("noise_center", torch.float32)):
            r = params[key]
            if r.device != self.tabs.device or tuple(r.shape) != (F,):
                raise ValueError(f"m3 scan: params[{key!r}] must be (F,) "
                                 f"= ({F},) on {self.tabs.device}, got "
                                 f"{tuple(r.shape)} on {r.device}")
            r = r.to(dtype).contiguous()
            rows.append(r.clone() if r.data_ptr() % 4 else r)
        return rows

    def launch(self, logmdct, lastmdct, val, tval, sw, reset, ncen, out):
        """One launch on checked tensors: the rows of param_rows, out
        (F, ch, n).  __call__ checks and allocates; a timing loop calls
        this alone."""
        F, ch, n = logmdct.shape
        rc = load_library().vtt_m3_scan(
            logmdct.data_ptr(), lastmdct.data_ptr(), val.data_ptr(),
            tval.data_ptr(), sw.data_ptr(), reset.data_ptr(),
            ncen.data_ptr(), self.tabs.data_ptr(), out.data_ptr(), F, ch,
            n, lastmdct.shape[-1], self.maxnb, self.base,
            torch.cuda.current_stream(out.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"m3_scan kernel launch failed: cudaError "
                               f"{rc}")
        self.launches += 1

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
