"""The floor1 fit as two hand-written Hopper kernels: the greedy fit
(counterpart of vorbis_tpu/ops/floor_pallas.py) and its prepare
(counterpart of the jitted quantization and `_moments` around it,
vorbis_tpu/ops/floor_device.py:114-145 and :199-208).

`csrc/floor_fit.cu` runs the greedy loop + final walk of
`DeviceFloorFit.fit` with one warp per frame, four frames a block.
`csrc/floor_prepare.cu` runs `DeviceFloorFit.prepare` with a warp a
row, several a block, persistent (`prepare_geometry`), the next row's
spectra staged by cp.async under this one's work: the mask's dB
quantization and the above classes a lane a 4-bin chunk, the moments a
lane a run of `bins_a_lane(n)` bins with the sums recorded at the
look's window edges (`prepare_table`) and scanned over the lanes, so a
window's sums are its edges' exact uint32 difference, the weighted
prefix in float64 in segment order (the CPU's torch.cumsum order; the
card's cumsum may add in another).  `DeviceFloorFitCuda` is a fit whose
`prepare` and `fit` are the two kernels, so a fit from the spectra is
two launches; `floor_prepare(fit, logmdct, logmask)` is the prepare's
wrapper (`floor_prepare.launches` counts its launches) and
`floor_prepare_plain` its plain version.  The render stays plain torch.
Each library is compiled by nvcc at first use into build/vorbis_tpu_torch/
(keyed by a hash of the source and flags, vorbis_tpu_torch.native) and
bound with ctypes.  On a CUDA tensor the kernel is the only path: a
failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..convert import device_tables
from ..native import PKG, build_library
from .floor_device import QUANT_OFFSET, QUANT_SCALE, DeviceFloorFit

SOURCE = PKG / "csrc" / "floor_fit.cu"
PREPARE_SOURCE = PKG / "csrc" / "floor_prepare.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def build() -> tuple[Path, str]:
    """Compile the kernel library unless this source's build exists.
    Returns (path, ptxas report); the report is empty when cached."""
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "libfloorfit",
                         extra=("-Xptxas=-v",))


def build_prepare(timing=False) -> tuple[Path, str]:
    """Compile the prepare kernel's library (build; with `timing` its
    -DVTT_PREPARE_TIMING build, whose launch takes the stamps array
    last)."""
    if timing:
        return build_library(PREPARE_SOURCE, nvcc,
                             (*NVCC_FLAGS, "-DVTT_PREPARE_TIMING"),
                             "libfloorprepare_timing")
    return build_library(PREPARE_SOURCE, nvcc, NVCC_FLAGS, "libfloorprepare",
                         extra=("-Xptxas=-v",))


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_floor_fit
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    return lib


def bind_prepare(lib, stamps=False) -> ctypes.CDLL:
    """Set the argument types of a prepare library's entry points (a
    timing build's launch takes the stamps array last)."""
    fn = lib.vtt_floor_prepare
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 5
                   + [ctypes.c_void_p] * stamps)
    fn = lib.vtt_floor_prepare_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    return lib


@lru_cache(maxsize=None)
def load_prepare_library() -> ctypes.CDLL:
    return bind_prepare(ctypes.CDLL(str(build_prepare()[0])))


# csrc/floor_prepare.cu: warps a block at most, the largest n (every
# window's sums below 2^32), a block's shared bytes at most, the most
# posts (two segments a lane), and the timing build's phases a warp
# (VTT_PREPARE_TIMING)
PREPARE_WARPS, PREPARE_MAX_N, PREPARE_SHARED = 8, 2048, 227 * 1024
PREPARE_MAX_P = 65                  # floor1's posts at most
PREPARE_PHASES = ("wait", "quant and above", "moments", "windows",
                  "prefix", "store")


def bins_a_lane(n: int) -> int:
    """csrc/floor_prepare.cu bins_a_lane: the bins a lane owns in the
    moments, n / 32 rounded up to 4s, at least 4."""
    b = -(-n // 32)
    return 4 if b < 4 else -(-b // 4) * 4


def prepare_table(seg_lo, seg_hi) -> np.ndarray:
    """A look's table for csrc/floor_prepare.cu: the sorted distinct
    window edges (each segment's first bin and its end), then each
    segment's lo edge and hi edge as indices into them (int32)."""
    lo, hi = np.asarray(seg_lo, np.int64), np.asarray(seg_hi, np.int64)
    edges = np.unique(np.concatenate([lo, hi]))
    return np.concatenate([edges, np.searchsorted(edges, lo),
                           np.searchsorted(edges, hi)]).astype(np.int32)


def prepare_words(n: int, P: int, nE: int) -> int:
    """A warp's shared words (csrc/floor_prepare.cu layout)."""
    n4 = -(-n // 4) * 4
    words = 4 * n4 + ((n + (n >> 5) + 4) & ~3) + ((n4 // 4 + 3) & ~3) \
        + 12 * nE + 6 * (P - 1) + 6 * P
    return -(-words // 4) * 4


def prepare_geometry(n: int, P: int, nE: int, B: int, sms: int) -> dict:
    """The block of a launch of B rows (csrc/floor_prepare.cu geometry):
    warps a block (wpb: as many as the shared memory holds, at most
    PREPARE_WARPS, fewer where the batch is small) and its shared bytes;
    the launch has as many blocks as the card holds at once, at most one
    a wpb rows, and a warp takes rows warp, warp + warps, ..."""
    nbytes = 4 * prepare_words(n, P, nE)
    wpb = max(1, min(PREPARE_WARPS, PREPARE_SHARED // nbytes,
                     -(-B // sms)))
    return dict(wpb=wpb, smem=wpb * nbytes, bpl=bins_a_lane(n))


def floor_prepare_plain(fit: DeviceFloorFit, logmdct: torch.Tensor,
                        logmask: torch.Tensor):
    """(quant, above, prefix, used) of fit's look on (B, n) spectra: the
    plain version in PyTorch (DeviceFloorFit.prepare)."""
    return DeviceFloorFit.prepare(fit, logmdct, logmask)


class FloorPrepareKernel:
    """`self(fit, logmdct, logmask)` -> (quant (B, n) int32, above (B, n)
    bool, prefix (B, P, 6) float32, used (B,) bool), as
    floor_prepare_plain: on CPU tensors the plain version; on CUDA
    tensors one launch of csrc/floor_prepare.cu on the current stream,
    or an exception.  `fit` is a DeviceFloorFitCuda (its window table
    `prep_tab` of `prep_edges` edges).  `launches` counts the kernel's
    launches (and nothing else)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, fit, logmdct: torch.Tensor, logmask: torch.Tensor):
        if logmdct.device.type == "cpu":
            return floor_prepare_plain(fit, logmdct, logmask)
        if logmdct.device.type != "cuda":
            raise ValueError(f"floor prepare: unsupported device "
                             f"{logmdct.device}")
        dev = fit.prep_tab.device
        B = logmdct.shape[0] if logmdct.dim() == 2 else -1
        n, P = fit.n, fit.posts
        if n > PREPARE_MAX_N or P > PREPARE_MAX_P:
            raise ValueError(f"floor prepare: n={n} (at most "
                             f"{PREPARE_MAX_N}: a window's uint32 sums "
                             f"could wrap), P={P} (at most {PREPARE_MAX_P})")
        for name, t in (("logmdct", logmdct), ("logmask", logmask)):
            if (t.device != dev or t.dtype != torch.float32
                    or tuple(t.shape) != (B, n)):
                raise ValueError(
                    f"floor prepare: {name} must be float32 {(B, n)} on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"floor prepare: {name} is not contiguous")
        quant = torch.empty((B, n), dtype=torch.int32, device=dev)
        above = torch.empty((B, n), dtype=torch.bool, device=dev)
        prefix = torch.empty((B, P, 6), dtype=torch.float32, device=dev)
        used = torch.empty((B,), dtype=torch.bool, device=dev)
        if B == 0:
            return quant, above, prefix, used
        rc = load_prepare_library().vtt_floor_prepare(
            logmdct.data_ptr(), logmask.data_ptr(), fit.prep_tab.data_ptr(),
            fit.prep_edges, B, n, P, float(QUANT_SCALE), float(QUANT_OFFSET),
            float(fit.twofitatten), float(fit.tw), quant.data_ptr(),
            above.data_ptr(), prefix.data_ptr(), used.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"floor_prepare kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        return quant, above, prefix, used


floor_prepare = FloorPrepareKernel()


class DeviceFloorFitCuda(DeviceFloorFit):
    """DeviceFloorFit whose prepare (csrc/floor_prepare.cu, through
    `floor_prepare`) and greedy fit + final walk (csrc/floor_fit.cu) are
    CUDA kernels.  `launches` counts the fit kernel's launches (and
    nothing else); `floor_prepare.launches` the prepare's, of every
    look."""

    def __init__(self, look, device):
        super().__init__(look, device)
        for name, v in (("maxover", self.maxover),
                        ("maxunder", self.maxunder)):
            # the kernel's over test is an integer range check
            if not (0 <= v < 2 ** 20 and float(v).is_integer()):
                raise ValueError(
                    f"floor fit kernel: {name}={v} must be integral in "
                    f"[0, 2^20) (every floor1 template uses 60 and 30)")
        P = self.posts
        tabs = np.zeros((5, P), np.int32)
        tabs[0] = self.reverse_index
        tabs[1] = self.postlist
        tabs[2] = self.sorted_x
        tabs[3, :P - 2] = self.lo_static
        tabs[4, :P - 2] = self.hi_static
        self.kernel_tabs = device_tables({"tabs": tabs}, self.device)["tabs"]
        # the prepare's segment windows: each segment's first bin, then
        # its end; and as the kernel reads them (prepare_table)
        self.seg_t = device_tables({"seg": np.stack(
            [self.seg_lo, self.seg_hi]).astype(np.int32)},
            self.device)["seg"]
        tab = prepare_table(self.seg_lo, self.seg_hi)
        self.prep_edges = len(tab) - 2 * (P - 1)
        self.prep_tab = device_tables({"tab": tab}, self.device)["tab"]
        self._consts = (float(self.maxover), float(self.maxunder),
                        float(self.maxerr),
                        float(self.maxover * self.maxover),
                        float(self.maxunder * self.maxunder))
        self.launches = 0

    def prepare(self, logmdct, logmask):
        return floor_prepare(self, logmdct, logmask)

    def fit(self, quant, above, prefix):
        if quant.device.type == "cpu":
            return super().fit(quant, above, prefix)
        if quant.device.type != "cuda":
            raise ValueError(f"floor fit: unsupported device {quant.device}")
        B, n = quant.shape
        P = self.posts
        dev = self.kernel_tabs.device
        for name, t, dt, shape in (("quant", quant, torch.int32, (B, n)),
                                   ("above", above, torch.bool, (B, n)),
                                   ("prefix", prefix, torch.float32,
                                    (B, P, 6))):
            if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
                raise ValueError(
                    f"floor fit: {name} must be {dt} {shape} on {dev}, got "
                    f"{t.dtype} {tuple(t.shape)} on {t.device}")
            if not t.is_contiguous():
                raise ValueError(f"floor fit: {name} is not contiguous")
        if n != self.n:
            raise ValueError(f"floor fit: n={n}, expected {self.n}")
        out = torch.empty((B, P), dtype=torch.int32, device=dev)
        lib = load_library()
        rc = lib.vtt_floor_fit(
            quant.data_ptr(), above.data_ptr(), prefix.data_ptr(),
            self.kernel_tabs.data_ptr(), out.data_ptr(), B, n, P,
            *self._consts, torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"floor_fit kernel launch failed: cudaError "
                               f"{rc}")
        self.launches += 1
        return out

    def fit_plain(self, quant, above, prefix):
        """The plain PyTorch version on the same tensors (for checks)."""
        return DeviceFloorFit.fit(self, quant, above, prefix)


def make_floor_fit(look, device):
    """The CUDA kernel for a CUDA device, the plain version for the
    CPU.  Both produce bitwise-identical posts."""
    device = torch.device(device)
    if device.type == "cuda":
        return DeviceFloorFitCuda(look, device)
    if device.type == "cpu":
        return DeviceFloorFit(look, device)
    raise ValueError(f"no floor fit for device {device}")
