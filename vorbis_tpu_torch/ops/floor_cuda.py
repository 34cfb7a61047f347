"""Floor1 greedy fit as a hand-written Hopper kernel (counterpart of
vorbis_tpu/ops/floor_pallas.py).

`csrc/floor_fit.cu` runs the greedy loop + final walk of
`DeviceFloorFit.fit` with one warp per frame, four frames a block; the
moments (the bin -> segment matmul) and the render stay plain torch, as
they stay XLA around the Pallas kernel.  The library is compiled by nvcc
at first use into build/vorbis_tpu_torch/ (keyed by a hash of the source
and flags, vorbis_tpu_torch.native) and bound with ctypes.  On a CUDA
tensor the kernel is the only path: a failed build or launch raises.
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
from .floor_device import DeviceFloorFit

SOURCE = PKG / "csrc" / "floor_fit.cu"
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


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_floor_fit
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    return lib


class DeviceFloorFitCuda(DeviceFloorFit):
    """DeviceFloorFit whose greedy fit + final walk is the CUDA kernel.
    `launches` counts kernel launches (and nothing else)."""

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
        self._consts = (float(self.maxover), float(self.maxunder),
                        float(self.maxerr),
                        float(self.maxover * self.maxover),
                        float(self.maxunder * self.maxunder))
        self.launches = 0

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
