"""The packet packer as one hand-written Hopper kernel: the static plan's
bit-field column merge and the LSB-first packing of every packet
(counterpart of the jitted `merge_columns`, `_merge_limb_pairs` and
`pack_bits_device` of vorbis_tpu/ops/encdevice.py:241-360; libogg
oggpack_write).

`csrc/pack_bits.cu` takes a finish call's raw columns (vals (F, C)
int64, lens (F, C) int32) and returns (packets (F, wb) uint8, nbits (F,)
int32): one CTA a packet merges the plan's groups a thread a group in
rounds, scans their lengths across the block and ORs each field into
shared-memory words of the row's wb bytes.  Its plan is `PackTables`:
the plan's gidx (what `merge_columns` gathers by) and, for the kernel,
the groups' column lists.

`pack_packets_plain(tabs, vals, lens, wb)` is the plain version,
`merge_columns` then `pack_bits` (on the CPU bitwise equal to the JAX
package's packer, tests/test_torch_pack.py; on the card the kernel,
chip_smoke.py).  `pack_packets(tabs, vals, lens, wb)` runs the plain
version on CPU tensors and on CUDA tensors launches the kernel or
raises; `pack_packets.launches` counts its launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..native import PKG, build_library
from .floor_cuda import NVCC_FLAGS, nvcc

SOURCE = PKG / "csrc" / "pack_bits.cu"
i32 = torch.int32
i64 = torch.int64


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


class PackTables:
    """A PackPlan (ops/encdevice.py) on the device: `gidx` (C1, Gmax)
    long with the pads at column C, what merge_columns gathers by, and
    `groups`, the kernel's int32 view of the same plan: C1 + 1 offsets
    into the column list that follows them, each group's columns in
    merge order (its pads dropped: a pad merges a zero-length column,
    which contributes nothing).  `plan` is the host plan (its budget `wb`
    and `worst_bytes`)."""

    def __init__(self, plan, gidx_t: torch.Tensor):
        cols = [row[row >= 0] for row in np.asarray(plan.gidx)]
        offs = np.cumsum([0] + [len(c) for c in cols])
        self.plan = plan
        self.n_cols = int(plan.n_cols)
        self.n_groups = len(cols)
        self.gidx = gidx_t
        self.groups = torch.from_numpy(np.concatenate(
            [offs, *cols]).astype(np.int32)).to(gidx_t.device)


def pack_packets_plain(tabs: PackTables, vals: torch.Tensor,
                       lens: torch.Tensor, wb: int):
    """(packets (F, wb) uint8, nbits (F,) int32) of raw columns vals (F,
    C) int64 and lens (F, C) int32: merge_columns then pack_bits."""
    mv, ml = merge_columns(vals, lens, tabs.gidx)
    return pack_bits(mv, ml, wb)


def build() -> tuple[Path, str]:
    """Compile the kernel library unless this source's build exists.
    Returns (path, ptxas report); the report is empty when cached."""
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "libpackbits",
                         extra=("-Xptxas=-v",))


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_pack_packets
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 3)
    fn = lib.vtt_pack_packets_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    return lib


class PackPacketsKernel:
    """`self(tabs, vals, lens, wb)` -> (packets (F, wb) uint8, nbits (F,)
    int32), as pack_packets_plain: on CPU tensors the plain version; on
    CUDA tensors one launch of csrc/pack_bits.cu on the current stream,
    or an exception.  `launches` counts the kernel's launches (and
    nothing else)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, tabs: PackTables, vals: torch.Tensor,
                 lens: torch.Tensor, wb: int):
        if vals.device.type == "cpu":
            return pack_packets_plain(tabs, vals, lens, wb)
        if vals.device.type != "cuda":
            raise ValueError(f"pack packets: unsupported device "
                             f"{vals.device}")
        dev = tabs.groups.device
        F = vals.shape[0] if vals.dim() == 2 else -1
        for name, x, dt in (("vals", vals, i64), ("lens", lens, i32)):
            if (x.device != dev or x.dtype != dt
                    or tuple(x.shape) != (F, tabs.n_cols)):
                raise ValueError(
                    f"pack packets: {name} must be {dt} {(F, tabs.n_cols)} "
                    f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                    f"{x.device}")
            if not x.is_contiguous():
                raise ValueError(f"pack packets: {name} is not contiguous")
        wb = int(wb)
        if wb < 1:
            raise ValueError(f"pack packets: wb={wb}")
        out = torch.empty((F, wb), dtype=torch.uint8, device=dev)
        nbits = torch.empty((F,), dtype=i32, device=dev)
        if F == 0:
            return out, nbits
        rc = load_library().vtt_pack_packets(
            vals.data_ptr(), lens.data_ptr(), tabs.groups.data_ptr(), F,
            tabs.n_cols, tabs.n_groups, wb, out.data_ptr(), nbits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"pack_packets kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        return out, nbits


pack_packets = PackPacketsKernel()
