"""The packet packer as one hand-written Hopper kernel: the static plan's
bit-field column merge and the LSB-first packing of every packet
(counterpart of the jitted `merge_columns`, `_merge_limb_pairs` and
`pack_bits_device` of vorbis_tpu/ops/encdevice.py:241-360; libogg
oggpack_write).

`csrc/pack_bits.cu` takes a finish call's raw columns (vals (F, C)
int64, lens (F, C) int32) and returns (packets (F, wb) uint8, nbits (F,)
int32): a block of `ppb` packets of `tpp` threads stages a tile of each
packet's lengths into shared memory by asynchronous copies, then the
low words of the values of the columns with bits the same way;
meanwhile a thread sums a run of consecutive groups and one block scan
gives each run its bit offset; then each thread merges its groups and
ORs each field into shared-memory words of the row's wb bytes.  Its plan
is `PackTables`: the plan's gidx (what `merge_columns` gathers by) and,
for the kernel, the groups' column offsets (every group is a run of
consecutive columns) with the tiling; `PackTables.geometry(F, wb, sms)`
sizes a launch to its batch.

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
from typing import NamedTuple

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


# csrc/pack_bits.cu's limits: threads a block, groups a thread a tile;
# and the columns a packet's tile stages at most (32 KB of lengths and
# values' low words), which only a run of one group a thread can exceed
THREADS, MAX_RUN = 256, 8
LENS_WORDS = 4096


class Geometry(NamedTuple):
    """A launch of csrc/pack_bits.cu: threads a packet (tpp), packets a
    block (ppb), groups a thread a tile (run), staged columns (lw: as
    many int32 lengths and values' low words) and packet words (nw) a
    packet, blocks, dynamic shared bytes a block."""
    tpp: int
    ppb: int
    run: int
    lw: int
    nw: int
    blocks: int
    smem: int


def group_offsets(gidx: np.ndarray, n_cols: int) -> np.ndarray:
    """(C1 + 1,) int32 column offsets of a plan whose every group (a row
    of gidx, -1 pads last) is a run of consecutive columns, the runs in
    order from column 0 to n_cols; raises ValueError for any other plan
    (the kernel reads no column lists)."""
    gidx = np.asarray(gidx)
    width = (gidx >= 0).sum(1)
    offs = np.concatenate([[0], np.cumsum(width)])
    k = np.arange(gidx.shape[1])
    want = np.where(k < width[:, None], offs[:-1, None] + k, -1)
    if not (np.array_equal(gidx, want) and offs[-1] == n_cols
            and (width > 0).all()):
        raise ValueError("pack plan: a group is not a run of consecutive "
                         "columns in order")
    return offs.astype(np.int32)


def tiling(offs: np.ndarray, tpp_max: int = THREADS,
           lens_words: int = LENS_WORDS) -> tuple[int, int, int]:
    """(tpp, run, lw) of a plan's offsets: MAX_RUN groups a thread over
    whole warps, at most `tpp_max` threads a packet, fewer groups where a
    tile's columns would not fit `lens_words` staged columns (three more
    for the row's alignment)."""
    C1 = len(offs) - 1
    tpp = min(tpp_max, -(-C1 // (32 * MAX_RUN)) * 32)
    run = min(MAX_RUN, -(-C1 // tpp))
    while True:
        g0 = np.arange(0, C1, tpp * run)
        span = int((offs[np.minimum(g0 + tpp * run, C1)] - offs[g0]).max())
        if span + 3 <= lens_words or run == 1:
            return tpp, run, -(-(span + 3) // 4) * 4
        run -= 1


class PackTables:
    """A PackPlan (ops/encdevice.py) on the device: `gidx` (C1, Gmax)
    long with the pads at column C, what merge_columns gathers by, and
    `offs` (C1 + 1) int32, the kernel's view of the same plan: each
    group's first column (its pads dropped: a pad merges a zero-length
    column, which contributes nothing), then C; `tpp`, `run`, `lw` its
    tiling (`tiling`; the tests and chip_smoke.py also check small tiles
    of few threads a packet).  `plan` is the host plan (its budget `wb` and
    `worst_bytes`)."""

    def __init__(self, plan, gidx_t: torch.Tensor, tpp_max: int = THREADS,
                 lens_words: int = LENS_WORDS):
        offs = group_offsets(plan.gidx, plan.n_cols)
        self.plan = plan
        self.n_cols = int(plan.n_cols)
        self.n_groups = len(offs) - 1
        self.gidx = gidx_t
        self.offs = torch.from_numpy(offs).to(gidx_t.device)
        self.tpp, self.run, self.lw = tiling(offs, tpp_max, lens_words)

    def geometry(self, F: int, wb: int, sms: int) -> Geometry:
        """The launch of F packets at budget wb on a card of `sms` SMs:
        packets a block as csrc/residue_encode.cu takes frames, two
        blocks an SM where the batch allows, at most THREADS a block."""
        ppb = max(1, min(THREADS // self.tpp, F // (2 * sms)))
        nw = -(-wb // 16) * 4
        return Geometry(self.tpp, ppb, self.run, self.lw, nw,
                        -(-F // ppb), ppb * (2 * self.lw + nw) * 4)


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
    bind(lib)
    fn = lib.vtt_pack_packets_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib


def bind(lib, stamps: bool = False):
    """Set vtt_pack_packets' ctypes signature on `lib` (a timing build's
    takes the stamps' pointer last) and return the function."""
    fn = lib.vtt_pack_packets
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] * (3 + stamps))
    return fn


@lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(fn, tabs: PackTables, vals: torch.Tensor, lens: torch.Tensor,
           wb: int, *extra):
    """(packets, nbits) of one call of the entry point `fn` (the
    library's, or a timing build's with its stamps' pointer in `extra`)
    on the current stream, sized by tabs.geometry; raises on a refused
    launch."""
    dev = vals.device
    F = vals.shape[0]
    out = torch.empty((F, wb), dtype=torch.uint8, device=dev)
    nbits = torch.empty((F,), dtype=i32, device=dev)
    if F == 0:
        return out, nbits
    g = tabs.geometry(F, wb, sm_count(dev.index))
    rc = fn(vals.data_ptr(), lens.data_ptr(), tabs.offs.data_ptr(), F,
            tabs.n_cols, tabs.n_groups, wb, g.tpp, g.ppb, g.run, g.lw, g.nw,
            out.data_ptr(), nbits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, *extra)
    if rc != 0:
        raise RuntimeError(f"pack_packets kernel launch failed: "
                           f"cudaError {rc}")
    return out, nbits


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
        dev = tabs.offs.device
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
        out = launch(load_library().vtt_pack_packets, tabs, vals, lens, wb)
        if F:
            self.launches += 1
        return out


pack_packets = PackPacketsKernel()
