"""Windowed lapped overlap-add with the granulepos trim as a hand-written
Hopper kernel (counterpart of the host C lap the JAX package's decode
runs, vorbis_tpu/models/fastdec.py `FastDecoder._native_lap` ->
vn_lap_add, then the cut of `_trim_range`, and of its chunked decode's
sum into the previous chunk's lap tail).

`csrc/lap.cu` writes every stream's trimmed (ch, hi - lo) PCM once: a
sample in [c_{p-1}, c_p) (c_p packet p's center) is its initial value
(the stream's tail there, else +0) plus block p-1 x window, plus block p
x window, which equals the host C's packet-order sum into that buffer bit
for bit (the source argues it).  `lap_plain` is that sum itself in eager
PyTorch: the tail copied into a `torch.zeros` buffer, the window multiply
and a per-packet slice add in packet order, then the trim.

`LapPlan` describes a batch of streams (per packet its block, position,
window and blocksize; per stream its channels, [lo, hi) and optionally
its tail), made on the host by models/fastdec.py.
`lap(blocks, wins, plan, tails=...)` is the wrapper the decode calls: on
a CPU tensor it runs `lap_plain`; on a CUDA tensor it launches the kernel
or raises (no fall-back).  `lap.launches` counts the kernel's launches
and nothing else.  The library is compiled by nvcc at first use into
build/vorbis_tpu_torch/ and bound with ctypes.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..native import PKG, build_library
from .floor_cuda import NVCC_FLAGS, nvcc

SOURCE = PKG / "csrc" / "lap.cu"


def build() -> tuple[Path, str]:
    """Compile the kernel library unless this source's build exists.
    Returns (path, ptxas report); the report is empty when cached."""
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "liblap",
                         extra=("-Xptxas=-v",))


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_lap
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_long, ctypes.c_void_p]
    return lib


class LapPlan:
    """The lap of a batch of streams, on the host.  `streams` holds, per
    stream, (ch, n, pos, blk, win, lo, hi): each packet's blocksize, block
    start in the stream's lapped coordinates, element offset of its
    channel-0 block in the batch's `blocks` (channel c at + c * n) and of
    its window in the batch's `wins`, and the trim [lo, hi).  Each
    stream's (ch, hi - lo) PCM lies at `out_off[k]` of the output.
    `tails[k]`, where given, is stream k's tail (offset, stride, pos,
    length): its initial values, channel c's at offset + c * stride of
    the wrapper's `tails`, for the samples [pos, pos + length) of its
    lapped coordinates (the rest start at +0).

    `pk` (packets, 4) and `st` (streams, 8) are the kernel's tables:
    block, position, window, (stream << 16) | n a packet; lo, hi,
    channels, output offset, tail offset, stride, pos, length a
    stream."""

    def __init__(self, streams, tails=None):
        self.streams = streams
        cols, st, off = [], [], 0
        self.out_off = []
        for k, (ch, n, pos, blk, win, lo, hi) in enumerate(streams):
            n = np.asarray(n, np.int64)
            if len(n) and (n.min() < 64 or n.max() > 8192):
                raise ValueError("lap: blocksize out of 64..8192")
            cols.append(np.stack([np.asarray(blk, np.int64),
                                  np.asarray(pos, np.int64),
                                  np.asarray(win, np.int64),
                                  (k << 16) | n], axis=1).reshape(-1, 4))
            tail = None if tails is None else tails[k]
            st.append((lo, hi, ch, off, *(tail or (0, 0, 0, 0))))
            self.out_off.append(off)
            off += ch * max(0, hi - lo)
        self.total = off
        self.pk = (np.concatenate(cols) if cols
                   else np.zeros((0, 4), np.int64))
        self.st = np.asarray(st, np.int64).reshape(-1, 8)

    def out_view(self, out: torch.Tensor, k: int) -> torch.Tensor:
        """Stream k's (ch, hi - lo) PCM in the flat output `out`."""
        ch, _, _, _, _, lo, hi = self.streams[k]
        o = self.out_off[k]
        return out[o:o + ch * max(0, hi - lo)].view(ch, max(0, hi - lo))


def lap_plain(blocks: torch.Tensor, wins: torch.Tensor, plan: LapPlan,
              tails: torch.Tensor | None = None) -> torch.Tensor:
    """The lap of `plan` in eager PyTorch on blocks' device: per stream,
    a zeroed buffer that takes its tail, each packet's blocks times its
    window added into it in packet order (`d += s * w`, vn_lap_add's
    order), then the trim.  Returns the flat output (plan.total floats)."""
    out = torch.zeros(plan.total, dtype=torch.float32, device=blocks.device)
    for k, (ch, n, pos, blk, win, lo, hi) in enumerate(plan.streams):
        if hi <= lo:
            continue
        t_off, t_stride, t_pos, t_len = map(int, plan.st[k, 4:])
        length = max([hi, t_pos + t_len]
                     + [int(p) + int(m) for p, m in zip(pos, n)])
        buf = torch.zeros((ch, length), dtype=torch.float32,
                          device=blocks.device)
        if t_len:
            buf[:, t_pos:t_pos + t_len] = tails[t_off:].as_strided(
                (ch, t_len), (t_stride, 1))
        for m, p, b, w in zip(n, pos, blk, win):
            m, p, b, w = int(m), int(p), int(b), int(w)
            buf[:, p:p + m] += blocks[b:b + ch * m].view(ch, m) \
                * wins[w:w + m]
        plan.out_view(out, k).copy_(buf[:, lo:hi])
    return out


class LapKernel:
    """`self(blocks, wins, plan)`: the batch's trimmed PCM, flat (plan's
    `out_view` cuts a stream out).  On a CPU tensor the plain version; on
    a CUDA tensor one launch of csrc/lap.cu on the current stream, or an
    exception.  `launches` counts the kernel's launches (and nothing
    else)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, blocks: torch.Tensor, wins: torch.Tensor,
                 plan: LapPlan, tables=None,
                 tails: torch.Tensor | None = None) -> torch.Tensor:
        """`tables`, the plan's (pk, st) already on the card, saves their
        copy; `tails` holds the streams' tails (LapPlan's `tails`)."""
        if blocks.device.type == "cpu":
            return lap_plain(blocks, wins, plan, tails)
        if blocks.device.type != "cuda":
            raise ValueError(f"lap: unsupported device {blocks.device}")
        named = [("blocks", blocks), ("wins", wins)]
        if tails is not None:
            named.append(("tails", tails))
        for name, t in named:
            if t.dtype != torch.float32 or t.dim() != 1 \
                    or not t.is_contiguous() or t.device != blocks.device:
                raise ValueError(f"lap: {name} must be a contiguous 1-D "
                                 f"float32 tensor on {blocks.device}")
        pk, st = self._checked(plan, blocks.numel(), wins.numel(),
                               0 if tails is None else tails.numel())
        if tables is None:
            tables = tuple(torch.from_numpy(a).to(blocks.device)
                           for a in (pk, st))
        out = torch.empty(plan.total, dtype=torch.float32,
                          device=blocks.device)
        if not len(pk) or plan.total == 0:
            return out
        rc = load_library().vtt_lap(
            blocks.data_ptr(), wins.data_ptr(),
            None if tails is None else tails.data_ptr(), tables[0].data_ptr(),
            tables[1].data_ptr(), out.data_ptr(), len(pk),
            torch.cuda.current_stream(blocks.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"lap kernel launch failed: cudaError {rc}")
        self.launches += 1
        return out

    @staticmethod
    def _checked(plan, nblocks, nwins, ntails=0):
        """The plan's tables, after the checks that keep every read of
        the kernel inside `blocks`, `wins` and `tails`."""
        pk, st = plan.pk, plan.st
        for (ch, n, pos, blk, win, lo, hi), s in zip(plan.streams, st):
            t_off, t_stride, t_pos, t_len = map(int, s[4:])
            if t_len and (t_off < 0 or t_stride < t_len or t_pos < 0
                          or t_off + (ch - 1) * t_stride + t_len > ntails):
                raise ValueError("lap: a tail lies outside `tails`")
            n = np.asarray(n, np.int64)
            if not len(n):
                continue
            if (np.asarray(blk) < 0).any() or \
                    (np.asarray(blk) + ch * n > nblocks).any():
                raise ValueError("lap: a block lies outside `blocks`")
            if (np.asarray(win) < 0).any() or \
                    (np.asarray(win) + n > nwins).any():
                raise ValueError("lap: a window lies outside `wins`")
        return np.ascontiguousarray(pk), np.ascontiguousarray(st)


lap = LapKernel()
