"""The floor's post coding as one hand-written Hopper kernel: floor1_encode's
quantization and wrap coding, the decoder-side curve render and the
floor's packet columns (counterpart of the jitted `_floor_wrap` and
`_floor_fields` of vorbis_tpu/ops/encdevice.py and `DeviceFloorFit.render`
of vorbis_tpu/ops/floor_device.py).

`csrc/floor_encode.cu` takes a batch of raw fit posts (B, P) int32 and
used (B,) bool and returns (curve (B, n) float32, vals (B, FC) int64,
lens (B, FC) int32), one warp a row.  Its tables come as one int32 blob
a floor config (`pack_blob`): a header of offsets (HEADER), then the
static tables, the 256 fromdB bit patterns, one record a partition
(PART) and each codebook once as (codeword, length) pairs.

`floor_encode_plain(cfg, posts, used)` is the plain version: the
finish's three stages `_floor_wrap`, `render` and `_floor_fields`, as
they ran before the kernel (on the CPU bitwise equal to the JAX
package's, tests/test_torch_floor_encode.py; on the card the kernel,
chip_smoke.py).  `floor_encode(cfg, posts, used)` runs the plain version
on CPU tensors and on CUDA tensors launches the kernel or raises;
`floor_encode.launches` counts its launches.  `cfg` is a finish config
(the DeviceFastEncode, or a submap's namespace) holding `floor_enc`, a
FloorEncodeConfig.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache, partial
from pathlib import Path

import numpy as np
import torch

from ..native import PKG, build_library
from .floor_cuda import NVCC_FLAGS, nvcc

SOURCE = PKG / "csrc" / "floor_encode.cu"
# the blob's header words, in order (csrc/floor_encode.cu H_*): the
# offsets point into the blob
HEADER = ("P", "n", "mult", "quant_q", "qb", "npart", "fc", "lo", "hi",
          "postlist", "fwd", "sx", "iv", "fromdB", "parts", "words")
H = {k: i for i, k in enumerate(HEADER)}
# a partition record (csrc/floor_encode.cu R_*); sub-book l's maxval, book
# offset (-1: none) and entries at SUBS + 3 * l
PART = ("cdim", "csubbits", "csub", "col", "code", "cb")
R = {k: i for i, k in enumerate(PART)}
SUBS = len(PART)
MAX_SUB = 8
PART_WORDS = SUBS + 3 * MAX_SUB
MAX_POSTS = 65


def pack_blob(cfg, fromdB: np.ndarray) -> np.ndarray:
    """One floor config's tables as the kernel's int32 blob.  cfg: the
    finish config's floor fields (P, quant_q, qb, mult, lo_static,
    hi_static, postlist, fl_parts, and fl, the Floor1Look)."""
    look = cfg.fl
    P, n = cfg.P, look.n
    if not 2 <= P <= MAX_POSTS:
        raise ValueError(f"floor encode: P = {P} outside [2, {MAX_POSTS}]")
    sx = np.asarray(look.sorted_x, np.int64)
    iv = np.clip(np.searchsorted(sx, np.arange(n), side="right") - 1,
                 0, P - 1)
    fromdB = np.ascontiguousarray(fromdB, np.float32)
    if fromdB.shape != (256,):
        raise ValueError(f"floor encode: fromdB {fromdB.shape}")
    arrays = [("lo", cfg.lo_static), ("hi", cfg.hi_static),
              ("postlist", cfg.postlist), ("fwd", look.forward_index),
              ("sx", sx), ("iv", iv), ("fromdB", fromdB.view(np.int32))]
    words = [np.zeros(len(HEADER), np.int64)]
    at = len(HEADER)
    hdr = dict(P=P, n=n, mult=cfg.mult, quant_q=cfg.quant_q, qb=cfg.qb,
               npart=len(cfg.fl_parts))
    for name, a in arrays:
        a = np.asarray(a).astype(np.int64)
        hdr[name] = at
        words.append(a)
        at += len(a)
    hdr["parts"] = at
    recs = np.zeros((len(cfg.fl_parts), PART_WORDS), np.int64)
    at += recs.size
    books = {}                  # id(book) -> offset: each book once
    book_words = []

    def book(bk):
        nonlocal at
        if id(bk) not in books:
            pairs = np.stack([np.asarray(bk.codewords, np.uint64)
                              .astype(np.uint32).view(np.int32),
                              np.asarray(bk.lengths, np.int32)], 1)
            books[id(bk)] = at
            book_words.append(pairs.reshape(-1).astype(np.int64))
            at += pairs.size
        return books[id(bk)]

    col, code = 3, 2
    for k, p in enumerate(cfg.fl_parts):
        r = recs[k]
        csub = len(p["subbooks"])
        if csub > MAX_SUB or csub != 1 << p["csubbits"]:
            raise ValueError(f"floor encode: partition {k} has {csub} "
                             f"sub-books for {p['csubbits']} class bits")
        r[[R["cdim"], R["csubbits"], R["csub"], R["col"], R["code"]]] = (
            p["cdim"], p["csubbits"], csub, col, code)
        r[R["cb"]] = -1
        if p["csubbits"]:
            cb = p["classbook"]
            if cb.entries < 1 << (p["csubbits"] * p["cdim"]):
                raise ValueError(f"floor encode: partition {k}'s class "
                                 f"book has {cb.entries} entries")
            r[R["cb"]] = book(cb)
            col += 1
        for l, bk in enumerate(p["subbooks"]):
            s = SUBS + 3 * l
            r[s:s + 3] = (p["maxval"][l], -1 if bk is None else book(bk),
                          0 if bk is None else bk.entries)
        col += p["cdim"]
        code += p["cdim"]
    if code != P:
        raise ValueError(f"floor encode: the partitions code {code - 2} "
                         f"posts of {P - 2}")
    hdr["fc"] = col
    hdr["words"] = at
    for k, v in hdr.items():
        words[0][H[k]] = v
    blob = np.concatenate(words + [recs.reshape(-1)] + book_words)
    assert len(blob) == at
    return blob.astype(np.int32)


class FloorEncodeConfig:
    """One floor config's blob (on the host and on the config's device)
    and the plain version's three stages bound to the config."""

    def __init__(self, enc, cfg, floor, fromdB: torch.Tensor):
        self.blob_np = pack_blob(cfg, fromdB.cpu().numpy())
        self.blob = torch.from_numpy(self.blob_np).to(fromdB.device)
        self.P, self.n, self.fc = (int(self.blob_np[H[k]])
                                   for k in ("P", "n", "fc"))
        self.wrap = partial(enc._floor_wrap, cfg=cfg)
        self.render = partial(floor.render, fromdB_table=fromdB)
        self.fields = partial(enc._floor_fields, cfg=cfg)


def floor_encode_plain(cfg, posts: torch.Tensor, used: torch.Tensor):
    """(curve, vals, lens) of raw fit posts (B, P) and used (B,): the
    finish's _floor_wrap, render and _floor_fields in PyTorch."""
    t = cfg.floor_enc
    codes, qposts = t.wrap(posts)
    curve = t.render(qposts)
    vals, lens = t.fields(codes, used)
    return curve, vals, lens


def build() -> tuple[Path, str]:
    """Compile the kernel library unless this source's build exists.
    Returns (path, ptxas report); the report is empty when cached."""
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "libfloorencode",
                         extra=("-Xptxas=-v",))


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_floor_encode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    return lib


class FloorEncodeKernel:
    """`self(cfg, posts, used)` -> (curve (B, n) float32, vals (B, FC)
    int64, lens (B, FC) int32), as floor_encode_plain: on CPU tensors the
    plain version; on CUDA tensors one launch of csrc/floor_encode.cu on
    the current stream, or an exception.  `launches` counts the kernel's
    launches (and nothing else)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg, posts: torch.Tensor, used: torch.Tensor):
        if posts.device.type == "cpu":
            return floor_encode_plain(cfg, posts, used)
        if posts.device.type != "cuda":
            raise ValueError(f"floor encode: unsupported device "
                             f"{posts.device}")
        t = cfg.floor_enc
        B = posts.shape[0]
        dev = t.blob.device
        for name, x, dt, shape in (("posts", posts, torch.int32, (B, t.P)),
                                   ("used", used, torch.bool, (B,))):
            if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
                raise ValueError(
                    f"floor encode: {name} must be {dt} {shape} on {dev}, "
                    f"got {x.dtype} {tuple(x.shape)} on {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"floor encode: {name} is not contiguous")
        curve = torch.empty((B, t.n), dtype=torch.float32, device=dev)
        vals = torch.empty((B, t.fc), dtype=torch.int64, device=dev)
        lens = torch.empty((B, t.fc), dtype=torch.int32, device=dev)
        if B == 0:
            return curve, vals, lens
        rc = load_library().vtt_floor_encode(
            posts.data_ptr(), used.data_ptr(), t.blob.data_ptr(),
            t.blob.numel(), curve.data_ptr(), vals.data_ptr(),
            lens.data_ptr(), B, t.P, torch.cuda.current_stream(dev)
            .cuda_stream)
        if rc != 0:
            raise RuntimeError(f"floor_encode kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        return curve, vals, lens


floor_encode = FloorEncodeKernel()
