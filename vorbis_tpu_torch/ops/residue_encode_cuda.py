"""The residue path as one hand-written Hopper kernel: the partition
classify, the multi-stage lattice VQ and the codeword columns
(counterpart of the jitted `_classify2` / `_classify`, `_vq_stages` and
`_residue_fields` of vorbis_tpu/ops/encdevice.py:767-1000, lib/res0.c
_2class / _01class, _encodepart with the lattice fast path and
res01_forward's emission loop).

`csrc/residue_encode.cu` takes one residue config's residue rows (R, n)
float32, laid out as `_vq_stages` reads them (the interleaved (F, nch *
n2) rows of residue type 2, the (F * ch, n2) rows of type 1), and used
(F, res_ch) bool, and returns the config's residue columns (vals (F, RC)
int64, lens (F, RC) int32) in res01_forward's emission order.  A warp
takes an item (`cpw` chunks of one frame, every channel), a lane a unit
of `unit` values of a partition (whole entries at every stage): the
class from the partition's lanes, every stage's quantization with the
values in registers (the lattice step's divide a multiply-high by a
magic number, `magic`; JAX's quotient at INT_MIN), the entries' pair
offsets in the item's column order in shared memory, then the item's
columns, a contiguous run a stage; a block of up to 8 warps an item
each (`geometry`).  Its tables come as one int32 blob a residue config
(`pack_blob`): a header (HEADER), the classmetric thresholds, one record
a (stage, class) (REC), the column records (`columns`, the emission
order), the phrase book and each stage book once as (codeword, length)
pairs, the remapped index of each entry of a book whose remap is not the
identity, and a second record a (stage, class) (REC2: the digit
divisor, the entries a unit).

`residue_encode_plain(cfg, res, used)` is the plain version, the
config's `ResidueEncodeConfig.plain`: the finish's three stages as they
ran before the kernel (on the CPU bitwise equal to the JAX package's,
tests/test_torch_residue_encode.py; on the card the kernel,
chip_smoke.py).  A dead column (length 0) has value 0 in both.
`residue_encode(cfg, res, used)` runs the plain version on CPU tensors
and on CUDA tensors launches the kernel or raises;
`residue_encode.launches` counts its launches.  `cfg` holds `res_enc`, a
ResidueEncodeConfig (a DeviceFastEncode or a submap's namespace).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..native import PKG, build_library
from .floor_cuda import NVCC_FLAGS, nvcc

SOURCE = PKG / "csrc" / "residue_encode.cu"
MAX_STAGES = 8
# the blob's header words, in order (csrc/residue_encode.cu H_*): the
# layout, a lane's values (unit), the partitions a frame (per_frame), a
# partition's lanes (units), the offsets of the tables, each stage's most
# steps (ms) and its first entry slot a partition (soff), then the rec2
# table's offset, the chunks an item (cpw) and an item's columns at most
# (item_cols)
HEADER = ("type", "nch", "res_ch", "begin", "spp", "partvals", "ppw",
          "nck", "parts_pad", "possible", "stages", "rc", "phr_entries",
          "scale", "sument", "unit", "per_frame", "units", "cm1", "cm2",
          "recs", "cols", "phr", "words") + tuple(
    f"ms{s}" for s in range(MAX_STAGES)) + tuple(
    f"soff{s}" for s in range(MAX_STAGES)) + ("rec2", "cpw", "item_cols")
H = {k: i for i, k in enumerate(HEADER)}
# a (stage, class) record (csrc/residue_encode.cu R_*): dim 0 where the
# class has no book at the stage; minval, add and delta's float32 bits;
# book: the (codeword, length) pairs' offset; remap: the remapped
# indices' offset, -1 for the identity; magic and shift: delta's
# divisor (`magic`)
REC = ("dim", "qv", "steps", "minval", "add", "delta", "deltaf", "book",
       "remap", "entries", "magic", "shift")
R = {k: i for i, k in enumerate(REC)}
# a (stage, class) second record (csrc/residue_encode.cu R2_*): qv's
# divisor (`magic`) for a remapped book's digits, a unit's entries
# (unit / dim, 0 where the class has no book), a pad word
REC2 = ("qmagic", "qshift", "per", "pad")
R2 = {k: i for i, k in enumerate(REC2)}
MAX_SPP = 32                    # a partition's values, at most
MAX_UNIT = 8                    # csrc/residue_encode.cu kMaxUnit
WARPS = 8                       # csrc/residue_encode.cu kWarps
WARP_EXTRA = 2 * 32 + 32        # csrc/residue_encode.cu kWarpExtra
MAX_SHARED = 227 * 1024
# the timing build's phases a warp (VTT_RESIDUE_TIMING)
PHASES = ("tables", "load", "classify", "VQ", "columns")
# a column record: its step, stage, partition and channel, and the top
# bit for a phrase word
COL_STEP, COL_STAGE, COL_PART, COL_CHAN, COL_PHRASE = 0, 6, 9, 21, 31


def _f32bits(v) -> int:
    return int(np.float32(v).view(np.int32))


def magic(d: int) -> tuple[int, int]:
    """(m, shift) of the divisor d >= 1 (csrc/residue_encode.cu
    trunc_div): for d > 1, L = ceil(log2 d), m = floor(2^32 (2^L - d) /
    d) + 1 < 2^32 and shift = L - 1, so that a // d = (t + ((a - t) >> 1))
    >> shift with t = (m * a) >> 32 for every 0 <= a < 2^32 (Granlund and
    Montgomery's round-up method); d = 1 divides by no number."""
    if d < 1 or d >= 1 << 31:
        raise ValueError(f"residue encode: divisor {d}")
    if d == 1:
        return 0, 0
    L = (d - 1).bit_length()
    return ((1 << 32) * ((1 << L) - d)) // d + 1, L - 1


def _words(head) -> tuple[int, int]:
    """(table words a block, words a warp) of csrc/residue_encode.cu."""
    sp = int(head[H["stages"]]) * int(head[H["possible"]])
    table = sp * (len(REC) + len(REC2)) + 2 * int(head[H["possible"]])
    warp = int(head[H["item_cols"]]) + WARP_EXTRA
    return -(-table // 4) * 4, -(-warp // 4) * 4


def geometry(head, frames: int, sms: int) -> dict:
    """The launch of `frames` frames on a card of `sms` SMs
    (csrc/residue_encode.cu geometry): its items (a frame's chunks in
    items of cpw), warps a block (wpb: the items spread over the SMs, at
    most WARPS), shared bytes a block, and blocks: one a wpb items, warp
    w of the launch item w."""
    cpw, nck = int(head[H["cpw"]]), int(head[H["nck"]])
    items = frames * -(-nck // cpw)
    wpb = max(1, min(WARPS, -(-items // sms)))
    table, warp = _words(head)
    blocks = -(-items // wpb)
    return dict(items=items, wpb=wpb, smem=4 * (table + wpb * warp),
                blocks=blocks, warps=blocks * wpb)


def unit_of(spp: int, ppw: int, res_ch: int, lcm: int) -> int:
    """A lane's values: the least multiple of `lcm` dividing spp whose
    units (spp / unit a partition) let a chunk's partitions, every
    channel, fit a warp; at most MAX_UNIT."""
    for unit in range(lcm, min(spp, MAX_UNIT) + 1, lcm):
        if spp % unit == 0 and spp // unit * ppw * res_ch <= 32:
            return unit
    raise ValueError(f"residue encode: no unit of at most {MAX_UNIT} "
                     f"values (a multiple of {lcm}) lets a chunk of {ppw} "
                     f"partitions x {res_ch} channels fit a warp")


def columns(stages, nck, ppw, res_ch, ms) -> np.ndarray:
    """The column records of one frame in res01_forward's order: each
    stage, each chunk of ppw partitions, stage 0's phrase word a channel,
    then each partition of the chunk, each channel, ms[s] steps."""
    out = []
    for s in range(stages):
        for c0 in range(nck):
            if s == 0:
                out += [1 << COL_PHRASE | (c0 * ppw) << COL_PART
                        | c << COL_CHAN for c in range(res_ch)]
            for k in range(ppw):
                for c in range(res_ch):
                    out += [st << COL_STEP | s << COL_STAGE
                            | (c0 * ppw + k) << COL_PART | c << COL_CHAN
                            for st in range(ms[s])]
    return np.asarray(out, np.int64)


def pack_blob(cfg, nch: int) -> np.ndarray:
    """One residue config's tables as the kernel's int32 blob.  cfg: the
    finish config's residue fields (res_type, res_ch, ri, spp, partvals,
    ppw, nchunks, parts_pad, possible, stages, sec, res_books,
    stage_tabs, phrasebook, ph_cw, ph_cl); nch: the interleaved channels
    of a type-2 row (1 for type 1)."""
    typ, rc_ch, spp = cfg.res_type, cfg.res_ch, cfg.spp
    ri = cfg.ri
    if typ not in (1, 2):
        raise ValueError(f"residue encode: residue type {typ}")
    if typ == 2 and (nch < 2 or rc_ch != 1 or spp % nch
                     or ri.begin % nch):
        raise ValueError(f"residue encode: type 2 over {nch} channels, "
                         f"spp {spp}, begin {ri.begin}")
    if typ == 1 and nch != 1:
        raise ValueError("residue encode: type 1 rows are one channel")
    if not 0 < spp <= MAX_SPP:
        raise ValueError(f"residue encode: {spp} values a partition")
    if not 0 < cfg.stages <= MAX_STAGES:
        raise ValueError(f"residue encode: {cfg.stages} stages")
    if cfg.possible > 256 or cfg.parts_pad >= 1 << 12 or rc_ch >= 1 << 10:
        raise ValueError("residue encode: too many classes, partitions or "
                         "channels for the column words")
    ms = [st["max_steps"] for st in cfg.stage_tabs]
    soff = np.concatenate([[0], np.cumsum(ms)])
    words = [np.zeros(len(HEADER), np.int64)]
    hdr = {}
    at = len(HEADER)

    def put(name, a, align=1):
        """Place `a` at the next multiple of `align` words; -> offset."""
        nonlocal at
        a = np.asarray(a, np.int64).reshape(-1)
        pad = -at % align
        words.append(np.concatenate([np.zeros(pad, np.int64), a]))
        hdr[name] = at + pad
        at += pad + len(a)
        return hdr[name]

    put("cm1", np.asarray(ri.classmetric1, np.int64)[:cfg.possible])
    put("cm2", np.asarray(ri.classmetric2, np.int64)[:cfg.possible])
    recs = np.zeros((cfg.stages, cfg.possible, len(REC)), np.int64)
    recs[..., R["remap"]] = -1
    put("recs", recs)
    rec_block = len(words) - 1
    cols = columns(cfg.stages, cfg.nchunks, cfg.ppw, rc_ch, ms)
    put("cols", cols)
    # (codeword, length) pairs at even offsets: the kernel loads a pair
    # as one 8-byte word
    put("phr", np.stack([cfg.ph_cw.view(np.int32),
                         cfg.ph_cl.astype(np.int32)], 1), 2)
    for s in range(cfg.stages):
        st = cfg.stage_tabs[s]
        for c, d in enumerate(cfg.res_books[s]):
            if d is None:
                continue
            E, dim = d["entries"], d["dim"]
            if spp % dim or E > 1 << 16 or d["delta"] < 1:
                raise ValueError(f"residue encode: stage {s} class {c}: "
                                 f"dim {dim}, {E} entries, delta "
                                 f"{d['delta']}")
            r = recs[s, c]
            r[[R["dim"], R["qv"], R["steps"], R["delta"], R["entries"]]] = (
                dim, d["qv"], spp // dim, d["delta"], E)
            r[R["minval"]] = _f32bits(float(d["minval"]))
            r[R["add"]] = _f32bits(float(d["delta"] >> 1)
                                   if d["delta"] != 1 else 0.0)
            r[R["deltaf"]] = _f32bits(float(d["delta"]))
            m, sh = magic(int(d["delta"]))
            r[R["magic"]] = np.uint32(m).view(np.int32)
            r[R["shift"]] = sh
            r[R["book"]] = put("book", np.stack(
                [st["cw"][c, :E].view(np.int32), st["cl"][c, :E]], 1), 2)
            if not d["ident"]:
                remap = np.asarray(d["book"].remap_np, np.int64)
                r[R["remap"]] = put("remap", remap)
    words[rec_block][:] = recs.reshape(-1)
    hdr.pop("book", None)
    hdr.pop("remap", None)
    # a lane's unit: whole entries of every book (and whole channel
    # rounds of a type-2 row), a chunk of every channel within a warp
    dims = [d["dim"] for row in cfg.res_books for d in row if d is not None]
    unit = unit_of(spp, cfg.ppw, rc_ch,
                   int(np.lcm.reduce(dims + ([nch] if typ == 2 else []))))
    units = spp // unit
    rec2 = np.zeros((cfg.stages, cfg.possible, len(REC2)), np.int64)
    for s in range(cfg.stages):
        for c, d in enumerate(cfg.res_books[s]):
            if d is not None:
                m, sh = magic(int(d["qv"]))
                rec2[s, c, [R2["qmagic"], R2["qshift"], R2["per"]]] = (
                    np.uint32(m).view(np.int32), sh, unit // d["dim"])
    put("rec2", rec2)
    cpw = max(1, min(cfg.nchunks, 32 // (units * cfg.ppw * rc_ch)))
    item_cols = cpw * sum((rc_ch if s == 0 else 0) + cfg.ppw * rc_ch * ms[s]
                          for s in range(cfg.stages))
    hdr.update(type=typ, nch=nch, res_ch=rc_ch, begin=ri.begin, spp=spp,
               partvals=cfg.partvals, ppw=cfg.ppw, nck=cfg.nchunks,
               parts_pad=cfg.parts_pad, possible=cfg.possible,
               stages=cfg.stages, rc=len(cols),
               phr_entries=cfg.phrasebook.entries,
               scale=_f32bits(np.float32(100.0) / np.float32(spp)),
               sument=int(soff[-1]), unit=unit,
               per_frame=rc_ch * cfg.parts_pad, units=units, cpw=cpw,
               item_cols=item_cols, words=at)
    for s in range(cfg.stages):
        hdr[f"ms{s}"] = ms[s]
        hdr[f"soff{s}"] = soff[s]
    for k, v in hdr.items():
        words[0][H[k]] = v
    big = geometry(words[0], 1 << 30, 1)        # a block of WARPS warps
    if big["smem"] > MAX_SHARED:
        raise ValueError(f"residue encode: a block takes {big['smem']} "
                         f"bytes")
    blob = np.concatenate(words)
    assert len(blob) == at
    if at >= 1 << 31:
        raise ValueError("residue encode: blob too large")
    return blob.astype(np.int32)


def blob_tables(blob) -> dict:
    """The blob read back by its header: the header's words, cm1 and cm2,
    the records (stages, possible, len(REC)) and (stages, possible,
    len(REC2)), the column records (rc,), ms and soff (stages,)."""
    b = np.asarray(blob.cpu() if torch.is_tensor(blob) else blob, np.int32)
    out = {k: int(b[H[k]]) for k in HEADER}
    S, P = out["stages"], out["possible"]
    out["cm1"] = b[out["cm1"]:out["cm1"] + P].astype(np.int64)
    out["cm2"] = b[out["cm2"]:out["cm2"] + P].astype(np.int64)
    out["recs"] = b[out["recs"]:out["recs"] + S * P * len(REC)] \
        .reshape(S, P, len(REC))
    out["rec2"] = b[out["rec2"]:out["rec2"] + S * P * len(REC2)] \
        .reshape(S, P, len(REC2))
    out["cols"] = b[out["cols"]:out["cols"] + out["rc"]]
    out["ms"] = [out[f"ms{s}"] for s in range(S)]
    out["soff"] = [out[f"soff{s}"] for s in range(S)]
    return out


class ResidueEncodeConfig:
    """One residue config's blob (on the host and on the device of `dev`,
    the DeviceFastEncode that finishes through it) and its plain version,
    `plain(res, used)` -> (vals, lens): residue_trio(dev, cfg, nch)."""

    def __init__(self, cfg, nch: int, dev):
        self.blob_np = pack_blob(cfg, nch)
        self.blob = torch.from_numpy(self.blob_np).to(dev.device)
        self.head = np.ascontiguousarray(self.blob_np[:len(HEADER)])
        tb = {k: int(self.head[H[k]]) for k in HEADER}
        self.type, self.nch, self.res_ch, self.rc = (
            tb[k] for k in ("type", "nch", "res_ch", "rc"))
        self.dev = dev
        self.plain = residue_trio(dev, cfg, nch)


def classify_rows(dev, res, nch, cfg):
    """The type-2 classes of interleaved rows res (F, nch * n2): channel
    0's magnitudes and the elementwise max of the other channels' through
    dev._classify2."""
    absM = torch.abs(res[:, 0::nch])
    absA = torch.abs(res[:, 1::nch]) if nch == 2 else torch.stack(
        [torch.abs(res[:, c::nch]) for c in range(1, nch)], 1).amax(1)
    return dev._classify2(absM, absA, nch=nch, cfg=cfg)


def residue_trio(dev, cfg, nch):
    """The plain version of a residue config: dev's classifier
    (_classify2 on the interleaved rows for type 2, _classify for type
    1), _vq_stages and _residue_fields, bound to cfg."""
    def plain(res, used):
        F = used.shape[0]
        if cfg.res_type == 2:
            pw = classify_rows(dev, res, nch, cfg)
        else:
            pw = dev._classify(res, cfg=cfg)
        entries = dev._vq_stages(res, pw, cfg=cfg)
        rc = cfg.res_ch
        return dev._residue_fields(
            pw.reshape(F, rc, -1),
            [e.reshape(F, rc, cfg.partvals, -1) for e in entries], used,
            cfg=cfg)
    return plain


def residue_encode_plain(cfg, res: torch.Tensor, used: torch.Tensor):
    """(vals, lens) of residue rows res and used (F, res_ch): the
    config's plain version in PyTorch."""
    return cfg.res_enc.plain(res, used)


def build(timing=False) -> tuple[Path, str]:
    """Compile the kernel library (with `timing` its -DVTT_RESIDUE_TIMING
    build, whose launch takes the stamps array last) unless this source's
    build exists.  Returns (path, ptxas report); the report is empty when
    cached."""
    if timing:
        return build_library(SOURCE, nvcc,
                             (*NVCC_FLAGS, "-DVTT_RESIDUE_TIMING"),
                             "libresidueencode_timing")
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "libresidueencode",
                         extra=("-Xptxas=-v",))


def bind(lib, stamps=False) -> ctypes.CDLL:
    """Set the argument types of a library's entry points (a timing
    build's launch takes the stamps array last)."""
    fn = lib.vtt_residue_encode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * (3 + stamps))
    fn = lib.vtt_residue_encode_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    return lib


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return bind(ctypes.CDLL(str(build()[0])))


class ResidueEncodeKernel:
    """`self(cfg, res, used)` -> (vals (F, RC) int64, lens (F, RC) int32),
    as residue_encode_plain: on CPU tensors the plain version; on CUDA
    tensors one launch of csrc/residue_encode.cu on the current stream,
    or an exception.  `launches` counts the kernel's launches (and
    nothing else)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, cfg, res: torch.Tensor, used: torch.Tensor):
        if res.device.type == "cpu":
            return residue_encode_plain(cfg, res, used)
        if res.device.type != "cuda":
            raise ValueError(f"residue encode: unsupported device "
                             f"{res.device}")
        t = cfg.res_enc
        dev = t.blob.device
        F = used.shape[0] if used.dim() == 2 else -1
        for name, x, dt, shape in (
                ("used", used, torch.bool, (F, t.res_ch)),
                ("res", res, torch.float32, (F * t.res_ch, res.shape[-1]))):
            if x.device != dev or x.dtype != dt or tuple(x.shape) != shape:
                raise ValueError(
                    f"residue encode: {name} must be {dt} {shape} on {dev}, "
                    f"got {x.dtype} {tuple(x.shape)} on {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"residue encode: {name} is not "
                                 f"contiguous")
        vals = torch.empty((F, t.rc), dtype=torch.int64, device=dev)
        lens = torch.empty((F, t.rc), dtype=torch.int32, device=dev)
        if F == 0:
            return vals, lens
        rc = load_library().vtt_residue_encode(
            res.data_ptr(), used.data_ptr(), t.blob.data_ptr(),
            t.head.ctypes.data, F, res.shape[-1], vals.data_ptr(),
            lens.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"residue_encode kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        return vals, lens


residue_encode = ResidueEncodeKernel()
