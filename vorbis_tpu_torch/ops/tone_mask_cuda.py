"""The tone mask as one hand-written Hopper kernel (counterpart of the
jitted `DeviceToneMask.__call__` of vorbis_tpu/ops/jaxdsp.py:477-558,
lib/psy.c's _vp_tonemask / seed_loop / seed_chase / max_seeds).

`csrc/tone_mask.cu` takes the log FFT spectrum logfft (R, n) float32 and
the global and local spectral maxima (R,) float32 and returns the tone
mask (R, n) float32, one block a row: the octave groups' maxima, the
curve seeding spread evenly over the block (the depositing groups listed
by a block scan, 32 deposits a warp chunk), the eighth-octave chase 8
lines a thread and the windowed min over static window pieces with the
ATH floor, each row's working set in shared memory.  Its tables come as
one int32 blob a psy look (`pack_blob`: a header of offsets, HEADER,
then each bin's group and window, the ATH, each group's first bin, band
and owned octave line, four words a group of its ATH, curve-row base,
line and in-range steps at each level, each window's lines, the window
pieces and the curve rows), built once by DeviceToneMask and kept on
its device with its header on the host (`blob_head`, passed by value).

`tone_mask_plain(tm, logfft, global_specmax, local_specmax)` is the plain
version: the JAX package's passes as PyTorch ops (a scatter_reduce amax,
56 seed gathers, 7 chase passes, a sparse-table range min), bitwise
equal to the jitted JAX function on the CPU
(tests/test_torch_tone_mask.py).  `tone_mask(tm, ...)` runs the plain
version on CPU tensors and on CUDA tensors launches the kernel or raises;
`tone_mask.launches` counts its launches.  `tm` is a
torchdsp.DeviceToneMask, whose __call__ is `tone_mask(self, ...)`.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..native import PKG, build_library
from . import psy as PSY
from .floor_cuda import NVCC_FLAGS, nvcc

SOURCE = PKG / "csrc" / "tone_mask.cu"
NEGINF = float(PSY.NEGINF)
# the blob's header words, in order (csrc/tone_mask.cu H_*): sizes, then
# the offsets of the tables in the blob, then the four constants' float32
# bits, psy.c's two EHMER sizes and the blob's length; the first 24 are the
# first design's layout, the rest its redesign's tables and piece count
HEADER = ("n", "T", "G", "W", "linesper", "p_levels", "ncurves", "curve_w",
          "bin_group", "bin_win", "ath", "group_first", "group_band",
          "group_base", "win_lo", "win_hi", "curves", "tone_abs_limit",
          "ath_adjatt", "ath_maxatt", "max_curve_dB", "ehmer_max",
          "ehmer_offset", "words", "group_static", "group_posts", "piece",
          "pieces", "chunks")
H = {k: i for i, k in enumerate(HEADER)}
CONSTS = ("tone_abs_limit", "ath_adjatt", "ath_maxatt", "max_curve_dB")
TABLES = {"bin_group": np.int32, "bin_win": np.int32, "ath": np.float32,
          "group_first": np.int32, "group_band": np.int32,
          "group_base": np.int32, "win_lo": np.int32, "win_hi": np.int32,
          "curves": np.float32, "group_static": np.int32,
          "group_posts": np.int32, "piece": np.int32}
# the most lines of a window piece (csrc/tone_mask.cu kPiece); a piece's
# word is its first line | its lines less one << 15 | its window << 18
PIECE = 8


def _c(v) -> float:
    """A float32-rounded constant as a Python scalar (torch casts it to
    the tensor dtype exactly)."""
    return float(np.float32(v))


def pack_blob(n: int, linesper: int, p_levels: int, tables: dict,
              consts: dict) -> np.ndarray:
    """One psy look's tables as the kernel's int32 blob.  tables: the
    look's group_first (G,), group_band (G,), line2group (T,) (the group
    whose base octave line it is, -1 for none), ath (n,), win_start and
    win_end (n,) (each bin's window of lines) and curve_rows (P_BANDS *
    p_levels, 2 + EHMER_MAX) float32; consts: CONSTS' values.  Each group
    keeps the line it owns (-1: none), each bin its window among the
    distinct (start, end) pairs.  The redesign's tables, four words a
    group: group_static (its ATH at its first bin as float32 bits, its
    curve rows' first word, the line of its step 0, 0) and group_posts
    (at each of the 8 curve levels, as 16-bit halves, k0 | k1 << 8: its
    curve row's [post0, post1) cut to the steps whose line falls in
    1..T-1, 0 | 0 where none is left or it owns no line); and the window
    pieces (window_pieces) as words.  The header's `chunks` is the most
    32-deposit chunks a row can fill.  Each table starts at a multiple of
    4 words."""
    first = np.asarray(tables["group_first"], np.int64)
    G, T = len(first), len(tables["line2group"])
    group_id = np.searchsorted(first, np.arange(n), side="right") - 1
    l2g = np.asarray(tables["line2group"], np.int64)
    base = np.full(G, -1, np.int64)
    base[l2g[l2g >= 0]] = np.nonzero(l2g >= 0)[0]
    pairs = np.stack([tables["win_start"], tables["win_end"]], 1)
    wins, bin_win = np.unique(pairs, axis=0, return_inverse=True)
    curves = np.asarray(tables["curve_rows"], np.float32)
    ath = np.asarray(tables["ath"], np.float32)[:n]
    if first[0] != 0 or (np.diff(first) <= 0).any() or first[-1] >= n:
        raise ValueError("tone mask: groups are not contiguous spans")
    if (wins[:, 0] > wins[:, 1]).any() or wins.min() < 0 \
            or wins.max() >= T:
        raise ValueError("tone mask: a window outside the octave lines")
    if curves.shape[1] != 2 + PSY.EHMER_MAX:
        raise ValueError(f"tone mask: curve rows of {curves.shape[1]}")
    if curves.size >= 1 << 16 or len(wins) >= 1 << 13 or T >= 1 << 15:
        raise ValueError("tone mask: tables too large for the words")
    if p_levels != 8:
        raise ValueError(f"tone mask: {p_levels} curve levels, not 8")
    off = np.where(base >= 0, base - PSY.EHMER_OFFSET * linesper
                   - (linesper >> 1), 0)
    line = off[:, None] + np.arange(PSY.EHMER_MAX) * linesper
    ok = (line >= 1) & (line < T) & (base >= 0)[:, None]
    klo = np.where(ok.any(1), ok.argmax(1), 0)
    khi = np.where(ok.any(1), PSY.EHMER_MAX - ok[:, ::-1].argmax(1), 0)
    band = np.asarray(tables["group_band"], np.int64)
    post = curves[band[:, None] * p_levels + np.arange(p_levels), :2] \
        .astype(np.int32)
    k0 = np.maximum(post[..., 0], klo[:, None])
    k1 = np.minimum(post[..., 1], khi[:, None])
    posts = np.where(k1 > k0, k0 | k1 << 8, 0)          # (G, 8)
    static = np.stack([ath[first].view(np.int32),
                       band * p_levels * curves.shape[1], off,
                       np.zeros(G, np.int64)], 1)
    piece_lo, piece_hi, piece_win = window_pieces(wins[:, 0], wins[:, 1])
    parts = dict(bin_group=group_id, bin_win=bin_win.reshape(-1), ath=ath,
                 group_first=first, group_band=tables["group_band"],
                 group_base=base, win_lo=wins[:, 0], win_hi=wins[:, 1],
                 curves=curves.reshape(-1), group_static=static,
                 group_posts=posts[:, 0::2] | posts[:, 1::2] << 16,
                 piece=piece_lo | (piece_hi - piece_lo) << 15
                 | piece_win << 18)
    head = np.zeros(len(HEADER), np.int32)
    words, at = [head], len(HEADER)
    for name, dt in TABLES.items():
        pad = -at % 4
        words.append(np.zeros(pad, np.int32))
        at += pad
        a = np.ascontiguousarray(parts[name], dt).view(np.int32) \
            .reshape(-1)
        head[H[name]] = at
        words.append(a)
        at += len(a)
    head[[H[k] for k in ("n", "T", "G", "W", "linesper", "p_levels",
                         "ncurves", "curve_w", "pieces", "chunks")]] = (
        n, T, G, len(wins), linesper, p_levels, curves.shape[0],
        curves.shape[1], len(piece_lo),
        -(-int(((posts >> 8) - (posts & 0xFF)).max(1).sum()) // 32))
    for k in CONSTS:
        head[H[k]] = np.float32(consts[k]).view(np.int32)
    head[H["ehmer_max"]] = PSY.EHMER_MAX
    head[H["ehmer_offset"]] = PSY.EHMER_OFFSET
    head[H["words"]] = at
    return np.concatenate(words)


def window_pieces(lo, hi, piece: int = PIECE):
    """Each window [lo_w, hi_w] of lines cut into pieces of at most
    `piece` lines, in window order: (piece_lo, piece_hi, piece_win)."""
    lo, hi = np.asarray(lo, np.int64), np.asarray(hi, np.int64)
    count = (hi - lo) // piece + 1
    win = np.repeat(np.arange(len(lo)), count)
    k = np.arange(len(win)) - np.repeat(np.cumsum(count) - count, count)
    plo = lo[win] + k * piece
    return plo, np.minimum(plo + piece - 1, hi[win]), win


def blob_tables(blob) -> dict:
    """The blob read back by its header: the sizes, each table at its
    offset (bin_group, bin_win, ath, group_first, group_band, group_base,
    win_lo, win_hi, curves (ncurves, curve_w), group_static (G, 4),
    group_posts (G, 4), piece) and the constants; the pieces' words
    unpacked as piece_lo, piece_hi and piece_win, the posts' halves as
    group_k0 and group_k1 (G, 8)."""
    b = np.asarray(blob.cpu() if torch.is_tensor(blob) else blob, np.int32)
    out = {k: int(b[H[k]]) for k in HEADER if k not in TABLES
           and k not in CONSTS}
    n, G, W, P = out["n"], out["G"], out["W"], out["pieces"]
    sizes = dict(bin_group=n, bin_win=n, ath=n, group_first=G,
                 group_band=G, group_base=G, win_lo=W, win_hi=W,
                 curves=out["ncurves"] * out["curve_w"],
                 group_static=4 * G, group_posts=4 * G, piece=P)
    for name, dt in TABLES.items():
        o = int(b[H[name]])
        out[name] = b[o:o + sizes[name]].view(dt)
    out["curves"] = out["curves"].reshape(out["ncurves"], out["curve_w"])
    for k in ("group_static", "group_posts"):
        out[k] = out[k].reshape(G, 4)
    half = np.stack([out["group_posts"] & 0xFFFF,
                     out["group_posts"] >> 16 & 0xFFFF], 2).reshape(G, 8)
    out["group_k0"], out["group_k1"] = half & 0xFF, half >> 8
    pc = out["piece"]
    out["piece_lo"], out["piece_win"] = pc & 0x7FFF, pc >> 18
    out["piece_hi"] = out["piece_lo"] + ((pc >> 15) & 7)
    for k in CONSTS:
        out[k] = b[H[k]:H[k] + 1].view(np.float32)[0]
    return out


def _groups(tm, logfft, global_specmax, local_specmax):
    """The plain version's octave groups: (flr (..., n), gmax, curves
    (..., G, 2 + EHMER_MAX), post0, post1, audible (..., G))."""
    att = torch.clamp_min(local_specmax + tm.ath_adjatt, tm.ath_maxatt)
    flr = tm.ath + att[..., None]
    # per-group max
    lead = logfft.shape[:-1]
    gmax = torch.full(lead + (tm.n_groups,), -float("inf"),
                      dtype=torch.float32, device=logfft.device)
    gmax = gmax.scatter_reduce(-1, tm.group_id.expand(logfft.shape),
                               logfft, "amax", include_self=True)
    dBoffset = tm.max_curve_dB - global_specmax[..., None]
    level = torch.clamp(((gmax + dBoffset - _c(PSY.P_LEVEL_0))
                         * _c(0.1)).to(torch.int32),
                        0, tm.p_levels - 1)
    rows = tm.group_band * tm.p_levels + level          # (R, G)
    curves = tm.curve_rows[rows]                        # (R, G, 2+E)
    post0 = curves[..., 0].to(torch.int32)
    post1 = curves[..., 1].to(torch.int32)
    audible = gmax + 6.0 > flr[..., tm.group_first]
    return flr, gmax, curves, post0, post1, audible


def seed_deposits(tm, logfft, global_specmax, local_specmax) -> int:
    """The curve steps that the seeding deposits on these rows: an
    audible group's steps k in [post0, post1) that land on an octave
    line (the contributions that the plain version does not mask)."""
    _, _, _, post0, post1, audible = _groups(tm, logfft, global_specmax,
                                             local_specmax)
    count = 0
    for k in range(PSY.EHMER_MAX):
        act = (k >= post0) & (k < post1) & audible
        count += int((act[..., tm.seed_src[k]] & tm.seed_ok[k]).sum())
    return count


def tone_mask_plain(tm, logfft, global_specmax, local_specmax):
    """The tone mask of logfft (..., n) and the spectral maxima (...,)
    under tm's tables, as the JAX package computes it: PyTorch ops on
    any device."""
    flr, gmax, curves, post0, post1, audible = _groups(
        tm, logfft, global_specmax, local_specmax)
    lead = logfft.shape[:-1]
    # seed deposit: 56 static gathers + running max
    seed = torch.full(lead + (tm.total,), NEGINF,
                      dtype=torch.float32, device=logfft.device)
    for k in range(PSY.EHMER_MAX):
        vk = gmax + curves[..., 2 + k]
        act = (k >= post0) & (k < post1) & audible
        vk = torch.where(act, vk, NEGINF)
        contrib = vk[..., tm.seed_src[k]]
        contrib = torch.where(tm.seed_ok[k], contrib, NEGINF)
        seed = torch.maximum(seed, contrib)
    # chase: extend seeds across one eighth-octave (sliding max)
    ext = seed
    for s in range(1, tm.linesper):
        shifted = torch.nn.functional.pad(seed[..., :-s], (s, 0),
                                          value=NEGINF)
        ext = torch.maximum(ext, shifted)
    # windowed min over [start_j, end_j] back in the linear domain:
    # sparse-table (dyadic) range-min
    run = torch.where(ext > NEGINF, ext, float("inf"))
    levels = [run]
    for k in range(tm.kmax):
        prev = levels[-1]
        sh = 1 << k
        levels.append(torch.minimum(prev, torch.nn.functional.pad(
            prev[..., sh:], (0, sh), value=float("inf"))))
    minv = torch.full(flr.shape, float("inf"), dtype=torch.float32,
                      device=logfft.device)
    for k in tm.levels_used:
        a = levels[k][..., tm.win_lo]
        b = levels[k][..., tm.win_hi[k]]
        minv = torch.where(tm.k_mask[k], torch.minimum(a, b), minv)
    # seedless windows must stay at the ATH floor
    minv = torch.where(torch.isfinite(minv),
                       torch.clamp_max(minv, tm.tone_abs_limit),
                       NEGINF)
    return torch.maximum(flr, minv)


def build() -> tuple[Path, str]:
    """Compile the kernel library unless this source's build exists.
    Returns (path, ptxas report); the report is empty when cached."""
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "libtonemask",
                         extra=("-Xptxas=-v",))


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    fn = lib.vtt_tone_mask
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p])
    fn = lib.vtt_tone_mask_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


class ToneMaskKernel:
    """`self(tm, logfft, global_specmax, local_specmax)` -> tone (..., n)
    float32, as tone_mask_plain: on CPU tensors the plain version; on
    CUDA tensors one launch of csrc/tone_mask.cu on the current stream,
    or an exception.  `launches` counts the kernel's launches (and
    nothing else)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, tm, logfft: torch.Tensor,
                 global_specmax: torch.Tensor,
                 local_specmax: torch.Tensor) -> torch.Tensor:
        if logfft.device.type == "cpu":
            return tone_mask_plain(tm, logfft, global_specmax,
                                   local_specmax)
        if logfft.device.type != "cuda":
            raise ValueError(f"tone mask: unsupported device "
                             f"{logfft.device}")
        dev, n = tm.blob.device, tm.look.n
        lead = tuple(logfft.shape[:-1])
        for name, x, shape in (("logfft", logfft, lead + (n,)),
                               ("global_specmax", global_specmax, lead),
                               ("local_specmax", local_specmax, lead)):
            if x.device != dev or x.dtype != torch.float32 \
                    or tuple(x.shape) != shape:
                raise ValueError(
                    f"tone mask: {name} must be float32 {shape} on {dev}, "
                    f"got {x.dtype} {tuple(x.shape)} on {x.device}")
            if not x.is_contiguous():
                raise ValueError(f"tone mask: {name} is not contiguous")
        out = torch.empty_like(logfft)
        rows = out.numel() // n
        if rows == 0:
            return out
        rc = load_library().vtt_tone_mask(
            logfft.data_ptr(), global_specmax.data_ptr(),
            local_specmax.data_ptr(), tm.blob.data_ptr(),
            tm.blob_head.ctypes.data, tm.blob.numel(), out.data_ptr(), rows,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"tone_mask kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        return out


tone_mask = ToneMaskKernel()
