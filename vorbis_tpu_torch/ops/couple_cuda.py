"""The stereo coupling as one hand-written Hopper kernel: the per-row
lowpass, the M9 threshold lowering, the M6 promotion, the lossless
mag/ang transform, the signed-energy point fold, the noise-normalize
promotion, the zeroing of unused frames and the interleave (counterpart
of the jitted `_couple_quantize`, `_m6_promote` and `_normalize_promote`
of vorbis_tpu/ops/encdevice.py:1011-1174 and :1448, with the lowpass and
the interleave of its `finish_from_posts`, :1510).

`csrc/couple_quantize.cu` takes a stereo finish call's md and curve
(2F, n2) float32 and used (2F,) bool, with the optional per-row lowpass
(2F,) int32, the M9 peaks epeak (2F, n2) and the M8 store npeak (2F,
ncols), and returns (res (F, 2 n2) float32, any_used (F,) bool): res's
rows interleave the pair as `residue_encode` reads them.  The coupling
tables thr1 and threv (float32) and inlimit (bool) are each None (the
encoder's static table), an (n2,) row, or (R, n2) rows with F a multiple
of R, frame f reading row f % R (the managed pass gives its 15 blobs'
rows so; a view whose rows repeat by stride 0 is taken as it is).

`couple_quantize_plain(dev, ...)` is the plain version: the lowpass
`where`, `dev._couple_quantize` and the interleave, as
`finish_from_posts` ran them (on the CPU bitwise equal to the JAX
package's jitted coupling, tests/test_torch_couple.py; on the card the
kernel, chip_smoke.py).  `couple_quantize(dev, ...)` runs the plain
version on CPU tensors and on CUDA tensors launches the kernel or raises;
`couple_quantize.launches` counts its launches and
`couple_quantize.instances` its launches by instantiation (`INSTANCES`:
the kernel is specialised on the partition width, M6, the normalize and
the two sums' lanes, the keys `instance` gives).  Both sum each
partition in XLA:CPU's order (ops/xla_f32.py `part_sum`, `SUM_LANES`).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..native import PKG, build_library
from .floor_cuda import NVCC_FLAGS, nvcc
from .xla_f32 import SUM_LANES

SOURCE = PKG / "csrc" / "couple_quantize.cu"
BPT = {32: 4, 8: 1}                # bins a thread a partition width
# csrc/couple_quantize.cu kInstances, in its order: (partition, M6,
# normalize, M6's lanes, the normalize's lanes; 0 where the step is off)
INSTANCES = ((32, 1, 0, 8, 0), (32, 1, 1, 8, 8), (32, 0, 0, 0, 0),
             (32, 0, 1, 0, 16), (32, 1, 0, 1, 0), (32, 1, 1, 1, 1),
             (32, 0, 1, 0, 1), (8, 1, 0, 1, 0), (8, 1, 1, 1, 8),
             (8, 0, 0, 0, 0), (8, 0, 1, 0, 1), (8, 1, 1, 1, 1))
# the timing build's phases a warp (VTT_COUPLE_TIMING)
PHASES = ("load", "M6", "carry", "fold", "normalize", "store")
f32 = np.float32

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_F = ctypes.c_float


class CoupleArgs(ctypes.Structure):
    """csrc/couple_quantize.cu's CoupleArgs, field for field."""
    _fields_ = ([(k, _P) for k in (
        "md", "curve", "used", "lowpass", "epeak", "npeak", "thr1", "threv",
        "inlimit", "thr2", "nm_inreg", "nm_start", "res", "any_used")]
        + [(k, _LL) for k in ("thr1_rs", "threv_rs", "inl_rs")]
        + [(k, _I) for k in (
            "thr1_rows", "threv_rows", "inl_rows", "F", "n2", "part", "npt",
            "ncols", "tfe", "m6", "normalize", "lanes_m6", "lanes_nm")]
        + [(k, _F) for k in ("prepoint", "prae", "thresh")])


def _frame_rows(t, F):
    """A table of None, (n2,) or (R, n2) rows (F a multiple of R) as
    _couple_quantize takes it: None, the row, or (F, n2) with frame f's
    row f % R."""
    if t is None or t.dim() == 1 or t.shape[0] == F:
        return t
    R = t.shape[0]
    if R < 1 or F % R:
        raise ValueError(f"couple quantize: {R} table rows for {F} frames")
    return t.repeat(F // R, 1)


def couple_quantize_plain(dev, md, curve, used, F, thr1=None, threv=None,
                          inlimit=None, lowpass=None, epeak=None,
                          npeak=None):
    """(res (F, 2 n2) float32 interleaved, any_used (F,) bool) of a
    stereo finish call, as finish_from_posts' coupled branch computed
    them: the lowpass zeroes md at and above each row's bin limit, then
    `dev._couple_quantize`, then flat[i] = out2[:, i % 2, i // 2]."""
    if lowpass is not None:
        bins = torch.arange(md.shape[-1], dtype=torch.int32,
                            device=md.device)
        md = torch.where(bins[None, :] < lowpass[:, None], md, 0.0)
    out2, any_used = dev._couple_quantize(
        md, curve, used, F, thr1=_frame_rows(thr1, F),
        threv=_frame_rows(threv, F), inlimit=_frame_rows(inlimit, F),
        epeak=epeak, npeak=npeak)
    return out2.transpose(1, 2).reshape(F, -1), any_used


def build(timing=False) -> tuple[Path, str]:
    """Compile the kernel library (with `timing` its -DVTT_COUPLE_TIMING
    build) unless this source's build exists.  Returns (path, ptxas
    report); the report is empty when cached."""
    if timing:
        return build_library(SOURCE, nvcc,
                             (*NVCC_FLAGS, "-DVTT_COUPLE_TIMING"),
                             "libcouple_timing")
    return build_library(SOURCE, nvcc, NVCC_FLAGS, "libcouple",
                         extra=("-Xptxas=-v",))


def bind(lib, stamps=False):
    """Set the argument types of a library's entry points (a timing
    build's launch takes the stamps array after the stream)."""
    fn = lib.vtt_couple_quantize
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(CoupleArgs), ctypes.c_void_p] + (
        [ctypes.c_void_p] if stamps else [])
    lib.vtt_couple_quantize_instances.restype = ctypes.c_int
    fn = lib.vtt_couple_quantize_attrs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    return bind(ctypes.CDLL(str(build()[0])))


def attrs(lib) -> list[dict]:
    """Each instantiation's key, registers, static shared and local bytes
    a thread and blocks (of one warp) an SM (the report of 3o)."""
    n = lib.vtt_couple_quantize_instances()
    out = []
    for k in range(n):
        v = (ctypes.c_int * 9)()
        rc = lib.vtt_couple_quantize_attrs(k, v)
        if rc != 0:
            raise RuntimeError(f"couple quantize attrs {k}: cudaError {rc}")
        out.append(dict(key=tuple(v[:5]), registers=v[5], shared_bytes=v[6],
                        local_bytes=v[7], blocks_per_sm=v[8]))
    if tuple(o["key"] for o in out) != INSTANCES:
        raise RuntimeError("couple quantize: the library's instantiations "
                           "are not INSTANCES")
    return out


def geometry(n2: int, part: int, F: int) -> tuple[int, int]:
    """(warps a frame, blocks) of a launch: a warp holds 32 BPT[part] /
    part partitions of a frame, a block is one warp."""
    npt = -(-n2 // part)
    wpf = -(-npt // (32 * BPT[part] // part))
    return wpf, F * wpf


def lanes(dev, n2: int, m6: bool) -> tuple[int, int]:
    """The accumulators of M6's and of the normalize's partition sums
    at this width (SUM_LANES; a padded row sums left to right), as
    `dev._m6_promote` and `dev._normalize_promote` take them."""
    part = dev.ctx.couple["partition"]
    if n2 % part:
        return 1, 1
    return (SUM_LANES["m6", part],
            SUM_LANES["normalize_m6" if m6 else "normalize", part])


def instance(dev, n2: int, epeak: bool) -> tuple:
    """The INSTANCES key a launch of this config at width n2 picks, with
    the M9 peaks given or not (M6 runs where they are and tonefix_end
    is above 0)."""
    cp = dev.ctx.couple
    part = int(cp["partition"])
    m6 = epeak and int(cp.get("tonefix_end", 0)) > 0
    normalize = dev.ctx.normal["thresh"] < 9000.0
    lm, ln = lanes(dev, n2, m6)
    return (part, int(m6), int(normalize), lm if m6 else 0,
            ln if normalize else 0)


def _table(name, t, default, F, n2, dt, dev):
    """(tensor, rows, row stride) of a coupling table for the kernel."""
    if t is None:
        t = default[:n2]
    if t.dim() == 1:
        t = t[None]
    if (t.device != dev or t.dtype != dt or t.dim() != 2
            or t.shape[1] != n2 or t.shape[0] < 1 or F % t.shape[0]):
        raise ValueError(
            f"couple quantize: {name} must be {dt} (n2,) or (R, {n2}) rows "
            f"with {F} frames a multiple of R on {dev}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}")
    if t.stride(1) != 1:
        t = t.contiguous()
    return t, t.shape[0], t.stride(0)


def args(dev, md, curve, used, F, thr1=None, threv=None, inlimit=None,
         lowpass=None, epeak=None, npeak=None):
    """(CoupleArgs, res, any_used, tensors to keep alive, instantiation
    key) of a call on the card: checks every input, picks the
    instantiation and allocates the outputs."""
    dv = md.device
    n2 = md.shape[-1] if md.dim() == 2 else -1
    if lowpass is not None:
        lowpass = lowpass.to(torch.int32)
    for name, x, dt, shape in (
            ("md", md, torch.float32, (2 * F, n2)),
            ("curve", curve, torch.float32, (2 * F, n2)),
            ("used", used, torch.bool, (2 * F,)),
            ("lowpass", lowpass, torch.int32, (2 * F,)),
            ("epeak", epeak, torch.float32, (2 * F, n2))):
        if x is None:
            continue
        if x.device != dv or x.dtype != dt or tuple(x.shape) != shape:
            raise ValueError(
                f"couple quantize: {name} must be {dt} {shape} on {dv}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"couple quantize: {name} is not contiguous")
    if npeak is not None:
        if (npeak.device != dv or npeak.dtype != torch.float32
                or npeak.dim() != 2 or npeak.shape[0] != 2 * F):
            raise ValueError(f"couple quantize: npeak must be float32 "
                             f"(2F, ncols) on {dv}")
        npeak = npeak.contiguous()
    cp = dev.ctx.couple
    nm = dev.ctx.normal
    part = int(cp["partition"])
    if nm["partition"] != part or part not in (8, 32):
        raise ValueError(f"couple quantize: partitions of {part} (M6) and "
                         f"{nm['partition']} (normalize)")
    m6 = epeak is not None and int(cp.get("tonefix_end", 0)) > 0
    normalize = nm["thresh"] < 9000.0
    t1, r1, s1 = _table("thr1", thr1, dev.thr1_t, F, n2, torch.float32, dv)
    tv, rv, sv = _table("threv", threv, dev.threv_t, F, n2, torch.float32,
                        dv)
    il = (None, 1, 0) if inlimit is None else _table(
        "inlimit", inlimit, None, F, n2, torch.bool, dv)
    res = torch.empty((F, 2 * n2), dtype=torch.float32, device=dv)
    any_used = torch.empty((F,), dtype=torch.bool, device=dv)
    lm, ln = lanes(dev, n2, m6)
    key = instance(dev, n2, epeak is not None)
    if key not in INSTANCES:
        raise ValueError(f"couple quantize: no instantiation {key}")
    keep = [t1, tv, il[0], npeak, lowpass]

    def ptr(x):
        return None if x is None else x.data_ptr()
    a = CoupleArgs(
        md=ptr(md), curve=ptr(curve), used=ptr(used), lowpass=ptr(lowpass),
        epeak=ptr(epeak), npeak=ptr(npeak), thr1=ptr(t1), threv=ptr(tv),
        inlimit=ptr(il[0]), thr2=ptr(dev.thr2_t),
        nm_inreg=ptr(getattr(dev, "nm_inreg_t", None)),
        nm_start=ptr(getattr(dev, "nm_start_t", None)),
        res=ptr(res), any_used=ptr(any_used),
        thr1_rs=s1, threv_rs=sv, inl_rs=il[2],
        thr1_rows=r1, threv_rows=rv, inl_rows=il[1], F=F, n2=n2, part=part,
        npt=-(-n2 // part), ncols=0 if npeak is None else npeak.shape[1],
        tfe=int(cp.get("tonefix_end", 0)), m6=int(m6),
        normalize=int(normalize), lanes_m6=lm, lanes_nm=ln,
        prepoint=f32(cp["prepoint"]), prae=f32(0.34),
        thresh=f32(nm["thresh"]) if normalize else f32(0.0))
    return a, res, any_used, keep, key


class CoupleQuantizeKernel:
    """`self(dev, md, curve, used, F, thr1=None, threv=None, inlimit=None,
    lowpass=None, epeak=None, npeak=None)` -> (res (F, 2 n2) float32,
    any_used (F,) bool), as couple_quantize_plain: on CPU tensors the
    plain version; on CUDA tensors one launch of csrc/couple_quantize.cu
    on the current stream, or an exception.  `launches` counts the
    kernel's launches (and nothing else), `instances` them by INSTANCES
    key."""

    def __init__(self):
        self.launches = 0
        self.instances = Counter()

    def __call__(self, dev, md, curve, used, F, thr1=None, threv=None,
                 inlimit=None, lowpass=None, epeak=None, npeak=None):
        if md.device.type == "cpu":
            return couple_quantize_plain(dev, md, curve, used, F, thr1,
                                         threv, inlimit, lowpass, epeak,
                                         npeak)
        if md.device.type != "cuda":
            raise ValueError(f"couple quantize: unsupported device "
                             f"{md.device}")
        a, res, any_used, _keep, key = args(dev, md, curve, used, F, thr1,
                                            threv, inlimit, lowpass, epeak,
                                            npeak)
        if F == 0:
            return res, any_used
        rc = load_library().vtt_couple_quantize(
            ctypes.byref(a), torch.cuda.current_stream(md.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"couple_quantize kernel launch failed: "
                               f"cudaError {rc}")
        self.launches += 1
        self.instances[key] += 1
        return res, any_used


couple_quantize = CoupleQuantizeKernel()
