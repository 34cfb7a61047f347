"""Build and bind the port's compiled code (counterpart of
vorbis_tpu/native.py).

Every source under `csrc/` is compiled at first use into
build/vorbis_tpu_torch/ beside the package, under a name keyed by a hash
of the source and the flags, and bound with ctypes: the host C
(`csrc/host_ogg.c`: the Ogg page CRC, the audio pager, the stretch-rescue
walk and the blockout schedule) with `cc`, the CUDA kernels
(`ops/floor_cuda.py`) with `nvcc`.  There is no fall-back: a missing
compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent
BUILD_DIR = PKG.parent / "build" / "vorbis_tpu_torch"
HOST_OGG = PKG / "csrc" / "host_ogg.c"
CC_FLAGS = ("-O3", "-fPIC", "-shared")


def build_library(source: Path, compiler, flags, stem: str,
                  extra=()) -> tuple[Path, str]:
    """Compile `source` into a shared library unless the build of this
    source and these flags exists.  `compiler()` names the compiler; it
    is asked only when a build is needed.  Returns (path, compiler
    report); the report is empty when the library was already built.
    `extra` flags do not enter the hash (diagnostics such as
    -Xptxas=-v)."""
    h = hashlib.sha256(source.read_bytes()
                       + " ".join(flags).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{stem}-{h}.so"
    if so.exists():
        return so, ""
    tool = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [tool, *flags, *extra, "-o", str(tmp), str(source)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"build failed ({r.returncode}): {' '.join(cmd)}"
                           f"\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so, r.stdout + r.stderr


def host_compiler() -> str:
    cc = os.environ.get("CC") or shutil.which("cc")
    if not cc:
        raise RuntimeError("no host C compiler: the port builds "
                           "csrc/host_ogg.c with `cc` (or $CC)")
    return cc


def build_host() -> tuple[Path, str]:
    """Compile csrc/host_ogg.c unless its build exists (build_library)."""
    return build_library(HOST_OGG, host_compiler, CC_FLAGS, "libhostogg")


@lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_host()[0]))
    lib.vtt_ogg_crc.restype = ctypes.c_uint32
    lib.vtt_ogg_crc.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                ctypes.c_uint32]
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    lib.vtt_ogg_pages.restype = ctypes.c_long
    lib.vtt_ogg_pages.argtypes = [
        u8, ctypes.c_long, u8, ctypes.c_long, i64, u8, i64, i64,
        ctypes.c_long, ctypes.c_uint32, ctypes.c_int, ctypes.c_int, u8, i64]
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    lib.vtt_rescue_walk.restype = ctypes.c_long
    lib.vtt_rescue_walk.argtypes = [u8, u8, ctypes.c_long, ctypes.c_long,
                                    i32, ctypes.c_int, u8, u8]
    lib.vtt_schedule.restype = ctypes.c_long
    lib.vtt_schedule.argtypes = [u8, ctypes.c_long, ctypes.c_long,
                                 ctypes.c_long, ctypes.c_long, i64, i64, u8]
    return lib


def ogg_crc(data: bytes, crc: int = 0) -> int:
    """Ogg page CRC of `data` (poly 0x04c11db7, unreflected, init `crc`,
    no final xor) in the host C."""
    data = bytes(data)
    return int(host_library().vtt_ogg_crc(data, len(data), crc))


def ogg_pages(pk_l, pk_s, ilk, isshort, sizes, gps, serialno, pageno,
              per_page=16, eos_last=True):
    """Assemble one stream's audio pages in one host C call.

    pk_l (Fl, wl) / pk_s (Fs, ws) uint8 packet rows (or 1-D blobs with
    byte offsets in ilk); per-packet ilk / isshort / sizes / gps.
    Returns (pages_bytes, next_pageno)."""
    pk_l = np.ascontiguousarray(pk_l, np.uint8)
    pk_s = np.ascontiguousarray(pk_s, np.uint8)
    ilk = np.ascontiguousarray(ilk, np.int64)
    iss = np.ascontiguousarray(isshort, np.uint8)
    sizes = np.ascontiguousarray(sizes, np.int64)
    gps = np.ascontiguousarray(gps, np.int64)
    npkt = len(sizes)
    cap = int(sizes.sum()) + npkt * (27 + 255) + 64
    out = np.empty(cap, np.uint8)
    pgio = np.array([pageno], np.int64)
    wl = pk_l.shape[1] if pk_l.ndim == 2 and pk_l.shape[0] else 1
    ws = pk_s.shape[1] if pk_s.ndim == 2 and pk_s.shape[0] else 1
    n = host_library().vtt_ogg_pages(
        pk_l, wl, pk_s, ws, ilk, iss, sizes, gps, npkt,
        serialno & 0xFFFFFFFF, per_page, 1 if eos_last else 0, out, pgio)
    return out[:n].tobytes(), int(pgio[0])


def rescue_walk(T1, T2, wlen, smax):
    """Stretch-rescue lockstep walk over the device-built trigger tables
    (T1/T2: (smax//2+1, C, Lw) bool, wlen: (C,) window lengths) in the
    host C.  Returns (newmk (C, Lw+2) bool, retrig (C,) bool).
    Reference state machine: envelope.c:569-681."""
    T1 = np.ascontiguousarray(T1, np.uint8)
    T2 = np.ascontiguousarray(T2, np.uint8)
    _, Cc, Lw = T1.shape
    wlen = np.ascontiguousarray(wlen, np.int32)
    # the walk reads T[stretch >> 1, c, k] for k < wlen[c]
    if (T2.shape != T1.shape or T1.shape[0] <= int(smax) >> 1
            or wlen.shape != (Cc,) or (wlen > Lw).any()):
        raise ValueError(f"rescue walk: tables {T1.shape} / {T2.shape}, "
                         f"wlen {wlen.shape} (max {wlen.max(initial=0)}), "
                         f"smax {smax}")
    newmk = np.zeros((Cc, Lw + 2), np.uint8)
    retrig = np.zeros(Cc, np.uint8)
    host_library().vtt_rescue_walk(T1, T2, Cc, Lw, wlen, int(smax), newmk,
                                   retrig)
    return newmk.astype(bool), retrig.astype(bool)


def schedule(marks, ns, n0, n1):
    """Envelope marks -> block schedule via the host C blockout state
    machine (reference: block.c:557-812).  Returns (centers, Ws,
    impulse)."""
    marks = np.ascontiguousarray(marks, np.uint8)
    nmk = len(marks)
    hop = n1 // 2
    cap = (hop + int(ns) - hop) // (n0 // 2) + 3
    centers = np.empty(cap, np.int64)
    Ws = np.empty(cap, np.int64)
    imp = np.empty(cap, np.uint8)
    cnt = host_library().vtt_schedule(marks, nmk, int(ns), int(n0),
                                      int(n1), centers, Ws, imp)
    assert 0 < cnt <= cap, (cnt, cap)
    return centers[:cnt], Ws[:cnt], imp[:cnt].astype(bool)
