"""Build and bind the port's compiled code (counterpart of
vorbis_tpu/native.py).

Every source under `csrc/` is compiled at first use into
build/vorbis_tpu_torch/ beside the package, under a name keyed by a hash
of the source and the flags, and bound with ctypes: the host C
(`csrc/host_ogg.c`: the Ogg page CRC, the audio pager, the stretch-rescue
walk and the blockout schedule; `csrc/host_decode.c`: the decode half of
native/vorbisnative.c, with the source's own flags) with `cc`, the CUDA
kernels (`ops/floor_cuda.py`, `ops/m3_cuda.py`, `ops/imdct_cuda.py`) with
`nvcc`.  There is no fall-back: a missing compiler or a failed build
raises.
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
HOST_DECODE = PKG / "csrc" / "host_decode.c"
# native/build.sh's flags: no FMA contraction, so the IMDCT's products
# round one by one as in the reference and the numpy transform
DECODE_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC",
                "-shared")


def build_library(source: Path, compiler, flags, stem: str,
                  extra=(), libs=()) -> tuple[Path, str]:
    """Compile `source` into a shared library unless the build of this
    source and these flags exists.  `compiler()` names the compiler; it
    is asked only when a build is needed.  Returns (path, compiler
    report); the report is empty when the library was already built.
    `extra` flags do not enter the hash (diagnostics such as
    -Xptxas=-v); `libs` follow the source on the command line."""
    h = hashlib.sha256(source.read_bytes() + " ".join(
        (*flags, *libs)).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{stem}-{h}.so"
    if so.exists():
        return so, ""
    tool = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [tool, *flags, *extra, "-o", str(tmp), str(source), *libs]
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


def build_decode() -> tuple[Path, str]:
    """Compile csrc/host_decode.c unless its build exists."""
    return build_library(HOST_DECODE, host_compiler, DECODE_FLAGS,
                         "libhostdecode", libs=("-lm",))


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


@lru_cache(maxsize=None)
def decode_library() -> ctypes.CDLL:
    """csrc/host_decode.c, built at first use.  Its entry points take
    their arguments as explicit ctypes values, as vorbis_tpu/native.py
    binds the same functions."""
    lib = ctypes.CDLL(str(build_decode()[0]))
    for fn in ("vn_parse_packets", "vn_scan_W", "vn_decode_stream",
               "vn_ogg_scan", "vn_imdct_batch", "vn_imdct_batch16",
               "vn_lap_add"):
        getattr(lib, fn).restype = ctypes.c_long
    return lib


# ---- bindings of the decode library (copies of vorbis_tpu/native.py
# :464-512, :529-631 and :673-709; the "or None without the library"
# branches go: a failed build raises) ----

class HuffDecoder:
    """Two-level table Huffman decoder over a codebook (built once per
    Codebook; reference: codebook.c decode_packed_entry_number's
    firsttable + bisection replaced by an explicit escape table)."""

    K = 10

    def __init__(self, codewords, lengths, K2=None):
        self.ok = True
        K = self.K
        lengths = np.asarray(lengths, np.int64)
        maxlen = int(lengths.max(initial=0))
        K2 = K2 or max(1, maxlen - K)
        self.K2 = K2
        t1 = np.full(1 << K, -1, np.int32)
        groups = {}
        for e in range(len(lengths)):
            ln = int(lengths[e])
            if ln == 0:
                continue
            c = int(codewords[e])
            if ln <= K:
                t1[c::1 << ln] = (e << 6) | ln
            else:
                groups.setdefault(c & ((1 << K) - 1), []).append(
                    (c, ln, e))
        sec = []
        offs = [0]
        for w, items in groups.items():
            t2 = np.full(1 << K2, -1, np.int32)
            for c, ln, e in items:
                rest = c >> K
                step = 1 << (ln - K)
                t2[rest::step] = (e << 6) | ln
            t1[w] = -(len(sec)) - 2   # escape to secondary table
            sec.append(t2)
            offs.append(offs[-1] + (1 << K2))
        self.t1 = np.ascontiguousarray(t1)
        self.sec = (np.concatenate(sec).astype(np.int32)
                    if sec else np.zeros(1, np.int32))
        self.sec = np.ascontiguousarray(self.sec)
        self.offs = np.ascontiguousarray(np.asarray(offs, np.int64))


class _ImTab(ctypes.Structure):
    """Mirrors native vn_imtab (int32 n, nstages, then 14 pointers)."""
    _fields_ = [("n", ctypes.c_int32), ("nstages", ctypes.c_int32),
                ("T", ctypes.c_void_p), ("sa", ctypes.c_void_p),
                ("sb", ctypes.c_void_p), ("ia", ctypes.c_void_p),
                ("ib", ctypes.c_void_p), ("ta", ctypes.c_void_p),
                ("tb", ctypes.c_void_p), ("stageP", ctypes.c_void_p),
                ("tc_all", ctypes.c_void_p), ("e0", ctypes.c_void_p),
                ("e1", ctypes.c_void_p), ("tC", ctypes.c_void_p),
                ("tD", ctypes.c_void_p), ("stage_off", ctypes.c_void_p)]


@lru_cache(maxsize=None)
def _imdct_pack(n):
    """Marshaled IMDCT index tables for blocksize n (cached; the pack
    dict pins the arrays and carries a ready vn_imtab struct)."""
    from .ops.mdct import _imdct_index_tables
    tbl = _imdct_index_tables(n)
    stageP = np.asarray([p for p, _ in tbl["stages"]], np.int32)
    offs, tcs = [], []
    acc = 0
    for _, tc in tbl["stages"]:
        offs.append(acc)
        tcs.append(np.asarray(tc, np.int32))
        acc += len(tc)
    pack = dict(
        T=np.ascontiguousarray(tbl["T"], np.float32),
        ia=np.ascontiguousarray(tbl["ia"], np.int32),
        ib=np.ascontiguousarray(tbl["ib"], np.int32),
        ta=np.ascontiguousarray(tbl["ta"], np.int32),
        tb=np.ascontiguousarray(tbl["tb"], np.int32),
        sa=np.ascontiguousarray(tbl["sa"], np.float32),
        sb=np.ascontiguousarray(tbl["sb"], np.float32),
        stageP=stageP,
        stage_off=np.asarray(offs, np.int64),
        tc_all=(np.concatenate(tcs).astype(np.int32)
                if tcs else np.zeros(1, np.int32)),
        e0=np.ascontiguousarray(tbl["e0"], np.int32),
        e1=np.ascontiguousarray(tbl["e1"], np.int32),
        tC=np.ascontiguousarray(tbl["tC"], np.int32),
        tD=np.ascontiguousarray(tbl["tD"], np.int32))
    t = _ImTab()
    t.n = n
    t.nstages = len(pack["stageP"])
    for f in ("T", "sa", "sb", "ia", "ib", "ta", "tb", "stageP",
              "tc_all", "e0", "e1", "tC", "tD", "stage_off"):
        setattr(t, f, pack[f].ctypes.data)
    pack["tab"] = t
    return pack


def imdct_tab(n):
    """ctypes vn_imtab for blocksize n."""
    return _imdct_pack(n)["tab"]


def imdct_batch(spec: np.ndarray, n: int):
    """Host C bit-exact batched IMDCT (vn_imdct_batch): (B, n//2)
    float32 -> (B, n)."""
    L = decode_library()
    pack = _imdct_pack(n)
    spec = np.ascontiguousarray(spec, np.float32)
    B = spec.shape[0]
    out = np.empty((B, n), np.float32)

    def ptr(a):
        return ctypes.c_void_p(a.ctypes.data)

    common = (ctypes.c_int(n), ptr(pack["T"]),
              ptr(pack["ia"]), ptr(pack["ib"]), ptr(pack["ta"]),
              ptr(pack["tb"]), ptr(pack["sa"]), ptr(pack["sb"]),
              ptr(pack["stageP"]), ptr(pack["stage_off"]),
              ctypes.c_int(len(pack["stageP"])), ptr(pack["tc_all"]),
              ptr(pack["e0"]), ptr(pack["e1"]), ptr(pack["tC"]),
              ptr(pack["tD"]))
    # bulk frames ride the 16-lane frame-tiled kernel (bit-identical
    # per-frame op order, AVX-vectorized across frames); the remainder
    # takes the scalar kernel
    VNL = 16
    Bt = (B // VNL) * VNL
    if Bt:
        scratch16 = np.empty(3 * (n // 2) * VNL, np.float32)
        L.vn_imdct_batch16(ptr(spec), ctypes.c_long(Bt), *common,
                           ptr(out), ptr(scratch16))
    if Bt < B:
        scratch = np.empty(n // 2, np.float32)
        L.vn_imdct_batch(
            ctypes.c_void_p(spec[Bt:].ctypes.data), ctypes.c_long(B - Bt),
            *common, ctypes.c_void_p(out[Bt:].ctypes.data), ptr(scratch))
    return out


def ogg_scan(data: bytes, serialno=None):
    """Host C Ogg page walk -> packet arrays in ONE call (vn_ogg_scan).
    Returns (blob uint8, off, lens, gp, eos, serial): packet i is
    blob[off[i]:off[i]+lens[i]], gp -1 where the page granulepos doesn't
    land on it."""
    L = decode_library()
    arr = np.frombuffer(data, np.uint8)
    n = len(arr)
    blob = np.empty(n + 8, np.uint8)
    maxpkt = n // 16 + 64

    def ptr(a):
        return ctypes.c_void_p(a.ctypes.data)

    while True:
        off = np.empty(maxpkt, np.int64)
        lens = np.empty(maxpkt, np.int64)
        gp = np.empty(maxpkt, np.int64)
        eos = np.empty(maxpkt, np.uint8)
        ser = np.asarray(
            [-1 if serialno is None else int(serialno)], np.int64)
        got = L.vn_ogg_scan(ptr(arr), ctypes.c_long(n), ptr(ser), ptr(blob),
                            ptr(off), ptr(lens), ptr(gp), ptr(eos),
                            ctypes.c_long(maxpkt))
        if got >= 0:
            return (blob, off[:got], lens[:got], gp[:got], eos[:got],
                    int(ser[0]))
        maxpkt *= 4
        if maxpkt > 4 * n + 1024:
            raise RuntimeError("ogg_scan packet overflow")
