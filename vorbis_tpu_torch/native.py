"""Build and bind the port's compiled code (counterpart of
vorbis_tpu/native.py).

Every source under `csrc/` is compiled at first use into
build/vorbis_tpu_torch/ beside the package, under a name keyed by a hash
of the source and the flags, and bound with ctypes: the host C
(`csrc/host_ogg.c`, the Ogg page CRC) with `cc`, the CUDA kernels
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
    return lib


def ogg_crc(data: bytes, crc: int = 0) -> int:
    """Ogg page CRC of `data` (poly 0x04c11db7, unreflected, init `crc`,
    no final xor) in the host C."""
    data = bytes(data)
    return int(host_library().vtt_ogg_crc(data, len(data), crc))
