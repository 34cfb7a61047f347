"""Scale conversions: dB, Bark, octave (reference: lib/scales.h).

The numpy half is a copy of vorbis_tpu/utils/scales.py, kept
line-aligned with it: the todB constants and the init-time scalar
conversions (`toBARK`, `toOC`, `fromOC`) that the psy tables
(ops/psy.py) are built from, and the numpy branches of `todB` and
`unitnorm` as `todB_np` and `unitnorm_np` (the golden encoder's host
copies run them).  `todB` and `unitnorm` are the port's own, on torch
tensors:

todB is the IEEE-754 bit-cast linear approximation (lib/scales.h), not
20log10: reinterpret |x| as an integer, then u * 7.17711438e-7f -
764.6161886f, all in float32.  The sign bit is cleared on the int32
view, so the value stays below 2^31 and the int32 -> float32 cast
rounds exactly like the reference's uint32 -> float32 one.
"""

from __future__ import annotations

import numpy as np
import torch

_TODB_SCALE = np.float32(7.17711438e-7)
_TODB_BIAS = np.float32(764.6161886)


# float32-representable Python scalars: torch casts a Python scalar to
# the tensor's dtype, so these reproduce the np.float32 constants
TODB_SCALE = float(_TODB_SCALE)
TODB_BIAS = float(_TODB_BIAS)


def todB(x: torch.Tensor) -> torch.Tensor:
    """Vectorized bit-cast 20log10 approximation, float32-exact."""
    u = x.to(torch.float32).view(torch.int32) & 0x7FFFFFFF
    return u.to(torch.float32) * TODB_SCALE - TODB_BIAS


def unitnorm(x: torch.Tensor) -> torch.Tensor:
    """+-1 with the sign of x (bit trick: sign bit | 1.0f)."""
    u = x.to(torch.float32).view(torch.int32)
    return ((u & -0x80000000) | 0x3F800000).view(torch.float32)


# The numpy branches of the source's todB and unitnorm (its xp=np path),
# under names of their own: the host copies (the golden encoder's
# codec/encoder.py, ops/psy.py, ops/envelope.py) import them as todB and
# unitnorm.

def todB_np(x):
    """Vectorized bit-cast 20log10 approximation, float32-exact."""
    # as in the source: a float64 or Python scalar raises here
    np.abs(x).view(np.uint32)
    u = (np.asarray(x, dtype=np.float32).view(np.uint32)
         & np.uint32(0x7FFFFFFF))
    return u.astype(np.float32) * _TODB_SCALE - _TODB_BIAS


def unitnorm_np(x):
    """+-1 with the sign of x (bit trick: sign bit | 1.0f)."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((u & np.uint32(0x80000000)) | np.uint32(0x3F800000)).view(
        np.float32)


# Init-time scalar versions.  The C macros use f-suffixed float
# constants promoted into double expressions (scales.h); reproduce the
# float32-rounded constant values exactly.
_C = lambda v: float(np.float32(v))


def toBARK(n) -> float:
    """C macro semantics: with an integer argument, each atan argument
    is a float-const*int product computed (and rounded) in float32;
    the atans and the final sum are double."""
    import math
    if isinstance(n, (int, np.integer)):
        # float-const * int: the int converts to float32 first, then a
        # single-precision multiply
        nf = np.float32(int(n))
        a1 = float(np.float32(0.00074) * nf)
        a2 = float(np.float32(np.float32(int(n) * int(n)))
                   * np.float32(1.85e-8))
        a3 = float(np.float32(1e-4) * nf)
        return (_C(13.1) * math.atan(a1) + _C(2.24) * math.atan(a2) + a3)
    return (_C(13.1) * math.atan(_C(0.00074) * n)
            + _C(2.24) * math.atan(n * n * _C(1.85e-8)) + _C(1e-4) * n)


def toOC(n: float) -> float:
    import math
    return math.log(n) * _C(1.442695) - _C(5.965784)


def fromOC(o: float) -> float:
    import math
    return math.exp((o + _C(5.965784)) * _C(0.693147))

