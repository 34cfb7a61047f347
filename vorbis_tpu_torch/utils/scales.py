"""Torch counterpart of the jnp branch of vorbis_tpu/utils/scales.py.

todB is the IEEE-754 bit-cast linear approximation (lib/scales.h), not
20log10: reinterpret |x| as an integer, then u * 7.17711438e-7f -
764.6161886f, all in float32.  The sign bit is cleared on the int32
view, so the value stays below 2^31 and the int32 -> float32 cast
rounds exactly like the reference's uint32 -> float32 one.
"""

from __future__ import annotations

import torch

from vorbis_tpu.utils.scales import _TODB_BIAS, _TODB_SCALE

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
