"""Vorbis window application (encode side) and window table access.

Reference: lib/window.c _vorbis_apply_window — the hybrid window zeros
the lead-in/tail, rises with the previous block's half-window, and
falls with the (reversed) next block's half-window; for short blocks
(W=0) both halves use the short window.

Copy of vorbis_tpu/ops/window.py, kept line-aligned with it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..codec.decoder import window_half


@lru_cache(maxsize=None)
def hybrid_window(bs0: int, bs1: int, lW: int, W: int, nW: int) -> np.ndarray:
    """Full multiplicative window of length blocksizes[W] for the given
    (lW, W, nW) shape, as one float32 vector (zeros/ones included) so
    the application is a single elementwise multiply (batched on TPU)."""
    blocksizes = (bs0, bs1)
    lW = lW if W else 0
    nW = nW if W else 0
    n = blocksizes[W]
    ln = blocksizes[lW]
    rn = blocksizes[nW]
    leftbegin = n // 4 - ln // 4
    leftend = leftbegin + ln // 2
    rightbegin = n // 2 + n // 4 - rn // 4
    rightend = rightbegin + rn // 2
    w = np.ones(n, dtype=np.float32)
    w[:leftbegin] = 0.0
    w[leftbegin:leftend] = window_half(ln)
    w[rightbegin:rightend] = window_half(rn)[::-1]
    w[rightend:] = 0.0
    return w


def apply_window(pcm, bs0, bs1, lW, W, nW, xp=np):
    """pcm (..., n) -> windowed (..., n), float32-exact (the reference
    multiplies each sample by at most one window coefficient, so one
    fused elementwise multiply reproduces it)."""
    return pcm * xp.asarray(hybrid_window(bs0, bs1, lW, W, nW))
