"""LPC edge extrapolation (reference: lib/lpc.c, used by the encoder
for stream-edge priming and EOS tail synthesis, lib/block.c).

Levinson-Durbin on double autocorrelation with .99 damping, float32
prediction filter.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32


def lpc_from_data(data: np.ndarray, m: int) -> np.ndarray:
    """n samples -> m float32 LPC coefficients."""
    n = len(data)
    d = data.astype(np.float64)
    aut = np.zeros(m + 1)
    for j in range(m + 1):
        # sequential double accumulation (np.dot's pairwise/BLAS order
        # would round differently and change the extrapolated samples)
        acc = 0.0
        a = d[j:]
        b = d[:n - j]
        prods = a * b  # element products are exact in double? no —
        # each product rounds identically to C's (double*double), and
        # the SUM must be sequential:
        for v in prods:
            acc += float(v)
        aut[j] = acc
    lpc = np.zeros(m)
    error = aut[0] * (1.0 + 1e-10)
    epsilon = 1e-9 * aut[0] + 1e-10
    for i in range(m):
        r = -aut[i + 1]
        if error < epsilon:
            lpc[i:] = 0.0
            break
        for j in range(i):
            r -= lpc[j] * aut[i - j]
        r /= error
        lpc[i] = r
        half = i // 2
        for j in range(half):
            tmp = lpc[j]
            lpc[j] += r * lpc[i - 1 - j]
            lpc[i - 1 - j] += r * tmp
        if i & 1:
            lpc[half] += lpc[half] * r
        error *= 1.0 - r * r
    g = 0.99
    damp = g
    for j in range(m):
        lpc[j] *= damp
        damp *= g
    return lpc.astype(np.float32)


def _lpc_from_data_fast(data: np.ndarray, m: int) -> np.ndarray:
    """lpc_from_data with np.dot autocorrelation: ~1000x faster than
    the sequential-sum version but rounds the lags differently, so it
    serves only the synthetic edge pads (lpc_extrapolate) where the C
    sum order is not load-bearing."""
    n = len(data)
    d = data.astype(np.float64)
    aut = np.array([float(np.dot(d[j:], d[:n - j]))
                    for j in range(m + 1)])
    lpc = np.zeros(m)
    error = aut[0] * (1.0 + 1e-10)
    epsilon = 1e-9 * aut[0] + 1e-10
    for i in range(m):
        r = -aut[i + 1]
        if error < epsilon:
            lpc[i:] = 0.0
            break
        for j in range(i):
            r -= lpc[j] * aut[i - j]
        r /= error
        lpc[i] = r
        half = i // 2
        for j in range(half):
            tmp = lpc[j]
            lpc[j] += r * lpc[i - 1 - j]
            lpc[i - 1 - j] += r * tmp
        if i & 1:
            lpc[half] += lpc[half] * r
        error *= 1.0 - r * r
    g = 0.99
    damp = g
    for j in range(m):
        lpc[j] *= damp
        damp *= g
    return lpc.astype(np.float32)


def lpc_predict(coeff: np.ndarray, prime: np.ndarray, m: int,
                n: int) -> np.ndarray:
    """Run the prediction filter for n samples (float32 accumulation,
    matching the reference's running work buffer)."""
    work = np.zeros(m + n, dtype=np.float32)
    if prime is not None:
        work[:m] = prime[:m]
    rev = coeff[::-1].astype(np.float32)
    for i in range(n):
        y = f32(0.0)
        for j in range(m):
            y = f32(y - f32(work[i + j] * rev[j]))
        work[m + i] = y
    return work[m:]


def lpc_extrapolate(data: np.ndarray, order: int, n: int) -> np.ndarray:
    """Continue `data` (1-D float32) forward by n samples with an
    order-`order` LPC fit — the reference's stream-edge extension
    (block.c:438-477 pre-extrapolation, 497-537 eof tail).  The fast
    encoder uses it to fill its lap pads so the envelope detector and
    psy model see a smooth lead-in/out instead of a zero-pad edge
    (which reads as a transient).  The pads are synthetic, so exact
    f32 op order is not load-bearing: scipy's lfilter runs the AR
    recursion ~1000x faster than the per-sample python filter;
    lpc_predict remains the fallback."""
    data = np.asarray(data, np.float32)
    if len(data) < order * 2 or n <= 0:
        return np.zeros(max(n, 0), np.float32)
    coeff = _lpc_from_data_fast(data, order)
    try:
        from scipy import signal
        A = np.concatenate([[1.0], np.asarray(coeff, np.float64)])
        zi = signal.lfiltic([1.0], A,
                            data[-order:][::-1].astype(np.float64))
        y, _ = signal.lfilter([1.0], A, np.zeros(n), zi=zi)
        if not np.isfinite(y).all():
            return np.zeros(n, np.float32)
        return y.astype(np.float32)
    except ImportError:
        return lpc_predict(coeff, data[-order:], order, n)
