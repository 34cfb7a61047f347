"""Batched MDCT/IMDCT with reference-exact float32 semantics.

The Vorbis decode contract is bit-exact float PCM, which pins down not
just the transform but the *rounding path* of every float op.  The
reference computes its IMDCT as pre-rotation -> log2(n)-5 radix-2
butterfly stages (each complex twiddle evaluated as exactly two
multiplies and one add per output) -> bitreversal rotation -> final
rotation with symmetric expansion (reference: lib/mdct.c mdct_backward
/ mdct_butterflies / mdct_bitreverse; trig layout from mdct_init).

Here the same dataflow is expressed as *vectorized stages over a frame
batch*: each stage is a gather + elementwise multiply/add over the
whole (batch, n) array.  Because each output element's expression tree
is identical to the reference's scalar computation, IEEE float32
elementwise ops reproduce its results bit-for-bit, while XLA still sees
wide, fusable vector ops (this is also how an FFT wants to be written
for the TPU's 8x128 VPU: no scalar loops, no data-dependent control
flow, log2(n) dense stages).

Everything here is pure-functional and works with either numpy or
jax.numpy as the array module (xp=...).

Copy of vorbis_tpu/ops/mdct.py, kept line-aligned with it; the port
calls it with numpy only.  Two uses: `imdct` in the port's host decoder
(codec/decoder.py), and `mdct_basis_np` (at the end, the port's own),
the dense basis of the forward MDCT that the device analysis runs as one
fp32 matmul (counterpart of vorbis_tpu/ops/jaxdsp.py `_mdct_basis` /
`mdct_matmul`).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

cPI1_8 = np.float32(0.92387953)
cPI2_8 = np.float32(0.70710678)
cPI3_8 = np.float32(0.38268343)


@lru_cache(maxsize=None)
def mdct_tables(n: int):
    """Trig + index tables for block size n (matches mdct_init layout:
    T[0:n2] interleaved cos/-sin of 4i*pi/n; T[n2:n] cos/sin of odd half
    angles; T[n:n+n4] half-scaled cos/-sin; bitrev pairs)."""
    log2n = int(round(math.log2(n)))
    n2, n4, n8 = n >> 1, n >> 2, n >> 3
    T = np.zeros(n + n4, dtype=np.float32)
    i = np.arange(n4, dtype=np.float64)
    T[0:n2:2] = np.cos((math.pi / n) * (4 * i)).astype(np.float32)
    T[1:n2:2] = (-np.sin((math.pi / n) * (4 * i))).astype(np.float32)
    T[n2:n:2] = np.cos((math.pi / (2 * n)) * (2 * i + 1)).astype(np.float32)
    T[n2 + 1:n:2] = np.sin((math.pi / (2 * n)) * (2 * i + 1)).astype(np.float32)
    i8 = np.arange(n8, dtype=np.float64)
    T[n::2] = (np.cos((math.pi / n) * (4 * i8 + 2)) * 0.5).astype(np.float32)
    T[n + 1::2] = (-np.sin((math.pi / n) * (4 * i8 + 2)) * 0.5).astype(np.float32)

    # bit-reversed complex-pair index table
    mask = (1 << (log2n - 1)) - 1
    msb = 1 << (log2n - 2)
    bitrev = np.zeros(n4, dtype=np.int64)
    for ii in range(n8):
        acc = 0
        j = 0
        while msb >> j:
            if (msb >> j) & ii:
                acc |= 1 << j
            j += 1
        bitrev[2 * ii] = ((~acc) & mask) - 1
        bitrev[2 * ii + 1] = acc
    return log2n, T, bitrev


@lru_cache(maxsize=None)
def _imdct_index_tables(n: int):
    """Precomputed gather indices for the vectorized IMDCT stages."""
    log2n, T, bitrev = mdct_tables(n)
    n2, n4, n8 = n >> 1, n >> 2, n >> 3

    # --- stage A: pre-rotation.  Two interleaved loops over the input
    # spectrum write the working vector y[0:n2] (which the reference
    # stores at out[n2:n]).  Loop 1 consumes odd input indices from the
    # top down; loop 2 consumes even input indices.
    ia = np.zeros(n2, dtype=np.int64)   # first input gather
    ib = np.zeros(n2, dtype=np.int64)   # second input gather
    ta = np.zeros(n2, dtype=np.int64)   # first trig gather
    tb = np.zeros(n2, dtype=np.int64)   # second trig gather
    sa = np.zeros(n2, dtype=np.float32)  # sign of first product
    t = np.arange(n2 // 8)
    p = n2 - 7 - 8 * t                  # odd input base (loop 1)
    yb = n4 - 4 * (t + 1)               # output base (loop 1, descending)
    tb1 = n4 + 4 * t
    # y[yb+0] = -in[p+2]*T[tb+3] - in[p+0]*T[tb+2]
    ia[yb + 0], ta[yb + 0], ib[yb + 0], tb[yb + 0], sa[yb + 0] = p + 2, tb1 + 3, p + 0, tb1 + 2, -1.0
    # y[yb+1] =  in[p+0]*T[tb+3] - in[p+2]*T[tb+2]
    ia[yb + 1], ta[yb + 1], ib[yb + 1], tb[yb + 1], sa[yb + 1] = p + 0, tb1 + 3, p + 2, tb1 + 2, 1.0
    # y[yb+2] = -in[p+6]*T[tb+1] - in[p+4]*T[tb+0]
    ia[yb + 2], ta[yb + 2], ib[yb + 2], tb[yb + 2], sa[yb + 2] = p + 6, tb1 + 1, p + 4, tb1 + 0, -1.0
    # y[yb+3] =  in[p+4]*T[tb+1] - in[p+6]*T[tb+0]
    ia[yb + 3], ta[yb + 3], ib[yb + 3], tb[yb + 3], sa[yb + 3] = p + 4, tb1 + 1, p + 6, tb1 + 0, 1.0
    p2 = n2 - 8 - 8 * t                 # even input base (loop 2)
    yb2 = n4 + 4 * t                    # output base (loop 2, ascending)
    tb2 = n4 - 4 * (t + 1)
    # y[yb2+0] = in[p2+4]*T[tb2+3] + in[p2+6]*T[tb2+2]  (note +)
    ia[yb2 + 0], ta[yb2 + 0], ib[yb2 + 0], tb[yb2 + 0], sa[yb2 + 0] = p2 + 4, tb2 + 3, p2 + 6, tb2 + 2, 1.0
    ia[yb2 + 1], ta[yb2 + 1], ib[yb2 + 1], tb[yb2 + 1], sa[yb2 + 1] = p2 + 4, tb2 + 2, p2 + 6, tb2 + 3, 1.0
    ia[yb2 + 2], ta[yb2 + 2], ib[yb2 + 2], tb[yb2 + 2], sa[yb2 + 2] = p2 + 0, tb2 + 1, p2 + 2, tb2 + 0, 1.0
    ia[yb2 + 3], ta[yb2 + 3], ib[yb2 + 3], tb[yb2 + 3], sa[yb2 + 3] = p2 + 0, tb2 + 0, p2 + 2, tb2 + 1, 1.0
    # second product sign: +1 for loop2 rows 0 and 2... careful:
    # loop2: y0 = +x*T + +x*T ; y1 = +x*T - x*T ; y2 = + + ; y3 = + -
    sb = np.zeros(n2, dtype=np.float32)
    sb[yb + 0] = -1.0
    sb[yb + 1] = -1.0
    sb[yb + 2] = -1.0
    sb[yb + 3] = -1.0
    sb[yb2 + 0] = 1.0
    sb[yb2 + 1] = -1.0
    sb[yb2 + 2] = 1.0
    sb[yb2 + 3] = -1.0

    # --- stage B: butterfly trig index per stage
    stages = []
    P = n2
    si = 0
    while P > 32:
        stride = 4 << si
        nc = P // 4                    # complexes per block
        j = np.arange(nc)
        c = nc - 1 - j                 # complex index counted from top
        tc = stride * c
        stages.append((P, tc))
        P >>= 1
        si += 1

    # --- stage C: bitreverse rotation
    m = np.arange(n8)
    e0 = bitrev[2 * m]
    e1 = bitrev[2 * m + 1]
    tC = n + 2 * m

    # --- stage D trig
    cD = np.arange(n4)
    tD = n2 + 2 * cD

    return dict(log2n=log2n, T=T, ia=ia, ib=ib, ta=ta, tb=tb, sa=sa, sb=sb,
                stages=stages, e0=e0, e1=e1, tC=tC, tD=tD)


def _bf8(x, xp):
    """8-point butterfly tail, vectorized over leading dims (..., 8)."""
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    x4, x5, x6, x7 = x[..., 4], x[..., 5], x[..., 6], x[..., 7]
    r0 = x6 + x2
    r1 = x6 - x2
    r2 = x4 + x0
    r3 = x4 - x0
    n6 = r0 + r2
    n4 = r0 - r2
    s0 = x5 - x1
    s2 = x7 - x3
    n0 = r1 + s0
    n2 = r1 - s0
    u0 = x5 + x1
    u1 = x7 + x3
    n3 = s2 + r3
    n1 = s2 - r3
    n7 = u1 + u0
    n5 = u1 - u0
    return xp.stack([n0, n1, n2, n3, n4, n5, n6, n7], axis=-1)


def _bf16(x, xp):
    """16-point butterfly, vectorized (..., 16)."""
    c2 = cPI2_8
    g = lambda i: x[..., i]
    r0 = g(1) - g(9)
    r1 = g(0) - g(8)
    n8 = g(8) + g(0)
    n9 = g(9) + g(1)
    n0 = (r0 + r1) * c2
    n1 = (r0 - r1) * c2
    r0b = g(3) - g(11)
    r1b = g(10) - g(2)
    n10 = g(10) + g(2)
    n11 = g(11) + g(3)
    n2 = r0b
    n3 = r1b
    r0c = g(12) - g(4)
    r1c = g(13) - g(5)
    n12 = g(12) + g(4)
    n13 = g(13) + g(5)
    n4 = (r0c - r1c) * c2
    n5 = (r0c + r1c) * c2
    r0d = g(14) - g(6)
    r1d = g(15) - g(7)
    n14 = g(14) + g(6)
    n15 = g(15) + g(7)
    n6 = r0d
    n7 = r1d
    y = xp.stack([n0, n1, n2, n3, n4, n5, n6, n7,
                  n8, n9, n10, n11, n12, n13, n14, n15], axis=-1)
    return xp.concatenate([_bf8(y[..., :8], xp), _bf8(y[..., 8:], xp)],
                          axis=-1)


def _bf32(x, xp):
    """32-point butterfly, vectorized (..., 32)."""
    c1, c2, c3 = cPI1_8, cPI2_8, cPI3_8
    g = lambda i: x[..., i]
    r0 = g(30) - g(14)
    r1 = g(31) - g(15)
    n30 = g(30) + g(14)
    n31 = g(31) + g(15)
    n14 = r0
    n15 = r1
    r0b = g(28) - g(12)
    r1b = g(29) - g(13)
    n28 = g(28) + g(12)
    n29 = g(29) + g(13)
    n12 = r0b * c1 - r1b * c3
    n13 = r0b * c3 + r1b * c1
    r0c = g(26) - g(10)
    r1c = g(27) - g(11)
    n26 = g(26) + g(10)
    n27 = g(27) + g(11)
    n10 = (r0c - r1c) * c2
    n11 = (r0c + r1c) * c2
    r0d = g(24) - g(8)
    r1d = g(25) - g(9)
    n24 = g(24) + g(8)
    n25 = g(25) + g(9)
    n8 = r0d * c3 - r1d * c1
    n9 = r1d * c3 + r0d * c1
    r0e = g(22) - g(6)
    r1e = g(7) - g(23)
    n22 = g(22) + g(6)
    n23 = g(23) + g(7)
    n6 = r1e
    n7 = r0e
    r0f = g(4) - g(20)
    r1f = g(5) - g(21)
    n20 = g(20) + g(4)
    n21 = g(21) + g(5)
    n4 = r1f * c1 + r0f * c3
    n5 = r1f * c3 - r0f * c1
    r0g = g(2) - g(18)
    r1g = g(3) - g(19)
    n18 = g(18) + g(2)
    n19 = g(19) + g(3)
    n2 = (r1g + r0g) * c2
    n3 = (r1g - r0g) * c2
    r0h = g(0) - g(16)
    r1h = g(1) - g(17)
    n16 = g(16) + g(0)
    n17 = g(17) + g(1)
    n0 = r1h * c3 + r0h * c1
    n1 = r1h * c1 - r0h * c3
    y = xp.stack([n0, n1, n2, n3, n4, n5, n6, n7, n8, n9, n10, n11,
                  n12, n13, n14, n15, n16, n17, n18, n19, n20, n21,
                  n22, n23, n24, n25, n26, n27, n28, n29, n30, n31],
                 axis=-1)
    return xp.concatenate([_bf16(y[..., :16], xp), _bf16(y[..., 16:], xp)],
                          axis=-1)


def imdct(spec, n: int, xp=np):
    """Inverse MDCT, batched.  spec: (..., n//2) float32 -> (..., n).

    Bit-exact reproduction of the reference decode transform
    (lib/mdct.c mdct_backward) as vectorized stages.
    """
    tbl = _imdct_index_tables(n)
    T = xp.asarray(tbl["T"])
    n2, n4 = n >> 1, n >> 2
    x = spec

    # stage A: pre-rotation
    y = (tbl["sa"] * x[..., tbl["ia"]] * T[tbl["ta"]]
         + tbl["sb"] * x[..., tbl["ib"]] * T[tbl["tb"]])

    # stage B: butterfly cascade
    for P, tc in tbl["stages"]:
        nblk = n2 // P
        yv = y.reshape(y.shape[:-1] + (nblk, P))
        lo = yv[..., :P // 2]
        hi = yv[..., P // 2:]
        new_hi = hi + lo
        r0 = hi[..., 0::2] - lo[..., 0::2]
        r1 = hi[..., 1::2] - lo[..., 1::2]
        Tc = T[tc]
        Ts = T[tc + 1]
        lo_e = r1 * Ts + r0 * Tc
        lo_o = r1 * Tc - r0 * Ts
        new_lo = xp.stack([lo_e, lo_o], axis=-1).reshape(lo.shape)
        y = xp.concatenate([new_lo, new_hi], axis=-1).reshape(y.shape)
    nblk = n2 // 32
    y = _bf32(y.reshape(y.shape[:-1] + (nblk, 32)), xp).reshape(y.shape)

    # stage C: bitreverse + half-angle rotation
    half = np.float32(0.5)
    a0 = y[..., tbl["e0"]]
    a1 = y[..., tbl["e0"] + 1]
    b0 = y[..., tbl["e1"]]
    b1 = y[..., tbl["e1"] + 1]
    Tc = T[tbl["tC"]]
    Ts = T[tbl["tC"] + 1]
    r0 = a1 - b1
    r1 = a0 + b0
    r2 = r1 * Tc + r0 * Ts
    r3 = r1 * Ts - r0 * Tc
    r0h = half * (a1 + b1)
    r1h = half * (a0 - b0)
    n8 = n >> 3
    lo = xp.stack([r0h + r2, r1h + r3], axis=-1).reshape(y.shape[:-1] + (n4,))
    # upper half is written top-down in complex pairs: reverse pair order
    # but keep (even, odd) order within each pair
    hi = xp.stack([r0h - r2, r3 - r1h], axis=-1)          # (..., n8, 2)
    hi = hi[..., ::-1, :].reshape(y.shape[:-1] + (n4,))
    z = xp.concatenate([lo, hi], axis=-1)

    # stage D: final rotation + symmetric expansion
    z0 = z[..., 0::2]
    z1 = z[..., 1::2]
    Tc = T[tbl["tD"]]
    Ts = T[tbl["tD"] + 1]
    a = z0 * Ts - z1 * Tc
    b = -(z0 * Tc + z1 * Ts)
    return xp.concatenate([a[..., ::-1], -a, b[..., ::-1], b], axis=-1)


@lru_cache(maxsize=None)
def _mdct_forward_index_tables(n: int):
    """Gather indices for the forward MDCT input fold (reference:
    lib/mdct.c mdct_forward scalar; three loops folding the windowed
    n-point input into an n/2 rotated working vector)."""
    _, T, _ = mdct_tables(n)
    n2, n4, n8 = n >> 1, n >> 2, n >> 3
    a0 = np.zeros(n4, dtype=np.int64)   # contributes to r0
    a1 = np.zeros(n4, dtype=np.int64)
    a2 = np.zeros(n4, dtype=np.int64)   # contributes to r1
    a3 = np.zeros(n4, dtype=np.int64)
    s01 = np.zeros(n4, dtype=np.float32)  # sign pair selectors
    s0 = np.zeros(n4, dtype=np.float32)
    s1 = np.zeros(n4, dtype=np.float32)
    tix = np.zeros(n4, dtype=np.int64)
    k = np.arange(n4)
    tix[:] = n2 - 2 * (k + 1)
    # loop A: k in [0, n8/2): r0 = in[n2+n4-4k-2] + in[n2+n4+4k+1]
    #                         r1 = in[n2+n4-4k-4] + in[n2+n4+4k+3]
    kA = np.arange(n8 // 2)
    a0[kA] = n2 + n4 - 4 * kA - 2
    a1[kA] = n2 + n4 + 4 * kA + 1
    a2[kA] = n2 + n4 - 4 * kA - 4
    a3[kA] = n2 + n4 + 4 * kA + 3
    s0[kA] = 1.0
    s1[kA] = 1.0
    # loop B: k in [n8/2, (n2-n8)/2): x1 rebased to in+1
    kB = np.arange(n8 // 2, (n2 - n8) // 2)
    j = kB - n8 // 2
    a0[kB] = n2 + n4 - 4 * kB - 2
    a1[kB] = 1 + 4 * j
    a2[kB] = n2 + n4 - 4 * kB - 4
    a3[kB] = 3 + 4 * j
    s0[kB] = 1.0
    s1[kB] = -1.0
    # loop C: k in [(n2-n8)/2, n4): x0 rebased to in+n
    kC = np.arange((n2 - n8) // 2, n4)
    m = kC - (n2 - n8) // 2
    j = kC - n8 // 2
    a0[kC] = n - 4 * m - 2
    a1[kC] = 1 + 4 * j
    a2[kC] = n - 4 * m - 4
    a3[kC] = 3 + 4 * j
    s0[kC] = -1.0
    s1[kC] = -1.0
    scale = np.float32(4.0 / n)
    return dict(a0=a0, a1=a1, a2=a2, a3=a3, s0=s0, s1=s1, tix=tix,
                scale=scale)


def mdct_forward(x, n: int, xp=np):
    """Forward MDCT, batched: (..., n) windowed PCM -> (..., n//2)
    spectrum, reference-exact float32."""
    tblB = _imdct_index_tables(n)
    tblF = _mdct_forward_index_tables(n)
    T = xp.asarray(tblB["T"])
    n2, n4 = n >> 1, n >> 2

    r0 = tblF["s0"] * x[..., tblF["a0"]] + tblF["s1"] * x[..., tblF["a1"]]
    r1 = tblF["s0"] * x[..., tblF["a2"]] + tblF["s1"] * x[..., tblF["a3"]]
    Tc = T[tblF["tix"]]
    Ts = T[tblF["tix"] + 1]
    w_e = r1 * Ts + r0 * Tc
    w_o = r1 * Tc - r0 * Ts
    y = xp.stack([w_e, w_o], axis=-1).reshape(x.shape[:-1] + (n2,))

    # butterfly cascade + bitreverse rotation (shared with imdct)
    for P, tc in tblB["stages"]:
        nblk = n2 // P
        yv = y.reshape(y.shape[:-1] + (nblk, P))
        lo = yv[..., :P // 2]
        hi = yv[..., P // 2:]
        new_hi = hi + lo
        rr0 = hi[..., 0::2] - lo[..., 0::2]
        rr1 = hi[..., 1::2] - lo[..., 1::2]
        Tcs = T[tc]
        Tss = T[tc + 1]
        lo_e = rr1 * Tss + rr0 * Tcs
        lo_o = rr1 * Tcs - rr0 * Tss
        new_lo = xp.stack([lo_e, lo_o], axis=-1).reshape(lo.shape)
        y = xp.concatenate([new_lo, new_hi], axis=-1).reshape(y.shape)
    nblk = n2 // 32
    y = _bf32(y.reshape(y.shape[:-1] + (nblk, 32)), xp).reshape(y.shape)

    half = np.float32(0.5)
    a0v = y[..., tblB["e0"]]
    a1v = y[..., tblB["e0"] + 1]
    b0v = y[..., tblB["e1"]]
    b1v = y[..., tblB["e1"] + 1]
    Tc = T[tblB["tC"]]
    Ts = T[tblB["tC"] + 1]
    rr0 = a1v - b1v
    rr1 = a0v + b0v
    rr2 = rr1 * Tc + rr0 * Ts
    rr3 = rr1 * Ts - rr0 * Tc
    r0h = half * (a1v + b1v)
    r1h = half * (a0v - b0v)
    lo = xp.stack([r0h + rr2, r1h + rr3], axis=-1).reshape(y.shape[:-1] + (n4,))
    hi = xp.stack([r0h - rr2, rr3 - r1h], axis=-1)
    hi = hi[..., ::-1, :].reshape(y.shape[:-1] + (n4,))
    w = xp.concatenate([lo, hi], axis=-1)

    # final rotation: out[i] and out[n2-1-i]
    scale = tblF["scale"]
    w0 = w[..., 0::2]
    w1 = w[..., 1::2]
    tD = tblB["tD"]
    Tc = T[tD]
    Ts = T[tD + 1]
    front = (w0 * Tc + w1 * Ts) * scale
    back = (w0 * Ts - w1 * Tc) * scale
    return xp.concatenate([front, back[..., ::-1]], axis=-1)


@lru_cache(maxsize=None)
def mdct_basis_np(n: int) -> np.ndarray:
    """Dense MDCT basis (n, n/2) float32: mdct(x) = x @ B.  Column by
    column it is the reference's transform (mdct_forward of the identity);
    the JAX fast step runs the butterfly itself, and the matmul agrees
    with it to about 1 ulp (tests/test_torch_analysis.py) and, with TF32
    off (the package's fp32 policy), runs as a full-fp32 GEMM on the
    card."""
    return np.asarray(mdct_forward(np.eye(n, dtype=np.float32), n),
                      np.float32)
