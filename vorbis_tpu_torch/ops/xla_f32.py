"""Float32 arithmetic rounded as the JAX package's jitted code rounds it
on the CPU, in eager PyTorch: the plain versions of csrc/mdct_fwd.cu
(ops/mdct_cuda.py) and csrc/bark_fit.cu (ops/bark_cuda.py) are written
with these operations, and the kernels with their PTX counterparts;
`block_cumsum` is jnp.cumsum's order of summation, `partition_sum` the
order of a jitted `x.reshape(..., part).sum(-1)`, `to_int32` XLA's
float -> int32 convert.

Two properties of XLA:CPU's code decide its float32 bits beyond IEEE
round-to-nearest:

- it runs with the x86 flush-to-zero and denormals-are-zero modes set: a
  subnormal operand reads as zero and a subnormal result is written as a
  zero of the same sign (`jax.jit(lambda a: a + a)` of 1e-40 is 0).  So
  every operation here flushes its result (`ftz`), and the callers flush
  their inputs once; no operand is then ever subnormal;
- LLVM contracts a product that feeds an add or a subtract into one
  fused multiply-add, which rounds once (`fma`).  Which product of
  `a*b + c*d` is fused is the compiler's choice, fixed for a given
  program; the callers spell out each site as measured against the JAX
  package (tests/test_torch_mdct.py).

`fma` is exact on any device: the product of two float32 values is
exact in float64, TwoSum gives the float64 sum's error, the sum is
rounded to odd on that error, and one rounding to float32 follows
(Boldo and Melquiond: round-to-odd at 53 bits then to 24 bits rounds
once).
"""

from __future__ import annotations

import torch

FLT_MIN = 2.0 ** -126


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to a zero of the same sign; every other value as is."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def add(a, b):
    return ftz(a + b)


def sub(a, b):
    return ftz(a - b)


def mul(a, b):
    return ftz(a * b)


def div(a, b):
    return ftz(a / b)


def fma(a, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once (then flushed), elementwise with
    broadcasting; a, b, c float32 tensors or Python floats that are
    float32 values."""
    a, b, c = (t.double() if torch.is_tensor(t) else t for t in (a, b, c))
    p = a * b                                  # exact in float64
    if not torch.is_tensor(c):
        c = torch.full_like(p, c)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)              # s + e == p + c exactly
    bits = s.view(torch.int64)
    # round to odd: an inexact sum with an even last bit steps one ulp
    # toward the exact value (s is never 0 when e is not)
    step = torch.where((e > 0) == (s > 0), 1, -1)
    odd = (e != 0) & ((bits & 1) == 0) & torch.isfinite(s)
    s = torch.where(odd, (bits + step).view(torch.float64), s)
    return ftz(s.float())


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA's convert (and the card's cvt.rzi) gives
    it: truncated toward zero, saturated at the int32 range, NaN to 0.
    Torch's CPU cast takes NaN, +inf and every value at or above 2^31 to
    INT_MIN."""
    big = x >= 2.0 ** 31
    y = torch.where(torch.isnan(x) | big, 0.0, x.clamp_min(-2.0 ** 31))
    return torch.where(big, 2 ** 31 - 1, y.to(torch.int32))


def block_cumsum(x, base=16):
    """Prefix sum over the last axis in the summation order of the JAX
    package's `jnp.cumsum` on the CPU (XLA rewrites the cumulative
    reduce-window into blocks of `base`): a sequential sum inside each
    block, the blocks' totals scanned the same way recursively, and
    each block's exclusive prefix added to its elements.  Written as
    explicit adds, so the card rounds exactly as the CPU does (a
    library scan would sum in its own order)."""
    n = x.shape[-1]
    if n == 0:
        return x
    m = -(-n // base) * base
    blk = torch.nn.functional.pad(x, (0, m - n)).reshape(
        x.shape[:-1] + (m // base, base))
    cols = [blk[..., 0]]
    for k in range(1, base):
        cols.append(cols[-1] + blk[..., k])
    inner = torch.stack(cols, -1)
    if m // base > 1:
        pre = block_cumsum(inner[..., -1], base)
        excl = torch.nn.functional.pad(pre[..., :-1], (1, 0))
        inner = inner + excl[..., None]
    return inner.reshape(x.shape[:-1] + (m,))[..., :n]


def partition_sum(x: torch.Tensor, part: int, lanes: int) -> torch.Tensor:
    """(..., m * part) -> (..., m): each partition of `part` values
    summed in the order XLA:CPU's jitted `reshape(..., m, part).sum(-1)`
    takes.  That order is the fusion's: `lanes` accumulators, lane l
    taking values l, l + lanes, l + 2 lanes, ... in turn, then the
    lanes folded in halves (l + (l + lanes/2), and so on down to one);
    `lanes` 1 is a left-to-right sum.  The callers name the lanes each
    site was measured to take (`SUM_LANES`, through `part_sum`).

    Written as slice adds, so every device rounds as the CPU does (a
    library reduction states no order: torch's CPU sum agrees with
    XLA's on about half of random 32-value partitions).  Each chain
    starts from its first value, not from 0.0: the two differ only
    for a partition of negative zeros."""
    if lanes < 1 or part % lanes or lanes & (lanes - 1):
        raise ValueError(f"partition_sum: {lanes} lanes over {part}")
    x = x.reshape(x.shape[:-1] + (-1, part))
    acc = x[..., 0:lanes]
    for k in range(lanes, part, lanes):
        acc = acc + x[..., k:k + lanes]
    while lanes > 1:
        lanes //= 2
        acc = acc[..., :lanes] + acc[..., lanes:2 * lanes]
    return acc[..., 0]


# The accumulators XLA:CPU sums a partition in, by site and partition
# width (partition_sum; 1 is left to right).  Its fusion decides them,
# so each was measured against the JAX package's jitted
# finish_from_posts, _couple_quantize and _couple_multi
# (tests/test_torch_couple.py, tests/test_torch_couple_orders.py):
# "m6" is M6's imbalance sum at both callers, "normalize" the coupled
# pair's normalize, "normalize_m6" the same after an M6 promotion ran,
# "normalize_multi" the chained coupling's, "normalize_uncoupled" the
# uncoupled branch's; the 5.1 uncoupled submap (the LFE, whose floor
# ends below the normalize region) takes the uncoupled branch's order,
# unmeasured there.  A row padded to whole partitions is summed left to
# right at every site.
SUM_LANES = {("m6", 32): 8, ("m6", 8): 1,
             ("normalize", 32): 16, ("normalize", 8): 1,
             ("normalize_m6", 32): 8, ("normalize_m6", 8): 8,
             ("normalize_multi", 32): 8, ("normalize_multi", 8): 8,
             ("normalize_uncoupled", 32): 1, ("normalize_uncoupled", 8): 1,
             ("normalize_submap", 32): 1, ("normalize_submap", 8): 1}


def part_sum(x, part, site, padded=False):
    """(..., m * part) -> (..., m) partition sums in XLA:CPU's order at
    `site` for rows padded (or not) from a width that is not a multiple
    of `part`; a width with no measured order raises."""
    if (site, part) not in SUM_LANES:
        raise ValueError(f"no measured summation order for partitions "
                         f"of {part} at {site}")
    return partition_sum(x, part, 1 if padded else SUM_LANES[site, part])
