"""Dense MDCT basis for the forward MDCT as one fp32 matmul (counterpart
of vorbis_tpu/ops/jaxdsp.py `_mdct_basis` / `mdct_matmul`).

The dense basis comes from the jax-free numpy butterfly,
`vorbis_tpu.ops.mdct.mdct_forward(np.eye(n))`, so it is the reference's
transform column by column; mdct(x) = x @ basis.  The JAX fast step runs
the butterfly itself; the matmul agrees with it to about 1 ulp
(tests/test_torch_analysis.py) and, with TF32 off (the package's fp32
policy), runs as a full-fp32 GEMM on the card.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from vorbis_tpu.ops.mdct import mdct_forward


@lru_cache(maxsize=None)
def mdct_basis_np(n: int) -> np.ndarray:
    """Dense MDCT basis (n, n/2) float32: mdct(x) = x @ B."""
    return np.asarray(mdct_forward(np.eye(n, dtype=np.float32), n),
                      np.float32)

