"""Static tables onto the device.

The codec's "weights" are its static tables: windows, the MDCT basis,
psy curves, floor neighbour tables, lattice parameters, codeword
tables.  The JAX package and this port derive them from the same
numpy arrays (the shared encsetup setup); every constructor of the
port moves them to its device through `device_tables`, so one test can
hold the port's tensors bit for bit against the JAX objects' constants.
"""

from __future__ import annotations

import numpy as np
import torch

# torch has no arithmetic on unsigned 32/64-bit tensors on every
# backend; bit fields ride int64 instead (values < 2^32 are exact)
_WIDEN = {np.dtype(np.uint16): np.int64, np.dtype(np.uint32): np.int64,
          np.dtype(np.uint64): np.int64}


def device_tables(np_tables: dict[str, np.ndarray],
                  device) -> dict[str, torch.Tensor]:
    """{name: numpy array} -> {name: tensor on `device`}, same values.
    float64 tables are refused: the device side is float32 only."""
    out = {}
    for name, arr in np_tables.items():
        a = np.asarray(arr)
        if a.dtype == np.float64:
            raise TypeError(f"{name}: float64 table (cast on the host)")
        if a.dtype in _WIDEN:
            a = a.astype(_WIDEN[a.dtype])
        out[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out
