"""Opt-in analysis dumps (reference: lib/analysis.c:65-108
_analysis_output under the ANALYSIS build flag, which writes every
intermediate vector to name_N.m matlab files).

Here: `enable(dir)` switches on dumping; instrumented call sites use
`dump(name, vec)` and each vector lands as <dir>/<name>_<seq>.npy plus
a matlab-compatible .m text file when `matlab=True` (the reference's
format: one "index value" pair per line).

Copy of vorbis_tpu/utils/analysis_dump.py, kept line-aligned with it.
"""

from __future__ import annotations

import os

import numpy as np

_state = {"dir": None, "seq": {}, "matlab": False}


def enable(directory: str, matlab: bool = False) -> None:
    os.makedirs(directory, exist_ok=True)
    _state["dir"] = directory
    _state["seq"] = {}
    _state["matlab"] = matlab


def disable() -> None:
    _state["dir"] = None


def enabled() -> bool:
    return _state["dir"] is not None


def dump(name: str, vec) -> None:
    """Record one named vector (no-op unless enabled)."""
    d = _state["dir"]
    if d is None:
        return
    seq = _state["seq"].get(name, 0)
    _state["seq"][name] = seq + 1
    arr = np.asarray(vec)
    np.save(os.path.join(d, f"{name}_{seq}.npy"), arr)
    if _state["matlab"]:
        with open(os.path.join(d, f"{name}_{seq}.m"), "w") as f:
            flat = arr.reshape(-1)
            for i, v in enumerate(flat):
                f.write(f"{i} {float(v):.10g}\n")
