"""Transient/envelope detector constants driving long/short block
switching (reference: lib/envelope.c).

A copy of only the constants of vorbis_tpu/ops/envelope.py that the port
runs, kept line-aligned with its source (lines 22-32): per 64-sample
step a 128-point MDCT is taken per channel, 12 sin^2-weighted bands
(BAND_BEGIN / BAND_END) go through pre/post-echo threshold triggers, and
the "stretch" hysteresis (VE_MINSTRETCH..VE_MAXSTRETCH) lengthens the
pre-trigger context after impulses.  The batched detector
(ops/torchdsp.DeviceEnvelope) and the exact stretch rescue
(models/fastenc) read them.  The scalar detector of the reference
encoder (EnvelopeLookup, _ve_amp) is not part of the fast path and is
not copied.
"""

from __future__ import annotations

# the band layout and the search-window constants of envelope.c
# (vorbis_tpu/ops/envelope.py:22-32)


VE_PRE = 16
VE_WIN = 4
VE_POST = 2
VE_AMP = VE_PRE + VE_POST - 1
VE_BANDS = 12
VE_NEARDC = 15
VE_MINSTRETCH = 2
VE_MAXSTRETCH = 12

BAND_BEGIN = [2, 4, 6, 9, 13, 17, 22, 12, 8, 3, 2, 1]
BAND_END = [4, 5, 6, 8, 8, 8, 8, 4, 4, 3, 2, 4]
