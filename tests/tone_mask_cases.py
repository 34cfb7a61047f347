"""Seeded inputs of the tone mask (vorbis_tpu_torch/ops/tone_mask_cuda.py),
shared by tests/test_torch_tone_mask.py (the port against the JAX package
on the CPU), tests/test_torch_cuda.py and chip_smoke.py phase 3k (the
kernel against its plain version on the card).  It imports no JAX.

LOOKS are the encoders' psy looks, (channels, rate, quality, W) with W 1
long and 0 short, and SHAPES their (n, T, G): bins, octave lines and
octave groups.  `port_look(case, device)` builds the port's
DeviceToneMask of a look as DeviceAnalysis does, `psy_look(psy, setup,
W, rate)` the PsyLook of either package.  `inputs(n, seed, rows)` gives
`rows` seeded rows (noise-like spectra, and sparse tonal peaks over a
low floor) with global and local maxima as the encoders make them, then
the EDGE rows: a silent row (every group inaudible), global_specmax = 0,
a loud row whose curve level saturates at p_levels - 1, one whose level
clamps at 0, and local != global.  `stress_rows(tm)` gives two rows that
stress the kernel's partitions at a look: the most deposits a row can make
and a single depositing group.
"""

import numpy as np

f32 = np.float32
LOOKS = [(2, 44100, 0.5, 1), (2, 44100, 0.5, 0), (6, 48000, 0.4, 1),
         (6, 48000, 0.4, 0), (2, 16000, 0.5, 1), (2, 16000, 0.5, 0),
         (2, 32000, 0.5, 1), (2, 32000, 0.5, 0)]
SHAPES = {(2, 44100, 0.5, 1): (1024, 777, 316),
          (2, 44100, 0.5, 0): (128, 585, 123),
          (6, 48000, 0.4, 1): (1024, 776, 315),
          (6, 48000, 0.4, 0): (128, 585, 123),
          (2, 16000, 0.5, 1): (512, 712, 251),
          (2, 16000, 0.5, 0): (256, 648, 187),
          (2, 32000, 0.5, 1): (1024, 776, 315),
          (2, 32000, 0.5, 0): (128, 584, 122)}
ROWS = 32
EDGE = ("silent", "global 0", "level max", "level 0", "local != global")
# the log spectrum of digital silence: todB(0) * 0.5 + 0.345 + 0.345
SILENT = f32(f32(f32(-764.6161886) * f32(0.5)) + f32(0.345)) + f32(0.345)


def psy_look(psy, setup, W, rate):
    """The PsyLook that DeviceAnalysis(setup, blocktype, rate, W) builds:
    blocktype 3 for long blocks, 0 for short ones (the package's `psy`
    module, either package's setup)."""
    bt = min(3 if W else 0, len(setup.psy_params) - 1)
    n2 = setup.vi.blocksizes[W] // 2
    return psy.PsyLook(setup.psy_params[bt], setup.psy_global, n2, rate)


def port_look(case, device):
    """The port's DeviceToneMask of a LOOKS case on `device`."""
    from vorbis_tpu_torch.models import encsetup
    from vorbis_tpu_torch.ops import psy
    from vorbis_tpu_torch.ops.torchdsp import DeviceToneMask
    ch, rate, q, W = case
    setup = encsetup.setup_vbr_staged(ch, rate, q).init()
    return DeviceToneMask(psy_look(psy, setup, W, rate), device)


def inputs(n, seed, rows=ROWS):
    """(logfft (R, n), global (R,), local (R,)) float32: `rows` seeded
    rows, then the len(EDGE) edge rows."""
    rng = np.random.RandomState(seed)
    half = rows // 2
    noise = rng.randn(half, n) * 12 - 40
    tonal = -90 + rng.randn(rows - half, n) * 3
    for r in range(rows - half):
        peaks = rng.choice(n, rng.randint(1, 8), replace=False)
        tonal[r, peaks] = rng.uniform(-30, 0, len(peaks))
    lf = np.concatenate([noise, tonal]).astype(f32)
    local = np.minimum(lf.max(-1), 0).astype(f32)
    # the stateful paths' global max: the decayed max of earlier frames
    glob = np.maximum(local, local + rng.uniform(0, 30, rows)).astype(f32)
    glob[::3] = local[::3]
    edge = [(np.full(n, SILENT), f32(-9999.0), None),
            (rng.randn(n) * 12 - 40, f32(0.0), None),
            (rng.randn(n) * 3 + 20, f32(-100.0), None),
            (rng.randn(n) * 3 - 120, f32(0.0), None),
            (rng.randn(n) * 12 - 30, f32(-5.0), f32(-25.0))]
    e_lf = np.stack([e[0] for e in edge]).astype(f32)
    e_loc = np.array([np.minimum(e_lf[k].max(), 0) if e[2] is None
                      else e[2] for k, e in enumerate(edge)], f32)
    e_glob = np.array([e[1] for e in edge], f32)
    return (np.concatenate([lf, e_lf]), np.concatenate([glob, e_glob]),
            np.concatenate([local, e_loc]))


def stress_rows(tm):
    """(logfft (2, n), global (2,), local (2,)) float32 at the look of tm
    (a DeviceToneMask), read from its blob: row 0 puts each group's bins
    at the middle of the curve level that gives the group its most
    in-range deposits, the global max raised until every group clears its
    floor by 10 dB, so every group deposits its widest span; row 1 is
    silence but for the group with the most such deposits, alone."""
    from vorbis_tpu_torch.ops.tone_mask_cuda import blob_tables
    tb = blob_tables(tm.blob)
    count = (tb["group_k1"] - tb["group_k0"]).clip(0)      # (G, levels)
    level = count.argmax(1)
    att = max(tb["ath_adjatt"], tb["ath_maxatt"])          # local = 0
    mid = 10.0 * level + 35.0 - float(tb["max_curve_dB"])
    gath = tb["group_static"][:, 0].view(f32)
    glob = np.ceil(max(0.0, (gath + att - mid - 6.0).max())) + 10
    gm = (mid + glob).astype(f32)
    one = np.full(tb["n"], SILENT, f32)
    g = int(count.max(1).argmax())
    one[tb["bin_group"] == g] = gm[g]
    return (np.stack([gm[tb["bin_group"]], one]),
            np.full(2, glob, f32), np.zeros(2, f32))
