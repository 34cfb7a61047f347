#!/usr/bin/env python3
"""SNR of the JAX package's own stream of chip_smoke.py's signal: the
constants chip_smoke.py holds the port's streams to (JAX_SNR_DB and
JAX_STATEFUL_SNR_DB).

Runs the JAX reference (vorbis_tpu) on the CPU, so it needs JAX and is
never run on the card:

    JAX_PLATFORMS=cpu python3 reference_snr.py            # psy_state=True
    JAX_PLATFORMS=cpu python3 reference_snr.py --stateless

It encodes 60 s of _signal(60, 44100, 0) with
vorbis_tpu FastEncoder(2, 44100, 0.5, switching=False), decodes the
stream with vorbis_tpu.vorbisfile and prints the SNR against the input
in dB, with the jax version.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stateless", action="store_true",
                    help="psy_state=False (chip_smoke.py's JAX_SNR_DB)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import jax
    import numpy as np

    from chip_smoke import _signal
    from vorbis_tpu.models.fastenc import FastEncoder
    from vorbis_tpu.vorbisfile import OggVorbisFile

    pcm16 = _signal(60, 44100, 0)
    fe = FastEncoder(2, 44100, 0.5, switching=False,
                     psy_state=not args.stateless)
    ogg = fe.encode(pcm16)
    out = OggVorbisFile(ogg).read_all_float()
    x = pcm16.astype(np.float64) / 32768.0
    assert out.shape == x.shape, (out.shape, x.shape)
    snr = 10 * np.log10(np.sum(x ** 2) / np.sum((out - x) ** 2))
    print(f"psy_state={not args.stateless} bytes={len(ogg)} "
          f"SNR {snr:.5f} dB (jax {jax.__version__}, "
          f"{jax.devices()[0].platform})")


if __name__ == "__main__":
    main()
