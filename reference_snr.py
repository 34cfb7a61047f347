#!/usr/bin/env python3
"""SNR of the JAX package's own stream of chip_smoke.py's signals: the
constants chip_smoke.py holds the port's streams to (JAX_SNR_DB,
JAX_STATEFUL_SNR_DB, the JAX_SWITCHED_*, JAX_MANAGED_* and JAX_51_*
values).

Runs the JAX reference (vorbis_tpu) on the CPU, so it needs JAX and is
never run on the card:

    JAX_PLATFORMS=cpu python3 reference_snr.py            # psy_state=True
    JAX_PLATFORMS=cpu python3 reference_snr.py --stateless
    JAX_PLATFORMS=cpu python3 reference_snr.py --switching
    JAX_PLATFORMS=cpu python3 reference_snr.py --managed
    JAX_PLATFORMS=cpu python3 reference_snr.py --51 [--seconds S]

The first two encode 60 s of _signal(60, 44100, 0) with vorbis_tpu
FastEncoder(2, 44100, 0.5, switching=False); --switching encodes
_signal(60, 44100, 0) and _click_train(60, 44100, 0) with the default
FastEncoder(2, 44100, 0.5) (block switching and the psy state on);
--managed encodes streams 0 and 7 of bench.py's managed transient leg,
_click_train(30, 44100, s), with FastEncoder(2, 44100, bitrate=(-1,
128000, -1)).encode_managed (switching, the psy state and the reservoir
floater on); --51 encodes the first stream of each of chip_smoke.py's
5.1 legs, _signal51(S, 48000, 0) and _click_train51(S, 48000, 0), with
the default FastEncoder(6, 48000, 0.4).encode (S = 60 and 30 unless
--seconds cuts both).  Each stream is decoded with vorbis_tpu.vorbisfile; the
script prints its SNR against the input in dB, its bytes, the audio
packets' rate, its short-block count and the jax version.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stateless", action="store_true",
                    help="psy_state=False (chip_smoke.py's JAX_SNR_DB)")
    ap.add_argument("--switching", action="store_true",
                    help="the default encoder (switching=True) on both "
                         "signals (chip_smoke.py's JAX_SWITCHED_*)")
    ap.add_argument("--managed", action="store_true",
                    help="ABR 128 kbps on the click train, streams 0 and 7 "
                         "(chip_smoke.py's JAX_MANAGED_*)")
    ap.add_argument("--51", dest="surround", action="store_true",
                    help="the 5.1 encoder on both 5.1 signals "
                         "(chip_smoke.py's JAX_51_*)")
    ap.add_argument("--seconds", type=float, default=None,
                    help="with --51: cut both signals to this length")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import jax
    import numpy as np

    from chip_smoke import _click_train, _click_train51, _signal, _signal51
    from vorbis_tpu.bitstream.oggfile import OggStreamReader
    from vorbis_tpu.models.fastenc import FastEncoder
    from vorbis_tpu.vorbisfile import OggVorbisFile

    rate = 44100
    if args.surround:
        rate = 48000
        fe = FastEncoder(6, rate, 0.4)
        runs = [("signal51", _signal51(args.seconds or 60, rate, 0)),
                ("click_train51", _click_train51(args.seconds or 30, rate,
                                                 0))]
    elif args.managed:
        fe = FastEncoder(2, 44100, bitrate=(-1, 128000, -1))
        runs = [(f"click_train {s}", _click_train(30, 44100, s))
                for s in (0, 7)]
    elif args.switching:
        fe = FastEncoder(2, 44100, 0.5)
        runs = [("signal", _signal(60, 44100, 0)),
                ("click_train", _click_train(60, 44100, 0))]
    else:
        fe = FastEncoder(2, 44100, 0.5, switching=False,
                         psy_state=not args.stateless)
        runs = [("signal", _signal(60, 44100, 0))]
    for name, pcm16 in runs:
        ogg = fe.encode(pcm16)      # encode_managed when managed
        out = OggVorbisFile(ogg).read_all_float()
        x = pcm16.astype(np.float64) / 32768.0
        assert out.shape == x.shape, (out.shape, x.shape)
        snr = 10 * np.log10(np.sum(x ** 2) / np.sum((out - x) ** 2))
        # a short packet's mode number picks a blockflag-0 mode
        pk = [p for p, _, _ in OggStreamReader(ogg).packets()][3:]
        short_modes = {i for i, m in enumerate(fe.vi.modes)
                       if m.blockflag == 0}
        shorts = sum((p[0] >> 1) & ((1 << fe.modebits) - 1) in short_modes
                     for p in pk)
        kbps = sum(map(len, pk)) * 8 / (x.shape[1] / rate) / 1000
        print(f"{name}: {x.shape[1] / rate:g} s, "
              f"switching={fe.switching} psy_state={fe.psy_state} "
              f"managed={fe.managed} bytes={len(ogg)} packets={len(pk)} "
              f"audio_kbps={kbps:.3f} short_blocks={shorts} "
              f"SNR {snr:.5f} dB (jax {jax.__version__}, "
              f"{jax.devices()[0].platform})")


if __name__ == "__main__":
    main()
