#!/usr/bin/env python3
"""Time the construction of the port's encoders on the CPU: the median of
`Encoder(setup_vbr(2, 44100, 0.5))` (the golden encoder's looks and
state, which FastEncoder builds for its looks and header packets) and of
`FastEncoder(2, 44100, 0.5, device="cpu")`, warm (tables cached by a
first construction).  One torch thread.

    python3 tools/torch_encoder_init_time.py [--root CHECKOUT] [--reps N]

--root imports vorbis_tpu_torch from another checkout (e.g. a `git
archive` of the parent commit), so two versions can be timed in turns
on the same host.
"""

import argparse
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    torch.set_num_threads(1)
    from vorbis_tpu_torch.codec.encoder import Encoder
    from vorbis_tpu_torch.models.encsetup import setup_vbr
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    FastEncoder(2, 44100, 0.5, device="cpu")          # warm the caches
    setup = setup_vbr(2, 44100, 0.5)

    def median(fn):
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]

    enc = median(lambda: Encoder(setup))
    fe = median(lambda: FastEncoder(2, 44100, 0.5, device="cpu"))
    print(f"{args.root}: Encoder(setup) {enc:.4f} s, FastEncoder(2, 44100, "
          f"0.5, device=\"cpu\") {fe:.4f} s (median of {args.reps})")


if __name__ == "__main__":
    main()
