#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (vorbis_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card
and the CUDA toolkit (nvcc); it needs no JAX and no network:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card, its name and power limit, the fp32 policy;
  2. build: nvcc compiles csrc/floor_fit.cu into build/vorbis_tpu_torch/;
  3. kernel vs plain: the floor-fit kernel against its plain PyTorch
     version, bitwise, on real spectra (B = 2048 rows, one chunk of the
     main path) and on random correlated inputs (B = 4096), with both
     times at B = 2048 from CUDA events;
  4. main path: FastEncoder(2, 44100, 0.5, switching=False,
     psy_state=False).encode of 60 s of 44.1 kHz stereo int16 (bench.py's
     signal, seed 0), from a CUDA tensor and from host numpy; the stream
     decodes (vorbis_tpu.vorbisfile) to the exact length above an SNR
     floor; the kernel's launch count shows the path went through it;
  5. card vs CPU: the port's packets for a 2 s clip on the card and on
     the CPU, byte for byte.
It prints the kernel record as one JSON line, then the result line.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# SNR floor for phase 4.  The JAX package's own stream of the same
# signal (vorbis_tpu FastEncoder(2, 44100, 0.5, switching=False,
# psy_state=False).encode of _signal(60, 44100, 0), decoded by
# vorbis_tpu.vorbisfile, JAX 0.9.0 on the CPU) measures 24.95600 dB; the
# port must come within SNR_MARGIN_DB of it.
JAX_SNR_DB = 24.956
SNR_MARGIN_DB = 0.25


def _signal(secs, rate, seed):
    """bench.py's stream: two tones plus seeded noise, int16 stereo."""
    import numpy as np
    t = np.arange(secs * rate) / rate
    rng = np.random.RandomState(seed)
    pcmf = (0.30 * np.sin(2 * np.pi * (440 + 7 * seed) * t)[None, :]
            + 0.10 * np.sin(2 * np.pi * 1873 * t)[None, :]
            + 0.02 * rng.randn(2, int(secs * rate)))
    return np.clip(np.rint(pcmf * 32768.0), -32768,
                   32767).astype(np.int16)


def _cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _packets(dev, chunk):
    """(list of packet bytes) from one device step on `chunk`."""
    pk, nb = dev.get_step()(chunk)
    pk = pk.cpu().numpy()
    nb = nb.cpu().numpy()
    return [pk[f, :(nb[f] + 7) // 8].tobytes() + bytes([nb[f] % 8])
            for f in range(len(nb))]


def main():
    if not os.path.isdir(os.path.join(HERE, "vorbis_tpu_torch")):
        raise SystemExit("chip_smoke.py: run it from the root of a "
                         "checkout (vorbis_tpu_torch/ not found)")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    import vorbis_tpu_torch
    if not vorbis_tpu_torch.fp32_policy_ok():
        raise RuntimeError("fp32 policy not set (TF32 on)")
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}  torch {torch.__version__} cuda "
          f"{torch.version.cuda}  count {torch.cuda.device_count()}")

    # 2. build
    from vorbis_tpu_torch.ops import floor_cuda
    t0 = time.perf_counter()
    so, log = floor_cuda.build()
    floor_cuda.load_library()
    print(f"[build] {so.relative_to(HERE)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}")

    # 3. kernel vs plain
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    fe = FastEncoder(2, 44100, 0.5, switching=False, psy_state=False,
                     device="cuda")
    floor = fe.floor
    if not isinstance(floor, floor_cuda.DeviceFloorFitCuda):
        raise RuntimeError(f"main path floor is {type(floor).__name__}")
    dev = fe.dev
    pcm16 = _signal(60, 44100, 0)
    CF = dev.chunk_packets
    hop = fe.n // 2
    chunk = torch.from_numpy(np.ascontiguousarray(
        pcm16[:, :CF * hop + hop])).cuda()
    flat = chunk.float().div(32768.0).unfold(1, fe.n, hop)[:, :CF] \
        .transpose(0, 1).reshape(CF * 2, fe.n)
    _, logmdct, mask = fe.analysis.full_mask(flat)
    rng = np.random.RandomState(7)
    lm = (rng.randn(4096, floor.n) * 20 - 60).astype(np.float32)
    mk = (lm + rng.randn(4096, floor.n) * 6 - 3).astype(np.float32)
    cases = {"real_B2048": (logmdct, mask),
             "random_B4096": (torch.from_numpy(lm).cuda(),
                              torch.from_numpy(mk).cuda())}
    max_err = 0
    prepared = {}
    for name, (a, b) in cases.items():
        quant, above, prefix, used = floor.prepare(a, b)
        got = floor.fit(quant, above, prefix)
        want = floor.fit_plain(quant, above, prefix)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        print(f"[kernel] {name}: B={quant.shape[0]} posts={got.numel()} "
              f"mismatches={bad} max_abs_err={err}")
        if bad:
            raise RuntimeError(f"kernel != plain on {name}: {bad}")
        prepared[name] = (quant, above, prefix)
    q, a, p = prepared["real_B2048"]
    ms = _cuda_ms(lambda: floor.fit(q, a, p), 50)
    plain_ms = _cuda_ms(lambda: floor.fit_plain(q, a, p), 5)
    print(f"[kernel] floor fit B=2048 n={floor.n} P={floor.posts}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms ({smi})")

    # 4. main path at real size
    secs = pcm16.shape[1] / 44100
    pcm_dev = torch.from_numpy(pcm16).cuda()
    fe.encode(pcm_dev)                              # warm-up
    torch.cuda.synchronize()
    floor.launches = 0
    t0 = time.perf_counter()
    ogg = fe.encode(pcm_dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    launches = floor.launches
    nchunks = -(-((pcm16.shape[1] + 3 * hop - fe.n) // hop + 1) // CF)
    if launches < nchunks:
        raise RuntimeError(f"floor kernel launched {launches} times for "
                           f"{nchunks} chunks")
    t0 = time.perf_counter()
    ogg_host = fe.encode(pcm16)
    t_host = time.perf_counter() - t0
    if ogg_host != ogg:
        raise RuntimeError("host-staged stream differs from the "
                           "device-resident one")
    from vorbis_tpu.vorbisfile import OggVorbisFile
    out = OggVorbisFile(ogg).read_all_float()
    x = pcm16.astype(np.float64) / 32768.0
    if out.shape != pcm16.shape:
        raise RuntimeError(f"decoded shape {out.shape} != {pcm16.shape}")
    if not np.isfinite(out).all():
        raise RuntimeError("non-finite decoded samples")
    snr = 10 * np.log10(np.sum(x ** 2) / np.sum((out - x) ** 2))
    print(f"[encode] 60 s stereo: {len(ogg)} bytes, {nchunks} chunks, "
          f"floor launches {launches}, decoded {out.shape}, "
          f"SNR {snr:.3f} dB (JAX {JAX_SNR_DB:.3f} dB)")
    if snr < JAX_SNR_DB - SNR_MARGIN_DB:
        raise RuntimeError(f"SNR {snr:.3f} dB below the floor")
    print(f"[encode] warm encode from device {t_dev:.4f} s = "
          f"{secs / t_dev:.2f}x realtime; from host {t_host:.4f} s = "
          f"{secs / t_host:.2f}x realtime ({smi})")

    # 5. card vs CPU
    fe_cpu = FastEncoder(2, 44100, 0.5, switching=False, psy_state=False,
                         device="cpu")
    F = (2 * 44100 + 3 * hop - fe.n) // hop + 1
    clip = np.zeros((2, F * hop + hop), np.int16)
    clip[:, hop:hop + 2 * 44100] = pcm16[:, :2 * 44100]
    on_card = _packets(dev, torch.from_numpy(clip).cuda())
    on_cpu = _packets(fe_cpu.dev, torch.from_numpy(clip))
    same = sum(a == b for a, b in zip(on_card, on_cpu))
    print(f"[card-vs-cpu] identical packets {same}/{len(on_card)}")
    if same < 0.9 * len(on_card):
        raise RuntimeError("card and CPU packets differ in more than 10%")

    print(json.dumps({"kernels": [{
        "name": "floor1_greedy_fit", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/floor_fit.cu",
        "replaces": "vorbis_tpu/ops/floor_pallas.py:289",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
