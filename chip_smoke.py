#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (vorbis_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
the CUDA toolkit (nvcc) and a host C compiler (cc); it needs no JAX, no
vorbis_tpu and no network:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card, its name and power limit, the fp32 policy;
  2. build: nvcc compiles csrc/floor_fit.cu and cc compiles
     csrc/host_ogg.c (the Ogg page CRC) into build/vorbis_tpu_torch/, all
     builds started together;
  3. kernel vs plain: the floor-fit kernel against its plain PyTorch
     version, bitwise, on real spectra of the main path (B = 2048, the
     1074 rows of the last chunk, B = 1 and 3), on random correlated
     inputs (B = 4096), on the short-block look (n = 128) and the long
     look of q = -0.1 (n = 2048), and on synthetic looks of 48 and 65
     posts (n = 1024) and of 65 posts at n = 2048; then its time at
     B = 2048 from CUDA events (warm L2, as on the main path, where the
     inputs were just written), its bound and share, and the plain
     version's time;
  4. main path: FastEncoder(2, 44100, 0.5, switching=False,
     psy_state=False).encode of 60 s of 44.1 kHz stereo int16 (bench.py's
     signal, seed 0), from a CUDA tensor and from host numpy; the stream
     decodes with the port's own decoder (vorbis_tpu_torch.codec.decoder)
     to the exact length above an SNR floor; the kernel's launch count
     shows the path went through it;
  4b. stateful encode: FastEncoder(2, 44100, 0.5, switching=False) with
     the cross-frame psy state (the default) encodes the same 60 s from
     a CUDA tensor and from host int16, byte-equal; the port's decoder
     reads it to the exact length within SNR_MARGIN_DB of the JAX
     package's stateful stream; the floor kernel (long and short looks)
     launches at least once a finish batch; the phase times
     (last_profile) and x-realtime are printed;
  4c. multi-stream: encode_batch of 16 streams (_signal(60, 44100, s),
     s = 0..15, CUDA tensors) at the default B_long=2048: total
     x-realtime and launches; every stream's last page granulepos is its
     length; streams 0 and 15 decode to the exact length;
  5. card vs CPU: the port's packets for a 2 s clip on the card and on
     the CPU, byte for byte;
  5b. card vs CPU, stateful: the stateful packets of a 2 s clip
     (encode_batch at B_long=64), >= 90% identical; the count at encode's
     B_long=1024 and the stateless encode_batch's are printed beside it.
Phases 4b and 4c then run once more under torch.profiler and print the
device's busy share.  Launch counts are set to 0 just before each main
path (4, 4b, 4c) and read just after it.
It prints the kernel record as one JSON line, then the result line.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# SNR floor for phase 4.  The JAX package's own stream of the same
# signal (vorbis_tpu FastEncoder(2, 44100, 0.5, switching=False,
# psy_state=False).encode of _signal(60, 44100, 0), decoded by
# vorbis_tpu.vorbisfile, JAX 0.9.0 on the CPU) measures 24.95600 dB; the
# port must come within SNR_MARGIN_DB of it.
JAX_SNR_DB = 24.956
SNR_MARGIN_DB = 0.25
# The same for phase 4b: the JAX package's stateful stream
# (vorbis_tpu FastEncoder(2, 44100, 0.5, switching=False).encode of
# _signal(60, 44100, 0), psy_state at its default, decoded by
# vorbis_tpu.vorbisfile; JAX 0.9.0 on the CPU; reference_snr.py)
# measures 25.04790 dB.
JAX_STATEFUL_SNR_DB = 25.0479

# The card's peaks for the kernel's bound (NVIDIA H100 SXM data sheet,
# 132 SMs at 1.98 GHz): HBM bytes per second; float32 operations, 67e12
# counting an FMA as two, and the kernel is built without FMAs; int32
# operations, 64 integer lanes a SM against 128 float32 lanes.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = 67e12 / 4
# Operations of csrc/floor_fit.cu, counted from its source, once each
# (not once a lane where the warp repeats a scalar step):
#  - a bin of inspect: the range check, the two shared loads, the
#    difference, the square-and-add, the over test (3 compares, 3
#    logic ops, the offset add and the unsigned compare, or'ed in), the
#    DDA step (2 adds, a compare, 2 conditional adds) and x += 32: 20;
#  - every greedy step, new or memo: the next step's two table loads and
#    bound test, 3 shuffles with their lane arithmetic, the link
#    unpacking, two table loads and their x fields, two post_y (11
#    each) and the memo test: 41;
#  - a new step besides: the memo store 6, the two fits' operand
#    selects, moment loads and packing 53, the DDA set-up 30, the
#    verdict 8, unpacking and the degenerate cases 16, the three state
#    updates 12, the propagation's ballots and link updates 20: 145
#    integer operations, and each of its two fit_lines (and the one
#    initial fit of a frame) 26 float32 operations: 5 differences, the
#    denominator's 3, two numerators of 3, two divisions and two
#    evaluations of multiply, add, round, max and min.
# Left out: the row load's address arithmetic and the final walk (P
# render_points a frame, under 1% of these).
OPS_PER_BIN = 20
OPS_PER_STEP = 41
OPS_PER_NEW_STEP = 145
F32_OPS_PER_FIT = 26


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


def _floors(fe):
    """The floor-fit kernels of an encoder's main path: the long look's
    and, once built, the short look's (a long-only stream opens with one
    short block)."""
    out = [fe.floor]
    if fe._short_ctx is not None:
        out.append(fe._short_ctx.floor)
    return out


def _launches(fe):
    return sum(f.launches for f in _floors(fe))


def _reset_launches(fe):
    for f in _floors(fe):
        f.launches = 0


def _snr(pcm16, out):
    import numpy as np
    x = pcm16.astype(np.float64) / 32768.0
    if out.shape != pcm16.shape:
        raise RuntimeError(f"decoded shape {out.shape} != {pcm16.shape}")
    if not np.isfinite(out).all():
        raise RuntimeError("non-finite decoded samples")
    return 10 * np.log10(np.sum(x ** 2) / np.sum((out - x) ** 2))


def _audio_packets(ogg):
    from vorbis_tpu_torch.bitstream.oggfile import OggStreamReader
    return [p for p, _, _ in OggStreamReader(ogg).packets()][3:]


def _last_granulepos(ogg):
    import struct
    at = ogg.rfind(b"OggS")
    return struct.unpack_from("<q", ogg, at + 6)[0]


def _busy_share(fn, wall_s):
    """Device time of one profiled call of fn (the kernels' time, summed
    over the profiler's device-side events only: its CPU-op rows repeat
    the time of the kernels they launch) over the unprofiled wall time
    wall_s; and the largest kernels by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    rows = [f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
            f"x{e.count}" for e in top]
    return dev_us / 1e6 / wall_s, dev_us / 1e3, rows


def _random_spectra(n, B, seed):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    lm = (rng.randn(B, n) * 20 - 60).astype(np.float32)
    mk = (lm + rng.randn(B, n) * 6 - 3).astype(np.float32)
    return torch.from_numpy(lm).cuda(), torch.from_numpy(mk).cuda()


def _synthetic_look(base, posts, seed):
    """A floor1 look with `posts` posts at seeded distinct x in (0, n),
    with the fit constants of `base`."""
    import numpy as np
    from vorbis_tpu_torch.codec.floor1_codec import Floor1Look
    from vorbis_tpu_torch.codec.headers import Floor1Info
    n = base.n
    b = base.info
    xs = np.random.RandomState(seed).choice(np.arange(1, n), posts - 2,
                                            replace=False)
    info = Floor1Info(1, [0], [1], [0], [0], [[-1]], b.mult,
                      b.rangebits, [0, n] + [int(x) for x in xs],
                      maxover=b.maxover, maxunder=b.maxunder,
                      maxerr=b.maxerr, twofitweight=b.twofitweight,
                      twofitatten=b.twofitatten)
    return Floor1Look(info)


def _check(fit, name, quant, above, prefix):
    """Kernel vs the plain version, bitwise."""
    import torch
    got = fit.fit(quant, above, prefix)
    want = fit.fit_plain(quant, above, prefix)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    err = int((got - want).abs().max()) if got.numel() else 0
    B, n = quant.shape
    print(f"[kernel] {name}: B={B} n={n} P={fit.posts} posts={got.numel()} "
          f"mismatches={bad} max_abs_err={err}")
    if bad:
        raise RuntimeError(f"kernel != plain on {name}: {bad}")
    return err


def _bound(fit, quant, above, prefix):
    """(bound_ms, bound_by, detail) of the fit on these inputs: the bytes
    read and written over the HBM rate, against the operations that this
    data needs over the rate of their type.  The work is counted by
    replaying the plain version: a step whose neighbour pair was
    inspected before (memo) changes nothing and needs only its lookup,
    and a new step's scan needs its bins up to the first one over the
    limits, or all of them."""
    import torch
    from vorbis_tpu_torch.ops.floor_device import _render_point
    B, n = quant.shape
    rows = torch.arange(B, device=quant.device)
    memo = torch.full((B, n + 1), -1, dtype=torch.int32,
                      device=quant.device)
    work = {"new_steps": 0, "bins": 0}
    x = fit.xg[None, :]
    inspect = fit._inspect

    def counting(q, a, lx, hx, ly, hy):
        # posts have distinct x, so (lx, hx) names the neighbour pair
        new = memo[rows, lx.long()] != hx
        memo[rows, lx.long()] = hx
        y = _render_point(lx[:, None], hx[:, None], ly[:, None],
                          hy[:, None], x)
        d = q - y
        over = ((x >= lx[:, None]) & (x < hx[:, None]) & a
                & ((x == lx[:, None]) | (q != 0))
                & ((d > int(fit.maxover)) | (d < -int(fit.maxunder))))
        end = torch.minimum(torch.where(over, x, n).amin(-1) + 1, hx)
        work["new_steps"] += int(new.sum())
        work["bins"] += int(torch.where(new, (end - lx).clamp_min(0),
                                        0).sum())
        return inspect(q, a, lx, hx, ly, hy)

    fit._inspect = counting
    try:
        fit.fit_plain(quant, above, prefix)
    finally:
        del fit._inspect
    nbytes = (quant.numel() * 4 + above.numel() + prefix.numel() * 4
              + B * fit.posts * 4)
    int_ops = (work["bins"] * OPS_PER_BIN
               + B * (fit.posts - 2) * OPS_PER_STEP
               + work["new_steps"] * OPS_PER_NEW_STEP)
    f32_ops = (2 * work["new_steps"] + B) * F32_OPS_PER_FIT
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S,
                f32_ops / F32_OPS_PER_S) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, dict(
        bytes=nbytes, bytes_us=t_bytes * 1e3, int_ops=int_ops,
        f32_ops=f32_ops, ops_us=t_ops * 1e3, **work)


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

    # 2. build: one compiler process per source, all started together
    from vorbis_tpu_torch import native
    from vorbis_tpu_torch.ops import floor_cuda
    t0 = time.perf_counter()
    jobs = {"floor_fit.cu": floor_cuda.build,
            "host_ogg.c": native.build_host}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(f) for k, f in jobs.items()}
        built = {k: f.result() for k, f in futs.items()}
    floor_cuda.load_library()
    native.host_library()
    print(f"[build] {len(built)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for k, (so, log) in built.items():
        print(f"[build] {k} -> {so.relative_to(HERE)}")
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build]   {line.strip()}")

    # 3. kernel vs plain
    from vorbis_tpu_torch.codec.encoder import Encoder
    from vorbis_tpu_torch.models import encsetup
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    fe = FastEncoder(2, 44100, 0.5, switching=False, psy_state=False)
    if fe.device.type != "cuda":
        raise RuntimeError(f"FastEncoder defaults to {fe.device}")
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
    q05 = Encoder(encsetup.setup_vbr(2, 44100, 0.5)).floor_looks
    qm01 = Encoder(encsetup.setup_vbr(2, 44100, -0.1)).floor_looks
    short = next(lk for lk in q05 if lk.n == 128)
    long2048 = next(lk for lk in qm01 if lk.n == 2048)
    fits = {"main": floor,
            "short": floor_cuda.DeviceFloorFitCuda(short, "cuda"),
            "q-0.1": floor_cuda.DeviceFloorFitCuda(long2048, "cuda"),
            "P48": floor_cuda.DeviceFloorFitCuda(
                _synthetic_look(floor.look, 48, 1), "cuda"),
            "P65": floor_cuda.DeviceFloorFitCuda(
                _synthetic_look(floor.look, 65, 2), "cuda"),
            "P65_n2048": floor_cuda.DeviceFloorFitCuda(
                _synthetic_look(long2048, 65, 3), "cuda")}
    cases = [("real_B2048", "main", (logmdct, mask)),
             ("real_B1074", "main", (logmdct[:1074], mask[:1074])),
             ("real_B1", "main", (logmdct[:1], mask[:1])),
             ("real_B3", "main", (logmdct[:3], mask[:3])),
             ("random_B4096", "main", _random_spectra(floor.n, 4096, 7)),
             ("short_n128", "short", _random_spectra(short.n, 2048, 8)),
             ("q-0.1_n2048", "q-0.1", _random_spectra(2048, 2048, 9)),
             ("synthetic_P48", "P48", _random_spectra(floor.n, 2048, 10)),
             ("synthetic_P65", "P65", _random_spectra(floor.n, 2048, 11)),
             # more than 48 KB of shared memory a block: the opt-in path
             ("synthetic_P65_n2048", "P65_n2048",
              _random_spectra(2048, 2048, 12))]
    max_err = 0
    prepared = {}
    for name, which, (a, b) in cases:
        fit = fits[which]
        quant, above, prefix, _ = fit.prepare(a.contiguous(),
                                              b.contiguous())
        max_err = max(max_err, _check(fit, name, quant, above, prefix))
        prepared[name] = (quant, above, prefix)
    q, a, p = prepared["real_B2048"]
    ms = _cuda_ms(lambda: floor.fit(q, a, p), 200)
    plain_ms = _cuda_ms(lambda: floor.fit_plain(q, a, p), 5)
    bound_ms, bound_by, w = _bound(floor, q, a, p)
    share = bound_ms / ms
    print(f"[kernel] floor fit B=2048 n={floor.n} P={floor.posts}: kernel "
          f"{ms:.5f} ms, plain {plain_ms:.4f} ms ({smi})")
    print(f"[kernel] bytes {w['bytes']} = {w['bytes_us']:.3f} us; "
          f"operations {w['int_ops']} int32 + {w['f32_ops']} float32 "
          f"({w['new_steps']} new steps of {q.shape[0] * (floor.posts - 2)}"
          f", {w['bins']} bins) = {w['ops_us']:.3f} us; bound "
          f"{bound_ms * 1e3:.3f} us by {bound_by}, share "
          f"{100 * share:.1f}%")
    # time against B: at small B each warp runs alone and the time is one
    # frame's dependent chain; at large B the warps share the SMs' issue
    sweep = []
    for nb in (128, 512, 1024, 2048, 4096):
        rep = -(-nb // q.shape[0])
        qs, as_, ps = (t.repeat((rep,) + (1,) * (t.dim() - 1))[:nb]
                       .contiguous() for t in (q, a, p))
        ms_b = _cuda_ms(lambda: floor.fit(qs, as_, ps), 100)
        sweep.append(f"B={nb} {ms_b:.5f}")
    print("[kernel] time against B (ms): " + ", ".join(sweep))

    # 4. main path at real size
    from vorbis_tpu_torch.codec.decoder import decode_ogg
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
    t0 = time.perf_counter()
    out, _ = decode_ogg(ogg)
    t_dec = time.perf_counter() - t0
    x = pcm16.astype(np.float64) / 32768.0
    if out.shape != pcm16.shape:
        raise RuntimeError(f"decoded shape {out.shape} != {pcm16.shape}")
    if not np.isfinite(out).all():
        raise RuntimeError("non-finite decoded samples")
    snr = 10 * np.log10(np.sum(x ** 2) / np.sum((out - x) ** 2))
    print(f"[encode] 60 s stereo: {len(ogg)} bytes, {nchunks} chunks, "
          f"floor launches {launches}, decoded {out.shape} in "
          f"{t_dec:.2f} s (host decoder), SNR {snr:.3f} dB "
          f"(JAX {JAX_SNR_DB:.3f} dB)")
    if snr < JAX_SNR_DB - SNR_MARGIN_DB:
        raise RuntimeError(f"SNR {snr:.3f} dB below the floor")
    print(f"[encode] warm encode from device {t_dev:.4f} s = "
          f"{secs / t_dev:.2f}x realtime; from host {t_host:.4f} s = "
          f"{secs / t_host:.2f}x realtime ({smi})")

    # 4b. the stateful encode (psy_state at its default)
    fs = FastEncoder(2, 44100, 0.5, switching=False)
    if not fs.psy_state:
        raise RuntimeError("psy_state is not the default")
    fs.encode(pcm_dev)                              # warm-up
    torch.cuda.synchronize()
    _reset_launches(fs)
    t0 = time.perf_counter()
    ogg_s = fs.encode(pcm_dev)
    torch.cuda.synchronize()
    t_sdev = time.perf_counter() - t0
    launches_s = _launches(fs)
    prof_s = dict(fs.last_profile)
    t0 = time.perf_counter()
    if fs.encode(pcm16) != ogg_s:
        raise RuntimeError("stateful: host int16 stream differs from the "
                           "device-resident one")
    t_shost = time.perf_counter() - t0
    npk = len(_audio_packets(ogg_s))
    batches = -(-(npk - 1) // 1024) + 1     # long batches + the short one
    if launches_s < batches:
        raise RuntimeError(f"stateful: floor kernel launched {launches_s} "
                           f"times for {batches} finish batches")
    out_s, _ = decode_ogg(ogg_s)
    snr_s = _snr(pcm16, out_s)
    print(f"[stateful] 60 s stereo: {len(ogg_s)} bytes, {npk} packets, "
          f"{batches} finish batches, floor launches {launches_s}, SNR "
          f"{snr_s:.3f} dB (JAX stateful {JAX_STATEFUL_SNR_DB:.3f} dB)")
    if abs(snr_s - JAX_STATEFUL_SNR_DB) > SNR_MARGIN_DB:
        raise RuntimeError(f"stateful SNR {snr_s:.3f} dB not within "
                           f"{SNR_MARGIN_DB} dB of the JAX stream")
    print("[stateful] last_profile (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in prof_s.items()))
    print(f"[stateful] warm encode from device {t_sdev:.4f} s = "
          f"{secs / t_sdev:.2f}x realtime; from host {t_shost:.4f} s = "
          f"{secs / t_shost:.2f}x realtime ({smi})")
    busy, dev_ms, rows = _busy_share(lambda: fs.encode(pcm_dev), t_sdev)
    print(f"[stateful] profiled: device {dev_ms:.3f} ms, busy "
          f"{100 * busy:.1f}% of the unprofiled {t_sdev:.4f} s; top: "
          + "; ".join(rows))

    # 4c. multi-stream encode_batch, 16 x 60 s
    S = 16
    streams = [torch.from_numpy(_signal(60, 44100, k)).cuda()
               for k in range(S)]
    fs.encode_batch(streams[:2])                    # warm-up at B=2048
    torch.cuda.synchronize()
    _reset_launches(fs)
    t0 = time.perf_counter()
    oggs = fs.encode_batch(streams)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    launches_b = _launches(fs)
    prof_b = dict(fs.last_profile)
    if launches_b == 0:
        raise RuntimeError("multi-stream: the floor kernel never launched")
    for k, o in enumerate(oggs):
        if _last_granulepos(o) != streams[k].shape[1]:
            raise RuntimeError(f"stream {k}: last granulepos "
                               f"{_last_granulepos(o)}")
    for k in (0, S - 1):
        out_k, _ = decode_ogg(oggs[k])
        snr_k = _snr(streams[k].cpu().numpy(), out_k)
        print(f"[batch] stream {k}: {len(oggs[k])} bytes, decoded "
              f"{out_k.shape}, SNR {snr_k:.3f} dB")
    print(f"[batch] {S} x 60 s: {t_batch:.4f} s = "
          f"{S * secs / t_batch:.2f}x realtime, floor launches "
          f"{launches_b}; last_profile (s): " + ", ".join(
              f"{k} {v:.4f}" for k, v in prof_b.items()) + f" ({smi})")
    busy, dev_ms, rows = _busy_share(lambda: fs.encode_batch(streams),
                                     t_batch)
    print(f"[batch] profiled: device {dev_ms:.3f} ms, busy "
          f"{100 * busy:.1f}% of the unprofiled {t_batch:.4f} s; top: "
          + "; ".join(rows))
    del streams

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

    # 5b. card vs CPU, stateful: encode_batch of the clip at B_long=64
    # (the CPU side's batch need not be padded to 1024 rows); encode's
    # own B_long=1024 is printed beside it with the stateless
    # encode_batch of the same clip (the GEMMs round by batch shape)
    fs_cpu = FastEncoder(2, 44100, 0.5, switching=False, device="cpu")
    clip16 = np.ascontiguousarray(pcm16[:, :2 * 44100])
    clip_dev = torch.from_numpy(clip16).cuda()

    def card_vs_cpu(B, psy_state=True):
        fs.psy_state = fs_cpu.psy_state = psy_state
        try:
            a = _audio_packets(fs.encode_batch([clip_dev], B_long=B)[0])
            b = _audio_packets(fs_cpu.encode_batch([clip16], B_long=B)[0])
        finally:
            fs.psy_state = fs_cpu.psy_state = True
        if len(a) != len(b):
            raise RuntimeError(f"card {len(a)} packets, CPU {len(b)}")
        return [i for i, (x, y) in enumerate(zip(a, b)) if x != y], len(a)

    diff, tot = card_vs_cpu(64)
    diff_e, _ = card_vs_cpu(1024)
    diff_0, _ = card_vs_cpu(1024, psy_state=False)
    same = tot - len(diff)
    print(f"[card-vs-cpu] stateful: identical packets {same}/{tot} "
          f"(B_long=64, differing {diff}); at B_long=1024 "
          f"{tot - len(diff_e)}/{tot} (differing {diff_e}), stateless "
          f"encode_batch {tot - len(diff_0)}/{tot} (differing {diff_0})")
    if same < 0.9 * tot:
        raise RuntimeError("stateful card and CPU packets differ in more "
                           "than 10%")

    print(json.dumps({"kernels": [{
        "name": "floor1_greedy_fit", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/floor_fit.cu",
        "replaces": "vorbis_tpu/ops/floor_pallas.py:289",
        "launches": launches + launches_s + launches_b,
        "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "share": share, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
