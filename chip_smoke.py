#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (vorbis_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
the CUDA toolkit (nvcc) and a host C compiler (cc); it needs no JAX, no
vorbis_tpu and no network:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card, its name and power limit, the fp32 policy;
  2. build: nvcc compiles csrc/floor_fit.cu, csrc/m3_scan.cu,
     csrc/imdct.cu and csrc/lap.cu and cc compiles csrc/host_ogg.c (Ogg CRC and pager,
     rescue walk, schedule) and csrc/host_decode.c (the decode's page
     walk, packet parse, host IMDCT and lap, with -ffp-contract=off) into
     build/vorbis_tpu_torch/, all builds started together;
  3. kernel vs plain: the floor-fit kernel against its plain PyTorch
     version, bitwise, on real spectra of the main path (B = 2048, the
     1074 rows of the last chunk, B = 1 and 3), on random correlated
     inputs (B = 4096), on the short-block look (n = 128) and the long
     look of q = -0.1 (n = 2048), and on synthetic looks of 48 and 65
     posts (n = 1024) and of 65 posts at n = 2048; then its time at
     B = 2048 from CUDA events (warm L2, as on the main path, where the
     inputs were just written), its bound and share, and the plain
     version's time;
  3b. M3 kernel vs plain: the tempmdct scan kernel against its plain
     PyTorch version, by bit pattern, on the real short batches of 20 s
     of the click train (F = 256, through the port's own probe), and on
     the cases of tests/test_torch_m3.py (m3_case): seeded inputs at
     F = 1, 3 and 256, and at n = 256 (freq_bfn256), and the segment
     schedule's edge cases at F = 256, n = 128 and 256 (one chain, a
     reset on every impulse frame, no sw, reset flags without sw, a
     batch opening inside a run, triggers on -0.0), each with its
     segment count and longest segment; the device kernels of one
     main-path call (one) and its host time; then its times from CUDA
     graphs on the real batch and on the recorded batch with the longest
     segment, on the one-chain worst case and on 256 frames without sw
     (the staging pipeline alone), at n = 128 and 256 (in turns with the
     first design, commit 185cdeb's, with --m3-baseline), its roofline
     and segment-chain bounds, and the plain version's time;
  3f. managed kernels: FastEncoder(2, 44100, bitrate=(-1, 128000, -1))
     encodes 20 s of the click train at B = 256 with the finish step's
     arguments recorded; its first long and first short batch run again:
     the stacked floor fit of the three offset_select masks (one launch
     of 3*B*ch rows) bitwise against the plain fit and three separate
     launches, the short batch's three M3 calls by bit pattern against
     their plain version, and the 15-blob finish on the card against the
     same step on the CPU in >= 90% of the (F, 15) rows;
  3g. 5.1 kernels: the floor kernel bitwise against its plain version
     on the three floor looks of FastEncoder(6, 48000, 0.4) (P = 29,
     n = 1024; P = 13, n = 128; the LFE's P = 2, n = 12) at B = 1280 and
     256 rows of random spectra and at the rows of a main-path finish
     batch, with its times, bounds and plain times there; the MDCT's
     time at a long batch's rows (float64-accumulated, beside an fp32
     GEMM); the M3 kernel by bit pattern on the six-channel short
     batches of 5 s of the 5.1 click train, and its time on the first
     full batch;
  3h. decode vs scalar: decode_ogg_fast with the IMDCT kernel on the
     card, and the host-C drain, bitwise against the port's scalar
     decoder (vorbis_tpu_torch.codec.decoder) on 2 s click-train clips of
     the switched, managed and 5.1 encoders; phases 4-4g then decode
     their streams with decode_ogg_fast on the card;
  4. main path: FastEncoder(2, 44100, 0.5, switching=False,
     psy_state=False).encode of 60 s of 44.1 kHz stereo int16 (bench.py's
     signal, seed 0), from a CUDA tensor and from host numpy; the stream
     decodes (decode_ogg_fast on the card) to the exact length above an
     SNR floor; the kernel's launch count
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
  4d. the default main path: FastEncoder(2, 44100, 0.5) (block switching
     and the psy state on) encode_batch of 16 x 60 s of bench.py's signal
     and of its click train (_click_train), from CUDA tensors:
     x-realtime, last_profile, the warm time of _prepare_switched alone
     (envelope, rescue, schedule), long and short frames, the floor and
     M3 kernels' launches (M3's must equal the short finish batches),
     every last granulepos, streams 0 and 15
     decoded with SNR (stream 0 within SNR_MARGIN_DB of the JAX stream)
     and stream 0's short blocks beside JAX's; once more under
     torch.profiler for the busy share (the click train on 2 streams:
     the profiler's cost grows with its ~1M kernels);
  4e. encode (B_long = 1024) of one 60 s click-train stream: x-realtime
     and the SNR check;
  4f. bench.py's managed transient leg: the ABR 128 kbps encoder of 3f,
     encode_managed_batch of 8 x 30 s click trains (_click_train(30,
     44100, s), s = 0..7) from CUDA tensors, warm, then timed:
     x-realtime, last_profile, long and short frames and finish batches,
     the floor launches (one a finish batch) and M3's (three a short
     batch), oversized redos, truncates and pads, each stream's audio
     kbps (100-165), every last granulepos, streams 0 and 7 decoded with
     SNR within SNR_MARGIN_DB of the JAX package's managed streams;
     the busy share of 2 streams under torch.profiler; one 30 s CBR
     stream (bitrate=(128000,)*3): its truncates and pads, decoded to
     the exact length; the long-only managed paths (switching=False,
     stateful and stateless) on 10 s of stream 0, decoded to the exact
     length;
  4g. 5.1: FastEncoder(6, 48000, 0.4) (switching and the psy state on)
     encode_batch of 4 x 60 s of _signal51 and 4 x 30 s of
     _click_train51 from CUDA tensors, warm, then timed: x-realtime,
     last_profile, frames and finish batches per mode, the floor launches
     of every group's wrapper (the coupled submap's and the LFE's, each
     block mode) and M3's (six channels), every last granulepos, every
     stream decoded to its exact length (decode_ogg_fast), stream
     0's SNR within SNR_MARGIN_DB of the JAX package's and its short
     blocks beside JAX's, audio kbps; the busy share under
     torch.profiler (the click train on one stream);
  5. card vs CPU: the port's packets for a 2 s clip on the card and on
     the CPU, byte for byte;
  5b. card vs CPU, stateful: the stateful packets of a 2 s clip
     (encode_batch at B_long=64), >= 90% identical; the count at encode's
     B_long=1024 and the stateless encode_batch's are printed beside it;
  5c. card vs CPU, switched: a 2 s click-train clip at B_long = 64: the
     envelope marks and the schedule equal, >= 90% of packets identical;
  5d. card vs CPU, managed: the same clip through the ABR encoder at
     B_long = B_short = 64: marks and schedule equal, the chosen blobs
     equal printed, >= 85% of packets identical;
  5e. card vs CPU, 5.1: a 2 s 5.1 click train at B_long = B_short = 64:
     marks and schedule equal, >= 90% of packets identical;
  6. decode: the IMDCT kernel (csrc/imdct.cu) and the lap kernel
     (csrc/lap.cu) by bit pattern against their plain versions on the
     card and the host C: the IMDCT at n = 64-8192 on seeded spectra read
     through a permuted row table and on the real spectra of 4d's stream
     0 (tonal, click train) read in place; the lap on
     tests/test_torch_lap.py's seeded streams at every blocksize, its
     -0.0 and subnormal case, the seeded streams with tails and the spans
     before the first and after the last center (the chunked decode's
     lap) and the host IMDCT blocks of those streams;
     then the decode path: decode_ogg_fast_batch(device=True) of 4d's
     16 x 60 s tonal streams, click trains and 4g's 5.1 streams and
     decode_ogg_fast(device=True) of one tonal stream, each bitwise equal
     to device=False and as long as its input, each card call launching
     the IMDCT once a blocksize and the lap once and never the host lap;
     x-realtime card and host-C drain, three times each with the spread;
     the split of the tonal and click-train batches into scan + parse and
     the device half (host plan and row tables, H2D, each IMDCT launch,
     the lap, D2H, the host's rest); the IMDCT's time (CUDA graphs) at 5,166
     rows of n = 2048 and 9,356 rows of n = 256, in turns with the first
     design (commit 5b586f3's, with --imdct-baseline), its bytes bound
     and share, the plain version's time and one torch.matmul against the
     dense IMDCT basis; the lap's time at the tonal batch's shape, in
     turns with the kernel before tails (commit e1480c3's, with
     --lap-baseline), its bound and share, the plain version's and one
     index_add_ of the windowed products;
  6b. the ov_* layer (vorbis_tpu_torch.vorbisfile.OggVorbisFile) on the
     card against device=False, bit for bit, on 4d's tonal and click-train
     stream 0 and a chain of the tonal stream and a 4g 5.1 stream: reads
     of 4096, 313, 20000 and 64 samples to the end (each as long as
     pcm_total), 8 seeded pcm_seeks with their tells and reads, halfrate
     reads, read_all_float, a crosslap, the click train with a corrupt
     page, and a damaged packet held back between a long and a short
     block; every staged chunk launching the IMDCT once a blocksize
     present and the lap once, no host-path chunk, lap or IMDCT and no
     plain version on a card pass; read_float(4096) and halfrate
     x-realtime and the pcm_seek + first read latency, card and host,
     three runs each; both kernels' times at one 256-packet chunk's
     shapes, full rate and halfrate;
  7. the sharded encode step, the roundtrip pipeline and LBG training
     (vorbis_tpu_torch.parallel, models.pipeline, vq): 7a the framed
     encode step of FastEncoder(2, 44100, 0.5) on 2,048 frames of
     _signal(48, 44100, 0) split over a mesh of [cuda:0] * 4 (and every
     card where there are several) bitwise against one device, nbits
     within the static budget, one floor launch a shard, the floor
     kernel against its plain version at a shard's rows, frames/s split
     and whole; 7b TorchCodecPipeline(2, 44100, 0.5).roundtrip_step on
     (4, 2, 256, 2048) frames split 2 x 4 over cuda:0, equal in value
     to the unsplit step (each sp shard starts its lap from the previous
     shard's halo), two IMDCT and two lap launches a shard and no plain
     version, DeviceSynthesis against imdct_plain + lap_plain on the
     card, the card against the CPU, encode_quantize_step card against
     CPU (>= 90% of qpost rows), the roundtrip's times; 7c lbg_train of
     65,536 clustered 4-dim points into 256 entries on the card against
     numpy (final MSE within 25%), both times;
  8. golden: the corpus gate of tests/test_quality_gates.py on the card
     (GATES, GATE_51): FastEncoder(2, rate, q) encodes 1 s of the mix
     signal and of quiet-after-loud at q0.1, q0.8, 16 and 32 kHz, and
     FastEncoder(6, 48000, 0.4) 0.6 s of 5.1, while spawned workers run
     the port's golden encoder (encode_vbr_stream, host numpy) on the
     same clips; both streams decode on the card and _gate's bounds
     hold (RMS error against the golden stream's, segmental SNR within
     2 dB, size ratio); the floor and M3 launches of the card encodes
     and the IMDCT and lap launches of the decodes, each above zero;
     each golden stream's x-realtime in its worker; the sha256 of the
     port's golden stream of a 0.3 s clip beside the JAX package's
     pinned one, with the first analysis stage that differs (not
     gated).
Phase 4b then runs once more under torch.profiler and prints the
device's busy share (4d profiles the same 16-stream batch as 4c, with
switching).  Launch counts are set to 0 just before each main
path (4, 4b, 4c, 4d, 4e, 4f, 4g, 6's decode runs, each card pass
of 6b, 7's split steps and 8's encodes and decodes) and read just
after it.
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
# And for phases 4d and 4e: the JAX package's default encoder (block
# switching and the psy state on) on stream 0 of each 4d leg,
# FastEncoder(2, 44100, 0.5).encode, decoded by vorbis_tpu.vorbisfile:
# SNR in dB and short blocks (JAX 0.9.0 on the CPU;
# `JAX_PLATFORMS=cpu python3 reference_snr.py --switching`; bytes
# 1,210,928 and 887,288).
JAX_SWITCHED_SNR_DB = {"signal": 25.04687, "click_train": 10.74682}
JAX_SWITCHED_SHORTS = {"signal": 9, "click_train": 4678}
# And for phase 4f: the JAX package's managed encoder, FastEncoder(2,
# 44100, bitrate=(-1, 128000, -1)).encode of _click_train(30, 44100, s)
# for streams s = 0 and 7, decoded by vorbis_tpu.vorbisfile (JAX 0.9.0 on
# the CPU; `JAX_PLATFORMS=cpu python3 reference_snr.py --managed`;
# audio 128.316 and 128.374 kbps, 2337 and 2345 short blocks).
JAX_MANAGED_SNR_DB = {0: 7.82215, 7: 8.09780}
# And for phase 4g: the JAX package's 5.1 encoder, FastEncoder(6, 48000,
# 0.4).encode (block switching and the psy state on) of the first stream
# of each 4g leg, _signal51(60, 48000, 0) and _click_train51(30, 48000,
# 0), decoded by vorbis_tpu.vorbisfile: SNR in dB and short blocks (JAX
# 0.9.0 on the CPU; `JAX_PLATFORMS=cpu python3 reference_snr.py --51`;
# bytes 2,243,961 and 849,484, audio 296.057 and 221.272 kbps).
JAX_51_SNR_DB = {"signal51": 19.66066, "click_train51": 4.67523}
JAX_51_SHORTS = {"signal51": 13, "click_train51": 3251}

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
# Operations of the M3 scan that a frame with sw needs a (channel, bin),
# counted from csrc/m3_scan.cu: each spread shift that applies to the bin
# (j <= t and j < bfn[t-j]) the difference, the compare and the count
# (3); one add an increment counted (k); besides, the reset select and
# the base subtraction, the trigger's three compares, add and two ands,
# and the carry select (9).  A frame without sw only passes the carry.
# Its dependent chain a frame with sw: the base subtraction, the compare,
# k adds, and the trigger's add, compare and select (5 + k), at 4 cycles
# a step (an fp32 add's latency) at the 1.98 GHz boost clock.
M3_OPS_PER_SHIFT = 3
M3_OPS_PER_BIN = 9
M3_CHAIN_OPS = 5
CYCLES_PER_DEP_OP = 4
CLOCK_HZ = 1.98e9


# Phase 8's configurations: tests/test_quality_gates.py:67-82's
# (q, rate, rms_ratio), each on 1 s of the mix signal and on
# _quiet_after_loud(rate); the 5.1 relative gate of :85-101 as (q, rate,
# seconds, rms_ratio, size window).
GATES = [(0.1, 44100, 1.2), (0.8, 44100, 1.1), (0.5, 16000, 1.1),
         (0.5, 32000, 1.3)]
GATE_51 = (0.4, 48000, 0.6, 1.3, (0.65, 1.25))
# Phase 8's digest clip, tests/test_encoder.py GOLDEN_MATRIX's first
# row (0.3 s of the mix signal, stereo, 44.1 kHz, q0.4) as (rate, q,
# seconds), through encode_vbr_stream with GOLDEN_COMMENTS.
# GOLDEN_SHA256 is the sha256 of the JAX package's stream of it
# (vorbis_tpu.encode_vbr_stream, numpy on an x86-64 CPU), and
# GOLDEN_STAGE_SHA256 that of each stage utils/analysis_dump.py dumps
# (_golden_digests); tests/test_torch_golden_managed.py holds both
# packages to them.
GOLDEN_CLIP = (44100, 0.4, 0.3)
GOLDEN_COMMENTS = ("TITLE=golden clip", "ENCODER=vorbis_tpu_torch")
GOLDEN_STAGES = ("logmdct", "logfft", "noise", "tone")
GOLDEN_SHA256 = (
    "eb8e67ade74d4f129d901310163c873912ea8975325ec415bbbd44de85deebcd")
GOLDEN_STAGE_SHA256 = {
    "logfft_ch0":
        "bce03d98a467c4b500ac10e843629848ed8beb324828e0aee0b13e7265241610",
    "logfft_ch1":
        "d91ee53b5175a5c833e600347273319d0b2ef6458436f47b4c81f1641b746018",
    "logmdct_ch0":
        "8a5e461a207661e6ebffd5f97c2b336c1153e8fd12b019d7354cdc656d9c9b10",
    "logmdct_ch1":
        "8ed4b5376fa7ec25db1acf5ac6061d6c9d20ff4034461b62df84bdd7386a9750",
    "noise_ch0":
        "7826247d81f76dc7d5ff2f877ef962ee9334555e72cba9d6db77cd1d8e8640db",
    "noise_ch1":
        "2a6fa72ffc2dbe4d0b5a962febe9850221d4af4867687a48ee8c7045b46fa44a",
    "tone_ch0":
        "3f946d4378e8e744235d65b7d2d805ed0a24b788075c8875310a7a203ce6bb6e",
    "tone_ch1":
        "589eb8d3371b1fd77a7a9d8bb08f899ce6b57713afb36da137c998a7a8fa0ce5",
}


def _signal(secs, rate, seed):
    """bench.py's stream: two tones plus seeded noise, int16 stereo."""
    import numpy as np
    t = np.arange(secs * rate) / rate
    rng = np.random.RandomState(seed)
    return _int16(0.30 * np.sin(2 * np.pi * (440 + 7 * seed) * t)[None, :]
                  + 0.10 * np.sin(2 * np.pi * 1873 * t)[None, :]
                  + 0.02 * rng.randn(2, int(secs * rate)))


def _click_mono(secs, rate, seed):
    """The click train's one channel, float64: a decaying click every
    ~90 ms over a quiet tone."""
    import numpy as np
    n = int(secs * rate)
    t = np.arange(n) / rate
    rng = np.random.RandomState(1000 + seed)
    x = 0.05 * np.sin(2 * np.pi * (330 + 11 * seed) * t)
    step = int(0.09 * rate)
    for o in range(step // 2, n - 400, step):
        dur = 256
        env = np.exp(-np.arange(dur) / 40.0)
        x[o:o + dur] += 0.75 * env * rng.randn(dur)
    return x


def _int16(pcmf):
    import numpy as np
    return np.clip(np.rint(pcmf * 32768.0), -32768,
                   32767).astype(np.int16)


def _click_train(secs, rate, seed):
    """bench.py's transient leg: a decaying click every ~90 ms over a
    quiet tonal bed, int16 stereo (every click lands an envelope mark,
    so the schedule mixes short and long blocks throughout)."""
    import numpy as np
    x = _click_mono(secs, rate, seed)
    return _int16(np.stack([x, np.roll(x, 7)]))


def _signal51(secs, rate, seed):
    """A 5.1 stream as tests/test_fastenc.py's test_fast_51_coupled
    builds it, from a seed: five tones plus seeded noise on channels 0-4
    and a 50 Hz LFE, int16."""
    import numpy as np
    n = int(secs * rate)
    t = np.arange(n) / rate
    rng = np.random.RandomState(seed)
    chs = [0.3 * np.sin(2 * np.pi * (300 + 120 * c + 7 * seed) * t)
           + 0.02 * rng.randn(n) for c in range(5)]
    chs.append(0.2 * np.sin(2 * np.pi * 50 * t))
    return _int16(np.stack(chs))


def _click_train51(secs, rate, seed):
    """The click train on channels 0-4 (each a few samples later than the
    one before) and a quiet 50 Hz LFE tone, int16 5.1: it drives the
    short blocks and M3 on six channels."""
    import numpy as np
    x = _click_mono(secs, rate, seed)
    t = np.arange(len(x)) / rate
    return _int16(np.stack([np.roll(x, 7 * c) for c in range(5)]
                           + [0.05 * np.sin(2 * np.pi * 50 * t)]))


def _make_test_signal(rate=44100, seconds=1.0, ch=2, kind="mix", seed=0):
    """tests/oracle.py make_test_signal (a copy: that module loads the
    system libvorbis when imported): windowed sine mix + noise bursts,
    (ch, n) float32 -- both long blocks (tonal) and short blocks
    (transients)."""
    import numpy as np
    n = int(rate * seconds)
    t = np.arange(n) / rate
    rng = np.random.RandomState(seed)
    out = np.zeros((ch, n), dtype=np.float32)
    for c in range(ch):
        sig = (0.45 * np.sin(2 * np.pi * (440 + 60 * c) * t)
               + 0.25 * np.sin(2 * np.pi * (1873 + 40 * c) * t + 0.3)
               + 0.1 * np.sin(2 * np.pi * 7902 * t))
        if kind == "mix":
            sig = sig + 0.02 * rng.randn(n)
            # transient clicks to force short blocks
            for pos in range(rate // 4, n, rate // 3):
                L = min(192, n - pos)
                sig[pos:pos + L] += (0.4 * rng.randn(L) *
                                     np.hanning(L)).astype(np.float64)
        env = np.minimum(1.0, np.minimum(t / 0.01, (t[-1] - t) / 0.01 + 1e-9))
        out[c] = (sig * env * 0.7).astype(np.float32)
    return np.clip(out, -1.0, 1.0)


def _quiet_after_loud(rate):
    """tests/test_quality_gates.py _quiet_after_loud (a copy): 0.5 s of
    a loud 600 Hz tone, then 0.5 s of a quiet 900 Hz one, stereo."""
    import numpy as np
    t = np.arange(rate) / rate
    x = np.concatenate([
        0.8 * np.sin(2 * np.pi * 600 * t[:rate // 2]),
        0.02 * np.sin(2 * np.pi * 900 * t[:rate // 2])])
    return np.stack([x, x]).astype(np.float32)


def _seg_snr(ref, out, seg=2048):
    """tests/test_quality_gates.py _seg_snr (a copy): the mean SNR of the
    2048-sample segments with signal."""
    import numpy as np
    m = min(ref.shape[1], out.shape[1])
    snrs = []
    for o in range(0, m - seg, seg):
        r = ref[:, o:o + seg]
        e = out[:, o:o + seg] - r
        pr = (r ** 2).mean()
        if pr > 1e-9:
            snrs.append(10 * np.log10(pr / max((e ** 2).mean(), 1e-12)))
    return float(np.mean(snrs))


def _golden_digests(encode_vbr_stream, dump, directory):
    """(sha256 of the digest clip's stream, {stage: sha256}): one
    encode_vbr_stream of GOLDEN_CLIP with GOLDEN_COMMENTS while `dump`
    (a package's utils/analysis_dump) writes every stage into the
    emptied `directory`; a stage's digest runs over its vectors in the
    order they were dumped (dtype, shape, bytes)."""
    import hashlib
    import shutil
    import numpy as np
    rate, q, secs = GOLDEN_CLIP
    pcm = _make_test_signal(rate=rate, seconds=secs)
    shutil.rmtree(directory, ignore_errors=True)
    dump.enable(directory)
    try:
        ogg = encode_vbr_stream(pcm, rate, q, comments=list(GOLDEN_COMMENTS))
    finally:
        dump.disable()
    names = sorted({f.rsplit("_", 1)[0] for f in os.listdir(directory)
                    if f.endswith(".npy")})
    stages = {}
    for name in names:
        h = hashlib.sha256()
        seq = 0
        while os.path.exists(os.path.join(directory, f"{name}_{seq}.npy")):
            a = np.load(os.path.join(directory, f"{name}_{seq}.npy"))
            h.update(f"{a.dtype}{a.shape}".encode() + a.tobytes())
            seq += 1
        stages[name] = h.hexdigest()
    return hashlib.sha256(ogg).hexdigest(), stages


def _first_stage_differing(stages):
    """The first stage, in the encoder's order (the log MDCT, the log
    FFT, the noise mask, the tone mask; channel 0 first), whose digest
    differs from GOLDEN_STAGE_SHA256; None when all agree."""
    order = sorted(GOLDEN_STAGE_SHA256, key=lambda k: (GOLDEN_STAGES.index(
        k.rsplit("_ch", 1)[0]), k))
    return next((k for k in order
                 if stages.get(k) != GOLDEN_STAGE_SHA256[k]), None)


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


def _floor_groups(fe):
    """{name: floor-fit wrapper} of an encoder's main path: the long
    look's and, once built, the short look's (a long-only stream opens
    with one short block); on a multi-submap layout (5.1) each submap's
    of each block mode built so far (the coupled submap shares its
    mode's, the LFE has its own)."""
    out = {"long": fe.floor}
    if fe._short_ctx is not None:
        out["short"] = fe._short_ctx.floor
    for mode, d in (("long", fe._dev), ("short", fe._dev_short)):
        if d is not None and d.multi:
            for i, g in enumerate(d.groups):
                if all(g.floor is not f for f in out.values()):
                    out[f"{mode} group {i}"] = g.floor
    return out


def _floors(fe):
    """The floor-fit kernels of an encoder's main path (_floor_groups)."""
    return list(_floor_groups(fe).values())


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


def _test_module(name):
    """tests/<name>.py loaded by its path (another installed package may
    be named `tests`): the one definition of the cases and recorders that
    the tests and this script share."""
    import importlib.util
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, "tests", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return mod


def _m3_cases():
    """tests/test_torch_m3.py: the M3 scan's seeded inputs and the
    segment schedule's edge cases (`m3_case`, `KINDS`)."""
    return _test_module("test_torch_m3")


def _m3_case(kind, n, F):
    """A kind of case of `_m3_cases()` at n bins and F frames as CUDA
    tensors: ([logmdct, lastmdct, val, tval], params)."""
    import numpy as np
    import torch
    args, pr = _m3_cases().m3_case(kind, n, F)
    return ([torch.from_numpy(a).cuda() for a in args],
            {k: torch.from_numpy(np.asarray(v)).cuda()
             for k, v in pr.items()})


def _m3_segments(prm):
    """(segments, longest) of a batch: a segment starts at frame 0 and
    at every frame with sw and reset (csrc/m3_scan.cu)."""
    import torch
    start = prm["sw"].bool() & prm["reset"].bool()
    start[0] = True
    idx = torch.nonzero(start).flatten().tolist() + [start.numel()]
    lens = [b - a for a, b in zip(idx, idx[1:])]
    return len(lens), max(lens)


def _m3_check(scan, name, args, prm):
    """M3 kernel vs its plain version, by bit pattern (a -0.0 against a
    +0.0 or another NaN payload is a mismatch).  Returns (max_abs_err,
    the plain output, segments, longest segment)."""
    import torch
    got = scan(*args, prm)
    want = scan.plain(*args, prm)
    torch.cuda.synchronize()
    bad = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    err = float((got - want).abs().max()) if got.numel() else 0.0
    F, ch, n = args[0].shape
    sw = prm["sw"]
    runs = int((sw[1:] & sw[:-1]).sum()) if F > 1 else 0
    segs, longest = _m3_segments(prm)
    print(f"[m3] {name}: F={F} ch={ch} n={n} sw={int(sw.sum())} "
          f"reset={int(prm['reset'].sum())} consecutive={runs} "
          f"segments={segs} longest={longest} mismatches={bad} "
          f"max_abs_err={err}")
    if bad:
        raise RuntimeError(f"m3 kernel != plain on {name}: {bad}")
    return err, want, segs, longest


def _m3_bound(scan, args, prm, want):
    """(bound_ms, bound_by, chain_ms, detail) of the scan on these
    inputs.  The roofline: the bytes the function needs, each once --
    every frame's sw flag and output row; a frame with sw besides its
    reset flag, noise_center and four input rows (a frame without sw
    only passes the carry on) -- over the HBM rate, against the
    operations this data needs over the fp32 rate.  The chain: the
    longest (segment, channel, bin) column's dependent steps at
    CYCLES_PER_DEP_OP, counted from the batch's own reset flags and
    spread counts k (replayed from the plain output `want`, whose frame
    f - 1 is frame f's carry)."""
    import torch
    lm, last = args[0], args[1]
    F, ch, n = lm.shape
    tab = scan.tabs
    J = tab.shape[0] - 1
    sw = prm["sw"].bool()
    rs = prm["reset"].bool()
    prev = torch.cat([torch.zeros_like(want[:1]), want[:-1]])
    tm = torch.where(rs[:, None, None], last[..., :n], prev) - scan.base
    k = torch.zeros((F, ch, n), dtype=torch.int64, device=lm.device)
    shifts = 0
    for j in range(1, J + 1):
        k[..., j:] += tm[..., j:] < lm[..., :-j] - tab[j - 1, j:]
        shifts += int(torch.isfinite(tab[j - 1, j:]).sum())
    k = torch.where(sw[:, None, None], k, 0)
    steps = torch.where(sw[:, None, None], M3_CHAIN_OPS + k, 0)
    start = sw & rs
    start[0] = True
    seg = torch.cumsum(start.long(), 0) - 1
    per = torch.zeros((int(seg[-1]) + 1, ch, n), dtype=torch.int64,
                      device=lm.device).index_add_(0, seg, steps)
    chain_steps = int(per.max())
    nsw = int(sw.sum())
    nbytes = (4 * nsw + F) * ch * n * 4 + F + nsw * 5
    ops = (nsw * ch * (shifts * M3_OPS_PER_SHIFT + n * M3_OPS_PER_BIN)
           + int(k.sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    chain_ms = chain_steps * CYCLES_PER_DEP_OP / CLOCK_HZ * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, chain_ms, dict(
        bytes=nbytes, bytes_us=t_bytes * 1e3, ops=ops, ops_us=t_ops * 1e3,
        chain_steps=chain_steps, k=int(k.sum()))


def _device_kernels(fn):
    """Names of the device kernels that one call of fn runs, from
    torch.profiler's device-side events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def _graph_ms(fn, reps=50, rounds=4):
    """ms a call of fn from CUDA events around replays of a CUDA graph
    of `reps` calls: a kernel of a few microseconds launched from Python
    would time the host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


# sha256 of the first design's csrc/m3_scan.cu (commit 185cdeb), the
# one earlier version whose C interface _M3Baseline knows
M3_BASELINE_SHA256 = ("fabfacccb97f62edc84ee41b8fd001428e6757980"
                      "2f8bfd8bf936c1995cf8466")


class _M3Baseline:
    """The first design's csrc/m3_scan.cu (one thread per column over all
    frames: `git show 185cdeb:vorbis_tpu_torch/csrc/m3_scan.cu`), built
    from `source` for timing in turns.  Its entry point takes the
    per-frame parameters as one (3, F) float32 block and a (3, n) table
    [bfn, cell, incr]; any other source is refused (its hash differs),
    since it would read another table.  `launch` as M3ScanCuda.launch,
    with the block."""

    def __init__(self, source, scan):
        import ctypes
        import hashlib
        from pathlib import Path
        import numpy as np
        import torch
        from vorbis_tpu_torch.native import build_library
        from vorbis_tpu_torch.ops import floor_cuda
        from vorbis_tpu_torch.ops.psydevice import m3_tables
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()
        if digest != M3_BASELINE_SHA256:
            raise RuntimeError(f"--m3-baseline {source} is not commit "
                               f"185cdeb's m3_scan.cu (sha256 {digest})")
        so, _ = build_library(Path(source), floor_cuda.nvcc,
                              floor_cuda.NVCC_FLAGS, "libm3scan_baseline")
        self.fn = ctypes.CDLL(str(so)).vtt_m3_scan
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                            + [ctypes.c_float, ctypes.c_void_p])
        bfn, cell, incr, _ = m3_tables(scan.look)
        self.tabs = torch.from_numpy(np.stack(
            [bfn.astype(np.float32), cell, incr])).cuda()
        self.scan = scan

    def launch(self, logmdct, lastmdct, val, tval, prm, out):
        import torch
        F, ch, n = logmdct.shape
        rc = self.fn(logmdct.data_ptr(), lastmdct.data_ptr(),
                     val.data_ptr(), tval.data_ptr(), prm.data_ptr(),
                     self.tabs.data_ptr(), out.data_ptr(), F, ch, n,
                     lastmdct.shape[-1], self.scan.maxnb, self.scan.base,
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline m3 launch failed: {rc}")


def _m3_turns(scan, base, args, prm):
    """Kernel times (ms) in turns on one input: this kernel, the
    baseline, the baseline, this kernel (this kernel twice without a
    baseline); the baseline's output must equal this kernel's."""
    import torch
    rows = scan.param_rows(prm, args[0].shape[0])
    out = torch.empty_like(args[0])
    out_b = torch.empty_like(args[0])
    mine = lambda: scan.launch(*args, *rows, out)        # noqa: E731
    order = [mine, mine]
    if base is not None:
        block = torch.stack([r.to(torch.float32) for r in rows])
        theirs = lambda: base.launch(*args, block, out_b)  # noqa: E731
        order = [mine, theirs, theirs, mine]
    ms = [_graph_ms(fn) for fn in order]
    if base is not None and not torch.equal(out.view(torch.int32),
                                            out_b.view(torch.int32)):
        raise RuntimeError("baseline m3 kernel differs from this one")
    return ms


def _phase_m3(fsw, smi, baseline=None):
    """Phase 3b: the M3 scan kernel vs its plain version, by bit
    pattern, on the real short batches of 20 s of the click train (the
    default encoder's short finish batches, F = 256, through the port's
    own probe), on the seeded cases and the segment schedule's edge
    cases of tests/test_torch_m3.py; one main-path call's kernels and
    host time; then its times (CUDA graphs, in turns with `baseline`, a
    path to commit 185cdeb's source) on the real batch and on the
    recorded batch with the longest segment, on one 256-frame chain
    (the worst case) and on 256 frames without sw (the
    staging pipeline alone: every frame only passes the carry), at
    n = 128 and 256, its bounds and the plain version's time.  Returns
    the M3 record's fields for the kernels' JSON line."""
    import types
    import torch
    from vorbis_tpu_torch.ops import m3_cuda
    m3 = fsw.ctx(0).m3_scan
    if not isinstance(m3, m3_cuda.M3ScanCuda):
        raise RuntimeError(f"main path M3 scan is {type(m3).__name__}")
    recorded = []

    def record(*a):
        recorded.append(a)
        return m3(*a)

    fsw._short_ctx.m3_scan = record
    try:
        fsw.encode_batch([torch.from_numpy(_click_train(20, 44100, 0))
                          .cuda()])
    finally:
        fsw._short_ctx.m3_scan = m3
    m3_err = 0.0
    full = None
    slowest = (0, None)     # the recorded batch with the longest segment
    for i, (lm3, last3, v3, tv3, prm3) in enumerate(recorded):
        sub = {k: prm3[k] for k in ("sw", "reset", "noise_center")}
        args = (lm3, last3, v3, tv3)
        err, want, segs, longest = _m3_check(m3, f"click-train batch {i}",
                                             args, sub)
        m3_err = max(m3_err, err)
        if longest > slowest[0]:
            slowest = (longest, (m3, args, sub))
        sw = sub["sw"]
        if (full is None and lm3.shape[0] == 256 and bool(sw.any())
                and bool(sub["reset"].any())
                and int((sw[1:] & sw[:-1]).sum()) >= 2):
            full = (args, sub, want, segs, longest)
    if full is None:
        raise RuntimeError("no F = 256 click-train batch with sw, reset "
                           "and consecutive impulse frames")
    look = fsw.ctx(0).analysis.look
    m3_256 = m3_cuda.M3ScanCuda(types.SimpleNamespace(
        n=256, m3n=look.m3n, vi=look.vi), "cuda")
    kinds = _m3_cases().KINDS
    timed = {"real, longest segment": slowest[1]}
    cases = [("seeded", 128, 1), ("seeded", 128, 3), ("seeded", 128, 256),
             ("seeded", 256, 256)] + [(kind, n_, 256) for n_ in (128, 256)
                                      for kind in kinds if kind != "seeded"]
    for kind, n_, F_ in cases:
        scan = m3 if n_ == 128 else m3_256
        args, prm = _m3_case(kind, n_, F_)
        m3_err = max(m3_err, _m3_check(scan, f"{kind} F={F_} n={n_}", args,
                                       prm)[0])
        if (kind, F_) in (("chain", 256), ("no_sw", 256)) or (
                kind, n_, F_) == ("seeded", 256, 256):
            timed[f"{kind} n={n_}"] = (scan, args, prm)
    args, prm, want, segs, longest = full
    # one wrapper call as the main path makes it (its params as the
    # finish step passes them): the device kernels it runs, and its time
    # on the host's clock (checks, rows, allocation, launch)
    kerns = _device_kernels(lambda: m3(*args, prm))
    if len(kerns) > 1:
        raise RuntimeError(f"one m3 scan call ran {len(kerns)} kernels: "
                           f"{kerns}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        m3(*args, prm)
    torch.cuda.synchronize()
    call_us = (time.perf_counter() - t0) / 200 * 1e6
    print(f"[m3] one main-path call: device kernels {kerns}; "
          f"{call_us:.2f} us a call from the host, 200 calls")
    bases = {}
    if baseline:
        bases = {128: _M3Baseline(baseline, m3),
                 256: _M3Baseline(baseline, m3_256)}
    rows = {}
    for name, (scan, a, p) in [("real", (m3, args, prm))] + list(
            timed.items()):
        rows[name] = _m3_turns(scan, bases.get(scan.n), a, p)
        print(f"[m3] time {name} (F={a[0].shape[0]} n={scan.n}, "
              f"{_m3_segments(p)[0]} segments, longest "
              f"{_m3_segments(p)[1]}): " + ", ".join(
                  f"{t:.5f}" for t in rows[name])
              + (" ms (this, baseline, baseline, this)" if baseline
                 else " ms (two turns)") + f" ({smi})")
    m3_ms = (rows["real"][0] + rows["real"][-1]) / 2
    worst_ms = (rows["chain n=128"][0] + rows["chain n=128"][-1]) / 2
    m3_plain_ms = _cuda_ms(lambda: m3.plain(*args, prm), 3)
    bound_ms, by, chain_ms, mw = _m3_bound(m3, args, prm, want)
    share = max(bound_ms, chain_ms) / m3_ms
    wa, wp = timed["chain n=128"][1:]
    _, _, wchain_ms, ww = _m3_bound(m3, wa, wp, m3.plain(*wa, wp))
    print(f"[m3] scan F=256 ch=2 n={m3.n} (real batch, {segs} segments, "
          f"longest {longest}): kernel {m3_ms:.5f} ms, plain "
          f"{m3_plain_ms:.4f} ms ({smi}); bytes {mw['bytes']} = "
          f"{mw['bytes_us']:.3f} us, operations {mw['ops']} float32 = "
          f"{mw['ops_us']:.3f} us: roofline {bound_ms * 1e3:.3f} us by "
          f"{by}; segment chain {mw['chain_steps']} steps = "
          f"{chain_ms * 1e3:.3f} us (k = {mw['k']} adds in all); share "
          f"{100 * share:.2f}% of the larger; worst case (one chain) "
          f"{worst_ms:.5f} ms against its chain {ww['chain_steps']} steps "
          f"= {wchain_ms * 1e3:.3f} us")
    return {"max_abs_err": m3_err, "ms": m3_ms, "plain_ms": m3_plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "share": share,
            "chain_bound_ms": chain_ms, "segments": segs,
            "longest_segment": longest, "worst_ms": worst_ms,
            "worst_chain_bound_ms": wchain_ms, "call_us": call_us}


def _kernels_of(fe):
    """The path's kernel wrappers: the floor fits (long, and short once
    built) and the short look's M3 scan."""
    ks = _floors(fe)
    if fe._short_ctx is not None:
        ks.append(fe._short_ctx.m3_scan)
    return ks


def _switched_metas(fe, pcms):
    """encode_batch's (ns, base_row, Si) per stream with switching:
    each stream padded to at least one envelope chunk."""
    hop = fe.n // 2
    metas, base = [], 0
    for pcm in pcms:
        ns = pcm.shape[1]
        Si = max(((ns + 5 * hop + 63) // 64) * 64 + 64,
                 (fe._ENV_STEPS + 1) * 64)
        metas.append((ns, base, Si))
        base += Si // 64
    return metas


def _switched_marks(fe, pcms):
    """(marks per stream, per-stream schedule records) of the switched
    set-up: the envelope pass plus the exact stretch rescue, then the
    schedule, as _prepare_switched runs them."""
    x64, per = fe._prepare_switched(pcms, True)
    metas = _switched_metas(fe, pcms)
    marks = fe._envelope_marks_multi(x64, metas)
    fe._stretch_rescue(x64, metas, marks)
    return marks, per


def _prepare_times(fe, pcms):
    """Warm times (s) of the switched set-up alone -- _prepare_switched
    whole, then its envelope pass and its stretch rescue on their own --
    and the long and short frame counts of its schedule."""
    import torch
    metas = _switched_metas(fe, pcms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x64, per = fe._prepare_switched(pcms, True)
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    marks = fe._envelope_marks_multi(x64, metas)
    t_env = time.perf_counter() - t0
    t0 = time.perf_counter()
    fe._stretch_rescue(x64, metas, marks)
    t_res = time.perf_counter() - t0
    nlong = sum(len(r["li"]) for r in per)
    nshort = sum(len(r["si"]) for r in per)
    return (dict(prepare=t_prep, envelope=t_env, rescue=t_res), nlong,
            nshort, per)


def _m3_carry_cuts(fe, per, B_short=256):
    """How often the M3 scan's carry, which starts at zero on every
    short finish batch, cuts a run of impulse frames: over the batch's
    short frames in global order, the impulse frames (sw), those that
    continue a run (sw and not reset: their carry is the previous
    frame's buffer), the batches, the batch starts that fall on such a
    frame, and how many of those are a stream's first short frame."""
    import numpy as np
    from vorbis_tpu_torch.ops import psydevice as PD
    sw, rs, first = [], [], []
    toneatt1 = float(fe.analysis.look.vi["tone_masteratt"][1])
    for r in per:
        ann = PD.annotate_frames(r["Ws"], r["impulse"])
        pr = PD.m3_param_seq(ann, fe.vi.blocksizes[0] // 2, toneatt1, True)
        sw.append(pr["sw"][r["si"]])
        rs.append(pr["reset"][r["si"]])
        first.append(np.arange(len(r["si"])) == 0)
    sw, rs, first = map(np.concatenate, (sw, rs, first))
    run = sw & ~rs
    start = np.arange(len(sw)) % B_short == 0
    start[:1] = False
    return dict(short=len(sw), impulse=int(sw.sum()),
                continuing=int(run.sum()), batches=-(-len(sw) // B_short),
                cut=int((run & start).sum()),
                cut_first=int((run & start & first).sum()))


def _lap(t_start, phase):
    print(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s")


def _short_blocks(fe, ogg):
    """Short (blockflag 0) audio packets of a stream."""
    short = {i for i, m in enumerate(fe.vi.modes) if m.blockflag == 0}
    mask = (1 << fe.modebits) - 1
    return sum((p[0] >> 1) & mask in short for p in _audio_packets(ogg))


def _rows_equal(pa, na, pb, nb):
    """Rows of (F, 15) packet variants (host arrays) with equal bit
    counts and bytes."""
    F, NB = na.shape
    return sum(bool(na[f, k] == nb[f, k]) and
               (pa[f, k, :(na[f, k] + 7) // 8]
                == pb[f, k, :(nb[f, k] + 7) // 8]).all()
               for f in range(F) for k in range(NB))


def _phase_managed_kernels(fm, fm_cpu, smi):
    """Phase 3f: one long and one short managed finish batch at B = 256
    (the first of each in 20 s of the click train, as encode_managed_batch
    runs them through the port's own probe and host recurrences, args
    recorded): the stacked floor fit of the three offset_select masks
    (one launch of 3*B*ch rows) against the plain fit and three separate
    launches, bitwise; each of the short batch's three M3 calls against
    its plain version by bit pattern; the whole 15-blob finish on the
    card against the same step on the CPU, >= 90% of the (F, 15) rows.
    Returns (floor max_abs_err, m3 max_abs_err)."""
    import torch
    from vorbis_tpu_torch.ops import floor_cuda
    B = 256
    calls = {}
    step_of = fm._managed_finish_step

    def spy(W, B_, wb=None):
        step = step_of(W, B_, wb)

        def rec(*a):
            calls.setdefault(W, a)
            return step(*a)
        return rec

    fm._managed_finish_step = spy
    try:
        fm.encode_managed_batch([torch.from_numpy(
            _click_train(20, 44100, 0)).cuda()], B_long=B, B_short=B)
    finally:
        del fm._managed_finish_step
    floor_err = m3_err = 0.0
    for W in (1, 0):
        ctx = fm.ctx(W)
        fl = ctx.floor
        fits, scans, stage_args = [], [], {}
        m3 = fm.ctx(0).m3_scan
        mdev = fm._managed_dev_for(W)
        for name in ("ladder_rows", "blob_rows"):
            def stage(*a, _f=getattr(mdev, name), _n=name):
                stage_args[_n] = a
                return _f(*a)
            setattr(mdev, name, stage)

        def fit(q, a, p):
            fits.append((q, a, p))
            return floor_cuda.DeviceFloorFitCuda.fit(fl, q, a, p)

        def scan(*a):
            scans.append(a)
            return m3(*a)

        fl.fit = fit
        fm._short_ctx.m3_scan = scan
        fl.launches = 0
        try:
            pk, nb = step_of(W, B)(*calls[W])
            torch.cuda.synchronize()
        finally:
            del fl.fit, mdev.ladder_rows, mdev.blob_rows
            fm._short_ctx.m3_scan = m3
        if len(fits) != 1 or fl.launches != 1:
            raise RuntimeError(f"managed W={W}: {len(fits)} floor fits, "
                               f"{fl.launches} launches (one expected)")
        q, a, p = fits[0]
        R = q.shape[0] // 3
        got = fl.fit(q, a, p)
        sep = torch.cat([fl.fit(q[k * R:(k + 1) * R], a[k * R:(k + 1) * R],
                                p[k * R:(k + 1) * R]) for k in range(3)])
        plain = fl.fit_plain(q, a, p)
        torch.cuda.synchronize()
        bad = int((got != plain).sum()) + int((got != sep).sum())
        floor_err = max(floor_err, float((got - plain).abs().max()))
        print(f"[managed] W={W} stacked floor fit: {q.shape[0]} rows "
              f"(3 x {R}) in one launch; mismatches against the plain fit "
              f"and three launches {bad}")
        if bad:
            raise RuntimeError(f"managed W={W}: stacked floor fit differs")
        if W == 0:
            if len(scans) != 3:
                raise RuntimeError(f"managed short batch: {len(scans)} M3 "
                                   f"calls, 3 expected")
            for k, (lm3, last3, v3, tv3, prm3) in enumerate(scans):
                sub = {key: prm3[key]
                       for key in ("sw", "reset", "noise_center")}
                m3_err = max(m3_err, _m3_check(
                    m3, f"managed short batch, select call {k}",
                    (lm3, last3, v3, tv3), sub)[0])
        # the managed-only stages, plain PyTorch (ROADMAP 2.12): device
        # kernels a call and time at this batch's shapes
        choices = torch.zeros(B, dtype=torch.int64, device=pk.device)
        stages = {"ladder": lambda: mdev.ladder_rows(*stage_args[
                      "ladder_rows"]),
                  "blob rows": lambda: mdev.blob_rows(*stage_args[
                      "blob_rows"]),
                  "gather": lambda: mdev.gather(pk, choices)}
        print(f"[managed] W={W} plain managed-only stages at B={B}: " + "; "
              .join(f"{k} {len(_device_kernels(f))} kernels "
                    f"{_cuda_ms(f, 20):.4f} ms" for k, f in stages.items())
              + f" ({smi})")
        pc, nc = fm_cpu._managed_finish_step(W, B)(
            *(None if t is None else t.cpu() for t in calls[W]))
        same = _rows_equal(pk.cpu().numpy(), nb.cpu().numpy(), pc.numpy(),
                           nc.numpy())
        print(f"[managed] W={W} 15-blob finish, card vs CPU: {same}/"
              f"{nc.numel()} rows equal in bits and bytes; bits "
              f"{int(nb.sum())} card, {int(nc.sum())} CPU ({smi})")
        if same < 0.9 * nc.numel():
            raise RuntimeError(f"managed W={W}: card and CPU rows differ "
                               f"in more than 10%")
    return floor_err, m3_err


def _audio_kbps(ogg, ns, rate=44100):
    return sum(map(len, _audio_packets(ogg))) * 8 / (ns / rate) / 1000


def _phase_managed_leg(fm, smi):
    """Phase 4f: bench.py's managed transient leg, encode_managed_batch
    of 8 x 30 s click trains from CUDA tensors at ABR 128 kbps, warm,
    then timed; then one 30 s CBR stream.  Returns the (floor, M3)
    launches of the timed run."""
    import numpy as np
    import torch
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    S, secs = 8, 30
    streams = [torch.from_numpy(_click_train(secs, 44100, k)).cuda()
               for k in range(S)]
    fm.encode_managed_batch(streams[:2])            # warm-up
    torch.cuda.synchronize()
    for k in _kernels_of(fm):
        k.launches = 0
    t0 = time.perf_counter()
    oggs = fm.encode_managed_batch(streams)
    torch.cuda.synchronize()
    t_m = time.perf_counter() - t0
    fl = fm.floor.launches + fm._short_ctx.floor.launches
    m3_n = fm._short_ctx.m3_scan.launches
    lm = dict(fm.last_managed)
    prof = dict(fm.last_profile)
    batches = lm["long_batches"] + lm["short_batches"]
    redos = lm["redos_long"] + lm["redos_short"]
    if fl != batches + redos or m3_n != 3 * (lm["short_batches"]
                                             + lm["redos_short"]):
        raise RuntimeError(f"managed: floor launches {fl}, M3 {m3_n} for "
                           f"{batches} finish batches and {redos} redos")
    for k, o in enumerate(oggs):
        if _last_granulepos(o) != streams[k].shape[1]:
            raise RuntimeError(f"managed stream {k}: last granulepos "
                               f"{_last_granulepos(o)}")
    kbps = [_audio_kbps(o, streams[k].shape[1]) for k, o in enumerate(oggs)]
    snrs = {}
    for k in (0, S - 1):
        out_k, _ = _decode(oggs[k])
        snrs[k] = _snr(streams[k].cpu().numpy(), out_k)
        print(f"[managed] stream {k}: {len(oggs[k])} bytes, "
              f"{_short_blocks(fm, oggs[k])} short blocks, decoded "
              f"{out_k.shape}, SNR {snrs[k]:.3f} dB (JAX "
              f"{JAX_MANAGED_SNR_DB[k]:.3f} dB)")
        if abs(snrs[k] - JAX_MANAGED_SNR_DB[k]) > SNR_MARGIN_DB:
            raise RuntimeError(f"managed stream {k}: SNR {snrs[k]:.3f} dB "
                               f"not within {SNR_MARGIN_DB} dB of the JAX "
                               f"stream")
    print(f"[managed] ABR 128 kbps {S} x {secs} s click train: {t_m:.4f} s "
          f"= {S * secs / t_m:.2f}x realtime; {lm['long']} long + "
          f"{lm['short']} short frames in {lm['long_batches']} + "
          f"{lm['short_batches']} finish batches; launches: floor {fl}, "
          f"m3 {m3_n}; oversized redos {lm['redos_long']} long + "
          f"{lm['redos_short']} short; truncates {lm['truncates']}, pads "
          f"{lm['pads']}; audio kbps " + ", ".join(f"{v:.2f}" for v in kbps)
          + "; last_profile (s): " + ", ".join(
              f"{k} {v:.4f}" for k, v in prof.items()) + f" ({smi})")
    if not all(100 <= v <= 165 for v in kbps):
        raise RuntimeError(f"managed: a stream outside 100-165 kbps: {kbps}")
    # the profiler's cost grows with the kernel count: 2 streams, against
    # the unprofiled wall of the same 2 streams
    t0 = time.perf_counter()
    fm.encode_managed_batch(streams[:2])
    torch.cuda.synchronize()
    t_prof = time.perf_counter() - t0
    busy, dev_ms, rows = _busy_share(
        lambda: fm.encode_managed_batch(streams[:2]), t_prof)
    print(f"[managed] profiled (2 streams): device {dev_ms:.3f} ms, busy "
          f"{100 * busy:.1f}% of the unprofiled {t_prof:.4f} s; top: "
          + "; ".join(rows))
    # one 30 s CBR stream: the floater on its walls
    fc = FastEncoder(2, 44100, bitrate=(128000, 128000, 128000))
    t0 = time.perf_counter()
    ogg_c = fc.encode_managed_batch([streams[0]])[0]
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    out_c, _ = _decode(ogg_c)
    snr_c = _snr(streams[0].cpu().numpy(), out_c)
    lc = fc.last_managed
    print(f"[managed] CBR 128 kbps 30 s click train (cold): {t_c:.4f} s, "
          f"{len(ogg_c)} bytes, audio "
          f"{_audio_kbps(ogg_c, streams[0].shape[1]):.2f} kbps, truncates "
          f"{lc['truncates']}, pads {lc['pads']}, redos "
          f"{lc['redos_long'] + lc['redos_short']}, decoded {out_c.shape}, "
          f"SNR {snr_c:.3f} dB")
    # the long-only managed paths (switching=False), stateful and
    # stateless, on the first 10 s of stream 0
    clip = streams[0][:, :10 * 44100]
    for psy_state in (True, False):
        fm.psy_state = psy_state
        try:
            t0 = time.perf_counter()
            ogg_l = fm.encode_managed(clip, switching=False)
            torch.cuda.synchronize()
            t_l = time.perf_counter() - t0
        finally:
            fm.psy_state = True
        out_l, _ = _decode(ogg_l)
        snr_l = _snr(clip.cpu().numpy(), out_l)
        print(f"[managed] long-only psy_state={psy_state} 10 s (cold): "
              f"{t_l:.4f} s, {len(ogg_l)} bytes, audio "
              f"{_audio_kbps(ogg_l, clip.shape[1]):.2f} kbps, decoded "
              f"{out_l.shape}, SNR {snr_l:.3f} dB")
    return fl, m3_n


def _phase_managed_card_vs_cpu(fm, fm_cpu, clip, clip_dev):
    """Phase 5d: the clip through the ABR encoder on the card and on the
    CPU at B_long = B_short = 64: the envelope marks and the schedule
    equal, the chosen blobs equal printed, >= 85% of packets
    identical."""
    import numpy as np
    (mk_card,), per_card = _switched_marks(fm, [clip_dev])
    (mk_cpu,), per_cpu = _switched_marks(fm_cpu, [clip])
    sched = all(np.array_equal(per_card[0][k], per_cpu[0][k])
                for k in ("cs", "Ws", "impulse"))
    a = _audio_packets(fm.encode_managed_batch([clip_dev], B_long=64,
                                               B_short=64)[0])
    cho_card = fm.last_managed["choices"][0]
    b = _audio_packets(fm_cpu.encode_managed_batch([clip], B_long=64,
                                                   B_short=64)[0])
    cho_cpu = fm_cpu.last_managed["choices"][0]
    if len(a) != len(b):
        raise RuntimeError(f"managed: card {len(a)} packets, CPU {len(b)}")
    same = sum(x == y for x, y in zip(a, b))
    print(f"[card-vs-cpu] managed: marks {int(mk_card.sum())} card, "
          f"{int(mk_cpu.sum())} CPU, {int((mk_card != mk_cpu).sum())} "
          f"differ; schedule {'equal' if sched else 'DIFFERS'}; chosen "
          f"blobs equal {int((cho_card == cho_cpu).sum())}/{len(cho_cpu)}; "
          f"identical packets {same}/{len(a)} (B=64)")
    if (mk_card != mk_cpu).any() or not sched:
        raise RuntimeError("managed: card and CPU marks or schedule differ")
    if same < 0.85 * len(a):
        raise RuntimeError("managed card and CPU packets differ in more "
                           "than 15%")


def _phase_51_kernels(f51, smi):
    """Phase 3g: both hand kernels at the shapes the 5.1 encoder sends
    them.  The floor kernel bitwise against its plain version on the
    three floor looks of FastEncoder(6, 48000, 0.4) (the port's
    encsetup): P = 29, n = 1024 (long), P = 13, n = 128 (short) and the
    LFE's P = 2, n = 12, each at B = 256 * 5 and B = 256 rows of random
    spectra (_random_spectra), then its time (CUDA events), bound and
    plain time at the rows of one main-path finish batch: the coupled
    submap's B_long * 5 = 10,240 and B_short * 5 = 1,280 rows, the LFE's
    2,048 and 256.  The M3 kernel by bit pattern on every short batch of
    5 s of the 5.1 click train (F = 256, six channels, through the
    port's own probe), and its time on the first full batch (CUDA
    graphs).  Returns the records for the kernels' JSON line."""
    import torch
    from vorbis_tpu_torch.codec.encoder import Encoder
    from vorbis_tpu_torch.models import encsetup
    from vorbis_tpu_torch.ops import floor_cuda
    looks = Encoder(encsetup.setup_vbr_staged(6, 48000, 0.4).init()
                    ).floor_looks
    by = {(lk.posts, lk.n): lk for lk in looks}
    if sorted(by) != [(2, 12), (13, 128), (29, 1024)]:
        raise RuntimeError(f"5.1 floor looks {sorted(by)}")
    fl_err, fl_rec = 0, []
    timed = [((29, 1024), 10240), ((13, 128), 1280), ((2, 12), 2048),
             ((2, 12), 256)]
    for (P, n), lk in sorted(by.items()):
        fit = floor_cuda.DeviceFloorFitCuda(lk, "cuda")
        for B in sorted({1280, 256} | {b for pn, b in timed
                                       if pn == (P, n)}):
            q, a, p, _ = fit.prepare(*_random_spectra(n, B, 40 + P))
            fl_err = max(fl_err, _check(fit, f"5.1 P={P} n={n}", q, a, p))
            if ((P, n), B) not in timed:
                continue
            ms = _cuda_ms(lambda: fit.fit(q, a, p), 100)
            plain_ms = _cuda_ms(lambda: fit.fit_plain(q, a, p), 3)
            bound_ms, bound_by, _ = _bound(fit, q, a, p)
            print(f"[5.1 kernel] floor fit P={P} n={n} B={B}: kernel "
                  f"{ms:.5f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms * 1e3:.3f} us by {bound_by}, share "
                  f"{100 * bound_ms / ms:.1f}% ({smi})")
            fl_rec.append(dict(P=P, n=n, B=B, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by))
    # the MDCT accumulates in float64 (torchdsp.DeviceAnalysis.mdct):
    # its cost at one long finish batch's rows, beside an fp32 GEMM
    da = f51.analysis
    w = torch.randn(2048 * 6, f51.n, device="cuda")
    t64 = _cuda_ms(lambda: da.mdct(w), 20)
    t32 = _cuda_ms(lambda: torch.matmul(w, da.mdct_basis), 20)
    print(f"[5.1 kernel] MDCT of one long finish batch ({w.shape[0]} x "
          f"{f51.n}): float64-accumulated {t64:.4f} ms, fp32 GEMM "
          f"{t32:.4f} ms ({smi})")
    m3 = f51.ctx(0).m3_scan
    recorded = []

    def record(*a):
        recorded.append(a)
        return m3(*a)

    f51._short_ctx.m3_scan = record
    try:
        f51.encode_batch([torch.from_numpy(_click_train51(5, 48000, 0))
                          .cuda()])
    finally:
        f51._short_ctx.m3_scan = m3
    m3_err, first = 0.0, None
    for i, (lm3, last3, v3, tv3, prm3) in enumerate(recorded):
        sub = {k: prm3[k] for k in ("sw", "reset", "noise_center")}
        args = (lm3, last3, v3, tv3)
        if lm3.shape[1] != 6:
            raise RuntimeError(f"5.1 M3 call on {lm3.shape[1]} channels")
        err, want, segs, longest = _m3_check(m3, f"5.1 click-train batch "
                                             f"{i}", args, sub)
        m3_err = max(m3_err, err)
        if first is None and lm3.shape[0] == 256 and bool(sub["sw"].any()):
            first = (args, sub, want, segs, longest)
    if first is None:
        raise RuntimeError("no F = 256 5.1 short batch with sw")
    args, sub, want, segs, longest = first
    rows = _m3_turns(m3, None, args, sub)
    m3_ms = (rows[0] + rows[-1]) / 2
    m3_plain = _cuda_ms(lambda: m3.plain(*args, sub), 3)
    bound_ms, bound_by, chain_ms, w = _m3_bound(m3, args, sub, want)
    print(f"[5.1 kernel] m3 scan F=256 ch=6 n={m3.n} ({segs} segments, "
          f"longest {longest}): kernel {m3_ms:.5f} ms (turns "
          f"{rows[0]:.5f}, {rows[-1]:.5f}), plain {m3_plain:.4f} ms; "
          f"roofline {bound_ms * 1e3:.3f} us by {bound_by}, segment chain "
          f"{chain_ms * 1e3:.3f} us ({w['chain_steps']} steps); share "
          f"{100 * max(bound_ms, chain_ms) / m3_ms:.2f}% ({smi})")
    return fl_err, fl_rec, m3_err, dict(
        F=256, ch=6, n=m3.n, ms=m3_ms, plain_ms=m3_plain,
        bound_ms=bound_ms, bound_by=bound_by, chain_bound_ms=chain_ms)


def _decode(ogg):
    """One stream through the port's fast decode with the IMDCT on the
    card (phase 3h holds it bitwise against the port's scalar decoder):
    (pcm (ch, n) float32, vi)."""
    from vorbis_tpu_torch.models.fastdec import decode_ogg_fast
    return decode_ogg_fast(ogg)


def _phase_51(f51, smi, keep):
    """Phase 4g: FastEncoder(6, 48000, 0.4) (5.1: block switching and the
    psy state on) encode_batch of 4 x 60 s of _signal51 and 4 x 30 s of
    _click_train51 (seeds 0-3) from CUDA tensors, warm, then timed:
    x-realtime, last_profile, frames and finish batches per mode, the
    floor launches of every group's wrapper (the coupled submap's and
    the LFE's, long and short) and M3's (on six channels: the warm-up's
    calls are recorded), every last granulepos, every stream decoded by
    decode_ogg_fast on the card to its exact length,
    stream 0's SNR within SNR_MARGIN_DB of the JAX package's and its
    short blocks beside JAX's, each stream's audio kbps; then the busy
    share under torch.profiler (the click train on one stream) and the
    largest kernels.  Returns the timed runs' (floor, M3) launches and
    keeps each leg's streams and input lengths in `keep` for phase 6."""
    S, rate = 4, 48000
    total = [0, 0]
    for leg, gen, secs in (("signal51", _signal51, 60),
                           ("click_train51", _click_train51, 30)):
        fl, m3_n = _leg_51(f51, smi, keep, leg, gen, secs, S, rate)
        total[0] += fl
        total[1] += m3_n
    return tuple(total)


def _leg_51(f51, smi, keep, leg, gen, secs, S, rate):
    """One leg of phase 4g (_phase_51); returns its (floor, M3)
    launches."""
    import torch
    pcms = [gen(secs, rate, k) for k in range(S)]
    streams = [torch.from_numpy(x).cuda() for x in pcms]
    m3 = f51.ctx(0).m3_scan
    chans = set()

    def record(*a):
        chans.add(a[0].shape[1])
        return m3(*a)

    f51._short_ctx.m3_scan = record
    try:
        f51.encode_batch(streams[:1])             # warm-up
        torch.cuda.synchronize()
    finally:
        f51._short_ctx.m3_scan = m3
    groups = _floor_groups(f51)
    for k in _kernels_of(f51):
        k.launches = 0
    t0 = time.perf_counter()
    oggs = f51.encode_batch(streams)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    fl = {k: w.launches for k, w in groups.items()}
    m3_n = m3.launches
    prof = dict(f51.last_profile)
    shorts = [_short_blocks(f51, o) for o in oggs]
    npk = [len(_audio_packets(o)) for o in oggs]
    nshort = sum(shorts)
    nlong = sum(npk) - nshort
    nb_l, nb_s = -(-nlong // 2048), -(-nshort // 256)
    fl_long = (fl["long"], fl["long group 1"])
    fl_short = (fl["short"], fl["short group 1"])
    if (fl_long[0] != fl_long[1] or fl_long[0] < nb_l
            or fl_short[0] != fl_short[1] or fl_short[0] < nb_s
            or m3_n < nb_s or (nshort and not m3_n)
            or chans != {6}):
        raise RuntimeError(f"{leg}: floor launches {fl}, M3 {m3_n} on "
                           f"channels {chans}, for {nb_l} long + {nb_s} "
                           f"short finish batches")
    for k, o in enumerate(oggs):
        if _last_granulepos(o) != pcms[k].shape[1]:
            raise RuntimeError(f"{leg} stream {k}: last granulepos "
                               f"{_last_granulepos(o)}")
    snrs = [_snr(x, _decode(o)[0]) for o, x in zip(oggs, pcms)]
    keep[leg] = (oggs, [x.shape[1] for x in pcms])
    kbps = [_audio_kbps(o, x.shape[1], rate) for o, x in zip(oggs, pcms)]
    print(f"[5.1] {leg} stream 0: {len(oggs[0])} bytes, {shorts[0]} "
          f"short blocks (JAX {JAX_51_SHORTS[leg]}), SNR {snrs[0]:.3f} "
          f"dB (JAX {JAX_51_SNR_DB[leg]:.3f} dB); every stream decoded "
          f"to its length, SNR " + ", ".join(f"{v:.3f}" for v in snrs)
          + " dB; audio kbps " + ", ".join(f"{v:.2f}" for v in kbps))
    if abs(snrs[0] - JAX_51_SNR_DB[leg]) > SNR_MARGIN_DB:
        raise RuntimeError(f"{leg}: SNR {snrs[0]:.3f} dB not within "
                           f"{SNR_MARGIN_DB} dB of the JAX stream")
    print(f"[5.1] {leg} {S} x {secs} s: {t:.4f} s = "
          f"{S * secs / t:.2f}x realtime; {nlong} long + {nshort} short "
          f"frames in {nb_l} + {nb_s} finish batches; floor launches "
          + ", ".join(f"{k} {v}" for k, v in fl.items())
          + f"; m3 {m3_n} on {sorted(chans)} channels; last_profile (s): "
          + ", ".join(f"{k} {v:.4f}" for k, v in prof.items())
          + f" ({smi})")
    # the profiler's cost grows with the kernel count: the click
    # train is profiled on one stream, against its unprofiled wall
    prof_streams = streams if leg == "signal51" else streams[:1]
    t_prof = t
    if leg != "signal51":
        t0 = time.perf_counter()
        f51.encode_batch(prof_streams)
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
    busy, dev_ms, rows = _busy_share(
        lambda: f51.encode_batch(prof_streams), t_prof)
    print(f"[5.1] {leg} profiled ({len(prof_streams)} streams): device "
          f"{dev_ms:.3f} ms, busy {100 * busy:.1f}% of the unprofiled "
          f"{t_prof:.4f} s; top: " + "; ".join(rows))
    return sum(fl.values()), m3_n


def _phase_51_card_vs_cpu(f51, f51_cpu):
    """Phase 5e: a 2 s 5.1 click train through FastEncoder(6, 48000, 0.4)
    on the card and on the CPU at B_long = B_short = 64: the envelope
    marks and the schedule equal, >= 90% of packets identical."""
    import numpy as np
    import torch
    clip = np.ascontiguousarray(_click_train51(2, 48000, 0))
    clip_dev = torch.from_numpy(clip).cuda()
    (mk_card,), per_card = _switched_marks(f51, [clip_dev])
    (mk_cpu,), per_cpu = _switched_marks(f51_cpu, [clip])
    sched = all(np.array_equal(per_card[0][k], per_cpu[0][k])
                for k in ("cs", "Ws", "impulse"))
    a = _audio_packets(f51.encode_batch([clip_dev], B_long=64,
                                        B_short=64)[0])
    b = _audio_packets(f51_cpu.encode_batch([clip], B_long=64,
                                            B_short=64)[0])
    if len(a) != len(b):
        raise RuntimeError(f"5.1: card {len(a)} packets, CPU {len(b)}")
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    print(f"[card-vs-cpu] 5.1: marks {int(mk_card.sum())} card, "
          f"{int(mk_cpu.sum())} CPU, {int((mk_card != mk_cpu).sum())} "
          f"differ; schedule {'equal' if sched else 'DIFFERS'} "
          f"({int((per_card[0]['Ws'] == 0).sum())} short blocks); "
          f"identical packets {len(a) - len(diff)}/{len(a)} (B=64)")
    if (mk_card != mk_cpu).any() or not sched:
        raise RuntimeError("5.1: card and CPU marks or schedule differ")
    if len(a) - len(diff) < 0.9 * len(a):
        raise RuntimeError("5.1 card and CPU packets differ in more than "
                           "10%")


def _phase_decode_vs_scalar(fsw, fm, f51):
    """Phase 3h: decode_ogg_fast with the IMDCT on the card against the
    port's scalar decoder (vorbis_tpu_torch.codec.decoder) and the host-C
    drain, bit for bit, on 2 s click-train clips of the stereo switched,
    managed (ABR 128 kbps) and 5.1 encoders, so that phases 4-4g can read
    their streams with it."""
    import numpy as np
    import torch
    from vorbis_tpu_torch.codec.decoder import decode_ogg
    from vorbis_tpu_torch.models.fastdec import decode_ogg_fast

    def card(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    clips = (("switched", fsw.encode_batch([card(_click_train(2, 44100, 0))])),
             ("managed", fm.encode_managed_batch(
                 [card(_click_train(2, 44100, 0))])),
             ("5.1", f51.encode_batch([card(_click_train51(2, 48000, 0))])))
    for name, (ogg,) in clips:
        t0 = time.perf_counter()
        want, _ = decode_ogg(ogg)
        t_scalar = time.perf_counter() - t0
        got, _ = decode_ogg_fast(ogg)
        host, _ = decode_ogg_fast(ogg, device=False)
        same = [g.shape == want.shape and np.array_equal(
            g.view(np.uint32), want.view(np.uint32)) for g in (got, host)]
        print(f"[decode] {name} 2 s clip: card {same[0]}, host-C drain "
              f"{same[1]} bitwise against the scalar decoder "
              f"({want.shape}, scalar {t_scalar:.2f} s)")
        if not all(same):
            raise RuntimeError(f"{name}: the fast decode differs from the "
                               f"scalar decoder")


def _imdct_work(n, rows):
    """(bytes, float32 operations) of `rows` IMDCT rows of blocksize n:
    each input float read once, each row's table entry (8 bytes) and
    each output float written once; the operations as the code does
    them: stage A 3 an output of n/2, a radix-2 butterfly 10 (n/8 a
    stage), a 32-point tail 176, stage C 16 a pair of n/8, stage D 8 an
    output pair of n/4."""
    from vorbis_tpu_torch.ops.mdct import _imdct_index_tables
    nst = len(_imdct_index_tables(n)["stages"])
    ops = (3 * (n // 2) + nst * (n // 8) * 10 + (n // 64) * 176
           + (n // 8) * 16 + (n // 4) * 8)
    return rows * ((n // 2 + n) * 4 + 8), rows * ops


def _roofline(nbytes, ops):
    """(bound ms, what bounds it) of a kernel that moves `nbytes` and
    does `ops` float32 operations."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def _spread(ts):
    ts = sorted(ts)
    return f"{ts[len(ts) // 2]:.4f} s (min {ts[0]:.4f}, max {ts[-1]:.4f})"


def _lap_cases():
    """tests/test_torch_lap.py: the lap's seeded cases (`lap_case`,
    `CASE_PAIRS`, `signed_zero_case`, `lap_inputs`, `tail_inputs`)."""
    return _test_module("test_torch_lap")


# sha256 of the first design's csrc/imdct.cu (commit 5b586f3), the one
# earlier version whose C interface _ImdctBaseline knows
IMDCT_BASELINE_SHA256 = ("f871fc59209805631ccb7224c820f2af3c1ccdc0422edc"
                         "24aa168e22b94ee1fd")


class _ImdctBaseline:
    """The first design's csrc/imdct.cu (one thread block a row, a stage
    a barrier, the tails on one thread in 32: `git show
    5b586f3:vorbis_tpu_torch/csrc/imdct.cu`), built from `source` for
    timing in turns on packed rows.  Its entry point takes thirteen
    index and trig tables, made here from ops/mdct.py as that commit's
    wrapper made them; any other source is refused (its hash differs)."""

    NAMES = ("T", "sa", "sb", "ia", "ib", "ta", "tb", "tc_all",
             "stage_off", "e0", "e1", "tC", "tD")

    def __init__(self, source):
        import ctypes
        import hashlib
        from pathlib import Path
        from vorbis_tpu_torch.native import build_library
        from vorbis_tpu_torch.ops import floor_cuda
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()
        if digest != IMDCT_BASELINE_SHA256:
            raise RuntimeError(f"--imdct-baseline {source} is not commit "
                               f"5b586f3's imdct.cu (sha256 {digest})")
        so, _ = build_library(Path(source), floor_cuda.nvcc,
                              floor_cuda.NVCC_FLAGS, "libimdct_baseline")
        self.fn = ctypes.CDLL(str(so)).vtt_imdct
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_long]
                            + [ctypes.c_int] * 2
                            + [ctypes.c_void_p] * (len(self.NAMES) + 1))
        self.tabs = {}

    def _tables(self, n):
        import numpy as np
        import torch
        from vorbis_tpu_torch.ops.mdct import _imdct_index_tables
        if n not in self.tabs:
            tbl = _imdct_index_tables(n)
            tcs = [np.asarray(tc, np.int32) for _, tc in tbl["stages"]]
            offs = np.cumsum([0] + [len(tc) for tc in tcs])[:-1]
            arrs = dict(T=np.asarray(tbl["T"], np.float32),
                        sa=np.asarray(tbl["sa"], np.float32),
                        sb=np.asarray(tbl["sb"], np.float32),
                        tc_all=(np.concatenate(tcs) if tcs
                                else np.zeros(1, np.int32)),
                        stage_off=np.asarray(offs if tcs else [0],
                                             np.int32))
            for k in ("ia", "ib", "ta", "tb", "e0", "e1", "tC", "tD"):
                arrs[k] = np.asarray(tbl[k], np.int32)
            t = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
                 for k, v in arrs.items()}
            self.tabs[n] = (t, len(tcs))
        return self.tabs[n]

    def launch(self, x, n, out):
        import torch
        t, nst = self._tables(n)
        rc = self.fn(x.data_ptr(), out.data_ptr(), x.shape[0], n, nst,
                     *(t[k].data_ptr() for k in self.NAMES),
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline imdct launch failed: {rc}")


def _imdct_turns(x, n, base):
    """The IMDCT kernel's ms (CUDA graphs) on packed (R, n/2) rows `x`, in
    turns with the baseline (this kernel, the baseline, the baseline,
    this kernel), or twice alone; the baseline's output must equal this
    kernel's bit for bit."""
    import numpy as np
    import torch
    from vorbis_tpu_torch.ops.imdct_cuda import imdct
    R = x.shape[0]
    offs = np.arange(R, dtype=np.int64) * (n // 2)
    offs_d = torch.from_numpy(offs).cuda()
    flat = x.reshape(-1)
    out = torch.empty((R, n), device="cuda")
    out_b = torch.empty((R, n), device="cuda")
    mine = lambda: imdct(flat, n, rows=offs, out=out,     # noqa: E731
                         rows_dev=offs_d)
    order = [mine, mine]
    if base is not None:
        theirs = lambda: base.launch(x, n, out_b)          # noqa: E731
        order = [mine, theirs, theirs, mine]
    ms = [_graph_ms(fn) for fn in order]
    if base is not None and not torch.equal(out.view(torch.int32),
                                            out_b.view(torch.int32)):
        raise RuntimeError("baseline imdct kernel differs from this one")
    return ms


# sha256 of the redesign's csrc/lap.cu (commit e1480c3), the one earlier
# version whose C interface _LapBaseline knows
LAP_BASELINE_SHA256 = ("808a08b05367e0a18ff55c29db4e081262b374aea3949633"
                       "3bade6f8ebef1a79")


class _LapBaseline:
    """The lap kernel before it took tails and wrote the spans before a
    stream's first center and after its last (`git show
    e1480c3:vorbis_tpu_torch/csrc/lap.cu`), built from `source` for
    timing in turns on a plan without tails whose trims lie inside
    [c_0, c_last), where both write the same bits.  Its entry point
    takes the stream table's first four columns; any other source is
    refused (its hash differs)."""

    def __init__(self, source):
        import ctypes
        import hashlib
        from pathlib import Path
        from vorbis_tpu_torch.native import build_library
        from vorbis_tpu_torch.ops import floor_cuda
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()
        if digest != LAP_BASELINE_SHA256:
            raise RuntimeError(f"--lap-baseline {source} is not commit "
                               f"e1480c3's lap.cu (sha256 {digest})")
        so, _ = build_library(Path(source), floor_cuda.nvcc,
                              floor_cuda.NVCC_FLAGS, "liblap_baseline")
        self.fn = ctypes.CDLL(str(so)).vtt_lap
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = ([ctypes.c_void_p] * 5
                            + [ctypes.c_long, ctypes.c_void_p])

    def launch(self, blocks, wins, pk, st4, out, npk):
        import torch
        rc = self.fn(blocks.data_ptr(), wins.data_ptr(), pk.data_ptr(),
                     st4.data_ptr(), out.data_ptr(), npk,
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline lap launch failed: {rc}")


def _lap_turns(blocks, wins, plan, tabs, base):
    """The lap kernel's ms (CUDA graphs) at `plan`, in turns with the
    baseline (this kernel, the baseline, the baseline, this kernel), or
    twice alone, and this kernel's output; the baseline's output must
    equal it bit for bit."""
    import numpy as np
    import torch
    from vorbis_tpu_torch.ops.lap_cuda import lap
    mine = lambda: lap(blocks, wins, plan, tables=tabs)   # noqa: E731
    order = [mine, mine]
    if base is not None:
        st4 = torch.from_numpy(np.ascontiguousarray(plan.st[:, :4])).cuda()
        out_b = torch.empty(plan.total, device="cuda")
        theirs = (lambda: base.launch(blocks, wins, tabs[0], st4,   # noqa
                                      out_b, len(plan.pk)))
        order = [mine, theirs, theirs, mine]
    ms = [_graph_ms(fn, reps=10) for fn in order]
    got = mine()
    if base is not None and not torch.equal(got.view(torch.int32),
                                            out_b.view(torch.int32)):
        raise RuntimeError("baseline lap kernel differs from this one")
    return ms, got


def _lap_work(plan):
    """(bytes, float32 operations) of the lap of `plan`: every block
    float read once (each block's ch x n, whatever the trim keeps), every
    tail float, the windows and tables once, every output float written
    once; 4 operations an output sample (two products, two sums)."""
    import numpy as np
    blk = sum(int(np.asarray(n, np.int64).sum()) * ch
              for ch, n, *_ in plan.streams)
    tail = int((plan.st[:, 2] * plan.st[:, 7]).sum())
    nbytes = (4 * (blk + tail + plan.total)
              + 8 * (plan.pk.size + plan.st.size))
    return nbytes, 4 * plan.total


def _index_add_lap(blocks, wins, plan):
    """The lap's library yardstick: each block element inside its
    stream's [lo, hi) times its window (made here, outside the timing)
    and its destination in the flat output, for one
    `torch.Tensor.index_add_` into a zeroed buffer."""
    import torch
    pk = torch.from_numpy(plan.pk).cuda()
    st = torch.from_numpy(plan.st).cuda()
    n, sid = pk[:, 3] & 0xffff, pk[:, 3] >> 16
    ch = st[sid, 2]
    prow = torch.repeat_interleave(torch.arange(len(pk), device="cuda"), ch)
    first = torch.cumsum(ch, 0) - ch
    c = torch.arange(len(prow), device="cuda") - first[prow]
    nr = n[prow]
    row = torch.repeat_interleave(torch.arange(len(prow), device="cuda"), nr)
    j = torch.arange(len(row), device="cuda") - (torch.cumsum(nr, 0)
                                                  - nr)[row]
    p = prow[row]
    s = sid[p]
    t = pk[p, 1] + j                        # sample in the stream
    lo, hi = st[s, 0], st[s, 1]
    keep = (t >= lo) & (t < hi)
    src = pk[p, 0] + c[row] * n[p] + j
    prod = (blocks[src] * wins[pk[p, 2] + j])[keep]
    dst = (st[s, 3] + c[row] * (hi - lo) + t - lo)[keep]
    return prod, dst


def _phase_decode(smi, keep, baseline=None, lap_baseline=None):
    """Phase 6: the decode slice on the card.  Both kernels against their
    plain versions on the card and the host C, by bit pattern: the IMDCT
    (vn_imdct_batch) at n = 64-8192 on seeded spectra read through a row
    table that reorders and spaces them and on the real spectra of 4d's
    tonal and click-train stream 0 read in place; the lap (vn_lap_add and
    the trim) on the seeded cases of tests/test_torch_lap.py at every
    blocksize (start and end trims, one batch), its -0.0 and subnormal
    case, its seeded cases with tails and the spans before the first and
    after the last center (`tail_inputs`, the chunked decode's lap) and
    the host IMDCT blocks of those two streams.  Then the main
    path, decode_ogg_fast_batch(device=True) of 4d's 16 x 60 s tonal
    streams and click trains and 4g's 5.1 streams and
    decode_ogg_fast(device=True) of one tonal stream, each bitwise equal
    to device=False and as long as its input, with both kernels' launches
    counted over these runs (the IMDCT once a blocksize, the lap once a
    call) and the host lap's calls (none); x-realtime of the tonal batch
    and of one stream, card and host-C drain, each three times with its
    spread; the split of the tonal and click-train batches into scan +
    parse and the device half: its host plan and row tables, H2D, each
    IMDCT launch, the lap, D2H and the host's rest; the IMDCT's time (CUDA graphs) at
    5,166 rows of n = 2048 and at the click train's short rows (n = 256),
    in turns with the first design (`baseline`), its bytes bound and
    share, the plain version's time and one torch.matmul against the
    dense IMDCT basis (fp32, TF32 off); the lap's time at the tonal
    batch's shape, in turns with the kernel before tails
    (`lap_baseline`), its bound, the plain version's and one index_add_
    of the windowed products.  Returns both kernels' records."""
    import numpy as np
    import torch
    from vorbis_tpu_torch.models import fastdec
    from vorbis_tpu_torch.native import imdct_batch
    from vorbis_tpu_torch.ops.imdct_cuda import imdct, imdct_plain
    from vorbis_tpu_torch.ops.lap_cuda import lap, lap_plain
    tl = _lap_cases()
    base = _ImdctBaseline(baseline) if baseline else None
    lap_base = _LapBaseline(lap_baseline) if lap_baseline else None
    max_err = {"imdct": 0.0, "lap": 0.0}
    bad = {"imdct": 0, "lap": 0}

    def tally(kind, name, got, wants):
        g = np.ascontiguousarray(got)
        mis = [int((g.view(np.uint32) != np.ascontiguousarray(w)
                    .view(np.uint32)).sum()) if w.shape == g.shape
               else g.size for w in wants]
        err = max((float(np.abs(g - w).max()) if g.size and
                   w.shape == g.shape else 0.0) for w in wants)
        max_err[kind] = max(max_err[kind], err)
        bad[kind] += sum(mis)
        print(f"[{kind}] {name}: mismatches against plain {mis[0]}, "
              f"against host C {mis[1]}")

    def check_imdct(name, flat, offs, n):
        x = torch.from_numpy(flat).cuda()
        got = imdct(x, n, rows=offs)
        spec = flat[offs[:, None] + np.arange(n // 2)]
        plain = imdct_plain(torch.from_numpy(spec).cuda(), n)
        torch.cuda.synchronize()
        tally("imdct", f"{name} n={n} rows={len(offs)}", got.cpu().numpy(),
              [plain.cpu().numpy(), imdct_batch(spec, n)])

    for k, n in enumerate((64, 128, 256, 512, 1024, 2048, 4096, 8192)):
        rng = np.random.RandomState(k)
        B = 2048
        s = rng.randn(B, n // 2) * 10.0 ** rng.uniform(-3, 3, (B, 1))
        s[rng.rand(B, n // 2) < 0.1] = 0.0
        slot = rng.permutation(B).astype(np.int64) * (n // 2 + 4)
        flat = np.zeros(int(slot.max()) + n // 2, np.float32)
        flat[slot[:, None] + np.arange(n // 2)] = s
        check_imdct("seeded, permuted row table", flat, slot, n)
    real = {}
    for leg in ("signal", "click_train"):
        dec, W, res, gp, eos = fastdec._scan_job(keep[leg][0][0])
        bs, ch, n2m = dec.vi.blocksizes, dec.vi.channels, res.shape[2]
        flat = np.ascontiguousarray(res).reshape(-1)
        for Wv in (0, 1):
            idx = np.flatnonzero(W == Wv)
            offs = ((idx[:, None] * ch + np.arange(ch)) * n2m).reshape(-1)
            if len(idx):
                check_imdct(f"4d {leg} stream 0 W={Wv}, in place", flat,
                            offs, bs[Wv])
                real[(leg, bs[Wv])] = np.ascontiguousarray(
                    res[idx][:, :, :bs[Wv] // 2].reshape(-1, bs[Wv] // 2))
        blocks = [imdct_batch(np.ascontiguousarray(
            res[p, :, :bs[w] // 2]), bs[w]) for p, w in enumerate(W)]
        real[leg] = (dec, W, gp, eos, blocks)

    def check_lap(name, cases, with_tails=False):
        if with_tails:
            flat, wins, plan, tails, wants = tl.tail_inputs(cases, seed=3)
            tails = torch.from_numpy(tails).cuda()
        else:
            (flat, wins, plan, wants), tails = tl.lap_inputs(cases), None
        args = (torch.from_numpy(flat).cuda(), torch.from_numpy(wins).cuda(),
                plan)
        got, plain = lap(*args, tails=tails), lap_plain(*args, tails)
        torch.cuda.synchronize()
        for k, want in enumerate(wants):
            tally("lap", f"{name} stream {k} ({want.shape[0]} x "
                  f"{want.shape[1]})", plan.out_view(got, k).cpu().numpy(),
                  [plan.out_view(plain, k).cpu().numpy(), want])

    check_lap("seeded, bs " + " ".join(f"{a}/{b}" for a, b in tl.CASE_PAIRS),
              [tl.lap_case(bs0, bs1, 200, (1, 2, 6)[k % 3], k,
                           trim=k % 2 == 0)
               for k, (bs0, bs1) in enumerate(tl.CASE_PAIRS)])
    check_lap("-0.0 and subnormal products", [tl.signed_zero_case()])
    check_lap("tails and edge spans, bs " + " ".join(
        f"{a}/{b}" for a, b in tl.CASE_PAIRS),
        [tl.lap_case(bs0, bs1, 200, (1, 2, 6)[k % 3], k, trim=False)
         for k, (bs0, bs1) in enumerate(tl.CASE_PAIRS)], with_tails=True)
    for leg in ("signal", "click_train"):
        check_lap(f"4d {leg} stream 0 host-C blocks", [real[leg]])
    if bad["imdct"] or bad["lap"]:
        raise RuntimeError(f"decode kernels: {bad} mismatches")

    def same(a, b):
        return a.shape == b.shape and np.array_equal(a.view(np.uint32),
                                                     b.view(np.uint32))

    # the main path: the counts go to 0 just before it and are read after;
    # every card call must launch the IMDCT once a blocksize (two here)
    # and the lap once, and never run the host lap
    host_laps = [0]
    host_lap = fastdec.FastDecoder._lap_and_trim

    def counted(*a, **kw):
        host_laps[0] += 1
        return host_lap(*a, **kw)

    tonal, tlen = keep["signal"]
    secs = sum(tlen) / 44100
    calls = []

    def card(fn, *a):
        i0, l0 = imdct.launches, lap.launches
        t0 = time.perf_counter()
        r = fn(*a, device=True)
        calls.append((imdct.launches - i0, lap.launches - l0))
        return r, time.perf_counter() - t0

    fastdec.FastDecoder._lap_and_trim = counted
    imdct.launches = 0
    lap.launches = 0
    try:
        t_card, t_host, t1_card, t1_host = [], [], [], []
        for rep in range(3):
            outs, t = card(fastdec.decode_ogg_fast_batch, tonal)
            t_card.append(t)
            t0 = time.perf_counter()
            host = fastdec.decode_ogg_fast_batch(tonal, device=False)
            t_host.append(time.perf_counter() - t0)
            (one, _), t = card(fastdec.decode_ogg_fast, tonal[0])
            t1_card.append(t)
            t0 = time.perf_counter()
            one_h, _ = fastdec.decode_ogg_fast(tonal[0], device=False)
            t1_host.append(time.perf_counter() - t0)
            if rep == 0:
                if not all(same(a, b) for (a, _), (b, _) in zip(outs, host)) \
                        or not same(one, one_h):
                    raise RuntimeError("4d tonal: device=True differs from "
                                       "device=False")
                if [a.shape[1] for a, _ in outs] != tlen:
                    raise RuntimeError("4d tonal: a decoded stream is not "
                                       "as long as its input")
        del outs, host
        t_other = {}
        for leg in ("click_train", "signal51", "click_train51"):
            oggs, lens = keep[leg]
            outs, t_other[leg] = card(fastdec.decode_ogg_fast_batch, oggs)
            host = fastdec.decode_ogg_fast_batch(oggs, device=False)
            if not all(same(a, b) for (a, _), (b, _) in zip(outs, host)):
                raise RuntimeError(f"{leg}: device=True differs from "
                                   f"device=False")
            if [a.shape[1] for a, _ in outs] != lens:
                raise RuntimeError(f"{leg}: a decoded stream is not as long "
                                   f"as its input")
            print(f"[decode] {leg} {len(oggs)} streams: device=True equal to "
                  f"device=False bit for bit, every stream as long as its "
                  f"input (card {t_other[leg]:.4f} s)")
            del outs, host
    finally:
        fastdec.FastDecoder._lap_and_trim = host_lap
    launches = {"imdct": imdct.launches, "lap": lap.launches}
    print(f"[decode] main path: {len(calls)} card calls, launches a call "
          f"(imdct, lap) {sorted(set(calls))}, in all imdct "
          f"{launches['imdct']}, lap {launches['lap']}; host lap calls "
          f"{host_laps[0]}")
    if host_laps[0]:
        raise RuntimeError("the card path ran the host lap")
    if any(c != (2, 1) for c in calls):
        raise RuntimeError(f"launches a call {calls}: the IMDCT once a "
                           f"blocksize (2) and the lap once expected")
    print(f"[decode] 4d tonal {len(tonal)} x {tlen[0] / 44100:.0f} s, "
          f"device=True: "
          f"{_spread(t_card)} = {secs / sorted(t_card)[1]:.2f}x realtime; "
          f"device=False (host-C drain, threads): {_spread(t_host)} = "
          f"{secs / sorted(t_host)[1]:.2f}x; one stream: card "
          f"{_spread(t1_card)} = {tlen[0] / 44100 / sorted(t1_card)[1]:.2f}x"
          f", host {_spread(t1_host)} = "
          f"{tlen[0] / 44100 / sorted(t1_host)[1]:.2f}x ({smi})")

    # the split of a batch: scan + parse, then the device half
    dev = torch.device("cuda")
    lap_args = None
    for leg in ("signal", "click_train"):
        oggs = keep[leg][0]
        t0 = time.perf_counter()
        jobs = [fastdec._scan_job(o) for o in oggs]
        t_scan = time.perf_counter() - t0
        prof = {}
        t0 = time.perf_counter()
        fastdec._decode_jobs(jobs, dev, profile=prof)
        wall = time.perf_counter() - t0
        dev_s = (prof["h2d_ms"] + sum(prof["imdct_ms"]) + prof["lap_ms"]
                 + prof["d2h_ms"]) / 1e3
        print(f"[decode] split of the 4d {leg} batch (s): scan + parse "
              f"{t_scan:.4f}, device half {wall:.4f} = host plan "
              f"{prof['plan']:.4f} + row tables {prof['tables']:.4f} + "
              f"device {dev_s:.4f} + host rest "
              f"{wall - prof['plan'] - prof['tables'] - dev_s:.4f}; device "
              f"(ms): H2D {prof['h2d_ms']:.3f}, imdct "
              + ", ".join(f"n={n} ({R} rows) {ms:.3f}" for (n, R), ms
                          in zip(prof["rows"].items(), prof["imdct_ms"]))
              + f", lap {prof['lap_ms']:.3f}, D2H {prof['d2h_ms']:.3f}")
        if leg == "signal":
            lap_args = prof["lap_args"]
        del prof, jobs

    # the IMDCT kernel at the main path's rows, in turns with the first
    # design: tonal stream 0's long rows and click-train stream 0's short
    # rows, packed
    rec = {}
    for leg, n in (("signal", 2048), ("click_train", 256)):
        x = torch.from_numpy(real[(leg, n)]).cuda()
        ms = _imdct_turns(x, n, base)
        bound_ms, bound_by = _roofline(*_imdct_work(n, x.shape[0]))
        rec[n] = dict(rows=x.shape[0], ms=min(ms[0], ms[-1]),
                      baseline_ms=(min(ms[1], ms[2]) if base else None),
                      bound_ms=bound_ms, bound_by=bound_by)
        print(f"[imdct] kernel at {x.shape[0]} rows of n={n} (4d {leg} "
              f"stream 0), CUDA graphs in turns (ms): "
              + (f"this {ms[0]:.5f}, first design {ms[1]:.5f}, first "
                 f"design {ms[2]:.5f}, this {ms[3]:.5f}" if base else
                 f"this {ms[0]:.5f}, this {ms[1]:.5f}")
              + f"; bound {bound_ms:.5f} ms by {bound_by}, share "
              f"{100 * bound_ms / rec[n]['ms']:.1f}%"
              + (f" (first design {100 * bound_ms / rec[n]['baseline_ms']:.1f}"
                 f"%)" if base else "") + f" ({smi})")
        if base and rec[n]["ms"] >= rec[n]["baseline_ms"]:
            raise RuntimeError(f"imdct at n={n}: not faster than the first "
                               f"design")
    x = torch.from_numpy(real[("signal", 2048)]).cuda()
    n = 2048
    plain_ms = _cuda_ms(lambda: imdct_plain(x, n), 5)
    basis = imdct_plain(torch.eye(n // 2, device=dev), n)
    lib_ms = _cuda_ms(lambda: torch.matmul(x, basis), 20)
    lib_err = float((torch.matmul(x, basis) - imdct(x, n)).abs().max())
    nbytes, ops = _imdct_work(n, x.shape[0])
    print(f"[imdct] at {x.shape[0]} rows of n={n}: plain {plain_ms:.4f} ms, "
          f"torch.matmul against the dense basis {lib_ms:.5f} ms (max abs "
          f"difference {lib_err:.3g}); bytes {nbytes} = "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms, operations {ops} = "
          f"{ops / F32_OPS_PER_S * 1e3:.5f} ms ({smi})")
    del basis, x
    imdct_rec = dict(
        launches=launches["imdct"], max_abs_err=max_err["imdct"],
        ms=rec[2048]["ms"], plain_ms=plain_ms,
        bound_ms=rec[2048]["bound_ms"], bound_by=rec[2048]["bound_by"],
        share=rec[2048]["bound_ms"] / rec[2048]["ms"], library_ms=lib_ms,
        rows=rec[2048]["rows"], n=2048,
        baseline_ms=rec[2048]["baseline_ms"], at_n256=rec[256])

    # the lap kernel at the tonal batch's shape, in turns with the kernel
    # before tails
    blocks, wins, plan, tabs = lap_args
    ms, got = _lap_turns(blocks, wins, plan, tabs, lap_base)
    lap_ms = min(ms[0], ms[-1])
    lap_base_ms = min(ms[1], ms[2]) if lap_base else None
    print(f"[lap] kernel at the 4d tonal batch, CUDA graphs in turns (ms): "
          + (f"this {ms[0]:.5f}, before tails {ms[1]:.5f}, before tails "
             f"{ms[2]:.5f}, this {ms[3]:.5f}" if lap_base else
             f"this {ms[0]:.5f}, this {ms[1]:.5f}") + f" ({smi})")
    plain_ms = _cuda_ms(lambda: lap_plain(blocks, wins, plan), 1)
    prod, dst = _index_add_lap(blocks, wins, plan)
    acc = torch.zeros(plan.total, device=dev)
    lib_ms = _cuda_ms(lambda: acc.index_add_(0, dst, prod), 5)
    acc.zero_().index_add_(0, dst, prod)
    lib_err = float((acc - got).abs().max())
    nbytes, ops = _lap_work(plan)
    bound_ms, bound_by = _roofline(nbytes, ops)
    print(f"[lap] kernel at the 4d tonal batch ({len(plan.pk)} packets, "
          f"{plan.total} output floats): {lap_ms:.5f} ms (CUDA graphs), "
          f"plain {plain_ms:.2f} ms, index_add_ of the windowed products "
          f"{lib_ms:.5f} ms (max abs difference {lib_err:.3g}); bytes "
          f"{nbytes} = {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms, operations "
          f"{ops}; bound {bound_ms:.5f} ms by {bound_by}, share "
          f"{100 * bound_ms / lap_ms:.1f}% ({smi})")
    lap_rec = dict(
        launches=launches["lap"], max_abs_err=max_err["lap"], ms=lap_ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        share=bound_ms / lap_ms, library_ms=lib_ms, packets=len(plan.pk),
        baseline_ms=lap_base_ms)
    del blocks, wins, plan, tabs, lap_args, prod, dst, acc, got
    return imdct_rec, lap_rec


def _phase_vorbisfile(smi, keep):
    """Phase 6b: the ov_* layer (vorbis_tpu_torch.vorbisfile) on the card,
    held bit for bit to device=False (the JAX package's host path) on
    4d's tonal stream 0 and click-train stream 0 (60 s each) and on a
    chain of the tonal stream 0 and 4g's 5.1 stream 1 (stereo 44.1 kHz,
    then six channels at 48 kHz; stream 0's serial is the tonal one's):
    reads of 4096, 313, 20000 and 64 samples to the end, each as long as
    pcm_total; 8 seeded pcm_seeks, each with its tell and one
    read_float(4096); halfrate reads to the end; read_all_float (the chain
    mixes channel counts, which the JAX package's drain refuses with a
    ValueError: both paths must raise it, and the 5.1 stream drains
    alone); a crosslap of the tonal stream into the click train; the
    click train with a corrupt page read to the end (equal hole counts),
    and fed to FastStreamDecoder with a damaged packet held back between
    a long block and a short one (tests/test_torch_cuda.py
    `damaged_holdback`: the next chunk's lap starts from a tail that
    reaches past its first center).  Every card pass counts its launches
    from 0: each staged chunk must launch the IMDCT once a blocksize
    present and the lap once (tests/test_torch_cuda.py `_ChunkLaunches`),
    a whole-link drain two IMDCT launches and one lap, and no pass may
    run the host C's chunk, lap or IMDCT or either kernel's plain
    version.  Readings (three timed runs, median and
    spread): read_float(4096) x-realtime card against device=False, the
    latency of pcm_seek plus the first read_float(4096) (median of the 8
    positions), halfrate x-realtime; then each kernel's time at the
    shapes of one 256-packet chunk, full rate and halfrate, from CUDA
    graphs and as 50 calls from Python (a chunk's launches are that
    path's host cost), with its bound.  Returns
    (IMDCT launches, lap launches, record)."""
    import numpy as np
    import pytest
    from vorbis_tpu_torch import native
    from vorbis_tpu_torch.codec import nativeparse
    from vorbis_tpu_torch.models import fastdec
    from vorbis_tpu_torch.ops import imdct_cuda, lap_cuda
    from vorbis_tpu_torch.ops.imdct_cuda import imdct
    from vorbis_tpu_torch.ops.lap_cuda import lap
    from vorbis_tpu_torch.vorbisfile import OggVorbisFile
    tc = _test_module("test_torch_cuda")

    tonal, click = keep["signal"][0][0], keep["click_train"][0][0]
    s51 = keep["signal51"][0][1]
    streams = {"tonal": tonal, "click_train": click, "chained": tonal + s51}
    FSD = fastdec.FastStreamDecoder

    # host-path and plain-version calls, counted while a card pass runs
    host = {"chunk": 0, "halfrate chunk": 0, "lap": 0, "imdct": 0,
            "plain lap": 0, "plain imdct": 0}
    card_on = [False]
    saved = []

    def counting(owner, name, key):
        raw = vars(owner)[name]           # a staticmethod stays one
        real = getattr(owner, name)
        saved.append((owner, name, raw))

        def wrapper(*a, **kw):
            if card_on[0]:
                host[key] += 1
            return real(*a, **kw)
        setattr(owner, name, staticmethod(wrapper)
                if isinstance(raw, staticmethod) else wrapper)

    counting(nativeparse, "decode_stream", "chunk")
    counting(FSD, "_synth_staged", "halfrate chunk")
    counting(fastdec.FastDecoder, "_native_lap", "lap")
    counting(native, "imdct_batch", "imdct")
    counting(fastdec, "imdct_batch", "imdct")
    counting(lap_cuda, "lap_plain", "plain lap")
    counting(imdct_cuda, "imdct_plain", "plain imdct")
    mp = pytest.MonkeyPatch()
    chunks = tc._ChunkLaunches(mp)     # (imdct launches, blocksizes, laps)
    launches = [0, 0]
    drains = []

    def card(fn):
        """One card pass with the counts from 0, read after it."""
        imdct.launches = lap.launches = 0
        card_on[0] = True
        try:
            r = fn()
        finally:
            card_on[0] = False
        launches[0] += imdct.launches
        launches[1] += lap.launches
        return r

    def run(d):
        """The pass runner of device d: `card` for the card."""
        return card if d == "cuda" else (lambda f: f())

    def check(what, a, b):
        if not tc._bits_equal(a, b):
            raise RuntimeError(f"6b {what}: the card differs from "
                               f"device=False")

    rng = np.random.RandomState(6)
    rec = {}
    try:
        for name, data in streams.items():
            ref = OggVorbisFile(data, device=False)
            total = ref.pcm_total()
            for n in (4096, 313, 20000, 64):
                got = card(lambda: tc._reads(OggVorbisFile(data), [n]))
                check(f"{name} reads of {n}", got,
                      tc._reads(OggVorbisFile(data, device=False), [n]))
                if sum(c.shape[1] for c in got) != total:
                    raise RuntimeError(f"6b {name}: reads of {n} are not "
                                       f"pcm_total ({total}) long")
            pos = np.sort(rng.randint(0, total, 8))
            vfs = {d: OggVorbisFile(data, device=d) for d in ("cuda", False)}
            lat = {"cuda": [], False: []}
            heads = {}
            for d, vf in vfs.items():
                heads[d] = []
                for p in map(int, pos):
                    t0 = time.perf_counter()
                    c = run(d)(lambda: (vf.pcm_seek(p), vf.read_float(4096)))
                    lat[d].append(time.perf_counter() - t0)
                    if vf.pcm_tell() != p + c[1].shape[1]:
                        raise RuntimeError(f"6b {name}: tell after a seek "
                                           f"to {p}")
                    heads[d].append(c[1])
            check(f"{name} seeks", heads["cuda"], heads[False])

            def halfrate(d):
                vf = OggVorbisFile(data, device=d)
                vf.halfrate(True)
                out = tc._reads(vf, [4096])
                if vf.pcm_tell() != total:
                    raise RuntimeError(f"6b {name}: halfrate tell "
                                       f"{vf.pcm_tell()} != {total}")
                return out
            check(f"{name} halfrate", card(lambda: halfrate("cuda")),
                  halfrate(False))
            if name == "chained":
                errs = []
                for d in ("cuda", False):
                    try:
                        run(d)(lambda: OggVorbisFile(
                            data, device=d).read_all_float())
                        errs.append(None)
                    except ValueError as e:
                        errs.append(str(e))
                if errs[0] is None or errs[0] != errs[1]:
                    raise RuntimeError(f"6b chained read_all_float: {errs}")
                drain_of = s51
            else:
                drain_of = data
            i0 = launches[:]
            full = card(lambda: OggVorbisFile(drain_of).read_all_float())
            drains.append((launches[0] - i0[0], launches[1] - i0[1]))
            want = OggVorbisFile(drain_of, device=False).read_all_float()
            check(f"{name} read_all_float", [full], [want])
            # the readings: three timed runs of each, card and host
            secs = sum(lk.pcm_total / lk.vi.rate for lk in ref.links)
            t_seq = {"cuda": [], False: []}
            t_half = {"cuda": [], False: []}
            for _ in range(3):
                for d in ("cuda", False):
                    t0 = time.perf_counter()
                    run(d)(lambda: tc._reads(OggVorbisFile(data, device=d),
                                             [4096]))
                    t_seq[d].append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    run(d)(lambda: halfrate(d))
                    t_half[d].append(time.perf_counter() - t0)
            rec[name] = {
                "seconds": secs,
                "read4096_xrt": {str(d): secs / sorted(t)[1]
                                 for d, t in t_seq.items()},
                "seek_read_ms": {str(d): 1e3 * float(np.median(t))
                                 for d, t in lat.items()},
                "halfrate_xrt": {str(d): secs / sorted(t)[1]
                                 for d, t in t_half.items()}}
            print(f"[ov] {name} ({secs:.1f} s, pcm_total {total}): reads of "
                  f"4096/313/20000/64, 8 seeks {list(map(int, pos))}, "
                  f"halfrate and read_all_float bit for bit equal to "
                  f"device=False; read_float(4096) card {_spread(t_seq['cuda'])}"
                  f" = {rec[name]['read4096_xrt']['cuda']:.2f}x realtime, "
                  f"host {_spread(t_seq[False])} = "
                  f"{rec[name]['read4096_xrt']['False']:.2f}x; pcm_seek + "
                  f"read_float(4096) median card "
                  f"{rec[name]['seek_read_ms']['cuda']:.3f} ms (min "
                  f"{1e3 * min(lat['cuda']):.3f}, max "
                  f"{1e3 * max(lat['cuda']):.3f}), host "
                  f"{rec[name]['seek_read_ms']['False']:.3f} ms; halfrate "
                  f"card {_spread(t_half['cuda'])} = "
                  f"{rec[name]['halfrate_xrt']['cuda']:.2f}x, host "
                  f"{_spread(t_half[False])} = "
                  f"{rec[name]['halfrate_xrt']['False']:.2f}x ({smi})")
        # crosslap: the tonal stream's lap tail into the click train
        spliced = []
        for d in ("cuda", False):
            def splice():
                a = OggVorbisFile(tonal, device=d)
                b = OggVorbisFile(click, device=d)
                a.read_all_float()
                a.crosslap(b)
                return [b.read_float(1 << 14) for _ in range(3)]
            spliced.append(run(d)(splice))
        check("crosslap", *spliced)
        # a corrupt page (holes), and a damaged packet held back between
        # a long and a short block (a tail past the next center)
        bad = bytearray(click)
        bad[len(bad) // 2] ^= 0xFF
        holes = []
        for d in ("cuda", False):
            vf = OggVorbisFile(bytes(bad), device=d)
            got = run(d)(lambda: tc._reads(vf, [4096]))
            holes.append((got, vf.hole_count))
        check("corrupt page", holes[0][0], holes[1][0])
        if holes[0][1] != holes[1][1] or holes[0][1] < 1:
            raise RuntimeError(f"6b corrupt page: holes {holes[0][1]}, "
                               f"{holes[1][1]}")
        dmg = card(lambda: tc.damaged_holdback(click, "cuda"))
        dmg_h = tc.damaged_holdback(click, False)
        check("damaged held-back packet", dmg[0], dmg_h[0])
        if dmg[1] != dmg_h[1] or dmg[1] != 1:
            raise RuntimeError(f"6b damaged held-back packet: holes "
                               f"{dmg[1]}, {dmg_h[1]}")
    finally:
        mp.undo()
        for owner, name, real in saved:
            setattr(owner, name, real)
    bad = chunks.bad()
    print(f"[ov] main path: {len(chunks.rows)} staged chunks, launches a "
          f"chunk (imdct, blocksizes, lap) {sorted(set(chunks.rows))}; "
          f"whole-link drains (imdct, lap) {drains}; in all imdct "
          f"{launches[0]}, lap {launches[1]}; host-path and plain calls "
          f"{host}; corrupt page {holes[0][1]} holes; damaged held-back "
          f"packet: bit for bit equal to device=False")
    if bad or any(host.values()) or any(d != (2, 1) for d in drains):
        raise RuntimeError(f"6b launches: chunks off {bad[:5]}, drains "
                           f"{drains}, host calls {host}")

    # each kernel at the shapes of one 256-packet chunk of the tonal
    # stream, full rate and halfrate (the calls of the chunk, recorded)
    seen = {}
    real_imdct, real_lap = fastdec.imdct, fastdec.lap

    def rec_imdct(spec, n, **kw):
        seen.setdefault(("imdct", seen.get("hs"), n), (spec, n, kw))
        return real_imdct(spec, n, **kw)

    def rec_lap(blocks, wins, plan, tables=None, tails=None):
        seen.setdefault(("lap", seen.get("hs")),
                        (blocks, wins, plan, tables, tails))
        return real_lap(blocks, wins, plan, tables=tables, tails=tails)

    from vorbis_tpu_torch.bitstream.oggfile import OggStreamReader
    pkts = list(OggStreamReader(tonal).packets())
    dec = fastdec._decoder_for(tuple(p for p, _, _ in pkts[:3]))
    fastdec.imdct, fastdec.lap = rec_imdct, rec_lap
    by_hs = {}
    try:
        for hs in (0, 1):
            d = FSD(dec, hs=hs)
            d.feed(pkts[3:3 + 257])            # the first chunk
            seen.clear()
            seen["hs"] = hs
            d.feed(pkts[260:516])              # a warm 256-packet chunk
            by_hs[hs] = {k: v for k, v in seen.items() if k != "hs"}
    finally:
        fastdec.imdct, fastdec.lap = real_imdct, real_lap
    i_saved, l_saved = imdct.launches, lap.launches
    kern = {}
    for hs, calls in by_hs.items():
        for key, args in calls.items():
            if key[0] == "imdct":
                spec, n, kw = args
                fn = (lambda: imdct(spec, n, **kw))
                bound_ms, by = _roofline(*_imdct_work(n, len(kw["rows"])))
                name, shape = f"imdct hs={hs} n={n}", dict(rows=len(kw["rows"]))
            else:
                blocks, wins, plan, tables, tails = args
                fn = (lambda: lap(blocks, wins, plan, tables=tables,
                                  tails=tails))
                bound_ms, by = _roofline(*_lap_work(plan))
                name, shape = f"lap hs={hs}", dict(packets=len(plan.pk),
                                                   samples=plan.total)
            kern[name] = dict(**shape, ms=_graph_ms(fn, reps=20),
                              call_ms=_cuda_ms(fn, 50), bound_ms=bound_ms,
                              bound_by=by)
    imdct.launches, lap.launches = i_saved, l_saved
    print("[ov] kernels at one 256-packet chunk of the tonal stream (ms: "
          "CUDA graphs; call_ms: CUDA events over 50 calls from Python, "
          "the wrapper's host cost included; warm L2): " + "; ".join(
              f"{k}: " + ", ".join(f"{a} {v:.5f}" if isinstance(v, float)
                                   else f"{a} {v}" for a, v in r.items())
              for k, r in kern.items()) + f" ({smi})")
    rec["chunk_kernels"] = kern
    rec["chunks"] = len(chunks.rows)
    return launches[0], launches[1], rec


def _median_s(fn, reps=3):
    """Median and spread of `reps` timed calls of fn (each synchronised):
    (median s, _spread text)."""
    import torch
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], _spread(ts)


def _phase_pipeline(smi):
    """Phase 7: the sharded encode step, the roundtrip pipeline and LBG
    training on the card.  7a: the first 2,048 frames of
    TorchCodecPipeline.frame of _signal(48, 44100, 0) / 32768 as (F, ch,
    n) through sharded_encode_step on a mesh of [cuda:0] * 4 (and of
    every card where there are several), bitwise against
    make_framed_step(2048) on one device, every nbits > 0 and <= 8 * wb
    (no packet cut at the static budget); the floor kernel's launches
    (one a shard); frames/s sharded and single (median of 3).  7b:
    frames (4, 2, 256, 2048) of _signal seeds 0-3 through the roundtrip
    on a 2 x 4 mesh of cuda:0, equal in value to the unsharded step, err
    within 1e-6 relative; the IMDCT and lap launches (two each a shard)
    and no plain version on the card pass; DeviceSynthesis on the card
    equal in value to imdct_plain + lap_plain on the same spectra on the
    card; encode_quantize_step of stream 0 (512 rows) on the card and on
    the CPU, >= 90% of qpost rows equal; the roundtrip's time.  7c: LBG,
    65,536 clustered 4-dim points, 256 entries, iters = 40, on the card
    and on numpy: final MSE within 25%, both times.  Returns the
    record (launches of each kernel, readings)."""
    import numpy as np
    import pytest
    import torch
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    from vorbis_tpu_torch.models.pipeline import TorchCodecPipeline
    from vorbis_tpu_torch.ops import imdct_cuda, lap_cuda
    from vorbis_tpu_torch.ops.encdevice import DeviceFastEncode
    from vorbis_tpu_torch.ops.imdct_cuda import imdct, imdct_plain
    from vorbis_tpu_torch.ops.lap_cuda import lap, lap_plain
    from vorbis_tpu_torch.parallel import (make_codec_mesh,
                                           sharded_encode_step,
                                           sharded_roundtrip_step)
    from vorbis_tpu_torch.vq import lbg_train
    cuda0 = torch.device("cuda", 0)
    rec = {"card": smi}

    # 7a. the sharded encode step
    fe = FastEncoder(2, 44100, 0.5)
    pipe = TorchCodecPipeline(2, 44100, 0.5)
    F = 2048
    fr = pipe.frame(_signal(48, 44100, 0).astype(np.float32) / 32768.0)
    frames = torch.from_numpy(np.ascontiguousarray(
        fr[:, :F].transpose(1, 0, 2))).to(cuda0)
    dev = DeviceFastEncode(fe, chunk_packets=F)
    wb = dev.plan.wb
    single = dev.make_framed_step(F)
    pk1, nb1 = single(frames)
    if not (bool((nb1 > 0).all()) and int(nb1.max()) <= 8 * wb):
        raise RuntimeError(f"7a: nbits {int(nb1.min())}..{int(nb1.max())} "
                           f"outside 1..{8 * wb} (wb = {wb})")
    meshes = {"4 x cuda:0": make_codec_mesh(devices=[cuda0] * 4)}
    if torch.cuda.device_count() > 1:
        meshes[f"{torch.cuda.device_count()} cards"] = make_codec_mesh()
    single_s, single_txt = _median_s(lambda: single(frames))
    rec["encode"] = {"F": F, "wb": wb, "bits": int(nb1.sum()),
                     "single_frames_per_s": F / single_s}
    for name, mesh in meshes.items():
        step = sharded_encode_step(dev, mesh, F)
        torch.cuda.synchronize()
        fe.floor.launches = 0                   # the main path's run
        pk, nb = step(frames)
        torch.cuda.synchronize()
        fl = fe.floor.launches
        same = torch.equal(pk, pk1) and torch.equal(nb, nb1)
        rows = int((pk != pk1).any(1).sum())
        print(f"[7a] sharded encode on {name} ({mesh.shape}): {F} frames, "
              f"packets bitwise equal to one device: {same} ({rows} rows "
              f"differ), nbits {int(nb.min())}..{int(nb.max())} <= "
              f"{8 * wb}, floor launches {fl}")
        if not same:
            raise RuntimeError(f"7a: sharded packets differ on {name}")
        want_fl = sum(d == cuda0 for d in mesh.flat)
        if fl != want_fl:
            raise RuntimeError(f"7a: {fl} floor launches, {want_fl} "
                               f"expected (one a shard on cuda:0)")
        rec["encode"].setdefault("floor_launches", fl)
        sh_s, sh_txt = _median_s(lambda: step(frames))
        rec["encode"][f"sharded_frames_per_s {name}"] = F / sh_s
        print(f"[7a] {name}: {F / sh_s:.1f} frames/s sharded "
              f"({sh_txt}) against {F / single_s:.1f} frames/s on one "
              f"device ({single_txt}); one card, so no speed-up is "
              f"claimed  [{smi}]")

    # the floor kernel against its plain version at one shard's rows
    _, lm, mk = fe.analysis.full_mask(frames[:F // 4].reshape(-1, fe.n))
    quant, above, prefix, _ = fe.floor.prepare(lm, mk)
    rec["floor_err"] = _check(fe.floor, f"7a shard ({F // 4} frames, 2 ch)",
                              quant, above, prefix)

    # 7b. the roundtrip
    S, FR = 4, 256
    frames4 = np.stack([pipe.frame(_signal(6, 44100, s).astype(np.float32)
                                   / 32768.0)[:, :FR] for s in range(S)])
    x = torch.from_numpy(frames4).to(cuda0)
    mesh = make_codec_mesh(devices=[cuda0] * 8)
    rstep = sharded_roundtrip_step(pipe, mesh)
    plain_calls = [0]
    mp = pytest.MonkeyPatch()

    def counted(module, name):
        real = getattr(module, name)

        def wrapper(*a, **kw):
            plain_calls[0] += 1
            return real(*a, **kw)
        mp.setattr(module, name, wrapper)

    counted(imdct_cuda, "imdct_plain")
    counted(lap_cuda, "lap_plain")
    try:
        torch.cuda.synchronize()
        imdct.launches = lap.launches = 0       # the main path's run
        pcm, err = rstep(x)
        torch.cuda.synchronize()
        li, ll = imdct.launches, lap.launches
        pcm1, err1 = pipe.roundtrip_step(x)
        torch.cuda.synchronize()
        li1, ll1 = imdct.launches - li, lap.launches - ll
    finally:
        mp.undo()
    equal = torch.equal(pcm, pcm1)
    rel = abs(float(err) - float(err1)) / float(err1)
    print(f"[7b] roundtrip {tuple(x.shape)} on {mesh.shape} of cuda:0: pcm "
          f"{tuple(pcm.shape)} equal in value to the unsharded step: "
          f"{equal} (max |diff| {float((pcm - pcm1).abs().max()):.3g}), "
          f"err {float(err):.9g} against {float(err1):.9g} (rel "
          f"{rel:.3g}); launches sharded IMDCT {li}, lap {ll}; unsharded "
          f"IMDCT {li1}, lap {ll1}; plain calls {plain_calls[0]}")
    if not equal or rel > 1e-6 or not np.isfinite(float(err)):
        raise RuntimeError("7b: the sharded roundtrip differs")
    if (li, ll) != (2 * mesh.size, 2 * mesh.size) or (li1, ll1) != (2, 2) \
            or plain_calls[0]:
        raise RuntimeError("7b: launches or plain calls off")
    # DeviceSynthesis on the card against the plain versions on the card
    md, logmdct, mask = pipe.analysis.full_mask(x)
    quant = torch.where(logmdct >= mask, md, 0.0)
    syn = pipe.synthesis
    got = syn(quant)
    n, n2 = pipe.n, pipe.n // 2
    plan = syn._plan(S * 2, FR, False, False)[0]
    want = lap_plain(imdct_plain(quant.reshape(-1, n2), n).reshape(-1),
                     syn.window, plan).reshape(got.shape)
    same_syn = torch.equal(got, want)
    print(f"[7b] DeviceSynthesis on the card equal in value to imdct_plain "
          f"+ lap_plain on the card: {same_syn} (max |diff| "
          f"{float((got - want).abs().max()):.3g}; bits differ at "
          f"{int((got.view(torch.int32) != want.view(torch.int32)).sum())} "
          f"samples)")
    if not same_syn:
        raise RuntimeError("7b: DeviceSynthesis differs from its plain "
                           "versions")
    # both kernels at one synthesis's shapes (2,048 rows, 8 streams of
    # 256 blocks), warm L2: ms from CUDA graphs, call_ms from CUDA events
    # over 50 calls from Python (the wrapper's host cost included)
    spec = quant.reshape(-1, n2)
    blocks = imdct(spec, n).reshape(-1)
    tables = syn._plan(S * 2, FR, False, False)[1]
    kern = {}
    for name, fn, plain_fn, work in (
            ("imdct", lambda: imdct(spec, n),
             lambda: imdct_plain(spec, n), _imdct_work(n, spec.shape[0])),
            ("lap", lambda: lap(blocks, syn.window, plan, tables=tables),
             lambda: lap_plain(blocks, syn.window, plan), _lap_work(plan))):
        ms, call_ms = _graph_ms(fn), _cuda_ms(fn, 50)
        plain_ms = _cuda_ms(plain_fn, 3)
        bound_ms, by = _roofline(*work)
        kern[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": by,
                      "share": bound_ms / ms}
        print(f"[7b] {name} kernel at the roundtrip's shapes: {ms:.5f} ms "
              f"(graphs), {call_ms:.5f} ms as calls, bound {bound_ms:.5f} "
              f"ms by {by} ({bound_ms / ms:.1%}), plain {plain_ms:.3f} ms  "
              f"[{smi}]")
    cpu_pcm, cpu_err = TorchCodecPipeline(2, 44100, 0.5, device="cpu") \
        .roundtrip_step(frames4)
    print(f"[7b] card against the CPU: max |pcm diff| "
          f"{float((pcm.cpu() - cpu_pcm).abs().max()):.3g} of "
          f"{float(cpu_pcm.abs().max()):.3g}, err {float(err):.9g} against "
          f"{float(cpu_err):.9g}")
    sh_s, sh_txt = _median_s(lambda: rstep(x))
    un_s, un_txt = _median_s(lambda: pipe.roundtrip_step(x))
    print(f"[7b] roundtrip of {S * 2 * FR} frames: sharded {sh_txt}, "
          f"unsharded {un_txt}  [{smi}]")
    # encode_quantize_step, card against CPU
    pipe_cpu = TorchCodecPipeline(2, 44100, 0.5, device="cpu")
    rows = frames4[0].reshape(-1, n)
    fe_launch0 = pipe.floor_fit.launches
    qc, rc = pipe.encode_quantize_step(torch.from_numpy(rows).to(cuda0))
    torch.cuda.synchronize()
    fq = pipe.floor_fit.launches - fe_launch0
    qh, rh = pipe_cpu.encode_quantize_step(rows)
    q_share = float((qc.cpu() == qh).all(1).float().mean())
    r_share = float((rc.cpu() == rh).all(1).float().mean())
    print(f"[7b] encode_quantize_step of {len(rows)} rows, card against the "
          f"CPU: qpost rows equal {q_share:.4f}, residue rows equal "
          f"{r_share:.4f}; floor launches {fq}")
    if q_share < 0.9 or fq != 1:
        raise RuntimeError("7b: encode_quantize_step card vs CPU")
    rec["roundtrip"] = {"frames": S * 2 * FR, "sharded_s": sh_s,
                        "unsharded_s": un_s, "imdct_launches": li,
                        "lap_launches": ll, "qpost_rows_equal": q_share}

    # 7c. LBG
    rng = np.random.RandomState(0)
    centers = rng.randn(256, 4).astype(np.float32) * 3
    pts = (centers[rng.randint(0, 256, 65536)]
           + rng.randn(65536, 4).astype(np.float32) * 0.25) \
        .astype(np.float32)
    lbg_train(pts[:4096], 16, iters=8)           # warm: first cuBLAS call
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cc, ac, hc = lbg_train(pts, 256, iters=40)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cn, an, hn = lbg_train(pts, 256, iters=40, use_torch=False)
    t_np = time.perf_counter() - t0
    gap = abs(hc[-1] - hn[-1]) / hn[-1]
    print(f"[7c] LBG 65536 x 4 -> 256 entries, iters 40: card {t_card:.4f} s "
          f"({len(hc)} steps, final MSE {hc[-1]:.6g}), numpy {t_np:.4f} s "
          f"({len(hn)} steps, {hn[-1]:.6g}); gap {gap:.4f} (bound 0.25)  "
          f"[{smi}]")
    if gap >= 0.25:
        raise RuntimeError("7c: LBG on the card off the numpy path")
    rec["lbg"] = {"card_s": t_card, "numpy_s": t_np, "steps": len(hc),
                  "mse_gap": gap}
    rec["floor"] = rec["encode"]["floor_launches"] + fq
    rec["imdct"], rec["lap"] = li + li1, ll + ll1
    rec["kernels"] = kern
    return rec


def _gate_signal(kind, rate, secs, ch):
    """A phase 8 input: 1 s of the mix signal, quiet-after-loud, or (ch =
    6) the 5.1 gate's mix signal, float32 (ch, n)."""
    if kind == "qal":
        return _quiet_after_loud(rate)
    return _make_test_signal(rate=rate, seconds=secs, ch=ch)


def _golden_job(kind, q, rate, secs, ch):
    """Runs in a spawned worker: the port's golden stream
    (vorbis_tpu_torch.encode_vbr_stream, host numpy) of one phase 8
    input, and its encode time (s)."""
    import torch
    torch.set_num_threads(1)
    from vorbis_tpu_torch import encode_vbr_stream
    pcm = _gate_signal(kind, rate, secs, ch)
    t0 = time.perf_counter()
    ogg = encode_vbr_stream(pcm, rate, q)
    return ogg, time.perf_counter() - t0


def _digest_job(directory):
    """Runs in a spawned worker: _golden_digests of the port's golden
    encoder, and its time (s)."""
    import torch
    torch.set_num_threads(1)
    from vorbis_tpu_torch import encode_vbr_stream
    from vorbis_tpu_torch.utils import analysis_dump
    t0 = time.perf_counter()
    out = _golden_digests(encode_vbr_stream, analysis_dump, directory)
    return out, time.perf_counter() - t0


def _gate_one(tag, pcm, f, g, rms_ratio, size, snr_db=2.0):
    """tests/test_quality_gates.py _gate's three tests on the card: both
    streams decoded by decode_ogg_fast (the IMDCT and lap kernels), then
    the RMS error below rms_ratio times the golden stream's, the
    segmental SNR within snr_db of it (None: not tested, as the 5.1
    gate) and the size ratio inside `size`.  Raises on a failure;
    returns the measured ratios."""
    import numpy as np
    df = _decode(f)[0]
    dg = _decode(g)[0]
    for name, d in (("fast", df), ("golden", dg)):
        if d.shape[0] != pcm.shape[0] or not np.isfinite(d).all():
            raise RuntimeError(f"phase 8 {tag}: the {name} stream decodes "
                               f"to {d.shape}, or not finite")
    m = min(df.shape[1], dg.shape[1], pcm.shape[1])
    ef = float(np.sqrt(np.mean((df[:, :m] - pcm[:, :m]) ** 2)))
    eg = float(np.sqrt(np.mean((dg[:, :m] - pcm[:, :m]) ** 2)))
    r = dict(rms_ratio=ef / eg, snr_delta=_seg_snr(pcm, df)
             - _seg_snr(pcm, dg), size_ratio=len(f) / len(g))
    bad = []
    if not ef < rms_ratio * eg:
        bad.append(f"RMS error {ef:.6g} not below {rms_ratio} x the "
                   f"golden stream's {eg:.6g}")
    if snr_db is not None and not r["snr_delta"] > -snr_db:
        bad.append(f"segmental SNR {r['snr_delta']:+.3f} dB from the "
                   f"golden stream's (bound -{snr_db})")
    if not size[0] <= r["size_ratio"] <= size[1]:
        bad.append(f"size {len(f)} / {len(g)} outside {size}")
    if bad:
        raise RuntimeError(f"phase 8 gate {tag}: " + "; ".join(bad))
    return r


def _phase_golden(smi):
    """Phase 8: the port's FastEncoder on the card held to the port's
    golden encoder by the corpus gate of tests/test_quality_gates.py
    (GATES on the mix signal and quiet-after-loud, and the 5.1 relative
    gate GATE_51).  The golden streams are host numpy: they run in a pool
    of spawned workers while the main process encodes on the card.
    Both streams decode on the card.  Returns the (floor, M3) launches
    of the card encodes and the (IMDCT, lap) launches of the decodes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import torch
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    from vorbis_tpu_torch.ops.imdct_cuda import imdct
    from vorbis_tpu_torch.ops.lap_cuda import lap
    t_phase = time.perf_counter()
    q51, rate51, secs51, ratio51, size51 = GATE_51
    cfgs = [(q, rate, 1.0, 2, ratio, (0.65, 1.2), ("mix", "qal"))
            for q, rate, ratio in GATES]
    cfgs.append((q51, rate51, secs51, 6, ratio51, size51, ("mix",)))
    jobs = [(kind, q, rate, secs, ch) for q, rate, secs, ch, _, _, kinds
            in cfgs for kind in kinds]
    jobs.sort(key=lambda j: -j[4] * j[2] * j[3])   # the longest first
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
             else os.cpu_count() or 2)
    workers = max(1, min(len(jobs) + 1, cores - 1))
    dump_dir = os.path.join(HERE, "build", "vorbis_tpu_torch", "golden_dump")
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as ex:
        futs = {j: ex.submit(_golden_job, *j) for j in jobs}
        digest = ex.submit(_digest_job, dump_dir)
        # the card encodes, while the workers run the golden encoder
        fast, launches = {}, [0, 0]
        t0 = time.perf_counter()
        for q, rate, secs, ch, _, _, kinds in cfgs:
            fe = FastEncoder(ch, rate, q)
            if fe.device.type != "cuda":
                raise RuntimeError(f"FastEncoder defaults to {fe.device}")
            for k in _kernels_of(fe):
                k.launches = 0                  # this path's run
            for kind in kinds:
                fast[kind, q, rate, secs, ch] = fe.encode(
                    _gate_signal(kind, rate, secs, ch))
            torch.cuda.synchronize()
            launches[0] += _launches(fe)
            if fe._short_ctx is not None:
                launches[1] += fe._short_ctx.m3_scan.launches
        t_card = time.perf_counter() - t0
        golden = {j: f.result() for j, f in futs.items()}
        (sha, stages), t_digest = digest.result()
    t_golden = time.perf_counter() - t0
    if min(launches) < 1:
        raise RuntimeError(f"phase 8's card encodes launched the floor "
                           f"kernel {launches[0]} times and M3 "
                           f"{launches[1]} times")
    first = _first_stage_differing(stages)
    print(f"[golden] digest clip (0.3 s stereo q0.4, comments): port "
          f"{sha}, JAX package's pinned {GOLDEN_SHA256}: "
          f"{'equal' if sha == GOLDEN_SHA256 else 'DIFFERENT'}; of "
          f"{len(stages)} analysis stages "
          + ("all equal" if first is None else f"the first differing is "
             f"{first}") + " (not gated)")
    imdct.launches = lap.launches = 0            # the decodes' run
    rows = []
    for q, rate, secs, ch, ratio, size, kinds in cfgs:
        for kind in kinds:
            key = (kind, q, rate, secs, ch)
            g, t_enc = golden[key]
            tag = (f"5.1 q{q}@{rate}" if ch == 6 else
                   f"{kind} q{q}@{rate}")
            r = _gate_one(tag, _gate_signal(kind, rate, secs, ch),
                          fast[key], g, ratio, size,
                          snr_db=None if ch == 6 else 2.0)
            rows.append((tag, r, ratio, t_enc, secs))
            print(f"[golden] {tag}: rms ratio {r['rms_ratio']:.4f} (bound "
                  f"{ratio}), SNR delta "
                  + ("not gated" if ch == 6 else f"{r['snr_delta']:+.3f} dB")
                  + f", size ratio {r['size_ratio']:.4f} (bounds {size}); "
                  f"golden encode {t_enc:.2f} s = "
                  f"{secs / t_enc:.3f}x realtime on one host core")
    dec = (imdct.launches, lap.launches)
    if min(dec) < 1:
        raise RuntimeError(f"phase 8's decodes launched the IMDCT "
                           f"{dec[0]} times and the lap {dec[1]} times")
    print(f"[golden] {len(rows)} gates passed; card encodes "
          f"{t_card:.2f} s (floor kernel {launches[0]} launches, M3 "
          f"{launches[1]}), golden streams in {workers} workers "
          f"{t_golden:.2f} s (digest {t_digest:.2f} s); decodes on the card "
          f"IMDCT {dec[0]} launches, lap {dec[1]}; phase 8 "
          f"{time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches, dec


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m3-baseline", metavar="SOURCE",
                    help="the first design's csrc/m3_scan.cu (git show 185cdeb:"
                         "vorbis_tpu_torch/csrc/m3_scan.cu, checked by its "
                         "hash) to time in turns with this one in phase 3b")
    ap.add_argument("--imdct-baseline", metavar="SOURCE",
                    help="the first design's csrc/imdct.cu (git show 5b586f3:"
                         "vorbis_tpu_torch/csrc/imdct.cu, checked by its "
                         "hash) to time in turns with this one in phase 6")
    ap.add_argument("--lap-baseline", metavar="SOURCE",
                    help="the lap kernel before tails (git show e1480c3:"
                         "vorbis_tpu_torch/csrc/lap.cu, checked by its hash) "
                         "to time in turns with this one in phase 6")
    args = ap.parse_args()
    t_start = time.perf_counter()
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
    from vorbis_tpu_torch.ops import floor_cuda, imdct_cuda, lap_cuda, m3_cuda
    t0 = time.perf_counter()
    jobs = {"floor_fit.cu": floor_cuda.build,
            "m3_scan.cu": m3_cuda.build,
            "imdct.cu": imdct_cuda.build,
            "lap.cu": lap_cuda.build,
            "host_ogg.c": native.build_host,
            "host_decode.c": native.build_decode}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(f) for k, f in jobs.items()}
        built = {k: f.result() for k, f in futs.items()}
    floor_cuda.load_library()
    m3_cuda.load_library()
    imdct_cuda.load_library()
    lap_cuda.load_library()
    native.host_library()
    native.decode_library()
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
    _lap(t_start, "3")

    # 3b. the M3 scan kernel vs its plain version, times and bounds
    fsw = FastEncoder(2, 44100, 0.5)
    if not (fsw.switching and fsw.psy_state):
        raise RuntimeError("switching and psy_state are not the defaults")
    m3_rec = _phase_m3(fsw, smi, args.m3_baseline)
    _lap(t_start, "3b")

    # 3f. the managed finish: stacked floor fit, M3 calls, card vs CPU
    abr = (-1, 128000, -1)
    fm = FastEncoder(2, 44100, bitrate=abr)
    fm_cpu = FastEncoder(2, 44100, bitrate=abr, device="cpu")
    fl_err_m, m3_err_m = _phase_managed_kernels(fm, fm_cpu, smi)
    max_err = max(max_err, fl_err_m)
    m3_rec["max_abs_err"] = max(m3_rec["max_abs_err"], m3_err_m)
    _lap(t_start, "3f")

    # 3g. both kernels at the shapes of the 5.1 encoder
    f51 = FastEncoder(6, 48000, 0.4)
    fl_err_51, fl_rec_51, m3_err_51, m3_rec_51 = _phase_51_kernels(f51, smi)
    max_err = max(max_err, fl_err_51)
    m3_rec["max_abs_err"] = max(m3_rec["max_abs_err"], m3_err_51)
    _lap(t_start, "3g")

    # 3h. the fast decode on the card against the scalar decoder, before
    # phases 4-4g read their streams with it
    _phase_decode_vs_scalar(fsw, fm, f51)
    _lap(t_start, "3h")

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
    t0 = time.perf_counter()
    out, _ = _decode(ogg)
    t_dec = time.perf_counter() - t0
    x = pcm16.astype(np.float64) / 32768.0
    if out.shape != pcm16.shape:
        raise RuntimeError(f"decoded shape {out.shape} != {pcm16.shape}")
    if not np.isfinite(out).all():
        raise RuntimeError("non-finite decoded samples")
    snr = 10 * np.log10(np.sum(x ** 2) / np.sum((out - x) ** 2))
    print(f"[encode] 60 s stereo: {len(ogg)} bytes, {nchunks} chunks, "
          f"floor launches {launches}, decoded {out.shape} in "
          f"{t_dec:.2f} s (decode_ogg_fast on the card), SNR {snr:.3f} dB "
          f"(JAX {JAX_SNR_DB:.3f} dB)")
    if snr < JAX_SNR_DB - SNR_MARGIN_DB:
        raise RuntimeError(f"SNR {snr:.3f} dB below the floor")
    print(f"[encode] warm encode from device {t_dev:.4f} s = "
          f"{secs / t_dev:.2f}x realtime; from host {t_host:.4f} s = "
          f"{secs / t_host:.2f}x realtime ({smi})")

    _lap(t_start, "4")

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
    out_s, _ = _decode(ogg_s)
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

    _lap(t_start, "4b")

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
        out_k, _ = _decode(oggs[k])
        snr_k = _snr(streams[k].cpu().numpy(), out_k)
        print(f"[batch] stream {k}: {len(oggs[k])} bytes, decoded "
              f"{out_k.shape}, SNR {snr_k:.3f} dB")
    print(f"[batch] {S} x 60 s: {t_batch:.4f} s = "
          f"{S * secs / t_batch:.2f}x realtime, floor launches "
          f"{launches_b}; last_profile (s): " + ", ".join(
              f"{k} {v:.4f}" for k, v in prof_b.items()) + f" ({smi})")
    del streams
    _lap(t_start, "4c")

    # 4d. the default main path (block switching + psy state), 16 x 60 s
    # of the tonal signal and of the click train, from CUDA tensors
    launches_sw = {}
    keep = {}                   # leg -> (streams, input lengths): phase 6
    for leg, gen in (("signal", _signal), ("click_train", _click_train)):
        streams = [torch.from_numpy(gen(60, 44100, k)).cuda()
                   for k in range(S)]
        fsw.encode_batch(streams[:2])               # warm-up
        torch.cuda.synchronize()
        for k in _kernels_of(fsw):
            k.launches = 0
        t0 = time.perf_counter()
        oggs = fsw.encode_batch(streams)
        torch.cuda.synchronize()
        t_sw = time.perf_counter() - t0
        fl_long = fsw.floor.launches
        fl_short = fsw._short_ctx.floor.launches
        m3_n = fsw._short_ctx.m3_scan.launches
        prof_sw = dict(fsw.last_profile)
        times, nlong, nshort, per = _prepare_times(fsw, streams)
        if fl_long == 0 or (nshort and fl_short == 0):
            raise RuntimeError(f"{leg}: floor kernel launches {fl_long} "
                               f"long, {fl_short} short")
        cuts = _m3_carry_cuts(fsw, per)
        if m3_n != cuts["batches"] or (leg == "click_train" and m3_n == 0):
            raise RuntimeError(f"{leg}: the M3 kernel launched {m3_n} "
                               f"times for {cuts['batches']} short batches")
        for k, o in enumerate(oggs):
            if _last_granulepos(o) != streams[k].shape[1]:
                raise RuntimeError(f"{leg} stream {k}: last granulepos "
                                   f"{_last_granulepos(o)}")
        for k in (0, S - 1):
            out_k, _ = _decode(oggs[k])
            snr_k = _snr(streams[k].cpu().numpy(), out_k)
            line = (f"[switched] {leg} stream {k}: {len(oggs[k])} bytes, "
                    f"{_short_blocks(fsw, oggs[k])} short blocks, decoded "
                    f"{out_k.shape}, SNR {snr_k:.3f} dB")
            if k == 0:
                line += (f" (JAX {JAX_SWITCHED_SNR_DB[leg]:.3f} dB, "
                         f"{JAX_SWITCHED_SHORTS[leg]} short blocks)")
            print(line)
            if k == 0 and abs(snr_k - JAX_SWITCHED_SNR_DB[leg]) \
                    > SNR_MARGIN_DB:
                raise RuntimeError(f"{leg}: SNR {snr_k:.3f} dB not within "
                                   f"{SNR_MARGIN_DB} dB of the JAX stream")
        print(f"[switched] {leg} {S} x 60 s: {t_sw:.4f} s = "
              f"{S * secs / t_sw:.2f}x realtime; {nlong} long + {nshort} "
              f"short frames; launches: floor {fl_long} long + {fl_short} "
              f"short, m3 {m3_n}; last_profile (s): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in prof_sw.items())
              + "; _prepare_switched alone (s): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in times.items()) + f" ({smi})")
        # the profiler's own cost grows with the kernel count: the click
        # train (~1M kernels at 16 streams) is profiled on 2 streams,
        # against the unprofiled wall of the same 2 streams
        prof_streams = streams if leg == "signal" else streams[:2]
        t_prof = t_sw
        if leg != "signal":
            t0 = time.perf_counter()
            fsw.encode_batch(prof_streams)
            torch.cuda.synchronize()
            t_prof = time.perf_counter() - t0
        print(f"[switched] {leg} M3 carry over the short batches: "
              + ", ".join(f"{k} {v}" for k, v in cuts.items()))
        busy, dev_ms, rows = _busy_share(
            lambda: fsw.encode_batch(prof_streams), t_prof)
        print(f"[switched] {leg} profiled ({len(prof_streams)} streams): "
              f"device {dev_ms:.3f} ms, busy {100 * busy:.1f}% of the "
              f"unprofiled {t_prof:.4f} s; top: " + "; ".join(rows))
        _lap(t_start, f"4d {leg}")
        launches_sw[leg] = (fl_long + fl_short, m3_n)
        keep[leg] = (oggs, [x.shape[1] for x in streams])
        click0 = streams[0]
        del streams, oggs

    # 4e. encode of one 60 s click-train stream (B_long = 1024)
    fsw.encode(click0)                              # warm-up
    torch.cuda.synchronize()
    for k in _kernels_of(fsw):
        k.launches = 0
    t0 = time.perf_counter()
    ogg_e = fsw.encode(click0)
    torch.cuda.synchronize()
    t_e = time.perf_counter() - t0
    launches_sw["encode"] = (fsw.floor.launches
                             + fsw._short_ctx.floor.launches,
                             fsw._short_ctx.m3_scan.launches)
    out_e, _ = _decode(ogg_e)
    snr_e = _snr(click0.cpu().numpy(), out_e)
    print(f"[switched] encode click train 60 s: {t_e:.4f} s = "
          f"{secs / t_e:.2f}x realtime, {len(ogg_e)} bytes, "
          f"{_short_blocks(fsw, ogg_e)} short blocks, launches floor "
          f"{launches_sw['encode'][0]}, m3 {launches_sw['encode'][1]}, SNR "
          f"{snr_e:.3f} dB (JAX {JAX_SWITCHED_SNR_DB['click_train']:.3f} "
          f"dB); last_profile (s): " + ", ".join(
              f"{k} {v:.4f}" for k, v in fsw.last_profile.items())
          + f" ({smi})")
    if abs(snr_e - JAX_SWITCHED_SNR_DB["click_train"]) > SNR_MARGIN_DB:
        raise RuntimeError(f"encode: SNR {snr_e:.3f} dB not within "
                           f"{SNR_MARGIN_DB} dB of the JAX stream")
    del click0
    _lap(t_start, "4e")

    # 4f. bench.py's managed transient leg: ABR 128 kbps, 8 x 30 s
    launches_sw["managed"] = _phase_managed_leg(fm, smi)
    _lap(t_start, "4f")

    # 4g. 5.1: 4 x 60 s tonal and 4 x 30 s click train
    launches_sw["5.1"] = _phase_51(f51, smi, keep)
    _lap(t_start, "4g")

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

    _lap(t_start, "5, 5b")

    # 5c. card vs CPU, switched: a 2 s click-train clip at B_long = 64
    fsw_cpu = FastEncoder(2, 44100, 0.5, device="cpu")
    clipc = np.ascontiguousarray(_click_train(2, 44100, 0))
    clipc_dev = torch.from_numpy(clipc).cuda()
    (mk_card,), per_card = _switched_marks(fsw, [clipc_dev])
    (mk_cpu,), per_cpu = _switched_marks(fsw_cpu, [clipc])
    flips = int((mk_card != mk_cpu).sum())
    sched = all(np.array_equal(per_card[0][k], per_cpu[0][k])
                for k in ("cs", "Ws", "impulse"))
    a = _audio_packets(fsw.encode_batch([clipc_dev], B_long=64)[0])
    b = _audio_packets(fsw_cpu.encode_batch([clipc], B_long=64)[0])
    if len(a) != len(b):
        raise RuntimeError(f"switched: card {len(a)} packets, CPU {len(b)}")
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    print(f"[card-vs-cpu] switched: marks {int(mk_card.sum())} card, "
          f"{int(mk_cpu.sum())} CPU, {flips} differ; schedule "
          f"{'equal' if sched else 'DIFFERS'} "
          f"({int((per_card[0]['Ws'] == 0).sum())} short blocks); identical "
          f"packets {len(a) - len(diff)}/{len(a)} (B_long=64, differing "
          f"{diff})")
    if flips or not sched:
        raise RuntimeError("switched: card and CPU marks or schedule differ")
    if len(a) - len(diff) < 0.9 * len(a):
        raise RuntimeError("switched card and CPU packets differ in more "
                           "than 10%")
    _lap(t_start, "5c")

    # 5d. card vs CPU, managed: the 2 s click-train clip at B = 64
    _phase_managed_card_vs_cpu(fm, fm_cpu, clipc, clipc_dev)

    # 5e. card vs CPU, 5.1: a 2 s click train at B = 64
    _phase_51_card_vs_cpu(f51, FastEncoder(6, 48000, 0.4, device="cpu"))
    _lap(t_start, "5d, 5e")

    # 6. decode: the IMDCT and lap kernels, then decode_ogg_fast(_batch)
    # on the card over 4d's and 4g's streams
    imdct_rec, lap_rec = _phase_decode(smi, keep, args.imdct_baseline,
                                       args.lap_baseline)
    _lap(t_start, "6")

    # 6b. the ov_* layer on the card: chunked reads, seeks, halfrate,
    # drains and a crosslap, held to the host path
    ov_imdct, ov_lap, ov_rec = _phase_vorbisfile(smi, keep)
    imdct_rec["launches"] += ov_imdct
    lap_rec["launches"] += ov_lap
    imdct_rec["at_ov"] = {"launches": ov_imdct, "chunks": ov_rec["chunks"],
                          **{k: v for k, v in ov_rec["chunk_kernels"].items()
                             if k.startswith("imdct")}}
    lap_rec["at_ov"] = {"launches": ov_lap, "chunks": ov_rec["chunks"],
                        **{k: v for k, v in ov_rec["chunk_kernels"].items()
                           if k.startswith("lap")}}
    _lap(t_start, "6b")

    # 7. the sharded encode step, the roundtrip pipeline (DeviceSynthesis
    # on the IMDCT and lap kernels) and LBG training on the card
    p7 = _phase_pipeline(smi)
    imdct_rec["launches"] += p7["imdct"]
    lap_rec["launches"] += p7["lap"]
    imdct_rec["at_pipeline"] = {"launches": p7["imdct"],
                                **p7["kernels"]["imdct"]}
    lap_rec["at_pipeline"] = {"launches": p7["lap"], **p7["kernels"]["lap"]}
    _lap(t_start, "7")

    # 8. the card's FastEncoder held to the port's golden encoder
    (p8_floor, p8_m3), (p8_imdct, p8_lap) = _phase_golden(smi)
    imdct_rec["launches"] += p8_imdct
    lap_rec["launches"] += p8_lap
    imdct_rec["at_golden"] = {"launches": p8_imdct}
    lap_rec["at_golden"] = {"launches": p8_lap}
    _lap(t_start, "8")

    print(f"[time] {time.perf_counter() - t_start:.1f} s of command time")
    print(json.dumps({"kernels": [{
        "name": "floor1_greedy_fit", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/floor_fit.cu",
        "replaces": "vorbis_tpu/ops/floor_pallas.py:289",
        "launches": launches + launches_s + launches_b + sum(
            v[0] for v in launches_sw.values()) + p7["floor"] + p8_floor,
        "at_pipeline": {"launches": p7["floor"]},
        "at_golden": {"launches": p8_floor},
        "max_abs_err": max(max_err, p7["floor_err"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "share": share, "at_51": fl_rec_51,
        "library_ms": None}, {
        "name": "m3_tempmdct_scan", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/m3_scan.cu",
        "replaces": "vorbis_tpu/ops/psydevice.py:498",
        "launches": sum(v[1] for v in launches_sw.values()) + p8_m3,
        **m3_rec, "at_51": m3_rec_51, "at_golden": {"launches": p8_m3},
        "library_ms": None}, {
        "name": "imdct", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/imdct.cu",
        "replaces": "vorbis_tpu/ops/mdct.py:261 (jnp, fastdec.py:210)",
        **imdct_rec}, {
        "name": "lap", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/lap.cu",
        "replaces": "vorbis_tpu/models/fastdec.py:142 (_native_lap, host C "
                    "vn_lap_add) and :351 (_trim_range)",
        **lap_rec}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
