#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (vorbis_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
the CUDA toolkit (nvcc) and a host C compiler (cc); it needs no JAX, no
vorbis_tpu and no network:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: the card, its name and power limit, the fp32 policy;
  2. build: nvcc compiles csrc/floor_fit.cu, csrc/floor_prepare.cu,
     csrc/floor_encode.cu, csrc/m3_scan.cu, csrc/imdct.cu, csrc/lap.cu,
     csrc/mdct_fwd.cu, csrc/bark_fit.cu, csrc/tone_mask.cu,
     csrc/residue_encode.cu, csrc/pack_bits.cu and
     csrc/couple_quantize.cu and cc compiles csrc/host_ogg.c (Ogg CRC and
     pager, rescue walk, schedule), csrc/host_decode.c (the decode's
     page walk, packet parse, host IMDCT and lap, with
     -ffp-contract=off) and
     csrc/host_pack.c (the host-pack encode's bit packers) into
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
     the stacked floor fit of the three offset_select masks (one
     prepare and one fit launch of 3*B*ch rows) bitwise against the plain
     fit and three separate launches, the short batch's three M3 calls by bit pattern against
     their plain version, and the 15-blob finish on the card against the
     same step on the CPU in >= 90% of the (F, 15) rows;
  3g. 5.1 kernels: the floor kernel bitwise against its plain version
     on the three floor looks of FastEncoder(6, 48000, 0.4) (P = 29,
     n = 1024; P = 13, n = 128; the LFE's P = 2, n = 12) at B = 1280 and
     256 rows of random spectra and at the rows of a main-path finish
     batch, with its times, bounds and plain times there; the M3 kernel
     by bit pattern on the six-channel short
     batches of 5 s of the 5.1 click train, and its time on the first
     full batch;
  3h. decode vs scalar: decode_ogg_fast with the IMDCT kernel on the
     card, and the host-C drain, bitwise against the port's scalar
     decoder (vorbis_tpu_torch.codec.decoder) on 2 s click-train clips of
     the switched, managed and 5.1 encoders; phases 4-4g then decode
     their streams with decode_ogg_fast on the card;
  3i. analysis front: the forward MDCT with its log spectrum
     (csrc/mdct_fwd.cu) and the two-pass bark fit (csrc/bark_fit.cu)
     bitwise against their plain versions (the JAX package's rounding,
     emulated in PyTorch) on real frames at the main path's shapes: 4d's
     long batch (2,048 rows of n = 2,048, per-row window ids) and a short
     batch (512 rows of n = 256), the 5.1 encoder's long and short blocks
     and phase 8's 16 kHz blocksizes (512, 1,024); both kernels' times
     (CUDA graphs, median and spread of three rounds) at the first two,
     in turns with the first designs (commit 0716f4b's, with
     --mdct-fwd-baseline and --bark-fit-baseline), their bounds by bytes,
     the plain versions' times and the library calls beside them (fp32
     torch.matmul and a float64 GEMM against the dense MDCT basis, a
     float32 torch.cumsum of the five prefix arrays); then
     FastEncoder(1, 44100, 0.5).encode_hostpack of 10 s on the card (its
     curve from the floor-encode kernel), its packets equal to the device
     packer's (switching and the psy state off) and its stream decoded
     to the exact length, the kernel's curve and qposts bitwise equal to
     the plain version (quantize_posts and render) at the inputs the
     device step gave it and at tests/floor_encode_cases.py's synthetic
     rows of its config;
  3j. (run right after 3, before 3b) the floor's post coding:
     csrc/floor_encode.cu (the wrap coding, the curve render and the
     floor's columns in one launch) bitwise against its plain version
     (the finish's _floor_wrap, render and _floor_fields) on the posts
     of a recorded long finish batch of 4d's click train (2,048 frames, 4,096 rows) and a short one (512 rows),
     their first 1 and 3 rows, the managed encoder's stacked 15-blob rows,
     the 5.1 encoder's three looks, FastEncoder(2, 16000 and 32000, 0.5)'s
     looks and tests/floor_encode_cases.py's synthetic rows at each of
     them, and its dense look (65 posts over n = 128, used posts a bin
     apart), the wrapped posts too; the build's registers, shared memory a
     block and blocks an SM;
     its time at the two 4d batches (CUDA graphs, median and spread of
     six; in turns with the first design, commit e7acfc3's, with
     --floor-encode-baseline, whose outputs must equal this design's),
     bound by bytes, share, the plain trio's time and device kernels (no
     library call computes it); and the two batches split by
     stage (noise-mask tail, tone mask, M3, mix, the floor fit's prepare
     kernel and its fit kernel, floor encode, coupling, residue encode,
     the packer kernel, the rest): each stage alone on its recorded
     inputs, device kernels and device ms under torch.profiler and ms a
     call, the floor's and the residue path's plain trios, the plain
     tone mask, the plain prepare and the packer's plain duo (merge and
     pack) alone, and the whole step with the kernels, with the floor's
     plain trio in the floor-encode kernel's place, with the residue
     path's plain trio in the residue kernel's place, with the plain
     tone mask in the tone-mask kernel's place, with the plain
     prepare and packer in those two kernels' places and with the plain
     coupling in the coupling kernel's place; then each step captured
     in one CUDA graph on static copies of its inputs (ROADMAP 2.16),
     with the kernels, with the residue path's plain trio, with the
     plain prepare and packer and with the plain coupling: the replay's
     packets and bit counts bitwise equal to the eager step's, the
     eager and replayed ms a call in turns;
  3k. the tone mask: csrc/tone_mask.cu (the octave groups' maxima, the
     curve seeding, the chase and the windowed min with the ATH floor in
     one launch) bitwise against its plain version (the JAX package's
     passes) on the tone-mask calls 3j recorded: 4d's long and short
     finish batch, the managed encoder's long and short steps, the 5.1
     encoder's two looks and the 16 and 32 kHz looks, and on
     tests/tone_mask_cases.py's seeded and edge rows (a silent row, a
     global max of 0, levels saturated at both ends, local != global)
     and its stress rows (every group at its widest span, a single
     depositing group) at each of those looks; the build's registers,
     shared memory a block and blocks an SM; its time at the two 4d
     batches (CUDA graphs, median and spread of six; in turns with PR
     17's design, commit c40e5f8's, with --tone-mask-baseline, whose
     outputs must equal this design's), its bound and share, the plain
     version's time and device kernels (no library call computes it);
     and where a block's time goes: a timing build of the same source
     (-DVTT_TONE_TIMING, clock64 stamps a warp at each phase's end and
     barrier) prints the slowest warp's cycles a phase at the two 4d
     batches, and with the baseline the same of the first design, its
     source stamped at its barriers;
  3l. the residue path: csrc/residue_encode.cu (the partition
     classify, every stage's lattice VQ and the codeword columns in one
     launch) bitwise, values and lengths, against its plain version (the
     finish's classifier, _vq_stages and _residue_fields) on the residue
     calls 3j recorded: 4d's long and short finish batch, the managed
     encoder's 15-blob rows (long and short), the 5.1 encoder's two
     submaps long and short, the 16 and 32 kHz configs, and on
     tests/residue_encode_cases.py's seeded, threshold, zero, unused,
     stress and INT_MIN rows at each of those configs, the INT_MIN rows
     also at each config's LatticeVariant (the widest class at lattice
     steps 2 and 3); the build's registers, its launch (warps a block,
     shared memory a block, blocks an SM); its time at the two 4d
     batches (CUDA graphs, median and spread of six; in turns with
     commit f26b635's design, with --residue-baseline, whose outputs must
     equal this design's), its bound (bytes against the function's own
     arithmetic on this run's classes) and share, the plain trio's time
     and device kernels (no library call computes it), and each phase's
     cycles an item (tables, load, classify, VQ, columns) from a timing
     build of the same source (-DVTT_RESIDUE_TIMING), and the baseline's
     a block from a copy of it stamped at its barriers;
  3m. the packer: csrc/pack_bits.cu (the plan's column merge and the
     LSB-first packing in one launch) bitwise, packets and bit counts,
     against its plain version (merge_columns and pack_bits) on the
     packer calls 3j recorded (4d's long and short finish batch, the
     managed encoder's 15-blob rows long and short, the 5.1 encoder long
     and short, the 16 and 32 kHz configs) at their budget and at the
     plan's worst_bytes, and on _pack_rows' seeded rows, stale values in
     zero-length columns, values with bits above their lengths, packets
     over the budget and zero rows at each of those plans; the build's
     registers and spills, the blocks sized to the batch (threads a
     packet, packets a block, groups a thread, tiles), shared memory a
     block and blocks an SM; its time at the two 4d batches (CUDA
     graphs, median and spread of six; in turns with the first design,
     commit 4c76a5d's, with --pack-baseline, whose outputs must equal
     this design's), its bound by bytes on this run's lengths (a
     zero-length column's value is never read) and share, the plain
     duo's time and device kernels (no library call computes it), and
     each phase's slowest-warp cycles (stage, copies, scan, wait, merge
     and OR, store) from a timing build of the same source
     (-DVTT_PACK_TIMING);
  3n. the floor fit's prepare: csrc/floor_prepare.cu (the mask's dB
     quantization, the above classes, the segments' moments and their
     weighted prefix in one launch) bitwise against its plain version
     (DeviceFloorFit.prepare; its prefix summed in the CPU's order, and
     the elements where the card's own cumsum differs counted) on the
     prepare calls 3j recorded (4d's long and short batch, the managed
     encoder's stacked rows, the 5.1 encoder's three looks, the 16 and 32
     kHz looks) and on _prepare_rows' seeded rows and edge rows (NaN and
     +-inf in the mask and in logmdct, nothing above, nothing used, a
     saturated mask) at each of those looks and at a synthetic look of
     two posts; the build's registers, its launch (warps a block,
     shared memory a block, blocks an SM); its time at the two 4d
     batches (CUDA graphs, median and spread of six; in turns with commit
     f26b635's design, with --prepare-baseline, whose outputs must equal
     this design's), its bound by bytes and share, the plain version's
     time and device kernels (no library call computes it), and each
     phase's cycles a row (wait, quant and above, moments, windows,
     prefix, store) from a timing build of the same source
     (-DVTT_PREPARE_TIMING), and the baseline's from a stamped copy;
  3o. the stereo coupling: csrc/couple_quantize.cu (the lowpass, the
     M9 lowering, M6, the lossless mag/ang, the point fold, the
     normalize and the interleave in one launch) bitwise, residues and
     flags, against its plain version (the lowpass where,
     _couple_quantize, the interleave) on the coupling calls 3j
     recorded (4d's long and short finish batch, the managed encoder's
     15-blob rows long and short, the 16 and 32 kHz configs) and on
     tests/couple_cases.py's seeded rows, its rows on M6's and the
     normalize's edges (padded too) and its rows of every instantiation
     (with and without the M9 peaks, padded, the carry of a warp's first
     partition) at each of those configs and at FastEncoder(2, 44100,
     0.2)'s, failing unless every instantiation of the kernel launched;
     each instantiation's registers, shared memory and blocks an SM;
     its time at the two 4d batches (CUDA graphs, median and spread of
     six; in turns with the first design, commit e6f7150's, with
     --couple-baseline, whose outputs must equal this design's), its
     bound by bytes and share, the plain version's time and device
     kernels (no library call computes it), and each phase's
     slowest-warp cycles from a -DVTT_COUPLE_TIMING build;
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
     the CPU, byte for byte, >= 90% identical; for the first packet that
     differs, the first stage whose card and CPU outputs differ (spectra
     and masks, fit posts, the floor's post coding, coupled residues,
     the residue path's columns, packed bytes), with its size and
     whether its inputs were equal (the floor's post coding, the
     residue path or the packer differing on equal inputs fails the
     phase);
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
     card, the card against the CPU, encode_quantize_step (its curve and
     qposts from the floor-encode kernel, P = 65) card against CPU (>= 90%
     of qpost rows), the kernel's curve and qposts bitwise equal to the
     plain version at the inputs the step gave it and at the synthetic
     rows of its config, the roundtrip's times; 7c lbg_train of
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
after it; every main-path encode of 3i's host pack, 4-4g, 7a's split
step, 7b's encode_quantize_step and 8 must launch both analysis-front
kernels, the floor-encode kernel as often as the floor fit (one launch a
finish call, or a device step, a floor look), the tone-mask kernel
once a finish step or DeviceAnalysis.mask_components call (the two
callers are counted apart from the kernel's wrapper) and the residue
kernel once a finish call a residue submap (finish_from_posts and each
submap of _finish_multi, counted apart from its wrapper; 3i's host pack
and 7b's step call no finish), the packer kernel once a finish call
(counted the same way), the prepare kernel as often as the floor fit
and the coupling kernel once a stereo finish_from_posts call (counted
the same way; none in 3i, 4g and 7b, some in every other phase).  Phase 5 prints the differing packets'
indices.
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


def _prepare_rows(n, B, seed):
    """Spectra (logmdct, logmask) float32 (B + 8, n) numpy for the floor
    prepare's checks: B seeded rows (the spread of _random_spectra), then
    edge rows: nothing above, everything above, a mask below the
    quantizer's first step (nothing used), a saturated mask, NaN in the
    mask, -inf in the mask, NaN and +-inf in logmdct, and +inf in the
    mask (quant 1023: the convert saturates).  A tenth of the seeded
    rows' second-half bins hold a mask below the first step or
    saturated."""
    import numpy as np
    rng = np.random.RandomState(seed)
    lm = (rng.randn(B + 8, n) * 20 - 60).astype(np.float32)
    mk = (lm + rng.randn(B + 8, n) * 6 - 3).astype(np.float32)
    e = B
    lm[e] = mk[e] - 1000.0                      # nothing above
    lm[e + 1] = mk[e + 1] + 1000.0              # everything above
    mk[e + 2] = -150.0                          # quant 0: nothing used
    mk[e + 3] = 300.0                           # quant clamped at 1023
    mk[e + 4, ::3] = np.nan
    mk[e + 5, ::2] = -np.inf
    lm[e + 6, ::3] = np.nan
    lm[e + 6, 1::3] = np.inf
    lm[e + 6, 2::6] = -np.inf
    mk[e + 7, ::4] = np.inf
    pick = (np.arange(n) >= n // 2) & (rng.rand(B, n) < 0.1)
    mk[:B][pick] = rng.choice(np.float32([-150.0, 300.0]), pick.sum())
    return lm, mk


def _pack_rows(gidx, n_cols, seed, seeded=4):
    """Raw columns (vals (F, C) int64, lens (F, C) int32) numpy for the
    packer's checks on a plan (gidx (C1, Gmax) with -1 pads, n_cols C):
    `seeded` rows whose groups hold at most 32 bits with values below
    2^length, then a row with stale values in every zero-length column, a
    row whose values carry bits above their lengths (a group's columns
    merge unmasked), a row with every group at 32 bits (longer than any
    budget), a row of zero lengths with stale values and an all-zero
    row."""
    import numpy as np
    rng = np.random.RandomState(seed)
    F = seeded + 5

    def lengths(full):
        lens = np.zeros((F, n_cols), np.int64)
        for row in gidx:
            cols = row[row >= 0]
            cuts = np.sort(rng.randint(0, 33, (F, len(cols) + 1)), 1)
            if full:
                cuts[:, 0], cuts[:, -1] = 0, 32
            lens[:, cols] = np.diff(cuts, axis=1)
        return lens

    lens = lengths(False)
    lens[seeded + 2] = lengths(True)[seeded + 2]
    lens[seeded + 3:] = 0
    raw = rng.randint(0, 2 ** 32, (F, n_cols), dtype=np.uint64)
    vals = raw & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))
    s = seeded
    vals[s] = np.where(lens[s] == 0, raw[s], vals[s])      # stale values
    vals[s + 1] = raw[s + 1]                               # high bits
    vals[s + 3] = raw[s + 3]                               # stale, no bits
    vals[s + 4] = 0
    return vals.astype(np.int64), lens.astype(np.int32)


def _prep_want(fit, logmdct, logmask):
    """The plain prepare of fit's look on the card's tensors with its
    prefix summed in the CPU's order (the plain weighted moments' float64
    running sum taken on the CPU, one segment after another, rounded
    once): the kernel's contract.  Returns ((quant, above, prefix, used),
    the prefix elements in which the card's own cumsum of the same
    moments differs)."""
    import torch
    from vorbis_tpu_torch.ops.floor_cuda import floor_prepare_plain
    quant, above, card, used = floor_prepare_plain(fit, logmdct, logmask)
    wm, _ = fit._weighted_moments(quant, above)
    run = torch.cumsum(wm.double().cpu(), dim=-2).float().to(card.device)
    prefix = torch.cat([torch.zeros_like(run[:, :1]), run], 1)
    differ = int((prefix.view(torch.int32) != card.view(torch.int32)).sum())
    return (quant, above, prefix, used), differ


def _prep_check(name, fit, logmdct, logmask):
    """The prepare kernel against _prep_want, bitwise (the prefix by bit
    pattern); returns the largest difference."""
    import torch
    from vorbis_tpu_torch.ops.floor_cuda import floor_prepare
    got = floor_prepare(fit, logmdct, logmask)
    want, differ = _prep_want(fit, logmdct, logmask)
    torch.cuda.synchronize()
    same = [torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                        w.view(torch.int32) if w.is_floating_point() else w)
            for g, w in zip(got, want)]
    err = max(float((g.double() - w.double()).abs().max()) if g.numel()
              else 0.0 for g, w in zip(got, want))
    print(f"[floor prepare] {name}: B={logmdct.shape[0]} n={fit.n} "
          f"P={fit.posts}: quant, above, prefix, used "
          + ("bitwise equal to the plain version" if all(same) else
             f"DIFFER {same}") + f", max_abs_err {err}; the card's own "
          f"cumsum differs from the CPU's order in {differ} prefix "
          f"elements")
    if not all(same):
        raise RuntimeError(f"floor prepare {name}: kernel != plain")
    return err


def _pack_check(name, tabs, vals, lens, wb):
    """The packer kernel against pack_packets_plain on the card, bitwise;
    returns the largest difference."""
    import torch
    from vorbis_tpu_torch.ops.pack_cuda import pack_packets, pack_packets_plain
    got = pack_packets(tabs, vals, lens, wb)
    want = pack_packets_plain(tabs, vals, lens, wb)
    torch.cuda.synchronize()
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    err = max(float((g.double() - w.double()).abs().max()) if g.numel()
              else 0.0 for g, w in zip(got, want))
    print(f"[pack] {name}: F={vals.shape[0]} C={tabs.n_cols} "
          f"C1={tabs.n_groups} wb={wb}: packets, nbits "
          + ("bitwise equal to the plain version" if all(same) else
             f"DIFFER {same}") + f", max_abs_err {err}; "
          f"{int((want[1] > 8 * wb).sum())} packets over the budget")
    if not all(same):
        raise RuntimeError(f"pack {name}: kernel != plain")
    return err


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
        prep0 = floor_cuda.floor_prepare.launches
        try:
            pk, nb = step_of(W, B)(*calls[W])
            torch.cuda.synchronize()
        finally:
            del fl.fit, mdev.ladder_rows, mdev.blob_rows
            fm._short_ctx.m3_scan = m3
        preps = floor_cuda.floor_prepare.launches - prep0
        if len(fits) != 1 or fl.launches != 1 or preps != 1:
            raise RuntimeError(f"managed W={W}: {len(fits)} floor fits, "
                               f"{fl.launches} fit and {preps} prepare "
                               f"launches (one each expected)")
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
              f"(3 x {R}) in one prepare and one fit launch; mismatches "
              f"against the plain fit and three launches {bad}")
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
    _path_reset()
    t0 = time.perf_counter()
    oggs = fm.encode_managed_batch(streams)
    torch.cuda.synchronize()
    t_m = time.perf_counter() - t0
    _path_add("4f")
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



# -- the analysis front: csrc/mdct_fwd.cu and csrc/bark_fit.cu ------------

# (mdct_fwd, bark_fit, floor_encode, tone_mask, residue_encode,
# pack_packets, floor_prepare, couple_quantize) launches of each
# main-path run, by phase
PATH_LAUNCHES = {}
# the calls that reach the tone mask since _path_reset: the finish
# steps' (each calls psydevice.noisemask_tail once) and
# DeviceAnalysis.mask_components' (the stateless steps, the host pack,
# the pipeline)
TONE_CALLS = [0]
# the residue blocks of the finish calls since _path_reset: one a
# finish_from_posts call, one a submap a _finish_multi call
RES_CALLS = [0]
# the finish calls since _path_reset (finish_from_posts and _finish_multi
# each pack their packets once)
FINISH_CALLS = [0]
# the stereo finish_from_posts calls since _path_reset (res_type 2: each
# couples its pair once)
COUPLE_CALLS = [0]
# the main-path runs that call no finish step (the host pack's device
# step, the pipeline's encode_quantize_step): the residue kernel is not
# on their path; nor is the coupling kernel, nor on 5.1's (its chained
# coupling is plain PyTorch)
NO_FINISH = ("3i", "7b")
NO_COUPLE = NO_FINISH + ("4g",)


def _path_kernels():
    """The kernel wrappers that every main-path encode launches besides
    the floor fit and M3: the analysis front's two (each DeviceAnalysis
    spectra call launches both), the floor's post coding (once a finish
    call a floor look), the tone mask (once a finish step or
    mask_components call), the residue path (once a finish call a
    residue submap), the packer (once a finish call), the floor fit's
    prepare (once a floor fit launch) and the stereo coupling (once a
    stereo finish_from_posts call)."""
    from vorbis_tpu_torch.ops.bark_cuda import bark_fit
    from vorbis_tpu_torch.ops.couple_cuda import couple_quantize
    from vorbis_tpu_torch.ops.floor_cuda import floor_prepare
    from vorbis_tpu_torch.ops.floor_encode_cuda import floor_encode
    from vorbis_tpu_torch.ops.mdct_cuda import mdct_fwd
    from vorbis_tpu_torch.ops.pack_cuda import pack_packets
    from vorbis_tpu_torch.ops.residue_encode_cuda import residue_encode
    from vorbis_tpu_torch.ops.tone_mask_cuda import tone_mask
    return (mdct_fwd, bark_fit, floor_encode, tone_mask, residue_encode,
            pack_packets, floor_prepare, couple_quantize)


def _count_tone_calls():
    """Count, in TONE_CALLS, the calls of psydevice.noisemask_tail and of
    DeviceAnalysis.mask_components from here on: each is one call of the
    tone mask on the main path, counted apart from its wrapper."""
    from vorbis_tpu_torch.ops import psydevice, torchdsp
    for owner, name in ((psydevice, "noisemask_tail"),
                        (torchdsp.DeviceAnalysis, "mask_components")):
        real = getattr(owner, name)

        def counted(*a, _real=real, **kw):
            TONE_CALLS[0] += 1
            return _real(*a, **kw)
        setattr(owner, name, counted)


def _count_finish_calls():
    """Count, in RES_CALLS, the residue blocks of the finish calls from
    here on: one a DeviceFastEncode.finish_from_posts call (the
    single-submap layouts and the managed pass), one a submap a
    _finish_multi call (5.1); each is one call of the residue kernel,
    counted apart from its wrapper.  FINISH_CALLS counts the calls, each
    one call of the packer, and COUPLE_CALLS the finish_from_posts calls
    of a stereo (res_type 2) layout, each one call of the coupling."""
    from vorbis_tpu_torch.ops.encdevice import DeviceFastEncode
    real_one = DeviceFastEncode.finish_from_posts
    real_multi = DeviceFastEncode._finish_multi

    def one(self, *a, **kw):
        RES_CALLS[0] += 1
        FINISH_CALLS[0] += 1
        COUPLE_CALLS[0] += self.res_type == 2
        return real_one(self, *a, **kw)

    def multi(self, *a, **kw):
        RES_CALLS[0] += len(self.groups)
        FINISH_CALLS[0] += 1
        return real_multi(self, *a, **kw)
    DeviceFastEncode.finish_from_posts = one
    DeviceFastEncode._finish_multi = multi


def _path_reset():
    for k in _path_kernels():
        k.launches = 0
    TONE_CALLS[0] = 0
    RES_CALLS[0] = 0
    FINISH_CALLS[0] = 0
    COUPLE_CALLS[0] = 0


def _path_add(phase):
    """Add the _path_kernels' launches since _path_reset to `phase`;
    a main-path run that launched one of them no time (the residue
    kernel and the packer outside NO_FINISH), the tone mask otherwise
    than once a finish step or mask_components call, the residue kernel
    otherwise than once a finish call a residue submap, the packer
    otherwise than once a finish call, or the coupling otherwise than
    once a stereo finish_from_posts call (none in NO_COUPLE; main()
    fails a phase outside it whose runs launched it no time: phase 8's
    5.1 encode calls none), fails."""
    counts = [k.launches for k in _path_kernels()]
    if (min(counts[:4] + counts[6:7]) == 0
            or (phase not in NO_FINISH and min(counts[4:6]) == 0)
            or (phase in NO_COUPLE and counts[7])):
        raise RuntimeError(f"{phase}: mdct_fwd, bark_fit, floor_encode, "
                           f"tone_mask, residue_encode, pack_packets, "
                           f"floor_prepare and couple_quantize launched "
                           f"{counts} times")
    if counts[3] != TONE_CALLS[0]:
        raise RuntimeError(f"{phase}: tone_mask launched {counts[3]} times "
                           f"for {TONE_CALLS[0]} finish steps and "
                           f"mask_components calls")
    if counts[4] != RES_CALLS[0]:
        raise RuntimeError(f"{phase}: residue_encode launched {counts[4]} "
                           f"times for {RES_CALLS[0]} finish calls x residue "
                           f"submaps")
    if counts[5] != FINISH_CALLS[0]:
        raise RuntimeError(f"{phase}: pack_packets launched {counts[5]} "
                           f"times for {FINISH_CALLS[0]} finish calls")
    if counts[7] != COUPLE_CALLS[0]:
        raise RuntimeError(f"{phase}: couple_quantize launched {counts[7]} "
                           f"times for {COUPLE_CALLS[0]} stereo "
                           f"finish_from_posts calls")
    PATH_LAUNCHES[phase] = tuple(
        a + b for a, b in zip(PATH_LAUNCHES.get(phase, (0,) * len(counts)),
                              counts))


def _mdct_fwd_work(n, rows, nwin):
    """(bytes, float32 operations) of csrc/mdct_fwd.cu on `rows` rows of
    blocksize n with `nwin` windows (1, or 4 read by a per-row id): the
    frames read once and md and logmdct written once, each window and
    id read once; the operations as the kernel does them (an fma one):
    the window n, the fold n/2, the first rotation 4 of n/4, a radix-2
    stage 8 of n/8, a 32-point tail 227, the bitreverse stage with the
    final rotation and todB 34 of n/8."""
    from vorbis_tpu_torch.ops.mdct import _imdct_index_tables
    nst = len(_imdct_index_tables(n)["stages"])
    ops = (n + n // 2 + 4 * (n // 4) + nst * 8 * (n // 8)
           + 227 * (n // 64) + 34 * (n // 8))
    ids = 4 * rows if nwin > 1 else 0
    return rows * n * 4 * 2 + nwin * n * 4 + ids, rows * ops


def _bark_fit_work(n2, rows, fixed):
    """(bytes, float32 operations) of csrc/bark_fit.cu on `rows` rows of
    n2 bins: md read once, fit1 and dB written once, the two window
    tables read once; a bin's operations as the kernel does them (an
    fma one): per pass the five products and the five prefix sums' two
    adds each (15), the bark window's fit (5 differences, 6 for the
    terms, 1 fma and 1 division: 13); pass 1's input, mask and work 6,
    pass 2's 5 and the fixed window's fit (13) where it has one."""
    per = 2 * (15 + 13) + 6 + 5 + (13 if fixed > 0 else 0)
    return rows * n2 * 12 + 2 * n2 * 4, rows * n2 * per


# sha256 of the first designs of csrc/mdct_fwd.cu and csrc/bark_fit.cu
# (commit 0716f4b), whose C interfaces equal this design's
FRONT_BASELINE_SHA256 = {
    "mdct_fwd": ("61c5ae62c7f19e79d9cff1a411b2e6507f8bcd9a44c60f338d341c"
                 "1d5158a16c"),
    "bark_fit": ("15e68d1c5cbfe78c74ce5b3309a053f3bf633cec9881c342ded391"
                 "6757b9e1f9")}


class _FrontBaseline:
    """The first design of an analysis-front kernel (one CTA a row: `git
    show 0716f4b:vorbis_tpu_torch/csrc/mdct_fwd.cu`, or bark_fit.cu),
    built from `source` under its own library name for timing in turns.
    Its entry point takes this design's arguments; any other source is
    refused (its hash differs)."""

    def __init__(self, source, name):
        import ctypes
        import hashlib
        from pathlib import Path
        from vorbis_tpu_torch.native import build_library
        from vorbis_tpu_torch.ops import bark_cuda, floor_cuda, mdct_cuda
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()
        if digest != FRONT_BASELINE_SHA256[name]:
            raise RuntimeError(f"--{name.replace('_', '-')}-baseline "
                               f"{source} is not commit 0716f4b's "
                               f"{name}.cu (sha256 {digest})")
        so, _ = build_library(Path(source), floor_cuda.nvcc,
                              floor_cuda.NVCC_FLAGS, f"lib{name}_baseline")
        self.fn = getattr(ctypes.CDLL(str(so)), f"vtt_{name}")
        ours = getattr((mdct_cuda if name == "mdct_fwd" else bark_cuda)
                       .load_library(), f"vtt_{name}")
        self.fn.restype, self.fn.argtypes = ours.restype, ours.argtypes

    def mdct_fwd(self, fr, win, wid, md, lm):
        import torch
        from vorbis_tpu_torch.ops.mdct_cuda import mdct_fwd
        n = fr.shape[1]
        rc = self.fn(fr.data_ptr(), win.data_ptr(),
                     None if wid is None else wid.data_ptr(),
                     md.data_ptr(), lm.data_ptr(), fr.shape[0], n,
                     mdct_fwd.table(n, fr.device).data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline mdct_fwd launch failed: {rc}")

    def bark_fit(self, md, tabs, fit1, dB):
        import torch
        rc = self.fn(md.data_ptr(), tabs["bark_lo32"].data_ptr(),
                     tabs["bark_hi32"].data_ptr(), fit1.data_ptr(),
                     dB.data_ptr(), md.shape[0], md.shape[1], tabs["i1"],
                     tabs["i2"], tabs["j1"], tabs["j2"], tabs["fixed"],
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline bark_fit launch failed: {rc}")


def _turns(mine, theirs, rounds=3):
    """ms a call (CUDA graphs) of `mine`, and of `theirs` where given,
    over `rounds` rounds of (mine, theirs, theirs, mine), or of mine
    twice: two lists of times."""
    a, b = [], []
    for _ in range(rounds):
        a.append(_graph_ms(mine))
        b += [_graph_ms(theirs), _graph_ms(theirs)] if theirs else []
        a.append(_graph_ms(mine))
    return a, b


def _med(ts):
    """(median, min, max) of the times ts."""
    ts = sorted(ts)
    return ts[len(ts) // 2], ts[0], ts[-1]


def _build_lines(report):
    """The registers and stack lines of a build's ptxas report."""
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "stack" in ln]


def _phase_front(fsw, f51, smi, baselines=None):
    """Phase 3i: the analysis front's two kernels against their plain
    versions, bitwise, at the main path's shapes: 4d's long batch (2,048
    rows of n = 2,048 with per-row window ids) and a short batch (512
    rows of n = 256) of FastEncoder(2, 44100, 0.5), the 5.1 encoder's
    long and short blocks (48 kHz) and phase 8's 16 kHz blocksizes (512
    and 1,024); each kernel's time (CUDA graphs), bound and plain time,
    and the library calls beside them: an fp32 torch.matmul and the
    float64 GEMM of the port before (the MDCT against its dense basis),
    one float32 torch.cumsum of the five prefix arrays (the bark fit).  Each
    kernel's time is the median of three rounds, in turns with its first
    design where `baselines` ({name: _FrontBaseline}) has it, whose
    output must equal this design's and which must be the slower.
    Then FastEncoder(1, 44100, 0.5).encode_hostpack of 10 s on the card
    held to the device packer's packets, its floor_encode calls recorded
    and held bitwise to the plain version (_fenc_path_check).  Returns
    the two kernels' records for the JSON line, the host pack's floor
    fit launches and floor_encode's largest difference."""
    import numpy as np
    import torch
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    from vorbis_tpu_torch.ops.bark_cuda import bark_fit_plain
    from vorbis_tpu_torch.ops.mdct import mdct_basis_np
    from vorbis_tpu_torch.ops.mdct_cuda import mdct_fwd_plain
    mdct_fwd, bark_fit = _path_kernels()[:2]
    f16 = FastEncoder(2, 16000, 0.5)
    cases = [("4d long", fsw.analysis, _signal, 44100, 2048, True),
             ("short n=256", fsw.ctx(0).analysis, _click_train, 44100, 512,
              False),
             ("5.1 long", f51.analysis, _signal51, 48000, 3072, True),
             ("5.1 short", f51.ctx(0).analysis, _click_train51, 48000,
              1536, False),
             ("16 kHz long", f16.analysis, _signal, 16000, 512, True),
             ("16 kHz short", f16.ctx(0).analysis, _signal, 16000, 512,
              False)]
    err, recs = 0.0, {}
    for name, da, gen, rate, rows, ids in cases:
        n, hop = da.n, da.n // 2
        ch = 6 if gen in (_signal51, _click_train51) else 2
        secs = -(-((rows // ch) * hop + n) // rate)
        x = torch.from_numpy(gen(secs, rate, 1)).cuda().float() / 32768.0
        fr = x.unfold(1, n, hop)[:, :rows // ch].transpose(0, 1) \
            .reshape(-1, n).contiguous()
        wid = (torch.from_numpy(np.random.RandomState(n).choice(
            4, len(fr), p=[0.05, 0.1, 0.1, 0.75])).cuda() if ids else None)
        win = da.windows4 if ids else da.window
        args = (fr, win) if wid is None else (fr, win, wid)
        got = mdct_fwd(*args)
        want = mdct_fwd_plain(*args)
        fb = bark_fit(got[0], da.bark)
        fbw = bark_fit_plain(got[0], da.bark)
        torch.cuda.synchronize()
        for g, w in zip(got + fb, want + fbw):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                raise RuntimeError(f"front {name}: a kernel differs from "
                                   f"its plain version")
            err = max(err, float((g.double() - w.double()).abs().max()))
        print(f"[front] {name}: {len(fr)} rows of n = {n} ({rate} Hz"
              f"{', window ids' if ids else ''}), i1 {da.i1} j1 {da.j1} "
              f"fixed {da.fixed}: mdct_fwd and bark_fit bitwise equal to "
              f"their plain versions")
        if name not in ("4d long", "short n=256"):
            continue
        md = got[0]
        mbase = (baselines or {}).get("mdct_fwd")
        bbase = (baselines or {}).get("bark_fit")
        outs = (torch.empty_like(md), torch.empty_like(md),
                torch.empty_like(md), torch.empty_like(fb[1]))
        wid32 = None if wid is None else wid.int()
        m_t, m_base = _turns(
            lambda: mdct_fwd(*args),
            mbase and (lambda: mbase.mdct_fwd(fr, win, wid32, *outs[:2])))
        b_t, b_base = _turns(
            lambda: bark_fit(md, da.bark),
            bbase and (lambda: bbase.bark_fit(md, da.bark, *outs[2:])))
        torch.cuda.synchronize()
        for key, base, o, w in (("mdct_fwd", mbase, outs[:2], got),
                                ("bark_fit", bbase, outs[2:], fb)):
            if base and not all(torch.equal(x.view(torch.int32),
                                            y.view(torch.int32))
                                for x, y in zip(o, w)):
                raise RuntimeError(f"front {name}: the first {key} differs "
                                   f"from this design")
        m_ms, b_ms = _med(m_t)[0], _med(b_t)[0]
        for key, t, tb in (("mdct_fwd", m_t, m_base),
                           ("bark_fit", b_t, b_base)):
            print(f"[front] {name} {key} in turns (ms, CUDA graphs; "
                  f"median, min-max of {len(t)}): this design "
                  "%.5f (%.5f-%.5f)" % _med(t)
                  + (", first design %.5f (%.5f-%.5f), %.2fx faster" % (
                      *_med(tb), _med(tb)[0] / _med(t)[0]) if tb else "")
                  + f"; rounds {[round(v, 5) for v in t]}"
                  + (f" against {[round(v, 5) for v in tb]}" if tb else "")
                  + f" ({smi})")
            if tb and _med(t)[0] >= _med(tb)[0]:
                raise RuntimeError(f"front {name}: {key} is not faster "
                                   f"than its first design")
        m_plain = _cuda_ms(lambda: mdct_fwd_plain(*args), 3)
        b_plain = _cuda_ms(lambda: bark_fit_plain(md, da.bark), 3)
        w = (fr * (win[wid] if ids else win)).contiguous()
        basis = torch.from_numpy(mdct_basis_np(n)).cuda()
        basis64 = basis.double()
        m_lib = _graph_ms(lambda: torch.matmul(w, basis))
        m_lib64 = _graph_ms(lambda: torch.matmul(w.double(), basis64)
                            .float())
        five = torch.rand(5, *md.shape, device="cuda") + 1.0
        b_lib = _graph_ms(lambda: torch.cumsum(five, -1))
        mb, mo = _mdct_fwd_work(n, len(fr), 4 if ids else 1)
        bb, bo = _bark_fit_work(n // 2, len(fr), da.fixed)
        m_bound, m_by = _roofline(mb, mo)
        b_bound, b_by = _roofline(bb, bo)
        print(f"[front] {name} mdct_fwd: kernel {m_ms:.5f} ms, plain "
              f"{m_plain:.4f} ms, bound {m_bound * 1e3:.3f} us by {m_by} "
              f"({mb} bytes, {mo} operations), share "
              f"{100 * m_bound / m_ms:.1f}%; fp32 torch.matmul against the "
              f"basis {m_lib:.5f} ms, float64 GEMM {m_lib64:.5f} ms "
              f"({smi})")
        print(f"[front] {name} bark_fit: kernel {b_ms:.5f} ms, plain "
              f"{b_plain:.4f} ms, bound {b_bound * 1e3:.3f} us by {b_by} "
              f"({bb} bytes, {bo} operations), share "
              f"{100 * b_bound / b_ms:.1f}%; torch.cumsum of the five "
              f"arrays {b_lib:.5f} ms ({smi})")
        recs[name] = (dict(rows=len(fr), n=n, ms=m_ms, plain_ms=m_plain,
                           bound_ms=m_bound, bound_by=m_by,
                           library_ms=m_lib, float64_gemm_ms=m_lib64,
                           rounds_ms=m_t,
                           baseline_ms=_med(m_base)[0] if m_base else None,
                           baseline_rounds_ms=m_base or None),
                      dict(rows=len(fr), n2=n // 2, ms=b_ms,
                           plain_ms=b_plain, bound_ms=b_bound,
                           bound_by=b_by, library_ms=b_lib, rounds_ms=b_t,
                           baseline_ms=_med(b_base)[0] if b_base else None,
                           baseline_rounds_ms=b_base or None))
    # the host-pack encode on the card against the device packer; its
    # floor_encode launches held to its floor fit's (main())
    from vorbis_tpu_torch.models import fastenc
    pcm = _signal(10, 44100, 2)[:1]
    fh = FastEncoder(1, 44100, 0.5)
    fh.floor.launches = 0
    _path_reset()
    hp = []
    recorded = _record_floor_encode(
        lambda: hp.append(fh.encode_hostpack(pcm)), fastenc)
    hp = hp[0]
    _path_add("3i")
    hostpack_fits = fh.floor.launches
    # its device step's curve config, held bitwise to its plain version
    # (the fit's quantize_posts and render) at the inputs it was given
    fenc_err = _fenc_path_check("host pack", recorded, 131)
    dp = FastEncoder(1, 44100, 0.5, switching=False,
                     psy_state=False).encode(pcm)
    a, b = _audio_packets(hp), _audio_packets(dp)
    if a != b:
        differ = sum(x != y for x, y in zip(a, b))
        raise RuntimeError(f"encode_hostpack: {differ} of {len(a)} packets "
                           f"differ from the device packer's ({len(b)})")
    out, _ = _decode(hp)
    if out.shape != pcm.shape:
        raise RuntimeError(f"encode_hostpack decodes to {out.shape}")
    print(f"[front] encode_hostpack 10 s mono on the card: {len(hp)} bytes, "
          f"{len(a)} audio packets equal to the device packer's, decoded "
          f"{out.shape}; floor fit launches {hostpack_fits}, floor_encode "
          f"{PATH_LAUNCHES['3i'][2]}")
    rec = {}
    for i, key in enumerate(("mdct_fwd", "bark_fit")):
        main, short = recs["4d long"][i], recs["short n=256"][i]
        rec[key] = dict({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
                        max_abs_err=err, at_long=main, at_short=short)
    return rec, hostpack_fits, fenc_err


# -- the floor's post coding: csrc/floor_encode.cu --------------------------

# Operations of csrc/floor_encode.cu a row, counted from its source, once
# each (not once a lane where the warp repeats a step):
#  - a bin of the curve: the interval and segment loads, the two tests,
#    the DDA (difference, abs, offset, multiply, the three conversions and
#    the sign select and add), the clamp, the table load and the store:
#    16 integer operations, and 2 float32 ones (the add and the divide);
#  - a post: its load, the quantization (mask, shift or divide, or) and
#    store, 6; its step of the wrap (neighbour and x loads, the
#    prediction, the flag test, the code, the stores), 28; its sorted
#    position's two scans (a load and a test a post passed, at least one
#    each way), the two clamps and the store, 16;
#  - a column: the sub-book choice (a compare a sub-book tried), the
#    book load, the length's mask and two stores, 10.
OPS_FENC_PER_BIN = 16
F32_FENC_PER_BIN = 2
OPS_FENC_PER_POST = 6 + 28 + 16
OPS_FENC_PER_COL = 10


def _fenc_bound(cfg, B):
    """(bound ms, bound_by, bytes, int32 ops, float32 ops) of one
    floor_encode call on B rows of the finish config cfg: posts and used
    read once, the curve and the columns written once, the blob read
    once; the operations as counted above."""
    t = cfg.floor_enc
    nbytes = B * (t.P * 4 + 1 + t.n * 4 + t.fc * 12) + t.blob.numel() * 4
    int_ops = B * (t.n * OPS_FENC_PER_BIN + t.P * OPS_FENC_PER_POST
                   + t.fc * OPS_FENC_PER_COL)
    f32_ops = B * t.n * F32_FENC_PER_BIN
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, int_ops, f32_ops)


# sha256 of the first design of csrc/floor_encode.cu (commit e7acfc3): its
# C entry point vtt_floor_encode is this design's, and it finds its tables
# in this design's blob through the header's first 16 words
FENC_BASELINE_SHA256 = ("c26c0ff5fb2f88fc323e3135df7255edde22774cb76c9e0c"
                        "ae916a22643f010f")


class _FencBaseline:
    """The first design of csrc/floor_encode.cu (one lane walks the wrap,
    the blob copied whole into each block: `git show e7acfc3:vorbis_tpu_
    torch/csrc/floor_encode.cu`), built from `source` under its own
    library name, called on this design's blob and inputs for timing in
    turns; any other source is refused (its hash differs)."""

    def __init__(self, source):
        import ctypes
        import hashlib
        from pathlib import Path
        from vorbis_tpu_torch.native import build_library
        from vorbis_tpu_torch.ops import floor_cuda, floor_encode_cuda
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()
        if digest != FENC_BASELINE_SHA256:
            raise RuntimeError(f"--floor-encode-baseline {source} is not "
                               f"commit e7acfc3's floor_encode.cu (sha256 "
                               f"{digest})")
        so, _ = build_library(Path(source), floor_cuda.nvcc,
                              floor_cuda.NVCC_FLAGS,
                              "libfloorencode_baseline")
        self.fn = ctypes.CDLL(str(so)).vtt_floor_encode
        ours = floor_encode_cuda.load_library().vtt_floor_encode
        self.fn.restype, self.fn.argtypes = ours.restype, ours.argtypes

    def __call__(self, cfg, posts, used):
        import torch
        t = cfg.floor_enc
        B = posts.shape[0]
        out = (torch.empty((B, t.n), dtype=torch.float32, device="cuda"),
               torch.empty((B, t.fc), dtype=torch.int64, device="cuda"),
               torch.empty((B, t.fc), dtype=torch.int32, device="cuda"))
        rc = self.fn(posts.data_ptr(), used.data_ptr(), t.blob.data_ptr(),
                     t.blob.numel(), *(x.data_ptr() for x in out), B, t.P,
                     torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline floor_encode launch failed: {rc}")
        return out


# sha256 of the first design of csrc/tone_mask.cu (commit c40e5f8): its C
# entry point vtt_tone_mask takes G, T and W where this design's takes the
# header, and it finds its tables in this design's blob through the
# header's first 24 words
TONE_BASELINE_SHA256 = ("74e39f5b10d906dacf9cb2596a288d31f9777f0c4e45115e"
                        "25e5b8e619f4223d")


def _tone_call(fn, tm, logfft, gspec, lspec, *extra):
    """tone (R, n) of one call of this design's vtt_tone_mask entry point
    `fn` (the library's, or a timing build's, whose `extra` is the
    stamps' pointer) on the look's blob and header, on the current
    stream."""
    import torch
    out = torch.empty_like(logfft)
    rc = fn(logfft.data_ptr(), gspec.data_ptr(), lspec.data_ptr(),
            tm.blob.data_ptr(), tm.blob_head.ctypes.data, tm.blob.numel(),
            out.data_ptr(), logfft.shape[0],
            torch.cuda.current_stream().cuda_stream, *extra)
    if rc != 0:
        raise RuntimeError(f"tone mask launch failed: cudaError {rc}")
    return out


def _tone_call_baseline(fn, tm, logfft, gspec, lspec, *extra):
    """As _tone_call for the first design's entry point (G, T, W in
    place of the header)."""
    import torch
    out = torch.empty_like(logfft)
    rc = fn(logfft.data_ptr(), gspec.data_ptr(), lspec.data_ptr(),
            tm.blob.data_ptr(), tm.blob.numel(), *tm.blob_dims,
            out.data_ptr(), logfft.shape[0],
            torch.cuda.current_stream().cuda_stream, *extra)
    if rc != 0:
        raise RuntimeError(f"baseline tone mask launch failed: "
                           f"cudaError {rc}")
    return out


def _tone_lib(source, stem, argtypes, flags=()):
    """vtt_tone_mask of `source` built under its own library name with
    the port's nvcc flags and `flags`."""
    import ctypes
    from vorbis_tpu_torch.native import build_library
    from vorbis_tpu_torch.ops import floor_cuda
    so, _ = build_library(source, floor_cuda.nvcc,
                          (*floor_cuda.NVCC_FLAGS, *flags), stem)
    fn = ctypes.CDLL(str(so)).vtt_tone_mask
    fn.restype, fn.argtypes = ctypes.c_int, argtypes
    return fn


def _tone_argtypes(baseline=False, stamps=False):
    """vtt_tone_mask's ctypes arguments: this design's or the first
    design's, with the timing build's stamps last where asked."""
    import ctypes
    p, i = ctypes.c_void_p, ctypes.c_int
    head = [p] * 4 + [i] * 4 if baseline else [p] * 5 + [i]
    return head + [p, i, p] + [p] * stamps


# the stamps a warp of a timing build: a phase's start (after the barrier
# before it) and end (before the barrier after it), six phases each
TONE_STAMPS = 12
TONE_PHASES = ("group max", "groups and scan", "deposits", "chase",
               "windows", "store")
TONE_PHASES_BASELINE = ("init", "group max", "groups and deposits",
                        "chase", "windows", "store")


class _ToneBaseline:
    """The first design of csrc/tone_mask.cu (a thread a group walks its
    deposits, a thread a window its lines: `git show c40e5f8:vorbis_tpu_
    torch/csrc/tone_mask.cu`), built from `source` under its own library
    name, called on this design's blob (the header's first 24 words are
    its layout) for timing in turns; any other source is refused (its
    hash differs).  `timing()` builds it with a clock64 stamp a warp
    before and after each of its five barriers and at its start and end,
    inserted into a copy of its text, as this design's timing build
    stamps its phases."""

    def __init__(self, source):
        import hashlib
        from pathlib import Path
        self.source = Path(source)
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()
        if digest != TONE_BASELINE_SHA256:
            raise RuntimeError(f"--tone-mask-baseline {source} is not "
                               f"commit c40e5f8's tone_mask.cu (sha256 "
                               f"{digest})")
        self.fn = _tone_lib(self.source, "libtonemask_baseline",
                            _tone_argtypes(baseline=True))

    def __call__(self, tm, logfft, gspec, lspec):
        return _tone_call_baseline(self.fn, tm, logfft, gspec, lspec)

    def timing(self):
        """The stamped copy's vtt_tone_mask: its last argument the
        stamps (TONE_STAMPS int64 a warp a row)."""
        import ctypes
        stamp = "VTT_STAMP();"
        lib = _stamped_library(self.source, [
            ("float* __restrict__ out) {\n  extern __shared__ int smem[];",
             "float* __restrict__ out, long long* __restrict__ stamps) {\n"
             "  extern __shared__ int smem[];\n  int vtt_st = 0;\n  "
             + stamp, 1),
            ("  __syncthreads();", f"  {stamp}\n  __syncthreads();\n  "
             f"{stamp}", 5),
            ("\n}\n\nsize_t smem_bytes", f"\n  {stamp}\n}}\n\n"
             "size_t smem_bytes", 1),
            ("void* stream) {", "void* stream, void* stamps) {", 1),
            ("(const int*)blob, (float*)out);",
             "(const int*)blob, (float*)out, (long long*)stamps);", 1)],
            "tone_mask_c40e5f8_stamped", TONE_STAMPS)
        fn = lib.vtt_tone_mask
        fn.restype = ctypes.c_int
        fn.argtypes = _tone_argtypes(baseline=True, stamps=True)
        return fn


def _tone_phases(call, R):
    """Where a block's time goes, from one call `call(stamps pointer)` of
    a timing build on R rows: for each of the six phases the slowest
    warp's cycles (a warp's start to its end of the phase's work; mean
    over the rows) and the phase's span in the block (the first warp's
    start to the last warp's end; mean), and the block's cycles, start to
    end (mean and median)."""
    import numpy as np
    import torch
    warps = 256 // 32
    st = torch.zeros(R * warps * TONE_STAMPS, dtype=torch.int64,
                     device="cuda")
    call(st.data_ptr())
    torch.cuda.synchronize()
    s = st.view(R, warps, TONE_STAMPS).cpu().numpy()
    slowest, span = [], []
    for k in range(TONE_STAMPS // 2):
        slowest.append(float((s[:, :, 2 * k + 1]
                              - s[:, :, 2 * k]).max(1).mean()))
        span.append(float((s[:, :, 2 * k + 1].max(1)
                           - s[:, :, 2 * k].min(1)).mean()))
    block = s[:, :, -1].max(1) - s[:, :, 0].min(1)
    return dict(slowest=slowest, span=span, block=float(block.mean()),
                block_median=float(np.median(block)))


def _device_profile(fn):
    """(device kernels, their device ms) of one call of fn, from
    torch.profiler's device-side events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return (sum(e.count for e in kern),
            sum(e.self_device_time_total for e in kern) / 1e3)


def _patched(targets, calls):
    """Wrap each (label, object, attribute) of `targets` so that a call
    appends (label, the original, args, kwargs) to `calls`; returns the
    function that undoes it."""
    undo = []
    for label, obj, attr in targets:
        if not hasattr(obj, attr):
            continue
        orig = getattr(obj, attr)
        own = attr in vars(obj)

        def wrap(*a, _l=label, _f=orig, **kw):
            calls.append((_l, _f, a, kw))
            return _f(*a, **kw)

        setattr(obj, attr, wrap)
        undo.append((obj, attr, orig, own))

    def restore():
        for obj, attr, orig, own in reversed(undo):
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
    return restore


def _record_floor_encode(run, owner=None):
    """floor_encode's calls through `owner` (a module that imports it;
    ops/encdevice.py, the finish's, by default) while run() encodes:
    [(cfg, posts, used)] of each floor config's first call, in call
    order."""
    if owner is None:
        from vorbis_tpu_torch.ops import encdevice as owner
    calls = []
    restore = _patched([("floor encode", owner, "floor_encode")], calls)
    try:
        run()
    finally:
        restore()
    first = {}
    for _, _, (cfg, posts, used), _ in calls:
        first.setdefault(id(cfg), (cfg, posts, used))
    return list(first.values())


def _fenc_check(name, cfg, posts, used):
    """floor_encode's kernel against its plain version on the card,
    bitwise (the curve by bit pattern), the wrapped posts too; returns
    the largest difference."""
    import torch
    from vorbis_tpu_torch.ops.floor_encode_cuda import (floor_encode,
                                                        floor_encode_plain)
    got = floor_encode(cfg, posts, used, qposts=True)
    want = floor_encode_plain(cfg, posts, used, qposts=True)
    torch.cuda.synchronize()
    same = [torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            ] + [torch.equal(g, w) for g, w in zip(got[1:], want[1:])]
    err = max(float((g.double() - w.double()).abs().max())
              if g.numel() else 0.0 for g, w in zip(got, want))
    t = cfg.floor_enc
    print(f"[floor encode] {name}: B={posts.shape[0]} P={t.P} n={t.n} "
          f"FC={t.fc}: curve, vals, lens, qposts "
          + ("bitwise equal to the plain version" if all(same) else
             f"DIFFER {same}") + f", max_abs_err {err}")
    if not all(same):
        raise RuntimeError(f"floor encode {name}: kernel != plain")
    return err


def _fenc_path_check(label, recorded, seed):
    """_fenc_check of a path's recorded floor_encode calls
    (_record_floor_encode) and of tests/floor_encode_cases.py's synthetic
    rows at each of their configs; returns the largest difference."""
    import torch
    synthetic = _test_module("floor_encode_cases").synthetic
    if not recorded:
        raise RuntimeError(f"{label}: no floor_encode call recorded")
    err = 0.0
    for k, (c, p, u) in enumerate(recorded):
        name = f"{label} P={c.P} n={c.floor_enc.n}"
        err = max(err, _fenc_check(name, c, p, u))
        sp, su, _ = synthetic(c, seed + k)
        err = max(err, _fenc_check(
            f"{name}, synthetic", c, torch.from_numpy(sp).to(p.device),
            torch.from_numpy(su).to(p.device)))
    return err


# the finish step's stages for the split (ROADMAP 2): (label, where the
# finish step reaches it, attribute); the objects are bound in _split
SPLIT_STAGES = (
    ("noise-mask tail", "psydevice", "noisemask_tail"),
    ("tone mask", "analysis", "tonemask"),
    ("M3", "ctx", "m3_scan"), ("M3", "psydevice", "m3_apply"),
    ("mix", "analysis", "mix_m4_m1"),
    ("floor prepare", "floor_cuda", "floor_prepare"),
    ("floor fit", "floor", "fit"),
    ("floor encode", "encdevice", "floor_encode"),
    ("coupling", "encdevice", "couple_quantize"),
    ("residue encode", "encdevice", "residue_encode"),
    ("pack", "encdevice", "pack_packets"))


# the stateless step's stages in the encoder's order, for phase 5's
# localization: (label, owner, attribute), the owners bound in _staged
STAGES5 = (
    ("spectra and masks (md, logmdct, mask)", "analysis", "full_mask"),
    ("fit posts (posts, used)", "ctx", "floor"),
    ("floor post coding (curve, codewords, lengths)", "encdevice",
     "floor_encode"),
    ("coupled residues (residues, any used)", "encdevice",
     "couple_quantize"),
    ("residue path (classes, VQ and columns: vals, lens)", "encdevice",
     "residue_encode"),
    ("packed bytes (packets, nbits)", "encdevice", "pack_packets"))


def _host(x):
    """x with every tensor in it copied to the host (tuples and lists
    walked); other values as they are."""
    import torch
    if torch.is_tensor(x):
        return x.detach().cpu().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    return x


def _tensors(x):
    import torch
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _tensors(v)]
    return []


def _staged(dev, chunk):
    """One stateless step of `dev` on `chunk`, each STAGES5 stage's calls
    recorded: [(label, inputs, outputs)] on the host, in call order."""
    from vorbis_tpu_torch.ops import encdevice
    owners = dict(analysis=dev.ctx.analysis, ctx=dev.ctx,
                  encdevice=encdevice, dev=dev)
    rec, undo = [], []
    for label, o, attr in STAGES5:
        obj = owners[o]
        if not hasattr(obj, attr):
            continue
        orig = getattr(obj, attr)

        def wrap(*a, _l=label, _f=orig, **kw):
            out = _f(*a, **kw)
            rec.append((_l, _host((a, kw)), _host(out)))
            return out

        undo.append((obj, attr, orig, attr in vars(obj)))
        setattr(obj, attr, wrap)
    try:
        dev.get_step()(chunk)
    finally:
        for obj, attr, orig, own in reversed(undo):
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
    return rec


def _localize(dev_card, dev_cpu, chunk_card, chunk_cpu, f, F):
    """Where the card's and the CPU's packet (frame) f of a stateless step
    part: for each stage, in the encoder's order, how many output
    elements differ in the packet's rows and over the batch, the largest
    difference and whether its inputs were equal; then the first stage
    whose outputs differ in the packet's rows, with its size.  A floor
    post coding that differs on equal inputs is a fault and raises."""
    import torch
    card, cpu = _staged(dev_card, chunk_card), _staged(dev_cpu, chunk_cpu)
    ch = dev_cpu.ch
    first = None
    for (label, a_in, a_out), (_, b_in, b_out) in zip(card, cpu):
        outs = list(zip(_tensors(a_out), _tensors(b_out)))
        same_in = all(torch.equal(x, y) for x, y in zip(_tensors(a_in),
                                                        _tensors(b_in)))
        parts, in_packet = [], 0
        for x, y in outs:
            ne = x != y
            lead = ne.shape[0] if ne.dim() else 1
            pk = (ne[f * ch:(f + 1) * ch] if lead == F * ch else
                  ne[f:f + 1] if lead == F else ne)
            in_packet += int(pk.sum())
            big = (float((x.double() - y.double()).abs().max())
                   if x.numel() and x.dtype != torch.bool else 0.0)
            parts.append(f"{tuple(x.shape)}: {int(pk.sum())} in the packet's "
                         f"rows, {int(ne.sum())} of {x.numel()} over the "
                         f"batch, max |diff| {big:.6g}")
        print(f"[card-vs-cpu] packet {f} of {F}, {label}: inputs "
              f"{'equal' if same_in else 'differ'}; " + "; ".join(parts))
        if in_packet and first is None:
            first = label
            if same_in and label.startswith(("floor post coding",
                                             "residue path",
                                             "packed bytes")):
                raise RuntimeError(f"5: the {label.split(' (')[0]} differs "
                                   f"card against CPU on equal inputs")
    print(f"[card-vs-cpu] packet {f}: the first stage that differs in its "
          f"rows is {first}")
    return first


def _split(fe, W, step, args, smi):
    """One recorded finish batch split by stage: the step runs once with
    its stages wrapped (SPLIT_STAGES, from here: the program has no
    switch for it), then each stage alone on its recorded inputs under
    torch.profiler (device kernels, device ms) and timed with CUDA
    events (ms a call, the host's issue included), the whole step
    likewise, with the kernels, with the floor's plain trio in the
    floor-encode kernel's place, with the residue path's plain trio in
    the residue kernel's place, with the plain tone mask in the
    tone-mask kernel's place, with the plain prepare and the packer's
    plain duo (merge_columns and pack_bits) in those kernels' places, and
    with the plain coupling in the coupling kernel's place.  Returns
    ({stage: (kernels, device ms, ms)}, {stage: its recorded call's
    arguments}: the floor_encode call's (cfg, posts, used), the tone
    mask's (DeviceToneMask, logfft, global, local), the residue_encode
    call's (cfg, res, used), the packer's (tabs, vals, lens, wb), the
    prepare's (fit, logmdct, logmask) and the coupling's ((dev, md,
    curve, used, F), keyword arguments))."""
    import torch
    from vorbis_tpu_torch.ops import encdevice, floor_cuda, psydevice
    from vorbis_tpu_torch.ops.couple_cuda import couple_quantize_plain
    from vorbis_tpu_torch.ops.floor_encode_cuda import floor_encode_plain
    from vorbis_tpu_torch.ops.pack_cuda import pack_packets_plain
    from vorbis_tpu_torch.ops.residue_encode_cuda import (
        residue_encode_plain)
    from vorbis_tpu_torch.ops.tone_mask_cuda import tone_mask_plain
    ctx = fe.ctx(W)
    owners = dict(psydevice=psydevice, encdevice=encdevice, ctx=ctx,
                  analysis=ctx.analysis, dev=fe._dev_for(W),
                  floor_cuda=floor_cuda, floor=ctx.floor)
    calls = []
    restore = _patched([(lb, owners[o], a) for lb, o, a in SPLIT_STAGES],
                       calls)
    try:
        step(*args)
        torch.cuda.synchronize()
    finally:
        restore()
    rows = {}
    for label, f, a, kw in calls:
        k, dms = _device_profile(lambda: f(*a, **kw))
        ms = _cuda_ms(lambda: f(*a, **kw), 3)
        r = rows.get(label, (0, 0.0, 0.0))
        rows[label] = (r[0] + k, r[1] + dms, r[2] + ms)
    whole = (*_device_profile(lambda: step(*args)),
             _cuda_ms(lambda: step(*args), 3))
    rows["other"] = tuple(w - sum(r[i] for r in rows.values())
                          for i, w in enumerate(whole))
    rec = {}
    for label, _, a, _ in calls:
        rec.setdefault(label, a)
    tm, targs = next((f, a) for lb, f, a, _ in calls if lb == "tone mask")
    rec["tone mask"] = (tm, *targs)
    ca, ckw = next((a, kw) for lb, _, a, kw in calls if lb == "coupling")
    rec["coupling"] = (ca, ckw)

    def plain_step(swaps):
        """The step's (kernels, device ms, ms) with each (owner,
        attribute) of `swaps` set to its plain version."""
        undo = [(o, at, getattr(o, at)) for (o, at) in swaps]
        for (o, at), fn in swaps.items():
            setattr(o, at, fn)
        try:
            return (*_device_profile(lambda: step(*args)),
                    _cuda_ms(lambda: step(*args), 3))
        finally:
            for o, at, fn in undo:
                setattr(o, at, fn)

    # each kernel's plain version alone, and the step with it in the
    # kernel's place
    for label, plain, call, what, swaps in (
            ("floor encode, plain trio", floor_encode_plain,
             rec["floor encode"], "floor trio",
             {(encdevice, "floor_encode"): floor_encode_plain}),
            ("residue encode, plain trio", residue_encode_plain,
             rec["residue encode"], "residue trio",
             {(encdevice, "residue_encode"): residue_encode_plain}),
            ("tone mask, plain", tone_mask_plain, rec["tone mask"],
             "tone mask", {(ctx.analysis, "tonemask"):
                           lambda *a: tone_mask_plain(tm, *a)}),
            ("floor prepare, plain", floor_cuda.floor_prepare_plain,
             rec["floor prepare"], None, None),
            ("pack, plain duo (merge + pack)", pack_packets_plain,
             rec["pack"], "prepare and packer",
             {(encdevice, "pack_packets"): pack_packets_plain,
              (floor_cuda, "floor_prepare"):
              floor_cuda.floor_prepare_plain}),
            ("coupling, plain", lambda *a: couple_quantize_plain(*a, **ckw),
             ca, "coupling",
             {(encdevice, "couple_quantize"): couple_quantize_plain})):
        rows[label] = (*_device_profile(lambda: plain(*call)),
                       _cuda_ms(lambda: plain(*call), 3))
        if swaps:
            rows[f"step, plain {what}"] = plain_step(swaps)
    rows["step"] = whole
    B = rec["floor encode"][1].shape[0]
    for label in ("floor encode", "tone mask", "residue encode",
                  "floor prepare", "floor fit", "pack", "coupling"):
        if rows[label][0] > 1:
            raise RuntimeError(f"3j W={W}: one {label} call ran "
                               f"{rows[label][0]} device kernels")
        if rows[label][0] != 1:
            print(f"[split] W={W}: the profiler saw {rows[label][0]} "
                  f"device kernels of one {label} launch: the counts "
                  f"below miss some")
    for label, (k, dms, ms) in rows.items():
        print(f"[split] W={W} {B} rows: {label}: {k} device kernels, "
              f"device {dms:.4f} ms, {ms:.4f} ms a call")
    print(f"[split] W={W}: the step with the kernels {whole[0]} device "
          f"kernels ({whole[1]:.4f} ms on the device, {whole[2]:.4f} ms a "
          f"call); " + "; ".join(
              f"with the plain {key[len('step, plain '):]} {r[0]} "
              f"({r[1]:.4f} ms, {r[2]:.4f} ms)" for key, r in rows.items()
              if key.startswith("step, plain")) + f" ({smi})")
    rows["graph"] = _step_graphs(W, step, args, smi)
    return rows, rec


def _step_graph(step, args):
    """The finish step captured in one CUDA graph on static copies of its
    inputs (ROADMAP 2.16): -> (graph, its outputs, the eager step's
    outputs on the same inputs)."""
    import torch
    static = [x.clone() if torch.is_tensor(x) else x for x in args]
    eager = step(*static)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(*static)
    graph.replay()
    torch.cuda.synchronize()
    return graph, out, eager, static


def _step_graphs(W, step, args, smi):
    """ROADMAP 2.16: the recorded finish step in one CUDA graph, with the
    kernels, with the residue path's plain trio in the residue kernel's
    place, with the plain prepare and packer in those kernels' places and
    with the plain coupling in the coupling kernel's place:
    the replay's packets and bit counts bitwise against the eager step's,
    and the eager step's and the replay's ms a call in turns (median of
    three rounds each).  A step that cannot be captured raises."""
    import torch
    from vorbis_tpu_torch.ops import encdevice, floor_cuda
    from vorbis_tpu_torch.ops.couple_cuda import couple_quantize_plain
    from vorbis_tpu_torch.ops.pack_cuda import pack_packets_plain
    from vorbis_tpu_torch.ops.residue_encode_cuda import (
        residue_encode_plain)
    out = {}
    for label, swaps in (
            ("kernels", {}),
            ("plain residue trio", {(encdevice, "residue_encode"):
                                    residue_encode_plain}),
            ("plain prepare and packer",
             {(encdevice, "pack_packets"): pack_packets_plain,
              (floor_cuda, "floor_prepare"):
              floor_cuda.floor_prepare_plain}),
            ("plain coupling", {(encdevice, "couple_quantize"):
                                couple_quantize_plain})):
        undo = [(o, at, getattr(o, at)) for (o, at) in swaps]
        for (o, at), fn in swaps.items():
            setattr(o, at, fn)
        try:
            graph, got, want, static = _step_graph(step, args)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            if not same:
                raise RuntimeError(f"3j W={W}: the CUDA graph's packets "
                                   f"differ from the eager step's ({label})")
            eager, replay = [], []
            for _ in range(3):
                eager.append(_cuda_ms(lambda: step(*static), 3))
                replay += [_cuda_ms(graph.replay, 10),
                           _cuda_ms(graph.replay, 10)]
                eager.append(_cuda_ms(lambda: step(*static), 3))
        finally:
            for o, at, fn in undo:
                setattr(o, at, fn)
        e, r = _med(eager)[0], _med(replay)[0]
        print(f"[graph] W={W}, the step with the {label}: eager {e:.4f} ms "
              f"a call, one CUDA graph {r:.4f} ms a replay (medians of "
              f"{len(eager)}, {len(replay)}), packets and bit counts bitwise "
              f"equal to the eager step's ({smi})")
        out[label] = dict(eager_ms=e, graph_ms=r, eager_rounds_ms=eager,
                          graph_rounds_ms=replay)
        del graph
    return out


def _phase_floor_encode(fsw, fm, f51, smi, baseline=None, report=""):
    """Phase 3j: the floor's post coding (csrc/floor_encode.cu) against
    its plain version, bitwise, on the inputs the main path gives it: a
    recorded long finish batch of 4d's click train (2,048 frames, 4,096
    rows) and a short one (256 frames, 512 rows), their first 1 and 3
    rows, the managed encoder's stacked 15-blob rows (long and short),
    the 5.1 encoder's three looks, phase 8's 16 and 32 kHz looks, and
    tests/floor_encode_cases.py's synthetic rows at every one of those
    looks, and a dense look of 65 posts over n = 128 (synthetic and 4,096
    random rows); the build's registers (`report`, nvcc's ptxas lines), shared
    memory a block and blocks an SM; its time at the two 4d batches
    (CUDA graphs, median and spread of six; in turns with the first
    design where `baseline`, a _FencBaseline, is given, whose outputs must
    equal this design's), its bound and share, the plain trio's time and
    device kernels; and the two 4d batches split by stage (_split).
    Returns the kernel's record for the JSON line, the tone-mask calls
    recorded on the way for phase 3k: [(label, DeviceToneMask, logfft,
    global, local)] of the two 4d batches and each look's first call in
    the managed, 5.1, 16 and 32 kHz runs, the residue calls for phase
    3l: [(label, cfg, res, used)] of the two 4d batches and each residue
    config's first call in the same runs, the packer's calls for phase
    3m: [(label, tabs, vals, lens, wb)], the prepare's for phase 3n:
    [(label, fit, logmdct, logmask)], each plan's or look's first, and
    the coupling's for phase 3o: [(label, (dev, md, curve, used, F),
    keyword arguments)] of the two 4d batches and each stereo config's
    first call in the managed, 16 and 32 kHz runs."""
    import numpy as np
    import torch
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    from vorbis_tpu_torch.ops import encdevice, floor_cuda, torchdsp
    from vorbis_tpu_torch.ops.floor_encode_cuda import (floor_encode,
                                                        floor_encode_plain)
    synthetic = _test_module("floor_encode_cases").synthetic
    # 4d's click train: the finish step and arguments of the first long
    # batch (B_long = 2048) and the first short one (B_short = 256)
    steps = {}
    step_of = fsw._finish_step

    def spy(W, B, wb=None):
        step = step_of(W, B, wb)

        def rec(*a):
            steps.setdefault(W, (step, a))
            return step(*a)
        return rec

    fsw._finish_step = spy
    try:
        fsw.encode_batch([torch.from_numpy(_click_train(30, 44100, k))
                          .cuda() for k in range(3)])
    finally:
        del fsw._finish_step
    split, cases, tone_cases, res_cases = {}, [], [], []
    pack_cases, prep_cases, cpl_cases = [], [], []
    for W, label in ((1, "4d long batch"), (0, "4d short batch")):
        step, a = steps[W]
        split[label], got = _split(fsw, W, step, a, smi)
        cases.append((label, *got["floor encode"]))
        tone_cases.append((label, *got["tone mask"]))
        res_cases.append((label, *got["residue encode"]))
        pack_cases.append((label, *got["pack"]))
        prep_cases.append((label, *got["floor prepare"]))
        cpl_cases.append((label, *got["coupling"]))
    cfg, posts, used = cases[0][1:]
    if posts.shape[0] != 4096 or cases[1][2].shape[0] != 512:
        raise RuntimeError(f"4d batches of {posts.shape[0]} and "
                           f"{cases[1][2].shape[0]} rows")
    cases += [("4d long batch, first rows", cfg, posts[:b].contiguous(),
               used[:b].contiguous()) for b in (1, 3)]
    # the managed stacked rows, the 5.1 looks, phase 8's 16 and 32 kHz
    for label, run in (
            ("managed", lambda: fm.encode_managed_batch(
                [torch.from_numpy(_click_train(10, 44100, 3)).cuda()],
                B_long=256, B_short=256)),
            ("5.1", lambda: f51.encode_batch([torch.from_numpy(
                _click_train51(5, 48000, 0)).cuda()])),
            ("16 kHz", lambda: FastEncoder(2, 16000, 0.5).encode(
                _gate_signal("mix", 16000, 1.0, 2))),
            ("32 kHz", lambda: FastEncoder(2, 32000, 0.5).encode(
                _gate_signal("mix", 32000, 1.0, 2)))):
        tcalls = []
        restore = _patched([("tone mask", torchdsp.DeviceToneMask,
                             "__call__"),
                            ("residue encode", encdevice, "residue_encode"),
                            ("pack", encdevice, "pack_packets"),
                            ("floor prepare", floor_cuda, "floor_prepare"),
                            ("coupling", encdevice, "couple_quantize")],
                           tcalls)
        try:
            recorded = _record_floor_encode(run)
        finally:
            restore()
        first = {k: {} for k in ("tone mask", "residue encode", "pack",
                                 "floor prepare")}
        cfirst = {}
        for lb, _, (obj, *targs), kw in tcalls:
            # a look's, a config's or a plan's first call
            if lb == "coupling":
                cfirst.setdefault(id(obj), ((obj, *targs), kw))
            else:
                first[lb].setdefault(id(obj), (obj, *targs))
        cpl_cases += [(f"{label} n={a[0].n}", a, kw)
                      for a, kw in cfirst.values()]
        tone_cases += [(f"{label} n={v[0].look.n}", *v)
                       for v in first["tone mask"].values()]
        rfirst = first["residue encode"]
        res_cases += [(f"{label} {_res_name(v[0])}", *v)
                      for v in rfirst.values()]
        pack_cases += [(f"{label} C={v[0].n_cols}", *v)
                       for v in first["pack"].values()]
        prep_cases += [(f"{label} P={v[0].posts} n={v[0].n}", *v)
                       for v in first["floor prepare"].values()]
        if label == "5.1" and sorted(c.P for c, _, _ in recorded) \
                != [2, 2, 13, 29]:
            raise RuntimeError(f"5.1 floor configs "
                               f"{[c.P for c, _, _ in recorded]}")
        if label == "5.1" and sorted(c.res_enc.type for c, *_ in
                                     rfirst.values()) != [1, 1, 2, 2]:
            raise RuntimeError(f"5.1 residue configs {len(rfirst)}")
        cases += [(f"{label} P={c.P} n={c.floor_enc.n}", c, p, u)
                  for c, p, u in recorded]
    err = 0.0
    seen = {}
    for name, c, p, u in cases:
        err = max(err, _fenc_check(name, c, p, u))
        seen.setdefault(id(c), (name, c))
    for k, (name, c) in enumerate(seen.values()):
        sp, su, _ = synthetic(c, 100 + k)
        err = max(err, _fenc_check(
            f"{name.split(',')[0]}, synthetic", c,
            torch.from_numpy(sp).cuda(), torch.from_numpy(su).cuda()))
    # a dense look (65 posts over n = 128): used posts one bin apart
    dense = _test_module("floor_encode_cases").dense_config(16, "cuda")
    sp, su, _ = synthetic(dense, 116)
    rng = np.random.RandomState(16)
    rp = (rng.randint(0, 1024, (4096, 65))
          | np.where(rng.rand(4096, 65) < 0.3, 0x8000, 0)).astype(np.int32)
    for label, p_, u_ in (("synthetic", sp, su),
                          ("random", rp, rng.rand(4096) < 0.9)):
        err = max(err, _fenc_check(
            f"dense look, {label}", dense, torch.from_numpy(p_).cuda(),
            torch.from_numpy(u_).cuda()))
    import ctypes
    from vorbis_tpu_torch.ops.floor_encode_cuda import load_library
    per_sm = load_library().vtt_floor_encode_blocks_per_sm
    per_sm.restype, per_sm.argtypes = ctypes.c_int, [ctypes.c_int,
                                                      ctypes.c_void_p]
    build = _build_lines(report)
    rec = {}
    for name, c, p, u in cases[:2]:
        smem = ctypes.c_int(0)
        blocks = per_sm(c.floor_enc.shared, ctypes.byref(smem))
        print(f"[floor encode] {name}: build {build or 'cached'}; "
              f"{smem.value} bytes of shared memory a block "
              f"({c.floor_enc.shared} table words), {blocks} blocks an SM")
        mine = (lambda c=c, p=p, u=u: floor_encode(c, p, u))
        theirs = None
        if baseline is not None:
            theirs = (lambda c=c, p=p, u=u: baseline(c, p, u))
            same = [torch.equal(a, b) for a, b in zip(theirs(), mine())]
            torch.cuda.synchronize()
            if not all(same):
                raise RuntimeError(f"3j {name}: the first design's outputs "
                                   f"differ from this one's {same}")
        t, tb = _turns(mine, theirs)
        ms, lo, hi = _med(t)
        plain_k, plain_dev = _device_profile(
            lambda: floor_encode_plain(c, p, u))
        plain_ms = _cuda_ms(lambda: floor_encode_plain(c, p, u), 3)
        bound_ms, by, nb, io, fo = _fenc_bound(c, p.shape[0])
        print(f"[floor encode] {name} B={p.shape[0]}: kernel {ms:.5f} ms "
              f"(CUDA graphs; median of {len(t)}, {lo:.5f}-{hi:.5f}); "
              f"bound {bound_ms * 1e3:.3f} us by {by} ({nb} bytes, {io} "
              f"int32 + {fo} float32 operations), share "
              f"{100 * bound_ms / ms:.1f}%; plain trio {plain_ms:.4f} ms a "
              f"call, {plain_k} device kernels ({plain_dev:.4f} ms on the "
              f"device); library call: none ({smi})")
        base = {}
        if tb:
            bms, blo, bhi = _med(tb)
            print(f"[floor encode] {name}: in turns, the first design "
                  f"(e7acfc3) {bms:.5f} ms ({blo:.5f}-{bhi:.5f}), share "
                  f"{100 * bound_ms / bms:.1f}%, against this design's "
                  f"{ms:.5f} ms ({100 * bound_ms / ms:.1f}%), outputs "
                  f"equal ({smi})")
            base = dict(baseline_ms=bms, baseline_rounds_ms=tb,
                        baseline_share=bound_ms / bms)
        rec[name] = dict(rows=p.shape[0], P=c.P, n=c.floor_enc.n,
                         ms=ms, rounds_ms=t, plain_ms=plain_ms,
                         plain_kernels=plain_k, bound_ms=bound_ms,
                         bound_by=by, share=bound_ms / ms,
                         shared_bytes=smem.value, blocks_per_sm=blocks,
                         **base,
                         split={k: list(v) if isinstance(v, tuple) else v
                                for k, v in split[name].items()})
    main = rec["4d long batch"]
    return dict({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by")},
                max_abs_err=err, library_ms=None, at_long=main,
                at_short=rec["4d short batch"]), tone_cases, res_cases, \
        pack_cases, prep_cases, cpl_cases


# The tone mask's own arithmetic, whatever a kernel's schedule: float32
# operations
#  - a row: the attenuation's add and max, 2;
#  - a bin: its group's max, the ATH floor's add and the final max, 3;
#  - a group: the audibility's add and compare, the level's add,
#    subtract and multiply, its window's finiteness test and clamp, 7
#    (and the level's conversion and two clamps, 3 int32);
#  - a deposit, counted on this run's data (seed_deposits): the curve's
#    add and the max, 2;
#  - the chase: a max for each of the linesper - 1 lines below a line;
#  - a window: a min for each of its lines past the first.
F32_TM_PER_ROW, F32_TM_PER_BIN, F32_TM_PER_GROUP = 2, 3, 7
OPS_TM_PER_GROUP, F32_TM_PER_DEPOSIT = 3, 2


def _tone_bound(tm, logfft, gspec, lspec):
    """(bound ms, bound_by, bytes, int32 ops, float32 ops) of one tone_mask
    call: logfft and the maxima read once, the tone written once, the blob
    read once; the function's operations as counted above."""
    from vorbis_tpu_torch.ops.tone_mask_cuda import (blob_tables,
                                                     seed_deposits)
    R, n = logfft.shape
    tb = blob_tables(tm.blob)
    G, T_, lp = tb["G"], tb["T"], tb["linesper"]
    chase = T_ * (lp - 1) - lp * (lp - 1) // 2
    wmins = int((tb["win_hi"] - tb["win_lo"]).sum())
    nbytes = R * (2 * n * 4 + 2 * 4) + tm.blob.numel() * 4
    int_ops = R * G * OPS_TM_PER_GROUP
    f32_ops = (R * (F32_TM_PER_ROW + n * F32_TM_PER_BIN
                    + G * F32_TM_PER_GROUP + chase + wmins)
               + F32_TM_PER_DEPOSIT * seed_deposits(tm, logfft, gspec, lspec))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, int_ops, f32_ops)


def _tone_check(name, tm, logfft, gspec, lspec):
    """tone_mask's kernel against its plain version on the card, by bit
    pattern; returns the largest difference."""
    import torch
    from vorbis_tpu_torch.ops.tone_mask_cuda import (tone_mask,
                                                     tone_mask_plain)
    got = tone_mask(tm, logfft, gspec, lspec)
    want = tone_mask_plain(tm, logfft, gspec, lspec)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    err = float((got.double() - want.double()).abs().max())
    print(f"[tone mask] {name}: {tuple(logfft.shape)} rows x bins, "
          f"T={tm.total} G={tm.n_groups} W={tm.blob_dims[2]}: "
          + ("bitwise equal to the plain version" if same else "DIFFERS")
          + f", max_abs_err {err}")
    if not same:
        raise RuntimeError(f"tone mask {name}: kernel != plain")
    return err


def _phase_tone_mask(cases, smi, report="", baseline=None):
    """Phase 3k: the tone mask (csrc/tone_mask.cu) against its plain
    version, bitwise, on the calls 3j recorded (`cases`: 4d's long and
    short finish batch, the managed step's, the 5.1 looks', phase 8's 16
    and 32 kHz looks) and on tests/tone_mask_cases.py's seeded, edge and
    stress rows at each of those looks; the build's registers (`report`),
    shared memory a block and blocks an SM; its time at the two 4d
    batches (CUDA graphs, median and spread of six; in turns with the
    first design where `baseline`, a _ToneBaseline, is given, whose
    output must equal this design's), its bound and share, the plain
    version's time and device kernels (no single library call computes
    it); and where a block's time goes at the two batches (_tone_phases
    of the timing build, and of the baseline's stamped copy).  Returns the kernel's
    record for the JSON line."""
    import ctypes
    import torch
    from vorbis_tpu_torch.ops.tone_mask_cuda import (SOURCE, load_library,
                                                     tone_mask,
                                                     tone_mask_plain)
    tmc = _test_module("tone_mask_cases")
    err, looks = 0.0, {}
    for name, tm, lf, g, l in cases:
        err = max(err, _tone_check(name, tm, lf, g, l))
        looks.setdefault(id(tm), (name, tm))
    for k, (name, tm) in enumerate(looks.values()):
        for rows, host in (("seeded and edge", tmc.inputs(tm.look.n, 300 + k,
                                                          251)),
                           ("stress", tmc.stress_rows(tm))):
            err = max(err, _tone_check(
                f"{name}, {rows} rows", tm,
                *(torch.from_numpy(a).cuda() for a in host)))
    per_sm = load_library().vtt_tone_mask_blocks_per_sm
    build = _build_lines(report)
    timed = _tone_lib(SOURCE, "libtonemask_timing",
                      _tone_argtypes(stamps=True), ("-DVTT_TONE_TIMING",))
    btimed = baseline.timing() if baseline is not None else None
    rec = {}
    for name, tm, lf, g, l in cases[:2]:
        smem = ctypes.c_int(0)
        blocks = per_sm(tm.blob_head.ctypes.data, ctypes.byref(smem))
        mine = (lambda tm=tm, lf=lf, g=g, l=l: tone_mask(tm, lf, g, l))
        theirs = None
        if baseline is not None:
            theirs = (lambda tm=tm, lf=lf, g=g, l=l: baseline(tm, lf, g, l))
            same = torch.equal(theirs().view(torch.int32),
                               mine().view(torch.int32))
            torch.cuda.synchronize()
            if not same:
                raise RuntimeError(f"3k {name}: the first design's output "
                                   f"differs from this one's")
        t, tb = _turns(mine, theirs)
        ms, lo, hi = _med(t)
        plain_k, plain_dev = _device_profile(
            lambda: tone_mask_plain(tm, lf, g, l))
        plain_ms = _cuda_ms(lambda: tone_mask_plain(tm, lf, g, l), 3)
        bound_ms, by, nb, io, fo = _tone_bound(tm, lf, g, l)
        print(f"[tone mask] {name}: build {build or 'cached'}; "
              f"{smem.value} bytes of shared memory a block, {blocks} "
              f"blocks an SM")
        print(f"[tone mask] {name} {lf.shape[0]} rows of n={lf.shape[1]}: "
              f"kernel {ms:.5f} ms (CUDA graphs; median of {len(t)}, "
              f"{lo:.5f}-{hi:.5f}); bound {bound_ms * 1e3:.3f} us by {by} "
              f"({nb} bytes, {io} int32 + {fo} float32 operations), share "
              f"{100 * bound_ms / ms:.1f}%; plain {plain_ms:.4f} ms a call, "
              f"{plain_k} device kernels ({plain_dev:.4f} ms on the "
              f"device); library call: none ({smi})")
        extra = {}
        if tb:
            bms, blo, bhi = _med(tb)
            print(f"[tone mask] {name}: in turns, the first design (c40e5f8) "
                  f"{bms:.5f} ms ({blo:.5f}-{bhi:.5f}), share "
                  f"{100 * bound_ms / bms:.1f}%, against this design's "
                  f"{ms:.5f} ms ({100 * bound_ms / ms:.1f}%), "
                  f"{bms / ms:.2f}x, outputs equal ({smi})")
            extra = dict(baseline_ms=bms, baseline_rounds_ms=tb,
                         baseline_share=bound_ms / bms)
        for label, fn, call, names in (
                ("this design", timed, _tone_call, TONE_PHASES),
                ("the first design", btimed, _tone_call_baseline,
                 TONE_PHASES_BASELINE)):
            if fn is None:
                continue
            ph = _tone_phases(lambda p, fn=fn, call=call, tm=tm, lf=lf, g=g,
                              l=l: call(fn, tm, lf, g, l, p), lf.shape[0])
            print(f"[tone mask] {name}, {label}: a block {ph['block']:.0f} "
                  f"cycles (median {ph['block_median']:.0f}); a phase, the "
                  f"slowest warp / the block's span: " + ", ".join(
                      f"{n} {w:.0f} / {sp:.0f}" for n, w, sp in
                      zip(names, ph["slowest"], ph["span"]))
                  + f" (timing build, clock64; {smi})")
            extra["phases" if fn is timed else "baseline_phases"] = dict(
                ph, names=list(names))
        rec[name] = dict(rows=lf.shape[0], n=lf.shape[1], ms=ms,
                         rounds_ms=t, plain_ms=plain_ms,
                         plain_kernels=plain_k, plain_device_ms=plain_dev,
                         bound_ms=bound_ms, bound_by=by,
                         share=bound_ms / ms, shared_bytes=smem.value,
                         blocks_per_sm=blocks, **extra)
    main = rec["4d long batch"]
    return dict({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "share")},
                max_abs_err=err, library_ms=None, at_long=main,
                at_short=rec["4d short batch"])


# -- the residue path: csrc/residue_encode.cu -------------------------------

# The residue path's own arithmetic, whatever a kernel's schedule,
# counted on this run's data:
#  - a value, its class statistic: type 2, the |x| and the max, 2 float32
#    operations; type 1, the conversion, |x|, the max and the sum, 4 int32;
#  - a value at a stage where its partition's class has a book: the
#    offset's subtract and add, 2 float32; the conversion, the divide, the
#    zigzag's compare, subtract and shift, the clamp's two and the index's
#    multiply and add, 10 int32; where a later stage follows, the
#    remainder: the digit's remainder and quotient, the zigzag's three and
#    the conversion, 6 int32, and the multiply and subtract, 2 float32;
#  - a column: its liveness tests and the codeword and length loads, 4
#    int32.
F32_RES_CLASS2, OPS_RES_CLASS1 = 2, 4
F32_RES_STAGE, OPS_RES_STAGE = 2, 10
F32_RES_CARRY, OPS_RES_CARRY = 2, 6
OPS_RES_COL = 4


def _res_name(cfg):
    t = cfg.res_enc
    return (f"type {t.type} nch={t.nch} res_ch={t.res_ch} parts="
            f"{cfg.partvals} RC={t.rc}")


def _res_classes(cfg, res):
    """The partition classes of rows res through the plain classifier of
    cfg's residue path (the plain trio's first stage)."""
    from vorbis_tpu_torch.ops.residue_encode_cuda import classify_rows
    dev = cfg.res_enc.dev
    if cfg.res_type == 2:
        return classify_rows(dev, res, cfg.res_enc.nch, cfg)
    return dev._classify(res, cfg=cfg)


def _res_bound(cfg, res, used):
    """(bound ms, bound_by, bytes, int32 ops, float32 ops) of one
    residue_encode call: each row's partitions read once, used read once,
    the columns written once (int64 values, int32 lengths), the blob read
    once; the operations as counted above, the stages' on this run's
    classes."""
    import numpy as np
    t = cfg.res_enc
    R, L = res.shape
    F = used.shape[0]
    span = max(0, min(L - cfg.ri.begin, cfg.partvals * cfg.spp))
    nbytes = R * span * 4 + used.numel() + F * t.rc * 12 \
        + t.blob.numel() * 4
    pw = _res_classes(cfg, res).cpu().numpy()
    has = np.array([[d is not None for d in row] for row in cfg.res_books])
    act = has[:, pw].reshape(cfg.stages, -1).sum(1)   # (stages,)
    vals = R * cfg.partvals * cfg.spp
    staged = int(act.sum()) * cfg.spp
    carried = int(act[:-1].sum()) * cfg.spp
    f32_ops = (vals * F32_RES_CLASS2 if t.type == 2 else 0) \
        + staged * F32_RES_STAGE + carried * F32_RES_CARRY
    int_ops = (vals * OPS_RES_CLASS1 if t.type == 1 else 0) \
        + staged * OPS_RES_STAGE + carried * OPS_RES_CARRY \
        + F * t.rc * OPS_RES_COL
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, int_ops, f32_ops)


def _res_check(name, cfg, res, used):
    """residue_encode's kernel against its plain version on the card,
    values and lengths bitwise; returns the largest difference."""
    import torch
    from vorbis_tpu_torch.ops.residue_encode_cuda import (
        residue_encode, residue_encode_plain)
    got = residue_encode(cfg, res, used)
    want = residue_encode_plain(cfg, res, used)
    torch.cuda.synchronize()
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    err = max(float((g.double() - w.double()).abs().max())
              if g.numel() else 0.0 for g, w in zip(got, want))
    print(f"[residue encode] {name}: {tuple(res.shape)} rows, F="
          f"{used.shape[0]} RC={cfg.res_enc.rc}: vals, lens "
          + ("bitwise equal to the plain version" if all(same) else
             f"DIFFER {same}") + f", max_abs_err {err}")
    if not all(same):
        raise RuntimeError(f"residue encode {name}: kernel != plain")
    return err


# sha256 of the designs before their Hopper redesign (commit f26b635):
# csrc/residue_encode.cu, a thread a (row, partition) then a column a
# thread, and csrc/floor_prepare.cu, a CTA a row
RESIDUE_BASELINE_SHA256 = ("f56d847fdc5f47d63672bef6f612a8c8c433e46a5f803e"
                           "ad3b670520c6c48625")
PREPARE_BASELINE_SHA256 = ("f00ee76910e235fd8395f3eabf9d23f8e3d454f5f4230d"
                           "49ee3db8bc435f2a9d")
# a stamped baseline's phases: the work before each barrier, the wait at
# it, then the work after the last
RESIDUE_PHASES_BASELINE = ("records", "barrier", "classify and VQ",
                           "barrier", "columns")
PREPARE_PHASES_BASELINE = ("quant and above", "barrier", "segment sums",
                           "barrier", "prefix", "barrier", "store")


def _baseline_source(source, sha, flag, commit, name):
    """`source` as a Path, refused unless its sha256 is `sha`."""
    import hashlib
    from pathlib import Path
    digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()
    if digest != sha:
        raise RuntimeError(f"--{flag} {source} is not commit {commit}'s "
                           f"{name} (sha256 {digest})")
    return Path(source)


def _stamped_library(source, edits, stem, nstamps):
    """A copy of the baseline `source` with a clock64 stamp a warp at its
    start, before and after each barrier and at its end (`edits`, [(old,
    new, count)], each `old` found `count` times; VTT_STAMP() in `new`
    writes the warp's next of `nstamps` stamps), built under its own
    library name: its entry point takes the stamps array last."""
    import ctypes
    from vorbis_tpu_torch.native import BUILD_DIR, build_library
    from vorbis_tpu_torch.ops import floor_cuda
    text = source.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"baseline stamps: {old!r} found "
                               f"{text.count(old)} times")
        text = text.replace(old, new)
    macro = ("#define VTT_STAMP() do { if ((threadIdx.x & 31) == 0) "
             "stamps[((size_t)blockIdx.x * (blockDim.x >> 5) + "
             f"(threadIdx.x >> 5)) * {nstamps} + vtt_st] = clock64(); "
             "++vtt_st; } while (0)\n")
    text = text.replace("namespace {", macro + "namespace {", 1)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stamped = BUILD_DIR / f"{stem}.cu"
    stamped.write_text(text)
    so, _ = build_library(stamped, floor_cuda.nvcc, floor_cuda.NVCC_FLAGS,
                          stem)
    return ctypes.CDLL(str(so))


def _stamp_phases(st, blocks, warps, nstamps, frames_a_block):
    """From a stamped baseline's stamps (blocks * warps * nstamps int64):
    each phase's slowest warp (cycles between consecutive stamps, the
    most of a block's warps; mean over the blocks), and a block's cycles,
    its first warp's start to its last warp's end (mean and median), of
    a block of `frames_a_block` frames (or rows)."""
    import numpy as np
    s = st.view(blocks, warps, nstamps).cpu().numpy()
    slowest = [float((s[:, :, k + 1] - s[:, :, k]).max(1).mean())
               for k in range(nstamps - 1)]
    block = s[:, :, -1].max(1) - s[:, :, 0].min(1)
    return dict(slowest=slowest, block=float(block.mean()),
                block_median=float(np.median(block)),
                frames_a_block=frames_a_block)


class _ResidueBaseline:
    """The design of csrc/residue_encode.cu before its Hopper redesign (a
    thread a (row, partition) through every stage, then a column a
    thread: `git show f26b635:vorbis_tpu_torch/csrc/residue_encode.cu`),
    built from `source` under its own library name and called on this
    design's blob (its HEADER and records lead the blob unchanged) for
    timing in turns; any other source is refused (its hash differs).
    `phases` runs a copy stamped at its two barriers."""

    def __init__(self, source):
        import ctypes
        from vorbis_tpu_torch.native import build_library
        from vorbis_tpu_torch.ops import floor_cuda
        self.source = _baseline_source(
            source, RESIDUE_BASELINE_SHA256, "residue-baseline", "f26b635",
            "residue_encode.cu")
        so, _ = build_library(self.source, floor_cuda.nvcc,
                              floor_cuda.NVCC_FLAGS,
                              "libresidueencode_baseline")
        self.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p] * 3)
        self.fn = ctypes.CDLL(str(so)).vtt_residue_encode
        self.fn.restype, self.fn.argtypes = ctypes.c_int, self.argtypes
        self.timed = None

    def __call__(self, cfg, res, used, stamps=None, fn=None):
        import torch
        t = cfg.res_enc
        F = used.shape[0]
        vals = torch.empty((F, t.rc), dtype=torch.int64, device="cuda")
        lens = torch.empty((F, t.rc), dtype=torch.int32, device="cuda")
        head = self.head(t)
        rc = (fn or self.fn)(
            res.data_ptr(), used.data_ptr(), t.blob.data_ptr(),
            head.ctypes.data, F, res.shape[-1], vals.data_ptr(),
            lens.data_ptr(), torch.cuda.current_stream().cuda_stream,
            *([stamps] if stamps is not None else []))
        if rc != 0:
            raise RuntimeError(f"baseline residue_encode launch failed: "
                               f"cudaError {rc}")
        return vals, lens

    # f26b635's header: this design's first 40 words, its word 15 the
    # frames a block (fpb, where this design keeps its unit)
    OLD_WORDS, OLD_FPB = 40, 15

    @classmethod
    def head(cls, t):
        """f26b635's header words for this design's blob: its first 40
        words, fpb as f26b635's pack_blob set it (about 128 phase-1
        threads a block of whole frames)."""
        import numpy as np
        from vorbis_tpu_torch.ops.residue_encode_cuda import H
        h = np.ascontiguousarray(t.head[:cls.OLD_WORDS].copy())
        h[cls.OLD_FPB] = max(1, 128 // int(h[H["per_frame"]]))
        return h

    def geometry(self, t, F, sms):
        """(blocks, threads, frames a block) of f26b635's launch."""
        from vorbis_tpu_torch.ops.residue_encode_cuda import H
        h = self.head(t)
        fpb = min(max(F // (2 * sms), 1), int(h[self.OLD_FPB]))
        threads = max(-(-fpb * int(h[H["per_frame"]]) // 32) * 32, 64)
        return -(-F // fpb), threads, fpb

    def phases(self, cfg, res, used, sms):
        """Each phase's slowest-warp cycles (RESIDUE_PHASES_BASELINE) of
        one call of the stamped copy, its outputs equal to the plain
        build's."""
        import ctypes
        import torch
        stamp = "VTT_STAMP();"
        if self.timed is None:
            lib = _stamped_library(self.source, [
                ("int* __restrict__ lens) {\n",
                 "int* __restrict__ lens, long long* __restrict__ stamps) {\n"
                 f"  int vtt_st = 0;\n  {stamp}\n", 1),
                ("  __syncthreads();", f"  {stamp}\n  __syncthreads();\n  "
                 f"{stamp}", 2),
                ("        lout[j] = l[u];\n      }\n    }\n  }\n}\n",
                 "        lout[j] = l[u];\n      }\n    }\n  }\n"
                 f"  {stamp}\n}}\n", 1),
                ("int* lens, cudaStream_t stream) {",
                 "int* lens, cudaStream_t stream, long long* stamps) {", 1),
                ("g.fpb, vec4, vals, lens);", "g.fpb, vec4, vals, lens, "
                 "stamps);", 1)], "residue_encode_f26b635_stamped", 6)
            self.timed = lib.vtt_residue_encode
            self.timed.restype = ctypes.c_int
            self.timed.argtypes = self.argtypes + [ctypes.c_void_p]
        blocks, threads, fpb = self.geometry(cfg.res_enc, used.shape[0], sms)
        st = torch.zeros(blocks * (threads // 32) * 6, dtype=torch.int64,
                         device="cuda")
        got = self(cfg, res, used, st.data_ptr(), self.timed)
        want = self(cfg, res, used)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError("stamped residue baseline != its build")
        return _stamp_phases(st, blocks, threads // 32, 6, fpb)


class _PrepareBaseline:
    """The design of csrc/floor_prepare.cu before its Hopper redesign (a
    CTA of 256 threads a row, three barriers: `git show
    f26b635:vorbis_tpu_torch/csrc/floor_prepare.cu`), built from
    `source` under its own library name and called on this design's
    inputs for timing in turns; any other source is refused (its hash
    differs).  `phases` runs a copy stamped at its three barriers."""

    def __init__(self, source):
        import ctypes
        from vorbis_tpu_torch.native import build_library
        from vorbis_tpu_torch.ops import floor_cuda
        self.source = _baseline_source(
            source, PREPARE_BASELINE_SHA256, "prepare-baseline", "f26b635",
            "floor_prepare.cu")
        so, _ = build_library(self.source, floor_cuda.nvcc,
                              floor_cuda.NVCC_FLAGS,
                              "libfloorprepare_baseline")
        self.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                         + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 5)
        self.fn = ctypes.CDLL(str(so)).vtt_floor_prepare
        self.fn.restype, self.fn.argtypes = ctypes.c_int, self.argtypes
        self.timed = None

    def __call__(self, fit, logmdct, logmask, stamps=None, fn=None):
        import torch
        from vorbis_tpu_torch.ops.floor_device import (QUANT_OFFSET,
                                                       QUANT_SCALE)
        B, n, P = logmdct.shape[0], fit.n, fit.posts
        quant = torch.empty((B, n), dtype=torch.int32, device="cuda")
        above = torch.empty((B, n), dtype=torch.bool, device="cuda")
        prefix = torch.empty((B, P, 6), dtype=torch.float32, device="cuda")
        used = torch.empty((B,), dtype=torch.bool, device="cuda")
        rc = (fn or self.fn)(
            logmdct.data_ptr(), logmask.data_ptr(), fit.seg_t.data_ptr(), B,
            n, P, float(QUANT_SCALE), float(QUANT_OFFSET),
            float(fit.twofitatten), float(fit.tw), quant.data_ptr(),
            above.data_ptr(), prefix.data_ptr(), used.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
            *([stamps] if stamps is not None else []))
        if rc != 0:
            raise RuntimeError(f"baseline floor_prepare launch failed: "
                               f"cudaError {rc}")
        return quant, above, prefix, used

    def phases(self, fit, logmdct, logmask):
        """Each phase's slowest-warp cycles (PREPARE_PHASES_BASELINE) of
        one call of the stamped copy, its outputs equal to the plain
        build's."""
        import ctypes
        import torch
        stamp = "VTT_STAMP();"
        if self.timed is None:
            lib = _stamped_library(self.source, [
                ("unsigned char* __restrict__ used) {\n",
                 "unsigned char* __restrict__ used,\n"
                 "                         long long* __restrict__ stamps) "
                 f"{{\n  int vtt_st = 0;\n  {stamp}\n", 1),
                ("  __syncthreads();", f"  {stamp}\n  __syncthreads();\n  "
                 f"{stamp}", 3),
                ("prow[i] = pre_s[i];\n}", f"prow[i] = pre_s[i];\n  {stamp}\n}}",
                 1),
                ("unsigned char* used,\n                                 "
                 "cudaStream_t stream) {",
                 "unsigned char* used, cudaStream_t stream, long long* "
                 "stamps) {", 1),
                ("      prefix, used);", "      prefix, used, stamps);", 1)],
                "floor_prepare_f26b635_stamped", 8)
            self.timed = lib.vtt_floor_prepare
            self.timed.restype = ctypes.c_int
            self.timed.argtypes = self.argtypes + [ctypes.c_void_p]
        B = logmdct.shape[0]
        st = torch.zeros(B * 8 * 8, dtype=torch.int64, device="cuda")
        got = self(fit, logmdct, logmask, st.data_ptr(), self.timed)
        want = self(fit, logmdct, logmask)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError("stamped prepare baseline != its build")
        return _stamp_phases(st, B, 8, 8, 1)


def _warp_phases(st, nphases):
    """From a timing build's stamps (warps * (nphases + 2) int64: each
    phase's cycles summed over the warp's rows or frames, their count,
    the warp's total): each phase's cycles a row (or frame) of the
    slowest warp and of the mean warp, over the warps holding rows; a
    warp's cycles a row, and its total (mean and most)."""
    import numpy as np
    s = st.cpu().numpy().reshape(-1, nphases + 2).astype(np.float64)
    rows = s[:, nphases]
    busy = rows > 0
    per_row = s[busy, :nphases] / rows[busy, None]
    return dict(slowest=[float(v) for v in per_row.max(0)],
                mean=[float(v) for v in per_row.mean(0)],
                row=float((s[busy, nphases + 1] / rows[busy]).mean()),
                warp=float(s[busy, nphases + 1].mean()),
                warp_max=float(s[busy, nphases + 1].max()),
                rows_a_warp=float(rows[busy].mean()))


def _prep_phases(lib, fit, logmdct, logmask):
    """Where a warp's time goes in csrc/floor_prepare.cu, from one call
    of its timing build (`lib`, -DVTT_PREPARE_TIMING) on the same inputs:
    for each of PREPARE_PHASES the cycles a row of the slowest warp and
    the mean warp, a warp's cycles a row and its total; the call's
    outputs must equal the default build's."""
    import ctypes
    import torch
    from vorbis_tpu_torch.ops.floor_cuda import (PREPARE_PHASES,
                                                 floor_prepare)
    from vorbis_tpu_torch.ops.floor_device import QUANT_OFFSET, QUANT_SCALE
    B, n, P = logmdct.shape[0], fit.n, fit.posts
    wpb, smem, blocks = (ctypes.c_int(0) for _ in range(3))
    if lib.vtt_floor_prepare_blocks_per_sm(
            n, P, fit.prep_edges, B, ctypes.byref(wpb), ctypes.byref(smem),
            ctypes.byref(blocks)) < 1:
        raise RuntimeError("floor_prepare timing build: no occupancy")
    st = torch.zeros(blocks.value * wpb.value * (len(PREPARE_PHASES) + 2),
                     dtype=torch.int64, device="cuda")
    out = (torch.empty((B, n), dtype=torch.int32, device="cuda"),
           torch.empty((B, n), dtype=torch.bool, device="cuda"),
           torch.empty((B, P, 6), dtype=torch.float32, device="cuda"),
           torch.empty((B,), dtype=torch.bool, device="cuda"))
    rc = lib.vtt_floor_prepare(
        logmdct.data_ptr(), logmask.data_ptr(), fit.prep_tab.data_ptr(),
        fit.prep_edges, B, n, P, float(QUANT_SCALE), float(QUANT_OFFSET),
        float(fit.twofitatten), float(fit.tw),
        *(t.data_ptr() for t in out),
        torch.cuda.current_stream().cuda_stream, st.data_ptr())
    if rc != 0:
        raise RuntimeError(f"floor_prepare timing build: cudaError {rc}")
    want = floor_prepare(fit, logmdct, logmask)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(out, want)):
        raise RuntimeError("floor_prepare timing build != default build")
    return _warp_phases(st, len(PREPARE_PHASES))


def _res_phases(lib, cfg, res, used):
    """Where a warp's time goes in csrc/residue_encode.cu, from one call
    of its timing build (`lib`, -DVTT_RESIDUE_TIMING) on the same inputs:
    for each of residue_encode_cuda.PHASES the cycles an item of the
    slowest and of the mean warp, a warp's cycles an item and its total;
    the call's outputs must equal the default build's."""
    import ctypes
    import torch
    from vorbis_tpu_torch.ops.residue_encode_cuda import (PHASES,
                                                          residue_encode)
    t = cfg.res_enc
    F = used.shape[0]
    wpb, smem, blocks = (ctypes.c_int(0) for _ in range(3))
    if lib.vtt_residue_encode_blocks_per_sm(
            t.head.ctypes.data, F, ctypes.byref(wpb), ctypes.byref(smem),
            ctypes.byref(blocks)) < 1:
        raise RuntimeError("residue_encode timing build: no occupancy")
    st = torch.zeros(blocks.value * wpb.value * (len(PHASES) + 2),
                     dtype=torch.int64, device="cuda")
    vals = torch.empty((F, t.rc), dtype=torch.int64, device="cuda")
    lens = torch.empty((F, t.rc), dtype=torch.int32, device="cuda")
    rc = lib.vtt_residue_encode(
        res.data_ptr(), used.data_ptr(), t.blob.data_ptr(), t.head.ctypes.data,
        F, res.shape[-1], vals.data_ptr(), lens.data_ptr(),
        torch.cuda.current_stream().cuda_stream, st.data_ptr())
    if rc != 0:
        raise RuntimeError(f"residue_encode timing build: cudaError {rc}")
    want = residue_encode(cfg, res, used)
    torch.cuda.synchronize()
    if not (torch.equal(vals, want[0]) and torch.equal(lens, want[1])):
        raise RuntimeError("residue_encode timing build != default build")
    return _warp_phases(st, len(PHASES))


def _phase_residue_encode(cases, smi, report="", baseline=None):
    """Phase 3l: the residue path (csrc/residue_encode.cu: classify,
    lattice VQ and the codeword columns in one launch) against its plain
    version (the finish's classifier, _vq_stages and _residue_fields),
    values and lengths bitwise, on the calls 3j recorded (`cases`: 4d's
    long and short finish batch, the managed encoder's 15-blob rows, both
    5.1 submaps long and short, the 16 and 32 kHz configs) and on
    tests/residue_encode_cases.py's seeded, threshold, zero, unused,
    stress and INT_MIN rows at each of those configs, the INT_MIN rows
    also at each config's LatticeVariant (the widest class at lattice
    steps 2 and 3); the build's registers (`report`), its launch (warps
    a block, shared memory a block, blocks, blocks an SM); its time at
    the two 4d batches (CUDA graphs, median and spread of six; in turns
    with f26b635's design where `baseline`, a _ResidueBaseline, is given,
    whose outputs must equal this design's), its bound and share, the
    plain trio's time and device kernels (no library call computes it),
    and each phase's cycles from the timing build (and from the
    baseline's stamped copy).  Returns the kernel's record for the JSON
    line."""
    import ctypes
    import torch
    from vorbis_tpu_torch.ops import residue_encode_cuda
    from vorbis_tpu_torch.ops.residue_encode_cuda import (
        PHASES, ResidueEncodeConfig, load_library, residue_encode,
        residue_encode_plain)
    rcs = _test_module("residue_encode_cases")
    err, configs = 0.0, {}
    for name, cfg, res, used in cases:
        err = max(err, _res_check(name, cfg, res, used))
        configs.setdefault(id(cfg), (name, cfg))
    for k, (name, cfg) in enumerate(configs.values()):
        n2 = cfg.res_enc.dev.n // 2
        var = rcs.LatticeVariant(cfg)
        var.res_enc = ResidueEncodeConfig(var, cfg.res_enc.nch,
                                          cfg.res_enc.dev)
        for rows, c, host in (
                ("seeded and edge", cfg, rcs.inputs(cfg, n2, 500 + k)),
                ("stress", cfg, rcs.stress_rows(cfg, n2, 600 + k)),
                ("INT_MIN", cfg, rcs.int_min_rows(cfg, n2, 650 + k)),
                ("INT_MIN, lattice steps 2 and 3", var,
                 rcs.int_min_rows(cfg, n2, 650 + k))):
            err = max(err, _res_check(
                f"{name}, {rows} rows", c,
                *(torch.from_numpy(a).cuda() for a in host)))
    lib = load_library()
    build = _build_lines(report)
    timed = residue_encode_cuda.bind(ctypes.CDLL(str(
        residue_encode_cuda.build(timing=True)[0])), stamps=True)
    rec = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, cfg, res, used in cases[:2]:
        t = cfg.res_enc
        F = used.shape[0]
        wpb, smem, blocks = (ctypes.c_int(0) for _ in range(3))
        per_sm = lib.vtt_residue_encode_blocks_per_sm(
            t.head.ctypes.data, F, ctypes.byref(wpb), ctypes.byref(smem),
            ctypes.byref(blocks))
        h = residue_encode_cuda.blob_tables(t.blob_np)
        print(f"[residue encode] {name}: build {build or 'cached'}; "
              f"{blocks.value} blocks of {wpb.value} warps, {smem.value} "
              f"bytes of shared memory a block, {per_sm} blocks an SM; a "
              f"lane {h['unit']} values, {h['units']} lanes a partition, "
              f"{h['cpw']} chunks an item ({h['item_cols']} columns); blob "
              f"{4 * h['words']} bytes (books through the read-only path)")
        mine = (lambda c=cfg, r=res, u=used: residue_encode(c, r, u))
        theirs = None
        if baseline is not None:
            theirs = (lambda c=cfg, r=res, u=used: baseline(c, r, u))
            got, want = theirs(), mine()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"3l {name}: f26b635's design's output "
                                   f"differs from this one's")
        ts, tb = _turns(mine, theirs)
        ms, lo, hi = _med(ts)
        plain_k, plain_dev = _device_profile(
            lambda: residue_encode_plain(cfg, res, used))
        plain_ms = _cuda_ms(lambda: residue_encode_plain(cfg, res, used), 3)
        bound_ms, by, nb, io, fo = _res_bound(cfg, res, used)
        print(f"[residue encode] {name} F={used.shape[0]}: kernel "
              f"{ms:.5f} ms (CUDA graphs; median of {len(ts)}, "
              f"{lo:.5f}-{hi:.5f}); bound {bound_ms * 1e3:.3f} us by {by} "
              f"({nb} bytes, {io} int32 + {fo} float32 operations), share "
              f"{100 * bound_ms / ms:.1f}%; plain trio {plain_ms:.4f} ms a "
              f"call, {plain_k} device kernels ({plain_dev:.4f} ms on the "
              f"device); library call: none ({smi})")
        extra = {}
        if tb:
            bms, blo, bhi = _med(tb)
            print(f"[residue encode] {name}: in turns, f26b635's design "
                  f"{bms:.5f} ms ({blo:.5f}-{bhi:.5f}), share "
                  f"{100 * bound_ms / bms:.1f}%, against this design's "
                  f"{ms:.5f} ms ({100 * bound_ms / ms:.1f}%), "
                  f"{bms / ms:.2f}x, outputs equal ({smi})")
            bph = baseline.phases(cfg, res, used, sms)
            print(f"[residue encode] {name}: f26b635's design, a block "
                  f"{bph['block']:.0f} cycles (median "
                  f"{bph['block_median']:.0f}; {bph['frames_a_block']} "
                  f"frames); a phase's slowest warp: "
                  + ", ".join(f"{n} {c:.0f}" for n, c in
                              zip(RESIDUE_PHASES_BASELINE, bph["slowest"]))
                  + f" (stamped copy, clock64; {smi})")
            extra = dict(baseline_ms=bms, baseline_rounds_ms=tb,
                         baseline_share=bound_ms / bms,
                         baseline_phases=dict(bph, names=list(
                             RESIDUE_PHASES_BASELINE)))
        ph = _res_phases(timed, cfg, res, used)
        print(f"[residue encode] {name}: a warp {ph['warp']:.0f} cycles "
              f"(most {ph['warp_max']:.0f}; {ph['rows_a_warp']:.2f} items "
              f"a warp, {ph['row']:.0f} cycles an item); an item's "
              f"cycles, slowest warp / mean warp: "
              + ", ".join(f"{n} {c:.0f} / {m:.0f}" for n, c, m in
                          zip(PHASES, ph["slowest"], ph["mean"]))
              + f" (timing build, clock64; {smi})")
        rec[name] = dict(frames=used.shape[0], rows=res.shape[0],
                         rc=t.rc, ms=ms, rounds_ms=ts, plain_ms=plain_ms,
                         plain_kernels=plain_k, plain_device_ms=plain_dev,
                         bound_ms=bound_ms, bound_by=by, bytes=nb,
                         share=bound_ms / ms, shared_bytes=smem.value,
                         warps_a_block=wpb.value, blocks=blocks.value,
                         blocks_per_sm=per_sm, build=build,
                         phases=dict(ph, names=list(PHASES)), **extra)
    main = rec["4d long batch"]
    return dict({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "share")},
                max_abs_err=err, library_ms=None, at_long=main,
                at_short=rec["4d short batch"])


# The packer's own arithmetic, whatever a kernel's schedule: int32
# operations a column (the zero-length test, the length's add), a column
# with bits (the shift, the OR) and a group (its width mask, its offset's
# add, the field's shift and split, two ORs, the byte's share of the
# store)
OPS_PACK_COL, OPS_PACK_BITS, OPS_PACK_GROUP = 2, 2, 8
SECTOR = 32                                   # bytes a DRAM sector


def _pack_bound(tabs, vals, lens, wb):
    """(bound ms, bound_by, bytes, int32 ops) of one pack_packets call on
    this run's columns: every length read once (int32), of the int64
    values only the 32-byte sectors that hold a column of nonzero length
    (a zero-length column's value is never needed), the packets and bit
    counts written once, the plan read once; the operations as counted
    above, the bit columns' on this run's lengths."""
    import torch
    F = vals.shape[0]
    per = SECTOR // vals.element_size()
    bits = torch.nonzero(lens.reshape(-1) > 0).squeeze(1)
    first = (vals.data_ptr() % SECTOR) // vals.element_size()
    sectors = torch.unique_consecutive((bits + first) // per).numel()
    nbytes = sectors * SECTOR + lens.numel() * 4 + F * (wb + 4) \
        + tabs.offs.numel() * 4
    ops = F * (tabs.n_cols * OPS_PACK_COL + tabs.n_groups * OPS_PACK_GROUP) \
        + bits.numel() * OPS_PACK_BITS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


# sha256 of the first design of csrc/pack_bits.cu (commit 4c76a5d): its C
# entry point vtt_pack_packets takes the plan as C1 + 1 offsets followed by
# the groups' column lists, a block a packet
PACK_BASELINE_SHA256 = ("2a9dd694461a62297449f14a4d5fc5f2c183840571758c9d"
                        "4e899fe257444ea2")
# the timing build's phases (csrc/pack_bits.cu -DVTT_PACK_TIMING): a
# warp's cycles in each, summed over the tiles, then its total
PACK_PHASES = ("stage", "copies", "scan", "wait", "merge and OR", "store")


class _PackBaseline:
    """The first design of csrc/pack_bits.cu (a block a packet walking
    the groups in rounds of a group a thread, a block scan a round: `git
    show 4c76a5d:vorbis_tpu_torch/csrc/pack_bits.cu`), built from
    `source` under its own library name, called on the same columns with
    the column lists it reads (a plan's columns in order: every group is
    a run) for timing in turns; any other source is refused (its hash
    differs)."""

    def __init__(self, source):
        import ctypes
        import hashlib
        import weakref
        from pathlib import Path
        from vorbis_tpu_torch.native import build_library
        from vorbis_tpu_torch.ops import floor_cuda
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()
        if digest != PACK_BASELINE_SHA256:
            raise RuntimeError(f"--pack-baseline {source} is not commit "
                               f"4c76a5d's pack_bits.cu (sha256 {digest})")
        so, _ = build_library(Path(source), floor_cuda.nvcc,
                              floor_cuda.NVCC_FLAGS, "libpackbits_baseline")
        self.fn = ctypes.CDLL(str(so)).vtt_pack_packets
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                            + [ctypes.c_void_p] * 3)
        self.groups = weakref.WeakKeyDictionary()

    def __call__(self, tabs, vals, lens, wb):
        import torch
        g = self.groups.get(tabs)
        if g is None:
            g = self.groups[tabs] = torch.cat([tabs.offs, torch.arange(
                tabs.n_cols, dtype=torch.int32, device=tabs.offs.device)])
        F = vals.shape[0]
        out = torch.empty((F, wb), dtype=torch.uint8, device="cuda")
        nbits = torch.empty((F,), dtype=torch.int32, device="cuda")
        rc = self.fn(vals.data_ptr(), lens.data_ptr(), g.data_ptr(), F,
                     tabs.n_cols, tabs.n_groups, wb, out.data_ptr(),
                     nbits.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline pack_packets launch failed: {rc}")
        return out, nbits


def _pack_phases(fn, tabs, vals, lens, wb):
    """Where a block's time goes, from one call of the timing build's
    entry point `fn`: for each of PACK_PHASES the slowest warp's cycles
    (mean over the blocks), and a block's cycles, its slowest warp's
    start to end (mean)."""
    import numpy as np
    import torch
    from vorbis_tpu_torch.ops.pack_cuda import launch, sm_count
    g = tabs.geometry(vals.shape[0], wb, sm_count(vals.device.index))
    warps = g.tpp * g.ppb // 32
    st = torch.zeros(g.blocks * warps * (len(PACK_PHASES) + 1),
                     dtype=torch.int64, device="cuda")
    launch(fn, tabs, vals, lens, wb, st.data_ptr())
    torch.cuda.synchronize()
    s = st.view(g.blocks, warps, -1).cpu().numpy()
    return dict(slowest=[float(s[:, :, k].max(1).mean())
                         for k in range(len(PACK_PHASES))],
                block=float(s[:, :, -1].max(1).mean()),
                block_median=float(np.median(s[:, :, -1].max(1))))


def _phase_pack(cases, smi, report="", baseline=None):
    """Phase 3m: the packer (csrc/pack_bits.cu: the plan's column merge
    and the LSB-first packing in one launch) against its plain version
    (merge_columns and pack_bits), packets and bit counts bitwise, on the
    calls 3j recorded (`cases`: 4d's long and short finish batch, the
    managed encoder's 15-blob rows, the 5.1 encoder, the 16 and 32 kHz
    configs) at their budget and at the plan's worst_bytes, and on
    _pack_rows' seeded and stress rows at each of those plans; the
    build's registers and spills (`report`), the block sizing chosen,
    shared memory a block and blocks an SM; its time at the two 4d
    batches (CUDA graphs, median and spread of six; in turns with the
    first design where `baseline`, a _PackBaseline, is given, whose
    outputs must equal this design's), its bound and share, the plain
    duo's time and device kernels (no library call computes it); and
    each phase's slowest-warp cycles from the timing build.  Returns the
    kernel's record for the JSON line."""
    import ctypes
    import torch
    from vorbis_tpu_torch.native import build_library
    from vorbis_tpu_torch.ops import floor_cuda, pack_cuda
    from vorbis_tpu_torch.ops.pack_cuda import (load_library, pack_packets,
                                                pack_packets_plain, sm_count)
    err, plans = 0.0, {}
    for name, tabs, vals, lens, wb in cases:
        for w in sorted({wb, tabs.plan.worst_bytes}):
            err = max(err, _pack_check(f"{name}, recorded", tabs, vals,
                                       lens, w))
        plans.setdefault(id(tabs), (name, tabs, vals, lens))
    for k, (name, tabs, vals, lens) in enumerate(plans.values()):
        v, l = (torch.from_numpy(a).cuda() for a in
                _pack_rows(tabs.plan.gidx, tabs.n_cols, 700 + k))
        # and in tiles of at most 128 staged words, 32 threads a packet,
        # up to eight packets a block
        small = pack_cuda.PackTables(tabs.plan, tabs.gidx, 32, 128)
        err = max(err, _pack_check(f"{name}, recorded, small tiles", small,
                                   vals, lens, tabs.plan.wb))
        for w in (tabs.plan.wb, tabs.plan.worst_bytes):
            for label, t in (("", tabs), (", small tiles", small)):
                err = max(err, _pack_check(
                    f"{name}, seeded and stress rows{label}", t, v, l, w))
    per_sm = load_library().vtt_pack_packets_blocks_per_sm
    build = _build_lines(report)
    so, _ = build_library(pack_cuda.SOURCE, floor_cuda.nvcc,
                          (*floor_cuda.NVCC_FLAGS, "-DVTT_PACK_TIMING"),
                          "libpackbits_timing")
    timed = pack_cuda.bind(ctypes.CDLL(str(so)), stamps=True)
    rec = {}
    for name, tabs, vals, lens, wb in cases[:2]:
        F = vals.shape[0]
        g = tabs.geometry(F, wb, sm_count(vals.device.index))
        blocks = per_sm(g.tpp * g.ppb, g.smem)
        tiles = -(-tabs.n_groups // (g.tpp * g.run))
        print(f"[pack] {name}: build {build or 'cached'}; blocks sized to "
              f"the batch: {g.tpp} threads a packet x {g.ppb} packets a "
              f"block, {g.run} groups a thread, {tiles} tile(s) a packet, "
              f"{g.blocks} blocks; {g.smem} bytes of shared memory a block "
              f"({g.lw} staged columns, lengths and values' low words, + "
              f"{g.nw} packet words a packet), {blocks} blocks an SM")
        mine = (lambda t=tabs, v=vals, l=lens, w=wb: pack_packets(t, v, l, w))
        theirs = None
        if baseline is not None:
            theirs = (lambda t=tabs, v=vals, l=lens, w=wb:
                      baseline(t, v, l, w))
            same = all(torch.equal(a, b) for a, b in zip(theirs(), mine()))
            torch.cuda.synchronize()
            if not same:
                raise RuntimeError(f"3m {name}: the first design's output "
                                   f"differs from this one's")
        ts, tb = _turns(mine, theirs)
        ms, lo, hi = _med(ts)
        plain_k, plain_dev = _device_profile(
            lambda: pack_packets_plain(tabs, vals, lens, wb))
        plain_ms = _cuda_ms(lambda: pack_packets_plain(tabs, vals, lens,
                                                       wb), 3)
        bound_ms, by, nb, ops = _pack_bound(tabs, vals, lens, wb)
        print(f"[pack] {name} F={F} C={tabs.n_cols} C1={tabs.n_groups} "
              f"wb={wb}: kernel {ms:.5f} ms (CUDA graphs; median of "
              f"{len(ts)}, {lo:.5f}-{hi:.5f}); bound {bound_ms * 1e3:.3f} us "
              f"by {by} ({nb} bytes: the lengths, the value sectors of "
              f"columns with bits, the packets; {ops} int32 operations), "
              f"share {100 * bound_ms / ms:.1f}%; plain duo (merge + pack) "
              f"{plain_ms:.4f} ms a call, {plain_k} device kernels "
              f"({plain_dev:.4f} ms on the device); library call: none "
              f"({smi})")
        extra = {}
        if tb:
            bms, blo, bhi = _med(tb)
            print(f"[pack] {name}: in turns, the first design (4c76a5d) "
                  f"{bms:.5f} ms ({blo:.5f}-{bhi:.5f}), share "
                  f"{100 * bound_ms / bms:.1f}%, against this design's "
                  f"{ms:.5f} ms ({100 * bound_ms / ms:.1f}%), "
                  f"{bms / ms:.2f}x, outputs equal ({smi})")
            extra = dict(baseline_ms=bms, baseline_rounds_ms=tb,
                         baseline_share=bound_ms / bms)
        ph = _pack_phases(timed, tabs, vals, lens, wb)
        print(f"[pack] {name}: a block {ph['block']:.0f} cycles (median "
              f"{ph['block_median']:.0f}); a phase's slowest warp: "
              + ", ".join(f"{n} {c:.0f}" for n, c in
                          zip(PACK_PHASES, ph["slowest"]))
              + f" (timing build, clock64; {smi})")
        rec[name] = dict(packets=F, cols=tabs.n_cols, groups=tabs.n_groups,
                         wb=wb, ms=ms, rounds_ms=ts, plain_ms=plain_ms,
                         plain_kernels=plain_k, plain_device_ms=plain_dev,
                         bound_ms=bound_ms, bound_by=by, bytes=nb,
                         share=bound_ms / ms, shared_bytes=g.smem,
                         blocks_per_sm=blocks, geometry=g._asdict(),
                         phases=dict(ph, names=list(PACK_PHASES)), **extra)
    main = rec["4d long batch"]
    return dict({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "share")},
                max_abs_err=err, library_ms=None, at_long=main,
                at_short=rec["4d short batch"])


# The prepare's own arithmetic: a bin's fma, add and compare (float32)
# and its cast and two clamps (int32); a used bin of a segment's window,
# counted on this run's quant once a window that holds it: its six
# features' three products and six adds (int32, though the kernel adds
# in int64); a segment's twelve conversions, its weight's four and the
# weighted moments' twelve float32 operations and the prefix's six adds
F32_PREP_BIN, OPS_PREP_BIN, OPS_PREP_USED, F32_PREP_SEG = 3, 3, 9, 34


def _prep_bound(fit, logmdct, quant):
    """(bound ms, bound_by, bytes, int32 ops, float32 ops) of one
    floor_prepare call: logmdct and logmask read once, quant, above, the
    prefix and used written once, the segment table read once; the
    operations as counted above, the windows' on this run's used bins."""
    import numpy as np
    import torch
    B, n = logmdct.shape
    P = fit.posts
    nbytes = B * n * (4 + 4 + 4 + 1) + B * P * 6 * 4 + B \
        + fit.seg_t.numel() * 4
    cover = np.zeros(n, np.float32)              # windows holding a bin
    for lo, hi in zip(fit.seg_lo, fit.seg_hi):
        cover[lo:hi] += 1
    used = float(((quant != 0).float()
                  @ torch.from_numpy(cover).to(quant.device)).sum())
    int_ops = B * n * OPS_PREP_BIN + used * OPS_PREP_USED
    f32_ops = B * n * F32_PREP_BIN + B * (P - 1) * F32_PREP_SEG
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, int(int_ops), int(f32_ops))


def _phase_floor_prepare(cases, smi, report="", baseline=None):
    """Phase 3n: the floor fit's prepare (csrc/floor_prepare.cu: the
    mask's dB quantization, the above classes, the segments' moments and
    their weighted prefix in one launch) against its plain version
    (DeviceFloorFit.prepare, its prefix summed in the CPU's order:
    _prep_want), bitwise, on the calls 3j recorded (`cases`: 4d's long
    and short batch, the managed encoder's stacked rows, the 5.1
    encoder's three looks, the 16 and 32 kHz looks) and on _prepare_rows'
    seeded and edge rows at each of those looks and at a synthetic look of
    two posts over n = 1,024; the build's registers (`report`), its
    launch (warps a block, shared memory a block, blocks, blocks an SM);
    its time at the two 4d batches (CUDA graphs, median and spread of
    six; in turns with f26b635's design where `baseline`, a
    _PrepareBaseline, is given, whose outputs must equal this design's),
    its bound and share, the plain version's time and device kernels (no
    library call computes it), and each phase's cycles from the timing
    build (and from the baseline's stamped copy).  Returns the kernel's
    record for the JSON line."""
    import ctypes
    import torch
    from vorbis_tpu_torch.ops import floor_cuda
    from vorbis_tpu_torch.ops.floor_cuda import (PREPARE_PHASES,
                                                 DeviceFloorFitCuda,
                                                 floor_prepare,
                                                 floor_prepare_plain,
                                                 load_prepare_library)
    err, fits = 0.0, {}
    for name, fit, lm, mk in cases:
        err = max(err, _prep_check(f"{name}, recorded", fit, lm, mk))
        fits.setdefault(id(fit), (name, fit))
    two = DeviceFloorFitCuda(_synthetic_look(cases[0][1].look, 2, 4), "cuda")
    for k, (name, fit) in enumerate(list(fits.values())
                                    + [("synthetic P=2 n=1024", two)]):
        lm, mk = (torch.from_numpy(a).cuda() for a in
                  _prepare_rows(fit.n, 24, 800 + k))
        err = max(err, _prep_check(f"{name}, seeded and edge rows", fit,
                                   lm, mk))
    lib = load_prepare_library()
    timed = floor_cuda.bind_prepare(ctypes.CDLL(str(
        floor_cuda.build_prepare(timing=True)[0])), stamps=True)
    build = _build_lines(report)
    rec = {}
    for name, fit, lm, mk in cases[:2]:
        B = lm.shape[0]
        wpb, smem, blocks = (ctypes.c_int(0) for _ in range(3))
        per_sm = lib.vtt_floor_prepare_blocks_per_sm(
            fit.n, fit.posts, fit.prep_edges, B, ctypes.byref(wpb),
            ctypes.byref(smem), ctypes.byref(blocks))
        print(f"[floor prepare] {name}: build {build or 'cached'}; "
              f"{blocks.value} blocks of {wpb.value} warps (a warp a row), "
              f"{smem.value} bytes of shared memory a block, {per_sm} "
              f"blocks an SM; {floor_cuda.bins_a_lane(fit.n)} bins a lane, "
              f"{fit.prep_edges} window edges")
        mine = (lambda f=fit, a=lm, b=mk: floor_prepare(f, a, b))
        theirs = None
        if baseline is not None:
            theirs = (lambda f=fit, a=lm, b=mk: baseline(f, a, b))
            got, want = theirs(), mine()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"3n {name}: f26b635's design's output "
                                   f"differs from this one's")
        ts, tb = _turns(mine, theirs)
        ms, lo, hi = _med(ts)
        plain_k, plain_dev = _device_profile(
            lambda: floor_prepare_plain(fit, lm, mk))
        plain_ms = _cuda_ms(lambda: floor_prepare_plain(fit, lm, mk), 3)
        quant = floor_prepare(fit, lm, mk)[0]
        bound_ms, by, nb, io, fo = _prep_bound(fit, lm, quant)
        print(f"[floor prepare] {name} B={B} n={fit.n} P={fit.posts}: "
              f"kernel {ms:.5f} ms (CUDA graphs; median of {len(ts)}, "
              f"{lo:.5f}-{hi:.5f}); bound {bound_ms * 1e3:.3f} us by {by} "
              f"({nb} bytes, {io} int32 + {fo} float32 operations), share "
              f"{100 * bound_ms / ms:.1f}%; plain version {plain_ms:.4f} ms "
              f"a call, {plain_k} device kernels ({plain_dev:.4f} ms on the "
              f"device); library call: none ({smi})")
        extra = {}
        if tb:
            bms, blo, bhi = _med(tb)
            print(f"[floor prepare] {name}: in turns, f26b635's design "
                  f"{bms:.5f} ms ({blo:.5f}-{bhi:.5f}), share "
                  f"{100 * bound_ms / bms:.1f}%, against this design's "
                  f"{ms:.5f} ms ({100 * bound_ms / ms:.1f}%), "
                  f"{bms / ms:.2f}x, outputs equal ({smi})")
            bph = baseline.phases(fit, lm, mk)
            print(f"[floor prepare] {name}: f26b635's design, a row's block "
                  f"{bph['block']:.0f} cycles (median "
                  f"{bph['block_median']:.0f}); a phase's slowest warp: "
                  + ", ".join(f"{n} {c:.0f}" for n, c in
                              zip(PREPARE_PHASES_BASELINE, bph["slowest"]))
                  + f" (stamped copy, clock64; {smi})")
            extra = dict(baseline_ms=bms, baseline_rounds_ms=tb,
                         baseline_share=bound_ms / bms,
                         baseline_phases=dict(bph, names=list(
                             PREPARE_PHASES_BASELINE)))
        ph = _prep_phases(timed, fit, lm, mk)
        print(f"[floor prepare] {name}: a warp {ph['warp']:.0f} cycles "
              f"(most {ph['warp_max']:.0f}; {ph['rows_a_warp']:.2f} rows a "
              f"warp, {ph['row']:.0f} cycles a row); a row's cycles, "
              f"slowest warp / mean warp: "
              + ", ".join(f"{n} {c:.0f} / {m:.0f}" for n, c, m in
                          zip(PREPARE_PHASES, ph["slowest"], ph["mean"]))
              + f" (timing build, clock64; {smi})")
        rec[name] = dict(rows=B, n=fit.n, P=fit.posts, ms=ms, rounds_ms=ts,
                         plain_ms=plain_ms, plain_kernels=plain_k,
                         plain_device_ms=plain_dev, bound_ms=bound_ms,
                         bound_by=by, bytes=nb, share=bound_ms / ms,
                         shared_bytes=smem.value, warps_a_block=wpb.value,
                         blocks=blocks.value, blocks_per_sm=per_sm,
                         build=build,
                         phases=dict(ph, names=list(PREPARE_PHASES)),
                         **extra)
    main = rec["4d long batch"]
    return dict({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "share")},
                max_abs_err=err, library_ms=None, at_long=main,
                at_short=rec["4d short batch"])


# The coupling's own arithmetic, whatever a kernel's schedule, counted
# from its plain version: float32 operations a bin
#  - always: the two residues' divides and absolutes, the lossless
#    compares, the two rints, the mag/ang transform (absolutes, compare,
#    difference, the flip's multiply and compare), the fold's two signed
#    squares, the two 0.94 products and absolutes, the hypot's products
#    and sum, the floor energy's two squares and add, ve's divide, the
#    square root, its rint and the candidate compare: 35;
#  - with the M9 peaks: the two threshold subtracts and maxima, 4;
#  - with M6: the point2 compares, the active compares, the signed
#    squares, the imbalance's absolutes and difference, its add into the
#    partition sum: 10;
#  - with the normalize: the budget's add, and the candidate's place in
#    its partition (two compares against each of the partition's keys:
#    the stable descending rank the sort gives).
F32_CPL_PER_BIN, F32_CPL_M9, F32_CPL_M6 = 35, 4, 10


def _couple_bound(a, kw):
    """(bound ms, bound_by, bytes, float32 ops) of one couple_quantize
    call (dev, md, curve, used, F) with keyword arguments kw: md, curve,
    the used flags and each optional input read once, each table row
    read once, the interleaved residues and the flags written once; the
    operations as counted above."""
    dev, md, curve, used, F = a
    n2 = md.shape[-1]
    cp, nm = dev.ctx.couple, dev.ctx.normal
    m6 = kw.get("epeak") is not None and int(cp.get("tonefix_end", 0)) > 0
    normalize = nm["thresh"] < 9000.0

    def table(t, default):
        t = default[:n2] if t is None else t
        return (t.shape[0] if t.dim() == 2 else 1) * n2 * t.element_size()
    nbytes = (md.numel() + curve.numel()) * 4 + used.numel() \
        + table(kw.get("thr1"), dev.thr1_t) \
        + table(kw.get("threv"), dev.threv_t) \
        + sum(kw[k].numel() * kw[k].element_size()
              for k in ("epeak", "npeak", "lowpass", "inlimit")
              if kw.get(k) is not None) \
        + (n2 * 4 if m6 else 0) + (n2 if normalize else 0) \
        + F * 2 * n2 * 4 + F
    per_bin = F32_CPL_PER_BIN + (F32_CPL_M9 if kw.get("epeak") is not None
                                 else 0) + (F32_CPL_M6 if m6 else 0) \
        + (1 + 2 * nm["partition"] if normalize else 0)
    ops = F * n2 * per_bin
    bound_ms, by = _roofline(nbytes, ops)
    return bound_ms, by, nbytes, ops


def _couple_check(name, a, kw):
    """couple_quantize's kernel against its plain version on the card,
    residues by bit pattern and flags; returns the largest difference."""
    import torch
    from vorbis_tpu_torch.ops.couple_cuda import (couple_quantize,
                                                  couple_quantize_plain)
    before = couple_quantize.launches
    got = couple_quantize(*a, **kw)
    want = couple_quantize_plain(*a, **kw)
    torch.cuda.synchronize()
    if couple_quantize.launches != before + 1:
        raise RuntimeError(f"couple quantize {name}: "
                           f"{couple_quantize.launches - before} launches")
    same = [torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)),
            torch.equal(got[1], want[1])]
    err = float((got[0].double() - want[0].double()).abs().max()) \
        if got[0].numel() else 0.0
    dev, md = a[0], a[1]
    print(f"[couple] {name}: F={a[4]} n2={md.shape[-1]} part="
          f"{dev.ctx.couple['partition']}"
          + "".join(f" {k}" for k in ("epeak", "npeak", "lowpass", "thr1")
                    if kw.get(k) is not None)
          + ": residues, flags " + ("bitwise equal to the plain version"
                                    if all(same) else f"DIFFER {same}")
          + f", max_abs_err {err}, {int((want[0] != 0).sum())} nonzero")
    if not all(same):
        raise RuntimeError(f"couple quantize {name}: kernel != plain")
    return err


# sha256 of the first design's csrc/couple_quantize.cu (commit e6f7150),
# whose CoupleArgs _CoupleBaseline mirrors
COUPLE_BASELINE_SHA256 = ("c7624ccb192745c992e4d639b0deeb2cf84e70130f02d4"
                          "1dc51a53e635e8654b")


class _CoupleBaseline:
    """The first design of csrc/couple_quantize.cu (a frame a block of up
    to 256 threads, M6 as two passes over the frame with one barrier, the
    bin reloaded in the second: `git show
    e6f7150:vorbis_tpu_torch/csrc/couple_quantize.cu`), built from
    `source` under its own library name and called through a mirror of
    its own CoupleArgs (this design's fields, then its threads a frame
    and frames a block) on this design's inputs, for timing in turns; any
    other source is refused (its hash differs)."""

    def __init__(self, source):
        import ctypes
        import hashlib
        from pathlib import Path
        from vorbis_tpu_torch.native import build_library
        from vorbis_tpu_torch.ops import floor_cuda
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()
        if digest != COUPLE_BASELINE_SHA256:
            raise RuntimeError(f"--couple-baseline {source} is not commit "
                               f"e6f7150's couple_quantize.cu (sha256 "
                               f"{digest})")
        so, _ = build_library(Path(source), floor_cuda.nvcc,
                              floor_cuda.NVCC_FLAGS, "libcouple_baseline")
        p, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_float)

        class Args(ctypes.Structure):
            _fields_ = ([(k, p) for k in (
                "md", "curve", "used", "lowpass", "epeak", "npeak", "thr1",
                "threv", "inlimit", "thr2", "nm_inreg", "nm_start", "res",
                "any_used")]
                + [(k, ll) for k in ("thr1_rs", "threv_rs", "inl_rs")]
                + [(k, i) for k in (
                    "thr1_rows", "threv_rows", "inl_rows", "F", "n2",
                    "part", "npt", "ncols", "tfe", "m6", "normalize",
                    "lanes_m6", "lanes_nm", "tpf", "fpb")]
                + [(k, f) for k in ("prepoint", "prae", "thresh")])
        self.Args = Args
        self.fn = ctypes.CDLL(str(so)).vtt_couple_quantize
        self.fn.restype = ctypes.c_int
        self.fn.argtypes = [ctypes.POINTER(Args), ctypes.c_void_p]

    def __call__(self, a, kw):
        """(res, any_used) of the first design on a couple_quantize call
        (dev, md, curve, used, F) with keyword arguments kw."""
        import ctypes
        import torch
        from vorbis_tpu_torch.ops.couple_cuda import args
        ca, res, anyu, keep, _ = args(*a, **kw)
        n2 = a[1].shape[-1]
        slots = -(-(-(-n2 // ca.part) * ca.part) // 32) * 32
        tpf = min(slots, 256)
        b = self.Args(**{k: getattr(ca, k) for k, _ in self.Args._fields_
                         if k not in ("tpf", "fpb")},
                      tpf=tpf, fpb=max(1, 256 // tpf))
        rc = self.fn(ctypes.byref(b), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline couple_quantize launch failed: "
                               f"cudaError {rc}")
        return res, anyu


def _couple_phases(lib, a, kw):
    """Where a frame's time goes, from one call of the timing build
    (`lib`, -DVTT_COUPLE_TIMING) on a couple_quantize call: for each of
    couple_cuda.PHASES the slowest of a frame's warps' cycles (mean over
    the frames), and a frame's cycles, its slowest warp's start to end
    (mean and median); the call's outputs must equal the default
    build's."""
    import ctypes
    import numpy as np
    import torch
    from vorbis_tpu_torch.ops.couple_cuda import (PHASES, args,
                                                  couple_quantize, geometry)
    ca, res, anyu, keep, _ = args(*a, **kw)
    F = a[4]
    wpf, blocks = geometry(a[1].shape[-1], ca.part, a[4])
    st = torch.zeros(blocks * (len(PHASES) + 1), dtype=torch.int64,
                     device="cuda")
    rc = lib.vtt_couple_quantize(ctypes.byref(ca),
                                 torch.cuda.current_stream().cuda_stream,
                                 st.data_ptr())
    if rc != 0:
        raise RuntimeError(f"couple_quantize timing build: cudaError {rc}")
    want = couple_quantize(*a, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(res.view(torch.int32), want[0].view(torch.int32))
            and torch.equal(anyu, want[1])):
        raise RuntimeError("couple_quantize timing build != default build")
    s = st.view(F, wpf, -1).cpu().numpy()
    return dict(slowest=[float(s[:, :, k].max(1).mean())
                         for k in range(len(PHASES))],
                frame=float(s[:, :, -1].max(1).mean()),
                frame_median=float(np.median(s[:, :, -1].max(1))),
                warps_a_frame=wpf, blocks=blocks)


def _phase_couple(cases, smi, report="", baseline=None):
    """Phase 3o: the stereo coupling (csrc/couple_quantize.cu: the
    lowpass, the lossless flags with the M9 lowering, M6, the mag/ang and
    point fold, the normalize and the interleave in one launch) against
    its plain version, residues bitwise, on the calls 3j recorded
    (`cases`: 4d's long and short finish batch, the managed encoder's
    15-blob rows long and short, the 16 and 32 kHz configs) and on
    tests/couple_cases.py's rows at each of those configs and at
    FastEncoder(2, 44100, 0.2)'s long and short ones (the normalize on):
    seeded rows (the M9 and M8 stores, lowpass, unused channels and
    frames, equal energies; the managed calls' 15-row tables), its rows
    on M6's and the normalize's edges, padded too, `instance_rows` (with
    and without the M9 peaks, padded and not, the carry of a warp's first
    partition); fails unless every instantiation (couple_cuda.INSTANCES)
    was launched.  Prints each instantiation's registers, static shared
    and local bytes and blocks an SM (`report`: the ptxas lines); at the
    two 4d batches the launch's geometry, its time (CUDA graphs, median
    and spread of six; in turns with the first design where `baseline`,
    a _CoupleBaseline, is given, whose outputs must equal this design's),
    its bound and share, the plain version's time and device kernels (no
    library call computes it), and each phase's slowest-warp cycles from
    the timing build.  Returns the kernel's record for the JSON line."""
    import ctypes
    from collections import Counter
    import torch
    from vorbis_tpu_torch.ops import couple_cuda
    from vorbis_tpu_torch.ops.couple_cuda import (
        BPT, INSTANCES, PHASES, args, couple_quantize,
        couple_quantize_plain, geometry, load_library)
    cc = _test_module("couple_cases")
    seen = Counter(couple_quantize.instances)
    err, configs = 0.0, {}
    for name, a, kw in cases:
        err = max(err, _couple_check(name, a, kw))
        configs.setdefault(id(a[0]), (name, a[0], kw))
    # q0.2 at 44.1 kHz: the normalize on at 32-bin partitions too
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    q02 = FastEncoder(2, 44100, 0.2)
    for W in (1, 0):
        dev = q02._dev_for(W)
        configs[id(dev)] = (f"q0.2 n={dev.n}", dev, {})
    for k, (name, dev, kw) in enumerate(configs.values()):
        cfg = cc.config(dev)
        rows = {"seeded": cc.seeded(cfg, 64, 700 + k),
                "seeded, M9 M8 lowpass": cc.seeded(
                    cfg, 64, 710 + k, epeak=True, npeak=True, lowpass=True)}
        if kw.get("thr1") is not None and kw["thr1"].shape[0] == 15:
            c = cc.seeded(cfg, 30, 720 + k, epeak=True, npeak=True,
                          lowpass=True)
            c.update({t: kw[t].cpu().numpy()
                      for t in ("thr1", "threv", "inlimit")})
            rows["seeded, 15 blobs' rows"] = c
        for pad in (0, cfg["part"] // 4):
            for label, build, ok in (
                    ("M6 edge", cc.m6_rows, cfg["tfe"] > 0),
                    ("normalize edge", cc.normalize_rows, cfg["normalize"]),
                    ("normalize edge after M6",
                     lambda c, F, s, pad: cc.normalize_rows(
                         c, F, s, pad=pad, epeak=True, npeak=True),
                     cfg["normalize"] and cfg["tfe"] > 0)):
                if not ok:
                    continue
                try:
                    rows[f"{label}, pad {pad}"] = build(cfg, 32, 730 + k,
                                                        pad=pad)[0]
                except IndexError:
                    print(f"[couple] {name}: no partition for the "
                          f"{label} rows at this config")
        rows.update(cc.instance_rows(cfg, 740 + 10 * k))
        for label, case in rows.items():
            tc = cc.torch_case(case, "cuda")
            F = tc.pop("F")
            err = max(err, _couple_check(
                f"{name.split(',')[0]}, {label}",
                (dev, tc.pop("md"), tc.pop("curve"), tc.pop("used"), F),
                tc))
    ran = Counter(couple_quantize.instances)
    ran.subtract(seen)
    missing = [k for k in INSTANCES if ran[k] < 1]
    print(f"[couple] launches by instantiation (partition, M6, normalize, "
          f"lanes M6, lanes normalize): "
          + ", ".join(f"{k} {ran[k]}" for k in INSTANCES))
    if missing:
        raise RuntimeError(f"3o launched no instantiation {missing}")
    inst = {d["key"]: d for d in couple_cuda.attrs(load_library())}
    for d in inst.values():
        print(f"[couple] instantiation {d['key']}: {d['registers']} "
              f"registers, {d['shared_bytes']} bytes of static shared "
              f"memory, {d['local_bytes']} local bytes a thread, "
              f"{d['blocks_per_sm']} blocks of one warp an SM")
    build = _build_lines(report)
    print(f"[couple] build: {build or 'cached'}")
    so, _ = couple_cuda.build(timing=True)
    timed = couple_cuda.bind(ctypes.CDLL(str(so)), stamps=True)
    rec = {}
    for name, a, kw in cases[:2]:
        F, n2 = a[4], a[1].shape[-1]
        key = args(*a, **kw)[4]
        d = inst[key]
        wpf, blocks = geometry(n2, key[0], F)
        print(f"[couple] {name}: instantiation {key}, {d['registers']} "
              f"registers, {d['blocks_per_sm']} warps an SM; {wpf} warps a "
              f"frame ({32 * BPT[key[0]]} bins a warp), {blocks} blocks of "
              f"one warp, no shared memory")
        mine = (lambda a=a, kw=kw: couple_quantize(*a, **kw))
        theirs = None
        if baseline is not None:
            theirs = (lambda a=a, kw=kw: baseline(a, kw))
            got, want = theirs(), mine()
            torch.cuda.synchronize()
            if not (torch.equal(got[0].view(torch.int32),
                                want[0].view(torch.int32))
                    and torch.equal(got[1], want[1])):
                raise RuntimeError(f"3o {name}: the first design's output "
                                   f"differs from this one's")
        ts, tb = _turns(mine, theirs)
        ms, lo, hi = _med(ts)
        plain_k, plain_dev = _device_profile(
            lambda: couple_quantize_plain(*a, **kw))
        plain_ms = _cuda_ms(lambda: couple_quantize_plain(*a, **kw), 3)
        bound_ms, by, nb, fo = _couple_bound(a, kw)
        print(f"[couple] {name} F={F}: kernel {ms:.5f} ms (CUDA graphs; "
              f"median of {len(ts)}, {lo:.5f}-{hi:.5f}); bound "
              f"{bound_ms * 1e3:.3f} us by {by} ({nb} bytes, {fo} float32 "
              f"operations), share {100 * bound_ms / ms:.1f}%; plain "
              f"{plain_ms:.4f} ms a call, {plain_k} device kernels "
              f"({plain_dev:.4f} ms on the device); library call: none "
              f"({smi})")
        extra = {}
        if tb:
            bms, blo, bhi = _med(tb)
            print(f"[couple] {name}: in turns, the first design (e6f7150) "
                  f"{bms:.5f} ms ({blo:.5f}-{bhi:.5f}), share "
                  f"{100 * bound_ms / bms:.1f}%, against this design's "
                  f"{ms:.5f} ms ({100 * bound_ms / ms:.1f}%), "
                  f"{bms / ms:.2f}x, outputs equal ({smi})")
            extra = dict(baseline_ms=bms, baseline_rounds_ms=tb,
                         baseline_share=bound_ms / bms)
        ph = _couple_phases(timed, a, kw)
        print(f"[couple] {name}: a frame {ph['frame']:.0f} cycles (median "
              f"{ph['frame_median']:.0f}); a phase's slowest warp: "
              + ", ".join(f"{n} {c:.0f}" for n, c in
                          zip(PHASES, ph["slowest"]))
              + f" (timing build, clock64; {smi})")
        rec[name] = dict(frames=F, n2=n2, ms=ms, rounds_ms=ts,
                         plain_ms=plain_ms, plain_kernels=plain_k,
                         plain_device_ms=plain_dev, bound_ms=bound_ms,
                         bound_by=by, bytes=nb, share=bound_ms / ms,
                         instance=list(key), registers=d["registers"],
                         shared_bytes=d["shared_bytes"], threads=32,
                         blocks=blocks, blocks_per_sm=d["blocks_per_sm"],
                         phases=dict(ph, names=list(PHASES)), build=build,
                         **extra)
    main = rec["4d long batch"]
    return dict({k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "share")},
                max_abs_err=err, library_ms=None, at_long=main,
                at_short=rec["4d short batch"],
                instances=[dict(d, key=list(d["key"]))
                           for d in inst.values()])


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
    _path_reset()
    t0 = time.perf_counter()
    oggs = f51.encode_batch(streams)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    _path_add("4g")
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
    the CPU, >= 90% of qpost rows equal, its floor_encode call held
    bitwise to the plain version (_fenc_path_check); the roundtrip's
    time.  7c: LBG,
    65,536 clustered 4-dim points, 256 entries, iters = 40, on the card
    and on numpy: final MSE within 25%, both times.  Returns the
    record (launches of each kernel, readings)."""
    import numpy as np
    import pytest
    import torch
    from vorbis_tpu_torch.models.fastenc import FastEncoder
    from vorbis_tpu_torch.models import pipeline
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
        _path_reset()
        pk, nb = step(frames)
        torch.cuda.synchronize()
        _path_add("7a")
        fl = fe.floor.launches
        rec["floor_7a"] = rec.get("floor_7a", 0) + fl
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
    _path_reset()
    out7 = []
    recorded = _record_floor_encode(lambda: out7.append(
        pipe.encode_quantize_step(torch.from_numpy(rows).to(cuda0))),
        pipeline)
    qc, rc = out7[0]
    torch.cuda.synchronize()
    _path_add("7b")
    fq = pipe.floor_fit.launches - fe_launch0
    # its curve and qposts, bitwise to the plain version (the fit's
    # quantize_posts and render) at the inputs the step gave the kernel
    rec["floor_encode_err"] = _fenc_path_check("7b encode_quantize_step",
                                               recorded, 171)
    qh, rh = pipe_cpu.encode_quantize_step(rows)
    q_share = float((qc.cpu() == qh).all(1).float().mean())
    r_share = float((rc.cpu() == rh).all(1).float().mean())
    print(f"[7b] encode_quantize_step of {len(rows)} rows, card against the "
          f"CPU: qpost rows equal {q_share:.4f}, residue rows equal "
          f"{r_share:.4f}; floor launches {fq}, floor_encode "
          f"{PATH_LAUNCHES['7b'][2]} (P = {pipe.floor_cfg.P})")
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
    rec["floor_7b"] = fq
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
            _path_reset()
            for kind in kinds:
                fast[kind, q, rate, secs, ch] = fe.encode(
                    _gate_signal(kind, rate, secs, ch))
            torch.cuda.synchronize()
            launches[0] += _launches(fe)
            _path_add("8")
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
    ap.add_argument("--floor-encode-baseline", metavar="SOURCE",
                    help="the first csrc/floor_encode.cu (git show e7acfc3:"
                         "vorbis_tpu_torch/csrc/floor_encode.cu, checked by "
                         "its hash) to time in turns with this one in "
                         "phase 3j")
    ap.add_argument("--tone-mask-baseline", metavar="SOURCE",
                    help="the first csrc/tone_mask.cu (git show c40e5f8:"
                         "vorbis_tpu_torch/csrc/tone_mask.cu, checked by its "
                         "hash) to time in turns with this one in phase 3k")
    ap.add_argument("--couple-baseline", metavar="SOURCE",
                    help="the first csrc/couple_quantize.cu (git show "
                         "e6f7150:vorbis_tpu_torch/csrc/couple_quantize.cu, "
                         "checked by its hash) to time in turns with this "
                         "one in phase 3o")
    ap.add_argument("--residue-baseline", metavar="SOURCE",
                    help="csrc/residue_encode.cu before its Hopper redesign "
                         "(git show f26b635:vorbis_tpu_torch/csrc/"
                         "residue_encode.cu, checked by its hash) to time "
                         "in turns with this one in phase 3l")
    ap.add_argument("--prepare-baseline", metavar="SOURCE",
                    help="csrc/floor_prepare.cu before its Hopper redesign "
                         "(git show f26b635:vorbis_tpu_torch/csrc/"
                         "floor_prepare.cu, checked by its hash) to time in "
                         "turns with this one in phase 3n")
    ap.add_argument("--pack-baseline", metavar="SOURCE",
                    help="the first csrc/pack_bits.cu (git show 4c76a5d:"
                         "vorbis_tpu_torch/csrc/pack_bits.cu, checked by its "
                         "hash) to time in turns with this one in phase 3m")
    for name in ("mdct_fwd", "bark_fit"):
        ap.add_argument(f"--{name.replace('_', '-')}-baseline",
                        metavar="SOURCE",
                        help=f"the first csrc/{name}.cu (git show 0716f4b:"
                             f"vorbis_tpu_torch/csrc/{name}.cu, checked by "
                             f"its hash) to time in turns with this one in "
                             f"phase 3i")
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
    from vorbis_tpu_torch.ops import (bark_cuda, couple_cuda, floor_cuda,
                                      floor_encode_cuda, imdct_cuda,
                                      lap_cuda, m3_cuda, mdct_cuda,
                                      pack_cuda, residue_encode_cuda,
                                      tone_mask_cuda)
    t0 = time.perf_counter()
    jobs = {"floor_fit.cu": floor_cuda.build,
            "floor_prepare.cu": floor_cuda.build_prepare,
            "floor_encode.cu": floor_encode_cuda.build,
            "m3_scan.cu": m3_cuda.build,
            "imdct.cu": imdct_cuda.build,
            "lap.cu": lap_cuda.build,
            "mdct_fwd.cu": mdct_cuda.build,
            "bark_fit.cu": bark_cuda.build,
            "tone_mask.cu": tone_mask_cuda.build,
            "residue_encode.cu": residue_encode_cuda.build,
            "residue_encode.cu, timing build":
                lambda: residue_encode_cuda.build(timing=True),
            "floor_prepare.cu, timing build":
                lambda: floor_cuda.build_prepare(timing=True),
            "pack_bits.cu": pack_cuda.build,
            "couple_quantize.cu": couple_cuda.build,
            "couple_quantize.cu, timing build":
                lambda: couple_cuda.build(timing=True),
            "host_ogg.c": native.build_host,
            "host_decode.c": native.build_decode,
            "host_pack.c": native.build_pack}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(f) for k, f in jobs.items()}
        built = {k: f.result() for k, f in futs.items()}
    floor_cuda.load_library()
    floor_cuda.load_prepare_library()
    floor_encode_cuda.load_library()
    m3_cuda.load_library()
    imdct_cuda.load_library()
    lap_cuda.load_library()
    mdct_cuda.load_library()
    bark_cuda.load_library()
    tone_mask_cuda.load_library()
    residue_encode_cuda.load_library()
    pack_cuda.load_library()
    couple_cuda.load_library()
    native.host_library()
    native.decode_library()
    native.pack_library()
    print(f"[build] {len(built)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for k, (so, log) in built.items():
        print(f"[build] {k} -> {so.relative_to(HERE)}")
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build]   {line.strip()}")

    # every call of the tone mask's two callers, and every finish call's
    # residue blocks, is counted from here on
    _count_tone_calls()
    _count_finish_calls()

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

    # the encoders of phases 3b-4g
    fsw = FastEncoder(2, 44100, 0.5)
    if not (fsw.switching and fsw.psy_state):
        raise RuntimeError("switching and psy_state are not the defaults")
    abr = (-1, 128000, -1)
    fm = FastEncoder(2, 44100, bitrate=abr)
    fm_cpu = FastEncoder(2, 44100, bitrate=abr, device="cpu")
    f51 = FastEncoder(6, 48000, 0.4)

    # 3j. the floor's post coding at the main path's shapes, and 4d's
    # finish batches split by stage.  It runs first of the 3x phases: its
    # split counts each stage's device kernels with torch.profiler, which
    # after phases 3b-3i saw three device events fewer a profiled call,
    # the floor-encode kernel among them
    fenc_rec, tone_cases, res_cases, pack_cases, prep_cases, cpl_cases = \
        _phase_floor_encode(fsw, fm, f51, smi,
                            _FencBaseline(args.floor_encode_baseline)
                            if args.floor_encode_baseline else None,
                            built["floor_encode.cu"][1])
    _lap(t_start, "3j")

    # 3k. the tone mask on 3j's recorded calls, its times and bound
    tone_rec = _phase_tone_mask(
        tone_cases, smi, built["tone_mask.cu"][1],
        _ToneBaseline(args.tone_mask_baseline)
        if args.tone_mask_baseline else None)
    del tone_cases
    _lap(t_start, "3k")

    # 3l. the residue path on 3j's recorded calls, its times and bound
    res_rec = _phase_residue_encode(
        res_cases, smi, built["residue_encode.cu"][1],
        _ResidueBaseline(args.residue_baseline)
        if args.residue_baseline else None)
    del res_cases
    _lap(t_start, "3l")

    # 3m. the packer on 3j's recorded calls, its times and bound
    pack_rec = _phase_pack(pack_cases, smi, built["pack_bits.cu"][1],
                           _PackBaseline(args.pack_baseline)
                           if args.pack_baseline else None)
    del pack_cases
    _lap(t_start, "3m")

    # 3n. the floor fit's prepare on 3j's recorded calls
    prep_rec = _phase_floor_prepare(
        prep_cases, smi, built["floor_prepare.cu"][1],
        _PrepareBaseline(args.prepare_baseline)
        if args.prepare_baseline else None)
    del prep_cases
    _lap(t_start, "3n")

    # 3o. the stereo coupling on 3j's recorded calls
    cpl_rec = _phase_couple(cpl_cases, smi, built["couple_quantize.cu"][1],
                            _CoupleBaseline(args.couple_baseline)
                            if args.couple_baseline else None)
    del cpl_cases
    _lap(t_start, "3o")

    # 3b. the M3 scan kernel vs its plain version, times and bounds
    m3_rec = _phase_m3(fsw, smi, args.m3_baseline)
    _lap(t_start, "3b")

    # 3f. the managed finish: stacked floor fit, M3 calls, card vs CPU
    fl_err_m, m3_err_m = _phase_managed_kernels(fm, fm_cpu, smi)
    max_err = max(max_err, fl_err_m)
    m3_rec["max_abs_err"] = max(m3_rec["max_abs_err"], m3_err_m)
    _lap(t_start, "3f")

    # 3g. both kernels at the shapes of the 5.1 encoder
    fl_err_51, fl_rec_51, m3_err_51, m3_rec_51 = _phase_51_kernels(f51, smi)
    max_err = max(max_err, fl_err_51)
    m3_rec["max_abs_err"] = max(m3_rec["max_abs_err"], m3_err_51)
    _lap(t_start, "3g")

    # 3h. the fast decode on the card against the scalar decoder, before
    # phases 4-4g read their streams with it
    _phase_decode_vs_scalar(fsw, fm, f51)
    _lap(t_start, "3h")

    # 3i. the analysis front's two kernels at the main path's shapes,
    # and the host-pack encode against the device packer
    front_rec, hostpack_fits, fenc_err = _phase_front(fsw, f51, smi, {
        name: _FrontBaseline(src, name) for name, src in (
            ("mdct_fwd", args.mdct_fwd_baseline),
            ("bark_fit", args.bark_fit_baseline)) if src})
    fenc_rec["max_abs_err"] = max(fenc_rec["max_abs_err"], fenc_err)
    _lap(t_start, "3i")

    # 4. main path at real size
    secs = pcm16.shape[1] / 44100
    pcm_dev = torch.from_numpy(pcm16).cuda()
    fe.encode(pcm_dev)                              # warm-up
    torch.cuda.synchronize()
    floor.launches = 0
    _path_reset()
    t0 = time.perf_counter()
    ogg = fe.encode(pcm_dev)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    launches = floor.launches
    _path_add("4")
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
    _path_reset()
    t0 = time.perf_counter()
    ogg_s = fs.encode(pcm_dev)
    torch.cuda.synchronize()
    t_sdev = time.perf_counter() - t0
    launches_s = _launches(fs)
    _path_add("4b")
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
    _path_reset()
    t0 = time.perf_counter()
    oggs = fs.encode_batch(streams)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    launches_b = _launches(fs)
    _path_add("4c")
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
        _path_reset()
        t0 = time.perf_counter()
        oggs = fsw.encode_batch(streams)
        torch.cuda.synchronize()
        t_sw = time.perf_counter() - t0
        _path_add("4d")
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
    _path_reset()
    t0 = time.perf_counter()
    ogg_e = fsw.encode(click0)
    torch.cuda.synchronize()
    t_e = time.perf_counter() - t0
    _path_add("4e")
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
    differ = [i for i, (a, b) in enumerate(zip(on_card, on_cpu)) if a != b]
    print(f"[card-vs-cpu] identical packets {same}/{len(on_card)} "
          f"(differing {differ})")
    if same < 0.9 * len(on_card):
        raise RuntimeError("card and CPU packets differ in more than 10%")
    if differ:
        _localize(dev, fe_cpu.dev, torch.from_numpy(clip).cuda(),
                  torch.from_numpy(clip), differ[0], len(on_card))

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
    fenc_rec["max_abs_err"] = max(fenc_rec["max_abs_err"],
                                  p7["floor_encode_err"])
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

    # the floor's post coding: one launch a finish call a floor look, as
    # the floor fit, in every main-path run
    fits = {"3i": hostpack_fits, "4": launches, "4b": launches_s,
            "4c": launches_b,
            "4d": launches_sw["signal"][0] + launches_sw["click_train"][0],
            "4e": launches_sw["encode"][0],
            "4f": launches_sw["managed"][0], "4g": launches_sw["5.1"][0],
            "7a": p7["floor_7a"], "7b": p7["floor_7b"], "8": p8_floor}
    fenc = {k: v[2] for k, v in PATH_LAUNCHES.items()}
    print(f"[floor encode] launches by phase {fenc}, floor fit's {fits}")
    if fenc != fits:
        raise RuntimeError("floor_encode did not launch once a finish call "
                           "a floor look")
    # the tone mask: one launch a finish step or mask_components call,
    # held phase by phase in _path_add
    tone = {k: v[3] for k, v in PATH_LAUNCHES.items()}
    print(f"[tone mask] launches by phase {tone}, each equal to the "
          f"phase's finish steps and mask_components calls")
    # the residue path: one launch a finish call a residue submap, held
    # phase by phase in _path_add
    resl = {k: v[4] for k, v in PATH_LAUNCHES.items()}
    print(f"[residue encode] launches by phase {resl}, each equal to the "
          f"phase's finish calls x residue submaps")
    # the packer: one launch a finish call, held phase by phase in
    # _path_add; the prepare: one launch a floor fit launch
    packl = {k: v[5] for k, v in PATH_LAUNCHES.items()}
    print(f"[pack] launches by phase {packl}, each equal to the phase's "
          f"finish calls")
    prepl = {k: v[6] for k, v in PATH_LAUNCHES.items()}
    print(f"[floor prepare] launches by phase {prepl}, floor fit's {fits}")
    if prepl != fits:
        raise RuntimeError("floor_prepare did not launch once a floor fit "
                           "launch")
    # the coupling: one launch a stereo finish_from_posts call, held phase
    # by phase in _path_add (none in 3i, 4g and 7b)
    cpll = {k: v[7] for k, v in PATH_LAUNCHES.items()}
    print(f"[couple] launches by phase {cpll}, each equal to the phase's "
          f"stereo finish_from_posts calls")
    if any(v == 0 for k, v in cpll.items() if k not in NO_COUPLE):
        raise RuntimeError("couple_quantize launched no time in a phase "
                           "with stereo finish calls")
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
        "name": "floor_encode", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/floor_encode.cu",
        "replaces": "vorbis_tpu/ops/encdevice.py:671-765 (_floor_wrap, "
                    "_floor_fields) and vorbis_tpu/ops/floor_device.py:396 "
                    "(render), jitted XLA",
        "launches": sum(fenc.values()), "by_phase": fenc, **fenc_rec}, {
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
        **lap_rec}, {
        "name": "mdct_fwd", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/mdct_fwd.cu",
        "replaces": "vorbis_tpu/ops/jaxdsp.py:271-272 (mdct_forward, "
                    "mdct.py:383, and log_spectrum in the jitted spectra)",
        "launches": sum(v[0] for v in PATH_LAUNCHES.values()),
        "by_phase": {k: v[0] for k, v in PATH_LAUNCHES.items()},
        **front_rec["mdct_fwd"]}, {
        "name": "bark_fit", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/bark_fit.cu",
        "replaces": "vorbis_tpu/ops/jaxdsp.py:273-284 (the two bark_fit "
                    "calls, :93, and the compand index of the jitted "
                    "spectra)",
        "launches": sum(v[1] for v in PATH_LAUNCHES.values()),
        "by_phase": {k: v[1] for k, v in PATH_LAUNCHES.items()},
        **front_rec["bark_fit"]}, {
        "name": "tone_mask", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/tone_mask.cu",
        "replaces": "vorbis_tpu/ops/jaxdsp.py:477-558 (DeviceToneMask."
                    "__call__, jitted XLA)",
        "launches": sum(tone.values()), "by_phase": tone, **tone_rec}, {
        "name": "residue_encode", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/residue_encode.cu",
        "replaces": "vorbis_tpu/ops/encdevice.py:767-1000 (_classify, "
                    "_vq_stages, _residue_fields, _classify2; jitted XLA)",
        "launches": sum(resl.values()), "by_phase": resl, **res_rec}, {
        "name": "pack_packets", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/pack_bits.cu",
        "replaces": "vorbis_tpu/ops/encdevice.py:241-360 (merge_columns, "
                    "_merge_limb_pairs, pack_bits_device; jitted XLA)",
        "launches": sum(packl.values()), "by_phase": packl, **pack_rec}, {
        "name": "floor_prepare", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/floor_prepare.cu",
        "replaces": "vorbis_tpu/ops/floor_device.py:114-145 and 199-208 "
                    "(the quantization and _moments of the jitted fit)",
        "launches": sum(prepl.values()), "by_phase": prepl, **prep_rec}, {
        "name": "couple_quantize", "route": "cuda",
        "source": "vorbis_tpu_torch/csrc/couple_quantize.cu",
        "replaces": "vorbis_tpu/ops/encdevice.py:1011-1174 and 1448-1500 "
                    "(_m6_promote, _couple_quantize, _normalize_promote) "
                    "and 1525-1536 (finish_from_posts' lowpass and "
                    "interleave; jitted XLA)",
        "launches": sum(cpll.values()), "by_phase": cpll, **cpl_rec}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
