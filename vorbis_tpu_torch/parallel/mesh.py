"""Device mesh and sharding for the batched codec (counterpart of
vorbis_tpu/parallel/mesh.py).

The reference is strictly single-threaded frame-serial C; its only
parallelism is SIMD (SURVEY.md §2 items 22-23).  Here the scale-out
model is the JAX module's: independent audio streams ride a `dp`
(data-parallel) mesh axis, frames within a stream ride `sp`
(sequence-parallel).  Encode analysis is embarrassingly parallel;
decode's overlap-add is the one cross-frame dependency, a halo of n/2
samples that each sp shard hands to the next.

In PyTorch's idiom a mesh is a (dp, sp) grid of `torch.device`, a shard
a slice of the batch moved onto its entry's device, and a sharded step
a loop over the shards that runs the single-device code there (the
kernels of that device), one set of tables a distinct device, built
once.  The halo is a plain `.to(device)` copy, no collectives library,
and the results are gathered on the mesh's first device in (dp, sp)
order.  A device may repeat in the list (one card, or the CPU, standing
in for several): the split's results must equal the unsplit step's all
the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.encdevice import DeviceFastEncode


class CodecMesh:
    """A (dp, sp) grid of devices: `devices` is the (dp, sp) object
    array of `torch.device`, `flat` the entries in (dp, sp) order."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.flat = list(devices.reshape(-1))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return len(self.flat)

    def distinct(self) -> list:
        """The mesh's devices, each once, in (dp, sp) order."""
        return list(dict.fromkeys(self.flat))


def _canonical(device) -> torch.device:
    """`device` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_codec_mesh(n_devices: int | None = None,
                    devices=None) -> CodecMesh:
    """Build a (dp, sp) mesh over `devices` (default: every CUDA
    device), preferring the squarest factorization (dp x sp).  Raises
    where there are fewer devices than `n_devices`: nothing stands in
    for a missing card unless the caller lists it."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "make_codec_mesh: no CUDA device; pass devices=[...] "
                "(e.g. [torch.device(\"cpu\")] * 8) to shard on the CPU")
    devices = [_canonical(d) for d in devices]
    n = n_devices or len(devices)
    if len(devices) < n:
        raise RuntimeError(f"make_codec_mesh: {n} devices asked for, "
                           f"{len(devices)} available")
    dp = 1
    for cand in range(int(n ** 0.5), 0, -1):
        if n % cand == 0:
            dp = cand
            break
    sp = n // dp
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return CodecMesh(grid.reshape(dp, sp))


def shard_frames(mesh: CodecMesh, frames) -> list:
    """A (streams, channels, frames, n) batch cut into the mesh's
    shards: streams->dp, frames->sp.  Returns the (dp, sp) grid (lists)
    of float32 tensors, each on its entry's device."""
    frames = torch.as_tensor(frames, dtype=torch.float32)
    dp, sp = mesh.devices.shape
    S, F = frames.shape[0], frames.shape[2]
    if S % dp or F % sp:
        raise ValueError(f"shard_frames: {S} streams and {F} frames do "
                         f"not split over a {dp} x {sp} mesh")
    s, f = S // dp, F // sp
    return [[frames[i * s:(i + 1) * s, :, j * f:(j + 1) * f]
             .to(mesh.devices[i, j]) for j in range(sp)]
            for i in range(dp)]


def sharded_roundtrip_step(pipe, mesh: CodecMesh):
    """The pipeline's full roundtrip step over the mesh: frames
    (S, ch, F, n) -> (pcm (S, ch, F*n/2), err) on the mesh's first
    device.  Each sp shard but the first starts its two syntheses from
    the previous shard's halo (its last frame's windowed second half),
    copied onto its device; err combines the shards' sums of
    squares."""
    home = _canonical(pipe.device)
    pipes = {d: pipe if d == home else pipe.to(d) for d in mesh.distinct()}
    first = mesh.flat[0]

    def step(frames):
        shards = shard_frames(mesh, frames)
        dp, sp = mesh.devices.shape
        rows, sums = [], []
        for i in range(dp):
            pcms, halos = [], (None, None)
            for j in range(sp):
                device = mesh.devices[i, j]
                tails = tuple(None if h is None else h.to(device)
                              for h in halos)
                pcm, ss, halos = pipes[device].roundtrip_shard(
                    shards[i][j], tails, halo=j < sp - 1)
                pcms.append(pcm.to(first))
                sums.append(ss.to(first))
            rows.append(torch.cat(pcms, -1))
        pcm = torch.cat(rows, 0)
        err = torch.sqrt(torch.stack(sums).sum() / pcm.numel())
        return pcm, err.float()

    return step


def sharded_encode_step(dev, mesh: CodecMesh, F: int):
    """The REAL production encode step — the full DeviceFastEncode
    pipeline (masking -> floor1 fit -> post wrap coding -> residue VQ
    -> Huffman codeword lookup -> bit packing) — with the frame axis
    split over every mesh entry in (dp, sp) order (per-frame math has
    no cross-frame dependency, so the sharded packets are bitwise
    identical to single-device output).

    dev: ops.encdevice.DeviceFastEncode; on each other device of the
    mesh the same encoder is built once (FastEncoder.to).  F: frames
    per step, divisible by mesh.size.  Returns a callable
    frames (F, ch, n) -> (packets (F, wb) uint8, nbits (F,) int32) on
    the mesh's first device."""
    if F % mesh.size:
        raise ValueError(f"sharded_encode_step: F={F} does not split "
                         f"over {mesh.size} devices")
    Fs = F // mesh.size
    home = _canonical(dev.device)
    steps = {}
    for d in mesh.distinct():
        dd = dev if d == home else DeviceFastEncode(
            dev.fe.to(d), chunk_packets=dev.chunk_packets, W=dev.W)
        steps[d] = dd.make_framed_step(Fs)
    first = mesh.flat[0]

    def step(frames):
        frames = torch.as_tensor(frames, dtype=torch.float32)
        outs = [steps[d](frames[k * Fs:(k + 1) * Fs].to(d))
                for k, d in enumerate(mesh.flat)]
        return (torch.cat([pk.to(first) for pk, _ in outs]),
                torch.cat([nb.to(first) for _, nb in outs]))

    return step
