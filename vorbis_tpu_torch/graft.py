"""Entry points: the single-device encode step and the multi-device dry
run (counterpart of the repository's __graft_entry__.py)."""

import numpy as np
import torch


def entry(device=None):
    """Returns (fn, example_args): a forward step on the flagship model
    — the full on-device encode pipeline (window -> MDCT+FFT -> psy
    masking -> floor1 fit -> post wrap coding -> residue VQ -> Huffman
    codeword lookup -> bit packing), raw PCM frames in, packed Vorbis
    packets out.  `device`: the card unless given (FastEncoder's
    default)."""
    from .models.fastenc import FastEncoder
    from .ops.encdevice import DeviceFastEncode

    fe = FastEncoder(2, 44100, 0.5, device=device)
    F = 8
    dev = DeviceFastEncode(fe, chunk_packets=F)
    frames = (np.random.RandomState(0).randn(F, fe.ch, fe.n)
              * 0.1).astype(np.float32)
    return dev.make_framed_step(F), (torch.from_numpy(frames)
                                     .to(fe.device),)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Create an n_devices mesh (dp x sp) over `devices` (default: every
    CUDA device; too few raise), run the FULL codec step over it
    (encode analysis + masked quantization + decode synthesis with its
    cross-frame overlap-add halo) and the sharded encode step once on
    tiny shapes, and check both invariants.  Nothing is pinned to the
    CPU: the caller's device list decides (a list may repeat a
    device)."""
    from .models.fastenc import FastEncoder
    from .models.pipeline import TorchCodecPipeline
    from .ops.encdevice import DeviceFastEncode
    from .parallel import (make_codec_mesh, sharded_encode_step,
                           sharded_roundtrip_step)

    mesh = make_codec_mesh(n_devices, devices=devices)
    dp, sp = mesh.devices.shape
    home = mesh.flat[0]

    # 1) the REAL production encode step, frame axis sharded over the
    # whole mesh: masking -> floor1 fit -> post wrap coding -> residue
    # VQ -> Huffman codeword lookup -> on-device bit packing.  Packets
    # must be bitwise identical to the single-device step (per-frame
    # math only; sharding cannot change it).
    fe = FastEncoder(2, 44100, 0.5, device=home)
    F = 2 * n_devices
    dev = DeviceFastEncode(fe, chunk_packets=F)
    step = sharded_encode_step(dev, mesh, F)
    rng = np.random.RandomState(0)
    frames = torch.from_numpy(
        (rng.randn(F, fe.ch, fe.n) * 0.1).astype(np.float32))
    pk, nb = step(frames)
    pk1, nb1 = dev.make_framed_step(F)(frames.to(home))
    if not (torch.equal(pk, pk1) and torch.equal(nb, nb1)):
        raise AssertionError("sharded encode packets differ from the "
                             "single-device step")
    if not bool((nb > 0).all()):
        raise AssertionError("an empty packet")

    # 2) the synthesis halo: decode-side overlap-add is the one
    # cross-frame dependency (frames ride sp; each shard takes the
    # previous shard's halo)
    pipe = TorchCodecPipeline(ch=2, rate=44100, quality=0.4, device=home)
    rstep = sharded_roundtrip_step(pipe, mesh)
    rframes = np.random.RandomState(1).randn(
        dp * 2, 2, sp * 2, pipe.n).astype(np.float32)
    pcm, err = rstep(rframes)
    if tuple(pcm.shape) != (dp * 2, 2, sp * 2 * (pipe.n // 2)):
        raise AssertionError(f"roundtrip pcm shape {tuple(pcm.shape)}")
    if not np.isfinite(float(err)):
        raise AssertionError(f"roundtrip err {float(err)}")
