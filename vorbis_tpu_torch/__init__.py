"""vorbis_tpu_torch — the PyTorch + CUDA port of vorbis_tpu.

The JAX package `vorbis_tpu` stays the reference; this package mirrors
its layout and names (`ops/torchdsp.py` is the counterpart of
`ops/jaxdsp.py`, `ops/floor_cuda.py` of `ops/floor_pallas.py`, and so
on) and imports nothing of it: the host layers it runs (bitstream, the
codec's headers, codebooks, floor1 and residue codecs and decoder,
encsetup, the psy model, envelope, window, rdft, the numpy MDCT, data/)
are its own line-aligned copies.  The package exports the encoders as
vorbis_tpu does: `FastEncoder` (the device encoder, on the card unless
the caller passes device="cpu") and `encode_vbr_stream(pcm, rate, q)`,
the scalar golden encoder (host numpy, `codec/encoder.py`: the same
bytes as the JAX package's), which the port's quality gates hold
`FastEncoder` to.  Device code is plain torch on an explicit device; the
hand-written kernels (the floor1 greedy fit `csrc/floor_fit.cu`, the M3
scan `csrc/m3_scan.cu`, the decode's IMDCT `csrc/imdct.cu` and its
windowed lap `csrc/lap.cu`) are built with nvcc and the host C
(`csrc/host_ogg.c`, `csrc/host_decode.c`) with cc at first use
(`native.py`).  The decode's `ov_*` layer is `vorbisfile.py`; the
roundtrip pipeline `models/pipeline.py`, its split over a list of
devices `parallel/`, the dry run `graft.py` and VQ training `vq/`.

Importing the package sets the fp32 policy the reference runs under:
the JAX side computes its matmuls at Precision.HIGHEST, so TF32 is off
for both cuBLAS and cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def fp32_policy_ok() -> bool:
    """True when the process still runs fp32 matmuls in full fp32."""
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def __getattr__(name):
    """The public API, imported at first use (as vorbis_tpu exports it):
    the encoders `FastEncoder` and the golden `encode_vbr_stream`, the
    decode's `decode_ogg_fast`, `decode_ogg_fast_batch`, `FastDecoder`,
    the `ov_*` layer's `OggVorbisFile` and `decode_file`, and the scalar
    `decode_ogg`."""
    if name == "FastEncoder":
        from .models.fastenc import FastEncoder
        return FastEncoder
    if name == "encode_vbr_stream":
        from .codec.encoder import encode_vbr_stream
        return encode_vbr_stream
    if name in ("decode_ogg_fast", "decode_ogg_fast_batch", "FastDecoder"):
        from .models import fastdec
        return getattr(fastdec, name)
    if name in ("OggVorbisFile", "decode_file"):
        from . import vorbisfile
        return getattr(vorbisfile, name)
    if name == "decode_ogg":
        from .codec.decoder import decode_ogg
        return decode_ogg
    raise AttributeError(name)
