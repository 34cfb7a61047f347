"""Batched codec pipeline on the card: the flagship device model
(counterpart of vorbis_tpu/models/pipeline.py).

The reference processes one block at a time through a frame-serial
loop (lib/block.c, lib/analysis.c).  Here the same dataflow is one
step over a (streams, frames, n) batch:

  analysis  : window -> forward MDCT -> log spectrum -> two-pass bark
              noise fit -> companded noise mask        (DeviceAnalysis)
  synthesis : IMDCT kernel -> windowed lap kernel      (DeviceSynthesis)

Sharding model (SURVEY.md §7): streams ride the `dp` mesh axis, frames
within a stream ride `sp` (parallel/mesh.py).  Analysis is
embarrassingly parallel; the synthesis overlap-add is the one
cross-frame dependency, a halo each sp shard hands to the next.  Host
keeps only Huffman coding + Ogg framing (bitstream/).
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import device_tables
from ..ops.torchdsp import DeviceAnalysis, DeviceSynthesis
from . import encsetup

f32 = np.float32


class TorchCodecPipeline:
    """Batched long-block encode/decode compute spine for one codec
    config (channels/rate/quality) on `device` (default: "cuda"; with
    no card that raises, and the CPU takes device="cpu")."""

    def __init__(self, ch=2, rate=44100, quality=0.4, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchCodecPipeline runs on the card by default and no "
                    "CUDA device is available: pass device=\"cpu\" to run "
                    "it on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self._config = dict(ch=ch, rate=rate, quality=quality)
        self.setup = encsetup.setup_vbr(ch, rate, quality)
        self.n = self.setup.vi.blocksizes[1]
        self.analysis = DeviceAnalysis(self.setup, blocktype=3, rate=rate,
                                       device=self.device)
        self.synthesis = DeviceSynthesis(self.n, device=self.device)
        from ..codec import headers as H
        from ..codec.floor1_codec import Floor1Look, fromdB_lookup
        from ..ops.floor_cuda import make_floor_fit
        # long-block floor config (the encoder's floor for blocktype 3)
        fl = [f for f in self.setup.floor_full
              if f["postlist"][1] == self.n // 2]
        fd = (fl[-1] if fl else self.setup.floor_full[-1])
        info = H.Floor1Info(
            partitions=fd["partitions"],
            partitionclass=list(fd["partitionclass"]),
            class_dim=list(fd["class_dim"]),
            class_subs=list(fd["class_subs"]),
            class_book=list(fd["class_book"]),
            class_subbook=[list(r) for r in fd["class_subbook"]],
            mult=fd["mult"], rangebits=0,
            postlist=list(fd["postlist"]),
            maxover=fd["maxover"], maxunder=fd["maxunder"],
            maxerr=fd["maxerr"], twofitweight=fd["twofitweight"],
            twofitatten=fd["twofitatten"])
        # the floor-fit kernel on the card, its plain version on the CPU
        self.floor_fit = make_floor_fit(Floor1Look(info), self.device)
        self.fromdB = device_tables(
            {"fromdB": np.asarray(fromdB_lookup(), np.float32)},
            self.device)["fromdB"]

    def to(self, device) -> "TorchCodecPipeline":
        """This pipeline's configuration on `device`, its tables built
        there (self where it already runs on that device)."""
        if torch.device(device) == self.device:
            return self
        return TorchCodecPipeline(**self._config, device=device)

    def frame(self, pcm):
        """Host-side framing: (ch, samples) -> (ch, F, n) overlapping
        long blocks advancing n/2 (lib/block.c centerW walk)."""
        ch, ns = pcm.shape
        n = self.n
        hop = n // 2
        nf = max(1, (ns - n) // hop + 1)
        idx = np.arange(nf)[:, None] * hop + np.arange(n)[None, :]
        return np.ascontiguousarray(
            pcm[:, np.clip(idx, 0, ns - 1)].astype(np.float32))

    def _frames(self, frames):
        return torch.as_tensor(frames, dtype=torch.float32,
                               device=self.device)

    def encode_step(self, frames):
        """frames: (..., n) -> (mdct, logmdct, noise_mask)."""
        return self.analysis(self._frames(frames))

    def mask_step(self, frames):
        """Full psy fast path: MDCT + FFT + noise fit + tone seeding +
        offset/mix -> (mdct, logmdct, final_mask)."""
        return self.analysis.full_mask(self._frames(frames))

    def encode_quantize_step(self, frames):
        """Device encode through quantization: masking chain -> floor1
        fit -> stream post quantization -> rendered gain curve ->
        integer residues (reference: mapping0_forward through
        _vp_couple_quantize_normalize's uncoupled quantization).
        frames: (B, n).  Returns (qposts (B, P) int32, residues (B, n/2)
        int32)."""
        md, logmdct, mask = self.analysis.full_mask(self._frames(frames))
        posts, used = self.floor_fit(logmdct, mask)
        qposts = self.floor_fit.quantize_posts(posts)
        curve = self.floor_fit.render(qposts, self.fromdB)
        # rint quantization against the rendered floor; unused floors
        # (silent channels) produce zero residues
        r = md / curve
        res = torch.where(used[:, None], torch.round(r).to(torch.int32), 0)
        return qposts, res

    def roundtrip_step(self, frames):
        """Full device step: analyze (complete masking chain), floor
        the spectrum against the mask (the quantization decision),
        resynthesize, and measure reconstruction error.  This is the
        codec equivalent of a train step — every hot op of encode AND
        decode in one step."""
        pcm, ss, _ = self.roundtrip_shard(self._frames(frames))
        return pcm, torch.sqrt(ss / pcm.numel()).float()

    def roundtrip_shard(self, frames, tails=(None, None), halo=False):
        """The roundtrip of one shard of the frame axis: frames
        (..., F, n) on this device, tails the previous shard's halos of
        the quantized and the source synthesis (or None).  Returns
        (pcm (..., F*n/2), the float64 sum of squares of pcm - src,
        this shard's halos (quantized, source) where `halo`)."""
        md, logmdct, mask = self.analysis.full_mask(frames)
        # keep only components above the mask (the decision the
        # residue coder encodes; reference: _vp_couple_quantize_normalize)
        keep = logmdct >= mask
        quant = torch.where(keep, md, 0.0)
        if halo:
            pcm, hq = self.synthesis.with_halo(quant, tails[0])
            src, hs = self.synthesis.with_halo(md, tails[1])
        else:
            pcm = self.synthesis(quant, tails[0])
            src = self.synthesis(md, tails[1])
            hq = hs = None
        ss = torch.sum((pcm - src).double() ** 2)
        return pcm, ss, (hq, hs)


# the JAX package's name, for readers who look for it
TpuCodecPipeline = TorchCodecPipeline


def make_sharded_step(pipe: TorchCodecPipeline, mesh):
    """The full roundtrip step over a device mesh with streams->dp,
    frames->sp sharding (see parallel/mesh.py)."""
    from ..parallel.mesh import sharded_roundtrip_step
    return sharded_roundtrip_step(pipe, mesh)
