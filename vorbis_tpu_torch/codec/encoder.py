"""Vorbis encoder: PCM -> packets.

Host reference path assembling the validated bit-exact stages:
windowing + forward MDCT/FFT (ops.mdct), psychoacoustics (ops.psy),
floor fitting/encoding (floor1_codec), coupling/quantization (ops.psy),
residue VQ (residue_codec), with the block-switching state machine and
granulepos bookkeeping of the reference (lib/block.c encode side,
lib/analysis.c, lib/mapping0.c mapping0_forward, lib/bitrate.c).

The packet bits produced must be byte-identical to the reference
encoder for the same PCM — that is the test contract
(tests/test_encoder.py).

Copy of vorbis_tpu/codec/encoder.py :1-150, kept line-aligned with it:
`Encoder.__init__` up to the psy, floor and residue looks, and
`header_packets`.  The port's encoder (models/fastenc.py) takes its
looks and header packets from here; the scalar encode loop, its
envelope, dsp state and bitrate manager stay behind.
"""

from __future__ import annotations

from ..bitstream.bitpack import ilog
from ..models.encsetup import EncoderSetup
from ..ops import psy as PSY
from . import headers as H
from .floor1_codec import Floor1Look
from .residue_codec import ResidueLook


class Encoder:
    def __init__(self, setup: EncoderSetup):
        self.bit_stats = {"packets": 0, "glue_bits": 0,
                          "floor_bits": 0, "res_bits": 0,
                          "packet_bits": 0}
        self.s = setup
        vi = setup.vi
        self.vi = vi
        self.ch = vi.channels
        self.rate = vi.rate
        bs = vi.blocksizes
        self.bs = bs
        self.modebits = ilog(len(vi.modes) - 1)

        # psy looks per blocktype
        self.psy_looks = [PSY.PsyLook(p, setup.psy_global,
                                      bs[p["blockflag"]] // 2, vi.rate)
                          for p in setup.psy_params]
        self.floor_looks = []
        for f in setup.floor_full:
            info = H.Floor1Info(
                f["partitions"], f["partitionclass"][:f["partitions"]],
                f["class_dim"], f["class_subs"], f["class_book"],
                f["class_subbook"], f["mult"],
                ilog(f["postlist"][1] - 1),
                f["postlist"][:2 + sum(
                    f["class_dim"][f["partitionclass"][i]]
                    for i in range(f["partitions"]))],
                maxover=f["maxover"], maxunder=f["maxunder"],
                maxerr=f["maxerr"], twofitweight=f["twofitweight"],
                twofitatten=f["twofitatten"])
            # NB: the fit domain is postlist[1] (Floor1Look.n); the
            # encoder lowpass f["n"] only feeds offset_and_mix end_block
            self.floor_looks.append(Floor1Look(info))
        self.residue_looks = [ResidueLook(r, vi.books)
                              for r in vi.residues]

    # ------------------------------------------------------------------
    def header_packets(self, comments=None):
        # memoized: the setup header alone costs ~25 ms to pack and is
        # identical for every stream of a batch encode
        key = tuple(comments or [])
        cached = getattr(self, "_hdr_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        vi = self.vi
        vi.comments = list(key)
        pkts = [H.pack_id_header(vi), H.pack_comment_header(vi),
                H.pack_setup_header(vi)]
        self._hdr_cache = (key, pkts)
        return pkts
