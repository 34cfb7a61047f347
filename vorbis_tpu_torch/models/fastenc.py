"""Torch counterpart of vorbis_tpu/models/fastenc.py: the batched fast
encoder, long-only stateless slice.

All DSP decisions (masking, floor fit, coupling, residue VQ, codeword
lookup, bit packing) run on `device` for a chunk of frames at a time
(ops/encdevice.py); the host only slices the packed packets and frames
Ogg pages.  The output is a valid Vorbis stream, not byte-identical to
aoTuV (see the JAX module's docstring); for byte-identical output use
vorbis_tpu.codec.encoder.Encoder.

Ported here: `FastEncoder.__init__` (host setup), `ctx`, `dev`,
`_device_pad` and the stateless long-only branch of `encode`.  Paths of
the JAX encoder that later slices port raise NotImplementedError naming
their ROADMAP item: block switching (§1.7), the cross-frame psy state
(§1.6), managed bitrate (§1.9) and the multi-submap 5.1 layouts
(§1.10).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream.bitpack import ilog
from ..bitstream.oggfile import OggStreamWriter
from ..codec.encoder import Encoder
from ..codec.floor1_codec import fromdB_lookup
from ..convert import device_tables
from ..ops.floor_cuda import make_floor_fit
from ..ops.residue_device import DeviceResidueVQ
from ..ops.torchdsp import DeviceAnalysis
from . import encsetup


def _couple_params(setup, blocktype, blockflag, n2, blob=7):
    """Static stereo-coupling constants for the fast path (reference:
    _vp_couple_quantize_normalize's threshold setup; blob 7 is the
    unmanaged middle, the managed pass builds all 15)."""
    from ..ops.psy import _tables
    t = _tables()
    g = setup.psy_global
    pv = setup.psy_params[blocktype]
    st = t["stereo_threshholds"]
    stX = t["stereo_threshholds_X"]
    prepoint = np.float32(st[g["coupling_prepointamp"][blob]])
    postpoint = np.float32(st[g["coupling_postpointamp"][blob]])
    prepoint_x = np.float32(stX[g["coupling_prepointamp"][blob]])
    postpoint_x = np.float32(stX[g["coupling_postpointamp"][blob]])
    if prepoint_x < prepoint:
        prepoint_x = prepoint
    if postpoint_x < prepoint:
        postpoint_x = prepoint
    limit = int(g["coupling_pointlimit"][blockflag][blob])
    partition = int(pv["normal_partition"]) if pv["normal_p"] else 16

    def profile(pre, post):
        """per-bin threshold: pre below the point limit, a linear ramp
        across the partition containing it, then post (flag_lossless's
        ps interpolation)."""
        thr = np.full(n2, post, np.float32)
        p0 = (limit // partition) * partition
        thr[:p0] = pre
        if p0 < n2:
            jn = min(partition, n2 - p0)
            ps1 = np.float32((post - pre) / np.float32(jn))
            ramp = pre + ps1 * np.arange(1, jn + 1, dtype=np.float32)
            thr[p0:p0 + jn] = ramp
        return thr

    thr = profile(prepoint, postpoint)
    thr2 = profile(prepoint_x, postpoint_x)
    threv = np.where(np.arange(n2) < limit,
                     np.float32(0.18), np.float32(0.12)).astype(np.float32)
    return dict(thr1=thr, thr2=thr2, prepoint=float(prepoint),
                threv=threv, limit=limit,
                partition=partition,
                tonefix_end=0,
                normal_thresh=float(pv.get("normal_thresh", 9999.0)))


class FastEncoder:
    def __init__(self, ch: int, rate: int, quality: float = 0.5,
                 switching: bool = True, coupling: bool | None = None,
                 bitrate: tuple | None = None, psy_state: bool = True,
                 device=None):
        """Unmanaged VBR at `quality` on `device` (default: "cuda"; with
        no card that raises, and the CPU takes device="cpu").  The JAX
        encoder's defaults are kept; `encode` raises NotImplementedError
        for switching=True and psy_state=True until those slices land,
        so this slice runs as FastEncoder(..., switching=False,
        psy_state=False)."""
        if bitrate is not None:
            raise NotImplementedError(
                "managed ABR/CBR (bitrate=): ROADMAP §1.9")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "FastEncoder runs on the card by default and no CUDA "
                    "device is available: pass device=\"cpu\" to encode "
                    "on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        self.managed = False
        b = encsetup.setup_vbr_staged(ch, rate, quality)
        if coupling is None:
            # couple wherever the reference templates do: stereo and
            # the 5.1 layouts (setup_44p51); other channel counts have
            # no coupled template
            coupling = ch in (2, 6)
        if not coupling:
            b.ctl_coupling_set(False)
        self.setup = b.init()
        self.enc = Encoder(self.setup)   # looks, books, header packing
        self.vi = self.setup.vi
        self.ch = ch
        self.rate = rate
        vi = self.vi
        self.n = vi.blocksizes[1]
        n2 = self.n // 2
        # long-block mode + its mapping; single-blocksize templates
        # (8/11 kHz) have only short modes — use mode 0 (W=0 packets,
        # no window-shape bits) with the padding psy params
        try:
            self.mode_idx = next(i for i, m in enumerate(vi.modes)
                                 if m.blockflag == 1)
            self.W_main = 1
        except StopIteration:
            self.mode_idx = 0
            self.W_main = 0
        self.modebits = ilog(len(vi.modes) - 1)
        minfo = vi.modes[self.mode_idx]
        self.mapping = vi.maps[minfo.mapping]
        # device ops
        self.blocktype = min(3 if self.W_main else 1,
                             len(self.setup.psy_params) - 1)
        self.analysis = DeviceAnalysis(
            self.setup, blocktype=self.blocktype,
            rate=rate, W=self.W_main, device=self.device)
        fl_idx = self.mapping.floorsubmap[self.mapping.chmuxlist[0]]
        self.fl_look = self.enc.floor_looks[fl_idx]
        self.floor = make_floor_fit(self.fl_look, self.device)
        self.fromdB = device_tables(
            {"fromdB": np.asarray(fromdB_lookup(), np.float32)},
            self.device)["fromdB"]
        res_idx = self.mapping.residuesubmap[self.mapping.chmuxlist[0]]
        self.res_look = self.enc.residue_looks[res_idx]
        self.res_type = vi.residue_types[res_idx]
        assert self.res_type in (0, 1, 2)
        self.dvq = DeviceResidueVQ(self.res_look.info,
                                   self.res_look.books,
                                   self.res_look.partbooks, self.device)
        pv = self.setup.psy_params[self.blocktype]
        self.normal = dict(
            partition=int(pv["normal_partition"]) if pv["normal_p"]
            else 16,
            start=int(pv["normal_start"]),
            thresh=float(pv.get("normal_thresh", 9999.0)))
        if self.res_type == 2:
            # coupled layouts: single-step stereo AND the multi-step
            # multi-submap 5.1 templates
            self.couple = _couple_params(
                self.setup, self.blocktype, self.W_main, n2)
            self.couple["tonefix_end"] = self.analysis.look.tonefix_end
        self._dev = None
        # block switching (envelope-driven 256/2048) — on by default
        # when the mode set has two block sizes
        self.switching = bool(switching) and (
            vi.blocksizes[0] != vi.blocksizes[1]
            and any(m.blockflag == 0 for m in vi.modes))
        self.psy_state = bool(psy_state)

    def ctx(self, W: int = 1):
        """Per-mode component bundle; the long ctx is the encoder
        itself (analysis/floor/dvq attributes)."""
        if W or self.W_main == 0:
            return self
        raise NotImplementedError(
            "short-block ctx (block switching): ROADMAP §1.7")

    @property
    def dev(self):
        if self._dev is None:
            from ..ops.encdevice import DeviceFastEncode
            self._dev = DeviceFastEncode(self, W=self.W_main)
        return self._dev

    def _device_pad(self, pcm_dev):
        """Pad a device-resident (ch, ns) PCM tensor with the lap
        margins (hop front, 2*hop tail) plus chunk slack, on device."""
        hop = self.n // 2
        CF = self.dev.chunk_packets
        ns = pcm_dev.shape[1]
        F = (ns + 3 * hop - self.n) // hop + 1
        nchunks = (F + CF - 1) // CF
        total = (nchunks - 1) * CF * hop + self.dev.chunk_samples
        tail = total - ns - hop
        return torch.nn.functional.pad(pcm_dev, (hop, tail))

    # -- host side ---------------------------------------------------------
    def encode(self, pcm, serialno=778, comments=None,
               switching=None) -> bytes:
        """Full VBR fast encode of (ch, samples) -> Ogg bytes.

        The whole per-packet pipeline runs on the device a chunk of
        `dev.chunk_packets` packets at a time (the last chunk is cut to
        the packets it holds); the host slices the packed packets and
        frames Ogg pages.  pcm may be a numpy array, float32 (reference
        scale) or int16 (scaled by 1/32768 on the device), staged to the
        device chunk by chunk, or a tensor on the device, sliced there.
        """
        sw = self.switching if switching is None else switching
        if sw:
            raise NotImplementedError(
                "block switching (switching=True): ROADMAP §1.7")
        if self.psy_state:
            raise NotImplementedError(
                "cross-frame psy state (psy_state=True): ROADMAP §1.6")
        is_dev = torch.is_tensor(pcm)
        ch, ns = pcm.shape
        if ch != self.ch:
            raise ValueError(f"pcm has {ch} channels, encoder {self.ch}")
        dev = self.dev
        n, hop = self.n, self.n // 2
        CF = dev.chunk_packets
        if is_dev:
            # PCM already resident on the device: chunks are slices of
            # one padded tensor, no host->device traffic in the loop
            xd = self._device_pad(pcm.to(self.device))
        else:
            if pcm.dtype == np.int16:
                zdt = np.int16
            else:
                pcm = pcm.astype(np.float32, copy=False)
                zdt = np.float32
            pad1 = np.zeros((ch, hop), zdt)
            pad2 = np.zeros((ch, 2 * hop), zdt)
            x = np.concatenate([pad1, pcm, pad2], 1)
        F = (ns + 3 * hop - n) // hop + 1          # packets total
        nchunks = (F + CF - 1) // CF
        wb = dev.plan.wb

        w = OggStreamWriter(serialno)
        h1, h2, h3 = self.enc.header_packets(comments)
        w.packetin(h1, 0)
        w.flush()
        w.packetin(h2, 0)
        w.packetin(h3, 0)
        w.flush()

        def chunk(c):
            """Chunk c's samples on the device: its packets' frames."""
            s0 = c * CF * hop
            S = min(CF, F - c * CF) * hop + hop
            if is_dev:
                return xd[:, s0:s0 + S]
            sl = np.ascontiguousarray(x[:, s0:s0 + S])
            return torch.from_numpy(sl).to(self.device)

        gp = 0
        fglobal = 0
        for c in range(nchunks):
            sl = chunk(c)
            pk, nb = dev.get_step(wb)(sl)
            pkb = pk.cpu().numpy()
            nbb = nb.cpu().numpy()
            if (nbb > wb * 8).any():
                # rare oversized packet: redo the chunk with the
                # static worst-case byte budget
                pk, nb = dev.get_step(dev.plan.worst_bytes)(sl)
                pkb = pk.cpu().numpy()
                nbb = nb.cpu().numpy()
            sizes = (nbb + 7) >> 3
            for f in range(len(sizes)):
                pkt = pkb[f, :sizes[f]].tobytes()
                gp = 0 if fglobal == 0 else gp + hop
                eos = fglobal == F - 1
                if eos:
                    gp = ns
                w.packetin(pkt, gp if fglobal > 0 else 0, eos=eos)
                if fglobal % 16 == 0 or eos:
                    w.flush(eos=eos)
                fglobal += 1
        w.flush()
        return w.pageout_all()
