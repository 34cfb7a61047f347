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

Copy of vorbis_tpu/codec/encoder.py, kept line-aligned with it; its
import of `todB` takes the numpy one (`todB_np`).  The port's
`FastEncoder` (models/fastenc.py) takes its looks and header packets
from `Encoder`; `encode_vbr_stream` and `Encoder.pump` are the golden
encoder the port's quality gates hold it to.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream.bitpack import BitWriter, ilog
from ..models.encsetup import EncoderSetup, PACKETBLOBS
from ..ops import envelope as ENV
from ..ops import psy as PSY
from ..ops.mdct import mdct_forward
from ..ops.rdft import drft_forward
from ..ops.window import apply_window
from ..utils import analysis_dump as _dump
from ..utils.lpc import lpc_from_data, lpc_predict
from ..utils.scales import todB_np as todB
from . import headers as H
from .floor1_codec import (Floor1Look, floor1_encode, floor1_fit,
                           floor1_interpolate_fit)
from .residue_codec import ResidueLook, res_class, res_forward

f32 = np.float32
DB345 = f32(0.345)

# blocktype is 0/1 within each window class (reference
# codec_internal.h): psy index = blocktype + 2*W, and the aoTuV
# "block_mode" = blocktype | (W<<1) spans 0..3
BLOCKTYPE_IMPULSE = 0
BLOCKTYPE_PADDING = 1
BLOCKTYPE_TRANSITION = 0
BLOCKTYPE_LONG = 1


@dataclass
class EncodedPacket:
    data: bytes
    granulepos: int
    eos: bool


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

        self.env = ENV.EnvelopeLookup(setup.psy_global, bs, self.ch)

        # dsp state
        self.pcm = [np.zeros(bs[1], np.float32) for _ in range(self.ch)]
        self.pcm_current = bs[1] // 2
        self.centerW = bs[1] // 2
        self.lW = 0
        self.W = 0
        self.nW = 0
        self.granulepos = 0
        self.sequence = 3
        self.eofflag = 0
        self.preextrapolate = False
        self.done = False

        # psy frame-to-frame history
        self.ampmax = -9999.0
        self.lastmdct = [np.zeros(2048, np.float32) for _ in range(self.ch)]
        self.tblock = [np.zeros(256, np.float32) for _ in range(self.ch)]
        self.lowcomp = [0.0] * self.ch
        self.lW_block_mode = 0
        self.lW_no = 0
        self.impadnum = 0
        self.last_blocktype = 0

        # bitrate manager
        hi = setup.hi
        self.managed = hi.managed and hi.bitrate_reservoir > 0
        if self.managed:
            half = bs[0] >> 1
            self.short_per_long = bs[1] // bs[0]
            self.avg_bitsper = int(np.rint(1.0 * hi.bitrate_av * half
                                           / vi.rate))
            self.min_bitsper = int(np.rint(1.0 * hi.bitrate_min * half
                                           / vi.rate))
            self.max_bitsper = int(np.rint(1.0 * hi.bitrate_max * half
                                           / vi.rate))
            self.avgfloat = float(PACKETBLOBS // 2)  # C int division
            desired = hi.bitrate_reservoir * hi.bitrate_reservoir_bias
            self.minmax_reservoir = desired
            self.avg_reservoir = desired
        self._pending = None

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

    # ------------------------------------------------------------------
    def _buffer(self, vals):
        need = self.pcm_current + vals
        if need >= len(self.pcm[0]):
            for i in range(self.ch):
                old = self.pcm[i]
                self.pcm[i] = np.zeros(self.pcm_current + vals * 2,
                                       np.float32)
                self.pcm[i][:len(old)] = old

    def _preextrapolate(self):
        self.preextrapolate = True
        order = 16
        if self.pcm_current - self.centerW > order * 2:
            for i in range(self.ch):
                work = self.pcm[i][:self.pcm_current][::-1].copy()
                lpc = lpc_from_data(work[:self.pcm_current - self.centerW],
                                    order)
                pred = lpc_predict(
                    lpc,
                    work[self.pcm_current - self.centerW - order:
                         self.pcm_current - self.centerW],
                    order, self.centerW)
                work[self.pcm_current - self.centerW:] = pred
                self.pcm[i][:self.pcm_current] = work[::-1]

    def write(self, pcm: np.ndarray):
        """Feed (ch, n) float PCM (the analysis_buffer/wrote pair)."""
        vals = pcm.shape[1]
        self._buffer(vals)
        pre = f32(self.s.hi.pre_amplitude)
        for i in range(self.ch):
            self.pcm[i][self.pcm_current:self.pcm_current + vals] = \
                (pcm[i].astype(np.float32) * pre).astype(np.float32)
        self.pcm_current += vals
        if (not self.preextrapolate
                and self.pcm_current - self.centerW > self.bs[1]):
            self._preextrapolate()

    def end_of_stream(self):
        """vorbis_analysis_wrote(v, 0)."""
        order = 32
        if not self.preextrapolate:
            self._preextrapolate()
        self._buffer(self.bs[1] * 3)
        self.eofflag = self.pcm_current
        self.pcm_current += self.bs[1] * 3
        for i in range(self.ch):
            if self.eofflag > order * 2:
                n = min(self.eofflag, self.bs[1])
                lpc = lpc_from_data(
                    self.pcm[i][self.eofflag - n:self.eofflag], order)
                pred = lpc_predict(
                    lpc, self.pcm[i][self.eofflag - order:self.eofflag],
                    order, self.pcm_current - self.eofflag)
                self.pcm[i][self.eofflag:self.pcm_current] = pred
            else:
                self.pcm[i][self.eofflag:self.pcm_current] = 0.0

    # ------------------------------------------------------------------
    def blockout(self):
        """Returns (block_pcm_view, W, lW, nW, blocktype, granulepos,
        eos) or None."""
        bs = self.bs
        if not self.preextrapolate:
            return None
        if self.eofflag == -1:
            return None
        beginW = self.centerW - bs[self.W] // 2

        bp = ENV.envelope_search(self.env, self.pcm, self.pcm_current,
                                 self.centerW, self.W)
        if bp == -1:
            if self.eofflag == 0:
                return None
            self.nW = 0
        else:
            self.nW = 0 if bs[0] == bs[1] else bp

        centerNext = self.centerW + bs[self.W] // 4 + bs[self.nW] // 4
        blockbound = centerNext + bs[self.nW] // 2
        if self.pcm_current < blockbound:
            return None

        lW, W, nW = self.lW, self.W, self.nW
        if W:
            blocktype = (BLOCKTYPE_LONG if (lW and nW)
                         else BLOCKTYPE_TRANSITION)
        else:
            blocktype = (BLOCKTYPE_IMPULSE
                         if ENV.envelope_mark(self.env, self.centerW, W,
                                              lW, nW)
                         else BLOCKTYPE_PADDING)

        # ampmax decay
        self.ampmax = float(PSY.ampmax_decay(
            f32(self.ampmax), self.rate, bs[W] // 2,
            f32(self.s.psy_global["ampmax_att_per_sec"])))

        pcmend = bs[W]
        block = np.stack([self.pcm[i][beginW:beginW + pcmend].copy()
                          for i in range(self.ch)])
        granulepos = self.granulepos
        sequence = self.sequence
        self.sequence += 1
        eos = False
        emitted = True

        if self.eofflag:
            if self.centerW >= self.eofflag:
                self.eofflag = -1
                eos = True

        if not eos:
            new_centerNext = bs[1] // 2
            movementW = centerNext - new_centerNext
            if movementW > 0:
                ENV.envelope_shift(self.env, movementW)
                self.pcm_current -= movementW
                for i in range(self.ch):
                    self.pcm[i][:self.pcm_current] = \
                        self.pcm[i][movementW:movementW
                                    + self.pcm_current].copy()
                self.lW = self.W
                self.W = self.nW
                self.centerW = new_centerNext
                if self.eofflag:
                    self.eofflag -= movementW
                    if self.eofflag <= 0:
                        self.eofflag = -1
                    if 0 < self.eofflag <= self.centerW:
                        self.granulepos += movementW - (self.centerW
                                                        - self.eofflag)
                    elif self.eofflag == -1 \
                            and self.centerW >= (self.eofflag
                                                 if self.eofflag > 0
                                                 else 0):
                        self.granulepos += movementW
                    else:
                        self.granulepos += movementW
                else:
                    self.granulepos += movementW

        return block, W, lW, nW, blocktype, granulepos, eos

    # ------------------------------------------------------------------
    def analyze(self, blockinfo):
        """mapping0_forward: produce PACKETBLOBS (or 1) packet
        writers for the block."""
        s = self.s
        vi = self.vi
        ch = self.ch
        block, W, lW, nW, blocktype, granulepos, eos = blockinfo
        n = self.bs[W]
        n2 = n // 2
        modenumber = W
        mapping = vi.maps[modenumber if len(vi.maps) > 1 else 0]
        psy_look = self.psy_looks[blocktype + (2 if W else 0)]
        vif_n = s.floor_full[W if len(s.floor_full) > 1 else 0]["n"]
        block_mode = blocktype | (modenumber << 1)

        lowpass_residue = s.block_lowpassr[1 if modenumber else 0]
        npart = psy_look.vi["normal_partition"]
        if lowpass_residue % npart:
            lowpass_residue = (lowpass_residue // npart + 1) * npart

        scale = f32(4.0 / n)
        scale_dB = f32(np.float64(todB(scale)) + np.float64(DB345))

        gmdct = []
        logfft_all = []
        local_ampmax = []
        poste = []
        global_ampmax = self.ampmax

        for i in range(ch):
            pcm = block[i]
            poste.append(PSY.postnoise_detection(pcm, n, block_mode,
                                                 self.lW_block_mode))
            wpcm = np.asarray(apply_window(pcm[None, :], self.bs[0],
                                           self.bs[1], lW, W, nW))[0]
            gmdct.append(np.asarray(mdct_forward(wpcm[None, :], n))[0])
            fft = np.asarray(drft_forward(wpcm[None, :], n))[0]
            logfft = np.empty(n2, np.float32)
            logfft[0] = f32(np.float64(scale_dB)
                            + np.float64(todB(f32(fft[0])))
                            + np.float64(DB345))
            lam = float(logfft[0])
            re = fft[1:n - 1:2].astype(np.float32)
            im = fft[2:n - 1:2].astype(np.float32)
            temp = ((re * re).astype(np.float32)
                    + (im * im).astype(np.float32)).astype(np.float32)
            # C: scale_dB + .5f*todB (float adds) then +.345 as a
            # double add, rounded once on store
            tdb = (scale_dB
                   + (f32(0.5) * todB(temp).astype(np.float32))
                   .astype(np.float32)).astype(np.float32)
            tdb = (tdb.astype(np.float64) + 0.345).astype(np.float32)
            logfft[1:] = tdb
            m = float(tdb.max()) if len(tdb) else lam
            lam = max(lam, m)
            if lam > 0.0:
                lam = 0.0
            local_ampmax.append(lam)
            if lam > global_ampmax:
                global_ampmax = lam
            logfft_all.append(logfft)

        blobs = PACKETBLOBS if self.managed else 1
        floor_posts = [[None] * PACKETBLOBS for _ in range(ch)]
        logmdct_all = []
        epeak = []
        npeak = []

        for i in range(ch):
            logmdct = (todB(gmdct[i].astype(np.float32))
                       .astype(np.float64) + 0.345).astype(np.float32)
            logmdct_all.append(logmdct)
            lastmdct = self.lastmdct[i]
            tempmdct = self.tblock[i]
            lowcomp = PSY.lb_loudnoise_fix(psy_look, self.lowcomp[i],
                                           logmdct, block_mode,
                                           self.lW_block_mode)
            self.lowcomp[i] = lowcomp

            logmask, ep, npk = PSY.noisemask(psy_look, lowcomp, logmdct,
                                             lastmdct, poste[i],
                                             block_mode)
            tone = PSY.tonemask(psy_look, logfft_all[i], global_ampmax,
                                local_ampmax[i])
            epeak.append(ep)
            npeak.append(npk)
            noise = logmask
            if _dump.enabled():     # reference: ANALYSIS build dumps
                _dump.dump(f"logmdct_ch{i}", logmdct)
                _dump.dump(f"logfft_ch{i}", logfft_all[i])
                _dump.dump(f"noise_ch{i}", noise)
                _dump.dump(f"tone_ch{i}", tone)

            fl_look = self.floor_looks[
                mapping.floorsubmap[mapping.chmuxlist[i]]]
            mask1 = PSY.offset_and_mix(psy_look, noise, tone, 1,
                                       1 if self.managed else 0,
                                       gmdct[i], logmdct, lastmdct,
                                       tempmdct, lowcomp, npk, vif_n,
                                       block_mode, nW,
                                       self.lW_block_mode, self.lW_no,
                                       self.impadnum)
            floor_posts[i][PACKETBLOBS // 2] = floor1_fit(fl_look, logmdct,
                                                          mask1)
            if self.managed and floor_posts[i][PACKETBLOBS // 2] is not None:
                mask2 = PSY.offset_and_mix(psy_look, noise, tone, 2, 1,
                                           gmdct[i], logmdct, lastmdct,
                                           tempmdct, lowcomp, npk, vif_n,
                                           block_mode, nW,
                                           self.lW_block_mode, self.lW_no,
                                           self.impadnum)
                floor_posts[i][PACKETBLOBS - 1] = floor1_fit(
                    fl_look, logmdct, mask2)
                mask0 = PSY.offset_and_mix(psy_look, noise, tone, 0, 1,
                                           gmdct[i], logmdct, lastmdct,
                                           tempmdct, lowcomp, npk, vif_n,
                                           block_mode, nW,
                                           self.lW_block_mode, self.lW_no,
                                           self.impadnum)
                floor_posts[i][0] = floor1_fit(fl_look, logmdct, mask0)
                for k in range(1, PACKETBLOBS // 2):
                    floor_posts[i][k] = floor1_interpolate_fit(
                        fl_look, floor_posts[i][0],
                        floor_posts[i][PACKETBLOBS // 2],
                        k * 65536 // (PACKETBLOBS // 2))
                for k in range(PACKETBLOBS // 2 + 1, PACKETBLOBS - 1):
                    floor_posts[i][k] = floor1_interpolate_fit(
                        fl_look, floor_posts[i][PACKETBLOBS // 2],
                        floor_posts[i][PACKETBLOBS - 1],
                        (k - PACKETBLOBS // 2) * 65536
                        // (PACKETBLOBS // 2))
        self.ampmax = global_ampmax

        # blob loop
        g = self.s.psy_global
        writers = {}
        rng_ = (range(PACKETBLOBS) if self.managed
                else [PACKETBLOBS // 2])
        bitsplits = {}
        for k in rng_:
            w = BitWriter()
            w.write(0, 1)
            w.write(modenumber, self.modebits)
            if W:
                w.write(lW, 1)
                w.write(nW, 1)
            glue_end = w.bitpos

            nonzero = [0] * ch
            iwork = []
            for i in range(ch):
                fl_idx = mapping.floorsubmap[mapping.chmuxlist[i]]
                fl_look = self.floor_looks[fl_idx]
                nz, ilogmask = floor1_encode(
                    w, fl_look, vi.books, vi.static_books,
                    floor_posts[i][k] if floor_posts[i][k] is None
                    else floor_posts[i][k].copy(), n2)
                nonzero[i] = nz
                iwork.append(ilogmask)
            floor_end = w.bitpos

            # nepeak is shared and progressively mutated across the
            # 15 blobs (reference keeps one buffer per channel)
            PSY.couple_quantize_normalize(
                k, g, psy_look, mapping, gmdct,
                epeak, npeak, iwork, nonzero,
                g["sliding_lowpass"][1 if W else 0][k], ch,
                lowpass_residue)

            for sm in range(mapping.submaps):
                chans = [c for c in range(ch)
                         if mapping.chmuxlist[c] == sm]
                res_idx = mapping.residuesubmap[sm]
                look = self.residue_looks[res_idx]
                rtype = vi.residue_types[res_idx]
                bundle = [iwork[c] for c in chans]
                nzb = [nonzero[c] for c in chans]
                partword = res_class(look, bundle, nzb, rtype)
                if partword is not None:
                    res_forward(w, look, bundle, nzb, rtype, partword)
            writers[k] = w
            bitsplits[k] = (glue_end, floor_end, w.bitpos)

            # aoTuV frame-to-frame state updates live INSIDE the blob
            # loop in the reference (mapping0.c tail) — they run once
            # per blob (15x per block when managed)
            if block_mode >= 2:
                self.impadnum = 0
            if (not self.lW_block_mode) and block_mode == 1:
                self.impadnum = 1
            elif self.impadnum and self.impadnum < 8:
                self.impadnum += 1
            if self.lW_block_mode == block_mode:
                self.lW_no += 1
            else:
                self.lW_no = 1
            self.lW_block_mode = block_mode

        self._last_bitsplits = bitsplits
        return writers, granulepos, eos, W

    def _account_bits(self, choice, nbytes):
        """Bit-usage accounting per emitted packet (reference
        vorbis_block.glue_bits/floor_bits/res_bits, codec.h:112-115,
        summed like block.c:928-931)."""
        sp = getattr(self, "_last_bitsplits", {}).get(choice)
        if sp is None:
            return
        glue_end, floor_end, res_end = sp
        st = self.bit_stats
        st["packets"] += 1
        st["glue_bits"] += glue_end
        st["floor_bits"] += floor_end - glue_end
        st["res_bits"] += res_end - floor_end
        st["packet_bits"] += nbytes * 8

    # ------------------------------------------------------------------
    def _bitrate_choose(self, writers, W):
        """vorbis_bitrate_addblock: pick the blob, truncate/pad."""
        if not self.managed:
            data = writers[PACKETBLOBS // 2].getvalue()
            self._account_bits(PACKETBLOBS // 2, len(data))
            return data
        hi = self.s.hi
        sizes = {k: len(w.getvalue()) for k, w in writers.items()}
        choice = int(np.rint(self.avgfloat))
        this_bits = sizes[choice] * 8
        min_tb = self.min_bitsper * (self.short_per_long if W else 1)
        max_tb = self.max_bitsper * (self.short_per_long if W else 1)
        samples = self.bs[W] >> 1
        desired = hi.bitrate_reservoir * hi.bitrate_reservoir_bias
        if self.avg_bitsper > 0:
            avg_tb = self.avg_bitsper * (self.short_per_long if W else 1)
            slewlimit = 15.0 / hi.bitrate_av_damp
            if self.avg_reservoir + (this_bits - avg_tb) > desired:
                while (choice > 0 and this_bits > avg_tb
                       and self.avg_reservoir + (this_bits - avg_tb)
                       > desired):
                    choice -= 1
                    this_bits = sizes[choice] * 8
            elif self.avg_reservoir + (this_bits - avg_tb) < desired:
                while (choice + 1 < PACKETBLOBS and this_bits < avg_tb
                       and self.avg_reservoir + (this_bits - avg_tb)
                       < desired):
                    choice += 1
                    this_bits = sizes[choice] * 8
            slew = np.rint(choice - self.avgfloat) / samples * self.rate
            slew = min(max(slew, -slewlimit), slewlimit)
            self.avgfloat += slew / self.rate * samples
            choice = int(np.rint(self.avgfloat))
            this_bits = sizes[choice] * 8
        if self.min_bitsper > 0 and this_bits < min_tb:
            while self.minmax_reservoir - (min_tb - this_bits) < 0:
                choice += 1
                if choice >= PACKETBLOBS:
                    break
                this_bits = sizes[choice] * 8
        if self.max_bitsper > 0 and this_bits > max_tb:
            while self.minmax_reservoir + (this_bits - max_tb) \
                    > hi.bitrate_reservoir:
                choice -= 1
                if choice < 0:
                    break
                this_bits = sizes[choice] * 8
        if choice < 0:
            maxsize = (max_tb + (hi.bitrate_reservoir
                                 - self.minmax_reservoir)) // 8
            choice = 0
            data = writers[0].getvalue()
            if len(data) > maxsize:
                data = data[:int(maxsize)]
            this_bits = len(data) * 8
            self._account_bits(0, len(data))
        else:
            minsize = (min_tb - self.minmax_reservoir + 7) // 8
            if choice >= PACKETBLOBS:
                choice = PACKETBLOBS - 1
            data = writers[choice].getvalue()
            pad = int(minsize) - len(data)
            if pad > 0:
                data = data + b"\x00" * pad
            this_bits = len(data) * 8
            self._account_bits(choice, len(data))
        # reservoir updates
        if self.min_bitsper > 0 or self.max_bitsper > 0:
            if max_tb > 0 and this_bits > max_tb:
                self.minmax_reservoir += this_bits - max_tb
            elif min_tb > 0 and this_bits < min_tb:
                self.minmax_reservoir += this_bits - min_tb
            else:
                if self.minmax_reservoir > desired:
                    if max_tb > 0:
                        self.minmax_reservoir += this_bits - max_tb
                        if self.minmax_reservoir < desired:
                            self.minmax_reservoir = desired
                    else:
                        self.minmax_reservoir = desired
                else:
                    if min_tb > 0:
                        self.minmax_reservoir += this_bits - min_tb
                        if self.minmax_reservoir > desired:
                            self.minmax_reservoir = desired
                    else:
                        self.minmax_reservoir = desired
        if self.avg_bitsper > 0:
            avg_tb = self.avg_bitsper * (self.short_per_long if W else 1)
            self.avg_reservoir += this_bits - avg_tb
        return data

    # ------------------------------------------------------------------
    def pump(self):
        """Produce all currently available packets."""
        out = []
        while True:
            bi = self.blockout()
            if bi is None:
                break
            writers, granulepos, eos, W = self.analyze(bi)
            data = self._bitrate_choose(writers, W)
            out.append(EncodedPacket(data, granulepos, eos))
            if eos:
                break
        return out


def encode_vbr_stream(pcm, rate, quality, serialno=777, comments=None):
    """Convenience: full VBR encode of (ch, n) float PCM to Ogg bytes."""
    from ..bitstream.oggfile import OggStreamWriter
    from ..models import encsetup
    setup = encsetup.setup_vbr(pcm.shape[0], rate, quality)
    enc = Encoder(setup)
    w = OggStreamWriter(serialno)
    h = enc.header_packets(comments)
    w.packetin(h[0], 0)
    w.flush()
    w.packetin(h[1], 0)
    w.packetin(h[2], 0)
    w.flush()
    enc.write(pcm)
    enc.end_of_stream()
    for pkt in enc.pump():
        w.packetin(pkt.data, pkt.granulepos, eos=pkt.eos)
        if pkt.granulepos >= 0:
            w.flush(eos=pkt.eos)
    w.flush()
    return w.pageout_all()
