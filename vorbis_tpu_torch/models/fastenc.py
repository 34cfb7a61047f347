"""Torch counterpart of vorbis_tpu/models/fastenc.py: the batched fast
encoder.

All DSP decisions (masking, floor fit, coupling, residue VQ, codeword
lookup, bit packing) run on `device` for a batch of frames at a time
(ops/encdevice.py); the host runs the cross-frame psy recurrences
(ops/psydevice.py), slices the packed packets and pages Ogg in its own
host C (csrc/host_ogg.c).  The output is a valid Vorbis stream, not
byte-identical to aoTuV (see the JAX module's docstring); for
byte-identical output use the port's golden encoder,
vorbis_tpu_torch.codec.encoder (`Encoder`, `encode_vbr_stream`).

Ported here: `FastEncoder.__init__` (host setup), `ctx`, `dev`, the
stateless long-only `encode` (switching=False, psy_state=False),
`encode_batch` with its two-phase cross-frame psy state (probe -> host
recurrences -> finish, `_run_two_phase`), and the envelope-driven
256/2048 block switching that both run by default: the batched envelope
marks, the exact stretch rescue (device trigger tables, host C walk),
the switched schedule, and M3 on impulse short blocks (`encode` is then
`encode_batch` of one stream, `_encode_switched`); and managed
ABR/CBR bitrate (`bitrate=`, `encode_managed_batch`): the 15-packetblob
finish on the device (ops/managed.py), the host reservoir floater and a
device gather of the chosen packets, switched or long-only; and the
multi-submap 5.1 layouts (FastEncoder(6, 48000, 0.4)): per-submap floor
and residue configs, the four-step chained coupling and the LFE's own
floor (ops/encdevice.py `_finish_multi`), on every unmanaged path.
Managed 5.1 raises NotImplementedError: the JAX package's managed
finish has no multi-submap branch either.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..bitstream.bitpack import ilog
from ..bitstream.oggfile import OggStreamWriter
from ..codec.encoder import Encoder
from ..codec.floor1_codec import fromdB_lookup
from ..convert import device_tables
from ..ops.floor_cuda import make_floor_fit
from ..ops.m3_cuda import make_m3_scan
from ..ops.residue_device import DeviceResidueVQ
from ..ops.torchdsp import DeviceAnalysis
from . import encsetup

f32 = np.float32

class _ShortCtx:
    """Per-mode device components for the short-block (W=0) frames: a
    long-only schedule opens every stream with one short block, as the
    reference's blockout does (W starts 0)."""

    def __init__(self, fe):
        vi = fe.vi
        self.n = vi.blocksizes[0]
        self.mode_idx = next(i for i, m in enumerate(vi.modes)
                             if m.blockflag == 0)
        minfo = vi.modes[self.mode_idx]
        mapping = vi.maps[minfo.mapping]
        self.mapping = mapping
        # impulse psy params (blocktype 0) for every short block; the
        # finish step's trans flag selects the padding noise bias
        self.analysis = DeviceAnalysis(fe.setup, blocktype=0,
                                       rate=fe.rate, W=0, device=fe.device)
        fl_idx = mapping.floorsubmap[mapping.chmuxlist[0]]
        self.fl_look = fe.enc.floor_looks[fl_idx]
        self.floor = make_floor_fit(self.fl_look, fe.device)
        # M3's tempmdct scan on impulse short blocks (the CUDA kernel
        # csrc/m3_scan.cu on the card)
        self.m3_scan = make_m3_scan(self.analysis.look, fe.device)
        self.fromdB = fe.fromdB
        res_idx = mapping.residuesubmap[mapping.chmuxlist[0]]
        self.res_look = fe.enc.residue_looks[res_idx]
        self.res_type = vi.residue_types[res_idx]
        assert self.res_type in (0, 1, 2)
        self.dvq = DeviceResidueVQ(self.res_look.info,
                                   self.res_look.books,
                                   self.res_look.partbooks, fe.device)
        pv = fe.setup.psy_params[0]
        self.normal = dict(
            partition=int(pv["normal_partition"]) if pv["normal_p"]
            else 16,
            start=int(pv["normal_start"]),
            thresh=float(pv.get("normal_thresh", 9999.0)))
        if self.res_type == 2:
            self.couple = _couple_params(fe.setup, 0, 0, self.n // 2)
            self.couple["tonefix_end"] = self.analysis.look.tonefix_end


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
        encoder's defaults are kept: switching=True drives 256/2048
        block switching from the envelope pass (False forces long-only).

        bitrate=(max_bps, nominal_bps, min_bps) selects managed
        (ABR/CBR) mode: the encode runs the 15-packetblob device pass
        and the host reservoir floater picks each packet
        (ops/managed.py; reference lib/bitrate.c).

        psy_state=True (default) threads the reference's cross-frame
        psychoacoustic state through the batched pipeline -- ampmax
        decay, lastmdct (M9), the M5 compand latch, M2 post-echo, M7
        ntfix, M6 lossless promotion and the M8 noise-normalize budgets
        (ops/psydevice); False selects the stateless single-pass
        pipeline."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "FastEncoder runs on the card by default and no CUDA "
                    "device is available: pass device=\"cpu\" to encode "
                    "on the CPU")
            device = "cuda"
        self.device = torch.device(device)
        # what `to` builds the same encoder from on another device
        self._config = dict(ch=ch, rate=rate, quality=quality,
                            switching=switching, coupling=coupling,
                            bitrate=bitrate, psy_state=psy_state)
        self.managed = bitrate is not None
        if self.managed:
            mx, nom, mn = bitrate
            b = encsetup.setup_managed_staged(ch, rate, mx, nom, mn)
        else:
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
        self._short_ctx = None
        self._dev_short = None
        self._managed_devs = {}
        self._step_caches = {}
        # block switching (envelope-driven 256/2048) — on by default
        # when the mode set has two block sizes
        self.switching = bool(switching) and (
            vi.blocksizes[0] != vi.blocksizes[1]
            and any(m.blockflag == 0 for m in vi.modes))
        self.psy_state = bool(psy_state)

    def to(self, device) -> "FastEncoder":
        """This encoder's configuration on `device`, its tables built
        there (self where it already runs on that device)."""
        if torch.device(device) == self.device:
            return self
        return FastEncoder(**self._config, device=device)

    def ctx(self, W: int = 1):
        """Per-mode component bundle; the long ctx is the encoder
        itself (analysis/floor/dvq attributes), the short ctx is
        built lazily."""
        if W or self.W_main == 0:
            # single-blocksize templates have one mode: the encoder
            # itself is the only ctx
            return self
        if self._short_ctx is None:
            self._short_ctx = _ShortCtx(self)
        return self._short_ctx

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

    # -- host-side Ogg paging ----------------------------------------------
    @staticmethod
    def _write_audio_pages(w, rows_for, sizes, gps, eos_last=True,
                           per_page=16):
        """Emit audio packets onto pages directly, one 16-packet page
        per pass: the plain version of the host C pager
        (native.ogg_pages, which _page_stream runs), held against it by
        tests/test_torch_psystate.py.  w: an OggStreamWriter that
        already emitted the header pages."""
        import struct

        from ..bitstream.oggfile import ogg_crc
        npkt = len(sizes)
        serialno = w.serialno
        pageno = w.pageno
        pages = w._pages
        i0 = 0
        while i0 < npkt:
            lacing = bytearray()
            body = bytearray()
            hi = i0
            while hi < npkt and hi - i0 < per_page:
                nsz = int(sizes[hi])
                need = nsz // 255 + 1
                if lacing and len(lacing) + need > 255:
                    break                 # lacing table is full
                body += rows_for(hi)
                while nsz >= 255:
                    lacing.append(255)
                    nsz -= 255
                lacing.append(nsz)
                hi += 1
            eos = eos_last and hi == npkt
            htype = 4 if eos else 0
            hdr = struct.pack(
                "<4sBBqIIIB", b"OggS", 0, htype, int(gps[hi - 1]),
                serialno & 0xFFFFFFFF, pageno, 0, len(lacing))
            page = bytearray(hdr + bytes(lacing) + bytes(body))
            crc = ogg_crc(bytes(page))
            page[22:26] = struct.pack("<I", crc)
            pages.append(bytes(page))
            pageno += 1
            i0 = hi
        w.pageno = pageno

    # -- per-mode device steps ---------------------------------------------
    def _dev_for(self, W):
        """DeviceFastEncode per block mode (cached)."""
        if W or self.W_main == 0:
            return self.dev
        if self._dev_short is None:
            from ..ops.encdevice import DeviceFastEncode
            self._dev_short = DeviceFastEncode(self, W=0)
        return self._dev_short

    def _cached_step(self, kind, W, B, wb, make):
        """One plain callable per (kind, W, B, wb), built once."""
        key = (kind, W, B, wb)
        if key not in self._step_caches:
            self._step_caches[key] = make()
        return self._step_caches[key]

    def _gather_step(self, W, B, wb=None):
        return self._cached_step("gather", W, B, wb, lambda: self._dev_for(
            W).make_gather_step(B, wb))

    def _probe_step(self, W, B):
        return self._cached_step("probe", W, B, None, lambda: self._dev_for(
            W).make_probe_step(B, self.n // 2))

    def _finish_step(self, W, B, wb=None):
        return self._cached_step("finish", W, B, wb, lambda: self._dev_for(
            W).make_finish_step(B, wb))

    def _managed_dev_for(self, W):
        """DeviceManagedEncode per block mode (cached); it shares the
        mode's DeviceFastEncode."""
        from ..ops.managed import DeviceManagedEncode
        W = W if self.W_main else 0
        if W not in self._managed_devs:
            self._managed_devs[W] = DeviceManagedEncode(self, W=W)
        return self._managed_devs[W]

    def _managed_finish_step(self, W, B, wb=None):
        return self._cached_step("finish15", W, B, wb, lambda: (
            self._managed_dev_for(W).make_finish_step15(B, wb)))

    # -- block switching (envelope-driven 256/2048) -----------------------
    _ENV_STEPS = 8192        # envelope chunk, in 64-sample steps
    _ENV_HIST = 32           # history overlap (nearDC window + stretch)
    _ENV_NC = 8              # env chunks per dispatch (batch mode)

    def _env_chunk_step(self, NC):
        """(x64 (ch, R, 64), starts (NC,) row offsets) -> (NC, E) bool
        marks.  Row-gathers envelope chunks from the concatenated
        multi-stream array so one dispatch covers chunks of MANY
        streams (encode_batch's envelope pass)."""
        if not hasattr(self, "_env_steps_cache"):
            self._env_steps_cache = {}
        if NC not in self._env_steps_cache:
            env = self._env_obj()
            E = self._ENV_STEPS
            ch = self.ch

            def step(x64, starts):
                rows = (starts.long()[:, None]
                        + torch.arange(E + 1, device=x64.device)[None, :])
                sl = x64[:, rows]                    # (ch, NC, E+1, 64)
                x = sl.reshape(ch, NC, (E + 1) * 64)
                if x.dtype != torch.float32:
                    x = x.to(torch.float32) / 32768.0
                return env.marks_nd(x)

            self._env_steps_cache[NC] = step
        return self._env_steps_cache[NC]

    @staticmethod
    def _start_to_host(t):
        """Start one non-blocking copy of a device tensor into pinned
        host memory and return the host tensor (valid after the next
        synchronize); a CPU tensor is returned as it is."""
        if not t.is_cuda:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h

    @staticmethod
    def _to_host(tensors):
        """Device tensors -> host numpy arrays: one non-blocking copy
        into pinned memory each, then one synchronize (a CPU tensor is
        read as it is)."""
        outs = [FastEncoder._start_to_host(t) for t in tensors]
        if any(t.is_pinned() for t in outs):
            torch.cuda.synchronize()
        return [t.numpy() for t in outs]

    def _envelope_marks_multi(self, x64, metas):
        """Batched envelope pass over the concatenated stream array.
        metas: [(ns, base_row, Si)] per stream (Si >= one envelope
        chunk).  Returns per-stream bool mark arrays."""
        E, H = self._ENV_STEPS, self._ENV_HIST
        plans = []            # (stream, dst_step, lo, take, abs_row)
        for si, (ns, base, Si) in enumerate(metas):
            nsteps = Si // 64 - 1
            s = 0
            while s < nsteps:
                s0 = min(max(0, s - H), max(0, Si // 64 - (E + 1)))
                lo = s - s0
                take = min(E - lo, nsteps - s)
                plans.append((si, s, lo, take, base + s0))
                s += take
        # eager steps need no fixed shape: a group of fewer chunks than
        # _ENV_NC runs at its own size (each chunk's marks are its own)
        NC = min(self._ENV_NC, len(plans))
        step = self._env_chunk_step(NC)
        st = np.zeros((-(-len(plans) // NC), NC), np.int32)
        st.reshape(-1)[:len(plans)] = [g[4] for g in plans]
        std = torch.from_numpy(st).to(x64.device)
        outs = self._to_host([step(x64, std[o]) for o in range(len(st))])
        marks = [np.zeros(Si // 64 - 1, bool) for (_, _, Si) in metas]
        for o, dn in enumerate(outs):
            for j, (si, s, lo, take, _) in enumerate(
                    plans[o * NC:(o + 1) * NC]):
                marks[si][s:s + take] = dn[j, lo:lo + take]
        return marks

    _RESCUE_PAD = 30     # steps: stretch re-saturates after 24
                         # trigger-free steps, plus mark spill margin

    def _env_obj(self):
        if not hasattr(self, "_env_rescue_obj"):
            from ..ops.torchdsp import DeviceEnvelope
            self._env_rescue_obj = DeviceEnvelope(
                self.setup.psy_global, self.ch, device=self.device)
        return self._env_rescue_obj

    _RESCUE_G = 128     # clusters per trigger-table dispatch

    def _rescue_trig_step(self, G, Lmax, Lw):
        """(x64, rows (G, Lmax) i32, nr (G,), ofs (G,)) -> (T1, T2)
        (MAXSTRETCH+1, G, Lw/8) uint8 bit-packed trigger tables, the
        ENTIRE per-cluster envelope replay on the device: gather the
        cluster's 64-sample rows, recompute the 12-band amplitudes
        (DeviceEnvelope.band_amps, the math of marks_nd), build the
        sliding pre-window extrema for every distinct (stretch-window,
        penalty) combo and compare against the pre/post-echo
        thresholds.  Only these tables reach the host, which is left
        with pure boolean indexing.  Reference walk:
        envelope.c:569-681."""
        if not hasattr(self, "_rescue_trig_cache"):
            self._rescue_trig_cache = {}
        key = (G, Lmax, Lw)
        if key not in self._rescue_trig_cache:
            from ..ops import envelope as ENV
            env = self._env_obj()
            gi = self.setup.psy_global
            sp_pen = float(gi["stretch_penalty"])
            pre_t = np.asarray(gi["preecho_thresh"], np.float32)
            post_t = np.asarray(gi["postecho_thresh"], np.float32)
            MNS = ENV.VE_MINSTRETCH
            MXS = ENV.VE_MAXSTRETCH
            zpad = MXS + 2
            ch = self.ch
            Lacc = Lmax - 1
            Lp = zpad + Lacc
            dev = self.device
            # the distinct (window, penalty) combos and their thresholds
            combos, which = {}, []
            for s2 in range(MXS + 1):
                su = max(MNS, s2)
                pen = f32(min(max(sp_pen - (s2 - MNS), 0.0), sp_pen))
                ck = (su, float(pen))
                if ck not in combos:
                    combos[ck] = tuple(torch.from_numpy(t).to(dev) for t in (
                        pre_t + pen, post_t - pen))
                which.append(ck)
            wts = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128],
                               dtype=torch.int32, device=dev)
            steps = torch.arange(Lmax, device=dev)
            wsteps = torch.arange(Lw, device=dev)

            def step(x64, rows, nr, ofs):
                sl = x64[:, rows.long().reshape(-1)].reshape(ch, G, Lmax, 64)
                if sl.dtype != torch.float32:
                    sl = sl.to(torch.float32) / 32768.0
                # zero rows at/past each cluster's end (the scalar's
                # zero-initialized ampbuf history semantics)
                valid = steps[None, :] < nr[:, None]
                sl = sl * valid[None, :, :, None].to(torch.float32)
                frames = torch.cat([sl[:, :, :-1], sl[:, :, 1:]], -1)
                acc = env.band_amps(frames)          # (ch, G, Lacc, 12)
                accp = torch.nn.functional.pad(acc, (0, 0, zpad, 0))
                pos = torch.clamp(zpad + ofs.long()[:, None]
                                  + wsteps[None, :], 0, Lp - 1)  # (G, Lw)

                def take(a, idx):
                    return torch.gather(a, 2, idx[None, :, :, None].expand(
                        ch, G, Lw, a.shape[-1]))

                cur = take(accp, pos)
                prv = take(accp, torch.clamp_min(pos - 1, 0))
                postmax = torch.maximum(cur, prv)
                postmin = torch.minimum(cur, prv)
                res = {}
                for (su, pen), (pre_thr, post_thr) in combos.items():
                    pmx = accp[:, :, :Lp - su + 1]
                    pmn = pmx
                    for s in range(1, su):
                        seg = accp[:, :, s:s + Lp - su + 1]
                        pmx = torch.maximum(pmx, seg)
                        pmn = torch.minimum(pmn, seg)
                    pw = torch.clamp(pos - 1 - su, 0, Lp - su)
                    t1 = ((postmax - take(pmx, pw)) > pre_thr).any(-1).any(0)
                    t2 = ((postmin - take(pmn, pw)) < post_thr).any(-1).any(0)
                    res[(su, pen)] = (t1, t2)

                # bit-pack along the step axis (8 steps a byte, LSB
                # first): 8x fewer bytes cross to the host
                def pack(ts):
                    s = torch.stack(ts).to(torch.int32)
                    s = s.reshape(s.shape[0], G, Lw // 8, 8)
                    return (s * wts).sum(-1).to(torch.uint8)

                return (pack([res[ck][0] for ck in which]),
                        pack([res[ck][1] for ck in which]))

            self._rescue_trig_cache[key] = step
        return self._rescue_trig_cache[key]

    def _rescue_trig_tables(self, x64, jobs):
        """Device trigger tables for a list of rescue jobs: bucket
        clusters by padded row length, dispatch every group before
        fetching any (one non-blocking copy a group, one synchronize),
        and scatter the per-group results into (MAXSTRETCH+1, C, Lwmax)
        host bool arrays indexed [stretch//2, cluster, window step]."""
        from ..ops import envelope as ENV
        MXS = ENV.VE_MAXSTRETCH
        R = int(x64.shape[1])
        C = len(jobs)
        nrs = [j[8] for j in jobs]
        wls = [j[5] - j[4] for j in jobs]
        Lwmax = max(wls)

        def bucket(n):
            b = 128
            while b < n:
                b *= 2
            return b

        order = sorted(range(C), key=lambda i: bucket(nrs[i]))
        T1 = np.zeros((MXS + 1, C, Lwmax), bool)
        T2 = np.zeros((MXS + 1, C, Lwmax), bool)
        groups, pend = [], []
        i = 0
        while i < len(order):
            Lb = bucket(nrs[order[i]])
            grp = [order[i]]
            i += 1
            while (i < len(order) and len(grp) < self._RESCUE_G
                   and bucket(nrs[order[i]]) == Lb):
                grp.append(order[i])
                i += 1
            G = self._RESCUE_G if len(grp) > 8 else 8
            # rows (G, Lb), nr and ofs in one upload
            arg = np.zeros((G, Lb + 2), np.int32)
            for g, ji in enumerate(grp):
                _, _, base, _, w0, _, _, r0, nrj = jobs[ji]
                arg[g, :nrj] = np.minimum(base + r0 + np.arange(nrj),
                                          R - 1)
                arg[g, Lb] = nrj
                arg[g, Lb + 1] = w0 - r0
            argd = torch.from_numpy(arg).to(x64.device)
            step = self._rescue_trig_step(G, Lb, Lb)
            d1, d2 = step(x64, argd[:, :Lb], argd[:, Lb], argd[:, Lb + 1])
            groups.append(grp)
            pend.append(torch.stack([d1, d2]))
        for grp, d in zip(groups, self._to_host(pend)):
            h1 = np.unpackbits(d[0], axis=-1, bitorder="little")
            h2 = np.unpackbits(d[1], axis=-1, bitorder="little")
            for g, ji in enumerate(grp):
                wl = min(wls[ji], h1.shape[2])
                T1[:, ji, :wl] = h1[:, g, :wl]
                T2[:, ji, :wl] = h2[:, g, :wl]
        return T1, T2

    def _stretch_rescue(self, x64, metas, marks):
        """Exact envelope `stretch` hysteresis around candidate marks.

        The batched detector runs at the steady-state stretch and
        penalty (envelope.c's serial feedback would serialize 8k tiny
        steps per chunk), which over-triggers right after an impulse.
        Steady regions (>= 24 trigger-free steps) ARE exact, and any
        trigger is itself a steady-state candidate, so only candidate
        neighborhoods need fixing: dilate candidate clusters, replay
        the per-(stretch, penalty) trigger decisions ON THE DEVICE
        (_rescue_trig_tables: only boolean trigger tables reach the
        host), then advance the reference's serial walk
        (_ve_envelope_search: stretch grows to 2*VE_MAXSTRETCH, resets
        on a pre-echo trigger; the pre-window and penalty follow
        stretch//2) over the tables, replacing the marks.

        The walk runs in lockstep across clusters in the host C
        (_rescue_walk_batch).  Clusters whose stretch state leaks past
        the window end (a trigger within SMAX+2 steps of it) take the
        per-cluster serial path with window extension
        (_rescue_cluster_serial), interleaved in job order so
        overlapping extended windows overwrite exactly like the
        all-serial walk does."""
        PAD = self._RESCUE_PAD
        K_long = 3 * (self.n // 4) + self.vi.blocksizes[0] // 4
        lead = 17 + 14       # nearDC window + pre-window lead-in

        # --- phase 1: cluster discovery across ALL streams
        jobs = []
        for (ns, base, Si), mk in zip(metas, marks):
            nst = len(mk)
            # marks past the schedule's look-ahead horizon (tail pad
            # territory) can't change any block decision
            reach = min(nst,
                        (self.n // 2 + ns + K_long) // 64 + PAD)
            cand = np.flatnonzero(mk[:reach])
            if not len(cand):
                continue
            clusters = []
            a = b = int(cand[0])
            for c in cand[1:]:
                if c - b <= 2 * PAD:
                    b = int(c)
                else:
                    clusters.append((a, b))
                    a = b = int(c)
            clusters.append((a, b))
            for a, b in clusters:
                w0 = max(0, a - PAD)
                w1 = min(nst, b + PAD)
                r0 = max(0, w0 - lead)
                rhi = min(Si // 64, w1 + 2)
                jobs.append([mk, nst, base, Si, w0, w1, b, r0,
                             rhi - r0])
        if not jobs:
            return
        T1, T2 = self._rescue_trig_tables(x64, jobs)

        if getattr(self, "_rescue_force_serial", False):
            # test hook: the all-serial walk the lockstep batch is
            # held bitwise-equal to (tests/test_torch_switching.py)
            for ci, job in enumerate(jobs):
                self._rescue_cluster_serial(
                    x64, job, T1[:, ci], T2[:, ci])
            return

        # --- phase 2: lockstep walk over every cluster at once
        newmk, retrig = self._rescue_walk_batch(T1, T2, jobs)
        for ci, job in enumerate(jobs):
            mk, nst, w0, w1 = job[0], job[1], job[4], job[5]
            if retrig[ci] and w1 < nst:
                # stretch state leaks past the window end: replay
                # this cluster serially with window extension
                self._rescue_cluster_serial(
                    x64, job, T1[:, ci], T2[:, ci])
                continue
            wl = w1 - w0
            mk[w0:w1] = newmk[ci, :wl]
            if w1 < nst and newmk[ci, wl]:
                mk[w1] = True

    def _rescue_walk_batch(self, T1, T2, jobs):
        """Phase 2 of _stretch_rescue: the serial stretch state machine
        advanced across the cluster axis over the device-built trigger
        tables, in the host C (native.rescue_walk, no fall-back; its
        plain version is _rescue_walk_plain).  Returns (newmk (C, Lw+2)
        bool, retrig (C,) bool); marks are written by the caller (or
        the serial path for retrig clusters)."""
        from ..ops import envelope as ENV
        wlen = np.asarray([j[5] - j[4] for j in jobs])  # w1 - w0
        return native.rescue_walk(T1, T2, wlen, 2 * ENV.VE_MAXSTRETCH)

    @staticmethod
    def _rescue_walk_plain(T1, T2, wlen, smax):
        """The lockstep walk in numpy (the JAX module's fall-back): only
        the per-step stretch counter is serial state, so all clusters
        advance together through one boolean-indexing state machine.
        The plain version native.rescue_walk is held against
        (tests/test_torch_switching.py)."""
        C = len(wlen)
        Lw = T1.shape[2]
        cidx = np.arange(C)
        newmk = np.zeros((C, Lw + 2), bool)
        stretch = np.full(C, smax, np.int64)
        retrig = np.zeros(C, bool)
        for k in range(Lw):
            act = k < wlen
            stretch = np.minimum(stretch + 1, smax)
            s2 = stretch >> 1
            t1 = T1[s2, cidx, k] & act
            t2 = T2[s2, cidx, k] & act
            newmk[:, k] |= t1 | t2
            newmk[:, k + 1] |= t1
            if k > 0:
                newmk[:, k - 1] |= t2
            retrig |= t1 & (k >= wlen - (smax + 2))
            stretch = np.where(t1, -1, stretch)
        return newmk, retrig

    def _rescue_cluster_serial(self, x64, job, T1c, T2c):
        """The per-cluster reference walk (window extends while a
        trigger lands within SMAX+2 steps of its end): the exact
        serial replay of _ve_envelope_search over one cluster, over
        the SAME device-built trigger tables as the lockstep batch
        (T1c/T2c: (VE_MAXSTRETCH+1, >= w1-w0) bool, indexed
        [stretch//2, window step])."""
        from ..ops import envelope as ENV
        PAD = self._RESCUE_PAD
        SMAX = 2 * ENV.VE_MAXSTRETCH
        while True:
            mk, nst, _, Si, w0, w1 = job[:6]
            newmk = np.zeros(w1 - w0 + 2, bool)
            stretch = SMAX
            retrig_tail = False
            for j in range(w0, w1):
                stretch = min(stretch + 1, SMAX)
                s2 = stretch >> 1
                k = j - w0
                if T1c[s2, k]:
                    newmk[k] = True
                    newmk[k + 1] = True
                if T2c[s2, k]:
                    newmk[k] = True
                    if k > 0:
                        newmk[k - 1] = True
                if T1c[s2, k]:
                    stretch = -1
                    if j >= w1 - (SMAX + 2):
                        retrig_tail = True
            if retrig_tail and w1 < nst:
                # trigger near the window end: stretch state leaks —
                # extend the window and rebuild this cluster's tables
                # on the device (same math as the batch pass)
                b = w1 + PAD
                job[5] = w1 = min(nst, b + PAD)
                job[6] = b
                job[8] = min(Si // 64, w1 + 2) - job[7]
                Tn1, Tn2 = self._rescue_trig_tables(x64, [job])
                T1c, T2c = Tn1[:, 0], Tn2[:, 0]
                continue
            mk[w0:w1] = newmk[:w1 - w0]
            if w1 < nst and newmk[w1 - w0]:
                mk[w1] = True
            break

    def _edge_pads(self, pcm, hop, tail, src=None):
        """LPC stream-edge extensions for the lap pads (reference:
        block.c:438-477 pre-extrapolation, 497-537 eof tail): the
        front pad continues the signal BACKWARD (order 16), the tail
        pad FORWARD (order 32, capped at 3 long blocks like the
        reference), so the psy model sees a smooth lead-in/out instead
        of zero-pad edges.  Returns host arrays in the input dtype.
        src: the (head, tail) edge slices already on the host (a
        device-resident pcm sends only these 4*n-sample edges)."""
        from ..utils.lpc import lpc_extrapolate
        ch, ns = pcm.shape
        n1 = self.n
        w = int(min(ns, 4 * n1))
        if src is not None:
            head = np.asarray(src[0])
            tsrc = np.asarray(src[1])
        else:
            head = np.asarray(pcm[:, :w])
            tsrc = np.asarray(pcm[:, ns - w:])
        dt = head.dtype
        i16 = dt == np.int16
        sc = np.float32(1.0 / 32768.0) if i16 else np.float32(1.0)
        front = np.stack([
            lpc_extrapolate(head[c, ::-1].astype(np.float32) * sc,
                            16, hop)[::-1] for c in range(ch)])
        text = int(min(tail, 3 * n1))
        tl = np.stack([
            lpc_extrapolate(tsrc[c].astype(np.float32) * sc, 32, text)
            for c in range(ch)])
        if i16:
            front = np.clip(np.rint(front * 32768.0), -32768, 32767)
            tl = np.clip(np.rint(tl * 32768.0), -32768, 32767)
        tailbuf = np.zeros((ch, tail), dt)
        tailbuf[:, :text] = tl.astype(dt)
        return front.astype(dt), tailbuf

    def _schedule(self, marks, ns):
        """Envelope marks -> block schedule (centers, Ws, impulse) in
        padded-stream coordinates (front pad = hop), through the host C
        blockout state machine (native.schedule; its plain version is
        _schedule_plain).  Single-blocksize templates have one mode and
        a fixed hop."""
        n1 = self.n
        n0 = self.vi.blocksizes[0]
        hop = n1 // 2
        if n0 == n1:
            # single-blocksize template: one mode; keep the "main"
            # label the batched pipeline keys on
            k = (hop + ns - 1 - hop) // hop + 1
            cs = hop + hop * np.arange(k + 1, dtype=np.int64)
            return (cs, np.ones(k + 1, np.int64),
                    np.zeros(k + 1, bool))
        return native.schedule(np.asarray(marks, bool), ns, n0, n1)

    @staticmethod
    def _schedule_plain(marks, ns, n0, n1):
        """The blockout / envelope_search state machine in Python
        (block.c:557-812, envelope.c:569-735): W starts 0, a persistent
        scan cursor walks the mark array, a mark strictly after the
        current center and before testW = center + bs[W]/4 + bs[1]/2 +
        bs[0]/4 makes the NEXT block short, and the SAME mark keeps
        blocks short until the center passes it.  The impulse flag
        mirrors envelope_mark (span marks or the consumed curmark).
        Mark-free long-long stretches bulk-emit arithmetically.  The
        plain version native.schedule is held against
        (tests/test_torch_psystate.py)."""
        bs = (n0, n1)
        hop = n1 // 2
        marks = np.asarray(marks, bool)
        nmk = len(marks)
        end_c = hop + ns
        mpos = np.flatnonzero(marks).astype(np.int64) * 64
        mc = np.concatenate([[0], np.cumsum(marks.astype(np.int64))])
        limit = 64 * nmk
        K_long = 3 * (n1 // 4) + n0 // 4

        def anymark(b_abs, e_abs):
            b = max(0, min(b_abs // 64, nmk))
            e = max(0, min((e_abs + 63) // 64, nmk))
            return e > b and mc[e] > mc[b]

        segs_c, segs_W, segs_I = [], [], []
        centerW = hop
        W = 0                      # _vds_shared_init starts W=0
        cursor = hop               # EnvelopeLookup: blocksizes[1]//2
        curmark = 0
        one = np.ones(1, np.int64)
        while True:
            # bulk: long steady state with the next mark out of reach
            if W == 1 and centerW < end_c:
                j0 = max(cursor, centerW + 64)
                mi = int(np.searchsorted(mpos, j0))
                m_abs = int(mpos[mi]) if mi < len(mpos) else None
                cap = (m_abs if m_abs is not None else limit) - K_long
                cap = min(cap, end_c - 1)
                if cap >= centerW + hop:
                    k = (cap - centerW) // hop + 1
                    arr = centerW + hop * np.arange(k, dtype=np.int64)
                    segs_c.append(arr)
                    segs_W.append(np.ones(k, np.int64))
                    segs_I.append(np.zeros(k, bool))
                    last_testW = int(arr[-1]) + K_long
                    cursor = max(cursor,
                                 ((last_testW - 1) // 64) * 64)
                    centerW = int(arr[-1]) + hop
                    continue
            # serial: envelope_search in absolute coordinates
            testW = centerW + bs[W] // 4 + n1 // 2 + n0 // 4
            mi = int(np.searchsorted(mpos, cursor))
            m_abs = None
            while mi < len(mpos):
                if mpos[mi] > centerW:
                    m_abs = int(mpos[mi])
                    break
                mi += 1
            if m_abs is not None and m_abs < testW:
                bp = 0
                cursor = m_abs
                curmark = m_abs
            elif testW <= limit:
                bp = 1
                cursor = max(cursor, ((testW - 1) // 64) * 64)
            else:
                bp = -1            # end of analyzable data -> short
                cursor = max(cursor, ((limit - 1) // 64) * 64)
            nW = 1 if bp == 1 else 0
            if W == 0:
                b0 = centerW - n0 // 4 - n0 // 4
                e0 = centerW + n0 // 4 + n0 // 4
                imp = anymark(b0, e0) or (b0 <= curmark < e0)
            else:
                imp = False
            segs_c.append(np.array([centerW], np.int64))
            segs_W.append(one * W)
            segs_I.append(np.array([imp]))
            if centerW >= end_c:
                break
            centerW = centerW + bs[W] // 4 + bs[nW] // 4
            W = nW
        return (np.concatenate(segs_c), np.concatenate(segs_W),
                np.concatenate(segs_I))

    # -- stateful two-phase pipeline ----------------------------------------
    @staticmethod
    def _host_compact(pkb, sizes):
        """Concatenate the used prefixes of padded packet rows into
        (blob, off): one dense byte buffer + exclusive byte offsets
        (a row-major boolean mask keeps exactly those prefixes, in
        order)."""
        sizes = np.asarray(sizes, np.int64)
        off = np.cumsum(sizes) - sizes
        keep = np.arange(pkb.shape[1])[None, :] < sizes[:, None]
        return pkb[keep], off

    @staticmethod
    def _pad_to(a, B, fill=0):
        if len(a) >= B:
            return np.asarray(a)
        return np.concatenate(
            [np.asarray(a),
             np.full((B - len(a),) + np.shape(a)[1:], fill,
                     np.asarray(a).dtype)])

    def _drain(self, pend, redo, wb, F):
        """Fetch every batch's (packets, nbits) in one wave, redo a
        batch holding an oversized packet at the static worst-case
        budget, and host-compact the rows.  pend: [(pk, nb)] on the
        device; redo(bi) -> the batch's (pk, nb) at the worst-case
        budget.  Returns (blob, off, nbits) for the first F packets."""
        if not pend:
            return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        pk_all = torch.stack([pk for pk, _ in pend]).cpu().numpy()
        nb_all = torch.stack([nb for _, nb in pend]).cpu().numpy()
        blobs, offs, nbs = [], [], []
        base = 0
        for bi in range(len(pend)):
            pkb, nbb = pk_all[bi], nb_all[bi]
            if (nbb > wb * 8).any():
                pk, nb = redo(bi)
                pkb, nbb = pk.cpu().numpy(), nb.cpu().numpy()
            blob_b, off_b = self._host_compact(pkb, (nbb + 7) >> 3)
            blobs.append(blob_b)
            offs.append(off_b + base)
            nbs.append(nbb.astype(np.int64))
            base += len(blob_b)
        return (np.concatenate(blobs), np.concatenate(offs)[:F],
                np.concatenate(nbs)[:F])

    def _run_two_phase(self, x64, per, B_long, B_short, managed=False):
        """The cross-frame-state encode: probe pass -> host scalar
        recurrences -> finish pass.  per: per-stream dicts from
        _prepare_switched (cs, Ws, impulse, li, si, lofs, sofs, starts,
        wid).  Returns ((blob, off, nbits) longs, (blob, off, nbits)
        shorts): packet i's bytes are blob[off[i]:off[i] +
        ((nbits[i]+7)>>3)] -- the stateless gather runner's contract.
        Phase times land in `last_profile`.  A long-only schedule
        still opens each stream with one short (padding) block; either
        list of frames may be empty.

        managed=True keeps the same probe pass and host recurrences
        (with m3_param_seq's managed noise_rate reduction) but finishes
        through the 15-packetblob step and returns, per block mode,
        ((pend, args), B): pend holds every batch's (packets (B, 15,
        wb), nbits (B, 15)) on the device, with the nbits already on
        their way to the host, and args(bi) rebuilds batch bi's finish
        arguments (for the oversized redo), for the reservoir and gather
        stage (_encode_managed_switched)."""
        import time as _time

        from ..ops import psydevice as PD
        ch = self.ch
        n2L = self.n // 2
        hsrate = self.rate >= 26000
        dev = self.device

        # --- per-stream annotations (batched across streams) +
        # per-frame probe metadata
        S = len(per)
        Fmax = max(len(r["Ws"]) for r in per)
        Ws_p = np.ones((S, Fmax), np.int64)
        imp_p = np.zeros((S, Fmax), bool)
        for sidx, rec in enumerate(per):
            F = len(rec["Ws"])
            Ws_p[sidx, :F] = rec["Ws"]
            imp_p[sidx, :F] = rec["impulse"]
        ann_nd = PD.annotate_frames_nd(Ws_p, imp_p)
        anns = []
        for sidx, rec in enumerate(per):
            F = len(rec["Ws"])
            ann = {k: v[sidx, :F] for k, v in ann_nd.items()}
            anns.append(ann)
            rec["ann"] = ann
        # lmode per frame: how THIS frame's logmdct resamples into its
        # successor's lastmdct (psy.c:4462-4501)
        gl_lm, gs_lm = [], []
        gl_tr = []
        for rec, ann in zip(per, anns):
            Ws = rec["Ws"]
            lmode = np.where(Ws == 1, np.where(ann["nW"] == 0, 2, 0),
                             np.where(ann["nW"] == 1, 1, 0))
            gl_lm.append(lmode[rec["li"]])
            gs_lm.append(lmode[rec["si"]])
            gl_tr.append(ann["bm"][rec["li"]] == 2)
        lm_l = np.concatenate(gl_lm).astype(np.int32)
        lm_s = np.concatenate(gs_lm).astype(np.int32)
        tr_l = np.concatenate(gl_tr).astype(bool)

        # --- phase A: probe all batches (longs then shorts); one upload
        # of every batch's (starts, wid, lmode) rows, pads at starts 0,
        # wid 3, lmode 0
        def run_probe(W, starts, wids, lmodes, B):
            F = len(starts)
            nbat = -(-F // B)
            sv = np.zeros((3, nbat * B), np.int32)
            sv[1] = 3
            sv[0, :F] = starts
            if wids is not None:
                sv[1, :F] = wids
            sv[2, :F] = lmodes
            svd = torch.from_numpy(np.ascontiguousarray(
                sv.reshape(3, nbat, B).transpose(1, 0, 2))).to(dev)
            step = self._probe_step(W, B)
            return [step(x64, svd[b]) for b in range(nbat)]

        prof = self.last_profile = {}
        _t0 = _time.perf_counter()
        st_l = np.concatenate([r["starts"][r["li"]] for r in per])
        wd_l = np.concatenate([r["wid"][r["li"]] for r in per])
        st_s = np.concatenate([r["starts"][r["si"]] for r in per])
        pa_l = run_probe(1, st_l, wd_l, lm_l, B_long)
        pa_s = run_probe(0, st_s, None, lm_s, B_short)
        prof["probe_dispatch"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()

        # --- host mid-pass: the per-row reductions of every batch in
        # one fetch, then the scalar recurrences in stream order
        red = torch.cat([torch.stack([o[k] for k in (6, 7, 8, 9)])
                         for o in pa_l + pa_s], 1).cpu().numpy()
        NLrows = len(pa_l) * B_long * ch
        lam_l, hi_l, up_l, un_l = red[:, :NLrows]
        lam_s = red[0, NLrows:]
        prof["probe_wait"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        nlong = len(st_l)
        nshort = len(st_s)
        zrow = NLrows + len(pa_s) * B_short * ch

        look_mnt = []
        for bt in range(4):
            bi = min(bt, len(self.setup.psy_params) - 1)
            pv = self.setup.psy_params[bi]
            mv = self.analysis.look.m_val
            look_mnt.append((mv, float(pv.get("normal_thresh", 1.0))))

        amp_l = np.full(nlong, -9999.0, np.float32)
        amp_s = np.full(nshort, -9999.0, np.float32)
        lc_l = np.full(nlong * ch, -1.0, np.float32)
        lc_s = np.full(nshort * ch, -1.0, np.float32)
        po_l = np.full(nlong * ch, -1.0, np.float32)
        prev_l = np.full(nlong * ch, zrow, np.int64)
        prev_s = np.full(nshort * ch, zrow, np.int64)

        # padded (S, Fmax) / (S, ch, Fmax) layouts so ONE vectorized
        # recurrence covers every stream (ampmax/lowcomp lanes evolve
        # independently; pad frames trail the real ones and are never
        # read back)
        lam_p = np.full((S, Fmax), -9999.0, np.float32)
        hi_p = np.zeros((S, ch, Fmax), np.float32)
        up_p = np.zeros((S, ch, Fmax), np.float32)
        un_p = np.zeros((S, ch, Fmax), np.float32)
        gls, gss = [], []
        for sidx, rec in enumerate(per):
            li, si = rec["li"], rec["si"]
            F = len(rec["Ws"])
            # global row index per (frame, ch)
            rowf = np.empty((F, ch), np.int64)
            gl = rec["lofs"] + np.arange(len(li))
            gs = rec["sofs"] + np.arange(len(si))
            gls.append(gl)
            gss.append(gs)
            for c in range(ch):
                rowf[li, c] = gl * ch + c
                rowf[si, c] = NLrows + gs * ch + c
            prev = np.concatenate([[[zrow] * ch], rowf[:-1]])
            for c in range(ch):
                prev_l[gl * ch + c] = prev[li, c]
                prev_s[gs * ch + c] = prev[si, c]
            # lam per frame = max over channels
            lamf = np.empty(F, np.float32)
            lamf[li] = np.max(
                lam_l[(gl * ch)[:, None] + np.arange(ch)], -1) \
                if len(li) else 0
            if len(si):
                lamf[si] = np.max(
                    lam_s[(gs * ch)[:, None] + np.arange(ch)], -1)
            lam_p[sidx, :F] = lamf
            for c in range(ch):
                if len(li):
                    hi_p[sidx, c, li] = hi_l[gl * ch + c]
                    up_p[sidx, c, li] = up_l[gl * ch + c]
                    un_p[sidx, c, li] = un_l[gl * ch + c]
        amp_all = PD.ampmax_seq_nd(
            lam_p, Ws_p, self.vi.blocksizes, self.rate,
            self.setup.psy_global["ampmax_att_per_sec"])
        bm_r = np.repeat(ann_nd["bm"], ch, 0)        # (S*ch, Fmax)
        lWbm_r = np.repeat(ann_nd["lW_bm"], ch, 0)
        lc_all = PD.lowcomp_seq_nd(hi_p.reshape(S * ch, Fmax),
                                   bm_r, lWbm_r, look_mnt)
        po_all = PD.poste_seq(up_p.reshape(S * ch, Fmax),
                              un_p.reshape(S * ch, Fmax),
                              {"bm": bm_r, "lW_bm": lWbm_r}, self.n)
        for sidx, rec in enumerate(per):
            li, si = rec["li"], rec["si"]
            gl, gs = gls[sidx], gss[sidx]
            amp_l[gl] = amp_all[sidx, li]
            amp_s[gs] = amp_all[sidx, si]
            for c in range(ch):
                r = sidx * ch + c
                lc_l[gl * ch + c] = lc_all[r, li]
                lc_s[gs * ch + c] = lc_all[r, si]
                po_l[gl * ch + c] = po_all[r, li]
        # M3 params for all streams' short frames (global short order
        # IS stream order: gs = sofs + arange), as the finish step's
        # (6, F) m3vec rows [sw, noise_rate, noise_center, tone_rate,
        # reset, impad_zero]; M3 acts on impulse short blocks only
        # (sw = bm == 0), which only block switching schedules
        m3 = None
        if nshort and hsrate:
            sub = {k: np.concatenate(
                [a[k][r["si"]] for a, r in zip(anns, per)])
                for k in ("bm", "lW_bm", "lW_no", "impadnum")}
            toneatt1 = float(self.analysis.look.vi["tone_masteratt"][1])
            pr = PD.m3_param_seq(sub, self.vi.blocksizes[0] // 2,
                                 toneatt1, True, managed=managed)
            m3 = np.stack([pr["sw"], pr["noise_rate"],
                           pr["noise_center"], pr["tone_rate"],
                           pr["reset"], sub["impadnum"] == 0]
                          ).astype(np.float32)

        # --- the global lastmdct-contribution buffer: every batch's
        # rows plus one zero row at index zrow; it stays on the device
        L_all = torch.cat([o[5] for o in pa_l + pa_s]
                          + [torch.zeros((1, n2L), dtype=torch.float32,
                                         device=dev)], 0)

        # --- phase B: finish all batches, then drain
        def run_finish(W, outs, B, amp, lc, po, tr, prevrows, wids,
                       m3=None):
            devW = self._dev_for(W)
            nbat = len(outs)
            F = len(amp)
            if not F:
                return ([], None) if managed else self._drain(
                    [], None, devW.plan.wb, 0)

            def rows(a, fill):
                return self._pad_to(a, nbat * B * (len(a) // F),
                                    fill).reshape(nbat, -1)
            # per-batch state, one upload each for all batches: fstate
            # [ampmax (B), lowcomp (B*ch), poste (B*ch), trans (B),
            # wid (B)] padded at -9999 / -1 / -1 / 0 / 3, and the
            # lastmdct rows to gather (pads point at the zero row)
            fsd = torch.from_numpy(np.concatenate([
                rows(amp, -9999.0), rows(lc, -1.0), rows(po, -1.0),
                rows(tr.astype(np.float32), 0.0),
                rows((wids if wids is not None
                      else np.zeros(F, np.int64)).astype(np.float32),
                     3.0)], 1).astype(np.float32)).to(dev)
            prevd = torch.from_numpy(rows(prevrows, zrow)).to(dev)
            # short mode: every batch's (6, B) M3 rows, pads at 0
            m3d = None if m3 is None else torch.from_numpy(
                np.ascontiguousarray(self._pad_to(m3.T, nbat * B).reshape(
                    nbat, B, 6).transpose(0, 2, 1))).to(dev)

            def args(bi):
                o = outs[bi]
                lastm = (L_all.index_select(0, prevd[bi]) if hsrate
                         else torch.zeros((B * ch, n2L),
                                          dtype=torch.float32,
                                          device=dev))
                return (o[0], o[1], o[2], o[3], o[4], lastm, o[6],
                        fsd[bi], None if m3d is None else m3d[bi])

            if managed:
                # the 15-blob packets stay on the device; the (B, 15)
                # bit counts start to the host at once
                step = self._managed_finish_step(W, B)
                pend = [step(*args(bi)) for bi in range(nbat)]
                return [(pk, self._start_to_host(nb)) for pk, nb in pend], \
                    args
            step = self._finish_step(W, B)
            pend = [step(*args(bi)) for bi in range(nbat)]
            return self._drain(
                pend, lambda bi: self._finish_step(
                    W, B, devW.plan.worst_bytes)(*args(bi)),
                devW.plan.wb, F)

        prof["host_midpass"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        res_l = run_finish(1, pa_l, B_long, amp_l, lc_l, po_l, tr_l,
                           prev_l, wd_l)
        # per-frame blocktype flag for shorts: padding (bm==1) selects
        # the alternate noise-bias curve
        pad_s = np.concatenate(
            [a["bm"][r["si"]] for a, r in zip(anns, per)]) == 1
        res_s = run_finish(0, pa_s, B_short, amp_s, lc_s,
                           np.full(nshort * ch, -1.0, np.float32), pad_s,
                           prev_s, None, m3)
        prof["finish"] = _time.perf_counter() - _t0
        if managed:
            return (res_l, B_long), (res_s, B_short)
        return res_l, res_s

    def _run_gather_batches(self, W, x64d, starts, wids, B=1024):
        """Run the mode-W gather step over all frames (padded to B per
        dispatch); returns (blob uint8, off (F,) byte offsets,
        nbits (F,)) -- packet i is blob[off[i]:off[i] +
        ((nbits[i]+7)>>3)]."""
        devW = self._dev_for(W)
        step = self._gather_step(W, B)
        F = len(starts)
        nbat = -(-F // B)
        sw = np.zeros((2, nbat * B), np.int32)
        sw[0, :F] = starts
        if wids is not None:
            sw[1] = 3
            sw[1, :F] = wids
        swd = torch.from_numpy(np.ascontiguousarray(
            sw.reshape(2, nbat, B).transpose(1, 0, 2))).to(self.device)
        pend = [step(x64d, swd[b, 0], swd[b, 1]) for b in range(nbat)]
        big = lambda bi: self._gather_step(W, B, devW.plan.worst_bytes)(
            x64d, swd[bi, 0], swd[bi, 1])
        return self._drain(pend, big, devW.plan.wb, F)

    def encode_batch(self, pcms, serialnos=None, comments=None,
                     switching=None, B_long=2048, B_short=256):
        """Encode S independent streams through ONE device pipeline:
        all streams' frames ride the same batched steps, so device
        occupancy no longer depends on single-stream length, and the
        host does only the per-stream recurrences and Ogg paging.

        pcms: list of (ch, ns) int16/float32 arrays or tensors (a
        tensor stays on the device; only its edges go to the host for
        the LPC pads); lengths may differ.  Returns a list of Ogg byte
        strings (one per stream)."""
        sw = self.switching if switching is None else switching
        if serialnos is None:
            serialnos = [778 + i for i in range(len(pcms))]
        x64, per = self._prepare_switched(pcms, sw)
        gl_st = [r["starts"][r["li"]] for r in per]
        gl_wd = [r["wid"][r["li"]] for r in per]
        gs_st = [r["starts"][r["si"]] for r in per]

        # the batched device pipelines, ALL streams together
        if self.psy_state:
            (bl_l, of_l, nb_l), (bl_s, of_s, nb_s) = \
                self._run_two_phase(x64, per, B_long, B_short)
        else:
            bl_l, of_l, nb_l = self._run_gather_batches(
                1, x64, np.concatenate(gl_st), np.concatenate(gl_wd),
                B=B_long)
            bl_s, of_s, nb_s = self._run_gather_batches(
                0, x64, np.concatenate(gs_st), None, B=B_short)

        # per-stream Ogg paging
        outs = []
        for rec, serialno in zip(per, serialnos):
            sizes = np.empty(len(rec["cs"]), np.int64)
            rows = rec["rows"]
            li, si = rec["li"], rec["si"]
            sizes[li] = (nb_l[rows[li]] + 7) >> 3
            if len(si):
                sizes[si] = (nb_s[rows[si]] + 7) >> 3
            ilk = np.zeros(len(rec["cs"]), np.int64)
            ilk[li] = of_l[rows[li]]
            if len(si):
                ilk[si] = of_s[rows[si]]
            outs.append(self._page_stream(rec, serialno, comments,
                                          bl_l, bl_s, ilk, sizes))
        return outs

    def _prepare_switched(self, pcms, sw):
        """encode_batch's set-up: the concatenated padded 64-row device
        layout (per-stream LPC edge pads keep gathers from ever crossing
        streams) and the per-stream block schedules.  Returns
        (x64 (ch, R, 64), per) where each per-stream record carries
        cs/Ws/li/si/starts/wid/impulse/rows and the global long/short
        offsets.  With sw, the batched envelope marks and the exact
        stretch rescue drive each stream's schedule (every stream is
        padded to at least one envelope chunk)."""
        ch = self.ch
        hop = self.n // 2
        n0 = self.vi.blocksizes[0]
        dev = self.device
        minS = (self._ENV_STEPS + 1) * 64 if sw else 0
        srcs = []
        for pcm in pcms:
            if torch.is_tensor(pcm):
                pcm = pcm.to(dev)
                if pcm.dtype != torch.int16:
                    pcm = pcm.to(torch.float32)
            elif pcm.dtype != np.int16:
                pcm = np.asarray(pcm, np.float32)
            srcs.append(pcm)
        # every device-resident stream's two edge slices go to the host
        # in one wave before any LPC pad is computed
        ws, cuts = [], []
        for pcm in srcs:
            if torch.is_tensor(pcm):
                ns = int(pcm.shape[1])
                w = int(min(ns, 4 * self.n))
                ws.append(w)
                cuts.append(torch.cat([pcm[:, :w], pcm[:, ns - w:]], 1))
        host = iter(zip(self._to_host(cuts), ws))
        edges = [next(host) if torch.is_tensor(pcm) else None
                 for pcm in srcs]
        metas, parts = [], []
        base = 0
        for pcm, edge in zip(srcs, edges):
            assert pcm.shape[0] == ch
            ns = int(pcm.shape[1])
            Si = ((ns + hop + 4 * hop + 63) // 64) * 64 + 64
            Si = max(Si, minS)
            tail = Si - ns - hop
            if edge is not None:
                e, w = edge
                front, tailbuf = self._edge_pads(
                    pcm, hop, tail, src=(e[:, :w], e[:, w:]))
                # both pads in one upload, joined around the resident
                # body on the device
                pads = torch.from_numpy(
                    np.concatenate([front, tailbuf], 1)).to(dev)
                xd = torch.cat([pads[:, :hop], pcm, pads[:, hop:]], 1)
            else:
                front, tailbuf = self._edge_pads(pcm, hop, tail)
                xd = torch.from_numpy(
                    np.concatenate([front, pcm, tailbuf], 1)).to(dev)
            parts.append(xd.reshape(ch, Si // 64, 64))
            metas.append((ns, base, Si))
            base += Si // 64
        if len({p.dtype for p in parts}) > 1:
            # mixed int16/float32 inputs: promote to the f32 domain the
            # gather step would produce anyway (x/32768)
            parts = [p.to(torch.float32) / 32768.0
                     if p.dtype != torch.float32 else p for p in parts]
        x64 = parts[0] if len(parts) == 1 else torch.cat(parts, 1)

        # envelope marks (all streams batched) + exact-stretch rescue
        # around candidate clusters
        if sw:
            marks = self._envelope_marks_multi(x64, metas)
            self._stretch_rescue(x64, metas, marks)
        else:
            marks = [np.zeros(Si // 64 - 1, bool) for (_, _, Si) in metas]

        # per-stream block schedule -> global frame lists
        per = []
        nlong = nshort = 0
        for (ns, brow, Si), mk in zip(metas, marks):
            cs, Ws, impulse = self._schedule(mk, ns)
            lW = np.concatenate([[1], Ws[:-1]])
            nW = np.concatenate([Ws[1:], [Ws[-1]]])
            bsz = np.where(Ws == 1, self.n, n0)
            starts = cs - bsz // 2 + brow * 64
            wid = (lW * 2 + nW).astype(np.int64)
            li = np.where(Ws == 1)[0]
            si = np.where(Ws == 0)[0]
            rows = np.zeros(len(cs), np.int64)   # global packet rows
            rows[li] = nlong + np.arange(len(li))
            rows[si] = nshort + np.arange(len(si))
            per.append(dict(cs=cs, Ws=Ws, li=li, si=si, ns=ns,
                            lofs=nlong, sofs=nshort, starts=starts,
                            wid=wid, impulse=impulse, rows=rows))
            nlong += len(li)
            nshort += len(si)
        return x64, per

    def _page_stream(self, rec, serialno, comments, bl_l, bl_s, ilk,
                     sizes):
        """Assemble one stream's Ogg from dense packet blobs: ilk =
        per-packet byte offset into bl_l/bl_s (the host C pager reads
        pk + ilk[i]*width, so width=1 + byte offsets address the blobs
        directly), sizes = final packet bytes."""
        cs, Ws, ns = rec["cs"], rec["Ws"], rec["ns"]
        hop = self.n // 2
        w = OggStreamWriter(serialno)
        h1, h2, h3 = self.enc.header_packets(comments)
        w.packetin(h1, 0)
        w.flush()
        w.packetin(h2, 0)
        w.packetin(h3, 0)
        w.flush()
        gps = cs - hop
        gps[-1] = ns
        blob, w.pageno = native.ogg_pages(
            bl_l, bl_s, ilk, (Ws == 0).astype(np.uint8), sizes, gps,
            serialno, w.pageno)
        w._pages.append(blob)
        return w.pageout_all()

    # -- managed (ABR/CBR) path --------------------------------------------
    def encode_managed(self, pcm, serialno=778, comments=None, chunk=256,
                       switching=None) -> bytes:
        """Managed encode of one stream (see encode_managed_batch)."""
        return self.encode_managed_batch([pcm], [serialno], comments,
                                         chunk=chunk,
                                         switching=switching)[0]

    # frames budget per managed device wave: bounds live device memory
    # (probe spectra + the 15-blob packet buffers stay resident until
    # the wave's reservoir/gather drains them)
    _MANAGED_GROUP_FRAMES = 24576

    def encode_managed_batch(self, pcms, serialnos=None, comments=None,
                             chunk=256, switching=None, B_long=256,
                             B_short=256) -> list:
        """Managed (ABR/CBR) encode of MANY independent streams.

        With switching (the default when the template has two block
        sizes): the envelope schedule drives 256/2048 block selection,
        every frame runs the 15-packetblob stateful finish on the device
        (the blob axis folded into the frame batch,
        ops/managed.make_finish_step15), the per-stream host reservoir
        floater (ReservoirChooser, lib/bitrate.c:73-227, fed each
        packet's W) picks each packet, and a device gather fetches only
        the chosen blob's bytes.  Streams run in groups of about
        _MANAGED_GROUP_FRAMES frames, so live device memory is bounded
        by a group, not the job.  `last_managed` counts the frames,
        batches, oversized redos, truncates and pads of the last group,
        and holds its streams' chosen blobs in frame order (switched
        path).

        switching=False (or a single-blocksize template) selects the
        long-only pipeline in chunks of `chunk` frames, stateful unless
        psy_state=False."""
        if not self.managed:
            raise ValueError("construct FastEncoder(bitrate=...) first")
        if self.mapping.submaps > 1 or self.mapping.coupling_steps > 1:
            raise NotImplementedError(
                "managed bitrate on a multi-submap layout (5.1): the JAX "
                "package's managed finish has no multi-submap branch "
                "(vorbis_tpu/ops/managed.py:398 reaches "
                "encdevice.py:676 _floor_wrap, which raises "
                "AttributeError), so there is no reference to port")
        if serialnos is None:
            serialnos = [778 + i for i in range(len(pcms))]
        if len(serialnos) < len(pcms):
            raise ValueError(f"{len(serialnos)} serialnos < {len(pcms)} "
                             f"streams")
        sw = self.switching if switching is None else switching
        if not sw:
            return self._encode_managed_long(pcms, serialnos, comments,
                                             chunk)
        hop = self.n // 2
        outs = []
        i = 0
        while i < len(pcms):
            j, acc = i, 0
            while j < len(pcms) and (
                    j == i or acc + pcms[j].shape[1] // hop + 4
                    <= self._MANAGED_GROUP_FRAMES):
                acc += pcms[j].shape[1] // hop + 4
                j += 1
            outs += self._encode_managed_switched(
                pcms[i:j], serialnos[i:j], comments, B_long, B_short)
            i = j
        return outs

    def _encode_managed_switched(self, pcms, serialnos, comments,
                                 B_long=256, B_short=256):
        """One device wave of the switched managed pipeline (see
        encode_managed_batch)."""
        import time as _time

        from ..ops.managed import (PACKETBLOBS, ReservoirChooser,
                                   compact_chosen, reservoir_walk)
        x64, per = self._prepare_switched(pcms, True)
        res_l, res_s = self._run_two_phase(x64, per, B_long, B_short,
                                           managed=True)
        prof = self.last_profile
        _t0 = _time.perf_counter()
        nlong = sum(len(r["li"]) for r in per)
        nshort = sum(len(r["si"]) for r in per)
        if self.device.type == "cuda":
            torch.cuda.synchronize()       # the (B, 15) bit counts landed

        def nbits(res, total):
            pend = res[0][0]
            if not pend:
                return np.zeros((0, PACKETBLOBS), np.int64)
            return np.concatenate([nb.numpy() for _, nb in pend])[
                :total].astype(np.int64)

        nb_l = nbits(res_l, nlong)
        nb_s = nbits(res_s, nshort)

        # per-stream reservoir walk in frame order (mixing W groups)
        choices = []
        cho_l = np.zeros(nlong, np.int64)
        cho_s = np.zeros(nshort, np.int64)
        tp_l = np.zeros((nlong, 2), np.int64)     # (truncate, pad)
        tp_s = np.zeros((nshort, 2), np.int64)
        for rec in per:
            F = len(rec["Ws"])
            li, si = rec["li"], rec["si"]
            gl = rec["lofs"] + np.arange(len(li))
            gs = rec["sofs"] + np.arange(len(si))
            sizes = np.empty((F, PACKETBLOBS), np.int64)
            sizes[li] = (nb_l[gl] + 7) >> 3
            sizes[si] = (nb_s[gs] + 7) >> 3
            cf, tf = reservoir_walk(
                ReservoirChooser(self.setup, self.rate, self.vi.blocksizes),
                sizes, rec["Ws"])
            cho_l[gl], tp_l[gl] = cf[li], tf[li]
            cho_s[gs], tp_s[gs] = cf[si], tf[si]
            choices.append(cf)
        prof["reservoir"] = _time.perf_counter() - _t0
        _t0 = _time.perf_counter()

        # gather the chosen blob per batch on the device (a batch whose
        # chosen packet outgrew the budget is redone at the worst case),
        # fetch in one wave, then apply truncate/pad while compacting
        # into the dense (blob, off) pager form
        def drain_sel(res, W, choices, tps, nbW, total):
            (pend, args), B = res
            if not pend:
                return (np.zeros(0, np.uint8), np.zeros(0, np.int64),
                        np.zeros(0, np.int64), 0)
            mdev = self._managed_dev_for(W)
            plan = mdev.dev.plan
            chd = torch.from_numpy(self._pad_to(
                choices, len(pend) * B)).to(self.device)
            sel, redos = [], 0
            for bi, (pk, _) in enumerate(pend):
                g = np.arange(bi * B, min((bi + 1) * B, total))
                if (nbW[g, choices[g]] > plan.wb * 8).any():
                    pk, _ = self._managed_finish_step(
                        W, B, plan.worst_bytes)(*args(bi))
                    redos += 1
                sel.append(mdev.gather(pk, chd[bi * B:(bi + 1) * B]))
            chosen = (nbW[np.arange(total), choices] + 7) >> 3
            return (*compact_chosen(self._to_host(sel), chosen, tps),
                    redos)

        bl_l, of_l, sz_l, rd_l = drain_sel(res_l, 1, cho_l, tp_l, nb_l,
                                           nlong)
        bl_s, of_s, sz_s, rd_s = drain_sel(res_s, 0, cho_s, tp_s, nb_s,
                                           nshort)
        prof["gather"] = _time.perf_counter() - _t0
        tps = np.concatenate([tp_l, tp_s])
        self.last_managed = dict(
            long=nlong, short=nshort, long_batches=len(res_l[0][0]),
            short_batches=len(res_s[0][0]), redos_long=rd_l,
            redos_short=rd_s, truncates=int((tps[:, 0] > 0).sum()),
            pads=int((tps[:, 1] > 0).sum()), choices=choices)

        # per-stream Ogg paging (the dense-blob pager of encode_batch)
        _t0 = _time.perf_counter()
        outs = []
        for rec, serialno in zip(per, serialnos):
            rows = rec["rows"]
            li, si = rec["li"], rec["si"]
            sizes = np.empty(len(rec["cs"]), np.int64)
            sizes[li] = sz_l[rows[li]]
            sizes[si] = sz_s[rows[si]]
            ilk = np.zeros(len(rec["cs"]), np.int64)
            ilk[li] = of_l[rows[li]]
            ilk[si] = of_s[rows[si]]
            outs.append(self._page_stream(rec, serialno, comments,
                                          bl_l, bl_s, ilk, sizes))
        prof["paging"] = _time.perf_counter() - _t0
        return outs

    def _frame(self, pcm):
        """(ch, ns) PCM, numpy or tensor -> (F, ch, n) float32 frames on
        the device (a view), lapped at hop over a hop of front pad and
        two of tail; int16 is scaled by 1/32768."""
        x = (pcm if torch.is_tensor(pcm) else torch.from_numpy(
            np.ascontiguousarray(pcm))).to(self.device)
        x = x.to(torch.float32) / (32768.0 if x.dtype == torch.int16
                                   else 1.0)
        hop = self.n // 2
        x = torch.nn.functional.pad(x, (hop, 2 * hop))
        nf = (x.shape[1] - self.n) // hop + 1
        return x.unfold(1, self.n, hop)[:, :nf].transpose(0, 1)

    def _encode_managed_long(self, pcms, serialnos, comments,
                             chunk=256) -> list:
        """Long-only managed pipeline (switching=False and the
        single-blocksize templates): every chunk of frames runs the
        15-packetblob device pass, the host reservoir picks each
        packet, a device gather fetches only the chosen blob's
        bytes."""
        from ..ops import psydevice as PD
        from ..ops.managed import ReservoirChooser, reservoir_walk
        mdev = self._managed_dev_for(self.W_main)
        plan = mdev.dev.plan
        hop = self.n // 2
        ch = self.ch
        dev = self.device

        # ---- per-stream framing + the global (stream, chunk) list
        streams = []
        work = []                        # (sidx, frame offset o)
        for sidx, pcm in enumerate(pcms):
            if pcm.shape[0] != ch:
                raise ValueError(f"pcm has {pcm.shape[0]} channels, "
                                 f"encoder {ch}")
            frames = self._frame(pcm)
            streams.append(dict(frames=frames, F=frames.shape[0],
                                ns=int(pcm.shape[1])))
            work += [(sidx, o) for o in range(0, frames.shape[0], chunk)]

        def chunk_frames(sidx, o):
            blk = streams[sidx]["frames"][o:o + chunk]
            return torch.nn.functional.pad(
                blk, (0, 0, 0, 0, 0, chunk - blk.shape[0])).contiguous()

        # ---- dispatch all chunks; the (chunk, 15) bit counts start to
        # the host at once
        if self.psy_state:
            # two-phase: probe all chunks, replay the ampmax decay on
            # the host (each stream is an independent lane of
            # ampmax_seq_nd), finish with per-frame state (the managed
            # path is long-only: ampmax + M9 lastmdct are the live
            # states; lastmdct rows never cross a stream boundary)
            probe = mdev.make_probe_step(chunk)
            finish = mdev.make_finish_step(chunk)
            probes = [probe(chunk_frames(sidx, o)) for sidx, o in work]
            lamf = self._to_host([torch.cat([ob[5] for ob in probes])])[
                0].reshape(-1, ch).max(-1)           # global frame order
            S = len(streams)
            Fcmax = chunk * max(sum(w == sidx for w, _ in work)
                                for sidx in range(S))
            lam_p = np.full((S, Fcmax), -9999.0, np.float32)
            gbase = []
            cur = [0] * S
            for wi, (sidx, o) in enumerate(work):
                lam_p[sidx, cur[sidx]:cur[sidx] + chunk] = \
                    lamf[wi * chunk:(wi + 1) * chunk]
                gbase.append(cur[sidx])
                cur[sidx] += chunk
            amp_nd = PD.ampmax_seq_nd(
                lam_p, np.full((S, Fcmax), self.W_main, np.int64),
                self.vi.blocksizes, self.rate,
                self.setup.psy_global["ampmax_att_per_sec"]) \
                .astype(np.float32)
            hsrate = self.rate >= 26000
            n2L = mdev.n2
            zeros = torch.zeros((chunk * ch, n2L), device=dev)
            if hsrate:
                # previous frame's logmdct rows; the first frame of EACH
                # STREAM reads the zero row
                L_all = torch.cat([ob[1] for ob in probes]
                                  + [zeros[:1]], 0)
                zrow = len(probes) * chunk * ch
                g = np.arange(len(probes) * chunk)
                within = np.concatenate([np.arange(chunk) + b
                                         for b in gbase])
                prow = np.where(within[:, None] == 0, zrow,
                                (g - 1)[:, None] * ch
                                + np.arange(ch)[None, :])
                prow = torch.from_numpy(prow.reshape(
                    len(probes), -1)).to(dev)
            ampd = torch.from_numpy(np.stack(
                [amp_nd[sidx, b:b + chunk]
                 for (sidx, _), b in zip(work, gbase)])).to(dev)

            def args(wi):
                ob = probes[wi]
                lastm = L_all.index_select(0, prow[wi]) if hsrate \
                    else zeros
                return (*ob[:5], lastm, ob[5], ampd[wi])

            def redo(wi):
                return mdev.make_finish_step(chunk, plan.worst_bytes)(
                    *args(wi))
            pend = [finish(*args(wi)) for wi in range(len(work))]
        else:
            step = mdev.make_framed_step(chunk)

            def redo(wi):
                return mdev.make_framed_step(chunk, plan.worst_bytes)(
                    chunk_frames(*work[wi]))
            pend = [step(chunk_frames(sidx, o)) for sidx, o in work]
        nbs = self._to_host([nb for _, nb in pend])

        # ---- per-stream reservoir walk (work is stream-major, so each
        # stream's chunks arrive in order), then the device gather of
        # the chosen blobs, fetched in one wave
        sizes = {}
        for wi, (sidx, o) in enumerate(work):
            hi = min(chunk, streams[sidx]["F"] - o)
            sizes.setdefault(sidx, []).append((nbs[wi][:hi] + 7) >> 3)
        picks = {}
        for sidx, st in enumerate(streams):
            sz = np.concatenate(sizes[sidx]).astype(np.int64)
            picks[sidx] = (sz, *reservoir_walk(
                ReservoirChooser(self.setup, self.rate, self.vi.blocksizes),
                sz, np.full(len(sz), self.W_main)))
        sel = []
        for wi, ((sidx, o), (pk, _)) in enumerate(zip(work, pend)):
            sz, cf, _ = picks[sidx]
            c = cf[o:o + chunk]
            if (sz[o + np.arange(len(c)), c] > plan.wb).any():
                # an oversized chosen packet: redo the chunk at the
                # static worst-case budget
                pk, _ = redo(wi)
            sel.append(mdev.gather(pk[:len(c)], torch.from_numpy(c).to(
                dev)))
        sel = self._to_host(sel)

        # ---- per-stream Ogg assembly
        outs = []
        for sidx, serialno in enumerate(serialnos[:len(streams)]):
            st = streams[sidx]
            w = OggStreamWriter(serialno)
            h1, h2, h3 = self.enc.header_packets(comments)
            w.packetin(h1, 0)
            w.flush()
            w.packetin(h2, 0)
            w.packetin(h3, 0)
            w.flush()
            sz, cf, tf = picks[sidx]
            # the stream's chunks in order; a chunk redone at the
            # worst-case budget has wider rows than the others
            rows = [s for (si, _), s in zip(work, sel) if si == sidx]
            F, ns = st["F"], st["ns"]
            gp = 0
            for f in range(F):
                nbytes = int(sz[f, cf[f]])
                row = rows[f // chunk][f % chunk]
                data = row[:nbytes - int(tf[f, 0])].tobytes() \
                    + b"\x00" * int(tf[f, 1])
                gp = 0 if f == 0 else gp + hop
                eos = f == F - 1
                if eos:
                    gp = ns
                w.packetin(data, gp if f > 0 else 0, eos=eos)
                if f % 16 == 0 or eos:
                    w.flush(eos=eos)
            outs.append(w.pageout_all())
        return outs

    # -- host side ---------------------------------------------------------
    def _encode_switched(self, pcm, serialno, comments):
        return self.encode_batch([pcm], [serialno], comments,
                                 switching=True, B_long=1024)[0]

    def encode(self, pcm, serialno=778, comments=None,
               switching=None) -> bytes:
        """Full VBR fast encode of (ch, samples) -> Ogg bytes.

        With psy_state (the default) this is encode_batch of the one
        stream at B_long=1024.  Without, the whole per-packet pipeline
        runs on the device a chunk of
        `dev.chunk_packets` packets at a time (the last chunk is cut to
        the packets it holds); the host slices the packed packets and
        frames Ogg pages.  pcm may be a numpy array, float32 (reference
        scale) or int16 (scaled by 1/32768 on the device), staged to the
        device chunk by chunk, or a tensor on the device, sliced there.
        """
        if self.managed:
            return self.encode_managed(pcm, serialno, comments,
                                       switching=switching)
        sw = self.switching if switching is None else switching
        if sw:
            return self._encode_switched(pcm, serialno, comments)
        if self.psy_state:
            # the stateful pipeline runs through the batch path (an
            # all-long schedule when switching is off)
            return self.encode_batch([pcm], [serialno], comments,
                                     switching=False, B_long=1024)[0]
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
