"""Encoder setup: (channels, rate, quality | bitrate) -> full codec
configuration.

Reimplements the reference's template-driven setup chain
(lib/vorbisenc.c: get_setup_template, vorbis_encode_setup_vbr/managed,
vorbis_encode_setup_init and the per-subsystem *_setup helpers) on top
of the transcribed static tables.  The output must be byte-identical at
the header level with the reference encoder for any supported config —
that is the test contract.

Copy of vorbis_tpu/models/encsetup.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..codec import headers as H
from ..codec.codebook import Codebook
from . import modes as M

PACKETBLOBS = M.PACKETBLOBS
LFE_FRQLIMIT = 250


@dataclass
class HighLevel:
    base_setting: float = 0.0
    managed: bool = False
    coupling_p: bool = True
    impulse_block_p: bool = True
    noise_normalize_p: bool = True
    lowpass_kHz: float = 0.0
    lowpass_altered: bool = False
    pre_amplitude: float = 1.0
    ath_floating_dB: float = 0.0
    ath_absolute_dB: float = 0.0
    amplitude_track_dBpersec: float = -6.0
    trigger_setting: float = 0.0
    bitrate_min: int = 0
    bitrate_max: int = 0
    bitrate_av: int = 0
    bitrate_av_damp: float = 1.5
    bitrate_reservoir: int = 0
    bitrate_reservoir_bias: float = 0.1
    impulse_noisetune: float = 0.0
    block_settings: list = field(default_factory=lambda: [0.0] * 4)


@dataclass
class EncoderSetup:
    vi: H.VorbisInfo
    hi: HighLevel
    psy_params: list          # vorbis_info_psy per block type (2 or 4)
    psy_global: M.Struct
    floor_full: list          # full floor structs incl. encoder fields + n
    block_lowpassr: list      # [short, long]
    template_name: str = ""

    @property
    def singleblock(self):
        return self.vi.blocksizes[0] == self.vi.blocksizes[1]


def get_setup_template(ch, srate, req, q_or_bitrate):
    if q_or_bitrate:
        req /= ch
    for name in M.setup_list():
        tpl = M.setup_template(name)
        if tpl.coupling_restriction not in (-1, ch):
            continue
        if not (tpl.samplerate_min_restriction <= srate
                <= tpl.samplerate_max_restriction):
            continue
        mappings = tpl.mappings
        mp = tpl.rate_mapping if q_or_bitrate else tpl.quality_mapping
        if mp is None:
            continue
        if req < mp[0] or req > mp[mappings]:
            continue
        j = 0
        while j < mappings and not (mp[j] <= req < mp[j + 1]):
            j += 1
        if j == mappings:
            base = j - 0.001
        else:
            # C: float low=map[j], high=map[j+1];
            #    float del=(req-low)/(high-low);
            # req stays double; the division happens in double (low/high
            # promote) and only the result rounds to f32.
            # C: float low=map[j], high=map[j+1];
            #    float del=(req-low)/(high-low);
            #    *base_setting=j+del;   <- int+float = FLOAT add
            # req stays double; the division happens in double (low/high
            # promote), rounds once to f32, and the j+del add rounds to
            # f32 again (e.g. 6+8.94e-7 -> 6.00000095367431640625).
            low = float(np.float32(mp[j]))
            high = float(np.float32(mp[j + 1]))
            delta = np.float32((req - low) / (high - low))
            base = float(np.float32(np.float32(j) + delta))
        return tpl, base
    return None, None


def _interp(arr, s, get=lambda a, i: a[i]):
    is_ = int(s)
    ds = s - is_
    return get(arr, is_) * (1.0 - ds) + get(arr, is_ + 1) * ds


class SetupBuilder:
    """Staged setup mirroring the 3-step C API: setup_vbr/setup_managed
    -> vorbis_encode_ctl -> vorbis_encode_setup_init
    (reference: vorbisenc.c:952/997/1072/722)."""

    def __init__(self, tpl, hi: HighLevel, ch: int, rate: int,
                 req: float):
        self.tpl = tpl
        self.hi = hi
        self.ch = ch
        self.rate = rate
        self.req = req
        self.set_in_stone = False

    # -- vorbis_encode_ctl equivalents (vorbisenc.c:1072-1274) ----------
    def ctl_lowpass_get(self) -> float:
        return self.hi.lowpass_kHz

    def ctl_lowpass_set(self, kHz: float) -> None:
        self._writable()
        self.hi.lowpass_kHz = min(max(float(kHz), 2.0), 99.0)
        self.hi.lowpass_altered = True

    def ctl_iblock_get(self) -> float:
        return self.hi.impulse_noisetune

    def ctl_iblock_set(self, v: float) -> None:
        self._writable()
        self.hi.impulse_noisetune = min(max(float(v), -15.0), 0.0)

    def ctl_coupling_get(self) -> bool:
        return self.hi.coupling_p

    def ctl_coupling_set(self, flag: bool) -> None:
        """Re-fetches the (un)coupled template; base_setting moves with
        it but an explicitly-altered lowpass survives
        (vorbisenc.c:1246-1269)."""
        self._writable()
        self.hi.coupling_p = bool(flag)
        tpl, base = get_setup_template(
            self.ch if self.hi.coupling_p else -1, self.rate,
            self.req, 1 if self.hi.managed else 0)
        if tpl is None:
            raise ValueError("no matching mode template (OV_EIMPL)")
        self.tpl = tpl
        self.hi.base_setting = base

    def ctl_ratemanage2_get(self) -> dict:
        hi = self.hi
        return {
            "management_active": bool(hi.managed),
            "bitrate_limit_min_kbps": hi.bitrate_min // 1000,
            "bitrate_limit_max_kbps": hi.bitrate_max // 1000,
            "bitrate_average_kbps": hi.bitrate_av // 1000,
            "bitrate_average_damping": hi.bitrate_av_damp,
            "bitrate_limit_reservoir_bits": hi.bitrate_reservoir,
            "bitrate_limit_reservoir_bias": hi.bitrate_reservoir_bias,
        }

    def ctl_ratemanage2_set(self, ai: dict | None) -> None:
        self._writable()
        hi = self.hi
        if ai is None:
            hi.managed = False
            return
        mn = ai.get("bitrate_limit_min_kbps", hi.bitrate_min // 1000)
        mx = ai.get("bitrate_limit_max_kbps", hi.bitrate_max // 1000)
        av = ai.get("bitrate_average_kbps", hi.bitrate_av // 1000)
        damp = ai.get("bitrate_average_damping", hi.bitrate_av_damp)
        res = ai.get("bitrate_limit_reservoir_bits",
                     hi.bitrate_reservoir)
        bias = ai.get("bitrate_limit_reservoir_bias",
                      hi.bitrate_reservoir_bias)
        if mn > 0 and av > 0 and mn > av:
            raise ValueError("OV_EINVAL")
        if mx > 0 and av > 0 and mx < av:
            raise ValueError("OV_EINVAL")
        if mn > 0 and mx > 0 and mn > mx:
            raise ValueError("OV_EINVAL")
        if damp <= 0.0 or res < 0 or not 0.0 <= bias <= 1.0:
            raise ValueError("OV_EINVAL")
        hi.managed = bool(ai.get("management_active", hi.managed))
        hi.bitrate_min = mn * 1000
        hi.bitrate_max = mx * 1000
        hi.bitrate_av = av * 1000
        hi.bitrate_av_damp = damp
        hi.bitrate_reservoir = res
        hi.bitrate_reservoir_bias = bias

    def _writable(self):
        if self.set_in_stone:
            raise ValueError("setup already initialized (OV_EINVAL)")

    def init(self) -> EncoderSetup:
        self.set_in_stone = True
        return _setup_init(self.tpl, self.hi, self.ch, self.rate)


def setup_vbr_staged(ch: int, rate: int, quality: float) -> SetupBuilder:
    # C: float quality; quality+=.0000001; (float add, rounds to f32)
    quality = float(np.float32(np.float64(np.float32(quality))
                               + 0.0000001))
    if quality >= 1.0:
        quality = 0.9999
    tpl, base = get_setup_template(ch, rate, quality, 0)
    if tpl is None:
        raise ValueError("no matching mode template (OV_EIMPL)")
    hi = HighLevel(base_setting=base, managed=False)
    return SetupBuilder(tpl, hi, ch, rate, quality)


def setup_vbr(ch: int, rate: int, quality: float) -> EncoderSetup:
    return setup_vbr_staged(ch, rate, quality).init()


def setup_managed_staged(ch: int, rate: int, max_bps: int,
                         nominal_bps: int, min_bps: int) -> SetupBuilder:
    tnominal = nominal_bps
    if nominal_bps <= 0:
        if max_bps > 0:
            nominal_bps = ((max_bps + min_bps) * 0.5 if min_bps > 0
                           else max_bps * 0.875)
        elif min_bps > 0:
            nominal_bps = min_bps
        else:
            raise ValueError("OV_EINVAL")
    tpl, base = get_setup_template(ch, rate, nominal_bps, 1)
    if tpl is None:
        raise ValueError("no matching mode template (OV_EIMPL)")
    hi = HighLevel(base_setting=base, managed=True,
                   bitrate_min=min_bps, bitrate_max=max_bps,
                   bitrate_av=int(tnominal),
                   bitrate_reservoir=int(nominal_bps * 2))
    return SetupBuilder(tpl, hi, ch, rate, nominal_bps)


def setup_managed(ch: int, rate: int, max_bps: int, nominal_bps: int,
                  min_bps: int) -> EncoderSetup:
    return setup_managed_staged(ch, rate, max_bps, nominal_bps,
                                min_bps).init()


def _setup_init(tpl, hi: HighLevel, ch: int, rate: int) -> EncoderSetup:
    s = hi.base_setting
    is_ = int(s)
    ds = s - is_

    # ---- vorbis_encode_setup_setting ------------------------------------
    if not hi.lowpass_altered:
        hi.lowpass_kHz = _interp(tpl.psy_lowpass, s)
    hi.pre_amplitude = _interp(tpl.pre_amp, s)
    hi.ath_floating_dB = _interp(tpl.psy_ath_float, s)
    hi.ath_absolute_dB = _interp(tpl.psy_ath_abs, s)
    hi.trigger_setting = s
    hi.block_settings = [s] * 4
    if hi.ath_floating_dB > -80:
        hi.ath_floating_dB = -80
    if hi.ath_floating_dB < -200:
        hi.ath_floating_dB = -200

    vi = H.VorbisInfo(channels=ch, rate=rate)
    books = []          # static book objects in ci order
    book_names = []

    # ---- blocksizes -------------------------------------------------------
    bs0 = tpl.blocksize_short[is_]
    bs1 = tpl.blocksize_long[is_]
    vi.blocksizes = (bs0, bs1)
    singleblock = bs0 == bs1

    # ---- floors ------------------------------------------------------------
    floor_books_tbl = M.floor_books_table(tpl.floor_books)
    floor_full = []
    for i in range(tpl.floor_mappings):
        x = tpl.floor_mapping_list[i]
        fidx = x[is_]
        f = tpl.floor_params[fidx].copy()
        f["partitionclass"] = list(f["partitionclass"])
        f["class_book"] = list(f["class_book"])
        f["class_subbook"] = [list(r) for r in f["class_subbook"]]
        maxclass = max(f["partitionclass"][:f["partitions"]], default=-1)
        maxbook = -1
        nbooks0 = len(books)
        for c in range(maxclass + 1):
            if f["class_book"][c] > maxbook:
                maxbook = f["class_book"][c]
            f["class_book"][c] += nbooks0
            for k in range(1 << f["class_subs"][c]):
                if f["class_subbook"][c][k] > maxbook:
                    maxbook = f["class_subbook"][c][k]
                if f["class_subbook"][c][k] >= 0:
                    f["class_subbook"][c][k] += nbooks0
        for b in range(maxbook + 1):
            name = floor_books_tbl[fidx][b]
            books.append(M.static_book(name))
            book_names.append(name)
        floor_full.append(f)

    # ---- psy globals --------------------------------------------------------
    g = _psy_global_setup(tpl, hi)
    _global_stereo(g, tpl, hi, vi, bs0, bs1)

    # ---- per-blocktype psy params -------------------------------------------
    psy_params = _psy_params_setup(tpl, hi, singleblock)

    # ---- maps / modes / residues ---------------------------------------------
    maps_tpl = M.mapping_templates(tpl.maps)
    map_list, res_list = maps_tpl[is_]
    modes = 1 if singleblock else 2
    vi.modes = []
    vi.maps = []
    residues = {}
    residue_types = {}
    block_lowpassr = [0, 0]
    for i in range(modes):
        mt = M.mode_template()[i]
        vi.modes.append(H.ModeInfo(mt[0], mt[1], mt[2], mt[3]))
        m = map_list[i]
        vi.maps.append(H.MappingInfo(
            m.submaps,
            m.coupling_mag[:m.coupling_steps],
            m.coupling_ang[:m.coupling_steps],
            m.chmuxlist[:ch],
            m.floorsubmap[:m.submaps],
            m.residuesubmap[:m.submaps]))
        for j in range(m.submaps):
            number = m.residuesubmap[j]
            _residue_setup(vi, tpl, hi, books, book_names, residues,
                           residue_types, number, i, res_list[number],
                           floor_full, g, block_lowpassr, ch)

    nres = max(residues) + 1
    vi.residues = [residues[k] for k in range(nres)]
    vi.residue_types = [residue_types[k] for k in range(nres)]
    vi.floor_types = [1] * len(floor_full)
    from ..bitstream.bitpack import ilog
    vi.floors = [H.Floor1Info(
        f["partitions"], f["partitionclass"][:f["partitions"]],
        f["class_dim"], f["class_subs"], f["class_book"],
        f["class_subbook"], f["mult"], ilog(f["postlist"][1] - 1),
        f["postlist"][:2 + sum(f["class_dim"][f["partitionclass"][i]]
                               for i in range(f["partitions"]))],
        maxover=f["maxover"], maxunder=f["maxunder"], maxerr=f["maxerr"],
        twofitweight=f["twofitweight"], twofitatten=f["twofitatten"])
        for f in floor_full]

    vi.static_books = books
    vi.books = [Codebook(sb) for sb in books]

    # bitrate fields
    if hi.bitrate_av > 0:
        vi.bitrate_nominal = hi.bitrate_av
    else:
        r = tpl.rate_mapping
        vi.bitrate_nominal = (int(_interp(r, s) * ch) if r is not None
                              else -1)
    vi.bitrate_lower = hi.bitrate_min
    vi.bitrate_upper = hi.bitrate_max

    return EncoderSetup(vi=vi, hi=hi, psy_params=psy_params, psy_global=g,
                        floor_full=floor_full,
                        block_lowpassr=block_lowpassr,
                        template_name=tpl.name)


def _psy_global_setup(tpl, hi):
    s = hi.trigger_setting
    x = tpl.global_mapping
    is_ = int(s)
    ds = s - is_
    g = tpl.global_params[int(x[is_])].copy()
    g["preecho_thresh"] = list(g["preecho_thresh"])
    g["postecho_thresh"] = list(g["postecho_thresh"])
    g["coupling_pointlimit"] = [list(r) for r in g["coupling_pointlimit"]]
    g["sliding_lowpass"] = [list(r) for r in g["sliding_lowpass"]]
    g["coupling_prepointamp"] = list(g["coupling_prepointamp"])
    g["coupling_postpointamp"] = list(g["coupling_postpointamp"])
    g["coupling_pkHz"] = list(g["coupling_pkHz"])
    ds = x[is_] * (1.0 - ds) + x[is_ + 1] * ds
    is_ = int(ds)
    ds -= is_
    if ds == 0 and is_ > 0:
        is_ -= 1
        ds = 1.0
    gp = tpl.global_params
    # preecho/postecho_thresh are C float fields: the double interp
    # rounds once on store (vorbisenc.c:249-252).
    for i in range(4):
        g["preecho_thresh"][i] = float(np.float32(
            gp[is_].preecho_thresh[i] * (1.0 - ds)
            + gp[is_ + 1].preecho_thresh[i] * ds))
        g["postecho_thresh"][i] = float(np.float32(
            gp[is_].postecho_thresh[i] * (1.0 - ds)
            + gp[is_ + 1].postecho_thresh[i] * ds))
    g["ampmax_att_per_sec"] = float(np.float32(hi.amplitude_track_dBpersec))
    return g


def _global_stereo(g, tpl, hi, vi, bs0, bs1):
    p = tpl.stereo_modes
    if p is not None:
        s = hi.base_setting  # stereo_point_setting
        is_ = int(s)
        ds = s - is_
        g["coupling_prepointamp"] = list(p[is_].pre)
        g["coupling_postpointamp"] = list(p[is_].post)
        if hi.managed:
            for i in range(PACKETBLOBS):
                kHz = p[is_].kHz[i] * (1.0 - ds) + p[is_ + 1].kHz[i] * ds
                kHz = np.float32(kHz)
                g["coupling_pointlimit"][0][i] = int(kHz * 1000.0 / vi.rate * bs0)
                g["coupling_pointlimit"][1][i] = int(kHz * 1000.0 / vi.rate * bs1)
                g["coupling_pkHz"][i] = int(kHz)
                kHz = np.float32(p[is_].lowpasskHz[i] * (1.0 - ds)
                                 + p[is_ + 1].lowpasskHz[i] * ds)
                g["sliding_lowpass"][0][i] = int(kHz * 1000.0 / vi.rate * bs0)
                g["sliding_lowpass"][1][i] = int(kHz * 1000.0 / vi.rate * bs1)
        else:
            kHz = np.float32(p[is_].kHz[PACKETBLOBS // 2] * (1.0 - ds)
                             + p[is_ + 1].kHz[PACKETBLOBS // 2] * ds)
            for i in range(PACKETBLOBS):
                g["coupling_pointlimit"][0][i] = int(kHz * 1000.0 / vi.rate * bs0)
                g["coupling_pointlimit"][1][i] = int(kHz * 1000.0 / vi.rate * bs1)
                g["coupling_pkHz"][i] = int(kHz)
            kHz = np.float32(p[is_].lowpasskHz[PACKETBLOBS // 2] * (1.0 - ds)
                             + p[is_ + 1].lowpasskHz[PACKETBLOBS // 2] * ds)
            for i in range(PACKETBLOBS):
                g["sliding_lowpass"][0][i] = int(kHz * 1000.0 / vi.rate * bs0)
                g["sliding_lowpass"][1][i] = int(kHz * 1000.0 / vi.rate * bs1)
    else:
        for i in range(PACKETBLOBS):
            g["sliding_lowpass"][0][i] = bs0
            g["sliding_lowpass"][1][i] = bs1


def _psy_params_setup(tpl, hi, singleblock):
    nblocks = 2 if singleblock else 4
    s = hi.base_setting
    is_ = int(s)
    params = []
    for block in range(nblocks):
        p = M.psy_info_template().copy()
        p["tone_masteratt"] = list(p["tone_masteratt"])
        p["toneatt"] = list(p["toneatt"])
        p["noiseoff"] = [list(r) for r in p["noiseoff"]]
        p["noisecompand"] = list(p["noisecompand"])
        p["noisecompand_high"] = list(p["noisecompand_high"])
        p["blockflag"] = block >> 1
        # psyset (noise normalization)
        if hi.noise_normalize_p:
            half = 0 if block < 2 else 1
            p["normal_p"] = 1
            p["normal_start"] = tpl.psy_noise_normal_start[half][is_]
            p["normal_partition"] = tpl.psy_noise_normal_partition[half][is_]
            p["normal_thresh"] = tpl.psy_noise_normal_thresh[is_]
        params.append(p)

    i0 = 0 if hi.impulse_block_p else 1

    def bs(block):
        return hi.block_settings[{0: i0, 1: 1, 2: 2, 3: 3}[block]]

    # tone masking
    adj = [tpl.psy_tone_adj_impulse, tpl.psy_tone_adj_other,
           tpl.psy_tone_adj_other, tpl.psy_tone_adj_long]
    for block in range(nblocks):
        sblk = bs(block)
        isb = int(sblk)
        dsb = sblk - isb
        att = tpl.psy_tone_masteratt
        p = params[block]
        for j in range(3):
            p["tone_masteratt"][j] = (att[isb].att[j] * (1.0 - dsb)
                                      + att[isb + 1].att[j] * dsb)
        p["tone_centerboost"] = (att[isb].boost * (1.0 - dsb)
                                 + att[isb + 1].boost * dsb)
        p["tone_decay"] = (att[isb].decay * (1.0 - dsb)
                           + att[isb + 1].decay * dsb)
        p["max_curve_dB"] = _interp(tpl.psy_tone_0dB, sblk)
        p["toneatt"] = [
            adj[block][isb].block[i] * (1.0 - dsb)
            + adj[block][isb + 1].block[i] * dsb for i in range(M.P_BANDS)]

    # noise companding (with aoTuV high-compander shadow)
    cmap = [tpl.psy_noise_compand_short_mapping,
            tpl.psy_noise_compand_short_mapping,
            tpl.psy_noise_compand_long_mapping,
            tpl.psy_noise_compand_long_mapping]
    for block in range(nblocks):
        sblk = bs(block)
        isb = int(sblk)
        dsb = sblk - isb
        p = params[block]
        hcm_stop = min(5, tpl.mappings)
        p["flacint"] = dsb
        x = cmap[block]
        dsx = x[isb] * (1.0 - dsb) + x[isb + 1] * dsb
        isx = int(dsx)
        dsx -= isx
        if dsx == 0 and isx > 0:
            isx -= 1
            dsx = 1.0
        ishcm = isx
        dshcm = dsx + 0.3
        if dshcm > 1.0:
            ishcm += 1
            dshcm -= 1
        if x[hcm_stop] < (ishcm + dshcm):
            ishcm = int(x[hcm_stop])
            dshcm = x[hcm_stop] - ishcm
            if (ishcm + dshcm) < (isx + dsx):
                ishcm = isx
                dshcm = dsx
        if dshcm == 0 and ishcm > 0:
            ishcm -= 1
            dshcm = 1.0
        cb = tpl.psy_noise_compand
        p["noisecompand"] = [cb[isx].data[i] * (1.0 - dsx)
                             + cb[isx + 1].data[i] * dsx
                             for i in range(M.NOISE_COMPAND_LEVELS)]
        p["noisecompand_high"] = [cb[ishcm].data[i] * (1.0 - dshcm)
                                  + cb[ishcm + 1].data[i] * dshcm
                                  for i in range(M.NOISE_COMPAND_LEVELS)]

    # peak limit
    for block in range(nblocks):
        params[block]["tone_abs_limit"] = _interp(tpl.psy_tone_dBsuppress,
                                                  bs(block))

    # noise bias
    bias = [tpl.psy_noise_bias_impulse, tpl.psy_noise_bias_padding,
            tpl.psy_noise_bias_trans, tpl.psy_noise_bias_long]
    for block in range(nblocks):
        sblk = bs(block)
        isb = int(sblk)
        dsb = sblk - isb
        p = params[block]
        p["noisemaxsupp"] = _interp(tpl.psy_noise_dBsuppress, sblk)
        guard = tpl.psy_noiseguards[block]
        p["noisewindowlomin"] = guard.lo
        p["noisewindowhimin"] = guard.hi
        p["noisewindowfixed"] = guard.fixed
        nb = bias[block]
        userbias = hi.impulse_noisetune if (block == 0 and i0 == 0) else 0.0
        # C (vorbisenc.c:444-456): noiseoff is a float field — the
        # interpolation rounds to f32 on store, min/userbias work on the
        # f32 values (min computed before bias is applied to [j][0]).
        for j in range(3):
            p["noiseoff"][j] = [
                float(np.float32(nb[isb].data[j][i] * (1.0 - dsb)
                                 + nb[isb + 1].data[j][i] * dsb))
                for i in range(M.P_BANDS)]
        for j in range(3):
            mn = float(np.float32(p["noiseoff"][j][0] + 6))
            for i in range(M.P_BANDS):
                v = float(np.float32(p["noiseoff"][j][i] + userbias))
                p["noiseoff"][j][i] = mn if v < mn else v
        # ath
        p["ath_adjatt"] = hi.ath_floating_dB
        p["ath_maxatt"] = hi.ath_absolute_dB

    # vorbis_info_psy fields are C floats (psy.h:37-68): every double
    # interpolation result above rounds once when stored in the struct.
    _F32_FIELDS = ("ath_adjatt", "ath_maxatt", "tone_centerboost",
                   "tone_decay", "tone_abs_limit", "noisemaxsupp",
                   "noisewindowlo", "noisewindowhi", "flacint",
                   "max_curve_dB")
    _F32_LISTS = ("tone_masteratt", "toneatt", "noisecompand",
                  "noisecompand_high")
    for p in params:
        for k in _F32_FIELDS:
            p[k] = float(np.float32(p[k]))
        for k in _F32_LISTS:
            p[k] = [float(np.float32(v)) for v in p[k]]
    return params


def _book_dup_or_new(books, book_names, name):
    for i, nm in enumerate(book_names):
        if nm == name:
            return i
    books.append(M.static_book(name))
    book_names.append(name)
    return len(books) - 1


def _residue_setup(vi, tpl, hi, books, book_names, residues, residue_types,
                   number, block, rt, floor_full, g, block_lowpassr, ch):
    r = rt.res.copy()
    r["secondstages"] = list(r["secondstages"])
    r["booklist"] = list(r["booklist"])
    r["grouping"] = rt.grouping
    residue_types[number] = rt.res_type

    base = rt.books_base_managed if hi.managed else rt.books_base
    aux = rt.book_aux_managed if hi.managed else rt.book_aux
    booklist = 0
    for i in range(r["partitions"]):
        for k in range(4):
            if base[i][k]:
                r["secondstages"][i] |= 1 << k
    r["groupbook"] = _book_dup_or_new(books, book_names, aux)
    for i in range(r["partitions"]):
        for k in range(4):
            if base[i][k]:
                bookid = _book_dup_or_new(books, book_names, base[i][k])
                r["booklist"][booklist] = bookid
                booklist += 1

    # lowpass / end
    freq = hi.lowpass_kHz * 1000.0
    f = floor_full[block]  # by convention
    nyq = vi.rate / 2.0
    blocksize = vi.blocksizes[block] >> 1
    if freq > nyq:
        freq = nyq
    f["n"] = int(freq / nyq * blocksize)

    if rt.limit_type == 1:
        freq = g["coupling_pkHz"][PACKETBLOBS - 1 if hi.managed
                                  else PACKETBLOBS // 2] * 1000.0
        if freq > nyq:
            freq = nyq
    elif rt.limit_type == 2:
        freq = LFE_FRQLIMIT

    if rt.res_type == 2:
        # count channels bundled by this residue
        chn = 0
        for m in vi.maps:
            if chn:
                break
            for j in range(m.submaps):
                if m.residuesubmap[j] == number and chn == 0:
                    chn = sum(1 for c in range(ch) if m.chmuxlist[c] == j)
        end = int((freq / nyq * blocksize * chn) / r["grouping"] + 0.9) \
            * r["grouping"]
        if end > blocksize * chn:
            end = blocksize * chn // r["grouping"] * r["grouping"]
        r["end"] = end
        if freq != LFE_FRQLIMIT:
            block_lowpassr[block] = end // chn
    else:
        end = int((freq / nyq * blocksize) / r["grouping"] + 0.9) \
            * r["grouping"]
        if end > blocksize:
            end = blocksize // r["grouping"] * r["grouping"]
        r["end"] = end
        if freq != LFE_FRQLIMIT:
            block_lowpassr[block] = end
    if r["end"] == 0:
        r["end"] = r["grouping"]

    nbook = sum(bin(x).count("1") for x in
                r["secondstages"][:r["partitions"]])
    info = H.ResidueInfo(
        rt.res_type, r["begin"], r["end"], r["grouping"], r["partitions"],
        r["groupbook"], r["secondstages"][:r["partitions"]],
        r["booklist"][:nbook])
    info.classmetric1 = r["classmetric1"]
    info.classmetric2 = r["classmetric2"]
    gb = books[r["groupbook"]]
    partvals = 1
    for _ in range(gb.dim):
        partvals *= r["partitions"]
    info.partvals = partvals
    residues[number] = info
