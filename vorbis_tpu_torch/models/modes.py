"""Typed access to the transcribed static mode tables.

The raw tables (vorbis_tpu/data/modes.json.gz, books.npz) are
positional C initializers; this module maps them onto named structures
per the reference struct layouts (lib/psy.h, lib/backends.h,
lib/vorbisenc.c ve_setup_data_template) with C zero-fill semantics for
partial initializers.

Copy of vorbis_tpu/models/modes.py; it reads the port's byte copies of
the tables in vorbis_tpu_torch/data/.
"""

from __future__ import annotations

import gzip
import json
import os
from functools import lru_cache

import numpy as np

from ..codec.codebook import StaticCodebook

_DATA = os.path.join(os.path.dirname(__file__), "..", "data")

P_BANDS = 17
P_NOISECURVES = 3
NOISE_COMPAND_LEVELS = 40
PACKETBLOBS = 15
VE_BANDS = 12
VIF_POSIT = 63


@lru_cache(maxsize=1)
def _raw():
    with gzip.open(os.path.join(_DATA, "modes.json.gz"), "rt") as f:
        return json.load(f)


@lru_cache(maxsize=1)
def _books_raw():
    data = np.load(os.path.join(_DATA, "books.npz"))
    with gzip.open(os.path.join(_DATA, "books_meta.json.gz"), "rt") as f:
        meta = json.load(f)
    return data, meta


@lru_cache(maxsize=None)
def static_book(name: str) -> StaticCodebook:
    data, meta = _books_raw()
    dim, entries, maptype, q_min, q_delta, q_quant, q_seq = meta[name]
    ll = data[f"{name}.ll"].astype(np.int32)
    ql = data.get(f"{name}.ql")
    return StaticCodebook(dim, entries, ll, maptype, q_min, q_delta,
                          q_quant, q_seq,
                          ql.astype(np.int64) if ql is not None else None)


def _deref(v):
    """Resolve a {"&": name} reference into the raw table value.
    NULL/0 fields (single-block templates) resolve to None."""
    if isinstance(v, dict) and "&" in v:
        return _raw()[v["&"]]["value"]
    if v == 0 or v is None:
        return None
    return v


def _refname(v):
    return v["&"] if isinstance(v, dict) and "&" in v else None


def _arr(v, n, fill=0):
    """C zero-filled fixed array from a (possibly partial) initializer."""
    v = v if isinstance(v, list) else [v]
    out = [fill] * n
    for i, x in enumerate(v[:n]):
        out[i] = x if x is not None else fill
    return out


def _arr2(v, n0, n1):
    v = v if isinstance(v, list) else [[v]]
    rows = [_arr(v[i] if i < len(v) else [], n1) for i in range(n0)]
    return rows


class Struct(dict):
    __getattr__ = dict.__getitem__

    def copy(self):
        return Struct(dict.copy(self))


def s_att3(v):
    return Struct(att=_arr(v[0], 3), boost=v[1], decay=v[2])


def s_adjblock(v):
    return Struct(block=_arr(v[0], P_BANDS))


def s_noise3(v):
    return Struct(data=_arr2(v[0], 3, P_BANDS))


def s_noiseguard(v):
    return Struct(lo=v[0], hi=v[1], fixed=v[2])


def s_compand(v):
    return Struct(data=_arr(v[0], NOISE_COMPAND_LEVELS))


def s_psy_global(v):
    return Struct(
        eighth_octave_lines=v[0],
        preecho_thresh=_arr(v[1], VE_BANDS),
        postecho_thresh=_arr(v[2], VE_BANDS),
        stretch_penalty=v[3],
        preecho_minenergy=v[4],
        ampmax_att_per_sec=v[5],
        coupling_pkHz=_arr(v[6], PACKETBLOBS),
        coupling_pointlimit=_arr2(v[7], 2, PACKETBLOBS),
        coupling_prepointamp=_arr(v[8], PACKETBLOBS),
        coupling_postpointamp=_arr(v[9], PACKETBLOBS),
        sliding_lowpass=_arr2(v[10], 2, PACKETBLOBS),
    )


def s_adj_stereo(v):
    return Struct(pre=_arr(v[0], PACKETBLOBS), post=_arr(v[1], PACKETBLOBS),
                  kHz=_arr(v[2], PACKETBLOBS),
                  lowpasskHz=_arr(v[3], PACKETBLOBS))


def s_floor1(v):
    return Struct(
        partitions=v[0],
        partitionclass=_arr(v[1], 31),
        class_dim=_arr(v[2], 16),
        class_subs=_arr(v[3], 16),
        class_book=_arr(v[4], 16),
        class_subbook=_arr2(v[5], 16, 8),
        mult=v[6],
        postlist=_arr(v[7], VIF_POSIT + 2),
        maxover=v[8], maxunder=v[9], maxerr=v[10],
        twofitweight=v[11], twofitatten=v[12],
        n=v[13] if len(v) > 13 else 0,
    )


def s_residue0(v):
    return Struct(
        begin=v[0], end=v[1], grouping=v[2], partitions=v[3],
        partvals=v[4], groupbook=v[5],
        secondstages=_arr(v[6], 64), booklist=_arr(v[7], 512),
        classmetric1=_arr(v[8], 64), classmetric2=_arr(v[9], 64),
    )


def s_mapping0(v):
    return Struct(
        submaps=v[0], chmuxlist=_arr(v[1], 256),
        floorsubmap=_arr(v[2], 16), residuesubmap=_arr(v[3], 16),
        coupling_steps=v[4], coupling_mag=_arr(v[5], 256),
        coupling_ang=_arr(v[6], 256),
    )


def s_psy_info(v):
    return Struct(
        blockflag=v[0], ath_adjatt=v[1], ath_maxatt=v[2],
        tone_masteratt=_arr(v[3], 3), tone_centerboost=v[4],
        tone_decay=v[5], tone_abs_limit=v[6], toneatt=_arr(v[7], P_BANDS),
        noisemaskp=v[8], noisemaxsupp=v[9], noisewindowlo=v[10],
        noisewindowhi=v[11], noisewindowlomin=v[12],
        noisewindowhimin=v[13], noisewindowfixed=v[14],
        noiseoff=_arr2(v[15], 3, P_BANDS),
        noisecompand=_arr(v[16], NOISE_COMPAND_LEVELS),
        noisecompand_high=_arr(v[17], NOISE_COMPAND_LEVELS),
        flacint=v[18], max_curve_dB=v[19],
        normal_p=v[20], normal_start=v[21], normal_partition=v[22],
        normal_thresh=v[23],
    )


def s_res_template(v):
    return Struct(
        res_type=v[0], limit_type=v[1], grouping=v[2],
        res=s_residue0(_deref(v[3])),
        book_aux=_refname(v[4]),
        book_aux_managed=_refname(v[5]),
        books_base=_bookblock(_deref(v[6])),
        books_base_managed=_bookblock(_deref(v[7])),
    )


def _bookblock(v):
    # static_bookblock { books[12][4] of codebook refs }
    rows = []
    grid = v[0] if isinstance(v[0], list) else v
    for i in range(12):
        row = []
        src = grid[i] if i < len(grid) else []
        if not isinstance(src, list):
            src = [src]
        for k in range(4):
            cell = src[k] if k < len(src) else 0
            row.append(_refname(cell))
        rows.append(row)
    return rows


@lru_cache(maxsize=None)
def mapping_templates(name: str):
    """List of (mapping0, [res_template x submaps...]) per quality rung."""
    raw = _raw()[name]["value"]
    out = []
    for entry in raw:
        map_ref = entry[0]["&"]
        res_ref = entry[1]["&"]
        mapv = _raw()[map_ref]["value"]
        maps = [s_mapping0(m) for m in mapv]
        resv = _raw()[res_ref]["value"]
        res = [s_res_template(r) for r in resv]
        out.append((maps, res))
    return out


def _maybe(fn, v):
    return [fn(x) for x in v] if v is not None else None


@lru_cache(maxsize=None)
def setup_template(name: str):
    """A ve_setup_data_template by name, fields resolved."""
    v = _raw()[name]["value"]
    g = lambda i: _deref(v[i])
    tpl = Struct(
        name=name,
        mappings=v[0],
        rate_mapping=g(1), quality_mapping=g(2), pre_amp=g(3),
        coupling_restriction=v[4],
        samplerate_min_restriction=v[5], samplerate_max_restriction=v[6],
        blocksize_short=g(7), blocksize_long=g(8),
        psy_tone_masteratt=_maybe(s_att3, g(9)),
        psy_tone_0dB=g(10), psy_tone_dBsuppress=g(11),
        psy_tone_adj_impulse=_maybe(s_adjblock, g(12)),
        psy_tone_adj_long=_maybe(s_adjblock, g(13)),
        psy_tone_adj_other=_maybe(s_adjblock, g(14)),
        psy_noiseguards=_maybe(s_noiseguard, g(15)),
        psy_noise_bias_impulse=_maybe(s_noise3, g(16)),
        psy_noise_bias_padding=_maybe(s_noise3, g(17)),
        psy_noise_bias_trans=_maybe(s_noise3, g(18)),
        psy_noise_bias_long=_maybe(s_noise3, g(19)),
        psy_noise_dBsuppress=g(20),
        psy_noise_compand=_maybe(s_compand, g(21)),
        psy_noise_compand_short_mapping=g(22),
        psy_noise_compand_long_mapping=g(23),
        psy_noise_normal_start=[_deref(x) for x in v[24]],
        psy_noise_normal_partition=[_deref(x) for x in v[25]],
        psy_noise_normal_thresh=g(26),
        psy_ath_float=g(27), psy_ath_abs=g(28),
        psy_lowpass=g(29),
        global_params=_maybe(s_psy_global, g(30)),
        global_mapping=g(31),
        stereo_modes=([s_adj_stereo(x) for x in g(32)]
                      if _refname(v[32]) else None),
        floor_books=_refname(v[33]),
        floor_params=_maybe(s_floor1, g(34)),
        floor_mappings=v[35],
        floor_mapping_list=[_deref(x) for x in _deref(v[36])],
        maps=_refname(v[37]),
    )
    return tpl


@lru_cache(maxsize=1)
def setup_list():
    raw = _raw()["setup_list"]["value"]
    return [r["&"] for r in raw if isinstance(r, dict)]


@lru_cache(maxsize=1)
def psy_info_template():
    return s_psy_info(_raw()["_psy_info_template"]["value"])


@lru_cache(maxsize=1)
def mode_template():
    return _raw()["_mode_template"]["value"]  # [[0,0,0,0],[1,0,0,1]]


@lru_cache(maxsize=None)
def floor_books_table(name: str):
    """floor_books is an array of per-floor book-pointer arrays."""
    v = _raw()[name]["value"]
    out = []
    for row in v:
        if isinstance(row, dict):
            row = _raw()[row["&"]]["value"]
        out.append([_refname(x) for x in (row if isinstance(row, list)
                                          else [row])])
    return out
