"""The floor's post coding (vorbis_tpu_torch/ops/floor_encode_cuda.py,
csrc/floor_encode.cu) against the JAX package, both on the CPU.

`floor_encode` on CPU tensors is its plain version: the finish's
`_floor_wrap`, `render` and `_floor_fields`.  Its (curve, vals, lens)
must equal the JAX package's jitted `_floor_wrap` -> `render` ->
`_floor_fields` bit for bit (every stage is integer work, one exact f32
divide a bin and a table lookup), at the looks of FastEncoder(2, 44100,
0.5) long and short, FastEncoder(6, 48000, 0.4)'s coupled long and
short and its LFE (P = 2, n = 12), and FastEncoder(2, 16000, 0.5) long
and short, on posts the port's floor fit makes from real spectra and on
tests/floor_encode_cases.py's synthetic rows.  A numpy replay of the
kernel's walk reads the packed blob through its header and must equal
the plain version on the same rows, so a layout or offset fault shows
here, where no kernel runs.  The kernel itself needs a card:
tests/test_torch_cuda.py::test_floor_encode_kernel_on_cuda and
chip_smoke.py phase 3j hold it to the plain version there.
"""

import numpy as np
import pytest
import torch

import jax

from tests import oracle
from tests.floor_encode_cases import DIVISOR, synthetic
from vorbis_tpu.models.fastenc import FastEncoder as JFE
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops import encdevice as TE
from vorbis_tpu_torch.ops import floor_encode_cuda as FEC

# one torch thread a pytest-xdist worker (see test_torch_encode.py)
torch.set_num_threads(1)

# look -> (FastEncoder arguments, W, submap)
LOOKS = {"44k_long": ((2, 44100, 0.5), 1, 0),
         "44k_short": ((2, 44100, 0.5), 0, 0),
         "51_long": ((6, 48000, 0.4), 1, 0),
         "51_short": ((6, 48000, 0.4), 0, 0),
         "51_lfe": ((6, 48000, 0.4), 1, 1),
         "16k_long": ((2, 16000, 0.5), 1, 0),
         "16k_short": ((2, 16000, 0.5), 0, 0)}
FRAMES = 6
_ENCODERS = {}


def _encoders(args):
    if args not in _ENCODERS:
        _ENCODERS[args] = (JFE(*args), TFE(*args, device="cpu"))
    return _ENCODERS[args]


def _cfgs(d, sm):
    """(finish config, its floor fit) of submap `sm` of a
    DeviceFastEncode."""
    if d.multi:
        return d.groups[sm], d.groups[sm].floor
    return d, d.ctx.floor


def _real_rows(tfe, W, td, cfg, floor):
    """(posts, used) of the port's floor fit on FRAMES frames of the test
    signal, the config's channels and bins."""
    ctx = tfe.ctx(W)
    n, hop, ch = ctx.n, ctx.n // 2, tfe.ch
    pcm = oracle.make_test_signal(rate=tfe.rate, ch=ch,
                                  seconds=(FRAMES + 1) * hop / tfe.rate)
    x = torch.from_numpy(np.ascontiguousarray(pcm[:, :FRAMES * hop + hop]))
    flat = x.unfold(1, n, hop)[:, :FRAMES].transpose(0, 1) \
        .reshape(FRAMES * ch, n)
    _, logmdct, mask = ctx.analysis.full_mask(flat)
    chans = cfg.channels if td.multi else list(range(ch))
    fln = cfg.fl.n

    def rows(t):
        return t.reshape(FRAMES, ch, -1)[:, chans, :fln] \
            .reshape(-1, fln).contiguous()

    posts, used = floor(rows(logmdct), rows(mask))
    return posts.numpy(), used.numpy()


@pytest.fixture(scope="session", params=list(LOOKS))
def case(request):
    """One look: the port's config, the JAX package's jitted trio, and
    the rows (the floor fit's posts on real spectra, then the synthetic
    cases)."""
    args, W, sm = LOOKS[request.param]
    jfe, tfe = _encoders(args)
    jd, td = jfe._dev_for(W), tfe._dev_for(W)
    jcfg, jfloor = _cfgs(jd, sm)
    tcfg, tfloor = _cfgs(td, sm)
    fromdB = jd.ctx.fromdB
    jarg = jcfg if jd.multi else None

    @jax.jit
    def trio(posts, used):
        codes, qposts = jd._floor_wrap(posts, used, cfg=jarg)
        curve = jfloor.render(qposts, fromdB)
        vals, lens = jd._floor_fields(codes, used, cfg=jarg)
        return curve, vals, lens

    rp, ru = _real_rows(tfe, W, td, tcfg, tfloor)
    sp, su, _ = synthetic(tcfg, 7)
    posts = np.concatenate([rp, sp])
    used = np.concatenate([ru, su])
    return dict(name=request.param, td=td, cfg=tcfg, trio=trio,
                posts=posts, used=used, real=len(rp))


def _plain(case):
    return [t.numpy() for t in FEC.floor_encode(
        case["cfg"], torch.from_numpy(case["posts"]),
        torch.from_numpy(case["used"]))]


def test_floor_encode_equals_jax(case):
    curve, vals, lens = _plain(case)
    cj, vj, lj = (np.asarray(t) for t in case["trio"](case["posts"],
                                                      case["used"]))
    B = len(case["posts"])
    cfg = case["cfg"]
    assert curve.shape == (B, cfg.fl.n) and vals.shape == lens.shape \
        == (B, len(cfg.fl_bits) if case["td"].multi else cfg.fl_ncols)
    assert vals.dtype == np.int64 and lens.dtype == np.int32
    assert np.array_equal(curve.view(np.int32), cj.view(np.int32))
    assert np.array_equal(vals, vj.astype(np.int64))
    assert np.array_equal(lens, lj)
    # the real rows carry bits, and some are coded
    assert case["used"][:case["real"]].any() and lens.sum() > 0


def replay(blob, posts, used):
    """The kernel's walk in numpy, every table read from the blob through
    its header: (curve (B, n) float32, vals (B, FC) int64, lens (B, FC)
    int32)."""
    tab = blob.astype(np.int64)
    h = {k: int(tab[i]) for k, i in FEC.H.items()}
    P, n, mult, qq, qb, FC = (h[k] for k in ("P", "n", "mult", "quant_q",
                                             "qb", "fc"))
    assert h["words"] == len(blob)
    lo, hi = tab[h["lo"]:], tab[h["hi"]:]
    xl, fwd, sx = tab[h["postlist"]:], tab[h["fwd"]:], tab[h["sx"]:]
    iv = tab[h["iv"]:h["iv"] + n]
    fromdB = blob[h["fromdB"]:h["fromdB"] + 256]
    B = len(posts)
    curve = np.zeros((B, n), np.int32)
    vals = np.zeros((B, FC), np.int64)
    lens = np.zeros((B, FC), np.int32)
    t = np.arange(n)
    for r in range(B):
        p = posts[r].astype(np.int64)
        cols = ((p & 0x7FFF) // DIVISOR[mult]) | (p & 0x8000)
        codes = np.zeros(P, np.int64)
        codes[:2] = cols[:2] & 0x7FFF
        for i in range(2, P):
            ln, hn = lo[i - 2], hi[i - 2]
            y0 = cols[ln] & 0x7FFF
            dy = (cols[hn] & 0x7FFF) - y0
            off = abs(dy) * (xl[i] - xl[ln]) // (xl[hn] - xl[ln])
            pred = y0 - off if dy < 0 else y0 + off
            if cols[i] & 0x8000 or pred == cols[i]:
                cols[i] = pred | 0x8000
            else:
                head = min(qq - pred, pred)
                v = cols[i] - pred
                codes[i] = ((head - v - 1 if v < -head else -1 - 2 * v)
                            if v < 0 else
                            (v + head if v >= head else 2 * v))
                cols[ln] &= 0x7FFF
                cols[hn] &= 0x7FFF
        seg = np.zeros((P, 4), np.int64)
        for j in range(P):
            a, b = j, j + 1
            while a > 0 and cols[fwd[a]] & 0x8000:
                a -= 1
            while b < P and cols[fwd[b]] & 0x8000:
                b += 1
            ly = min(max((cols[fwd[a]] & 0x7FFF) * mult, 0), 255)
            seg[j] = (sx[a], ly, sx[a], 0) if b == P else (
                sx[a], ly, sx[b],
                min(max((cols[fwd[b]] & 0x7FFF) * mult, 0), 255))
        lx, ly, hx, hy = seg[iv].T
        on = (hx > lx) & (t >= lx)
        dy = hy - ly
        err = np.abs(dy) * (t - lx)
        q = ((err.astype(np.float32) + np.float32(0.5))
             / np.maximum(hx - lx, 1).astype(np.float32)).astype(np.int64)
        y = np.where(on, np.where(dy < 0, ly - q, ly + q), ly)
        curve[r] = fromdB[np.clip(y, 0, 255)]
        u = bool(used[r])
        vals[r, :3] = (int(u), codes[0], codes[1])
        lens[r, :3] = (1, qb if u else 0, qb if u else 0)
        for k in range(h["npart"]):
            rec = tab[h["parts"] + k * FEC.PART_WORDS:]
            cdim, csubbits, csub, col, j0 = (
                int(rec[FEC.R[f]]) for f in ("cdim", "csubbits", "csub",
                                             "col", "code"))

            def book_of(c):
                return next((l for l in range(csub)
                             if c < rec[FEC.SUBS + 3 * l]), 0)

            if csubbits:
                cval = sum(book_of(codes[j0 + d]) << (d * csubbits)
                           for d in range(cdim))
                at = rec[FEC.R["cb"]] + 2 * cval
                vals[r, col] = tab[at] & 0xFFFFFFFF
                lens[r, col] = tab[at + 1] if u else 0
                col += 1
            for d in range(cdim):
                c = codes[j0 + d]
                sub = rec[FEC.SUBS + 3 * book_of(c):]
                if sub[1] >= 0 and c < sub[2]:
                    at = sub[1] + 2 * max(c, 0)
                    vals[r, col + d] = tab[at] & 0xFFFFFFFF
                    lens[r, col + d] = tab[at + 1] if u else 0
    return curve.view(np.float32), vals, lens


def test_replay_of_the_blob_equals_plain(case):
    blob = case["cfg"].floor_enc.blob_np
    got = replay(blob, case["posts"], case["used"])
    for g, w in zip(got, _plain(case)):
        assert g.dtype == w.dtype and np.array_equal(
            g.view(np.int32) if g.dtype == np.float32 else g,
            w.view(np.int32) if w.dtype == np.float32 else w)


def test_wrapper_on_cpu_is_plain_and_other_devices_raise():
    _, tfe = _encoders((2, 44100, 0.5))
    td = tfe._dev_for(0)
    posts, used, _ = synthetic(td, 3)
    p, u = torch.from_numpy(posts), torch.from_numpy(used)
    before = FEC.floor_encode.launches
    got = FEC.floor_encode(td, p, u)
    want = FEC.floor_encode_plain(td, p, u)
    assert FEC.floor_encode.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="unsupported device"):
        FEC.floor_encode(td, p.to("meta"), u.to("meta"))


@pytest.mark.parametrize("args,calls", [((2, 44100, 0.5), 1),
                                        ((6, 48000, 0.4), 2)],
                         ids=["stereo", "5.1"])
def test_finish_calls_floor_encode_once_a_floor_config(args, calls,
                                                       monkeypatch):
    """finish_from_posts and _finish_multi reach the floor's post coding
    through one floor_encode call a floor config: one launch a finish
    call a floor look on the card."""
    _, tfe = _encoders(args)
    td = tfe._dev_for(1)
    seen = []

    def spy(cfg, posts, used):
        seen.append(cfg)
        return FEC.floor_encode(cfg, posts, used)

    monkeypatch.setattr(TE, "floor_encode", spy)
    F = 2
    flat = torch.from_numpy(np.ascontiguousarray(np.tile(
        oracle.make_test_signal(rate=tfe.rate, ch=1, seconds=0.2)[
            0, :td.n], (F * td.ch, 1))))
    pk, nb = td.encode_flat(flat, F, td.plan.wb)
    assert pk.shape[0] == F and (nb > 0).all()
    want = td.groups if td.multi else [td]
    assert len(seen) == calls and all(a is b for a, b in zip(seen, want))
