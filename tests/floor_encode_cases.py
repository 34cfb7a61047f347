"""Seeded synthetic inputs of the floor's post coding
(vorbis_tpu_torch/ops/floor_encode_cuda.py), shared by
tests/test_torch_floor_encode.py (the port against the JAX package on the
CPU), tests/test_torch_cuda.py and chip_smoke.py phase 3j (the kernel
against its plain version on the card).  It imports no JAX.

`synthetic(cfg, seed)` gives raw fit posts (B, P) int32 and used (B,)
bool for one finish config (a DeviceFastEncode or a submap's namespace):
random posts, every post flagged, none, alternating flags, posts at 0
and at the top of the range (quant_q - 1 after the multiplier), rows
whose wrap codes sit on each sub-book's maxval and entries edges and at
quant_q - 1, and rows with used false.  `dense_config(seed, device)`
is a config on a dense floor1 look (65 posts over n = 128).
`phase5_fit`, `fit_moments` and `running_sum32` rebuild the floor fit's
inputs and prefix moments on chip_smoke.py phase 5's clip, for the tests
that hold the prefix sums to one float64 sum rounded once, on the CPU
and on the card (a float32 running sum moves posts).
"""

import numpy as np

# floor1_encode's divisor of each multiplier (1: >> 2, 2: >> 3, 3: / 12,
# 4: >> 4)
DIVISOR = {1: 4, 2: 8, 3: 12, 4: 16}


def wrap_code(v, pred, qq):
    """floor1_encode's code of the difference v = post - predicted."""
    head = min(qq - pred, pred)
    return np.where(v < 0, np.where(v < -head, head - v - 1, -1 - 2 * v),
                    np.where(v >= head, v + head, 2 * v))


def posts_for_codes(cfg, first, targets):
    """Raw posts (B, P) int32, without flags, whose wrap codes posts 2..P-1
    as `targets` (B, P - 2) (a target of 0 leaves the post on its
    prediction, flagged by the wrap); `first` (B, 2) the two first posts'
    values after the multiplier."""
    P, qq = cfg.P, cfg.quant_q
    xl = np.asarray(cfg.postlist, np.int64)
    vals = np.arange(qq)
    cols = np.zeros((len(targets), P), np.int64)
    cols[:, :2] = first
    for b, row in enumerate(targets):
        c = cols[b]
        for i in range(2, P):
            ln, hn = int(cfg.lo_static[i - 2]), int(cfg.hi_static[i - 2])
            dy = c[hn] - c[ln]
            off = abs(dy) * (xl[i] - xl[ln]) // (xl[hn] - xl[ln])
            pred = c[ln] - off if dy < 0 else c[ln] + off
            hit = np.flatnonzero(wrap_code(vals - pred, pred, qq)
                                 == row[i - 2])
            assert len(hit) == 1, (pred, row[i - 2])
            c[i] = hit[0]
    return (cols * DIVISOR[cfg.mult]).astype(np.int32)


def edge_codes(cfg):
    """Every code on a sub-book's maxval or entries edge (each edge and
    one below it), and quant_q - 1, within [0, quant_q)."""
    edges = {cfg.quant_q - 1}
    for p in cfg.fl_parts:
        for mv, bk in zip(p["maxval"], p["subbooks"]):
            for e in (int(mv), None if bk is None else bk.entries):
                if e is not None:
                    edges |= {e - 1, e}
    return sorted(e for e in edges if 0 <= e < cfg.quant_q)


def synthetic(cfg, seed):
    """(posts (B, P) int32, used (B,) bool, names [B]): the synthetic
    cases of one finish config."""
    rng = np.random.RandomState(seed)
    P, qq = cfg.P, cfg.quant_q
    top = (qq - 1) * DIVISOR[cfg.mult]       # <= 1023, the fit's range
    rows, names = [], []

    def add(name, r):
        rows.append(np.asarray(r, np.int64))
        names.append(name)

    for k in range(4):
        add(f"random {k}", rng.randint(0, 1024, P))
    for k in range(2):
        add(f"all flagged {k}", rng.randint(0, 1024, P) | 0x8000)
    alt = np.arange(P) % 2 == 1
    for k in range(2):
        r = rng.randint(0, 1024, P)
        add(f"flags on odd posts {k}", np.where(alt, r | 0x8000, r))
        add(f"flags on even posts {k}", np.where(~alt, r | 0x8000, r))
    add("all 0", np.zeros(P))
    add("all at the top", np.full(P, top))
    add("0 and the top in turns", np.where(alt, top, 0))
    add("the top, flagged", np.full(P, top | 0x8000))
    if P > 2:
        edges = edge_codes(cfg)
        first = rng.randint(0, qq, (len(edges) + 4, 2))
        targets = [np.full(P - 2, e) for e in edges]
        targets += [rng.choice(edges, P - 2) for _ in range(4)]
        for k, r in enumerate(posts_for_codes(cfg, first,
                                              np.array(targets))):
            add(f"codes at {edges[k]}" if k < len(edges)
                else f"mixed edge codes {k - len(edges)}", r)
    posts = np.stack(rows).astype(np.int32)
    used = np.ones(len(posts), bool)
    used[2::3] = False
    return posts, used, names


def dense_config(seed, device):
    """A config of the floor's post coding on a dense floor1 look: 65
    posts over n = 128, so used posts lie one bin apart, no partitions
    (FC = 3); its plain version is the floor fit's quantize_posts and
    render (floor_encode_cuda.curve_encoder, as the roundtrip
    pipeline's)."""
    import torch
    from vorbis_tpu_torch.codec.floor1_codec import Floor1Look, fromdB_lookup
    from vorbis_tpu_torch.codec.headers import Floor1Info
    from vorbis_tpu_torch.ops.floor_device import DeviceFloorFit
    from vorbis_tpu_torch.ops.floor_encode_cuda import curve_encoder
    rng = np.random.RandomState(seed)
    xs = [0, 128] + [int(x) for x in rng.choice(np.arange(1, 128), 63,
                                                replace=False)]
    look = Floor1Look(Floor1Info(
        partitions=0, partitionclass=[], class_dim=[], class_subs=[],
        class_book=[], class_subbook=[], mult=2, rangebits=7, postlist=xs))
    fromdB = torch.tensor(np.asarray(fromdB_lookup(), np.float32),
                          device=device)
    return curve_encoder(DeviceFloorFit(look, device), fromdB)


def phase5_fit(fe, pcm16):
    """The floor fit's inputs on chip_smoke.py phase 5's clip: the first
    2 s of `pcm16` (_signal(60, 44100, 0)) after a hop of silence, framed
    as the stateless step frames it, through `fe`'s analysis (fe a
    FastEncoder(2, 44100, 0.5, switching=False, psy_state=False)):
    (logmdct, mask) (F * 2, n / 2), packet f's rows 2 f and 2 f + 1."""
    import torch
    hop, n = fe.n // 2, fe.n
    F = (2 * 44100 + 3 * hop - n) // hop + 1
    clip = np.zeros((2, F * hop + hop), np.int16)
    clip[:, hop:hop + 2 * 44100] = pcm16[:, :2 * 44100]
    x = torch.from_numpy(clip).to(fe.device).float() / 32768.0
    frames = clip.shape[1] // hop - 1
    flat = x.unfold(1, n, hop)[:, :frames].transpose(0, 1) \
        .reshape(frames * 2, n)
    _, logmdct, mask = fe.dev.ctx.analysis.full_mask(flat)
    return logmdct, mask


def fit_moments(fit, logmdct, mask):
    """fit.prepare(logmdct, mask)'s (quant, above, prefix) and the moments
    its prefix sums (ops/floor_device.py _moments: the input of its
    torch.cumsum, (B, S, 6), the float32 moments widened to float64 and
    returned as float32, exactly)."""
    import torch
    seen = []
    cumsum = torch.cumsum

    def spy(x, *a, **kw):
        seen.append(x)
        return cumsum(x, *a, **kw)

    torch.cumsum = spy
    try:
        quant, above, prefix, _ = fit.prepare(logmdct, mask)
    finally:
        torch.cumsum = cumsum
    return quant, above, prefix, seen[-1].float()


def running_sum32(moments):
    """The float32 running sum of the moments over segments, in order,
    one float32 add a step, with the leading zero row of the fit's
    prefix."""
    import torch
    run = moments.clone()
    for k in range(1, run.shape[-2]):
        run[:, k] = run[:, k - 1] + moments[:, k]
    return torch.cat([torch.zeros_like(run[:, :1]), run], -2)
