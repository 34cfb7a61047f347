"""LBG (Linde-Buzo-Gray) vector-quantizer training (reference:
vq/vqgen.c _vqgen_seed/vqgen_iterate), counterpart of
vorbis_tpu/vq/vqgen.py.

The reference iterates scalar nearest-entry scans with bias terms to
even out cell occupancy.  The batched formulation is classic LBG
splitting + batched k-means: the (points x entries) distance matrix is
one fp32 matmul (|a-b|^2 = |a|^2 - 2ab + |b|^2; TF32 off, the package
sets it); codebook growth doubles by perturbation, and the
highest-distortion cells are split preferentially when the target entry
count is not a power of two (this replaces vqgen.c's occupancy-bias
trick).

The step runs on a torch device: the distances, argmin, the cell counts
(`bincount`), the cell sums and per-cell distortion (`index_add_`, in
float64 and rounded once, so the card's atomics add in any order to the
same float32 but where a sum's error meets a rounding boundary) and the
empty-cell rule.  The JAX module's one-hot matmul for the sums was the
MXU's workaround for a scatter.  The host loop of `lbg_train` is the
JAX module's line for line; `use_torch=False` is its numpy step."""

from __future__ import annotations

import numpy as np
import torch


def _pairwise_sq(points, codes, xp):
    p2 = (points * points).sum(-1, keepdims=True)
    c2 = (codes * codes).sum(-1)
    return p2 - 2.0 * points @ codes.T + c2


def _make_step(device):
    if device is not None:
        device = torch.device(device)
        f64 = torch.float64

        def step(points, codes):
            d = _pairwise_sq(points, codes, torch)
            a = torch.argmin(d, dim=1)
            K = codes.shape[0]
            counts = torch.bincount(a, minlength=K).to(torch.float32)
            sums = torch.zeros((K, codes.shape[1]), dtype=f64,
                               device=device).index_add_(0, a,
                                                         points.to(f64))
            newc = torch.where(counts[:, None] > 0,
                               (sums / torch.clamp_min(counts[:, None], 1)
                                ).to(torch.float32), codes)
            own = torch.gather(d, 1, a[:, None])[:, 0]
            mse = own.to(f64).mean()
            # per-cell distortion for split selection
            dist = torch.zeros(K, dtype=f64, device=device).index_add_(
                0, a, own.to(f64))
            return newc, a, counts, dist, mse

        held = {}

        def run(points, codes):
            # the training set goes to the device once per array
            if held.get("src") is not points:
                held["src"] = points
                held["pts"] = torch.from_numpy(points).to(device)
            c, a, n, dist, m = step(held["pts"],
                                    torch.from_numpy(codes).to(device))
            return (c.cpu().numpy(), a.cpu().numpy(), n.cpu().numpy(),
                    dist.cpu().numpy(), float(m))

        return run

    def run(points, codes):
        d = _pairwise_sq(points, codes, np)
        a = np.argmin(d, axis=1)
        own = np.take_along_axis(d, a[:, None], 1)[:, 0]
        counts = np.bincount(a, minlength=len(codes)).astype(np.float32)
        sums = np.zeros_like(codes)
        np.add.at(sums, a, points)
        nz = counts > 0
        newc = codes.copy()
        newc[nz] = sums[nz] / counts[nz, None]
        dist = np.zeros(len(codes), np.float64)
        np.add.at(dist, a, own)
        return newc, a.astype(np.int64), counts, dist, float(own.mean())

    return run


def lbg_train(points: np.ndarray, entries: int, iters: int = 40,
              seed: int = 0, use_torch: bool = True, device=None,
              split_eps: float = 0.01, bias_strength: float = 0.0):
    """Train `entries` codewords on (N, dim) float32 points via LBG
    splitting.  Returns (codebook (entries, dim) float32,
    assignments (N,) int64, mse history list).  use_torch: the step on
    `device` (default "cuda": with no card that raises, and the CPU
    takes device="cpu"); False: the numpy step."""
    points = np.asarray(points, np.float32)
    n, dim = points.shape
    rng = np.random.RandomState(seed)
    if use_torch and device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lbg_train runs on the card by default and no CUDA "
                "device is available: pass device=\"cpu\" (or "
                "use_torch=False) to train on the CPU")
        device = "cuda"
    run = _make_step(device if use_torch else None)
    codes = points.mean(0, keepdims=True).astype(np.float32)
    history = []
    a = np.zeros(n, np.int64)

    def refine(codes, k):
        nonlocal a
        for _ in range(k):
            codes, a, counts, dist, mse = run(points, codes)
            history.append(mse)
            empty = np.nonzero(counts == 0)[0]
            if len(empty):
                worst = np.argsort(-((points - codes[a]) ** 2).sum(-1))
                codes[empty] = points[worst[:len(empty)]]
        return codes

    inner = max(3, iters // max(1, int(np.ceil(np.log2(entries))) + 1))
    while len(codes) < entries:
        grow = min(len(codes), entries - len(codes))
        # split the highest-distortion cells first
        _, a, counts, dist, _ = run(points, codes)
        order = np.argsort(-dist)[:grow]
        jitter = split_eps * points.std(0) * rng.randn(grow, dim)
        codes = np.concatenate(
            [codes, codes[order] + jitter.astype(np.float32)])
        codes = refine(codes, inner)
    codes = refine(codes, max(2, inner))
    # escape local minima: move the least-useful code into the
    # highest-distortion cell (split-and-merge), keep if it improves
    for _ in range(6):
        _, a, counts, dist, base_mse = run(points, codes)
        worst = int(np.argmax(dist))
        laziest = int(np.argmin(np.where(np.arange(len(codes)) == worst,
                                         np.inf, counts)))
        cand = codes.copy()
        members = points[a == worst]
        if len(members) < 2:
            break
        cand[laziest] = members[rng.randint(len(members))]
        cand[worst] = members.mean(0)
        cand = refine(cand, max(2, inner))
        _, _, _, _, new_mse = run(points, cand)
        if new_mse < base_mse:
            codes = cand
        else:
            break
    codes = refine(codes, 2)
    return codes.astype(np.float32), a, history
