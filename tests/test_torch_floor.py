"""The port's floor1 fit and render (vorbis_tpu_torch/ops/floor_device.py,
ops/floor_cuda.py) against vorbis_tpu/ops/floor_device.py and the Pallas
kernel of vorbis_tpu/ops/floor_pallas.py, both on the CPU.

Tolerances and why:
  * moments: the bin -> segment sums are f32 matmuls whose summation
    order differs between XLA and torch; measured 2.7e-7 relative, 4 ulp
    relative asserted; the above counts are integers and exact.
  * greedy fit, given the SAME quant/above/prefix: XLA:CPU contracts
    fit_line's products-differences (yb*x2b - xyb*xb and the like) into
    FMAs inside the Pallas kernel (interpret mode), torch and the CUDA
    kernel (built with -fmad=false) round each product.  With the
    contraction emulated the plain fit equals the Pallas kernel bit for
    bit; as written, 13 of 1856 random posts (0.7%) move by one quantum
    at near-ties.  Asserted: emulated bitwise, as written <= 1% and
    <= 1 quantum.
  * against DeviceFloorFit end to end, JAX computes quant as
    int(mask * 7.3142857 + 1023.5), which XLA:CPU contracts into an FMA
    while torch rounds the product first; where that moves a quantum the
    fit may move a post.  The count is printed and bounded: at most 1% of
    posts, none by more than one quantum.
  * quantize_posts / render: integer math and an exact f32 divide ->
    bitwise.
The kernel itself (csrc/floor_fit.cu) needs a CUDA device: its test is
in test_torch_cuda.py, which imports no JAX (the GPU machine has none);
chip_smoke.py holds it to the plain version on every run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vorbis_tpu.codec.encoder as E
from tests import oracle
from vorbis_tpu.codec import floor1_codec as FC
from vorbis_tpu.models import encsetup
from vorbis_tpu.ops.floor_device import DeviceFloorFit as JFit
from vorbis_tpu.ops.floor_pallas import DeviceFloorFitPallas
from vorbis_tpu_torch.ops.floor_cuda import (DeviceFloorFitCuda,
                                              make_floor_fit)
from vorbis_tpu_torch.ops.floor_device import DeviceFloorFit as TFit

# The suite runs under pytest-xdist with several workers to the host's
# cores; one torch thread a worker keeps torch's OpenMP pools from
# oversubscribing them (the port's test files took 672 s with 6 workers
# on 8 cores at torch's default, 70 s at one thread).
torch.set_num_threads(1)

EPS = np.finfo(np.float32).eps


@pytest.fixture(scope="module")
def look():
    """The long-block floor of FastEncoder(2, 44100, 0.5)."""
    setup = encsetup.setup_vbr_staged(2, 44100, 0.5).init()
    enc = E.Encoder(setup)
    vi = setup.vi
    mode = next(m for m in vi.modes if m.blockflag == 1)
    mapping = vi.maps[mode.mapping]
    return enc.floor_looks[mapping.floorsubmap[mapping.chmuxlist[0]]]


@pytest.fixture(scope="module")
def captures():
    """(look, logmdct, logmask, exact posts) from the golden encoder, as
    tests/test_floor_device.py captures them."""
    caps = []
    real = FC.floor1_fit

    def hook(fl_look, logmdct, logmask):
        r = real(fl_look, logmdct, logmask)
        caps.append((fl_look, np.array(logmdct, np.float32),
                     np.array(logmask, np.float32),
                     None if r is None else np.array(r)))
        return r

    old = E.floor1_fit
    E.floor1_fit = hook
    try:
        pcm = oracle.make_test_signal(seconds=0.4)
        enc = E.Encoder(encsetup.setup_vbr(2, 44100, 0.4))
        enc.write(pcm)
        enc.end_of_stream()
        enc.pump()
    finally:
        E.floor1_fit = old
    groups = {}
    for c in caps:
        groups.setdefault(id(c[0]), []).append(c)
    return list(groups.values())


def _random(look, B, seed):
    rng = np.random.RandomState(seed)
    lm = (rng.randn(B, look.n) * 20 - 60).astype(np.float32)
    mk = (lm + rng.randn(B, look.n) * 6 - 3).astype(np.float32)
    return lm, mk


def _pallas_posts(look, quant, above, prefix):
    """The Pallas kernel (interpret mode) on the given fit inputs, run as
    tests/test_floor_device.py runs it."""
    pal = DeviceFloorFitPallas(look, block_frames=8, interpret=True)
    B, P = prefix.shape[0], look.posts
    pp = np.transpose(prefix, (0, 2, 1))
    pp = np.pad(pp, ((0, 0), (0, 0), (0, pal._P2 - P))).reshape(B, -1)
    out = pal._call_for(B)(jnp.asarray(pal._tabs), jnp.asarray(pal._vtabs),
                           jnp.asarray(quant),
                           jnp.asarray(above.astype(np.int32)),
                           jnp.asarray(pp))
    return np.asarray(out)[:, :P]


def test_moments_close(look):
    tf = TFit(look, "cpu")
    lm, mk = _random(look, 16, 3)
    quant, above, prefix, used = tf.prepare(torch.from_numpy(lm),
                                            torch.from_numpy(mk))
    pj, anj = map(np.asarray, jax.jit(JFit(look)._moments)(
        quant.numpy(), above.numpy()))
    pt, ant = tf._moments(quant, above)
    pt = pt.numpy()
    assert np.array_equal(ant.numpy(), anj)
    assert np.all(np.abs(pt - pj) <= 4 * EPS * np.abs(pj))


class _FmaFit(TFit):
    """The plain fit with fit_line's three products-difference terms
    rounded as XLA:CPU rounds them: fma(p, q, -(r * s)), emulated in
    float64 (p * q is exact there)."""

    def _fit_line(self, prefix, s0, s1, x0, x1):
        bidx = torch.arange(prefix.shape[0])
        m = prefix[bidx, s1] - prefix[bidx, s0]
        xb, yb, x2b, y2b, xyb, bn = m.unbind(-1)

        def fms(p, q, r, s):
            return (p.double() * q.double() - (r * s).double()).float()
        denom = fms(bn, x2b, xb, xb)
        bad = denom <= 0.0
        d = torch.where(bad, 1.0, denom)
        a = fms(yb, x2b, xyb, xb) / d
        b = fms(bn, xyb, xb, yb) / d
        y0 = torch.clamp(torch.round(a + b * x0), 0, 1023).to(torch.int32)
        y1 = torch.clamp(torch.round(a + b * x1), 0, 1023).to(torch.int32)
        return torch.where(bad, 0, y0), torch.where(bad, 0, y1), bad


@pytest.mark.parametrize("source", ["random", "captured"])
def test_greedy_fit_vs_pallas_same_inputs(look, captures, source):
    """Given the same quant/above/prefix, the plain fit runs the Pallas
    kernel's algorithm: with XLA:CPU's FMA contraction of fit_line
    emulated it is bitwise equal; as written (two roundings, as torch
    and the CUDA kernel round) it differs on a few near-tie posts, by
    one quantum."""
    if source == "random":
        lm, mk = _random(look, 64, 7)
    else:
        items = [c for g in captures for c in g if c[0].n == look.n]
        lm = np.stack([c[1] for c in items])[:64]
        mk = np.stack([c[2] for c in items])[:64]
        lm, mk = lm[:len(lm) // 8 * 8], mk[:len(mk) // 8 * 8]
    tf = TFit(look, "cpu")
    quant, above, prefix, used = tf.prepare(torch.from_numpy(lm),
                                            torch.from_numpy(mk))
    want = _pallas_posts(look, quant.numpy(), above.numpy(),
                         prefix.numpy())
    fma = _FmaFit(look, "cpu").fit(quant, above, prefix).numpy()
    assert np.array_equal(fma, want)
    got = tf.fit(quant, above, prefix).numpy()
    assert got.shape == want.shape == (len(lm), look.posts)
    differ = int((got != want).sum())
    print(f"{source}: plain vs Pallas (FMA-contracted fit_line) differ "
          f"on {differ}/{got.size} posts")
    assert np.abs((got & 0x7FFF) - (want & 0x7FFF)).max() <= 1
    assert differ <= 0.01 * got.size


def test_fit_matches_jax_and_exact_on_captures(captures):
    """Port vs JAX DeviceFloorFit end to end (bounded FMA-quant effect,
    see the module docstring) and vs the exact scalar fit (>= 75% of
    frames exact, every deviation <= 1 quantum, as
    tests/test_floor_device.py holds JAX)."""
    posts_total = differ = 0
    total = agree = 0
    for items in captures:
        lk = items[0][0]
        lm = np.stack([i[1] for i in items])
        mk = np.stack([i[2] for i in items])
        pj, uj = map(np.asarray, jax.jit(JFit(lk))(lm, mk))
        pt, ut = TFit(lk, "cpu")(torch.from_numpy(lm),
                                 torch.from_numpy(mk))
        pt, ut = pt.numpy(), ut.numpy()
        assert np.array_equal(ut, uj)
        d = np.abs((pt & 0x7FFF) - (pj & 0x7FFF))
        assert d.max() <= 1
        differ += int((pt != pj).sum())
        posts_total += pt.size
        for k, (_, _, _, r) in enumerate(items):
            total += 1
            if r is None:
                agree += not ut[k]
                continue
            same = np.array_equal(pt[k][:len(r)], r)
            if not same:
                dd = np.abs((pt[k][:len(r)] & 0x7FFF) - (r & 0x7FFF))
                assert dd.max() <= 1, dd.max()
            agree += same
    print(f"posts differing from JAX (FMA-contracted quant): "
          f"{differ}/{posts_total}; exact-fit frames {agree}/{total}")
    assert differ <= 0.01 * posts_total
    assert agree / total >= 0.75


def test_quantize_and_render_bitwise(captures):
    table = FC.fromdB_lookup()
    checked = 0
    for items in captures:
        lk = items[0][0]
        posts = np.stack([i[3] for i in items if i[3] is not None]
                         ).astype(np.int32)
        if not len(posts):
            continue
        jf, tf = JFit(lk), TFit(lk, "cpu")
        qj = np.asarray(jax.jit(jf.quantize_posts)(posts))
        qt = tf.quantize_posts(torch.from_numpy(posts)).numpy()
        assert np.array_equal(qt, qj)
        cj = np.asarray(jax.jit(lambda q: jf.render(
            q, jnp.asarray(table)))(qj))
        ct = tf.render(torch.from_numpy(np.array(qj)),
                       torch.from_numpy(table.astype(np.float32))).numpy()
        assert np.array_equal(ct, cj)
        checked += len(posts)
    assert checked > 10


def test_kernel_wrapper_on_cpu_tensors_is_the_plain_version(look):
    assert type(make_floor_fit(look, "cpu")) is TFit
    kf = DeviceFloorFitCuda(look, "cpu")
    lm, mk = _random(look, 8, 11)
    pk, uk = kf(torch.from_numpy(lm), torch.from_numpy(mk))
    pp, up = TFit(look, "cpu")(torch.from_numpy(lm), torch.from_numpy(mk))
    assert torch.equal(pk, pp) and torch.equal(uk, up)
    assert kf.launches == 0


def test_floor_tables_bitwise(look):
    jf, tf = JFit(look), TFit(look, "cpu")
    pal = DeviceFloorFitPallas(look, block_frames=8, interpret=True)
    P = look.posts
    assert np.array_equal(tf.seg_mat.numpy(), jf._seg_mat_np())
    assert np.array_equal(tf.rev_t.numpy(), jf.reverse_index)
    assert np.array_equal(tf.postlist_t.numpy(), jf.postlist)
    assert np.array_equal(tf.sx_t.numpy(), jf.sorted_x)
    assert np.array_equal(tf.xg.numpy(), np.asarray(jf.xg))
    kf = DeviceFloorFitCuda(look, "cpu")
    assert np.array_equal(kf.kernel_tabs.numpy(), pal._tabs[:, :P])
