"""The packet packer (vorbis_tpu_torch/ops/pack_cuda.py: `pack_packets`,
csrc/pack_bits.cu) on the CPU.

`pack_packets_plain` (merge_columns, then pack_bits) is held bitwise to
the JAX package's jitted `merge_columns` + `pack_bits_device` on every
look's real plan (FastEncoder(2, 44100, 0.5), FastEncoder(6, 48000,
0.4), 16 and 32 kHz, long and short) at the plan's budget and at
`worst_bytes`, on chip_smoke.py's `_pack_rows` (seeded rows, stale
values in zero-length columns, packets longer than the budget, zero
rows), the rows the card test and chip phase 3m check too; its row of
values with bits above their lengths is held to the kernel's replay
only (the JAX packer adds such bits into its byte planes).  A numpy
replay of the kernel's schedule (a thread a group in rounds of a block,
the merge in 64-bit registers, the block's scan of the merged lengths
by warp shuffles and warp totals, each field ORed into at most two
32-bit words, words past the budget dropped) is held bitwise to the
plain version at two block sizes, and to a real finish call's packets.
The wrapper takes the plain version on CPU tensors, and `PackTables`'
column lists are the plan's groups without their pads.  Tolerance:
bitwise everywhere (integer work).
"""

import numpy as np
import pytest
import torch

import jax

from chip_smoke import _pack_rows
from vorbis_tpu.ops import encdevice as JE
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops.pack_cuda import pack_packets, pack_packets_plain

# one torch thread a pytest-xdist worker (see test_torch_switching.py)
torch.set_num_threads(1)

LOOKS = {"44.1 kHz": (2, 44100, 0.5), "5.1": (6, 48000, 0.4),
         "16 kHz": (2, 16000, 0.5), "32 kHz": (2, 32000, 0.5)}
CASES = [(look, W) for look in LOOKS for W in (1, 0)]
KERNEL_THREADS = 256                # csrc/pack_bits.cu kThreads


@pytest.fixture(scope="session")
def plans():
    """(look, W) -> (the port's PackPlan, its PackTables on the CPU)."""
    out = {}
    for look, args in LOOKS.items():
        fe = TFE(*args, device="cpu")
        for W in (1, 0):
            dev = fe._dev_for(W)
            out[look, W] = dev.plan, dev.pack_tabs
    return out


@pytest.fixture(scope="session")
def jax_packer():
    """The JAX package's packer, jitted once a (plan, budget)."""
    cache = {}

    def run(plan, vals, lens, wb):
        key = (id(plan), wb)
        if key not in cache:
            jplan = JE.PackPlan(gidx=plan.gidx, n_cols=plan.n_cols,
                                wb=plan.wb, worst_bytes=plan.worst_bytes)
            cache[key] = jax.jit(lambda v, l: JE.pack_bits_device(
                *JE.merge_columns(v, l, jplan), wb))
        pk, nb = cache[key](vals.astype(np.uint32), lens)
        return np.asarray(pk), np.asarray(nb)
    return run


def _plain(tabs, vals, lens, wb):
    pk, nb = pack_packets_plain(tabs, torch.from_numpy(vals),
                                torch.from_numpy(lens), wb)
    return pk.numpy(), nb.numpy()


@pytest.mark.parametrize("look,W", CASES)
def test_plain_packer_equals_jax_on_every_plan(plans, jax_packer, look, W):
    """Every _pack_rows row but the one whose values carry bits above
    their lengths: the JAX packer adds a merged field's bits above its
    width into its byte planes, where the port masks them; no encoder
    column has such bits (a codeword is below 2^length)."""
    plan, tabs = plans[look, W]
    vals, lens = (np.delete(a, 5, 0) for a in
                  _pack_rows(plan.gidx, plan.n_cols, 11 + 2 * W))
    for wb in (plan.wb, plan.worst_bytes):
        pk, nb = _plain(tabs, vals, lens, wb)
        jpk, jnb = jax_packer(plan, vals, lens, wb)
        assert pk.shape == (len(vals), wb) and pk.dtype == np.uint8
        assert np.array_equal(nb, jnb), (look, W, wb)
        assert np.array_equal(pk, jpk), (look, W, wb)
    # a row of every group at 32 bits is longer than any budget
    assert nb[-3] == 32 * len(plan.gidx) > 8 * plan.worst_bytes
    assert nb[-1] == nb[-2] == 0 and not pk[-2:].any()


def replay(groups, n_groups, vals, lens, wb, threads=KERNEL_THREADS):
    """csrc/pack_bits.cu's schedule in numpy, the rows side by side: the
    plan's groups in rounds of `threads`, a group a thread merged as the
    kernel merges it, the block's exclusive scan of the merged lengths
    (warp inclusive scans by shuffles up, then the warps' totals before
    the thread's), each field shifted to its offset and ORed into at
    most two 32-bit words of the row's (wb + 3) / 4, words past that
    dropped; the bytes are the words' first wb, the bit count the sum of
    the rounds'."""
    F = len(vals)
    offs, cols = groups[:n_groups + 1], groups[n_groups + 1:]
    nwords = (wb + 3) // 4
    words = np.zeros((F, nwords + 2), np.uint64)   # two spill words
    v64, lens = vals.view(np.uint64), lens.astype(np.int64)
    base = np.zeros(F, np.int64)
    rows = np.arange(F)
    for g0 in range(0, n_groups, threads):
        acc = np.zeros((F, threads), np.uint64)
        acc_l = np.zeros((F, threads), np.int64)
        for t in range(min(threads, n_groups - g0)):
            g = g0 + t
            for c in cols[offs[g]:offs[g + 1]]:
                l = lens[:, c]
                sh = np.minimum(acc_l[:, t], 31).astype(np.uint64)
                acc[:, t] |= np.where(l > 0, v64[:, c] << sh, np.uint64(0))
                acc_l[:, t] += l
        v = acc & np.uint64(0xFFFFFFFF)
        width = (np.uint64(1) << np.clip(acc_l, 0, 63).astype(np.uint64)) \
            - np.uint64(1)
        v = np.where(acc_l <= 0, np.uint64(0),
                     np.where(acc_l < 32, v & width, v))
        x = acc_l.reshape(F, threads // 32, 32).copy()
        d = 1
        while d < 32:                          # __shfl_up_sync
            y = np.zeros_like(x)
            y[..., d:] = x[..., :-d]
            x += y
            d <<= 1
        tot = x[..., -1]
        before = np.cumsum(tot, 1) - tot
        off = base[:, None] + (before[..., None] + x).reshape(F, threads) \
            - acc_l
        w = off >> 5
        sh = (v << (off & 31).astype(np.uint64))
        for part, wi in ((sh & np.uint64(0xFFFFFFFF), w),
                         (sh >> np.uint64(32), w + 1)):
            keep = (v != 0) & (wi < nwords)
            np.bitwise_or.at(words, (np.broadcast_to(rows[:, None],
                                                     wi.shape)[keep],
                                     wi[keep]), part[keep])
        base += tot.sum(1)
    out = words[:, :nwords].astype("<u4").view(np.uint8)[:, :wb]
    return np.ascontiguousarray(out), base.astype(np.int32)


@pytest.mark.parametrize("look,W", CASES)
def test_kernel_replay_equals_plain(plans, look, W):
    plan, tabs = plans[look, W]
    vals, lens = _pack_rows(plan.gidx, plan.n_cols, 31 + W, seeded=2)
    g = tabs.groups.numpy()
    for wb in (plan.wb, plan.worst_bytes, 40):
        want = _plain(tabs, vals, lens, wb)
        for threads in (KERNEL_THREADS, 64):
            got = replay(g, tabs.n_groups, vals, lens, wb, threads)
            assert np.array_equal(got[1], want[1]), (look, W, wb, threads)
            assert np.array_equal(got[0], want[0]), (look, W, wb, threads)


def test_real_columns_replay(plans):
    """The replay on a real finish call's columns: a 44.1 kHz stateless
    step of 64 packets on the CPU, its columns recorded at the packer."""
    from vorbis_tpu_torch.ops import encdevice
    fe = TFE(2, 44100, 0.5, switching=False, psy_state=False, device="cpu")
    dev = encdevice.DeviceFastEncode(fe, chunk_packets=64)
    seen = []
    real = encdevice.pack_packets

    def spy(tabs, vals, lens, wb):
        seen.append((tabs, vals, lens, wb))
        return real(tabs, vals, lens, wb)
    encdevice.pack_packets = spy
    try:
        rng = np.random.RandomState(3)
        pcm = (rng.randn(2, dev.chunk_samples) * 3000).astype(np.int16)
        pk, nb = dev.make_step()(torch.from_numpy(pcm))
    finally:
        encdevice.pack_packets = real
    (tabs, vals, lens, wb), = seen
    assert tabs is dev.pack_tabs and wb == dev.plan.wb
    got = replay(tabs.groups.numpy(), tabs.n_groups, vals.numpy(),
                 lens.numpy(), wb)
    assert np.array_equal(got[0], pk.numpy())
    assert np.array_equal(got[1], nb.numpy())
    assert int(nb.min()) > 0


def test_tables_and_cpu_wrapper(plans):
    plan, tabs = plans["5.1", 1]
    g = tabs.groups.numpy()
    offs, cols = g[:tabs.n_groups + 1], g[tabs.n_groups + 1:]
    assert tabs.n_groups == len(plan.gidx) and offs[-1] == len(cols)
    for k, row in enumerate(plan.gidx):
        assert np.array_equal(cols[offs[k]:offs[k + 1]], row[row >= 0])
    assert torch.equal(tabs.gidx, torch.from_numpy(np.where(
        plan.gidx < 0, plan.n_cols, plan.gidx)))
    vals, lens = _pack_rows(plan.gidx, plan.n_cols, 5, seeded=1)
    before = pack_packets.launches
    got = pack_packets(tabs, torch.from_numpy(vals), torch.from_numpy(lens),
                       plan.wb)
    want = _plain(tabs, vals, lens, plan.wb)
    assert pack_packets.launches == before
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
