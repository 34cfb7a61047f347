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
replay of the kernel's schedule (`replay`: tiles of a thread's runs of
groups, the lengths' staging copies, the values read only where a
length is positive, one block scan of the runs' bits by warp shuffles
and the packet's warp totals, the merge a group at a time in 32 bits,
each field ORed into at most two 32-bit words, words past the budget
dropped) is held bitwise to the plain version at the kernel's block
shape and at 32 threads a packet in tiles of 128 staged words, several
packets a block (`SHAPES`), and to a real finish call's packets.  The
wrapper takes the plain version on CPU tensors; `PackTables`' offsets
name every plan's groups, and a plan whose groups are not runs of
consecutive columns is refused.  Tolerance: bitwise everywhere (integer
work).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from chip_smoke import _pack_rows
from vorbis_tpu.ops import encdevice as JE
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops.pack_cuda import (LENS_WORDS, MAX_RUN, THREADS,
                                            PackTables, pack_packets,
                                            pack_packets_plain)

# one torch thread a pytest-xdist worker (see test_torch_switching.py)
torch.set_num_threads(1)

LOOKS = {"44.1 kHz": (2, 44100, 0.5), "5.1": (6, 48000, 0.4),
         "16 kHz": (2, 16000, 0.5), "32 kHz": (2, 32000, 0.5)}
CASES = [(look, W) for look in LOOKS for W in (1, 0)]


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


def _put(words, rows, acc, acc_l, off, m, nwords):
    """put_field where m: each merged field kept to 32 bits, masked to
    its width and ORed into at most two 32-bit words, words past the
    budget dropped."""
    v = acc & np.uint64(0xFFFFFFFF)
    width = (np.uint64(1) << np.clip(acc_l, 0, 63).astype(np.uint64)) \
        - np.uint64(1)
    v = np.where(acc_l <= 0, np.uint64(0),
                 np.where(acc_l < 32, v & width, v))
    keep = m & (v != 0) & (off >= 0)
    w = off >> 5
    sh = v << (off & 31).astype(np.uint64)
    for part, wi in ((sh & np.uint64(0xFFFFFFFF), w),
                     (sh >> np.uint64(32), w + 1)):
        k = keep & (wi < nwords) & (part != 0)
        np.bitwise_or.at(words, (rows[k], wi[k]), part[k])


POISON = 1 << 40                    # a staged word no copy wrote


def replay(tabs, vals, lens, wb, sms=132):
    """csrc/pack_bits.cu's schedule in numpy at the launch
    tabs.geometry(F, wb, sms) sizes, the rows laid out from a 16-byte
    aligned base as torch allocates them: blocks of ppb packets of tpp
    threads; a tile of tpp x run groups at a time, its lengths staged by
    4-byte head and tail copies and 16-byte interior copies (alignment
    checked, every column of the tile written once, POISON elsewhere),
    then its values, read only where the staged length is positive; a
    thread's run of groups from the offsets
    (o[j], the run's end past its groups); the scan (warp inclusive
    scans by shuffles up, the packet's warp totals read from the block's
    array at the packet's first warp); the merge a group at a time from
    the stages in 32 bits; each field ORed into at most two 32-bit
    words; the row's 16-byte stores and byte edges.  Returns (packets, nbits, the value reads a
    column)."""
    offs = tabs.offs.numpy().astype(np.int64)
    F, C = lens.shape
    C1 = len(offs) - 1
    g = tabs.geometry(F, wb, sms)
    tpp, ppb, run, lw = g.tpp, g.ppb, g.run, g.lw
    nwords, nwp = (wb + 3) // 4, tpp // 32
    words = np.zeros((F, g.nw), np.uint64)
    v64, rows = vals.view(np.uint64), np.arange(F)
    loads = np.zeros((F, C), np.int64)
    base = np.zeros(F, np.int64)
    R = rows[:, None]
    for g0 in range(0, C1, tpp * run):
        g1 = min(g0 + tpp * run, C1)
        c0, c1 = offs[g0], offs[g1]
        n = c1 - c0
        # the stage: a packet's tile at word mis + (c - c0)
        stage = np.full((F, lw), POISON, np.int64)
        mis = (rows * C + c0) % 4
        for f in range(F):
            m = mis[f]
            head = min((4 - m) % 4, n)
            nvec = (n - head) // 4
            tail = head + 4 * nvec
            assert (m + head) % 4 == 0 and (f * C + c0 + head) % 4 == 0
            assert m + n <= lw
            stage[f, m:m + head] = lens[f, c0:c0 + head]             # 4 B
            stage[f, m + head:m + tail] = lens[f, c0 + head:c0 + tail]
            stage[f, m + tail:m + n] = lens[f, c0 + tail:c1]         # 4 B
        at = mis[:, None] - c0                 # stage[f, at + c]: column c
        # a thread's run [ga, gb) and its offsets
        ga = np.minimum(g0 + np.arange(tpp) * run, g1)
        gb = np.minimum(ga + run, g1)
        o = offs[np.minimum(ga[None] + np.arange(MAX_RUN + 1)[:, None],
                            gb[None])]
        cb, ce = o[0], o[MAX_RUN]
        # then the values' low words where the length is positive (no
        # other slot is read)
        vstage = np.zeros((F, lw), np.uint32)
        cols = c0 + np.arange(n)
        ld = stage[R, at + cols[None]] > 0
        vstage[:, :n] = np.where(ld, vals[:, c0:c1] & 0xFFFFFFFF, 0)
        loads[:, c0:c1] += ld
        cs = np.concatenate([np.zeros((F, 1), np.int64),
                             np.cumsum(stage, 1)], 1)
        mine = cs[R, at + ce] - cs[R, at + cb]
        # the scan over the blocks' warps: slots past F are dead packets
        x = np.zeros((g.blocks * ppb, tpp), np.int64)
        x[:F] = mine
        x = x.reshape(g.blocks, ppb * nwp, 32)
        d = 1
        while d < 32:                          # __shfl_up_sync
            y = np.zeros_like(x)
            y[..., d:] = x[..., :-d]
            x += y
            d <<= 1
        warp_total = x[..., 31]                # (blocks, warps a block)
        x = x.reshape(g.blocks * ppb, tpp)[:F]
        slot = rows % ppb
        warp = (slot * tpp)[:, None] // 32 + np.arange(tpp)[None] // 32
        w0 = (slot * nwp)[:, None]
        blk = (rows // ppb)[:, None]
        wsum = np.concatenate([np.zeros((g.blocks, 1), np.int64),
                               np.cumsum(warp_total, 1)], 1)
        before = wsum[blk, warp] - wsum[blk, w0]
        total = (wsum[blk, w0 + nwp] - wsum[blk, w0])[:, 0]
        off = base[:, None] + before + x - mine
        # the merge, group j of every thread's run at a time, column k of
        # the group, in 32 bits
        ng = gb - ga
        for j in range(MAX_RUN):
            acc = np.zeros((F, tpp), np.uint32)
            acc_l = np.zeros((F, tpp), np.int64)
            for k in range(int((o[j + 1] - o[j]).max(initial=0))):
                c = o[j] + k
                act = ((j < ng) & (c < o[j + 1]))[None]
                cc = np.where(act, c[None], c0)
                lk = np.where(act, stage[R, at + cc], 0)
                sh = np.minimum(acc_l, 31).astype(np.uint32)
                acc |= np.where(lk > 0, vstage[R, cc - c0] << sh,
                                np.uint32(0))
                acc_l += lk
            opens = np.broadcast_to((j < ng)[None], acc.shape)
            _put(words, np.broadcast_to(R, acc.shape), acc.astype(np.uint64),
                 acc_l, off, opens, nwords)
            off = off + np.where(opens, acc_l, 0)
        base += total
    byts = words.astype("<u4").view(np.uint8)
    out = np.zeros((F, wb), np.uint8)
    for f in range(F):
        done = wb // 16 * 16 if f * wb % 16 == 0 else 0
        out[f, :done] = byts[f, :done]         # 16-byte stores
        out[f, done:] = byts[f, done:wb]       # bytes
    return out, base.astype(np.int32), loads


# the kernel's block shape (132 SMs: a packet a block at these rows), and
# 32 threads a packet in tiles of at most 128 staged words, eight packets
# a block (one SM), the last block part empty
SHAPES = {"kernel": (THREADS, LENS_WORDS, 132), "small": (32, 128, 1)}


def _tables(plan, tabs, shape):
    tpp_max, words, sms = SHAPES[shape]
    return PackTables(plan, tabs.gidx, tpp_max, words), sms


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("look,W", CASES)
def test_kernel_replay_equals_plain(plans, look, W, shape):
    plan, tabs = plans[look, W]
    vals, lens = _pack_rows(plan.gidx, plan.n_cols, 31 + W, seeded=2 + 8 * W)
    t, sms = _tables(plan, tabs, shape)
    for wb in (plan.wb, plan.worst_bytes, 40):
        g = t.geometry(len(vals), wb, sms)
        if shape == "small":
            assert g.tpp == 32 and g.ppb > 1 and len(vals) % g.ppb
            assert t.run < MAX_RUN or -(-t.n_groups // (32 * t.run)) > 1
        want = _plain(tabs, vals, lens, wb)
        pk, nb, loads = replay(t, vals, lens, wb, sms)
        assert np.array_equal(nb, want[1]), (look, W, wb, shape)
        assert np.array_equal(pk, want[0]), (look, W, wb, shape)
        # each column with bits loaded once, no other value read
        assert np.array_equal(loads, (lens > 0).astype(np.int64))


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
    assert int(nb.min()) > 0
    for shape in SHAPES:
        t, sms = _tables(dev.plan, tabs, shape)
        got = replay(t, vals.numpy(), lens.numpy(), wb, sms)
        assert np.array_equal(got[0], pk.numpy()), shape
        assert np.array_equal(got[1], nb.numpy()), shape


def test_tables_and_cpu_wrapper(plans):
    """Every plan's groups are runs of consecutive columns, which
    PackTables' offsets name; a plan whose groups are not is refused;
    its tiling and launch sizes; the wrapper takes the plain version on
    CPU tensors and launches nothing."""
    for (look, W), (plan, tabs) in plans.items():
        offs = tabs.offs.numpy()
        assert tabs.n_groups == len(plan.gidx) and offs[-1] == plan.n_cols
        for k, row in enumerate(plan.gidx):
            assert np.array_equal(row[row >= 0],
                                  np.arange(offs[k], offs[k + 1]))
            assert (row[offs[k + 1] - offs[k]:] < 0).all()
        assert torch.equal(tabs.gidx, torch.from_numpy(np.where(
            plan.gidx < 0, plan.n_cols, plan.gidx)))
        # a tile's columns fit its stage, three words left for alignment
        tile = tabs.tpp * tabs.run
        g0 = np.arange(0, tabs.n_groups, tile)
        span = offs[np.minimum(g0 + tile, tabs.n_groups)] - offs[g0]
        assert span.max() + 3 <= tabs.lw <= LENS_WORDS
        assert tabs.tpp % 32 == 0 and tabs.run <= MAX_RUN
    # 4d's batches: the long plan one tile of 256 threads x 8 groups, a
    # packet a block; the short one 64 threads x 5 groups
    long_, short = plans["44.1 kHz", 1][1], plans["44.1 kHz", 0][1]
    assert long_.geometry(2048, 768, 132)[:3] == (256, 1, 8)
    assert long_.geometry(2048, 768, 132).smem == (2 * long_.lw + 192) * 4
    assert short.geometry(256, 768, 132)[:3] == (64, 1, 5)
    assert short.geometry(15 * 256, 768, 132)[:3] == (64, 4, 5)
    # the 5.1 long plan goes in tiles
    assert -(-plans["5.1", 1][1].n_groups
             // (256 * plans["5.1", 1][1].run)) > 1
    plan, tabs = plans["5.1", 1]
    bad = plan.gidx.copy()
    bad[[3, 4]] = bad[[4, 3]]                   # two groups out of order
    with pytest.raises(ValueError):
        PackTables(dataclasses.replace(plan, gidx=bad), tabs.gidx)
    bad = plan.gidx.copy()
    w = (bad[0] >= 0).sum()
    bad[0, :w] = bad[0, :w][::-1]               # a group's columns reversed
    with pytest.raises(ValueError):
        PackTables(dataclasses.replace(plan, gidx=bad), tabs.gidx)
    vals, lens = _pack_rows(plan.gidx, plan.n_cols, 5, seeded=1)
    before = pack_packets.launches
    got = pack_packets(tabs, torch.from_numpy(vals), torch.from_numpy(lens),
                       plan.wb)
    want = _plain(tabs, vals, lens, plan.wb)
    assert pack_packets.launches == before
    assert np.array_equal(got[0].numpy(), want[0])
    assert np.array_equal(got[1].numpy(), want[1])
