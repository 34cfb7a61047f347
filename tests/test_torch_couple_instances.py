"""The stereo coupling kernel's instantiations (csrc/couple_quantize.cu
`kInstances`, ops/couple_cuda.py `INSTANCES`): which one `args` picks
for each encoder config, and the kernel's schedule in numpy
(tests/couple_cases.py `replay`) against the plain version on every
one of them, on the CPU and without JAX (tests/test_torch_couple.py
holds the plain version to the JAX package's jitted coupling).

Tolerance: none; residues compared by bit pattern, flags exactly.
"""

import re

import numpy as np
import pytest
import torch

from tests import couple_cases as CC
from vorbis_tpu_torch.models.fastenc import FastEncoder as TFE
from vorbis_tpu_torch.ops.couple_cuda import (INSTANCES, SOURCE, args,
                                              couple_quantize_plain,
                                              geometry)

# one torch thread a pytest-xdist worker (see test_torch_couple.py)
torch.set_num_threads(1)

# (encoder, W, M9 peaks given, padded) -> the instantiation's key
# (partition, M6, normalize, M6's lanes, the normalize's lanes)
EXPECT = {}
for _name, _long, _short, _nm in (("q0.5", 608, 76, False),
                                  ("q0.2", 608, 76, True),
                                  ("32 kHz", 832, 104, False),
                                  ("managed", 608, 76, False)):
    n = int(_nm)
    EXPECT.update({
        (_name, 1, False, False): (32, 0, n, 0, 16 * n),
        (_name, 1, False, True): (32, 0, n, 0, n),
        (_name, 1, True, False): (32, 1, n, 8, 8 * n),
        (_name, 1, True, True): (32, 1, n, 1, n),
        (_name, 0, False, False): (8, 0, n, 0, n),
        (_name, 0, False, True): (8, 0, n, 0, n),
        (_name, 0, True, False): (8, 1, n, 1, 8 * n),
        (_name, 0, True, True): (8, 1, n, 1, n)})
# 16 kHz: 8-bin partitions at both blocksizes, tonefix_end 0 (no M6),
# the normalize on
EXPECT.update({("16 kHz", W, ep, pad): (8, 0, 1, 0, 1)
               for W in (1, 0) for ep in (False, True)
               for pad in (False, True)})


@pytest.fixture(scope="module")
def encoders():
    return {name: TFE(*a, device="cpu", **kw)
            for name, (a, kw) in CC.ENCODERS.items()}


def _bitwise(got, want):
    (r, u), (rw, uw) = got, want
    assert r.shape == rw.shape and r.dtype == rw.dtype == np.float32
    bad = (r.view(np.int32) != rw.view(np.int32)).any(1) | (u != uw)
    return int(bad.sum())


def _plain(td, case):
    tc = CC.torch_case(case)
    r, u = couple_quantize_plain(td, tc.pop("md"), tc.pop("curve"),
                                 tc.pop("used"), tc.pop("F"), **tc)
    return r.numpy(), u.numpy()


def _key(td, case):
    tc = CC.torch_case(case)
    return args(td, tc.pop("md"), tc.pop("curve"), tc.pop("used"),
                tc.pop("F"), **tc)[4]


def test_instances_are_the_sources():
    """INSTANCES lists csrc/couple_quantize.cu's kInstances in order, and
    the encoders' configs with the padded rows reach every one."""
    src = re.findall(r"^\s*INSTANCE\((\d+), (\d), (\d), (\d+), (\d+)\)",
                     SOURCE.read_text(), re.M)
    assert tuple(tuple(map(int, k)) for k in src) == INSTANCES
    assert len(set(INSTANCES)) == len(INSTANCES)
    assert set(EXPECT.values()) == set(INSTANCES)
    # a warp 128 bins of 32-bin partitions, 32 of 8-bin ones; a block
    # one warp
    assert geometry(1024, 32, 2048) == (8, 16384)
    assert geometry(128, 8, 256) == (4, 1024)
    assert geometry(1016, 32, 3) == (8, 24)
    assert geometry(2048, 32, 100) == (16, 1600)


@pytest.mark.parametrize("name", list(CC.ENCODERS))
def test_args_picks_the_instance(encoders, name):
    """`args` picks EXPECT's instantiation at each encoder's long and
    short look, with and without the M9 peaks, padded and not."""
    fe = encoders[name]
    for W in (1, 0):
        td = fe._dev_for(W)
        cfg = CC.config(td)
        for ep in (False, True):
            for pad in (False, True):
                case = CC.seeded(cfg, 4, 1, epeak=ep,
                                 pad=cfg["part"] // 4 if pad else 0)
                assert _key(td, case) == EXPECT[name, W, ep, pad], \
                    (name, W, ep, pad)


@pytest.mark.parametrize("W", [1, 0])
@pytest.mark.parametrize("name", list(CC.ENCODERS))
def test_replay_on_every_instance(encoders, name, W):
    """The kernel's schedule in numpy equals the plain version on the
    rows of every instantiation this look picks (seeded rows with and
    without the M9 peaks, padded and not, with the M8 store and a
    lowpass) and, where a warp's first partition lies below
    tonefix_end and can flag -1, on the carry's rows, whose promotions
    turn on the previous warp's last partition."""
    td = encoders[name]._dev_for(W)
    cfg = CC.config(td)
    keys = set()
    for label, case in CC.instance_rows(cfg, 100 + 10 * W).items():
        keys.add(_key(td, case))
        want = _plain(td, case)
        assert _bitwise(CC.replay(cfg, case), want) == 0, label
        if label == "carry":
            p0 = CC.carry_rows(cfg, 16, 109 + 10 * W)[1]
            prom = (want[0][:, 1::2][:, p0:p0 + cfg["part"]] != 0).any(1)
            assert 0 < prom.sum() < 16
    assert keys == {v for k, v in EXPECT.items() if k[:2] == (name, W)}
