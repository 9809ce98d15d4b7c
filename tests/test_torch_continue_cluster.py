"""The MDS continuation kernel's decomposition (csrc/mds.cu in its
continuation mode: the live lanes of a cloud over a cluster of C CTAs, the
state started from temp0, weights from orig, a lexicographic argmin reduced
by thread, warp, CTA and cluster, staged lane compaction) in plain PyTorch,
``ops/mds.py:mds_continue_partitioned``, against the plain version
``mds_continue_plain`` bit for bit, on the CPU. The kernel itself runs in
tests/test_torch_port_gpu.py and chip_smoke.py, where every C is held to
the plain version.
"""

import numpy as np
import pytest
import torch

from sparenet_tpu_torch.ops import mds


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _state(seed, b, n, heavy_from=8000):
    """Seeded live lanes: coordinates in a box with every 8th point
    duplicated (exact density ties), densities of a prefix (small, every
    4th one equal to its neighbour), original indices ascending from
    ``heavy_from`` (so lanes past 8192 - heavy_from weigh 2)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, n, 3).astype(np.float32) - 0.5
    x[:, 1::8] = x[:, 0::8][:, :x[:, 1::8].shape[1]]
    temp = (rng.rand(b, n) * 0.05).astype(np.float32)
    temp[:, 3::4] = temp[:, 2::4][:, :temp[:, 3::4].shape[1]]
    orig = (np.arange(n, dtype=np.int32)[None] * 2 + heavy_from).repeat(b, 0)
    return _t(x), _t(temp), _t(orig)


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 16])
def test_partitioned_continuation_matches_plain(cluster):
    """N = 1000 live lanes (not a multiple of 32), the weight 2 from lane 96
    on, 80 steps, compaction every 16 and every 33 steps, and none: the
    picks of mds_continue_plain."""
    xyz, temp, orig = _state(0, 2, 1000)
    mml = torch.tensor([0.02, 0.006])
    want = mds.mds_continue_plain(xyz, temp, orig, mml, 80)
    for stage in (16, 33, 0):
        got = mds.mds_continue_partitioned(xyz, temp, orig, mml, 80, cluster,
                                           stage)
        assert torch.equal(got, want), stage


@pytest.mark.parametrize("cluster", [1, 3, 16])
def test_partitioned_continuation_ties(cluster):
    """Every density of temp0 equal and far-apart points (every bump but a
    pick's own flushes to 0): the lowest lane wins each step, so the picks
    are the lanes in order; duplicated lanes tie above 0."""
    g = torch.stack(torch.meshgrid(*[torch.arange(9.0)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    xyz = torch.cat([g, g[:100]], 0)[None].repeat(2, 1, 1).contiguous()
    xyz[1] = xyz[1].flip(0)
    temp = torch.full((2, xyz.shape[1]), 0.25)
    orig = torch.arange(8150, 8150 + xyz.shape[1], dtype=torch.int32)[None]
    orig = orig.repeat(2, 1).contiguous()
    mml = torch.tensor([0.05, 0.05])
    want = mds.mds_continue_plain(xyz, temp, orig, mml, 72)
    assert want[0, :40].tolist() == list(range(40))
    for stage in (8, 0):
        assert torch.equal(mds.mds_continue_partitioned(
            xyz, temp, orig, mml, 72, cluster, stage), want)


@pytest.mark.parametrize("cluster", [1, 4])
def test_partitioned_continuation_nan_and_zero_temperature(cluster):
    """t = 0 (NaN only where a lane coincides with a pick, so picks repeat)
    and a NaN in temp0 (it wins the first step, then its pin replaces it):
    compaction must stay off in both."""
    xyz, temp, orig = _state(1, 2, 300)
    xyz[0, 150:170] = xyz[0, :20]
    temp[1, 77] = float("nan")
    mml = torch.tensor([0.0, 0.01])
    want = mds.mds_continue_plain(xyz, temp, orig, mml, 48)
    assert int(want[1, 0]) == 77
    assert len(set(want[0].tolist())) < 48
    got = mds.mds_continue_partitioned(xyz, temp, orig, mml, 48, cluster, 4)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cluster", [1, 2, 16])
def test_partitioned_continuation_large_temp0_keeps_every_lane(cluster):
    """Densities of 1e9 and inf in temp0 (lanes that can lose to a picked
    lane, which then wins again), and -inf, -0 and +0: -inf lanes go first,
    -0 ties +0 (the lower lane wins), and compaction stays off, since a
    density reaches 5e8."""
    xyz, temp, orig = _state(2, 2, 200)
    temp[0, 20:] = float("inf")
    temp[0, 10:20] = 1e9
    temp[0, 5] = float("-inf")
    temp[1, 60] = -0.0
    temp[1, 40] = 0.0
    temp[1, 100:] = 6e8
    mml = torch.tensor([0.01, 0.01])
    want = mds.mds_continue_plain(xyz, temp, orig, mml, 40)
    assert len(set(want[0].tolist())) < 40       # picks repeat
    assert int(want[0, 0]) == 5 and int(want[1, 0]) == 40
    for stage in (2, 7):
        got = mds.mds_continue_partitioned(xyz, temp, orig, mml, 40, cluster,
                                           stage)
        assert torch.equal(got, want), stage


def test_partitioned_continuation_compacts_where_it_may():
    """The compaction does take lanes out where temp0 is below 5e8 and t
    finite: with a period of 1 a picked lane is gone from the next step on,
    and the picks still equal the plain version's (the bound that keeps a
    live lane below any picked one holds)."""
    xyz, temp, orig = _state(3, 1, 700)
    temp[0, 5] = 4.9e8
    mml = torch.tensor([0.01])
    want = mds.mds_continue_plain(xyz, temp, orig, mml, 120)
    assert len(set(want[0].tolist())) == 120
    for cluster in (1, 3):
        assert torch.equal(mds.mds_continue_partitioned(
            xyz, temp, orig, mml, 120, cluster, 1), want)
