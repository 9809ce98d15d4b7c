"""The greedy MDS kernel's decomposition (csrc/mds.cu: a cloud over a
cluster of C CTAs, per-thread lanes, a lexicographic argmin reduced by
thread, warp, CTA and cluster, staged lane compaction) in plain PyTorch,
``ops/mds.py:mds_partitioned``, against the plain version ``mds_plain`` bit
for bit, on the CPU. The kernel itself runs in tests/test_torch_port_gpu.py
and chip_smoke.py, where every C is held to C = 1.
"""

import numpy as np
import pytest
import torch

from sparenet_tpu_torch.ops import mds


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(seed, b, n):
    """Seeded clouds: a box, an ellipsoid shell and duplicated points."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, n, 3).astype(np.float32) - 0.5
    h = n // 2
    d = rng.randn(b, n - h, 3)
    x[:, h:] = (d / np.linalg.norm(d, axis=-1, keepdims=True)
                * [0.4, 0.3, 0.2]).astype(np.float32)
    x[:, h + 1::16] = x[:, h::16][:, :x[:, h + 1::16].shape[1]]
    return _t(x)


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 16])
def test_partitioned_argmin_matches_plain(cluster):
    """N = 8300 (the weight 2 from index 8192 on), 64 picks, compaction
    every 16 and every 40 steps, and none: the picks of mds_plain."""
    xyz = _cloud(0, 2, 8300)
    mml = torch.tensor([0.02, 0.006])
    want = mds.mds_plain(xyz, 64, mml)
    for stage in (16, 40, 0):
        got = mds.mds_partitioned(xyz, 64, mml, cluster, stage)
        assert torch.equal(got, want), stage


@pytest.mark.parametrize("cluster", [1, 3, 16])
def test_partitioned_argmin_ties_at_density_zero(cluster):
    """Points 1 apart on a lattice at a small temperature: every bump but a
    pick's own flushes to 0, so densities tie at exactly 0 and the lowest
    index wins each step; duplicated points tie above 0."""
    g = torch.stack(torch.meshgrid(*[torch.arange(12.0)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    xyz = torch.cat([g, g[:300]], 0)[None].repeat(2, 1, 1).contiguous()
    xyz[1] = xyz[1].flip(0)
    mml = torch.tensor([0.05, 0.05])
    want = mds.mds_plain(xyz, 96, mml)
    for stage in (8, 33):
        assert torch.equal(mds.mds_partitioned(xyz, 96, mml, cluster, stage),
                           want)


@pytest.mark.parametrize("cluster", [1, 4])
def test_partitioned_argmin_nan_and_zero_temperature(cluster):
    """t NaN: every density NaN, the first NaN (point 0) wins each step; t
    = 0: NaN only where a point coincides with a pick, so picks repeat.
    Compaction must stay off in both (a picked lane can win again)."""
    xyz = _cloud(1, 2, 600)
    xyz[1, 300:340] = xyz[1, :40]
    mml = torch.tensor([float("nan"), 0.0])
    want = mds.mds_plain(xyz, 48, mml)
    assert bool((want[0] == 0).all())
    got = mds.mds_partitioned(xyz, 48, mml, cluster, 4)
    assert torch.equal(got, want)


def test_cloud_ids_cover_every_point_once():
    """Chunks of 32 go round the CTAs; within a CTA lanes ascend with the
    original index and (thread, lane) pairs are distinct."""
    for n, c in ((8300, 3), (19384, 16), (100, 4)):
        cta, thread, lane = mds._cloud_ids(n, c, "cpu")
        assert bool((cta == (torch.arange(n) // 32) % c).all())
        key = (cta * 512 + thread) * 64 + lane
        assert key.unique().numel() == n
        for r in range(c):
            sel = cta == r
            local = lane[sel] * 512 + thread[sel]
            assert bool((local.diff() > 0).all()) if local.numel() > 1 else True

