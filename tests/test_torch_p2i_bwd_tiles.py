"""The p2i backward kernel's decomposition (csrc/p2i.cu: points binned by
the tile holding their window's clipped origin, work items of a bin's
points, each item's region of ids marking its points' window bitmasks,
every hit's terms added in row-major order a point; or the scan path that
reads each window where it lies) in plain PyTorch,
``ops/p2i.py:p2i_bwd_tiles_plain``, against the plain version
``p2i_max_backward_plain`` bit for bit on the CPU, where its index_add_ sums
each point's pixels in pixel order. The kernel itself runs in
tests/test_torch_port_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from sparenet_tpu_torch.ops import p2i


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, b, n, h, w, radius, grouped=True):
    """n points an image over and beyond the image (windows straddling the
    tile edges and the image's border, points off it), 1/8 on pixel centres
    and 1/8 duplicating others (exact ties), features in [-0.3, 1), 1/16 of
    the image indices invalid, a NaN point and two far off the image;
    scrambled unless ``grouped``. Returns the backward's arguments, with the
    winner ids of the plain splat and a random g."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(b * n, 2) * [h + 16.0, w + 16.0] - 8).astype(np.float32)
    f = (rng.rand(b * n, 1) * 1.3 - 0.3).astype(np.float32)
    q = b * n // 8
    pts[:q] = np.round(pts[:q])
    pts[q:2 * q] = pts[2 * q:3 * q]
    f[q:2 * q] = f[2 * q:3 * q]
    pts[3 * q] = np.nan
    pts[3 * q + 1] = [1e30, 5.0]
    pts[3 * q + 2] = [-1e30, -1e30]
    binds = np.repeat(np.arange(b, dtype=np.int32), n)
    bad = rng.rand(b * n) < 1 / 16
    binds[bad] = rng.choice([-1, b], int(bad.sum())).astype(np.int32)
    if not grouped:
        binds = rng.permutation(binds)
    pts, f, binds = _t(pts), _t(f), _t(binds)
    _, ids = p2i.p2i_max_plain(pts, f, binds, b, h, w, radius, True)
    g = _t(rng.randn(b, h, w, 1).astype(np.float32))
    return pts, f, binds, ids, g, radius


def _same(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("radius", [2.5, 5.0, 10.0])
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "scrambled"])
def test_tiles_match_plain(radius, grouped):
    """The kernel's plan at the tests' and the GAN's radii, on a 45 x 150
    image: tiles cut by the image's edge, windows across tile edges."""
    args = _case(0, 3, 300, 45, 150, radius, grouped)
    want = p2i.p2i_max_backward_plain(*args)
    _same(p2i.p2i_bwd_tiles_plain(*args), want)
    assert bool((want[1] != 0).any())


@pytest.mark.parametrize("tile,item,path", [((8, 32), 1, "bits"), ((16, 64), 7, "bits"),
                                            ((8, 32), 300, "scan"),
                                            ((32, 128), 5, "scan")])
def test_any_tile_item_and_path(tile, item, path):
    """Small tiles and items (a bin's points over many items) and the scan
    path give the same sums."""
    args = _case(1, 2, 300, 60, 90, 5.0)
    _same(p2i.p2i_bwd_tiles_plain(*args, tile=tile, item=item, path=path),
          p2i.p2i_max_backward_plain(*args))


def test_wide_window_takes_smaller_tiles():
    """R = 46 (K = 94): the first tile's region no longer fits, the plan
    takes 8 x 32 tiles of 16 points an item (test_plans reads it from the
    kernel library); the sums are the same."""
    args = _case(2, 2, 80, 70, 60, 46.0)
    _same(p2i.p2i_bwd_tiles_plain(*args, tile=(8, 32), item=16),
          p2i.p2i_max_backward_plain(*args))


@pytest.mark.gpu
def test_plans():
    """The kernel library's plans (csrc/p2i.cu:spn_p2i_bwd_plan; it is
    built where there is a card): the GAN's radii take 16 x 64 tiles on the
    bitmask path within 73 KB a block, with room for 4 hits a point; R = 46
    takes 8 x 32 tiles of 16 points; windows whose bitmask does not fit
    take the scan path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the plan comes from the kernel library")
    for radius in (2.5, 5.0, 7.0, 10.0):
        plan = p2i.bwd_plan(radius)
        k = p2i.window_size(radius)
        assert plan["path"] == "bits" and plan["tile"] == (16, 64)
        assert plan["words"] % 2 == 1 and plan["words"] >= k * -(-k // 32)
        assert 1 <= plan["item"] <= 300
        assert plan["hits"] == 4 * plan["item"]
        assert plan["smem"] <= 73 * 1024
    assert p2i.bwd_plan(10.0)["item"] == 283
    wide = p2i.bwd_plan(46.0)
    assert (wide["path"], wide["tile"], wide["item"]) == ("bits", (8, 32), 16)
    assert p2i.bwd_plan(400.0)["path"] == "scan"
    assert p2i.bwd_plan(10.0, path="scan")["words"] == 0


def test_no_binned_point():
    """Every point off its image or with an invalid index: zeros."""
    pts = torch.tensor([[-50.0, 3.0], [float("nan"), 1.0], [4.0, 4.0]])
    f = torch.ones(3, 1)
    binds = torch.tensor([0, 0, 5], dtype=torch.int32)
    _, ids = p2i.p2i_max_plain(pts, f, binds, 1, 16, 16, 2.5, True)
    g = torch.randn(1, 16, 16, 1, generator=torch.Generator().manual_seed(0))
    got = p2i.p2i_bwd_tiles_plain(pts, f, binds, ids, g, 2.5)
    assert not bool(got[0].any()) and not bool(got[1].any())
    _same(got, p2i.p2i_max_backward_plain(pts, f, binds, ids, g, 2.5))
