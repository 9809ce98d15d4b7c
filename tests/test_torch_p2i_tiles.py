"""The p2i splat kernel's decomposition (csrc/p2i.cu: a counting sort of
(point, tile) entries into bins, work items of a bin's entries, each item's
max of packed keys over its tile, split bins merged) in plain PyTorch,
``ops/p2i.py:p2i_tiles_plain``, against the plain version ``p2i_max_plain``
bit for bit in values and ids, on the CPU. The kernel itself runs in
tests/test_torch_port_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from sparenet_tpu_torch.ops import p2i


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _splat(seed, b, n, h, w, grouped=True):
    """n points an image scattered over and beyond the image (windows
    straddling the tile edges and the image's border, points off it), 1/8
    on pixel centres (exact distance ties), 1/8 duplicating others (equal
    values: the lowest id must win), features in [-0.3, 1) (some <= 0),
    1/16 of the image indices invalid (-1 or b); scrambled unless
    ``grouped`` (image-major equal groups, the renderer's layout)."""
    rng = np.random.RandomState(seed)
    pts = (rng.rand(b * n, 2) * [h + 16.0, w + 16.0] - 8).astype(np.float32)
    f = (rng.rand(b * n, 1) * 1.3 - 0.3).astype(np.float32)
    q = b * n // 8
    pts[:q] = np.round(pts[:q])
    pts[q:2 * q] = pts[2 * q:3 * q]
    f[q:2 * q] = f[2 * q:3 * q]
    binds = np.repeat(np.arange(b, dtype=np.int32), n)
    bad = rng.rand(b * n) < 1 / 16
    binds[bad] = rng.choice([-1, b], int(bad.sum())).astype(np.int32)
    if not grouped:
        binds = rng.permutation(binds)
    return _t(pts), _t(f), _t(binds)


def _same(got, want):
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("radius", [2.0, 4.5, 10.0])
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "scrambled"])
def test_tiles_match_plain(radius, grouped):
    """Small tiles (16 x 32 on a 45 x 70 image: windows cross up to three
    tiles a side at R = 10, the last tiles are cut by the image's edge),
    with and without ids."""
    args = (*_splat(0, 3, 300, 45, 70, grouped), 3, 45, 70, radius)
    for with_ids in (True, False):
        want = p2i.p2i_max_plain(*args, with_ids)
        _same(p2i.p2i_tiles_plain(*args, with_ids, tile=(16, 32)), want)
        if with_ids:
            assert bool((want[1] >= 0).any())
            assert bool((want[1] == -1).any()) or radius > 5


@pytest.mark.parametrize("radius", [4.5, 10.0])
def test_tiles_default_shape_and_order_within_bins(radius):
    """The kernel's tile (32 x 128) on a 70 x 300 image, three orders of
    the entries within their bins: the same values and ids."""
    args = (*_splat(1, 2, 500, 70, 300, grouped=False), 2, 70, 300, radius)
    want = p2i.p2i_max_plain(*args)
    for seed in range(3):
        _same(p2i.p2i_tiles_plain(*args, seed=seed), want)


def test_tiles_split_bins():
    """A crowded tile: 600 points within a few pixels of one spot, among
    others; with 8 entries an item its bin splits over some 75 items that
    merge by max, and one item a bin gives the same."""
    pts, f, binds = _splat(2, 2, 200, 40, 64)
    rng = np.random.RandomState(3)
    crowd = _t((rng.rand(600, 2) * 5 + [20.0, 30.0]).astype(np.float32))
    crowd[:100] = crowd[100:200]                      # exact ties in the crowd
    pts = torch.cat([pts, crowd])
    f = torch.cat([f, _t(rng.rand(600, 1).astype(np.float32))])
    binds = torch.cat([binds, torch.zeros(600, dtype=torch.int32)])
    args = (pts, f, binds, 2, 40, 64, 7.0)
    want = p2i.p2i_max_plain(*args)
    for per_item in (8, 10 ** 6):
        _same(p2i.p2i_tiles_plain(*args, tile=(16, 32), per_item=per_item), want)


def test_tiles_no_points_and_all_off_image():
    """No points, and points all off the image or with invalid image
    indices: every pixel 0, every id -1 (empty tiles are written too)."""
    for pts, binds in ((torch.zeros(0, 2), torch.zeros(0, dtype=torch.int32)),
                       (torch.tensor([[-30.0, 5.0], [5.0, 99.0], [3.0, 3.0]]),
                        torch.tensor([0, 0, 2], dtype=torch.int32))):
        f = torch.ones(pts.shape[0], 1)
        got = p2i.p2i_tiles_plain(pts, f, binds, 2, 20, 40, 3.0, tile=(8, 32))
        _same(got, p2i.p2i_max_plain(pts, f, binds, 2, 20, 40, 3.0))
        assert not bool(got[0].any()) and bool((got[1] == -1).all())


@pytest.mark.parametrize("tile", [p2i.TILE, (16, 32)])
def test_item_entries_scale_with_the_window(tile):
    """A work item holds about ITEM_PIXELS pixels of windows clipped to a
    tile at any radius."""
    for r in (2.0, 5.0, 7.0, 10.0, 40.0):
        n = p2i.item_entries(r, tile)
        k = p2i.window_size(r)
        area = min(k, tile[0]) * min(k, tile[1])
        assert n >= 1 and (n * area <= p2i.ITEM_PIXELS or n == 1)
        assert (n + 1) * area > p2i.ITEM_PIXELS
