"""The port's kernel wrappers at shapes past the first designs' limits, on
the CPU: each wrapper is made to take its CUDA branch (``is_cpu`` patched)
with a stand-in for the kernel library that records the C call, so the
test shows that the wrapper raises nothing and hands the kernel the shape.
The capacities the stand-in reports are the ones the kernel sources
declare. The kernels themselves run at these shapes in
tests/test_torch_port_gpu.py.
"""

import contextlib
import re

import pytest
import torch

from sparenet_tpu_torch.ops import (_lib, edge_gather, expansion_penalty,
                                    gather, knn, mds, p2i)


def _constants(source: str) -> dict:
    text = (_lib.CSRC_DIR / source).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def _capacities() -> dict:
    m, e = _constants("mds.cu"), _constants("expansion.cu")
    return {"spn_mds_max_points": m["kMaxCluster"] * m["kMaxLanes"] * m["kThreads"],
            "spn_mds_continue_max_points": m["kMaxCluster"] * m["kMaxLanes"] * m["kThreads"],
            "spn_mds_continue_max_steps": 1 << 14,
            "spn_expansion_max_points": e["kMaxV"] * e["kMaxS"]}


class _Library:
    """Records each entry point's arguments; returns 0 (success), the
    constants the sources declare, and small scratch sizes."""

    def __init__(self):
        self.calls = []
        self.caps = _capacities()

    def __getattr__(self, name):
        if name in self.caps:
            return lambda *a: self.caps[name]

        def call(*args):
            self.calls.append((name, args))
            if name == "spn_p2i_bwd_plan":  # words, tile, item, hits, smem
                args[-1][:] = (7, 5, 9, 11, 13, 0)
            if name == "spn_gather_partial_rows":  # three row groups
                return 3
            return 1 if name == "spn_edge_stats_route_bytes" else (
                16 if "scratch" in name else 0)
        return call


@pytest.fixture
def kernels(monkeypatch):
    fake = _Library()
    monkeypatch.setattr(_lib, "lib", lambda: fake)
    monkeypatch.setattr(_lib, "stream_of", lambda t: 0)
    monkeypatch.setattr(_lib, "device_counter",
                        lambda name, dev: torch.zeros(1, dtype=torch.int64))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for mod in (mds, expansion_penalty, gather, edge_gather, knn, p2i):
        monkeypatch.setattr(mod, "is_cpu", lambda t: False)
    return fake


def _launched(fake, name):
    return [args for n, args in fake.calls if n == name]


def test_mds_takes_n_past_20480(kernels):
    xyz = torch.zeros(2, 25000, 3)
    mds.minimum_density_sample(xyz, 100, torch.ones(2))
    (args,) = _launched(kernels, "spn_mds")
    assert args[2:5] == (2, 25000, 100)
    assert kernels.caps["spn_mds_max_points"] >= 16 * 20480


def test_mds_continue_takes_past_5120_lanes(kernels):
    xyz, temp = torch.zeros(1, 20000, 3), torch.zeros(1, 20000)
    orig = torch.zeros(1, 20000, dtype=torch.int32)
    mds.mds_continue(xyz, temp, orig, torch.ones(1), 300)
    (args,) = _launched(kernels, "spn_mds_continue")
    assert args[4:7] == (1, 20000, 300)


def test_mds_continue_takes_past_20480_lanes(kernels):
    """On a cluster the continuation takes what the greedy kernel takes:
    C x 20480 lanes, and the cluster size and compaction period are passed
    on."""
    xyz, temp = torch.zeros(2, 100000, 3), torch.zeros(2, 100000)
    orig = torch.zeros(2, 100000, dtype=torch.int32)
    mds.mds_continue(xyz, temp, orig, torch.ones(2), 2048, _cluster=8, _stage=0)
    (args,) = _launched(kernels, "spn_mds_continue")
    assert args[4:9] == (2, 100000, 2048, 8, 0)
    assert kernels.caps["spn_mds_continue_max_points"] >= 16 * 20480


@pytest.mark.parametrize("tile,radius", [((32, 128), 10.0), ((8, 32), 40.0)])
def test_p2i_takes_any_radius_and_tile(kernels, tile, radius):
    """Windows wider than a tile (a point in up to 36 tiles) and any image
    size: the wrapper hands the kernel the tile, the window and the
    entries an item."""
    pts, f = torch.zeros(1000, 2), torch.zeros(1000, 1)
    binds = torch.zeros(1000, dtype=torch.int32)
    p2i.p2i_max(pts, f, binds, 3, 300, 77, radius, True, _tile=tile)
    (args,) = _launched(kernels, "spn_p2i_max")
    assert args[3:7] == (1000, 3, 300, 77)
    assert args[8:12] == (p2i.window_size(radius), *tile,
                          p2i.item_entries(radius, tile))


def test_expansion_takes_s_past_1024(kernels):
    expansion_penalty.mst_charges(torch.zeros(2, 5000, 3))
    (args,) = _launched(kernels, "spn_expansion")
    assert args[1:3] == (2, 5000)
    assert kernels.caps["spn_expansion_max_points"] >= 14336


def test_expansion_passes_its_warps_and_modes(kernels):
    """The 16-warp kernel takes no warp count: the whole function reaches
    it as mode 0, the timing modes as 1 (Prim only) and 2 (empty steps)."""
    x = torch.zeros(3, 512, 3)
    expansion_penalty.mst_charges(x)
    expansion_penalty.mst_floor(x, "prim")
    expansion_penalty.mst_floor(x, "floor")
    calls = _launched(kernels, "spn_expansion")
    assert [a[1:4] for a in calls] == [(3, 512, 0), (3, 512, 1), (3, 512, 2)]


@pytest.mark.parametrize("radius", [10.0, 46.0, 300.0])
def test_p2i_backward_takes_any_radius(kernels, radius):
    """The GAN's radius, a window that takes the smaller tiles and one whose
    bitmask does not fit: the wrapper asks the library for the plan at the
    window's K and hands the kernel that plan (test_torch_p2i_bwd_tiles.py:
    test_plans checks the plans themselves on the card)."""
    pts, f = torch.zeros(700, 2), torch.zeros(700, 1)
    binds = torch.zeros(700, dtype=torch.int32)
    ids = torch.zeros(3, 90, 70, 1, dtype=torch.int32)
    p2i.p2i_max_backward(pts, f, binds, ids, torch.zeros(3, 90, 70, 1), radius)
    (plan,) = _launched(kernels, "spn_p2i_bwd_plan")
    (args,) = _launched(kernels, "spn_p2i_max_backward")
    assert plan[:5] == (p2i.window_size(radius), 0, 0, 0, 0)
    assert args[5:9] == (700, 3, 90, 70)
    assert args[10:16] == (p2i.window_size(radius), 5, 9, 11, 7, 13)


def test_p2i_backward_passes_forced_plans(kernels):
    """Forced tiles, items and the scan path reach the library's plan as
    (K, rows, columns, item, scan); none forced as zeros."""
    pts, f = torch.zeros(50, 2), torch.zeros(50, 1)
    binds = torch.zeros(50, dtype=torch.int32)
    ids = torch.zeros(2, 40, 30, 1, dtype=torch.int32)
    g = torch.zeros(2, 40, 30, 1)
    p2i.p2i_max_backward(pts, f, binds, ids, g, 5.0, _tile=(8, 32), _item=7)
    p2i.p2i_max_backward(pts, f, binds, ids, g, 5.0, _path="scan")
    p2i.p2i_max_backward(pts, f, binds, ids, g, 2.5)
    plans = [a[:5] for a in _launched(kernels, "spn_p2i_bwd_plan")]
    assert plans == [(12, 8, 32, 7, 0), (12, 0, 0, 0, 1), (8, 0, 0, 0, 0)]


@pytest.mark.parametrize("c,k,offset", [(3, 8, 0), (130, 20, 0), (64, 40, 1)])
def test_gather_max_takes_any_width_k_and_alignment(kernels, c, k, offset):
    table = torch.zeros(2 * 50 * c + offset)[offset:].view(2, 50, c)
    idx = torch.zeros(2, 40, k, dtype=torch.int32)
    _, s = gather.gather_max(table, idx, need_sum=True)
    (args,) = _launched(kernels, "spn_gather_max")
    assert args[2:7] == (2, 50, 40, c, k)
    assert args[8] is not None and s.shape == (2, c)   # 3 partial rows
    gather.gather_max(table, idx)
    assert _launched(kernels, "spn_gather_max")[1][8] is None


@pytest.mark.parametrize("c,k,offset", [(3, 8, 0), (130, 16, 0), (64, 33, 1)])
def test_edge_stats_take_any_width_k_and_alignment(kernels, c, k, offset):
    table = torch.zeros(2 * 50 * c + offset)[offset:].view(2, 50, c)
    idx = torch.zeros(2, 40, k, dtype=torch.int32)
    edge_gather.edge_stats_fwd(table, idx)
    g = [torch.zeros(2, 40, c) for _ in range(6)]
    edge_gather.edge_stats_bwd(table, idx, *g)
    assert _launched(kernels, "spn_edge_stats_fwd")[0][2:7] == (2, 50, 40, c, k)
    assert _launched(kernels, "spn_edge_stats_bwd")[0][8:13] == (2, 50, 40, c, k)


@pytest.mark.parametrize("packed", [False, True])
def test_knn_takes_k_past_32(kernels, packed):
    knn.knn_idx(torch.zeros(2, 300, 8), 64, packed=packed)
    (args,) = _launched(kernels, "spn_knn_packed" if packed else "spn_knn")
    assert args[2:6] == (2, 300, 8, 64)
