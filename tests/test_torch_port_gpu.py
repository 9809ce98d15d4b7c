"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and carries the ``gpu`` marker; where
there is none, the ``cuda`` fixture skips it. The file imports no JAX, so it
also runs where JAX is not installed (tests/conftest.py imports it, hence
``--noconftest``). On a machine with an NVIDIA Hopper card:
    python -m pytest --noconftest tests/test_torch_port_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from sparenet_tpu_torch import models
from sparenet_tpu_torch.ops import (_lib, chamfer, common, edge_gather, emd,
                                    expansion_penalty, gather, knn, mds, p2i)
from sparenet_tpu_torch.ops.common import (pairwise_sqdist_graph,
                                           pairwise_sqdist_graph_seq)
from sparenet_tpu_torch.runners import base, sparenet, sparenet_gan
from test_torch_bids_split import _assign_one_read_a_round
from test_torch_nn_split import _shells

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, or a skip. Decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    models.set_parity_mode()
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    """torch.use_deterministic_algorithms(True) for the test."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _gen():
    return torch.Generator().manual_seed(0)


def _near_ties_only(x, got, want):
    """Index mismatches only at near-ties: the distance gap of each is
    within 1e-5 of |x|^2 + |y|^2 (the two sum the same terms in another
    order), and fewer than 1e-3 of the entries."""
    got, want = got.long(), want.long()
    d = pairwise_sqdist_graph(x, x)
    gap = (d.gather(2, got) - d.gather(2, want)).abs()
    x2 = (x * x).sum(-1)
    b = x.shape[0]
    scale = x2[:, :, None] + x2.gather(1, want.reshape(b, -1)).reshape(want.shape)
    assert bool((gap <= 1e-5 * scale).all())
    assert (got != want).float().mean() < 1e-3


@pytest.mark.parametrize("c,n", [(3, 3000), (256, 3000), (40, 129)])
def test_knn_kernel_matches_plain(cuda, c, n):
    x = torch.randn(2, n, c, generator=_gen()).to(cuda)
    _near_ties_only(x, knn.knn_idx(x, 8), knn.knn_plain(x, 8))


def test_knn_kernel_lowest_index_on_ties(cuda):
    base = torch.rand(1, 40, 3, generator=_gen())
    x = torch.cat([base, base, base[:, :10]], 1).to(cuda)
    np.testing.assert_array_equal(knn.knn_idx(x, 8).cpu().numpy(),
                                  knn.knn_plain(x, 8).cpu().numpy())


@pytest.mark.parametrize("n", [129, 3000, 4097])
@pytest.mark.parametrize("k", [1, 16, 20, 32])
def test_knn_kernels_take_any_k(cuda, k, n):
    """Both arms at k other than the model's 8 (the kernels are built for
    K = 8, 16, 32 and write the first k): exact arm within the near-tie
    rule, packed arm bit for bit."""
    x = torch.randn(1, n, 64, generator=_gen()).to(cuda)
    _near_ties_only(x, knn.knn_idx(x, k), knn.knn_plain(x, k))
    assert torch.equal(knn.knn_idx(x, k, packed=True), knn.knn_packed_plain(x, k))


@pytest.mark.parametrize("k,n", [(33, 129), (64, 3000), (100, 300)])
def test_knn_kernels_take_k_above_32(cuda, k, n):
    """Past the filtered kernels' k = 32 every query takes the exact scan of
    all candidates: the exact arm equals its fixed order bit for bit
    (lowest index on ties, duplicated rows included), the packed arm its
    plain version."""
    x = torch.randn(2, n, 40, generator=_gen())
    x[:, n // 2:n // 2 + 20] = x[:, :20]
    x = x.to(cuda)
    want = knn.smallest_k(pairwise_sqdist_graph_seq(x), k)
    assert torch.equal(knn.knn_idx(x, k), want)
    assert torch.equal(knn.knn_idx(x, k, packed=True), knn.knn_packed_plain(x, k))


@pytest.mark.parametrize("c,n", [(3, 3000), (256, 3000), (40, 129)])
def test_knn_kernel_equals_its_fixed_order(cuda, c, n):
    """The exact arm ranks by its fixed summation order
    (pairwise_sqdist_graph_seq), lowest index on ties: bit for bit."""
    x = torch.randn(2, n, c, generator=_gen()).to(cuda)
    want = knn.smallest_k(pairwise_sqdist_graph_seq(x), 8)
    assert torch.equal(knn.knn_idx(x, 8), want)


def _lattice(c):
    """Two clouds of 3000 distinct points of {0..7}^4 (in the first 4 of c
    channels): a query has up to 8 others at distance 1 and 24 at 2, exact
    ties among distinct points."""
    g = torch.stack(torch.meshgrid(*[torch.arange(8.0)] * 4, indexing="ij"),
                    -1).reshape(-1, 4)
    x = torch.zeros(2, 3000, c)
    for b in range(2):
        x[b, :, :4] = g[torch.randperm(len(g), generator=_gen())[:3000]]
    return x


@pytest.mark.parametrize("c", [4, 256])
def test_knn_flagged_queries_take_the_exact_scan(cuda, c):
    """Distinct lattice points: more than 32 keys share a truncation
    bucket, the margin test flags those queries in both arms and the scan
    kernel answers them, bit for bit."""
    x = _lattice(c).to(cuda)
    _lib.reset_counts()
    packed = knn.knn_idx(x, 8, packed=True)
    exact = knn.knn_idx(x, 8)
    assert _lib.device_count("knn_packed_flagged") > 0
    assert _lib.device_count("knn_flagged") > 0
    assert torch.equal(packed, knn.knn_packed_plain(x, 8))
    assert torch.equal(exact, knn.smallest_k(pairwise_sqdist_graph_seq(x), 8))


@pytest.mark.parametrize("c", [3, 256])
def test_knn_equal_rows_rank_as_groups(cuda, c):
    """Zero-padded clouds (2048 points and 952 zero rows, as the loaders'
    RandomSamplePoints gives), and 8 points each ~125 times in the first
    1000 rows: the equal rows rank as groups, no query is flagged, and both
    arms give the plain answer, bit for bit."""
    x = torch.zeros(2, 3000, c)
    x[:, 1000:2048] = torch.randn(2, 1048, c, generator=_gen())
    x[:, :1000, :3] = torch.randint(0, 2, (2, 1000, 3), generator=_gen()).float()
    x = x.to(cuda)
    _lib.reset_counts()
    packed = knn.knn_idx(x, 8, packed=True)
    exact = knn.knn_idx(x, 8)
    assert _lib.device_count("knn_packed_flagged") == 0
    assert _lib.device_count("knn_flagged") == 0
    assert torch.equal(packed, knn.knn_packed_plain(x, 8))
    assert torch.equal(exact, knn.smallest_k(pairwise_sqdist_graph_seq(x), 8))


def _mixed_operands(c):
    """Operands that stress the tensor cores' sums: each entry scaled by
    2^e, e uniform in [-12, 12] (terms of mixed exponents in one k-step),
    and every point beside a copy of itself moved by 1e-3 (cancellation:
    d far below |x|^2)."""
    g = _gen()
    base = torch.randn(1, 128, c, generator=g) * 2.0 ** torch.randint(
        -12, 13, (1, 128, c), generator=g).float()
    near = base * (1 + 1e-3 * torch.randn(1, 128, c, generator=g))
    return torch.cat([base, near], 1)


@pytest.mark.parametrize("packed", [False, True], ids=["exact", "packed"])
@pytest.mark.parametrize("c", [3, 256, 512])
def test_knn_tensor_core_error_within_margin(cuda, c, packed):
    """The margin's premise on the card: the main kernel's dots differ from
    the arm's fixed-order dots by well under the bound derived for them
    (each add of the tensor cores keeping 24 significant bits), and its
    distances from the fixed order's by less than E."""
    dot_ratio, d_ratio = knn.tensor_core_error(_mixed_operands(c).to(cuda),
                                               packed)
    print(f"C={c} {'packed' if packed else 'exact'}: max |dot' - dot| / bound "
          f"{dot_ratio:.3e}, max |d' - d| / E {d_ratio:.3e}")
    assert dot_ratio < 0.5
    assert d_ratio < 1.0


def _unaligned(t):
    """t's values in a tensor whose data starts 4 bytes past 16-byte
    alignment (contiguous)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("c,k,shift", [(4, 8, False), (256, 8, False),
                                       (1024, 8, False), (3, 8, False),
                                       (130, 20, False), (64, 40, True),
                                       (7, 17, True)])
def test_gather_max_kernel_matches_plain(cuda, c, k, shift):
    """max exact; sum to rtol 1e-5 (+1e-6 of sum |rows| for cancellation).
    Also at C % 4 != 0, k > 16 and a table not 16-byte aligned (the
    one-channel path)."""
    g = _gen()
    table = torch.randn(2, 700, c, generator=g).to(cuda)
    if shift:
        table = _unaligned(table)
    idx = torch.randint(0, 700, (2, 650, k), generator=g, dtype=torch.int32).to(cuda)
    out, s = gather.gather_max(table, idx, need_sum=True)
    pout, ps = gather.gather_max_plain(table, idx, need_sum=True)
    assert torch.equal(out, pout)
    abs_sum = gather.gather_rows(table.abs(), idx).sum((1, 2))
    assert bool(((s - ps).abs() <= 1e-5 * ps.abs() + 1e-6 * abs_sum).all())
    assert torch.equal(gather.gather_max(table, idx), pout)


def _nan_equal(a, b):
    """Equal bit for bit where not NaN, and NaN at the same places."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def _slice_case(b, n, m, c, k, shift=False, nan=False):
    g = _gen()
    table = torch.randn(b, n, c, generator=g)
    table[:, 1] = table[:, 0]                       # equal rows
    idx = torch.randint(0, n, (b, m, k), generator=g, dtype=torch.int32)
    idx[:, :, k - 1] = idx[:, :, 0]                 # equal slots
    if nan:
        table[0, 7, c // 2] = float("nan")
        table[-1, 9] = float("nan")
        idx[:, :3, 1] = 7
        idx[:, 3:6, 0] = 9
    table, idx = table.cuda(), idx.cuda()
    return (_unaligned(table) if shift else table), idx


def _check_gather_slices(table, idx):
    """Max equal to the plain version's (NaN-aware), the sum equal to the
    model of the plan's order bit for bit, within the tolerance of the
    plain sum, and the same on a second call. Returns the plan."""
    b, n, c = table.shape
    _, m, k = idx.shape
    plan = common.slice_plan(b, n, m, c, k)
    out, s = gather.gather_max(table, idx, need_sum=True)
    out2, s2 = gather.gather_max(table, idx, need_sum=True)
    pout, ps = gather.gather_max_plain(table, idx, need_sum=True)
    assert _nan_equal(out, pout) and _nan_equal(out2, out) and _nan_equal(s2, s)
    assert _nan_equal(gather.gather_max(table, idx), pout)
    if plan["width"]:
        _, ms = gather.gather_max_sum_blocks_plain(table, idx, plan["lanes"],
                                                   plan["group_rows"])
        assert _nan_equal(s, ms), plan
    ok = ~ps.isnan()
    abs_sum = gather.gather_rows(table.abs(), idx).sum((1, 2))
    assert torch.equal(s.isnan(), ps.isnan())
    assert bool(((s - ps).abs() <= 1e-5 * ps.abs() + 1e-6 * abs_sum)[ok].all())
    return plan


def _check_stats_slices(table, idx):
    """The four outputs equal to the plain version's bit for bit
    (NaN-aware), on two calls."""
    outs = edge_gather.edge_stats_fwd(table, idx)
    again = edge_gather.edge_stats_fwd(table, idx)
    for o, w, a in zip(outs, edge_gather.edge_stats_fwd_plain(table, idx), again):
        assert _nan_equal(o, w) and _nan_equal(a, o)


@pytest.mark.parametrize("c", [256, 512, 1024])
def test_slice_kernels_at_the_path_shapes(cuda, c):
    """N = M = 3000, k = 8 (every EdgeConv stage's), the plan the paths
    take: a 16-channel slice of the table in shared memory, with a row
    split at C = 256 only."""
    table, idx = _slice_case(4, 3000, 3000, c, 8)
    plan = _check_gather_slices(table, idx)
    assert plan["width"] == 16 and (plan["groups"] > 1) == (c == 256)
    _check_stats_slices(table, idx)


# (B, N, M, C) -> the plan's width and whether it splits the rows, on an
# H100 (csrc/slices.cuh:make_plan): W = 16 up to N = 3440, W = 8 for C in
# 5..8 or N in 3441..6880, W = 4 for C <= 4 or N in 6881..13760; row groups
# where the clouds' slices fill less than one wave of blocks.
SLICE_SHAPES = [((4, 3000, 3000, 1024), 16, False), ((1, 3000, 3000, 256), 16, True),
                ((4, 5000, 3000, 256), 8, False), ((1, 5000, 3000, 256), 8, True),
                ((2, 3000, 3000, 8), 8, True), ((4, 10000, 2000, 256), 4, False),
                ((1, 10000, 2000, 256), 4, True), ((2, 3000, 3000, 3), 4, True)]


@pytest.mark.parametrize("shape,width,split", SLICE_SHAPES)
def test_slice_kernels_every_width_and_row_split(cuda, shape, width, split):
    """Every width the plan takes, without and with a row split, each at a
    shape the plan maps to it."""
    table, idx = _slice_case(*shape, 8)
    plan = _check_gather_slices(table, idx)
    assert (plan["width"], plan["groups"] > 1) == (width, split), plan
    _check_stats_slices(table, idx)


@pytest.mark.parametrize("n,m,c,k,shift", [
    (700, 650, 3, 8, False), (700, 650, 7, 8, True), (3000, 3000, 130, 8, False),
    (500, 800, 64, 16, False), (3000, 2000, 256, 20, True),
    (3000, 3000, 40, 40, False), (3000, 3000, 130, 40, True), (90, 30, 260, 1, False)])
def test_slice_kernels_ragged_k_and_alignment(cuda, n, m, c, k, shift):
    """Ragged C (the last slice masked), k other than 8 (the loop), a
    table 4 bytes past 16-byte alignment (4-byte copies), M != N."""
    table, idx = _slice_case(2, n, m, c, k, shift)
    assert _check_gather_slices(table, idx)["width"] > 0
    _check_stats_slices(table, idx)


@pytest.mark.parametrize("n,width", [(3000, 16), (10000, 4)])
def test_slice_kernels_nan_rows(cuda, n, width):
    """NaN in rows the lists name: the max, min and sums carry it."""
    table, idx = _slice_case(2, n, 3000, 256, 8, nan=True)
    assert _check_gather_slices(table, idx)["width"] == width
    _check_stats_slices(table, idx)


def test_slice_kernels_past_the_slices_reach(cuda):
    """Where no slice fits in shared memory (N = 15000 rows of 16 bytes),
    the plan gives width 0 and the row-at-a-time kernels run; at N = 13000
    the narrowest slice still fits."""
    table, idx = _slice_case(1, 15000, 700, 256, 8)
    assert common.slice_plan(1, 15000, 700, 256, 8)["width"] == 0
    assert common.slice_plan(1, 13000, 700, 256, 8)["width"] == 4
    _check_gather_slices(table, idx)
    _check_stats_slices(table, idx)


@pytest.mark.parametrize("bp,s", [(8, 64), (16, 512), (3, 1000), (2, 1500),
                                  (1, 5000), (1, 14336), (1024, 512)])
def test_expansion_kernel_matches_plain(cuda, bp, s):
    """parent and charged exact, cost to atol 1e-6 ((1024, 512): the B=32
    forward's shape)."""
    xyz = (torch.rand(bp, s, 3, generator=_gen()) * 2 - 1).to(cuda)
    par, cost, chg = expansion_penalty.mst_charges(xyz)
    ppar, pcost, pchg = expansion_penalty.mst_charges_plain(xyz)
    assert torch.equal(par, ppar) and torch.equal(chg, pchg)
    assert float((cost - pcost).abs().max()) <= 1e-6


def _degenerate_prims(g, bp, s):
    """The random-init coarse cloud's scale (1e-7), a quarter of the
    points duplicated, some on a lattice (exact distance ties), one NaN."""
    x = (torch.rand(bp, s, 3, generator=g) - 0.5) * 1e-7
    q = s // 4
    x[:, q:2 * q] = x[:, :q]
    x[:, 2 * q:3 * q] = torch.round(x[:, 2 * q:3 * q] * 4e7) / 4e7
    x[0, s // 2, 1] = float("nan")
    return x


@pytest.mark.parametrize("bp,s", [(128, 512), (16, 33), (8, 2), (4, 300),
                                  (4, 700), (2, 1024), (1, 1500)])
def test_expansion_kernel_degenerate_at_every_width(cuda, bp, s):
    """A 1e-7-scale cloud with duplicates, lattice ties and a NaN, at the
    B=4 forward's shape, at S = 33, 2 and 300 (a vertex a thread), 700 and
    1024 (two) and 1500 (the wide kernel): parent and charged exact, cost
    to atol 1e-6."""
    xyz = _degenerate_prims(_gen(), bp, s).to(cuda)
    par, cost, chg = expansion_penalty.mst_charges(xyz)
    ppar, pcost, pchg = expansion_penalty.mst_charges_plain(xyz)
    assert torch.equal(par, ppar) and torch.equal(chg, pchg)
    assert float((cost - pcost).abs().max()) <= 1e-6


@pytest.mark.parametrize("bp", [128, 768, 1024])
def test_expansion_timing_modes_run(cuda, bp):
    """The "prim" mode gives the tree with no charges, the "floor" mode
    launches."""
    xyz = (torch.rand(bp, 512, 3, generator=_gen()) - 0.5).to(cuda)
    par, cost, _ = expansion_penalty.mst_charges_plain(xyz[:2])
    p2, c2, ch2 = expansion_penalty.mst_floor(xyz, "prim")
    assert torch.equal(p2[:2], par) and torch.equal(c2[:2], cost)
    assert not bool(ch2.any())
    expansion_penalty.mst_floor(xyz, "floor")
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,npoint", [(320, 256), (8300, 300), (19384, 600)])
def test_mds_kernel_matches_plain(cuda, n, npoint):
    """Exact indices."""
    xyz = (torch.rand(2, n, 3, generator=_gen()) - 0.5).to(cuda)
    mml = torch.tensor([0.02, 0.05], device=cuda)
    assert torch.equal(mds.minimum_density_sample(xyz, npoint, mml),
                       mds.mds_plain(xyz, npoint, mml))


def _mds_near_ties_only(xyz, mml, got, want):
    """Picks equal, or the first step at which a cloud's differ a near-tie
    of the plain densities (1e-6 relative; the kernel's expf and the plain
    version's exp may differ by an ulp)."""
    for bi in range(got.shape[0]):
        bad = torch.nonzero(got[bi] != want[bi])
        if len(bad) == 0:
            continue
        j = int(bad[0])
        n = xyz.shape[1]
        t = 5.0 * mml[bi] * mml[bi]
        weight = torch.where(torch.arange(n, device=xyz.device) >= 8192, 2.0, 1.0)
        temp = torch.zeros(n, device=xyz.device)
        temp[0] = 1e9
        for s in range(1, j + 1):
            e = torch.exp(-common.sqdist3(xyz[bi] - xyz[bi, want[bi, s - 1]]) / t)
            temp = temp + weight * torch.where(
                e < torch.finfo(torch.float32).tiny, 0.0, e)
            if s < j:
                temp[want[bi, s]] = 1e9
        a, b = float(temp[got[bi, j]]), float(temp[want[bi, j]])
        assert abs(a - b) <= 1e-6 * max(abs(a), abs(b)), (bi, j, a, b)


def _mds_cloud(b, n, g):
    """Seeded clouds: half uniform in a box, half on an ellipsoid shell
    with every 16th point duplicated (exact density ties)."""
    xyz = torch.rand(b, n, 3, generator=g) - 0.5
    h = n // 2
    d = torch.randn(b, n - h, 3, generator=g)
    xyz[:, h:] = d / d.norm(dim=-1, keepdim=True) * torch.tensor([0.4, 0.3, 0.2])
    xyz[:, h + 1::16] = xyz[:, h::16][:, :xyz[:, h + 1::16].shape[1]]
    return xyz.contiguous()


@pytest.mark.parametrize("b", [1, 4, 32])
@pytest.mark.parametrize("n,npoint", [(320, 256), (19384, 2048), (25000, 1500)])
def test_mds_every_cluster_size_gives_the_same_picks(cuda, b, n, npoint):
    """Each cluster size C = 1..16 the card launches (forced, one CTA an
    SM), with two compaction periods, picks bit for bit what the smallest C
    that holds N picks (C = 1 up to 20480 points), and that matches the
    plain version (near-ties aside); so does the shape the wrapper chooses
    (one or two CTAs an SM)."""
    g = _gen()
    xyz = _mds_cloud(b, n, g).to(cuda)
    mml = (0.004 + 0.02 * torch.rand(b, generator=g)).to(cuda)
    first = 1 if n <= 20480 else 2
    want = mds.minimum_density_sample(xyz, npoint, mml, _cluster=first)
    _mds_near_ties_only(xyz, mml, want, mds.mds_plain(xyz, npoint, mml))
    for c in range(first, 17):
        for stage in (1024, 96):
            got = mds.minimum_density_sample(xyz, npoint, mml, _cluster=c,
                                             _stage=stage)
            assert torch.equal(got, want), (c, stage)
    c, per_sm = mds.cluster_size(b, n)
    assert first <= c <= 16 and per_sm in (1, 2)
    assert torch.equal(mds.minimum_density_sample(xyz, npoint, mml), want)


def test_mds_picks_with_nan_and_zero_temperature(cuda):
    """t NaN (every density NaN: the first NaN wins, point 0 again and
    again) and t = 0 (densities NaN only where a point coincides with a
    pick): compaction stays off, and every C equals the plain version."""
    g = _gen()
    xyz = (torch.rand(2, 3000, 3, generator=g) - 0.5)
    xyz[1, 1000:1100] = xyz[1, :100]
    xyz = xyz.to(cuda)
    mml = torch.tensor([float("nan"), 0.0], device=cuda)
    want = mds.mds_plain(xyz, 200, mml)
    for c in (1, 3, 16):
        got = mds.minimum_density_sample(xyz, 200, mml, _cluster=c, _stage=16)
        assert torch.equal(got, want), c


def test_mds_refuses_a_cluster_too_small(cuda):
    """One CTA holds at most 20480 points: C = 1 at 25000 raises; there is
    no fallback to another size or to the plain version."""
    xyz = torch.rand(1, 25000, 3, generator=_gen()).to(cuda)
    with pytest.raises(RuntimeError, match="mds"):
        mds.minimum_density_sample(xyz, 10, torch.tensor([0.01], device=cuda),
                                   _cluster=1)


def test_forward_launches_every_kernel(cuda):
    """A small forward on the card launches each kernel (4 kNN, 4 gather,
    2 expansion, 2 MDS) and runs no plain version."""
    model = models.build_generator(num_points=1024, n_primitives=4,
                                   bottleneck_size=128, hide_size=128)
    partial = (torch.rand(2, 300, 3, generator=_gen()) - 0.5)
    _lib.reset_counts()
    outs = models.complete(model, partial)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES == {**dict.fromkeys(_lib.LAUNCHES, 0), "knn": 4,
                             "gather_max": 4, "expansion": 2, "mds": 2}
    assert set(_lib.PLAIN_CALLS.values()) == {0}
    for o in outs[:3]:
        assert o.shape == (2, 1024, 3) and bool(torch.isfinite(o).all())


def _dup_cloud(b, n, g):
    """A cloud in which every point appears twice (exact ties)."""
    half = torch.rand(b, n // 2, 3, generator=g) - 0.5
    return torch.cat([half, half.flip(1)], 1)


@pytest.mark.parametrize("n1,n2,dup", [(16384, 16384, False), (3000, 4096, True),
                                       (129, 2049, False)])
def test_nn_idx_kernel_matches_plain(cuda, n1, n2, dup):
    """Exact indices: both compute fma(dz, dz, fma(dx, dx, dy * dy)) and
    keep the lowest index among equal minima."""
    g = _gen()
    x2 = (_dup_cloud(2, n2, g) if dup else torch.rand(2, n2, 3, generator=g) - 0.5)
    x1 = torch.rand(2, n1, 3, generator=g) - 0.5
    if dup:
        x1[:, :8] = x2[:, :8]
    x1, x2 = x1.to(cuda), x2.to(cuda)
    got = chamfer.nn_idx(x1, x2)
    assert torch.equal(got, chamfer.nn_idx_plain(x1, x2))
    if dup:
        assert torch.equal(got[:, :8].cpu(), torch.arange(8).expand(2, 8).int())


def _nn_edge_case(n2, g):
    """x1 [2, 4096] and x2 [2, n2]: half of x2 repeated (exact ties), the
    first queries on candidates, a NaN query and a NaN candidate."""
    x2 = torch.rand(2, n2, 3, generator=g) - 0.5
    h = n2 // 2
    x2[:, h:2 * h] = x2[:, :h].flip(1)
    x1 = torch.rand(2, 4096, 3, generator=g) - 0.5
    x1[:, :8] = x2[:, :8].flip(1)
    x1[0, 9] = float("nan")
    x2[1, n2 // 3] = float("nan")
    return x1, x2


@pytest.mark.parametrize("n2,splits", [(1, None), (2047, None), (2049, None),
                                       (16384, None), (2049, 1), (2049, 2),
                                       (2049, 3), (16384, 8)])
def test_nn_idx_edges_match_plain(cuda, deterministic, n2, splits):
    """Bit for bit at N2 of one point, around a 2048-candidate tile and at
    the step's 16384, with duplicated points, a NaN query (index 0) and a
    NaN candidate (never picked), at the split count the kernel picks and
    at forced ones (any split count gives the same picks)."""
    x1, x2 = (t.to(cuda) for t in _nn_edge_case(n2, _gen()))
    got = chamfer.nn_idx(x1, x2, _splits=splits)
    assert torch.equal(got, chamfer.nn_idx_plain(x1, x2))
    assert int(got[0, 9]) == 0
    assert not bool((got[1] == n2 // 3).any()) or n2 == 1


@pytest.mark.parametrize("seed", range(3))
def test_nn_idx_near_ties_match_plain(cuda, deterministic, seed):
    """Candidates on shells around the queries whose distances differ by a
    few ulps (tests/test_torch_nn_split.py's input, at 512 queries and
    16384 candidates): bit for bit."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.rand(2, 512, 3, generator=g) - 0.5) * 2
    x2 = _shells(g, q, 32, 0.3, 1e-7)
    q, x2 = q.to(cuda), x2.to(cuda)
    assert torch.equal(chamfer.nn_idx(q, x2), chamfer.nn_idx_plain(q, x2))


@pytest.mark.parametrize("u", [1, 37, 8908, 16384])
def test_bids_kernel_scores_the_counted_bidders(cuda, u):
    """Full-width bidder lists with the counts on the card (the auction's
    rounds): the first count[b] bidders bit for bit against the plain
    version, the rest target 0 and inc 0; duplicated objects at equal
    price tie (lower index, increment 0)."""
    g = _gen()
    n = 16384
    x2 = _dup_cloud(2, n, g)
    x1 = torch.rand(2, n, 3, generator=g) - 0.5
    x1[:, :64] = x2[:, :64]
    price = torch.rand(2, n, generator=g) * 0.02
    price[:, n // 2:] = price[:, :n // 2].flip(1)
    count = torch.tensor([u, max(1, u // 3)], dtype=torch.int32)
    x1, x2, price, count = (t.to(cuda) for t in (x1, x2, price, count))
    t, i = emd.emd_bids(x1, x2, price, count)
    pt, pi = emd.emd_bids_plain(x1, x2, price, count)
    assert torch.equal(t, pt) and torch.equal(i, pi)
    assert bool((t[0, u:] == 0).all()) and bool((i[0, u:] == 0).all())


def test_auction_without_host_reads_matches_the_plain_loop(cuda):
    """The whole auction on the card (full width, counts on the card, no
    host read a round) gives the assignment of the round loop that cuts
    each round's list to a host-read count, on the card and on the CPU
    (plain bids)."""
    g = _gen()
    x1 = torch.rand(2, 2048, 3, generator=g) - 0.5
    x2 = torch.rand(2, 2048, 3, generator=g) - 0.5
    want = _assign_one_read_a_round(x1, x2, 0.005, 50)
    assert torch.equal(emd.auction_assign(x1, x2, 0.005, 50), want)
    a, b = x1.to(cuda), x2.to(cuda)
    assert torch.equal(emd.auction_assign(a, b, 0.005, 50).cpu(), want)
    assert torch.equal(_assign_one_read_a_round(a, b, 0.005, 50).cpu(), want)
    dist, assign = emd.emd_auction(a, b, 0.005, 50)
    assert torch.equal(assign.cpu(), want)
    # a second cloud, the first one's points shuffled: every bidder is
    # assigned early, and the loop stops on the copy of a count of 0
    perm = torch.randperm(2048, generator=g)
    x3 = x1[:, perm] + 1e-4 * (torch.rand(2, 2048, 3, generator=g) - 0.5)
    want = emd.auction_assign(x1, x3, 0.005, 50)
    assert torch.equal(emd.auction_assign(a, x3.to(cuda), 0.005, 50).cpu(), want)


def test_auction_stop_waits_for_the_count_to_arrive(cuda):
    """The stop reads a round's count only once the copy has landed: a
    slot no copy has reached holds -1, and while the card is busy ahead of
    the copy the stop does not fire, even though the count it will bring
    is 0."""
    arrivals = emd._Arrivals(3, cuda)
    assert bool((arrivals.host == -1).all())
    done = torch.zeros((2, 64), dtype=torch.long, device=cuda)  # none left
    torch.cuda._sleep(200_000_000)          # ~0.1 s of the card's clock
    arrivals.record(done)
    assert not arrivals.zero()
    torch.cuda.synchronize()
    assert arrivals.zero()


def test_auction_on_a_card_that_is_not_the_current_one(cuda):
    """The copies and their events on the inputs' card, not the current
    one: an auction on the second card gives the first card's assignment,
    and the stop waits for a copy held back on the second card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    other = torch.device("cuda", 1)
    g = _gen()
    x1 = torch.rand(2, 1024, 3, generator=g) - 0.5
    x2 = torch.rand(2, 1024, 3, generator=g) - 0.5
    with torch.cuda.device(0):
        want = emd.auction_assign(x1.to(cuda), x2.to(cuda), 0.005, 50).cpu()
        got = emd.auction_assign(x1.to(other), x2.to(other), 0.005, 50).cpu()
        assert torch.equal(got, want)
        arrivals = emd._Arrivals(2, other)
        with torch.cuda.device(other):
            torch.cuda._sleep(200_000_000)
        arrivals.record(torch.zeros((2, 64), dtype=torch.long, device=other))
        assert not arrivals.zero()
        torch.cuda.synchronize(other)
        assert arrivals.zero()


@pytest.mark.parametrize("m,n,dup", [(16384, 16384, False), (1000, 4096, True),
                                     (257, 300, False)])
def test_bids_kernel_matches_plain(cuda, m, n, dup):
    """Exact targets and increments (IEEE sqrt on both sides); duplicated
    objects at equal price tie: lower index, increment 0."""
    g = _gen()
    x2 = (_dup_cloud(2, n, g) if dup else torch.rand(2, n, 3, generator=g) - 0.5)
    x1 = torch.rand(2, m, 3, generator=g) - 0.5
    price = torch.rand(2, n, generator=g) * 0.02
    if dup:
        price[:, n // 2:] = price[:, :n // 2].flip(1)
    x1, x2, price = x1.to(cuda), x2.to(cuda), price.to(cuda)
    t, i = emd.emd_bids(x1, x2, price)
    pt, pi = emd.emd_bids_plain(x1, x2, price)
    assert torch.equal(t, pt) and torch.equal(i, pi)
    if dup:
        assert bool((i == 0).all()) and bool((t < n // 2).all())


@pytest.mark.parametrize("n,c,k,shift", [(3000, 256, 8, False),
                                         (3000, 512, 8, False),
                                         (3000, 1024, 8, False), (77, 8, 8, False),
                                         (300, 3, 8, False), (3000, 3, 20, False),
                                         (500, 130, 16, False),
                                         (3000, 256, 16, False),
                                         (4000, 256, 8, False),
                                         (400, 64, 33, True), (200, 7, 20, True)])
def test_edge_stats_kernels_match_plain(cuda, deterministic, n, c, k, shift):
    """Forward outputs and the table gradient bit for bit, with duplicated
    slots and rows (max and min ties take the first slot); also at
    C % 4 != 0, k > 15 (wide route codes), N = 4000 (the inverse lists in
    device memory) and a table not 16-byte aligned."""
    g = _gen()
    table = torch.randn(2, n, c, generator=g)
    table[:, 1] = table[:, 0]
    idx = torch.randint(0, n, (2, n, k), generator=g, dtype=torch.int32)
    idx[:, :, k - 1] = idx[:, :, 0]
    idx[:, :4] = torch.arange(k, dtype=torch.int32) % 2
    grads = [torch.randn(2, n, c, generator=g).to(cuda) for _ in range(4)]
    table, idx = table.to(cuda), idx.to(cuda)
    if shift:
        table = _unaligned(table)
    outs = edge_gather.edge_stats_fwd(table, idx)
    for o, w in zip(outs, edge_gather.edge_stats_fwd_plain(table, idx)):
        assert torch.equal(o, w)
    got = edge_gather.edge_stats_bwd(table, idx, outs[0], outs[1], *grads)
    want = edge_gather.edge_stats_bwd_plain(table, idx, outs[0], outs[1], *grads)
    assert torch.equal(got, want)


def test_edge_stats_lists_path(cuda):
    """The inverse lists are built in shared memory at the model's 3000
    points and k = 8, in device memory at 4000."""
    assert edge_gather.lists_scratch_ints(4, 3000, 3000, 8) == 0
    assert edge_gather.lists_scratch_ints(4, 4000, 4000, 8) == 4 * 9 * 4000


def test_train_step_launches_every_kernel(cuda):
    """A small training step on the card launches each kernel of the step
    and runs no plain version; the loss is finite."""
    model = models.build_generator(num_points=1024, n_primitives=2,
                                   bottleneck_size=128, hide_size=128)
    opt = base.make_optimizer(model, sparenet.CONFIG)
    g = _gen()
    partial = torch.rand(2, 300, 3, generator=g) - 0.5
    gt = torch.rand(2, 1024, 3, generator=g) - 0.5
    _lib.reset_counts()
    loss, _, _ = sparenet.train_step(model, opt, partial, gt, 1e-4)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    for name in ("knn", "expansion", "mds", "nn_idx", "emd_bids",
                 "edge_stats_fwd", "edge_stats_bwd"):
        assert _lib.LAUNCHES[name] > 0, name
    assert _lib.LAUNCHES["gather_max"] == 0     # eval arm only
    assert set(_lib.PLAIN_CALLS.values()) == {0}


def _splat_case(g, b, n, h, w):
    """n points an image around and beyond the image, 1/8 on pixel centres
    (exact ties), 1/8 duplicated, features in [-0.2, 1)."""
    pts = torch.rand(b, n, 2, generator=g) * torch.tensor([h + 8.0, w + 8.0]) - 4
    q = n // 8
    pts[:, :q] = pts[:, :q].round()
    pts[:, q:2 * q] = pts[:, 2 * q:3 * q]
    f = torch.rand(b, n, 1, generator=g) * 1.2 - 0.2
    f[:, q:2 * q] = f[:, 2 * q:3 * q]
    binds = torch.arange(b, dtype=torch.int32).repeat_interleave(n)
    return pts.reshape(-1, 2), f.reshape(-1, 1), binds


@pytest.mark.parametrize("radius,h,w", [(5.0, 256, 256), (7.0, 256, 256),
                                        (10.0, 256, 256), (2.5, 37, 53)])
def test_p2i_kernel_matches_plain(cuda, radius, h, w):
    """Values and winner ids bit for bit, with and without ids, exact ties
    and duplicated points included."""
    pts, f, binds = (t.to(cuda) for t in _splat_case(_gen(), 6, 4000, h, w))
    for with_ids in (True, False):
        got = p2i.p2i_max(pts, f, binds, 6, h, w, radius, with_ids)
        want = p2i.p2i_max_plain(pts, f, binds, 6, h, w, radius, with_ids)
        assert torch.equal(got[0], want[0])
        if with_ids:
            assert torch.equal(got[1], want[1])
            assert bool((got[1] >= 0).any())
        else:
            assert got[1] is None


def _crowded(g, b, h, w):
    """A crowded tile: 4000 points within 6 pixels of one spot of image 0
    (its bin splits over many work items), among 500 an image elsewhere."""
    pts, f, binds = _splat_case(g, b, 500, h, w)
    crowd = torch.rand(4000, 2, generator=g) * 6 + torch.tensor([h / 3, w / 2])
    crowd[:500] = crowd[500:1000]
    return (torch.cat([pts, crowd]),
            torch.cat([f, torch.rand(4000, 1, generator=g)]),
            torch.cat([binds, torch.zeros(4000, dtype=torch.int32)]))


@pytest.mark.parametrize("radius", [4.5, 5.0, 7.0, 10.0])
@pytest.mark.parametrize("case", ["grouped", "scrambled", "crowded", "64 points"])
def test_p2i_tiles_match_plain(cuda, radius, case):
    """Values and winner ids bit for bit, with and without ids, at the
    kernel's tiles and work items and at small ones (16 x 32 tiles,
    windows wider than a tile at R = 10, 512 window pixels an item: most
    bins split): image-major binds, scrambled binds (invalid ones
    included), a crowded tile, and 64 points."""
    g = _gen()
    b, h, w = 4, 256, 256
    if case == "crowded":
        pts, f, binds = _crowded(g, b, h, w)
    else:
        pts, f, binds = _splat_case(g, b, 16 if case == "64 points" else 3000, h, w)
    if case == "scrambled":
        binds = binds[torch.randperm(len(binds), generator=g)].contiguous()
        binds[::17] = torch.tensor([-1, b], dtype=torch.int32).repeat(
            (len(binds[::17]) + 1) // 2)[:len(binds[::17])]
    pts, f, binds = (t.to(cuda) for t in (pts, f, binds))
    for with_ids in (True, False):
        want = p2i.p2i_max_plain(pts, f, binds, b, h, w, radius, with_ids)
        for tile, item in ((p2i.TILE, p2i.ITEM_PIXELS), ((16, 32), 512)):
            got = p2i.p2i_max(pts, f, binds, b, h, w, radius, with_ids,
                              _tile=tile, _item_pixels=item)
            assert torch.equal(got[0], want[0]), (tile, with_ids)
            if with_ids:
                assert torch.equal(got[1], want[1]), tile


def test_p2i_no_points(cuda):
    """No points: a zero image and ids -1 (every tile is written)."""
    z = torch.zeros(0, 2, device=cuda)
    out, ids = p2i.p2i_max(z, z[:, :1], torch.zeros(0, dtype=torch.int32,
                                                     device=cuda), 2, 40, 70, 5.0)
    assert not bool(out.any()) and bool((ids == -1).all())


def test_gan_step_launches_every_kernel(cuda, monkeypatch):
    """A small GAN step on the card (B=2, img 64) launches each kernel of the
    step, p2i three times and its backward once, and runs no plain version;
    losses finite."""
    monkeypatch.setitem(sparenet_gan.CONFIG, "img_size", 64)
    gen = models.build_generator(num_points=1024, n_primitives=2,
                                 bottleneck_size=128, hide_size=128)
    disc = models.build_discriminator(image_size=64)
    opts = [base.make_optimizer(m, sparenet_gan.CONFIG) for m in (gen, disc)]
    g = _gen()
    partial = torch.rand(2, 300, 3, generator=g) - 0.5
    gt = torch.rand(2, 1024, 3, generator=g) - 0.5
    _lib.reset_counts()
    losses = sparenet_gan.gan_step(gen, disc, *opts, partial, gt,
                                   torch.zeros(2, dtype=torch.int32), 1e-4,
                                   7.0, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v)) for v in losses)
    for name in ("knn", "expansion", "mds", "nn_idx", "emd_bids",
                 "edge_stats_fwd", "edge_stats_bwd"):
        assert _lib.LAUNCHES[name] > 0, name
    assert _lib.LAUNCHES["p2i"] == 3
    assert _lib.LAUNCHES["p2i_bwd"] == 1
    assert set(_lib.PLAIN_CALLS.values()) == {0}


# ---------------------------------------------------------------------------
# serving mode: packed kNN, the MDS continuation, the p2i backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,n", [(3, 3000), (256, 3000), (512, 3000), (40, 129)])
def test_knn_packed_kernel_matches_plain(cuda, c, n):
    """Exact indices: both sum the bf16 products and the norms in channel
    order, and the keys are unique."""
    x = torch.randn(2, n, c, generator=_gen()).to(cuda)
    assert torch.equal(knn.knn_idx(x, 8, packed=True),
                       knn.knn_packed_plain(x, 8))


def test_knn_packed_kernel_lowest_index_on_ties(cuda):
    base = torch.rand(1, 40, 3, generator=_gen())
    x = torch.cat([base, base, base[:, :10]], 1).to(cuda)
    got = knn.knn_idx(x, 8, packed=True)
    assert torch.equal(got, knn.knn_packed_plain(x, 8))
    assert got[0, 45, :3].tolist() == [5, 45, 85]


def _prefix_state(xyz, mml, npick, g):
    """The live lanes a batched prefix of npick picks leaves, as the hybrid
    arm hands them to its tail."""
    _, temp = mds.mds_batched(xyz, npick, mml, g=g, schedule=(),
                              return_state=True)
    return mds.compact_live(xyz, temp, xyz.shape[1] - npick)


@pytest.mark.parametrize("n,npick,steps,g", [(19384, 14336, 2048, 8192),
                                             (3000, 1000, 700, 256)])
def test_mds_continue_kernel_matches_plain(cuda, n, npick, steps, g):
    """Exact lane indices on prefix states, with duplicated points (exact
    density ties) in the cloud."""
    gen = _gen()
    half = torch.rand(2, n // 2, 3, generator=gen) - 0.5
    xyz = torch.cat([half, half[:, :n - n // 2]], 1).contiguous().to(cuda)
    mml = torch.tensor([0.006, 0.012], device=cuda)
    xc, tc, orig = _prefix_state(xyz, mml, npick, g)
    got = mds.mds_continue(xc, tc, orig, mml, steps)
    assert torch.equal(got, mds.mds_continue_plain(xc, tc, orig, mml, steps))
    assert _lib.LAUNCHES["mds_continue"] > 0


@pytest.mark.parametrize("n,steps", [(8000, 600), (20000, 300)])
def test_mds_continue_kernel_past_5120_lanes(cuda, n, steps):
    """Live-lane counts past the first design's 5120 (20 and 40 lanes a
    thread) against the plain version, bit for bit."""
    gen = _gen()
    xyz = (torch.rand(2, n, 3, generator=gen) - 0.5).to(cuda)
    temp = (torch.rand(2, n, generator=gen) * 0.01).to(cuda)
    orig = torch.arange(2 * n, dtype=torch.int32).reshape(2, n).to(cuda)
    mml = torch.tensor([0.006, 0.012], device=cuda)
    got = mds.mds_continue(xyz, temp, orig, mml, steps)
    assert torch.equal(got, mds.mds_continue_plain(xyz, temp, orig, mml, steps))


def test_mds_continue_kernel_lowest_lane_on_ties(cuda):
    """All densities 0 and far-apart points: the picks are the lanes in
    order, as the plain version's argmin."""
    xyz = (torch.arange(300, dtype=torch.float32)[None, :, None]
           * torch.ones(1, 1, 3)).to(cuda).contiguous()
    temp = torch.zeros(1, 300, device=cuda)
    orig = torch.arange(8000, 8300, dtype=torch.int32, device=cuda)[None]
    mml = torch.tensor([0.01], device=cuda)
    got = mds.mds_continue(xyz, temp, orig, mml, 64)
    assert torch.equal(got, mds.mds_continue_plain(xyz, temp, orig, mml, 64))
    assert got[0].tolist() == list(range(64))


@pytest.mark.parametrize("n,npick,steps,b", [(19384, 14336, 2048, 4),
                                             (3000, 1000, 700, 2),
                                             (30000, 2000, 1000, 1)])
def test_mds_continue_every_cluster_size_and_stage(cuda, n, npick, steps, b):
    """Every cluster size C = 1..16 that holds the lanes, with compaction
    every 1024 and 96 steps and none, picks bit for bit what the plain
    version picks, on prefix states with duplicated points (exact ties;
    28000 lanes need C >= 2); so does the shape the wrapper chooses."""
    gen = _gen()
    half = torch.rand(b, n // 2, 3, generator=gen) - 0.5
    xyz = torch.cat([half, half[:, :n - n // 2]], 1).contiguous().to(cuda)
    mml = (0.004 + 0.01 * torch.rand(b, generator=gen)).to(cuda)
    xc, tc, orig = _prefix_state(xyz, mml, npick, 8192)
    want = mds.mds_continue_plain(xc, tc, orig, mml, steps)
    first = 1 if xc.shape[1] <= 20480 else 2
    for c in range(first, 17):
        for stage in (1024, 96, 0):
            got = mds.mds_continue(xc, tc, orig, mml, steps, _cluster=c,
                                   _stage=stage)
            assert torch.equal(got, want), (c, stage)
    c, per_sm = mds.continue_cluster_size(b, xc.shape[1])
    assert first <= c <= 16 and per_sm in (1, 2)
    assert torch.equal(mds.mds_continue(xc, tc, orig, mml, steps), want)


def test_mds_continue_nan_inf_and_zero_temperature(cuda):
    """t = 0, a NaN, -inf, -0, 1e9 and inf in temp0: compaction stays off
    where it must, and every C equals the plain version (picks repeat
    where a picked lane wins again)."""
    g = _gen()
    xyz = torch.rand(4, 3000, 3, generator=g) - 0.5
    xyz[0, 1000:1100] = xyz[0, :100]
    temp = torch.rand(4, 3000, generator=g) * 0.01 + 1e-3
    temp[1, 77], temp[1, 5] = float("nan"), float("-inf")
    temp[2, 300:] = float("inf")
    temp[2, 200:300] = 1e9
    temp[3, 60], temp[3, 40] = -0.0, 0.0
    orig = torch.arange(7000, 10000, dtype=torch.int32).repeat(4, 1)
    xyz, temp, orig = (t.contiguous().to(cuda) for t in (xyz, temp, orig))
    mml = torch.tensor([0.0, 0.01, 0.01, 0.01], device=cuda)
    want = mds.mds_continue_plain(xyz, temp, orig, mml, 400)
    assert want[1, :2].tolist() == [77, 5] and int(want[3, 0]) == 40
    for c in (1, 3, 16):
        got = mds.mds_continue(xyz, temp, orig, mml, 400, _cluster=c, _stage=16)
        assert torch.equal(got, want), c


@pytest.mark.parametrize("c", [1, 4, 16])
def test_mds_continue_floor_runs(cuda, c):
    """The continuation's latency floor launches at each cluster size and
    writes a lane index for every step."""
    g = _gen()
    xyz = (torch.rand(4, 5048, 3, generator=g) - 0.5).to(cuda)
    temp = torch.zeros(4, 5048, device=cuda)
    orig = torch.arange(5048, dtype=torch.int32, device=cuda).repeat(4, 1)
    out = mds.mds_continue_floor(xyz, temp, orig, torch.full((4,), 0.01,
                                                             device=cuda), 512, c)
    torch.cuda.synchronize()
    assert out.shape == (4, 512)
    assert bool(((out >= 0) & (out < 5048)).all())


@pytest.mark.parametrize("radius", [5.0, 7.0, 10.0, 2.5])
def test_p2i_backward_kernel_matches_plain(cuda, radius):
    """Within 1e-6 of the largest entry (the plain version's index_add_ sums
    each point's pixels in another order, with atomics outside
    deterministic mode), and two launches bit for bit equal."""
    h = w = 64 if radius == 2.5 else 256
    pts, f, binds = (t.to(cuda) for t in _splat_case(_gen(), 6, 4000, h, w))
    _, ids = p2i.p2i_max(pts, f, binds, 6, h, w, radius, True)
    g = torch.randn(6, h, w, 1, generator=_gen()).to(cuda)
    got = p2i.p2i_max_backward(pts, f, binds, ids, g, radius)
    want = p2i.p2i_max_backward_plain(pts, f, binds, ids, g, radius)
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-6 * scale
    again = p2i.p2i_max_backward(pts, f, binds, ids, g, radius)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _gan_splat(g, b):
    """The GAN step's renderer layout: b clouds x 8 views of 16384 points
    projected into 256 x 256 images, image-major."""
    from sparenet_tpu_torch.renderer import ComputeDepthMaps
    r = ComputeDepthMaps(image_size=256)
    pix, feat = r._project(torch.rand(b, 16384, 3, generator=g) - 0.5,
                           r.matrices[:, None])
    binds = torch.arange(b * 8, dtype=torch.int32).repeat_interleave(16384)
    return (pix.transpose(0, 1).reshape(-1, 2).contiguous(),
            feat.transpose(0, 1).reshape(-1, 1).contiguous(), binds)


def test_p2i_backward_kernel_at_the_gan_shape(cuda):
    """The B=4 GAN step's shape at R = 10: within 1e-6 of the plain
    version, two launches bit for bit equal."""
    pts, f, binds = (t.to(cuda) for t in _gan_splat(_gen(), 4))
    _, ids = p2i.p2i_max(pts, f, binds, 32, 256, 256, 10.0, True)
    g = torch.randn(32, 256, 256, 1, generator=_gen()).to(cuda)
    got = p2i.p2i_max_backward(pts, f, binds, ids, g, 10.0)
    want = p2i.p2i_max_backward_plain(pts, f, binds, ids, g, 10.0)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    again = p2i.p2i_max_backward(pts, f, binds, ids, g, 10.0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("radius", [2.5, 10.0, 40.0])
def test_p2i_backward_edges_and_tiles(cuda, radius):
    """Points off the image, NaN points, invalid and scrambled image
    indices, at the kernel's plan and at forced tiles, work items and the
    scan path: every plan bit for bit equal to the default, and the default
    within 1e-6 of the plain version's largest entry (1e-5 at R = 40, where
    a point sums up to K^2 = 6724 pixels: the plain version's index_add_
    adds them in another order, with atomics)."""
    h, w = 96, 160
    pts, f, binds = _splat_case(_gen(), 3, 1500, h, w)
    pts[:10] = pts[:10] * 40 - 2000
    pts[10:14] = float("nan")
    binds = binds.clone()
    binds[20:30] = torch.tensor([-1, 3, 7, -5, 2, 0, 1, 2, 0, 1], dtype=torch.int32)
    perm = torch.randperm(len(binds), generator=_gen())
    pts, f, binds = (t[perm].contiguous().to(cuda) for t in (pts, f, binds))
    _, ids = p2i.p2i_max(pts, f, binds, 3, h, w, radius, True)
    g = torch.randn(3, h, w, 1, generator=_gen()).to(cuda)
    got = p2i.p2i_max_backward(pts, f, binds, ids, g, radius)
    want = p2i.p2i_max_backward_plain(pts, f, binds, ids, g, radius)
    rtol = 1e-5 if radius > 10 else 1e-6
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= rtol * scale
    for tile, item, path in (((8, 32), 1, None), ((16, 64), 33, None),
                             ((32, 128), 1000, "scan"), ((8, 32), 7, "scan")):
        other = p2i.p2i_max_backward(pts, f, binds, ids, g, radius, _tile=tile,
                                     _item=item, _path=path)
        assert all(torch.equal(a, b) for a, b in zip(got, other)), (tile, item, path)


@pytest.mark.parametrize("arm", ["batched", "hybrid", "exact", "auto"])
def test_serving_forward_launches_its_kernels(cuda, arm):
    """A B=2 serving forward launches the packed kNN 4 times, gather-max 4
    times, MDS 2 times (exact, and "auto", which is exact off the TPU) or
    the continuation 2 times (hybrid), no expansion and no plain version;
    outputs finite, loss_mst 0."""
    model = models.build_generator(num_points=2048, n_primitives=4,
                                   bottleneck_size=128, hide_size=128,
                                   serving=True, mds=arm, mds_g=512,
                                   mds_schedule=(128,), mds_tail=256)
    partial = torch.rand(2, 300, 3, generator=_gen()) - 0.5
    _lib.reset_counts()
    outs = models.complete(model, partial)
    torch.cuda.synchronize()
    want = {"knn_packed": 4, "gather_max": 4,
            "mds": 2 if arm in ("exact", "auto") else 0,
            "mds_continue": 2 if arm == "hybrid" else 0}
    assert _lib.LAUNCHES == {**dict.fromkeys(_lib.LAUNCHES, 0), **want}
    assert set(_lib.PLAIN_CALLS.values()) == {0}
    for o in outs[:3]:
        assert o.shape == (2, 2048, 3) and bool(torch.isfinite(o).all())
    assert float(outs[3]) == 0.0
