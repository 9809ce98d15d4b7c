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
from sparenet_tpu_torch.ops import _lib, expansion_penalty, gather, knn, mds
from sparenet_tpu_torch.ops.common import pairwise_sqdist_graph

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, or a skip. Decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    models.set_parity_mode()
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("c,n", [(3, 3000), (256, 3000), (40, 129)])
def test_knn_kernel_matches_plain(cuda, c, n):
    """Index mismatches only at near-ties: the distance gap of each is
    within 1e-5 of |x|^2 + |y|^2 (the two sum the same terms in another
    order)."""
    x = torch.randn(2, n, c, generator=_gen()).to(cuda)
    got = knn.knn_idx(x, 8).long()
    want = knn.knn_plain(x, 8).long()
    d = pairwise_sqdist_graph(x, x)
    gap = (d.gather(2, got) - d.gather(2, want)).abs()
    x2 = (x * x).sum(-1)
    scale = x2[:, :, None] + x2.gather(1, want.reshape(2, -1)).reshape(want.shape)
    assert bool((gap <= 1e-5 * scale).all())
    assert (got != want).float().mean() < 1e-3


def test_knn_kernel_lowest_index_on_ties(cuda):
    base = torch.rand(1, 40, 3, generator=_gen())
    x = torch.cat([base, base, base[:, :10]], 1).to(cuda)
    np.testing.assert_array_equal(knn.knn_idx(x, 8).cpu().numpy(),
                                  knn.knn_plain(x, 8).cpu().numpy())


@pytest.mark.parametrize("c", [4, 256, 1024])
def test_gather_max_kernel_matches_plain(cuda, c):
    """max exact; sum to rtol 1e-5 (+1e-6 of sum |rows| for cancellation)."""
    g = _gen()
    table = torch.randn(2, 700, c, generator=g).to(cuda)
    idx = torch.randint(0, 700, (2, 650, 8), generator=g, dtype=torch.int32).to(cuda)
    out, s = gather.gather_max(table, idx, need_sum=True)
    pout, ps = gather.gather_max_plain(table, idx, need_sum=True)
    assert torch.equal(out, pout)
    abs_sum = gather.gather_rows(table.abs(), idx).sum((1, 2))
    assert bool(((s - ps).abs() <= 1e-5 * ps.abs() + 1e-6 * abs_sum).all())
    assert torch.equal(gather.gather_max(table, idx), pout)


@pytest.mark.parametrize("bp,s", [(8, 64), (16, 512), (3, 1000)])
def test_expansion_kernel_matches_plain(cuda, bp, s):
    """parent and charged exact, cost to atol 1e-6."""
    xyz = (torch.rand(bp, s, 3, generator=_gen()) * 2 - 1).to(cuda)
    par, cost, chg = expansion_penalty.mst_charges(xyz)
    ppar, pcost, pchg = expansion_penalty.mst_charges_plain(xyz)
    assert torch.equal(par, ppar) and torch.equal(chg, pchg)
    assert float((cost - pcost).abs().max()) <= 1e-6


@pytest.mark.parametrize("n,npoint", [(320, 256), (8300, 300), (19384, 600)])
def test_mds_kernel_matches_plain(cuda, n, npoint):
    """Exact indices."""
    xyz = (torch.rand(2, n, 3, generator=_gen()) - 0.5).to(cuda)
    mml = torch.tensor([0.02, 0.05], device=cuda)
    assert torch.equal(mds.minimum_density_sample(xyz, npoint, mml),
                       mds.mds_plain(xyz, npoint, mml))


def test_forward_launches_every_kernel(cuda):
    """A small forward on the card launches each kernel (4 kNN, 4 gather,
    2 expansion, 2 MDS) and runs no plain version."""
    model = models.build_generator(num_points=1024, n_primitives=4,
                                   bottleneck_size=128, hide_size=128)
    partial = (torch.rand(2, 300, 3, generator=_gen()) - 0.5)
    _lib.reset_counts()
    outs = models.complete(model, partial)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES == {"knn": 4, "gather_max": 4, "expansion": 2, "mds": 2}
    assert set(_lib.PLAIN_CALLS.values()) == {0}
    for o in outs[:3]:
        assert o.shape == (2, 1024, 3) and bool(torch.isfinite(o).all())
