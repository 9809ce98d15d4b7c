"""The PyTorch port's ops (plain versions, on the CPU) against the JAX package.

Inputs are made from a seed with numpy and given to both packages as numpy
arrays. On the CPU every port wrapper runs its plain PyTorch version, and the
JAX package resolves to its XLA paths, as its own CPU tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.ops.common import pairwise_sqdist_graph as jax_sqdist_graph
from sparenet_tpu.ops.expansion_penalty import (_mst_parents_xla,
                                                _prune_edges)
from sparenet_tpu.ops.expansion_penalty import \
    expansion_penalty as jax_expansion
from sparenet_tpu.ops.knn import knn_idx as jax_knn
from sparenet_tpu.ops.mds import gather_points as jax_gather_points
from sparenet_tpu.ops.mds import minimum_density_sample as jax_mds
from sparenet_tpu_torch.ops import _lib, common, gather, knn, mds
from sparenet_tpu_torch.ops import expansion_penalty as port_expansion

jax.config.update("jax_platforms", "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# kNN graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,n,k", [
    pytest.param(3, 300, 8, id="3-300"), pytest.param(16, 200, 8, id="16-200"),
    pytest.param(40, 120, 8, id="40-120"),
    pytest.param(3, 300, 1, id="3-300-k1"), pytest.param(16, 200, 16, id="16-200-k16"),
    pytest.param(40, 120, 20, id="40-120-k20")])
def test_knn_matches_jax(rng, c, n, k):
    """Index equality (exact) on random inputs, at the model's k = 8 and at
    other k (the CUDA kernels take k <= 32)."""
    x = rng.randn(2, n, c).astype(np.float32)
    want = np.asarray(jax_knn(jnp.asarray(x), k))
    got = knn.knn_idx(_t(x), k)
    assert got.dtype == torch.int32 and got.shape == (2, n, k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_knn_duplicate_points_take_lowest_index(rng):
    """Exact ties (duplicated points) go to the lowest index, as in JAX."""
    base = rng.rand(1, 40, 3).astype(np.float32)
    x = np.concatenate([base, base, base[:, :10]], axis=1)   # 3 copies of 10
    want = np.asarray(jax_knn(jnp.asarray(x), 8))
    got = knn.knn_idx(_t(x), 8).numpy()
    np.testing.assert_array_equal(got, want)
    # point 45 duplicates points 5 and 85: its list starts 5, 45, 85
    np.testing.assert_array_equal(got[0, 45, :3], [5, 45, 85])


def test_graph_distance_matches_jax_split(rng):
    """The 3-term bf16 split distance: agrees with JAX's to f32 rounding of
    its terms (atol 1e-6 * max(|x|^2 + |y|^2): a few ulps of the largest
    term, whose sums the two packages associate differently), and is not
    the plain fp32 distance."""
    x = rng.randn(1, 64, 32).astype(np.float32)
    want = np.asarray(jax_sqdist_graph(jnp.asarray(x[0]), jnp.asarray(x[0])))
    got = common.pairwise_sqdist_graph(_t(x), _t(x))[0].numpy()
    terms = 2 * (x[0] ** 2).sum(-1).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * terms)
    plain = ((x[0][:, None] - x[0][None]) ** 2).sum(-1)
    assert np.abs(got - plain).max() > 1e-4


# ---------------------------------------------------------------------------
# gather + max
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [4, 32, 256])
def test_gather_max_matches_jax(rng, c):
    """Max bitwise equal to take_along_axis + max; sum to rtol 1e-6."""
    b, n, m, k = 2, 50, 40, 8
    table = rng.randn(b, n, c).astype(np.float32)
    idx = rng.randint(0, n, (b, m, k)).astype(np.int32)
    rows = jnp.take_along_axis(jnp.asarray(table)[:, :, None, :],
                               jnp.asarray(idx)[..., None], axis=1)
    want_max = np.asarray(jnp.max(rows, axis=2))
    want_sum = np.asarray(jnp.sum(rows, axis=(1, 2)))
    got_max, got_sum = gather.gather_max(_t(table), _t(idx), need_sum=True)
    np.testing.assert_array_equal(got_max.numpy(), want_max)
    np.testing.assert_allclose(got_sum.numpy(), want_sum, rtol=1e-6,
                               atol=1e-6 * np.abs(want_sum).max())
    np.testing.assert_array_equal(gather.gather_max(_t(table), _t(idx)).numpy(),
                                  want_max)


# ---------------------------------------------------------------------------
# expansion penalty
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,n_prim", [(64, 4), (512, 1)])
def test_expansion_matches_jax(rng, s, n_prim):
    """parent, charged, assignment exact; cost, dist, mean MST length to
    atol 1e-6."""
    xyz = (rng.rand(2, s * n_prim, 3) - 0.5).astype(np.float32)
    prims = jnp.asarray(xyz.reshape(-1, s, 3))
    j_parent, j_cost = _mst_parents_xla(prims)
    j_charged = np.asarray(_prune_edges(j_parent, j_cost, s))
    j_dist, j_assign, j_mml = jax_expansion(jnp.asarray(xyz), s, 1.5)

    parent, cost, charged = port_expansion.mst_charges(_t(xyz.reshape(-1, s, 3)))
    np.testing.assert_array_equal(parent.numpy(), np.asarray(j_parent))
    np.testing.assert_array_equal(charged.numpy()[:, 1:], j_charged)
    np.testing.assert_allclose(cost.numpy(), np.asarray(j_cost), atol=1e-6)

    dist, assign, mml = port_expansion.expansion_penalty(_t(xyz), s, 1.5)
    np.testing.assert_allclose(dist.numpy(), np.asarray(j_dist), atol=1e-6)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(j_assign))
    np.testing.assert_allclose(mml.numpy(), np.asarray(j_mml), atol=1e-6)
    assert (assign.numpy() >= 0).any()   # some edges are penalised


# ---------------------------------------------------------------------------
# minimum-density sampling and gather_points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,npoint", [(320, 256), (8300, 64)])
def test_mds_matches_jax(rng, n, npoint):
    """Exact indices. N=8300 reaches the 2x weight of index >= 8192, and
    its far points add density terms below the smallest normal f32, which
    the reference flushes to 0."""
    xyz = (rng.rand(2, n, 3) - 0.5).astype(np.float32)
    mml = np.array([0.05, 0.08], np.float32)
    want = np.asarray(jax_mds(jnp.asarray(xyz), npoint, jnp.asarray(mml)))
    got = mds.minimum_density_sample(_t(xyz), npoint, _t(mml))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_points_matches_jax(rng):
    feats = rng.randn(2, 30, 4).astype(np.float32)
    idx = rng.randint(0, 30, (2, 12)).astype(np.int32)
    want = np.asarray(jax_gather_points(jnp.asarray(feats), jnp.asarray(idx)))
    np.testing.assert_array_equal(mds.gather_points(_t(feats), _t(idx)).numpy(),
                                  want)


# ---------------------------------------------------------------------------
# wrapper contract
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions(rng):
    _lib.reset_counts()
    x = _t(rng.randn(1, 20, 3).astype(np.float32))
    idx = knn.knn_idx(x, 8)
    gather.gather_max(x, idx)
    port_expansion.mst_charges(x)
    mds.minimum_density_sample(x, 5, torch.tensor([0.1]))
    assert _lib.PLAIN_CALLS == {**dict.fromkeys(_lib.PLAIN_CALLS, 0),
                                "knn": 1, "gather_max": 1, "expansion": 1,
                                "mds": 1}
    assert set(_lib.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("case", ["dtype", "rank", "contiguity", "last_dim"])
def test_wrappers_reject_what_they_do_not_take(case):
    x = torch.zeros(2, 16, 3)
    bad = {"dtype": x.double(), "rank": x[0],
           "contiguity": x.transpose(0, 1), "last_dim": torch.zeros(2, 16, 4)}[case]
    with pytest.raises((TypeError, ValueError)):
        if case == "last_dim":
            port_expansion.mst_charges(bad)
        else:
            knn.knn_idx(bad, 8)


def test_kernel_build_fails_loudly_without_nvcc(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(_lib.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib.nvcc_command(_lib.BUILD_DIR / "lib.so")
