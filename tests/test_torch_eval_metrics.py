"""The port's evaluation metrics against the JAX package's.

The port's chamfer NN (#6) and auction bids (#8) follow the TPU kernels,
which take squared distances from coordinate differences; the JAX package's
CPU paths use the |x|^2 + |y|^2 - 2xy expansion instead and may pick
another neighbour or bid at a near-tie (ROADMAP.md section 3). So the JAX
metrics run here with their NN search and bids routed through the Pallas
kernels in interpret mode, as on the TPU (jit caches cleared before and
after, so that no trace made without the patches is reused and none made
with them outlives the test; the bid kernel's tiles take clouds of a
multiple of 256 points). Then the indices and
distances are the same, and the metrics differ only by the order of their
f32 means (CD and EMD) and XLA's fused rounding of 2pr / (p + r) from the
same counts (F-Score): all to rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.ops import chamfer as jax_chamfer
from sparenet_tpu.ops import emd as jax_emd
from sparenet_tpu.ops.pallas import emd_pallas
from sparenet_tpu.ops.pallas.chamfer_pallas import nn_idx_pallas
from sparenet_tpu.utils import metrics as jax_metrics
from sparenet_tpu_torch.ops import _lib
from sparenet_tpu_torch.utils import metrics as port_metrics

jax.config.update("jax_platforms", "cpu")


def _nn_interpret(x, y):
    """The TPU branch of the JAX package's _nn_batched, interpret mode."""
    idx = nn_idx_pallas(x, y, interpret=True)
    diff = x - jnp.take_along_axis(y, idx[..., None], axis=1)
    return jnp.sum(diff * diff, axis=-1), idx


@pytest.fixture
def tpu_kernels(monkeypatch):
    monkeypatch.setattr(jax_chamfer, "_nn_batched", _nn_interpret)
    monkeypatch.setattr(jax_emd, "_use_pallas_bids", lambda n: True)

    pallas_bids = emd_pallas.emd_bids_pallas

    def bids(x1, x2, price, **kw):
        return pallas_bids(x1, x2, price, interpret=True, oc=x2.shape[1])
    monkeypatch.setattr(emd_pallas, "emd_bids_pallas", bids)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _clouds(seed, b, n, scale=1.0, near=0.0):
    """gt a cloud of n points in [-0.5, 0.5]^3 * scale; pred gt moved by
    Gaussian noise of sd ``near`` (so that F-Score is neither 0 nor 1)
    plus a share of fresh points."""
    rng = np.random.RandomState(seed)
    gt = ((rng.rand(b, n, 3) - 0.5) * scale).astype(np.float32)
    pred = gt[:, rng.permutation(n)] + rng.randn(b, n, 3).astype(np.float32) * near
    pred[:, : n // 5] = (rng.rand(b, n // 5, 3) - 0.5) * scale
    return pred.astype(np.float32), gt


CASES = [(0, 2, 300, 0.1, 0.004), (1, 1, 520, 1.0, 0.003)]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c[0]}")
def test_f_score_and_chamfer_match_jax(tpu_kernels, case):
    seed, b, n, scale, near = case
    pred, gt = _clouds(seed, b, n, scale, near)
    for th in (0.002, 0.01):
        want = np.asarray(jax_metrics.f_score(jnp.asarray(pred), jnp.asarray(gt), th))
        got = port_metrics.f_score(_t(pred), _t(gt), th).numpy()
        assert got.dtype == np.float32 and got.shape == (b,)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert 0 < want.min() and want.max() < 1       # at th 0.01
    want = np.asarray(jax_metrics.chamfer_metric(jnp.asarray(pred), jnp.asarray(gt)))
    got = port_metrics.chamfer_metric(_t(pred), _t(gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("eps,iters", [(0.005, 50), (0.002, 200)])
def test_emd_metric_matches_jax(tpu_kernels, eps, iters):
    """The validation protocol and a longer, finer one (the final-test
    protocol's eps, fewer rounds)."""
    pred, gt = _clouds(3, 2, 512, 0.2, 0.01)
    want = np.asarray(jax_metrics.emd_metric(jnp.asarray(pred), jnp.asarray(gt),
                                             eps, iters))
    got = port_metrics.emd_metric(_t(pred), _t(gt), eps, iters).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_compute_all_matches_jax(tpu_kernels):
    """[3, B] numpy, one NN search for F-Score and CD (one chamfer call: two
    plain NN calls) and one auction."""
    pred, gt = _clouds(4, 2, 512, 0.1, 0.003)
    want = jax_metrics.compute_all(jnp.asarray(pred), jnp.asarray(gt), 0.005, 50)
    _lib.reset_counts()
    got = port_metrics.compute_all(_t(pred), _t(gt), 0.005, 50)
    assert _lib.PLAIN_CALLS["nn_idx"] == 2 and _lib.PLAIN_CALLS["emd_bids"] > 0
    assert got.shape == want.shape == (3, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_metrics_better_than_matches_jax():
    """All three names, a tie, None and a dict with missing names."""
    rng = np.random.RandomState(5)
    for name in port_metrics.NAMES:
        for _ in range(20):
            a, b = rng.rand(3).round(1), rng.rand(3).round(1)
            pa, pb = (port_metrics.Metrics(name, list(v)) for v in (a, b))
            ja, jb = (jax_metrics.Metrics(name, list(v)) for v in (a, b))
            assert pa.better_than(pb) == ja.better_than(jb)
            assert not pa.better_than(pa) and not ja.better_than(ja)
        assert port_metrics.Metrics(name, [1, 2, 3]).better_than(None)
    partial = {"EMD": 2.0}
    assert (port_metrics.Metrics("EMD", partial).state_dict()
            == jax_metrics.Metrics("EMD", partial).state_dict())
    assert port_metrics.Metrics.names() == jax_metrics.Metrics.names()
