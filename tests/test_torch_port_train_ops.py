"""The training slice's ops (plain versions, on the CPU) against the JAX
package.

The plain versions of the three new kernels (chamfer NN, auction bids,
edge-gather statistics forward and backward) are held to the JAX package's
Pallas kernels run in interpret mode; the ops around them (chamfer, EMD
auction, expansion penalty, train-mode BatchNorm) to the JAX ops. Inputs are
made from a seed with numpy and given to both packages as numpy arrays.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from sparenet_tpu.ops import emd as jax_emd
from sparenet_tpu.ops.chamfer import chamfer_raw as jax_chamfer_raw
from sparenet_tpu.ops.expansion_penalty import \
    expansion_penalty as jax_expansion
from sparenet_tpu.ops.pallas import emd_pallas
from sparenet_tpu.ops.pallas.chamfer_pallas import nn_idx_pallas
from sparenet_tpu.ops.pallas.edge_train_pallas import \
    edge_gather_stats as jax_edge_stats
from sparenet_tpu_torch.models import layers as port_layers
from sparenet_tpu_torch.ops import _lib, chamfer, edge_gather, emd
from sparenet_tpu_torch.ops import expansion_penalty as port_expansion

jax.config.update("jax_platforms", "cpu")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype, copy=True))


def _cloud(rng, *shape):
    return (rng.rand(*shape) - 0.5).astype(np.float32)


def _with_duplicates(rng, b, n):
    """A cloud in which every point appears twice (exact distance ties)."""
    half = _cloud(rng, b, n // 2, 3)
    return np.concatenate([half, half[:, ::-1]], 1).copy()


# ---------------------------------------------------------------------------
# chamfer NN kernel (#6): plain version against nn_idx_pallas, interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n1,n2,dup", [(300, 700, False), (512, 512, True),
                                       (64, 2500, False)])
def test_nn_idx_matches_pallas(rng, n1, n2, dup):
    """Indices exact, ties (duplicated points) included."""
    x1 = _cloud(rng, 2, n1, 3)
    x2 = _with_duplicates(rng, 2, n2) if dup else _cloud(rng, 2, n2, 3)
    if dup:
        x1[:, :8] = x2[:, :8]
    want = np.asarray(nn_idx_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                    interpret=True))
    got = chamfer.nn_idx(_t(x1), _t(x2))
    assert got.dtype == torch.int32 and got.shape == (2, n1)
    np.testing.assert_array_equal(got.numpy(), want)
    if dup:   # x1's first points sit on a duplicated pair: the lower index
        assert (got[:, :8].numpy() == np.arange(8)).all()


def test_chamfer_raw_matches_jax(rng):
    """Distances and indices exact; the VJP to atol 1e-7 (the scatter-add of
    the matched side sums in another order where several points share a
    match)."""
    x1, x2 = _cloud(rng, 2, 200, 3), _cloud(rng, 2, 300, 3)
    g1, g2 = rng.rand(2, 200).astype(np.float32), rng.rand(2, 300).astype(np.float32)
    outs, vjp = jax.vjp(lambda a, b: jax_chamfer_raw(a, b)[:2],
                        jnp.asarray(x1), jnp.asarray(x2))
    jg = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    a, b = _t(x1).requires_grad_(), _t(x2).requires_grad_()
    d1, d2, i1, i2 = chamfer.chamfer_raw(a, b)
    torch.autograd.backward([d1, d2], [_t(g1), _t(g2)])
    ref = [np.asarray(o) for o in jax_chamfer_raw(jnp.asarray(x1), jnp.asarray(x2))]
    for got, want in zip((d1, d2, i1, i2), ref):
        np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg[0]), atol=1e-7)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jg[1]), atol=1e-7)


# ---------------------------------------------------------------------------
# auction bids (#8): plain version against emd_bids_pallas, interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,dup", [(256, 512, False), (512, 1024, True)])
def test_bids_match_pallas(rng, m, n, dup):
    """Targets and increments exact. With duplicated objects at equal price
    the best value is tied: the lower index wins and the increment is 0."""
    x1 = _cloud(rng, 2, m, 3)
    x2 = _with_duplicates(rng, 2, n) if dup else _cloud(rng, 2, n, 3)
    price = (rng.rand(2, n) * 0.02).astype(np.float32)
    price[:, ::4] = 0.0
    if dup:
        price[:, n // 2:] = price[:, n // 2 - 1::-1]   # duplicates priced alike
    tgt, inc = emd_pallas.emd_bids_pallas(jnp.asarray(x1), jnp.asarray(x2),
                                          jnp.asarray(price), oc=n,
                                          interpret=True)
    got_t, got_i = emd.emd_bids(_t(x1), _t(x2), _t(price))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(tgt))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(inc))
    if dup:
        assert (got_i.numpy() == 0).all() and (got_t.numpy() < n // 2).all()


def _patch_pallas_bids(monkeypatch, n):
    """Route the JAX auction through the bid kernel in interpret mode (its
    CPU path bids with the |x|^2 + |y|^2 - 2xy expansion instead)."""
    monkeypatch.setattr(jax_emd, "_use_pallas_bids", lambda n_: True)
    monkeypatch.setattr(emd_pallas, "emd_bids_pallas", functools.partial(
        emd_pallas.emd_bids_pallas, interpret=True, oc=n))


def test_emd_auction_matches_jax(rng, monkeypatch):
    """n=1024, eps 0.005, 50 rounds (the loss's setting): assignment and
    distances exact, the VJP exact (one gather, no sums)."""
    n = 1024
    _patch_pallas_bids(monkeypatch, n)
    x1, x2 = _cloud(rng, 2, n, 3), _cloud(rng, 2, n, 3)
    g = rng.rand(2, n).astype(np.float32)
    (dist, assign), vjp = jax.vjp(
        lambda a: jax_emd.emd_auction(a, jnp.asarray(x2), 0.005, 50),
        jnp.asarray(x1))
    jg = vjp((jnp.asarray(g), np.zeros((2, n), jax.dtypes.float0)))[0]
    a = _t(x1).requires_grad_()
    pd, pa = emd.emd_auction(a, _t(x2), 0.005, 50)
    (pd * _t(g)).sum().backward()
    np.testing.assert_array_equal(pa.numpy(), np.asarray(assign))
    np.testing.assert_array_equal(pd.detach().numpy(), np.asarray(dist))
    np.testing.assert_array_equal(a.grad.numpy(), np.asarray(jg))


# ---------------------------------------------------------------------------
# edge-gather statistics (#7): plain versions against the interpret kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,c,k", [(100, 40, 8), (37, 128, 8), (64, 8, 3)])
def test_edge_stats_match_pallas(rng, n, c, k):
    """Forward outputs and the table gradient (jax.vjp) bit for bit, with
    duplicated slots and duplicated table rows, so that max and min tie and
    only the first tied slot may take their gradient."""
    table = rng.randn(2, n, c).astype(np.float32)
    table[:, 1::5] = table[:, ::5][:, :table[:, 1::5].shape[1]]   # equal rows
    idx = rng.randint(0, n, (2, n, k)).astype(np.int32)
    idx[:, :, -1] = idx[:, :, 0]                                   # equal slots
    idx[:, :4, :] = np.arange(k) % 2            # rows 0 and 1 are equal
    grads = [rng.randn(2, n, c).astype(np.float32) for _ in range(4)]
    outs, vjp = jax.vjp(lambda t: jax_edge_stats(t, jnp.asarray(idx), True),
                        jnp.asarray(table))
    (want_g,) = vjp(tuple(jnp.asarray(g) for g in grads))
    t = _t(table).requires_grad_()
    got = edge_gather.edge_gather_stats(t, _t(idx))
    for o, w in zip(got, outs):
        np.testing.assert_array_equal(o.detach().numpy(), np.asarray(w))
    torch.autograd.backward(list(got), [_t(g) for g in grads])
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want_g))


def test_edge_stats_route_to_first_tied_slot():
    """Two slots hold the same max: only the first takes gmx."""
    table = torch.tensor([[[1.0, 5.0], [3.0, 5.0], [3.0, 0.0]]])
    idx = torch.tensor([[[0, 1, 2, 1]]], dtype=torch.int32)        # M=1, k=4
    mx, mn, _, _ = edge_gather.edge_stats_fwd(table, idx)
    zero = torch.zeros(1, 1, 2)
    g = edge_gather.edge_stats_bwd(table, idx, mx, mn, torch.ones(1, 1, 2),
                                   zero, zero, zero)
    # channel 0: max 3 first at slot 1 (row 1); channel 1: max 5 at slot 0
    np.testing.assert_array_equal(g[0].numpy(), [[0, 1], [1, 0], [0, 0]])


# ---------------------------------------------------------------------------
# expansion penalty backward, train-mode BatchNorm
# ---------------------------------------------------------------------------

def test_expansion_penalty_vjp_matches_jax(rng):
    """The gradient of sum(g * dist): exact (one gather, one product)."""
    s = 64
    xyz = _cloud(rng, 2, 4 * s, 3)
    g = rng.rand(2, 4 * s).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jax_expansion(x, s, 1.5)[0], jnp.asarray(xyz))
    (want,) = vjp(jnp.asarray(g))
    x = _t(xyz).requires_grad_()
    dist, _, _ = port_expansion.expansion_penalty(x, s, 1.5)
    (dist * _t(g)).sum().backward()
    assert np.count_nonzero(np.asarray(want)) > 0
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(24, 32), (2, 50, 16), (3, 2, 40, 8)])
def test_train_bn_matches_flax(rng, shape):
    """Train-mode BatchNorm against flax nn.BatchNorm(use_running_average=
    False, momentum 0.9): output, new running mean and (biased) variance
    to rtol 1e-5 / atol 1e-6 (f32 sums in another order)."""
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    c = shape[-1]
    scale = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    ra_m = (0.1 * rng.randn(c)).astype(np.float32)
    ra_v = (1 + 0.1 * rng.rand(c)).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_m, "var": ra_v}}
    y, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    tbn = torch.nn.BatchNorm1d(c).train()
    with torch.no_grad():
        tbn.weight.copy_(_t(scale))
        tbn.bias.copy_(_t(bias))
        tbn.running_mean.copy_(_t(ra_m))
        tbn.running_var.copy_(_t(ra_v))
    got = port_layers.bn_apply(tbn, _t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# wrapper contract
# ---------------------------------------------------------------------------

def test_new_wrappers_take_the_plain_versions_on_cpu(rng):
    _lib.reset_counts()
    x = _t(_cloud(rng, 1, 20, 3))
    chamfer.nn_idx(x, x)
    emd.emd_bids(x, x, torch.zeros(1, 20))
    t = _t(rng.randn(1, 20, 8).astype(np.float32)).requires_grad_()
    idx = torch.zeros(1, 20, 8, dtype=torch.int32)
    sum(o.sum() for o in edge_gather.edge_gather_stats(t, idx)).backward()
    assert {k: v for k, v in _lib.PLAIN_CALLS.items() if v} == {
        "nn_idx": 1, "emd_bids": 1, "edge_stats_fwd": 1, "edge_stats_bwd": 1}
    assert set(_lib.LAUNCHES.values()) == {0}


def test_completion_loss_chamfer_form_matches_jax(rng):
    """The loss's chamfer form (metric "chamfer", consistency term on):
    total, coarse and refine losses to rtol 1e-6 (means of distances that
    agree bit for bit, summed in another order)."""
    import types

    from sparenet_tpu.runners.sparenet import completion_loss as jax_loss
    from sparenet_tpu_torch.runners import sparenet as port_runner
    clouds = [_cloud(rng, 2, 300, 3) for _ in range(4)]
    cfg = types.SimpleNamespace(NETWORK=types.SimpleNamespace(
        metric="chamfer", use_consist_loss=True))
    want = jax_loss(cfg, *map(jnp.asarray, clouds[:3]), jnp.float32(0.25),
                    jnp.asarray(clouds[3]))
    got = port_runner.completion_loss(*map(_t, clouds[:3]), torch.tensor(0.25),
                                      _t(clouds[3]), metric="chamfer")
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-6)


def test_training_modules_and_chip_smoke_import_no_jax():
    """The training slice's modules and chip_smoke.py import neither JAX,
    flax nor the JAX package (checked in a fresh interpreter)."""
    import subprocess
    import sys
    code = (
        "import sys, chip_smoke\n"
        "import sparenet_tpu_torch.runners.sparenet, sparenet_tpu_torch.runners.base\n"
        "import sparenet_tpu_torch.ops.chamfer, sparenet_tpu_torch.ops.emd\n"
        "import sparenet_tpu_torch.ops.edge_gather\n"
        "bad = [n for n in sys.modules if n in ('jax', 'flax', 'sparenet_tpu')"
        " or n.startswith(('jax.', 'flax.', 'sparenet_tpu.'))]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
