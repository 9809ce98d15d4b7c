"""One training step of the port's GRNet runner against the JAX package's
(``grnetRunner._train_impl``, jitted), on the CPU at toy size: B=2, 128 ->
16 sampled -> 128 dense points, gridding scale 16, EMD dense loss, Adam at
lr 1e-4.

The variables are tests/test_torch_grnet.py's well-conditioned draw, with
the conv biases ahead of the train-mode BatchNorms at 0 (that file's
docstring says why); the clouds are ellipsoids of random axes and centres.
The JAX step's sample (its Gumbel noise, candidates and picks) is recorded
by a wrapper of ``random_point_sampling`` around the unchanged function, its
auction assignments and gradients by wrappers of ``emd_auction`` and
``apply_updates``; all leave the step through ``jax.debug.callback``.

Anchored: the port replays the JAX step's picks and auction assignments;
the loss, every gradient leaf, the running statistics and the updated
parameters are compared. Free-running: the port selects its own sample
from the JAX step's noise (as the folding families' tests share the grids)
and runs its own auction; the three losses are compared.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.models import grnet as jax_grnet
from sparenet_tpu.runners import atlasnet as jax_atlas_runner
from sparenet_tpu.runners import grnet as jax_grnet_runner
from sparenet_tpu.runners.base import TrainState, apply_updates, make_optimizer
from sparenet_tpu_torch.models import grnet as port_grnet
from sparenet_tpu_torch.ops import emd
from sparenet_tpu_torch.runners import base as port_base
from sparenet_tpu_torch.runners import grnet as port_runner
from sparenet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_grnet import draw, recording_sampler
from tests.test_torch_msn_atlasnet import ellipsoids
from tests.test_torch_msn_atlasnet_train import _Kept, _replay

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, N_IN, N_SAMP, SCALE, LR = 2, 128, 16, 16, 1e-4
N = 8 * N_SAMP
CFG = types.SimpleNamespace(
    NETWORK=types.SimpleNamespace(metric="emd"),
    TRAIN=types.SimpleNamespace(betas=(0.0, 0.9), weight_decay=0))


@pytest.fixture(scope="module")
def step():
    """The JAX runner's jitted step on drawn variables, with what the port
    replays."""
    rng = np.random.RandomState(1)
    v = ellipsoids(rng, B, N + N_IN)
    gt, partial = np.ascontiguousarray(v[:, :N]), np.ascontiguousarray(v[:, N:])
    partial[1, :8] = 0.0                      # the loaders' zero padding
    model = jax_grnet.GRNet(n_sampling_points=N_SAMP, gridding_scale=SCALE,
                            train=True)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                         "sample": jax.random.PRNGKey(1)},
                            jnp.asarray(partial))
    variables = draw(shapes, rng)
    for i in range(4):
        conv = variables["params"][f"_ConvBlock_{i}"]["Conv_0"]
        conv["bias"] = np.zeros_like(conv["bias"])
    runner = object.__new__(jax_grnet_runner.grnetRunner)
    runner.config, runner.model_train = CFG, model
    runner.tx = make_optimizer(CFG)
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=runner.tx.init(variables["params"]),
                       rng=jax.random.PRNGKey(2), step=jnp.zeros((), jnp.int32))
    kept = _Kept()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_grnet, "random_point_sampling", recording_sampler(kept.keep))
    mp.setattr(jax_atlas_runner, "emd_auction", kept.wrap(
        "assign", jax_atlas_runner.emd_auction, lambda a, o: o[1]))
    mp.setattr(jax_grnet_runner, "apply_updates", kept.wrap(
        "grads", jax_grnet_runner.apply_updates, lambda a, o: a[1]))
    try:
        new, loss, c_l, r_l = jax.jit(runner._train_impl)(
            state, jnp.asarray(partial), jnp.asarray(gt), jnp.float32(LR))
        rec = kept.take()
    finally:
        mp.undo()
    return dict(gt=gt, partial=partial,
                variables=jax.tree_util.tree_map(np.array, variables),
                loss=[float(loss), float(c_l), float(r_l)],
                new_bstats=jax.tree_util.tree_map(np.array, new.batch_stats),
                **rec)


def _load(values):
    m = port_grnet.GRNet(N_SAMP, SCALE)
    m.load_state_dict(state_dict_from_jax(values, model_type="GRNet"),
                      strict=True)
    return m


def _port_step(step, anchored: bool):
    model = _load(step["variables"])
    opt = port_base.make_optimizer(model, port_runner.CONFIG)
    mp = pytest.MonkeyPatch()
    mp.setattr(port_grnet, "gumbel_noise", _replay(step["gumbel"]))
    if anchored:
        mp.setattr(port_grnet, "sample_indices", _replay(
            step["picks"], lambda v: torch.from_numpy(np.array(v)).long()))
        mp.setattr(emd, "auction_assign", _replay(step["assign"]))
    try:
        loss = port_runner.train_step(
            model, opt, torch.from_numpy(step["partial"]),
            torch.from_numpy(step["gt"]), LR, torch.Generator())
    finally:
        mp.undo()
    return model, [float(v) for v in loss]


@pytest.fixture(scope="module")
def anchored(step):
    model, loss = _port_step(step, anchored=True)
    return dict(model=model, loss=loss)


def _grads(step, anchored):
    """(port gradient, JAX gradient) per parameter, in the port's layout."""
    want = dict(_load({"params": step["grads"][0],
                       "batch_stats": step["variables"]["batch_stats"]}
                      ).named_parameters())
    out = {name: (p.grad.numpy(), want[name].detach().numpy())
           for name, p in anchored["model"].named_parameters()}
    assert len(out) == len(jax.tree_util.tree_leaves(step["grads"][0]))
    return out


def test_jax_step_ran_what_the_port_replays(step):
    """The JAX step's records: one sample, one auction (the dense EMD loss),
    one gradient."""
    assert all(len(step[k]) == 1 for k in ("gumbel", "picks", "cloud",
                                           "assign", "grads"))
    assert step["gumbel"][0].shape == (B, N_IN + SCALE ** 3)
    assert step["picks"][0].shape == (B, N_SAMP)


def test_anchored_loss_matches_jax(step, anchored):
    """loss, sparse (coarse) loss and dense (refine) loss: rtol 1e-5
    (reading: equal)."""
    np.testing.assert_allclose(anchored["loss"], step["loss"], rtol=1e-5)


# Gradients that are exactly 0 in exact arithmetic: the biases of the convs a
# train-mode BatchNorm follows. Both packages give rounding noise there.
ZERO_GRAD = {f"conv{i}.0.bias" for i in (1, 2, 3, 4)}


def test_anchored_gradients_match_jax(step, anchored):
    """Every gradient leaf within 3e-3 of the JAX leaf in relative L2 norm
    (reading: up to 4.0e-6, dconv10.1.weight); the leaves whose exact
    gradient is 0 (ZERO_GRAD) below 1e-4 in norm on both sides (reading:
    7.3e-6)."""
    for name, (got, want) in _grads(step, anchored).items():
        if name in ZERO_GRAD:
            assert np.linalg.norm(got) < 1e-4 and np.linalg.norm(want) < 1e-4, name
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 3e-3, (name, rel)


def test_anchored_running_stats_match_jax(step, anchored):
    """Every BatchNorm's new running mean and (biased) variance: rtol 1e-4,
    atol 1e-6."""
    want = dict(_load({"params": step["variables"]["params"],
                       "batch_stats": step["new_bstats"]}).named_buffers())
    n = 0
    for name, buf in anchored["model"].named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
            n += 1
    assert n == len(jax.tree_util.tree_leaves(step["new_bstats"])) == 16


def test_anchored_update_is_the_jax_optimizers(step, anchored):
    """The port's parameters after its Adam step equal the JAX optimizer
    applied to the port's own gradients from the same parameters, within
    1e-7 |p| + 1e-3 lr."""
    grads = {n: g for n, (g, _) in _grads(step, anchored).items()}
    old = dict(_load(step["variables"]).named_parameters())
    p0 = {n: old[n].detach().numpy() for n in grads}
    tx = make_optimizer(CFG)
    want = jax.jit(lambda g, p: apply_updates(tx, g, tx.init(p), p, LR)[0])(
        grads, p0)
    for name, p in anchored["model"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]),
                                   rtol=1e-7, atol=1e-3 * LR, err_msg=name)


def test_free_running_loss_matches_jax(step):
    """The port's own step on the JAX step's noise (its own picks and
    assignments): the three losses within rtol 1e-2 of the JAX step's
    (reading: equal)."""
    _, loss = _port_step(step, anchored=False)
    np.testing.assert_allclose(loss, step["loss"], rtol=1e-2)
