"""One training step of the port's AtlasNet and MSN runners against the JAX
package's runners (``atlasnetRunner._train_impl``, ``msnRunner._train_impl``,
jitted), on the CPU at toy size: B=4, 256 -> 256 points, 4 primitives of 64,
bottleneck 64 (PointNetfeat's hide 1024), EMD loss, Adam at lr 1e-4.

B=4, not 2: train-mode BatchNorm of the bottleneck takes its statistics over
the samples, and over two the normalised value is +-1 whatever the input.
The variables are tests/test_torch_msn_atlasnet.py's well-conditioned draw,
the clouds ellipsoids of random axes and centres. Both steps fold the same
grids: the JAX step's draw (``jax.random.uniform`` of the 'grid' stream) is
replaced by them, and the port model's ``draw_grids`` returns them.

Anchored: the port replays the JAX step's index outputs (MSN's MDS picks and
the expansion MSTs of its coarse cloud, the auction assignments), which the
JAX step hands out through ``jax.debug.callback`` with its gradients; the
loss, every gradient leaf, the running statistics and the updated
parameters are compared. Free-running: the port's own step, loss compared.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.models import AtlasNet as JaxAtlasNet
from sparenet_tpu.models import MSN as JaxMSN
from sparenet_tpu.models import msn as jax_msn_mod
from sparenet_tpu.runners import atlasnet as jax_atlas_runner
from sparenet_tpu.runners import msn as jax_msn_runner
from sparenet_tpu.runners.base import TrainState, apply_updates, make_optimizer
from sparenet_tpu_torch import models as port_models
from sparenet_tpu_torch.ops import emd, expansion_penalty, mds
from sparenet_tpu_torch.runners import atlasnet as port_atlas
from sparenet_tpu_torch.runners import base as port_base
from sparenet_tpu_torch.runners import msn as port_msn
from sparenet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_msn_atlasnet import D, N, N_IN, P, S, draw, ellipsoids

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

B, LR = 4, 1e-4
CFG = types.SimpleNamespace(
    NETWORK=types.SimpleNamespace(metric="emd"),
    TRAIN=types.SimpleNamespace(betas=(0.0, 0.9), weight_decay=0))
JAX = {"AtlasNet": (JaxAtlasNet, jax_atlas_runner.atlasnetRunner,
                    jax_atlas_runner),
       "MSN": (JaxMSN, jax_msn_runner.msnRunner, jax_msn_runner)}
PORT_STEP = {"AtlasNet": port_atlas.train_step, "MSN": port_msn.train_step}


class _Kept:
    """Values the jitted JAX step computes, handed out by
    ``jax.debug.callback`` in the order the step traced their sites."""

    def __init__(self):
        self.sites, self.items = 0, []

    def keep(self, name, value):
        site = self.sites
        self.sites += 1
        jax.debug.callback(lambda v: self.items.append(
            (site, name, jax.tree_util.tree_map(np.array, v))), value)

    def take(self) -> dict:
        jax.effects_barrier()
        out: dict = {}
        for _, name, v in sorted(self.items, key=lambda t: t[0]):
            out.setdefault(name, []).append(v)
        return out

    def wrap(self, name, fn, pick):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            self.keep(name, pick(args, out))
            return out
        return rec


def _clouds(seed):
    rng = np.random.RandomState(seed)
    v = ellipsoids(rng, B, 2 * N + N_IN)
    gt, partial = v[:, :N], v[:, 2 * N:][:, :N_IN]
    grids = rng.rand(P, B, S, 2).astype(np.float32)
    return rng, np.ascontiguousarray(gt), np.ascontiguousarray(partial), grids


def _jax_step(name):
    """The JAX runner's jitted step on drawn variables, with what the port
    replays."""
    model_cls, runner_cls, runner_mod = JAX[name]
    rng, gt, partial, grids = _clouds(1)
    model = model_cls(num_points=N, bottleneck_size=D, n_primitives=P,
                      train=True)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            jnp.asarray(partial), jnp.asarray(grids))
    variables = draw(shapes, rng)
    runner = object.__new__(runner_cls)
    runner.config, runner.model_train = CFG, model
    runner.tx = make_optimizer(CFG)
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=runner.tx.init(variables["params"]),
                       rng=jax.random.PRNGKey(2), step=jnp.zeros((), jnp.int32))
    kept = _Kept()
    uniform = jax.random.uniform
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "uniform", lambda key, shape, *a, **kw: (
        jnp.asarray(grids) if tuple(shape) == grids.shape
        else uniform(key, shape, *a, **kw)))
    mp.setattr(jax_atlas_runner, "emd_auction", kept.wrap(
        "assign", jax_atlas_runner.emd_auction, lambda a, o: o[1]))
    mp.setattr(runner_mod, "apply_updates", kept.wrap(
        "grads", runner_mod.apply_updates, lambda a, o: a[1]))
    if name == "MSN":
        mp.setattr(jax_msn_mod, "expansion_penalty", kept.wrap(
            "coarse", jax_msn_mod.expansion_penalty, lambda a, o: a[0]))
        mp.setattr(jax_msn_mod, "minimum_density_sample", kept.wrap(
            "picks", jax_msn_mod.minimum_density_sample, lambda a, o: o))
    try:
        new, loss, c_l, r_l = jax.jit(runner._train_impl)(
            state, jnp.asarray(partial), jnp.asarray(gt), jnp.float32(LR))
        rec = kept.take()
    finally:
        mp.undo()
    return dict(name=name, gt=gt, partial=partial, grids=grids,
                variables=jax.tree_util.tree_map(np.array, variables),
                loss=[float(loss), float(c_l), float(r_l)],
                new_bstats=jax.tree_util.tree_map(np.array, new.batch_stats),
                **rec)


@pytest.fixture(scope="module", params=list(JAX))
def step(request):
    return _jax_step(request.param)


def _load(step, values):
    """A port model of the step's family holding ``values`` (a JAX
    variables tree), its grids fixed to the step's."""
    m = getattr(port_models, step["name"])(num_points=N, bottleneck_size=D,
                                           n_primitives=P)
    m.load_state_dict(state_dict_from_jax(values, n_primitives=P,
                                          model_type=step["name"]),
                      strict=True)
    grids = torch.from_numpy(step["grids"])
    m.draw_grids = lambda batch, generator: grids
    return m


def _replay(values, fn=None):
    """An op that returns ``values`` in call order (through ``fn``)."""
    it = iter(values)

    def op(*args, **kw):
        v = next(it)
        return fn(v) if fn else torch.from_numpy(np.array(v))
    return op


def _port_step(step, anchored: bool):
    model = _load(step, step["variables"])
    opt = port_base.make_optimizer(model, port_atlas.CONFIG)
    mp = pytest.MonkeyPatch()
    if anchored:
        mp.setattr(emd, "auction_assign", _replay(step["assign"]))
        if step["name"] == "MSN":
            mp.setattr(mds, "minimum_density_sample", _replay(step["picks"]))
            mp.setattr(expansion_penalty, "mst_charges", _replay(
                step["coarse"], lambda c: expansion_penalty.mst_charges_plain(
                    torch.from_numpy(np.array(c)).reshape(-1, S, 3))))
    try:
        loss = PORT_STEP[step["name"]](
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
    want = dict(_load(step, {"params": step["grads"][0],
                             "batch_stats": step["variables"]["batch_stats"]}
                      ).named_parameters())
    out = {}
    for name, p in anchored["model"].named_parameters():
        if p.grad is None:            # registered but unused, as in JAX
            assert ".bn7." in name
            continue
        out[name] = (p.grad.numpy(), want[name].detach().numpy())
    assert len(out) == len(jax.tree_util.tree_leaves(step["grads"][0]))
    return out


def test_jax_step_ran_what_the_port_replays(step):
    """The JAX step's recorded index outputs: one auction a reconstruction
    loss (AtlasNet 1, MSN 2), and MSN's one expansion and one MDS."""
    want = 1 if step["name"] == "AtlasNet" else 2
    assert len(step["assign"]) == want and len(step["grads"]) == 1
    if step["name"] == "MSN":
        assert len(step["picks"]) == 1 and len(step["coarse"]) == 1


def test_anchored_loss_matches_jax(step, anchored):
    """loss, coarse_loss and refine_loss: rtol 1e-5 (readings: up to
    3.0e-6)."""
    np.testing.assert_allclose(anchored["loss"], step["loss"], rtol=1e-5)


# Gradients that are exactly 0 in exact arithmetic: the biases of convs a
# train-mode BatchNorm follows, and of the BatchNorms before a max-pool
# (PointNetfeat's bn3, the residual net's bn3): a constant shift of the
# global feature, which the next train-mode BatchNorm removes. Both packages
# give rounding noise there (readings: up to 1.5e-5 in norm).
ZERO_GRAD = ({"encoder.linear.bias", "encoder.feat_extractor.bn3.bias",
              "res.bn3.bias"}
             | {f"encoder.feat_extractor.conv{i}.bias" for i in (1, 2, 3)}
             | {f"decoder.conv{i}.bias" for i in (1, 2, 3)}
             | {f"res.conv{i}.bias" for i in range(1, 7)})


def test_anchored_gradients_match_jax(step, anchored):
    """Every gradient leaf within 3e-3 of the JAX leaf in relative L2 norm
    (readings: up to 1.1e-3, MSN's res.bn4.bias; the rest below 7e-5); the
    leaves whose exact gradient is 0 (ZERO_GRAD) below 5e-5 in norm on both
    sides."""
    for name, (got, want) in _grads(step, anchored).items():
        if name in ZERO_GRAD:
            assert np.linalg.norm(got) < 5e-5 and np.linalg.norm(want) < 5e-5, name
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 3e-3, (name, rel)


def test_anchored_running_stats_match_jax(step, anchored):
    """Every BatchNorm's new running mean and (biased) variance: rtol 1e-4,
    atol 1e-6."""
    want = dict(_load(step, {"params": step["variables"]["params"],
                             "batch_stats": step["new_bstats"]}
                      ).named_buffers())
    n = 0
    for name, buf in anchored["model"].named_buffers():
        if name.endswith(("running_mean", "running_var")) and ".bn7." not in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
            n += 1
    assert n == len(jax.tree_util.tree_leaves(step["new_bstats"]))


def test_anchored_update_is_the_jax_optimizers(step, anchored):
    """The port's parameters after its Adam step equal the JAX optimizer
    applied to the port's own gradients from the same parameters, within
    1e-7 |p| + 1e-3 lr (torch and optax round the bias corrections
    differently); with the gradient test this holds them to the JAX
    step's."""
    grads = {n: g for n, (g, _) in _grads(step, anchored).items()}
    old = dict(_load(step, step["variables"]).named_parameters())
    p0 = {n: old[n].detach().numpy() for n in grads}
    tx = make_optimizer(CFG)
    want = jax.jit(lambda g, p: apply_updates(tx, g, tx.init(p), p, LR)[0])(
        grads, p0)
    for name, p in anchored["model"].named_parameters():
        if name not in grads:
            assert torch.equal(p, old[name]), name      # untouched
            continue
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[name]),
                                   rtol=1e-7, atol=1e-3 * LR, err_msg=name)


def test_free_running_loss_matches_jax(step):
    """The port's own step (its own MDS picks, MSTs and assignments on the
    same grids): the three losses within rtol 1e-2 of the JAX step's
    (readings: up to 1.3e-3)."""
    _, loss = _port_step(step, anchored=False)
    np.testing.assert_allclose(loss, step["loss"], rtol=1e-2)
