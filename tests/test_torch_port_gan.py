"""One SpareNet-GAN training step of the PyTorch port against the JAX
package's ``sparenetGANRunner._gan_impl``, at toy size.

The generator and its inputs are those of tests/test_torch_port_train.py
(flagship arms at B=4, 256 -> 1024 points, 2 primitives, bottleneck and
hide 128, well-conditioned weights drawn from a seed); the renders are at
img 64 and radius 5, the discriminator is ``ProjectionD`` (the shipped
``use_cgan: true``, no classes). The JAX step runs with the encoder's train
commute on its XLA arm and the auction's bids through the Pallas kernel in
interpret mode (monkeypatched, as its own tests do); the Dropout2d masks
are drawn from a numpy seed by a stand-in for ``jax.random.bernoulli`` and
handed to both packages.

Anchored: the port replays the JAX step's kNN graphs, MDS picks, expansion
MSTs, EMD and Chamfer assignments and dropout masks, so that only rounding
separates the two. Free-running: the port's own step with the same masks.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.models import SpareNetGenerator as JaxGenerator
from sparenet_tpu.models import sparenet as jax_model_mod
from sparenet_tpu.models.discriminator import ProjectionD as JaxProjD
from sparenet_tpu.ops import common as jax_opc
from sparenet_tpu.ops import emd as jax_emd
from sparenet_tpu.ops.pallas import emd_pallas
from sparenet_tpu.renderer import ComputeDepthMaps as JaxRenderer
from sparenet_tpu.runners import base as jax_base
from sparenet_tpu.runners import sparenet as jax_runner_mod
from sparenet_tpu.runners import sparenet_gan as jax_gan_mod
from sparenet_tpu_torch import models as port_models
from sparenet_tpu_torch.models import discriminator as port_disc
from sparenet_tpu_torch.ops import chamfer, emd, expansion_penalty, knn, mds
from sparenet_tpu_torch.runners import base as port_base
from sparenet_tpu_torch.runners import sparenet_gan as port_gan
from sparenet_tpu_torch.utils.weights import (disc_state_dict_from_jax,
                                              state_dict_from_jax)
from tests.test_torch_port_gan_ops import MaskFeed
from tests.test_torch_port_train import (B, CONFIG, N_OUT, PRIMS, S, ZERO_GRAD,
                                         _gt_and_partial, _replay, _tree_np,
                                         draw_variables)

jax.config.update("jax_platforms", "cpu")

IMG, RADIUS, LR = 64, 5.0, 1e-4
GAN = dict(use_im=True, use_fm=True, use_cgan=True, weight_gan=0.1,
           weight_l2=200.0, weight_im=1.0, weight_fm=1.0)
CFG = types.SimpleNamespace(
    NETWORK=types.SimpleNamespace(metric="emd", use_consist_loss=True),
    TRAIN=types.SimpleNamespace(betas=(0.0, 0.9), weight_decay=0),
    GAN=types.SimpleNamespace(**GAN))
LOSSES = ("rec", "coarse_loss", "refine_loss", "errG", "errG_D",
          "errD_real", "errD_fake")


def _keep(calls, name, value):
    """Store value (or a tree of values) at calls[name][i] when the program
    runs, i counting the trace-time calls: the values traced inside the
    step's jax.vjp cannot leave it as outputs."""
    slots = calls.setdefault(name, [])
    i = len(slots)
    slots.append(None)

    def store(v):
        slots[i] = jax.tree_util.tree_map(np.asarray, v)
    jax.debug.callback(store, value)


def _recording(calls, name, fn, pick):
    def rec(*args, **kw):
        out = fn(*args, **kw)
        _keep(calls, name, pick(out))
        return out
    return rec


class _Recording:
    """The JAX generator, also keeping its kNN graphs and its coarse and
    middle clouds in ``calls``."""

    def __init__(self, model, calls):
        self.model, self.calls = model, calls

    def apply(self, variables, x, mutable):
        out, upd = self.model.apply(variables, x,
                                    mutable=list(mutable) + ["intermediates"])
        enc = upd.pop("intermediates")["encoder"]["EdgeConvResFeat_0"]
        _keep(self.calls, "nbrs", [enc[f"nbr{i}"][0] for i in (1, 2, 3, 4)])
        _keep(self.calls, "outs", out[:2])
        return out, upd


@pytest.fixture(scope="module")
def step():
    """The JAX GAN step, its gradients and the index outputs the port
    replays."""
    rng = np.random.RandomState(0)
    gt, partial = _gt_and_partial(rng)
    gen = JaxGenerator(**CONFIG, use_adain="share", encode="Residualnet",
                       train=True)
    gvars = draw_variables(gen, partial, rng)
    disc = JaxProjD(num_classes=0, train=True)
    img0 = jnp.zeros((2, IMG, IMG, 16), jnp.float32)
    dvars = _tree_np(jax.jit(disc.init)(
        {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
        img0, y=jnp.zeros((2,), jnp.int32)))
    tx = jax_base.make_optimizer(CFG)
    calls: dict = {}
    runner = types.SimpleNamespace(
        config=CFG, model_train=_Recording(gen, calls), tx=tx, tx_d=tx,
        renderer=JaxRenderer("orthorgonal", 1.0, IMG), disc_train=disc)
    runner._apply_disc = functools.partial(
        jax_gan_mod.sparenetGANRunner._apply_disc, runner)
    gstate = jax_base.TrainState(
        params=gvars["params"], batch_stats=gvars["batch_stats"],
        opt_state=tx.init(gvars["params"]), rng=jax.random.PRNGKey(3),
        step=jnp.int32(0))
    dstate = jax_gan_mod.DiscState(
        params=dvars["params"], batch_stats=dvars["batch_stats"],
        spectral=dvars["spectral"], opt_state=tx.init(dvars["params"]))
    feed = MaskFeed(11)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_opc, "TRAIN_COMMUTE", True)
    mp.setattr(jax_opc, "TRAIN_COMMUTE_IMPL", "xla")
    mp.setattr(jax_emd, "_use_pallas_bids", lambda n: True)
    mp.setattr(emd_pallas, "emd_bids_pallas", functools.partial(
        emd_pallas.emd_bids_pallas, interpret=True, oc=N_OUT))
    mp.setattr(jax_model_mod, "minimum_density_sample", _recording(
        calls, "picks", jax_model_mod.minimum_density_sample, lambda o: o))
    mp.setattr(jax_runner_mod, "emd_auction", _recording(
        calls, "assigns", jax_runner_mod.emd_auction, lambda o: o[1]))
    mp.setattr(jax_runner_mod, "chamfer_raw", _recording(
        calls, "nn", jax_runner_mod.chamfer_raw, lambda o: o[2:]))
    mp.setattr(jax.random, "bernoulli", feed)

    def apply_updates(tx_, grads, *args):      # keeps D's, then G's grads
        _keep(calls, "grads", grads)
        return jax_base.apply_updates(tx_, grads, *args)
    mp.setattr(jax_gan_mod, "apply_updates", apply_updates)

    run = jax.jit(functools.partial(
        jax_gan_mod.sparenetGANRunner._gan_impl, runner, RADIUS))
    try:
        gs, ds, *losses = run(gstate, dstate, jnp.asarray(partial),
                              jnp.asarray(gt), jnp.zeros((B,), jnp.int32),
                              jnp.float32(LR))
        jax.effects_barrier()
    finally:
        mp.undo()
    rec = calls
    dgrads, ggrads = rec["grads"]
    assert len(feed.masks) == 16
    return dict(gt=gt, partial=partial, gvars=gvars, dvars=dvars,
                losses=[float(v) for v in losses], masks=feed.port_masks(),
                ggrads=ggrads, dgrads=dgrads,
                new_gbstats=_tree_np(gs.batch_stats),
                new_dbstats=_tree_np(ds.batch_stats),
                new_spectral=_tree_np(ds.spectral),
                nbrs=rec["nbrs"][0], picks=rec["picks"], assigns=rec["assigns"],
                nn=list(rec["nn"][0]), outs=list(rec["outs"][0]))


def _port_models(step):
    gen = port_models.build_generator(device="cpu", **CONFIG)
    gen.load_state_dict(state_dict_from_jax(step["gvars"], n_primitives=PRIMS),
                        strict=True)
    d = step["dvars"]
    disc = port_models.build_discriminator(device="cpu", image_size=IMG)
    disc.load_state_dict(disc_state_dict_from_jax(
        d["params"], d["batch_stats"], d["spectral"]), strict=True)
    return (gen, disc, port_base.make_optimizer(gen, port_gan.CONFIG),
            port_base.make_optimizer(disc, port_gan.CONFIG))


def _run_port(step, mp):
    gen, disc, opt_g, opt_d = _port_models(step)
    masks = iter(step["masks"])
    mp.setattr(port_disc, "dropout_mask", lambda shape, g, dev: next(masks))
    mp.setitem(port_gan.CONFIG, "img_size", IMG)
    losses = port_gan.gan_step(
        gen, disc, opt_g, opt_d, torch.from_numpy(step["partial"]),
        torch.from_numpy(step["gt"]), torch.zeros(B, dtype=torch.int32), LR,
        RADIUS, torch.Generator().manual_seed(0))
    assert next(masks, None) is None            # all 16 masks taken
    return dict(gen=gen, disc=disc, losses=[float(v) for v in losses])


@pytest.fixture(scope="module")
def anchored(step):
    mp = pytest.MonkeyPatch()
    mp.setattr(knn, "knn_idx", _replay(step["nbrs"]))
    mp.setattr(mds, "minimum_density_sample", _replay(step["picks"]))
    mp.setattr(expansion_penalty, "mst_charges", _replay(
        step["outs"], lambda c: expansion_penalty.mst_charges_plain(
            torch.from_numpy(np.array(c)).reshape(-1, S, 3))))
    mp.setattr(emd, "auction_assign", _replay(step["assigns"]))
    mp.setattr(chamfer, "nn_idx", _replay(step["nn"]))
    try:
        return _run_port(step, mp)
    finally:
        mp.undo()


def _gen_grads(step, run):
    """(port gradient, JAX gradient) per generator parameter."""
    want = port_models.build_generator(device="cpu", **CONFIG)
    want.load_state_dict(state_dict_from_jax(
        {"params": step["ggrads"], "batch_stats": step["gvars"]["batch_stats"]},
        n_primitives=PRIMS), strict=True)
    want = dict(want.named_parameters())
    out = {}
    for name, p in run["gen"].named_parameters():
        if p.grad is None:            # registered but unused, as in JAX
            assert name in ("conv1.weight", "conv1.bias") or ".bn7." in name
            continue
        out[name] = (p.grad.numpy(), want[name].detach().numpy())
    assert len(out) == len(jax.tree_util.tree_leaves(step["ggrads"]))
    return out


def test_anchored_losses_match_jax(step, anchored):
    """rec, coarse and refine losses, errG, errG_D, errD_real and errD_fake:
    rtol 3e-4 (readings up to 4.2e-5)."""
    np.testing.assert_allclose(anchored["losses"], step["losses"], rtol=3e-4)


def test_anchored_generator_gradients_match_jax(step, anchored):
    """Every generator gradient leaf within 3e-2 of JAX's in relative L2 (as
    the training step's test: the train-mode BatchNorms make each
    package's rounding move a gradient by about 1%; readings up to 1.2e-2);
    the leaves whose exact gradient is 0 below 3e-3 in norm on both sides
    (weight_l2 = 200 scales their rounding noise; readings up to 9.2e-4,
    against norms of 34 to 2.2e4 for the other leaves)."""
    for name, (got, want) in _gen_grads(step, anchored).items():
        if name in ZERO_GRAD:
            assert max(np.linalg.norm(got), np.linalg.norm(want)) < 3e-3, name
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 3e-2, (name, rel)


def test_anchored_discriminator_gradients_match_jax(step, anchored):
    """The discriminator step's gradient leaves within 5e-3 of JAX's in
    relative L2 (readings up to 1.0e-3, in the first blocks: the fake maps
    they see carry the generator's rounding)."""
    d = step["dvars"]
    want = disc_state_dict_from_jax(step["dgrads"], d["batch_stats"],
                                    d["spectral"])
    n = 0
    for name, p in anchored["disc"].named_parameters():
        w = want[name].numpy()
        rel = np.linalg.norm(p.grad.numpy() - w) / np.linalg.norm(w)
        assert rel <= 5e-3, (name, rel)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(step["dgrads"]))


def test_anchored_state_matches_jax(step, anchored):
    """After the step's four discriminator forwards: every spectral-norm u
    and the discriminator's running statistics within 1e-4 of each
    buffer's largest entry (readings up to 2.4e-5); the generator's running
    statistics rtol 1e-4, atol 1e-5 (as the training step's test)."""
    d = step["dvars"]
    want = disc_state_dict_from_jax(d["params"], step["new_dbstats"],
                                    step["new_spectral"])
    for name, buf in anchored["disc"].named_buffers():
        if name.endswith("num_batches_tracked"):
            continue
        w = want[name].numpy()
        np.testing.assert_allclose(buf.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    assert not torch.equal(anchored["disc"].conv1.u, torch.from_numpy(
        np.array(d["spectral"]["SNConv_0"]["u"])))     # the step moved u
    g = port_models.build_generator(device="cpu", **CONFIG)
    g.load_state_dict(state_dict_from_jax(
        {"params": step["gvars"]["params"], "batch_stats": step["new_gbstats"]},
        n_primitives=PRIMS), strict=True)
    want = dict(g.named_buffers())
    for name, buf in anchored["gen"].named_buffers():
        if name.endswith(("running_mean", "running_var")) and ".bn7." not in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_gan_step_checks_its_inputs(monkeypatch):
    gen, disc = (port_models.build_generator(device="cpu", **CONFIG),
                 port_models.build_discriminator(device="cpu", image_size=IMG))
    opts = [port_base.make_optimizer(m, port_gan.CONFIG) for m in (gen, disc)]
    with pytest.raises(ValueError):
        port_gan.gan_step(gen, disc, *opts, torch.zeros(2, 10, 4),
                          torch.zeros(2, 10, 3), torch.zeros(2), LR, RADIUS,
                          torch.Generator())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_models.build_discriminator()
