"""The SpareNet-GAN runner's step and the training settings that the runners
now read from a run's config, against the JAX package, at toy size.

- Two GAN steps held to ``sparenetGANRunner._gan_impl``: the shipped
  settings (EMD, feature and image matching) with a class-conditioned
  ``ProjectionD`` (8 classes, the count ``data_init`` sets for Synthetic
  and ShapeNet, so its label embedding trains), and a step with the chamfer
  metric, ``use_fm: false`` and ``use_cgan: false`` (``PatchDiscriminator``)
  that shows ``gan_step`` follows the config it is given. The port replays
  the JAX step's EMD and Chamfer assignments (the JAX step's own CPU
  auction gives them) and its Dropout2d masks (fed to both packages by
  tests/test_torch_port_gan_ops.py's stand-in for ``jax.random.bernoulli``),
  and the radius is given to both, as tests/test_torch_port_gan.py anchors
  its step.
- Adam with weight decay against the optax chain of the JAX package's
  ``make_optimizer``.
- ``TRAIN.serving_aligned``: the MDS arm of the training and eval forwards
  against the JAX package's ``define_G(train=True)`` and ``(train=False)``.
- The whole-GAN checkpoint of the port's runner: it reloads bit for bit.

Both steps run a stand-in generator of a few parameters (an offset cloud
and a scale, the same function in both packages): what they check lies
past the generator, whose own GAN step tests/test_torch_port_gan.py holds
to the JAX package. B=4, 64 -> 256 points, renders at img 64 and radius 5.
The runners run a toy config (``_toy_yaml``) on the CPU.
"""

import contextlib
import functools
import io
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparenet_tpu.configs.defaults import default_config as jax_default_config
from sparenet_tpu.models import SpareNetGenerator as JaxGenerator
from sparenet_tpu.models import define_G
from sparenet_tpu.models import sparenet as jax_model_mod
from sparenet_tpu.models.discriminator import PatchDiscriminator as JaxPatchD
from sparenet_tpu.models.discriminator import ProjectionD as JaxProjD
from sparenet_tpu.ops import common as jax_opc
from sparenet_tpu.ops import mds as jax_mds
from sparenet_tpu.renderer import ComputeDepthMaps as JaxRenderer
from sparenet_tpu.runners import base as jax_base
from sparenet_tpu.runners import sparenet as jax_runner_mod
from sparenet_tpu.runners import sparenet_gan as jax_gan_mod
from sparenet_tpu_torch import models as port_models
from sparenet_tpu_torch import train as train_cli
from sparenet_tpu_torch.configs import cfg_from_file
from sparenet_tpu_torch.models import discriminator as port_disc
from sparenet_tpu_torch.ops import chamfer, emd, mds
from sparenet_tpu_torch.runners import base as port_base
from sparenet_tpu_torch.runners import get_runner
from sparenet_tpu_torch.runners import sparenet_gan as port_gan
from sparenet_tpu_torch.utils.logging import set_logger
from sparenet_tpu_torch.utils.weights import (disc_state_dict_from_jax,
                                              state_dict_from_jax)
from tests.test_torch_port_gan import _keep, _recording
from tests.test_torch_port_gan_ops import PATCH_ZERO_GRAD, MaskFeed
from tests.test_torch_port_train import _replay, _tree_np, draw_variables

jax.config.update("jax_platforms", "cpu")

B, N_IN, N_OUT, PRIMS = 4, 64, 256, 2
CONFIG = dict(num_points=N_OUT, n_primitives=PRIMS, bottleneck_size=128,
              hide_size=128, use_selayer=True)
IMG, RADIUS, LR = 64, 5.0, 1e-4
N_CLASSES = 8
LABELS = np.array([3, 7, 0, 3], np.int32)
SHIPPED = dict(metric="emd", use_im=True, use_fm=True, use_cgan=True)
CHAMFER_NO_FM = dict(metric="chamfer", use_im=True, use_fm=False,
                     use_cgan=False)
WEIGHTS = dict(weight_gan=0.1, weight_l2=200.0, weight_im=1.0, weight_fm=1.0)


def _clouds(rng):
    """gt: N_OUT points of a noisy ellipsoid with random axes and centre;
    partial: N_IN points of its upper side, from other samples (as
    tests/test_torch_port_train.py makes them)."""
    v = rng.randn(B, 4 * N_OUT, 3)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    v = v * rng.uniform(0.1, 0.45, (B, 1, 3)) + rng.uniform(-0.05, 0.05, (B, 1, 3))
    v = v + 0.005 * rng.randn(*v.shape)
    gt = v[:, :N_OUT].astype(np.float32)
    partial = np.stack([c[N_OUT:][c[N_OUT:, 2] > 0][:N_IN]
                        for c in v]).astype(np.float32)
    return gt, partial


# the stand-in generator: coarse = template + offset + the partial's mean,
# middle = (coarse + template) / 2, refine = middle * scale, loss_mst =
# mean(offset^2); the same function in both packages
TEMPLATE = np.random.RandomState(5).uniform(-0.3, 0.3, (N_OUT, 3)).astype(
    np.float32)


def _toy_outputs(params, x, template):
    coarse = template + params["offset"] + x.mean(1)[:, None]
    middle = (coarse + template) * 0.5
    return coarse, middle, middle * params["scale"], (params["offset"] ** 2).mean()


class _JaxToy:
    def apply(self, variables, x, mutable):
        return (_toy_outputs(variables["params"], x, jnp.asarray(TEMPLATE)),
                {"batch_stats": {}})


class _PortToy(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        self.offset = torch.nn.Parameter(torch.from_numpy(params["offset"].copy()))
        self.scale = torch.nn.Parameter(torch.from_numpy(params["scale"].copy()))

    def forward(self, x):
        return _toy_outputs({"offset": self.offset, "scale": self.scale}, x,
                            torch.from_numpy(TEMPLATE))


def _disc_variables(disc, y0, rng):
    """Variables of the JAX discriminator's shape drawn as its init draws
    them (conv kernels normal(0, 0.02), dense kernels and the embedding
    Xavier-uniform, BatchNorm scales 1 + 0.02 normal, biases 0, each u a
    normalised normal draw, running statistics at their init), with numpy:
    no compiled init."""
    shapes = jax.eval_shape(
        functools.partial(disc.init, y=y0),
        {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((2, IMG, IMG, 16), jnp.float32))

    def leaf(path, s):
        keys = [p.key for p in path]
        col, name = keys[0], keys[-1]
        if col == "batch_stats":
            return np.full(s.shape, 1.0 if name == "var" else 0.0, np.float32)
        if col == "spectral":
            u = rng.randn(*s.shape)
            return (u / (np.linalg.norm(u) + 1e-12)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.02 * rng.randn(*s.shape)).astype(np.float32)
        if name == "bias":
            return np.zeros(s.shape, np.float32)
        if name == "kernel" and keys[-2].startswith("SNConv"):
            return (0.02 * rng.randn(*s.shape)).astype(np.float32)
        bound = np.sqrt(6.0 / (s.shape[0] + s.shape[1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_gan_step(setting: dict):
    """One JAX GAN step under ``setting``: its losses, gradients, updated
    discriminator state and the assignments and dropout masks the port
    replays."""
    rng = np.random.RandomState(0)
    gt, partial = _clouds(rng)
    calls: dict = {}
    gvars = {"params": {"offset": (0.05 * rng.randn(N_OUT, 3)).astype(
        np.float32), "scale": np.ones(3, np.float32)}, "batch_stats": {}}
    cgan = setting["use_cgan"]
    disc = (JaxProjD(num_classes=N_CLASSES, train=True) if cgan
            else JaxPatchD(train=True))
    y0 = jnp.zeros((2,), jnp.int32) if cgan else None
    dvars = _disc_variables(disc, y0, rng)
    gan = dict(WEIGHTS, **{k: setting[k] for k in ("use_im", "use_fm",
                                                   "use_cgan")})
    cfg = types.SimpleNamespace(
        NETWORK=types.SimpleNamespace(metric=setting["metric"],
                                      use_consist_loss=True),
        TRAIN=types.SimpleNamespace(betas=(0.0, 0.9), weight_decay=0),
        GAN=types.SimpleNamespace(**gan))
    tx = jax_base.make_optimizer(cfg)
    runner = types.SimpleNamespace(
        config=cfg, model_train=_JaxToy(), tx=tx, tx_d=tx,
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
                              jnp.asarray(gt), jnp.asarray(LABELS),
                              jnp.float32(LR))
        jax.effects_barrier()
    finally:
        mp.undo()
    dgrads, ggrads = calls["grads"]
    n_forwards = 4 if setting["use_fm"] else 3
    assert len(feed.masks) == (4 * n_forwards if cgan else 0)
    return dict(setting=setting, gt=gt, partial=partial, gvars=gvars,
                dvars=dvars, losses=[float(v) for v in losses],
                masks=feed.port_masks(), ggrads=ggrads, dgrads=dgrads,
                new_dbstats=_tree_np(ds.batch_stats),
                new_spectral=_tree_np(ds.spectral),
                assigns=calls.get("assigns", []),
                nn=[i for call in calls["nn"] for i in call])


def port_gan_step(step: dict):
    """The port's gan_step on the JAX step's weights and inputs, given the
    step's settings as a config dict, replaying the JAX step's assignments
    and masks."""
    setting = step["setting"]
    cgan = setting["use_cgan"]
    gen = _PortToy(step["gvars"]["params"])
    d = step["dvars"]
    disc = port_models.build_discriminator(
        device="cpu", use_cgan=cgan, num_classes=N_CLASSES if cgan else 0,
        image_size=IMG)
    disc.load_state_dict(disc_state_dict_from_jax(
        d["params"], d["batch_stats"], d["spectral"], use_cgan=cgan),
        strict=True)
    cfg = dict(port_gan.CONFIG, img_size=IMG, **setting)
    opt_g, opt_d = (port_base.make_optimizer(m, cfg) for m in (gen, disc))
    masks = iter(step["masks"])
    mp = pytest.MonkeyPatch()
    mp.setattr(port_disc, "dropout_mask", lambda shape, g, dev: next(masks))
    mp.setattr(emd, "auction_assign", _replay(step["assigns"]))
    mp.setattr(chamfer, "nn_idx", _replay(step["nn"]))
    try:
        losses = port_gan.gan_step(
            gen, disc, opt_g, opt_d, torch.from_numpy(step["partial"]),
            torch.from_numpy(step["gt"]), torch.from_numpy(LABELS).long(),
            LR, RADIUS, torch.Generator().manual_seed(0), cfg)
    finally:
        mp.undo()
    assert next(masks, None) is None            # every mask taken
    return dict(gen=gen, disc=disc, losses=[float(v) for v in losses])


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[SHIPPED, CHAMFER_NO_FM],
                ids=["emd-fm-cgan8", "chamfer-nofm-patch"])
def pair(request):
    step = jax_gan_step(request.param)
    return step, port_gan_step(step)


def test_gan_step_losses_match_jax(pair):
    """rec, coarse and refine losses, errG, errG_D, errD_real and errD_fake
    within rtol 1e-5 of the JAX step (readings up to 1.2e-6)."""
    step, port = pair
    np.testing.assert_allclose(port["losses"], step["losses"], rtol=1e-5)


def test_gan_step_gradients_match_jax(pair):
    """The stand-in generator's gradient leaves within 1e-4 of JAX's in
    relative L2 (readings up to 9.2e-6); every discriminator gradient leaf
    (the label embedding's with 8 classes) within 5e-4 (readings up to
    3.6e-5), PatchDiscriminator's conv biases ahead of a BatchNorm (exactly
    0) below 1e-5 in norm."""
    step, port = pair
    for name, p in port["gen"].named_parameters():
        w = np.asarray(step["ggrads"][name])
        rel = np.linalg.norm(p.grad.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-4, (name, rel)
    cgan = step["setting"]["use_cgan"]
    d = step["dvars"]
    want = disc_state_dict_from_jax(step["dgrads"], d["batch_stats"],
                                    d["spectral"], use_cgan=cgan)
    names = [name for name, _ in port["disc"].named_parameters()]
    assert ("embed.weight" in names) == cgan
    for name, p in port["disc"].named_parameters():
        got, w = p.grad.numpy(), want[name].numpy()
        if name in PATCH_ZERO_GRAD and not cgan:
            assert max(np.linalg.norm(got), np.linalg.norm(w)) < 1e-5, name
            continue
        rel = np.linalg.norm(got - w) / np.linalg.norm(w)
        assert rel <= 5e-4, (name, rel)
    assert len(names) == len(jax.tree_util.tree_leaves(step["dgrads"]))


def test_gan_step_state_matches_jax(pair):
    """After the step's three or four discriminator forwards: every
    spectral-norm u and running statistic within 1e-3 of each buffer's
    largest entry (readings up to 5.5e-4, in a running mean: the first Adam
    step moves each weight by about lr times its gradient's sign, so a
    gradient entry near 0 whose sign the rounding flips moves its weight by
    2 lr, and the later forwards see the updated weights; a forward more or
    less moves a running mean by about a tenth of a batch mean)."""
    step, port = pair
    d = step["dvars"]
    want = disc_state_dict_from_jax(d["params"], step["new_dbstats"],
                                    step["new_spectral"],
                                    use_cgan=step["setting"]["use_cgan"])
    for name, buf in port["disc"].named_buffers():
        if name.endswith("num_batches_tracked"):
            continue
        w = want[name].numpy()
        np.testing.assert_allclose(buf.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=name)


def test_adam_weight_decay_matches_optax():
    """TRAIN.weight_decay 1e-2 over 3 steps at lr 1e-3: torch Adam's L2
    weight decay against the JAX package's chain (add_decayed_weights,
    scale_by_adam, p - lr * u); parameters within rtol 1e-6 (readings:
    float32 rounding, below 1e-7)."""
    rng = np.random.RandomState(4)
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lr, wd = 1e-3, 1e-2
    cfg = types.SimpleNamespace(TRAIN=types.SimpleNamespace(
        betas=(0.0, 0.9), weight_decay=wd))
    tx = jax_base.make_optimizer(cfg)
    assert len(tx.init(params)) == 2              # decay, then Adam
    jp, state = dict(params), tx.init(params)
    for g in grads:
        jp, state = jax_base.apply_updates(tx, g, state, jp, lr)
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    opt = port_base.make_optimizer(module, dict(
        learning_rate=lr, betas=(0.0, 0.9), weight_decay=wd))
    for g in grads:
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(module[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-6, atol=1e-9)
    # with the decay the result differs from plain Adam's
    plain = optax.chain(optax.scale_by_adam(0.0, 0.9, eps=1e-8))
    qp, qs = dict(params), plain.init(params)
    for g in grads:
        qp, qs = jax_base.apply_updates(plain, g, qs, qp, lr)
    assert not np.allclose(np.asarray(qp["a"]), np.asarray(jp["a"]),
                           rtol=0, atol=1e-7)


def _toy_yaml(root, **extra) -> str:
    """A toy run of the runners: Synthetic, 64 -> 128 points, 4 primitives,
    chamfer, B=2, 4 training clouds, 2 validation clouds (the EMD metric at
    5 auction rounds), renders at img 64."""
    lines = [
        "DATASET: {train_dataset: Synthetic, test_dataset: Synthetic, "
        "n_outpoints: 128}",
        "CONST: {num_workers: 2, n_input_points: 64}",
        "NETWORK: {n_primitives: 4, metric: chamfer, use_selayer: true}",
        "TRAIN: {batch_size: 2, n_epochs: 1, save_freq: 1, log_freq: 1}",
        "TEST: {metric_name: ChamferDistance, batch_size: 2, emd_iters: 5}",
        f"RENDER: {{img_size: {IMG}}}",
        "DATASETS: {synthetic: {n_train: 4, n_val: 2}}",
    ] + [f"{k}: {v}" for k, v in extra.items()]
    path = os.path.join(root, "toy.yaml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _jax_cfg(yaml_path):
    from sparenet_tpu.configs import cfg_from_file as jax_cfg_from_file
    return jax_cfg_from_file(yaml_path, jax_default_config())


def test_serving_aligned_picks_match_jax(tmp_path, monkeypatch):
    """TRAIN.serving_aligned: the port's runner builds its generator with
    the batched MDS arm for the training forward and exact greedy MDS for
    validation, as the JAX package's define_G(train=True) and
    define_G(train=False) resolve ``mds_impl``. A toy-width train-mode
    forward of each package with that arm, on the same weights, calls its
    batched arm twice (and the port's eval forward its exact arm), and the
    port's arm gives the JAX arm's picks on the inputs the JAX forward gave
    it: the same set, in the same order but where two densities of the
    round lie within rtol 1e-5 (the exp2 dot form's sums round differently
    in the two packages; tests/test_torch_port_serving_ops.py's rule)."""
    path = _toy_yaml(str(tmp_path), GAN="{use_cgan: false}")
    text = open(path).read().replace("log_freq: 1}",
                                     "log_freq: 1, serving_aligned: true}")
    open(path, "w").write(text)
    jcfg = _jax_cfg(path)
    arm = define_G(jcfg, train=True).mds_impl
    assert arm == "batched" and define_G(jcfg, train=False).mds_impl == "auto"
    cfg = cfg_from_file(path)
    cfg.DIR.out_path = str(tmp_path / "run")
    cfg.DIR.checkpoints = str(tmp_path / "run" / "ckpt")
    refine = get_runner(cfg)(cfg, set_logger(None), device="cpu").model.refine
    assert (refine.train_mds, refine.mds) == ("batched", "exact")

    jax_model = JaxGenerator(**CONFIG, use_adain="share", encode="Residualnet",
                             train=True, mds_impl=arm)
    rng = np.random.RandomState(1)
    _, partial = _clouds(rng)
    variables = draw_variables(jax_model, partial, rng)
    calls: list = []

    def record(xyz, npoint, mml, impl="auto"):
        idx = jax_mds.minimum_density_sample(xyz, npoint, mml, impl=impl)
        jax.debug.callback(lambda *a: calls.append(_tree_np(a)), xyz, mml, idx)
        assert impl == "batched"
        return idx
    monkeypatch.setattr(jax_model_mod, "minimum_density_sample", record)
    jax.jit(lambda v, x: jax_model.apply(v, x, mutable=["batch_stats"]))(
        variables, jnp.asarray(partial))
    jax.effects_barrier()
    assert len(calls) == 2
    # one round takes every pick after the first at this size, from the
    # densities after pick 0
    assert len(mds._round_sizes(N_OUT, refine.mds_g, refine.mds_schedule)) == 1
    for xyz, mml, want in calls:
        got, _ = mds.minimum_density_sample_xyz(
            torch.tensor(xyz), N_OUT, torch.tensor(mml), refine.train_mds,
            g=refine.mds_g, schedule=refine.mds_schedule)
        got = got.numpy()
        _, temp = jax_mds._mds_batched(jnp.asarray(xyz), 1, jnp.asarray(mml),
                                       return_state=True, select="sort")
        temp = np.asarray(temp)
        for b in range(len(want)):
            assert set(got[b]) == set(want[b])
            for i in np.flatnonzero(got[b] != want[b]):
                pair = temp[b, [got[b, i], want[b, i]]]
                assert np.ptp(pair) <= 1e-5 * np.abs(pair).max(), (b, i)

    # the port's own forwards: the batched arm in train mode, exact in eval
    model = port_models.build_generator(device="cpu", **CONFIG,
                                        train_mds=refine.train_mds)
    model.load_state_dict(state_dict_from_jax(variables, n_primitives=PRIMS),
                          strict=True)
    arms = []
    for name in ("minimum_density_sample", "minimum_density_sample_xyz"):
        fn = getattr(mds, name)
        monkeypatch.setattr(mds, name, lambda *a, _f=fn, _n=name, **k: (
            arms.append((_n, a[3] if len(a) > 3 else "exact")), _f(*a, **k))[1])
    x = torch.from_numpy(partial)
    model.train()(x)
    assert arms == [("minimum_density_sample_xyz", "batched")] * 2
    arms.clear()
    port_models.complete(model, x)
    assert arms == [("minimum_density_sample", "exact")] * 2


def _state(runner) -> dict:
    """Everything a resume needs, as plain tensors."""
    out = {f"G.{k}": v for k, v in runner.model.state_dict().items()}
    out.update({f"D.{k}": v for k, v in runner.disc.state_dict().items()})
    for tag, opt in (("optG", runner.optimizer), ("optD", runner.optimizer_d)):
        for i, st in opt.state_dict()["state"].items():
            out.update({f"{tag}.{i}.{k}": v for k, v in st.items()})
    out["rng_radius"] = runner.radius_generator.get_state()
    out["rng_dropout"] = runner.dropout_generator.get_state()
    return out


@pytest.fixture(scope="module")
def gan_cli(tmp_path_factory):
    """``python -m sparenet_tpu_torch.train --gan --dataset Synthetic
    --device cpu`` on the toy config with ProjectionD (one epoch of 2
    steps): its last line and its runner."""
    root = tmp_path_factory.mktemp("gan_cli")
    path = _toy_yaml(str(root), GAN="{use_cgan: true}")
    runners = []
    mp = pytest.MonkeyPatch()
    run = train_cli.run
    mp.setattr(train_cli, "run", lambda r: (runners.append(r), run(r))[1])
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            assert train_cli.main(["--model", "sparenet", "--gan", "--config",
                                   path, "--dataset", "Synthetic", "--device",
                                   "cpu", "--workdir", str(root / "a")]) == 0
    finally:
        mp.undo()
    yield dict(root=root, yaml=path, runner=runners[0],
               line=json.loads(out.getvalue().splitlines()[-1]))
    shutil.rmtree(root, ignore_errors=True)         # 0.7 GB a checkpoint


def test_gan_runner_checkpoint_round_trip(gan_cli):
    """The GAN runner the CLI built (ProjectionD with the 8 Synthetic
    classes) after its epoch, and a runner resumed from its checkpoint
    through the CLI's ``build``: the resumed one holds the generator, the
    discriminator, both Adams' moments and steps and both step generators
    bit for bit, starts at epoch 2, and draws the radii the first would draw
    next."""
    first = gan_cli["runner"]
    assert type(first).__name__ == "sparenetGANRunner"
    assert first.config.DATASET.num_class == 8
    assert first.disc.embed.weight.shape[0] == 8
    assert len(first.radii) == 2 and set(first.radii) <= {5.0, 7.0, 10.0}
    ckpts = os.listdir(first.config.DIR.checkpoints)
    assert ckpts == ["ckpt-best.pth"]
    payload = torch.load(os.path.join(first.config.DIR.checkpoints, ckpts[0]),
                         weights_only=True)
    assert {"epoch_index", "best_metrics", "net_G", "optim_G", "net_D",
            "optim_D", "rng_radius", "rng_dropout"} == set(payload)
    second = train_cli.build([
        "--gan", "--config", gan_cli["yaml"], "--device", "cpu",
        "--workdir", str(gan_cli["root"] / "b"), "--epochs", "2", "--weights",
        os.path.join(first.config.DIR.checkpoints, ckpts[0])])
    assert second.init_epoch == 1
    want, got = _state(first), _state(second)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    draws = [first.draw_radius() for _ in range(4)]
    assert [second.draw_radius() for _ in range(4)] == draws


def test_gan_cli_json_line(gan_cli):
    """The CLI's last line: one epoch, its six mean losses, best metrics,
    seconds by part, the renderer's plain calls (3 p2i and 1 backward a
    step) and no launch."""
    line = gan_cli["line"]
    assert line["epochs"] == [1] and line["clouds_trained"] == 4
    assert set(line["epoch_losses"]["1"]) == set(port_gan.sparenetGANRunner.LOSSES)
    assert all(np.isfinite(v) for v in line["epoch_losses"]["1"].values())
    assert set(line["seconds"]) == {"data", "step", "val", "total"}
    assert line["launches"] == {} and line["device"] == "cpu"
    assert line["plain_calls"]["p2i"] == 6 and line["plain_calls"]["p2i_bwd"] == 2
    assert line["best_metrics"]["ChamferDistance"] > 0
