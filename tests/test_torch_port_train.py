"""One flagship SpareNet training step of the PyTorch port against the JAX
package, at toy size.

The flagship configuration (shared AdaIN, Residualnet encoder with SE, EMD
loss with the consistency Chamfer term, Adam with betas (0, 0.9)) at B=2,
256 -> 1024 points, 2 primitives of 512, bottleneck and hide 128 (the
EdgeConv stages keep their 256/256/512/1024 widths). The JAX step is
``model.apply`` + ``completion_loss`` + ``jax.value_and_grad`` +
``make_optimizer``/``apply_updates``, with the encoder's train commute on its
XLA arm and the auction's bids through the Pallas kernel in interpret mode
(both reached by monkeypatching, as the JAX package's own tests do). The
port's step is ``train_step`` on the CPU (plain versions).

Anchored: the port replays the JAX step's index outputs (kNN graphs, MDS
picks, EMD and Chamfer assignments, and the expansion MSTs of the JAX
clouds), because near-tie flips cascade (tests/test_forward_parity.py); the
loss, every gradient leaf, the running statistics and the updated
parameters are compared. Free-running: the port's own step, loss compared.
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
from sparenet_tpu.ops import common as jax_opc
from sparenet_tpu.ops import emd as jax_emd
from sparenet_tpu.ops.pallas import emd_pallas
from sparenet_tpu.runners.base import apply_updates, make_optimizer
from sparenet_tpu.runners import sparenet as jax_runner_mod
from sparenet_tpu.runners.sparenet import completion_loss as jax_loss
from sparenet_tpu_torch import models as port_models
from sparenet_tpu_torch.models import layers as port_layers
from sparenet_tpu_torch.ops import chamfer, emd, expansion_penalty, knn, mds
from sparenet_tpu_torch.runners import base as port_base
from sparenet_tpu_torch.runners import sparenet as port_runner
from sparenet_tpu_torch.utils.weights import state_dict_from_jax

jax.config.update("jax_platforms", "cpu")

B, N_IN, N_OUT, PRIMS = 4, 256, 1024, 2
S = N_OUT // PRIMS
LR = 1e-4
CONFIG = dict(num_points=N_OUT, n_primitives=PRIMS, bottleneck_size=128,
              hide_size=128, use_selayer=True)
CFG = types.SimpleNamespace(
    NETWORK=types.SimpleNamespace(metric="emd", use_consist_loss=True),
    TRAIN=types.SimpleNamespace(betas=(0.0, 0.9), weight_decay=0))


def _gt_and_partial(rng):
    """gt: 1024 points of an ellipsoid with a little noise, one ellipsoid
    per cloud with random axes in [0.1, 0.45] and a random centre;
    partial: 256 points of its upper side, from other samples."""
    v = rng.randn(B, 4 * N_OUT, 3)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    v = v * rng.uniform(0.1, 0.45, (B, 1, 3)) + rng.uniform(-0.05, 0.05, (B, 1, 3))
    v = v + 0.005 * rng.randn(*v.shape)
    gt = v[:, :N_OUT].astype(np.float32)
    # partial from other samples of the surface than gt's: a refine point
    # made of a partial point would otherwise sit on its gt match, where the
    # gradient of sqrt(dist) is unbounded
    partial = np.stack([c[N_OUT:][c[N_OUT:, 2] > 0][:N_IN]
                        for c in v]).astype(np.float32)
    return gt, partial


def draw_variables(model, partial, rng):
    """Variables of the model's shape, drawn from rng: kernels normal with
    std 1/sqrt(fan_in), BatchNorm scales 1 + 0.1 normal (negative for a
    third of the EdgeConv stages' channels, as trained scales can be, so
    that the train commute takes its min arm), biases 0.1 normal,
    running statistics at their init. Not the reference's initialisation
    (std 0.02 and 0.01 kernels): that emits a nearly degenerate coarse cloud
    and near-equal bottleneck features for the two samples, and train-mode
    BatchNorm then divides f32 rounding by a near-zero batch spread (up to
    1/sqrt(eps) = 316x, forward and backward), more than a parity test
    should have to absorb."""
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            jnp.asarray(partial))

    def leaf(path, s):
        keys = [p.key for p in path]
        name = keys[-1]
        if path[0].key == "batch_stats":
            return np.full(s.shape, 1.0 if name == "var" else 0.0, np.float32)
        if name == "kernel":
            v = rng.normal(0.0, s.shape[-2] ** -0.5, s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
            if "EdgeConvResFeat_0" in keys and keys[-2] != "BatchNorm_4":
                # a third negative in the EdgeConv stages: the min arm
                v = v * np.where(rng.rand(*s.shape) < 1 / 3, -1.0, 1.0)
        else:
            v = 0.1 * rng.normal(size=s.shape)
        return v.astype(np.float32)
    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    # the refiner's first conv after concat(global max feature, point
    # features): its 1024 global-feature rows at 1/8 scale
    k = variables["params"]["refine"]["PointNetRes_0"]["Conv1d_3"]["kernel"]
    k[:1024] *= 0.125
    return variables


def _tree_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _recording(calls, name, fn, pick):
    """fn, appending pick(output) to calls[name] while the step traces."""
    def rec(*args, **kw):
        out = fn(*args, **kw)
        calls.setdefault(name, []).append(pick(out))
        return out
    return rec


@pytest.fixture(scope="module")
def step():
    """The JAX step and the index outputs the port replays."""
    rng = np.random.RandomState(0)
    gt, partial = _gt_and_partial(rng)
    model = JaxGenerator(**CONFIG, use_adain="share", encode="Residualnet",
                         train=True)
    variables = draw_variables(model, partial, rng)
    params, bstats = variables["params"], variables["batch_stats"]
    calls: dict = {}
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

    def loss_fn(p):
        outs, upd = model.apply({"params": p, "batch_stats": bstats},
                                jnp.asarray(partial),
                                mutable=["batch_stats", "intermediates"])
        loss, c_l, r_l = jax_loss(CFG, *outs, jnp.asarray(gt))
        return loss, (upd, c_l, r_l, outs, calls)

    @jax.jit
    def run(p):
        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        tx = make_optimizer(CFG)
        new_p, _ = apply_updates(tx, grads, tx.init(p), p, LR)
        return loss, aux, grads, new_p

    try:
        loss, (upd, c_l, r_l, outs, rec), grads, new_params = run(params)
    finally:
        mp.undo()
    enc = upd["intermediates"]["encoder"]["EdgeConvResFeat_0"]
    return dict(gt=gt, partial=partial, variables=variables,
                loss=[float(loss), float(c_l), float(r_l)],
                grads=_tree_np(grads), new_params=_tree_np(new_params),
                new_bstats=_tree_np(upd["batch_stats"]),
                nbrs=[np.asarray(enc[f"nbr{i}"][0]) for i in (1, 2, 3, 4)],
                picks=_tree_np(rec["picks"]), assigns=_tree_np(rec["assigns"]),
                nn=_tree_np(list(rec["nn"][0])),
                outs=[np.asarray(o) for o in outs[:3]])


def _replay(values, fn=None):
    """An op that returns ``values`` in call order (through ``fn``)."""
    it = iter(values)

    def op(*args, **kw):
        v = next(it)
        return fn(v) if fn else torch.from_numpy(np.array(v))
    return op


def _port(step):
    sd = state_dict_from_jax(step["variables"], n_primitives=PRIMS)
    model = port_models.build_generator(device="cpu", **CONFIG)
    model.load_state_dict(sd, strict=True)
    opt = port_base.make_optimizer(model, port_runner.CONFIG)
    return model, opt


def _load(values):
    """A port model holding ``values`` (a JAX variables tree)."""
    m = port_models.build_generator(device="cpu", **CONFIG)
    m.load_state_dict(state_dict_from_jax(values, n_primitives=PRIMS),
                      strict=True)
    return m


@pytest.fixture(scope="module")
def anchored(step):
    model, opt = _port(step)
    mp = pytest.MonkeyPatch()
    mp.setattr(knn, "knn_idx", _replay(step["nbrs"]))
    mp.setattr(mds, "minimum_density_sample", _replay(step["picks"]))
    mp.setattr(expansion_penalty, "mst_charges", _replay(
        step["outs"][:2], lambda c: expansion_penalty.mst_charges_plain(
            torch.from_numpy(np.array(c)).reshape(-1, S, 3))))
    mp.setattr(emd, "auction_assign", _replay(step["assigns"]))
    mp.setattr(chamfer, "nn_idx", _replay(step["nn"]))
    try:
        loss = port_runner.train_step(model, opt, torch.from_numpy(step["partial"]),
                                      torch.from_numpy(step["gt"]), LR)
    finally:
        mp.undo()
    return dict(model=model, loss=[float(v) for v in loss])


# Gradients that are exactly 0 in exact arithmetic: biases of layers whose
# output a normalisation centres (BatchNorm, or AdaIN in the decoder), and
# refine bn3's bias, a constant shift of the global feature that the next
# BatchNorm removes. Both packages give rounding noise there.
ZERO_GRAD = ({"encoder.linear.bias", "refine.residual.bn3.bias"}
             | {f"decoder.decoder.conv{i}.bias" for i in (1, 2, 3)}
             | {f"refine.residual.conv{i}.bias" for i in range(1, 7)})


def _grads(step, anchored):
    """(port gradient, JAX gradient) per parameter, in the port's layout."""
    want = dict(_load({"params": step["grads"],
                       "batch_stats": step["variables"]["batch_stats"]}
                      ).named_parameters())
    out = {}
    for name, p in anchored["model"].named_parameters():
        if p.grad is None:            # registered but unused, as in JAX
            assert name in ("conv1.weight", "conv1.bias") or ".bn7." in name
            continue
        out[name] = (p.grad.numpy(), want[name].detach().numpy())
    assert len(out) == len(jax.tree_util.tree_leaves(step["grads"]))
    return out


def test_anchored_loss_matches_jax(step, anchored):
    """loss, coarse_loss and refine_loss: rtol 3e-5 (readings: up to
    6.9e-6, from the refiner's train-mode BatchNorms; see the gradient test
    below)."""
    np.testing.assert_allclose(anchored["loss"], step["loss"], rtol=3e-5)


def test_anchored_gradients_match_jax(step, anchored):
    """Every gradient leaf, mapped into the port's layout, within 3e-2 of
    the JAX leaf in relative L2 norm. Readings: at most 1.2%, and the port's
    step with its BatchNorm statistics taken in f64 differs from its f32 step
    by as much: the reference's statistics are E[x^2] - E[x]^2 in f32, and
    the refiner's and encoder's BatchNorms see channels whose mean is many
    times their spread, so each package's own rounding moves the gradient
    by about 1%. The leaves whose exact gradient is 0 (ZERO_GRAD) must be
    below 1e-5 in norm on both sides (readings: 3.2e-6)."""
    for name, (got, want) in _grads(step, anchored).items():
        if name in ZERO_GRAD:
            assert np.linalg.norm(got) < 1e-5 and np.linalg.norm(want) < 1e-5, name
            continue
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 3e-2, (name, rel)


def test_anchored_running_stats_match_jax(step, anchored):
    """Every BatchNorm's new running mean and (biased) variance: rtol 1e-4,
    atol 1e-5 (batch statistics of activations that agree to ~1e-6
    relative, through the same conditioning as the gradients)."""
    want = dict(_load({"params": step["variables"]["params"],
                       "batch_stats": step["new_bstats"]}).named_buffers())
    n = 0
    for name, buf in anchored["model"].named_buffers():
        if name.endswith(("running_mean", "running_var")) and ".bn7." not in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
            n += 1
    assert n == len(jax.tree_util.tree_leaves(step["new_bstats"]))


def test_anchored_update_is_the_jax_optimizers(step, anchored):
    """The port's parameters after its Adam step equal the JAX optimizer
    (make_optimizer + apply_updates, lr 1e-4) applied to the port's own
    gradients from the same parameters: within 1e-7 |p| + 1e-3 lr (torch
    and optax round the bias corrections differently). With the gradient
    test above, this holds the updated parameters to the JAX step's."""
    grads = {n: g for n, (g, _) in _grads(step, anchored).items()}
    old = dict(_port(step)[0].named_parameters())
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


def _encoder_against_jax(monkeypatch, commute: bool):
    """The EdgeConv encoder alone in train mode, port against JAX on the
    same kNN graphs, at B=4, 48 points, SE on, a third of the stage
    BatchNorm scales negative; JAX on its XLA commute arm (``commute``) or
    on its dense edge-tensor arm. Returns (port, JAX) pairs: the output, the
    new running statistics by name, and the gradients of a squared-error
    loss by name."""
    from sparenet_tpu.models.layers import EdgeConvResFeat as JaxEnc
    monkeypatch.setattr(jax_opc, "TRAIN_COMMUTE", commute)
    monkeypatch.setattr(jax_opc, "TRAIN_COMMUTE_IMPL", "xla" if commute else "0")
    rng = np.random.RandomState(1)
    b, n, h = 4, 48, 128
    jm = JaxEnc(k=8, hide_size=4096, output_size=h, use_selayer=True, train=True)
    x = (rng.rand(b, n, 3) - 0.5).astype(np.float32)
    tgt = rng.rand(b, h).astype(np.float32)
    v = _tree_np(jax.jit(jm.init)({"params": jax.random.PRNGKey(1)},
                                  jnp.asarray(x)))
    for i in range(4):      # negative scales take the stages' min arm
        scale = v["params"][f"BatchNorm_{i}"]["scale"] = np.array(
            v["params"][f"BatchNorm_{i}"]["scale"])
        scale[rng.rand(*scale.shape) < 1 / 3] *= -1.0

    @jax.jit
    def run(p):
        def loss_fn(p):
            out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                                jnp.asarray(x),
                                mutable=["batch_stats", "intermediates"])
            return jnp.mean((out - tgt) ** 2), (out, upd)
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (_, (out, upd)), g = run(v["params"])
    nbrs = [np.asarray(upd["intermediates"][f"nbr{i}"][0]) for i in (1, 2, 3, 4)]

    def port_sd(params, bstats):
        return _encoder_state_dict({"params": params, "batch_stats": bstats})

    pm = port_layers.EdgeConvResFeat(k=8, hide_size=4096, output_size=h,
                                     use_selayer=True)
    pm.load_state_dict(port_sd(v["params"], v["batch_stats"]), strict=True)
    pm.train()
    monkeypatch.setattr(knn, "knn_idx", _replay(nbrs))
    pout = pm(torch.from_numpy(x))
    ((pout - torch.from_numpy(tgt)) ** 2).mean().backward()
    want_bs = port_sd(v["params"], _tree_np(upd["batch_stats"]))
    stats = {name: (buf.numpy(), want_bs[name].numpy())
             for name, buf in pm.named_buffers()
             if name.endswith(("running_mean", "running_var"))}
    want_g = port_sd(_tree_np(g), v["batch_stats"])
    grads = {name: (p.grad.numpy(), want_g[name].numpy())
             for name, p in pm.named_parameters()}
    return (pout.detach().numpy(), np.asarray(out)), stats, grads


def test_train_commute_encoder_matches_jax(monkeypatch):
    """The EdgeConv encoder alone in train mode against JAX's XLA commute
    arm on the same kNN graphs, at B=4, 48 points, SE on: output and new
    running statistics rtol 1e-4 / atol 1e-5, the gradient of a
    squared-error loss within 1e-3 of each leaf in relative L2 norm
    (readings: up to 1.1e-4)."""
    (pout, out), stats, grads = _encoder_against_jax(monkeypatch, True)
    np.testing.assert_allclose(pout, out, rtol=1e-4, atol=1e-5)
    for name, (got, want) in stats.items():
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)
    for name, (got, want) in grads.items():
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-3, (name, rel)


def test_train_encoder_matches_jax_dense_arm(monkeypatch):
    """The same against JAX's dense edge-tensor arm (TRAIN_COMMUTE off, what
    "auto" runs on the CPU and the GPU: the original reference's math). The
    two arms sum the BatchNorm statistics in another order (closed form
    from per-point sums against sums over the [B, N, k, C] edge tensor) and
    route a max's gradient to the first extremum or split it among tied
    edges. Output and running statistics rtol 1e-4 / atol 1e-5, each
    gradient leaf within 3e-3 in relative L2 (readings: up to 9.5e-4, where
    JAX's own commute arm is 8.5e-4 from its dense arm and 1.0e-4 from the
    port: the gap is the two formulations', not the port's)."""
    (pout, out), stats, grads = _encoder_against_jax(monkeypatch, False)
    np.testing.assert_allclose(pout, out, rtol=1e-4, atol=1e-5)
    for name, (got, want) in stats.items():
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)
    for name, (got, want) in grads.items():
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 3e-3, (name, rel)


def _encoder_state_dict(variables):
    """EdgeConvResFeat variables -> the port encoder's state_dict, by the
    generator's rules (keys under encoder.feat_extractor)."""
    from sparenet_tpu_torch.utils import weights
    wrap = {col: {"encoder": {"EdgeConvResFeat_0": variables[col]}}
            for col in ("params", "batch_stats")}
    prefix = "encoder.feat_extractor."
    sd = {}
    for col, fpath, tkey, kind, _ in weights.netG_rules(use_selayer=True).entries:
        if tkey.startswith(prefix):
            v = np.asarray(weights._get(wrap[col], fpath), np.float32)
            sd[tkey[len(prefix):]] = torch.from_numpy(
                np.array(weights._to_torch(kind, v), order="C"))
            if tkey.endswith(".running_var"):
                sd[tkey[len(prefix):-len("running_var")] + "num_batches_tracked"] = \
                    torch.zeros((), dtype=torch.int64)
    return sd


def test_train_step_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    model = port_models.build_generator(device="cpu", **CONFIG)
    opt = port_base.make_optimizer(model, port_runner.CONFIG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_models.build_generator(**CONFIG)
    with pytest.raises(ValueError):
        port_runner.train_step(model, opt, torch.zeros(2, 10, 4),
                               torch.zeros(2, 10, 3), LR)
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    monkeypatch.setattr(model, "parameters", lambda: iter([on_card]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_runner.train_step(model, opt, torch.zeros(2, 10, 3),
                               torch.zeros(2, 10, 3), LR)


def test_lr_schedule_matches_jax():
    from sparenet_tpu.runners.base import lr_for_epoch as jax_lr
    cfg = types.SimpleNamespace(TRAIN=types.SimpleNamespace(
        learning_rate=1e-4, lr_milestones=[3, 5], gamma=0.5))
    pcfg = dict(port_runner.CONFIG, lr_milestones=(3, 5))
    for e in range(8):
        assert port_base.lr_for_epoch(pcfg, e) == jax_lr(cfg, e)
