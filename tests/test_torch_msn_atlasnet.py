"""The port's AtlasNet and MSN (models, layers and weights) against the JAX
package's, on the CPU at toy size: B=2, 256 -> 256 points, 4 primitives of
64, bottleneck 64 (PointNetfeat's hide 1024, as the models fix it).

The variables are drawn well-conditioned on the JAX side (kernels normal
with std 1/sqrt(fan_in), BatchNorm scales 1 + 0.1 normal, biases 0.1 normal,
running statistics jittered): the reference's initialisation folds every
primitive to within 5e-5 of one point, where an elementwise check says
little. They reach the port through ``utils/weights.py``. The grids are
passed to both (the JAX package draws them from its 'grid' PRNG stream).
Parity contract (tests/test_forward_parity.py): deterministic stages
elementwise within atol 3e-6 and rtol 1e-4; MDS exact when fed the JAX
package's cloud and mml; refine elementwise when anchored on the JAX
package's coarse cloud and picks, by Chamfer when free-running.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.models import AtlasNet as JaxAtlasNet
from sparenet_tpu.models import MSN as JaxMSN
from sparenet_tpu.models import layers as jax_layers
from sparenet_tpu.models import msn as jax_msn_mod
from sparenet_tpu.models.atlasnet import PointEncoder as JaxPointEncoder
from sparenet_tpu.ops import common as jax_opc
from sparenet_tpu.ops.chamfer import chamfer_raw
from sparenet_tpu.utils import torch_import as ti
from sparenet_tpu_torch import models as port_models
from sparenet_tpu_torch.models import layers as port_layers
from sparenet_tpu_torch.models.atlasnet import PointEncoder
from sparenet_tpu_torch.models.sparenet import flagged_base
from sparenet_tpu_torch.ops import expansion_penalty, mds
from sparenet_tpu_torch.utils import weights
from sparenet_tpu_torch.utils.weights import (reference_state_dict,
                                              state_dict_from_jax)

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

B, N_IN, N, P, D = 2, 256, 256, 4, 64
S = N // P
ATOL, RTOL = 3e-6, 1e-4
FAMILIES = {"AtlasNet": JaxAtlasNet, "MSN": JaxMSN}


def draw(shapes, rng):
    """Well-conditioned variables of the given shape tree (see the module
    docstring)."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, s.shape[-2] ** -0.5, s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        elif name == "mean":
            v = rng.uniform(-0.3, 0.3, s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.normal(size=s.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    partial = (rng.rand(B, N_IN, 3) - 0.5).astype(np.float32)
    grids = rng.rand(P, B, S, 2).astype(np.float32)
    return rng, partial, grids


def port_model(name, sd, **kw):
    model = getattr(port_models, name)(num_points=N, bottleneck_size=D,
                                       n_primitives=P, **kw)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def chamfer(a, b) -> float:
    d1, d2, _, _ = chamfer_raw(jnp.asarray(a), jnp.asarray(b))
    return float(jnp.mean(d1) + jnp.mean(d2))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class _JaxGenConStack(fnn.Module):
    """PointGenCon vmapped over the primitives, as the JAX models run it."""

    train: bool

    @fnn.compact
    def __call__(self, y):
        return fnn.vmap(jax_layers.PointGenCon, in_axes=(0,), out_axes=0,
                        axis_size=P,
                        variable_axes={"params": 0, "batch_stats": 0},
                        split_rngs={"params": True})(
            bottleneck_size=2 + D, train=self.train)(y)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _layer_sd(name, variables):
    """A layer's JAX variables -> its port state_dict, by AtlasNet's rules
    (PointGenCon's per-primitive keys stacked by its module's load
    hook)."""
    prefix, root, kept = {
        "PointNetfeat": ("encoder.feat_extractor.",
                         ("PointEncoder_0", "PointNetfeat_0"), 0),
        "PointEncoder": ("encoder.", ("PointEncoder_0",), 0),
        # the wrapper module keeps the vmap's name in its variables
        "PointGenCon": ("decoder.", ("VmapPointGenCon_0",), 1)}[name]
    out = {}
    for col, fpath, tkey, kind, stacked in weights.atlasnet_rules().entries:
        if fpath[:len(root)] != root:
            continue
        v = np.asarray(_get(variables[col], fpath[len(root) - kept:]),
                       np.float32)
        for p in range(P) if stacked else (None,):
            key = tkey.format(p=p)[len(prefix):]
            out[key] = torch.from_numpy(np.array(
                weights._to_torch(kind, v if p is None else v[p]), order="C"))
            if key.endswith(".running_var") and not stacked:
                out[key[:-len("running_var")] + "num_batches_tracked"] = \
                    torch.zeros((), dtype=torch.int64)
    return out


LAYERS = ("PointNetfeat", "PointGenCon", "PointEncoder")
# The layer checks' batch. Train-mode BatchNorm takes its statistics over the
# batch (PointEncoder's bottleneck BatchNorm over the samples alone; within a
# primitive, PointGenCon's first over the grid's two columns and the
# samples' styles): at B=2 some channel's mean is 39 times its spread, and
# both packages' f32 statistics (E[x^2] - E[x]^2, flax's) then sit about
# 1e-4 from their f64 values. At B=8 the channels are spread.
B_LAYER = 8


def _fresh(name):
    return {"PointNetfeat": lambda: port_layers.PointNetfeat(hide_size=128),
            "PointEncoder": lambda: PointEncoder(bottleneck_size=D),
            "PointGenCon": lambda: port_layers.PointGenConStack(P, 2 + D)}[name]()


def ellipsoids(rng, b, n):
    """b clouds of n points on ellipsoids of random axes and centres: the
    samples' global features differ (uniform cubes give nearly equal
    max-pooled features, and the bottleneck's train-mode BatchNorm, over
    the samples, then divides rounding by their spread)."""
    v = rng.randn(b, n, 3)
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    v = v * rng.uniform(0.1, 0.5, (b, 1, 3)) + rng.uniform(-0.3, 0.3, (b, 1, 3))
    return v.astype(np.float32)


def _layer_case(name, train, rng):
    """(JAX module, port module, JAX inputs, port inputs) of one layer."""
    if name in ("PointNetfeat", "PointEncoder"):
        jm = (jax_layers.PointNetfeat(hide_size=128, train=train)
              if name == "PointNetfeat"
              else JaxPointEncoder(bottleneck_size=D, train=train))
        x = ellipsoids(rng, B_LAYER, N_IN)
        return jm, _fresh(name), (x,), (x,)
    jm = _JaxGenConStack(train=train)
    pm = _fresh(name)
    grids = rng.rand(P, B_LAYER, S, 2).astype(np.float32)
    style = rng.randn(B_LAYER, D).astype(np.float32)
    y = np.concatenate([grids, np.broadcast_to(style[None, :, None, :],
                                               (P, B_LAYER, S, D))], -1)
    return jm, pm, (y,), (grids, style)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", LAYERS)
def test_layer_matches_jax(name, train):
    """Each new layer against flax on the same inputs and converted weights:
    the output elementwise (atol 3e-6, rtol 1e-4); in train mode also every
    BatchNorm's new running mean and variance."""
    rng = np.random.RandomState(3)
    jm, pm, jin, pin = _layer_case(name, train, rng)
    shapes = jax.eval_shape(jm.init, {"params": jax.random.PRNGKey(0)},
                            *map(jnp.asarray, jin))
    variables = draw(shapes, rng)
    pm.load_state_dict(_layer_sd(name, variables), strict=True)
    pm.train(train)
    if train:
        out, upd = jax.jit(lambda v, *x: jm.apply(v, *x, mutable=["batch_stats"]))(
            variables, *map(jnp.asarray, jin))
    else:
        out = jax.jit(jm.apply)(variables, *map(jnp.asarray, jin))
    got = pm(*map(torch.from_numpy, pin))
    close(got.detach().numpy(), out)
    if train:
        want = _layer_sd(name, {"params": variables["params"],
                                "batch_stats": jax.tree_util.tree_map(
                                    np.asarray, upd["batch_stats"])})
        want_pm = _fresh(name)
        want_pm.load_state_dict(want, strict=True)
        n = 0
        for key, v in want_pm.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                close(pm.state_dict()[key].numpy(), v.numpy(), atol=1e-6)
                n += 1
        assert n == 2 * (4 if name == "PointEncoder" else 3)


# ---------------------------------------------------------------------------
# the eval forwards, parity mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def family():
    """Per family: the JAX eval forward on drawn variables with grids
    passed, the port model holding them, and for MSN the JAX package's mml
    and MDS picks on its own coarse cloud (the values its forward computes
    from that cloud)."""
    out = {}
    for name, cls in FAMILIES.items():
        rng, partial, grids = inputs()
        jm = cls(num_points=N, bottleneck_size=D, n_primitives=P, train=False)
        shapes = jax.eval_shape(
            jm.init, {"params": jax.random.PRNGKey(0)}, jnp.asarray(partial),
            jnp.asarray(grids))
        variables = draw(shapes, rng)
        jout = jax.tree_util.tree_map(np.array, jax.jit(jm.apply)(
            variables, jnp.asarray(partial), jnp.asarray(grids)))
        rec = {}
        if name == "MSN":
            rec = dict(zip(("mml", "idx"), map(np.array,
                                               _jax_picks(jout[0], partial))))
        sd = state_dict_from_jax(variables, n_primitives=P, model_type=name)
        out[name] = dict(variables=variables, partial=partial, grids=grids,
                         jax=jout, port=port_model(name, sd), sd=sd, **rec)
    return out


@jax.jit
def _jax_picks(coarse, partial):
    """The JAX MSN's parity mml and MDS picks, from its coarse cloud."""
    _, _, mml = jax_msn_mod.expansion_penalty(coarse, S, 1.5)
    xyz = jnp.concatenate([coarse, partial], 1)
    return mml, jax_msn_mod.minimum_density_sample(xyz, N, mml)


def test_atlasnet_forward_matches_jax(family):
    """AtlasNet's eval forward with grids passed: elementwise."""
    f = family["AtlasNet"]
    got = port_models.complete(f["port"], torch.from_numpy(f["partial"]),
                               grids=torch.from_numpy(f["grids"]))
    assert got.shape == (B, N, 3)
    assert np.abs(f["jax"]).max() > 0.1      # not a degenerate fold
    close(got.numpy(), f["jax"])


def test_msn_forward_matches_jax(family):
    """MSN's eval forward with grids passed: coarse elementwise; loss_mst
    and mml within rtol 1e-4; the MDS picks on the JAX package's cloud and
    mml equal to its own; refine elementwise anchored on its coarse cloud
    and picks, and within Chamfer 1e-4 free-running."""
    f = family["MSN"]
    model, partial = f["port"], torch.from_numpy(f["partial"])
    coarse, refine, loss_mst = port_models.complete(
        model, partial, grids=torch.from_numpy(f["grids"]))
    j_coarse, j_refine, j_loss = f["jax"]
    close(coarse.numpy(), j_coarse)
    np.testing.assert_allclose(float(loss_mst), float(j_loss), rtol=1e-4)
    jc = torch.from_numpy(j_coarse)
    _, _, mml = expansion_penalty.expansion_penalty(jc, S, 1.5)
    np.testing.assert_allclose(mml.numpy(), f["mml"], rtol=1e-4)
    base = flagged_base(jc, partial)
    idx = mds.minimum_density_sample(base[..., :3].contiguous(), N,
                                     torch.from_numpy(f["mml"]))
    np.testing.assert_array_equal(idx.numpy(), f["idx"])
    with torch.no_grad():
        anchored = model.finish(base, torch.from_numpy(f["idx"]))
    close(anchored.numpy(), j_refine)
    assert chamfer(refine.numpy(), j_refine) <= 1e-4


def test_grids_come_from_the_callers_generator(family):
    """Without grids the forward draws them on the CPU from the generator it
    is given: the same seed gives the same cloud, another seed another, and
    there is no draw from torch's global RNG (the forward needs grids or a
    generator)."""
    model = family["AtlasNet"]["port"]
    x = torch.from_numpy(family["AtlasNet"]["partial"])

    def run(seed):
        return port_models.complete(model, x,
                                    generator=torch.Generator().manual_seed(seed))
    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    grids = torch.rand((P, B, S, 2), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, port_models.complete(model, x, grids=grids))
    with pytest.raises(ValueError, match="torch.Generator"):
        port_models.complete(model, x)
    with pytest.raises(ValueError, match="grids must be"):
        port_models.complete(model, x, grids=grids[:, :1])


# ---------------------------------------------------------------------------
# MSN's serving branch
# ---------------------------------------------------------------------------

# Coarse: the port's encoder products at bf16 precision where the JAX CPU
# program keeps f32, and the decoders' bf16 chains on both sides. Refine,
# fed the JAX package's coarse cloud: the residual net's bf16 chain alone.
# Readings: coarse max abs 7.8e-3, refine 6.9e-3, free-running Chamfer
# 4.2e-5 (the JAX package's own serving envelope: max abs 0.05, Chamfer
# 5e-4, tests/test_serving_mode.py).
SERVE_COARSE_ATOL, SERVE_REFINE_ATOL = 2e-2, 2e-2


def test_msn_serving_branch_matches_jax(family, monkeypatch):
    """MSN in serving mode, exact arm, at the family's mml_calibration 5.65,
    against the JAX MSN with FAST_MATH on: coarse within 2e-2, loss_mst 0;
    the mml estimate on the JAX package's serving coarse cloud within rtol
    1e-4 of its own, the picks on it equal; refine fed that cloud within
    2e-2 of the JAX package's, and Chamfer 1e-4 free-running."""
    f = family["MSN"]
    monkeypatch.setattr(jax_opc, "FAST_MATH", True)
    jm = JaxMSN(num_points=N, bottleneck_size=D, n_primitives=P, train=False,
                mds_impl="exact")

    @jax.jit
    def run(variables, partial, grids):
        coarse, refine, loss = jm.apply(variables, partial, grids)
        mml = jax_msn_mod.mean_mst_length_estimate(coarse, S,
                                                   calibration=jm.mml_calibration)
        idx, _ = jax_msn_mod.minimum_density_sample_xyz(
            jnp.concatenate([coarse, partial], 1), N, mml, impl="exact")
        return coarse, refine, loss, mml, idx
    j_coarse, j_refine, j_loss, j_mml, j_idx = map(np.array, run(
        f["variables"], jnp.asarray(f["partial"]), jnp.asarray(f["grids"])))
    monkeypatch.undo()
    model = port_model("MSN", f["sd"], serving=True, mds="exact")
    assert model.resampler.mml_calibration == 5.65 == jm.mml_calibration
    partial = torch.from_numpy(f["partial"])
    coarse, refine, loss = port_models.complete(
        model, partial, grids=torch.from_numpy(f["grids"]))
    assert float(loss) == 0.0 == float(j_loss)
    close(coarse.numpy(), j_coarse, atol=SERVE_COARSE_ATOL)
    jc = torch.from_numpy(j_coarse)
    mml = expansion_penalty.mean_mst_length_estimate(jc, S, 5.65)
    np.testing.assert_allclose(mml.numpy(), j_mml, rtol=1e-4)
    with torch.no_grad():
        anchored, _ = model.serve(jc, partial)
    idx, _ = mds.minimum_density_sample_xyz(torch.cat([jc, partial], 1), N,
                                            torch.from_numpy(j_mml))
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    close(anchored.numpy(), j_refine, atol=SERVE_REFINE_ATOL)
    assert chamfer(refine.numpy(), j_refine) <= 1e-4


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FAMILIES))
def test_weights_both_ways_match_jax(family, name):
    """``state_dict_from_jax`` against the JAX package's export of the same
    variables (every tensor equal; the export names the stacked decoders'
    BatchNorm step counts with a literal "{p}" where the reference numbers
    them), and ``reference_state_dict`` of the port model back through the
    JAX package's converter (strict) to the same variables; the port's
    reference layout loads strictly into a fresh port model."""
    f = family[name]
    export = {"AtlasNet": ti.export_atlasnet_state_dict,
              "MSN": ti.export_msn_state_dict}[name](f["variables"],
                                                    n_primitives=P)
    sd = f["sd"]
    literal = {k for k in export if "{p}" in k}
    assert literal == {f"decoder.{{p}}.bn{i}.num_batches_tracked"
                       for i in (1, 2, 3)}
    assert set(export) - literal <= set(sd)
    assert set(sd) - set(export) == {f"decoder.{p}.bn{i}.num_batches_tracked"
                                     for p in range(P) for i in (1, 2, 3)}
    for key in set(export) - literal:
        np.testing.assert_array_equal(sd[key].numpy(), export[key], err_msg=key)
    ref = reference_state_dict(f["port"])
    assert set(ref) == set(sd)
    convert = {"AtlasNet": ti.convert_atlasnet_state_dict,
               "MSN": ti.convert_msn_state_dict}[name]
    back = convert({k: v.numpy() for k, v in ref.items()}, n_primitives=P,
                   strict=True)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, f["variables"]))
    fresh = port_model(name, ref)
    for key, v in fresh.state_dict().items():
        assert torch.equal(v, f["port"].state_dict()[key]), key


def test_define_g_builds_each_family_from_the_config():
    """``define_G`` builds AtlasNet and MSN at define_G's widths (bottleneck
    and PointNetfeat's hide 1024) from the config, initialised from the seed
    on the CPU the same way twice; MSN takes NETWORK.mml_calibration when it
    is > 0 and the serving dial."""
    from sparenet_tpu_torch.configs import cfg_from_file, shipped_yaml
    for model, name in (("atlasnet", "AtlasNet"), ("msn", "MSN")):
        cfg = cfg_from_file(shipped_yaml(model))
        cfg.DATASET.n_outpoints, cfg.NETWORK.n_primitives = 128, 4
        a = port_models.define_G(cfg, device="cpu")
        b = port_models.define_G(cfg, device="cpu")
        assert type(a).__name__ == name and not a.training
        assert a.encoder.linear.weight.shape == (1024, 1024)
        assert a.decoder.conv1.weight.shape == (4, 1026, 1026)
        for k, v in a.state_dict().items():
            assert torch.equal(v, b.state_dict()[k]), k
    cfg.NETWORK.mml_calibration = 2.5
    dial = port_models.ServingDial(mds="hybrid")
    m = port_models.define_G(cfg, device="cpu", dial=dial)
    assert m.resampler.mml_calibration == 2.5 and m.mds == "hybrid"
    assert m.serving and m.res.serving and m.decoder.serving
