"""The port's serving-mode SpareNet eval forward against the JAX package's.

A toy generator as tests/test_serving_mode.py builds it (B=2, 128 -> 256
points, 4 primitives, bottleneck and hide 128, SE on), with jittered
BatchNorm statistics, its variables carried into the port by
``state_dict_from_jax``. The JAX package runs its serving mode on the CPU
(``set_fast_math(True)``), with its kNN graphs from the packed Pallas kernel
in interpret mode (``knn_idx`` patched in its layers module: on the CPU it
would take the exact XLA selection) and its MDS globals set to toy rounds
(G 64, schedule (16,), tail 64); the port is built with the same arguments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.models import SpareNetGenerator as JaxGenerator
from sparenet_tpu.models import layers as jax_layers
from sparenet_tpu.ops import common as opc
from sparenet_tpu.ops import mds as jax_mds
from sparenet_tpu.ops.chamfer import chamfer_raw
from sparenet_tpu.ops.expansion_penalty import \
    mean_mst_length_estimate as jax_mml_estimate
from sparenet_tpu.ops.pallas.knn_pallas import knn_self_pallas
from sparenet_tpu_torch import models as port_models
from sparenet_tpu_torch.ops import mds as port_mds
from sparenet_tpu_torch.utils.calibration import (autocalibrate_mml,
                                                  fit_mml_ratio)
from sparenet_tpu_torch.utils.weights import state_dict_from_jax

jax.config.update("jax_platforms", "cpu")

B, N_IN, N_OUT, PRIMS = 2, 128, 256, 4
S = N_OUT // PRIMS
CONFIG = dict(num_points=N_OUT, n_primitives=PRIMS, bottleneck_size=128,
              hide_size=128, use_selayer=True)
G, SCHEDULE, TAIL, CALIBRATION = 64, (16,), 64, 1.33
ARMS = ("batched", "hybrid")
# Coarse against the JAX serving coarse. Readings: max abs 2.6e-4, Chamfer
# 1.3e-9 (the encoder's f32 gather against the JAX CPU path's bf16 rows,
# and bf16 products where JAX's CPU program keeps f32). Limits about 8x and
# 80x those, far inside the JAX package's own serving envelope (max abs
# 0.05, Chamfer 5e-4, tests/test_serving_mode.py).
COARSE_ATOL, COARSE_CHAMFER = 2e-3, 1e-7
# Each refine pass fed JAX's cloud, selected rows and flags: the residual
# net's bf16 chain alone. Reading 3.0e-5.
REFINE_ATOL = 2e-4


def _jitter_stats(variables, rng):
    def jit_leaf(path, leaf):
        name = path[-1].key
        if name == "mean":
            return jnp.asarray(rng.uniform(-0.3, 0.3, leaf.shape), jnp.float32)
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape), jnp.float32)
        return leaf
    return {"params": variables["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(
                jit_leaf, variables["batch_stats"])}


def _packed_knn(x, k):
    return knn_self_pallas(x, k, interpret=True, packed=True)


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    partial = (rng.rand(B, N_IN, 3) - 0.5).astype(np.float32)
    init = JaxGenerator(**CONFIG, use_adain="share", encode="Residualnet",
                        train=True)
    variables = jax.jit(init.init)({"params": jax.random.PRNGKey(0)},
                                   jnp.asarray(partial))
    variables = jax.tree_util.tree_map(np.asarray, _jitter_stats(variables, rng))
    sd = state_dict_from_jax(variables, n_primitives=PRIMS)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_layers, "knn_idx", _packed_knn)
    mp.setattr(jax_mds, "_MDS_BATCH_G", G)
    mp.setattr(jax_mds, "_MDS_SCHEDULE", SCHEDULE)
    mp.setattr(jax_mds, "_MDS_TAIL", TAIL)
    opc.set_fast_math(True)
    out = dict(partial=partial, sd=sd, variables=variables, jax={}, port={},
               models={})
    try:
        for arm in ARMS:
            model = JaxGenerator(**CONFIG, use_adain="share",
                                 encode="Residualnet", train=False,
                                 mds_impl=arm, mml_calibration=CALIBRATION)
            out["jax"][arm] = [np.asarray(o) for o in
                               jax.jit(model.apply)(variables,
                                                    jnp.asarray(partial))]
            # the picks of each JAX refine pass, from JAX's own clouds
            picks = []
            for cloud in out["jax"][arm][:2]:
                mml = jax_mml_estimate(jnp.asarray(cloud), S, CALIBRATION)
                idx, sel = jax_mds.minimum_density_sample_xyz(
                    jnp.concatenate([jnp.asarray(cloud), jnp.asarray(partial)],
                                    1), N_OUT, mml, impl=arm)
                picks.append((np.asarray(mml), np.asarray(idx),
                              np.asarray(sel)))
            out["jax"][arm + "_picks"] = picks
            port = port_models.build_generator(
                device="cpu", serving=True, mds=arm,
                mml_calibration=CALIBRATION, mds_g=G, mds_schedule=SCHEDULE,
                mds_tail=TAIL, **CONFIG)
            port.load_state_dict(sd, strict=True)
            out["models"][arm] = port
            out["port"][arm] = [o.numpy() for o in port_models.complete(
                port, torch.from_numpy(partial))]
    finally:
        opc.set_fast_math(False)
        mp.undo()
    return out


def _chamfer_max(a, b):
    d1, d2, _, _ = chamfer_raw(jnp.asarray(a), jnp.asarray(b))
    return float(jnp.max(jnp.mean(d1, 1) + jnp.mean(d2, 1)))


@pytest.mark.parametrize("arm", ARMS)
def test_serving_coarse_matches_jax(case, arm):
    """Coarse within the bf16 limits stated at the top of this file."""
    got, want = case["port"][arm][0], case["jax"][arm][0]
    assert got.shape == want.shape == (B, N_OUT, 3)
    assert np.abs(got - want).max() <= COARSE_ATOL
    assert _chamfer_max(got, want) <= COARSE_CHAMFER


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("stage", [1, 2], ids=["middle", "refine"])
def test_serving_refine_anchored_on_jax_picks(case, arm, stage):
    """Each refine pass on JAX's cloud and JAX's mml: the port's MDS arm
    picks exactly JAX's points, and the residual net on JAX's selected rows
    is within REFINE_ATOL of JAX's pass. (The mml estimate is held to JAX's
    in test_torch_port_serving_ops.py on spread clouds: this random-init
    coarse cloud is degenerate, its nearest neighbours ~1e-7 apart, below
    what |p|^2 + |q|^2 - 2 p.q resolves in f32, so there both packages'
    estimates are rounding noise.)"""
    cloud = case["jax"][arm][stage - 1]
    want = case["jax"][arm][stage]
    mml, idx, sel = case["jax"][arm + "_picks"][stage - 1]
    refine = case["models"][arm].refine
    with torch.no_grad():
        pidx, psel = port_mds.minimum_density_sample_xyz(
            torch.from_numpy(np.concatenate([cloud, case["partial"]], 1)),
            N_OUT, torch.from_numpy(mml), arm, g=G, schedule=SCHEDULE,
            tail=TAIL)
        np.testing.assert_array_equal(pidx.numpy(), idx)
        np.testing.assert_array_equal(psel.numpy(), sel)
        flag = (idx >= N_OUT).astype(np.float32)[..., None]
        base = torch.from_numpy(np.concatenate([sel, flag], -1))
        got = (base[..., :3] + refine.residual(base)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=REFINE_ATOL)


@pytest.mark.parametrize("arm", ARMS)
def test_serving_outputs_finite_and_loss_zero(case, arm):
    """Serving mode skips the MST loss (loss_mst = 0, as the reference's),
    and every output is finite with the expected shape."""
    coarse, middle, refine, loss = case["port"][arm]
    assert float(loss) == 0.0 == float(case["jax"][arm][3])
    for o in (coarse, middle, refine):
        assert o.shape == (B, N_OUT, 3) and np.isfinite(o).all()


def test_serving_needs_no_new_weight_rule(case):
    """Serving uses the parity model's parameters: the converted state_dict
    loads strict into a serving and a parity generator, with identical
    tensors."""
    serving = port_models.build_generator(device="cpu", serving=True, seed=3,
                                          **CONFIG)
    parity = port_models.build_generator(device="cpu", seed=4, **CONFIG)
    for m in (serving, parity):
        result = m.load_state_dict(case["sd"], strict=True)
        assert not result.missing_keys and not result.unexpected_keys
    a, b = serving.state_dict(), parity.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_serving_arms_and_defaults():
    """build_generator's serving arguments: "auto" is the exact arm, as the
    JAX package resolves it off the TPU, the reference's calibration 1.33
    and G, schedule, tail defaults; the batched and hybrid arms by name; an
    unknown arm raises; parity stays the default."""
    m = port_models.build_generator(device="cpu", serving=True, **CONFIG)
    assert m.refine.mds == "exact" and m.refine.mml_calibration == 1.33
    for arm in ("batched", "hybrid"):
        assert port_models.build_generator(
            device="cpu", serving=True, mds=arm, **CONFIG).refine.mds == arm
    assert (m.refine.mds_g, m.refine.mds_schedule, m.refine.mds_tail) == (
        8192, (2048,), 2048)
    assert not port_models.build_generator(device="cpu", **CONFIG).serving
    with pytest.raises(ValueError):
        port_models.build_generator(device="cpu", serving=True, mds="topk",
                                    **CONFIG)


def test_autocalibrate_sets_the_fitted_ratio(case):
    """autocalibrate_mml fits the ratio on the model's own coarse output
    (rtol 1e-6 against fit_mml_ratio on that coarse) and sets it."""
    model = port_models.build_generator(device="cpu", serving=True, seed=5,
                                        **CONFIG)
    model.load_state_dict(case["sd"], strict=True)
    partial = torch.from_numpy(case["partial"])
    ratio = autocalibrate_mml(model, partial)
    with torch.no_grad():
        coarse = model.decoder(model.encoder(partial))
    assert model.refine.mml_calibration == ratio
    np.testing.assert_allclose(ratio, float(fit_mml_ratio(coarse, S)),
                               rtol=1e-6)
    assert not model.training
