"""The PyTorch port's flagship SpareNet eval forward against the JAX package.

A port of the flagship case of tests/test_forward_parity.py at toy size
(B=2, 64 -> 256 points, 4 primitives, bottleneck and hide 128; the EdgeConv
stages keep their 256/256/512/1024 widths): one JAX model with jittered
BatchNorm statistics, its variables carried into the port by
``state_dict_from_jax``, both forwards on the same numpy inputs. On the CPU
the port runs its plain versions. Also: the weight converter, some layers,
and the package's hygiene (no JAX import, no silent CPU fallback).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.models import SpareNetGenerator as JaxGenerator
from sparenet_tpu.models import layers as jax_layers
from sparenet_tpu.ops.chamfer import chamfer_raw
from sparenet_tpu.ops.expansion_penalty import expansion_penalty as jax_expansion
from sparenet_tpu.ops.mds import minimum_density_sample as jax_mds
from sparenet_tpu.utils.torch_import import export_netG_state_dict
from sparenet_tpu_torch import models as port_models
from sparenet_tpu_torch.models import layers as port_layers
from sparenet_tpu_torch.models.sparenet import flagged_base
from sparenet_tpu_torch.utils.weights import state_dict_from_jax

jax.config.update("jax_platforms", "cpu")

B, N_IN, N_OUT, PRIMS = 2, 64, 256, 4
S = N_OUT // PRIMS
CONFIG = dict(num_points=N_OUT, n_primitives=PRIMS, bottleneck_size=128,
              hide_size=128, use_selayer=True)


def _jitter_stats(variables, rng):
    """Non-trivial BN running stats (as tests/test_forward_parity.py)."""
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


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    model = JaxGenerator(**CONFIG, use_adain="share", encode="Residualnet",
                         train=False)
    partial = (rng.rand(B, N_IN, 3) - 0.5).astype(np.float32)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)},
                                    jnp.asarray(partial))
    variables = jax.tree_util.tree_map(np.asarray, _jitter_stats(variables, rng))
    outs = jax.jit(model.apply)(variables, jnp.asarray(partial))
    sd = state_dict_from_jax(variables, n_primitives=PRIMS)
    port = port_models.build_generator(device="cpu", **CONFIG)
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        port_outs = port_models.complete(port, torch.from_numpy(partial))
    return dict(variables=variables, partial=partial, sd=sd, port=port,
                jax=[np.array(o) for o in outs],
                port_outs=[o.numpy() for o in port_outs])


def _chamfer_max(a, b):
    d1, d2, _, _ = chamfer_raw(jnp.asarray(a), jnp.asarray(b))
    return float(jnp.max(jnp.mean(d1, 1) + jnp.mean(d2, 1)))


def _jax_refine_idx(cloud, partial):
    """The MDS indices the JAX refine pass selects for ``cloud``."""
    _, _, mml = jax_expansion(jnp.asarray(cloud), S, 1.5)
    base = np.concatenate([cloud, partial], axis=1)
    return np.array(jax_mds(jnp.asarray(base), N_OUT, mml))


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def test_weights_match_jax_export(case):
    """Key for key and bit for bit equal to export_netG_state_dict, except
    its per-primitive BatchNorm step counts: the exporter writes them under
    the unexpanded template key ``decoder.decoder.{p}.dec.bn<i>...``, the
    port under one key per primitive (see ROADMAP section 3)."""
    ref = export_netG_state_dict(case["variables"], use_adain="share",
                                 encode="Residualnet", use_selayer=True,
                                 n_primitives=PRIMS)
    sd = case["sd"]
    template = {k for k in ref if "{p}" in k}
    assert template == {f"decoder.decoder.{{p}}.dec.bn{i}.num_batches_tracked"
                        for i in (1, 2, 3)}
    expanded = {k.format(p=p) for k in template for p in range(PRIMS)}
    assert set(sd) == (set(ref) - template) | expanded
    for k, v in ref.items():
        if k not in template:
            got = sd[k].numpy()
            assert got.dtype == v.dtype and got.shape == v.shape, k
            assert got.tobytes() == np.ascontiguousarray(v).tobytes(), k
    for k in expanded:
        assert int(sd[k]) == 0


def test_state_dict_loads_strict_in_both_layouts(case):
    """The reference layout and the port's own (stacked) layout both load
    with strict=True, and give the same weights."""
    fresh = port_models.build_generator(device="cpu", seed=1, **CONFIG)
    result = fresh.load_state_dict(case["sd"], strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    again = port_models.build_generator(device="cpu", seed=2, **CONFIG)
    again.load_state_dict(fresh.state_dict(), strict=True)
    for (k, a), (_, b) in zip(fresh.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def test_coarse_matches_jax(case):
    """Elementwise: atol 3e-6, rtol 1e-4 (the parity contract)."""
    np.testing.assert_allclose(case["port_outs"][0], case["jax"][0],
                               atol=3e-6, rtol=1e-4)


@pytest.mark.parametrize("stage", [1, 2], ids=["middle", "refine"])
def test_refine_anchored_matches_jax(case, stage):
    """Each refine pass fed the JAX cloud and the JAX MDS indices:
    atol 3e-6, rtol 1e-4 (greedy MDS is chaotic at 1e-7 input changes, so
    the anchored pass isolates the refine's own numerics)."""
    cloud, want = case["jax"][stage - 1], case["jax"][stage]
    partial = case["partial"]
    idx = _jax_refine_idx(cloud, partial)
    refine = case["port"].refine
    with torch.no_grad():
        base = flagged_base(torch.from_numpy(cloud), torch.from_numpy(partial))
        got = refine.finish(base, torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-6, rtol=1e-4)


@pytest.mark.parametrize("stage", [1, 2], ids=["middle", "refine"])
def test_free_running_chamfer(case, stage):
    """The port's own forward end to end: Chamfer distance <= 1e-4."""
    assert _chamfer_max(case["port_outs"][stage], case["jax"][stage]) <= 1e-4


def test_loss_mst_matches_jax(case):
    """loss_mst of the port's expansion penalty on the JAX coarse cloud:
    rtol 1e-5. Anchored like the refine passes: a random-init decoder emits
    a nearly degenerate cloud whose MST edges (~1e-7) are as small as the
    two forwards' coarse difference, so which edges pass the 1.5x-mean
    threshold is decided by rounding unless both see the same cloud."""
    from sparenet_tpu_torch.ops.expansion_penalty import expansion_penalty
    dist, _, _ = expansion_penalty(torch.from_numpy(case["jax"][0]), S, 1.5)
    np.testing.assert_allclose(float(dist.mean()), float(case["jax"][3]),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_points,prims", [(256, 4), (16384, 32), (2048, 16)])
def test_grid_generation_matches_jax(num_points, prims):
    np.testing.assert_array_equal(port_layers.grid_generation(num_points, prims),
                                  jax_layers.grid_generation(num_points, prims))


def test_adaptive_instance_norm_matches_jax(rng):
    """atol 1e-6 (f32 reassociation of the point-axis statistics)."""
    x = rng.randn(3, 50, 16).astype(np.float32)
    w = rng.rand(3, 16).astype(np.float32) + 0.5
    b = rng.randn(3, 16).astype(np.float32)
    want = np.asarray(jax_layers.adaptive_instance_norm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = port_layers.adaptive_instance_norm(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_adain_param_split_matches_jax(rng):
    sizes = jax_layers.grid_decoder_adain_sizes(1026)
    assert port_layers.grid_decoder_adain_sizes(1026) == sizes
    assert port_layers.num_adain_params(1026) == jax_layers.num_adain_params(1026)
    p = rng.randn(2, jax_layers.num_adain_params(1026)).astype(np.float32)
    for (jw, jb), (pw, pb) in zip(
            jax_layers.split_adain_params(jnp.asarray(p), sizes),
            port_layers.split_adain_params(torch.from_numpy(p), sizes)):
        np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


# ---------------------------------------------------------------------------
# hygiene
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib, sparenet_tpu_torch\n"
        "for m in pkgutil.walk_packages(sparenet_tpu_torch.__path__, "
        "'sparenet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('ops.p2i', 'renderer.depth_maps', 'models.discriminator',"
        " 'runners.sparenet_gan', 'utils.calibration', 'ops.mds', 'ops.knn',"
        " 'configs', 'configs.defaults', 'data.datasets', 'data.loaders',"
        " 'utils.metrics', 'utils.ckpt_npz', 'utils.checkpoint',"
        " 'utils.logging', 'utils.visualizer', 'runners.misc',"
        " 'runners.base', 'runners.sparenet', 'test', 'train',"
        " 'utils.profiler', 'models.msn', 'models.atlasnet', 'runners.msn',"
        " 'runners.atlasnet', 'models.grnet', 'runners.grnet',"
        " 'ops.gridding', 'ops.cubic_feature_sampling', 'ops.gridding_loss',"
        " 'frechet', 'frechet.fpd', 'frechet.pointnet',"
        " 'frechet.train_classifier', 'test_fpd'):\n"
        "    assert 'sparenet_tpu_torch.' + m in sys.modules, m\n"
        "bad = [n for n in sys.modules if n in ('jax', 'flax', 'sparenet_tpu')"
        " or n.startswith(('jax.', 'flax.', 'sparenet_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('sparenet_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 10   # every submodule was imported


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, case):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_models.build_generator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_models.resolve_device("cuda")
    with pytest.raises(ValueError):
        port_models.complete(case["port"], torch.zeros(2, 10, 4))
