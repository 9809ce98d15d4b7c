"""The trained flagship (docs/artifacts/r5/flagship_e8_bf16.npz) in the port
against the JAX package, at full width on the CPU: Synthetic TEST cloud 0
of the evaluation config (sparenet_tpu_torch/configs/flagship_e8_eval.yaml),
B=1, 3000 -> 16384 points, parity mode.

Limits: the end-to-end contract (ROADMAP.md, "Parity contract"): Chamfer
between the two packages' outputs <= 1e-4; the per-cloud metrics CD x 1000
and EMD x 100 within 1% relative and F-Score within 0.005. The JAX metrics
run on the JAX CPU paths (nearest neighbours and bids from the
|x|^2 + |y|^2 - 2xy expansion), the port's on its plain versions of the
TPU kernels' coordinate differences. The port runs on two threads: its
plain greedy MDS takes 16384 small steps a call, which more threads, on
cores that the other test workers share, make many times slower.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.configs import cfg_from_file as jax_cfg_from_file
from sparenet_tpu.models import define_G
from sparenet_tpu.ops.chamfer import chamfer_raw as jax_chamfer_raw
from sparenet_tpu.utils.ckpt_npz import load_npz as jax_load_npz
from sparenet_tpu.utils.metrics import compute_all as jax_compute_all
from sparenet_tpu_torch.configs import CONFIG_DIR, cfg_from_file
from sparenet_tpu_torch.data import SyntheticDataset
from sparenet_tpu_torch.models import FLAGSHIP, build_generator, complete
from sparenet_tpu_torch.utils.checkpoint import checkpoint_load
from sparenet_tpu_torch.utils.ckpt_npz import load_npz
from sparenet_tpu_torch.utils.metrics import compute_all
from sparenet_tpu_torch.utils.weights import (reference_state_dict,
                                              state_dict_from_jax)

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "docs", "artifacts", "r5", "flagship_e8_bf16.npz")
EVAL_YAML = os.path.join(CONFIG_DIR, "flagship_e8_eval.yaml")


@pytest.fixture(scope="module")
def trained():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    cfg = cfg_from_file(EVAL_YAML)
    cfg.CONST.weights = NPZ
    model = build_generator(seed=0, device="cpu")
    epoch, best = checkpoint_load(cfg, model)
    _, _, _, data = SyntheticDataset(cfg, "test")[0]
    yield dict(cfg=cfg, model=model, epoch=epoch, best=best,
               partial=data["partial_cloud"][None], gt=data["gtcloud"][None])
    torch.set_num_threads(threads)


def test_flagship_npz_loads_strictly(trained):
    """The archive read as the JAX package reads it, converted, loaded with
    strict=True (as checkpoint_load does), and given back in the same
    reference layout bit for bit; epoch 1 and no best metrics."""
    tree = load_npz(NPZ)
    want = jax_load_npz(NPZ)
    assert sorted(tree) == sorted(want) == ["batch_stats", "params"]
    flat = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat) == len(jax.tree_util.tree_leaves(want)) == 120
    for path, leaf in flat:
        w = want
        for k in path:
            w = w[k.key]
        assert leaf.dtype == w.dtype and np.array_equal(leaf, w)
    sd = state_dict_from_jax(tree)
    assert trained["model"].decoder.n_primitives == FLAGSHIP["n_primitives"]
    assert (trained["epoch"], trained["best"]) == (1, None)
    got = reference_state_dict(trained["model"])
    assert sorted(got) == sorted(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_trained_eval_matches_jax(trained):
    """Cloud 0 through both packages' eval forward and metrics."""
    jcfg = jax_cfg_from_file(EVAL_YAML)
    jmodel = define_G(jcfg, train=False)
    variables = jax_load_npz(NPZ)
    jouts = jax.jit(jmodel.apply)(variables, jnp.asarray(trained["partial"]))
    with torch.no_grad():
        pouts = complete(trained["model"], torch.from_numpy(trained["partial"]))
    gaps = {}
    for name, j, p in zip(("coarse", "middle", "refine"), jouts[:3], pouts[:3]):
        assert p.shape == (1, 16384, 3) and bool(torch.isfinite(p).all())
        d1, d2, _, _ = jax_chamfer_raw(jnp.asarray(p.numpy()), j)
        gaps[name] = float(jnp.mean(d1) + jnp.mean(d2))
    assert max(gaps.values()) <= 1e-4, gaps

    gt = trained["gt"]
    want = np.asarray(jax_compute_all(jouts[2], jnp.asarray(gt),
                                      float(jcfg.TEST.emd_eps),
                                      int(jcfg.TEST.emd_iters)))[:, 0]
    got = compute_all(pouts[2], torch.from_numpy(gt),
                      float(trained["cfg"].TEST.emd_eps),
                      int(trained["cfg"].TEST.emd_iters))[:, 0]
    assert abs(got[0] - want[0]) <= 0.005, (got, want)
    np.testing.assert_allclose(got[1:], want[1:], rtol=0.01)
    # a trained model: the cloud is completed, not noise
    assert 0.1 < got[0] < 1 and got[1] < 5.0, got
