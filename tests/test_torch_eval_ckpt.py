"""The port's checkpoints: its reader of the JAX package's bf16 archive
against the JAX reader, and its torch checkpoints (save, load, names)."""

import os

import numpy as np
import pytest
import torch

from sparenet_tpu.utils.ckpt_npz import export_npz
from sparenet_tpu.utils.ckpt_npz import load_npz as jax_load_npz
from sparenet_tpu_torch.configs import default_config
from sparenet_tpu_torch.models import build_generator
from sparenet_tpu_torch.utils import checkpoint as ckpt
from sparenet_tpu_torch.utils.ckpt_npz import _SEP, load_npz
from sparenet_tpu_torch.utils.metrics import Metrics

TOY = dict(num_points=128, n_primitives=2, use_selayer=True)


def _tree_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_load_npz_matches_jax(tmp_path, rng):
    """An archive that the JAX package's export_npz writes: f32 leaves as
    bf16 (u16), int and f64 leaves verbatim, nested paths joined by _SEP."""
    state = {
        "params": {
            "encoder": {"Linear_0": {"kernel": rng.randn(5, 7).astype(np.float32),
                                     "bias": np.full(7, -0.0, np.float32)}},
            "decoder": {"VmapGridDecoder_0": {"Conv1d_0": {
                "kernel": rng.randn(3, 2, 4).astype(np.float32)}}},
            "step": np.int32(11),
            "scale": np.float64(0.1),
        },
        "batch_stats": {"bn": {"mean": rng.randn(6).astype(np.float32),
                               "var": np.array([np.inf, np.nan, 1e-40],
                                               np.float32)}},
        "opt_state": {"ignored": np.ones(2, np.float32)},
    }
    path = str(tmp_path / "toy.npz")
    assert export_npz(state, path) == 7
    got, want = load_npz(path), jax_load_npz(path)
    _tree_equal(got, want)
    k = got["params"]["encoder"]["Linear_0"]["kernel"]
    np.testing.assert_array_equal(
        k.view(np.uint32),
        state["params"]["encoder"]["Linear_0"]["kernel"].view(np.uint32)
        & np.uint32(0xFFFF0000))
    assert _SEP == "//" and "opt_state" not in got


def test_load_npz_rejects_an_unknown_tag(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path, **{"f16:params//w": np.zeros(2, np.float16)})
    with pytest.raises(ValueError, match="unknown leaf tag"):
        load_npz(path)


def _cfg(tmp_path, weights=None):
    cfg = default_config()
    cfg.NETWORK.n_primitives = TOY["n_primitives"]
    cfg.DIR.checkpoints = str(tmp_path / "ckpt")
    cfg.TRAIN.save_freq = 5
    cfg.TEST.metric_name = "ChamferDistance"
    cfg.CONST.weights = weights
    return cfg


def test_torch_checkpoint_roundtrips_bit_for_bit(tmp_path):
    """checkpoint_save then checkpoint_load into a model with other weights:
    every tensor of the state_dict equal bit for bit, with the epoch and the
    best metrics, in the reference's {"epoch_index", "best_metrics",
    "net_G"} layout."""
    cfg = _cfg(tmp_path)
    model = build_generator(seed=1, device="cpu", **TOY)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    metrics = Metrics("ChamferDistance", [0.4, 1.25, 3.5])
    best = ckpt.checkpoint_save(cfg, 7, metrics, None, model)
    assert best is metrics
    path = os.path.join(cfg.DIR.checkpoints, "ckpt-best.pth")
    payload = torch.load(path, weights_only=True)
    assert sorted(payload) == ["best_metrics", "epoch_index", "net_G"]
    assert payload["net_G"]["decoder.decoder.1.dec.conv2.weight"].shape == (
        513, 1026, 1)
    assert "decoder.decoder.0.dec.adain3.running_var" in payload["net_G"]
    other = build_generator(seed=2, device="cpu", **TOY)
    cfg.CONST.weights = path
    epoch, loaded = ckpt.checkpoint_load(cfg, other)
    assert epoch == 7 and loaded.state_dict() == metrics.state_dict()
    want, got = model.state_dict(), other.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k


def test_checkpoint_names_as_the_jax_package(tmp_path):
    """ckpt-best on improvement, ckpt-epoch-NNN every save_freq epochs,
    nothing otherwise; (0, None) and no load without weights."""
    cfg = _cfg(tmp_path)
    model = build_generator(seed=1, device="cpu", **TOY)
    best = Metrics("ChamferDistance", [0.4, 1.0, 3.5])
    worse = Metrics("ChamferDistance", [0.5, 2.0, 3.0])
    assert ckpt.checkpoint_save(cfg, 10, worse, best, model) is best
    assert ckpt.checkpoint_save(cfg, 11, worse, best, model) is best
    assert sorted(os.listdir(cfg.DIR.checkpoints)) == ["ckpt-epoch-010.pth"]
    assert ckpt.checkpoint_load(cfg, model) == (0, None)
    assert ckpt.checkpoint_name(-1, True) == "ckpt-best.pth"


def test_checkpoint_load_is_strict(tmp_path):
    cfg = _cfg(tmp_path)
    model = build_generator(seed=1, device="cpu", **TOY)
    ckpt.checkpoint_save(cfg, 5, Metrics("ChamferDistance", [0, 1, 2]), None,
                         model)
    bigger = build_generator(seed=1, device="cpu", **dict(TOY, n_primitives=4))
    cfg.CONST.weights = os.path.join(cfg.DIR.checkpoints, "ckpt-best.pth")
    with pytest.raises(RuntimeError, match="Unexpected key"):
        ckpt.checkpoint_load(cfg, bigger)
