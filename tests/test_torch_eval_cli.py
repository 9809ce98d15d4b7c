"""The port's evaluation CLI (``python -m sparenet_tpu_torch.test``) end to
end on the CPU at toy widths: Synthetic TEST, 4 clouds in batches of 2,
64 -> 128 points, 2 primitives (the encoder and decoder keep define_G's
widths). It loads a checkpoint the test writes itself, and its last line
must equal the metrics computed directly on the outputs of a model loaded
from the same file."""

import json
import os

import numpy as np
import pytest
import torch

from sparenet_tpu_torch import test as cli
from sparenet_tpu_torch.configs import cfg_from_file
from sparenet_tpu_torch.data import SyntheticDataset
from sparenet_tpu_torch.models import build_generator, complete
from sparenet_tpu_torch.ops import _lib
from sparenet_tpu_torch.runners import get_runner, runner_class
from sparenet_tpu_torch.utils.checkpoint import checkpoint_save
from sparenet_tpu_torch.utils.logging import set_logger
from sparenet_tpu_torch.utils.metrics import Metrics, compute_all

TOY_YAML = """\
DATASET: {train_dataset: Synthetic, test_dataset: Synthetic, n_outpoints: 128}
CONST: {num_workers: 2, n_input_points: 64}
NETWORK: {n_primitives: 2, metric: "chamfer", use_selayer: true}
TEST: {metric_name: "ChamferDistance", batch_size: 2}
DATASETS: {synthetic: {n_train: 8, n_val: 4}}
"""
TOY = dict(num_points=128, n_primitives=2, use_selayer=True)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The config file and a checkpoint of a seeded model with jittered
    BatchNorm statistics, saved at epoch 4 with poor best metrics."""
    root = tmp_path_factory.mktemp("cli")
    path = root / "toy.yaml"
    path.write_text(TOY_YAML)
    cfg = cfg_from_file(str(path))
    cfg.DIR.checkpoints = str(root / "given")
    model = build_generator(seed=3, device="cpu", **TOY)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.6 - 0.3)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    checkpoint_save(cfg, 4, Metrics("ChamferDistance", [0.0, 1e4, 1e4]), None,
                    model)
    return dict(root=root, yaml=str(path),
                weights=os.path.join(cfg.DIR.checkpoints, "ckpt-best.pth"))


def test_cli_matches_compute_all_on_its_outputs(toy, capsys):
    work = toy["root"] / "work"
    _lib.reset_counts()
    assert cli.main(["--weights", toy["weights"], "--config", toy["yaml"],
                     "--workdir", str(work), "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert "TEST RESULTS" in "\n".join(out) and "Overall" in "\n".join(out)
    # the CPU takes every op's plain version
    assert _lib.PLAIN_CALLS["knn"] == 8 and _lib.PLAIN_CALLS["mds"] == 4
    # chamfer val losses of coarse and refine, and the metrics: 6 a batch
    assert _lib.PLAIN_CALLS["nn_idx"] == 12 and _lib.PLAIN_CALLS["emd_bids"] > 0
    assert not any(_lib.LAUNCHES.values())

    # the same outputs, directly: a model loaded from the same file
    payload = torch.load(toy["weights"], weights_only=True)
    model = build_generator(seed=9, device="cpu", **TOY)
    model.load_state_dict(payload["net_G"], strict=True)
    cfg = cfg_from_file(toy["yaml"])
    ds = SyntheticDataset(cfg, "test")
    vals = []
    for i in (0, 2):
        items = [ds[j] for j in (i, i + 1)]
        partial = torch.from_numpy(np.stack([it[3]["partial_cloud"] for it in items]))
        gt = torch.from_numpy(np.stack([it[3]["gtcloud"] for it in items]))
        refine = complete(model, partial)[2]
        vals.append(compute_all(refine, gt, cfg.TEST.emd_eps, cfg.TEST.emd_iters))
    vals = np.concatenate(vals, 1).astype(np.float64)
    for i, name in enumerate(Metrics.names()):
        assert line[name] == pytest.approx(vals[i].mean(), rel=1e-12), name
    assert line["n_clouds"] == 4 and line["batches"] == 2
    assert set(line["seconds"]) == {"data", "forward", "metrics", "total"}
    assert line["clouds_per_s"] > 0 and line["device"] == "cpu"
    assert line["launches"] == {} and line["plain_calls"]["mds"] == 4

    # its outputs: the config, the table's json line, and ckpt-best (the
    # split's CD beats the checkpoint's best), which loads back
    logs = [d for d in (work / "logs").iterdir()]
    assert len(logs) == 1 and (logs[0] / "test.txt").read_text().startswith(
        "json_stats: ")
    assert (work / "config.yaml").exists()
    best = next((work / "checkpoints").iterdir()) / "ckpt-best.pth"
    again = torch.load(best, weights_only=True)
    assert again["epoch_index"] == -1
    assert again["best_metrics"]["ChamferDistance"] == pytest.approx(
        line["ChamferDistance"], rel=1e-12)
    for k, v in payload["net_G"].items():
        assert torch.equal(again["net_G"][k], v), k


def test_cli_needs_a_card_unless_asked_for_the_cpu(toy, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--weights", toy["weights"], "--config", toy["yaml"],
                  "--workdir", str(tmp_path)])


@pytest.mark.parametrize("args,err,match", [
    (["--test_mode", "render"], NotImplementedError, "queue 1 item 3"),
    (["--model", "msn"], NotImplementedError, "queue 1 item 4"),
    (["--model", "grnet"], NotImplementedError, "queue 1 item 5"),
    (["--test_mode", "vis"], NotImplementedError, "queue 1 item 3"),
    (["--dataset", "ShapeNet"], NotImplementedError, "queue 1 item 3"),
])
def test_cli_names_what_is_not_ported(toy, tmp_path, args, err, match):
    with pytest.raises(err, match=match):
        cli.main(["--weights", toy["weights"], "--config", toy["yaml"],
                  "--workdir", str(tmp_path), "--device", "cpu"] + args)


def test_get_runner():
    cfg = cfg_from_file(os.path.join(os.path.dirname(cli.__file__), "configs",
                                     "sparenet.yaml"))
    assert get_runner(cfg).__name__ == "sparenetRunner"
    with pytest.raises(ValueError, match="No runner"):
        runner_class("PointNet", False)


def test_runner_test_needs_a_checkpoint(toy, tmp_path):
    cfg = cfg_from_file(toy["yaml"])
    cfg.DIR.out_path = str(tmp_path)
    cfg.DIR.checkpoints = str(tmp_path / "ckpt")
    runner = get_runner(cfg)(cfg, set_logger(None), device="cpu")
    with pytest.raises(ValueError, match="loaded checkpoint"):
        runner.test()
