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


MSN_YAML = """\
DATASET: {train_dataset: Synthetic, test_dataset: Synthetic, n_outpoints: 128}
CONST: {num_workers: 2, n_input_points: 64}
NETWORK: {n_primitives: 4, model_type: MSN, metric: chamfer}
TEST: {metric_name: ChamferDistance, batch_size: 2}
DATASETS: {synthetic: {n_train: 2, n_val: 4}}
"""


def test_cli_evaluates_msn_in_serving_mode(tmp_path, capsys):
    """``--model msn --serving`` on a checkpoint of a seeded MSN with
    jittered BatchNorm statistics (``toy``'s recipe): the runner fits the mml
    ratio at load (the expansion's plain version once, on the first batch's
    coarse clouds folded on grids seeded 0), inside ``BAND`` and equal to
    ``autocalibrate_mml`` on a serving model loaded from the checkpoint; the
    split evaluates in serving mode, exact arm (MDS once a batch, no
    expansion), to finite metrics."""
    from sparenet_tpu_torch.models import ServingDial, define_G
    from sparenet_tpu_torch.utils.calibration import BAND, autocalibrate_mml

    path = tmp_path / "msn.yaml"
    path.write_text(MSN_YAML)
    cfg = cfg_from_file(str(path))
    cfg.DIR.checkpoints = str(tmp_path / "given")
    model = define_G(cfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.6 - 0.3)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    checkpoint_save(cfg, 1, Metrics("ChamferDistance", [0.0, 1e4, 1e4]), None,
                    model)
    weights = os.path.join(cfg.DIR.checkpoints, "ckpt-best.pth")
    _lib.reset_counts()
    assert cli.main(["--model", "msn", "--serving", "--weights", weights,
                     "--config", str(path), "--workdir", str(tmp_path / "w"),
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["mode"] == "serving" and line["mml_fitted"]
    assert line["dial"]["arm"] == "exact" and line["n_clouds"] == 4
    assert BAND[0] <= line["mml_calibration"] <= BAND[1]
    assert line["plain_calls"]["expansion"] == 1
    assert line["plain_calls"]["mds"] == 2 and line["launches"] == {}
    assert all(np.isfinite(line[k]) for k in Metrics.names())
    runner = get_runner(cfg)
    assert runner.__name__ == "msnRunner"
    fresh = define_G(cfg, device="cpu", dial=ServingDial())
    fresh.load_state_dict(torch.load(weights, weights_only=True)["net_G"])
    from sparenet_tpu_torch.data import data_init
    _, val = data_init(cfg)
    _, _, _, data = val.first_batch()
    ratio, fitted = autocalibrate_mml(fresh, torch.from_numpy(data["partial_cloud"]))
    assert fitted and ratio == line["mml_calibration"]


GRNET_YAML = """\
DATASET: {train_dataset: Synthetic, test_dataset: Synthetic, n_outpoints: 128}
CONST: {num_workers: 2, n_input_points: 64}
NETWORK: {n_sampling_points: 16, model_type: GRNet, metric: chamfer}
TEST: {metric_name: ChamferDistance, batch_size: 2}
DATASETS: {synthetic: {n_train: 2, n_val: 4}}
"""


def test_cli_evaluates_grnet(tmp_path, capsys):
    """``--model grnet`` on a checkpoint of a seeded GRNet (define_G's 64^3
    grid, 16 sampled points, 128 dense) with jittered BatchNorm statistics:
    the last line's metrics equal ``compute_all`` on the dense clouds of a
    model loaded from the same file, each batch's sample drawn from a
    generator seeded with the batch's index; a batch runs the NN both ways
    for the sparse Chamfer loss, the dense Chamfer loss and the metrics.
    About 5 s on two threads."""
    from sparenet_tpu_torch.models import define_G

    path = tmp_path / "grnet.yaml"
    path.write_text(GRNET_YAML)
    cfg = cfg_from_file(str(path))
    cfg.DIR.checkpoints = str(tmp_path / "given")
    model = define_G(cfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.6 - 0.3)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    checkpoint_save(cfg, 1, Metrics("ChamferDistance", [0.0, 1e4, 1e4]), None,
                    model)
    weights = os.path.join(cfg.DIR.checkpoints, "ckpt-best.pth")
    _lib.reset_counts()
    assert cli.main(["--model", "grnet", "--weights", weights, "--config",
                     str(path), "--workdir", str(tmp_path / "w"),
                     "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["n_clouds"] == 4 and line["batches"] == 2
    assert line["launches"] == {} and line["mml_calibration"] is None
    assert line["plain_calls"]["nn_idx"] == 2 * 6
    assert get_runner(cfg).__name__ == "grnetRunner"

    fresh = define_G(cfg, seed=9, device="cpu")
    fresh.load_state_dict(torch.load(weights, weights_only=True)["net_G"],
                          strict=True)
    ds = SyntheticDataset(cfg, "test")
    vals = []
    for i in (0, 1):
        items = [ds[j] for j in (2 * i, 2 * i + 1)]
        partial = torch.from_numpy(np.stack([d["partial_cloud"]
                                             for _, _, _, d in items]))
        gt = torch.from_numpy(np.stack([d["gtcloud"] for _, _, _, d in items]))
        _, dense = complete(fresh, partial,
                            generator=torch.Generator().manual_seed(i))
        vals.append(compute_all(dense, gt, eps=float(cfg.TEST.emd_eps),
                                iters=int(cfg.TEST.emd_iters)))
    want = np.concatenate(vals, 1).mean(1)
    for k, v in zip(Metrics.names(), want):
        assert line[k] == pytest.approx(float(v), rel=1e-6), k


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
