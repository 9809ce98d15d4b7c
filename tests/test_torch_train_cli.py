"""The port's training lifecycle (``runners.base.BaseRunner.runner``, the
SpareNet runner's ``train_step``, full-state checkpoints and the CLI
``python -m sparenet_tpu_torch.train``) against the JAX package's
``sparenetRunner``, on the CPU at toy size.

The toy run: Synthetic, 64 -> 128 points, 4 primitives (the encoder and
decoder keep define_G's widths), chamfer metric with the consistency loss,
2 epochs of 2 batches, ``lr_milestones: [1]`` so that epoch 2 trains at
``gamma`` times the rate, a checkpoint every epoch and validation over 2
clouds. Batches of 4, not 2: over 2 clouds the train-mode BatchNorms divide
rounding by a near-zero batch spread (the two packages' first coarse clouds
are 2.2e-3 apart at B=2, 3.3e-5 at B=4). The learning rate is 1e-6: Adam's
first step moves every weight by lr times its gradient's sign, so rounding
that flips a small gradient's sign moves a weight by 2 lr, and at 1e-4 the
two runs part within a step whatever their inputs. Both runners start from
the JAX runner's initial variables (tests/test_torch_port_train.py's
well-conditioned draw), carried into the port's layout by
``utils/weights.py``.

The training steps are anchored as tests/test_torch_port_train.py anchors
its step: the port's step replays the JAX step's kNN graphs, MDS picks,
expansion MSTs (taken on the JAX clouds) and Chamfer assignments, because
free-running, greedy MDS near-ties part the two runs from the second step
(refine loss 2.0% apart there, against 5.8e-4 anchored). The JAX encoder
runs its
train-commute formulation, the port's (monkeypatched, as the JAX package's
own tests do). Validation runs free in both.
"""

import json
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from sparenet_tpu.configs import cfg_from_file as jax_cfg_from_file
from sparenet_tpu.configs import cfg_update as jax_cfg_update
from sparenet_tpu.models import sparenet as jax_model_mod
from sparenet_tpu.ops import common as jax_opc
from sparenet_tpu.parallel.mesh import replicated_sharding
from sparenet_tpu.runners import sparenet as jax_runner_mod
from sparenet_tpu.utils import checkpoint as jax_ckpt
from sparenet_tpu_torch import test as test_cli
from sparenet_tpu_torch import train as train_cli
from sparenet_tpu_torch.configs import cfg_from_file, cfg_update
from sparenet_tpu_torch.ops import chamfer, expansion_penalty, knn, mds
from sparenet_tpu_torch.runners import base as port_base
from sparenet_tpu_torch.runners import sparenet as port_runner_mod
from sparenet_tpu_torch.utils import profiler
from sparenet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_train import _replay, draw_variables

jax.config.update("jax_platforms", "cpu")

TOY_YAML = """\
DATASET: {train_dataset: Synthetic, test_dataset: Synthetic, n_outpoints: 128}
CONST: {num_workers: 2, n_input_points: 64}
NETWORK: {n_primitives: 4, metric: chamfer, use_selayer: true, use_consist_loss: true}
TRAIN: {batch_size: 4, n_epochs: 2, save_freq: 1, log_freq: 1, learning_rate: 1.0e-6, lr_milestones: [1], gamma: 0.5}
TEST: {metric_name: ChamferDistance, batch_size: 2, emd_iters: 5}
TPU: {mesh_batch: 1}
DATASETS: {synthetic: {n_train: 8, n_val: 2}}
"""
LOSSES = ("coarse_loss", "refine_loss", "rec_loss")
PRIM_S = 128 // 4


class _Log:
    """A logger that keeps its lines."""

    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(str(msg))

    warning = info

    def saved(self):
        """The checkpoint names the run logged, in order, without suffix."""
        return [os.path.basename(line.split()[3]).removesuffix(".pth")
                for line in self.lines if line.startswith("Saved checkpoint")]


class _Calls:
    """Values the JAX step computes, kept as its program runs: each
    ``keep`` site (numbered when the step traces) appends its value at each
    run; ``take`` returns the values kept since the last call by name, in
    site order."""

    def __init__(self):
        self.sites, self.items = 0, []

    def keep(self, name, value):
        site = self.sites
        self.sites += 1
        jax.debug.callback(lambda v: self.items.append(
            (site, name, jax.tree_util.tree_map(np.asarray, v))), value)

    def take(self) -> dict:
        jax.effects_barrier()
        out: dict = {}
        for _, name, v in sorted(self.items, key=lambda t: t[0]):
            out.setdefault(name, []).append(v)
        self.items = []
        return out


class _Model:
    """A flax generator whose ``init`` gives tests/test_torch_port_train.py's
    well-conditioned variables (the reference initialisation emits a nearly
    degenerate coarse cloud, where train-mode BatchNorm divides rounding by
    a near-zero batch spread; and the JAX runner initialises these widths op
    by op, about a minute on a CPU) and whose train-mode ``apply`` keeps its
    kNN graphs and its coarse and middle clouds in ``calls``."""

    def __init__(self, module, calls):
        self.module, self.calls = module, calls

    def __getattr__(self, name):
        return getattr(self.module, name)

    def init(self, rngs, x):
        return draw_variables(self.module, x, np.random.RandomState(0))

    def apply(self, variables, x, mutable=False, **kw):
        if not mutable:
            return self.module.apply(variables, x, **kw)
        out, upd = self.module.apply(
            variables, x, mutable=list(mutable) + ["intermediates"], **kw)
        enc = upd.pop("intermediates")["encoder"]["EdgeConvResFeat_0"]
        self.calls.keep("nbrs", [enc[f"nbr{i}"][0] for i in (1, 2, 3, 4)])
        self.calls.keep("outs", out[:2])
        return out, upd


def _recording(cls, calls=None):
    """``cls`` keeping each step's epoch, lr, model ids and losses; with
    ``calls`` (the JAX runner) each step's index outputs too; without (the
    port's runner) replaying ``self.replays``, one a step."""
    class Recording(cls):
        steps: list
        replays: list

        def train_step(self, items):
            if calls is not None:
                calls.take()                  # validation's, not replayed
                super().train_step(items)
                replay = calls.take()
            else:
                replay = self.replays[len(self.steps)]
                mp = pytest.MonkeyPatch()
                mp.setattr(knn, "knn_idx", _replay(replay["nbrs"][0]))
                mp.setattr(mds, "minimum_density_sample",
                           _replay(replay["picks"]))
                mp.setattr(expansion_penalty, "mst_charges", _replay(
                    replay["outs"][0],
                    lambda c: expansion_penalty.mst_charges_plain(
                        torch.from_numpy(np.array(c)).reshape(-1, PRIM_S, 3))))
                mp.setattr(chamfer, "nn_idx", _replay(
                    [i for pair in replay["nn"] for i in pair]))
                try:
                    super().train_step(items)
                finally:
                    mp.undo()
            self.steps.append(dict(epoch=self.epoch_idx, lr=float(self.lr),
                                   ids=list(items[2]), replay=replay,
                                   **self.loss))
    return Recording


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX runner's run and the port runner's, from the same variables."""
    root = tmp_path_factory.mktemp("train")
    yaml_path = root / "toy.yaml"
    yaml_path.write_text(TOY_YAML)

    calls = _Calls()
    mp = pytest.MonkeyPatch()
    define_g = jax_runner_mod.define_G
    mp.setattr(jax_runner_mod, "define_G",
               lambda cfg, train=True: _Model(define_g(cfg, train), calls))
    mp.setattr(jax_opc, "TRAIN_COMMUTE", True)
    mp.setattr(jax_opc, "TRAIN_COMMUTE_IMPL", "xla")
    # the JAX runner names, logs and skips writing its checkpoints (0.7 GB
    # each): the test reads their names only
    mp.setattr(jax_ckpt, "_ckptr", lambda: types.SimpleNamespace(
        save=lambda *a, **k: None))
    for mod, name, tag, pick in (
            (jax_model_mod, "minimum_density_sample", "picks", lambda o: o),
            (jax_runner_mod, "chamfer_raw", "nn", lambda o: o[2:])):
        def keeping(*a, _f=getattr(mod, name), _tag=tag, _pick=pick, **k):
            out = _f(*a, **k)
            calls.keep(_tag, _pick(out))
            return out
        mp.setattr(mod, name, keeping)
    try:
        jcfg = jax_cfg_from_file(str(yaml_path))
        jcfg.DIR.out_path = str(root / "jax")
        jax_cfg_update(jcfg, timestamp=False)
        jlog = _Log()
        jrun = _recording(jax_runner_mod.sparenetRunner, calls)(jcfg, jlog)
        # where the step's outputs live, so that the step compiles once
        jrun.state = jax.device_put(jrun.state, replicated_sharding(jrun.mesh))
        init = jax.device_get({"params": jrun.state.params,
                               "batch_stats": jrun.state.batch_stats})
        jrun.steps = []
        jrun.runner()
    finally:
        mp.undo()

    cfg = cfg_from_file(str(yaml_path))
    cfg.DIR.out_path = str(root / "port")
    cfg_update(cfg, timestamp=False)
    plog = _Log()
    prun = _recording(port_runner_mod.sparenetRunner)(cfg, plog, device="cpu")
    prun.model.load_state_dict(state_dict_from_jax(
        init, use_selayer=True, n_primitives=4), strict=True)
    prun.steps = []
    prun.replays = [st["replay"] for st in jrun.steps]
    prun.runner()
    yield dict(root=root, yaml=str(yaml_path), jax=jrun, jlog=jlog,
               port=prun, plog=plog)
    shutil.rmtree(root, ignore_errors=True)


def test_same_batches_lr_and_checkpoints(runs):
    """The same batches in the same order (model ids), the same lr each
    epoch (1e-6, then gamma times it) and the same checkpoint names each
    epoch."""
    j, p = runs["jax"].steps, runs["port"].steps
    assert len(j) == len(p) == 4
    assert [s["ids"] for s in p] == [s["ids"] for s in j]
    assert [(s["epoch"], s["lr"]) for s in p] == [(s["epoch"], s["lr"]) for s in j]
    assert [s["lr"] for s in p] == pytest.approx([1e-6, 1e-6, 5e-7, 5e-7])
    names = runs["plog"].saved()
    assert len(names) == 2 and names == runs["jlog"].saved()
    assert runs["port"].epoch_lr == {1: 1e-6, 2: 5e-7}


def test_step_losses_match_jax(runs):
    """Each step's coarse and refine losses (x 1000) and its total: the
    first step, on the same weights, within rtol 1e-4 of the JAX runner's
    (readings up to 4.4e-5), the later ones within rtol 2e-2 (readings up
    to 4.8e-3: the runs' weights part by 2 lr where rounding flips a small
    gradient's sign, see the module docstring)."""
    for i, (s, t) in enumerate(zip(runs["port"].steps, runs["jax"].steps)):
        got = [s[k] for k in LOSSES]
        want = [t[k] for k in LOSSES]
        np.testing.assert_allclose(got, want, rtol=1e-4 if i == 0 else 2e-2)


def test_checkpoint_reloads_bit_for_bit(runs):
    """The run's last checkpoint, loaded by a new runner: epoch 2, the
    metrics it was saved with (the reference keeps the saving epoch's under
    "best_metrics"), and the generator's parameters and buffers and Adam's moments
    and steps equal the run's bit for bit. (SpareNet's runner draws nothing
    at random, so it keeps no generator state; the GAN runner's is checked
    in tests/test_torch_train_gan.py.)"""
    run = runs["port"]
    last = os.path.join(run.config.DIR.checkpoints, runs["plog"].saved()[-1]
                        + ".pth")
    payload = torch.load(last, weights_only=True)
    assert set(payload) == {"epoch_index", "best_metrics", "net_G", "optim_G"}
    cfg = cfg_from_file(runs["yaml"])
    cfg.DIR.out_path = str(runs["root"] / "reload")
    cfg_update(cfg, weights=last, timestamp=False)
    again = port_runner_mod.sparenetRunner(cfg, _Log(), device="cpu")
    assert again.init_epoch == 2
    assert again.best_metrics.state_dict() == run.metrics.state_dict()
    for (k, a), (k2, b) in zip(again.model.state_dict().items(),
                               run.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    sa, sb = again.optimizer.state_dict(), run.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys() and sa["state"]
    for i in sb["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)


def test_check_finite_raises_on_nan(runs, monkeypatch):
    """A NaN loss stops the epoch with FloatingPointError naming the loss,
    the epoch and batch and where to resume from."""
    run = runs["port"]
    monkeypatch.setattr(run, "train_step", types.MethodType(
        port_runner_mod.sparenetRunner.train_step, run))     # no replays
    monkeypatch.setattr(port_runner_mod, "train_step", lambda *a: (
        torch.tensor(float("nan")), torch.tensor(1.0), torch.tensor(1.0)))
    run.epoch_idx = 3
    with pytest.raises(FloatingPointError,
                       match=r"\['rec_loss'\] at epoch 3 batch 0; resume "
                             r"from the last checkpoint in"):
        run.train()


def test_cli_json_line_and_resume(runs, tmp_path, capsys):
    """``python -m sparenet_tpu_torch.train --device cpu`` on the toy config,
    resumed from the run's last checkpoint (epoch 2) with ``--epochs 3``:
    its last line has epoch 3 alone at lr_for_epoch(3), the epoch's mean
    losses, the best metrics, seconds by part and clouds/s, each op's plain
    calls and no launch; it saves one checkpoint. (The GAN CLI's test starts
    a run afresh.)"""
    run = runs["port"]
    last = os.path.join(run.config.DIR.checkpoints, runs["plog"].saved()[-1]
                        + ".pth")
    assert train_cli.main(["--model", "sparenet", "--config", runs["yaml"],
                           "--dataset", "Synthetic", "--device", "cpu",
                           "--workdir", str(tmp_path), "--epochs", "3",
                           "--weights", last]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    want_lr = port_base.lr_for_epoch(cfg_from_file(runs["yaml"]).TRAIN, 3)
    assert line["epochs"] == [3] and line["lr"] == {"3": want_lr}
    assert want_lr == pytest.approx(5e-7)
    assert set(line["epoch_losses"]["3"]) == {"CoarseLoss", "RefineLoss"}
    assert line["clouds_trained"] == 8 and line["clouds_per_s"] > 0
    assert set(line["seconds"]) == {"data", "step", "val", "total"}
    assert line["best_metrics"]["ChamferDistance"] > 0
    assert line["launches"] == {} and line["device"] == "cpu"
    # 2 steps and 1 validation batch: kNN 4 a forward, MDS 2
    assert line["plain_calls"]["knn"] == 12 and line["plain_calls"]["mds"] == 6
    assert line["plain_calls"]["edge_stats_bwd"] == 8
    assert len(list((tmp_path / "checkpoints").rglob("*.pth"))) == 1
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_cli_needs_a_card_unless_asked_for_the_cpu(runs, tmp_path,
                                                   monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--config", runs["yaml"], "--workdir", str(tmp_path)])


FAMILY_YAML = """\
DATASET: {{train_dataset: Synthetic, test_dataset: Synthetic, n_outpoints: 128}}
CONST: {{num_workers: 2, n_input_points: 64}}
NETWORK: {{n_primitives: 4, n_sampling_points: 16, model_type: {model},
           metric: emd}}
TRAIN: {{batch_size: 2, n_epochs: 1, save_freq: 1, log_freq: 1}}
TEST: {{metric_name: EMD, batch_size: 2, emd_iters: 5}}
DATASETS: {{synthetic: {{n_train: 2, n_val: 2}}}}
"""
# a training step's plain calls (the EMD auction's bids 50 a reconstruction
# loss; MSN's expansion and MDS once; GRNet's sparse Chamfer, the NN both
# ways) and a validation batch's (the auction at 5 rounds for the metric and
# 50 for each validation loss, the NN both ways for the metrics and for
# GRNet's sparse loss)
FAMILY_CALLS = {"atlasnet": {"emd_bids": 50 + 50 + 5, "nn_idx": 2},
                "msn": {"emd_bids": 100 + 100 + 5, "nn_idx": 2,
                        "expansion": 2, "mds": 2},
                "grnet": {"emd_bids": 50 + 50 + 5, "nn_idx": 2 + 2 + 2}}
FAMILY = {"msn": ("MSN", "rng_grid"), "atlasnet": ("AtlasNet", "rng_grid"),
          "grnet": ("GRNet", "rng_sample")}


@pytest.mark.parametrize("model", ["msn", "atlasnet", "grnet"])
def test_cli_trains_evaluates_and_resumes(tmp_path, capsys, model):
    """``--model msn|atlasnet|grnet`` on the CPU (plain versions; the models
    at define_G's widths, 64 -> 128 points, EMD; MSN and AtlasNet with 4
    primitives, GRNet on its 64^3 grid with 16 sampled points): one epoch
    of one step at B=2, validation, a checkpoint; the evaluation CLI on
    that checkpoint reads the metrics the epoch's validation read (its
    grids or sample seeded by the batch's index, as the JAX package's
    are); a runner resumed from it holds the trained generator, its Adam
    and the step draws' generator bit for bit, and starts at epoch 2.
    GRNet's case takes about 15 s on two threads: its checkpoint holds 77M
    parameters and Adam's two moments."""
    name, rng_key = FAMILY[model]
    cfg_path = tmp_path / "toy.yaml"
    cfg_path.write_text(FAMILY_YAML.format(model=name))
    args = ["--model", model, "--config", str(cfg_path), "--device", "cpu"]
    run = train_cli.build(args + ["--workdir", str(tmp_path / "train")])
    line = train_cli.run(run)
    assert line["epochs"] == [1] and line["clouds_trained"] == 2
    meters = ({"RefineLoss"} if model == "atlasnet"
              else {"CoarseLoss", "RefineLoss"})
    assert set(line["epoch_losses"]["1"]) == meters
    assert line["launches"] == {} and line["plain_calls"] == FAMILY_CALLS[model]
    assert line["mml_calibration"] == (5.65 if model == "msn" else None)
    (ckpt,) = list((tmp_path / "train" / "checkpoints").rglob("*.pth"))
    payload = torch.load(ckpt, weights_only=True)
    assert set(payload) == {"epoch_index", "best_metrics", "net_G", "optim_G",
                            rng_key}

    assert test_cli.main(args + ["--weights", str(ckpt), "--workdir",
                                 str(tmp_path / "test")]) == 0
    test_line = json.loads(capsys.readouterr().out.splitlines()[-1])
    for k, v in line["best_metrics"].items():
        assert test_line[k] == pytest.approx(v, rel=1e-6), k

    again = train_cli.build(args + ["--workdir", str(tmp_path / "resume"),
                                    "--weights", str(ckpt), "--epochs", "2"])
    assert again.init_epoch == 1
    assert torch.equal(again.step_generator.get_state(),
                       run.step_generator.get_state())
    for (k, a), (k2, b) in zip(again.model.state_dict().items(),
                               run.model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k
    sa, sb = again.optimizer.state_dict(), run.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys() and sa["state"]
    for i in sb["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_profiler_hooks(tmp_path):
    """utils/profiler.py on the CPU: ``trace`` writes a Chrome trace that
    holds an ``annotate`` span, and ``StepTimer`` summarises its steps."""
    timer = profiler.StepTimer("toy")
    with profiler.trace(str(tmp_path)) as prof:
        for _ in range(3):
            timer.start()
            with profiler.annotate("toy_span"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            timer.stop()
    assert any(e.key == "toy_span" for e in prof.key_averages())
    assert "toy_span" in (tmp_path / "trace.json").read_text()
    summary = timer.summary()
    assert summary["name"] == "toy" and summary["n"] == 3
    assert 0 < summary["min_ms"] <= summary["p50_ms"] <= summary["p90_ms"]
