"""The runners' base (counterpart of sparenet_tpu/runners/base.py): the
optimizer and learning-rate rules (make_optimizer, set_lr, lr_for_epoch) and
``BaseRunner``'s training and evaluation lifecycle.

The reference steps params with optax ``add_decayed_weights(wd)`` (when
TRAIN.weight_decay is set) then ``scale_by_adam(b1, b2, eps=1e-8)`` and
``p - lr * u``: the decay is L2 added to the gradient before Adam, which is
``torch.optim.Adam(weight_decay=wd)``. The port uses that Adam with the same
betas and eps: the same update up to rounding (torch divides by sqrt(nu) /
sqrt(1 - b2^t) where optax takes sqrt(nu / (1 - b2^t))). The learning rate
is set on the optimizer before each step, as the reference feeds a
per-epoch scalar.

``BaseRunner(config, logger, device=None)`` builds the writers, the dataset
(``data.data_init``), the models (``build_models``, a subclass's) and loads
CONST.weights (``utils.checkpoint``, with the training state a subclass
names in ``training_state``). ``runner()`` runs the epochs from
``init_epoch + 1`` to TRAIN.n_epochs, each at ``lr_for_epoch``: ``train()``
(a subclass's ``train_step`` a batch, its losses checked finite and logged
every TRAIN.log_freq batches) then ``val()``. ``test()`` runs ``val()``
alone: a ``val_step`` (a subclass's) a batch, the overall and per-category
meters, the table, and a checkpoint on improvement or every TRAIN.save_freq
epochs. The runner works on ``device`` (``None``: the card). Training
seconds are split into data (waiting for the loader and the copy to the
device), step and val in ``train_seconds``; each validation batch's into
data, forward (the eval forward and the validation losses) and metrics in
``seconds``, and its metric means are kept in ``batch_metrics``. There is no
mesh and no multi-host yet (ROADMAP.md, queue 1 item 8). The JAX package's
serving-mode mml self-calibration at load is not ported: parity mode, the
only mode the runner builds, never reads its result.
"""

from __future__ import annotations

import math
import os
from copy import deepcopy
from time import perf_counter

import torch
import yaml

from ..configs import AttrDict
from ..data import data_init
from ..models import resolve_device
from ..utils import checkpoint as ckpt
from ..utils import visualizer as uv
from ..utils.logging import writer_init
from ..utils.metrics import Metrics
from .misc import AverageMeter

__all__ = ["make_optimizer", "set_lr", "lr_for_epoch", "BaseRunner"]


def make_optimizer(model: torch.nn.Module, cfg: dict) -> torch.optim.Adam:
    """Adam over the parameters that take part in the step (the reference's
    registered-but-unused ones never get a gradient and are skipped), with
    ``weight_decay`` as L2 on the gradient (see the module docstring)."""
    return torch.optim.Adam(model.parameters(), lr=cfg["learning_rate"],
                            betas=tuple(cfg["betas"]), eps=1e-8,
                            weight_decay=float(cfg["weight_decay"]))


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def lr_for_epoch(cfg: dict, epoch_idx: int) -> float:
    """MultiStepLR(milestones, gamma) as a plain function of the epoch."""
    lr = cfg["learning_rate"]
    for m in cfg["lr_milestones"]:
        if epoch_idx > m:
            lr *= cfg["gamma"]
    return lr


def _plain(node):
    """A config tree as plain dicts and lists (for yaml.safe_dump)."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


class BaseRunner:
    """Training and evaluation lifecycle (runners/base_runner.py:23-355)."""

    def __init__(self, config: AttrDict, logger, device=None):
        self.config = deepcopy(config)
        self.logger = logger
        self.device = resolve_device(device)
        self.work_dir = self.config.DIR.out_path
        os.makedirs(self.work_dir, exist_ok=True)
        os.makedirs(self.config.DIR.checkpoints, exist_ok=True)
        with open(os.path.join(self.work_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(_plain(self.config), f)

        self.init_epoch = 0
        self.best_metrics = None
        self.epoch_idx = 0
        self.metrics = None
        self.ptcloud = None
        self.loss: dict = {}
        self.train_time = AverageMeter()
        self.val_time = AverageMeter()
        self.seconds = dict.fromkeys(("data", "forward", "metrics"), 0.0)
        self.train_seconds = dict.fromkeys(("data", "step", "val"), 0.0)
        self.batch_metrics: list = []
        self.epoch_losses: dict = {}
        self.epoch_lr: dict = {}
        self.clouds_trained = 0

        self.build_writer()
        self.build_dataset()
        self.build_models()
        self.models_load()

    # construction

    def build_writer(self):
        self.train_writer, self.val_writer = writer_init(self.config)

    def build_dataset(self):
        self.train_loader, self.val_loader = data_init(self.config)
        self.logger.info("Finish building dataset.")

    def build_models(self):
        raise NotImplementedError

    def training_state(self) -> dict:
        """What a checkpoint keeps beside net_G, by name (a subclass's)."""
        return {}

    def models_load(self):
        self.init_epoch, self.best_metrics = ckpt.checkpoint_load(
            self.config, self.model, self.logger, self.training_state())

    def models_save(self):
        self.best_metrics = ckpt.checkpoint_save(
            self.config, self.epoch_idx, self.metrics, self.best_metrics,
            self.model, self.logger, self.training_state())

    # steps (implemented by subclasses)

    def train_step(self, items):
        raise NotImplementedError

    def val_step(self, items):
        raise NotImplementedError

    def reset_meters(self):
        raise NotImplementedError

    # loops

    def check_finite(self):
        """Fail fast on a non-finite training loss, with what resumes the
        run (the last good checkpoint)."""
        bad = [k for k, v in self.loss.items() if not math.isfinite(v)]
        if bad:
            raise FloatingPointError(
                f"non-finite training loss {bad} at epoch {self.epoch_idx} "
                f"batch {self.batch_idx}; resume from the last checkpoint in "
                f"{self.config.DIR.checkpoints} with a lower learning rate")

    def save_item_train_info(self):
        self.check_finite()
        n_itr = (self.epoch_idx - 1) * self.n_batches + self.batch_idx
        if self.batch_idx % self.config.TRAIN.log_freq == 0:
            for k, v in self.loss.items():
                self.train_writer.add_scalar("Loss/Batch/" + k, v, n_itr)
            self.logger.info(
                "[Epoch %d/%d][Batch %d/%d] BatchTime = %.3f (s) Losses = %s"
                % (self.epoch_idx, self.config.TRAIN.n_epochs,
                   self.batch_idx + 1, self.n_batches, self.train_time.val(),
                   ["%.4f" % l for l in self.losses.val()]))

    def train(self):
        """One epoch over the training loader at ``self.lr``."""
        self.logger.info("Start training.")
        self.epoch_start_time = perf_counter()
        self.n_batches = len(self.train_loader)
        batches = iter(self.train_loader)
        self.batch_idx = 0
        while True:
            t0 = perf_counter()
            items = next(batches, None)
            self.train_seconds["data"] += perf_counter() - t0
            if items is None:
                break
            copied = self.train_seconds["data"]
            t0 = perf_counter()
            self.train_step(items)        # adds its copy to the device to data
            dt = perf_counter() - t0
            self.train_time.update(dt)
            self.train_seconds["step"] += dt - (self.train_seconds["data"]
                                                - copied)
            self.clouds_trained += len(items[0])
            self.save_item_train_info()
            self.batch_idx += 1
        self.train_finish()

    def train_finish(self):
        self.epoch_end_time = perf_counter()
        means = self.losses.avg()
        for name, v in zip(self.losses.items, means):
            self.train_writer.add_scalar("Loss/Epoch/" + name, v,
                                         self.epoch_idx)
        self.epoch_losses[self.epoch_idx] = dict(zip(self.losses.items, means))
        self.logger.info(
            "[Epoch %d/%d] EpochTime = %.3f (s) Losses = %s"
            % (self.epoch_idx, self.config.TRAIN.n_epochs,
               self.epoch_end_time - self.epoch_start_time,
               ["%.4f" % l for l in means]))

    def runner(self):
        """Epoch loop (runners/base_runner.py:329-342): epochs init_epoch + 1
        to TRAIN.n_epochs, each trained at lr_for_epoch, then validated."""
        start = perf_counter()
        for epoch_idx in range(self.init_epoch + 1,
                               self.config.TRAIN.n_epochs + 1):
            self.epoch_idx = epoch_idx
            self.lr = self.epoch_lr[epoch_idx] = lr_for_epoch(self.config.TRAIN,
                                                              epoch_idx)
            self.reset_meters()
            self.train()
            t0 = perf_counter()
            self.val()
            self.train_seconds["val"] += perf_counter() - t0
        self.logger.info("runner time: %3f" % (perf_counter() - start))
        self.train_writer.close()
        self.val_writer.close()

    def val(self):
        self.category_metrics = {}
        self.batch_metrics = []
        self.seconds = dict.fromkeys(self.seconds, 0.0)
        self.logger.info("Start validating.")
        self.n_batches = len(self.val_loader)
        batches = iter(self.val_loader)
        self.model_idx = 0
        while True:
            t0 = perf_counter()
            items = next(batches, None)
            self.seconds["data"] += perf_counter() - t0
            if items is None:
                break
            taxonomy_ids, _, model_ids, data = items
            self.taxonomy_id = taxonomy_ids[0]
            self.model_id = model_ids[0]
            t0 = perf_counter()
            per_sample = self.val_step(items)
            self.val_time.update(perf_counter() - t0)
            self.batch_metrics.append([float(v) for v in per_sample.mean(1)])
            self._accumulate_val(taxonomy_ids, per_sample)
            if self.model_idx % self.config.TRAIN.log_freq == 0:
                self.logger.info(
                    "Test[%d/%d] Taxonomy = %s Sample = %s Losses = %s Metrics = %s"
                    % (self.model_idx + 1, self.n_batches, self.taxonomy_id,
                       self.model_id,
                       ["%.4f" % l for l in self.test_losses.val()],
                       ["%.4f" % m for m in self.metrics]))
            self.inference(data)
            self.model_idx += 1
        self.metrics = Metrics(self.config.TEST.metric_name,
                               self.test_metrics.avg())
        self.val_finish()

    def _accumulate_val(self, taxonomy_ids, per_sample):
        """per_sample: numpy [3, B] metric values."""
        for j, tid in enumerate(taxonomy_ids):
            vals = [float(per_sample[i, j]) for i in range(per_sample.shape[0])]
            self.test_metrics.update(vals)
            if tid not in self.category_metrics:
                self.category_metrics[tid] = AverageMeter(Metrics.names())
            self.category_metrics[tid].update(vals)
        self.metrics = [
            self.test_metrics.val(i) for i in range(len(Metrics.names()))
        ]

    def val_finish(self):
        uv.print_table(self.config, self.epoch_idx, self.test_metrics,
                       self.category_metrics, self.val_writer,
                       self.test_losses)
        self.models_save()

    def inference(self, data):
        """Side outputs per TEST.mode: "default" writes images to the
        writers, which are no-op writers here."""
        if self.config.TEST.mode != "default":
            raise NotImplementedError(
                f"TEST.mode {self.config.TEST.mode!r}: the plots, depth maps "
                f"and KITTI outputs are not ported yet (ROADMAP.md, queue 1 "
                f"item 3)")

    def test(self):
        """Standalone eval (runners/base_runner.py:344-355)."""
        if self.init_epoch == 0:
            raise ValueError("test requires a loaded checkpoint (CONST.weights)")
        start = perf_counter()
        self.epoch_idx = -1
        self.reset_meters()
        self.val()
        self.logger.info("test time: %3f" % (perf_counter() - start))
        self.train_writer.close()
        self.val_writer.close()

    def summary(self) -> dict:
        """The split's per-metric means, its clouds and the seconds by
        part: the evaluation CLI's last line."""
        out = dict(zip(Metrics.names(), self.test_metrics.avg()))
        n = self.test_metrics.count(0)
        total = sum(self.seconds.values())
        out.update(n_clouds=n, batches=len(self.batch_metrics),
                   seconds=dict(self.seconds, total=total),
                   clouds_per_s=n / total if total else 0.0)
        return out

    def train_summary(self) -> dict:
        """The epochs run, each one's lr and mean losses, the best metrics,
        the training seconds by part and the clouds trained a second of data
        and step time: the training CLI's last line."""
        total = sum(self.train_seconds.values())
        busy = self.train_seconds["data"] + self.train_seconds["step"]
        best = self.best_metrics
        return dict(
            epochs=sorted(self.epoch_losses),
            lr={str(k): v for k, v in sorted(self.epoch_lr.items())},
            epoch_losses={str(k): v for k, v in sorted(self.epoch_losses.items())},
            best_metrics=None if best is None else {
                k: float(v) for k, v in best.state_dict().items()},
            clouds_trained=self.clouds_trained,
            seconds=dict(self.train_seconds, total=total),
            clouds_per_s=self.clouds_trained / busy if busy else 0.0)
