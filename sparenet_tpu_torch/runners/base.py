"""The runners' base (counterpart of sparenet_tpu/runners/base.py): the
optimizer and learning-rate rules (make_optimizer, apply_updates,
lr_for_epoch) and ``BaseRunner``'s evaluation lifecycle.

The reference steps params with optax ``scale_by_adam(b1, b2, eps=1e-8)``
(+ decoupled weight decay when set) and ``p - lr * u``. The port uses
``torch.optim.Adam`` with the same betas, eps 1e-8 and weight decay: the
same update up to rounding (torch divides by sqrt(nu) / sqrt(1 - b2^t)
where optax takes sqrt(nu / (1 - b2^t))). The learning rate is set on the
optimizer before each step, as the reference feeds a per-epoch scalar.

``BaseRunner(config, logger, device=None)`` builds the writers, the dataset
(``data.data_init``), the models (``build_models``, a subclass's) and loads
CONST.weights (``utils.checkpoint``); ``test()`` runs ``val()`` over the
validation loader, a ``val_step`` (a subclass's) a batch, keeps the overall
and per-category meters, prints the table and saves a checkpoint on
improvement. The runner works on ``device`` (``None``: the card). Each
batch's time is split into data (waiting for the loader and the copy to the
device), forward (the eval forward and the validation losses) and metrics,
in ``seconds``, and its metric means are kept in ``batch_metrics``. There is
no mesh, no multi-host and no training epoch loop yet (ROADMAP.md, queue 1
items 3 and 8). The JAX package's serving-mode mml self-calibration at
load is not ported: parity mode, the only mode the runner builds, never
reads its result.
"""

from __future__ import annotations

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
    registered-but-unused ones never get a gradient and are skipped)."""
    if cfg["weight_decay"]:
        raise NotImplementedError(
            "weight_decay: the reference's decoupled decay is not ported yet")
    return torch.optim.Adam(model.parameters(), lr=cfg["learning_rate"],
                            betas=tuple(cfg["betas"]), eps=1e-8,
                            weight_decay=0.0)


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
    """Evaluation lifecycle (runners/base_runner.py:23-355)."""

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
        self.val_time = AverageMeter()
        self.seconds = dict.fromkeys(("data", "forward", "metrics"), 0.0)
        self.batch_metrics: list = []

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

    def models_load(self):
        self.init_epoch, self.best_metrics = ckpt.checkpoint_load(
            self.config, self.model, self.logger)

    def models_save(self):
        self.best_metrics = ckpt.checkpoint_save(
            self.config, self.epoch_idx, self.metrics, self.best_metrics,
            self.model, self.logger)

    # steps (implemented by subclasses)

    def val_step(self, items):
        raise NotImplementedError

    def reset_meters(self):
        raise NotImplementedError

    # loops

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
        part: the CLI's last line."""
        out = dict(zip(Metrics.names(), self.test_metrics.avg()))
        n = self.test_metrics.count(0)
        total = sum(self.seconds.values())
        out.update(n_clouds=n, batches=len(self.batch_metrics),
                   seconds=dict(self.seconds, total=total),
                   clouds_per_s=n / total if total else 0.0)
        return out
