"""Optimizer and learning-rate rules (counterpart of
sparenet_tpu/runners/base.py: make_optimizer, apply_updates, lr_for_epoch).

The reference steps params with optax ``scale_by_adam(b1, b2, eps=1e-8)``
(+ decoupled weight decay when set) and ``p - lr * u``. The port uses
``torch.optim.Adam`` with the same betas, eps 1e-8 and weight decay: the
same update up to rounding (torch divides by sqrt(nu) / sqrt(1 - b2^t)
where optax takes sqrt(nu / (1 - b2^t))). The learning rate is set on the
optimizer before each step, as the reference feeds a per-epoch scalar.
"""

from __future__ import annotations

import torch

__all__ = ["make_optimizer", "set_lr", "lr_for_epoch"]


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
