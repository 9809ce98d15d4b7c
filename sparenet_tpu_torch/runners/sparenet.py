"""The flagship SpareNet training step (counterpart of
sparenet_tpu/runners/sparenet.py: completion_loss and _train_impl).

``train_step(model, optimizer, partial, gt, lr)`` runs one step on the
model's device: the train-mode forward, the completion loss, its gradient,
one Adam step at ``lr`` and the BatchNorm running-statistics update (made
by the forward). It returns (loss, coarse_loss, refine_loss) as 0-d tensors
on the device. Like the other entry points it needs a card unless the model
was built with ``device="cpu"``.
"""

from __future__ import annotations

import torch

from ..models import resolve_device, set_parity_mode
from ..ops import chamfer, emd
from .base import set_lr

__all__ = ["CONFIG", "completion_loss", "train_step"]

# The flagship's training settings: sparenet_tpu/configs/sparenet.yaml
# (NETWORK.metric emd, use_consist_loss true; TRAIN.batch_size 24,
# learning_rate 1e-4) over configs/defaults.py (TRAIN.betas (0, 0.9),
# weight_decay 0, lr_milestones [1000], gamma 0.5), and the loss's EMD
# protocol (eps 0.005, 50 rounds).
CONFIG = dict(metric="emd", use_consist_loss=True, batch_size=24,
              learning_rate=1e-4, betas=(0.0, 0.9), weight_decay=0,
              lr_milestones=(1000,), gamma=0.5, emd_eps=0.005, emd_iters=50)


def completion_loss(coarse, middle, refine, expansion, gt, metric="emd",
                    use_consist_loss=True):
    """(total, coarse_loss, refine_loss): EMD form mean(sqrt(dist)) or
    chamfer form mean(d1) + mean(d2) for each of coarse, middle and refine,
    + 0.1 * the expansion penalty, + 0.5 * mean(d1) of the one-sided
    consistency Chamfer of refine against gt."""
    if metric == "chamfer":
        def rec(a):
            return chamfer.chamfer_distance(a, gt)
    elif metric == "emd":
        def rec(a):
            dist, _ = emd.emd_auction(a, gt, CONFIG["emd_eps"],
                                      CONFIG["emd_iters"])
            return dist.sqrt().mean()
    else:
        raise ValueError(f"unknown training metric {metric!r}")
    coarse_loss, middle_loss, refine_loss = rec(coarse), rec(middle), rec(refine)
    loss = coarse_loss + middle_loss + refine_loss + expansion * 0.1
    if use_consist_loss:
        d1, _, _, _ = chamfer.chamfer_raw(refine, gt)
        loss = loss + d1.mean() * 0.5
    return loss, coarse_loss, refine_loss


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               partial: torch.Tensor, gt: torch.Tensor, lr: float):
    """One training step; see the module docstring."""
    set_parity_mode()
    dev = next(model.parameters()).device
    resolve_device(dev)
    for name, t in (("partial", partial), ("gt", gt)):
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be [B, N, 3], got {tuple(t.shape)}")
    x = partial.to(device=dev, dtype=torch.float32).contiguous()
    y = gt.to(device=dev, dtype=torch.float32).contiguous()
    model.train()
    optimizer.zero_grad(set_to_none=True)
    coarse, middle, refine, loss_mst = model(x)
    loss, coarse_loss, refine_loss = completion_loss(
        coarse, middle, refine, loss_mst, y, CONFIG["metric"],
        CONFIG["use_consist_loss"])
    loss.backward()
    set_lr(optimizer, lr)
    optimizer.step()
    return loss.detach(), coarse_loss.detach(), refine_loss.detach()
