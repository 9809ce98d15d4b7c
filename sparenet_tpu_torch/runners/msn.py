"""The MSN runner (counterpart of sparenet_tpu/runners/msn.py: msnRunner).

``msn_loss`` is the reference's: the reconstruction loss of coarse and of
refine (``reconstruction`` by NETWORK.metric) + 0.1 * the expansion penalty.
``train_step(model, optimizer, partial, gt, lr, generator, cfg=None)`` is
AtlasNet's step (``runners.atlasnet.train_step``) with that loss: per step
the MSN forward launches the expansion kernel once and greedy MDS once, and
the EMD form two auctions (50 bids launches each at the loss's protocol).

``msnRunner`` is ``atlasnetRunner`` with MSN, the CoarseLoss and RefineLoss
meters and validation losses of coarse and refine. With a serving dial
validation runs MSN's serving branch on it (the NN-mean mml at the family's
5.65, or the ratio fitted at load, and the dial's MDS arm).
"""

from __future__ import annotations

import torch

from ..configs import model_names
from . import atlasnet
from .atlasnet import CONFIG, atlasnetRunner
from .sparenet import reconstruction

__all__ = ["CONFIG", "msn_loss", "train_step", "msnRunner"]


def msn_loss(outs, gt, cfg: dict):
    """(coarse_loss + refine_loss + 0.1 * loss_mst, coarse_loss,
    refine_loss) of MSN's outputs (coarse, refine, loss_mst)."""
    coarse, refine, loss_mst = outs
    c_l, r_l = (reconstruction(a, gt, cfg["metric"], cfg["emd_eps"],
                               cfg["emd_iters"]) for a in (coarse, refine))
    return c_l + r_l + loss_mst * 0.1, c_l, r_l


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               partial: torch.Tensor, gt: torch.Tensor, lr: float,
               generator: torch.Generator, cfg: dict | None = None):
    """One MSN training step; see the module docstring."""
    return atlasnet.train_step(model, optimizer, partial, gt, lr, generator,
                               cfg, msn_loss)


class msnRunner(atlasnetRunner):
    """The reference's class name, which the runner registry keys."""

    model_type = model_names.MODEL_MSN
    step_loss = staticmethod(msn_loss)
    METERS = ("CoarseLoss", "RefineLoss")

    def _val_impl(self, partial, gt):
        coarse, refine, _ = self.val_outputs(partial)
        if gt is None:
            return refine, None
        return refine, [self.rec(coarse, gt), self.rec(refine, gt)]
