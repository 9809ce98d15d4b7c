"""The GRNet runner (counterpart of sparenet_tpu/runners/grnet.py: _cd_mean
and grnetRunner).

``grnet_loss`` is the reference's: the Chamfer mean(d1) + mean(d2) of the
sparse cloud against gt (the NN kernel once each way, 2048 against 16384
points at grnet.yaml's widths), plus the dense cloud's reconstruction loss
by NETWORK.metric (EMD: one auction, 50 bids launches at the loss's
protocol). ``train_step(model, optimizer, partial, gt, lr, generator,
cfg=None)`` is AtlasNet's step (``runners.atlasnet.train_step``) with that
loss: the sample is drawn from ``generator`` (a CPU ``torch.Generator``).

``grnetRunner`` is ``atlasnetRunner`` with GRNet, the CoarseLoss (sparse)
and RefineLoss (dense) meters, the sample's generator seeded from
CONST.seed and kept in the checkpoint as ``rng_sample`` (so a resumed run
draws what the run it resumes would have drawn), validation sampled from a
generator seeded with the batch's index (the JAX package's
PRNGKey(model_idx)) with the sparse cloud's Chamfer and the dense cloud's
loss by NETWORK.metric. GRNet has no serving mode: with a serving dial
validation runs the same forward.
"""

from __future__ import annotations

import torch

from ..configs import model_names
from ..ops import chamfer
from . import atlasnet
from .atlasnet import CONFIG, atlasnetRunner
from .sparenet import reconstruction

__all__ = ["CONFIG", "grnet_loss", "train_step", "grnetRunner"]


def grnet_loss(outs, gt, cfg: dict):
    """(sparse_loss + dense_loss, sparse_loss, dense_loss) of GRNet's
    outputs (sparse, dense)."""
    sparse, dense = outs
    c_l = chamfer.chamfer_distance(sparse, gt)
    r_l = reconstruction(dense, gt, cfg["metric"], cfg["emd_eps"],
                         cfg["emd_iters"])
    return c_l + r_l, c_l, r_l


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               partial: torch.Tensor, gt: torch.Tensor, lr: float,
               generator: torch.Generator, cfg: dict | None = None):
    """One GRNet training step; see the module docstring."""
    return atlasnet.train_step(model, optimizer, partial, gt, lr, generator,
                               cfg, grnet_loss)


class grnetRunner(atlasnetRunner):
    """The reference's class name, which the runner registry keys."""

    model_type = model_names.MODEL_GRNET
    step_loss = staticmethod(grnet_loss)
    METERS = ("CoarseLoss", "RefineLoss")
    RNG_KEY = "rng_sample"

    def _val_impl(self, partial, gt):
        sparse, dense = self.val_outputs(partial)
        return dense, [chamfer.chamfer_distance(sparse, gt),
                       self.rec(dense, gt)]
