"""The AtlasNet runner (counterpart of sparenet_tpu/runners/atlasnet.py:
_single_loss, _train_impl and atlasnetRunner), and the training step of the
two families that fold random grids (AtlasNet, MSN).

``train_step(model, optimizer, partial, gt, lr, generator, cfg=None,
loss=atlasnet_loss)`` runs one step on the model's device: the train-mode
forward on grids drawn from ``generator`` (a CPU ``torch.Generator``), the
family's ``loss`` of its outputs, its gradient, one Adam step at ``lr`` and
the BatchNorm running-statistics update. It returns (loss, coarse_loss,
refine_loss) as 0-d tensors on the device; for AtlasNet all three are its
one reconstruction loss (``atlasnet_loss``: one EMD auction at the loss's
protocol, mean(sqrt(dist)), or the chamfer form, by NETWORK.metric).
``cfg`` holds the settings as ``CONFIG`` does (atlasnet.yaml's).

``atlasnetRunner`` is ``sparenetRunner`` with AtlasNet (``models.define_G``),
one RefineLoss meter, the step above on grids from a ``torch.Generator``
seeded from CONST.seed (``step_generator``, kept in the checkpoint under
``RNG_KEY``, ``rng_grid``, so a resumed run draws the grids the run it
resumes would have drawn) and validation on grids from a generator seeded
with the batch's index, as the JAX package seeds PRNGKey(model_idx). With a
serving dial validation runs AtlasNet's serving mode (the decoders' bf16
chain; there is no MDS and no mml).
"""

from __future__ import annotations

import torch

from ..configs import model_names
from ..models import complete
from .base import set_lr
from .misc import AverageMeter
from .sparenet import CONFIG as FLAGSHIP_TRAIN
from .sparenet import reconstruction, sparenetRunner, step_inputs

__all__ = ["CONFIG", "atlasnet_loss", "train_step", "atlasnetRunner"]

# sparenet_tpu/configs/atlasnet.yaml (and msn.yaml, the same TRAIN block)
# over configs/defaults.py: metric emd, no consistency loss, batch 32, lr 1e-4
CONFIG = dict(FLAGSHIP_TRAIN, use_consist_loss=False, batch_size=32)


def atlasnet_loss(refine, gt, cfg: dict):
    """(loss, loss, loss): AtlasNet's one reconstruction loss."""
    loss = reconstruction(refine, gt, cfg["metric"], cfg["emd_eps"],
                          cfg["emd_iters"])
    return loss, loss, loss


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               partial: torch.Tensor, gt: torch.Tensor, lr: float,
               generator: torch.Generator, cfg: dict | None = None,
               loss=atlasnet_loss):
    """One training step; see the module docstring."""
    cfg = CONFIG if cfg is None else cfg
    x, y = step_inputs(model, partial, gt)
    model.train()
    optimizer.zero_grad(set_to_none=True)
    total, coarse_loss, refine_loss = loss(model(x, generator=generator), y,
                                           cfg)
    total.backward()
    set_lr(optimizer, lr)
    optimizer.step()
    return total.detach(), coarse_loss.detach(), refine_loss.detach()


class atlasnetRunner(sparenetRunner):
    """The reference's class name, which the runner registry keys."""

    model_type = model_names.MODEL_ATLASNET
    step_loss = staticmethod(atlasnet_loss)
    METERS = ("RefineLoss",)
    RNG_KEY = "rng_grid"      # the step generator's name in the checkpoint

    def __init__(self, config, logger, device=None, dial=None):
        super().__init__(config, logger, device, dial)
        self.losses = AverageMeter(list(self.METERS))
        self.test_losses = AverageMeter(list(self.METERS))

    def build_models(self):
        """The generator and its Adam (``sparenetRunner.build_models``),
        then the generator of the training steps' draws, seeded from
        CONST.seed."""
        super().build_models()
        self.step_generator = torch.Generator().manual_seed(
            self.config.CONST.seed)

    def training_state(self) -> dict:
        return {"optim_G": self.optimizer, self.RNG_KEY: self.step_generator}

    def train_step(self, items):
        _, _, _, data = items
        partial, gt = self._put_batch(data)
        loss, c_l, r_l = train_step(self.model, self.optimizer, partial, gt,
                                    self.lr, self.step_generator,
                                    self.step_config, self.step_loss)
        c_l, r_l = float(c_l) * 1000, float(r_l) * 1000
        self.loss = {"refine_loss": r_l, "rec_loss": float(loss)}
        if "CoarseLoss" in self.METERS:
            self.loss["coarse_loss"] = c_l
        meters = {"CoarseLoss": c_l, "RefineLoss": r_l}
        self.losses.update([meters[m] for m in self.METERS])

    def val_outputs(self, partial):
        """The eval forward of one batch on grids seeded with its index."""
        return complete(self.model, partial,
                        generator=torch.Generator().manual_seed(self.model_idx))

    def _val_impl(self, partial, gt):
        refine = self.val_outputs(partial)
        return refine, [self.rec(refine, gt)]
