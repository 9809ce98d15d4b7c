"""Runners: the flagship SpareNet training step (``runners.sparenet.
train_step``), the SpareNet-GAN step (``runners.sparenet_gan.gan_step``),
the AtlasNet, MSN and GRNet steps (``runners.atlasnet.train_step``,
``runners.msn.train_step``, ``runners.grnet.train_step``), the optimizer
rules (``runners.base``) and the runners around them (``sparenetRunner``,
``sparenetGANRunner``, ``atlasnetRunner``, ``msnRunner``, ``grnetRunner``),
resolved by ``get_runner``."""

from __future__ import annotations

from ..configs import model_names
from .atlasnet import atlasnetRunner
from .base import BaseRunner
from .grnet import grnetRunner
from .misc import AverageMeter
from .msn import msnRunner
from .sparenet import sparenetRunner
from .sparenet_gan import sparenetGANRunner

__all__ = ["BaseRunner", "AverageMeter", "RUNNERS", "get_runner",
           "runner_class", "sparenetRunner", "sparenetGANRunner",
           "atlasnetRunner", "msnRunner", "grnetRunner"]

RUNNERS = {
    (model_names.MODEL_SPARENET, False): sparenetRunner,
    (model_names.MODEL_SPARENET, True): sparenetGANRunner,
    (model_names.MODEL_ATLASNET, False): atlasnetRunner,
    (model_names.MODEL_MSN, False): msnRunner,
    (model_names.MODEL_GRNET, False): grnetRunner,
}


def runner_class(model_type: str, gan: bool = False):
    """The runner class for (model_type, gan)."""
    key = (model_type, bool(gan))
    if key in RUNNERS:
        return RUNNERS[key]
    raise ValueError(f"No runner for model={model_type!r} gan={gan}")


def get_runner(cfg, gan: bool = False):
    """Resolve the runner class from cfg.NETWORK.model_type (the reference
    does this by string reflection, train.py:56-64)."""
    return runner_class(cfg.NETWORK.model_type, gan)
