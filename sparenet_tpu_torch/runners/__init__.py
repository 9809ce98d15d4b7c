"""Runners: the flagship SpareNet training step (``runners.sparenet.
train_step``), the SpareNet-GAN step (``runners.sparenet_gan.gan_step``),
the AtlasNet and MSN steps (``runners.atlasnet.train_step``,
``runners.msn.train_step``), the optimizer rules (``runners.base``) and the
runners around them (``sparenetRunner``, ``sparenetGANRunner``,
``atlasnetRunner``, ``msnRunner``), resolved by ``get_runner``."""

from __future__ import annotations

from ..configs import model_names
from .atlasnet import atlasnetRunner
from .base import BaseRunner
from .misc import AverageMeter
from .msn import msnRunner
from .sparenet import sparenetRunner
from .sparenet_gan import sparenetGANRunner

__all__ = ["BaseRunner", "AverageMeter", "RUNNERS", "get_runner",
           "runner_class", "sparenetRunner", "sparenetGANRunner",
           "atlasnetRunner", "msnRunner"]

RUNNERS = {
    (model_names.MODEL_SPARENET, False): sparenetRunner,
    (model_names.MODEL_SPARENET, True): sparenetGANRunner,
    (model_names.MODEL_ATLASNET, False): atlasnetRunner,
    (model_names.MODEL_MSN, False): msnRunner,
}
# the runners still to port, and the queue item of ROADMAP.md that ports each
_WAITING = {
    (model_names.MODEL_GRNET, False): "queue 1 item 5 (GRNet)",
}


def runner_class(model_type: str, gan: bool = False):
    """The runner class for (model_type, gan)."""
    key = (model_type, bool(gan))
    if key in RUNNERS:
        return RUNNERS[key]
    if key in _WAITING:
        raise NotImplementedError(
            f"no runner for model={model_type!r} gan={gan} yet: "
            f"ROADMAP.md, {_WAITING[key]}")
    raise ValueError(f"No runner for model={model_type!r} gan={gan}")


def get_runner(cfg, gan: bool = False):
    """Resolve the runner class from cfg.NETWORK.model_type (the reference
    does this by string reflection, train.py:56-64)."""
    return runner_class(cfg.NETWORK.model_type, gan)
