"""Checkpoints of the port (counterpart of sparenet_tpu/utils/checkpoint.py).

A checkpoint is a ``torch.save`` file in the original reference's layout,
``{"epoch_index", "best_metrics", "net_G"}`` (utils/misc.py:54-109), the
generator's state_dict under "net_G" in the reference's keys and shapes
(``utils.weights.reference_state_dict``). It is
named as the JAX package names its checkpoints, ``ckpt-best`` on a metric
improvement and ``ckpt-epoch-NNN`` every TRAIN.save_freq epochs, with the
reference's ``.pth`` suffix. ``checkpoint_load`` also takes the JAX
package's bf16 archive (a ``.npz``: ``utils.ckpt_npz.load_npz``, then
``utils.weights.state_dict_from_jax``), as epoch 1 with no best metrics.
Either loads strictly: a key missing or left over is an error.
"""

from __future__ import annotations

import os

import torch

from .ckpt_npz import load_npz
from .metrics import Metrics
from .weights import reference_state_dict, state_dict_from_jax

__all__ = ["checkpoint_save", "checkpoint_load", "checkpoint_name"]


def checkpoint_name(epoch_idx: int, improved: bool) -> str:
    return "ckpt-best.pth" if improved else f"ckpt-epoch-{epoch_idx:03d}.pth"


def checkpoint_save(cfg, epoch_idx: int, metrics: Metrics,
                    best_metrics: Metrics | None, model: torch.nn.Module,
                    logger=None):
    """Save on TRAIN.save_freq or improvement; returns the best metrics."""
    improved = metrics.better_than(best_metrics)
    if epoch_idx % cfg.TRAIN.save_freq == 0 or improved:
        path = os.path.abspath(os.path.join(
            cfg.DIR.checkpoints, checkpoint_name(epoch_idx, improved)))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({
            "epoch_index": int(epoch_idx),
            "best_metrics": {k: float(v) for k, v in metrics.state_dict().items()},
            "net_G": reference_state_dict(model),
        }, path)
        if logger:
            logger.info("Saved checkpoint to %s ..." % path)
        if improved:
            best_metrics = metrics
    return best_metrics


def checkpoint_load(cfg, model: torch.nn.Module, logger=None):
    """Load cfg.CONST.weights into ``model`` (strict) -> (init_epoch,
    best_metrics); (0, None) and the model untouched if no weights are set."""
    if not cfg.CONST.weights:
        return 0, None
    path = os.path.abspath(cfg.CONST.weights)
    if path.endswith(".npz"):
        state = state_dict_from_jax(load_npz(path),
                                    use_selayer=cfg.NETWORK.use_selayer,
                                    n_primitives=cfg.NETWORK.n_primitives)
        epoch, best = 1, None
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state = payload["net_G"]
        epoch = int(payload.get("epoch_index", 0))
        best = (Metrics(cfg.TEST.metric_name, dict(payload["best_metrics"]))
                if payload.get("best_metrics") else None)
    model.load_state_dict(state, strict=True)
    if logger:
        logger.info("Recover complete. Current epoch = #%d; best metrics = %s."
                    % (epoch, best))
    return epoch, best
