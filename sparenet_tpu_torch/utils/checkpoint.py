"""Checkpoints of the port (counterpart of sparenet_tpu/utils/checkpoint.py).

A checkpoint is a ``torch.save`` file in the original reference's layout,
``{"epoch_index", "best_metrics", "net_G"}`` (utils/misc.py:54-109), the
generator's state_dict under "net_G" in the reference's keys and shapes
(``utils.weights.reference_state_dict``), plus the rest of the training
state that the runner names, as the JAX package keeps the full state: the
generator's Adam under "optim_G", the runner's ``torch.Generator`` states,
and for SpareNet-GAN the discriminator ("net_D") and its Adam ("optim_D").
It is named as the JAX package names its checkpoints, ``ckpt-best`` on a
metric improvement and ``ckpt-epoch-NNN`` every TRAIN.save_freq epochs, with
the reference's ``.pth`` suffix. ``checkpoint_load`` also takes the JAX
package's bf16 archive (a ``.npz``: ``utils.ckpt_npz.load_npz``, then
``utils.weights.state_dict_from_jax``), as epoch 1 with no best metrics.
Either loads strictly: a key missing or left over is an error. A file with
no optimizer state (the npz, or a reference ``.pth`` with net_G only)
leaves the rest of the training state as it was built, as the JAX package
loads a reference ``.pth`` (utils/checkpoint.py:81-121): Adam starts fresh,
and so does a GAN's discriminator.
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


def _state_of(obj):
    """What a checkpoint keeps of a module, an optimizer or a generator."""
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    return obj.state_dict()


def _restore(obj, state) -> None:
    if isinstance(obj, torch.Generator):
        obj.set_state(state)
    elif isinstance(obj, torch.nn.Module):
        obj.load_state_dict(state, strict=True)
    else:
        obj.load_state_dict(state)


def checkpoint_save(cfg, epoch_idx: int, metrics: Metrics,
                    best_metrics: Metrics | None, model: torch.nn.Module,
                    logger=None, state: dict | None = None):
    """Save on TRAIN.save_freq or improvement; returns the best metrics.
    ``state``: the rest of the training state by name (modules, optimizers,
    ``torch.Generator``s), kept beside net_G."""
    improved = metrics.better_than(best_metrics)
    if epoch_idx % cfg.TRAIN.save_freq == 0 or improved:
        path = os.path.abspath(os.path.join(
            cfg.DIR.checkpoints, checkpoint_name(epoch_idx, improved)))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({
            "epoch_index": int(epoch_idx),
            "best_metrics": {k: float(v) for k, v in metrics.state_dict().items()},
            "net_G": reference_state_dict(model),
            **{k: _state_of(v) for k, v in (state or {}).items()},
        }, path)
        if logger:
            logger.info("Saved checkpoint to %s ..." % path)
        if improved:
            best_metrics = metrics
    return best_metrics


def checkpoint_load(cfg, model: torch.nn.Module, logger=None,
                    state: dict | None = None):
    """Load cfg.CONST.weights into ``model`` (strict) and, from a file that
    holds optimizer state, each part of ``state`` it holds -> (init_epoch,
    best_metrics); (0, None) and everything untouched if no weights are
    set."""
    if not cfg.CONST.weights:
        return 0, None
    path = os.path.abspath(cfg.CONST.weights)
    if path.endswith(".npz"):
        payload = {"net_G": state_dict_from_jax(
            load_npz(path), use_selayer=cfg.NETWORK.use_selayer,
            n_primitives=cfg.NETWORK.n_primitives)}
        epoch, best = 1, None
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
        epoch = int(payload.get("epoch_index", 0))
        best = (Metrics(cfg.TEST.metric_name, dict(payload["best_metrics"]))
                if payload.get("best_metrics") else None)
    model.load_state_dict(payload["net_G"], strict=True)
    fresh = sorted(state or ())
    if "optim_G" in payload:
        fresh = [k for k in fresh if k not in payload]
        for name, obj in (state or {}).items():
            if name in payload:
                _restore(obj, payload[name])
    if logger:
        logger.info("Recover complete. Current epoch = #%d; best metrics = %s."
                    % (epoch, best)
                    + (" Starting fresh: %s." % ", ".join(fresh) if fresh else ""))
    return epoch, best
