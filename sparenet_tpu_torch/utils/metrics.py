"""Evaluation metrics: F-Score, Chamfer Distance, EMD (the port's copy of
sparenet_tpu/utils/metrics.py).

Units are the reference's (utils/misc.py:133-260):
  - F-Score@0.01 (higher better), from euclidean nearest-neighbour distances;
  - ChamferDistance: (mean d1 + mean d2) * 1000 (lower better);
  - EMD: mean(sqrt(dist)) * 100 at eps 0.005 and 50 rounds (lower better);
    the final-test protocol is eps 0.002 and 10000 rounds.

Each runs on the tensors' device: the nearest neighbours come from
``ops.chamfer.chamfer_raw`` (the chamfer NN kernel on the card), the EMD
from ``ops.emd.emd_auction`` (the auction's bids kernel on the card). The
square roots are correctly rounded f32 roots on either device
(``ops.common.sqrt_ieee``; PyTorch's f32 CPU root is not), so the
F-Score's threshold test sees the JAX package's values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.chamfer import chamfer_raw
from ..ops.common import sqrt_ieee
from ..ops.emd import emd_auction

__all__ = ["NAMES", "f_score", "chamfer_metric", "emd_metric", "compute_all",
           "Metrics"]

NAMES = ["F-Score", "ChamferDistance", "EMD"]
_INIT = {"F-Score": 0.0, "ChamferDistance": 32767.0, "EMD": 32767.0}
_GREATER_BETTER = {"F-Score": True, "ChamferDistance": False, "EMD": False}


def _f_score(d1: torch.Tensor, d2: torch.Tensor, th: float) -> torch.Tensor:
    th = torch.tensor(th, dtype=torch.float32, device=d1.device)
    precision = (sqrt_ieee(d1) < th).float().mean(-1)
    recall = (sqrt_ieee(d2) < th).float().mean(-1)
    denom = precision + recall
    return torch.where(denom > 0,
                       2 * precision * recall / denom.clamp_min(1e-12),
                       torch.zeros_like(denom))


def _chamfer(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    return (d1.mean(-1) + d2.mean(-1)) * 1000.0


@torch.no_grad()
def f_score(pred: torch.Tensor, gt: torch.Tensor, th: float = 0.01) -> torch.Tensor:
    """Per-sample F-Score at distance threshold th [B]."""
    d1, d2, _, _ = chamfer_raw(pred, gt)
    return _f_score(d1, d2, th)


@torch.no_grad()
def chamfer_metric(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-sample (mean d1 + mean d2) * 1000 [B]."""
    d1, d2, _, _ = chamfer_raw(pred, gt)
    return _chamfer(d1, d2)


@torch.no_grad()
def emd_metric(pred: torch.Tensor, gt: torch.Tensor, eps: float = 0.005,
               iters: int = 50) -> torch.Tensor:
    """Per-sample mean(sqrt(dist)) * 100 [B]."""
    dist, _ = emd_auction(pred, gt, eps, iters)
    return sqrt_ieee(dist).mean(-1) * 100.0


@torch.no_grad()
def compute_all(pred: torch.Tensor, gt: torch.Tensor, eps: float = 0.005,
                iters: int = 50) -> np.ndarray:
    """[F-Score, CD, EMD] per sample, as numpy [3, B]. F-Score and CD share
    one nearest-neighbour search (the same distances their functions
    compute each)."""
    d1, d2, _, _ = chamfer_raw(pred, gt)
    return np.stack([
        _f_score(d1, d2, 0.01).cpu().numpy(),
        _chamfer(d1, d2).cpu().numpy(),
        emd_metric(pred, gt, eps, iters).cpu().numpy(),
    ])


class Metrics:
    """Value container with the reference comparison protocol
    (utils/misc.py:213-260)."""

    def __init__(self, metric_name: str, values):
        self.metric_name = metric_name
        if isinstance(values, dict):
            self._values = [values.get(n, _INIT[n]) for n in NAMES]
        else:
            self._values = list(values)

    @classmethod
    def names(cls):
        return list(NAMES)

    def state_dict(self):
        return dict(zip(NAMES, self._values))

    def __repr__(self):
        return str(self.state_dict())

    def better_than(self, other) -> bool:
        if other is None:
            return True
        idx = NAMES.index(self.metric_name)
        a, b = self._values[idx], other._values[idx]
        return a > b if _GREATER_BETTER[self.metric_name] else a < b
