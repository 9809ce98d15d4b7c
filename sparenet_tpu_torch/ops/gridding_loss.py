"""Gridding distance and the gridding loss: a multi-scale L1 distance of two
clouds' voxel slot grids (counterpart of sparenet_tpu/ops/gridding_loss.py:
_rasterize_slots, gridding_distance, gridding_loss and GriddingLoss).

Both clouds are rasterised onto a grid of per-corner slots (vertex * 8 +
corner) spanning [-s/2 - 2, s/2 + 2] on each axis, which holds the
reference's dynamic joint bounding box for clouds in [-1, 1]; vertices
outside that box receive no mass from either cloud, so the L1 sum equals
the reference's, and its mean divides by the reference's dynamic vertex
count. Stock PyTorch ops, as the JAX package's are XLA. The reference
configures the loss but no runner uses it, in the JAX package or here.
"""

from __future__ import annotations

import torch

from .gridding import trilinear_corners

__all__ = ["gridding_distance", "gridding_loss", "GriddingLoss"]


def _rasterize_slots(p: torch.Tensor, lo: int, length: int) -> torch.Tensor:
    """Clouds [B, N, 3] in grid units -> slot grids [B, length^3, 8]: each
    point's corner c adds its trilinear weight to slot c of its vertex;
    points whose coordinates sum to 0 add nothing, corners off the grid are
    dropped."""
    b = p.shape[0]
    valid = p.sum(-1) != 0.0
    corners, weights = trilinear_corners(p)                # [B,N,8,3], [B,N,8]
    weights = weights * valid.unsqueeze(-1)
    offs = corners - lo
    inside = ((offs >= 0) & (offs < length)).all(-1)
    cells = length ** 3 * 8
    flat = ((offs[..., 0] * length + offs[..., 1]) * length
            + offs[..., 2]) * 8 + torch.arange(8, device=p.device)
    flat = flat + torch.arange(b, device=p.device).view(b, 1, 1) * cells
    flat = torch.where(inside, flat, torch.full_like(flat, b * cells))
    grid = p.new_zeros(b * cells + 1).index_put(
        (flat.reshape(-1),), weights.reshape(-1), accumulate=True)
    return grid[:-1].view(b, length ** 3, 8)


def gridding_distance(pred_cloud: torch.Tensor, gt_cloud: torch.Tensor,
                      scale: int):
    """(pred_grid, gt_grid, n_vertices): the two slot grids [B, L^3, 8] on
    the static box, L = scale + 5, and the vertex count of the reference's
    dynamic grid over the union of both clouds (per axis (ceil(max) + 1) -
    (floor(min) - 1) + 1)."""
    half = scale / 2.0
    p, g = pred_cloud * half, gt_cloud * half
    lo, length = -(scale // 2) - 2, scale + 5
    both = torch.cat([p, g], 1).reshape(-1, 3)
    mn = torch.floor(both.min(0).values) - 1.0
    mx = torch.ceil(both.max(0).values) + 1.0
    lens = mx - mn + 1.0
    n_vertices = lens[0] * lens[1] * lens[2]
    return (_rasterize_slots(p, lo, length), _rasterize_slots(g, lo, length),
            n_vertices)


def gridding_loss(pred_cloud: torch.Tensor, gt_cloud: torch.Tensor, scales,
                  alphas) -> torch.Tensor:
    """sum over the scales of alpha * L1(pred_grid, gt_grid), the L1 mean
    taken over B * n_vertices * 8 slots."""
    total = pred_cloud.new_zeros(())
    for scale, alpha in zip(scales, alphas):
        pred_grid, gt_grid, n_vertices = gridding_distance(pred_cloud,
                                                           gt_cloud, scale)
        l1_sum = (pred_grid - gt_grid).abs().sum()
        total = total + alpha * l1_sum / (pred_grid.shape[0] * n_vertices
                                          * 8.0)
    return total


class GriddingLoss:
    """The reference module's interface: ``GriddingLoss(scales, alphas)
    (pred, gt)``."""

    def __init__(self, scales=(), alphas=()):
        self.scales = tuple(scales)
        self.alphas = tuple(alphas)

    def __call__(self, pred_cloud, gt_cloud):
        return gridding_loss(pred_cloud, gt_cloud, self.scales, self.alphas)
