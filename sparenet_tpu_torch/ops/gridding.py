"""Gridding and gridding reverse: trilinear point cloud <-> voxel grid
(counterpart of sparenet_tpu/ops/gridding.py: trilinear_corners, gridding,
gridding_reverse).

The JAX package runs both as XLA, not as Pallas kernels, so the port runs
them as stock PyTorch ops on either device: a scatter-add
(``index_put_(accumulate=True)``) of each point's 8 corner weights, and
shifted slices of the grid. On the card the scatter adds in the order its
atomics land, so the grid can differ from run to run in the last bits
(``torch.use_deterministic_algorithms`` makes it reproducible; an ordered
sort-and-segment-sum scatter took 5.97 ms at B=32 against its 0.32 on an
H100 at 700 W, scripts/port_grnet_scatter_bench.py, and GRNet's cuDNN
convolutions are not reproducible outside that mode either).

Grid layout: x-major, ``idx = x * s^2 + y * s + z``; reshaped to [s, s, s]
the axes are (x, y, z). The gradient reaches the points through the corner
weights only: the corner indices are integers.

A corner outside [0, s) is dropped. The JAX package's ``mode="drop"``
scatter drops those past the far face, but wraps an index in [-s, 0) to the
far face as numpy indexing does; such corners come only from points below
-1, which no cloud in [-1, 1] has, and the port drops them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["trilinear_corners", "gridding", "gridding_reverse", "CORNERS"]

# corner c of a cell: bit b selects the upper vertex on axis b, in the order
# LLL, LLU, LUL, LUU, ULL, ULU, UUL, UUU (x major)
CORNERS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
           (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))


def trilinear_corners(p: torch.Tensor):
    """Points p [..., 3] in grid units -> (corner vertices [..., 8, 3] int64,
    weights [..., 8]): the vertices floor(p) + c for each corner c of
    ``CORNERS`` and their trilinear weights prod(1 - |p - vertex|).

    With f = p - floor(p) in [0, 1) the axis weights are 1 - f and f, the
    values the JAX package's 1 - |f| and 1 - |f - 1| give (f and 1 - f are
    exact in f32 at grid coordinates); written without the absolute values
    their slopes are -1 and +1 also at f = 0, where torch's abs has slope 0
    and the JAX package's (and the reference's analytic backward) do not."""
    lower = torch.floor(p).detach()
    combos = torch.tensor(CORNERS, device=p.device)
    f = p - lower
    w_low = 1.0 - f
    w_up = f
    upper = combos.bool()
    w = torch.where(upper, w_up.unsqueeze(-2), w_low.unsqueeze(-2))
    weights = w[..., 0] * w[..., 1] * w[..., 2]
    corners = lower.long().unsqueeze(-2) + combos
    return corners, weights


def gridding(ptcloud: torch.Tensor, scale: int = 64) -> torch.Tensor:
    """Clouds [B, N, 3] with coordinates in [-1, 1] -> grids [B, s, s, s]:
    each point scaled by s // 2 scatters its 8 corner weights onto the
    vertices [-s/2, s/2 - 1] (shifted to [0, s)). A point whose coordinates
    sum to exactly 0 (the loaders' zero padding) adds nothing."""
    b = ptcloud.shape[0]
    s, half = scale, scale // 2
    p = ptcloud * half
    valid = p.sum(-1) != 0.0
    corners, weights = trilinear_corners(p)               # [B,N,8,3], [B,N,8]
    weights = weights * valid.unsqueeze(-1)
    v = corners + half
    keep = ((v >= 0) & (v < s)).all(-1)                    # [B, N, 8]
    flat = (v[..., 0] * s + v[..., 1]) * s + v[..., 2]
    flat = flat + torch.arange(b, device=p.device).view(b, 1, 1) * s ** 3
    # dropped corners go to one extra slot, cut off after the scatter (a
    # boolean selection would wait for the card to count them)
    flat = torch.where(keep, flat, torch.full_like(flat, b * s ** 3))
    grid = p.new_zeros(b * s ** 3 + 1).index_put(
        (flat.reshape(-1),), weights.reshape(-1), accumulate=True)
    return grid[:-1].view(b, s, s, s)


def gridding_reverse(grid: torch.Tensor, scale: int = 64) -> torch.Tensor:
    """Grids [B, s, s, s] -> clouds [B, s^3, 3] in [-1, 1]: voxel (x, y, z)
    gives the centroid of its cell's 8 lower vertices (x - dx, y - dy,
    z - dz), dx, dy, dz in {0, 1}, weighted by their grid values normalised
    by their sum; (0, 0, 0) where the sum is below 1e-6 or where x, y or z
    is 0; scaled by 2 / s. The JAX package's order of operations: the
    weights normalised first, then the three weighted sums."""
    eps = 1e-6
    b = grid.shape[0]
    s, half = scale, scale // 2
    gp = F.pad(grid, (1, 0, 1, 0, 1, 0))       # gp[x] = grid[x - 1]
    # corner order (x-1, y-1, z-1), (x-1, y-1, z), ..., (x, y, z)
    deltas = [(dx, dy, dz) for dx in (1, 0) for dy in (1, 0) for dz in (1, 0)]
    w = torch.stack([gp[:, 1 - dx:s + 1 - dx, 1 - dy:s + 1 - dy,
                        1 - dz:s + 1 - dz] for dx, dy, dz in deltas], -1)
    wsum = w.sum(-1, keepdim=True)                             # [B,s,s,s,1]
    wn = w / torch.where(wsum < eps, torch.ones_like(wsum), wsum)
    ax = torch.arange(s, device=grid.device, dtype=grid.dtype) - half
    d = torch.tensor(deltas, device=grid.device, dtype=grid.dtype)  # [8, 3]
    px = (wn * (ax.view(s, 1, 1, 1) - d[:, 0])).sum(-1)
    py = (wn * (ax.view(1, s, 1, 1) - d[:, 1])).sum(-1)
    pz = (wn * (ax.view(1, 1, s, 1) - d[:, 2])).sum(-1)
    pts = torch.stack([px, py, pz], -1)                        # [B,s,s,s,3]
    inner = torch.arange(s, device=grid.device) > 0
    interior = (inner.view(s, 1, 1) & inner.view(1, s, 1)
                & inner.view(1, 1, s))
    keep = interior.unsqueeze(-1) & (wsum >= eps)
    pts = torch.where(keep, pts, torch.zeros_like(pts))
    return pts.reshape(b, s ** 3, 3) * (2.0 / s)
