"""Cubic feature sampling: a volume's features at the 8 vertices around
each point (counterpart of sparenet_tpu/ops/cubic_feature_sampling.py).

The JAX package runs it as an XLA gather, not as a Pallas kernel, so the
port gathers with stock PyTorch ops on either device. Its volumes are the
reference's channel-first [B, C, s, s, s] (the JAX package's are
channel-last); the output is the JAX package's [B, N, 8, C], corner-major
(x, then y, then z) and channel-minor, the order GRNet's fc11 reads after
the flatten to [B, N, 8 C]. Vertices outside the grid give zeros. The
gradient reaches the volume only, as in the reference's CUDA op: the points
enter through integer vertex indices. On the card that gradient is an
atomic scatter-add (``index_select``'s backward), reproducible under
``torch.use_deterministic_algorithms``.
"""

from __future__ import annotations

import torch

__all__ = ["cubic_feature_sampling"]


def cubic_feature_sampling(ptcloud: torch.Tensor,
                           cubic_features: torch.Tensor) -> torch.Tensor:
    """ptcloud [B, N, 3] in [-1, 1], cubic_features [B, C, s, s, s] (axes
    x, y, z) -> [B, N, 8, C]: the points scaled by s/2 and shifted by s/2,
    the vertices floor(p) + (dx, dy, dz) for dx, dy, dz in {0, 1} (the
    reference's neighbourhood size 1)."""
    b, n, _ = ptcloud.shape
    c, s = cubic_features.shape[1], cubic_features.shape[-1]
    half = s / 2.0
    lower = torch.floor(ptcloud * half + half).detach().long()      # [B,N,3]
    offs = torch.arange(2, device=ptcloud.device)
    gx = (lower[..., 0:1] + offs).view(b, n, 2, 1, 1).expand(b, n, 2, 2, 2)
    gy = (lower[..., 1:2] + offs).view(b, n, 1, 2, 1).expand(b, n, 2, 2, 2)
    gz = (lower[..., 2:3] + offs).view(b, n, 1, 1, 2).expand(b, n, 2, 2, 2)
    inside = ((gx >= 0) & (gx < s) & (gy >= 0) & (gy < s) & (gz >= 0)
              & (gz < s)).reshape(b, n * 8)
    flat = ((gx.clamp(0, s - 1) * s + gy.clamp(0, s - 1)) * s
            + gz.clamp(0, s - 1)).reshape(b, n * 8)
    flat = flat + torch.arange(b, device=ptcloud.device).view(b, 1) * s ** 3
    # channel-last rows [B s^3, C], one row gathered a vertex
    rows = cubic_features.reshape(b, c, s ** 3).transpose(1, 2).reshape(
        b * s ** 3, c)
    feats = rows.index_select(0, flat.reshape(-1)).view(b, n * 8, c)
    feats = feats * inside.unsqueeze(-1).to(feats.dtype)
    return feats.view(b, n, 8, c)
