"""AtlasNet (counterpart of sparenet_tpu/models/atlasnet.py): a PointNet
encoder and 32 folding decoders without AdaIN over random 2D grids.

The grids [P, B, S, 2], uniform in [0, 1), are either passed (``grids``) or
drawn on the CPU from a ``torch.Generator`` the caller owns (``generator``),
never from torch's global RNG, and moved to the model's device: a generator
state gives the same grids on every device. The JAX package draws them from
its 'grid' PRNG stream, which torch cannot reproduce, so tests pass
``grids``. Module and parameter names follow the original reference's
AtlasNet state_dict (``encoder.*``, ``decoder.{p}.*`` stacked: see
``layers.PointGenConStack``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (PointGenConStack, PointNetfeat, bn_apply, product_bf16,
                     serving_dtype)

__all__ = ["PointEncoder", "AtlasNet"]


class PointEncoder(nn.Module):
    """PointNetfeat and a Linear/BatchNorm/ReLU bottleneck: partial
    [B, N_in, 3] -> style [B, bottleneck_size]."""

    def __init__(self, bottleneck_size: int = 1024, hide_size: int = 1024,
                 serving: bool = False):
        super().__init__()
        self.serving = serving
        self.feat_extractor = PointNetfeat(hide_size, serving)
        self.linear = nn.Linear(hide_size, bottleneck_size)
        self.bn = nn.BatchNorm1d(bottleneck_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = product_bf16(self.feat_extractor(x), self.linear.weight,
                         self.linear.bias, on=serving_dtype(self) is not None)
        return F.relu(bn_apply(self.bn, y))


class AtlasNet(nn.Module):
    """partial [B, N_in, 3] -> completion [B, num_points, 3]: primitive i
    owns points [i*S, (i+1)*S). ``serving`` runs the decoders' bf16 chain
    in eval mode (AtlasNet has no MDS)."""

    def __init__(self, num_points: int = 16384, bottleneck_size: int = 1024,
                 n_primitives: int = 32, serving: bool = False):
        super().__init__()
        self.num_points = num_points
        self.n_primitives = n_primitives
        self.primitive_size = num_points // n_primitives
        self.serving = serving
        self.encoder = PointEncoder(bottleneck_size, 1024, serving)
        self.decoder = PointGenConStack(n_primitives, 2 + bottleneck_size,
                                        serving)

    # AtlasNet has no MDS temperature to calibrate
    resampler = None

    def draw_grids(self, batch: int, generator: torch.Generator) -> torch.Tensor:
        """[P, B, S, 2] uniform in [0, 1), drawn on the CPU from
        ``generator`` and moved to the model's device."""
        if generator is None:
            raise ValueError("pass grids or a torch.Generator to draw them "
                             "from (the model never uses torch's global RNG)")
        g = torch.rand((self.n_primitives, batch, self.primitive_size, 2),
                       generator=generator)
        return g.to(next(self.parameters()).device)

    def coarse_cloud(self, partial: torch.Tensor, grids=None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """partial [B, N_in, 3] -> the folded cloud [B, num_points, 3] on
        ``grids`` [P, B, S, 2], or on grids drawn from ``generator``."""
        b = partial.shape[0]
        want = (self.n_primitives, b, self.primitive_size, 2)
        if grids is None:
            grids = self.draw_grids(b, generator)
        elif tuple(grids.shape) != want:
            raise ValueError(f"grids must be {list(want)}, got "
                             f"{list(grids.shape)}")
        out = self.decoder(grids.to(partial.dtype), self.encoder(partial))
        return out.permute(1, 0, 2, 3).reshape(b, self.num_points, 3)

    def forward(self, partial: torch.Tensor, grids=None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.coarse_cloud(partial, grids, generator)
