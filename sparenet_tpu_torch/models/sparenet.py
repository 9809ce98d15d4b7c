"""SpareNet generator (counterpart of sparenet_tpu/models/sparenet.py):
encode -> decode -> refine twice, in eval or train mode (``training``).

Parity mode only, ``use_adain="share"`` and ``encode="Residualnet"``; the
other decoder and encoder arms wait for a later slice. Clouds are
channel-last [B, N, 3]; primitive i owns points [i*S, (i+1)*S) of the coarse
cloud. Module and parameter names follow the original reference's net_G
state_dict.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import expansion_penalty as _expansion
from ..ops import mds as _mds
from .layers import (EdgeConvResFeat, GridDecoderStack, PointNetRes, bn_apply,
                     grid_generation, num_adain_params)

__all__ = ["SpareNetEncode", "SpareNetDecode", "SpareNetRefine",
           "SpareNetGenerator"]

_DEC_BOTTLENECK = 1026  # GridDecoder width
_EXPANSION_ALPHA = 1.5


class SpareNetEncode(nn.Module):
    """EdgeConv (Residualnet) feature extractor + bottleneck head:
    partial [B, N_in, 3] -> style [B, bottleneck_size]."""

    def __init__(self, bottleneck_size: int = 4096, hide_size: int = 4096,
                 use_selayer: bool = False):
        super().__init__()
        # the reference fixes the extractor's internal width at 4096 and
        # sets only its output width from hide_size
        self.feat_extractor = EdgeConvResFeat(
            k=8, hide_size=4096, output_size=hide_size, use_selayer=use_selayer)
        self.linear = nn.Linear(hide_size, bottleneck_size)
        self.bn = nn.BatchNorm1d(bottleneck_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(bn_apply(self.bn, self.linear(self.feat_extractor(x))))


class SpareNetDecode(nn.Module):
    """Shared-AdaIN multi-primitive folding decoder: style [B, bottleneck]
    -> coarse cloud [B, num_points, 3]. One MLP emits the AdaIN parameters
    every primitive's decoder consumes."""

    def __init__(self, num_points: int = 16384, n_primitives: int = 32,
                 bottleneck_size: int = 4096, use_selayer: bool = False):
        super().__init__()
        self.n_primitives = n_primitives
        self.mlp = nn.Sequential(
            nn.Linear(bottleneck_size, bottleneck_size),
            nn.ReLU(inplace=True),
            nn.Linear(bottleneck_size, num_adain_params(_DEC_BOTTLENECK)),
        )
        self.decoder = GridDecoderStack(n_primitives, _DEC_BOTTLENECK,
                                        use_selayer)
        grid = (grid_generation(num_points, n_primitives) - 0.5) * 2.0
        self.register_buffer("grid", torch.from_numpy(grid), persistent=False)

    def forward(self, style: torch.Tensor) -> torch.Tensor:
        out = self.decoder(self.grid, self.mlp(style))         # [P, B, S, 3]
        b = style.shape[0]
        return out.permute(1, 0, 2, 3).reshape(b, -1, 3)


def flagged_base(coarse: torch.Tensor, partial: torch.Tensor) -> torch.Tensor:
    """concat([coarse | 0], [partial | 1]) along points: [B, N + N_in, 4];
    the fourth channel flags rows that came from the partial input."""
    zeros = coarse.new_zeros(coarse.shape[:2] + (1,))
    ones = partial.new_ones(partial.shape[:2] + (1,))
    return torch.cat([torch.cat([coarse, zeros], -1),
                      torch.cat([partial, ones], -1)], 1)


class SpareNetRefine(nn.Module):
    """Expansion penalty -> MDS resample of coarse + partial -> residual
    delta. One module serves both refine passes, as in the reference."""

    def __init__(self, num_points: int = 16384, n_primitives: int = 32,
                 use_selayer: bool = False):
        super().__init__()
        self.num_points = num_points
        self.primitive_size = num_points // n_primitives
        self.residual = PointNetRes(use_selayer)

    def finish(self, base: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Gather the MDS picks idx [B, N] of base [B, N + N_in, 4] and add
        the residual net's delta: -> refined [B, N, 3]."""
        picked = _mds.gather_points(base, idx)
        return picked[..., :3] + self.residual(picked)

    def forward(self, coarse: torch.Tensor, partial: torch.Tensor):
        """coarse [B, N, 3], partial [B, N_in, 3] -> (refined, loss_mst).
        Gradient reaches coarse through the expansion penalty's backward and
        through the gathered points; the MDS picks carry none."""
        dist, _, mml = _expansion.expansion_penalty(
            coarse, self.primitive_size, _EXPANSION_ALPHA)
        base = flagged_base(coarse, partial)
        idx = _mds.minimum_density_sample(
            base[..., :3].contiguous(), self.num_points, mml)
        return self.finish(base, idx), dist.mean()


class SpareNetGenerator(nn.Module):
    """Full SpareNet: partial [B, N_in, 3] ->
    (coarse, middle, refine [B, num_points, 3], loss_mst)."""

    def __init__(self, num_points: int = 16384, n_primitives: int = 32,
                 bottleneck_size: int = 4096, hide_size: int = 4096,
                 use_selayer: bool = False, use_adain: str = "share",
                 encode: str = "Residualnet"):
        super().__init__()
        if use_adain != "share" or encode != "Residualnet":
            raise NotImplementedError(
                f"use_adain={use_adain!r}, encode={encode!r}: only 'share' "
                "with 'Residualnet' is ported so far")
        # registered but unused by the forward, as in the reference
        self.conv1 = nn.Conv1d(3, 64, 1)
        self.encoder = SpareNetEncode(bottleneck_size, hide_size, use_selayer)
        self.decoder = SpareNetDecode(num_points, n_primitives,
                                      bottleneck_size, use_selayer)
        self.refine = SpareNetRefine(num_points, n_primitives, use_selayer)

    def forward(self, partial: torch.Tensor):
        coarse = self.decoder(self.encoder(partial))
        middle, loss_mst = self.refine(coarse, partial)
        refine, _ = self.refine(middle, partial)
        return coarse, middle, refine, loss_mst
