"""SpareNet generator (counterpart of sparenet_tpu/models/sparenet.py):
encode -> decode -> refine twice, in eval or train mode (``training``).

Parity mode by default; ``serving=True`` is the reference's serving mode
(``SPARENET_FAST_MATH=1`` in eval, as ``bench.py`` runs it): packed-key kNN
graphs, bf16 activation chains (models/layers.py), the NN-mean mml estimate
in place of the expansion penalty (``loss_mst`` = 0), and the MDS arm
``mds`` ("auto" = "exact" as off the TPU, "batched" or "hybrid"; ops/mds.py)
returning its selected rows, the flag channel being index math; the batched
rounds pick by the selection arm ``select`` ("sort", "bisect", "topk" or
"pack16"; ops/mds.py:select_smallest). Serving applies in
eval mode only; a serving model in train mode runs the parity training
path, as in the reference. ``train_mds`` is the MDS arm of the training
forward: "exact" (greedy MDS, the reference's), or "batched" as the JAX
package's serving-aligned training (``TRAIN.serving_aligned``,
``define_G(train=True)``); eval forwards keep exact greedy MDS.

Every arm of the JAX package's generator: the encoder ``encode``
("Residualnet", the EdgeConv extractor, or "Pointfeat", PointNetfeat with
SE), the decoder ``use_adain`` ("share": one style MLP for every primitive;
"no_share": each primitive's own; "no_use": the style concatenated onto the
grid, no AdaIN), and the refine's residual net (``edgeres``: EdgeRes, which
no shipped config sets, in place of PointNetRes). ``remat`` (the config's
TPU.remat) recomputes the encoder, the decoder and each refine pass's
residual net in the backward instead of keeping their activations
(``torch.utils.checkpoint``, non-reentrant), in training with gradients
only; the expansion penalty and MDS stay outside, and the replay leaves the
BatchNorm running statistics as the forward set them. Clouds are
channel-last [B, N, 3]; primitive i owns points [i*S, (i+1)*S) of the
coarse cloud. Module and parameter names follow the original reference's
net_G state_dict.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _checkpoint

from ..ops import expansion_penalty as _expansion
from ..ops import mds as _mds
from .layers import (AdaInGridDecoderStack, EdgeConvResFeat, EdgeRes,
                     GridDecoderStack, PointGenConStack, PointNetfeat,
                     PointNetRes, bn_apply, grid_generation, num_adain_params,
                     product_bf16, recomputing, serving_dtype)

__all__ = ["SpareNetEncode", "SpareNetDecode", "Resampler", "SpareNetRefine",
           "SpareNetGenerator", "flagged_base", "rematerialised",
           "MML_CALIBRATION", "ENCODERS", "DECODERS"]

_DEC_BOTTLENECK = 1026  # GridDecoder width
# the family's serving mml ratio, the reference's trained-weights fit
# (sparenet_tpu/models/sparenet.py: SpareNetRefine.mml_calibration)
MML_CALIBRATION = 1.33
_EXPANSION_ALPHA = 1.5
ENCODERS = ("Residualnet", "Pointfeat")
DECODERS = ("share", "no_share", "no_use")


def rematerialised(fn, *args):
    """fn(*args) under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward, the recompute inside
    ``layers.recomputing`` (no second running-statistics update)."""
    return _checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recomputing()))


class SpareNetEncode(nn.Module):
    """Feature extractor (``encode``: EdgeConv "Residualnet" or PointNet
    "Pointfeat") + bottleneck head: partial [B, N_in, 3] -> style
    [B, bottleneck_size]."""

    def __init__(self, bottleneck_size: int = 4096, hide_size: int = 4096,
                 use_selayer: bool = False, serving: bool = False,
                 encode: str = "Residualnet"):
        super().__init__()
        self.serving = serving
        if encode == "Residualnet":
            # the reference fixes the extractor's internal width at 4096 and
            # sets only its output width from hide_size
            self.feat_extractor = EdgeConvResFeat(
                k=8, hide_size=4096, output_size=hide_size,
                use_selayer=use_selayer, serving=serving)
        elif encode == "Pointfeat":
            self.feat_extractor = PointNetfeat(hide_size, serving, use_selayer)
        else:
            raise ValueError(f"unknown encode {encode!r}: one of {ENCODERS}")
        self.linear = nn.Linear(hide_size, bottleneck_size)
        self.bn = nn.BatchNorm1d(bottleneck_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = product_bf16(self.feat_extractor(x), self.linear.weight,
                         self.linear.bias, on=serving_dtype(self) is not None)
        return F.relu(bn_apply(self.bn, y))


class SpareNetDecode(nn.Module):
    """Style-based multi-primitive folding decoder: style [B, bottleneck]
    -> coarse cloud [B, num_points, 3]. ``use_adain``: "share" (one MLP
    emits the AdaIN parameters every primitive's decoder consumes),
    "no_share" (each primitive's own MLP, ``AdaInGridDecoderStack``) or
    "no_use" (PointGenCon decoders over concat(grid, style), no AdaIN)."""

    def __init__(self, num_points: int = 16384, n_primitives: int = 32,
                 bottleneck_size: int = 4096, use_selayer: bool = False,
                 serving: bool = False, use_adain: str = "share"):
        super().__init__()
        self.n_primitives = n_primitives
        self.serving = serving
        self.use_adain = use_adain
        if use_adain == "share":
            self.mlp = nn.Sequential(
                nn.Linear(bottleneck_size, bottleneck_size),
                nn.ReLU(inplace=True),
                nn.Linear(bottleneck_size, num_adain_params(_DEC_BOTTLENECK)),
            )
            self.decoder = GridDecoderStack(n_primitives, _DEC_BOTTLENECK,
                                            use_selayer, serving)
        elif use_adain == "no_share":
            self.decoder = AdaInGridDecoderStack(
                n_primitives, bottleneck_size, _DEC_BOTTLENECK, use_selayer,
                serving)
        elif use_adain == "no_use":
            self.decoder = PointGenConStack(
                n_primitives, _DEC_BOTTLENECK, serving,
                input_size=2 + bottleneck_size, use_selayer=use_selayer)
        else:
            raise ValueError(f"unknown use_adain {use_adain!r}: one of "
                             f"{DECODERS}")
        grid = (grid_generation(num_points, n_primitives) - 0.5) * 2.0
        self.register_buffer("grid", torch.from_numpy(grid), persistent=False)

    def _style(self, style: torch.Tensor) -> torch.Tensor:
        if serving_dtype(self) is None:
            return self.mlp(style)
        l1, l2 = self.mlp[0], self.mlp[2]
        h = F.relu(product_bf16(style, l1.weight, l1.bias))
        return product_bf16(h, l2.weight, l2.bias)

    def forward(self, style: torch.Tensor) -> torch.Tensor:
        b = style.shape[0]
        if self.use_adain == "share":
            out = self.decoder(self.grid, self._style(style))  # [P, B, S, 3]
        elif self.use_adain == "no_share":
            out = self.decoder(self.grid, style)
        else:
            grids = self.grid.expand(self.n_primitives, b, *self.grid.shape)
            out = self.decoder(grids, style)
        return out.permute(1, 0, 2, 3).reshape(b, -1, 3)


def flagged_base(coarse: torch.Tensor, partial: torch.Tensor) -> torch.Tensor:
    """concat([coarse | 0], [partial | 1]) along points: [B, N + N_in, 4];
    the fourth channel flags rows that came from the partial input."""
    zeros = coarse.new_zeros(coarse.shape[:2] + (1,))
    ones = partial.new_ones(partial.shape[:2] + (1,))
    return torch.cat([torch.cat([coarse, zeros], -1),
                      torch.cat([partial, ones], -1)], 1)


class Resampler:
    """The resample-and-refine step of SpareNet's refine passes and MSN,
    as a mixin of those modules: expansion penalty -> MDS resample of coarse
    + partial -> a residual delta (the subclass's ``delta``).

    Serving branch (eval with ``serving``; the reference's
    models/sparenet.py:203-227 and models/msn.py:71-90): mml from the
    NN-mean estimate times ``mml_calibration`` (the family's trained-weights
    fit; ``utils.calibration.autocalibrate_mml`` fits it to a model),
    loss_mst 0, the MDS arm ``mds`` with its selected rows (G, schedule,
    tail and the rounds' selection arm as ``mds_g``, ``mds_schedule``,
    ``mds_tail``, ``select``), the flag channel idx >= N. A batched
    training arm (``train_mds``) takes the same G, schedule and selection
    arm. A module with this mixin is its model's ``resampler``: the
    calibration reads ``primitive_size`` and sets ``mml_calibration``
    there."""

    def init_resampler(self, num_points: int, n_primitives: int,
                       serving: bool, mds: str, mml_calibration: float,
                       mds_g: int, mds_schedule, mds_tail: int,
                       train_mds: str, select: str) -> None:
        self.num_points = num_points
        self.primitive_size = num_points // n_primitives
        self.serving = serving
        self.mds = _mds.resolve_impl(mds, serving)
        self.train_mds = _mds.resolve_impl(train_mds)
        self.mml_calibration = mml_calibration
        self.mds_g, self.mds_schedule, self.mds_tail = (
            mds_g, tuple(mds_schedule), mds_tail)
        self.select = _mds.check_select(select)

    def delta(self, base: torch.Tensor) -> torch.Tensor:
        """The residual net: base [B, N, 4] -> delta [B, N, 3]."""
        raise NotImplementedError

    def finish(self, base: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Gather the MDS picks idx [B, N] of base [B, N + N_in, 4] and add
        the residual net's delta: -> refined [B, N, 3]."""
        picked = _mds.gather_points(base, idx)
        return picked[..., :3] + self.delta(picked)

    def resample_refine(self, coarse: torch.Tensor, partial: torch.Tensor):
        """coarse [B, N, 3], partial [B, N_in, 3] -> (refined, loss_mst).
        Gradient reaches coarse through the expansion penalty's backward and
        through the gathered points; the MDS picks carry none."""
        if self.serving and not self.training:
            return self.serve(coarse, partial)
        dist, _, mml = _expansion.expansion_penalty(
            coarse, self.primitive_size, _EXPANSION_ALPHA)
        base = flagged_base(coarse, partial)
        xyz = base[..., :3].contiguous()
        if self.training and self.train_mds != "exact":
            idx, _ = _mds.minimum_density_sample_xyz(
                xyz, self.num_points, mml, self.train_mds, g=self.mds_g,
                schedule=self.mds_schedule, tail=self.mds_tail,
                select=self.select)
        else:
            idx = _mds.minimum_density_sample(xyz, self.num_points, mml)
        return self.finish(base, idx), dist.mean()

    def serve(self, coarse: torch.Tensor, partial: torch.Tensor):
        """The serving branch: (refined [B, N, 3], loss_mst = 0)."""
        n = coarse.shape[1]
        mml = _expansion.mean_mst_length_estimate(
            coarse, self.primitive_size, self.mml_calibration)
        idx, sel = _mds.minimum_density_sample_xyz(
            torch.cat([coarse, partial], 1), n, mml, self.mds, g=self.mds_g,
            schedule=self.mds_schedule, tail=self.mds_tail,
            select=self.select)
        base = torch.cat([sel, (idx >= n).to(sel.dtype)[..., None]], -1)
        return base[..., :3] + self.delta(base), coarse.new_zeros(())


class SpareNetRefine(Resampler, nn.Module):
    """Expansion penalty -> MDS resample of coarse + partial -> residual
    delta (``Resampler``, its residual net ``residual``: PointNetRes, or
    EdgeRes with ``edgeres``). One module serves both refine passes, as in
    the reference; ``mml_calibration`` defaults to 1.33, the reference's
    trained-weights fit. ``remat``: the residual net is recomputed in the
    backward (training with gradients only)."""

    def __init__(self, num_points: int = 16384, n_primitives: int = 32,
                 use_selayer: bool = False, serving: bool = False,
                 mds: str = "auto", mml_calibration: float = MML_CALIBRATION,
                 mds_g: int = _mds.BATCH_G, mds_schedule=_mds.SCHEDULE,
                 mds_tail: int = _mds.TAIL, train_mds: str = "exact",
                 select: str = "sort", edgeres: bool = False,
                 remat: bool = False):
        nn.Module.__init__(self)
        self.init_resampler(num_points, n_primitives, serving, mds,
                            mml_calibration, mds_g, mds_schedule, mds_tail,
                            train_mds, select)
        self.remat = remat
        self.residual = (EdgeRes if edgeres else PointNetRes)(use_selayer,
                                                              serving)

    def delta(self, base: torch.Tensor) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return rematerialised(self.residual, base)
        return self.residual(base)

    def forward(self, coarse: torch.Tensor, partial: torch.Tensor):
        return self.resample_refine(coarse, partial)


class SpareNetGenerator(nn.Module):
    """Full SpareNet: partial [B, N_in, 3] ->
    (coarse, middle, refine [B, num_points, 3], loss_mst); the arms
    ``encode``, ``use_adain``, ``edgeres`` and ``remat`` as the module
    docstring says."""

    def __init__(self, num_points: int = 16384, n_primitives: int = 32,
                 bottleneck_size: int = 4096, hide_size: int = 4096,
                 use_selayer: bool = False, use_adain: str = "share",
                 encode: str = "Residualnet", serving: bool = False,
                 mds: str = "auto", mml_calibration: float = MML_CALIBRATION,
                 mds_g: int = _mds.BATCH_G, mds_schedule=_mds.SCHEDULE,
                 mds_tail: int = _mds.TAIL, train_mds: str = "exact",
                 select: str = "sort", edgeres: bool = False,
                 remat: bool = False):
        super().__init__()
        # registered but unused by the forward, as in the reference
        self.conv1 = nn.Conv1d(3, 64, 1)
        self.serving = serving
        self.remat = remat
        self.encoder = SpareNetEncode(bottleneck_size, hide_size, use_selayer,
                                      serving, encode)
        self.decoder = SpareNetDecode(num_points, n_primitives,
                                      bottleneck_size, use_selayer, serving,
                                      use_adain)
        self.refine = SpareNetRefine(
            num_points, n_primitives, use_selayer, serving, mds,
            mml_calibration, mds_g, mds_schedule, mds_tail, train_mds, select,
            edgeres, remat)

    @property
    def resampler(self) -> SpareNetRefine:
        return self.refine

    def coarse_cloud(self, partial: torch.Tensor,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """partial [B, N_in, 3] -> the coarse cloud [B, num_points, 3]
        (``generator`` is unused: SpareNet's folding grid is fixed)."""
        if self.remat and self.training and torch.is_grad_enabled():
            return rematerialised(self.decoder,
                                  rematerialised(self.encoder, partial))
        return self.decoder(self.encoder(partial))

    def forward(self, partial: torch.Tensor):
        coarse = self.coarse_cloud(partial)
        middle, loss_mst = self.refine(coarse, partial)
        refine, _ = self.refine(middle, partial)
        return coarse, middle, refine, loss_mst
