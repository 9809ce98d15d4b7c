"""MSN (counterpart of sparenet_tpu/models/msn.py): AtlasNet's encoder and
folding decoders, then the expansion penalty, an MDS resample of coarse +
partial and a residual refiner (``sparenet.Resampler``, the refine step
SpareNet runs twice, here once).

forward(partial, grids=None, generator=None) -> (coarse, refine
[B, num_points, 3], loss_mst), the grids as AtlasNet takes them. Parity
mode by default; ``serving=True`` is the reference's serving mode in eval:
the decoders' and the refiner's bf16 chains, the NN-mean mml estimate at
``mml_calibration`` (5.65, the JAX package's fit on trained MSN), the MDS
arm ``mds`` and loss_mst 0. ``train_mds`` puts the training forward's MDS on
the batched arm (the JAX package's serving-aligned training). Reference keys
as AtlasNet's, with the residual net under ``res``.
"""

from __future__ import annotations

import torch

from ..ops import mds as _mds
from .atlasnet import AtlasNet
from .layers import PointNetRes
from .sparenet import Resampler

__all__ = ["MSN", "MSN_MML_CALIBRATION"]

# the family's serving mml ratio, the reference's trained-weights fit
# (sparenet_tpu/models/msn.py: MSN.mml_calibration)
MSN_MML_CALIBRATION = 5.65


class MSN(Resampler, AtlasNet):
    """AtlasNet + ``Resampler`` with its residual net ``res``; the model is
    its own ``resampler``."""

    def __init__(self, num_points: int = 16384, bottleneck_size: int = 1024,
                 n_primitives: int = 32, serving: bool = False,
                 mds: str = "auto",
                 mml_calibration: float = MSN_MML_CALIBRATION,
                 mds_g: int = _mds.BATCH_G, mds_schedule=_mds.SCHEDULE,
                 mds_tail: int = _mds.TAIL, train_mds: str = "exact",
                 select: str = "sort"):
        AtlasNet.__init__(self, num_points, bottleneck_size, n_primitives,
                          serving)
        self.init_resampler(num_points, n_primitives, serving, mds,
                            mml_calibration, mds_g, mds_schedule, mds_tail,
                            train_mds, select)
        self.res = PointNetRes(False, serving)

    @property
    def resampler(self) -> "MSN":
        return self

    def delta(self, base: torch.Tensor) -> torch.Tensor:
        return self.res(base)

    def forward(self, partial: torch.Tensor, grids=None,
                generator: torch.Generator | None = None):
        coarse = self.coarse_cloud(partial, grids, generator)
        refine, loss_mst = self.resample_refine(coarse, partial)
        return coarse, refine, loss_mst
