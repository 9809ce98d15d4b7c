"""Serving-mode mml calibration (counterpart of
sparenet_tpu/utils/calibration.py and of BaseRunner._maybe_autocalibrate_mml).

Serving mode replaces the exact Prim's mean MST edge length (the MDS density
temperature t = 5 mml^2) by calibration x the per-primitive mean
nearest-neighbour distance (``ops.expansion_penalty.
mean_mst_length_estimate``). The ratio depends on the coarse cloud's
distribution, so it is fitted on the model's own coarse output:
``fit_mml_ratio`` runs the exact Prim's once (the expansion kernel on the
card) and ``autocalibrate_mml`` fits it on a built generator's coarse
output and sets it there if it lies inside ``BAND``. The runners fit at
checkpoint load in serving mode (``runners.base.BaseRunner.
autocalibrate_mml``). A model exposes what the fit needs the same way in
every family that has the knob (SpareNet, MSN): ``coarse_cloud(partial,
generator=)`` and its ``resampler``, which holds ``primitive_size`` and
``mml_calibration``; MSN's grids come from a generator seeded 0, as the JAX
package's fit draws them from PRNGKey(0).
"""

from __future__ import annotations

import math

import torch

from ..ops.expansion_penalty import expansion_penalty, mean_mst_length_estimate

__all__ = ["fit_mml_ratio", "autocalibrate_mml", "BAND"]

# the plausible ratios (the JAX package's _maybe_autocalibrate_mml): fits
# span about 1.1 (converged SpareNet) to 5.7 (MSN); a collapsed coarse cloud
# gives about 0 and non-finite activations NaN, which would zero or poison
# the MDS temperature t = 5 mml^2
BAND = (0.05, 50.0)


@torch.no_grad()
def fit_mml_ratio(coarse: torch.Tensor, primitive_size: int) -> torch.Tensor:
    """coarse [B, N, 3] -> scalar: mean over the batch of Prim's mml over
    the NN-mean estimate (calibration 1)."""
    coarse = coarse.detach()
    _, _, mml = expansion_penalty(coarse, primitive_size, 1.5)
    nn_mean = mean_mst_length_estimate(coarse, primitive_size, calibration=1.0)
    return (mml / nn_mean.clamp_min(1e-12)).mean()


@torch.no_grad()
def autocalibrate_mml(model, partial: torch.Tensor) -> tuple[float, bool]:
    """Fit the ratio on ``model``'s coarse output (eval mode, in the mode it
    was built with) for one batch of partial clouds [B, N_in, 3], moved to
    the model's device, and set it as the model's serving calibration if it
    is finite and inside ``BAND``: (the fitted ratio, whether it was set)."""
    resampler = model.resampler
    if resampler is None:
        raise ValueError(f"{type(model).__name__} has no mml calibration")
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    try:
        x = partial.to(device=dev, dtype=torch.float32).contiguous()
        coarse = model.coarse_cloud(x, generator=torch.Generator().manual_seed(0))
        ratio = float(fit_mml_ratio(coarse, resampler.primitive_size))
    finally:
        model.train(was_training)
    fitted = math.isfinite(ratio) and BAND[0] <= ratio <= BAND[1]
    if fitted:
        resampler.mml_calibration = ratio
    return ratio, fitted
