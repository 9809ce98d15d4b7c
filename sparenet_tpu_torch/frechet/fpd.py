"""Frechet Pointcloud Distance (counterpart of sparenet_tpu/frechet/fpd.py).

Activations from the PointNet classifier's 1808-d concat layer, their
Gaussian statistics and the Frechet distance with scipy's ``sqrtm``. The
forward runs on the card (``device=None``) unless the caller passes
``device="cpu"``; the statistics and ``sqrtm`` stay on the host in float64,
as the JAX package splits them.

Classifier weights (``weights``) are a ``PointNetCls``, a state_dict in the
reference's names (``utils.weights.fpd_state_dict_from_jax`` converts the
JAX package's), or a path: an ``.npz`` of such a state_dict (the port's
canonical classifier, ``CANONICAL``) or the reference's ``.pth``.
"""

from __future__ import annotations

import os
from collections.abc import Mapping

import numpy as np
import torch

from ..models import resolve_device, set_parity_mode
from .pointnet import ACTIVATION_DIMS, PointNetCls

__all__ = ["CANONICAL", "load_classifier", "get_activations",
           "calculate_activation_statistics", "calculate_frechet_distance",
           "calculate_fpd"]

# the JAX package's canonical classifier (scripts/fpd_canonical.py), its
# variables carried into the reference's names (docs/FPD_ARTIFACT.md)
CANONICAL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "fpd_cls_canonical.npz")


def _state_dict(source) -> dict:
    if isinstance(source, Mapping):
        return {k: torch.as_tensor(np.asarray(v)) for k, v in source.items()}
    path = os.fspath(source)
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: torch.from_numpy(f[k]) for k in f.files}
    if path.endswith(".pth"):
        return torch.load(path, map_location="cpu")
    raise ValueError(f"unsupported classifier weight format: {path}")


def load_classifier(weights=CANONICAL, k: int = 16, device=None) -> PointNetCls:
    """A ``PointNetCls`` in eval mode on ``device`` (None: the card) holding
    ``weights`` (see the module docstring); a module stays on its device
    unless ``device`` is given."""
    if isinstance(weights, PointNetCls):
        dev = resolve_device(next(weights.parameters()).device
                             if device is None else device)
        return weights.to(dev).eval()
    dev = resolve_device(device)
    model = PointNetCls(k=k)
    model.load_state_dict(_state_dict(weights), strict=True)
    return model.to(dev).eval()


@torch.no_grad()
def get_activations(pointclouds, weights=CANONICAL, batch_size: int = 100,
                    dims: int = ACTIVATION_DIMS + 16, k: int = 16,
                    device=None) -> np.ndarray:
    """pointclouds [M, N, 3] -> activations [M_used, dims] float64, M_used =
    floor(M / batch_size) * batch_size (the last partial batch is dropped,
    as the reference and the JAX package drop it). One model a call."""
    set_parity_mode()
    model = load_classifier(weights, k, device)
    dev = next(model.parameters()).device
    m = pointclouds.shape[0]
    n_batches = m // batch_size
    out = np.empty((n_batches * batch_size, dims), np.float64)
    for i in range(n_batches):
        s = i * batch_size
        pc = torch.as_tensor(np.asarray(pointclouds[s:s + batch_size]),
                             dtype=torch.float32).to(dev)
        out[s:s + batch_size] = model(pc)[2].double().cpu().numpy()
    return out


def calculate_activation_statistics(pointclouds, weights=CANONICAL,
                                    batch_size: int = 100,
                                    dims: int = ACTIVATION_DIMS + 16,
                                    device=None):
    """(mu, sigma) of the activation Gaussian, on the host in float64."""
    act = get_activations(pointclouds, weights, batch_size, dims,
                          device=device)
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps=1e-6) -> float:
    """The Frechet distance of two Gaussians, with scipy's sqrtm; where the
    product's root is not finite, retried with ``eps`` added to both
    diagonals; an imaginary part above 1e-3 on the diagonal raises."""
    from scipy.linalg import sqrtm

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                "Imaginary component %s" % np.max(np.abs(covmean.imag)))
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def calculate_fpd(pointclouds1, pointclouds2=None, weights=CANONICAL,
                  statistic_save_path: str | None = None,
                  batch_size: int = 100, dims: int = ACTIVATION_DIMS + 16,
                  device=None) -> float:
    """FPD between two cloud sets, or against statistics saved as an npz
    with ``m`` and ``s``. The classifier is built once for the call."""
    model = load_classifier(weights, device=device)
    m1, s1 = calculate_activation_statistics(pointclouds1, model, batch_size,
                                             dims)
    if pointclouds2 is not None:
        m2, s2 = calculate_activation_statistics(pointclouds2, model,
                                                 batch_size, dims)
    else:
        with np.load(statistic_save_path) as f:
            m2, s2 = f["m"][:], f["s"][:]
    return calculate_frechet_distance(m1, s1, m2, s2)
