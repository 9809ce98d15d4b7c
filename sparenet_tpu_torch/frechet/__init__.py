"""Frechet Pointcloud Distance: the PointNet classifier, its activations'
statistics and the Frechet distance (counterpart of sparenet_tpu/frechet/).
The converter from the JAX package's classifier variables is
``utils.weights.fpd_state_dict_from_jax``."""

from .fpd import (
    calculate_activation_statistics,
    calculate_fpd,
    calculate_frechet_distance,
    get_activations,
)
from .pointnet import PointNetCls, PointNetFeat, STN3d, load_torch_state
from .train_classifier import train_classifier

__all__ = [
    "calculate_fpd", "calculate_frechet_distance",
    "calculate_activation_statistics", "get_activations",
    "PointNetCls", "PointNetFeat", "STN3d", "load_torch_state",
    "train_classifier",
]
