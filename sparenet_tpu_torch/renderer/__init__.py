"""The differentiable depth renderer (``depth_maps.ComputeDepthMaps``)."""

from .depth_maps import (N_VIEWS_PREDEFINED, ComputeDepthMaps, look_at,
                         orthorgonal, perspective, transform_points)

__all__ = ["ComputeDepthMaps", "N_VIEWS_PREDEFINED", "look_at", "orthorgonal",
           "perspective", "transform_points"]
