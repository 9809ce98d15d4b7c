"""Differentiable point cloud -> depth maps (counterpart of
sparenet_tpu/renderer/depth_maps.py).

Eight fixed cube-corner views (look-at with up = (0, 0, 1)), orthographic
(scale 1.5) or perspective (fovy pi / 4) projection, z in [0.1, 10]. The
depth feature is ``1 - normalised z``, with z's min and max taken over the
whole batch of one view; the points are splatted by the zero-background max
splat (``ops/p2i.py``), whose kernel runs on the card.

``render_all_views`` folds the 8 views into the image axis, so each cloud
takes one splat call per radius. Images are channel-last [B, H, W, C], as in
the JAX package; the channel order of ``render_all_views`` is (view, radius).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import p2i

__all__ = ["N_VIEWS_PREDEFINED", "look_at", "perspective", "orthorgonal",
           "transform_points", "ComputeDepthMaps"]

N_VIEWS_PREDEFINED = 8

_EYES = np.array(
    [[-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
     [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1]], np.float32)


def _normalize(v, eps=1e-6):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), eps)


def look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """4x4 view matrix: translate the eye to the origin, then rotate so that
    -forward is +z."""
    zaxis = _normalize(eye - center)
    xaxis = _normalize(np.cross(up, zaxis))
    yaxis = np.cross(zaxis, xaxis)
    orientation = np.eye(4, dtype=np.float32)
    orientation[0, :3] = xaxis
    orientation[1, :3] = yaxis
    orientation[2, :3] = zaxis
    translation = np.eye(4, dtype=np.float32)
    translation[:3, 3] = -eye
    return orientation @ translation


def perspective(fovy: float, aspect: float, z_near: float,
                z_far: float) -> np.ndarray:
    """Right-handed perspective projection."""
    t = math.tan(fovy / 2.0)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -2.0 * z_far * z_near / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def orthorgonal(scalex: float, scaley: float, z_near: float,
                z_far: float) -> np.ndarray:
    """Orthographic projection (the reference's spelling)."""
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = scalex
    m[1, 1] = scaley
    m[2, 2] = -2.0 / (z_far - z_near)
    m[2, 3] = (z_far + z_near) / (z_far - z_near)
    m[3, 3] = 1.0
    return m


def transform_points(matrix: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """A 4x4 matrix (or a stack [..., 4, 4] broadcast against the points'
    leading axes) applied to [..., 3] points, with the perspective divide."""
    hom = torch.cat([points, points.new_ones(points.shape[:-1] + (1,))], -1)
    out = hom @ matrix.transpose(-1, -2)
    return out[..., :3] / out[..., 3:4]


class ComputeDepthMaps:
    """Renderer with the 8 projection @ view matrices precomputed;
    ``__call__`` renders one view, ``render_all_views`` all 8 at once."""

    def __init__(self, projection: str = "orthorgonal",
                 eyepos_scale: float = 1.0, image_size: int = 256):
        if projection not in ("perspective", "orthorgonal"):
            raise ValueError(f"unknown projection {projection!r}")
        self.image_size = image_size
        self.num_views = N_VIEWS_PREDEFINED
        if projection == "perspective":
            proj = perspective(math.pi / 4, 1.0, 0.1, 10.0)
        else:
            proj = orthorgonal(1.5, 1.5, 0.1, 10.0)
        up, center = np.array([0, 0, 1], np.float32), np.zeros(3, np.float32)
        self.matrices = torch.from_numpy(np.stack(
            [proj @ look_at(eye * eyepos_scale, center, up) for eye in _EYES]))

    def _project(self, data: torch.Tensor, matrix: torch.Tensor):
        """data [B, N, 3], matrix [..., 1, 4, 4] -> pixel (y, x) coordinates
        [..., B, N, 2] and depth features [..., B, N, 1], with z's min and
        max over the batch (the last two axes)."""
        trans = transform_points(matrix, data)
        xs, ys, zs = trans.unbind(-1)
        pix = (torch.stack([-ys, xs], -1) + 1.0) * ((self.image_size - 1) / 2.0)
        zmin = zs.amin((-2, -1), keepdim=True)
        zmax = zs.amax((-2, -1), keepdim=True)
        return pix, (1.0 - (zs - zmin) / (zmax - zmin))[..., None]

    def _splat(self, pix, feat, n_images: int, radius_list) -> torch.Tensor:
        """Rows image-major, n_images equal groups -> [n, H, W, len(radii)]."""
        h = w = self.image_size
        binds = torch.arange(n_images, dtype=torch.int32, device=pix.device)
        binds = binds.repeat_interleave(pix.shape[0] // n_images)
        return torch.cat([p2i.p2i_max_zbg(pix, feat, binds, n_images, h, w,
                                          float(r)) for r in radius_list], -1)

    def __call__(self, data: torch.Tensor, view_id: int = 0,
                 radius_list=(10.0,)) -> torch.Tensor:
        """data [B, N, 3] -> depth maps [B, H, W, len(radius_list)]."""
        b = data.shape[0]
        m = self.matrices[view_id].to(data.device)
        pix, feat = self._project(data, m)
        return self._splat(pix.reshape(-1, 2), feat.reshape(-1, 1), b,
                           radius_list)

    def render_all_views(self, data: torch.Tensor,
                         radius_list=(10.0,)) -> torch.Tensor:
        """data [B, N, 3] -> [B, H, W, 8 * len(radius_list)], channels in
        (view, radius) order, in one splat call per radius."""
        b, n, _ = data.shape
        v, h = self.num_views, self.image_size
        pix, feat = self._project(data, self.matrices.to(data.device)[:, None])
        # image-major rows: image = batch * 8 + view
        pix = pix.transpose(0, 1).reshape(-1, 2)
        feat = feat.transpose(0, 1).reshape(-1, 1)
        maps = self._splat(pix, feat, b * v, radius_list)    # [B*V, H, W, R]
        maps = maps.reshape(b, v, h, h, -1).permute(0, 2, 3, 1, 4)
        return maps.reshape(b, h, h, -1)
