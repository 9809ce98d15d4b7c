"""Host-side data transforms in numpy (the port's copy of
sparenet_tpu/data/transforms.py; reference: datasets/data_transforms.py:
11-261).

The arithmetic is the JAX package's, line for line; only the random draws
differ in where they come from. The JAX transforms draw from the global
``np.random``, inside a pool of loader threads, so which cloud gets which
draw depends on thread timing. Here every draw comes from the
``np.random.RandomState`` that ``Compose`` is called with: the legacy class,
so one seed gives exactly the draws the JAX package takes from the global
generator seeded with it. ``Compose(steps)(data, rs)`` draws one shared
``rnd_value`` per step, as the reference does (one mirroring for the
partial and the complete cloud), and calls each transform as
``transform(array, rnd_value, rs)`` (``NormalizeObjectPose`` on the whole
item). ``CenterCrop`` and ``RandomCrop`` resize with ``cv2`` and raise
without it.
"""

from __future__ import annotations

import math

import numpy as np

from .io import require_cv2

__all__ = [
    "Compose", "RandomSamplePoints", "RandomClipPoints", "RandomRotatePoints",
    "RandomScalePoints", "RandomMirrorPoints", "NormalizeObjectPose",
    "ToArray", "TRANSFORM_REGISTRY",
]


class ToArray:
    """float32 numpy passthrough (analog of ToTensor,
    datasets/data_transforms.py:45-55; images stay channel-last)."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, arr, rnd_value=None, rs=None):
        return np.ascontiguousarray(arr, dtype=np.float32)


class Normalize:
    """Image normalize: /std then -mean, in that (reference) order
    (datasets/data_transforms.py:58-68)."""

    def __init__(self, parameters):
        self.mean = parameters["mean"]
        self.std = parameters["std"]

    def __call__(self, arr, rnd_value=None, rs=None):
        arr = arr.astype(np.float32)
        return arr / self.std - self.mean


def _crop_resize(img, y_top, y_bottom, x_left, x_right, out_h, out_w):
    cv2 = require_cv2("the image crop transforms")
    img = cv2.resize(
        img[int(y_top):int(y_bottom), int(x_left):int(x_right)],
        (out_w, out_h))
    return img[..., np.newaxis] if img.ndim == 2 else img


class CenterCrop:
    """(datasets/data_transforms.py:71-92)."""

    def __init__(self, parameters):
        self.img_size = parameters["img_size"]
        self.crop_size = parameters["crop_size"]

    def __call__(self, img, rnd_value=None, rs=None):
        img_w, img_h = img.shape[0], img.shape[1]
        x_left = (img_w - self.crop_size[1]) * 0.5
        y_top = (img_h - self.crop_size[0]) * 0.5
        return _crop_resize(img, y_top, y_top + self.crop_size[0],
                            x_left, x_left + self.crop_size[1],
                            self.img_size[0], self.img_size[1])


class RandomCrop:
    """(datasets/data_transforms.py:95-116)."""

    def __init__(self, parameters):
        self.img_size = parameters["img_size"]
        self.crop_size = parameters["crop_size"]

    def __call__(self, img, rnd_value, rs=None):
        img_w, img_h = img.shape[0], img.shape[1]
        x_left = (img_w - self.crop_size[1]) * rnd_value
        y_top = (img_h - self.crop_size[0]) * rnd_value
        return _crop_resize(img, y_top, y_top + self.crop_size[0],
                            x_left, x_left + self.crop_size[1],
                            self.img_size[0], self.img_size[1])


class RandomFlip:
    """Horizontal flip at rnd > 0.5 (datasets/data_transforms.py:119-127)."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, img, rnd_value, rs=None):
        return np.fliplr(img) if rnd_value > 0.5 else img


class RandomPermuteRGB:
    """(datasets/data_transforms.py:130-136)."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, img, rnd_value, rs):
        return img[..., rs.permutation(3)]


class RandomBackground:
    """Composite RGBA onto a random background color
    (datasets/data_transforms.py:139-159)."""

    def __init__(self, parameters):
        self.random_bg_color_range = parameters["bg_color"]

    def __call__(self, img, rnd_value, rs):
        if img.shape[2] != 4:
            return img
        r, g, b = [rs.randint(lo, hi + 1)
                   for lo, hi in self.random_bg_color_range]
        alpha = (np.expand_dims(img[:, :, 3], axis=2) == 0).astype(np.float32)
        rgb = img[:, :, :3]
        bg_color = np.array([[[r, g, b]]]) / 255.0
        return alpha * bg_color + (1 - alpha) * rgb


class RandomSamplePoints:
    """Random permutation + truncate to n_points, zero-pad if short
    (datasets/data_transforms.py:162-174)."""

    def __init__(self, parameters):
        self.n_points = parameters["n_points"]

    def __call__(self, ptcloud, rnd_value, rs):
        choice = rs.permutation(ptcloud.shape[0])
        ptcloud = ptcloud[choice[: self.n_points]]
        if ptcloud.shape[0] < self.n_points:
            zeros = np.zeros((self.n_points - ptcloud.shape[0], 3))
            ptcloud = np.concatenate([ptcloud, zeros])
        return ptcloud


class RandomClipPoints:
    """Clipped gaussian jitter (datasets/data_transforms.py:177-186)."""

    def __init__(self, parameters):
        parameters = parameters or {}
        self.sigma = parameters.get("sigma", 0.01)
        self.clip = parameters.get("clip", 0.05)

    def __call__(self, ptcloud, rnd_value, rs):
        noise = np.clip(
            self.sigma * rs.randn(*ptcloud.shape), -self.clip, self.clip
        ).astype(np.float32)
        return ptcloud + noise


def _axangle_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


class RandomRotatePoints:
    """Rotation about +y by 2*pi*rnd (datasets/data_transforms.py:189-198)."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, ptcloud, rnd_value, rs=None):
        m = _axangle_y(2 * math.pi * rnd_value)
        ptcloud[:, :3] = ptcloud[:, :3] @ m.T
        return ptcloud


class RandomScalePoints:
    """Uniform isotropic scale in [rnd/scale, rnd*scale]
    (datasets/data_transforms.py:201-212)."""

    def __init__(self, parameters):
        self.scale = parameters["scale"]

    def __call__(self, ptcloud, rnd_value, rs):
        s = rs.uniform(1.0 / self.scale * rnd_value, self.scale * rnd_value)
        ptcloud[:, :3] = ptcloud[:, :3] * s
        return ptcloud


class RandomMirrorPoints:
    """Mirror about x and/or z planes, branch thresholds 0.25/0.5/0.75
    (datasets/data_transforms.py:215-232)."""

    def __init__(self, parameters=None):
        pass

    def __call__(self, ptcloud, rnd_value, rs=None):
        mx = np.diag([-1.0, 1.0, 1.0])   # zfdir2mat(-1, [1,0,0])
        mz = np.diag([1.0, 1.0, -1.0])   # zfdir2mat(-1, [0,0,1])
        if rnd_value <= 0.25:
            m = mx @ mz
        elif rnd_value <= 0.5:
            m = mx
        elif rnd_value <= 0.75:
            m = mz
        else:
            m = np.eye(3)
        ptcloud[:, :3] = ptcloud[:, :3] @ m.T
        return ptcloud


class NormalizeObjectPose:
    """KITTI bbox-frame normalization (datasets/data_transforms.py:235-261):
    center/yaw/scale from the bbox corners, then a y<->z axis swap. Takes
    the whole item."""

    def __init__(self, parameters):
        input_keys = parameters["input_keys"]
        self.ptcloud_key = input_keys["ptcloud"]
        self.bbox_key = input_keys["bbox"]

    def __call__(self, data):
        ptcloud = data[self.ptcloud_key]
        bbox = data[self.bbox_key]
        center = (bbox.min(0) + bbox.max(0)) / 2
        bbox = bbox - center
        yaw = np.arctan2(bbox[3, 1] - bbox[0, 1], bbox[3, 0] - bbox[0, 0])
        rotation = np.array(
            [[np.cos(yaw), -np.sin(yaw), 0],
             [np.sin(yaw), np.cos(yaw), 0],
             [0, 0, 1]]
        )
        bbox = bbox @ rotation
        scale = bbox[3, 0] - bbox[0, 0]
        bbox = bbox / scale
        ptcloud = (ptcloud - center) @ rotation / scale
        ptcloud = ptcloud @ np.array([[1.0, 0, 0], [0, 0, 1.0], [0, 1.0, 0]])
        data[self.ptcloud_key] = ptcloud
        data[self.bbox_key] = bbox
        return data


TRANSFORM_REGISTRY = {
    "Normalize": Normalize,
    "CenterCrop": CenterCrop,
    "RandomCrop": RandomCrop,
    "RandomFlip": RandomFlip,
    "RandomPermuteRGB": RandomPermuteRGB,
    "RandomBackground": RandomBackground,
    "RandomSamplePoints": RandomSamplePoints,
    "RandomClipPoints": RandomClipPoints,
    "RandomRotatePoints": RandomRotatePoints,
    "RandomScalePoints": RandomScalePoints,
    "RandomMirrorPoints": RandomMirrorPoints,
    "NormalizeObjectPose": NormalizeObjectPose,
    "ToTensor": ToArray,   # reference name kept for config parity
    "ToArray": ToArray,
}


class Compose:
    """Registry-driven transform pipeline
    (datasets/data_transforms.py:11-42); see the module docstring."""

    def __init__(self, transforms):
        self.transformers = []
        for tr in transforms:
            cls = TRANSFORM_REGISTRY[tr["callback"]]
            self.transformers.append(
                {"callback": cls(tr.get("parameters")), "objects": tr["objects"]}
            )

    def __call__(self, data: dict, rs: np.random.RandomState) -> dict:
        for tr in self.transformers:
            transform = tr["callback"]
            objects = tr["objects"]
            rnd_value = rs.uniform(0, 1)
            if isinstance(transform, NormalizeObjectPose):
                data = transform(data)
            else:
                for k in list(data.keys()):
                    if k in objects:
                        data[k] = transform(data[k], rnd_value, rs)
        return data
