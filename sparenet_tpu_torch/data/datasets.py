"""The procedural Synthetic dataset (the port's copy of
sparenet_tpu/data/datasets.py: TRAIN / VAL / TEST, ``_surface_points``,
``SyntheticDataset``, ``SyntheticDataLoader``).

A dataset item is (taxonomy_id, label, model_id, data dict of float32
arrays), made with numpy from ``np.random.RandomState(seed + index)`` as the
JAX package makes it, so both packages give the same clouds bit for bit.
The file datasets (ShapeNet, ShapeNetCars, Completion3D, KITTI) and their
io and transforms are not ported yet: ``loader_class`` names the queue item
(ROADMAP.md, queue 1 item 3, the data pipeline) when one is asked for.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TRAIN", "TEST", "VAL", "SyntheticDataset", "SyntheticDataLoader",
           "DATASET_LOADER_MAPPING", "FILE_DATASETS", "loader_class"]

TRAIN, TEST, VAL = "train", "test", "val"

# ---------------------------------------------------------------------------
# Synthetic procedural dataset
# ---------------------------------------------------------------------------

_SYNTH_SHAPES = ("sphere", "box", "cylinder", "torus",
                 "cone", "capsule", "ellipsoid", "plane_union")


def _surface_points(shape: str, n: int, rs: np.random.RandomState) -> np.ndarray:
    """n points on the surface of a unit primitive, in [-0.5, 0.5]^3."""
    u = rs.randn(n, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-9
    if shape == "sphere":
        p = u * 0.5
    elif shape == "ellipsoid":
        p = u * np.array([0.5, 0.3, 0.2])
    elif shape == "box":
        face = rs.randint(0, 6, n)
        p = rs.rand(n, 3) - 0.5
        axis = face // 2
        p[np.arange(n), axis] = np.where(face % 2 == 0, -0.5, 0.5)
    elif shape == "cylinder":
        theta = rs.rand(n) * 2 * np.pi
        z = rs.rand(n) - 0.5
        p = np.stack([0.35 * np.cos(theta), 0.35 * np.sin(theta), z], -1)
    elif shape == "cone":
        theta = rs.rand(n) * 2 * np.pi
        h = np.sqrt(rs.rand(n))
        r = 0.45 * (1 - h)
        p = np.stack([r * np.cos(theta), r * np.sin(theta), h - 0.5], -1)
    elif shape == "torus":
        a, b = 0.35, 0.12
        t1 = rs.rand(n) * 2 * np.pi
        t2 = rs.rand(n) * 2 * np.pi
        p = np.stack([
            (a + b * np.cos(t2)) * np.cos(t1),
            (a + b * np.cos(t2)) * np.sin(t1),
            b * np.sin(t2)], -1)
    elif shape == "capsule":
        seg = rs.rand(n) < 0.5
        theta = rs.rand(n) * 2 * np.pi
        z = (rs.rand(n) - 0.5) * 0.6
        cyl = np.stack([0.25 * np.cos(theta), 0.25 * np.sin(theta), z], -1)
        cap = u * 0.25 + np.array([0, 0, 0.3]) * np.sign(u[:, 2:3])
        p = np.where(seg[:, None], cyl, cap)
    else:  # plane_union: two orthogonal planes
        which = rs.rand(n) < 0.5
        a = np.stack([rs.rand(n) - 0.5, rs.rand(n) - 0.5, np.zeros(n)], -1)
        b2 = np.stack([rs.rand(n) - 0.5, np.zeros(n), rs.rand(n) - 0.5], -1)
        p = np.where(which[:, None], a, b2)
    return p.astype(np.float32)


class SyntheticDataset:
    """Procedural completion pairs: gt = full surface sample; partial =
    half-space crop from a random view direction (deterministic per
    (seed, index))."""

    def __init__(self, cfg, subset: str):
        self.cfg = cfg
        self.subset = subset
        n = (cfg.DATASETS.synthetic.n_train if subset == TRAIN
             else cfg.DATASETS.synthetic.n_val)
        self.n = n
        self.n_cat = cfg.DATASETS.synthetic.n_categories
        self.seed = {TRAIN: 10_000, VAL: 20_000, TEST: 30_000}[subset]

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rs = np.random.RandomState(self.seed + idx)
        label = idx % self.n_cat
        shape = _SYNTH_SHAPES[label % len(_SYNTH_SHAPES)]
        gt = _surface_points(shape, self.cfg.DATASET.n_outpoints, rs)
        # random rotation
        q = rs.randn(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        gt = gt @ rot.T
        # partial: keep points on the far side of a random plane
        view = rs.randn(3)
        view /= np.linalg.norm(view)
        mask = gt @ view > np.quantile(gt @ view, 0.5)
        partial_full = gt[mask]
        n_in = self.cfg.CONST.n_input_points
        choice = rs.permutation(partial_full.shape[0])
        partial = partial_full[choice[:n_in]]
        if partial.shape[0] < n_in:
            partial = np.concatenate(
                [partial, np.zeros((n_in - partial.shape[0], 3), np.float32)]
            )
        data = {"partial_cloud": partial.astype(np.float32),
                "gtcloud": gt.astype(np.float32)}
        return f"synthetic_{label}", label, f"model_{idx:06d}", data


class SyntheticDataLoader:
    def __init__(self, cfg):
        self.cfg = cfg
        self.dataset_categories = [
            {"taxonomy_id": f"synthetic_{i}", "taxonomy_name": _SYNTH_SHAPES[i % len(_SYNTH_SHAPES)]}
            for i in range(cfg.DATASETS.synthetic.n_categories)
        ]

    def get_dataset(self, subset: str):
        return SyntheticDataset(self.cfg, subset)


DATASET_LOADER_MAPPING = {
    "Synthetic": SyntheticDataLoader,
}
FILE_DATASETS = ("Completion3D", "ShapeNet", "ShapeNetCars", "KITTI")


def loader_class(name: str):
    """The dataset loader class for a config's DATASET.*_dataset name."""
    if name in DATASET_LOADER_MAPPING:
        return DATASET_LOADER_MAPPING[name]
    if name in FILE_DATASETS:
        raise NotImplementedError(
            f"dataset {name!r}: the file datasets, their io and transforms "
            f"are not ported yet (ROADMAP.md, queue 1 item 3, the data "
            f"pipeline); the port has {sorted(DATASET_LOADER_MAPPING)}")
    raise KeyError(f"unknown dataset {name!r}")
