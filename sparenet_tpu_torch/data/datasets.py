"""Datasets (the port's copy of sparenet_tpu/data/datasets.py; reference:
datasets/data_loaders.py:103-443): the file datasets ShapeNet (both
layouts), ShapeNetCars, Completion3D and KITTI, and the procedural
Synthetic dataset.

A dataset item is (taxonomy_id, label, model_id, data dict of float32
arrays). The loader (``data/loaders.py``) takes a file dataset's item in
three calls, so that files are read in a pool of threads while every
random draw is taken on one thread, in the pass's index order:
``choose(idx, rnd)`` draws what decides which files are read (the partial
rendering of a ShapeNet training model, from a ``random.Random``),
``read(idx, choice)`` reads them (no draw; thread-safe) and ``finish(item,
rs)`` runs the transforms on draws from an ``np.random.RandomState``
(``data/transforms.py``). Drawn from generators seeded with the
values the JAX package's global ``random`` and ``np.random`` were seeded
with, an item equals the JAX package's bit for bit when its loader runs one
worker. Synthetic items (``dataset[index]``) are made from
``np.random.RandomState(seed + index)`` and draw nothing from the loader,
so both packages give the same clouds bit for bit at any worker count.

The category files default to the port's copies in ``data/meta/``
(``configs/defaults.py``).
"""

from __future__ import annotations

import json

import numpy as np

from . import transforms as T
from .io import IO

__all__ = ["TRAIN", "TEST", "VAL", "FileListDataset", "ShapeNetDataLoader",
           "ShapeNetCarsDataLoader", "Completion3DDataLoader",
           "KittiDataLoader", "SyntheticDataset", "SyntheticDataLoader",
           "DATASET_LOADER_MAPPING", "loader_class"]

TRAIN, TEST, VAL = "train", "test", "val"


class FileListDataset:
    """Generic file-list dataset (datasets/data_loaders.py:103-124): one of
    n_renderings partial views (random in a shuffled split, else the
    first), then the transform pipeline."""

    def __init__(self, options: dict, file_list: list, transforms=None):
        self.options = options
        self.file_list = file_list
        self.transforms = transforms

    def __len__(self):
        return len(self.file_list)

    def choose(self, idx, rnd):
        """The rendering to read: drawn from ``rnd`` (a ``random.Random``)
        where the split is shuffled and has renderings, as the JAX package
        draws it from the global ``random``."""
        if "n_renderings" not in self.options:
            return -1
        if self.options["shuffle"]:
            return rnd.randint(0, self.options["n_renderings"] - 1)
        return 0

    def read(self, idx, choice):
        sample = self.file_list[idx]
        data = {}
        for ri in self.options["required_items"]:
            file_path = sample[f"{ri}_path"]
            if isinstance(file_path, list):
                file_path = file_path[choice]
            data[ri] = IO.get(file_path).astype(np.float32)
        return sample["taxonomy_id"], sample["label"], sample["model_id"], data

    def finish(self, item, rs):
        if self.transforms is None:
            return item
        taxonomy_id, label, model_id, data = item
        return taxonomy_id, label, model_id, self.transforms(data, rs)


def _shapenet_transforms(cfg, subset):
    """datasets/data_loaders.py:154-190."""
    steps = [
        {"callback": "RandomSamplePoints",
         "parameters": {"n_points": cfg.CONST.n_input_points},
         "objects": ["partial_cloud"]},
        {"callback": "RandomSamplePoints",
         "parameters": {"n_points": cfg.DATASET.n_outpoints},
         "objects": ["gtcloud"]},
    ]
    if subset == TRAIN:
        steps.append({"callback": "RandomMirrorPoints",
                      "objects": ["partial_cloud", "gtcloud"]})
    steps.append({"callback": "ToArray", "objects": ["partial_cloud", "gtcloud"]})
    return T.Compose(steps)


class ShapeNetDataLoader:
    """datasets/data_loaders.py:127-250: the "GRnet" layout (one entry a
    model, its renderings a list) or the expanded one (an entry a
    rendering, model_id suffixed with its index)."""

    def __init__(self, cfg):
        self.cfg = cfg
        with open(cfg.DATASETS.shapenet.category_file_path) as f:
            self.dataset_categories = json.load(f)

    def get_dataset(self, subset: str):
        n_renderings = (
            self.cfg.DATASETS.shapenet.n_renderings if subset == TRAIN else 1
        )
        file_list = self._get_file_list(subset, n_renderings)
        return FileListDataset(
            {"required_items": ["partial_cloud", "gtcloud"],
             "shuffle": subset == TRAIN,
             "n_renderings": n_renderings},
            file_list,
            _shapenet_transforms(self.cfg, subset),
        )

    def _get_file_list(self, subset, n_renderings=1):
        cfg = self.cfg
        file_list = []
        for label, dc in enumerate(self.dataset_categories):
            for s in dc[subset]:
                if cfg.DATASETS.shapenet.version == "GRnet":
                    file_list.append({
                        "taxonomy_id": dc["taxonomy_id"],
                        "label": label,
                        "model_id": s,
                        "partial_cloud_path": [
                            cfg.DATASETS.shapenet.partial_points_path
                            % (subset, dc["taxonomy_id"], s, i)
                            for i in range(n_renderings)
                        ],
                        "gtcloud_path": cfg.DATASETS.shapenet.complete_points_path
                        % (subset, dc["taxonomy_id"], s),
                    })
                else:
                    for i in range(n_renderings):
                        file_list.append({
                            "taxonomy_id": dc["taxonomy_id"],
                            "label": label,
                            "model_id": s + str(i),
                            "partial_cloud_path":
                                cfg.DATASETS.shapenet.partial_points_path
                                % (subset, dc["taxonomy_id"], s, i),
                            "gtcloud_path":
                                cfg.DATASETS.shapenet.complete_points_path
                                % (subset, dc["taxonomy_id"], s),
                        })
        return file_list


class ShapeNetCarsDataLoader(ShapeNetDataLoader):
    """Cars-only filter, taxonomy 02958343
    (datasets/data_loaders.py:253-260)."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.dataset_categories = [
            dc for dc in self.dataset_categories
            if dc["taxonomy_id"] == "02958343"
        ]


class Completion3DDataLoader:
    """datasets/data_loaders.py:263-355 (.h5 files; TEST has no gt)."""

    def __init__(self, cfg):
        self.cfg = cfg
        with open(cfg.DATASETS.completion3d.category_file_path) as f:
            self.dataset_categories = json.load(f)

    def get_dataset(self, subset: str):
        required = ["partial_cloud"] if subset == TEST else ["partial_cloud", "gtcloud"]
        steps = [
            {"callback": "RandomSamplePoints",
             "parameters": {"n_points": self.cfg.CONST.n_input_points},
             "objects": ["partial_cloud"]},
        ]
        if subset == TRAIN:
            steps.append({"callback": "RandomMirrorPoints",
                          "objects": ["partial_cloud", "gtcloud"]})
        steps.append({"callback": "ToArray", "objects": required})
        return FileListDataset(
            {"required_items": required, "shuffle": subset == TRAIN},
            self._get_file_list(subset),
            T.Compose(steps),
        )

    def _get_file_list(self, subset):
        cfg = self.cfg
        file_list = []
        label = 0
        for dc in self.dataset_categories:
            for s in dc[subset]:
                file_list.append({
                    "taxonomy_id": dc["taxonomy_id"],
                    "label": label,
                    "model_id": s,
                    "partial_cloud_path":
                        cfg.DATASETS.completion3d.partial_points_path
                        % (subset, dc["taxonomy_id"], s),
                    "gtcloud_path":
                        cfg.DATASETS.completion3d.complete_points_path
                        % (subset, dc["taxonomy_id"], s),
                })
            if dc["taxonomy_id"] != "all":
                label += 1
        return file_list


class KittiDataLoader:
    """datasets/data_loaders.py:358-433 (bbox pose normalization, no gt)."""

    def __init__(self, cfg):
        self.cfg = cfg
        with open(cfg.DATASETS.kitti.category_file_path) as f:
            self.dataset_categories = json.load(f)

    def get_dataset(self, subset: str):
        steps = [
            {"callback": "NormalizeObjectPose",
             "parameters": {"input_keys": {"ptcloud": "partial_cloud",
                                           "bbox": "bounding_box"}},
             "objects": ["partial_cloud", "bounding_box"]},
            {"callback": "RandomSamplePoints",
             "parameters": {"n_points": self.cfg.CONST.n_input_points},
             "objects": ["partial_cloud"]},
            {"callback": "ToArray", "objects": ["partial_cloud", "bounding_box"]},
        ]
        return FileListDataset(
            {"required_items": ["partial_cloud", "bounding_box"],
             "shuffle": False},
            self._get_file_list(subset),
            T.Compose(steps),
        )

    def _get_file_list(self, subset):
        cfg = self.cfg
        file_list = []
        for dc in self.dataset_categories:
            for s in dc[subset]:
                file_list.append({
                    "taxonomy_id": dc["taxonomy_id"],
                    "label": 0,
                    "model_id": s,
                    "partial_cloud_path":
                        cfg.DATASETS.kitti.partial_points_path % s,
                    "bounding_box_path":
                        cfg.DATASETS.kitti.bounding_box_file_path % s,
                })
        return file_list


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
    "Completion3D": Completion3DDataLoader,
    "ShapeNet": ShapeNetDataLoader,
    "ShapeNetCars": ShapeNetCarsDataLoader,
    "KITTI": KittiDataLoader,
    "Synthetic": SyntheticDataLoader,
}


def loader_class(name: str):
    """The dataset loader class for a config's DATASET.*_dataset name."""
    if name not in DATASET_LOADER_MAPPING:
        raise KeyError(f"unknown dataset {name!r}; the port has "
                       f"{sorted(DATASET_LOADER_MAPPING)}")
    return DATASET_LOADER_MAPPING[name]
