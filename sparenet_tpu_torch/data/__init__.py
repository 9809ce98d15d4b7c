"""Datasets and loaders: the file datasets (ShapeNet, ShapeNetCars,
Completion3D, KITTI) with their io and transforms, the Synthetic dataset and
the batching loader."""

from . import transforms
from .datasets import (DATASET_LOADER_MAPPING, TEST, TRAIN, VAL,
                       SyntheticDataset, loader_class)
from .io import IO, read_pcd, write_pcd
from .loaders import DataLoader, collate, data_init

__all__ = ["DataLoader", "collate", "data_init", "DATASET_LOADER_MAPPING",
           "SyntheticDataset", "loader_class", "TRAIN", "TEST", "VAL", "IO",
           "read_pcd", "write_pcd", "transforms"]
