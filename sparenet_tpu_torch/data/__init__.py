"""Datasets and loaders: the Synthetic dataset and the batching loader."""

from .datasets import (DATASET_LOADER_MAPPING, TEST, TRAIN, VAL,
                       SyntheticDataset, loader_class)
from .loaders import DataLoader, collate, data_init

__all__ = ["DataLoader", "collate", "data_init", "DATASET_LOADER_MAPPING",
           "SyntheticDataset", "loader_class", "TRAIN", "TEST", "VAL"]
