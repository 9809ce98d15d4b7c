"""Host-side batching and prefetch (the port's copy of
sparenet_tpu/data/loaders.py: ``collate``, ``DataLoader``, ``data_init``).

A thread pool maps the dataset reads and a background thread keeps
``prefetch`` batches ready; batches are (taxonomy_ids, labels [B] int32,
model_ids, data dict of stacked float32 numpy arrays), in the same order and
with the same shuffle seeds as the JAX package's loader, so both packages
see the same batches. The step that takes a batch makes the one host-to-card
copy.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .datasets import TEST, TRAIN, VAL, loader_class

__all__ = ["collate", "DataLoader", "data_init"]


def collate(samples):
    taxonomy_ids = [s[0] for s in samples]
    labels = np.asarray([s[1] for s in samples], np.int32)
    model_ids = [s[2] for s in samples]
    data = {}
    for k in samples[0][3]:
        data[k] = np.stack([s[3][k] for s in samples]).astype(np.float32)
    return taxonomy_ids, labels, model_ids, data


class DataLoader:
    """Iterable over collated batches with worker threads + prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool,
                 drop_last: bool = False, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self._epoch = 0
        self._seed = seed

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rs = np.random.RandomState(self._seed + self._epoch)
            rs.shuffle(order)
        return order

    def _batches(self):
        order = self._order()
        self._epoch += 1
        for i in range(len(self)):
            yield order[i * self.batch_size:(i + 1) * self.batch_size]

    def first_batch(self):
        """The next pass's first batch, read in the calling thread; the
        pass is not counted (its shuffle seed stays the next pass's)."""
        idxs = self._order()[:self.batch_size]
        return collate([self.dataset[i] for i in idxs])

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in self._batches():
                        q.put(collate(list(pool.map(self.dataset.__getitem__,
                                                    idxs))))
            except BaseException as e:      # raised again in the consumer
                q.put(e)
            q.put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def data_init(cfg):
    """(train_loader, val_loader). Validation takes the TEST split, except
    for Completion3D (VAL: its test split has no ground truth), in batches
    of cfg.TEST.batch_size."""
    train_ld = loader_class(cfg.DATASET.train_dataset)(cfg)
    test_ld = loader_class(cfg.DATASET.test_dataset)(cfg)
    train_loader = DataLoader(
        train_ld.get_dataset(TRAIN),
        batch_size=cfg.TRAIN.batch_size,
        shuffle=True,
        drop_last=True,
        num_workers=cfg.CONST.num_workers,
        prefetch=cfg.TPU.prefetch,
        seed=cfg.CONST.seed,
    )
    val_subset = VAL if cfg.DATASET.test_dataset == "Completion3D" else TEST
    val_loader = DataLoader(
        test_ld.get_dataset(val_subset),
        batch_size=getattr(cfg.TEST, "batch_size", 1),
        shuffle=False,
        drop_last=False,
        num_workers=cfg.CONST.num_workers,
        prefetch=cfg.TPU.prefetch,
    )
    if cfg.GAN.use_cgan:
        num_classes = len(train_ld.dataset_categories)
        if cfg.DATASET.train_dataset == "Completion3D":
            num_classes -= 1
        cfg.DATASET.num_class = num_classes
    return train_loader, val_loader
