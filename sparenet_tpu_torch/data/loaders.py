"""Host-side batching and prefetch (the port's copy of
sparenet_tpu/data/loaders.py: ``collate``, ``DataLoader``, ``data_init``).

A background thread keeps ``prefetch`` batches ready; batches are
(taxonomy_ids, labels [B] int32, model_ids, data dict of stacked float32
numpy arrays), in the same order and with the same shuffle seeds as the JAX
package's loader (``RandomState(seed + pass)``, the pass counted from 0 in
each loader). A pool of ``num_workers`` threads reads the files, but every
random draw is taken on the background thread in the pass's index order
(the draw protocol of ``data/datasets.py``: ``choose``, ``read``,
``finish``; a dataset without it, as Synthetic, is read whole by
``dataset[i]`` in the pool), from a ``random.Random`` and an
``np.random.RandomState`` both seeded with ``seed + pass`` as well. So a
pass's batches do not depend on the worker count, a loader's pass draws
what any other loader of the same seed draws in that pass (a resumed run's
first epoch draws what the first run's first epoch drew, as its shuffle
does), and they equal the JAX package's batches at one worker when its
global ``random`` and ``np.random`` are seeded with ``seed + pass``. The
step that takes a batch makes the one host-to-card copy.
"""

from __future__ import annotations

import queue
import random
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

    def _generators(self):
        """The pass's draw generators: (random.Random, RandomState)."""
        seed = self._seed + self._epoch
        return random.Random(seed), np.random.RandomState(seed)

    def _batches(self):
        order = self._order()
        for i in range(len(self)):
            yield order[i * self.batch_size:(i + 1) * self.batch_size]

    def _collated(self, idxs, rngs, pool=None):
        """One batch: the items of ``idxs`` read in ``pool`` (or here), the
        draws taken here in index order. A dataset without the draw
        protocol (``finish``: Synthetic) is read whole by ``dataset[i]``."""
        rnd, rs = rngs
        ds = self.dataset
        drawn = hasattr(ds, "finish")
        if drawn:
            args = (ds.read, idxs, [ds.choose(i, rnd) for i in idxs])
        else:
            args = (ds.__getitem__, idxs)
        items = (map if pool is None else pool.map)(*args)
        if drawn:
            items = [ds.finish(item, rs) for item in items]
        return collate(list(items))

    def first_batch(self):
        """The next pass's first batch, read in the calling thread; the
        pass is not counted (its shuffle and draw seeds stay the next
        pass's)."""
        return self._collated(self._order()[:self.batch_size],
                              self._generators())

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        batches, rngs = list(self._batches()), self._generators()
        self._epoch += 1

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        q.put(self._collated(idxs, rngs, pool))
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
    of cfg.TEST.batch_size. Both loaders draw from generators seeded with
    CONST.seed and the pass (the JAX package leaves its validation loader
    at seed 0 and never seeds its draws); with the cGAN, DATASET.num_class
    is the training dataset's categories (Completion3D's less its "all")."""
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
        seed=cfg.CONST.seed,
    )
    if cfg.GAN.use_cgan:
        num_classes = len(train_ld.dataset_categories)
        if cfg.DATASET.train_dataset == "Completion3D":
            num_classes -= 1
        cfg.DATASET.num_class = num_classes
    return train_loader, val_loader
