"""Logger and summary writers (the port's copy of
sparenet_tpu/utils/logging.py; reference: utils/misc.py:39-51, 112-130).

``writer_init`` gives no-op writers: the port writes no TensorBoard files,
so the scalars and the point-cloud images that ``TEST.mode`` "default"
draws in the JAX package are not made (``utils/visualizer.py:
tensorboard_save_image`` draws them for a writer that is given one).
"""

from __future__ import annotations

import logging
import os

__all__ = ["set_logger", "writer_init", "NullWriter"]


def set_logger(filename: str | None = None) -> logging.Logger:
    """File + console logger (utils/misc.py:112-130)."""
    logger = logging.getLogger("sparenet_tpu_torch")
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    formatter = logging.Formatter("%(levelname)s: - %(message)s")
    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO)
    ch.setFormatter(formatter)
    logger.addHandler(ch)
    if filename:
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        fh = logging.FileHandler(filename)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    return logger


class NullWriter:
    """No-op SummaryWriter stand-in."""

    def add_scalar(self, *a, **k):
        pass

    def add_image(self, *a, **k):
        pass

    def close(self):
        pass

    def flush(self):
        pass


def writer_init(cfg):
    """(train_writer, val_writer): no-op writers."""
    return NullWriter(), NullWriter()
