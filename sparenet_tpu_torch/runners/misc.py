"""AverageMeter (the port's copy of sparenet_tpu/runners/misc.py; reference:
runners/misc.py:4-44)."""

from __future__ import annotations

__all__ = ["AverageMeter"]


class AverageMeter:
    """Tracks val/sum/count/avg for one or several named items."""

    def __init__(self, items=None):
        self.items = items
        self.n_items = 1 if items is None else len(items)
        self.reset()

    def reset(self):
        self._val = [0.0] * self.n_items
        self._sum = [0.0] * self.n_items
        self._count = [0] * self.n_items

    def update(self, values):
        if isinstance(values, (list, tuple)):
            for i, v in enumerate(values):
                self._val[i] = float(v)
                self._sum[i] += float(v)
                self._count[i] += 1
        else:
            self._val[0] = float(values)
            self._sum[0] += float(values)
            self._count[0] += 1

    def val(self, idx=None):
        if idx is None:
            return self._val if self.items else self._val[0]
        return self._val[idx]

    def count(self, idx=None):
        if idx is None:
            return self._count if self.items else self._count[0]
        return self._count[idx]

    def avg(self, idx=None):
        if idx is None:
            if self.items:
                return [s / c if c else 0.0 for s, c in zip(self._sum, self._count)]
            return self._sum[0] / self._count[0] if self._count[0] else 0.0
        return self._sum[idx] / self._count[idx] if self._count[idx] else 0.0
