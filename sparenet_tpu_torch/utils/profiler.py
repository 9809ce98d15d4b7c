"""Tracing and timing hooks (counterpart of sparenet_tpu/utils/profiler.py).

- ``trace(dir)``: a context manager around ``torch.profiler`` (CPU and, where
  there is a card, CUDA activities) that writes a Chrome trace to
  ``dir/trace.json`` and returns the profiler for ``key_averages()``.
- ``annotate(name)``: a named span (``torch.profiler.record_function``) that
  shows in traces.
- ``StepTimer``: wall-clock times a step with a summary; ``stop()``
  synchronises the card first, so that a step's time includes its kernels.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; its Chrome trace goes to log_dir/trace.json."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named span of host code, shown in traces."""
    return record_function(name)


class StepTimer:
    """Wall time a step: ``start()``, then ``stop()``, which waits for the
    card (when one is in use) before it reads the clock."""

    def __init__(self, name: str = "step", device=None):
        self.name = name
        self.device = torch.device("cpu" if device is None else device)
        self.samples: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {"name": self.name, "n": len(arr),
                "mean_ms": float(arr.mean() * 1000),
                "p50_ms": float(np.percentile(arr, 50) * 1000),
                "p90_ms": float(np.percentile(arr, 90) * 1000),
                "min_ms": float(arr.min() * 1000)}
