"""Exact greedy minimum-density sampling and point gathering (counterpart of
sparenet_tpu/ops/mds.py: _mds_one and gather_points).

``minimum_density_sample(xyz, npoint, mean_mst_length)``: xyz [B, N, 3] f32,
mean_mst_length [B] -> idx [B, npoint] int32. Pick 0 is point 0, pinned to
1e9; each step adds w * exp(-d2 / t) to every density (t = 5 * mml^2, d2 the
squared distance to the previous pick, w = 2 for index >= 8192), picks the
lowest-index argmin and pins it to 1e9. On a CUDA tensor it launches
``csrc/mds.cu``; on a CPU tensor it runs ``mds_plain``.

The density term exp(-d2 / t) is flushed to 0 below the smallest normal
f32, as the reference computes it: its XLA CPU and TPU programs have no
subnormals. Far points then add exactly 0, and which points tie at density 0
decides the lowest-index picks of the early steps.
"""

from __future__ import annotations

import torch

from . import _lib
from .common import check_input, is_cpu, sqdist3

__all__ = ["minimum_density_sample", "mds_plain", "gather_points"]

_BIG = 1e9
_HEAVY_FROM = 8192  # points at index >= this get 2x density weight
_TINY = torch.finfo(torch.float32).tiny  # smallest normal f32


def _temperature(mean_mst_length: torch.Tensor) -> torch.Tensor:
    return 5.0 * mean_mst_length * mean_mst_length


def mds_plain(xyz: torch.Tensor, npoint: int,
              mean_mst_length: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the MDS kernel (one step per pick)."""
    _lib.PLAIN_CALLS["mds"] += 1
    b, n, _ = xyz.shape
    dev = xyz.device
    # a [B, 1] tensor: tensor / tensor is an IEEE division on every device
    t = _temperature(mean_mst_length).reshape(b, 1)
    weight = torch.where(torch.arange(n, device=dev) >= _HEAVY_FROM, 2.0, 1.0)
    temp = torch.zeros((b, n), dtype=torch.float32, device=dev)
    temp[:, 0] = _BIG
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    last = torch.zeros(b, dtype=torch.long, device=dev)
    for j in range(1, npoint):
        d2 = sqdist3(xyz - xyz[rows, last][:, None, :])
        e = torch.exp(-d2 / t)
        e = torch.where(e < _TINY, 0.0, e)
        temp = temp + weight * e
        nxt = temp.argmin(1)
        temp[rows, nxt] = _BIG
        idx[:, j] = nxt.to(torch.int32)
        last = nxt
    return idx


def minimum_density_sample(xyz: torch.Tensor, npoint: int,
                           mean_mst_length: torch.Tensor) -> torch.Tensor:
    """Greedy MDS indices; see the module docstring."""
    check_input("minimum_density_sample xyz", xyz, torch.float32, 3, last=3)
    b, n, _ = xyz.shape
    if mean_mst_length.shape != (b,) or mean_mst_length.device != xyz.device:
        raise ValueError("minimum_density_sample: mean_mst_length must be [B] "
                         "on xyz's device")
    if not 1 <= npoint <= n:
        raise ValueError(f"minimum_density_sample: npoint={npoint} not in [1, {n}]")
    if is_cpu(xyz):
        return mds_plain(xyz, npoint, mean_mst_length)
    lib = _lib.lib()
    if n > lib.spn_mds_max_points():
        raise ValueError(f"minimum_density_sample: the CUDA kernel takes "
                         f"N <= {lib.spn_mds_max_points()}, got {n}")
    t = _temperature(mean_mst_length.to(torch.float32)).contiguous()
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        code = lib.spn_mds(xyz.data_ptr(), t.data_ptr(), b, n, npoint,
                           out.data_ptr(), _lib.stream_of(xyz))
    _lib.check(code, "mds")
    _lib.LAUNCHES["mds"] += 1
    return out


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [B, N, C], idx [B, M] -> [B, M, C] (plain indexing)."""
    c = features.shape[-1]
    return torch.gather(features, 1, idx.long()[..., None].expand(-1, -1, c))
