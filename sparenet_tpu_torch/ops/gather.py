"""Neighbour gather + max over k (counterpart of
sparenet_tpu/ops/pallas/gather_pallas.py:gather_rows_max).

``gather_max(table, idx, need_sum)``: out[b, m] = max_j table[b, idx[b, m, j]]
for table [B, N, C] f32 and idx [B, M, k] int32 with values in [0, N); with
``need_sum`` also the f32 sum [B, C] of every gathered row. On a CUDA tensor
it launches ``csrc/gather_max.cu``; on a CPU tensor it runs
``gather_max_plain``.
"""

from __future__ import annotations

import torch

from . import _lib
from .common import check_input, is_cpu

__all__ = ["gather_max", "gather_max_plain", "gather_rows"]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [B, N, C], idx [B, M, k] -> the gathered rows [B, M, k, C]."""
    b, m, k = idx.shape
    c = table.shape[-1]
    flat = idx.reshape(b, m * k, 1).long().expand(b, m * k, c)
    return torch.gather(table, 1, flat).reshape(b, m, k, c)


def gather_max_plain(table: torch.Tensor, idx: torch.Tensor,
                     need_sum: bool = False):
    """Plain PyTorch version of the gather-max kernel."""
    _lib.PLAIN_CALLS["gather_max"] += 1
    g = gather_rows(table, idx)
    out = g.amax(2)
    if not need_sum:
        return out
    return out, g.sum((1, 2))


def gather_max(table: torch.Tensor, idx: torch.Tensor, need_sum: bool = False):
    """max over gathered rows; see the module docstring."""
    check_input("gather_max table", table, torch.float32, 3)
    check_input("gather_max idx", idx, torch.int32, 3)
    b, n, c = table.shape
    _, m, k = idx.shape
    if idx.shape[0] != b or idx.device != table.device:
        raise ValueError("gather_max: table and idx differ in batch or device")
    if is_cpu(table):
        return gather_max_plain(table, idx, need_sum)
    lib = _lib.lib()
    out = torch.empty((b, m, c), dtype=torch.float32, device=table.device)
    partial = s = None
    if need_sum:
        nblk = -(-m // lib.spn_gather_rows_per_block())
        partial = torch.empty((b, nblk, c), dtype=torch.float32,
                              device=table.device)
        s = torch.empty((b, c), dtype=torch.float32, device=table.device)
    with torch.cuda.device(table.device):
        code = lib.spn_gather_max(
            table.data_ptr(), idx.data_ptr(), b, n, m, c, k, out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if s is None else s.data_ptr(), _lib.stream_of(table))
    _lib.check(code, "gather_max")
    _lib.LAUNCHES["gather_max"] += 1
    return (out, s) if need_sum else out
