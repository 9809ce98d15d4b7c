"""Neighbour gather + max over k (counterpart of
sparenet_tpu/ops/pallas/gather_pallas.py:gather_rows_max).

``gather_max(table, idx, need_sum)``: out[b, m] = max_j table[b, idx[b, m, j]]
for table [B, N, C] f32 and idx [B, M, k] int32 with values in [0, N); with
``need_sum`` also the f32 sum [B, C] of every gathered row. On a CUDA tensor
it launches ``csrc/gather_max.cu``; on a CPU tensor it runs
``gather_max_plain``.

The kernel holds a channel slice of each cloud's table in shared memory
(``csrc/slices.cuh``; ``common.slice_plan`` reads its plan for a shape from
the kernel library). Its sum is taken in a fixed order, the same on every
run; ``gather_max_sum_blocks_plain`` is that order in plain PyTorch.
"""

from __future__ import annotations

import functools

import torch

from . import _lib
from .common import check_input, is_cpu

__all__ = ["gather_max", "gather_max_plain", "gather_max_sum_blocks_plain",
           "gather_rows", "partial_rows"]


@functools.lru_cache(maxsize=256)
def partial_rows(device: int, b: int, n: int, m: int, c: int, k: int) -> int:
    """Rows of the partial sums [b, rows, c] the kernel takes with the sum
    on card ``device`` (0: none); asked of the kernel library once a shape."""
    rows = _lib.lib().spn_gather_partial_rows(b, n, m, c, k)
    if rows < 0:
        _lib.check(-rows, "gather_max")
    return rows


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


def gather_max_sum_blocks_plain(table: torch.Tensor, idx: torch.Tensor,
                                lanes: int, group_rows: int):
    """(max, sum) as the slice kernel takes them under a plan of ``lanes``
    row lanes and ``group_rows`` rows a group: a row lane q of a group
    adds, from 0, the slots of its rows (the group's rows q, q + lanes, ...)
    in slot order; the lanes are added by a halving tree (lane q + lane
    q + h, h = lanes / 2, ..., 1); one group's tree is the sum, several
    groups' trees are added in group order from 0. The max is
    gather_max_plain's."""
    b, m, k = idx.shape
    c = table.shape[-1]
    groups = -(-m // group_rows)
    g = gather_rows(table, idx)
    out = g.amax(2)
    pad = g.new_zeros(b, groups * group_rows - m, k, c)   # rows past M add 0
    g = torch.cat([g, pad], 1).reshape(b, groups, group_rows // lanes, lanes,
                                        k, c)
    acc = g.new_zeros(b, groups, lanes, c)
    for chunk in range(group_rows // lanes):
        for j in range(k):
            acc = acc + g[:, :, chunk, :, j]
    while acc.shape[2] > 1:
        h = acc.shape[2] // 2
        acc = acc[:, :, :h] + acc[:, :, h:]
    if groups == 1:
        return out, acc[:, 0, 0]
    s = g.new_zeros(b, c)
    for gi in range(groups):
        s = s + acc[:, gi, 0]
    return out, s


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
    with torch.cuda.device(table.device):
        if need_sum:
            rows = partial_rows(table.device.index, b, n, m, c, k)
            s = torch.empty((b, c), dtype=torch.float32, device=table.device)
            if rows:
                partial = torch.empty((b, rows, c), dtype=torch.float32,
                                      device=table.device)
        code = lib.spn_gather_max(
            table.data_ptr(), idx.data_ptr(), b, n, m, c, k, out.data_ptr(), None if partial is None else partial.data_ptr(),
            None if s is None else s.data_ptr(), _lib.stream_of(table))
    _lib.check(code, "gather_max")
    _lib.LAUNCHES["gather_max"] += 1
    return (out, s) if need_sum else out
