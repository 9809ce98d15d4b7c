"""Edge-gather statistics of the train-mode EdgeConv stage, with their
gradient (counterpart of sparenet_tpu/ops/pallas/edge_train_pallas.py).

``edge_gather_stats(table, idx)``: table [B, N, C] f32, idx [B, M, k] int32
-> (mx, mn, s1, s2), each [B, M, C]: per point the max, min, sum and sum of
squares of its k gathered rows. Differentiable in table: max and min send
their gradient to the first slot holding the extremum, the sum to every
slot, the sum of squares 2 r g. The forward and the backward each have a
kernel (``csrc/edge_stats.cu``) and a plain version; a CUDA tensor launches
the kernel, a CPU tensor runs the plain version.

Both versions round as the reference's interpret-mode program does: sums in
slot order from slot 0, s2 = fma(r0, r0, r1 * r1) then fma(r_j, r_j, s2); a
contribution is fma(2 r, gs2, gs1) + [first max slot] gmx + [first min slot]
gmn, and each table row sums its contributions in ascending (m, j) order
from 0 (the TPU kernel's grid order).
"""

from __future__ import annotations

import torch

from . import _lib
from .common import check_input, fma, is_cpu
from .gather import gather_rows

__all__ = ["edge_gather_stats", "edge_stats_fwd", "edge_stats_fwd_plain",
           "edge_stats_bwd", "edge_stats_bwd_plain", "first_slots"]


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    check_input("edge_gather_stats table", table, torch.float32, 3)
    check_input("edge_gather_stats idx", idx, torch.int32, 3)
    if idx.shape[0] != table.shape[0] or idx.device != table.device:
        raise ValueError("edge_gather_stats: table and idx differ in batch "
                         "or device")


def edge_stats_fwd_plain(table: torch.Tensor, idx: torch.Tensor):
    """Plain PyTorch version of the forward kernel."""
    _lib.PLAIN_CALLS["edge_stats_fwd"] += 1
    g = gather_rows(table, idx)                        # [B, M, k, C]
    r = g.unbind(2)
    s1 = r[0]
    s2 = r[0] * r[0]
    for j in range(1, len(r)):
        s1 = s1 + r[j]
        s2 = fma(r[0], r[0], r[1] * r[1]) if j == 1 else fma(r[j], r[j], s2)
    return g.amax(2), g.amin(2), s1, s2


def edge_stats_fwd(table: torch.Tensor, idx: torch.Tensor):
    """(mx, mn, s1, s2) of the gathered rows; see the module docstring."""
    _check(table, idx)
    if is_cpu(table):
        return edge_stats_fwd_plain(table, idx)
    b, n, c = table.shape
    m, k = idx.shape[1], idx.shape[2]
    outs = [torch.empty((b, m, c), dtype=torch.float32, device=table.device)
            for _ in range(4)]
    with torch.cuda.device(table.device):
        code = _lib.lib().spn_edge_stats_fwd(
            table.data_ptr(), idx.data_ptr(), b, n, m, c, k,
            *[o.data_ptr() for o in outs], _lib.stream_of(table))
    _lib.check(code, "edge_stats_fwd")
    _lib.LAUNCHES["edge_stats_fwd"] += 1
    return tuple(outs)


def first_slots(g: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """For gathered rows g [B, M, k, C] and an extremum ext [B, M, C]: a
    [B, M, k, C] mask of the first slot equal to ext (none if no slot is)."""
    hit = g == ext[:, :, None, :]
    first = hit.to(torch.uint8).argmax(2, keepdim=True)   # first True slot
    slots = torch.arange(g.shape[2], device=g.device)[None, None, :, None]
    return hit & (slots == first)


def edge_stats_bwd_plain(table, idx, mx, mn, gmx, gmn, gs1, gs2):
    """Plain PyTorch version of the backward kernel: the contribution of
    every (m, j), then one pass per rank r adding the r-th contribution of
    every table row (lists in ascending (m, j) order), so the sums run in
    the kernel's order on any device."""
    _lib.PLAIN_CALLS["edge_stats_bwd"] += 1
    b, n, c = table.shape
    _, m, k = idx.shape
    g = gather_rows(table, idx)                                # [B, M, k, C]
    zero = torch.zeros((), device=table.device)
    con = fma(2.0 * g, gs2[:, :, None, :], gs1[:, :, None, :].expand_as(g))
    con = con + torch.where(first_slots(g, mx), gmx[:, :, None, :], zero)
    con = con + torch.where(first_slots(g, mn), gmn[:, :, None, :], zero)
    con = con.reshape(b * m * k, c)
    # target row of every contribution, as one index into [B * N]
    tgt = (idx.long() + n * torch.arange(b, device=idx.device)[:, None, None]
           ).reshape(-1)
    order = torch.sort(tgt, stable=True).indices               # by row, then (m, j)
    sorted_t = tgt[order]
    start = torch.searchsorted(sorted_t, sorted_t, right=False)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=idx.device) - start
    out = torch.zeros((b * n, c), dtype=torch.float32, device=table.device)
    for r in range(int(rank.max()) + 1):
        sel = torch.nonzero(rank == r)[:, 0]
        out.index_add_(0, tgt[sel], con[sel])          # one entry per row
    return out.reshape(b, n, c)


def edge_stats_bwd(table, idx, mx, mn, gmx, gmn, gs1, gs2):
    """The table gradient of edge_gather_stats; see the module docstring."""
    _check(table, idx)
    b, n, c = table.shape
    m, k = idx.shape[1], idx.shape[2]
    for name, t in (("mx", mx), ("mn", mn), ("gmx", gmx), ("gmn", gmn),
                    ("gs1", gs1), ("gs2", gs2)):
        check_input(f"edge_stats_bwd {name}", t, torch.float32, 3)
        if t.shape != (b, m, c) or t.device != table.device:
            raise ValueError(f"edge_stats_bwd: {name} must be [B, M, C] on "
                             f"the table's device")
    if is_cpu(table):
        return edge_stats_bwd_plain(table, idx, mx, mn, gmx, gmn, gs1, gs2)
    dev = table.device
    lib = _lib.lib()
    route = torch.empty((b, m, c * lib.spn_edge_stats_route_bytes(k)),
                        dtype=torch.uint8, device=dev)
    cnt = torch.empty((b, n), dtype=torch.int32, device=dev)
    cursor = torch.empty((b, n), dtype=torch.int32, device=dev)
    offs = torch.empty((b, n + 1), dtype=torch.int32, device=dev)
    lst = torch.empty((b, m * k), dtype=torch.int32, device=dev)
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (table, idx, mx, mn, gmx, gmn, gs1, gs2)]
    with torch.cuda.device(dev):
        code = lib.spn_edge_stats_bwd(
            *ptrs, b, n, m, c, k, route.data_ptr(), cnt.data_ptr(),
            cursor.data_ptr(), offs.data_ptr(), lst.data_ptr(), out.data_ptr(),
            _lib.stream_of(table))
    _lib.check(code, "edge_stats_bwd")
    _lib.LAUNCHES["edge_stats_bwd"] += 1
    return out


class _EdgeGatherStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        mx, mn, s1, s2 = edge_stats_fwd(table, idx)
        ctx.save_for_backward(table, idx, mx, mn)
        return mx, mn, s1, s2

    @staticmethod
    def backward(ctx, gmx, gmn, gs1, gs2):
        table, idx, mx, mn = ctx.saved_tensors
        grads = [g.contiguous() for g in (gmx, gmn, gs1, gs2)]
        return edge_stats_bwd(table, idx, mx, mn, *grads), None


def edge_gather_stats(table: torch.Tensor, idx: torch.Tensor):
    """(mx, mn, s1, s2) [B, M, C] each; see the module docstring."""
    return _EdgeGatherStats.apply(table, idx)
