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

import ctypes

import torch

from . import _lib
from .common import check_input, fma, is_cpu
from .gather import gather_rows

__all__ = ["edge_gather_stats", "edge_stats_fwd", "edge_stats_fwd_plain",
           "edge_stats_bwd", "edge_stats_bwd_plain", "first_slots",
           "inverse_lists_plain", "radix_lists_plain",
           "edge_stats_bwd_lists_plain", "lists_scratch_ints", "LIST_WARPS",
           "SORT_THREADS", "SORT_ITEMS", "DIGIT_BITS", "SLICE"]

# the kernel's list builds (csrc/edge_stats.cu): warps of the device-memory
# counting sort (kListWarps); threads, keys a thread and digit bits of the
# shared-memory radix sort (kSortThreads, kSortItems, kDigitBits)
LIST_WARPS = 8
SORT_THREADS, SORT_ITEMS, DIGIT_BITS = 1024, 24, 4
# channels a warp of the kernel's route and accumulation passes (32 lanes of
# 4 channels; 32 where C % 4 != 0)
SLICE = 128


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
    """(mx, mn, s1, s2) of the gathered rows; see the module docstring. The
    kernel holds a channel slice of each cloud's table in shared memory
    (csrc/slices.cuh; its plan: ops/common.py:slice_plan)."""
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


def lists_scratch_ints(b: int, n: int, m: int, k: int) -> int:
    """Device-memory scratch (ints) of the kernel's inverse lists: 0 where
    they are built in shared memory (csrc/edge_stats.cu:
    spn_edge_stats_lists)."""
    out = (ctypes.c_longlong * 1)()
    _lib.lib().spn_edge_stats_lists(b, n, m, k, out)
    return int(out[0])


def radix_lists_plain(idx: torch.Tensor, n: int, threads: int = SORT_THREADS,
                      items: int = SORT_ITEMS, digit_bits: int = DIGIT_BITS):
    """The kernel's inverse lists as its shared-memory path builds them (at
    most ``threads * items`` slots a cloud): keys (target, flat slot), a
    slot naming no row in [0, n) keyed past every target; passes over the
    target's digits, least significant first, ceil(bit length of n /
    digit_bits) of them; in each, thread i holds keys [i * items, (i + 1) *
    items) and a key goes to the count of lower digits, plus the keys of
    its digit in earlier threads, plus those earlier in its own thread.
    -> (offs [B, n + 1], lists [B, M * k]) int32, as inverse_lists_plain."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1).long()
    mk, size = flat.shape[1], threads * items
    if mk > size:
        raise ValueError(f"{mk} slots a cloud: more than {size}")
    passes = -(-n.bit_length() // digit_bits)
    none = (1 << (digit_bits * passes)) - 1
    radix = 1 << digit_bits
    thread = torch.arange(size) // items
    offs = torch.zeros((b, n + 1), dtype=torch.long)
    lists = torch.zeros((b, mk), dtype=torch.long)
    for bi in range(b):
        tf = torch.full((size,), none, dtype=torch.long)
        tf[:mk] = flat[bi].where((flat[bi] >= 0) & (flat[bi] < n), none)
        slot = torch.arange(size)
        for p in range(passes):
            d = (tf >> (p * digit_bits)) & (radix - 1)
            cnt = torch.zeros((radix, threads), dtype=torch.long)
            cnt.index_put_((d, thread), torch.ones(size, dtype=torch.long),
                           accumulate=True)
            excl = (cnt.reshape(-1).cumsum(0) - cnt.reshape(-1)).reshape(radix, threads)
            onehot = torch.nn.functional.one_hot(d, radix).reshape(threads, items, radix)
            before = (onehot.cumsum(1) - onehot).reshape(size, radix)
            pos = excl[d, thread] + before.gather(1, d[:, None])[:, 0]
            new_tf, new_slot = torch.empty_like(tf), torch.empty_like(slot)
            new_tf[pos], new_slot[pos] = tf, slot
            tf, slot = new_tf, new_slot
        valid = tf < none
        offs[bi] = torch.searchsorted(tf[valid], torch.arange(n + 1))
        lists[bi, :int(valid.sum())] = slot[valid]
    return offs.to(torch.int32), lists.to(torch.int32)


def inverse_lists_plain(idx: torch.Tensor, n: int, warps: int = LIST_WARPS):
    """The kernel's inverse lists as its device-memory path builds them
    (any size): the flat slots e = m * k + j of each cloud cut into
    ``warps`` contiguous segments; each segment's target counts; the counts
    scanned over (target, segment); each segment's slots placed in order,
    32 at a time, equal targets within the 32 ranked by slot. -> (offs
    [B, n + 1], lists [B, M * k]) int32: the slots naming target t are
    lists[b, offs[b, t]:offs[b, t + 1]], ascending (torch.sort's stable
    order); a slot naming no row in [0, n) is in no list."""
    b = idx.shape[0]
    flat = idx.reshape(b, -1).long()
    mk = flat.shape[1]
    seg = -(-mk // warps)
    offs = torch.zeros((b, n + 1), dtype=torch.long)
    lists = torch.zeros((b, mk), dtype=torch.long)
    for bi in range(b):
        t = flat[bi].where((flat[bi] >= 0) & (flat[bi] < n), -1)
        segs = [torch.arange(min(mk, w * seg), min(mk, (w + 1) * seg))
                for w in range(warps)]
        cnt = torch.stack([torch.bincount(t[e][t[e] >= 0], minlength=n)
                           for e in segs])                      # [warps, n]
        tot = cnt.sum(0)
        offs[bi, 1:] = tot.cumsum(0)
        cursor = offs[bi, :n][None] + cnt.cumsum(0) - cnt
        for w, e in enumerate(segs):
            for s0 in range(0, e.numel(), 32):
                step = e[s0:s0 + 32]
                ts = t[step]
                for lane in range(step.numel()):
                    if ts[lane] >= 0:
                        rank = int((ts[:lane] == ts[lane]).sum())
                        lists[bi, cursor[w, ts[lane]] + rank] = step[lane]
                for v in ts[ts >= 0].unique():
                    cursor[w, v] += int((ts == v).sum())
    return offs.to(torch.int32), lists.to(torch.int32)


def edge_stats_bwd_lists_plain(table, idx, mx, mn, gmx, gmn, gs1, gs2,
                               width: int = SLICE):
    """The kernel's backward in plain PyTorch: route codes (the first slot
    equal to mx and to mn), the inverse lists of ``inverse_lists_plain``,
    and per channel slice of ``width`` each row's contributions summed in
    list order from +0. Equal to edge_stats_bwd_plain for any width."""
    b, n, c = table.shape
    k = idx.shape[2]
    g = gather_rows(table, idx)                                # [B, M, k, C]
    slots = torch.arange(k)[None, None, :, None]
    none = torch.full((), k)
    jmax = torch.where(first_slots(g, mx), slots, none).amin(2)  # [B, M, C]
    jmin = torch.where(first_slots(g, mn), slots, none).amin(2)
    offs, lists = inverse_lists_plain(idx, n)
    offs, lists = offs.long(), lists.long()
    deg = offs[:, 1:] - offs[:, :-1]                           # [B, n]
    out = torch.zeros_like(table)
    zero = torch.zeros(())
    for s0 in range(0, c, width):
        sl = slice(s0, min(c, s0 + width))
        row2 = 2.0 * table[:, :, sl]
        acc = torch.zeros_like(row2)
        for r in range(int(deg.max()) if deg.numel() else 0):
            bi, t = torch.nonzero(deg > r, as_tuple=True)
            f = lists[bi, offs[bi, t] + r]
            m, j = f // k, f % k
            con = fma(row2[bi, t], gs2[bi, m, sl], gs1[bi, m, sl])
            con = con + torch.where(jmax[bi, m, sl] == j[:, None], gmx[bi, m, sl], zero)
            con = con + torch.where(jmin[bi, m, sl] == j[:, None], gmn[bi, m, sl], zero)
            acc[bi, t] = acc[bi, t] + con
        out[:, :, sl] = acc
    return out


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
    ptrs = [t.data_ptr() for t in (table, idx, mx, mn, gmx, gmn, gs1, gs2)]
    with torch.cuda.device(dev):
        route = torch.empty((b, m, c * lib.spn_edge_stats_route_bytes(k)),
                            dtype=torch.uint8, device=dev)
        offs = torch.empty((b, n + 1), dtype=torch.int32, device=dev)
        lst = torch.empty((b, m * k), dtype=torch.int32, device=dev)
        order = torch.empty((b, n), dtype=torch.int32, device=dev)
        scratch = torch.empty(lists_scratch_ints(b, n, m, k), dtype=torch.int32,
                              device=dev)
        out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
        code = lib.spn_edge_stats_bwd(
            *ptrs, b, n, m, c, k, route.data_ptr(), offs.data_ptr(),
            lst.data_ptr(), order.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            out.data_ptr(), _lib.stream_of(table))
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
