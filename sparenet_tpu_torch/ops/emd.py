"""Auction Earth Mover's Distance (counterpart of sparenet_tpu/ops/emd.py and
ops/pallas/emd_pallas.py).

``emd_bids(xyz1, xyz2, price, count=None)``: every bidder of xyz1 [B, M, 3]
scores the objects xyz2 [B, N, 3] as v = (3 - price) - |x1 - x2| and
returns (target [B, M] int32: the lowest index among the maxima; inc [B, M]
f32: best minus the largest value at any other index). With ``count`` [B]
int32 (on the tensors' device) only the first count[b] bidders of each
cloud are scored; the others get target 0 and inc 0. On a CUDA tensor it
launches ``csrc/emd_bids.cu`` (which reads the counts on the card); on a
CPU tensor it runs ``emd_bids_plain``. ``emd_bids_split`` is the kernel's
decomposition (object chunks scanned with its square-root pruning, then
merged in order) in plain PyTorch, for the tests; no path runs it.

``auction_assign`` runs the auction around it in plain PyTorch, on the
tensors' device: each round only the unassigned bidders bid (compacted, in
ascending id order, as the reference's ``_compact_resolve``: bit-identical
to a round where every bidder bids and the assigned ones are masked); per
object the largest increment wins, the lowest bidder within 1e-6 of it taking
the object (scatter_reduce amax / amin, deterministic); the previous owner is
unassigned and the price rises by the increment. Rounds run until no bidder
is unassigned or ``iters - 1`` rounds have run, then one forced round gives
every unassigned bidder its target. A round with no unassigned bidder
changes nothing, so running such rounds, or stopping at any of them, is
exact (the reference stops at the first, which keeps its 10000-round test
protocol short). The list stays at full width with the counts passed to
the bids, and on the card the loop reads no count on the host before it
runs a round: it copies each round's largest count to the host
asynchronously and stops at the first round whose copy has arrived and says
0. On the CPU, where a read costs no synchronisation, it reads the count.

``emd_auction(xyz1, xyz2, eps, iters)`` -> (dist [B, N] squared distance of
each matched pair, assignment [B, N] int32); its backward sends
2 g (x1 - x2[a]) to xyz1 only, as the reference does.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib
from .chamfer import gather_rows3, query_chunks
from .common import check_input, is_cpu, sqnorm3, sqdist_pairs, sqrt_ieee

__all__ = ["emd_bids", "emd_bids_plain", "emd_bids_split", "prune_bound",
           "auction_assign", "emd_auction"]

_NEG = -3.4e38  # the kernels' finite "-inf"


def _scored(target, inc, count):
    """target 0 and inc 0 past each cloud's count."""
    if count is None:
        return target, inc
    keep = torch.arange(target.shape[1], device=target.device) < count[:, None]
    return torch.where(keep, target, 0), torch.where(keep, inc, 0.0)


def emd_bids_plain(xyz1: torch.Tensor, xyz2: torch.Tensor,
                   price: torch.Tensor, count: torch.Tensor | None = None):
    """Plain PyTorch version of the bid kernel."""
    _lib.PLAIN_CALLS["emd_bids"] += 1
    pp = (3.0 - price)[:, None, :]
    b, m, _ = xyz1.shape
    u = m if count is None else min(m, max(1, int(count.max())))
    tgt = torch.zeros((b, m), dtype=torch.int32, device=xyz1.device)
    inc = torch.zeros((b, m), dtype=torch.float32, device=xyz1.device)
    for sl in query_chunks(b, u, xyz2.shape[1], xyz1.device):
        v = pp - sqrt_ieee(sqdist_pairs(xyz1[:, sl], xyz2))
        best_i = v.argmax(-1, keepdim=True)          # first maximal index
        best = v.gather(-1, best_i)
        second = v.scatter_(-1, best_i, _NEG).amax(-1, keepdim=True)
        tgt[:, sl] = best_i[..., 0].to(torch.int32)
        inc[:, sl] = (best - second)[..., 0]
    return _scored(tgt, inc, count)


def _sub_up(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b for f32 tensors rounded upward to f32 (as __fsub_ru): the f64
    difference and its exact error (TwoSum), then the f32 at or above."""
    a64, b64 = a.double(), -b.double()
    s = a64 + b64
    bb = s - a64
    err = (a64 - (s - bb)) + (b64 - bb)
    f = s.float()
    up = (f.double() < s) | ((f.double() == s) & (err > 0))
    return torch.where(up, torch.nextafter(f, torch.full_like(f, float("inf"))), f)


def _mul_up(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b for f32 tensors rounded upward to f32 (as __fmul_ru): the f64
    product is exact."""
    p = a.double() * b.double()
    f = p.float()
    return torch.where(f.double() < p,
                       torch.nextafter(f, torch.full_like(f, float("inf"))), f)


def prune_bound(pp: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """D = fmul_ru(A, |A|), A = fsub_ru(pp, second): the kernel skips the
    square root of a pair with d2 >= D, whose v cannot exceed second
    (csrc/emd_bids.cu, design 4)."""
    a = _sub_up(pp, second)
    return _mul_up(a, a.abs())


_SUB = 32  # objects a candidate mask of the bid kernel


def _chunk_scan(x1, x2, pp):
    """The kernel's scan of one object chunk with its square-root pruning:
    in each sub-tile of 32 objects, the candidates d2 < D at the second the
    sub-tile starts with, then those in ascending order with the exact
    updates: (best, index, second) [B, M]."""
    b, m, _ = x1.shape
    best = torch.full((b, m), _NEG, dtype=torch.float32, device=x1.device)
    second = best.clone()
    bi = torch.zeros((b, m), dtype=torch.long, device=x1.device)
    d2 = sqdist_pairs(x1, x2)                                  # [B, M, n]
    for j in range(x2.shape[1]):
        p = pp[:, j:j + 1].expand(b, m)
        if j % _SUB == 0:
            start = second
        take = d2[:, :, j] < prune_bound(p, start)
        v = p - sqrt_ieee(d2[:, :, j])
        above = take & (v > best)
        mid = take & ~above & (v > second)
        second = torch.where(above, best, torch.where(mid, v, second))
        best = torch.where(above, v, best)
        bi = torch.where(above, j, bi)
    return best, bi, second


def emd_bids_split(xyz1: torch.Tensor, xyz2: torch.Tensor,
                   price: torch.Tensor, bounds) -> tuple:
    """The bid kernel's decomposition (for the tests): the objects cut at
    ``bounds`` (ascending, from 0 to N), each chunk scanned as the kernel
    scans it, and the chunks' (best, index, second) merged in ascending
    order: a higher chunk's (b2, i2, s2) replaces (b1, i1, s1) by (b2, i2,
    max(b1, s2)) if b2 > b1, else gives (b1, i1, max(s1, b2)). Equals
    ``emd_bids_plain``."""
    pp = 3.0 - price
    best = bi = second = None
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        b2, i2, s2 = _chunk_scan(xyz1, xyz2[:, lo:hi], pp[:, lo:hi])
        if best is None:
            best, bi, second = b2, i2 + lo, s2
            continue
        higher = b2 > best
        second = torch.where(higher, torch.where(s2 > best, s2, best),
                             torch.where(b2 > second, b2, second))
        bi = torch.where(higher, i2 + lo, bi)
        best = torch.where(higher, b2, best)
    return bi.to(torch.int32), best - second


def emd_bids(xyz1: torch.Tensor, xyz2: torch.Tensor, price: torch.Tensor,
             count: torch.Tensor | None = None):
    """Auction bids; see the module docstring."""
    check_input("emd_bids xyz1", xyz1, torch.float32, 3, last=3)
    check_input("emd_bids xyz2", xyz2, torch.float32, 3, last=3)
    check_input("emd_bids price", price, torch.float32, 2)
    b, m, _ = xyz1.shape
    n = xyz2.shape[1]
    if (xyz2.shape[0] != b or price.shape != (b, n)
            or not xyz1.device == xyz2.device == price.device):
        raise ValueError("emd_bids: inputs differ in batch, size or device")
    if n < 2:
        raise ValueError(f"emd_bids: need at least 2 objects, got {n}")
    if count is not None:
        check_input("emd_bids count", count, torch.int32, 1)
        if count.shape != (b,) or count.device != xyz1.device:
            raise ValueError("emd_bids: count must be [B] on the inputs' device")
    if is_cpu(xyz1):
        return emd_bids_plain(xyz1, xyz2, price, count)
    lib = _lib.lib()
    dev = xyz1.device
    pp = (3.0 - price).contiguous()
    target = torch.empty((b, m), dtype=torch.int32, device=dev)
    inc = torch.empty((b, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        parts = lib.spn_emd_bids_scratch(b, m)
        part_best = torch.empty(parts, dtype=torch.float32, device=dev)
        part_idx = torch.empty(parts, dtype=torch.int32, device=dev)
        part_second = torch.empty(parts, dtype=torch.float32, device=dev)
        code = lib.spn_emd_bids(
            xyz1.data_ptr(), xyz2.data_ptr(), pp.data_ptr(),
            None if count is None else count.data_ptr(), b, m, n,
            part_best.data_ptr(), part_idx.data_ptr(), part_second.data_ptr(),
            target.data_ptr(), inc.data_ptr(), _lib.stream_of(xyz1))
    _lib.check(code, "emd_bids")
    _lib.LAUNCHES["emd_bids"] += 1
    return target, inc


def bids_plan(batch: int, m: int, n: int, u: int) -> dict:
    """The bid kernel's plan on the current card at u bidders to score:
    bidder tiles, object chunks, objects a chunk, blocks that work."""
    out = (ctypes.c_int * 4)()
    _lib.lib().spn_emd_bids_plan(batch, m, n, u, out)
    return dict(zip(("tiles", "splits", "chunk", "blocks"), out))


def _padded(t: torch.Tensor, fill) -> torch.Tensor:
    """t [B, n] with one more column (the sentinel slot n) holding fill."""
    return torch.cat([t, t.new_full((t.shape[0], 1), fill)], 1)


def _round(xyz1, xyz2, state, eps: float, last: bool):
    """One auction round over the list of unassigned bidders (reference:
    _compact_resolve), at full width with the counts passed to the bids."""
    assignment, owner, price = state
    b, n = assignment.shape
    unass = assignment < 0
    # unassigned ids first, ascending (stable sort of the assigned flag)
    ids = torch.sort((~unass).to(torch.uint8), dim=1, stable=True).indices
    count = unass.sum(1, dtype=torch.int32)
    valid = unass.gather(1, ids)
    ids = torch.where(valid, ids, n)
    x1c = gather_rows3(xyz1, ids.clamp_max(n - 1)).contiguous()
    target, raw = emd_bids(x1c, xyz2, price, count)
    t = torch.where(valid, target.long(), n)
    if last:
        a = _padded(assignment, -1).scatter_(1, torch.where(valid, ids, n), t)
        return a[:, :n], owner, price
    inc = raw + eps
    slot = torch.arange(n, device=ids.device).repeat(b, 1)
    max_inc = torch.full((b, n + 1), float("-inf"), device=ids.device)
    max_inc.scatter_reduce_(1, t, torch.where(valid, inc, float("-inf")), "amax")
    eligible = valid & (inc >= max_inc.gather(1, t) - 1e-6)
    win = torch.full((b, n + 1), n, dtype=torch.long, device=ids.device)
    win.scatter_reduce_(1, torch.where(eligible, t, n), slot, "amin")
    won = eligible & (win.gather(1, t) == slot)
    wid = torch.where(won, ids, n)
    wtgt = torch.where(won, t, n)
    # unassign the previous owners of the won objects, then assign winners
    old = torch.where(won, owner.gather(1, wtgt.clamp_max(n - 1)), -1)
    a = _padded(assignment, -1)
    a.scatter_(1, torch.where(old >= 0, old, n), -1)
    a.scatter_(1, wid, t)
    o = _padded(owner, -1).scatter_(1, wtgt, ids)
    p = _padded(price, 0.0).scatter_add_(1, wtgt, torch.where(won, inc, 0.0))
    return a[:, :n], o[:, :n], p[:, :n].contiguous()


class _Arrivals:
    """Each round's largest unassigned count, copied to the host without a
    synchronisation (a pinned buffer, from PyTorch's caching host
    allocator, and an event a round on the stream of the tensors' device,
    which the copies take); ``zero()`` is True once a copy that has arrived
    says 0. Copies arrive in order (one stream); a slot no copy has reached
    holds -1."""

    def __init__(self, rounds: int, device: torch.device):
        self.stream = torch.cuda.current_stream(device)
        self.host = torch.full((rounds,), -1, dtype=torch.int64,
                               pin_memory=True)
        self.events: list = []
        self.seen = 0                       # copies read so far

    def record(self, assignment: torch.Tensor) -> None:
        r = len(self.events)
        self.host[r:r + 1].copy_((assignment < 0).sum(1).amax().reshape(1),
                                 non_blocking=True)
        self.events.append(torch.cuda.Event())
        self.events[-1].record(self.stream)

    def zero(self) -> bool:
        while self.seen < len(self.events) and self.events[self.seen].query():
            if int(self.host[self.seen]) == 0:
                return True
            self.seen += 1
        return False


def auction_assign(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float,
                   iters: int) -> torch.Tensor:
    """The auction's assignment [B, N] int32 of xyz1 [B, N, 3] to xyz2."""
    xyz1, xyz2 = xyz1.detach(), xyz2.detach()
    if xyz1.shape != xyz2.shape:
        raise ValueError(f"emd: clouds differ in shape: {tuple(xyz1.shape)} "
                         f"and {tuple(xyz2.shape)}")
    b, n, _ = xyz1.shape
    dev = xyz1.device
    state = (torch.full((b, n), -1, dtype=torch.long, device=dev),
             torch.full((b, n), -1, dtype=torch.long, device=dev),
             torch.zeros((b, n), dtype=torch.float32, device=dev))
    arrivals = None if is_cpu(xyz1) else _Arrivals(iters, dev)
    for r in range(iters):
        if arrivals is None:
            if not bool((state[0] < 0).any()):      # free on the CPU
                break
        elif arrivals.zero():
            break
        else:
            arrivals.record(state[0])
        state = _round(xyz1, xyz2, state, eps, last=r == iters - 1)
    return state[0].to(torch.int32)


class _EMD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2, eps, iters):
        assignment = auction_assign(xyz1, xyz2, eps, iters)
        dist = sqnorm3(xyz1 - gather_rows3(xyz2, assignment.clamp_min(0)))
        ctx.save_for_backward(xyz1, xyz2, assignment)
        ctx.mark_non_differentiable(assignment)
        return dist, assignment

    @staticmethod
    def backward(ctx, g, _ga):
        xyz1, xyz2, assignment = ctx.saved_tensors
        matched = gather_rows3(xyz2, assignment.clamp_min(0))
        return 2.0 * g[..., None] * (xyz1 - matched), None, None, None


def emd_auction(xyz1: torch.Tensor, xyz2: torch.Tensor, eps: float = 0.005,
                iters: int = 50):
    """(dist [B, N], assignment [B, N] int32); see the module docstring."""
    return _EMD.apply(xyz1, xyz2, eps, iters)
