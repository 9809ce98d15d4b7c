"""Auction Earth Mover's Distance (counterpart of sparenet_tpu/ops/emd.py and
ops/pallas/emd_pallas.py).

``emd_bids(xyz1, xyz2, price)``: every bidder of xyz1 [B, M, 3] scores the
objects xyz2 [B, N, 3] as v = (3 - price) - |x1 - x2| and returns (target
[B, M] int32: the lowest index among the maxima; inc [B, M] f32: best minus
the largest value at any other index). On a CUDA tensor it launches
``csrc/emd_bids.cu``; on a CPU tensor it runs ``emd_bids_plain``.

``auction_assign`` runs the auction around it in plain PyTorch, on the
tensors' device: each round only the unassigned bidders bid (compacted, in
ascending id order, as the reference's ``_compact_resolve``: bit-identical
to a round where every bidder bids and the assigned ones are masked); per
object the largest increment wins, the lowest bidder within 1e-6 of it taking
the object (scatter_reduce amax / amin, deterministic); the previous owner is
unassigned and the price rises by the increment. Rounds run until no bidder
is unassigned or ``iters - 1`` rounds have run, then one forced round gives
every unassigned bidder its target. A round with no unassigned bidder
changes nothing, so stopping on a host check of the unassigned count is
exact; the check reads one integer a round (a synchronisation).

``emd_auction(xyz1, xyz2, eps, iters)`` -> (dist [B, N] squared distance of
each matched pair, assignment [B, N] int32); its backward sends
2 g (x1 - x2[a]) to xyz1 only, as the reference does.
"""

from __future__ import annotations

import torch

from . import _lib
from .chamfer import gather_rows3, query_chunks
from .common import check_input, is_cpu, sqnorm3, sqdist_pairs, sqrt_ieee

__all__ = ["emd_bids", "emd_bids_plain", "auction_assign", "emd_auction"]

_NEG = -3.4e38  # the kernels' finite "-inf"


def emd_bids_plain(xyz1: torch.Tensor, xyz2: torch.Tensor,
                   price: torch.Tensor):
    """Plain PyTorch version of the bid kernel."""
    _lib.PLAIN_CALLS["emd_bids"] += 1
    pp = (3.0 - price)[:, None, :]
    b, m, _ = xyz1.shape
    tgt, inc = [], []
    for sl in query_chunks(b, m, xyz2.shape[1]):
        v = pp - sqrt_ieee(sqdist_pairs(xyz1[:, sl], xyz2))
        best_i = v.argmax(-1, keepdim=True)          # first maximal index
        best = v.gather(-1, best_i)
        second = v.scatter_(-1, best_i, _NEG).amax(-1, keepdim=True)
        tgt.append(best_i[..., 0])
        inc.append((best - second)[..., 0])
    return torch.cat(tgt, 1).to(torch.int32), torch.cat(inc, 1)


def emd_bids(xyz1: torch.Tensor, xyz2: torch.Tensor, price: torch.Tensor):
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
    if is_cpu(xyz1):
        return emd_bids_plain(xyz1, xyz2, price)
    pp = (3.0 - price).contiguous()
    target = torch.empty((b, m), dtype=torch.int32, device=xyz1.device)
    inc = torch.empty((b, m), dtype=torch.float32, device=xyz1.device)
    with torch.cuda.device(xyz1.device):
        code = _lib.lib().spn_emd_bids(
            xyz1.data_ptr(), xyz2.data_ptr(), pp.data_ptr(), b, m, n,
            target.data_ptr(), inc.data_ptr(), _lib.stream_of(xyz1))
    _lib.check(code, "emd_bids")
    _lib.LAUNCHES["emd_bids"] += 1
    return target, inc


def _padded(t: torch.Tensor, fill) -> torch.Tensor:
    """t [B, n] with one more column (the sentinel slot n) holding fill."""
    return torch.cat([t, t.new_full((t.shape[0], 1), fill)], 1)


def _round(xyz1, xyz2, state, eps: float, u: int, last: bool):
    """One auction round over the u-wide compacted list of unassigned
    bidders (reference: _compact_resolve)."""
    assignment, owner, price = state
    b, n = assignment.shape
    unass = assignment < 0
    # unassigned ids first, ascending (stable sort of the assigned flag)
    ids = torch.sort((~unass).to(torch.uint8), dim=1,
                     stable=True).indices[:, :u]
    valid = unass.gather(1, ids)
    ids = torch.where(valid, ids, n)
    x1c = gather_rows3(xyz1, ids.clamp_max(n - 1)).contiguous()
    target, raw = emd_bids(x1c, xyz2, price)
    t = torch.where(valid, target.long(), n)
    if last:
        a = _padded(assignment, -1).scatter_(1, torch.where(valid, ids, n), t)
        return a[:, :n], owner, price
    inc = raw + eps
    slot = torch.arange(u, device=ids.device).repeat(b, 1)
    max_inc = torch.full((b, n + 1), float("-inf"), device=ids.device)
    max_inc.scatter_reduce_(1, t, torch.where(valid, inc, float("-inf")), "amax")
    eligible = valid & (inc >= max_inc.gather(1, t) - 1e-6)
    win = torch.full((b, n + 1), u, dtype=torch.long, device=ids.device)
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
    for r in range(iters):
        u = int((state[0] < 0).sum(1).max())     # host check, one a round
        if u == 0:
            break
        state = _round(xyz1, xyz2, state, eps, u, last=r == iters - 1)
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
