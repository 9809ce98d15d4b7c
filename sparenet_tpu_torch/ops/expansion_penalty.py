"""Expansion penalty, forward (counterpart of
sparenet_tpu/ops/expansion_penalty.py).

Per primitive (a contiguous block of ``primitive_size`` points):
  1. Prim's MST from local point 0 on Euclidean (not squared) distances,
     strict < relaxation, lowest-index argmin;
  2. parallel leaf pruning charges each edge to the endpoint pruned first
     (an edge whose two endpoints are leaves together goes to the higher
     vertex);
  3. edges longer than alpha * (mean edge length) set dist[charged] to their
     length and assignment[charged] to the global index of the other end.

``mst_charges`` runs steps 1-2 (``csrc/expansion.cu`` on a CUDA tensor,
``mst_charges_plain`` on a CPU one); ``expansion_penalty`` adds step 3 in
plain PyTorch around it. Its backward is the reference's, quirk included:
grad xyz[u] = 2 g[u] (xyz[u] - xyz[assignment[u]]) for the charged endpoints
u only (the squared-distance gradient applied to the unsquared distance);
mean_mst_length carries no gradient.
"""

from __future__ import annotations

import torch

from . import _lib
from .common import check_input, is_cpu, sqdist3, sqrt_ieee

__all__ = ["expansion_penalty", "mst_charges", "mst_charges_plain"]

_BIG = 1e9


def _prune_edges(parent: torch.Tensor) -> torch.Tensor:
    """Leaf-pruning rounds on the parent-pointer edge list (reference:
    _prune_edges). parent [BP, S] -> charged [BP, S] (0 at the root)."""
    bp, s = parent.shape
    eu = torch.arange(1, s, device=parent.device).expand(bp, s - 1)
    ev = parent[:, 1:].long()
    alive = torch.ones((bp, s - 1), dtype=torch.bool, device=parent.device)
    charged = torch.zeros((bp, s - 1), dtype=torch.long, device=parent.device)
    while bool(alive.any()):
        a = alive.long()
        deg = torch.zeros((bp, s), dtype=torch.long, device=parent.device)
        deg.scatter_add_(1, ev, a)                     # alive child edges
        deg[:, 1:] += a                                # each vertex's own edge
        u_leaf = alive & (deg[:, 1:] == 1)
        v_leaf = alive & (deg.gather(1, ev) == 1)
        kill = u_leaf | v_leaf
        chosen = torch.where(u_leaf & v_leaf, torch.maximum(eu, ev),
                             torch.where(u_leaf, eu, ev))
        charged = torch.where(kill, chosen, charged)
        alive = alive & ~kill
    out = torch.zeros((bp, s), dtype=torch.int32, device=parent.device)
    out[:, 1:] = charged.to(torch.int32)
    return out


def mst_charges_plain(xyz: torch.Tensor):
    """Plain PyTorch version of the expansion kernel: xyz [BP, S, 3] ->
    (parent [BP, S] int32, cost [BP, S] f32, charged [BP, S] int32)."""
    _lib.PLAIN_CALLS["expansion"] += 1
    bp, s, _ = xyz.shape
    dev = xyz.device
    rows = torch.arange(bp, device=dev)
    visited = torch.zeros((bp, s), dtype=torch.bool, device=dev)
    visited[:, 0] = True
    cur_dis = torch.full((bp, s), _BIG, dtype=torch.float32, device=dev)
    cur_idx = torch.zeros((bp, s), dtype=torch.long, device=dev)
    parent = torch.zeros((bp, s), dtype=torch.long, device=dev)
    cost = torch.zeros((bp, s), dtype=torch.float32, device=dev)
    last = torch.zeros(bp, dtype=torch.long, device=dev)
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    for _ in range(s - 1):
        d = sqrt_ieee(sqdist3(xyz - xyz[rows, last][:, None, :]))
        closer = ~visited & (d < cur_dis)
        cur_dis = torch.where(closer, d, cur_dis)
        cur_idx = torch.where(closer, last[:, None], cur_idx)
        masked = torch.where(visited, big, cur_dis)
        nxt = masked.argmin(1)
        visited[rows, nxt] = True
        parent[rows, nxt] = cur_idx[rows, nxt]
        cost[rows, nxt] = masked[rows, nxt]
        last = nxt
    parent = parent.to(torch.int32)
    return parent, cost, _prune_edges(parent)


def mst_charges(xyz: torch.Tensor):
    """Prim's MST + leaf-prune charges per primitive: xyz [BP, S, 3] f32 ->
    (parent, cost, charged), each [BP, S]; see csrc/expansion.cu."""
    xyz = xyz.detach()
    check_input("mst_charges xyz", xyz, torch.float32, 3, last=3)
    bp, s, _ = xyz.shape
    if s < 2:
        raise ValueError(f"mst_charges: primitive size must be >= 2, got {s}")
    if is_cpu(xyz):
        return mst_charges_plain(xyz)
    if s > 1024:
        raise ValueError(f"mst_charges: the CUDA kernel takes S <= 1024, got {s}")
    parent = torch.empty((bp, s), dtype=torch.int32, device=xyz.device)
    cost = torch.empty((bp, s), dtype=torch.float32, device=xyz.device)
    charged = torch.empty((bp, s), dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        code = _lib.lib().spn_expansion(
            xyz.data_ptr(), bp, s, parent.data_ptr(), cost.data_ptr(),
            charged.data_ptr(), _lib.stream_of(xyz))
    _lib.check(code, "expansion")
    _lib.LAUNCHES["expansion"] += 1
    return parent, cost, charged


def _penalty(xyz: torch.Tensor, primitive_size: int, alpha: float):
    b, n, _ = xyz.shape
    s = primitive_size
    if n % s:
        raise ValueError(f"expansion_penalty: N={n} is not a multiple of {s}")
    n_prim = n // s
    bp = b * n_prim
    parent, cost, charged = mst_charges(xyz.reshape(bp, s, 3))
    ec = cost[:, 1:]
    ch = charged[:, 1:].long()
    mean_dis = ec.sum(-1) / (s - 1)                              # [BP]
    over = ec > alpha * mean_dis[:, None]
    eu = torch.arange(1, s, device=xyz.device).expand(bp, s - 1)
    ev = parent[:, 1:].long()
    other = torch.where(ch == eu, ev, eu)
    dist = torch.zeros((bp, s), dtype=xyz.dtype, device=xyz.device)
    dist.scatter_add_(1, ch, torch.where(over, ec, torch.zeros_like(ec)))
    assignment = torch.full((bp, s), -1, dtype=torch.long, device=xyz.device)
    assignment.scatter_reduce_(1, ch, torch.where(over, other, -1), "amax")
    prim_base = (torch.arange(bp, device=xyz.device) % n_prim) * s
    assignment = torch.where(assignment >= 0, assignment + prim_base[:, None], -1)
    mean_mst_length = mean_dis.reshape(b, n_prim).mean(-1)
    return (dist.reshape(b, n), assignment.to(torch.int32).reshape(b, n),
            mean_mst_length)


class _ExpansionPenalty(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, primitive_size, alpha):
        dist, assignment, mml = _penalty(xyz, primitive_size, alpha)
        ctx.save_for_backward(xyz, assignment)
        ctx.mark_non_differentiable(assignment, mml)
        return dist, assignment, mml

    @staticmethod
    def backward(ctx, g_dist, _ga, _gm):
        xyz, assignment = ctx.saved_tensors
        a = assignment.long()
        nb = torch.gather(xyz, 1, a.clamp_min(0)[..., None].expand(-1, -1, 3))
        g = torch.where(a >= 0, g_dist * 2.0, 0.0)
        return g[..., None] * (xyz - nb), None, None


def expansion_penalty(xyz: torch.Tensor, primitive_size: int, alpha: float):
    """xyz [B, N, 3] with N % primitive_size == 0 ->
    (dist [B, N] f32, assignment [B, N] int32, mean_mst_length [B])."""
    return _ExpansionPenalty.apply(xyz, primitive_size, alpha)
