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
plain PyTorch around it. The kernel runs a primitive on a block of 16
warps, relaxes only where the squared distance drops, and charges by the pruning rounds;
``mst_charges_lanes_plain`` is that decomposition in plain PyTorch (for the
tests; no path runs it), and ``mst_floor`` times its parts. Its backward
is the reference's, quirk included: grad xyz[u] = 2 g[u] (xyz[u] -
xyz[assignment[u]]) for the charged endpoints u only (the squared-distance
gradient applied to the unsquared distance); mean_mst_length carries no
gradient.

``mean_mst_length_estimate`` is serving mode's stand-in for the third
output (the reference's function of that name): calibration x the mean
nearest-neighbour distance within each primitive, one [S, S] product per
primitive (f32), no kernel.
"""

from __future__ import annotations

import torch

from . import _lib
from .common import check_input, is_cpu, sqdist3, sqrt_ieee

__all__ = ["expansion_penalty", "mst_charges", "mst_charges_plain",
           "mst_charges_lanes_plain", "mst_floor", "WARPS",
           "pruning_rounds", "mean_mst_length_estimate"]

_BIG = 1e9
WARPS = 16  # warps a primitive of the kernel (csrc/expansion.cu: kWarps)


def _prune_edges(parent: torch.Tensor):
    """Leaf-pruning rounds on the parent-pointer edge list (reference:
    _prune_edges). parent [BP, S] -> (charged [BP, S] (0 at the root),
    rounds [BP]: the rounds each primitive took)."""
    bp, s = parent.shape
    eu = torch.arange(1, s, device=parent.device).expand(bp, s - 1)
    ev = parent[:, 1:].long()
    alive = torch.ones((bp, s - 1), dtype=torch.bool, device=parent.device)
    charged = torch.zeros((bp, s - 1), dtype=torch.long, device=parent.device)
    rounds = torch.zeros(bp, dtype=torch.long, device=parent.device)
    while bool(alive.any()):
        rounds += alive.any(1)
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
    return out, rounds


def pruning_rounds(parent: torch.Tensor) -> torch.Tensor:
    """The leaf-pruning rounds each tree parent [BP, S] takes -> [BP]."""
    return _prune_edges(parent)[1]


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
    return parent, cost, _prune_edges(parent)[0]


def mst_charges_lanes_plain(xyz: torch.Tensor):
    """The kernel's decomposition in plain PyTorch (for the tests): a block
    of 16 warps a primitive, thread ``tid`` holding vertices v = tid V + k
    (k < V; V = 1 up to S = 512, 2 up to S = 1024); per step, the squared
    distance to the last pick, the root and the strict < test only where it
    is below the one behind the vertex's distance (visited vertices carry -inf and 1e9,
    vertices past S -inf and +inf); the argmin as a tree of (distance bits,
    slot) over each thread's slots, then each warp's minimum bits and the
    lowest lane holding them, then the least bits over the warps and the
    lowest warp holding them; then the leaf-pruning rounds with each
    vertex's degree starting at its own alive edge. xyz [BP, S, 3] ->
    (parent, cost, charged, rounds [BP]); equals ``mst_charges_plain``."""
    bp, s, _ = xyz.shape
    warps = WARPS
    nt = 32 * warps
    if s > 2 * nt:
        raise ValueError(f"the 16-warp layout takes S <= {2 * nt}, got {s}")
    v_slots = 1 if s <= nt else 2
    n = nt * v_slots                                   # v = tid * V + k
    inf = float("inf")
    pts = torch.zeros((bp, n, 3))
    pts[:, :s] = xyz
    v = torch.arange(n)
    valid = v < s
    dis = torch.where(valid, torch.tensor(_BIG), inf).repeat(bp, 1)
    d2 = torch.where(valid & (v > 0), inf, -inf).repeat(bp, 1)
    frm = torch.zeros((bp, n), dtype=torch.long)
    cost = torch.zeros((bp, s))
    rows = torch.arange(bp)
    last = torch.zeros(bp, dtype=torch.long)
    big = torch.iinfo(torch.int64).max
    for _ in range(s - 1):
        e = sqdist3(pts - pts[rows, last][:, None, :])
        need = e < d2
        d = torch.where(need, sqrt_ieee(e), inf)
        closer = need & (d < dis)
        dis = torch.where(closer, d, dis)
        d2 = torch.where(closer, e, d2)
        frm = torch.where(closer, last[:, None], frm)
        bv = dis.view(torch.int32).long().view(bp, nt, v_slots).clone()
        bk = torch.arange(v_slots).repeat(bp, nt, 1)
        span = 1
        while span < v_slots:
            for k in range(0, v_slots - span, 2 * span):
                take = bv[:, :, k + span] < bv[:, :, k]
                bv[:, :, k] = torch.where(take, bv[:, :, k + span], bv[:, :, k])
                bk[:, :, k] = torch.where(take, bk[:, :, k + span], bk[:, :, k])
            span *= 2
        lane_b = bv[:, :, 0].view(bp, warps, 32)
        lane_v = (torch.arange(nt) * v_slots + bk[:, :, 0]).view(bp, warps, 32)
        wmin = lane_b.amin(2, keepdim=True)
        wl = torch.where(lane_b == wmin, torch.arange(32), 32).argmin(2, keepdim=True)
        wv = lane_v.gather(2, wl)[:, :, 0]
        gmin = wmin[:, :, 0].amin(1, keepdim=True)
        ww = torch.where(wmin[:, :, 0] == gmin, torch.arange(warps), big).argmin(1)
        nxt = wv[rows, ww]
        cost[rows, nxt] = gmin[:, 0].to(torch.int32).view(torch.float32)
        dis[rows, nxt] = _BIG
        d2[rows, nxt] = -inf
        last = nxt
    alive = (valid & (v >= 1)).repeat(bp, 1)
    charged = torch.zeros((bp, n), dtype=torch.long)
    rounds = torch.zeros(bp, dtype=torch.long)
    while bool(alive.any()):
        rounds += alive.any(1)
        deg = alive.long().scatter_add(1, frm, alive.long())
        u_leaf = alive & (deg == 1)
        p_leaf = alive & (deg.gather(1, frm) == 1)
        kill = u_leaf | p_leaf
        chosen = torch.where(u_leaf & p_leaf, torch.maximum(v, frm),
                             torch.where(u_leaf, v, frm))
        charged = torch.where(kill, chosen, charged)
        alive = alive & ~kill
    return (frm[:, :s].to(torch.int32), cost, charged[:, :s].to(torch.int32),
            rounds)


_MODES = {"full": 0, "prim": 1, "floor": 2}


def _launch(xyz: torch.Tensor, mode: str):
    bp, s, _ = xyz.shape
    parent = torch.empty((bp, s), dtype=torch.int32, device=xyz.device)
    cost = torch.empty((bp, s), dtype=torch.float32, device=xyz.device)
    charged = torch.empty((bp, s), dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        code = _lib.lib().spn_expansion(
            xyz.data_ptr(), bp, s, _MODES[mode], parent.data_ptr(),
            cost.data_ptr(), charged.data_ptr(), _lib.stream_of(xyz))
    _lib.check(code, "expansion")
    return parent, cost, charged


def mst_floor(xyz: torch.Tensor, mode: str):
    """The kernel in a timing mode (CUDA only, S <= 1024, not counted as a
    launch): "prim", Prim's steps without the charging (charged all 0);
    "floor", S - 1 empty steps (the argmin, the key exchange and the pick,
    no relaxation) and no charging, whose output is not a tree."""
    return _launch(xyz.detach().contiguous(), mode)


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
    lib = _lib.lib()
    if s > lib.spn_expansion_max_points():
        raise ValueError(f"mst_charges: the CUDA kernel takes S <= "
                         f"{lib.spn_expansion_max_points()}, got {s}")
    out = _launch(xyz, "full")
    _lib.LAUNCHES["expansion"] += 1
    return out


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


def mean_mst_length_estimate(xyz: torch.Tensor, primitive_size: int,
                             calibration: float = 3.18) -> torch.Tensor:
    """xyz [B, N, 3] -> [B]: calibration * mean over the primitives of the
    mean nearest-neighbour distance within each (the reference's
    mean_mst_length_estimate; its default 3.18 is the random-init fit, the
    models carry their own)."""
    b, n, _ = xyz.shape
    s = primitive_size
    p = xyz.detach().float().reshape(b * (n // s), s, 3)
    p2 = sqdist3(p)
    d2 = (p2[:, :, None] + p2[:, None, :]) - 2.0 * torch.bmm(p, p.transpose(1, 2))
    d2 = d2 + torch.eye(s, device=p.device) * _BIG
    m = d2.amin(-1).clamp_min(0.0).sqrt().mean(-1)
    return m.reshape(b, n // s).mean(-1) * torch.tensor(
        calibration, dtype=torch.float32, device=p.device)
