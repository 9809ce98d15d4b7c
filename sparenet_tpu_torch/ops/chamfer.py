"""Chamfer distance: nearest-neighbour search and its gradient (counterpart
of sparenet_tpu/ops/chamfer.py and ops/pallas/chamfer_pallas.py).

``nn_idx(x1, x2)``: x1 [B, N, 3], x2 [B, M, 3] f32 -> [B, N] int32, the
nearest row of x2 for each row of x1 by squared distance from coordinate
differences, lowest index on ties (the TPU kernel's semantics; the JAX
package's CPU path uses the |x|^2 + |y|^2 - 2xy expansion instead and may
pick another index at a near-tie). A NaN distance counts as +inf: it is
never picked, and a row whose distances are all NaN or +inf gets 0. On a
CUDA tensor it launches ``csrc/chamfer_nn.cu``; on a CPU tensor it runs
``nn_idx_plain``. ``nn_idx_split_plain`` is the kernel's schedule in plain
PyTorch (chunk minima, candidate splits merged in order, a scan of the
winning chunk), for the tests; no path runs it.

``chamfer_raw(xyz1, xyz2)`` -> (dist1 [B, N], dist2 [B, M], idx1, idx2):
distances recomputed from the match as sum((x - y[idx]) ** 2); its backward
sends 2 g (x - y[idx]) to x and the negation to y[idx], for both directions
(a gather and a scatter-add in plain PyTorch, as the reference's backward is
plain XLA).
"""

from __future__ import annotations

import torch

from . import _lib
from .common import check_input, is_cpu, sqnorm3, sqdist_pairs

__all__ = ["nn_idx", "nn_idx_plain", "nn_idx_split_plain", "nn_splits",
           "CHUNK", "chamfer_raw", "chamfer_distance", "gather_rows3"]

# candidates a selection chunk of the kernel (csrc/chamfer_nn.cu: kChunk)
CHUNK = 32

# plain versions work in query chunks of at most this many distances: on
# the CPU tiles that stay in cache (3.4x faster than 1 << 24 at 16384
# points), on the card fewer launches
_PLAIN_ELEMS = {"cpu": 1 << 20, "cuda": 1 << 24}


def query_chunks(b: int, n: int, m: int, device: torch.device):
    """Slices of the query axis whose [B, chunk, M] tiles stay small. The
    result does not depend on them: each query row is scored alone."""
    step = max(1, _PLAIN_ELEMS[device.type] // max(1, b * m))
    return [slice(i, min(n, i + step)) for i in range(0, n, step)]


def _distances(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """sqdist_pairs with NaN read as +inf."""
    d = sqdist_pairs(x1, x2)
    return d.masked_fill(d.isnan(), float("inf"))


def nn_idx_plain(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the chamfer NN kernel (argmin returns the
    first minimal index)."""
    _lib.PLAIN_CALLS["nn_idx"] += 1
    b, n, _ = x1.shape
    out = [_distances(x1[:, sl], x2).argmin(-1)
           for sl in query_chunks(b, n, x2.shape[1], x1.device)]
    return torch.cat(out, 1).to(torch.int32)


def nn_idx_split_plain(x1: torch.Tensor, x2: torch.Tensor, splits: int,
                       chunk: int = CHUNK) -> torch.Tensor:
    """The kernel's schedule: the candidates in chunks of ``chunk``, the
    chunks cut into ``splits`` ranges of ceil(chunks / splits) (a range past
    the end is empty); in each range a query keeps the first chunk whose
    minimum (NaN dropped, as the kernel's minimum of the distances' bits
    drops it) is strictly below the best so far; the ranges' (minimum, chunk) pairs merged in
    order with strict <; then the first index in the winning chunk at that
    distance, 0 where no chunk won. Equal to nn_idx_plain for any
    splits >= 1 and chunk >= 1."""
    b, n, _ = x1.shape
    m = x2.shape[1]
    n_chunks = -(-m // chunk)
    per = -(-n_chunks // splits)
    d = sqdist_pairs(x1, x2)                                # NaN kept
    padded = torch.cat([d, d.new_full((b, n, n_chunks * chunk - m),
                                      float("nan"))], 2)
    padded = padded.reshape(b, n, n_chunks, chunk)
    nan = padded.isnan()
    cmin = padded.masked_fill(nan, float("inf")).amin(3)
    cmin = cmin.masked_fill(nan.all(3), float("nan"))
    best = d.new_full((b, n), float("inf"))
    win = torch.full((b, n), -1, dtype=torch.long)
    for s in range(splits):
        s_best = d.new_full((b, n), float("inf"))
        s_win = torch.full((b, n), -1, dtype=torch.long)
        for c in range(s * per, min(n_chunks, (s + 1) * per)):
            better = cmin[:, :, c] < s_best
            s_best = torch.where(better, cmin[:, :, c], s_best)
            s_win = torch.where(better, c, s_win)
        better = s_best < best
        best = torch.where(better, s_best, best)
        win = torch.where(better, s_win, win)
    in_win = torch.arange(m)[None, None, :] // chunk == win[:, :, None]
    hit = in_win & (d == best[:, :, None])
    return torch.where(win >= 0, hit.to(torch.uint8).argmax(2), 0).to(torch.int32)


def nn_splits(b: int, n1: int, n2: int) -> int:
    """The number of candidate ranges the kernel splits a query tile's scan
    into on the current card (csrc/chamfer_nn.cu: spn_nn_idx_splits)."""
    return _lib.lib().spn_nn_idx_splits(b, n1, n2)


def nn_idx(x1: torch.Tensor, x2: torch.Tensor, _splits: int | None = None
           ) -> torch.Tensor:
    """Nearest row of x2 for each row of x1; see the module docstring.
    ``_splits`` forces the kernel's number of candidate ranges (tests)."""
    x1, x2 = x1.detach(), x2.detach()
    check_input("nn_idx x1", x1, torch.float32, 3, last=3)
    check_input("nn_idx x2", x2, torch.float32, 3, last=3)
    if x1.shape[0] != x2.shape[0] or x1.device != x2.device:
        raise ValueError("nn_idx: x1 and x2 differ in batch or device")
    if x2.shape[1] < 1:
        raise ValueError("nn_idx: x2 has no points")
    if is_cpu(x1):
        return nn_idx_plain(x1, x2)
    b, n, _ = x1.shape
    m = x2.shape[1]
    dev = x1.device
    with torch.cuda.device(dev):
        splits = _splits or nn_splits(b, n, m)
        part_min = torch.empty((splits, b, n), dtype=torch.float32, device=dev)
        part_chunk = torch.empty((splits, b, n), dtype=torch.int32, device=dev)
        out = torch.empty((b, n), dtype=torch.int32, device=dev)
        code = _lib.lib().spn_nn_idx(x1.data_ptr(), x2.data_ptr(), b, n, m,
                                     splits, part_min.data_ptr(),
                                     part_chunk.data_ptr(), out.data_ptr(),
                                     _lib.stream_of(x1))
    _lib.check(code, "nn_idx")
    _lib.LAUNCHES["nn_idx"] += 1
    return out


def gather_rows3(y: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y [B, M, C], idx [B, N] -> y[b, idx[b, n]] [B, N, C]."""
    return torch.gather(y, 1, idx.long()[..., None].expand(-1, -1, y.shape[-1]))


def _one_sided_grads(x, y, idx, g):
    """Gradients of sum(g * dist) w.r.t. (x, y) for one direction
    (reference: _one_sided_grads)."""
    contrib = 2.0 * g[..., None] * (x - gather_rows3(y, idx))
    gy = torch.zeros_like(y).scatter_add_(
        1, idx.long()[..., None].expand(-1, -1, 3), -contrib)
    return contrib, gy


class _Chamfer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz1, xyz2):
        idx1 = nn_idx(xyz1, xyz2)
        idx2 = nn_idx(xyz2, xyz1)
        dist1 = sqnorm3(xyz1 - gather_rows3(xyz2, idx1))
        dist2 = sqnorm3(xyz2 - gather_rows3(xyz1, idx2))
        ctx.save_for_backward(xyz1, xyz2, idx1, idx2)
        ctx.mark_non_differentiable(idx1, idx2)
        return dist1, dist2, idx1, idx2

    @staticmethod
    def backward(ctx, g1, g2, _gi1, _gi2):
        xyz1, xyz2, idx1, idx2 = ctx.saved_tensors
        a1, a2 = _one_sided_grads(xyz1, xyz2, idx1, g1)
        b2, b1 = _one_sided_grads(xyz2, xyz1, idx2, g2)
        return a1 + b1, a2 + b2


def chamfer_raw(xyz1: torch.Tensor, xyz2: torch.Tensor):
    """(dist1 [B, N], dist2 [B, M], idx1 [B, N], idx2 [B, M]); see the
    module docstring."""
    return _Chamfer.apply(xyz1, xyz2)


def chamfer_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """mean(dist1) + mean(dist2)."""
    d1, d2, _, _ = chamfer_raw(xyz1, xyz2)
    return d1.mean() + d2.mean()
