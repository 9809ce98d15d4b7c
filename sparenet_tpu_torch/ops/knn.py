"""Self-kNN graph of point features (counterpart of sparenet_tpu/ops/knn.py).

``knn_idx(x, k)``: x [B, N, C] f32 -> [B, N, k] int32, self included,
ascending by distance, lowest index on ties. On a CUDA tensor it launches
``csrc/knn.cu``; on a CPU tensor it runs ``knn_plain``.
"""

from __future__ import annotations

import torch

from . import _lib
from .common import check_input, is_cpu, pairwise_sqdist_graph

__all__ = ["knn_idx", "knn_plain", "smallest_k"]


def smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of each row of d [..., M],
    ascending, lowest index on ties: k masked argmins, as the reference's
    _smallest_k (torch.argmin returns the first minimal index)."""
    d = d.clone()
    out = []
    for _ in range(k):
        i = d.argmin(-1, keepdim=True)
        out.append(i)
        d.scatter_(-1, i, float("inf"))
    return torch.cat(out, -1).to(torch.int32)


def knn_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the kNN kernel."""
    _lib.PLAIN_CALLS["knn"] += 1
    return smallest_k(pairwise_sqdist_graph(x, x), k)


def knn_idx(x: torch.Tensor, k: int = 8) -> torch.Tensor:
    """Self-kNN indices x [B, N, C] -> [B, N, k] int32 (no gradient)."""
    x = x.detach()
    check_input("knn_idx x", x, torch.float32, 3)
    if x.shape[1] < k:
        raise ValueError(f"knn_idx: need N >= k, got N={x.shape[1]}, k={k}")
    if is_cpu(x):
        return knn_plain(x, k)
    if k != 8:
        raise ValueError(f"knn_idx: the CUDA kernel takes k=8, got {k}")
    b, n, c = x.shape
    out = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    sq = torch.empty((b, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _lib.lib().spn_knn(x.data_ptr(), sq.data_ptr(), b, n, c, k,
                                  out.data_ptr(), _lib.stream_of(x))
    _lib.check(code, "knn")
    _lib.LAUNCHES["knn"] += 1
    return out
