"""Self-kNN graph of point features (counterpart of sparenet_tpu/ops/knn.py).

``knn_idx(x, k, packed=False)``: x [B, N, C] f32 -> [B, N, k] int32, self
included, ascending by distance, lowest index on ties. On a CUDA tensor it
launches ``csrc/knn.cu``; on a CPU tensor it runs ``knn_plain``.

``packed=True`` is serving mode's arm (the reference's
``knn_self_pallas(..., packed=True)``, knn_pallas.py:_knn_onechunk_kernel):
the distance is one bf16 pass (``pairwise_sqdist_serving``), and each
candidate is ranked by one int32 key, the f32 bits of the distance with the
low ``packed_bits(N)`` bits replaced by its index, so distances equal after
that truncation go to the lowest index. As in the reference it applies only
where its one-chunk kernel takes the shape (``packed_applies``); elsewhere
the exact arm runs. Plain version ``knn_packed_plain``, kernel
``spn_knn_packed``, counted as ``"knn_packed"``.
"""

from __future__ import annotations

import torch

from . import _lib
from .common import (check_input, is_cpu, pairwise_sqdist_graph,
                     pairwise_sqdist_serving)

__all__ = ["knn_idx", "knn_plain", "knn_packed_plain", "smallest_k",
           "packed_bits", "packed_applies"]

# the reference's one-chunk ceiling: its [C, N] operand must fit VMEM
_ONECHUNK_MAX_ELEMS = 1024 * 8192


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def packed_bits(n: int) -> int:
    """Low key bits the index takes: bit_length(n_pad - 1), n_pad = N
    rounded up to 128 (12 at N = 3000)."""
    return max((_round_up(n, 128) - 1).bit_length(), 1)


def packed_applies(n: int, c: int) -> bool:
    """Whether the reference takes the packed arm at this shape (its
    one-chunk kernel: channels padded to 128, or to 256 above 256)."""
    cc = min(256, _round_up(c, 128))
    return _round_up(c, cc) * _round_up(n, 128) <= _ONECHUNK_MAX_ELEMS


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


def knn_packed_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the packed-key kNN kernel: the k smallest
    keys (unique, as the index is in them)."""
    _lib.PLAIN_CALLS["knn_packed"] += 1
    n = x.shape[1]
    bits = packed_bits(n)
    d = pairwise_sqdist_serving(x, x)
    key = ((d.view(torch.int32) & -(1 << bits))
           | torch.arange(n, dtype=torch.int32, device=x.device))
    low = key.topk(k, dim=-1, largest=False, sorted=True).values
    return low & ((1 << bits) - 1)


def knn_idx(x: torch.Tensor, k: int = 8, packed: bool = False) -> torch.Tensor:
    """Self-kNN indices x [B, N, C] -> [B, N, k] int32 (no gradient)."""
    x = x.detach()
    check_input("knn_idx x", x, torch.float32, 3)
    if x.shape[1] < k:
        raise ValueError(f"knn_idx: need N >= k, got N={x.shape[1]}, k={k}")
    b, n, c = x.shape
    packed = packed and packed_applies(n, c)
    if is_cpu(x):
        return knn_packed_plain(x, k) if packed else knn_plain(x, k)
    if k != 8:
        raise ValueError(f"knn_idx: the CUDA kernel takes k=8, got {k}")
    if packed:
        return _knn_packed(x, k)
    out = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    sq = torch.empty((b, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _lib.lib().spn_knn(x.data_ptr(), sq.data_ptr(), b, n, c, k,
                                  out.data_ptr(), _lib.stream_of(x))
    _lib.check(code, "knn")
    _lib.LAUNCHES["knn"] += 1
    return out


def _knn_packed(x: torch.Tensor, k: int) -> torch.Tensor:
    b, n, c = x.shape
    out = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    sq = torch.empty((b, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _lib.lib().spn_knn_packed(x.data_ptr(), sq.data_ptr(), b, n, c,
                                         k, packed_bits(n), out.data_ptr(),
                                         _lib.stream_of(x))
    _lib.check(code, "knn_packed")
    _lib.LAUNCHES["knn_packed"] += 1
    return out
