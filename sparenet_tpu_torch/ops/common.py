"""Shared helpers for the port's ops: the kNN graph distance, the squared
distance the MST and MDS steps use, and the checks every kernel wrapper
makes before it launches.

Parity mode only. The reference (``sparenet_tpu/ops/common.py``) computes
the kNN graph distance at its ``HIGH`` graph precision, which is NOT plain
fp32: the inner product is the 3-term bf16 split ``xh.yh + xh.yl + xl.yh``
accumulated in f32 (``graph_dot``), on the CPU too. The port computes that
exact formula, here and in ``csrc/knn.cu``; a plain fp32 distance flips
neighbour sets at near-ties far more often.
"""

from __future__ import annotations

import torch

__all__ = ["graph_dot", "pairwise_sqdist_graph", "sqdist3", "sqnorm3",
           "sqdist_pairs", "fma", "sqrt_ieee", "check_input", "is_cpu"]


def _split_bf16(x: torch.Tensor):
    hi = x.to(torch.bfloat16).to(torch.float32)
    lo = (x - hi).to(torch.bfloat16).to(torch.float32)
    return hi, lo


def graph_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """<x, y> for x [B, N, C], y [B, M, C] -> [B, N, M] f32, as the
    reference's graph_dot at HIGH precision: xh.yh + xh.yl + xl.yh."""
    xh, xl = _split_bf16(x)
    yh, yl = _split_bf16(y)
    yht, ylt = yh.transpose(1, 2), yl.transpose(1, 2)
    return (torch.bmm(xh, yht) + torch.bmm(xh, ylt)) + torch.bmm(xl, yht)


def pairwise_sqdist_graph(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """max(|x|^2 + |y|^2 - 2 graph_dot(x, y), 0): x [B, N, C], y [B, M, C]
    -> [B, N, M] (reference: ops/common.py:pairwise_sqdist_graph)."""
    x2 = (x * x).sum(-1, keepdim=True)
    y2 = (y * y).sum(-1)[:, None, :]
    return (x2 + y2 - 2.0 * graph_dot(x, y)).clamp_min(0.0)


def sqdist3(d: torch.Tensor) -> torch.Tensor:
    """Squared length of d [..., 3] as fma(dz, dz, fma(dy, dy, dx * dx)):
    the rounding the reference's XLA program gives sum(d ** 2, axis=-1),
    and the one the CUDA kernels use. Each fused step is computed in f64
    and rounded once to f32 (the products of two f32 are exact in f64)."""
    dx, dy, dz = d.unbind(-1)
    r = dx * dx
    r = (dy.double() * dy.double() + r.double()).float()
    return (dz.double() * dz.double() + r.double()).float()


def sqnorm3(d: torch.Tensor) -> torch.Tensor:
    """Squared length of d [..., 3] as (dx * dx + dy * dy) + dz * dz, each
    step rounded: how the reference's chamfer and EMD losses round
    sum(d * d, axis=-1) (its XLA program contracts nothing there)."""
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for f32 tensors with one rounding (as CUDA's __fmaf_rn):
    computed in f64, where the product of two f32 is exact, and rounded to
    f32."""
    return (a.double() * b.double() + c.double()).float()


def sqdist_pairs(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared distances x [B, N, 3] to y [B, M, 3] -> [B, N, M] from
    coordinate differences, as fma(dz, dz, fma(dx, dx, dy * dy)): the
    rounding the reference's Pallas chamfer and bid kernels get for
    dx*dx + dy*dy + dz*dz in interpret mode, and the one the CUDA kernels
    use."""
    dx, dy, dz = (x[:, :, None, :] - y[:, None, :, :]).unbind(-1)
    return fma(dz, dz, fma(dx, dx, dy * dy))


def sqrt_ieee(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (PyTorch's f32 sqrt on the CPU is
    not; the f64 root rounded to f32 is)."""
    return x.double().sqrt().float()


def is_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor, False for a CUDA one; raises on any other
    device. Wrappers take their plain version only for CPU tensors."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")


def check_input(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
                last: int | None = None) -> None:
    """Raise unless t has the dtype, rank (and last dim) a wrapper takes and
    is contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if last is not None and t.shape[-1] != last:
        raise ValueError(f"{name}: last dim must be {last}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
