"""Shared helpers for the port's ops: the kNN graph distance, the squared
distance the MST and MDS steps use, and the checks every kernel wrapper
makes before it launches.

In parity mode the reference (``sparenet_tpu/ops/common.py``) computes
the kNN graph distance at its ``HIGH`` graph precision, which is NOT plain
fp32: the inner product is the 3-term bf16 split ``xh.yh + xh.yl + xl.yh``
accumulated in f32 (``graph_dot``), on the CPU too. The port computes that
exact formula, here and in ``csrc/knn.cu``; a plain fp32 distance flips
neighbour sets at near-ties far more often.

Serving mode (the reference's ``SPARENET_FAST_MATH=1``, an explicit
``serving`` argument here) takes the graph distance at ``DEFAULT``: one bf16
pass with f32 accumulation (``pairwise_sqdist_serving``). Its other switches
(bf16 activation chains, packed-key kNN, the MDS arms, the mml estimate)
are arguments of the modules and ops that use them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib

__all__ = ["graph_dot", "pairwise_sqdist_graph", "pairwise_sqdist_graph_seq",
           "graph_dot_seq", "sqnorm_fma", "sqdist_from", "serving_dot",
           "pairwise_sqdist_serving",
           "sqnorm_seq", "sqdist3", "sqnorm3",
           "sqdist_pairs", "fma", "sqrt_ieee", "check_input", "is_cpu",
           "slice_plan", "PLAN_KEYS"]

# csrc/slices.cu:spn_slice_plan's fields
PLAN_KEYS = ("width", "groups", "group_rows", "threads", "lanes", "smem",
             "blocks")


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


def graph_dot_seq(x: torch.Tensor) -> torch.Tensor:
    """graph_dot(x, x) in the exact kNN kernel's fixed order (csrc/knn.cu):
    per channel, in channel order, dot = fma(xl, yh, fma(xh, yl,
    fma(xh, yh, dot))), each fma computed in f64 and rounded once.
    x [B, N, C] -> [B, N, N]."""
    xh, xl = _split_bf16(x)
    dot = x.new_zeros(x.shape[0], x.shape[1], x.shape[1])
    for c in range(x.shape[-1]):
        qh, ql = xh[:, :, c, None], xl[:, :, c, None]
        yh, yl = xh[:, None, :, c], xl[:, None, :, c]
        dot = fma(ql, yh, fma(qh, yl, fma(qh, yh, dot)))
    return dot


def sqnorm_fma(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over the last axis as an fma chain in channel order (the exact
    kNN kernel's norms)."""
    s = x.new_zeros(x.shape[:-1])
    for c in range(x.shape[-1]):
        s = fma(x[..., c], x[..., c], s)
    return s


def sqdist_from(sq: torch.Tensor, dot: torch.Tensor) -> torch.Tensor:
    """max((|x_q|^2 + |y_j|^2) - 2 dot, 0) from the norms sq [B, N] and the
    dots [B, N, N], each step rounded, as the kNN kernels combine them."""
    return ((sq[:, :, None] + sq[:, None, :]) - 2.0 * dot).clamp_min(0.0)


def pairwise_sqdist_graph_seq(x: torch.Tensor) -> torch.Tensor:
    """pairwise_sqdist_graph(x, x) summed in one fixed order, the exact kNN
    kernel's: ``graph_dot_seq`` and ``sqnorm_fma``. x [B, N, C] ->
    [B, N, N]."""
    return sqdist_from(sqnorm_fma(x), graph_dot_seq(x))


def sqnorm_seq(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 over the last axis summed in channel order, each product and
    each sum rounded: ((x0 x0 + x1 x1) + x2 x2) + ...  (the serving kNN
    kernel's order, and the reference's at the encoder's first widths)."""
    s = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        s = s + x[..., c] * x[..., c]
    return s


def serving_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """xh.yh for x [B, N, C], y [B, M, C] -> [B, N, M]: graph_dot at
    DEFAULT, one bf16 pass accumulated in f32, in channel order (products
    of two bf16 values are exact in f32, so the order is the only
    rounding)."""
    xh = x.to(torch.bfloat16).to(torch.float32)
    yh = y.to(torch.bfloat16).to(torch.float32)
    dot = x.new_zeros(x.shape[0], x.shape[1], y.shape[1])
    for c in range(x.shape[-1]):
        dot.addcmul_(xh[:, :, c, None], yh[:, None, :, c])
    return dot


def pairwise_sqdist_serving(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Serving-mode graph distance max(|x|^2 + |y|^2 - 2 xh.yh, 0) for
    x [B, N, C], y [B, M, C] -> [B, N, M]: ``serving_dot``, and the norms
    from the f32 values (``sqnorm_seq``)."""
    d = ((sqnorm_seq(x)[:, :, None] + sqnorm_seq(y)[:, None, :])
         - 2.0 * serving_dot(x, y))
    return d.clamp_min(0.0)


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


def slice_plan(b: int, n: int, m: int, c: int, k: int) -> dict:
    """The plan of the slice kernels (gather-max and the edge-stats forward,
    csrc/slices.cuh) for a [b, n, c] table and [b, m, k] lists on the
    current card, as they launch: width 0 is the row-at-a-time path."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    _lib.check(_lib.lib().spn_slice_plan(b, n, m, c, k, out), "slice_plan")
    return dict(zip(PLAN_KEYS, out))
