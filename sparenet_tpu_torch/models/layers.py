"""Model building blocks, channel-last (counterpart of
sparenet_tpu/models/layers.py), in eval and train mode (``module.training``).

Point features are [B, N, C], as in the JAX package. Every layer keeps the
parameter names and shapes of the original reference's torch modules
(Conv1d weights [out, in, 1], BatchNorm running stats, ...), so a state_dict
in that layout (see ``sparenet_tpu_torch.utils.weights``) loads with
``load_state_dict(strict=True)``. The 1x1 convolutions run as ``F.linear``
over the channel axis, never as cuDNN convolutions.

The 32 per-primitive folding decoders are one module with stacked weights
[P, out, in] and batched products (``GridDecoderStack`` for SpareNet's
shared AdaIN and its SIREN variant, ``AdaInGridDecoderStack`` for its
``no_share`` arm, ``PointGenConStack`` for AtlasNet, MSN and SpareNet's
``no_use`` arm); a load hook stacks the reference's per-primitive keys.
``recomputing`` marks a checkpoint's replay (remat), during which the
running statistics are left as the forward set them.

Serving mode (eval with ``serving=True``, the reference's
``SPARENET_FAST_MATH=1`` under ``bench.py``'s bf16 matmul precision) runs the
wide chains as flax's ``dtype=bfloat16`` does (``serving_dtype``): the
encoder's conv5 tail, the folding decoders and the residual refiner take
bf16 inputs and parameters and give bf16 outputs (``dense``; BatchNorm and
AdaIN compute in f32 and round to bf16 where flax does). Every other
product of the network runs at the bf16 precision too (``product_bf16``:
bf16 operands on cuBLAS, the result widened to f32).

Train-mode BatchNorm follows the JAX package (flax), not ``nn.BatchNorm``'s
own training update: statistics over every axis but the channel, the
variance biased and computed as max(mean(x^2) - mean(x)^2, 0), and the
running update 0.9 * running + 0.1 * statistic with that biased variance.
"""

from __future__ import annotations

import contextlib
import math
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import edge_gather, gather, knn

__all__ = [
    "serving_dtype", "dense", "product_bf16", "conv1x1", "bn_eval", "bn_affine", "bn_apply", "bn_train_stats",
    "external_stats_affine", "SELayer", "EdgeConvResFeat", "PointNetfeat",
    "adaptive_instance_norm", "grid_decoder_adain_sizes", "num_adain_params",
    "split_adain_params", "StackedLinear", "StackedBatchNorm", "StackedSE",
    "GridDecoderStack", "AdaInGridDecoderStack", "PointGenConStack", "PointNetRes",
    "EdgeRes", "graph_feature", "grid_generation", "init_weights", "recomputing",
]


# ---------------------------------------------------------------------------
# 1x1 convolutions, BatchNorm (eval), squeeze-excitation
# ---------------------------------------------------------------------------

def serving_dtype(module: nn.Module):
    """bf16 for a module in serving mode's eval (``module.serving`` and not
    training), else None (f32): the reference's serving_dtype."""
    serving = getattr(module, "serving", False) and not module.training
    return torch.bfloat16 if serving else None


def dense(x: torch.Tensor, weight: torch.Tensor, bias=None, dtype=None):
    """x [..., in] -> [..., out] with weight [out, in]: in f32 for dtype
    None; for bf16 as flax's Dense(dtype=bf16): input, weight and bias cast
    to bf16, one bf16 GEMM (f32 accumulation, bf16 result), the bias added
    in bf16."""
    if dtype is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def product_bf16(x: torch.Tensor, weight: torch.Tensor, bias=None, on=True):
    """An f32 layer's product at serving precision (``on``): bf16 operands,
    one bf16 GEMM, the result widened to f32, then the f32 bias; with
    ``on`` False, the f32 product."""
    if not on:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(torch.bfloat16), weight.to(torch.bfloat16)).float()
    return y if bias is None else y + bias


def conv1x1(conv: nn.Module, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """A 1x1 Conv1d/Conv2d (weight [out, in, 1(, 1)]) applied over the last
    axis of channel-last x [..., in] (``dense`` with ``dtype``)."""
    w = conv.weight.reshape(conv.weight.shape[0], -1)
    return dense(x, w, conv.bias, dtype)


def bn_eval(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis, in flax's order of operations:
    (x - mean) * (rsqrt(var + eps) * scale) + bias, computed in f32 and
    returned in x's dtype (flax's BatchNorm(dtype=bf16))."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return ((x - bn.running_mean) * mul + bn.bias).to(x.dtype)


_MOMENTUM = 0.9  # flax's EMA decay (torch momentum 0.1)
_RECOMPUTING = [0]  # > 0 while a checkpointed forward is replayed


@contextlib.contextmanager
def recomputing():
    """The context of a checkpoint's recompute (``torch.utils.checkpoint``'s
    ``context_fn``): the replayed forward leaves the running statistics as
    the first forward set them, so they advance once a step, as under the
    JAX package's ``nn.remat``."""
    _RECOMPUTING[0] += 1
    try:
        yield
    finally:
        _RECOMPUTING[0] -= 1


def bn_train_stats(x: torch.Tensor, dims):
    """flax's batch statistics (use_fast_variance): mean and the biased
    variance max(mean(x^2) - mean(x)^2, 0) over ``dims``."""
    mean = x.mean(dims)
    var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
    return mean, var


@torch.no_grad()
def update_running(running_mean: torch.Tensor, running_var: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor) -> None:
    """running <- 0.9 * running + 0.1 * statistic, in place (flax's EMA);
    nothing while a checkpointed forward is replayed (``recomputing``)."""
    if _RECOMPUTING[0]:
        return
    running_mean.copy_(_MOMENTUM * running_mean + (1.0 - _MOMENTUM) * mean)
    running_var.copy_(_MOMENTUM * running_var + (1.0 - _MOMENTUM) * var)


def bn_apply(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the last axis of x: eval mode as ``bn_eval``; in train
    mode normalise by the batch statistics over every other axis and update
    the running statistics (see the module docstring)."""
    if not bn.training:
        return bn_eval(bn, x)
    mean, var = bn_train_stats(x, tuple(range(x.dim() - 1)))
    update_running(bn.running_mean, bn.running_var, mean, var)
    return (x - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


def external_stats_affine(bn: nn.modules.batchnorm._BatchNorm,
                          mean: torch.Tensor, var: torch.Tensor):
    """Train-mode BatchNorm from statistics computed elsewhere (reference:
    _ExternalStatsBN): updates the running statistics with them and returns
    the per-channel affine (a, b0) of the normalisation, y = a * x + b0."""
    update_running(bn.running_mean, bn.running_var, mean, var)
    a = bn.weight * torch.rsqrt(var + bn.eps)
    return a, bn.bias - mean * a


def bn_affine(bn: nn.modules.batchnorm._BatchNorm):
    """(a, b0) with bn_eval(bn, x) = a * x + b0 per channel, found by probing
    at 0 and 1 as the reference's commute path does."""
    b0 = bn_eval(bn, torch.zeros_like(bn.running_mean))
    a = bn_eval(bn, torch.ones_like(bn.running_mean)) - b0
    return a, b0


class SELayer(nn.Module):
    """Squeeze-excitation over [B, ..., C], reduction 16; ``mean`` overrides
    the pooled statistic (the commute path passes the mean over all edges)."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channel, channel // reduction, bias=False),
            nn.ReLU(inplace=True),
            nn.Linear(channel // reduction, channel, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor, mean: torch.Tensor | None = None,
                serving: bool = False):
        """``serving``: the two products at bf16 precision, the scale
        rounded to x's dtype before the multiply (the reference's order)."""
        if mean is None:
            mean = x.float().mean(dim=tuple(range(1, x.dim() - 1)))
        if serving:
            h = F.relu(product_bf16(mean, self.fc[0].weight))
            y = torch.sigmoid(product_bf16(h, self.fc[2].weight)).to(x.dtype)
        else:
            y = self.fc(mean)
        return x * y.reshape(y.shape[0], *([1] * (x.dim() - 2)), y.shape[1])


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

class EdgeConvResFeat(nn.Module):
    """Channel-attentive EdgeConv encoder, commute paths (eval and train).

    x [B, N, 3] -> [B, output_size]: four EdgeConv stages over kNN graphs
    (k=8) in feature space, 1x1 residual shortcuts, concat of the four
    scales, a wide conv5, then concat(max-pool, avg-pool).

    Each stage is the reference's eval max-commute (EdgeConv1x1._commute):
    with W = [W1; W2] and the stage BatchNorm's affine (a, b0),
        max_j bn(g1[idx_j] - g1 + g2) = max_j (a*g1)[idx_j] + a*(g2 - g1) + b0
    so only one C-wide neighbour gather + max runs (the gather-max kernel),
    and the SE squeeze is the mean over all edges (its need_sum output).

    In train mode each stage is the reference's train commute on its kernel
    arm (layers.py, EdgeConvResFeat.stage): the batch statistics of the edge
    tensor e = g1[idx] + diff follow in closed form from the per-point max,
    min, sum and sum of squares of the gathered g1 rows (the edge-stats
    kernels), BatchNorm becomes the affine (a, b0) of those statistics, and
    max_j a * g1[idx_j] = a >= 0 ? a * max : a * min.
    """

    def __init__(self, k: int = 8, hide_size: int = 4096,
                 output_size: int = 4096, use_selayer: bool = False,
                 serving: bool = False):
        super().__init__()
        self.k = k
        self.use_selayer = use_selayer
        self.serving = serving
        h = hide_size
        widths = [(3, h // 16), (h // 16, h // 16), (h // 16, h // 8),
                  (h // 8, h // 4)]
        for i, (cin, cout) in enumerate(widths, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(2 * cin, cout, 1, bias=False))
            setattr(self, f"bn{i}", nn.BatchNorm2d(cout))
            if use_selayer:
                setattr(self, f"se{i}", SELayer(cout))
        self.resconv1 = nn.Conv1d(h // 16, h // 16, 1, bias=False)
        self.resconv2 = nn.Conv1d(h // 16, h // 8, 1, bias=False)
        self.resconv3 = nn.Conv1d(h // 8, h // 4, 1, bias=False)
        self.conv5 = nn.Conv1d(h // 2, output_size // 2, 1, bias=False)
        self.bn5 = nn.BatchNorm1d(output_size // 2)

    def _stage(self, feat: torch.Tensor, i: int) -> torch.Tensor:
        if self.training:
            return self._train_stage(feat, i)
        return self._eval_stage(feat, i)

    def _eval_stage(self, feat: torch.Tensor, i: int) -> torch.Tensor:
        serving = self.serving
        nbr = knn.knn_idx(feat, self.k, packed=serving)        # [B, N, k]
        c = feat.shape[-1]
        w = getattr(self, f"conv{i}").weight.reshape(-1, 2 * c)
        g1 = product_bf16(feat, w[:, :c], on=serving)
        diff = product_bf16(feat, w[:, c:], on=serving) - g1
        a, b0 = bn_affine(getattr(self, f"bn{i}"))
        g1s = g1 * a
        if not self.use_selayer:
            m = gather.gather_max(g1s, nbr)
            return F.leaky_relu(m + a * diff + b0, 0.2)
        m, s = gather.gather_max(g1s, nbr, need_sum=True)
        n, k = nbr.shape[1], nbr.shape[2]
        z_mean = s / float(n * k) + a * diff.mean(1) + b0
        z = getattr(self, f"se{i}")(m + a * diff + b0, mean=z_mean,
                                    serving=serving)
        return F.leaky_relu(z, 0.2)

    def _train_stage(self, feat: torch.Tensor, i: int) -> torch.Tensor:
        nbr = knn.knn_idx(feat, self.k)                        # [B, N, k]
        b, n, c = feat.shape
        k = self.k
        w = getattr(self, f"conv{i}").weight.reshape(-1, 2 * c)
        g1 = F.linear(feat, w[:, :c])
        diff = F.linear(feat, w[:, c:]) - g1
        mx, mn, s1, s2 = edge_gather.edge_gather_stats(g1, nbr)
        sum_g_b = s1.sum(1)                                    # [B, C]
        sum_g2 = s2.sum((0, 1))
        sum_d_b = diff.sum(1)
        cnt = b * n * k
        mean = (sum_g_b.sum(0) + k * sum_d_b.sum(0)) / cnt
        mean2 = (sum_g2 + 2.0 * (diff * s1).sum((0, 1))
                 + k * (diff * diff).sum((0, 1))) / cnt
        a, b0 = external_stats_affine(getattr(self, f"bn{i}"), mean,
                                      mean2 - mean * mean)
        z = torch.where(a >= 0, a * mx, a * mn) + a * diff + b0
        if self.use_selayer:
            mean_e_b = (sum_g_b + k * sum_d_b) / (n * k)
            z = getattr(self, f"se{i}")(z, mean=a * mean_e_b + b0)
        return F.leaky_relu(z, 0.2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = serving_dtype(self)

        def res(conv, v):
            return product_bf16(v, conv.weight[..., 0], on=dt is not None)
        x1 = self._stage(x, 1)
        x2 = self._stage(x1, 2) + res(self.resconv1, x1)
        x3 = self._stage(x2, 3) + res(self.resconv2, x2)
        x4 = self._stage(x3, 4) + res(self.resconv3, x3)
        xc = torch.cat([x1, x2, x3, x4], dim=-1)
        xc = F.leaky_relu(bn_apply(self.bn5, conv1x1(self.conv5, xc, dt)), 0.2)
        return torch.cat([xc.amax(1).float(), xc.float().mean(1)], dim=-1)


class PointNetfeat(nn.Module):
    """PointNet global feature (the reference's PointNetfeat): x [B, N, 3]
    -> [B, hide_size] by 1x1 convs 3 -> 64 -> 128 -> hide_size, each with
    BatchNorm, then SE (``use_selayer``) and ReLU after the first two, then
    a max over the points. In serving mode the products run at bf16
    precision (``product_bf16``)."""

    def __init__(self, hide_size: int = 1024, serving: bool = False,
                 use_selayer: bool = False):
        super().__init__()
        self.serving = serving
        self.use_selayer = use_selayer
        for i, (cin, cout) in enumerate(((3, 64), (64, 128), (128, hide_size)),
                                        start=1):
            setattr(self, f"conv{i}", nn.Conv1d(cin, cout, 1))
            setattr(self, f"bn{i}", nn.BatchNorm1d(cout))
            if use_selayer and i < 3:
                setattr(self, f"se{i}", SELayer(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        on = serving_dtype(self) is not None
        for i in (1, 2, 3):
            conv = getattr(self, f"conv{i}")
            x = bn_apply(getattr(self, f"bn{i}"),
                         product_bf16(x, conv.weight[..., 0], conv.bias, on=on))
            if i < 3:
                if self.use_selayer:
                    x = getattr(self, f"se{i}")(x, serving=on)
                x = F.relu(x)
        return x.amax(1)


# ---------------------------------------------------------------------------
# AdaIN
# ---------------------------------------------------------------------------

def adaptive_instance_norm(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, eps: float = 1e-5):
    """AdaIN over the point axis (-2): x [..., B, N, C], weight/bias [B, C]
    (or [P, B, C], a primitive's own); instance statistics per (sample,
    channel), biased variance. For bf16 x
    the statistics are f32 and the normalisation runs in bf16 (the
    reference's dtype-preserving form)."""
    dt = x.dtype
    mean = x.float().mean(-2, keepdim=True)
    var = ((x - mean.to(dt)).float() ** 2).mean(-2, keepdim=True)
    xn = (x - mean.to(dt)) * torch.rsqrt(var + eps).to(dt)
    return xn * weight.unsqueeze(-2).to(dt) + bias.unsqueeze(-2).to(dt)


def grid_decoder_adain_sizes(bottleneck_size: int,
                             use_sine: bool = False) -> tuple[int, ...]:
    """Per-layer AdaIN feature counts of the GridDecoder, in the
    reference's registration order: the SIREN decoder's four sine layers'
    first, then adain1-3, registered but unused by its forward."""
    b = bottleneck_size
    if use_sine:
        return (b, b // 2, b // 4, b // 4, b, b // 2, b // 4)
    return (b, b // 2, b // 4)


def num_adain_params(bottleneck_size: int, use_sine: bool = False) -> int:
    return 2 * sum(grid_decoder_adain_sizes(bottleneck_size, use_sine))


def split_adain_params(params: torch.Tensor, sizes):
    """Per AdaIN layer, (weight, bias) = (std, mean) consumed in order:
    each layer's slice of the last axis is [mean(=bias) | std(=weight)]."""
    out, off = [], 0
    for nf in sizes:
        bias = params[..., off:off + nf]
        weight = params[..., off + nf:off + 2 * nf]
        out.append((weight, bias))
        off += 2 * nf
    return out


# ---------------------------------------------------------------------------
# Stacked per-primitive layers (the reference's 32 decoders, batched)
# ---------------------------------------------------------------------------

class StackedLinear(nn.Module):
    """P independent linear maps: weight [P, out, in], bias [P, out].
    x [P (or 1), ..., in] -> [P, ..., out] by one batched product."""

    def __init__(self, p: int, cin: int, cout: int, bias: bool = True,
                 init_std: float = 0.02, init_bound: float | None = None):
        super().__init__()
        self.init_std = init_std
        self.init_bound = init_bound  # uniform(-bound, bound) in its place
        self.weight = nn.Parameter(torch.empty(p, cout, cin))
        self.bias = nn.Parameter(torch.zeros(p, cout)) if bias else None

    def forward(self, x: torch.Tensor, dtype=None,
                bf16_product: bool = False) -> torch.Tensor:
        """``dtype`` bf16: flax's Dense(dtype=bf16) (see ``dense``);
        ``bf16_product``: an f32 layer at bf16 precision (``product_bf16``)."""
        p = self.weight.shape[0]
        lead = x.shape[1:-1]
        x2 = x.expand(p, *x.shape[1:]).reshape(p, -1, x.shape[-1])
        wt = self.weight.transpose(1, 2)
        if dtype is not None or bf16_product:
            cast = dtype or torch.bfloat16
            y = torch.bmm(x2.to(cast), wt.to(cast))
            if bf16_product:
                y = y.float()
            if self.bias is not None:
                y = y + self.bias[:, None, :].to(y.dtype)
        elif self.bias is None:
            y = torch.bmm(x2, wt)
        else:
            y = torch.baddbmm(self.bias[:, None, :], x2, wt)
        return y.reshape(p, *lead, -1)


class StackedBatchNorm(nn.Module):
    """P BatchNorm1d's over x [P, ..., C]; in train mode each normalises by
    its own batch statistics (over every axis but P and C)."""

    def __init__(self, p: int, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(p, c))
        self.bias = nn.Parameter(torch.zeros(p, c))
        self.register_buffer("running_mean", torch.zeros(p, c))
        self.register_buffer("running_var", torch.ones(p, c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        if self.training:
            mean, var = bn_train_stats(x, tuple(range(1, x.dim() - 1)))
            update_running(self.running_mean, self.running_var, mean, var)
            mul = torch.rsqrt(var + self.eps) * self.weight
            return ((x - mean.reshape(shape)) * mul.reshape(shape)
                    + self.bias.reshape(shape))
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean.reshape(shape)) * mul.reshape(shape)
                + self.bias.reshape(shape)).to(x.dtype)


class StackedSE(nn.Module):
    """P squeeze-excitation layers over x [P, B, S, C] (reduction 16)."""

    def __init__(self, p: int, channel: int, reduction: int = 16):
        super().__init__()
        r = channel // reduction
        self.fc = nn.Sequential(
            StackedLinear(p, channel, r, bias=False, init_std=0.01),
            nn.ReLU(inplace=True),
            StackedLinear(p, r, channel, bias=False, init_std=0.01),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor, serving: bool = False) -> torch.Tensor:
        """``serving``: the products at bf16 precision, the scale rounded
        to x's dtype before the multiply."""
        m = x.float().mean(2)                                  # [P, B, C]
        if not serving:
            return x * self.fc(m)[:, :, None, :]
        h = F.relu(self.fc[0](m, bf16_product=True))
        y = torch.sigmoid(self.fc[2](h, bf16_product=True)).to(x.dtype)
        return x * y[:, :, None, :]


class _PrimitiveStack(nn.Module):
    """Base of the stacked per-primitive decoders. Their state-dict keys are
    the reference's per-primitive layout with the primitive index folded
    into a leading axis: ``conv1.weight`` [P, out, in] stands for the
    reference's ``reference_key`` with p and name filled in (conv weights
    [out, in, 1]). ``load_state_dict`` takes either layout (a pre-hook
    stacks the reference's); ``reference_state`` gives the reference's, with
    the tensors the reference registers but never uses (``unused_reference``,
    each primitive's) at their defaults."""

    reference_key = "{p}.{name}"
    # the 1x1 convolutions, whose reference weights are [out, in, 1]
    conv_weight = re.compile(r"(conv\d|linear\d(\.linear)?)\.weight")

    def __init__(self, n_primitives: int):
        super().__init__()
        self.n_primitives = n_primitives
        self._register_load_state_dict_pre_hook(self._stack_reference_keys)

    def unused_reference(self) -> dict:
        """One primitive's registered-but-unused reference tensors by name:
        its BatchNorms' step counts."""
        return {f"bn{i}.num_batches_tracked": torch.zeros((), dtype=torch.int64)
                for i in (1, 2, 3)}

    def _key(self, prefix: str, p: int, name: str) -> str:
        return prefix + self.reference_key.format(p=p, name=name)

    def _stack_reference_keys(self, state_dict, prefix, *args):
        first = next(name for name, _ in self.named_parameters())
        if self._key(prefix, 0, first) not in state_dict:
            return
        for name, t in list(self.named_parameters()) + list(self.named_buffers()):
            keys = [self._key(prefix, p, name) for p in range(self.n_primitives)]
            if all(k in state_dict for k in keys):
                state_dict[prefix + name] = torch.stack(
                    [torch.as_tensor(state_dict.pop(k)).reshape(t.shape[1:])
                     for k in keys])
        for p in range(self.n_primitives):
            for name in self.unused_reference():
                state_dict.pop(self._key(prefix, p, name), None)

    def reference_state(self, prefix: str) -> dict:
        """This stack's tensors under ``prefix`` in the reference's layout,
        as CPU tensors."""
        out = {}
        for name, v in self.state_dict().items():
            v = v.detach().cpu()
            conv = self.conv_weight.fullmatch(name) is not None
            for p in range(self.n_primitives):
                out[self._key(prefix, p, name)] = (v[p, ..., None] if conv
                                                   else v[p]).clone()
        for p in range(self.n_primitives):
            for name, t in self.unused_reference().items():
                out[self._key(prefix, p, name)] = t.clone()
        return out


OMEGA = 30.0  # the SIREN layers' frequency (the reference's omega_0)


class _SineStack(nn.Module):
    """P SIREN layers' products (the reference's SineLayer.linear)."""

    def __init__(self, p: int, cin: int, cout: int, bound: float):
        super().__init__()
        self.linear = StackedLinear(p, cin, cout, init_bound=bound)


class GridDecoderStack(_PrimitiveStack):
    """P AdaIN-modulated folding decoders (GridDecoder) with stacked
    weights: grid [S, 2] and AdaIN params [B, A] shared by every primitive
    (or [P, B, A], each its own) -> [P, B, S, 3]. Per layer: conv -> AdaIN
    -> BN -> (SE) -> relu; then conv4 + tanh. With ``use_sine`` the SIREN
    decoder: four layers sin(AdaIN(30 * linear(x))) at widths b, b/2, b/4,
    b/4 and an output linear5 to 3 with no tanh, initialised as the
    reference's SineLayer (uniform, bound 1/in for the first layer,
    sqrt(6/in)/30 after it and sqrt(6/b)/30 for linear5); its params
    carry seven AdaIN sizes, the last three (adain1-3) registered but
    unused. Reference keys ``{p}.dec.<name>`` (``_PrimitiveStack``);
    AdaIN's dummy running statistics are registered-but-unused there."""

    reference_key = "{p}.dec.{name}"

    def __init__(self, n_primitives: int, bottleneck_size: int = 1026,
                 use_selayer: bool = False, serving: bool = False,
                 use_sine: bool = False):
        super().__init__(n_primitives)
        self.serving = serving
        self.use_selayer = use_selayer
        self.use_sine = use_sine
        self.sizes = grid_decoder_adain_sizes(bottleneck_size, use_sine)
        if use_sine:
            b = bottleneck_size
            widths = (2, b, b // 2, b // 4, b // 4)
            for i in range(4):
                cin = widths[i]
                bound = 1.0 / cin if i == 0 else math.sqrt(6.0 / cin) / OMEGA
                setattr(self, f"linear{i + 1}",
                        _SineStack(n_primitives, cin, widths[i + 1], bound))
            self.linear5 = StackedLinear(n_primitives, b // 4, 3,
                                         init_bound=math.sqrt(6.0 / b) / OMEGA)
            return
        chans = (2,) + self.sizes
        for i in range(3):
            setattr(self, f"conv{i + 1}",
                    StackedLinear(n_primitives, chans[i], chans[i + 1]))
            setattr(self, f"bn{i + 1}",
                    StackedBatchNorm(n_primitives, chans[i + 1]))
            if use_selayer:
                setattr(self, f"se{i + 1}",
                        StackedSE(n_primitives, chans[i + 1]))
        self.conv4 = StackedLinear(n_primitives, self.sizes[-1], 3)

    def unused_reference(self) -> dict:
        out = {} if self.use_sine else super().unused_reference()
        names = ([f"linear{i}.adain" for i in (1, 2, 3, 4)]
                 if self.use_sine else [])
        names += [f"adain{i}" for i in (1, 2, 3)]
        for name, nf in zip(names, self.sizes):
            out[f"{name}.running_mean"] = torch.zeros(nf)
            out[f"{name}.running_var"] = torch.ones(nf)
        return out

    def _sine(self, x: torch.Tensor, style, on: bool) -> torch.Tensor:
        for i, (w, bias) in enumerate(style[:4], 1):
            y = getattr(self, f"linear{i}").linear(x, bf16_product=on)
            x = torch.sin(adaptive_instance_norm(OMEGA * y, w, bias))
        return self.linear5(x, bf16_product=on)

    def forward(self, grid: torch.Tensor, adain_params: torch.Tensor):
        b = adain_params.shape[-2]
        dt = serving_dtype(self)
        x = grid.expand(1, b, *grid.shape)                     # [1, B, S, 2]
        style = split_adain_params(adain_params, self.sizes)
        if self.use_sine:
            return self._sine(x, style, dt is not None)
        for i, (w, bias) in enumerate(style, 1):
            x = getattr(self, f"conv{i}")(x, dt)
            x = adaptive_instance_norm(x, w, bias)
            x = getattr(self, f"bn{i}")(x)
            if self.use_selayer:
                x = getattr(self, f"se{i}")(x, serving=dt is not None)
            x = F.relu(x)
        return torch.tanh(self.conv4(x, dt)).float()


class AdaInGridDecoderStack(GridDecoderStack):
    """The ``no_share`` decoders: each primitive's own style MLP
    (Linear(D, D), ReLU, Linear(D, A), on ``StackedLinear``: one batched
    product over the primitives) emits the AdaIN params of its own
    GridDecoder: grid [S, 2] and style [B, D] -> [P, B, S, 3]. Reference
    keys ``{p}.mlp.0``/``{p}.mlp.2`` and ``{p}.dec.<name>``. In serving
    mode the MLP's products run at bf16 precision."""

    def __init__(self, n_primitives: int, style_size: int,
                 bottleneck_size: int = 1026, use_selayer: bool = False,
                 serving: bool = False):
        super().__init__(n_primitives, bottleneck_size, use_selayer, serving)
        self.mlp = nn.Sequential(
            StackedLinear(n_primitives, style_size, style_size, init_std=0.01),
            nn.ReLU(inplace=True),
            StackedLinear(n_primitives, style_size,
                          num_adain_params(bottleneck_size), init_std=0.01))

    def _key(self, prefix: str, p: int, name: str) -> str:
        if name.startswith("mlp."):
            return f"{prefix}{p}.{name}"
        return super()._key(prefix, p, name)

    def forward(self, grid: torch.Tensor, style: torch.Tensor):
        on = serving_dtype(self) is not None
        h = F.relu(self.mlp[0](style[None], bf16_product=on))  # [P, B, D]
        return super().forward(grid, self.mlp[2](h, bf16_product=on))


class PointGenConStack(_PrimitiveStack):
    """P folding decoders without AdaIN (the reference's PointGenCon, which
    AtlasNet and MSN run once a primitive and the JAX package vmaps), with
    stacked weights: grids [P, B, S, 2] and style [B, D] -> [P, B, S, 3].
    Each maps concat(grid, style) [B, S, D + 2] through 1x1 convs
    D + 2 -> D + 2 -> (D + 2) / 2 -> (D + 2) / 4 with BatchNorm and ReLU,
    then a conv to 3 and tanh; ``input_size`` sets the first conv's input
    width where it is not D + 2 (SpareNet's ``no_use`` decoders: 2 + 4096
    into 1026), ``use_selayer`` adds SE after each BatchNorm. The first
    conv's product is split: the style columns once a (primitive, sample),
    the two grid columns a point; the same sum, without the [P, B, S, D + 2]
    input. In serving mode the chain runs in bf16 as flax's dtype=bfloat16
    does (``dense``). Reference keys ``{p}.<name>`` (``_PrimitiveStack``)."""

    def __init__(self, n_primitives: int, bottleneck_size: int = 1026,
                 serving: bool = False, input_size: int | None = None,
                 use_selayer: bool = False):
        super().__init__(n_primitives)
        self.serving = serving
        self.use_selayer = use_selayer
        bs = bottleneck_size
        chans = (input_size or bs, bs, bs // 2, bs // 4, 3)
        for i in range(4):
            setattr(self, f"conv{i + 1}",
                    StackedLinear(n_primitives, chans[i], chans[i + 1]))
        for i in range(3):
            setattr(self, f"bn{i + 1}",
                    StackedBatchNorm(n_primitives, chans[i + 1]))
            if use_selayer:
                setattr(self, f"se{i + 1}",
                        StackedSE(n_primitives, chans[i + 1]))

    def _first(self, grids: torch.Tensor, style: torch.Tensor, dt):
        """conv1 of concat(grid, style): [P, B, S, D + 2]-wide input never
        built. In bf16 (flax's Dense(dtype=bf16)): the products of the bf16
        operands accumulated in f32, rounded to bf16 once, the bias added in
        bf16."""
        w, bias = self.conv1.weight, self.conv1.bias       # [P, C, D + 2]
        p, b, s, _ = grids.shape
        c = w.shape[1]
        wg, ws = w[..., :2].transpose(1, 2), w[..., 2:].transpose(1, 2)
        x = style.expand(p, -1, -1)                         # [P, B, D]
        g = grids.reshape(p * b, s, 2)
        wg = wg[:, None].expand(-1, b, -1, -1).reshape(p * b, 2, c)
        if dt is None:
            per_sample = torch.baddbmm(bias[:, None, :], x, ws)   # [P, B, C]
            return torch.baddbmm(per_sample.reshape(p * b, 1, c), g,
                                 wg).reshape(p, b, s, c)

        def r(t):
            return t.to(dt).float()
        per_sample = torch.bmm(r(x), r(ws)).reshape(p * b, 1, c)
        y = torch.baddbmm(per_sample, r(g), r(wg)).to(dt)
        return y.reshape(p, b, s, c) + bias[:, None, None, :].to(dt)

    def forward(self, grids: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        dt = serving_dtype(self)
        x = self._first(grids, style, dt)
        for i in (1, 2, 3):
            if i > 1:
                x = getattr(self, f"conv{i}")(x, dt)
            x = getattr(self, f"bn{i}")(x)
            if self.use_selayer:
                x = getattr(self, f"se{i}")(x, serving=dt is not None)
            x = F.relu(x)
        return torch.tanh(self.conv4(x, dt)).float()


# ---------------------------------------------------------------------------
# Residual refiner
# ---------------------------------------------------------------------------

class PointNetRes(nn.Module):
    """Residual refinement net: x [B, N, 4] -> [B, N, 3]; the global max
    feature is tiled and concatenated with the 64-d point features."""

    _CHANNELS = (4, 64, 128, 1024, 512, 256, 128, 3)

    def __init__(self, use_selayer: bool = False, serving: bool = False):
        super().__init__()
        self.serving = serving
        ch = self._CHANNELS
        for i in range(7):
            cin = 1088 if i == 3 else ch[i]
            setattr(self, f"conv{i + 1}", nn.Conv1d(cin, ch[i + 1], 1))
        for i in range(6):
            setattr(self, f"bn{i + 1}", nn.BatchNorm1d(ch[i + 1]))
        # registered but unused by the forward, as in the reference
        self.bn7 = nn.BatchNorm1d(3)
        self.use_selayer = use_selayer
        if use_selayer:
            for i in (1, 2, 4, 5, 6):  # no se3
                setattr(self, f"se{i}", SELayer(ch[i]))

    def _block(self, x: torch.Tensor, i: int, dt) -> torch.Tensor:
        x = bn_apply(getattr(self, f"bn{i}"),
                     conv1x1(getattr(self, f"conv{i}"), x, dt))
        if self.use_selayer:
            x = getattr(self, f"se{i}")(x, serving=dt is not None)
        return F.relu(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = serving_dtype(self)
        x = self._block(x, 1, dt)
        pointfeat = x
        x = self._block(x, 2, dt)
        x = bn_apply(self.bn3, conv1x1(self.conv3, x, dt))
        g = x.amax(1, keepdim=True).expand(-1, x.shape[1], -1)
        x = torch.cat([g, pointfeat], dim=-1)
        for i in (4, 5, 6):
            x = self._block(x, i, dt)
        return torch.tanh(conv1x1(self.conv7, x, dt)).float()


def graph_feature(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """DGCNN edge features [B, N, k, 2C] of x [B, N, C] over the graph idx
    [B, N, k]: concat(x_j - x_i, x_i) (the JAX package's
    get_graph_feature)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    nbr = x[rows, idx.long()]                                  # [B, N, k, C]
    center = x[:, :, None, :].expand_as(nbr)
    return torch.cat([nbr - center, center], dim=-1)


class EdgeRes(nn.Module):
    """EdgeConv residual refiner (the reference's EdgeRes, off unless the
    refine's ``edgeres`` is set): x [B, N, 4] -> [B, N, 3]. Six EdgeConv
    stages, each a kNN graph (k = 8) over its input features (the kNN
    kernel), the edge features, a 1x1 Conv2d without bias, BatchNorm2d,
    SE (``use_selayer``; over points and edges) and ReLU, then a max over
    the k edges: 4 -> 64 -> 128 -> 1024 (no SE, no ReLU), then
    concat(global max, the 64-d point features) 1088 -> 512 -> 256 -> 128;
    then a last graph, conv7 to 3, tanh and a max over the edges. Dense as
    in the JAX package (the edge tensor exists; seven graphs a call). In
    serving mode the products run at bf16 precision and the graphs take the
    packed kNN arm where it applies (the encoder's rule)."""

    _CHANNELS = (4, 64, 128, 1024, 512, 256, 128, 3)

    def __init__(self, use_selayer: bool = False, serving: bool = False,
                 k: int = 8):
        super().__init__()
        self.k = k
        self.serving = serving
        self.use_selayer = use_selayer
        ch = self._CHANNELS
        for i in range(7):
            cin = 1088 if i == 3 else ch[i]
            setattr(self, f"conv{i + 1}", nn.Conv2d(2 * cin, ch[i + 1], 1,
                                                    bias=False))
        for i in range(6):
            setattr(self, f"bn{i + 1}", nn.BatchNorm2d(ch[i + 1]))
        if use_selayer:
            for i in (1, 2, 4, 5, 6):  # no se3, as PointNetRes
                setattr(self, f"se{i}", SELayer(ch[i]))

    def _stage(self, feat: torch.Tensor, i: int, act: bool = True):
        on = serving_dtype(self) is not None
        nbr = knn.knn_idx(feat.contiguous(), self.k, packed=on)
        conv = getattr(self, f"conv{i}")
        e = product_bf16(graph_feature(feat, nbr),
                         conv.weight.reshape(conv.weight.shape[0], -1), on=on)
        if i == 7:
            return torch.tanh(e).amax(2)
        e = bn_apply(getattr(self, f"bn{i}"), e)
        if self.use_selayer and i != 3:
            e = getattr(self, f"se{i}")(e, serving=on)
        return (F.relu(e) if act else e).amax(2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._stage(x, 1)
        pointfeat = x
        x = self._stage(x, 2)
        x = self._stage(x, 3, act=False)
        g = x.amax(1, keepdim=True).expand(-1, x.shape[1], -1)
        x = torch.cat([g, pointfeat], dim=-1)
        for i in (4, 5, 6):
            x = self._stage(x, i)
        return self._stage(x, 7)


# ---------------------------------------------------------------------------
# Folding grid and initialisation
# ---------------------------------------------------------------------------

def grid_generation(num_points: int, nb_primitives: int) -> np.ndarray:
    """Fixed 2D folding grid shared by every primitive: [S, 2] float32 in
    [0, 1], grain 2^(floor/ceil(log2(S)/2)) - 1, x-major."""
    s = num_points / nb_primitives
    grain_x = 2 ** np.floor(np.log2(s) / 2) - 1
    grain_y = 2 ** np.ceil(np.log2(s) / 2) - 1
    xs = np.arange(int(grain_x) + 1) / grain_x
    ys = np.arange(int(grain_y) + 1) / grain_y
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx.reshape(-1), gy.reshape(-1)], -1).astype(np.float32)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """The reference's initialisation, drawn from ``generator``: Conv1d
    normal(0, 0.02); Conv2d, Conv3d and ConvTranspose3d kaiming normal
    (fan_in, gain sqrt 2; a transposed convolution's fan_in is its
    in_channels times its taps, as the JAX package's kernel counts it);
    Linear normal(0, 0.01); BatchNorm1d scale normal(1, 0.02); BatchNorm2d
    and BatchNorm3d scale 1; biases 0. Run it on the CPU so a seed gives the
    same weights on every device."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            fan_in = mod.in_channels * math.prod(mod.kernel_size)
            mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        elif isinstance(mod, nn.Conv1d):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, 0.01, generator=generator)
        elif isinstance(mod, StackedLinear) and mod.init_bound is not None:
            mod.weight.uniform_(-mod.init_bound, mod.init_bound,
                                generator=generator)
        elif isinstance(mod, StackedLinear):
            mod.weight.normal_(0.0, mod.init_std, generator=generator)
        elif isinstance(mod, (nn.BatchNorm1d, StackedBatchNorm)):
            mod.weight.normal_(1.0, 0.02, generator=generator)
        elif isinstance(mod, (nn.BatchNorm2d, nn.BatchNorm3d)):
            mod.weight.fill_(1.0)
        else:
            continue
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
