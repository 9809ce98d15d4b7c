"""Model building blocks, channel-last (counterpart of
sparenet_tpu/models/layers.py), in eval and train mode (``module.training``).

Point features are [B, N, C], as in the JAX package. Every layer keeps the
parameter names and shapes of the original reference's torch modules
(Conv1d weights [out, in, 1], BatchNorm running stats, ...), so a state_dict
in that layout (see ``sparenet_tpu_torch.utils.weights``) loads with
``load_state_dict(strict=True)``. The 1x1 convolutions run as ``F.linear``
over the channel axis, never as cuDNN convolutions.

The 32 per-primitive folding decoders are one ``GridDecoderStack`` with
stacked weights [P, out, in] and batched products; a load hook stacks the
reference's per-primitive keys.

Train-mode BatchNorm follows the JAX package (flax), not ``nn.BatchNorm``'s
own training update: statistics over every axis but the channel, the
variance biased and computed as max(mean(x^2) - mean(x)^2, 0), and the
running update 0.9 * running + 0.1 * statistic with that biased variance.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import edge_gather, gather, knn

__all__ = [
    "conv1x1", "bn_eval", "bn_affine", "bn_apply", "bn_train_stats",
    "external_stats_affine", "SELayer", "EdgeConvResFeat",
    "adaptive_instance_norm", "grid_decoder_adain_sizes", "num_adain_params",
    "split_adain_params", "StackedLinear", "StackedBatchNorm", "StackedSE",
    "GridDecoderStack", "PointNetRes", "grid_generation", "init_weights",
]


# ---------------------------------------------------------------------------
# 1x1 convolutions, BatchNorm (eval), squeeze-excitation
# ---------------------------------------------------------------------------

def conv1x1(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv1d/Conv2d (weight [out, in, 1(, 1)]) applied over the last
    axis of channel-last x [..., in]."""
    w = conv.weight.reshape(conv.weight.shape[0], -1)
    return F.linear(x, w, conv.bias)


def bn_eval(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis, in flax's order of operations:
    (x - mean) * (rsqrt(var + eps) * scale) + bias."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return (x - bn.running_mean) * mul + bn.bias


_MOMENTUM = 0.9  # flax's EMA decay (torch momentum 0.1)


def bn_train_stats(x: torch.Tensor, dims):
    """flax's batch statistics (use_fast_variance): mean and the biased
    variance max(mean(x^2) - mean(x)^2, 0) over ``dims``."""
    mean = x.mean(dims)
    var = ((x * x).mean(dims) - mean * mean).clamp_min(0.0)
    return mean, var


@torch.no_grad()
def update_running(running_mean: torch.Tensor, running_var: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor) -> None:
    """running <- 0.9 * running + 0.1 * statistic, in place (flax's EMA)."""
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

    def forward(self, x: torch.Tensor, mean: torch.Tensor | None = None):
        if mean is None:
            mean = x.mean(dim=tuple(range(1, x.dim() - 1)))
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
                 output_size: int = 4096, use_selayer: bool = False):
        super().__init__()
        self.k = k
        self.use_selayer = use_selayer
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
        nbr = knn.knn_idx(feat, self.k)                        # [B, N, k]
        c = feat.shape[-1]
        w = getattr(self, f"conv{i}").weight.reshape(-1, 2 * c)
        g1 = F.linear(feat, w[:, :c])
        diff = F.linear(feat, w[:, c:]) - g1
        a, b0 = bn_affine(getattr(self, f"bn{i}"))
        g1s = g1 * a
        if not self.use_selayer:
            m = gather.gather_max(g1s, nbr)
            return F.leaky_relu(m + a * diff + b0, 0.2)
        m, s = gather.gather_max(g1s, nbr, need_sum=True)
        n, k = nbr.shape[1], nbr.shape[2]
        z_mean = s / float(n * k) + a * diff.mean(1) + b0
        z = getattr(self, f"se{i}")(m + a * diff + b0, mean=z_mean)
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
        x1 = self._stage(x, 1)
        x2 = self._stage(x1, 2) + conv1x1(self.resconv1, x1)
        x3 = self._stage(x2, 3) + conv1x1(self.resconv2, x2)
        x4 = self._stage(x3, 4) + conv1x1(self.resconv3, x3)
        xc = torch.cat([x1, x2, x3, x4], dim=-1)
        xc = F.leaky_relu(bn_apply(self.bn5, conv1x1(self.conv5, xc)), 0.2)
        return torch.cat([xc.amax(1), xc.mean(1)], dim=-1)


# ---------------------------------------------------------------------------
# AdaIN
# ---------------------------------------------------------------------------

def adaptive_instance_norm(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor, eps: float = 1e-5):
    """AdaIN over the point axis (-2): x [..., B, N, C], weight/bias [B, C];
    instance statistics per (sample, channel), biased variance."""
    mean = x.mean(-2, keepdim=True)
    var = ((x - mean) ** 2).mean(-2, keepdim=True)
    xn = (x - mean) * torch.rsqrt(var + eps)
    return xn * weight[:, None, :] + bias[:, None, :]


def grid_decoder_adain_sizes(bottleneck_size: int) -> tuple[int, ...]:
    """Per-layer AdaIN feature counts of the (non-SIREN) GridDecoder."""
    b = bottleneck_size
    return (b, b // 2, b // 4)


def num_adain_params(bottleneck_size: int) -> int:
    return 2 * sum(grid_decoder_adain_sizes(bottleneck_size))


def split_adain_params(params: torch.Tensor, sizes):
    """Per AdaIN layer, (weight, bias) = (std, mean) consumed in order:
    each layer's slice is [mean(=bias) | std(=weight)]."""
    out, off = [], 0
    for nf in sizes:
        bias = params[:, off:off + nf]
        weight = params[:, off + nf:off + 2 * nf]
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
                 init_std: float = 0.02):
        super().__init__()
        self.init_std = init_std
        self.weight = nn.Parameter(torch.empty(p, cout, cin))
        self.bias = nn.Parameter(torch.zeros(p, cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.weight.shape[0]
        lead = x.shape[1:-1]
        x2 = x.expand(p, *x.shape[1:]).reshape(p, -1, x.shape[-1])
        wt = self.weight.transpose(1, 2)
        if self.bias is None:
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
                + self.bias.reshape(shape))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc(x.mean(2))                                 # [P, B, C]
        return x * y[:, :, None, :]


class GridDecoderStack(nn.Module):
    """P AdaIN-modulated folding decoders (non-SIREN GridDecoder) with
    stacked weights: grid [S, 2] and shared AdaIN params [B, A] ->
    [P, B, S, 3]. Per layer: conv -> AdaIN -> BN -> (SE) -> relu; then
    conv4 + tanh.

    State-dict keys are the reference's per-primitive layout with the
    primitive index folded into a leading axis: ``conv1.weight`` [P, out, in]
    stands for ``{p}.dec.conv1.weight`` [out, in, 1]. ``load_state_dict``
    takes either; the hook below stacks the reference layout."""

    def __init__(self, n_primitives: int, bottleneck_size: int = 1026,
                 use_selayer: bool = False):
        super().__init__()
        self.n_primitives = n_primitives
        self.sizes = grid_decoder_adain_sizes(bottleneck_size)
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
        self.use_selayer = use_selayer
        self._register_load_state_dict_pre_hook(self._stack_reference_keys)

    def _stack_reference_keys(self, state_dict, prefix, *args):
        if prefix + "0.dec.conv1.weight" not in state_dict:
            return
        for name, t in list(self.named_parameters()) + list(self.named_buffers()):
            keys = [f"{prefix}{p}.dec.{name}" for p in range(self.n_primitives)]
            if all(k in state_dict for k in keys):
                state_dict[prefix + name] = torch.stack(
                    [torch.as_tensor(state_dict.pop(k)).reshape(t.shape[1:])
                     for k in keys])
        # registered-but-unused reference tensors with no counterpart here:
        # BatchNorm step counts and AdaIN's dummy running stats
        for p in range(self.n_primitives):
            for i in (1, 2, 3):
                for k in (f"bn{i}.num_batches_tracked",
                          f"adain{i}.running_mean", f"adain{i}.running_var"):
                    state_dict.pop(f"{prefix}{p}.dec.{k}", None)

    def forward(self, grid: torch.Tensor, adain_params: torch.Tensor):
        b = adain_params.shape[0]
        x = grid.expand(1, b, *grid.shape)                     # [1, B, S, 2]
        for i, (w, bias) in enumerate(split_adain_params(adain_params,
                                                         self.sizes), 1):
            x = getattr(self, f"conv{i}")(x)
            x = adaptive_instance_norm(x, w, bias)
            x = getattr(self, f"bn{i}")(x)
            if self.use_selayer:
                x = getattr(self, f"se{i}")(x)
            x = F.relu(x)
        return torch.tanh(self.conv4(x))


# ---------------------------------------------------------------------------
# Residual refiner
# ---------------------------------------------------------------------------

class PointNetRes(nn.Module):
    """Residual refinement net: x [B, N, 4] -> [B, N, 3]; the global max
    feature is tiled and concatenated with the 64-d point features."""

    _CHANNELS = (4, 64, 128, 1024, 512, 256, 128, 3)

    def __init__(self, use_selayer: bool = False):
        super().__init__()
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

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        x = bn_apply(getattr(self, f"bn{i}"), conv1x1(getattr(self, f"conv{i}"), x))
        if self.use_selayer:
            x = getattr(self, f"se{i}")(x)
        return F.relu(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._block(x, 1)
        pointfeat = x
        x = self._block(x, 2)
        x = bn_apply(self.bn3, conv1x1(self.conv3, x))
        g = x.amax(1, keepdim=True).expand(-1, x.shape[1], -1)
        x = torch.cat([g, pointfeat], dim=-1)
        for i in (4, 5, 6):
            x = self._block(x, i)
        return torch.tanh(conv1x1(self.conv7, x))


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
    normal(0, 0.02); Conv2d kaiming normal (fan_in, gain sqrt 2); Linear
    normal(0, 0.01); BatchNorm1d scale normal(1, 0.02); BatchNorm2d scale 1;
    biases 0. Run it on the CPU so a seed gives the same weights on every
    device."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
        elif isinstance(mod, nn.Conv1d):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, 0.01, generator=generator)
        elif isinstance(mod, StackedLinear):
            mod.weight.normal_(0.0, mod.init_std, generator=generator)
        elif isinstance(mod, (nn.BatchNorm1d, StackedBatchNorm)):
            mod.weight.normal_(1.0, 0.02, generator=generator)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.fill_(1.0)
        else:
            continue
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
