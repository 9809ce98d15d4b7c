"""GRNet (counterpart of sparenet_tpu/models/grnet.py): gridding, a 3D
convolutional U-Net, gridding reverse, a random sample of points, cubic
features at three scales and an MLP of per-point offsets.

Volumes are the reference's channel-first [B, C, s, s, s], with the
reference's module names (``conv1``..``conv4``, ``fc5``, ``fc6``,
``dconv7``..``dconv10``, ``fc11``..``fc14``), so its state_dict loads with
``load_state_dict(strict=True)``; the convolutions run on cuDNN, as the JAX
package's run as XLA. Train-mode BatchNorm follows the JAX package (flax),
as ``layers.bn_apply`` does for point features: biased batch variance and
the running update 0.9 * running + 0.1 * statistic.

The sample of points (the reference's RandomPointSampling) is a Gumbel
top-k over the non-zero points of concat(partial, cloud): ``sample_indices``
is the selection, exact on ties (the lowest index first, as the JAX
package's ``lax.top_k``); the Gumbel noise is drawn on the CPU from a
``torch.Generator`` the caller owns (``gumbel_noise``), never from torch's
global RNG, as a uniform draw that the model's device turns into noise.
``forward(partial, sample_idx=None, generator=None)`` takes the sampled rows
as given with ``sample_idx`` (the tests and the card's witness check pass
the JAX package's), else draws them from ``generator``. The model runs no
kernel of the port: its ops have no Pallas counterpart in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cubic_feature_sampling import cubic_feature_sampling
from ..ops.gridding import gridding, gridding_reverse
from .layers import bn_train_stats, update_running

__all__ = ["GRNet", "sample_indices", "gumbel_noise", "bn3d"]


def bn3d(bn: nn.BatchNorm3d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the channel axis of [B, C, D, H, W] in flax's order of
    operations: eval mode (x - mean) * (rsqrt(var + eps) * scale) + bias on
    the running statistics; train mode the same on the batch statistics
    (mean, biased variance max(mean(x^2) - mean(x)^2, 0)), which update the
    running ones."""
    shape = (1, -1, 1, 1, 1)
    if bn.training:
        mean, var = bn_train_stats(x, (0, 2, 3, 4))
        update_running(bn.running_mean, bn.running_var, mean, var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)


def sample_indices(valid: torch.Tensor, gumbel: torch.Tensor,
                   n: int) -> torch.Tensor:
    """The rows of a uniform sample of n valid rows without replacement:
    valid [B, N] bool, gumbel [B, N] noise -> [B, n] int64, the n largest
    scores where(valid, 0, -inf) + gumbel, ties in index order (a stable
    descending sort). Fewer than n valid rows fill up with the lowest
    invalid ones, as the JAX package's ``lax.top_k``."""
    score = torch.where(valid, 0.0, float("-inf")) + gumbel
    order = torch.sort(score, dim=1, descending=True, stable=True).indices
    return order[:, :n]


def gumbel_noise(shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` on ``device``: u uniform in
    [tiny, 1) drawn on the CPU from ``generator`` (a generator state gives
    the same u on every device), then -log(-log(u)) on ``device``."""
    if generator is None:
        raise ValueError("pass sample_idx or a torch.Generator to draw the "
                         "sample from (the model never uses torch's global "
                         "RNG)")
    u = torch.rand(shape, generator=generator).to(device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return -torch.log(-torch.log(u))


class _MaxPool2(torch.autograd.Function):
    """max_pool3d(kernel 2, stride 2; an odd edge dropped) whose backward
    sends each output's gradient to its window's first maximum through the
    forward's indices (as max_pool3d's own backward and the JAX package's
    do). The windows do not overlap, so the scatter has no atomics: it is
    deterministic, where max_pool3d's CUDA backward has no deterministic
    form and raises under ``torch.use_deterministic_algorithms``."""

    @staticmethod
    def forward(ctx, x):
        y, idx = F.max_pool3d(x, 2, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.in_shape = x.shape
        return y

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, c = g.shape[:2]
        gx = g.new_zeros(b, c, math.prod(ctx.in_shape[2:]))
        gx.scatter_(2, idx.flatten(2), g.flatten(2))
        return gx.view(ctx.in_shape)


class _ConvBlock(nn.Sequential):
    """Conv3d(k=4, padding=2) and BatchNorm3d (the reference's ``.0`` and
    ``.1``), then LeakyReLU(0.2) and the 2x max-pool."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv3d(cin, cout, kernel_size=4, padding=2),
                         nn.BatchNorm3d(cout))

    def forward(self, x):
        x = F.leaky_relu(bn3d(self[1], self[0](x)), 0.2)
        return _MaxPool2.apply(x)


class _DeconvBlock(nn.Sequential):
    """ConvTranspose3d(k=4, stride 2, padding 1, no bias) and BatchNorm3d,
    then ReLU: exact 2x upsampling."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.ConvTranspose3d(cin, cout, kernel_size=4,
                                            stride=2, padding=1, bias=False),
                         nn.BatchNorm3d(cout))

    def forward(self, x):
        return F.relu(bn3d(self[1], self[0](x)))


class GRNet(nn.Module):
    """partial [B, N_in, 3] -> (sparse [B, n, 3], dense [B, 8 n, 3]),
    n = ``n_sampling_points``, on a grid of ``gridding_scale`` (64 in the
    shipped configuration; a multiple of 16)."""

    def __init__(self, n_sampling_points: int = 2048,
                 gridding_scale: int = 64):
        super().__init__()
        if gridding_scale % 16:
            raise ValueError(f"gridding_scale {gridding_scale} is no "
                             f"multiple of 16")
        self.n_sampling_points = n_sampling_points
        self.gridding_scale = gridding_scale
        flat = 256 * (gridding_scale // 16) ** 3
        for i, (cin, cout) in enumerate(((1, 32), (32, 64), (64, 128),
                                         (128, 256))):
            setattr(self, f"conv{i + 1}", _ConvBlock(cin, cout))
        self.fc5 = nn.Sequential(nn.Linear(flat, 2048), nn.ReLU())
        self.fc6 = nn.Sequential(nn.Linear(2048, flat), nn.ReLU())
        for i, (cin, cout) in enumerate(((256, 128), (128, 64), (64, 32),
                                         (32, 1))):
            setattr(self, f"dconv{i + 7}", _DeconvBlock(cin, cout))
        self.fc11 = nn.Sequential(nn.Linear(1792, 1792), nn.ReLU())
        self.fc12 = nn.Sequential(nn.Linear(1792, 448), nn.ReLU())
        self.fc13 = nn.Sequential(nn.Linear(448, 112), nn.ReLU())
        self.fc14 = nn.Linear(112, 24)

    # GRNet has no serving mode and no MDS temperature to calibrate
    resampler = None

    def candidates(self, partial: torch.Tensor):
        """partial [B, N_in, 3] -> (the sample's candidates, concat(partial,
        the gridding reverse cloud) [B, N_in + s^3, 3]; the U-Net's decoder
        volumes at s/2, s/4 and s/8, channel-first, that the cubic features
        read)."""
        s = self.gridding_scale
        v64_l = gridding(partial, s).unsqueeze(1)            # [B,1,s,s,s]
        v32_l = self.conv1(v64_l)
        v16_l = self.conv2(v32_l)
        v8_l = self.conv3(v16_l)
        v4_l = self.conv4(v8_l)
        back = self.fc6(self.fc5(v4_l.flatten(1)))
        v4_r = back.view(v4_l.shape) + v4_l
        v8_r = self.dconv7(v4_r) + v8_l
        v16_r = self.dconv8(v8_r) + v16_l
        v32_r = self.dconv9(v16_r) + v32_l
        v64_r = self.dconv10(v32_r) + v64_l
        cloud = gridding_reverse(v64_r.squeeze(1), s)
        return torch.cat([partial, cloud], 1), (v32_r, v16_r, v8_r)

    def forward(self, partial: torch.Tensor, sample_idx=None,
                generator: torch.Generator | None = None):
        b, n = partial.shape[0], self.n_sampling_points
        n_cand = partial.shape[1] + self.gridding_scale ** 3
        noise = None
        if sample_idx is None:     # drawn before the U-Net is queued
            noise = gumbel_noise((b, n_cand), generator, partial.device)
        elif tuple(sample_idx.shape) != (b, n):
            raise ValueError(f"sample_idx must be [{b}, {n}], got "
                             f"{list(sample_idx.shape)}")
        cand, volumes = self.candidates(partial)
        if noise is not None:
            sample_idx = sample_indices(cand.sum(-1) != 0.0, noise, n)
        idx = sample_idx.to(cand.device, torch.int64)
        rows = idx + torch.arange(b, device=idx.device).view(b, 1) * n_cand
        sparse = cand.reshape(b * n_cand, 3).index_select(
            0, rows.reshape(-1)).view(b, n, 3)
        return sparse, self.decode(sparse, volumes)

    def decode(self, sparse: torch.Tensor, volumes) -> torch.Tensor:
        """sparse [B, n, 3] and the decoder volumes -> dense [B, 8 n, 3]:
        each point's cubic features at the three scales (1792), the fc11-fc14
        MLP's 24 offsets, added to the point repeated 8 times."""
        b, n = sparse.shape[:2]
        feats = torch.cat([cubic_feature_sampling(sparse, v).reshape(b, n, -1)
                           for v in volumes], -1)            # [B, n, 1792]
        feats = self.fc13(self.fc12(self.fc11(feats)))
        offsets = self.fc14(feats).view(b, n * 8, 3)
        dense = sparse.unsqueeze(2).expand(b, n, 8, 3).reshape(b, n * 8, 3)
        return dense + offsets
