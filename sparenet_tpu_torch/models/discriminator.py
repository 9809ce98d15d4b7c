"""Discriminators of SpareNet-GAN with spectral normalisation (counterpart
of sparenet_tpu/models/discriminator.py).

Images come in channel-last [B, H, W, 16], as in the JAX package (2 x 8
views at the one radius a step renders: the partial input's depth maps
beside the real or fake ones),
and run through ``F.conv2d`` as NCHW; the feature maps returned for the
feature-matching loss are channel-last again.

Spectral norm is one power iteration a forward on the [out, in] matrix view
of the weight (torch's ``weight.view(out, -1)``): v = normalise(W^T u),
u' = normalise(W v), sigma = u' . (W v) with u' and v held constant, so
sigma is differentiable through W only. ``u`` is a buffer, replaced by u' in
train mode. The flattened input of ``SNDense`` is in (C, H, W) order, as a
torch model flattens NCHW; ``utils.weights.disc_state_dict_from_jax``
permutes the JAX kernel, which flattens (H, W, C).

BatchNorm in train mode is the JAX package's (flax): statistics over (N, H,
W), biased variance E[x^2] - E[x]^2, running update 0.9 / 0.1.
``ProjectionD`` keeps the reference's eps of 0.8 (``BatchNorm2d(c, 0.8)``
puts 0.8 on eps) and its Dropout2d(0.25), whose masks [B, C, 1, 1] are drawn
from an explicit ``torch.Generator`` by ``dropout_mask`` (the tests replace
that function to feed given masks).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import bn_train_stats, update_running

__all__ = ["SNConv", "SNDense", "SNEmbed", "PatchDiscriminator",
           "ProjectionD", "dropout_mask", "KEEP_PROB"]

KEEP_PROB = 0.75     # Dropout2d(0.25)


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (v.norm() + eps)


def spectral_sigma(w_mat: torch.Tensor, u: torch.Tensor,
                   update: bool) -> torch.Tensor:
    """One power iteration on w_mat [out, in] from u [out]; returns sigma
    (differentiable through w_mat only) and, with ``update``, stores the new
    u in place."""
    with torch.no_grad():
        w = w_mat.detach()
        v = _l2normalize(w.t() @ u)
        u_new = _l2normalize(w @ v)
        if update:
            u.copy_(u_new)
    return u_new @ (w_mat @ v)


class SNConv(nn.Module):
    """Spectral-normalised Conv2d (square kernel) over NCHW."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 padding: int, bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.register_buffer("u", torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_mat = self.weight.reshape(self.weight.shape[0], -1)
        sigma = spectral_sigma(w_mat, self.u, self.training)
        return F.conv2d(x, self.weight / sigma, self.bias, self.stride,
                        self.padding)


class SNDense(nn.Module):
    """Spectral-normalised Linear: weight [out, in], bias [out]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.register_buffer("u", torch.empty(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sigma = spectral_sigma(self.weight, self.u, self.training)
        return F.linear(x, self.weight / sigma, self.bias)


class SNEmbed(nn.Module):
    """Spectral-normalised embedding table [num_classes, features]."""

    def __init__(self, num_classes: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_classes, features))
        self.register_buffer("u", torch.empty(num_classes))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        sigma = spectral_sigma(self.weight, self.u, self.training)
        return (self.weight / sigma)[y.long()]


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the channels of NCHW x; train mode as the module
    docstring says."""
    if bn.training:
        mean, var = bn_train_stats(x, (0, 2, 3))
        update_running(bn.running_mean, bn.running_var, mean, var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((x - mean[:, None, None]) * mul[:, None, None]
            + bn.bias[:, None, None])


def dropout_mask(shape, generator: torch.Generator | None,
                 device) -> torch.Tensor:
    """Dropout2d keep mask (True = kept, probability KEEP_PROB), drawn on
    the CPU from ``generator`` so that a seed gives the same masks on every
    device."""
    return (torch.rand(shape, generator=generator) < KEEP_PROB).to(device)


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """leaky ReLU, slope 0.2, with flax's gradient 1 at x = 0 (F.leaky_relu
    takes the slope there; the first step meets exact zeros, a zero bias on
    the zero background of the depth maps)."""
    return torch.where(x >= 0, x, 0.2 * x)


IN_CHANNELS = 16      # 2 x 8 views x one radius


def _channel_last(feats):
    return [f.permute(0, 2, 3, 1) for f in feats]


class PatchDiscriminator(nn.Module):
    """Six SN conv blocks (k4 s2; BatchNorm from the second on), leaky ReLU
    0.2, then a 1-channel SN conv (k3 s1, no bias) averaged over the image:
    img [B, H, W, C] -> validity [B, 1] (and the first four feature maps)."""

    CHANNELS = (16, 32, 64, 128, 256, 512)

    def __init__(self):
        super().__init__()
        cin = IN_CHANNELS
        for i, ch in enumerate(self.CHANNELS, 1):
            setattr(self, f"conv{i}", SNConv(cin, ch, 4, 2, 1))
            if i > 1:
                setattr(self, f"bn{i}", nn.BatchNorm2d(ch, eps=1e-5))
            cin = ch
        self.adv = SNConv(cin, 1, 3, 1, 1, bias=False)

    def forward(self, img: torch.Tensor, feat: bool = False, y=None,
                generator: torch.Generator | None = None):
        """No dropout here: ``generator`` is unused (the signature is
        ProjectionD's)."""
        feats = []
        x = img.permute(0, 3, 1, 2)
        for i in range(1, len(self.CHANNELS) + 1):
            x = getattr(self, f"conv{i}")(x)
            if i > 1:
                x = _bn(getattr(self, f"bn{i}"), x)
            x = _leaky_relu(x)
            if i <= 4:
                feats.append(x)
        validity = self.adv(x).mean((2, 3))                    # [B, 1]
        return (validity, _channel_last(feats)) if feat else validity


class ProjectionD(nn.Module):
    """cGAN projection discriminator: four SN conv blocks (k3 s2) each with
    leaky ReLU 0.2, Dropout2d(0.25) and (from the second on) BatchNorm with
    eps 0.8, an SN linear head on the flattened (C, H, W) features, and,
    with classes, the inner product of an SN label embedding with them."""

    CHANNELS = (16, 32, 64, 128)

    def __init__(self, image_size: int = 256, num_classes: int = 0):
        super().__init__()
        cin = IN_CHANNELS
        for i, ch in enumerate(self.CHANNELS, 1):
            setattr(self, f"conv{i}", SNConv(cin, ch, 3, 2, 1))
            if i > 1:
                setattr(self, f"bn{i}", nn.BatchNorm2d(ch, eps=0.8))
            cin = ch
        side = image_size
        for _ in self.CHANNELS:
            side = (side - 1) // 2 + 1
        self.num_classes = num_classes
        self.adv = SNDense(cin * side * side, 1)
        if num_classes > 0:
            self.embed = SNEmbed(num_classes, cin * side * side)

    def forward(self, img: torch.Tensor, feat: bool = False, y=None,
                generator: torch.Generator | None = None):
        """In train mode the four Dropout2d masks come from
        ``dropout_mask(shape, generator, device)``."""
        feats = []
        x = img.permute(0, 3, 1, 2)
        for i in range(1, len(self.CHANNELS) + 1):
            x = _leaky_relu(getattr(self, f"conv{i}")(x))
            if self.training:
                keep = dropout_mask(x.shape[:2] + (1, 1), generator, x.device)
                x = torch.where(keep, x / KEEP_PROB, 0.0)
            if i > 1:
                x = _bn(getattr(self, f"bn{i}"), x)
            feats.append(x)
        out = x.reshape(x.shape[0], -1)
        validity = self.adv(out)
        if y is not None and self.num_classes > 0:
            validity = validity + (self.embed(y) * out).sum(1, keepdim=True)
        return (validity, _channel_last(feats)) if feat else validity
