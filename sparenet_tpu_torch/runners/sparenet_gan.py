"""The SpareNet-GAN training step (counterpart of
sparenet_tpu/runners/sparenet_gan.py: sparenetGANRunner._gan_impl).

``gan_step(gen, disc, opt_g, opt_d, partial, gt, labels, lr, radius,
generator)`` runs one adversarial step on the models' device:

1. the train-mode generator forward and ``completion_loss`` (the flagship's
   EMD + consistency Chamfer);
2. depth maps of the generator's ``middle`` cloud (differentiated), and of
   ``gt`` and ``partial`` (not), at 8 views and the one ``radius``;
3. a discriminator step on concat(input maps, real maps) against
   concat(input maps, detached fake maps) with MSE labels 1 and 0, and
   Adam on the discriminator;
4. a generator step through the updated discriminator: weight_l2 * rec +
   weight_gan * adv + weight_fm * channel-weighted feature matching +
   weight_im * L1 between fake and real maps, with two more discriminator
   forwards (fake, then real, whose features are held constant). The
   discriminator's parameters take no gradient from this backward.

Each of the four discriminator forwards runs in train mode and advances its
spectral-norm u vectors and BatchNorm statistics, in that order; its
Dropout2d masks come from ``generator`` (a CPU ``torch.Generator``). It
returns (rec, coarse_loss, refine_loss, errG, errG_D, errD_real, errD_fake)
as 0-d tensors on the device, the losses ``_gan_impl`` returns. The radius
is the caller's: the reference draws it from ``RENDER.radius_list`` each
step.
"""

from __future__ import annotations

import torch

from ..models import resolve_device, set_parity_mode
from ..renderer import ComputeDepthMaps
from .base import set_lr
from .sparenet import CONFIG as FLAGSHIP_TRAIN
from .sparenet import completion_loss

__all__ = ["CONFIG", "gan_step"]

# sparenet_tpu/configs/sparenet_gan.yaml over configs/defaults.py: the
# flagship generator and loss (NETWORK as sparenet.yaml), RENDER (img 256,
# radius_list [5, 7, 10], orthorgonal, eyepos 1, 8 views), GAN (weight_gan
# 0.1, weight_l2 200, weight_im 1, weight_fm 1), TRAIN (batch_size 32,
# learning_rate 1e-4, betas (0, 0.9), weight_decay 0). The yaml's GAN.use_im,
# use_fm and use_cgan are all true and DATASET.num_class is 0: gan_step is
# written for those settings only (every loss term on, the labels passed to
# a ProjectionD that has no class embedding).
CONFIG = dict(FLAGSHIP_TRAIN, batch_size=32, learning_rate=1e-4,
              img_size=256, radius_list=(5.0, 7.0, 10.0),
              projection="orthorgonal", eyepos=1.0, weight_gan=0.1,
              weight_l2=200.0, weight_im=1.0, weight_fm=1.0)


def gan_step(gen: torch.nn.Module, disc: torch.nn.Module,
             opt_g: torch.optim.Optimizer, opt_d: torch.optim.Optimizer,
             partial: torch.Tensor, gt: torch.Tensor, labels: torch.Tensor,
             lr: float, radius: float, generator: torch.Generator):
    """One SpareNet-GAN step; see the module docstring."""
    set_parity_mode()
    cfg = CONFIG
    dev = next(gen.parameters()).device
    resolve_device(dev)
    if next(disc.parameters()).device != dev:
        raise ValueError("gan_step: the generator and the discriminator are "
                         "on different devices")
    for name, t in (("partial", partial), ("gt", gt)):
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be [B, N, 3], got {tuple(t.shape)}")
    x = partial.to(device=dev, dtype=torch.float32).contiguous()
    y = gt.to(device=dev, dtype=torch.float32).contiguous()
    labels = labels.to(dev)
    render = ComputeDepthMaps(cfg["projection"], cfg["eyepos"], cfg["img_size"])
    radii = (float(radius),)

    # generator forward, completion loss, the fake render
    gen.train()
    disc.train()
    opt_g.zero_grad(set_to_none=True)
    coarse, middle, refine, loss_mst = gen(x)
    rec, coarse_loss, refine_loss = completion_loss(
        coarse, middle, refine, loss_mst, y, cfg["metric"],
        cfg["use_consist_loss"])
    fake = render.render_all_views(middle, radii)
    with torch.no_grad():
        real = render.render_all_views(y, radii)
        inp = render.render_all_views(x, radii)
    real_pair = torch.cat([inp, real], -1)

    # discriminator step on the detached fakes
    opt_d.zero_grad(set_to_none=True)
    pred_real = disc(real_pair, y=labels, generator=generator)
    pred_fake = disc(torch.cat([inp, fake.detach()], -1), y=labels,
                     generator=generator)
    err_real = ((pred_real - 1.0) ** 2).mean()
    err_fake = (pred_fake ** 2).mean()
    (err_real + err_fake).backward()
    set_lr(opt_d, lr)
    opt_d.step()

    # generator step through the updated discriminator
    d_params = [p for p in disc.parameters() if p.requires_grad]
    for p in d_params:
        p.requires_grad_(False)
    try:
        pred, fake_feats = disc(torch.cat([inp, fake], -1), feat=True,
                                y=labels, generator=generator)
        with torch.no_grad():
            _, real_feats = disc(real_pair, feat=True, y=labels,
                                 generator=generator)
        ch = [f.shape[-1] for f in fake_feats]
        loss_fm = sum((c / sum(ch)) * ((ff - rf) ** 2).mean()
                      for c, ff, rf in zip(ch, fake_feats, real_feats))
        err_g_d = ((pred - 1.0) ** 2).mean()
        err_g = cfg["weight_l2"] * rec + (
            cfg["weight_gan"] * err_g_d + cfg["weight_fm"] * loss_fm
            + cfg["weight_im"] * (fake - real).abs().mean())
        err_g.backward()
    finally:
        for p in d_params:
            p.requires_grad_(True)
    set_lr(opt_g, lr)
    opt_g.step()
    return tuple(t.detach() for t in (rec, coarse_loss, refine_loss, err_g,
                                      err_g_d, err_real, err_fake))
