"""The SpareNet-GAN runner (counterpart of
sparenet_tpu/runners/sparenet_gan.py: sparenetGANRunner and its _gan_impl).

``gan_step(gen, disc, opt_g, opt_d, partial, gt, labels, lr, radius,
generator, cfg=None)`` runs one adversarial step on the models' device:

1. the train-mode generator forward and ``completion_loss`` (NETWORK.metric,
   the consistency Chamfer if NETWORK.use_consist_loss);
2. depth maps of the generator's ``middle`` cloud (differentiated), and of
   ``gt`` and ``partial`` (not), at 8 views and the one ``radius``;
3. a discriminator step on concat(input maps, real maps) against
   concat(input maps, detached fake maps) with MSE labels 1 and 0, and
   Adam on the discriminator;
4. a generator step through the updated discriminator: weight_l2 * rec +
   weight_gan * adv, + weight_fm * channel-weighted feature matching with
   use_fm (a fourth discriminator forward, on the real maps, whose features
   are held constant), + weight_im * L1 between fake and real maps with
   use_im. The discriminator's parameters take no gradient from this
   backward.

The discriminator gets ``labels`` with use_cgan (a ``ProjectionD`` with
classes adds its label-embedding term). Each of its forwards runs in train
mode and advances its spectral-norm u vectors and BatchNorm statistics, in
that order; its Dropout2d masks come from ``generator`` (a CPU
``torch.Generator``). ``cfg`` holds the step's settings as ``CONFIG`` does
(the default: sparenet_gan.yaml's); ``gan_config`` reads them from a run's
config. It returns (rec, coarse_loss, refine_loss, errG, errG_D,
errD_real, errD_fake) as 0-d tensors on the device, the losses ``_gan_impl``
returns.

``sparenetGANRunner`` is ``sparenetRunner`` with the discriminator
(``ProjectionD(num_classes=DATASET.num_class)`` with GAN.use_cgan, else
``PatchDiscriminator``), its Adam and the renderer. Each step draws its
radius from RENDER.radius_list with a ``torch.Generator`` seeded from
CONST.seed (the JAX package draws it with Python's unseeded
``random.sample``), and the dropout masks come from a second one; both are
kept in the checkpoint with the whole GAN (``training_state``).
"""

from __future__ import annotations

import torch

from ..models import build_discriminator, resolve_device, set_parity_mode
from ..renderer import ComputeDepthMaps
from .base import make_optimizer, set_lr
from .misc import AverageMeter
from .sparenet import CONFIG as FLAGSHIP_TRAIN
from .sparenet import completion_loss, sparenetRunner, train_config

__all__ = ["CONFIG", "gan_config", "gan_step", "sparenetGANRunner"]

# sparenet_tpu/configs/sparenet_gan.yaml over configs/defaults.py: the
# flagship generator and loss (NETWORK as sparenet.yaml), RENDER (img 256,
# radius_list [5, 7, 10], orthorgonal, eyepos 1, 8 views), GAN (use_im,
# use_fm and use_cgan true, weight_gan 0.1, weight_l2 200, weight_im 1,
# weight_fm 1), TRAIN (batch_size 32, learning_rate 1e-4, betas (0, 0.9),
# weight_decay 0).
CONFIG = dict(FLAGSHIP_TRAIN, batch_size=32, learning_rate=1e-4,
              img_size=256, radius_list=(5.0, 7.0, 10.0),
              projection="orthorgonal", eyepos=1.0, use_im=True, use_fm=True,
              use_cgan=True, weight_gan=0.1, weight_l2=200.0, weight_im=1.0,
              weight_fm=1.0)


def gan_config(cfg) -> dict:
    """A run's config (NETWORK, TRAIN, RENDER and GAN) as the step's
    settings dict."""
    r, g = cfg.RENDER, cfg.GAN
    return dict(train_config(cfg), img_size=int(r.img_size),
                radius_list=tuple(float(v) for v in r.radius_list),
                projection=r.projection, eyepos=float(r.eyepos),
                use_im=bool(g.use_im), use_fm=bool(g.use_fm),
                use_cgan=bool(g.use_cgan), weight_gan=float(g.weight_gan),
                weight_l2=float(g.weight_l2), weight_im=float(g.weight_im),
                weight_fm=float(g.weight_fm))


def gan_step(gen: torch.nn.Module, disc: torch.nn.Module,
             opt_g: torch.optim.Optimizer, opt_d: torch.optim.Optimizer,
             partial: torch.Tensor, gt: torch.Tensor, labels: torch.Tensor,
             lr: float, radius: float, generator: torch.Generator,
             cfg: dict | None = None):
    """One SpareNet-GAN step; see the module docstring."""
    set_parity_mode()
    cfg = CONFIG if cfg is None else cfg
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
    labels = labels.to(dev) if cfg["use_cgan"] else None
    render = ComputeDepthMaps(cfg["projection"], cfg["eyepos"], cfg["img_size"])
    radii = (float(radius),)

    # generator forward, completion loss, the fake render
    gen.train()
    disc.train()
    opt_g.zero_grad(set_to_none=True)
    coarse, middle, refine, loss_mst = gen(x)
    rec, coarse_loss, refine_loss = completion_loss(
        coarse, middle, refine, loss_mst, y, cfg["metric"],
        cfg["use_consist_loss"], cfg["emd_eps"], cfg["emd_iters"])
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
        fake_pair = torch.cat([inp, fake], -1)
        if cfg["use_fm"]:
            pred, fake_feats = disc(fake_pair, feat=True, y=labels,
                                    generator=generator)
            with torch.no_grad():
                _, real_feats = disc(real_pair, feat=True, y=labels,
                                     generator=generator)
            ch = [f.shape[-1] for f in fake_feats]
            loss_fm = sum((c / sum(ch)) * ((ff - rf) ** 2).mean()
                          for c, ff, rf in zip(ch, fake_feats, real_feats))
        else:
            pred = disc(fake_pair, y=labels, generator=generator)
        err_g_d = ((pred - 1.0) ** 2).mean()
        img = cfg["weight_gan"] * err_g_d
        if cfg["use_fm"]:
            img = img + cfg["weight_fm"] * loss_fm
        if cfg["use_im"]:
            img = img + cfg["weight_im"] * (fake - real).abs().mean()
        err_g = cfg["weight_l2"] * rec + img
        err_g.backward()
    finally:
        for p in d_params:
            p.requires_grad_(True)
    set_lr(opt_g, lr)
    opt_g.step()
    return tuple(t.detach() for t in (rec, coarse_loss, refine_loss, err_g,
                                      err_g_d, err_real, err_fake))


class sparenetGANRunner(sparenetRunner):
    """The reference's class name, which the runner registry keys."""

    LOSSES = ("CoarseLoss", "RefineLoss", "errG", "errG_D", "DisRealLoss",
              "DisFakeLoss")

    def __init__(self, config, logger, device=None):
        super().__init__(config, logger, device)
        self.losses = AverageMeter(list(self.LOSSES))
        self.radii: list[float] = []

    def build_models(self):
        """The generator and its Adam, then the discriminator (initialised
        from CONST.seed + 1, as the JAX package seeds it), its Adam and the
        two step generators."""
        super().build_models()
        cfg = self.config
        self.step_config = gan_config(cfg)
        self.disc = build_discriminator(
            seed=cfg.CONST.seed + 1, device=self.device,
            use_cgan=cfg.GAN.use_cgan, num_classes=cfg.DATASET.num_class,
            image_size=cfg.RENDER.img_size)
        self.optimizer_d = make_optimizer(self.disc, self.step_config)
        self.radius_generator = torch.Generator().manual_seed(cfg.CONST.seed)
        self.dropout_generator = torch.Generator().manual_seed(
            cfg.CONST.seed + 2)
        n_params = sum(p.numel() for p in self.disc.parameters())
        self.logger.info("Parameters in net_D: %d." % n_params)

    def training_state(self) -> dict:
        return {"optim_G": self.optimizer, "net_D": self.disc,
                "optim_D": self.optimizer_d,
                "rng_radius": self.radius_generator,
                "rng_dropout": self.dropout_generator}

    def draw_radius(self) -> float:
        radii = self.step_config["radius_list"]
        i = int(torch.randint(len(radii), (), generator=self.radius_generator))
        return radii[i]

    def train_step(self, items):
        _, labels, _, data = items
        partial, gt = self._put_batch(data)
        radius = self.draw_radius()
        self.radii.append(radius)
        out = gan_step(self.model, self.disc, self.optimizer, self.optimizer_d,
                       partial, gt, torch.from_numpy(labels).long(), self.lr,
                       radius, self.dropout_generator, self.step_config)
        rec, c_l, r_l, err_g, err_g_d, err_real, err_fake = map(float, out)
        c_l, r_l = c_l * 1000, r_l * 1000
        self.loss = {"coarse_loss": c_l, "refine_loss": r_l, "rec_loss": rec,
                     "errG": err_g, "errG_D": err_g_d, "errD_real": err_real,
                     "errD_fake": err_fake}
        self.losses.update([c_l, r_l, err_g, err_g_d, err_real, err_fake])
