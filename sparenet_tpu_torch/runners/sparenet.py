"""The flagship SpareNet runner (counterpart of
sparenet_tpu/runners/sparenet.py: completion_loss, _train_impl and
sparenetRunner).

``train_step(model, optimizer, partial, gt, lr, cfg=None)`` runs one step on
the model's device: the train-mode forward, the completion loss, its
gradient, one Adam step at ``lr`` and the BatchNorm running-statistics
update (made by the forward). ``cfg`` holds the loss's settings as
``CONFIG`` does (the default: the flagship's); ``train_config`` reads them
from a run's config. It returns (loss, coarse_loss, refine_loss) as 0-d
tensors on the device. Like the other entry points it needs a card unless
the model was built with ``device="cpu"``.

``sparenetRunner`` is ``runners.base.BaseRunner`` with the generator and its
Adam built from the config (``build_models``; TRAIN.serving_aligned puts the
training forward's MDS on the batched arm, as the JAX package's
``define_G(train=True)`` does, and validation keeps exact greedy MDS), its
``train_step`` (a batch copied to the device, then ``train_step`` above at
the epoch's lr; losses into ``loss`` and the CoarseLoss/RefineLoss meters)
and its ``val_step``: the eval forward, the validation losses of coarse and
refine (Chamfer or EMD by NETWORK.metric, as ``_val_impl``) and
``utils.metrics.compute_all`` at TEST.emd_eps / emd_iters.
"""

from __future__ import annotations

from time import perf_counter

import torch

from ..configs import model_names
from ..models import build_generator, complete, resolve_device, set_parity_mode
from ..ops import chamfer, emd
from ..utils.metrics import Metrics, compute_all
from .base import BaseRunner, make_optimizer, set_lr
from .misc import AverageMeter

__all__ = ["CONFIG", "train_config", "completion_loss", "train_step",
           "sparenetRunner"]

# the loss's EMD protocol, which the reference fixes
# (sparenet_tpu/runners/sparenet.py:completion_loss)
EMD_EPS, EMD_ITERS = 0.005, 50
# The flagship's training settings: sparenet_tpu/configs/sparenet.yaml
# (NETWORK.metric emd, use_consist_loss true; TRAIN.batch_size 24,
# learning_rate 1e-4) over configs/defaults.py (TRAIN.betas (0, 0.9),
# weight_decay 0, lr_milestones [1000], gamma 0.5), and that protocol.
CONFIG = dict(metric="emd", use_consist_loss=True, batch_size=24,
              learning_rate=1e-4, betas=(0.0, 0.9), weight_decay=0,
              lr_milestones=(1000,), gamma=0.5, emd_eps=EMD_EPS,
              emd_iters=EMD_ITERS)


def train_config(cfg) -> dict:
    """A run's config (NETWORK and TRAIN) as the steps' settings dict."""
    t = cfg.TRAIN
    return dict(metric=cfg.NETWORK.metric,
                use_consist_loss=bool(cfg.NETWORK.use_consist_loss),
                batch_size=t.batch_size, learning_rate=t.learning_rate,
                betas=tuple(t.betas), weight_decay=t.weight_decay,
                lr_milestones=tuple(t.lr_milestones), gamma=t.gamma,
                emd_eps=EMD_EPS, emd_iters=EMD_ITERS)


def completion_loss(coarse, middle, refine, expansion, gt, metric="emd",
                    use_consist_loss=True, emd_eps=EMD_EPS,
                    emd_iters=EMD_ITERS):
    """(total, coarse_loss, refine_loss): EMD form mean(sqrt(dist)) or
    chamfer form mean(d1) + mean(d2) for each of coarse, middle and refine,
    + 0.1 * the expansion penalty, + 0.5 * mean(d1) of the one-sided
    consistency Chamfer of refine against gt."""
    if metric == "chamfer":
        def rec(a):
            return chamfer.chamfer_distance(a, gt)
    elif metric == "emd":
        def rec(a):
            dist, _ = emd.emd_auction(a, gt, emd_eps, emd_iters)
            return dist.sqrt().mean()
    else:
        raise ValueError(f"unknown training metric {metric!r}")
    coarse_loss, middle_loss, refine_loss = rec(coarse), rec(middle), rec(refine)
    loss = coarse_loss + middle_loss + refine_loss + expansion * 0.1
    if use_consist_loss:
        d1, _, _, _ = chamfer.chamfer_raw(refine, gt)
        loss = loss + d1.mean() * 0.5
    return loss, coarse_loss, refine_loss


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               partial: torch.Tensor, gt: torch.Tensor, lr: float,
               cfg: dict | None = None):
    """One training step; see the module docstring."""
    cfg = CONFIG if cfg is None else cfg
    set_parity_mode()
    dev = next(model.parameters()).device
    resolve_device(dev)
    for name, t in (("partial", partial), ("gt", gt)):
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be [B, N, 3], got {tuple(t.shape)}")
    x = partial.to(device=dev, dtype=torch.float32).contiguous()
    y = gt.to(device=dev, dtype=torch.float32).contiguous()
    model.train()
    optimizer.zero_grad(set_to_none=True)
    coarse, middle, refine, loss_mst = model(x)
    loss, coarse_loss, refine_loss = completion_loss(
        coarse, middle, refine, loss_mst, y, cfg["metric"],
        cfg["use_consist_loss"], cfg["emd_eps"], cfg["emd_iters"])
    loss.backward()
    set_lr(optimizer, lr)
    optimizer.step()
    return loss.detach(), coarse_loss.detach(), refine_loss.detach()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class sparenetRunner(BaseRunner):
    """The reference's class name, which the runner registry keys."""

    def __init__(self, config, logger, device=None):
        super().__init__(config, logger, device)
        self.losses = AverageMeter(["CoarseLoss", "RefineLoss"])
        self.test_losses = AverageMeter(["CoarseLoss", "RefineLoss"])
        self.test_metrics = AverageMeter(Metrics.names())

    def reset_meters(self):
        self.losses.reset()
        self.test_losses.reset()
        self.test_metrics = AverageMeter(Metrics.names())

    def build_models(self):
        """The generator (define_G's SpareNet: bottleneck and hide 4096),
        initialised from CONST.seed, and its Adam. The steps put it in
        train mode, the eval forward in eval mode."""
        cfg = self.config
        if cfg.NETWORK.model_type != model_names.MODEL_SPARENET:
            raise ValueError(f"sparenetRunner builds SpareNet, not "
                             f"{cfg.NETWORK.model_type!r}")
        self.step_config = train_config(cfg)
        self.model = build_generator(
            seed=cfg.CONST.seed, device=self.device,
            num_points=cfg.DATASET.n_outpoints, bottleneck_size=4096,
            hide_size=4096, n_primitives=cfg.NETWORK.n_primitives,
            use_selayer=cfg.NETWORK.use_selayer,
            use_adain=cfg.NETWORK.use_adain, encode=cfg.NETWORK.encode,
            train_mds="batched" if cfg.TRAIN.serving_aligned else "exact")
        self.optimizer = make_optimizer(self.model, self.step_config)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info("Parameters in net_G: %d." % n_params)

    def training_state(self) -> dict:
        return {"optim_G": self.optimizer}

    def _put_batch(self, data):
        """The batch's clouds on the device, the copy timed as data."""
        t0 = perf_counter()
        partial = torch.from_numpy(data["partial_cloud"]).to(self.device)
        gt = torch.from_numpy(data["gtcloud"]).to(self.device)
        _sync(self.device)
        self.train_seconds["data"] += perf_counter() - t0
        return partial, gt

    def train_step(self, items):
        _, _, _, data = items
        partial, gt = self._put_batch(data)
        loss, c_l, r_l = train_step(self.model, self.optimizer, partial, gt,
                                    self.lr, self.step_config)
        c_l, r_l = float(c_l) * 1000, float(r_l) * 1000
        self.loss = {"coarse_loss": c_l, "refine_loss": r_l,
                     "rec_loss": float(loss)}
        self.losses.update([c_l, r_l])

    def _val_impl(self, partial, gt):
        """(refine, coarse loss, refine loss) of one batch."""
        coarse, _, refine, _ = complete(self.model, partial)
        if self.config.NETWORK.metric == "emd":
            def rec(a):
                dist, _ = emd.emd_auction(a, gt, EMD_EPS, EMD_ITERS)
                return dist.sqrt().mean()
        else:
            def rec(a):
                return chamfer.chamfer_distance(a, gt)
        return refine, rec(coarse), rec(refine)

    @torch.no_grad()
    def val_step(self, items):
        _, _, _, data = items
        dev = self.device
        t0 = perf_counter()
        partial = torch.from_numpy(data["partial_cloud"]).to(dev)
        gt = torch.from_numpy(data["gtcloud"]).to(dev)
        _sync(dev)
        t1 = perf_counter()
        refine, c_l, r_l = self._val_impl(partial, gt)
        self.test_losses.update([float(c_l) * 1000, float(r_l) * 1000])
        t2 = perf_counter()
        self.ptcloud = refine
        vals = compute_all(refine, gt, eps=float(self.config.TEST.emd_eps),
                           iters=int(self.config.TEST.emd_iters))
        t3 = perf_counter()
        self.seconds["data"] += t1 - t0
        self.seconds["forward"] += t2 - t1
        self.seconds["metrics"] += t3 - t2
        return vals
