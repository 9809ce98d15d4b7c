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
Adam built from the config (``build_models``: ``models.define_G``, as the
JAX package's: NETWORK.mml_calibration when it is > 0, else the family's
1.33; TRAIN.serving_aligned puts the training forward's MDS on the batched
arm, as ``define_G(train=True)`` does; with a serving dial the eval forward
runs serving mode on it, and the training forward parity), its
``train_step`` (a batch copied to the device, then ``train_step`` above at
the epoch's lr; losses into ``loss`` and the CoarseLoss/RefineLoss meters)
and its ``val_step``: the eval forward (serving mode with a dial), the
validation losses of coarse and refine (Chamfer or EMD by NETWORK.metric, as
``_val_impl``) and ``utils.metrics.compute_all`` at TEST.emd_eps /
emd_iters, in fp32 in either mode; a batch without ground truth runs the
forward alone.
"""

from __future__ import annotations

from time import perf_counter

import torch

from ..configs import model_names
from ..models import complete, define_G, resolve_device, set_parity_mode
from ..ops import chamfer, emd
from ..utils.metrics import Metrics, compute_all
from .base import BaseRunner, make_optimizer, set_lr
from .misc import AverageMeter

__all__ = ["CONFIG", "train_config", "reconstruction", "completion_loss",
           "train_step", "sparenetRunner"]

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


def reconstruction(pred, gt, metric="emd", emd_eps=EMD_EPS,
                   emd_iters=EMD_ITERS):
    """One cloud's reconstruction loss against gt: the EMD form
    mean(sqrt(dist)) of the auction at (emd_eps, emd_iters), or the chamfer
    form mean(d1) + mean(d2) (the JAX package's _single_loss)."""
    if metric == "chamfer":
        return chamfer.chamfer_distance(pred, gt)
    if metric == "emd":
        dist, _ = emd.emd_auction(pred, gt, emd_eps, emd_iters)
        return dist.sqrt().mean()
    raise ValueError(f"unknown training metric {metric!r}")


def completion_loss(coarse, middle, refine, expansion, gt, metric="emd",
                    use_consist_loss=True, emd_eps=EMD_EPS,
                    emd_iters=EMD_ITERS):
    """(total, coarse_loss, refine_loss): ``reconstruction`` of each of
    coarse, middle and refine, + 0.1 * the expansion penalty, + 0.5 *
    mean(d1) of the one-sided consistency Chamfer of refine against gt."""
    def rec(a):
        return reconstruction(a, gt, metric, emd_eps, emd_iters)
    coarse_loss, middle_loss, refine_loss = rec(coarse), rec(middle), rec(refine)
    loss = coarse_loss + middle_loss + refine_loss + expansion * 0.1
    if use_consist_loss:
        d1, _, _, _ = chamfer.chamfer_raw(refine, gt)
        loss = loss + d1.mean() * 0.5
    return loss, coarse_loss, refine_loss


def step_inputs(model: torch.nn.Module, partial: torch.Tensor,
                gt: torch.Tensor):
    """A step's clouds as f32 on the model's device (parity mode set, the
    device checked, each [B, N, 3])."""
    set_parity_mode()
    dev = next(model.parameters()).device
    resolve_device(dev)
    for name, t in (("partial", partial), ("gt", gt)):
        if t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be [B, N, 3], got {tuple(t.shape)}")
    return (partial.to(device=dev, dtype=torch.float32).contiguous(),
            gt.to(device=dev, dtype=torch.float32).contiguous())


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               partial: torch.Tensor, gt: torch.Tensor, lr: float,
               cfg: dict | None = None):
    """One training step; see the module docstring."""
    cfg = CONFIG if cfg is None else cfg
    x, y = step_inputs(model, partial, gt)
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

    model_type = model_names.MODEL_SPARENET

    def __init__(self, config, logger, device=None, dial=None):
        super().__init__(config, logger, device, dial)
        self.losses = AverageMeter(["CoarseLoss", "RefineLoss"])
        self.test_losses = AverageMeter(["CoarseLoss", "RefineLoss"])
        self.test_metrics = AverageMeter(Metrics.names())

    def reset_meters(self):
        self.losses.reset()
        self.test_losses.reset()
        self.test_metrics = AverageMeter(Metrics.names())

    def build_models(self):
        """The generator (``models.define_G`` of the runner's model type:
        NETWORK.mml_calibration when it is > 0, serving mode on the dial
        where there is one), initialised from CONST.seed, and its Adam. The
        steps put it in train mode, the eval forward in eval mode."""
        cfg = self.config
        if cfg.NETWORK.model_type != self.model_type:
            raise ValueError(f"{type(self).__name__} builds {self.model_type}"
                             f", not {cfg.NETWORK.model_type!r}")
        self.step_config = train_config(cfg)
        self.model = define_G(cfg, device=self.device, dial=self.dial)
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

    def rec(self, pred, gt):
        """A validation loss: ``reconstruction`` by NETWORK.metric (EMD at
        the loss's protocol, else Chamfer), as ``_val_impl`` takes it."""
        metric = "emd" if self.config.NETWORK.metric == "emd" else "chamfer"
        return reconstruction(pred, gt, metric)

    def _val_impl(self, partial, gt):
        """(refine, the validation losses: coarse and refine, or None
        without ``gt``) of one batch."""
        coarse, _, refine, _ = complete(self.model, partial)
        if gt is None:
            return refine, None
        return refine, [self.rec(coarse, gt), self.rec(refine, gt)]

    @torch.no_grad()
    def val_step(self, items):
        """The batch's metrics [3, B]; without a ground truth (KITTI) the
        eval forward alone, and None."""
        _, _, _, data = items
        dev = self.device
        t0 = perf_counter()
        partial = torch.from_numpy(data["partial_cloud"]).to(dev)
        gt = data.get("gtcloud")
        gt = None if gt is None else torch.from_numpy(gt).to(dev)
        _sync(dev)
        t1 = perf_counter()
        refine, losses = self._val_impl(partial, gt)
        if losses is not None:
            self.test_losses.update([float(v) * 1000 for v in losses])
        else:                       # no loss read waits for the forward
            _sync(dev)
        t2 = perf_counter()
        self.ptcloud = refine
        vals = None if gt is None else compute_all(
            refine, gt, eps=float(self.config.TEST.emd_eps),
            iters=int(self.config.TEST.emd_iters))
        t3 = perf_counter()
        self.seconds["data"] += t1 - t0
        self.seconds["forward"] += t2 - t1
        self.seconds["metrics"] += t3 - t2
        return vals
