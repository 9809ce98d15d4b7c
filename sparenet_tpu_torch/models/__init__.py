"""Entry points: build the flagship SpareNet generator, or any ported
family's generator from a run's config (``define_G``: SpareNet, AtlasNet,
MSN), and complete clouds; build the SpareNet-GAN discriminator.

Both run on the card unless the caller asks for the CPU: with no ``device``
they use ``cuda`` and raise where there is none. On the CPU every op runs its
plain PyTorch version (the tests use this); on the card every op launches its
CUDA kernel.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass

import torch
from torch import nn

from ..ops import mds as _mds

from ..configs import model_names
from .atlasnet import AtlasNet, PointEncoder
from .discriminator import (PatchDiscriminator, ProjectionD, SNConv, SNDense,
                            SNEmbed)
from .layers import init_weights
from .msn import MSN, MSN_MML_CALIBRATION
from .sparenet import (MML_CALIBRATION, SpareNetDecode, SpareNetEncode,
                       SpareNetGenerator, SpareNetRefine)

__all__ = ["FLAGSHIP", "N_INPUT_POINTS", "MML_CALIBRATION",
           "MSN_MML_CALIBRATION", "ServingDial", "build_generator", "define_G",
           "complete", "build_discriminator", "resolve_device",
           "set_parity_mode", "SpareNetGenerator", "SpareNetEncode",
           "SpareNetDecode", "SpareNetRefine", "AtlasNet", "PointEncoder",
           "MSN", "ProjectionD", "PatchDiscriminator"]

# The flagship configuration: sparenet_tpu/configs/sparenet.yaml (NETWORK:
# n_primitives 32, encode Residualnet, use_adain share, use_selayer true;
# DATASET.n_outpoints 16384; CONST.n_input_points 3000) with the widths that
# define_G fixes (bottleneck_size = hide_size = 4096).
FLAGSHIP = dict(num_points=16384, n_primitives=32, bottleneck_size=4096,
                hide_size=4096, use_selayer=True, use_adain="share",
                encode="Residualnet")
N_INPUT_POINTS = 3000


@dataclass(frozen=True)
class ServingDial:
    """Serving mode's switch and MDS dial, the counterpart of the JAX
    package's environment (``SPARENET_FAST_MATH=1`` with
    ``SPARENET_MDS_IMPL``, ``_BATCH_G``, ``_SCHEDULE``, ``_TAIL`` and
    ``_SELECT``), at that environment's defaults: the MDS arm ``mds``
    ("auto" = "exact", as the JAX package resolves it off the TPU;
    "batched", "hybrid"), the batched rounds' fixed size ``g``, their
    leading sizes ``schedule`` (empty: G alone), the hybrid's exact
    ``tail`` and the rounds' selection arm ``select``."""

    mds: str = "auto"
    g: int = _mds.BATCH_G
    schedule: tuple = _mds.SCHEDULE
    tail: int = _mds.TAIL
    select: str = "sort"

    def __post_init__(self):
        object.__setattr__(self, "schedule", tuple(int(v) for v in self.schedule))
        _mds.resolve_impl(self.mds)
        _mds.check_select(self.select)
        if self.g < 1 or self.tail < 1 or any(v < 1 for v in self.schedule):
            raise ValueError(f"serving dial: G {self.g}, schedule "
                             f"{self.schedule} and tail {self.tail} must be "
                             f">= 1")

    def generator_kwargs(self) -> dict:
        """``build_generator``'s keywords for serving mode on this dial."""
        return dict(serving=True, mds=self.mds, mds_g=self.g,
                    mds_schedule=self.schedule, mds_tail=self.tail,
                    select=self.select)

    def state(self) -> dict:
        """The dial as the evaluation CLI's JSON line gives it: its fields,
        the arm "auto" resolves to, and the JAX package's ``dial_state``
        label of the rounds."""
        return dict(asdict(self), schedule=list(self.schedule),
                    arm=_mds.resolve_impl(self.mds, serving=True),
                    **_mds.dial_state(self.g, self.schedule, self.select))


def set_parity_mode() -> None:
    """Parity mode: float32 everywhere, TF32 off for matmuls and cuDNN
    (the reference's parity contract is stated in fp32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raise if it is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def build_generator(*, seed: int = 0, device=None, serving: bool = False,
                    mds: str = "auto", mml_calibration: float = MML_CALIBRATION,
                    select: str = "sort", **config) -> SpareNetGenerator:
    """The flagship generator (``FLAGSHIP``, overridable by keyword) in eval
    mode on ``device``, with the reference's initialisation drawn on the CPU
    from ``torch.Generator().manual_seed(seed)``.

    ``serving=True`` builds the reference's serving mode (``bench.py``'s
    default: ``SPARENET_FAST_MATH=1`` with bf16 matmuls) with the MDS arm
    ``mds`` ("auto" = "exact", as the reference resolves it off the TPU;
    "batched" or "hybrid") and the mml estimate's ``mml_calibration``; the
    batched arms' G, schedule, tail and selection arm default to the
    reference's (``mds_g``, ``mds_schedule``, ``mds_tail`` and ``select``
    override them; ``ServingDial.generator_kwargs`` gives all of them).
    The same parameters serve both modes. ``train_mds="batched"``
    puts the training forward's MDS on the batched arm (the JAX package's
    serving-aligned training); eval forwards keep exact greedy MDS."""
    dev = resolve_device(device)
    model = SpareNetGenerator(**{**FLAGSHIP, **config}, serving=serving,
                              mds=mds, mml_calibration=mml_calibration,
                              select=select)
    return _initialised(model, seed, dev)


def _initialised(model: nn.Module, seed: int, dev: torch.device) -> nn.Module:
    """``model`` with the reference's initialisation drawn on the CPU from
    ``torch.Generator().manual_seed(seed)``, on ``dev``, in eval mode."""
    set_parity_mode()
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def define_G(cfg, *, seed: int | None = None, device=None,
             dial: ServingDial | None = None) -> nn.Module:
    """The generator of cfg.NETWORK.model_type (the JAX package's define_G:
    SpareNet with bottleneck and hide 4096; AtlasNet and MSN with bottleneck
    1024 and PointNetfeat's hide 1024), DATASET.n_outpoints points and
    NETWORK.n_primitives primitives, in eval mode on ``device``, initialised
    as ``build_generator`` does from ``seed`` (default CONST.seed).
    NETWORK.mml_calibration > 0 replaces the family's serving mml ratio;
    TRAIN.serving_aligned puts the training forward's MDS on the batched
    arm; ``dial`` (a ``ServingDial``) builds serving mode on that dial."""
    net = cfg.NETWORK
    mt = net.model_type
    seed = cfg.CONST.seed if seed is None else seed
    mml = float(net.mml_calibration)
    common = dict(num_points=cfg.DATASET.n_outpoints,
                  n_primitives=net.n_primitives)
    serving = {} if dial is None else dial.generator_kwargs()
    train_mds = "batched" if cfg.TRAIN.serving_aligned else "exact"
    if mt == model_names.MODEL_SPARENET:
        return build_generator(
            seed=seed, device=device, bottleneck_size=4096, hide_size=4096,
            use_selayer=net.use_selayer, use_adain=net.use_adain,
            encode=net.encode, train_mds=train_mds,
            mml_calibration=mml if mml > 0 else MML_CALIBRATION, **common,
            **serving)
    dev = resolve_device(device)
    if mt == model_names.MODEL_ATLASNET:
        model = AtlasNet(bottleneck_size=1024, serving=dial is not None,
                         **common)
    elif mt == model_names.MODEL_MSN:
        model = MSN(bottleneck_size=1024, train_mds=train_mds,
                    mml_calibration=mml if mml > 0 else MSN_MML_CALIBRATION,
                    **common, **serving)
    else:
        raise ValueError(f"define_G: no generator for model type {mt!r}")
    return _initialised(model, seed, dev)


@torch.no_grad()
def complete(model: nn.Module, partial: torch.Tensor, **kw):
    """Eval forward on the model's device: partial [B, N_in, 3] -> the
    model's outputs, in the mode it was built with: SpareNet's (coarse,
    middle, refine [B, num_points, 3], loss_mst), MSN's (coarse, refine,
    loss_mst), AtlasNet's cloud; loss_mst is 0 in serving mode. ``kw``
    reaches the model (AtlasNet's and MSN's ``grids`` or ``generator``)."""
    set_parity_mode()
    dev = next(model.parameters()).device
    resolve_device(dev)
    if partial.dim() != 3 or partial.shape[-1] != 3:
        raise ValueError(f"partial must be [B, N, 3], got {tuple(partial.shape)}")
    x = partial.to(device=dev, dtype=torch.float32).contiguous()
    return model.eval()(x, **kw)


@torch.no_grad()
def _init_discriminator(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's define_D initialisation, drawn from ``generator``:
    conv weights normal(0, 0.02), BatchNorm scales 1 + 0.02 normal, dense and
    embedding weights Xavier-uniform, biases 0, and each spectral-norm u a
    normalised normal draw."""
    for mod in model.modules():
        if isinstance(mod, SNConv):
            mod.weight.normal_(0.0, 0.02, generator=generator)
        elif isinstance(mod, (SNDense, SNEmbed)):
            fan_out, fan_in = mod.weight.shape
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            mod.weight.uniform_(-bound, bound, generator=generator)
        elif isinstance(mod, nn.BatchNorm2d):
            mod.weight.normal_(1.0, 0.02, generator=generator)
            mod.bias.zero_()
        if isinstance(mod, (SNConv, SNDense, SNEmbed)):
            u = torch.randn(mod.u.shape, generator=generator)
            mod.u.copy_(u / (u.norm() + 1e-12))
            if getattr(mod, "bias", None) is not None:
                mod.bias.zero_()


def build_discriminator(*, seed: int = 0, device=None, use_cgan: bool = True,
                        num_classes: int = 0,
                        image_size: int = 256) -> nn.Module:
    """The SpareNet-GAN discriminator (the JAX package's define_D):
    ``ProjectionD`` with ``use_cgan`` (the shipped setting), else
    ``PatchDiscriminator``, in train mode on ``device``, initialised on the
    CPU from ``torch.Generator().manual_seed(seed)``."""
    dev = resolve_device(device)
    set_parity_mode()
    model = (ProjectionD(image_size, num_classes) if use_cgan
             else PatchDiscriminator())
    _init_discriminator(model, torch.Generator().manual_seed(seed))
    return model.to(dev).train()
