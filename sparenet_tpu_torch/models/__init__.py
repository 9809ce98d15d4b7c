"""Entry points: build the flagship SpareNet generator and complete clouds;
build the SpareNet-GAN discriminator.

Both run on the card unless the caller asks for the CPU: with no ``device``
they use ``cuda`` and raise where there is none. On the CPU every op runs its
plain PyTorch version (the tests use this); on the card every op launches its
CUDA kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .discriminator import (PatchDiscriminator, ProjectionD, SNConv, SNDense,
                            SNEmbed)
from .layers import init_weights
from .sparenet import (SpareNetDecode, SpareNetEncode, SpareNetGenerator,
                       SpareNetRefine)

__all__ = ["FLAGSHIP", "N_INPUT_POINTS", "build_generator", "complete",
           "build_discriminator", "resolve_device", "set_parity_mode",
           "SpareNetGenerator", "SpareNetEncode", "SpareNetDecode",
           "SpareNetRefine", "ProjectionD", "PatchDiscriminator"]

# The flagship configuration: sparenet_tpu/configs/sparenet.yaml (NETWORK:
# n_primitives 32, encode Residualnet, use_adain share, use_selayer true;
# DATASET.n_outpoints 16384; CONST.n_input_points 3000) with the widths that
# define_G fixes (bottleneck_size = hide_size = 4096).
FLAGSHIP = dict(num_points=16384, n_primitives=32, bottleneck_size=4096,
                hide_size=4096, use_selayer=True, use_adain="share",
                encode="Residualnet")
N_INPUT_POINTS = 3000


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
                    mds: str = "auto", mml_calibration: float = 1.33,
                    **config) -> SpareNetGenerator:
    """The flagship generator (``FLAGSHIP``, overridable by keyword) in eval
    mode on ``device``, with the reference's initialisation drawn on the CPU
    from ``torch.Generator().manual_seed(seed)``.

    ``serving=True`` builds the reference's serving mode (``bench.py``'s
    default: ``SPARENET_FAST_MATH=1`` with bf16 matmuls) with the MDS arm
    ``mds`` ("auto" = "exact", as the reference resolves it off the TPU;
    "batched" or "hybrid") and the mml estimate's ``mml_calibration``; the
    batched arms' G, schedule and tail default to
    the reference's (``mds_g``, ``mds_schedule``, ``mds_tail`` override
    them). The same parameters serve both modes. ``train_mds="batched"``
    puts the training forward's MDS on the batched arm (the JAX package's
    serving-aligned training); eval forwards keep exact greedy MDS."""
    dev = resolve_device(device)
    set_parity_mode()
    model = SpareNetGenerator(**{**FLAGSHIP, **config}, serving=serving,
                              mds=mds, mml_calibration=mml_calibration)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


@torch.no_grad()
def complete(model: SpareNetGenerator, partial: torch.Tensor):
    """Eval forward on the model's device: partial [B, N_in, 3] ->
    (coarse, middle, refine [B, num_points, 3], loss_mst), in the mode the
    model was built with (loss_mst is 0 in serving mode)."""
    set_parity_mode()
    dev = next(model.parameters()).device
    resolve_device(dev)
    if partial.dim() != 3 or partial.shape[-1] != 3:
        raise ValueError(f"partial must be [B, N, 3], got {tuple(partial.shape)}")
    x = partial.to(device=dev, dtype=torch.float32).contiguous()
    return model.eval()(x)


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
