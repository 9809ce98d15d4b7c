"""SpareNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``sparenet_tpu``, which stays the reference. It
imports neither JAX nor anything of ``sparenet_tpu``. Parity mode only (fp32,
TF32 off). Entry points: ``sparenet_tpu_torch.models.build_generator`` and
``complete`` (eval), ``sparenet_tpu_torch.runners.sparenet.train_step``
(one training step); kernels and their plain PyTorch versions live in
``sparenet_tpu_torch.ops``, their CUDA sources in ``csrc/``.
"""
