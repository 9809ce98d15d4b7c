"""SpareNet in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``sparenet_tpu``, which stays the reference. It
imports neither JAX nor anything of ``sparenet_tpu``. Parity mode (fp32,
TF32 off) by default; the eval forward also runs in the reference's serving
mode (``build_generator(serving=True, mds=...)``; ``models.ServingDial``
for the runners and ``--serving`` for the CLIs). Entry points:
``sparenet_tpu_torch.models.build_generator`` and ``complete`` (eval),
``sparenet_tpu_torch.runners.sparenet.train_step`` (one training step),
``sparenet_tpu_torch.runners.sparenet_gan.gan_step`` (one SpareNet-GAN
step); kernels and their plain PyTorch versions live in
``sparenet_tpu_torch.ops``, their CUDA sources in ``csrc/``.
"""
