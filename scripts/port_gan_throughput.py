"""Time the SpareNet-GAN step of one copy of the PyTorch/CUDA port at B=32
on the card: chip_smoke.py's phase 16 alone (its model and seeds), for an
A/B of two commits on one card, in turns:

    git archive PARENT | tar -x -C _archive/a     # and the change in _archive/c
    for d in a c c a; do python scripts/port_gan_throughput.py _archive/$d $d; done

Each run builds that copy's kernels and prints the copy's phase 16 lines:
ms per GAN step over three steps (radii 5, 7, 10, one a step) after a
warm-up, clouds/s, peak memory, one profiled step, and the same in
deterministic mode.
"""
import os
import sys

sys.argv[1] = os.path.abspath(sys.argv[1])
sys.path.insert(0, sys.argv[1])
os.chdir(sys.argv[1])
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

dev = torch.device("cuda:0")
cs.set_parity_mode()
cs._lib.lib()
gen = torch.Generator().manual_seed(1)
model = cs.build_generator(seed=0, device="cpu")
cs.jitter_bn_stats(model, gen)
model = model.to(dev).eval()
state = cs.snapshot(model)
del model
disc = cs.build_discriminator(seed=1, device="cpu", image_size=cs.IMG).state_dict()
print(sys.argv[2], flush=True)
cs.gan_throughput(state, disc, gen, dev)
