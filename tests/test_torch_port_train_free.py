"""The port's own flagship training step, free-running, against the JAX
step of tests/test_torch_port_train.py (its ``step`` fixture: the flagship
arms at B=4, 256 -> 1024 points, 2 primitives, bottleneck and hide 128).
A file of its own so that ``--dist loadfile`` runs it beside the anchored
checks, on another worker.
"""

import numpy as np
import torch

from sparenet_tpu_torch.runners import sparenet as port_runner
from tests.test_torch_port_train import LR, _port, step  # noqa: F401 (fixture)


def test_free_running_loss_matches_jax(step):
    """The port's own step (its own kNN graphs, MDS picks, assignments and
    nearest neighbours): loss, coarse_loss and refine_loss within rtol 1e-2
    of the JAX step's (readings: up to 2.2e-3). The kNN graphs see features that
    differ by rounding, the auction and greedy MDS turn that into other
    picks, and the losses, averages over the cloud, move little."""
    model, opt = _port(step)
    loss = port_runner.train_step(model, opt, torch.from_numpy(step["partial"]),
                                  torch.from_numpy(step["gt"]), LR)
    np.testing.assert_allclose([float(v) for v in loss], step["loss"], rtol=1e-2)
