"""The port's own SpareNet-GAN step, free-running (its own kNN graphs, MDS
picks and assignments; the same dropout masks), against the JAX step of
tests/test_torch_port_gan.py (its ``step`` fixture). A file of its own so
that ``--dist loadfile`` runs it beside the anchored checks, on another
worker.
"""

import numpy as np
import pytest

from tests.test_torch_port_gan import _run_port, step  # noqa: F401 (fixture)


def test_free_running_losses_match_jax(step):
    """The port's own step (its own kNN graphs, MDS picks, assignments; the
    same dropout masks): every loss within rtol 1e-2 of JAX's (readings up
    to 2.3e-3; the training step's own test allows 1e-2)."""
    mp = pytest.MonkeyPatch()
    try:
        run = _run_port(step, mp)
    finally:
        mp.undo()
    np.testing.assert_allclose(run["losses"], step["losses"], rtol=1e-2)
