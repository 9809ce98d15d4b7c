"""The gather-max kernel's sum order (csrc/gather_max.cu, slice path) as
``ops/gather.py:gather_max_sum_blocks_plain`` models it, on the CPU at toy
shapes: against a scalar loop over the order written out in float32, the
plain version and the JAX package's Pallas kernel in interpret mode. The
kernel's sum is held to the model bit for bit on the card
(tests/test_torch_port_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.ops.pallas.gather_pallas import gather_rows_max
from sparenet_tpu_torch.ops import gather

jax.config.update("jax_platforms", "cpu")


def _inputs(seed, b, n, m, c, k, nan=False):
    rng = np.random.RandomState(seed)
    table = rng.randn(b, n, c).astype(np.float32)
    table[:, 0] *= 1e4                                  # cancellation
    idx = rng.randint(0, n, (b, m, k)).astype(np.int32)
    if nan:
        table[0, 3, 1] = np.nan
        idx[0, 5, 2] = 3
    return table, idx


def _scalar_order(table, idx, lanes, group_rows):
    """The order spelled out one float32 add at a time."""
    b, m, k = idx.shape
    c = table.shape[2]
    f = np.float32
    out = np.zeros((b, c), np.float32)
    for bi in range(b):
        partials = []
        for r0 in range(0, m, group_rows):
            lane = [np.zeros(c, np.float32) for _ in range(lanes)]
            for row in range(r0, min(r0 + group_rows, m)):
                q = (row - r0) % lanes
                for j in range(k):
                    lane[q] = (lane[q] + table[bi, idx[bi, row, j]]).astype(f)
            h = lanes // 2
            while h:
                for q in range(h):
                    lane[q] = (lane[q] + lane[q + h]).astype(f)
                h //= 2
            partials.append(lane[0])
        if len(partials) == 1:
            out[bi] = partials[0]
        else:
            s = np.zeros(c, np.float32)
            for p in partials:
                s = (s + p).astype(f)
            out[bi] = s
    return out


@pytest.mark.parametrize("lanes,group_rows,k", [
    (1, 1, 3), (2, 4, 8), (4, 4, 1), (8, 24, 8), (8, 8, 20), (16, 64, 5)])
def test_model_is_the_order(lanes, group_rows, k):
    """Every add of the model where the order says, bit for bit."""
    table, idx = _inputs(0, 2, 23, 37, 6, k)
    mx, s = gather.gather_max_sum_blocks_plain(
        torch.from_numpy(table), torch.from_numpy(idx), lanes, group_rows)
    np.testing.assert_array_equal(s.numpy(),
                                  _scalar_order(table, idx, lanes, group_rows))
    want = gather.gather_max_plain(torch.from_numpy(table),
                                   torch.from_numpy(idx))
    assert torch.equal(mx, want)


@pytest.mark.parametrize("lanes,group_rows", [
    (128, 128), (128, 1024), (128, 3072), (64, 64), (64, 256), (2, 10)])
@pytest.mark.parametrize("k", [8, 16])
def test_model_within_tolerance_of_plain(lanes, group_rows, k):
    """The model's sum within rtol 1e-5 (+1e-6 of the summed |rows|) of the
    plain version's, at the plans' 128 lanes and their group sizes, and at
    other lane counts; max equal."""
    table, idx = (torch.from_numpy(a) for a in _inputs(1, 2, 400, 3000 // 4, 12, k))
    mx, s = gather.gather_max_sum_blocks_plain(table, idx, lanes, group_rows)
    pmx, ps = gather.gather_max_plain(table, idx, need_sum=True)
    assert torch.equal(mx, pmx)
    abs_sum = gather.gather_rows(table.abs(), idx).sum((1, 2))
    assert bool(((s - ps).abs() <= 1e-5 * ps.abs() + 1e-6 * abs_sum).all())


@pytest.mark.parametrize("lanes,group_rows,nan", [
    (128, 128, False), (64, 128, False), (8, 16, True)])
def test_model_against_jax_interpret(lanes, group_rows, nan):
    """Max bit for bit and sum within the tolerance of the JAX package's
    gather_rows_max (Pallas, interpret mode), NaN where it has NaN."""
    table, idx = _inputs(2, 2, 300, 260, 20, 8, nan)
    want_max, want_sum = gather_rows_max(jnp.asarray(table), jnp.asarray(idx),
                                         need_sum=True, interpret=True)
    want_max, want_sum = np.asarray(want_max), np.asarray(want_sum)
    mx, s = gather.gather_max_sum_blocks_plain(
        torch.from_numpy(table), torch.from_numpy(idx), lanes, group_rows)
    np.testing.assert_array_equal(mx.numpy(), want_max)
    s = s.numpy()
    assert (np.isnan(s) == np.isnan(want_sum)).all()
    assert bool(np.isnan(s).any()) == nan
    ok = ~np.isnan(want_sum)
    abs_sum = gather.gather_rows(torch.from_numpy(np.abs(table)),
                                 torch.from_numpy(idx)).sum((1, 2)).numpy()
    assert (np.abs(s - want_sum)[ok]
            <= (1e-5 * np.abs(want_sum) + 1e-6 * abs_sum)[ok]).all()
