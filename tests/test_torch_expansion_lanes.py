"""The expansion kernel's decomposition (csrc/expansion.cu: a block of 16
warps a primitive, V = 1 or 2 vertices a thread, the root taken only where the
squared distance drops, a (bits, slot) tree a thread, a warp's minimum and
its lowest lane, the warps' least key, then leaf-pruning rounds with each
degree starting at its own edge) in plain PyTorch,
``ops/expansion_penalty.py:mst_charges_lanes_plain``, against the plain
version ``mst_charges_plain`` bit for bit (parent, cost and charged), and
against the JAX package's Pallas kernel in interpret mode (its closed-form
charging), on the CPU. The kernel itself runs in
tests/test_torch_port_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sparenet_tpu.ops.pallas.expansion_pallas import expansion_pallas

from sparenet_tpu_torch.ops import expansion_penalty as ep


def _cloud(kind: str, bp: int, s: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    x = rng.rand(bp, s, 3).astype(np.float32) - 0.5
    if kind == "tiny":        # the random-init coarse cloud's scale
        x = x * np.float32(1e-7)
    elif kind == "ties":      # duplicated points and a lattice: exact ties
        q = s // 3
        x[:, q:2 * q] = x[:, :q]
        x[:, 2 * q:] = np.round(x[:, 2 * q:] * 4) / 4
    elif kind == "nan":
        x[0, s // 2, 1] = np.nan
        x[-1, 0, 0] = np.nan
    elif kind == "path":      # points on a line in shuffled order
        x[:] = 0
        x[:, :, 0] = rng.permutation(s).astype(np.float32)
    elif kind == "star":      # a centre and legs along 8 directions
        d = np.array([[i, j, k] for i in (-1, 1) for j in (-1, 1) for k in (-1, 1)],
                     np.float32) / np.sqrt(3)
        legs = [d[i % 8] * (1 + i // 8) for i in range(s - 1)]
        x[:] = np.concatenate([np.zeros((1, 3), np.float32), np.stack(legs)])
    return torch.from_numpy(x)


def _same(got, want):
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,bp,s", [("random", 3, 64), ("tiny", 2, 100),
                                       ("ties", 2, 99), ("nan", 2, 40),
                                       ("random", 4, 2), ("tiny", 2, 33),
                                       ("path", 2, 33), ("star", 2, 41)])
@pytest.mark.parametrize("extra", [0, 512, None])
def test_lanes_match_plain(kind, bp, s, extra):
    """Both layouts the kernel takes (a vertex a thread up to S = 512, two
    past it: S + 512, and S = 1024 for None, the most a block takes) give
    the plain version's tree, costs and charges bit for bit."""
    x = _cloud(kind, bp, 1024 if extra is None else s + extra)
    got = ep.mst_charges_lanes_plain(x)
    want = ep.mst_charges_plain(x)
    _same(got[:3], want)
    assert torch.equal(got[3], ep.pruning_rounds(want[0]))


def test_lanes_match_plain_at_512():
    """The main path's primitive (S = 512) at the random-init scale, at
    the kernel's 16 warps (a vertex a thread)."""
    x = _cloud("tiny", 1, 512, seed=3)
    _same(ep.mst_charges_lanes_plain(x)[:3], ep.mst_charges_plain(x))


def test_path_peels_from_both_ends():
    """A path of S points peels a leaf from each end a round and ends in
    one leaf-leaf edge, charged to the higher vertex."""
    s = 33
    x = torch.zeros(1, s, 3)
    x[0, :, 0] = torch.arange(s, dtype=torch.float32)
    parent, _, charged, rounds = ep.mst_charges_lanes_plain(x)
    assert torch.equal(parent[0, 1:], torch.arange(s - 1, dtype=torch.int32))
    assert int(rounds) == (s - 1 + 1) // 2
    # the middle edge (16, 17) dies last, both ends leaves: the higher one
    assert int(charged[0, 17]) == 17
    assert int(charged[0, 1]) == 0 and int(charged[0, s - 1]) == s - 1


@pytest.mark.parametrize("bp,s", [(4, 64), (2, 33)])
def test_lanes_match_pallas(bp, s):
    """Against the Pallas kernel in interpret mode (Prim's steps with its
    own rounding of the distance, charges by its closed-form tree DP):
    parent and charged exact, cost to 1e-6."""
    x = _cloud("random", bp, s, seed=5)
    parent, cost, charged, _ = ep.mst_charges_lanes_plain(x)
    p_pal, c_pal, ch_pal = expansion_pallas(jnp.asarray(x.numpy()), s,
                                            interpret=True)
    np.testing.assert_array_equal(parent.numpy(), np.asarray(p_pal)[:, :s])
    np.testing.assert_array_equal(charged.numpy()[:, 1:], np.asarray(ch_pal)[:, 1:s])
    np.testing.assert_allclose(cost.numpy(), np.asarray(c_pal)[:, :s], atol=1e-6)
