"""The chamfer NN kernel's schedule (``ops/chamfer.py:nn_idx_split_plain``:
per-chunk minima, the candidate range split into ranges merged in order with
strict <, a scan of the winning chunk) against the plain version
``nn_idx_plain``, bit for bit, on the CPU; no JAX. The kernel
(csrc/chamfer_nn.cu) runs this schedule with chunks of ``chamfer.CHUNK``
candidates and the split count ``spn_nn_idx_splits`` picks; the `gpu` tests
hold it to the plain version on the card.
"""

import pytest
import torch

from sparenet_tpu_torch.ops import chamfer

# (splits, chunk): one range, and 2, 3 and 8 (several merged, some past
# the last chunk) with the kernel's chunk and one that divides nothing
SCHEDULES = [(1, chamfer.CHUNK), (2, chamfer.CHUNK), (3, chamfer.CHUNK),
             (8, chamfer.CHUNK), (3, 5), (8, 7)]
NAN = float("nan")


def _cloud(g, b, n):
    return torch.rand(b, n, 3, generator=g) - 0.5


def _check(x1, x2, schedules=SCHEDULES):
    want = chamfer.nn_idx_plain(x1, x2)
    for splits, chunk in schedules:
        got = chamfer.nn_idx_split_plain(x1, x2, splits, chunk)
        assert torch.equal(got, want), (splits, chunk)
    return want


@pytest.mark.parametrize("n2", [1, 2, 31, 77, 100, 161])
def test_split_schedule_matches_plain(n2):
    """Random clouds, N2 below, at and past a chunk and not a multiple of
    it; a range past the last chunk is empty."""
    g = torch.Generator().manual_seed(n2)
    _check(_cloud(g, 2, 40), _cloud(g, 2, n2))


def _shells(g, queries, per, radius, jitter):
    """``per`` candidates around each query at radius * (1 + jitter * N(0,
    1)), shuffled: distances that differ by a few ulps across chunks."""
    parts = []
    for q in queries.unbind(1):
        v = torch.randn(queries.shape[0], per, 3, generator=g, dtype=torch.float64)
        v = v / v.norm(dim=-1, keepdim=True)
        r = radius * (1 + jitter * torch.randn(queries.shape[0], per, 1, generator=g,
                                               dtype=torch.float64))
        parts.append((q[:, None].double() + v * r).float())
    x2 = torch.cat(parts, 1)
    return x2[:, torch.randperm(x2.shape[1], generator=g)]


@pytest.mark.parametrize("seed", range(4))
def test_near_ties_across_chunks(seed):
    """Candidates on shells around the queries whose distances differ by a
    few ulps across chunks and ranges."""
    g = torch.Generator().manual_seed(seed)
    q = (torch.rand(1, 4, 3, generator=g) - 0.5) * 2
    _check(q, _shells(g, q, 48, 0.3, 1e-7))


def test_duplicated_points_take_the_lowest_index():
    """Every candidate twice (exact ties across chunks and splits): the
    first copy wins."""
    g = torch.Generator().manual_seed(1)
    half = _cloud(g, 2, 50)
    x2 = torch.cat([half, half.flip(1)], 1)
    x1 = torch.cat([half[:, :10], _cloud(g, 2, 30)], 1)
    want = _check(x1, x2)
    assert torch.equal(want[:, :10], torch.arange(10).expand(2, 10).int())


def test_exact_ties_at_equal_distance():
    """Candidates on a lattice around a query at one distance, many chunks
    of them (exact ties between different points): the lowest index among
    them."""
    q = torch.zeros(1, 1, 3)
    x2 = torch.tensor([[[2., 0, 0], [0, 1, 0], [1, 0, 0], [0, 0, -1],
                        [-1, 0, 0], [0, 0, 1]] * 7])
    want = _check(q, x2)
    assert int(want) == 1


def test_nan_distances_are_never_picked():
    """A NaN candidate is skipped; a NaN query (all its distances NaN) gets
    0, and so does a query whose every candidate is NaN."""
    g = torch.Generator().manual_seed(2)
    x1, x2 = _cloud(g, 2, 20), _cloud(g, 2, 70)
    x1[0, 3] = NAN
    x2[1, :] = NAN
    x2[0, 40] = x1[0, 5]
    x2[0, 7] = torch.tensor([NAN, 0.0, 0.0])
    want = _check(x1, x2)
    assert int(want[0, 3]) == 0 and bool((want[1] == 0).all())
    assert int(want[0, 5]) == 40


def test_infinite_distances():
    """Distances of +inf (coordinates past 1e19): the lowest index among the
    least, as argmin with NaN read as +inf."""
    x1 = torch.tensor([[[0.0, 0.0, 0.0], [3e19, 0.0, 0.0]]])
    x2 = torch.tensor([[[NAN, 0.0, 0.0], [2e19, 0, 0], [-2e19, 0, 0],
                        [0, 3e19, 0]]])
    want = _check(x1, x2, SCHEDULES + [(2, 1), (3, 2)])
    assert want.tolist() == [[0, 1]]


def test_one_point_cloud():
    g = torch.Generator().manual_seed(3)
    want = _check(_cloud(g, 3, 17), _cloud(g, 3, 1))
    assert bool((want == 0).all())


def test_plain_matches_a_scan_in_order():
    """nn_idx_plain is the strict-< scan the kernel's contract states:
    distances fma(dz, dz, fma(dx, dx, dy * dy)) from differences, NaN
    skipped, the first minimum kept."""
    g = torch.Generator().manual_seed(4)
    x1, x2 = _cloud(g, 1, 6), _cloud(g, 1, 45)
    x2[0, 9] = x2[0, 30]
    x2[0, 11] = NAN
    x1[0, 2] = x2[0, 30]
    d = chamfer.sqdist_pairs(x1, x2)[0]
    for q in range(6):
        best, pick = float("inf"), 0
        for j in range(45):
            if float(d[q, j]) < best:
                best, pick = float(d[q, j]), j
        assert int(chamfer.nn_idx_plain(x1, x2)[0, q]) == pick
    assert int(chamfer.nn_idx_plain(x1, x2)[0, 2]) == 9
