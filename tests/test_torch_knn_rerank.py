"""The kNN kernels' re-rank rule (ops/knn.py:rerank_plain, the plain
mirror of csrc/knn.cu), on the CPU.

Both arms' kernels rank candidates by tensor-core distances d' that differ
from the arm's exact distances d by at most E (``margin``), re-rank a
shortlist of M by exact keys where a margin test holds, and send the other
queries to an exact scan; rows equal bit for bit rank as one group
(``duplicate_reps``), expanded into its rows in the re-rank. Here d' is d pushed by up to E toward the k-th
neighbour, the case that makes the shortlist hardest, and the rule must
still return the plain version's indices exactly: ``knn_packed_plain``
(packed arm), or the (distance, index) order of ``knn_plain`` (exact arm;
its bmm-order distance stands in for the kernel's fixed order).
"""

import numpy as np
import pytest
import torch

from sparenet_tpu_torch.ops import common, knn


def _arm(x, packed):
    """The arm's exact distances and its plain version's answer."""
    if packed:
        return common.pairwise_sqdist_serving(x, x), knn.knn_packed_plain
    return common.pairwise_sqdist_graph(x, x), knn.knn_plain


def _toward_kth(x, k, scale, packed):
    """d moved by scale * E toward the k-th neighbour's distance: the
    candidates nearer than it outward, the others inward."""
    d, plain = _arm(x, packed)
    e = knn.margin(x, packed)[..., None]
    kth = d.gather(-1, plain(x, k)[..., k - 1:k].long())
    return torch.where(d <= kth, d + scale * e, d - scale * e)


def _rerank(x, d_approx, k, m, packed, groups=True):
    d, _ = _arm(x, packed)
    return knn.rerank_plain(d_approx, d, knn.margin(x, packed), k, m, packed,
                            knn.duplicate_reps(x) if groups else None)


def _clouds(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "randn":                  # features, as the encoder's
        x = rng.randn(2, 200, 24)
    elif kind == "quantised":            # coordinates 0 or 1: each corner
        x = np.round(rng.rand(2, 300, 3))   # ~37 times, more than M (16, 32)
    elif kind == "clustered":            # 20 points within 1e-2 of each of
        x = (np.repeat(rng.rand(2, 15, 3), 20, axis=1)     # 15 centres
             + 1e-2 * rng.randn(2, 300, 3))
    elif kind == "lattice":              # the 256 distinct points of
        grid = np.stack(np.meshgrid(*[np.arange(4)] * 4), -1).reshape(-1, 4)
        x = np.stack([rng.permutation(grid) for _ in range(2)])  # {0..3}^4:
        # up to 24 others at distance 2, distinct points in exact ties
    elif kind == "zero_padded":          # 200 points and 100 zero rows, as
        x = np.concatenate([rng.rand(2, 200, 3) - 0.5,      # RandomSamplePoints
                            np.zeros((2, 100, 3))], 1)     # pads short clouds
    else:                                # every point three times
        x = np.tile(rng.rand(1, 50, 3), (1, 3, 1))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
@pytest.mark.parametrize("kind", ["randn", "quantised", "clustered",
                                  "duplicated", "lattice", "zero_padded"])
@pytest.mark.parametrize("k", [1, 8, 16, 20])
def test_rerank_equals_plain_under_adversarial_error(kind, k, packed):
    """Distances pushed by 0.999 E toward the k-th neighbour (and the
    unperturbed ones): the rule returns the plain version's indices, bit
    for bit."""
    x = _clouds(kind, seed=k)
    want = _arm(x, packed)[1](x, k)
    m = knn.shortlist_len(k)
    for scale in (0.999, 0.0):
        got, _ = _rerank(x, _toward_kth(x, k, scale, packed), k, m, packed)
        assert torch.equal(got, want), (kind, k, scale)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
@pytest.mark.parametrize("k", [8, 16])
def test_quantised_coordinates_take_the_exact_scan(k, packed):
    """Distinct lattice points: more than M candidates share the k-th
    distance, the margin test fails for some queries, which the exact scan
    answers."""
    x = _clouds("lattice", seed=0)
    got, flagged = _rerank(x, _toward_kth(x, k, 0.999, packed), k,
                           knn.shortlist_len(k), packed)
    assert int(flagged.sum()) > 0
    assert torch.equal(got, _arm(x, packed)[1](x, k))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "exact"])
@pytest.mark.parametrize("kind", ["quantised", "zero_padded", "duplicated"])
def test_equal_rows_rank_as_one_group(kind, packed):
    """Rows equal bit for bit (8 points ~37 times each; the loaders' zero
    padding; every point three times): as groups, no query fails the
    margin test and the answer is the plain version's; ranked row by row,
    ties of more than M rows fail it (the control)."""
    x = _clouds(kind, seed=3)
    d_approx = _toward_kth(x, 8, 0.999, packed)
    got, flagged = _rerank(x, d_approx, 8, 16, packed)
    assert int(flagged.sum()) == 0
    assert torch.equal(got, _arm(x, packed)[1](x, 8))
    got, flagged = _rerank(x, d_approx, 8, 16, packed, groups=False)
    assert torch.equal(got, _arm(x, packed)[1](x, 8))
    if kind != "duplicated":             # there, 3 rows a tie: under M
        assert int(flagged.sum()) > 0


def test_duplicate_reps_are_the_lowest_equal_index():
    """Each row's group is the lowest index of a row equal to it bit for
    bit; -0.0 and 0.0 differ in their bits and so in their groups."""
    x = _clouds("duplicated", seed=4)
    x[0, 7] = 0.0
    x[0, 9] = 0.0
    x[0, 9, 1] = -0.0
    reps = knn.duplicate_reps(x)[0]
    bits = x[0].view(torch.int32)
    for j in range(x.shape[1]):
        same = (bits == bits[j]).all(-1).nonzero()[0, 0]
        assert int(reps[j]) == int(same)
    assert int(reps[9]) == 9 and int(reps[107]) == int(reps[57]) == 57


def test_random_features_pass_the_margin_test():
    """On random features the shortlist suffices for every query, also with
    the distances pushed by E."""
    x = _clouds("randn", seed=5)
    for packed in (True, False):
        _, flagged = _rerank(x, _toward_kth(x, 8, 0.999, packed), 8, 32, packed)
        assert int(flagged.sum()) == 0


def test_a_margin_too_small_is_seen():
    """Control: with E taken 2^12 times smaller, distances pushed by the
    true E make a 9-long shortlist miss neighbours inside a cluster, which
    the test then no longer flags, so the rule returns other indices."""
    x = _clouds("clustered", seed=7)
    d, plain = _arm(x, True)
    e = knn.margin(x, True)
    got, _ = knn.rerank_plain(_toward_kth(x, 8, 0.999, True), d, e * 2.0 ** -12,
                              8, 9, True)
    assert not torch.equal(got, plain(x, 8))


def test_margin_covers_the_derivation():
    """E is at least f (2^-16 + c_pad 2^-22) |xh_q| max |yh| (f = 2 for
    the exact arm's three terms) and grows with the padded channels
    (c_pad = C rounded up to 32)."""
    x = _clouds("randn", seed=1)
    nh = x.to(torch.bfloat16).double().norm(dim=-1)
    p = nh * nh.amax(1, keepdim=True)
    for packed, f in ((True, 1.0), (False, 2.0)):
        e = knn.margin(x, packed).double()
        assert bool((e >= f * (2.0 ** -16 + 32 * 2.0 ** -22) * p).all())
        wide = knn.margin(torch.cat([x, torch.zeros(2, 200, 40)], -1), packed)
        assert bool((wide > knn.margin(x, packed)).all())


def test_sequential_graph_distance_is_the_graph_distance():
    """The exact kernel's fixed summation order (pairwise_sqdist_graph_seq)
    computes the same distance as the bmm-order one, to a few f32 ulps of
    |x|^2 + |y|^2."""
    x = _clouds("randn", seed=2)[:, :64]
    seq = common.pairwise_sqdist_graph_seq(x)
    bmm = common.pairwise_sqdist_graph(x, x)
    x2 = (x * x).sum(-1)
    scale = x2[:, :, None] + x2[:, None, :]
    assert bool(((seq - bmm).abs() <= 1e-6 * scale).all())
    assert not torch.equal(seq, bmm)


def test_the_bucket_ceiling_counts():
    """Packed keys, hand-built distances with E below a truncation bucket
    w: the k-th candidate (index 299) sits just under its bucket's top and
    its exact distance crosses into the next bucket, where an unlisted
    candidate (index 150) lands from two buckets up and, with the lower
    index, takes its place. The test must flag the query (the shortlist's
    M-th bucket is only two above the k-th's), and the exact scan finds
    150; a test that took the k-th bucket's floor for its ceiling would
    pass and return 299."""
    n, k, m = 300, 8, 16
    w = 2.0 ** (knn.packed_bits(n) - 23)           # a bucket at 1.0
    e = 1e-6
    d_approx = torch.full((n,), 10.0, dtype=torch.float64)
    d_approx[:7] = 0.5
    d_approx[299] = 1.0 + w - e / 2
    d_approx[100:108] = 1.0 + 2 * w + 1e-7
    d_approx[150] = 1.0 + 2 * w + e / 4
    d = d_approx.clone()
    d[299] += 0.999 * e
    d[150] -= 0.999 * e
    d_approx, d = (t.float().expand(1, n, n).contiguous() for t in (d_approx, d))
    got, flagged = knn.rerank_plain(d_approx, d, torch.full((1, n), e), k, m,
                                    packed=True)
    assert bool(flagged.all())
    assert got[0, 0].tolist() == [0, 1, 2, 3, 4, 5, 6, 150]
