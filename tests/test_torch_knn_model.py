"""The exact kNN arm's model on the CPU, no JAX: ``ops/common.py:fma_rn``
(an fma rounded once, as CUDA's __fmaf_rn) against exact rational
arithmetic, and ``ops/knn.py:knn_seq_rows`` (the kernel's own ranking at
chosen query rows) against the fixed-order distances of
``pairwise_sqdist_graph_seq``. chip_smoke.py holds the kernel to
``knn_seq_rows`` at EdgeRes's shapes, where a feature shared by every row
dwarfs the distances and the plain version's ranking can only bound them.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from sparenet_tpu_torch.ops import knn
from sparenet_tpu_torch.ops.common import fma, fma_rn, pairwise_sqdist_graph_seq


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rounded_once(a: float, b: float, c: float) -> np.float32:
    """a * b + c rounded once to f32, to nearest, ties to even."""
    v = Fraction(a) * Fraction(b) + Fraction(c)
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda x: (abs(Fraction(float(x)) - v),
                                     int(np.array(x).view(np.int32)) & 1))


def test_fma_rn_rounds_once():
    """Sums whose f64 value lands on an f32 midpoint (c odd, a b = 2^-24
    less a hair): fma_rn rounds them as the exact sum, ``fma`` (f64 to
    nearest, then f32) does not for some; random sums of every scale
    agree too."""
    i = torch.arange(1, 401, dtype=torch.float32)
    c = 1.0 + (2 * i - 1) * 2.0 ** -23
    a = 2.0 ** -12 * (1 + i * 2.0 ** -23)
    b = 2.0 ** -12 * (1 - i * 2.0 ** -23)
    g = torch.Generator().manual_seed(0)
    scale = 2.0 ** torch.randint(-30, 31, (3, 600), generator=g).float()
    ra, rb, rc = torch.randn(3, 600, generator=g) * scale
    a, b, c = torch.cat([a, ra]), torch.cat([b, rb]), torch.cat([c, rc])
    got = fma_rn(a, b, c)
    want = torch.tensor([float(_rounded_once(*map(float, t)))
                         for t in zip(a, b, c)])
    assert torch.equal(got, want)
    assert int((fma(a, b, c) != want)[:400].sum()) > 100


@pytest.mark.parametrize("c", [4, 40, 120])
def test_knn_seq_rows_is_the_fixed_order_ranking(c):
    """At rows spread over the cloud, with a feature shared by every row
    at 30 times the spread and duplicated rows: the k smallest (d, index)
    keys of pairwise_sqdist_graph_seq (whose fma rounds twice, so on
    random data equal)."""
    g = torch.Generator().manual_seed(c)
    x = torch.randn(2, 200, c, generator=g)
    x[..., : c // 2] = 30 * x[:1, :1, : c // 2]
    x[:, 170:] = x[:, :30]
    rows = torch.arange(0, 200, 7)
    want = knn.smallest_k(pairwise_sqdist_graph_seq(x)[:, rows], 9).long()
    assert torch.equal(knn.knn_seq_rows(x, rows, 9), want)


def test_knn_seq_rows_refuses_an_off_by_one_under_a_shared_feature():
    """EdgeRes's widest stage in small: 200 of 216 channels the same in
    every row at 300 times the others' spread, so the plain version's
    ranking parts from the fixed order's in most slots (81% here); a graph
    with its 8th neighbour replaced by the 9th differs from knn_seq_rows at
    every sampled row."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 400, 216, generator=g)
    x[..., :200] = 300 * x[:, :1, :200]
    rows = torch.arange(0, 400, 5)
    model = knn.knn_seq_rows(x, rows, 9)
    plain = knn.knn_plain(x, 8)[:, rows].long()
    assert int((plain != model[..., :8]).sum()) > 0.5 * plain.numel()
    fault = torch.cat([model[..., :7], model[..., 8:9]], -1)
    assert bool((fault != model[..., :8]).any(-1).all())
