"""The edge-stats backward kernel's decomposition on the CPU, no JAX:
``ops/edge_gather.py:radix_lists_plain`` (the shared-memory lists kernel's
radix sort: 4-bit digits of the target, each pass placing a thread's keys
after the earlier threads') and ``inverse_lists_plain`` (the device-memory
lists kernel's stable counting sort: warp segments, counts scanned over
(target, segment), equal targets ranked within a 32-slot step) against
torch.sort(stable=True), and
``edge_stats_bwd_lists_plain`` (route codes, those lists, each row's
contributions summed in list order over channel slices) against
``edge_stats_bwd_plain``, bit for bit. The `gpu` tests hold the kernel
(csrc/edge_stats.cu) to the plain version on the card.
"""

import pytest
import torch

from sparenet_tpu_torch.ops import edge_gather

KS = (1, 8, 15, 16, 20)


def _graph(g, b, n, m, k, spare=0):
    """idx [b, m, k] into n rows with repeated slots; the last ``spare``
    rows are named by no point."""
    idx = torch.randint(0, n - spare, (b, m, k), generator=g, dtype=torch.int32)
    if k > 1:
        idx[:, :, k - 1] = idx[:, :, 0]            # a repeated slot
    idx[:, :3] = torch.arange(k, dtype=torch.int32) % 2   # crowded rows 0, 1
    return idx


def _stable_lists(idx, n):
    b = idx.shape[0]
    flat = idx.reshape(b, -1).long()
    offs = torch.zeros((b, n + 1), dtype=torch.long)
    offs[:, 1:] = torch.stack([torch.bincount(f, minlength=n) for f in flat]).cumsum(1)
    return offs, torch.sort(flat, dim=1, stable=True).indices


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("warps", [1, 3, 8])
def test_lists_are_the_stable_sort(k, warps):
    """Each target's list holds its flat slots m * k + j ascending, for
    any number of warp segments (one segment shorter than a 32-slot step
    included)."""
    g = torch.Generator().manual_seed(k * 10 + warps)
    n, m = 37, 29
    idx = _graph(g, 2, n, m, k, spare=4)
    offs, lists = edge_gather.inverse_lists_plain(idx, n, warps)
    want_offs, want_lists = _stable_lists(idx, n)
    assert torch.equal(offs.long(), want_offs)
    assert torch.equal(lists.long(), want_lists)
    assert bool((offs[:, n - 4:] == offs[:, -1:]).all())   # empty lists


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("threads,items", [(16, 64), (32, 19), (4, 250)])
def test_radix_lists_are_the_stable_sort(k, threads, items):
    """The radix path's passes give the stable sort's lists, with padding
    keys past the last slot (threads * items > M * k) and n of 4 to 12
    bits (one to three passes)."""
    g = torch.Generator().manual_seed(k * 7 + threads)
    for n in (9, 37, 2100):
        idx = _graph(g, 2, n, 23, k, spare=2)
        offs, lists = edge_gather.radix_lists_plain(idx, n, threads, items)
        want_offs, want_lists = _stable_lists(idx, n)
        assert torch.equal(offs.long(), want_offs)
        assert torch.equal(lists.long(), want_lists)


def test_radix_lists_at_the_kernel_size():
    """The kernel's own shape: 1024 threads of 24 keys, 3000 points, k = 8
    (24000 slots), three 4-bit passes."""
    g = torch.Generator().manual_seed(5)
    idx = _graph(g, 1, 3000, 3000, 8, spare=10)
    offs, lists = edge_gather.radix_lists_plain(idx, 3000)
    want_offs, want_lists = _stable_lists(idx, 3000)
    assert torch.equal(offs.long(), want_offs)
    assert torch.equal(lists.long(), want_lists)
    with pytest.raises(ValueError):
        edge_gather.radix_lists_plain(torch.zeros(1, 3000, 9, dtype=torch.int32),
                                      3000)


def test_lists_skip_slots_outside_the_table():
    """A slot naming no row in [0, n) is in no list (the kernel's counts
    skip it), and the others keep their order."""
    idx = torch.tensor([[[3, 9], [-1, 0], [3, 2]]], dtype=torch.int32)
    for offs, lists in (edge_gather.inverse_lists_plain(idx, 4),
                        edge_gather.radix_lists_plain(idx, 4, 2, 4)):
        assert offs.tolist() == [[0, 1, 1, 2, 4]]
        assert lists[0, :4].tolist() == [3, 5, 0, 4]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("c,width", [(7, 4), (130, 128), (9, 32)])
def test_sliced_accumulation_matches_plain(k, c, width):
    """The backward as the kernel computes it, over channel slices of
    ``width`` (C not a multiple of 4 or of the slice), equals
    edge_stats_bwd_plain bit for bit, with equal rows (max and min ties
    across slots), repeated slots and rows that no point names."""
    g = torch.Generator().manual_seed(k + c)
    n, m = 23, 19
    table = torch.randn(2, n, c, generator=g)
    table[:, 1] = table[:, 0]
    table[:, 5, : c // 2] = 0.0
    table[:, 6, : c // 2] = 0.0
    idx = _graph(g, 2, n, m, k, spare=3)
    idx[:, 4, 0], idx[:, 4, -1] = 5, 6
    mx, mn, _, _ = edge_gather.edge_stats_fwd_plain(table, idx)
    grads = [torch.randn(2, m, c, generator=g) for _ in range(4)]
    want = edge_gather.edge_stats_bwd_plain(table, idx, mx, mn, *grads)
    got = edge_gather.edge_stats_bwd_lists_plain(table, idx, mx, mn, *grads,
                                                  width=width)
    assert torch.equal(got, want)
    assert bool((want[:, n - 3:] == 0).all())
