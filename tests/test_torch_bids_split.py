"""The auction bid kernel's decomposition (csrc/emd_bids.cu: the object axis
split into chunks, each scanned in order with the square root skipped where
it cannot change (best, second), the chunks merged in ascending order) in
plain PyTorch, ``ops/emd.py:emd_bids_split``, against the plain version
``emd_bids_plain`` bit for bit; the pruning bound against an f64 reference;
and the auction at full width with the counts on the device against the
round loop with one host read a round, on the CPU.
"""

import itertools

import numpy as np
import pytest
import torch

from sparenet_tpu_torch.ops import emd
from sparenet_tpu_torch.ops.chamfer import gather_rows3
from sparenet_tpu_torch.ops.common import sqnorm3, sqrt_ieee


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, b, m, n, dup):
    """Bidders, objects and prices; with ``dup`` every object twice at
    one price (tied bids), and some bidders on objects."""
    rng = np.random.RandomState(seed)
    x1 = rng.rand(b, m, 3).astype(np.float32) - 0.5
    if dup:
        half = rng.rand(b, n // 2, 3).astype(np.float32) - 0.5
        x2 = np.concatenate([half, half[:, ::-1]], 1)
        price = (rng.rand(b, n // 2) * 0.02).astype(np.float32)
        price = np.concatenate([price, price[:, ::-1]], 1)
        x1[:, :min(3, n)] = x2[:, :min(3, n)]
    else:
        x2 = rng.rand(b, n, 3).astype(np.float32) - 0.5
        price = (rng.rand(b, n) * 0.02).astype(np.float32)
        price[:, ::3] = 0.0
    return _t(x1), _t(x2), _t(price)


@pytest.mark.parametrize("n,dup", [(8, False), (8, True), (2, False),
                                   (2, True)])
def test_every_chunking_merges_to_the_plain_bids(n, dup):
    """Every way to cut a toy object axis into chunks: targets and
    increments of the merged chunks equal the plain version's."""
    x1, x2, price = _case(n, 2, 48, n, dup)
    want = emd.emd_bids_plain(x1, x2, price)
    if dup:
        assert bool((want[1] == 0).all())
    for cuts in itertools.product((False, True), repeat=n - 1):
        bounds = [0] + [i + 1 for i, c in enumerate(cuts) if c] + [n]
        got = emd.emd_bids_split(x1, x2, price, bounds)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), bounds


def test_chunks_with_exact_ties_across_them():
    """Equal best values in different chunks (the lower index wins, inc 0)
    and equal seconds: 20 objects in chunks of 1, 3 and 7."""
    x1, x2, price = _case(3, 2, 64, 20, True)
    want = emd.emd_bids_plain(x1, x2, price)
    for step in (1, 3, 7):
        bounds = list(range(0, 20, step)) + [20]
        got = emd.emd_bids_split(x1, x2, price, bounds)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _v(pp, d2):
    """fsub_rn(pp, fsqrt_rn(d2)) in f32."""
    return pp - sqrt_ieee(d2)


def test_pruning_bound_is_conservative_at_the_boundary():
    """d2 >= D = fmul_ru(A, |A|), A = fsub_ru(pp, second), gives
    v = fsub_rn(pp, fsqrt_rn(d2)) <= second: at D itself, at the floats
    around it and at the f64 threshold (pp - second)^2 rounded either way;
    and D is at least that threshold (it only errs towards taking the
    root)."""
    rng = np.random.RandomState(0)
    pp = _t((3.0 - rng.rand(20000) * 0.05).astype(np.float32))
    second = pp - _t((rng.rand(20000) * 2.0).astype(np.float32)) ** 2
    second[:50] = -3.4e38                 # the scan's start
    second[50:100] = pp[50:100]           # pp == second: skip everything
    second[100:150] = pp[100:150] + 0.5   # pp < second
    d = emd.prune_bound(pp, second)
    exact = (pp.double() - second.double()) ** 2
    ok = (second > -1e38) & (pp > second)
    assert bool((d.double()[ok] >= exact[ok]).all())
    assert bool((d[100:150] <= 0).all())   # pp < second: every pair skipped
    inf = torch.full_like(d, float("inf"))
    cands = [d, torch.nextafter(d, inf), torch.nextafter(torch.nextafter(d, inf), inf),
             exact.float(), torch.nextafter(exact.float(), inf), 2.0 * d]
    for d2 in cands:
        d2 = d2.clamp_min(0.0)
        skip = d2 >= d
        assert bool((_v(pp, d2)[skip] <= second[skip]).all())
    # the bound is tight: a float below the f64 threshold passes second
    below = torch.nextafter(exact.float(), torch.zeros_like(d))
    assert bool((_v(pp, below)[ok] > second[ok]).any())


def test_pruned_scan_on_clouds():
    """The pruned scan in one chunk and in 5 uneven chunks, on clouds with
    duplicated objects and bidders on objects, equals the plain bids."""
    x1, x2, price = _case(7, 2, 200, 96, True)
    want = emd.emd_bids_plain(x1, x2, price)
    for bounds in ([0, 96], [0, 5, 6, 40, 81, 96]):
        got = emd.emd_bids_split(x1, x2, price, bounds)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_counted_bidders_score_as_a_slice():
    """With counts, the first count[b] bidders score as the sliced call
    does and the rest get target 0 and inc 0."""
    x1, x2, price = _case(5, 2, 64, 40, False)
    count = torch.tensor([17, 1], dtype=torch.int32)
    t, i = emd.emd_bids(x1, x2, price, count)
    for b, u in enumerate(count.tolist()):
        ws = emd.emd_bids_plain(x1[b:b + 1, :u], x2[b:b + 1], price[b:b + 1])
        assert torch.equal(t[b, :u], ws[0][0]) and torch.equal(i[b, :u], ws[1][0])
        assert bool((t[b, u:] == 0).all()) and bool((i[b, u:] == 0).all())


def _round_cut_to_u(xyz1, xyz2, state, eps, u, last):
    """The auction round as it was: the list of unassigned ids cut to the
    host-read count u, no counts passed to the bids."""
    assignment, owner, price = state
    b, n = assignment.shape
    unass = assignment < 0
    ids = torch.sort((~unass).to(torch.uint8), dim=1, stable=True).indices[:, :u]
    valid = unass.gather(1, ids)
    ids = torch.where(valid, ids, n)
    x1c = gather_rows3(xyz1, ids.clamp_max(n - 1)).contiguous()
    target, raw = emd.emd_bids(x1c, xyz2, price)
    t = torch.where(valid, target.long(), n)
    if last:
        a = emd._padded(assignment, -1).scatter_(1, torch.where(valid, ids, n), t)
        return a[:, :n], owner, price
    inc = raw + eps
    slot = torch.arange(u, device=ids.device).repeat(b, 1)
    max_inc = torch.full((b, n + 1), float("-inf"), device=ids.device)
    max_inc.scatter_reduce_(1, t, torch.where(valid, inc, float("-inf")), "amax")
    eligible = valid & (inc >= max_inc.gather(1, t) - 1e-6)
    win = torch.full((b, n + 1), u, dtype=torch.long, device=ids.device)
    win.scatter_reduce_(1, torch.where(eligible, t, n), slot, "amin")
    won = eligible & (win.gather(1, t) == slot)
    wid = torch.where(won, ids, n)
    wtgt = torch.where(won, t, n)
    old = torch.where(won, owner.gather(1, wtgt.clamp_max(n - 1)), -1)
    a = emd._padded(assignment, -1)
    a.scatter_(1, torch.where(old >= 0, old, n), -1)
    a.scatter_(1, wid, t)
    o = emd._padded(owner, -1).scatter_(1, wtgt, ids)
    p = emd._padded(price, 0.0).scatter_add_(1, wtgt, torch.where(won, inc, 0.0))
    return a[:, :n], o[:, :n], p[:, :n].contiguous()


def _assign_one_read_a_round(xyz1, xyz2, eps, iters):
    """The auction loop as it was: the unassigned count read on the host
    each round and each round's list cut to it (on the inputs' device)."""
    b, n, _ = xyz1.shape
    dev = xyz1.device
    state = (torch.full((b, n), -1, dtype=torch.long, device=dev),
             torch.full((b, n), -1, dtype=torch.long, device=dev),
             torch.zeros((b, n), dtype=torch.float32, device=dev))
    for r in range(iters):
        u = int((state[0] < 0).sum(1).max())
        if u == 0:
            break
        state = _round_cut_to_u(xyz1, xyz2, state, eps, u, last=r == iters - 1)
    return state[0].to(torch.int32)


@pytest.mark.parametrize("iters", [50, 7])
def test_full_width_auction_matches_the_read_a_round_loop(iters):
    """The rounds at full width with the counts passed to the bids give the
    assignment of the loop that cuts each round's list to a host-read
    count, bit for bit; 7 rounds end in the forced round with bidders
    left."""
    rng = np.random.RandomState(11)
    x1 = _t(rng.rand(2, 384, 3).astype(np.float32) - 0.5)
    x2 = _t(rng.rand(2, 384, 3).astype(np.float32) - 0.5)
    x2[:, 200:260] = x2[:, 100:160]
    want = _assign_one_read_a_round(x1, x2, 0.005, iters)
    assert torch.equal(emd.auction_assign(x1, x2, 0.005, iters), want)
    assert bool((want >= 0).all())
    dist, assign = emd.emd_auction(x1, x2, 0.005, iters)
    assert torch.equal(assign, want)
    assert torch.equal(dist, sqnorm3(x1 - gather_rows3(x2, want.long())))
