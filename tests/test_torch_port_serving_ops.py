"""The port's serving-mode ops (plain versions, on the CPU) against the JAX
package's serving mode.

Serving mode is turned on in the JAX package through its own API
(``set_fast_math``, restored after each test) or by its module globals
(monkeypatched). Inputs are made from a seed with numpy and handed to both
packages as numpy arrays; each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.ops import common as opc
from sparenet_tpu.ops import mds as jax_mds
from sparenet_tpu.ops.p2i import p2i_max_zbg as jax_p2i_max_zbg
from sparenet_tpu.ops.expansion_penalty import \
    mean_mst_length_estimate as jax_mml_estimate
from sparenet_tpu.ops.pallas.knn_pallas import knn_self_pallas
from sparenet_tpu.ops.pallas.mds_pallas import mds_pallas_continue
from sparenet_tpu.utils.calibration import fit_mml_ratio as jax_fit_ratio
from sparenet_tpu_torch.ops import _lib, common, knn, mds, p2i
from sparenet_tpu_torch.ops.expansion_penalty import mean_mst_length_estimate
from sparenet_tpu_torch.utils.calibration import fit_mml_ratio

jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def fast_math():
    opc.set_fast_math(True)
    try:
        yield
    finally:
        opc.set_fast_math(False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# packed-key kNN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,n,k", [
    pytest.param(c, n, 8, id=f"{c}-{n}") for c, n in
    [(3, 300), (8, 128), (16, 200), (40, 120), (64, 256), (128, 300)]] + [
    pytest.param(16, 200, k, id=f"16-200-k{k}") for k in (1, 16, 20)])
def test_knn_packed_matches_pallas_interpret(rng, fast_math, c, n, k):
    """Indices exact against the Pallas kernel's packed arm in interpret
    mode (one bf16 pass, truncated keys, lowest index on ties), at the
    model's k = 8 and at other k (the CUDA kernels take k <= 32)."""
    x = rng.randn(2, n, c).astype(np.float32)
    want = np.asarray(knn_self_pallas(jnp.asarray(x), k, interpret=True,
                                      packed=True))
    got = knn.knn_idx(_t(x), k, packed=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,seed", [(256, 0), (512, 1)])
def test_knn_packed_wide_channels_near_ties_only(fast_math, c, seed):
    """At 256 and more channels the reference's XLA program sums |x|^2 in
    its own vectorised order, which the port's channel-order sum does not
    reproduce, so a distance may land one truncation bucket over: an index
    may differ only where the two candidates' keys (by the port's
    distances) are in the same or adjacent buckets, at most 0.1% of the
    entries (these seeds give 2 each: one swapped pair)."""
    n = 256
    x = np.random.RandomState(seed).randn(2, n, c).astype(np.float32)
    want = np.asarray(knn_self_pallas(jnp.asarray(x), 8, interpret=True,
                                      packed=True))
    got = knn.knn_idx(_t(x), 8, packed=True).numpy()
    mis = got != want
    assert mis.sum() <= 1e-3 * mis.size
    d = common.pairwise_sqdist_serving(_t(x), _t(x)).numpy()
    b, i, j = np.nonzero(mis)
    bits = knn.packed_bits(n)
    gap = ((d[b, i, got[b, i, j]].view(np.int32) >> bits)
           - (d[b, i, want[b, i, j]].view(np.int32) >> bits))
    assert np.abs(gap).max(initial=0) <= 1


def test_knn_packed_duplicates_take_lowest_index(fast_math):
    base = np.random.RandomState(3).rand(1, 40, 3).astype(np.float32)
    x = np.concatenate([base, base, base[:, :10]], axis=1)
    want = np.asarray(knn_self_pallas(jnp.asarray(x), 8, interpret=True,
                                      packed=True))
    got = knn.knn_idx(_t(x), 8, packed=True).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 45, :3], [5, 45, 85])


def test_knn_packed_arm_applies_where_the_reference_takes_it():
    """The reference runs the packed arm only in its one-chunk kernel; the
    other shapes take the exact arm, as here."""
    assert knn.packed_bits(3000) == 12 and knn.packed_bits(128) == 7
    assert knn.packed_applies(3000, 512) and knn.packed_applies(8192, 1024)
    assert not knn.packed_applies(16384, 1024)
    _lib.reset_counts()
    x = torch.randn(1, 20, 4)
    knn.knn_idx(x, 8, packed=True)
    knn.knn_idx(x, 8)
    assert _lib.PLAIN_CALLS["knn_packed"] == 1 and _lib.PLAIN_CALLS["knn"] == 1


# ---------------------------------------------------------------------------
# batch-greedy MDS
# ---------------------------------------------------------------------------

def test_select_smallest_matches_jax_sort_arm(rng):
    """Same picks in the same order as _select_smallest_sort, with exact
    ties (repeated values) and pinned lanes."""
    temp = rng.rand(3, 500).astype(np.float32)
    temp[:, 100:200] = temp[:, :100]
    temp[:, ::7] = 1e9
    temp[1, :300] = 0.0
    for take in (1, 50, 333, 420):
        want = np.asarray(jax_mds._select_smallest_sort(jnp.asarray(temp),
                                                        take))
        got = mds.select_smallest(_t(temp), take)
        np.testing.assert_array_equal(got.numpy(), want)


def _rounds(npoint, g, schedule):
    """Picks covered after each round (the reference's round plan)."""
    covered, out = 1, [1]
    for take in mds._round_sizes(npoint, g, schedule):
        covered += take
        out.append(covered)
    return out


@pytest.mark.parametrize("g,schedule", [(64, ()), (64, (16,)), (32, (8, 40))])
def test_mds_batched_anchored_round_by_round(rng, g, schedule):
    """Each round run from the JAX state before it: the same picks (a pick
    may differ only where two densities lie within the rtol; counted, 0
    expected here), and the updated densities within rtol 1e-5 of the JAX
    state after it (chunked sums and exp2 round differently from XLA)."""
    xyz = rng.rand(2, 300, 3).astype(np.float32)
    mml = np.array([0.1, 0.2], np.float32)
    xj, mj = jnp.asarray(xyz), jnp.asarray(mml)
    x, kde, bias = mds.batched_terms(_t(xyz), _t(mml))
    plan = _rounds(250, g, schedule)
    states = []
    for covered in plan:
        idx, st = jax_mds._mds_batched(xj, covered, mj, g=g, schedule=schedule,
                                       return_state=True, select="sort")
        states.append((np.asarray(idx), np.asarray(st)))
    # the seed state (pick 0 only)
    seed = mds._bump(x, x[:, :1], kde, bias)
    seed[:, 0] = 1e9
    np.testing.assert_allclose(seed.numpy(), states[0][1], rtol=1e-5)
    near_tie_picks = 0
    for r in range(1, len(plan)):
        before, (idx, after) = states[r - 1][1], states[r]
        take = plan[r] - plan[r - 1]
        want = idx[:, plan[r - 1]:plan[r]]
        got = mds.select_smallest(_t(before), take).numpy()
        for bi in range(2):
            if not np.array_equal(got[bi], want[bi]):
                # only a near-tie may swap, at the boundary of the set
                d = set(got[bi]) ^ set(want[bi])
                vals = before[bi, sorted(d)]
                assert np.ptp(vals) <= 1e-5 * vals.max(), (r, bi)
                near_tie_picks += len(d) // 2
        upd = mds.batched_update(x, _t(before).clone(), _t(want), kde, bias)
        np.testing.assert_allclose(upd.numpy(), after, rtol=1e-5)
    assert near_tie_picks == 0


@pytest.mark.parametrize("g,schedule", [(64, (16,)), (96, ())])
def test_mds_batched_free_running_and_rows(rng, g, schedule):
    """The port's own run: the same picks as JAX's (0 near-tie swaps at this
    size), and return_xyz rows exactly xyz[idx]."""
    xyz = rng.rand(2, 300, 3).astype(np.float32)
    mml = np.array([0.1, 0.2], np.float32)
    want, want_sel = jax_mds._mds_batched(jnp.asarray(xyz), 250,
                                          jnp.asarray(mml), g=g,
                                          schedule=schedule, return_xyz=True,
                                          select="sort")
    idx, sel = mds.mds_batched(_t(xyz), 250, _t(mml), g=g, schedule=schedule,
                               return_xyz=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        sel.numpy(), np.take_along_axis(xyz, idx.numpy()[..., None].astype(
            np.int64), axis=1))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))


# ---------------------------------------------------------------------------
# the greedy continuation (kernel #5's plain version) and the hybrid arm
# ---------------------------------------------------------------------------

def _compact_like_jax(xyz, temp, npick):
    """The live lanes as _mds_hybrid's Pallas branch compacts them."""
    b, n, _ = xyz.shape
    lane = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None], (b, n))
    key = jnp.where(temp >= 5e8, jnp.int32(1 << 24), 0) + lane
    xt = jnp.moveaxis(xyz, -1, 0)
    _, temp_c, orig, xs, ys, zs = jax.lax.sort(
        (key, temp, lane, xt[0], xt[1], xt[2]), dimension=-1, num_keys=1)
    nlive = n - npick
    xyz_c = jnp.stack([xs[:, :nlive], ys[:, :nlive], zs[:, :nlive]], -1)
    return (np.asarray(xyz_c), np.asarray(temp_c[:, :nlive]),
            np.asarray(orig[:, :nlive]))


@pytest.mark.parametrize("n,npick,tail,g", [(300, 200, 40, 64),
                                            (9000, 8300, 300, 4096)])
def test_mds_continue_matches_jax_xla_tail(rng, n, npick, tail, g):
    """From JAX's prefix state, the port's compaction and continuation
    (plain) pick exactly the XLA tail's points (full width there, compacted
    here); with n = 9000 the lanes above 8192 carry the 2x weight."""
    xyz = rng.rand(2, n, 3).astype(np.float32)
    mml = np.array([0.02, 0.035], np.float32)
    xj, mj = jnp.asarray(xyz), jnp.asarray(mml)
    _, temp = jax_mds._mds_batched(xj, npick, mj, g=g, return_state=True)
    want = np.asarray(jax_mds._mds_hybrid(xj, npick + tail, mj, g=g, tail=tail,
                                          tail_impl="xla"))[:, npick:]
    xc, tc, orig = mds.compact_live(_t(xyz), _t(np.asarray(temp)), n - npick)
    _lib.reset_counts()
    lanes = mds.mds_continue(xc, tc, orig, _t(mml), tail)
    assert _lib.PLAIN_CALLS["mds_continue"] == 1
    np.testing.assert_array_equal(orig.gather(1, lanes.long()).numpy(), want)


def test_mds_continue_matches_pallas_interpret():
    """On the inputs of tests/test_mds_hybrid.py's Pallas-continuation test
    (seed 0, g 32, 100 + 60 picks of 200): lanes exact against
    mds_pallas_continue in interpret mode."""
    rng = np.random.RandomState(0)
    xyz = jnp.asarray(rng.rand(2, 200, 3), jnp.float32)
    mml = jnp.asarray([0.2, 0.35], jnp.float32)
    npick, tail = 100, 60
    _, temp = jax_mds._mds_batched(xyz, npick, mml, g=32, return_state=True)
    xyz_c, temp_c, orig = _compact_like_jax(xyz, temp, npick)
    want = np.asarray(mds_pallas_continue(
        jnp.asarray(xyz_c), jnp.asarray(temp_c), jnp.asarray(orig), mml,
        tail, interpret=True))
    got = mds.mds_continue(_t(xyz_c), _t(temp_c), _t(orig),
                           _t(np.asarray(mml)), tail)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("g,tail", [(64, 32), (128, 120), (32, 500)])
def test_mds_hybrid_matches_jax(rng, g, tail):
    """The whole hybrid arm on its own prefix: picks exact against
    _mds_hybrid with the XLA tail (tail 500 > npoint - 1 is cut to 249), and
    return_xyz rows exactly xyz[idx]."""
    xyz = rng.rand(2, 300, 3).astype(np.float32)
    mml = np.array([0.1, 0.2], np.float32)
    want = np.asarray(jax_mds._mds_hybrid(jnp.asarray(xyz), 250,
                                          jnp.asarray(mml), g=g, tail=tail,
                                          tail_impl="xla"))
    idx, sel = mds.mds_hybrid(_t(xyz), 250, _t(mml), g=g, tail=tail,
                              return_xyz=True)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(
        sel.numpy(), np.take_along_axis(xyz, want[..., None].astype(np.int64),
                                        axis=1))


def test_mds_dispatch(rng, monkeypatch):
    """resolve_impl: "auto" is batched in serving mode and exact otherwise;
    minimum_density_sample_xyz routes each arm as the JAX dispatch does
    with its globals set to the same G, schedule and tail."""
    assert mds.resolve_impl("auto", serving=True) == "batched"
    assert mds.resolve_impl("auto") == "exact"
    assert mds.resolve_impl("hybrid") == "hybrid"
    with pytest.raises(ValueError):
        mds.resolve_impl("pallas")
    monkeypatch.setattr(jax_mds, "_MDS_BATCH_G", 64)
    monkeypatch.setattr(jax_mds, "_MDS_SCHEDULE", (16,))
    monkeypatch.setattr(jax_mds, "_MDS_TAIL", 48)
    xyz = rng.rand(2, 300, 3).astype(np.float32)
    mml = np.array([0.1, 0.2], np.float32)
    for arm in ("batched", "hybrid", "exact"):
        want, want_sel = jax_mds.minimum_density_sample_xyz(
            jnp.asarray(xyz), 250, jnp.asarray(mml),
            impl="xla" if arm == "exact" else arm)
        idx, sel = mds.minimum_density_sample_xyz(
            _t(xyz), 250, _t(mml), arm, g=64, schedule=(16,), tail=48)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
        np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))


def test_mds_continue_rejects_what_it_does_not_take():
    xyz, temp = torch.zeros(1, 10, 3), torch.zeros(1, 10)
    orig, mml = torch.arange(10, dtype=torch.int32)[None], torch.ones(1)
    with pytest.raises(ValueError):
        mds.mds_continue(xyz, temp, orig, mml, 11)
    with pytest.raises(TypeError):
        mds.mds_continue(xyz, temp, orig.long(), mml, 5)
    with pytest.raises(ValueError):
        mds.mds_continue(xyz, temp[:, :9].contiguous(), orig, mml, 5)


# ---------------------------------------------------------------------------
# mml estimate and calibration
# ---------------------------------------------------------------------------

def _clouds(rng, b=3, prims=4, s=64):
    """Per primitive a blob of s points with its own spread."""
    c = rng.randn(b, prims, s, 3) * rng.uniform(0.02, 0.2, (b, prims, 1, 1))
    return (c + rng.uniform(-0.5, 0.5, (b, prims, 1, 3))).reshape(
        b, prims * s, 3).astype(np.float32)


@pytest.mark.parametrize("calibration", [1.0, 1.33, 3.18])
def test_mml_estimate_matches_jax(rng, calibration):
    """rtol 1e-5 (the norms' and products' sums round in another order)."""
    xyz = _clouds(rng)
    want = np.asarray(jax_mml_estimate(jnp.asarray(xyz), 64, calibration))
    got = mean_mst_length_estimate(_t(xyz), 64, calibration)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_fit_mml_ratio_matches_jax(rng):
    """rtol 1e-5; the ratio turns the estimate into the exact mml on
    average."""
    xyz = _clouds(rng)
    want = float(jax_fit_ratio(jnp.asarray(xyz), 64))
    got = float(fit_mml_ratio(_t(xyz), 64))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 1.0 < got < 5.0


# ---------------------------------------------------------------------------
# p2i backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [2.0, 4.5])
def test_p2i_backward_plain_matches_jax_vjp(rng, radius):
    """The plain backward (unchanged), called through the wrapper on CPU
    tensors, against jax.vjp of p2i_max_zbg: within 1e-5 of the largest
    entry (reassociated sums)."""
    b, h, w, p = 2, 24, 32, 300
    pts = (rng.rand(p, 2) * [h + 4, w + 4] - 2).astype(np.float32)
    feats = (rng.rand(p, 1) * 1.2 - 0.2).astype(np.float32)
    binds = rng.randint(0, b, p).astype(np.int32)
    g = rng.randn(b, h, w, 1).astype(np.float32)
    out, vjp = jax.vjp(lambda a, f: jax_p2i_max_zbg(a, f, jnp.asarray(binds),
                                                          b, h, w, radius),
                       jnp.asarray(pts), jnp.asarray(feats))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    _, ids = p2i.p2i_max(_t(pts), _t(feats), _t(binds), b, h, w, radius)
    _lib.reset_counts()
    got = p2i.p2i_max_backward(_t(pts), _t(feats), _t(binds), ids, _t(g),
                               radius)
    assert _lib.PLAIN_CALLS["p2i_bwd"] == 1 and _lib.LAUNCHES["p2i_bwd"] == 0
    for a, e in zip(got, want):
        assert a.shape == e.shape
        np.testing.assert_allclose(a.numpy(), e, rtol=0,
                                   atol=1e-5 * np.abs(e).max())
