"""The batched MDS rounds' four selection arms (``ops/mds.py:
select_smallest_*``) against the JAX package's (``_select_smallest_sort``,
``_select_smallest``, ``lax.top_k`` and ``_select_smallest_pack16``), and
the ``select`` argument through ``mds_batched``, ``mds_hybrid``'s prefix,
``minimum_density_sample_xyz`` and the model, against the JAX functions
with ``_MDS_SELECT`` patched.

Every arm must return its JAX arm's indices in the same order, exactly.
Densities are made from a seed with numpy: exact ties, pinned lanes (1e9),
rows of zeros, near-ties inside 2^-7 (where pack16 parts from sort, and
must still match JAX's pack16) and rows of 2^15 lanes or more (pack16 falls
back to sort).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.ops import mds as jax_mds
from sparenet_tpu_torch.models import build_generator
from sparenet_tpu_torch.ops import mds

jax.config.update("jax_platforms", "cpu")

JAX_ARMS = {"sort": jax_mds._select_smallest_sort,
            "bisect": jax_mds._select_smallest,
            "topk": lambda t, k: jax.lax.top_k(-t, k)[1],
            "pack16": jax_mds._select_smallest_pack16}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _densities(case: str) -> np.ndarray:
    rng = np.random.RandomState(0)
    if case == "wide":
        t = rng.rand(2, 1 << 15).astype(np.float32)
        t[:, 1000:2000] = t[:, :1000]
        return t
    t = rng.rand(3, 600).astype(np.float32) * 40.0
    if case == "ties":
        t[:, 200:400] = t[:, :200]
        t[2] = np.round(t[2])
    elif case == "pinned":
        t[:, ::5] = 1e9
        t[1, :450] = 1e9
    elif case == "zeros":
        t[0] = 0.0
        t[1, 100:500] = 0.0
        t[2, ::3] = 0.0
    elif case == "near_ties":
        # relative gaps below 2^-7: one 15-bit rank bucket or its neighbour
        base = t[:, :1] * (1.0 + rng.rand(3, 600).astype(np.float32) * 2.0 ** -8)
        t = base.astype(np.float32)
    return t


CASES = ("ties", "pinned", "zeros", "near_ties", "wide")
TAKES = {"wide": (1, 4000)}


@pytest.mark.parametrize("arm", tuple(JAX_ARMS))
@pytest.mark.parametrize("case", CASES)
def test_arm_matches_jax(arm, case):
    """The same indices in the same order as the JAX arm, at several round
    sizes."""
    t = _densities(case)
    for take in TAKES.get(case, (1, 37, 300, 599)):
        want = np.asarray(JAX_ARMS[arm](jnp.asarray(t), take))
        got = mds.select_smallest(torch.from_numpy(t), take, arm)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"take {take}")


def test_arm_orders():
    """sort and topk return ascending density (ties to the lower index),
    bisect ascending index; the three pick one set. On near-ties pack16
    picks another set; on 2^15 lanes it is the sort arm."""
    t = _densities("ties")
    tt = torch.from_numpy(t)
    s, b, k = (mds.select_smallest(tt, 300, a) for a in ("sort", "bisect", "topk"))
    assert torch.equal(s, k)
    assert torch.equal(b, s.sort(1).values)
    assert bool((b[:, 1:] > b[:, :-1]).all())
    near = torch.from_numpy(_densities("near_ties"))
    assert not torch.equal(mds.select_smallest(near, 300, "pack16").sort(1).values,
                           mds.select_smallest(near, 300, "sort").sort(1).values)
    wide = torch.from_numpy(_densities("wide"))
    assert torch.equal(mds.select_smallest(wide, 4000, "pack16"),
                       mds.select_smallest(wide, 4000, "sort"))
    with pytest.raises(ValueError, match="selection arm"):
        mds.select_smallest(tt, 3, "heap")


@pytest.fixture
def jax_select(monkeypatch):
    """Set the JAX package's selection arm (its SPARENET_MDS_SELECT). Its
    jitted functions read the global when they trace, and their caches do
    not key on it, so the caches are cleared around each test."""
    jax.clear_caches()

    def set_(arm):
        monkeypatch.setattr(jax_mds, "_MDS_SELECT", arm)
    yield set_
    jax.clear_caches()


def _rounds(npoint, g, schedule):
    covered, out = 1, [1]
    for take in mds._round_sizes(npoint, g, schedule):
        covered += take
        out.append(covered)
    return out


@pytest.mark.parametrize("select", ("pack16",))
def test_mds_batched_anchored_round_by_round(select, jax_select):
    """Each round run from the JAX state before it (JAX's ``_round_pick``
    reading the patched ``_MDS_SELECT``): the same picks in the same order,
    and the updated densities within rtol 1e-5 of the JAX state after it."""
    jax_select(select)
    rng = np.random.RandomState(1)
    xyz = rng.rand(2, 300, 3).astype(np.float32)
    mml = np.array([0.1, 0.2], np.float32)
    xj, mj = jnp.asarray(xyz), jnp.asarray(mml)
    x, kde, bias = mds.batched_terms(torch.from_numpy(xyz), torch.from_numpy(mml))
    g, schedule = 64, (16,)
    plan = _rounds(250, g, schedule)
    states = [tuple(map(np.asarray, jax_mds._mds_batched(
        xj, covered, mj, g=g, schedule=schedule, return_state=True)))
        for covered in plan]
    for r in range(1, len(plan)):
        before, (idx, after) = states[r - 1][1], states[r]
        want = idx[:, plan[r - 1]:plan[r]]
        got = mds.select_smallest(torch.from_numpy(before), plan[r] - plan[r - 1],
                                  select)
        np.testing.assert_array_equal(got.numpy(), want)
        upd = mds.batched_update(x, torch.from_numpy(before).clone(),
                                 torch.from_numpy(want), kde, bias)
        np.testing.assert_allclose(upd.numpy(), after, rtol=1e-5)


@pytest.mark.parametrize("select", ("sort", "pack16"))
@pytest.mark.parametrize("mml", (0.2, 0.02, 0.005))
def test_mds_batched_free_running(select, mml, jax_select):
    """The port's whole run against JAX's, down to the flagship's cold
    temperatures, where most exp2 terms fall below the smallest normal f32:
    the JAX package's XLA program flushes them to 0 (far lanes tie and the
    lowest index takes them), and so must the port."""
    jax_select(select)
    rng = np.random.RandomState(2)
    xyz = rng.rand(2, 600, 3).astype(np.float32)
    m = np.array([mml, 1.5 * mml], np.float32)
    want = np.asarray(jax_mds._mds_batched(jnp.asarray(xyz), 500, jnp.asarray(m),
                                           g=128, schedule=(32,)))
    got = mds.mds_batched(torch.from_numpy(xyz), 500, torch.from_numpy(m),
                          g=128, schedule=(32,), select=select)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("select", ("pack16", "topk"))
def test_mds_hybrid_prefix_takes_select(select, jax_select):
    """The hybrid arm's batched prefix picks by the selection arm (JAX's
    prefix reads ``_MDS_SELECT``), then the exact tail: picks exact against
    _mds_hybrid with its XLA tail, rows exactly xyz[idx]."""
    jax_select(select)
    rng = np.random.RandomState(3)
    xyz = rng.rand(2, 300, 3).astype(np.float32)
    mml = np.array([0.05, 0.08], np.float32)
    want = np.asarray(jax_mds._mds_hybrid(jnp.asarray(xyz), 250, jnp.asarray(mml),
                                          g=64, tail=40, tail_impl="xla"))
    idx, sel = mds.mds_hybrid(torch.from_numpy(xyz), 250, torch.from_numpy(mml),
                              g=64, tail=40, return_xyz=True, select=select)
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(
        sel.numpy(), np.take_along_axis(xyz, want[..., None].astype(np.int64), 1))


def test_dispatch_and_model_take_select(jax_select, monkeypatch):
    """minimum_density_sample_xyz routes ``select`` as the JAX dispatch
    routes its globals; the model's serving refine and its batched training
    arm (serving-aligned training) pick by the model's ``select``."""
    jax_select("pack16")
    monkeypatch.setattr(jax_mds, "_MDS_BATCH_G", 64)
    monkeypatch.setattr(jax_mds, "_MDS_SCHEDULE", (16,))
    rng = np.random.RandomState(4)
    xyz = rng.rand(2, 300, 3).astype(np.float32)
    mml = np.array([0.05, 0.08], np.float32)
    want, want_sel = jax_mds.minimum_density_sample_xyz(
        jnp.asarray(xyz), 250, jnp.asarray(mml), impl="batched")
    idx, sel = mds.minimum_density_sample_xyz(
        torch.from_numpy(xyz), 250, torch.from_numpy(mml), "batched", g=64,
        schedule=(16,), select="pack16")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    assert mds.dial_state(64, (16,), "pack16") == jax_mds.dial_state() == {
        "rounds": [16], "select": "pack16"}

    seen = []
    base = mds.select_smallest

    def spy(temp, take, select="sort"):
        seen.append(select)
        return base(temp, take, select)

    monkeypatch.setattr(mds, "select_smallest", spy)
    model = build_generator(device="cpu", num_points=128, n_primitives=4,
                            bottleneck_size=64, hide_size=64, serving=True,
                            mds="batched", mds_g=32, train_mds="batched",
                            select="bisect")
    partial = torch.from_numpy(rng.rand(2, 64, 3).astype(np.float32) - 0.5)
    with torch.no_grad():
        model.eval()(partial)
        n_eval = len(seen)
        model.train()(partial)
    assert n_eval > 0 and len(seen) > n_eval and set(seen) == {"bisect"}
    with pytest.raises(ValueError, match="selection arm"):
        build_generator(device="cpu", num_points=128, n_primitives=4,
                        bottleneck_size=64, hide_size=64, select="heap")


def test_density_terms_flush_below_smallest_normal():
    """A bump term below the smallest normal f32 adds 0, as the JAX
    package's XLA program computes exp2 (its CPU and TPU programs flush
    subnormal results); a normal term counts (within the two exp2s'
    rounding: rtol 1e-5, as the densities above)."""
    args = [-125.0, -125.9, -127.0, -149.0, -30.0]
    want = np.asarray(jnp.exp2(jnp.asarray(args, jnp.float32)))
    assert want[:2].all() and not want[2:4].any()
    got = mds._bump(torch.zeros(1, len(args), 3), torch.zeros(1, 1, 3),
                    torch.ones(1, 1), torch.tensor([args]))
    np.testing.assert_array_equal(got.numpy()[0] == 0, want == 0)
    np.testing.assert_allclose(got.numpy()[0], want, rtol=1e-5)
