"""The port's GRNet (ops, sampling, model and weights) against the JAX
package's, on the CPU at toy size: B=2, 128 input points, 16 sampled points
(128 dense), gridding scale 16 for the ops and 32 for the model (a 2^3
bottleneck, so the fc5/fc6 flatten order matters).

Parity contract (tests/test_forward_parity.py): values and gradients
elementwise within atol 3e-6 and rtol 1e-4. The sample's selection is held
exactly: ``sample_indices`` fed the JAX package's Gumbel noise picks the
rows its ``random_point_sampling`` picks, ties included. The forwards are
anchored on the JAX package's sample: its candidates and picks are
recorded by a wrapper of ``random_point_sampling`` around the unchanged
function (``jax.debug.callback``), and the port model takes the picks as
``sample_idx``.

The model's variables are drawn well-conditioned on the JAX side (kernels
normal with std 1/sqrt(fan_in), BatchNorm scales 1 + 0.1 normal, biases 0.1
normal, running statistics jittered): the reference's initialisation gives
offsets of about 1e-3, where an elementwise check of the dense cloud says
little about the offset MLP. The train-mode forward takes the conv biases
ahead of its BatchNorms at 0, as the reference's initialisation draws them
and as training keeps them (a train-mode BatchNorm removes the bias, so its
gradient is 0): a bias moves the batch mean away from 0 and leaves the
spread, and over the mostly empty grid flax's one-pass variance E[x^2] -
E[x]^2, which the port follows, then cancels (a mean 8.5 times the spread
at conv1 here) and both packages lose digits, each in its own summation
order (2e-3 relative at conv1's BatchNorm).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.models import grnet as jax_grnet
from sparenet_tpu.ops.cubic_feature_sampling import \
    cubic_feature_sampling as jax_cubic
from sparenet_tpu.utils import torch_import as ti
from sparenet_tpu_torch import models as port_models
from sparenet_tpu_torch.configs import cfg_from_file, shipped_yaml
from sparenet_tpu_torch.models import grnet as port_grnet
from sparenet_tpu_torch.ops import gridding, gridding_loss
from sparenet_tpu_torch.ops.cubic_feature_sampling import \
    cubic_feature_sampling
from sparenet_tpu_torch.utils.weights import (reference_state_dict,
                                              state_dict_from_jax)
from tests.test_torch_msn_atlasnet_train import _Kept

jax.config.update("jax_platforms", "cpu")

# the modules (sparenet_tpu.ops exports functions of the same names)
jax_gridding = importlib.import_module("sparenet_tpu.ops.gridding")
jax_gloss = importlib.import_module("sparenet_tpu.ops.gridding_loss")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, N_IN, N_SAMP = 2, 128, 16
S_OPS, S_MODEL = 16, 32
ATOL, RTOL = 3e-6, 1e-4


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def port_grad(fn, x: np.ndarray, cot: np.ndarray):
    """(fn(x), d sum(fn(x) * cot) / dx) through torch autograd."""
    t = torch.tensor(x, requires_grad=True)
    out = fn(t)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), t.grad.numpy()


def jax_grad(fn, x: np.ndarray, cot: np.ndarray):
    """(fn(x), d sum(fn(x) * cot) / dx) through jax.vjp, jitted."""
    def both(x, cot):
        out, vjp = jax.vjp(fn, x)
        return out, vjp(cot)[0]
    out, grad = jax.jit(both)(jnp.asarray(x), jnp.asarray(cot))
    return np.asarray(out), np.asarray(grad)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def _cloud(rng, n=200):
    """Points in [-1, 1] with the cases the scatter must get right: zero
    rows, a non-zero row whose coordinates sum to 0 (it adds nothing),
    points on the +1 face (their upper corners fall off the grid) and on the
    -1 face, and a point on a grid vertex."""
    c = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    c[0, :5] = 0.0
    c[0, 5] = (0.5, -0.25, -0.25)
    c[1, 0] = (1.0, 1.0, 1.0)
    c[1, 1] = (1.0, -0.3, 0.2)
    c[1, 2] = (-1.0, -1.0, -1.0)
    c[1, 3] = (0.25, -0.5, 0.125)        # on a vertex at scale 16
    return c


def test_gridding_matches_jax():
    """Grid and the gradient to the points, elementwise."""
    rng = np.random.RandomState(0)
    cloud = _cloud(rng)
    cot = rng.randn(B, S_OPS, S_OPS, S_OPS).astype(np.float32)
    want, want_g = jax_grad(lambda c: jax_gridding.gridding(c, S_OPS),
                            cloud, cot)
    got, got_g = port_grad(lambda c: gridding.gridding(c, S_OPS), cloud, cot)
    assert got.shape == (B, S_OPS, S_OPS, S_OPS)
    close(got, want)
    close(got_g, want_g)
    assert np.all(got_g[0, :6] == 0)          # rows that add nothing


def test_gridding_drops_corners_below_the_grid():
    """A point below -1: the port drops its corners off the grid on both
    sides, as the reference's drop mode means; the JAX package's scatter
    wraps the corner at index -1 to the far face (numpy indexing), which
    only such points reach. Elsewhere the two grids agree."""
    cloud = np.zeros((1, 2, 3), np.float32)
    cloud[0, 0] = (-1.05, 0.1, 0.2)
    cloud[0, 1] = (0.3, 0.4, 0.5)
    got = gridding.gridding(torch.from_numpy(cloud), S_OPS).numpy()
    want = np.asarray(jax_gridding.gridding(jnp.asarray(cloud), S_OPS))
    assert got[0, -1].sum() == 0 and want[0, -1].sum() > 0
    close(got[0, :-1], want[0, :-1])


def test_gridding_reverse_matches_jax():
    """Cloud and the gradient to the grid, elementwise, with empty voxels and
    voxels whose 8 weights sum below 1e-6. A grid value's gradient sums
    terms of up to 1/(weight sum) that cancel (up to 180 here, for sums of
    0.9 down to 0.03), so float32 rounding alone moves it by up to 5e-5 in
    either package: an entry outside the contract against the JAX package
    must lie nearer the float64 gradient than the JAX package's does, and
    such entries must be few (one here: the port 1e-7 from the float64
    value, the JAX package 7.7e-6)."""
    rng = np.random.RandomState(1)
    s = S_OPS
    grid = rng.rand(B, s, s, s) * (rng.rand(B, s, s, s) > 0.6)
    tiny = rng.rand(B, s, s, s) > 0.97
    grid = np.where(tiny, 1e-8 * rng.rand(B, s, s, s), grid).astype(np.float32)
    grid[:, :6] = np.where(grid[:, :6] > 0.5, 1e-7, 0.0)  # near the 1e-6 sum
    cot = rng.randn(B, s ** 3, 3).astype(np.float32)
    want, want_g = jax_grad(lambda g: jax_gridding.gridding_reverse(g, s),
                            grid, cot)
    got, got_g = port_grad(lambda g: gridding.gridding_reverse(g, s), grid,
                           cot)
    n_zero = int((np.abs(want).sum(-1) == 0).sum())
    assert 0 < n_zero < B * s ** 3 // 2
    close(got, want)
    np.testing.assert_array_equal(np.abs(got).sum(-1) == 0,
                                  np.abs(want).sum(-1) == 0)
    _, truth = port_grad(lambda g: gridding.gridding_reverse(g, s),
                         grid.astype(np.float64), cot.astype(np.float64))
    off = ~np.isclose(got_g, want_g, atol=ATOL, rtol=RTOL)
    assert off.sum() <= 2
    assert (np.abs(got_g - truth)[off] < np.abs(want_g - truth)[off]).all()


def test_cubic_feature_sampling_matches_jax():
    """A channel-first volume against the JAX package's channel-last one:
    the [B, N, 8, C] features equal (corner-major, channel-minor; zeros off
    the grid) and the gradient to the volume elementwise."""
    rng = np.random.RandomState(2)
    c, s, n = 5, 8, 60
    vol = rng.randn(B, s, s, s, c).astype(np.float32)      # channel-last
    pts = rng.uniform(-1.1, 1.1, (B, n, 3)).astype(np.float32)
    pts[0, 0] = (1.0, 1.0, -1.0)
    cot = rng.randn(B, n, 8, c).astype(np.float32)
    want, want_g = jax_grad(lambda v: jax_cubic(jnp.asarray(pts), v), vol,
                            cot)
    first = vol.transpose(0, 4, 1, 2, 3).copy()              # channel-first
    got, got_g = port_grad(
        lambda v: cubic_feature_sampling(torch.from_numpy(pts), v), first,
        cot)
    assert got.shape == (B, n, 8, c)
    np.testing.assert_array_equal(got, want)
    assert (want == 0).all(-1).any()                        # off the grid
    close(got_g.transpose(0, 2, 3, 4, 1), want_g)


def test_gridding_loss_matches_jax():
    """The loss at two scales (the reference's dynamic vertex count as the
    mean's divisor) and its gradient to the prediction."""
    rng = np.random.RandomState(3)
    pred = rng.uniform(-0.9, 0.9, (B, 100, 3)).astype(np.float32)
    gt = rng.uniform(-0.5, 0.5, (B, 100, 3)).astype(np.float32)
    gt[1, :4] = 0.0
    scales, alphas = (8, 16), (0.1, 0.05)
    want, want_g = jax_grad(lambda p: jax_gloss.GriddingLoss(scales, alphas)(
        p, jnp.asarray(gt)), pred, np.float32(1.0))
    p = torch.tensor(pred, requires_grad=True)
    got = gridding_loss.GriddingLoss(scales, alphas)(p, torch.from_numpy(gt))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    close(p.grad.numpy(), want_g)
    _, _, n_v = gridding_loss.gridding_distance(torch.from_numpy(pred),
                                                torch.from_numpy(gt), 8)
    _, _, jn_v = jax_gloss.gridding_distance(jnp.asarray(pred),
                                             jnp.asarray(gt), 8)
    assert float(n_v) == float(jn_v)


# ---------------------------------------------------------------------------
# the sample
# ---------------------------------------------------------------------------

def _jax_gumbel(key, b: int, n: int) -> np.ndarray:
    """The noise ``random_point_sampling`` draws: one key a sample."""
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(
        jax.random.split(key, b)))


@pytest.mark.parametrize("n_valid", [None, 9], ids=["valid", "few_valid"])
def test_sample_indices_pick_the_jax_rows(n_valid):
    """``sample_indices`` on the JAX package's noise picks its rows exactly.
    With fewer valid rows than n the rest are the invalid rows of lowest
    index, in index order: those rows sum to 0 but differ, so their order
    shows."""
    rng = np.random.RandomState(4)
    partial = rng.uniform(-1, 1, (B, 20, 3)).astype(np.float32)
    pred = rng.uniform(-1, 1, (B, 30, 3)).astype(np.float32)
    if n_valid is not None:
        a = rng.uniform(0.1, 0.9, (B, 50, 1)).astype(np.float32)
        invalid = np.concatenate([a, -a, np.zeros_like(a)], -1)
        keep = np.zeros((B, 50, 1), bool)
        keep[:, rng.permutation(50)[:n_valid]] = True
        both = np.where(keep, np.concatenate([partial, pred], 1), invalid)
        partial, pred = both[:, :20].copy(), both[:, 20:].copy()
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_grnet.random_point_sampling(
        key, jnp.asarray(pred), jnp.asarray(partial), N_SAMP))
    cloud = np.concatenate([partial, pred], 1)
    valid = torch.from_numpy(cloud.sum(-1) != 0)
    idx = port_grnet.sample_indices(
        valid, torch.tensor(_jax_gumbel(key, B, 50)), N_SAMP).numpy()
    np.testing.assert_array_equal(
        np.take_along_axis(cloud, idx[..., None], 1), want)
    if n_valid is not None:
        assert (idx[:, n_valid:] == np.sort(idx[:, n_valid:], 1)).all()
        assert not valid.numpy()[np.arange(B)[:, None], idx[:, n_valid:]].any()


def test_sample_draws_from_the_callers_generator():
    """The noise comes from the generator alone: the same seed picks the same
    rows, another seed others; every pick is a valid row, none twice; no
    generator and no sample_idx is an error."""
    valid = torch.rand(B, 400, generator=torch.Generator().manual_seed(0)) > 0.3

    def pick(seed):
        g = port_grnet.gumbel_noise((B, 400), torch.Generator().manual_seed(seed),
                                    "cpu")
        return port_grnet.sample_indices(valid, g, 64)
    a, b, c = pick(1), pick(1), pick(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    for row in range(B):
        assert valid[row, a[row]].all() and a[row].unique().numel() == 64
    model = port_grnet.GRNet(n_sampling_points=4, gridding_scale=16)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(torch.zeros(1, 8, 3))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def draw(shapes, rng):
    """Well-conditioned variables of the given shape tree (see the module
    docstring)."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.normal(size=s.shape)
        elif name == "mean":
            v = rng.uniform(-0.3, 0.3, s.shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        else:
            v = 0.1 * rng.normal(size=s.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def recording_sampler(keep):
    """``random_point_sampling`` unchanged, its noise ("gumbel"), candidates
    ("cloud") and picks (the top-k of its scores, "picks") handed to
    ``keep(name, value)`` inside the trace."""
    orig = jax_grnet.random_point_sampling

    def rps(key, pred_cloud, partial_cloud, n_points):
        out = orig(key, pred_cloud, partial_cloud, n_points)
        cloud = jnp.concatenate([partial_cloud, pred_cloud], axis=1)
        valid = jnp.sum(cloud, axis=-1) != 0.0
        g = jax.vmap(lambda k: jax.random.gumbel(k, valid.shape[1:]))(
            jax.random.split(key, cloud.shape[0]))
        _, idx = jax.lax.top_k(jnp.where(valid, 0.0, -jnp.inf) + g, n_points)
        for name, v in (("gumbel", g), ("cloud", cloud), ("picks", idx)):
            keep(name, v)
        return out
    return rps


@pytest.fixture(scope="module")
def model():
    """The JAX GRNet's eval and train-mode forwards on drawn variables (the
    train-mode one with its updated running statistics) and the port model
    holding the same variables."""
    rng = np.random.RandomState(5)
    partial = rng.uniform(-0.6, 0.6, (B, N_IN, 3)).astype(np.float32)
    partial[0, :10] = 0.0                     # the loaders' zero padding
    rngs = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}
    out = dict(partial=partial)
    mp = pytest.MonkeyPatch()
    try:
        for train in (False, True):
            jm = jax_grnet.GRNet(n_sampling_points=N_SAMP,
                                 gridding_scale=S_MODEL, train=train)
            if not train:
                variables = eval_variables = draw(jax.eval_shape(jm.init, rngs,
                                                jnp.asarray(partial)), rng)
            else:
                variables = jax.tree_util.tree_map(np.copy, variables)
                for i in range(4):
                    conv = variables["params"][f"_ConvBlock_{i}"]["Conv_0"]
                    conv["bias"] = np.zeros_like(conv["bias"])
                out["train_variables"] = variables
            kept = _Kept()
            mp.setattr(jax_grnet, "random_point_sampling",
                       recording_sampler(kept.keep))
            res = jax.jit(lambda v, x: jm.apply(
                v, x, rngs={"sample": jax.random.PRNGKey(2 + train)},
                mutable=["batch_stats"] if train else False))(
                    variables, jnp.asarray(partial))
            (sparse, dense), upd = res if train else (res, None)
            rec = kept.take()
            out["train" if train else "eval"] = dict(
                sparse=np.asarray(sparse), dense=np.asarray(dense),
                bstats=None if upd is None else jax.tree_util.tree_map(
                    np.asarray, upd["batch_stats"]),
                idx=rec["picks"][0], cloud=rec["cloud"][0])
    finally:
        mp.undo()
    out["variables"] = jax.tree_util.tree_map(np.asarray, eval_variables)
    out["sd"] = state_dict_from_jax(out["variables"], model_type="GRNet")
    out["port"] = port_grnet.GRNet(N_SAMP, S_MODEL)
    out["port"].load_state_dict(out["sd"], strict=True)
    return out


def test_forward_matches_jax_eval(model):
    """Eval mode on the JAX package's picks: the candidates (partial and
    gridding reverse cloud), sparse and dense elementwise; the JAX picks
    are the rows of its output."""
    j = model["eval"]
    np.testing.assert_array_equal(
        np.take_along_axis(j["cloud"], j["idx"][..., None], 1), j["sparse"])
    port = model["port"].eval()
    partial = torch.from_numpy(model["partial"])
    with torch.no_grad():
        cand, _ = port.candidates(partial)
        sparse, dense = port_models.complete(
            port, partial, sample_idx=torch.from_numpy(j["idx"]))
    close(cand.numpy(), j["cloud"])
    valid = (np.abs(j["cloud"][:, N_IN:]).sum(-1) > 0).sum(1)
    assert (valid > 100).all()                 # a cloud, not a few points
    assert sparse.shape == (B, N_SAMP, 3) and dense.shape == (B, 8 * N_SAMP, 3)
    close(sparse.numpy(), j["sparse"])
    close(dense.numpy(), j["dense"])
    offsets = j["dense"] - np.repeat(j["sparse"], 8, 1)
    assert np.abs(offsets).max() > 0.1         # the MLP's offsets matter


def test_forward_matches_jax_train(model):
    """Train mode on the JAX package's picks: sparse and dense elementwise,
    and every BatchNorm's new running mean and (biased) variance."""
    j = model["train"]
    sd = state_dict_from_jax(model["train_variables"], model_type="GRNet")
    port = port_grnet.GRNet(N_SAMP, S_MODEL)
    port.load_state_dict(sd, strict=True)
    port.train()
    with torch.no_grad():
        sparse, dense = port(torch.from_numpy(model["partial"]),
                             sample_idx=torch.from_numpy(j["idx"]))
    close(sparse.numpy(), j["sparse"])
    close(dense.numpy(), j["dense"])
    want = state_dict_from_jax({"params": model["train_variables"]["params"],
                                "batch_stats": j["bstats"]},
                               model_type="GRNet")
    n = 0
    for key, buf in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            close(buf.numpy(), want[key].numpy(), atol=1e-6)
            assert not torch.equal(buf, sd[key]), key
            n += 1
    assert n == 16


def test_weights_both_ways_match_jax(model):
    """``state_dict_from_jax`` equals the JAX package's export of the same
    variables tensor for tensor; ``reference_state_dict`` of the port model
    goes back through the JAX package's converter (strict) to the same
    variables; it loads strictly into a fresh port model."""
    export = ti.export_grnet_state_dict(model["variables"])
    sd = model["sd"]
    assert set(export) == set(sd)
    for key in export:
        np.testing.assert_array_equal(sd[key].numpy(), export[key],
                                      err_msg=key)
    ref = reference_state_dict(model["port"])
    assert set(ref) == set(sd)
    back = ti.convert_grnet_state_dict({k: v.numpy() for k, v in ref.items()},
                                       strict=True)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           model["variables"])
    fresh = port_grnet.GRNet(N_SAMP, S_MODEL)
    fresh.load_state_dict(ref, strict=True)
    for key, v in fresh.state_dict().items():
        assert torch.equal(v, model["port"].state_dict()[key]), key


def test_define_g_builds_grnet_with_the_jax_initialisation():
    """``define_G`` on grnet.yaml: GRNet at scale 64 with 2048 sampled
    points and 76,707,626 parameters, the same from the same seed. Each
    kernel's spread follows the JAX package's initialisation (kaiming on
    in_channels x taps for Conv3d and ConvTranspose3d alike, Linear
    0.01), within 10% of the std the JAX package's own draw gives that
    kernel; BatchNorm scales 1, biases 0."""
    cfg = cfg_from_file(shipped_yaml("grnet"))
    a = port_models.define_G(cfg, device="cpu")
    b = port_models.define_G(cfg, device="cpu")
    assert type(a).__name__ == "GRNet" and not a.training
    assert a.gridding_scale == 64 and a.n_sampling_points == 2048
    assert sum(p.numel() for p in a.parameters()) == 76_707_626
    sa, sb = a.state_dict(), b.state_dict()
    for k, v in sa.items():
        assert torch.equal(v, sb[k]), k
    jm = jax_grnet.GRNet(n_sampling_points=16, gridding_scale=16, train=False)
    jv = jax.jit(jm.init)({"params": jax.random.PRNGKey(0),
                           "sample": jax.random.PRNGKey(1)},
                          jnp.zeros((1, 8, 3)))
    want = {k: v for k, v in ti.export_grnet_state_dict(
        jax.tree_util.tree_map(np.asarray, jv)).items()}
    for key, v in sa.items():
        if key.endswith(".weight") and v.dim() > 1 and key not in (
                "fc5.0.weight", "fc6.0.weight"):     # scale-dependent width
            ratio = float(v.std()) / float(np.std(want[key]))
            assert 0.9 < ratio < 1.1, (key, ratio)
        elif key.endswith(".weight") and v.dim() == 1:
            assert torch.equal(v, torch.ones_like(v)), key
        elif key.endswith(".bias"):
            assert not v.any(), key
    assert abs(float(sa["fc5.0.weight"].std()) / 0.01 - 1) < 0.01
