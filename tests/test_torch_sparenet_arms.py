"""SpareNet's other arms in the port against the JAX package, on the CPU at
toy size: the Pointfeat encoder (PointNetfeat with SE), the no_share and
no_use decoders, the EdgeRes refine, the SIREN GridDecoder, remat, and the
weight rules of every (encode, use_adain) combination.

B=2, 64 -> 256 points, 4 primitives of 64, bottleneck and hide 128, SE on
(the Residualnet extractor keeps its 256/256/512/1024 stage widths). The
variables are drawn well-conditioned on the JAX side (kernels normal with
std 1/sqrt(fan_in), BatchNorm scales 1 + 0.1 normal, biases 0.1 normal,
running statistics jittered; the reference's initialisation folds every
primitive to within 5e-5 of one point) and reach the port through
``utils/weights.py``. Each JAX module is jitted once for the file: the
generator of a combination is its encoder, decoder and refine applied in
turn (their variables are the generator's subtrees). Parity contract
(tests/test_forward_parity.py): deterministic stages elementwise within
atol 3e-6 and rtol 1e-4; a refine anchored on the JAX coarse cloud and MDS
picks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.models import layers as jax_layers
from sparenet_tpu.models import sparenet as jax_model_mod
from sparenet_tpu.models.sparenet import (SpareNetDecode as JaxDecode,
                                          SpareNetEncode as JaxEncode,
                                          SpareNetRefine as JaxRefine)
from sparenet_tpu.ops.knn import get_graph_feature as jax_get_graph_feature
from sparenet_tpu.ops.knn import knn_idx as jax_knn
from sparenet_tpu.utils import torch_import as ti
from sparenet_tpu_torch import models as port_models
from sparenet_tpu_torch.configs import CONFIG_DIR, cfg_from_file
from sparenet_tpu_torch.models import layers as port_layers
from sparenet_tpu_torch.models.sparenet import flagged_base
from sparenet_tpu_torch.ops import _lib, knn
from sparenet_tpu_torch.utils import weights

jax.config.update("jax_platforms", "cpu")

B, N_IN, N_OUT, P, D = 2, 64, 256, 4, 128
S = N_OUT // P
ATOL, RTOL = 3e-6, 1e-4
CONFIG = dict(num_points=N_OUT, n_primitives=P, bottleneck_size=D,
              hide_size=D, use_selayer=True)
ENCODERS, DECODERS = ("Residualnet", "Pointfeat"), ("share", "no_share", "no_use")
COMBOS = [(e, a) for e in ENCODERS for a in DECODERS]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def draw(shapes, rng):
    """Well-conditioned variables of the given shape tree (see the module
    docstring)."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0.0, s.shape[-2] ** -0.5, s.shape)
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


def close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _init(module, rng, *args):
    shapes = jax.eval_shape(module.init, {"params": jax.random.PRNGKey(0)},
                            *map(jnp.asarray, args))
    return draw(shapes, rng)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def parts():
    """The JAX encoders, decoders and refine on drawn variables: per
    encoder its style, per decoder its coarse cloud from each style, the
    refine's output on one coarse cloud with the picks it made."""
    rng = np.random.RandomState(0)
    partial = (rng.rand(B, N_IN, 3) - 0.5).astype(np.float32)
    enc, dec, style, coarse = {}, {}, {}, {}
    for e in ENCODERS:
        m = JaxEncode(bottleneck_size=D, hide_size=D, use_selayer=True,
                      encode=e, train=False)
        enc[e] = _init(m, rng, partial)
        style[e] = np.asarray(jax.jit(m.apply)(enc[e], jnp.asarray(partial)))
    for a in DECODERS:
        m = JaxDecode(num_points=N_OUT, n_primitives=P, bottleneck_size=D,
                      use_adain=a, use_selayer=True, train=False)
        dec[a] = _init(m, rng, style["Pointfeat"])
        fn = jax.jit(m.apply)
        for e in ENCODERS:
            coarse[e, a] = np.asarray(fn(dec[a], jnp.asarray(style[e])))
    return dict(rng=rng, partial=partial, enc=enc, dec=dec, style=style,
                coarse=coarse)


def generator_variables(parts, e, a, refine):
    return {col: {"encoder": parts["enc"][e][col],
                  "decoder": parts["dec"][a][col], "refine": refine[col]}
            for col in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def refine_vars(parts):
    m = JaxRefine(num_points=N_OUT, n_primitives=P, use_selayer=True,
                  train=False)
    return _init(m, parts["rng"], parts["coarse"]["Pointfeat", "share"],
                 parts["partial"])


def port_generator(variables, e, a, **kw):
    sd = weights.state_dict_from_jax(variables, n_primitives=P, use_adain=a,
                                     encode=e, **kw)
    model = port_models.build_generator(device="cpu", **CONFIG, use_adain=a,
                                        encode=e, **kw)
    model.load_state_dict(sd, strict=True)
    return model, sd


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,a", COMBOS)
def test_netG_rules_match_jax_export(parts, refine_vars, e, a):
    """Key for key and bit for bit equal to export_netG_state_dict of the
    same configuration (its per-primitive BatchNorm step counts under the
    unexpanded template key, the port's one a primitive: ROADMAP section
    3), loaded strictly; the port's reference_state_dict carried back by the
    JAX package's convert_netG_state_dict gives the variables bit for
    bit."""
    v = generator_variables(parts, e, a, refine_vars)
    model, sd = port_generator(v, e, a)
    ref = ti.export_netG_state_dict(v, use_adain=a, encode=e, use_selayer=True,
                                    n_primitives=P)
    template = {k for k in ref if "{p}" in k}
    expanded = {k.format(p=p) for k in template for p in range(P)}
    assert set(sd) == (set(ref) - template) | expanded
    for k, want in ref.items():
        if k not in template:
            assert sd[k].numpy().tobytes() == np.ascontiguousarray(want).tobytes(), k
    back = weights.reference_state_dict(model)
    assert set(back) == set(sd)
    flat = ti.convert_netG_state_dict({k: t.numpy() for k, t in back.items()},
                                      use_adain=a, encode=e, n_primitives=P)
    for (path, got), want in zip(
            jax.tree_util.tree_leaves_with_path(flat),
            jax.tree_util.tree_leaves(v)):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path


# ---------------------------------------------------------------------------
# the arms' forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,a", COMBOS)
def test_generator_forward_matches_jax(parts, refine_vars, e, a):
    """The port's generator of each combination (its own forward, plain
    versions): coarse elementwise against the JAX encoder and decoder
    (atol 3e-6, rtol 1e-4); middle and refine of shape [B, 256, 3], finite
    (the shared refine pass is held anchored below and in
    test_torch_port_forward.py)."""
    model, _ = port_generator(generator_variables(parts, e, a, refine_vars),
                              e, a)
    with torch.no_grad():
        outs = port_models.complete(model, torch.from_numpy(parts["partial"]))
    close(outs[0].numpy(), parts["coarse"][e, a])
    for o in outs[1:3]:
        assert o.shape == (B, N_OUT, 3) and bool(torch.isfinite(o).all())


@pytest.fixture
def graphs(monkeypatch):
    """The kNN graphs the JAX package's EdgeRes builds (recorded in call
    order by a stand-in for its get_graph_feature, taken out of the jitted
    program by jax.debug.callback), and a stand-in for the port's knn_idx
    that replays them: EdgeRes's features at toy size meet kNN near-ties
    (equal distances within rounding) that the two packages' f32 rounding
    breaks apart, and a flipped neighbour moves a point's max."""
    seen = []
    real = jax_layers.get_graph_feature

    def recording(x, k=20, idx=None):
        idx = jax_knn(x, k=k)
        jax.debug.callback(lambda i: seen.append(np.array(i)), idx,
                           ordered=True)
        return real(x, k, idx)
    monkeypatch.setattr(jax_layers, "get_graph_feature", recording)

    def replay(feat, k, packed=False):
        return torch.from_numpy(seen.pop(0))
    return seen, lambda: monkeypatch.setattr(knn, "knn_idx", replay)


def test_edgeres_refine_anchored_matches_jax(parts, graphs, monkeypatch):
    """SpareNetRefine(edgeres=True) fed the JAX coarse cloud (Pointfeat +
    no_use) and the MDS picks of the JAX refine (recorded by a stand-in for
    its minimum_density_sample), replaying the JAX package's seven kNN
    graphs (``graphs``): the refined cloud within atol 3e-6, rtol 1e-4 of
    the JAX refine's (the PointNetRes refine is held so in
    test_torch_port_forward.py)."""
    cloud = parts["coarse"]["Pointfeat", "no_use"]
    picks = []
    real_mds = jax_model_mod.minimum_density_sample

    def recording(*a, **kw):
        idx = real_mds(*a, **kw)
        jax.debug.callback(lambda i: picks.append(np.array(i)), idx,
                           ordered=True)
        return idx
    monkeypatch.setattr(jax_model_mod, "minimum_density_sample", recording)
    jm = JaxRefine(num_points=N_OUT, n_primitives=P, use_selayer=True,
                   edgeres=True, train=False)
    v = _init(jm, parts["rng"], cloud, parts["partial"])
    want, _ = jax.jit(jm.apply)(v, jnp.asarray(cloud), jnp.asarray(parts["partial"]))
    jax.effects_barrier()
    assert len(graphs[0]) == 7 and len(picks) == 1
    graphs[1]()
    rules = weights.edgeres_rules(("EdgeRes_0",), "residual")
    assert len(rules.entries) == 7 + 6 * 4 + 5 * 2
    port = port_models.SpareNetRefine(N_OUT, P, use_selayer=True, edgeres=True)
    port.load_state_dict(weights.module_state_dict_from_jax(v, rules),
                         strict=True)
    port.eval()
    with torch.no_grad():
        base = flagged_base(torch.from_numpy(cloud.copy()),
                            torch.from_numpy(parts["partial"]))
        got = port.finish(base, torch.from_numpy(picks[0]))
    close(got.numpy(), want)


def _edgeres_case(train):
    rng = np.random.RandomState(5)
    x = np.concatenate([rng.rand(B, 96, 3) - 0.5,
                        (rng.rand(B, 96, 1) < 0.3)], -1).astype(np.float32)
    jm = jax_layers.EdgeRes(use_selayer=True, train=train)
    v = _init(jm, rng, x)
    # the stage after concat(global max, point features): its center rows
    # of the global feature at 1/8 scale, else a per-cloud offset 100 times
    # the spread of some channels meets train-mode BatchNorm's f32 variance
    # E[x^2] - E[x]^2 over 2 clouds (as test_torch_port_train.py scales the
    # refiner's)
    v["params"]["Conv2d1x1_3"]["kernel"][1088:2112] *= 0.125
    pm = port_layers.EdgeRes(use_selayer=True)
    pm.load_state_dict(weights.module_state_dict_from_jax(
        v, weights.edgeres_rules((), "")), strict=True)
    return rng, x, jm, v, pm.train(train)


def test_edgeres_matches_flax_in_train_mode(monkeypatch):
    """EdgeRes alone in train mode (BatchNorm2d over batch, points and
    edges) at B=2, 96 points, both packages on the kNN graphs of the JAX
    package's forward (``graphs``): every new running statistic within
    atol 1e-6 / rtol 1e-4; the output within atol 3e-5 / rtol 1e-4, since
    seven train-mode BatchNorms in f32 (flax's variance E[x^2] - E[x]^2)
    leave the JAX package's output 1.4e-5 from an f64 evaluation of the
    same module (readings; the port's 4.7e-6). The gradient of a
    squared-error loss, along one seeded unit direction over each stage's
    leaves, within 2% of the stage's gradient norm of central differences
    (step 1e-2) of the JAX package's jitted loss on those graphs. Not against the
    JAX package's jitted gradient, which is wrong for this module on the
    CPU (ROADMAP section 3): at f64 it parts from its eager gradient by 93%
    of a leaf's norm, and central differences agree with the eager one
    (and the port's) to 1e-7."""
    rng, x, jm, v, pm = _edgeres_case(True)
    tgt = rng.rand(B, 96, 3).astype(np.float32)
    # one jitted program: the JAX package's own kNN graphs out, or given
    # graphs in (``use``), for the forward and the loss's differences
    state: dict = {}

    def graph_feature(f, k=20, idx=None):
        own = jax_knn(f, k=k)
        i = len(state["own"])
        state["own"].append(own)
        return jax_get_graph_feature(
            f, k, jnp.where(state["use"], state["graphs"][i], own))
    monkeypatch.setattr(jax_layers, "get_graph_feature", graph_feature)

    @jax.jit
    def run(p, graphs, use):
        state.update(own=[], graphs=graphs, use=use)
        o, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), mutable=["batch_stats"])
        return jnp.mean((o - tgt) ** 2), o, upd, jnp.stack(state["own"])

    _, out, upd, own = run(v["params"], jnp.zeros((7, B, 96, 8), jnp.int32),
                           False)
    replayed = iter(np.asarray(own))
    monkeypatch.setattr(knn, "knn_idx", lambda feat, k, packed=False:
                        torch.from_numpy(next(replayed)))
    got = pm(torch.from_numpy(x))
    ((got - torch.from_numpy(tgt)) ** 2).mean().backward()
    close(got.detach().numpy(), out, atol=3e-5)
    rules = weights.edgeres_rules((), "")
    want = weights.module_state_dict_from_jax(
        {"params": v["params"], "batch_stats": _np(upd["batch_stats"])}, rules)
    n = 0
    for name, buf in pm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            close(buf.numpy(), want[name].numpy(), atol=1e-6)
            n += 1
    assert n == 12
    # one seeded unit direction over each stage's leaves (its conv, its
    # BatchNorm and its SE), carried to the port's layout by the rules
    params = dict(pm.named_parameters())
    name_of = {tuple(fpath): tkey for col, fpath, tkey, _, _ in rules.entries
               if col == "params"}
    dirs = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(v["params"]):
        name = name_of[tuple(q.key for q in path)]
        if name != "bn3.bias":      # exactly 0: the next BatchNorm removes it
            dirs[path] = (name, rng.randn(*leaf.shape).astype(np.float32))
    u_port = weights.module_state_dict_from_jax(
        {"params": jax.tree_util.tree_map_with_path(
            lambda q, a: dirs[q][1] if q in dirs else np.zeros_like(a),
            v["params"]), "batch_stats": v["batch_stats"]}, rules)
    stage = lambda name: name.split(".")[0][-1]  # noqa: E731
    groups: dict = {}
    for path, (name, u) in dirs.items():
        key = stage(name) if name[:2] in ("co", "bn", "se") else name
        groups.setdefault(key, []).append(path)
    assert len(groups) == 7
    for key, paths in groups.items():
        norm = np.sqrt(sum(float((dirs[p][1] ** 2).sum()) for p in paths))

        def shift(h):
            return jax.tree_util.tree_map_with_path(
                lambda q, a: a + h * dirs[q][1] / norm if q in paths else a,
                v["params"])
        fd = (float(run(shift(1e-2), own, True)[0])
              - float(run(shift(-1e-2), own, True)[0])) / 2e-2
        proj = gnorm = 0.0
        for p in paths:
            name = dirs[p][0]
            g = params[name].grad
            proj += float((g * u_port[name]).sum()) / norm
            gnorm += float((g * g).sum())
        assert abs(proj - fd) <= 0.02 * gnorm ** 0.5, (key, proj, fd)


def test_siren_decoder_matches_flax():
    """GridDecoderStack(use_sine=True), one primitive, against the JAX
    GridDecoder(use_sine=True) on drawn weights and seeded AdaIN parameters
    (seven sizes, the last three unused): [B, S, 3], no tanh, atol 3e-6 /
    rtol 1e-4; the reference names of the stack's layers and AdaIN
    buffers; the port's own initialisation inside the SIREN bounds."""
    rng = np.random.RandomState(6)
    bsz = 64
    grid = (rng.rand(S, 2) * 2 - 1).astype(np.float32)
    ap = (rng.randn(B, jax_layers.num_adain_params(bsz, True)) * 0.5 + 1.0
          ).astype(np.float32)
    assert port_layers.num_adain_params(bsz, True) == ap.shape[1]
    assert (port_layers.grid_decoder_adain_sizes(bsz, True)
            == jax_layers.grid_decoder_adain_sizes(bsz, True))
    jm = jax_layers.GridDecoder(bottleneck_size=bsz, use_sine=True, train=False)
    xb = np.broadcast_to(grid, (B, S, 2))
    v = _init(jm, rng, xb, ap)
    want = jax.jit(jm.apply)(v, jnp.asarray(xb), jnp.asarray(ap))
    pm = port_layers.GridDecoderStack(1, bsz, use_sine=True)
    ref = weights.module_state_dict_from_jax(
        v, weights.sine_decoder_rules(troot="0.dec"))
    pm.load_state_dict(ref, strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(grid), torch.from_numpy(ap))
    assert got.shape == (1, B, S, 3)
    close(got[0].numpy(), want)
    assert set(pm.reference_state("")) == set(ref) | {
        f"0.dec.{n}.running_{s}" for n in
        ("linear1.adain", "linear2.adain", "linear3.adain", "linear4.adain",
         "adain1", "adain2", "adain3") for s in ("mean", "var")}
    fresh = port_layers.GridDecoderStack(2, bsz, use_sine=True)
    port_layers.init_weights(fresh, torch.Generator().manual_seed(0))
    bounds = (0.5, (6 / bsz) ** 0.5 / 30, (6 / (bsz // 2)) ** 0.5 / 30,
              (6 / (bsz // 4)) ** 0.5 / 30)
    for i, bound in enumerate(bounds, 1):
        w = getattr(fresh, f"linear{i}").linear.weight
        assert float(w.abs().max()) <= bound < 1.1 * float(w.abs().max())
    assert float(fresh.linear5.weight.abs().max()) <= (6 / bsz) ** 0.5 / 30


# ---------------------------------------------------------------------------
# train mode and remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", ["Pointfeat", "no_share", "no_use"])
def test_arm_train_mode_matches_flax(parts, arm):
    """The Pointfeat encoder and the no_share and no_use decoders in train
    mode (batch statistics, SE on) against flax at B=8 (at B=2 the
    bottleneck BatchNorm, over the samples alone, divides f32 rounding by a
    spread of two values): the output elementwise (atol 3e-6, rtol 1e-4)
    and every new running mean and (biased) variance within atol 1e-5 /
    rtol 1e-4."""
    rng = np.random.RandomState(8)
    if arm == "Pointfeat":
        jm = JaxEncode(bottleneck_size=D, hide_size=D, use_selayer=True,
                       encode=arm, train=True)
        v = parts["enc"][arm]
        pts = rng.randn(8, N_IN, 3)
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
        x = (pts * rng.uniform(0.1, 0.5, (8, 1, 3))
             + rng.uniform(-0.3, 0.3, (8, 1, 3))).astype(np.float32)
        pm = port_models.SpareNetEncode(D, D, True, encode=arm)
        tree = generator_variables(parts, arm, "share",
                                   {"params": {}, "batch_stats": {}})
        key = "encoder."
    else:
        jm = JaxDecode(num_points=N_OUT, n_primitives=P, bottleneck_size=D,
                       use_adain=arm, use_selayer=True, train=True)
        v = parts["dec"][arm]
        x = np.abs(rng.randn(8, D)).astype(np.float32)
        pm = port_models.SpareNetDecode(N_OUT, P, D, True, use_adain=arm)
        tree = generator_variables(parts, "Pointfeat", arm,
                                   {"params": {}, "batch_stats": {}})
        key = "decoder."
    out, upd = jax.jit(lambda v, x: jm.apply(v, x, mutable=["batch_stats"]))(
        v, jnp.asarray(x))

    def sub_sd(tree):
        rules = weights.netG_rules(
            "share" if arm == "Pointfeat" else arm,
            arm if arm == "Pointfeat" else "Pointfeat")
        rules.entries = [r for r in rules.entries if r[2].startswith(key)]
        sd = weights.module_state_dict_from_jax(tree, rules, P)
        return {k[len(key):]: t for k, t in sd.items()}

    pm.load_state_dict(sub_sd(tree), strict=False)
    pm.train()
    got = pm(torch.from_numpy(x))
    close(got.detach().numpy(), out)
    new = dict(tree)
    new["batch_stats"] = dict(tree["batch_stats"])
    new["batch_stats"][key[:-1]] = _np(upd["batch_stats"])
    want = port_models.SpareNetEncode(D, D, True, encode=arm) if arm == "Pointfeat" \
        else port_models.SpareNetDecode(N_OUT, P, D, True, use_adain=arm)
    want.load_state_dict(sub_sd(new), strict=False)
    n = 0
    for name, buf in pm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            close(buf.numpy(), dict(want.named_buffers())[name].numpy(), atol=1e-5)
            n += 1
    assert n == (8 if arm == "Pointfeat" else 6)


def _remat_case(remat):
    rng = np.random.RandomState(7)
    partial = torch.from_numpy((rng.rand(B, N_IN, 3) - 0.5).astype(np.float32))
    gt = torch.from_numpy((rng.rand(B, 128, 3) - 0.5).astype(np.float32))
    model = port_models.build_generator(device="cpu", seed=3, **dict(
        CONFIG, num_points=128, n_primitives=2), remat=remat).train()
    _lib.reset_counts()
    c, m, r, lm = model(partial)
    loss = ((r - gt) ** 2).mean() + 0.1 * lm + ((c - gt) ** 2).mean()
    loss.backward()
    return model, float(loss), dict(_lib.PLAIN_CALLS)


def test_remat_gradients_equal_the_plain_step():
    """TPU.remat is a pure memory/time trade, as the JAX package's
    (tests/test_models.py::test_sparenet_remat_grads_exact): the same
    parameters, the same loss and every gradient bit for bit, the running
    statistics advanced once (equal to the plain step's bit for bit); the
    recompute replays the encoder's four kNN graphs (8 plain kNN calls
    against 4), and the expansion penalty and MDS are not replayed."""
    plain, l0, calls0 = _remat_case(False)
    remat, l1, calls1 = _remat_case(True)
    assert l0 == l1
    for (name, a), (_, b) in zip(plain.named_parameters(),
                                 remat.named_parameters()):
        if a.grad is None:
            assert b.grad is None, name
            continue
        assert torch.equal(a.grad, b.grad), name
    for (name, a), (_, b) in zip(plain.named_buffers(), remat.named_buffers()):
        assert torch.equal(a, b), name
    assert (calls0["knn"], calls1["knn"]) == (4, 8)
    for op in ("expansion", "mds"):
        assert calls0[op] == calls1[op] == 2, op


def test_define_g_takes_the_arms_and_remat():
    """define_G builds the configured arms and remat for training only: the
    eval forward and a forward without gradients replay nothing."""
    cfg = cfg_from_file(os.path.join(CONFIG_DIR, "sparenet.yaml"))
    cfg.NETWORK.encode, cfg.NETWORK.use_adain = "Pointfeat", "no_use"
    cfg.NETWORK.n_primitives, cfg.DATASET.n_outpoints = P, N_OUT
    cfg.TPU.remat = True
    model = port_models.define_G(cfg, device="cpu")
    assert model.remat and model.refine.remat
    assert isinstance(model.encoder.feat_extractor, port_layers.PointNetfeat)
    assert isinstance(model.decoder.decoder, port_layers.PointGenConStack)
    _lib.reset_counts()
    with torch.no_grad():
        model.train()(torch.rand(B, N_IN, 3) - 0.5)
    port_models.complete(model, torch.rand(B, N_IN, 3) - 0.5)
    assert _lib.PLAIN_CALLS["mds"] == 4 and _lib.PLAIN_CALLS["knn"] == 0
