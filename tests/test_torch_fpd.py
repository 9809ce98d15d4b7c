"""The port's FPD (sparenet_tpu_torch/frechet/, the FPD CLI) against the JAX
package's sparenet_tpu/frechet/ on the CPU.

The classifier is the canonical one (sparenet_tpu/data/fpd_cls_canonical.npz
and the port's converted copy); clouds are numpy-seeded at 512 points. The
JAX forward is jitted once for the module. scipy's sqrtm of the real
1808 x 1808 product takes seconds of a core, so the Frechet distance is
held to the JAX function's at small dimensions, and the CLI's plumbing with
the distance replaced by a cheap one (the chip runs the real thing).
"""

import hashlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch
from flax import traverse_util

from sparenet_tpu.frechet import fpd as jax_fpd
from sparenet_tpu.frechet import pointnet as jax_pointnet
from sparenet_tpu.frechet.train_classifier import train_classifier as jax_train
from sparenet_tpu_torch import test_fpd as cli
from sparenet_tpu_torch.data.io import IO
from sparenet_tpu_torch.frechet import (PointNetCls, calculate_frechet_distance,
                                        get_activations, load_torch_state,
                                        train_classifier)
from sparenet_tpu_torch.frechet import fpd as port_fpd
from sparenet_tpu_torch.utils.weights import fpd_state_dict_from_jax

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NPZ = os.path.join(ROOT, "sparenet_tpu", "data", "fpd_cls_canonical.npz")
ATOL, RTOL = 3e-6, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def canonical():
    """The JAX canonical variables (nested), their flat npz and the port's
    classifier on the CPU."""
    flat = dict(np.load(JAX_NPZ))
    tree = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat.items()})
    return dict(flat=flat, tree=tree,
                port=port_fpd.load_classifier(port_fpd.CANONICAL, device="cpu"))


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.RandomState(0)
    a = (rng.rand(10, 512, 3) - 0.5).astype(np.float32)
    b = (0.8 * rng.rand(10, 512, 3) - 0.3).astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def jax_apply(canonical):
    """The JAX classifier's (logits, trans, actv), jitted once."""
    model = jax_pointnet.PointNetCls(k=16, train=False)
    return jax.jit(lambda pc: model.apply(canonical["tree"], pc))


def test_canonical_copy_is_the_jax_classifier(canonical):
    """The port's npz equals fpd_state_dict_from_jax of the JAX npz bit for
    bit, and the JAX package's load_torch_state of it gives back the JAX
    npz's variables bit for bit (the round trip through both converters)."""
    want = fpd_state_dict_from_jax(canonical["flat"])
    with np.load(port_fpd.CANONICAL) as f:
        got = {k: f[k] for k in f.files}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.numpy().dtype and got[k].tobytes() == v.numpy().tobytes(), k
    back = traverse_util.flatten_dict(jax_pointnet.load_torch_state(got), sep="/")
    assert set(back) == set(canonical["flat"])
    for k, v in back.items():
        assert np.asarray(v).tobytes() == canonical["flat"][k].tobytes(), k
    # the names are the reference's: a cls_model state_dict loads strictly
    load_torch_state({k: torch.from_numpy(v) for k, v in got.items()})


def test_classifier_matches_jax(canonical, clouds, jax_apply):
    """logits, trans and the 1808-d activations: atol 3e-6, rtol 1e-4."""
    pc = clouds[0][:4]
    want = jax_apply(jnp.asarray(pc))
    with torch.no_grad():
        got = canonical["port"](torch.from_numpy(pc))
    assert got[2].shape == (4, 1808)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_activation_statistics_match_jax(canonical, clouds, jax_apply):
    """get_activations drops the last partial batch (10 clouds at batch 4
    -> 8) and returns float64; mean and covariance against the JAX forward's
    activations of the same 8 clouds through the JAX statistics: mean atol
    3e-6 rtol 1e-4, covariance atol 1e-5 (products of activations of
    magnitude up to ~10)."""
    act = get_activations(clouds[0], canonical["port"], batch_size=4,
                          device="cpu")
    assert act.shape == (8, 1808) and act.dtype == np.float64
    want_act = np.asarray(jax_apply(jnp.asarray(clouds[0][:8]))[2], np.float64)
    np.testing.assert_allclose(act, want_act, atol=ATOL, rtol=RTOL)
    mu, sigma = port_fpd.calculate_activation_statistics(
        clouds[0], canonical["port"], batch_size=4, device="cpu")
    np.testing.assert_allclose(mu, want_act.mean(0), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(sigma, np.cov(want_act, rowvar=False), atol=1e-5)


def _gaussians(rng, d, rank):
    x, y = rng.randn(rank, d), rng.randn(rank, d) * 0.7 + 0.2
    return (x.mean(0), np.cov(x, rowvar=False), y.mean(0),
            np.cov(y, rowvar=False))


@pytest.mark.parametrize("rank", [40, 12], ids=["full", "singular"])
def test_frechet_distance_equals_jax(rank):
    """The port's calculate_frechet_distance equals the JAX function's on
    the same float64 statistics (d = 24; full rank, and rank 11 where sqrtm
    returns a complex root with a near-zero imaginary part)."""
    stats = _gaussians(np.random.RandomState(rank), 24, rank)
    assert calculate_frechet_distance(*stats) == jax_fpd.calculate_frechet_distance(*stats)


def test_frechet_distance_retry_and_imaginary_check(monkeypatch):
    """Where the first root is not finite both retry with eps on the
    diagonals (the same value); a root whose diagonal has an imaginary part
    above 1e-3 raises in both."""
    stats = _gaussians(np.random.RandomState(1), 16, 30)
    real_sqrtm = scipy.linalg.sqrtm
    calls = []

    def answer(out, kw):
        """The JAX package asks with disp=False for (root, error); the port
        asks for the root alone."""
        return (out, 0.0) if kw.get("disp") is False else out

    def first_nan(m, **kw):
        calls.append(m)
        if len(calls) % 2 == 1:
            return answer(np.full_like(m, np.nan), kw)
        return real_sqrtm(m)
    monkeypatch.setattr(scipy.linalg, "sqrtm", first_nan)
    got = calculate_frechet_distance(*stats, eps=1e-3)
    want = jax_fpd.calculate_frechet_distance(*stats, eps=1e-3)
    assert got == want and len(calls) == 4
    np.testing.assert_array_equal(calls[1], calls[3])     # the offset product
    monkeypatch.setattr(scipy.linalg, "sqrtm",
                        lambda m, **kw: answer(m + 0.5j, kw))
    for fn in (calculate_frechet_distance, jax_fpd.calculate_frechet_distance):
        with pytest.raises(ValueError, match="Imaginary component"):
            fn(*stats)


class _JitInit:
    """PointNetCls with its ``init`` jitted: the JAX train_classifier inits
    eagerly, which compiles op by op (about 10 s here); jitted, the same
    variables bit for bit, and the test's own init of the same model is a
    cache hit."""
    _inits: dict = {}

    def __init__(self, **kw):
        self.module = jax_pointnet.PointNetCls(**kw)
        key = tuple(sorted(kw.items()))
        if key not in self._inits:
            self._inits[key] = jax.jit(self.module.init)
        self.init = self._inits[key]
        self.apply = self.module.apply


def test_train_classifier_step_matches_jax(monkeypatch):
    """One step (4 items, batch 4, 128 of 200 points each) from the JAX
    package's own initialisation: the same RandomState draws, Adam at 1e-3,
    cross-entropy plus 1e-3 times the STN term. Adam's first step moves a
    parameter by lr g / (|g| + 1e-8), lr times the sign of g for any g well
    above 1e-8: where the exact gradient is 0 (the biases a train-mode
    BatchNorm centres) or within rounding of it, the sign is the rounding's.
    The JAX step's gradients lie 0.3-0.7% (relative L2 a leaf) from an f64
    evaluation of the same step, the port's f32 ones within 6e-5 of it
    (train-mode BatchNorm over 4 samples amplifies rounding), so gradients
    near 0 take either sign. So: every updated parameter within 2 lr;
    outside the centred biases, all but 0.5% of them within atol 1e-5 (1%
    of the step; reading: 2153 of 1600652, 0.13%, took the other sign); the
    running statistics (the variance biased, as flax stores it) rtol 1e-4,
    atol 1e-6."""
    lr = 1e-3
    rng = np.random.RandomState(3)
    data = [("t", i % 3, f"m{i}", {"gtcloud": (rng.rand(200, 3) - 0.5).astype(
        np.float32) * (1.0 + 0.3 * i)}) for i in range(4)]
    monkeypatch.setattr(sys.modules[jax_train.__module__], "PointNetCls",
                        _JitInit)
    init = _JitInit(k=3, train=True).init(
        {"params": jax.random.PRNGKey(5)}, jnp.zeros((2, 128, 3), jnp.float32))
    want = jax_train(data, num_classes=3, n_points=128, epochs=1,
                     batch_size=4, seed=5, lr=lr)
    flat = lambda v: traverse_util.flatten_dict(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, v), sep="/")
    sd0 = fpd_state_dict_from_jax(flat(init))
    got = train_classifier(data, num_classes=3, n_points=128, epochs=1,
                           batch_size=4, seed=5, lr=lr, init_state=sd0,
                           device="cpu")
    want_sd = fpd_state_dict_from_jax(flat(want))
    centred = {f"{p}.bias" for p in ("feat.stn.conv1", "feat.stn.conv2",
                                     "feat.stn.conv3", "feat.stn.fc1",
                                     "feat.stn.fc2", "feat.conv1", "feat.conv2",
                                     "feat.conv3", "fc1", "fc2")}
    n_stats = n_off = n_all = 0
    for name, v in got.state_dict().items():
        g, w = v.numpy(), want_sd[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=name)
            n_stats += 1
        elif not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * lr, err_msg=name)
            assert not np.array_equal(g, sd0[name].numpy()), name   # moved
            if name not in centred:
                n_off += int((np.abs(g - w) > 1e-5).sum())
                n_all += g.size
    assert n_stats == 20
    assert n_off <= 5e-3 * n_all, (n_off, n_all)


def test_cli_groups_reads_and_reports(tmp_path, canonical, monkeypatch):
    """The FPD CLI on a tree of 2 models a category (the list's first), 256
    points read back through IO.get, the distance replaced by a cheap one
    (|mu1 - mu2|^2 + the first covariance's trace): the nine values equal
    that function of the statistics of each category's activations and of
    all of them, and the last line is their JSON."""
    rng = np.random.RandomState(4)
    with open(cli.FPD_LIST) as f:
        models = f.read().splitlines()
    sub = [m for tax in cli.TAXONOMY2LABEL for m in
           [x for x in models if x.startswith(tax)][:2]]
    (tmp_path / "list.txt").write_text("\n".join(sub))
    clouds = {}
    for m in sub:
        for d in ("real/complete", "fake"):
            p = tmp_path / d / f"{m}.pcd"
            p.parent.mkdir(parents=True, exist_ok=True)
            clouds[d, m] = (rng.rand(300, 3) - 0.5).astype(np.float32)
            IO.put(str(p), clouds[d, m])

    def cheap(m1, s1, m2, s2):
        return float(((m1 - m2) ** 2).sum() + np.trace(s1))
    monkeypatch.setattr(cli, "calculate_frechet_distance", cheap)
    line = cli.main(["--data_dir", str(tmp_path / "real"), "--fake_dir",
                     str(tmp_path / "fake"), "--list_path",
                     str(tmp_path / "list.txt"), "--num_points", "256",
                     "--batch_size", "2", "--jobs", "1", "--device", "cpu",
                     "--log_dir", str(tmp_path / "log")])

    def stats(d, ms):
        act = get_activations(np.stack([clouds[d, m][:256] for m in ms]),
                              canonical["port"], 2, device="cpu")
        return act.mean(0), np.cov(act, rowvar=False)
    for tax in cli.TAXONOMY2LABEL:
        ms = [m for m in sub if m.startswith(tax)]
        want = cheap(*stats("fake", ms), *stats("real/complete", ms))
        np.testing.assert_allclose(line["fpd_per_category"][tax], want, rtol=1e-12)
    order = sorted(sub, key=lambda m: cli.TAXONOMY2LABEL[m.split("/")[0]])
    np.testing.assert_allclose(
        line["fpd_all"], cheap(*stats("fake", order), *stats("real/complete", order)),
        rtol=1e-12)
    assert line["fpd_category_mean"] == pytest.approx(
        np.mean(list(line["fpd_per_category"].values())), rel=1e-12)
    assert set(line["seconds"]) == {"read", "activations", "statistics", "sqrtm"}
    assert json.loads(json.dumps(line)) == line


def test_canonical_npz_is_pinned():
    """README.md records the port's canonical npz by sha256, beside the JAX
    file's (docs/FPD_ARTIFACT.md records that one)."""
    digests = []
    for path in (port_fpd.CANONICAL, JAX_NPZ):
        with open(path, "rb") as f:
            digests.append(hashlib.sha256(f.read()).hexdigest())
    with open(os.path.join(ROOT, "README.md")) as f:
        text = f.read()
    assert all(d in text for d in digests)


def test_fpd_needs_a_card_unless_asked_for_the_cpu(monkeypatch, clouds):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_activations(clouds[0], port_fpd.CANONICAL, batch_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_classifier([], epochs=0)
    assert isinstance(port_fpd.load_classifier(device="cpu"), PointNetCls)
