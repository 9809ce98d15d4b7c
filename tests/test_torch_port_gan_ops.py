"""The GAN slice's modules (plain versions, on the CPU) against the JAX
package: the zero-background max splat (p2i, kernel #9), the depth renderer
and the discriminators.

Inputs are made from a seed with numpy and given to both packages as numpy
arrays. The p2i plain version is held bit for bit to the JAX package's XLA
path (``_p2i_max_forward``, which its CPU and GPU programs run), and to the
Pallas kernel in interpret mode within the kernel's own tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.models.discriminator import PatchDiscriminator as JaxPatchD
from sparenet_tpu.models.discriminator import ProjectionD as JaxProjD
from sparenet_tpu.ops.p2i import _p2i_max_forward, p2i_max_zbg as jax_zbg
from sparenet_tpu.ops.pallas.p2i_pallas import p2i_max_pallas
from sparenet_tpu.renderer import ComputeDepthMaps as JaxRenderer
from sparenet_tpu_torch import models as port_models
from sparenet_tpu_torch.models import discriminator as port_disc
from sparenet_tpu_torch.ops import _lib, p2i
from sparenet_tpu_torch.renderer import ComputeDepthMaps
from sparenet_tpu_torch.utils.weights import disc_state_dict_from_jax

jax.config.update("jax_platforms", "cpu")


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.asarray(a).dtype, copy=True))


def _splat_case(rng, b, n, h, w):
    """n points an image, some off the edges, 40 on pixel centres (exact
    ties between points at equal distance), 30 duplicated (equal values),
    features of 0 and below among them."""
    p = b * n
    pts = np.stack([rng.uniform(-4, h + 4, p), rng.uniform(-4, w + 4, p)], -1)
    pts[:40] = np.round(pts[:40])
    pts[40:70] = pts[100:130]
    f = rng.uniform(-0.3, 1.0, (p, 1))
    f[40:70] = f[100:130]
    f[:12] = 0.0
    binds = rng.randint(0, b, p)
    binds[40:70] = binds[100:130]
    return (pts.astype(np.float32), f.astype(np.float32),
            binds.astype(np.int32))


# ---------------------------------------------------------------------------
# p2i (#9): the plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [2.0, 4.5, 7.0])
def test_p2i_plain_matches_jax_xla_path(rng, radius):
    """Values and winner ids exact against _p2i_max_forward, ties and
    duplicates included; features <= 0 never win."""
    b, h, w = 3, 40, 56
    pts, f, binds = _splat_case(rng, b, 220, h, w)
    want_v, want_i = jax.jit(lambda p, f, bi: _p2i_max_forward(
        p, f, bi, jnp.zeros((b, h, w, 1)), radius))(pts, f, binds)
    got_v, got_i = p2i.p2i_max_plain(_t(pts), _t(f), _t(binds), b, h, w, radius)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    won = got_i.numpy()[got_i.numpy() >= 0]
    assert won.size and bool((f[won, 0] > 0).all())
    vals, _ = p2i.p2i_max_plain(_t(pts), _t(f), _t(binds), b, h, w, radius,
                                with_ids=False)
    assert torch.equal(vals, got_v)


@pytest.mark.parametrize("grouped,with_ids,radius",
                         [(False, True, 4.5), (True, True, 7.0),
                          (True, False, 4.5)])
def test_p2i_plain_matches_pallas_interpret(rng, grouped, with_ids, radius):
    """Against the Pallas kernel (interpret mode) at H=32, W=128 on random
    inputs: values within atol 1e-6 (the kernel tests r^2 <= R^2 and scales
    r^2 by 1/R^2, so it rounds w otherwise; readings up to 2.1e-7); ids exact
    wherever the value exceeds 1e-6 (at a window's rim w is ~0 and the two
    forms can put it on either side of 0; readings: all ids agreed, rim
    pixels included)."""
    b, n, h, w = 2, 200, 32, 128
    pts = np.stack([rng.rand(b * n) * (h + 8) - 4,
                    rng.rand(b * n) * (w + 8) - 4], -1).astype(np.float32)
    f = (rng.rand(b * n, 1) + 0.1).astype(np.float32)
    binds = np.repeat(np.arange(b, dtype=np.int32), n)
    want_v, want_i = p2i_max_pallas(jnp.asarray(pts), jnp.asarray(f),
                                    jnp.asarray(binds), radius, b, h, w,
                                    with_ids=with_ids, grouped=grouped,
                                    interpret=True)
    got_v, got_i = p2i.p2i_max_plain(_t(pts), _t(f), _t(binds), b, h, w,
                                     radius, with_ids=with_ids)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=1e-6)
    if with_ids:
        sure = got_v.numpy() > 1e-6
        np.testing.assert_array_equal(got_i.numpy()[sure],
                                      np.asarray(want_i)[sure])
    else:
        assert got_i is None and want_i is None


@pytest.mark.parametrize("radius", [2.0, 5.0])
def test_p2i_backward_matches_jax_vjp(rng, radius):
    """Gradients of sum(g * out) with respect to points and features against
    jax.vjp of p2i_max_zbg: rtol 1e-5 of the largest entry (sin and the
    fused products round otherwise; readings up to 1.5e-7)."""
    b, h, w = 2, 24, 32
    pts, f, binds = _splat_case(rng, b, 150, h, w)
    g = rng.randn(b, h, w, 1).astype(np.float32)
    _, vjp = jax.vjp(lambda p, f: jax_zbg(p, f, jnp.asarray(binds), b, h, w,
                                          radius), jnp.asarray(pts),
                     jnp.asarray(f))
    want_pt, want_f = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    tp, tf = _t(pts).requires_grad_(), _t(f).requires_grad_()
    out = p2i.p2i_max_zbg(tp, tf, _t(binds), b, h, w, radius)
    (out * _t(g)).sum().backward()
    for got, want in ((tp.grad.numpy(), want_pt), (tf.grad.numpy(), want_f)):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_cpu_tensors_take_the_plain_p2i(rng):
    pts, f, binds = _splat_case(rng, 2, 150, 16, 16)
    _lib.reset_counts()
    p2i.p2i_max(_t(pts), _t(f), _t(binds), 2, 16, 16, 3.0)
    p2i.p2i_max_zbg(_t(pts), _t(f), _t(binds), 2, 16, 16, 3.0)
    assert _lib.PLAIN_CALLS["p2i"] == 2 and _lib.LAUNCHES["p2i"] == 0
    with pytest.raises(ValueError):
        p2i.p2i_max(_t(pts), _t(f), _t(binds[:-1]), 2, 16, 16, 3.0)
    with pytest.raises(TypeError):
        p2i.p2i_max(_t(pts), _t(f), _t(binds.astype(np.int64)), 2, 16, 16, 3.0)


# ---------------------------------------------------------------------------
# renderer
# ---------------------------------------------------------------------------

IMG = 64


def _renderers():
    return (JaxRenderer("orthorgonal", 1.0, IMG),
            ComputeDepthMaps("orthorgonal", 1.0, IMG))


def _clouds(rng, b=2, n=300):
    return (rng.rand(b, n, 3) - 0.5).astype(np.float32)


@pytest.mark.parametrize("projection", ["orthorgonal", "perspective"])
def test_matrices_match_jax(projection):
    want = np.asarray(JaxRenderer(projection, 1.0, IMG).matrices)
    np.testing.assert_array_equal(
        ComputeDepthMaps(projection, 1.0, IMG).matrices.numpy(), want)


def test_render_anchored_on_jax_projection_is_exact(rng):
    """Fed the JAX renderer's projected pixels and depth features, the
    port's splat and layout give JAX's all-view depth maps exactly."""
    cloud = _clouds(rng)
    jr, port_r = _renderers()
    radii = (2.0, 3.5)
    want = np.asarray(jax.jit(lambda d: jr.render_all_views(d, radii))(cloud))
    proj = jax.jit(jax.vmap(lambda m: jr._project(jnp.asarray(cloud), m)))
    pix, feat = (np.asarray(a) for a in proj(jr.matrices))       # [V, B*N, *]
    port_r._project = lambda data, m: (_t(pix.reshape(8, 2, -1, 2)),
                                   _t(feat.reshape(8, 2, -1, 1)))
    got = port_r.render_all_views(_t(cloud), radii)
    assert got.shape == (2, IMG, IMG, 16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("view", [0, 5])
def test_render_free_running_matches_jax(rng, view):
    """The port's own projection: all views and one view within atol 1e-5
    (the 4x4 products round otherwise and shift pixel coordinates by
    ~1e-5 px; readings up to 3.2e-6)."""
    cloud = _clouds(rng)
    jr, port_r = _renderers()
    want = np.asarray(jax.jit(lambda d: jr.render_all_views(d, (3.0,)))(cloud))
    np.testing.assert_allclose(port_r.render_all_views(_t(cloud), (3.0,)).numpy(),
                               want, atol=1e-5)
    want = np.asarray(jax.jit(lambda d: jr(d, view, (2.0, 4.0)))(cloud))
    np.testing.assert_allclose(port_r(_t(cloud), view, (2.0, 4.0)).numpy(), want,
                               atol=1e-5)


def test_render_gradient_matches_jax(rng):
    """Gradient of sum(g * maps) with respect to the cloud, through the
    depth normalisation and the p2i backward: within 1e-4 of JAX's in
    relative L2 norm (readings: 1.2e-6)."""
    cloud = _clouds(rng)
    g = rng.randn(2, IMG, IMG, 8).astype(np.float32)
    jr, port_r = _renderers()
    want = np.asarray(jax.jit(jax.grad(
        lambda d: jnp.sum(jr.render_all_views(d, (3.0,)) * g)))(cloud))
    tc = _t(cloud).requires_grad_()
    (port_r.render_all_views(tc, (3.0,)) * _t(g)).sum().backward()
    rel = np.linalg.norm(tc.grad.numpy() - want) / np.linalg.norm(want)
    assert rel <= 1e-4, rel


# ---------------------------------------------------------------------------
# discriminators
# ---------------------------------------------------------------------------

class MaskFeed:
    """A stand-in for jax.random.bernoulli that returns keep masks drawn
    from a numpy seed and records them, so both packages see the same
    Dropout2d masks."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.masks = []

    def __call__(self, key, p=0.5, shape=None):
        m = self.rng.rand(*shape) < float(p)
        self.masks.append(m)
        return jnp.asarray(m)

    def port_masks(self):
        """The recorded masks [B, 1, 1, C] as the port's [B, C, 1, 1]."""
        return [_t(np.ascontiguousarray(m.transpose(0, 3, 1, 2)))
                for m in self.masks]


def _jax_disc(use_cgan, num_classes):
    if use_cgan:
        return JaxProjD(num_classes=num_classes, train=True)
    return JaxPatchD(train=True)


def _disc_vars(model, img, y, rng):
    """Variables of the JAX discriminator: its own init, with BatchNorm
    running statistics jittered so that their update is checked."""
    v = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        jnp.asarray(img), y=y))
    for st in v["batch_stats"].values():
        st["mean"] = (0.1 * rng.randn(*st["mean"].shape)).astype(np.float32)
        st["var"] = (1.0 + 0.2 * rng.rand(*st["var"].shape)).astype(np.float32)
    return v


@pytest.mark.parametrize("use_cgan,num_classes", [(True, 0), (False, 0),
                                                 (True, 3)])
def test_discriminator_train_forward_matches_jax(rng, monkeypatch, use_cgan,
                                                 num_classes):
    """One train-mode forward at img 64 with the same weights, u vectors and
    dropout masks (ProjectionD as shipped, with 3 classes and its label
    embedding, and PatchDiscriminator): validity and the FM feature maps within 3e-5 of each
    tensor's largest entry (readings up to 5.6e-6, in PatchDiscriminator's
    fourth map, whose BatchNorm sees 64 values a channel), the updated u
    vectors and running statistics within 1e-5 of each buffer's largest
    entry (readings up to 4.4e-7), and every parameter gradient of a fixed
    loss within 1e-4 in relative L2 (readings up to 2.2e-5)."""
    b = 4
    img = rng.rand(b, IMG, IMG, 16).astype(np.float32)
    y = np.array([0, 2, 1, 2], np.int32) if num_classes else None
    model = _jax_disc(use_cgan, num_classes)
    v = _disc_vars(model, img, y, rng)
    feed = MaskFeed(5)
    monkeypatch.setattr(jax.random, "bernoulli", feed)
    wv = rng.randn(b, 1).astype(np.float32)

    def loss_fn(params):
        (val, feats), upd = model.apply(
            {"params": params, "batch_stats": v["batch_stats"],
             "spectral": v["spectral"]}, jnp.asarray(img), feat=True, y=y,
            mutable=["batch_stats", "spectral"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        loss = jnp.sum(val * wv) + sum(jnp.mean(f * f) for f in feats)
        return loss, (val, feats, upd)

    (_, (val, feats, upd)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    assert len(feed.masks) == (4 if use_cgan else 0)

    pm = port_models.build_discriminator(device="cpu", use_cgan=use_cgan,
                                         num_classes=num_classes,
                                         image_size=IMG)
    pm.load_state_dict(disc_state_dict_from_jax(
        v["params"], v["batch_stats"], v["spectral"], use_cgan=use_cgan),
        strict=True)
    masks = iter(feed.port_masks())
    monkeypatch.setattr(port_disc, "dropout_mask", lambda *a: next(masks))
    pval, pfeats = pm(_t(img), feat=True,
                      y=None if y is None else _t(y))
    assert next(masks, None) is None
    (torch.sum(pval * _t(wv)) + sum((f * f).mean() for f in pfeats)).backward()

    def close(got, want, tol):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * max(np.abs(want).max(), 1e-30))

    close(pval.detach().numpy(), val, 3e-5)
    assert len(pfeats) == len(feats) == 4
    for pf, jf in zip(pfeats, feats):
        close(pf.detach().numpy(), jf, 3e-5)
    want_sd = disc_state_dict_from_jax(v["params"], _np(upd["batch_stats"]),
                                       _np(upd["spectral"]), use_cgan=use_cgan)
    for name, buf in pm.named_buffers():
        if not name.endswith("num_batches_tracked"):
            close(buf.numpy(), want_sd[name].numpy(), 1e-5)
    want_g = disc_state_dict_from_jax(_np(grads), v["batch_stats"],
                                      v["spectral"], use_cgan=use_cgan)
    for name, p in pm.named_parameters():
        w = want_g[name].numpy()
        if name in PATCH_ZERO_GRAD and not use_cgan:
            assert max(np.linalg.norm(w), np.linalg.norm(p.grad.numpy())) < 1e-5
            continue
        rel = np.linalg.norm(p.grad.numpy() - w) / np.linalg.norm(w)
        assert rel <= 1e-4, (name, rel)


# PatchDiscriminator's conv biases ahead of a BatchNorm: their exact
# gradient is 0, and both packages give rounding noise (readings: norms up
# to 2.7e-6 against about 1 for the other leaves).
PATCH_ZERO_GRAD = {f"conv{i}.bias" for i in range(2, 7)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_discriminator_eval_forward_and_init(rng, monkeypatch):
    """Eval mode uses the running statistics, draws no mask and leaves u
    alone; a seed gives the same weights; every u has unit norm."""
    pm = port_models.build_discriminator(device="cpu", image_size=IMG, seed=7)
    again = port_models.build_discriminator(device="cpu", image_size=IMG, seed=7)
    for (n, a), (_, c) in zip(pm.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, c), n
    for n, buf in pm.named_buffers():
        if n.endswith(".u"):
            assert abs(float(buf.norm()) - 1.0) < 1e-6, n
    pm.eval()
    before = {n: b.clone() for n, b in pm.named_buffers()}
    img = _t(rng.rand(2, IMG, IMG, 16).astype(np.float32))
    monkeypatch.setattr(port_disc, "dropout_mask", None)   # not called in eval
    a = pm(img)
    assert a.shape == (2, 1) and bool(torch.isfinite(a).all())
    for n, buf in pm.named_buffers():
        assert torch.equal(buf, before[n]), n
