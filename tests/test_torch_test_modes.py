"""The evaluation CLI's side outputs (``--test_mode vis|render|kitti``,
``runners/base.py:inference``), the gray PNG writer, and the general p2i
ops, against the JAX package on the CPU at toy widths: the depth-map PNGs
pixel for pixel (the JAX side through its XLA p2i and matplotlib), the
KITTI .h5 clouds against the port's own eval forward, ``p2i_sum`` and
``p2i_max_bg`` forward and gradients."""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sparenet_tpu.renderer import ComputeDepthMaps as JaxRenderer
from sparenet_tpu.utils import visualizer as jax_uv
from sparenet_tpu_torch import test as cli
from sparenet_tpu_torch.configs import cfg_from_file, default_config
from sparenet_tpu_torch.data import data_init, h5
from sparenet_tpu_torch.data.io import IO
from sparenet_tpu_torch.models import build_generator, complete
from sparenet_tpu_torch.ops import _lib
from sparenet_tpu_torch.renderer import ComputeDepthMaps
from sparenet_tpu_torch.utils import visualizer as uv
from sparenet_tpu_torch.utils.checkpoint import checkpoint_save
from sparenet_tpu_torch.utils.metrics import Metrics

jax_p2i = importlib.import_module("sparenet_tpu.ops.p2i")
port_p2i = importlib.import_module("sparenet_tpu_torch.ops.p2i")

TOY_YAML = """\
DATASET: {train_dataset: Synthetic, test_dataset: Synthetic, n_outpoints: 128}
CONST: {num_workers: 2, n_input_points: 64}
NETWORK: {n_primitives: 2, metric: "chamfer", use_selayer: true}
RENDER: {img_size: 32}
TEST: {metric_name: "ChamferDistance", batch_size: 2, infer_freq: 1}
"""
TOY = dict(num_points=128, n_primitives=2, use_selayer=True)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the PNG writer and the render mode against the JAX package
# ---------------------------------------------------------------------------

def test_gray_png_equals_plt_imsave(tmp_path):
    """Pixel for pixel: the byte LUT (levels rounded down), the x * 256
    bins with 1.0 in the top one, under, over and NaN."""
    plt = uv.require_matplotlib("the test")
    rs = np.random.RandomState(0)
    img = rs.rand(37, 41).astype(np.float32)
    img.flat[:258] = np.arange(258) / 256.0
    img.flat[300:310] = [0, 1, -0.0, -1e-8, 1.0000001, np.nan, 255 / 256,
                         1 - 2**-24, 2, -3]
    for x in (img, img.astype(np.float64)):
        plt.imsave(tmp_path / "ref.png", x, cmap="gray", vmin=0.0, vmax=1.0)
        uv.save_gray_png(str(tmp_path / "mine.png"), x)
        want = np.asarray(Image.open(tmp_path / "ref.png"))
        assert want.shape == (37, 41, 4)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "mine.png")),
                                      want)
        np.testing.assert_array_equal(uv.read_png(str(tmp_path / "mine.png")),
                                      want)


def test_render_pngs_match_jax(tmp_path, monkeypatch):
    """The 24 depth-map PNGs of a batch (8 views x partial, output, ground
    truth at radius 7) decode to the pixels of the JAX package's
    ``_save_gray_png`` of its XLA renderer's maps of the same clouds. The
    port's renderer is anchored on the JAX package's projection (the 4x4
    products round otherwise, 1e-5 px, tests/test_torch_port_gan_ops.py),
    so the depth maps are equal and the PNG writers are what is compared."""
    jr = JaxRenderer("orthorgonal", 1.0, 32)
    project = jax.jit(jr._project)
    views = jax.jit(lambda d: jnp.stack(
        [jr(d, j, (7.0,))[0, :, :, 0] for j in range(jr.num_views)]))

    def anchored(self, data, matrix):
        pix, feat = project(jnp.asarray(data.numpy()), jnp.asarray(matrix.numpy()))
        shape = tuple(data.shape[:2])
        return (torch.from_numpy(np.array(pix)).reshape(shape + (2,)),
                torch.from_numpy(np.array(feat)).reshape(shape + (1,)))
    monkeypatch.setattr(ComputeDepthMaps, "_project", anchored)
    rs = np.random.RandomState(1)
    clouds = {"1": (rs.rand(2, 90, 3) - 0.5).astype(np.float32),
              "2": (rs.rand(2, 128, 3) * 0.8 - 0.4).astype(np.float32),
              "3": (rs.rand(2, 128, 3) - 0.5).astype(np.float32)}
    cfg = default_config()
    cfg.RENDER.img_size, cfg.DIR.logs = 32, str(tmp_path / "port")
    paths = uv.save_depth_map(
        cfg, torch.from_numpy(clouds["2"]),
        {"partial_cloud": torch.from_numpy(clouds["1"]),
         "gtcloud": torch.from_numpy(clouds["3"])}, "tax", 3)
    assert len(paths) == 24
    for tag, cloud in clouds.items():
        maps = np.asarray(views(jnp.asarray(cloud)))
        for j in range(8):
            want = str(tmp_path / "jax" / f"{j}{tag}.png")
            jax_uv._save_gray_png(want, maps[j])
            got = os.path.join(cfg.DIR.logs, "plots", "tax", "3", f"{j}{tag}.png")
            assert got in paths
            np.testing.assert_array_equal(uv.read_png(got),
                                          np.asarray(Image.open(want)))
    assert uv.read_png(paths[0])[..., 0].any()


# ---------------------------------------------------------------------------
# the CLI's test modes at toy widths
# ---------------------------------------------------------------------------

def _kitti_tree(root, rs):
    cats = [{"taxonomy_id": "02958343", "taxonomy_name": "car", "train": [],
             "val": [], "test": ["f0", "f1", "f2"]}]
    for d in ("cars", "bboxes"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i, s in enumerate(cats[0]["test"]):
        yaw = 0.3 + i
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        centre = rs.randn(3) * 5
        cloud = (rs.rand(50 + 10 * i, 3) - 0.5) * [3.8, 1.6, 1.4]
        IO.put(os.path.join(root, "cars", f"{s}.pcd"),
               (cloud @ rot.T + centre).astype(np.float32))
        box = np.array([[x, y, z] for x in (-2, 2) for y in (-0.9, 0.9)
                        for z in (-0.8, 0.8)]) @ rot.T + centre
        np.savetxt(os.path.join(root, "bboxes", f"{s}.txt"), box)
    with open(os.path.join(root, "KITTI.json"), "w") as f:
        json.dump(cats, f)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A toy yaml (KITTI paths into a tree of 3 frames) and a checkpoint of
    a seeded model with jittered BatchNorm statistics."""
    root = tmp_path_factory.mktemp("modes")
    _kitti_tree(str(root / "kitti"), np.random.RandomState(2))
    kitti = {"category_file_path": str(root / "kitti" / "KITTI.json"),
             "partial_points_path": str(root / "kitti" / "cars" / "%s.pcd"),
             "bounding_box_file_path": str(root / "kitti" / "bboxes" / "%s.txt")}
    path = root / "toy.yaml"
    path.write_text(TOY_YAML + "DATASETS: " + json.dumps(
        {"synthetic": {"n_train": 4, "n_val": 4}, "kitti": kitti}) + "\n")
    cfg = cfg_from_file(str(path))
    cfg.DIR.checkpoints = str(root / "given")
    model = build_generator(seed=3, device="cpu", **TOY)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.rand(buf.shape, generator=gen) * 0.6 - 0.3)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    checkpoint_save(cfg, 4, Metrics("ChamferDistance", [0.0, 1e4, 1e4]), None,
                    model)
    return dict(root=root, yaml=str(path),
                weights=os.path.join(cfg.DIR.checkpoints, "ckpt-best.pth"))


def _run(toy, work, mode):
    _lib.reset_counts()
    runner = cli.build(["--weights", toy["weights"], "--config", toy["yaml"],
                        "--workdir", str(work), "--device", "cpu",
                        "--test_mode", mode])
    return runner, cli.run(runner)


def test_cli_render_mode_writes_the_depth_maps(toy, tmp_path):
    """24 PNGs a batch (TEST.infer_freq 1: both batches), 24 p2i calls a
    batch, each map the renderer's of the batch's clouds, the output's from
    the runner's own model."""
    runner, line = _run(toy, tmp_path, "render")
    assert line["n_clouds"] == 4 and line["ChamferDistance"] > 0
    assert line["plain_calls"]["p2i"] == 48
    cfg = runner.config
    val = list(data_init(cfg)[1])
    renderer = ComputeDepthMaps(image_size=32)
    for b, (tax, _, _, data) in enumerate(val):
        base = os.path.join(cfg.DIR.logs, "plots", str(tax[0]), str(b))
        assert sorted(os.listdir(base)) == sorted(
            f"{j}{t}.png" for j in range(8) for t in "123")
        with torch.no_grad():
            out = complete(runner.model, torch.from_numpy(data["partial_cloud"]))
        clouds = {"1": torch.from_numpy(data["partial_cloud"]), "2": out[2],
                  "3": torch.from_numpy(data["gtcloud"])}
        for j in (0, 5):
            for tag, cloud in clouds.items():
                img = renderer(cloud, view_id=j, radius_list=[7.0])[0, :, :, 0]
                np.testing.assert_array_equal(
                    uv.read_png(os.path.join(base, f"{j}{tag}.png")),
                    uv.gray_rgba(img.numpy()))


def test_cli_vis_mode_writes_its_plot(toy, tmp_path):
    runner, line = _run(toy, tmp_path, "vis")
    plots = os.path.join(runner.config.DIR.logs, "plots")
    written = sorted(os.path.relpath(os.path.join(d, f), plots)
                     for d, _, fs in os.walk(plots) for f in fs)
    assert len(written) == 2 and all(p.endswith(".png") for p in written)
    with Image.open(os.path.join(plots, written[0])) as img:
        assert img.size == (900, 900)
    assert line["n_clouds"] == 4


def test_cli_vis_mode_names_matplotlib_before_building(toy, tmp_path,
                                                       monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        cli.main(["--weights", toy["weights"], "--config", toy["yaml"],
                  "--workdir", str(tmp_path / "w"), "--device", "cpu",
                  "--test_mode", "vis"])
    assert not (tmp_path / "w").exists()


def test_cli_kitti_mode_writes_the_completed_clouds(toy, tmp_path, capsys):
    """The .h5 outputs (a batch's first cloud) equal the model's eval forward
    on the pose-normalised partials; no metrics, no table, no checkpoint;
    the last line's metrics are null and its clouds counted."""
    cli.main(["--weights", toy["weights"], "--config", toy["yaml"],
              "--workdir", str(tmp_path), "--device", "cpu",
              "--test_mode", "kitti"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["n_clouds"] == 3 and line["batches"] == 2
    assert all(line[k] is None for k in Metrics.names())
    cfg = cfg_from_file(toy["yaml"])
    cfg.DATASET.test_dataset = "KITTI"
    model = build_generator(seed=0, device="cpu", **TOY)
    model.load_state_dict(torch.load(toy["weights"], weights_only=True)["net_G"])
    model.eval()
    for b, (tax, _, _, data) in enumerate(data_init(cfg)[1]):
        assert "gtcloud" not in data and data["partial_cloud"].shape[1] == 64
        with torch.no_grad():
            out = complete(model, torch.from_numpy(data["partial_cloud"]))[2]
        got = h5.read(os.path.join(str(tmp_path), "benchmark", tax[0],
                                   f"{b}.h5"))
        assert got.dtype == np.float32 and got.shape == (128, 3)
        np.testing.assert_array_equal(got, out[0].numpy())
    assert not os.path.exists(os.path.join(cfg.DIR.out_path, "checkpoints"))


# ---------------------------------------------------------------------------
# the general p2i ops against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduce", ["sum", "max"])
@pytest.mark.parametrize("radius,channels", [(2.5, 1), (4.0, 3)])
def test_general_p2i_matches_jax(reduce, radius, channels):
    """Forward and the gradients of points, features and background within
    1e-6 (the JAX package's custom VJPs), with points off the images, on
    pixel centres (r = 0) and of batch indices outside [0, B)."""
    rs = np.random.RandomState(0)
    b, h, w, p = 2, 17, 23, 60
    pts = (rs.rand(p, 2) * [h + 6, w + 6] - 3).astype(np.float32)
    pts[:3] = np.round(pts[:3])
    feats = rs.rand(p, channels).astype(np.float32)
    binds = rs.randint(-1, b + 1, p).astype(np.int32)
    bg = (rs.rand(b, h, w, channels) * 0.6).astype(np.float32)
    g = rs.randn(b, h, w, channels).astype(np.float32)

    def jf(a, f, c):
        return jax_p2i.p2i(a, f, jnp.asarray(binds), c, radius, reduce=reduce)
    want, vjp = jax.vjp(jf, jnp.asarray(pts), jnp.asarray(feats),
                        jnp.asarray(bg))
    wants = vjp(jnp.asarray(g))
    args = [torch.tensor(x, requires_grad=True) for x in (pts, feats, bg)]
    got = port_p2i.p2i(args[0], args[1], torch.from_numpy(binds), args[2],
                       radius, reduce=reduce)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    for t, j in zip(args, wants):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    assert np.abs(args[0].grad.numpy()).max() > 0


def test_p2i_dispatcher_refuses_other_kernels_and_reductions():
    z = torch.zeros(1, 2), torch.zeros(1, 1), torch.zeros(1, dtype=torch.int32)
    bg = torch.zeros(1, 4, 4, 1)
    with pytest.raises(ValueError, match="kernel"):
        port_p2i.p2i(*z, bg, 2.0, kernel_kind_str="gauss")
    with pytest.raises(ValueError, match="reduce"):
        port_p2i.p2i(*z, bg, 2.0, reduce="mean")
