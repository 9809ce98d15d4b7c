"""The port's data pipeline (``sparenet_tpu_torch/data``: transforms, the
file datasets, the loader) against the JAX package's on the same files.

The JAX transforms and file loaders draw from the global ``random`` and
``np.random`` inside a pool of loader threads; the port draws from
generators seeded with CONST.seed plus the pass, in index order on one
thread. So each JAX pass here runs at one worker with the globals seeded
with the value the port's generators get, and then the batches must be
equal bit for bit. The trees are small copies of the published layouts
(modelled on tests/test_dataset_layouts.py), written with the port's codecs.
"""

import json
import os
import random

import numpy as np
import pytest

from sparenet_tpu.configs import default_config as jax_default_config
from sparenet_tpu.data import loaders as jax_loaders
from sparenet_tpu.data import transforms as jax_T
from sparenet_tpu_torch.configs import default_config
from sparenet_tpu_torch.data import datasets as port_datasets
from sparenet_tpu_torch.data import loaders as port_loaders
from sparenet_tpu_torch.data import transforms as port_T
from sparenet_tpu_torch.data.io import IO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAX_A, TAX_B = "02691156", "02958343"   # airplane, car


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _apply_both(name, params, x, rnd_value, seed=11):
    """(port output, JAX output) of one transform on copies of ``x``, the
    port drawing from RandomState(seed), the JAX package from the global
    generator seeded with it; both generators must be left in one state."""
    port_t = port_T.TRANSFORM_REGISTRY[name](params)
    jax_t = jax_T.TRANSFORM_REGISTRY[name](params)
    rs = np.random.RandomState(seed)
    np.random.seed(seed)
    got = port_t(x.copy(), rnd_value, rs)
    want = (jax_t(x.copy(), rnd_value) if isinstance(jax_t, jax_T._SHARED_RND)
            else jax_t(x.copy()))
    assert rs.randint(2**31) == np.random.randint(2**31)
    return got, want


POINT_CASES = [
    ("RandomSamplePoints", {"n_points": 50}, 0.5),      # truncates
    ("RandomSamplePoints", {"n_points": 120}, 0.5),     # zero-pads
    ("RandomClipPoints", {"sigma": 0.02, "clip": 0.03}, 0.5),
    ("RandomClipPoints", None, 0.5),
    ("RandomRotatePoints", None, 0.3),
    ("RandomScalePoints", {"scale": 1.3}, 0.7),
    ("RandomMirrorPoints", None, 0.1),
    ("RandomMirrorPoints", None, 0.25),
    ("RandomMirrorPoints", None, 0.4),
    ("RandomMirrorPoints", None, 0.6),
    ("RandomMirrorPoints", None, 0.9),
    ("ToArray", None, 0.5),
    ("ToTensor", None, 0.5),
]


@pytest.mark.parametrize("name,params,rnd_value", POINT_CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(POINT_CASES)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_point_transforms_match_jax(name, params, rnd_value, dtype):
    x = (np.random.RandomState(1).randn(80, 3) * 0.3).astype(dtype)
    got, want = _apply_both(name, params, x, rnd_value)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


IMAGE_CASES = [
    ("RandomFlip", None, 0.3), ("RandomFlip", None, 0.7),
    ("RandomPermuteRGB", None, 0.5),
    ("RandomBackground", {"bg_color": [[0, 255], [10, 20], [200, 255]]}, 0.5),
    ("Normalize", {"mean": [0.5, 0.4, 0.3, 0.2], "std": [0.2, 0.3, 0.4, 0.5]},
     0.5),
    ("CenterCrop", {"img_size": (6, 6), "crop_size": (8, 8)}, 0.5),
    ("RandomCrop", {"img_size": (6, 6), "crop_size": (8, 8)}, 0.35),
]


@pytest.mark.parametrize("name,params,rnd_value", IMAGE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(IMAGE_CASES)])
def test_image_transforms_match_jax(name, params, rnd_value):
    if name.endswith("Crop"):
        pytest.importorskip("cv2")
    img = np.random.RandomState(2).rand(12, 10, 4).astype(np.float32)
    img[2:5, 3:7, 3] = 0           # transparent pixels for the background
    got, want = _apply_both(name, params, img, rnd_value)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_normalize_object_pose_matches_jax():
    rs = np.random.RandomState(3)
    cloud = (rs.randn(70, 3) * [2, 1, 0.5] + [10, -4, 1]).astype(np.float32)
    yaw = 0.7
    rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                    [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    box = (np.array([[x, y, z] for x in (-2, 2) for y in (-1, 1)
                     for z in (-0.5, 0.5)]) @ rot.T + [10, -4, 1])
    params = {"input_keys": {"ptcloud": "partial_cloud", "bbox": "bounding_box"}}
    data = {"partial_cloud": cloud, "bounding_box": box.astype(np.float32)}
    got = port_T.NormalizeObjectPose(params)(dict(data))
    want = jax_T.NormalizeObjectPose(params)(dict(data))
    for k in data:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_compose_shares_its_rnd_value_as_jax(seed):
    """One rnd_value a step for every object it names (the partial and the
    complete cloud mirrored and scaled alike), the draws in the JAX order."""
    steps = [
        {"callback": "RandomSamplePoints", "parameters": {"n_points": 64},
         "objects": ["partial_cloud"]},
        {"callback": "RandomSamplePoints", "parameters": {"n_points": 128},
         "objects": ["gtcloud"]},
        {"callback": "RandomMirrorPoints",
         "objects": ["partial_cloud", "gtcloud"]},
        {"callback": "RandomScalePoints", "parameters": {"scale": 1.2},
         "objects": ["partial_cloud", "gtcloud"]},
        {"callback": "RandomClipPoints", "objects": ["partial_cloud"]},
        {"callback": "ToArray", "objects": ["partial_cloud", "gtcloud"]},
    ]
    rs0 = np.random.RandomState(seed + 100)
    data = {"partial_cloud": rs0.rand(90, 3).astype(np.float32),
            "gtcloud": rs0.rand(100, 3).astype(np.float32)}
    rs = np.random.RandomState(seed)
    got = port_T.Compose(steps)({k: v.copy() for k, v in data.items()}, rs)
    np.random.seed(seed)
    want = jax_T.Compose(steps)({k: v.copy() for k, v in data.items()})
    for k in data:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    assert rs.randint(2**31) == np.random.randint(2**31)


# ---------------------------------------------------------------------------
# dataset trees
# ---------------------------------------------------------------------------

def _cloud(rs, n):
    return (rs.rand(n, 3) - 0.5).astype(np.float32)


def _shapenet_tree(root, rs, n_renderings=3):
    """<root>/%s/partial/%s/%s/%02d.pcd and <root>/%s/complete/%s/%s.pcd;
    partials of 40-100 points (some short of n_input_points), one of them
    ASCII."""
    cats = [{"taxonomy_id": TAX_A, "taxonomy_name": "airplane",
             "train": ["a1", "a2", "a3"], "val": ["a4"], "test": ["a4", "a5"]},
            {"taxonomy_id": TAX_B, "taxonomy_name": "car",
             "train": ["b1", "b2", "b3"], "val": ["b4"], "test": ["b4"]}]
    for dc in cats:
        for subset in ("train", "test"):
            for s in dc[subset]:
                d = os.path.join(root, subset, "complete", dc["taxonomy_id"])
                os.makedirs(d, exist_ok=True)
                IO.put(os.path.join(d, f"{s}.pcd"), _cloud(rs, 160))
                d = os.path.join(root, subset, "partial", dc["taxonomy_id"], s)
                os.makedirs(d, exist_ok=True)
                for i in range(n_renderings):
                    IO.put(os.path.join(d, f"{i:02d}.pcd"),
                           _cloud(rs, int(rs.randint(40, 100))))
    ascii_path = os.path.join(root, "train", "partial", TAX_A, "a1", "01.pcd")
    pts = _cloud(rs, 70)
    with open(ascii_path, "w") as f:
        f.write("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                "COUNT 1 1 1\nWIDTH 70\nHEIGHT 1\nPOINTS 70\nDATA ascii\n")
        f.writelines(" ".join(repr(float(v)) for v in p) + "\n" for p in pts)
    path = os.path.join(root, "ShapeNet.json")
    with open(path, "w") as f:
        json.dump(cats, f)
    return path


def _completion3d_tree(root, rs):
    cats = [{"taxonomy_id": "all", "taxonomy_name": "all",
             "train": [], "val": [], "test": ["t9"]},
            {"taxonomy_id": TAX_A, "taxonomy_name": "airplane",
             "train": ["m1", "m2", "m3", "m4"], "val": ["m5", "m6", "m7"],
             "test": []},
            {"taxonomy_id": TAX_B, "taxonomy_name": "car",
             "train": ["n1", "n2"], "val": ["n3"], "test": []}]
    for dc in cats:
        for subset in ("train", "val", "test"):
            for s in dc[subset]:
                for kind, n in (("partial", int(rs.randint(40, 100))),
                                ("gt", 96)):
                    d = os.path.join(root, subset, kind, dc["taxonomy_id"])
                    os.makedirs(d, exist_ok=True)
                    IO.put(os.path.join(d, f"{s}.h5"), _cloud(rs, n))
    path = os.path.join(root, "Completion3D.json")
    with open(path, "w") as f:
        json.dump(cats, f)
    return path


def _kitti_tree(root, rs):
    cats = [{"taxonomy_id": TAX_B, "taxonomy_name": "car", "train": [],
             "val": [], "test": ["frame_0", "frame_1", "frame_2"]}]
    for d in ("cars", "bboxes"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for i, s in enumerate(cats[0]["test"]):
        yaw = 0.4 + i
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        centre = rs.randn(3) * 5
        cloud = (rs.rand(int(rs.randint(50, 90)), 3) - 0.5) * [3.8, 1.6, 1.4]
        IO.put(os.path.join(root, "cars", f"{s}.pcd"),
               (cloud @ rot.T + centre).astype(np.float32))
        box = np.array([[x, y, z] for x in (-2, 2) for y in (-0.9, 0.9)
                        for z in (-0.8, 0.8)]) @ rot.T + centre
        np.savetxt(os.path.join(root, "bboxes", f"{s}.txt"), box)
    path = os.path.join(root, "KITTI.json")
    with open(path, "w") as f:
        json.dump(cats, f)
    return path


def _configs(root, kind, workers=3):
    """(port config, JAX config at one worker) for a dataset case."""
    out = []
    for make, n_workers in ((default_config, workers), (jax_default_config, 1)):
        cfg = make()
        cfg.CONST.n_input_points = 64
        cfg.CONST.num_workers = n_workers
        cfg.CONST.seed = 5
        cfg.DATASET.n_outpoints = 128
        cfg.TRAIN.batch_size = 2
        cfg.TEST.batch_size = 2
        sn = cfg.DATASETS.shapenet
        sn.category_file_path = os.path.join(root, "ShapeNet.json")
        sn.n_renderings = 3
        sn.partial_points_path = os.path.join(root, "%s/partial/%s/%s/%02d.pcd")
        sn.complete_points_path = os.path.join(root, "%s/complete/%s/%s.pcd")
        c3 = cfg.DATASETS.completion3d
        c3.category_file_path = os.path.join(root, "c3d", "Completion3D.json")
        c3.partial_points_path = os.path.join(root, "c3d", "%s/partial/%s/%s.h5")
        c3.complete_points_path = os.path.join(root, "c3d", "%s/gt/%s/%s.h5")
        kt = cfg.DATASETS.kitti
        kt.category_file_path = os.path.join(root, "kitti", "KITTI.json")
        kt.partial_points_path = os.path.join(root, "kitti", "cars", "%s.pcd")
        kt.bounding_box_file_path = os.path.join(root, "kitti", "bboxes",
                                                 "%s.txt")
        train, test = {"shapenet_grnet": ("ShapeNet", "ShapeNet"),
                       "shapenet_expanded": ("ShapeNet", "ShapeNet"),
                       "shapenet_cars": ("ShapeNetCars", "ShapeNetCars"),
                       "completion3d": ("Completion3D", "Completion3D"),
                       "kitti": ("ShapeNetCars", "KITTI")}[kind]
        cfg.DATASET.train_dataset, cfg.DATASET.test_dataset = train, test
        if kind == "shapenet_expanded":
            sn.version = "SpareNet"
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trees"))
    rs = np.random.RandomState(0)
    _shapenet_tree(root, rs)
    _completion3d_tree(os.path.join(root, "c3d"), rs)
    _kitti_tree(os.path.join(root, "kitti"), rs)
    return root


def _jax_pass(loader, seed):
    random.seed(seed)
    np.random.seed(seed)
    return list(loader)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[2] == w[2]
        assert g[1].dtype == w[1].dtype == np.int32
        np.testing.assert_array_equal(g[1], w[1])
        assert sorted(g[3]) == sorted(w[3])
        for k in w[3]:
            assert g[3][k].dtype == w[3][k].dtype == np.float32
            np.testing.assert_array_equal(g[3][k], w[3][k])


@pytest.mark.parametrize("kind", ["shapenet_grnet", "shapenet_expanded",
                                  "shapenet_cars", "completion3d", "kitti"])
def test_batches_through_data_init_match_jax(trees, kind):
    """Two training passes and one validation pass, bit for bit."""
    pc, jc = _configs(trees, kind)
    port_train, port_val = port_loaders.data_init(pc)
    jax_train, jax_val = jax_loaders.data_init(jc)
    assert (len(port_train), len(port_val)) == (len(jax_train), len(jax_val))
    for epoch in range(2):
        _assert_batches_equal(list(port_train),
                              _jax_pass(jax_train, pc.CONST.seed + epoch))
    val = list(port_val)
    _assert_batches_equal(val, _jax_pass(jax_val, pc.CONST.seed))
    keys = set(val[0][3])
    if kind == "kitti":
        assert keys == {"partial_cloud", "bounding_box"}
        assert val[0][3]["bounding_box"].shape == (2, 8, 3)
        assert np.abs(val[0][3]["partial_cloud"]).max() < 1.5
    else:
        assert keys == {"partial_cloud", "gtcloud"}
    if kind == "completion3d":
        assert port_val.dataset.file_list[0]["gtcloud_path"].count("/val/")


def test_batches_do_not_depend_on_the_worker_count(trees):
    """Files are read by the pool, draws taken in index order: one worker
    and four give the same two passes."""
    passes = []
    for workers in (1, 4):
        loader, _ = port_loaders.data_init(
            _configs(trees, "shapenet_grnet", workers)[0])
        passes.append([list(loader) for _ in range(2)])
    for a, b in zip(*passes):
        _assert_batches_equal(a, b)


def test_a_resumed_pass_draws_what_the_first_drew(trees):
    """A new loader (a resumed run's) draws in its first pass what the
    first run's loader drew in its first; the second pass draws anew; the
    first batch read ahead (the mml fit's) is the next pass's."""
    pc = _configs(trees, "shapenet_grnet")[0]
    first, _ = port_loaders.data_init(pc)
    ahead = first.first_batch()
    one, two = list(first), list(first)
    resumed, _ = port_loaders.data_init(pc)
    _assert_batches_equal(list(resumed), one)
    _assert_batches_equal([ahead], one[:1])
    a = np.concatenate([b[3]["partial_cloud"] for b in one])
    b = np.concatenate([b[3]["partial_cloud"] for b in two])
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_data_init_keeps_val_and_the_cgan_classes(trees):
    """Completion3D validates on VAL (its TEST has no ground truth) and
    counts its classes without "all", as the JAX package does."""
    pc, jc = _configs(trees, "completion3d")
    for cfg in (pc, jc):
        cfg.GAN.use_cgan = True
    _, pv = port_loaders.data_init(pc)
    _, jv = jax_loaders.data_init(jc)
    assert pc.DATASET.num_class == jc.DATASET.num_class == 2
    assert len(pv.dataset) == len(jv.dataset) == 4
    test = port_datasets.Completion3DDataLoader(pc).get_dataset("test")
    assert test.options["required_items"] == ["partial_cloud"]


@pytest.mark.parametrize("name", ["ShapeNet", "ShapeNetCars", "Completion3D",
                                  "KITTI", "Synthetic"])
def test_loader_class_serves_every_dataset(name):
    cls = port_datasets.loader_class(name)
    assert cls is port_datasets.DATASET_LOADER_MAPPING[name]
    if name != "Synthetic":      # reads the port's own category file
        assert len(cls(default_config()).dataset_categories) > 0
    with pytest.raises(KeyError, match="NoSuchSet"):
        port_datasets.loader_class("NoSuchSet")


def test_default_category_files_are_the_port_copies():
    """The defaults point inside sparenet_tpu_torch/, resolved from the
    package, and the copies hold the JAX package's categories."""
    pkg = os.path.join(ROOT, "sparenet_tpu_torch") + os.sep
    cfg, jcfg = default_config(), jax_default_config()
    for key in ("shapenet", "completion3d", "kitti"):
        path = cfg.DATASETS[key].category_file_path
        assert os.path.isabs(path) and path.startswith(pkg), path
        with open(path) as a, open(os.path.join(
                ROOT, jcfg.DATASETS[key].category_file_path)) as b:
            assert json.load(a) == json.load(b)
