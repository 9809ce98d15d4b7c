"""The port's config reader, Synthetic dataset, loaders, AverageMeter and
result table against the JAX package's (all numpy and Python: equal
exactly)."""

import contextlib
import io
import os

import numpy as np
import pytest

from sparenet_tpu import configs as jax_configs
from sparenet_tpu.data import datasets as jax_datasets
from sparenet_tpu.data import loaders as jax_loaders
from sparenet_tpu.runners.misc import AverageMeter as JaxMeter
from sparenet_tpu.utils import visualizer as jax_vis
from sparenet_tpu_torch import configs as port_configs
from sparenet_tpu_torch.data import datasets as port_datasets
from sparenet_tpu_torch.data import loaders as port_loaders
from sparenet_tpu_torch.runners.misc import AverageMeter as PortMeter
from sparenet_tpu_torch.utils import visualizer as port_vis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = os.path.join(ROOT, "sparenet_tpu", "configs")
PORT_META = os.path.join(ROOT, "sparenet_tpu_torch", "data", "meta")
YAMLS = ([os.path.join(JAX_CONFIGS, f"{m}.yaml") for m in
          ("sparenet", "sparenet_gan", "atlasnet", "msn", "grnet")]
         + [os.path.join(ROOT, "scripts", "r4", "train_conv_sparenet.yaml")]
         + [os.path.join(port_configs.CONFIG_DIR, f) for f in
            ("sparenet.yaml", "flagship_e8_eval.yaml")])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_config_tree_matches_jax(path):
    """The same tree, key for key and type for type."""
    got = port_configs.cfg_from_file(path)
    want = jax_configs.cfg_from_file(path)

    def walk(a, b, where=""):
        assert type(a).__name__ == type(b).__name__, where
        if isinstance(a, dict):
            assert list(a) == list(b), where
            for k in a:
                walk(a[k], b[k], f"{where}.{k}")
        elif where.endswith(".category_file_path"):
            # the port reads its own copy of each category file
            assert os.path.basename(a) == os.path.basename(b), where
            assert a == os.path.join(PORT_META, os.path.basename(b)), where
        else:
            assert a == b, where
    walk(got, want)
    for name, d in got.DATASETS.items():
        if "category_file_path" in d:
            d.category_file_path = want.DATASETS[name].category_file_path
    got.DIR.out_path = want.DIR.out_path = "/out"
    assert (port_configs.cfg_update(got, weights="w.npz", timestamp=False)
            == jax_configs.cfg_update(want, weights="w.npz", timestamp=False))
    assert got == want and got.DIR.logs == "/out/logs/run"


def test_port_sparenet_yaml_is_the_shipped_one():
    with open(os.path.join(JAX_CONFIGS, "sparenet.yaml")) as f:
        want = f.read()
    with open(os.path.join(port_configs.CONFIG_DIR, "sparenet.yaml")) as f:
        assert f.read() == want


@pytest.mark.parametrize("overlay,err", [
    ({"NETWORK": {"no_such_key": 1}}, KeyError),
    ({"NETWORK": {"n_primitives": "many"}}, ValueError),
    ({"NETWORK": 3}, ValueError),
])
def test_merge_into_is_strict_as_jax(overlay, err):
    with pytest.raises(err):
        port_configs.merge_into(overlay, port_configs.default_config())
    with pytest.raises(err):
        jax_configs.merge_into(overlay, jax_configs.default_config())


def test_merge_into_widens_as_jax():
    overlay = {"TEST": {"emd_eps": 1}, "TRAIN": {"betas": [0.5, 0.99]}}
    got, want = port_configs.default_config(), jax_configs.default_config()
    port_configs.merge_into(overlay, got)
    jax_configs.merge_into(overlay, want)
    assert got.TEST.emd_eps == want.TEST.emd_eps == 1.0
    assert type(got.TEST.emd_eps) is float
    assert got.TRAIN.betas == want.TRAIN.betas == (0.5, 0.99)


# ---------------------------------------------------------------------------
# Synthetic dataset and loaders
# ---------------------------------------------------------------------------

def _cfgs(n_out=16384, n_in=3000, **synthetic):
    out = []
    for mod in (port_configs, jax_configs):
        cfg = mod.default_config()
        cfg.DATASET.n_outpoints = n_out
        cfg.CONST.n_input_points = n_in
        cfg.DATASETS.synthetic.update(synthetic)
        out.append(cfg)
    return out


def _assert_items_equal(got, want):
    assert got[:3] == want[:3]
    assert sorted(got[3]) == sorted(want[3])
    for k in got[3]:
        assert got[3][k].dtype == want[3][k].dtype == np.float32
        np.testing.assert_array_equal(got[3][k], want[3][k])


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("n_out,n_in", [(16384, 3000), (2048, 3000)])
def test_synthetic_items_match_jax(split, n_out, n_in):
    """Bit for bit, at the eval config's sizes and where the half-space
    crop is short of n_in (zero rows padded)."""
    pc, jc = _cfgs(n_out, n_in, n_train=40, n_val=40)
    port_ds = port_datasets.SyntheticDataLoader(pc).get_dataset(split)
    jax_ds = jax_datasets.SyntheticDataLoader(jc).get_dataset(split)
    assert len(port_ds) == len(jax_ds) == 40
    for idx in (0, 1, 7, 13, 39):
        got, want = port_ds[idx], jax_ds[idx]
        _assert_items_equal(got, want)
        assert got[3]["partial_cloud"].shape == (n_in, 3)
    if n_in > n_out // 2:
        assert not got[3]["partial_cloud"][-1].any()


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_dataloader_batches_match_jax(shuffle, drop_last):
    """The same batches in the same order over two epochs: shuffled (the
    training loader: seeded, drop_last) and in order (validation)."""
    pc, jc = _cfgs(256, 64, n_train=10)
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
              num_workers=3, prefetch=2, seed=1)
    got = port_loaders.DataLoader(port_datasets.SyntheticDataset(pc, "train"), **kw)
    want = jax_loaders.DataLoader(jax_datasets.SyntheticDataset(jc, "train"), **kw)
    assert len(got) == len(want) == (2 if drop_last else 3)
    for _ in range(2):
        batches = list(zip(got, want, strict=True))
        assert len(batches) == len(want)
        for g, w in batches:
            assert g[0] == w[0] and g[2] == w[2]
            np.testing.assert_array_equal(g[1], w[1])
            assert g[1].dtype == w[1].dtype == np.int32
            for k in w[3]:
                np.testing.assert_array_equal(g[3][k], w[3][k])


def test_dataloader_raises_a_worker_error():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise RuntimeError(f"item {i}")
    with pytest.raises(RuntimeError, match="item"):
        list(port_loaders.DataLoader(Broken(), 2, shuffle=False))


def test_data_init_matches_jax():
    """Validation takes TEST in batches of TEST.batch_size; use_cgan sets
    DATASET.num_class from the categories."""
    path = os.path.join(port_configs.CONFIG_DIR, "sparenet.yaml")
    pc, jc = port_configs.cfg_from_file(path), jax_configs.cfg_from_file(path)
    for cfg in (pc, jc):
        cfg.DATASET.train_dataset = cfg.DATASET.test_dataset = "Synthetic"
        cfg.DATASET.n_outpoints = 512
        cfg.TEST.batch_size = 3
    gt, gv = port_loaders.data_init(pc)
    jt, jv = jax_loaders.data_init(jc)
    assert pc.DATASET.num_class == jc.DATASET.num_class == 8
    assert (len(gt), len(gv)) == (len(jt), len(jv)) == (256 // 24, 11)
    assert gv.dataset.subset == jv.dataset.subset == "test"
    g, w = next(iter(gv)), next(iter(jv))
    assert g[2] == w[2] and g[3]["gtcloud"].shape == (3, 512, 3)
    np.testing.assert_array_equal(g[3]["partial_cloud"], w[3]["partial_cloud"])


# ---------------------------------------------------------------------------
# AverageMeter, print_table
# ---------------------------------------------------------------------------

def _meters(cls, rng_seed=0):
    rng = np.random.RandomState(rng_seed)
    single, multi = cls(), cls(["F-Score", "ChamferDistance", "EMD"])
    for _ in range(5):
        single.update(float(rng.rand()))
        multi.update([float(v) for v in rng.rand(3)])
    multi.update((1.0, 2.0, 3.0))
    return single, multi


def test_average_meter_matches_jax():
    (ps, pm), (js, jm) = _meters(PortMeter), _meters(JaxMeter)
    assert (ps.val(), ps.avg(), ps.count()) == (js.val(), js.avg(), js.count())
    assert (pm.val(), pm.avg(), pm.count()) == (jm.val(), jm.avg(), jm.count())
    for i in range(3):
        assert (pm.val(i), pm.avg(i), pm.count(i)) == (jm.val(i), jm.avg(i), jm.count(i))
    pm.reset()
    assert pm.avg() == [0.0, 0.0, 0.0] and pm.count() == [0, 0, 0]
    assert PortMeter().avg() == 0.0


class _Writer:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, *a):
        self.scalars.append(a)


def test_print_table_matches_jax(tmp_path):
    """The same printed table, the same scalars and the same json_stats
    line in DIR.logs/test.txt."""
    outs = []
    for mod, meter_cls, cfg_mod, sub in ((port_vis, PortMeter, port_configs, "p"),
                                         (jax_vis, JaxMeter, jax_configs, "j")):
        cfg = cfg_mod.default_config()
        cfg.DIR.logs = str(tmp_path / sub)
        _, overall = _meters(meter_cls)
        cats = {f"synthetic_{i}": _meters(meter_cls, i + 1)[1] for i in range(3)}
        losses = meter_cls(["CoarseLoss", "RefineLoss"])
        losses.update([0.5, 0.25])
        writer, buf = _Writer(), io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.print_table(cfg, -1, overall, cats, writer, losses)
        with open(tmp_path / sub / "test.txt") as f:
            outs.append((buf.getvalue(), writer.scalars, f.read()))
    assert outs[0] == outs[1]
    assert "Overall" in outs[0][0] and outs[0][2].startswith("json_stats: ")
