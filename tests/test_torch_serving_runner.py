"""The port's serving runner (``runners.base.BaseRunner`` with a
``models.ServingDial``) against the JAX package's runner on the CPU: the mml
self-calibration at load (``BaseRunner._maybe_autocalibrate_mml``, run on a
stand-in holding the JAX model, its variables, its loader and its config,
with the JAX package's serving mode on through ``set_fast_math(True)``), its
opt-outs and its plausibility band; the serving eval step; the config's
NETWORK.mml_calibration; and both CLIs' serving flags.

The toy config: Synthetic, 64 -> 128 points, 4 primitives (the encoder and
decoder at define_G's widths), TEST batches of 2. Weights are
tests/test_torch_port_train.py's well-conditioned draw, carried into the
port's layout by ``utils/weights.py`` and saved as a port checkpoint. The
JAX encoder's kNN graphs come from the packed Pallas kernel in interpret
mode, which the port's serving encoder reproduces (on the CPU the JAX
package would take its exact XLA selection).
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparenet_tpu.configs import cfg_from_file as jax_cfg_from_file
from sparenet_tpu.data.loaders import data_init as jax_data_init
from sparenet_tpu.models import SpareNetGenerator as JaxGenerator
from sparenet_tpu.models import define_G
from sparenet_tpu.models import layers as jax_layers
from sparenet_tpu.ops import common as opc
from sparenet_tpu.ops.pallas.knn_pallas import knn_self_pallas
from sparenet_tpu.runners.base import BaseRunner as JaxBaseRunner
from sparenet_tpu_torch import test as test_cli
from sparenet_tpu_torch import train as train_cli
from sparenet_tpu_torch.configs import cfg_from_file, cfg_update
from sparenet_tpu_torch.models import ServingDial, build_generator, complete
from sparenet_tpu_torch.ops import _lib
from sparenet_tpu_torch.runners import sparenetRunner
from sparenet_tpu_torch.utils.checkpoint import checkpoint_save
from sparenet_tpu_torch.utils.metrics import Metrics
from sparenet_tpu_torch.utils.weights import state_dict_from_jax
from tests.test_torch_port_train import draw_variables

jax.config.update("jax_platforms", "cpu")

TOY_YAML = """\
DATASET: {train_dataset: Synthetic, test_dataset: Synthetic, n_outpoints: 128}
CONST: {num_workers: 2, n_input_points: 64}
NETWORK: {n_primitives: 4, metric: chamfer, use_selayer: true}
TRAIN: {batch_size: 2}
TEST: {metric_name: ChamferDistance, batch_size: 2, emd_iters: 5}
RENDER: {img_size: 64}
DATASETS: {synthetic: {n_train: 4, n_val: 4}}
"""
TOY = dict(num_points=128, n_primitives=4, use_selayer=True)
DEFAULT = 1.33
# The fitted ratio against the JAX runner's. The fit itself agrees to 2e-7
# on the same coarse clouds (tests/test_torch_port_serving_ops.py); the two
# serving coarse clouds differ, by up to 8.1e-3 at these widths and weights,
# where the port's serving chains round products to bf16 and the JAX CPU
# program keeps f32 (tests/test_torch_port_serving.py). Reading: 2.0e-3
# relative. Limit 2.5x that.
FIT_RTOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads: the suite runs files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Log:
    """A logger that keeps its lines."""

    def __init__(self):
        self.lines, self.warnings = [], []

    def info(self, msg):
        self.lines.append(str(msg))

    def warning(self, msg):
        self.warnings.append(str(msg))


def _packed_knn(x, k):
    return knn_self_pallas(x, k, interpret=True, packed=True)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy yaml, the JAX variables and two port checkpoints of them:
    as drawn, and collapsed (the decoder's last conv zeroed, so that every
    coarse cloud is one point)."""
    root = tmp_path_factory.mktemp("serving_runner")
    yaml = root / "toy.yaml"
    yaml.write_text(TOY_YAML)
    jax_model = JaxGenerator(bottleneck_size=4096, hide_size=4096,
                             use_adain="share", encode="Residualnet",
                             train=False, **TOY)
    sample = np.zeros((2, 64, 3), np.float32)
    variables = draw_variables(jax_model, sample, np.random.RandomState(0))
    collapsed = jax.tree_util.tree_map(np.array, variables)
    last = collapsed["params"]["decoder"]["VmapGridDecoder_0"]["Conv1d_3"]
    last["kernel"][:] = 0.0
    last["bias"][:] = 0.0
    out = dict(root=root, yaml=str(yaml), jax_model=jax_model,
               variables={"drawn": variables, "collapsed": collapsed})
    cfg = cfg_from_file(str(yaml))
    for name, v in out["variables"].items():
        model = build_generator(device="cpu", **TOY)
        model.load_state_dict(state_dict_from_jax(v, n_primitives=4),
                              strict=True)
        cfg.DIR.checkpoints = str(root / name)
        checkpoint_save(cfg, 1, Metrics("ChamferDistance", [0.0, 1e4, 1e4]),
                        None, model)
        out[name] = str(root / name / "ckpt-best.pth")
    return out


def _config(toy, tag, weights=None, **sections):
    cfg = cfg_from_file(toy["yaml"])
    cfg_update(cfg, weights=weights, workdir=str(toy["root"] / tag))
    for section, values in sections.items():
        cfg[section].update(values)
    return cfg


def _runner(toy, tag, weights=None, dial=ServingDial(), **sections):
    """A port runner on the CPU; (runner, its logger, the expansion's plain
    calls during its construction)."""
    log = _Log()
    _lib.reset_counts()
    runner = sparenetRunner(_config(toy, tag, weights, **sections), log,
                            device="cpu", dial=dial)
    return runner, log, _lib.PLAIN_CALLS["expansion"]


def _jax_fit(toy, variables, weights=True, fast_math=True, **sections):
    """The JAX runner's _maybe_autocalibrate_mml on a stand-in runner: the
    calibration it leaves on its eval model and its warnings."""
    cfg = jax_cfg_from_file(toy["yaml"])
    cfg.CONST.weights = "the checkpoint" if weights else None
    for section, values in sections.items():
        cfg[section].update(values)
    model = define_G(cfg, train=False)
    log = _Log()
    stub = types.SimpleNamespace(
        config=cfg, model_eval=model, logger=log,
        state=types.SimpleNamespace(
            params=toy["variables"][variables]["params"],
            batch_stats=toy["variables"][variables]["batch_stats"]),
        val_loader=jax_data_init(cfg)[1])
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_layers, "knn_idx", _packed_knn)
    opc.set_fast_math(fast_math)
    try:
        JaxBaseRunner._maybe_autocalibrate_mml(stub)
    finally:
        opc.set_fast_math(False)
        mp.undo()
    return stub.model_eval.mml_calibration, log.warnings


@pytest.fixture(scope="module")
def fitted(toy):
    """The port's serving runner on the drawn checkpoint, and the JAX
    runner's fit of the same checkpoint."""
    runner, log, expansion = _runner(toy, "fit", toy["drawn"])
    want, warnings = _jax_fit(toy, "drawn")
    return dict(runner=runner, log=log, expansion=expansion, want=want,
                warnings=warnings)


def test_fitted_ratio_matches_jax_runner(fitted):
    """The fit on the first validation batch's serving coarse clouds: the
    expansion once (its plain version here), the ratio within FIT_RTOL of
    the JAX runner's, the default replaced, the fit logged."""
    runner = fitted["runner"]
    assert fitted["expansion"] == 1
    assert runner.mml_fitted and fitted["want"] != DEFAULT
    assert runner.mml_calibration == pytest.approx(fitted["want"], rel=FIT_RTOL)
    assert runner.model.refine.mml_calibration == runner.mml_calibration
    assert any("Auto-calibrated serving mml ratio" in line
               for line in fitted["log"].lines)
    assert not fitted["warnings"] and not fitted["log"].warnings


@pytest.mark.parametrize("opt_out", ["no weights", "mml_calibration set",
                                     "auto-calibration off", "parity mode"])
def test_opt_outs_match_jax_runner(toy, opt_out):
    """Each opt-out on its own: no fit (no expansion call at load), and the
    calibration the JAX runner keeps (the family default, or the config's
    NETWORK.mml_calibration, which reaches the model in both packages)."""
    kw = {"no weights": dict(weights=False),
          "mml_calibration set": dict(NETWORK={"mml_calibration": 2.5}),
          "auto-calibration off": dict(TEST={"mml_auto_calibrate": False}),
          "parity mode": dict(fast_math=False)}[opt_out]
    want, _ = _jax_fit(toy, "drawn", **kw)
    weights = None if opt_out == "no weights" else toy["drawn"]
    dial = None if opt_out == "parity mode" else ServingDial()
    sections = {k: v for k, v in kw.items() if k.isupper()}
    runner, log, expansion = _runner(toy, opt_out.replace(" ", "_"), weights,
                                     dial, **sections)
    assert expansion == 0 and not runner.mml_fitted
    assert runner.mml_calibration == want == (
        2.5 if opt_out == "mml_calibration set" else DEFAULT)
    mode = runner.mode()
    assert mode["mode"] == ("parity" if dial is None else "serving")
    assert mode["mml_calibration"] == want and not mode["mml_fitted"]


def test_collapsed_checkpoint_keeps_default_and_warns(toy):
    """A collapsed checkpoint fits a ratio of about 0: both runners keep the
    family default and warn."""
    want, jax_warnings = _jax_fit(toy, "collapsed")
    runner, log, expansion = _runner(toy, "collapsed", toy["collapsed"])
    assert expansion == 1 and not runner.mml_fitted
    assert runner.mml_calibration == want == DEFAULT
    assert len(jax_warnings) == len(log.warnings) == 1
    assert "outside the plausible band" in log.warnings[0]
    assert "outside the plausible band" in jax_warnings[0]


def test_serving_val_step_is_complete_on_the_dial(toy, fitted):
    """The runner's serving val_step refine equals complete() of a
    generator built with the same dial and ratio, bit for bit: the runner
    adds no arithmetic. The training forward of the same runner stays in
    parity mode (the expansion penalty, a non-zero loss_mst)."""
    runner = fitted["runner"]
    dial = runner.dial
    items = runner.val_loader.first_batch()
    runner.reset_meters()
    vals = runner.val_step(items)
    assert vals.shape == (3, 2) and np.isfinite(vals).all()
    model = build_generator(device="cpu", mml_calibration=runner.mml_calibration,
                            **TOY, **dial.generator_kwargs())
    model.load_state_dict(runner.model.state_dict(), strict=True)
    partial = torch.from_numpy(items[3]["partial_cloud"])
    assert torch.equal(runner.ptcloud, complete(model, partial)[2])
    with torch.no_grad():
        _, _, _, loss_mst = runner.model.train()(partial)
    runner.model.eval()
    assert float(loss_mst) > 0


def test_cli_flags_reach_the_runner(toy):
    """Both CLIs build the dial their flags ask for, the GAN runner's
    generator too (an empty schedule is the fixed G), and a dial flag
    without --serving is an error."""
    base = ["--config", toy["yaml"], "--device", "cpu"]
    flags = ["--serving", "--mds", "batched", "--mds-g", "32",
             "--mds-schedule", "8,16", "--mds-tail", "24", "--mds-select",
             "topk"]
    want = ServingDial(mds="batched", g=32, schedule=(8, 16), tail=24,
                       select="topk")
    runner = train_cli.build(base + ["--workdir", str(toy["root"] / "train")]
                             + flags)
    assert runner.dial == want and not runner.mml_fitted
    r = runner.model.refine
    assert (r.serving, r.mds, r.mds_g, r.mds_schedule, r.mds_tail, r.select) == (
        True, "batched", 32, (8, 16), 24, "topk")
    gan = train_cli.build(base + ["--gan", "--workdir", str(toy["root"] / "gan")]
                          + flags)
    assert gan.dial == want and gan.model.refine.select == "topk"
    args = test_cli.get_args_from_command_line(
        ["--weights", "w", "--serving", "--mds-schedule", ""])
    assert test_cli.serving_dial(args) == ServingDial(schedule=())
    for cli in (test_cli.main, train_cli.main):
        with pytest.raises(ValueError, match="need --serving"):
            cli(base + ["--weights", toy["drawn"], "--mds-select", "pack16"])


@pytest.mark.parametrize("flags,arm", [
    (["--mds", "batched", "--mds-select", "pack16"], "batched"),
    (["--mds", "exact"], "exact")])
def test_eval_cli_serving_line(toy, capsys, flags, arm):
    """``python -m sparenet_tpu_torch.test --serving ...`` on the CPU runs
    the toy split to its JSON line, which names the mode, the dial and its
    resolved arm, and the ratio fitted at load (the load's expansion call
    among the plain calls)."""
    assert test_cli.main(["--model", "sparenet", "--weights", toy["drawn"],
                          "--config", toy["yaml"], "--device", "cpu",
                          "--workdir", str(toy["root"] / f"cli_{arm}"),
                          "--serving"] + flags) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["mode"] == "serving" and line["dial"]["arm"] == arm
    assert line["dial"]["select"] == ("pack16" if arm == "batched" else "sort")
    assert line["mml_fitted"] and line["mml_calibration"] != DEFAULT
    assert line["n_clouds"] == 4 and np.isfinite(line["F-Score"])
    assert line["plain_calls"]["expansion"] == 1
    assert line["plain_calls"]["knn_packed"] == 12 and "knn" not in line["plain_calls"]
    assert ("mds" in line["plain_calls"]) == (arm == "exact")
    assert not line["launches"]


def test_port_reads_no_sparenet_variable():
    """The serving switch and dial are arguments: no module of the port
    reads a SPARENET_* environment variable."""
    import pathlib
    import re
    root = pathlib.Path(test_cli.__file__).parent
    reads = re.compile(r"(os\.environ|getenv\()[^\n]*SPARENET_")
    sources = [p for p in sorted(root.rglob("*.py"))
               if "_build" not in p.relative_to(root).parts]
    hits = [f"{p.relative_to(root)}:{i}" for p in sources
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if reads.search(line)]
    assert len(sources) > 30 and not hits, hits
