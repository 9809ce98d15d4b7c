"""Evaluation CLI of the port (counterpart of the root test.py, which runs
the JAX package).

    python -m sparenet_tpu_torch.test --weights CKPT
        [--model sparenet|msn|atlasnet|grnet] [--config YAML]
        [--dataset Synthetic] [--workdir DIR] [--device cpu]
        [--serving [--mds {auto,exact,batched,hybrid}] [--mds-g G]
         [--mds-schedule S1,S2,...] [--mds-tail T]
         [--mds-select {sort,bisect,topk,pack16}]]

CKPT is a checkpoint of the port (``.pth``, utils/checkpoint.py) or the JAX
package's bf16 archive (``.npz``). The config defaults to the port's copy of
the model's shipped yaml (``configs/<model>.yaml``, with ``--gan``
``configs/sparenet_gan.yaml``). It runs on the card
unless ``--device cpu`` is given. ``--serving`` evaluates in serving mode
(the JAX package's ``SPARENET_FAST_MATH=1``) on the MDS dial the other
flags set (the counterparts of ``SPARENET_MDS_IMPL``, ``_BATCH_G``,
``_SCHEDULE`` (an empty value: fixed G), ``_TAIL`` and ``_SELECT``, with
their defaults; ``models.ServingDial``); a dial flag without ``--serving`` is
an error. In serving mode the runner fits the mml ratio at load
(``runners.base.BaseRunner.autocalibrate_mml``; SpareNet and MSN: AtlasNet
has no MDS, and its serving mode is the decoders' bf16 chain). The table of per-category
metrics goes to
stdout and to DIR/logs/<stamp>/test.txt; the last line printed is one JSON
object: the split's mean F-Score, ChamferDistance (x 1000) and EMD (x 100),
its clouds and batches, the seconds spent on data, forward and metrics,
the mode ("parity" or "serving"), the serving dial with the MDS arm it
resolves to, the mml ratio and whether it was fitted,
and the kernel launches and plain-version calls by op of the load (the mml
fit) and the evaluation (on the card every op launches its kernel; on the
CPU each runs its plain version). ``build(argv)`` gives the loaded runner
and ``run(runner)`` that line, for callers in process.
SpareNet (with or without ``--gan``), MSN, AtlasNet and GRNet, and
TEST.mode "default", are ported. MSN's and AtlasNet's grids and GRNet's
sample are seeded by the batch's index, as the JAX package seeds
PRNGKey(model_idx). GRNet has no serving mode: ``--serving`` evaluates it
in its one mode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .configs import cfg_from_file, cfg_update, model_names, shipped_yaml

MODELS = {"sparenet": model_names.MODEL_SPARENET,
          "atlasnet": model_names.MODEL_ATLASNET,
          "msn": model_names.MODEL_MSN, "grnet": model_names.MODEL_GRNET}
# the dial flags and their ServingDial fields
DIAL_FLAGS = {"mds": "mds", "mds_g": "g", "mds_schedule": "schedule",
              "mds_tail": "tail", "mds_select": "select"}


def add_serving_args(parser: argparse.ArgumentParser) -> None:
    """``--serving`` and the MDS dial's flags (each left unset: the JAX
    package's default)."""
    parser.add_argument("--serving", action="store_true",
                        help="serving mode (SPARENET_FAST_MATH=1)")
    parser.add_argument("--mds", choices=["auto", "exact", "batched",
                                          "hybrid"])
    parser.add_argument("--mds-g", type=int)
    parser.add_argument("--mds-schedule", type=str,
                        help="comma ints; empty: the fixed G alone")
    parser.add_argument("--mds-tail", type=int)
    parser.add_argument("--mds-select", choices=["sort", "bisect", "topk",
                                                 "pack16"])


def serving_dial(args):
    """The ``models.ServingDial`` the flags ask for, None without
    ``--serving``."""
    flags = {f: getattr(args, f) for f in DIAL_FLAGS
             if getattr(args, f) is not None}
    if not args.serving:
        if flags:
            raise ValueError(", ".join("--" + f.replace("_", "-") for f in flags)
                             + " set the serving MDS dial: they need --serving")
        return None
    given = {DIAL_FLAGS[f]: v for f, v in flags.items()}
    if "schedule" in given:
        given["schedule"] = tuple(int(v) for v in given["schedule"].split(",")
                                  if v.strip())
    from .models import ServingDial
    return ServingDial(**given)


def get_args_from_command_line(argv=None):
    parser = argparse.ArgumentParser(description="SpareNet evaluation "
                                                 "(PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, default="sparenet",
                        choices=sorted(MODELS))
    parser.add_argument("--gan", action="store_true")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--weights", type=str, required=True,
                        help="checkpoint to evaluate (.pth or .npz)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--workdir", type=str, default=None)
    parser.add_argument("--test_mode", type=str, default="default",
                        choices=["default", "vis", "render", "kitti"])
    parser.add_argument("--dataset", type=str, default=None)
    add_serving_args(parser)
    return parser.parse_args(argv)


def build(argv=None):
    """The runner the command line asks for, built and loaded (in serving
    mode the mml ratio is fitted there)."""
    args = get_args_from_command_line(argv)

    from .runners import runner_class
    from .utils.logging import set_logger

    runner_cls = runner_class(MODELS[args.model], args.gan)
    dial = serving_dial(args)
    if args.test_mode != "default":
        raise NotImplementedError(
            f"--test_mode {args.test_mode}: the plots, depth maps and KITTI "
            f"outputs are not ported yet (ROADMAP.md, queue 1 item 3)")
    yaml_path = args.config or shipped_yaml(args.model, args.gan)
    cfg = cfg_from_file(yaml_path)
    cfg_update(cfg, weights=args.weights, workdir=args.workdir)
    cfg.TEST.mode = args.test_mode
    if args.dataset:
        cfg.DATASET.train_dataset = args.dataset
        cfg.DATASET.test_dataset = args.dataset

    logger = set_logger(os.path.join(cfg.DIR.logs, "log.txt"))
    return runner_cls(cfg, logger, device=args.device, dial=dial)


def run(runner) -> dict:
    """Evaluate ``runner`` over its split; the CLI's last line (the kernel
    and plain-version counts as they stand: ``main`` sets them to 0 before
    the runner is built, so they hold the load's mml fit too)."""
    from .ops import _lib

    runner.test()
    line = runner.summary()
    line.update(device=str(runner.device),
                launches={k: v for k, v in _lib.LAUNCHES.items() if v},
                plain_calls={k: v for k, v in _lib.PLAIN_CALLS.items() if v})
    return line


def main(argv=None) -> int:
    from .ops import _lib

    _lib.reset_counts()
    print(json.dumps(run(build(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
