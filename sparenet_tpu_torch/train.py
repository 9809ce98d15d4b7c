"""Training CLI of the port (counterpart of the root train.py, which runs
the JAX package).

    python -m sparenet_tpu_torch.train [--model sparenet|msn|atlasnet|grnet]
        [--gan] [--config YAML] [--weights CKPT] [--workdir DIR]
        [--dataset NAME]
        [--epochs N] [--batch-size B] [--device cpu]
        [--serving [--mds ...] [--mds-g G] [--mds-schedule S1,...]
         [--mds-tail T] [--mds-select ...]]

The config defaults to the port's copy of the model's shipped yaml
(``configs/<model>.yaml``, with ``--gan`` ``configs/sparenet_gan.yaml``).
CKPT resumes a run: a checkpoint of the port (``.pth``, its epoch and, where
it holds them, the optimizers, the discriminator and the step generators)
or the JAX package's bf16 archive (``.npz``, loaded as epoch 1: its weights,
with the optimizers fresh). Epochs run from the checkpoint's epoch + 1 to
``--epochs`` (TRAIN.n_epochs), each followed by validation and a checkpoint
on improvement or every TRAIN.save_freq epochs, under DIR. It runs on the
card unless ``--device cpu`` is given. ``--serving`` and the MDS dial's flags
are the evaluation CLI's (``test.py``): validation then runs serving mode on
that dial, as the root train.py's does under ``SPARENET_FAST_MATH=1``, with
the mml ratio fitted at load where a checkpoint is given; training stays in
parity mode (TRAIN.serving_aligned puts its MDS on the batched arm of the
same dial). The last line printed is one JSON
object: the epochs run, each one's lr and mean losses, the best metrics, the
clouds trained and the training seconds by part (data, step, val) with the
clouds a second of data and step time, the mode, dial and mml ratio as the
evaluation CLI gives them, and the run's kernel launches and
plain-version calls by op (on the card every op launches its kernel; on the
CPU each runs its plain version). SpareNet (with or without the GAN), MSN,
AtlasNet and GRNet are ported. MSN and AtlasNet fold grids, and GRNet
samples points, that a generator seeded from CONST.seed draws each step;
the checkpoint keeps its state (``rng_grid``, ``rng_sample``), so a resumed
run draws what the run it resumes would have drawn.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .configs import cfg_from_file, cfg_update, shipped_yaml
from .test import MODELS, add_serving_args, serving_dial


def get_args_from_command_line(argv=None):
    parser = argparse.ArgumentParser(description="SpareNet training "
                                                 "(PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, default="sparenet",
                        choices=sorted(MODELS))
    parser.add_argument("--gan", action="store_true",
                        help="adversarial-rendering training (SpareNet only)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--weights", type=str, default=None,
                        help="checkpoint to resume from (.pth or .npz)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--workdir", type=str, default=None)
    parser.add_argument("--dataset", type=str, default=None,
                        help="DATASET.{train,test}_dataset: ShapeNet, "
                             "ShapeNetCars, Completion3D, KITTI or Synthetic")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    add_serving_args(parser)
    return parser.parse_args(argv)


def build(argv=None):
    """The runner the command line asks for, built and loaded."""
    args = get_args_from_command_line(argv)

    from .runners import runner_class
    from .utils.logging import set_logger

    runner_cls = runner_class(MODELS[args.model], args.gan)
    dial = serving_dial(args)
    yaml_path = args.config or shipped_yaml(args.model, args.gan)
    cfg = cfg_from_file(yaml_path)
    cfg_update(cfg, weights=args.weights, workdir=args.workdir)
    if args.dataset:
        cfg.DATASET.train_dataset = args.dataset
        cfg.DATASET.test_dataset = args.dataset
    if args.epochs:
        cfg.TRAIN.n_epochs = args.epochs
    if args.batch_size:
        cfg.TRAIN.batch_size = args.batch_size
    logger = set_logger(os.path.join(cfg.DIR.logs, "log.txt"))
    logger.info("Use config: %s" % yaml_path)
    return runner_cls(cfg, logger, device=args.device, dial=dial)


def run(runner) -> dict:
    """Train ``runner`` (its epochs, each validated), with every kernel and
    plain-version count set to 0 just before; the CLI's last line."""
    from .ops import _lib

    _lib.reset_counts()
    runner.runner()
    line = runner.train_summary()
    line.update(device=str(runner.device), **runner.mode(),
                launches={k: v for k, v in _lib.LAUNCHES.items() if v},
                plain_calls={k: v for k, v in _lib.PLAIN_CALLS.items() if v})
    return line


def main(argv=None) -> int:
    print(json.dumps(run(build(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
