"""Evaluation CLI of the port (counterpart of the root test.py, which runs
the JAX package).

    python -m sparenet_tpu_torch.test --weights CKPT [--config YAML]
        [--dataset Synthetic] [--workdir DIR] [--device cpu]

CKPT is a checkpoint of the port (``.pth``, utils/checkpoint.py) or the JAX
package's bf16 archive (``.npz``). The config defaults to the port's copy of
the model's shipped yaml (``configs/sparenet.yaml``). It runs on the card
unless ``--device cpu`` is given. The table of per-category metrics goes to
stdout and to DIR/logs/<stamp>/test.txt; the last line printed is one JSON
object: the split's mean F-Score, ChamferDistance (x 1000) and EMD (x 100),
its clouds and batches, the seconds spent on data, forward and metrics,
and the evaluation's kernel launches and plain-version calls by op (on the
card every op launches its kernel; on the CPU each runs its plain version).
Only SpareNet without the GAN and TEST.mode "default" are ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .configs import CONFIG_DIR, cfg_from_file, cfg_update, model_names

MODELS = {"sparenet": model_names.MODEL_SPARENET,
          "atlasnet": model_names.MODEL_ATLASNET,
          "msn": model_names.MODEL_MSN, "grnet": model_names.MODEL_GRNET}


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
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = get_args_from_command_line(argv)

    from .ops import _lib
    from .runners import runner_class
    from .utils.logging import set_logger

    runner_cls = runner_class(MODELS[args.model], args.gan)
    if args.test_mode != "default":
        raise NotImplementedError(
            f"--test_mode {args.test_mode}: the plots, depth maps and KITTI "
            f"outputs are not ported yet (ROADMAP.md, queue 1 item 3)")
    yaml_path = args.config or os.path.join(CONFIG_DIR, f"{args.model}.yaml")
    cfg = cfg_from_file(yaml_path)
    cfg_update(cfg, weights=args.weights, workdir=args.workdir)
    cfg.TEST.mode = args.test_mode
    if args.dataset:
        cfg.DATASET.train_dataset = args.dataset
        cfg.DATASET.test_dataset = args.dataset

    logger = set_logger(os.path.join(cfg.DIR.logs, "log.txt"))
    runner = runner_cls(cfg, logger, device=args.device)
    _lib.reset_counts()
    runner.test()
    line = runner.summary()
    line.update(device=str(runner.device),
                launches={k: v for k, v in _lib.LAUNCHES.items() if v},
                plain_calls={k: v for k, v in _lib.PLAIN_CALLS.items() if v})
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
