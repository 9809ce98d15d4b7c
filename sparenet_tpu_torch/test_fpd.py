"""FPD evaluation CLI of the port (counterpart of the root test_fpd.py).

    python -m sparenet_tpu_torch.test_fpd --data_dir DIR --fake_dir DIR
        [--list_path LIST] [--weights NPZ|PTH] [--num_points 16384]
        [--batch_size 30] [--jobs J] [--device cpu] [--log_dir DIR]

Scores completed clouds (``<fake_dir>/<taxonomy>/<model>.pcd``) against the
ground truth (``<data_dir>/complete/<taxonomy>/<model>.pcd``) over the
model list (default the port's copy of the 1200-model ShapeNet test list,
``data/meta/fpd_test.list``, 150 models in each of 8 taxonomies): the FPD of
each category, their mean and the FPD over all models, each cloud's first
``num_points`` points read through ``data.io.IO.get``. The classifier
defaults to the port's canonical one (``frechet.fpd.CANONICAL``); a ``.pth``
loads as the reference's state_dict. The forward runs on the card unless
``--device cpu``; the statistics and the nine Frechet distances on the
host, the distances in ``--jobs`` processes (scipy's sqrtm of a 1808 x 1808
product is seconds of one core). The last line of output is one JSON
object: the distances and the seconds by part (read, activations,
statistics, sqrtm).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from contextlib import contextmanager
from multiprocessing import get_context
from time import perf_counter

import numpy as np

from .data.io import IO
from .frechet.fpd import (CANONICAL, calculate_frechet_distance,
                          get_activations, load_classifier)
from .utils.logging import set_logger

TAXONOMY2LABEL = {
    "02691156": 0, "02933112": 1, "02958343": 2, "03001627": 3,
    "03636649": 4, "04256520": 5, "04379243": 6, "04530566": 7,
}
LABEL2TAXONOMY = {v: k for k, v in TAXONOMY2LABEL.items()}
FPD_LIST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "meta", "fpd_test.list")
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log_dir", default="./output/fpd_logs")
    ap.add_argument("--list_path", default=FPD_LIST)
    ap.add_argument("--data_dir", required=True,
                    help="the ground truth: <data_dir>/complete/<tax>/<id>.pcd")
    ap.add_argument("--fake_dir", required=True,
                    help="the completions: <fake_dir>/<tax>/<id>.pcd")
    ap.add_argument("--weights", default=CANONICAL,
                    help="PointNetCls weights: the port's .npz (reference "
                         "names) or the reference's .pth")
    ap.add_argument("--num_points", type=int, default=16384)
    ap.add_argument("--batch_size", type=int, default=30)
    ap.add_argument("--jobs", type=int, default=min(9, os.cpu_count() or 1),
                    help="processes for the Frechet distances")
    ap.add_argument("--device", default=None,
                    help="torch device of the forward (default: the card)")
    return ap.parse_args(argv)


@contextmanager
def _one_thread_each():
    """Spawned workers start with one BLAS thread each (they inherit the
    environment at their start)."""
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update(dict.fromkeys(_THREAD_VARS, "1"))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _distance(stats):
    t = perf_counter()
    return calculate_frechet_distance(*stats), perf_counter() - t


def frechet_distances(stats: list, jobs: int) -> tuple[list, float]:
    """The Frechet distance of each (mu1, s1, mu2, s2), in ``jobs``
    processes (spawned: the parent may hold a CUDA context); returns the
    distances and the sqrtm seconds summed over them."""
    if jobs <= 1:
        out = [_distance(s) for s in stats]
    else:
        with _one_thread_each(), ProcessPoolExecutor(
                min(jobs, len(stats)), mp_context=get_context("spawn")) as ex:
            out = list(ex.map(_distance, stats))
    return [d for d, _ in out], sum(t for _, t in out)


def _statistics(act: np.ndarray):
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def main(argv=None) -> dict:
    opt = parse_args(argv)
    os.makedirs(opt.log_dir, exist_ok=True)
    logger = set_logger(os.path.join(opt.log_dir, "log.txt"))
    logger.info("save into dir: %s" % opt.log_dir)
    with open(opt.list_path) as f:
        model_list = f.read().splitlines()
    logger.info("n_samples %s" % len(model_list))
    seconds = dict.fromkeys(("read", "activations", "statistics", "sqrtm"), 0.0)
    model = load_classifier(opt.weights, device=opt.device)

    t = perf_counter()
    fakes, reals = [[] for _ in range(8)], [[] for _ in range(8)]
    for model_id in model_list:
        taxonomy_id, _ = model_id.split("/")
        label = TAXONOMY2LABEL[taxonomy_id]
        fake = np.asarray(IO.get(os.path.join(opt.fake_dir, "%s.pcd" % model_id)))
        gt = np.asarray(IO.get(os.path.join(opt.data_dir, "complete",
                                            "%s.pcd" % model_id)))
        fakes[label].append(fake[: opt.num_points].astype(np.float32))
        reals[label].append(gt[: opt.num_points].astype(np.float32))
    seconds["read"] = perf_counter() - t

    def activations(clouds):
        if len(clouds) // opt.batch_size * opt.batch_size < 2:
            # the JAX package's CLI would hand sqrtm a NaN covariance
            raise ValueError(
                f"{len(clouds)} clouds in batches of {opt.batch_size} leave "
                f"fewer than 2 activations: no covariance")
        t = perf_counter()
        act = get_activations(clouds, model, opt.batch_size)
        seconds["activations"] += perf_counter() - t
        t = perf_counter()
        stats = _statistics(act)
        seconds["statistics"] += perf_counter() - t
        return stats

    labels = [label for label in range(8) if fakes[label]]
    stats = [activations(np.stack(fakes[label])) + activations(np.stack(reals[label]))
             for label in labels]
    stats.append(activations(np.concatenate([np.stack(fakes[la]) for la in labels]))
                 + activations(np.concatenate([np.stack(reals[la]) for la in labels])))
    values, seconds["sqrtm"] = frechet_distances(stats, opt.jobs)
    per_category = {}
    for label, fpd in zip(labels, values):
        per_category[LABEL2TAXONOMY[label]] = fpd
        logger.info("[ %s  category] Frechet Pointcloud Distance <<< %f >>>"
                    % (LABEL2TAXONOMY[label], fpd))
    mean = float(np.mean(values[:-1]))
    logger.info("avg FPD for %d categories: %f" % (len(labels), mean))
    logger.info("[ all category] Frechet Pointcloud Distance <<< %f >>>"
                % values[-1])
    line = {"fpd_per_category": per_category, "fpd_category_mean": mean,
            "fpd_all": values[-1], "n_models": len(model_list),
            "seconds": seconds}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main(sys.argv[1:])
