"""The JAX package's reading of the trained flagship on the evaluation split
that the PyTorch port's CLI and ``chip_smoke.py`` run.

    python scripts/port_jax_eval_reading.py \
        [--weights docs/artifacts/r5/flagship_e8_bf16.npz] \
        [--config sparenet_tpu_torch/configs/flagship_e8_eval.yaml] \
        [--chunk 1] [--jobs 4] \
        [--out docs/artifacts/port/jax_eval_flagship_e8.json]

It reads the config with the JAX package's ``cfg_from_file``, batches the
validation split with its ``data_init`` (Synthetic TEST, 8 batches of 16),
runs its parity-mode eval forward on the npz's weights (``load_npz``) and
its ``compute_all`` (F-Score@0.01, CD x 1000, EMD x 100 at the config's
TEST.emd_eps / emd_iters) on each batch, and writes the per-cloud,
per-batch and overall means to ``--out``. The forward runs ``--chunk``
clouds at a time and the metrics one: in eval mode BatchNorm reads its
running statistics, so a cloud's output does not depend on the others in
its batch, and every metric is a per-cloud value (the JAX CPU paths at
B=16 take many times the sum of 16 calls at B=1), in ``--jobs`` worker
processes, a batch each at a time. CPU only (2679 s with 4 jobs on 8
cores for the committed file: the JAX CPU auction takes about 75 s a cloud
there); ``chip_smoke.py`` holds the port's card readings to this file.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


_WORKER: dict = {}


def _init_worker(config: str, weights: str, chunk: int) -> None:
    """Load the model and the weights once in each worker process."""
    os.environ.pop("SPARENET_FAST_MATH", None)      # parity mode
    import jax
    jax.config.update("jax_platforms", "cpu")

    from sparenet_tpu.configs import cfg_from_file
    from sparenet_tpu.models import define_G
    from sparenet_tpu.ops import common as opc
    from sparenet_tpu.utils.ckpt_npz import load_npz

    assert not opc.FAST_MATH, "the reading is of parity mode"
    cfg = cfg_from_file(config)
    model = define_G(cfg, train=False)
    _WORKER.update(
        variables=jax.device_put(load_npz(weights)),
        forward=jax.jit(lambda v, x: model.apply(v, x)[2]),
        eps=float(cfg.TEST.emd_eps), iters=int(cfg.TEST.emd_iters),
        chunk=chunk)


def _run_batch(item):
    """(batch index, metrics [3, B], forward s, metrics s) of one batch."""
    import jax.numpy as jnp
    import numpy as np

    from sparenet_tpu.utils.metrics import compute_all

    b, partial, gt = item
    w = _WORKER
    t0 = time.perf_counter()
    refine = np.concatenate([
        np.asarray(w["forward"](w["variables"],
                                jnp.asarray(partial[i:i + w["chunk"]])))
        for i in range(0, partial.shape[0], w["chunk"])])
    t1 = time.perf_counter()
    vals = np.concatenate([
        compute_all(jnp.asarray(refine[i:i + 1]), jnp.asarray(gt[i:i + 1]),
                    eps=w["eps"], iters=w["iters"])
        for i in range(refine.shape[0])], 1)
    return b, vals, t1 - t0, time.perf_counter() - t1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default="docs/artifacts/r5/flagship_e8_bf16.npz")
    ap.add_argument("--config",
                    default="sparenet_tpu_torch/configs/flagship_e8_eval.yaml")
    ap.add_argument("--chunk", type=int, default=1)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default="docs/artifacts/port/jax_eval_flagship_e8.json")
    args = ap.parse_args()

    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from sparenet_tpu.configs import cfg_from_file
    from sparenet_tpu.data import data_init
    from sparenet_tpu.utils.metrics import NAMES

    t_start = time.perf_counter()
    config = os.path.join(ROOT, args.config)
    cfg = cfg_from_file(config)
    _, val_loader = data_init(cfg)
    batches, taxonomy = [], []
    for b, (tids, _, _, data) in enumerate(val_loader):
        batches.append((b, data["partial_cloud"], data["gtcloud"]))
        taxonomy.extend(tids)
    results = {}
    with ProcessPoolExecutor(args.jobs, mp_context=mp.get_context("spawn"),
                             initializer=_init_worker,
                             initargs=(config, os.path.join(ROOT, args.weights),
                                       args.chunk)) as pool:
        for b, vals, t_fwd, t_met in pool.map(_run_batch, batches):
            results[b] = vals
            print(f"batch {b}: {dict(zip(NAMES, vals.mean(1).tolist()))} "
                  f"(forward {t_fwd:.1f} s, metrics {t_met:.1f} s)", flush=True)
    vals = np.concatenate([results[b] for b in sorted(results)], 1)
    per_cloud = {n: [float(v) for v in vals[i]] for i, n in enumerate(NAMES)}
    per_batch = [{n: float(results[b][i].mean()) for i, n in enumerate(NAMES)}
                 for b in sorted(results)]
    overall = {n: float(np.mean(per_cloud[n])) for n in NAMES}
    import jax
    out = {
        "what": "the JAX package's parity-mode eval of the npz on the "
                "config's validation split, on the CPU",
        "weights": args.weights,
        "config": args.config,
        "split": "test",
        "n_clouds": len(taxonomy),
        "batch_size": int(cfg.TEST.batch_size),
        "emd_eps": float(cfg.TEST.emd_eps),
        "emd_iters": int(cfg.TEST.emd_iters),
        "units": {"F-Score": "at 0.01", "ChamferDistance": "x 1000",
                  "EMD": "x 100"},
        "overall": overall,
        "per_batch": per_batch,
        "per_cloud": per_cloud,
        "taxonomy_ids": taxonomy,
        "jax": jax.__version__,
        "host": f"{platform.processor() or platform.machine()}, "
                f"{os.cpu_count()} cores",
        "seconds": time.perf_counter() - t_start,
    }
    path = os.path.join(ROOT, args.out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"overall {overall}; wrote {args.out} in {out['seconds']:.0f} s",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
