"""The JAX package, on the CPU, as a second witness of the port's serving
path on the trained npz: its batched MDS rounds, its mml fit, and the
serving contract's rows from the port's coarse clouds on.

    python scripts/port_jax_serving_witness.py PROBE_DIR \
        [--weights docs/artifacts/r5/flagship_e8_bf16.npz] [--jobs 3] \
        [--out docs/artifacts/port/jax_serving_witness.json]

``PROBE_DIR`` holds what ``scripts/port_serving_precision_probe.py`` writes
on the card: ``witness.npz`` (the first two contract clouds' MDS inputs of
both refine passes with their mml at calibration 1.2695, the card's picks
at G=8192 and S=2048, "sort"; the serving coarse clouds of the evaluation
CLI's first validation batch with the runner's fitted ratio) and
``contract_coarse.npz`` (the contract clouds' coarse output, parity and
serving, on the card).

1. For each cloud and refine pass it runs the JAX package's
   ``_mds_batched`` (the same round plan and selection) and the port's
   ``mds_batched`` on the CPU, and counts the picks in which each differs
   from the card's (as sets and in order).
2. The JAX package's ``fit_mml_ratio`` (Prim's mml over the NN-mean
   estimate) on the first validation batch's serving coarse clouds, beside
   the runner's fit on the card.
3. The contract (docs/SERVING_ENVELOPE.md section 7; Synthetic VAL, 8
   batches of 16, calibration 1.2695): from each cloud's coarse output on
   the card, the JAX package's own refine passes, MDS and F-Score@0.01, in
   parity mode and in serving mode on each row's dial (exact greedy, S=2048,
   S=4096, G=8192, hybrid), one cloud a call, in ``--jobs`` worker
   processes, and each row's per-batch paired F-Score move against parity.
   The encoder and decoder are the port's (their serving forward is held to
   the JAX package's in tests/test_torch_port_serving*.py); everything after
   them is the JAX package's.

CPU only: about 4 GB a worker.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MML = 1.2695
NPOINT, N_BATCHES, BATCH = 16384, 8, 16
# (row, FAST_MATH, SPARENET_MDS_IMPL, _SCHEDULE); G 8192, "sort" throughout
ROWS = (("parity", False, "auto", ()),
        ("exact", True, "xla", ()),
        ("S=2048", True, "batched", (2048,)),
        ("S=4096", True, "batched", (4096,)),
        ("G=8192", True, "batched", ()),
        ("hybrid", True, "hybrid", ()))

_WORKER: dict = {}


def _init_worker(weights: str, coarse_npz: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from sparenet_tpu.configs.defaults import default_config
    from sparenet_tpu.data.datasets import VAL, SyntheticDataset
    from sparenet_tpu.utils.ckpt_npz import load_npz

    cfg = default_config()
    cfg.DATASET.n_outpoints = NPOINT
    cfg.CONST.n_input_points = 3000
    cfg.DATASETS.synthetic.n_val = N_BATCHES * BATCH
    c = np.load(coarse_npz)
    srv = (c["serving_bf16"].astype(np.uint16).astype(np.uint32)
           << np.uint32(16)).view(np.float32)
    _WORKER.update(variables=jax.device_put(load_npz(weights)),
                   data=SyntheticDataset(cfg, VAL), parity=c["parity"],
                   serving=srv, fns={})


def _forward(row):
    """The jitted two refine passes of one row (traced once a worker)."""
    import jax

    from sparenet_tpu.models import SpareNetGenerator
    from sparenet_tpu.ops import common as opc
    from sparenet_tpu.ops import mds as jmds
    from sparenet_tpu.utils.metrics import f_score

    name, fast, impl, sched = row
    if name in _WORKER["fns"]:
        return _WORKER["fns"][name]
    model = SpareNetGenerator(
        num_points=NPOINT, n_primitives=32, bottleneck_size=4096,
        hide_size=4096, use_selayer=True, use_adain="share",
        encode="Residualnet", train=False, mml_calibration=MML)

    def two_pass(m, coarse, partial):
        middle, _ = m.refine(coarse, partial)
        return m.refine(middle, partial)[0]

    def fn(v, coarse, partial, gt):
        out = model.apply(v, coarse, partial, method=two_pass)
        return f_score(out, gt)

    # the dial is read when the function is traced: trace it now
    opc.set_fast_math(fast)
    saved = (jmds._MDS_IMPL, jmds._MDS_BATCH_G, jmds._MDS_SCHEDULE,
             jmds._MDS_SELECT)
    jmds._MDS_IMPL, jmds._MDS_BATCH_G = impl, 8192
    jmds._MDS_SCHEDULE, jmds._MDS_SELECT = sched, "sort"
    try:
        d = _WORKER["data"][0][3]
        coarse = _WORKER["parity"][:1]
        jitted = jax.jit(fn).lower(
            _WORKER["variables"], coarse, d["partial_cloud"][None],
            d["gtcloud"][None]).compile()
    finally:
        opc.set_fast_math(False)
        (jmds._MDS_IMPL, jmds._MDS_BATCH_G, jmds._MDS_SCHEDULE,
         jmds._MDS_SELECT) = saved
    _WORKER["fns"][name] = jitted
    return jitted


def _run_cloud(item):
    """(row, cloud, F-Score) of one cloud in one row."""
    import numpy as np

    row, i = item
    d = _WORKER["data"][i][3]
    coarse = _WORKER["parity" if not row[1] else "serving"][i:i + 1]
    f = _forward(row)(_WORKER["variables"], coarse, d["partial_cloud"][None],
                      d["gtcloud"][None])
    return row[0], i, float(np.asarray(f)[0])


def picks_and_fit(w):
    """Parts 1 and 2: the batched rounds against the card, and the fit."""
    import jax.numpy as jnp
    import numpy as np
    import torch

    from sparenet_tpu.ops import mds as jmds
    from sparenet_tpu.utils.calibration import fit_mml_ratio
    from sparenet_tpu_torch.ops import mds as tmds

    rounds = {}
    for stage in (1, 2):
        xyz, mml = w[f"xyz{stage}"], w[f"mml{stage}"]
        for tag, sched in (("g8192", ()), ("s2048", (2048,))):
            card = w[f"idx{stage}_{tag}"]
            for c in range(xyz.shape[0]):
                x, m = xyz[c:c + 1], mml[c:c + 1]
                j = np.asarray(jmds._mds_batched(
                    jnp.asarray(x), NPOINT, jnp.asarray(m), g=8192,
                    schedule=sched, select="sort"))[0]
                p = tmds.mds_batched(torch.from_numpy(x), NPOINT,
                                     torch.from_numpy(m), g=8192,
                                     schedule=sched).numpy()[0]
                k = card[c]
                row = dict(
                    jax_vs_card_order=int((j != k).sum()),
                    jax_vs_card_set=int(NPOINT - len(np.intersect1d(j, k))),
                    port_cpu_vs_jax_order=int((p != j).sum()),
                    port_cpu_vs_card_order=int((p != k).sum()))
                rounds[f"pass{stage} {tag} cloud{c}"] = row
                print(f"pass {stage} {tag} cloud {c} (mml {float(m[0]):.6f}): "
                      f"{row}", flush=True)
    ratio = float(fit_mml_ratio(jnp.asarray(w["fit_coarse"]), 512))
    card = float(w["fit_ratio"])
    print(f"fit_mml_ratio on the first validation batch's serving coarse "
          f"clouds: JAX (CPU) {ratio:.6f}, the port's runner on the card "
          f"{card:.6f}", flush=True)
    return rounds, dict(jax_cpu=ratio, port_card=card,
                        abs_diff=abs(ratio - card),
                        clouds=int(w["fit_coarse"].shape[0]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("probe_dir")
    ap.add_argument("--weights",
                    default="docs/artifacts/r5/flagship_e8_bf16.npz")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out",
                    default="docs/artifacts/port/jax_serving_witness.json")
    args = ap.parse_args()
    os.environ.pop("SPARENET_FAST_MATH", None)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    t0 = time.perf_counter()
    w = np.load(os.path.join(args.probe_dir, "witness.npz"))
    rounds, fit = picks_and_fit(w)

    n = N_BATCHES * BATCH
    f = {name: np.zeros(n) for name, *_ in ROWS}
    items = [(row, i) for row in ROWS for i in range(n)]
    with ProcessPoolExecutor(
            args.jobs, mp_context=mp.get_context("spawn"),
            initializer=_init_worker,
            initargs=(os.path.join(ROOT, args.weights),
                      os.path.join(args.probe_dir, "contract_coarse.npz"))
    ) as pool:
        for k, (name, i, v) in enumerate(pool.map(_run_cloud, items)):
            f[name][i] = v
            if (k + 1) % BATCH == 0:
                print(f"{name} batch {i // BATCH}: F "
                      f"{f[name][i - BATCH + 1:i + 1].mean():.4f} "
                      f"({time.perf_counter() - t0:.0f} s)", flush=True)
    per_batch = {k: v.reshape(N_BATCHES, BATCH).mean(1) for k, v in f.items()}
    rows = {}
    for name, *_ in ROWS:
        rel = (per_batch[name] - per_batch["parity"]) / per_batch["parity"] * 100
        rows[name] = dict(f_mean=float(per_batch[name].mean()),
                          df_mean=float(rel.mean()), df_std=float(rel.std()),
                          per_batch_df=[float(v) for v in rel],
                          per_cloud_f=[float(v) for v in f[name]])
        print(f"{name}: F {per_batch[name].mean():.4f}, dF {rel.mean():+.3f} "
              f"+- {rel.std():.3f}", flush=True)
    out = dict(
        what="the JAX package on the CPU on the port's trained serving "
             "inputs (scripts/port_serving_precision_probe.py, on the card): "
             "batched MDS picks differing from the card's, the mml fit, and "
             "the contract's rows from the card's coarse clouds on",
        weights=args.weights, mml_calibration=MML, rounds=rounds, fit=fit,
        contract=rows, jax=jax.__version__,
        seconds=time.perf_counter() - t0)
    path = os.path.join(ROOT, args.out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {args.out} in {out['seconds']:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
