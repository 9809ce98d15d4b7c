#!/usr/bin/env python3
"""The JAX package's full-width GRNet eval forward on the CPU, the witness
that chip_smoke.py phase 31 holds the port on the card to (the machine with
the card has no JAX).

    JAX_PLATFORMS=cpu python scripts/port_jax_grnet_witness.py [--out NPZ]

GRNet is built at full width by the port (``chip_smoke.witness_model``:
``define_G`` on grnet.yaml, a 64^3 grid, 2048 sampled and 16384 dense
points; the reference's initialisation drawn on the CPU from a seed,
BatchNorm statistics jittered), carried into the JAX package through
``reference_state_dict`` and its ``convert_grnet_state_dict``, and run there
in eval mode at B=2 on ``chip_smoke.witness_inputs``'s numpy-seeded partial
clouds, its sample drawn from PRNGKey(GRNET_SAMPLE_KEY). The npz (default
docs/artifacts/port/jax_grnet_witness.npz, compressed) holds the sample's
picks (rows of concat(partial, gridding reverse cloud)), the sparse and
dense clouds, each sample's count of non-zero gridding reverse points, and
the sha256 of every weight tensor (``weight_checksums``), so that a card
whose torch draws other numbers from the seed stops with a clear message
instead of comparing other models. About 20 s and 3 GB on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from sparenet_tpu.models import grnet as jax_grnet  # noqa: E402
from sparenet_tpu.utils import torch_import  # noqa: E402
from sparenet_tpu_torch.utils.weights import reference_state_dict  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=chip_smoke.GRNET_WITNESS)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    partial, _ = chip_smoke.witness_inputs()
    model = chip_smoke.witness_model("grnet", "cpu")
    out = {"seed": np.int64(chip_smoke.WITNESS_SEED),
           "checksums": np.array(json.dumps(
               chip_smoke.weight_checksums(model)))}
    variables = torch_import.convert_grnet_state_dict(
        {k: v.numpy() for k, v in reference_state_dict(model).items()},
        strict=True)
    jm = jax_grnet.GRNet(n_sampling_points=model.n_sampling_points,
                         gridding_scale=model.gridding_scale, train=False)
    del model
    kept: dict = {}
    orig = jax_grnet.random_point_sampling

    def sampler(key, pred_cloud, partial_cloud, n_points):
        """``random_point_sampling`` unchanged; its picks (the top-k of its
        scores on its noise) and candidate count kept."""
        res = orig(key, pred_cloud, partial_cloud, n_points)
        cloud = jnp.concatenate([partial_cloud, pred_cloud], axis=1)
        valid = jnp.sum(cloud, axis=-1) != 0.0
        g = jax.vmap(lambda k: jax.random.gumbel(k, valid.shape[1:]))(
            jax.random.split(key, cloud.shape[0]))
        _, idx = jax.lax.top_k(jnp.where(valid, 0.0, -jnp.inf) + g, n_points)
        nonzero = jnp.sum(valid[:, partial_cloud.shape[1]:], axis=1)
        jax.debug.callback(lambda i, n: kept.update(idx=np.array(i),
                                                    n_valid=np.array(n)),
                           idx, nonzero)
        return res
    jax_grnet.random_point_sampling = sampler
    try:
        sparse, dense = jax.jit(lambda v, x: jm.apply(
            v, x, rngs={"sample": jax.random.PRNGKey(
                chip_smoke.GRNET_SAMPLE_KEY)}))(variables, jnp.asarray(partial))
        sparse, dense = np.asarray(sparse), np.asarray(dense)
        jax.effects_barrier()
    finally:
        jax_grnet.random_point_sampling = orig
    out.update(sparse=sparse, dense=dense, idx=kept["idx"].astype(np.int32),
               n_valid=kept["n_valid"].astype(np.int64))
    np.savez_compressed(args.out, **out)
    print(f"GRNet: {time.perf_counter() - t0:.1f} s; valid gridding reverse "
          f"points {out['n_valid'].tolist()}; wrote {args.out}: "
          f"{os.path.getsize(args.out)} bytes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
