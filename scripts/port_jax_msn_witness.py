#!/usr/bin/env python3
"""The JAX package's full-width AtlasNet and MSN eval forwards on the CPU,
the witness that chip_smoke.py phase 28 holds the port on the card to (the
machine with the card has no JAX).

    JAX_PLATFORMS=cpu python scripts/port_jax_msn_witness.py [--out NPZ]

Each family is built at full width by the port (``chip_smoke.witness_model``:
``define_G`` on its shipped yaml, 16384 points, 32 primitives, bottleneck
1024; the reference's initialisation drawn on the CPU from a seed, BatchNorm
statistics jittered), carried into the JAX package through
``reference_state_dict`` and its ``convert_atlasnet_state_dict`` /
``convert_msn_state_dict``, and run there in parity mode (eval) at B=2 on
``chip_smoke.witness_inputs`` (numpy-seeded partial clouds and grids). The
npz (default docs/artifacts/port/jax_msn_atlasnet_witness.npz, compressed)
holds AtlasNet's cloud; MSN's coarse cloud, its mml, its MDS picks and
refined cloud and loss_mst; and per family the sha256 of every weight
tensor (``weight_checksums``), so that a card whose torch draws other
numbers from the seed stops with a clear message instead of comparing other
models. About 3 minutes and 4 GB on 8 CPU cores.
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
from sparenet_tpu.models import AtlasNet, MSN  # noqa: E402
from sparenet_tpu.models import msn as jax_msn  # noqa: E402
from sparenet_tpu.utils import torch_import  # noqa: E402
from sparenet_tpu_torch.utils.weights import reference_state_dict  # noqa: E402

JAX = {"atlasnet": (AtlasNet, torch_import.convert_atlasnet_state_dict),
       "msn": (MSN, torch_import.convert_msn_state_dict)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=chip_smoke.MSN_WITNESS)
    args = ap.parse_args(argv)
    partial, grids = chip_smoke.witness_inputs()
    out = {"seed": np.int64(chip_smoke.WITNESS_SEED)}
    for family, (cls, convert) in JAX.items():
        t0 = time.perf_counter()
        model = chip_smoke.witness_model(family, "cpu")
        out[f"{family}_checksums"] = np.array(json.dumps(
            chip_smoke.weight_checksums(model)))
        cfg = chip_smoke.family_config(family)
        variables = convert({k: v.numpy() for k, v in
                             reference_state_dict(model).items()},
                            n_primitives=cfg.NETWORK.n_primitives, strict=True)
        del model
        jm = cls(num_points=cfg.DATASET.n_outpoints, bottleneck_size=1024,
                 n_primitives=cfg.NETWORK.n_primitives, train=False)
        res = jax.jit(jm.apply)(variables, jnp.asarray(partial),
                                jnp.asarray(grids))
        if family == "atlasnet":
            out["atlasnet_out"] = np.asarray(res)
        else:
            coarse, refine, loss_mst = map(np.asarray, res)
            s = chip_smoke.PRIM_S

            @jax.jit
            def picks(coarse):
                _, _, mml = jax_msn.expansion_penalty(coarse, s, 1.5)
                xyz = jnp.concatenate([coarse, jnp.asarray(partial)], 1)
                return mml, jax_msn.minimum_density_sample(
                    xyz, coarse.shape[1], mml)
            mml, idx = map(np.asarray, picks(jnp.asarray(coarse)))
            out.update(msn_coarse=coarse, msn_refine=refine,
                       msn_loss_mst=loss_mst, msn_mml=mml,
                       msn_idx=idx.astype(np.int32))
        print(f"{family}: {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
