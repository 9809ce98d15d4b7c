#!/usr/bin/env python3
"""The JAX package's outputs for SpareNet's other arms, EdgeRes, the SIREN
decoder and FPD, on the CPU: the witness that chip_smoke.py phases 36-38
hold the port on the card to (the machine with the card has no JAX).

    JAX_PLATFORMS=cpu python scripts/port_jax_arms_fpd_witness.py [--out NPZ]

Weights and inputs are the port's, built by chip_smoke's helpers (seeded on
the CPU) and carried into the JAX package:
  (a) and (b): the generator at full width (``chip_smoke.arms_model``: the
      port's sparenet.yaml, 16384 points, 32 primitives, bottleneck and hide
      4096, SE on) with encode=Pointfeat, use_adain=no_share and with
      encode=Residualnet, use_adain=no_use, through ``reference_state_dict``
      and the JAX package's ``convert_netG_state_dict``; its eval forward at
      B=2 on ``chip_smoke.witness_inputs``: the coarse and refined clouds,
      loss_mst, the MDS picks of both refine passes (on the JAX package's own
      coarse and middle clouds) and, for (b), the encoder's four kNN graphs;
  (c) SpareNetRefine with EdgeRes (``chip_smoke.edgeres_refine``), its
      weights carried by ``utils.weights.edgeres_rules`` (the JAX exporter
      has no EdgeRes rule), one pass on (b)'s coarse cloud, and its seven
      kNN graphs;
  (d) one SIREN GridDecoder (``chip_smoke.siren_decoder``, by
      ``utils.weights.sine_decoder_rules``) on ``chip_smoke.siren_inputs``;
  FPD: the canonical classifier's 1808-d activations on
      ``chip_smoke.fpd_clouds``' first set and the JAX package's
      calculate_fpd of its two sets of 60 clouds.
Each weight set's checksums (``chip_smoke.state_checksums``) go with it, so
that a card whose torch draws other numbers from the seed stops with a clear
message. About 10 minutes and 14 GB on 8 CPU cores (the no_share decoders
hold 1.03 billion parameters).
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

import chip_smoke as cs  # noqa: E402
from flax import traverse_util  # noqa: E402
from sparenet_tpu.frechet import fpd as jax_fpd  # noqa: E402
from sparenet_tpu.frechet.pointnet import PointNetCls  # noqa: E402
from sparenet_tpu.models import SpareNetGenerator  # noqa: E402
from sparenet_tpu.models import sparenet as jax_sparenet  # noqa: E402
from sparenet_tpu.models import layers as jax_layers  # noqa: E402
from sparenet_tpu.models.layers import GridDecoder  # noqa: E402
from sparenet_tpu.ops.knn import knn_idx as jax_knn  # noqa: E402
from sparenet_tpu.utils import torch_import  # noqa: E402
from sparenet_tpu_torch.utils import weights  # noqa: E402

JAX_FPD_NPZ = os.path.join(ROOT, "sparenet_tpu", "data", "fpd_cls_canonical.npz")


def to_flax(rules, state: dict) -> dict:
    """A port state_dict -> JAX variables by ``rules`` (the inverse of
    utils.weights._to_torch for the kinds these rules use)."""
    out: dict = {"params": {}, "batch_stats": {}}
    for col, fpath, tkey, kind, stacked in rules.entries:
        assert not stacked
        v = state[tkey].detach().cpu().numpy()
        if kind == "conv2d_w":
            v = v[:, :, 0, 0].T
        elif kind == "conv1d_w":
            v = v[:, :, 0].T
        elif kind == "lin_w":
            v = v.T
        node = out[col]
        for k in fpath[:-1]:
            node = node.setdefault(k, {})
        node[fpath[-1]] = jnp.asarray(np.ascontiguousarray(v, np.float32))
    return out


@jax.jit
def _picks(cloud, partial):
    _, _, mml = jax_sparenet.expansion_penalty(cloud, cs.PRIM_S, 1.5)
    return jax_sparenet.minimum_density_sample(
        jnp.concatenate([cloud, partial], 1), cloud.shape[1], mml)


def arms(partial, out: dict) -> None:
    for arm, kw in cs.ARMS.items():
        t0 = time.perf_counter()
        model = cs.arms_model(arm, "cpu")
        out[f"{arm}_checksums"] = np.array(json.dumps(cs.state_checksums(model)))
        sd = {k: v.numpy() for k, v in
              weights.reference_state_dict(model).items()}
        del model
        variables = torch_import.convert_netG_state_dict(
            sd, use_selayer=True, n_primitives=cs.N_PRIMS, strict=True, **kw)
        del sd
        jm = SpareNetGenerator(num_points=cs.N_OUT, n_primitives=cs.N_PRIMS,
                               bottleneck_size=4096, hide_size=4096,
                               use_selayer=True, train=False, **kw)
        (coarse, middle, refine, loss_mst), inter = jax.jit(
            lambda v, x: jm.apply(v, x, mutable=["intermediates"]))(
                variables, jnp.asarray(partial))
        del variables
        out.update({f"{arm}_coarse": np.asarray(coarse),
                    f"{arm}_refine": np.asarray(refine),
                    f"{arm}_loss_mst": np.asarray(loss_mst)})
        for p, cloud in ((1, coarse), (2, middle)):
            out[f"{arm}_idx{p}"] = np.asarray(
                _picks(cloud, jnp.asarray(partial))).astype(np.int16)
        if kw["encode"] == "Residualnet":
            enc = inter["intermediates"]["encoder"]["EdgeConvResFeat_0"]
            out[f"{arm}_graphs"] = np.stack(
                [np.asarray(enc[f"nbr{i}"][0]) for i in (1, 2, 3, 4)]
            ).astype(np.int16)
        print(f"arm ({arm}) {kw}: {time.perf_counter() - t0:.1f} s", flush=True)


def edgeres(partial, out: dict) -> None:
    """(c), with EdgeRes's seven kNN graphs (recorded in call order by a
    stand-in for the JAX package's get_graph_feature), each row sorted:
    EdgeRes takes a graph as a set (a max over its k slots, and SE's
    mean)."""
    t0 = time.perf_counter()
    refine = cs.edgeres_refine("cpu")
    out["c_checksums"] = np.array(json.dumps(cs.state_checksums(refine)))
    variables = to_flax(weights.edgeres_rules(("EdgeRes_0",), "residual"),
                        refine.state_dict())
    jm = jax_sparenet.SpareNetRefine(num_points=cs.N_OUT,
                                     n_primitives=cs.N_PRIMS, use_selayer=True,
                                     edgeres=True, train=False)
    seen: list = []
    real = jax_layers.get_graph_feature

    def recording(x, k=20, idx=None):
        idx = jax_knn(x, k=k)
        jax.debug.callback(lambda i: seen.append(np.array(i)), idx,
                           ordered=True)
        return real(x, k, idx)
    jax_layers.get_graph_feature = recording
    try:
        got, loss_mst = jax.jit(jm.apply)(
            variables, jnp.asarray(out["b_coarse"]), jnp.asarray(partial))
        jax.effects_barrier()
    finally:
        jax_layers.get_graph_feature = real
    assert len(seen) == 7, len(seen)
    out["c_refine"], out["c_loss_mst"] = np.asarray(got), np.asarray(loss_mst)
    out["c_graphs"] = np.sort(np.stack(seen), -1).astype(np.int16)
    print(f"EdgeRes refine: {time.perf_counter() - t0:.1f} s", flush=True)


def siren(out: dict) -> None:
    dec = cs.siren_decoder("cpu")
    out["d_checksums"] = np.array(json.dumps(cs.state_checksums(dec)))
    state = {k[len("0.dec."):]: v for k, v in dec.reference_state("").items()
             if ".adain." not in k and "adain" not in k.split(".")[2]}
    variables = to_flax(weights.sine_decoder_rules(troot=""), state)
    grid, ap = cs.siren_inputs()
    x = np.broadcast_to(grid, (ap.shape[0],) + grid.shape)
    jm = GridDecoder(bottleneck_size=cs.SIREN_WIDTH, use_sine=True, train=False)
    out["d_out"] = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x),
                                                jnp.asarray(ap)))


def fpd(out: dict) -> None:
    t0 = time.perf_counter()
    flat = dict(np.load(JAX_FPD_NPZ))
    variables = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    one, s1, s2 = cs.fpd_clouds()
    model = PointNetCls(k=16, train=False)
    out["fpd_actv"] = np.asarray(jax.jit(model.apply)(variables,
                                                      jnp.asarray(one))[2])
    out["fpd_value"] = np.float64(jax_fpd.calculate_fpd(
        s1, s2, variables=variables, batch_size=cs.FPD_BATCH))
    print(f"FPD: {float(out['fpd_value'])!r}, {time.perf_counter() - t0:.1f} s",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=cs.ARMS_WITNESS)
    args = ap.parse_args(argv)
    partial, _ = cs.witness_inputs()
    out = {"seed": np.int64(cs.WITNESS_SEED)}
    fpd(out)
    siren(out)
    arms(partial, out)
    edgeres(partial, out)
    cs.save_witness(args.out, out)
    print(f"wrote {args.out}: {os.path.getsize(args.out)} bytes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
