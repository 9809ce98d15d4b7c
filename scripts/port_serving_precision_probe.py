"""Serving's quality contract on the trained npz under the JAX package's TPU
arithmetic, emulated, beside the port's own f32 arithmetic; and the inputs
of a CPU witness (``scripts/port_jax_serving_witness.py``).

    python scripts/port_serving_precision_probe.py --out DIR

Needs a CUDA card. On the contract's clouds (``chip_smoke.envelope_data``:
Synthetic VAL, 8 batches of 16) at mml calibration 1.2695, it prints each
serving row's mean F-Score move against parity (dF %, per batch paired) in
three arithmetics:

- ``f32``: the port as it runs;
- ``est``: the mml estimate's distance product at one bf16 pass (operands
  rounded to bf16, products summed in f32), as a TPU runs the JAX
  package's ``mean_mst_length_estimate`` at its default precision, in both
  refine passes;
- ``est+bump``: also the batched rounds' density-update product (the
  coordinates and 2 kde s) at one bf16 pass, as a TPU runs the JAX
  package's ``_mds_batched`` einsums.

It also prints each refine pass's mean mml estimate (f32 and one-pass
bf16) over the first batch, and writes ``witness.npz`` to ``--out`` (a
directory, made if missing): the
first two clouds' MDS inputs of both refine passes (f32 arithmetic), their
mml, the card's picks at G=8192 and S=2048 (sort), and the serving coarse
clouds of the evaluation CLI's first validation batch
(flagship_e8_eval.yaml) with the runner's fitted ratio; and
``contract_coarse.npz``: the contract clouds' coarse output in parity and
in serving mode, and ``probe.json`` with each cloud's F-Score by row.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sparenet_tpu_torch.models import ServingDial, build_generator  # noqa: E402
from sparenet_tpu_torch.ops import expansion_penalty as expansion  # noqa: E402
from sparenet_tpu_torch.ops import mds  # noqa: E402
from sparenet_tpu_torch.ops.common import sqdist3  # noqa: E402
from sparenet_tpu_torch.utils import calibration  # noqa: E402
from sparenet_tpu_torch.utils.metrics import f_score  # noqa: E402

MML = 1.2695
ROWS = (("exact", ServingDial(mds="exact")),
        ("S=2048", ServingDial(mds="batched")),
        ("S=4096", ServingDial(mds="batched", schedule=(4096,))),
        ("G=8192", ServingDial(mds="batched", schedule=())),
        ("hybrid", ServingDial(mds="hybrid")))


def one_pass_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.bfloat16().float()


def estimate_bf16(xyz, primitive_size, calibration=3.18):
    """mean_mst_length_estimate with its product at one bf16 pass."""
    return cs.nn_mean_one_pass_bf16(xyz, primitive_size) * calibration


def bump_bf16(x, s, kde, bias):
    """ops.mds._bump with its product at one bf16 pass."""
    sk = one_pass_bf16((2.0 * kde[..., None]) * s)
    s2k = sqdist3(s) * kde
    xb = one_pass_bf16(x)
    tot = None
    for c0 in range(0, s.shape[1], mds._UPDATE_CHUNK):
        c1 = c0 + mds._UPDATE_CHUNK
        term = torch.bmm(xb, sk[:, c0:c1].transpose(1, 2))
        term.add_(bias[..., None]).sub_(s2k[:, None, c0:c1]).exp2_()
        part = F.threshold_(term, mds._SUBNORMAL_MAX, 0.0).sum(2)
        tot = part if tot is None else tot + part
    return tot


@contextlib.contextmanager
def arithmetic(name: str):
    patches = []
    if name in ("est", "est+bump"):
        patches.append((expansion, "mean_mst_length_estimate", estimate_bf16))
    if name == "est+bump":
        patches.append((mds, "_bump", bump_bf16))
    with cs.patched(*patches):
        yield


@contextlib.contextmanager
def recording(calls: list):
    base = mds.minimum_density_sample_xyz

    def rec(xyz, npoint, mml, *a, **kw):
        calls.append((xyz.clone(), mml.clone()))
        return base(xyz, npoint, mml, *a, **kw)
    with cs.patched((mds, "minimum_density_sample_xyz", rec)):
        yield


@torch.no_grad()
def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    cs.set_parity_mode()
    dev = torch.device("cuda:0")
    print(f"card: {cs.nvidia_smi()}", flush=True)
    t0 = time.perf_counter()
    partial, gt = cs.envelope_data(dev)
    parity = cs.trained_model(dev)
    serving = build_generator(seed=0, device="cpu", serving=True)
    serving.load_state_dict(parity.state_dict())
    serving = serving.to(dev).eval()
    serving.refine.mml_calibration = MML
    par_fc = torch.stack([f_score(cs.complete(parity, partial[i])[2], gt[i])
                          for i in range(cs.ENV_BATCHES)]).double()
    par_f, par_cloud = par_fc.mean(1), par_fc.flatten().tolist()
    # the contract's coarse clouds, the JAX witness's inputs: parity f32,
    # serving bf16-valued (kept as bf16 bit patterns)
    coarse_par = torch.cat([parity.decoder(parity.encoder(partial[i]))
                            for i in range(cs.ENV_BATCHES)])
    coarse_srv = torch.cat([serving.decoder(serving.encoder(partial[i]))
                            for i in range(cs.ENV_BATCHES)])
    if not torch.equal(coarse_srv, one_pass_bf16(coarse_srv)):
        raise SystemExit("serving coarse clouds are not bf16-valued")
    np.savez_compressed(
        os.path.join(args.out, "contract_coarse.npz"),
        parity=coarse_par.cpu().numpy(),
        serving_bf16=coarse_srv.bfloat16().view(torch.int16).cpu().numpy())
    del coarse_par, coarse_srv

    # each refine pass's estimate over the first batch
    calls: list = []
    cs.set_dial(serving, ServingDial(mds="batched", schedule=()))
    with recording(calls):
        cs.complete(serving, partial[0])
    est = {}
    for stage, (xyz, _) in enumerate(calls):
        cloud = xyz[:, :cs.N_OUT]
        s = serving.refine.primitive_size
        est[f"pass{stage + 1}"] = dict(
            f32=float(expansion.mean_mst_length_estimate(cloud, s, 1.0).mean()),
            one_pass_bf16=float(estimate_bf16(cloud, s, 1.0).mean()),
            bf16_valued=bool(torch.equal(cloud, one_pass_bf16(cloud))))
    print(f"mml estimate at calibration 1, first batch: {json.dumps(est)}",
          flush=True)

    table, per_cloud = {}, {"parity": par_cloud}
    for arith in ("f32", "est", "est+bump"):
        for name, dial in ROWS:
            cs.set_dial(serving, dial)
            with arithmetic(arith):
                fc = torch.stack([
                    f_score(cs.complete(serving, partial[i])[2], gt[i])
                    for i in range(cs.ENV_BATCHES)]).double()
            if arith == "f32":
                per_cloud[name] = fc.flatten().tolist()
            f = fc.mean(1)
            rel = (f - par_f) / par_f * 100.0
            table.setdefault(arith, {})[name] = dict(
                df_mean=float(rel.mean()), df_std=float(rel.std(unbiased=False)),
                per_batch=[round(float(v), 3) for v in rel])
            print(f"[{arith:8s}] {name:7s} dF {float(rel.mean()):+.3f} +- "
                  f"{float(rel.std(unbiased=False)):.3f} (per batch "
                  f"{' '.join(f'{v:+.2f}' for v in rel.tolist())})", flush=True)

    # the witness's inputs: the first two clouds, both refine passes
    wit = {}
    for stage, (xyz, mml) in enumerate(calls):
        x, m = xyz[:2].contiguous(), mml[:2].contiguous()
        wit[f"xyz{stage + 1}"] = x.cpu().numpy()
        wit[f"mml{stage + 1}"] = m.cpu().numpy()
        for tag, sched in (("g8192", ()), ("s2048", (2048,))):
            idx = mds.mds_batched(x, cs.N_OUT, m, schedule=sched)
            wit[f"idx{stage + 1}_{tag}"] = idx.cpu().numpy()
    work = tempfile.mkdtemp(prefix="probe_cli_")
    runner = cs.test_cli.build(["--config", cs.EVAL_YAML, "--weights",
                                cs.TRAINED_NPZ, "--workdir", work, "--serving"])
    _, _, _, data = runner.val_loader.first_batch()
    p = torch.from_numpy(data["partial_cloud"]).to(dev)
    coarse = runner.model.decoder(runner.model.encoder(p))
    wit["fit_partial"] = data["partial_cloud"]
    wit["fit_coarse"] = coarse.cpu().numpy()
    wit["fit_ratio"] = np.float64(runner.mml_calibration)
    again = float(calibration.fit_mml_ratio(coarse,
                                            runner.model.refine.primitive_size))
    print(f"the runner's fit {runner.mml_calibration:.6f}, again {again:.6f}",
          flush=True)
    np.savez_compressed(os.path.join(args.out, "witness.npz"), **wit)
    with open(os.path.join(args.out, "probe.json"), "w") as f:
        json.dump(dict(card=cs.nvidia_smi(), mml=MML, estimate=est,
                       parity_f=[float(v) for v in par_f], rows=table,
                       per_cloud_f=per_cloud,
                       runner_fit=runner.mml_calibration), f, indent=1)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
