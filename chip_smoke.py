#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sparenet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a flushed line with its elapsed seconds:
  0. the device: name, count, and nvidia-smi's name and power limit;
  1. the build: one nvcc call over all csrc/*.cu into sparenet_tpu_torch/_build/
     (gitignored), its seconds and the -Xptxas -v register/shared-memory lines;
  2. each kernel against its plain PyTorch version on random inputs at the
     shapes the flagship forward gives it (B=4);
  3. the main path: the flagship SpareNet eval forward (3000 -> 16384 points,
     full widths, seeded random weights with jittered BatchNorm statistics)
     at B=4, with every launch count set to 0 just before and read just
     after; every kernel launched, no plain version ran;
  4. each kernel on the very inputs the main path gave it: its outputs there
     against the plain version's, and kernel, plain and library times summed
     over the forward's calls (the numbers of the kernels line);
  5. the forward against plain forwards: free-running (every op plain), and
     anchored (the plain forward replays the kernel kNN graphs checked in
     phase 4, so that only reassociation separates the two); two controls
     show that the anchored check fails when one op is perturbed;
  6. at B=32, bench.py's batch: clouds/s by CUDA events, and one
     torch.profiler forward (device time by kernel group, busy share);
  7. each training kernel (chamfer NN, auction bids, edge-stats forward and
     backward) against its plain version on random inputs at the shapes the
     flagship training step gives it, ties included;
  8. the second main path: one flagship training step (the same model and
     widths, EMD + consistency-Chamfer loss, Adam) at B=4 through
     ``runners.sparenet.train_step``, counts set to 0 just before and read
     just after: every kernel of the step launched, no plain version ran;
  9. each training kernel on the very inputs the step gave it: outputs
     against the plain version's, kernel, plain and library times summed
     over the step's calls;
 10. the kernel step against a plain step on the card that replays its kNN
     graphs and MDS picks, both in deterministic mode: loss and every
     gradient leaf, and two perturbed-op controls the check must catch;
 11. training throughput: steps at B=24 (sparenet.yaml's batch, or the
     largest that fits), clouds/s, peak memory, one profiled step.
The output ends with one JSON line of per-kernel numbers, the card's name and
power limit, and {"ok": true, "device": {...}} as the last line. Any failed
phase exits non-zero without that line. No CUDA device: exit 2.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import signal
import subprocess
import sys
import time

import torch

from sparenet_tpu_torch.models import (N_INPUT_POINTS, build_generator,
                                       complete, set_parity_mode)
from sparenet_tpu_torch.ops import _lib
from sparenet_tpu_torch.ops import chamfer as chamfer_op
from sparenet_tpu_torch.ops import (edge_gather, emd, expansion_penalty,
                                    gather, knn, mds)
from sparenet_tpu_torch.ops.common import pairwise_sqdist_graph, sqdist3
from sparenet_tpu_torch.runners import base as train_base
from sparenet_tpu_torch.runners import sparenet as train_runner

T0 = time.perf_counter()
TIME_LIMIT_S = 1150          # the whole script, build included
B_CHECK, B_BENCH = 4, 32
B_TRAIN = train_runner.CONFIG["batch_size"]   # 24, sparenet.yaml
K = 8
# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32
# (non-tensor) and bf16 tensor-core flop/s.
HBM_BPS, FP32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
KNN_WIDTHS = (3, 256, 512)             # encoder stage inputs (256 twice)
GATHER_WIDTHS = (256, 1024)            # encoder stage outputs
PRIM_S, N_PRIMS, N_OUT = 512, 32, 16384
# Free-running forward (kernels vs every op plain): coarse differs where a
# kNN near-tie picks another neighbour. Limits: 5x the coarse max abs
# (8.0e-6) and about 40x the middle/refine Chamfer (2.3e-9) of the runs on
# an H100 80GB HBM3 at 700 W.
FREE_COARSE_ATOL, FREE_CHAMFER = 4e-5, 1e-7
# Anchored forward (the plain forward replays the kernel kNN graphs): only
# the SE sums' reassociation separates the two. Readings on that card:
# encoder stage features equal, coarse max abs 7.2e-8, middle/refine
# Chamfer 8.0e-16 (MDS picks swap among coincident points); a perturbed op
# moves the features by 0.14 and coarse by 3.9e-4 (the script's controls).
ANCHOR_FEAT_ATOL, ANCHOR_COARSE_ATOL, ANCHOR_CHAMFER = 1e-6, 1e-6, 1e-13
FAILURES: list[str] = []


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    log(f"FAIL: {msg}")


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not available"
    except (OSError, subprocess.SubprocessError):
        return "not available"


# The model calls each op through its module attribute, so swapping the
# attribute reroutes the forward.
OPS = {"knn": (knn, "knn_idx"),
       "gather_max": (gather, "gather_max"),
       "expansion": (expansion_penalty, "mst_charges"),
       "mds": (mds, "minimum_density_sample"),
       "nn_idx": (chamfer_op, "nn_idx"),
       "emd_bids": (emd, "emd_bids"),
       "edge_stats_fwd": (edge_gather, "edge_stats_fwd"),
       "edge_stats_bwd": (edge_gather, "edge_stats_bwd")}
EVAL_OPS = ("knn", "gather_max", "expansion", "mds")
TRAIN_OPS = ("nn_idx", "emd_bids", "edge_stats_fwd", "edge_stats_bwd")
KERNEL = {name: getattr(*OPS[name]) for name in OPS}
PLAIN = {"knn": lambda x, k=8: knn.knn_plain(x, k),
         "gather_max": gather.gather_max_plain,
         "expansion": expansion_penalty.mst_charges_plain,
         "mds": mds.mds_plain,
         "nn_idx": chamfer_op.nn_idx_plain,
         "emd_bids": emd.emd_bids_plain,
         "edge_stats_fwd": edge_gather.edge_stats_fwd_plain,
         "edge_stats_bwd": edge_gather.edge_stats_bwd_plain}


@contextlib.contextmanager
def swapped(**fns):
    """Route the named ops to other functions; restored on exit."""
    saved = {name: getattr(*OPS[name]) for name in fns}
    for name, fn in fns.items():
        setattr(*OPS[name], fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(*OPS[name], fn)


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    if isinstance(v, tuple):
        return tuple(_clone(x) for x in v)
    return v


def recording(calls: dict):
    """Wrappers of the ops now installed that append (args, kwargs, output),
    cloned, to calls[name]; pass them to ``swapped``."""
    def wrap(name, fn):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            calls.setdefault(name, []).append((_clone(args), kw, _clone(out)))
            return out
        return rec
    return {name: wrap(name, getattr(*OPS[name])) for name in OPS}


def chamfer(a: torch.Tensor, b: torch.Tensor) -> float:
    """max over the batch of mean NN sq-distance both ways (the parity
    contract's Chamfer distance), exact fp32 differences."""
    worst = 0.0
    for i in range(a.shape[0]):
        d = torch.cdist(a[i].double(), b[i].double()) ** 2
        worst = max(worst, float(d.min(1)[0].mean() + d.min(0)[0].mean()))
    return worst


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# comparisons of one call, kernel against plain; each returns
# (ok, max_abs_err, message)
# ---------------------------------------------------------------------------

def compare_knn(x, got, want):
    """Index mismatches are acceptable only at near-ties: a distance gap
    within 1e-5 of |x|^2 + |y|^2 (the two sum the same terms in another
    order)."""
    got, want = got.long(), want.long()
    d = pairwise_sqdist_graph(x, x)
    gap = (d.gather(2, got) - d.gather(2, want)).abs()
    x2 = (x * x).sum(-1)
    b = x.shape[0]
    scale = x2[:, :, None] + x2.gather(1, want.reshape(b, -1)).reshape(want.shape)
    mism = got != want
    n_far = int((mism & (gap > 1e-5 * scale)).sum())
    err = float(gap.max())
    return (n_far == 0, err,
            f"{int(mism.sum())} index mismatches of {got.numel()}, {n_far} "
            f"beyond the near-tie envelope; max distance gap {err:.3e}")


def compare_gather(table, idx, got, want):
    """max bitwise; the sum reassociates: rtol 1e-5, plus 1e-6 of the sum
    of |rows| for cancellation in a sum of 24000 terms of either sign."""
    (out, s), (pout, ps) = got, want
    exact = torch.equal(out, pout)
    abs_sum = gather.gather_rows(table.abs(), idx).sum((1, 2))
    err = (s - ps).abs()
    sum_ok = bool((err <= 1e-5 * ps.abs() + 1e-6 * abs_sum).all())
    e = float(err.max())
    return (exact and sum_ok, e,
            f"max exact={exact}; sum max abs err {e:.3e}, within "
            f"tolerance={sum_ok}")


def compare_expansion(got, want):
    """parent and charged exact; cost to atol 1e-6."""
    (par, cost, chg), (ppar, pcost, pchg) = got, want
    e = float((cost - pcost).abs().max())
    pe, ce = torch.equal(par, ppar), torch.equal(chg, pchg)
    return (pe and ce and e <= 1e-6, e,
            f"parent exact={pe}, charged exact={ce}, cost max abs err {e:.3e}")


def mds_density_gap(xyz, mml, picks, step, a, b):
    """Plain densities after ``step`` picks (replaying ``picks``), and the
    gap between candidates a and b at that step, for one cloud [N, 3]."""
    n = xyz.shape[0]
    t = 5.0 * mml * mml
    weight = torch.where(torch.arange(n, device=xyz.device) >= 8192, 2.0, 1.0)
    temp = torch.zeros(n, device=xyz.device)
    temp[0] = 1e9
    last = 0
    for j in range(1, step + 1):
        d2 = sqdist3(xyz - xyz[last])
        e = torch.exp(-d2 / t)
        temp = temp + weight * torch.where(e < torch.finfo(torch.float32).tiny, 0.0, e)
        if j < step:
            last = int(picks[j])
            temp[last] = 1e9
    return float(temp[a]), float(temp[b])


def compare_mds(xyz, mml, got, want):
    """Indices exact; where they diverge, the first divergent step must be
    a near-tie of the densities (1e-6 relative)."""
    n_mis = int((got != want).sum())
    ok, notes = True, []
    for bi in range(got.shape[0]):
        bad = torch.nonzero(got[bi] != want[bi])
        if len(bad):
            j = int(bad[0])
            ta, tb = mds_density_gap(xyz[bi], mml[bi], want[bi].cpu(), j,
                                     int(got[bi, j]), int(want[bi, j]))
            near = abs(ta - tb) <= 1e-6 * max(abs(ta), abs(tb))
            ok = ok and near
            notes.append(f"cloud {bi} first diverges at step {j}: kernel "
                         f"{int(got[bi, j])} density {ta!r}, plain "
                         f"{int(want[bi, j])} density {tb!r} "
                         f"({'near-tie' if near else 'NOT a near-tie'})")
    err = float((got - want).abs().max())
    return ok, err, "; ".join([f"{n_mis} index mismatches of {got.numel()}"] + notes)


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version, random inputs
# ---------------------------------------------------------------------------

def check_random(gen, dev) -> dict:
    """Returns each kernel's largest error over its checks."""
    errs = dict.fromkeys(OPS, 0.0)

    def verdict(name, what, res):
        ok, err, msg = res
        errs[name] = max(errs[name], err)
        log(f"  {name} {what}: {msg}")
        if not ok:
            fail(f"{name} {what}: kernel differs from the plain version")

    n = N_INPUT_POINTS
    for c in KNN_WIDTHS:
        x = (torch.rand(B_CHECK, n, c, generator=gen) - 0.5 if c == 3 else
             torch.randn(B_CHECK, n, c, generator=gen)).to(dev)
        verdict("knn", f"C={c}", compare_knn(x, knn.knn_idx(x, K),
                                             knn.knn_plain(x, K)))
    for c in GATHER_WIDTHS:
        table = torch.randn(B_CHECK, n, c, generator=gen).to(dev)
        idx = torch.randint(0, n, (B_CHECK, n, K), generator=gen,
                            dtype=torch.int32).to(dev)
        verdict("gather_max", f"C={c}", compare_gather(
            table, idx, gather.gather_max(table, idx, need_sum=True),
            gather.gather_max_plain(table, idx, need_sum=True)))
    xyz = (torch.rand(B_CHECK * N_PRIMS, PRIM_S, 3, generator=gen) * 2 - 1).to(dev)
    verdict("expansion", f"{list(xyz.shape)}", compare_expansion(
        expansion_penalty.mst_charges(xyz),
        expansion_penalty.mst_charges_plain(xyz)))
    coarse = (torch.rand(B_CHECK, N_OUT, 3, generator=gen) - 0.5).to(dev)
    partial = (torch.rand(B_CHECK, n, 3, generator=gen) - 0.5).to(dev)
    _, _, mml = expansion_penalty.expansion_penalty(coarse, PRIM_S, 1.5)
    xyz = torch.cat([coarse, partial], 1).contiguous()
    verdict("mds", f"{list(xyz.shape)} -> {N_OUT}", compare_mds(
        xyz, mml, mds.minimum_density_sample(xyz, N_OUT, mml),
        mds.mds_plain(xyz, N_OUT, mml)))
    return errs


# ---------------------------------------------------------------------------
# phase 4: each kernel on the inputs the main path gave it, timed
# ---------------------------------------------------------------------------

def _library_knn(x, k=8):
    return torch.topk(torch.cdist(x, x), k, largest=False)


def _library_gather(table, idx, need_sum=False):
    g = gather.gather_rows(table, idx)
    return g.amax(2), g.sum((1, 2))


# name: (library call or None, kernel reps, comparison, bound)
SPECS = {
    "knn": (_library_knn, 5,
            lambda a, got, want: compare_knn(a[0], got, want),
            lambda a, out: bound(4 * (a[0].numel() + out.numel()),
                                 6.0 * a[0].numel() * a[0].shape[1], BF16_FLOPS)),
    "gather_max": (_library_gather, 20,
                   lambda a, got, want: compare_gather(a[0], a[1], got, want),
                   lambda a, out: bound(
                       4 * (a[0].numel() + a[1].numel() + out[0].numel()
                            + out[1].numel()),
                       2.0 * a[1].numel() * a[0].shape[2], FP32_FLOPS)),
    # Prim's steps only: (S-1) steps x S vertices x ~9 flops (3 sub, 3
    # mul/fma, sqrt, compare, select); the pruning rounds are not counted
    "expansion": (None, 10,
                  lambda a, got, want: compare_expansion(got, want),
                  lambda a, out: bound(
                      4 * (a[0].numel() + 3 * a[0].shape[0] * a[0].shape[1]),
                      9.0 * a[0].shape[0] * (a[0].shape[1] - 1) * a[0].shape[1],
                      FP32_FLOPS)),
    # per step and point: 3 sub, 3 mul/fma, div, exp, flush, mul, add,
    # compare ~ 12 operations
    "mds": (None, 3,
            lambda a, got, want: compare_mds(a[0], a[2], got, want),
            lambda a, out: bound(4 * (a[0].numel() + a[2].numel() + out.numel()),
                                 12.0 * a[0].shape[0] * (a[1] - 1) * a[0].shape[1],
                                 FP32_FLOPS)),
}


# --- the training kernels: comparisons (exact: both versions round alike)


def compare_exact(got, want):
    """Every output bit for bit (torch.equal; -0 equals +0)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    same = [torch.equal(g, w) for g, w in zip(got, want)]
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    n_bad = sum(int((g != w).sum()) for g, w in zip(got, want))
    return (all(same), err, f"outputs exact={all(same)}, {n_bad} elements differ, "
            f"max abs err {err:.3e}")


def _library_nn(x1, x2):
    return torch.cdist(x1, x2).argmin(-1)


def _library_bids(x1, x2, price):
    return ((3.0 - price)[:, None, :] - torch.cdist(x1, x2)).topk(2, -1)


def _library_stats_fwd(table, idx):
    g = gather.gather_rows(table, idx)
    return g.amax(2), g.amin(2), g.sum(2), (g * g).sum(2)


def _library_stats_bwd(table, idx, *rest):
    """A gather of the k rows of every point and one index_add_ of them
    back into [B*N, C]: the scatter the kernel replaces, at its shapes."""
    b, n, c = table.shape
    tgt = (idx.long() + n * torch.arange(b, device=idx.device)[:, None, None]).reshape(-1)
    con = gather.gather_rows(table, idx).reshape(-1, c)
    return torch.zeros(b * n, c, device=table.device).index_add_(0, tgt, con)


# bytes each input read once, each output written once; operations per
# (query, candidate) pair or per gathered element, at the fp32 peak
SPECS.update({
    # 3 sub, 1 mul, 2 fma (4 flops), 1 compare per pair
    "nn_idx": (_library_nn, 5, lambda a, got, want: compare_exact(got, want),
               lambda a, out: bound(
                   4 * (a[0].numel() + a[1].numel() + out.numel()),
                   8.0 * a[0].shape[0] * a[0].shape[1] * a[1].shape[1],
                   FP32_FLOPS)),
    # as nn_idx plus the square root, a subtraction and a second compare
    "emd_bids": (_library_bids, 3, lambda a, got, want: compare_exact(got, want),
                 lambda a, out: bound(
                     4 * (a[0].numel() + a[1].numel() + a[2].numel()
                          + 2 * out[0].numel()),
                     11.0 * a[0].shape[0] * a[0].shape[1] * a[1].shape[1],
                     FP32_FLOPS)),
    # max, min, add, fma (2) per gathered element
    "edge_stats_fwd": (_library_stats_fwd, 10,
                       lambda a, got, want: compare_exact(got, want),
                       lambda a, out: bound(
                           4 * (a[0].numel() + a[1].numel() + 4 * out[0].numel()),
                           5.0 * a[1].numel() * a[0].shape[2], FP32_FLOPS)),
    # fma (2), two adds and the accumulation per (m, j, c)
    "edge_stats_bwd": (_library_stats_bwd, 5,
                       lambda a, got, want: compare_exact(got, want),
                       lambda a, out: bound(
                           4 * (a[0].numel() + a[1].numel()
                                + sum(t.numel() for t in a[2:]) + out.numel()),
                           5.0 * a[1].numel() * a[0].shape[2], FP32_FLOPS)),
})


# ---------------------------------------------------------------------------
# phase 7: the training kernels against their plain versions, random inputs
# ---------------------------------------------------------------------------

def _dup_cloud(gen, b, n):
    """Every point twice (exact distance ties)."""
    half = torch.rand(b, n // 2, 3, generator=gen) - 0.5
    return torch.cat([half, half.flip(1)], 1)


def check_random_train(gen, dev) -> dict:
    """Returns each training kernel's largest error over its checks."""
    errs = dict.fromkeys(TRAIN_OPS, 0.0)

    def verdict(name, what, res):
        ok, err, msg = res
        errs[name] = max(errs[name], err)
        log(f"  {name} {what}: {msg}")
        if not ok:
            fail(f"{name} {what}: kernel differs from the plain version")

    b = B_CHECK
    for what, x2 in (("random", torch.rand(b, N_OUT, 3, generator=gen) - 0.5),
                     ("duplicated points", _dup_cloud(gen, b, N_OUT))):
        x1 = (torch.rand(b, N_OUT, 3, generator=gen) - 0.5).to(dev)
        x2 = x2.to(dev)
        verdict("nn_idx", f"[{b}, {N_OUT}] x [{b}, {N_OUT}] {what}", compare_exact(
            chamfer_op.nn_idx(x1, x2), chamfer_op.nn_idx_plain(x1, x2)))
        price = torch.rand(b, N_OUT, generator=gen) * 0.02
        if what != "random":        # duplicates priced alike: tied bids
            price[:, N_OUT // 2:] = price[:, :N_OUT // 2].flip(1)
        price = price.to(dev)
        verdict("emd_bids", f"[{b}, {N_OUT}] x [{b}, {N_OUT}] {what}", compare_exact(
            emd.emd_bids(x1, x2, price), emd.emd_bids_plain(x1, x2, price)))
    n = N_INPUT_POINTS
    for c in (256, 1024):
        table = torch.randn(b, n, c, generator=gen)
        table[:, 1] = table[:, 0]                   # equal rows
        idx = torch.randint(0, n, (b, n, K), generator=gen, dtype=torch.int32)
        idx[:, :, K - 1] = idx[:, :, 0]             # equal slots
        idx[:, :4] = torch.arange(K, dtype=torch.int32) % 2
        table, idx = table.to(dev), idx.to(dev)
        outs = edge_gather.edge_stats_fwd(table, idx)
        verdict("edge_stats_fwd", f"C={c}", compare_exact(
            outs, edge_gather.edge_stats_fwd_plain(table, idx)))
        grads = [torch.randn(b, n, c, generator=gen).to(dev) for _ in range(4)]
        verdict("edge_stats_bwd", f"C={c}", compare_exact(
            edge_gather.edge_stats_bwd(table, idx, outs[0], outs[1], *grads),
            edge_gather.edge_stats_bwd_plain(table, idx, outs[0], outs[1], *grads)))
    return errs


# ---------------------------------------------------------------------------
# phases 8-11: the flagship training step
# ---------------------------------------------------------------------------

TRAIN_EXPECTED = ("knn", "expansion", "mds", "nn_idx", "emd_bids",
                  "edge_stats_fwd", "edge_stats_bwd")
# Kernel step against the anchored plain step, both in deterministic mode.
# Every kernel equals its plain version bit for bit and the plain step
# replays the kNN graphs and MDS picks, so the two are expected to agree
# exactly; the limits leave room for reassociation only. Each gradient leaf
# is compared in relative L2 norm; leaves whose exact gradient is 0
# (biases ahead of a normalisation) are compared in absolute norm.
STEP_LOSS_RTOL, STEP_GRAD_REL, STEP_ZERO_ABS = 1e-6, 1e-5, 1e-6
ZERO_GRAD = ({"encoder.linear.bias", "refine.residual.bn3.bias"}
             | {f"decoder.decoder.conv{i}.bias" for i in (1, 2, 3)}
             | {f"refine.residual.conv{i}.bias" for i in range(1, 7)})


def train_batch(gen, b: int):
    """Seeded clouds: gt 16384 points on an ellipsoid with random axes in
    [0.1, 0.45] and a random centre, with a little noise; partial 3000
    points of its upper side, drawn apart from gt's."""
    v = torch.randn(b, 2 * N_OUT, 3, generator=gen)
    v = v / v.norm(dim=-1, keepdim=True)
    v = (v * (0.1 + 0.35 * torch.rand(b, 1, 3, generator=gen))
         + 0.1 * torch.rand(b, 1, 3, generator=gen) - 0.05)
    v = v + 0.005 * torch.randn(v.shape, generator=gen)
    gt = v[:, :N_OUT]
    rest = v[:, N_OUT:]
    order = torch.argsort(-rest[..., 2], dim=1)[:, :N_INPUT_POINTS]
    partial = torch.gather(rest, 1, order[..., None].expand(-1, -1, 3))
    return partial.contiguous(), gt.contiguous()


def snapshot(model) -> dict:
    return copy.deepcopy(model.state_dict())


def fresh_model(state: dict, dev):
    """A model holding ``state`` on the card, and a new Adam over it."""
    model = build_generator(seed=0, device="cpu").to(dev)
    model.load_state_dict(state)
    return model, train_base.make_optimizer(model, train_runner.CONFIG)


def run_step(model, opt, partial, gt):
    loss = train_runner.train_step(model, opt, partial, gt,
                                   train_runner.CONFIG["learning_rate"])
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return [float(v) for v in loss], grads


def step_gaps(a, b):
    """(loss rel gap, largest relative-L2 gap of a gradient leaf, largest
    norm of a ZERO_GRAD leaf's gap, name of the worst leaf)."""
    (la, ga), (lb, gb) = a, b
    loss = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(la, lb))
    rel, zero, worst = 0.0, 0.0, ""
    assert ga.keys() == gb.keys()
    for name in ga:
        d = float((ga[name] - gb[name]).double().norm())
        if name in ZERO_GRAD:
            zero = max(zero, d)
            continue
        r = d / max(float(gb[name].double().norm()), 1e-30)
        if r > rel:
            rel, worst = r, name
    return loss, rel, zero, worst


def replay(kcalls):
    """An op returning a recorded call's output, in call order."""
    it = iter(kcalls)

    def op(*args, **kw):
        return next(it)[2]
    return op


def stats_bwd_route_to_slot0(table, idx, mx, mn, gmx, gmn, gs1, gs2):
    """A stats backward that sends the max and min gradients to slot 0
    whichever slot holds the extremum (a routing fault)."""
    g0 = torch.zeros_like(gmx)
    base = edge_gather.edge_stats_bwd_plain(table, idx, mx, mn, g0, g0, gs1, gs2)
    b, n, c = table.shape
    first = idx[:, :, 0].long()
    return base.scatter_add(1, first[..., None].expand(-1, -1, c), gmx + gmn)


def bids_without_second(xyz1, xyz2, price):
    """Bids whose increment ignores the second-best value (best - best)."""
    t, inc = emd.emd_bids_plain(xyz1, xyz2, price)
    return t, torch.zeros_like(inc)


def compare_steps(state, partial, gt, calls, dev) -> None:
    """Kernel step against plain steps replaying its kNN graphs and MDS
    picks, all in deterministic mode, and two perturbed-op controls."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        kern = run_step(*fresh_model(state, dev), partial, gt)
        kern2 = run_step(*fresh_model(state, dev), partial, gt)
        loss, rel, zero, worst = step_gaps(kern2, kern)
        log(f"  kernel step twice: loss rel gap {loss:.3e}, gradient leaf "
            f"relative-L2 gap {rel:.3e} ({worst}), zero-gradient leaves "
            f"{zero:.3e}")
        fixed = dict(knn=replay(calls["knn"]), mds=replay(calls["mds"]))
        plain = dict(PLAIN, **fixed)
        with swapped(**plain):
            p = run_step(*fresh_model(state, dev), partial, gt)
        loss, rel, zero, worst = step_gaps(kern, p)
        log(f"  kernel step vs plain step (kNN graphs and MDS picks replayed):"
            f" loss {kern[0]} vs {p[0]}, loss rel gap {loss:.3e} (limit "
            f"{STEP_LOSS_RTOL:g}), gradient leaf relative-L2 gap {rel:.3e} "
            f"({worst}; limit {STEP_GRAD_REL:g}), zero-gradient leaves "
            f"{zero:.3e} (limit {STEP_ZERO_ABS:g})")
        if loss > STEP_LOSS_RTOL or rel > STEP_GRAD_REL or zero > STEP_ZERO_ABS:
            fail("the kernel step differs from the anchored plain step")
        for op, fn, what in (
                ("edge_stats_bwd", stats_bwd_route_to_slot0,
                 "stats backward routing max/min to slot 0"),
                ("emd_bids", bids_without_second,
                 "bids whose increment ignores the second best")):
            fixed = dict(knn=replay(calls["knn"]), mds=replay(calls["mds"]))
            with swapped(**dict(PLAIN, **fixed, **{op: fn})):
                c = run_step(*fresh_model(state, dev), partial, gt)
            loss, rel, zero, worst = step_gaps(c, kern)
            caught = (loss > STEP_LOSS_RTOL or rel > STEP_GRAD_REL
                      or zero > STEP_ZERO_ABS)
            log(f"  control, {what}: loss rel gap {loss:.3e}, gradient leaf "
                f"relative-L2 gap {rel:.3e} ({worst}): "
                f"{'caught' if caught else 'NOT caught'}")
            if not caught:
                fail(f"the step check does not see a {what}")
    finally:
        torch.use_deterministic_algorithms(False)


_TRAIN_GROUPS = (("mds", ("mds_kernel",)),
                 ("emd_bids", ("bids_kernel",)),
                 ("knn", ("knn_kernel", "sqnorm_kernel")),
                 ("nn_idx", ("::nn_kernel",)),
                 ("edge_stats", ("stats_fwd_kernel", "route_kernel", "count_kernel",
                                 "scan_kernel", "fill_kernel", "sort_kernel",
                                 "accum_kernel")),
                 ("expansion", ("expansion_kernel",)),
                 ("gemm", ("gemm", "xmma", "cutlass", "cublas")))


def profile_step(model, opt, partial, gt) -> None:
    """One profiled training step: device time by kernel group."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run_step(model, opt, partial, gt)
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if not busy:
        fail("the profiler saw no device time in the training step")
        return
    groups = dict.fromkeys([g for g, _ in _TRAIN_GROUPS] + ["other"], 0.0)
    for key, ms, _ in kernels:
        name = next((g for g, pats in _TRAIN_GROUPS
                     if any(p in key.lower() for p in pats)), "other")
        groups[name] += ms
    log(f"  profile step B={partial.shape[0]}: wall {wall_ms:.1f} ms, device "
        f"busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:10s} {ms:9.2f} ms  {100 * ms / busy:5.1f}% of busy")
    for key, ms, n in sorted(kernels, key=lambda k: -k[1])[:15]:
        log(f"    {ms:9.2f} ms  x{n:<5d} {key[:110]}")


def train_throughput(state, gen, dev) -> None:
    """Steps at B=24, or the largest batch that fits: ms per step over 3
    steps after one warm-up, clouds/s, peak memory; one profiled step."""
    for b in (B_TRAIN, 16, 12, 8):
        model = opt = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            model, opt = fresh_model(state, dev)
            partial, gt = (t.to(dev) for t in train_batch(gen, b))
            run_step(model, opt, partial, gt)
            t = time.perf_counter()
            for _ in range(3):
                run_step(model, opt, partial, gt)
            ms = (time.perf_counter() - t) * 1e3 / 3
        except torch.cuda.OutOfMemoryError:
            log(f"  B={b}: out of memory (peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
            del model, opt
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  B={b}: {ms:.1f} ms per training step, {b / (ms / 1e3):.2f} "
            f"clouds/s, peak memory {peak:.2f} GiB (max_memory_allocated) "
            f"on {nvidia_smi()}")
        profile_step(model, opt, partial, gt)
        return
    fail("no training batch fits on the card")


def main_train(model_state, dev) -> tuple[dict, dict, dict]:
    """Phases 7-10; returns (launches, per-kernel rows, random errors)."""
    log(f"phase 7: each training kernel against its plain version, random "
        f"inputs (B={B_CHECK})")
    errs = check_random_train(torch.Generator().manual_seed(2), dev)

    log(f"phase 8: the second main path, one flagship training step "
        f"{N_INPUT_POINTS} -> {N_OUT} points at B={B_CHECK}")
    gen = torch.Generator().manual_seed(3)
    partial, gt = (t.to(dev) for t in train_batch(gen, B_CHECK))
    model, opt = fresh_model(model_state, dev)
    calls: dict = {}
    with swapped(**recording(calls)):
        _lib.reset_counts()
        t = time.perf_counter()
        loss, grads = run_step(model, opt, partial, gt)
        launches, plain = dict(_lib.LAUNCHES), dict(_lib.PLAIN_CALLS)
    log(f"  kernel step: {time.perf_counter() - t:.2f} s; loss, coarse, refine "
        f"{loss}; launches {launches}, plain calls {plain}")
    if not all(map(math.isfinite, loss)):
        fail(f"training loss not finite: {loss}")
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad:
        fail(f"non-finite gradients in {bad[:5]}")
    for name in TRAIN_EXPECTED:
        log(f"  {name}: {launches[name]} launches, {plain[name]} plain calls")
        if launches[name] < 1 or plain[name] != 0:
            fail(f"{name}: {launches[name]} launches, {plain[name]} plain calls "
                 f"in the training step")
    if sum(plain.values()):
        fail(f"plain versions ran in the training step: {plain}")

    log("phase 9: each training kernel on the inputs the step gave it")
    rows = check_forward_calls(calls, errs, TRAIN_OPS, "step")

    log("phase 10: the kernel step against the anchored plain step")
    compare_steps(model_state, partial, gt, calls, dev)
    return launches, rows, errs


def check_forward_calls(calls: dict, errs: dict, names=EVAL_OPS,
                        what: str = "forward") -> dict:
    """Each recorded kernel call against the plain version on the same
    inputs; kernel, plain and library times per call, summed per forward
    (or step). The plain version's first call is its warm-up and its
    reference."""
    rows = {}
    for name in names:
        library, reps, compare, bound_fn = SPECS[name]
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0 if library else None,
               "max_abs_err": errs[name]}
        by = set()
        for i, (args, kw, out) in enumerate(calls[name]):
            want = PLAIN[name](*args, **kw)
            ok, err, msg = compare(args, out, want)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            if not ok:
                fail(f"{name} call {i} of the {what}: kernel differs from "
                     f"the plain version")
            ms = cuda_ms(lambda: KERNEL[name](*args, **kw), reps=reps)
            pms = cuda_ms(lambda: PLAIN[name](*args, **kw), reps=1, warmup=0)
            lms = (cuda_ms(lambda: library(*args, **kw), reps=3)
                   if library else None)
            b_ms, b_by = bound_fn(args, out)
            by.add(b_by)
            shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
            if len(calls[name]) <= 8 or i % 10 == 0:
                log(f"  {name} call {i} {shapes}: {msg}; kernel {ms:.4f} ms, "
                    f"plain {pms:.4f} ms"
                    + (f", library {lms:.4f} ms" if library else "")
                    + f", bound {b_ms:.5f} ms ({b_by})")
            tot["ms"] += ms
            tot["plain_ms"] += pms
            tot["bound_ms"] += b_ms
            if library:
                tot["library_ms"] += lms
        tot["bound_by"] = "bytes" if by == {"bytes"} else "operations"
        lib_ms = "none" if library is None else f"{tot['library_ms']:.4f} ms"
        log(f"  {name}: {len(calls[name])} calls per {what}: kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
            f"{lib_ms}, bound {tot['bound_ms']:.5f} ms")
        rows[name] = tot
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 5: the flagship forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def jitter_bn_stats(model, gen) -> None:
    """Non-trivial BatchNorm running statistics, so eval BN does work."""
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.rand(buf.shape, generator=gen) * 0.6 - 0.3)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)


def replay_knn(kcalls, seen: list, perturb: bool = False):
    """A kNN that returns the kernel forward's graphs in call order and
    keeps its inputs in ``seen``; with ``perturb``, each graph's 8th
    neighbour is replaced by the 9th nearest (a top-k off by one)."""
    it = iter(kcalls)

    def knn_replay(x, k=8):
        (x_k, *_), _, out = next(it)
        seen.append((x, x_k))
        if not perturb:
            return out
        nine = knn.knn_plain(x_k, k + 1)
        return torch.cat([out[..., :k - 1], nine[..., k:]], -1)
    return knn_replay


def drop_last_neighbour(table, idx, need_sum=False):
    """A gather-max that takes the 8th neighbour for the 7th (a loop one
    short)."""
    idx = torch.cat([idx[..., :-1], idx[..., -2:-1]], -1)
    return gather.gather_max_plain(table, idx, need_sum)


def anchored_gaps(model, partial, kcalls, coarse, perturb: str):
    """Encoder and decoder with every op plain, the kernel kNN graphs
    replayed, and the op ``perturb`` perturbed: the largest gap of the
    encoder stage features and of coarse against the kernel forward's."""
    seen: list = []
    fns = {"knn": replay_knn(kcalls, seen, perturb=perturb == "knn"),
           "gather_max": (drop_last_neighbour if perturb == "gather_max"
                          else PLAIN["gather_max"])}
    with swapped(**fns), torch.no_grad():
        c = model.decoder(model.encoder(partial))
    feat = max(float((x - x_k).abs().max()) for x, x_k in seen)
    return feat, float((c - coarse).abs().max())


def compare_forwards(model, partial, calls, outs) -> None:
    coarse, middle, refine, loss = outs
    kcalls = calls["knn"]

    # free-running: every op plain
    with swapped(**PLAIN):
        p = complete(model, partial)
    c_err = float((coarse - p[0]).abs().max())
    cds = {n: chamfer(a, b) for n, a, b in (("middle", middle, p[1]),
                                            ("refine", refine, p[2]))}
    log(f"  free-running: coarse max abs {c_err:.3e} (limit "
        f"{FREE_COARSE_ATOL:g}), Chamfer middle {cds['middle']:.3e} refine "
        f"{cds['refine']:.3e} (limit {FREE_CHAMFER:g}); loss_mst "
        f"{float(loss):.6e} vs {float(p[3]):.6e}")
    if c_err > FREE_COARSE_ATOL:
        fail(f"free-running coarse max abs {c_err:.3e} > {FREE_COARSE_ATOL:g}")
    for n, v in cds.items():
        if v > FREE_CHAMFER:
            fail(f"free-running {n} Chamfer {v:.3e} > {FREE_CHAMFER:g}")

    # anchored: the plain forward replays the kernel kNN graphs
    seen: list = []
    acalls: dict = {}
    with swapped(**dict(PLAIN, knn=replay_knn(kcalls, seen))):
        with swapped(**recording(acalls)):
            a = complete(model, partial)
    feat = max(float((x - x_k).abs().max()) for x, x_k in seen)
    a_err = float((coarse - a[0]).abs().max())
    same = [int((g[2] != w[2]).sum()) for g, w in zip(calls["mds"], acalls["mds"])]
    acd = {n: chamfer(x, y) for n, x, y in (("middle", middle, a[1]),
                                            ("refine", refine, a[2]))}
    log(f"  anchored: encoder stage features max abs {feat:.3e} (limit "
        f"{ANCHOR_FEAT_ATOL:g}), coarse max abs {a_err:.3e} (limit "
        f"{ANCHOR_COARSE_ATOL:g}), MDS picks that differ per call {same}, "
        f"Chamfer middle {acd['middle']:.3e} refine {acd['refine']:.3e} "
        f"(limit {ANCHOR_CHAMFER:g})")
    if feat > ANCHOR_FEAT_ATOL:
        fail(f"anchored encoder features max abs {feat:.3e} > {ANCHOR_FEAT_ATOL:g}")
    if a_err > ANCHOR_COARSE_ATOL:
        fail(f"anchored coarse max abs {a_err:.3e} > {ANCHOR_COARSE_ATOL:g}")
    for n, v in acd.items():
        if v > ANCHOR_CHAMFER:
            fail(f"anchored {n} Chamfer {v:.3e} > {ANCHOR_CHAMFER:g}")

    # controls: one op perturbed, the anchored check must see it
    for op, what in (("knn", "kNN top-k off by one (9th for 8th)"),
                     ("gather_max", "gather-max loop one short")):
        f_gap, c_gap = anchored_gaps(model, partial, kcalls, coarse, op)
        caught = f_gap > ANCHOR_FEAT_ATOL or c_gap > ANCHOR_COARSE_ATOL
        log(f"  control, {what}: encoder stage features max abs {f_gap:.3e}, "
            f"coarse max abs {c_gap:.3e} (free-running limit "
            f"{FREE_COARSE_ATOL:g}): {'caught' if caught else 'NOT caught'}")
        if not caught:
            fail(f"the anchored forward check does not see a {what}")

    # loss_mst anchored on one coarse cloud: which MST edges pass the
    # 1.5x-mean threshold is decided by rounding when the clouds differ
    dist_k, _, _ = expansion_penalty.expansion_penalty(coarse, PRIM_S, 1.5)
    with swapped(expansion=PLAIN["expansion"]):
        dist_p, _, _ = expansion_penalty.expansion_penalty(coarse, PRIM_S, 1.5)
    loss_rel = abs(float(dist_k.mean() - dist_p.mean())) / max(float(dist_p.mean()), 1e-30)
    log(f"  loss_mst on the kernel forward's coarse cloud: kernel vs plain "
        f"expansion rel diff {loss_rel:.2e}")
    if loss_rel > 1e-5:
        fail(f"anchored loss_mst differs by {loss_rel:.2e} (relative)")


_GROUPS = (("knn", ("knn_kernel", "sqnorm_kernel")),
           ("gather_max", ("gather_max_kernel", "sum_partials_kernel")),
           ("expansion", ("expansion_kernel",)),
           ("mds", ("mds_kernel",)),
           ("gemm", ("gemm", "xmma", "cutlass", "cublas")))


def profile_forward(model, partial) -> None:
    """One profiled forward: device time by kernel group, busy share of
    the wall time (the profiler's own overhead counts as idle)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        complete(model, partial)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if not busy:
        fail("the profiler saw no device time")
        return
    groups = dict.fromkeys([g for g, _ in _GROUPS] + ["other"], 0.0)
    for key, ms, _ in kernels:
        name = next((g for g, pats in _GROUPS
                     if any(p in key.lower() for p in pats)), "other")
        groups[name] += ms
    log(f"  profile B={partial.shape[0]}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:10s} {ms:9.2f} ms  {100 * ms / busy:5.1f}% of busy")
    for key, ms, n in sorted(kernels, key=lambda k: -k[1])[:12]:
        log(f"    {ms:9.2f} ms  x{n:<4d} {key[:110]}")


def main() -> int:
    signal.alarm(TIME_LIMIT_S)   # never outlive the time limit
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels run on the card only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    set_parity_mode()

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"phase 0: device {kind!r}, count {count}, nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 1: building the kernels (one nvcc call)")
    _lib.lib()
    info = _lib.BUILD_INFO
    if "seconds" in info:
        log(f"  built {info['path']} in {info['seconds']:.1f} s (one nvcc per "
            f"source, all at once, then one link):")
        for cmd in info["command"]:
            log(f"    {cmd}")
        for line in info["ptxas"].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    else:
        log(f"  library already built: {info.get('path')}")

    log(f"phase 2: each kernel against its plain version, random inputs (B={B_CHECK})")
    errs = check_random(torch.Generator().manual_seed(0), dev)

    log(f"phase 3: the main path, flagship forward {N_INPUT_POINTS} -> "
        f"{N_OUT} points at B={B_CHECK}")
    gen = torch.Generator().manual_seed(1)
    model = build_generator(seed=0, device="cpu")
    jitter_bn_stats(model, gen)
    model = model.to(dev).eval()
    partial = (torch.rand(B_CHECK, N_INPUT_POINTS, 3, generator=gen) - 0.5).to(dev)
    calls: dict = {}
    with swapped(**recording(calls)):
        _lib.reset_counts()
        t = time.perf_counter()
        outs = complete(model, partial)
        torch.cuda.synchronize()
        launches, plain = dict(_lib.LAUNCHES), dict(_lib.PLAIN_CALLS)
    log(f"  kernel forward: {time.perf_counter() - t:.2f} s; launches "
        f"{launches}, plain calls {plain}")
    for name, v in zip(("coarse", "middle", "refine"), outs[:3]):
        if v.shape != (B_CHECK, N_OUT, 3) or not bool(torch.isfinite(v).all()):
            fail(f"{name}: shape {tuple(v.shape)} or non-finite values")
    if not bool(torch.isfinite(outs[3])):
        fail("loss_mst is not finite")
    expected = {"knn": 4, "gather_max": 4, "expansion": 2, "mds": 2}
    for name, want in expected.items():
        log(f"  {name}: {launches[name]} launches (expected {want}), "
            f"{plain[name]} plain calls")
        if launches[name] != want or plain[name] != 0:
            fail(f"{name}: {launches[name]} launches, {plain[name]} plain calls")

    log("phase 4: each kernel on the inputs the main path gave it")
    results = check_forward_calls(calls, errs)

    log("phase 5: the kernel forward against plain forwards")
    compare_forwards(model, partial, calls, outs)
    del calls

    log(f"phase 6: throughput at B={B_BENCH}")
    partial32 = (torch.rand(B_BENCH, N_INPUT_POINTS, 3, generator=gen) - 0.5).to(dev)
    fwd_ms = cuda_ms(lambda: complete(model, partial32), reps=3, warmup=1)
    cps = B_BENCH / (fwd_ms / 1e3)
    log(f"  B={B_BENCH}: {fwd_ms:.1f} ms per forward, {cps:.2f} clouds/s on "
        f"{smi}")
    profile_forward(model, partial32)

    train_state = snapshot(model)
    del model, partial32, outs
    t_launches, t_rows, _ = main_train(train_state, dev)
    results.update(t_rows)

    log(f"phase 11: training throughput at B={B_TRAIN} (sparenet.yaml)")
    train_throughput(train_state, gen, dev)

    meta = {
        "knn": ("sparenet_tpu_torch/csrc/knn.cu",
                "sparenet_tpu/ops/pallas/knn_pallas.py:152"),
        "gather_max": ("sparenet_tpu_torch/csrc/gather_max.cu",
                       "sparenet_tpu/ops/pallas/gather_pallas.py:81"),
        "expansion": ("sparenet_tpu_torch/csrc/expansion.cu",
                      "sparenet_tpu/ops/pallas/expansion_pallas.py:155"),
        "mds": ("sparenet_tpu_torch/csrc/mds.cu",
                "sparenet_tpu/ops/pallas/mds_pallas.py:327"),
        "nn_idx": ("sparenet_tpu_torch/csrc/chamfer_nn.cu",
                   "sparenet_tpu/ops/pallas/chamfer_pallas.py:73"),
        "emd_bids": ("sparenet_tpu_torch/csrc/emd_bids.cu",
                     "sparenet_tpu/ops/pallas/emd_pallas.py:91"),
        "edge_stats_fwd": ("sparenet_tpu_torch/csrc/edge_stats.cu",
                           "sparenet_tpu/ops/pallas/edge_train_pallas.py:122"),
        "edge_stats_bwd": ("sparenet_tpu_torch/csrc/edge_stats.cu",
                           "sparenet_tpu/ops/pallas/edge_train_pallas.py:157"),
    }
    # launches: each kernel's count on its own main path (the eval forward
    # for the first four, the training step for the rest)
    counts = {**{k: launches[k] for k in EVAL_OPS},
              **{k: t_launches[k] for k in TRAIN_OPS}}
    kernels = []
    for name, (src, rep) in meta.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    if FAILURES:
        log(f"{len(FAILURES)} check(s) failed: {FAILURES}")
        return 1
    log(f"all phases passed; kernel times summed over the B={B_CHECK} "
        f"forward's (or training step's) calls; forward B={B_BENCH} "
        f"{cps:.2f} clouds/s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
