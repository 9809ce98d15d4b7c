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
     torch.profiler forward (device time by kernel group, busy share).
The output ends with one JSON line of per-kernel numbers, the card's name and
power limit, and {"ok": true, "device": {...}} as the last line. Any failed
phase exits non-zero without that line. No CUDA device: exit 2.
"""

from __future__ import annotations

import contextlib
import json
import signal
import subprocess
import sys
import time

import torch

from sparenet_tpu_torch.models import (N_INPUT_POINTS, build_generator,
                                       complete, set_parity_mode)
from sparenet_tpu_torch.ops import _lib, expansion_penalty, gather, knn, mds
from sparenet_tpu_torch.ops.common import pairwise_sqdist_graph, sqdist3

T0 = time.perf_counter()
TIME_LIMIT_S = 1150          # the whole script, build included
B_CHECK, B_BENCH = 4, 32
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
       "mds": (mds, "minimum_density_sample")}
KERNEL = {name: getattr(*OPS[name]) for name in OPS}
PLAIN = {"knn": lambda x, k=8: knn.knn_plain(x, k),
         "gather_max": gather.gather_max_plain,
         "expansion": expansion_penalty.mst_charges_plain,
         "mds": mds.mds_plain}


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
        return v.clone()
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


def check_forward_calls(calls: dict, errs: dict) -> dict:
    """Each recorded kernel call against the plain version on the same
    inputs; kernel, plain and library times per call, summed per forward.
    The plain version's first call is its warm-up and its reference."""
    rows = {}
    for name, (library, reps, compare, bound_fn) in SPECS.items():
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0 if library else None,
               "max_abs_err": errs[name]}
        by = set()
        for i, (args, kw, out) in enumerate(calls[name]):
            want = PLAIN[name](*args, **kw)
            ok, err, msg = compare(args, out, want)
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            if not ok:
                fail(f"{name} call {i} of the forward: kernel differs from "
                     f"the plain version")
            ms = cuda_ms(lambda: KERNEL[name](*args, **kw), reps=reps)
            pms = cuda_ms(lambda: PLAIN[name](*args, **kw), reps=1, warmup=0)
            lms = (cuda_ms(lambda: library(*args, **kw), reps=3)
                   if library else None)
            b_ms, b_by = bound_fn(args, out)
            by.add(b_by)
            shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
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
        log(f"  {name}: {len(calls[name])} calls per forward: kernel "
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
        log(f"  built {info['path']} in {info['seconds']:.1f} s: {' '.join(info['command'])}")
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

    meta = {
        "knn": ("sparenet_tpu_torch/csrc/knn.cu",
                "sparenet_tpu/ops/pallas/knn_pallas.py:152"),
        "gather_max": ("sparenet_tpu_torch/csrc/gather_max.cu",
                       "sparenet_tpu/ops/pallas/gather_pallas.py:81"),
        "expansion": ("sparenet_tpu_torch/csrc/expansion.cu",
                      "sparenet_tpu/ops/pallas/expansion_pallas.py:155"),
        "mds": ("sparenet_tpu_torch/csrc/mds.cu",
                "sparenet_tpu/ops/pallas/mds_pallas.py:327"),
    }
    kernels = []
    for name, (src, rep) in meta.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    if FAILURES:
        log(f"{len(FAILURES)} check(s) failed: {FAILURES}")
        return 1
    log(f"all phases passed; kernel times summed over the B={B_CHECK} "
        f"forward's calls; forward B={B_BENCH} {cps:.2f} clouds/s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
