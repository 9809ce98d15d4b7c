#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sparenet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a flushed line with its elapsed seconds:
  0. the device: name, count, and nvidia-smi's name and power limit;
  1. the build: one nvcc call over all csrc/*.cu into sparenet_tpu_torch/_build/
     (gitignored), its seconds and the -Xptxas -v register/shared-memory lines;
  2. each kernel against its plain PyTorch version on random inputs at the
     shapes the flagship forward gives it (B=4); the kNN also bit for bit
     against its fixed summation order, on an adversarial near-tie input
     (zero padding, distinct lattice points in exact ties, duplicated grid
     features; C=256) with the count of queries its margin test sent to
     the exact scan and its time, and its tensor-core distances against
     the fixed order's on operands of mixed exponents and with
     cancellation, as a share of the margin E; greedy MDS at the cluster
     size it chooses against plain, and at every cluster size C = 1..16
     bit for bit against C = 1, with its time at C = 1, 2, 4, 8, 16; the
     MDS continuation (the same kernel started from a density state) on a
     random state of the hybrid tail's 5048 live lanes at every C = 1..16,
     with and without compaction, bit for bit against its plain version;
     the expansion kernel also at the B=32 forward's shape and on a
     degenerate 1e-7-scale cloud (duplicates, a lattice, a NaN) at 1, 4
     and 16 warps a primitive; gather-max at every slice plan (widths 4, 8
     and 16, without and with a row split; csrc/slices.cuh), its sum bit
     for bit against the model of its order, two calls equal, with NaN
     rows and past the slices' reach (the row path);
  3. the main path: the flagship SpareNet eval forward (3000 -> 16384 points,
     full widths, seeded random weights with jittered BatchNorm statistics)
     at B=4, with every launch count set to 0 just before and read just
     after; every kernel launched, no plain version ran;
  4. each kernel on the very inputs the main path gave it: its outputs there
     against the plain version's, and kernel, plain and library times summed
     over the forward's calls (the numbers of the kernels line; the kernel
     by CUDA events over calls back to back, and with the host ahead:
     calls enqueued behind a spin kernel, "host_ahead_ms"); the kNN
     queries flagged for the exact scan on those inputs; MDS at every
     cluster size on each of its calls' inputs, bit for bit against C = 1;
     the MDS latency floor: an empty step (no lane pass: the CTA argmin,
     the record exchange and its wait) in us at each C, and the
     C chosen at B = 4, 24 and 32; the expansion kernel's warps a
     primitive, its empty step (no relaxation) in us, its charging and its
     floor, (S - 1) empty steps + charging, at B = 4, 24 and 32, and the
     pruning rounds of the forward's trees; each gather-max call's slice
     plan (width, row groups, shared memory), time and share of its byte
     bound, at B=4 and on its inputs repeated to B=32;
  5. the forward against plain forwards: free-running (every op plain), and
     anchored (the plain forward replays the kernel kNN graphs checked in
     phase 4, so that only reassociation separates the two); two controls
     show that the anchored check fails when one op is perturbed;
  6. at B=32, bench.py's batch: clouds/s by CUDA events, one
     torch.profiler forward (device time by kernel group, busy share), and
     each kNN call of that forward timed beside its library call; then the
     same on zero-padded clouds (2048 points and 952 zero rows, as the
     loaders pad short clouds), with the flagged kNN queries;
  7. each training kernel (chamfer NN, auction bids, edge-stats forward and
     backward) against its plain version on random inputs at the shapes the
     flagship training step gives it, ties included; the bids also at full
     width with the counts on the card (u = 1, 37, 8908, 16384 bidders),
     with the kernel's plan (bidder tiles, object chunks) at each u; the NN
     also at N2 = 1, 2047, 2049 and 16384 with duplicated points, a NaN
     query and a NaN candidate, with its candidate split count; the
     edge-stats kernels at C = 256, 512, 1024 and 3, at k = 16 and 20 (wide
     route codes) and at N = 4000, with where the backward built its
     inverse lists (shared or device memory); the forward also with NaN
     rows at every slice plan and past the slices' reach (the row path);
  8. the second main path: one flagship training step (the same model and
     widths, EMD + consistency-Chamfer loss, Adam) at B=4 through
     ``runners.sparenet.train_step``, counts set to 0 just before and read
     just after: every kernel of the step launched, no plain version ran;
  9. each training kernel on the very inputs the step gave it: outputs
     against the plain version's, kernel, plain and library times summed
     over the step's calls; each edge-stats forward call's slice plan,
     time and share of its byte bound at B=4 and on its inputs repeated to
     B=24; the edge-stats backward by part (route codes,
     inverse lists, accumulation; device time by torch.profiler) and the
     NN's candidate splits, both also in the kernels line; the bids' plan
     at the smallest and largest u of the step's rounds (the rounds run at
     full width, no host read a round);
 10. the kernel step against a plain step on the card that replays its kNN
     graphs and MDS picks, both in deterministic mode: loss and every
     gradient leaf, and two perturbed-op controls the check must catch;
 11. training throughput: steps at B=24 (sparenet.yaml's batch, or the
     largest that fits), clouds/s, peak memory, the same on zero-padded
     partial clouds with the flagged kNN queries, one profiled step, and
     the same steps again in deterministic mode;
 12. the p2i splat kernel against its plain version on random inputs in the
     renderer's layout at 256 x 256, R = 4.5 and every radius of
     sparenet_gan.yaml, with duplicated points and exact ties, the same
     points scrambled and with a crowded tile added, at the kernel's tiles
     and at small tiles and work items (split bins): values and ids bit
     for bit;
 13. the third main path: one SpareNet-GAN step (the flagship generator and
     loss, 8-view depth maps at 256 x 256, the ProjectionD discriminator's
     step, the generator's step through it) at B=4 through
     ``runners.sparenet_gan.gan_step``, counts set to 0 just before and read
     just after: every kernel of the step launched (p2i three times), no
     plain version ran;
 14. the p2i kernel and its backward on the very inputs the GAN step gave
     them, timed; the backward by part (binning, tile pass), its plan
     (tile, item, bitmask words, hits a round, path) at each radius, and
     its time at the B=32 step's shape at each radius of sparenet_gan.yaml;
 15. the kernel GAN step against a plain GAN step that replays its kNN graphs,
     MDS picks, dropout masks and p2i backward (held to its plain version on
     the step's inputs), both in deterministic mode, and two
     controls the check must catch (depth normalised per cloud; a p2i
     backward without its point-coordinate term);
 16. GAN throughput at B=32 (sparenet_gan.yaml's batch, or the largest that
     fits): ms per step, clouds/s, peak memory, one profiled step, and the
     same steps in deterministic mode, with one profiled step there;
 17. the serving kernels against their plain versions on random inputs: the
     packed-key kNN at N 3000 and the encoder's widths (duplicated points
     included) and on phase 2's adversarial input (its flagged queries and
     time), bit for bit; the MDS continuation on the prefix states the
     plain batched prefix gives at the production shape (19384 points,
     14336 batched picks, 2048 continued; duplicated points give exact
     ties), bit for bit, at the chosen cluster size and at every C =
     1..16 with and without compaction; the p2i backward at R 5/7/10 within 1e-6 of the
     largest entry, two launches bit for bit equal, and bit for bit equal
     on its scan path and at small tiles and items;
 18. the fourth main path: the serving-mode forward (``build_generator(
     serving=True, mds=arm)``, the same parameters as phase 3) at B=4 in
     each MDS arm, batched, hybrid and exact, counts set to 0 just before
     and read just after: packed kNN 4, gather-max 4, MDS 2 (exact) or the
     continuation 2 (hybrid), no expansion, no plain version; the packed
     kNN queries flagged for the exact scan; then the forward as
     ``build_generator(serving=True)`` builds it, its MDS arm left at the
     default "auto": it must run the exact arm (MDS #4 twice, no
     continuation, no batched round), as the JAX package off the TPU;
 19. each serving kernel on the hybrid forward's own inputs (times and
     flagged kNN queries, as phase 4; the continuation at every C =
     1..16 and its latency floor: an empty step in us at the chosen C and
     at C = 1, 4, 16), and the kernel serving forward of each arm against a plain
     serving forward replaying its kNN graphs and MDS picks; two controls
     (a continuation skipping its first bump; a kNN off by one); the
     free-running Chamfer of each arm against parity as readings;
 20. B=32 forwards in each arm beside parity (CUDA events), each arm's MDS
     time on its own inputs, one profiled forward for batched and hybrid,
     each kNN call of the batched forward timed beside its library call,
     and the batched forward on zero-padded clouds with its flagged kNN
     queries; the arm the default serving forward took (phase 18);
 21. the trained flagship (docs/artifacts/r5/flagship_e8_bf16.npz, read by
     the port's checkpoint reader) at B=4 on the first clouds of the
     evaluation CLI's split (sparenet_tpu_torch/configs/flagship_e8_eval.yaml:
     Synthetic TEST, 128 clouds in batches of 16): launch counts, each
     kernel against its plain version on the inputs it gave them (timed),
     the kNN queries flagged for the exact scan, the MDS steps that met an
     exact tie or a near-tie of the smallest density, and the forward
     against plain forwards under the parity contract (free-running end to
     end by Chamfer; anchored on the kernel kNN graphs: the encoder stage
     features and coarse elementwise, middle and refine by Chamfer), with
     two controls;
 22. the evaluation CLI's path: the runner (``runners.get_runner``) over
     that split on the npz, in process, counts set to 0 just before and
     read just after (kNN, gather-max, expansion, MDS, the chamfer NN and
     the auction bids all launched, no plain version); per-batch and
     overall F-Score, CD x 1000 and EMD x 100 against the JAX package's
     reading on the CPU (docs/artifacts/port/jax_eval_flagship_e8.json,
     scripts/port_jax_eval_reading.py): CD and EMD within 1% and F within
     0.005 over the split, each batch within 2% and 0.01; clouds/s with
     data, forward and metrics apart;
 23. the final-test EMD protocol (eps 0.002, up to 10000 rounds) on the
     trained outputs of the split's first batch of 16: the rounds the
     auction ran before its early stop (its bids launches), the time and
     the EMD; where the stop does not fire, the unassigned bidders after
     some rounds of a run without the stop; the run's first bids call (all
     16384 bidders of each cloud) against its plain version;
 24. the training CLI (``sparenet_tpu_torch.train``: ``build`` and ``run``, in
     process) on the port's sparenet.yaml with Synthetic data: B=24, EMD and
     the consistency loss, a checkpoint every epoch; epoch 1 (2 steps, then
     validation over 32 clouds at B=16), then a run resumed from its
     checkpoint for epoch 2; each run's counts set to 0 just before and
     read just after: every training kernel launched (gather-max in
     validation), a step's launches as phase 8's, no plain version; finite
     losses; one checkpoint an epoch; the resumed runner holds the epoch-1
     run's generator (parameters and buffers) and Adam bit for bit and
     starts at epoch 2 at lr_for_epoch(2); in deterministic mode the
     runner's step equals a direct train_step on the same state and batch
     bit for bit; the epoch's clouds/s, seconds by part and peak memory;
 25. the SpareNet-GAN training CLI (``--gan``, the port's sparenet_gan.yaml)
     on the trained npz: one epoch (epoch 2: the npz loads as epoch 1) of 2
     steps at B=32 with the class-conditioned ProjectionD (8 Synthetic
     classes), then validation; every kernel of the GAN step launched, p2i
     3 times and its backward once a step, no plain version; the radii
     drawn; the whole-GAN checkpoint (generator, discriminator, both Adams,
     the step generators) reloads bit for bit; p2i and its backward on the
     first step's trained clouds against their plain versions, timed beside
     phase 14's random-weight clouds.
Deterministic mode is torch.use_deterministic_algorithms(True) as a user sets
it, with no warn_only: an op with no deterministic form fails the phase. The
script sets CUBLAS_WORKSPACE_CONFIG=:4096:8 before cuBLAS starts, which that
mode needs.
The output ends with a line "paths {...}" of each path's end-to-end time (the
line two runs are compared by), one JSON line of per-kernel numbers (every
TPU kernel of the JAX package, the packed kNN arm and the p2i backward), the
card's name
and power limit, and {"ok": true, "device": {...}} as the last line. Any failed
phase exits non-zero without that line. No CUDA device: exit 2.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

# Deterministic mode (phases 10, 11, 15 and 16) refuses cuBLAS calls unless
# the workspace is configured for it before cuBLAS starts; 8 x 4 MiB is also
# PyTorch's default workspace on Hopper, so the default mode is unchanged.
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import torch  # noqa: E402

from sparenet_tpu_torch import train as train_cli
from sparenet_tpu_torch.configs import CONFIG_DIR, cfg_from_file, cfg_update
from sparenet_tpu_torch.data import collate, data_init
from sparenet_tpu_torch.models import (N_INPUT_POINTS, build_discriminator,
                                       build_generator,
                                       complete, set_parity_mode)
from sparenet_tpu_torch.ops import _lib
from sparenet_tpu_torch.ops import chamfer as chamfer_op
from sparenet_tpu_torch.ops import p2i as p2i_op
from sparenet_tpu_torch.ops import (edge_gather, emd, expansion_penalty,
                                    gather, knn, mds)
from sparenet_tpu_torch.ops.common import (pairwise_sqdist_graph,
                                           pairwise_sqdist_graph_seq,
                                           slice_plan, sqdist3)
from sparenet_tpu_torch.runners import base as train_base
from sparenet_tpu_torch.renderer import ComputeDepthMaps, transform_points
from sparenet_tpu_torch.runners import sparenet as train_runner
from sparenet_tpu_torch.runners import get_runner
from sparenet_tpu_torch.runners import sparenet_gan as gan_runner
from sparenet_tpu_torch.utils.checkpoint import checkpoint_load
from sparenet_tpu_torch.utils.logging import set_logger
from sparenet_tpu_torch.utils.metrics import Metrics, emd_metric

T0 = time.perf_counter()
TIME_LIMIT_S = 1150          # the whole script, build included
B_CHECK, B_BENCH = 4, 32
B_TRAIN = train_runner.CONFIG["batch_size"]   # 24, sparenet.yaml
B_GAN = gan_runner.CONFIG["batch_size"]       # 32, sparenet_gan.yaml
IMG = gan_runner.CONFIG["img_size"]           # 256
RADII = gan_runner.CONFIG["radius_list"]      # 5, 7, 10
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


SPIN_CYCLES = 20_000_000  # a spin kernel of about 10 ms at the H100's clock


def host_ahead_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds a call by CUDA events over ``reps`` calls enqueued
    behind a spin kernel of about 10 ms, after a warm-up: the host is out of
    the way, so the card runs the calls back to back as fast as it can
    (their kernels and the gaps between them, no host pacing)."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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
       "edge_stats_bwd": (edge_gather, "edge_stats_bwd"),
       "p2i": (p2i_op, "p2i_max"),
       "p2i_bwd": (p2i_op, "p2i_max_backward"),
       "mds_continue": (mds, "mds_continue"),
       # serving mode's MDS dispatch: swapped only to replay its picks
       "mds_xyz": (mds, "minimum_density_sample_xyz")}
EVAL_OPS = ("knn", "gather_max", "expansion", "mds")
TRAIN_OPS = ("nn_idx", "emd_bids", "edge_stats_fwd", "edge_stats_bwd")
KERNEL = {name: getattr(*OPS[name]) for name in OPS}
# the serving kNN is knn_idx(..., packed=True); it has a row of its own
KERNEL["knn_packed"] = knn.knn_idx


# csrc/knn.cu (both arms): pre-pass, grouping of equal rows, tensor-core
# main kernel, the merge and re-rank, the exact scan of flagged queries
KNN_KERNELS = ("knn_prepass", "knn_dedup", "knn_mma", "knn_rerank", "knn_scan")
# csrc/p2i.cu: the binning (histogram and scatter, scan), the tile splat,
# the split tiles' prepare and finish passes, the backward (its binning,
# its bitmask tile pass or its window scan)
P2I_KERNELS = ("bin_kernel", "bin_scan_kernel", "tile_splat_kernel",
               "split_prepare_kernel", "split_finish_kernel", "bwd_bin_kernel",
               "bwd_bits_kernel", "bwd_scan_kernel")
# csrc/p2i.cu's backward by part: the binning (with its counts' memset) and
# the tile pass
P2I_BWD_PARTS = {"binning": ("bwd_bin_kernel", "bin_scan_kernel", "Memset"),
                 "tile pass": ("bwd_bits_kernel", "bwd_scan_kernel")}
# csrc/expansion.cu (the warp kernel; the wide one past S = 1024)
EXPANSION_KERNELS = ("expansion_warp_kernel", "expansion_wide_kernel")
# csrc/gather_max.cu and the edge-stats forward (csrc/edge_stats.cu): the
# slice kernels, the row path past their reach, the sum's partials
GATHER_KERNELS = ("gather_slice_kernel", "gather_max_kernel",
                  "sum_partials_kernel")
STATS_FWD_KERNELS = ("stats_slice_kernel", "stats_fwd_kernel")
# csrc/edge_stats.cu's backward by part: the route codes, the inverse lists,
# the ordered accumulation
EDGE_BWD_PARTS = {"route": ("route_kernel",), "lists": ("lists_kernel",),
                  "accum": ("accum_kernel",)}
# csrc/mds.cu's cluster kernel in its continuation mode (kPicks, kCont)
CONTINUE_KERNEL = ", 0, true>("
# each path's end-to-end time, printed on one line ("paths {...}") so that
# two runs compare line against line
PATHS: dict = {}
# the MDS latency floor (phase 4): us a step at each cluster size, the size
# chosen at B = 4, 24, 32
FLOOR: dict = {}


def plain_knn(x, k=8, packed=False):
    """The plain version of the arm knn_idx takes for these arguments."""
    if packed and knn.packed_applies(x.shape[1], x.shape[2]):
        return knn.knn_packed_plain(x, k)
    return knn.knn_plain(x, k)


PLAIN = {"knn": plain_knn,
         "knn_packed": plain_knn,
         "p2i_bwd": p2i_op.p2i_max_backward_plain,
         "mds_continue": mds.mds_continue_plain,
         "gather_max": gather.gather_max_plain,
         "expansion": expansion_penalty.mst_charges_plain,
         "mds": mds.mds_plain,
         "nn_idx": chamfer_op.nn_idx_plain,
         "emd_bids": emd.emd_bids_plain,
         "edge_stats_fwd": edge_gather.edge_stats_fwd_plain,
         "edge_stats_bwd": edge_gather.edge_stats_bwd_plain,
         "p2i": p2i_op.p2i_max_plain}


@contextlib.contextmanager
def patched(*targets):
    """Set each (object, attribute, value) for the block; restored on exit."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    for obj, name, fn in targets:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in reversed(saved):
            setattr(obj, name, fn)


def swapped(**fns):
    """Route the named ops to other functions (rows that are no op of their
    own, "knn_packed", are routed through "knn"); restored on exit."""
    return patched(*((*OPS[name], fn) for name, fn in fns.items()
                     if name in OPS))


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


def nan_equal(a, b) -> bool:
    """Equal bit for bit where not NaN, NaN at the same places."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def compare_gather(table, idx, got, want):
    """max bitwise (NaN-aware); the sum bitwise against the model of the
    kernel's order under the call's plan (ops/gather.py:
    gather_max_sum_blocks_plain; the row path of a shape no slice fits has
    no model), and against the plain sum, which reassociates: rtol 1e-5,
    plus 1e-6 of the sum of |rows| for cancellation in a sum of 24000
    terms of either sign, NaN where it has NaN."""
    (out, s), (pout, ps) = got, want
    b, n, c = table.shape
    plan = slice_plan(b, n, idx.shape[1], c, idx.shape[2])
    exact = nan_equal(out, pout)
    model = "row path, no model"
    ordered = True
    if plan["width"]:
        _, ms = gather.gather_max_sum_blocks_plain(table, idx, plan["lanes"],
                                                   plan["group_rows"])
        ordered = nan_equal(s, ms)
        model = f"sum equals its order's model={ordered}"
    abs_sum = gather.gather_rows(table.abs(), idx).sum((1, 2))
    err = (s - ps).abs()
    ok = ~ps.isnan()
    sum_ok = (torch.equal(s.isnan(), ps.isnan()) and bool(
        (err <= 1e-5 * ps.abs() + 1e-6 * abs_sum)[ok].all()))
    e = float(err[ok].max()) if bool(ok.any()) else 0.0
    return (exact and sum_ok and ordered, e,
            f"plan W={plan['width']} G={plan['groups']}; max exact={exact}; "
            f"{model}; sum max abs err {e:.3e} against the plain sum, within "
            f"tolerance={sum_ok}")


def gather_inputs(gen, dev, b, n, m, c, nan=False):
    """A table with equal rows and, where asked, NaN in rows the lists
    name; lists with equal slots."""
    table = torch.randn(b, n, c, generator=gen)
    table[:, 1] = table[:, 0]
    idx = torch.randint(0, n, (b, m, K), generator=gen, dtype=torch.int32)
    idx[:, :, K - 1] = idx[:, :, 0]
    if nan:
        table[0, 7, c // 2] = float("nan")
        table[-1, 9] = float("nan")
        idx[:, :3, 1] = 7
        idx[:, 3:6, 0] = 9
    return table.to(dev), idx.to(dev)


# shapes (B, N, M, C) at which phases 2 and 7 check the slice kernels
# beside the paths' own, with the plan each takes on an H100
# (csrc/slices.cuh:make_plan): every width, without and with a row split
SLICE_SHAPES = [((4, 3000, 3000, 1024), 16, False), ((1, 3000, 3000, 256), 16, True),
                ((4, 5000, 3000, 256), 8, False), ((1, 5000, 3000, 256), 8, True),
                ((2, 3000, 3000, 8), 8, True), ((4, 10000, 2000, 256), 4, False),
                ((1, 10000, 2000, 256), 4, True), ((2, 3000, 3000, 3), 4, True)]


def plan_as_expected(shape, width, split) -> tuple[bool, str]:
    """Whether the plan of a SLICE_SHAPES entry is the width and row split
    listed, and a description of it."""
    plan = slice_plan(*shape, K)
    ok = (plan["width"], plan["groups"] > 1) == (width, split)
    return ok, (f"{list(shape)}: plan W={plan['width']} G={plan['groups']} "
                f"(expected W={width}{', split' if split else ''}: {ok})")
# a cloud past the slices' reach: the row-at-a-time kernels (N, M, C)
ROW_PATH_SHAPE = (15000, 700, 256)


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
        got = knn.knn_idx(x, K)
        verdict("knn", f"C={c}", compare_knn(x, got, knn.knn_plain(x, K)))
        verdict("knn", f"C={c}, against its fixed summation order",
                compare_exact(got, knn.smallest_k(pairwise_sqdist_graph_seq(x), K)))
    x = near_tie_features(gen, dev)
    before = _lib.device_count("knn_flagged")
    got = knn.knn_idx(x, K)
    flagged = _lib.device_count("knn_flagged") - before
    verdict("knn", f"C={x.shape[2]}, zero rows, lattice points and a "
            f"duplicated grid, {flagged} of {x.shape[0] * x.shape[1]} queries "
            f"flagged for the exact scan, "
            f"{cuda_ms(lambda: knn.knn_idx(x, K), reps=3):.3f} ms",
            compare_knn(x, got, knn.knn_plain(x, K)))
    check_margin_premise(gen, dev)
    for c in GATHER_WIDTHS:
        table = torch.randn(B_CHECK, n, c, generator=gen).to(dev)
        idx = torch.randint(0, n, (B_CHECK, n, K), generator=gen,
                            dtype=torch.int32).to(dev)
        want = gather.gather_max_plain(table, idx, need_sum=True)
        verdict("gather_max", f"C={c}", compare_gather(
            table, idx, gather.gather_max(table, idx, need_sum=True), want))
        again = gather.gather_max(table, idx, need_sum=True)
        same = all(torch.equal(x, y) for x, y in zip(
            again, gather.gather_max(table, idx, need_sum=True)))
        verdict("gather_max", f"C={c}, two calls", (same, 0.0,
                                                    f"bit for bit equal={same}"))
    for shape, width, split in SLICE_SHAPES:
        planned, what = plan_as_expected(shape, width, split)
        table, idx = gather_inputs(gen, dev, *shape)
        ok, e, msg = compare_gather(
            table, idx, gather.gather_max(table, idx, need_sum=True),
            gather.gather_max_plain(table, idx, need_sum=True))
        verdict("gather_max", what, (ok and planned, e, msg))
    for what, (nn_, m, c), nan in (("NaN rows", (n, n, 256), True),
                                   ("past the slices' reach", ROW_PATH_SHAPE,
                                    False)):
        table, idx = gather_inputs(gen, dev, B_CHECK, nn_, m, c, nan)
        verdict("gather_max", f"[{B_CHECK}, {nn_}, {c}] -> {m} rows, {what}",
                compare_gather(table, idx,
                               gather.gather_max(table, idx, need_sum=True),
                               gather.gather_max_plain(table, idx, need_sum=True)))
    xyz = (torch.rand(B_CHECK * N_PRIMS, PRIM_S, 3, generator=gen) * 2 - 1).to(dev)
    verdict("expansion", f"{list(xyz.shape)}", compare_expansion(
        expansion_penalty.mst_charges(xyz),
        expansion_penalty.mst_charges_plain(xyz)))
    # the B=32 forward's shape, and a degenerate cloud at the random-init
    # coarse cloud's scale (duplicates, a lattice, a NaN)
    xyz = (torch.rand(B_BENCH * N_PRIMS, PRIM_S, 3, generator=gen) - 0.5).to(dev)
    verdict("expansion", f"{list(xyz.shape)}", compare_expansion(
        expansion_penalty.mst_charges(xyz),
        expansion_penalty.mst_charges_plain(xyz)))
    xyz = (torch.rand(B_CHECK * N_PRIMS, PRIM_S, 3, generator=gen) - 0.5) * 1e-7
    q = PRIM_S // 4
    xyz[:, q:2 * q] = xyz[:, :q]
    xyz[:, 2 * q:3 * q] = torch.round(xyz[:, 2 * q:3 * q] * 4e7) / 4e7
    xyz[0, PRIM_S // 2, 1] = float("nan")
    xyz = xyz.to(dev)
    verdict("expansion", f"{list(xyz.shape)} at the 1e-7 scale with ties and "
            f"a NaN", compare_expansion(
                expansion_penalty.mst_charges(xyz),
                expansion_penalty.mst_charges_plain(xyz)))
    coarse = (torch.rand(B_CHECK, N_OUT, 3, generator=gen) - 0.5).to(dev)
    partial = (torch.rand(B_CHECK, n, 3, generator=gen) - 0.5).to(dev)
    _, _, mml = expansion_penalty.expansion_penalty(coarse, PRIM_S, 1.5)
    xyz = torch.cat([coarse, partial], 1).contiguous()
    picks = mds.minimum_density_sample(xyz, N_OUT, mml)
    c, per_sm = mds.cluster_size(B_CHECK, xyz.shape[1])
    verdict("mds", f"{list(xyz.shape)} -> {N_OUT}, C={c} ({per_sm} CTA(s) an "
            f"SM)", compare_mds(
                xyz, mml, picks, mds.mds_plain(xyz, N_OUT, mml)))
    check_mds_clusters(xyz, N_OUT, mml, picks, errs, "random input")
    # the continuation (#5, the same kernel started from a density state)
    # on a random state of the hybrid tail's live lanes
    n_live = N_MDS - HYBRID_PREFIX
    cargs = ((torch.rand(B_CHECK, n_live, 3, generator=gen) - 0.5).to(dev),
             (torch.rand(B_CHECK, n_live, generator=gen) * 0.01).to(dev),
             torch.arange(8000, 8000 + n_live, dtype=torch.int32).repeat(
                 B_CHECK, 1).to(dev), mml, mds.TAIL)
    check_continue_clusters(cargs, mds.mds_continue_plain(*cargs), errs,
                            "random state")
    return errs


def check_mds_clusters(xyz, npoint, mml, picks, errs, what: str) -> None:
    """Every cluster size C = 1..16, forced, against C = 1, and C = 1
    against the picks of the chosen size: bit for bit, with the kernel's
    time at each C."""
    ref = mds.minimum_density_sample(xyz, npoint, mml, _cluster=1)
    same = []
    for c in range(1, 17):
        got = (ref if c == 1 else
               mds.minimum_density_sample(xyz, npoint, mml, _cluster=c))
        ok, err, _ = compare_exact(got, ref)
        errs["mds"] = max(errs["mds"], err)
        same.append(ok)
        if not ok:
            fail(f"mds {what}: C={c} picks differ from C=1's")
    ok, err, msg = compare_exact(picks, ref)
    if not ok:
        fail(f"mds {what}: the chosen C's picks differ from C=1's ({msg})")
    times = {c: cuda_ms(lambda: mds.minimum_density_sample(
        xyz, npoint, mml, _cluster=c), reps=1) for c in (1, 2, 4, 8, 16)}
    log(f"  mds {what} {list(xyz.shape)} -> {npoint}: C = 1..16 bit for bit "
        f"equal to C=1: {all(same)}; ms a call at C " + ", ".join(
            f"{c}: {ms:.3f}" for c, ms in times.items()))


def near_tie_features(gen, dev):
    """Adversarial kNN input at N=3000, C=256: in each cloud, 1000 zero rows
    (the loaders' padding: exact ties in bulk, one group); 1000 distinct
    points of the lattice {0..7}^4 in 4 channels (up to 24 others at one
    distance: more than 32 keys in one truncation bucket, which the margin
    test sends to the exact scan); 500 features on a grid of 3 values in
    every channel, each twice."""
    n, c = N_INPUT_POINTS, 256
    x = torch.zeros(B_CHECK, n, c)
    g = torch.stack(torch.meshgrid(*[torch.arange(8.0)] * 4, indexing="ij"),
                    -1).reshape(-1, 4)
    for b in range(B_CHECK):
        x[b, 1000:2000, :4] = g[torch.randperm(len(g), generator=gen)[:1000]]
    grid = torch.randint(-1, 2, (B_CHECK, 500, c), generator=gen) * 0.5
    x[:, 2000:] = torch.cat([grid, grid], 1)
    return x.to(dev)


def check_margin_premise(gen, dev) -> None:
    """The margin E assumes each add of the tensor cores keeps 24
    significant bits (csrc/knn.cu). Each arm's main-kernel dots and
    distances against its fixed order's, on points whose entries are
    scaled by 2^e, e uniform in [-12, 12], each beside a copy moved by
    1e-3: max |dot' - dot| over the bound derived for it, which must stay
    under 0.5, and max |d' - d| / E, under 1."""
    for c in KNN_WIDTHS:
        base = torch.randn(1, 1024, c, generator=gen) * 2.0 ** torch.randint(
            -12, 13, (1, 1024, c), generator=gen).float()
        near = base * (1 + 1e-3 * torch.randn(1, 1024, c, generator=gen))
        x = torch.cat([base, near], 1).to(dev)
        for packed in (False, True):
            dot_ratio, d_ratio = knn.tensor_core_error(x, packed)
            arm = "knn_packed" if packed else "knn"
            log(f"  {arm} C={c}: tensor cores over {x.shape[1] ** 2} pairs, "
                f"max |dot' - dot| / bound {dot_ratio:.3e}, max |d' - d| / E "
                f"{d_ratio:.3e}")
            if not (dot_ratio < 0.5 and d_ratio < 1.0):
                fail(f"{arm} C={c}: the tensor cores' error reaches "
                     f"{dot_ratio:.3e} of its bound, {d_ratio:.3e} E")


def zero_padded(partial):
    """partial [B, 3000, 3] with its rows from 2048 on set to 0: the
    loaders' RandomSamplePoints pads a cloud of 2048 points (a Completion3D
    partial) so."""
    out = partial.clone()
    out[:, 2048:] = 0.0
    return out


def flagged_by(fn, name: str) -> int:
    """The queries that ``fn()`` sends to the exact kNN scan (counter
    ``name``)."""
    before = _lib.device_count(name)
    fn()
    return _lib.device_count(name) - before


def report_flagged(kcalls, what: str) -> None:
    """How many queries of each recorded kNN input (exact or packed arm, as
    recorded) the kernel's margin test sends to the exact scan."""
    counts = []
    for args, kw, _ in kcalls:
        packed = kw.get("packed", False) and knn.packed_applies(*args[0].shape[1:])
        name = "knn_packed_flagged" if packed else "knn_flagged"
        before = _lib.device_count(name)
        knn.knn_idx(*args, **kw)
        counts.append(_lib.device_count(name) - before)
    rows = sum(a[0].shape[0] * a[0].shape[1] for a, _, _ in kcalls)
    log(f"  kNN on {what}: {sum(counts)} of {rows} queries flagged for the "
        f"exact scan (per call {counts})")


def time_knn_calls(model, partial, what: str) -> None:
    """Each kNN call of one forward of ``model`` on ``partial``, timed on its
    own inputs: the kernel and the library call (CUDA events)."""
    calls: dict = {}
    with swapped(**recording(calls)):
        complete(model, partial)
    for i, (args, kw, _) in enumerate(calls["knn"]):
        ms = cuda_ms(lambda: knn.knn_idx(*args, **kw), reps=5)
        lms = cuda_ms(lambda: _library_knn(*args, **kw), reps=3)
        log(f"  {what} kNN call {i} {list(args[0].shape)}: kernel {ms:.4f} ms, "
            f"library {lms:.4f} ms")


# ---------------------------------------------------------------------------
# phase 4: each kernel on the inputs the main path gave it, timed
# ---------------------------------------------------------------------------

FLOOR_STEPS = 4096


def mds_latency_floor(args, dev) -> None:
    """The greedy kernel's latency floor: a chain of FLOOR_STEPS steps with
    no lane pass (barriers and the record exchange only) on the forward's
    input, in microseconds a step at each cluster size; the size chosen at
    B = 4, 24 and 32 for the N the forward sees."""
    xyz, _, mml = args
    n = xyz.shape[1]

    def us_a_step(c, cta_only=False):
        ms = cuda_ms(lambda: mds.mds_floor(xyz, FLOOR_STEPS + 1, mml, c,
                                           cta_only), reps=3)
        return 1e3 * ms / FLOOR_STEPS
    per_step = {c: us_a_step(c) for c in range(1, 17)}
    cta = {c: us_a_step(c, True) for c in (1, 16)}
    stages = {st: cuda_ms(lambda: mds.minimum_density_sample(
        xyz, args[1], mml, _stage=st), reps=2) for st in (0, 256, 1024, 4096)}
    log(f"  mds on the forward's input, ms a call by compaction period "
        f"(0: none): " + ", ".join(f"{st}: {t:.3f}" for st, t in stages.items()))
    chosen = {b: mds.cluster_size(b, n) for b in (B_CHECK, B_TRAIN, B_BENCH)}
    FLOOR.update(per_step_us=per_step, cta_only_us=cta, chosen=chosen)
    log(f"  mds latency floor (an empty step: CTA argmin, record exchange, "
        f"its wait), us a step at C: " + ", ".join(
            f"{c}: {us:.3f}" for c, us in per_step.items())
        + "; the CTA argmin and barrier alone at C " + ", ".join(
            f"{c}: {us:.3f}" for c, us in cta.items())
        + f"; (C, CTAs an SM) chosen for N={n} at B " + ", ".join(
            f"{b}: {c}" for b, c in chosen.items()) + f" on {nvidia_smi()}")

def expansion_latency_floor(calls) -> float:
    """The expansion kernel's launch shape and latency floor (phase 4): on
    the forward's inputs (B_CHECK x 32 primitives of PRIM_S) and on their
    primitives repeated to the B_TRAIN and B_BENCH forwards' counts, ms a
    call of the whole kernel, of Prim's steps alone (mode "prim") and of
    S - 1 empty steps (mode "floor": the argmin, the key exchange and the
    pick, no relaxation); the empty step in us, the charging (whole minus
    Prim) and the floor, (S - 1) empty steps + charging; and the pruning
    rounds of the forward's trees. Returns the floor summed over the
    forward's calls, in ms."""
    floor_ms = 0.0
    for i, (args, _, out) in enumerate(calls):
        xyz = args[0]
        rounds = expansion_penalty.pruning_rounds(out[0])
        full = cuda_ms(lambda: expansion_penalty.mst_charges(xyz), reps=10)
        prim = cuda_ms(lambda: expansion_penalty.mst_floor(xyz, "prim"), reps=10)
        empty = cuda_ms(lambda: expansion_penalty.mst_floor(xyz, "floor"), reps=10)
        floor_ms += empty + max(full - prim, 0.0)
        log(f"  expansion call {i} {list(xyz.shape)}: pruning rounds max "
            f"{int(rounds.max())}, mean {float(rounds.float().mean()):.1f}; "
            f"whole {full:.4f} ms, Prim's steps {prim:.4f}, empty steps "
            f"{empty:.4f}, charging {full - prim:.4f}")
    xyz, s = calls[0][0][0], calls[0][0][0].shape[1]
    shapes = {}
    for b in (B_CHECK, B_TRAIN, B_BENCH):
        x = xyz.repeat(b // B_CHECK, 1, 1).contiguous()
        w = expansion_penalty.WARPS
        full = cuda_ms(lambda: expansion_penalty.mst_charges(x), reps=10)
        prim = cuda_ms(lambda: expansion_penalty.mst_floor(x, "prim"), reps=10)
        empty = cuda_ms(lambda: expansion_penalty.mst_floor(x, "floor"), reps=10)
        charging = max(full - prim, 0.0)  # the two differ by less than their spread
        shapes[b] = {"warps": w, "ms": full, "empty_step_us": 1e3 * empty / (s - 1),
                     "floor_ms": empty + charging}
        log(f"  expansion at B={b} {list(x.shape)}: {w} warps a primitive; "
            f"{full:.4f} ms a call, Prim's steps {prim:.4f}, empty step "
            f"{1e3 * empty / (s - 1):.4f} us, charging {full - prim:.4f} ms, "
            f"floor {empty + charging:.4f} ms ((S-1) x empty step + "
            f"charging, a negative charging read as 0) on {nvidia_smi()}")
    FLOOR["expansion"] = shapes
    return floor_ms


def slice_plans(calls, name: str, batch: int) -> dict:
    """Phases 4 and 9: each of a path's calls of a slice kernel (gather-max,
    the edge-stats forward) with its plan (width, row groups, shared
    memory, blocks), its time (CUDA events over calls back to back, which
    count the host's enqueue where a call enqueues slower than it runs, and
    with the host ahead: host_ahead_ms) and its share of the byte bound,
    on the
    path's own inputs (B_CHECK clouds) and on them repeated to ``batch``
    clouds (the B=32 forward's, the B=24 step's). Returns, for each batch,
    the calls' plans and their summed times and bounds."""
    bound_fn = SPECS[name][3]
    got = {}
    for b in (B_CHECK, batch):
        tot = {"ms": 0.0, "host_ahead_ms": 0.0, "bound_ms": 0.0, "plans": []}
        for i, (args, kw, _) in enumerate(calls):
            reps = b // B_CHECK
            a = tuple(x.repeat(reps, 1, 1).contiguous() for x in args[:2]) + tuple(args[2:])
            n, c = a[0].shape[1:]
            m, k = a[1].shape[1:]
            plan = slice_plan(b, n, m, c, k)
            ms = cuda_ms(lambda: KERNEL[name](*a, **kw), reps=10)
            ahead_ms = host_ahead_ms(lambda: KERNEL[name](*a, **kw))
            b_ms, _ = bound_fn(a, KERNEL[name](*a, **kw))
            tot["ms"] += ms
            tot["host_ahead_ms"] += ahead_ms
            tot["bound_ms"] += b_ms
            tot["plans"].append({k_: plan[k_] for k_ in ("width", "groups",
                                                         "smem", "blocks")})
            log(f"  {name} call {i} at B={b} [{b}, {n}, {c}]: plan W="
                f"{plan['width']} G={plan['groups']}, shared memory "
                f"{plan['smem']} B, {plan['blocks']} blocks of "
                f"{plan['threads']}; {ms:.4f} ms, host ahead {ahead_ms:.4f} "
                f"ms, bound {b_ms:.5f} ms ({100 * b_ms / ahead_ms:.1f}% of "
                f"the host-ahead time)")
            del a
        log(f"  {name}: the {len(calls)} calls at B={b}: {tot['ms']:.4f} ms "
            f"(host ahead {tot['host_ahead_ms']:.4f} ms) against a "
            f"{tot['bound_ms']:.5f} ms byte bound ("
            f"{100 * tot['bound_ms'] / tot['ms']:.1f}%; "
            f"{100 * tot['bound_ms'] / tot['host_ahead_ms']:.1f}% of the "
            f"host-ahead time) on {nvidia_smi()}")
        got[f"b{b}"] = tot
    return got


def _library_knn(x, k=8, packed=False):
    """cdist + topk: ranks the exact f32 distances (neither the bf16 split
    of parity mode nor serving mode's one bf16 pass and truncated keys)."""
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


def compare_exact_nan(got, want):
    """As compare_exact, with NaN equal to NaN at the same place."""
    same = all(nan_equal(g, w) for g, w in zip(got, want))
    n_bad = sum(int(((g != w) & ~(g.isnan() & w.isnan())).sum())
                for g, w in zip(got, want))
    return (same, 0.0 if same else float("nan"),
            f"outputs exact (NaN-aware)={same}, {n_bad} elements differ")


def _library_nn(x1, x2):
    return torch.cdist(x1, x2).argmin(-1)


def _library_bids(x1, x2, price, count=None):
    """cdist and topk over the bidders the call scores: the list cut to its
    largest count where the call has counts (a host read)."""
    if count is not None:
        x1 = x1[:, :max(1, int(count.max()))]
    return ((3.0 - price)[:, None, :] - torch.cdist(x1, x2)).topk(2, -1)


def _bids_pairs(a) -> float:
    """(bidder, object) pairs the call scores: count[b] bidders a cloud
    where the call has counts (this run's data), else all M."""
    b, m = a[0].shape[:2]
    rows = b * m if len(a) < 4 or a[3] is None else float(a[3].sum())
    return rows * a[1].shape[1]


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
    # as nn_idx plus the square root, a subtraction and a second compare,
    # for the pairs of the bidders the call scores
    "emd_bids": (_library_bids, 3, lambda a, got, want: compare_exact(got, want),
                 lambda a, out: bound(
                     4 * (a[0].numel() + a[1].numel() + a[2].numel()
                          + 2 * out[0].numel()),
                     11.0 * _bids_pairs(a), FP32_FLOPS)),
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



def compare_p2i(got, want):
    """Values and winner ids bit for bit (ids only where asked for)."""
    return compare_exact(tuple(t for t in got if t is not None),
                         tuple(t for t in want if t is not None))


def _library_p2i(points, feats, binds, b, h, w, radius, with_ids=True):
    """Window expansion and one scatter_reduce_(amax) a point chunk: the
    values only (PyTorch has no call that returns the winner ids)."""
    return p2i_op.p2i_max_plain(points, feats, binds, b, h, w, radius, False)


def _bound_p2i(a, out):
    """Points, features and image indices read once, the image (and ids)
    written once; about 26 fp32 operations for each pixel of each point's
    (2 ceil(R) + 2)^2 window."""
    points, _, _, b, h, w, radius = a[:7]
    n_out = 2 if out[1] is not None else 1
    p = points.shape[0]
    return bound(16.0 * p + 4.0 * n_out * b * h * w,
                 26.0 * p * p2i_op.window_size(radius) ** 2, FP32_FLOPS)


SPECS["p2i"] = (_library_p2i, 5, lambda a, got, want: compare_p2i(got, want),
                _bound_p2i)


def compare_rel(got, want, rtol: float = 1e-6):
    """Every output within rtol of its largest entry (sums in another
    order)."""
    worst, ok = 0.0, True
    for g, w in zip(got, want):
        err = float((g - w).abs().max())
        ok = ok and err <= rtol * float(w.abs().max())
        worst = max(worst, err)
    return ok, worst, (f"max abs err {worst:.3e} (limit {rtol:g} of the "
                       f"largest entry: {'within' if ok else 'NOT within'})")


def _bound_p2i_bwd(a, out):
    """Points, features and image indices read once and the gradients
    written once (28 bytes a point), the ids and g images read once; two
    operations for each window pixel's id test and about 40 for each pixel
    the point won (this run's ids)."""
    points, _, _, ids, g, radius = a[:6]
    p = points.shape[0]
    won = int((ids >= 0).sum())
    return bound(28.0 * p + 8.0 * g.numel(),
                 2.0 * p * p2i_op.window_size(radius) ** 2 + 40.0 * won,
                 FP32_FLOPS)


SPECS.update({
    # one bf16 product a (query, candidate, channel) triple: 2 B N^2 C
    # operations at the bf16 tensor-core peak
    "knn_packed": (_library_knn, 5, lambda a, got, want: compare_exact(got, want),
                   lambda a, out: bound(4 * (a[0].numel() + out.numel()),
                                        2.0 * a[0].numel() * a[0].shape[1],
                                        BF16_FLOPS)),
    # steps updates of N live lanes, ~12 operations each (as mds)
    "mds_continue": (None, 3, lambda a, got, want: compare_exact(got, want),
                     lambda a, out: bound(
                         4 * (a[0].numel() + a[1].numel() + a[2].numel()
                              + a[3].numel() + out.numel()),
                         12.0 * a[0].shape[0] * a[4] * a[0].shape[1],
                         FP32_FLOPS)),
    "p2i_bwd": (None, 5, lambda a, got, want: compare_rel(got, want),
                _bound_p2i_bwd),
})


# ---------------------------------------------------------------------------
# phase 7: the training kernels against their plain versions, random inputs
# ---------------------------------------------------------------------------

def _dup_cloud(gen, b, n):
    """Every point twice (exact distance ties)."""
    half = torch.rand(b, n // 2, 3, generator=gen) - 0.5
    return torch.cat([half, half.flip(1)], 1)


def nn_edge_inputs(gen, b, n1, n2):
    """x1 [b, n1] and x2 [b, n2]: half of x2 repeated (exact ties), the
    first queries on candidates, a NaN query and a NaN candidate."""
    x2 = torch.rand(b, n2, 3, generator=gen) - 0.5
    h = n2 // 2
    x2[:, h:2 * h] = x2[:, :h].flip(1)
    x1 = torch.rand(b, n1, 3, generator=gen) - 0.5
    x1[:, :8] = x2[:, :8].flip(1)
    x1[0, 9] = float("nan")
    x2[-1, n2 // 3] = float("nan")
    return x1, x2


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
        for u in (1, 37, 8908, N_OUT):      # an auction's rounds: full width
            count = torch.tensor([u, max(1, u // 3), u, 1][:b] + [u] * (b - 4),
                                 dtype=torch.int32, device=dev)
            verdict("emd_bids", f"{what}, full-width list, counts "
                    f"{count.tolist()}, grid {emd.bids_plan(b, N_OUT, N_OUT, u)}",
                    compare_exact(emd.emd_bids(x1, x2, price, count),
                                  emd.emd_bids_plain(x1, x2, price, count)))
    for n2 in (1, 2047, 2049, N_OUT):     # around a tile, one point, the step's
        x1, x2 = (t.to(dev) for t in nn_edge_inputs(gen, b, N_OUT, n2))
        verdict("nn_idx", f"[{b}, {N_OUT}] x [{b}, {n2}], duplicated points, a "
                f"NaN query and a NaN candidate, "
                f"{chamfer_op.nn_splits(b, N_OUT, n2)} candidate splits",
                compare_exact(chamfer_op.nn_idx(x1, x2),
                              chamfer_op.nn_idx_plain(x1, x2)))
    n = N_INPUT_POINTS
    table, idx = gather_inputs(gen, dev, b, n, n, 256, nan=True)
    want = edge_gather.edge_stats_fwd_plain(table, idx)
    plan = slice_plan(b, n, n, 256, K)
    verdict("edge_stats_fwd", f"[{b}, {n}, 256] with NaN rows, plan "
            f"W={plan['width']} G={plan['groups']}", compare_exact_nan(
                edge_gather.edge_stats_fwd(table, idx), want))
    for shape, width, split in SLICE_SHAPES:
        planned, what = plan_as_expected(shape, width, split)
        table, idx = gather_inputs(gen, dev, *shape, nan=True)
        ok, e, msg = compare_exact_nan(edge_gather.edge_stats_fwd(table, idx),
                                       edge_gather.edge_stats_fwd_plain(table, idx))
        verdict("edge_stats_fwd", f"{what} with NaN rows",
                (ok and planned, e, msg))
    nn_, m, c = ROW_PATH_SHAPE
    table, idx = gather_inputs(gen, dev, b, nn_, m, c)
    verdict("edge_stats_fwd", f"[{b}, {nn_}, {c}] -> {m} rows, past the "
            f"slices' reach (plan W={slice_plan(b, nn_, m, c, K)['width']})",
            compare_exact(edge_gather.edge_stats_fwd(table, idx),
                          edge_gather.edge_stats_fwd_plain(table, idx)))
    for c, k, rows in ((256, K, n), (512, K, n), (1024, K, n), (3, K, n),
                       (256, 16, n), (256, 20, n), (256, K, 4000)):
        table = torch.randn(b, rows, c, generator=gen)
        table[:, 1] = table[:, 0]                   # equal rows
        idx = torch.randint(0, rows, (b, rows, k), generator=gen, dtype=torch.int32)
        idx[:, :, k - 1] = idx[:, :, 0]             # equal slots
        idx[:, :4] = torch.arange(k, dtype=torch.int32) % 2
        table, idx = table.to(dev), idx.to(dev)
        outs = edge_gather.edge_stats_fwd(table, idx)
        what = f"[{b}, {rows}, {c}], k={k}"
        verdict("edge_stats_fwd", what, compare_exact(
            outs, edge_gather.edge_stats_fwd_plain(table, idx)))
        grads = [torch.randn(b, rows, c, generator=gen).to(dev) for _ in range(4)]
        lists = ("shared" if edge_gather.lists_scratch_ints(b, rows, rows, k) == 0
                 else "device")
        verdict("edge_stats_bwd", f"{what}, inverse lists in {lists} memory",
                compare_exact(
                    edge_gather.edge_stats_bwd(table, idx, outs[0], outs[1], *grads),
                    edge_gather.edge_stats_bwd_plain(table, idx, outs[0], outs[1],
                                                     *grads)))
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


def bids_without_second(xyz1, xyz2, price, count=None):
    """Bids whose increment ignores the second-best value (best - best)."""
    t, inc = emd.emd_bids_plain(xyz1, xyz2, price, count)
    return t, torch.zeros_like(inc)


@contextlib.contextmanager
def deterministic():
    """Deterministic mode as a user turns it on: an op with no deterministic
    form raises (no warn_only), cuBLAS with the workspace set above."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def compare_steps(state, partial, gt, calls, dev) -> None:
    """Kernel step against plain steps replaying its kNN graphs and MDS
    picks, all in deterministic mode, and two perturbed-op controls."""
    with deterministic():
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


_TRAIN_GROUPS = (("mds", ("mds_cluster_kernel",)),
                 ("emd_bids", ("bids_kernel", "bids_merge_kernel")),
                 ("knn", KNN_KERNELS),
                 ("nn_idx", ("nn_split_kernel", "nn_merge_kernel")),
                 ("p2i", P2I_KERNELS),
                 ("edge_stats", STATS_FWD_KERNELS + sum(EDGE_BWD_PARTS.values(), ())),
                 ("expansion", EXPANSION_KERNELS),
                 ("gemm", ("gemm", "xmma", "cutlass", "cublas")),
                 ("conv (cuDNN)", ("conv", "cudnn", "implicit", "wgrad", "dgrad")))


def profiled(body, cpu: bool = False, tries: int = 3):
    """A torch.profiler session (CUDA, and the CPU where ``cpu``) over
    ``body()``, which synchronises the card; opened again where a session
    recorded no device time, up to ``tries`` sessions, each reopening
    logged. On an H100 a session now and then records none (1 of 900
    short sessions of scripts/port_profiler_sessions.py, cause not found);
    the callers fail where the last session is empty too. Returns the
    last session's profiler and body's result."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for i in range(tries):
        with profile(activities=acts) as prof:
            got = body()
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 for e in prof.key_averages()):
            break
        log(f"  the profiler recorded no device time in session {i + 1} of "
            f"{tries}")
    return prof, got


def profile_step(run, b: int) -> None:
    """One profiled step (``run()``, synchronised): device time by kernel
    group, busy share of the wall time."""
    def body():
        t = time.perf_counter()
        run()
        return (time.perf_counter() - t) * 1e3
    prof, wall_ms = profiled(body, cpu=True)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if not busy:
        fail("the profiler saw no device time in the step")
        return
    groups = dict.fromkeys([g for g, _ in _TRAIN_GROUPS] + ["other"], 0.0)
    for key, ms, _ in kernels:
        name = next((g for g, pats in _TRAIN_GROUPS
                     if any(p in key.lower() for p in pats)), "other")
        groups[name] += ms
    log(f"  profile step B={b}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:12s} {ms:9.2f} ms  {100 * ms / busy:5.1f}% of busy")
    for key, ms, n in sorted(kernels, key=lambda k: -k[1])[:15]:
        log(f"    {ms:9.2f} ms  x{n:<5d} {key[:110]}")


def kernel_parts(calls, name: str, groups: dict, reps: int = 5) -> dict:
    """Device ms of each group of a wrapper's kernels (by kernel name),
    summed over the recorded calls, by torch.profiler over ``reps`` launches
    a call after a warm-up."""
    tot = dict.fromkeys(groups, 0.0)
    for args, kw, _ in calls:
        KERNEL[name](*args, **kw)
        torch.cuda.synchronize()

        def body():
            for _ in range(reps):
                KERNEL[name](*args, **kw)
            torch.cuda.synchronize()
        prof, _ = profiled(body)
        for e in prof.key_averages():
            g = next((g for g, pats in groups.items()
                      if any(p in e.key for p in pats)), None)
            if g:
                tot[g] += e.self_device_time_total / 1e3 / reps
    if not sum(tot.values()):
        fail(f"the profiler saw no device time in {name}'s kernels")
    return tot


def device_timeline(fn, names, reps: int = 5) -> dict:
    """Where back-to-back calls of ``fn`` spend their time on the card:
    "host_enqueue_ms", the host's ms to enqueue a call (the loop of calls
    before its synchronisation); "ms_host_ahead", the calls' ms a call by
    CUDA events when they are enqueued behind a spin kernel of about 10 ms,
    so the host is out of the way and the card runs them as fast as it
    can; and, from torch.profiler's device records of such calls after the
    spin kernel (the ops whose names hold one of ``names``; "records"
    counts them by name), "timeline": averaged over the calls, each op's us
    and the card's idle us before it within the call, a call's span, busy
    and idle ms, and the idle ms between calls (None where the records do
    not split into calls of the same ops)."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    out = {"host_enqueue_ms": host, "ms_host_ahead": host_ahead_ms(fn, reps),
           "timeline": None}
    def body():
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof, _ = profiled(body)
    dev_ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    after = max((e.time_range.end for e in dev_ops if "spin_kernel" in e.name),
                default=float("-inf"))
    ops = sorted((e.time_range.start, e.time_range.end,
                  (re.search(r"\w+_kernel|Memset|Memcpy", e.name)
                   or re.match(r".{0,40}", e.name)).group(0)) for e in dev_ops
                 if e.time_range.start >= after and any(p in e.name for p in names))
    out["records"] = {k: sum(o[2] == k for o in ops) for k in sorted({o[2] for o in ops})}
    n = len(ops) // reps
    calls = [ops[i * n:(i + 1) * n] for i in range(reps)]
    if not n or len(ops) % reps or any(
            [o[2] for o in c] != [o[2] for o in calls[0]] for c in calls):
        return out
    op_us = [sum(c[j][1] - c[j][0] for c in calls) / reps for j in range(n)]
    idle_us = [0.0] + [sum(c[j][0] - c[j - 1][1] for c in calls) / reps
                       for j in range(1, n)]
    out["timeline"] = {
        "ops": [o[2] for o in calls[0]], "op_us": op_us, "idle_before_us": idle_us,
        "span_ms": sum(c[-1][1] - c[0][0] for c in calls) / reps / 1e3,
        "busy_ms": sum(op_us) / 1e3, "idle_in_call_ms": sum(idle_us) / 1e3,
        "idle_between_calls_ms": sum(calls[i][0][0] - calls[i - 1][-1][1]
                                     for i in range(1, reps)) / (reps - 1) / 1e3}
    return out


def timed_steps(run, n: int = 3) -> float:
    """ms per synchronised step over n steps (``run(i)``)."""
    t = time.perf_counter()
    for i in range(n):
        run(i)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / n


def step_times(run, n: int = 3) -> list[float]:
    """ms of each of n steps (``run(i)``), each synchronised."""
    out = []
    for i in range(n):
        t = time.perf_counter()
        run(i)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def allocator_counts() -> dict:
    """The caching allocator's counts of retries (a malloc that failed,
    freed the cache and tried again) and of cudaMalloc and cudaFree calls."""
    st = torch.cuda.memory_stats()
    return {k: int(st.get(k, 0)) for k in ("num_alloc_retries",
                                           "num_device_alloc", "num_device_free")}


def train_throughput(state, gen, dev) -> None:
    """Steps at B=24, or the largest batch that fits: ms per step over 3
    steps after one warm-up, clouds/s, peak memory; one profiled step; the
    3 steps again in deterministic mode."""
    for b in (B_TRAIN, 16, 12, 8):
        model = opt = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            model, opt = fresh_model(state, dev)
            partial, gt = (t.to(dev) for t in train_batch(gen, b))
            run_step(model, opt, partial, gt)
            ms = timed_steps(lambda i: run_step(model, opt, partial, gt))
        except torch.cuda.OutOfMemoryError:
            log(f"  B={b}: out of memory (peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
            del model, opt
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  B={b}: {ms:.1f} ms per training step, {b / (ms / 1e3):.2f} "
            f"clouds/s, peak memory {peak:.2f} GiB (max_memory_allocated) "
            f"on {nvidia_smi()}")
        padded = zero_padded(partial)
        flagged = flagged_by(lambda: run_step(model, opt, padded, gt),
                             "knn_flagged")
        pad_ms = timed_steps(lambda i: run_step(model, opt, padded, gt))
        log(f"  B={b}, zero-padded partial clouds: {pad_ms:.1f} ms per "
            f"training step; kNN queries flagged for the exact scan "
            f"{flagged} of {4 * b * N_INPUT_POINTS}")
        PATHS.update({f"train_b{b}_ms": ms, f"train_b{b}_padded_ms": pad_ms,
                      f"train_b{b}_padded_flagged": flagged})
        profile_step(lambda: run_step(model, opt, partial, gt), b)
        with deterministic():
            det = timed_steps(lambda i: run_step(model, opt, partial, gt))
        log(f"  B={b} in deterministic mode: {det:.1f} ms per training step "
            f"({b / (det / 1e3):.2f} clouds/s), {det / ms:.3f}x the default "
            f"mode's {ms:.1f} ms")
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
    rows["edge_stats_fwd"]["plans"] = slice_plans(calls["edge_stats_fwd"],
                                                  "edge_stats_fwd", B_TRAIN)
    parts = kernel_parts(calls["edge_stats_bwd"], "edge_stats_bwd", EDGE_BWD_PARTS)
    rows["edge_stats_bwd"]["parts_ms"] = parts
    log(f"  edge_stats_bwd by part over the step's "
        f"{len(calls['edge_stats_bwd'])} calls (device ms, torch.profiler): "
        + ", ".join(f"{p} {v:.4f}" for p, v in parts.items()) + "; inverse "
        "lists in " + ", ".join(
            "shared" if edge_gather.lists_scratch_ints(
                a[0].shape[0], a[0].shape[1], a[1].shape[1], a[1].shape[2]) == 0
            else "device" for a, _, _ in calls["edge_stats_bwd"]) + " memory")
    rows["nn_idx"]["splits"] = [chamfer_op.nn_splits(
        a[0].shape[0], a[0].shape[1], a[1].shape[1]) for a, _, _ in calls["nn_idx"]]
    log(f"  nn_idx candidate splits a call: {rows['nn_idx']['splits']}")
    us = [int(a[3].max()) for a, _, _ in calls["emd_bids"]]
    b, m = calls["emd_bids"][0][0][0].shape[:2]
    log(f"  emd_bids grid: {len(us)} calls, u from {min(us)} to {max(us)} "
        f"bidders; at u={max(us)} {emd.bids_plan(b, m, m, max(us))}, at "
        f"u={min(us)} {emd.bids_plan(b, m, m, min(us))}; rounds with u = 0 "
        f"run (no host read a round): {sum(u == 0 for u in us)}")

    log("phase 10: the kernel step against the anchored plain step")
    compare_steps(model_state, partial, gt, calls, dev)
    return launches, rows, errs


# ---------------------------------------------------------------------------
# phases 12-16: the SpareNet-GAN step
# ---------------------------------------------------------------------------

GAN_EXPECTED = TRAIN_EXPECTED + ("p2i", "p2i_bwd")
GAN_CHECK_RADIUS = 10.0       # the largest of sparenet_gan.yaml's windows
MASK_SEED = 5                 # the dropout masks of every GAN step here


def splat_inputs(gen, dev, b: int):
    """The renderer's layout: B clouds x 8 views of 16384 points projected
    at 256 x 256, image-major rows; in every image 1/16 of the points moved
    onto pixel centres (exact distance ties) and 1/16 duplicated (equal
    values)."""
    r = ComputeDepthMaps(image_size=IMG)
    cloud = torch.rand(b, N_OUT, 3, generator=gen) - 0.5
    pix, feat = r._project(cloud, r.matrices[:, None])
    v = r.num_views
    pix = pix.transpose(0, 1).reshape(b * v, N_OUT, 2).clone()
    feat = feat.transpose(0, 1).reshape(b * v, N_OUT, 1).clone()
    q = N_OUT // 16
    pix[:, :q] = pix[:, :q].round()
    pix[:, q:2 * q] = pix[:, 2 * q:3 * q]
    feat[:, q:2 * q] = feat[:, 2 * q:3 * q]
    binds = torch.arange(b * v, dtype=torch.int32).repeat_interleave(N_OUT)
    return (pix.reshape(-1, 2).to(dev), feat.reshape(-1, 1).to(dev),
            binds.to(dev), b * v)


def check_random_p2i(gen, dev) -> float:
    """Phase 12; returns the largest error. The renderer's layout, the same
    points in a scrambled order (image indices not grouped), and a crowded
    tile (100000 more points within 8 pixels of one spot of image 0), at
    R = 4.5 and every radius of sparenet_gan.yaml, with and without ids;
    at the kernel's tiles and work items and at small ones (16 x 32 tiles,
    512 window pixels an item: most bins split and merge)."""
    worst = 0.0
    pts, feat, binds, n_img = splat_inputs(gen, dev, B_CHECK)
    perm = torch.randperm(len(binds), generator=gen).to(dev)
    crowd = (torch.rand(100000, 2, generator=gen) * 8 + (IMG / 2 - 4)).to(dev)
    cases = {
        "image-major": (pts, feat, binds),
        "scrambled": (pts[perm].contiguous(), feat[perm].contiguous(),
                      binds[perm].contiguous()),
        "crowded tile": (torch.cat([pts, crowd]),
                         torch.cat([feat, torch.rand(100000, 1, generator=gen).to(dev)]),
                         torch.cat([binds, torch.zeros(100000, dtype=torch.int32,
                                                       device=dev)]))}
    for radius in (4.5,) + tuple(RADII):
        for case, (p, f, b) in cases.items():
            for with_ids in (True, False):
                args = (p, f, b, n_img, IMG, IMG, radius, with_ids)
                want = p2i_op.p2i_max_plain(*args)
                for tile, item in ((p2i_op.TILE, p2i_op.ITEM_PIXELS), ((16, 32), 512)):
                    ok, err, msg = compare_p2i(p2i_op.p2i_max(
                        *args, _tile=tile, _item_pixels=item), want)
                    worst = max(worst, err)
                    log(f"  p2i R={radius} {case} {'with' if with_ids else 'without'} "
                        f"ids, {p.shape[0]} points into {n_img} images, tiles "
                        f"{tile}, {item} pixels an item: {msg}")
                    if not ok:
                        fail(f"p2i R={radius} {case}: kernel differs from the "
                             f"plain version")
    return worst


def p2i_backward_b32(dev) -> None:
    """The backward at the B_GAN step's shape (B_GAN x 8 views of N_OUT
    points into 256 x 256 images) at each radius of sparenet_gan.yaml, on
    the splat's own winner ids: ms a call (CUDA events) and by part."""
    gen = torch.Generator().manual_seed(8)
    pts, feat, binds, n_img = splat_inputs(gen, dev, B_GAN)
    for radius in RADII:
        _, ids = p2i_op.p2i_max(pts, feat, binds, n_img, IMG, IMG, radius, True)
        g = torch.randn(n_img, IMG, IMG, 1, generator=gen).to(dev)
        args = (pts, feat, binds, ids, g, radius)
        ms = cuda_ms(lambda: p2i_op.p2i_max_backward(*args), reps=5)
        parts = kernel_parts([(args, {}, None)], "p2i_bwd", P2I_BWD_PARTS)
        log(f"  p2i_bwd at B={B_GAN}, R={radius}, {pts.shape[0]} points: "
            f"{ms:.4f} ms a call; " + ", ".join(
                f"{p} {v:.4f}" for p, v in parts.items()) + f" (device ms) on "
            f"{nvidia_smi()}")
        PATHS[f"p2i_bwd_b{B_GAN}_r{radius:g}_ms"] = ms
    del pts, feat, binds, ids, g


def fresh_gan(gstate: dict, dstate: dict, dev):
    """Generator and discriminator holding the states on the card, and new
    Adams over them."""
    gen, opt_g = fresh_model(gstate, dev)
    disc = build_discriminator(seed=1, device="cpu", image_size=IMG).to(dev)
    disc.load_state_dict(dstate)
    return gen, disc, opt_g, train_base.make_optimizer(disc, gan_runner.CONFIG)


def run_gan(models, partial, gt, radius, keep_grads: bool = True):
    """One GAN step with the dropout masks of MASK_SEED: (losses, gradient
    leaves of the generator and, under "D.", of the discriminator)."""
    gen, disc, opt_g, opt_d = models
    labels = torch.zeros(partial.shape[0], dtype=torch.int32)
    losses = gan_runner.gan_step(gen, disc, opt_g, opt_d, partial, gt, labels,
                                 gan_runner.CONFIG["learning_rate"], radius,
                                 torch.Generator().manual_seed(MASK_SEED))
    torch.cuda.synchronize()
    if not keep_grads:
        return None
    grads = {n: p.grad.detach().clone() for n, p in gen.named_parameters()
             if p.grad is not None}
    grads.update({f"D.{n}": p.grad.detach().clone()
                  for n, p in disc.named_parameters()})
    return [float(v) for v in losses], grads


def project_per_cloud(self, data, matrix):
    """The renderer's projection with z normalised per cloud instead of
    over the batch (a forward fault)."""
    trans = transform_points(matrix, data)
    xs, ys, zs = trans.unbind(-1)
    pix = (torch.stack([-ys, xs], -1) + 1.0) * ((self.image_size - 1) / 2.0)
    zmin, zmax = zs.amin(-1, keepdim=True), zs.amax(-1, keepdim=True)
    return pix, (1.0 - (zs - zmin) / (zmax - zmin))[..., None]


def p2i_backward_without_points(points, feats, binds, ids, g, radius):
    """A p2i backward that drops the gradient to the point coordinates (a
    backward-only fault: the losses do not move)."""
    pt, pf = p2i_op.p2i_max_backward_plain(points, feats, binds, ids, g, radius)
    return torch.zeros_like(pt), pf


def compare_gan_steps(gstate, dstate, partial, gt, calls, dev) -> None:
    """Phase 15: the kernel GAN step against a plain one replaying its kNN
    graphs and MDS picks (the masks come from one seed), all in
    deterministic mode, with the training step's limits, and two controls.
    The plain step also replays the kernel step's p2i backward: its plain
    version scatters with index_add_, which sums each point's pixels in
    another order, and the gradients that are exactly 0 in exact
    arithmetic (ZERO_GRAD) carry that rounding at their own size; the
    kernel is held to the plain version on the step's own inputs here."""
    r = GAN_CHECK_RADIUS
    with deterministic():
        bwd: dict = {}
        with swapped(p2i_bwd=recording(bwd)["p2i_bwd"]):
            kern = run_gan(fresh_gan(gstate, dstate, dev), partial, gt, r)
        for args, kw, out in bwd["p2i_bwd"]:
            ok, err, msg = compare_rel(out, PLAIN["p2i_bwd"](*args, **kw))
            log(f"  p2i backward of this step against its plain version: {msg}")
            if not ok:
                fail("p2i_bwd in the deterministic GAN step: kernel differs "
                     "from the plain version")
        kern2 = run_gan(fresh_gan(gstate, dstate, dev), partial, gt, r)
        loss, rel, zero, worst = step_gaps(kern2, kern)
        log(f"  kernel GAN step twice: loss rel gap {loss:.3e}, gradient leaf "
            f"relative-L2 gap {rel:.3e} ({worst}), zero-gradient leaves "
            f"{zero:.3e}")

        def fixed():
            return dict(knn=replay(calls["knn"]), mds=replay(calls["mds"]))
        with swapped(**dict(PLAIN, **fixed(),
                            p2i_bwd=replay(bwd["p2i_bwd"]))):
            p = run_gan(fresh_gan(gstate, dstate, dev), partial, gt, r)
        loss, rel, zero, worst = step_gaps(kern, p)
        log(f"  kernel GAN step vs plain GAN step (kNN graphs, MDS picks, "
            f"dropout masks and p2i backward replayed): losses {kern[0]} vs {p[0]}, loss rel "
            f"gap {loss:.3e} (limit {STEP_LOSS_RTOL:g}), gradient leaf "
            f"relative-L2 gap {rel:.3e} ({worst}; limit {STEP_GRAD_REL:g}), "
            f"zero-gradient leaves {zero:.3e} (limit {STEP_ZERO_ABS:g})")
        if loss > STEP_LOSS_RTOL or rel > STEP_GRAD_REL or zero > STEP_ZERO_ABS:
            fail("the kernel GAN step differs from the anchored plain step")
        for obj, name, fn, what in (
                (ComputeDepthMaps, "_project", project_per_cloud,
                 "renderer normalising depth per cloud"),
                (p2i_op, "p2i_max_backward", p2i_backward_without_points,
                 "p2i backward without the point-coordinate term")):
            with patched((obj, name, fn)), swapped(**fixed()):
                c = run_gan(fresh_gan(gstate, dstate, dev), partial, gt, r)
            loss, rel, zero, worst = step_gaps(c, kern)
            caught = (loss > STEP_LOSS_RTOL or rel > STEP_GRAD_REL
                      or zero > STEP_ZERO_ABS)
            log(f"  control, {what}: loss rel gap {loss:.3e}, gradient leaf "
                f"relative-L2 gap {rel:.3e} ({worst}): "
                f"{'caught' if caught else 'NOT caught'}")
            if not caught:
                fail(f"the GAN step check does not see a {what}")


def main_gan(gstate: dict, dstate: dict, dev) -> tuple[dict, dict]:
    """Phases 12-15; returns (launches, the p2i row)."""
    log(f"phase 12: the p2i kernel against its plain version, random inputs "
        f"in the renderer's layout (B={B_CHECK} x 8 views, {IMG} x {IMG})")
    err = check_random_p2i(torch.Generator().manual_seed(4), dev)

    log(f"phase 13: the third main path, one SpareNet-GAN step at "
        f"B={B_CHECK}, radius {GAN_CHECK_RADIUS}")
    gen = torch.Generator().manual_seed(6)
    partial, gt = (t.to(dev) for t in train_batch(gen, B_CHECK))
    models = fresh_gan(gstate, dstate, dev)
    calls: dict = {}
    with swapped(**recording(calls)):
        _lib.reset_counts()
        t = time.perf_counter()
        losses, grads = run_gan(models, partial, gt, GAN_CHECK_RADIUS)
        launches, plain = dict(_lib.LAUNCHES), dict(_lib.PLAIN_CALLS)
    log(f"  kernel GAN step: {time.perf_counter() - t:.2f} s; losses (rec, "
        f"coarse, refine, errG, errG_D, errD_real, errD_fake) {losses}; "
        f"launches {launches}, plain calls {plain}")
    if not all(map(math.isfinite, losses)):
        fail(f"GAN losses not finite: {losses}")
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad:
        fail(f"non-finite gradients in {bad[:5]}")
    for name in GAN_EXPECTED:
        log(f"  {name}: {launches[name]} launches, {plain[name]} plain calls")
        if launches[name] < 1 or plain[name] != 0:
            fail(f"{name}: {launches[name]} launches, {plain[name]} plain calls "
                 f"in the GAN step")
    if launches["p2i"] != 3 or launches["p2i_bwd"] != 1:
        fail(f"p2i: {launches['p2i']} launches and {launches['p2i_bwd']} of "
             f"its backward in the GAN step, expected 3 and 1")
    if sum(plain.values()):
        fail(f"plain versions ran in the GAN step: {plain}")
    del models

    log("phase 14: the p2i kernel and its backward on the inputs the GAN "
        "step gave them")
    rows = check_forward_calls(calls, {"p2i": err, "p2i_bwd": 0.0},
                               ("p2i", "p2i_bwd"), "GAN step")
    parts = kernel_parts(calls["p2i_bwd"], "p2i_bwd", P2I_BWD_PARTS)
    rows["p2i_bwd"]["parts_ms"] = parts
    log(f"  p2i_bwd by part over the step's {len(calls['p2i_bwd'])} call(s) "
        f"(device ms, torch.profiler): "
        + ", ".join(f"{p} {v:.4f}" for p, v in parts.items()))
    args = calls["p2i_bwd"][0][0]
    tl = device_timeline(lambda: KERNEL["p2i_bwd"](*args),
                         sum(P2I_BWD_PARTS.values(), ()))
    rows["p2i_bwd"]["timeline"] = tl
    line = tl["timeline"]
    log(f"  p2i_bwd on the step's input: {rows['p2i_bwd']['ms']:.4f} ms a call "
        f"back to back, {tl['ms_host_ahead']:.4f} with the calls enqueued "
        f"ahead of the card; host enqueue {tl['host_enqueue_ms']:.4f} ms a "
        f"call; profiler records after the spin kernel {tl['records']}: "
        + ("not split into calls" if line is None else ", ".join(
            f"{o} {u:.2f} us (idle before {i:.2f})" for o, u, i in zip(
                line["ops"], line["op_us"], line["idle_before_us"]))
           + f"; a call's span {line['span_ms']:.4f} ms, busy "
           f"{line['busy_ms']:.4f}, idle in the call {line['idle_in_call_ms']:.4f}, "
           f"idle between calls {line['idle_between_calls_ms']:.4f}")
        + f" on {nvidia_smi()}")
    for radius in sorted(set(RADII) | {GAN_CHECK_RADIUS}):
        log(f"  p2i_bwd plan at R={radius}: {p2i_op.bwd_plan(radius)}")
    p2i_backward_b32(dev)

    log("phase 15: the kernel GAN step against the anchored plain GAN step")
    compare_gan_steps(gstate, dstate, partial, gt, calls, dev)
    return launches, rows


def gan_throughput(gstate: dict, dstate: dict, gen, dev) -> None:
    """Phase 16: GAN steps at B=32, or the largest batch that fits, one
    radius of sparenet_gan.yaml each in turn: ms per step over 3 steps after
    one warm-up (each step synchronised and its ms printed, with the caching
    allocator's retries, cudaMalloc and cudaFree calls over the 3 and the
    memory earlier phases still hold), clouds/s, peak memory; one profiled
    step; the 3 steps and one profiled step again in deterministic mode."""
    for b in (B_GAN, 24, 16, 8):
        models = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        held_reserved = torch.cuda.memory_reserved()
        try:
            models = fresh_gan(gstate, dstate, dev)
            partial, gt = (t.to(dev) for t in train_batch(gen, b))

            def step(i):
                run_gan(models, partial, gt, RADII[i % len(RADII)], False)
            step(len(RADII) - 1)
            before = allocator_counts()
            each = step_times(step, len(RADII))
            after = allocator_counts()
            ms = sum(each) / len(each)
        except torch.cuda.OutOfMemoryError:
            log(f"  B={b}: out of memory (peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")
            models = None
            continue
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  B={b}: {ms:.1f} ms per GAN step (radii {list(RADII)}, one a "
            f"step), {b / (ms / 1e3):.2f} clouds/s, peak memory {peak:.2f} GiB "
            f"(max_memory_allocated) on {nvidia_smi()}")
        log(f"  B={b}: each step, ms (radius): " + ", ".join(
            f"{t:.1f} ({RADII[i % len(RADII)]})" for i, t in enumerate(each))
            + "; the caching allocator over the steps: " + ", ".join(
                f"{k} {after[k] - before[k]:+d}" for k in before)
            + f"; held before the phase {held / 2**30:.2f} GiB allocated, "
            f"{held_reserved / 2**30:.2f} GiB reserved")
        PATHS[f"gan_b{b}_ms"] = ms
        PATHS[f"gan_b{b}_step_ms"] = each
        profile_step(lambda: step(1), b)
        with deterministic():
            det = timed_steps(step, len(RADII))
            log(f"  B={b} in deterministic mode: {det:.1f} ms per GAN step "
                f"({b / (det / 1e3):.2f} clouds/s), {det / ms:.3f}x the "
                f"default mode's {ms:.1f} ms; one profiled step:")
            profile_step(lambda: step(1), b)
        return
    fail("no GAN batch fits on the card")


def check_forward_calls(calls: dict, errs: dict, names=EVAL_OPS,
                        what: str = "forward") -> dict:
    """Each recorded kernel call against the plain version on the same
    inputs; kernel, plain and library times per call, summed per forward
    (or step). The plain version's first call is its warm-up and its
    reference."""
    rows = {}
    for name in names:
        library, reps, compare, bound_fn = SPECS[name]
        tot = {"ms": 0.0, "host_ahead_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
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
            ahead = host_ahead_ms(lambda: KERNEL[name](*args, **kw), reps=reps)
            pms = cuda_ms(lambda: PLAIN[name](*args, **kw), reps=1, warmup=0)
            lms = (cuda_ms(lambda: library(*args, **kw), reps=3)
                   if library else None)
            b_ms, b_by = bound_fn(args, out)
            by.add(b_by)
            shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
            if len(calls[name]) <= 8 or i % 10 == 0:
                log(f"  {name} call {i} {shapes}: {msg}; kernel {ms:.4f} ms "
                    f"(host ahead {ahead:.4f}), plain {pms:.4f} ms"
                    + (f", library {lms:.4f} ms" if library else "")
                    + f", bound {b_ms:.5f} ms ({b_by})")
            tot["ms"] += ms
            tot["host_ahead_ms"] += ahead
            tot["plain_ms"] += pms
            tot["bound_ms"] += b_ms
            if library:
                tot["library_ms"] += lms
        tot["bound_by"] = "bytes" if by == {"bytes"} else "operations"
        lib_ms = "none" if library is None else f"{tot['library_ms']:.4f} ms"
        log(f"  {name}: {len(calls[name])} calls per {what}: kernel "
            f"{tot['ms']:.4f} ms (host ahead {tot['host_ahead_ms']:.4f} ms), "
            f"plain {tot['plain_ms']:.4f} ms, library "
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

    def knn_replay(x, k=8, packed=False):
        (x_k, *_), _, out = next(it)
        seen.append((x, x_k))
        if not perturb:
            return out
        nine = plain_knn(x_k, k + 1, packed)
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


_GROUPS = (("knn", KNN_KERNELS),
           ("gather_max", GATHER_KERNELS),
           ("expansion", EXPANSION_KERNELS),
           ("mds", ("mds_cluster_kernel",)),
           ("gemm", ("gemm", "xmma", "cutlass", "cublas")))


def profile_forward(model, partial, groups=None) -> None:
    """One profiled forward: device time by kernel group, busy share of
    the wall time (the profiler's own overhead counts as idle)."""
    groups_def = groups or _GROUPS
    def body():
        t = time.perf_counter()
        complete(model, partial)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3
    prof, wall_ms = profiled(body, cpu=True)
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    if not busy:
        fail("the profiler saw no device time")
        return
    groups = dict.fromkeys([g for g, _ in groups_def] + ["other"], 0.0)
    for key, ms, _ in kernels:
        name = next((g for g, pats in groups_def
                     if any(p in key.lower() for p in pats)), "other")
        groups[name] += ms
    log(f"  profile B={partial.shape[0]}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:10s} {ms:9.2f} ms  {100 * ms / busy:5.1f}% of busy")
    for key, ms, n in sorted(kernels, key=lambda k: -k[1])[:12]:
        log(f"    {ms:9.2f} ms  x{n:<4d} {key[:110]}")


# ---------------------------------------------------------------------------
# phases 17-20: the serving-mode forward
# ---------------------------------------------------------------------------

SERVING_ARMS = ("batched", "hybrid", "exact")
N_MDS = N_OUT + N_INPUT_POINTS                 # 19384 points the MDS sees
HYBRID_PREFIX = N_OUT - mds.TAIL               # 14336 batched picks
# Anchored serving forward (the plain forward replays the kernel forward's
# kNN graphs and MDS picks): only the gather-max sums' reassociation could
# separate the two, and the SE's bf16-rounded products could widen it to a
# bf16 ulp of a scale. Readings on an H100 80GB HBM3 at 700 W: every stage
# feature, coarse, middle and refine equal in all three arms. Limits: the
# parity forward's anchored limits.
SERVE_FEAT_ATOL, SERVE_COARSE_ATOL, SERVE_CHAMFER = (
    ANCHOR_FEAT_ATOL, ANCHOR_COARSE_ATOL, ANCHOR_CHAMFER)


def serving_model(state: dict, arm: str, dev):
    """The flagship generator in serving mode with the MDS arm ``arm``,
    holding ``state`` (the same parameters as the parity model)."""
    model = build_generator(seed=0, device="cpu", serving=True, mds=arm)
    model.load_state_dict(state)
    return model.to(dev).eval()


def continue_skipping_first_bump(xyz, temp0, orig, mml, steps):
    """A continuation that pins its first pick but never adds that pick's
    bump (a fault of the kernel's first step)."""
    first = mds.mds_continue_plain(xyz, temp0, orig, mml, 1)
    temp = temp0.clone()
    temp.scatter_(1, first.long(), 1e9)
    rest = mds.mds_continue_plain(xyz, temp, orig, mml, steps - 1)
    return torch.cat([first, rest], 1)


def check_continue_clusters(args, want, errs, what: str) -> None:
    """The continuation at every cluster size C = 1..16 that holds its
    lanes, forced, with compaction every mds.STAGE steps and none, against
    ``want`` (the plain version's picks): bit for bit, with the kernel's
    time at C = 1, 2, 4, 8, 16 and the shape the wrapper chooses."""
    xyz = args[0]
    first = 1 if xyz.shape[1] <= 20480 else 2
    same = []
    for c in range(first, 17):
        for stage in (mds.STAGE, 0):
            ok, err, _ = compare_exact(
                mds.mds_continue(*args, _cluster=c, _stage=stage), want)
            errs["mds_continue"] = max(errs["mds_continue"], err)
            same.append(ok)
            if not ok:
                fail(f"mds_continue {what}: C={c}, stage {stage} picks differ "
                     f"from the plain version's")
    times = {c: cuda_ms(lambda: mds.mds_continue(*args, _cluster=c), reps=2)
             for c in (1, 2, 4, 8, 16) if c >= first}
    shape = mds.continue_cluster_size(xyz.shape[0], xyz.shape[1])
    log(f"  mds_continue {what} {list(xyz.shape)}, {args[4]} steps: C = "
        f"{first}..16 (stage {mds.STAGE} and none) bit for bit equal to the "
        f"plain version: {all(same)}; (C, CTAs an SM) chosen {shape}; ms a "
        f"call at C " + ", ".join(f"{c}: {ms:.3f}" for c, ms in times.items()))


def continue_latency_floor(args) -> float:
    """The continuation's latency floor on ``args``: its chain of steps
    with no lane pass at the chosen C and at C = 1, 4, 16, in us a step;
    returns ms a call at the chosen C."""
    xyz, temp0, orig, mml, steps = args
    chosen = mds.continue_cluster_size(xyz.shape[0], xyz.shape[1])[0]
    us = {}
    for c in dict.fromkeys((chosen, 1, 4, 16)):
        ms = cuda_ms(lambda: mds.mds_continue_floor(xyz, temp0, orig, mml,
                                                    steps, c), reps=3)
        us[c] = 1e3 * ms / steps
    log(f"  mds_continue latency floor on {list(xyz.shape)}, {steps} steps "
        f"(an empty step: CTA argmin, record exchange, its wait), us a step "
        f"at C " + ", ".join(f"{c}: {v:.3f}" for c, v in us.items())
        + f" (C={chosen} chosen) on {nvidia_smi()}")
    return us[chosen] * steps / 1e3


def check_random_serving(gen, dev) -> dict:
    """Phase 17; returns each new kernel's largest error."""
    errs = {"knn_packed": 0.0, "mds_continue": 0.0, "p2i_bwd": 0.0}

    def verdict(name, what, res):
        ok, err, msg = res
        errs[name] = max(errs[name], err)
        log(f"  {name} {what}: {msg}")
        if not ok:
            fail(f"{name} {what}: kernel differs from the plain version")

    n = N_INPUT_POINTS
    for c in KNN_WIDTHS:
        x = (torch.rand(B_CHECK, n, c, generator=gen) - 0.5 if c == 3 else
             torch.randn(B_CHECK, n, c, generator=gen))
        if c == 3:                              # duplicated points: ties
            x[:, n // 2:] = x[:, :n - n // 2]
        x = x.to(dev)
        verdict("knn_packed", f"C={c}", compare_exact(
            knn.knn_idx(x, K, packed=True), knn.knn_packed_plain(x, K)))
    x = near_tie_features(gen, dev)
    before = _lib.device_count("knn_packed_flagged")
    got = knn.knn_idx(x, K, packed=True)
    flagged = _lib.device_count("knn_packed_flagged") - before
    verdict("knn_packed", f"C={x.shape[2]}, zero rows, lattice points and a "
            f"duplicated grid, {flagged} of {x.shape[0] * x.shape[1]} queries "
            f"flagged for the exact scan, "
            f"{cuda_ms(lambda: knn.knn_idx(x, K, packed=True), reps=3):.3f} ms",
            compare_exact(got, knn.knn_packed_plain(x, K)))
    # prefix states of the production hybrid: 19384 points (1/16 of the
    # coarse ones duplicated: exact density ties), a batched prefix of
    # 14336 picks (G 8192, every bump applied), its live lanes compacted
    coarse = torch.rand(B_CHECK, N_OUT, 3, generator=gen) - 0.5
    q = N_OUT // 16
    coarse[:, q:2 * q] = coarse[:, :q]
    partial = torch.rand(B_CHECK, n, 3, generator=gen) - 0.5
    xyz = torch.cat([coarse, partial], 1).contiguous().to(dev)
    mml = expansion_penalty.mean_mst_length_estimate(xyz[:, :N_OUT], PRIM_S, 1.33)
    _, temp = mds.mds_batched(xyz, HYBRID_PREFIX, mml, g=mds.BATCH_G,
                              schedule=(), return_state=True)
    xc, tc, orig = mds.compact_live(xyz, temp, N_MDS - HYBRID_PREFIX)
    got = mds.mds_continue(xc, tc, orig, mml, mds.TAIL)
    want = mds.mds_continue_plain(xc, tc, orig, mml, mds.TAIL)
    verdict("mds_continue", f"{list(xc.shape)} from a {HYBRID_PREFIX}-pick "
            f"prefix of {N_MDS}, {mds.TAIL} steps", compare_exact(got, want))
    check_continue_clusters((xc, tc, orig, mml, mds.TAIL), want, errs,
                            "random prefix state")
    pts, feat, binds, n_img = splat_inputs(gen, dev, B_CHECK)
    for radius in RADII:
        _, ids = p2i_op.p2i_max(pts, feat, binds, n_img, IMG, IMG, radius, True)
        g = torch.randn(n_img, IMG, IMG, 1, generator=gen).to(dev)
        args = (pts, feat, binds, ids, g, radius)
        got = p2i_op.p2i_max_backward(*args)
        verdict("p2i_bwd", f"R={radius}, {pts.shape[0]} points, "
                f"{int((ids >= 0).sum())} pixels won",
                compare_rel(got, p2i_op.p2i_max_backward_plain(*args)))
        again = p2i_op.p2i_max_backward(*args)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"  p2i_bwd R={radius}: two launches bit for bit equal: {same}")
        if not same:
            fail(f"p2i_bwd R={radius}: two launches differ")
        # the result does not depend on the plan: the scan path, small
        # tiles and items (many items a bin, hits in rounds)
        for kw in ({"_path": "scan"}, {"_tile": (8, 32), "_item": 40}):
            other = p2i_op.p2i_max_backward(*args, **kw)
            same = all(torch.equal(a, b) for a, b in zip(got, other))
            log(f"  p2i_bwd R={radius} with {kw}: bit for bit equal to the "
                f"default plan: {same}")
            if not same:
                fail(f"p2i_bwd R={radius} with {kw}: differs from the default plan")
    return errs


def serving_forward(state, arm, partial, dev):
    """Phase 18, one arm: the serving forward at B=4 with counts set to 0
    just before and read just after, its calls recorded."""
    model = serving_model(state, arm, dev)
    calls: dict = {}
    with swapped(**recording(calls)):
        _lib.reset_counts()
        t = time.perf_counter()
        outs = complete(model, partial)
        torch.cuda.synchronize()
        launches, plain = dict(_lib.LAUNCHES), dict(_lib.PLAIN_CALLS)
        flagged = _lib.device_count("knn_packed_flagged")
    mml = [c[0][2].tolist() for c in calls["mds_xyz"]]
    log(f"  {arm}: {time.perf_counter() - t:.2f} s; mml per refine pass "
        f"{mml}; launches {launches}, plain calls {plain}; packed kNN "
        f"queries flagged for the exact scan {flagged}")
    for name, v in zip(("coarse", "middle", "refine"), outs[:3]):
        if v.shape != (B_CHECK, N_OUT, 3) or not bool(torch.isfinite(v).all()):
            fail(f"serving {arm} {name}: shape {tuple(v.shape)} or non-finite")
    if float(outs[3]) != 0.0:
        fail(f"serving {arm}: loss_mst {float(outs[3])} is not 0")
    want = dict.fromkeys(_lib.LAUNCHES, 0)
    want.update(knn_packed=4, gather_max=4, mds=2 if arm == "exact" else 0,
                mds_continue=2 if arm == "hybrid" else 0)
    if launches != want or sum(plain.values()):
        fail(f"serving {arm}: launches {launches}, expected {want}; plain "
             f"calls {plain}")
    return model, outs, calls, launches


def serving_default(state: dict, partial, dev) -> str:
    """Phase 18: the serving forward as ``build_generator(serving=True)``
    builds it, its MDS arm left at the default; the arm it ran, read from
    what it launched: greedy MDS #4 twice, no continuation #5 and no batched
    round is the exact arm."""
    model = build_generator(seed=0, device="cpu", serving=True)
    model.load_state_dict(state)
    model = model.to(dev).eval()
    rounds = [0]
    batched = mds.mds_batched

    def counted(*args, **kw):
        rounds[0] += 1
        return batched(*args, **kw)
    with patched((mds, "mds_batched", counted)):
        _lib.reset_counts()
        complete(model, partial)
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
    took = ("hybrid" if launches["mds_continue"] else "batched" if rounds[0]
            else "exact" if launches["mds"] == 2 else "none of the three")
    log(f"  default arm (build_generator(serving=True), mds not given): MDS "
        f"#4 {launches['mds']} launches, continuation #5 "
        f"{launches['mds_continue']}, batched MDS calls {rounds[0]}: the "
        f"{took} arm, as the JAX package resolves \"auto\" off the TPU")
    if took != "exact":
        fail(f"the default serving forward took the {took} MDS arm, not exact")
    return took


def compare_serving(model, partial, calls, outs, arm) -> None:
    """Phase 19, one arm: the plain serving forward replaying the kernel
    forward's kNN graphs and MDS picks."""
    seen: list = []
    fixed = dict(knn=replay_knn(calls["knn"], seen),
                 mds_xyz=replay(calls["mds_xyz"]))
    with swapped(**dict(PLAIN, **fixed)):
        p = complete(model, partial)
    feat = max(float((x - x_k).abs().max()) for x, x_k in seen)
    c_err = float((outs[0] - p[0]).abs().max())
    cds = {n: chamfer(a, b) for n, a, b in (("middle", outs[1], p[1]),
                                            ("refine", outs[2], p[2]))}
    log(f"  {arm} anchored: encoder stage features max abs {feat:.3e} (limit "
        f"{SERVE_FEAT_ATOL:g}), coarse max abs {c_err:.3e} (limit "
        f"{SERVE_COARSE_ATOL:g}), Chamfer middle {cds['middle']:.3e} refine "
        f"{cds['refine']:.3e} (limit {SERVE_CHAMFER:g})")
    if feat > SERVE_FEAT_ATOL or c_err > SERVE_COARSE_ATOL:
        fail(f"serving {arm}: anchored features {feat:.3e} or coarse "
             f"{c_err:.3e} beyond their limits")
    for n, v in cds.items():
        if v > SERVE_CHAMFER:
            fail(f"serving {arm}: anchored {n} Chamfer {v:.3e} > {SERVE_CHAMFER:g}")


def serving_controls(model, partial, calls) -> None:
    """Phase 19's controls: a continuation skipping its first bump, held
    against the hybrid forward's recorded continuation calls; a kNN top-k
    off by one in the anchored serving forward."""
    n_bad = 0
    for args, kw, out in calls["mds_continue"]:
        n_bad += int((continue_skipping_first_bump(*args, **kw) != out).sum())
    caught = n_bad > 0
    log(f"  control, continuation skipping its first bump: {n_bad} of "
        f"{sum(c[2].numel() for c in calls['mds_continue'])} tail picks "
        f"differ from the kernel's: {'caught' if caught else 'NOT caught'}")
    if not caught:
        fail("the continuation check does not see a skipped first bump")
    seen: list = []
    fixed = dict(knn=replay_knn(calls["knn"], seen, perturb=True),
                 mds_xyz=replay(calls["mds_xyz"]))
    with swapped(**dict(PLAIN, **fixed)), torch.no_grad():
        c = model.decoder(model.encoder(partial))
    feat = max(float((x - x_k).abs().max()) for x, x_k in seen)
    caught = feat > SERVE_FEAT_ATOL
    log(f"  control, kNN top-k off by one (9th for 8th): encoder stage "
        f"features max abs {feat:.3e}: {'caught' if caught else 'NOT caught'}")
    if not caught:
        fail("the anchored serving check does not see a kNN off by one")


def main_serving(state: dict, partial, parity_outs, errs: dict, dev):
    """Phases 18-19; returns (per-arm launches, kernel rows)."""
    log(f"phase 18: the serving forward, {N_INPUT_POINTS} -> {N_OUT} at "
        f"B={B_CHECK}, in each MDS arm {SERVING_ARMS}")
    runs = {arm: serving_forward(state, arm, partial, dev) for arm in SERVING_ARMS}
    PATHS["serving_default_arm"] = serving_default(state, partial, dev)

    log("phase 19: the kernel serving forward against the plain one")
    model, outs, calls, _ = runs["hybrid"]
    rows = check_forward_calls({"knn_packed": calls["knn"],
                                "mds_continue": calls["mds_continue"]},
                               errs, ("knn_packed", "mds_continue"),
                               "serving forward")
    report_flagged(calls["knn"], "the hybrid serving forward's inputs")
    for i, (args, kw, out) in enumerate(calls["mds_continue"]):
        check_continue_clusters(args, out, errs, f"forward call {i}'s input")
    rows["mds_continue"]["max_abs_err"] = errs["mds_continue"]
    rows["mds_continue"]["latency_floor_ms"] = sum(
        continue_latency_floor(args) for args, _, _ in calls["mds_continue"])
    for arm, (model, outs, calls, _) in runs.items():
        compare_serving(model, partial, calls, outs, arm)
    serving_controls(*runs["hybrid"][:1], partial, runs["hybrid"][2])
    for arm, (_, outs, _, _) in runs.items():
        cds = [chamfer(a, b) for a, b in zip(outs[:3], parity_outs[:3])]
        log(f"  reading, {arm} against parity (free-running, random "
            f"weights; no gate): Chamfer coarse {cds[0]:.3e} middle "
            f"{cds[1]:.3e} refine {cds[2]:.3e}")
    return {arm: r[3] for arm, r in runs.items()}, rows


_SERVE_GROUPS = (("knn (packed)", KNN_KERNELS),
                 ("gather_max", GATHER_KERNELS),
                 ("mds continuation", (CONTINUE_KERNEL,)),
                 ("mds (exact)", ("mds_cluster_kernel",)),
                 ("sort", ("radix", "sort")),
                 ("gemm", ("gemm", "xmma", "cutlass", "cublas")))


def serving_throughput(state: dict, parity_state: dict, gen, dev) -> None:
    """Phase 20: B=32 forwards in each serving arm beside parity (CUDA
    events, 3 forwards after one warm-up), each arm's MDS calls timed on
    their own inputs, and one profiled forward each for batched and
    hybrid."""
    partial = (torch.rand(B_BENCH, N_INPUT_POINTS, 3, generator=gen) - 0.5).to(dev)
    parity = build_generator(seed=0, device="cpu")
    parity.load_state_dict(parity_state)
    parity = parity.to(dev).eval()
    ms = {"parity": cuda_ms(lambda: complete(parity, partial), reps=3)}
    del parity
    for arm in SERVING_ARMS:
        model = serving_model(state, arm, dev)
        ms[arm] = cuda_ms(lambda: complete(model, partial), reps=3)
        calls: dict = {}
        with swapped(**recording(calls)):
            complete(model, partial)
        mds_ms = sum(cuda_ms(lambda: mds.minimum_density_sample_xyz(*a, **kw),
                             reps=3) for a, kw, _ in calls["mds_xyz"])
        log(f"  {arm}: {ms[arm]:.1f} ms per forward, "
            f"{B_BENCH / (ms[arm] / 1e3):.2f} clouds/s; its two MDS calls "
            f"{mds_ms:.2f} ms ({100 * mds_ms / ms[arm]:.1f}%)")
        if arm in ("batched", "hybrid"):
            profile_forward(model, partial, _SERVE_GROUPS)
        if arm == "batched":
            time_knn_calls(model, partial, f"B={B_BENCH} serving forward's")
            padded = zero_padded(partial)
            pad_ms = cuda_ms(lambda: complete(model, padded), reps=3)
            flagged = flagged_by(lambda: complete(model, padded),
                                 "knn_packed_flagged")
            log(f"  batched, zero-padded clouds: {pad_ms:.1f} ms per forward; "
                f"packed kNN queries flagged for the exact scan {flagged} of "
                f"{4 * B_BENCH * N_INPUT_POINTS}")
            PATHS.update(serving_batched_b32_padded_ms=pad_ms,
                         serving_batched_b32_padded_flagged=flagged)
        PATHS[f"serving_{arm}_b32_ms"] = ms[arm]
        del model, calls
    log(f"  B={B_BENCH} on {nvidia_smi()}: parity {ms['parity']:.1f} ms "
        f"({B_BENCH / (ms['parity'] / 1e3):.2f} clouds/s), "
        + ", ".join(f"{a} {ms[a]:.1f} ms ({ms['parity'] / ms[a]:.3f}x)"
                    for a in SERVING_ARMS)
        + f"; the default serving forward runs the "
        f"{PATHS.get('serving_default_arm')} arm (phase 18)")


# ---------------------------------------------------------------------------
# phases 21-23: the trained flagship and the evaluation CLI
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
TRAINED_NPZ = os.path.join(ROOT, "docs", "artifacts", "r5",
                           "flagship_e8_bf16.npz")
EVAL_YAML = os.path.join(CONFIG_DIR, "flagship_e8_eval.yaml")
# scripts/port_jax_eval_reading.py: the JAX package's reading of the npz on
# the same split (CPU)
JAX_READING = os.path.join(ROOT, "docs", "artifacts", "port",
                           "jax_eval_flagship_e8.json")
EVAL_OPS_ALL = EVAL_OPS + ("nn_idx", "emd_bids")
# The parity contract (ROADMAP.md): deterministic stages elementwise within
# atol 3e-6 and rtol 1e-4, end to end Chamfer <= 1e-4.
CONTRACT_ATOL, CONTRACT_RTOL, CONTRACT_CHAMFER = 3e-6, 1e-4, 1e-4
# The trained eval against the JAX reading: the split's means (CD and EMD
# relative, F-Score absolute) and each batch's.
EVAL_REL, EVAL_F = 0.01, 0.005
BATCH_REL, BATCH_F = 0.02, 0.01
# the final-test EMD protocol (sparenet_tpu/configs/defaults.py: TEST)
FINAL_EPS, FINAL_ITERS = 0.002, 10000


def eval_config(weights=None, workdir=None):
    """The CLI's split: flagship_e8_eval.yaml (Synthetic TEST, 128 clouds in
    batches of 16, the trained NETWORK block)."""
    cfg = cfg_from_file(EVAL_YAML)
    if weights or workdir:
        cfg_update(cfg, weights=weights, workdir=workdir)
    return cfg


def trained_model(dev):
    """The flagship generator holding the npz's weights, in parity mode."""
    if not os.path.exists(TRAINED_NPZ):
        raise FileNotFoundError(
            f"{TRAINED_NPZ} is missing: the trained-weight phases need the "
            f"archive in the checkout")
    cfg = eval_config()
    cfg.CONST.weights = TRAINED_NPZ
    model = build_generator(seed=0, device="cpu")
    epoch, best = checkpoint_load(cfg, model)
    if (epoch, best) != (1, None):
        fail(f"the npz loaded as epoch {epoch}, best {best}")
    return model.to(dev).eval()


def mds_ties(xyz, npoint, mml):
    """mds_plain's loop (ops/mds.py) counting, per cloud, the steps whose
    smallest density is held by more than one point (an exact tie, which
    the lowest index breaks) and those where another density is within
    1e-6 relative of it (a near-tie)."""
    b, n, _ = xyz.shape
    dev = xyz.device
    t = (5.0 * mml * mml).reshape(b, 1)
    weight = torch.where(torch.arange(n, device=dev) >= 8192, 2.0, 1.0)
    temp = torch.zeros((b, n), device=dev)
    temp[:, 0] = 1e9
    rows = torch.arange(b, device=dev)
    last = torch.zeros(b, dtype=torch.long, device=dev)
    exact = torch.zeros(b, dtype=torch.long, device=dev)
    near = torch.zeros(b, dtype=torch.long, device=dev)
    for _ in range(1, npoint):
        d2 = sqdist3(xyz - xyz[rows, last][:, None, :])
        e = torch.exp(-d2 / t)
        temp = temp + weight * torch.where(
            e < torch.finfo(torch.float32).tiny, 0.0, e)
        low = temp.amin(1, keepdim=True)
        exact += (temp == low).sum(1) > 1
        near += (temp <= low + 1e-6 * low.abs()).sum(1) > 1
        nxt = temp.argmin(1)
        temp[rows, nxt] = 1e9
        last = nxt
    return exact.tolist(), near.tolist()


def compare_trained(model, partial, calls, outs) -> None:
    """The kernel forward on trained weights against plain forwards under
    the parity contract: free-running (every op plain; kNN near-ties may
    flip and cascade) end to end, every output by Chamfer; anchored (the
    kernel kNN graphs replayed) the encoder stage features and coarse
    elementwise, middle and refine by Chamfer (MDS picks swap among
    near-ties); two controls the anchored check must catch."""
    def within(a, b):
        return bool(torch.allclose(a, b, atol=CONTRACT_ATOL, rtol=CONTRACT_RTOL))

    names = ("coarse", "middle", "refine")
    with swapped(**PLAIN):
        p = complete(model, partial)
    cds = {n: chamfer(x, y) for n, x, y in zip(names, outs[:3], p[:3])}
    log(f"  free-running: Chamfer " + ", ".join(
        f"{n} {v:.3e}" for n, v in cds.items())
        + f" (limit {CONTRACT_CHAMFER:g}); coarse max abs "
        f"{float((outs[0] - p[0]).abs().max()):.3e}")
    seen: list = []
    acalls: dict = {}
    with swapped(**dict(PLAIN, knn=replay_knn(calls["knn"], seen))):
        with swapped(**recording(acalls)):
            a = complete(model, partial)
    feat = max(float((x - x_k).abs().max()) for x, x_k in seen)
    feat_ok = all(within(x, x_k) for x, x_k in seen)
    a_err = float((outs[0] - a[0]).abs().max())
    diff = [int((g[2] != w[2]).sum()) for g, w in zip(calls["mds"], acalls["mds"])]
    acd = {n: chamfer(x, y) for n, x, y in zip(names[1:], outs[1:3], a[1:3])}
    log(f"  anchored: encoder stage features max abs {feat:.3e}, coarse max "
        f"abs {a_err:.3e} (both within atol {CONTRACT_ATOL:g} + rtol "
        f"{CONTRACT_RTOL:g}: {feat_ok and within(outs[0], a[0])}), MDS picks "
        f"that differ per call {diff}, Chamfer middle {acd['middle']:.3e} "
        f"refine {acd['refine']:.3e}")
    if not (feat_ok and within(outs[0], a[0])):
        fail(f"trained anchored encoder {feat:.3e} or coarse {a_err:.3e} "
             f"outside the contract")
    for n, v in list(cds.items()) + list(acd.items()):
        if v > CONTRACT_CHAMFER:
            fail(f"trained {n} Chamfer {v:.3e} > {CONTRACT_CHAMFER:g}")
    for op, what in (("knn", "kNN top-k off by one (9th for 8th)"),
                     ("gather_max", "gather-max loop one short")):
        f_gap, c_gap = anchored_gaps(model, partial, calls["knn"], outs[0], op)
        caught = f_gap > CONTRACT_ATOL or c_gap > CONTRACT_ATOL
        log(f"  control, {what}: encoder stage features max abs {f_gap:.3e}, "
            f"coarse max abs {c_gap:.3e}: {'caught' if caught else 'NOT caught'}")
        if not caught:
            fail(f"the trained anchored check does not see a {what}")


def main_trained(dev) -> None:
    """Phase 21: the trained forward at B=4 (the split's first clouds),
    every kernel against its plain version on the inputs it gave them, the
    kNN flags and MDS ties it met, and the forward against plain ones."""
    model = trained_model(dev)
    _, val_loader = data_init(eval_config())
    _, _, _, data = next(iter(val_loader))
    partial = torch.from_numpy(data["partial_cloud"][:B_CHECK]).to(dev)
    calls: dict = {}
    with swapped(**recording(calls)):
        _lib.reset_counts()
        outs = complete(model, partial)
        torch.cuda.synchronize()
        launches, plain = dict(_lib.LAUNCHES), dict(_lib.PLAIN_CALLS)
        flagged = _lib.device_count("knn_flagged")
    log(f"  trained forward B={B_CHECK}: launches {launches}, plain calls "
        f"{plain}; kNN queries flagged for the exact scan {flagged} of "
        f"{4 * B_CHECK * N_INPUT_POINTS}")
    for name, want in {"knn": 4, "gather_max": 4, "expansion": 2, "mds": 2}.items():
        if launches[name] != want or plain[name] != 0:
            fail(f"trained forward {name}: {launches[name]} launches, "
                 f"{plain[name]} plain calls")
    for name, v in zip(("coarse", "middle", "refine"), outs[:3]):
        if v.shape != (B_CHECK, N_OUT, 3) or not bool(torch.isfinite(v).all()):
            fail(f"trained {name}: shape {tuple(v.shape)} or non-finite values")
    check_forward_calls(calls, dict.fromkeys(EVAL_OPS, 0.0),
                        what="trained forward")
    report_flagged(calls["knn"], "the trained forward's inputs")
    for i, (a, _, _) in enumerate(calls["mds"]):
        exact, near = mds_ties(a[0], a[1], a[2])
        log(f"  mds call {i} of the trained forward: steps meeting an exact "
            f"tie of the smallest density per cloud {exact}, a near-tie "
            f"(1e-6 relative) {near}, of {a[1] - 1}")
    compare_trained(model, partial, calls, outs)


def check_reading(name: str, got: dict, want: dict, rel: float, f_abs: float):
    """F-Score within f_abs, CD and EMD within rel of the JAX reading."""
    gaps = {"F-Score": abs(got["F-Score"] - want["F-Score"]),
            "ChamferDistance": abs(got["ChamferDistance"] / want["ChamferDistance"] - 1),
            "EMD": abs(got["EMD"] / want["EMD"] - 1)}
    ok = (gaps["F-Score"] <= f_abs and gaps["ChamferDistance"] <= rel
          and gaps["EMD"] <= rel)
    log(f"  {name}: F {got['F-Score']:.4f} (JAX {want['F-Score']:.4f}), CD x "
        f"1000 {got['ChamferDistance']:.4f} ({want['ChamferDistance']:.4f}), "
        f"EMD x 100 {got['EMD']:.4f} ({want['EMD']:.4f}); gaps F "
        f"{gaps['F-Score']:.2e} (limit {f_abs:g}), CD {gaps['ChamferDistance']:.2e}"
        f", EMD {gaps['EMD']:.2e} (relative, limit {rel:g}): "
        f"{'within' if ok else 'OUTSIDE'}")
    if not ok:
        fail(f"trained eval {name} outside its limits of the JAX reading")


def main_eval_cli(dev) -> dict:
    """Phase 22: the evaluation runner, in process, over the CLI's split on
    the npz (the CLI's path: config, Synthetic loader, checkpoint reader,
    eval forward, validation losses, metrics), counts set to 0 just before
    and read just after; per-batch and overall metrics against the JAX
    reading; clouds/s by part."""
    if not os.path.exists(JAX_READING):
        raise FileNotFoundError(f"{JAX_READING} is missing")
    with open(JAX_READING) as f:
        reading = json.load(f)
    work = tempfile.mkdtemp(prefix="eval_cli_")
    try:
        cfg = eval_config(weights=TRAINED_NPZ, workdir=work)
        runner = get_runner(cfg)(cfg, set_logger(None), device=dev)
        _lib.reset_counts()
        runner.test()
        torch.cuda.synchronize()
        launches, plain = dict(_lib.LAUNCHES), dict(_lib.PLAIN_CALLS)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = runner.summary()
    log(f"  eval: launches {launches}, plain calls {plain}")
    for name in EVAL_OPS_ALL:
        if launches[name] == 0:
            fail(f"eval CLI: {name} was not launched")
    if any(plain.values()):
        fail(f"eval CLI: plain calls {plain}")
    names = Metrics.names()
    if summary["n_clouds"] != reading["n_clouds"] or len(
            runner.batch_metrics) != len(reading["per_batch"]):
        fail(f"eval CLI: {summary['n_clouds']} clouds in "
             f"{len(runner.batch_metrics)} batches, the reading has "
             f"{reading['n_clouds']} in {len(reading['per_batch'])}")
    for i, (got, want) in enumerate(zip(runner.batch_metrics, reading["per_batch"])):
        check_reading(f"batch {i}", dict(zip(names, got)), want, BATCH_REL,
                      BATCH_F)
    check_reading("the split", summary, reading["overall"], EVAL_REL, EVAL_F)
    sec = summary["seconds"]
    n_batches = len(runner.batch_metrics)
    log(f"  eval epoch on {nvidia_smi()}: {summary['n_clouds']} clouds in "
        f"{sec['total']:.3f} s, {summary['clouds_per_s']:.2f} clouds/s; data "
        f"{sec['data']:.3f} s, forward (with the validation losses) "
        f"{sec['forward']:.3f} s, metrics {sec['metrics']:.3f} s; launches a "
        f"batch: chamfer NN {launches['nn_idx'] / n_batches:g}, bids "
        f"{launches['emd_bids'] / n_batches:g}")
    PATHS["eval_trained"] = dict(
        clouds_per_s=summary["clouds_per_s"], clouds=summary["n_clouds"],
        **{f"{k}_s": v for k, v in sec.items()},
        **{k: summary[k] for k in names})
    return {"nn_idx": launches["nn_idx"] // n_batches,
            "emd_bids": launches["emd_bids"] // n_batches}


def first_call(name: str, keep: list):
    """A wrapper of the op now installed that keeps a clone of its first
    call's arguments in ``keep``."""
    fn = getattr(*OPS[name])

    def once(*args, **kw):
        if not keep:
            keep.append((_clone(args), kw))
        return fn(*args, **kw)
    return once


TRAJECTORY_MARKS = (1, 10, 50, 100, 500, 1000, 2000, 5000, FINAL_ITERS - 1)


def auction_trajectory(xyz1, xyz2, eps: float, iters: int) -> dict:
    """The auction of ops/emd.py:auction_assign run round by round with no
    early stop: the largest number of unassigned bidders of a cloud after
    each round of TRAJECTORY_MARKS (read on the host there only)."""
    b, n, _ = xyz1.shape
    state = (torch.full((b, n), -1, dtype=torch.long, device=xyz1.device),
             torch.full((b, n), -1, dtype=torch.long, device=xyz1.device),
             torch.zeros((b, n), device=xyz1.device))
    left = {}
    for r in range(1, iters):
        state = emd._round(xyz1, xyz2, state, eps, last=False)
        if r in TRAJECTORY_MARKS:
            left[r] = int((state[0] < 0).sum(1).max())
    return left


def main_final_emd(dev) -> None:
    """Phase 23: the final-test EMD protocol (eps 0.002, up to 10000 rounds)
    on the trained refine of the split's first batch of 16: the rounds the
    auction took before it stopped (its bids launches: one a round), its
    time, the EMD; one bids call of that run (the first, every bidder
    scored) against its plain version."""
    model = trained_model(dev)
    _, val_loader = data_init(eval_config())
    _, _, _, data = next(iter(val_loader))
    partial = torch.from_numpy(data["partial_cloud"]).to(dev)
    gt = torch.from_numpy(data["gtcloud"]).to(dev)
    refine = complete(model, partial)[2]
    del model
    keep: list = []
    with swapped(emd_bids=first_call("emd_bids", keep)):
        torch.cuda.synchronize()
        before = _lib.LAUNCHES["emd_bids"]
        t = time.perf_counter()
        final = emd_metric(refine, gt, FINAL_EPS, FINAL_ITERS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rounds = _lib.LAUNCHES["emd_bids"] - before
    val = emd_metric(refine, gt, 0.005, 50)
    log(f"  final-test EMD (eps {FINAL_EPS}, at most {FINAL_ITERS} rounds) on "
        f"B={refine.shape[0]}: {rounds} rounds before it stopped, "
        f"{wall:.3f} s (host clock, synchronised), EMD x 100 "
        f"mean {float(final.mean()):.4f} (validation protocol on the same "
        f"clouds {float(val.mean()):.4f})")
    if not bool(torch.isfinite(final).all()):
        fail("final-test EMD is not finite")
    if rounds >= FINAL_ITERS:
        left = auction_trajectory(refine, gt, FINAL_EPS, FINAL_ITERS)
        log(f"  the auction's early stop did not fire: unassigned bidders "
            f"(most of a cloud, of {refine.shape[1]}) after round "
            + ", ".join(f"{r}: {v}" for r, v in left.items()))
        PATHS["final_emd_unassigned"] = left
    args, kw = keep[0]
    got = emd.emd_bids(*args, **kw)
    want = emd.emd_bids_plain(*args, **kw)
    ok, err, msg = compare_exact(got, want)
    log(f"  bids call 0 of that run {[list(x.shape) for x in args if isinstance(x, torch.Tensor)]}"
        f": kernel against plain: {msg}")
    if not ok:
        fail("final-test bids call differs from its plain version")
    PATHS["final_emd"] = dict(rounds=rounds, s=wall, emd=float(final.mean()))


# ---------------------------------------------------------------------------
# phases 24-25: the training CLI
# ---------------------------------------------------------------------------

# phase 24: sparenet.yaml (B=24, EMD, consistency loss) on Synthetic, 2 steps
# an epoch, validation over 32 clouds at B=16, a checkpoint every epoch;
# phase 25: sparenet_gan.yaml (B=32) the same way
TRAIN_CLI_RUN = {"TRAIN": {"save_freq": 1}, "TEST": {"batch_size": 16},
                 "DATASETS": {"synthetic": {"n_train": 2 * B_TRAIN, "n_val": 32}}}
GAN_CLI_RUN = {"TRAIN": {"save_freq": 1}, "TEST": {"batch_size": 16},
               "DATASETS": {"synthetic": {"n_train": 2 * B_GAN, "n_val": 32}}}


def run_yaml(name: str, work: str, overrides: dict) -> str:
    """The port's shipped config ``name`` with ``overrides`` merged in,
    written under ``work``."""
    import yaml

    with open(os.path.join(CONFIG_DIR, name)) as f:
        tree = yaml.safe_load(f)

    def merge(a, b):
        for k, v in b.items():
            if isinstance(v, dict):
                merge(a.setdefault(k, {}), v)
            else:
                a[k] = v
    merge(tree, overrides)
    path = os.path.join(work, name)
    with open(path, "w") as f:
        yaml.safe_dump(tree, f)
    return path


@contextlib.contextmanager
def training_launches(keep: list):
    """Append each ``BaseRunner.train()``'s launches (an epoch's training,
    validation apart) to ``keep``."""
    train = train_base.BaseRunner.train

    def counted(self):
        before = dict(_lib.LAUNCHES)
        train(self)
        keep.append({k: v - before.get(k, 0) for k, v in _lib.LAUNCHES.items()})
    with patched((train_base.BaseRunner, "train", counted)):
        yield


def release_memory(what: str) -> None:
    """Free what earlier phases left (runners hold reference cycles) and
    return the cache, so that a phase's peak is its own; log what stays."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  before {what}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")


def per_step(epochs: list, steps: int) -> dict:
    return {k: sum(e[k] for e in epochs) / steps for k in _lib.LAUNCHES}


def checkpoints(runner) -> list:
    d = runner.config.DIR.checkpoints
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def same_state(name: str, got: dict, want: dict) -> int:
    """Fail unless two flat dicts of tensors are equal bit for bit; the
    count of tensors compared."""
    if got.keys() != want.keys():
        fail(f"{name}: keys differ")
        return 0
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]
    if bad:
        fail(f"{name}: {len(bad)} of {len(want)} tensors differ, e.g. {bad[:3]}")
    return len(want)


def adam_state(opt) -> dict:
    return {f"{i}.{k}": v for i, st in opt.state_dict()["state"].items()
            for k, v in st.items()}


def check_cli_line(line: dict, launches: dict, plain: dict, expected,
                   what: str) -> None:
    log(f"  {what}: epochs {line['epochs']}, lr {line['lr']}, mean losses "
        f"{line['epoch_losses']}, best metrics {line['best_metrics']}; "
        f"launches {launches}, plain calls {plain}")
    for name in expected:
        if launches[name] < 1:
            fail(f"{what}: {name} was not launched")
    if any(plain.values()):
        fail(f"{what}: plain calls {plain}")
    losses = [v for e in line["epoch_losses"].values() for v in e.values()]
    if not losses or not all(map(math.isfinite, losses)):
        fail(f"{what}: losses not finite: {line['epoch_losses']}")


def main_train_cli(step_launches: dict, dev) -> dict:
    """Phase 24; returns a training step's launches as the CLI runs it."""
    release_memory("the training CLI")
    work = tempfile.mkdtemp(prefix="train_cli_")
    try:
        path = run_yaml("sparenet.yaml", work, TRAIN_CLI_RUN)
        args = ["--config", path, "--dataset", "Synthetic"]
        first = train_cli.build(args + ["--workdir", os.path.join(work, "a"),
                                        "--epochs", "1"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        epochs: list = []
        with training_launches(epochs):
            line = train_cli.run(first)
            torch.cuda.synchronize()
            launches, plain = dict(_lib.LAUNCHES), dict(_lib.PLAIN_CALLS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = len(first.train_loader)
        check_cli_line(line, launches, plain, TRAIN_EXPECTED + ("gather_max",),
                       "training CLI, epoch 1")
        step = per_step(epochs, steps)
        log(f"  a training step's launches as the CLI runs it: "
            f"{ {k: v for k, v in step.items() if v} }")
        for name in ("knn", "expansion", "mds", "nn_idx", "edge_stats_fwd",
                     "edge_stats_bwd"):
            if step[name] != step_launches[name]:
                fail(f"training CLI: {name} {step[name]} launches a step, "
                     f"phase 8's step {step_launches[name]}")
        names = checkpoints(first)
        log(f"  epoch 1 checkpoints: {names}")
        if len(names) != 1:
            fail(f"training CLI: {len(names)} checkpoints after one epoch")
        sec = line["seconds"]
        log(f"  training epoch on {nvidia_smi()}: {line['clouds_trained']} "
            f"clouds in {steps} steps of {B_TRAIN}, {line['clouds_per_s']:.2f} "
            f"clouds/s over data and step time; seconds: data {sec['data']:.3f}, "
            f"step {sec['step']:.3f}, val {sec['val']:.3f} (validation over "
            f"32 clouds at B=16, metrics and the checkpoint included), total "
            f"{sec['total']:.3f}; peak memory {peak:.2f} GiB "
            f"(max_memory_allocated)")
        PATHS["train_cli"] = dict(clouds_per_s=line["clouds_per_s"],
                                  steps=steps, peak_gib=peak,
                                  **{f"{k}_s": v for k, v in sec.items()})

        ckpt = os.path.join(first.config.DIR.checkpoints, names[0]) if names else ""
        second = train_cli.build(args + ["--workdir", os.path.join(work, "b"),
                                         "--epochs", "2", "--weights", ckpt])
        n = same_state("resumed generator", second.model.state_dict(),
                       first.model.state_dict())
        n += same_state("resumed Adam", adam_state(second.optimizer),
                        adam_state(first.optimizer))
        log(f"  the resumed runner holds the epoch-1 run's generator and Adam "
            f"bit for bit ({n} tensors); init_epoch {second.init_epoch}")
        line = train_cli.run(second)
        torch.cuda.synchronize()
        launches, plain = dict(_lib.LAUNCHES), dict(_lib.PLAIN_CALLS)
        check_cli_line(line, launches, plain, TRAIN_EXPECTED + ("gather_max",),
                       "training CLI, resumed")
        want_lr = train_base.lr_for_epoch(second.config.TRAIN, 2)
        if line["epochs"] != [2] or line["lr"] != {"2": want_lr}:
            fail(f"the resumed run ran epochs {line['epochs']} at {line['lr']}, "
                 f"expected epoch 2 at {want_lr}")
        if len(checkpoints(second)) != 1:
            fail(f"training CLI: {len(checkpoints(second))} checkpoints after "
                 f"the resumed epoch")
        del second

        # the runner's step against a direct train_step on the same state
        # and batch, deterministic mode
        ds = first.train_loader.dataset
        items = collate([ds[i] for i in range(B_TRAIN)])
        model = copy.deepcopy(first.model)
        opt = train_base.make_optimizer(model, first.step_config)
        opt.load_state_dict(copy.deepcopy(first.optimizer.state_dict()))
        with deterministic():
            first.train_step(items)
            direct = train_runner.train_step(
                model, opt, torch.from_numpy(items[3]["partial_cloud"]).to(dev),
                torch.from_numpy(items[3]["gtcloud"]).to(dev), first.lr,
                first.step_config)
            torch.cuda.synchronize()
        got = [first.loss["rec_loss"], first.loss["coarse_loss"],
               first.loss["refine_loss"]]
        want = [float(direct[0]), float(direct[1]) * 1000,
                float(direct[2]) * 1000]
        n = same_state("runner step vs train_step", first.model.state_dict(),
                       model.state_dict())
        n += same_state("runner step vs train_step, Adam",
                        adam_state(first.optimizer), adam_state(opt))
        log(f"  deterministic mode: the runner's step {got} against a direct "
            f"train_step {want}; after the step {n} tensors compared bit for "
            f"bit")
        if got != want:
            fail("the runner's step differs from a direct train_step")
        return step
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main_gan_cli(p2i_rows: dict, dev) -> dict:
    """Phase 25; returns a GAN step's launches as the CLI runs it."""
    release_memory("the GAN training CLI")
    work = tempfile.mkdtemp(prefix="gan_cli_")
    try:
        path = run_yaml("sparenet_gan.yaml", work, GAN_CLI_RUN)
        args = ["--gan", "--config", path, "--dataset", "Synthetic"]
        first = train_cli.build(args + ["--workdir", os.path.join(work, "a"),
                                        "--epochs", "2", "--weights",
                                        TRAINED_NPZ])
        n_class = first.config.DATASET.num_class
        log(f"  the GAN runner on the npz: init_epoch {first.init_epoch}, "
            f"{type(first.disc).__name__} with {n_class} classes")
        if first.init_epoch != 1 or n_class != 8 or first.disc.num_classes != 8:
            fail("the GAN runner did not load the npz as epoch 1 with a "
                 "class-conditioned ProjectionD of 8 classes")
        epochs: list = []
        calls: dict = {}
        rec = {k: v for k, v in recording(calls).items()
               if k in ("p2i", "p2i_bwd")}
        with training_launches(epochs), swapped(**rec):
            line = train_cli.run(first)
            torch.cuda.synchronize()
            launches, plain = dict(_lib.LAUNCHES), dict(_lib.PLAIN_CALLS)
        steps = len(first.train_loader)
        check_cli_line(line, launches, plain, GAN_EXPECTED + ("gather_max",),
                       "GAN training CLI")
        step = per_step(epochs, steps)
        log(f"  a GAN step's launches as the CLI runs it: "
            f"{ {k: v for k, v in step.items() if v} }; radii drawn "
            f"{first.radii}")
        if step["p2i"] != 3 or step["p2i_bwd"] != 1:
            fail(f"GAN CLI: p2i {step['p2i']} and its backward "
                 f"{step['p2i_bwd']} launches a step, expected 3 and 1")
        if len(first.radii) != steps or not set(first.radii) <= set(RADII):
            fail(f"GAN CLI: radii drawn {first.radii}")
        sec = line["seconds"]
        log(f"  GAN epoch on the npz on {nvidia_smi()}: {line['clouds_trained']}"
            f" clouds in {steps} steps of {B_GAN}, {line['clouds_per_s']:.2f} "
            f"clouds/s; seconds: data {sec['data']:.3f}, step {sec['step']:.3f}"
            f", val {sec['val']:.3f}")
        PATHS["gan_cli_trained"] = dict(clouds_per_s=line["clouds_per_s"],
                                        steps=steps, radii=first.radii,
                                        **{f"{k}_s": v for k, v in sec.items()})

        names = checkpoints(first)
        log(f"  checkpoints: {names}")
        if len(names) != 1:
            fail(f"GAN CLI: {len(names)} checkpoints after one epoch")
        else:
            second = train_cli.build(args + [
                "--workdir", os.path.join(work, "b"), "--epochs", "3",
                "--weights", os.path.join(first.config.DIR.checkpoints,
                                          names[0])])
            n = same_state("resumed generator", second.model.state_dict(),
                           first.model.state_dict())
            n += same_state("resumed discriminator", second.disc.state_dict(),
                            first.disc.state_dict())
            n += same_state("resumed Adam of G", adam_state(second.optimizer),
                            adam_state(first.optimizer))
            n += same_state("resumed Adam of D", adam_state(second.optimizer_d),
                            adam_state(first.optimizer_d))
            n += same_state("resumed step generators", {
                "radius": second.radius_generator.get_state(),
                "dropout": second.dropout_generator.get_state()}, {
                "radius": first.radius_generator.get_state(),
                "dropout": first.dropout_generator.get_state()})
            log(f"  the whole-GAN checkpoint reloads bit for bit ({n} tensors);"
                f" init_epoch {second.init_epoch}")
            if second.init_epoch != 2:
                fail(f"the GAN checkpoint loaded as epoch {second.init_epoch}")
            del second

        first_step = {"p2i": calls["p2i"][:3], "p2i_bwd": calls["p2i_bwd"][:1]}
        log(f"  p2i and its backward on the first step's trained clouds (radius"
            f" {first.radii[0]}, B={B_GAN}):")
        rows = check_forward_calls(first_step, {"p2i": 0.0, "p2i_bwd": 0.0},
                                   ("p2i", "p2i_bwd"), "trained GAN step")
        for name, row in rows.items():
            log(f"  {name} a step: trained clouds at B={B_GAN} {row['ms']:.4f} ms "
                f"(host ahead {row['host_ahead_ms']:.4f}, bound "
                f"{row['bound_ms']:.5f}); phase 14's random-weight clouds at "
                f"B={B_CHECK}, R={GAN_CHECK_RADIUS} {p2i_rows[name]['ms']:.4f} ms")
        PATHS["gan_cli_trained"].update(
            p2i_ms=rows["p2i"]["ms"], p2i_bwd_ms=rows["p2i_bwd"]["ms"])
        return step
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
        flagged = _lib.device_count("knn_flagged")
    log(f"  kernel forward: {time.perf_counter() - t:.2f} s; launches "
        f"{launches}, plain calls {plain}; kNN queries flagged for the "
        f"exact scan {flagged}")
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
    results["gather_max"]["plans"] = slice_plans(calls["gather_max"],
                                                 "gather_max", B_BENCH)
    report_flagged(calls["knn"], "the forward's inputs")
    for i, (a, kw, out) in enumerate(calls["mds"]):
        check_mds_clusters(a[0], a[1], a[2], out, errs,
                           f"forward call {i}'s input")
    results["mds"]["max_abs_err"] = max(results["mds"]["max_abs_err"], errs["mds"])
    mds_latency_floor(calls["mds"][0][0], dev)
    results["expansion"]["latency_floor_ms"] = expansion_latency_floor(
        calls["expansion"])
    c4 = FLOOR["chosen"][B_CHECK][0]
    results["mds"]["latency_floor_ms"] = sum(
        FLOOR["per_step_us"][c4] * (a[1] - 1) for a, _, _ in calls["mds"]) / 1e3

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
    time_knn_calls(model, partial32, f"B={B_BENCH} forward's")
    padded32 = zero_padded(partial32)
    pad_ms = cuda_ms(lambda: complete(model, padded32), reps=3, warmup=1)
    flagged = flagged_by(lambda: complete(model, padded32), "knn_flagged")
    log(f"  B={B_BENCH}, zero-padded clouds: {pad_ms:.1f} ms per forward, "
        f"{B_BENCH / (pad_ms / 1e3):.2f} clouds/s; kNN queries flagged for "
        f"the exact scan {flagged} of {4 * B_BENCH * N_INPUT_POINTS}")
    time_knn_calls(model, padded32, f"B={B_BENCH} zero-padded forward's")
    PATHS.update(parity_b32_ms=fwd_ms, parity_b32_padded_ms=pad_ms,
                 parity_b32_padded_flagged=flagged)

    train_state = snapshot(model)
    parity_outs = [o.clone() for o in outs[:3]]
    del model, partial32, outs
    t_launches, t_rows, _ = main_train(train_state, dev)
    results.update(t_rows)

    log(f"phase 11: training throughput at B={B_TRAIN} (sparenet.yaml)")
    train_throughput(train_state, gen, dev)

    disc_state = build_discriminator(seed=1, device="cpu",
                                     image_size=IMG).state_dict()
    g_launches, g_rows = main_gan(train_state, disc_state, dev)
    results.update(g_rows)
    log(f"phase 16: GAN throughput at B={B_GAN} (sparenet_gan.yaml)")
    gan_throughput(train_state, disc_state, gen, dev)

    log(f"phase 17: the serving kernels (packed kNN, MDS continuation) and "
        f"the p2i backward against their plain versions, random inputs "
        f"(B={B_CHECK})")
    s_errs = check_random_serving(torch.Generator().manual_seed(7), dev)
    results["p2i_bwd"]["max_abs_err"] = max(results["p2i_bwd"]["max_abs_err"],
                                            s_errs["p2i_bwd"])
    s_errs["mds_continue"] = max(s_errs["mds_continue"], errs["mds_continue"])
    s_launches, s_rows = main_serving(train_state, partial, parity_outs,
                                      s_errs, dev)
    results.update(s_rows)
    log(f"phase 20: serving throughput at B={B_BENCH} in each MDS arm, "
        f"beside parity")
    serving_throughput(train_state, train_state, gen, dev)
    del train_state, parity_outs

    log("phase 21: the trained flagship (docs/artifacts/r5/flagship_e8_bf16."
        f"npz) at B={B_CHECK}: its kernels on the inputs it gave them, and "
        "plain forwards")
    main_trained(dev)
    log("phase 22: the evaluation CLI's runner over its split (Synthetic "
        "TEST, 8 batches of 16) on the npz, against the JAX reading")
    eval_launches = main_eval_cli(dev)
    log(f"phase 23: the final-test EMD protocol (eps {FINAL_EPS}, "
        f"{FINAL_ITERS} rounds) on one batch of the trained outputs")
    main_final_emd(dev)
    log(f"phase 24: the training CLI on sparenet.yaml (Synthetic, B={B_TRAIN}, "
        f"2 steps an epoch, validation over 32 clouds at B=16): epoch 1, then "
        f"epoch 2 resumed from its checkpoint")
    cli_step = main_train_cli(t_launches, dev)
    log(f"phase 25: the SpareNet-GAN training CLI on the npz (sparenet_gan.yaml"
        f", Synthetic, B={B_GAN}, 2 steps, 8 classes)")
    gan_step_launches = main_gan_cli(g_rows, dev)

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
        "p2i": ("sparenet_tpu_torch/csrc/p2i.cu",
                "sparenet_tpu/ops/pallas/p2i_pallas.py:272"),
        "knn_packed": ("sparenet_tpu_torch/csrc/knn.cu",
                       "sparenet_tpu/ops/pallas/knn_pallas.py:70"),
        "mds_continue": ("sparenet_tpu_torch/csrc/mds.cu",
                         "sparenet_tpu/ops/pallas/mds_pallas.py:237"),
        "p2i_bwd": ("sparenet_tpu_torch/csrc/p2i.cu",
                    "sparenet_tpu/ops/p2i.py:258"),
    }
    # launches: each kernel's count on its own main path (the eval forward
    # for the first four, the training step for the next four, the GAN step
    # for p2i and its backward, the hybrid serving forward for the packed
    # kNN and the continuation)
    counts = {**{k: launches[k] for k in EVAL_OPS},
              **{k: t_launches[k] for k in TRAIN_OPS}, "p2i": g_launches["p2i"],
              "p2i_bwd": g_launches["p2i_bwd"],
              "knn_packed": s_launches["hybrid"]["knn_packed"],
              "mds_continue": s_launches["hybrid"]["mds_continue"]}
    kernels = []
    for name, (src, rep) in meta.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "state": "ported"})
        for key in ("host_ahead_ms", "latency_floor_ms", "parts_ms", "splits",
                    "plans"):
            if key in r:
                kernels[-1][key] = r[key]
        if name in eval_launches:
            kernels[-1]["launches_eval_batch"] = eval_launches[name]
        # a step's launches as the training CLI runs it (phase 24) and as
        # its --gan runs it (phase 25)
        kernels[-1]["launches_train_step"] = cli_step.get(name, 0)
        kernels[-1]["launches_gan_step"] = gan_step_launches.get(name, 0)
    if FAILURES:
        log(f"{len(FAILURES)} check(s) failed: {FAILURES}")
        return 1
    log(f"all phases passed; kernel times summed over the B={B_CHECK} "
        f"forward's (or training or GAN step's) calls; forward B={B_BENCH} "
        f"{cps:.2f} clouds/s")
    print("paths " + json.dumps(PATHS), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
