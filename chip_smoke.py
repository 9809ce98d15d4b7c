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
 26. the evaluation CLI in serving mode (``sparenet_tpu_torch.test``: ``build``
     and ``run``, in process, ``--serving``) on the npz over
     flagship_e8_eval.yaml's split, in the default arm (auto = exact) and
     with ``--mds hybrid``; counts set to 0 before the runner is built and
     read after its load and after the evaluation: the load's mml fit
     launches the expansion once, the ratio lies in [0.05, 50], equals a
     fit on the same batch again and lies within 0.005 of the JAX
     package's fit on the same serving coarse clouds (on the CPU,
     docs/artifacts/port/jax_serving_witness.json); the serving kernels
     (packed kNN, gather-max, MDS or its continuation, the NN, the bids)
     launched and no plain version; clouds/s by part; the B=32 serving
     forward of each arm on trained clouds beside phase 20's; the packed
     kNN on the trained inputs against its plain version (near-tie slots
     counted) with its flagged queries, the continuation bit for bit;
     scripts/calibrate_mml.py's fit on the npz, the port's and with the
     estimate's product at one bf16 pass (the TPU's arithmetic), a
     reading; with NETWORK.mml_calibration set, no fit;
 27. serving's quality contract (docs/SERVING_ENVELOPE.md section 7:
     Synthetic VAL, 8 batches of 16, the npz, mml calibration 1.2695):
     parity, serving exact, S=2048, S=4096 and G=8192 each with sort and
     pack16, hybrid; per row CD x 1000, F-Score and EMD x 100 (eps 0.005,
     50 rounds) and the paired dF against the port's parity: each row's
     mean dF within 0.3 pp of the JAX package's reading of it on the same
     weights and coarse clouds (on the CPU, jax_serving_witness.json; a
     pack16 row's is its sort twin's), inside its JAX (TPU) row's mean +- 2
     sigma (docs/artifacts/r5/stage5/envelope_r5ckpt.json) where the JAX
     package's CPU reading is inside it too (a window that reading misses
     is printed as a finding), each pack16 row within 0.3 pp of its sort
     twin; bisect picks sort's set in every round;
 28. MSN and AtlasNet (``models.define_G`` on msn.yaml and atlasnet.yaml:
     3000 -> 16384 points, 32 primitives, bottleneck and PointNetfeat's hide
     1024) from seed 17 with jittered BatchNorm statistics, parity mode: at
     B=2 on numpy-seeded partials and grids, each weight tensor's sha256
     and the forwards against the JAX package's on the CPU
     (docs/artifacts/port/jax_msn_atlasnet_witness.npz, scripts/
     port_jax_msn_witness.py): AtlasNet's cloud and MSN's coarse cloud
     elementwise (atol 3e-6, rtol 1e-4), MSN's mml and loss_mst on the
     witness's coarse cloud (rtol 1e-4; loss_mst free-running a reading),
     its MDS on the witness's cloud and mml against the JAX picks (a
     divergence only at a near-tie), its refine anchored on the witness's
     cloud and picks elementwise and free-running by Chamfer <= 1e-4;
     launches a forward (MSN: expansion 1, MDS 1; AtlasNet none; no plain
     call), MSN's expansion and MDS calls bit for bit against their plain
     versions; B=32 forwards by CUDA events (3 after a warm-up, grids drawn
     on the host) with peak memory and one profiled forward; MSN's serving
     forward at B=32 in the exact arm (MDS 1) and the hybrid arm (the
     continuation 1);
 29. one training step of each family at B=32 (EMD, Adam;
     ``runners.msn.train_step``, ``runners.atlasnet.train_step``):
     launches (MSN: bids 100, expansion 1, MDS 1; AtlasNet: bids 50; no
     plain call); against a plain step on the card replaying its MDS picks
     and auction assignments, both in deterministic mode (loss and every
     gradient leaf); the step's expansion call whole, its MDS and first
     bids call (every bidder) on their first 2 clouds and its last 3 bids
     calls whole, bit for bit against their plain versions; 3 timed steps,
     peak memory, one profiled step;
 30. the CLIs with ``--model msn`` and ``atlasnet`` on their yamls
     (Synthetic, 2 steps at B=32, validation over 32 clouds at B=16): a
     step's launches as phase 29's, no plain call, one checkpoint; the
     runner resumed from it holds the generator, Adam and the grid
     generator bit for bit; the evaluation CLI on the checkpoint reads the
     training run's validation metrics (relative 1e-5), a batch's launches
     (bids 150 for MSN, 100 for AtlasNet, NN 2, MSN's MDS 1 and expansion
     1); ``--serving`` for MSN: the fit at load launches the expansion once
     and lies in [0.05, 50], a batch launches MDS once; clouds/s and
     seconds by part.
 31. GRNet (``models.define_G`` on grnet.yaml: 3000 input points, a 64^3
     grid, 2048 sampled and 16384 dense points) from seed 17 with jittered
     BatchNorm statistics, parity mode: each weight tensor's sha256 and, at
     B=2 on numpy-seeded partials with the witness's sample passed, sparse
     against the JAX package's on the CPU elementwise (atol 3e-6, rtol
     1e-4; docs/artifacts/port/jax_grnet_witness.npz, scripts/
     port_jax_grnet_witness.py), dense so decoded from the witness's sparse
     cloud, and from its own wherever a sparse point lies in the witness's
     cubic-feature cells (a point within rounding of a cell face may fall
     on the other side); the gridding reverse points a sample against the
     witness's count (within 8: voxels near the 1e-6 threshold); no kernel
     launched; gridding
     and gridding reverse on the card against the CPU on the same inputs
     within the contract, the cubic gathers bit for bit; the free-running
     dense cloud's Chamfer to the anchored one (a reading); B=32 forwards by
     CUDA events (3 after a warm-up) with peak memory and one profiled
     forward (device time by op group: cuDNN's 3D convolutions, the
     gridding scatter, the cubic and sample gathers, the sample's sort, the
     fc GEMMs); the NN #6 on the sparse loss's shapes (B=32, 2048 against
     16384 points and back) bit for bit against its plain version;
 32. one GRNet training step at B=32 (``runners.grnet.train_step``: sparse
     Chamfer, dense EMD, Adam): launches (#6 2, #8 50, no plain call);
     against a plain step on the card replaying its NN picks and auction
     assignments, both in deterministic mode (loss and every gradient
     leaf); the NN calls whole, the first bids call on its first 2 clouds
     and the last 3 whole, bit for bit against their plain versions; 3
     timed steps, peak memory, one profiled step by op group;
 33. the CLIs with ``--model grnet`` on grnet.yaml (Synthetic, 2 steps at
     B=32, validation over 32 clouds at B=16): a step's launches as phase
     32's, no plain call, one checkpoint; the runner resumed from it holds
     the generator, Adam and the sample's generator (``rng_sample``) bit
     for bit; the evaluation CLI on the checkpoint reads the training run's
     validation metrics (relative 1e-3: cuDNN's 3D convolutions may add
     with atomics), and twice in deterministic mode to equal metrics, a
     batch launching #6 4 and #8 100; clouds/s and seconds by part;
 34. the file datasets, on trees the phase writes in their published
     layouts: ShapeNet (GRnet layout, 2 categories, 48 training models of 8
     partial renderings of 2048 points and a 16384-point complete cloud,
     one partial in ASCII, 32 test models), Completion3D (.h5 written by
     the port, 32 VAL models of 2048 points) and KITTI (4 car scans with
     their box corners); the C++ PCD reader and the Python codec by MB/s
     on the card's host (warm cache), their clouds equal; the training CLI
     on ShapeNet (sparenet.yaml, 2 steps at B=24): a step's launches as
     phase 8's, no plain call, one checkpoint; the evaluation CLI on that
     checkpoint reads the training run's validation metrics (relative
     1e-5), a batch launching #1 4, #2 4, #3 2, #4 2, #6 and #8, no plain
     call, with its seconds by part and the data's share of the epoch; the
     evaluation CLI on Completion3D VAL at 2048 output points;
 35. the evaluation CLI's test modes on that checkpoint: ``render`` (a
     rendered batch launches #9 24 times, no plain call; its 24 PNGs decode
     to the depth maps the plain p2i renders on the card from the same
     clouds, pixel for pixel), ``kitti`` (B=1: no metrics, and the .h5
     clouds read back through data/h5.py equal a direct eval forward on the
     same pose-normalised partials), ``vis`` in a subprocess (without
     matplotlib it exits non-zero before building anything, naming it;
     with it, it writes its plots);
 36. FPD on the card: the canonical classifier (sparenet_tpu_torch/data/
     fpd_cls_canonical.npz) on 4 seeded clouds of 16384 points, its 1808-d
     activations against the JAX package's on the CPU (docs/artifacts/port/
     jax_arms_fpd_witness.npz, scripts/port_jax_arms_fpd_witness.py; atol
     3e-6, rtol 1e-4), and calculate_fpd of two seeded sets of 60 clouds of
     2048 points within 1e-3 relative of the JAX package's; then the FPD CLI
     (``python -m sparenet_tpu_torch.test_fpd``) in two processes side by
     side, fake and null against real, on three trees the phase writes,
     keyed to the first 50 models of each category of fpd_test.list at
     16384 points: every FPD finite, fake above null; seconds by part;
 37. SpareNet's other arms at full width (sparenet.yaml: 16384 points, 32
     primitives, bottleneck and hide 4096, SE on), (a) encode=Pointfeat with
     use_adain=no_share and (b) encode=Residualnet with use_adain=no_use,
     seeded with jittered BatchNorm statistics: each tensor's sha256 (on a
     stride) against the witness's; at B=2 a forward's launches, coarse
     against the witness (b's also with plain ops on the witness's encoder
     graphs, the slots its graphs differ in counted), loss_mst, both refine
     passes' MDS against the witness's picks and the refine anchored on the
     witness's cloud and picks, free-running by Chamfer; B=32 forwards with
     peak memory; one training step of each at B=4 against a plain step
     replaying its kNN graphs, MDS picks and auction assignments, both
     deterministic; the
     flagship step at B=24 with and without TPU.remat, twice each in
     deterministic mode: bit for bit, each step's time, peak and launches
     (remat: #1 and #7f twice in the encoder);
 38. EdgeRes and SIREN: one EdgeRes refine pass (16384 points, B=2) on the
     witness's coarse cloud and picks, #1 at each of its seven shapes (C =
     4, 64, 128, 1088, 512, 256, 128) against its plain version, timed; the
     pass with plain ops on the kernel's graphs elementwise, and against the
     witness by Chamfer (each on its own graphs); a flagship forward with
     EdgeRes (#1 18 times) and one training step at B=2 against a plain
     step; the SIREN decoder against the witness.
Deterministic mode is torch.use_deterministic_algorithms(True) as a user sets
it, with no warn_only: an op with no deterministic form fails the phase. The
script sets CUBLAS_WORKSPACE_CONFIG=:4096:8 before cuBLAS starts, which that
mode needs.
The output ends with a line "paths {...}" of each path's end-to-end time (the
line two runs are compared by), one JSON line of per-kernel numbers (every
TPU kernel of the JAX package, the packed kNN arm and the p2i backward, each
with its launches a step and a serving eval batch as the CLIs run them, and
on the file datasets' paths: a ShapeNet step and eval batch, a rendered
batch's side outputs, a KITTI cloud; on SpareNet's other arms, EdgeRes and
the rematted step; #1's times on EdgeRes's pass), the card's name
and power limit, and {"ok": true, "device": {...}} as the last line. Any failed
phase exits non-zero without that line. No CUDA device: exit 2.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import hashlib
import json
import lzma
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sparenet_tpu_torch import test as test_cli
from sparenet_tpu_torch import train as train_cli
from sparenet_tpu_torch.configs import CONFIG_DIR, cfg_from_file, cfg_update
from sparenet_tpu_torch.data import (IO, TEST, VAL, SyntheticDataset,
                                     collate, data_init, h5, read_pcd)
from sparenet_tpu_torch.data.datasets import _SYNTH_SHAPES, _surface_points
from sparenet_tpu_torch.native import read_pcd_native
from sparenet_tpu_torch.models import (N_INPUT_POINTS, ServingDial,
                                       build_discriminator, build_generator,
                                       MSN_MML_CALIBRATION, complete, define_G,
                                       set_parity_mode)
from sparenet_tpu_torch.ops import _lib
from sparenet_tpu_torch.ops import chamfer as chamfer_op
from sparenet_tpu_torch.ops import p2i as p2i_op
from sparenet_tpu_torch.ops import (edge_gather, emd, expansion_penalty,
                                    gather, knn, mds)
from sparenet_tpu_torch.ops import cubic_feature_sampling as cubic_op
from sparenet_tpu_torch.ops import gridding as gridding_op
from sparenet_tpu_torch.ops.common import (pairwise_sqdist_graph_seq,
                                           pairwise_sqdist_serving,
                                           slice_plan, sqdist3)
from sparenet_tpu_torch.models import grnet as grnet_model
from sparenet_tpu_torch.models.layers import (GridDecoderStack, grid_generation,
                                             init_weights, num_adain_params)
from sparenet_tpu_torch.models.sparenet import SpareNetRefine, flagged_base
from sparenet_tpu_torch.runners import atlasnet as atlas_runner
from sparenet_tpu_torch.runners import base as train_base
from sparenet_tpu_torch.runners import grnet as grnet_runner
from sparenet_tpu_torch.runners import msn as msn_runner
from sparenet_tpu_torch.renderer import ComputeDepthMaps, transform_points
from sparenet_tpu_torch.runners import sparenet as train_runner
from sparenet_tpu_torch.runners import get_runner
from sparenet_tpu_torch.runners import sparenet_gan as gan_runner
from sparenet_tpu_torch.utils.checkpoint import checkpoint_load
from sparenet_tpu_torch.utils.logging import set_logger
from sparenet_tpu_torch.utils import calibration
from sparenet_tpu_torch.utils import visualizer as uv
from sparenet_tpu_torch.utils.calibration import BAND
from sparenet_tpu_torch.utils.metrics import Metrics, compute_all, emd_metric
from sparenet_tpu_torch.utils.weights import reference_state_dict

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

def slot_sqdist_high(x, idx, chunk: int = 1024):
    """For the slots idx [B, N, k] of x [B, N, C], the distance both kNN
    versions round, evaluated exactly in float64: |x|^2 + |y|^2 - 2 (xh.yh
    + xh.yl + xl.yh), the reference's HIGH-precision split (xh = bf16(x),
    xl = bf16(x - xh)), written as |x - y|^2 from differences plus the
    split's error 2 sum(xh (yr - yl) + (xr - xl) yh + xr yr), xr = x - xh,
    so that nothing cancels. [B, N, k], ``chunk`` queries at a time."""
    xh = x.to(torch.bfloat16).float()
    xr = x - xh
    xl = xr.to(torch.bfloat16).float()
    xd, xhd, xrd, xld = (t.double() for t in (x, xh, xr, xl))
    out = []
    for s in range(0, x.shape[1], chunk):
        i = idx[:, s:s + chunk]
        q = slice(s, s + chunk)
        y, yh, yr, yl = (gather.gather_rows(t, i) for t in (xd, xhd, xrd, xld))
        diff = (y - xd[:, q, None]).square().sum(-1)
        err = (xhd[:, q, None] * (yr - yl) + (xrd - xld)[:, q, None] * yh
               + xrd[:, q, None] * yr).sum(-1)
        out.append((diff + 2.0 * err).clamp_min(0.0))
    return torch.cat(out, 1)


def compare_knn(x, got, want):
    """Index mismatches are acceptable only at near-ties: each query's k
    distances (``slot_sqdist_high``: the split distance both versions
    round, exact) sorted, for the two graphs slot by slot, within 1e-5 of
    |x|^2 + max |y|^2 over the row, an envelope of the f32 rounding of that
    distance in two summation orders. Sorted, a near-tie that moves one
    neighbour up compares no rank with the next.
    Where |x|^2 dwarfs the distances (EdgeRes's 1088-wide stage) the
    envelope spans several neighbour ranks: there the kernel is held to its
    own ranking bit for bit (``compare_knn_model``)."""
    got, want = got.long(), want.long()
    gap = (slot_sqdist_high(x, got).sort(-1).values
           - slot_sqdist_high(x, want).sort(-1).values).abs()
    x2 = x.double().square().sum(-1)
    b = x.shape[0]

    def far(idx):
        return x2.gather(1, idx.reshape(b, -1)).reshape(idx.shape).amax(-1)
    scale = x2 + torch.maximum(far(got), far(want))
    mism = got != want
    n_far = int((gap > 1e-5 * scale[..., None]).sum())
    err = float(gap.max())
    return (n_far == 0, err,
            f"{int(mism.sum())} index mismatches of {got.numel()}, {n_far} "
            f"sorted distances beyond the near-tie envelope; max gap "
            f"{err:.3e}")


def compare_knn_model(got, rows, model):
    """The kernel's graph got [B, N, k] at the query rows ``rows`` against
    its own ranking there (``knn.knn_seq_rows``): bit for bit."""
    g = got[:, rows].long()
    bad = g != model[..., :got.shape[2]]
    return (not bool(bad.any()), int(bad.sum()),
            f"{int(bad.any(-1).sum())} of {bad.shape[0] * bad.shape[1]} "
            f"sampled queries off the kernel's own ranking ({int(bad.sum())} "
            f"slots)")


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


def step_gaps(a, b, zero_grad=ZERO_GRAD):
    """(loss rel gap, largest relative-L2 gap of a gradient leaf, largest
    norm of a ``zero_grad`` leaf's gap, name of the worst leaf)."""
    (la, ga), (lb, gb) = a, b
    loss = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(la, lb))
    rel, zero, worst = 0.0, 0.0, ""
    assert ga.keys() == gb.keys()
    for name in ga:
        d = float((ga[name] - gb[name]).double().norm())
        if name in zero_grad:
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


# ---------------------------------------------------------------------------
# phases 26-27: serving mode on the trained npz
# ---------------------------------------------------------------------------

# the JAX package's mml fit of this checkpoint (before its bf16 archive;
# docs/SERVING_ENVELOPE.md section 7: 1.2695 +- 0.009), made on a TPU by
# scripts/calibrate_mml.py: parity-mode coarse clouds of 32 partial clouds
# drawn uniform in [-0.5, 0.5]^3 by RandomState(0); the contract's
# calibration. The port's runner fits its own ratio on the split's first
# batch (phase 26), held to the JAX package's fit on the same serving
# coarse clouds (scripts/port_jax_serving_witness.py, on the CPU) within
# FIT_TOL, half the JAX fit's spread over batches
JAX_FIT, FIT_TOL = 1.2695, 0.005
CALIBRATE_B, CALIBRATE_SEED = 32, 0
WITNESS = os.path.join(ROOT, "docs", "artifacts", "port",
                       "jax_serving_witness.json")
# the serving contract (docs/SERVING_ENVELOPE.md section 7,
# scripts/r5/envelope_multibatch.py): Synthetic VAL, 8 batches of 16, the
# calibration fixed at JAX_FIT, F / CD / EMD (eps 0.005, 50 rounds). Each
# row is held to the JAX package's own reading of it on the same weights
# and coarse clouds (WITNESS, on the CPU) within WITNESS_PP, and to its
# JAX (TPU) row's window where the JAX package's CPU reading lies inside
# that window
ENVELOPE = os.path.join(ROOT, "docs", "artifacts", "r5", "stage5",
                        "envelope_r5ckpt.json")
ENV_BATCHES, ENV_B = 8, 16
ENV_EPS, ENV_ITERS = 0.005, 50
# (row, its dial, its JAX (TPU) row, its sort twin)
ENV_ROWS = (
    ("parity", None, None, None),
    ("exact", ServingDial(mds="exact"), "serving exactMDS", None),
    ("S=2048", ServingDial(mds="batched"), "serving S=2048", None),
    ("S=2048/pack16", ServingDial(mds="batched", select="pack16"),
     "serving S=2048/pack16", "S=2048"),
    ("S=4096", ServingDial(mds="batched", schedule=(4096,)),
     "serving S=4096", None),
    ("S=4096/pack16", ServingDial(mds="batched", schedule=(4096,),
                                  select="pack16"),
     "serving S=4096/pack16", "S=4096"),
    ("G=8192", ServingDial(mds="batched", schedule=()), "serving G=8192",
     None),
    ("G=8192/pack16", ServingDial(mds="batched", schedule=(),
                                  select="pack16"),
     "serving G=8192/pack16", "G=8192"),
    ("hybrid", ServingDial(mds="hybrid"), None, None),
)
# the JAX window is its row's mean dF +- 2 standard deviations; a pack16
# row within 0.3 pp of its sort twin (the JAX twins agree within 0.06 pp),
# and a row's mean dF within as much of the JAX package's CPU reading
ENV_SIGMAS, TWIN_PP, WITNESS_PP = 2.0, 0.3, 0.3
# the kernels of the serving eval path (the load's fit adds the expansion)
SERVING_EVAL_OPS = ("knn_packed", "gather_max", "nn_idx", "emd_bids")


def launches_of(batch: dict, name: str):
    """A kernel's launches a batch, an int where the batches agree."""
    v = batch.get(name, 0)
    return int(v) if float(v).is_integer() else round(v, 3)


def set_dial(model, dial: ServingDial) -> None:
    """Put a serving generator's refine passes on ``dial``."""
    r = model.refine
    r.mds = mds.resolve_impl(dial.mds, serving=True)
    r.mds_g, r.mds_schedule, r.mds_tail = dial.g, dial.schedule, dial.tail
    r.select = dial.select


def serving_cli(work: str, tag: str, extra: list, config: str = EVAL_YAML):
    """The evaluation CLI (``test.build`` and ``test.run``, in process) in
    serving mode on the npz over ``config``'s split (flagship_e8_eval.yaml),
    counts set to 0 just before the runner is built and read after its load
    and after the evaluation: (runner, line, load's launches, the
    evaluation's)."""
    _lib.reset_counts()
    runner = test_cli.build(["--config", config, "--weights", TRAINED_NPZ,
                             "--workdir", os.path.join(work, tag),
                             "--serving"] + extra)
    torch.cuda.synchronize()
    load = dict(_lib.LAUNCHES)
    line = test_cli.run(runner)
    torch.cuda.synchronize()
    evals = {k: v - load[k] for k, v in _lib.LAUNCHES.items()}
    if any(_lib.PLAIN_CALLS.values()):
        fail(f"serving CLI {tag}: plain calls {dict(_lib.PLAIN_CALLS)}")
    return runner, line, load, evals


def compare_knn_packed(x, got, want):
    """The packed kNN kernel against its plain version on trained inputs:
    an index may differ only where the two candidates' keys (by the plain
    version's distances) sit in the same or adjacent truncation bucket
    (a near-tie, which a rounding of the bf16 product moves)."""
    got, want = got.long(), want.long()
    mism = got != want
    if not bool(mism.any()):
        return True, 0, "indices exact"
    d = pairwise_sqdist_serving(x, x).contiguous()
    bits = knn.packed_bits(x.shape[1])
    key = lambda idx: d.gather(2, idx).view(torch.int32) >> bits
    gap = (key(got) - key(want)).abs()[mism]
    far = int((gap > 1).sum())
    return far == 0, int(mism.sum()), (
        f"{int(mism.sum())} index mismatches of {got.numel()}, {far} beyond "
        f"adjacent key buckets")


def check_trained_serving_kernels(model, partial) -> None:
    """#1p and #5 on the trained clouds' own inputs (the hybrid forward of
    the split's first batch): the packed kNN within its near-tie buckets
    (mismatched slots counted), the continuation bit for bit; the kNN
    queries flagged for the exact scan."""
    calls: dict = {}
    with swapped(**recording(calls)):
        complete(model, partial)
    mism = []
    for i, (args, kw, out) in enumerate(calls["knn"]):
        ok, n, msg = compare_knn_packed(args[0], out, plain_knn(*args, **kw))
        mism.append(n)
        ms = cuda_ms(lambda: knn.knn_idx(*args, **kw), reps=3)
        log(f"  knn_packed call {i} {list(args[0].shape)} on trained inputs: "
            f"{msg}; kernel {ms:.4f} ms")
        if not ok:
            fail(f"knn_packed call {i} on trained inputs: mismatches beyond "
                 f"the near-tie buckets")
    report_flagged(calls["knn"], "the trained serving forward's inputs")
    for i, (args, kw, out) in enumerate(calls["mds_continue"]):
        ok, err, msg = compare_exact(out, mds.mds_continue_plain(*args, **kw))
        ms = cuda_ms(lambda: mds.mds_continue(*args, **kw), reps=3)
        log(f"  mds_continue call {i} {list(args[0].shape)}, {args[4]} steps "
            f"on trained inputs: {msg}; kernel {ms:.4f} ms")
        if not ok:
            fail(f"mds_continue call {i} on trained inputs differs from its "
                 f"plain version")
    PATHS["serving_trained_knn_mismatch"] = mism


def nn_mean_one_pass_bf16(coarse, s: int):
    """The serving mml estimate at calibration 1 as the JAX package's TPU
    program computes it: its distance matmul at the TPU's default precision,
    one bf16 pass (operands rounded to bf16, products summed in f32), the
    norms in f32 (sparenet_tpu/ops/expansion_penalty.py:
    mean_mst_length_estimate). A measuring device for the JAX fit, which
    was taken on a TPU; no path of the port computes it."""
    b, n, _ = coarse.shape
    p = coarse.float().reshape(b * (n // s), s, 3)
    p2 = (p * p).sum(-1)
    pb = p.bfloat16().float()
    d2 = p2[:, :, None] + p2[:, None, :] - 2.0 * torch.bmm(pb, pb.transpose(1, 2))
    d2 = d2 + torch.eye(s, device=p.device) * 1e9
    return d2.amin(-1).clamp_min(0.0).sqrt().mean(-1).reshape(b, n // s).mean(-1)


@torch.no_grad()
def calibrate_protocol(dev) -> tuple[float, float]:
    """scripts/calibrate_mml.py's fit on the npz: the mean over the clouds
    of Prim's mml over the NN-mean estimate, on the parity-mode coarse
    clouds of RandomState(0)'s 32 partial clouds uniform in [-0.5, 0.5]^3;
    (the port's, its estimate in f32; the same with the estimate's product
    at one bf16 pass, as the TPU that took JAX_FIT ran it)."""
    rs = np.random.RandomState(CALIBRATE_SEED)
    partial = torch.from_numpy(
        (rs.rand(CALIBRATE_B, N_INPUT_POINTS, 3) - 0.5).astype(np.float32))
    model = trained_model(dev)
    coarse = model.decoder(model.encoder(partial.to(dev)))
    s = model.refine.primitive_size
    _, _, mml = expansion_penalty.expansion_penalty(coarse, s, 1.5)
    ratio = float(calibration.fit_mml_ratio(coarse, s))
    tpu = float((mml / nn_mean_one_pass_bf16(coarse, s)).mean())
    del model
    return ratio, tpu


def main_serving_cli(dev) -> dict:
    """Phase 26; returns a serving eval batch's launches by arm."""
    release_memory("the serving CLI")
    work = tempfile.mkdtemp(prefix="serve_cli_")
    per_batch = {}
    try:
        for tag, extra, arm in (("default", [], "mds"),
                                ("hybrid", ["--mds", "hybrid"], "mds_continue")):
            runner, line, load, evals = serving_cli(work, tag, extra)
            n = line["batches"]
            ratio = runner.mml_calibration
            log(f"  {tag}: mode {line['mode']}, dial {line['dial']}; the load "
                f"launched {({k: v for k, v in load.items() if v})}; mml ratio "
                f"{ratio:.4f} fitted {line['mml_fitted']} (band {BAND}); the "
                f"evaluation launched "
                f"{({k: v for k, v in evals.items() if v})} over {n} batches")
            if load["expansion"] != 1 or not line["mml_fitted"]:
                fail(f"serving CLI {tag}: the fit launched expansion "
                     f"{load['expansion']} times, fitted {line['mml_fitted']}")
            if not BAND[0] <= ratio <= BAND[1]:
                fail(f"serving CLI {tag}: mml ratio {ratio:.4f} outside the "
                     f"band {BAND}")
            for name in SERVING_EVAL_OPS + (arm,):
                if evals[name] == 0:
                    fail(f"serving CLI {tag}: {name} was not launched")
            other = "mds_continue" if arm == "mds" else "mds"
            for name in ("knn", "expansion", other):
                if evals[name]:
                    fail(f"serving CLI {tag}: {name} launched {evals[name]} "
                         f"times in serving evaluation")
            want_arm = "exact" if tag == "default" else "hybrid"
            if line["mode"] != "serving" or line["dial"]["arm"] != want_arm:
                fail(f"serving CLI {tag}: line mode {line['mode']}, arm "
                     f"{line['dial']['arm']}")
            per_batch[tag] = {k: v / n for k, v in evals.items() if v}
            sec = line["seconds"]
            log(f"  {tag} eval epoch on {nvidia_smi()}: {line['n_clouds']} "
                f"clouds, {line['clouds_per_s']:.2f} clouds/s; data "
                f"{sec['data']:.3f} s, forward (with the validation losses) "
                f"{sec['forward']:.3f} s, metrics {sec['metrics']:.3f} s; F "
                f"{line['F-Score']:.4f}, CD x 1000 "
                f"{line['ChamferDistance']:.4f}, EMD x 100 {line['EMD']:.4f} "
                f"(parity, phase 22: {PATHS.get('eval_trained', {}).get('clouds_per_s', 0):.2f}"
                f" clouds/s, F {PATHS.get('eval_trained', {}).get('F-Score', 0):.4f})")
            PATHS[f"serving_cli_{tag}"] = dict(
                clouds_per_s=line["clouds_per_s"], mml=ratio,
                **{f"{k}_s": v for k, v in sec.items()},
                **{k: line[k] for k in Metrics.names()})
            if tag == "default":
                fitted = ratio
                _, _, _, data = runner.val_loader.first_batch()
                partial = torch.from_numpy(data["partial_cloud"]).to(dev)
                # the runner adds nothing to the fit: the same ratio again
                m = runner.model
                again = float(calibration.fit_mml_ratio(
                    m.decoder(m.encoder(partial)), m.refine.primitive_size))
                with open(WITNESS) as f:
                    jax_fit = json.load(f)["fit"]["jax_cpu"]
                log(f"  the fit again on the same batch's serving coarse "
                    f"clouds: {again:.6f} (the runner's {ratio:.6f}); the "
                    f"JAX package's fit on them (CPU, "
                    f"scripts/port_jax_serving_witness.py): {jax_fit:.6f}, "
                    f"limit +-{FIT_TOL}")
                if again != ratio:
                    fail("the runner's fitted ratio differs from the fit on "
                         "the same batch")
                if abs(ratio - jax_fit) > FIT_TOL:
                    fail(f"the runner's fit {ratio:.6f} is beyond {FIT_TOL} "
                         f"of the JAX package's {jax_fit:.6f}")
                ds = SyntheticDataset(eval_config(), TEST)
                data32 = collate([ds[i] for i in range(B_BENCH)])[3]
                partial32 = torch.from_numpy(data32["partial_cloud"]).to(dev)
                ms = {}
                for a in SERVING_ARMS:
                    set_dial(runner.model, ServingDial(mds=a))
                    ms[a] = cuda_ms(lambda: complete(runner.model, partial32),
                                    reps=3)
                log(f"  B={B_BENCH} serving forward on trained clouds (the "
                    f"split's first {B_BENCH}, ratio {fitted:.4f}) on "
                    f"{nvidia_smi()}: " + ", ".join(
                        f"{a} {ms[a]:.1f} ms ({B_BENCH / ms[a] * 1e3:.2f} "
                        f"clouds/s; random weights, phase 20: "
                        f"{PATHS.get(f'serving_{a}_b32_ms', 0):.1f} ms)"
                        for a in SERVING_ARMS))
                PATHS.update({f"serving_trained_{a}_b32_ms": v
                              for a, v in ms.items()})
            else:
                check_trained_serving_kernels(runner.model, partial)
            del runner
            release_memory(f"the next serving CLI run")
        proto, tpu = calibrate_protocol(dev)
        log(f"  a reading: scripts/calibrate_mml.py's protocol "
            f"({CALIBRATE_B} uniform partial clouds of RandomState("
            f"{CALIBRATE_SEED}), parity coarse) on the npz: the port's ratio "
            f"{proto:.4f}; with the estimate's product at one bf16 pass, as "
            f"on the TPU that took the JAX fit {JAX_FIT}: {tpu:.4f}; the "
            f"runner's fit on the split's first batch {fitted:.4f}")
        PATHS["mml_fit"] = dict(runner=fitted, jax_cpu_same_clouds=jax_fit,
                                calibrate_protocol=proto,
                                calibrate_protocol_one_pass_bf16=tpu)
        runner, line, load, evals = serving_cli(
            work, "mml_set", [], run_yaml(os.path.basename(EVAL_YAML), work, {
                "NETWORK": {"mml_calibration": JAX_FIT}}))
        log(f"  NETWORK.mml_calibration {JAX_FIT}: the load launched "
            f"{({k: v for k, v in load.items() if v})}, ratio "
            f"{runner.mml_calibration} fitted {line['mml_fitted']}; F "
            f"{line['F-Score']:.4f}, CD x 1000 {line['ChamferDistance']:.4f}")
        if (any(load.values()) or evals["expansion"] or line["mml_fitted"]
                or runner.mml_calibration != JAX_FIT):
            fail("serving CLI with NETWORK.mml_calibration set: a fit ran or "
                 "the set ratio did not reach the model")
        del runner
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return per_batch


def envelope_data(dev):
    """The contract's clouds: Synthetic VAL, n_val 128, [8, 16, N, 3] on
    the card (partial, gt)."""
    cfg = eval_config()
    cfg.DATASETS.synthetic.n_val = ENV_BATCHES * ENV_B
    ds = SyntheticDataset(cfg, VAL)
    items = collate([ds[i] for i in range(ENV_BATCHES * ENV_B)])[3]
    return tuple(torch.from_numpy(items[k]).reshape(
        ENV_BATCHES, ENV_B, -1, 3).to(dev) for k in ("partial_cloud", "gtcloud"))


def select_agreement(counts: dict):
    """Route the batched rounds' selection through a check: every "sort"
    round is also picked by "bisect", whose set must equal sort's ("topk"
    is the sort arm itself)."""
    base = mds.select_smallest

    def check(temp, take, select="sort"):
        out = base(temp, take, select)
        if select == "sort":
            counts["rounds"] += 1
            bis = mds.select_smallest_bisect(temp, take)
            counts["bisect"] += not torch.equal(bis, out.sort(1).values)
        return out
    return patched((mds, "select_smallest", check))


def envelope_rows(parity, serving, partial, gt, mml: float, counts: dict):
    """Each contract row's per-batch means [batches, (F, CD, EMD)], the
    serving rows at the calibration ``mml``."""
    serving.refine.mml_calibration = mml
    rows = {}
    with select_agreement(counts):
        for name, dial, _, _ in ENV_ROWS:
            model = parity if dial is None else serving
            if dial is not None:
                set_dial(model, dial)
            vals = [compute_all(complete(model, partial[i])[2], gt[i], ENV_EPS,
                                ENV_ITERS).mean(1) for i in range(ENV_BATCHES)]
            rows[name] = torch.stack([torch.from_numpy(v) for v in vals]).double()
    return rows


def envelope_table(rows: dict, jax_rows: dict, witness: dict) -> dict:
    """Each row's means and paired dF against parity, beside the JAX
    package's CPU reading of the row (``witness``; a pack16 row's is its
    sort twin's) and its JAX (TPU) row's window. A row fails beyond
    WITNESS_PP of its CPU reading, outside its window where the CPU reading
    lies inside it, or, for pack16, beyond TWIN_PP of its sort twin; a
    window that the CPU reading itself misses is a finding, printed."""
    par_f = rows["parity"][:, 0]
    moves, table, standing = {}, {}, []
    for name, dial, jax_name, twin in ENV_ROWS:
        r = rows[name]
        m, sd = r.mean(0), r.std(0, unbiased=False)
        rel = (r[:, 0] - par_f) / par_f * 100.0
        moves[name] = float(rel.mean())
        table[name] = dict(cd=float(m[1]), f=float(m[0]), emd=float(m[2]),
                           df_mean=float(rel.mean()),
                           df_std=float(rel.std(unbiased=False)),
                           per_batch_df=[round(float(v), 3) for v in rel])
        verdict = ""
        if dial is not None:
            cpu = witness[twin or name]["df_mean"]
            table[name]["jax_cpu_df"] = cpu
            verdict = (f"JAX (CPU) {cpu:+.2f}, {abs(moves[name] - cpu):.3f} pp "
                       f"away (limit {WITNESS_PP})")
            if abs(moves[name] - cpu) > WITNESS_PP:
                fail(f"contract row {name}: dF {moves[name]:+.2f}% is beyond "
                     f"{WITNESS_PP} pp of the JAX package's {cpu:+.2f}%")
        if jax_name:
            j = jax_rows[jax_name]
            lo = j["f_move_pct_mean"] - ENV_SIGMAS * j["f_move_pct_std"]
            hi = j["f_move_pct_mean"] + ENV_SIGMAS * j["f_move_pct_std"]
            inside = lo <= moves[name] <= hi
            binds = lo <= cpu <= hi
            verdict += (f"; JAX (TPU) {j['f_move_pct_mean']:+.2f} +- "
                        f"{j['f_move_pct_std']:.2f}, window [{lo:+.2f}, "
                        f"{hi:+.2f}]: {'inside' if inside else 'OUTSIDE'}")
            table[name].update(window=[lo, hi], inside=inside)
            if not inside and binds:
                fail(f"contract row {name}: dF {moves[name]:+.2f}% outside "
                     f"the JAX window [{lo:+.2f}, {hi:+.2f}]")
            if not inside:
                standing.append(name)
                verdict += (" (the JAX package's CPU reading is outside it "
                            "too: a finding, not gated)")
        if twin:
            gap = abs(moves[name] - moves[twin])
            verdict += f"; {gap:.3f} pp from {twin} (limit {TWIN_PP})"
            if gap > TWIN_PP:
                fail(f"contract row {name}: {gap:.3f} pp from its sort twin")
        log(f"  [{name:14s}] CD x 1000 {m[1]:.4f} +- {sd[1]:.4f}, F "
            f"{m[0]:.4f} +- {sd[0]:.4f}, EMD x 100 {m[2]:.4f} +- {sd[2]:.4f}"
            + ("" if dial is None else
               f"; dF {rel.mean():+.2f}% +- {rel.std(unbiased=False):.2f}% "
               f"(per batch {' '.join(f'{v:+.1f}' for v in rel.tolist())}); "
               + verdict))
    if standing:
        log(f"  outside their JAX (TPU) windows: {', '.join(standing)}")
    return table


def main_envelope(dev) -> None:
    """Phase 27: serving's quality contract on the npz at the calibration
    JAX_FIT, against the JAX package's CPU reading and the JAX (TPU)
    envelope."""
    release_memory("the serving contract")
    with open(ENVELOPE) as f:
        jax_rows = json.load(f)["rows"]
    with open(WITNESS) as f:
        witness = json.load(f)["contract"]
    partial, gt = envelope_data(dev)
    parity = trained_model(dev)
    serving = build_generator(seed=0, device="cpu", serving=True)
    serving.load_state_dict(parity.state_dict())
    serving = serving.to(dev).eval()
    counts = {"rounds": 0, "bisect": 0}
    t = time.perf_counter()
    rows = envelope_rows(parity, serving, partial, gt, JAX_FIT, counts)
    log(f"  mml calibration {JAX_FIT}: {len(ENV_ROWS)} rows x {ENV_BATCHES} "
        f"batches of {ENV_B} in {time.perf_counter() - t:.1f} s; parity F "
        f"{float(rows['parity'][:, 0].mean()):.4f} (the JAX package's CPU "
        f"reading {witness['parity']['f_mean']:.4f})")
    PATHS["serving_contract"] = envelope_table(rows, jax_rows, witness)
    log(f"  the batched rounds' selection: {counts['rounds']} sort rounds; "
        f"bisect's set differs in {counts['bisect']}")
    if counts["rounds"] == 0 or counts["bisect"]:
        fail(f"bisect picks differ from sort: {counts}")
    del parity, serving


# ---------------------------------------------------------------------------
# MSN and AtlasNet (phases 28-30)
# ---------------------------------------------------------------------------

# scripts/port_jax_msn_witness.py: the JAX package's forwards of both families
# at full width on the CPU, from the weights ``witness_model`` builds
MSN_WITNESS = os.path.join(ROOT, "docs", "artifacts", "port",
                           "jax_msn_atlasnet_witness.npz")
WITNESS_SEED, WITNESS_B = 17, 2
FAMILIES = ("atlasnet", "msn")


def family_config(family: str):
    """The port's copy of the family's shipped yaml (16384 points, 32
    primitives, B=32, EMD)."""
    return cfg_from_file(os.path.join(CONFIG_DIR, f"{family}.yaml"))


def witness_model(family: str, dev, dial=None):
    """The family at full width (``define_G`` on its yaml), initialised on
    the CPU from WITNESS_SEED with jittered BatchNorm statistics (phase 3's
    recipe; the initialisation's own statistics fold each primitive to
    within 3e-5 of a point), on ``dev`` in eval mode. GRNet's too (phase
    31)."""
    model = define_G(family_config(family), seed=WITNESS_SEED, device="cpu",
                     dial=dial)
    jitter_bn_stats(model, torch.Generator().manual_seed(WITNESS_SEED + 1))
    return model.to(dev).eval()


def witness_inputs(batch: int = WITNESS_B):
    """numpy-seeded partial clouds [B, 3000, 3] in [-0.5, 0.5) and grids
    [32, B, 512, 2] in [0, 1)."""
    rs = np.random.RandomState(WITNESS_SEED)
    partial = (rs.rand(batch, N_INPUT_POINTS, 3) - 0.5).astype(np.float32)
    grids = rs.rand(N_PRIMS, batch, PRIM_S, 2).astype(np.float32)
    return partial, grids


def weight_checksums(model) -> dict:
    """sha256 (first 16 hex digits) of each tensor of the model's
    reference-layout state_dict, by key."""
    return {k: hashlib.sha256(v.contiguous().numpy().tobytes()).hexdigest()[:16]
            for k, v in sorted(reference_state_dict(model).items())}


B_FAMILY = atlas_runner.CONFIG["batch_size"]   # 32, msn.yaml and atlasnet.yaml
FAMILY_STEP = {"atlasnet": atlas_runner.train_step,
               "msn": msn_runner.train_step, "grnet": grnet_runner.train_step}
# launches of an eval forward and of a training step (EMD: 50 bids rounds a
# reconstruction loss at the loss's protocol; GRNet's sparse Chamfer, the NN
# both ways)
FAMILY_FORWARD = {"atlasnet": {}, "msn": {"expansion": 1, "mds": 1}}
FAMILY_STEP_LAUNCHES = {"atlasnet": {"emd_bids": 50},
                        "msn": {"emd_bids": 100, "expansion": 1, "mds": 1},
                        "grnet": {"nn_idx": 2, "emd_bids": 50}}
# a validation batch's launches in the evaluation CLI (parity): the EMD
# validation losses at the loss's protocol and the metrics' auction, the NN
# both ways for the metrics (and GRNet's sparse loss), MSN's refine
FAMILY_EVAL_BATCH = {"atlasnet": {"emd_bids": 100, "nn_idx": 2},
                     "msn": {"emd_bids": 150, "nn_idx": 2, "mds": 1,
                             "expansion": 1},
                     "grnet": {"emd_bids": 100, "nn_idx": 4}}
# Gradients that are exactly 0 in exact arithmetic (tests/
# test_torch_msn_atlasnet_train.py, test_torch_grnet_train.py): biases ahead
# of a train-mode BatchNorm, and the BatchNorm biases before a max-pool
# whose shift the next one removes
FAMILY_ZERO_GRAD = ({"encoder.linear.bias", "encoder.feat_extractor.bn3.bias",
                     "res.bn3.bias"}
                    | {f"encoder.feat_extractor.conv{i}.bias" for i in (1, 2, 3)}
                    | {f"decoder.conv{i}.bias" for i in (1, 2, 3)}
                    | {f"res.conv{i}.bias" for i in range(1, 7)}
                    | {f"conv{i}.0.bias" for i in (1, 2, 3, 4)})
# GRNet's evaluation is reproducible only in deterministic mode: cuDNN's
# algorithms for its 3D (transposed) convolutions may add with atomics, and
# the auction and the F-Score threshold carry the last bits into the
# metrics; so phase 33 holds the evaluation CLI to the training run's
# validation within this relative gap, and two evaluations in deterministic
# mode to each other exactly (the other families, bit for bit, within 1e-5)
FAMILY_RUN_TO_RUN = {"grnet": 1e-3}
# the ops whose kernel outputs a family's plain step replays (phases 29 and
# 32) and the kernel calls held to their plain versions on a step's inputs
# beside the bids' (name -> [(call index, clouds or None)])
FAMILY_REPLAYED = {"atlasnet": (), "msn": ("mds",), "grnet": ("nn_idx",)}
# the CLIs' run: 2 training steps at B=32, validation over 32 clouds at B=16
FAMILY_CLI_RUN = {"TRAIN": {"save_freq": 1}, "TEST": {"batch_size": 16},
                  "DATASETS": {"synthetic": {"n_train": 2 * B_FAMILY,
                                             "n_val": 32}}}
# a kernel's calls held to its plain version on a training step's inputs:
# MDS on its first clouds (the plain greedy loop takes seconds a call), the
# bids' first call (every bidder) on its first clouds and its last calls
# (the fewest bidders) whole
STEP_HELD_CLOUDS, BIDS_LAST_HELD = 2, 3


def launch_counts(fn):
    """(fn(), launches by op, plain calls by op): the counts set to 0 just
    before and read just after."""
    _lib.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: v for k, v in _lib.LAUNCHES.items() if v},
            {k: v for k, v in _lib.PLAIN_CALLS.items() if v})


def check_launches(what: str, launches: dict, plain: dict, want: dict) -> None:
    log(f"  {what}: launches {launches}, plain calls {plain}")
    if launches != want or plain:
        fail(f"{what}: launches {launches} (expected {want}), plain calls "
             f"{plain}")


def hold(what: str, got, want, atol=CONTRACT_ATOL, rtol=CONTRACT_RTOL) -> float:
    """got (a card tensor) against want (numpy) elementwise; the max abs
    error."""
    got, want = got.detach().float().cpu(), torch.as_tensor(np.asarray(want))
    err = float((got - want).abs().max())
    ok = got.shape == want.shape and bool(torch.allclose(got, want, atol=atol,
                                                         rtol=rtol))
    log(f"  {what}: max abs err {err:.3e} (atol {atol:g}, rtol {rtol:g})"
        + ("" if ok else ": FAILS"))
    if not ok:
        fail(f"{what} differs from the witness")
    return err


def first_clouds(args, c: int):
    """The call's tensor arguments cut to their first c clouds (the
    kernels of these paths treat each cloud on its own)."""
    b = args[0].shape[0]
    return tuple(a[:c] if isinstance(a, torch.Tensor) and a.dim()
                 and a.shape[0] == b else a for a in args)


def hold_kernels(calls: dict, held: dict, what: str) -> None:
    """Each held call (``held``: name -> [(call index, clouds or None)])
    against the plain version on the same inputs, every output bit for bit;
    the kernel's ms on the whole call by CUDA events beside the plain one's
    on what was held."""
    for name, picks in held.items():
        for i, c in picks:
            args, kw, out = calls[name][i]
            cut = args if c is None else first_clouds(args, c)
            t0 = time.perf_counter()
            want = PLAIN[name](*cut, **kw)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            got = out if c is None else tuple(
                o[:c] for o in (out if isinstance(out, tuple) else (out,)))
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            ms = cuda_ms(lambda: KERNEL[name](*args, **kw), reps=3)
            log(f"  {name} call {i} of {len(calls[name])} of the {what}, "
                f"{list(args[0].shape)}"
                + ("" if c is None else f", held on its first {c} clouds")
                + f": bit for bit {exact}; kernel {ms:.3f} ms, plain "
                f"{pms:.1f} ms")
            if not exact:
                fail(f"{name} call {i} of the {what}: kernel differs from the "
                     f"plain version")


@torch.no_grad()
def main_family_eval(dev) -> dict:
    """Phase 28; returns the launches of each family's forward (MSN's
    serving arms as ``msn_serving_<arm>``)."""
    release_memory("the MSN and AtlasNet forwards")
    out: dict = {}
    if not os.path.exists(MSN_WITNESS):
        fail(f"{MSN_WITNESS} is missing (scripts/port_jax_msn_witness.py)")
        return out
    w = np.load(MSN_WITNESS)
    partial_np, grids_np = witness_inputs()
    partial = torch.from_numpy(partial_np).to(dev)
    grids = torch.from_numpy(grids_np).to(dev)
    gen = torch.Generator().manual_seed(28)
    partial32 = (torch.rand(B_FAMILY, N_INPUT_POINTS, 3, generator=gen)
                 - 0.5).to(dev)
    for family in FAMILIES:
        model = witness_model(family, dev)
        want_sums = json.loads(str(w[f"{family}_checksums"]))
        sums = weight_checksums(model)
        bad = [k for k in want_sums if sums.get(k) != want_sums[k]]
        if bad or sums.keys() != want_sums.keys():
            fail(f"{family}: {len(bad)} of {len(want_sums)} weight tensors "
                 f"differ from the witness's (e.g. {bad[:3]}): this torch "
                 f"({torch.__version__}) draws other numbers from seed "
                 f"{WITNESS_SEED}, so the witness does not apply")
            continue
        n_par = sum(p.numel() for p in model.parameters())
        log(f"  {family}: {n_par} parameters; its {len(sums)} weight tensors "
            f"equal the witness's by sha256")
        calls: dict = {}
        with swapped(**recording(calls)):
            res, launches, plain = launch_counts(
                lambda: complete(model, partial, grids=grids))
        check_launches(f"{family} forward, B={WITNESS_B}", launches, plain,
                       FAMILY_FORWARD[family])
        out[family] = launches
        if family == "atlasnet":
            hold("AtlasNet's cloud against the witness", res, w["atlasnet_out"])
        else:
            coarse, refine, loss_mst = res
            hold("MSN's coarse cloud against the witness", coarse,
                 w["msn_coarse"])
            jc = torch.from_numpy(w["msn_coarse"]).to(dev)
            dist, _, mml = expansion_penalty.expansion_penalty(jc, PRIM_S, 1.5)
            hold("MSN's mml (#3) on the witness's coarse cloud", mml,
                 w["msn_mml"], atol=0.0)
            hold("MSN's loss_mst on the witness's coarse cloud", dist.mean(),
                 w["msn_loss_mst"], atol=0.0)
            # free-running, a reading: the coarse clouds' 1e-7 differences
            # are 1e-3 of the edges of these folds (a primitive spans
            # 1e-4), and the charged edges' sum follows
            log(f"  MSN's loss_mst free-running: {float(loss_mst)!r} against "
                f"the witness's {float(w['msn_loss_mst'])!r}, relative gap "
                f"{abs(float(loss_mst) / float(w['msn_loss_mst']) - 1):.3e}")
            base = flagged_base(jc, partial)
            wm = torch.from_numpy(w["msn_mml"]).to(dev)
            w_idx = torch.from_numpy(w["msn_idx"]).to(dev)
            idx = mds.minimum_density_sample(base[..., :3].contiguous(), N_OUT,
                                             wm)
            ok, _, msg = compare_mds(base[..., :3], wm, idx, w_idx)
            log(f"  MSN's MDS (#4) on the witness's coarse cloud and mml "
                f"against the JAX package's picks: {msg}")
            if not ok:
                fail("MSN's MDS picks part from the JAX package's at a step "
                     "that is no near-tie")
            hold("MSN's refine anchored on the witness's coarse cloud and "
                 "picks", model.finish(base, w_idx), w["msn_refine"])
            cd = chamfer(refine, torch.from_numpy(w["msn_refine"]).to(dev))
            log(f"  MSN's refine free-running: Chamfer {cd:.3e} against the "
                f"witness (limit {CONTRACT_CHAMFER:g})")
            if not cd <= CONTRACT_CHAMFER:
                fail(f"MSN's free-running refine: Chamfer {cd:.3e}")
            hold_kernels(calls, {"expansion": [(0, None)], "mds": [(0, None)]},
                         f"MSN forward at B={WITNESS_B}")

        def run():
            return complete(model, partial32,
                            generator=torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(run, reps=3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  {family} forward, B={B_FAMILY}, parity (grids drawn on the "
            f"host a forward, as the runners draw them): {ms:.1f} ms, "
            f"{B_FAMILY / (ms / 1e3):.2f} clouds/s, peak memory {peak:.2f} "
            f"GiB, on {nvidia_smi()}")
        PATHS[f"{family}_b32_ms"] = ms
        PATHS[f"{family}_b32_peak_gib"] = peak
        profile_step(lambda: (run(), torch.cuda.synchronize()), B_FAMILY)
        del model

    for arm in ("exact", "hybrid"):
        model = witness_model("msn", dev, dial=ServingDial(mds=arm))

        def run():
            return complete(model, partial32,
                            generator=torch.Generator().manual_seed(0))
        run()
        res, launches, plain = launch_counts(run)
        want = {"exact": {"mds": 1}, "hybrid": {"mds_continue": 1}}[arm]
        check_launches(f"MSN serving forward, {arm} arm, B={B_FAMILY}",
                       launches, plain, want)
        if float(res[2]) != 0.0 or not bool(torch.isfinite(res[1]).all()):
            fail(f"MSN serving ({arm}): loss_mst {float(res[2])} or a "
                 f"non-finite refine")
        ms = cuda_ms(run, reps=3, warmup=0)
        log(f"  MSN serving forward, {arm} arm (mml {MSN_MML_CALIBRATION}), "
            f"B={B_FAMILY}: {ms:.1f} ms, {B_FAMILY / (ms / 1e3):.2f} clouds/s")
        PATHS[f"msn_serving_{arm}_b32_ms"] = ms
        out[f"msn_serving_{arm}"] = launches
        del model
    return out


def family_model(family: str, state: dict, dev):
    """A model of the family holding ``state`` on the card, and a new Adam
    over it."""
    model = define_G(family_config(family), seed=WITNESS_SEED, device="cpu")
    model.load_state_dict(state)
    model = model.to(dev)
    return model, train_base.make_optimizer(model, atlas_runner.CONFIG)


def family_step(family: str, state: dict, partial, gt, dev):
    """One training step of a fresh model holding ``state`` on grids from a
    generator seeded 5: (losses, gradients by name)."""
    model, opt = family_model(family, state, dev)
    loss = FAMILY_STEP[family](model, opt, partial, gt,
                               atlas_runner.CONFIG["learning_rate"],
                               torch.Generator().manual_seed(5))
    torch.cuda.synchronize()
    return ([float(v) for v in loss],
            {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None})


def main_family_train(dev, families=FAMILIES) -> dict:
    """Phase 29 (and 32 with ``families`` ("grnet",)); returns each
    family's step launches."""
    out: dict = {}
    partial, gt = (t.to(dev) for t in train_batch(
        torch.Generator().manual_seed(29), B_FAMILY))
    for family in families:
        release_memory(f"the {family} training step")
        state = snapshot(witness_model(family, "cpu"))
        calls: dict = {}
        assigns: list = []
        auction = emd.auction_assign

        def keep(*a, **k):
            assigns.append(auction(*a, **k))
            return assigns[-1]
        with deterministic():
            with swapped(**recording(calls)), patched(
                    (emd, "auction_assign", keep)):
                kern, launches, plain = launch_counts(
                    lambda: family_step(family, state, partial, gt, dev))
            check_launches(f"{family} training step, B={B_FAMILY}", launches,
                           plain, FAMILY_STEP_LAUNCHES[family])
            out[family] = launches
            fixed = {op: replay(calls[op]) for op in FAMILY_REPLAYED[family]}
            it = iter(assigns)
            with swapped(**dict(PLAIN, **fixed)), patched(
                    (emd, "auction_assign", lambda *a, **k: next(it))):
                p = family_step(family, state, partial, gt, dev)
        loss, rel, zero, worst = step_gaps(kern, p, FAMILY_ZERO_GRAD)
        log(f"  {family}: kernel step vs plain step ("
            + "".join(f"{op} outputs, " for op in FAMILY_REPLAYED[family])
            + f"auction assignments replayed), both deterministic: loss "
            f"{kern[0]} vs "
            f"{p[0]}, loss rel gap {loss:.3e} (limit {STEP_LOSS_RTOL:g}), "
            f"gradient leaf relative-L2 gap {rel:.3e} ({worst}; limit "
            f"{STEP_GRAD_REL:g}), zero-gradient leaves {zero:.3e} (limit "
            f"{STEP_ZERO_ABS:g})")
        if loss > STEP_LOSS_RTOL or rel > STEP_GRAD_REL or zero > STEP_ZERO_ABS:
            fail(f"the {family} kernel step differs from the anchored plain "
                 f"step")
        n_bids = len(calls["emd_bids"])
        held = {"emd_bids": [(0, STEP_HELD_CLOUDS)] + [
            (i, None) for i in range(n_bids - BIDS_LAST_HELD, n_bids)]}
        if family == "msn":
            held.update(expansion=[(0, None)], mds=[(0, STEP_HELD_CLOUDS)])
        if family == "grnet":
            held.update(nn_idx=[(0, None), (1, None)])
        hold_kernels(calls, held, f"{family} training step")
        del calls, assigns

        model, opt = family_model(family, state, dev)
        lr = atlas_runner.CONFIG["learning_rate"]
        gens = [torch.Generator().manual_seed(i) for i in range(4)]

        def run(i):
            FAMILY_STEP[family](model, opt, partial, gt, lr, gens[i])
        run(3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = step_times(run, 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = sorted(times)[1]
        log(f"  {family} training step, B={B_FAMILY} (EMD, Adam): "
            f"{[round(t, 1) for t in times]} ms, median {ms:.1f} ms, "
            f"{B_FAMILY / (ms / 1e3):.2f} clouds/s, peak memory {peak:.2f} "
            f"GiB, on {nvidia_smi()}")
        PATHS[f"{family}_train_b32_ms"] = ms
        PATHS[f"{family}_train_b32_peak_gib"] = peak
        if family == "grnet":
            PATHS["grnet_train_b32_shares"] = profile_ops(
                lambda: (run(0), torch.cuda.synchronize()), B_FAMILY,
                "GRNet training step")
        else:
            profile_step(lambda: (run(0), torch.cuda.synchronize()), B_FAMILY)
        del model, opt
    return out


def main_family_cli(dev, families=FAMILIES) -> dict:
    """Phase 30 (and 33 with ``families`` ("grnet",)); returns a validation
    batch's launches of each family's evaluation CLI (and MSN's with
    --serving)."""
    out: dict = {}
    work = tempfile.mkdtemp(prefix="family_cli_")
    try:
        for family in families:
            release_memory(f"the {family} CLIs")
            path = run_yaml(f"{family}.yaml", work, FAMILY_CLI_RUN)
            args = ["--model", family, "--config", path, "--dataset",
                    "Synthetic"]
            first = train_cli.build(args + ["--workdir",
                                            os.path.join(work, family, "a"),
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
            check_cli_line(line, launches, plain,
                           tuple(FAMILY_STEP_LAUNCHES[family]) + ("nn_idx",),
                           f"{family} training CLI")
            step = {k: v for k, v in per_step(epochs, steps).items() if v}
            if step != FAMILY_STEP_LAUNCHES[family]:
                fail(f"{family} training CLI: a step's launches {step}, "
                     f"expected {FAMILY_STEP_LAUNCHES[family]}")
            sec = line["seconds"]
            log(f"  {family} training epoch on {nvidia_smi()}: "
                f"{line['clouds_trained']} clouds in {steps} steps of "
                f"{B_FAMILY}, {line['clouds_per_s']:.2f} clouds/s over data "
                f"and step time; seconds: data {sec['data']:.3f}, step "
                f"{sec['step']:.3f}, val {sec['val']:.3f} (32 clouds at B=16, "
                f"metrics and the checkpoint included); peak memory "
                f"{peak:.2f} GiB; a step's launches {step}")
            PATHS[f"{family}_train_cli"] = dict(
                clouds_per_s=line["clouds_per_s"], peak_gib=peak,
                **{f"{k}_s": v for k, v in sec.items()})
            names = checkpoints(first)
            if len(names) != 1:
                fail(f"{family} training CLI: {len(names)} checkpoints")
                continue
            ckpt = os.path.join(first.config.DIR.checkpoints, names[0])
            second = train_cli.build(args + [
                "--workdir", os.path.join(work, family, "b"), "--epochs", "2",
                "--weights", ckpt])
            n = same_state(f"{family} resumed generator",
                           second.model.state_dict(), first.model.state_dict())
            n += same_state(f"{family} resumed Adam",
                            adam_state(second.optimizer),
                            adam_state(first.optimizer))
            n += same_state(f"{family} resumed step generator",
                            {"rng": second.step_generator.get_state()},
                            {"rng": first.step_generator.get_state()})
            log(f"  {family}: the resumed runner holds the epoch-1 run's "
                f"generator, Adam and step generator ({first.RNG_KEY}) bit "
                f"for bit ({n} tensors), init_epoch {second.init_epoch}")
            if second.init_epoch != 1:
                fail(f"{family}: resumed at epoch {second.init_epoch}")
            best = line["best_metrics"]
            del first, second
            release_memory(f"the {family} evaluation CLI")

            modes = [("parity", [])] + ([("serving", ["--serving"])]
                                        if family == "msn" else [])
            for mode, extra in modes:
                _lib.reset_counts()
                runner = test_cli.build(args + extra + [
                    "--weights", ckpt, "--workdir",
                    os.path.join(work, family, mode)])
                torch.cuda.synchronize()
                load = {k: v for k, v in _lib.LAUNCHES.items() if v}
                _lib.reset_counts()
                tline = test_cli.run(runner)
                launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
                plain = {k: v for k, v in _lib.PLAIN_CALLS.items() if v}
                batches = tline["batches"]
                batch = {k: v / batches for k, v in launches.items()}
                sec = tline["seconds"]
                log(f"  {family} evaluation CLI ({mode}) on the checkpoint: "
                    f"F {tline['F-Score']:.4f}, CD x 1000 "
                    f"{tline['ChamferDistance']:.4f}, EMD x 100 "
                    f"{tline['EMD']:.4f}; {tline['n_clouds']} clouds, "
                    f"{tline['clouds_per_s']:.2f} clouds/s (data "
                    f"{sec['data']:.3f} s, forward {sec['forward']:.3f} s, "
                    f"metrics {sec['metrics']:.3f} s); the load's launches "
                    f"{load}; a batch's launches {batch}, plain calls {plain}"
                    + (f"; mml {tline['mml_calibration']:.4f} fitted "
                       f"{tline['mml_fitted']}" if family == "msn" else ""))
                PATHS[f"{family}_eval_cli_{mode}"] = dict(
                    clouds_per_s=tline["clouds_per_s"],
                    **{f"{k}_s": v for k, v in sec.items()})
                out[f"{family}_{mode}"] = batch
                want_batch = dict(FAMILY_EVAL_BATCH[family])
                if mode == "serving":
                    del want_batch["expansion"]
                if plain or batch != want_batch:
                    fail(f"{family} evaluation CLI ({mode}): a batch's "
                         f"launches {batch} (expected {want_batch}), plain "
                         f"{plain}")
                if mode == "serving":
                    if load != {"expansion": 1} or not tline["mml_fitted"]:
                        fail(f"MSN --serving: the load launched {load}, "
                             f"fitted {tline['mml_fitted']}")
                    if not BAND[0] <= tline["mml_calibration"] <= BAND[1]:
                        fail(f"MSN --serving: the fit "
                             f"{tline['mml_calibration']} lies outside {BAND}")
                else:
                    limit = FAMILY_RUN_TO_RUN.get(family, 1e-5)
                    gaps = {k: abs(tline[k] / v - 1) if v else abs(tline[k])
                            for k, v in best.items()}
                    log(f"  against the training run's validation of the "
                        f"same weights: relative gaps {gaps} (limit {limit:g})")
                    if max(gaps.values()) > limit:
                        fail(f"{family} evaluation CLI reads other metrics "
                             f"than the training run's validation: {gaps}")
                del runner
            if family in FAMILY_RUN_TO_RUN:
                with deterministic():
                    det = [test_cli.run(test_cli.build(args + [
                        "--weights", ckpt, "--workdir",
                        os.path.join(work, family, f"det{i}")]))
                        for i in range(2)]
                same = all(det[0][k] == det[1][k] for k in Metrics.names())
                log(f"  {family} evaluation CLI twice in deterministic mode: "
                    f"metrics equal {same} ({[det[0][k] for k in Metrics.names()]}"
                    f"; {det[0]['clouds_per_s']:.2f} clouds/s)")
                if not same:
                    fail(f"{family}: two deterministic evaluations differ")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# GRNet (phases 31-33)
# ---------------------------------------------------------------------------

# scripts/port_jax_grnet_witness.py: the JAX package's GRNet eval forward at
# full width on the CPU, from the weights ``witness_model("grnet", ...)``
# builds, its sample drawn from PRNGKey(GRNET_SAMPLE_KEY)
GRNET_WITNESS = os.path.join(ROOT, "docs", "artifacts", "port",
                             "jax_grnet_witness.npz")
GRNET_SAMPLE_KEY = 31
# gridding reverse points (voxels whose 8 weights sum to 1e-6 or more) may
# part between the card and the witness where a sum lies within rounding of
# that threshold: a voxel's weights are ReLU outputs of up to 2 whose
# rounding is about 1e-7, and some 46,000 voxels a sample weigh between
# 1e-6 and 1e-5 (the witness's inputs); a sample's count parted by 1 in the
# CPU and H100 runs made for this slice
GRNET_VALID_SLACK = 8
# GRNet's ops (XLA in the JAX package, stock PyTorch in the port) as its
# module calls them, and the functions themselves
GRNET_OPS = {"gridding": gridding_op.gridding,
             "gridding_reverse": gridding_op.gridding_reverse,
             "cubic_feature_sampling": cubic_op.cubic_feature_sampling}


def grnet_op_calls(calls: dict):
    """``patched`` targets: GRNet's ops in its module, each call's (args,
    output) cloned into calls[name]."""
    def wrap(name, fn):
        def rec(*args):
            out = fn(*args)
            calls.setdefault(name, []).append((_clone(args), _clone(out)))
            return out
        return rec
    return [(grnet_model, n, wrap(n, fn)) for n, fn in GRNET_OPS.items()]


def hold_grnet_ops(calls: dict) -> None:
    """Each recorded op call on the card against the same function on the
    CPU on the same inputs: the gridding scatter (the card's atomics add in
    another order) and the reverse within the contract, the cubic gathers
    bit for bit."""
    for name, fn in GRNET_OPS.items():
        for i, (args, out) in enumerate(calls.get(name, [])):
            cpu = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                       for a in args))
            got = out.cpu()
            err = float((got - cpu).abs().max())
            ok = (torch.equal(got, cpu) if name == "cubic_feature_sampling"
                  else bool(torch.allclose(got, cpu, atol=CONTRACT_ATOL,
                                           rtol=CONTRACT_RTOL)))
            log(f"  {name} call {i}, {list(args[0].shape)} -> "
                f"{list(out.shape)}: card against CPU max abs err {err:.3e} "
                + ("(bit for bit)" if name == "cubic_feature_sampling"
                   else f"(atol {CONTRACT_ATOL:g}, rtol {CONTRACT_RTOL:g})")
                + ("" if ok else ": FAILS"))
            if not ok:
                fail(f"GRNet's {name} on the card differs from the CPU's")


def grnet_cell_splits(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[B, n] bool: where sparse points a and b fall in different cells of
    one of the cubic features' volumes (32^3, 16^3, 8^3: floor(p s/2 +
    s/2)); there the features, and the 8 dense points, may part."""
    return np.any([np.any(np.floor(a * h + h) != np.floor(b * h + h), -1)
                   for h in (16.0, 8.0, 4.0)], 0)


def grnet_op_group(key: str) -> str:
    """The group of an op (torch.profiler's key) of a GRNet step."""
    if "convolution" in key:
        return "conv3d (cuDNN)"
    if "max_pool3d" in key or key == "aten::scatter_":
        return "max-pool and its backward"
    if key in ("aten::_index_put_impl_", "aten::index_put_", "aten::index"):
        return "gridding scatter and its backward"
    if key in ("aten::index_select", "aten::index_add_"):
        return "cubic and sample gathers"
    if "sort" in key:
        return "sample sort"
    if key in ("aten::addmm", "aten::mm", "aten::bmm"):
        return "fc (cuBLAS)"
    if "foreach" in key or "adam" in key.lower():
        return "Adam"
    return "other (BatchNorm, gridding reverse, losses, elementwise)"


def profile_ops(run, b: int, what: str) -> dict:
    """One profiled ``run()`` (synchronised): device ms by op group (each
    op's own kernels), the port's kernels by name, the forward's time in
    each of GRNet's ops (``GRNET_OPS``, a profiler range around each call),
    the busy share of the wall time; returns the shares of busy by
    group."""
    def body():
        t = time.perf_counter()
        run()
        return (time.perf_counter() - t) * 1e3

    def ranged(name, fn):
        def call(*args):
            with torch.profiler.record_function(name):
                return fn(*args)
        return call
    with patched(*((grnet_model, n, ranged(n, fn))
                   for n, fn in GRNET_OPS.items())):
        prof, wall_ms = profiled(body, cpu=True)
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    ranges = {e.key: e.device_time_total / 1e3 for e in avgs
              if e.key in GRNET_OPS}
    busy = sum(e.self_device_time_total for e in avgs
               if e.device_type == DeviceType.CUDA) / 1e3
    if not busy:
        fail(f"the profiler saw no device time in the {what}")
        return {}
    groups: dict = {}
    for e in avgs:
        if e.device_type == DeviceType.CPU and e.self_device_time_total > 0:
            g = grnet_op_group(e.key)
            groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    for g, pats in (("nn_idx (#6)", ("nn_split_kernel", "nn_merge_kernel")),
                    ("emd_bids (#8)", ("bids_kernel", "bids_merge_kernel"))):
        ms = sum(e.self_device_time_total for e in avgs
                 if e.device_type == DeviceType.CUDA
                 and any(p in e.key for p in pats)) / 1e3
        if ms:
            groups[g] = ms
    rest = busy - sum(groups.values())
    if rest > 1e-3:
        groups["outside any op"] = rest
    log(f"  profile, {what}, B={b}: wall {wall_ms:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {g:48s} {ms:9.2f} ms  {100 * ms / busy:5.1f}% of busy")
    log("    forward, within each op's calls: " + ", ".join(
        f"{n} {ms:.2f} ms" for n, ms in ranges.items()))
    return {g: ms / busy for g, ms in groups.items()}


@torch.no_grad()
def main_grnet_eval(dev) -> dict:
    """Phase 31; returns a forward's launches."""
    release_memory("the GRNet forwards")
    if not os.path.exists(GRNET_WITNESS):
        fail(f"{GRNET_WITNESS} is missing (scripts/port_jax_grnet_witness.py)")
        return {}
    w = np.load(GRNET_WITNESS)
    model = witness_model("grnet", dev)
    want_sums = json.loads(str(w["checksums"]))
    sums = weight_checksums(model)
    bad = [k for k in want_sums if sums.get(k) != want_sums[k]]
    if bad or sums.keys() != want_sums.keys():
        fail(f"grnet: {len(bad)} of {len(want_sums)} weight tensors differ "
             f"from the witness's (e.g. {bad[:3]}): this torch "
             f"({torch.__version__}) draws other numbers from seed "
             f"{WITNESS_SEED}, so the witness does not apply")
        return {}
    n_par = sum(p.numel() for p in model.parameters())
    log(f"  GRNet: {n_par} parameters; its {len(sums)} weight tensors equal "
        f"the witness's by sha256")
    partial = torch.from_numpy(witness_inputs()[0]).to(dev)
    picks = torch.from_numpy(w["idx"]).to(dev)
    calls: dict = {}
    with patched(*grnet_op_calls(calls)):
        (sparse, dense), launches, plain = launch_counts(
            lambda: complete(model, partial, sample_idx=picks))
    check_launches(f"GRNet forward, B={WITNESS_B}, on the witness's picks",
                   launches, plain, {})
    hold("GRNet's sparse cloud on the witness's picks", sparse, w["sparse"])
    _, volumes = model.candidates(partial)
    hold("GRNet's dense cloud decoded from the witness's sparse cloud",
         model.decode(torch.from_numpy(w["sparse"]).to(dev), volumes),
         w["dense"])
    split = grnet_cell_splits(sparse.cpu().numpy(), w["sparse"])
    off = ~np.isclose(dense.cpu().numpy(), w["dense"], atol=CONTRACT_ATOL,
                      rtol=CONTRACT_RTOL).reshape(*split.shape, -1).any(-1)
    log(f"  dense cloud on the witness's picks: {int(off.sum())} of "
        f"{off.size} sparse points' 8 dense points outside the contract, all "
        f"among the {int(split.sum())} whose cubic-feature cell differs from "
        f"the witness's (the point within rounding of a cell face)")
    if (off & ~split).any():
        fail("GRNet's dense cloud differs from the witness's at a point whose "
             "cubic-feature cells equal the witness's")
    cloud = calls["gridding_reverse"][0][1]
    n_valid = (cloud.sum(-1) != 0).sum(1).cpu().numpy()
    gap = np.abs(n_valid - w["n_valid"]).max()
    log(f"  gridding reverse points a sample (of {cloud.shape[1]} voxels): "
        f"{n_valid.tolist()}, the witness's {w['n_valid'].tolist()} (limit "
        f"{GRNET_VALID_SLACK} apart)")
    if gap > GRNET_VALID_SLACK:
        fail(f"GRNet's gridding reverse keeps {n_valid.tolist()} points, the "
             f"witness {w['n_valid'].tolist()}")
    hold_grnet_ops(calls)
    _, free = complete(model, partial,
                       generator=torch.Generator().manual_seed(0))
    log(f"  free-running (its own sample, generator seeded 0): dense against "
        f"the anchored dense, Chamfer {chamfer(free, dense):.3e} (a reading: "
        f"another random sample of the same cloud)")

    gen = torch.Generator().manual_seed(31)
    partial32, gt32 = (t.to(dev) for t in train_batch(gen, B_FAMILY))

    def run():
        return complete(model, partial32,
                        generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(run, reps=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  GRNet forward, B={B_FAMILY}, parity (the sample's noise drawn on "
        f"the host a forward): {ms:.1f} ms, {B_FAMILY / (ms / 1e3):.2f} "
        f"clouds/s, peak memory {peak:.2f} GiB, on {nvidia_smi()}")
    PATHS.update(grnet_b32_ms=ms, grnet_b32_peak_gib=peak)
    PATHS["grnet_b32_shares"] = profile_ops(
        lambda: (run(), torch.cuda.synchronize()), B_FAMILY, "GRNet forward")
    sparse32 = run()[0]
    for x1, x2, what in ((sparse32, gt32, "sparse -> gt"),
                         (gt32, sparse32, "gt -> sparse")):
        got = KERNEL["nn_idx"](x1, x2)
        t0 = time.perf_counter()
        want = PLAIN["nn_idx"](x1, x2)
        torch.cuda.synchronize()
        pms = (time.perf_counter() - t0) * 1e3
        kms = cuda_ms(lambda: KERNEL["nn_idx"](x1, x2), reps=3)
        exact = torch.equal(got, want)
        log(f"  nn_idx (#6) on the sparse loss's shapes, {what} "
            f"{list(x1.shape)} -> {list(x2.shape)}: bit for bit {exact}; "
            f"kernel {kms:.3f} ms, plain {pms:.1f} ms; "
            f"{chamfer_op.nn_splits(*x1.shape[:2], x2.shape[1])} candidate "
            f"splits")
        PATHS[f"grnet_nn_{what.split()[0]}_ms"] = kms
        if not exact:
            fail(f"nn_idx on GRNet's {what} shapes differs from plain")
    del model
    return launches


# ---------------------------------------------------------------------------
# phases 34-35: the file datasets and the evaluation CLI's test modes
# ---------------------------------------------------------------------------

# trees in the published layouts, written here: ShapeNet (GRnet layout: 8
# partial renderings of 2048 points and a 16384-point complete cloud a
# model; 2 categories of 24 training models, two steps at B=24, and 16 test
# models, 32 clouds at B=16), Completion3D (.h5 of 2048 points, 16 VAL models
# a category, evaluated at its 2048 output points) and KITTI (car scans with
# their box corners)
FILE_CATS = (("02691156", "airplane"), ("02958343", "car"))
N_PARTIAL, N_RENDERINGS, N_C3D = 2048, 8, 2048
FILE_TRAIN, FILE_TEST, C3D_VAL, KITTI_FRAMES = B_TRAIN, 16, 16, 4
# a rendered batch: 8 views x (partial, output, ground truth) at radius 7
RENDERED_P2I = 24


def _scan(cloud: np.ndarray, n: int, rs) -> np.ndarray:
    """n points of the half of ``cloud`` seen from a random direction."""
    d = rs.randn(3)
    side = cloud @ (d / np.linalg.norm(d))
    seen = cloud[side > np.median(side)]
    return seen[rs.choice(len(seen), n, replace=len(seen) < n)]


def _write_ascii_pcd(path: str, pts: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
                "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
                f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
                f"POINTS {len(pts)}\nDATA ascii\n")
        np.savetxt(f, pts.astype(np.float32), fmt="%.9g")


def write_file_trees(root: str) -> dict:
    """The three trees under ``root``; the config overrides that point the
    DATASETS at them, and the ShapeNet .pcd files written (for the codec
    reading)."""
    rs = np.random.RandomState(34)
    sn, c3, kt = (os.path.join(root, d) for d in ("ShapeNet", "c3d", "kitti"))
    pcds, cats = [], []
    for c, (tax, name) in enumerate(FILE_CATS):
        train = [f"{name}{i:03d}" for i in range(FILE_TRAIN)]
        test = [f"{name}{i:03d}" for i in range(FILE_TRAIN, FILE_TRAIN + FILE_TEST)]
        cats.append({"taxonomy_id": tax, "taxonomy_name": name,
                     "train": train, "val": test, "test": test})
        for subset, models, views in (("train", train, N_RENDERINGS),
                                      ("test", test, 1)):
            for k, m in enumerate(models):
                whole = _surface_points(
                    _SYNTH_SHAPES[(3 * c + k) % len(_SYNTH_SHAPES)], N_OUT, rs)
                d = os.path.join(sn, subset, "complete", tax)
                os.makedirs(d, exist_ok=True)
                pcds.append(os.path.join(d, f"{m}.pcd"))
                IO.put(pcds[-1], whole)
                d = os.path.join(sn, subset, "partial", tax, m)
                os.makedirs(d, exist_ok=True)
                for i in range(views):
                    pcds.append(os.path.join(d, f"{i:02d}.pcd"))
                    IO.put(pcds[-1], _scan(whole, N_PARTIAL, rs))
    _write_ascii_pcd(pcds[1], IO.get(pcds[1]))      # one partial in ASCII
    with open(os.path.join(sn, "ShapeNet.json"), "w") as f:
        json.dump(cats, f)

    cats = [{"taxonomy_id": "all", "taxonomy_name": "all", "train": [],
             "val": [], "test": ["all000", "all001"]}]
    for c, (tax, name) in enumerate(FILE_CATS):
        models = [f"{name}{i:03d}" for i in range(C3D_VAL)]
        cats.append({"taxonomy_id": tax, "taxonomy_name": name, "train": [],
                     "val": models, "test": []})
    for dc in cats:
        for subset in ("val", "test"):
            for m in dc[subset]:
                whole = _surface_points(_SYNTH_SHAPES[rs.randint(8)], N_OUT, rs)
                for kind, cloud in (("partial", _scan(whole, N_C3D, rs)),
                                    ("gt", whole[rs.choice(N_OUT, N_C3D,
                                                           replace=False)])):
                    if subset == "test" and kind == "gt":
                        continue
                    d = os.path.join(c3, subset, kind, dc["taxonomy_id"])
                    os.makedirs(d, exist_ok=True)
                    IO.put(os.path.join(d, f"{m}.h5"), cloud)
    with open(os.path.join(c3, "Completion3D.json"), "w") as f:
        json.dump(cats, f)

    frames = [f"frame{i:04d}" for i in range(KITTI_FRAMES)]
    for d in ("cars", "bboxes"):
        os.makedirs(os.path.join(kt, d), exist_ok=True)
    size = np.array([3.9, 1.6, 1.5])
    # corners 0 and 3 along the car's length, as NormalizeObjectPose reads
    unit = np.array([[-1, -1, -1], [-1, 1, -1], [1, 1, -1], [1, -1, -1],
                     [-1, -1, 1], [-1, 1, 1], [1, 1, 1], [1, -1, 1]]) * 0.5
    for f_ in frames:
        yaw = rs.uniform(-np.pi, np.pi)
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
        centre = rs.uniform([-20, -20, -1], [20, 20, 1])
        car = _scan(_surface_points("box", 8192, rs) * size,
                    int(rs.randint(300, 3000)), rs)
        IO.put(os.path.join(kt, "cars", f"{f_}.pcd"),
               (car @ rot.T + centre).astype(np.float32))
        np.savetxt(os.path.join(kt, "bboxes", f"{f_}.txt"),
                   (unit * size) @ rot.T + centre)
    with open(os.path.join(kt, "KITTI.json"), "w") as f:
        json.dump([{"taxonomy_id": "02958343", "taxonomy_name": "car",
                    "train": [], "val": [], "test": frames}], f)
    overrides = {"TRAIN": {"save_freq": 1}, "TEST": {"batch_size": 16},
                 "DATASETS": {
        "shapenet": {"category_file_path": os.path.join(sn, "ShapeNet.json"),
                     "n_renderings": N_RENDERINGS,
                     "partial_points_path": os.path.join(
                         sn, "%s/partial/%s/%s/%02d.pcd"),
                     "complete_points_path": os.path.join(
                         sn, "%s/complete/%s/%s.pcd")},
        "completion3d": {"category_file_path": os.path.join(
                             c3, "Completion3D.json"),
                         "partial_points_path": os.path.join(
                             c3, "%s/partial/%s/%s.h5"),
                         "complete_points_path": os.path.join(
                             c3, "%s/gt/%s/%s.h5")},
        "kitti": {"category_file_path": os.path.join(kt, "KITTI.json"),
                  "partial_points_path": os.path.join(kt, "cars", "%s.pcd"),
                  "bounding_box_file_path": os.path.join(kt, "bboxes",
                                                         "%s.txt")}}}
    return {"overrides": overrides, "pcds": pcds}


def file_yaml(work: str, tag: str, overrides: dict) -> str:
    """sparenet.yaml with ``overrides``, written under work/tag."""
    os.makedirs(os.path.join(work, tag), exist_ok=True)
    return run_yaml("sparenet.yaml", os.path.join(work, tag), overrides)


def codec_reading(pcds: list) -> None:
    """MB/s of the C++ PCD reader and of the Python codec over the same
    files on the card's host (page cache warm: the files were just
    written), their clouds equal."""
    nbytes = sum(os.path.getsize(p) for p in pcds)
    times, clouds = {}, {}
    for name, fn in (("native", read_pcd_native), ("python", read_pcd)):
        t0 = time.perf_counter()
        clouds[name] = [fn(p) for p in pcds]
        times[name] = time.perf_counter() - t0
    same = all(np.array_equal(a, b.astype(np.float32))
               for a, b in zip(clouds["native"], clouds["python"]))
    rates = {k: nbytes / 1e6 / v for k, v in times.items()}
    log(f"  PCD codecs over {len(pcds)} files, {nbytes / 1e6:.2f} MB (one "
        f"ASCII, warm page cache) on the card's host: C++ reader "
        f"{rates['native']:.1f} MB/s ({times['native']:.3f} s), Python codec "
        f"{rates['python']:.1f} MB/s ({times['python']:.3f} s); clouds equal "
        f"{same}")
    if not same:
        fail("the C++ PCD reader and the Python codec read other clouds")
    PATHS["pcd_codecs"] = dict(files=len(pcds), mb=nbytes / 1e6,
                               **{f"{k}_mb_per_s": v for k, v in rates.items()})


def eval_file_cli(args: list, what: str, expect_clouds: int):
    """The evaluation CLI in process on ``args``, counts set to 0 just
    before its run; (runner, last line, a batch's launches)."""
    _lib.reset_counts()
    runner = test_cli.build(args)
    _lib.reset_counts()
    line = test_cli.run(runner)
    torch.cuda.synchronize()
    plain = {k: v for k, v in _lib.PLAIN_CALLS.items() if v}
    batch = {k: v / line["batches"] for k, v in _lib.LAUNCHES.items() if v}
    sec = line["seconds"]
    share = sec["data"] / sec["total"] if sec["total"] else 0.0
    metrics = ("no metrics (no ground truth)" if line["F-Score"] is None else
               f"F {line['F-Score']:.4f}, CD x 1000 "
               f"{line['ChamferDistance']:.4f}, EMD x 100 {line['EMD']:.4f}")
    log(f"  {what}: {metrics}; {line['n_clouds']} clouds in "
        f"{line['batches']} batches, {line['clouds_per_s']:.2f} clouds/s "
        f"(data {sec['data']:.3f} s, {100 * share:.1f}% of the epoch; "
        f"forward {sec['forward']:.3f} s, metrics {sec['metrics']:.3f} s); a "
        f"batch's launches {batch}, plain calls {plain}")
    if plain:
        fail(f"{what}: plain calls {plain}")
    if line["n_clouds"] != expect_clouds:
        fail(f"{what}: {line['n_clouds']} clouds, expected {expect_clouds}")
    for name, want in (("knn", 4), ("gather_max", 4), ("expansion", 2),
                       ("mds", 2)):
        if batch.get(name) != want:
            fail(f"{what}: {name} {batch.get(name)} launches a batch, "
                 f"expected {want}")
    return runner, line, dict(batch, data_share=share)


def main_file_data(step_launches: dict, dev) -> dict:
    """Phase 34; returns the trees' overrides, the checkpoint and the work
    directory (phase 35 reads them) and the launches of a ShapeNet step and
    eval batch."""
    release_memory("the file datasets")
    work = tempfile.mkdtemp(prefix="file_data_")
    try:
        return _file_data(work, step_launches)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


def _file_data(work: str, step_launches: dict) -> dict:
    t0 = time.perf_counter()
    trees = write_file_trees(os.path.join(work, "trees"))
    log(f"  trees written in {time.perf_counter() - t0:.1f} s: ShapeNet "
        f"({2 * (FILE_TRAIN + FILE_TEST)} models, {len(trees['pcds'])} .pcd), "
        f"Completion3D ({2 * C3D_VAL} VAL models, .h5), KITTI "
        f"({KITTI_FRAMES} frames)")
    codec_reading(trees["pcds"])
    path = file_yaml(work, "shapenet", trees["overrides"])
    first = train_cli.build(["--config", path, "--workdir",
                             os.path.join(work, "train"), "--epochs", "1"])
    epochs: list = []
    with training_launches(epochs):
        line = train_cli.run(first)
        torch.cuda.synchronize()
        launches, plain = dict(_lib.LAUNCHES), dict(_lib.PLAIN_CALLS)
    steps = len(first.train_loader)
    check_cli_line(line, launches, plain, TRAIN_EXPECTED + ("gather_max",),
                   "training CLI on ShapeNet files")
    step = per_step(epochs, steps)
    for name in ("knn", "expansion", "mds", "nn_idx", "edge_stats_fwd",
                 "edge_stats_bwd"):
        if step[name] != step_launches[name]:
            fail(f"ShapeNet training: {name} {step[name]} launches a step, "
                 f"phase 8's step {step_launches[name]}")
    sec = line["seconds"]
    log(f"  training epoch on ShapeNet files on {nvidia_smi()}: "
        f"{line['clouds_trained']} clouds in {steps} steps of {B_TRAIN}, "
        f"{line['clouds_per_s']:.2f} clouds/s over data and step time; "
        f"seconds: data {sec['data']:.3f}, step {sec['step']:.3f}, val "
        f"{sec['val']:.3f}; a step's launches "
        f"{ {k: v for k, v in step.items() if v} }")
    PATHS["shapenet_train_cli"] = dict(
        clouds_per_s=line["clouds_per_s"], steps=steps,
        **{f"{k}_s": v for k, v in sec.items()})
    names = checkpoints(first)
    if len(names) != 1:
        fail(f"ShapeNet training: {len(names)} checkpoints after one epoch")
        raise RuntimeError("no checkpoint to evaluate")
    ckpt = os.path.join(first.config.DIR.checkpoints, names[0])
    best = line["best_metrics"]
    del first
    release_memory("the evaluation CLI on ShapeNet files")

    _, tline, batch = eval_file_cli(
        ["--config", path, "--weights", ckpt, "--workdir",
         os.path.join(work, "eval")], "evaluation CLI on ShapeNet TEST",
        2 * FILE_TEST)
    gaps = {k: abs(tline[k] / v - 1) if v else abs(tline[k])
            for k, v in best.items()}
    log(f"  against the training run's validation of the same weights: "
        f"relative gaps {gaps} (limit 1e-05)")
    if max(gaps.values()) > 1e-5:
        fail(f"ShapeNet evaluation CLI reads other metrics than the training "
             f"run's validation: {gaps}")
    for name in EVAL_OPS_ALL:
        if not batch.get(name):
            fail(f"ShapeNet evaluation: {name} was not launched")
    PATHS["shapenet_eval_cli"] = dict(
        clouds_per_s=tline["clouds_per_s"], data_share=batch["data_share"],
        **{f"{k}_s": v for k, v in tline["seconds"].items()})
    release_memory("the evaluation CLI on Completion3D")

    c3d = file_yaml(work, "c3d", dict(trees["overrides"],
                                      DATASET={"n_outpoints": N_C3D}))
    _, cline, _ = eval_file_cli(
        ["--config", c3d, "--weights", ckpt, "--dataset", "Completion3D",
         "--workdir", os.path.join(work, "c3d")],
        f"evaluation CLI on Completion3D VAL ({N_C3D} output points)",
        2 * C3D_VAL)
    if not all(math.isfinite(cline[k]) for k in Metrics.names()):
        fail(f"Completion3D evaluation: metrics not finite {cline}")
    PATHS["c3d_eval_cli"] = dict(clouds_per_s=cline["clouds_per_s"])
    return dict(trees=trees, path=path, ckpt=ckpt, work=work,
                shapenet_step={k: v for k, v in step.items() if v},
                shapenet_eval_batch={k: v for k, v in batch.items()
                                     if k in _lib.LAUNCHES})


def main_test_modes(files: dict, dev) -> dict:
    """Phase 35; returns the launches of a rendered batch's side outputs
    and of a KITTI cloud."""
    work, ckpt, path = files["work"], files["ckpt"], files["path"]
    out: dict = {}
    try:
        release_memory("the render mode")
        kept: dict = {}
        rendered: list = []
        inference = train_base.BaseRunner.inference

        def keeping(self, data):
            if self.model_idx == 0:
                kept.update(refine=self.ptcloud.clone(), tax=self.taxonomy_id,
                            data={k: torch.from_numpy(v).to(dev)
                                  for k, v in data.items()})
            before = dict(_lib.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inference(self, data)
            torch.cuda.synchronize()
            if self.model_idx % self.config.TEST.infer_freq == 0:
                rendered.append(({k: v - before[k] for k, v in
                                  _lib.LAUNCHES.items() if v - before[k]},
                                 time.perf_counter() - t0))
        with patched((train_base.BaseRunner, "inference", keeping)):
            runner, line, _ = eval_file_cli(
                ["--config", path, "--weights", ckpt, "--workdir",
                 os.path.join(work, "render"), "--test_mode", "render"],
                "--test_mode render on ShapeNet TEST", 2 * FILE_TEST)
        log(f"  rendered batches (TEST.infer_freq {runner.config.TEST.infer_freq}"
            f"): {[(l, round(s, 4)) for l, s in rendered]} (launches, seconds "
            f"of the 24 maps and their PNGs)")
        if not rendered or any(l != {"p2i": RENDERED_P2I} for l, _ in rendered):
            fail(f"render mode: a rendered batch launched {rendered}, "
                 f"expected p2i {RENDERED_P2I}")
        cfg = runner.config
        base = os.path.join(cfg.DIR.logs, "plots", str(kept["tax"]), "0")
        renderer = ComputeDepthMaps(projection=cfg.RENDER.projection,
                                    eyepos_scale=cfg.RENDER.eyepos,
                                    image_size=cfg.RENDER.img_size)
        clouds = {"1": kept["data"]["partial_cloud"], "2": kept["refine"],
                  "3": kept["data"]["gtcloud"]}
        bad = []
        with torch.no_grad(), swapped(p2i=PLAIN["p2i"]):
            for j in range(renderer.num_views):
                for tag, cloud in clouds.items():
                    img = renderer(cloud, view_id=j,
                                   radius_list=[uv.DEPTH_RADIUS])[0, :, :, 0]
                    got = uv.read_png(os.path.join(base, f"{j}{tag}.png"))
                    if not np.array_equal(got, uv.gray_rgba(img.cpu().numpy())):
                        bad.append(f"{j}{tag}")
        log(f"  the 24 PNGs of batch 0 decoded against depth maps of its "
            f"clouds by the plain p2i on the card: {24 - len(bad)} equal "
            f"pixel for pixel{', differing: ' + str(bad) if bad else ''}")
        if bad:
            fail(f"render mode: PNGs {bad} differ from the plain p2i's maps")
        PATHS["rendered_batch_s"] = rendered[0][1] if rendered else None
        out["rendered_batch"] = rendered[0][0] if rendered else {}
        del runner, kept
        release_memory("the kitti mode")

        kitti = file_yaml(work, "kitti", dict(
            files["trees"]["overrides"], TEST={"batch_size": 1,
                                               "infer_freq": 1}))
        runner, line, batch = eval_file_cli(
            ["--config", kitti, "--weights", ckpt, "--workdir",
             os.path.join(work, "kitti"), "--test_mode", "kitti"],
            "--test_mode kitti (B=1)", KITTI_FRAMES)
        if any(line[k] is not None for k in Metrics.names()):
            fail(f"kitti mode: metrics {line} where there is no ground truth")
        worst, n = 0.0, 0
        with torch.no_grad():
            for b, (tax, _, _, data) in enumerate(data_init(runner.config)[1]):
                want = complete(runner.model, torch.from_numpy(
                    data["partial_cloud"]).to(dev))[2][0].cpu().numpy()
                got = h5.read(os.path.join(runner.config.DIR.out_path,
                                           "benchmark", tax[0], f"{b}.h5"))
                n += 1
                if got.shape != want.shape or not np.array_equal(got, want):
                    worst = max(worst, float(np.abs(got - want).max())
                                if got.shape == want.shape else math.inf)
        log(f"  kitti outputs: {n} .h5 clouds read back through data/h5.py "
            f"against a direct eval forward on the same pose-normalised "
            f"partials: {'equal bit for bit' if not worst else f'max abs {worst:.3g}'}"
            f"; {line['seconds']['forward'] / KITTI_FRAMES * 1e3:.1f} ms of "
            f"forward a cloud at B=1")
        if n != KITTI_FRAMES or worst:
            fail(f"kitti mode: {n} outputs, max abs {worst} from the direct "
                 f"forward")
        out["kitti_cloud"] = {k: v for k, v in batch.items()
                              if k in _lib.LAUNCHES}
        PATHS["kitti_cloud_ms"] = line["seconds"]["total"] / KITTI_FRAMES * 1e3
        del runner
        release_memory("the vis mode")

        vis_dir = os.path.join(work, "vis")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "sparenet_tpu_torch.test", "--config", path,
             "--weights", ckpt, "--workdir", vis_dir, "--test_mode", "vis"],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        tail = (proc.stderr.strip().splitlines() or [""])[-1]
        try:
            import matplotlib  # noqa: F401
            have = True
        except ImportError:
            have = False
        plots = [os.path.join(d, f) for d, _, fs in os.walk(vis_dir)
                 for f in fs if f.endswith(".png")]
        log(f"  --test_mode vis ({'with' if have else 'without'} matplotlib): "
            f"exit {proc.returncode} in {time.perf_counter() - t0:.1f} s, "
            f"{len(plots)} plots; last line of stderr: {tail[:200]}")
        if have and (proc.returncode or not plots):
            fail("vis mode with matplotlib wrote no plot")
        if not have and (proc.returncode == 0 or "matplotlib" not in tail
                         or os.path.exists(vis_dir)):
            fail("vis mode without matplotlib did not stop before building, "
                 "with a message that names it")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# FPD, SpareNet's other arms, EdgeRes and SIREN (phases 36-38)
# ---------------------------------------------------------------------------

# scripts/port_jax_arms_fpd_witness.py: the JAX package's outputs on the
# CPU from the weights and inputs the helpers below build
ARMS_WITNESS = os.path.join(ROOT, "docs", "artifacts", "port",
                            "jax_arms_fpd_witness.npz")


def save_witness(path: str, arrays: dict) -> None:
    """An npz of each array's bytes compressed by lzma, beside a manifest
    of dtypes and shapes (the witness's clouds and kNN graphs take about
    30% less than under savez_compressed)."""
    blobs = {k: np.frombuffer(lzma.compress(
        np.ascontiguousarray(v).tobytes(), preset=9 | lzma.PRESET_EXTREME),
        np.uint8) for k, v in arrays.items()}
    manifest = {k: [np.asarray(v).dtype.str, list(np.shape(v))]
                for k, v in arrays.items()}
    np.savez(path, _manifest=np.array(json.dumps(manifest)), **blobs)


def load_witness(path: str) -> dict:
    """The arrays ``save_witness`` wrote, by name."""
    with np.load(path) as f:
        manifest = json.loads(str(f["_manifest"]))
        return {k: np.frombuffer(lzma.decompress(f[k].tobytes()),
                                 np.dtype(dt)).reshape(shape).copy()
                for k, (dt, shape) in manifest.items()}
ARMS = {"a": dict(encode="Pointfeat", use_adain="no_share"),
        "b": dict(encode="Residualnet", use_adain="no_use")}
# a forward's and a training step's launches of each arm (the step's bids
# depend on the auction's rounds: counted, not fixed)
ARMS_FORWARD = {"a": {"expansion": 2, "mds": 2},
                "b": {"knn": 4, "gather_max": 4, "expansion": 2, "mds": 2}}
ARMS_STEP_OPS = {"a": ("expansion", "mds", "nn_idx", "emd_bids"),
                 "b": TRAIN_EXPECTED}
# gradients exactly 0 in exact arithmetic: biases ahead of a normalisation
# (train BatchNorm, or AdaIN in no_share's decoders) and the BatchNorm
# biases before a max whose shift the next train BatchNorm removes
ARMS_ZERO_GRAD = {
    "a": ({"encoder.linear.bias", "encoder.feat_extractor.bn3.bias",
           "refine.residual.bn3.bias"}
          | {f"encoder.feat_extractor.conv{i}.bias" for i in (1, 2, 3)}
          | {f"decoder.decoder.conv{i}.bias" for i in (1, 2, 3)}
          | {f"refine.residual.conv{i}.bias" for i in range(1, 7)}),
    "b": ({"encoder.linear.bias", "refine.residual.bn3.bias"}
          | {f"decoder.decoder.conv{i}.bias" for i in (1, 2, 3)}
          | {f"refine.residual.conv{i}.bias" for i in range(1, 7)})}
SIREN_WIDTH = 1026                       # the decoders' bottleneck
FPD_SEED, FPD_CLOUDS, FPD_SET, FPD_SET_POINTS = WITNESS_SEED + 36, 4, 60, 2048
FPD_BATCH = 30                           # the FPD CLI's default batch
FPD_PER_CATEGORY = 50                    # models a category the CLI phase scores
FPD_CLI_TIMEOUT_S = 300
FPD_CLI_ARGS: list = []                  # further CLI flags (a CPU rehearsal's)
SESSIONS: set = set()                    # child sessions killed at the time limit


def arms_config(arm: str, remat: bool = False):
    """The port's sparenet.yaml (16384 points, 32 primitives, SE on) with
    the arm's encoder and decoder, and TPU.remat."""
    cfg = family_config("sparenet")
    cfg.NETWORK.encode = ARMS[arm]["encode"]
    cfg.NETWORK.use_adain = ARMS[arm]["use_adain"]
    cfg.TPU.remat = remat
    return cfg


def arms_model(arm: str, dev):
    """The arm at full width (``define_G``: bottleneck and hide 4096),
    initialised on the CPU from WITNESS_SEED with jittered BatchNorm
    statistics, on ``dev`` in eval mode."""
    model = define_G(arms_config(arm), seed=WITNESS_SEED, device="cpu")
    jitter_bn_stats(model, torch.Generator().manual_seed(WITNESS_SEED + 1))
    return model.to(dev).eval()


def edgeres_refine(dev):
    """SpareNetRefine with EdgeRes at full width (16384 points, 32
    primitives, SE on), initialised on the CPU from WITNESS_SEED + 2 with
    jittered BatchNorm statistics."""
    refine = SpareNetRefine(N_OUT, N_PRIMS, use_selayer=True, edgeres=True)
    init_weights(refine, torch.Generator().manual_seed(WITNESS_SEED + 2))
    jitter_bn_stats(refine, torch.Generator().manual_seed(WITNESS_SEED + 3))
    return refine.to(dev).eval()


def siren_decoder(dev):
    """One SIREN GridDecoder at the decoders' width (1026), initialised on
    the CPU from WITNESS_SEED + 4 (the SineLayer bounds)."""
    dec = GridDecoderStack(1, SIREN_WIDTH, use_sine=True)
    init_weights(dec, torch.Generator().manual_seed(WITNESS_SEED + 4))
    return dec.to(dev).eval()


def siren_inputs():
    """The folding grid [512, 2] and numpy-seeded AdaIN parameters [B,
    7692] (seven sizes, the last three unused), 1 + 0.5 normal."""
    grid = ((grid_generation(N_OUT, N_PRIMS) - 0.5) * 2.0).astype(np.float32)
    rs = np.random.RandomState(WITNESS_SEED + 5)
    ap = 1.0 + 0.5 * rs.randn(WITNESS_B, num_adain_params(SIREN_WIDTH, True))
    return grid, ap.astype(np.float32)


def fpd_clouds():
    """numpy-seeded clouds for the FPD checks: FPD_CLOUDS clouds of 16384
    uniform points, and two sets of FPD_SET Synthetic surfaces of 2048
    points (one shape a cloud, in turn), the second with 0.02 noise."""
    rs = np.random.RandomState(FPD_SEED)
    one = (rs.rand(FPD_CLOUDS, N_OUT, 3) - 0.5).astype(np.float32)
    sets = []
    for noise in (0.0, 0.02):
        clouds = [_surface_points(_SYNTH_SHAPES[i % len(_SYNTH_SHAPES)],
                                  FPD_SET_POINTS, rs) for i in range(FPD_SET)]
        c = np.stack(clouds).astype(np.float32)
        sets.append((c + noise * rs.randn(*c.shape)).astype(np.float32))
    return one, sets[0], sets[1]


def state_checksums(module) -> dict:
    """sha256 (first 16 hex digits) of each tensor of the module's own
    state_dict, hashed on a stride that keeps at most 2^20 elements (the
    no_share decoders hold 1.03 billion parameters)."""
    out = {}
    for k, v in sorted(module.state_dict().items()):
        flat = v.detach().cpu().reshape(-1)
        step = max(1, flat.numel() >> 20)
        out[k] = hashlib.sha256(flat[::step].contiguous().numpy().tobytes()
                                ).hexdigest()[:16]
    return out


def same_weights(what: str, module, want: dict) -> bool:
    sums = state_checksums(module)
    bad = [k for k in want if sums.get(k) != want[k]]
    if bad or sums.keys() != want.keys():
        fail(f"{what}: {len(bad)} of {len(want)} tensors differ from the "
             f"witness's (e.g. {bad[:3]}): this torch ({torch.__version__}) "
             f"draws other numbers from the seed, so the witness does not "
             f"apply")
        return False
    log(f"  {what}: {sum(p.numel() for p in module.parameters())} parameters;"
        f" its {len(sums)} tensors equal the witness's by sha256")
    return True


def fpd_tree(root: str) -> str:
    """Three .pcd trees of 16384-point clouds keyed to the first
    FPD_PER_CATEGORY models of each category of the port's fpd_test.list
    (docs/FPD_ARTIFACT.md's protocol): real/complete = a clean Synthetic
    surface of the category's shape, fake = the same with 0.02 noise and a
    quarter of its points duplicated, null = an independent clean sample.
    Returns the list's path."""
    from sparenet_tpu_torch import test_fpd as fpd_cli
    with open(fpd_cli.FPD_LIST) as f:
        models = f.read().splitlines()
    keep = [m for tax in fpd_cli.TAXONOMY2LABEL
            for m in [x for x in models if x.startswith(tax)][:FPD_PER_CATEGORY]]
    for i, model_id in enumerate(keep):
        label = fpd_cli.TAXONOMY2LABEL[model_id.split("/")[0]]
        rs = np.random.RandomState(77_000 + i)
        real = _surface_points(_SYNTH_SHAPES[label], N_OUT, rs)
        fake = real + rs.randn(N_OUT, 3).astype(np.float32) * 0.02
        dup = rs.permutation(N_OUT)[:N_OUT // 4]
        fake[dup] = fake[rs.permutation(N_OUT)[:N_OUT // 4]]
        null = _surface_points(_SYNTH_SHAPES[label], N_OUT, rs)
        for sub, cloud in (("real/complete", real), ("fake", fake),
                           ("null", null)):
            path = os.path.join(root, sub, f"{model_id}.pcd")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            IO.put(path, cloud.astype(np.float32))
    lst = os.path.join(root, "list.txt")
    with open(lst, "w") as f:
        f.write("\n".join(keep))
    return lst


def main_fpd(dev) -> None:
    """Phase 36: the canonical classifier's activations and an FPD against
    the witness, then the FPD CLI twice (fake and null against real) in two
    processes side by side."""
    from sparenet_tpu_torch import frechet
    from sparenet_tpu_torch.frechet import fpd as fpd_mod
    release_memory("FPD")
    if not os.path.exists(ARMS_WITNESS):
        fail(f"{ARMS_WITNESS} is missing (scripts/port_jax_arms_fpd_witness.py)")
        return
    w = load_witness(ARMS_WITNESS)
    one, s1, s2 = fpd_clouds()
    t = time.perf_counter()
    model = fpd_mod.load_classifier(device=dev)
    act = frechet.get_activations(one, model, batch_size=FPD_CLOUDS)
    hold(f"the canonical classifier's activations, {FPD_CLOUDS} clouds of "
         f"{N_OUT} points", torch.from_numpy(act), w["fpd_actv"])
    t1 = time.perf_counter()
    value = frechet.calculate_fpd(s1, s2, model, batch_size=FPD_BATCH)
    gap = abs(value / float(w["fpd_value"]) - 1)
    log(f"  FPD of two sets of {FPD_SET} clouds of {FPD_SET_POINTS} points: "
        f"{value!r} against the witness's {float(w['fpd_value'])!r}, relative "
        f"gap {gap:.3e} (limit 1e-3); activations {t1 - t:.2f} s, the FPD "
        f"{time.perf_counter() - t1:.2f} s (one sqrtm of 1808 x 1808 on the "
        f"host)")
    if not gap <= 1e-3:
        fail(f"FPD {value} differs from the witness's {float(w['fpd_value'])}")
    del model
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="fpd_cli_")
    try:
        t = time.perf_counter()
        lst = fpd_tree(work)
        log(f"  wrote 3 trees of {8 * FPD_PER_CATEGORY} clouds of {N_OUT} "
            f"points ({FPD_PER_CATEGORY} a category of fpd_test.list) in "
            f"{time.perf_counter() - t:.1f} s")
        procs, lines = {}, {}
        t = time.perf_counter()
        for tag in ("fake", "null"):
            cmd = [sys.executable, "-m", "sparenet_tpu_torch.test_fpd",
                   "--data_dir", os.path.join(work, "real"),
                   "--fake_dir", os.path.join(work, tag), "--list_path", lst,
                   "--num_points", str(N_OUT), "--batch_size", str(FPD_BATCH),
                   "--jobs", "4", "--log_dir", os.path.join(work, f"log_{tag}"),
                   *FPD_CLI_ARGS]
            out = open(os.path.join(work, f"{tag}.out"), "w")
            # a session of its own: a timeout kills its sqrtm workers too
            procs[tag] = (subprocess.Popen(cmd, cwd=ROOT, stdout=out,
                                           stderr=subprocess.STDOUT,
                                           start_new_session=True), out)
            SESSIONS.add(procs[tag][0].pid)
        for tag, (proc, out) in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, FPD_CLI_TIMEOUT_S - (
                    time.perf_counter() - t)))
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                rc = proc.wait()
            SESSIONS.discard(proc.pid)
            out.close()
            with open(out.name) as f:
                text = f.read().strip().splitlines()
            try:
                lines[tag] = json.loads(text[-1]) if rc == 0 else None
            except (ValueError, IndexError):
                lines[tag] = None
            if lines[tag] is None:
                fail(f"the FPD CLI ({tag} against real) exited {rc}: "
                     f"{text[-5:]}")
        wall = time.perf_counter() - t
        for tag, line in lines.items():
            if line is None:
                continue
            log(f"  FPD CLI, {tag} against real ({line['n_models']} models): "
                f"overall {line['fpd_all']!r}, category mean "
                f"{line['fpd_category_mean']!r}, per category "
                + json.dumps({k: round(v, 6) for k, v in
                              line["fpd_per_category"].items()})
                + "; seconds by part " + json.dumps(
                    {k: round(v, 2) for k, v in line["seconds"].items()}))
            PATHS[f"fpd_cli_{tag}"] = dict(
                all=line["fpd_all"], mean=line["fpd_category_mean"],
                per_category=line["fpd_per_category"], seconds=line["seconds"])
        log(f"  the two CLIs side by side: {wall:.1f} s of wall time")
        PATHS["fpd_cli_wall_s"] = wall
        if all(lines.values()):
            ok = all(math.isfinite(v) for line in lines.values() for v in
                     [line["fpd_all"], *line["fpd_per_category"].values()])
            if not ok or not lines["fake"]["fpd_all"] > lines["null"]["fpd_all"]:
                fail("the FPD CLI's fake set does not score above the null set "
                     "(or a value is not finite)")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def replay_graphs(graphs):
    """A kNN returning the witness's graphs in call order."""
    it = iter(graphs)

    def knn_replay(x, k=8, packed=False):
        return torch.from_numpy(np.asarray(next(it), np.int32)).to(x.device)
    return knn_replay


def knn_slots_off(calls, graphs, as_sets: bool = False) -> list:
    """For each recorded kNN call, the slots whose index differs from the
    graph's (``as_sets``: both sorted in each row)."""
    off = []
    for c, g in zip(calls, graphs):
        got = c[2].cpu().long()
        if as_sets:
            got = got.sort(-1).values
        off.append(int((got != torch.from_numpy(g.astype(np.int64))).sum()))
    return off


def arm_step(model, partial, gt):
    """One training step of a copy of ``model`` with a new Adam: (losses,
    gradients by name)."""
    m = copy.deepcopy(model)
    return run_step(m, train_base.make_optimizer(m, train_runner.CONFIG),
                    partial, gt)


def main_arms(dev) -> dict:
    """Phase 37; returns the launches of each arm's forward and step and of
    the rematted flagship step."""
    out: dict = {}
    if not os.path.exists(ARMS_WITNESS):
        fail(f"{ARMS_WITNESS} is missing (scripts/port_jax_arms_fpd_witness.py)")
        return out
    w = load_witness(ARMS_WITNESS)
    partial_np, _ = witness_inputs()
    partial = torch.from_numpy(partial_np).to(dev)
    gen = torch.Generator().manual_seed(37)
    partial32 = (torch.rand(B_BENCH, N_INPUT_POINTS, 3, generator=gen)
                 - 0.5).to(dev)
    step_in = [t.to(dev) for t in train_batch(gen, B_CHECK)]
    with torch.no_grad():
        for arm in ARMS:
            release_memory(f"arm ({arm}) {ARMS[arm]}")
            t = time.perf_counter()
            model = arms_model(arm, dev)
            log(f"  arm ({arm}): built on the CPU and moved in "
                f"{time.perf_counter() - t:.1f} s")
            if not same_weights(f"arm ({arm})", model,
                                json.loads(str(w[f"{arm}_checksums"]))):
                continue
            calls: dict = {}
            with swapped(**recording(calls)):
                res, launches, plain = launch_counts(
                    lambda: complete(model, partial))
            check_launches(f"arm ({arm}) forward, B={WITNESS_B}", launches,
                           plain, ARMS_FORWARD[arm])
            out[f"{arm}_forward"] = launches
            coarse, _, refine, loss_mst = res
            if arm == "b":
                graphs = w["b_graphs"]
                off = knn_slots_off(calls["knn"], graphs)
                log(f"  arm (b): the kernel's encoder graphs against the JAX "
                    f"package's: slots that differ per stage {off} of "
                    f"{graphs[0].size} (near-ties the two round apart)")
                with swapped(**dict(PLAIN, knn=replay_graphs(graphs))):
                    anchored = model.coarse_cloud(partial)
                hold("arm (b) coarse, plain ops on the witness's graphs",
                     anchored, w["b_coarse"])
                if sum(off):
                    gap = float((coarse.cpu() - torch.from_numpy(
                        w["b_coarse"])).abs().max())
                    log(f"  arm (b) coarse free-running: max abs gap {gap:.3e}"
                        f", Chamfer {chamfer(coarse, torch.from_numpy(w['b_coarse']).to(dev)):.3e}")
                else:
                    hold("arm (b) coarse against the witness", coarse,
                         w["b_coarse"])
            else:
                hold(f"arm ({arm}) coarse against the witness", coarse,
                     w[f"{arm}_coarse"])
            jc = torch.from_numpy(w[f"{arm}_coarse"]).to(dev)
            dist, _, mml = expansion_penalty.expansion_penalty(jc, PRIM_S, 1.5)
            hold(f"arm ({arm}) loss_mst on the witness's coarse cloud",
                 dist.mean(), w[f"{arm}_loss_mst"], atol=0.0)
            # both refine passes anchored on the witness's coarse cloud and
            # picks; the middle cloud between them is the port's own
            mid = jc
            for p in (1, 2):
                base = flagged_base(mid, partial)
                if p == 2:
                    _, _, mml = expansion_penalty.expansion_penalty(
                        mid, PRIM_S, 1.5)
                w_idx = torch.from_numpy(w[f"{arm}_idx{p}"].astype(np.int32)).to(dev)
                idx = mds.minimum_density_sample(base[..., :3].contiguous(),
                                                 N_OUT, mml)
                ok, _, msg = compare_mds(base[..., :3], mml, idx, w_idx)
                log(f"  arm ({arm}) refine pass {p}: MDS (#4) on the "
                    f"{'witness' if p == 1 else 'anchored middle'} cloud "
                    f"against the JAX package's picks: {msg}")
                if not ok:
                    fail(f"arm ({arm}) pass {p}: MDS picks part from the JAX "
                         f"package's at a step that is no near-tie")
                mid = model.refine.finish(base, w_idx)
            hold(f"arm ({arm}) refine anchored on the witness's coarse cloud "
                 f"and both passes' picks", mid, w[f"{arm}_refine"])
            cd = chamfer(refine, torch.from_numpy(w[f"{arm}_refine"]).to(dev))
            log(f"  arm ({arm}) refine free-running: Chamfer {cd:.3e} against "
                f"the witness (limit {CONTRACT_CHAMFER:g}); loss_mst "
                f"{float(loss_mst)!r} against {float(w[f'{arm}_loss_mst'])!r}")
            if not cd <= CONTRACT_CHAMFER:
                fail(f"arm ({arm}) free-running refine: Chamfer {cd:.3e}")
            del calls, res
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: complete(model, partial32), reps=3, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            log(f"  arm ({arm}) forward, B={B_BENCH}: {ms:.1f} ms, "
                f"{B_BENCH / (ms / 1e3):.2f} clouds/s, peak memory {peak:.2f} "
                f"GiB, on {nvidia_smi()}")
            PATHS[f"arm_{arm}_b32_ms"] = ms
            PATHS[f"arm_{arm}_b32_peak_gib"] = peak
            with torch.enable_grad():
                out[f"{arm}_step"] = kernel_and_plain_steps(
                    f"arm ({arm}) training step, B={B_CHECK}", model, step_in,
                    ARMS_STEP_OPS[arm], ARMS_ZERO_GRAD[arm])
            del model
    release_memory("the rematted flagship step")
    with torch.enable_grad():
        out["flagship_remat_step"] = remat_steps(dev)
    return out


def kernel_and_plain_steps(what: str, model, step_in, expected, zero_grad):
    """One training step of a copy of ``model`` against a plain step that
    replays its kNN graphs, MDS picks and auction assignments, both in
    deterministic mode (the bids are held to their plain version in phases
    9 and 29); returns the kernel step's launches."""
    calls: dict = {}
    assigns: list = []
    auction = emd.auction_assign

    def keep(*a, **k):
        assigns.append(auction(*a, **k))
        return assigns[-1]
    with deterministic():
        with swapped(**recording(calls)), patched(
                (emd, "auction_assign", keep)):
            kern, launches, plain = launch_counts(
                lambda: arm_step(model, *step_in))
        log(f"  {what}: loss {kern[0]}; launches {launches}, plain calls "
            f"{plain}")
        missing = [op for op in expected if not launches.get(op)]
        if missing or plain:
            fail(f"{what}: no launch of {missing} or plain calls {plain}")
        fixed = {op: replay(calls[op]) for op in ("knn", "mds") if op in calls}
        it = iter(assigns)
        with swapped(**dict(PLAIN, **fixed)), patched(
                (emd, "auction_assign", lambda *a, **k: next(it))):
            p = arm_step(model, *step_in)
    loss, rel, zero, worst = step_gaps(kern, p, zero_grad)
    log(f"  {what}: kernel step vs plain step (kNN graphs, MDS picks and "
        f"auction assignments replayed), both deterministic: loss rel gap "
        f"{loss:.3e} (limit {STEP_LOSS_RTOL:g}), gradient leaf relative-L2 "
        f"gap {rel:.3e} ({worst}; limit {STEP_GRAD_REL:g}), zero-gradient "
        f"leaves {zero:.3e} (limit {STEP_ZERO_ABS:g})")
    if loss > STEP_LOSS_RTOL or rel > STEP_GRAD_REL or zero > STEP_ZERO_ABS:
        fail(f"{what}: the kernel step differs from the anchored plain step")
    return launches


def remat_steps(dev) -> dict:
    """The flagship step at B=24 with and without TPU.remat, each twice
    from the same state in deterministic mode: losses, every gradient and
    every running statistic bit for bit, each step's peak memory and time;
    returns the rematted step's launches."""
    model = build_generator(seed=0, device="cpu")
    jitter_bn_stats(model, torch.Generator().manual_seed(38))
    plain_m = model.to(dev)
    remat_m = copy.deepcopy(plain_m)
    remat_m.remat = remat_m.refine.remat = True
    partial, gt = (t.to(dev) for t in train_batch(
        torch.Generator().manual_seed(39), B_TRAIN))
    runs = {}
    with deterministic():
        for tag, m in (("plain", plain_m), ("remat", remat_m)):
            opt = train_base.make_optimizer(m, train_runner.CONFIG)
            steps, peaks, times = [], [], []
            for i in range(2):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                _lib.reset_counts()
                steps.append(run_step(m, opt, partial, gt))
                times.append((time.perf_counter() - t) * 1e3)
                peaks.append(torch.cuda.max_memory_allocated() / 2**30)
                if i == 0:
                    launches = {k: v for k, v in _lib.LAUNCHES.items() if v}
            runs[tag] = dict(steps=steps, peaks=peaks, times=times,
                             launches=launches,
                             buffers={k: v.clone() for k, v in m.named_buffers()})
            m.zero_grad(set_to_none=True)
            del opt
    same = all(
        a[0] == b[0] and a[1].keys() == b[1].keys()
        and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
        for a, b in zip(runs["plain"]["steps"], runs["remat"]["steps"]))
    same_buf = all(torch.equal(runs["plain"]["buffers"][k], v)
                   for k, v in runs["remat"]["buffers"].items())
    for tag, r in runs.items():
        log(f"  flagship step B={B_TRAIN}, {tag}, deterministic: "
            f"{[round(x, 1) for x in r['times']]} ms, peak memory "
            f"{[round(x, 2) for x in r['peaks']]} GiB, launches {r['launches']}")
        PATHS[f"flagship_{tag}_b24_det_ms"] = r["times"][1]
        PATHS[f"flagship_{tag}_b24_peak_gib"] = max(r["peaks"])
    log(f"  remat against plain, two steps: losses, gradients bit for bit "
        f"{same}; running statistics bit for bit {same_buf}")
    if not (same and same_buf):
        fail("the rematted flagship step differs from the plain step")
    lp, lr_ = runs["plain"]["launches"], runs["remat"]["launches"]
    want = dict(lp, knn=2 * lp.get("knn", 0),
                edge_stats_fwd=2 * lp.get("edge_stats_fwd", 0))
    if lr_ != want:
        fail(f"the rematted step's launches {lr_} are not the plain step's "
             f"with the encoder's #1 and #7f twice ({want})")
    return lr_


EDGERES_MODEL_ROWS = 128      # query rows a cloud held to #1's own ranking


def check_edgeres_knn(kcalls) -> dict:
    """#1 on each of the EdgeRes pass's seven inputs: against its plain
    version at every query (``compare_knn``), against its own ranking bit
    for bit at EDGERES_MODEL_ROWS evenly spaced query rows a cloud
    (``compare_knn_model``), the queries its margin test sends to the exact
    scan, and kernel, plain and library times. Then a planted fault, each
    graph's 8th neighbour replaced by plain's 9th (``replay_knn``'s
    perturbation), which the two checks together must refuse at every
    shape. Returns the kernels line's row: sums over the seven calls and a
    list by shape."""
    library, reps, _, bound_fn = SPECS["knn"]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "flagged": 0, "queries": 0, "shapes": []}
    for i, (args, kw, got) in enumerate(kcalls):
        x, k = args[0], kw.get("k", args[1] if len(args) > 1 else K)
        b, n, c = x.shape
        want = plain_knn(x, k)
        ok, err, msg = compare_knn(x, got, want)
        rows = torch.arange(0, n, n // EDGERES_MODEL_ROWS, device=x.device)
        model = knn.knn_seq_rows(x, rows, k)
        ok_m, _, msg_m = compare_knn_model(got, rows, model)
        flagged = flagged_by(lambda: knn.knn_idx(x, k), "knn_flagged")
        nine = plain_knn(x, k + 1)
        fault = torch.cat([got[..., :k - 1], nine[..., k:].to(got.dtype)], -1)
        f_plain, _, f_msg = compare_knn(x, fault, want)
        f_model, _, f_msg_m = compare_knn_model(fault, rows, model)
        ms = cuda_ms(lambda: knn.knn_idx(x, k), reps=reps)
        pms = cuda_ms(lambda: plain_knn(x, k), reps=1, warmup=0)
        lms = cuda_ms(lambda: library(x, k), reps=3)
        b_ms, _ = bound_fn(args, got)
        log(f"  knn call {i} [{b}, {n}, {c}]: against plain: {msg}; against "
            f"its own ranking: {msg_m}; {flagged} of {b * n} queries flagged "
            f"for the exact scan; kernel {ms:.4f} ms, plain {pms:.4f} ms, "
            f"library {lms:.4f} ms, bound {b_ms:.5f} ms")
        log(f"    planted fault (8th neighbour := plain's 9th): against "
            f"plain: {'passes' if f_plain else 'refused'} ({f_msg}); against "
            f"its own ranking: {'passes' if f_model else 'refused'} "
            f"({f_msg_m})")
        if not ok:
            fail(f"knn call {i} of the EdgeRes pass: beyond the near-tie "
                 f"envelope of its plain version")
        if not ok_m:
            fail(f"knn call {i} of the EdgeRes pass: off its own ranking")
        if f_plain and f_model:
            fail(f"knn call {i} of the EdgeRes pass: the planted fault passes")
        tot["shapes"].append(dict(C=c, flagged=flagged, queries=b * n, ms=ms,
                                  plain_ms=pms, library_ms=lms, bound_ms=b_ms,
                                  slots_off_plain=int((got != want).sum()),
                                  fault_refused_by_plain=not f_plain,
                                  fault_refused_by_model=not f_model))
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                       ("bound_ms", b_ms), ("flagged", flagged),
                       ("queries", b * n)):
            tot[key] += v
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        del want, model, nine, fault
    log(f"  knn: {len(kcalls)} calls per EdgeRes pass: kernel "
        f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
        f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.5f} ms; "
        f"{tot['flagged']} of {tot['queries']} queries flagged")
    return tot


def main_edgeres_siren(dev) -> dict:
    """Phase 38; returns the launches of EdgeRes's refine pass, a
    generator forward and a training step with it."""
    out: dict = {}
    if not os.path.exists(ARMS_WITNESS):
        return out
    w = load_witness(ARMS_WITNESS)
    partial_np, _ = witness_inputs()
    partial = torch.from_numpy(partial_np).to(dev)
    release_memory("EdgeRes")
    with torch.no_grad():
        refine = edgeres_refine(dev)
        if same_weights("the EdgeRes refine", refine,
                        json.loads(str(w["c_checksums"]))):
            base = flagged_base(torch.from_numpy(w["b_coarse"]).to(dev), partial)
            w_idx = torch.from_numpy(w["b_idx1"].astype(np.int32)).to(dev)
            calls: dict = {}
            with swapped(**recording(calls)):
                got, launches, plain = launch_counts(
                    lambda: refine.finish(base, w_idx))
            check_launches(f"the EdgeRes refine pass, B={WITNESS_B}",
                           launches, plain, {"knn": 7})
            out["edgeres_pass"] = launches
            log("  #1 at EdgeRes's shapes (the pass's own inputs):")
            out["knn_rows"] = check_edgeres_knn(calls["knn"])
            graphs = w["c_graphs"]
            slots = knn_slots_off(calls["knn"], graphs, as_sets=True)
            log(f"  the kernel's seven graphs against the JAX package's, as "
                f"sets: slots that differ per stage {slots} of "
                f"{graphs[0].size}")
            out["knn_rows"]["slots_off_witness"] = slots
            with swapped(**dict(PLAIN, knn=replay_graphs(graphs))):
                anchored = refine.finish(base, w_idx)
            hold("the EdgeRes pass, plain ops on the witness's seven graphs",
                 anchored, w["c_refine"])
            want = torch.from_numpy(w["c_refine"]).to(dev)
            err = (got - want).abs()
            off = int((err > CONTRACT_ATOL + CONTRACT_RTOL * want.abs())
                      .any(-1).sum())
            cd = chamfer(got, want)
            log(f"  the EdgeRes pass free-running against the witness (each "
                f"package on its own seven graphs): Chamfer "
                f"{cd:.3e} (limit {CONTRACT_CHAMFER:g}); max abs gap "
                f"{float(err.max()):.3e}, points outside atol {CONTRACT_ATOL:g}"
                f" + rtol {CONTRACT_RTOL:g}: {off} of "
                f"{got.shape[0] * got.shape[1]} (kNN near-ties the two round "
                f"apart, and the global max feature after them)")
            PATHS["edgeres_witness"] = dict(chamfer=cd, points_off=off,
                                            max_abs=float(err.max()))
            if not cd <= CONTRACT_CHAMFER:
                fail(f"the EdgeRes pass differs from the witness: Chamfer {cd:.3e}")
        del refine
        dec = siren_decoder(dev)
        if same_weights("the SIREN decoder", dec,
                        json.loads(str(w["d_checksums"]))):
            grid, ap = siren_inputs()
            res = dec(torch.from_numpy(grid).to(dev),
                      torch.from_numpy(ap).to(dev))[0]
            hold("the SIREN decoder against the witness", res, w["d_out"])
        del dec
    release_memory("the flagship with EdgeRes")
    model = build_generator(seed=WITNESS_SEED, device="cpu", edgeres=True)
    jitter_bn_stats(model, torch.Generator().manual_seed(40))
    model = model.to(dev).eval()
    _, launches, plain = launch_counts(lambda: complete(model, partial))
    check_launches(f"the flagship forward with EdgeRes, B={WITNESS_B}",
                   launches, plain, {"knn": 18, "gather_max": 4,
                                     "expansion": 2, "mds": 2})
    out["edgeres_forward"] = launches
    step_in = [t.to(dev) for t in train_batch(
        torch.Generator().manual_seed(41), WITNESS_B)]
    launches = kernel_and_plain_steps(
        f"the flagship training step with EdgeRes, B={WITNESS_B}", model,
        step_in, TRAIN_EXPECTED, ZERO_GRAD)
    if launches.get("knn") != 18:
        fail(f"the EdgeRes step launched #1 {launches.get('knn')} times, not 18")
    out["edgeres_step"] = launches
    return out


def _out_of_time(signum, frame):
    """The time limit: kill the child sessions, then exit non-zero."""
    for pgid in list(SESSIONS):
        with contextlib.suppress(ProcessLookupError):
            os.killpg(pgid, signal.SIGKILL)
    print(f"time limit of {TIME_LIMIT_S} s reached", file=sys.stderr, flush=True)
    os._exit(1)


def main() -> int:
    signal.signal(signal.SIGALRM, _out_of_time)
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
    log("phase 26: the evaluation CLI in serving mode on the npz "
        "(flagship_e8_eval.yaml, 8 batches of 16): the default arm, then "
        "--mds hybrid, then NETWORK.mml_calibration set")
    serve_batch = main_serving_cli(dev)
    log(f"phase 27: serving's quality contract on the npz (Synthetic VAL, "
        f"{ENV_BATCHES} batches of {ENV_B}) against the JAX envelope "
        f"(docs/artifacts/r5/stage5/envelope_r5ckpt.json)")
    main_envelope(dev)
    log(f"phase 28: MSN and AtlasNet eval forwards at full width against the "
        f"JAX witness (B={WITNESS_B}), B={B_FAMILY} throughput, MSN serving")
    family_forward = main_family_eval(dev)
    log(f"phase 29: MSN and AtlasNet training steps at B={B_FAMILY} against "
        f"plain steps replaying their MDS picks and auction assignments")
    family_steps = main_family_train(dev)
    log("phase 30: the training and evaluation CLIs with --model msn and "
        "atlasnet (Synthetic, 2 steps at B=32, validation over 32 clouds at "
        "B=16), MSN's --serving")
    family_batches = main_family_cli(dev)
    log(f"phase 31: GRNet's eval forward at full width against the JAX "
        f"witness (B={WITNESS_B}), its ops on the card against the CPU, the "
        f"NN on the sparse loss's shapes, B={B_FAMILY} throughput")
    grnet_forward = main_grnet_eval(dev)
    log(f"phase 32: GRNet's training step at B={B_FAMILY} against a plain step "
        f"replaying its NN picks and auction assignments")
    family_steps.update(main_family_train(dev, ("grnet",)))
    log("phase 33: the training and evaluation CLIs with --model grnet "
        "(Synthetic, 2 steps at B=32, validation over 32 clouds at B=16)")
    family_batches.update(main_family_cli(dev, ("grnet",)))
    log(f"phase 34: the file datasets: ShapeNet (.pcd), Completion3D (.h5) "
        f"and KITTI trees; the training CLI on ShapeNet (2 steps at "
        f"B={B_TRAIN}), the evaluation CLI on its checkpoint and on "
        f"Completion3D VAL; the PCD codecs' MB/s")
    files = main_file_data(t_launches, dev)
    log("phase 35: the evaluation CLI's test modes on the checkpoint: render "
        "(ShapeNet TEST), kitti (B=1), vis")
    file_launches = dict(shapenet_step=files["shapenet_step"],
                         shapenet_eval_batch=files["shapenet_eval_batch"],
                         **main_test_modes(files, dev))
    t36 = time.perf_counter()
    log(f"phase 36: FPD on the card: the canonical classifier's activations "
        f"and an FPD against the JAX witness, then the FPD CLI (fake and null "
        f"against real, {FPD_PER_CATEGORY} models a category of "
        f"fpd_test.list at {N_OUT} points)")
    main_fpd(dev)
    t37 = time.perf_counter()
    log(f"  phase 36: {t37 - t36:.1f} s")
    log(f"phase 37: SpareNet's arms at full width against the JAX witness "
        f"(B={WITNESS_B}): (a) {ARMS['a']}, (b) {ARMS['b']}; B={B_BENCH} "
        f"forwards, a training step of each at B={B_CHECK} against a plain "
        f"step, the flagship step at B={B_TRAIN} with and without TPU.remat")
    arm_launches = main_arms(dev)
    log("phase 38: EdgeRes (#1 at its shapes, its refine pass against the "
        "witness, a forward and a training step with it) and the SIREN "
        "decoder against the witness")
    arm_launches.update(main_edgeres_siren(dev))
    knn_rows = arm_launches.pop("knn_rows", None)
    log(f"  phases 37-38: {time.perf_counter() - t37:.1f} s")
    PATHS.update(phase36_s=t37 - t36, phase37_38_s=time.perf_counter() - t37)

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
        # a serving eval batch's launches as the CLI runs it (phase 26)
        kernels[-1]["launches_serving_batch"] = {
            tag: launches_of(batch, name) for tag, batch in serve_batch.items()}
        # MSN's, AtlasNet's and GRNet's paths (phases 28-33): a forward
        # (MSN's serving arms too), a training step, an evaluation CLI batch
        kernels[-1]["launches_families"] = {
            "msn_forward": family_forward.get("msn", {}).get(name, 0),
            **{f"msn_serving_{arm}": family_forward.get(
                f"msn_serving_{arm}", {}).get(name, 0)
               for arm in ("exact", "hybrid")},
            "grnet_forward": grnet_forward.get(name, 0),
            **{f"{f}_step": family_steps.get(f, {}).get(name, 0)
               for f in FAMILIES + ("grnet",)},
            **{f"{k}_eval_batch": v.get(name, 0)
               for k, v in family_batches.items()}}
        # the file datasets' paths (phases 34-35): a ShapeNet training step
        # and eval batch, a rendered batch's side outputs, a KITTI cloud
        kernels[-1]["launches_file_data"] = {
            k: v.get(name, 0) for k, v in file_launches.items()}
        # SpareNet's other arms (phases 37-38): each arm's forward and
        # training step, the rematted flagship step, EdgeRes's refine pass,
        # a forward and a training step with EdgeRes
        kernels[-1]["launches_arms"] = {
            k: v.get(name, 0) for k, v in arm_launches.items()}
    if knn_rows is not None:
        # #1 on EdgeRes's seven graphs of one refine pass (B=2, N=16384)
        kernels[0]["edgeres_pass"] = knn_rows
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
