"""Minimum-density sampling and point gathering (counterpart of
sparenet_tpu/ops/mds.py).

``minimum_density_sample(xyz, npoint, mean_mst_length)``: exact greedy MDS,
xyz [B, N, 3] f32, mean_mst_length [B] -> idx [B, npoint] int32. Pick 0 is
point 0, pinned to 1e9; each step adds w * exp(-d2 / t) to every density
(t = 5 * mml^2, d2 the squared distance to the previous pick, w = 2 for
index >= 8192), picks the lowest-index argmin and pins it to 1e9. On a CUDA
tensor it launches ``csrc/mds.cu``; on a CPU tensor it runs ``mds_plain``.
The kernel spreads each cloud over a thread-block cluster of C CTAs, C
chosen from the batch (``cluster_size``: among the shapes at which every
cloud's cluster is resident at once, one or two CTAs an SM, the one with
the fewest points an SM), and compacts its picked lanes every
``STAGE`` steps; ``mds_partitioned`` is that decomposition in plain
PyTorch (for the tests; no path runs it). Any C gives the same picks.

The density term exp(-d2 / t) is flushed to 0 below the smallest normal
f32, as the reference computes it: its XLA CPU and TPU programs have no
subnormals. Far points then add exactly 0, and which points tie at density 0
decides the lowest-index picks of the early steps.

Serving mode's arms (the reference's ``SPARENET_FAST_MATH=1`` dispatch,
``resolve_impl`` and ``minimum_density_sample_xyz``):
- ``"batched"`` (``mds_batched``, the reference's _mds_batched): rounds of
  the G lowest densities, each followed by ONE density update summed over
  the round's picks in exp2 dot form; plain PyTorch (the reference has no
  Pallas kernel there), reduced in chunks of picks so the [B, N, picks]
  tensor never exists whole. A round picks by one of the reference's
  selection arms (``SELECTS``, the reference's _round_pick): "sort" (the
  default) and "topk" (the same function) and "bisect" pick the same set,
  bisect in index order; "pack16" a 15-bit rank that may part from them at
  near-ties;
- ``"hybrid"`` (``mds_hybrid``, the reference's _mds_hybrid): a batched
  prefix with G = 8192 and every bump applied, its picked lanes compacted
  out (stable), then an exact greedy tail of ``tail`` picks on the live
  lanes (``mds_continue``: kernel ``spn_mds_continue``, counted as
  ``"mds_continue"``; plain version ``mds_continue_plain``). The kernel is
  the greedy kernel's cluster decomposition started from the prefix's
  densities (``continue_cluster_size`` gives its launch shape,
  ``mds_continue_floor`` its latency floor, ``mds_continue_partitioned``
  models it on the CPU for the tests);
- ``"exact"``: the greedy kernel above, then a gather.
Their densities and distances stay f32 (the reference's TPU program runs
these products at its default one-pass bf16, which moves the exp2
argument by ~1 at production temperatures); the reference's bf16 MDS
coordinates under fast math are not carried either.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import _lib
from .common import check_input, is_cpu, sqdist3

__all__ = ["minimum_density_sample", "mds_plain", "mds_partitioned",
           "cluster_size", "mds_floor", "STAGE", "gather_points",
           "resolve_impl", "select_smallest", "select_smallest_sort",
           "select_smallest_bisect", "select_smallest_pack16",
           "check_select", "dial_state", "SELECTS",
           "mds_batched", "mds_hybrid",
           "mds_continue", "mds_continue_plain", "mds_continue_partitioned",
           "continue_cluster_size", "mds_continue_floor",
           "minimum_density_sample_xyz",
           "compact_live", "batched_terms", "batched_update", "MDS_IMPLS", "BATCH_G", "SCHEDULE", "TAIL"]

_BIG = 1e9
# the continuation compacts its picked lanes only where every density of
# temp0 is below this (csrc/mds.cu: a live lane then stays below any pick)
_LIVE_BELOW = 5e8
_HEAVY_FROM = 8192  # points at index >= this get 2x density weight
_TINY = torch.finfo(torch.float32).tiny  # smallest normal f32
_SUBNORMAL_MAX = (2 ** 23 - 1) * 2.0 ** -149  # largest subnormal f32
_L2E = 1.4426950408889634
MDS_IMPLS = ("exact", "batched", "hybrid")
# the batched rounds' selection arms (the reference's SPARENET_MDS_SELECT)
SELECTS = ("sort", "bisect", "topk", "pack16")
_BIG_BITS = 0x4E6E6B28   # the bit pattern of 1e9 (f32), the bisect's top
_PACK_LANES = 1 << 15    # pack16's lane field: rows of fewer lanes only
# the reference's serving defaults (SPARENET_MDS_BATCH_G, _SCHEDULE, _TAIL)
BATCH_G, SCHEDULE, TAIL = 8192, (2048,), 2048
# steps between the greedy kernel's lane compactions
STAGE = 1024
# the greedy kernel's decomposition (csrc/mds.cu): threads a CTA, points a
# chunk (chunk i goes to CTA i mod C), threads a warp
_THREADS, _CHUNK, _WARP = 512, 32, 32
# picks a batched update reduces at once: [B, N, 512] f32 is 1.3 GB at
# B = 32, N = 19384 (the whole [B, N, 8192] round would be 20 GB)
_UPDATE_CHUNK = 512


def _temperature(mean_mst_length: torch.Tensor) -> torch.Tensor:
    return 5.0 * mean_mst_length * mean_mst_length


def mds_plain(xyz: torch.Tensor, npoint: int,
              mean_mst_length: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the MDS kernel (one step per pick)."""
    _lib.PLAIN_CALLS["mds"] += 1
    b, n, _ = xyz.shape
    dev = xyz.device
    # a [B, 1] tensor: tensor / tensor is an IEEE division on every device
    t = _temperature(mean_mst_length).reshape(b, 1)
    weight = torch.where(torch.arange(n, device=dev) >= _HEAVY_FROM, 2.0, 1.0)
    temp = torch.zeros((b, n), dtype=torch.float32, device=dev)
    temp[:, 0] = _BIG
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    last = torch.zeros(b, dtype=torch.long, device=dev)
    for j in range(1, npoint):
        d2 = sqdist3(xyz - xyz[rows, last][:, None, :])
        e = torch.exp(-d2 / t)
        e = torch.where(e < _TINY, 0.0, e)
        temp = temp + weight * e
        nxt = temp.argmin(1)
        temp[rows, nxt] = _BIG
        idx[:, j] = nxt.to(torch.int32)
        last = nxt
    return idx


def _cloud_ids(n: int, cluster: int, device) -> tuple:
    """(CTA, thread, lane) of every point of an N-point cloud in the
    kernel's decomposition: point i is in chunk i // 32, which goes to CTA
    chunk mod C; in a CTA, local point p is lane p // 512 of thread
    p % 512."""
    i = torch.arange(n, device=device)
    chunk = i // _CHUNK
    p = (chunk // cluster) * _CHUNK + i % _CHUNK
    return chunk % cluster, p % _THREADS, p // _THREADS


def _lex_argmin(key: torch.Tensor, idx: torch.Tensor, dim: int):
    """Lexicographic (key, index) argmin along dim -> (key, index)."""
    low = key.amin(dim, keepdim=True)
    cand = torch.where(key == low, idx, torch.iinfo(torch.int64).max)
    return low.squeeze(dim), cand.amin(dim)


def _cluster_slots(b: int, n: int, cluster: int, device):
    """(slot of every point in a [B, C, warps, 32, lanes] layout, that
    shape)."""
    cta, thread, lane = _cloud_ids(n, cluster, device)
    lanes = int(lane.max()) + 1
    slot = (((cta * (_THREADS // _WARP) + thread // _WARP) * _WARP
             + thread % _WARP) * lanes + lane)
    return slot, (b, cluster, _THREADS // _WARP, _WARP, lanes)


def _cluster_argmin(key: torch.Tensor, present: torch.Tensor,
                    slot: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The kernel's argmin of key [B, N] (no NaN) over the present points:
    each thread the lowest-index minimum of its lanes, then warps, CTAs and
    the cluster lexicographically on (key, index) -> [B] int64."""
    b, n = key.shape
    big = torch.iinfo(torch.int64).max
    key = torch.where(present, key, float("inf"))
    ids = torch.where(present, torch.arange(n, device=key.device), big)
    kk = torch.full((b, math.prod(shape[1:])), float("inf"), dtype=key.dtype,
                    device=key.device)
    ii = torch.full(kk.shape, big, dtype=torch.long, device=key.device)
    kk[:, slot], ii[:, slot] = key, ids
    kk, ii = kk.view(shape), ii.view(shape)
    # thread: its lanes ascend in index, strict < keeps the first
    li = kk.argmin(-1, keepdim=True)
    kk, ii = kk.gather(-1, li)[..., 0], ii.gather(-1, li)[..., 0]
    for dim in (3, 2, 1):                          # warp, CTA, cluster
        kk, ii = _lex_argmin(kk, ii, dim)
    return ii


def mds_partitioned(xyz: torch.Tensor, npoint: int,
                    mean_mst_length: torch.Tensor, cluster: int,
                    stage: int = STAGE) -> torch.Tensor:
    """The greedy kernel's decomposition in plain PyTorch (for the tests):
    the points spread over ``cluster`` CTAs as csrc/mds.cu spreads them;
    each step every thread takes the lowest-index argmin of its lanes, then
    warps, CTAs and the cluster reduce (density, index) lexicographically
    in that order (NaN first); the previous pick is pinned lazily; every
    ``stage`` steps the picked lanes leave, where no density can turn NaN
    (t finite and > 0, every coordinate finite). Equals ``mds_plain``."""
    b, n, _ = xyz.shape
    dev = xyz.device
    t = _temperature(mean_mst_length).reshape(b, 1)
    weight = torch.where(torch.arange(n, device=dev) >= _HEAVY_FROM, 2.0, 1.0)
    slot, shape = _cluster_slots(b, n, cluster, dev)
    compact = (stage > 0) & torch.isfinite(t[:, 0]) & (t[:, 0] > 0) & \
        torch.isfinite(xyz).flatten(1).all(1)
    present = torch.ones((b, n), dtype=torch.bool, device=dev)
    picked = torch.zeros((b, n), dtype=torch.bool, device=dev)
    temp = torch.zeros((b, n), dtype=torch.float32, device=dev)
    idx = torch.zeros((b, npoint), dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    last = torch.zeros(b, dtype=torch.long, device=dev)
    picked[:, 0] = True
    for j in range(1, npoint):
        if stage > 0 and j % stage == 0:
            present &= ~(picked & compact[:, None])
        temp[rows, last] = _BIG                                # the lazy pin
        e = torch.exp(-sqdist3(xyz - xyz[rows, last][:, None, :]) / t)
        temp = temp + weight * torch.where(e < _TINY, 0.0, e)
        key = torch.where(temp.isnan(), float("-inf"), temp)
        nxt = _cluster_argmin(key, present, slot, shape)
        picked[rows, nxt] = True
        idx[:, j] = nxt.to(torch.int32)
        last = nxt
    return idx


def cluster_size(batch: int, n: int) -> tuple[int, int]:
    """(C, CTAs an SM): the launch shape the greedy kernel takes for
    ``batch`` clouds of ``n`` points on the current card."""
    out = (ctypes.c_int * 2)()
    _lib.lib().spn_mds_shape(batch, n, out)
    return out[0], out[1]


def _mds_launch(fn, xyz, npoint, mean_mst_length, *extra):
    b, n, _ = xyz.shape
    t = _temperature(mean_mst_length.to(torch.float32)).contiguous()
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        code = fn(xyz.data_ptr(), t.data_ptr(), b, n, npoint, *extra,
                  out.data_ptr(), _lib.stream_of(xyz))
    _lib.check(code, "mds")
    return out


def mds_floor(xyz: torch.Tensor, npoint: int, mean_mst_length: torch.Tensor,
              cluster: int, cta_only: bool = False) -> torch.Tensor:
    """The greedy kernel's chain of npoint - 1 steps at cluster size
    ``cluster`` with no lane pass (its barriers and exchanges only; with
    ``cta_only`` the CTA's argmin and barrier alone, no record exchange),
    for timing the latency floor; its output is not
    MDS picks. CUDA only."""
    return _mds_launch(_lib.lib().spn_mds_floor, xyz.detach(), npoint,
                       mean_mst_length.detach(), cluster, int(cta_only))


def minimum_density_sample(xyz: torch.Tensor, npoint: int,
                           mean_mst_length: torch.Tensor, *, _cluster: int = 0,
                           _stage: int = STAGE) -> torch.Tensor:
    """Greedy MDS indices; see the module docstring (no gradient).
    ``_cluster`` forces the kernel's cluster size (1 is one block a cloud)
    and ``_stage`` its compaction period (0: none), for the tests; the
    picks do not depend on either."""
    xyz, mean_mst_length = xyz.detach(), mean_mst_length.detach()
    check_input("minimum_density_sample xyz", xyz, torch.float32, 3, last=3)
    b, n, _ = xyz.shape
    if mean_mst_length.shape != (b,) or mean_mst_length.device != xyz.device:
        raise ValueError("minimum_density_sample: mean_mst_length must be [B] "
                         "on xyz's device")
    if not 1 <= npoint <= n:
        raise ValueError(f"minimum_density_sample: npoint={npoint} not in [1, {n}]")
    if is_cpu(xyz):
        return mds_plain(xyz, npoint, mean_mst_length)
    lib = _lib.lib()
    if n > lib.spn_mds_max_points():
        raise ValueError(f"minimum_density_sample: the CUDA kernel takes "
                         f"N <= {lib.spn_mds_max_points()}, got {n}")
    out = _mds_launch(lib.spn_mds, xyz, npoint, mean_mst_length, _cluster,
                      _stage)
    _lib.LAUNCHES["mds"] += 1
    return out


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [B, N, C], idx [B, M] -> [B, M, C] (plain indexing)."""
    c = features.shape[-1]
    return torch.gather(features, 1, idx.long()[..., None].expand(-1, -1, c))


# ---------------------------------------------------------------------------
# serving arms
# ---------------------------------------------------------------------------

def resolve_impl(impl: str = "auto", serving: bool = False) -> str:
    """The arm ``minimum_density_sample_xyz`` runs: "auto" is "exact" in
    both modes, as the reference's dispatch resolves it on the "cpu" and
    "gpu" backends ("xla", exact greedy MDS) and takes the batched serving
    arm only on the TPU. ``serving`` names the caller's mode; "auto"
    resolves alike in both off the TPU."""
    if impl == "auto":
        return "exact"
    if impl not in MDS_IMPLS:
        raise ValueError(f"unknown MDS arm {impl!r}; expected one of "
                         f"{MDS_IMPLS} or 'auto'")
    return impl


def select_smallest_sort(temp: torch.Tensor, take: int) -> torch.Tensor:
    """The ``take`` lowest densities of each row of temp [B, N] (finite,
    >= 0): one stable sort of their int32 bit patterns with the index as
    payload, so ties go to the lower index (the reference's
    _select_smallest_sort, the "sort" arm) -> [B, take] int32 in ascending
    value order."""
    order = torch.sort(temp.view(torch.int32), dim=1, stable=True).indices
    return order[:, :take].to(torch.int32)


def select_smallest_bisect(temp: torch.Tensor, take: int) -> torch.Tensor:
    """The "bisect" arm (the reference's _select_smallest): the take-th
    smallest bit pattern by 31 count passes of a binary search over the
    int32 bit space up to bits(1e9), then the lanes below it and the
    lowest-index lanes equal to it, compacted by a cumsum and a search ->
    [B, take] int32 in ascending index order."""
    b = temp.shape[0]
    dev = temp.device
    bits = temp.contiguous().view(torch.int32)
    lo = torch.zeros((b,), dtype=torch.int32, device=dev)
    hi = torch.full((b,), _BIG_BITS, dtype=torch.int32, device=dev)
    for _ in range(31):
        mid = lo + (hi - lo) // 2
        ge = (bits <= mid[:, None]).sum(1) >= take
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    tau = lo[:, None]
    lt = bits < tau
    tie = bits == tau
    need = take - lt.sum(1, keepdim=True)
    sel = lt | (tie & (tie.cumsum(1) <= need))
    csum = sel.cumsum(1)
    targets = torch.arange(1, take + 1, dtype=csum.dtype, device=dev)
    idx = torch.searchsorted(csum, targets.expand(b, take).contiguous())
    return idx.to(torch.int32)


def select_smallest_pack16(temp: torch.Tensor, take: int) -> torch.Tensor:
    """The "pack16" arm (the reference's _select_smallest_pack16): one sort
    of unique int32 keys, the 15-bit rank ``bits >> 17`` (logical: sign,
    exponent and 6 mantissa bits) over the 15-bit lane index; picks may
    differ from the exact arms only among densities within ~2^-7 of each
    other. Rows of 2^15 lanes or more take the "sort" arm, as there ->
    [B, take] int32 in ascending key order."""
    n = temp.shape[1]
    if n >= _PACK_LANES:
        return select_smallest_sort(temp, take)
    bits = temp.contiguous().view(torch.int32)
    lane = torch.arange(n, dtype=torch.int32, device=temp.device)
    key = (((bits >> 17) & (_PACK_LANES - 1)) << 15) | lane
    return torch.sort(key, dim=1).values[:, :take] & (_PACK_LANES - 1)


# "topk" is the reference's lax.top_k(-temp): ascending temp, ties to the
# lower index, which for densities >= +0 is the stable sort of their bits
_SELECT = {"sort": select_smallest_sort, "bisect": select_smallest_bisect,
           "topk": select_smallest_sort, "pack16": select_smallest_pack16}


def select_smallest(temp: torch.Tensor, take: int,
                    select: str = "sort") -> torch.Tensor:
    """One batched round's picks by the selection arm ``select`` (the
    reference's _round_pick): "sort", "bisect" and "topk" pick the same set
    (stable top-k, ties to the lower index), each in its reference arm's
    order; "pack16" may differ at near-ties."""
    return _SELECT[check_select(select)](temp, take)


def check_select(select: str) -> str:
    if select not in SELECTS:
        raise ValueError(f"unknown MDS selection arm {select!r}; expected "
                         f"one of {SELECTS}")
    return select


def dial_state(g: int = BATCH_G, schedule=SCHEDULE,
               select: str = "sort") -> dict:
    """The batched rounds' dial as the reference's dial_state labels it:
    the round plan (the schedule, or the fixed G) and the selection arm."""
    return {"rounds": list(schedule) or f"G={g}", "select": select}


def _gather3(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.long()[..., None].expand(-1, -1, x.shape[-1]))


def _bump(x, s, kde, bias):
    """sum over picks s [B, G, 3] of exp2(2 kde <x, s> + bias - kde |s|^2)
    -> [B, N], reduced in chunks of _UPDATE_CHUNK picks. A term below the
    smallest normal f32 adds 0, as in the reference's XLA programs, which
    flush subnormals: at the flagship's temperatures most far lanes then
    tie at exactly 0, and the lowest index takes them."""
    sk = (2.0 * kde[..., None]) * s                             # [B, G, 3]
    s2k = sqdist3(s) * kde                                      # [B, G]
    tot = None
    for c0 in range(0, s.shape[1], _UPDATE_CHUNK):
        c1 = c0 + _UPDATE_CHUNK
        term = torch.bmm(x, sk[:, c0:c1].transpose(1, 2))
        term.add_(bias[..., None]).sub_(s2k[:, None, c0:c1]).exp2_()
        # keep a term > the largest subnormal, i.e. >= the smallest normal
        part = F.threshold_(term, _SUBNORMAL_MAX, 0.0).sum(2)
        tot = part if tot is None else tot + part
    return tot


def batched_terms(xyz: torch.Tensor, mean_mst_length: torch.Tensor):
    """(x f32 [B, N, 3], kde [B, 1], bias [B, N]) of the exp2 dot form:
    kde = log2(e) / (5 mml^2), bias = log2(w) - kde |x|^2."""
    x = xyz.detach().float()
    mml = mean_mst_length.detach().float()
    kde = (_L2E / (5.0 * mml * mml))[:, None]
    logw = (torch.arange(x.shape[1], device=x.device) >= _HEAVY_FROM).float()
    return x, kde, logw - sqdist3(x) * kde


def batched_update(x, temp, c, kde, bias):
    """One round's update: every density gains the bumps of the picks c
    [B, G], then the picks are pinned to 1e9."""
    temp = temp + _bump(x, _gather3(x, c), kde, bias)
    return temp.scatter_(1, c.long(), _BIG)


def _round_sizes(npoint: int, g: int, schedule) -> list[int]:
    takes, covered = [], 1
    for r in schedule or ():
        if covered >= npoint:
            break
        takes.append(min(int(r), npoint - covered))
        covered += takes[-1]
    while covered < npoint:
        takes.append(min(g, npoint - covered))
        covered += takes[-1]
    return takes


def mds_batched(xyz: torch.Tensor, npoint: int, mean_mst_length: torch.Tensor,
                g: int = BATCH_G, schedule=SCHEDULE, return_xyz: bool = False,
                return_state: bool = False, select: str = "sort"):
    """Batch-greedy MDS (the reference's _mds_batched): pick 0 is point 0;
    then rounds of sizes ``schedule`` followed by G until npoint picks, each
    round taking the lowest densities by the selection arm ``select``
    (``select_smallest``; ties to the lower index) and, unless it is the
    last (or ``return_state``), adding the
    round's bumps w * exp2(2 kde <x, s> + bias - kde |s|^2) (kde = log2(e) /
    (5 mml^2), bias = log2(w) - kde |x|^2) and pinning its picks to 1e9.
    Returns idx [B, npoint] int32, then with ``return_xyz`` the selected
    rows of xyz, then with ``return_state`` the densities [B, N]."""
    xyz = xyz.detach()
    b, n, _ = xyz.shape
    if not 1 <= npoint <= n or g < 1:
        raise ValueError(f"mds_batched: npoint={npoint}, g={g}, N={n}")
    check_select(select)
    x, kde, bias = batched_terms(xyz, mean_mst_length)
    temp = _bump(x, x[:, :1], kde, bias)
    temp[:, 0] = _BIG
    out = torch.zeros((b, npoint), dtype=torch.int32, device=x.device)
    out_xyz = None
    if return_xyz:
        out_xyz = xyz.new_zeros((b, npoint, 3))
        out_xyz[:, :1] = xyz[:, :1]
    done = 1
    for take in _round_sizes(npoint, g, schedule):
        c = select_smallest(temp, take, select)
        out[:, done:done + take] = c
        if return_xyz:
            out_xyz[:, done:done + take] = _gather3(xyz, c)
        if done + take < npoint or return_state:
            temp = batched_update(x, temp, c, kde, bias)
        done += take
    outs = (out,)
    if return_xyz:
        outs += (out_xyz,)
    if return_state:
        outs += (temp,)
    return outs if len(outs) > 1 else out


def mds_continue_plain(xyz: torch.Tensor, temp0: torch.Tensor,
                       orig: torch.Tensor, mean_mst_length: torch.Tensor,
                       steps: int) -> torch.Tensor:
    """Plain PyTorch version of the continuation kernel (the reference's
    XLA tail in _mds_hybrid): each step takes the lowest-lane argmin, pins
    it to 1e9 and adds w * exp(-d2 / t) to every density."""
    _lib.PLAIN_CALLS["mds_continue"] += 1
    b = xyz.shape[0]
    dev = xyz.device
    t = _temperature(mean_mst_length).reshape(b, 1)
    weight = torch.where(orig >= _HEAVY_FROM, 2.0, 1.0)
    temp = temp0.clone()
    rows = torch.arange(b, device=dev)
    idx = torch.zeros((b, steps), dtype=torch.int32, device=dev)
    for j in range(steps):
        nxt = temp.argmin(1)
        idx[:, j] = nxt.to(torch.int32)
        if j == steps - 1:
            break
        temp[rows, nxt] = _BIG
        e = torch.exp(-sqdist3(xyz - xyz[rows, nxt][:, None, :]) / t)
        temp = temp + weight * torch.where(e < _TINY, 0.0, e)
    return idx


def _continue_key(temp: torch.Tensor) -> torch.Tensor:
    """The continuation's argmin key in float64: NaN below -inf (argmin
    takes the first NaN before any -inf), -inf below every float."""
    key = torch.where(temp == float("-inf"), -1e308, temp.double())
    return torch.where(temp.isnan(), float("-inf"), key)


def mds_continue_partitioned(xyz: torch.Tensor, temp0: torch.Tensor,
                             orig: torch.Tensor, mean_mst_length: torch.Tensor,
                             steps: int, cluster: int,
                             stage: int = STAGE) -> torch.Tensor:
    """The continuation kernel's decomposition in plain PyTorch (for the
    tests): the lanes spread over ``cluster`` CTAs as the greedy kernel's
    points (``mds_partitioned``), the state starts at temp0 with no pending
    bump, the weights come from orig, the argmin is reduced by thread, warp,
    CTA and cluster on (density, lane) with NaN first, then -inf; the
    previous pick is pinned lazily; before kernel step s (s = 1 .. steps:
    output s - 1) with s a multiple of ``stage`` the picked lanes leave,
    where no density can turn NaN and none of temp0 reaches 5e8 (t finite
    and > 0, every coordinate finite). Equals ``mds_continue_plain``."""
    b, n, _ = xyz.shape
    dev = xyz.device
    t = _temperature(mean_mst_length).reshape(b, 1)
    weight = torch.where(orig >= _HEAVY_FROM, 2.0, 1.0)
    slot, shape = _cluster_slots(b, n, cluster, dev)
    compact = ((stage > 0) & torch.isfinite(t[:, 0]) & (t[:, 0] > 0)
               & torch.isfinite(xyz).flatten(1).all(1)
               & (temp0 < _LIVE_BELOW).all(1))
    present = torch.ones((b, n), dtype=torch.bool, device=dev)
    picked = torch.zeros((b, n), dtype=torch.bool, device=dev)
    temp = temp0.clone()
    idx = torch.zeros((b, steps), dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)
    last = None
    for j in range(steps):
        if stage > 0 and (j + 1) % stage == 0:
            present &= ~(picked & compact[:, None])
        if last is not None:
            temp[rows, last] = _BIG                            # the lazy pin
            e = torch.exp(-sqdist3(xyz - xyz[rows, last][:, None, :]) / t)
            temp = temp + weight * torch.where(e < _TINY, 0.0, e)
        nxt = _cluster_argmin(_continue_key(temp), present, slot, shape)
        picked[rows, nxt] = True
        idx[:, j] = nxt.to(torch.int32)
        last = nxt
    return idx


def continue_cluster_size(batch: int, n: int) -> tuple[int, int]:
    """(C, CTAs an SM): the launch shape the continuation kernel takes for
    ``batch`` clouds of ``n`` live lanes on the current card."""
    out = (ctypes.c_int * 2)()
    _lib.lib().spn_mds_continue_shape(batch, n, out)
    return out[0], out[1]


def _continue_launch(fn, xyz, temp0, orig, mean_mst_length, steps, *extra):
    b, n, _ = xyz.shape
    t = _temperature(mean_mst_length.to(torch.float32)).contiguous()
    out = torch.empty((b, steps), dtype=torch.int32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        code = fn(xyz.data_ptr(), temp0.data_ptr(), orig.data_ptr(),
                  t.data_ptr(), b, n, steps, *extra, out.data_ptr(),
                  _lib.stream_of(xyz))
    _lib.check(code, "mds_continue")
    return out


def mds_continue_floor(xyz: torch.Tensor, temp0: torch.Tensor,
                       orig: torch.Tensor, mean_mst_length: torch.Tensor,
                       steps: int, cluster: int) -> torch.Tensor:
    """The continuation kernel's chain of ``steps`` steps at cluster size
    ``cluster`` with no lane pass (its barriers and record exchanges only),
    for timing its latency floor; its output is not picks. CUDA only."""
    return _continue_launch(_lib.lib().spn_mds_continue_floor, xyz.detach(),
                            temp0.detach(), orig, mean_mst_length.detach(),
                            steps, cluster)


def mds_continue(xyz: torch.Tensor, temp0: torch.Tensor, orig: torch.Tensor,
                 mean_mst_length: torch.Tensor, steps: int, *,
                 _cluster: int = 0, _stage: int = STAGE) -> torch.Tensor:
    """Greedy MDS continued for ``steps`` picks on live lanes: xyz [B, N, 3],
    temp0 [B, N] f32 densities with every earlier bump applied, orig [B, N]
    int32 original indices (>= 8192: weight 2), mean_mst_length [B] -> lane
    indices [B, steps] int32 (no gradient). Raises at N or steps beyond the
    kernel's limits; there is no fallback. ``_cluster`` forces the kernel's
    cluster size and ``_stage`` its compaction period (0: none), for the
    tests; the picks do not depend on either."""
    xyz, temp0 = xyz.detach(), temp0.detach()
    mean_mst_length = mean_mst_length.detach()
    check_input("mds_continue xyz", xyz, torch.float32, 3, last=3)
    check_input("mds_continue temp0", temp0, torch.float32, 2)
    check_input("mds_continue orig", orig, torch.int32, 2)
    b, n, _ = xyz.shape
    if temp0.shape != (b, n) or orig.shape != (b, n):
        raise ValueError("mds_continue: temp0 and orig must be [B, N]")
    if mean_mst_length.shape != (b,) or len({t.device for t in (
            xyz, temp0, orig, mean_mst_length)}) != 1:
        raise ValueError("mds_continue: mean_mst_length must be [B] on xyz's "
                         "device, as temp0 and orig")
    if not 1 <= steps <= n:
        raise ValueError(f"mds_continue: steps={steps} not in [1, {n}]")
    if is_cpu(xyz):
        return mds_continue_plain(xyz, temp0, orig, mean_mst_length, steps)
    lib = _lib.lib()
    if (n > lib.spn_mds_continue_max_points()
            or steps > lib.spn_mds_continue_max_steps()):
        raise ValueError(f"mds_continue: the CUDA kernel takes N <= "
                         f"{lib.spn_mds_continue_max_points()} and steps <= "
                         f"{lib.spn_mds_continue_max_steps()}, got N={n}, "
                         f"steps={steps}")
    out = _continue_launch(lib.spn_mds_continue, xyz, temp0, orig,
                           mean_mst_length, steps, _cluster, _stage)
    _lib.LAUNCHES["mds_continue"] += 1
    return out


def compact_live(xyz: torch.Tensor, temp: torch.Tensor, nlive: int):
    """The lanes not pinned (density < 5e8) of each row, in their order (a
    stable sort on the picked flag): (xyz [B, nlive, 3] f32, temp
    [B, nlive], orig [B, nlive] int32)."""
    order = torch.sort((temp >= _BIG / 2).to(torch.int32), dim=1,
                       stable=True).indices[:, :nlive]
    return (_gather3(xyz.float(), order).contiguous(),
            temp.gather(1, order).contiguous(), order.to(torch.int32))


def mds_hybrid(xyz: torch.Tensor, npoint: int, mean_mst_length: torch.Tensor,
               g: int = BATCH_G, tail: int = TAIL, return_xyz: bool = False,
               select: str = "sort"):
    """Batched prefix of npoint - tail picks (fixed G, no schedule, every
    bump applied, the selection arm ``select``), its picked lanes compacted
    out, then ``tail`` exact greedy picks on the live lanes (the reference's
    _mds_hybrid). Returns idx [B, npoint] int32 (and, with ``return_xyz``,
    the selected rows)."""
    b, n, _ = xyz.shape
    tail = int(min(tail, npoint - 1))
    if tail <= 0:
        return mds_batched(xyz, npoint, mean_mst_length, g=g, schedule=(),
                           return_xyz=return_xyz, select=select)
    npick = npoint - tail
    pref = mds_batched(xyz, npick, mean_mst_length, g=g, schedule=(),
                       return_xyz=return_xyz, return_state=True, select=select)
    xyz_c, temp_c, orig = compact_live(xyz.detach(), pref[-1], n - npick)
    lanes = mds_continue(xyz_c, temp_c, orig, mean_mst_length, tail)
    out_tail = orig.gather(1, lanes.long())
    out = torch.cat([pref[0], out_tail], 1)
    if not return_xyz:
        return out
    return out, torch.cat([pref[1], _gather3(xyz.detach(), out_tail)], 1)


def minimum_density_sample_xyz(xyz: torch.Tensor, npoint: int,
                               mean_mst_length: torch.Tensor,
                               impl: str = "exact", g: int = BATCH_G,
                               schedule=SCHEDULE, tail: int = TAIL,
                               select: str = "sort"):
    """(idx [B, npoint] int32, the selected rows of xyz [B, npoint, 3]) by
    the arm ``impl`` (see ``resolve_impl``; G, schedule and the selection
    arm ``select`` drive the batched rounds, G, select and tail the
    hybrid's). The batched arms assemble the rows from the gathers their
    rounds make anyway."""
    impl = resolve_impl(impl)
    if impl == "batched":
        return mds_batched(xyz, npoint, mean_mst_length, g=g,
                           schedule=schedule, return_xyz=True, select=select)
    if impl == "hybrid":
        return mds_hybrid(xyz, npoint, mean_mst_length, g=g, tail=tail,
                          return_xyz=True, select=select)
    idx = minimum_density_sample(xyz.contiguous(), npoint, mean_mst_length)
    return idx, gather_points(xyz.detach(), idx)
