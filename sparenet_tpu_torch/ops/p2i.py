"""Zero-background max splat of points into images (counterpart of
sparenet_tpu/ops/p2i.py:p2i_max_zbg and ops/pallas/p2i_pallas.py).

``p2i_max(points, feats, binds, b, h, w, radius, with_ids)``: points [P, 2]
f32 in (y, x) pixels, feats [P, 1] f32, binds [P] int32 (the image of each
point) -> (out [B, H, W, 1] f32, ids [B, H, W, 1] int32 or None). Every pixel
within r <= radius of a point takes the max of f * w(r), with w the cosine
kernel cos(pi r / R) / 2 + 1/2 as the Taylor series ``cos_weight_sq`` in
(r / R)^2; a pixel is updated only where a value is strictly above the zero
background, and on an exact tie the lowest point id wins; ids is -1 where
nothing won. Points whose image index is outside [0, B) are dropped. On a
CUDA tensor it launches ``csrc/p2i.cu``; on a CPU tensor it runs
``p2i_max_plain``. The kernel bins the points by image tile (``TILE``
pixels, a counting sort on the card), splats each tile in shared memory
from work items of about ``ITEM_PIXELS`` window pixels, and merges a tile
through global memory only where its bin fills more than one item;
``p2i_tiles_plain`` is that decomposition in plain PyTorch (for the tests;
no path runs it).

``p2i_max_zbg(points, feats, binds, b, h, w, radius)`` -> out, differentiable
in points and feats: a render that is differentiated launches the variant
with ids, any other the values-only one. Its backward is the JAX package's
``_p2i_max_bwd`` (XLA there too): the gradient of each pixel goes to its
winner's feature through w, and to its (y, x) through
dw/dr = -(pi / 2R) sin(pi r / R), with the reference's max(r, 1e-10) guard.
``p2i_max_backward`` launches ``spn_p2i_max_backward`` on a CUDA tensor
(counted as ``"p2i_bwd"``): the points binned by the tile that holds their
window's clipped origin, then a block a work item of a bin's points reads
the tile's ids and a halo of K - 1 rows and columns once and sets each won
pixel's bit in its point's window bitmask in shared memory; a scan of the
bitmasks places every hit, a thread a hit computes its terms, and a thread
a point adds its terms in row-major order, deterministic with no atomics
on floats (``bwd_plan`` picks the tile, the item and, for windows whose
bitmask does not fit, a scan of each window by a warp); on a CPU
tensor it runs ``p2i_max_backward_plain``, which scatters every pixel into
its winner. ``p2i_bwd_tiles_plain`` is the kernel's decomposition in plain
PyTorch (for the tests; no path runs it).

Rounding follows the JAX package's XLA path bit for bit (its CPU program
computes r as sqrt(dy * dy + dx * dx) without fma, the division by R as a
product with the f32 reciprocal, and the Horner steps as fma), not the Pallas
kernel's r^2 <= R^2 form, which differs in the last bit.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _lib
from .common import check_input, fma, is_cpu, sqrt_ieee

__all__ = ["COS_COEFFS", "cos_weight_sq", "window_size", "p2i_max",
           "p2i_max_plain", "p2i_tiles_plain", "TILE", "ITEM_PIXELS",
           "item_entries", "p2i_max_backward", "p2i_max_backward_plain",
           "p2i_bwd_tiles_plain", "bwd_plan", "p2i_max_zbg", "p2i_sum",
           "p2i_max_bg", "p2i"]

# cos(pi sqrt(s)) / 2 + 1/2 = 1 + sum_k c_k s^k, c_k = (-1)^k pi^2k / (2 (2k)!),
# k = 1 .. 10, rounded to f32 (the JAX package's _COS_COEFFS)
COS_COEFFS = tuple(float(np.float32(0.5 * (-1.0) ** k * math.pi ** (2 * k)
                                    / math.factorial(2 * k)))
                   for k in range(1, 11))
# plain versions expand at most this many window pixels at once
_CHUNK_BUDGET = 1 << 23
# the splat kernel's tiles (rows, columns; columns a multiple of 32) and the
# window pixels of its work items
TILE = (32, 128)
ITEM_PIXELS = 1 << 16
def window_size(radius: float) -> int:
    """Side K of the square pixel window a point visits: floor(p - R) ..
    floor(p - R) + K - 1 covers every pixel within R."""
    return 2 * int(math.ceil(radius)) + 2


def item_entries(radius: float, tile=TILE, item_pixels: int = ITEM_PIXELS) -> int:
    """(point, tile) entries a work item of the splat kernel holds: about
    ``item_pixels`` pixels of windows clipped to a tile."""
    k = window_size(radius)
    return max(1, item_pixels // (min(k, tile[0]) * min(k, tile[1])))


def bwd_plan(radius: float, tile=None, item: int | None = None,
             path: str | None = None) -> dict:
    """The backward kernel's plan at ``radius``, chosen by the kernel
    library (csrc/p2i.cu:spn_p2i_bwd_plan, beside the shared-memory layout
    it sizes; so on a machine that builds the kernels): "path", "bits" (a
    window bitmask of ``words`` ints a point, room for ``hits`` hits a
    round, ``smem`` bytes a block) or "scan" (words 0); "tile"; and "item",
    the points a work item. ``tile``, ``item`` and ``path`` ("scan") force
    them."""
    out = (ctypes.c_longlong * 6)()
    th, tw = tile or (0, 0)
    _lib.lib().spn_p2i_bwd_plan(window_size(radius), th, tw, item or 0,
                                int(path == "scan"), out)
    words, th, tw, n, hits, smem = out
    return {"path": "bits" if words else "scan", "tile": (th, tw),
            "words": words, "item": n, "hits": hits, "smem": smem}


def cos_weight_sq(s: torch.Tensor) -> torch.Tensor:
    """1 + sum_k c_k s^k by Horner with one rounding a step (fma)."""
    w = torch.full_like(s, COS_COEFFS[-1])
    for c in COS_COEFFS[-2::-1]:
        w = fma(w, s, torch.full_like(s, c))
    return fma(w, s, torch.ones_like(s))


def _weight(r: torch.Tensor, radius: float) -> torch.Tensor:
    inv = 1.0 / torch.tensor(radius, dtype=torch.float32)
    s = r * inv.to(r.device)
    return cos_weight_sq(s * s)


def _window_terms(points: torch.Tensor, radius: float, h: int, w: int):
    """Candidate pixels of each point, as the JAX package's ``_window``:
    (rows [P, K, 1], columns [P, 1, K], dy, dx and r [P, K, K], valid
    [P, K, K])."""
    k = window_size(radius)
    rad = torch.tensor(radius, dtype=torch.float32, device=points.device)
    base = torch.floor(points - rad).to(torch.int32)          # [P, 2]
    offs = torch.arange(k, dtype=torch.int32, device=points.device)
    py = (base[:, 0:1] + offs)[:, :, None]                    # [P, K, 1]
    px = (base[:, 1:2] + offs)[:, None, :]                    # [P, 1, K]
    dy = py.float() - points[:, 0, None, None]
    dx = px.float() - points[:, 1, None, None]
    r = sqrt_ieee(dy * dy + dx * dx)                          # [P, K, K]
    valid = (py >= 0) & (py < h) & (px >= 0) & (px < w) & (r <= rad)
    return py, px, dy, dx, r, valid


def _window(points: torch.Tensor, radius: float, h: int, w: int):
    """Candidate pixels of each point: (pixel index within its image
    [P, K, K], weight w(r) [P, K, K], valid [P, K, K])."""
    py, px, _, _, r, valid = _window_terms(points, radius, h, w)
    return py * w + px, _weight(r, radius), valid


def _chunks(p: int, radius: float):
    k = window_size(radius)
    step = max(1, _CHUNK_BUDGET // (k * k))
    return [slice(i, min(p, i + step)) for i in range(0, p, step)]


def p2i_max_plain(points, feats, binds, b: int, h: int, w: int, radius: float,
                  with_ids: bool = True):
    """Plain PyTorch version of the p2i kernel (the JAX package's
    _p2i_max_forward): windowed contributions in point chunks, a scatter
    max for the values, then the lowest winning point id where wv >= out
    and wv > 0."""
    _lib.PLAIN_CALLS["p2i"] += 1
    n_pix = b * h * w
    dev = points.device
    out = torch.zeros(n_pix + 1, dtype=torch.float32, device=dev)  # +1: drop
    parts = []
    for sl in _chunks(points.shape[0], radius):
        pix, weight, valid = _window(points[sl], radius, h, w)
        bi = binds[sl].long()[:, None, None]
        valid = valid & (bi >= 0) & (bi < b)
        idx = torch.where(valid, bi * (h * w) + pix, n_pix).reshape(-1)
        wv = (weight * feats[sl, 0, None, None]).reshape(-1)
        out.scatter_reduce_(0, idx, wv, reduce="amax", include_self=True)
        parts.append((sl, idx, wv))
    if not with_ids:
        return out[:n_pix].reshape(b, h, w, 1), None
    big = torch.iinfo(torch.int64).max
    ids = torch.full((n_pix + 1,), big, dtype=torch.int64, device=dev)
    for sl, idx, wv in parts:
        win = (wv >= out[idx]) & (wv > 0) & (idx < n_pix)
        k2 = idx.numel() // (sl.stop - sl.start)
        pid = torch.arange(sl.start, sl.stop, device=dev).repeat_interleave(k2)
        ids.scatter_reduce_(0, torch.where(win, idx, n_pix),
                            torch.where(win, pid, big), reduce="amin",
                            include_self=True)
    ids = torch.where(ids == big, -1, ids)[:n_pix].to(torch.int32)
    return out[:n_pix].reshape(b, h, w, 1), ids.reshape(b, h, w, 1)


def p2i_tiles_plain(points, feats, binds, b: int, h: int, w: int,
                    radius: float, with_ids: bool = True, tile=TILE,
                    per_item: int | None = None, seed: int = 0):
    """The splat kernel's decomposition in plain PyTorch (for the tests):
    every (point, tile) pair whose window, clipped to the image, overlaps
    the tile goes to the tile's bin, in an order drawn from ``seed`` (the
    kernel's order within a bin is whatever its atomics give); each bin's
    entries split into work items of ``per_item`` (at least one item a
    bin, so an empty tile is written too); each item takes the max of the
    packed keys (value bits << 32 | 0xFFFFFFFF - id, for values > 0) of its
    entries' windows clipped to its tile; a bin of one item writes its tile,
    the items of a split bin merge by max first. Pixels start as NaN and -2,
    so a pixel no tile wrote shows. Equals ``p2i_max_plain``."""
    th, tw = tile
    k = window_size(radius)
    per_item = per_item or item_entries(radius, tile)
    nty, ntx = -(-h // th), -(-w // tw)
    nbins = b * nty * ntx
    # 1. bin: the window's origin floor(p - R), clamped as the kernel does
    o = torch.floor(points - torch.tensor(radius, dtype=torch.float32))
    o = torch.where(o.isnan(), float(-k), o)
    o = torch.minimum(torch.maximum(o, torch.tensor(float(-k))),
                      torch.tensor([float(h), float(w)])).long()
    y0, y1 = o[:, 0].clamp_min(0), (o[:, 0] + k).clamp_max(h)
    x0, x1 = o[:, 1].clamp_min(0), (o[:, 1] + k).clamp_max(w)
    bi = binds.long()
    ok = (bi >= 0) & (bi < b) & (y0 < y1) & (x0 < x1)
    ty0, ty1 = y0 // th, (y1 - 1) // th
    tx0, tx1 = x0 // tw, (x1 - 1) // tw
    pid, bins = [], []
    for dy in range((k - 1) // th + 2):
        for dx in range((k - 1) // tw + 2):
            sel = ok & (ty0 + dy <= ty1) & (tx0 + dx <= tx1)
            pid.append(torch.nonzero(sel)[:, 0])
            bins.append((bi * nty * ntx + (ty0 + dy) * ntx + tx0 + dx)[sel])
    pid, bins = torch.cat(pid), torch.cat(bins)
    # a counting sort: the order within a bin drawn from the seed
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(len(bins), generator=g)
    pid, bins = pid[perm], bins[perm]
    order = torch.sort(bins, stable=True).indices
    pid, bins = pid[order], bins[order]
    counts = torch.bincount(bins, minlength=nbins)
    off = torch.cumsum(counts, 0) - counts
    items = torch.clamp_min(-(-counts // per_item), 1)
    item_off = torch.cumsum(items, 0) - items
    rank = torch.arange(len(bins)) - off[bins]
    item = item_off[bins] + rank // per_item
    # 2. each item's tile: its entries' windows clipped to the tile
    keys = torch.zeros((int(items.sum()), th * tw), dtype=torch.int64)
    tile_y = (bins % (nty * ntx)) // ntx * th
    tile_x = (bins % ntx) * tw
    if len(pid):
        pix, weight, valid = _window(points[pid], radius, h, w)
        py, px = pix // w, pix % w
        valid = (valid & (py >= tile_y[:, None, None])
                 & (py < tile_y[:, None, None] + th)
                 & (px >= tile_x[:, None, None])
                 & (px < tile_x[:, None, None] + tw))
        wv = weight * feats[pid, 0, None, None]
        valid = valid & (wv > 0)
        bits = wv.contiguous().view(torch.int32).long()
        key = (bits << 32) | (0xFFFFFFFF - pid[:, None, None])
        local = ((py - tile_y[:, None, None]) * tw
                 + px - tile_x[:, None, None])
        slot = item[:, None, None] * (th * tw) + local
        keys.view(-1).scatter_reduce_(0, slot[valid], key[valid], reduce="amax",
                                      include_self=True)
    # 3. a bin of one item writes its tile; a split bin's items merge first
    merged = torch.zeros((nbins, th * tw), dtype=torch.int64)
    item_bin = torch.repeat_interleave(torch.arange(nbins), items)
    merged.scatter_reduce_(0, item_bin[:, None].expand_as(keys), keys, "amax",
                           include_self=True)
    out = torch.full((b, h, w), float("nan"))
    ids = torch.full((b, h, w), -2, dtype=torch.int32)
    for t in range(nbins):
        img, r = divmod(t, nty * ntx)
        ys, xs = (r // ntx) * th, (r % ntx) * tw
        ye, xe = min(ys + th, h), min(xs + tw, w)
        kt = merged[t].view(th, tw)[:ye - ys, :xe - xs]
        out[img, ys:ye, xs:xe] = (kt >> 32).to(torch.int32).view(torch.float32)
        ids[img, ys:ye, xs:xe] = torch.where(
            kt != 0, 0xFFFFFFFF - (kt & 0xFFFFFFFF), -1).to(torch.int32)
    return out[..., None], (ids[..., None] if with_ids else None)


def p2i_max(points, feats, binds, b: int, h: int, w: int, radius: float,
            with_ids: bool = True, *, _tile=TILE,
            _item_pixels: int = ITEM_PIXELS):
    """(out, ids or None); see the module docstring. ``_tile`` and
    ``_item_pixels`` set the kernel's tile and work-item size, for the tests
    and for tuning; the result does not depend on them."""
    points, feats = points.detach(), feats.detach()
    check_input("p2i points", points, torch.float32, 2, last=2)
    check_input("p2i feats", feats, torch.float32, 2, last=1)
    check_input("p2i binds", binds, torch.int32, 1)
    if not (points.shape[0] == feats.shape[0] == binds.shape[0]):
        raise ValueError("p2i: points, feats and binds differ in length")
    if points.device != feats.device or points.device != binds.device:
        raise ValueError("p2i: points, feats and binds differ in device")
    if not radius > 0 or min(b, h, w) < 1:
        raise ValueError(f"p2i: radius {radius}, images {b} x {h} x {w}")
    if is_cpu(points):
        return p2i_max_plain(points, feats, binds, b, h, w, radius, with_ids)
    if points.shape[0] >= 2**31 or b * h * w >= 2**31:
        raise ValueError("p2i: more than 2^31 points or pixels")
    dev = points.device
    lib = _lib.lib()
    k = window_size(radius)
    th, tw = _tile
    n_scratch = lib.spn_p2i_scratch_ints(points.shape[0], b, h, w, k, th, tw)
    if n_scratch < 0:
        raise ValueError(f"p2i: the kernel refuses tiles {_tile} for "
                         f"{points.shape[0]} points, images {b} x {h} x {w}, "
                         f"radius {radius}")
    out = torch.empty((b, h, w, 1), dtype=torch.float32, device=dev)
    scratch = torch.empty((n_scratch,), dtype=torch.int32, device=dev)
    ids = merge = None
    if with_ids:
        ids = torch.empty((b, h, w, 1), dtype=torch.int32, device=dev)
        merge = torch.empty((b * h * w,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        code = lib.spn_p2i_max(
            points.data_ptr(), feats.data_ptr(), binds.data_ptr(),
            points.shape[0], b, h, w, float(radius), k, th, tw,
            item_entries(radius, _tile, _item_pixels), out.data_ptr(),
            ids.data_ptr() if with_ids else None, scratch.data_ptr(),
            merge.data_ptr() if with_ids else None, _lib.stream_of(points))
    _lib.check(code, "p2i_max")
    _lib.LAUNCHES["p2i"] += 1
    return out, ids


def _pixel_terms(points, feats, ids, g, radius: float):
    """Each pixel's gradient terms for its winner: (winner index [B*H*W],
    P where no point won; d feat, d y, d x terms [B*H*W]), the JAX
    package's _p2i_max_bwd arithmetic."""
    b, h, w, _ = g.shape
    p = points.shape[0]
    dev = g.device
    won = ids >= 0
    safe = torch.where(won, ids, 0).long()
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    dy = yy - points[:, 0][safe]
    dx = xx - points[:, 1][safe]
    r = sqrt_ieee(dy * dy + dx * dx)
    gm = g * won
    sid = torch.where(won, safe, p).reshape(-1)
    kfac = (gm * feats[safe, 0] * torch.sin(r * math.pi / radius)
            * 0.5 * math.pi / radius / r.clamp_min(1e-10))
    return (sid, (gm * _weight(r, radius)).reshape(-1),
            (kfac * dy).reshape(-1), (kfac * dx).reshape(-1))


def p2i_max_backward_plain(points, feats, binds, ids, g, radius: float):
    """Plain PyTorch version of the backward kernel: gradients (points
    [P, 2], feats [P, 1]) of sum(g * out) for the winner ids [B, H, W, 1]
    (the JAX package's _p2i_max_bwd; ``binds`` is not needed here, the ids
    name each pixel's point)."""
    _lib.PLAIN_CALLS["p2i_bwd"] += 1
    p = points.shape[0]
    sid, tf, ty, tx = _pixel_terms(points, feats, ids, g, radius)
    pf = torch.zeros(p + 1, 1, dtype=g.dtype, device=g.device).index_add_(
        0, sid, tf[:, None])[:p]
    pt = torch.zeros(p + 1, 2, dtype=g.dtype, device=g.device).index_add_(
        0, sid, torch.stack([ty, tx], -1))[:p]
    return pt, pf


def p2i_bwd_tiles_plain(points, feats, binds, ids, g, radius: float,
                        tile=(16, 64), item: int = 300, path: str = "bits",
                        seed: int = 0):
    """The backward kernel's decomposition in plain PyTorch (for the tests):
    each point with a valid image index and a window (clamped as the
    kernel's, then clipped to the image) goes to the bin of the tile holding
    the window's origin, in an order drawn from ``seed``, its place kept;
    the bins split into work items of ``item`` points (the kernel's plan,
    ``bwd_plan``, at the GAN's radii: 16 x 64 tiles, 283-300 points an
    item, the bitmask path). On the bitmask ("bits") path each item reads its tile's ids and K - 1 more rows and columns
    (clipped to the image), and a pixel whose id names a point of the item
    (by its place) and lies in that point's window sets the point's bit for
    (row, column) of the window; each point then adds the terms of its bits
    in row-major order, from +0. On the scan path each point reads its
    window's ids in the same order. Other points get zeros. Equals
    ``p2i_max_backward_plain`` on the CPU, whose index_add_ sums each
    point's pixels in pixel order."""
    b, h, w, _ = g.shape
    p = points.shape[0]
    k = window_size(radius)
    th, tw = tile
    nty, ntx = -(-h // th), -(-w // tw)
    nbins = b * nty * ntx
    _, tf, ty, tx = _pixel_terms(points, feats, ids, g, radius)
    # 1. bin by the clipped window origin (the kernel's window_of)
    o = torch.floor(points - torch.tensor(radius, dtype=torch.float32))
    o = torch.where(o.isnan(), float(-k), o)
    o = torch.minimum(torch.maximum(o, torch.tensor(float(-k))),
                      torch.tensor([float(h), float(w)])).long()
    y0, y1 = o[:, 0].clamp_min(0), (o[:, 0] + k).clamp_max(h)
    x0, x1 = o[:, 1].clamp_min(0), (o[:, 1] + k).clamp_max(w)
    bi = binds.long()
    ok = (bi >= 0) & (bi < b) & (y0 < y1) & (x0 < x1)
    pid = torch.nonzero(ok)[:, 0]
    bins = ((bi * nty + y0 // th) * ntx + x0 // tw)[pid]
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(len(pid), generator=gen)
    pid, bins = pid[perm], bins[perm]
    order = torch.sort(bins, stable=True).indices
    pid, bins = pid[order], bins[order]                 # entries
    pos = torch.full((p,), -1, dtype=torch.long)
    pos[pid] = torch.arange(len(pid))
    counts = torch.bincount(bins, minlength=nbins)
    off = torch.cumsum(counts, 0) - counts
    n_items = -(-counts // item)
    # 2. each point's won pixels, as (row, column) of its window
    won = torch.zeros((len(pid), k, k), dtype=torch.bool)
    flat = ids.reshape(b, h, w)
    if path == "bits":
        for t in torch.nonzero(counts)[:, 0].tolist():
            img, rest = divmod(t, nty * ntx)
            ys, xs = (rest // ntx) * th, (rest % ntx) * tw
            yy, xx = torch.meshgrid(torch.arange(ys, min(ys + th + k - 1, h)),
                                    torch.arange(xs, min(xs + tw + k - 1, w)),
                                    indexing="ij")
            q = flat[img, yy, xx].long()
            q_ok = (q >= 0) & (q < p)
            e = torch.where(q_ok, pos[q.clamp(0, max(p - 1, 0))], -1)
            for i in range(int(n_items[t])):            # the bin's items
                first = int(off[t]) + i * item
                last = min(int(off[t] + counts[t]), first + item)
                j = e.clamp_min(0)
                hit = (q_ok & (e >= first) & (e < last)
                       & (yy >= y0[pid[j]]) & (yy < y1[pid[j]])
                       & (xx >= x0[pid[j]]) & (xx < x1[pid[j]]))
                won[j[hit], (yy - y0[pid[j]])[hit], (xx - x0[pid[j]])[hit]] = True
    else:
        r = torch.arange(k)
        iy = (y0[pid, None] + r).clamp_max(h - 1)
        ix = (x0[pid, None] + r).clamp_max(w - 1)
        inside = ((y0[pid, None, None] + r[:, None] < y1[pid, None, None])
                  & (x0[pid, None, None] + r < x1[pid, None, None]))
        won = inside & (flat[bi[pid, None, None], iy[:, :, None], ix[:, None, :]]
                        == pid[:, None, None])
    # 3. the sums, in row-major order from +0
    zero = torch.zeros(())
    base = bi[pid] * (h * w)
    af, ay, ax = (torch.zeros(len(pid)) for _ in range(3))
    for r in range(k):
        for c in range(k):
            pix = base + ((y0[pid] + r) * w + x0[pid] + c).clamp(0, h * w - 1)
            hit = won[:, r, c]
            af = af + torch.where(hit, tf[pix], zero)
            ay = ay + torch.where(hit, ty[pix], zero)
            ax = ax + torch.where(hit, tx[pix], zero)
    pt = torch.zeros(p, 2)
    pf = torch.zeros(p, 1)
    pt[pid] = torch.stack([ay, ax], -1)
    pf[pid, 0] = af
    return pt, pf


def p2i_max_backward(points, feats, binds, ids, g, radius: float, *,
                     _tile=None, _item: int | None = None,
                     _path: str | None = None):
    """(d points [P, 2], d feats [P, 1]) of sum(g * out) for the winner ids
    [B, H, W, 1] of a splat of points, feats and binds; see the module
    docstring. ``_tile``, ``_item`` and ``_path`` set the kernel's tile,
    work-item size and path (``bwd_plan``), for the tests and for tuning;
    the result does not depend on them."""
    check_input("p2i backward ids", ids, torch.int32, 4, last=1)
    check_input("p2i backward g", g, torch.float32, 4, last=1)
    if ids.shape != g.shape or ids.device != g.device:
        raise ValueError("p2i backward: ids and g differ in shape or device")
    if is_cpu(g):
        return p2i_max_backward_plain(points, feats, binds, ids, g, radius)
    b, h, w, _ = g.shape
    p = points.shape[0]
    gpt = torch.empty((p, 2), dtype=torch.float32, device=g.device)
    gpf = torch.empty((p, 1), dtype=torch.float32, device=g.device)
    if p == 0:
        return gpt, gpf
    lib = _lib.lib()
    plan = bwd_plan(radius, _tile, _item, _path)
    th, tw = plan["tile"]
    n_scratch = lib.spn_p2i_bwd_scratch_ints(p, b, h, w, th, tw, plan["item"])
    if n_scratch < 0:
        raise ValueError(f"p2i backward: the kernel refuses tiles {(th, tw)} "
                         f"for {p} points, images {b} x {h} x {w}")
    scratch = torch.empty((n_scratch,), dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        code = lib.spn_p2i_max_backward(
            points.contiguous().data_ptr(), feats.contiguous().data_ptr(),
            binds.contiguous().data_ptr(), ids.data_ptr(), g.data_ptr(), p, b,
            h, w, float(radius), window_size(radius), th, tw, plan["item"],
            plan["words"], plan["hits"], scratch.data_ptr(), gpt.data_ptr(),
            gpf.data_ptr(), _lib.stream_of(g))
    _lib.check(code, "p2i_max_backward")
    _lib.LAUNCHES["p2i_bwd"] += 1
    return gpt, gpf


class _P2iMaxZbg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, feats, binds, b, h, w, radius):
        out, ids = p2i_max(points, feats, binds, b, h, w, radius, True)
        ctx.save_for_backward(points, feats, binds, ids)
        ctx.radius = radius
        return out

    @staticmethod
    def backward(ctx, g):
        points, feats, binds, ids = ctx.saved_tensors
        pt, pf = p2i_max_backward(points, feats, binds, ids, g.contiguous(),
                                  ctx.radius)
        return pt, pf, None, None, None, None, None


def p2i_max_zbg(points, feats, binds, b: int, h: int, w: int,
                radius: float) -> torch.Tensor:
    """Differentiable zero-background max splat -> [B, H, W, 1]; see the
    module docstring."""
    if not (torch.is_grad_enabled()
            and (points.requires_grad or feats.requires_grad)):
        return p2i_max(points, feats, binds, b, h, w, float(radius), False)[0]
    return _P2iMaxZbg.apply(points, feats, binds, b, h, w, float(radius))


# ---------------------------------------------------------------------------
# the general splats over a background (the JAX package's p2i_sum, p2i_max
# and p2i; XLA there, stock PyTorch ops here, on either device)
# ---------------------------------------------------------------------------

def _check_general(points, feats, binds, background):
    check_input("p2i points", points, torch.float32, 2, last=2)
    check_input("p2i feats", feats, torch.float32, 2)
    check_input("p2i binds", binds, torch.int32, 1)
    check_input("p2i background", background, torch.float32, 4,
                last=feats.shape[1])
    if not (points.shape[0] == feats.shape[0] == binds.shape[0]):
        raise ValueError("p2i: points, feats and binds differ in length")


def _slots(points, binds, radius: float, b: int, h: int, w: int, sl):
    """A chunk's window: (pixel slot [p, K, K] in the flattened images,
    B * H * W where invalid or out of the batch; dy, dx, r, valid)."""
    py, px, dy, dx, r, valid = _window_terms(points[sl], radius, h, w)
    bi = binds[sl].long()[:, None, None]
    valid = valid & (bi >= 0) & (bi < b)
    slot = torch.where(valid, bi * (h * w) + py * w + px, b * h * w)
    return slot, dy, dx, r, valid


def _slope(r: torch.Tensor, radius: float) -> torch.Tensor:
    """-dw/dr / r: (pi / 2R) sin(pi r / R) / max(r, 1e-10)."""
    return (torch.sin(r * math.pi / radius) * 0.5 * math.pi / radius
            / r.clamp_min(1e-10))


def _sum_forward(points, feats, binds, background, radius: float):
    b, h, w, c = background.shape
    n_pix = b * h * w
    out = torch.cat([background.reshape(n_pix, c),
                     background.new_zeros(1, c)])             # +1: drop
    for sl in _chunks(points.shape[0], radius):
        slot, _, _, r, valid = _slots(points, binds, radius, b, h, w, sl)
        wv = (_weight(r, radius) * valid)[..., None] * feats[sl, None, None, :]
        out.index_add_(0, slot.reshape(-1), wv.reshape(-1, c))
    return out[:n_pix].reshape(b, h, w, c)


def _sum_backward(points, feats, binds, g, radius: float):
    """The JAX package's _p2i_sum_bwd: (d points [P, 2], d feats [P, C])."""
    b, h, w, c = g.shape
    gf = torch.cat([g.reshape(-1, c), g.new_zeros(1, c)])
    d_pt, d_pf = [], []
    for sl in _chunks(points.shape[0], radius):
        slot, dy, dx, r, valid = _slots(points, binds, radius, b, h, w, sl)
        og = gf[slot] * valid[..., None]                      # [p, K, K, C]
        d_pf.append((og * _weight(r, radius)[..., None]).sum((1, 2)))
        kfac = ((og * feats[sl, None, None, :]).sum(-1)
                * _slope(r, radius)) * valid
        d_pt.append(torch.stack([(kfac * dy).sum((1, 2)),
                                 (kfac * dx).sum((1, 2))], -1))
    return torch.cat(d_pt), torch.cat(d_pf)


def _max_forward(points, feats, binds, background, radius: float):
    """The JAX package's _p2i_max_forward: (out [B, H, W, C], winner ids
    [B, H, W, C] int64, -1 where the background stays): the lowest point id
    among those whose value is >= the pixel's max and > its background."""
    b, h, w, c = background.shape
    n = b * h * w * c
    bg = torch.cat([background.reshape(-1), background.new_zeros(1)])
    out = bg.clone()
    ch = torch.arange(c, device=points.device)
    parts = []
    for sl in _chunks(points.shape[0], radius):
        slot, _, _, r, valid = _slots(points, binds, radius, b, h, w, sl)
        wv = _weight(r, radius)[..., None] * feats[sl, None, None, :]
        idx = torch.where(valid[..., None], slot[..., None] * c + ch, n)
        out.scatter_reduce_(0, idx.reshape(-1), wv.reshape(-1), reduce="amax",
                            include_self=True)
        parts.append((sl, idx.reshape(-1), wv.reshape(-1)))
    big = torch.iinfo(torch.int64).max
    ids = torch.full((n + 1,), big, dtype=torch.int64, device=points.device)
    for sl, idx, wv in parts:
        win = (wv >= out[idx]) & (wv > bg[idx]) & (idx < n)
        pid = torch.arange(sl.start, sl.stop, device=points.device)
        pid = pid.repeat_interleave(idx.numel() // (sl.stop - sl.start))
        ids.scatter_reduce_(0, torch.where(win, idx, n),
                            torch.where(win, pid, big), reduce="amin",
                            include_self=True)
    ids = torch.where(ids == big, -1, ids)[:n]
    return out[:n].reshape(b, h, w, c), ids.reshape(b, h, w, c)


def _max_backward(points, feats, ids, g, radius: float):
    """The JAX package's _p2i_max_bwd: (d points [P, 2], d feats [P, C],
    d background [B, H, W, C])."""
    b, h, w, c = g.shape
    p = points.shape[0]
    dev = g.device
    won = ids >= 0
    safe = torch.where(won, ids, 0)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :, None]
    dy = yy - points[:, 0][safe]
    dx = xx - points[:, 1][safe]
    r = sqrt_ieee(dy * dy + dx * dx)
    gm = g * won
    sid = torch.where(won, safe, p).reshape(-1)
    ch = torch.arange(c, device=dev).expand(b, h, w, c).reshape(-1)
    d_pf = torch.zeros(p + 1, c, dtype=g.dtype, device=dev).index_put_(
        (sid, ch), (gm * _weight(r, radius)).reshape(-1), accumulate=True)
    kfac = gm * feats[safe, ch.reshape(b, h, w, c)] * _slope(r, radius)
    d_pt = torch.zeros(p + 1, 2, dtype=g.dtype, device=dev).index_add_(
        0, sid, torch.stack([kfac * dy, kfac * dx], -1).reshape(-1, 2))
    return d_pt[:p], d_pf[:p], torch.where(won, 0.0, g)


class _P2iSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, feats, binds, background, radius):
        ctx.save_for_backward(points, feats, binds)
        ctx.radius = radius
        return _sum_forward(points, feats, binds, background, radius)

    @staticmethod
    def backward(ctx, g):
        points, feats, binds = ctx.saved_tensors
        d_pt, d_pf = _sum_backward(points, feats, binds, g.contiguous(),
                                   ctx.radius)
        return d_pt, d_pf, None, g, None


class _P2iMaxBg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, feats, binds, background, radius):
        out, ids = _max_forward(points, feats, binds, background, radius)
        ctx.save_for_backward(points, feats, ids)
        ctx.radius = radius
        return out

    @staticmethod
    def backward(ctx, g):
        points, feats, ids = ctx.saved_tensors
        d_pt, d_pf, d_bg = _max_backward(points, feats, ids, g.contiguous(),
                                         ctx.radius)
        return d_pt, d_pf, None, d_bg, None


def p2i_sum(points, feats, binds, background, radius: float) -> torch.Tensor:
    """Sum splat over a background: points [P, 2] f32 (y, x) pixels, feats
    [P, C] f32, binds [P] int32, background [B, H, W, C] f32 -> background +
    sum of w(r) * f over every pixel within r <= radius of a point;
    differentiable in points, feats and background (the JAX package's
    ``p2i_sum`` and its ``_p2i_sum_bwd``). Stock PyTorch ops on either
    device: the JAX package has no kernel for it, and no shipped path
    runs it."""
    _check_general(points, feats, binds, background)
    return _P2iSum.apply(points, feats, binds, background, float(radius))


def p2i_max_bg(points, feats, binds, background, radius: float) -> torch.Tensor:
    """Max splat over a background (the JAX package's ``p2i_max``, whose
    name here is the zero-background kernel's): each pixel takes the max of
    its background and of w(r) * f over the points within r <= radius;
    differentiable in points, feats and background as ``_p2i_max_bwd``: a
    pixel's gradient goes to its winner (the lowest point id among values
    >= the max and > the background), else to the background. Stock
    PyTorch ops on either device, as ``p2i_sum``."""
    _check_general(points, feats, binds, background)
    return _P2iMaxBg.apply(points, feats, binds, background, float(radius))


def p2i(points, feats, binds, background, radius: float,
        kernel_kind_str: str = "cos", reduce: str = "sum") -> torch.Tensor:
    """The reference wrapper's dispatcher (cuda/p2i_op/__init__.py:99-131)
    on points already in (y, x) pixels: ``reduce`` "sum" or "max"."""
    if kernel_kind_str != "cos":
        raise ValueError(f"p2i: kernel {kernel_kind_str!r}; only 'cos' exists")
    if reduce == "sum":
        return p2i_sum(points, feats, binds, background, radius)
    if reduce == "max":
        return p2i_max_bg(points, feats, binds, background, radius)
    raise ValueError(f"Invalid reduce value: {reduce}")
