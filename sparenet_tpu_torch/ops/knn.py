"""Self-kNN graph of point features (counterpart of sparenet_tpu/ops/knn.py).

``knn_idx(x, k, packed=False)``: x [B, N, C] f32 -> [B, N, k] int32, self
included, ascending by distance, lowest index on ties. On a CUDA tensor it
launches ``csrc/knn.cu``; on a CPU tensor it runs ``knn_plain``. Any
k <= N on either.

``packed=True`` is serving mode's arm (the reference's
``knn_self_pallas(..., packed=True)``, knn_pallas.py:_knn_onechunk_kernel):
the distance is one bf16 pass (``pairwise_sqdist_serving``), and each
candidate is ranked by one int32 key, the f32 bits of the distance with the
low ``packed_bits(N)`` bits replaced by its index, so distances equal after
that truncation go to the lowest index. As in the reference it applies only
where its one-chunk kernel takes the shape (``packed_applies``); elsewhere
the exact arm runs. Plain version ``knn_packed_plain``, kernel
``spn_knn_packed``, counted as ``"knn_packed"``.

Both arms' kernels rank on the tensor cores, whose sums differ from a
fixed order's by at most ``margin``, then re-rank a shortlist of
``shortlist_len(k)`` candidates by their exact keys in that order where a
margin test proves that enough: the packed arm's order is the plain
version's, the exact arm's ``common.pairwise_sqdist_graph_seq``. Rows
equal bit for bit (the loaders' zero padding) rank as one group, led by
its lowest index (``duplicate_reps``), which the re-rank expands into its
rows. ``rerank_plain`` is that rule in plain PyTorch. The queries that fail
the test take an exact-scan kernel and are counted on the card
(``_lib.device_count("knn_flagged")``, ``"knn_packed_flagged"``).
``tensor_core_dots`` returns the main kernel's dots, held to
``dot_bound`` on the card (the margin's premise); ``knn_seq_rows`` is the
exact arm's own ranking at chosen query rows, which its output equals bit
for bit. Above k = 32 (the largest
shortlist the kernels are built for) every query takes an exact scan of all
N candidates, keeping its k smallest keys in device memory; those queries
are not counted as flagged.
"""

from __future__ import annotations

import torch

from . import _lib
from .common import (_split_bf16, check_input, fma_rn, graph_dot_seq, is_cpu,
                     pairwise_sqdist_graph, pairwise_sqdist_serving,
                     serving_dot, sqdist_from, sqnorm_fma, sqnorm_seq)

__all__ = ["knn_idx", "knn_plain", "knn_packed_plain", "smallest_k",
           "packed_bits", "packed_applies", "margin", "rerank_plain",
           "duplicate_reps", "shortlist_len", "tensor_core_dots", "dot_bound",
           "tensor_core_error", "knn_seq_rows"]

# the reference's one-chunk ceiling: its [C, N] operand must fit VMEM
_ONECHUNK_MAX_ELEMS = 1024 * 8192


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def packed_bits(n: int) -> int:
    """Low key bits the index takes: bit_length(n_pad - 1), n_pad = N
    rounded up to 128 (12 at N = 3000)."""
    return max((_round_up(n, 128) - 1).bit_length(), 1)


def packed_applies(n: int, c: int) -> bool:
    """Whether the reference takes the packed arm at this shape (its
    one-chunk kernel: channels padded to 128, or to 256 above 256)."""
    cc = min(256, _round_up(c, 128))
    return _round_up(c, cc) * _round_up(n, 128) <= _ONECHUNK_MAX_ELEMS


def shortlist_len(k: int) -> int:
    """M, the candidates the kernels re-rank a query: twice the K they are
    built for (csrc/knn.cu list_len)."""
    return 2 * (8 if k <= 8 else 16 if k <= 16 else 32)


def _to_f32(v: torch.Tensor, up: bool) -> torch.Tensor:
    """f64 values rounded to f32 upward (or downward)."""
    f = v.float()
    off = f.double() < v if up else f.double() > v
    return torch.where(off, torch.nextafter(f, torch.full_like(
        f, float("inf") if up else float("-inf"))), f)


def margin(x: torch.Tensor, packed: bool) -> torch.Tensor:
    """E [B, N]: the bound on |d' - d| for each query of x [B, N, C] over
    all candidates, d' the tensor cores' distance of the arm, d its fixed
    order's (derived in csrc/knn.cu), with f = 1 (packed) or 2 (exact):
    f (2^-16 + c_pad 2^-22) |xh_q| max|yh| + 2^-22 (|x_q|^2 + max|y|^2)
    + f c_pad 2^-124, c_pad = C rounded up to 32 (the kernel's padded
    channels), rounded up to f32."""
    f = 1.0 if packed else 2.0
    c_pad = _round_up(x.shape[2], 32)
    nh = x.to(torch.bfloat16).double().square().sum(-1).sqrt()
    sq = x.double().square().sum(-1)
    e = (f * (2.0 ** -16 + c_pad * 2.0 ** -22) * nh * nh.amax(1, keepdim=True)
         + 2.0 ** -22 * (sq + sq.amax(1, keepdim=True))
         + f * c_pad * 2.0 ** -124)
    return _to_f32(e, up=True)


def duplicate_reps(x: torch.Tensor) -> torch.Tensor:
    """[B, N] int64: for each row of x [B, N, C], the lowest index of a row
    equal to it bit for bit (the kernels' groups, csrc/knn.cu
    knn_dedup_kernel, which may split a group on a hash collision)."""
    bits = x.contiguous().view(torch.int32)
    n = x.shape[1]
    lane = torch.arange(n, device=x.device)
    reps = []
    for row in bits:
        _, inv = torch.unique(row, dim=0, return_inverse=True)
        first = torch.full((n,), n, device=x.device).scatter_reduce(
            0, inv, lane, "amin")
        reps.append(first[inv])
    return torch.stack(reps)


def rerank_plain(d_approx: torch.Tensor, d: torch.Tensor, e: torch.Tensor,
                 k: int, m: int, packed: bool, reps: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' rule in plain PyTorch. d [B, N, N]: the arm's exact
    distances; d_approx: distances within e [B, N] of them; reps [B, N]:
    each row's group (``duplicate_reps``; default, every row alone). The
    m smallest packed keys of d_approx among the groups' first rows form a
    shortlist of groups, whose rows are ranked by exact keys (the packed
    key of d, or (d, index) in lexicographic order) where the margin test
    holds, T(lo_m - e) > T(hi_k + e) with T the truncated bits, lo_m the
    m-th key's bucket floor and hi_k the bucket ceiling of the key of the
    k'-th group, k' the fewest leading groups with k rows in all; the other
    queries rank all N exact keys. Returns ([B, N, k] indices, the [B, N]
    mask of queries that failed the test)."""
    b, n = d.shape[:2]
    bits = packed_bits(n)
    mask, low = -(1 << bits), (1 << bits) - 1
    lane = torch.arange(n, dtype=torch.int32, device=d.device)
    if reps is None:
        reps = lane.long().expand(b, n)
    first = reps == lane
    approx = (d_approx.clamp_min(0.0).contiguous().view(torch.int32) & mask) | lane
    approx = approx.masked_fill(~first[:, None, :], torch.iinfo(torch.int32).max)
    short = approx.topk(min(m, n), dim=-1, largest=False, sorted=True).values
    valid = short != torch.iinfo(torch.int32).max
    at = torch.where(valid, short & low, 0).long()
    if packed:
        key = ((d.view(torch.int32) & mask) | lane).long()
    else:
        key = (d.view(torch.int32).long() << 32) | lane.long()
    ok = first.sum(1, keepdim=True).expand(b, n) <= m
    if m < n:
        rows = torch.zeros(b, n, dtype=torch.long, device=d.device).scatter_add_(
            1, reps, torch.ones_like(reps))
        size = rows.gather(1, at.flatten(1)).view(at.shape) * valid
        kth = (size.cumsum(-1) >= k).int().argmax(-1, keepdim=True)
        e = e.double()
        lo = (short[..., m - 1] & mask).view(torch.float32).double()
        hi = ((short.gather(-1, kth)[..., 0] & mask) + (1 << bits)
              ).view(torch.float32).double()
        ok = ok | ((_to_f32(lo - e, up=False).view(torch.int32) & mask)
                   > (_to_f32(hi + e, up=True).view(torch.int32) & mask))
    listed = torch.zeros(b, n, n + 1, dtype=torch.bool, device=d.device).scatter_(
        -1, torch.where(valid, at, n), True)     # empty entries: column n
    listed = listed.gather(-1, reps[:, None, :].expand(b, n, n))
    best = torch.where(
        ok[..., None],
        key.masked_fill(~listed, torch.iinfo(torch.int64).max).topk(
            k, dim=-1, largest=False, sorted=True).values,
        key.topk(k, dim=-1, largest=False, sorted=True).values)
    return (best & low).to(torch.int32), ~ok


def smallest_k(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of each row of d [..., M],
    ascending, lowest index on ties: k masked argmins, as the reference's
    _smallest_k (torch.argmin returns the first minimal index)."""
    d = d.clone()
    out = []
    for _ in range(k):
        i = d.argmin(-1, keepdim=True)
        out.append(i)
        d.scatter_(-1, i, float("inf"))
    return torch.cat(out, -1).to(torch.int32)


def knn_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the kNN kernel."""
    _lib.PLAIN_CALLS["knn"] += 1
    return smallest_k(pairwise_sqdist_graph(x, x), k)


def knn_packed_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of the packed-key kNN kernel: the k smallest
    keys (unique, as the index is in them)."""
    _lib.PLAIN_CALLS["knn_packed"] += 1
    n = x.shape[1]
    bits = packed_bits(n)
    d = pairwise_sqdist_serving(x, x)
    key = ((d.view(torch.int32) & -(1 << bits))
           | torch.arange(n, dtype=torch.int32, device=x.device))
    low = key.topk(k, dim=-1, largest=False, sorted=True).values
    return low & ((1 << bits) - 1)


def knn_idx(x: torch.Tensor, k: int = 8, packed: bool = False) -> torch.Tensor:
    """Self-kNN indices x [B, N, C] -> [B, N, k] int32 (no gradient)."""
    x = x.detach()
    check_input("knn_idx x", x, torch.float32, 3)
    if x.shape[1] < k:
        raise ValueError(f"knn_idx: need N >= k, got N={x.shape[1]}, k={k}")
    b, n, c = x.shape
    packed = packed and packed_applies(n, c)
    if is_cpu(x):
        return knn_packed_plain(x, k) if packed else knn_plain(x, k)
    name = "knn_packed" if packed else "knn"
    out = torch.empty((b, n, k), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        so = _lib.lib()
        scratch = torch.empty(so.spn_knn_scratch_bytes(b, n, c, k, int(packed)),
                              dtype=torch.uint8, device=x.device)
        total = _lib.device_counter(f"{name}_flagged", x.device)
        launch = so.spn_knn_packed if packed else so.spn_knn
        code = launch(x.data_ptr(), scratch.data_ptr(), b, n, c, k,
                      total.data_ptr(), out.data_ptr(), _lib.stream_of(x))
    _lib.check(code, name)
    _lib.LAUNCHES[name] += 1
    return out


def tensor_core_dots(x: torch.Tensor, packed: bool = False) -> torch.Tensor:
    """The main kernel's dot' of every pair of x [B, N, C] (N >= 8) on the
    card, [B, N, N] f32 (csrc/knn.cu spn_knn_dots; the exact arm's three
    terms, or the packed arm's one at any shape), whose distance
    ``common.sqdist_from`` gives from the arm's norms. It runs the whole
    kernel chain and is counted as a launch of that arm."""
    x = x.detach()
    check_input("tensor_core_dots x", x, torch.float32, 3)
    if is_cpu(x):
        raise ValueError("tensor_core_dots: the kernels run on the card")
    b, n, c = x.shape
    name = "knn_packed" if packed else "knn"
    out = torch.empty((b, n, 8), dtype=torch.int32, device=x.device)
    probe = torch.empty((b, n, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        so = _lib.lib()
        scratch = torch.empty(so.spn_knn_scratch_bytes(b, n, c, 8, int(packed)),
                              dtype=torch.uint8, device=x.device)
        total = _lib.device_counter(f"{name}_flagged", x.device)
        code = so.spn_knn_dots(x.data_ptr(), scratch.data_ptr(), b, n, c, 8,
                               int(packed), total.data_ptr(), out.data_ptr(),
                               probe.data_ptr(), _lib.stream_of(x))
    _lib.check(code, name)
    _lib.LAUNCHES[name] += 1
    return probe


def dot_bound(x: torch.Tensor, packed: bool) -> torch.Tensor:
    """[B, N]: the bound csrc/knn.cu derives on |dot' - dot| for each query
    of x over all candidates, dot' the tensor cores' and dot the arm's
    fixed order's: f (2^-18 + 1.6 c_pad 2^-24) 1.01 |xh_q| max|yh|, f = 1
    (packed) or 2 (exact). It rests on the premise that each add of the
    tensor cores keeps 24 significant bits; E covers twice it."""
    f = 1.0 if packed else 2.0
    c_pad = _round_up(x.shape[2], 32)
    nh = x.to(torch.bfloat16).double().square().sum(-1).sqrt()
    return (f * (2.0 ** -18 + 1.6 * c_pad * 2.0 ** -24) * 1.01
            * nh * nh.amax(1, keepdim=True))


def tensor_core_error(x: torch.Tensor, packed: bool) -> tuple[float, float]:
    """The margin's premise measured on the card for x [B, N, C]:
    (max |dot' - dot| / dot_bound, max |d' - d| / E) over all pairs, the
    tensor cores' values against the arm's fixed order's."""
    dot_mma = tensor_core_dots(x, packed)
    dot = serving_dot(x, x) if packed else graph_dot_seq(x)
    sq = sqnorm_seq(x) if packed else sqnorm_fma(x)

    def worst(err, bound):
        return float(torch.where(err > 0, err / bound, 0.0).max())
    return (worst((dot_mma - dot).abs(), dot_bound(x, packed)[..., None]),
            worst((sqdist_from(sq, dot_mma) - sqdist_from(sq, dot)).abs(),
                  margin(x, packed)[..., None]))


def knn_seq_rows(x: torch.Tensor, rows: torch.Tensor, k: int) -> torch.Tensor:
    """The exact arm's own ranking at the query rows ``rows`` of x [B, N,
    C]: the k smallest (d, index) keys over all N rows, d in its fixed
    order (``common.pairwise_sqdist_graph_seq``: norms and dots as fma
    chains in channel order), every fma rounded once (``common.fma_rn``).
    [B, len(rows), k] int64. Where |x|^2 dwarfs the distances (a feature
    shared by every row), rounding ranks the neighbours, and a comparison
    with the plain version's ranking can only bound the distance gaps;
    this one is exact."""
    xh, xl = _split_bf16(x)
    sq = x.new_zeros(x.shape[:2])
    dot = x.new_zeros(x.shape[0], len(rows), x.shape[1])
    for c in range(x.shape[2]):
        sq = fma_rn(x[..., c], x[..., c], sq)
        qh, ql = xh[:, rows, c, None], xl[:, rows, c, None]
        yh, yl = xh[:, None, :, c], xl[:, None, :, c]
        dot = fma_rn(ql, yh, fma_rn(qh, yl, fma_rn(qh, yh, dot)))
    d = ((sq[:, rows, None] + sq[:, None, :]) - 2.0 * dot).clamp_min(0.0)
    return smallest_k(d, k).long()
