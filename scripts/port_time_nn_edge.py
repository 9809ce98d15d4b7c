"""Time the chamfer NN and the edge-stats backward of one copy of the
PyTorch/CUDA port on the card, with each kernel's parts, and hold both to
their plain versions:

    python scripts/port_time_nn_edge.py DIR [rand | knn | lists]

DIR is a copy of the repository (a `git archive` of a commit, or a scratch
copy of this tree with one kernel changed); run copies in turns in one call
to compare them. Prints one JSON line: the NN on [B, 16384] x [B, 16384]
(half of x2 repeated: exact ties) at B = 4 and 24, ms a call by CUDA events
and device ms of its two kernels by torch.profiler, and whether it equals
nn_idx_plain; with `rand` or `knn`, the backward on [4, 3000, 256],
[4, 3000, 1024] and [24, 3000, 1024] at k = 8, its graph random or the
kNN graph of a uniform cloud, ms a call, its route, lists and
accumulation kernels' device ms, and whether it equals
edge_stats_bwd_plain; with `lists`, only the lists kernel's device ms at
[4, 3000, 256] on a kNN graph. Inputs come from seed 0.
"""
import json
import sys

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from sparenet_tpu_torch.ops import _lib, chamfer, edge_gather, knn  # noqa: E402

MODE = sys.argv[2] if len(sys.argv) > 2 else None
PARTS = ("route_kernel", "lists_kernel", "accum_kernel", "nn_split", "nn_merge")
_lib.lib()
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)


def ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def parts(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for key in PARTS:
            if key in e.key:
                out[key] = out.get(key, 0) + e.self_device_time_total / 1e3 / reps
    return out


def graph(b):
    if MODE == "rand":
        return torch.randint(0, 3000, (b, 3000, 8), generator=g,
                             dtype=torch.int32).to(dev)
    return knn.knn_idx((torch.rand(b, 3000, 3, generator=g) - 0.5).to(dev), 8)


out = {}
if MODE == "lists":
    idx = graph(4)
    tb = torch.randn(4, 3000, 256, generator=g).to(dev)
    mx, mn, _, _ = edge_gather.edge_stats_fwd(tb, idx)
    gs = [torch.randn(4, 3000, 256, generator=g).to(dev) for _ in range(4)]
    out = {k: v for k, v in parts(lambda: edge_gather.edge_stats_bwd(
        tb, idx, mx, mn, *gs), reps=10).items() if "lists" in k}
else:
    for b in (4, 24):
        x1 = (torch.rand(b, 16384, 3, generator=g) - 0.5).to(dev)
        x2 = (torch.rand(b, 16384, 3, generator=g) - 0.5).to(dev)
        x2[:, 8192:] = x2[:, :8192].flip(1)
        got = chamfer.nn_idx(x1, x2)
        out[f"nn_b{b}_exact"] = bool(torch.equal(got, chamfer.nn_idx_plain(x1, x2)))
        out[f"nn_b{b}"] = ms(lambda: chamfer.nn_idx(x1, x2), 50 if b == 4 else 10)
        out[f"nn_b{b}_parts"] = parts(lambda: chamfer.nn_idx(x1, x2))
    if MODE:
        for b, c in ((4, 256), (4, 1024), (24, 1024)):
            idx = graph(b)
            tb = torch.randn(b, 3000, c, generator=g).to(dev)
            mx, mn, _, _ = edge_gather.edge_stats_fwd(tb, idx)
            gs = [torch.randn(b, 3000, c, generator=g).to(dev) for _ in range(4)]
            call = lambda: edge_gather.edge_stats_bwd(tb, idx, mx, mn, *gs)  # noqa: E731
            out[f"edge_b{b}_c{c}_exact"] = bool(torch.equal(
                call(), edge_gather.edge_stats_bwd_plain(tb, idx, mx, mn, *gs)))
            out[f"edge_b{b}_c{c}"] = ms(call, 20)
            out[f"edge_b{b}_c{c}_parts"] = parts(call)
print(sys.argv[1], json.dumps(out), flush=True)
