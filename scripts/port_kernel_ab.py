"""Time the greedy-MDS, auction-bid, expansion, edge-stats, chamfer-NN,
continuation and p2i kernels of one copy of the PyTorch/CUDA port, for an A/B of two commits
on one card:

    git archive PARENT | tar -x -C _archive/a     # and the change in _archive/c
    for d in a c c a; do python scripts/port_kernel_ab.py _archive/$d $d; done

Each run builds that copy's kernels and prints one JSON line of
milliseconds a call (CUDA events after a warm-up): bids at B=4 (u = 16384
and 8450 bidders, counted on the card where the copy takes counts, else
a u-row list) and B=24, one whole 50-round auction, MDS at B=4, 24 and
32 on a uniform cloud (temperature from the expansion penalty) and an
ellipsoid shell (mml 0.01), and, where the copy has them, the cluster size
chosen and the latency floor in us a step at C = 1, 3, 16; then the
kernels at the main paths' shapes: expansion on [128, 512, 3], gather-max
with sums on [4, 3000, 256] and [4, 3000, 1024] and the edge-stats
forward on [4, 3000, 256] and the backward on [4, 3000, 256], [4, 3000,
1024], [24, 3000, 256] and [24, 3000, 1024] at k = 8, each with its parts
(route codes, inverse lists, accumulation: device ms by torch.profiler),
the chamfer NN on [4, 16384] x [4, 16384] and [24, 16384] x [24, 16384],
the MDS continuation on [4, 5048]
and [32, 5048] live lanes for 2048 steps (and, where the copy has it, its
latency floor at the chosen cluster size); and the p2i splat at the B=4
GAN step's three shapes (4 clouds x 8 views of 16384, 16384 and 3000
points, uniform in a cube, projected by the renderer into 32 images of
256 x 256) at R = 5, 7 and 10, with and without ids.
Inputs come from seed 0.
"""
import inspect
import json
import sys

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402

from sparenet_tpu_torch.models import set_parity_mode  # noqa: E402
from sparenet_tpu_torch.ops import (_lib, chamfer, edge_gather,  # noqa: E402
                                    emd, expansion_penalty, gather, mds, p2i)
from sparenet_tpu_torch.renderer import ComputeDepthMaps  # noqa: E402

set_parity_mode()
_lib.lib()
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)


# the edge-stats backward's parts, by kernel name: the route codes, the
# inverse lists (with their memsets) and the ordered accumulation
EDGE_BWD_PARTS = {"route": ("route_kernel",),
                  "lists": ("lists_kernel", "count_kernel", "scan_kernel",
                            "fill_kernel", "sort_kernel", "memset"),
                  "accum": ("accum_kernel",)}


def parts_ms(fn, groups, reps=5):
    """Device ms a call of each group of kernels (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    got = dict.fromkeys(groups, 0.0)
    for e in prof.key_averages():
        name = next((k for k, pats in groups.items()
                     if any(p in e.key.lower() for p in pats)), None)
        if name:
            got[name] += e.self_device_time_total / 1e3 / reps
    return got


def ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


out = {}
n = 16384
for b in (4, 24):
    x1 = (torch.rand(b, n, 3, generator=g) - 0.5).to(dev)
    x2 = (torch.rand(b, n, 3, generator=g) - 0.5).to(dev)
    price = (torch.rand(b, n, generator=g) * 0.05).to(dev)
    counted = "count" in inspect.signature(emd.emd_bids).parameters
    for u in ((16384, 8450) if b == 4 else (16384,)):
        cnt = torch.full((b,), u, dtype=torch.int32, device=dev)
        xu = x1[:, :u].contiguous()
        out[f"bids_b{b}_u{u}"] = ms(
            (lambda: emd.emd_bids(x1, x2, price, cnt)) if counted
            else (lambda: emd.emd_bids(xu, x2, price)))
    a = x1.clone()
    out[f"auction_b{b}"] = ms(lambda: emd.auction_assign(a, x2, 0.005, 50), reps=2)
for b in (4, 24, 32):
    coarse = (torch.rand(b, 16384, 3, generator=g) - 0.5).to(dev)
    part = (torch.rand(b, 3000, 3, generator=g) - 0.5).to(dev)
    _, _, mml = expansion_penalty.expansion_penalty(coarse, 512, 1.5)
    xyz = torch.cat([coarse, part], 1).contiguous()
    out[f"mds_rand_b{b}"] = ms(lambda: mds.minimum_density_sample(xyz, 16384, mml), reps=2)
    d = torch.randn(b, 19384, 3, generator=g)
    ell = (d / d.norm(dim=-1, keepdim=True) * torch.tensor([0.4, 0.3, 0.2])).to(dev)
    mml2 = torch.full((b,), 0.01, device=dev)
    out[f"mds_ell_b{b}"] = ms(lambda: mds.minimum_density_sample(ell, 16384, mml2), reps=2)
    if hasattr(mds, "cluster_size"):
        out[f"mds_C_b{b}"] = mds.cluster_size(b, 19384)
if hasattr(mds, "mds_floor"):
    for c in (1, 3, 16):
        out[f"floor_us_c{c}"] = 1e3 * ms(lambda: mds.mds_floor(
            xyz[:4].contiguous(), 4097, mml[:4].contiguous(), c), reps=3) / 4096
xe = (torch.rand(128, 512, 3, generator=g) * 2 - 1).to(dev)
out["expansion"] = ms(lambda: expansion_penalty.mst_charges(xe), reps=50)
t = torch.randn(4, 3000, 256, generator=g).to(dev)
idx = torch.randint(0, 3000, (4, 3000, 8), generator=g, dtype=torch.int32).to(dev)
out["gather_max"] = ms(lambda: gather.gather_max(t, idx, need_sum=True), reps=200)
t4 = torch.randn(4, 3000, 1024, generator=g).to(dev)
out["gather_max_1024"] = ms(lambda: gather.gather_max(t4, idx, need_sum=True), reps=100)
out["edge_fwd"] = ms(lambda: edge_gather.edge_stats_fwd(t, idx), reps=200)
for b in (4, 24):
    idx = torch.randint(0, 3000, (b, 3000, 8), generator=g,
                        dtype=torch.int32).to(dev)
    for c in (256, 1024):
        tb = torch.randn(b, 3000, c, generator=g).to(dev)
        mx, mn, _, _ = edge_gather.edge_stats_fwd(tb, idx)
        gs = [torch.randn(b, 3000, c, generator=g).to(dev) for _ in range(4)]
        key = "edge_bwd" + ("" if (b, c) == (4, 256) else f"_b{b}_c{c}")
        call = lambda: edge_gather.edge_stats_bwd(tb, idx, mx, mn, *gs)  # noqa: E731
        out[key] = ms(call, reps=20)
        for part, v in parts_ms(call, EDGE_BWD_PARTS).items():
            out[f"{key}_{part}"] = v
        del tb, mx, mn, gs
for b in (4, 24):
    x1 = (torch.rand(b, 16384, 3, generator=g) - 0.5).to(dev)
    x2 = (torch.rand(b, 16384, 3, generator=g) - 0.5).to(dev)
    out[f"nn_b{b}"] = ms(lambda: chamfer.nn_idx(x1, x2), reps=10)
xc = (torch.rand(4, 5048, 3, generator=g) - 0.5).to(dev)
tc = (torch.rand(4, 5048, generator=g) * 0.01).to(dev)
oc = torch.arange(4 * 5048, dtype=torch.int32).reshape(4, 5048).to(dev) + 8000
mc = torch.full((4,), 0.006, device=dev)
out["mds_continue"] = ms(lambda: mds.mds_continue(xc, tc, oc, mc, 2048), reps=5)
if hasattr(mds, "mds_continue_floor"):
    c = mds.continue_cluster_size(4, 5048)[0]
    out["mds_continue_floor"] = ms(lambda: mds.mds_continue_floor(xc, tc, oc, mc, 2048, c), reps=5)
xc = (torch.rand(32, 5048, 3, generator=g) - 0.5).to(dev)
tc = (torch.rand(32, 5048, generator=g) * 0.01).to(dev)
oc = torch.arange(32 * 5048, dtype=torch.int32).reshape(32, 5048).to(dev) + 8000
mc = torch.full((32,), 0.006, device=dev)
out["mds_continue_b32"] = ms(lambda: mds.mds_continue(xc, tc, oc, mc, 2048), reps=5)
render = ComputeDepthMaps(image_size=256)
for n in (16384, 3000):
    cloud = torch.rand(4, n, 3, generator=g) - 0.5
    pix, feat = render._project(cloud, render.matrices[:, None])
    pix = pix.transpose(0, 1).reshape(-1, 2).contiguous().to(dev)
    feat = feat.transpose(0, 1).reshape(-1, 1).contiguous().to(dev)
    binds = torch.arange(32, dtype=torch.int32).repeat_interleave(n).to(dev)
    for radius in (5.0, 7.0, 10.0):
        for ids in (True, False):
            out[f"p2i_{n}_r{radius:g}_{'ids' if ids else 'values'}"] = ms(
                lambda: p2i.p2i_max(pix, feat, binds, 32, 256, 256, radius, ids),
                reps=10)
print(sys.argv[2], json.dumps({k: round(v, 4) if isinstance(v, float) else v
                               for k, v in out.items()}), flush=True)
