"""Launch-shape and tiling sweeps of the PyTorch/CUDA port's MDS continuation
(kernel #5) and p2i splat (kernel #9), on one NVIDIA GPU:

    python scripts/port_sweep_continue_p2i.py

Prints, each line flushed, with the card's name and power limit first:
- the continuation on the hybrid tail's prefix states (19384 points, a
  batched prefix of 14336 picks, its 5048 live lanes, 2048 steps) at B=4
  and B=32: the shape the wrapper chooses, ms a call at every cluster size
  C = 1..16 with compaction every 1024 steps and none, each held bit for
  bit to the plain version (B=4) or to C = 1 (B=32), and the latency floor
  (an empty step) at C = 1, 2, 4, 8, 16;
- the p2i splat on chip_smoke.py's phase-12 input (4 clouds x 8 views of
  16384 points at 256 x 256, with ties): the device time of each of its
  kernels at R = 5 and 10 (torch.profiler), ms a call with ids at R = 5, 7
  and 10 for tiles 16 x 32 .. 64 x 128 and work items of 2^13 .. 2^18
  window pixels, each tile held bit for bit to the plain version; then 15
  readings of 10 calls (CUDA events and the host clock) at R = 5.
Times are CUDA events after a warm-up. Inputs come from fixed seeds.
"""
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from sparenet_tpu_torch.models import set_parity_mode  # noqa: E402
from sparenet_tpu_torch.ops import _lib, expansion_penalty, mds, p2i  # noqa: E402


def prefix_state(b, gen, dev):
    """The live lanes the hybrid's batched prefix leaves (1/16 of the
    coarse points duplicated: exact density ties)."""
    coarse = torch.rand(b, 16384, 3, generator=gen) - 0.5
    coarse[:, 1024:2048] = coarse[:, :1024]
    partial = torch.rand(b, 3000, 3, generator=gen) - 0.5
    xyz = torch.cat([coarse, partial], 1).contiguous().to(dev)
    mml = expansion_penalty.mean_mst_length_estimate(xyz[:, :16384], 512, 1.33)
    _, temp = mds.mds_batched(xyz, 14336, mml, g=8192, schedule=(),
                              return_state=True)
    return (*mds.compact_live(xyz, temp, 19384 - 14336), mml)


def sweep_continue(dev):
    gen = torch.Generator().manual_seed(7)
    for b in (4, 32):
        xc, tc, orig, mml = prefix_state(b, gen, dev)
        args = (xc, tc, orig, mml, 2048)
        want = (mds.mds_continue_plain(*args) if b == 4 else
                mds.mds_continue(*args, _cluster=1, _stage=0))
        print(f"continuation B={b}, {xc.shape[1]} lanes, 2048 steps: chosen "
              f"(C, CTAs an SM) {mds.continue_cluster_size(b, xc.shape[1])}, "
              f"{cs.cuda_ms(lambda: mds.mds_continue(*args), reps=3):.4f} ms; "
              f"held to {'the plain version' if b == 4 else 'C = 1'}", flush=True)
        for c in range(1, 17):
            row = []
            for stage in (1024, 0):
                same = torch.equal(mds.mds_continue(*args, _cluster=c, _stage=stage), want)
                ms = cs.cuda_ms(lambda: mds.mds_continue(*args, _cluster=c,
                                                         _stage=stage), reps=3)
                row.append(f"stage {stage}: {ms:.4f} ms, equal {same}")
            print(f"  C={c}: " + "; ".join(row), flush=True)
        floor = {c: 1e3 * cs.cuda_ms(lambda: mds.mds_continue_floor(*args, c), reps=3)
                 / 2048 for c in (1, 2, 4, 8, 16)}
        print("  latency floor, us a step at C " + ", ".join(
            f"{c}: {us:.3f}" for c, us in floor.items()), flush=True)


def kernel_name(key: str) -> str:
    """The kernel's name (template arguments kept) in a profiler key."""
    m = re.search(r"::(\w+(?:<[^()]*?>)?)\(", key)
    return m.group(1) if m else key


def sweep_p2i(dev):
    pts, feat, binds, n_img = cs.splat_inputs(torch.Generator().manual_seed(4), dev, 4)
    for radius in (5.0, 10.0):
        args = (pts, feat, binds, n_img, 256, 256, radius, True)
        p2i.p2i_max(*args)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                p2i.p2i_max(*args)
            torch.cuda.synchronize()
        parts = {kernel_name(e.key): e.device_time_total / 5e3
                 for e in prof.key_averages() if e.device_time_total > 0}
        print(f"p2i R={radius} with ids, ms a call by kernel: "
              + json.dumps({k: round(v, 4) for k, v in parts.items()}), flush=True)
    for radius in (5.0, 7.0, 10.0):
        args = (pts, feat, binds, n_img, 256, 256, radius, True)
        want = p2i.p2i_max_plain(*args)
        for tile in ((16, 32), (32, 64), (32, 128), (64, 64), (64, 128)):
            got = p2i.p2i_max(*args, _tile=tile)
            same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            row = [f"{item}: {cs.cuda_ms(lambda: p2i.p2i_max(*args, _tile=tile, _item_pixels=item), reps=5):.4f}"
                   for item in (1 << 13, 1 << 14, 1 << 15, 1 << 16, 1 << 17, 1 << 18)]
            print(f"p2i R={radius} tiles {tile} exact {same}, ms a call by item "
                  f"pixels: " + ", ".join(row), flush=True)
    args = (pts, feat, binds, n_img, 256, 256, 5.0, True)
    readings = []
    for _ in range(15):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ms = cs.cuda_ms(lambda: p2i.p2i_max(*args), reps=10, warmup=0)
        readings.append((round(ms, 4), round((time.perf_counter() - t) * 100, 4)))
    print(f"p2i R=5.0 with ids, 15 readings of 10 calls (event ms, host ms a "
          f"call): {readings}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    set_parity_mode()
    _lib.lib()
    dev = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    sweep_continue(dev)
    sweep_p2i(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
