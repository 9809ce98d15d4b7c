#!/usr/bin/env python3
"""GRNet's gridding scatter on the card: the port's atomic scatter-add
against an ordered one, at grnet.yaml's shape (B=32, 3000 points, a 64^3
grid: 768,000 corner weights onto 8,388,608 voxels).

    python scripts/port_grnet_scatter_bench.py

Prints ms a call by CUDA events (20 calls after one) for: "atomic", the
port's ``index_put_(accumulate=True)`` (``ops/gridding.py:gridding``);
"ordered", a stable sort of the voxel indices, their run bounds by
``searchsorted`` and ``torch.segment_reduce`` over the runs (no atomics:
the same grid in every run); the sort alone and the sort with the bounds;
then the whole of ``gridding`` and ``gridding_reverse``, beside the card's
name and power limit. Needs a CUDA device; about 15 s.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from sparenet_tpu_torch.ops import gridding as G  # noqa: E402

B, N, S = 32, 3000, 64


def cuda_ms(fn, reps: int = 20) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cloud = ((torch.rand(B, N, 3, generator=gen) - 0.5) * 0.9).to(dev)
    corners, w = G.trilinear_corners(cloud * (S // 2))
    v = corners + S // 2
    flat = (((v[..., 0] * S + v[..., 1]) * S + v[..., 2])
            + torch.arange(B, device=dev).view(B, 1, 1) * S ** 3).reshape(-1)
    w = w.reshape(-1)
    size = B * S ** 3

    def atomic():
        return torch.zeros(size, device=dev).index_put_((flat,), w,
                                                        accumulate=True)

    def bounds():
        keys, order = torch.sort(flat, stable=True)
        return order, torch.searchsorted(
            keys, torch.arange(size + 1, device=dev, dtype=keys.dtype))

    def ordered():
        order, b = bounds()
        return torch.segment_reduce(w[order], "sum", offsets=b, unsafe=True)

    a, o = atomic(), ordered()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"device {smi}; the two grids' max abs difference "
          f"{float((a - o).abs().max()):.3e}", flush=True)
    for name, fn in (("atomic", atomic), ("ordered", ordered),
                     ("sort", lambda: torch.sort(flat, stable=True)),
                     ("sort + bounds", bounds)):
        print(f"{name:14s} {cuda_ms(fn):8.3f} ms", flush=True)
    grid = G.gridding(cloud, S)
    print(f"gridding {cuda_ms(lambda: G.gridding(cloud, S)):.3f} ms, "
          f"gridding_reverse {cuda_ms(lambda: G.gridding_reverse(grid, S)):.3f} "
          f"ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
