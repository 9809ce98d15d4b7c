"""Sweep the plans of the two slice kernels of the PyTorch/CUDA port
(csrc/slices.cuh: gather-max with its sum, csrc/gather_max.cu, and the
edge-stats forward, csrc/edge_stats.cu) on the card:

    python scripts/port_sweep_slices.py

The port takes one plan a shape (slices.cuh:make_plan) and has no switch
for another. So the script copies sparenet_tpu_torch/ into a temporary
directory, rewrites the copy's make_plan to take its width and row groups
from two variables of the library, spn_sweep_width and spn_sweep_groups
(0 keeps the plan's own choice), builds the copy and sets them through
ctypes; the repository's sources are not changed.

At the main paths' shapes (N = M = 3000, k = 8; C = 256, 512 and 1024;
B = 4 and 32 for gather-max, the eval forward's, and B = 1, one cloud;
B = 4 and 24 for the edge stats, the training step's) it times each kernel
at every slice width W in (4, 8, 16) and row groups G in (1, 2, 3, 4, 6,
8), and at the plan's own choice: by CUDA events over 20 calls back to
back after a warm-up, which count the host's enqueue where a call
enqueues slower than it runs, and by its device time alone (torch.profiler:
the kernels' own time, summed over the call's launches; "not measured"
where the profiler records no device time). Each reading is given with its
share of the byte bound (inputs read once, outputs written once, at 3.35
TB/s). Beside the plan's time on random neighbour lists it gives its time
on lists that name rows in order (idx[m, j] = (m + j) mod N: the rows a
quarter-warp reads from shared memory start in distinct bank groups), so
the difference is the cost of bank conflicts; and the bytes the design
reads from L2 (the slices, once a row group, and the lists, once a slice).
Prints one line a shape and, last, one JSON object of them all; inputs
come from seed 0.
"""
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
# make_plan's two choices, and what the copy puts in their place
PATCHES = {
    "slices.cuh": [
        ("const int w = pick_width(n, c, k, card.optin);",
         "const int w = spn_sweep_width > 0 ? spn_sweep_width"
         " : pick_width(n, c, k, card.optin);"),
        ("std::min<long long>(wave / clouds_slices, chunks)",
         "std::min<long long>(spn_sweep_groups > 0 ? spn_sweep_groups"
         " : wave / clouds_slices, chunks)"),
        ("namespace spn {",
         'extern "C" int spn_sweep_width, spn_sweep_groups;\n\nnamespace spn {'),
    ],
}
DEFINITIONS = '\nextern "C" {\nint spn_sweep_width = 0;\nint spn_sweep_groups = 0;\n}\n'


def patched_copy() -> Path:
    """sparenet_tpu_torch/ copied into a temporary directory, its make_plan
    rewritten to read spn_sweep_width and spn_sweep_groups (which the
    copy's slices.cu defines); returns the directory."""
    tmp = Path(tempfile.mkdtemp(prefix="sweep_slices_"))
    pkg = tmp / "sparenet_tpu_torch"
    shutil.copytree(REPO / "sparenet_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for name, subs in PATCHES.items():
        path = pkg / "csrc" / name
        text = path.read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: expected one {old!r}; the sweep's "
                                 f"patch no longer matches the source")
            text = text.replace(old, new)
        path.write_text(text)
    with open(pkg / "csrc" / "slices.cu", "a") as f:
        f.write(DEFINITIONS)
    return tmp


HBM_BPS = 3.35e12
N, K = 3000, 8
WIDTHS, GROUPS = (4, 8, 16), (1, 2, 3, 4, 6, 8)


def ms(fn, reps=20):
    """CUDA events over reps calls back to back, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=20):
    """Device time a call (torch.profiler: the kernels' own time, without
    the host's enqueue or the gaps between launches); None where the
    profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.self_device_time_total > 0)
    return us / 1e3 / reps if us else None


def f4(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def main() -> None:
    tmp = patched_copy()
    try:
        sweep(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def sweep(tmp: Path) -> None:
    sys.path.insert(0, str(tmp))
    from sparenet_tpu_torch.ops import _lib, common, edge_gather, gather
    assert Path(_lib.__file__).is_relative_to(tmp)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    lib = _lib.lib()
    knobs = [ctypes.c_int.in_dll(lib, f"spn_sweep_{v}") for v in ("width", "groups")]

    def force(w=0, gr=0):
        """Plans of width w and gr row groups from here on (0: the plan's)."""
        knobs[0].value, knobs[1].value = w, gr
        gather.partial_rows.cache_clear()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    # a second of matrix products first: the card at its working clock
    warm = torch.randn(4096, 4096, device=dev)
    for _ in range(100):
        warm = warm @ warm * 1e-3
    torch.cuda.synchronize()
    calls = {
        "gather": (lambda t, i: gather.gather_max(t, i, need_sum=True),
                   (1, 4, 32), 1),
        "edge": (lambda t, i: edge_gather.edge_stats_fwd(t, i), (4, 24), 4),
    }
    out = {"card": smi}
    for name, (fn, batches, n_out) in calls.items():
        for b in batches:
            idx = torch.randint(0, N, (b, N, K), generator=g,
                                dtype=torch.int32).to(dev)
            seq = ((torch.arange(N)[:, None] + torch.arange(K)) % N).to(
                torch.int32).expand(b, N, K).contiguous().to(dev)
            for c in (256, 512, 1024):
                t = torch.randn(b, N, c, generator=g).to(dev)
                nbytes = 4 * (t.numel() + idx.numel() + n_out * b * N * c
                              + (b * c if name == "gather" else 0))
                bound = nbytes / HBM_BPS * 1e3
                key = f"{name}_b{b}_c{c}"
                force()
                plan = common.slice_plan(b, N, N, c, K)
                t_plan = ms(lambda: fn(t, idx))
                d_plan = device_ms(lambda: fn(t, idx))
                d_seq = device_ms(lambda: fn(t, seq))
                slices = -(-c // plan["width"])
                l2_mb = (plan["groups"] * t.numel() * 4
                         + slices * idx.numel() * 4) / 1e6
                grid = {}
                for w in WIDTHS:
                    for gr in GROUPS:
                        force(w, gr)
                        if common.slice_plan(b, N, N, c, K)["groups"] != gr:
                            continue
                        grid[f"W{w}_G{gr}"] = (ms(lambda: fn(t, idx)),
                                               device_ms(lambda: fn(t, idx)))
                force()
                timed = [kk for kk in grid if grid[kk][1] is not None]
                best = min(timed, key=lambda kk: grid[kk][1]) if timed else None
                out[key] = {"plan": {kk: plan[kk] for kk in ("width", "groups",
                                                             "smem", "blocks")},
                            "ms": t_plan, "device_ms": d_plan,
                            "device_ms_rows_in_order": d_seq,
                            "bound_ms": bound, "l2_mb": l2_mb,
                            "best_by_device": best, "grid": grid}
                share = ("" if d_plan is None else
                         f" ({100 * bound / d_plan:.1f}% of the bound)")
                conflicts = ("not measured" if None in (d_plan, d_seq) else
                             f"{d_plan - d_seq:+.4f}")
                print(f"{key}: plan W={plan['width']} G={plan['groups']} "
                      f"({plan['blocks']} blocks): {t_plan:.4f} ms by events, "
                      f"device {f4(d_plan)} ms{share}, bound {bound:.4f} ms; "
                      f"rows in order, device {f4(d_seq)} ms (bank conflicts "
                      f"{conflicts}); L2 reads {l2_mb:.1f} MB; best by device "
                      f"{best} {f4(grid[best][1] if best else None)}; "
                      f"events/device: " + ", ".join(
                          f"{kk} {v[0]:.4f}/{f4(v[1])}" for kk, v in grid.items()),
                      flush=True)
                del t
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
