"""Count torch.profiler sessions on the card that record no device time, or
less than half of it, for short runs of a small kernel: the port's
gather-max with its sum on [4, 3000, 1024] at k = 8 (about 0.06 ms a call),
20 calls a session after a warm-up, as chip_smoke.py and
scripts/port_sweep_slices.py time kernels by device time. Three ways to
close a session are compared, in turns, 100 sessions each a turn:

    python scripts/port_profiler_sessions.py [SESSIONS]

  - "plain": synchronise, leave the session;
  - "pause": synchronise, wait 20 ms on the host, leave the session;
  - "spin": a spin kernel of about 10 ms first in the session, then the
    calls, synchronise, leave.

Prints, for each way, the sessions, the empty ones, the partial ones (a
device time below half the median of the sessions that saw any) and the
median device ms a call, then one JSON object of them; the card's name and
power limit first. Inputs come from seed 0.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from sparenet_tpu_torch.ops import _lib, gather  # noqa: E402

REPS = 20


def session(fn, way: str) -> float:
    """Device ms a call in one profiler session closed the given way."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if way == "spin":
            torch.cuda._sleep(20_000_000)
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        if way == "pause":
            time.sleep(0.02)
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0 and "sleep" not in e.key
               and "spin" not in e.key) / 1e3 / REPS


def main() -> None:
    sessions = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    _lib.lib()
    g = torch.Generator().manual_seed(0)
    table = torch.randn(4, 3000, 1024, generator=g).cuda()
    idx = torch.randint(0, 3000, (4, 3000, 8), generator=g,
                        dtype=torch.int32).cuda()

    def fn():
        gather.gather_max(table, idx, need_sum=True)
    fn()
    torch.cuda.synchronize()
    ways = ("plain", "pause", "spin")
    got = {w: [] for w in ways}
    for _ in range(-(-sessions // 100)):
        for w in ways:
            got[w] += [session(fn, w) for _ in range(100)]
    out = {"card": smi}
    for w in ways:
        seen = [x for x in got[w] if x > 0]
        med = statistics.median(seen) if seen else 0.0
        out[w] = {"sessions": len(got[w]), "empty": len(got[w]) - len(seen),
                  "partial": sum(x < 0.5 * med for x in seen),
                  "median_device_ms": med}
        print(f"{w}: {out[w]['sessions']} sessions, {out[w]['empty']} empty, "
              f"{out[w]['partial']} partial, median {med:.4f} ms a call",
              flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
