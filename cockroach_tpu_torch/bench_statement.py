"""A statement's latency on the card through Engine.execute and through a
prepared handle.

    python3 -m cockroach_tpu_torch.bench_statement [--sf 1] [--runs 21]
        [--label NAME]

Loads TPC-H lineitem at the given scale into an Engine on the current
CUDA card, warms TPC-H Q1 and Q6 three times each, then takes the
median of ``--runs`` runs (host clock around each run, which ends with
its result on the host) through ``Engine.execute`` and through
``Engine.prepare(...).run()``, and the device busy ms a run of each
from torch.profiler (one stream: kernels do not overlap). Prints one
JSON line with the card's name and power limit. It uses only entry
points that every slice of the port has, so one call can time two
checkouts of the repository in turn (``--label`` names each) to compare
them on the same card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def _median_ms(fn, runs: int) -> float:
    import torch
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _busy_ms(fn, runs: int) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type.name == "CUDA") / 1e3 / runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=21)
    ap.add_argument("--label", default="")
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_statement: no CUDA device available", file=sys.stderr)
        return 1
    from .exec.engine import Engine
    from .models import tpch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()
    eng = Engine()
    tpch.load(eng, sf=a.sf, tables=("lineitem",), encoded=True)
    out = {"label": a.label, "card": smi, "sf": a.sf, "runs": a.runs}
    for name, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
        for _ in range(3):
            eng.execute(sql)
        p = eng.prepare(sql)
        p.run()
        for way, fn in (("execute", lambda: eng.execute(sql)),
                        ("prepared", p.run)):
            ms = _median_ms(fn, a.runs)
            busy = _busy_ms(fn, 5)
            out[f"{name}_{way}_ms"] = ms
            out[f"{name}_{way}_device_ms"] = busy
            out[f"{name}_{way}_host_ms"] = ms - busy
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
