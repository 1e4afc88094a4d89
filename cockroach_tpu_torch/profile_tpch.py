"""Where the time goes in TPC-H Q1, Q6 and Q14 on the card (the port).

    python3 -m cockroach_tpu_torch.profile_tpch [--sf 1] [--runs 3] [--out DIR]

Loads TPC-H lineitem and part at the given scale into the port's Engine
on the current CUDA card, warms Q1 (large-G kernel path), Q1 under
``pallas_groupagg = off``, Q6, Q14 (hash join) and, under
``pallas_groupagg = on``, Q1F and Q6F (small-G kernel path), then
profiles ``--runs`` executions of each with torch.profiler (CPU + CUDA
activity). Prints, per query: the
wall time per run (host clock around work that ends in a synchronize),
the device busy time (sum of kernel durations; one stream, so kernels
do not overlap), the device idle share (1 - busy / wall), the kernel
launch count (all kernels, and the hand-written kernels' wrapper counts),
and the top kernels by device time. Chrome traces go to
``--out`` (default chiprun_out/profile). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/profile")
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_tpch: no CUDA device available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from .exec.engine import Engine
    from .models import tpch
    from .ops.cuda import groupagg, groupagg_large

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    eng = Engine()
    tpch.load(eng, sf=a.sf, tables=("lineitem", "part"), encoded=True)
    off, on = eng.session(), eng.session()
    eng.execute("SET pallas_groupagg = off", off)
    eng.execute("SET pallas_groupagg = on", on)
    queries = {"q1": (tpch.Q1, None), "q1_off": (tpch.Q1, off),
               "q6": (tpch.Q6, None), "q14": (tpch.Q14, None),
               "q1f_on": (tpch.Q1F, on), "q6f_on": (tpch.Q6F, on)}
    os.makedirs(a.out, exist_ok=True)
    summary = {"card": smi, "sf": a.sf,
               "rows": eng.store.table("lineitem").row_count}
    for name, (sql, sess) in queries.items():
        for _ in range(2):
            eng.execute(sql, sess)
        torch.cuda.synchronize()
        groupagg.LAUNCHES = groupagg_large.LAUNCHES = 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(a.runs):
                eng.execute(sql, sess)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / a.runs * 1e3
        prof.export_chrome_trace(os.path.join(a.out, f"{name}.json"))
        kernels = [e for e in prof.events()
                   if e.device_type.name == "CUDA"]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 \
            / a.runs
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        summary[name] = {
            "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "kernels_per_run": len(kernels) / a.runs,
            # launches of the hand-written kernels, through their wrappers
            "groupagg_large_per_run": groupagg_large.LAUNCHES / a.runs,
            "groupagg_per_run": groupagg.LAUNCHES / a.runs,
            "top_kernels_ms": [(k[:80], v / 1e3 / a.runs) for k, v in top],
        }
        print(f"{name}: " + json.dumps(summary[name]), flush=True)
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
