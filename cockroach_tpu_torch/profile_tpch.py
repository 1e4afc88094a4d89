"""Where the time goes in the ported TPC-H queries on the card.

    python3 -m cockroach_tpu_torch.profile_tpch [--sf 1] [--runs 3] [--out DIR]

Loads every TPC-H table at the given scale into the port's Engine on
the current CUDA card, warms Q1 (large-G kernel path), Q1 under
``pallas_groupagg = off``, Q6, Q14 (hash join), under ``pallas_groupagg
= on`` Q1F and Q6F (small-G kernel path), Q3, Q5, Q10 and Q12
(multi-way joins, compaction, hash GROUP BY, top-k) and the subquery,
derived-table and CTE queries Q2, Q4, Q7, Q8, Q9, Q11, Q13, Q15, Q16,
Q17, Q18, Q19, Q20, Q21 and Q22; then loads SSB at the same scale into
a second Engine (its supplier and customer clash with TPC-H's) for the
five flights (``ssb_q1.1`` ...); then profiles
``--runs`` executions of each with torch.profiler (CPU + CUDA
activity). Prints, per query: the wall time per run (host clock around
work that ends in a synchronize), the device busy time (sum of kernel
durations; one stream, so kernels do not overlap), the device idle
share (1 - busy / wall), the kernel launch count (all kernels, and the
hand-written kernels' wrapper counts), the hash GROUP BY's build rounds
in the last run (one host sync each), the device memory allocated when
the runs began and the peak above it, and the top kernels by device
time. Chrome traces go to ``--out``
(default chiprun_out/profile). Needs a CUDA card.
``profile_queries`` does the same for any {name: (sql, session)} on a
loaded engine.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def profile_queries(eng, queries: dict, runs: int, out: str) -> dict:
    """Profile each {name: (sql, session)} on a loaded Engine: two warm
    runs, then `runs` under torch.profiler. Returns {name: numbers}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .ops.cuda import groupagg, groupagg_large
    os.makedirs(out, exist_ok=True)
    summary = {}
    for name, (sql, sess) in queries.items():
        for _ in range(2):
            eng.execute(sql, sess)
        torch.cuda.synchronize()
        groupagg.LAUNCHES = groupagg_large.LAUNCHES = 0
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                eng.execute(sql, sess)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / runs * 1e3
        prof.export_chrome_trace(os.path.join(out, f"{name}.json"))
        kernels = [e for e in prof.events()
                   if e.device_type.name == "CUDA"]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 \
            / runs
        # copies run on a stream of their own in a streamed scan, so
        # they may overlap the kernels: busy can then pass the wall
        memcpy = sum(e.time_range.elapsed_us() for e in kernels
                     if e.name.startswith("Memcpy")) / 1e3 / runs
        by_name: dict[str, float] = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        summary[name] = {
            "wall_ms": wall, "device_busy_ms": busy, "memcpy_ms": memcpy,
            "device_idle_share": max(0.0, 1.0 - busy / wall),
            "kernels_per_run": len(kernels) / runs,
            # launches of the hand-written kernels, through their wrappers
            "groupagg_large_per_run": groupagg_large.LAUNCHES / runs,
            "groupagg_per_run": groupagg.LAUNCHES / runs,
            "group_ids_rounds": eng.last_exec.get("group_ids_rounds", 0),
            # the last run's plan runs, partitioned re-runs and temps
            "plan_runs": eng.last_exec["all"]["runs"],
            "partitioned": eng.last_exec["all"]["partitioned"],
            "temp_rows": [n for _, n, _ in eng.last_exec["temps"]],
            "temp_paths": [p for _, _, p in eng.last_exec["temps"]],
            # allocated when the runs began (resident tables and what
            # the caller holds), and the peak above it during the runs
            "memory_allocated_before": resident,
            "peak_above_before": torch.cuda.max_memory_allocated()
            - resident,
            "top_kernels_ms": [(k[:80], v / 1e3 / runs) for k, v in top],
        }
        print(f"{name}: " + json.dumps(summary[name]), flush=True)
    return summary


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
    from .exec.engine import Engine
    from .models import ssb, tpch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    eng = Engine()
    tpch.load(eng, sf=a.sf, tables=tpch.ALL_TABLES, encoded=True)
    off, on = eng.session(), eng.session()
    eng.execute("SET pallas_groupagg = off", off)
    eng.execute("SET pallas_groupagg = on", on)
    queries = {"q1": (tpch.Q1, None), "q1_off": (tpch.Q1, off),
               "q6": (tpch.Q6, None), "q14": (tpch.Q14, None),
               "q1f_on": (tpch.Q1F, on), "q6f_on": (tpch.Q6F, on)}
    queries.update({q: (tpch.QUERIES[q], None)
                    for q in ("q3", "q5", "q10", "q12")
                    + tuple(tpch.ORACLE_ARGS)})
    summary = {"card": smi, "sf": a.sf,
               "rows": eng.store.table("lineitem").row_count}
    summary.update(profile_queries(eng, queries, a.runs, a.out))
    s_eng = Engine()
    ssb.load(s_eng, sf=a.sf)
    summary.update(profile_queries(
        s_eng, {f"ssb_{q}": (sql, None) for q, sql in ssb.QUERIES.items()},
        a.runs, a.out))
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
