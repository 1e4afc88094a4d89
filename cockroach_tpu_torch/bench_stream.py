"""TPC-H Q1 and Q6 at a given scale and device budget, end to end.

    python3 -m cockroach_tpu_torch.bench_stream --sf 10 --budget 64G
        --budget 1G [--reps 5] [--page-rows N] [--out FILE]
        [--profile DIR]

Loads lineitem at scale ``--sf`` (``--sf max``: the largest of 100 and
30 whose lineitem the host's MemAvailable holds at 1.8 GB per scale
unit) into the port's Engine on the current CUDA card, without ANALYZE
(a single-table scan reads the chunks' seal-time sketches), and for
each ``--budget`` (bytes, or with a K/M/G suffix) sets
``sql.exec.hbm_budget_bytes`` and runs Q1 and Q6 through
``Engine.execute``: once cold, then ``--reps`` warm runs. For each it
reports the placement verdict (resident or stream-scan), the pages
uploaded and skipped, the p50 wall time of the warm runs, lineitem rows
per second per card (BASELINE.json's metric: the one card is the
chip), the host-to-device bytes of a run and their rate over its wall
time, the consumer's stall and the prefetch worker's overlap seconds,
and the peak device memory. Results are checked against the numpy
oracles (models/tpch.py ref_q1 at rel 1e-6, ref_q6 at rel 1e-9).
Prints one JSON object, with the card's name and power limit and the
host's memory, and writes it to ``--out``. ``--profile DIR`` then
profiles each (budget, query) with torch.profiler
(``profile_tpch.profile_queries``: device busy, copy and idle time,
top kernels; traces into DIR).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

GB_PER_SF = 1.8e9     # host bytes per scale unit (SF10 took 17.6 GB)
UNITS = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30}


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def meminfo() -> dict:
    """MemTotal and MemAvailable of the host, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) * 1024
    return out


def parse_bytes(text: str) -> int:
    text = text.strip().upper()
    if text and text[-1] in UNITS:
        return int(float(text[:-1]) * UNITS[text[-1]])
    return int(text)


def pick_sf(arg: str, available: int):
    """The scale to run: the number given, or for ``max`` the largest
    of 100 and 30 the host holds (None when neither fits)."""
    if arg != "max":
        return float(arg) if "." in arg else int(arg)
    for sf in (100, 30):
        if sf * GB_PER_SF <= available:
            return sf
    return None


def close(got, want, rel) -> bool:
    return abs(got - want) <= rel * max(abs(want), 1e-300)


def check(q: str, rows, want) -> None:
    if q == "q6":
        if not close(rows[0][0], want, 1e-9):
            raise AssertionError(f"Q6 {rows[0][0]} != oracle {want}")
        return
    if len(rows) != len(want):
        raise AssertionError(f"Q1: {len(rows)} groups, oracle {len(want)}")
    for g_row, w_row in zip(rows, want):
        if tuple(g_row[:2]) != tuple(w_row[:2]) or not all(
                close(g, float(w), 1e-6)
                for g, w in zip(g_row[2:], w_row[2:])):
            raise AssertionError(f"Q1 {g_row} != oracle {w_row}")


def run_query(eng, sql: str, s, reps: int) -> dict:
    import torch
    runs = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = eng.execute(sql, s)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated(),
                     eng.last_exec["paging"]))
    warm = runs[1:]
    p50 = statistics.median(t for t, _, _ in warm)
    pg = warm[-1][2]
    out = {"cold_s": runs[0][0], "p50_s": p50,
           "peak_bytes": max(m for _, m, _ in warm), "rows": res.rows}
    if pg is not None:
        out.update({
            "pages": pg["pages"], "skipped": pg["skipped"],
            "h2d_bytes": pg["bytes"],
            "h2d_gbps": statistics.median(p["bytes"] / t / 1e9
                                          for t, _, p in warm),
            "stall_s": statistics.median(p["stall_s"] for _, _, p in warm),
            "overlap_s": statistics.median(p["overlap_s"]
                                           for _, _, p in warm)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", default="10",
                    help="TPC-H scale, or max (the largest of 100 and 30 "
                    "the host holds)")
    ap.add_argument("--budget", action="append", required=True,
                    help="sql.exec.hbm_budget_bytes (repeatable; bytes "
                    "or a K/M/G suffix)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--page-rows", type=int, default=None,
                    help="SET streaming_page_rows (default 2^21)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also profile each (budget, query) into DIR")
    opts = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_stream: no CUDA device available", file=sys.stderr)
        return 1
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch

    host = meminfo()
    sf = pick_sf(opts.sf, host["MemAvailable"])
    card = smi()
    result = {"card": card, "host": host, "sf_arg": opts.sf, "sf": sf,
              "gb_per_sf": GB_PER_SF}
    if sf is None:
        result["skipped"] = (
            f"MemAvailable {host['MemAvailable']} bytes holds neither "
            f"SF100 ({100 * GB_PER_SF:.0f}) nor SF30 "
            f"({30 * GB_PER_SF:.0f})")
        print(json.dumps(result), flush=True)
        return 0
    t0 = time.perf_counter()
    eng = Engine()
    tpch.load(eng, sf=sf, tables=("lineitem",), encoded=True,
              analyze=False)
    n_rows = eng.store.table("lineitem").row_count
    result.update({"load_s": time.perf_counter() - t0,
                   "lineitem_rows": n_rows,
                   "host_after_load": meminfo()})
    t0 = time.perf_counter()
    li = tpch.gen_lineitem(sf, encoded=True)
    li["l_returnflag"] = np.asarray(tpch.RF_VALUES)[li["l_returnflag"]]
    li["l_linestatus"] = np.asarray(tpch.LS_VALUES)[li["l_linestatus"]]
    want = {"q1": tpch.ref_q1(li), "q6": tpch.ref_q6(li)}
    del li
    result["oracle_s"] = time.perf_counter() - t0
    print(json.dumps({"loaded": result}), flush=True)
    runs = []
    for b in opts.budget:
        budget = parse_bytes(b)
        eng.drop_device_cache()
        torch.cuda.empty_cache()
        eng.settings.set("sql.exec.hbm_budget_bytes", budget)
        for q, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
            s = eng.session()
            if opts.page_rows:
                eng.execute(f"SET streaming_page_rows = {opts.page_rows}",
                            s)
            verdict = eng.stream_verdict(sql, s)
            r = run_query(eng, sql, s, opts.reps)
            check(q, r.pop("rows"), want[q])
            r.update({"query": q, "budget": budget, "verdict": verdict,
                      "rows_per_s_per_chip": n_rows / r["p50_s"]})
            if opts.profile:
                from cockroach_tpu_torch.profile_tpch import profile_queries
                r["profile"] = profile_queries(
                    eng, {f"{q}_{b}": (sql, s)}, 1, opts.profile)[
                        f"{q}_{b}"]
            runs.append(r)
            print(json.dumps(r), flush=True)
    result["runs"] = runs
    text = json.dumps(result)
    print(text, flush=True)
    if opts.out:
        with open(opts.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
