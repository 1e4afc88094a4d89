"""The small-G kernel (csrc/groupagg.cu) timed alone at real queries' inputs.

    python3 -m cockroach_tpu_torch.bench_groupagg [--sf 1] [--reps 20]
        [--rounds 2] [--source PATH ...] [--out FILE]

Loads TPC-H lineitem at the given scale into the port's Engine on the
current CUDA card and runs, under ``SET pallas_groupagg = on``, Q1F, Q6F
and Q1F grouped by l_returnflag and l_shipmode (``Q1F_RF_SM``: 32 group
slots and 15 aggregate slots, a shape past the thread-private layout),
keeping the inputs each hands the kernel. Then, for every build of the
kernel (the checkout's ``csrc/groupagg.cu``, named "tree", and each
``--source``, a variant of that file with the same C interface, named
by its file's stem), and at each query's inputs for every accumulator
layout that fits the shape, it checks the result against the plain
version (counts exact, MIN/MAX bit for bit, f32 sums within rtol 1e-5)
and times the kernel alone: CUDA events around each of ``--reps``
launches, the outputs reset between them. The builds are visited in
order and then in reverse, ``--rounds`` times, so drift in the card's
clocks falls on every build alike. Prints one JSON object, and writes it to ``--out``:
the card's name and power limit, each query's shape, and per build,
query and layout the mean over the rounds and each round's time in ms.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

# Q1F broken down by return flag and ship mode: (3 + 1) x (7 + 1) dense
# group slots (one NULL slot per key), Q1F's 15 aggregate slots
Q1F_RF_SM = """
SELECT
    l_returnflag,
    l_shipmode,
    sum(l_quantity::FLOAT8) AS sum_qty,
    sum(l_extendedprice::FLOAT8) AS sum_base_price,
    sum((l_extendedprice * (1 - l_discount))::FLOAT8) AS sum_disc_price,
    sum((l_extendedprice * (1 - l_discount) * (1 + l_tax))::FLOAT8)
        AS sum_charge,
    avg(l_quantity::FLOAT8) AS avg_qty,
    avg(l_extendedprice::FLOAT8) AS avg_price,
    avg(l_discount::FLOAT8) AS avg_disc,
    count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= date '1998-12-01' - interval '90 day'
GROUP BY l_returnflag, l_shipmode
ORDER BY l_returnflag, l_shipmode
"""


def _check(tg, args, got) -> None:
    """`got` (acc, cnt) against the plain version on the same inputs."""
    import numpy as np
    import torch
    gid, sel, vals, masks, G, ops = args
    pa, pc = tg.dense_group_aggregate_plain(*args)
    ka, kc, pa, pc = (t.cpu().numpy() for t in (*got, pa, pc))
    if not np.array_equal(kc, pc):
        raise AssertionError("counts differ from the plain version")
    for a, op in enumerate(ops):
        k, p = ka[:, a], pa[:, a]
        if op == tg.SUM:
            fin = ~np.isnan(p)
            if not (np.array_equal(np.isnan(k), ~fin) and np.all(
                    np.abs(k[fin] - p[fin].astype(np.float64))
                    <= 1e-5 * np.abs(p[fin]))):
                raise AssertionError(f"slot {a}: sums beyond rtol 1e-5")
        else:
            nan = np.isnan(p)
            if not (np.array_equal(np.isnan(k), nan) and np.array_equal(
                    k[~nan].view(np.int32), p[~nan].view(np.int32))):
                raise AssertionError(f"slot {a}: MIN/MAX differ")
    torch.cuda.synchronize()


def kernel_ms(args, strategy: str | None = None, lib=None,
              reps: int = 20) -> float:
    """Mean device time of one launch of the small-G kernel at `args`
    (gid, sel, values, masks, G, ops on the card): CUDA events around
    each of `reps` launches, the outputs reset to their identities
    between them. strategy: the layout (default choose_strategy's);
    lib: a build of the kernel (default the checkout's)."""
    import torch

    from .ops.cuda import groupagg as tg
    G, ops = args[4], args[5]
    launch, acc, cnt = tg._launcher(
        *args, strategy or tg.choose_strategy(G, len(ops)),
        lib or tg._lib())
    acc0, cnt0 = acc.clone(), cnt.clone()
    launch()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        acc.copy_(acc0)
        cnt.copy_(cnt0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--source", action="append", default=[], type=Path,
                    help="a variant of csrc/groupagg.cu to time beside it")
    ap.add_argument("--out", default="chiprun_out/bench_groupagg.json")
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_groupagg: no CUDA device available", file=sys.stderr)
        return 1

    from .exec.engine import Engine
    from .models import tpch
    from .ops.cuda import build
    from .ops.cuda import groupagg as tg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    names = {"tree": "groupagg"}
    names.update({src.stem: src.resolve() for src in a.source})
    if len(names) != 1 + len(a.source):
        raise ValueError("two builds share a name")
    logs = build.compile_all(list(names.values()))
    for b, src in names.items():
        for line in logs[src].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {b}: {line.strip()}", flush=True)
    libs = {k: tg.typed(build.load(v)) for k, v in names.items()}

    eng = Engine()
    tpch.load(eng, sf=a.sf, tables=("lineitem",), encoded=True)
    on = eng.session()
    eng.execute("SET pallas_groupagg = on", on)
    captured = {}
    kernel = tg.dense_group_aggregate
    try:
        for q, sql in (("q1f", tpch.Q1F), ("q6f", tpch.Q6F),
                       ("q1f_rf_sm", Q1F_RF_SM)):
            def recording(*args, q=q):
                captured.setdefault(q, args)
                return kernel(*args)
            tg.dense_group_aggregate = recording
            eng.execute(sql, on)
    finally:
        tg.dense_group_aggregate = kernel
    shapes = {}
    for q, (gid, sel, vals, masks, G, ops) in captured.items():
        captured[q] = (gid, sel, tuple(vals), tuple(masks), G, tuple(ops))
        plan = tg.column_plan(sel, vals, masks, ops)
        shapes[q] = {"n": gid.shape[0], "G": G, "A": len(ops),
                     "distinct_masks": len(plan.masks),
                     "distinct_values": len(plan.values),
                     "chosen": tg.choose_strategy(G, len(ops))}
    print("shapes: " + json.dumps(shapes), flush=True)

    times = {b: {q: {s: [] for s in tg.fitting_strategies(
        shapes[q]["G"], shapes[q]["A"])} for q in captured} for b in libs}
    order, checked = list(libs), set()
    for r in range(a.rounds):
        for b in order + order[::-1]:
            for q, args in captured.items():
                for s in times[b][q]:
                    if (b, q, s) not in checked:
                        _check(tg, args, tg._launch(*args, s, libs[b]))
                        checked.add((b, q, s))
                    times[b][q][s].append(
                        kernel_ms(args, s, libs[b], a.reps))
    out = {"card": smi, "sf": a.sf, "reps": a.reps, "rounds": a.rounds,
           "shapes": shapes,
           "ms": {b: {q: {s: {"mean": sum(v) / len(v), "each": v}
                          for s, v in qs.items()}
                      for q, qs in bq.items()} for b, bq in times.items()}}
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
