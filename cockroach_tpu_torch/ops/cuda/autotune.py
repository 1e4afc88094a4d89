"""Launch-point autotuner for kernel 1 (csrc/groupagg_large.cu).

The port of cockroach_tpu/ops/pallas/autotune.py. Kernel 1 shipped with
launch constants picked by hand (BLOCK = 256 threads, ROWS = 4 rows a
thread a tile, MIN_BLOCKS = 4 blocks an SM); the library now holds one
instantiation per point of ``groupagg_large.KERNEL_POINTS`` and the
wrapper selects one at launch. A point here adds the limb-width cap:
``(block, rows, min_blocks, limb_cap)``. This module times the
candidate points with CUDA events when asked (``on``) and keeps the
winner in a tuning table under the cache root (exec/coldstart.py),
keyed by the card's name; a restarted process reads the table instead
of timing again. A candidate displaces the shipped point only when it
is faster by more than ``MARGIN``: below that, sweeps of one card in
separate processes disagree about the winner, so a smaller lead is
noise, not a property of the point.

Exactness is the rule for every point: a point's limb width is
``limb_width(n, max_group_rows, block_rows=block * rows,
cap=limb_cap)``, so both the tile's partial limb sums and every
group's int32 running sum stay exact, and any point gives bit-identical
results; the tuner only picks the fastest. A corrupt, stale or foreign
table degrades to the shipped point, and the miss is counted
(``exec.autotune.table_miss``). A point that fails to build or launch
on the card raises: nothing is skipped quietly.

Modes (session variable ``pallas_autotune``, else the cluster setting
``sql.exec.pallas.autotune``): ``auto`` reads the table and, without
an entry for the card, uses the shipped point (it never sweeps); ``on``
sweeps when the table has no entry (on the CPU through the caller's
timer, since the plain version does not depend on the point); ``off``
uses the shipped point and reads nothing.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Callable, NamedTuple

import torch

from ...utils.metric import Tally
from . import groupagg_large as pgl

TABLE_VERSION = 1
_TABLE_NAME = "cuda_autotune.json"

# (block, rows, min_blocks, limb_cap): threads a block, rows a thread a
# tile, blocks an SM the registers are capped for, the limb width cap.
# Small on purpose: each point is a template instantiation.
CANDIDATES: tuple[tuple[int, int, int, int], ...] = (
    (256, 4, 4, 22),   # the shipped point
    (128, 4, 8, 22),
    (512, 4, 2, 22),
    (256, 2, 4, 22),
    (256, 8, 2, 22),
    (256, 4, 4, 16),   # narrower limbs: more limb rows, fewer bits each
)
DEFAULT = CANDIDATES[0]
MODES = ("auto", "on", "off")

# the lead over the shipped point a winner needs, as a fraction of the
# shipped point's time (PERF.md: sweeps on one H100 in separate calls
# named different winners, each within 7% of the shipped point)
MARGIN = 0.10

# (rows, groups) a card's sweep times each point at: the reference's
# synthetic shape (_time_candidate), and a Q1-sized one whose groups
# overflow shared memory, so both accumulator layouts are timed
CUDA_SHAPES = ((1 << 16, 1 << 12), (1 << 22, 1 << 16))
CPU_SHAPES = ((1 << 10, 256),)

RUNS = Tally()    # "sweep": sweeps run; "candidate": points timed;
                  # "seconds": wall seconds spent sweeping
TABLE = Tally()   # "hit" | "miss": tuning-table lookups

_LOCK = threading.Lock()
_MEM: dict = {}     # (root, device key) -> point


class Sweep(NamedTuple):
    best: tuple
    timings: dict   # "BxRmMwC" -> seconds


def register_metrics(metrics) -> None:
    metrics.func_counter(
        "exec.autotune.runs", lambda: RUNS.value("sweep"),
        "kernel-1 launch-point sweeps run (first use per card without "
        "a tuning table)")
    metrics.func_counter(
        "exec.autotune.seconds", lambda: RUNS.value("seconds"),
        "wall seconds spent timing launch points")
    metrics.func_counter(
        "exec.autotune.table_hit", lambda: TABLE.value("hit"),
        "launch-point lookups served by the tuning table")
    metrics.func_counter(
        "exec.autotune.table_miss", lambda: TABLE.value("miss"),
        "launch-point lookups that fell back to the shipped point (no, "
        "corrupt, stale or foreign table, and no sweep admitted)")


def point_name(p) -> str:
    return f"{p[0]}x{p[1]}m{p[2]}w{p[3]}"


def table_path(root: str) -> str:
    return os.path.join(root, _TABLE_NAME)


def _valid_entry(e) -> tuple | None:
    if not isinstance(e, dict):
        return None
    try:
        p = (int(e["block"]), int(e["rows"]), int(e["min_blocks"]),
             int(e["limb_cap"]))
    except (KeyError, TypeError, ValueError):
        return None
    return p if p in CANDIDATES else None


def load_table(root: str) -> dict:
    """The table's entries by device key; a missing, unparsable or
    other-version table reads as empty."""
    try:
        with open(table_path(root), encoding="utf-8") as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict) or raw.get("version") != TABLE_VERSION:
        return {}
    tables = raw.get("tables")
    return tables if isinstance(tables, dict) else {}


def table_point(key: str, root: str | None) -> tuple | None:
    """The point the table holds for ``key``, or None (no, corrupt,
    stale or foreign table). Counts nothing."""
    return _valid_entry(load_table(root).get(key)) if root else None


def _save(root: str, key: str, point: tuple, timings: dict) -> None:
    """Write the table atomically (a temp file and os.replace): test
    workers and engines of other processes share the root."""
    tables = load_table(root)
    tables[key] = {"block": point[0], "rows": point[1],
                   "min_blocks": point[2], "limb_cap": point[3],
                   "timings": timings}
    os.makedirs(root, exist_ok=True)
    tmp = f"{table_path(root)}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"version": TABLE_VERSION, "tables": tables}, f,
                  indent=1, sort_keys=True)
    os.replace(tmp, table_path(root))


def synthetic_slots(point: tuple, n: int, num_groups: int,
                    device) -> tuple:
    """The reference's synthetic shape (``_time_candidate``): one int64
    sum with its f32 shadow, counts, one MIN slot and REPMIN, the limb
    width following the point's own exactness bound. Returns (gid, sel,
    slots, num_groups, want_rep)."""
    import numpy as np
    w = pgl.limb_width(n, n, block_rows=point[0] * point[1], cap=point[3])
    k = -(-64 // w)
    rng = np.random.default_rng(n + point[0] + point[1])
    gid = torch.tensor(rng.integers(0, num_groups, n), dtype=torch.int32,
                       device=device)
    sel = torch.tensor(rng.random(n) < 0.9, device=device)
    vals = torch.tensor(rng.integers(0, 1 << w, n), dtype=torch.int64,
                        device=device)
    mm = torch.tensor(rng.random(n), dtype=torch.float32, device=device)
    slots = (pgl.i64sum(vals, None, w, k), pgl.count(),
             pgl.minmax(mm, None, pgl.MIN))
    return gid, sel, slots, num_groups, True


def cuda_timer(point: tuple, run: Callable[[], object]) -> float:
    """Median of three timed runs after one untimed, CUDA events."""
    run()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    return sorted(times)[1]


def host_timer(point: tuple, run: Callable[[], object]) -> float:
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def autotune(key: str, root: str | None, device,
             timer: Callable | None = None, shapes: tuple | None = None,
             candidates=CANDIDATES, workloads: tuple = ()) -> Sweep:
    """Time every candidate point, persist the winner under ``key``
    (and make it this process's point for ``key``), return it with
    every point's seconds. Each point is timed at each synthetic
    ``shapes`` entry and at each of ``workloads`` (callables of a point
    returning a run callable, e.g. a query's captured slots); its score
    is the sum. The fastest point wins only if it beats the shipped one
    by more than ``MARGIN``. On a card the runs launch the kernel; on
    the CPU they take the plain version, which the point does not
    change, so only an injected ``timer`` makes the sweep mean
    something there. A point that fails raises."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if timer is None:
        timer = cuda_timer if cuda else host_timer
    if shapes is None:
        shapes = CUDA_SHAPES if cuda else CPU_SHAPES
    fn = pgl.aggregate_slots if cuda else pgl.aggregate_slots_plain
    RUNS.bump("sweep")
    t0 = time.perf_counter()
    best, best_t, timings = DEFAULT, math.inf, {}
    for p in candidates:
        dt = 0.0
        for n, num_groups in shapes:
            gid, sel, slots, g, rep = synthetic_slots(p, n, num_groups,
                                                      dev)

            def run(p=p, gid=gid, sel=sel, slots=slots, g=g, rep=rep):
                return fn(gid, sel, slots, g, rep, point=p)

            dt += timer(p, run)
            del gid, sel, slots
        for wl in workloads:
            dt += timer(p, wl(p))
        RUNS.bump("candidate")
        timings[point_name(p)] = dt
        if dt < best_t:
            best, best_t = p, dt
    shipped = timings.get(point_name(DEFAULT))
    if shipped is not None and best_t >= shipped * (1 - MARGIN):
        best = DEFAULT
    RUNS.bump("seconds", time.perf_counter() - t0)
    if root:
        _save(root, key, best, timings)
        with _LOCK:
            _MEM[(root, key)] = best
    return Sweep(best, timings)


def params_for(key: str, root: str | None, mode: str, device,
               timer: Callable | None = None) -> tuple:
    """The launch point the engine builds kernel-1 plans with (module
    docstring for the modes). A table hit or a sweep's winner is kept
    for (root, key) for the rest of the process; only ``on`` sweeps, and
    a sweep's failure raises."""
    if mode not in MODES:
        raise ValueError(f"pallas_autotune = {mode} is not a mode "
                         "(auto, on, off)")
    if mode == "off":
        return DEFAULT
    if not root:
        TABLE.bump("miss")
        return DEFAULT
    mkey = (root, key)
    with _LOCK:
        hit = _MEM.get(mkey)
    if hit is not None:
        TABLE.bump("hit")
        return hit
    entry = table_point(key, root)
    if entry is not None:
        with _LOCK:
            _MEM[mkey] = entry
        TABLE.bump("hit")
        return entry
    TABLE.bump("miss")
    if mode == "on":
        return autotune(key, root, device, timer).best
    return DEFAULT


def forget() -> None:
    """Drop the in-process memo (a test's fresh start)."""
    with _LOCK:
        _MEM.clear()
