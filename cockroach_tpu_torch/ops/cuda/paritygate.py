"""Fuzzed bit-parity gate for promoting kernel-1 paths into `auto`.

The port of cockroach_tpu/ops/pallas/paritygate.py. Routing under
`auto` may never change a result, which is why kernel 1's float
accumulation and its MIN/MAX shipped behind `on`. The ordered-int
MIN/MAX path is exact by construction (the kernel reduces an
order-preserving high limb, and a plain fold refines the winner to the
full-width value, so every result is an input value), but that is an
argument about the arithmetic. This module makes it a measured verdict:
on first use per card it fuzzes each path through kernel 1's wrapper
against an oracle of plain int64/float64 scatters, bit for bit, in both
accumulator layouts (a group count that fits shared memory and one past
it) and at the launch point the engine launches with, and keeps the
verdicts in a table under the cache root (exec/coldstart.py), keyed by
the card's name. A verdict holds only for the kernel source it was
fuzzed on (``build.source_tag`` of csrc/groupagg_large.cu) and for its
launch point: after an edit of the kernel, or at another point, the
fuzz runs again. `auto` then admits exactly the promoted paths
(exec/compile.py ``_pallas_large_ok``).

Paths:

- ``int_minmax``: INT/DECIMAL MIN/MAX through the kernel's high limb
  ``value >> MM_HI_SHIFT`` (|limb| < 2^23: exact and order-preserving in
  f32) and ``refine_int_minmax``. Expected exact everywhere.
- ``float_sum``: FLOAT SUM/AVG accumulated in f32. Expected not to
  match the float64 oracle; fuzzed all the same, so the verdict is a
  measurement.

On a card the fuzz launches the CUDA kernel (``aggregate_slots``); on
the CPU it runs the wrapper's plain version (``aggregate_slots_plain``,
which leaves the wrapper's call counts alone), which still tests the
high-limb-plus-refinement formulation. Unlike the reference, a fuzz
that raises on a card raises to the caller: nothing demotes quietly.
"""

from __future__ import annotations

import json
import os
import threading
import time

import torch

from ...utils.metric import Tally

TABLE_VERSION = 1
_TABLE_NAME = "cuda_paritygate.json"

# arithmetic right shift putting an int64's order-preserving high limb
# into f32-exact range: 64 - 40 = 24 magnitude bits -> |limb| <= 2^23
MM_HI_SHIFT = 40

PATHS = ("int_minmax", "float_sum")

CHECKS = Tally()  # "exact" | "approx": verdicts computed; "seconds"
TABLE = Tally()   # "hit" | "miss": verdict-table lookups

_LOCK = threading.Lock()
_MEM: dict = {}     # (root, device key) -> promoted paths


def register_metrics(metrics) -> None:
    metrics.func_counter(
        "exec.paritygate.checks",
        lambda: CHECKS.value("exact") + CHECKS.value("approx"),
        "parity-gate fuzz verdicts computed (first use per card "
        "without a verdict table)")
    metrics.func_counter(
        "exec.paritygate.seconds", lambda: CHECKS.value("seconds"),
        "wall seconds spent fuzzing kernel-1 paths against the plain "
        "int64/float64 oracle")
    metrics.func_counter(
        "exec.paritygate.table_hit", lambda: TABLE.value("hit"),
        "promotion lookups served by the verdict table")
    metrics.func_counter(
        "exec.paritygate.table_miss", lambda: TABLE.value("miss"),
        "promotion lookups with no usable verdict table (none, "
        "corrupt or another version): the fuzz runs")


def table_path(root: str) -> str:
    return os.path.join(root, _TABLE_NAME)


def load_table(root: str) -> dict:
    try:
        with open(table_path(root), encoding="utf-8") as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict) or raw.get("version") != TABLE_VERSION:
        return {}
    tables = raw.get("tables")
    return tables if isinstance(tables, dict) else {}


def _kernel_tag() -> str:
    from . import build
    return build.source_tag("groupagg_large")


def _point_tag(point) -> str:
    from . import groupagg_large as pgl
    return "x".join(str(v) for v in pgl.kernel_point(point))


def _save(root: str, key: str, exact: tuple, point) -> None:
    """Atomic write (a temp file and os.replace): the root is shared."""
    tables = load_table(root)
    tables[key] = {"exact": sorted(exact), "kernel": _kernel_tag(),
                   "point": _point_tag(point)}
    os.makedirs(root, exist_ok=True)
    tmp = f"{table_path(root)}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({"version": TABLE_VERSION, "tables": tables}, f,
                  indent=1, sort_keys=True)
    os.replace(tmp, table_path(root))


def refine_int_minmax(d0, passes, gid, winner, num_groups: int,
                      op: str):
    """The full-width INT MIN/MAX from the kernel's high-limb winner:
    the plain fold (dtype-preserving) over only the rows that pass and
    hold their group's winning limb. ``winner``: the kernel's f32 row
    (+/-inf for an empty group); ``passes``: sel AND the argument's
    validity."""
    from .. import agg as aggops
    rowhi = d0.to(torch.int64) >> MM_HI_SHIFT
    # an empty group's +/-inf has no int64 value: park it at 0 (no row
    # of that group passes)
    win = torch.where(torch.isfinite(winner), winner, 0.0).to(torch.int64)
    g = torch.clamp(gid.to(torch.int64), 0, num_groups - 1)
    refine = torch.logical_and(passes, rowhi == win[g])
    fold = aggops.group_min if op == "min" else aggops.group_max
    return fold(d0, gid, refine, num_groups)


def _oracle(values, gid, passes, num_groups: int, reduce: str):
    """Plain scatter of int64 (amin/amax) or float64 (sum) values over
    the rows that pass, [G]."""
    slot = torch.where(passes, gid.to(torch.int64), num_groups)
    if reduce == "sum":
        out = torch.zeros(num_groups + 1, dtype=torch.float64,
                          device=values.device)
        out.index_add_(0, slot, values.to(torch.float64))
        return out[:num_groups]
    info = torch.iinfo(torch.int64)
    ident = info.max if reduce == "amin" else info.min
    out = torch.full((num_groups + 1,), ident, dtype=torch.int64,
                     device=values.device)
    out.scatter_reduce_(0, slot, values, reduce=reduce, include_self=True)
    return out[:num_groups]


def _cases(device) -> tuple:
    """(rows, groups) of the fuzz: on a card, 256 groups take the
    shared-memory layout and 2^16 the global-atomics one."""
    if device.type == "cpu":
        return ((512, 64), (512, 4096))
    return ((4096, 256), (1 << 18, 1 << 16))


def _run_fn(device, point):
    """The wrapper (the kernel on a card, the plain version on the CPU)
    at ``point``; on a card it also notes the layout each call takes."""
    from . import groupagg_large as pgl
    layouts: set = set()
    if device.type != "cuda":
        def run(gid, sel, slots, g):
            return pgl.aggregate_slots_plain(gid, sel, slots, g,
                                             point=point)
        return run, None

    def run(gid, sel, slots, g):
        layouts.add(pgl.choose_layout(pgl.plan_slots(gid, sel, slots, g)))
        return pgl.aggregate_slots(gid, sel, slots, g, point=point)
    return run, layouts


def _covered(layouts) -> bool:
    """An exact verdict on a card must have seen both layouts."""
    from . import groupagg_large as pgl
    if layouts is not None and layouts != set(pgl.LAYOUTS):
        raise AssertionError(f"the fuzz took the layouts {sorted(layouts)}"
                             f", not {list(pgl.LAYOUTS)}")
    return True


def _fuzz_int_minmax(device, point=None) -> bool:
    """Kernel high-limb MIN/MAX plus refinement against plain int64
    scatters, over seeded int64 data spanning sign changes and
    magnitudes past 2^24 (where an f32 MIN/MAX of the value is wrong)."""
    import numpy as np

    from . import groupagg_large as pgl
    fn, layouts = _run_fn(device, point)
    for (n, g), seed in ((c, s) for c in _cases(device) for s in range(3)):
        rng = np.random.default_rng(1000 + seed)
        gid = torch.tensor(rng.integers(0, g, n), dtype=torch.int32,
                           device=device)
        sel = torch.tensor(rng.random(n) < 0.85, device=device)
        vals = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)
        small = rng.random(n) < 0.3  # mix in sub-2^24 magnitudes
        vals[small] = rng.integers(-100, 100, int(small.sum()))
        d = torch.tensor(vals, device=device)
        res = fn(gid, sel, (pgl.minmax(d, None, pgl.MIN),
                            pgl.minmax(d, None, pgl.MAX), pgl.count()),
                 g)
        live = res.acc_i[res.rows[2]] > 0
        for s, op, red in ((0, "min", "amin"), (1, "max", "amax")):
            got = refine_int_minmax(d, sel, gid, res.acc_f[res.rows[s]],
                                    g, op)
            want = _oracle(d, gid, sel, g, red)
            if not torch.equal(got[live], want[live]):
                return False
    return _covered(layouts)


def _fuzz_float_sum(device, point=None) -> bool:
    """Kernel f32-accumulated FLOAT sum against the float64 oracle, bit
    for bit: one rounding difference demotes the path."""
    import numpy as np

    from . import groupagg_large as pgl
    fn, layouts = _run_fn(device, point)
    for (n, g), seed in ((c, s) for c in _cases(device) for s in range(3)):
        rng = np.random.default_rng(2000 + seed)
        gid = torch.tensor(rng.integers(0, g, n), dtype=torch.int32,
                           device=device)
        sel = torch.tensor(rng.random(n) < 0.85, device=device)
        d = torch.tensor(rng.standard_normal(n) * 1e3, device=device)
        res = fn(gid, sel, (pgl.f32sum(d, None), pgl.count()), g)
        got = res.acc_f[res.rows[0]].to(torch.float64)
        want = _oracle(d, gid, sel, g, "sum")
        live = res.acc_i[res.rows[1]] > 0
        if not torch.equal(got[live], want[live]):
            return False
    return _covered(layouts)


_FUZZERS = {"int_minmax": _fuzz_int_minmax,
            "float_sum": _fuzz_float_sum}


def fuzz(key: str, root: str | None, device,
         point=None) -> tuple[str, ...]:
    """Run every path's fuzz on ``device`` at the launch point ``point``
    (the shipped one when None), persist and return the paths found
    exact. A fuzz that raises raises."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    exact = []
    for path in PATHS:
        ok = _FUZZERS[path](dev, point)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        CHECKS.bump("exact" if ok else "approx")
        if ok:
            exact.append(path)
    CHECKS.bump("seconds", time.perf_counter() - t0)
    out = tuple(exact)
    if root:
        _save(root, key, out, point)
    return out


def promoted(key: str, root: str | None, device,
             point=None) -> tuple[str, ...]:
    """The kernel-1 paths `auto` may take on this card at the launch
    point ``point``: the persisted verdicts for this kernel source and
    point, or one fuzz on first use (memoized per process; without a
    root the fuzz still runs, so a cacheless engine routes the same)."""
    mkey = (root, key, _point_tag(point))
    with _LOCK:
        hit = _MEM.get(mkey)
    if hit is not None:
        TABLE.bump("hit")
        return hit
    if root:
        entry = load_table(root).get(key)
        ok = isinstance(entry, dict) \
            and entry.get("kernel") == _kernel_tag() \
            and entry.get("point") == _point_tag(point)
        paths = entry.get("exact") if ok else None
        if isinstance(paths, list) and all(p in PATHS for p in paths):
            out = tuple(sorted(paths))
            with _LOCK:
                _MEM[mkey] = out
            TABLE.bump("hit")
            return out
    TABLE.bump("miss")
    out = fuzz(key, root, device, point)
    with _LOCK:
        _MEM[mkey] = out
    return out


def forget() -> None:
    """Drop the in-process memo (a test's fresh start)."""
    with _LOCK:
        _MEM.clear()
