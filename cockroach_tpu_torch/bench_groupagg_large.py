"""The large-G kernel (csrc/groupagg_large.cu) timed alone at real queries' inputs.

    python3 -m cockroach_tpu_torch.bench_groupagg_large [--sf 1] [--reps 20]
        [--rounds 2] [--source PATH ...] [--out FILE]

Loads every TPC-H table at the given scale into the port's Engine on the
current CUDA card and runs Q1, Q5, Q10 and Q12 (default
``pallas_groupagg = auto``), keeping the slots each hands the kernel
and the launch point the engine resolved (``point``, printed per query):
every launch below is at that point. Then, at each query's inputs:
- for every build of the kernel (the checkout's csrc/groupagg_large.cu,
  named "tree", and each ``--source``, a variant of that file with the
  same C interface, named by its file's stem), in the accumulator layout
  the wrapper chooses for the shape (``choose_layout``), it checks the
  kernel against the plain version (``groupagg_large_check.
  compare_plain``: integer rows and max-|value| exactly, MIN/MAX rows
  bit for bit, f32 sums within 1e-5 of the group's sum of magnitudes)
  and times the kernel alone: CUDA events around ``--reps`` bare
  launches back to back (the library's init kernel and the aggregation
  kernel), the launch prepared beforehand. The builds are visited in
  order and then in reverse, ``--rounds`` times, so drift in the card's
  clocks falls on each alike;
- it times the wrapper (``aggregate_slots``: planning, allocation,
  launch) with CUDA events, and its host time per call and that of each
  part (host clock over back-to-back calls, no synchronisation inside);
- it times the aggregation stage both ways, in turns: the pre-built
  route (the limb, count, shadow and MIN/MAX columns built with PyTorch
  ops, one set per aggregate, and fed through the pre-built-column
  interface, plus the sentinel's eager max-|value|; the TPU kernel's
  layout) against the slots.
Bounds: bytes each way (the slots' distinct columns, and the pre-built
columns), each read once, outputs written once, over 3.35 TB/s, and by
content (columns equal in content once; a mask whose AND with sel
equals sel, or another mask's, not at all). Prints
one JSON object, and writes it to ``--out``: the card's name and power
limit, each query's shape, bounds and times.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def events_ms(fn, reps: int = 20, warm: int = 2) -> float:
    """Mean device time of fn() over `reps` calls, CUDA events around
    each call, after `warm` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def kernel_ms(plan, layout: str | None = None, reps: int = 20,
              lib=None, point=None) -> float:
    """Mean device time of one bare launch of the large-G kernel (its
    init kernel and the aggregation) at a plan, the launch prepared
    beforehand: CUDA events around `reps` launches back to back, so the
    card does not wait on the host between them. lib: a build of the
    kernel (default the checkout's); point: the launch point (default
    the shipped one)."""
    import torch

    from .ops.cuda import groupagg_large as tgl
    layout = layout or tgl.choose_layout(plan)
    run, _ = tgl.launcher(plan, layout, lib or tgl._lib(),
                          tgl.kernel_point(point))
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds per call of fn, back to back, no sync inside."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def slot_bytes(plan) -> int:
    """Bytes the slots need: gid, sel, each distinct value column and
    mask read once, the outputs written once."""
    n = plan.gid.shape[0]
    per_row = plan.gid.element_size() + 1 \
        + sum(c.element_size() for c in plan.cols) + len(plan.masks)
    return n * per_row + (plan.nf + plan.ni) * plan.num_groups * 4 \
        + plan.n_mx * 8


def content_bytes(plan) -> int:
    """Bytes the function needs by content: gid, sel, the value columns
    that differ in content, and the masks whose AND with sel differs
    from sel and from each other's (a NOT NULL argument's validity
    selects every row sel does, so it need not be read), each read
    once, the outputs written once."""
    import torch
    n = plan.gid.shape[0]
    sel = plan.sel.to(torch.bool)
    cols, masks = [], [sel]
    for c in plan.cols:
        if not any(c.dtype == k.dtype and torch.equal(c, k) for k in cols):
            cols.append(c)
    for m in plan.masks:
        m = sel & m.to(torch.bool)
        if not any(torch.equal(m, k) for k in masks):
            masks.append(m)
    per_row = plan.gid.element_size() \
        + sum(c.element_size() for c in cols) + len(masks)
    return n * per_row + (plan.nf + plan.ni) * plan.num_groups * 4 \
        + plan.n_mx * 8


def prebuilt_columns(gid, sel, slots, want_rep):
    """The pre-built route: every slot's f32 columns cut with PyTorch ops
    as the TPU kernel's caller cuts them (no folding): per i64sum its k
    limb columns and its shadow, per count its mask, per f32sum its
    masked value, per minmax its masked operand (the high limb of an
    integer column). Returns the pre-built-column interface's arguments
    and, per i64sum slot, the sentinel's max |value| (float64, eager)."""
    import torch

    from .ops import agg as aggops
    from .ops.cuda import groupagg_large as tgl
    f_cols, i_cols, mm_cols, mm_ops, amax = [], [], [], [], []
    for s in slots:
        m = sel if s.mask is None else torch.logical_and(sel, s.mask)
        if s.kind == "count":
            i_cols.append(m.to(torch.float32))
        elif s.kind == "i64sum":
            dz = torch.where(m, s.value.to(torch.int64), 0)
            for j in range(s.k):
                i_cols.append(aggops.limb(dz, j, s.w).to(torch.float32))
            f_cols.append(dz.to(torch.float32))
            dz64 = torch.where(m, s.value, torch.zeros_like(s.value)) \
                .to(torch.float64)
            amax.append(torch.amax(torch.abs(dz64)))
        elif s.kind == "f32sum":
            f_cols.append(torch.where(m, s.value, 0).to(torch.float32))
        else:
            ident = math.inf if s.op == tgl.MIN else -math.inf
            v = s.value
            v = (v.to(torch.int64) >> tgl.MM_HI_SHIFT) \
                if not v.is_floating_point() else v
            mm_cols.append(torch.where(m, v.to(torch.float32), ident))
            mm_ops.append(s.op)
    mat = tuple(f_cols) + tuple(i_cols)
    mat_int = (False,) * len(f_cols) + (True,) * len(i_cols)
    return (gid, sel, mat, tuple(mm_cols), mat_int, tuple(mm_ops),
            want_rep), amax


def prebuilt_bytes(args, num_groups: int) -> int:
    """The pre-built route's bound: gid, sel and every pre-built column
    read once, the outputs written once."""
    gid, sel, mat, mm, mat_int, mm_ops, want_rep = args
    n = gid.shape[0]
    nf = max(1, sum(not b for b in mat_int) + len(mm))
    ni = max(1, sum(bool(b) for b in mat_int) + int(want_rep))
    return n * (4 * len(mat) + 4 * len(mm) + 4 + 1) \
        + (nf + ni) * num_groups * 4


def stage_prebuilt(gid, sel, slots, G, want_rep):
    """The pre-built route's aggregation stage: columns, kernel,
    sentinel bound."""
    from .ops.cuda import groupagg_large as tgl
    (g, s, mat, mm, mat_int, mm_ops, rep), amax = prebuilt_columns(
        gid, sel, slots, want_rep)
    return tgl.large_group_aggregate(g, s, mat, mm, G, mat_int, mm_ops,
                                     rep), amax


def stage_slots(gid, sel, slots, G, want_rep, point=None):
    """The aggregation stage over slots: the kernel at the launch point,
    and its max-|value| words as the sentinel's float64 bound."""
    import torch

    from .ops.cuda import groupagg_large as tgl
    res = tgl.aggregate_slots(gid, sel, slots, G, want_rep, point=point)
    return res, torch.where(res.maxabs < 0, 2.0 ** 63,
                            res.maxabs.to(torch.float64))


def capture(eng, queries: dict) -> dict:
    """Run each {name: sql} once, keeping the (gid, sel, slots, G,
    want_rep, point) it hands the large-G kernel: the point is the launch
    point the engine resolved. Each runs once before: its first plan
    build may fuzz the parity gate, whose launches are not the query's."""
    from .ops.cuda import groupagg_large as tgl
    captured = {}
    kernel = tgl.aggregate_slots
    try:
        for q, sql in queries.items():
            eng.execute(sql)
            def recording(gid, sel, slots, num_groups, want_rep=False,
                          point=None, q=q):
                captured.setdefault(q, (gid, sel, tuple(slots),
                                        num_groups, bool(want_rep),
                                        point))
                return kernel(gid, sel, slots, num_groups, want_rep,
                              point=point)
            tgl.aggregate_slots = recording
            eng.execute(sql)
    finally:
        tgl.aggregate_slots = kernel
    return captured


def shape(args) -> dict:
    """A query's kernel shape and its byte bounds: by the slots read
    (``bound_ms``), by content (``content_bound_ms``) and by the
    pre-built columns (``prebuilt_bound_ms``)."""
    from .ops.cuda import groupagg_large as tgl
    gid, sel, slots, G, want_rep = args[:5]
    plan = tgl.plan_slots(*args)
    pre, _ = prebuilt_columns(gid, sel, slots, want_rep)
    nbytes, pbytes = slot_bytes(plan), prebuilt_bytes(pre, G)
    cbytes = content_bytes(plan)
    return {"n": gid.shape[0], "G": G, "slots": len(slots),
            "kernel_slots": len(plan.kslots), "value_columns":
            [str(c.dtype).replace("torch.", "") for c in plan.cols],
            "masks": len(plan.masks), "nf": plan.nf, "ni": plan.ni,
            "prebuilt_columns": len(pre[2]) + len(pre[3]),
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "content_bytes": cbytes,
            "content_bound_ms": cbytes / HBM_BYTES_PER_S * 1e3,
            "prebuilt_bytes": pbytes,
            "prebuilt_bound_ms": pbytes / HBM_BYTES_PER_S * 1e3,
            "layout": tgl.choose_layout(plan)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--source", action="append", default=[], type=Path,
                    help="a variant of csrc/groupagg_large.cu to time "
                    "beside it")
    ap.add_argument("--out", default="chiprun_out/bench_groupagg_large.json")
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("bench_groupagg_large: no CUDA device available",
              file=sys.stderr)
        return 1

    from .exec.engine import Engine
    from .models import tpch
    from .ops.cuda import build
    from .ops.cuda import groupagg_large as tgl
    from .ops.cuda.groupagg_large_check import compare_plain

    card = smi()
    print(f"card: {card}", flush=True)
    names = {"tree": "groupagg_large"}
    names.update({src.stem: src.resolve() for src in a.source})
    if len(names) != 1 + len(a.source):
        raise ValueError("two builds share a name")
    logs = build.compile_all(list(names.values()))
    for b, src in names.items():
        for line in logs[src].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {b}: {line.strip()}", flush=True)
    libs = {b: tgl.typed(build.load(src)) for b, src in names.items()}
    eng = Engine()
    tpch.load(eng, sf=a.sf, tables=tpch.ALL_TABLES, encoded=True)
    captured = capture(eng, {"q1": tpch.Q1, "q5": tpch.Q5,
                             "q10": tpch.Q10, "q12": tpch.Q12})
    shapes = {q: shape(args) for q, args in captured.items()}
    print("shapes: " + json.dumps(shapes), flush=True)

    plans = {q: tgl.plan_slots(*args) for q, args in captured.items()}
    layout = {q: tgl.choose_layout(p) for q, p in plans.items()}
    # every launch at the point the engine resolved for the query
    point = {q: tgl.kernel_point(args[5]) for q, args in captured.items()}
    errs = {q: {f"{b}/{layout[q]}": compare_plain(captured[q], tgl.SlotResult(
        *tgl.launch(p, layout[q], lib, point[q]), p.rows, p.rep_row))
        for b, lib in libs.items()} for q, p in plans.items()}
    alone = {q: {f"{b}/{layout[q]}": [] for b in libs} for q in plans}
    for _ in range(a.rounds):
        for q, p in plans.items():
            for b in list(libs) + list(libs)[::-1]:
                alone[q][f"{b}/{layout[q]}"].append(
                    kernel_ms(p, layout[q], a.reps, libs[b], point[q]))
    out = {"card": card, "sf": a.sf, "reps": a.reps, "rounds": a.rounds,
           "shapes": shapes, "errors": errs, "queries": {}}
    for q, args in captured.items():
        plan = plans[q]
        run, _ = tgl.launcher(plan, layout[q], libs["tree"], point[q])
        stage = {"prebuilt": [], "slots": []}
        for _ in range(a.rounds):
            for way in ("prebuilt", "slots", "slots", "prebuilt"):
                if way == "prebuilt":
                    stage[way].append(events_ms(
                        lambda: stage_prebuilt(*args[:5]), a.reps))
                else:
                    stage[way].append(events_ms(
                        lambda: stage_slots(*args), a.reps))
        out["queries"][q] = {
            "point": list(point[q]),
            "alone_ms": {k: {"mean": sum(v) / len(v), "each": v}
                         for k, v in alone[q].items()},
            "wrapper_ms": events_ms(lambda: tgl.aggregate_slots(*args),
                                    a.reps),
            # host time per call: planning, allocation and packing, the
            # ctypes call and its two launches, and the whole wrapper
            "plan_host_us": host_us(lambda: tgl.plan_slots(*args)),
            "launcher_host_us": host_us(lambda: tgl.launcher(
                plan, layout[q], libs["tree"], point[q])),
            "run_host_us": host_us(run),
            "wrapper_host_us": host_us(lambda: tgl.aggregate_slots(*args)),
            "stage_ms": {k: {"mean": sum(v) / len(v), "each": v}
                         for k, v in stage.items()},
        }
        print(f"{q}: " + json.dumps(out["queries"][q]), flush=True)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
