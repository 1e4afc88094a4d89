"""Compile logical plans into functions over device-resident tensors.

The counterpart of cockroach_tpu/exec/compile.py for the plans the
ported TPC-H and SSB queries produce: scans with the MVCC visibility
mask, filters, projections, hash joins (unique build keys, or duplicate
keys expanded K ways), selection compaction, ungrouped, dense
(mixed-radix) and hash-strategy GROUP BY aggregation, ORDER BY, the
fused top-k ORDER BY ... LIMIT, and LIMIT. ``compile_plan(node,
params)`` returns ``fn(RunContext) -> ColumnBatch``; PyTorch runs it
eagerly on the batches' device, so there is no jit (the engine keeps
the closures in its exec cache).

Aggregation routes as the reference's does. Under the default
``pallas_groupagg = auto``, a dense GROUP BY whose aggregates all have
an exact-result envelope (counts, `any`, and int64 limb sums / averages
over INT/DECIMAL) runs in ONE pass of the large-G kernel
(ops/cuda/groupagg_large.py). Under ``on``, an ungrouped or dense
aggregation over at most 64 groups whose value aggregates all take
FLOAT arguments runs in the small-G kernel (ops/cuda/groupagg.py, f32
accumulation), and the large-G kernel also takes f32 float sums and
MIN/MAX. Hash-strategy GROUP BY numbers its groups through the device
hash table (ops/hashtable.py group_ids) and aggregates with the plain
scatters. Sorts go through packed sort-key lanes (ops/sortkey.py)
under ``sort_normalized = auto|on``.

Result batches carry error sentinels the engine checks when it
materializes them (exec/session.py SENTINEL_COLUMNS): an int64 SUM
that wrapped, a hash table that overflowed, a top-k cut that crossed
a tie, a compaction block that overflowed. A DISTINCT aggregate keeps
the first row of each (group, value) (ops/agg.py distinct_first_mask)
and aggregates as usual. A RunContext with ``nparts`` > 1 keeps only
its partition's rows of a hash GROUP BY. ``compile_streaming`` splits
an aggregate-rooted plan into page partials, their combine and a
finalize for the streamed and spilled paths. Window functions sort
once and scan (ops/window.py); a window sees its whole partition, so
it never streams, spills or runs distributed.

With ``ExecParams.axis_name`` set (a parallel/collective.py ShardAxis),
the plan runs once per shard slot of a mesh, on row slices of its
probe-spine tables, and keeps the reference's collectives where the
reference has them: partial counts and sums psum, MIN pmin, MAX and
`any` pmax, a global overflow bound psum, and both kernels' partials
merge after their per-shard launches (kernel 1's int32 limb rows cut
for the global row bound, so their psum is exact). A hash GROUP BY
exchanges its shard-local groups to their hash owner and all_gathers
the merged ones (_compile_hash_dist_aggregate). The outputs are the
same on every shard, so Sort, Limit and HAVING above the aggregate run
on each; the fused top-k, compaction and DISTINCT aggregates stay off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops import agg as aggops
from ..ops import hashtable, sortkey
from ..ops.batch import ColumnBatch
from ..ops.cuda import groupagg as pg
from ..ops.cuda import groupagg_large as pgl
from ..ops.cuda import paritygate
from ..ops.join import hash_join
from ..sql import plan as P
from ..sql.bound import BoundAgg
from ..sql.pushdown import _expr_key
from ..sql.types import Family
from . import profile
from .expr import ExprContext, compile_expr


class ExecError(Exception):
    pass


@dataclass
class ExecParams:
    """Static execution parameters (session-var controlled)."""
    # Session var pallas_groupagg: "auto" routes eligible dense GROUP
    # BYs through the large-G kernel, "on" also through the small-G
    # kernel and the f32 float envelope, "off" through neither.
    pallas_groupagg: str = "auto"
    # slots for hash-strategy GROUP BY (session var hash_group_capacity)
    hash_group_capacity: int = 1 << 17
    # fuse ORDER BY ... LIMIT into a top-k cut (off after a TopKInexact)
    topk_sort: bool = True
    # session var sort_normalized: auto | on | off
    sort_normalized: str = "auto"
    # kernel 1's launch point (block, rows, min_blocks, limb_cap) from
    # the tuning table (ops/cuda/autotune.py) and the kernel-1 paths the
    # parity gate proved exact on this card (ops/cuda/paritygate.py),
    # which `auto` admits. Both are performance-only under the gate's
    # proof, so neither is part of the exec-cache key.
    pallas_point: tuple = (256, 4, 4, 22)
    pallas_exact_paths: tuple = ()
    # When set, the plan runs once per shard slot of a mesh: scans see
    # row slices, and aggregate partials merge with collectives over
    # this shard axis (parallel/collective.py ShardAxis: psum, pmin,
    # pmax, all_gather, all_to_all), the DistSQL final-stage merge.
    axis_name: object = None
    # the mesh's slot count (the exchange's send-buffer shapes depend
    # on it)
    n_shards: int = 1


class RunContext:
    """Per-execution inputs: alias -> uploaded table batch, and the MVCC
    read timestamp as an int (Timestamp.to_int). ``route`` records what
    the run did: Compact nodes that packed their batch, top-k cuts,
    hash GROUP BYs (group_ids calls, and the build rounds of the last,
    one host sync each) and the K of each expanding join.

    ``nparts``/``pid`` drive the partitioned re-run of a hash GROUP BY
    that overflowed its table: the run keeps only the rows whose salted
    key hash lands in partition ``pid`` of ``nparts``
    (ops/hashtable.py partition_mask). nparts = 1 keeps every row.

    ``params``: the statement's lifted filter literals (Python scalars,
    exec/planparam.py), read by the plan's BParam nodes."""

    def __init__(self, scans: dict[str, ColumnBatch], read_ts: int,
                 nparts: int = 1, pid: int = 0, route: dict | None = None,
                 params: tuple = ()):
        self.scans = scans
        self.read_ts = read_ts
        self.nparts = nparts
        self.pid = pid
        self.params = params
        # a paged run shares one route over its pages
        self.route = route if route is not None else self.new_route()

    @staticmethod
    def new_route() -> dict:
        return {"compacts_applied": 0, "topk_cuts": 0, "group_ids": 0,
                "group_ids_rounds": 0, "expansions": []}


CompiledNode = Callable[[RunContext], ColumnBatch]


def _ctx_of(batch: ColumnBatch, aggs=None,
            params: tuple = ()) -> ExprContext:
    cols = {name: (batch.data[i], batch.valid[i])
            for i, name in enumerate(batch.names)}
    return ExprContext(cols, batch.n, batch.device, aggs, params)


def compile_plan(node: P.PlanNode, params: ExecParams,
                 meta: P.OutputMeta | None = None) -> CompiledNode:
    """The plan as a closure over RunContext. Every operator is wrapped
    for the fine profile plane (exec/profile.py): while a fine sink is
    active on the running thread the operator runs inside
    ``sink.op(node)`` (CUDA events on the card) and reports its output
    rows as a device count; otherwise the wrapper only calls it."""
    fn = _compile_plan(node, params, meta)

    def run_op(rc):
        sink = profile.fine_sink()
        if sink is None:
            return fn(rc)
        with sink.op(node) as rec:
            b = fn(rc)
            rec.rows = b.sel.sum()
            if isinstance(node, P.Scan):
                # a scan's output is the uploaded table slice
                rec.bytes_uploaded = _batch_nbytes(b)
        return b
    return run_op


def _batch_nbytes(b: ColumnBatch) -> int:
    n = b.sel.numel() * b.sel.element_size()
    for d in b.data:
        n += d.numel() * d.element_size()
    return int(n)


def _compile_plan(node: P.PlanNode, params: ExecParams,
                  meta: P.OutputMeta | None = None) -> CompiledNode:
    if isinstance(node, P.Scan):
        return _compile_scan(node)
    if isinstance(node, P.Filter):
        childf = compile_plan(node.child, params)
        predf = compile_expr(node.pred)

        def run_filter(rc):
            b = childf(rc)
            pv = predf(_ctx_of(b, params=rc.params))
            return b.and_sel(torch.logical_and(pv[0], pv[1]))
        return run_filter
    if isinstance(node, P.Project):
        childf = compile_plan(node.child, params)
        items = [(name, compile_expr(e)) for name, e in node.items]

        def run_project(rc):
            b = childf(rc)
            ctx = _ctx_of(b)
            cols, valid = {}, {}
            for name, f in items:
                d, v = f(ctx)
                cols[name] = d
                valid[name] = v
            out = ColumnBatch.from_dict(cols, valid, sel=b.sel)
            return _bubble_compact_overflow(b, out)
        return run_project
    if isinstance(node, P.HashJoin):
        leftf = compile_plan(node.left, params)
        rightf = compile_plan(node.right, params)
        jn = node

        def run_join(rc):
            if jn.expand > 1 and jn.join_type in ("inner", "left"):
                rc.route["expansions"].append(jn.expand)
            return hash_join(leftf(rc), rightf(rc), jn.left_keys,
                             jn.right_keys, jn.payload, jn.join_type,
                             expand=jn.expand, direct=jn.direct,
                             pack_payload=jn.pack_payload,
                             sort_normalized=params.sort_normalized)
        return run_join
    if isinstance(node, P.Compact):
        childf = compile_plan(node.child, params)
        frac, block = node.frac, node.block

        def run_compact(rc):
            b = childf(rc)
            out = compact_batch(b, frac, block)
            rc.route["compacts_applied"] += out is not b
            return out
        return run_compact
    if isinstance(node, P.Aggregate):
        return _compile_aggregate(node, params)
    if isinstance(node, P.Window):
        return _compile_window(node, params)
    if isinstance(node, P.Sort):
        return _compile_sort(node, params, meta)
    if isinstance(node, P.Limit):
        if isinstance(node.child, P.Sort) and params.topk_sort \
                and params.axis_name is None \
                and node.limit is not None \
                and 0 < node.limit + node.offset <= TOPK_MAX:
            return _compile_topk_sort_limit(node, params, meta)
        childf = compile_plan(node.child, params, meta)
        lim, off = node.limit, node.offset

        def run_limit(rc):
            return limit_batch(childf(rc), lim, off)
        return run_limit
    raise ExecError(f"{type(node).__name__} is not yet ported")


def _compile_scan(node: P.Scan) -> CompiledNode:
    alias = node.alias
    colmap = dict(node.columns)  # batch name -> stored name
    predf = compile_expr(node.filter) if node.filter is not None else None
    computedf = [(n, compile_expr(e)) for n, e in node.computed]

    def run_scan(rc: RunContext) -> ColumnBatch:
        raw = rc.scans[alias]
        # MVCC visibility: mvcc_ts <= read_ts < mvcc_del, fused with the
        # scan (storage/columnstore.py docstring)
        ts = raw.col("_mvcc_ts")
        dl = raw.col("_mvcc_del")
        live = torch.logical_and(ts <= rc.read_ts, rc.read_ts < dl)
        cols, valid = {}, {}
        for bname, sname in colmap.items():
            cols[bname] = raw.col(sname)
            valid[bname] = raw.col_valid(sname)
        b = ColumnBatch.from_dict(cols, valid,
                                  sel=torch.logical_and(raw.sel, live))
        if predf is not None:
            pv = predf(_ctx_of(b, params=rc.params))
            b = b.and_sel(torch.logical_and(pv[0], pv[1]))
        for cname, cf in computedf:
            d, v = cf(_ctx_of(b))
            b = b.with_column(cname, d, v)
        return b
    return run_scan


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def compact_batch(b: ColumnBatch, frac: float,
                  block: int = 32768) -> ColumnBatch:
    """Pack selected rows to the front of a batch `frac` the size.

    Blocked: each `block`-row segment keeps its first kb = block * frac
    selected rows (kb rounded up to a multiple of 128, so the packed
    batch still suits the kernels' row tiling), and every downstream
    per-row op (join probe gathers, CASE math, aggregate partials) then
    runs at that width. The pack is the reference's non-TPU strategy: a
    cumulative-sum rank per block and one scatter of row ids into a
    (kb + 1)-slot frame per block, whose extra slot takes the unselected
    and beyond-capacity rows; it keeps the selected rows in order. A
    block with more selected rows than kb sets the __compact_overflow
    sentinel: the engine sees it at materialize time and replans
    without compaction. Batches under two blocks, or not a multiple of
    one, pass through unchanged."""
    n = int(b.sel.shape[0])
    if n < 2 * block or n % block:
        return b
    nb = n // block
    kb = max(128, int(block * frac))
    kb = ((kb + 127) // 128) * 128
    if kb >= block:
        return b
    dev = b.device
    s = b.sel.reshape(nb, block)
    pos = torch.cumsum(s.to(torch.int32), dim=1, dtype=torch.int32) - 1
    overflow = torch.any(pos[:, -1] + 1 > kb)
    base = (torch.arange(nb, dtype=torch.int32, device=dev)
            * (kb + 1))[:, None]
    dst = (torch.where(s & (pos < kb), pos, kb) + base).reshape(-1)
    scat = torch.full((nb * (kb + 1),), -1, dtype=torch.int32, device=dev)
    scat[dst.to(torch.int64)] = torch.arange(n, dtype=torch.int32,
                                             device=dev)
    flat = scat.reshape(nb, kb + 1)[:, :kb].reshape(-1)
    live = flat >= 0
    flat = torch.clamp(flat, min=0).to(torch.int64)
    cols, valid = {}, {}
    for name in b.names:
        cols[name] = b.col(name).index_select(0, flat)
        valid[name] = b.col_valid(name).index_select(0, flat)
    out = ColumnBatch.from_dict(cols, valid, sel=live)
    return out.with_column("__compact_overflow",
                           overflow.reshape(1).expand(out.n))


def _bubble_compact_overflow(child: ColumnBatch,
                             out: ColumnBatch) -> ColumnBatch:
    """Carry a child Compact's capacity sentinel into a fresh output
    batch (projection and aggregation drop the child's columns)."""
    if not child.has("__compact_overflow"):
        return out
    flag = torch.any(child.col("__compact_overflow"))
    return out.with_column("__compact_overflow",
                           flag.reshape(1).expand(out.n))


def _agg_output(group_cols, aggs_out, live, itemfs, havingf,
                num_groups: int, sum_ovf, device,
                ht_ovf=None) -> ColumnBatch:
    """Shared tail of every aggregation strategy: evaluate the output
    items over (group cols, agg results), apply HAVING, and attach the
    sentinel columns the engine checks at materialize time (the int64
    SUM overflow and, for hash-strategy plans, the hash table's)."""
    out_ctx = ExprContext(group_cols, num_groups, device, aggs_out)
    cols, valid = {}, {}
    for name, f in itemfs:
        d, v = f(out_ctx)
        cols[name] = d
        valid[name] = v
    if havingf is not None:
        hv, hm = havingf(out_ctx)
        live = torch.logical_and(live, torch.logical_and(hv, hm))
    out = ColumnBatch.from_dict(cols, valid, sel=live)
    out = out.with_column("__sum_overflow",
                          sum_ovf.reshape(1).expand(num_groups))
    if ht_ovf is not None:
        out = out.with_column("__ht_overflow",
                              ht_ovf.reshape(1).expand(num_groups))
    return out


def _merges(axis):
    """(psum, pmin, pmax) over ``axis``, or identities on one device."""
    if axis is None:
        def ident(x):
            return x
        return ident, ident, ident
    return axis.psum, axis.pmin, axis.pmax


def _agg_partials(a: BoundAgg, argf, batch, ctx, gid, num_groups,
                  max_group_rows=0, rep_state=None, sort_mode="off",
                  axis=None):
    """One aggregate's per-group arrays on the plain scatter path:
    (data, valid, overflow or None).

    With ``axis`` set, the partials merge across the mesh's shards with
    the collective of each (the reference's final-stage merge): counts
    and sums psum, MIN pmin, MAX and `any` pmax."""
    grouped = gid is not None
    dev = batch.device
    psum, pmin, pmax = _merges(axis)
    if a.func == "count_rows":
        mask = batch.sel
        if grouped:
            d = aggops.group_count(gid, mask, num_groups)
        else:
            d = aggops.masked_count(mask).reshape(1)
        d = psum(d)
        return d, torch.ones_like(d, dtype=torch.bool), None
    d0, v0 = argf(ctx)
    if a.func == "any" and grouped and rep_state is not None \
            and not a.distinct:
        rep, nonempty = rep_state
        d, v = aggops.group_any_via_rep(d0, v0, rep, nonempty)
        return d, v, None
    mask = torch.logical_and(batch.sel, v0)
    if a.distinct:
        # DISTINCT x: only the first occurrence of each (group, value)
        # counts; the aggregate itself is then unchanged
        gid_d = gid if grouped else torch.zeros(d0.shape, dtype=torch.int32,
                                                device=dev)
        mask = torch.logical_and(mask, aggops.distinct_first_mask(
            d0, mask, gid_d, num_groups if grouped else 1, sort_mode))
    if grouped:
        cnt = aggops.group_count(gid, mask, num_groups)
    else:
        cnt = aggops.masked_count(mask).reshape(1)
    cnt = psum(cnt)
    if a.func == "count":
        return cnt, torch.ones_like(cnt, dtype=torch.bool), None
    nonempty = cnt > 0

    if a.func in ("sum", "sum_int"):
        acc = torch.float64 if d0.dtype == torch.float64 else torch.int64
        if grouped:
            d = aggops.group_sum(d0, gid, mask, num_groups, acc_dtype=acc,
                                 max_group_rows=max_group_rows,
                                 arg_max_abs=a.arg_max_abs,
                                 arg_nonneg=a.arg_nonneg)
        else:
            d = aggops.masked_sum(d0, mask, acc_dtype=acc).reshape(1)
        d = psum(d)
        overflow = None
        if acc == torch.int64:
            # int64 wraps silently past its range: a cheap global bound
            # (rows x max|value|, summed over the shards so that every
            # shard agrees) proves most scans cannot; otherwise an f64
            # shadow sum exposes a wrap. Both are computed eagerly (no
            # host round trip to pick one).
            dz64 = torch.where(mask, d0, torch.zeros_like(d0)) \
                .to(torch.float64)
            bound = psum((float(d0.shape[0])
                          * torch.amax(torch.abs(dz64))).reshape(1))[0]
            cannot = bound < float(2 ** 62)
            if grouped:
                sh = aggops.group_sum(d0.to(torch.float64), gid, mask,
                                      num_groups)
            else:
                sh = aggops.masked_sum(d0.to(torch.float64), mask) \
                    .reshape(1)
            sh = psum(sh)
            err = torch.abs(d.to(torch.float64) - sh)
            tol = torch.clamp(torch.abs(sh) * 1e-3, min=1e12)
            overflow = torch.logical_and(torch.logical_not(cannot),
                                         torch.any(err > tol))
        return d, nonempty, overflow
    if a.func == "avg":
        scale = (10.0 ** a.arg.type.scale
                 if a.arg.type.family == Family.DECIMAL else 1.0)
        df = d0.to(torch.float64) / scale
        if grouped:
            s = aggops.group_sum(df, gid, mask, num_groups)
        else:
            s = aggops.masked_sum(df, mask).reshape(1)
        d = psum(s) / torch.clamp(cnt, min=1).to(torch.float64)
        return d, nonempty, None
    if a.func in ("min", "max", "any"):
        # `any` is a per-group-constant value: max picks it (an empty
        # shard's group holds the max identity, which loses the pmax)
        if grouped:
            fold = aggops.group_min if a.func == "min" else aggops.group_max
            d = fold(d0, gid, mask, num_groups)
        else:
            fold = aggops.masked_min if a.func == "min" \
                else aggops.masked_max
            d = fold(d0, mask).reshape(1)
        return (pmin if a.func == "min" else pmax)(d), nonempty, None
    raise ExecError(f"aggregate {a.func} unsupported")


# Large-G kernel envelope (the reference's routing constants, kept so
# both packages send the same plans to their kernel): group domains up
# to 2^19, and under `auto` inputs of at least 4096 rows.
LARGE_G_MAX = 1 << 19
AUTO_MIN_ROWS = 4096


def _pallas_agg_slots(aggs) -> list | None:
    """Slot layout for the small-G kernel (ops/cuda/groupagg.py), or
    None if any aggregate falls outside its f32 envelope: counts are
    exact; value aggregates must take FLOAT arguments."""
    kinds = {"sum": pg.SUM, "avg": pg.SUM, "min": pg.MIN, "max": pg.MAX}
    slots = []  # (kernel op, agg index, role: "main" | "cnt")
    for i, a in enumerate(aggs):
        if a.distinct:
            return None
        if a.func in ("count_rows", "count"):
            slots.append((pg.COUNT, i, "main"))
        elif a.func in kinds:
            if a.arg is None or a.arg.type.family != Family.FLOAT:
                return None
            slots.append((kinds[a.func], i, "main"))
            # paired count: per-group validity + avg divisor
            slots.append((pg.COUNT, i, "cnt"))
        else:
            return None
    return slots


def _pallas_dense_partials(slots, aggfs, b, ctx, gid, num_groups: int,
                           grouped: bool, axis=None):
    """Every aggregate's (data, valid) from ONE small-G kernel pass, in
    aggfs order, and for a grouped plan the groups' liveness from the
    same pass (else None): a group is live when it holds a selected
    row, which `count(*)`'s slot counts; without one, one more COUNT
    slot does. Never a SUM's paired count: a group whose arguments are
    all NULL is live and returns a NULL sum.

    With ``axis`` set, each shard's kernel partials merge column by
    column with their op's collective: counts and SUMs psum, MIN pmin,
    MAX pmax."""
    argdata = {i: argf(ctx) for i, (a, argf) in enumerate(aggfs)
               if argf is not None}
    slots = list(slots)
    rows_slot = [(i, role) for _, i, role in slots
                 if aggfs[i][0].func == "count_rows"]
    if grouped and not rows_slot:
        slots.append((pg.COUNT, -1, "live"))
        rows_slot = [(-1, "live")]
    values, masks, ops = [], [], []
    for op, i, role in slots:
        # a COUNT slot's value is never read: it gets sel
        if i in argdata:
            d0, v0 = argdata[i]
            values.append(b.sel if op == pg.COUNT else d0)
            masks.append(v0)
        else:
            # count(*) and liveness: every selected row; the mask is
            # sel itself, which the kernel does not read again
            values.append(b.sel)
            masks.append(b.sel)
        ops.append(op)
    acc, cnt = pg.dense_group_aggregate(gid, b.sel, tuple(values),
                                        tuple(masks), num_groups,
                                        tuple(ops))
    if axis is not None:
        # one collective an op kind, over its columns together
        cnt = axis.psum(cnt)
        acc = acc.clone()
        for kinds, merge in (((pg.COUNT, pg.SUM), axis.psum),
                             ((pg.MIN,), axis.pmin), ((pg.MAX,), axis.pmax)):
            cols = [j for j, op in enumerate(ops) if op in kinds]
            if cols:
                idx = torch.tensor(cols, device=acc.device)
                acc[:, idx] = merge(acc[:, idx])
    col_of = {(i, role): j for j, (op, i, role) in enumerate(slots)}
    aggs_out = []
    for i, (a, argf) in enumerate(aggfs):
        if a.func in ("count_rows", "count"):
            d = cnt[:, col_of[(i, "main")]].to(torch.int64)
            aggs_out.append((d, torch.ones_like(d, dtype=torch.bool)))
            continue
        d = acc[:, col_of[(i, "main")]].to(torch.float64)
        n_valid = cnt[:, col_of[(i, "cnt")]]
        if a.func == "avg":
            d = d / torch.clamp(n_valid, min=1).to(torch.float64)
        aggs_out.append((d, n_valid > 0))
    live = cnt[:, col_of[rows_slot[0]]] > 0 if grouped else None
    return aggs_out, live


def _pallas_large_ok(aggs, mode: str, exact_paths: tuple = ()) -> bool:
    """Static (SQL-type) envelope check for the large-G kernel (the
    reference's). `auto` admits only aggregates whose kernel results
    are exact: counts, `any` (representative-row gather), int64-limb
    sums/avgs over INT/DECIMAL args, and whatever ``exact_paths`` the
    parity gate (ops/cuda/paritygate.py) proved bit-identical on this
    card: ``int_minmax`` (INT/DECIMAL MIN/MAX through the high limb and
    its refinement), ``float_sum`` (FLOAT sum/avg in f32). `on` admits
    every path, FLOAT MIN/MAX included (approximate, as in the small-G
    kernel)."""
    for a in aggs:
        if a.distinct:
            return False
        if a.func in ("count_rows", "count", "any"):
            continue
        fam = a.arg.type.family if a.arg is not None else None
        if a.func in ("sum", "sum_int", "avg"):
            if fam in (Family.INT, Family.DECIMAL):
                continue
            if fam == Family.FLOAT and \
                    (mode == "on" or "float_sum" in exact_paths):
                continue
            return False
        if a.func in ("min", "max"):
            if fam in (Family.INT, Family.DECIMAL) and \
                    (mode == "on" or "int_minmax" in exact_paths):
                continue
            if mode == "on" and fam == Family.FLOAT:
                continue
        return False
    return True


def _agg_args(aggfs, ctx) -> dict:
    """Each aggregate's evaluated (data, valid) argument, by index. Equal
    bound argument expressions are evaluated once and share tensors, so
    the large-G kernel's wrapper folds sum(x) and avg(x) by storage even
    where x is an expression. Arguments are matched by the structural
    key (repr plus a digest of every dictionary table), not by the
    dataclasses' ==, which compares numpy tables elementwise."""
    out, done = {}, {}
    for i, (a, argf) in enumerate(aggfs):
        if argf is None:
            continue
        key = _expr_key(a.arg)
        if key not in done:
            done[key] = argf(ctx)
        out[i] = done[key]
    return out


def _pallas_large_partials(aggfs, b, ctx, gid, num_groups: int,
                           max_group_rows: int, params: ExecParams):
    """Every aggregate's per-group (data, valid) from ONE large-G
    kernel pass. Returns (aggs_out, live, overflow), or None when an
    argument's dtype falls outside the envelope (the caller then takes
    the plain scatter path).

    The kernel reads the arguments in place. Exact int64 sums come back
    as w-bit limb sums (logical shifts, cut in the kernel) in int32,
    recombined with wrapping int64 shifts/adds: int64 modular
    arithmetic, bit-identical to the plain path's _group_sum_i64_limbs.
    FLOAT sums add in f32. MIN/MAX of FLOAT reduce the f32 value; of
    INT/DECIMAL, the arithmetic high limb (order-preserving, f32-exact),
    refined to the full-width winner by a plain fold over the rows
    holding it.

    On a mesh (``params.axis_name`` set) each shard's kernel partials
    merge with collectives: the i32 limb, count and liveness rows psum
    exactly, since the limb width bounds them by the GLOBAL
    max_group_rows over every shard's rows; f32 sum and shadow rows
    psum; MIN/MAX rows pmin/pmax (the INT refinement runs on the merged
    winner, and its shard results pmin/pmax again); `any` merges each
    shard's representative with a pmax over an identity fill (the FD
    makes every shard that holds the group agree on the value)."""
    n = b.n
    sel = b.sel
    axis = params.axis_name
    argdata = _agg_args(aggfs, ctx)
    for i, (a, _) in enumerate(aggfs):
        if a.func in ("sum", "sum_int", "avg", "min", "max") \
                and a.arg is not None \
                and a.arg.type.family in (Family.INT, Family.DECIMAL) \
                and argdata[i][0].dtype not in (torch.int64, torch.int32):
            # the static check ran on SQL types; limb sums and the
            # MIN/MAX high limb need real integers
            return None
    # the launch point's exactness bound: its tile's rows and every
    # group's rows in one int32 accumulator (the shipped point gives
    # the reference's limb layout)
    block, rows, _mb, cap = params.pallas_point
    # on a mesh, every shard's rows: summed shard limbs then stay
    # below 2^31 too (a shard's row count alone would let them wrap)
    n_all = n * (params.n_shards if axis is not None else 1)
    w = pgl.limb_width(n_all, max_group_rows, block_rows=block * rows,
                       cap=cap)
    slots, tags = [], []
    want_rep = False
    exact = {}  # agg index -> limb count k
    for i, (a, _) in enumerate(aggfs):
        if a.func == "count_rows":
            slots.append(pgl.count())
            tags.append(("cnt", i))
            continue
        if a.func == "any":
            want_rep = True  # rides the REPMIN row + a gather
            continue
        d0, v0 = argdata[i]
        slots.append(pgl.count(v0))  # validity + avg divisor
        tags.append(("cnt", i))
        if a.func == "count":
            continue
        if a.func in ("min", "max"):
            slots.append(pgl.minmax(d0, v0, pgl.MIN if a.func == "min"
                                    else pgl.MAX))
            tags.append(("mm", i))
            continue
        if a.arg.type.family == Family.FLOAT:
            slots.append(pgl.f32sum(d0, v0))
            tags.append(("fsum", i))
            continue
        bits = 64
        if a.arg_nonneg and a.arg_max_abs:
            bits = max(1, int(a.arg_max_abs).bit_length())
        exact[i] = -(-bits // w)
        slots.append(pgl.i64sum(d0, v0, w, exact[i]))
        tags.append(("sum", i))
    slots.append(pgl.count())  # group liveness: count(*)'s row if any
    tags.append(("live",))

    res = pgl.aggregate_slots(gid, sel, tuple(slots), num_groups,
                              want_rep, point=params.pallas_point)
    acc_f, acc_i = res.acc_f, res.acc_i
    row = dict(zip(tags, res.rows))
    rep = rep_live = None
    if want_rep:
        # REPMIN row (n = empty group): shard-local row ids
        racc = acc_i[res.rep_row]
        rep_live = racc < n
        rep = torch.clamp(racc, max=n - 1)
    # |value| bounds as float64: the uint64 pattern of 2^63 reads as
    # INT64_MIN; n x max|value| per int64 sum, summed over the shards
    maxabs = torch.where(res.maxabs < 0, 2.0 ** 63,
                         res.maxabs.to(torch.float64))
    bound = float(n) * maxabs
    if axis is not None:
        acc_i = axis.psum(acc_i)
        mm_ops = {row[t]: aggfs[t[1]][0].func for t in tags
                  if t[0] == "mm"}
        acc_f = acc_f.clone()
        for rows_k, merge in (
                ([r for r in range(acc_f.shape[0]) if r not in mm_ops],
                 axis.psum),
                ([r for r, f in mm_ops.items() if f == "min"], axis.pmin),
                ([r for r, f in mm_ops.items() if f == "max"], axis.pmax)):
            if rows_k:
                idx = torch.tensor(rows_k, device=acc_f.device)
                acc_f[idx] = merge(acc_f[idx])
        if bound.numel():
            bound = axis.psum(bound)
    live = acc_i[row[("live",)]] > 0

    overflow = torch.zeros((), dtype=torch.bool, device=b.device)
    aggs_out = []
    for i, (a, _) in enumerate(aggfs):
        if a.func in ("count_rows", "count"):
            d = acc_i[row[("cnt", i)]].to(torch.int64)
            aggs_out.append((d, torch.ones_like(d, dtype=torch.bool)))
            continue
        if a.func == "any":
            d0, v0 = argdata[i]
            d, v = aggops.group_any_via_rep(d0, v0, rep, rep_live)
            if axis is not None:
                # an empty shard contributes the max identity (already
                # group_any_via_rep's fill), so pmax picks a real value
                d = axis.pmax(d)
                v = axis.psum(v.to(torch.int32)) > 0
            aggs_out.append((d, v))
            continue
        cnt = acc_i[row[("cnt", i)]]
        nonempty = cnt > 0
        if a.func in ("min", "max"):
            d = acc_f[row[("mm", i)]]
            if a.arg.type.family in (Family.INT, Family.DECIMAL):
                # refine the winning high limb to the full-width value
                # with the dtype-preserving plain fold over only the
                # rows that hold it: every survivor is an input value,
                # so the result is bit-equal to the plain path's
                d0, v0 = argdata[i]
                dref = paritygate.refine_int_minmax(
                    d0, torch.logical_and(sel, v0), gid, d, num_groups,
                    a.func)
                if axis is not None:
                    # a shard without the winning limb refines an empty
                    # mask, whose identity loses this merge
                    dref = (axis.pmin if a.func == "min"
                            else axis.pmax)(dref)
                aggs_out.append((dref, nonempty))
                continue
            aggs_out.append((d.to(torch.float64), nonempty))
            continue
        if i not in exact:  # float sum/avg (`on`)
            d = acc_f[row[("fsum", i)]].to(torch.float64)
            if a.func == "avg":
                d = d / torch.clamp(cnt, min=1).to(torch.float64)
            aggs_out.append((d, nonempty))
            continue
        k = exact[i]
        r0, frow, mx = row[("sum", i)]
        # sum(x) and avg(x) share limb rows; each reads its own k.
        # Wrapping IS int64 modular arithmetic, in any order.
        shifts = torch.arange(0, k * w, w, dtype=torch.int64,
                              device=b.device)
        total = (acc_i[r0:r0 + k].to(torch.int64) << shifts[:, None]) \
            .sum(dim=0)
        # overflow sentinel: a cheap global bound proves most scans
        # cannot wrap, else compare the f32 shadow. Tolerance 1e-2
        # absorbs f32 accumulation noise; a real int64 wrap is ~2^64
        # off, far beyond it.
        cannot = bound[mx] < float(2 ** 62)
        sh = acc_f[frow].to(torch.float64)
        err = torch.abs(total.to(torch.float64) - sh)
        tol = torch.clamp(torch.abs(sh) * 1e-2, min=1e12)
        overflow = torch.logical_or(
            overflow,
            torch.logical_and(torch.logical_not(cannot),
                              torch.any(err > tol)))
        if a.func == "avg":
            scale = (10.0 ** a.arg.type.scale
                     if a.arg.type.family == Family.DECIMAL else 1.0)
            d = total.to(torch.float64) / scale \
                / torch.clamp(cnt, min=1).to(torch.float64)
            aggs_out.append((d, nonempty))
        else:
            aggs_out.append((total, nonempty))
    return aggs_out, live, overflow


def _compile_aggregate(node: P.Aggregate, params: ExecParams) -> CompiledNode:
    childf = compile_plan(node.child, params)
    groupfs = [(name, compile_expr(e)) for name, e in node.group_by]
    aggfs = [(a, compile_expr(a.arg) if a.arg is not None else None)
             for a in node.aggs]
    itemfs = [(name, compile_expr(e)) for name, e in node.items]
    havingf = compile_expr(node.having) if node.having is not None else None
    dense = node.max_groups > 0
    dims = list(node.group_dims)
    los = list(node.group_lo) or [0] * len(dims)
    mode = params.pallas_groupagg
    if mode not in ("auto", "on", "off"):
        raise ExecError(f"pallas_groupagg = {mode} is not a mode "
                        "(auto, on, off)")
    axis = params.axis_name
    if axis is not None and any(a.distinct for a in node.aggs):
        # a distinct set cannot be unioned from per-shard partials by
        # sum/min/max merges; distagg.analyze refuses these plans
        raise ExecError("DISTINCT aggregates cannot run distributed")
    if axis is not None and groupfs and not dense:
        # hash-strategy group ids are shard-local: the groups exchange
        # to their hash owner (the HashRouter's shuffle)
        return _compile_hash_dist_aggregate(node, params, childf, groupfs,
                                            aggfs, itemfs, havingf)

    def run_agg(rc: RunContext) -> ColumnBatch:
        b = childf(rc)
        ctx = _ctx_of(b)
        dev = b.device
        group_cols = {}  # name -> ([G] data, [G] valid)

        ng = None
        if not groupfs:
            gid, num_groups = None, 1
        elif not dense:
            # hash strategy: key columns -> dense ids through the
            # device hash table, numbered in slot order
            keycols = []
            gvals = []
            for name, gf in groupfs:
                d, v = gf(ctx)
                gvals.append((name, d, v))
                kd, kv = _key_encode(d, v)
                # NULLs group together: zero data + validity as a key
                keycols.append(kd)
                keycols.append(kv)
            if rc.nparts > 1:
                # partitioned re-run: this partition's rows only
                b = b.and_sel(hashtable.partition_mask(
                    tuple(keycols), rc.nparts, rc.pid))
            cap = params.hash_group_capacity
            # an overflow ends the build at once: the engine re-runs
            # the plan partitioned
            gid, ng, rep, rounds = hashtable.group_ids(tuple(keycols),
                                                       b.sel, cap)
            rc.route["group_ids"] += 1
            rc.route["group_ids_rounds"] = rounds
            num_groups = cap  # static bound; ng is the dynamic count
            rep = rep.to(torch.int64)
            for name, d, v in gvals:
                group_cols[name] = (d[rep], v[rep])
        else:
            # mixed-radix dense code; code dim_i == NULL
            gid = torch.zeros(b.n, dtype=torch.int32, device=dev)
            num_groups = 1
            for (name, gf), dim, lo in zip(groupfs, dims, los):
                d, v = gf(ctx)
                # int64 first: a BOOL key does not subtract
                code = torch.where(v, (d.to(torch.int64) - lo)
                                   .to(torch.int32), dim)
                gid = gid * (dim + 1) + code
                num_groups *= dim + 1
            # decode per-group key values from the group index itself
            garange = torch.arange(num_groups, dtype=torch.int32,
                                   device=dev)
            strides = []
            s = 1
            for dim in reversed(dims):
                strides.append(s)
                s *= dim + 1
            strides.reverse()
            for (name, _gf), dim, st, lo in zip(groupfs, dims, strides,
                                                los):
                code = (garange // st) % (dim + 1)
                # int dims decode in int64: lo can exceed int32
                val = code if lo == 0 else code.to(torch.int64) + lo
                group_cols[name] = (val, code < dim)

        # the small-G kernel serves dense GROUP BY and ungrouped
        # aggregation alike (Q6 is the num_groups == 1 case); explicit
        # `on` only, since its f32 accumulation is approximate
        pslots = None
        if mode == "on" and (dense or not groupfs) \
                and num_groups <= pg.MAX_GROUPS and b.n % pg.LANES == 0:
            pslots = _pallas_agg_slots([a for a, _ in aggfs])
        # the large-G kernel: dense grouped plans with a kernel envelope
        # for the mode (the reference's conditions)
        large = (pslots is None and mode in ("on", "auto") and groupfs
                 and dense and b.n % 128 == 0 and num_groups <= LARGE_G_MAX
                 and not (mode == "auto" and b.n < AUTO_MIN_ROWS)
                 and _pallas_large_ok([a for a, _ in aggfs], mode,
                                      params.pallas_exact_paths))
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        rep_state = None
        kernel_live = None   # liveness from a kernel's own launch
        res = None
        if pslots is not None:
            pgid = gid if gid is not None \
                else torch.zeros(b.n, dtype=torch.int32, device=dev)
            aggs_out, kernel_live = _pallas_dense_partials(
                pslots, aggfs, b, ctx, pgid, num_groups, gid is not None,
                axis)
        elif large:
            res = _pallas_large_partials(aggfs, b, ctx, gid, num_groups,
                                         node.max_group_rows, params)
        if res is not None:
            aggs_out, kernel_live, overflow = res
        elif pslots is None:
            # the shared representative index is shard-local: on a mesh
            # `any` merges through its pmax instead
            if gid is not None and axis is None and any(
                    a.func == "any" and not a.distinct for a, _ in aggfs):
                rep_state = aggops.group_rep_index(gid, b.sel, num_groups)
            aggs_out = []
            for a, argf in aggfs:
                d, v, ovf = _agg_partials(a, argf, b, ctx, gid,
                                          num_groups, node.max_group_rows,
                                          rep_state,
                                          params.sort_normalized, axis)
                aggs_out.append((d, v))
                if ovf is not None:
                    overflow = torch.logical_or(overflow, ovf)

        # group liveness
        if not groupfs:
            live = torch.ones(1, dtype=torch.bool, device=dev)
        elif not dense:
            live = torch.arange(num_groups, dtype=torch.int32,
                                device=dev) < ng
        elif kernel_live is not None:
            live = kernel_live
        elif rep_state is not None:
            live = rep_state[1]
        else:
            cnt = aggops.group_count(gid, b.sel, num_groups)
            live = (cnt if axis is None else axis.psum(cnt)) > 0

        out = _agg_output(group_cols, aggs_out, live, itemfs, havingf,
                          num_groups, overflow, dev,
                          ht_ovf=None if ng is None else ng < 0)
        return _bubble_compact_overflow(b, out)
    return run_agg


def _key_encode(d, v):
    """One group-key column as (masked int payload, validity): the two
    int columns the device hash table keys on. Floats key on their
    float64 bit pattern."""
    kd = d
    if kd.dtype == torch.bool:
        kd = kd.to(torch.int32)
    elif kd.is_floating_point():
        kd = kd.to(torch.float64).view(torch.int64)
    return torch.where(v, kd, torch.zeros_like(kd)), v.to(torch.int32)


def _compile_hash_dist_aggregate(node: P.Aggregate, params: ExecParams,
                                 childf, groupfs, aggfs, itemfs,
                                 havingf) -> CompiledNode:
    """Hash GROUP BY over the mesh (the reference's
    _compile_hash_dist_aggregate).

    Per shard: local hash grouping into at most ``hash_group_capacity``
    dense slots, with the streamed path's page-state partials per slot.
    Then a hash-partitioned all-to-all (parallel/shuffle.py) ships each
    partial group's slot to hash(key) % D, so each shard merges only its
    1/D of the groups, and one all_gather of the (disjoint) merged
    groups assembles the replicated output with no second re-group: the
    reference's HashRouter and final-stage aggregation as collectives.

    Capacity: the exchange's send budget and each shard's output budget
    are both ``xcap`` = 2 * capacity / D slots (at least 16, at most
    the capacity). A local or merge table past its capacity, a send
    block past xcap or a shard owning more than xcap merged groups sets
    the hash-overflow sentinel, on every shard alike; the engine then
    re-runs the plan partition by partition."""
    from ..parallel import shuffle
    axis = params.axis_name
    cap = params.hash_group_capacity
    n_shards = max(params.n_shards, 1)
    xcap = min(max(2 * cap // n_shards, 16), cap)
    ops_layout = [_agg_state_ops(a) for a, _ in aggfs]
    flat_ops = [op for ops in ops_layout for op in ops]
    # the exchange's bytes are tallied once a plan (its first run)
    tallied = [False]

    def run(rc: RunContext) -> ColumnBatch:
        b = childf(rc)
        ctx = _ctx_of(b)
        dev = b.device
        keycols = []
        gdata = []  # (name, data, valid) of each group-key expression
        for name, gf in groupfs:
            d, v = gf(ctx)
            kd, kv = _key_encode(d, v)
            keycols.extend((kd, kv))
            gdata.append((name, d, v))
        if rc.nparts > 1:
            b = b.and_sel(hashtable.partition_mask(
                tuple(keycols), rc.nparts, rc.pid))
        gid, ng, rep, rounds = hashtable.group_ids(tuple(keycols), b.sel,
                                                   cap)
        rc.route["group_ids"] += 1
        rc.route["group_ids_rounds"] = rounds
        slot_live = torch.arange(cap, dtype=torch.int32, device=dev) < ng
        flat_state = []
        for a, argf in aggfs:
            flat_state.extend(_agg_page_state(a, argf, b, ctx, gid, cap,
                                              node.max_group_rows))

        # per slot: the partial state and the group keys' output
        # columns, to hash(key) % n_shards. The encoded key columns do
        # not travel: the receiver encodes the (data, valid) pairs again
        rep = rep.to(torch.int64)
        dest = shuffle.dest_of(tuple(kc[rep] for kc in keycols), n_shards)
        payload = flat_state + [d[rep] for _n, d, _v in gdata] + \
            [v[rep] for _n, _d, v in gdata]
        tally = not tallied[0] and axis.index() == 0
        recv, rvalid, x_ovf = shuffle.exchange(
            dest, slot_live, n_shards, xcap, payload, axis, tally=tally)
        if tally:
            tallied[0] = True
        ns = len(flat_state)
        r_state = recv[:ns]
        r_gd = recv[ns:ns + len(gdata)]
        r_gv = recv[ns + len(gdata):]
        r_keys = []
        for gd, gv in zip(r_gd, r_gv):
            r_keys.extend(_key_encode(gd, gv))

        # merge: each shard groups only its own 1/D of the groups again
        gid2, ng2, rep2, _ = hashtable.group_ids(tuple(r_keys), rvalid,
                                                 cap)
        rc.route["group_ids"] += 1
        merged = []
        for gs, op in zip(r_state, flat_ops):
            if op == "add":
                merged.append(aggops.group_sum(gs, gid2, rvalid, cap,
                                               acc_dtype=gs.dtype))
            elif op == "min":
                merged.append(aggops.group_min(gs, gid2, rvalid, cap))
            else:
                merged.append(aggops.group_max(gs, gid2, rvalid, cap))
        aggs_out = []
        sum_ovf = torch.zeros((), dtype=torch.bool, device=dev)
        i = 0
        for (a, _), ops in zip(aggfs, ops_layout):
            d, v, ovf = _agg_finalize(a, tuple(merged[i:i + len(ops)]))
            i += len(ops)
            aggs_out.append((d, v))
            if ovf is not None:
                sum_ovf = torch.logical_or(sum_ovf, ovf)

        # the replicated output: merged groups are disjoint across
        # shards (a key has one hash owner), so one all_gather of each
        # shard's first xcap dense slots concatenates them
        def gather(x):
            return axis.all_gather(x[:xcap])

        rep2 = rep2.to(torch.int64)
        group_cols = {name: (gather(gd[rep2]), gather(gv[rep2]))
                      for (name, _d, _v), gd, gv in zip(gdata, r_gd, r_gv)}
        aggs_out = [(gather(d), gather(v)) for d, v in aggs_out]
        my_live = torch.arange(cap, dtype=torch.int32, device=dev) \
            < torch.clamp(ng2, min=0)
        live = gather(my_live)
        flags = axis.psum(torch.stack([
            sum_ovf.to(torch.int32),
            # a local table spilled, the merge table spilled, or this
            # shard owns more merged groups than its output budget
            (ng < 0).to(torch.int32) + (ng2 < 0).to(torch.int32)
            + (ng2 > xcap).to(torch.int32)]))
        ht_ovf = torch.logical_or(flags[1] > 0, x_ovf)
        return _agg_output(group_cols, aggs_out, live, itemfs, havingf,
                           n_shards * xcap, flags[0] > 0, dev,
                           ht_ovf=ht_ovf)
    return run


# ---------------------------------------------------------------------------
# sort and limit
# ---------------------------------------------------------------------------

def _dict_rank(d) -> np.ndarray:
    """code -> sort rank for one string dictionary, cached on the
    dictionary object keyed by its (append-only) length."""
    cached = getattr(d, "_sort_rank_cache", None)
    if cached is not None and cached[0] == len(d.values):
        return cached[1]
    order = np.argsort(np.asarray(d.values, dtype=object).astype(str),
                       kind="stable")
    rank = np.empty(len(order), dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    d._sort_rank_cache = (len(d.values), rank)
    return rank


def _sort_rank_tables(keys, meta: P.OutputMeta | None) -> dict:
    """String sort keys order by dictionary rank, not code."""
    rank_tables = {}
    if meta is not None:
        for key in keys:
            name = key[0]
            d = meta.dictionaries.get(name)
            if d is not None:
                rank_tables[name] = _dict_rank(d)
    return rank_tables


def _key_specs(b: ColumnBatch, keys, rank_tables: dict):
    """sort_batch's key list as ops/sortkey encode specs (pg default:
    NULLS LAST for asc, NULLS FIRST for desc; explicit override)."""
    specs = []
    for key in keys:
        name, desc = key[0], key[1]
        nf = key[2] if len(key) > 2 else None
        null_first = nf if nf is not None else desc
        specs.append((b.col(name), b.col_valid(name), desc, null_first,
                      rank_tables.get(name), None))
    return specs


def _normalized_lanes(b: ColumnBatch, keys, rank_tables: dict, kind: str):
    """Packed sort-key lanes for the batch with dead rows demoted, or
    None (the successive-argsort path) when a key dtype has no
    encoding; the fallback is tallied."""
    fields = sortkey.encode_keys(_key_specs(b, keys, rank_tables))
    if fields is None:
        sortkey.FALLBACKS.bump(kind)
        return None
    return sortkey.mask_dead(sortkey.pack_lanes(fields, b.n, b.device),
                             b.sel)


def sort_batch(b: ColumnBatch, keys, rank_tables: dict,
               mode: str = "off") -> ColumnBatch:
    """ORDER BY. Under auto/on: one stable argsort per packed sort-key
    lane (ops/sortkey.py). Under off, or for a key with no encoding:
    successive stable argsorts, least significant key first (the
    reference's jnp.lexsort, whose LAST key is primary): each key sorts
    by value, then by its NULL flag (pg default: NULLS LAST for asc,
    NULLS FIRST for desc; explicit override), and dead rows always sort
    last. The two orders differ only where floats do: the lanes put
    -0.0 before +0.0 and order NaNs by their sign bit, as the
    reference's lanes do."""
    perm = None
    if mode in ("auto", "on") and keys:
        lanes = _normalized_lanes(b, keys, rank_tables, "sort")
        if lanes is not None:
            perm = sortkey.sort_perm(lanes, kind="sort")
    if perm is None:
        sort_keys = []  # least significant first
        for key in reversed(keys):
            name, desc = key[0], key[1]
            nf = key[2] if len(key) > 2 else None
            d = b.col(name)
            v = b.col_valid(name)
            if name in rank_tables:
                lut = torch.tensor(rank_tables[name], device=b.device)
                d = lut[torch.clamp(d.to(torch.int64), 0, lut.shape[0] - 1)]
            if d.dtype == torch.bool:
                d = d.to(torch.int32)
            if desc:
                # ints reverse via bitwise NOT: arithmetic negation
                # wraps at INT64_MIN
                d = -d.to(torch.float64) if d.is_floating_point() \
                    else ~d.to(torch.int64)
            null_first = nf if nf is not None else desc
            nullkey = v if null_first else torch.logical_not(v)
            sort_keys.append(d)
            sort_keys.append(nullkey.to(torch.int8))
        sort_keys.append(torch.logical_not(b.sel).to(torch.int8))
        perm = sortkey.lexsort(sort_keys)
    data = tuple(d[perm] for d in b.data)
    valid = tuple(v[perm] for v in b.valid)
    return ColumnBatch(data, valid, b.sel[perm], b.names)


# the largest LIMIT + OFFSET the fused top-k takes
TOPK_MAX = 1024


def _primary_rank_word(b: ColumnBatch, keys, rank_tables,
                       mode: str = "off") -> torch.Tensor:
    """One ascending-sorts-first rank word for the top-k cut.

    Normalized (auto/on): lane 0 of the full packed key word as its
    order-preserving int64 image; where the key list fits one lane the
    word breaks every comparator tie. Off: the FIRST key only, in value
    order (desc via bitwise NOT), NULLS LAST for asc and FIRST for desc,
    dead rows strictly last, real values clipped to +-(2^62 - 1) so
    they never meet the 2^62-family NULL and dead words. Ties on the
    word are resolved by the refining full-key sort; the cut needs only
    the word and the tie count in topk_sort_limit_batch."""
    if mode in ("auto", "on"):
        lanes = _normalized_lanes(b, keys, rank_tables, "topk")
        if lanes is not None:
            sortkey.NORMALIZED.bump("topk")
            sortkey.LANES.bump("topk")
            return sortkey.ordered(lanes[0])
    name, desc = keys[0][0], keys[0][1]
    nf = keys[0][2] if len(keys[0]) > 2 else None
    null_first = nf if nf is not None else desc
    d = b.col(name)
    v = b.col_valid(name)
    if name in rank_tables:
        lut = torch.tensor(rank_tables[name], device=b.device)
        d = lut[torch.clamp(d.to(torch.int64), 0, lut.shape[0] - 1)]
    if d.dtype == torch.bool:
        d = d.to(torch.int32)
    if d.is_floating_point():
        w = d.to(torch.float64)
        if desc:
            w = -w
        null_w = -1e308 if null_first else 1e308
        dead_w = math.inf
    else:
        w = d.to(torch.int64)
        if desc:
            w = ~w
        lim = (1 << 62) - 1
        w = torch.clamp(w, -lim, lim)
        null_w = -(1 << 62) if null_first else (1 << 62)
        dead_w = (1 << 62) + (1 << 61)
    w = torch.where(v, w, null_w)
    return torch.where(b.sel, w, dead_w)


def topk_sort_limit_batch(b: ColumnBatch, keys, rank_tables, limit: int,
                          offset: int, mode: str = "off") -> ColumnBatch:
    """ORDER BY ... LIMIT as a top-k cut and a refining sort: the full
    sort runs only over the m = max(4 k, 128) candidate rows of the
    smallest rank words. The candidates keep row order (their indices
    are sorted before the stable refine), so rows tied on every key
    come out in row order, as from the full sort. The __topk_inexact
    sentinel flags the case where rows tied with the k-th on the rank
    word did not all make the cut; the engine then replans with the
    full sort."""
    n = int(b.sel.shape[0])
    k_eff = limit + offset
    m = min(n, max(4 * k_eff, 128))
    w = _primary_rank_word(b, keys, rank_tables, mode)
    _, idx = torch.topk(w, m, largest=False, sorted=False)
    idx = torch.sort(idx).values
    ones = torch.ones(m, dtype=torch.bool, device=b.device)
    data = tuple(d[idx] for d in b.data)
    valid = tuple(v[idx] for v in b.valid)
    bm = ColumnBatch(data + (w[idx],), valid + (ones,), b.sel[idx],
                     tuple(b.names) + ("__topk_w",))
    bs = sort_batch(bm, keys, rank_tables, mode)
    # exact when every row whose word could place at or before the
    # k-th selected row is a candidate
    kth = min(k_eff, m) - 1
    boundary = bs.col("__topk_w")[kth]
    live = b.sel.sum()
    exact = (live <= m) | ((w <= boundary).sum() <= m)
    flag = torch.logical_not(exact).reshape(1).expand(m)
    out = ColumnBatch(bs.data + (flag,), bs.valid + (ones,), bs.sel,
                      tuple(bs.names) + ("__topk_inexact",))
    return limit_batch(out, limit, offset)


def _compile_topk_sort_limit(node: P.Limit, params: ExecParams,
                             meta: P.OutputMeta | None) -> CompiledNode:
    sortnode: P.Sort = node.child
    childf = compile_plan(sortnode.child, params, meta)
    rank_tables = _sort_rank_tables(sortnode.keys, meta)
    keys = list(sortnode.keys)
    lim, off = node.limit, node.offset
    mode = params.sort_normalized

    def run_topk(rc: RunContext) -> ColumnBatch:
        rc.route["topk_cuts"] += 1
        return topk_sort_limit_batch(childf(rc), keys, rank_tables, lim,
                                     off, mode)
    return run_topk


def limit_batch(b: ColumnBatch, limit, offset) -> ColumnBatch:
    rank = torch.cumsum(b.sel.to(torch.int32), 0) - 1
    keep = b.sel
    if offset:
        keep = torch.logical_and(keep, rank >= offset)
    if limit is not None:
        keep = torch.logical_and(keep, rank < offset + limit)
    return b.with_sel(keep)


def _compile_sort(node: P.Sort, params: ExecParams,
                  meta: P.OutputMeta | None) -> CompiledNode:
    childf = compile_plan(node.child, params, meta)
    rank_tables = _sort_rank_tables(node.keys, meta)
    keys = list(node.keys)
    mode = params.sort_normalized

    def run_sort(rc: RunContext) -> ColumnBatch:
        return sort_batch(childf(rc), keys, rank_tables, mode)
    return run_sort


def _compile_window(node: P.Window, params: ExecParams) -> CompiledNode:
    """Window functions: one sort and cumulative scans per spec
    (ops/window.py), materialized as __win{i} columns. Neither
    streamable nor distributable: a window sees its whole partition."""
    from ..ops import window as W
    if params.axis_name is not None:
        raise ExecError("window functions cannot run distributed yet")
    childf = compile_plan(node.child, params)
    specs = []
    for w in node.windows:
        specs.append((
            w,
            compile_expr(w.arg) if w.arg is not None else None,
            [compile_expr(p) for p in w.partition_by],
            [(compile_expr(o), desc) for o, desc in w.order_by],
        ))

    def run_window(rc: RunContext) -> ColumnBatch:
        b = childf(rc)
        ctx = _ctx_of(b)
        for i, (w, argf, partfs, orderfs) in enumerate(specs):
            parts = [pf(ctx) for pf in partfs]
            orders = []
            for of, desc in orderfs:
                od, ov = of(ctx)
                orders.append((od, ov, desc))
            order, seg_start, peer_start, sel_s = W.order_and_segments(
                parts, orders, b.sel, params.sort_normalized)
            framed = bool(orders)
            if w.func == "row_number":
                d, v = W.row_number(order, seg_start, sel_s)
            elif w.func == "rank":
                d, v = W.rank(order, seg_start, peer_start, sel_s)
            elif w.func == "dense_rank":
                d, v = W.dense_rank(order, seg_start, peer_start, sel_s)
            elif w.func == "ntile":
                d, v = W.ntile(order, seg_start, sel_s, w.offset)
            elif w.func in ("lag", "lead"):
                ad, av = argf(ctx)
                off = w.offset if w.func == "lag" else -w.offset
                d, v = W.lag_lead(order, seg_start, sel_s, ad, av, off)
            elif w.func == "first_value":
                ad, av = argf(ctx)
                d, v = W.first_value(order, seg_start, sel_s, ad, av)
            elif w.func == "last_value":
                ad, av = argf(ctx)
                d, v = W.last_value(order, seg_start, peer_start, sel_s,
                                    ad, av, framed)
            else:  # sum/sum_int/count/count_rows/min/max/avg
                ad, av = argf(ctx) if argf is not None else (None, None)
                d, v = W.window_agg(w.func, order, seg_start, peer_start,
                                    sel_s, ad, av, framed)
                if w.func == "avg" and w.arg.type.family == Family.DECIMAL:
                    # a DECIMAL sums as scaled ints: AVG (FLOAT8) is
                    # logical. The reference returns the scaled mean
                    # here (10^scale times too large); the port does not
                    d = d / 10.0 ** w.arg.type.scale
            b = b.with_column(f"__win{i}", d, v)
            ctx = _ctx_of(b)
        return b
    return run_window


def _has_window(node: P.PlanNode) -> bool:
    if isinstance(node, P.Window):
        return True
    return any(_has_window(c) for c in
               (getattr(node, a, None) for a in ("child", "left", "right"))
               if c is not None)


# ---------------------------------------------------------------------------
# streaming: per-page partial aggregate state
# ---------------------------------------------------------------------------
# A table past the device budget runs page by page (exec/stream.py) and
# keeps only the per-group partial state on the device between pages.
# The page-partial / combine / finalize split is the reference's
# (cockroach_tpu/exec/compile.py compile_streaming): SUM -> add, MIN ->
# min, AVG -> (sum, count) + divide. The page state takes the plain
# scatters, as the reference's takes its XLA reductions: no kernel.

_COMBINE_OPS = {
    "add": torch.add,
    "min": torch.minimum,
    "max": torch.maximum,
}


def _is_float_agg_arg(a: BoundAgg) -> bool:
    return a.arg is not None and a.arg.type.family == Family.FLOAT


def _agg_state_ops(a: BoundAgg) -> tuple:
    """Static combine-op layout of one aggregate's partial state."""
    if a.func in ("count_rows", "count"):
        return ("add",)
    if a.func in ("sum", "sum_int"):
        # int64-accumulated sums carry a float64 shadow for the
        # overflow sentinel
        return ("add", "add") if _is_float_agg_arg(a) \
            else ("add", "add", "add")
    if a.func == "avg":
        return ("add", "add")
    if a.func == "min":
        return ("min", "add")
    if a.func in ("max", "any"):
        # `any` is a per-group-constant value: max-combining page
        # partials (empty groups hold the very negative identity)
        # picks the one real value
        return ("max", "add")
    raise ExecError(f"aggregate {a.func} cannot stream")


def _agg_page_state(a: BoundAgg, argf, batch, ctx, gid, num_groups,
                    max_group_rows=0) -> tuple:
    """One page's partial-state tensors for one aggregate (the layout
    of _agg_state_ops). Nothing here reads a device value back to the
    host."""
    grouped = gid is not None
    if a.func == "count_rows":
        mask = batch.sel
        d = (aggops.group_count(gid, mask, num_groups) if grouped
             else aggops.masked_count(mask).reshape(1))
        return (d,)
    d0, v0 = argf(ctx)
    mask = torch.logical_and(batch.sel, v0)
    cnt = (aggops.group_count(gid, mask, num_groups) if grouped
           else aggops.masked_count(mask).reshape(1))
    if a.func == "count":
        return (cnt,)
    if a.func in ("sum", "sum_int"):
        acc = torch.float64 if _is_float_agg_arg(a) else torch.int64
        d = (aggops.group_sum(d0, gid, mask, num_groups, acc_dtype=acc,
                              max_group_rows=max_group_rows,
                              arg_max_abs=a.arg_max_abs,
                              arg_nonneg=a.arg_nonneg)
             if grouped else
             aggops.masked_sum(d0, mask, acc_dtype=acc).reshape(1))
        if acc == torch.int64:
            # the reference picks between the int64 sum cast to f64 and
            # an f64 shadow scatter per page with lax.cond on the
            # page's rows x max|value|. Here the choice is made on the
            # host from the page's row count and the binder's static
            # bound (Engine._bound_agg_value_ranges): when it proves
            # the page partial cannot wrap, the cast IS the shadow
            # (within f64 rounding, inside the finalize tolerance);
            # else the shadow is summed
            if a.arg_max_abs and d0.shape[0] * a.arg_max_abs < 2 ** 62:
                sh = d.to(torch.float64)
            elif grouped:
                sh = aggops.group_sum(d0.to(torch.float64), gid, mask,
                                      num_groups)
            else:
                sh = aggops.masked_sum(d0.to(torch.float64), mask) \
                    .reshape(1)
            return (d, cnt, sh)
        return (d, cnt)
    if a.func == "avg":
        scale = (10.0 ** a.arg.type.scale
                 if a.arg.type.family == Family.DECIMAL else 1.0)
        df = d0.to(torch.float64) / scale
        s = (aggops.group_sum(df, gid, mask, num_groups) if grouped
             else aggops.masked_sum(df, mask).reshape(1))
        return (s, cnt)
    if a.func == "min":
        m = (aggops.group_min(d0, gid, mask, num_groups) if grouped
             else aggops.masked_min(d0, mask).reshape(1))
        return (m, cnt)
    if a.func == "max":
        m = (aggops.group_max(d0, gid, mask, num_groups) if grouped
             else aggops.masked_max(d0, mask).reshape(1))
        return (m, cnt)
    if a.func == "any":
        m = (aggops.group_any(d0, gid, mask, num_groups) if grouped
             else aggops.masked_max(d0, mask).reshape(1))
        return (m, cnt)
    raise ExecError(f"aggregate {a.func} cannot stream")


def _agg_finalize(a: BoundAgg, arrs: tuple):
    """Combined state -> (data, valid, overflow or None)."""
    if a.func in ("count_rows", "count"):
        d = arrs[0]
        return d, torch.ones_like(d, dtype=torch.bool), None
    if a.func in ("sum", "sum_int"):
        if _is_float_agg_arg(a):
            d, cnt = arrs
            return d, cnt > 0, None
        d, cnt, sh = arrs
        err = torch.abs(d.to(torch.float64) - sh)
        tol = torch.clamp(torch.abs(sh) * 1e-3, min=1e12)
        return d, cnt > 0, torch.any(err > tol)
    if a.func == "avg":
        s, cnt = arrs
        return s / torch.clamp(cnt, min=1).to(torch.float64), cnt > 0, None
    if a.func in ("min", "max", "any"):
        m, cnt = arrs
        return m, cnt > 0, None
    raise ExecError(f"aggregate {a.func} cannot stream")


@dataclass
class StreamingPlan:
    """A plan compiled for paged execution over one streamed scan."""
    page_fn: Callable      # RunContext -> flat state tuple
    combine: Callable      # (state, state) -> state
    final_fn: Callable     # state -> ColumnBatch


def can_stream(node: P.PlanNode) -> bool:
    """compile_streaming's eligibility: the engine never picks a plan
    it would refuse (hash-strategy GROUP BY and DISTINCT do not page, a
    window needs its whole partition)."""
    if _has_window(node):
        return False
    n = node
    if isinstance(n, P.Limit):
        n = n.child
    if isinstance(n, P.Sort):
        n = n.child
    if not isinstance(n, P.Aggregate):
        return False
    if n.group_by and n.max_groups <= 0:
        return False
    return not any(a.distinct for a in n.aggs)


def can_spill_sort(node: P.PlanNode) -> bool:
    """exec/spill.compile_spill_sort's eligibility: Limit?/Sort over a
    join-free single-scan spine (a window in it is not)."""
    if _has_window(node):
        return False
    n = node
    if isinstance(n, P.Limit):
        n = n.child
    if not isinstance(n, P.Sort) or not n.keys:
        return False
    n = n.child
    while isinstance(n, (P.Filter, P.Project, P.Compact)):
        n = n.child
    return isinstance(n, P.Scan)


def compile_streaming(node: P.PlanNode, params: ExecParams,
                      meta: P.OutputMeta | None = None) -> StreamingPlan:
    """Compile Limit?/Sort?/Aggregate(dense | ungrouped) for paging.

    The child subtree (scan, filter, project, joins against resident
    builds) compiles unchanged and runs once per page; only the
    aggregate splits into page partials, combine and finalize."""
    limit_node = sort_node = None
    n = node
    if isinstance(n, P.Limit):
        limit_node, n = n, n.child
    if isinstance(n, P.Sort):
        sort_node, n = n, n.child
    if not isinstance(n, P.Aggregate):
        raise ExecError("streaming requires an aggregate-rooted plan")
    agg = n
    if agg.group_by and agg.max_groups <= 0:
        raise ExecError("hash-strategy GROUP BY cannot stream yet")
    if any(a.distinct for a in agg.aggs):
        raise ExecError("DISTINCT aggregates cannot stream")
    childf = compile_plan(agg.child, params)
    groupfs = [(name, compile_expr(e)) for name, e in agg.group_by]
    aggfs = [(a, compile_expr(a.arg) if a.arg is not None else None)
             for a in agg.aggs]
    itemfs = [(name, compile_expr(e)) for name, e in agg.items]
    havingf = compile_expr(agg.having) if agg.having is not None else None
    dims = list(agg.group_dims)
    slos = list(agg.group_lo) or [0] * len(dims)
    num_groups = 1
    for dim in dims:
        num_groups *= dim + 1
    ops_layout = [_agg_state_ops(a) for a, _ in aggfs]
    flat_ops = tuple(op for ops in ops_layout for op in ops) + ("add",)

    def page_fn(rc: RunContext) -> tuple:
        b = childf(rc)
        ctx = _ctx_of(b)
        gid = None
        if groupfs:
            gid = torch.zeros(b.n, dtype=torch.int32, device=b.device)
            for (name, gf), dim, lo in zip(groupfs, dims, slos):
                d, v = gf(ctx)
                # int64 first: a BOOL key does not subtract
                code = torch.where(v, (d.to(torch.int64) - lo)
                                   .to(torch.int32), dim)
                gid = gid * (dim + 1) + code
        state = []
        for a, argf in aggfs:
            state.extend(_agg_page_state(a, argf, b, ctx, gid, num_groups,
                                         agg.max_group_rows))
        # the group liveness count rides last
        state.append(aggops.group_count(gid, b.sel, num_groups) if groupfs
                     else aggops.masked_count(b.sel).reshape(1))
        return tuple(state)

    def combine(sa: tuple, sb: tuple) -> tuple:
        return tuple(_COMBINE_OPS[op](x, y)
                     for op, x, y in zip(flat_ops, sa, sb))

    rank_tables = (_sort_rank_tables(sort_node.keys, meta)
                   if sort_node is not None else {})

    def final_fn(state: tuple) -> ColumnBatch:
        dev = state[-1].device
        group_cols = {}
        if groupfs:
            garange = torch.arange(num_groups, dtype=torch.int32,
                                   device=dev)
            strides = []
            s = 1
            for dim in reversed(dims):
                strides.append(s)
                s *= dim + 1
            strides.reverse()
            for (name, _), dim, st, lo in zip(groupfs, dims, strides,
                                              slos):
                code = (garange // st) % (dim + 1)
                val = code if lo == 0 else code.to(torch.int64) + lo
                group_cols[name] = (val, code < dim)
        i = 0
        aggs_out = []
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        for (a, _), ops in zip(aggfs, ops_layout):
            d, v, ovf = _agg_finalize(a, state[i:i + len(ops)])
            i += len(ops)
            aggs_out.append((d, v))
            if ovf is not None:
                overflow = torch.logical_or(overflow, ovf)
        live = (state[i] > 0 if groupfs
                else torch.ones(1, dtype=torch.bool, device=dev))
        out = _agg_output(group_cols, aggs_out, live, itemfs, havingf,
                          num_groups, overflow, dev)
        if sort_node is not None:
            out = sort_batch(out, list(sort_node.keys), rank_tables,
                             params.sort_normalized)
        if limit_node is not None:
            out = limit_batch(out, limit_node.limit, limit_node.offset)
        return out

    return StreamingPlan(page_fn, combine, final_fn)
