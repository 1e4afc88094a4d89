"""Physical planning: split a logical plan into local + final stages
(cockroach_tpu/distsql/physical.py, over the port's sql/plan.py and
sql/bound.py).

The DistAggregationTable model of the reference
(``pkg/sql/physicalplan/aggregator_funcs.go:22-91``): each aggregate
function maps to LocalStage functions computed per node and FinalStage
functions merging the partials at the gateway — SUM→SUM/SUM,
COUNT→COUNT/SUM_INT, AVG→[SUM,COUNT] + a division render. Plans whose
root aggregation cannot be split ship filtered rows instead ("rows"
stage) and aggregate entirely at the gateway.

The final stage is a normal logical plan whose leaf scans the union of
inbound partial batches (pseudo-table ``__union``), so it compiles
through the same compile_plan pipeline as any query.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from cockroach_tpu_torch.sql import plan as P
from cockroach_tpu_torch.sql.bound import (BAggRef, BBin, BCast, BCol,
                                           BDictLookup, BExpr, BoundAgg, walk)
from cockroach_tpu_torch.sql.types import FLOAT8, INT8, Family

UNION = "__union"
# pseudo-table the gateway's raw-row fold scans (adaptive partial
# aggregation): the union of raw source rows from shards that chose to
# ship rows instead of per-shard partials
RAW = "__rawunion"


@dataclass
class StagePlan:
    stage: str                    # "rows" | "partial_agg"
    local: P.PlanNode             # runs on every data node
    final: P.PlanNode             # runs at the gateway over __union
    union_columns: list[str] = field(default_factory=list)
    # union columns that are dictionary codes: name -> source BCol name.
    # Codes are node-local (each shard built its dictionary from its own
    # data), so these cross the wire as strings and the gateway
    # re-encodes them against a merged dictionary — the Arrow
    # dictionary-replacement model colserde sidesteps by shipping
    # dictionaries per batch.
    string_cols: dict = field(default_factory=dict)
    # final output name -> union string column whose merged dictionary
    # decodes it (fixes up OutputMeta.dictionaries at the gateway)
    dict_outputs: dict = field(default_factory=dict)
    # adaptive partial aggregation (Partial Partial Aggregates): when
    # the aggregate merges exactly (combine_exact), a shard whose group
    # cardinality approaches its row count may ship RAW source rows —
    # the partial stage would not reduce anything there — and the
    # gateway folds them through raw_merge (the same aggregate each
    # node would have run) into one extra partial chunk. None/empty
    # when the statement is not eligible; per-shard choice happens at
    # flow setup time (node.py _adaptive_agg_stage).
    raw_local: P.PlanNode = None       # Project of the source columns
    raw_columns: list = field(default_factory=list)
    raw_strings: dict = field(default_factory=dict)
    raw_merge: P.PlanNode = None       # Aggregate over Scan(__rawunion)
    # hierarchical partial-agg merge (round 15 multi-host tentpole):
    # partial-form chunks may tree-merge at intermediate hosts before
    # reaching the gateway (merge_partials below). merge_cols are the
    # group-key names, merge_funcs maps each __pN partial column to its
    # associative merge function, and merge_exact gates the whole path
    # on combine_exact — a mid-tree merge reorders the fold, so only
    # order-free/exactly-associative aggregates may ride it.
    merge_cols: list = field(default_factory=list)
    merge_funcs: dict = field(default_factory=dict)
    merge_exact: bool = False


def _peel(node: P.PlanNode):
    """Strip Limit/Sort wrappers off the root; they rerun above the
    final stage (all inputs gathered at the gateway by then)."""
    wrappers = []
    while isinstance(node, (P.Limit, P.Sort)):
        wrappers.append(node)
        node = node.child
    return wrappers, node


def _rewrap(wrappers, node):
    for w in reversed(wrappers):
        if isinstance(w, P.Limit):
            node = P.Limit(node, w.limit, w.offset)
        else:
            node = P.Sort(node, list(w.keys))
    return node


def _coltypes(node: P.PlanNode) -> dict:
    """name -> SQLType for every column reference in the tree."""
    out = {}

    def scan_expr(e):
        if e is None:
            return
        for sub in walk(e):
            if isinstance(sub, BCol) and sub.type is not None:
                out.setdefault(sub.name, sub.type)

    def rec(n):
        if isinstance(n, P.Scan):
            scan_expr(n.filter)
            for _, e in n.computed:
                scan_expr(e)
        elif isinstance(n, P.Filter):
            scan_expr(n.pred)
            rec(n.child)
        elif isinstance(n, P.Project):
            for _, e in n.items:
                scan_expr(e)
            rec(n.child)
        elif isinstance(n, P.HashJoin):
            rec(n.left)
            rec(n.right)
        elif isinstance(n, P.Aggregate):
            for _, e in n.group_by:
                scan_expr(e)
            for a in n.aggs:
                scan_expr(a.arg)
            scan_expr(n.having)
            for _, e in n.items:
                scan_expr(e)
            rec(n.child)
        elif isinstance(n, (P.Sort, P.Limit)):
            rec(n.child)
    rec(node)
    return out


def _subst_aggrefs(e: BExpr, mapping: dict[int, BExpr]) -> BExpr:
    import copy
    if e is None:
        return None
    if isinstance(e, BAggRef):
        return mapping[e.index]
    e = copy.copy(e)
    if isinstance(e, BBin):
        e.left = _subst_aggrefs(e.left, mapping)
        e.right = _subst_aggrefs(e.right, mapping)
    elif hasattr(e, "expr"):
        e.expr = _subst_aggrefs(e.expr, mapping)
    elif hasattr(e, "operand"):
        e.operand = _subst_aggrefs(e.operand, mapping)
    elif hasattr(e, "args"):
        e.args = [_subst_aggrefs(a, mapping) for a in e.args]
    elif hasattr(e, "whens"):
        e.whens = [(_subst_aggrefs(c, mapping), _subst_aggrefs(v, mapping))
                   for c, v in e.whens]
        if e.else_ is not None:
            e.else_ = _subst_aggrefs(e.else_, mapping)
    return e


SPLITTABLE = {"sum", "sum_int", "count", "count_rows", "min", "max",
              "any", "avg"}

# aggregates whose partial/merge decomposition is bit-identical to
# aggregating the raw rows in any order and grouping
_ORDER_FREE = {"count", "count_rows", "min", "max", "any"}


def combine_exact(aggs) -> bool:
    """True when merging per-shard partials gives bit-identical results
    to aggregating the raw rows directly, regardless of how rows split
    across shards: min/max/any/count are order-free, and integer (or
    scaled-decimal) sums are exactly associative. FLOAT sums — and AVG,
    whose local stage is a float sum — depend on addition order, so the
    adaptive raw-ship path must not rewrite them."""
    for a in aggs:
        if a.func in _ORDER_FREE:
            continue
        if a.func in ("sum", "sum_int") and a.type is not None \
                and a.type.family is not Family.FLOAT:
            continue
        return False
    return True


def _raw_safe(core: P.Aggregate) -> bool:
    """May this aggregate's raw source rows cross the wire? Dictionary
    codes are node-local: the gateway re-encodes wire strings against a
    merged dictionary, so any expression that interprets codes
    numerically breaks under raw shipping. A PLAIN dict-coded group key
    is safe (re-encoding preserves group identity and the hash strategy
    regroups by the merged codes) — but a BDictLookup (its table
    indexes the ORIGINAL codes) or a dict-coded column inside a
    computed expression is not."""
    def hazard(e, allow_plain_col: bool) -> bool:
        if e is None:
            return False
        if allow_plain_col and isinstance(e, BCol):
            return False
        for sub in walk(e):
            if isinstance(sub, BDictLookup):
                return True
            ty = getattr(sub, "type", None)
            if isinstance(sub, BCol) and ty is not None \
                    and ty.uses_dictionary:
                return True
        return False

    for _, ge in core.group_by:
        if hazard(ge, allow_plain_col=True):
            return False
    for a in core.aggs:
        if hazard(a.arg, allow_plain_col=False):
            return False
    return True


def split(node: P.PlanNode) -> StagePlan:
    wrappers, core = _peel(node)
    if isinstance(core, P.Aggregate) and \
            all(a.func in SPLITTABLE and not a.distinct
                for a in core.aggs):
        return _split_aggregate(wrappers, core)
    return _rows_stage(wrappers, core)


def _string_union_cols(pairs) -> dict:
    """(union_name, expr) pairs -> {union_name: source name} for
    dictionary-coded columns: a plain column's source column, or, in
    the port, the union name itself for an expression that carries its
    own output dictionary (string builtins, COALESCE/CASE over string
    literals: the node resolves it by that name, DistSQLNode.
    _dictionary_for). Any other string expression has no dictionary to
    decode it by: not distributable."""
    out = {}
    for n, e in pairs:
        ty = getattr(e, "type", None)
        if ty is not None and ty.uses_dictionary:
            if isinstance(e, BCol):
                out[n] = e.name
            elif getattr(e, "dictionary", None) is not None:
                out[n] = n
            else:
                raise DistUnsupported(
                    f"string output {n!r} is not a plain column")
    return out


class DistUnsupported(Exception):
    pass


def _rows_stage(wrappers, core) -> StagePlan:
    """Ship (filtered/projected) rows; whole core repeats at gateway
    over the union when it is an Aggregate, else rows pass through."""
    if isinstance(core, P.Aggregate):
        types = _coltypes(core)
        needed = set()
        for _, e in core.group_by:
            needed |= {c.name for c in walk(e) if isinstance(c, BCol)}
        for a in core.aggs:
            if a.arg is not None:
                needed |= {c.name for c in walk(a.arg)
                           if isinstance(c, BCol)}
        cols = sorted(needed)
        items = [(n, BCol(n, types.get(n))) for n in cols]
        local = P.Project(core.child, items=items)
        strings = _string_union_cols(items)
        final_child = P.Scan(UNION, UNION, columns={n: n for n in cols})
        final = P.Aggregate(final_child, list(core.group_by),
                            list(core.aggs), core.having,
                            list(core.items),
                            0 if strings else core.max_groups,
                            [] if strings else list(core.group_dims),
                            group_lo=([] if strings
                                      else list(core.group_lo)))
        # output -> group name -> source column (two hops)
        group_src = {gn: ge.name for gn, ge in core.group_by
                     if isinstance(ge, BCol) and ge.name in strings}
        dict_outputs = {n: group_src[e.name] for n, e in core.items
                        if isinstance(e, BCol) and e.name in group_src}
        return StagePlan("rows", local, _rewrap(wrappers, final), cols,
                         strings, dict_outputs)
    # pure row pipeline (no aggregate): union the outputs, rerun
    # sort/limit at the gateway
    out_names = _output_names(core)
    items = _output_items(core)
    strings = _string_union_cols(items) if items is not None else {}
    final = P.Scan(UNION, UNION, columns={n: n for n in out_names})
    return StagePlan("rows", core, _rewrap(wrappers, final), out_names,
                     strings, {n: n for n in strings})


def _output_items(core: P.PlanNode):
    if isinstance(core, P.Project):
        return list(core.items)
    if isinstance(core, P.Aggregate):
        return list(core.items)
    if isinstance(core, P.Filter):
        return _output_items(core.child)
    return None


def _output_names(core: P.PlanNode) -> list[str]:
    if isinstance(core, P.Project):
        return [n for n, _ in core.items]
    if isinstance(core, P.Aggregate):
        return [n for n, _ in core.items]
    if isinstance(core, P.Scan):
        return list(core.columns.keys())
    if isinstance(core, (P.Filter,)):
        return _output_names(core.child)
    if isinstance(core, P.HashJoin):
        return _output_names(core.left) + list(core.payload)
    raise ValueError(f"cannot determine output columns of {core!r}")


def _split_aggregate(wrappers, core: P.Aggregate) -> StagePlan:
    local_aggs: list[BoundAgg] = []
    final_aggs: list[BoundAgg] = []
    # orig agg index -> expression over final agg refs
    final_ref: dict[int, BExpr] = {}

    def partial_name(j: int) -> str:
        return f"__p{j}"

    for i, a in enumerate(core.aggs):
        fam = a.arg.type.family if a.arg is not None else None
        if a.func == "avg" and fam in (Family.INT, Family.DECIMAL):
            # the port's AVG over INT/DECIMAL: an exact SUM and COUNT
            # locally (the reference sums FLOAT8 casts), merged exactly
            # and divided at the final stage. The local stage stays in
            # kernel 1's exact envelope under `auto`; the quotient is
            # FLOAT8 either way
            sfunc, sty = (("sum", a.arg.type) if fam is Family.DECIMAL
                          else ("sum_int", INT8))
            js, jc = len(local_aggs), len(local_aggs) + 1
            local_aggs.append(BoundAgg(sfunc, a.arg, sty))
            local_aggs.append(BoundAgg("count", a.arg, a.type))
            fs, fc = len(final_aggs), len(final_aggs) + 1
            final_aggs.append(BoundAgg(
                sfunc, BCol(partial_name(js), sty), sty))
            final_aggs.append(BoundAgg(
                "sum_int", BCol(partial_name(jc), a.type), a.type))
            final_ref[i] = BBin("/", BCast(BAggRef(fs, sty), FLOAT8),
                                BCast(BAggRef(fc, a.type), FLOAT8),
                                FLOAT8)
            continue
        if a.func == "avg":
            # AVG -> [SUM(float), COUNT] locally; SUM/SUM + divide at
            # the final stage (aggregator_funcs.go AVG entry). BCast
            # DECIMAL->FLOAT descales scaled-int decimals itself.
            arg_f: BExpr = BCast(a.arg, FLOAT8)
            js, jc = len(local_aggs), len(local_aggs) + 1
            local_aggs.append(BoundAgg("sum", arg_f, FLOAT8))
            local_aggs.append(BoundAgg("count", a.arg, a.type))
            fs, fc = len(final_aggs), len(final_aggs) + 1
            final_aggs.append(BoundAgg(
                "sum", BCol(partial_name(js), FLOAT8), FLOAT8))
            final_aggs.append(BoundAgg(
                "sum_int", BCol(partial_name(jc), a.type), a.type))
            final_ref[i] = BBin("/", BAggRef(fs, FLOAT8),
                                BCast(BAggRef(fc, a.type), FLOAT8),
                                FLOAT8)
            continue
        j = len(local_aggs)
        local_aggs.append(a)
        f = len(final_aggs)
        merge_func = {"sum": "sum", "sum_int": "sum_int",
                      "count": "sum_int", "count_rows": "sum_int",
                      "min": "min", "max": "max",
                      "any": "max"}[a.func]
        final_aggs.append(BoundAgg(merge_func,
                                   BCol(partial_name(j), a.type), a.type))
        final_ref[i] = BAggRef(f, a.type)

    gnames = [n for n, _ in core.group_by]
    local_items = [(n, BCol(n, e.type)) for n, e in core.group_by]
    local_items += [(partial_name(j), BAggRef(j, la.type))
                    for j, la in enumerate(local_aggs)]
    local = P.Aggregate(core.child, list(core.group_by), local_aggs,
                        None, local_items, core.max_groups,
                        list(core.group_dims),
                        group_lo=list(core.group_lo))
    strings = _string_union_cols(list(core.group_by))

    union_cols = gnames + [partial_name(j)
                           for j in range(len(local_aggs))]
    final_child = P.Scan(UNION, UNION,
                         columns={n: n for n in union_cols})
    final_group = [(n, BCol(n, e.type)) for n, e in core.group_by]
    final_items = [(n, _subst_aggrefs(e, final_ref))
                   for n, e in core.items]
    final_having = _subst_aggrefs(core.having, final_ref)
    # merged dictionaries are only known at union time, so dict-coded
    # group keys re-group via the hash strategy at the gateway
    final = P.Aggregate(final_child, final_group, final_aggs,
                        final_having, final_items,
                        0 if strings else core.max_groups,
                        [] if strings else list(core.group_dims),
                        group_lo=([] if strings
                                  else list(core.group_lo)))
    dict_outputs = {n: e.name for n, e in final_items
                    if isinstance(e, BCol) and e.name in strings}
    sp = StagePlan("partial_agg", local, _rewrap(wrappers, final),
                   union_cols, strings, dict_outputs)
    # hierarchical-merge metadata: every final agg is a merge over one
    # partial column (BCol __pN by construction above), so the partial
    # schema merges to itself under these functions at any tree level
    sp.merge_cols = list(gnames)
    sp.merge_funcs = {fa.arg.name: fa.func for fa in final_aggs}
    sp.merge_exact = combine_exact(core.aggs)

    # adaptive raw-ship alternative: only for combine-exact aggregates
    # (bit-identity across the per-shard choice) with at least one agg
    # (so partial chunks are distinguishable by their __p0 column) and
    # no dictionary-code hazard in the exprs that re-run at the gateway
    if local_aggs and combine_exact(core.aggs) and _raw_safe(core):
        types = _coltypes(core)
        needed = set()
        for _, e in core.group_by:
            needed |= {c.name for c in walk(e) if isinstance(c, BCol)}
        for a in core.aggs:
            if a.arg is not None:
                needed |= {c.name for c in walk(a.arg)
                           if isinstance(c, BCol)}
        raw_cols = sorted(needed)
        raw_items = [(n, BCol(n, types.get(n))) for n in raw_cols]
        try:
            raw_strings = _string_union_cols(raw_items)
        except DistUnsupported:
            return sp
        sp.raw_local = P.Project(core.child, items=raw_items)
        sp.raw_columns = raw_cols
        sp.raw_strings = raw_strings
        raw_child = P.Scan(RAW, RAW, columns={n: n for n in raw_cols})
        # same shape as the per-node partial stage, scanning the raw
        # union: its output schema is exactly union_cols, so the fold
        # result joins the partial chunks unchanged. Dict-coded keys
        # force the hash strategy (codes are merged-dict at the
        # gateway, not the planner's).
        hashed = bool(strings or raw_strings)
        sp.raw_merge = P.Aggregate(
            raw_child, list(core.group_by), local_aggs, None,
            local_items, 0 if hashed else core.max_groups,
            [] if hashed else list(core.group_dims),
            group_lo=([] if hashed else list(core.group_lo)))
    return sp


class MergeUnsupported(Exception):
    """A partial chunk's dtype cannot tree-merge host-side; the caller
    forwards the chunks unmerged (correctness first, byte savings
    second)."""


def merge_partials(chunks, group_cols, merge_funcs):
    """Tree-merge partial-form wire chunks into one partial-form chunk.

    The mid-tree rung of the hierarchical merge: psum folds partials
    inside a host's mesh, this folds partial CHUNKS across rendezvous
    domains on their way up the host tree, and the gateway's final
    stage merges whatever reaches it. Chunks are the wire tuples
    ``(n, cols, valid)`` (numpy host arrays, strings decoded) that
    DistSQLNode._host_output produces, all sharing the partial schema
    ``group_cols + merge_funcs.keys()``.

    Pure numpy, no device work: intermediate hosts must merge without
    compiling a plan (and without touching their mesh mid-flow). Only
    combine-exact stages ride this path (StagePlan.merge_exact), so
    the host-side int sums / min / max are bit-identical to any other
    fold order. Raises MergeUnsupported for dtypes it cannot reduce
    exactly (the caller forwards unmerged).
    """
    import numpy as np
    live = [(n, c, v) for n, c, v in chunks if n > 0]
    names = list(group_cols) + list(merge_funcs)
    if not live:
        _n, c0, v0 = chunks[0]
        return (0, {k: c0[k][:0] for k in names},
                {k: v0[k][:0] for k in names})
    for p in merge_funcs:
        for _n, c, _v in live:
            if c[p].dtype.kind not in "biuf":
                raise MergeUnsupported(
                    f"partial column {p!r} has dtype {c[p].dtype}")
    total = sum(n for n, _c, _v in live)
    cols = {c: np.concatenate([ch[1][c] for ch in live]) for c in names}
    valid = {c: np.concatenate([ch[2][c] for ch in live]).astype(bool)
             for c in names}
    # group identity = (valid bit, value) per key column; invalid
    # slots normalize to the type's zero so NULL groups coalesce
    fields, keydata = [], []
    for idx, g in enumerate(group_cols):
        gv = valid[g]
        vals = cols[g].copy()
        vals[~gv] = (b"" if vals.dtype.kind == "S"
                     else "" if vals.dtype.kind == "U"
                     else vals.dtype.type(0))
        fields += [(f"v{idx}", np.uint8), (f"k{idx}", vals.dtype)]
        keydata.append((gv.astype(np.uint8), vals))
    if fields:
        rec = np.empty(total, dtype=fields)
        for idx, (gv8, vals) in enumerate(keydata):
            rec[f"v{idx}"] = gv8
            rec[f"k{idx}"] = vals
        _uniq, first, inv = np.unique(rec, return_index=True,
                                      return_inverse=True)
        inv = inv.reshape(-1)
        k = len(first)
    else:      # ungrouped aggregate: one global group
        first = np.zeros(1, dtype=np.int64)
        inv = np.zeros(total, dtype=np.int64)
        k = 1
    out_cols = {g: cols[g][first] for g in group_cols}
    out_valid = {g: valid[g][first] for g in group_cols}
    for p, func in merge_funcs.items():
        pv = valid[p]
        vals = cols[p]
        dt = vals.dtype
        if func in ("sum", "sum_int"):
            ident = dt.type(0)
        elif func == "min":
            ident = (dt.type(np.inf) if dt.kind == "f"
                     else dt.type(np.iinfo(dt).max) if dt.kind in "iu"
                     else dt.type(True))
        else:                       # max / any
            ident = (dt.type(-np.inf) if dt.kind == "f"
                     else dt.type(np.iinfo(dt).min) if dt.kind in "iu"
                     else dt.type(False))
        contrib = np.where(pv, vals, ident)
        acc = np.full(k, ident, dtype=dt)
        if func in ("sum", "sum_int"):
            if dt.kind in "iu":
                # int SUM folds must not wrap silently (round-15
                # carried follow-up): accumulate through Python ints
                # (object dtype — arbitrary precision) and compare
                # against the native dtype's range. In range → cast
                # back, bit-identical to a non-overflowing native
                # fold; out of range → MergeUnsupported, so the
                # caller forwards unmerged and the overflow surfaces
                # at the gateway's device fold (__sum_overflow guard)
                # instead of as a silently wrapped number.
                wide = np.zeros(k, dtype=object)
                np.add.at(wide, inv, contrib.astype(object))
                info = np.iinfo(dt)
                lo = min((int(x) for x in wide), default=0)
                hi = max((int(x) for x in wide), default=0)
                if lo < int(info.min) or hi > int(info.max):
                    raise MergeUnsupported(
                        f"partial column {p!r}: {dt} SUM overflow "
                        f"in tree merge (range [{lo}, {hi}])")
                acc = wide.astype(dt)
            else:
                np.add.at(acc, inv, contrib)
        elif func == "min":
            np.minimum.at(acc, inv, contrib)
        else:
            np.maximum.at(acc, inv, contrib)
        anyv = np.zeros(k, dtype=bool)
        np.logical_or.at(anyv, inv, pv)
        out_cols[p] = acc
        out_valid[p] = anyv
    return k, out_cols, out_valid
