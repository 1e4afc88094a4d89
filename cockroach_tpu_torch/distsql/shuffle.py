"""Host-level hash shuffle: multi-stage flow graphs with exchange edges
(cockroach_tpu/distsql/shuffle.py; ``_hash_col`` is the reference's bit
for bit, so rows route to the same nodes. The device exchange of a
shard mesh is parallel/shuffle.py, a different layer).

Rounds 3 and 4 planned exactly one distributed shape — leaseholder
scan + partial aggregate, with join build sides replicated on every
node — and rejected anything else (`node.py`'s old
``_check_join_placement``). This module removes that wall: a logical
plan decomposes into a DAG of stages whose edges hash-partition rows
across the data nodes, so

- a join of two *sharded* (non-replicated) tables co-partitions both
  sides by join key: every node joins one disjoint key slice;
- a GROUP BY hash-distributes group keys so each group is merged on
  exactly one node, with a second exchange gathering finished groups.

The reference shape being rebuilt: ``HashRouter`` partitioning one
stream to N consumers (colflow/routers.go:425,471), ``Outbox``/
``Inbox`` streaming batches between any two nodes
(colrpc/outbox.go:49,150), and multi-processor FlowSpecs
(execinfrapb/api.proto:149,172). Stages stay whole plans compiled per
node (compile_plan); only the *routing* is host-side.

Stage graphs are re-derived deterministically on every node from the
statement text (flow.py's re-plan-don't-ship-protos design), so the
wire spec stays (sql, graph kind, node set). Determinism requires the
plan's SHAPE to be independent of any node's local shard: callers
plan with a stats-free catalog view (``Engine.catalog_view(...,
stats=False)``) so join order/build-side choices can't consult local
row counts.

Dictionary-coded strings and the exchange: predicates over strings
compile to host-precomputed LUTs against the *binding-time table
dictionary* (sql/binder.py), but rows arriving on an exchange edge
re-encode against a per-stage shared dictionary — the codes no longer
match any LUT. Two mechanisms keep string queries distributable:

1. **Pushdown**: any one-sided, non-string subexpression that touches
   a dictionary column (``p_type LIKE 'PROMO%'``) is evaluated BELOW
   the exchange as a computed column and crosses the wire as its
   numeric/bool result.
2. **Shared re-encode**: plain string columns ship as raw strings and
   every string column of a stage's inputs encodes into ONE shared
   dictionary, so code equality (join keys, group keys, col=col
   compares) stays exact across edges.

Anything else (a LUT that survives above an exchange) raises
``DistUnsupported`` and the caller falls back to a supported path.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

from cockroach_tpu_torch.distsql.physical import (UNION, DistUnsupported,
                                                  _peel, _rewrap, split)
from cockroach_tpu_torch.sql import plan as P
from cockroach_tpu_torch.sql.bound import (BBetween, BBin, BCase, BCast,
                                           BCoalesce, BCol, BDictGather,
                                           BDictLookup, BDictRemap, BExtract,
                                           BFunc, BInList, BIsNull, BUnary,
                                           BoundAgg, referenced_columns, walk)


def exch_table(edge: int) -> str:
    return f"__x{edge}"


@dataclass
class Edge:
    """One hash-exchange: producers route rows by hash(keys) to the
    flow's data nodes (consumer i of the spec's node list gets bucket
    i)."""
    edge: int
    keys: list[str]                  # batch-column names hashed
    columns: list[str]               # shipped columns
    string_cols: dict = field(default_factory=dict)  # col -> source col


@dataclass
class Stage:
    """One per-node execution stage. ``plan`` scans real tables and/or
    ``__x{e}`` exchange pseudo-tables; ``output`` is the edge it
    feeds, or None for the gather stream to the gateway."""
    sid: int
    plan: P.PlanNode
    inputs: list[int] = field(default_factory=list)
    output: int | None = None


@dataclass
class ShuffleGraph:
    kind: str                        # "join" | "groupby"
    stages: list[Stage]
    edges: dict[int, Edge]
    # gateway side (same contract as physical.StagePlan)
    final: P.PlanNode
    union_columns: list[str]
    string_cols: dict
    dict_outputs: dict
    tables: dict                     # alias -> real table (span planning)


# ---------------------------------------------------------------------------
# deterministic partition hash (host-side; must agree across producers)
# ---------------------------------------------------------------------------

_FNV = np.uint64(0x100000001B3)
_MIX = np.uint64(0xFF51AFD7ED558CCD)


def _hash_col(v: np.ndarray, ok: np.ndarray) -> np.ndarray:
    n = len(v)
    if v.dtype.kind in "SUO":
        b = np.asarray(v).astype("S")
        w = b.dtype.itemsize
        if n == 0 or w == 0:
            hv = np.zeros(n, dtype=np.uint64)
        else:
            m = np.frombuffer(b.tobytes(), dtype=np.uint8).reshape(n, w)
            # fold only each row's REAL bytes: the fixed-width S dtype
            # NUL-pads to the batch's longest string, and that width
            # varies per producer batch — folding the padding would
            # hash equal strings to different buckets on different
            # nodes (co-partitioned joins silently dropping rows)
            rowlen = np.char.str_len(b).astype(np.int64)
            hv = np.full(n, np.uint64(2166136261), dtype=np.uint64)
            for j in range(w):
                live = j < rowlen
                hv = np.where(live,
                              (hv ^ m[:, j].astype(np.uint64)) * _FNV,
                              hv)
    else:
        if v.dtype.kind == "f":
            # normalize -0.0 == 0.0 before bit-hashing
            iv = (v.astype(np.float64) + 0.0).view(np.uint64)
        else:
            iv = v.astype(np.int64).view(np.uint64)
        x = iv.copy()
        x ^= x >> np.uint64(33)
        x *= _MIX
        x ^= x >> np.uint64(33)
        hv = x
    # NULLs of a key column all hash alike (value contribution zeroed,
    # validity bit mixed) so NULL groups land on one node
    return np.where(ok, hv, np.uint64(0))


def partition_buckets(cols: dict, valid: dict, keys: list[str],
                      n_buckets: int) -> np.ndarray:
    """Row -> consumer bucket, identical on every producer for equal
    logical key tuples (the HashRouter decision, routers.go:471)."""
    some = cols[keys[0]]
    h = np.full(len(some), np.uint64(0x9E3779B97F4A7C15), dtype=np.uint64)
    for k in keys:
        ok = np.asarray(valid[k], dtype=bool)
        h = (h * _FNV) ^ _hash_col(np.asarray(cols[k]), ok) \
            ^ ok.astype(np.uint64)
    return (h % np.uint64(n_buckets)).astype(np.int64)


# ---------------------------------------------------------------------------
# expression rewrite helpers
# ---------------------------------------------------------------------------

def _map_expr(e, fn):
    """Rebuild ``e`` bottom-up; ``fn(node)`` may return a replacement
    (children then NOT visited) or None to recurse."""
    if e is None:
        return None
    r = fn(e)
    if r is not None:
        return r
    e2 = copy.copy(e)
    if isinstance(e2, BBin):
        e2.left = _map_expr(e2.left, fn)
        e2.right = _map_expr(e2.right, fn)
    elif isinstance(e2, BUnary):
        e2.operand = _map_expr(e2.operand, fn)
    elif isinstance(e2, BBetween):
        e2.expr = _map_expr(e2.expr, fn)
        e2.lo = _map_expr(e2.lo, fn)
        e2.hi = _map_expr(e2.hi, fn)
    elif isinstance(e2, (BInList, BIsNull, BDictLookup, BDictRemap,
                         BDictGather, BCast, BExtract)):
        e2.expr = _map_expr(e2.expr, fn)
    elif isinstance(e2, (BFunc, BCoalesce)):
        e2.args = [_map_expr(a, fn) for a in e2.args]
    elif isinstance(e2, BCase):
        e2.whens = [(_map_expr(c, fn), _map_expr(v, fn))
                    for c, v in e2.whens]
        if e2.else_ is not None:
            e2.else_ = _map_expr(e2.else_, fn)
    return e2


def _is_dict_type(ty) -> bool:
    return ty is not None and getattr(ty, "uses_dictionary", False)


def _uses_dict_col(e, types) -> bool:
    return any(_is_dict_type(types.get(c.name) or c.type)
               for c in walk(e) if isinstance(c, BCol))


class _Pushdown:
    """Push one-sided subexpressions that touch dictionary columns
    below the exchange (their LUTs only bind against local table
    dictionaries — see module docstring)."""

    def __init__(self, left_out: set, right_out: set, types: dict):
        self.left_out = left_out
        self.right_out = right_out
        self.types = types
        self.pushed_left: list[tuple[str, object]] = []
        self.pushed_right: list[tuple[str, object]] = []
        self._by_repr: dict[str, object] = {}

    def _push(self, sub, side: str):
        key = repr(sub)
        hit = self._by_repr.get(key)
        if hit is not None:
            return hit
        name = f"__sh{len(self._by_repr)}"
        ty = getattr(sub, "type", None)
        (self.pushed_left if side == "left"
         else self.pushed_right).append((name, sub))
        ref = BCol(name, ty)
        self._by_repr[key] = ref
        return ref

    def rewrite(self, e):
        def fn(sub):
            if isinstance(sub, BCol):
                return None          # plain columns ship as-is
            refs = referenced_columns(sub)
            if not refs or not _uses_dict_col(sub, self.types):
                return None
            if _is_dict_type(getattr(sub, "type", None)):
                return None          # string-valued: can't ship as data
            if refs <= self.left_out:
                return self._push(sub, "left")
            if refs <= self.right_out:
                return self._push(sub, "right")
            return None              # two-sided: recurse into children
        return _map_expr(e, fn)


def _check_no_luts(exprs) -> None:
    """A dictionary LUT surviving above an exchange would index the
    binding-time dictionary with shared-dictionary codes — reject."""
    for e in exprs:
        if e is None:
            continue
        for sub in walk(e):
            if isinstance(sub, (BDictLookup, BDictRemap, BDictGather)):
                raise DistUnsupported(
                    "string expression crosses the exchange (cannot "
                    "be pushed to one side)")


# ---------------------------------------------------------------------------
# graph decomposition
# ---------------------------------------------------------------------------

def graph_kind(node: P.PlanNode):
    """Which shuffle decomposition (if any) fits this plan."""
    _, core = _peel(node)
    joins = _collect_joins(core)
    if len(joins) == 1:
        return "join"
    if not joins and isinstance(core, P.Aggregate) and core.group_by:
        from cockroach_tpu_torch.distsql.physical import SPLITTABLE
        if all(a.func in SPLITTABLE and not a.distinct
               for a in core.aggs):
            return "groupby"
    return None


def decompose(kind: str, node: P.PlanNode) -> ShuffleGraph:
    if kind == "join":
        return _decompose_join(node)
    if kind == "groupby":
        return _decompose_groupby(node)
    raise DistUnsupported(f"unknown shuffle graph kind {kind!r}")


def _collect_joins(n) -> list:
    out = []

    def rec(x):
        if isinstance(x, P.HashJoin):
            out.append(x)
            rec(x.left)
            rec(x.right)
        else:
            c = getattr(x, "child", None)
            if c is not None:
                rec(c)
    rec(n)
    return out


def _subtree_outputs(n, types: dict) -> dict:
    """name -> SQLType|None for the columns a join input produces."""
    if isinstance(n, P.Scan):
        d = {bn: types.get(bn) for bn in n.columns}
        for cn, e in n.computed:
            d[cn] = getattr(e, "type", None)
        return d
    if isinstance(n, P.Project):
        return {nm: getattr(e, "type", None) for nm, e in n.items}
    if isinstance(n, (P.Filter, P.Compact)):
        return _subtree_outputs(n.child, types)
    raise DistUnsupported(
        f"shuffle: unsupported join input {type(n).__name__}")


def _coltypes_full(node) -> dict:
    from cockroach_tpu_torch.distsql.physical import _coltypes
    return _coltypes(node)


def _collect_real_scans(*plans) -> dict:
    out = {}

    def rec(n):
        if isinstance(n, P.Scan):
            if n.table != UNION and not n.table.startswith("__x"):
                out[n.alias] = n.table
        elif isinstance(n, P.HashJoin):
            rec(n.left)
            rec(n.right)
        elif getattr(n, "child", None) is not None:
            rec(n.child)
    for p in plans:
        rec(p)
    return out


def _string_map(names, types) -> dict:
    return {n: n for n in names if _is_dict_type(types.get(n))}


def _ship_project(sub, names, types, pushed):
    """Stage plan for a join input: the subtree narrowed to its shipped
    columns + pushed computed expressions."""
    items = [(n, BCol(n, types.get(n))) for n in names]
    items += pushed
    return P.Project(sub, items=items)


def _decompose_join(node: P.PlanNode) -> ShuffleGraph:
    wrappers, core = _peel(node)
    joins = _collect_joins(core)
    if len(joins) != 1:
        raise DistUnsupported(
            f"shuffle join wants exactly one join, plan has {len(joins)}")
    join = joins[0]
    if join.join_type not in ("inner", "left"):
        raise DistUnsupported(
            f"shuffle join: join type {join.join_type!r} unsupported")
    types = _coltypes_full(node)
    left_out = _subtree_outputs(join.left, types)
    right_out = _subtree_outputs(join.right, types)
    types = {**{n: t for n, t in left_out.items() if t is not None},
             **{n: t for n, t in right_out.items() if t is not None},
             **types}

    rw = _Pushdown(set(left_out), set(right_out), types)
    refs_above: set[str] = set()
    checked: list = []

    def rewrite(e):
        e2 = rw.rewrite(e)
        if e2 is not None:
            refs_above.update(referenced_columns(e2))
            checked.append(e2)
        return e2

    xl = P.Scan(exch_table(0), exch_table(0))
    xr = P.Scan(exch_table(1), exch_table(1))
    repl = P.HashJoin(xl, xr, left_keys=list(join.left_keys),
                      right_keys=list(join.right_keys),
                      payload=list(join.payload),
                      join_type=join.join_type,
                      expand=1, direct=None, pack_payload=[])

    def rebuild(n):
        if n is join:
            return repl
        if isinstance(n, P.Filter):
            return P.Filter(rebuild(n.child), rewrite(n.pred))
        if isinstance(n, P.Project):
            return P.Project(rebuild(n.child),
                             [(nm, rewrite(e)) for nm, e in n.items])
        if isinstance(n, P.Compact):
            return P.Compact(rebuild(n.child), n.frac, n.block)
        if isinstance(n, P.Aggregate):
            group_by = [(nm, rewrite(e)) for nm, e in n.group_by]
            aggs = [BoundAgg(a.func, rewrite(a.arg), a.type, a.distinct,
                             a.arg_max_abs, a.arg_nonneg) for a in n.aggs]
            strings = any(_is_dict_type(getattr(e, "type", None))
                          for _, e in group_by)
            return P.Aggregate(
                rebuild(n.child), group_by, aggs, rewrite(n.having),
                [(nm, rewrite(e)) for nm, e in n.items],
                # local dict-derived dense dims don't survive the
                # shared re-encode: force the hash strategy
                max_groups=0 if strings else n.max_groups,
                group_dims=[] if strings else list(n.group_dims),
                group_lo=[] if strings else list(n.group_lo),
                max_group_rows=0)
        if isinstance(n, P.Window):
            raise DistUnsupported("shuffle: window above join")
        raise DistUnsupported(
            f"shuffle: unsupported node above join: {type(n).__name__}")

    if core is join:
        # bare join at the root: every left output + the declared
        # payload crosses the exchange
        refs_above.update(left_out)
        refs_above.update(join.payload)
    core2 = rebuild(core)
    _check_no_luts(checked)
    if join.join_type != "inner" and rw.pushed_right:
        # NULL-extension would null the pushed column where evaluating
        # the expression over NULL inputs might not be NULL
        raise DistUnsupported(
            "shuffle: string expression over the build side of an "
            "outer join")

    ship_left = sorted((refs_above & set(left_out))
                       | set(join.left_keys))
    pushed_left_names = [n for n, _ in rw.pushed_left]
    pushed_right_names = [n for n, _ in rw.pushed_right]
    ship_right = sorted(((refs_above & set(right_out))
                         | set(join.right_keys))
                        - set(pushed_right_names))
    repl.payload = sorted((set(join.payload) & refs_above)
                          | set(pushed_right_names))
    xl.columns = {n: n for n in ship_left + pushed_left_names}
    xr.columns = {n: n for n in ship_right + pushed_right_names}

    stage0 = Stage(0, _ship_project(join.left, ship_left, types,
                                    rw.pushed_left), [], 0)
    stage1 = Stage(1, _ship_project(join.right, ship_right, types,
                                    rw.pushed_right), [], 1)
    edge0 = Edge(0, list(join.left_keys),
                 ship_left + pushed_left_names,
                 _string_map(ship_left, types))
    edge1 = Edge(1, list(join.right_keys),
                 ship_right + pushed_right_names,
                 _string_map(ship_right, types))

    s2 = split(_rewrap(wrappers, core2))
    stage2 = Stage(2, s2.local, [0, 1], None)
    return ShuffleGraph(
        "join", [stage0, stage1, stage2], {0: edge0, 1: edge1},
        s2.final, s2.union_columns, s2.string_cols, s2.dict_outputs,
        _collect_real_scans(stage0.plan, stage1.plan))


def _decompose_groupby(node: P.PlanNode) -> ShuffleGraph:
    """scan -> per-node partial agg --hash(group keys)--> per-node
    merge agg --gather--> gateway concat (+ sort/limit). Two exchange
    stages; each group is finished on exactly one node, so the gateway
    never re-aggregates (the multi-stage DistAggregation shape,
    aggregator_funcs.go + routers.go)."""
    wrappers, core = _peel(node)
    if not isinstance(core, P.Aggregate) or not core.group_by:
        raise DistUnsupported("shuffle groupby wants a grouped aggregate")
    s = split(node)
    if s.stage != "partial_agg":
        raise DistUnsupported("aggregate is not splittable")
    gnames = [n for n, _ in core.group_by]
    edge0 = Edge(0, gnames, list(s.union_columns), dict(s.string_cols))
    stage0 = Stage(0, s.local, [], 0)

    fwrap, fcore = _peel(s.final)
    assert isinstance(fcore, P.Aggregate)
    merge = copy.copy(fcore)
    merge.child = P.Scan(exch_table(0), exch_table(0),
                         columns={n: n for n in s.union_columns})
    stage1 = Stage(1, merge, [0], None)

    out_names = [n for n, _ in fcore.items]
    # ship-decode source is the union column feeding the output (it,
    # not the output name, appears in the __x0 scan's column set)
    string_out = dict(s.dict_outputs)
    final = _rewrap(fwrap, P.Scan(UNION, UNION,
                                  columns={n: n for n in out_names}))
    return ShuffleGraph(
        "groupby", [stage0, stage1], {0: edge0}, final, out_names,
        string_out, {n: n for n in s.dict_outputs},
        _collect_real_scans(stage0.plan))
