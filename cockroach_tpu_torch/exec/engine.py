"""The query engine: statement dispatch, device upload, result decode.

The counterpart of cockroach_tpu/exec/engine.py, slimmed to what the
ported TPC-H queries need: ``Engine.execute`` runs CREATE TABLE,
ANALYZE, SET and SELECTs over one table or over hash joins. A SELECT
goes parse -> bind/plan (sql/, host) -> join build checks (unique keys,
direct addressing, the expansion factor of duplicate keys) -> selection
compaction -> compile_plan (exec/compile.py) -> one eager run over
device-resident tables -> host decode, where the result's error
sentinels are checked. A top-k cut that crossed a tie replans with the
full sort, an overflowed compaction block replans uncompacted. Tables
upload once per (table, generation), padded to a power of two of at
least 128 rows with never-visible padding rows, and are reused across
statements.

Everything else the reference engine does (DML and transactions,
views, CTEs, subqueries, distribution, streaming and spill, plan
caches) is not ported yet and raises EngineError.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from .. import resolve_device
from ..ops.batch import ColumnBatch, pull_arrays, pull_batch_columns
from ..ops.join import MAX_EXPAND
from ..sql import ast, parser
from ..sql import plan as P
from ..sql.bound import BCol
from ..sql.planner import CatalogView, Planner
from ..sql.types import Family
from ..storage.columnstore import ColumnStore
from ..storage.hlc import Clock, Timestamp
from ..storage.transfer import schema_from_create
from ..utils.num import next_pow2
from .compile import ExecError, ExecParams, RunContext, compile_plan
from .session import (SENTINEL_COLUMNS, CompactOverflow, EngineError,
                      HashCapacityExceeded, Result, Session, TopKInexact)

EPOCH_DATE = datetime.date(1970, 1, 1)
EPOCH_DT = datetime.datetime(1970, 1, 1)

# padding rows are never visible: created at +inf, deleted at 0
_PAD_TS = 2 ** 62
# ANALYZE output goes stale past this row-count drift (the reference's
# sql.stats.stale_row_fraction default)
_STALE_ROW_FRACTION = 0.2

# exception per sentinel column (session.SENTINEL_COLUMNS), checked in
# that order
_SENTINEL_EXCS = {
    "__ht_overflow": lambda: HashCapacityExceeded(
        "GROUP BY cardinality exceeded hash_group_capacity; "
        "SET hash_group_capacity to a larger power of two"),
    "__sum_overflow": lambda: EngineError(
        "decimal SUM overflowed int64 accumulation; "
        "CAST the argument to FLOAT to trade exactness for range"),
    "__topk_inexact": lambda: TopKInexact(
        "top-k cut crossed a primary-key tie group; "
        "replanning with the full sort"),
    "__compact_overflow": lambda: CompactOverflow(
        "selection compaction overflowed a block's capacity; "
        "replanning uncompacted"),
}
_MODES = ("auto", "on", "off")


class Engine:
    def __init__(self, device=None, store: ColumnStore | None = None):
        self.device = resolve_device(device)
        self.store = store or ColumnStore()
        self.clock = Clock()
        # (table, generation) -> (uploaded column set, ColumnBatch)
        self._device_tables: dict[tuple, tuple] = {}
        # the last SELECT's route: Compact nodes in its final plan, the
        # replans it took ("no_topk", "no_compact"), in order, and its
        # last run's RunContext.route
        self.last_exec = {"compact_nodes": 0, "replans": []}

    # -- public API ----------------------------------------------------------
    def session(self) -> Session:
        return Session()

    def execute(self, sql: str, session: Session | None = None) -> Result:
        session = session or self.session()
        stmt = parser.parse(sql)
        if isinstance(stmt, ast.Select):
            return self._exec_select(stmt, session)
        if isinstance(stmt, ast.CreateTable):
            return self._exec_create(stmt)
        if isinstance(stmt, ast.Analyze):
            self.store.analyze(stmt.table)
            return Result(tag="ANALYZE")
        if isinstance(stmt, ast.SetVar) and not stmt.cluster:
            value = stmt.value
            if stmt.name in ("pallas_groupagg", "sort_normalized"):
                value = str(value).lower()
                if value not in _MODES:
                    raise EngineError(
                        f"invalid value for {stmt.name}: {value!r} "
                        "(auto, on or off)")
            elif stmt.name == "hash_group_capacity":
                value = _capacity(value)
            session.vars.set(stmt.name, value)
            return Result(tag="SET")
        raise EngineError(
            f"statement {type(stmt).__name__} is not yet ported")

    # -- DDL -----------------------------------------------------------------
    def _exec_create(self, c: ast.CreateTable) -> Result:
        if c.name in self.store.tables:
            if c.if_not_exists:
                return Result(tag="CREATE TABLE")
            raise EngineError(f"table {c.name!r} already exists")
        if c.foreign_keys or c.checks or c.uniques or any(
                d.unique or d.default is not None for d in c.columns):
            raise EngineError("constraints and column defaults are not "
                              "yet ported")
        schema = schema_from_create(c, self.store.alloc_table_id())
        self.store.create_table(schema)
        return Result(tag="CREATE TABLE")

    # -- planning ------------------------------------------------------------
    def catalog_view(self, read_ts: Timestamp | None = None,
                     sketch: bool = True) -> CatalogView:
        """What the planner sees of the store: schemas, dictionaries,
        table statistics (ANALYZE output while fresh, else write-time
        sketches when ``sketch``) and the store's key probes."""
        from ..sql.stats import TableStats
        schemas = {n: td.schema for n, td in self.store.tables.items()}
        dicts = {n: dict(td.dictionaries)
                 for n, td in self.store.tables.items()}
        stats_map = {}
        for n, td in self.store.tables.items():
            st = None
            if td.stats is not None:
                # ANALYZE output wins while the table hasn't drifted
                # far from the row count it was computed at
                base = max(td.stats.analyzed_rows, 0)
                drifted = abs(td.row_count - base) > \
                    _STALE_ROW_FRACTION * max(base, 1)
                if not (sketch and drifted):
                    st = TableStats(
                        row_count=td.row_count,
                        distinct=dict(td.stats.distinct),
                        null_frac=dict(td.stats.null_frac),
                        analyzed=td.stats_generation == td.generation,
                        source="analyze",
                        analyzed_rows=td.stats.analyzed_rows)
            if st is None and sketch and td.chunks:
                st = self.store.sketch_stats(n)
                st.row_count = td.row_count
            if st is None:
                st = TableStats(row_count=td.row_count)
            stats_map[n] = st
        unique_fn = None
        if read_ts is not None:
            rti = read_ts.to_int()

            def unique_fn(t, cols, _rti=rti):
                return self.store.keys_unique_for_read(t, cols, _rti)
        return CatalogView(schemas, dicts, stats_map,
                           key_distinct_fn=self.store.key_distinct,
                           int_range_fn=self.store.key_int_range,
                           keys_unique_fn=unique_fn)

    def _plan(self, stmt: ast.Select, session: Session,
              read_ts: Timestamp, no_memo: bool = False):
        cv = self.catalog_view(
            read_ts=read_ts,
            sketch=(str(session.vars.get("optimizer_sketch_stats",
                                         "on")).lower()
                    not in ("off", "false")))

        def no_subqueries(sel, lim):
            raise EngineError("subqueries are not yet ported")

        def no_sequences(fn, name, arg):
            raise EngineError("sequences are not yet ported")

        planner = Planner(
            cv, subquery_eval=no_subqueries,
            now_micros=read_ts.wall // 1000,
            sequence_ops=no_sequences,
            use_memo=(not no_memo
                      and session.vars.get("optimizer", "on") != "off"),
            volatile_fold_ok=False,
            rules=session.vars.get("optimizer_rules", "on") != "off")
        return planner.plan_select(stmt)

    def _bound_agg_group_rows(self, node, read_ts: Timestamp) -> None:
        """Attach a static rows-per-group upper bound to Aggregate
        nodes whose group keys trace to stored columns of a scan
        (filters only shrink groups). The bound sizes the i32 limb
        width of exact int64 group sums; 0 = unknown."""

        def spine(n, names):
            while True:
                if isinstance(n, P.Filter):
                    n = n.child
                    continue
                if isinstance(n, P.Project):
                    nxt = []
                    items = dict(n.items)
                    for nm in names:
                        e = items.get(nm)
                        if not isinstance(e, BCol):
                            return None
                        nxt.append(e.name)
                    names = nxt
                    n = n.child
                    continue
                if isinstance(n, P.Scan):
                    stored = []
                    for nm in names:
                        s = n.columns.get(nm)
                        if s is None:
                            return None
                        stored.append(s)
                    return n.table, tuple(stored)
                return None

        def walk(n):
            if isinstance(n, P.Aggregate):
                if n.group_by and n.aggs:
                    names = []
                    for _, e in n.group_by:
                        if not isinstance(e, BCol):
                            names = None
                            break
                        names.append(e.name)
                    hit = spine(n.child, names) if names else None
                    if hit is not None:
                        table, stored = hit
                        k = self.store.key_max_multiplicity(
                            table, stored, read_ts.to_int(),
                            include_null_group=True)
                        if k > 0:
                            n.max_group_rows = k
                self._bound_agg_value_ranges(n)
            for attr in ("child", "left", "right"):
                c = getattr(n, attr, None)
                if c is not None:
                    walk(c)

        walk(node)

    def _bound_agg_value_ranges(self, agg) -> None:
        """Attach stored-column value bounds to plain-column int64 SUM
        aggregates (BoundAgg.arg_max_abs/arg_nonneg): a SUM over a
        proven-non-negative narrow column needs limbs for bits(max)
        only."""
        colmap = {}

        def scans(n):
            if isinstance(n, P.Scan):
                for bname, sname in n.columns.items():
                    colmap[bname] = (n.table, sname)
                return
            for attr in ("child", "left", "right"):
                c = getattr(n, attr, None)
                if c is not None:
                    scans(c)

        scans(agg.child)
        for a in agg.aggs:
            if a.func not in ("sum", "sum_int") \
                    or not isinstance(a.arg, BCol):
                continue
            if a.arg.type.family not in (Family.INT, Family.DECIMAL):
                continue
            hit = colmap.get(a.arg.name)
            if hit is None:
                continue
            rng = self.store.key_int_range(hit[0], hit[1])
            if rng is None:
                continue
            lo, hi, _n = rng
            if lo >= 0 and hi > 0:
                a.arg_nonneg = True
                a.arg_max_abs = int(hi)

    # -- join build checks ---------------------------------------------------
    def _check_join_builds(self, node, read_ts: Timestamp) -> None:
        """The device hash join gathers ONE build row per probe key
        (ops/join.py: exact for unique build keys). Verify build-side
        key uniqueness on the host over the rows visible at the query's
        read timestamp before running, and pick direct addressing where
        the keys allow it. A duplicate-keyed build side sets the join's
        expansion factor K, measured over the visible rows (a static
        bound: ops/join.py then emits K copies per probe row); past
        MAX_JOIN_EXPANSION the join is refused. The port has no
        transactions, so no buffered writes widen the bound."""

        def walk(n):
            if isinstance(n, P.HashJoin):
                if n.join_type in ("inner", "left"):
                    self._check_one_build(n, read_ts)
                walk(n.left)
                walk(n.right)
                return
            c = getattr(n, "child", None)
            if c is not None:
                walk(c)

        walk(node)

    def _check_one_build(self, join, read_ts: Timestamp) -> None:
        from ..sql.stats import _underlying_col
        b = join.right
        if not isinstance(b, P.Scan):
            return
        stored = []
        all_plain = True  # every key is a stored column, not computed
        computed = dict(b.computed)
        for rk in join.right_keys:
            sname = b.columns.get(rk)
            if sname is None:
                all_plain = False
                # computed key: a dictionary-code remap of a column is
                # injective, so check the underlying column instead
                inner = _underlying_col(computed.get(rk))
                if inner is not None:
                    sname = b.columns.get(inner.name)
            if sname is None:
                return  # cannot map back to storage; accept
            stored.append(sname)
        # direct addressing needs the RUNTIME key values' range, so
        # only plain stored keys qualify
        if all_plain:
            self._maybe_direct_join(join, b, stored)
        if self.store.keys_unique_for_read(b.table, tuple(stored),
                                           read_ts.to_int()):
            join.expand = 1
            return
        # measured at table granularity: a pushed build filter can only
        # lower the true multiplicity, so K is a safe upper bound
        k = self.store.key_max_multiplicity(b.table, tuple(stored),
                                            read_ts.to_int())
        if k > self.MAX_JOIN_EXPANSION:
            raise EngineError(
                f"hash join build side {b.table!r} has up to {k} "
                f"duplicate rows per key {stored} (limit "
                f"{self.MAX_JOIN_EXPANSION}); make the lower-"
                "multiplicity table the build side")
        join.expand = max(k, 1)

    # the largest expansion factor a duplicate-keyed build may have
    MAX_JOIN_EXPANSION = MAX_EXPAND
    MAX_DIRECT_JOIN_SLOTS = 1 << 22
    # packed composite keys size the table by the SPAN PRODUCT
    MAX_PACKED_JOIN_SLOTS = 1 << 27

    def _maybe_direct_join(self, join, b, stored) -> None:
        """Direct-address the join when the build key is int-family
        with a dense enough value range (dimension pks, dict codes): one
        scatter + one gather instead of the hash table's rounds. A
        single key sizes the table by its span; composite keys pack
        mixed-radix and size it by the span product."""
        join.direct = None
        ranges = []
        n_all = 0
        for s in stored:
            col = self.store.table(b.table).schema.column(s)
            if col.type.family == Family.FLOAT:
                return
            r = self.store.key_int_range(b.table, s)
            if r is None:
                return
            lo, hi, n_all = r
            ranges.append((lo, hi - lo + 1))
        if len(ranges) == 1:
            lo, span = ranges[0]
            # density is a memory question: a sparse table is still one
            # scatter and one gather
            if span <= max(256 * n_all, 4096) \
                    and span + 1 <= self.MAX_DIRECT_JOIN_SLOTS:
                join.direct = (lo, span + 1)
            return
        total = 1
        for _, span in ranges:
            total *= span
            if total > self.MAX_PACKED_JOIN_SLOTS:
                return
        # payload folding allocates ~one size-length table per carried
        # payload column on top of the slot table: budget all of them
        if total * (2 + len(join.payload)) > 1 << 29:
            return
        if total <= max(2048 * n_all, 4096):
            join.direct = ("packed", tuple(lo for lo, _ in ranges),
                           tuple(span for _, span in ranges))

    # -- selection compaction (compile.compact_batch) ------------------------
    COMPACT_MAX_EST = 1 / 8     # only bother below this selectivity

    def _estimate_scan_selectivity(self, scan) -> float | None:
        """Upper-bound selectivity of a scan's pushed-down filter from
        stored column ranges (uniform within [min, max]) and dictionary
        sizes. Only int-family range/equality conjuncts, dictionary
        predicates and IN-lists contribute; every other conjunct can
        only shrink the true selectivity, so the estimate stays an upper
        bound, safe for sizing capacity."""
        from ..sql.bound import BBin, BConst, BDictLookup, BInList
        pred = scan.filter
        if pred is None:
            return None
        cons: dict[str, list] = {}
        dict_fracs: list[float] = []

        def _dict_len(col: BCol) -> int | None:
            stored = scan.columns.get(col.name)
            if stored is None:
                return None
            d = self.store.table(scan.table).dictionaries.get(stored)
            return len(d.values) if d is not None else None

        def walk(e):
            if isinstance(e, BBin) and e.op == "and":
                walk(e.left)
                walk(e.right)
                return
            if isinstance(e, BDictLookup) and isinstance(e.expr, BCol):
                # precomputed dictionary predicate (LIKE, ordered string
                # compare): the bool table's mean IS the fraction of
                # distinct values matching
                tbl = np.asarray(e.table)
                if tbl.size:
                    dict_fracs.append(float(tbl.mean()))
                return
            if isinstance(e, BInList) and isinstance(e.expr, BCol) \
                    and e.expr.type.uses_dictionary and not e.negated:
                n = _dict_len(e.expr)
                if n:
                    dict_fracs.append(min(1.0, len(e.values) / n))
                return
            if isinstance(e, BInList) and isinstance(e.expr, BCol) \
                    and not e.negated \
                    and e.expr.type.family in (Family.INT, Family.DATE):
                # near-unique values assumed: not a hard bound for
                # duplicate keys, but Compact's sentinel replans if it
                # undershoots
                stored = scan.columns.get(e.expr.name)
                if stored is not None:
                    r = self.store.key_int_range(scan.table, stored)
                    if r is not None and r[2] > 0:
                        dict_fracs.append(min(1.0, len(e.values) / r[2]))
                return
            if isinstance(e, BBin) and e.op in ("<", "<=", ">", ">=", "="):
                left, right, op = e.left, e.right, e.op
                if isinstance(left, BConst) and isinstance(right, BCol):
                    left, right = right, left
                    op = {"<": ">", "<=": ">=", ">": "<",
                          ">=": "<="}.get(op, op)
                if not (isinstance(left, BCol) and isinstance(right, BConst)
                        and isinstance(right.value, int)
                        and not isinstance(right.value, bool)):
                    return
                if op == "=" and left.type.uses_dictionary:
                    # dict-code equality: 1/ndv with the dictionary
                    # length as the distinct count
                    n = _dict_len(left)
                    if n:
                        dict_fracs.append(1.0 / n)
                    return
                cons.setdefault(left.name, []).append((op, right.value))
        walk(pred)
        if not cons and not dict_fracs:
            return None
        est = 1.0
        for f in dict_fracs:
            est *= f
        got = bool(dict_fracs)
        for bname, cs in cons.items():
            stored = scan.columns.get(bname)
            if stored is None:
                continue
            r = self.store.key_int_range(scan.table, stored)
            if r is None:
                continue
            lo_c, hi_c, _n = r
            lo, hi = lo_c, hi_c
            for op, v in cs:
                if op == ">=":
                    lo = max(lo, v)
                elif op == ">":
                    lo = max(lo, v + 1)
                elif op == "<=":
                    hi = min(hi, v)
                elif op == "<":
                    hi = min(hi, v - 1)
                else:           # =
                    lo, hi = max(lo, v), min(hi, v)
            width = hi_c - lo_c + 1
            if width <= 0:
                continue
            est *= max(0, hi - lo + 1) / width
            got = True
        return est if got else None

    def _compact_frac(self, est: float) -> float:
        # 4x headroom over the uniform estimate absorbs moderate
        # per-block skew; worse skew trips the sentinel and the engine
        # replans uncompacted
        return min(0.25, max(est * 4, 1 / 256))

    def _insert_compaction(self, node):
        """Wrap the DEEPEST point of a probe spine under aggregation
        where the estimated surviving fraction drops to <= 1/8 in a
        Compact node (compile.compact_batch): everything above (join
        probe gathers, CASE math, grouped scatters) then runs at a
        fraction of the batch width.

        Selectivity accumulates up the spine: a scan's pushed filter or
        an INNER join against a filtered build side both shrink the
        selected set, so the wrap point may be a Scan or a mid-spine
        HashJoin. A scan feeding aggregation with no join stays masked
        (the fused filter and aggregate are already one pass). Wraps
        above the last join also require a scatter-strategy aggregate
        (hash, or dense past 64 groups). An expanding join (duplicate
        build keys) bounds the wrap point: the spine below it still
        compacts, so its K-way copy runs over the packed width. Project
        and Window stop the walk."""

        def build_sel(jn) -> float:
            if jn.join_type != "inner":
                return 1.0
            if isinstance(jn.right, P.Scan):
                e = self._estimate_scan_selectivity(jn.right)
                return e if e is not None else 1.0
            return 1.0

        # returns (node, est, wrapped_below, joins_below)
        def spine(n, joins_above, agg_scatters):
            if isinstance(n, P.Filter):
                c, est, wrapped, jb = spine(n.child, joins_above,
                                            agg_scatters)
                n.child = c
                return n, est, wrapped, jb
            if isinstance(n, P.Scan):
                est = self._estimate_scan_selectivity(n)
                est = est if est is not None else 1.0
                if est <= self.COMPACT_MAX_EST and joins_above > 0:
                    return (P.Compact(n, frac=self._compact_frac(est)),
                            est, True, 0)
                return n, est, False, 0
            if isinstance(n, P.HashJoin):
                if n.expand != 1:
                    # the expanded output breaks the estimate for wraps
                    # at or above this node; report wrapped so nothing
                    # above compacts it
                    c, _, _, jb = spine(n.left, joins_above + 1,
                                        agg_scatters)
                    n.left = c
                    return n, 1.0, True, jb + 1
                c, left_est, wrapped, jb = spine(n.left, joins_above + 1,
                                                 agg_scatters)
                n.left = c
                est = left_est * build_sel(n)
                if not wrapped and est <= self.COMPACT_MAX_EST \
                        and (joins_above > 0 or agg_scatters):
                    return (P.Compact(n, frac=self._compact_frac(est)),
                            est, True, jb + 1)
                return n, est, wrapped, jb + 1
            return n, 1.0, False, 0

        def walk(n):
            if isinstance(n, P.Aggregate):
                dense = n.max_groups > 0
                scatters = bool(n.group_by) and \
                    (not dense or n.max_groups > 64)
                n.child = spine(n.child, 0, scatters)[0]
                return n
            if isinstance(n, P.Project):
                # compile bubbles the sentinel through Project
                n.child = spine(n.child, 0, True)[0]
                return n
            if isinstance(n, (P.Sort, P.Limit)):
                n.child = walk(n.child)
                return n
            return n
        return self._defer_payloads_past_compact(walk(node))

    def _defer_payloads_past_compact(self, root):
        """Payload pull-up: for every direct inner join BELOW a Compact,
        defer the payload columns no node between the join and the
        Compact consumes to a re-probe join ABOVE the Compact:

            join(match [+ used/packed payloads]) -> Compact
              -> join(deferred payloads)

        Each deferred payload gather then touches the compacted rows
        only. The build side is scanned twice; its tables are small.
        Packed (dictionary-code/bool) payloads stay below: they cost one
        fused gather already."""
        from ..sql.bound import referenced_columns

        def pull_up(compact):
            used: set[str] = set()
            deferred: list = []

            def descend(n):
                if isinstance(n, P.Filter):
                    used.update(referenced_columns(n.pred))
                    n.child = descend(n.child)
                    return n
                if isinstance(n, P.HashJoin):
                    used.update(n.left_keys)
                    used.update(n.right_keys)
                    if n.join_type == "inner" and n.expand == 1 \
                            and n.direct is not None:
                        packed = set(n.pack_payload or ())
                        defer = [p for p in n.payload
                                 if p not in packed and p not in used]
                        if defer:
                            n.payload = [p for p in n.payload
                                         if p not in defer]
                            deferred.append(P.HashJoin(
                                left=None, right=n.right,
                                left_keys=list(n.left_keys),
                                right_keys=list(n.right_keys),
                                payload=defer, join_type="inner",
                                expand=1, direct=n.direct,
                                pack_payload=[]))
                    used.update(n.payload)
                    n.left = descend(n.left)
                    return n
                return n

            compact.child = descend(compact.child)
            top = compact
            for dj in deferred:
                dj.left = top
                top = dj
            return top

        def walk(n):
            for attr in ("child", "left", "right"):
                c = getattr(n, attr, None)
                if c is not None:
                    setattr(n, attr, walk(c))
            if isinstance(n, P.Compact):
                return pull_up(n)
            return n

        return walk(root)

    # -- SELECT --------------------------------------------------------------
    def _exec_select(self, sel: ast.Select, session: Session) -> Result:
        """Run one SELECT, replanning as the reference's Prepared.run
        does: a top-k cut that crossed a tie runs again with the full
        sort, an overflowed compaction block runs again uncompacted
        (each flag, once set, stays set, so at most two replans). A
        hash table that overflowed reaches the caller: the reference's
        partitioned re-execution waits for the spill path."""
        if sel.ctes or sel.table is None \
                or getattr(sel, "as_of", None) is not None:
            raise EngineError("CTEs, table-free SELECTs and AS OF SYSTEM "
                              "TIME are not yet ported")
        flags = {"no_topk": False, "no_compact": False}
        self.last_exec = {"compact_nodes": 0, "replans": []}
        while True:
            try:
                return self._run_select(sel, session, **flags)
            except TopKInexact:
                if flags["no_topk"]:
                    raise
                flags["no_topk"] = True
                self.last_exec["replans"].append("no_topk")
            except CompactOverflow:
                if flags["no_compact"]:
                    raise
                flags["no_compact"] = True
                self.last_exec["replans"].append("no_compact")

    def _run_select(self, sel: ast.Select, session: Session,
                    no_topk: bool = False, no_compact: bool = False,
                    no_memo: bool = False) -> Result:
        read_ts = self.clock.now()
        node, meta = self._plan(sel, session, read_ts, no_memo=no_memo)
        try:
            self._check_join_builds(node, read_ts)
        except EngineError:
            # the memo's join order may have put the duplicate-heavy
            # side on the build side: the greedy order may not
            if meta.memo is not None and not no_memo:
                return self._run_select(sel, session, no_topk=no_topk,
                                        no_compact=no_compact,
                                        no_memo=True)
            raise
        self._bound_agg_group_rows(node, read_ts)
        if not no_compact:
            node = self._insert_compaction(node)
        self.last_exec["compact_nodes"] = _count_nodes(node, P.Compact)
        scans = {}
        for alias, tname, cols in _collect_scans(node):
            scans[alias] = self._device_table(tname, cols)
        sortn = str(session.vars.get("sort_normalized", "auto")).lower()
        params = ExecParams(
            pallas_groupagg=str(session.vars.get("pallas_groupagg",
                                                 "auto")).lower(),
            hash_group_capacity=_capacity(
                session.vars.get("hash_group_capacity", 1 << 17)),
            topk_sort=not no_topk,
            sort_normalized=sortn if sortn in _MODES else "off")
        try:
            runf = compile_plan(node, params, meta)
        except ExecError as e:
            raise EngineError(str(e)) from e
        rc = RunContext(scans, read_ts.to_int())
        out = runf(rc)
        self.last_exec.update(rc.route)
        return self._materialize(out, meta)

    # -- device upload -------------------------------------------------------
    def _device_table(self, name: str, cols: frozenset) -> ColumnBatch:
        """Resident device copy of ``name`` holding at least ``cols``:
        cached per table generation, or uploaded now."""
        td = self.store.table(name)
        key = (name, td.generation)
        hit = self._device_tables.get(key)
        if hit is not None and cols <= hit[0]:
            return hit[1]
        for k in [k for k in self._device_tables if k[0] == name]:
            del self._device_tables[k]
        if hit is not None:
            cols = cols | hit[0]
        b = self._device_upload(td, cols)
        self._device_tables[key] = (cols, b)
        return b

    def _device_upload(self, td, cols: frozenset) -> ColumnBatch:
        """Concatenate chunks, pad to a power-of-two row count of at
        least 128 (sel False, MVCC never-visible), and copy to the
        device with the MVCC columns. torch.tensor copies, so the
        device batch never aliases the store's arrays."""
        chunks = td.chunks
        n = sum(c.n for c in chunks)
        padded = next_pow2(max(n, 128))
        data, valid = {}, {}
        for col in td.schema.columns:
            cn = col.name
            if cn not in cols:
                continue
            arr = (np.concatenate([c.data[cn] for c in chunks]) if chunks
                   else np.zeros(0, dtype=col.type.np_dtype))
            va = (np.concatenate([c.valid[cn] for c in chunks]) if chunks
                  else np.zeros(0, bool))
            data[cn] = _pad(arr, padded)
            valid[cn] = _pad(va, padded)
        mts = (np.concatenate([c.mvcc_ts for c in chunks]) if chunks
               else np.zeros(0, np.int64))
        mdl = (np.concatenate([c.mvcc_del for c in chunks]) if chunks
               else np.zeros(0, np.int64))
        data["_mvcc_ts"] = _pad(mts, padded, fill=_PAD_TS)
        data["_mvcc_del"] = _pad(mdl, padded, fill=0)
        dev = self.device
        sel = torch.zeros(padded, dtype=torch.bool, device=dev)
        sel[:n] = True
        return ColumnBatch.from_dict(
            {k: torch.tensor(v, device=dev) for k, v in data.items()},
            {k: torch.tensor(v, device=dev) for k, v in valid.items()},
            sel=sel)

    # -- result materialization ---------------------------------------------
    def _materialize(self, out: ColumnBatch, meta: P.OutputMeta) -> Result:
        """Decode a device result batch into host rows. The sentinel
        flags reduce to scalars on the device and come over in one pull,
        before the rows: a set flag raises its exception."""
        sent = [n for n in SENTINEL_COLUMNS if out.has(n)]
        if sent:
            flags = pull_arrays([torch.stack([torch.any(out.col(n))
                                              for n in sent])])[0]
            for name, f in zip(sent, flags):
                if bool(f):
                    raise _SENTINEL_EXCS[name]()
        names = list(meta.names)
        pulled = pull_batch_columns(out, names)
        res = Result(names=names, types=list(meta.types))
        cols = []
        for name, ty in zip(names, meta.types):
            d, v = pulled[name]
            cols.append(_decode_column(d, v, ty,
                                       meta.dictionaries.get(name)))
        res.rows = list(zip(*cols)) if cols else []
        return res


def _collect_scans(node) -> list[tuple[str, str, frozenset]]:
    """(alias, table, stored columns read) of every scan in the plan."""
    if isinstance(node, P.Scan):
        return [(node.alias, node.table, frozenset(node.columns.values()))]
    out = []
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            out.extend(_collect_scans(c))
    return out


def _count_nodes(node, cls) -> int:
    n = int(isinstance(node, cls))
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            n += _count_nodes(c, cls)
    return n


def _capacity(value) -> int:
    """hash_group_capacity as a positive power of two, or EngineError."""
    try:
        cap = int(value)
    except (TypeError, ValueError):
        cap = 0
    if cap <= 0 or cap & (cap - 1):
        raise EngineError(f"invalid value for hash_group_capacity: "
                          f"{value!r} (a positive power of two)")
    return cap


def _pad(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full(n, fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _decode_scalar(v, valid: bool, ty, dictionary):
    if not valid:
        return None
    f = ty.family
    if f == Family.DECIMAL:
        return float(v) / 10 ** ty.scale
    if f == Family.DATE:
        return EPOCH_DATE + datetime.timedelta(days=int(v))
    if f == Family.TIMESTAMP:
        return EPOCH_DT + datetime.timedelta(microseconds=int(v))
    if f == Family.STRING:
        if dictionary is not None:
            return dictionary.values[int(v)]
        return int(v)
    if f == Family.BOOL:
        return bool(v)
    if f == Family.INT:
        return int(v)
    if f == Family.FLOAT:
        return float(v)
    return v.item() if hasattr(v, "item") else v


def _decode_column(data: np.ndarray, valid: np.ndarray, ty,
                   dictionary) -> list:
    return [_decode_scalar(d, bool(m), ty, dictionary)
            for d, m in zip(data, valid)]
