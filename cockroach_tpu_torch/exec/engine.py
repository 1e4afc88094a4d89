"""The query engine: statement dispatch, device upload, result decode.

The counterpart of cockroach_tpu/exec/engine.py, slimmed to what TPC-H
Q1, Q6 and Q14 need: ``Engine.execute`` runs CREATE TABLE, ANALYZE, SET
and SELECTs over one table or over hash joins with unique build keys.
A SELECT goes parse -> bind/plan (sql/, host) -> join build checks ->
compile_plan (exec/compile.py) -> one eager run over device-resident
tables -> host decode. Tables upload once per (table, generation),
padded to a power of two of at least 128 rows with never-visible
padding rows, and are reused across statements.

Everything else the reference engine does (DML and transactions,
joins with duplicate build keys, selection compaction, views, CTEs,
subqueries, distribution, streaming and spill, plan caches) is not
ported yet and raises EngineError.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from .. import resolve_device
from ..ops.batch import ColumnBatch, pull_arrays, pull_batch_columns
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
from .session import EngineError, Result, Session

EPOCH_DATE = datetime.date(1970, 1, 1)
EPOCH_DT = datetime.datetime(1970, 1, 1)

# padding rows are never visible: created at +inf, deleted at 0
_PAD_TS = 2 ** 62
# ANALYZE output goes stale past this row-count drift (the reference's
# sql.stats.stale_row_fraction default)
_STALE_ROW_FRACTION = 0.2


class Engine:
    def __init__(self, device=None, store: ColumnStore | None = None):
        self.device = resolve_device(device)
        self.store = store or ColumnStore()
        self.clock = Clock()
        # (table, generation) -> (uploaded column set, ColumnBatch)
        self._device_tables: dict[tuple, tuple] = {}

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
            if stmt.name == "pallas_groupagg":
                value = str(value).lower()
                if value not in ("auto", "on", "off"):
                    raise EngineError(
                        f"invalid value for pallas_groupagg: {value!r} "
                        "(auto, on or off)")
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
              read_ts: Timestamp):
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
            use_memo=session.vars.get("optimizer", "on") != "off",
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
        expansion factor, which the plan compiler refuses cleanly (row
        expansion is not ported yet): never a silently dropped match.
        The port has no transactions, so no buffered writes widen the
        bound."""

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
        k = self.store.key_max_multiplicity(b.table, tuple(stored),
                                            read_ts.to_int())
        join.expand = max(k, 1)

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

    # -- SELECT --------------------------------------------------------------
    def _exec_select(self, sel: ast.Select, session: Session) -> Result:
        if sel.ctes or sel.table is None \
                or getattr(sel, "as_of", None) is not None:
            raise EngineError("CTEs, table-free SELECTs and AS OF SYSTEM "
                              "TIME are not yet ported")
        read_ts = self.clock.now()
        node, meta = self._plan(sel, session, read_ts)
        self._check_join_builds(node, read_ts)
        self._bound_agg_group_rows(node, read_ts)
        scans = {}
        for alias, tname, cols in _collect_scans(node):
            scans[alias] = self._device_table(tname, cols)
        params = ExecParams(
            pallas_groupagg=str(session.vars.get("pallas_groupagg",
                                                 "auto")).lower())
        try:
            runf = compile_plan(node, params, meta)
        except ExecError as e:
            raise EngineError(str(e)) from e
        out = runf(RunContext(scans, read_ts.to_int()))
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
        """Decode a device result batch into host rows."""
        if out.has("__sum_overflow"):
            flag, = pull_arrays([torch.any(out.col("__sum_overflow"))])
            if bool(flag):
                raise EngineError(
                    "decimal SUM overflowed int64 accumulation; "
                    "CAST the argument to FLOAT to trade exactness for "
                    "range")
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
