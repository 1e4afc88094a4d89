"""DDL: CREATE TABLE (with DEFAULT, UNIQUE, CHECK and REFERENCES), DROP
TABLE, TRUNCATE, CREATE/DROP INDEX, CREATE/DROP VIEW and CREATE/DROP
SEQUENCE.

The port of cockroach_tpu/exec/ddl.py: a table's descriptor is written
to the catalog (catalog/, a transactional record in the KV plane) before
its columnstore table is created. A view is a descriptor carrying SQL
text, re-planned at every use (``_expand_views``); a sequence is a KV
record.

Secondary indexes (the reference's pkg/sql/rowenc encodings kept by the
row writers): the scan plane is columnar and the analytic path never
decodes keys, so a non-unique index is a host-side locator the store
derives from its chunks (generation-cached,
storage/columnstore.py ensure_secondary_index) for point reads and DML.
A UNIQUE index also keeps KV entries at /Table/<tid>/<index_id>/<vals>
-> pk key, written inside each DML txn, so two writers of one value
conflict in the KV plane (the guarantee the reference gets from a CPut
on the index key). CREATE INDEX is an online schema change: the index
is published WRITE_ONLY (writers maintain it), then a durable job
backfills and validates it and publishes it PUBLIC
(jobs/schemachange.py). UNIQUE column and table constraints of CREATE
TABLE are unique indexes at birth: the table is empty, so they are
PUBLIC at once.
"""

from __future__ import annotations

import copy
import json

from ..catalog import CatalogError, IndexDescriptor, TableDescriptor
from ..catalog.descriptor import WRITE_ONLY
from ..jobs.schemachange import INDEX_BACKFILL_JOB
from ..sql import ast, parser
from ..sql.binder import Binder, Scope
from ..sql.bound import BConst
from ..sql.rowenc import ROWID
from ..sql.types import ColumnSchema, Family, TableSchema
from ..storage import keys as K
from .session import EngineError, Result
from .stmtutil import collect_tables


class DDLMixin:
    """Engine methods of the DDL this package runs; mixed into
    exec.engine.Engine (all state lives on the Engine instance)."""

    @staticmethod
    def _eval_column_default(d: ast.ColumnDef):
        """DEFAULT expr -> physical constant, or {"__seq__": name} for
        nextval('name'), drawn per row at INSERT (pg stores the
        expression; the constant and sequence shapes are supported)."""
        if d.default is None:
            return None
        e = d.default
        if isinstance(e, ast.FuncCall) and e.name == "nextval" \
                and len(e.args) == 1 and isinstance(e.args[0], ast.Literal):
            return {"__seq__": str(e.args[0].value)}
        binder = Binder(Scope())
        try:
            b = binder.bind(e)
        except Exception as ex:
            raise EngineError(f"unsupported DEFAULT for column "
                              f"{d.name!r}: {ex}") from ex
        if not isinstance(b, BConst):
            raise EngineError(
                f"DEFAULT for column {d.name!r} must be a constant "
                f"or nextval(...)")
        if b.value is None:
            return None
        return binder._const_to(b, d.type).value

    def _exec_create(self, c: ast.CreateTable) -> Result:
        if c.name in self.store.tables or c.name in self._view_map():
            if c.if_not_exists:
                return Result(tag="CREATE TABLE")
            raise EngineError(f"table {c.name!r} already exists")
        schema = TableSchema(
            name=c.name,
            columns=[ColumnSchema(d.name, d.type, d.nullable,
                                  default=self._eval_column_default(d))
                     for d in c.columns],
            primary_key=list(c.primary_key))
        colnames = {d.name for d in c.columns}
        uniq_sets = [[d.name] for d in c.columns if d.unique] \
            + [list(u) for u in c.uniques]
        # FK references resolve now: the target must exist and the
        # referenced columns must be its primary key or a unique index
        fk_records = []
        for fkname, lcols, rt, rcols in c.foreign_keys:
            for cn in lcols:
                if cn not in colnames:
                    raise EngineError(f"fk column {cn!r} not in table")
            if rt == c.name:
                # self-referential: validate against the in-flight
                # definition (the table does not exist yet)
                rcols = rcols or list(c.primary_key)
                unique_sets = [tuple(c.primary_key)] + \
                    [tuple(u) for u in uniq_sets]
            elif rt in self.store.tables:
                rschema = self.store.table(rt).schema
                rcols = rcols or list(rschema.primary_key)
                unique_sets = [tuple(rschema.primary_key)] + [
                    tuple(i.columns) for i in self._table_indexes(rt)
                    if i.unique]
            else:
                raise EngineError(
                    f"referenced table {rt!r} does not exist")
            if tuple(rcols) not in unique_sets:
                raise EngineError(
                    f"foreign key must reference a primary key or "
                    f"unique index of {rt!r} (got {rcols})")
            if len(rcols) != len(lcols):
                raise EngineError("foreign key column count mismatch")
            fk_records.append({"name": fkname, "columns": list(lcols),
                               "ref_table": rt,
                               "ref_columns": list(rcols)})
        for u in uniq_sets:
            for cn in u:
                if cn not in colnames:
                    raise EngineError(f"unique column {cn!r} not in table")
        desc0 = TableDescriptor.from_schema(schema)
        desc0.checks = [{"name": n, "expr_sql": text}
                        for n, _e, text in c.checks]
        desc0.fks = fk_records
        desc0.indexes = [
            IndexDescriptor(f"{c.name}_{'_'.join(u)}_key", 2 + i, list(u),
                            True, "public")
            for i, u in enumerate(uniq_sets)]
        # the descriptor (the system of record) is written first,
        # transactionally; the columnstore table is the scan-plane
        # materialization keyed by the allocated descriptor id
        try:
            desc = self.catalog.create_table(desc0)
        except CatalogError as e:
            if c.if_not_exists:
                return Result(tag="CREATE TABLE")
            raise EngineError(str(e)) from e
        schema.table_id = desc.id
        # the allocated stable column ids tag the row codec's values
        by_name = {cd.name: cd.col_id for cd in desc.columns}
        for cs in schema.columns:
            cs.cid = by_name.get(cs.name, 0)
        self.store.create_table(schema)
        self._index_defs.pop(c.name, None)
        self._constraint_defs.pop(c.name, None)
        self._fk_children = None
        # CHECK expressions must bind against the new schema (unknown
        # columns and type errors surface at DDL time)
        try:
            scope, _ = self._dml_scope(c.name)
            for n, e, _text in c.checks:
                b = Binder(scope).bind(e)
                if b.type.family != Family.BOOL:
                    raise EngineError(
                        f"check constraint {n!r} must be boolean")
        except Exception:
            self.store.drop_table(c.name)
            self.catalog.drop_table(c.name)
            self._fk_children = None
            raise
        return Result(tag="CREATE TABLE")

    def _check_no_open_txn_effects(self, table: str, verb: str) -> None:
        """Non-transactional DDL (TRUNCATE/DROP) against open txns: a
        txn holding buffered effects on the table would resurrect rows
        when it commits after the DDL ran."""
        with self._sessions_lock:
            sessions = list(self._open_sessions)
        for s in sessions:
            if s.txn is not None and any(
                    eff[0] == table for eff in s.effects):
                raise EngineError(
                    f"cannot {verb} {table!r}: an open "
                    f"transaction has pending writes on it")

    def _exec_drop(self, d: ast.DropTable) -> Result:
        if d.name in self._view_map():
            raise EngineError(f"{d.name!r} is a view; use DROP VIEW")
        deps = self._view_dependents(d.name)
        if deps:
            raise EngineError(f"cannot drop table {d.name!r}: view(s) "
                              f"{deps} depend on it")
        fk_deps = sorted({child for child, _fk in
                          self._fk_children_of(d.name)
                          if child != d.name})
        if fk_deps:
            raise EngineError(
                f"cannot drop table {d.name!r}: foreign key(s) on "
                f"{fk_deps} reference it")
        if d.name not in self.store.tables:
            if d.if_exists:
                return Result(tag="DROP TABLE")
            raise EngineError(f"table {d.name!r} does not exist")
        self._check_no_open_txn_effects(d.name, "DROP TABLE")
        try:
            self.catalog.drop_table(d.name)
        except CatalogError:
            pass  # a store-only table (carried in, never CREATEd)
        self.store.drop_table(d.name)
        self._index_defs.pop(d.name, None)
        self._constraint_defs.pop(d.name, None)
        self._fk_children = None
        self._evict_device(d.name)
        return Result(tag="DROP TABLE")

    def _exec_truncate(self, tr: ast.Truncate) -> Result:
        """Clear all rows and KV pairs, keep the schema."""
        if tr.table not in self.store.tables:
            raise EngineError(f"table {tr.table!r} does not exist")
        fk_deps = sorted({child for child, _fk in
                          self._fk_children_of(tr.table)
                          if child != tr.table})
        if fk_deps:
            raise EngineError(
                f"cannot truncate {tr.table!r}: foreign key(s) on "
                f"{fk_deps} reference it")
        # TRUNCATE rebuilds the store table outside any txn: refuse
        # while open txns hold effects on the table
        self._check_no_open_txn_effects(tr.table, "TRUNCATE")
        schema = self.store.table(tr.table).schema
        base = bytearray(K.TABLE_PREFIX)
        K.encode_int(base, schema.table_id)
        base = bytes(base)
        self.kv.txn(lambda t: t.delete_range(base, K.prefix_end(base)))
        self.store.drop_table(tr.table)
        self.store.create_table(schema)
        self._evict_device(tr.table)
        return Result(tag="TRUNCATE")

    # -- secondary indexes ----------------------------------------------------
    def _table_indexes(self, table: str) -> list:
        """The table's index descriptors (every state), cached until a
        schema change drops the entry. A catalog error fails the
        statement rather than caching "no indexes", which would drop
        unique enforcement in silence; a table with no descriptor (one
        carried into the store) has none."""
        cached = self._index_defs.get(table)
        if cached is not None:
            return cached
        d = self.catalog.get_by_name(table)
        idxs = list(d.indexes) if d is not None else []
        self._index_defs[table] = idxs
        return idxs

    def _exec_create_index(self, c: ast.CreateIndex) -> Result:
        if c.table not in self.store.tables:
            raise EngineError(f"table {c.table!r} does not exist")
        td = self.store.table(c.table)
        for cn in c.columns:
            try:
                td.schema.column(cn)
            except KeyError:
                raise EngineError(
                    f"column {cn!r} does not exist in {c.table!r}")
        desc = self.catalog.get_by_name(c.table)
        if desc is None:
            raise EngineError(
                f"table {c.table!r} has no descriptor (pre-catalog)")
        if c.name == "primary":
            raise EngineError(
                "index name 'primary' is reserved for the primary key")
        if any(i.name == c.name for i in desc.indexes):
            if c.if_not_exists:
                return Result(tag="CREATE INDEX")
            raise EngineError(
                f"index {c.name!r} already exists on {c.table!r}")
        next_id = 1 + max([i.index_id for i in desc.indexes],
                          default=1)  # the primary index is 1
        # WRITE_ONLY: after the lease drain every writer maintains the
        # index; readers do not use it yet
        desc.indexes.append(IndexDescriptor(
            c.name, next_id, list(c.columns), c.unique, WRITE_ONLY))
        self.leases.publish(desc)
        self._index_defs.pop(c.table, None)
        # the checkpointed backfill, the validation and the PUBLIC
        # publish run as a durable job (resumable after a crash)
        job_id = self.jobs.create(INDEX_BACKFILL_JOB,
                                  {"table": c.table, "index": c.name})
        rec = self.jobs.run_job(job_id)
        self._index_defs.pop(c.table, None)
        if rec.status != "succeeded":
            raise EngineError(
                f"CREATE INDEX failed: {rec.error or rec.status}")
        return Result(tag="CREATE INDEX")

    def _exec_drop_index(self, d_stmt: ast.DropIndex) -> Result:
        found = [(desc, i) for desc in self.catalog.list_tables()
                 for i in desc.indexes if i.name == d_stmt.name]
        if not found:
            if d_stmt.if_exists:
                return Result(tag="DROP INDEX")
            raise EngineError(f"index {d_stmt.name!r} does not exist")
        if len(found) > 1:
            tables = sorted(d.name for d, _ in found)
            raise EngineError(
                f"index name {d_stmt.name!r} is ambiguous (exists on "
                f"tables {tables}); drop and recreate with distinct "
                f"names")
        desc, idx = found[0]
        desc.indexes = [i for i in desc.indexes if i.name != idx.name]
        self.leases.publish(desc)
        self._index_defs.pop(desc.name, None)
        if idx.unique:
            # the index keyspace goes at once (the reference's is a
            # GC-TTL'd schema-change job)
            p = K.table_prefix(desc.id, idx.index_id)
            self.kv.txn(lambda t: t.delete_range(p, K.prefix_end(p)))
        return Result(tag="DROP INDEX")

    def _exec_show_indexes(self, stmt: ast.ShowIndexes) -> Result:
        d = self.catalog.get_by_name(stmt.table)
        if d is None:
            raise EngineError(f"table {stmt.table!r} does not exist")
        rows = [(stmt.table, "primary",
                 ", ".join(d.primary_key) or ROWID, True, "public")]
        rows += [(stmt.table, i.name, ", ".join(i.columns), i.unique,
                  i.state) for i in d.indexes]
        return Result(names=["table_name", "index_name", "columns",
                             "unique", "state"],
                      rows=rows, tag="SHOW INDEXES")

    # -- views ----------------------------------------------------------------
    # A view is a descriptor carrying SQL text; every use re-plans it
    # (pkg/sql/create_view.go + the optimizer's view expansion).

    def _view_map(self) -> dict:
        views = self._view_defs
        if views is None:
            views = {d.name: d for d in self.catalog.list_tables()
                     if d.view_sql}
            self._view_defs = views
        return views

    def _view_dependents(self, name: str) -> list:
        """The views whose bodies name ``name``."""
        return sorted(v for v, vd in self._view_map().items()
                      if v != name and name in _table_refs(vd.view_sql))

    def _expand_views(self, sel: ast.Select) -> ast.Select:
        """Every view the statement names (in FROM and JOIN, in
        subqueries, in CTE bodies) becomes a CTE of the statement, ahead
        of its own CTEs and after the views it reads: the temp path
        then materializes each view once per statement, however often
        the statement names it, and rewrites every reference. A CTE of
        the statement with the same name shadows the view."""
        views = self._view_map()
        if not views:
            return sel
        shadow = {name for name, _c, _s in sel.ctes}
        refs: set = set()
        collect_tables(sel, refs)
        wanted = sorted((refs & views.keys()) - shadow)
        if not wanted:
            return sel
        ctes: list = []
        done: set = set()

        def add(name: str, depth: int) -> None:
            if name in done:
                return
            if depth > 16:
                raise EngineError("view nesting too deep (cycle?)")
            d = views[name]
            body = parser.parse(d.view_sql)
            if not isinstance(body, ast.Select):
                raise EngineError(
                    f"view {d.name!r} body is not a plain SELECT")
            inner: set = set()
            collect_tables(body, inner)
            for dep in sorted(inner & views.keys()):
                add(dep, depth + 1)
            ctes.append((name, list(d.view_columns) or None, body))
            done.add(name)

        for name in wanted:
            add(name, 0)
        sel = copy.copy(sel)
        sel.ctes = ctes + list(sel.ctes)
        return sel

    def _exec_create_view(self, c: ast.CreateView, session) -> Result:
        if c.name in self.store.tables or c.name in self._view_map():
            if c.if_not_exists:
                return Result(tag="CREATE VIEW")
            raise EngineError(f"relation {c.name!r} already exists")
        if not isinstance(c.select, ast.Select):
            raise EngineError("CREATE VIEW body must be a plain SELECT")
        if c.columns is not None and any(it.star for it in c.select.items):
            raise EngineError(
                "view column list requires explicit select items")
        # validate by running the body with LIMIT 0: unknown tables,
        # columns and type errors surface at DDL time
        probe = copy.deepcopy(c.select)
        probe.limit = 0
        with self._statement():
            res = self._exec_select(probe, session,
                                    f"(create-view {c.name})")
        if c.columns is not None and len(c.columns) != len(res.names):
            raise EngineError(
                f"view column list has {len(c.columns)} names, SELECT "
                f"produces {len(res.names)}")
        try:
            self.catalog.create_table(TableDescriptor(
                id=0, name=c.name, view_sql=c.sql,
                view_columns=list(c.columns or [])))
        except CatalogError as e:
            raise EngineError(str(e)) from e
        self._view_defs = None
        return Result(tag="CREATE VIEW")

    def _exec_drop_view(self, d: ast.DropView) -> Result:
        if d.name not in self._view_map():
            if d.if_exists:
                return Result(tag="DROP VIEW")
            raise EngineError(f"view {d.name!r} does not exist")
        deps = self._view_dependents(d.name)
        if deps:
            raise EngineError(f"cannot drop view {d.name!r}: view(s) "
                              f"{deps} depend on it")
        self.catalog.drop_table(d.name)
        self._view_defs = None
        return Result(tag="DROP VIEW")

    # -- sequences --------------------------------------------------------------
    def _exec_create_sequence(self, c: ast.CreateSequence) -> Result:
        key = self.SEQ_PREFIX + c.name.encode()

        def fn(t):
            if t.get(key) is not None:
                if c.if_not_exists:
                    return
                raise EngineError(f"sequence {c.name!r} already exists")
            t.put(key, json.dumps({"start": c.start,
                                   "increment": c.increment,
                                   "value": None}).encode())
        self.kv.txn(fn)
        return Result(tag="CREATE SEQUENCE")

    def _exec_drop_sequence(self, d: ast.DropSequence) -> Result:
        key = self.SEQ_PREFIX + d.name.encode()

        def fn(t):
            if t.get(key) is None:
                if d.if_exists:
                    return
                raise EngineError(f"sequence {d.name!r} does not exist")
            t.delete(key)
        self.kv.txn(fn)
        return Result(tag="DROP SEQUENCE")


def _table_refs(sql: str) -> set:
    """Every table a statement text names."""
    out: set = set()
    collect_tables(parser.parse(sql), out)
    return out
