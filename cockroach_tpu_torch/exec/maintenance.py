"""Online schema changes, jobs, zone configurations, protected
timestamps, MVCC GC, BACKUP and RESTORE, row TTL and changefeeds: the
engine's asynchronous-work surface.

The port of cockroach_tpu/exec/maintenance.py. ALTER TABLE ADD/DROP
COLUMN moves the descriptor through WRITE_ONLY to PUBLIC with a lease
drain at each version (catalog/lease.py), the ADD's backfill running as
a durable job (jobs/schemachange.py), as the reference's schema changer
does (pkg/sql/schemachanger through pkg/jobs). BACKUP and RESTORE run
their jobs inside the statement (jobs/backup.py); ``run_ttl`` runs one
row-TTL pass as a job (jobs/ttl.py); ``create_changefeed`` starts a
changefeed job on a thread of its own that runs until CANCEL JOB
(cdc/changefeed.py).

A GC pass (``run_gc``) drops the row versions deleted before
now - ``gc.ttl_seconds`` (the table's zone, else the cluster setting
``kv.gc.ttl_seconds``), held below the oldest protected timestamp that
covers the table. A pass with versions to drop compacts chunks, so it
runs under the exclusive side of the statement gate, after the OLTP
lane's queued writes on the table have published; then the table's
device copies, the lane's plans and mirrors go. A pass with none only
records its threshold. The table keeps the pass's threshold: an AS OF SYSTEM
TIME read below it is refused (``Engine._check_gc_threshold``), where
the reference silently reads the collected history.
"""

from __future__ import annotations

import json
import threading

from ..catalog.descriptor import WRITE_ONLY, ColumnDescriptor
from ..jobs.schemachange import (INDEX_BACKFILL_JOB, SCHEMA_CHANGE_JOB,
                                 IndexBackfillResumer, SchemaChangeResumer)
from ..kv.protectedts import ProtectedTimestamps
from ..sql import ast
from ..sql.binder import Binder, Scope
from ..sql.bound import BConst
from ..sql.types import ColumnSchema
from ..storage.hlc import Timestamp
from .session import EngineError, Result

ZONE_PREFIX = b"/zone/"
ZONE_OPTIONS = ("gc.ttl_seconds", "range_max_bytes")


class MaintenanceMixin:
    """Engine methods of schema changes, jobs, zones and GC; mixed into
    exec.engine.Engine (all state lives on the Engine instance)."""

    @property
    def jobs(self):
        """The engine's job registry (built at first use), with the
        schema-change, changefeed, backup, restore and TTL resumers."""
        if self._jobs is None:
            from ..cdc import CHANGEFEED_JOB, ChangefeedResumer
            from ..jobs import (BACKUP_JOB, RESTORE_JOB, TTL_JOB,
                                BackupResumer, Registry, RestoreResumer,
                                TTLResumer)
            reg = Registry(self.kv, session_id=f"engine-{id(self)}")
            reg.register(SCHEMA_CHANGE_JOB,
                         lambda: SchemaChangeResumer(self))
            reg.register(INDEX_BACKFILL_JOB,
                         lambda: IndexBackfillResumer(self))
            reg.register(CHANGEFEED_JOB, lambda: ChangefeedResumer(self))
            reg.register(BACKUP_JOB, lambda: BackupResumer(self))
            reg.register(RESTORE_JOB, lambda: RestoreResumer(self))
            reg.register(TTL_JOB, lambda: TTLResumer(self))
            self._jobs = reg
        return self._jobs

    @property
    def protectedts(self) -> ProtectedTimestamps:
        if self._pts is None:
            self._pts = ProtectedTimestamps(self.kv)
        return self._pts

    def zone_config(self, table: str) -> dict:
        """The table's zone overrides (the spanconfig analogue) at
        /zone/<table>; empty: the cluster defaults apply."""
        raw = self.kv.txn(lambda t: t.get(ZONE_PREFIX + table.encode()))
        return json.loads(raw.decode()) if raw else {}

    def _exec_configure_zone(self, stmt: ast.ConfigureZone) -> Result:
        if stmt.table not in self.store.tables:
            raise EngineError(f"table {stmt.table!r} does not exist")
        bad = set(stmt.options) - set(ZONE_OPTIONS)
        if bad:
            raise EngineError(f"unknown zone option(s) {sorted(bad)}; "
                              f"supported: {sorted(ZONE_OPTIONS)}")
        cur = self.zone_config(stmt.table)
        cur.update(stmt.options)
        self.kv.txn(lambda t: t.put(ZONE_PREFIX + stmt.table.encode(),
                                    json.dumps(cur, sort_keys=True)
                                    .encode()))
        return Result(tag="CONFIGURE ZONE")

    def _exec_show_zone(self, stmt: ast.ShowZone) -> Result:
        z = self.zone_config(stmt.table) or {
            "gc.ttl_seconds": self.settings.get("kv.gc.ttl_seconds"),
            "range_max_bytes": self.settings.get("kv.range.max_bytes")}
        return Result(names=["option", "value"],
                      rows=sorted((k, str(v)) for k, v in z.items()),
                      tag="SHOW ZONE CONFIGURATION")

    def _exec_show_jobs(self) -> Result:
        recs = sorted(self.jobs.jobs(), key=lambda r: r.id)
        return Result(names=["job_id", "job_type", "status",
                             "fraction_completed"],
                      rows=[(r.id, r.type, r.status,
                             round(r.fraction_completed, 3))
                            for r in recs],
                      tag="SHOW JOBS")

    def gc_threshold(self, table: str) -> Timestamp:
        """The threshold one GC pass over ``table`` would take now."""
        ttl_s = self.zone_config(table).get(
            "gc.ttl_seconds", self.settings.get("kv.gc.ttl_seconds"))
        threshold = self.clock.now().wall - int(ttl_s) * 10 ** 9
        prot = self.protectedts.min_protected(table)
        if prot is not None:
            threshold = min(threshold, prot - 1)
        return Timestamp(threshold, 0)

    def run_gc(self, table: str) -> int:
        """One MVCC GC pass over ``table`` (the mvcc_gc_queue analogue):
        the number of row versions it removed."""
        threshold = self.gc_threshold(table)
        if threshold.wall <= 0:
            return 0
        if not self._gc_due(table, threshold):
            # nothing to compact (the common case under the default
            # TTL): the threshold is recorded with no gate and no flush
            self.store.record_gc_threshold(table, threshold)
            return 0
        # chunks compact and row positions move: the lane's queued
        # writes publish first, then no statement runs meanwhile
        with self._run_scope({table}, shared=False):
            n = self.store.gc(table, threshold)
            if n:
                self._evict_device(table)
                self._lane_reset()
        return n

    def _gc_due(self, table: str, threshold: Timestamp) -> bool:
        """Whether a pass at ``threshold`` has versions to drop: in the
        store, or behind the lane's queued writes on the table (one
        committed at or before it supersedes a version once it
        publishes)."""
        ti = threshold.to_int()
        if any(tsi <= ti for _op, tsi in
               list(self._lane_pending.get(table, ()))):
            return True
        return self.store.gc_pending(table, threshold) > 0

    def _check_gc_threshold(self, table: str, read_ts: Timestamp) -> None:
        """Refuse a historical read below the table's GC threshold: the
        versions it would see may be gone (CockroachDB's "must be after
        replica GC threshold")."""
        td = self.store.tables.get(table)
        if td is not None and read_ts.to_int() < td.gc_threshold:
            thr = Timestamp.from_int(td.gc_threshold)
            raise EngineError(
                f"AS OF SYSTEM TIME: batch timestamp {read_ts.wall} must "
                f"be after replica GC threshold {thr.wall} of table "
                f"{table!r}")

    # -- BACKUP, RESTORE, row TTL, changefeeds --------------------------------
    def _exec_backup(self, stmt: ast.Backup) -> Result:
        from ..jobs import BACKUP_JOB
        for t in stmt.tables:
            if t not in self.store.tables:
                raise EngineError(f"table {t!r} does not exist")
        jid = self.jobs.create(BACKUP_JOB, {"tables": stmt.tables,
                                            "dest": stmt.dest})
        rec = self.jobs.run_job(jid)
        if rec.status != "succeeded":
            raise EngineError(f"BACKUP failed: {rec.error}")
        return Result(names=["job_id"], rows=[(jid,)], tag="BACKUP")

    def _exec_restore(self, stmt: ast.Restore) -> Result:
        from ..jobs import RESTORE_JOB
        jid = self.jobs.create(RESTORE_JOB, {"tables": stmt.tables,
                                             "src": stmt.src})
        rec = self.jobs.run_job(jid)
        if rec.status != "succeeded":
            raise EngineError(f"RESTORE failed: {rec.error}")
        return Result(names=["job_id"], rows=[(jid,)], tag="RESTORE")

    def _table_created(self, table: str) -> None:
        """A table created outside CREATE TABLE (RESTORE): the
        engine's per-table index, constraint and FK caches forget it."""
        self._index_defs.pop(table, None)
        self._constraint_defs.pop(table, None)
        self._fk_children = None

    def run_ttl(self, table: str, ttl_col: str, ttl_seconds: int) -> int:
        """One row-TTL pass over ``table`` (the pkg/ttl analogue): deletes
        the rows whose ``ttl_col`` is older than ``ttl_seconds``; returns
        the job id. The schedule is the caller's."""
        from ..jobs import TTL_JOB
        jid = self.jobs.create(TTL_JOB, {"table": table, "ttl_col": ttl_col,
                                         "ttl_seconds": ttl_seconds})
        rec = self.jobs.run_job(jid)
        if rec.status != "succeeded":
            raise EngineError(f"TTL job failed: {rec.error}")
        return jid

    def create_changefeed(self, table: str, sink: str, cursor: int = 0,
                          resolved_every_s: float = 0.05) -> int:
        """Start a changefeed job tailing ``table`` into ``sink``
        (mem://name or file://path) from ``cursor`` (a Timestamp int;
        0: the table's whole history); returns the job id. It runs on a
        thread of its own until canceled (CANCEL JOB)."""
        from ..cdc import CHANGEFEED_JOB
        if table not in self.store.tables:
            raise EngineError(f"table {table!r} does not exist")
        job_id = self.jobs.create(CHANGEFEED_JOB, {
            "table": table, "sink": sink, "cursor": cursor,
            "resolved_every_s": resolved_every_s})
        th = threading.Thread(target=self._run_changefeed, args=(job_id,),
                              daemon=True, name=f"changefeed-{job_id}")
        # the OLTP lane declines writes to a table whose feed thread
        # lives (exec/oltplane.py); dead threads gate nothing
        self._cdc_threads[job_id] = (th, table)
        th.start()
        return job_id

    def _run_changefeed(self, job_id: int) -> None:
        # a resumer's failure is in the job record; what escapes the
        # registry itself is logged
        try:
            self.jobs.run_job(job_id)
        except Exception as e:
            from ..utils import log
            log.error(log.JOBS, "changefeed job %s: %s", job_id, e)

    # -- ALTER TABLE ----------------------------------------------------------
    def _exec_alter(self, a: ast.AlterTable) -> Result:
        """Online schema change: WRITE_ONLY, then (for an ADD, a backfill
        job) PUBLIC, with a lease drain at each version bump."""
        if a.table not in self.store.tables:
            raise EngineError(f"table {a.table!r} does not exist")
        desc = self.catalog.get_by_name(a.table)
        if desc is None:
            raise EngineError(
                f"table {a.table!r} has no descriptor (pre-catalog)")
        if a.drop is not None:
            self._alter_drop_column(a.table, desc, a.drop)
        else:
            self._alter_add_column(a, desc)
        self._evict_device(a.table)
        return Result(tag="ALTER TABLE")

    def _alter_drop_column(self, table: str, desc, colname: str) -> None:
        if not any(c.name == colname for c in desc.columns):
            raise EngineError(f"column {colname!r} does not exist")
        if colname in desc.primary_key:
            raise EngineError(
                f"cannot drop primary key column {colname!r}")
        refs = [i.name for i in desc.indexes if colname in i.columns]
        if refs:
            raise EngineError(
                f"cannot drop column {colname!r}: referenced by "
                f"index(es) {sorted(refs)}; drop them first")
        # hidden from readers, published, leases drained; then removed
        desc.column(colname).state = WRITE_ONLY
        self.store.hide_column(table, colname)
        desc = self.leases.publish(desc)
        desc.columns = [c for c in desc.columns if c.name != colname]
        self.store.drop_column(table, colname)
        self.leases.publish(desc)

    def _alter_add_column(self, a: ast.AlterTable, desc) -> None:
        cdef = a.add
        if any(c.name == cdef.name for c in desc.columns):
            raise EngineError(f"column {cdef.name!r} already exists")
        default_phys = None
        if a.default is not None:
            binder = Binder(Scope())
            b = binder.bind(a.default)
            if not isinstance(b, BConst):
                raise EngineError("DEFAULT must be a constant")
            if b.value is not None:
                default_phys = binder.coerce(b, cdef.type).value
        if not cdef.nullable and default_phys is None \
                and self.store.table(a.table).row_count > 0:
            raise EngineError("adding NOT NULL column to non-empty table "
                              "requires DEFAULT")
        # WRITE_ONLY descriptor and a hidden physical column: writes
        # carry it, readers do not see it yet
        desc.columns.append(ColumnDescriptor(
            cdef.name, cdef.type, cdef.nullable, WRITE_ONLY, default_phys))
        desc.allocate_col_ids()   # a fresh stable id, never reused
        desc = self.leases.publish(desc)
        self.store.add_column(
            a.table, ColumnSchema(cdef.name, cdef.type, cdef.nullable,
                                  cid=desc.columns[-1].col_id),
            default=default_phys, hidden=True)
        # the chunk-checkpointed backfill and the PUBLIC publish run as
        # a durable job (resumable after a crash)
        job_id = self.jobs.create(SCHEMA_CHANGE_JOB,
                                  {"table": a.table, "column": cdef.name})
        rec = self.jobs.run_job(job_id)
        if rec.status != "succeeded":
            raise EngineError(
                f"schema change failed: {rec.error or rec.status}")
