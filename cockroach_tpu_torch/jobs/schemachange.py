"""Schema-change jobs: the online ADD COLUMN backfill and the online
CREATE INDEX backfill.

The port of cockroach_tpu/jobs/schemachange.py (the reference's schema
changer run through pkg/jobs; the backfillers of pkg/sql/backfill). ADD
COLUMN: the column is in the descriptor WRITE_ONLY and in the scan plane
hidden; the job fills the chunks that lack it one at a time (each chunk
a checkpoint), publishes the descriptor with the column PUBLIC, waits
for the old leases and unhides it. CREATE INDEX: the descriptor is
already published WRITE_ONLY (every writer maintains the index); the
job validates a unique index over the rows that existed before and
writes its KV entries chunk by chunk, then publishes it PUBLIC. Every
step is idempotent, so a crashed job resumes from its checkpoint.
"""

from __future__ import annotations

from ..catalog import CatalogError
from ..catalog.descriptor import PUBLIC
from ..storage import keys as K
from ..storage.columnstore import MAX_TS_INT
from .registry import JobContext, _CrashForTesting

SCHEMA_CHANGE_JOB = "schema-change"
INDEX_BACKFILL_JOB = "index-backfill"


class SchemaChangeResumer:
    """ADD COLUMN. payload: {table, column}; progress: {chunks_done}."""

    def __init__(self, engine, crash_after_chunk=None):
        self.engine = engine
        self.crash_after_chunk = crash_after_chunk

    def resume(self, ctx: JobContext) -> None:
        p = ctx.payload
        table, column = p["table"], p["column"]
        store = self.engine.store
        desc = self.engine.catalog.get_by_name(table)
        if desc is None:
            raise CatalogError(f"table {table!r} vanished mid-change")
        col = desc.column(column)
        if col.state != PUBLIC:
            # chunks can arrive while the job runs (concurrent writes):
            # loop until none lacks the column
            done = int(ctx.progress().get("chunks_done", 0))
            while True:
                ctx.check_cancel()
                missing = store.unfilled_chunks(table, column)
                if not missing:
                    break
                for ci in missing:
                    ctx.check_cancel()
                    store.backfill_column_chunk(table, column, ci)
                    done += 1
                    if (self.crash_after_chunk is not None
                            and done >= self.crash_after_chunk):
                        raise _CrashForTesting()
                    ctx.checkpoint({"chunks_done": done})
            # version+1 with the column PUBLIC, the old leases drained,
            # then unhidden in the scan plane
            col.state = PUBLIC
            self.engine.leases.publish(desc)
        store.publish_column(table, column)
        ctx.checkpoint({"chunks_done": ctx.progress().get("chunks_done", 0),
                        "published": True}, fraction=1.0)

    def on_fail_or_cancel(self, ctx: JobContext) -> None:
        """Roll back: drop the half-added hidden column."""
        p = ctx.payload
        eng = self.engine
        if p["table"] not in eng.store.tables:
            return
        td = eng.store.table(p["table"])
        if any(c.name == p["column"] and c.hidden
               for c in td.schema.columns):
            eng.store.drop_column(p["table"], p["column"])
        desc = eng.catalog.get_by_name(p["table"])
        if desc is not None and any(c.name == p["column"]
                                    for c in desc.columns):
            desc.columns = [c for c in desc.columns
                            if c.name != p["column"]]
            eng.catalog.write_new_version(desc)


class IndexBackfillResumer:
    """CREATE INDEX. A unique index is validated over the rows of the
    scan plane and its KV entries are written chunk by chunk (each chunk
    a checkpoint); a non-unique index is a locator the scan plane derives
    on demand, so its job only warms it.
    payload: {table, index}; progress: {chunks_done, generation}."""

    def __init__(self, engine, crash_after_chunk=None):
        self.engine = engine
        self.crash_after_chunk = crash_after_chunk

    def resume(self, ctx: JobContext) -> None:
        p = ctx.payload
        table, iname = p["table"], p["index"]
        eng = self.engine
        store = eng.store
        desc = eng.catalog.get_by_name(table)
        if desc is None:
            raise CatalogError(f"table {table!r} vanished mid-change")
        idx = next((i for i in desc.indexes if i.name == iname), None)
        if idx is None:
            raise CatalogError(f"index {iname!r} vanished mid-change")
        if idx.state != PUBLIC:
            td = store.table(table)
            cols = tuple(idx.columns)
            if idx.unique:
                # no two live rows may share a value (writers racing the
                # backfill already maintain KV entries: the same check
                # covers them)
                for vals, positions in store.ensure_secondary_index(
                        table, cols).items():
                    ctx.check_cancel()
                    live = [1 for ci, ri in positions
                            if td.chunks[ci].mvcc_del[ri] == MAX_TS_INT]
                    if len(live) > 1:
                        raise ValueError(
                            f"duplicate key value {vals!r} violates "
                            f"unique index {iname!r} of {table!r}")
                self._write_entries(ctx, td, desc.id, idx, cols)
            else:
                # warm the locator (and check the columns exist)
                store.ensure_secondary_index(table, cols)
            idx.state = PUBLIC
            eng.leases.publish(desc)
            eng._index_defs.pop(table, None)
        ctx.checkpoint({"chunks_done": ctx.progress().get("chunks_done", 0),
                        "published": True}, fraction=1.0)

    def _write_entries(self, ctx, td, tid: int, idx, cols: tuple) -> None:
        """The unique index's KV entries, one txn and one checkpoint a
        chunk. The cursor is a chunk position, valid only for the chunk
        layout it was taken against: a GC pass between a crash and the
        resume compacts the chunks, so a moved generation restarts at
        chunk 0 (an entry's put is idempotent)."""
        eng = self.engine
        store = eng.store
        done = int(ctx.progress().get("chunks_done", 0))
        if int(ctx.progress().get("generation", -1)) != td.generation:
            done = 0
        while done < len(td.chunks):
            for ci in range(done, len(td.chunks)):
                ctx.check_cancel()
                chunk = td.chunks[ci]

                def fill(t, chunk=chunk):
                    for ri in range(chunk.n):
                        if chunk.mvcc_del[ri] != MAX_TS_INT:
                            continue
                        row = store.extract_row(td, chunk, ri)
                        vals = tuple(row.get(cn) for cn in cols)
                        if any(v is None for v in vals):
                            continue
                        t.put(K.table_key(tid, vals, idx.index_id),
                              store.row_key(td, chunk, ri))
                eng.kv.txn(fill)
                done = ci + 1
                if (self.crash_after_chunk is not None
                        and done >= self.crash_after_chunk):
                    raise _CrashForTesting()
                ctx.checkpoint({"chunks_done": done,
                                "generation": td.generation})

    def on_fail_or_cancel(self, ctx: JobContext) -> None:
        """Roll back: the half-built index leaves the descriptor and its
        written KV entries go."""
        p = ctx.payload
        eng = self.engine
        desc = eng.catalog.get_by_name(p["table"])
        if desc is None:
            return
        idx = next((i for i in desc.indexes if i.name == p["index"]), None)
        if idx is None:
            return
        desc.indexes = [i for i in desc.indexes if i.name != p["index"]]
        eng.catalog.write_new_version(desc)
        eng._index_defs.pop(p["table"], None)
        if idx.unique:
            pref = K.table_prefix(desc.id, idx.index_id)
            eng.kv.txn(lambda t: t.delete_range(pref, K.prefix_end(pref)))
