"""Row-level TTL deletion job (the port of cockroach_tpu/jobs/ttl.py;
the reference's pkg/ttl).

A pass deletes the rows whose TTL column is older than ``ttl_seconds``
(``ttl_col + ttl_seconds <= now``) through ordinary DML, so deletions
are transactional, reach changefeeds and are collected like any other
tombstone. Progress checkpoints the rows deleted so far; a second pass
deletes only what is still expired, so the job is idempotent. The
schedule is the caller's (a Node loop, tests).
"""

from __future__ import annotations

import datetime

from .registry import JobContext

TTL_JOB = "row-ttl"


class TTLResumer:
    """payload: {table, ttl_col, ttl_seconds, batch_rows};
    progress: {deleted}."""

    def __init__(self, engine):
        self.engine = engine

    def resume(self, ctx: JobContext) -> None:
        p = ctx.payload
        table = p["table"]
        col = p["ttl_col"]
        ttl_s = int(p["ttl_seconds"])
        batch = int(p.get("batch_rows", 1000))
        e = self.engine
        if table not in e.store.tables:
            return
        ty = e.store.table(table).schema.column(col).type
        now_us = e.clock.now().wall // 1000
        cutoff_us = now_us - ttl_s * 1_000_000
        if ty.family.value == "date":
            lit = (f"date '1970-01-01' + interval "
                   f"'{cutoff_us // 86_400_000_000} day'")
        else:
            dt = (datetime.datetime(1970, 1, 1)
                  + datetime.timedelta(microseconds=cutoff_us))
            lit = f"timestamp '{dt.isoformat(sep=' ')}'"
        deleted = int(ctx.progress().get("deleted", 0))
        while True:
            ctx.check_cancel()
            n = e.execute(f"DELETE FROM {table} WHERE {col} <= {lit}"
                          ).row_count
            deleted += n
            ctx.checkpoint({"deleted": deleted})
            if n == 0 or n < batch:
                break

    def on_fail_or_cancel(self, ctx: JobContext) -> None:
        pass
