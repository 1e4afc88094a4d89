"""Changefeeds: committed SQL writes -> encoded events -> a sink.

The port of cockroach_tpu/cdc/changefeed.py (the reference's
pkg/ccl/changefeedccl). A changefeed job tails one table's committed
effects: a catch-up scan of the columnstore's MVCC history since its
cursor, then the engine's publish hook (exec/dml.py ``_publish``). It
encodes each row change as JSON, pushes it to a sink and emits
resolved timestamps, a promise that no earlier event will arrive.
Progress (the resolved timestamp) checkpoints into the job registry, so
a resumed changefeed re-delivers from its last resolved point
(at least once, as the reference's).

The catch-up selects the versions written and deleted after the cursor
with whole-chunk masks (``ColumnStore.changes_since``) and decodes only
those rows, a column at a time; its events are ordered by (timestamp,
key) as the reference's walk orders them. The engine's statement gate
stands where the reference takes its statement lock.

Sinks: mem://<name> (an in-process collector) and file://<path>
(newline-delimited JSON, the shape of the reference's cloud-storage
sink).
"""

from __future__ import annotations

import datetime
import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..jobs.registry import JobContext
from ..storage.hlc import Timestamp

CHANGEFEED_JOB = "changefeed"


# -- sinks ---------------------------------------------------------------------
class CollectorSink:
    """In-memory sink (tests, in-process consumers)."""

    def __init__(self):
        self.rows: list[dict] = []
        self.resolved: list[int] = []
        self._mu = threading.Lock()

    def emit_row(self, payload: dict) -> None:
        with self._mu:
            self.rows.append(payload)

    def emit_resolved(self, ts_int: int) -> None:
        with self._mu:
            self.resolved.append(ts_int)

    def flush(self) -> None:
        pass


class FileSink:
    """Newline-delimited JSON file."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", encoding="utf-8")

    def emit_row(self, payload: dict) -> None:
        self._f.write(json.dumps(payload, sort_keys=True) + "\n")

    def emit_resolved(self, ts_int: int) -> None:
        self._f.write(json.dumps({"resolved": ts_int}) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


_MEM_SINKS: dict[str, CollectorSink] = {}


def open_sink(uri: str):
    if uri.startswith("mem://"):
        return _MEM_SINKS.setdefault(uri[6:], CollectorSink())
    if uri.startswith("file://"):
        return FileSink(uri[7:])
    raise ValueError(f"unknown sink scheme {uri!r}")


# -- the feed (the engine-side event source) -----------------------------------
@dataclass
class FeedEvent:
    key: bytes
    row: Optional[dict]  # None: a delete
    ts_int: int


class TableFeed:
    """Buffered committed-write events of one table: the catch-up scan's
    history since ``since_int``, then live events from the publish
    hook."""

    def __init__(self, engine, table: str, since_int: int):
        self.engine = engine
        self.table = table
        self.events: deque[FeedEvent] = deque()
        self._mu = threading.Lock()
        with engine._stmt_lock:
            # committed lane writes may still wait in the deferred
            # publish queue; the catch-up reads the columnstore, so they
            # land first
            if engine._lane_pending:
                engine.lane_flush()
            engine.cdc_feeds.append(self)
            engine._lane_feeds_changed()
            self._catch_up(since_int)

    def close(self) -> None:
        with self.engine._stmt_lock:
            if self in self.engine.cdc_feeds:
                self.engine.cdc_feeds.remove(self)
                self.engine._lane_feeds_changed()

    def _catch_up(self, since_int: int) -> None:
        store = self.engine.store
        if self.table not in store.tables:
            return
        td = store.table(self.table)
        evs: list = []
        base = 0
        for chunk, put, gone in store.changes_since(self.table, since_int):
            # (ts, key, order): the order is the reference's walk, row
            # by row, a row's put before its delete; the sort is stable
            if put.size:
                keys = store.keys_at(td, chunk, put)
                rows = store.rows_at(td, chunk, put)
                evs.extend(
                    (ts, k, 2 * (base + ri), FeedEvent(k, row, ts))
                    for ts, k, ri, row in zip(chunk.mvcc_ts[put].tolist(),
                                              keys, put.tolist(), rows))
            if gone.size:
                keys = store.keys_at(td, chunk, gone)
                evs.extend(
                    (ts, k, 2 * (base + ri) + 1, FeedEvent(k, None, ts))
                    for ts, k, ri in zip(chunk.mvcc_del[gone].tolist(),
                                         keys, gone.tolist()))
            base += chunk.n
        evs.sort(key=lambda e: e[:3])
        self.events.extend(e[3] for e in evs)

    def on_publish(self, ops: list, ts: Timestamp) -> None:
        """Live events of one committed txn (called from the engine's
        publish, under the statement gate)."""
        tsi = ts.to_int()
        with self._mu:
            for op in ops:
                if op[0] == "put":
                    self.events.append(FeedEvent(op[1], dict(op[2]), tsi))
                else:
                    self.events.append(FeedEvent(op[1], None, tsi))

    def drain(self) -> list[FeedEvent]:
        with self._mu:
            out = list(self.events)
            self.events.clear()
            return out

    def frontier(self) -> int:
        """A timestamp below which no further event can arrive: commits
        publish under the statement gate's write side with a monotonic
        HLC, so with it held and the buffer drained, now() is a sound
        resolved timestamp."""
        with self.engine._stmt_lock:
            with self._mu:
                if self.events:
                    return min(e.ts_int for e in self.events) - 1
            return self.engine.clock.now().to_int()


# -- encoding ------------------------------------------------------------------
def _json_safe(v):
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (datetime.date, datetime.datetime)):
        return v.isoformat()
    if isinstance(v, bytes):
        return v.hex()
    return v


def encode_event(table: str, ev: FeedEvent) -> dict:
    after = None
    if ev.row is not None:
        after = {k: _json_safe(v) for k, v in ev.row.items()
                 if not k.startswith("__")}
    return {"table": table, "key": ev.key.hex(), "after": after,
            "updated": ev.ts_int}


# -- the job -------------------------------------------------------------------
class ChangefeedResumer:
    """payload: {table, sink, cursor, resolved_every_s};
    progress: {resolved}.

    Runs until canceled, renewing its job lease on the lease's own
    cadence (JobContext.keep_alive, every pass of its loop) besides the
    checkpoint of each advanced resolved timestamp, so a live feed is
    never adopted, however rarely it emits resolved timestamps. Adopted after a
    crash, it registers the feed again from the checkpointed resolved
    timestamp and re-emits what came after it (at least once)."""

    def __init__(self, engine, poll_s: float = 0.01):
        self.engine = engine
        self.poll_s = poll_s

    def resume(self, ctx: JobContext) -> None:
        p = ctx.payload
        table = p["table"]
        sink = open_sink(p["sink"])
        resolved = int(ctx.progress().get("resolved", p.get("cursor", 0)))
        feed = TableFeed(self.engine, table, resolved)
        emit_every = float(p.get("resolved_every_s", 0.05))
        last_resolved_emit = 0.0
        checkpointed = -1
        try:
            while True:
                ctx.check_cancel()
                evs = feed.drain()
                for ev in evs:
                    sink.emit_row(encode_event(table, ev))
                    if ev.ts_int > resolved:
                        resolved = ev.ts_int
                now = time.monotonic()
                if now - last_resolved_emit >= emit_every:
                    frontier = feed.frontier()
                    if frontier > resolved:
                        resolved = frontier
                    sink.emit_resolved(resolved)
                    sink.flush()
                    if resolved > checkpointed:
                        # the checkpoint renews the job's lease too
                        ctx.checkpoint({"resolved": resolved})
                        checkpointed = resolved
                    last_resolved_emit = now
                # the lease's own cadence, whatever resolved_every_s is
                ctx.keep_alive()
                if not evs:
                    time.sleep(self.poll_s)
        finally:
            feed.close()
            sink.flush()
            if isinstance(sink, FileSink):
                sink.close()

    def on_fail_or_cancel(self, ctx: JobContext) -> None:
        pass
