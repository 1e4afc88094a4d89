"""Protected timestamps: records that hold MVCC GC back (the port of
cockroach_tpu/kv/protectedts.py; the reference's
pkg/kv/kvserver/protectedts).

A record pins the history at and after its timestamp for a set of
tables (an empty set: every table); a GC pass's threshold is
min(now - ttl, oldest covering protection - 1). Records are
transactional KV rows at /pts/<id>.
"""

from __future__ import annotations

import json
import uuid
from typing import Optional

PTS_PREFIX = b"/pts/"


def _key(rec_id: str) -> bytes:
    return PTS_PREFIX + rec_id.encode()


class ProtectedTimestamps:
    def __init__(self, kv):
        self.kv = kv

    def protect(self, ts_int: int, tables: list[str], meta: str = "") -> str:
        """A new protection record; returns its id."""
        rec_id = uuid.uuid4().hex[:12]
        payload = json.dumps({"ts": int(ts_int), "tables": sorted(tables),
                              "meta": meta}).encode()
        self.kv.txn(lambda t: t.put(_key(rec_id), payload))
        return rec_id

    def release(self, rec_id: str) -> None:
        self.kv.txn(lambda t: t.delete(_key(rec_id)))

    def records(self) -> list[tuple[str, int, list[str], str]]:
        """[(id, ts, tables, meta)] of every record."""
        def fn(t):
            out = []
            for k, v in t.scan(PTS_PREFIX, PTS_PREFIX + b"\xff"):
                o = json.loads(v.decode())
                out.append((k[len(PTS_PREFIX):].decode(), o["ts"],
                            o["tables"], o.get("meta", "")))
            return out
        return self.kv.txn(fn)

    def min_protected(self, table: str) -> Optional[int]:
        """The oldest protection covering ``table``, or None."""
        ts = [ts for _id, ts, tables, _m in self.records()
              if not tables or table in tables]
        return min(ts) if ts else None
