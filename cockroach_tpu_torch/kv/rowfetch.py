"""Range-backed row fetch: SQL table rows on raft-replicated ranges
(cockroach_tpu/kv/rowfetch.py).

The analogue of cFetcher/txnKVFetcher pulling table rows out of ranges
(pkg/sql/colfetcher/cfetcher.go:668 NextBatch -> pkg/sql/row/
kv_batch_fetcher.go:107 -> DistSender -> ranges), plus the
PartitionSpans decision that assigns scan spans to nodes by
leaseholder (distsql_physical_planner.go:1096).

Rows travel as RowCodec KV pairs (sql/rowenc.py): writes raft-
replicate through the cluster's leaseholder replicas; scans decode
KV pairs back into storage-logical rows and MATERIALIZE them into a
node's columnstore, which is exactly this framework's design stance —
the scan plane is a columnar materialization of committed range data
(storage/columnstore.py docstring), refreshed per range epoch instead
of per query.
"""

from __future__ import annotations

from ..sql.rowenc import ROWID, RowCodec
from ..sql.types import TableSchema


class RangeTable:
    """One SQL table living on a Cluster's ranges."""

    def __init__(self, cluster, schema: TableSchema):
        self.cluster = cluster
        self.schema = schema
        self.codec = RowCodec(schema)
        self._next_rowid = 1

    # -- write path (raft-replicated) ---------------------------------------
    def insert_rows(self, rows: list) -> int:
        """Replicate each row's KV pair through its range's raft group
        (the reference: txn intents -> EndTxn -> raft; the cluster
        harness proposes committed writes directly)."""
        for row in rows:
            if self.codec.synthetic_pk and ROWID not in row:
                row = dict(row)
                row[ROWID] = self._next_rowid
                self._next_rowid += 1
            self.cluster.put(self.codec.key(row),
                             self.codec.encode_value(row))
        return len(rows)

    # -- span partitioning (PartitionSpans) ---------------------------------
    def partition_spans(self) -> dict:
        """node_id -> [(start, end)] pieces of this table's span,
        assigned by range leaseholder — the DistSQL planner's
        placement input (distsql_physical_planner.go:1096)."""
        start, end = self.codec.span()
        out: dict[int, list] = {}
        cur = start
        while cur < end:
            desc = self.cluster.range_for_key(cur)
            if desc is None:
                break
            holder = self.cluster.ensure_lease(desc.range_id)
            if holder is None:
                raise RuntimeError(
                    f"range r{desc.range_id} has no leaseholder")
            piece_end = min(end, desc.end_key)
            out.setdefault(holder, []).append((cur, piece_end))
            cur = piece_end
        return out

    # -- read path (the cFetcher analogue) ----------------------------------
    def fetch_rows(self, spans=None) -> list:
        """Decode committed KV pairs back into rows. spans=None reads
        the whole table; otherwise only the given (start, end) pieces
        (a node fetching its leaseholder partition)."""
        if spans is None:
            spans = [self.codec.span()]
        rows = []
        for lo, hi in spans:
            for k, v in self.cluster.scan(lo, hi):
                rows.append(self.codec.decode_row(k, v))
        return rows

    def materialize_into(self, engine, spans=None,
                         table_name: str | None = None,
                         ts=None) -> int:
        """Refresh one engine's columnstore scan plane from range data
        (the direct-columnar-scan idea, storage/col_mvcc.go:37-64:
        decode where the data lives, serve columns to the compute).
        Replaces the table's local contents."""
        name = table_name or self.schema.name
        rows = self.fetch_rows(spans)
        store = engine.store
        if name in store.tables:
            store.drop_table(name)
            engine._evict_device(name)
        schema = self.schema
        if table_name is not None and table_name != self.schema.name:
            from dataclasses import replace
            schema = replace(self.schema, name=table_name)
        store.create_table(schema)
        # ts: a flow materializing its span assignment mid-statement
        # must stamp rows AT OR BELOW the statement's read_ts, or the
        # MVCC mask hides the whole snapshot (the local copy is a
        # scan-plane snapshot of already-committed range data, so a
        # floor timestamp is faithful). The rows go in as sealed chunks
        # under a new table generation, so the engine's device copy and
        # exec cache (keyed by generation) never serve the old contents
        from ..storage.columnstore import MAX_TS_INT
        tsi = (ts or engine.clock.now()).to_int()
        store.insert_versions(name, [(r, tsi, MAX_TS_INT) for r in rows])
        return len(rows)
