"""Host columnar MVCC store — the table-data plane feeding the device.

Design rationale (SURVEY.md §7 step 3 + "Host↔HBM feed rate"): the
reference stores SQL rows as KV pairs and pays a per-row decode
(cFetcher, pkg/sql/colfetcher/cfetcher.go) on every scan; its own
direct-columnar-scan work (pkg/storage/col_mvcc.go:37-64) moves that
decode server-side to skip a network hop. We go one step further and
keep the *primary* analytic representation columnar: each table is a
list of immutable column chunks (numpy arrays + validity), with MVCC
visibility as two int64 timestamp columns per chunk:

    _mvcc_ts   — commit timestamp of the row version (Timestamp.to_int)
    _mvcc_del  — deletion timestamp (MAX if live)

A scan AS OF timestamp T selects ``_mvcc_ts <= T < _mvcc_del`` — a pure
mask kernel that runs on device beside the WHERE clause, so MVCC
visibility filtering costs one compare+and per row (SURVEY.md §7
"MVCC visibility filtering on device": resolved in favor of on-device).

Updates/deletes write tombstones (set _mvcc_del) and appended new
versions; chunks are sealed at `chunk_rows` and never mutated except
for the deletion column, mirroring LSM immutability. String columns
are dictionary-encoded at ingest (codes on device, dictionary on
host). This module is the scan plane. Writes go through the row-oriented
KV layer (kv/txn.py, exec/dml.py) and reach the scan plane only as
committed effects (``apply_committed``): tombstones on the superseded
versions and new sealed chunks (of at most `chunk_rows` rows) of the
new versions.
"""

from __future__ import annotations

import bisect
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..sql.types import Family, TableSchema
from . import chunkstats
from .hlc import MAX_TIMESTAMP, Timestamp

MAX_TS_INT = MAX_TIMESTAMP.to_int()


class Dictionary:
    """Growable string dictionary: value <-> int32 code."""

    def __init__(self):
        self.values: list[str] = []
        self.codes: dict[str, int] = {}

    def encode(self, v: str) -> int:
        c = self.codes.get(v)
        if c is None:
            c = len(self.values)
            self.values.append(v)
            self.codes[v] = c
        return c

    def encode_array(self, vals) -> np.ndarray:
        arr = np.asarray(vals)
        if arr.shape[0] > 4096:
            # bulk path: unique once, then one gather (600M-row ingest
            # must not loop per value)
            uniq, inv = np.unique(arr.astype(str), return_inverse=True)
            lut = np.fromiter((self.encode(u) for u in uniq),
                              dtype=np.int32, count=len(uniq))
            return lut[inv].astype(np.int32)
        return np.fromiter((self.encode(v) for v in arr),
                           dtype=np.int32, count=len(arr))

    def decode_array(self, codes: np.ndarray) -> np.ndarray:
        arr = np.asarray(self.values, dtype=object)
        return arr[codes]

    def __len__(self):
        return len(self.values)


@dataclass
class Chunk:
    """Immutable columnar slab (the storage analogue of an SSTable)."""
    data: dict[str, np.ndarray]
    valid: dict[str, np.ndarray]
    mvcc_ts: np.ndarray   # int64 creation timestamps
    mvcc_del: np.ndarray  # int64 deletion timestamps (MAX_TS_INT = live)
    n: int
    # hidden per-row id: stable identity for rows of tables with no
    # declared primary key (the reference synthesizes a rowid column
    # the same way, pkg/sql/catalog/tabledesc)
    rowid: Optional[np.ndarray] = None
    # per-column zone maps (sstable block-property collectors / the
    # reference's crdb_internal_mvcc-free span stats): column data is
    # immutable once the chunk is sealed, so a computed summary stays
    # valid for the chunk's lifetime. mvcc_del IS mutable
    # (tombstones), but zones summarize data columns only — a deleted
    # row's value still bounds the zone, which keeps skipping
    # conservative under any read timestamp. Populated at SEAL time
    # by finalize_stats (storage/chunkstats.py) on every creation
    # path; the in-method computation below survives only as a
    # fallback for directly-constructed chunks (tests).
    _zones: dict = field(default_factory=dict, repr=False, compare=False)
    # seal-time ChunkStats (blooms, distinct sketches, MVCC window);
    # None only for chunks that never went through a store path
    _stats: Optional[object] = field(default=None, repr=False,
                                     compare=False)

    def live_mask(self, ts: int) -> np.ndarray:
        return (self.mvcc_ts <= ts) & (ts < self.mvcc_del)

    def finalize_stats(self) -> None:
        """Build the write-time summaries (zones + blooms + distinct
        sketches + MVCC window) for this chunk. Called by every store
        path that creates or rebuilds a chunk, so the scan plane never
        has to compute a zone on demand."""
        st = chunkstats.compute(self.data, self.valid,
                                self.mvcc_ts, self.mvcc_del)
        self._stats = st
        self._zones.update(st.zones)

    def stats_ready(self) -> bool:
        return self._stats is not None

    def key_bloom(self, col: str):
        """Seal-time blocked bloom over ``col``'s valid values (int
        family and dictionary codes only), or None."""
        st = self._stats
        return st.blooms.get(col) if st is not None else None

    def distinct_sketch(self, col: str):
        """Seal-time distinct-count sketch of ``col``, or None."""
        st = self._stats
        return st.distinct.get(col) if st is not None else None

    def mvcc_window(self) -> tuple[int, int]:
        """(ts_min, del_max): nothing in this chunk is visible at
        read_ts when ts_min > read_ts or del_max <= read_ts. ts_min is
        exact forever (mvcc_ts never changes after seal); del_max is
        the seal-time max and stays an upper bound because tombstones
        only ever lower mvcc_del."""
        st = self._stats
        if st is not None:
            return st.ts_min, st.del_max
        if self.n == 0:
            return 0, 0
        return int(self.mvcc_ts.min()), int(self.mvcc_del.max())

    def zone(self, col: str):
        """(lo, hi, null_count, valid_count) over this chunk's valid
        lanes of `col`; (None, None, ...) when bounds are unknown
        (object dtype, NaNs, or an all-null chunk). Bounds cover ALL
        row versions, so predicate checks against them are
        visibility-independent and only ever under-skip."""
        z = self._zones.get(col)
        if z is None:
            d = self.data[col]
            v = self.valid[col]
            nvalid = int(v.sum())
            if nvalid == 0 or d.dtype.kind not in "biuf":
                z = (None, None, self.n - nvalid, nvalid)
            else:
                vals = d if nvalid == self.n else d[v]
                lo, hi = vals.min(), vals.max()
                if d.dtype.kind == "f" and (np.isnan(lo) or np.isnan(hi)):
                    z = (None, None, self.n - nvalid, nvalid)
                elif d.dtype.kind == "f":
                    z = (float(lo), float(hi), self.n - nvalid, nvalid)
                else:
                    z = (int(lo), int(hi), self.n - nvalid, nvalid)
            self._zones[col] = z
        return z


@dataclass
class TableData:
    schema: TableSchema
    dictionaries: dict[str, Dictionary] = field(default_factory=dict)
    chunks: list[Chunk] = field(default_factory=list)
    chunk_rows: int = 1 << 20
    # generation moves on every mutation; device caches key on it. It
    # is drawn from the store's one counter (ColumnStore._bump), so a
    # re-created table (TRUNCATE, DROP + CREATE) never reuses a value
    # that keys a dropped table's device copy, plan or dictionaries
    generation: int = 0
    next_rowid: int = 1
    # ANALYZE output (sql/stats.py TableStats) + the generation it was
    # computed at; stale stats still inform the planner (estimates),
    # exact row_count always comes from row_count
    stats: Optional[object] = None
    stats_generation: int = -1
    # cached multi-column distinct counts for join-uniqueness checks:
    # (cols tuple) -> (generation, distinct, live_rows)
    key_distinct_cache: dict = field(default_factory=dict)
    # pk-key bytes -> (chunk_index, row_index) of the LIVE version.
    # Built lazily on first transactional DML; None = not built.
    pk_index: Optional[dict] = None
    # host-side locators over ALL row versions, generation-cached:
    # (cols tuple) -> (generation, value tuple -> [(chunk, row)]) and
    # (cols tuple) -> (generation, sorted [(vals, chunk, row)])
    sec_index_cache: dict = field(default_factory=dict)
    sorted_index_cache: dict = field(default_factory=dict)
    # storage-form defaults of columns ALTER TABLE added: rows written
    # without the column (and the chunks the backfill fills) carry them
    column_defaults: dict = field(default_factory=dict)
    # the threshold of the last MVCC GC pass (Timestamp.to_int): no
    # read below it sees every version it would have seen
    gc_threshold: int = 0
    _codec: object = field(default=None, repr=False, compare=False)

    @property
    def row_count(self) -> int:
        return sum(c.n for c in self.chunks)

    @property
    def codec(self):
        from ..sql.rowenc import RowCodec
        if self._codec is None:
            self._codec = RowCodec(self.schema)
        return self._codec


class ColumnStore:
    """All tables of one store (one node's data plane)."""

    def __init__(self, chunk_rows: int | None = None):
        from ..utils.metamorphic import metamorphic_pow2
        if chunk_rows is None:
            # metamorphic: chunk size is perf-only; results must not
            # change at 64 rows or 1M rows
            chunk_rows = metamorphic_pow2(
                "columnstore.chunk_rows", 1 << 20, 6, 20)
        self._lock = threading.RLock()
        self.tables: dict[str, TableData] = {}
        self.chunk_rows = chunk_rows
        # monotonic: a dropped table's id is never reused, so its
        # orphaned KV rows can never alias a new table's keyspace
        # (the reference keeps descriptor ids monotonic the same way)
        self._next_table_id = 100
        self._generation = 0

    def alloc_table_id(self) -> int:
        with self._lock:
            tid = self._next_table_id
            self._next_table_id += 1
            return tid

    def _bump(self, td: TableData) -> None:
        """Move ``td`` to a generation no table of this store has held
        (the caller holds the store lock)."""
        self._generation += 1
        td.generation = self._generation

    # -- DDL ---------------------------------------------------------------
    def create_table(self, schema: TableSchema) -> TableData:
        with self._lock:
            if schema.name in self.tables:
                raise ValueError(f"table {schema.name!r} exists")
            self._next_table_id = max(self._next_table_id,
                                      schema.table_id + 1)
            td = TableData(schema=schema, chunk_rows=self.chunk_rows)
            self._bump(td)
            for col in schema.columns:
                if col.type.uses_dictionary:
                    td.dictionaries[col.name] = Dictionary()
            self.tables[schema.name] = td
            return td

    def drop_table(self, name: str) -> None:
        with self._lock:
            del self.tables[name]

    def table(self, name: str) -> TableData:
        td = self.tables.get(name)
        if td is None:
            raise KeyError(f"table {name!r} does not exist")
        return td

    # -- ingest ------------------------------------------------------------
    def set_dictionary(self, name: str, col: str, values) -> None:
        """Pre-seed a string column's dictionary so bulk ingest can pass
        already-encoded int32 codes (the big-data path: encoding 600M
        object strings through np.unique would dominate ingest)."""
        d = self.table(name).dictionaries[col]
        for v in values:
            d.encode(v)

    def insert_columns(self, name: str, cols: dict[str, np.ndarray],
                       ts: Timestamp,
                       valid: Optional[dict[str, np.ndarray]] = None) -> int:
        """Bulk columnar ingest (IMPORT path; one sealed chunk per call,
        the analogue of AddSSTable ingestion in pkg/sql/importer).

        String columns accept either string arrays (dictionary-encoded
        here) or int32 code arrays into a dictionary pre-seeded via
        set_dictionary."""
        td = self.table(name)
        valid = valid or {}
        n = len(next(iter(cols.values())))
        data: dict[str, np.ndarray] = {}
        vmap: dict[str, np.ndarray] = {}
        with self._lock:
            defaults = td.column_defaults
            for col in td.schema.columns:
                cn = col.name
                if cn not in cols:
                    dv = defaults.get(cn)
                    if dv is not None:
                        cols = dict(cols)
                        cols[cn] = np.full(
                            n, dv, dtype=object
                            if col.type.uses_dictionary
                            else None)
                    elif not col.nullable:
                        raise ValueError(f"missing non-null column {cn}")
                    else:
                        data[cn] = np.zeros(n, dtype=col.type.np_dtype)
                        vmap[cn] = np.zeros(n, dtype=bool)
                        continue
                raw = cols[cn]
                if col.type.uses_dictionary and raw.dtype.kind in ("U", "O", "S"):
                    arr = td.dictionaries[cn].encode_array(raw)
                elif (col.type.uses_dictionary
                      and raw.dtype.kind in ("i", "u")):
                    arr = np.asarray(raw, dtype=np.int32)
                    if arr.size and (int(arr.max()) >= len(td.dictionaries[cn])
                                     or int(arr.min()) < 0):
                        raise ValueError(
                            f"encoded codes for {cn} out of dictionary "
                            f"range (seed it with set_dictionary first)")
                elif col.type.family == Family.DECIMAL and raw.dtype.kind == "f":
                    arr = np.round(raw * (10 ** col.type.scale)).astype(np.int64)
                else:
                    arr = np.asarray(raw, dtype=col.type.np_dtype)
                data[cn] = arr
                vmap[cn] = (np.asarray(valid[cn], dtype=bool) if cn in valid
                            else np.ones(n, dtype=bool))
            tsi = ts.to_int()
            self.append_chunk(name, data, vmap,
                              np.full(n, tsi, dtype=np.int64),
                              np.full(n, MAX_TS_INT, dtype=np.int64))
        return n

    def append_chunk(self, name: str, data: dict[str, np.ndarray],
                     valid: dict[str, np.ndarray], mvcc_ts: np.ndarray,
                     mvcc_del: np.ndarray,
                     rowid: Optional[np.ndarray] = None) -> None:
        """Append one sealed chunk of already-physical column arrays
        with explicit MVCC bounds (bulk ingest, and storage/transfer.py
        carrying another store's row versions over unchanged). Given
        ``rowid``s are kept and ``next_rowid`` moves past them; else the
        chunk takes the next ones."""
        td = self.table(name)
        n = len(mvcc_ts)
        with self._lock:
            if rowid is None:
                rowid = np.arange(td.next_rowid, td.next_rowid + n,
                                  dtype=np.int64)
            else:
                rowid = np.asarray(rowid, dtype=np.int64)
            if n:
                td.next_rowid = max(td.next_rowid, int(rowid.max()) + 1)
            chunk = Chunk(data=data, valid=valid,
                          mvcc_ts=np.asarray(mvcc_ts, dtype=np.int64),
                          mvcc_del=np.asarray(mvcc_del, dtype=np.int64),
                          n=n, rowid=rowid)
            chunk.finalize_stats()
            td.chunks.append(chunk)
            td.pk_index = None  # rebuilt lazily if DML touches this table
            self._bump(td)

    def seal(self, name: str) -> None:
        """Seal the table's open chunk. The port has none: every publish
        and ingest seals its own chunks, so there is nothing buffered,
        the data is unchanged and the caches stay (the reference's seal
        of a table with no open rows)."""
        self.table(name)

    # -- mutation (tombstones + new versions) -------------------------------
    def delete_where(self, name: str, pred, ts: Timestamp) -> int:
        """Tombstone the rows visible at ``ts`` that ``pred(chunk)`` (a
        bool mask) selects: their deletion timestamp becomes ``ts``, so
        older readers still see them. Returns how many."""
        td = self.table(name)
        tsi = ts.to_int()
        deleted = 0
        with self._lock:
            for chunk in td.chunks:
                mask = chunk.live_mask(tsi) & pred(chunk)
                chunk.mvcc_del[mask] = tsi
                deleted += int(mask.sum())
            td.pk_index = None
            self._bump(td)
        return deleted

    def update_where(self, name: str, pred, assign, ts: Timestamp) -> int:
        """MVCC update: tombstone the rows visible at ``ts`` that
        ``pred(chunk)`` selects and append their new versions, which
        ``assign(chunk, mask) -> (data_cols, valid_cols)`` gives, one
        sealed chunk per source chunk (``append_chunk``). Returns how
        many rows changed."""
        td = self.table(name)
        tsi = ts.to_int()
        updated = 0
        with self._lock:
            new_rows = []
            for chunk in td.chunks:
                mask = chunk.live_mask(tsi) & pred(chunk)
                cnt = int(mask.sum())
                if cnt == 0:
                    continue
                chunk.mvcc_del[mask] = tsi
                new_rows.append(assign(chunk, mask))
                updated += cnt
            for data, vmap in new_rows:
                n = len(next(iter(data.values())))
                self.append_chunk(
                    name, {k: np.asarray(v) for k, v in data.items()},
                    {k: np.asarray(v, dtype=bool) for k, v in vmap.items()},
                    np.full(n, tsi, dtype=np.int64),
                    np.full(n, MAX_TS_INT, dtype=np.int64))
            td.pk_index = None
            self._bump(td)
        return updated

    # -- schema changes (ALTER TABLE; the backfill of pkg/sql/backfill) -----
    def add_column(self, name: str, col, default=None,
                   hidden: bool = True) -> None:
        """Add a column to the live schema, hidden until published. The
        sealed chunks are backfilled one by one by the schema-change job
        (backfill_column_chunk); rows written meanwhile carry
        ``default`` (storage form) at once."""
        td = self.table(name)
        with self._lock:
            if any(c.name == col.name for c in td.schema.columns):
                raise ValueError(f"column {col.name!r} already exists")
            col.hidden = hidden
            td.schema.columns.append(col)
            if col.type.uses_dictionary:
                td.dictionaries.setdefault(col.name, Dictionary())
            if default is not None:
                td.column_defaults[col.name] = default
            td._codec = None
            td.pk_index = None
            self._bump(td)

    def backfill_column_chunk(self, name: str, colname: str,
                              chunk_index: int) -> bool:
        """Fill one sealed chunk with the column's default (idempotent:
        False when the chunk has it already). The unit of the
        schema-change job's checkpoints."""
        td = self.table(name)
        with self._lock:
            if chunk_index >= len(td.chunks):
                return False
            chunk = td.chunks[chunk_index]
            if colname in chunk.data:
                return False
            col = td.schema.column(colname)
            default = td.column_defaults.get(colname)
            n = chunk.n
            if default is None:
                chunk.data[colname] = np.zeros(n, dtype=(
                    np.int32 if col.type.uses_dictionary
                    else col.type.np_dtype))
                chunk.valid[colname] = np.zeros(n, dtype=bool)
            elif col.type.uses_dictionary:
                code = td.dictionaries[colname].encode(default)
                chunk.data[colname] = np.full(n, code, dtype=np.int32)
                chunk.valid[colname] = np.ones(n, dtype=bool)
            else:
                v = default
                if col.type.family == Family.DECIMAL \
                        and not isinstance(v, (int, np.integer)):
                    v = int(round(float(v) * 10 ** col.type.scale))
                chunk.data[colname] = np.full(n, v, dtype=col.type.np_dtype)
                chunk.valid[colname] = np.ones(n, dtype=bool)
            if chunk._stats is not None:
                chunkstats.extend(chunk._stats, colname,
                                  chunk.data[colname], chunk.valid[colname])
                chunk._zones[colname] = chunk._stats.zones[colname]
            else:
                chunk.finalize_stats()
            self._bump(td)
            return True

    def unfilled_chunks(self, name: str, colname: str) -> list[int]:
        td = self.table(name)
        with self._lock:
            return [i for i, c in enumerate(td.chunks)
                    if colname not in c.data]

    def publish_column(self, name: str, colname: str) -> None:
        """Show an added column to readers (its descriptor went PUBLIC)."""
        self._set_hidden(name, colname, False)

    def hide_column(self, name: str, colname: str) -> None:
        self._set_hidden(name, colname, True)

    def _set_hidden(self, name: str, colname: str, hidden: bool) -> None:
        td = self.table(name)
        with self._lock:
            td.schema.column(colname).hidden = hidden
            self._bump(td)

    def drop_column(self, name: str, colname: str) -> None:
        td = self.table(name)
        with self._lock:
            idx = td.schema.column_index(colname)
            if colname in td.schema.primary_key:
                raise ValueError(
                    f"cannot drop primary key column {colname!r}")
            del td.schema.columns[idx]
            td.dictionaries.pop(colname, None)
            td.column_defaults.pop(colname, None)
            for c in td.chunks:
                c.data.pop(colname, None)
                c.valid.pop(colname, None)
                c._zones.pop(colname, None)
                if c._stats is not None:
                    c._stats.zones.pop(colname, None)
                    c._stats.blooms.pop(colname, None)
                    c._stats.distinct.pop(colname, None)
            td._codec = None
            td.pk_index = None
            self._bump(td)

    # -- the write path: committed effects, keys, row locators ---------------
    def alloc_rowids(self, name: str, n: int) -> list[int]:
        td = self.table(name)
        with self._lock:
            r0 = td.next_rowid
            td.next_rowid += n
            return list(range(r0, r0 + n))

    def extract_row(self, td: TableData, chunk: Chunk, ri: int) -> dict:
        """One row in storage-logical form (strings decoded, numerics
        physical), the inverse of the seal path's encode."""
        from ..sql.rowenc import ROWID
        row: dict = {}
        for col in td.schema.columns:
            cn = col.name
            if not chunk.valid[cn][ri]:
                row[cn] = None
            elif col.type.uses_dictionary:
                row[cn] = td.dictionaries[cn].values[int(chunk.data[cn][ri])]
            else:
                row[cn] = chunk.data[cn][ri].item()
        if chunk.rowid is not None:
            row[ROWID] = int(chunk.rowid[ri])
        return row

    def row_key(self, td: TableData, chunk: Chunk, ri: int) -> bytes:
        """The KV key bytes for one stored row version (pk columns
        decoded and run through the table's order-preserving codec)."""
        codec = td.codec
        if codec.synthetic_pk:
            return codec.key_from_pk((int(chunk.rowid[ri]),))
        pk = []
        for cn in codec.pk_cols:
            col = td.schema.column(cn)
            v = chunk.data[cn][ri]
            if col.type.uses_dictionary:
                pk.append(td.dictionaries[cn].values[int(v)])
            else:
                pk.append(v.item())
        return codec.key_from_pk(tuple(pk))

    def ensure_pk_index(self, name: str) -> dict:
        """Build (lazily) the pk-key -> (chunk, row) locator for LIVE
        rows. The DML path needs it to tombstone superseded versions;
        bulk-ingested tables only pay for it if they are ever DML'd."""
        td = self.table(name)
        with self._lock:
            if td.pk_index is not None:
                return td.pk_index
            idx: dict[bytes, tuple[int, int]] = {}
            for ci, chunk in enumerate(td.chunks):
                ris = np.nonzero(chunk.mvcc_del == MAX_TS_INT)[0]
                batch = self._batch_row_keys(td, chunk, ris)
                if batch is not None:
                    idx.update(zip(batch, zip([ci] * len(ris),
                                              ris.tolist())))
                else:
                    for ri in ris:
                        idx[self.row_key(td, chunk, int(ri))] = \
                            (ci, int(ri))
            td.pk_index = idx
            return idx

    def _batch_row_keys(self, td: TableData, chunk: Chunk,
                        ris: np.ndarray):
        """Bulk pk-key encode; the keys equal the row_key loop's byte for
        byte. Keys of int-family columns (synthetic rowids,
        INT/DATE/TIMESTAMP/DECIMAL/BOOL/INTERVAL pks, any count) go
        through storage/keys.py encode_int_keys, a numpy pass; a single
        STRING pk column through the native encoder (native/keyenc.cpp),
        whose failed build raises. None = another shape (a float pk
        column, or a string among several): the caller takes the row_key
        loop."""
        from . import keys as K
        codec = td.codec
        if codec.synthetic_pk:
            cols = [chunk.rowid[ris]]
        elif len(codec.pk_cols) == 1 and td.schema.column(
                codec.pk_cols[0]).type.family == Family.STRING:
            from .. import native
            cn = codec.pk_cols[0]
            strs = td.dictionaries[cn].decode_array(chunk.data[cn][ris])
            return native.batch_encode_str_keys(
                K.table_prefix(codec.table_id), strs)
        else:
            cols = []
            for cn in codec.pk_cols:
                col = td.schema.column(cn)
                if col.type.uses_dictionary or col.type.family not in (
                        Family.INT, Family.DATE, Family.TIMESTAMP,
                        Family.DECIMAL, Family.BOOL, Family.INTERVAL):
                    return None
                cols.append(chunk.data[cn][ris])
        return K.encode_int_keys(K.table_prefix(codec.table_id), cols)

    def apply_committed(self, name: str, ops: list, ts: Timestamp) -> None:
        """Publish one committed txn's effects on this table.

        ops: ordered list of ("put", key_bytes, row_dict) and
        ("del", key_bytes). A put supersedes (tombstones) the prior
        live version of the same key; rows carry storage-logical
        values (see extract_row). The scan plane only ever sees
        resolved, committed versions."""
        self.apply_committed_batch(name, [(ops, ts.to_int())])

    def apply_committed_batch(self, name: str, batches: list) -> None:
        """Publish many committed txns' effects in one sealed chunk.

        batches: [(ops, tsi)] in ascending commit-timestamp order. A row
        superseded by a later batch still publishes, with its
        [ts, del_ts) visibility window, so historical reads see it."""
        td = self.table(name)
        from ..sql.rowenc import ROWID
        with self._lock:
            idx = self.ensure_pk_index(name)
            new_rows: list = []  # [key, row|None, tsi, del_tsi]
            new_keys: dict[bytes, int] = {}
            for ops, tsi in batches:
                for op in ops:
                    kind, key = op[0], op[1]
                    pos = idx.pop(key, None)
                    if pos is not None:
                        ci, ri = pos
                        td.chunks[ci].mvcc_del[ri] = tsi
                    npos = new_keys.pop(key, None)
                    if npos is not None:
                        if new_rows[npos][2] == tsi:
                            # superseded within one txn: never visible
                            new_rows[npos][1] = None
                        else:
                            new_rows[npos][3] = tsi
                    if kind == "put":
                        row = dict(op[2])
                        if td.codec.synthetic_pk and ROWID not in row:
                            row[ROWID] = td.next_rowid
                            td.next_rowid += 1
                        new_keys[key] = len(new_rows)
                        new_rows.append([key, row, tsi, MAX_TS_INT])
            emit = [e for e in new_rows if e[1] is not None]
            rowids = []
            for _k, row, _t, _d in emit:
                rid = int(row.get(ROWID, 0))
                if not rid:
                    rid = td.next_rowid
                    td.next_rowid += 1
                rowids.append(rid)
            # sealed chunks of at most chunk_rows rows (the reference's
            # open chunk seals there; a metamorphic constant in tests)
            step = max(int(td.chunk_rows), 1)
            cuts = range(0, len(emit), step)
            base = len(td.chunks)
            for j, lo in enumerate(cuts):
                part = emit[lo:lo + step]
                chunk = self.rows_chunk(
                    td, [r for _, r, _, _ in part],
                    np.asarray([t for _, _, t, _ in part], dtype=np.int64),
                    np.asarray([d for _, _, _, d in part], dtype=np.int64),
                    np.asarray(rowids[lo:lo + step], dtype=np.int64))
                chunk.finalize_stats()
                td.chunks.append(chunk)
                for i, (k, _row, _tsi, dts) in enumerate(part):
                    if dts == MAX_TS_INT:
                        idx[k] = (base + j, i)
            gen = td.generation
            self._bump(td)
            for j, lo in enumerate(cuts):
                self._extend_locators(
                    td, [r for _, r, _, _ in emit[lo:lo + step]], base + j,
                    gen if j == 0 else td.generation)

    @staticmethod
    def _extend_locators(td: TableData, rows: list, base_ci: int,
                         gen: int) -> None:
        """Keep warm row locators valid across a publish (the new rows
        sit at (base_ci, i)) instead of forcing an O(table) rebuild per
        DML statement: the scan-plane analogue of the write path
        maintaining index entries in place. A sorted locator is copied,
        never changed in place: a reader may hold the old list. ``gen``
        is the generation before the publish; the kept locators move to
        the table's new one."""
        for cache, sort in ((td.sec_index_cache, False),
                            (td.sorted_index_cache, True)):
            for cols, (g, loc) in list(cache.items()):
                if g != gen:
                    del cache[cols]
                    continue
                if sort:
                    loc = list(loc)
                for i, row in enumerate(rows):
                    vals = tuple(row.get(cn, td.column_defaults.get(cn))
                                 for cn in cols)
                    if any(v is None for v in vals):
                        continue
                    if sort:
                        bisect.insort(loc, (vals, base_ci, i),
                                      key=lambda e: e[0])
                    else:
                        loc.setdefault(vals, []).append((base_ci, i))
                cache[cols] = (td.generation, loc)

    @staticmethod
    def rows_chunk(td: TableData, rows: list, mvcc_ts, mvcc_del,
                   rowid) -> Chunk:
        """Storage-logical row dicts as one chunk (no seal-time stats):
        strings are dictionary-encoded, DECIMAL ints are already-scaled
        physical values (floats are logical and get scaled). A column a
        row lacks takes its ALTER TABLE default, else NULL."""
        n = len(rows)
        data, vmap = {}, {}
        for col in td.schema.columns:
            dv = td.column_defaults.get(col.name)
            vals = [r.get(col.name, dv) for r in rows]
            vmap[col.name] = np.array([x is not None for x in vals],
                                      dtype=bool)
            if col.type.uses_dictionary:
                d = td.dictionaries[col.name]
                arr = np.fromiter(
                    (d.encode(x) if x is not None else 0 for x in vals),
                    dtype=np.int32, count=n)
            elif col.type.family == Family.DECIMAL:
                scale = 10 ** col.type.scale
                arr = np.fromiter(
                    (0 if x is None else
                     x if isinstance(x, (int, np.integer)) else
                     int(round(float(x) * scale)) for x in vals),
                    dtype=np.int64, count=n)
            else:
                arr = np.array([x if x is not None else 0 for x in vals],
                               dtype=col.type.np_dtype)
            data[col.name] = arr
        return Chunk(data=data, valid=vmap, mvcc_ts=mvcc_ts,
                     mvcc_del=mvcc_del, n=n, rowid=rowid)

    def insert_versions(self, name: str,
                        versions: list[tuple[dict, int, int]]) -> int:
        """Bulk ingest with explicit MVCC bounds: each element is (row,
        mvcc_ts_int, mvcc_del_int), rows storage-logical. Used when the
        scan plane is materialized from committed range data
        (exec/dml.py refresh_table_from_ranges): the columnstore must
        reproduce the range plane's version history, not re-stamp it,
        or open snapshots and AS OF SYSTEM TIME reads go wrong. Rows go
        in sealed chunks of at most ``chunk_rows``; synthetic-pk rowids
        come from the decoded keys, and later inserts allocate past
        them."""
        from ..sql.rowenc import ROWID
        td = self.table(name)
        with self._lock:
            if not versions:
                self._bump(td)
                return 0
            step = max(int(td.chunk_rows), 1)
            for lo in range(0, len(versions), step):
                part = versions[lo:lo + step]
                rowids = []
                for r, _t, _d in part:
                    rid = r.get(ROWID)
                    if rid is None:
                        rid = td.next_rowid
                        td.next_rowid += 1
                    rowids.append(int(rid))
                td.next_rowid = max(td.next_rowid, max(rowids) + 1)
                chunk = self.rows_chunk(
                    td, [r for r, _t, _d in part],
                    np.asarray([t for _r, t, _d in part], dtype=np.int64),
                    np.asarray([d for _r, _t, d in part], dtype=np.int64),
                    np.asarray(rowids, dtype=np.int64))
                chunk.finalize_stats()
                td.chunks.append(chunk)
            td.pk_index = None
            self._bump(td)
        return len(versions)

    # -- MVCC windows and bulk rows (BACKUP/RESTORE, changefeed catch-up) ---
    def mvcc_window(self, name: str, lo: int, hi: int) -> list:
        """The MVCC window (lo, hi] of a table as whole-chunk masks:
        [(chunk, put, deleted)], ``put`` the rows written in the window
        and live at hi (lo < mvcc_ts <= hi < mvcc_del), ``deleted`` the
        rows live at lo whose deletion falls in it (mvcc_ts <= lo <
        mvcc_del <= hi), both row-index arrays. Chunks with neither are
        left out. The window algebra of the reference's backup export
        (jobs/backup.py), one numpy pass a chunk."""
        td = self.table(name)
        out = []
        with self._lock:
            for chunk in td.chunks:
                ts, dl = chunk.mvcc_ts, chunk.mvcc_del
                put = np.flatnonzero((ts > lo) & (ts <= hi) & (dl > hi))
                gone = np.flatnonzero((ts <= lo) & (dl > lo) & (dl <= hi))
                if put.size or gone.size:
                    out.append((chunk, put, gone))
        return out

    def changes_since(self, name: str, since: int) -> list:
        """Every row version written after ``since`` and every deletion
        after it, per chunk: [(chunk, written, deleted)] as row-index
        arrays (the changefeed's catch-up scan)."""
        td = self.table(name)
        out = []
        with self._lock:
            for chunk in td.chunks:
                dl = chunk.mvcc_del
                put = np.flatnonzero(chunk.mvcc_ts > since)
                gone = np.flatnonzero((dl != MAX_TS_INT) & (dl > since))
                if put.size or gone.size:
                    out.append((chunk, put, gone))
        return out

    @staticmethod
    def chunk_column(td: TableData, chunk: Chunk, cn: str,
                     idx: np.ndarray) -> tuple:
        """(physical values, validity) of column ``cn`` at rows ``idx`` of
        one chunk; a chunk the ALTER TABLE backfill has not reached gives
        the column's default (else NULL)."""
        if cn in chunk.data:
            return chunk.data[cn][idx], chunk.valid[cn][idx]
        col = td.schema.column(cn)
        n = len(idx)
        dv = td.column_defaults.get(cn)
        if dv is None:
            dt = np.int32 if col.type.uses_dictionary else col.type.np_dtype
            return np.zeros(n, dtype=dt), np.zeros(n, dtype=bool)
        if col.type.uses_dictionary:
            return (np.full(n, td.dictionaries[cn].encode(dv), np.int32),
                    np.ones(n, dtype=bool))
        if col.type.family == Family.DECIMAL \
                and not isinstance(dv, (int, np.integer)):
            dv = int(round(float(dv) * 10 ** col.type.scale))
        return np.full(n, dv, dtype=col.type.np_dtype), np.ones(n, bool)

    def rows_at(self, td: TableData, chunk: Chunk, idx: np.ndarray) -> list:
        """Rows ``idx`` of one chunk as storage-logical dicts, equal to
        ``extract_row``'s, decoded a column at a time."""
        from ..sql.rowenc import ROWID
        cols: list = []
        for col in td.schema.columns:
            data, valid = self.chunk_column(td, chunk, col.name, idx)
            d = td.dictionaries.get(col.name)
            if d is None:
                vals = data.tolist()
            else:   # an empty dictionary: every row of the column is NULL
                vals = d.decode_array(data).tolist() if len(d) \
                    else [None] * len(idx)
            cols.append([v if ok else None
                         for v, ok in zip(vals, valid.tolist())])
        names = [c.name for c in td.schema.columns]
        rows = [dict(zip(names, r)) for r in zip(*cols)]
        if chunk.rowid is not None:
            for row, rid in zip(rows, chunk.rowid[idx].tolist()):
                row[ROWID] = rid
        return rows

    def keys_at(self, td: TableData, chunk: Chunk, idx: np.ndarray) -> list:
        """The KV keys of rows ``idx`` of one chunk (``row_key``'s bytes):
        one numpy pass for int-family keys, else a loop."""
        got = self._batch_row_keys(td, chunk, idx)
        if got is not None:
            return got
        return [self.row_key(td, chunk, int(ri)) for ri in idx]

    def insert_rows(self, name: str, data: dict, valid: dict,
                    rowid: np.ndarray, ts: Timestamp) -> int:
        """Bulk insert of physical column arrays that keeps the given
        rowids (RESTORE's full layer), in sealed chunks of at most
        ``chunk_rows`` rows committed at ``ts``; ``next_rowid`` moves
        past the largest, so later inserts never reuse one. String
        columns carry codes into the table's own dictionaries."""
        td = self.table(name)
        n = len(rowid)
        step = max(int(td.chunk_rows), 1)
        tsi = ts.to_int()
        with self._lock:
            for lo in range(0, n, step):
                sl = slice(lo, lo + step)
                m = len(rowid[sl])
                self.append_chunk(
                    name, {c: v[sl] for c, v in data.items()},
                    {c: v[sl] for c, v in valid.items()},
                    np.full(m, tsi, dtype=np.int64),
                    np.full(m, MAX_TS_INT, dtype=np.int64),
                    rowid=rowid[sl])
        return n

    def ensure_secondary_index(self, name: str, cols: tuple) -> dict:
        """Build (lazily, generation-cached) the value-tuple ->
        [(chunk, row), ...] locator over ALL row versions of `cols`.
        Rows with a NULL in any indexed column are excluded (SQL
        uniqueness and equality both ignore NULLs). Lookups filter
        positions by MVCC visibility at their read timestamp."""
        td = self.table(name)
        with self._lock:
            cached = td.sec_index_cache.get(cols)
            if cached is not None and cached[0] == td.generation:
                return cached[1]
            idx = self._numeric_locator(td, cols)
            if idx is None:
                idx = {}
                for ci, vals, ri in self._index_rows(td, cols):
                    idx.setdefault(vals, []).append((ci, ri))
            td.sec_index_cache = {k: v for k, v in
                                  td.sec_index_cache.items()
                                  if v[0] == td.generation}
            td.sec_index_cache[cols] = (td.generation, idx)
            return idx

    def ensure_sorted_index(self, name: str, cols: tuple) -> list:
        """Sorted [(vals, chunk, row)] over ALL row versions of `cols`
        (generation-cached): binary search gives range bounds, ordered
        iteration gives index order (the host-side analogue of an
        ordered KV index scan). NULL rows are excluded."""
        td = self.table(name)
        with self._lock:
            cached = td.sorted_index_cache.get(cols)
            if cached is not None and cached[0] == td.generation:
                return cached[1]
            entries = [(vals, ci, ri)
                       for ci, vals, ri in self._index_rows(td, cols)]
            entries.sort(key=lambda e: e[0])
            td.sorted_index_cache = {k: v for k, v in
                                     td.sorted_index_cache.items()
                                     if v[0] == td.generation}
            td.sorted_index_cache[cols] = (td.generation, entries)
            return entries

    @staticmethod
    def _numeric_locator(td: TableData, cols: tuple):
        """ensure_secondary_index's locator built with numpy when every
        column is stored as integers or booleans (no dictionary): the
        same dict, keys in the order of their first row and positions in
        row order, without a Python step per row. None: another column
        type, the caller's row loop builds it."""
        for cn in cols:
            if td.schema.column(cn).type.uses_dictionary or any(
                    c.data[cn].dtype.kind not in "iub" for c in td.chunks):
                return None
        cis, ris, keys = [], [], [[] for _ in cols]
        for ci, chunk in enumerate(td.chunks):
            valid = np.ones(chunk.n, dtype=bool)
            for cn in cols:
                valid &= chunk.valid[cn]
            rows = np.nonzero(valid)[0]
            cis.append(np.full(len(rows), ci, dtype=np.int64))
            ris.append(rows)
            for j, cn in enumerate(cols):
                keys[j].append(chunk.data[cn][rows])
        if not cis or not sum(len(r) for r in ris):
            return {}
        ci, ri = np.concatenate(cis), np.concatenate(ris)
        keys = [np.concatenate(k) for k in keys]
        order = (np.argsort(keys[0], kind="stable") if len(keys) == 1
                 else np.lexsort(keys[::-1]))
        sk = [k[order] for k in keys]
        n = len(order)
        new = np.zeros(n, dtype=bool)
        new[0] = True
        for k in sk:
            new[1:] |= k[1:] != k[:-1]
        starts = np.nonzero(new)[0]
        ends = np.append(starts[1:], n)
        # groups in the order of their first row (a stable sort puts
        # that row first in its group); the dict is built by one
        # dict(zip()) over slices made with map, since a comprehension
        # over millions of groups spends most of its time in the cyclic
        # collector's passes
        groups = np.argsort(order[starts], kind="stable")
        pos = list(zip(ci[order].tolist(), ri[order].tolist()))
        vals = zip(*(k[starts][groups].tolist() for k in sk))
        return dict(zip(vals, map(pos.__getitem__, map(
            slice, starts[groups].tolist(), ends[groups].tolist()))))

    @staticmethod
    def _index_rows(td: TableData, cols: tuple):
        """(chunk, value tuple, row) of every row version whose `cols`
        are all non-NULL, values storage-logical (strings decoded)."""
        for ci, chunk in enumerate(td.chunks):
            valid = np.ones(chunk.n, dtype=bool)
            arrs = []
            for cn in cols:
                valid &= chunk.valid[cn]
                col = td.schema.column(cn)
                if col.type.uses_dictionary:
                    arrs.append(td.dictionaries[cn].decode_array(
                        chunk.data[cn]))
                else:
                    arrs.append(chunk.data[cn].tolist())
            ris = np.nonzero(valid)[0].tolist()
            for ri in ris:
                yield ci, tuple(a[ri] for a in arrs), ri

    # -- statistics ----------------------------------------------------------
    def analyze(self, name: str):
        """ANALYZE: exact per-column stats over live rows (sql/stats)."""
        from ..sql.stats import analyze_columns
        td = self.table(name)
        with self._lock:
            td.stats = analyze_columns(td)
            td.stats_generation = td.generation
            return td.stats

    def sketch_stats(self, name: str):
        """Planner stats derived from seal-time chunk summaries
        (sql/stats.sketch_table_stats) — cached per table generation
        like _ts_hi_locked, because the merge walks every chunk's
        sketch registers. Never seals: open rows simply don't
        contribute (the execution path seals before planning, so in
        practice the summaries cover everything)."""
        from ..sql.stats import sketch_table_stats
        td = self.table(name)
        with self._lock:
            ck = ("__sketch_stats__",)
            hit = td.key_distinct_cache.get(ck)
            if hit is not None and hit[0] == td.generation:
                return hit[1]
            st = sketch_table_stats(td)
            td.key_distinct_cache[ck] = (td.generation, st)
            return st

    def _distinct_under(self, td: TableData, cols: tuple,
                        row_mask_fn) -> tuple[int, int]:
        """(distinct combined-key count, non-NULL-key row count) over
        rows selected by row_mask_fn(chunk) -> bool mask."""
        parts = []
        nonnull_rows = 0
        for chunk in td.chunks:
            sel = row_mask_fn(chunk)
            arrs = [chunk.data[c][sel] for c in cols]
            vals = [chunk.valid[c][sel] for c in cols]
            # NULL keys never join; exclude them from uniqueness
            ok = np.ones(int(sel.sum()), dtype=bool)
            for v in vals:
                ok &= v
            nonnull_rows += int(ok.sum())
            parts.append(np.stack([a[ok] for a in arrs], axis=1)
                         if arrs else np.zeros((0, 0)))
        if parts and sum(p.shape[0] for p in parts):
            allk = np.concatenate(parts, axis=0)
            # one key column: a plain sort, several times faster than
            # np.unique over rows (a structured view)
            distinct = int(len(np.unique(allk[:, 0]) if allk.shape[1] == 1
                               else np.unique(allk, axis=0)))
        else:
            distinct = 0
        return distinct, nonnull_rows

    def key_distinct(self, name: str, cols: tuple) -> tuple[int, int]:
        """(distinct combined-key count, non-NULL-key live row count)
        over CURRENTLY-live rows — the planner's build-side swap
        heuristic. Cached per table generation. For the correctness
        guard use keys_unique_for_read (snapshot-aware)."""
        td = self.table(name)
        with self._lock:
            hit = td.key_distinct_cache.get(cols)
            if hit is not None and hit[0] == td.generation:
                return hit[1], hit[2]
            distinct, nonnull = self._distinct_under(
                td, cols, lambda c: c.mvcc_del == MAX_TS_INT)
            td.key_distinct_cache[cols] = (td.generation, distinct,
                                           nonnull)
            return distinct, nonnull

    def _ts_hi_locked(self, td: TableData) -> int:
        """Max MVCC event timestamp (insert or delete) in the table,
        cached per generation. A read at or above it sees exactly the
        currently-live rows, so snapshot-dependent measurements become
        generation-cacheable — the steady state of every prepared
        statement re-executed against unmodified tables."""
        ck = ("__ts_hi__",)
        hit = td.key_distinct_cache.get(ck)
        if hit is not None and hit[0] == td.generation:
            return hit[1]
        hi = 0
        for chunk in td.chunks:
            if chunk.n:
                hi = max(hi, int(chunk.mvcc_ts.max()))
                dels = chunk.mvcc_del[chunk.mvcc_del != MAX_TS_INT]
                if len(dels):
                    hi = max(hi, int(dels.max()))
        td.key_distinct_cache[ck] = (td.generation, hi)
        return hi

    def keys_unique_for_read(self, name: str, cols: tuple,
                             read_ts_int: int) -> bool:
        """Snapshot-aware uniqueness: are the keys unique among the
        rows VISIBLE at read_ts (the rows a scan at that timestamp
        joins)? Tiers: (1) unique across ALL versions (cacheable per
        generation — every snapshot is a subset, so any snapshot is
        unique too) accepts immediately; (2) read_ts at/above the
        table's last MVCC event sees exactly the currently-live rows,
        so that answer caches per generation too; (3) historical
        read_ts inside the table's write history pays the exact
        snapshot computation."""
        td = self.table(name)
        with self._lock:
            allkey = ("__allversions__",) + cols
            hit = td.key_distinct_cache.get(allkey)
            if hit is None or hit[0] != td.generation:
                d, n = self._distinct_under(
                    td, cols, lambda c: np.ones(c.n, dtype=bool))
                td.key_distinct_cache[allkey] = (td.generation, d, n)
            else:
                _, d, n = hit
            if d == n:
                return True
            if read_ts_int >= self._ts_hi_locked(td):
                nowkey = ("__livenow_unique__",) + cols
                hit = td.key_distinct_cache.get(nowkey)
                if hit is None or hit[0] != td.generation:
                    d, n = self._distinct_under(
                        td, cols, lambda c: c.live_mask(read_ts_int))
                    td.key_distinct_cache[nowkey] = (td.generation,
                                                     d, n)
                else:
                    _, d, n = hit
                return d == n
            d, n = self._distinct_under(
                td, cols, lambda c: c.live_mask(read_ts_int))
            return d == n

    def key_max_multiplicity(self, name: str, cols: tuple,
                             read_ts_int: int,
                             include_null_group: bool = False) -> int:
        """Max duplicate count of (cols) among rows visible at read_ts.
        Two consumers with different NULL semantics: the hash join's
        expansion factor excludes NULL-keyed rows (they never join,
        the default); GROUP BY accumulator sizing sets
        include_null_group because NULL keys DO form a group. Cached
        per generation when read_ts sees the table's final state
        (same reasoning as keys_unique_for_read tier 2). A historical
        read_ts (AS OF SYSTEM TIME) sizes a GROUP BY by the count over
        ALL versions, cached per generation too: every snapshot is a
        subset, so it bounds each snapshot's groups, and an AS OF
        '-10s' that reads at a new timestamp each statement reuses it.
        A join's expansion stays exact at the snapshot (the
        all-versions count of a row updated many times could pass the
        limit past which the join is refused)."""
        td = self.table(name)
        with self._lock:
            mk = ("__maxmult__", include_null_group) + cols
            at = read_ts_int
            if read_ts_int < self._ts_hi_locked(td):
                if not include_null_group:
                    return self._key_max_multiplicity_locked(
                        td, cols, read_ts_int)
                mk = ("__maxmult_allversions__",) + cols
                at = None
            hit = td.key_distinct_cache.get(mk)
            if hit is not None and hit[0] == td.generation:
                return hit[1]
            k = self._key_max_multiplicity_locked(
                td, cols, at, include_null_group)
            td.key_distinct_cache[mk] = (td.generation, k)
            return k

    @staticmethod
    def _key_max_multiplicity_locked(td: TableData, cols: tuple,
                                     read_ts_int: int | None,
                                     include_null_group: bool = False
                                     ) -> int:
        """None for read_ts_int: over every version."""
        parts: list[list[np.ndarray]] = [[] for _ in cols]
        null_rows = 0
        for chunk in td.chunks:
            live = (np.ones(chunk.n, dtype=bool) if read_ts_int is None
                    else chunk.live_mask(read_ts_int))
            m = live.copy()
            for c in cols:
                m = m & chunk.valid[c]
            if include_null_group:
                null_rows += int((live & ~m).sum())
            for i, c in enumerate(cols):
                parts[i].append(chunk.data[c][m])
        if not parts or not parts[0]:
            return null_rows
        cat = [np.concatenate(p) for p in parts]
        n = len(cat[0])
        if n == 0:
            return null_rows
        dense = ColumnStore._dense_key_counts(cat, n)
        if dense is not None:
            return max(int(dense.max()), null_rows)
        order = np.lexsort(tuple(reversed(cat)))
        change = np.zeros(n, dtype=bool)
        change[0] = True
        for c in cat:
            s = c[order]
            change[1:] |= s[1:] != s[:-1]
        starts = np.flatnonzero(change)
        runs = np.diff(np.append(starts, n))
        return max(int(runs.max()), null_rows)

    @staticmethod
    def _dense_key_counts(cat: list, n: int):
        """Rows per key by one bincount when every key column holds
        integers (dictionary codes among them) whose value ranges
        multiply to at most max(n, 2^20) slots: a GROUP BY over a few
        codes (TPC-H Q1's flags) costs a pass over the rows instead of
        a sort. None: the caller sorts."""
        if any(c.dtype.kind not in "iub" for c in cat):
            return None
        limit = max(n, 1 << 20)
        idx = np.zeros(n, dtype=np.int64)
        slots = 1
        for c in cat:
            lo, hi = int(c.min()), int(c.max())
            slots *= hi - lo + 1
            if slots > limit:
                return None
            idx = idx * (hi - lo + 1) + (c.astype(np.int64) - lo)
        return np.bincount(idx, minlength=slots)

    def key_int_range(self, name: str, col: str):
        """(min, max, count) of an int-family key column over ALL
        versions (NULLs excluded), or None when empty. Sizes the
        direct-address join table (ops/join.py): the all-versions
        range is a superset of every snapshot's, so a table sized by
        it is correct at any read ts — and the result caches per
        generation (like key_distinct_cache)."""
        td = self.table(name)
        with self._lock:
            ck = ("__int_range__", col)
            hit = td.key_distinct_cache.get(ck)
            if hit is not None and hit[0] == td.generation:
                return hit[1]
            lo = hi = None
            n = 0
            for chunk in td.chunks:
                m = chunk.valid[col]
                if not m.any():
                    continue
                vals = chunk.data[col][m]
                cmin, cmax = int(vals.min()), int(vals.max())
                lo = cmin if lo is None else min(lo, cmin)
                hi = cmax if hi is None else max(hi, cmax)
                n += int(m.sum())
            out = None if lo is None else (lo, hi, n)
            td.key_distinct_cache[ck] = (td.generation, out)
            return out

    # -- GC ------------------------------------------------------------------
    def gc_pending(self, name: str, threshold: Timestamp) -> int:
        """The row versions a GC pass at ``threshold`` would remove."""
        td = self.table(name)
        ti = threshold.to_int()
        with self._lock:
            return sum(int((c.mvcc_del <= ti).sum()) for c in td.chunks)

    def record_gc_threshold(self, name: str, threshold: Timestamp) -> None:
        """A GC pass's threshold without its compaction: reads below it
        are refused."""
        td = self.table(name)
        with self._lock:
            td.gc_threshold = max(td.gc_threshold, threshold.to_int())

    def gc(self, name: str, threshold: Timestamp) -> int:
        """Drop the row versions deleted at or before ``threshold`` (the
        reference's MVCC GC queue, kvserver/mvcc_gc_queue.go) and record
        the threshold: reads below it are refused. A chunk that loses
        rows is rebuilt with fresh write-time summaries, so row
        positions move and the table takes a new generation; a pass
        that removes nothing leaves the chunks and the generation (and
        so every cached upload and plan) as they were."""
        td = self.table(name)
        ti = threshold.to_int()
        removed = 0
        with self._lock:
            new_chunks = []
            for chunk in td.chunks:
                keep = chunk.mvcc_del > ti
                drop = chunk.n - int(keep.sum())
                if drop == 0:
                    new_chunks.append(chunk)
                    continue
                removed += drop
                if keep.any():
                    nc = Chunk(
                        data={k: v[keep] for k, v in chunk.data.items()},
                        valid={k: v[keep] for k, v in chunk.valid.items()},
                        mvcc_ts=chunk.mvcc_ts[keep],
                        mvcc_del=chunk.mvcc_del[keep],
                        n=int(keep.sum()),
                        rowid=(chunk.rowid[keep]
                               if chunk.rowid is not None else None))
                    nc.finalize_stats()
                    new_chunks.append(nc)
            td.gc_threshold = max(td.gc_threshold, ti)
            if removed:
                td.chunks = new_chunks
                td.pk_index = None
                self._bump(td)
        return removed
