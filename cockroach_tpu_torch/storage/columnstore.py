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
host). This module is the scan plane; the reference's row-oriented KV
layer (point reads, the write path) is not part of this package.
"""

from __future__ import annotations

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
    # generation bumps on every mutation; device caches key on it
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

    @property
    def row_count(self) -> int:
        return sum(c.n for c in self.chunks)


class ColumnStore:
    """All tables of one store (one node's data plane)."""

    def __init__(self, chunk_rows: int | None = None):
        if chunk_rows is None:
            chunk_rows = 1 << 20
        self._lock = threading.RLock()
        self.tables: dict[str, TableData] = {}
        self.chunk_rows = chunk_rows
        # monotonic: a dropped table's id is never reused, so its
        # orphaned KV rows can never alias a new table's keyspace
        # (the reference keeps descriptor ids monotonic the same way)
        self._next_table_id = 100

    def alloc_table_id(self) -> int:
        with self._lock:
            tid = self._next_table_id
            self._next_table_id += 1
            return tid

    # -- DDL ---------------------------------------------------------------
    def create_table(self, schema: TableSchema) -> TableData:
        with self._lock:
            if schema.name in self.tables:
                raise ValueError(f"table {schema.name!r} exists")
            self._next_table_id = max(self._next_table_id,
                                      schema.table_id + 1)
            td = TableData(schema=schema, chunk_rows=self.chunk_rows)
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
            defaults = getattr(td, "column_defaults", {})
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
                     mvcc_del: np.ndarray) -> None:
        """Append one sealed chunk of already-physical column arrays
        with explicit MVCC bounds (bulk ingest, and storage/transfer.py
        carrying another store's row versions over unchanged)."""
        td = self.table(name)
        n = len(mvcc_ts)
        with self._lock:
            rid0 = td.next_rowid
            td.next_rowid += n
            chunk = Chunk(data=data, valid=valid,
                          mvcc_ts=np.asarray(mvcc_ts, dtype=np.int64),
                          mvcc_del=np.asarray(mvcc_del, dtype=np.int64),
                          n=n,
                          rowid=np.arange(rid0, rid0 + n, dtype=np.int64))
            chunk.finalize_stats()
            td.chunks.append(chunk)
            td.generation += 1

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
        (same reasoning as keys_unique_for_read tier 2)."""
        td = self.table(name)
        with self._lock:
            cacheable = read_ts_int >= self._ts_hi_locked(td)
            mk = ("__maxmult__", include_null_group) + cols
            if cacheable:
                hit = td.key_distinct_cache.get(mk)
                if hit is not None and hit[0] == td.generation:
                    return hit[1]
            k = self._key_max_multiplicity_locked(
                td, cols, read_ts_int, include_null_group)
            if cacheable:
                td.key_distinct_cache[mk] = (td.generation, k)
            return k

    @staticmethod
    def _key_max_multiplicity_locked(td: TableData, cols: tuple,
                                     read_ts_int: int,
                                     include_null_group: bool = False
                                     ) -> int:
        parts: list[list[np.ndarray]] = [[] for _ in cols]
        null_rows = 0
        for chunk in td.chunks:
            live = chunk.live_mask(read_ts_int)
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
        order = np.lexsort(tuple(reversed(cat)))
        change = np.zeros(n, dtype=bool)
        change[0] = True
        for c in cat:
            s = c[order]
            change[1:] |= s[1:] != s[:-1]
        starts = np.flatnonzero(change)
        runs = np.diff(np.append(starts, n))
        return max(int(runs.max()), null_rows)

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
