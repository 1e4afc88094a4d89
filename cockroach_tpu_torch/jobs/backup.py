"""BACKUP / RESTORE jobs: table data to and from a backup collection.

The port of cockroach_tpu/jobs/backup.py (the reference's
pkg/ccl/backupccl). BACKUP writes per-table data files and a manifest;
a BACKUP INTO a collection that already holds one appends an
INCREMENTAL layer with only the MVCC window since the previous layer
(rows written since, keys deleted since). RESTORE applies the full layer
and then each incremental one in order. Both are durable jobs with
per-table checkpoints (backup_job.go:230-266), so a crashed backup
resumes without exporting a finished table again, and at the timestamp
its first run fixed.

The window is computed a chunk at a time over whole arrays
(``ColumnStore.mvcc_window``), not a row at a time. A data file is an
``.npz`` of typed arrays of the table's physical columns: ``d_<col>``
values (a string column's codes into the file's own dictionary, UTF-8
bytes ``s_<col>`` cut at offsets ``o_<col>``), ``v_<col>`` validity
where a value is NULL, ``__rowid``; the deleted keys as the same arrays
of the primary-key columns, prefixed ``x_``, and ``__xrowid``. Nothing
is pickled: the package that wrote a file reads it back. RESTORE takes
the full layer in through the bulk insert that keeps rowids
(``ColumnStore.insert_rows``), then each incremental layer's puts and
then its deletes through ``apply_committed``, all at one restore
timestamp.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from ..storage.hlc import Timestamp
from .registry import JobContext, _CrashForTesting

BACKUP_JOB = "backup"
RESTORE_JOB = "restore"

MANIFEST = "BACKUP_MANIFEST.json"


def _load_manifest(dest: str) -> dict:
    path = os.path.join(dest, MANIFEST)
    if not os.path.exists(path):
        return {"layers": []}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _save_manifest(dest: str, m: dict) -> None:
    path = os.path.join(dest, MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(m, f, sort_keys=True, indent=1)
    os.replace(tmp, path)  # atomic: a torn manifest is unreadable


def _strings_out(values: list) -> tuple:
    """(UTF-8 bytes, int64 offsets) of a list of strings."""
    enc = [v.encode() for v in values]
    off = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in enc], out=off[1:])
    return np.frombuffer(b"".join(enc), dtype=np.uint8), off


def _strings_in(raw: np.ndarray, off: np.ndarray) -> list:
    buf = raw.tobytes()
    o = off.tolist()
    return [buf[a:b].decode() for a, b in zip(o[:-1], o[1:])]


class BackupResumer:
    """payload: {tables, dest}; progress: {end_ts, tables_done}."""

    def __init__(self, engine, crash_after_table: Optional[int] = None):
        self.engine = engine
        self.crash_after_table = crash_after_table

    def resume(self, ctx: JobContext) -> None:
        p = ctx.payload
        dest = p["dest"]
        os.makedirs(dest, exist_ok=True)
        manifest = _load_manifest(dest)
        prev_end = manifest["layers"][-1]["end_ts"] \
            if manifest["layers"] else 0
        prog = ctx.progress()
        # the backup timestamp is fixed once (at the first run), so a
        # resumed backup stays one consistent snapshot
        end_ts = int(prog.get("end_ts") or
                     self.engine.clock.now().to_int())
        done = set(prog.get("tables_done", []))
        if "end_ts" not in prog:
            ctx.checkpoint({"end_ts": end_ts, "tables_done": []})

        layer_id = len(manifest["layers"])
        layer = {"start_ts": prev_end, "end_ts": end_ts, "tables": {}}
        for table in p["tables"]:
            ctx.check_cancel()
            fname = f"l{layer_id}_{table}.npz"
            if table not in done:
                self._export_table(table, prev_end, end_ts,
                                   os.path.join(dest, fname))
                done.add(table)
                if (self.crash_after_table is not None
                        and len(done) > self.crash_after_table):
                    raise _CrashForTesting()
                ctx.checkpoint({"end_ts": end_ts,
                                "tables_done": sorted(done)},
                               fraction=len(done) / len(p["tables"]))
            desc = self.engine.catalog.get_by_name(table)
            layer["tables"][table] = {
                "file": fname,
                "descriptor": desc.encode().decode()
                if desc is not None else None,
            }
        manifest["layers"].append(layer)
        _save_manifest(dest, manifest)
        # the incremental chain needs every version since end_ts to
        # survive GC until the next layer runs: the chain's protection
        # record moves forward (pkg/kv/kvserver/protectedts)
        pts = self.engine.protectedts
        for rec_id, _ts, _tables, meta in pts.records():
            if meta == dest:
                pts.release(rec_id)
        pts.protect(end_ts, p["tables"], meta=dest)

    def _export_table(self, table: str, lo: int, hi: int,
                      path: str) -> None:
        """One table's MVCC window (lo, hi]: the rows live at hi that were
        written in it, and the keys deleted in it."""
        store = self.engine.store
        td = store.table(table)
        win = store.mvcc_window(table, lo, hi)
        puts = [(c, put) for c, put, _ in win if put.size]
        gone = [(c, g) for c, _, g in win if g.size]
        if gone:
            # a version superseded in the same window is not a deletion
            # of the user's: its key is put again at the newer version
            # (and RESTORE applies puts before deletes)
            put_keys = set()
            for c, put in puts:
                put_keys.update(store.keys_at(td, c, put))
            gone = [(c, g[np.fromiter(
                (k not in put_keys for k in store.keys_at(td, c, g)),
                dtype=bool, count=len(g))]) for c, g in gone]
        arrays: dict = {}
        cols = td.schema.columns
        pk = set(td.codec.pk_cols)
        blocks = {c.name: self._gather(td, c.name, puts, gone
                                       if c.name in pk else [])
                  for c in cols}
        for col in cols:
            (pd, pv), (xd, xv) = blocks[col.name]
            if col.type.uses_dictionary:
                # the file's dictionary holds only the codes it uses
                codes = np.concatenate([pd[pv], xd[xv]])
                used = np.flatnonzero(np.bincount(
                    codes, minlength=len(td.dictionaries[col.name])))
                lut = np.zeros(max(len(td.dictionaries[col.name]), 1),
                               dtype=np.int32)
                lut[used] = np.arange(len(used), dtype=np.int32)
                pd, xd = lut[pd], lut[xd]
                values = td.dictionaries[col.name].values
                arrays[f"s_{col.name}"], arrays[f"o_{col.name}"] = \
                    _strings_out([values[i] for i in used.tolist()])
            arrays[f"d_{col.name}"] = pd
            if not pv.all():
                arrays[f"v_{col.name}"] = pv
            if col.name in pk:
                arrays[f"x_{col.name}"] = xd
                if not xv.all():
                    arrays[f"xv_{col.name}"] = xv
        arrays["__rowid"] = _cat([c.rowid[i] for c, i in puts], np.int64)
        arrays["__xrowid"] = _cat([c.rowid[i] for c, i in gone], np.int64)
        arrays["__n"] = np.asarray([len(arrays["__rowid"])])
        arrays["__ndel"] = np.asarray([len(arrays["__xrowid"])])
        tmp = path + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)

    @staticmethod
    def _gather(td, cn: str, puts: list, gone: list) -> tuple:
        """((values, validity) at the put rows, the same at the deleted
        rows) of column ``cn``."""
        from ..storage.columnstore import ColumnStore
        col = td.schema.column(cn)
        dt = np.int32 if col.type.uses_dictionary else col.type.np_dtype
        out = []
        for parts in (puts, gone):
            got = [ColumnStore.chunk_column(td, c, cn, i) for c, i in parts]
            out.append((_cat([d for d, _ in got], dt),
                        _cat([v for _, v in got], bool)))
        return tuple(out)

    def on_fail_or_cancel(self, ctx: JobContext) -> None:
        pass  # partial data files are ignored without a manifest entry


def _cat(parts: list, dtype) -> np.ndarray:
    return np.concatenate(parts).astype(dtype, copy=False) if parts \
        else np.zeros(0, dtype=dtype)


class RestoreResumer:
    """payload: {tables, src}; progress: {tables_done}."""

    def __init__(self, engine):
        self.engine = engine

    def resume(self, ctx: JobContext) -> None:
        p = ctx.payload
        src = p["src"]
        manifest = _load_manifest(src)
        if not manifest["layers"]:
            raise ValueError(f"no backup found in {src!r}")
        done = set(ctx.progress().get("tables_done", []))
        tables = p["tables"] or sorted(
            manifest["layers"][0]["tables"].keys())
        for table in tables:
            ctx.check_cancel()
            if table in done:
                continue
            self._restore_table(table, manifest, src)
            done.add(table)
            ctx.checkpoint({"tables_done": sorted(done)},
                           fraction=len(done) / len(tables))

    def _restore_table(self, table: str, manifest: dict, src: str) -> None:
        from ..catalog import TableDescriptor
        eng = self.engine
        first = manifest["layers"][0]["tables"].get(table)
        if first is None:
            raise ValueError(f"table {table!r} not in backup")
        if table in eng.store.tables:
            raise ValueError(f"table {table!r} already exists")
        desc = TableDescriptor.decode(first["descriptor"].encode())
        schema = desc.public_schema()
        created = eng.catalog.create_table(
            TableDescriptor.from_schema(schema))
        schema.table_id = created.id
        eng.store.create_table(schema)
        eng._table_created(table)
        ts = eng.clock.now()
        for i, layer in enumerate(manifest["layers"]):
            entry = layer["tables"].get(table)
            if entry is None:
                continue
            path = os.path.join(src, entry["file"])
            if i == 0:
                self._insert_full(table, path, ts)
            else:
                self._apply_layer(table, path, ts)
        # rowids kept by the incremental puts must not collide with
        # later inserts either
        td = eng.store.table(table)
        top = max((int(c.rowid.max()) for c in td.chunks if c.n),
                  default=0)
        td.next_rowid = max(td.next_rowid, top + 1)

    def _columns(self, table: str, z, prefix: str, n: int,
                 names: list) -> tuple:
        """The layer's columns ``names`` (data prefix ``prefix``) as the
        restored table's physical arrays: string codes re-encoded into
        its dictionaries. Returns (data, validity)."""
        td = self.engine.store.table(table)
        data, valid = {}, {}
        for cn in names:
            col = td.schema.column(cn)
            d = z[f"{prefix}_{cn}"]
            if col.type.uses_dictionary:
                vals = _strings_in(z[f"s_{cn}"], z[f"o_{cn}"])
                lut = np.fromiter((td.dictionaries[cn].encode(v)
                                   for v in vals), dtype=np.int32,
                                  count=len(vals))
                d = lut[d] if len(vals) else np.zeros(n, dtype=np.int32)
            data[cn] = d
            vk = f"{'v' if prefix == 'd' else 'xv'}_{cn}"
            valid[cn] = z[vk] if vk in z.files else np.ones(n, dtype=bool)
        return data, valid

    def _insert_full(self, table: str, path: str, ts: Timestamp) -> None:
        store = self.engine.store
        td = store.table(table)
        with np.load(path) as z:
            n = int(z["__n"][0])
            if not n:
                return
            data, valid = self._columns(
                table, z, "d", n, [c.name for c in td.schema.columns])
            store.insert_rows(table, data, valid, z["__rowid"], ts)

    def _apply_layer(self, table: str, path: str, ts: Timestamp) -> None:
        store = self.engine.store
        td = store.table(table)
        codec = td.codec
        ops: list = []
        with np.load(path) as z:
            n = int(z["__n"][0])
            if n:
                data, valid = self._columns(
                    table, z, "d", n, [c.name for c in td.schema.columns])
                rows = store.rows_at(td, _block(data, valid, z["__rowid"]),
                                     np.arange(n))
                ops.extend(("put", codec.key(row), row) for row in rows)
            nd = int(z["__ndel"][0])
            if nd:
                data, valid = ({}, {}) if codec.synthetic_pk else \
                    self._columns(table, z, "x", nd, codec.pk_cols)
                rows = store.rows_at(td, _block(data, valid, z["__xrowid"]),
                                     np.arange(nd))
                ops.extend(("del", codec.key(row)) for row in rows)
        if ops:
            store.apply_committed(table, ops, ts)

    def on_fail_or_cancel(self, ctx: JobContext) -> None:
        pass


def _block(data: dict, valid: dict, rowid: np.ndarray):
    """A layer's rows as a chunk of the restored table's physical arrays
    (columns it lacks read as their default or NULL)."""
    from ..storage.columnstore import MAX_TS_INT, Chunk
    n = len(rowid)
    return Chunk(data=data, valid=valid,
                 mvcc_ts=np.zeros(n, dtype=np.int64),
                 mvcc_del=np.full(n, MAX_TS_INT, dtype=np.int64), n=n,
                 rowid=np.asarray(rowid, dtype=np.int64))
