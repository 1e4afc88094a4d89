"""DML through the transactional KV plane: INSERT/UPSERT, DELETE and
UPDATE with intents, overlay chunks and effect publication.

The port of cockroach_tpu/exec/dml.py. Every DML statement writes row
intents through kv.Txn (latches, timestamp-cache floors, pushes, read
refresh) and records scan-plane effects that are published into the
columnstore only at the commit timestamp. On a cluster-backed engine
(``Engine(cluster=...)``) the columnstore is a materialization of the
committed range data, kept coherent across gateways by per-table
generation tokens (``_sync_scan_plane``).

UPDATE and DELETE predicates and SET assignments are evaluated on the
host, as the reference evaluates them: point-op predicates never pay a
device round trip. Here that is this package's compile_expr over CPU
tensors of the chunk's columns (``_host_ctx``). Every SELECT, an
INSERT ... SELECT's source and any read after a write included, runs on
the engine's device.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import torch

from ..kv.concurrency import Span, TxnAbortedError, TxnRetryError
from ..kv.txn import DB as KVDB
from ..kv.txn import Txn
from ..sql import ast
from ..sql.binder import Binder, ColumnBinding, Scope
from ..sql.bound import BConst
from ..sql.rowenc import ROWID
from ..sql.types import Family, TableSchema
from ..storage.columnstore import MAX_TS_INT, Chunk
from ..storage.hlc import Timestamp
from .expr import ExprContext, compile_expr
from .session import EngineError, Result, Session
from .stmtutil import collect_tables, contains_func

EPOCH_DATE = datetime.date(1970, 1, 1)
EPOCH_DT = datetime.datetime(1970, 1, 1)
HOST = torch.device("cpu")


def retry_exhausted(last: Exception | None) -> EngineError:
    """The serialization-failure error after the DML retry budget (the
    "restart transaction" class, SQLSTATE 40001 on the wire)."""
    return EngineError(
        f"restart transaction: DML exhausted retries: {last}")


class DMLMixin:
    """Engine methods of the write path; mixed into exec.engine.Engine
    (all state lives on the Engine instance)."""

    def _dml(self, session: Session, fn) -> Result:
        """Run fn(txn, effects) -> Result in the session's open txn, or
        in a fresh auto-commit txn with the kv retry loop."""
        if session.txn is not None:
            # a failed statement aborts the whole explicit txn: its
            # partial intents are resolved away and nothing publishes
            # (pg's "aborted until end of txn block")
            try:
                return fn(session.txn, session.effects)
            except (TxnRetryError, TxnAbortedError) as e:
                session.txn_aborted = True
                session.txn.rollback()
                raise EngineError(f"restart transaction: {e}") from e
            except BaseException:
                session.txn_aborted = True
                session.txn.rollback()
                raise
        last: Exception | None = None
        for _ in range(KVDB.MAX_ATTEMPTS):
            t = Txn(self.kv.store)
            effects: list = []
            try:
                res = fn(t, effects)
                toks = {}
                if self.cluster is not None and effects:
                    toks = self._bump_table_gens(
                        t, sorted({tb for tb, _ in effects}))
                commit_ts = t.commit()
                self._publish(effects, commit_ts)
                self._scan_gens.update(toks)
                return res
            except (TxnRetryError, TxnAbortedError) as e:
                t.rollback()
                last = e
            except BaseException:
                t.rollback()
                raise
        raise retry_exhausted(last)

    # -- range-plane scan-plane sync ----------------------------------------
    # With a Cluster attached, the columnstore is a materialization of
    # committed range data. Every DML txn bumps an opaque generation
    # token at /tgen/<table> inside the SAME txn as its row intents;
    # engines compare the replicated token against the one their local
    # materialization was built from and re-fetch when they differ (the
    # reference gets this coherence from leaseholder reads; the scan
    # plane is a cache, so it carries its own epoch). A refresh rebuilds
    # the table under a new store generation, so the device copy and
    # the exec cache, both keyed by (table, generation), follow it.

    TGEN_PREFIX = b"/tgen/"

    def _bump_table_gens(self, t: Txn, tables: list) -> dict:
        import uuid
        toks = {}
        for tb in tables:
            toks[tb] = uuid.uuid4().hex[:16].encode()
            t.put(self.TGEN_PREFIX + tb.encode(), toks[tb])
        return toks

    def _bump_tgen_ddl(self, name: str, dropped: bool = False) -> None:
        """Schema-affecting DDL (DROP, TRUNCATE, ALTER) invalidates other
        gateways' materializations through the same token."""
        if self.cluster is None:
            return
        import uuid
        tok = b"ddl-" + uuid.uuid4().hex[:12].encode()
        self.kv.put(self.TGEN_PREFIX + name.encode(), tok)
        if dropped:
            self._scan_gens.pop(name, None)
        else:
            self._scan_gens[name] = tok

    def _sync_scan_plane(self, stmt) -> None:
        """Before a statement runs on a cluster-backed engine, make
        every referenced table's columnstore materialization match the
        replicated generation token."""
        refs: set = set()
        collect_tables(stmt, refs)
        tb = getattr(stmt, "table", None)
        if isinstance(tb, str):
            refs.add(tb)
        seen = set()
        while refs:
            name = refs.pop()
            if name in seen:
                continue
            seen.add(name)
            if name in self.store.tables:
                gen = self.kv.get(self.TGEN_PREFIX + name.encode())
                if gen == self._scan_gens.get(name):
                    continue
                self.refresh_table_from_ranges(name)
                continue
            desc = self.catalog.get_by_name(name)
            if desc is None:
                continue  # CTE alias or unknown: the binder will say so
            if desc.view_sql:
                from ..sql import parser as _p
                collect_tables(_p.parse(desc.view_sql), refs)
                continue
            self.refresh_table_from_ranges(name)

    def refresh_table_from_ranges(self, name: str) -> bool:
        """(Re)build one table's columnstore from committed range data
        (the cFetcher materialization path of kv/rowfetch.py, in the
        engine).

        The rebuild is version-faithful: every committed MVCC version
        becomes a columnstore row with its true (mvcc_ts, mvcc_del)
        interval, so open snapshots on this gateway and AS OF SYSTEM
        TIME keep reading correct history after a refresh triggered by
        another gateway's writes. Unresolved intents are skipped (the
        pebbleMVCCScanner contract: the scan plane only ever sees
        resolved committed versions)."""
        desc = self.catalog.get_by_name(name)
        if desc is None or desc.view_sql:
            if desc is None and name in self.store.tables:
                # dropped on another gateway: retire the local cache
                self.store.drop_table(name)
                self._evict_device(name)
                self._scan_gens.pop(name, None)
            return False
        from ..sql.rowenc import RowCodec
        schema = desc.public_schema()
        codec = RowCodec(schema)
        start, end = codec.span()
        gen = self.kv.get(self.TGEN_PREFIX + name.encode())

        # committed versions per key from every range overlapping the
        # table span (raw engine iteration: tombstones and history too)
        per_key: dict[bytes, list] = {}
        store = self.kv.store
        range_iter = getattr(store.mvcc, "_ranges_overlapping", None)
        if range_iter is None:   # local single-store plane
            sources = [(start, end, store.mvcc)]
        else:
            sources = [(max(start, d.start_key), min(end, d.end_key),
                        rep.mvcc)
                       for d, rep in range_iter(start, end)]
        for lo, hi, mvcc in sources:
            for key, tsi, val in mvcc.committed_versions(lo, hi):
                per_key.setdefault(key, []).append((tsi, val))
        versions: list[tuple[dict, int, int]] = []
        for key, vers in per_key.items():
            vers.sort()
            for i, (tsi, val) in enumerate(vers):
                if val is None:
                    continue   # MVCC delete: bounds the prior version
                del_i = vers[i + 1][0] if i + 1 < len(vers) \
                    else MAX_TS_INT
                versions.append((codec.decode_row(key, val), tsi, del_i))

        if name in self.store.tables:
            self.store.drop_table(name)
            self._evict_device(name)
        self.store.create_table(schema)
        self.store.insert_versions(name, versions)
        self._scan_gens[name] = gen
        self._index_defs.pop(name, None)
        self._constraint_defs.pop(name, None)
        self._fk_children = None
        return True

    def _publish(self, effects: list, ts: Timestamp) -> None:
        """Apply a committed txn's effects to the scan plane, table by
        table in first-touch order, drop the stale device copies, and
        hand each table's ops to the changefeeds on it (committed
        effects only, at the commit timestamp)."""
        by_table: dict[str, list] = {}
        for table, op in effects:
            by_table.setdefault(table, []).append(op)
        for table, ops in by_table.items():
            self.store.apply_committed(table, ops, ts)
            self._evict_device(table)
            for feed in self.cdc_feeds:
                if feed.table == table:
                    feed.on_publish(ops, ts)

    def _register_table_read(self, txn: Optional[Txn], table: str,
                             read_ts: Timestamp) -> None:
        """Record a scan-plane read in the KV concurrency plane: the
        table span goes into the txn's refresh set and the timestamp
        cache, so conflicting writers get pushed above our read."""
        start, end = self.store.table(table).codec.span()
        span = Span(start, end)
        self.kv.store.tscache.add(span, read_ts,
                                  txn.meta.id if txn else None)
        if txn is not None:
            txn.read_spans.append(span)

    @staticmethod
    def _txn_key_state(effects: list, table: str) -> dict:
        """Net per-key state of buffered effects for one table:
        key -> row dict (pending put) or None (pending delete)."""
        state: dict[bytes, object] = {}
        for tb, op in effects:
            if tb == table:
                state[op[1]] = op[2] if op[0] == "put" else None
        return state

    def _overlay_chunks(self, table: str, effects: list,
                        read_ts: Timestamp) -> list[Chunk]:
        """Committed chunks with this txn's buffered effects applied:
        pending deletes and overwrites tombstone the committed version
        (copy-on-write of the deletion column), pending puts appear as
        a delta chunk visible at the txn's read timestamp (the
        read-your-own-writes overlay)."""
        td = self.store.table(table)
        state = self._txn_key_state(effects, table)
        if not state:
            return list(td.chunks)
        idx = self.store.ensure_pk_index(table)
        rts = read_ts.to_int()
        shadow: dict[int, np.ndarray] = {}   # chunk idx -> COW mvcc_del

        def tombstone(ci: int, ri: int):
            if ci not in shadow:
                shadow[ci] = td.chunks[ci].mvcc_del.copy()
            shadow[ci][ri] = rts   # hidden from this txn's reads
        for key in state:
            pos = idx.get(key)
            if pos is None:
                continue
            ci, ri = pos
            if td.chunks[ci].mvcc_ts[ri] > rts:
                # a concurrent txn superseded the key after our read_ts:
                # the version to hide is found by the sweep below
                continue
            tombstone(ci, ri)
        # versions visible at rts but superseded after it are not in
        # the live pk index, yet a pending write must shadow them too
        for ci, c in enumerate(td.chunks):
            cand = np.nonzero((c.mvcc_ts <= rts) & (rts < c.mvcc_del)
                              & (c.mvcc_del != MAX_TS_INT))[0]
            for ri in cand:
                if self.store.row_key(td, c, int(ri)) in state:
                    tombstone(ci, int(ri))
        chunks = []
        for ci, c in enumerate(td.chunks):
            if ci in shadow:
                c = Chunk(data=c.data, valid=c.valid, mvcc_ts=c.mvcc_ts,
                          mvcc_del=shadow[ci], n=c.n, rowid=c.rowid)
            chunks.append(c)
        pending_rows = [r for r in state.values() if r is not None]
        if pending_rows:
            chunks.append(self._delta_chunk(td, pending_rows, rts))
        return chunks

    def _delta_chunk(self, td, rows: list[dict], ts_int: int) -> Chunk:
        """Pending rows as a chunk visible from `ts_int` on."""
        n = len(rows)
        return self.store.rows_chunk(
            td, rows, np.full(n, ts_int, dtype=np.int64),
            np.full(n, MAX_TS_INT, dtype=np.int64),
            np.asarray([int(r.get(ROWID, 0)) for r in rows],
                       dtype=np.int64))

    def _apply_column_defaults(self, schema, provided_cols, rows,
                               session: Session) -> None:
        """Fill DEFAULT values for columns absent from the INSERT column
        list; a {"__seq__": name} default draws nextval per row (pg
        evaluates defaults row at a time)."""
        defaulted = [c for c in schema.columns
                     if c.name not in provided_cols
                     and c.default is not None]
        for row in rows:
            for c in defaulted:
                if row.get(c.name) is not None:
                    continue
                d = c.default
                if isinstance(d, dict) and "__seq__" in d:
                    row[c.name] = int(self._sequence_op(
                        session, "nextval", d["__seq__"], None))
                else:
                    row[c.name] = d

    def _exec_insert(self, ins: ast.Insert, session: Session) -> Result:
        td = self.store.table(ins.table)
        schema = td.schema
        cols = ins.columns or schema.column_names
        if ins.select is not None:
            for vol in ("nextval", "gen_random_uuid"):
                if contains_func(ins.select, vol):
                    # the select binds the volatile fn once, handing
                    # every produced row the same value (pg evaluates
                    # per row): refuse rather than corrupt keys
                    raise EngineError(
                        f"{vol} inside INSERT ... SELECT is not "
                        "supported; insert explicit VALUES instead")
            with self._statement():
                src = self._exec_select(
                    ins.select, session,
                    "insert-select:" + repr(ins.select))
            rows = [self._encode_row(schema, dict(zip(cols, r)))
                    for r in src.rows]
        else:
            binder = Binder(Scope(),
                            sequence_ops=self._sequence_ops(session))
            rows = []
            for row_exprs in ins.rows:
                if len(row_exprs) != len(cols):
                    raise EngineError("INSERT value count mismatch")
                row = {}
                for cname, e in zip(cols, row_exprs):
                    col = schema.column(cname)
                    b = binder.bind(e)
                    if not isinstance(b, BConst):
                        raise EngineError(
                            "INSERT values must be constants")
                    if b.value is None:
                        if not col.nullable:
                            raise EngineError(
                                f"null in non-null column {cname}")
                        row[cname] = None
                    else:
                        row[cname] = binder._const_to(b, col.type).value
                rows.append(row)
        self._apply_column_defaults(schema, set(cols), rows, session)
        for row in rows:
            for col in schema.columns:
                if not col.nullable and row.get(col.name) is None:
                    raise EngineError(f"null in non-null column {col.name}")
        codec = td.codec

        def fn(t: Txn, effects: list) -> Result:
            pending = self._txn_key_state(effects, ins.table)
            idx = self.store.ensure_pk_index(ins.table)
            rts = t.meta.read_ts.to_int()
            self._enforce_checks(ins.table, td, rows, rts)
            self._enforce_fks(ins.table, rows, session, rts)
            new_rows = []
            for row in rows:
                r = dict(row)
                if codec.synthetic_pk:
                    r[ROWID] = self.store.alloc_rowids(ins.table, 1)[0]
                key = codec.key(r)
                old_row = None
                if not codec.synthetic_pk and not ins.upsert:
                    # duplicate-key check = CPut semantics: a KV read
                    # (sees concurrent intents, registers the span)
                    # plus the scan-plane live index (covers
                    # bulk-ingested rows with no KV pair)
                    in_txn = pending.get(key, "absent")
                    committed = (t.get(key) is not None or key in idx)
                    if in_txn not in (None, "absent") or \
                            (committed and in_txn == "absent"):
                        pk = codec.pk_values(r)
                        raise EngineError(
                            f"duplicate key value {pk!r} violates "
                            f"primary key of {ins.table!r}")
                elif ins.upsert:
                    # the row being replaced, for FK RESTRICT
                    in_txn = pending.get(key, "absent")
                    if in_txn not in (None, "absent"):
                        old_row = in_txn
                    elif key in idx:
                        ci, ri = idx[key]
                        old_row = self.store.extract_row(
                            td, td.chunks[ci], ri)
                    if old_row is not None:
                        changed = set()
                        for _ch, fk in self._fk_children_of(ins.table):
                            changed |= {
                                cn for cn in fk["ref_columns"]
                                if old_row.get(cn) != r.get(cn)}
                        if changed:
                            self._enforce_fk_restrict(
                                ins.table, [old_row], session, rts,
                                changed_cols=changed)
                self._maintain_indexes(ins.table, td, t, pending,
                                       old_row, r, rts)
                t.put(key, codec.encode_value(r))
                pending[key] = r
                new_rows.append((key, r))
            for key, r in new_rows:
                effects.append((ins.table, ("put", key, r)))
            return Result(row_count=len(rows),
                          tag="UPSERT" if ins.upsert else "INSERT")

        return self._dml(session, fn)

    @staticmethod
    def _encode_row(schema: TableSchema, row: dict) -> dict:
        """A decoded result row (INSERT ... SELECT's source) in
        storage-logical form."""
        out = {}
        for cname, v in row.items():
            col = schema.column(cname)
            if v is None:
                out[cname] = None
            elif col.type.family == Family.DECIMAL:
                out[cname] = int(round(float(v) * 10 ** col.type.scale))
            elif col.type.family == Family.DATE:
                out[cname] = ((v - EPOCH_DATE).days
                              if isinstance(v, datetime.date) else int(v))
            elif col.type.family == Family.TIMESTAMP:
                out[cname] = (int((v - EPOCH_DT).total_seconds() * 1e6)
                              if isinstance(v, datetime.datetime)
                              else int(v))
            else:
                out[cname] = v
        return out

    def _dml_scope(self, table: str) -> tuple[Scope, TableSchema]:
        td = self.store.table(table)
        scope = Scope()
        cols = {}
        for c in td.schema.columns:
            cols[c.name] = ColumnBinding(
                f"{table}.{c.name}", c.type, td.dictionaries.get(c.name))
        scope.add_table(table, cols)
        return scope, td.schema

    @staticmethod
    def _host_ctx(table: str, chunk: Chunk) -> ExprContext:
        """A chunk's columns as CPU tensors for host-side evaluation
        (the reference pins its DML expressions to the CPU backend so
        point-op predicates and assignments never pay a device round
        trip)."""
        return ExprContext(
            {f"{table}.{k}": (torch.from_numpy(chunk.data[k]),
                              torch.from_numpy(chunk.valid[k]))
             for k in chunk.data}, chunk.n, HOST)

    def _chunk_pred(self, table: str, where, scope: Scope,
                    session: Session | None = None):
        if where is None:
            return lambda chunk: np.ones(chunk.n, dtype=bool)
        session = session or self.session()
        binder = Binder(
            scope,
            subquery_eval=lambda s, lim: self._eval_subquery(
                s, session, lim),
            now_micros=self._read_ts(session).wall // 1000,
            sequence_ops=self._sequence_ops(session))
        predf = compile_expr(binder.bind(where))

        def f(chunk):
            d, v = predf(self._host_ctx(table, chunk))
            d = torch.as_tensor(d).expand(chunk.n)
            v = torch.as_tensor(v).expand(chunk.n)
            return (d & v).numpy()
        return f

    def _exec_delete(self, d: ast.Delete, session: Session) -> Result:
        scope, _ = self._dml_scope(d.table)
        td = self.store.table(d.table)
        codec = td.codec
        predf = self._chunk_pred(d.table, d.where, scope, session)

        def fn(t: Txn, effects: list) -> Result:
            read_ts = t.meta.read_ts
            self._register_table_read(t, d.table, read_ts)
            rts = read_ts.to_int()
            pending = self._txn_key_state(effects, d.table)
            cand = self._dml_index_candidates(d.table, d.where, session)
            n_committed = len(td.chunks)
            victims: list[tuple[bytes, dict]] = []
            for ci, chunk in enumerate(
                    self._overlay_chunks(d.table, effects, read_ts)):
                if cand is not None and ci < n_committed \
                        and ci not in cand:
                    continue
                mask = chunk.live_mask(rts) & predf(chunk)
                for ri in np.nonzero(mask)[0]:
                    row = self.store.extract_row(td, chunk, int(ri))
                    victims.append((codec.key(row), row))
            # one batched RESTRICT probe for the whole statement; child
            # rows removed by this same statement are excluded (a bulk
            # delete over a self-referential FK is legal in pg)
            self._enforce_fk_restrict(d.table, [r for _k, r in victims],
                                      session, rts,
                                      exclude_keys={k for k, _r
                                                    in victims})
            for key, row in victims:
                self._maintain_indexes(d.table, td, t, pending,
                                       row, None, rts)
                t.delete(key)
                effects.append((d.table, ("del", key)))
            return Result(row_count=len(victims), tag="DELETE")

        return self._dml(session, fn)

    def _exec_update(self, u: ast.Update, session: Session) -> Result:
        scope, schema = self._dml_scope(u.table)
        td = self.store.table(u.table)
        binder = Binder(scope, sequence_ops=self._sequence_ops(session))
        assigned = {}
        for cname, e in u.assignments:
            col = schema.column(cname)
            # nextval allocates per row (pg semantics): a bare
            # nextval('s') assignment draws in the row loop below;
            # nextval inside a larger expression would fold to one
            # shared value, so it is refused
            if isinstance(e, ast.FuncCall) and e.name == "nextval" \
                    and len(e.args) == 1 \
                    and isinstance(e.args[0], ast.Literal):
                self._seq_desc(e.args[0].value)  # must exist
                assigned[cname] = ("seq", e.args[0].value)
                continue
            if contains_func(e, "nextval"):
                raise EngineError(
                    "nextval may only be the entire SET expression "
                    "(per-row allocation); fold it into a bare "
                    "nextval('seq') assignment")
            if contains_func(e, "gen_random_uuid"):
                raise EngineError(
                    "gen_random_uuid in UPDATE SET would give every "
                    "row the same uuid (bound once per statement); "
                    "not supported")
            b = binder.bind(e)
            if isinstance(b, BConst) and isinstance(b.value, str) \
                    and col.type.uses_dictionary:
                if col.type.family != Family.STRING:
                    b = binder.coerce(b, col.type)  # canonicalize datum
                code = td.dictionaries[cname].encode(b.value)
                assigned[cname] = ("const", code)
            elif isinstance(b, BConst):
                phys = (binder._const_to(b, col.type).value
                        if b.value is not None else None)
                if phys is None and not col.nullable:
                    raise EngineError(f"null in non-null column {cname}")
                assigned[cname] = ("const", phys)
            else:
                b2 = (binder.coerce(b, col.type)
                      if b.type.family != col.type.family else b)
                assigned[cname] = ("expr", compile_expr(b2))

        def assign(chunk, mask):
            idx = np.nonzero(mask)[0]
            data, valid = {}, {}
            ctx = self._host_ctx(u.table, chunk)
            for c in schema.columns:
                cn = c.name
                if cn not in assigned:
                    data[cn] = chunk.data[cn][idx]
                    valid[cn] = chunk.valid[cn][idx]
                    continue
                kind, v = assigned[cn]
                if kind == "seq":
                    # drawn per row in the caller's row loop
                    data[cn] = np.zeros(len(idx), dtype=c.type.np_dtype)
                    valid[cn] = np.ones(len(idx), dtype=bool)
                    continue
                if kind == "const":
                    data[cn] = np.full(len(idx), 0 if v is None else v,
                                       dtype=c.type.np_dtype)
                    valid[cn] = np.full(len(idx), v is not None)
                    continue
                dd, vv = v(ctx)
                dd = torch.as_tensor(dd).expand(chunk.n).numpy()
                vv = torch.as_tensor(vv).expand(chunk.n).numpy()
                if not c.nullable and not vv[idx].all():
                    raise EngineError(f"null in non-null column {cn}")
                data[cn] = dd[idx].astype(c.type.np_dtype)
                valid[cn] = vv[idx]
            return data, valid

        codec = td.codec
        predf = self._chunk_pred(u.table, u.where, scope, session)

        def fn(t: Txn, effects: list) -> Result:
            read_ts = t.meta.read_ts
            self._register_table_read(t, u.table, read_ts)
            rts = read_ts.to_int()
            idx = self.store.ensure_pk_index(u.table)
            todo = []
            cand = self._dml_index_candidates(u.table, u.where, session)
            n_committed = len(td.chunks)
            for ci, chunk in enumerate(
                    self._overlay_chunks(u.table, effects, read_ts)):
                if cand is not None and ci < n_committed \
                        and ci not in cand:
                    continue
                mask = chunk.live_mask(rts) & predf(chunk)
                if not mask.any():
                    continue
                data, valid = assign(chunk, mask)
                for j, ri in enumerate(np.nonzero(mask)[0]):
                    old = self.store.extract_row(td, chunk, int(ri))
                    new = dict(old)
                    for c in schema.columns:
                        cn = c.name
                        if not valid[cn][j]:
                            new[cn] = None
                        elif c.type.uses_dictionary:
                            new[cn] = td.dictionaries[cn].values[
                                int(data[cn][j])]
                        else:
                            new[cn] = data[cn][j].item()
                    for cn, (kind, v) in assigned.items():
                        if kind == "seq":
                            new[cn] = self._sequence_op(
                                session, "nextval", v, None)
                    todo.append((old, new))
            pending = self._txn_key_state(effects, u.table)
            self._enforce_checks(u.table, td, [new for _o, new in todo],
                                 rts)
            self._enforce_fks(u.table, [new for _o, new in todo],
                              session, rts)
            ref_cols_all = set()
            for _child, fk in self._fk_children_of(u.table):
                ref_cols_all |= set(fk["ref_columns"])
            for old, new in todo:
                changed = {c for c in ref_cols_all
                           if old.get(c) != new.get(c)}
                if changed:
                    # probe only FKs whose own ref columns changed
                    self._enforce_fk_restrict(u.table, [old], session,
                                              rts, changed_cols=changed)
            for old, new in todo:
                okey = codec.key(old)
                nkey = codec.key(new)
                if nkey != okey:
                    # pk change: delete the old kv, insert the new
                    in_txn = pending.get(nkey, "absent")
                    committed = (t.get(nkey) is not None or nkey in idx)
                    if in_txn not in (None, "absent") or \
                            (committed and in_txn == "absent"):
                        raise EngineError(
                            f"duplicate key {codec.pk_values(new)!r} on "
                            f"UPDATE of {u.table!r}")
                    t.delete(okey)
                    effects.append((u.table, ("del", okey)))
                    pending[okey] = None
                self._maintain_indexes(u.table, td, t, pending,
                                       old, new, rts)
                t.put(nkey, codec.encode_value(new))
                effects.append((u.table, ("put", nkey, new)))
                pending[nkey] = new
            return Result(row_count=len(todo), tag="UPDATE")

        return self._dml(session, fn)
