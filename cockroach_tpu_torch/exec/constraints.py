"""Constraint enforcement inside DML txns: CHECK, FOREIGN KEY
(RESTRICT) and UNIQUE constraints.

The port of cockroach_tpu/exec/constraints.py. FK existence probes run
against the scan-plane row locators plus this txn's buffered effects;
concurrent-txn races are serialized by the KV plane. NOT NULL and the
duplicate-primary-key check live in the INSERT and UPDATE paths
(exec/dml.py). Unique indexes keep KV entries written inside the
statement's txn (``_maintain_indexes``), so a ROLLBACK releases a value
and two open txns writing one value conflict.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kv.txn import Txn
from ..sql import parser
from ..sql.binder import Binder
from ..storage import keys as K
from .expr import compile_expr
from .session import EngineError


class ConstraintMixin:
    """Engine methods of constraint enforcement; mixed into
    exec.engine.Engine (all state lives on the Engine instance)."""

    def _table_constraints(self, table: str) -> tuple:
        cached = self._constraint_defs.get(table)
        if cached is not None:
            return cached
        d = self.catalog.get_by_name(table)
        out = ((list(d.checks), list(d.fks)) if d is not None
               else ([], []))
        self._constraint_defs[table] = out
        return out

    def _fk_children_of(self, table: str) -> list:
        """[(child_table, fk_record)] of FKs referencing `table`."""
        if self._fk_children is None:
            m: dict[str, list] = {}
            for d in self.catalog.list_tables():
                for fk in d.fks:
                    m.setdefault(fk["ref_table"], []).append((d.name, fk))
            self._fk_children = m
        return self._fk_children.get(table, [])

    def _enforce_checks(self, table: str, td, rows: list,
                        rts: int) -> None:
        checks, _ = self._table_constraints(table)
        if not checks or not rows:
            return
        # the mini chunk is built first: encoding the new rows can add
        # string values to the table dictionaries, and the compiled
        # predicate bakes dictionary lookup tables
        mini = self._delta_chunk(td, rows, rts)
        # compiled per (table, string-dictionary sizes): dictionary
        # growth recompiles
        dictlens = tuple(sorted((cn, len(d)) for cn, d in
                                td.dictionaries.items()))
        key = (table, dictlens)
        compiled = self._check_fn_cache.get(key)
        if compiled is None:
            scope, _s = self._dml_scope(table)
            compiled = []
            for ck in checks:
                e = parser.Parser(ck["expr_sql"]).parse_expr()
                compiled.append((ck, compile_expr(Binder(scope).bind(e))))
            for k in [k for k in self._check_fn_cache if k[0] == table]:
                del self._check_fn_cache[k]
            self._check_fn_cache[key] = compiled
        ctx = self._host_ctx(table, mini)
        for ck, f in compiled:
            d, v = f(ctx)
            # SQL: CHECK fails only on FALSE (NULL passes)
            # graftlint: waive[no-aliasing-upload] d and v are the
            # compiled CHECK's result (a tensor, or a Python scalar for
            # a constant), only read into a fresh mask
            viol = torch.logical_and(torch.logical_not(
                torch.as_tensor(d)), torch.as_tensor(v))
            if bool(viol.any()):
                raise EngineError(
                    f"new row violates check constraint "
                    f"{ck['name']!r} ({ck['expr_sql']})")

    def _fk_parent_exists(self, fk: dict, vals: tuple, session,
                          rts: int) -> bool:
        rt = fk["ref_table"]
        rtd = self.store.table(rt)
        pending = (self._txn_key_state(session.effects, rt)
                   if session is not None and session.txn is not None
                   else {})
        sec = self.store.ensure_secondary_index(
            rt, tuple(fk["ref_columns"]))
        for ci, ri in sec.get(vals, []):
            ch = rtd.chunks[ci]
            if not (ch.mvcc_ts[ri] <= rts < ch.mvcc_del[ri]):
                continue
            if pending and self.store.row_key(rtd, ch, ri) in pending:
                continue  # deleted or superseded in this txn
            return True
        for _k, r in pending.items():
            if r is None:
                continue
            if tuple(r.get(c) for c in fk["ref_columns"]) == vals:
                return True
        return False

    def _enforce_fks(self, table: str, rows: list, session,
                     rts: int) -> None:
        """Child side: every non-NULL FK value in `rows` must have a
        visible parent row."""
        _checks, fks = self._table_constraints(table)
        for fk in fks:
            # self-FKs may be satisfied by rows of this very statement
            self_vals = None
            if fk["ref_table"] == table:
                self_vals = {tuple(r.get(c) for c in fk["ref_columns"])
                             for r in rows}
            for r in rows:
                vals = tuple(r.get(c) for c in fk["columns"])
                if any(v is None for v in vals):
                    continue
                if self_vals is not None and vals in self_vals:
                    continue
                if not self._fk_parent_exists(fk, vals, session, rts):
                    raise EngineError(
                        f"insert on {table!r} violates foreign key "
                        f"{fk['name']!r}: no row in "
                        f"{fk['ref_table']!r} with "
                        f"{fk['ref_columns']} = {vals!r}")

    def _enforce_fk_restrict(self, table: str, removed_rows: list,
                             session, rts: int,
                             changed_cols: Optional[set] = None,
                             exclude_keys: Optional[set] = None) -> None:
        """Parent side RESTRICT: removing or changing a referenced key
        fails while child rows still point at it.

        ``changed_cols`` (UPDATE/UPSERT): probe only FKs whose own
        ref_columns changed. ``exclude_keys`` (DELETE): row keys removed
        by this very statement (a bulk delete over a self-referential
        FK may remove parent and child together)."""
        for child, fk in self._fk_children_of(table):
            if child not in self.store.tables:
                continue
            if changed_cols is not None and \
                    not (set(fk["ref_columns"]) & changed_cols):
                continue
            ctd = self.store.table(child)
            pending = (self._txn_key_state(session.effects, child)
                       if session is not None
                       and session.txn is not None else {})
            sec = self.store.ensure_secondary_index(
                child, tuple(fk["columns"]))
            for row in removed_rows:
                vals = tuple(row.get(c) for c in fk["ref_columns"])
                if any(v is None for v in vals):
                    continue
                for ci, ri in sec.get(vals, []):
                    ch = ctd.chunks[ci]
                    if not (ch.mvcc_ts[ri] <= rts < ch.mvcc_del[ri]):
                        continue
                    if pending and self.store.row_key(
                            ctd, ch, ri) in pending:
                        continue
                    if exclude_keys and child == table and \
                            self.store.row_key(ctd, ch, ri) \
                            in exclude_keys:
                        continue  # this child row dies in the same stmt
                    raise EngineError(
                        f"delete/update on {table!r} violates "
                        f"foreign key {fk['name']!r} on {child!r}: "
                        f"row still references {vals!r}")
                for k, r in pending.items():
                    if exclude_keys and child == table and \
                            k in exclude_keys:
                        continue  # txn-buffered row dying in this stmt
                    if r is not None and tuple(
                            r.get(c) for c in fk["columns"]) == vals:
                        raise EngineError(
                            f"delete/update on {table!r} violates "
                            f"foreign key {fk['name']!r} on "
                            f"{child!r} (pending row)")

    def _maintain_indexes(self, table: str, td, t: Txn, pending: dict,
                          old_row, new_row, rts: int) -> None:
        """Per-row index maintenance inside a DML txn: a unique index's
        KV entry for ``old_row`` goes, ``new_row``'s is checked for
        uniqueness and written. A NULL in an indexed column exempts the
        row (SQL unique semantics). A non-unique index is derived from
        the scan plane and needs nothing here."""
        tid = td.schema.table_id
        for idx in self._table_indexes(table):
            if not idx.unique:
                continue
            cols = tuple(idx.columns)
            old_vals = _index_vals(old_row, cols)
            new_vals = _index_vals(new_row, cols)
            if old_vals == new_vals:
                continue
            if old_vals is not None:
                t.delete(K.table_key(tid, old_vals, idx.index_id))
            if new_vals is not None:
                self._check_unique(table, td, idx, new_vals, t, pending,
                                   new_row, rts)
                t.put(K.table_key(tid, new_vals, idx.index_id),
                      td.codec.key(new_row))

    def _check_unique(self, table: str, td, idx, vals: tuple, t: Txn,
                      pending: dict, new_row: dict, rts: int) -> None:
        new_key = td.codec.key(new_row)
        err = EngineError(f"duplicate key value {vals!r} violates unique "
                          f"index {idx.name!r} of {table!r}")
        # the KV entry: committed rows written through the row plane and
        # this txn's earlier writes (a txn reads its own intents); a
        # concurrent writer conflicts on this same key
        raw = t.get(K.table_key(td.schema.table_id, vals, idx.index_id))
        if raw is not None and raw != new_key:
            raise err
        # the scan plane: bulk-ingested rows that never had KV pairs,
        # visible at this txn's read timestamp
        sec = self.store.ensure_secondary_index(table, tuple(idx.columns))
        for ci, ri in sec.get(vals, []):
            c = td.chunks[ci]
            if not (c.mvcc_ts[ri] <= rts < c.mvcc_del[ri]):
                continue
            rk = self.store.row_key(td, c, ri)
            if rk != new_key and rk not in pending:
                raise err


def _index_vals(row, cols: tuple):
    """The row's values of ``cols``, or None (no row, or a NULL)."""
    if row is None:
        return None
    vals = tuple(row.get(cn) for cn in cols)
    return None if any(v is None for v in vals) else vals
