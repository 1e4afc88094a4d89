"""Host-side index fast paths: point and range reads that never touch
the device (the latency analogue of the reference's kvfetcher
single-range fast path, a constrained index scan).

The port of cockroach_tpu/exec/fastpath.py. The candidate indexes are
the primary key and the table's PUBLIC secondary indexes, best first:
primary, unique, non-unique. The range path serves YCSB-E's ``WHERE k
>= x ORDER BY k LIMIT n`` with early termination over a sorted locator
of the index's row versions. Both read at the statement's AS OF SYSTEM
TIME when it has one. ``_dml_index_candidates`` narrows a point
UPDATE or DELETE to the chunks an index says can hold its rows.
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np

from ..sql import ast
from ..sql.binder import Binder, Scope
from ..sql.rowenc import ROWID
from ..sql.types import Family
from .session import EngineError, Result, Session
from .stmtutil import decode_storage_value, split_conjuncts_ast


class FastpathMixin:
    """Engine methods of the host fast paths; mixed into
    exec.engine.Engine (all state lives on the Engine instance)."""

    def _dml_index_candidates(self, table: str, where,
                              session: Session):
        """The chunks that can hold rows matching ``where``'s equality
        conjuncts, by a usable secondary index: a point UPDATE or DELETE
        then evaluates its predicate over those alone. None: no usable
        index, every chunk. The locator covers every row version, so a
        pruned chunk holds no match at any timestamp."""
        if where is None or not self._table_indexes(table):
            # index-less tables (the lane's whole population) skip
            # building and matching the probe SELECT
            return None
        probe = ast.Select(items=[ast.SelectItem(None, star=True)],
                           table=ast.TableRef(table), where=where)
        match = self._index_fastpath_match(probe, session)
        if match is None:
            return None
        _label, cols, vals, _residual = match
        sec = self.store.ensure_secondary_index(table, cols)
        return {ci for ci, _ri in sec.get(vals, [])}

    def _public_indexes(self, tname: str, schema) -> list:
        """(label, columns, rank) of the candidate indexes: the primary
        key (0), PUBLIC unique (1) and non-unique (2) secondary ones."""
        cands = []
        if schema.primary_key:
            cands.append(("primary", tuple(schema.primary_key), 0))
        for idx in self._table_indexes(tname):
            if idx.state == "public":
                cands.append((idx.name, tuple(idx.columns),
                               1 if idx.unique else 2))
        return cands

    def _fastpath_read_ts(self, sel: ast.Select, session: Session,
                          tname: str):
        read_ts = self._as_of_ts(sel, session)
        if read_ts is None:
            return self._read_ts(session)
        self._check_gc_threshold(tname, read_ts)
        return read_ts

    def _fastpath_shape(self, sel: ast.Select, session: Session):
        """Common structural gate: a single stored table and
        projection-only items. Returns (tname, schema, visible,
        projected) or None."""
        if (sel.table is None or sel.joins or sel.group_by
                or sel.having or sel.distinct or sel.ctes):
            return None
        if session.vars.get("index_scan", "on") == "off":
            return None
        tname = sel.table.name
        if sel.table.alias not in (None, tname):
            return None
        if tname not in self.store.tables:
            return None
        schema = self.store.table(tname).schema
        visible = {c.name for c in schema.columns if not c.hidden}
        projected = set()
        for item in sel.items:
            if item.star:
                projected |= visible
                continue
            e = item.expr
            if not (isinstance(e, ast.ColumnRef)
                    and e.table in (None, tname)
                    and e.name in visible):
                return None
            projected.add(item.alias or e.name)
        return (tname, schema, visible, projected)

    def _index_fastpath_match(self, sel: ast.Select, session: Session):
        """(label, cols, vals, residual) when this SELECT is an equality
        lookup covering every column of a usable index: single table,
        projection-only items, conjunctive WHERE with constant
        equalities. None = the compiled scan path."""
        shape = self._fastpath_shape(sel, session)
        if shape is None or sel.where is None:
            return None
        tname, schema, visible, projected = shape
        for ob in sel.order_by:
            if not (isinstance(ob.expr, ast.ColumnRef)
                    and ob.expr.name in projected):
                return None
        eq: dict[str, object] = {}
        eq_conjs: dict[str, object] = {}
        conjs = split_conjuncts_ast(sel.where)
        for c in conjs:
            if not (isinstance(c, ast.BinOp) and c.op == "="):
                continue
            lhs, rhs = c.left, c.right
            if isinstance(rhs, ast.ColumnRef) and isinstance(
                    lhs, ast.Literal):
                lhs, rhs = rhs, lhs
            if (isinstance(lhs, ast.ColumnRef)
                    and lhs.table in (None, tname)
                    and lhs.name in visible
                    and isinstance(rhs, ast.Literal)
                    and rhs.value is not None
                    and lhs.name not in eq):
                eq[lhs.name] = rhs
                eq_conjs[lhs.name] = c
        if not eq:
            return None
        for label, cols, _rank in sorted(
                self._public_indexes(tname, schema), key=lambda c: c[2]):
            if not all(cn in eq for cn in cols):
                continue
            vals = [self._coerce_index_literal(schema.column(cn), eq[cn])
                    for cn in cols]
            if any(v is None for v in vals):
                continue
            consumed = {id(eq_conjs[cn]) for cn in cols}
            residual = any(id(c) not in consumed for c in conjs)
            return (label, cols, tuple(vals), residual)
        return None

    def _exec_index_fastpath(self, sel: ast.Select, session: Session,
                             match) -> Optional[Result]:
        _label, cols, vals, residual = match
        tname = sel.table.name
        td = self.store.table(tname)
        read_ts = self._fastpath_read_ts(sel, session, tname)
        rts = read_ts.to_int()
        positions = self.store.ensure_secondary_index(tname, cols).get(
            vals, [])
        if len(positions) > int(session.vars.get("index_lookup_limit",
                                                 4096)):
            return None  # low selectivity: the compiled scan wins
        self._register_table_read(session.txn, tname, read_ts)
        pending = (self._txn_key_state(session.effects, tname)
                   if session.txn is not None else {})
        rows = []
        for ci, ri in positions:
            c = td.chunks[ci]
            if not (c.mvcc_ts[ri] <= rts < c.mvcc_del[ri]):
                continue
            row = self.store.extract_row(td, c, ri)
            if pending and td.codec.key(row) in pending:
                continue  # superseded by this txn's buffered effects
            rows.append(row)
        for r in pending.values():
            if r is not None and tuple(r.get(cn) for cn in cols) == vals:
                rows.append(r)
        return self._fastpath_project(sel, session, td, rows, rts,
                                      apply_where=residual)

    _FLIP_OP = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}

    @staticmethod
    def _coerce_index_literal(col, lit):
        """Bind and coerce a literal to `col`'s storage form for index
        probing; None when the conversion fails or is inexact (a
        rounded probe value would answer a different predicate, so
        those shapes take the compiled path)."""
        binder = Binder(Scope())
        try:
            b = binder.bind(lit)
            v = binder._const_to(b, col.type).value
        except Exception:
            return None
        if v is None:
            return None
        if isinstance(b.value, (int, float)) \
                and not isinstance(b.value, bool):
            orig = (b.value / 10 ** b.type.scale
                    if b.type.family == Family.DECIMAL else b.value)
            f = col.type.family
            if f == Family.INT and float(v) != float(orig):
                return None
            if f == Family.DECIMAL and \
                    float(v) / 10 ** col.type.scale != float(orig):
                return None
        return v

    def _range_fastpath_match(self, sel: ast.Select, session: Session):
        """Match an index-ordered range scan: equality on a prefix of an
        index plus optional bounds on the next column (a constrained
        ordered index scan)."""
        shape = self._fastpath_shape(sel, session)
        if shape is None or sel.where is None:
            return None
        tname, schema, visible, projected = shape
        # comparisons normalized to (conj, col, op, literal)
        comps = []
        for c in split_conjuncts_ast(sel.where):
            if isinstance(c, ast.BinOp) and c.op in (
                    "=", "<", "<=", ">", ">="):
                lhs, rhs, op = c.left, c.right, c.op
                if isinstance(lhs, ast.Literal) and \
                        isinstance(rhs, ast.ColumnRef):
                    lhs, rhs = rhs, lhs
                    op = self._FLIP_OP.get(op, op)
                if (isinstance(lhs, ast.ColumnRef)
                        and lhs.table in (None, tname)
                        and lhs.name in visible
                        and isinstance(rhs, ast.Literal)
                        and rhs.value is not None):
                    comps.append((c, lhs.name, op, rhs))
                    continue
            comps.append((c, None, None, None))
        for label, cols, _rank in self._public_indexes(tname, schema):
            m = self._range_match_index(sel, schema, projected, comps,
                                        label, cols)
            if m is not None:
                return m
        return None

    def _range_match_index(self, sel, schema, projected, comps, label,
                           cols):
        consumed = []
        eq_vals = []
        p = 0
        for cn in cols:
            hit = next((t for t in comps
                        if t[1] == cn and t[2] == "="), None)
            if hit is None:
                break
            v = self._coerce_index_literal(schema.column(cn), hit[3])
            if v is None:
                break  # not consumed: stays in the residual
            consumed.append(hit[0])
            eq_vals.append(v)
            p += 1
        lo = hi = None
        lo_strict = hi_strict = False
        if p < len(cols):
            rng_col = cols[p]
            for t in comps:
                if t[1] != rng_col or t[2] in ("=", None):
                    continue
                v = self._coerce_index_literal(schema.column(rng_col),
                                               t[3])
                if v is None:
                    continue  # inexact bound: left as residual
                strict = t[2] in (">", "<")
                if t[2] in (">", ">="):
                    # tighter lower bound: the higher value wins; at a
                    # tie, strict (>) excludes more
                    if lo is None or v > lo or \
                            (v == lo and strict and not lo_strict):
                        lo, lo_strict = v, strict
                else:
                    if hi is None or v < hi or \
                            (v == hi and strict and not hi_strict):
                        hi, hi_strict = v, strict
                consumed.append(t[0])
        if p == len(cols) or (p == 0 and lo is None and hi is None):
            return None  # full equality (the point path) or unbounded
        residual = any(t[0] not in consumed for t in comps)
        # index order serves: no ORDER BY, or ascending on the range
        # column (the equality prefix is constant)
        order_ok = not sel.order_by or (
            len(sel.order_by) == 1
            and isinstance(sel.order_by[0].expr, ast.ColumnRef)
            and sel.order_by[0].expr.name == cols[p]
            and not sel.order_by[0].desc
            and cols[p] in projected)
        if sel.order_by and not order_ok and not all(
                isinstance(ob.expr, ast.ColumnRef)
                and ob.expr.name in projected for ob in sel.order_by):
            return None  # cannot even host-sort the output
        return {"label": label, "cols": cols, "p": p,
                "eq_vals": tuple(eq_vals), "lo": lo,
                "lo_strict": lo_strict, "hi": hi,
                "hi_strict": hi_strict, "residual": residual,
                "order_ok": order_ok}

    def _exec_range_fastpath(self, sel: ast.Select, session: Session,
                             m: dict) -> Optional[Result]:
        tname = sel.table.name
        td = self.store.table(tname)
        read_ts = self._fastpath_read_ts(sel, session, tname)
        rts = read_ts.to_int()
        entries = self.store.ensure_sorted_index(tname, m["cols"])
        p, eq_vals = m["p"], m["eq_vals"]
        lo_key = eq_vals + ((m["lo"],) if m["lo"] is not None else ())
        kl = len(lo_key)
        if kl:
            fn = (bisect.bisect_right if m["lo_strict"]
                  else bisect.bisect_left)
            start = fn(entries, lo_key, key=lambda e: e[0][:kl])
        else:
            start = 0
        if m["hi"] is not None:
            hi_key = eq_vals + (m["hi"],)
            kh = len(hi_key)
            fn = (bisect.bisect_left if m["hi_strict"]
                  else bisect.bisect_right)
            end = fn(entries, hi_key, key=lambda e: e[0][:kh])
        elif p:
            end = bisect.bisect_right(entries, eq_vals,
                                      key=lambda e: e[0][:p])
        else:
            end = len(entries)
        self._register_table_read(session.txn, tname, read_ts)
        pending = (self._txn_key_state(session.effects, tname)
                   if session.txn is not None else {})
        limit = int(session.vars.get("index_lookup_limit", 4096))
        # early termination is sound only when the index order is the
        # output order, nothing further filters rows, and no txn
        # overlay could add rows that sort earlier
        want = None
        if m["order_ok"] and not m["residual"] and not pending \
                and sel.limit is not None:
            want = sel.limit + (sel.offset or 0)
        rows = []
        for i in range(start, end):
            _vals, ci, ri = entries[i]
            c = td.chunks[ci]
            if not (c.mvcc_ts[ri] <= rts < c.mvcc_del[ri]):
                continue
            row = self.store.extract_row(td, c, ri)
            if pending and td.codec.key(row) in pending:
                continue
            rows.append(row)
            if want is not None and len(rows) >= want:
                break
            if len(rows) > limit:
                return None  # low selectivity: the compiled scan wins
        for r in pending.values():
            if r is None:
                continue
            vals = tuple(r.get(cn) for cn in m["cols"])
            if any(v is None for v in vals) or vals[:p] != eq_vals:
                continue
            if p < len(m["cols"]):
                v = vals[p]
                if m["lo"] is not None and (
                        v < m["lo"] or (m["lo_strict"] and v == m["lo"])):
                    continue
                if m["hi"] is not None and (
                        v > m["hi"] or (m["hi_strict"] and v == m["hi"])):
                    continue
            rows.append(r)
        return self._fastpath_project(sel, session, td, rows, rts,
                                      apply_where=m["residual"])

    def _fastpath_project(self, sel: ast.Select, session: Session,
                          td, rows: list, rts: int,
                          apply_where: bool = True) -> Result:
        """Shared fastpath tail: residual WHERE over a mini chunk
        (skipped when the key consumed every conjunct), projection,
        ORDER BY / OFFSET / LIMIT, client decode."""
        tname = sel.table.name
        if apply_where and rows and sel.where is not None:
            scope, _ = self._dml_scope(tname)
            predf = self._chunk_pred(tname, sel.where, scope, session)
            mask = np.asarray(predf(self._delta_chunk(td, rows, rts)))
            rows = [r for r, keep in zip(rows, mask) if keep]
        schema = td.schema
        out: list[tuple[str, object]] = []  # (output name, column)
        for item in sel.items:
            if item.star:
                for c in schema.columns:
                    if not c.hidden:
                        out.append((c.name, c))
            else:
                col = schema.column(item.expr.name)
                out.append((item.alias or item.expr.name, col))
        names = [n for n, _ in out]
        types = [c.type for _, c in out]
        res_rows = [tuple(decode_storage_value(r.get(c.name), c.type)
                          for _, c in out) for r in rows]
        if sel.order_by:
            res_rows = _sort_decoded(res_rows, names, sel.order_by)
        if sel.offset:
            res_rows = res_rows[sel.offset:]
        if sel.limit is not None:
            res_rows = res_rows[:sel.limit]
        return Result(names=names, rows=res_rows, types=types)


def _sort_decoded(rows: list, names: list, order_by) -> list:
    """Host sort of decoded rows by output columns or positions; pg
    NULL ordering (last for asc, first for desc)."""
    out = list(rows)
    for ob in reversed(order_by):
        if isinstance(ob.expr, ast.Literal) \
                and isinstance(ob.expr.value, int):
            i = ob.expr.value - 1
        elif isinstance(ob.expr, ast.ColumnRef) and ob.expr.name in names:
            i = names.index(ob.expr.name)
        else:
            raise EngineError("ORDER BY must reference output columns")
        null_first = (ob.nulls_first if ob.nulls_first is not None
                      else ob.desc)

        def key(r, i=i, nf=null_first, desc=ob.desc):
            v = r[i]
            # pre-reverse the null flag so the presented order puts
            # NULLs where nulls_first says
            flag = (v is None) if desc == nf else (v is not None)
            return (flag, 0 if v is None else v)
        out.sort(key=key, reverse=ob.desc)
    return out
