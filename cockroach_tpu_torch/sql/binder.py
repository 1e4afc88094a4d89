"""Semantic analysis: resolve names, assign types, lower to physical.

The binder (the analogue of optbuilder + sem/eval's type checking,
pkg/sql/opt/optbuilder/builder.go:184) turns parser AST into the bound
tree of bound.py. All host-only computation happens here so the
executor sees pure device-expressible operations:

- decimal literals/arithmetic are lowered to scaled-int64 ops with
  explicit rescales (scales tracked in SQLType);
- date/timestamp/interval literals are parsed and constant arithmetic
  on them is folded (calendar math never reaches the device);
- predicates over dictionary-encoded string columns become integer
  code comparisons, or code-set lookups for LIKE/ordered compares
  (BDictLookup: a precomputed bool table indexed by code — the binder
  evaluates the predicate against the dictionary once, so a LIKE over
  600M rows costs one gather on device).
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import ast
from . import datum as dtm
from .bound import (BAggRef, BBetween, BBin, BCase, BCast, BCoalesce, BCol,
                    BConst, BDictGather, BDictLookup, BDictRemap, BExpr,
                    BExtract, BFunc, BInList, BIsNull, BoundAgg,
                    BoundWindow, BUnary, BWinRef)
from .types import (BOOL, DATE, FLOAT8, INT8, INTERVAL, STRING, TIMESTAMP,
                    Family, SQLType, common_numeric_type)

AGG_FUNCS = {"sum", "count", "min", "max", "avg"}

EPOCH = datetime.date(1970, 1, 1)


class BindError(Exception):
    pass


@dataclass
class ColumnBinding:
    batch_name: str
    type: SQLType
    dictionary: Optional[object] = None  # storage.columnstore.Dictionary


@dataclass
class Scope:
    """In-scope tables: alias -> {col -> ColumnBinding}."""
    tables: dict[str, dict[str, ColumnBinding]] = field(default_factory=dict)

    def add_table(self, alias: str, cols: dict[str, ColumnBinding]):
        if alias in self.tables:
            raise BindError(f"duplicate table alias {alias!r}")
        self.tables[alias] = cols

    def resolve(self, name: str, qualifier: Optional[str]) -> ColumnBinding:
        if qualifier is not None:
            t = self.tables.get(qualifier)
            if t is None:
                raise BindError(f"unknown table {qualifier!r}")
            b = t.get(name)
            if b is None:
                raise BindError(f"column {name!r} not in {qualifier!r}")
            return b
        hits = [t[name] for t in self.tables.values() if name in t]
        if not hits:
            raise BindError(f"unknown column {name!r}")
        if len(hits) > 1:
            raise BindError(f"ambiguous column {name!r}")
        return hits[0]

    def all_columns(self) -> list[ColumnBinding]:
        out = []
        for t in self.tables.values():
            out.extend(t.values())
        return out


# ---------------------------------------------------------------------------
# literal parsing
# ---------------------------------------------------------------------------

def parse_date(s: str) -> int:
    d = datetime.date.fromisoformat(s.strip())
    return (d - EPOCH).days


def parse_timestamp(s: str) -> int:
    s = s.strip()
    try:
        dt = datetime.datetime.fromisoformat(s)
    except ValueError as e:
        raise BindError(f"bad timestamp {s!r}") from e
    if dt.tzinfo is not None:
        dt = dt.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    return int((dt - datetime.datetime(1970, 1, 1)).total_seconds() * 1e6)


# longer unit spellings must precede their prefixes in the alternation
# (regex | is first-match: "minute" before "minutes" would strand the s)
_INTERVAL_RE = re.compile(
    r"\s*(-?\d+)\s*(years|year|months|mons|month|mon|days|day|"
    r"hours|hour|minutes|mins|minute|min|seconds|secs|second|sec)\s*",
    re.I)


@dataclass
class Interval:
    months: int = 0
    days: int = 0
    micros: int = 0


def parse_interval(s: str) -> Interval:
    iv = Interval()
    pos = 0
    matched = False
    for m in _INTERVAL_RE.finditer(s):
        if m.start() != pos:
            break
        pos = m.end()
        matched = True
        qty = int(m.group(1))
        unit = m.group(2).lower()
        if unit.startswith("year"):
            iv.months += 12 * qty
        elif unit.startswith("mon"):
            iv.months += qty
        elif unit.startswith("day"):
            iv.days += qty
        elif unit.startswith("hour"):
            iv.micros += qty * 3_600_000_000
        elif unit.startswith("min"):
            iv.micros += qty * 60_000_000
        else:
            iv.micros += qty * 1_000_000
    if not matched or pos != len(s.rstrip()):
        raise BindError(f"bad interval {s!r}")
    return iv


def add_interval_to_date(days: int, iv: Interval, sign: int = 1) -> int:
    d = EPOCH + datetime.timedelta(days=days)
    if iv.months:
        total = d.year * 12 + (d.month - 1) + sign * iv.months
        y, m = divmod(total, 12)
        last = [31, 29 if _leap(y) else 28, 31, 30, 31, 30,
                31, 31, 30, 31, 30, 31][m]
        d = d.replace(year=y, month=m + 1, day=min(d.day, last))
    d += datetime.timedelta(days=sign * iv.days)
    return (d - EPOCH).days


def _leap(y: int) -> bool:
    return y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)


# ---------------------------------------------------------------------------
# binder
# ---------------------------------------------------------------------------

class Binder:
    def __init__(self, scope: Scope, subquery_eval=None,
                 now_micros: Optional[int] = None,
                 sequence_ops=None, volatile_fold_ok: bool = True,
                 dict_folds: bool = True):
        self.scope = scope
        # dict_folds=False: a string literal absent from the column's
        # dictionary binds to an impossible code (-1) compare instead
        # of folding to a constant. Folding is dictionary-CONTENT
        # dependent, so plans bound on different shards diverge
        # structurally — the host-level shuffle (distsql/shuffle.py)
        # needs every node to derive an identical stage graph.
        self.dict_folds = dict_folds
        # populated by bind_with_aggs
        self.aggs: list[BoundAgg] = []
        self._collect_aggs = False
        # subquery_eval(ast.Select) -> (rows, types): executes a
        # subquery before the main statement (the reference plans and
        # runs planTop.subqueryPlans first, sql/subquery.go); None when
        # the caller cannot execute (pure-binder contexts)
        self.subquery_eval = subquery_eval
        # statement timestamp in unix micros for now()/current_date
        self.now_micros = now_micros
        # sequence_ops(fn, seq_name, arg) -> int: volatile sequence
        # builtins (nextval/currval/setval), folded to constants at
        # bind time; None when no engine is attached
        self.sequence_ops = sequence_ops
        # window function instances (bind_with_windows)
        self.windows: list[BoundWindow] = []
        self._collect_windows = False
        # volatile builtins (nextval/random/gen_random_uuid) fold to
        # ONE constant per bind; in a SELECT with a FROM clause pg
        # evaluates them per ROW, so folding silently corrupts results.
        # plan_select sets this False for executed SELECTs; DML WHERE /
        # EXPLAIN contexts keep the (documented) per-statement fold
        self.volatile_fold_ok = volatile_fold_ok

    # -- main dispatch -------------------------------------------------------
    def bind(self, e: ast.Expr) -> BExpr:
        if isinstance(e, ast.Literal):
            return self.bind_literal(e)
        if isinstance(e, ast.ColumnRef):
            b = self.scope.resolve(e.name, e.table)
            return BCol(b.batch_name, b.type)
        if isinstance(e, ast.BinOp):
            return self.bind_binop(e)
        if isinstance(e, ast.UnaryOp):
            o = self.bind(e.operand)
            if e.op == "not":
                if o.type.family == Family.UNKNOWN:
                    return BConst(None, BOOL)  # NOT NULL is NULL
                if o.type.family != Family.BOOL:
                    raise BindError("NOT requires boolean")
                return BUnary("not", o, BOOL)
            if isinstance(o, BConst) and o.value is not None:
                return BConst(-o.value, o.type)
            return BUnary("-", o, o.type)
        if isinstance(e, ast.Between):
            x = self.bind(e.expr)
            if x.type.family == Family.STRING:
                # a dictionary column orders through its dictionary:
                # bind x >= lo AND x <= hi, whose ordered compares
                # become dictionary lookups
                rng = self.bind(ast.BinOp("and",
                                          ast.BinOp(">=", e.expr, e.lo),
                                          ast.BinOp("<=", e.expr, e.hi)))
                return BUnary("not", rng, BOOL) if e.negated else rng
            lo = self.coerce(self.bind(e.lo), x.type)
            hi = self.coerce(self.bind(e.hi), x.type)
            x, lo, hi = self._align3(x, lo, hi)
            return BBetween(x, lo, hi, e.negated, BOOL)
        if isinstance(e, ast.InList):
            return self.bind_in(e)
        if isinstance(e, ast.IsNull):
            return BIsNull(self.bind(e.expr), e.negated, BOOL)
        if isinstance(e, ast.Case):
            return self.bind_case(e)
        if isinstance(e, ast.Subscript):
            return self.bind_subscript(e)
        if isinstance(e, ast.ArrayLit):
            return self.bind_array_lit(e)
        if isinstance(e, ast.Cast):
            return self.bind_cast(self.bind(e.expr), e.to)
        if isinstance(e, ast.FuncCall):
            return self.bind_func(e)
        if isinstance(e, ast.WindowCall):
            return self.bind_window(e)
        if isinstance(e, ast.Extract):
            x = self.bind(e.expr)
            if x.type.family not in (Family.DATE, Family.TIMESTAMP):
                raise BindError("EXTRACT needs date/timestamp")
            return BExtract(e.part.lower(), x, INT8)
        if isinstance(e, ast.Substring):
            from . import builtins as bi
            args = [self.bind(e.expr), self.bind(e.start)]
            if e.length is not None:
                args.append(self.bind(e.length))
            for a in args[1:]:
                if not isinstance(a, BConst):
                    raise BindError("SUBSTRING bounds must be constants")
            try:
                out = bi.bind_builtin(self, "substr", args, None)
            except bi.BuiltinError as err:
                raise BindError(str(err)) from err
            if out is None:
                raise BindError("SUBSTRING binding failed")
            return out
        if isinstance(e, ast.Subquery):
            rows, types = self._run_subquery(e.select)
            if len(types) != 1:
                raise BindError("scalar subquery must return one column")
            if len(rows) > 1:
                raise BindError(
                    "more than one row returned by a subquery used as "
                    "an expression")
            val = rows[0][0] if rows else None
            return self._subquery_const(val, types[0])
        if isinstance(e, ast.Exists):
            rows, _ = self._run_subquery(e.select, limit_one=True)
            return BConst(bool(rows), BOOL)
        if isinstance(e, ast.InSubquery):
            rows, types = self._run_subquery(e.select)
            if len(types) != 1:
                raise BindError("IN subquery must return one column")
            items = [self._subquery_const(r[0], types[0]) for r in rows
                     if r[0] is not None]
            had_null = any(r[0] is None for r in rows)
            out = self._bind_in_consts(self.bind(e.expr), items,
                                       e.negated)
            if had_null:
                # three-valued IN: a NULL in the list means "maybe" —
                # x NOT IN (..., NULL) is never TRUE (false on match,
                # else NULL); x IN (..., NULL) is never FALSE. AND/OR
                # with NULL realizes exactly that truth table.
                out = BBin("and" if e.negated else "or",
                           out, BConst(None, BOOL), BOOL)
            return out
        raise BindError(f"cannot bind {e!r}")

    # -- subqueries ---------------------------------------------------------
    def _run_subquery(self, sel: ast.Select, limit_one: bool = False):
        if self.subquery_eval is None:
            raise BindError("subqueries not supported in this context")
        try:
            return self.subquery_eval(sel, limit_one)
        except BindError as e:
            # outer-column references fail name resolution in the
            # subquery's own scope: report it as what it is
            raise BindError(
                f"correlated subqueries not supported ({e})") from e

    def _subquery_const(self, val, ty: SQLType) -> BConst:
        """Re-encode a decoded subquery result value to physical form."""
        if val is None:
            return BConst(None, SQLType.unknown())
        f = ty.family
        if f == Family.DECIMAL:
            return BConst(int(round(float(val) * 10 ** ty.scale)), ty)
        if f == Family.DATE:
            return BConst((val - EPOCH).days
                          if isinstance(val, datetime.date) else int(val), ty)
        if f == Family.TIMESTAMP:
            if isinstance(val, datetime.datetime):
                us = int((val - datetime.datetime(1970, 1, 1))
                         .total_seconds() * 1e6)
                return BConst(us, ty)
            return BConst(int(val), ty)
        return BConst(val, ty)

    def _bind_in_consts(self, x: BExpr, items: list[BConst],
                        negated: bool) -> BExpr:
        """IN over pre-bound constant items (subquery results)."""
        if x.type.family == Family.STRING:
            d = self._dict_of(x)
            if d is None:
                raise BindError("IN on non-dictionary string column")
            vals = [d.codes[c.value] for c in items
                    if c.value in d.codes]
            if not vals:
                return BConst(negated, BOOL)
            return BInList(x, vals, negated, BOOL)
        vals = []
        target = x.type
        for c in items:
            if x.type.is_numeric:
                target = common_numeric_type(target, c.type)
        x2 = self.coerce(x, target) if x.type != target else x
        for c in items:
            vals.append(self.coerce(c, target).value)
        if not vals:
            return BConst(negated, BOOL)
        return BInList(x2, vals, negated, BOOL)

    def bind_literal(self, e: ast.Literal) -> BExpr:
        v, th = e.value, e.type_hint
        if v is None:
            return BConst(None, SQLType.unknown())
        if th is not None and th.family == Family.DATE:
            return BConst(parse_date(v), DATE)
        if th is not None and th.family == Family.TIMESTAMP:
            return BConst(parse_timestamp(v), TIMESTAMP)
        if th is not None and th.family == Family.INTERVAL:
            iv = parse_interval(v)
            c = BConst(iv, INTERVAL)
            return c
        if isinstance(v, bool):
            return BConst(v, BOOL)
        if isinstance(v, int):
            return BConst(v, INT8)
        if isinstance(v, str) and th is None:
            # number-looking strings come from decimal literals
            if re.fullmatch(r"-?\d*\.\d+([eE][-+]?\d+)?|-?\d+[eE][-+]?\d+", v):
                scale = len(v.split(".")[1].split("e")[0].split("E")[0]) \
                    if "." in v else 0
                if "e" in v.lower():
                    return BConst(float(v), FLOAT8)
                return BConst(int(round(float(v) * 10 ** scale)),
                              SQLType.decimal(scale=scale))
            return BConst(v, STRING)
        if isinstance(v, float):
            return BConst(v, FLOAT8)
        raise BindError(f"cannot type literal {v!r}")

    # -- coercion ------------------------------------------------------------
    def coerce(self, e: BExpr, target: SQLType) -> BExpr:
        """Coerce e toward target's family (constants fold)."""
        t = e.type
        if t.family == target.family:
            if t.family == Family.DECIMAL and t.scale != target.scale:
                return self._rescale_decimal(e, target.scale)
            return e
        if t.family == Family.UNKNOWN:
            e.type = target
            return e
        if isinstance(e, BConst):
            return self._const_to(e, target)
        if t.family == Family.INT and target.family == Family.DECIMAL:
            return BBin("*", e, BConst(10 ** target.scale, INT8), target)
        if t.family == Family.INT and target.family == Family.FLOAT:
            return BCast(e, FLOAT8)
        if t.family == Family.DECIMAL and target.family == Family.FLOAT:
            return BCast(e, FLOAT8)
        if t.family == Family.STRING and target.family == Family.DATE \
                and isinstance(e, BConst):
            return BConst(parse_date(e.value), DATE)
        if t.family == Family.DATE and target.family == Family.TIMESTAMP:
            # days -> micros: a date is midnight of that day
            return BBin("*", e, BConst(86_400_000_000, INT8), TIMESTAMP)
        raise BindError(f"cannot coerce {t} to {target}")

    def _const_to(self, e: BConst, target: SQLType) -> BConst:
        v = e.value
        f = target.family
        if v is None:
            return BConst(None, target)
        if f in (Family.JSON, Family.ARRAY):
            if e.type.family == f:
                # re-canonicalize (e.g. INT[] -> FLOAT[] not supported;
                # same family means text is already canonical)
                return BConst(v, target) if e.type == target else \
                    BConst(dtm.canon_text(str(v), target), target)
            if isinstance(v, str):
                try:
                    return BConst(dtm.canon_text(v, target), target)
                except dtm.DatumError as err:
                    raise BindError(str(err)) from None
            raise BindError(f"cannot convert constant {v!r} to {target}")
        if e.type.family in (Family.JSON, Family.ARRAY) \
                and f == Family.STRING:
            return BConst(str(v), STRING)
        if f == Family.DECIMAL:
            if e.type.family == Family.DECIMAL:
                return self._rescale_decimal(e, target.scale)
            return BConst(int(round(float(v) * 10 ** target.scale)), target)
        if f == Family.FLOAT:
            if e.type.family == Family.DECIMAL:
                return BConst(float(v) / 10 ** e.type.scale, FLOAT8)
            return BConst(float(v), FLOAT8)
        if f == Family.INT:
            if e.type.family == Family.DECIMAL:
                # v is the scaled physical value; cast rounds the logical
                # value half-away-from-zero (SQL semantics)
                logical = v / 10 ** e.type.scale
                return BConst(int(logical + (0.5 if logical >= 0 else -0.5)),
                              target)
            if isinstance(v, float):
                return BConst(round(v), target)  # half-even (pg float8)
            if isinstance(v, str):
                try:
                    return BConst(int(v.strip()), target)
                except ValueError:
                    raise BindError(
                        f"cannot convert constant {v!r} to {target}") \
                        from None
            return BConst(int(v), target)
        if f == Family.DATE and isinstance(v, str):
            return BConst(parse_date(v), DATE)
        if f == Family.TIMESTAMP and isinstance(v, str):
            return BConst(parse_timestamp(v), TIMESTAMP)
        if f in (Family.DATE, Family.TIMESTAMP) \
                and e.type.family == f and isinstance(v, int):
            return BConst(v, target)  # already physical (days / micros)
        if f == Family.TIMESTAMP and e.type.family == Family.DATE \
                and isinstance(v, int):
            return BConst(v * 86_400_000_000, TIMESTAMP)  # days -> us
        if f == Family.DATE and e.type.family == Family.TIMESTAMP \
                and isinstance(v, int):
            return BConst(v // 86_400_000_000, DATE)
        if f == Family.STRING:
            if isinstance(v, str):
                return BConst(v, STRING)
            if isinstance(v, bool):
                return BConst("true" if v else "false", STRING)
            if e.type.family == Family.DECIMAL:
                return BConst(f"{v / 10 ** e.type.scale:.{e.type.scale}f}",
                              STRING)
            if isinstance(v, (int, float)):
                return BConst(str(v), STRING)
        if f == Family.BOOL:
            if isinstance(v, str):
                s = v.strip().lower()
                if s in ("t", "true", "yes", "on", "1"):
                    return BConst(True, target)
                if s in ("f", "false", "no", "off", "0"):
                    return BConst(False, target)
                raise BindError(f"invalid bool value {v!r}")
            if isinstance(v, (bool, int)):
                return BConst(bool(v), target)
        raise BindError(f"cannot convert constant {v!r} to {target}")

    def _rescale_decimal(self, e: BExpr, scale: int) -> BExpr:
        cur = e.type.scale
        if cur == scale:
            return e
        ty = SQLType.decimal(scale=scale)
        if isinstance(e, BConst):
            if e.value is None:
                return BConst(None, ty)
            if scale > cur:
                return BConst(e.value * 10 ** (scale - cur), ty)
            # numeric rounds half away from zero on scale reduction
            div = 10 ** (cur - scale)
            q, r = divmod(abs(e.value), div)
            mag = q + (1 if 2 * r >= div else 0)
            return BConst(-mag if e.value < 0 else mag, ty)
        if scale > cur:
            return BBin("*", e, BConst(10 ** (scale - cur), INT8), ty)
        return BBin("//", e, BConst(10 ** (cur - scale), INT8), ty)

    def _align2(self, a: BExpr, b: BExpr) -> tuple[BExpr, BExpr, SQLType]:
        """Align two operands to a common physical type for +,-,cmp."""
        ta, tb = a.type, b.type
        if ta.family == Family.STRING or tb.family == Family.STRING:
            return a, b, STRING
        if {ta.family, tb.family} <= {Family.DATE, Family.INT}:
            return a, b, DATE if Family.DATE in (ta.family, tb.family) else ta
        target = common_numeric_type(ta, tb)
        return self.coerce(a, target), self.coerce(b, target), target

    def _align3(self, x, lo, hi):
        x2, lo2, _ = self._align2(x, lo)
        x3, hi2, _ = self._align2(x2, hi)
        # re-align lo in case x changed scale
        x4, lo3, _ = self._align2(x3, lo2)
        return x4, lo3, hi2

    # -- operators -----------------------------------------------------------
    def bind_binop(self, e: ast.BinOp) -> BExpr:
        op = e.op
        if op in ("and", "or"):
            l, r = self.bind(e.left), self.bind(e.right)
            for s in (l, r):
                if s.type.family not in (Family.BOOL, Family.UNKNOWN):
                    raise BindError(f"{op.upper()} requires booleans")
            return BBin(op, l, r, BOOL)
        if op == "like":
            return self.bind_like(e)
        l, r = self.bind(e.left), self.bind(e.right)

        # interval constant folding: date +/- interval, timestamp +/- interval
        for a, b, sign_sw in ((l, r, False), (r, l, True)):
            if b.type.family == Family.INTERVAL:
                if not isinstance(b, BConst):
                    raise BindError("non-constant intervals unsupported")
                if op not in ("+", "-"):
                    raise BindError(f"bad interval op {op}")
                sign = -1 if (op == "-" and not sign_sw) else 1
                if sign_sw and op == "-":
                    raise BindError("interval - date is invalid")
                return self._fold_interval(a, b.value, sign)

        # json/array operators and datum-typed operands take the
        # dictionary-LUT path (host-precomputed per-entry tables)
        datum_fams = (Family.JSON, Family.ARRAY)
        if op in ("->", "->>", "@>", "<@", "?") or (
                op in ("=", "!=", "<>", "||")
                and (l.type.family in datum_fams
                     or r.type.family in datum_fams)):
            return self._bind_datum_op("!=" if op == "<>" else op, l, r)
        if op in ("<", "<=", ">", ">=") and (
                l.type.family in datum_fams
                or r.type.family in datum_fams):
            raise BindError(
                "array/jsonb values are not orderable here (codes "
                "order by insertion, not value; only =/!= supported)")

        if op in ("=", "!=", "<>", "<", "<=", ">", ">="):
            if op == "<>":
                op = "!="
            # string comparisons against dict-encoded columns
            s = self._bind_string_compare(op, l, r)
            if s is not None:
                return s
            l2, r2, _ = self._align2(l, r)
            return BBin(op, l2, r2, BOOL)
        if op in ("+", "-"):
            if op == "-" and l.type.family == Family.DATE \
                    and r.type.family == Family.DATE:
                return BBin("-", l, r, INT8)  # day-count difference
            if op == "-" and l.type.family == Family.TIMESTAMP \
                    and r.type.family == Family.TIMESTAMP:
                return BBin("-", l, r, INTERVAL)  # microseconds
            l2, r2, t = self._align2(l, r)
            return BBin(op, l2, r2, t)
        if op == "*":
            return self.bind_mul(l, r)
        if op == "/":
            l2 = self.coerce(l, FLOAT8) if l.type.family != Family.FLOAT else l
            r2 = self.coerce(r, FLOAT8) if r.type.family != Family.FLOAT else r
            return BBin("/", l2, r2, FLOAT8)
        if op == "%":
            l2, r2, t = self._align2(l, r)
            return BBin("%", l2, r2, t)
        if op == "^":
            from . import builtins as bi
            try:
                return bi.bind_builtin(self, "pow", [l, r], e)
            except bi.BuiltinError as err:
                raise BindError(str(err)) from err
        if op == "||":
            # unlike concat() (which skips NULL args, pg-style), the
            # || operator is strict: NULL || x IS NULL
            if (isinstance(l, BConst) and l.value is None) or \
                    (isinstance(r, BConst) and r.value is None):
                return BConst(None, STRING)
            from . import builtins as bi
            try:
                out = bi.bind_builtin(self, "concat", [l, r], e)
            except bi.BuiltinError as err:
                raise BindError(str(err)) from err
            return out
        raise BindError(f"unknown operator {op}")

    def bind_mul(self, l: BExpr, r: BExpr) -> BExpr:
        tl, tr = l.type, r.type
        if Family.FLOAT in (tl.family, tr.family):
            return BBin("*", self.coerce(l, FLOAT8), self.coerce(r, FLOAT8),
                        FLOAT8)
        if tl.family == Family.DECIMAL and tr.family == Family.DECIMAL:
            # scaled-int multiply: scales add (rescale happens only on
            # explicit cast or output)
            ty = SQLType.decimal(scale=tl.scale + tr.scale)
            return BBin("*", l, r, ty)
        if tl.family == Family.DECIMAL or tr.family == Family.DECIMAL:
            dec, other = (l, r) if tl.family == Family.DECIMAL else (r, l)
            if other.type.family != Family.INT:
                raise BindError(f"cannot multiply {tl} by {tr}")
            return BBin("*", dec, other, dec.type)
        l2, r2, t = self._align2(l, r)
        return BBin("*", l2, r2, t)

    def _fold_interval(self, d: BExpr, iv: Interval, sign: int) -> BExpr:
        if d.type.family == Family.DATE:
            if isinstance(d, BConst):
                return BConst(add_interval_to_date(d.value, iv, sign), DATE)
            if iv.months == 0 and iv.micros == 0:
                return BBin("+", d, BConst(sign * iv.days, INT8), DATE)
            raise BindError("month intervals on non-constant dates")
        if d.type.family == Family.TIMESTAMP:
            if iv.months == 0:
                delta = sign * (iv.days * 86_400_000_000 + iv.micros)
                if isinstance(d, BConst):
                    return BConst(d.value + delta, TIMESTAMP)
                return BBin("+", d, BConst(delta, INT8), TIMESTAMP)
            raise BindError("month intervals on timestamps")
        raise BindError(f"interval arithmetic on {d.type}")

    # -- strings over dictionaries --------------------------------------------
    def _dict_of(self, e: BExpr):
        # nodes that carry their own output dictionary (string builtins,
        # CASE over constants) chain transforms: upper(trim(col)) works
        d = getattr(e, "dictionary", None)
        if d is not None:
            return d
        if isinstance(e, BCol) and e.type.uses_dictionary:
            for t in self.scope.tables.values():
                for b in t.values():
                    if b.batch_name == e.name:
                        return b.dictionary
        return None

    def _string_coalesce(self, args: list) -> BExpr:
        """COALESCE over STRING arguments: every argument re-encodes into
        one output dictionary (a column through a code remap, a literal
        as its code), so the first valid code decodes to its own string.
        The reference passes the literal's text to the device and
        fails."""
        if not any(isinstance(a, BConst) and isinstance(a.value, str)
                   for a in args):
            return BCoalesce(args, STRING)
        from ..storage.columnstore import Dictionary
        d2 = Dictionary()
        out_args = []
        for a in args:
            if isinstance(a, BConst):
                out_args.append(BConst(None if a.value is None
                                       else d2.encode(str(a.value)), STRING))
                continue
            src = self._dict_of(a)
            if src is None:
                raise BindError("COALESCE over a string expression "
                                "without a dictionary")
            table = np.fromiter((d2.encode(v) for v in src.values),
                                dtype=np.int32, count=len(src.values))
            out_args.append(BDictRemap(a, table, STRING))
        out = BCoalesce(out_args, STRING)
        out.dictionary = d2
        return out

    def _bind_string_compare(self, op, l, r):
        if l.type.family != Family.STRING and r.type.family != Family.STRING:
            return None
        if isinstance(l, BConst) and isinstance(r, BConst):
            if l.value is None or r.value is None:
                return BConst(None, BOOL)
            lv, rv = str(l.value), str(r.value)
            res = {"=": lv == rv, "!=": lv != rv, "<": lv < rv,
                   "<=": lv <= rv, ">": lv > rv, ">=": lv >= rv}[op]
            return BConst(res, BOOL)
        col, lit, flip = None, None, False
        if isinstance(r, BConst) and isinstance(r.value, str):
            col, lit = l, r.value
        elif isinstance(l, BConst) and isinstance(l.value, str):
            col, lit, flip = r, l.value, True
        if col is None:
            # col-col string compare
            if isinstance(l, BCol) and isinstance(r, BCol) and op in ("=", "!="):
                dl, dr = self._dict_of(l), self._dict_of(r)
                if dl is dr:
                    return BBin(op, l, r, BOOL)
                if dl is not None and dr is not None:
                    # translate r's codes into l's code space (host-side
                    # table; on device it's one gather — join keys ride this)
                    table = np.fromiter(
                        (dl.codes.get(v, -1) for v in dr.values),
                        dtype=np.int32, count=len(dr.values))
                    return BBin(op, l, BDictRemap(r, table, l.type), BOOL)
            raise BindError("unsupported string comparison")
        d = self._dict_of(col)
        if d is None:
            raise BindError("string compare on non-dictionary column")
        if flip:
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if op == "=":
            code = d.codes.get(lit)
            if code is None:
                if not self.dict_folds:
                    return BBin("=", col, BConst(-1, col.type), BOOL)
                return BConst(False, BOOL)  # value absent from data
            return BBin("=", col, BConst(code, col.type), BOOL)
        if op == "!=":
            code = d.codes.get(lit)
            if code is None:
                if not self.dict_folds:
                    return BBin("!=", col, BConst(-1, col.type), BOOL)
                return BConst(True, BOOL)
            return BBin("!=", col, BConst(code, col.type), BOOL)
        # ordered compare: evaluate against dictionary -> lookup table
        vals = np.asarray(d.values, dtype=object)
        pyop = {"<": np.less, "<=": np.less_equal,
                ">": np.greater, ">=": np.greater_equal}[op]
        table = pyop(vals.astype(str), lit)
        return BDictLookup(col, np.asarray(table, dtype=bool), BOOL)

    def bind_like(self, e: ast.BinOp) -> BExpr:
        col = self.bind(e.left)
        pat = self.bind(e.right)
        if isinstance(pat, BConst) and pat.value is None:
            return BConst(None, BOOL)  # x LIKE NULL is NULL
        if not isinstance(pat, BConst) or not isinstance(pat.value, str):
            raise BindError("LIKE pattern must be a constant")
        rx = re.compile(
            "^" + re.escape(pat.value).replace("%", ".*").replace("_", ".")
            + "$", re.S)
        if isinstance(col, BConst):
            if col.value is None:
                return BConst(None, BOOL)  # NULL LIKE p is NULL
            return BConst(rx.match(str(col.value)) is not None, BOOL)
        d = self._dict_of(col)
        if d is None:
            raise BindError("LIKE on non-dictionary column")
        table = np.fromiter((rx.match(v) is not None for v in d.values),
                            dtype=bool, count=len(d.values))
        return BDictLookup(col, table, BOOL)

    # -- datum types (ARRAY / JSONB) over dictionaries ------------------------
    #
    # Same playbook as strings: each distinct value is interned under
    # its canonical text (sql/datum.py), so per-row operators become
    # host-precomputed tables over the dictionary — one
    # BDictLookup/BDictRemap/BDictGather on device. The reference
    # instead walks per-element host objects through tree.Datum
    # (coldata/datum_vec.go, util/json) — per-row host work we never do.

    _MISSING = object()

    def _datum_dict(self, col: BExpr):
        d = self._dict_of(col)
        if d is None:
            raise BindError(
                f"{col.type} operator on a column with no dictionary")
        parsed = [dtm.decode_text(v, col.type) for v in d.values]
        return d, parsed

    @staticmethod
    def _json_get(pv, key):
        """jsonb -> field/element access; _MISSING when absent."""
        if isinstance(pv, dict) and isinstance(key, str):
            return pv.get(key, Binder._MISSING)
        if isinstance(pv, list) and isinstance(key, int) \
                and not isinstance(key, bool):
            i = key if key >= 0 else len(pv) + key
            return pv[i] if 0 <= i < len(pv) else Binder._MISSING
        return Binder._MISSING

    @staticmethod
    def _json_contains(a, b) -> bool:
        """jsonb @> containment (pg semantics, recursive)."""
        if isinstance(a, dict) and isinstance(b, dict):
            return all(k in a and Binder._json_contains(a[k], v)
                       for k, v in b.items())
        if isinstance(a, list):
            if isinstance(b, list):
                return all(any(Binder._json_contains(x, y) for x in a)
                           for y in b)
            # a scalar is contained in a top-level array (pg quirk)
            return any(Binder._json_contains(x, b) for x in a)
        return a == b

    def _datum_rhs_value(self, r: BConst, ty):
        """Parse the constant right operand of a datum operator."""
        if r.value is None:
            return None
        if r.type.family in (Family.JSON, Family.ARRAY):
            return dtm.decode_text(r.value, r.type)
        if ty.family == Family.JSON and isinstance(r.value, str) \
                and r.type.family == Family.STRING:
            # bare string literal on @>/? : treat as jsonb when it
            # parses ('{"a":1}'), else as a key string
            return r.value
        return r.value

    def _bind_datum_op(self, op: str, l: BExpr, r: BExpr) -> BExpr:
        from ..storage.columnstore import Dictionary
        if op == "<@":
            return self._bind_datum_op("@>", r, l)
        if op in ("=", "!="):
            return self._datum_eq(op, l, r)
        if op == "||":
            return self._datum_concat(l, r)
        # -> / ->> / @> / ? : constant right operand required (the LUT
        # is precomputed per dictionary entry)
        if isinstance(l, BConst) and isinstance(r, BConst):
            return self._fold_datum_op(op, l, r)
        if not isinstance(r, BConst):
            raise BindError(f"{op} requires a constant right operand")
        if l.type.family not in (Family.JSON, Family.ARRAY):
            raise BindError(f"{op} on {l.type}")
        if r.value is None:
            # NULL result types: predicates are BOOL, ->> is text,
            # -> keeps the datum type (matches the fold path)
            return BConst(None, BOOL if op in ("@>", "?")
                          else STRING if op == "->>" else l.type)
        d, parsed = self._datum_dict(l)
        rv = self._datum_rhs_value(r, l.type)

        if op in ("->", "->>"):
            if l.type.family != Family.JSON:
                raise BindError(f"{op} on {l.type}")
            if isinstance(r.value, int) and r.type.family == Family.INT:
                key = int(r.value)
            elif isinstance(rv, str):
                key = rv
            else:
                raise BindError(f"{op} key must be a string or integer")
            results = [self._json_get(pv, key) for pv in parsed]
            if op == "->":
                d2 = Dictionary()
                table = np.fromiter(
                    (d2.encode(dtm.canon_json(res))
                     if res is not Binder._MISSING else -1
                     for res in results),
                    dtype=np.int32, count=len(results))
                nulls = np.fromiter(
                    (res is not Binder._MISSING for res in results),
                    dtype=bool, count=len(results))
                out = BDictRemap(l, table, SQLType.json(),
                                 null_table=nulls)
                out.dictionary = d2
                return out
            # ->> : text, with JSON null and missing both SQL NULL
            d2 = Dictionary()
            texts = [None if res is Binder._MISSING or res is None
                     else (res if isinstance(res, str)
                           else dtm.canon_json(res))
                     for res in results]
            table = np.fromiter(
                (d2.encode(t) if t is not None else -1 for t in texts),
                dtype=np.int32, count=len(texts))
            nulls = np.fromiter((t is not None for t in texts),
                                dtype=bool, count=len(texts))
            out = BDictRemap(l, table, STRING, null_table=nulls)
            out.dictionary = d2
            return out

        if op == "@>":
            if l.type.family == Family.JSON:
                if isinstance(rv, str) and r.type.family == Family.STRING:
                    rv = dtm.parse_json(rv)
                table = np.fromiter(
                    (self._json_contains(pv, rv) for pv in parsed),
                    dtype=bool, count=len(parsed))
            else:
                if not isinstance(rv, list):
                    raise BindError("array @> needs an array operand")
                table = np.fromiter(
                    (all(y in pv for y in rv) for pv in parsed),
                    dtype=bool, count=len(parsed))
            return BDictLookup(l, table, BOOL)

        if op == "?":
            if not isinstance(rv, str):
                raise BindError("? needs a string key")

            def has_key(pv):
                if isinstance(pv, dict):
                    return rv in pv
                if isinstance(pv, list):
                    return rv in pv
                return pv == rv
            table = np.fromiter((has_key(pv) for pv in parsed),
                                dtype=bool, count=len(parsed))
            return BDictLookup(l, table, BOOL)

        raise BindError(f"unsupported datum operator {op}")

    def _datum_eq(self, op: str, l: BExpr, r: BExpr) -> BExpr:
        if isinstance(l, BConst) and not isinstance(r, BConst):
            l, r = r, l
        if isinstance(l, BConst) and isinstance(r, BConst):
            if l.value is None or r.value is None:
                return BConst(None, BOOL)
            eq = str(l.value) == str(r.value)  # canonical text
            return BConst(eq if op == "=" else not eq, BOOL)
        if isinstance(r, BConst):
            if r.value is None:
                return BConst(None, BOOL)
            d = self._dict_of(l)
            if d is None:
                raise BindError("datum compare on non-dictionary column")
            if r.type.family in (Family.JSON, Family.ARRAY):
                text = r.value
            else:
                try:
                    text = dtm.canon_text(str(r.value), l.type)
                except dtm.DatumError as err:
                    raise BindError(str(err)) from None
            code = d.codes.get(text)
            if code is None:
                if not self.dict_folds:
                    return BBin(op, l, BConst(-1, l.type), BOOL)
                return BConst(op == "!=", BOOL)
            return BBin(op, l, BConst(code, l.type), BOOL)
        # col-col: same dictionary -> direct code compare; else remap
        dl, dr = self._dict_of(l), self._dict_of(r)
        if dl is None or dr is None:
            raise BindError("datum compare on non-dictionary column")
        if dl is dr:
            return BBin(op, l, r, BOOL)
        table = np.fromiter((dl.codes.get(v, -1) for v in dr.values),
                            dtype=np.int32, count=len(dr.values))
        return BBin(op, l, BDictRemap(r, table, l.type), BOOL)

    def _datum_concat(self, l: BExpr, r: BExpr) -> BExpr:
        from ..storage.columnstore import Dictionary
        if isinstance(l, BConst) and not isinstance(r, BConst):
            raise BindError("const || column arrays not supported")
        if (isinstance(l, BConst) and l.value is None) or \
                (isinstance(r, BConst) and r.value is None):
            return BConst(None, l.type if not isinstance(l, BConst)
                          or l.value is not None else r.type)
        # jsonb || jsonb: a bare string literal operand must BE jsonb
        # (pg rejects jsonb || text); parse it so '{"z":true}' merges
        # as an object instead of appending as a scalar string
        if l.type.family == Family.JSON and isinstance(r, BConst) \
                and r.type.family == Family.STRING:
            r = self._const_to(r, SQLType.json())
        if isinstance(l, BConst) and isinstance(r, BConst):
            if l.type.family == Family.ARRAY:
                elem = l.type.elem
                vals = dtm.parse_array(l.value, elem) + \
                    dtm.parse_array(r.value, r.type.elem)
                return BConst(dtm.canon_array(vals, elem), l.type)
            a, b = dtm.parse_json(l.value), dtm.parse_json(r.value)
            if isinstance(a, dict) and isinstance(b, dict):
                return BConst(dtm.canon_json({**a, **b}), l.type)
            la = a if isinstance(a, list) else [a]
            lb = b if isinstance(b, list) else [b]
            return BConst(dtm.canon_json(la + lb), l.type)
        if not isinstance(r, BConst):
            raise BindError("array || array needs a constant operand")
        d, parsed = self._datum_dict(l)
        rv = self._datum_rhs_value(r, l.type)
        d2 = Dictionary()
        if l.type.family == Family.ARRAY:
            if not isinstance(rv, list):
                rv = [rv]
            texts = [dtm.canon_array(pv + rv, l.type.elem)
                     for pv in parsed]
        else:
            def joinj(pv):
                if isinstance(pv, dict) and isinstance(rv, dict):
                    return dtm.canon_json({**pv, **rv})
                la = pv if isinstance(pv, list) else [pv]
                lb = rv if isinstance(rv, list) else [rv]
                return dtm.canon_json(la + lb)
            texts = [joinj(pv) for pv in parsed]
        table = np.fromiter((d2.encode(t) for t in texts),
                            dtype=np.int32, count=len(texts))
        out = BDictRemap(l, table, l.type)
        out.dictionary = d2
        return out

    def bind_subscript(self, e: ast.Subscript) -> BExpr:
        x = self.bind(e.expr)
        if x.type.family == Family.JSON:
            return self._bind_datum_op("->", x, self.bind(e.index))
        if x.type.family != Family.ARRAY:
            raise BindError(f"cannot subscript {x.type}")
        idx = self.bind(e.index)
        if not isinstance(idx, BConst) or \
                idx.type.family != Family.INT:
            raise BindError("array index must be a constant integer")
        i = int(idx.value)
        elem = x.type.elem
        if isinstance(x, BConst):
            if x.value is None:
                return BConst(None, elem)
            vals = dtm.parse_array(x.value, elem)
            v = vals[i - 1] if 1 <= i <= len(vals) else None
            return self._elem_const(v, elem)
        d, parsed = self._datum_dict(x)
        picks = [pv[i - 1] if 1 <= i <= len(pv) else None
                 for pv in parsed]
        return self._elem_lut(x, picks, elem)

    def _elem_const(self, v, elem: SQLType) -> BConst:
        if v is None:
            return BConst(None, elem)
        if elem.family == Family.DECIMAL:
            return BConst(int(round(float(v) * 10 ** elem.scale)), elem)
        return BConst(v, elem)

    def _elem_lut(self, col: BExpr, picks: list, elem: SQLType) -> BExpr:
        """Per-dictionary-entry element values -> one typed LUT node."""
        from ..storage.columnstore import Dictionary
        nulls = np.fromiter((p is not None for p in picks),
                            dtype=bool, count=len(picks))
        if elem.family == Family.STRING:
            d2 = Dictionary()
            table = np.fromiter(
                (d2.encode(p) if p is not None else -1 for p in picks),
                dtype=np.int32, count=len(picks))
            out = BDictRemap(col, table, STRING, null_table=nulls)
            out.dictionary = d2
            return out
        if elem.family == Family.DECIMAL:
            vals = [int(round(float(p) * 10 ** elem.scale))
                    if p is not None else 0 for p in picks]
        elif elem.family == Family.FLOAT:
            vals = [float(p) if p is not None else 0.0 for p in picks]
        elif elem.family == Family.BOOL:
            vals = [bool(p) if p is not None else False for p in picks]
        else:
            vals = [int(p) if p is not None else 0 for p in picks]
        table = np.asarray(vals, dtype=elem.np_dtype)
        return BDictGather(col, table, elem, null_table=nulls)

    def bind_array_lit(self, e: ast.ArrayLit) -> BExpr:
        items = [self.bind(i) for i in e.items]
        if not all(isinstance(b, BConst) for b in items):
            raise BindError(
                "ARRAY[...] elements must be constants (arrays built "
                "from row values are not supported)")
        fams = {b.type.family for b in items
                if b.type.family != Family.UNKNOWN}
        if not fams:
            elem = INT8
        elif fams <= {Family.INT}:
            elem = INT8
        elif fams <= {Family.INT, Family.FLOAT, Family.DECIMAL}:
            elem = FLOAT8
        elif fams == {Family.STRING}:
            elem = STRING
        elif fams == {Family.BOOL}:
            elem = BOOL
        else:
            raise BindError(f"mixed array element types {fams}")
        vals = []
        for b in items:
            if b.value is None:
                vals.append(None)
            elif b.type.family == Family.DECIMAL:
                vals.append(b.value / 10 ** b.type.scale)
            else:
                vals.append(b.value)
        return BConst(dtm.canon_array(vals, elem), SQLType.array(elem))

    def _fold_datum_op(self, op: str, l: BConst, r: BConst) -> BConst:
        if l.value is None or r.value is None:
            return BConst(None, BOOL if op in ("@>", "?")
                          else STRING if op == "->>" else l.type)
        lv = dtm.decode_text(l.value, l.type)
        rv = self._datum_rhs_value(r, l.type)
        if op in ("->", "->>"):
            key = int(r.value) if (isinstance(r.value, int)
                                   and r.type.family == Family.INT) else rv
            res = self._json_get(lv, key)
            if res is Binder._MISSING:
                return BConst(None, SQLType.json() if op == "->"
                              else STRING)
            if op == "->":
                return BConst(dtm.canon_json(res), SQLType.json())
            if res is None:
                return BConst(None, STRING)
            return BConst(res if isinstance(res, str)
                          else dtm.canon_json(res), STRING)
        if op == "@>":
            if l.type.family == Family.JSON:
                if isinstance(rv, str):
                    rv = dtm.parse_json(rv)
                return BConst(self._json_contains(lv, rv), BOOL)
            if not isinstance(rv, list):
                raise BindError("array @> needs an array operand")
            return BConst(all(y in lv for y in rv), BOOL)
        if op == "?":
            if not isinstance(rv, str):
                raise BindError("? needs a string key")
            if isinstance(lv, (dict, list)):
                return BConst(rv in lv, BOOL)
            return BConst(lv == rv, BOOL)
        raise BindError(f"unsupported datum operator {op}")

    # -- IN / CASE / CAST ------------------------------------------------------
    def bind_in(self, e: ast.InList) -> BExpr:
        x = self.bind(e.expr)
        vals = []
        if x.type.family == Family.STRING:
            d = self._dict_of(x)
            if d is None:
                raise BindError("IN on non-dictionary string column")
            has_null = False
            for item in e.items:
                b = self.bind(item)
                if not isinstance(b, BConst):
                    raise BindError("IN list must be constants")
                if b.value is None:
                    # three-valued IN: a NULL item makes a non-match
                    # NULL (ops/kernels.py in_list); the reference
                    # drops it
                    has_null = True
                    continue
                code = d.codes.get(b.value)
                if code is not None:
                    vals.append(code)
                elif not self.dict_folds:
                    vals.append(-1)   # impossible code: never matches
            if not vals:
                return BConst(None if has_null else e.negated, BOOL)
            return BInList(x, vals + [None] * has_null, e.negated, BOOL)
        # common numeric type across x and all items (so `int_col IN
        # (1.5)` compares at decimal precision instead of rounding 1.5)
        bound_items = [self.bind(i) for i in e.items]
        target = x.type
        for b in bound_items:
            target = common_numeric_type(target, b.type) \
                if x.type.is_numeric else target
        x2 = self.coerce(x, target) if x.type != target else x
        for b in bound_items:
            b2 = self.coerce(b, target)
            if not isinstance(b2, BConst):
                raise BindError("IN list must be constants")
            vals.append(b2.value)
        return BInList(x2, vals, e.negated, BOOL)

    def bind_case(self, e: ast.Case) -> BExpr:
        whens = [(self.bind(c), self.bind(v)) for c, v in e.whens]
        else_ = self.bind(e.else_) if e.else_ is not None else BConst(
            None, SQLType.unknown())
        # result type: first non-unknown branch type, all coerced to it
        rty = None
        for _, v in whens:
            if v.type.family != Family.UNKNOWN:
                rty = v.type
                break
        if rty is None:
            rty = else_.type
        if rty.family == Family.UNKNOWN:
            raise BindError("untyped CASE")
        if rty.family == Family.STRING:
            # constant string branches get an ad-hoc output dictionary
            from ..storage.columnstore import Dictionary
            d = Dictionary()

            def enc(v):
                if isinstance(v, BConst):
                    if v.value is None:
                        return BConst(None, STRING)
                    if not isinstance(v.value, str):
                        raise BindError("mixed CASE branch types")
                    return BConst(d.encode(v.value), STRING)
                raise BindError(
                    "CASE over string columns not supported (constants only)")
            whens = [(c, enc(v)) for c, v in whens]
            else_ = enc(else_) if not (isinstance(else_, BConst)
                                       and else_.value is None) else BConst(None, STRING)
            out = BCase(whens, else_, STRING)
            out.dictionary = d
            return out
        # widen decimals to max scale among branches
        if rty.family == Family.DECIMAL:
            smax = max([v.type.scale for _, v in whens
                        if v.type.family == Family.DECIMAL] +
                       ([else_.type.scale]
                        if else_.type.family == Family.DECIMAL else [0]))
            rty = SQLType.decimal(scale=smax)
        whens = [(c, self.coerce(v, rty)) for c, v in whens]
        else_ = self.coerce(else_, rty)
        return BCase(whens, else_, rty)

    def bind_cast(self, x: BExpr, to: SQLType) -> BExpr:
        if x.type.family == to.family and x.type == to:
            return x
        if x.type.family in (Family.JSON, Family.ARRAY) \
                and to.family == Family.STRING and not isinstance(x, BConst):
            # datum::TEXT — the stored canonical text IS the result;
            # identity remap re-types the codes under a string dict
            from ..storage.columnstore import Dictionary
            d = self._dict_of(x)
            if d is None:
                raise BindError("cast on non-dictionary datum column")
            d2 = Dictionary()
            table = np.fromiter((d2.encode(v) for v in d.values),
                                dtype=np.int32,
                                count=len(d.values))
            out = BDictRemap(x, table, STRING)
            out.dictionary = d2
            return out
        if isinstance(x, BConst):
            return self._const_to(x, to)
        if to.family == Family.FLOAT:
            return BCast(x, FLOAT8)
        if to.family == Family.DECIMAL:
            if x.type.family == Family.DECIMAL:
                return self._rescale_decimal(x, to.scale)
            if x.type.family == Family.INT:
                return BBin("*", x, BConst(10 ** to.scale, INT8), to)
            if x.type.family == Family.FLOAT:
                return BCast(x, to)  # executor rounds
        if to.family == Family.INT:
            return BCast(x, to)
        raise BindError(f"unsupported cast {x.type} -> {to}")

    # -- functions & aggregates --------------------------------------------
    def bind_func(self, e: ast.FuncCall) -> BExpr:
        name = e.name
        if name in ("nextval", "random", "gen_random_uuid") \
                and self.scope.tables and not self.volatile_fold_ok:
            raise BindError(
                f"{name}() in a statement with a FROM clause is not "
                "supported: it would fold to one value per statement "
                "instead of one per row")
        if name in AGG_FUNCS or name in self.STATS_AGGS \
                or name in self.BOOL_AGGS:
            if not self._collect_aggs:
                raise BindError(f"aggregate {name} not allowed here")
            return self._bind_agg(e)
        if name in ("nextval", "currval", "setval"):
            if self.sequence_ops is None:
                raise BindError(
                    f"{name} is not available in this context")
            if not e.args or not isinstance(e.args[0], ast.Literal) \
                    or not isinstance(e.args[0].value, str):
                raise BindError(
                    f"{name} takes a sequence name string literal")
            seq = e.args[0].value
            arg = None
            if name == "setval":
                if len(e.args) != 2:
                    raise BindError("setval(seq, value)")
                v = self.bind(e.args[1])
                if not isinstance(v, BConst) or v.value is None:
                    raise BindError("setval(seq, value) takes a "
                                    "constant value")
                try:
                    arg = int(v.value)
                except (TypeError, ValueError):
                    raise BindError(
                        f"setval value must be an integer, got "
                        f"{v.value!r}")
            return BConst(self.sequence_ops(name, seq, arg), INT8)
        if name == "coalesce":
            args = [self.bind(a) for a in e.args]
            rty = next((a.type for a in args
                        if a.type.family != Family.UNKNOWN), None)
            if rty is None:
                raise BindError("untyped COALESCE")
            args = [self.coerce(a, rty) for a in args]
            if rty.family == Family.STRING:
                return self._string_coalesce(args)
            return BCoalesce(args, rty)
        if name == "abs":
            x = self.bind(e.args[0])
            return BUnary("abs", x, x.type)
        if name == "round" and len(e.args) == 1:
            x = self.coerce(self.bind(e.args[0]), FLOAT8)
            return BUnary(name, x, FLOAT8)
        from . import builtins as bi
        args = [self.bind(a) for a in e.args]
        try:
            out = bi.bind_builtin(self, name, args, e)
        except bi.BuiltinError as err:
            raise BindError(str(err)) from err
        if out is not None:
            return out
        raise BindError(f"unknown function {name}")

    # statistical aggregates rewritten at bind time into compositions
    # of sum/count partials (the reference computes them the same way
    # from local sums, builtins/aggregate_builtins.go): no new device
    # kernels, and distributed/streaming merges come for free
    STATS_AGGS = {"stddev", "stddev_samp", "stddev_pop",
                  "variance", "var_samp", "var_pop"}
    BOOL_AGGS = {"bool_and": "min", "bool_or": "max", "every": "min"}

    def _reg_agg(self, spec: BoundAgg) -> BExpr:
        for i, existing in enumerate(self.aggs):
            if _agg_key(existing) == _agg_key(spec):
                return BAggRef(i, existing.type)
        self.aggs.append(spec)
        return BAggRef(len(self.aggs) - 1, spec.type)

    def _check_no_nested_agg(self, arg: BExpr) -> None:
        from .bound import walk as _walk
        for nd in _walk(arg):
            if isinstance(nd, BAggRef):
                raise BindError("nested aggregates")

    def _bind_stats_agg(self, name: str, e: ast.FuncCall) -> BExpr:
        """stddev/variance via single-pass sum-of-squares partials in
        float64. PRECISION CAVEAT (round-4 advisor): for large-mean,
        low-variance data (mean ~1e8, var ~1) the ``sum(x²)-sum(x)²/n``
        form cancels catastrophically where Postgres' Youngs-Cramer
        recurrence stays accurate; the clamp-to-0 CASE below bounds the
        failure at 0, not at a wrong positive value. The single-pass
        form is what splits across DistSQL partials (SUM/SUM/COUNT
        merge; a per-group mean-centering pre-pass would need a second
        scan). Tests pin the well-conditioned cases; document, don't
        hide, the ill-conditioned one."""
        if e.distinct:
            raise BindError(f"{name}(DISTINCT) not supported")
        if len(e.args) != 1:
            raise BindError(f"{name} takes one argument")
        x = self.coerce(self.bind(e.args[0]), FLOAT8)
        self._check_no_nested_agg(x)
        s = self._reg_agg(BoundAgg("sum", x, FLOAT8))
        ss = self._reg_agg(BoundAgg("sum", BBin("*", x, x, FLOAT8),
                                    FLOAT8))
        n = self.coerce(self._reg_agg(BoundAgg("count", x, INT8)),
                        FLOAT8)
        # var_pop = (sum(x^2) - sum(x)^2/n) / n; _samp divides by n-1
        # (NULL when the divisor is zero, pg semantics, via nullif)
        num = BBin("-", ss, BBin("/", BBin("*", s, s, FLOAT8), n,
                                 FLOAT8), FLOAT8)
        pop = name.endswith("_pop")
        div = n if pop else BBin("-", n, BConst(1.0, FLOAT8), FLOAT8)
        var = BBin("/", num, BFunc("nullif", [div,
                                              BConst(0.0, FLOAT8)],
                                   FLOAT8), FLOAT8)
        # float error can drive the numerator epsilon-negative; CASE
        # (not greatest: pg's greatest IGNORES NULLs, which would turn
        # the empty-set NULL into 0)
        var = BCase(whens=[(BBin("<", var, BConst(0.0, FLOAT8), BOOL),
                            BConst(0.0, FLOAT8))],
                    else_=var, type=FLOAT8)
        if name.startswith("stddev"):
            return BFunc("sqrt", [var], FLOAT8)
        return var

    def _bind_agg(self, e: ast.FuncCall) -> BExpr:
        name = e.name
        if name in self.STATS_AGGS:
            return self._bind_stats_agg(name, e)
        if name in self.BOOL_AGGS:
            if len(e.args) != 1:
                raise BindError(f"{name} takes one argument")
            # min/max over the 0/1 encoding (the scatter identities
            # have no bool lane); the ref casts back to BOOL
            arg = BCast(self.coerce(self.bind(e.args[0]), BOOL), INT8)
            self._check_no_nested_agg(arg)
            ref = self._reg_agg(BoundAgg(self.BOOL_AGGS[name], arg,
                                         INT8))
            return BCast(ref, BOOL)
        if name == "count" and e.star:
            spec = BoundAgg("count_rows", None, INT8)
        else:
            if len(e.args) != 1:
                raise BindError(f"{name} takes one argument")
            arg = self.bind(e.args[0])
            for a in (arg,):
                from .bound import walk
                for nd in walk(a):
                    if isinstance(nd, BAggRef):
                        raise BindError("nested aggregates")
            if name == "count":
                spec = BoundAgg("count", arg, INT8, e.distinct)
            elif name == "avg":
                spec = BoundAgg("avg", arg, FLOAT8, e.distinct)
            elif name == "sum":
                if arg.type.family == Family.INT:
                    spec = BoundAgg("sum_int", arg, INT8, e.distinct)
                elif arg.type.family == Family.DECIMAL:
                    spec = BoundAgg("sum", arg, arg.type, e.distinct)
                else:
                    spec = BoundAgg("sum", self.coerce(arg, FLOAT8), FLOAT8,
                                    e.distinct)
            elif name in ("min", "max"):
                spec = BoundAgg(name, arg, arg.type, e.distinct)
            else:
                raise BindError(name)
        if spec.distinct and spec.func in ("min", "max"):
            spec.distinct = False  # DISTINCT is a no-op for min/max
        # dedup identical aggregates
        for i, existing in enumerate(self.aggs):
            if _agg_key(existing) == _agg_key(spec):
                return BAggRef(i, existing.type)
        self.aggs.append(spec)
        return BAggRef(len(self.aggs) - 1, spec.type)

    def bind_with_aggs(self, e: ast.Expr) -> BExpr:
        self._collect_aggs = True
        try:
            return self.bind(e)
        finally:
            self._collect_aggs = False

    # -- window functions ---------------------------------------------------
    WINDOW_FUNCS = {"row_number", "rank", "dense_rank", "lag", "lead",
                    "first_value", "last_value", "ntile"}

    def bind_window(self, e: ast.WindowCall) -> BExpr:
        if not self._collect_windows:
            raise BindError("window functions not allowed here")
        name = e.func
        parts = [self.bind(p) for p in e.partition_by]
        orders = [(self.bind(o.expr), o.desc) for o in e.order_by]
        offset = 1
        arg = None
        if name in ("row_number", "rank", "dense_rank"):
            if e.args:
                raise BindError(f"{name}() takes no arguments")
            if not orders:
                raise BindError(f"{name}() requires ORDER BY")
            ty = INT8
        elif name in ("lag", "lead"):
            if not 1 <= len(e.args) <= 2:
                raise BindError(f"{name}(expr[, offset])")
            if not orders:
                raise BindError(f"{name}() requires ORDER BY")
            arg = self.bind(e.args[0])
            if len(e.args) == 2:
                off = self.bind(e.args[1])
                if not isinstance(off, BConst):
                    raise BindError(f"{name} offset must be constant")
                offset = int(off.value)
            ty = arg.type
        elif name in ("first_value", "last_value"):
            if len(e.args) != 1:
                raise BindError(f"{name}(expr)")
            arg = self.bind(e.args[0])
            ty = arg.type
        elif name == "ntile":
            if len(e.args) != 1:
                raise BindError("ntile(buckets)")
            if not orders:
                raise BindError("ntile() requires ORDER BY")
            nb = self.bind(e.args[0])
            if not isinstance(nb, BConst) \
                    or nb.type.family != Family.INT \
                    or nb.value is None or int(nb.value) < 1:
                raise BindError("ntile bucket count must be a "
                                "positive integer constant")
            offset = int(nb.value)  # bucket count rides the offset slot
            ty = INT8
        elif name == "count" and e.star:
            ty = INT8
            name = "count_rows"
        elif name in AGG_FUNCS:
            if len(e.args) != 1:
                raise BindError(f"{name} takes one argument")
            arg = self.bind(e.args[0])
            if name == "count":
                ty = INT8
            elif name == "avg":
                ty = FLOAT8
            elif name == "sum":
                if arg.type.family == Family.INT:
                    name, ty = "sum_int", INT8
                elif arg.type.family == Family.DECIMAL:
                    ty = arg.type
                else:
                    arg = self.coerce(arg, FLOAT8)
                    ty = FLOAT8
            else:  # min/max
                ty = arg.type
        else:
            raise BindError(f"unknown window function {name}")
        spec = BoundWindow(name, arg, parts, orders, offset, ty)
        self.windows.append(spec)
        return BWinRef(len(self.windows) - 1, ty)

    def bind_with_windows(self, e: ast.Expr) -> BExpr:
        self._collect_windows = True
        try:
            return self.bind(e)
        finally:
            self._collect_windows = False


def _agg_key(a: BoundAgg):
    return (a.func, repr(a.arg), a.distinct)
