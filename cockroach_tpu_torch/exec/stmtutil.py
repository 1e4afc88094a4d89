"""Statement helpers of the engine (the subset of
cockroach_tpu/exec/stmtutil.py that this package uses): CTE and
derived-table name rewriting, the re-execute handle for set operations
and statements that materialize temps, SHOW CREATE TABLE's DDL, the
host-side ORDER BY of a partitioned GROUP BY, AST walks of the write
path and the client decode of physical values."""

from __future__ import annotations

import copy
import dataclasses
import datetime
from dataclasses import dataclass

from ..sql import ast
from ..sql import plan as P
from ..sql.types import Family
from .session import EngineError, Result

EPOCH_DATE = datetime.date(1970, 1, 1)
EPOCH_DT = datetime.datetime(1970, 1, 1)


def host_sort(rows: list, meta: P.OutputMeta, keys) -> list:
    """ORDER BY over decoded result rows (the partitioned GROUP BY's
    merge), by (name, desc[, nulls_first]) keys over ``meta.names``."""
    idx = []
    for key in keys:
        try:
            i = meta.names.index(key[0])
        except ValueError:
            raise EngineError(
                f"cannot host-sort a partitioned result by {key[0]!r}") \
                from None
        idx.append((i, key[1], key[2] if len(key) > 2 else None))
    return sort_rows(rows, idx)


def sort_rows(rows: list, keys) -> list:
    """Rows sorted by (column index, desc, nulls_first or None) keys, as
    the device orders them: ascending puts NULLs last, descending puts
    NULLs first, unless nulls_first says otherwise; strings compare
    lexicographically, as dictionary ranks do."""
    out = list(rows)
    for i, desc, nf in reversed(list(keys)):
        null_first = nf if nf is not None else desc
        # the NULL flag is chosen before the reversal so the presented
        # order puts NULLs where null_first says
        out = sorted(out,
                     key=lambda r, i=i: (
                         (r[i] is None) if desc == null_first
                         else (r[i] is not None),
                         0 if r[i] is None else r[i]),
                     reverse=desc)
    return out


@dataclass(eq=False)
class RerunPrepared:
    """Prepared handle for statements that cannot pin one compiled plan:
    CTEs and derived tables materialize fresh temps per execution, set
    operations merge on the host, so each run() re-executes the
    statement through the engine (whose stable temp names keep the main
    query's exec-cache entry hitting). A successful CTE or derived-table
    run captures its bodies' and main query's plans, and later runs
    against unchanged base tables compose them on the card
    (exec/ctecompose.py): no pull or upload between stages, one result
    pull, no re-plan. A drift (a base table's generation, a txn), a glue
    overflow or a body sentinel declines the composition: that run takes
    the slow path and captures again. ``composed_runs`` and ``declined``
    count both, as do the engine's ``sql.cte.composed.*`` counters."""
    engine: object
    session: object
    stmt: object
    sql_text: str
    _composed: object = None
    composed_runs: int = 0
    declined: int = 0

    def run(self, read_ts=None) -> Result:
        eng = self.engine
        with eng._run_scope(eng._stmt_tables(self.stmt), False), \
                eng._statement():
            comp = self._composed
            if comp is not None:
                self._composed = None
                if comp.valid():
                    try:
                        res = comp.run(read_ts)
                    except EngineError:
                        pass
                    else:
                        self._composed = comp
                        self.composed_runs += 1
                        eng.last_exec["composed"] = True
                        eng.metrics.counter(
                            "sql.cte.composed.runs",
                            "CTE statement runs composed on the "
                            "device").inc()
                        return res
                self.declined += 1
                eng.metrics.counter(
                    "sql.cte.composed.declined",
                    "compositions declined (a base table moved, a txn, "
                    "a glue overflow or a body sentinel): the run took "
                    "the slow path").inc()
            capturing = eng._begin_cte_capture(self.stmt, self.session)
            try:
                res = eng._exec_select(self.stmt, self.session,
                                       self.sql_text)
            finally:
                cap = eng._end_cte_capture() if capturing else None
            if cap is not None:
                from .ctecompose import build_composition
                self._composed = build_composition(eng, self.session, cap)
            return res

    def dispatch(self, read_ts=None):
        """The composed pipeline's device result batch (no sync)."""
        comp = self._composed
        if comp is not None and comp.valid():
            return comp.dispatch(read_ts)
        raise EngineError(
            "this statement shape cannot dispatch asynchronously")


def render_create(desc) -> str:
    """CREATE TABLE DDL reconstructed from a table descriptor (SHOW
    CREATE TABLE)."""
    def ty(t):
        f = t.family.value
        names = {"int": "INT8", "float": "FLOAT8", "bool": "BOOL",
                 "string": "STRING", "date": "DATE",
                 "timestamp": "TIMESTAMP", "interval": "INTERVAL"}
        if f == "decimal":
            return f"DECIMAL({t.precision},{t.scale})"
        if f == "array":
            return f"{ty(t.elem)}[]"
        if f == "json":
            return "JSONB"
        return names.get(f, f.upper())

    parts = []
    for c in desc.columns:
        if c.state != "public":
            continue
        s = f"{c.name} {ty(c.type)}"
        if not c.nullable:
            s += " NOT NULL"
        parts.append(s)
    if desc.primary_key:
        parts.append(f"PRIMARY KEY ({', '.join(desc.primary_key)})")
    for i in desc.indexes:
        if i.state != "public":
            continue
        kw = "UNIQUE INDEX" if i.unique else "INDEX"
        parts.append(f"{kw} {i.name} ({', '.join(i.columns)})")
    for ck in desc.checks:
        parts.append(f"CONSTRAINT {ck['name']} CHECK ({ck['expr_sql']})")
    for fk in desc.fks:
        parts.append(
            f"CONSTRAINT {fk['name']} FOREIGN KEY "
            f"({', '.join(fk['columns'])}) REFERENCES "
            f"{fk['ref_table']} ({', '.join(fk['ref_columns'])})")
    cols = ",\n  ".join(parts)
    return f"CREATE TABLE {desc.name} (\n  {cols}\n)"


def rewrite_table_names(sel, mapping: dict):
    """Deep-copy a Select or SetOp with CTE names replaced by their
    materialized temp-table names, in FROM/JOIN refs and inside
    expression subqueries (which execute while the temps are live), in
    both branches of a set operation wherever it nests."""
    if not mapping:
        return sel
    if isinstance(sel, ast.SetOp):
        sel = copy.copy(sel)
        shadowed = {name for name, _, _ in sel.ctes}
        inner = {k: v for k, v in mapping.items() if k not in shadowed}
        sel.left = rewrite_table_names(sel.left, inner)
        sel.right = rewrite_table_names(sel.right, inner)
        return sel
    sel = copy.deepcopy(sel)

    def fix_ref(ref):
        if ref is None:
            return
        if ref.subquery is not None:
            fix_select(ref.subquery)
            return
        if ref.name in mapping:
            ref.alias = ref.alias or ref.name
            ref.name = mapping[ref.name]

    def fix_expr(e):
        if e is None:
            return
        if isinstance(e, (ast.Subquery, ast.Exists)):
            fix_select(e.select)
            return
        if isinstance(e, ast.InSubquery):
            fix_expr(e.expr)
            fix_select(e.select)
            return
        for attr in ("left", "right", "operand", "expr", "lo", "hi",
                     "start", "length", "else_"):
            fix_expr(getattr(e, attr, None))
        for a in getattr(e, "args", None) or []:
            fix_expr(a)
        for a in getattr(e, "items", None) or []:
            fix_expr(a)
        for c, v in getattr(e, "whens", None) or []:
            fix_expr(c)
            fix_expr(v)

    def fix_select(s):
        if isinstance(s, ast.SetOp):
            fix_select(s.left)
            fix_select(s.right)
            return
        # a CTE of the same name in an inner scope shadows the outer
        shadowed = {name for name, _, _ in s.ctes}
        inner = {k: v for k, v in mapping.items() if k not in shadowed}
        if s is not sel and inner != mapping:
            rewritten = rewrite_table_names(s, inner)
            s.__dict__.update(rewritten.__dict__)
            return
        fix_ref(s.table)
        for j in s.joins:
            fix_ref(j.table)
            fix_expr(j.on)
        fix_expr(s.where)
        fix_expr(s.having)
        for it in s.items:
            fix_expr(it.expr)
        for g in s.group_by:
            fix_expr(g)
        for ob in s.order_by:
            fix_expr(ob.expr)
        for _, _, sub in s.ctes:
            fix_select(sub)

    fix_select(sel)
    return sel


def decode_scalar(v, valid: bool, ty, dictionary):
    if not valid:
        return None
    f = ty.family
    if f == Family.DECIMAL:
        return float(v) / 10 ** ty.scale
    if f == Family.DATE:
        return EPOCH_DATE + datetime.timedelta(days=int(v))
    if f == Family.TIMESTAMP:
        return EPOCH_DT + datetime.timedelta(microseconds=int(v))
    if f == Family.STRING:
        if dictionary is not None:
            return dictionary.values[int(v)]
        return int(v)
    if f in (Family.ARRAY, Family.JSON):
        if dictionary is not None:
            from ..sql import datum as dtm
            return dtm.decode_text(dictionary.values[int(v)], ty)
        return int(v)
    if f == Family.BOOL:
        return bool(v)
    if f == Family.INT:
        return int(v)
    if f == Family.FLOAT:
        return float(v)
    return v.item() if hasattr(v, "item") else v


def decode_storage_value(v, ty):
    """Storage-logical value (extract_row form: strings decoded,
    numerics physical) -> client value, as the compiled path decodes."""
    if v is None:
        return None
    if isinstance(v, str):
        if ty.family in (Family.ARRAY, Family.JSON):
            # datum columns extract as their canonical text
            from ..sql import datum as dtm
            return dtm.decode_text(v, ty)
        return v
    return decode_scalar(v, True, ty, None)


def contains_func(node, fname: str) -> bool:
    """Does any expression under `node` call function `fname`?"""
    found = [False]

    def walk(x):
        if found[0]:
            return
        if isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
            return
        if not dataclasses.is_dataclass(x) or isinstance(x, type):
            return
        if isinstance(x, ast.FuncCall) and x.name == fname:
            found[0] = True
            return
        for f in dataclasses.fields(x):
            walk(getattr(x, f.name))

    walk(node)
    return found[0]


def split_conjuncts_ast(e: ast.Expr) -> list:
    """Flatten a WHERE tree into its AND-conjuncts."""
    out: list = []

    def walk(x):
        if isinstance(x, ast.BinOp) and x.op == "and":
            walk(x.left)
            walk(x.right)
        else:
            out.append(x)

    walk(e)
    return out


def collect_tables(node, out: set) -> None:
    """Every stored table a parsed statement names, into ``out``: every
    AST node is a dataclass, so a generic field walk reaches subqueries,
    CTE bodies and derived tables wherever they nest (a CTE's own name
    is collected where the statement reads it)."""
    if node is None or isinstance(node, (str, int, float, bool, bytes)):
        return
    if isinstance(node, (list, tuple)):
        for x in node:
            collect_tables(x, out)
        return
    if isinstance(node, ast.TableRef):
        if node.subquery is not None:
            collect_tables(node.subquery, out)
        else:
            out.add(node.name)
        return
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            collect_tables(getattr(node, f.name), out)


def propagate_as_of(inner, outer):
    """AS OF SYSTEM TIME covers the whole statement: a sub-select (an
    expression subquery, a CTE, a derived table) inherits the outer
    clause unless it carries its own."""
    if not isinstance(inner, ast.Select) \
            or not isinstance(outer, ast.Select):
        return inner
    if outer.as_of is None or inner.as_of is not None:
        return inner
    inner = copy.copy(inner)
    inner.as_of = outer.as_of
    return inner
