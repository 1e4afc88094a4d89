"""EXISTS / NOT EXISTS decorrelation: aggregate-based unnesting.

The reference decorrelates through the optimizer's normalization rules
(pkg/sql/opt/norm/decorrelate.go: hoisting + apply-to-join rewrites).
The TPU engine compiles whole plans to static-shape XLA programs, so
the rewrite happens earlier and simpler — on the AST, before binding:

    ... WHERE EXISTS (SELECT * FROM T t2
                      WHERE t2.k  = outer.k        -- eq correlations
                        AND t2.s <> outer.s        -- <=1 neq correlation
                        AND <uncorrelated preds>)  -- residual

becomes a LEFT JOIN against the grouped inner table

    LEFT JOIN (SELECT k, count(*) AS __c
                    [, min(s) AS __mn, max(s) AS __mx]
               FROM T WHERE <residual> GROUP BY k) AS __existsN
           ON __existsN.k = outer.k

with the EXISTS conjunct replaced by a plain predicate:

    EXISTS          ->  __c >= 1 [AND (__mn <> s OR __mx <> s)]
    NOT EXISTS      ->  coalesce(__c, 0) = 0 [OR (__mn = s AND __mx = s)]

The min/max trick handles the one inequality correlation TPC-H Q21
needs: a row with t2.s <> outer.s exists among the k-group iff the
group's min or max differs from outer.s (works on any equality-
comparable type; we restrict to non-string columns so dictionary code
spaces never mix). The derived table has one row per k, so the LEFT
JOIN never multiplies outer rows. NULL semantics note: correlation
columns must be NOT NULL for the min/max trick (SQL's <> over NULLs
never matches anyway, and TPC-H schemas are NOT NULL throughout).
"""

from __future__ import annotations

import itertools
from dataclasses import replace

from . import ast

def _conjuncts(e):
    if isinstance(e, ast.BinOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _and_all(parts):
    out = None
    for p in parts:
        out = p if out is None else ast.BinOp("and", out, p)
    return out


def _refs(e, out):
    """Collect every ColumnRef under e via a generic dataclass walk;
    a None marker means 'opaque' (nested subquery or unknown node) and
    makes the caller bail — misclassifying a hidden outer reference as
    inner would hoist it out of scope."""
    import dataclasses
    if isinstance(e, ast.ColumnRef):
        out.append(e)
        return out
    if isinstance(e, (ast.Exists, ast.Subquery, ast.InSubquery)):
        out.append(None)
        return out
    if isinstance(e, (list, tuple)):
        for v in e:
            _refs(v, out)
        return out
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            if isinstance(v, (ast.Expr, list, tuple)):
                _refs(v, out)
        return out
    return out


def _side(e, inner_aliases, inner_cols: set, outer_aliases: set):
    """'inner' / 'outer' / None (mixed or unresolvable).
    inner_aliases: a str (one table) or a set of aliases."""
    if isinstance(inner_aliases, str):
        inner_aliases = {inner_aliases}
    refs = _refs(e, [])
    if any(r is None for r in refs):
        return None
    sides = set()
    for r in refs:
        if r.table in inner_aliases or (r.table is None
                                        and r.name in inner_cols):
            sides.add("inner")
        elif r.table in outer_aliases or r.table is None:
            sides.add("outer")
        else:
            return None
    if not sides:
        return "outer"   # constant expression: evaluable outside
    return sides.pop() if len(sides) == 1 else None


_AGG_FNS = {"sum", "avg", "min", "max", "count"}


def _agg_only(e) -> str | None:
    """Classify a select-item expression that must collapse to one row
    per group: every ColumnRef sits under an aggregate FuncCall and at
    least one aggregate exists. Returns "count" when the expression is
    exactly count(...) (whose empty-group value is 0, not NULL),
    "agg" for other aggregate-only shapes, None when not aggregate-only."""
    import dataclasses
    if isinstance(e, ast.FuncCall) and e.name in _AGG_FNS:
        return "count" if e.name == "count" else "agg"
    if isinstance(e, ast.ColumnRef):
        return None
    if isinstance(e, (ast.Exists, ast.Subquery, ast.InSubquery)):
        return None
    kinds = []
    if dataclasses.is_dataclass(e) and not isinstance(e, type):
        for f in dataclasses.fields(e):
            v = getattr(e, f.name)
            vs = v if isinstance(v, (list, tuple)) else [v]
            for x in vs:
                if isinstance(x, ast.Expr):
                    k = _agg_only(x)
                    if k is None and _refs(x, []):
                        return None  # bare column ref outside an agg
                    if k is not None:
                        kinds.append(k)
    if not kinds:
        return None
    if "count" in kinds:
        # arithmetic over count (e.g. count(*) + 1) would need the
        # empty group to evaluate the expression at count = 0, but the
        # LEFT JOIN yields NULL — not rewritable
        return None
    return "agg"


def _walk_subqueries(e, visit):
    """Depth-first over an expr/statement tree, calling visit(node,
    setter) for every ast.Subquery; setter(replacement) swaps it out
    in place. Mutates e (callers pass a private copy)."""
    import dataclasses
    if not (dataclasses.is_dataclass(e) and not isinstance(e, type)):
        return
    if isinstance(e, (ast.Exists, ast.InSubquery)):
        return  # handled by the EXISTS/IN paths; do not descend
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ast.Subquery):
            def setter(repl, _e=e, _n=f.name):
                setattr(_e, _n, repl)
            visit(v, setter)
        elif isinstance(v, ast.Expr):
            _walk_subqueries(v, visit)
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                if isinstance(x, ast.Subquery):
                    def setter(repl, _v=v, _i=i):
                        _v[_i] = repl
                    visit(x, setter)
                elif isinstance(x, ast.Expr):
                    _walk_subqueries(x, visit)


def decorrelate_scalar(sel: ast.Select, columns_of) -> ast.Select:
    """Rewrite correlated scalar subqueries in sel's SELECT items and
    WHERE into grouped LEFT JOINs (TPC-H q2/q17/q20/q22 shapes):

        x < (SELECT agg(e) FROM T WHERE T.k = outer.k AND <residual>)

    becomes LEFT JOIN (SELECT k AS __k0, agg(e) AS __v FROM T WHERE
    <residual> GROUP BY k) AS __scN ON __scN.__k0 = outer.k, with the
    subquery replaced by __scN.__v. Missing groups join as NULL —
    exactly the empty scalar subquery's value — except count(...),
    which yields 0 and gets a coalesce. Non-rewritable subqueries are
    left untouched (uncorrelated ones bind as constants; genuinely
    unsupported ones keep the clear bind error)."""
    import copy
    outer_aliases = set()
    if sel.table is not None:
        outer_aliases.add(sel.table.alias or sel.table.name)
    for j in sel.joins:
        outer_aliases.add(j.table.alias or j.table.name)
    if not outer_aliases:
        return sel

    # the deepcopy below is ~25% of a point-lookup's latency; skip it
    # (and the walks) when no scalar subquery exists at all
    found = []
    for item in sel.items:
        _walk_subqueries(item, lambda s, _set: found.append(s))
    if sel.where is not None:
        _walk_subqueries(sel.where, lambda s, _set: found.append(s))
    if not found:
        return sel

    sel = copy.deepcopy(sel)
    new_joins = []
    # derived-table names count per statement, so re-executions of one
    # statement rewrite to the same text and hit the exec cache
    seq = itertools.count()

    def visit(sub, setter):
        out = _rewrite_scalar(sub.select, outer_aliases, columns_of, seq)
        if out is None:
            return
        join, repl = out
        new_joins.append(join)
        setter(repl)

    for item in sel.items:
        _walk_subqueries(item, visit)
    if sel.where is not None:
        _walk_subqueries(sel.where, visit)
    if not new_joins:
        return sel
    sel.joins = list(sel.joins) + new_joins
    return sel


def _rewrite_scalar(sub: ast.Select, outer_aliases: set, columns_of,
                    seq):
    """One correlated scalar subquery -> (JoinClause, replacement
    expr), or None. The subquery may itself join several tables
    (TPC-H q2's min-supplycost over partsupp x supplier x nation x
    region) as long as every join is inner/comma with inner-only ON
    conditions — the whole inner FROM moves into the derived table."""
    if sub is None or sub.table is None or \
            sub.table.subquery is not None or \
            sub.group_by or sub.having or sub.ctes or sub.distinct or \
            sub.limit is not None or sub.where is None or \
            len(sub.items) != 1:
        return None
    kind = _agg_only(sub.items[0].expr)
    if kind is None:
        return None
    inner_aliases = {sub.table.alias or sub.table.name}
    inner_cols = columns_of(sub.table.name)
    if inner_cols is None:
        return None
    inner_cols = set(inner_cols)
    for j in sub.joins:
        if j.join_type not in ("inner", "cross") or \
                j.table.subquery is not None:
            return None
        cols = columns_of(j.table.name)
        if cols is None:
            return None
        inner_aliases.add(j.table.alias or j.table.name)
        inner_cols |= cols
    if inner_aliases & outer_aliases:
        return None
    for j in sub.joins:
        if j.on is not None and _side(j.on, inner_aliases, inner_cols,
                                      outer_aliases) != "inner":
            return None

    eq_corr = []
    residual = []
    for p in _conjuncts(sub.where):
        s = _side(p, inner_aliases, inner_cols, outer_aliases)
        if s == "inner":
            residual.append(p)
            continue
        if isinstance(p, ast.BinOp) and p.op == "=":
            ls = _side(p.left, inner_aliases, inner_cols, outer_aliases)
            rs = _side(p.right, inner_aliases, inner_cols,
                       outer_aliases)
            pair = None
            if ls == "inner" and rs == "outer" and \
                    isinstance(p.left, ast.ColumnRef):
                pair = (p.left, p.right)
            elif rs == "inner" and ls == "outer" and \
                    isinstance(p.right, ast.ColumnRef):
                pair = (p.right, p.left)
            if pair is not None:
                eq_corr.append(pair)
                continue
        return None
    if not eq_corr:
        return None  # uncorrelated: the binder inlines it already

    dn = f"__sc{next(seq)}"
    items = []
    group_by = []
    on_parts = []
    for i, (icol, oexpr) in enumerate(eq_corr):
        inner = ast.ColumnRef(icol.name, icol.table)
        items.append(ast.SelectItem(inner, alias=f"__k{i}"))
        group_by.append(inner)
        on_parts.append(ast.BinOp("=", ast.ColumnRef(f"__k{i}", dn),
                                  oexpr))
    items.append(ast.SelectItem(sub.items[0].expr, alias="__v"))
    derived = ast.Select(
        items=items,
        table=sub.table,
        joins=list(sub.joins),
        where=_and_all(residual),
        group_by=group_by)
    join = ast.JoinClause(
        table=ast.TableRef(dn, alias=dn, subquery=derived),
        join_type="left", on=_and_all(on_parts))
    repl: ast.Expr = ast.ColumnRef("__v", dn)
    if kind == "count":
        repl = ast.FuncCall("coalesce", [repl, ast.Literal(0)])
    return join, repl


def _match_exists(c):
    """(exists_node, negated) or (None, False)."""
    if isinstance(c, ast.Exists):
        return c, False
    if isinstance(c, ast.UnaryOp) and c.op == "not" and \
            isinstance(c.operand, ast.Exists):
        return c.operand, True
    return None, False


def decorrelate_exists(sel: ast.Select, columns_of,
                       is_string_col=None) -> ast.Select:
    """Rewrite rewritable (NOT) EXISTS conjuncts of sel.where;
    non-rewritable ones are left alone (and fail later with the
    existing 'correlated subqueries not supported' error).

    columns_of(table_name) -> set of column names, or None if the
    table is unknown (view, CTE - we skip those).
    is_string_col(table, col) -> bool: the neq (min/max) trick is
    refused for string columns (dictionary code spaces must not mix
    across tables)."""
    if sel.where is None or sel.table is None:
        return sel
    outer_aliases = set()
    if sel.table is not None:
        outer_aliases.add(sel.table.alias or sel.table.name)
    for j in sel.joins:
        outer_aliases.add(j.table.alias or j.table.name)

    new_conjs = []
    new_joins = []
    changed = False
    # derived-table names count per statement (see decorrelate_scalar)
    seq = itertools.count()
    for c in _conjuncts(sel.where):
        ex, negated = _match_exists(c)
        rewritten = None
        if ex is not None and ex.select is not None:
            rewritten = _rewrite_one(ex.select, negated, outer_aliases,
                                     columns_of, seq, is_string_col)
        if rewritten is None:
            new_conjs.append(c)
            continue
        join, pred = rewritten
        new_joins.append(join)
        new_conjs.append(pred)
        changed = True
    if not changed:
        return sel
    return replace(sel, where=_and_all(new_conjs),
                   joins=list(sel.joins) + new_joins)


def _rewrite_one(sub: ast.Select, negated: bool, outer_aliases: set,
                 columns_of, seq, is_string_col=None):
    """One EXISTS subquery -> (JoinClause, replacement predicate),
    or None if the shape is not rewritable."""
    if sub.table is None or sub.table.subquery is not None or \
            sub.joins or sub.group_by or sub.having or sub.ctes or \
            sub.distinct or sub.limit is not None or sub.where is None:
        return None
    inner_alias = sub.table.alias or sub.table.name
    inner_cols = columns_of(sub.table.name)
    if inner_cols is None or inner_alias in outer_aliases:
        return None

    eq_corr = []    # (inner ColumnRef, outer expr)
    neq_corr = []   # (inner ColumnRef, outer expr)
    residual = []
    for p in _conjuncts(sub.where):
        s = _side(p, inner_alias, inner_cols, outer_aliases)
        if s == "inner":
            residual.append(p)
            continue
        if isinstance(p, ast.BinOp) and p.op in ("=", "<>", "!="):
            ls = _side(p.left, inner_alias, inner_cols, outer_aliases)
            rs = _side(p.right, inner_alias, inner_cols, outer_aliases)
            pair = None
            if ls == "inner" and rs == "outer" and \
                    isinstance(p.left, ast.ColumnRef):
                pair = (p.left, p.right)
            elif rs == "inner" and ls == "outer" and \
                    isinstance(p.right, ast.ColumnRef):
                pair = (p.right, p.left)
            if pair is not None:
                (eq_corr if p.op == "=" else neq_corr).append(pair)
                continue
        return None   # unsupported correlated shape
    if not eq_corr or len(neq_corr) > 1:
        return None
    if neq_corr and is_string_col is not None and \
            is_string_col(sub.table.name, neq_corr[0][0].name):
        return None

    dn = f"__exists{next(seq)}"
    items = []
    group_by = []
    on_parts = []
    for i, (icol, oexpr) in enumerate(eq_corr):
        # keep the subquery's own alias inside the derived select so
        # residual predicates (which carry it as qualifier) still bind
        inner = ast.ColumnRef(icol.name, inner_alias)
        items.append(ast.SelectItem(inner, alias=f"__k{i}"))
        group_by.append(inner)
        on_parts.append(ast.BinOp("=", ast.ColumnRef(f"__k{i}", dn),
                                  oexpr))
    items.append(ast.SelectItem(
        ast.FuncCall("count", [], star=True), alias="__c"))
    if neq_corr:
        s_in = ast.ColumnRef(neq_corr[0][0].name, inner_alias)
        items.append(ast.SelectItem(ast.FuncCall("min", [s_in]),
                                    alias="__mn"))
        items.append(ast.SelectItem(ast.FuncCall("max", [s_in]),
                                    alias="__mx"))
    derived = ast.Select(
        items=items,
        table=ast.TableRef(sub.table.name, alias=inner_alias),
        where=_and_all(residual),
        group_by=group_by)
    join = ast.JoinClause(
        table=ast.TableRef(dn, alias=dn, subquery=derived),
        join_type="left", on=_and_all(on_parts))

    c_col = ast.ColumnRef("__c", dn)
    if not negated:
        pred = ast.BinOp(">=", c_col, ast.Literal(1))
        if neq_corr:
            s_out = neq_corr[0][1]
            mn = ast.ColumnRef("__mn", dn)
            mx = ast.ColumnRef("__mx", dn)
            diff = ast.BinOp("or", ast.BinOp("<>", mn, s_out),
                             ast.BinOp("<>", mx, s_out))
            pred = ast.BinOp("and", pred, diff)
        return join, pred
    # NOT EXISTS: true when no k-match at all, or (with the neq
    # correlation) when every inner row's s equals outer's s
    no_match = ast.BinOp("=", ast.FuncCall(
        "coalesce", [c_col, ast.Literal(0)]), ast.Literal(0))
    if not neq_corr:
        return join, no_match
    s_out = neq_corr[0][1]
    mn = ast.ColumnRef("__mn", dn)
    mx = ast.ColumnRef("__mx", dn)
    all_same = ast.BinOp("and", ast.BinOp("=", mn, s_out),
                         ast.BinOp("=", mx, s_out))
    return join, ast.BinOp("or", no_match, all_same)
