"""Statement-shape plan parameterization for the analytic path.

The port of cockroach_tpu/exec/planparam.py. Eligible filter literals
of a bound plan are replaced by ``BParam`` placeholders whose values
ride each run in ``RunContext.params``, so statements that differ only
in those literals (TPC-H Q6 with another date or discount) share one
exec-cache entry and skip the plan build (the reference's plan cache
keyed on the statement fingerprint, pkg/sql/plan_cache).

A parameter reaches its tensor op as a Python scalar, exactly as a
baked constant does (exec/expr.py): a DECIMAL as its scaled int, a DATE
as its day number, a TIMESTAMP as its microseconds. No run copies a
value from the host to the card or waits for the card because of it.

Conservative by construction: only constants inside ``Filter.pred`` /
``Scan.filter`` comparison spines are lifted. Anything that shapes the
plan stays baked and keeps the plan fingerprint distinct, so a
shape-changing literal (LIMIT, a compaction fraction derived from
selectivity, dictionary masks, function arguments read when the plan is
built) misses the cache instead of sharing a wrong plan.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re

import numpy as np

from ..sql import bound as B
from ..sql import plan as P
from ..sql.types import Family

# Literal families whose physical scalars can ride as run arguments.
# STRING (and ARRAY/JSON) predicates are evaluated on the host into
# dictionary tables at bind time, so they are inherently baked; BOOL
# constants often fold control flow.
_ELIGIBLE = (Family.INT, Family.DECIMAL, Family.DATE, Family.TIMESTAMP,
             Family.FLOAT)

# Bound on lifted literals per statement (the reference's): a
# pathological filter falls back to text keying.
_MAX_PARAMS = 16


def _eligible_const(e) -> bool:
    return (isinstance(e, B.BConst) and e.value is not None
            and not isinstance(e.value, bool)
            and e.type is not None and e.type.family in _ELIGIBLE)


class _Lifter:
    def __init__(self):
        self.values: list = []
        self.overflow = False

    def const(self, e: B.BConst):
        v = np.asarray(e.value, dtype=e.type.np_dtype)
        if v.item() != e.value:  # lossy physical round trip: keep baked
            return e
        if len(self.values) >= _MAX_PARAMS:
            self.overflow = True
            return e
        self.values.append(v)
        return B.BParam(len(self.values) - 1, e.type)

    def expr(self, e):
        """Rewrite the comparison spine of a predicate. Recursion is a
        whitelist (BBin/BUnary/BBetween), because other nodes read
        constant arguments structurally when the plan is built (BFunc's
        round digits, BInList value lists, dictionary tables)."""
        if _eligible_const(e):
            return self.const(e)
        if isinstance(e, B.BBin):
            left, right = self.expr(e.left), self.expr(e.right)
            if left is not e.left or right is not e.right:
                return B.BBin(e.op, left, right, e.type)
            return e
        if isinstance(e, B.BUnary):
            o = self.expr(e.operand)
            if o is not e.operand:
                return B.BUnary(e.op, o, e.type)
            return e
        if isinstance(e, B.BBetween):
            x, lo, hi = self.expr(e.expr), self.expr(e.lo), self.expr(e.hi)
            if x is not e.expr or lo is not e.lo or hi is not e.hi:
                return B.BBetween(x, lo, hi, e.negated, e.type)
            return e
        return e

    def node(self, n):
        if isinstance(n, P.Scan):
            if n.filter is None:
                return n
            f = self.expr(n.filter)
            return n if f is n.filter else dataclasses.replace(n, filter=f)
        if isinstance(n, P.Filter):
            c = self.node(n.child)
            p = self.expr(n.pred) if n.pred is not None else None
            if c is n.child and p is n.pred:
                return n
            return dataclasses.replace(n, child=c, pred=p)
        if isinstance(n, P.HashJoin):
            left, right = self.node(n.left), self.node(n.right)
            if left is n.left and right is n.right:
                return n
            return dataclasses.replace(n, left=left, right=right)
        if isinstance(n, (P.Project, P.Aggregate, P.Sort, P.Limit,
                          P.Window, P.Compact)):
            c = self.node(n.child)
            return n if c is n.child else dataclasses.replace(n, child=c)
        return n  # unknown node: leave baked (conservative)


def parameterize(node):
    """Lift eligible filter literals out of ``node``.

    Returns ``(parameterized_node, values)``, values a tuple of numpy
    scalars positionally matching the BParam indices, or ``(node,
    None)`` when nothing was lifted (or too much would be)."""
    lf = _Lifter()
    out = lf.node(node)
    if lf.overflow or not lf.values:
        return node, None
    return out, tuple(lf.values)


def run_values(values) -> tuple:
    """The lifted values as the Python scalars a run hands its tensor
    ops (``RunContext.params``)."""
    return tuple(v.item() for v in values)


def plan_fingerprint(node) -> str:
    """Deterministic structural fingerprint of a plan tree.

    ndarray payloads (dictionary masks, remap tables) hash their full
    bytes, where repr truncates large arrays. Fields marked repr=False
    (BDictGather.dictionary, a fresh object per bind) are skipped, the
    planner's structural-match convention."""
    h = hashlib.sha1()

    def feed(o):
        if isinstance(o, np.ndarray):
            h.update(b"nd|")
            h.update(str(o.dtype).encode())
            h.update(str(o.shape).encode())
            h.update(o.tobytes())
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            h.update(type(o).__name__.encode())
            for f in dataclasses.fields(o):
                if not f.repr:
                    continue
                h.update(f.name.encode())
                feed(getattr(o, f.name))
        elif isinstance(o, (list, tuple)):
            h.update(b"[")
            for x in o:
                feed(x)
            h.update(b"]")
        elif isinstance(o, dict):
            h.update(b"{")
            for k, v in o.items():
                feed(k)
                feed(v)
            h.update(b"}")
        elif isinstance(o, frozenset):
            h.update(b"fs")
            for x in sorted(repr(x) for x in o):
                h.update(x.encode())
        else:
            h.update(repr(o).encode())
        h.update(b";")

    feed(node)
    return h.hexdigest()


# Statement-shape text: literals -> "?" so literal-varying texts key
# identically. String literals normalize here even though their plans
# stay distinct: the plan fingerprint tells them apart.
_LIT_RE = re.compile(
    r"'(?:[^']|'')*'|(?<![\w.])\d+(?:\.\d+(?:[eE][+-]?\d+)?)?(?![\w.])")


def shape_text(sql: str) -> str:
    return _LIT_RE.sub("?", sql)
