"""Compile bound expressions to tensor computations.

The counterpart of cockroach_tpu/exec/expr.py. ``compile_expr(e)``
returns ``fn(ctx) -> (data, valid)`` where ctx maps batch column names
to (data, valid) pairs and carries aggregate results for
post-aggregation projections. PyTorch runs eagerly, so each node is one
or a few tensor ops on the batch's device.

Dictionary lookups (BDictGather / BDictLookup / BDictRemap) are plain
gathers through a small table copied to the batch's device; codes are
clamped into the table first, as the JAX package clamps them.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops import kernels as K
from ..sql.bound import (BAggRef, BBetween, BBin, BCase, BCast, BCoalesce,
                         BCol, BConst, BDictGather, BDictLookup, BDictRemap,
                         BExpr, BExtract, BFunc, BInList, BIsNull, BParam,
                         BUnary, BWinRef)
from ..sql.types import Family, SQLType
from .session import EngineError


class ExprContext:
    """Evaluation context: column name -> (data, valid); agg results;
    the run's statement parameters (exec/planparam.py BParam values, as
    Python scalars)."""

    def __init__(self, cols: dict, n: int, device: torch.device,
                 aggs: list | None = None, params: tuple = ()):
        self.cols = cols
        self.n = n
        self.device = device
        self.aggs = aggs or []
        self.params = params

    def col(self, name: str):
        return self.cols[name]


CompiledExpr = Callable[[ExprContext], tuple]


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (explicit: float64 stays
    float64, never the default float32)."""
    # graftlint: waive[no-aliasing-upload] a dtype probe of an empty
    # array made here: no buffer is shared
    return torch.from_numpy(np.empty(0, dtype=np_dtype)).dtype


def _dtype(t: SQLType) -> torch.dtype:
    return torch_dtype(t.np_dtype)


def _table(tbl: np.ndarray, device) -> torch.Tensor:
    """A host lookup table copied (never aliased) onto ``device``."""
    return torch.tensor(np.ascontiguousarray(tbl), device=device)


def _lookup(tbl: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    codes = torch.clamp(d.to(torch.int64), 0, tbl.shape[0] - 1)
    return tbl[codes]


def compile_expr(e: BExpr) -> CompiledExpr:
    if isinstance(e, BConst):
        ty = e.type
        if e.value is None:
            def f_null(ctx):
                z = torch.zeros(ctx.n, dtype=_dtype(ty), device=ctx.device)
                return z, torch.zeros(ctx.n, dtype=torch.bool,
                                      device=ctx.device)
            return f_null
        val = e.value

        def f_const(ctx):
            d = torch.full((ctx.n,), val, dtype=_dtype(ty),
                           device=ctx.device)
            return d, torch.ones(ctx.n, dtype=torch.bool, device=ctx.device)
        return f_const

    if isinstance(e, BParam):
        idx, pty = e.index, e.type

        def f_param(ctx):
            # a run argument (statement-shape plan cache): a Python
            # scalar, filled like the baked f_const above
            d = torch.full((ctx.n,), ctx.params[idx], dtype=_dtype(pty),
                           device=ctx.device)
            return d, torch.ones(ctx.n, dtype=torch.bool, device=ctx.device)
        return f_param

    if isinstance(e, BCol):
        name = e.name

        def f_col(ctx):
            return ctx.col(name)
        return f_col

    if isinstance(e, BWinRef):
        wname = f"__win{e.index}"

        def f_win(ctx):
            return ctx.col(wname)
        return f_win

    if isinstance(e, BAggRef):
        i = e.index

        def f_agg(ctx):
            return ctx.aggs[i]
        return f_agg

    if isinstance(e, BBin):
        lf, rf = compile_expr(e.left), compile_expr(e.right)
        op = e.op
        if op in ("and", "or"):
            k = K.and_ if op == "and" else K.or_

            def f_logic(ctx):
                return k(lf(ctx), rf(ctx))
            return f_logic
        if op == "//":
            def f_idiv(ctx):
                a, b = lf(ctx), rf(ctx)
                return a[0] // b[0], torch.logical_and(a[1], b[1])
            return f_idiv
        table = {"+": K.add, "-": K.sub, "*": K.mul, "/": K.div,
                 "%": K.mod,
                 "=": K.eq, "!=": K.ne, "<": K.lt, "<=": K.le,
                 ">": K.gt, ">=": K.ge}
        k = table[op]
        out_ty = e.type

        def f_bin(ctx):
            a, b = lf(ctx), rf(ctx)
            d, v = k(a, b)
            if op in ("+", "-", "*") and out_ty.family in (
                    Family.INT, Family.DECIMAL, Family.DATE,
                    Family.TIMESTAMP):
                d = d.to(_dtype(out_ty))
            return d, v
        return f_bin

    if isinstance(e, BUnary):
        xf = compile_expr(e.operand)
        op = e.op
        if op == "not":
            def f_not(ctx):
                return K.not_(xf(ctx))
            return f_not
        if op == "-":
            def f_neg(ctx):
                return K.neg(xf(ctx))
            return f_neg
        fn = {"abs": torch.abs, "floor": torch.floor, "ceil": torch.ceil,
              "round": torch.round, "sqrt": torch.sqrt, "ln": torch.log,
              "exp": torch.exp}[op]

        def f_un(ctx):
            d, v = xf(ctx)
            return fn(d), v
        return f_un

    if isinstance(e, BBetween):
        xf = compile_expr(e.expr)
        lof, hif = compile_expr(e.lo), compile_expr(e.hi)
        neg = e.negated

        def f_between(ctx):
            r = K.between(xf(ctx), lof(ctx), hif(ctx))
            return K.not_(r) if neg else r
        return f_between

    if isinstance(e, BInList):
        xf = compile_expr(e.expr)
        vals = list(e.values)
        neg = e.negated

        def f_in(ctx):
            r = K.in_list(xf(ctx), vals)
            return K.not_(r) if neg else r
        return f_in

    if isinstance(e, BIsNull):
        xf = compile_expr(e.expr)
        k = K.is_not_null if e.negated else K.is_null

        def f_isnull(ctx):
            return k(xf(ctx))
        return f_isnull

    if isinstance(e, BCase):
        whenfs = [(compile_expr(c), compile_expr(v)) for c, v in e.whens]
        elsef = compile_expr(e.else_)

        def f_case(ctx):
            return K.case_when([(cf(ctx), vf(ctx)) for cf, vf in whenfs],
                               elsef(ctx))
        return f_case

    if isinstance(e, BCast):
        xf = compile_expr(e.expr)
        src, dst = e.expr.type, e.type

        def f_cast(ctx):
            d, v = xf(ctx)
            if dst.family == Family.FLOAT:
                out = d.to(torch.float64)
                if src.family == Family.DECIMAL:
                    out = out / (10.0 ** src.scale)
                return out, v
            if dst.family == Family.DECIMAL:
                if src.family == Family.FLOAT:
                    return torch.round(
                        d.to(torch.float64) * 10.0 ** dst.scale
                    ).to(torch.int64), v
                return d.to(torch.int64), v
            if dst.family == Family.INT:
                if src.family == Family.DECIMAL:
                    # numeric -> int rounds half away from zero
                    div = 10 ** src.scale
                    mag = (torch.abs(d) + div // 2) // div
                    d = torch.where(d < 0, -mag, mag)
                elif src.family == Family.FLOAT:
                    d = torch.round(d)  # float -> int: half-even (pg)
                return d.to(_dtype(dst)), v
            if dst.family == Family.BOOL:
                return d.to(torch.bool), v
            raise NotImplementedError(f"cast {src} -> {dst}")
        return f_cast

    if isinstance(e, BCoalesce):
        fs = [compile_expr(a) for a in e.args]

        def f_coalesce(ctx):
            return K.coalesce(*[f(ctx) for f in fs])
        return f_coalesce

    if isinstance(e, BExtract):
        xf = compile_expr(e.expr)
        part = e.part
        fam = "timestamp" if e.expr.type.family == Family.TIMESTAMP \
            else "date"

        def f_extract(ctx):
            d, v = xf(ctx)
            return K.extract_part(part, d, fam), v
        return f_extract

    if isinstance(e, BFunc):
        return _compile_func(e)

    if isinstance(e, BDictGather):
        xf = compile_expr(e.expr)
        tbl = np.asarray(e.table)
        ntbl = (np.asarray(e.null_table, dtype=bool)
                if e.null_table is not None else None)

        def f_gather(ctx):
            d, v = xf(ctx)
            if ntbl is not None:
                v = v & _lookup(_table(ntbl, ctx.device), d)
            return _lookup(_table(tbl, ctx.device), d), v
        return f_gather

    if isinstance(e, BDictLookup):
        xf = compile_expr(e.expr)
        tbl = np.asarray(e.table, dtype=bool)

        def f_dict(ctx):
            d, v = xf(ctx)
            return _lookup(_table(tbl, ctx.device), d), v
        return f_dict

    if isinstance(e, BDictRemap):
        xf = compile_expr(e.expr)
        rtbl = np.asarray(e.table, dtype=np.int32)
        ntbl = (np.asarray(e.null_table, dtype=bool)
                if e.null_table is not None else None)

        def f_remap(ctx):
            d, v = xf(ctx)
            if ntbl is not None:
                v = v & _lookup(_table(ntbl, ctx.device), d)
            return _lookup(_table(rtbl, ctx.device), d), v
        return f_remap

    raise NotImplementedError(f"cannot compile {e!r}")


def _cot(x):
    return 1.0 / torch.tan(x)


# 1-arg elementwise builtin kernels (sql/builtins.py registry)
_UNARY_KERNELS = {
    "sqrt": torch.sqrt, "ln": torch.log, "exp": torch.exp,
    "log10": torch.log10, "log2": torch.log2,
    "cbrt": lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0),
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "cot": _cot,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "floor": torch.floor, "ceil": torch.ceil, "ceiling": torch.ceil,
    "trunc": torch.trunc, "sign": torch.sign,
    "erf": torch.erf, "erfc": torch.erfc,
    "sind": lambda x: torch.sin(torch.deg2rad(x)),
    "cosd": lambda x: torch.cos(torch.deg2rad(x)),
    "tand": lambda x: torch.tan(torch.deg2rad(x)),
    "cotd": lambda x: _cot(torch.deg2rad(x)),
    "asind": lambda x: torch.rad2deg(torch.asin(x)),
    "acosd": lambda x: torch.rad2deg(torch.acos(x)),
    "atand": lambda x: torch.rad2deg(torch.atan(x)),
}

_BINARY_KERNELS = {
    "pow": torch.pow, "power": torch.pow, "atan2": torch.atan2,
}


def _compile_func(e: BFunc) -> CompiledExpr:
    name = e.name
    fs = [compile_expr(a) for a in e.args]
    if name in _UNARY_KERNELS:
        fn = _UNARY_KERNELS[name]

        def f1(ctx):
            d, v = fs[0](ctx)
            return fn(d), v
        return f1
    if name in _BINARY_KERNELS:
        fn = _BINARY_KERNELS[name]

        def f2(ctx):
            (a, va), (b, vb) = fs[0](ctx), fs[1](ctx)
            return fn(a, b), torch.logical_and(va, vb)
        return f2
    if name in ("round_n", "trunc_n"):
        ndigits = e.args[1].value
        scale = 10.0 ** ndigits
        op = torch.round if name == "round_n" else torch.trunc

        def f_round(ctx):
            d, v = fs[0](ctx)
            return op(d * scale) / scale, v
        return f_round
    if name == "mod":
        def f_mod(ctx):
            return K.mod(fs[0](ctx), fs[1](ctx))
        return f_mod
    if name == "logb":
        def f_logb(ctx):
            # args are [base, x] (pg's log(b, x))
            (b, vb), (x, vx) = fs[0](ctx), fs[1](ctx)
            ok = torch.logical_and(b > 0, x > 0)
            d = torch.log(torch.where(ok, x, 1.0)) / \
                torch.log(torch.where(ok, b, 2.0))
            return d, torch.logical_and(torch.logical_and(vb, vx), ok)
        return f_logb
    if name == "div":
        def f_div(ctx):
            (a, va), (b, vb) = fs[0](ctx), fs[1](ctx)
            ok = b != 0
            q = torch.trunc(a / torch.where(ok, b, 1.0))
            return q, torch.logical_and(torch.logical_and(va, vb), ok)
        return f_div
    if name in ("greatest", "least"):
        pick = torch.maximum if name == "greatest" else torch.minimum

        def f_gl(ctx):
            # SQL GREATEST/LEAST ignore NULL arguments
            d, v = fs[0](ctx)
            for f in fs[1:]:
                d2, v2 = f(ctx)
                both = torch.logical_and(v, v2)
                d = torch.where(both, pick(d, d2), torch.where(v, d, d2))
                v = torch.logical_or(v, v2)
            return d, v
        return f_gl
    if name == "nullif":
        def f_nullif(ctx):
            (a, va), (b, vb) = fs[0](ctx), fs[1](ctx)
            eq = torch.logical_and(a == b, torch.logical_and(va, vb))
            return a, torch.logical_and(va, torch.logical_not(eq))
        return f_nullif
    if name == "isfinite":
        def f_isfinite(ctx):
            d, v = fs[0](ctx)
            return torch.isfinite(d), v
        return f_isfinite
    if name == "width_bucket":
        # the reference's buckets for ascending bounds (x < lo -> 0,
        # x >= hi -> n + 1, NULL for lo = hi); for descending bounds
        # PostgreSQL's mirror (x > lo -> 0, x <= hi -> n + 1), where the
        # reference counts as if ascending; a count below 1 is
        # PostgreSQL's error, where the reference returns buckets
        nb = int(e.args[3].value)
        if nb <= 0:
            raise EngineError("width_bucket count must be greater than "
                              "zero")

        def f_wb(ctx):
            (x, vx), (lo, vl), (hi, vh), (_, vn) = [f(ctx) for f in fs]
            asc = lo < hi
            span = torch.where(hi != lo, hi - lo, torch.ones_like(hi))
            inner = torch.floor((x - lo) / span * nb).to(torch.int64) + 1
            up = torch.where(x < lo, 0, torch.where(x >= hi, nb + 1, inner))
            down = torch.where(x > lo, 0,
                               torch.where(x <= hi, nb + 1, inner))
            ok = torch.logical_and(torch.logical_and(vx, vl),
                                   torch.logical_and(vh, vn))
            return (torch.where(asc, up, down),
                    torch.logical_and(ok, hi != lo))
        return f_wb
    if name == "isnan":
        def f_isnan(ctx):
            d, v = fs[0](ctx)
            return torch.isnan(d), v
        return f_isnan
    if name in ("date_trunc_date", "date_trunc_ts"):
        part = e.args[0].value
        kern = (K.date_trunc_days if name == "date_trunc_date"
                else K.date_trunc_micros)

        def f_trunc(ctx):
            d, v = fs[1](ctx)
            return kern(part, d), v
        return f_trunc
    raise NotImplementedError(f"no kernel for builtin {name}")
