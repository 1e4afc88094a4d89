"""Builtin scalar function library.

The analogue of pkg/sql/sem/builtins (~600 functions in the reference).
Functions split by execution strategy, each chosen for the TPU:

- **Elementwise numeric/date** (sin, pow, date_trunc, ...): bind to a
  BFunc/BUnary node whose kernel is a jnp elementwise op —- XLA fuses
  it into the surrounding scan, so a builtin costs nothing extra.
- **String functions over dictionary-encoded columns** (upper, length,
  substr, ...): evaluated ONCE against the column's dictionary on the
  host at bind time, producing a value table; on device the function is
  a single gather (BDictGather). upper() over 600M rows costs O(|dict|)
  host work + one gather — the dictionary-encoding dividend.
- **Constant folding**: any builtin over constants folds at bind time
  (the reference's normalization rules, opt/norm).

Registered entries are consulted by Binder.bind_func (binder.py).
"""

from __future__ import annotations

import datetime
import math
import re

import numpy as np

from .bound import BCase, BConst, BDictGather, BExpr, BFunc, BUnary
from .types import (BOOL, DATE, FLOAT8, INT8, STRING, TIMESTAMP, Family,
                    SQLType)


class BuiltinError(Exception):
    pass




# no-arg informational builtins: name -> (value, type). Session
# identity stays static (single-tenant engine); the point is driver/
# ORM compatibility (pg_catalog-adjacent probes).
_INFO_FNS = {
    "current_database": ("defaultdb", STRING),
    "current_schema": ("public", STRING),
    "current_user": ("root", STRING),
    "session_user": ("root", STRING),
    "pg_backend_pid": (0, INT8),
    "pg_is_in_recovery": (False, BOOL),
    "txid_current": (0, INT8),
    "inet_server_port": (26257, INT8),
}


# 1-arg float elementwise builtins: name -> python fn (for constant
# folding); the device kernel table lives in exec/expr.py:_FUNC_KERNELS
FLOAT_UNARY = {
    "sqrt": math.sqrt, "ln": math.log, "exp": math.exp,
    "log10": math.log10, "log2": math.log2,
    "cbrt": lambda x: math.copysign(abs(x) ** (1 / 3), x),
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "cot": lambda x: 1.0 / math.tan(x),
    "asin": math.asin, "acos": math.acos, "atan": math.atan,
    "sinh": math.sinh, "cosh": math.cosh, "tanh": math.tanh,
    "asinh": math.asinh, "acosh": math.acosh, "atanh": math.atanh,
    "degrees": math.degrees, "radians": math.radians,
    "floor": math.floor, "ceil": math.ceil, "ceiling": math.ceil,
    "erf": math.erf, "erfc": math.erfc,
    # pg's degree-argument trigonometry family
    "sind": lambda x: math.sin(math.radians(x)),
    "cosd": lambda x: math.cos(math.radians(x)),
    "tand": lambda x: math.tan(math.radians(x)),
    "cotd": lambda x: 1.0 / math.tan(math.radians(x)),
    "asind": lambda x: math.degrees(math.asin(x)),
    "acosd": lambda x: math.degrees(math.acos(x)),
    "atand": lambda x: math.degrees(math.atan(x)),
}

# integer constant-fold-only builtins (no row-wise device kernel;
# these appear in expressions over literals, pg's immutable int fns):
# name -> (arity, fn)
INT_FOLD = {
    "factorial": (1, lambda n: math.factorial(int(n))),
    "gcd": (2, lambda a, b: math.gcd(int(a), int(b))),
    "lcm": (2, lambda a, b: math.lcm(int(a), int(b))),
}

# 2-arg float elementwise
FLOAT_BINARY = {
    "pow": math.pow, "power": math.pow, "atan2": math.atan2,
}


def _fold(name, args, pyfn, ty):
    """Constant-fold when every argument is a constant."""
    if all(isinstance(a, BConst) for a in args):
        vals = [a.value for a in args]
        if any(v is None for v in vals):
            return BConst(None, ty)
        try:
            return BConst(pyfn(*vals), ty)
        except (ValueError, OverflowError, ZeroDivisionError):
            return BConst(None, ty)
    return None


def bind_builtin(binder, name: str, args: list, e) -> BExpr | None:
    """Resolve a builtin call; returns None if unknown (caller errors).
    ``binder`` provides coerce() and dictionary resolution; ``e`` is the
    original ast.FuncCall (for string-literal args)."""
    if name in _DATUM_FNS and args \
            and args[0].type.family in (Family.ARRAY, Family.JSON):
        return _datum_builtin(binder, name, args)
    if name in FLOAT_UNARY:
        if len(args) != 1:
            raise BuiltinError(f"{name} takes one argument")
        x = binder.coerce(args[0], FLOAT8)
        return _fold(name, [x], FLOAT_UNARY[name], FLOAT8) \
            or BFunc(name, [x], FLOAT8)
    if name in FLOAT_BINARY:
        if len(args) != 2:
            raise BuiltinError(f"{name} takes two arguments")
        xs = [binder.coerce(a, FLOAT8) for a in args]
        return _fold(name, xs, FLOAT_BINARY[name], FLOAT8) \
            or BFunc(name, xs, FLOAT8)
    if name in INT_FOLD:
        arity, fn = INT_FOLD[name]
        if len(args) != arity:
            raise BuiltinError(
                f"{name} takes {arity} argument"
                + ("s" if arity != 1 else ""))
        out = _fold(name, args, fn, INT8)
        if out is None:
            raise BuiltinError(
                f"{name} over columns not supported (constants only)")
        return out
    if name in ("round", "trunc") and len(args) == 2:
        x = binder.coerce(args[0], FLOAT8)
        nd = args[1]
        if not isinstance(nd, BConst):
            raise BuiltinError(f"{name} digit count must be constant")
        return BFunc(name + "_n", [x, BConst(int(nd.value), INT8)], FLOAT8)
    if name == "trunc" and len(args) == 1:
        x = binder.coerce(args[0], FLOAT8)
        return _fold(name, [x], math.trunc, FLOAT8) \
            or BFunc("trunc", [x], FLOAT8)
    if name == "sign":
        x = binder.coerce(args[0], FLOAT8)
        return _fold(name, [x], lambda v: float(np.sign(v)), FLOAT8) \
            or BFunc("sign", [x], FLOAT8)
    if name == "mod":
        if len(args) != 2:
            raise BuiltinError("mod takes two arguments")
        from .binder import Binder  # for _align2 typing only
        l, r, ty = binder._align2(args[0], args[1])
        return BFunc("mod", [l, r], ty)
    if name == "div":
        xs = [binder.coerce(a, FLOAT8) for a in args]
        return BFunc("div", xs, FLOAT8)
    if name in ("greatest", "least"):
        if not args:
            raise BuiltinError(f"{name} needs arguments")
        ty = args[0].type
        for a in args[1:]:
            _, _, ty = binder._align2(BConst(None, ty), a)
        xs = [binder.coerce(a, ty) for a in args]
        return BFunc(name, xs, ty)
    if name == "nullif":
        if len(args) != 2:
            raise BuiltinError("nullif takes two arguments")
        l, r, _ = binder._align2(args[0], args[1])
        if l.type.family == Family.STRING:
            return _string_nullif(binder, l, r)
        return BFunc("nullif", [l, r], l.type)
    if name == "pi":
        return BConst(math.pi, FLOAT8)
    if name == "log":
        # pg: log(x) = base-10; log(b, x) = arbitrary base
        xs = [binder.coerce(a, FLOAT8) for a in args]
        if len(xs) == 1:
            return _fold("log", xs, math.log10, FLOAT8) \
                or BFunc("log10", xs, FLOAT8)
        if len(xs) == 2:
            return _fold("log", xs,
                         lambda b, x: math.log(x) / math.log(b),
                         FLOAT8) or BFunc("logb", xs, FLOAT8)
        raise BuiltinError("log(x) or log(base, x)")
    if name == "random":
        # volatile; folded per bind like the sequence builtins (NB:
        # one value per statement, not per row — the device kernels
        # have no RNG key plumbing yet)
        import random as _random
        return BConst(_random.random(), FLOAT8)
    if name == "gen_random_uuid":
        import uuid as _uuid
        return BConst(str(_uuid.uuid4()), STRING)
    if name == "version":
        from .. import __version__
        return BConst(f"cockroach-tpu {__version__}", STRING)
    if name == "chr":
        x = binder.coerce(args[0], INT8)
        out = _fold("chr", [x], lambda v: chr(int(v)), STRING)
        if out is None:
            raise BuiltinError("chr over columns not supported "
                               "(constant only)")
        return out
    if name == "to_hex":
        x = binder.coerce(args[0], INT8)
        # negatives render as 64-bit two's complement, like pg
        out = _fold("to_hex", [x],
                    lambda v: format(int(v) & 0xFFFFFFFFFFFFFFFF, "x"),
                    STRING)
        if out is None:
            raise BuiltinError("to_hex over columns not supported "
                               "(constant only)")
        return out
    if name == "format":
        if not args or not isinstance(args[0], BConst):
            raise BuiltinError("format needs a constant template")
        if not all(isinstance(a, BConst) for a in args):
            raise BuiltinError("format over columns not supported "
                               "(constants only)")
        if args[0].value is None:
            return BConst(None, STRING)  # NULL template -> NULL (pg)
        tmpl = str(args[0].value)
        vals = []
        for a in args[1:]:
            v = a.value
            if v is not None and a.type.family == Family.DECIMAL:
                v = v / 10 ** a.type.scale
            vals.append(v)
        # pg format(): %s plain, %I quoted identifier, %L quoted
        # literal (NULL -> the keyword), %% literal percent
        out = []
        i = 0
        vi = 0
        n = len(tmpl)
        while i < n:
            ch = tmpl[i]
            if ch != "%":
                out.append(ch)
                i += 1
                continue
            spec = tmpl[i + 1:i + 2]
            i += 2
            if spec == "%":
                out.append("%")
                continue
            if spec not in ("s", "I", "L"):
                raise BuiltinError(
                    f"unrecognized format() type specifier "
                    f"%{spec or ''}")
            if vi >= len(vals):
                raise BuiltinError("too few arguments for format()")
            v = vals[vi]
            vi += 1
            if spec == "s":
                out.append("" if v is None else str(v))
            elif spec == "I":
                if v is None:
                    raise BuiltinError(
                        "format: NULL cannot be a %I identifier")
                out.append('"' + str(v).replace('"', '""') + '"')
            else:
                out.append("NULL" if v is None
                           else "'" + str(v).replace("'", "''")
                           + "'")
        return BConst("".join(out), STRING)
    if name == "isnan":
        x = binder.coerce(args[0], FLOAT8)
        return BFunc("isnan", [x], BOOL)
    if name == "width_bucket":
        if len(args) != 4:
            raise BuiltinError("width_bucket(x, lo, hi, n)")
        xs = [binder.coerce(a, FLOAT8) for a in args[:3]]
        n = args[3]
        if not isinstance(n, BConst):
            raise BuiltinError("width_bucket count must be constant")
        return BFunc("width_bucket", xs + [BConst(int(n.value), INT8)], INT8)

    # ---- date/time --------------------------------------------------------
    if name in ("now", "current_timestamp", "localtimestamp",
                "transaction_timestamp", "statement_timestamp",
                "clock_timestamp"):
        # every statement-timestamp variant folds to the statement's
        # HLC moment (timestamptz is future work, so local == utc)
        us = binder.now_micros
        if us is None:
            raise BuiltinError(f"{name}() needs a statement timestamp")
        return BConst(int(us), TIMESTAMP)
    if name == "current_date":
        us = binder.now_micros
        if us is None:
            raise BuiltinError("current_date needs a statement timestamp")
        return BConst(int(us // 86_400_000_000), DATE)
    if name == "to_timestamp":
        x = binder.coerce(args[0], FLOAT8)
        out = _fold(name, [x], lambda v: int(v * 1_000_000), TIMESTAMP)
        if out is None:
            raise BuiltinError(
                "to_timestamp over columns not supported "
                "(constants only)")
        return out
    if name == "make_timestamp":
        xs = [binder.coerce(a, FLOAT8) for a in args]
        if len(xs) != 6 or not all(isinstance(a, BConst) for a in xs):
            raise BuiltinError(
                "make_timestamp(y, mon, d, h, min, sec) constants")
        if any(a.value is None for a in xs):
            return BConst(None, TIMESTAMP)  # strict: NULL arg -> NULL
        y, mo, d, h, mi, s = (a.value for a in xs)
        try:
            dt = datetime.datetime(int(y), int(mo), int(d), int(h),
                                   int(mi)) \
                - datetime.datetime(1970, 1, 1)
        except (ValueError, OverflowError) as exc:
            raise BuiltinError(f"make_timestamp: {exc}") from None
        return BConst(int(dt.total_seconds() * 1_000_000
                          + s * 1_000_000), TIMESTAMP)
    if name == "isfinite":
        if not args:
            raise BuiltinError("isfinite takes one argument")
        x = args[0]
        if isinstance(x, BConst):
            # strict: NULL in -> NULL out (pg)
            return BConst(None if x.value is None else True, BOOL)
        # all STORED dates/timestamps are finite; NULL rows stay NULL
        from .bound import BIsNull
        return BCase(whens=[(BIsNull(x), BConst(None, BOOL))],
                     else_=BConst(True, BOOL), type=BOOL)
    if name == "date_trunc":
        if len(args) != 2 or not isinstance(args[0], BConst):
            raise BuiltinError("date_trunc('part', expr)")
        part = str(args[0].value).lower()
        x = args[1]
        if x.type.family not in (Family.DATE, Family.TIMESTAMP):
            raise BuiltinError("date_trunc needs date/timestamp")
        if part not in ("year", "quarter", "month", "week", "day",
                        "hour", "minute", "second"):
            raise BuiltinError(f"bad date_trunc field {part!r}")
        if x.type.family == Family.DATE and part in (
                "hour", "minute", "second", "day"):
            return x  # trunc below day granularity is identity on DATE
        kind = "ts" if x.type.family == Family.TIMESTAMP else "date"
        return BFunc(f"date_trunc_{kind}",
                     [BConst(part, STRING), x], x.type)
    if name in ("extract", "date_part"):
        # EXTRACT has dedicated syntax, but date_part('year', x) arrives
        # here as a plain call
        if len(args) != 2 or not isinstance(args[0], BConst):
            raise BuiltinError("date_part('part', expr)")
        from .bound import BExtract
        return BExtract(str(args[0].value).lower(), args[1], INT8)
    if name == "make_date":
        xs = [binder.coerce(a, INT8) for a in args]
        if all(isinstance(a, BConst) for a in xs):
            y, m, d = (int(a.value) for a in xs)
            return BConst(
                (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days,
                DATE)
        raise BuiltinError("make_date requires constants")
    if name == "age":
        if len(args) == 2:
            from .bound import BBin
            from .types import INTERVAL

            def _to_ts(a):
                if a.type.family == Family.TIMESTAMP:
                    return a
                if a.type.family == Family.DATE:
                    # days -> micros (both are epoch-relative ints)
                    return BBin("*", a,
                                BConst(86_400_000_000, INT8),
                                TIMESTAMP)
                if isinstance(a, BConst) and isinstance(a.value, str):
                    from .binder import parse_timestamp
                    return BConst(parse_timestamp(a.value), TIMESTAMP)
                return None
            l, r = _to_ts(args[0]), _to_ts(args[1])
            if l is not None and r is not None:
                return BBin("-", l, r, INTERVAL)
        raise BuiltinError("age(timestamp, timestamp)")
    if name == "to_char":
        # to_char(date|timestamp, 'pattern') over constants or a
        # dictionary-free context: pattern subset YYYY MM DD HH24 MI SS
        if len(args) != 2 or not isinstance(args[1], BConst):
            raise BuiltinError("to_char(expr, 'pattern')")
        x, pat = args[0], str(args[1].value)
        if not isinstance(x, BConst):
            raise BuiltinError("to_char over columns not supported "
                               "(constant only)")
        if x.value is None:
            return BConst(None, STRING)
        if x.type.family == Family.DATE:
            dt = datetime.date(1970, 1, 1) + \
                datetime.timedelta(days=int(x.value))
        elif x.type.family == Family.TIMESTAMP:
            dt = datetime.datetime(1970, 1, 1) + \
                datetime.timedelta(microseconds=int(x.value))
        else:
            raise BuiltinError("to_char needs a date/timestamp")
        fmt = (pat.replace("YYYY", "%Y").replace("MM", "%m")
               .replace("DD", "%d").replace("HH24", "%H")
               .replace("MI", "%M").replace("SS", "%S"))
        return BConst(dt.strftime(fmt), STRING)

    if name in _INFO_FNS:
        if args:
            raise BuiltinError(f"{name} takes no arguments")
        v, ty = _INFO_FNS[name]
        return BConst(v, ty)
    if name in ("justify_hours", "justify_days",
                "justify_interval"):
        # intervals are stored as total microseconds, so pg's
        # days/months re-bucketing is an output-formatting identity
        # here — the VALUE is unchanged by construction
        if len(args) != 1:
            raise BuiltinError(f"{name} takes one argument")
        return args[0]
    if name == "timeofday":
        us = binder.now_micros
        if us is None:
            raise BuiltinError("timeofday() needs a statement "
                               "timestamp")
        dt = datetime.datetime(1970, 1, 1) + \
            datetime.timedelta(microseconds=int(us))
        return BConst(dt.strftime("%a %b %d %H:%M:%S.%f")
                      + f" {dt.year} UTC", STRING)
    if name == "pg_typeof":
        if len(args) != 1:
            raise BuiltinError("pg_typeof takes one argument")
        return BConst(str(args[0].type).lower(), STRING)
    if name in ("obj_description", "col_description",
                "shobj_description"):
        return BConst(None, STRING)   # no comments stored
    if name == "pg_get_userbyid":
        return BConst("root", STRING)
    if name in ("has_table_privilege", "has_schema_privilege",
                "has_database_privilege", "pg_table_is_visible",
                "pg_function_is_visible"):
        return BConst(True, BOOL)     # single-role engine
    if name == "pg_encoding_to_char":
        return BConst("UTF8", STRING)
    if name == "uuid_generate_v4":
        return bind_builtin(binder, "gen_random_uuid", args, e)
    if name == "date_bin":
        # date_bin(stride, ts, origin): origin-aligned truncation —
        # pure int64 micros arithmetic, so it runs over COLUMNS and
        # fuses on device
        if len(args) != 3:
            raise BuiltinError("date_bin(stride, ts, origin)")
        from .bound import BBin
        stride, ts, origin = args
        if not isinstance(stride, BConst):
            raise BuiltinError("date_bin stride must be constant")
        sv = int(stride.value)
        if sv <= 0:
            raise BuiltinError("date_bin stride must be positive")
        if not isinstance(origin, BConst):
            raise BuiltinError("date_bin origin must be constant")
        ov = int(origin.value)
        # origin + ((ts - origin) / stride) * stride, integer division
        delta = BBin("-", ts, BConst(ov, TIMESTAMP), INT8)
        q = BFunc("div", [delta, BConst(sv, INT8)], INT8)
        return BBin("+", BConst(ov, TIMESTAMP),
                    BBin("*", q, BConst(sv, INT8), INT8), TIMESTAMP)

    # ---- strings over dictionaries ---------------------------------------
    out = _bind_string_builtin(binder, name, args)
    if out is not None:
        return out
    return None


# string -> string builtins: name -> fn(str, *const_args) -> str
_STR_TO_STR = {
    "upper": lambda s: s.upper(),
    "lower": lambda s: s.lower(),
    "initcap": lambda s: s.title(),
    "reverse": lambda s: s[::-1],
    "btrim": lambda s, chars=None: s.strip(chars),
    "trim": lambda s, chars=None: s.strip(chars),
    "ltrim": lambda s, chars=None: s.lstrip(chars),
    "rtrim": lambda s, chars=None: s.rstrip(chars),
    "replace": lambda s, a, b: s.replace(a, b),
    "translate": lambda s, frm, to: s.translate(
        str.maketrans(frm[:len(to)], to[:len(frm)], frm[len(to):])),
    "left": lambda s, n: s[:n] if n >= 0 else s[:len(s) + n],
    "right": lambda s, n: (s[-n:] if n > 0 else s[-n - len(s):]
                           if n < 0 else ""),
    "repeat": lambda s, n: s * max(n, 0),
    "lpad": lambda s, n, fill=" ": _pad(s, n, fill, left=True),
    "rpad": lambda s, n, fill=" ": _pad(s, n, fill, left=False),
    "substr": lambda s, start, length=None: _substr(s, start, length),
    "substring": lambda s, start, length=None: _substr(s, start, length),
    "split_part": lambda s, d, n: _split_part(s, d, n),
    "overlay": lambda s, repl, start, ln=None: (
        s[:start - 1] + repl
        + s[start - 1 + (len(repl) if ln is None else ln):]),
    "quote_ident": lambda s: '"' + s.replace('"', '""') + '"',
    "quote_literal": lambda s: "'" + s.replace("'", "''") + "'",
    "quote_nullable": lambda s: "'" + s.replace("'", "''") + "'",
    "encode": lambda s, fmt: _encode_blob(s, fmt),
    "decode": lambda s, fmt: _decode_blob(s, fmt),
    # pg regexp_replace: first match unless flags contain 'g'
    "regexp_replace": lambda s, pat, repl, flags="": re.sub(
        pat, repl, s,
        count=(0 if "g" in flags else 1),
        flags=(re.IGNORECASE if "i" in flags else 0)),
    "concat": None,     # variadic, handled specially
    "concat_ws": None,  # variadic, handled specially
    "md5": None,        # needs hashlib, handled specially
    "sha1": None,
    "sha256": None,
    "sha512": None,
}

# string -> scalar builtins: name -> (fn, SQLType)
_STR_TO_VAL = {
    "length": (len, INT8),
    "char_length": (len, INT8),
    "character_length": (len, INT8),
    "octet_length": (lambda s: len(s.encode()), INT8),
    "bit_length": (lambda s: len(s.encode()) * 8, INT8),
    "ascii": (lambda s: ord(s[0]) if s else 0, INT8),
    "strpos": (lambda s, sub: s.find(sub) + 1, INT8),
    "position": (lambda s, sub: s.find(sub) + 1, INT8),
    "starts_with": (lambda s, p: s.startswith(p), BOOL),
    "ends_with": (lambda s, p: s.endswith(p), BOOL),
    # CRDB string hash family (pkg/sql/sem/builtins: fnv/crc over the
    # value bytes) + fuzzystrmatch's levenshtein
    "fnv32": (lambda s: _fnv(s.encode(), 0x811c9dc5,
                             0x01000193, 1 << 32), INT8),
    "fnv32a": (lambda s: _fnva(s.encode(), 0x811c9dc5,
                               0x01000193, 1 << 32), INT8),
    "fnv64": (lambda s: _fnv(s.encode(), 0xcbf29ce484222325,
                             0x100000001b3, 1 << 64), INT8),
    "fnv64a": (lambda s: _fnva(s.encode(), 0xcbf29ce484222325,
                               0x100000001b3, 1 << 64), INT8),
    "crc32ieee": (lambda s: __import__("binascii").crc32(s.encode()),
                  INT8),
    "levenshtein": (lambda s, t: _levenshtein(s, t), INT8),
    "to_date": (lambda s, fmt: _to_date_days(s, fmt), DATE),
    # pg 15 regexp family (pattern/flags must be constants; the
    # predicate evaluates once per dictionary entry, sql/binder.py)
    "regexp_like": (lambda s, pat, flags="": bool(re.search(
        pat, s, re.IGNORECASE if "i" in flags else 0)), BOOL),
    "regexp_count": (lambda s, pat, flags="": len(re.findall(
        pat, s, re.IGNORECASE if "i" in flags else 0)), INT8),
    "regexp_instr": (lambda s, pat, flags="": (
        (lambda m: m.start() + 1 if m else 0)(re.search(
            pat, s, re.IGNORECASE if "i" in flags else 0))), INT8),
}


def _string_nullif(binder, l, r) -> BExpr:
    """NULLIF over STRING: the result keeps the first argument's codes and
    its dictionary; the second argument compares in that code space (a
    literal as its code, -1 and so never equal when it is absent; a
    column of another dictionary through a code remap). The reference
    passes the literal's text to the device and fails."""
    from .bound import BDictRemap
    if isinstance(l, BConst) and isinstance(r, BConst):
        same = l.value is not None and r.value is not None \
            and str(l.value) == str(r.value)
        return BConst(None if same else l.value, STRING)
    if isinstance(l, BConst):
        raise BuiltinError("nullif of a string literal by a string "
                           "column is not supported")
    d = binder._dict_of(l)
    if d is None:
        raise BuiltinError("nullif over a string expression without a "
                           "dictionary")
    if isinstance(r, BConst):
        r = BConst(None if r.value is None else d.codes.get(str(r.value), -1),
                   STRING)
    else:
        rd = binder._dict_of(r)
        if rd is None:
            raise BuiltinError("nullif over a string expression without a "
                               "dictionary")
        if rd is not d:
            table = np.fromiter((d.codes.get(v, -1) for v in rd.values),
                                dtype=np.int32, count=len(rd.values))
            r = BDictRemap(r, table, STRING)
    out = BFunc("nullif", [l, r], STRING)
    out.dictionary = d
    return out


def _intersperse(args: list, sep) -> list:
    out = []
    for i, a in enumerate(args):
        if i:
            out.append(sep)
        out.append(a)
    return out


def _pad(s, n, fill, left):
    if n <= len(s):
        return s[:n]
    pad = (fill * n)[: n - len(s)]
    return pad + s if left else s + pad


def _split_part(s: str, delim, n):
    if delim is None or n is None:
        return None  # NULL in, NULL out (str.split(None) would
        # silently mean whitespace-split)
    n = int(n)
    if n < 1:
        raise BuiltinError("split_part field must be >= 1")
    parts = s.split(delim)
    return parts[n - 1] if n <= len(parts) else ""


def _substr(s, start, length=None):
    # SQL substring: 1-based; nonpositive start eats into length
    i = start - 1
    if length is None:
        return s[max(i, 0):]
    end = i + length
    return s[max(i, 0):max(end, 0)]


_HASH_FNS = ("md5", "sha1", "sha224", "sha256", "sha384", "sha512")


def _encode_blob(s: str, fmt: str) -> str:
    import base64 as _b64
    if fmt == "hex":
        return s.encode().hex()
    if fmt == "base64":
        return _b64.b64encode(s.encode()).decode()
    if fmt == "escape":
        return "".join(c if 32 <= ord(c) < 127 and c != "\\"
                       else f"\\{ord(c):03o}" for c in s)
    raise BuiltinError(f"unknown encode format {fmt!r}")


def _decode_blob(s: str, fmt: str) -> str:
    import base64 as _b64
    try:
        if fmt == "hex":
            return bytes.fromhex(s).decode()
        if fmt == "base64":
            return _b64.b64decode(s).decode()
    except (ValueError, UnicodeDecodeError) as exc:
        raise BuiltinError(f"decode: {exc}") from None
    raise BuiltinError(f"unknown decode format {fmt!r}")


def _fnv(data: bytes, basis: int, prime: int, mod: int) -> int:
    h = basis
    for b in data:
        h = (h * prime) % mod
        h ^= b
    return h if h < (1 << 63) else h - (1 << 64)


def _fnva(data: bytes, basis: int, prime: int, mod: int) -> int:
    h = basis
    for b in data:
        h ^= b
        h = (h * prime) % mod
    return h if h < (1 << 63) else h - (1 << 64)


def _levenshtein(s: str, t: str) -> int:
    if len(s) < len(t):
        s, t = t, s
    prev = list(range(len(t) + 1))
    for i, cs in enumerate(s, 1):
        cur = [i]
        for j, ct in enumerate(t, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (cs != ct)))
        prev = cur
    return prev[-1]


def _to_date_days(s: str, fmt: str) -> int:
    pat = (fmt.replace("YYYY", "%Y").replace("MM", "%m")
           .replace("DD", "%d"))
    try:
        d = datetime.datetime.strptime(s.strip(), pat).date()
    except ValueError as exc:
        raise BuiltinError(f"to_date: {exc}") from None
    return (d - datetime.date(1970, 1, 1)).days


def _bind_string_builtin(binder, name: str, args: list) -> BExpr | None:
    import hashlib
    if name in _HASH_FNS:
        h = getattr(hashlib, name)
        fn = lambda s: h(s.encode()).hexdigest()  # noqa: E731
        return _dict_transform(binder, name, args[0], fn)
    if name == "concat_ws":
        if len(args) < 2 or not isinstance(args[0], BConst):
            raise BuiltinError(
                "concat_ws needs a constant separator first")
        sep = args[0].value
        if sep is None:
            return BConst(None, STRING)
        # pg: NULL arguments are skipped TOGETHER with their
        # separator (constant NULLs here; a NULL column VALUE still
        # nulls the row, a known narrowing of pg's per-row skip)
        live = [a for a in args[1:]
                if not (isinstance(a, BConst) and a.value is None)]
        if not live:
            return BConst("", STRING)
        return _bind_string_builtin(binder, "concat", _intersperse(
            live, BConst(str(sep), STRING)))
    if name == "concat":
        # variadic; exactly one dictionary column allowed, rest constants
        col_i = None
        parts = []
        for i, a in enumerate(args):
            if isinstance(a, BConst):
                parts.append("" if a.value is None else str(a.value))
            elif a.type.family == Family.STRING and col_i is None:
                col_i = i
                parts.append(None)
            else:
                raise BuiltinError(
                    "concat supports one string column + constants")
        if col_i is None:
            return BConst("".join(parts), STRING)
        pre = "".join(p for p in parts[:col_i] if p is not None)
        post = "".join(p for p in parts[col_i + 1:] if p is not None)
        return _dict_transform(binder, name, args[col_i],
                               lambda s: pre + s + post)
    if name in _STR_TO_STR:
        if not args:
            raise BuiltinError(f"{name} needs arguments")
        x, consts = args[0], args[1:]
        cvals = []
        for c in consts:
            if not isinstance(c, BConst):
                raise BuiltinError(
                    f"{name}: non-leading arguments must be constants")
            cvals.append(c.value)
        if any(v is None for v in cvals):
            return BConst(None, STRING)  # strict: NULL arg -> NULL
        fn = _STR_TO_STR[name]
        return _dict_transform(binder, name, x,
                               lambda s: fn(s, *cvals))
    if name in _STR_TO_VAL:
        fn, ty = _STR_TO_VAL[name]
        x, consts = args[0], args[1:]
        cvals = []
        for c in consts:
            if not isinstance(c, BConst):
                raise BuiltinError(
                    f"{name}: non-leading arguments must be constants")
            cvals.append(c.value)
        if any(v is None for v in cvals):
            return BConst(None, ty)  # strict: NULL arg -> NULL
        if isinstance(x, BConst):
            if x.value is None:
                return BConst(None, ty)
            return BConst(fn(str(x.value), *cvals), ty)
        d = binder._dict_of(x)
        if d is None:
            raise BuiltinError(f"{name} on non-dictionary column")
        vals = [fn(v, *cvals) for v in d.values]
        table = np.asarray(vals,
                           dtype=bool if ty is BOOL else np.int64)
        return BDictGather(x, table, ty)
    return None


def _dict_transform(binder, name, x, fn) -> BExpr:
    """string->string builtin: build an output dictionary by mapping the
    input dictionary through fn; the device op is a code remap gather."""
    from ..storage.columnstore import Dictionary
    if isinstance(x, BConst):
        if x.value is None:
            return BConst(None, STRING)
        try:
            return BConst(fn(str(x.value)), STRING)
        except re.error as exc:
            raise BuiltinError(f"{name}: invalid pattern: {exc}") \
                from None
    if x.type.family != Family.STRING:
        raise BuiltinError(f"{name} needs a string argument")
    d = binder._dict_of(x)
    if d is None:
        raise BuiltinError(f"{name} on non-dictionary column")
    out = Dictionary()
    try:
        codes = np.fromiter((out.encode(fn(v)) for v in d.values),
                            dtype=np.int64, count=len(d.values))
    except re.error as exc:
        # user-supplied malformed regexp (regexp_replace): a clean
        # bind error, not a traceback mid-dictionary-map
        raise BuiltinError(f"{name}: invalid pattern: {exc}") from None
    g = BDictGather(x, codes, STRING)
    g.dictionary = out
    return g


# -- datum builtins (ARRAY / JSONB) ---------------------------------------
# Same dictionary-LUT strategy as the string builtins above: the
# function runs once per DICTIONARY ENTRY on the host (values parsed
# from canonical text, sql/datum.py), and the device op is one typed
# gather. The reference evaluates these per row through tree.Datum
# (pkg/sql/sem/builtins/builtins.go json/array sections).

def _jsonb_typeof(v):
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, list):
        return "array"
    return "object"


def _array_position(v, needle):
    try:
        return v.index(needle) + 1
    except ValueError:
        return None


# name -> (fn(parsed, *const_args) -> value|None, result type, n_args,
#           required argument family) — array builtins bind ONLY on
# arrays and jsonb builtins only on jsonb, like pg's overload
# resolution; the wrong family is a bind error, not silent garbage
_DATUM_FNS = {
    "array_length": (lambda v, dim: len(v) if dim == 1 and v else None,
                     INT8, 2, Family.ARRAY),
    "cardinality": (lambda v: len(v), INT8, 1, Family.ARRAY),
    "array_position": (_array_position, INT8, 2, Family.ARRAY),
    "array_to_string": (
        lambda v, delim: delim.join(str(x) for x in v if x is not None),
        STRING, 2, Family.ARRAY),
    "jsonb_typeof": (_jsonb_typeof, STRING, 1, Family.JSON),
    "json_typeof": (_jsonb_typeof, STRING, 1, Family.JSON),
    "jsonb_array_length": (
        lambda v: len(v) if isinstance(v, list) else None, INT8, 1,
        Family.JSON),
    "jsonb_exists": (
        lambda v, key: (key in v if isinstance(v, dict)
                        else str(key) in [str(x) for x in v]
                        if isinstance(v, list) else False),
        BOOL, 2, Family.JSON),
}


def _datum_builtin(binder, name, args) -> BExpr:
    from . import datum as dtm
    from .bound import BDictRemap
    from ..storage.columnstore import Dictionary
    fn, ty, nargs, fam = _DATUM_FNS[name]
    if len(args) != nargs:
        raise BuiltinError(f"{name} takes {nargs} argument(s)")
    x, consts = args[0], args[1:]
    if x.type.family != fam:
        raise BuiltinError(
            f"{name} does not exist for argument type {x.type}")
    cvals = []
    for c in consts:
        if not isinstance(c, BConst):
            raise BuiltinError(
                f"{name}: non-leading arguments must be constants")
        if c.value is None:
            return BConst(None, ty)
        v = c.value
        if c.type.family in (Family.ARRAY, Family.JSON):
            v = dtm.decode_text(v, c.type)
        cvals.append(v)
    if name == "array_position" and x.type.family == Family.ARRAY \
            and x.type.elem.family == Family.DECIMAL:
        raise BuiltinError("array_position on decimal arrays unsupported")
    if isinstance(x, BConst):
        if x.value is None:
            return BConst(None, ty)
        return BConst(fn(dtm.decode_text(x.value, x.type), *cvals), ty)
    d = binder._dict_of(x)
    if d is None:
        raise BuiltinError(f"{name} on non-dictionary column")
    parsed = [dtm.decode_text(v, x.type) for v in d.values]
    results = [fn(pv, *cvals) for pv in parsed]
    nulls = np.fromiter((r is not None for r in results),
                        dtype=bool, count=len(results))
    if ty is STRING:
        out = Dictionary()
        table = np.fromiter(
            (out.encode(r) if r is not None else -1 for r in results),
            dtype=np.int32, count=len(results))
        g = BDictRemap(x, table, STRING, null_table=nulls)
        g.dictionary = out
        return g
    table = np.asarray([r if r is not None else 0 for r in results],
                       dtype=bool if ty is BOOL else np.int64)
    return BDictGather(x, table, ty, null_table=nulls)
