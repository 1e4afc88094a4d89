"""Dtype-generic columnar kernels with SQL NULL semantics, on tensors.

The counterpart of cockroach_tpu/ops/kernels.py: the reference's
per-type generated kernels (pkg/sql/colexec/*.eg.go) collapse into a
handful of PyTorch functions that dispatch on dtype at run time.

Values are (data, valid) pairs; ``valid`` is the non-NULL mask.
SQL three-valued logic:
  - arithmetic/comparison: NULL if any input is NULL
  - AND: FALSE if either is FALSE, else NULL if any NULL
  - OR:  TRUE if either is TRUE, else NULL if any NULL
Boolean results additionally distinguish value from validity, so a
WHERE clause keeps a row only where (valid AND value).

Decimal columns are scaled int64 (see sql/types.py); decimal*decimal
rescales by 10**scale after the multiply. torch's ``//`` on integer
tensors floors, like jnp's, so the rescale rounds the same way.
"""

from __future__ import annotations

from typing import Callable

import torch

SV = tuple  # (data, valid)


def _both(va, vb):
    return torch.logical_and(va, vb)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def add(a: SV, b: SV) -> SV:
    return a[0] + b[0], _both(a[1], b[1])


def sub(a: SV, b: SV) -> SV:
    return a[0] - b[0], _both(a[1], b[1])


def mul(a: SV, b: SV) -> SV:
    return a[0] * b[0], _both(a[1], b[1])


def div(a: SV, b: SV) -> SV:
    # x / 0 yields NULL for that row (the reference raises from the
    # kernel, colexecproj; the vectorized form masks it)
    zero = b[0] == 0
    denom = torch.where(zero, torch.ones_like(b[0]), b[0])
    out = a[0] / denom if a[0].is_floating_point() else a[0] // denom
    return out, _both(_both(a[1], b[1]), torch.logical_not(zero))


def mod(a: SV, b: SV) -> SV:
    # SQL mod truncates toward zero (sign of the dividend): fmod
    zero = b[0] == 0
    denom = torch.where(zero, torch.ones_like(b[0]), b[0])
    return (torch.fmod(a[0], denom),
            _both(_both(a[1], b[1]), torch.logical_not(zero)))


def neg(a: SV) -> SV:
    return -a[0], a[1]


def decimal_rescale(a: SV, factor: int) -> SV:
    """Divide scaled-int by 10**k after decimal*decimal multiply."""
    return a[0] // factor, a[1]


# ---------------------------------------------------------------------------
# comparison (NULL if either NULL)
# ---------------------------------------------------------------------------

def _cmp(op: Callable) -> Callable[[SV, SV], SV]:
    def f(a: SV, b: SV) -> SV:
        return op(a[0], b[0]), _both(a[1], b[1])
    return f


eq = _cmp(torch.eq)
ne = _cmp(torch.ne)
lt = _cmp(torch.lt)
le = _cmp(torch.le)
gt = _cmp(torch.gt)
ge = _cmp(torch.ge)


def between(x: SV, lo: SV, hi: SV) -> SV:
    v = torch.logical_and(x[0] >= lo[0], x[0] <= hi[0])
    return v, _both(x[1], _both(lo[1], hi[1]))


# past this many values an IN list is one membership test, not an OR
# of equals (a subquery's inlined result can hold thousands)
IN_LIST_ISIN = 16


def in_list(x: SV, values) -> SV:
    """x IN (v1, v2, ...) with a constant list, in SQL's three-valued
    logic: TRUE on a match, else NULL when the list holds a NULL (None),
    else FALSE; NULL for a NULL x. The test is an OR of equals, or one
    torch.isin for a long list (the same equalities). The reference
    ignores a NULL in the list (``x NOT IN (5, NULL)`` is TRUE there
    for x = 7); this follows SQL."""
    d = x[0]
    has_null = any(v is None for v in values)
    values = [v for v in values if v is not None]
    if len(values) > IN_LIST_ISIN:
        if d.dtype == torch.bool:
            d = d.to(torch.int32)
        test = torch.tensor(values, device=d.device)
        if test.is_floating_point() != d.is_floating_point():
            test, d = test.to(torch.float64), d.to(torch.float64)
        acc = torch.isin(d, test.to(d.dtype))
    else:
        acc = torch.zeros_like(d, dtype=torch.bool)
        for v in values:
            acc = torch.logical_or(acc, d == v)
    if has_null:
        return acc, torch.logical_and(x[1], acc)
    return acc, x[1]


# ---------------------------------------------------------------------------
# boolean logic (Kleene)
# ---------------------------------------------------------------------------

def and_(a: SV, b: SV) -> SV:
    av, am = a
    bv, bm = b
    # value: NULL operands act as "unknown true" so a definite FALSE wins
    val = torch.logical_and(torch.where(am, av, True),
                            torch.where(bm, bv, True))
    false_a = torch.logical_and(am, torch.logical_not(av))
    false_b = torch.logical_and(bm, torch.logical_not(bv))
    known = torch.logical_or(torch.logical_or(false_a, false_b),
                             _both(am, bm))
    return val, known


def or_(a: SV, b: SV) -> SV:
    av, am = a
    bv, bm = b
    val = torch.logical_or(torch.where(am, av, False),
                           torch.where(bm, bv, False))
    true_a = torch.logical_and(am, av)
    true_b = torch.logical_and(bm, bv)
    known = torch.logical_or(torch.logical_or(true_a, true_b),
                             _both(am, bm))
    return val, known


def not_(a: SV) -> SV:
    return torch.logical_not(a[0]), a[1]


def is_null(a: SV) -> SV:
    return torch.logical_not(a[1]), torch.ones_like(a[1])


def is_not_null(a: SV) -> SV:
    return a[1], torch.ones_like(a[1])


def coalesce(*args: SV) -> SV:
    out_v, out_m = args[-1]
    for v, m in reversed(args[:-1]):
        out_v = torch.where(m, v, out_v)
        out_m = torch.logical_or(m, out_m)
    return out_v, out_m


def case_when(whens: list[tuple[SV, SV]], else_: SV) -> SV:
    """CASE WHEN c1 THEN v1 ... ELSE e END as a right-fold of where()
    (the reference's caseOp shuttles selection vectors, colexec/case.go).
    """
    out_v, out_m = else_
    for cond, val in reversed(whens):
        cv = torch.logical_and(cond[0], cond[1])  # NULL cond = not taken
        out_v = torch.where(cv, val[0], out_v)
        out_m = torch.where(cv, val[1], out_m)
    return out_v, out_m


# ---------------------------------------------------------------------------
# calendar (EXTRACT on date columns; dates are int days since epoch)
# ---------------------------------------------------------------------------

def days_to_ymd(days):
    """Civil-from-days (Hinnant's algorithm) in integer tensor ops."""
    z = days.to(torch.int64) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 - 12 * (mp // 10)
    y = y + (m <= 2).to(torch.int64)
    return y, m, d


def ymd_to_days(y, m, d):
    """Days-from-civil (Hinnant), the inverse of days_to_ymd."""
    y = y - (m <= 2).to(torch.int64)
    era = torch.div(y, 400, rounding_mode="floor")
    yoe = y - era * 400
    mp = (m + 9) % 12
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def date_trunc_days(part: str, days):
    """date_trunc on day-number dates (year/quarter/month/week)."""
    days = days.to(torch.int64)
    if part == "week":
        # 1970-01-01 was a Thursday; ISO weeks start Monday
        return days - (days + 3) % 7
    y, m, _d = days_to_ymd(days)
    one = torch.ones_like(y)
    if part == "year":
        return ymd_to_days(y, one, one)
    if part == "quarter":
        return ymd_to_days(y, ((m - 1) // 3) * 3 + 1, one)
    if part == "month":
        return ymd_to_days(y, m, one)
    return days  # day and below: identity on DATE


def date_trunc_micros(part: str, micros):
    """date_trunc on microsecond timestamps."""
    micros = micros.to(torch.int64)
    if part == "hour":
        return micros - micros % 3_600_000_000
    if part == "minute":
        return micros - micros % 60_000_000
    if part == "second":
        return micros - micros % 1_000_000
    days = torch.div(micros, 86_400_000_000, rounding_mode="floor")
    if part == "day":
        return days * 86_400_000_000
    return date_trunc_days(part, days) * 86_400_000_000


def extract_part(part: str, data, family: str):
    """EXTRACT(part FROM date/timestamp)."""
    if family == "timestamp":
        micros = data.to(torch.int64)
        days = torch.div(micros, 86_400_000_000, rounding_mode="floor")
        rem = micros - days * 86_400_000_000
        if part == "hour":
            return rem // 3_600_000_000
        if part == "minute":
            return rem // 60_000_000 % 60
        if part == "second":
            return rem // 1_000_000 % 60
        data = days
    data = data.to(torch.int64)

    def _jan1_days(y):
        # days from epoch to Jan 1 of year y (1970-01-01 = day 0)
        leaps = (y - 1) // 4 - (y - 1) // 100 + (y - 1) // 400
        return (y - 1970) * 365 + leaps - 477

    if part == "dow":
        return (data + 4) % 7  # pg: 0 = Sunday; day 0 was a Thursday
    if part == "isodow":
        return (data + 3) % 7 + 1  # 1 = Monday
    if part == "week":
        # ISO week = week number of this date's Thursday
        thursday = data + 4 - ((data + 3) % 7 + 1)
        ty, _, _ = days_to_ymd(thursday)
        return (thursday - _jan1_days(ty)) // 7 + 1
    y, m, d = days_to_ymd(data)
    if part == "year":
        return y
    if part == "month":
        return m
    if part == "day":
        return d
    if part == "quarter":
        return (m - 1) // 3 + 1
    if part == "doy":
        return data - _jan1_days(y) + 1
    raise ValueError(f"EXTRACT({part}) unsupported")
