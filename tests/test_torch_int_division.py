"""INT8 arithmetic of the port's expression lowering past float32's exact
range, held to the reference (JAX under x64).

torch promotes an int64 tensor to float32 where JAX under x64 gives
float64: ``torch.where(mask, int64, 1.0)``, ``int64 / int64`` and
``int64 * 1.5`` are float32. The port's ``div`` (exec/expr.py, the
lowering of SQL's ``div`` and of ``date_bin``) had the first form, so
every ``date_bin`` over a real timestamp (micros near 2^50) came back
seconds off. It now divides INT8 operands exactly in int64 (truncating)
and FLOAT8 ones in float64.

Every other site of exec/expr.py and ops/kernels.py that divides, or
masks with a float literal, is reached here over INT8 values near 2^40
(past 2^24, inside float64's exact range) and equals the reference:
``a / b`` and ``a % b`` (``ops/kernels.py`` div and mod), the unary
and binary float builtins,
``div()``, ``log(b, x)``, ``width_bucket``, ``round(x, n)``, the casts,
and AVG over INT8. Past 2^53 the port's int64 ``div`` is exact where the
reference's float64 quotient rounds: a hand oracle holds that.
"""

import math

import pytest
import torch

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.exec.expr import div_trunc
from tests.test_torch_groupagg_large import reference_modules

BIG = 1 << 40
SETUP = (
    "CREATE TABLE t (k INT PRIMARY KEY, a INT, b INT, ts TIMESTAMP)",
    f"INSERT INTO t VALUES (1, {BIG + 12345}, 7, '2024-03-05 10:37:11'), "
    f"(2, {-BIG - 99}, 3, '2024-03-05 11:02:00'), "
    f"(3, {(1 << 33) + 1}, {-(1 << 20) - 3}, '1969-12-31 23:59:59'), "
    f"(4, {(1 << 25) + 7}, 0, NULL), (5, NULL, 5, '2099-12-31 23:30:00'), "
    f"(6, {BIG * 3 + 1}, {(1 << 26) + 1}, '2024-02-29 00:00:01')",
)
QUERIES = (
    "SELECT k, date_bin(3600000000, ts, 0) FROM t ORDER BY k",
    "SELECT k, date_bin(86400000000, ts, 1000000) FROM t ORDER BY k",
    "SELECT k, div(a, b) FROM t ORDER BY k",
    "SELECT k, a / b, a % b FROM t ORDER BY k",
    "SELECT k, sqrt(a), ln(a), cbrt(a), abs(a), floor(a), power(a, 2) "
    "FROM t ORDER BY k",
    "SELECT k, log(2, a), width_bucket(a, 0, 4398046511104, 7) "
    "FROM t ORDER BY k",
    "SELECT k, round(a, 2), CAST(a AS FLOAT), a * 3 FROM t ORDER BY k",
    "SELECT avg(a), sum(a), avg(b) FROM t",
)


@pytest.fixture(scope="module")
def reference():
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        e = jeng.Engine()
        try:
            for stmt in SETUP:
                e.execute(stmt)
            s = e.session()
            s.vars.set("distsql", "off")
            return {q: e.execute(q, session=s).rows for q in QUERIES}
        finally:
            e.close()


@pytest.fixture(scope="module")
def port():
    e = Engine(device="cpu")
    for stmt in SETUP:
        e.execute(stmt)
    yield e
    e.close()


def _canon(rows):
    """Rows with NaN made comparable (sqrt and ln of a negative)."""
    return [tuple("NaN" if isinstance(v, float) and math.isnan(v) else v
                  for v in r) for r in rows]


@pytest.mark.parametrize("sql", QUERIES)
def test_int8_past_float32_equals_reference(port, reference, sql):
    assert _canon(port.execute(sql).rows) == _canon(reference[sql])


def test_date_bin_is_on_the_hour():
    """builtins_datetime3.td's case: on the parent the bins came back at
    10:00:04.356096 and 11:00:28.234752."""
    e = Engine(device="cpu")
    for stmt in SETUP:
        e.execute(stmt)
    rows = e.execute(
        "SELECT k, date_bin(3600000000, ts, 0) FROM t ORDER BY k").rows
    assert [(r[1].minute, r[1].second, r[1].microsecond)
            for r in rows if r[1] is not None] == [(0, 0, 0)] * 5
    e.close()


def test_int8_div_is_exact_past_2_53():
    """``div_trunc`` over int64 (as ``date_bin`` lowers) against Python's
    truncating integer division, at magnitudes where a float64 quotient
    rounds; a zero divisor is not defined (NULL)."""
    a = [(1 << 62) - 1, -(1 << 62) + 3, (1 << 53) + 1, 9, -9, 5]
    b = [3, 7, -2, 0, 4, -(1 << 40)]
    q, ok = div_trunc(torch.tensor(a, dtype=torch.int64),
                      torch.tensor(b, dtype=torch.int64))
    assert q.dtype == torch.int64
    want = [abs(x) // abs(y) * (1 if (x < 0) == (y < 0) else -1)
            if y else None for x, y in zip(a, b)]
    assert [int(x) if o else None
            for x, o in zip(q.tolist(), ok.tolist())] == want
    f64 = div_trunc(torch.tensor([7.5, -7.5], dtype=torch.float64),
                    torch.tensor([2.0, 2.0], dtype=torch.float64))[0]
    assert f64.dtype == torch.float64 and f64.tolist() == [3.0, -3.0]
