"""Set operations, table-free clauses and generate_series through the
port's Engine against the JAX Engine.

Both engines get the same small tables by the same SQL (tests/
test_setops.py's ``a`` and ``b``, plus NULLs, FLOAT8 -0.0 beside 0.0,
and an INT/DECIMAL pair), and run the same statements: UNION, INTERSECT and
EXCEPT with and without ALL, chained, with ORDER BY (NULLS FIRST/LAST)
and LIMIT, over STRING columns, unifying INT with DECIMAL, and nested in
a derived table, a CTE, an IN subquery and WITH over a set operation;
INSERT ... SELECT ... UNION; a prepared set operation run again after a
write. Rows must be equal in order (every statement has an ORDER BY, or
one row); the errors carry the reference's text.

Table-free SELECTs: ORDER BY and LIMIT, generate_series in the select
list and in FROM, and unnest, against the reference. Where the
reference ignores a clause (it returns one row for ``SELECT 1 WHERE
1 = 0``, and drops a HAVING, LIMIT 0 or OFFSET) the port gives SQL's
answer, held to a hand oracle.
"""

import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.exec.session import EngineError
from tests.test_torch_groupagg_large import reference_modules

SETUP = (
    "CREATE TABLE a (x INT, s STRING)",
    "CREATE TABLE b (x INT, s STRING)",
    "INSERT INTO a VALUES (1,'p'),(2,'q'),(2,'q'),(3,'r')",
    "INSERT INTO b VALUES (2,'q'),(3,'r'),(4,'s')",
    "CREATE TABLE n1 (k INT PRIMARY KEY, v INT, f FLOAT, d DECIMAL(8,2))",
    "CREATE TABLE n2 (k INT PRIMARY KEY, v INT, f FLOAT)",
    "INSERT INTO n1 VALUES (1, 10, 1.5, 2.25), (2, NULL, -0.0, 1.00), "
    "(3, 5, 0.0, NULL), (4, NULL, NULL, 3.50)",
    "INSERT INTO n2 VALUES (1, NULL, 0.0), (2, 10, 2.5), (3, 7, NULL), "
    "(4, NULL, 1.5)",
)

QUERIES = {
    "union": "SELECT x FROM a UNION SELECT x FROM b ORDER BY x",
    "union_all": "SELECT x FROM a UNION ALL SELECT x FROM b ORDER BY x",
    "intersect": "SELECT x FROM a INTERSECT SELECT x FROM b ORDER BY x",
    "intersect_all": ("SELECT x FROM a INTERSECT ALL SELECT x FROM a "
                      "ORDER BY x"),
    "except": "SELECT x FROM a EXCEPT SELECT x FROM b ORDER BY x",
    "except_all": "SELECT x FROM a EXCEPT ALL SELECT x FROM b ORDER BY x",
    "chained": ("SELECT x FROM a UNION SELECT x FROM b "
                "UNION SELECT 99 AS x FROM b ORDER BY x DESC LIMIT 3"),
    "offset": ("SELECT x FROM a UNION ALL SELECT x FROM b ORDER BY x "
               "LIMIT 3 OFFSET 2"),
    "strings": "SELECT s FROM a UNION SELECT s FROM b ORDER BY s",
    "two_cols": ("SELECT x, s FROM a EXCEPT ALL SELECT x, s FROM b "
                 "ORDER BY x, s"),
    # NULL rows are equal in the merge
    "null_union": "SELECT v FROM n1 UNION SELECT v FROM n2 ORDER BY v",
    "null_intersect": ("SELECT v FROM n1 INTERSECT SELECT v FROM n2 "
                       "ORDER BY v"),
    "null_except_all": ("SELECT v FROM n1 EXCEPT ALL SELECT v FROM n2 "
                        "ORDER BY v"),
    "nulls_first": ("SELECT v FROM n1 UNION ALL SELECT v FROM n2 "
                    "ORDER BY v NULLS FIRST"),
    "desc_nulls_last": ("SELECT v FROM n1 UNION ALL SELECT v FROM n2 "
                        "ORDER BY v DESC NULLS LAST"),
    # FLOAT8 -0.0 equals 0.0 in the merge (Python float equality)
    "float_zeros": "SELECT f FROM n1 UNION SELECT f FROM n2 ORDER BY f",
    "float_intersect": ("SELECT f FROM n1 INTERSECT SELECT f FROM n2 "
                        "ORDER BY f"),
    # INT with DECIMAL unifies to DECIMAL
    "int_decimal": "SELECT v FROM n2 UNION SELECT d FROM n1 ORDER BY 1",
    # nested: a derived table, a CTE, an IN subquery, WITH over it
    "derived": ("SELECT count(*) FROM "
                "(SELECT x FROM a UNION SELECT x FROM b) u"),
    "derived_agg": ("SELECT s, count(*) AS c FROM (SELECT x, s FROM a "
                    "UNION ALL SELECT x, s FROM b) u GROUP BY s "
                    "ORDER BY s"),
    "cte": ("WITH u AS (SELECT x FROM a UNION SELECT x FROM b) "
            "SELECT max(x) FROM u"),
    "in_subquery": ("SELECT x FROM a WHERE x IN "
                    "(SELECT x FROM b UNION SELECT 1 AS y FROM b) "
                    "ORDER BY x"),
    "with_over_union": ("WITH c AS (SELECT x FROM a WHERE x > 1) "
                        "SELECT x FROM c UNION SELECT x FROM b ORDER BY x"),
}

TABLE_FREE = {
    "literal": "SELECT 1 + 2 AS three",
    "order_limit": "SELECT 7 AS v ORDER BY v LIMIT 5",
    "series": "SELECT generate_series(1, 6) AS g",
    "series_step": "SELECT generate_series(10, 1, -3) AS g",
    "series_order": ("SELECT generate_series(1, 9) AS g ORDER BY g DESC "
                     "LIMIT 4 OFFSET 1"),
    "series_from": "SELECT * FROM generate_series(2, 5) AS g",
    "series_from_agg": ("SELECT sum(g) AS s, count(*) AS c FROM "
                        "generate_series(1, 100) AS g"),
    "unnest": "SELECT unnest(ARRAY[3, 1, 2]) AS u ORDER BY u",
}


@pytest.fixture(scope="module")
def engines():
    """(reference rows per statement, the port's Engine)."""
    port = Engine(device="cpu")
    for stmt in SETUP:
        port.execute(stmt)
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        e = jeng.Engine()
        try:
            for stmt in SETUP:
                e.execute(stmt)
            out = {}
            for name, sql in [*QUERIES.items(), *TABLE_FREE.items()]:
                s = e.session()
                s.vars.set("distsql", "off")
                out[name] = e.execute(sql, session=s).rows
            for sql in ("SELECT 1 WHERE 1 = 0", "SELECT 1 OFFSET 1",
                        "SELECT 7 LIMIT 0"):
                out[sql] = e.execute(sql).rows
            errors = {}
            for sql in ("SELECT x, s FROM a UNION SELECT x FROM b",
                        "SELECT x FROM a UNION SELECT s FROM b"):
                try:
                    e.execute(sql)
                except Exception as ex:   # noqa: BLE001 - its text
                    errors[sql] = str(ex)
            out["errors"] = errors
        finally:
            e.close()
    return out, port


def _same(got, want):
    """Rows in order: floats within rel 1e-12, all else equal and of the
    same Python type."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            if isinstance(y, float):
                assert x == pytest.approx(y, rel=1e-12), (g, w)
            else:
                assert x == y and type(x) is type(y), (g, w)


@pytest.mark.parametrize("name", list(QUERIES))
def test_set_operation_matches_reference(engines, name):
    ref, port = engines
    _same(port.execute(QUERIES[name]).rows, ref[name])


@pytest.mark.parametrize("name", list(TABLE_FREE))
def test_table_free_matches_reference(engines, name):
    ref, port = engines
    _same(port.execute(TABLE_FREE[name]).rows, ref[name])


def test_mismatched_branches_rejected_with_reference_text(engines):
    ref, port = engines
    for sql, text in ref["errors"].items():
        with pytest.raises(EngineError) as ei:
            port.execute(sql)
        assert str(ei.value) == text


def test_table_free_where_gives_sql_answer(engines):
    """A table-free WHERE, HAVING, LIMIT 0 and OFFSET cut the one row;
    the reference ignores them (recorded as a kept divergence)."""
    ref, port = engines
    assert ref["SELECT 1 WHERE 1 = 0"] == [(1,)]
    assert ref["SELECT 1 OFFSET 1"] == [(1,)]
    assert ref["SELECT 7 LIMIT 0"] == [(7,)]
    assert port.execute("SELECT 7 LIMIT 0").rows == []
    assert port.execute("SELECT 1 WHERE 1 = 0").rows == []
    assert port.execute("SELECT 1 WHERE 1 = 1").rows == [(1,)]
    assert port.execute("SELECT 1 WHERE NULL").rows == []
    assert port.execute("SELECT 1 OFFSET 1").rows == []
    assert port.execute("SELECT 2 AS v GROUP BY 1 HAVING 1 > 2").rows == []
    assert port.execute("SELECT 2 AS v GROUP BY 1 HAVING 1 < 2").rows == \
        [(2,)]


def test_generate_series_errors(engines):
    _, port = engines
    with pytest.raises(EngineError, match="step cannot be 0"):
        port.execute("SELECT generate_series(1, 5, 0)")
    with pytest.raises(EngineError, match="only ORDER BY"):
        port.execute("SELECT generate_series(1, 5) AS g WHERE 1 = 1")


def test_insert_from_union_matches_reference():
    stmts = ("CREATE TABLE src1 (x INT)", "CREATE TABLE src2 (x INT)",
             "CREATE TABLE dst (x INT)", "INSERT INTO src1 VALUES (1),(2)",
             "INSERT INTO src2 VALUES (2),(3)",
             "INSERT INTO dst SELECT x FROM src1 UNION SELECT x FROM src2")
    q = "SELECT x FROM dst ORDER BY x"
    port = Engine(device="cpu")
    for s in stmts:
        port.execute(s)
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        e = jeng.Engine()
        try:
            for s in stmts:
                e.execute(s)
            want = e.execute(q).rows
        finally:
            e.close()
    assert port.execute(q).rows == want == [(1,), (2,), (3,)]


def test_prepared_set_operation_reruns_on_fresh_data():
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (a INT)")
    e.execute("INSERT INTO t VALUES (1),(2)")
    p = e.prepare("SELECT a FROM t UNION SELECT a + 10 FROM t ORDER BY 1")
    assert p.run().rows == [(1,), (2,), (11,), (12,)]
    assert p.run().rows == [(1,), (2,), (11,), (12,)]
    e.execute("INSERT INTO t VALUES (3)")
    assert p.run().rows == [(1,), (2,), (3,), (11,), (12,), (13,)]
