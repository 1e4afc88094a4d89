"""Faults of the port against SQL, repaired, each held to its oracle.

- An IN list holding a NULL follows SQL's three-valued logic over INT,
  FLOAT8 and STRING columns: a match is TRUE, a non-match NULL, so
  ``WHERE x NOT IN (5, NULL)`` returns no row. Hand oracles; the
  reference ignores the NULL (``7 NOT IN (5, NULL)`` is TRUE there),
  which the last test records.
- ``width_bucket`` equals the reference for ascending bounds; for
  descending bounds it gives PostgreSQL's mirror (hand oracle), and a
  count below 1 is PostgreSQL's error, an EngineError.
- ``coalesce`` and ``nullif`` over a STRING column with a STRING literal
  answer (hand oracles), through ``execute`` and through a DistSQL flow:
  the literal is encoded into the result's dictionary. The reference
  passes the literal's text to the device and raises a TypeError.
"""

import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.exec.session import EngineError
from tests.test_torch_groupagg_large import reference_modules

SETUP = (
    "CREATE TABLE t (k INT PRIMARY KEY, i INT, f FLOAT, s STRING)",
    "INSERT INTO t VALUES (1, 5, 1.5, 'a'), (2, 7, -1.0, 'b'), "
    "(3, NULL, NULL, NULL), (4, 3, 0.0, 'c'), (5, 9, 11.0, 'a'), "
    "(6, 5, 10.0, 'b')",
)
WB_ASC = "SELECT k, width_bucket(f, 0.0, 10.0, 5) FROM t ORDER BY k"
IN_NULL_REF = "SELECT k FROM t WHERE i NOT IN (5, NULL) ORDER BY k"


@pytest.fixture(scope="module")
def port():
    e = Engine(device="cpu")
    for stmt in SETUP:
        e.execute(stmt)
    return e


@pytest.fixture(scope="module")
def reference():
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        e = jeng.Engine()
        try:
            for stmt in SETUP:
                e.execute(stmt)
            s = e.session()
            s.vars.set("distsql", "off")
            return {sql: e.execute(sql, session=s).rows
                    for sql in (WB_ASC, IN_NULL_REF)}
        finally:
            e.close()


def _col(port, sql):
    return [r[1] for r in port.execute(sql).rows]


# (column, list, IN per row k = 1..6, hand-computed)
IN_CASES = [
    ("i", "(5, NULL)", [True, None, None, None, None, True]),
    ("i", "(NULL)", [None] * 6),
    ("f", "(1.5, NULL)", [True, None, None, None, None, None]),
    ("f", "(NULL, 10.0, 0.0)", [None, None, None, True, None, True]),
    ("s", "('a', NULL)", [True, None, None, None, True, None]),
    ("s", "(NULL, 'zz')", [None] * 6),
]


@pytest.mark.parametrize("col,lst,want", IN_CASES)
def test_in_list_with_null_is_three_valued(port, col, lst, want):
    assert _col(port, f"SELECT k, {col} IN {lst} FROM t ORDER BY k") == want
    negated = [None if w is None else not w for w in want]
    assert _col(port, f"SELECT k, {col} NOT IN {lst} FROM t "
                      "ORDER BY k") == negated
    # WHERE keeps TRUE rows only
    assert [r[0] for r in port.execute(
        f"SELECT k FROM t WHERE {col} NOT IN {lst} ORDER BY k").rows] == \
        [k for k, n in zip(range(1, 7), negated) if n is True]


def test_in_list_long_with_null(port):
    """Past IN_LIST_ISIN values the test is one torch.isin: the NULL
    still turns a non-match to NULL."""
    lst = ", ".join(str(v) for v in range(100, 130)) + ", 5, NULL"
    assert _col(port, f"SELECT k, i IN ({lst}) FROM t ORDER BY k") == \
        [True, None, None, None, None, True]


def test_width_bucket_ascending_matches_reference(port, reference):
    got = port.execute(WB_ASC).rows
    assert got == reference[WB_ASC]
    assert [r[1] for r in got] == [1, 0, None, 1, 6, 6]


def test_width_bucket_descending_is_postgres(port):
    # PostgreSQL: lo > hi counts down; x > lo is 0, x <= hi is n + 1
    assert _col(port, "SELECT k, width_bucket(f, 10.0, 0.0, 5) FROM t "
                      "ORDER BY k") == [5, 6, None, 6, 0, 1]
    # equal bounds: NULL, as in the reference
    assert _col(port, "SELECT k, width_bucket(f, 1.0, 1.0, 5) FROM t "
                      "ORDER BY k") == [None] * 6


@pytest.mark.parametrize("count", [0, -2])
def test_width_bucket_count_below_one_raises(port, count):
    with pytest.raises(EngineError, match="count must be greater"):
        port.execute(f"SELECT k, width_bucket(f, 0.0, 10.0, {count}) "
                     "FROM t")


def test_reference_ignores_a_null_in_the_list(port, reference):
    """The kept divergence: the reference drops the NULL and returns the
    rows SQL does not."""
    assert reference[IN_NULL_REF] == [(2,), (4,), (5,)]
    assert port.execute(IN_NULL_REF).rows == []


# (statement, hand oracle) over t's s = a, b, NULL, c, a, b (k = 1..6)
STRING_LITERALS = [
    ("SELECT k, coalesce(s, 'none') FROM t ORDER BY k",
     [(1, "a"), (2, "b"), (3, "none"), (4, "c"), (5, "a"), (6, "b")]),
    ("SELECT k, nullif(s, 'a') FROM t ORDER BY k",
     [(1, None), (2, "b"), (3, None), (4, "c"), (5, None), (6, "b")]),
    ("SELECT coalesce(s, 'none') AS g, count(*) FROM t "
     "GROUP BY coalesce(s, 'none') ORDER BY g",
     [("a", 2), ("b", 2), ("c", 1), ("none", 1)]),
]


@pytest.mark.parametrize("sql,want", STRING_LITERALS,
                         ids=["coalesce", "nullif", "coalesce_group_key"])
def test_string_literal_in_coalesce_and_nullif(port, sql, want):
    assert port.execute(sql).rows == want
    # and through a flow: t's rows split over two data nodes
    from cockroach_tpu_torch.distsql.node import DistSQLNode, Gateway
    from cockroach_tpu_torch.kvserver.transport import LocalTransport
    transport = LocalTransport()
    nodes = []
    for i, keys in enumerate([(), (1, 2, 3), (4, 5, 6)]):
        e = Engine(device="cpu")
        e.execute(SETUP[0].replace("i INT, f FLOAT, ", ""))
        rows = [r for r in ("(1, 'a')", "(2, 'b')", "(3, NULL)", "(4, 'c')",
                            "(5, 'a')", "(6, 'b')")
                if int(r[1]) in keys]
        if rows:
            e.execute("INSERT INTO t VALUES " + ", ".join(rows))
        nodes.append(DistSQLNode(i, e, transport))
    assert Gateway(nodes[0], [1, 2]).run(sql).rows == want
