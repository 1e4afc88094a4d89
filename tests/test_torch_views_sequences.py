"""Views and sequences through the port against the JAX package.

The reference's tests/test_views_sequences.py cases that need neither
EXPLAIN nor SHOW (other than SHOW SEQUENCES), nor what the port has not
ported (CREATE INDEX, generate_series), run statement by statement
through ``Engine(device="cpu")`` and the reference Engine: every
statement's rows, row count and tag, or its error's type and text, must
be equal. TPC-H Q15 in the specification's view form at sf 0.01 equals
its CTE form and the reference's.
"""

import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.models import tpch
from tests.test_torch_groupagg_large import reference_modules
from tests.test_torch_oltp_lane import Pair

ROWS = 20_000


@pytest.fixture(scope="module")
def ref():
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch") as mods:
        yield mods


@pytest.fixture
def pair(ref):
    p = Pair(ref)
    p.run("CREATE TABLE t (a INT PRIMARY KEY, b INT, s STRING)")
    p.run("INSERT INTO t VALUES (1,2,'x'),(2,3,'y'),(3,3,'z')")
    yield p
    p.close()


def _err(got, text):
    assert got[0] == "err" and text in got[2], got


def test_views_basic_and_join(pair):
    pair.run("CREATE VIEW v AS SELECT a, b FROM t WHERE b > 2")
    assert sorted(pair.rows("SELECT * FROM v")) == [(2, 3), (3, 3)]
    assert sorted(pair.rows("SELECT v.a FROM v JOIN t ON v.a = t.a")) == [
        (2,), (3,)]


def test_nested_views_with_renames(pair):
    pair.run("CREATE VIEW v AS SELECT a, b FROM t WHERE b > 2")
    pair.run("CREATE VIEW v2 (x, y) AS SELECT a, b FROM v")
    assert sorted(pair.rows("SELECT x FROM v2 WHERE y = 3")) == [(2,), (3,)]


def test_view_sees_new_rows(pair):
    pair.run("CREATE VIEW v AS SELECT a FROM t WHERE b = 3")
    pair.run("INSERT INTO t VALUES (4,3,'w')")
    assert sorted(pair.rows("SELECT * FROM v")) == [(2,), (3,), (4,)]


def test_aggregating_view(pair):
    pair.run("CREATE VIEW agg AS SELECT b, count(*) AS c FROM t GROUP BY b")
    assert sorted(pair.rows("SELECT * FROM agg")) == [(2, 1), (3, 2)]


def test_view_guards(pair):
    pair.run("CREATE VIEW v AS SELECT a FROM t")
    _err(pair.run("DELETE FROM v"), "not modifiable")
    _err(pair.run("UPDATE v SET a = 1"), "not modifiable")
    _err(pair.run("DROP TABLE v"), "use DROP VIEW")
    _err(pair.run("CREATE VIEW v AS SELECT 1"), "already exists")
    _err(pair.run("CREATE TABLE v (k INT PRIMARY KEY)"), "already exists")
    assert pair.run("CREATE VIEW bad AS SELECT nope FROM t")[0] == "err"
    pair.run("DROP VIEW v")
    assert pair.run("SELECT * FROM v")[0] == "err"
    _err(pair.run("DROP VIEW v"), "does not exist")
    pair.run("DROP VIEW IF EXISTS v")


def test_view_cache_survives_a_reset(pair):
    pair.run("CREATE VIEW v AS SELECT a FROM t WHERE b = 2")
    pair.port._view_defs = None     # a fresh cache reads the catalog
    pair.ref._view_defs = None
    assert pair.rows("SELECT * FROM v") == [(1,)]


def test_cte_shadows_view(pair):
    pair.run("CREATE VIEW v AS SELECT a FROM t")
    assert pair.rows("WITH v AS (SELECT 99 AS x) SELECT * FROM v") == [
        (99,)]


def test_prepare_view(pair):
    pair.run("CREATE VIEW v AS SELECT a FROM t WHERE b = 2")
    assert pair.port.prepare("SELECT * FROM v").run().rows == \
        pair.ref.prepare("SELECT * FROM v").run().rows == [(1,)]


def test_dependent_views_guard_drops(pair):
    pair.run("CREATE VIEW v AS SELECT a FROM t")
    pair.run("CREATE VIEW v2 AS SELECT a FROM v")
    _err(pair.run("DROP TABLE t"), "depend")
    _err(pair.run("DROP VIEW v"), "depend")
    pair.run("DROP VIEW v2")
    pair.run("DROP VIEW v")
    pair.run("DROP TABLE t")


def test_nextval_currval_setval(pair):
    pair.run("CREATE SEQUENCE sq START 5 INCREMENT 2")
    pair.session("s")
    assert [pair.rows("SELECT nextval('sq')", "s")[0][0]
            for _ in range(3)] == [5, 7, 9]
    assert pair.rows("SELECT currval('sq')", "s") == [(9,)]
    _err(pair.run("SELECT currval('sq')"), "not yet defined")
    pair.run("SELECT setval('sq', 100)", "s")
    assert pair.rows("SELECT nextval('sq')", "s") == [(102,)]
    assert pair.rows("SELECT setval('sq', -5)") == [(-5,)]
    _err(pair.run("SELECT setval('sq', 'abc')"), "integer")


def test_insert_per_row_values(pair):
    pair.run("CREATE SEQUENCE ids")
    pair.run("CREATE TABLE u (a INT PRIMARY KEY, s STRING)")
    pair.run("INSERT INTO u VALUES (nextval('ids'),'p'),(nextval('ids'),'q')")
    assert sorted(pair.rows("SELECT a FROM u")) == [(1,), (2,)]


def test_nextval_not_rolled_back(pair):
    pair.run("CREATE SEQUENCE sq")
    pair.session("s")
    pair.run("BEGIN", "s")
    assert pair.rows("SELECT nextval('sq')", "s") == [(1,)]
    pair.run("ROLLBACK", "s")
    assert pair.rows("SELECT nextval('sq')") == [(2,)]


def test_sequence_ddl_guards(pair):
    pair.run("CREATE SEQUENCE sq")
    _err(pair.run("CREATE SEQUENCE sq"), "already exists")
    pair.run("CREATE SEQUENCE IF NOT EXISTS sq")
    assert pair.rows("SHOW SEQUENCES") == [("sq", 1, 1, None)]
    pair.run("DROP SEQUENCE sq")
    _err(pair.run("SELECT nextval('sq')"), "does not exist")
    _err(pair.run("DROP SEQUENCE sq"), "does not exist")
    pair.run("DROP SEQUENCE IF EXISTS sq")


def test_update_with_nextval(pair):
    pair.run("CREATE SEQUENCE sq")
    pair.run("UPDATE t SET b = nextval('sq') WHERE a = 1")
    assert pair.rows("SELECT b FROM t WHERE a = 1") == [(1,)]
    pair.run("UPDATE t SET b = nextval('sq')")
    assert sorted(pair.rows("SELECT b FROM t")) == [(2,), (3,), (4,)]


def test_nextval_in_expressions_rejected(pair):
    pair.run("CREATE SEQUENCE sq")
    _err(pair.run("UPDATE t SET b = nextval('sq') + 1"), "nextval")
    pair.run("CREATE TABLE u (a INT PRIMARY KEY)")
    _err(pair.run("INSERT INTO u SELECT nextval('sq') FROM t"), "nextval")


def test_default_nextval_over_insert_select(pair):
    """A DEFAULT nextval column over INSERT ... SELECT: dense, unique
    keys; a value drawn in a rolled-back txn is not handed out again."""
    pair.run("CREATE SEQUENCE ids")
    pair.run("CREATE TABLE u (k INT PRIMARY KEY DEFAULT nextval('ids'), "
             "v INT)")
    pair.session("s")
    pair.run("BEGIN", "s")
    pair.run("INSERT INTO u (v) VALUES (0)", "s")
    pair.run("ROLLBACK", "s")
    pair.run("INSERT INTO u (v) SELECT a FROM t")
    pair.run("INSERT INTO u (v) VALUES (9)")
    assert pair.rows("SELECT k, v FROM u ORDER BY k") == [
        (2, 1), (3, 2), (4, 3), (5, 9)]
    assert pair.port.lane_hits == 0     # a DEFAULT keeps u off the lane


def test_truncate_missing(pair):
    _err(pair.run("TRUNCATE TABLE nope"), "does not exist")


def test_q15_view_form_equals_cte_form_and_reference(ref):
    jeng, jtpch = ref
    je = jeng.Engine()
    try:
        jtpch.load(je, sf=0.01, rows=ROWS, tables=("lineitem", "supplier"))
        create, query, drop = tpch.Q15_VIEW
        je.execute(create)
        want = je.execute(query).rows
        je.execute(drop)
        want_cte = je.execute(tpch.Q15).rows
    finally:
        je.close()
    e = Engine(device="cpu")
    tpch.load(e, sf=0.01, rows=ROWS, tables=("lineitem", "supplier"))
    e.execute(create)
    got = e.execute(query)
    # the view materializes once, though the query names it twice
    assert len(e.last_exec["temps"]) == 1
    e.execute(drop)
    assert got.rows == e.execute(tpch.Q15).rows == want == want_cte
    assert len(want) == 1
