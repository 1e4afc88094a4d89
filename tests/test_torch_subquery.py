"""All 22 TPC-H queries, the SSB flights, subqueries, derived tables,
CTEs, DISTINCT aggregates, BOOL group keys and the partitioned hash
GROUP BY through the port's Engine against the JAX Engine.

The reference Engine loads every TPC-H table (lineitem capped at 20,000
rows, the others at sf 0.01), the SSB tables at sf 0.01 into a second
Engine, and small ``bt``/``bn`` tables with NULLs in INT, STRING and
BOOL columns. Its stores are carried into the port's
``Engine(device="cpu")`` through ``storage/transfer.py``, and both run
the same SQL. Rows must be equal in the reference's order: INT,
DECIMAL, STRING, DATE and BOOL values bit for bit, FLOAT8 values
(AVG, Q8's share) within rel 1e-12, because AVG may differ from the
reference in the last bit.

The port's vectorized numpy oracles (models/tpch.py ``ref_q2`` to
``ref_q22``, models/ssb.py ``ref_q1_1`` and ``ref_q2_1``) must equal
the reference's loop oracles exactly, and every oracle must equal the
port's rows: floats within rel 1e-9 (float64 sums against exact
DECIMAL sums), all else exactly.
"""

import re

import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.exec.session import EngineError
from cockroach_tpu_torch.models import ssb, tpch
from cockroach_tpu_torch.ops import sortkey as tsk
from cockroach_tpu_torch.sql.types import Family
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from tests.test_torch_engine import _store_arrays
from tests.test_torch_groupagg_large import reference_modules

ROWS = 20_000
MODES = ("auto", "on", "off")
FLOAT_REL = 1e-12
ORACLE_REL = 1e-9

# Q18 at a threshold this slice of lineitem reaches (300 selects none)
Q18_150 = tpch.Q18_TEMPLATE.format(threshold=150)

BT_DDL = "CREATE TABLE bt (g INT, b BOOL, v INT, s STRING)"
BN_DDL = "CREATE TABLE bn (k INT, w INT)"
BT_ROWS = ("INSERT INTO bt VALUES "
           "(1, true, 10, 'x'), (1, false, 10, 'y'), (1, NULL, 20, 'x'), "
           "(2, true, NULL, NULL), (2, true, 30, 'z'), (2, false, 30, 'z'), "
           "(3, NULL, 40, 'y'), (3, false, 40, NULL), (3, false, 50, 'x'), "
           "(4, NULL, NULL, NULL), (5, true, 10, 'w')")
BN_ROWS = ("INSERT INTO bn VALUES (1, 10), (1, 20), (3, NULL), (6, 30), "
           "(NULL, 40)")
EXTRA = {
    # BOOL group keys: the dense code of a BOOL key
    "bool_key": "SELECT b, count(*) AS n FROM bt GROUP BY b ORDER BY b",
    "bool_two_keys": ("SELECT g, b, count(*) AS n, sum(v) AS sv FROM bt "
                      "GROUP BY g, b ORDER BY g, b"),
    "bool_distinct": "SELECT DISTINCT b FROM bt ORDER BY b",
    # DISTINCT aggregates, grouped and not, over INT and STRING with NULLs
    "count_distinct": ("SELECT g, count(DISTINCT v) AS dv, "
                       "sum(DISTINCT v) AS sv, count(DISTINCT s) AS ds, "
                       "count(v) AS cv FROM bt GROUP BY g ORDER BY g"),
    "count_distinct_all": ("SELECT count(DISTINCT v) AS dv, "
                           "count(DISTINCT s) AS ds, "
                           "count(DISTINCT b) AS db FROM bt"),
    # NOT IN / IN over a subquery holding a NULL (three-valued IN)
    "not_in_null": ("SELECT g, v FROM bt WHERE v NOT IN "
                    "(SELECT w FROM bn) ORDER BY g, v"),
    "in_null": "SELECT g, v FROM bt WHERE v IN (SELECT w FROM bn) "
               "ORDER BY g, v",
    "not_in_no_null": ("SELECT g, v FROM bt WHERE v NOT IN "
                       "(SELECT w FROM bn WHERE w IS NOT NULL) "
                       "ORDER BY g, v"),
    # LEFT JOIN count(col) over no match is 0, not NULL (Q13's shape)
    "left_count": ("SELECT c, count(*) AS n FROM ("
                   "SELECT g, count(w) AS c FROM bt LEFT JOIN bn ON g = k "
                   "GROUP BY g) AS x GROUP BY c ORDER BY c"),
    # correlated EXISTS and scalar subqueries over NULLs
    "exists": ("SELECT g, v FROM bt WHERE EXISTS "
               "(SELECT * FROM bn WHERE bn.k = bt.g) ORDER BY g, v"),
    "not_exists": ("SELECT g, v FROM bt WHERE NOT EXISTS "
                   "(SELECT * FROM bn WHERE bn.k = bt.g) ORDER BY g, v"),
    "scalar_corr": ("SELECT g, v FROM bt WHERE v > "
                    "(SELECT avg(w) FROM bn WHERE bn.k = bt.g) "
                    "ORDER BY g, v"),
    # a CTE read twice, with a column list
    "cte_twice": ("WITH t (gg, tot) AS (SELECT g, sum(v) FROM bt GROUP BY g) "
                  "SELECT gg, tot FROM t WHERE tot >= "
                  "(SELECT max(tot) FROM t) - 30 ORDER BY gg"),
    "q18_150": Q18_150,
    # a subquery result long enough for the one-test IN list
    "long_not_in": ("SELECT l_suppkey, count(*) AS n FROM lineitem "
                    "WHERE l_suppkey NOT IN (SELECT s_suppkey FROM supplier "
                    "WHERE s_acctbal < 5000) GROUP BY l_suppkey "
                    "ORDER BY l_suppkey"),
}
DERIVED = ("SELECT nation, count(*) AS n FROM (SELECT n_name AS nation "
           "FROM nation, region WHERE n_regionkey = r_regionkey "
           "AND r_name = 'ASIA') AS x GROUP BY nation ORDER BY nation")


@pytest.fixture(scope="module")
def reference():
    """The reference's rows per query, its stores as arrays, and the
    SSB generator output."""
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch",
                           "cockroach_tpu.workload.ssb") as (jeng, jtpch,
                                                             jssb):
        e = jeng.Engine()
        s_e = jeng.Engine()
        try:
            jtpch.load(e, sf=0.01, rows=ROWS, tables=jtpch.ALL_TABLES)
            for stmt in (BT_DDL, BN_DDL, BT_ROWS, BN_ROWS):
                e.execute(stmt)
            data = jssb.load(s_e, sf=0.01)
            out = {}
            for q, sql in [*jtpch.QUERIES.items(), *EXTRA.items(),
                           ("derived", DERIVED)]:
                s = e.session()
                s.vars.set("distsql", "off")
                out[q] = e.execute(sql, session=s).rows
            for q, sql in jssb.QUERIES.items():
                s = s_e.session()
                s.vars.set("distsql", "off")
                out[q] = s_e.execute(sql, session=s).rows
            arrays = _store_arrays(e.store, {**jtpch.DDL, "bt": BT_DDL,
                                             "bn": BN_DDL})
            ssb_arrays = _store_arrays(s_e.store, jssb.DDL)
        finally:
            e.close()
            s_e.close()
    return out, arrays, ssb_arrays, data


@pytest.fixture(scope="module")
def port(reference):
    return Engine(device="cpu", store=store_from_arrays(reference[1]))


@pytest.fixture(scope="module")
def ssb_port(reference):
    return Engine(device="cpu", store=store_from_arrays(reference[2]))


def _run(eng, sql, mode="auto", **vars_):
    s = eng.session()
    eng.execute(f"SET sort_normalized = {mode}", s)
    for k, v in vars_.items():
        eng.execute(f"SET {k} = {v}", s)
    return eng.execute(sql, s)


def assert_rows(res, want, rel=FLOAT_REL):
    """The port's Result against the reference's rows, in order: FLOAT8
    columns within `rel`, every other value exactly (a DECIMAL decodes
    to the same float on both sides)."""
    got = res.rows
    assert len(got) == len(want), (got, want)
    floats = [t.family == Family.FLOAT for t in res.types]
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w, f in zip(g_row, w_row, floats):
            if f and g is not None and w is not None:
                assert g == pytest.approx(w, rel=rel), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


def assert_oracle(got, want, rel=ORACLE_REL):
    assert len(got) == len(want) > 0
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=rel), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


@pytest.mark.parametrize("query", list(tpch.QUERIES))
def test_tpch_query_matches_reference(reference, port, query):
    ref = reference[0]
    res = _run(port, tpch.QUERIES[query])
    assert_rows(res, ref[query])
    assert query == "q18" or len(res.rows) > 0


@pytest.mark.parametrize("mode", ("on", "off"))
@pytest.mark.parametrize("query", ["q2", "q9", "q13", "q16", "q20",
                                   "q21", "q22"])
def test_tpch_query_every_sort_mode(reference, port, query, mode):
    assert_rows(_run(port, tpch.QUERIES[query], mode),
                reference[0][query])


@pytest.mark.parametrize("query", list(EXTRA) + ["derived"])
def test_extra_query_matches_reference(reference, port, query):
    sql = DERIVED if query == "derived" else EXTRA[query]
    for mode in MODES:
        assert_rows(_run(port, sql, mode), reference[0][query])


def test_bool_keys_and_distinct_rows(reference, port):
    # (False, True, NULL), with the reference's counts
    assert _run(port, EXTRA["bool_key"]).rows == [(False, 4), (True, 4),
                                                  (None, 3)]
    assert _run(port, EXTRA["bool_distinct"]).rows == [(False,), (True,),
                                                       (None,)]
    assert [r[:2] for r in _run(port, EXTRA["bool_two_keys"]).rows] == [
        (1, False), (1, True), (1, None), (2, False), (2, True),
        (3, False), (3, None), (4, None), (5, True)]
    # DISTINCT over the packed lanes under auto/on, the successive
    # argsorts under off
    for mode, lanes in (("auto", 1), ("on", 1), ("off", 0)):
        tsk.NORMALIZED.reset()
        _run(port, EXTRA["count_distinct"], mode)
        assert tsk.NORMALIZED.value("distinct") == 3 * lanes


# the temps each TPC-H query materializes: CTEs and derived tables by
# their names, decorrelated EXISTS and scalar subqueries as __exists and
# __sc (whose numbers count up through the Engine's life)
TEMP_NAMES = {"q2": ["__sc"], "q4": ["__exists"], "q7": ["shipping"],
              "q8": ["all_nations"], "q9": ["profit"],
              "q13": ["c_orders"], "q15": ["revenue"], "q17": ["__sc"],
              "q20": ["__sc"], "q21": ["__exists", "__exists"],
              "q22": ["custsale", "__exists"]}


def test_derived_tables_and_ctes_materialize_temps(port):
    _run(port, tpch.Q7)
    temps = port.last_exec["temps"]
    assert len(temps) == 1 and temps[0][1] > 0
    assert temps[0][0].startswith("__cte_") and \
        temps[0][0].endswith("_shipping")
    # the temps are dropped and their device copies evicted
    assert not [t for t in port.store.tables if t.startswith("__cte_")]
    assert not [k for k in port._device_tables if k[0].startswith("__cte_")]
    _run(port, tpch.Q15)
    assert port.last_exec["subqueries"] == 1
    # every temp of these queries takes the columnar path, none the
    # decoded rows
    for q, names in TEMP_NAMES.items():
        _run(port, tpch.QUERIES[q])
        temps = port.last_exec["temps"]
        assert [re.fullmatch(r"__cte_[0-9a-f]+_d0_\d+_(\w*?)\d*", t[0])
                .group(1) for t in temps] == names, (q, temps)
        assert [t[2] for t in temps] == ["columnar"] * len(names), \
            (q, temps)


def test_decorrelated_grouping_partitions(reference, port):
    # Q20's decorrelated GROUP BY l_partkey, l_suppkey holds 2,434
    # groups: past half of 256 slots it ingests its partitions' columns
    res = _run(port, tpch.Q20, hash_group_capacity=256)
    assert res.rows == reference[0]["q20"]
    assert port.last_exec["all"]["partitioned"] == [32]


def test_sorted_derived_table_partitions_through_the_row_path(port):
    # a derived table whose hash GROUP BY overflows under ORDER BY ...
    # LIMIT: its columns cannot be ingested partition by partition, so
    # the temp takes the decoded-row path, which sorts on the host
    sql = ("SELECT count(*) AS n, sum(q) AS tq FROM (SELECT l_orderkey, "
           "l_suppkey, sum(l_quantity) AS q FROM lineitem "
           "GROUP BY l_orderkey, l_suppkey ORDER BY q DESC, l_orderkey, "
           "l_suppkey LIMIT 50) AS x")
    want = _run(port, sql).rows
    got = _run(port, sql, hash_group_capacity=256)
    assert got.rows == want and want[0][0] == 50
    assert port.last_exec["temps"][0][1:] == [50, "rows"]
    assert len(port.last_exec["all"]["partitioned"]) == 1


def test_hash_group_by_partitioned_with_order_limit(port):
    # 20,000 lineitem rows over (l_orderkey, l_suppkey) pairs: a hash
    # GROUP BY far past 256 slots, ORDER BY ... LIMIT applied on the
    # host after the partitions
    sql = ("SELECT l_orderkey, l_suppkey, sum(l_quantity) AS q, "
           "count(*) AS n FROM lineitem GROUP BY l_orderkey, l_suppkey "
           "ORDER BY q DESC, l_orderkey, l_suppkey LIMIT 25")
    want = _run(port, sql).rows
    assert port.last_exec["group_ids"] == 1
    assert port.last_exec["partitioned"] == []
    for mode in MODES:
        got = _run(port, sql, mode, hash_group_capacity=256)
        assert got.rows == want
        assert len(port.last_exec["partitioned"]) == 1
        assert port.last_exec["partitioned"][0] >= 64


@pytest.mark.parametrize("query", list(ssb.QUERIES))
def test_ssb_query_matches_reference(reference, ssb_port, query):
    ref, _, _, data = reference
    res = _run(ssb_port, ssb.QUERIES[query])
    assert res.rows == ref[query]
    want = getattr(ssb, "ref_" + query.replace(".", "_"))(
        data["lineorder"], data["dims"])
    assert_oracle(res.rows, [(want,)] if isinstance(want, int) else want)


def test_ssb_vectorized_oracles_equal_the_reference_loops(reference):
    from cockroach_tpu.workload import ssb as jssb
    data = reference[3]
    lo, dims = data["lineorder"], data["dims"]
    assert ssb.ref_q1_1(lo, dims) == jssb.ref_q1_1(lo, dims)
    assert ssb.ref_q2_1(lo, dims) == jssb.ref_q2_1(lo, dims)


def _tables(rows=ROWS):
    sf = 0.01
    return {"lineitem": tpch.gen_lineitem(sf, rows=rows),
            "orders": tpch.gen_orders(sf), "customer": tpch.gen_customer(sf),
            "supplier": tpch.gen_supplier(sf), "part": tpch.gen_part(sf),
            "partsupp": tpch.gen_partsupp(sf), "nation": tpch.gen_nation(),
            "region": tpch.gen_region()}


@pytest.mark.parametrize("query", list(tpch.ORACLE_ARGS))
def test_vectorized_oracle_equals_the_reference_loop(query):
    from cockroach_tpu.models import tpch as jtpch
    # 60,000 lineitem rows: orders with several late lines and several
    # suppliers, so Q21's EXISTS and NOT EXISTS both decide rows
    t = _tables(60_000)
    args = [t[n] for n in tpch.ORACLE_ARGS[query]]
    want = getattr(jtpch, f"ref_{query}")(*args)
    assert getattr(tpch, f"ref_{query}")(*args) == want
    if query == "q18":
        assert tpch.ref_q18(*args, threshold=150) == \
            jtpch.ref_q18(*args, threshold=150) != []


@pytest.mark.parametrize("query", list(tpch.ORACLE_ARGS))
def test_oracle_equals_the_port(port, query):
    got = _run(port, tpch.QUERIES[query]).rows
    want = tpch.oracle_rows(query, _tables())
    if query == "q18":
        assert got == want == []
        got = _run(port, Q18_150).rows
        t = _tables()
        want = tpch.ref_q18(t["lineitem"], t["orders"], t["customer"],
                            threshold=150)
    assert_oracle(got, want)


def test_set_operations_are_refused(port):
    """Set operations run (tests/test_torch_setops.py); one whose
    branches differ in their column count is refused, with the
    reference's text."""
    assert port.execute("SELECT g FROM bt UNION SELECT k FROM bn "
                        "ORDER BY g").rows[:3] == [(1,), (2,), (3,)]
    with pytest.raises(EngineError, match="same number of columns"):
        port.execute("SELECT g, v FROM bt UNION SELECT k FROM bn")


def test_wide_expansion_left_join():
    # 40 orders per customer: past the reference's K of 32, within 64
    # for a small probe side; Q13's shape, customers without orders
    # count 0
    import numpy as np
    e = Engine(device="cpu")
    e.execute("CREATE TABLE c (ck INT8 NOT NULL)")
    e.execute("CREATE TABLE o (ok INT8 NOT NULL, ock INT8 NOT NULL)")
    ts = e.clock.now()
    e.store.insert_columns("c", {"ck": np.arange(1, 51)}, ts)
    ock = np.repeat(np.arange(1, 41), np.arange(1, 41))
    e.store.insert_columns("o", {"ok": np.arange(len(ock)), "ock": ock}, ts)
    e.execute("ANALYZE c")
    e.execute("ANALYZE o")
    got = e.execute("SELECT cnt, count(*) AS n FROM (SELECT ck, count(ok) "
                    "AS cnt FROM c LEFT JOIN o ON ck = ock GROUP BY ck) "
                    "AS x GROUP BY cnt ORDER BY cnt").rows
    assert got == [(0, 10)] + [(k, 1) for k in range(1, 41)]
    assert e.last_exec["all"]["expansions"] == [40]
