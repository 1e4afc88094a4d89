"""Window functions of the port against the JAX package.

Each function of the port's ops/window.py runs beside the reference's
ops/window.py on the same seeded inputs (numpy, seed per case) with
NULLs, ties, DESC keys, NaN and -0.0, under both sort paths (packed
lanes and successive argsorts): the sort permutation, partition and
peer starts are equal exactly, and every window value is equal exactly
(integer outputs, and float sums over the same sorted rows: the
cumulative sums add in the same order), the validity masks too.

Then every query of tests/test_window_functions.py, and queries over a
FLOAT/DECIMAL table holding NaN, -0.0 and NULLs, run through both
Engines, each loaded by the same SQL: rows equal as multisets (in order
where the query has ORDER BY), FLOAT8 within rel 1e-12, errors with
the same text. A window over a table past the device budget is
refused streaming by both engines' placement verdicts.
"""

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.ops import window as TW
from cockroach_tpu_torch.sql.types import Family
from tests.test_torch_groupagg_large import reference_modules

FLOAT_REL = 1e-12

EMP_DDL = "CREATE TABLE emp (dept STRING, name STRING, sal INT)"
EMP_ROWS = ("INSERT INTO emp VALUES "
            "('eng','a',100),('eng','b',200),('eng','c',200),"
            "('ops','d',50),('ops','e',70),('ops','f',NULL)")
WN_DDL = "CREATE TABLE wn (g STRING, v INT)"
WN_ROWS = ("INSERT INTO wn VALUES ('a',1),('a',2),('a',3),"
           "('a',4),('a',5),('b',10),('b',20)")
WN2_DDL = "CREATE TABLE wn2 (v INT)"
WN2_ROWS = "INSERT INTO wn2 VALUES (1),(2)"
P_DDL = "CREATE TABLE p (g INT, m DECIMAL(8,2))"
P_ROWS = "INSERT INTO p VALUES (1, 1.50), (1, 1.50), (1, 2.25), (2, 1.50)"
WF_DDL = "CREATE TABLE wf (g INT, x FLOAT, m DECIMAL(8,2), s STRING)"
WF_ROWS = ("INSERT INTO wf VALUES "
           "(1, 1.5, 2.25, 'x'), (1, -0.0, 1.00, 'y'), (1, 0.0, NULL, 'x'), "
           "(1, NULL, 3.50, NULL), (2, 2.5, 2.25, 'z'), (2, 2.5, 1.25, 'z'), "
           "(2, -1.0, 0.75, 'y'), (NULL, 7.0, 9.99, 'w'), "
           "(NULL, NULL, NULL, 'w'), (3, 4.0, 4.00, 'x')")

# every query of tests/test_window_functions.py, then the wf table's
QUERIES = {
    "row_number": "SELECT name, row_number() OVER (PARTITION BY dept "
                  "ORDER BY sal DESC) FROM emp",
    "rank_dense_rank": "SELECT name, rank() OVER (PARTITION BY dept "
                       "ORDER BY sal DESC), dense_rank() OVER "
                       "(PARTITION BY dept ORDER BY sal DESC) FROM emp",
    "partition_total": "SELECT name, sum(sal) OVER (PARTITION BY dept) "
                       "FROM emp",
    "running_sum": "SELECT name, sum(sal) OVER (PARTITION BY dept "
                   "ORDER BY sal) FROM emp",
    "running_count_avg_minmax": (
        "SELECT name, count(sal) OVER (PARTITION BY dept ORDER BY sal), "
        "avg(sal) OVER (PARTITION BY dept ORDER BY sal), "
        "min(sal) OVER (PARTITION BY dept ORDER BY sal), "
        "max(sal) OVER (PARTITION BY dept ORDER BY sal) FROM emp"),
    "count_star": "SELECT name, count(*) OVER (PARTITION BY dept) FROM emp",
    "whole_table": "SELECT name, sum(sal) OVER () FROM emp",
    "lag_lead": "SELECT name, lag(sal) OVER (PARTITION BY dept "
                "ORDER BY sal), lead(sal) OVER (PARTITION BY dept "
                "ORDER BY sal) FROM emp",
    "lag_offset": "SELECT name, lag(sal, 2) OVER (PARTITION BY dept "
                  "ORDER BY sal) FROM emp",
    "first_last": "SELECT name, first_value(sal) OVER (PARTITION BY dept "
                  "ORDER BY sal), last_value(sal) OVER (PARTITION BY dept "
                  "ORDER BY sal) FROM emp",
    "with_filter": "SELECT name, row_number() OVER (ORDER BY sal) "
                   "FROM emp WHERE sal > 60 ORDER BY 2",
    "expr_arithmetic": "SELECT name, rank() OVER (ORDER BY sal) * 10 "
                       "FROM emp WHERE sal IS NOT NULL",
    "in_cte": "WITH ranked AS (SELECT name, sal, row_number() OVER "
              "(PARTITION BY dept ORDER BY sal DESC) AS rn FROM emp "
              "WHERE sal IS NOT NULL) SELECT name FROM ranked "
              "WHERE rn = 1 ORDER BY name",
    "grouped_distinct": "SELECT dept, count(DISTINCT sal), "
                        "sum(DISTINCT sal) FROM emp GROUP BY dept "
                        "ORDER BY dept",
    "global_distinct": "SELECT count(DISTINCT sal), avg(DISTINCT sal) "
                       "FROM emp",
    "distinct_string": "SELECT count(DISTINCT dept) FROM emp",
    "distinct_plain_mix": "SELECT count(DISTINCT sal), count(sal), "
                          "count(*) FROM emp",
    "distinct_decimal": "SELECT g, sum(DISTINCT m) FROM p GROUP BY g "
                        "ORDER BY g",
    "ntile": "SELECT v, ntile(2) OVER (ORDER BY v) FROM wn ORDER BY v",
    "ntile_partitioned": "SELECT g, v, ntile(2) OVER (PARTITION BY g "
                         "ORDER BY v) FROM wn ORDER BY g, v",
    "ntile_more_buckets": "SELECT v, ntile(5) OVER (ORDER BY v) FROM wn2 "
                          "ORDER BY v",
    "wf_rank_float_desc": "SELECT g, x, m, rank() OVER (PARTITION BY g "
                          "ORDER BY x DESC), dense_rank() OVER "
                          "(PARTITION BY g ORDER BY x DESC) FROM wf",
    "wf_running_float": "SELECT g, x, sum(x) OVER (PARTITION BY g ORDER BY "
                        "x), min(x) OVER (PARTITION BY g ORDER BY x), "
                        "max(x) OVER (PARTITION BY g) FROM wf",
    "wf_decimal": "SELECT g, m, sum(m) OVER (PARTITION BY g ORDER BY m "
                  "DESC), count(m) OVER (PARTITION BY g), min(m) OVER "
                  "(ORDER BY m), last_value(m) OVER (PARTITION BY g "
                  "ORDER BY m) FROM wf",
    "wf_string_keys": "SELECT s, g, row_number() OVER (PARTITION BY s "
                      "ORDER BY g DESC, m), lag(m, 1) OVER (PARTITION BY "
                      "s ORDER BY g DESC, m), ntile(3) OVER (ORDER BY s, "
                      "g) FROM wf",
}
ERRORS = {
    "rank_requires_order_by": "SELECT rank() OVER (PARTITION BY dept) "
                              "FROM emp",
    "over_grouped": "SELECT dept, rank() OVER (ORDER BY sum(sal)) "
                    "FROM emp GROUP BY dept",
    "ntile_fraction": "SELECT ntile(2.5) OVER (ORDER BY v) FROM wn2",
    "ntile_string": "SELECT ntile('abc') OVER (ORDER BY v) FROM wn2",
    "ntile_zero": "SELECT ntile(0) OVER (ORDER BY v) FROM wn2",
}
SETUP = (EMP_DDL, EMP_ROWS, WN_DDL, WN_ROWS, WN2_DDL, WN2_ROWS, P_DDL,
         P_ROWS, WF_DDL, WF_ROWS)


def _outcome(eng, sql, mode):
    s = eng.session()
    s.vars.set("sort_normalized", mode)
    s.vars.set("distsql", "off")
    try:
        res = eng.execute(sql, s)
    except Exception as e:   # the error text is what is compared
        return ("error", str(e))
    return ("rows", res.rows, [t.family for t in res.types])


@pytest.fixture(scope="module")
def reference():
    out = {}
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        e = jeng.Engine()
        try:
            for stmt in SETUP:
                e.execute(stmt)
            for mode in ("auto", "off"):
                for name, sql in {**QUERIES, **ERRORS}.items():
                    out[(name, mode)] = _outcome(e, sql, mode)
        finally:
            e.close()
    return out


@pytest.fixture(scope="module")
def port():
    e = Engine(device="cpu")
    for stmt in SETUP:
        e.execute(stmt)
    return e


def _canon(rows, ordered):
    rows = [tuple(("nan",) if isinstance(v, float) and v != v else v
                  for v in r) for r in rows]
    return rows if ordered else sorted(rows, key=repr)


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_window_query_equals_reference(reference, port, name, mode):
    want = reference[(name, mode)]
    got = _outcome(port, QUERIES[name], mode)
    assert want[0] == "rows", want
    assert got[0] == "rows", got
    ordered = "ORDER BY" in QUERIES[name].rsplit(")", 1)[-1]
    g_rows, w_rows = _canon(got[1], ordered), _canon(want[1], ordered)
    assert len(g_rows) == len(w_rows)
    for g_row, w_row in zip(g_rows, w_rows):
        for g, w, fam in zip(g_row, w_row, got[2]):
            if fam == Family.FLOAT and isinstance(g, float) \
                    and isinstance(w, float):
                assert g == pytest.approx(w, rel=FLOAT_REL), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_window_error_equals_reference(reference, port, name):
    want = reference[(name, "auto")]
    got = _outcome(port, ERRORS[name], "auto")
    assert want[0] == "error" and got == want


def test_decimal_window_avg_is_repaired(reference, port):
    """AVG over a DECIMAL window: the reference returns the mean of the
    scaled ints (10^scale times the value); the port returns the value,
    held to a numpy oracle (rel 1e-12). The other columns equal the
    reference's."""
    sql = ("SELECT g, m, avg(m) OVER (PARTITION BY g), avg(m) OVER "
           "(ORDER BY m) FROM wf WHERE m IS NOT NULL ORDER BY m, g")
    got = port.execute(sql).rows
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        je = jeng.Engine()
        try:
            for stmt in SETUP:
                je.execute(stmt)
            s = je.session()
            s.vars.set("distsql", "off")
            want = je.execute(sql, s).rows
        finally:
            je.close()
    ms = [r[1] for r in got]
    for row, ref in zip(got, want):
        g, m = row[0], row[1]
        part = [r[1] for r in got if r[0] == g]
        assert row[2] == pytest.approx(np.mean(part), rel=FLOAT_REL)
        peers = [x for x in ms if x <= m]
        assert row[3] == pytest.approx(np.mean(peers), rel=FLOAT_REL)
        assert ref[:2] == row[:2]
        assert ref[2] == pytest.approx(100 * row[2], rel=FLOAT_REL)


def test_window_is_refused_streaming_on_both():
    """Past the budget an aggregate over the table streams on both
    engines; a window over it stays resident on both (a window sees
    its whole partition)."""
    budget = 1 << 14
    agg = "SELECT g, count(*) FROM big GROUP BY g"
    win = "SELECT g, row_number() OVER (PARTITION BY g ORDER BY v) FROM big"
    rng = np.random.default_rng(7)
    vals = ", ".join(f"({int(g)}, {int(v)})" for g, v in
                     zip(rng.integers(0, 8, 4000), rng.integers(0, 99, 4000)))
    stmts = ["CREATE TABLE big (g INT, v INT)",
             f"INSERT INTO big VALUES {vals}",
             f"SET CLUSTER SETTING sql.exec.hbm_budget_bytes = {budget}"]
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        je = jeng.Engine()
        try:
            for st in stmts:
                je.execute(st)
            s = je.session()
            s.vars.set("distsql", "off")
            s.vars.set("streaming_page_rows", 1024)
            want = (je.stream_verdict(agg, s), je.stream_verdict(win, s))
        finally:
            je.close()
    pe = Engine(device="cpu")
    for st in stmts:
        pe.execute(st)
    s = pe.session()
    pe.execute("SET streaming_page_rows = 1024", s)
    got = (pe.stream_verdict(agg, s), pe.stream_verdict(win, s))
    assert want == got == ("stream-scan", "resident")


# -- ops/window.py against the reference's, function by function ----------

def _case(seed, n=96):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, 5, n).astype(np.int64)
    part_v = rng.random(n) > 0.1
    x = rng.choice(np.array([-2.5, -0.0, 0.0, 1.0, 1.0, 3.25, np.nan]), n)
    x_v = rng.random(n) > 0.15
    k = rng.integers(-3, 4, n).astype(np.int64)
    k_v = rng.random(n) > 0.1
    sel = rng.random(n) > 0.2
    return part, part_v, x, x_v, k, k_v, sel


@pytest.fixture(scope="module")
def jw():
    with reference_modules("cockroach_tpu.ops.window") as (mod,):
        yield mod


def _pair(arrs):
    import jax.numpy as jnp
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs])


def _eq(j_out, t_out):
    jd, jv = (np.asarray(a) for a in j_out)
    td, tv = (t.numpy() for t in t_out)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(td[tv], jd[jv])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["on", "off"])
@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("order_col", ["float", "int"])
def test_window_functions_equal_reference(jw, seed, mode, desc, order_col):
    part, part_v, x, x_v, k, k_v, sel = _case(seed)
    (jp, jpv, jx, jxv, jk, jkv, js), (tp, tpv, tx, txv, tk, tkv, ts) = \
        _pair([part, part_v, x, x_v, k, k_v, sel])
    if order_col == "float":
        jord, tord = [(jx, jxv, desc)], [(tx, txv, desc)]
    else:
        jord, tord = [(jk, jkv, desc), (jx, jxv, False)], \
            [(tk, tkv, desc), (tx, txv, False)]
    j = jw.order_and_segments([(jp, jpv)], jord, js, mode)
    t = TW.order_and_segments([(tp, tpv)], tord, ts, mode)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jo, jss, jps, jsel = j
    to, tss, tps, tsel = t
    _eq(jw.row_number(jo, jss, jsel), TW.row_number(to, tss, tsel))
    _eq(jw.rank(jo, jss, jps, jsel), TW.rank(to, tss, tps, tsel))
    _eq(jw.dense_rank(jo, jss, jps, jsel),
        TW.dense_rank(to, tss, tps, tsel))
    for b in (1, 3, 7, 200):
        _eq(jw.ntile(jo, jss, jsel, b), TW.ntile(to, tss, tsel, b))
    for data in ((jx, jxv, tx, txv), (jk, jkv, tk, tkv)):
        jd, jv, td, tv = data
        for off in (1, 2, -1, -3):
            _eq(jw.lag_lead(jo, jss, jsel, jd, jv, off),
                TW.lag_lead(to, tss, tsel, td, tv, off))
        _eq(jw.first_value(jo, jss, jsel, jd, jv),
            TW.first_value(to, tss, tsel, td, tv))
        for framed in (False, True):
            _eq(jw.last_value(jo, jss, jps, jsel, jd, jv, framed),
                TW.last_value(to, tss, tps, tsel, td, tv, framed))
            for func in ("sum", "avg", "count", "min", "max"):
                _eq(jw.window_agg(func, jo, jss, jps, jsel, jd, jv, framed),
                    TW.window_agg(func, to, tss, tps, tsel, td, tv, framed))
    for framed in (False, True):
        _eq(jw.window_agg("count_rows", jo, jss, jps, jsel, None, None,
                          framed),
            TW.window_agg("count_rows", to, tss, tps, tsel, None, None,
                          framed))


@pytest.mark.parametrize("func", ["min", "max"])
def test_segmented_scan_equals_reference(jw, func):
    """The log-step scan against the reference's associative_scan over
    long segments, NaN included (both propagate it)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(11)
    n = 1000
    seg = np.cumsum(rng.random(n) < 0.02).astype(np.int64)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.01] = np.nan
    want = np.asarray(jw._segmented(jnp.asarray(x), jnp.asarray(seg), func))
    got = TW._segmented(torch.from_numpy(x), torch.from_numpy(seg),
                        func).numpy()
    np.testing.assert_array_equal(got, want)
