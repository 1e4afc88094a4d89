"""TPC-H Q3, Q5, Q10, Q12 and a duplicate-key partsupp join through the
port's Engine against the JAX Engine.

The reference Engine loads every TPC-H table (``ALL_TABLES``: lineitem
capped at 20,000 rows, the others at sf 0.01) and runs Q3, Q5, Q10, Q12,
QPS, the lineitem x partsupp half of Q9 without its supplier key
(partsupp has 4 rows per part key, so the join expands K = 4 ways), and
QH, returned-item revenue per customer and ship mode. Its store is
carried into the port's ``Engine(device="cpu")``, which must
return the reference's rows, in the reference's order, bit for bit
(DECIMAL, INT, STRING and DATE values decode to equal Python values)
under ``sort_normalized`` auto, on and off. Both engines' numpy oracles
must agree with each other exactly and with the port within rel 1e-9
(float64 sums against exact DECIMAL sums).

The routes are checked from counters: kernel 1 (the large-G kernel's
plain version here) for the dense GROUP BYs of Q3, Q5, Q12 and QH,
``group_ids`` for Q10's hash GROUP BY, the top-k cut for Q3, Q10 and
QH, packed-lane sorts as many as the reference makes, the K = 4
expansion for QPS. A second pair of stores holds
100,000 lineitem rows (padded to 2^17), where selection compaction
packs the batch before Q12's join and QPS's expansion.
"""

import numpy as np
import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.exec.session import EngineError
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.ops import sortkey as tsk
from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from tests.test_torch_engine import _store_arrays
from tests.test_torch_groupagg_large import reference_modules

ROWS = 20_000
BIG_ROWS = 100_000
MODES = ("auto", "on", "off")

QPS = """
SELECT count(*) AS n, sum(ps_supplycost * l_quantity) AS cost
FROM lineitem, partsupp
WHERE l_partkey = ps_partkey
  AND l_shipdate >= date '1995-01-01' AND l_shipdate < date '1995-02-01'
"""
# returned-item revenue per customer and ship mode (Q10's filters). Its
# two keys group by a dense code while o_custkey spans at most 4,096
# (sf 0.01), by hash past that (SF1); Q10 goes the other way: by hash
# here, and at SF1 the planner reduces its keys by functional
# dependency to the one dense key c_custkey

QH = """
SELECT o_custkey, l_shipmode, count(*) AS n,
       sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM orders, lineitem
WHERE l_orderkey = o_orderkey
  AND o_orderdate >= date '1993-10-01' AND o_orderdate < date '1994-01-01'
  AND l_returnflag = 'R'
GROUP BY o_custkey, l_shipmode
ORDER BY revenue DESC, o_custkey, l_shipmode
LIMIT 20
"""
QUERIES = {"q3": tpch.Q3, "q5": tpch.Q5, "q10": tpch.Q10, "q12": tpch.Q12,
           "qps": QPS, "qh": QH}


def _reference_run(rows, tables, queries):
    """The reference's rows and packed-sort count per query, and its
    store as arrays."""
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch",
                           "cockroach_tpu.ops.sortkey") as (jeng, jtpch,
                                                            jsk):
        e = jeng.Engine()
        try:
            jtpch.load(e, sf=0.01, rows=rows, tables=tables)
            out = {}
            for q in queries:
                s = e.session()
                s.vars.set("distsql", "off")
                n0 = jsk.NORMALIZED.value()
                out[q] = {"rows": e.execute(QUERIES[q], session=s).rows,
                          "normalized": jsk.NORMALIZED.value() - n0}
            arrays = _store_arrays(e.store, jtpch.DDL)
        finally:
            e.close()
    return out, arrays


@pytest.fixture(scope="module")
def reference():
    return _reference_run(ROWS, tpch.ALL_TABLES, list(QUERIES))


@pytest.fixture(scope="module")
def port(reference):
    return Engine(device="cpu", store=store_from_arrays(reference[1]))


@pytest.fixture(scope="module")
def big():
    ref, arrays = _reference_run(BIG_ROWS, ("lineitem", "orders",
                                            "partsupp"), ["q12", "qps"])
    return ref, Engine(device="cpu", store=store_from_arrays(arrays))


def _run(eng, sql, mode="auto"):
    s = eng.session()
    eng.execute(f"SET sort_normalized = {mode}", s)
    return eng.execute(sql, s).rows


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("query", list(QUERIES))
def test_query_matches_reference(reference, port, query, mode):
    ref, _ = reference
    got = _run(port, QUERIES[query], mode)
    assert len(got) > 0
    # bit-equal values in the reference's order
    assert got == ref[query]["rows"]
    assert port.last_exec["replans"] == []


def test_oracles_match_reference_and_port(port):
    from cockroach_tpu.models import tpch as jtpch
    d = {"li": tpch.gen_lineitem(0.01, rows=ROWS),
         "orders": tpch.gen_orders(0.01), "cust": tpch.gen_customer(0.01),
         "supp": tpch.gen_supplier(0.01), "nation": tpch.gen_nation()}
    for name in ("orders", "cust", "supp"):
        gen = {"orders": jtpch.gen_orders, "cust": jtpch.gen_customer,
               "supp": jtpch.gen_supplier}[name]
        want = gen(0.01)
        for col, arr in d[name].items():
            np.testing.assert_array_equal(arr, want[col], err_msg=col)
    for name, fn in (("partsupp", "gen_partsupp"), ("part", "gen_part")):
        want = getattr(jtpch, fn)(0.01)
        for col, arr in getattr(tpch, fn)(0.01).items():
            np.testing.assert_array_equal(arr, want[col], err_msg=col)
    for fn in ("gen_nation", "gen_region"):
        want = getattr(jtpch, fn)()
        for col, arr in getattr(tpch, fn)().items():
            np.testing.assert_array_equal(arr, want[col], err_msg=col)
    args = {"q3": ("li", "orders", "cust"),
            "q5": ("li", "orders", "cust", "supp"),
            "q10": ("li", "orders", "cust", "nation"),
            "q12": ("li", "orders")}
    for q, names in args.items():
        fn = f"ref_{q}"
        mine = getattr(tpch, fn)(*(d[n] for n in names))
        assert mine == getattr(jtpch, fn)(*(d[n] for n in names))
        got = _run(port, QUERIES[q])
        assert len(got) == len(mine) > 0
        for g_row, w_row in zip(got, mine):
            for g, w in zip(g_row, w_row):
                if isinstance(w, float):
                    assert g == pytest.approx(w, rel=1e-9), (g_row, w_row)
                else:
                    assert g == w, (g_row, w_row)


def test_routes(reference, port):
    ref, _ = reference
    for q in QUERIES:
        kernel = tgl.PLAIN_CALLS
        tsk.NORMALIZED.reset()
        _run(port, QUERIES[q])
        route = port.last_exec
        # kernel 1 for the dense GROUP BYs (Q10 groups by hash at this
        # scale, QPS is ungrouped)
        assert tgl.PLAIN_CALLS - kernel == (q in ("q3", "q5", "q12",
                                                  "qh")), q
        assert route["group_ids"] == (q == "q10"), q
        assert route["topk_cuts"] == (q in ("q3", "q10", "qh")), q
        assert route["expansions"] == ([4] if q == "qps" else []), q
        assert route["replans"] == []
        # every sort through packed lanes, as many as the reference's
        assert tsk.NORMALIZED.value() == ref[q]["normalized"] >= 1, q
        assert tsk.FALLBACKS.value() == 0


def test_compaction_at_scale(big):
    # 100,000 lineitem rows, padded to 2^17: four blocks of 32,768, so
    # the Compact under Q12's and QPS's joins packs the batch
    ref, eng = big
    for q in ("q12", "qps"):
        for mode in MODES:
            kernel = tgl.PLAIN_CALLS
            assert _run(eng, QUERIES[q], mode) == ref[q]["rows"]
            route = eng.last_exec
            assert (route["compact_nodes"], route["compacts_applied"],
                    route["replans"]) == (1, 1, [])
            # the packed batch (a multiple of 128 rows) still reaches
            # kernel 1
            assert tgl.PLAIN_CALLS - kernel == (q == "q12")


def test_compaction_overflow_replans(big, monkeypatch):
    # a capacity estimate far too low: every block overflows, the
    # engine replans uncompacted and still answers exactly
    ref, eng = big
    monkeypatch.setattr(Engine, "_compact_frac", lambda self, est: 1 / 256)
    assert _run(eng, QUERIES["q12"]) == ref["q12"]["rows"]
    route = eng.last_exec
    assert (route["compact_nodes"], route["compacts_applied"],
            route["replans"]) == (0, 0, ["no_compact"])


def test_topk_ties_across_the_cut_replan():
    # k takes two values over 1,000 rows: the top-k cut's rank word
    # ties across its 128 candidates, so the engine replans with the
    # full sort, which keeps tied rows in row order
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (k INT8 NOT NULL, v INT8 NOT NULL)")
    n = 1000
    k = np.arange(n) % 2
    e.store.insert_columns("t", {"k": k, "v": np.arange(n)}, e.clock.now())
    for mode in MODES:
        got = _run(e, "SELECT k, v FROM t ORDER BY k DESC LIMIT 5", mode)
        assert got == [(1, v) for v in (1, 3, 5, 7, 9)]
        assert e.last_exec["replans"] == ["no_topk"]
    with pytest.raises(EngineError, match="auto, on or off"):
        e.execute("SET sort_normalized = fast")


def test_hash_group_capacity_overflow_is_clean():
    # a FLOAT key groups by hash; 300 distinct keys do not fit 256 slots,
    # so the plan re-runs partition by partition
    e = Engine(device="cpu")
    e.execute("CREATE TABLE h (f FLOAT8 NOT NULL, v INT8 NOT NULL)")
    e.store.insert_columns("h", {"f": np.arange(300) / 7.0,
                                 "v": np.ones(300, dtype=np.int64)},
                           e.clock.now())
    sql = "SELECT f, count(*) AS n FROM h GROUP BY f"
    want = [(i / 7.0, 1) for i in range(300)]
    s = e.session()
    e.execute("SET hash_group_capacity = 256", s)
    assert sorted(e.execute(sql, s).rows) == want
    # the first run filled half the table and stopped, so did the
    # first of two partitions; four of about 75 keys each fit
    assert e.last_exec["partitioned"] == [4]
    e.execute("SET hash_group_capacity = 1024", s)
    rows = e.execute(sql, s).rows
    assert sorted(rows) == want
    assert e.last_exec["partitioned"] == []
    with pytest.raises(EngineError, match="power of two"):
        e.execute("SET hash_group_capacity = 1000", s)


def test_duplicate_key_join_answers():
    # build keys repeat up to 3 times: the join expands 3 ways
    e = Engine(device="cpu")
    e.execute("CREATE TABLE a (x INT8 NOT NULL, y INT8 NOT NULL)")
    e.execute("CREATE TABLE b (x INT8 NOT NULL, z INT8 NOT NULL)")
    ts = e.clock.now()
    e.store.insert_columns("a", {"x": np.arange(200) % 50,
                                 "y": np.arange(200)}, ts)
    bx = np.array([1, 1, 2, 3, 3, 3, 7])
    e.store.insert_columns("b", {"x": bx, "z": np.arange(7) * 10}, ts)
    e.execute("ANALYZE a")
    e.execute("ANALYZE b")
    rows = e.execute("SELECT count(*) AS n, sum(y * z) AS s FROM a, b "
                     "WHERE a.x = b.x").rows
    assert e.last_exec["expansions"] == [3]
    ax, ay = np.arange(200) % 50, np.arange(200)
    pairs = [(y, z) for x, y in zip(ax, ay)
             for xb, z in zip(bx, np.arange(7) * 10) if x == xb]
    assert rows == [(len(pairs), sum(y * z for y, z in pairs))]
