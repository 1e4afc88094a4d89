"""Prepared statements, the exec cache and re-runs in the port's Engine,
and the two masks behind partitioned GROUP BY and DISTINCT aggregates
against the JAX package's.

``Engine.prepare`` returns a ``Prepared`` (a ``RerunPrepared`` for CTE
and derived-table statements); its ``run()`` must equal ``execute``'s
rows exactly on every run. A second prepare of the same text hits the
exec cache. A moved table generation re-prepares the handle, whether
the table is scanned or read by a subquery whose result the plan
inlined. The TPC-H store is the reference's (sf 0.01, lineitem capped
at 20,000 rows), carried over with ``storage/transfer.py``; new
generations come from more of the reference's rows
(``ColumnStore.append_chunk``, as transfer.py ingests them) and from
``ColumnStore.insert_columns``.

``hashtable.partition_mask`` and ``agg.distinct_first_mask`` must be
bit-equal to the reference's on the same seeded keys: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.exec.session import EngineError, Prepared
from cockroach_tpu_torch.exec.stmtutil import RerunPrepared
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.ops import agg as tagg
from cockroach_tpu_torch.ops import hashtable as tht
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from tests.test_torch_engine import _store_arrays
from tests.test_torch_groupagg_large import reference_modules

PREPARED = {"q1": tpch.Q1, "q3": tpch.Q3, "q6": tpch.Q6, "q11": tpch.Q11,
            "q15": tpch.Q15, "q17": tpch.Q17, "q22": tpch.Q22}


@pytest.fixture(scope="module")
def arrays():
    """The reference's TPC-H store as arrays (storage/transfer.py)."""
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch") as (jeng, jtpch):
        e = jeng.Engine()
        try:
            jtpch.load(e, sf=0.01, rows=20_000, tables=jtpch.ALL_TABLES)
            return _store_arrays(e.store, jtpch.DDL)
        finally:
            e.close()


@pytest.fixture(scope="module")
def port(arrays):
    return Engine(device="cpu", store=store_from_arrays(arrays))


@pytest.mark.parametrize("query", list(PREPARED))
def test_prepared_runs_equal_execute(port, query):
    sql = PREPARED[query]
    s = port.session()
    want = port.execute(sql, s).rows
    p = port.prepare(sql, s)
    rerun = query in ("q15", "q17", "q22")
    assert isinstance(p, RerunPrepared if rerun else Prepared)
    for _ in range(3):
        assert p.run().rows == want
    if not rerun:
        assert port.last_exec["all"]["runs"] == 1


def test_second_prepare_hits_the_exec_cache(port):
    s = port.session()
    port.prepare(tpch.Q5, s)
    hit, miss = port.plan_cache["hit"], port.plan_cache["miss"]
    p = port.prepare(tpch.Q5, s)
    assert (port.plan_cache["hit"], port.plan_cache["miss"]) == \
        (hit + 1, miss)
    # another value of a plan-changing variable is another entry
    port.execute("SET sort_normalized = off", s)
    port.prepare(tpch.Q5, s)
    assert port.plan_cache["miss"] == miss + 1
    assert p.run().rows == port.execute(tpch.Q5).rows
    # a CTE statement's main query keeps its entry: its temps' names
    # are stable across executions
    port.execute(tpch.Q15, s)
    hit = port.plan_cache["hit"]
    port.execute(tpch.Q15, s)
    assert port.plan_cache["hit"] >= hit + 2


def _small_engine():
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t1 (g INT8 NOT NULL, v INT8 NOT NULL)")
    e.execute("CREATE TABLE t2 (w INT8 NOT NULL)")
    ts = e.clock.now()
    e.store.insert_columns("t1", {"g": np.arange(40) % 7,
                                  "v": np.arange(40)}, ts)
    e.store.insert_columns("t2", {"w": np.array([10, 20, 30])}, ts)
    return e


def test_changed_generation_replans():
    e = _small_engine()
    sql = "SELECT g, sum(v) AS s, count(*) AS n FROM t1 GROUP BY g ORDER BY g"
    p = e.prepare(sql)
    first = p.run().rows
    assert first == e.execute(sql).rows
    gens = p.gens
    e.store.insert_columns("t1", {"g": np.array([3, 9]),
                                  "v": np.array([100, 200])}, e.clock.now())
    got = p.run().rows
    assert p.gens != gens
    assert got == e.execute(sql).rows != first
    assert (9, 200, 1) in got


def test_transferred_rows_replan(arrays):
    # a store carried over from the reference (storage/transfer.py); a
    # second chunk of the reference's own rows for its first 2,000
    # orders, under new order keys and the same MVCC bounds, moves two
    # generations under a prepared Q12 (orders x lineitem)
    e = Engine(device="cpu", store=store_from_arrays(arrays))
    p = e.prepare(tpch.Q12)
    assert isinstance(p, Prepared)
    before = p.run().rows
    gens = p.gens
    shift = int(arrays["orders"]["columns"]["o_orderkey"].max())
    for name, key in (("orders", "o_orderkey"), ("lineitem", "l_orderkey")):
        src = arrays[name]
        m = src["columns"][key] <= 2000
        cols = {c: v[m].copy() for c, v in src["columns"].items()}
        cols[key] = cols[key] + shift
        e.store.append_chunk(name, cols,
                             {c: v[m].copy() for c, v in src["valid"].items()},
                             src["mvcc_ts"][m].copy(),
                             src["mvcc_del"][m].copy())
    after = p.run().rows
    assert p.gens != gens
    assert after == e.execute(tpch.Q12).rows
    assert sum(r[1] + r[2] for r in after) > sum(r[1] + r[2] for r in before)


def test_fresh_rows_when_an_inlined_subquery_moves():
    e = _small_engine()
    sql = "SELECT g, v FROM t1 WHERE v > (SELECT avg(w) FROM t2) ORDER BY v"
    s = e.session()
    p = e.prepare(sql, s)
    assert [r[1] for r in p.run().rows] == list(range(21, 40))
    assert e.last_exec["subqueries"] == 0   # inlined at prepare
    # only t2 moves: the avg goes from 20 to 30
    e.store.insert_columns("t2", {"w": np.array([40, 50])}, e.clock.now())
    assert [r[1] for r in p.run().rows] == list(range(31, 40))
    assert e.last_exec["subqueries"] == 1   # re-prepared
    # execute keys the exec cache by the plan: the new constant misses
    miss = e.plan_cache["miss"]
    assert [r[1] for r in e.execute(sql, s).rows] == list(range(31, 40))
    e.store.insert_columns("t2", {"w": np.array([0] * 5)}, e.clock.now())
    assert [r[1] for r in e.execute(sql, s).rows] == list(range(16, 40))
    assert e.plan_cache["miss"] > miss


def test_prepared_topk_replan_sticks():
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (k INT8 NOT NULL, v INT8 NOT NULL)")
    e.store.insert_columns("t", {"k": np.arange(1000) % 2,
                                 "v": np.arange(1000)}, e.clock.now())
    p = e.prepare("SELECT k, v FROM t ORDER BY k DESC LIMIT 5")
    want = [(1, v) for v in (1, 3, 5, 7, 9)]
    assert p.run().rows == want
    assert e.last_exec["replans"] == ["no_topk"] and p.no_topk
    assert p.run().rows == want
    assert e.last_exec["replans"] == []


def test_prepare_refuses_what_it_cannot_hold():
    e = _small_engine()
    with pytest.raises(EngineError, match="can only prepare"):
        e.prepare("CREATE TABLE t3 (a INT8)")
    with pytest.raises(EngineError, match="must be in the past"):
        e.prepare("SELECT g FROM t1 AS OF SYSTEM TIME "
                  "'2099-01-01 00:00:00'")


def test_derived_table_is_a_rerun_handle():
    e = _small_engine()
    sql = ("SELECT n, count(*) AS c FROM (SELECT g, count(*) AS n FROM t1 "
           "GROUP BY g) AS x GROUP BY n ORDER BY n")
    p = e.prepare(sql)
    assert isinstance(p, RerunPrepared)
    assert p.run().rows == e.execute(sql).rows == [(5, 2), (6, 5)]
    assert not [t for t in e.store.tables if t.startswith("__cte_")]


@pytest.mark.parametrize("nparts,pid", [(1, 0), (2, 1), (8, 5), (256, 255),
                                        (512, 300), (4096, 1)])
def test_partition_mask_equals_reference(nparts, pid):
    from cockroach_tpu.ops import hashtable as jht
    rng = np.random.default_rng(nparts + pid)
    n = 4096
    cols = (rng.integers(-(1 << 62), 1 << 62, size=n),
            rng.integers(-9, 9, size=n).astype(np.int32),
            (rng.random(n) < 0.9).astype(np.int32))
    want = np.asarray(jht.partition_mask(
        tuple(jnp.asarray(c) for c in cols), nparts, pid))
    got = tht.partition_mask(tuple(torch.from_numpy(c) for c in cols),
                             nparts, pid).numpy()
    np.testing.assert_array_equal(got, want)
    if nparts == 1:
        assert got.all()


@pytest.mark.parametrize("mode", ("auto", "on", "off"))
@pytest.mark.parametrize("dtype", ("int64", "int32", "float64", "bool"))
def test_distinct_first_mask_equals_reference(dtype, mode):
    from cockroach_tpu.ops import agg as jagg
    rng = np.random.default_rng(7)
    n = 3000
    data = {"int64": lambda: rng.integers(-5, 5, size=n) * (1 << 40),
            "int32": lambda: rng.integers(-9, 9, size=n).astype(np.int32),
            "float64": lambda: np.where(rng.random(n) < 0.1, -0.0,
                                        rng.integers(0, 6, size=n) / 4),
            "bool": lambda: rng.random(n) < 0.5}[dtype]()
    mask = rng.random(n) < 0.8
    G = 37
    gid = rng.integers(0, G, size=n).astype(np.int32)
    want = np.asarray(jagg.distinct_first_mask(
        jnp.asarray(data), jnp.asarray(mask), jnp.asarray(gid), G, mode))
    got = tagg.distinct_first_mask(torch.from_numpy(data),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(gid), G, mode).numpy()
    np.testing.assert_array_equal(got, want)
