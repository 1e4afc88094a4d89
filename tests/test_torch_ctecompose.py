"""Composed CTE execution (exec/ctecompose.py) against the JAX Engine.

The reference loads every TPC-H table (lineitem capped at 5,000 rows,
the others at sf 0.01); its store is carried into the port's
``Engine(device="cpu")``. TPC-H Q4, Q13, Q15, Q21 and Q22 (EXISTS and
NOT EXISTS temps, a derived table, a view's CTE) are prepared: the
first run takes the slow path and captures, runs 2-4 compose (the
handle's composed count rises, no temp is materialized or uploaded) and
every run equals the reference's rows. A composition is declined, and
the run takes the slow path with the right rows, after a write to a
base table, inside an open txn, and when its glue raises the overflow
flag; the run after a declined one composes again. The glue itself,
on a seeded body batch: live rows in order, the MVCC stamps and
padding of the port's upload, dictionary clipping, and the flag once
the live rows pass the captured width or a body sentinel is set. Two
threads prepare two CTE statements at once and each composes its own.
"""

import threading

import pytest
import torch

from cockroach_tpu_torch.exec import ctecompose
from cockroach_tpu_torch.exec.engine import TEMP_PREFIX, Engine
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.ops.batch import ColumnBatch
from cockroach_tpu_torch.storage.columnstore import MAX_TS_INT
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from tests.test_torch_engine import _store_arrays
from tests.test_torch_groupagg_large import reference_modules
from tests.test_torch_subquery import assert_rows

ROWS = 5_000
QUERIES = ("q4", "q13", "q15", "q21", "q22")
TIMEOUT = 120


@pytest.fixture(scope="module")
def reference():
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch") as (jeng, jtpch):
        e = jeng.Engine()
        try:
            jtpch.load(e, sf=0.01, rows=ROWS, tables=jtpch.ALL_TABLES)
            s = e.session()
            s.vars.set("distsql", "off")
            rows = {q: e.execute(jtpch.QUERIES[q], session=s).rows
                    for q in QUERIES}
            return rows, _store_arrays(e.store, jtpch.DDL)
        finally:
            e.close()


@pytest.fixture()
def port(reference, monkeypatch):
    """The port over the carried store, counting temp uploads."""
    e = Engine(device="cpu", store=store_from_arrays(reference[1]))
    uploads = []
    real = e._batch_from_chunks

    def counting(td, chunks, cols):
        if td.schema.name.startswith(TEMP_PREFIX):
            uploads.append(td.schema.name)
        return real(td, chunks, cols)
    monkeypatch.setattr(e, "_batch_from_chunks", counting)
    e.temp_uploads = uploads
    return e


@pytest.mark.parametrize("query", QUERIES)
def test_prepared_cte_composes_after_its_first_run(reference, port, query):
    want = reference[0][query]
    p = port.prepare(tpch.QUERIES[query])
    res = p.run()
    assert_rows(res, want)
    assert port.last_exec["temps"] and not port.last_exec["composed"]
    assert port.temp_uploads and p._composed is not None
    for i in range(3):
        port.temp_uploads.clear()
        assert_rows(p.run(), want)
        assert port.last_exec["composed"] and port.last_exec["temps"] == []
        assert port.temp_uploads == []
        assert (p.composed_runs, p.declined) == (i + 1, 0)
    assert not [t for t in port.store.tables if t.startswith(TEMP_PREFIX)]
    m = port.metrics.snapshot()
    assert m["sql.cte.composed.runs"] == 3


def test_write_to_a_base_table_declines(port):
    sql = tpch.QUERIES["q22"]
    p = port.prepare(sql)
    p.run()
    assert p.run().rows == port.execute(sql).rows
    assert p.composed_runs == 1
    # a customer with a Q22 country code, no orders, a high balance
    port.execute("INSERT INTO customer VALUES (999999, 'Customer#999999', "
                 "1, '13-555-555-5555', 9999.99, 'BUILDING')")
    want = port.execute(sql).rows
    got = p.run()
    assert got.rows == want and not port.last_exec["composed"]
    assert p.declined == 1 and port.last_exec["temps"]
    assert p.run().rows == want and port.last_exec["composed"]
    assert (p.composed_runs, p.declined) == (2, 1)
    assert port.metrics.snapshot()["sql.cte.composed.declined"] == 1


def test_open_txn_declines(port):
    sql = tpch.QUERIES["q4"]
    s = port.session()
    p = port.prepare(sql, s)
    want = p.run().rows
    assert p.run().rows == want and p.composed_runs == 1
    port.execute("BEGIN", s)
    try:
        assert p.run().rows == want
        assert not port.last_exec["composed"] and p.declined == 1
    finally:
        port.execute("ROLLBACK", s)
    # no capture inside the txn: the next run captures, the one after
    # composes
    assert p.run().rows == want and not port.last_exec["composed"]
    assert p.run().rows == want and port.last_exec["composed"]


def test_glue_overflow_declines(port, monkeypatch):
    """A glue whose flag is raised (more live rows than the captured
    width, a body sentinel) declines the run: it takes the slow path,
    captures again, and the next run composes."""
    sql = tpch.QUERIES["q4"]
    p = port.prepare(sql)
    want = p.run().rows
    st = p._composed.stages[0]
    alias, glue = st.glues[0]
    st.glues[0] = (alias, lambda b: (glue(b)[0], torch.tensor(True)))
    assert p.run().rows == want and not port.last_exec["composed"]
    assert p.declined == 1 and port.last_exec["temps"]
    assert p.run().rows == want and port.last_exec["composed"]


def _body(n, live, codes):
    sel = torch.zeros(n, dtype=torch.bool)
    sel[live] = True
    return ColumnBatch.from_dict(
        {"a": torch.arange(n, dtype=torch.int64) * 10,
         "s": torch.tensor(codes, dtype=torch.int64)},
        {"a": torch.arange(n) % 3 != 0}, sel=sel)


def _template(w):
    return ColumnBatch.from_dict(
        {"x": torch.zeros(w, dtype=torch.int64),
         "y": torch.zeros(w, dtype=torch.int32),
         "_mvcc_ts": torch.zeros(w, dtype=torch.int64),
         "_mvcc_del": torch.zeros(w, dtype=torch.int64)})


def test_glue_compacts_into_the_temp_batch():
    """The glue's batch is the upload's: live rows first in order,
    padding with data 0 and validity False, never-visible MVCC stamps on
    padding, codes clipped to the dictionary; no overflow below the
    width, the flag past it."""
    live = [1, 4, 5, 9]
    b = _body(12, live, [0, 1, 2, 7, 1, 9, 0, 0, 3, 2, 1, 0])
    glue = ctecompose.make_glue(_template(8), {"x": "a", "y": "s"},
                                {"y": 3})
    out, ovf = glue(b)
    assert not bool(ovf) and out.n == 8
    assert out.sel.tolist() == [True] * 4 + [False] * 4
    assert out.col("x").tolist() == [10, 40, 50, 90, 0, 0, 0, 0]
    assert out.col_valid("x").tolist() == [True, True, True, False] + \
        [False] * 4
    assert out.col("y").dtype == torch.int32
    assert out.col("y").tolist() == [1, 1, 2, 2, 0, 0, 0, 0]
    assert out.col("_mvcc_ts").tolist() == [ctecompose._LIVE_TS] * 4 + \
        [ctecompose._DEAD_TS] * 4
    assert out.col("_mvcc_del").tolist() == [MAX_TS_INT] * 4 + [0] * 4
    _, ovf = ctecompose.make_glue(_template(2), {"x": "a", "y": "s"},
                                  {})(b)
    assert bool(ovf)
    sentinel = b.with_column("__ht_overflow",
                             torch.ones(12, dtype=torch.bool))
    assert bool(glue(sentinel)[1])


def test_two_threads_compose_their_own(reference, port):
    results, errors = {}, []

    def worker(q):
        try:
            s = port.session()
            p = port.prepare(tpch.QUERIES[q], s)
            rows = [p.run().rows for _ in range(3)]
            results[q] = (rows, p.composed_runs, p.declined)
        except Exception as ex:   # noqa: BLE001 - reported below
            errors.append(ex)

    ts = [threading.Thread(target=worker, args=(q,))
          for q in ("q4", "q13")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert not errors, errors
    for q in ("q4", "q13"):
        rows, composed, declined = results[q]
        assert (composed, declined) == (2, 0)
        for r in rows:
            assert r == reference[0][q] or q == "q13" and sorted(r) == \
                sorted(reference[0][q])
