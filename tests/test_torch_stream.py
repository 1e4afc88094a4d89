"""Streamed scans of the port against the reference Engine and against
the port's own resident runs, on the CPU.

The reference Engine (cockroach_tpu, no mesh) loads a TPC-H slice (sf
0.01, lineitem capped at 50,000 rows, every table in sealed chunks of
4,096 rows), the join-skipping tables of tests/test_join_skipping.py
(``t`` clustered on its key in 8 chunks of 2,048 rows, ``d`` a 100-row
dimension whose keys all sit in t's second chunk), a page-boundary
table of exactly 4 x 4,096 rows and a table with every other row
deleted through the reference's own DELETE. Each query runs there at
an ample budget (resident) and at a small one (streamed, pages of
8,192 or 2,048 rows), with the page, skip and join-filter counters
read around each streamed run. Its store is then carried into the
port (``store_from_arrays``, chunk by chunk, MVCC bounds included) and
every query runs again on ``Engine(device="cpu")`` at the same budgets
and page sizes. The port's streamed rows must equal the reference's
streamed rows and the port's own resident rows, and its counters the
reference's: INT, DECIMAL, STRING and DATE values exactly, FLOAT8
within rel 1e-9 (tests/test_streaming.py's tolerance). Then the
page-path pieces alone: ``prefetch`` (order, bounded depth, a worker
exception re-raised at the consumer, an early close joining the
worker) and a PageSource whose pages are all taken before any is read
(a reused buffer would corrupt the earlier pages).
"""

import math
import threading
import time

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.exec import stream as tstream
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from cockroach_tpu_torch.utils.mon import MemoryQuotaError
from tests.test_torch_groupagg_large import reference_modules

ROWS = 50_000
CHUNK = 4096
AMPLE = 12 << 30
SMALL = 1 << 20
PAGE = 1 << 13

T_DDL = "CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, v INT8, s STRING)"
D_DDL = "CREATE TABLE d (k INT8 NOT NULL PRIMARY KEY, w INT8)"
PB_DDL = "CREATE TABLE pb (a INT8 NOT NULL, b INT8)"
DEL_DDL = "CREATE TABLE dl (a INT8 NOT NULL PRIMARY KEY, g INT8)"
JS_ROWS, JS_CHUNK = 16_384, 2_048
JS_BUDGET = 1 << 17

MINMAX = ("SELECT l_returnflag, min(l_quantity) AS mn, max(l_quantity) "
          "AS mx, min(l_shipdate) AS d0, count(*) AS n FROM lineitem "
          "GROUP BY l_returnflag HAVING count(*) > 10 "
          "ORDER BY l_returnflag DESC LIMIT 2")
# lineitem is sorted on l_orderkey: zone maps prune most pages
ZONE = ("SELECT count(*) AS c, sum(l_quantity) AS q, "
        "avg(l_extendedprice) AS a FROM lineitem WHERE l_orderkey < 3000")
# the build side is empty: its join filter skips every page of t, and
# the aggregate runs once over a page of padding rows
EMPTY = ("SELECT count(*) AS c, sum(t.v) AS sv, min(t.k) AS mk FROM t "
         "JOIN d ON t.k = d.k WHERE d.w < 0")
JOIN_T = "SELECT count(*) AS c, sum(t.v) AS sv FROM t JOIN d ON t.k = d.k"
PB_Q = "SELECT sum(a) AS s, count(*) AS c, max(b) AS m FROM pb"
DEL_Q = ("SELECT g, count(*) AS c, sum(a) AS s FROM dl GROUP BY g "
         "ORDER BY g")

# (query name, sql, small budget, page rows, session vars)
RUNS = [
    ("q1", "Q1", SMALL, PAGE, {}),
    ("q6", "Q6", SMALL, PAGE, {}),
    # spill off: the probe streams against the resident part
    ("q14", "Q14", SMALL, PAGE, {"spill": "off"}),
    ("minmax", MINMAX, SMALL, PAGE, {}),
    ("zone", ZONE, SMALL, PAGE, {}),
    ("empty", EMPTY, JS_BUDGET, JS_CHUNK, {"spill": "off"}),
    ("join_t", JOIN_T, JS_BUDGET, JS_CHUNK, {"spill": "off"}),
    # the join-filter-pruned stream with the prefetch worker off
    ("join_t_off", JOIN_T, JS_BUDGET, JS_CHUNK,
     {"spill": "off", "streaming_pipeline": "off"}),
    ("pb", PB_Q, 1 << 16, 4096, {}),
    ("del", DEL_Q, 1 << 14, 1024, {}),
]
COUNTERS = ("exec.stream.pages", "exec.stream.pages_skipped",
            "exec.skip.joinfilter.pages", "exec.skip.mvcc.pages")


def _sql(tpch, s):
    return getattr(tpch, s) if s in ("Q1", "Q6", "Q14") else s


def _load_extra(eng, insert):
    """The join-skipping, page-boundary and delete tables."""
    for ddl in (T_DDL, D_DDL, PB_DDL, DEL_DDL):
        eng.execute(ddl)
    for c in range(JS_ROWS // JS_CHUNK):
        k = np.arange(c * JS_CHUNK, (c + 1) * JS_CHUNK, dtype=np.int64)
        insert("t", {"k": k, "v": k % 97,
                     "s": np.where(k % 2 == 0, "even", "odd")
                     .astype(object)})
    dk = np.arange(3000, 3100, dtype=np.int64)
    insert("d", {"k": dk, "w": dk * 2})
    for _ in range(4):
        a = np.arange(4096, dtype=np.int64)
        insert("pb", {"a": a, "b": a % 7})
    a = np.arange(10_000, dtype=np.int64)
    insert("dl", {"a": a, "g": a % 5})
    for t in ("t", "d", "pb", "dl"):
        eng.execute(f"ANALYZE {t}")


def carry(store, ddl: dict) -> dict:
    """A reference ColumnStore as store_from_arrays' arrays, chunk
    boundaries included."""
    out = {}
    for name, td in store.tables.items():
        chunks = td.chunks
        cols = [c.name for c in td.schema.columns]
        out[name] = {
            "ddl": ddl[name],
            "columns": {c: np.concatenate([k.data[c] for k in chunks])
                        for c in cols},
            "valid": {c: np.concatenate([k.valid[c] for k in chunks])
                      for c in cols},
            "mvcc_ts": np.concatenate([k.mvcc_ts for k in chunks]),
            "mvcc_del": np.concatenate([k.mvcc_del for k in chunks]),
            "dictionaries": {c: list(d.values)
                             for c, d in td.dictionaries.items()},
            "chunks": [k.n for k in chunks],
        }
    return out


def _run_all(eng, tpch, session_of, verdict):
    """{name: (resident rows, streamed rows, verdict, counter deltas)}
    on one engine (either package)."""
    out = {}
    for name, q, budget, page, extra in RUNS:
        sql = _sql(tpch, q)
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)
        s = session_of(eng, page, extra)
        base = eng.execute(sql, s).rows
        eng.settings.set("sql.exec.hbm_budget_bytes", budget)
        v = verdict(eng, sql, s)
        before = eng.metrics.snapshot()
        got = eng.execute(sql, s).rows
        after = eng.metrics.snapshot()
        deltas = {c: after.get(c, 0) - before.get(c, 0) for c in COUNTERS}
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)
        out[name] = (base, got, v, deltas)
    return out


def _session(eng, page, extra):
    s = eng.session()
    s.vars.set("distsql", "off")
    s.vars.set("streaming_page_rows", page)
    for k, v in extra.items():
        s.vars.set(k, v)
    return s


@pytest.fixture(scope="module")
def reference():
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch") as (jeng, jtpch):
        e = jeng.Engine(mesh=None)
        try:
            jtpch.load(e, sf=0.01, rows=ROWS, chunk_rows=CHUNK)
            _load_extra(e, lambda t, cols: e.store.insert_columns(
                t, cols, e.clock.now()))
            e.execute("DELETE FROM dl WHERE a % 2 = 0")
            runs = _run_all(e, jtpch, _session,
                            lambda eng, sql, s: eng.stream_verdict(sql, s))
            # streaming = off past the budget: a quota error at upload
            s = _session(e, PAGE, {"streaming": "off"})
            e.drop_device_cache()
            e.settings.set("sql.exec.hbm_budget_bytes", SMALL)
            try:
                e.execute(jtpch.Q6, s)
                off_raised = False
            except Exception as ex:  # the reference's MemoryQuotaError
                off_raised = type(ex).__name__ == "MemoryQuotaError"
            arrays = carry(e.store, {**jtpch.DDL, "t": T_DDL, "d": D_DDL,
                                     "pb": PB_DDL, "dl": DEL_DDL})
        finally:
            e.close()
    return runs, off_raised, arrays


@pytest.fixture(scope="module")
def port(reference):
    from cockroach_tpu_torch.models import tpch
    _, _, arrays = reference
    eng = Engine(device="cpu", store=store_from_arrays(arrays))
    runs = _run_all(eng, tpch, _session,
                    lambda e, sql, s: e.stream_verdict(sql, s))
    return eng, runs


def _assert_rows_close(got, want, rel=1e-9):
    assert len(got) == len(want), (got, want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            if isinstance(w, float) or isinstance(g, float):
                assert math.isclose(float(g), float(w), rel_tol=rel,
                                    abs_tol=1e-9), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


def test_carried_chunks_keep_layout_zones_and_windows(reference, port):
    """The carried store has the reference's chunks, and each got its
    zones at seal; its MVCC window bounds the visible versions."""
    _, _, arrays = reference
    eng, _ = port
    for name, t in arrays.items():
        td = eng.store.table(name)
        assert [c.n for c in td.chunks] == t["chunks"], name
        for c in td.chunks:
            assert c.stats_ready()
            ts_min, del_max = c.mvcc_window()
            assert ts_min == int(c.mvcc_ts.min())
            assert del_max == int(c.mvcc_del.max())
    c0 = eng.store.table("lineitem").chunks[0]
    lo, hi, nulls, nvalid = c0.zone("l_orderkey")
    assert (lo, hi) == (int(c0.data["l_orderkey"].min()),
                        int(c0.data["l_orderkey"].max()))


@pytest.mark.parametrize("name", [r[0] for r in RUNS])
def test_streamed_matches_reference_and_resident(reference, port, name):
    ref = reference[0][name]
    got = port[1][name]
    base, streamed, verdict, deltas = got
    assert verdict == ref[2] == "stream-scan", (verdict, ref[2])
    _assert_rows_close(streamed, ref[1])
    _assert_rows_close(streamed, base)
    _assert_rows_close(base, ref[0])
    assert deltas == ref[3], (deltas, ref[3])


def test_zone_and_joinfilter_pruning_counted(port):
    _, runs = port
    assert runs["zone"][3]["exec.stream.pages_skipped"] > 0
    assert runs["empty"][3]["exec.stream.pages"] == 0
    assert runs["empty"][3]["exec.skip.joinfilter.pages"] == \
        JS_ROWS // JS_CHUNK
    assert runs["empty"][1] == [(0, None, None)]
    # the join filter prunes t's pages outside d's keys, with the
    # prefetch worker on and off alike
    assert runs["join_t"][3]["exec.skip.joinfilter.pages"] > 0
    assert runs["join_t_off"][3] == runs["join_t"][3]
    assert runs["join_t"][1] == runs["join_t_off"][1]
    # 4 x 4096 rows in pages of 4096: no ragged tail
    assert runs["pb"][3]["exec.stream.pages"] == 4
    assert runs["pb"][1] == [(4 * (4095 * 4096 // 2), 4 * 4096, 6)]


def test_deletes_carried_stay_invisible(port):
    _, runs = port
    want = [(g, 1000, sum(a for a in range(1, 10_000, 2) if a % 5 == g))
            for g in range(5)]
    assert runs["del"][1] == want


def test_streaming_off_raises_quota_error(reference, port):
    _, off_raised, _ = reference
    assert off_raised
    from cockroach_tpu_torch.models import tpch
    eng, _ = port
    eng.drop_device_cache()
    eng.settings.set("sql.exec.hbm_budget_bytes", SMALL)
    try:
        s = _session(eng, PAGE, {"streaming": "off"})
        with pytest.raises(MemoryQuotaError, match="budget"):
            eng.execute(tpch.Q6, s)
        # auto at the same budget streams and answers
        s = _session(eng, PAGE, {})
        assert eng.execute(tpch.Q6, s).rows == port[1]["q6"][1]
    finally:
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)


def test_streaming_releases_resident_copy(port):
    """A statement that streams a table drops its cached resident copy
    and the reservation with it."""
    from cockroach_tpu_torch.models import tpch
    eng, _ = port
    s = _session(eng, PAGE, {})
    eng.execute(tpch.Q6, s)
    assert any(k[0] == "lineitem" for k in eng._device_tables)
    held = eng.hbm.used
    assert held > 0
    eng.settings.set("sql.exec.hbm_budget_bytes", SMALL)
    try:
        eng.execute(tpch.Q6, s)
        assert not any(k[0] == "lineitem" for k in eng._device_tables)
        assert eng.hbm.used < held
    finally:
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)


def test_pipeline_off_and_prepared_rerun(port):
    """The synchronous page path gives the same rows; a Prepared
    re-decides its placement when the budget moves."""
    from cockroach_tpu_torch.models import tpch
    eng, runs = port
    eng.settings.set("sql.exec.hbm_budget_bytes", SMALL)
    try:
        s = _session(eng, PAGE, {"streaming_pipeline": "off"})
        assert eng.execute(tpch.Q1, s).rows == runs["q1"][1]
        s = _session(eng, PAGE, {})
        p = eng.prepare(tpch.Q6, s)
        assert p.stream is not None
        first = p.run().rows
        assert first == runs["q6"][1]
        hits = eng.plan_cache["hit"]
        assert p.run().rows == first
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)
        assert p.run().rows == runs["q6"][0]
        assert p.stream is None
        eng.settings.set("sql.exec.hbm_budget_bytes", SMALL)
        assert p.run().rows == first and p.stream is not None
        assert eng.plan_cache["hit"] > hits
    finally:
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)


def test_paged_route_recorded(port):
    from cockroach_tpu_torch.models import tpch
    eng, _ = port
    eng.settings.set("sql.exec.hbm_budget_bytes", SMALL)
    try:
        eng.execute(tpch.Q1, _session(eng, PAGE, {}))
    finally:
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)
    pg = eng.last_exec["paging"]
    assert pg["route"] == "stream"
    assert pg["pages"] == math.ceil(ROWS / PAGE)
    assert pg["bytes"] > 0 and pg["stall_s"] >= 0


# ---------------------------------------------------------------------------
# the page path's pieces
# ---------------------------------------------------------------------------

def test_prefetch_keeps_order():
    assert list(tstream.prefetch(iter(range(50)), depth=3)) == \
        list(range(50))


def test_prefetch_bounded_depth():
    made = []

    def gen():
        for i in range(20):
            made.append(i)
            yield i

    it = tstream.prefetch(gen(), depth=2)
    assert next(it) == 0
    time.sleep(0.2)
    # one consumed, at most `depth` queued and one held by the worker
    assert len(made) <= 1 + 2 + 1
    it.close()


def test_prefetch_reraises_worker_error():
    def gen():
        yield 1
        raise ValueError("page assembly failed")

    it = tstream.prefetch(gen())
    assert next(it) == 1
    with pytest.raises(ValueError, match="page assembly failed"):
        next(it)


def test_prefetch_close_joins_worker():
    def gen():
        i = 0
        while True:
            yield i
            i += 1

    before = {t.ident for t in threading.enumerate()}
    it = tstream.prefetch(gen(), depth=2)
    assert next(it) == 0
    workers = [t for t in threading.enumerate()
               if t.name == "page-prefetch" and t.ident not in before]
    assert workers
    it.close()
    assert not any(t.is_alive() for t in workers)


def test_page_source_pages_taken_before_read(port):
    """Every page assembled and uploaded before any is read: with a
    reused host buffer the earlier pages would hold the last page's
    rows."""
    eng, _ = port
    td = eng.store.table("lineitem")
    src = eng._page_source("lineitem", frozenset({"l_orderkey",
                                                  "l_quantity"}), 4096)
    ups = list(src.pages())
    assert len(ups) == math.ceil(ROWS / 4096)
    keys = np.concatenate([c.data["l_orderkey"] for c in td.chunks])
    qty = np.concatenate([c.data["l_quantity"] for c in td.chunks])
    for i, up in enumerate(ups):
        b = up.batch()
        lo, hi = i * 4096, min((i + 1) * 4096, ROWS)
        np.testing.assert_array_equal(
            b.col("l_orderkey").numpy()[:hi - lo], keys[lo:hi])
        np.testing.assert_array_equal(
            b.col("l_quantity").numpy()[:hi - lo], qty[lo:hi])
        assert (b.col("_mvcc_ts").numpy()[hi - lo:]
                == int(tstream.NEVER_TS)).all()


def test_page_source_without_device_takes_the_card(port):
    """A PageSource given no device takes the card, as Engine does:
    without one it raises instead of paging on the CPU."""
    eng, _ = port
    td = eng.store.table("lineitem")
    if torch.cuda.is_available():
        assert tstream.PageSource(td, frozenset({"l_orderkey"}),
                                  4096).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tstream.PageSource(td, frozenset({"l_orderkey"}), 4096)
    src = tstream.PageSource(td, frozenset({"l_orderkey"}), 4096,
                             device="cpu")
    assert src.device.type == "cpu"
    assert len(list(src.pages())) == math.ceil(ROWS / 4096)


def test_batch_concat_pad_to_and_group_any():
    """ops/batch.py concat and pad_to, and ops/agg.py group_any,
    against the reference's on seeded batches."""
    import torch

    from cockroach_tpu_torch.ops import agg as tagg
    from cockroach_tpu_torch.ops import batch as tbatch
    with reference_modules("cockroach_tpu.ops.batch",
                           "cockroach_tpu.ops.agg") as (jbatch, jagg):
        import jax.numpy as jnp
        rng = np.random.default_rng(9)
        parts = []
        for n in (5, 0, 7):
            d = rng.integers(-50, 50, n).astype(np.int64)
            v = rng.random(n) > 0.3
            sel = rng.random(n) > 0.2
            parts.append((d, v, sel))

        def tb(d, v, sel):
            return tbatch.ColumnBatch.from_dict(
                {"x": torch.from_numpy(d)}, {"x": torch.from_numpy(v)},
                sel=torch.from_numpy(sel))

        def jb(d, v, sel):
            return jbatch.ColumnBatch.from_dict(
                {"x": jnp.asarray(d)}, {"x": jnp.asarray(v)},
                sel=jnp.asarray(sel))

        got = tbatch.pad_to(tbatch.concat([tb(*p) for p in parts]), 16)
        want = jbatch.pad_to(jbatch.concat([jb(*p) for p in parts]), 16)
        for g, w in ((got.col("x"), want.col("x")),
                     (got.col_valid("x"), want.col_valid("x")),
                     (got.sel, want.sel)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        with pytest.raises(ValueError):
            tbatch.pad_to(got, 8)
        # group_any: a per-group-constant value; empty groups hold the
        # identity on both sides
        for dtype in (np.int64, np.float64, np.int32):
            gid = rng.integers(0, 40, 300).astype(np.int32)
            vals = (gid * 3 - 7).astype(dtype)
            mask = rng.random(300) > 0.4
            got = tagg.group_any(torch.from_numpy(vals),
                                 torch.from_numpy(gid),
                                 torch.from_numpy(mask), 48)
            want = jagg.group_any(jnp.asarray(vals), jnp.asarray(gid),
                                  jnp.asarray(mask), 48)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_transfer_scheduler_admission():
    """Resident reservations fail past the budget; a transient lease
    fails at once when only resident bytes fill the pool, waits for
    another lease to drain otherwise; a soft lease proceeds
    unreserved."""
    from cockroach_tpu_torch.exec.movement import TransferScheduler
    from cockroach_tpu_torch.utils.metric import MetricRegistry
    from cockroach_tpu_torch.utils.mon import BytesMonitor
    mon = BytesMonitor("hbm", 1000)
    ts = TransferScheduler(mon, MetricRegistry(), wait_timeout=5.0)
    ts.reserve_resident("t", 600)
    with pytest.raises(MemoryQuotaError, match="budget"):
        ts.reserve_resident("u", 500)
    with pytest.raises(MemoryQuotaError):
        with ts.lease("page", 500):
            pass
    with ts.soft_lease("page", 500) as got:
        assert got == 0
    with ts.soft_lease("spill", 300) as got:
        assert got == 300 and mon.used == 900
    assert mon.used == 600
    order = []
    with ts.lease("page", 300):
        def other():
            with ts.lease("spill", 200):
                order.append("second")
        th = threading.Thread(target=other)
        th.start()
        time.sleep(0.2)
        order.append("first")
    th.join(timeout=5.0)
    assert order == ["first", "second"]
    assert ts.release_resident("t") == 600 and mon.used == 0
    assert ts.transient_bytes() == 0
