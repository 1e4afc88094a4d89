"""MVCC history in the port against the JAX package's engine: AS OF
SYSTEM TIME, zone configurations, protected timestamps, MVCC GC, SHOW
JOBS and CANCEL JOB, and the node's maintenance loop.

Every case of the reference's tests/test_as_of.py, tests/test_zoneconfig.py,
the four cases of tests/test_protectedts.py without a backup and
tests/test_node_maintenance.py (its orphaned job an index backfill, since
BACKUP is not ported) runs the same statements through
``Engine(device="cpu")`` and the reference Engine (``Pair``): rows, tags
and error texts must be equal. Beyond them: AS OF through a CTE, a
derived table, a subquery, a ``Prepared`` and a streamed plan; GC beside
the OLTP lane's mirror; the KV plane's MVCC GC; and the one planned
divergence, an AS OF read below a table's GC threshold, which the port
refuses (the reference returns the collected history) and which is held
to a hand oracle. Last, TPC-H Q1 AS OF a time before the refresh pair
and Q1 over a backfilled DECIMAL column at sf 0.01 through kernel 1
(the port's plain version, the reference's Pallas kernel in interpret
mode): INT and DECIMAL exact, FLOAT8 within rel 1e-12.
"""

import time

import pytest

from cockroach_tpu_torch.exec.engine import Engine, EngineError
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
from cockroach_tpu_torch.storage.hlc import Timestamp
from tests.test_torch_dml import _same
from tests.test_torch_groupagg_large import reference_modules
from tests.test_torch_schema import Pair

REF_MODULES = ("cockroach_tpu.exec.engine", "cockroach_tpu.jobs",
               "cockroach_tpu.jobs.registry", "cockroach_tpu.catalog",
               "cockroach_tpu.catalog.descriptor", "cockroach_tpu.sql.types",
               "cockroach_tpu.kv.txn", "cockroach_tpu.storage.mvcc",
               "cockroach_tpu.storage.hlc", "cockroach_tpu.server",
               "cockroach_tpu.models.tpch")


@pytest.fixture(scope="module")
def ref():
    with reference_modules(*REF_MODULES) as mods:
        yield mods


@pytest.fixture
def pair(ref):
    p = Pair(ref)
    yield p
    p.close()


# -- tests/test_as_of.py ------------------------------------------------------
@pytest.fixture
def apair(pair):
    """test_as_of.py's fixture: ``mid`` lies between the first insert
    and the writes after it, on both engines' clocks."""
    pair.run("CREATE TABLE t (a INT PRIMARY KEY, b INT)")
    pair.run("INSERT INTO t VALUES (1,10),(2,20)")
    time.sleep(0.02)
    mids = pair.each(lambda e, _r: e.clock.now().wall)
    time.sleep(0.02)
    pair.run("UPDATE t SET b = 99 WHERE a = 1")
    pair.run("DELETE FROM t WHERE a = 2")
    pair.run("INSERT INTO t VALUES (3,30)")
    pair.mids = mids
    return pair


def _at(pair, sql_fmt, session=None, ordered=True):
    """``sql_fmt`` with {mid} filled by each engine's own timestamp."""
    from tests.test_torch_schema import _outcome_sorted
    from tests.test_torch_oltp_lane import _outcome
    fn = _outcome if ordered else _outcome_sorted
    ps, rs = pair.sessions[session]
    got = fn(pair.port, sql_fmt.format(mid=pair.mids[0]), ps)
    want = fn(pair.ref, sql_fmt.format(mid=pair.mids[1]), rs)
    assert got == want, (sql_fmt, got, want)
    return got


class TestAsOf:
    def test_scan_sees_old_state(self, apair):
        assert apair.rows("SELECT a, b FROM t", ordered=False) == \
            [(1, 99), (3, 30)]
        assert _at(apair, "SELECT a, b FROM t AS OF SYSTEM TIME {mid} "
                   "ORDER BY a")[1] == [(1, 10), (2, 20)]

    def test_aggregate_as_of(self, apair):
        assert _at(apair, "SELECT count(*), sum(b) FROM t "
                   "AS OF SYSTEM TIME {mid}")[1] == [(2, 30)]

    def test_fastpaths_as_of(self, apair):
        assert _at(apair, "SELECT b FROM t AS OF SYSTEM TIME {mid} "
                   "WHERE a = 1")[1] == [(10,)]
        assert _at(apair, "SELECT a FROM t AS OF SYSTEM TIME {mid} "
                   "WHERE a >= 1 ORDER BY a")[1] == [(1,), (2,)]

    def test_interval_form(self, apair):
        assert apair.rows("SELECT count(*) FROM t AS OF SYSTEM TIME "
                          "'-0.0001s'") == [(2,)]

    def test_guards(self, apair):
        apair.session("s")
        apair.run("BEGIN", "s")
        assert "transaction" in _at(
            apair, "SELECT * FROM t AS OF SYSTEM TIME {mid}", "s")[2]
        apair.run("ROLLBACK", "s")
        apair.err("SELECT * FROM t AS OF SYSTEM TIME "
                  "'2099-01-01 00:00:00'", "past")
        apair.err("SELECT * FROM t AS OF SYSTEM TIME 'bogus'", "parse")

    def test_alias_not_broken(self, apair):
        assert apair.rows("SELECT x.a FROM t AS x WHERE x.a = 3") == [(3,)]
        assert apair.rows("SELECT x.a FROM t x WHERE x.a = 3") == [(3,)]

    def test_cte_and_derived_inherit_as_of(self, apair):
        assert _at(apair, "WITH c AS (SELECT a, b FROM t) "
                   "SELECT * FROM c AS OF SYSTEM TIME {mid}",
                   ordered=False)[1] == [(1, 10), (2, 20)]
        assert _at(apair, "SELECT x.a, x.b FROM (SELECT a, b FROM t) x "
                   "AS OF SYSTEM TIME {mid}",
                   ordered=False)[1] == [(1, 10), (2, 20)]

    def test_subquery_pinned_to_as_of(self, apair):
        # max(b) was 20 then, 99 now: the inlined subquery reads then
        assert _at(apair, "SELECT a FROM t AS OF SYSTEM TIME {mid} "
                   "WHERE b = (SELECT max(b) FROM t)")[1] == [(2,)]

    def test_prepared_refresh_keeps_as_of(self, apair):
        got = apair.each(lambda e, r: e.prepare(
            f"SELECT count(*) FROM t AS OF SYSTEM TIME "
            f"{apair.mids[int(r)]}"))
        assert [p.run().rows for p in got] == [[(2,)]] * 2
        apair.run("INSERT INTO t VALUES (4,40)")  # a generation bump
        assert [p.run().rows for p in got] == [[(2,)]] * 2


class TestAsOfPaths:
    """AS OF through the port's other read paths."""

    def test_cte_join_and_group_as_of(self, apair):
        apair.run("CREATE TABLE u (a INT PRIMARY KEY, w INT)")
        apair.run("INSERT INTO u VALUES (1, 7), (2, 8), (3, 9)")
        # u did not exist at mid: its rows are invisible then
        assert _at(apair, "SELECT count(*) FROM u AS OF SYSTEM TIME "
                   "{mid}")[1] == [(0,)]
        assert _at(apair, "WITH c AS (SELECT a, b FROM t) SELECT c.a, "
                   "sum(c.b) FROM c GROUP BY c.a AS OF SYSTEM TIME {mid} "
                   "ORDER BY c.a".replace(
                       " GROUP BY c.a AS OF SYSTEM TIME {mid}",
                       " AS OF SYSTEM TIME {mid} GROUP BY c.a"))[1] == \
            [(1, 10), (2, 20)]

    def test_prepared_as_of_hits_the_exec_cache(self, apair):
        """A second AS OF run plans no new program and uploads nothing:
        the timestamp is a runtime argument of the compiled plan."""
        e = apair.port
        q = f"SELECT count(*), sum(b) FROM t AS OF SYSTEM TIME " \
            f"{apair.mids[0]}"
        assert e.execute(q).rows == [(2, 30)]
        miss, ndev = e.plan_cache["miss"], len(e._device_tables)
        hit = e.plan_cache["hit"]
        assert e.execute(q).rows == [(2, 30)]
        assert e.plan_cache["miss"] == miss
        assert e.plan_cache["hit"] == hit + 1
        assert len(e._device_tables) == ndev
        p = e.prepare(q)
        assert p.run().rows == [(2, 30)] and p.as_of.wall == apair.mids[0]

    def test_historical_group_bound_cached_per_generation(self, apair):
        """A GROUP BY read AS OF a historical timestamp is sized by the
        rows-per-group count over every version, computed once per
        generation: a repeated AS OF statement, and one at another
        historical timestamp (as AS OF '-10s' reads beside writes), pay
        for none of it, and the live rows keep an entry of their own. A
        join build's uniqueness at the snapshot stays exact."""
        from cockroach_tpu_torch.storage.columnstore import ColumnStore
        e = apair.port
        calls = {"mult": 0}
        mult = ColumnStore._key_max_multiplicity_locked

        def count_mult(*a, **kw):
            calls["mult"] += 1
            return mult(*a, **kw)
        q = ("SELECT b, count(*), sum(a) FROM t AS OF SYSTEM TIME {mid} "
             "GROUP BY b ORDER BY b")
        e.store._key_max_multiplicity_locked = count_mult
        try:
            first = _at(apair, q)
            assert calls["mult"] == 1, calls
            assert _at(apair, q) == first and calls["mult"] == 1
            later = e.execute(q.format(mid=apair.mids[0] + 1000)).rows
            assert later == first[1] and calls["mult"] == 1
            apair.rows("SELECT b, count(*), sum(a) FROM t GROUP BY b "
                       "ORDER BY b")
            assert calls["mult"] == 2   # the live rows' own entry
            assert _at(apair, q) == first and calls["mult"] == 2
            apair.run("INSERT INTO t VALUES (5, 50)")   # a new generation
            assert _at(apair, q) == first and calls["mult"] == 3
        finally:
            del e.store._key_max_multiplicity_locked
        assert first[1] == [(10, 1, 1), (20, 1, 2)]
        # a = 1 twice over every version, once at mid: the join's
        # measures at mid are exact, the GROUP BY's bound is not
        at = Timestamp(apair.mids[0], 0).to_int()
        assert e.store.keys_unique_for_read("t", ("a",), at)
        assert e.store.key_max_multiplicity("t", ("a",), at) == 1
        assert e.store.key_max_multiplicity(
            "t", ("a",), at, include_null_group=True) == 2

    def test_streamed_plan_as_of(self, apair):
        """A plan paged under a tiny budget reads at the AS OF
        timestamp too (the page skipping by MVCC window included)."""
        e = apair.port
        s = e.session()
        s.vars.set("streaming_page_rows", 2)
        e.settings.set("sql.exec.hbm_budget_bytes", 64)
        try:
            got = e.execute(f"SELECT count(*), sum(b) FROM t AS OF SYSTEM "
                            f"TIME {apair.mids[0]}", s).rows
            paging = e.last_exec.get("paging")
        finally:
            e.settings.set("sql.exec.hbm_budget_bytes", 12 << 30)
        assert got == [(2, 30)]
        assert paging and paging["route"] == "stream", paging


def _ttl0(pair):
    # (the two engines' SET CLUSTER SETTING tags differ: not compared)
    pair.each(lambda e, _r: e.execute(
        "SET CLUSTER SETTING kv.gc.ttl_seconds = 0"))


# -- tests/test_protectedts.py (without a backup) -----------------------------
@pytest.fixture
def ppair(pair):
    pair.run("CREATE TABLE t (a INT PRIMARY KEY, v INT)")
    pair.run("INSERT INTO t VALUES (1, 10), (2, 20)")
    pair.run("DELETE FROM t WHERE a = 2")  # a GC-able tombstone
    pair.ref.store.seal("t")
    _ttl0(pair)
    return pair


class TestProtectedTS:
    def test_gc_collects_without_protection(self, ppair):
        assert ppair.each(lambda e, _r: e.run_gc("t")) == (1, 1)

    def test_protection_blocks_gc(self, ppair):
        def case(e, _r):
            old = e.clock.now().to_int() - 10 ** 9
            rid = e.protectedts.protect(old, ["t"], meta="test")
            first = e.run_gc("t")
            e.protectedts.release(rid)
            return first, e.run_gc("t"), e.protectedts.records()
        assert ppair.each(case) == ((0, 1, []),) * 2

    def test_protection_scoped_by_table(self, ppair):
        ppair.run("CREATE TABLE other (a INT)")

        def case(e, _r):
            e.protectedts.protect(1, ["other"])
            return e.run_gc("t")
        assert ppair.each(case) == (1, 1)

    def test_cluster_wide_protection(self, ppair):
        def case(e, _r):
            e.protectedts.protect(1, [])  # empty: every table
            return e.run_gc("t"), e.protectedts.min_protected("t")
        assert ppair.each(case) == ((0, 1),) * 2


# -- tests/test_zoneconfig.py ---------------------------------------------------
@pytest.fixture
def zpair(pair):
    pair.run("CREATE TABLE t (a INT PRIMARY KEY)")
    pair.run("INSERT INTO t VALUES (1),(2)")
    pair.run("DELETE FROM t WHERE a = 2")
    pair.ref.store.seal("t")
    return pair


class TestZoneConfig:
    def test_defaults_shown(self, zpair):
        rows = dict(zpair.rows("SHOW ZONE CONFIGURATION FOR TABLE t"))
        assert rows["gc.ttl_seconds"] == "14400"

    def test_override_drives_gc(self, zpair):
        assert zpair.each(lambda e, _r: e.run_gc("t")) == (0, 0)
        zpair.run("ALTER TABLE t CONFIGURE ZONE USING gc.ttl_seconds = 0")
        assert zpair.each(lambda e, _r: e.run_gc("t")) == (1, 1)

    def test_options_merge(self, zpair):
        zpair.run("ALTER TABLE t CONFIGURE ZONE USING gc.ttl_seconds = 60")
        zpair.run("ALTER TABLE t CONFIGURE ZONE USING "
                  "range_max_bytes = 1024")
        assert dict(zpair.rows("SHOW ZONE CONFIGURATION FOR TABLE t")) == \
            {"gc.ttl_seconds": "60", "range_max_bytes": "1024"}

    def test_unknown_option_rejected(self, zpair):
        zpair.err("ALTER TABLE t CONFIGURE ZONE USING nope = 1",
                  "unknown zone option")

    def test_missing_table_rejected(self, zpair):
        zpair.err("ALTER TABLE ghost CONFIGURE ZONE USING "
                  "gc.ttl_seconds = 1", "does not exist")


# -- GC: the threshold, the lane's mirror, the KV plane ------------------------
class TestGC:
    def test_as_of_below_threshold_refused(self, apair):
        """The planned divergence, against a hand oracle: after a pass
        at ttl 0 the versions superseded before it are gone, so an AS OF
        read at ``mid`` is refused (the reference returns the collected
        history: the live rows only). Reads at and above the threshold,
        and present-time reads, are unchanged."""
        e = apair.port
        e.execute("SET CLUSTER SETTING kv.gc.ttl_seconds = 0")
        mid = apair.mids[0]
        before = e.execute(f"SELECT a, b FROM t AS OF SYSTEM TIME {mid} "
                           "ORDER BY a").rows
        assert before == [(1, 10), (2, 20)]
        assert e.run_gc("t") == 2          # (1, 10) and (2, 20)
        thr = e.store.table("t").gc_threshold
        assert mid < Timestamp.from_int(thr).wall
        for q in (f"SELECT a, b FROM t AS OF SYSTEM TIME {mid}",
                  f"SELECT b FROM t AS OF SYSTEM TIME {mid} WHERE a = 1",
                  f"SELECT a FROM t AS OF SYSTEM TIME {mid} WHERE a >= 1"):
            with pytest.raises(EngineError,
                               match="must be after replica GC threshold"):
                e.execute(q)
        p_at = Timestamp.from_int(thr).wall + 4096
        time.sleep(0.001)
        assert e.execute(f"SELECT a, b FROM t AS OF SYSTEM TIME {p_at} "
                         "ORDER BY a").rows == [(1, 99), (3, 30)]
        assert e.execute("SELECT a, b FROM t ORDER BY a").rows == \
            [(1, 99), (3, 30)]
        # the reference reads the collected history
        r = apair.ref
        r.execute("SET CLUSTER SETTING kv.gc.ttl_seconds = 0")
        assert r.run_gc("t") == 2
        assert r.execute(f"SELECT a, b FROM t AS OF SYSTEM TIME "
                         f"{apair.mids[1]} ORDER BY a").rows == []

    def test_gc_with_nothing_to_collect_takes_no_gate(self, zpair):
        """A pass that finds no version to drop records its threshold
        without the exclusive statement gate (so without flushing the
        lane's queued writes); one that finds some takes it."""
        e = zpair.port
        scopes = []
        run_scope = e._run_scope

        def counted(*a, **kw):
            scopes.append((a, kw))
            return run_scope(*a, **kw)
        e._run_scope = counted
        try:
            assert e.run_gc("t") == 0 and scopes == []
            thr = e.store.table("t").gc_threshold
            assert thr > 0
            e.execute("ALTER TABLE t CONFIGURE ZONE USING "
                      "gc.ttl_seconds = 0")
            scopes.clear()
            assert e.run_gc("t") == 1
            assert scopes == [(({"t"},), {"shared": False})]
            assert e.store.table("t").gc_threshold > thr
        finally:
            del e._run_scope

    def test_gc_beside_the_lane(self, pair):
        """Lane writes, a GC pass that compacts their versions, then the
        same keys read through the lane and through the compiled path."""
        pair.run("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, a INT8)")
        pair.run("INSERT INTO t VALUES " + ", ".join(
            f"({i}, {i})" for i in range(50)))
        for r in range(3):
            for k in range(0, 50, 5):
                pair.run(f"UPDATE t SET a = {1000 * r + k} WHERE k = {k}")
        pair.run("DELETE FROM t WHERE k = 49")
        assert pair.rows("SELECT a FROM t WHERE k = 10") == [(2010,)]
        hits = pair.port.lane_hits
        assert hits >= 30
        _ttl0(pair)
        got = pair.each(lambda e, _r: e.run_gc("t"))
        assert got[0] == got[1] == 31   # 3 x 10 updates and the delete
        for k in (0, 5, 10, 11, 45, 49):
            pair.run(f"SELECT a FROM t WHERE k = {k}")
        assert pair.port.lane_hits > hits          # through the lane
        assert pair.rows("SELECT k, a FROM t ORDER BY k") == [
            (k, 2000 + k if k % 5 == 0 else k) for k in range(49)]
        pair.run("UPDATE t SET a = -1 WHERE k = 5")
        assert pair.rows("SELECT sum(a) FROM t") == [
            (sum(2000 + k if k % 5 == 0 else k for k in range(49))
             - 2005 - 1,)]

    def test_kv_mvcc_gc_equals_reference(self, ref):
        """storage/mvcc.py gc against the reference's over the same
        history: shadowed versions and old tombstones go, an intent's
        versions stay."""
        from cockroach_tpu_torch.storage import mvcc as pm
        from cockroach_tpu_torch.storage.lsm import LSM
        rm, rh = ref[7], ref[8]
        out = []
        for mod, ts_cls, lsm in ((pm, Timestamp, LSM), (rm, rh.Timestamp,
                                                        None)):
            m = mod.MVCC(lsm() if lsm else None)
            ts = lambda w: ts_cls(w * 4096, 0)   # noqa: E731
            for i, k in enumerate((b"a", b"b", b"c")):
                m.put(k, ts(10 + i), b"v1")
                m.put(k, ts(20 + i), b"v2")
            m.put(b"b", ts(30), None)            # a tombstone
            txn = mod.TxnMeta(write_ts=ts(40), read_ts=ts(40))
            m.put(b"c", ts(40), b"v3", txn)      # an intent
            n = m.gc(b"a", b"z", ts(35))
            seen = [(k, m.get(k, ts(100), txn=txn)) for k in (b"a", b"b")]
            out.append((n, [(k, v.value if v else None) for k, v in seen],
                        m.get(b"a", ts(15)) is None))
        assert out[0] == out[1]
        # a: v1; b: v1, v2 and the tombstone; c's intent keeps it all
        assert out[0][0] == 4 and out[0][2]


# -- SHOW JOBS and CANCEL JOB ---------------------------------------------------
class TestJobs:
    def test_show_and_cancel(self, pair):
        pair.run("CREATE TABLE t (a INT PRIMARY KEY, b INT)")
        pair.run("INSERT INTO t VALUES (1, 1), (2, 2)")
        pair.run("CREATE INDEX bi ON t (b)")
        pair.run("ALTER TABLE t ADD COLUMN c INT DEFAULT 3")
        # a pending job no session has claimed yet, then cancelled
        pair.each(lambda e, r: e.jobs.create(
            "index-backfill", {"table": "t", "index": "nope"}))
        pair.run("CANCEL JOB 1")   # finished: unchanged
        pair.run("CANCEL JOB 3")
        assert pair.rows("SHOW JOBS") == [
            (1, "index-backfill", "succeeded", 1.0),
            (2, "schema-change", "succeeded", 1.0),
            (3, "index-backfill", "canceled", 0.0)]
        pair.err("CANCEL JOB 99", "does not exist")


# -- tests/test_node_maintenance.py ---------------------------------------------
def _wait(cond, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _orphan_index_job(e, mods, cat, registry, jobs_mod):
    """A unique index published WRITE_ONLY and its backfill job created
    by a session that died at once (its lease lapses immediately)."""
    desc = e.catalog.get_by_name("t")
    desc.indexes.append(cat.IndexDescriptor("ai", 2, ["a"], True,
                                            mods.WRITE_ONLY))
    e.leases.publish(desc)
    e._index_defs.pop("t", None)
    dead = registry.Registry(e.kv, session_id="dead", lease_seconds=0.01)
    dead.register(jobs_mod.schemachange.INDEX_BACKFILL_JOB,
                  lambda: jobs_mod.schemachange.IndexBackfillResumer(e))
    return dead.create(jobs_mod.schemachange.INDEX_BACKFILL_JOB,
                       {"table": "t", "index": "ai"})


class TestNodeMaintenance:
    def test_adopts_orphaned_job_and_runs_gc(self, ref):
        from cockroach_tpu_torch import catalog as pcat, jobs as pjobs
        from cockroach_tpu_torch.catalog import descriptor as pdesc
        from cockroach_tpu_torch.jobs import registry as preg
        from cockroach_tpu_torch.server import Node, NodeConfig
        rjobs, rreg, rcat, rdesc, rserver = ref[1], ref[2], ref[3], ref[4], \
            ref[9]
        out = []
        for node_cls, cfg_cls, mods in (
                (Node, NodeConfig, (pdesc, pcat, preg, pjobs)),
                (rserver.Node, rserver.NodeConfig, (rdesc, rcat, rreg,
                                                    rjobs))):
            kw = {"device": "cpu"} if node_cls is Node else {}
            with node_cls(cfg_cls(maintenance_interval=0.05, **kw)) as n:
                e = n.engine
                e.execute("CREATE TABLE t (k INT PRIMARY KEY, a INT)")
                e.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
                e.execute("DELETE FROM t WHERE k = 2")
                if node_cls is not Node:
                    e.store.seal("t")
                e.execute("ALTER TABLE t CONFIGURE ZONE USING "
                          "gc.ttl_seconds = 0")
                jid = _orphan_index_job(e, *mods)
                assert _wait(lambda: n.jobs.job(jid).status == "succeeded")
                # the GC pass collected the tombstoned version
                assert _wait(lambda: sum(
                    c.n for c in e.store.table("t").chunks) == 1)
                e._index_defs.clear()
                out.append((e.execute("SHOW INDEXES FROM t").rows,
                            e.execute("SELECT k, a FROM t").rows))
                try:
                    e.execute("INSERT INTO t VALUES (3, 10)")
                    out.append("ok")
                except Exception as exc:
                    out.append(str(exc))
        assert out[0] == out[2] and out[1] == out[3]
        assert "unique index 'ai'" in out[1]

    def test_maintenance_off_by_default(self):
        from cockroach_tpu_torch.server import Node, NodeConfig
        with Node(NodeConfig(device="cpu")) as n:
            assert n._maint_stop is None

    def test_maintenance_errors_are_counted(self):
        """A failing step is counted in node.maintenance.errors and
        logged, and the pass goes on (the reference swallows it)."""
        from cockroach_tpu_torch.server import Node, NodeConfig
        from cockroach_tpu_torch.utils import log
        n = Node(NodeConfig(device="cpu"))
        n.engine.execute("CREATE TABLE t (a INT PRIMARY KEY)")
        errs = n.engine.metrics.counter("node.maintenance.errors")

        def boom(_table):
            raise RuntimeError("gc exploded")
        n.engine.run_gc = boom
        sink = log.MemorySink()
        with log.scope(sink):
            n.maintain_once()
        assert errs.value() == 1
        assert any("gc exploded" in ln for ln in sink.lines())


# -- TPC-H Q1 history on kernel 1's path at sf 0.01 ----------------------------
SF = 0.01
ROWS = 20_000
RF_ORDERS = 60
FEE = "ALTER TABLE lineitem ADD COLUMN l_fee DECIMAL(15,2) NOT NULL " \
      "DEFAULT 0.05"
Q1_FEE = tpch.Q1.replace("count(*) AS count_order",
                         "count(*) AS count_order, sum(l_fee) AS sum_fee")


def _as_of(q: str, wall: int) -> str:
    return q.replace("FROM lineitem\n",
                     f"FROM lineitem AS OF SYSTEM TIME {wall}\n")


def _history_script(eng, mod):
    """Q1 before the refresh pair, its wall time, the pair (RF1 in a
    txn, RF2), then Q1 now and AS OF that time, the backfill and Q1
    with the new column: each step's outcome."""
    from tests.test_torch_dml import _outcome
    mod.load(eng, sf=SF, rows=ROWS, tables=("lineitem", "orders"))
    s = {"a": eng.session()}
    out = [_outcome(eng, s, "a", tpch.Q1)]
    time.sleep(0.01)
    t0 = eng.clock.now().wall
    time.sleep(0.01)
    orders, lineitem = tpch.gen_refresh(SF, n_orders=RF_ORDERS)
    keys = ", ".join(str(int(k)) for k in tpch.rf2_orderkeys(
        SF, n_orders=RF_ORDERS))
    eng.execute("BEGIN", s["a"])
    for st in (tpch.insert_statements("orders", orders)
               + tpch.insert_statements("lineitem", lineitem, batch=100)):
        eng.execute(st, s["a"])
    eng.execute("COMMIT", s["a"])
    eng.execute(f"DELETE FROM lineitem WHERE l_orderkey IN ({keys})")
    calls = []
    for sql in (tpch.Q1, _as_of(tpch.Q1, t0), _as_of(tpch.Q1, t0), FEE,
                Q1_FEE):
        c0 = tgl.PLAIN_CALLS
        out.append(_outcome(eng, s, "a", sql))
        calls.append(tgl.PLAIN_CALLS - c0)
    return out, calls


@pytest.fixture(scope="module")
def history_reference(ref):
    e = ref[0].Engine()
    try:
        return _history_script(e, ref[10])[0]
    finally:
        e.close()


def test_q1_history_on_kernel_path(history_reference):
    eng = Engine(device="cpu")
    eng.execute("SET pallas_groupagg = auto")
    got, calls = _history_script(eng, tpch)
    want = history_reference
    for g, w in zip(got, want):
        _same(g, w, tpch.Q1)
    pre, now, as_of, as_of2, _fee, fee = got
    assert as_of == pre and as_of2 == pre and now != pre
    # one kernel-1 launch (its plain version) per Q1, AS OF ones too
    assert calls == [1, 1, 1, 0, 1]
    # sum(l_fee) = 0.05 x count in every group, exactly
    for row in fee[1]:
        assert row[-1] == round(0.05 * row[-2], 2)


def test_chip_smoke_phase15_on_the_cpu():
    """chip_smoke.py's phase 15 at a small size on a CPU engine: every
    check it makes on the card but the kernel-vs-plain ones (the plain
    versions count their launches here)."""
    import chip_smoke
    out = chip_smoke.history_phase_alone(0.01, "cpu", rows=20_000)
    assert out["launches"] == {"groupagg_large": 20, "groupagg": 0}
    assert out["timed_launches"] == {"groupagg_large": 9, "groupagg": 0}
    assert [(r["misses"], r["htod_bytes"])
            for r in out["interval"]["runs"]] == [(1, 0), (0, 0)]
    assert out["gc"]["protected_pass_removed"] == 0
    assert out["gc"]["removed"] == (out["gc"]["versions_before"]
                                    - out["gc"]["versions_after"]) > 0
    assert "must be after replica GC threshold" in out["as_of_refused"]
    assert [j[1:3] for j in out["jobs"]] == [
        ("index-backfill", "succeeded")] * 2 + [("index-backfill", "failed")]


@pytest.mark.parametrize("kind", ["codes", "wide", "bool", "float"])
def test_group_bound_matches_a_count(kind):
    """The rows-per-group bound, by one bincount over small integer
    keys or by a sort otherwise, equals a plain count of the keys,
    NULL keys forming one group when asked, at a snapshot and over
    every version."""
    import collections

    import numpy as np
    rng = np.random.default_rng(7)
    e = Engine(device="cpu")
    typ = {"codes": "INT", "wide": "INT", "bool": "BOOL",
           "float": "FLOAT8"}[kind]
    e.execute(f"CREATE TABLE g (id INT PRIMARY KEY, a {typ}, b INT)")
    n = 3000
    hi = {"codes": 5, "wide": 1 << 40, "bool": 2, "float": 7}[kind]
    a = rng.integers(0, hi, n)
    b = rng.integers(-3, 4, n)

    def lit(v):
        if kind == "bool":
            return "true" if v else "false"
        return f"{v}.5" if kind == "float" else str(v)
    rows = [f"({i}, {'NULL' if i % 97 == 0 else lit(a[i])}, {b[i]})"
            for i in range(n)]
    e.execute("INSERT INTO g VALUES " + ", ".join(rows))
    mid = e.clock.now().to_int()
    e.execute("DELETE FROM g WHERE id % 5 = 0")
    now = e.clock.now().to_int()
    keys = [(None if i % 97 == 0 else a[i], b[i]) for i in range(n)]
    for at, live in ((mid, range(n)),
                     (now, [i for i in range(n) if i % 5])):
        for with_null in (False, True):
            c = collections.Counter(keys[i] for i in live
                                    if with_null or keys[i][0] is not None)
            if with_null:
                c[None] = sum(1 for i in live if keys[i][0] is None)
            got = e.store._key_max_multiplicity_locked(
                e.store.table("g"), ("a", "b"), at, with_null)
            assert got == max(c.values()), (kind, at == mid, with_null)
