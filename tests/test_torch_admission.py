"""Admission control in the port: the controller, the engine's wiring,
the tenant quota plane and the front door's rejection.

The controller cases are tests/test_admission.py's, each run against
the port's ``utils/admission.py`` and the reference's (which imports no
JAX). Through ``Engine(device="cpu")``: statements admit and release,
concurrent sessions are all admitted, tenant slots queue only the
tenant at its cap, a noisy tenant cannot evict a neighbour's plan-cache
entries, and the ``admission.*`` metrics move as the reference Engine's
do over the same statements. Over the wire, a shed statement fails with
SQLSTATE 53300 and the session lives on.
"""

import importlib
import threading
import time

import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.server.miniclient import MiniClient, PgError
from cockroach_tpu_torch.server.pgwire import PgServer, _sqlstate
from cockroach_tpu_torch.utils.admission import AdmissionRejected
from tests.test_torch_groupagg_large import reference_modules


@pytest.fixture(params=["port", "reference"])
def adm(request):
    return importlib.import_module(
        {"port": "cockroach_tpu_torch.utils.admission",
         "reference": "cockroach_tpu.utils.admission"}[request.param])


class TestAdmissionController:
    def test_grants_up_to_slots(self, adm):
        a = adm.AdmissionController(slots=2)
        a.acquire()
        a.acquire()
        assert a.depth() == 0
        a.release()
        a.release()

    def test_queue_orders_by_priority(self, adm):
        a = adm.AdmissionController(slots=1)
        a.acquire()  # saturate
        order = []

        def worker(prio, name):
            a.acquire(priority=prio, timeout=5)
            order.append(name)
            a.release()

        threads = [threading.Thread(target=worker, args=("low", "lo")),
                   threading.Thread(target=worker, args=("high", "hi"))]
        threads[0].start()
        time.sleep(0.05)  # lo queues first
        threads[1].start()
        time.sleep(0.05)  # hi queues second, but outranks
        a.release()
        for t in threads:
            t.join(timeout=5)
        assert order == ["hi", "lo"]

    def test_bounded_queue_rejects(self, adm):
        a = adm.AdmissionController(slots=1, max_queue=0)
        a.acquire()
        with pytest.raises(adm.AdmissionRejected, match="queue full"):
            a.acquire()
        a.release()

    def test_wait_timeout_rejects(self, adm):
        a = adm.AdmissionController(slots=1, max_queue=4)
        a.acquire()
        with pytest.raises(adm.AdmissionRejected, match="exceeded"):
            a.acquire(timeout=0.05)
        a.release()

    def test_slot_handoff(self, adm):
        a = adm.AdmissionController(slots=1)
        a.acquire()
        got = []
        th = threading.Thread(
            target=lambda: (a.acquire(timeout=5), got.append(1)))
        th.start()
        time.sleep(0.05)
        a.release()
        th.join(timeout=5)
        assert got == [1]
        a.release()


class TestWeightedFairQueue:
    def test_heavier_tenant_gets_more_early_grants(self, adm):
        a = adm.AdmissionController(slots=1)
        a.set_weight("gold", 4.0)
        a.set_weight("bronze", 1.0)
        a.acquire()  # saturate
        order = []

        def worker(tenant):
            a.acquire(timeout=10, tenant=tenant)
            order.append(tenant)
            a.release()

        threads = []
        for i in range(8):  # alternate arrivals: g b g b ...
            t = threading.Thread(
                target=worker, args=("gold" if i % 2 == 0 else "bronze",))
            t.start()
            threads.append(t)
            time.sleep(0.03)
        a.release()  # grants cascade via the release handoff
        for t in threads:
            t.join(timeout=10)
        # virtual finish times: gold at 1/4 spacing, bronze at 1/1 —
        # gold's four waiters all finish by vft 1.0, so they dominate
        # the early grants despite the interleaved arrival order
        assert order[:4].count("gold") >= 3, order

    def test_priority_still_outranks_weights(self, adm):
        a = adm.AdmissionController(slots=1)
        a.set_weight("whale", 100.0)
        a.acquire()
        order = []

        def worker(prio, tenant, name):
            a.acquire(priority=prio, timeout=10, tenant=tenant)
            order.append(name)
            a.release()

        t1 = threading.Thread(target=worker, args=("normal", "whale", "w"))
        t1.start()
        time.sleep(0.05)
        t2 = threading.Thread(target=worker, args=("high", "minnow", "m"))
        t2.start()
        time.sleep(0.05)
        a.release()
        t1.join(timeout=10)
        t2.join(timeout=10)
        assert order == ["m", "w"]  # strict tiers above fair shares


class TestLoadShed:
    def test_low_priority_sheds_at_queue_depth(self, adm):
        a = adm.AdmissionController(slots=1, max_queue=8)
        a.shed_queue_depth = 1
        a.acquire()
        th = threading.Thread(
            target=lambda: (a.acquire(timeout=10), a.release()))
        th.start()
        time.sleep(0.05)  # one waiter queued: at the shed threshold
        with pytest.raises(adm.AdmissionRejected, match="load shed"):
            a.acquire(priority="low", timeout=10)
        assert a.shed == 1 and a.rejected == 1
        a.release()
        th.join(timeout=10)
        a.release()

    def test_shed_on_wait_ewma(self, adm):
        a = adm.AdmissionController(slots=1, max_queue=8)
        a.shed_wait_seconds = 0.5
        a._wait_ewma = 2.0  # recent admits waited way over threshold
        a.acquire()
        with pytest.raises(adm.AdmissionRejected, match="load shed"):
            a.acquire(priority="low", timeout=10)
        # normal priority is never shed, only queued
        with pytest.raises(adm.AdmissionRejected, match="exceeded"):
            a.acquire(priority="normal", timeout=0.05)
        a.release()

    def test_shed_disabled_by_default(self, adm):
        a = adm.AdmissionController(slots=1, max_queue=8)
        a.acquire()
        with pytest.raises(adm.AdmissionRejected, match="exceeded"):
            a.acquire(priority="low", timeout=0.05)  # times out, no shed
        assert a.shed == 0
        a.release()

    def test_shed_on_movement_wait_p99(self, adm):
        # exec.movement.wait_seconds p99 over the shed threshold:
        # the interconnect is saturated, low-priority work sheds even
        # while the grant-wait EWMA still looks healthy
        a = adm.AdmissionController(slots=1, max_queue=8)
        a.shed_wait_seconds = 0.5
        a.movement_wait_p99 = lambda: 0.9
        a.acquire()
        assert a._wait_ewma == 0.0  # the EWMA alone would not shed
        with pytest.raises(adm.AdmissionRejected, match="load shed"):
            a.acquire(priority="low", timeout=10)
        assert a.shed == 1
        # normal priority queues through the pressure, never sheds
        with pytest.raises(adm.AdmissionRejected, match="exceeded"):
            a.acquire(priority="normal", timeout=0.05)
        a.release()

    def test_movement_p99_below_threshold_admits(self, adm):
        a = adm.AdmissionController(slots=1, max_queue=8)
        a.shed_wait_seconds = 0.5
        a.movement_wait_p99 = lambda: 0.1
        a.acquire()
        with pytest.raises(adm.AdmissionRejected, match="exceeded"):
            a.acquire(priority="low", timeout=0.05)  # queued, no shed
        assert a.shed == 0
        a.release()

    def test_broken_movement_signal_does_not_wedge(self, adm):
        def boom():
            raise RuntimeError("histogram gone")
        a = adm.AdmissionController(slots=1, max_queue=8)
        a.shed_wait_seconds = 0.5
        a.movement_wait_p99 = boom
        a.acquire()
        with pytest.raises(adm.AdmissionRejected, match="exceeded"):
            a.acquire(priority="low", timeout=0.05)
        assert a.shed == 0
        a.release()

class TestTimeoutAudit:
    def test_timed_out_waiter_leaves_the_queue(self, adm):
        a = adm.AdmissionController(slots=1, max_queue=4)
        a.acquire()
        with pytest.raises(adm.AdmissionRejected, match="exceeded"):
            a.acquire(timeout=0.05)
        assert a.depth() == 0  # stale waiter must not absorb a grant
        a.release()
        a.acquire(timeout=0.5)  # slot is immediately grantable
        a.release()

    def test_release_under_concurrent_timeouts_loses_no_slot(self, adm):
        a = adm.AdmissionController(slots=2, max_queue=32)
        deadline = time.monotonic() + 1.0
        errs = []

        def hammer():
            while time.monotonic() < deadline:
                try:
                    a.acquire(timeout=0.005)
                except adm.AdmissionRejected:
                    continue
                except Exception as e:  # pragma: no cover
                    errs.append(e)
                    return
                time.sleep(0.002)
                a.release()

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs
        assert a.depth() == 0
        # both slots survived the timeout/release races
        a.acquire(timeout=1.0)
        a.acquire(timeout=1.0)
        a.release()
        a.release()

    def test_counters_account_every_outcome(self, adm):
        a = adm.AdmissionController(slots=1, max_queue=4)
        a.acquire()
        with pytest.raises(adm.AdmissionRejected):
            a.acquire(timeout=0.05)
        a.release()
        a.acquire()
        a.release()
        assert a.admitted == 2 and a.rejected == 1 and a.queued >= 1


def test_engine_wires_movement_p99():
    e = Engine(device="cpu")
    assert e.admission.movement_wait_p99 is not None
    assert e.admission.movement_wait_p99() == 0.0
    e.movement.m_wait.observe(3.0)
    assert e.admission.movement_wait_p99() > 0.0


def test_pgwire_sqlstate_for_admission_rejection():
    assert _sqlstate(AdmissionRejected("shed")) == "53300"


class TestEngineAdmission:
    def test_statements_admit_and_release(self):
        e = Engine(device="cpu")
        e.execute("CREATE TABLE t (a INT)")
        for i in range(5):
            e.execute(f"INSERT INTO t VALUES ({i})")
        assert e.admission.depth() == 0
        assert e.admission.admitted >= 6

    def test_concurrent_sessions_all_admitted(self):
        e = Engine(device="cpu")
        e.execute("CREATE TABLE t (a INT)")
        errs = []

        def worker(i):
            try:
                e.execute(f"INSERT INTO t VALUES ({i})")
            except Exception as ex:  # pragma: no cover
                errs.append(ex)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs
        assert e.execute("SELECT count(*) FROM t").rows == [(12,)]
        assert e.admission.depth() == 0

    def test_tenant_slots_queue_only_the_tenant_at_its_cap(self):
        """sql.admission.tenant.slots = 1: with the noisy tenant's slot
        held, its next statement waits while another tenant's runs; the
        release lets it in."""
        e = Engine(device="cpu")
        e.execute("CREATE TABLE t (a INT)")
        e.execute("INSERT INTO t VALUES (1), (2)")
        e.execute("SET CLUSTER SETTING sql.admission.tenant.slots = 1")
        assert e.admission.tenant_slots == 1
        noisy, quiet = e.session(), e.session()
        e.execute("SET application_name = 'noisy'", noisy)
        e.execute("SET application_name = 'quiet'", quiet)
        e.admission.acquire(tenant="noisy")
        done = []
        th = threading.Thread(target=lambda: done.append(
            e.execute("SELECT count(*) FROM t", noisy).rows))
        th.start()
        deadline = time.monotonic() + 5
        while e.admission.depth() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert e.admission.depth() == 1 and not done
        assert e.execute("SELECT sum(a) FROM t", quiet).rows == [(3,)]
        waits = e.metrics.snapshot()["admission.tenant.slot_waits"]
        assert waits == 1
        e.admission.release(tenant="noisy")
        th.join(timeout=5)
        assert done == [[(2,)]]
        assert e.admission.tenant_usage() == {}

    def test_hbm_estimate_uses_the_ports_reckoning(self):
        e = Engine(device="cpu")
        e.execute("CREATE TABLE t (a INT, b FLOAT8)")
        e.execute("INSERT INTO t VALUES (1, 1.5)")
        from cockroach_tpu_torch.sql import parser
        est = e._stmt_hbm_estimate(parser.parse("SELECT a FROM t"))
        assert est == e._table_device_bytes(e.store.table("t"), None) > 0
        e.execute("SET CLUSTER SETTING "
                  "sql.admission.tenant.hbm_fraction = 0.5")
        assert e.admission.tenant_hbm_bytes == (12 << 30) // 2
        assert e.execute("SELECT a FROM t").rows == [(1,)]
        assert e.admission.tenant_usage() == {}


def test_noisy_tenant_cannot_evict_neighbor_plans():
    e = Engine(device="cpu")
    e.settings.set("sql.exec.plan_cache.tenant_budget", 4)
    quiet = e.session()
    quiet.vars.set("application_name", "t_quiet")
    noisy = e.session()
    noisy.vars.set("application_name", "t_noisy")
    e.execute("SELECT 1 + 0", session=quiet)
    assert "SELECT 1 + 0" in e._parse_cache
    for i in range(20):
        e.execute(f"SELECT {i} + 1000", session=noisy)
    counts = e._parse_cache.tenant_entry_counts()
    assert counts.get("t_noisy", 0) <= 4
    assert "SELECT 1 + 0" in e._parse_cache
    assert e._parse_cache.tenant_evictions.get("t_noisy", 0) >= 16
    assert e._parse_cache.tenant_evictions.get("t_quiet", 0) == 0
    snap = e.metrics.snapshot()
    assert snap["admission.tenant.plan_evictions"] >= 16


@pytest.fixture(scope="module")
def tpch_engine():
    from cockroach_tpu_torch.models import tpch
    e = Engine(device="cpu")
    tpch.load(e, sf=0.01, rows=20_000, tables=tpch.ALL_TABLES)
    e.execute("CREATE VIEW supp_rev AS SELECT l_suppkey, "
              "sum(l_extendedprice) AS r FROM lineitem GROUP BY l_suppkey")
    return e


def _parse_cache_cases():
    from cockroach_tpu_torch.models import tpch
    cases = dict(tpch.QUERIES, q1f=tpch.Q1F)
    cases["view"] = "SELECT max(r) FROM supp_rev"
    cases["cte"] = ("WITH t AS (SELECT l_suppkey AS s FROM lineitem) "
                    "SELECT count(*) FROM t")
    return sorted(cases.items())


@pytest.mark.parametrize("name,sql", _parse_cache_cases(),
                         ids=[n for n, _ in _parse_cache_cases()])
def test_parse_cache_shares_plain_selects_unchanged(tpch_engine, name, sql):
    """A plain SELECT's cached AST is handed out itself, and running it
    (views, decorrelation, the planner) leaves it equal to a fresh parse;
    a SELECT with CTEs or derived tables gets a copy each time."""
    from cockroach_tpu_torch.sql import parser
    e = tpch_engine
    first = e.execute(sql).rows
    assert e.execute(sql).rows == first
    cached = e._parse_cache.get(sql)
    assert cached == parser.parse(sql)
    shared = not cached.ctes and not e._has_derived(cached)
    assert (e._parse_cached(sql, "") is cached) == shared
    assert e._parse_cache.get(sql) == parser.parse(sql)


def test_exec_cache_is_tenant_partitioned():
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (a INT, b INT)")
    e.execute("INSERT INTO t VALUES (1, 2), (3, 4)")
    e.settings.set("sql.exec.plan_cache.tenant_budget", 2)
    quiet, noisy = e.session(), e.session()
    quiet.vars.set("application_name", "q")
    noisy.vars.set("application_name", "n")
    e.execute("SELECT sum(a) FROM t", quiet)
    for i in range(6):
        e.execute(f"SELECT sum(a + {i}) AS s{i} FROM t", noisy)
    counts = e._exec_cache.tenant_entry_counts()
    assert counts["n"] <= 2 and counts["q"] == 1
    hits = e.plan_cache["hit"]
    assert e.execute("SELECT sum(a) FROM t", quiet).rows == [(4,)]
    assert e.plan_cache["hit"] == hits + 1


SCRIPT = ["CREATE TABLE t (k INT PRIMARY KEY, s STRING)",
          "INSERT INTO t VALUES (1, 'a'), (2, 'b')",
          "SELECT count(*) FROM t", "SELECT s FROM t WHERE k = 2",
          "UPDATE t SET s = 'c' WHERE k = 1", "SELECT bogus FROM t",
          "SELECT s FROM t ORDER BY k"]


def _admission_deltas(eng):
    def snap():
        m = eng.metrics.snapshot()
        return {k: m[k] for k in ("admission.admitted", "admission.queued",
                                  "admission.rejected",
                                  "admission.tenant.slot_waits")}
    before = snap()
    for sql in SCRIPT:
        try:
            eng.execute(sql)
        except Exception:
            pass
    after = snap()
    return {k: after[k] - before[k] for k in after}


def test_admission_metrics_move_as_the_reference():
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        ref = jeng.Engine()
        try:
            want = _admission_deltas(ref)
        finally:
            ref.close()
    got = _admission_deltas(Engine(device="cpu"))
    assert got == want
    assert got["admission.admitted"] == len(SCRIPT)


def test_shed_statement_gets_53300_over_the_wire():
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (a INT)")
    srv = PgServer(e, frontend="threads").start()
    try:
        c = MiniClient(*srv.addr, timeout=5.0)
        try:
            c.query("SET admission_priority = 'low'")
            e.settings.set("sql.admission.shed.wait_seconds", 0.5)
            e.admission.slots = 1
            e.admission.acquire()            # the only slot is held
            e.admission._wait_ewma = 5.0     # recent grants waited long
            with pytest.raises(PgError) as ei:
                c.query("SELECT count(*) FROM t")
            assert ei.value.sqlstate == "53300"
            e.admission.release()
            e.admission._wait_ewma = 0.0
            assert c.query("SELECT count(*) FROM t")[1] == [(0,)]
        finally:
            c.close()
        assert e.metrics.snapshot()["admission.rejected"] == 1
    finally:
        srv.stop()
