"""Distributed execution over a CPU shard mesh against the reference's
8-device host mesh (tests/test_distributed.py's cases, and the kernels'
per-shard routes).

The reference ``Engine()`` runs on the 8 virtual devices conftest
forces, so it answers through its distributed path; the port's engine
runs on ``make_mesh(devices=[cpu] * 8)``. Both scan one store: the
reference's is carried into the port (storage/transfer.py). Each query
is also run by the port with ``distsql = off``. INT, DECIMAL, STRING and
DATE results are bit-exact; FLOAT8 within rel 1e-9 (merges add in
another order), and the small-G kernel's f32 sums within rel 1e-5.

Routes per shard, as under shard_map: kernel 1 (the large-G kernel)
runs once per shard where each shard holds at least AUTO_MIN_ROWS rows
(8 shards of 8,192 rows of a 65,536-row table), and the plain route
where a shard holds fewer (8 shards of 2,048 rows of a 16,384-row
table, which on one device takes the kernel); kernel 2 under ``on``
once per shard. A GROUP BY whose group sums pass 2^31 only across the
shards is exact: the port's limb width comes from the global row bound
(the reference's summed int32 limbs wrap there; documented below).

Faults: an injected CollectiveFault re-runs the statement on one device
and counts the retry; a shard that raises ends the statement at once,
releasing the others; a shard that never arrives times out. Every wait
has a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.exec import coldstart
from cockroach_tpu_torch.exec.compile import (AUTO_MIN_ROWS, ExecError,
                                              ExecParams, compile_plan)
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.ops import agg as aggops
from cockroach_tpu_torch.ops.cuda import groupagg as tg
from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
from cockroach_tpu_torch.parallel import collective, distagg
from cockroach_tpu_torch.parallel.collective import AXIS
from cockroach_tpu_torch.parallel.mesh import make_mesh
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from cockroach_tpu_torch.utils.metric import MetricRegistry

ROWS = 20_000
CPU8 = [torch.device("cpu")] * 8
FLOAT_REL = 1e-9

HAVING = ("SELECT l_returnflag, count(*) AS n, max(l_quantity) AS mx "
          "FROM lineitem WHERE l_quantity > 10 GROUP BY l_returnflag "
          "HAVING count(*) > 0 ORDER BY l_returnflag DESC")
MINMAX = ("SELECT min(l_shipdate) AS lo, max(l_shipdate) AS hi, "
          "avg(l_quantity) AS aq FROM lineitem")
# each shard of k1 holds 8,192 rows, of k2 2,048 (AUTO_MIN_ROWS: 4,096)
KQ = "SELECT g, count(*) AS c, sum(v) AS s, sum(d) AS sd FROM {t} " \
     "GROUP BY g ORDER BY g"
K_DDL = "CREATE TABLE {t} (g STRING, v INT8, d DECIMAL(12,2))"
K_ROWS = {"k1": 1 << 16, "k2": 1 << 14}
# 2^18 rows of 16,383: one group's sum is 4,293,066,852, past 2^31, while
# each shard's 32,768 rows sum below it
LW_ROWS = 1 << 18
LW_DDL = "CREATE TABLE lw (g STRING, v INT8)"
LW = "SELECT g, sum(v) AS s, count(*) AS c FROM lw GROUP BY g ORDER BY g"
REFUSED = {
    "distinct": ("SELECT count(DISTINCT l_suppkey) AS n FROM lineitem",
                 "DISTINCT aggregate"),
    "window": ("SELECT l_orderkey, row_number() OVER (PARTITION BY "
               "l_returnflag ORDER BY l_orderkey) AS rn FROM lineitem "
               "WHERE l_orderkey < 40 ORDER BY l_orderkey, rn",
               "root is not an aggregate"),
    "non_aggregate": ("SELECT l_orderkey FROM lineitem "
                      "ORDER BY l_orderkey LIMIT 3",
                      "root is not an aggregate"),
}


def _k_columns(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"g": np.asarray(["a", "b", "c", "d", "e"], dtype=object)[
                rng.integers(0, 5, n)],
            "v": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
            "d": rng.integers(0, 10_000_000, n).astype(np.int64)}


def _lw_columns() -> dict:
    g = np.array(["a"] * (LW_ROWS - 100) + ["b"] * 100, dtype=object)
    return {"g": g, "v": np.full(LW_ROWS, 16383, dtype=np.int64)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's rows per (query, mode) on its 8-device mesh and
    with distsql = off, its large-G and small-G kernel builds, the
    distribution decisions of REFUSED, and its store as arrays."""
    # imported here: the card-only case below runs without the
    # reference (and where another package named `tests` is installed)
    from tests.test_torch_engine import _store_arrays
    from tests.test_torch_groupagg_large import reference_modules
    # a cold-start root of its own: the session's shared root may hold
    # a tuning table another test planted, whose tile point changes the
    # reference's limb widths (tests/test_coldstart.py)
    mp = pytest.MonkeyPatch()
    mp.setenv("COCKROACH_TPU_COMPILE_CACHE_DIR",
              str(tmp_path_factory.mktemp("reference-coldstart")))
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch",
                           "cockroach_tpu.ops.pallas.groupagg",
                           "cockroach_tpu.parallel.distagg",
                           "cockroach_tpu.parallel.shuffle",
                           "cockroach_tpu.sql.parser",
                           "cockroach_tpu.sql.planner") as (
            jeng, jtpch, jpg, jdist, jshuf, jparser, jplanner):
        # the process-wide fault hooks healed, whatever earlier tests in
        # this process left; and every dispatch on the full mesh (under
        # `auto` a queue the reference finds non-empty, such as a stale
        # shutdown entry in its process-wide dispatcher, would route it
        # to a sub-mesh)
        jdist.install_ici_faults(None)
        jshuf.install_link_faults(None, 0)
        e = jeng.Engine()
        e.settings.set("sql.exec.submesh.size", "off")
        try:
            assert e.mesh is not None and e.mesh.size == 8
            jtpch.load(e, sf=0.01, rows=ROWS)
            for t, n in K_ROWS.items():
                e.execute(K_DDL.format(t=t))
                e.store.insert_columns(t, _k_columns(n, n), e.clock.now())
            e.execute(LW_DDL)
            e.store.insert_columns("lw", _lw_columns(), e.clock.now())
            for t in (*K_ROWS, "lw"):
                e.execute(f"ANALYZE {t}")
            runs = [(q, sql, "auto") for q, sql in
                    (("q1", jtpch.Q1), ("q6", jtpch.Q6), ("q14", jtpch.Q14),
                     ("having", HAVING), ("minmax", MINMAX), ("lw", LW))]
            runs += [(t, KQ.format(t=t), "auto") for t in K_ROWS]
            runs += [("q1f", tpch.Q1F, "on"), ("q6f", tpch.Q6F, "on")]
            runs += [(q, sql, "auto") for q, (sql, _) in REFUSED.items()]
            out = {}
            calls = e.metrics.counter("exec.allreduce.calls")
            for q, sql, mode in runs:
                for dist in ("auto", "off"):
                    s = e.session()
                    s.vars.set("distsql", dist)
                    s.vars.set("pallas_groupagg", mode)
                    b0 = {k: jpg.BUILDS.value(k) for k in ("small", "large")}
                    c0 = calls.value()
                    rows = e.execute(sql, session=s).rows
                    out[q, dist] = {"rows": rows,
                                    "dispatches": calls.value() - c0, **{
                                        f"{k}_builds":
                                        jpg.BUILDS.value(k) - b0[k]
                                        for k in b0}}
            decisions = {}
            for q, (sql, _) in REFUSED.items():
                node, _ = jplanner.Planner(e.catalog_view()).plan_select(
                    jparser.parse(sql))
                d = jdist.analyze(node)
                decisions[q] = (d.ok, d.reason)
            arrays = _store_arrays(e.store, {
                **jtpch.DDL, **{t: K_DDL.format(t=t) for t in K_ROWS},
                "lw": LW_DDL})
        finally:
            e.close()
            mp.undo()
    return out, decisions, arrays


@pytest.fixture(scope="module")
def port(reference):
    _, _, arrays = reference
    e = Engine(device="cpu", store=store_from_arrays(arrays),
               mesh=make_mesh(CPU8))
    yield e
    e.close()


def _run(eng, sql, dist="auto", mode="auto"):
    s = eng.session()
    eng.execute(f"SET distsql = {dist}", s)
    eng.execute(f"SET pallas_groupagg = {mode}", s)
    calls = eng.metrics.counter("exec.allreduce.calls")
    c0 = calls.value()
    rows = eng.execute(sql, s).rows
    return rows, calls.value() - c0


def _assert_rows(got, want, rel=FLOAT_REL):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=rel), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


def test_mesh_is_8(port):
    assert port.mesh is not None and port.mesh.size == 8
    assert port.mesh.devices == tuple(CPU8)


@pytest.mark.parametrize("q", ["q1", "q6", "q14"])
def test_tpch_matches_reference_and_local(reference, port, q):
    ref, _, _ = reference
    sql = tpch.QUERIES[q]
    dist, calls = _run(port, sql)
    assert calls == 1  # one distributed dispatch
    local, lcalls = _run(port, sql, dist="off")
    assert lcalls == 0
    _assert_rows(dist, ref[q, "auto"]["rows"])
    _assert_rows(dist, local)
    _assert_rows(local, ref[q, "off"]["rows"])


def test_grouped_with_having_and_sort(reference, port):
    ref, _, _ = reference
    dist, calls = _run(port, HAVING)
    assert calls == 1
    assert dist == ref["having", "auto"]["rows"]
    assert dist == _run(port, HAVING, dist="off")[0]


def test_min_max_collectives(reference, port):
    ref, _, _ = reference
    dist, calls = _run(port, MINMAX)
    assert calls == 1
    want = ref["minmax", "auto"]["rows"]
    assert dist[0][:2] == want[0][:2]
    assert dist[0][2] == pytest.approx(want[0][2], rel=1e-12)
    assert dist[0][:2] == _run(port, MINMAX, dist="off")[0][0][:2]


@pytest.mark.parametrize("q", sorted(REFUSED))
def test_decision_refusals(reference, port, q):
    """DISTINCT, a window and a non-aggregate root run on one device:
    the port's decision and its reason are the reference's, and so are
    the rows."""
    ref, decisions, _ = reference
    sql, reason = REFUSED[q]
    node = port._plan_sql(sql, port.session())[0]
    d = distagg.analyze(node)
    assert (d.ok, d.reason) == decisions[q] == (False, reason)
    rows, calls = _run(port, sql)
    assert calls == 0
    assert rows == ref[q, "auto"]["rows"]


def test_analyze_accepts_q14_and_hash_shapes(port):
    d = distagg.analyze(port._plan_sql(tpch.Q14, port.session())[0])
    assert d.ok and "lineitem" in d.sharded and "part" in d.replicated
    d = distagg.analyze(port._plan_sql(
        "SELECT l_orderkey, count(*) FROM lineitem GROUP BY l_orderkey",
        port.session())[0])
    assert d.ok


@pytest.mark.parametrize("q,want", [("distinct", False),
                                    ("non_aggregate", True)])
def test_partials_replannable(port, q, want):
    """DISTINCT partials are sets: such a plan's partials cannot be
    recomputed under another row assignment; a non-aggregate read holds
    no partial state (the reference's rule)."""
    node = port._plan_sql(REFUSED[q][0], port.session())[0]
    assert distagg.partials_replannable(node) is want
    assert distagg.partials_replannable(
        port._plan_sql(tpch.Q1, port.session())[0])


def test_kernel_counts_lose_no_update_under_threads():
    """The kernels' call counts are bumped from shard threads: 16
    threads x 50 calls at a switch interval of 1 us count 800."""
    import sys
    gid = torch.zeros(128, dtype=torch.int32)
    sel = torch.ones(128, dtype=torch.bool)
    args = (gid, sel, (sel,), (sel,), 1, (tg.COUNT,))
    before = tg.PLAIN_CALLS
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda: [
            tg.dense_group_aggregate(*args) for _ in range(50)])
            for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(prev)
    assert tg.PLAIN_CALLS - before == 800


@pytest.mark.parametrize("sql,what", [
    (REFUSED["window"][0], "window functions"),
    (REFUSED["distinct"][0], "DISTINCT aggregates")])
def test_compile_guards_refuse_on_a_mesh(port, sql, what):
    """The plan compiler's own guards (the reference's), behind the
    decision's: a window or a DISTINCT aggregate never compiles for a
    shard axis."""
    node, meta = port._plan_sql(sql, port.session())[:2]
    compile_plan(node, ExecParams(), meta)  # fine on one device
    with pytest.raises(ExecError, match=what):
        compile_plan(node, ExecParams(axis_name=AXIS, n_shards=8), meta)


def test_kernel1_once_per_shard(reference, port):
    """65,536 rows on 8 shards: 8,192 a shard, at least AUTO_MIN_ROWS,
    so kernel 1 runs on every shard (its plain version here: one call a
    shard), as the reference's traces its kernel under shard_map."""
    ref, _, _ = reference
    assert K_ROWS["k1"] // 8 >= AUTO_MIN_ROWS
    before = tgl.PLAIN_CALLS
    dist, calls = _run(port, KQ.format(t="k1"))
    assert calls == 1 and tgl.PLAIN_CALLS - before == 8
    assert ref["k1", "auto"]["large_builds"] >= 1
    assert dist == ref["k1", "auto"]["rows"]
    assert dist == _run(port, KQ.format(t="k1"), dist="off")[0]


def test_plain_route_below_auto_min_rows_per_shard(reference, port):
    """16,384 rows on 8 shards: 2,048 a shard, below AUTO_MIN_ROWS, so
    no shard takes kernel 1 (the reference's route too), while the same
    table on one device does."""
    ref, _, _ = reference
    assert K_ROWS["k2"] // 8 < AUTO_MIN_ROWS <= K_ROWS["k2"]
    before = tgl.PLAIN_CALLS
    dist, calls = _run(port, KQ.format(t="k2"))
    assert calls == 1 and tgl.PLAIN_CALLS == before
    assert ref["k2", "auto"]["dispatches"] == 1
    assert ref["k2", "auto"]["large_builds"] == 0, ref["k2", "auto"]
    assert dist == ref["k2", "auto"]["rows"]
    local, _ = _run(port, KQ.format(t="k2"), dist="off")
    assert tgl.PLAIN_CALLS == before + 1
    assert ref["k2", "off"]["large_builds"] >= 1
    assert dist == local == ref["k2", "off"]["rows"]


@pytest.mark.parametrize("q", ["q1f", "q6f"])
def test_kernel2_once_per_shard_under_on(reference, port, q):
    ref, _, _ = reference
    sql = {"q1f": tpch.Q1F, "q6f": tpch.Q6F}[q]
    before = tg.PLAIN_CALLS
    dist, calls = _run(port, sql, mode="on")
    assert calls == 1 and tg.PLAIN_CALLS - before == 8
    assert ref[q, "auto"]["small_builds"] >= 1
    _assert_rows(dist, ref[q, "auto"]["rows"], rel=1e-5)
    _assert_rows(dist, _run(port, sql, dist="off", mode="on")[0], rel=1e-5)


def test_cross_shard_limb_sums_are_exact(reference, port):
    """Group "a" sums to 4,293,066,852 over 262,044 rows: each shard's
    32,768 rows stay below 2^31, their sum does not. The port cuts its
    limbs for the global row bound, so the int32 limb rows it psums
    cannot wrap: exact, equal to its local run and to numpy. The
    reference cuts them for one shard's rows (its limb_width falls back
    to the shard's n when the group bound exceeds it), so its summed
    limb row wraps by a multiple of 2^32; its local run is exact."""
    ref, _, _ = reference
    cols = _lw_columns()
    want = [(g, int(cols["v"][cols["g"] == g].sum()),
             int((cols["g"] == g).sum())) for g in ("a", "b")]
    assert want[0][1] > 2 ** 31 > want[0][1] // 8
    before = tgl.PLAIN_CALLS
    dist, calls = _run(port, LW)
    assert calls == 1 and tgl.PLAIN_CALLS - before == 8
    assert dist == want
    assert _run(port, LW, dist="off")[0] == want
    assert ref["lw", "off"]["rows"] == want
    assert ref["lw", "auto"]["large_builds"] >= 1
    assert ref["lw", "auto"]["dispatches"] == 1
    got = ref["lw", "auto"]["rows"][0][1]
    assert got != want[0][1] and (got - want[0][1]) % (1 << 32) == 0


def test_device_seconds_counted_once(port):
    """A tenant's device_seconds (the host clock around the dispatch on
    a CPU engine) is measured on the issuing thread: above zero, and no
    more than the statement's wall time, not once a shard."""
    s = port.session()
    t0 = time.monotonic()
    port.execute("SET application_name = 'dist_tenant'", s)
    port.execute(tpch.Q1, s)
    wall = time.monotonic() - t0
    t = {r.app_name: r for r in port.sqlstats.tenants()}
    assert t["dist_tenant"].statements == 1  # the SET ran as the old name
    assert 0 < t["dist_tenant"].device_seconds <= wall


class TestFaults:
    class _Drop:
        def plan(self, frm, to):
            return []

    def test_collective_fault_reruns_locally(self, reference, port):
        ref, _, _ = reference
        retries = port.metrics.counter(
            "sql.distsql.collective_fault.retries")
        r0 = retries.value()
        s = port.session()
        distagg.install_ici_faults(self._Drop())
        try:
            rows = port.execute(tpch.Q6, s).rows
        finally:
            distagg.install_ici_faults(None)
        assert retries.value() == r0 + 1
        assert s.vars.get("distsql") == "auto"  # restored
        _assert_rows(rows, ref["q6", "off"]["rows"])
        # healed: distributed again
        assert _run(port, tpch.Q6)[1] == 1

    def test_raising_shard_ends_the_statement(self, port, monkeypatch):
        """Shard 3 raises inside the plan: the statement fails with its
        error at once (the others leave their collectives), no shard
        thread is left, and the next statement runs."""
        orig = aggops.masked_count

        def failing(mask):
            if AXIS.index() == 3:
                raise ValueError("shard 3 failed")
            return orig(mask)
        monkeypatch.setattr(aggops, "masked_count", failing)
        t0 = time.monotonic()
        with pytest.raises(ValueError, match="shard 3 failed"):
            port.execute(tpch.Q6)
        assert time.monotonic() - t0 < 30
        monkeypatch.setattr(aggops, "masked_count", orig)
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("shard-")]
        assert _run(port, tpch.Q6)[1] == 1

    def test_stalled_shard_times_out(self):
        def fn(i):
            if i == 1:
                return None  # never reaches the collective
            return AXIS.psum(torch.ones(2))
        t0 = time.monotonic()
        with pytest.raises(collective.CollectiveTimeout):
            collective.run_sharded(CPU8[:4], fn, timeout=1.0)
        assert time.monotonic() - t0 < 10

    def test_shards_disagreeing_on_a_collective(self):
        def fn(i):
            x = torch.ones(2)
            return AXIS.psum(x) if i else AXIS.pmax(x)
        with pytest.raises(collective.CollectiveError, match="disagree"):
            collective.run_sharded(CPU8[:4], fn, timeout=10.0)

    def test_collective_outside_a_run(self):
        with pytest.raises(collective.CollectiveError):
            AXIS.psum(torch.ones(1))


class TestCollectives:
    def test_reductions_in_shard_order(self):
        """psum/pmin/pmax, all_gather and all_to_all over 4 shards
        against numpy; every shard gets its own copy."""
        vals = [torch.tensor([float(i), -float(i), 1.0]) for i in range(4)]

        def fn(i):
            x = vals[i]
            return (AXIS.psum(x), AXIS.pmin(x), AXIS.pmax(x),
                    AXIS.all_gather(x), AXIS.all_to_all(
                        torch.arange(8) + 10 * i), AXIS.index())
        out = collective.run_sharded(CPU8[:4], fn, timeout=10.0)
        stack = np.stack([v.numpy() for v in vals])
        for i, (s, lo, hi, g, a2a, idx) in enumerate(out):
            assert np.array_equal(s.numpy(), stack.sum(0))
            assert np.array_equal(lo.numpy(), stack.min(0))
            assert np.array_equal(hi.numpy(), stack.max(0))
            assert np.array_equal(g.numpy(), stack.reshape(-1))
            assert a2a.tolist() == [10 * j + 2 * i + k for j in range(4)
                                    for k in range(2)]
            assert idx == i
        assert out[0][0].data_ptr() != out[1][0].data_ptr()

    def test_bool_min_max(self):
        def fn(i):
            x = torch.tensor([i % 2 == 0, True])
            return AXIS.pmin(x), AXIS.pmax(x)
        (lo, hi), *_ = collective.run_sharded(CPU8[:2], fn, timeout=10.0)
        assert lo.tolist() == [False, True] and hi.tolist() == [True, True]


class TestDispatcher:
    """The per-mesh FIFO dispatcher (tests/test_dispatch_queue.py)."""

    def test_fifo_order(self):
        d = distagg._MeshDispatcher("test-fifo")
        order = []
        futs = [d.submit(lambda i=i: order.append(i) or i, (), {})
                for i in range(20)]
        assert [f.result(timeout=10) for f in futs] == list(range(20))
        assert order == list(range(20))
        d.shutdown()

    def test_exception_propagates_to_caller(self):
        def boom():
            raise ValueError("inside dispatcher")
        call = distagg.queued_collective_call(boom, mesh=None)
        with pytest.raises(ValueError, match="inside dispatcher"):
            call()

    def test_shared_dispatcher_per_slot_set(self, port):
        a = distagg._dispatcher_for(port.mesh)
        assert a is distagg._dispatcher_for(make_mesh(CPU8))
        # sub-meshes over one device are distinct domains
        assert distagg._dispatcher_for(port.mesh.submesh(0, 4)) is not \
            distagg._dispatcher_for(port.mesh.submesh(4, 4))

    def test_queue_metrics_flow(self):
        reg = MetricRegistry()
        call = distagg.queued_collective_call(lambda x: x + 1,
                                              metrics=reg, mesh=None)
        assert call(41) == 42
        assert reg.get("exec.allreduce.calls").value() == 1
        assert reg.get("exec.queue.wait_seconds").value()["count"] == 1
        assert reg.get("exec.queue.depth") is not None

    # the dying thread reports its failure, as a loop-level bug would
    @pytest.mark.filterwarnings(
        "ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_dead_dispatcher_fails_futures_and_respawns(self):
        d = distagg._MeshDispatcher("test-death")
        dying = d._thread
        d.inject_death()
        fut = d.submit(lambda: 1, (), {})
        with pytest.raises(distagg.CollectiveFault):
            fut.result(timeout=10)
        dying.join(10)  # its failure is reported inside this test
        assert not dying.is_alive()
        n = d.respawns
        assert d.submit(lambda: 2, (), {}).result(timeout=10) == 2
        assert d.respawns == n + 1
        d.shutdown()

    def test_shutdown_of_a_dead_thread_leaves_no_queued_entry(self):
        """A retired or dead dispatcher's queue stays empty: a stale
        shutdown entry would read as a busy mesh to the router."""
        d = distagg._MeshDispatcher("test-stale")
        d.shutdown()
        assert not d._thread.is_alive() and d.depth() == 0
        d.shutdown()
        assert d.depth() == 0
        assert d.submit(lambda: 3, (), {}).result(timeout=10) == 3
        d.shutdown()

    def test_compile_bill_follows_the_submitter(self):
        """Work billed on the dispatcher thread lands in the submitting
        thread's compile-attribution cell (exec/coldstart.py)."""
        d = distagg._MeshDispatcher("test-bill")
        c0 = coldstart.thread_compile_seconds()
        d.submit(coldstart._bill, (0.5,), {}).result(timeout=10)
        assert coldstart.thread_compile_seconds() == pytest.approx(c0 + 0.5)
        d.shutdown()

    def test_queue_depth_gauge_reads_the_dispatchers(self, port):
        assert port.devstats.queue_depth() >= 0
        assert port.metrics.get("exec.device.queue.depth").value() == \
            port.devstats.queue_depth()


@pytest.mark.gpu
class TestOnCard:
    """Four shards on one card: Q1's kernel 1 once a shard, rows equal
    to the card's own local run."""

    @pytest.fixture
    def cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        return torch.device("cuda", 0)

    def test_q1_four_shards_on_one_card(self, cuda):
        eng = Engine(mesh=make_mesh([cuda] * 4))
        try:
            tpch.load(eng, sf=0.01, rows=1 << 16)
            # the first `auto` plan build runs the parity gate's fuzz,
            # which launches the kernel itself: count a warm run
            _run(eng, tpch.Q1)
            torch.cuda.synchronize()
            before = tgl.LAUNCHES
            dist, calls = _run(eng, tpch.Q1)
            torch.cuda.synchronize()
            assert calls == 1 and tgl.LAUNCHES - before == 4
            _assert_rows(dist, _run(eng, tpch.Q1, dist="off")[0])
        finally:
            eng.close()
