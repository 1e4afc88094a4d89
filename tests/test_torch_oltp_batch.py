"""Cross-session batch windows and group commit (exec/oltpbatch.py), the
statement gate and the lane's scoped suspension.

- ``oltp_batch = auto`` is bit for bit ``off`` on a sequential fuzzed
  matrix, and both equal the reference Engine's statement outcomes.
- Concurrent sessions over one engine end where an oracle of the
  per-key writes says (every thread joins within a timeout: the test
  fails rather than hangs).
- One kv commit per write round (``kv.groupcommit.*``), a same-key
  window split into rounds, per-statement errors kept apart, a solo
  window when uncontended, reads not queued behind a stuck write
  window.
- ``_stmt_tables``: a full-path statement suspends the lane only on
  the tables it reads; a view reference suspends it everywhere.
"""

import threading

import numpy as np
import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.exec.oltpbatch import BatchReq
from cockroach_tpu_torch.exec.session import EngineError, Session
from cockroach_tpu_torch.sql.parser import parse
from tests.test_torch_groupagg_large import reference_modules
from tests.test_torch_ranges import reference_cases

JOIN_TIMEOUT = 60.0


def _mk(records=60):
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, a INT8, b INT8)")
    e.execute("INSERT INTO t VALUES " + ", ".join(
        f"({i}, {i * 3}, {i * 5})" for i in range(records)))
    return e


def _session(mode):
    s = Session()
    s.vars.set("oltp_batch", mode)
    return s


def _snapshot(e):
    return e.execute("SELECT k, a, b FROM t ORDER BY k").rows


def _run_threads(fns):
    """Start one thread per callable, join each within JOIN_TIMEOUT and
    fail (not hang) on a thread still running; re-raise the first
    error a thread hit."""
    errs = []

    def wrap(fn):
        def go():
            try:
                fn()
            except BaseException as exc:
                errs.append(exc)
        return go

    ts = [threading.Thread(target=wrap(fn), daemon=True) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_TIMEOUT)
    assert not any(t.is_alive() for t in ts), "a session deadlocked"
    if errs:
        raise errs[0]


def _fuzz_ops(n=300, seed=7):
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(n):
        r = rng.integers(0, 100)
        k = int(rng.integers(0, 60))
        if r < 35:
            ops.append(f"SELECT a, b FROM t WHERE k = {k}")
        elif r < 40:
            ops.append(f"SELECT k, a FROM t WHERE k >= {k} ORDER BY k "
                       "LIMIT 3")
        elif r < 70:
            ops.append(f"UPDATE t SET a = {i} WHERE k = {k}")
        elif r < 85:
            ops.append(f"INSERT INTO t VALUES ({1000 + i}, {i}, 0)")
        elif r < 95:
            ops.append(f"DELETE FROM t WHERE k = {k}")
        else:
            ops.append("INSERT INTO t VALUES (1, 0, 0)")  # duplicate pk
    return ops


def _outcomes(e, ops, s):
    got = []
    for sql in ops:
        try:
            r = e.execute(sql, s)
            got.append(("ok", r.rows, r.row_count, r.tag))
        except Exception as exc:   # the reference raises its own class
            got.append(("err", type(exc).__name__, str(exc)))
    return got


def test_sequential_fuzzed_matrix_auto_equals_off_and_reference():
    ops = _fuzz_ops()
    outs = {}
    for mode in ("off", "auto"):
        e = _mk()
        h0 = e.lane_hits
        outs[mode] = (_outcomes(e, ops, _session(mode)), _snapshot(e))
        assert e.lane_hits - h0 >= len(ops) * 0.9
    assert outs["off"] == outs["auto"]
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        je = jeng.Engine()
        try:
            je.execute("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, "
                       "a INT8, b INT8)")
            je.execute("INSERT INTO t VALUES " + ", ".join(
                f"({i}, {i * 3}, {i * 5})" for i in range(60)))
            want = (_outcomes(je, ops, None), _snapshot(je))
        finally:
            je.close()
    assert outs["auto"] == want


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_concurrent_sessions_against_the_oracle(mode):
    """8 sessions of point reads, range scans, updates and inserts on
    shared keys; afterwards every key holds its initial value or one
    some session wrote to it, the inserted rows are all there, and the
    lane's rows equal the full path's."""
    e = _mk(50)
    written = {k: {k * 3} for k in range(50)}
    lock = threading.Lock()

    def work(w):
        def go():
            s = _session(mode)
            for i in range(60):
                k = (i * 7 + w) % 50
                if i % 4 == 0:
                    v = w * 1000 + i
                    with lock:
                        written[k].add(v)
                    e.execute(f"UPDATE t SET a = {v} WHERE k = {k}", s)
                elif i % 4 == 1:
                    r = e.execute(f"SELECT a, b FROM t WHERE k = {k}", s)
                    assert r.rows[0][1] == k * 5
                elif i % 4 == 2:
                    r = e.execute(f"SELECT k, a FROM t WHERE k >= {k} "
                                  "AND k < 50 ORDER BY k LIMIT 5", s)
                    assert [x[0] for x in r.rows] == list(
                        range(k, min(k + 5, 50)))
                else:
                    e.execute(f"INSERT INTO t VALUES ({1000 + w * 100 + i},"
                              f" {w}, {i})", s)
        return go

    _run_threads([work(w) for w in range(8)])
    assert e.execute("SELECT count(*) FROM t").rows == [(50 + 8 * 15,)]
    full = dict(e.execute("SELECT k, a FROM t WHERE k < 50").rows)
    for k in range(50):
        lane = e.execute(f"SELECT a FROM t WHERE k = {k}").rows[0][0]
        assert lane == full[k] and lane in written[k], k


def _reqs(e, keys):
    """Window requests of the lane's UPDATE shape, synthesized."""
    e.execute("UPDATE t SET a = 1 WHERE k = 0")
    plan = next(p for p in e._lane_shapes.values()
                if p is not None and p.kind == "update")
    return [BatchReq(plan, [500 + k, k], None) for k in keys]


def _gc(e):
    snap = e.metrics.snapshot()
    return snap["kv.groupcommit.proposals"], snap["kv.groupcommit.commands"]


def test_one_group_commit_per_round():
    e = _mk()
    reqs = _reqs(e, [3, 4, 5, 6])
    p0, c0 = _gc(e)
    e._lane_write_batch(reqs)
    assert all(r.error is None and r.result is not None for r in reqs)
    assert _gc(e) == (p0 + 1, c0 + 4)
    for k in (3, 4, 5, 6):
        assert e.execute(f"SELECT a FROM t WHERE k = {k}").rows == [
            (500 + k,)]


def test_same_key_window_splits_into_rounds():
    e = _mk()
    reqs = _reqs(e, [7, 7])
    p0, _ = _gc(e)
    e._lane_write_batch(reqs)
    assert all(r.result is not None for r in reqs)
    assert _gc(e)[0] == p0 + 2
    assert e.execute("SELECT a FROM t WHERE k = 7").rows == [(507,)]


def test_per_statement_errors_kept_apart():
    e = _mk(10)
    e.execute("INSERT INTO t VALUES (100, 0, 0)")
    plan = next(p for p in e._lane_shapes.values()
                if p is not None and p.kind == "insert")
    reqs = [BatchReq(plan, [200, 1, 1], None),
            BatchReq(plan, [100, 2, 2], None),    # duplicate pk
            BatchReq(plan, [201, 3, 3], None)]
    e._lane_write_batch(reqs)
    assert reqs[0].result is not None and reqs[2].result is not None
    assert isinstance(reqs[1].error, EngineError)
    assert "duplicate key" in str(reqs[1].error)
    assert e.execute("SELECT count(*) FROM t WHERE k >= 100").rows == [(3,)]


def test_plan_classified_before_ddl_is_stale():
    """A lane plan that reaches the gate after DDL replaced its table
    (here: the columns reordered) is refused there, per statement and
    in a window; the statement re-classifies against the new table."""
    from cockroach_tpu_torch.exec.oltplane import ShapeIneligible
    e = _mk(10)
    e.execute("SELECT a, b FROM t WHERE k = 1")
    plan = next(p for p in e._lane_shapes.values()
                if p is not None and p.kind == "point")
    e.execute("DROP TABLE t")
    e.execute("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, b INT8, a INT8)")
    e.execute("INSERT INTO t VALUES (1, 10, 20), (2, 30, 40)")
    with pytest.raises(ShapeIneligible):
        e._lane_read(plan, [1], None)
    req = BatchReq(plan, [1], None)
    e._lane_read_batch([req])
    assert isinstance(req.error, ShapeIneligible) and req.result is None
    h0 = e.lane_hits
    assert e.execute("SELECT a, b FROM t WHERE k = 1").rows == [(20, 10)]
    assert e.lane_hits == h0 + 1


def test_batch_counters_registered():
    e = _mk()
    s = _session("auto")
    for i in range(8):
        e.execute(f"UPDATE t SET a = {i} WHERE k = {i}", s)
    snap = e.metrics.snapshot()
    assert snap["exec.oltp.batch.windows"] >= 8
    assert snap["exec.oltp.batch.size_p50"] == 1.0
    assert snap["exec.oltp.batch.flush_wait_seconds"]["count"] >= 8
    assert snap["kv.groupcommit.proposals"] >= 8
    assert "exec.oltp.batch.fused" in snap


def test_solo_when_uncontended():
    e = _mk()
    lb = e._lane_batcher
    w0 = lb.windows
    assert e.execute("SELECT a FROM t WHERE k = 1", _session("auto")
                     ).rows == [(3,)]
    assert lb.windows == w0 + 1 and lb._sizes[-1] == 1
    # off never enters a window
    e.execute("SELECT a FROM t WHERE k = 2", _session("off"))
    assert lb.windows == w0 + 1


def _park_writes(lb):
    """Hold the write collector's leader inside its window until the
    returned gate opens."""
    gate, entered = threading.Event(), threading.Event()
    real = lb._writes.run_fn

    def slow(reqs):
        entered.set()
        gate.wait(JOIN_TIMEOUT)
        real(reqs)
    lb._writes.run_fn = slow
    return gate, entered, real


def test_pileup_fuses_into_one_window():
    e = _mk()
    lb = e._lane_batcher
    gate, entered, real = _park_writes(lb)
    s = _session("auto")
    first = threading.Thread(target=lambda: e.execute(
        "UPDATE t SET a = 1 WHERE k = 1", s), daemon=True)
    first.start()
    assert entered.wait(JOIN_TIMEOUT)
    rest = [threading.Thread(target=lambda k=k: e.execute(
        f"UPDATE t SET a = {k} WHERE k = {k}", s), daemon=True)
        for k in range(2, 6)]
    for t in rest:
        t.start()
    for _ in range(500):
        with lb._writes.window_cv:
            if len(lb._writes.queue) == 4:
                break
        threading.Event().wait(0.01)
    lb._writes.run_fn = real
    gate.set()
    for t in [first, *rest]:
        t.join(JOIN_TIMEOUT)
        assert not t.is_alive()
    with lb.stats_cv:
        assert 4 in lb._sizes
    assert e.metrics.snapshot()["exec.oltp.batch.fused"] >= 4
    for k in range(1, 6):
        assert e.execute(f"SELECT a FROM t WHERE k = {k}").rows == [(k,)]


def test_reads_not_blocked_behind_a_write_window():
    e = _mk()
    lb = e._lane_batcher
    gate, entered, real = _park_writes(lb)
    s = _session("auto")
    t = threading.Thread(target=lambda: e.execute(
        "UPDATE t SET a = 9 WHERE k = 9", s), daemon=True)
    t.start()
    try:
        assert entered.wait(JOIN_TIMEOUT)
        assert e.execute("SELECT a FROM t WHERE k = 1", s).rows == [(3,)]
    finally:
        lb._writes.run_fn = real
        gate.set()
        t.join(JOIN_TIMEOUT)
    assert not t.is_alive()


def test_stmt_tables_extraction():
    e = _mk()
    e.execute("CREATE TABLE u (k INT PRIMARY KEY, v INT)")
    assert e._stmt_tables(parse("SELECT sum(a) FROM t")) == {"t"}
    assert e._stmt_tables(parse(
        "SELECT * FROM t JOIN u ON t.k = u.k")) == {"t", "u"}
    assert e._stmt_tables(parse(
        "SELECT (SELECT max(v) FROM u) FROM t")) == {"t", "u"}
    assert e._stmt_tables(parse("UPDATE t SET a = 1 WHERE k IN "
                                "(SELECT k FROM u)")) == {"t", "u"}
    assert e._stmt_tables(parse("DROP TABLE u")) is None
    # statements that read no table neither flush nor suspend the lane;
    # COMMIT publishes a txn's writes, so it suspends every table
    for sql in ("SET oltp_batch = off", "BEGIN", "ROLLBACK",
                "CREATE SEQUENCE q", "SHOW SEQUENCES"):
        assert e._stmt_tables(parse(sql)) == set(), sql
    assert e._stmt_tables(parse("COMMIT")) is None
    e.execute("UPDATE t SET a = 7 WHERE k = 1")
    e.execute("SET oltp_batch = off")
    assert e._lane_pending["t"]
    e.execute("COMMIT")
    assert not e._lane_pending


def test_view_reference_goes_global():
    e = _mk()
    e.execute("CREATE VIEW vt AS SELECT k, a FROM t")
    assert e._stmt_tables(parse("SELECT * FROM vt")) is None


def test_analytic_on_another_table_does_not_suspend_the_lane():
    e = _mk()
    e.execute("CREATE TABLE u (k INT PRIMARY KEY, v INT)")
    s = _session("auto")
    e.execute("UPDATE t SET a = 1 WHERE k = 0", s)   # shape built
    with e._nonlane_scope({"u"}):                    # an analytic on u
        p0, _ = _gc(e)
        h0 = e.lane_hits
        e.execute("UPDATE t SET a = 2 WHERE k = 0", s)
        assert (_gc(e)[0], e.lane_hits) == (p0 + 1, h0 + 1)
    assert e.execute("SELECT a FROM t WHERE k = 0").rows == [(2,)]


def test_analytic_on_the_same_table_suspends_the_lane():
    e = _mk()
    s = _session("auto")
    e.execute("UPDATE t SET a = 1 WHERE k = 0", s)
    e.execute("UPDATE t SET a = 5 WHERE k = 1", s)
    assert e._lane_pending["t"]
    done = threading.Event()

    def lane_write():
        # the lane refuses it; the full path waits for the gate
        e.execute("UPDATE t SET a = 3 WHERE k = 0", s)
        done.set()

    with e._nonlane_scope({"t"}):
        # the scope flushed t's queue before the analytic's snapshot
        assert not e._lane_pending
        p0, _ = _gc(e)
        h0 = e.lane_hits
        with e._gate(True):
            t = threading.Thread(target=lane_write, daemon=True)
            t.start()
            assert not done.wait(0.3)   # held behind the shared reader
        t.join(JOIN_TIMEOUT)
        assert done.is_set()
        assert (_gc(e)[0], e.lane_hits) == (p0, h0)
    assert e.execute("SELECT a FROM t WHERE k = 0").rows == [(3,)]
    assert e.execute("SELECT a FROM t WHERE k = 1").rows == [(5,)]


def test_full_path_statement_reports_its_waits():
    """``last_exec["waits"]`` splits a full-path statement's entry: the
    commit fence (``fence_s``: here held by a lane commit for 0.3 s),
    the flush of the lane's queue and the statement gate."""
    e = _mk()
    s = _session("auto")
    e.execute("UPDATE t SET a = 1 WHERE k = 0", s)   # queued on the lane
    got = {}

    def count():
        got["rows"] = e.execute("SELECT count(*), sum(a) FROM t").rows
        got["waits"] = dict(e.last_exec["waits"])

    with e._lane_sync:                    # a lane commit in flight
        th = threading.Thread(target=count, daemon=True)
        th.start()
        th.join(0.3)
        assert th.is_alive()              # the statement waits at the fence
    th.join(JOIN_TIMEOUT)
    assert not th.is_alive()
    assert got["rows"] == [(60, sum(i * 3 for i in range(1, 60)) + 1)]
    assert set(got["waits"]) == {"fence_s", "flush_s", "gate_s"}
    assert got["waits"]["fence_s"] >= 0.25
    assert got["waits"]["flush_s"] > 0 and got["waits"]["gate_s"] >= 0
    assert not e._lane_pending            # the queue was flushed
    e.execute("UPDATE t SET a = 2 WHERE k = 0", s)
    e.execute("SELECT k FROM t WHERE k = 1")          # the lane: no scope
    assert e.execute("SELECT sum(a) FROM t").rows == \
        [(sum(i * 3 for i in range(1, 60)) + 2,)]
    assert e.last_exec["waits"]["fence_s"] < 0.25


def test_prepared_takes_the_gate_side_execute_takes():
    """Prepared.run decides the gate's side by execute()'s rule: a
    plain SELECT shares it; one with a subquery (re-run, and possibly
    materialized into temps, when a generation moves) is exclusive."""
    e = _mk()
    sides = []
    gate = e._gate

    def recording(shared):
        sides.append(shared)
        return gate(shared)
    e._gate = recording
    for sql, shared in (("SELECT a FROM t WHERE a > 6", True),
                        ("SELECT a FROM t WHERE a > (SELECT min(b) FROM t)",
                         False)):
        p = e.prepare(sql)
        assert type(p).__name__ == "Prepared"
        del sides[:]
        want = e.execute(sql).rows
        assert p.run().rows == want
        assert sides == [shared, shared]


def test_stress_more_threads_than_cores():
    """16 sessions (more than this machine's cores) with a shortened
    interpreter switch interval: each inserts, updates and reads its own
    keys through batch windows. A lost update anywhere (a row, a lane
    hit, a group-commit command) breaks one of the counts."""
    import sys
    e = _mk(10)
    n_threads, per = 16, 12
    switch = sys.getswitchinterval()
    h0 = e.lane_hits
    p0, c0 = _gc(e)

    def work(w):
        def go():
            s = _session("auto")
            for i in range(per):
                k = 1000 + w * 100 + i
                e.execute(f"INSERT INTO t VALUES ({k}, 0, {w})", s)
                e.execute(f"UPDATE t SET a = {i + 1} WHERE k = {k}", s)
                assert e.execute(f"SELECT a, b FROM t WHERE k = {k}", s
                                 ).rows == [(i + 1, w)]
        return go

    sys.setswitchinterval(1e-5)
    try:
        _run_threads([work(w) for w in range(n_threads)])
    finally:
        sys.setswitchinterval(switch)
    writes = 2 * n_threads * per
    assert e.lane_hits - h0 == 3 * n_threads * per
    p1, c1 = _gc(e)
    assert c1 - c0 == writes and 0 < p1 - p0 <= writes
    assert e.execute("SELECT count(*), sum(a), sum(b) FROM t WHERE k >= 1000"
                     ).rows == [(n_threads * per,
                                 n_threads * per * (per + 1) // 2,
                                 per * n_threads * (n_threads - 1) // 2)]


def test_shared_readers_upload_a_table_once():
    """Plain SELECTs share the gate: many threads running one analytic
    upload the table once and keep their own last_exec."""
    e = _mk(2000)
    e.execute("SELECT count(*) FROM t")
    e._evict_device("t")
    uploads = []
    real = e._batch_from_chunks

    def counting(*a, **kw):
        uploads.append(1)
        return real(*a, **kw)
    e._batch_from_chunks = counting
    sums = []

    def q(i):
        def go():
            r = e.execute(f"SELECT sum(a) FROM t WHERE b >= {i % 2}")
            assert e.last_exec["all"]["runs"] == 1
            sums.append(r.rows[0][0])
        return go

    _run_threads([q(i) for i in range(8)])
    assert len(uploads) == 1
    assert set(sums) == {sum(i * 3 for i in range(2000))}


def test_chip_smoke_phase12_on_the_cpu():
    """chip_smoke.py's phase 12 at a small size on a CPU engine: every
    check it makes on the card but the kernel-vs-plain ones (kernel 1's
    plain version counts its launches here)."""
    import chip_smoke
    from cockroach_tpu_torch.models import tpch
    eng = Engine(device="cpu")
    tpch.load(eng, sf=0.01, rows=20_000, tables=("lineitem", "supplier"),
              encoded=True)
    li = tpch.gen_lineitem(0.01, rows=20_000, encoded=True)
    li["l_returnflag"] = np.asarray(tpch.RF_VALUES)[li["l_returnflag"]]
    li["l_linestatus"] = np.asarray(tpch.LS_VALUES)[li["l_linestatus"]]
    eng.execute(chip_smoke.USERTABLE_DDL)
    out = chip_smoke.oltp_phase(eng, li, tpch.gen_supplier(0.01),
                                records=5_000, ops=600, conc_ops=960,
                                workers=8, q1_runs=2)
    assert out["chunks"]["after"] - out["chunks"]["before"] == \
        out["chunks"]["flushes"] == 2
    assert out["kernel1_launches"] == {"group_by_single": 1, "group_by": 1,
                                       "group_by_again": 1, "q1_beside": 2,
                                       "q15_view": 1}
    assert all({"fence_s", "flush_s", "gate_s"} <= set(r)
               for r in out["beside_q1"]["q1"])
    assert all(r["lane_hits"] == r["statements"]
               for r in out["single"].values())
    assert out["sequence"]["first"] == out["sequence"]["rolled_back"] + 1


# -- raft's group entries ------------------------------------------------------
# The reference's own cases, tests/test_oltp_batch.py's
# TestRaftGroupEntries and TestLeaseholderTsCache (6: pack/unpack, a single
# command as a plain entry, propose_group as one log entry of many
# commands, Replica.propose_batch acking every waiter on a 3-node Cluster,
# a follower's batch falling back to single proposals, and a read through
# one gateway pushing a txn write through another above it), run on the
# port's kvserver/raft.py, store.py, cluster.py and kv/rangekv.py
# (``reference_cases`` of test_torch_ranges.py).

reference_cases("test_oltp_batch.py", globals(),
                only=("TestRaftGroupEntries", "TestLeaseholderTsCache"))
