"""Changefeeds in the port against the JAX package's.

The four cases of the reference's tests/test_cdc.py ``TestChangefeed``
(end to end, commit visibility, a cursor resume that re-delivers, the
file sink) run as one scenario on each package (``Engine(device="cpu")``
against the reference Engine): the events' ``key`` and ``after``
payloads must be equal, and equal to what the reference's test asserts.
Timestamps come from each engine's own clock, so they are compared only
within an engine: events in (updated, key) order, resolved timestamps
monotone and past the last event. Beyond them: a catch-up of a table's
whole history (inserts, an UPDATE, a DELETE, NULLs) equal on both, and
the OLTP lane declining a fed table's writes and taking them again
after CANCEL JOB.
"""

import importlib
import json
import threading
import time
from types import SimpleNamespace

import pytest

from tests.test_torch_groupagg_large import reference_modules

REF_MODULES = ("cockroach_tpu.exec.engine", "cockroach_tpu.cdc")


def _side(pkg: str, port: bool) -> SimpleNamespace:
    eng_cls = importlib.import_module(f"{pkg}.exec.engine").Engine
    cdc = importlib.import_module(f"{pkg}.cdc")
    return SimpleNamespace(
        name="port" if port else "ref",
        engine=(lambda: eng_cls(device="cpu")) if port else eng_cls,
        open_sink=cdc.open_sink, CHANGEFEED_JOB=cdc.CHANGEFEED_JOB)


@pytest.fixture(scope="module")
def sides():
    with reference_modules(*REF_MODULES):
        yield _side("cockroach_tpu_torch", True), \
            _side("cockroach_tpu", False)


def wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def both(sides, tmp_path, scenario):
    got = []
    for s in sides:
        d = tmp_path / s.name
        d.mkdir()
        got.append(scenario(s, d))
    assert got[0] == got[1], got
    return got[0]


def _payloads(rows):
    """What both packages must agree on: each event's key and row."""
    return [(r["key"], r["after"]) for r in rows]


def _ordered_within(rows, resolved):
    """Events in (updated, key) order; resolved timestamps monotone."""
    ts = [(r["updated"], r["key"]) for r in rows]
    return ts == sorted(ts) and resolved == sorted(resolved)


def test_end_to_end(sides, tmp_path):
    def run(s, d):
        e = s.engine()
        e.execute("CREATE TABLE acc (id INT PRIMARY KEY, bal INT)")
        e.execute("INSERT INTO acc VALUES (1, 100)")
        uri = f"mem://e2e-{s.name}-{id(e)}"
        jid = e.execute(f"CREATE CHANGEFEED FOR acc INTO '{uri}'").rows[0][0]
        sink = s.open_sink(uri)
        assert wait(lambda: len(sink.rows) >= 1)
        e.execute("UPDATE acc SET bal = 150 WHERE id = 1")
        e.execute("DELETE FROM acc WHERE id = 1")
        assert wait(lambda: len(sink.rows) >= 3)
        # resolved timestamps are monotone and pass the last event
        assert wait(lambda: sink.resolved and
                    sink.resolved[-1] >= sink.rows[-1]["updated"])
        e.execute(f"CANCEL JOB {jid}")
        assert wait(lambda: e.jobs.job(jid).status == "canceled")
        return [_payloads(sink.rows), _ordered_within(sink.rows,
                                                      sink.resolved)]
    got = both(sides, tmp_path, run)
    afters = [a for _k, a in got[0]]
    assert {"id": 1, "bal": 100} in afters
    assert {"id": 1, "bal": 150} in afters
    assert afters[-1] is None and got[1]


def test_txn_commit_visibility(sides, tmp_path):
    """Events appear only at COMMIT, at the commit timestamp; a rolled
    back txn emits nothing."""
    def run(s, d):
        e = s.engine()
        e.execute("CREATE TABLE t (a INT PRIMARY KEY)")
        uri = f"mem://txn-{s.name}-{id(e)}"
        jid = e.execute(f"CREATE CHANGEFEED FOR t INTO '{uri}'").rows[0][0]
        sink = s.open_sink(uri)
        assert wait(lambda: sink.resolved)
        ss = e.session()
        e.execute("BEGIN", session=ss)
        e.execute("INSERT INTO t VALUES (1)", session=ss)
        time.sleep(0.1)
        trace = [list(sink.rows)]            # not committed yet
        e.execute("COMMIT", session=ss)
        assert wait(lambda: len(sink.rows) == 1)
        s2 = e.session()
        e.execute("BEGIN", session=s2)
        e.execute("INSERT INTO t VALUES (2)", session=s2)
        e.execute("ROLLBACK", session=s2)
        time.sleep(0.15)
        trace.append(_payloads(sink.rows))   # the rollback emitted nothing
        e.execute(f"CANCEL JOB {jid}")
        assert wait(lambda: e.jobs.job(jid).status == "canceled")
        return trace
    got = both(sides, tmp_path, run)
    assert got[0] == [] and [a for _k, a in got[1]] == [{"a": 1}]


def test_cursor_resume_redelivers(sides, tmp_path):
    """A changefeed started from a cursor re-emits the history after it:
    the at-least-once resume contract."""
    def run(s, d):
        e = s.engine()
        e.execute("CREATE TABLE t (a INT PRIMARY KEY, v INT)")
        e.execute("INSERT INTO t VALUES (1, 10)")
        cut = e.clock.now().to_int()
        e.execute("INSERT INTO t VALUES (2, 20)")
        seal = getattr(e.store, "seal", None)
        if seal is not None:
            seal("t")
        uri = f"mem://resume-{s.name}-{id(e)}"
        sink = s.open_sink(uri)
        jid = e.jobs.create(s.CHANGEFEED_JOB, {
            "table": "t", "sink": uri, "cursor": cut,
            "resolved_every_s": 0.02})
        th = threading.Thread(target=lambda: e.jobs.run_job(jid),
                              daemon=True)
        th.start()
        assert wait(lambda: len(sink.rows) >= 1 and sink.resolved)
        e.jobs.cancel(jid)
        th.join(timeout=10)
        return [not th.is_alive(), _payloads(sink.rows),
                e.jobs.job(jid).progress["resolved"] >= cut]
    got = both(sides, tmp_path, run)
    # only the row after the cursor arrives
    assert got[0] and [a["a"] for _k, a in got[1]] == [2] and got[2]


def test_file_sink(sides, tmp_path):
    def run(s, d):
        path = d / "feed.ndjson"
        e = s.engine()
        e.execute("CREATE TABLE t (a INT PRIMARY KEY)")
        jid = e.execute(
            f"CREATE CHANGEFEED FOR t INTO 'file://{path}'").rows[0][0]
        e.execute("INSERT INTO t VALUES (7)")
        assert wait(lambda: path.exists() and any(
            '"after"' in ln for ln in path.read_text().splitlines() if ln))
        e.execute(f"CANCEL JOB {jid}")
        assert wait(lambda: e.jobs.job(jid).status == "canceled")
        lines = [json.loads(x) for x in path.read_text().splitlines() if x]
        rows = [o for o in lines if "after" in o]
        resolved = [o["resolved"] for o in lines if "resolved" in o]
        return [_payloads(rows), bool(resolved),
                _ordered_within(rows, resolved)]
    got = both(sides, tmp_path, run)
    assert [a for _k, a in got[0]] == [{"a": 7}] and got[1] and got[2]


def test_catch_up_of_the_whole_history(sides, tmp_path):
    """A feed from cursor 0 over a table with inserts, an UPDATE of
    several rows, a DELETE and NULLs (the catch-up scan, not the live
    hook): the same events in the same (updated, key) order on both,
    the update as the old version's delete and the new version's put at
    one timestamp, as the reference's walk gives them."""
    def run(s, d):
        e = s.engine()
        e.execute("CREATE TABLE c (k INT PRIMARY KEY, s STRING, "
                  "m DECIMAL(8,2), dt DATE)")
        e.execute("INSERT INTO c VALUES (1, 'x', 1.50, '2020-01-02'), "
                  "(2, NULL, 2.25, NULL), (3, 'y', NULL, '1999-12-31'), "
                  "(4, 'x', 4.00, '2001-01-01')")
        e.execute("UPDATE c SET m = 9.99 WHERE k >= 3")
        e.execute("DELETE FROM c WHERE k = 1")
        uri = f"mem://hist-{s.name}-{id(e)}"
        jid = e.execute(f"CREATE CHANGEFEED FOR c INTO '{uri}'").rows[0][0]
        sink = s.open_sink(uri)
        assert wait(lambda: len(sink.rows) >= 9 and sink.resolved)
        e.execute(f"CANCEL JOB {jid}")
        assert wait(lambda: e.jobs.job(jid).status == "canceled")
        return [_payloads(sink.rows), _ordered_within(sink.rows,
                                                      sink.resolved)]
    got = both(sides, tmp_path, run)
    assert len(got[0]) == 9 and got[1]


def test_lane_declines_a_fed_table_until_cancel(tmp_path):
    """The OLTP lane takes single-row writes of an all-integer table;
    while a changefeed tails it, they take the full path (and reach the
    feed); after CANCEL JOB and the feed's thread's end, the lane takes
    them again."""
    from cockroach_tpu_torch.cdc import open_sink
    from cockroach_tpu_torch.exec.engine import Engine
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, a INT8)")
    e.execute("INSERT INTO t VALUES " + ", ".join(
        f"({i}, {i})" for i in range(20)))
    declines = e.metrics.counter("exec.oltp.lane.cdc_declines")
    h0 = e.lane_hits
    e.execute("UPDATE t SET a = 100 WHERE k = 1")
    e.execute("UPDATE t SET a = 101 WHERE k = 2")
    assert e.lane_hits == h0 + 2
    uri = f"mem://lane-{id(e)}"
    jid = e.execute(f"CREATE CHANGEFEED FOR t INTO '{uri}'").rows[0][0]
    sink = open_sink(uri)
    assert wait(lambda: len(sink.rows) >= 20 and sink.resolved)
    h1, d1 = e.lane_hits, declines.value()
    e.execute("UPDATE t SET a = 102 WHERE k = 3")
    e.execute("UPDATE t SET a = 103 WHERE k = 4")
    assert e.lane_hits == h1 and declines.value() > d1
    assert wait(lambda: {"k": 4, "a": 103} in [r["after"]
                                                for r in sink.rows])
    e.execute(f"CANCEL JOB {jid}")
    th = threading.enumerate()
    assert wait(lambda: e.jobs.job(jid).status == "canceled"
                and not e.cdc_feeds)
    for t in th:
        if t.name == f"changefeed-{jid}":
            t.join(timeout=10)
            assert not t.is_alive()
    h2 = e.lane_hits
    e.execute("UPDATE t SET a = 104 WHERE k = 5")
    assert e.lane_hits == h2 + 1
    assert e.execute("SELECT a FROM t WHERE k >= 3 AND k <= 5 ORDER BY k"
                     ).rows == [(102,), (103,), (104,)]


class _Adopted:
    """A resumer that records its runs and returns at once."""

    def __init__(self, seen: list):
        self.seen = seen

    def resume(self, ctx):
        self.seen.append(ctx.job_id)


@pytest.mark.parametrize("resolved_every_s", [0.05, 5.0])
def test_live_feed_keeps_its_lease_past_lease_seconds(tmp_path,
                                                      resolved_every_s):
    """A changefeed runs until canceled; its owner renews the job lease
    on the lease's own cadence, so a second registry's adoption pass
    finds nothing to adopt long after lease_seconds (0.5 s) have passed
    since the claim, also when resolved timestamps come far more rarely
    than the lease lasts (5 s)."""
    from cockroach_tpu_torch.cdc import CHANGEFEED_JOB, open_sink
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.jobs import Registry
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, a INT8)")
    e.execute("INSERT INTO t VALUES (1, 1), (2, 2)")
    e.jobs.lease_seconds = 0.5
    uri = f"mem://lease-{id(e)}"
    jid = e.create_changefeed("t", uri, resolved_every_s=resolved_every_s)
    sink = open_sink(uri)
    assert wait(lambda: len(sink.rows) >= 2 and sink.resolved)
    other = Registry(e.kv, session_id="other-node", lease_seconds=0.5)
    seen: list = []
    other.register(CHANGEFEED_JOB, lambda: _Adopted(seen))
    try:
        deadline = time.monotonic() + 3 * 0.5 + 0.2
        while time.monotonic() < deadline:
            assert other.adopt_and_run_all() == []
            time.sleep(0.1)
        e.execute("INSERT INTO t VALUES (3, 3)")
        assert wait(lambda: len(sink.rows) >= 3)
        assert other.adopt_and_run_all() == [] and seen == []
        rec = e.jobs.job(jid)
        assert rec.status == "running"
        assert rec.lease_owner == e.jobs.session_id
        assert rec.lease_expires > time.time()
    finally:
        e.jobs.cancel(jid)
        assert wait(lambda: e.jobs.job(jid).status == "canceled")


def test_job_of_a_dead_owner_is_adopted_after_its_lease():
    """A runner that claimed a job and died renews nothing: the job is
    not adoptable while its lease runs and is adopted after it."""
    from cockroach_tpu_torch.jobs import Registry
    from cockroach_tpu_torch.kv.txn import DB
    db = DB()
    dead = Registry(db, session_id="dead-node", lease_seconds=0.5)
    seen: list = []
    dead.register("probe", lambda: _Adopted([]))
    jid = dead.create("probe", {})
    assert dead._try_claim(jid) is not None  # claimed, then it died
    adopter = Registry(db, session_id="adopter", lease_seconds=0.5)
    adopter.register("probe", lambda: _Adopted(seen))
    assert adopter.adopt_and_run_all() == []
    assert wait(lambda: adopter.adopt_and_run_all() != [], timeout=5)
    assert seen == [jid]
    rec = adopter.job(jid)
    assert rec.status == "succeeded" and rec.lease_owner == ""
