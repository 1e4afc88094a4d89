"""The port's OLTP lane (exec/oltplane.py + native/oltp.cpp) against the
JAX package's.

Every case of the reference's tests/test_oltp_lane.py but AS OF and
CREATE INDEX (neither is ported) runs its statements through
``Engine(device="cpu")`` and the reference Engine side by side: each
statement's rows, row count and tag, or its error's type and text, must
be equal, and so must the lane's hits where the case reads them. The
lane must serve bit for bit what the full path serves.
"""

import pytest

from cockroach_tpu_torch.exec import oltplane
from cockroach_tpu_torch.exec.engine import Engine
from tests.test_torch_groupagg_large import reference_modules


@pytest.fixture(scope="module")
def ref():
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.exec.oltplane") as mods:
        yield mods


def _outcome(eng, sql, session):
    try:
        r = eng.execute(sql, session)
        return ("ok", r.rows, r.row_count, r.tag)
    except Exception as exc:
        return ("err", type(exc).__name__, str(exc))


class Pair:
    """The port and the reference engine, driven by one script."""

    def __init__(self, ref):
        self.port = Engine(device="cpu")
        self.ref = ref[0].Engine()
        self.sessions = {None: (None, None)}

    def session(self, name):
        self.sessions[name] = (self.port.session(), self.ref.session())

    def run(self, sql, session=None):
        ps, rs = self.sessions[session]
        got = _outcome(self.port, sql, ps)
        want = _outcome(self.ref, sql, rs)
        assert got == want, (sql, got, want)
        return got

    def rows(self, sql, session=None):
        got = self.run(sql, session)
        assert got[0] == "ok", got
        return got[1]

    def close(self):
        self.ref.close()


@pytest.fixture
def pair(ref):
    p = Pair(ref)
    yield p
    p.close()


def _mk(pair, records=100):
    pair.run("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, a INT8, b INT8)")
    vals = ", ".join(f"({i}, {i * 3}, {i * 5})" for i in range(records))
    pair.run(f"INSERT INTO t VALUES {vals}")


@pytest.mark.parametrize("sql", [
    "SELECT a FROM t WHERE k = 42 AND s = 'x''y' LIMIT 10",
    "SELECT field0 FROM usertable WHERE ycsb_key = 7",
    "SELECT a FROM t WHERE f = 1.5",
    "UPDATE usertable SET field0 = 12 WHERE ycsb_key = 99",
    "INSERT INTO t VALUES (-3, 'a1', 0)"])
def test_normalize_equals_reference(ref, sql):
    assert oltplane.normalize(sql) == ref[1].normalize(sql)


def test_normalize_shapes():
    assert oltplane.normalize(
        "SELECT a FROM t WHERE k = 42 AND s = 'x''y' LIMIT 10") == (
        "SELECT a FROM t WHERE k = ? AND s = ? LIMIT ?", [42, "x'y", 10])
    shape, lits = oltplane.normalize("SELECT a FROM t WHERE f = 1.5")
    assert "1.5" in shape and lits == []


def test_point_read(pair):
    _mk(pair)
    q = "SELECT a, b FROM t WHERE k = 7"
    assert pair.rows(q) == pair.rows(q) == [(21, 35)]
    assert pair.port.lane_hits == pair.ref.lane_hits >= 1
    assert pair.rows("SELECT a FROM t WHERE k = 10000") == []


def test_range_scans(pair):
    _mk(pair)
    h0 = pair.port.lane_hits
    for lo in (10, 90, 97):
        assert pair.rows(f"SELECT k, a FROM t WHERE k >= {lo} ORDER BY k "
                         f"LIMIT 5") == [(i, i * 3)
                                         for i in range(lo, min(lo + 5,
                                                                100))]
    assert pair.rows("SELECT k FROM t WHERE k >= 5 AND k < 8 "
                     "ORDER BY k") == [(5,), (6,), (7,)]
    assert pair.rows("SELECT k FROM t WHERE k > 5 AND k <= 8 "
                     "ORDER BY k") == [(6,), (7,), (8,)]
    assert pair.port.lane_hits - h0 == 5


def test_star_and_aliases(pair):
    _mk(pair)
    assert pair.rows("SELECT b AS bb, a FROM t WHERE k = 2") == [(10, 6)]
    assert pair.rows("SELECT * FROM t WHERE k = 2") == [(2, 6, 10)]
    assert pair.port.execute("SELECT * FROM t WHERE k = 2").names == \
        ["k", "a", "b"]


def test_null_columns(pair):
    pair.run("CREATE TABLE n (k INT PRIMARY KEY, v INT)")
    pair.run("INSERT INTO n VALUES (1, NULL)")
    pair.run("INSERT INTO n VALUES (2, 5)")
    for _ in range(2):   # the second pass reads the built shapes
        assert pair.rows("SELECT v FROM n WHERE k = 1") == [(None,)]
        assert pair.rows("SELECT v FROM n WHERE k = 2") == [(5,)]
    pair.run("UPDATE n SET v = NULL WHERE k = 2")
    assert pair.rows("SELECT k, v FROM n WHERE k >= 0 ORDER BY k") == [
        (1, None), (2, None)]


def test_updates_and_inserts_seen_everywhere(pair):
    _mk(pair, 10)
    pair.run("UPDATE t SET a = 777 WHERE k = 3")
    assert pair.rows("SELECT a FROM t WHERE k = 3") == [(777,)]
    # the full path flushes the lane's queue first
    assert pair.rows("SELECT sum(a) FROM t WHERE k = 3") == [(777,)]
    assert pair.run("UPDATE t SET a = 1 WHERE k = 99999")[2] == 0
    pair.run("INSERT INTO t VALUES (500, 1, 2)")
    assert pair.rows("SELECT a, b FROM t WHERE k = 500") == [(1, 2)]
    assert pair.rows("SELECT count(*) FROM t") == [(11,)]
    assert pair.port.lane_hits >= 4


def test_duplicate_pk(pair):
    _mk(pair, 10)
    pair.run("INSERT INTO t VALUES (100, 0, 0)")
    got = pair.run("INSERT INTO t VALUES (100, 0, 0)")
    assert got[0] == "err" and "duplicate key" in got[2]
    got = pair.run("INSERT INTO t VALUES (4, 0, 0)")   # bulk-loaded key
    assert got[0] == "err" and "duplicate key" in got[2]


def test_delete_then_reinsert(pair):
    _mk(pair, 10)
    assert pair.run("DELETE FROM t WHERE k = 5")[2] == 1
    assert pair.run("DELETE FROM t WHERE k = 5")[2] == 0
    assert pair.rows("SELECT a FROM t WHERE k = 5") == []
    pair.run("INSERT INTO t VALUES (5, 42, 43)")
    assert pair.rows("SELECT a FROM t WHERE k = 5") == [(42,)]
    assert pair.rows("SELECT count(*) FROM t") == [(10,)]


def test_not_null(pair):
    pair.run("CREATE TABLE nn (k INT PRIMARY KEY, v INT NOT NULL)")
    pair.run("INSERT INTO nn VALUES (1, 1)")   # builds the shape
    got = pair.run("UPDATE nn SET v = NULL WHERE k = 1")
    assert got[0] == "err" and "non-null" in got[2]
    got = pair.run("INSERT INTO nn VALUES (2, NULL)")
    assert got[0] == "err" and "non-null" in got[2]
    assert pair.rows("SELECT k, v FROM nn WHERE k >= 0 ORDER BY k") == [
        (1, 1)]


def test_many_inserts_publish_few_chunks(pair):
    """The deferred publish: 200 lane inserts, then one flush, add one
    chunk, not 200."""
    pair.run("CREATE TABLE m (k INT PRIMARY KEY, v INT)")
    pair.run("INSERT INTO m VALUES (0, 0)")
    before = len(pair.port.store.table("m").chunks)
    for i in range(1, 201):
        pair.run(f"INSERT INTO m VALUES ({i}, {i})")
    assert pair.port._lane_pending["m"]
    assert pair.rows("SELECT count(*), sum(v) FROM m") == [(201, 20100)]
    assert len(pair.port.store.table("m").chunks) - before == 1
    assert not pair.port._lane_pending


def test_lane_bypassed_inside_txn(pair):
    """An explicit txn takes the full path: its snapshot must not see a
    later lane write."""
    _mk(pair, 10)
    pair.session("s1")
    pair.run("BEGIN", "s1")
    assert pair.rows("SELECT a FROM t WHERE k = 1", "s1") == [(3,)]
    h0 = pair.port.lane_hits
    pair.run("UPDATE t SET a = 999 WHERE k = 1")     # another session
    assert pair.port.lane_hits == h0 + 1
    assert pair.rows("SELECT a FROM t WHERE k = 1", "s1") == [(3,)]
    pair.run("COMMIT", "s1")
    assert pair.rows("SELECT a FROM t WHERE k = 1") == [(999,)]


def test_write_write_last_wins(pair):
    _mk(pair, 10)
    pair.run("UPDATE t SET a = 1 WHERE k = 2")
    pair.run("UPDATE t SET a = 2 WHERE k = 2")
    assert pair.rows("SELECT a FROM t WHERE k = 2") == [(2,)]


def test_drop_and_recreate(pair):
    _mk(pair, 10)
    pair.run("SELECT a FROM t WHERE k = 1")
    pair.run("UPDATE t SET a = 5 WHERE k = 1")
    pair.run("DROP TABLE t")
    pair.run("CREATE TABLE t (k INT PRIMARY KEY, a INT, b INT)")
    pair.run("INSERT INTO t VALUES (1, 111, 0)")
    assert pair.rows("SELECT a FROM t WHERE k = 1") == [(111,)]
    assert pair.rows("SELECT count(*) FROM t") == [(1,)]


def test_full_path_write_invalidates_mirror(pair):
    """A multi-row UPDATE takes the full path and moves the generation;
    the next lane read rebuilds the mirror and sees it."""
    _mk(pair, 20)
    assert pair.rows("SELECT a FROM t WHERE k = 1") == [(3,)]
    gen = pair.port._lane_mirrors["t"].synced_gen
    pair.run("UPDATE t SET a = a + 1000 WHERE k < 5")
    assert pair.rows("SELECT a FROM t WHERE k = 1") == [(1003,)]
    assert pair.rows("SELECT a FROM t WHERE k = 10") == [(30,)]
    assert pair.port._lane_mirrors["t"].synced_gen != gen


def test_literal_kind_mismatch_binds_on_the_full_path(pair):
    """A shape built for k = 42, reused with k = 'abc', is not served by
    the lane: the full path raises the binder's error."""
    _mk(pair, 10)
    assert pair.rows("SELECT a FROM t WHERE k = 4") == [(12,)]
    h0 = pair.port.lane_hits
    got = pair.run("SELECT a FROM t WHERE k = 'abc'")
    assert got[:2] == ("err", "BindError")
    assert pair.port.lane_hits == h0
    got = pair.run("UPDATE t SET a = 'x' WHERE k = 4")
    assert got[:2] == ("err", "BindError")
    assert pair.rows("SELECT a FROM t WHERE k = 4") == [(12,)]


def test_ineligible_tables_take_the_full_path(pair):
    """A STRING column, a CHECK, a DEFAULT, a multi-column key: no lane
    shape, same answers."""
    for ddl in ("CREATE TABLE s1 (k INT PRIMARY KEY, v STRING)",
                "CREATE TABLE s2 (k INT PRIMARY KEY, v INT, CHECK (v > 0))",
                "CREATE TABLE s3 (k INT, j INT, v INT, PRIMARY KEY (k, j))"):
        pair.run(ddl)
    pair.run("INSERT INTO s1 VALUES (1, 'a')")
    pair.run("INSERT INTO s2 VALUES (1, 2)")
    got = pair.run("INSERT INTO s2 VALUES (2, -1)")
    assert got[0] == "err" and "check" in got[2].lower()
    pair.run("INSERT INTO s3 VALUES (1, 2, 3)")
    h0 = pair.port.lane_hits
    assert pair.rows("SELECT v FROM s1 WHERE k = 1") == [("a",)]
    assert pair.rows("SELECT v FROM s2 WHERE k = 1") == [(2,)]
    assert pair.rows("SELECT v FROM s3 WHERE k = 1") == [(3,)]
    assert pair.port.lane_hits == h0


def test_column_default_is_not_dropped():
    """A table with a column DEFAULT stays off the lane, so an INSERT
    leaving the column out stores the default. (The reference's lane
    serves it and stores NULL: ROADMAP Queue 3.)"""
    e = Engine(device="cpu")
    e.execute("CREATE TABLE d (k INT PRIMARY KEY, v INT DEFAULT 7)")
    e.execute("INSERT INTO d (k) VALUES (1)")
    e.execute("INSERT INTO d (k) VALUES (2)")
    assert e.execute("SELECT k, v FROM d WHERE k >= 0 ORDER BY k"
                     ).rows == [(1, 7), (2, 7)]
    assert e.lane_hits == 0


def test_prepared_statement_sees_lane_writes(ref):
    """A Prepared made before a lane write reads it: its run flushes the
    lane's queue for its tables as execute() does. (The reference's
    Prepared.run does not and returns the stale sum: ROADMAP Queue 3.)"""
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (k INT PRIMARY KEY, v INT)")
    e.execute("INSERT INTO t VALUES (1, 1), (2, 2)")
    p = e.prepare("SELECT sum(v) FROM t")
    assert p.run().rows == [(3,)]
    h0 = e.lane_hits
    e.execute("UPDATE t SET v = 100 WHERE k = 1")
    assert e.lane_hits == h0 + 1 and e._lane_pending
    assert p.run().rows == [(102,)]
    assert not e._lane_pending
    je = ref[0].Engine()
    try:
        je.execute("CREATE TABLE t (k INT PRIMARY KEY, v INT)")
        je.execute("INSERT INTO t VALUES (1, 1), (2, 2)")
        jp = je.prepare("SELECT sum(v) FROM t")
        jp.run()
        je.execute("UPDATE t SET v = 100 WHERE k = 1")
        assert jp.run().rows == [(3,)]            # the reference's fault
        assert je.execute("SELECT sum(v) FROM t").rows == [(102,)]
    finally:
        je.close()
