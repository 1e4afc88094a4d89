"""Online schema changes in the port against the JAX package's engine.

Every case of the reference's tests/test_indexes.py and
tests/test_schemachange.py, the lease and descriptor-version cases of
tests/test_catalog.py, and the index cases of tests/test_oltp_lane.py,
run through ``Engine(device="cpu")`` and the reference Engine with the
same statements (``Pair``): each statement's rows, row count and tag, or
its error's type and text, must be equal on both. Cases that drive the
internals (a crashed backfill adopted by a second registry, a
restarted index cache, leases held by a second holder) do the same steps
on both packages' objects and compare what each observes.
"""

import threading
import time

import pytest

from cockroach_tpu_torch.kv.txn import DB as KVDB
from cockroach_tpu_torch.kv.txn import KVStore
from tests.test_torch_groupagg_large import reference_modules
from tests.test_torch_oltp_lane import Pair as _Pair

REF_MODULES = ("cockroach_tpu.exec.engine", "cockroach_tpu.jobs",
               "cockroach_tpu.jobs.registry", "cockroach_tpu.catalog",
               "cockroach_tpu.catalog.descriptor", "cockroach_tpu.sql.types",
               "cockroach_tpu.kv.txn")


@pytest.fixture(scope="module")
def ref():
    with reference_modules(*REF_MODULES) as mods:
        yield mods


class Pair(_Pair):
    """``Pair`` with unordered comparison and session variables."""

    def session(self, name, **vars_):
        super().session(name)
        for s in self.sessions[name]:
            for k, v in vars_.items():
                s.vars.set(k, v)

    def run(self, sql, session=None, ordered=True):
        if ordered:
            return super().run(sql, session)
        ps, rs = self.sessions[session]
        got = _outcome_sorted(self.port, sql, ps)
        want = _outcome_sorted(self.ref, sql, rs)
        assert got == want, (sql, got, want)
        return got

    def rows(self, sql, session=None, ordered=True):
        got = self.run(sql, session, ordered)
        assert got[0] == "ok", got
        return got[1]

    def err(self, sql, match, session=None):
        got = self.run(sql, session)
        assert got[0] == "err" and match in got[2], got
        return got

    def both(self, sql, ordered=False):
        """The reference's ``both``: the statement through the fast
        paths and through the compiled scan (``index_scan = off``) on
        each engine; all four agree."""
        if "on" not in self.sessions:
            self.session("on")
            self.session("off", index_scan="off")
        on = self.rows(sql, "on", ordered)
        assert self.rows(sql, "off", ordered) == on
        return on

    def each(self, fn):
        """``fn(engine, reference?)`` on both engines; both results."""
        return fn(self.port, False), fn(self.ref, True)


def _outcome_sorted(eng, sql, session):
    try:
        r = eng.execute(sql, session)
        return ("ok", sorted(r.rows, key=repr), r.row_count, r.tag)
    except Exception as exc:
        return ("err", type(exc).__name__, str(exc))


@pytest.fixture
def pair(ref):
    p = Pair(ref)
    yield p
    p.close()


@pytest.fixture
def ipair(pair):
    """tests/test_indexes.py's fixture."""
    pair.run("CREATE TABLE t (a INT PRIMARY KEY, b INT, s STRING, "
             "m DECIMAL(10,2))")
    pair.run("INSERT INTO t VALUES (1,2,'x',1.50),(2,3,'y',2.25),"
             "(3,3,'z',0.75)")
    return pair


# -- tests/test_indexes.py ----------------------------------------------------
class TestIndexDDL:
    def test_create_show_drop(self, ipair):
        ipair.run("CREATE INDEX bi ON t (b)")
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        rows = ipair.rows("SHOW INDEXES FROM t")
        assert {r[1] for r in rows} == {"primary", "bi", "si"}
        ddl = ipair.rows("SHOW CREATE TABLE t")[0][1]
        assert "INDEX bi (b)" in ddl and "UNIQUE INDEX si (s)" in ddl
        ipair.run("DROP INDEX si")
        assert {r[1] for r in ipair.rows("SHOW INDEXES FROM t")} == \
            {"primary", "bi"}
        # the two index jobs, as SHOW JOBS lists them
        assert ipair.rows("SHOW JOBS") == [
            (1, "index-backfill", "succeeded", 1.0),
            (2, "index-backfill", "succeeded", 1.0)]

    def test_create_if_not_exists_and_errors(self, ipair):
        ipair.run("CREATE INDEX bi ON t (b)")
        ipair.run("CREATE INDEX IF NOT EXISTS bi ON t (b)")
        ipair.err("CREATE INDEX bi ON t (b)", "already exists")
        ipair.err("CREATE INDEX x ON t (nope)", "does not exist")
        ipair.err("DROP INDEX nope", "does not exist")
        ipair.run("DROP INDEX IF EXISTS nope")

    def test_unique_backfill_rejects_duplicates(self, ipair):
        ipair.run("INSERT INTO t VALUES (4,3,'w',0.10)")
        ipair.err("CREATE UNIQUE INDEX ub ON t (b)", "duplicate key")
        # the failed index rolled back: not listed, duplicates allowed
        assert all(r[1] != "ub" for r in ipair.rows("SHOW INDEXES FROM t"))
        ipair.run("INSERT INTO t VALUES (5,3,'v',0.20)")
        assert ipair.rows("SHOW JOBS") == [(1, "index-backfill", "failed",
                                            0.0)]


class TestUniqueEnforcement:
    def test_insert_conflict(self, ipair):
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        ipair.err("INSERT INTO t VALUES (4,9,'x',0.0)", "unique index 'si'")
        ipair.run("INSERT INTO t VALUES (4,9,'w',0.0)")

    def test_update_conflict_and_release(self, ipair):
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        ipair.err("UPDATE t SET s='y' WHERE a=1", "unique index")
        ipair.run("DELETE FROM t WHERE a=2")  # frees 'y'
        ipair.run("UPDATE t SET s='y' WHERE a=1")

    def test_null_exempt(self, ipair):
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        ipair.run("INSERT INTO t VALUES (10,1,NULL,0.0),(11,1,NULL,0.0)")

    def test_in_txn_delete_then_reuse(self, ipair):
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        ipair.session("s")
        ipair.run("BEGIN", "s")
        ipair.run("DELETE FROM t WHERE a=3", "s")
        ipair.run("INSERT INTO t VALUES (6,0,'z',0.0)", "s")
        ipair.run("COMMIT", "s")
        assert ipair.rows("SELECT a FROM t WHERE s='z'",
                          ordered=False) == [(6,)]

    def test_in_statement_duplicate(self, ipair):
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        ipair.err("INSERT INTO t VALUES (7,0,'q',0.0),(8,0,'q',0.0)",
                  "unique index")
        assert ipair.rows("SELECT a FROM t WHERE s='q'") == []

    def test_rollback_releases_value(self, ipair):
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        ipair.session("s")
        ipair.run("BEGIN", "s")
        ipair.run("INSERT INTO t VALUES (7,0,'q',0.0)", "s")
        ipair.run("ROLLBACK", "s")
        ipair.run("INSERT INTO t VALUES (8,0,'q',0.0)")

    def test_concurrent_writers_conflict(self, ipair):
        """Two open txns inserting one unique value: exactly one commits
        (the conflict on the index key's KV entry)."""
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        ipair.session("s1")
        ipair.session("s2")
        ipair.run("BEGIN", "s1")
        ipair.run("BEGIN", "s2")
        committed = 0
        for sess, a in (("s1", 20), ("s2", 21)):
            got = ipair.run(f"INSERT INTO t VALUES ({a},0,'dup',0.0)", sess)
            if got[0] == "ok" and ipair.run("COMMIT", sess)[0] == "ok":
                committed += 1
            else:
                ipair.run("ROLLBACK", sess)
        assert committed == 1
        assert len(ipair.rows("SELECT a FROM t WHERE s='dup'")) == 1

    def test_upsert_maintains_entries(self, ipair):
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        ipair.run("UPSERT INTO t VALUES (1,2,'xx',1.50)")  # frees 'x'
        ipair.run("INSERT INTO t VALUES (9,9,'x',0.0)")
        ipair.err("UPSERT INTO t VALUES (9,9,'xx',0.0)", "unique index")


class TestIndexFastPath:
    def test_matches_full_scan(self, ipair):
        ipair.run("CREATE INDEX bi ON t (b)")
        assert ipair.both("SELECT * FROM t WHERE a = 2")
        assert ipair.both("SELECT s, m FROM t WHERE b = 3")
        assert ipair.both("SELECT a FROM t WHERE b = 3 AND s = 'z'")
        assert ipair.both("SELECT a, b FROM t WHERE b = 3 ORDER BY a DESC "
                          "LIMIT 1")
        assert ipair.both("SELECT * FROM t WHERE b = 99") == []

    def test_counts_as_fastpath(self, ipair):
        def count(e, _ref):
            c = e.metrics.counter("sql.select.index_fastpath", "x")
            base = c.value()
            e.execute("SELECT * FROM t WHERE a = 1")
            e.execute("CREATE INDEX bi ON t (b)")
            e.execute("SELECT s FROM t WHERE b = 3")
            return c.value() - base
        assert ipair.each(count) == (2, 2)

    def test_read_your_writes(self, ipair):
        ipair.run("CREATE INDEX bi ON t (b)")
        ipair.session("s")
        ipair.run("BEGIN", "s")
        ipair.run("INSERT INTO t VALUES (4,3,'w',9.99)", "s")
        ipair.run("DELETE FROM t WHERE a = 2", "s")
        assert ipair.rows("SELECT a FROM t WHERE b = 3", "s",
                          ordered=False) == [(3,), (4,)]
        ipair.run("ROLLBACK", "s")
        assert ipair.rows("SELECT a FROM t WHERE b = 3",
                          ordered=False) == [(2,), (3,)]

    def test_txn_snapshot_visibility(self, ipair):
        """A txn pinned before a delete still sees the old row through
        the index (the locator holds superseded versions)."""
        ipair.run("CREATE INDEX bi ON t (b)")
        ipair.session("s")
        ipair.run("BEGIN", "s")
        ipair.run("SELECT 1", "s")  # pins the read timestamp
        ipair.run("DELETE FROM t WHERE a = 2")
        assert ipair.rows("SELECT a FROM t WHERE b = 3", "s",
                          ordered=False) == [(2,), (3,)]
        ipair.run("COMMIT", "s")
        assert ipair.rows("SELECT a FROM t WHERE b = 3") == [(3,)]

    def test_explain_shows_index(self, ipair):
        ipair.run("CREATE INDEX bi ON t (b)")
        plan = "\n".join(r[0] for r in ipair.rows(
            "EXPLAIN SELECT s FROM t WHERE b = 3"))
        assert "index scan t@bi" in plan
        plan = "\n".join(r[0] for r in ipair.rows(
            "EXPLAIN SELECT s FROM t WHERE a = 1"))
        assert "index scan t@primary" in plan

    def test_fallbacks(self, ipair):
        """Shapes the fast path declines (aggregates, ranges,
        expressions): the scan path answers them."""
        ipair.run("CREATE INDEX bi ON t (b)")
        assert ipair.rows("SELECT count(*) FROM t WHERE b = 3") == [(2,)]
        assert ipair.rows("SELECT a FROM t WHERE b > 2",
                          ordered=False) == [(2,), (3,)]
        assert ipair.rows("SELECT a + 1 FROM t WHERE b = 3",
                          ordered=False) == [(3,), (4,)]

    def test_after_dml_stays_fresh(self, ipair):
        ipair.run("CREATE INDEX bi ON t (b)")
        for i in range(10, 30):
            ipair.run(f"INSERT INTO t VALUES ({i},7,'s{i}',0.0)")
        assert len(ipair.both("SELECT a FROM t WHERE b = 7")) == 20
        ipair.run("DELETE FROM t WHERE b = 7 AND a < 20")
        assert len(ipair.both("SELECT a FROM t WHERE b = 7")) == 10
        ipair.run("UPDATE t SET b = 8 WHERE a = 25")
        assert len(ipair.both("SELECT a FROM t WHERE b = 7")) == 9
        assert ipair.both("SELECT a FROM t WHERE b = 8") == [(25,)]


class TestIndexOnRestart:
    def test_descriptor_survives_engine_restart(self, ipair):
        """Indexes live in the descriptor (KV): with the engine's index
        cache cleared, unique enforcement still holds."""
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        ipair.each(lambda e, _r: e._index_defs.clear())
        ipair.err("INSERT INTO t VALUES (4,9,'x',0.0)", "unique index")


class TestReviewRegressions:
    def test_drop_column_with_index_rejected(self, ipair):
        ipair.run("CREATE UNIQUE INDEX si ON t (s)")
        ipair.err("ALTER TABLE t DROP COLUMN s", "referenced by")
        ipair.run("DROP INDEX si")
        ipair.run("ALTER TABLE t DROP COLUMN s")

    def test_primary_name_reserved(self, ipair):
        ipair.err("CREATE INDEX primary ON t (b)", "reserved")

    def test_drop_index_ambiguous(self, ipair):
        ipair.run("CREATE TABLE t2 (a INT PRIMARY KEY, b INT)")
        ipair.run("CREATE INDEX dup ON t (b)")
        ipair.run("CREATE INDEX dup ON t2 (b)")
        ipair.err("DROP INDEX dup", "ambiguous")


@pytest.fixture
def rpair(pair):
    """TestRangeFastPath's fixture."""
    pair.run("CREATE TABLE r (k INT PRIMARY KEY, v INT, s STRING)")
    pair.run("INSERT INTO r VALUES " + ",".join(
        f"({i},{i * 3 % 7},'s{i}')" for i in range(100)))
    pair.run("CREATE INDEX vi ON r (v, k)")
    return pair


class TestRangeFastPath:
    def test_shapes_match_compiled_scan(self, rpair):
        b = rpair.both
        assert b("SELECT k FROM r WHERE k >= 90 ORDER BY k LIMIT 5", True)
        assert b("SELECT k FROM r WHERE k > 5 AND k < 9 ORDER BY k", True)
        assert b("SELECT k FROM r WHERE k >= 50")
        assert b("SELECT k, v FROM r WHERE v = 2 AND k >= 50 "
                 "ORDER BY k LIMIT 3", True)
        assert b("SELECT k FROM r WHERE v = 3 AND k > 50 AND s = 's57' "
                 "ORDER BY k", True) == [(57,)]
        assert b("SELECT k FROM r WHERE k >= 95 ORDER BY k DESC", True)
        assert b("SELECT k FROM r WHERE k >= 200 ORDER BY k", True) == []

    def test_counts_as_range_fastpath(self, rpair):
        def count(e, _ref):
            c = e.metrics.counter("sql.select.range_fastpath", "x")
            base = c.value()
            e.execute("SELECT k FROM r WHERE k >= 90 ORDER BY k LIMIT 3")
            # the secondary index (v, k): equality on v, a bound on k
            e.execute("SELECT k FROM r WHERE v = 2 AND k >= 50 "
                      "ORDER BY k LIMIT 3")
            return c.value() - base
        assert rpair.each(count) == (2, 2)

    def test_txn_overlay(self, rpair):
        rpair.session("s")
        rpair.run("BEGIN", "s")
        rpair.run("INSERT INTO r VALUES (1000, 1, 'new')", "s")
        rpair.run("DELETE FROM r WHERE k = 99", "s")
        assert rpair.rows("SELECT k FROM r WHERE k >= 98 ORDER BY k",
                          "s") == [(98,), (1000,)]
        rpair.run("ROLLBACK", "s")
        assert rpair.rows("SELECT k FROM r WHERE k >= 98 ORDER BY k") == \
            [(98,), (99,)]

    def test_limit_early_stop_correct(self, rpair):
        for off in (0, 3):
            q = (f"SELECT k FROM r WHERE k >= 10 ORDER BY k "
                 f"LIMIT 4 OFFSET {off}")
            assert rpair.both(q, True) == [(10 + off + i,) for i in range(4)]

    def test_stays_fresh_after_dml(self, rpair):
        rpair.run("DELETE FROM r WHERE k >= 95")
        assert rpair.both("SELECT k FROM r WHERE k >= 90 ORDER BY k",
                          True) == [(90,), (91,), (92,), (93,), (94,)]
        rpair.run("INSERT INTO r VALUES (97, 0, 'x')")
        assert rpair.both("SELECT k FROM r WHERE k >= 94 ORDER BY k",
                          True) == [(94,), (97,)]

    def test_inexact_literals_fall_back(self, rpair):
        assert rpair.both("SELECT k FROM r WHERE k > 0.5 ORDER BY k "
                          "LIMIT 3", True) == [(1,), (2,), (3,)]
        assert rpair.both("SELECT k FROM r WHERE k <= 2.5 ORDER BY k",
                          True) == [(0,), (1,), (2,)]
        assert rpair.both("SELECT k FROM r WHERE k = 0.5") == []

    def test_uncoercible_eq_is_an_error_both_paths(self, rpair):
        rpair.session("on")
        rpair.session("off", index_scan="off")
        for s in ("on", "off"):
            got = rpair.run("SELECT k FROM r WHERE k = 'zz' AND k > 10", s)
            assert got[:2] == ("err", "BindError"), got

    def test_bound_tightness_at_ties(self, rpair):
        assert rpair.both("SELECT k FROM r WHERE k < 5 AND k <= 5 "
                          "ORDER BY k", True) == [(i,) for i in range(5)]
        assert rpair.both("SELECT k FROM r WHERE k > 5 AND k >= 5 "
                          "ORDER BY k LIMIT 2", True) == [(6,), (7,)]


class TestUniqueInCreateTable:
    """UNIQUE column and table constraints are unique indexes at birth,
    and FOREIGN KEYs may reference them (reference exec/ddl.py:91)."""

    def test_column_and_table_constraints(self, pair):
        pair.run("CREATE TABLE u (k INT PRIMARY KEY, v INT UNIQUE, "
                 "a INT, b INT, UNIQUE (a, b))")
        assert pair.rows("SHOW INDEXES FROM u") == [
            ("u", "primary", "k", True, "public"),
            ("u", "u_v_key", "v", True, "public"),
            ("u", "u_a_b_key", "a, b", True, "public")]
        pair.run("INSERT INTO u VALUES (1, 5, 1, 1), (2, 6, 1, 2)")
        pair.err("INSERT INTO u VALUES (3, 5, 9, 9)", "unique index")
        pair.err("INSERT INTO u VALUES (3, 7, 1, 2)", "unique index")
        pair.run("INSERT INTO u VALUES (3, NULL, 1, NULL), "
                 "(4, NULL, 1, NULL)")
        pair.err("CREATE TABLE w (k INT PRIMARY KEY, UNIQUE (nope))",
                 "not in table")

    def test_foreign_key_to_unique(self, pair):
        pair.run("CREATE TABLE p (k INT PRIMARY KEY, code INT UNIQUE, "
                 "x INT)")
        pair.run("INSERT INTO p VALUES (1, 100, 0), (2, 200, 0)")
        pair.run("CREATE TABLE c (k INT PRIMARY KEY, "
                 "pc INT REFERENCES p (code))")
        pair.run("INSERT INTO c VALUES (1, 100)")
        pair.err("INSERT INTO c VALUES (2, 300)", "foreign key")
        pair.err("DELETE FROM p WHERE k = 1", "foreign key")
        pair.err("CREATE TABLE c2 (k INT PRIMARY KEY, "
                 "px INT REFERENCES p (x))", "unique index")


# -- tests/test_schemachange.py ---------------------------------------------
@pytest.fixture
def spair(pair):
    """tests/test_schemachange.py's fixture: two chunks (the reference
    seals its open chunk; each of the port's publishes is one)."""
    pair.run("CREATE TABLE t (a INT PRIMARY KEY, s STRING)")
    pair.run("INSERT INTO t VALUES (1,'x'),(2,'y')")
    pair.ref.store.seal("t")
    pair.run("INSERT INTO t VALUES (3,'z')")
    pair.ref.store.seal("t")
    assert len(pair.port.store.table("t").chunks) == 2
    return pair


class TestAddColumn:
    def test_add_with_default_backfills_all_chunks(self, spair):
        spair.run("ALTER TABLE t ADD COLUMN score FLOAT DEFAULT 1.5")
        assert spair.rows("SELECT a, score FROM t ORDER BY a") == \
            [(1, 1.5), (2, 1.5), (3, 1.5)]
        assert spair.rows("SHOW JOBS") == [(1, "schema-change",
                                            "succeeded", 1.0)]

    def test_add_without_default_is_null(self, spair):
        spair.run("ALTER TABLE t ADD COLUMN extra INT")
        assert spair.rows("SELECT a, extra FROM t ORDER BY a") == \
            [(1, None), (2, None), (3, None)]

    def test_new_writes_get_default(self, spair):
        spair.run("ALTER TABLE t ADD COLUMN score FLOAT DEFAULT 2.0")
        spair.run("INSERT INTO t VALUES (4,'w',9.0)")
        spair.run("INSERT INTO t (a, s) VALUES (5,'v')")
        assert spair.rows("SELECT a, score FROM t ORDER BY a")[3:] == \
            [(4, 9.0), (5, 2.0)]

    def test_string_column_with_default(self, spair):
        spair.run("ALTER TABLE t ADD COLUMN tag STRING DEFAULT 'hi'")
        assert spair.rows("SELECT tag FROM t WHERE a = 1") == [("hi",)]
        assert spair.rows("SELECT count(*) FROM t WHERE tag = 'hi'") == \
            [(3,)]

    def test_decimal_default_rescaled(self, spair):
        spair.run("ALTER TABLE t ADD COLUMN m DECIMAL(10,4) DEFAULT 1.5")
        assert spair.rows("SELECT m FROM t WHERE a = 1") == [(1.5,)]
        assert spair.rows("SELECT sum(m) FROM t") == [(4.5,)]

    def test_not_null_requires_default_when_nonempty(self, spair):
        spair.err("ALTER TABLE t ADD COLUMN x INT NOT NULL", "DEFAULT")

    def test_versions_advance(self, spair):
        v0 = spair.each(lambda e, _r: e.catalog.get_by_name("t").version)
        spair.run("ALTER TABLE t ADD COLUMN x INT DEFAULT 7")
        got = spair.each(lambda e, _r: (e.catalog.get_by_name("t").version,
                                        e.catalog.get_by_name("t")
                                        .column("x").state))
        assert got == ((v0[0] + 2, "public"), (v0[1] + 2, "public"))

    def test_duplicate_column_rejected(self, spair):
        spair.err("ALTER TABLE t ADD COLUMN s STRING", "already exists")


class TestDropColumn:
    def test_drop_column(self, spair):
        spair.run("ALTER TABLE t DROP COLUMN s")
        assert spair.rows("SELECT * FROM t ORDER BY a") == [(1,), (2,), (3,)]
        spair.err("SELECT s FROM t", "unknown column")
        assert spair.each(lambda e, _r: [
            c.name for c in e.catalog.get_by_name("t").columns]) == \
            (["a"], ["a"])

    def test_drop_pk_rejected(self, spair):
        spair.err("ALTER TABLE t DROP COLUMN a", "primary key")

    def test_drop_missing_rejected(self, spair):
        spair.err("ALTER TABLE t DROP COLUMN nope", "does not exist")


def _orphan_add_column(e, mods, column, default, lease_seconds,
                       crash_after_chunk=None):
    """The WRITE_ONLY phase of an ADD COLUMN done by hand (what
    ``_exec_alter`` does before its job), then the job created by a
    registry of a session that dies: (job id, its registry)."""
    jobs, registry, descriptor, types = mods
    desc = e.catalog.get_by_name("t")
    desc.columns.append(descriptor.ColumnDescriptor(
        column, types.INT8, True, descriptor.WRITE_ONLY, default))
    e.leases.publish(desc)
    e.store.add_column("t", types.ColumnSchema(column, types.INT8),
                       default=default, hidden=True)
    dead = registry.Registry(e.kv, session_id="crashy",
                             lease_seconds=lease_seconds)
    dead.register(jobs.SCHEMA_CHANGE_JOB, lambda: jobs.SchemaChangeResumer(
        e, crash_after_chunk=crash_after_chunk))
    return dead.create(jobs.SCHEMA_CHANGE_JOB,
                       {"table": "t", "column": column}), dead


def _mods(ref, is_ref):
    if is_ref:
        return ref[1], ref[2], ref[4], ref[5]
    from cockroach_tpu_torch import jobs
    from cockroach_tpu_torch.catalog import descriptor
    from cockroach_tpu_torch.jobs import registry
    from cockroach_tpu_torch.sql import types
    return jobs, registry, descriptor, types


class TestCrashResume:
    def test_backfill_survives_crash(self, spair, ref):
        """A schema change killed mid-backfill completes once a new
        registry adopts its job (pkg/jobs' kill-and-resume contract)."""
        def crash(e, is_ref):
            mods = _mods(ref, is_ref)
            jid, dead = _orphan_add_column(e, mods, "bf", 42, 0.05,
                                           crash_after_chunk=1)
            with pytest.raises(BaseException) as ei:
                dead.run_job(jid)
            assert type(ei.value).__name__ == "_CrashForTesting"
            return jid, dead.job(jid).status, dead.job(jid).progress
        jids = spair.each(crash)
        assert jids[0] == jids[1] and jids[0][1] == "running"
        # the column is still invisible: the job did not finish
        spair.err("SELECT bf FROM t", "unknown column")
        time.sleep(0.1)  # the crashed lease lapses

        def adopt(e, is_ref):
            jobs, registry, _d, _t = _mods(ref, is_ref)
            fresh = registry.Registry(e.kv, session_id="fresh")
            fresh.register(jobs.SCHEMA_CHANGE_JOB,
                           lambda: jobs.SchemaChangeResumer(e))
            return [(r.id, r.status) for r in fresh.adopt_and_run_all()]
        assert spair.each(adopt) == ([(1, "succeeded")],) * 2
        assert spair.rows("SELECT a, bf FROM t ORDER BY a") == \
            [(1, 42), (2, 42), (3, 42)]
        assert spair.each(lambda e, _r: e.catalog.get_by_name("t")
                          .column("bf").state) == ("public", "public")

    def test_index_backfill_survives_crash(self, spair, ref):
        """The same for a unique index's backfill: the adopted job
        finishes the entries and publishes the index."""
        def crash(e, is_ref):
            jobs, registry, descriptor, _t = _mods(ref, is_ref)
            from_cat = ref[3] if is_ref else __import__(
                "cockroach_tpu_torch.catalog", fromlist=["x"])
            desc = e.catalog.get_by_name("t")
            desc.indexes.append(from_cat.IndexDescriptor(
                "si", 2, ["s"], True, descriptor.WRITE_ONLY))
            e.leases.publish(desc)
            e._index_defs.pop("t", None)
            dead = registry.Registry(e.kv, session_id="crashy",
                                     lease_seconds=0.05)
            dead.register(jobs.schemachange.INDEX_BACKFILL_JOB,
                          lambda: jobs.schemachange.IndexBackfillResumer(
                              e, crash_after_chunk=1))
            jid = dead.create(jobs.schemachange.INDEX_BACKFILL_JOB,
                              {"table": "t", "index": "si"})
            with pytest.raises(BaseException):
                dead.run_job(jid)
            time.sleep(0.1)
            fresh = registry.Registry(e.kv, session_id="fresh")
            fresh.register(jobs.schemachange.INDEX_BACKFILL_JOB,
                           lambda: jobs.schemachange.IndexBackfillResumer(
                               e))
            return [(r.id, r.status, r.progress.get("chunks_done"))
                    for r in fresh.adopt_and_run_all()]
        got = spair.each(crash)
        assert got[0] == got[1] == [(1, "succeeded", 2)]
        spair.each(lambda e, _r: e._index_defs.clear())
        assert spair.rows("SHOW INDEXES FROM t")[1] == \
            ("t", "si", "s", True, "public")
        spair.err("INSERT INTO t VALUES (9, 'y')", "unique index 'si'")


# -- tests/test_catalog.py: descriptor versions and leases -------------------
def _desc(types, cat_mod, name="t"):
    return cat_mod.TableDescriptor(
        id=0, name=name,
        columns=[cat_mod.ColumnDescriptor("a", types.INT8, False),
                 cat_mod.ColumnDescriptor("s", types.STRING),
                 cat_mod.ColumnDescriptor("m", types.SQLType.decimal(10, 2))],
        primary_key=["a"])


def _catalogs(ref):
    """(port Catalog module, types, kv) and the reference's, fresh."""
    ref_cat, ref_types, ref_kv = ref[3], ref[5], ref[6]
    import cockroach_tpu_torch.catalog as port_cat
    from cockroach_tpu_torch.sql import types as port_types
    return ((port_cat, port_types, KVDB(KVStore())),
            (ref_cat, ref_types, ref_kv.DB(ref_kv.KVStore())))


def _each_catalog(ref, fn):
    out = []
    for mod, types, kv in _catalogs(ref):
        try:
            out.append(("ok", fn(mod, types, kv)))
        except Exception as exc:
            out.append(("err", type(exc).__name__, str(exc)))
    assert out[0] == out[1], out
    return out[0]


class TestDescriptorVersions:
    def test_version_skew_rejected(self, ref):
        def case(mod, types, kv):
            cat = mod.Catalog(kv)
            d = cat.create_table(_desc(types, mod))
            stale = cat.get_by_name("t")
            cat.write_new_version(d)
            cat.write_new_version(stale)
        got = _each_catalog(ref, case)
        assert got[0] == "err" and "version skew" in got[2]

    def test_get_by_id_after_drop(self, ref):
        def case(mod, types, kv):
            cat = mod.Catalog(kv)
            d = cat.create_table(_desc(types, mod))
            cat.drop_table("t")
            return (cat.get_by_name("t"), cat.get_by_id(d.id).state,
                    cat.get_by_id(d.id).version)
        assert _each_catalog(ref, case) == ("ok", (None, "dropped", 2))


class TestLeases:
    def test_acquire_caches_until_version_moves(self, ref):
        def case(mod, types, kv):
            cat = mod.Catalog(kv)
            cat.create_table(_desc(types, mod))
            lm = mod.LeaseManager(cat, "n1")
            l1, l2 = lm.acquire("t"), lm.acquire("t")
            cat.write_new_version(cat.get_by_name("t"))
            l3 = lm.acquire("t")
            return (l1 is l2, l3.desc.version, l3 is not l1,
                    lm.count_leases(l3.desc.id, 1),
                    lm.count_leases(l3.desc.id, 2))
        assert _each_catalog(ref, case) == ("ok", (True, 2, True, 0, 1))

    def test_two_version_invariant_blocks_then_drains(self, ref):
        def case(mod, types, kv):
            cat = mod.Catalog(kv)
            cat.create_table(_desc(types, mod))
            n1, n2 = mod.LeaseManager(cat, "n1"), mod.LeaseManager(cat, "n2")
            n1.acquire("t")
            lease2 = n2.acquire("t")
            published = threading.Event()

            def publish():
                d = cat.get_by_name("t")
                n1.release_all()
                n1.publish(d, timeout_s=5)
                published.set()
            th = threading.Thread(target=publish, daemon=True)
            th.start()
            time.sleep(0.2)
            blocked = not published.is_set()  # n2 holds a v1 lease
            n2.release(lease2)
            th.join(timeout=5)
            return blocked, published.is_set(), cat.get_by_name("t").version
        assert _each_catalog(ref, case) == ("ok", (True, True, 2))

    def test_expired_leases_do_not_block(self, ref):
        def case(mod, types, kv):
            cat = mod.Catalog(kv)
            cat.create_table(_desc(types, mod))
            now = [int(1e9)]
            lm = mod.LeaseManager(cat, "n1", now_ns=lambda: now[0],
                                  duration_ns=int(1e9))
            lm.acquire("t")
            other = mod.LeaseManager(cat, "n2", now_ns=lambda: now[0])
            now[0] += int(10e9)  # n1's lease expires
            other.publish(cat.get_by_name("t"), timeout_s=2)
            return cat.get_by_name("t").version
        assert _each_catalog(ref, case) == ("ok", 2)

    def test_wait_times_out_on_stuck_holder(self, ref):
        def case(mod, types, kv):
            cat = mod.Catalog(kv)
            cat.create_table(_desc(types, mod))
            mod.LeaseManager(cat, "n2").acquire("t")
            mod.LeaseManager(cat, "n1").publish(cat.get_by_name("t"),
                                                timeout_s=0.3)
        got = _each_catalog(ref, case)
        assert got[:2] == ("err", "CatalogError") and "timed out" in got[2]

    def test_create_index_waits_for_a_held_lease(self, pair):
        """A lease another holder keeps across statements delays CREATE
        INDEX (under the statement gate) until it is released, with no
        deadlock: the release needs no gate."""
        pair.run("CREATE TABLE t (a INT PRIMARY KEY, b INT)")
        pair.run("INSERT INTO t VALUES (1, 10), (2, 20)")

        def case(e, is_ref):
            mod = __import__("cockroach_tpu.catalog" if is_ref else
                             "cockroach_tpu_torch.catalog", fromlist=["x"])
            holder = mod.LeaseManager(e.catalog, "other-node")
            lease = holder.acquire("t")
            out = {}

            def ddl():
                t0 = time.monotonic()
                e.execute("CREATE INDEX bi ON t (b)")
                out["s"] = time.monotonic() - t0
            th = threading.Thread(target=ddl, daemon=True)
            th.start()
            time.sleep(0.3)
            waiting = th.is_alive()
            holder.release(lease)
            th.join(timeout=10)
            return waiting, not th.is_alive(), out["s"] >= 0.3
        assert pair.each(case) == ((True, True, True),) * 2
        assert pair.rows("SELECT a FROM t WHERE b = 20") == [(2,)]


# -- the lane (tests/test_oltp_lane.py's index case) -------------------------
class TestLaneAndIndexes:
    def test_create_index_pushes_writes_off_lane(self, pair):
        pair.run("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, a INT8, "
                 "b INT8)")
        pair.run("INSERT INTO t VALUES " + ", ".join(
            f"({i}, {i * 3}, {i * 5})" for i in range(10)))
        pair.run("UPDATE t SET a = 5 WHERE k = 1")  # the lane's shape
        pair.run("SELECT a FROM t WHERE k = 1")
        assert pair.port.lane_hits >= 1
        pair.run("CREATE INDEX ta ON t (a)")
        hits = pair.port.lane_hits
        pair.run("UPDATE t SET a = 77 WHERE k = 1")
        assert pair.rows("SELECT a FROM t WHERE k = 1") == [(77,)]
        assert pair.rows("SELECT k FROM t WHERE a = 77") == [(1,)]
        assert pair.port.lane_hits == hits   # every write took the full path

    def test_unique_index_exact_after_lane_writes(self, pair):
        """Lane writes, then a unique index: it validates over them, and
        later writes keep it exact through the full path."""
        pair.run("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, a INT8)")
        pair.run("INSERT INTO t VALUES " + ", ".join(
            f"({i}, {i})" for i in range(20)))
        for i in range(5):
            pair.run(f"UPDATE t SET a = {100 + i} WHERE k = {i}")
        pair.run("INSERT INTO t VALUES (50, 5)")   # a duplicates k = 5's
        assert pair.port.lane_hits >= 5
        pair.err("CREATE UNIQUE INDEX ua ON t (a)", "duplicate key")
        pair.run("DELETE FROM t WHERE k = 50")
        pair.run("CREATE UNIQUE INDEX ua ON t (a)")
        hits = pair.port.lane_hits
        pair.err("UPDATE t SET a = 101 WHERE k = 7", "unique index 'ua'")
        pair.err("INSERT INTO t VALUES (60, 102)", "unique index 'ua'")
        pair.run("UPDATE t SET a = 999 WHERE k = 1")   # frees 101
        pair.run("UPDATE t SET a = 101 WHERE k = 7")
        assert pair.rows("SELECT k FROM t WHERE a = 101") == [(7,)]
        assert pair.rows("SELECT k, a FROM t ORDER BY k") == [
            (i, {0: 100, 1: 999, 2: 102, 3: 103, 4: 104, 7: 101}.get(i, i))
            for i in range(20)]
        assert pair.port.lane_hits == hits

    def test_add_column_default_pushes_writes_off_lane(self, pair):
        pair.run("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, a INT8)")
        pair.run("INSERT INTO t VALUES (1, 1), (2, 2)")
        pair.run("UPDATE t SET a = 3 WHERE k = 1")
        pair.run("ALTER TABLE t ADD COLUMN c INT8 DEFAULT 9")
        hits = pair.port.lane_hits
        pair.run("INSERT INTO t (k, a) VALUES (3, 3)")
        pair.run("UPDATE t SET a = 4 WHERE k = 2")
        assert pair.rows("SELECT k, a, c FROM t ORDER BY k") == \
            [(1, 3, 9), (2, 4, 9), (3, 3, 9)]
        assert pair.port.lane_hits == hits
