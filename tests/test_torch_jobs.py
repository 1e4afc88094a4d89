"""BACKUP/RESTORE, row TTL and IMPORT in the port against the JAX
package's.

Every case of the reference's tests/test_backup_restore.py, the two
backup-chain cases of tests/test_protectedts.py, the three of
tests/test_ttl.py and the IMPORT cases of tests/test_jobs.py run as one
scenario on each package (``Engine(device="cpu")`` against the reference
Engine, each with its own registries, resumers and backup collection):
the restored rows, job statuses, progress and error texts each scenario
observes must be equal on both, and equal to what the reference's test
asserts. A backup's files are each package's own (the port writes typed
arrays, the reference pickled object arrays), so a case that opens one
reads it with its own package's layout. The reference's TTL cases fail
in this container on the ``jax.experimental.enable_x64`` import; under
``reference_modules``'s alias they run, so both sides hold each other
to the reference test's expectations. ``synthetic_chunk`` is compared bit
for bit. Last, TPC-H lineitem at sf 0.01 is backed up, TTL'd, backed up
again and restored on both, and Q1 over the restored table goes through
kernel 1 (the port's plain version here): INT and DECIMAL exact.
"""

import importlib
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from tests.test_torch_groupagg_large import reference_modules

REF_MODULES = ("cockroach_tpu.exec.engine", "cockroach_tpu.jobs",
               "cockroach_tpu.jobs.registry", "cockroach_tpu.jobs.backup",
               "cockroach_tpu.jobs.import_job", "cockroach_tpu.cdc",
               "cockroach_tpu.models.tpch")


def _side(pkg: str, port: bool) -> SimpleNamespace:
    m = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "exec.engine", "jobs", "jobs.registry", "jobs.backup",
        "jobs.import_job", "cdc", "models.tpch")}
    eng_cls = m["exec.engine"].Engine
    return SimpleNamespace(
        name="port" if port else "ref",
        engine=(lambda: eng_cls(device="cpu")) if port else eng_cls,
        Registry=m["jobs"].Registry,
        crash=m["jobs.registry"]._CrashForTesting,
        BACKUP_JOB=m["jobs.backup"].BACKUP_JOB,
        BackupResumer=m["jobs.backup"].BackupResumer,
        IMPORT_JOB=m["jobs.import_job"].IMPORT_JOB,
        ImportResumer=m["jobs.import_job"].ImportResumer,
        synthetic_chunk=m["jobs.import_job"].synthetic_chunk,
        open_sink=m["cdc"].open_sink, tpch=m["models.tpch"],
        port=port)


@pytest.fixture(scope="module")
def sides():
    with reference_modules(*REF_MODULES):
        yield _side("cockroach_tpu_torch", True), \
            _side("cockroach_tpu", False)


def _seal(eng, table):
    """The reference seals its open chunk; every publish of the port
    is a sealed chunk already."""
    seal = getattr(eng.store, "seal", None)
    if seal is not None:
        seal(table)


def _try(trace, fn, d=None):
    try:
        trace.append(("ok", fn()))
    except Exception as e:
        msg = str(e)
        if d is not None:
            msg = msg.replace(str(d), "<dir>")
        trace.append(("err", type(e).__name__, msg))


def both(sides, tmp_path, scenario):
    """``scenario(side, dir)`` on each package, in a directory of its
    own; the two traces must be equal. Returns the port's."""
    got = []
    for s in sides:
        d = tmp_path / s.name
        d.mkdir()
        got.append(scenario(s, d))
    assert got[0] == got[1], got
    return got[0]


def _acc(s):
    """tests/test_backup_restore.py's fixture."""
    e = s.engine()
    e.execute("CREATE TABLE acc (id INT PRIMARY KEY, name STRING, "
              "bal DECIMAL(10,2))")
    e.execute("INSERT INTO acc VALUES (1,'a',10.50),(2,'b',20.25),"
              "(3,'c',30.00)")
    return e


def table_rows(e, t="acc"):
    return e.execute(f"SELECT id, name, bal FROM {t} ORDER BY id").rows


# -- tests/test_backup_restore.py ------------------------------------------------
def test_roundtrip(sides, tmp_path):
    def run(s, d):
        eng = _acc(s)
        tag = eng.execute(f"BACKUP TABLE acc INTO '{d}'").tag
        e2 = s.engine()
        e2.execute(f"RESTORE TABLE acc FROM '{d}'")
        assert table_rows(e2) == table_rows(eng)
        return [tag, table_rows(e2),
                e2.catalog.get_by_name("acc") is not None]
    assert both(sides, tmp_path, run) == [
        "BACKUP", [(1, "a", 10.5), (2, "b", 20.25), (3, "c", 30.0)], True]


def test_restore_all_tables_by_default(sides, tmp_path):
    def run(s, d):
        eng = _acc(s)
        eng.execute("CREATE TABLE t2 (x INT)")
        eng.execute("INSERT INTO t2 VALUES (7)")
        eng.execute(f"BACKUP TABLE acc, t2 INTO '{d}'")
        e2 = s.engine()
        e2.execute(f"RESTORE FROM '{d}'")
        assert table_rows(e2) == table_rows(eng)
        return [table_rows(e2), e2.execute("SELECT x FROM t2").rows]
    assert both(sides, tmp_path, run)[1] == [(7,)]


def test_restore_into_existing_table_fails(sides, tmp_path):
    def run(s, d):
        eng = _acc(s)
        eng.execute(f"BACKUP TABLE acc INTO '{d}'")
        trace = []
        _try(trace, lambda: eng.execute(f"RESTORE TABLE acc FROM '{d}'"), d)
        return trace
    got = both(sides, tmp_path, run)
    assert got[0][0] == "err" and "already exists" in got[0][2]


def test_restore_missing_backup_fails(sides, tmp_path):
    def run(s, d):
        eng = _acc(s)
        trace = []
        _try(trace, lambda: eng.execute(f"RESTORE TABLE acc FROM '{d}'"), d)
        return trace
    got = both(sides, tmp_path, run)
    assert got == [("err", "EngineError",
                    "RESTORE failed: no backup found in '<dir>'")]


def test_restore_of_a_table_not_in_the_backup_fails(sides, tmp_path):
    def run(s, d):
        eng = _acc(s)
        eng.execute(f"BACKUP TABLE acc INTO '{d}'")
        trace = []
        _try(trace, lambda: s.engine().execute(
            f"RESTORE TABLE nope FROM '{d}'"), d)
        _try(trace, lambda: eng.execute(f"BACKUP TABLE nope INTO '{d}'"),
             d)
        return trace
    assert both(sides, tmp_path, run) == [
        ("err", "EngineError", "RESTORE failed: table 'nope' not in backup"),
        ("err", "EngineError", "table 'nope' does not exist")]


def test_post_restore_inserts_work(sides, tmp_path):
    def run(s, d):
        eng = _acc(s)
        eng.execute(f"BACKUP TABLE acc INTO '{d}'")
        e2 = s.engine()
        e2.execute(f"RESTORE TABLE acc FROM '{d}'")
        e2.execute("INSERT INTO acc VALUES (9,'z',1.00)")
        return [e2.execute("SELECT count(*) FROM acc").rows, table_rows(e2)]
    assert both(sides, tmp_path, run)[0] == [(4,)]


def test_update_delete_insert_window(sides, tmp_path):
    def run(s, d):
        eng = _acc(s)
        eng.execute(f"BACKUP TABLE acc INTO '{d}'")
        eng.execute("UPDATE acc SET bal = 99.99 WHERE id = 2")
        eng.execute("DELETE FROM acc WHERE id = 3")
        eng.execute("INSERT INTO acc VALUES (4,'d',40.00)")
        eng.execute(f"BACKUP TABLE acc INTO '{d}'")
        e2 = s.engine()
        e2.execute(f"RESTORE TABLE acc FROM '{d}'")
        assert table_rows(e2) == table_rows(eng)
        return table_rows(e2)
    assert both(sides, tmp_path, run) == \
        [(1, "a", 10.5), (2, "b", 99.99), (4, "d", 40.0)]


def test_three_layers(sides, tmp_path):
    def run(s, d):
        eng = _acc(s)
        eng.execute(f"BACKUP TABLE acc INTO '{d}'")
        eng.execute("DELETE FROM acc WHERE id = 1")
        eng.execute(f"BACKUP TABLE acc INTO '{d}'")
        eng.execute("INSERT INTO acc VALUES (1,'a2',11.00)")
        eng.execute(f"BACKUP TABLE acc INTO '{d}'")
        e2 = s.engine()
        e2.execute(f"RESTORE TABLE acc FROM '{d}'")
        assert table_rows(e2) == table_rows(eng)
        return table_rows(e2)
    assert both(sides, tmp_path, run)[0] == (1, "a2", 11.0)


def test_incremental_layer_is_small(sides, tmp_path):
    """Each package reads its own files: the port's hold no pickled
    object array (np.load refuses one without allow_pickle)."""
    def run(s, d):
        eng = _acc(s)
        eng.execute(f"BACKUP TABLE acc INTO '{d}'")
        eng.execute("INSERT INTO acc VALUES (4,'d',40.00)")
        eng.execute(f"BACKUP TABLE acc INTO '{d}'")
        with np.load(d / "l1_acc.npz", allow_pickle=not s.port) as z:
            n = int(z["__n"][0])
            if s.port:
                assert all(z[k].dtype != object for k in z.files)
                assert int(z["__ndel"][0]) == 0
        return n
    assert both(sides, tmp_path, run) == 1   # only the new row


def test_backup_resumes_after_crash(sides, tmp_path):
    """A crash after the first table's export; a fresh registry finishes
    the other table without exporting the first again."""
    def run(s, d):
        eng = _acc(s)
        eng.execute("CREATE TABLE t2 (x INT)")
        eng.execute("INSERT INTO t2 VALUES (7)")
        crashy = s.Registry(eng.kv, session_id="crashy",
                            lease_seconds=0.05)
        crashy.register(s.BACKUP_JOB, lambda: s.BackupResumer(
            eng, crash_after_table=0))
        jid = crashy.create(s.BACKUP_JOB, {"tables": ["acc", "t2"],
                                           "dest": str(d)})
        with pytest.raises(s.crash):
            crashy.run_job(jid)
        torn = sorted(os.listdir(d))   # no manifest: the backup is unseen
        time.sleep(0.1)
        fresh = s.Registry(eng.kv, session_id="fresh")
        fresh.register(s.BACKUP_JOB, lambda: s.BackupResumer(eng))
        done = fresh.adopt_and_run_all()
        e2 = s.engine()
        e2.execute(f"RESTORE FROM '{d}'")
        assert table_rows(e2) == table_rows(eng)
        return [torn, [(r.id == jid, r.status) for r in done],
                e2.execute("SELECT x FROM t2").rows]
    assert both(sides, tmp_path, run) == [
        ["l0_acc.npz"], [(True, "succeeded")], [(7,)]]


def test_snapshot_ts_fixed_across_resume(sides, tmp_path):
    """Writes between the crash and the resume stay out of the backup:
    the checkpointed end_ts pins the snapshot."""
    def run(s, d):
        eng = _acc(s)
        eng.execute("CREATE TABLE t2 (x INT)")
        crashy = s.Registry(eng.kv, session_id="crashy",
                            lease_seconds=0.05)
        crashy.register(s.BACKUP_JOB, lambda: s.BackupResumer(
            eng, crash_after_table=0))
        jid = crashy.create(s.BACKUP_JOB, {"tables": ["acc", "t2"],
                                           "dest": str(d)})
        with pytest.raises(s.crash):
            crashy.run_job(jid)
        eng.execute("INSERT INTO t2 VALUES (999)")   # after the snapshot
        time.sleep(0.1)
        fresh = s.Registry(eng.kv, session_id="fresh")
        fresh.register(s.BACKUP_JOB, lambda: s.BackupResumer(eng))
        fresh.adopt_and_run_all()
        e2 = s.engine()
        e2.execute(f"RESTORE FROM '{d}'")
        return e2.execute("SELECT count(*) FROM t2").rows
    assert both(sides, tmp_path, run) == [(0,)]


def test_backup_without_a_pk_and_with_nulls(sides, tmp_path):
    """A table with no primary key (rowid keys), NULLs in every column
    kind, an UPDATE of many rows and deletes across three layers: the
    restored rows equal the source's on both, and a row inserted after
    RESTORE takes a rowid past every restored one."""
    def run(s, d):
        eng = s.engine()
        eng.execute("CREATE TABLE n (a INT, s STRING, m DECIMAL(8,2), "
                    "f FLOAT8, dt DATE, b BOOL)")
        vals = ", ".join(
            f"({'NULL' if i % 7 == 0 else i}, "
            f"{'NULL' if i % 5 == 0 else repr('s%d' % (i % 4))}, "
            f"{'NULL' if i % 6 == 0 else '%d.25' % i}, "
            f"{'NULL' if i % 4 == 0 else i / 8}, "
            f"{'NULL' if i % 9 == 0 else repr('2020-01-%02d' % (i % 28 + 1))}, "
            f"{'NULL' if i % 3 == 0 else ('true' if i % 2 else 'false')})"
            for i in range(60))
        eng.execute(f"INSERT INTO n VALUES {vals}")
        q = "SELECT a, s, m, f, dt, b FROM n"
        eng.execute(f"BACKUP TABLE n INTO '{d}'")
        eng.execute("UPDATE n SET m = 1.50 WHERE a < 20")
        eng.execute("DELETE FROM n WHERE s = 's1'")
        eng.execute(f"BACKUP TABLE n INTO '{d}'")
        eng.execute("INSERT INTO n VALUES (1000, 'new', NULL, 0.5, NULL, "
                    "true)")
        eng.execute("DELETE FROM n WHERE a IS NULL")
        eng.execute(f"BACKUP TABLE n INTO '{d}'")
        e2 = s.engine()
        e2.execute(f"RESTORE TABLE n FROM '{d}'")
        want = sorted(eng.execute(q).rows, key=repr)
        assert sorted(e2.execute(q).rows, key=repr) == want
        td = e2.store.table("n")
        top = max(int(c.rowid.max()) for c in td.chunks if c.n)
        e2.execute("INSERT INTO n VALUES (2000, 'x', 1.00, 1.0, NULL, "
                   "false)")
        assert int(e2.store.table("n").chunks[-1].rowid.max()) > top
        return want
    assert len(both(sides, tmp_path, run)) == 42


# -- tests/test_protectedts.py: the backup chain --------------------------------
def _pts_engine(s):
    e = s.engine()
    e.execute("CREATE TABLE t (a INT PRIMARY KEY, v INT)")
    e.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    e.execute("DELETE FROM t WHERE a = 2")  # a collectible tombstone
    _seal(e, "t")
    e.execute("SET CLUSTER SETTING kv.gc.ttl_seconds = 0")
    return e


def test_backup_chain_protects_its_cursor(sides, tmp_path):
    def run(s, d):
        eng = _pts_engine(s)
        eng.execute(f"BACKUP TABLE t INTO '{d}'")
        # the chain's record pins the history at and after the layer's
        # end_ts; the tombstone from before the backup is collectible
        recs = [r for r in eng.protectedts.records() if r[3] == str(d)]
        trace = [len(recs), eng.run_gc("t")]
        eng.execute("UPDATE t SET v = 99 WHERE a = 1")
        _seal(eng, "t")
        trace.append(eng.run_gc("t"))   # the next layer needs it
        eng.execute(f"BACKUP TABLE t INTO '{d}'")
        recs2 = [r for r in eng.protectedts.records() if r[3] == str(d)]
        trace += [len(recs2), recs2[0][1] > recs[0][1], eng.run_gc("t")]
        return trace
    assert both(sides, tmp_path, run) == [1, 1, 0, 1, True, 1]


def test_chain_correct_despite_aggressive_gc(sides, tmp_path):
    """With a TTL of 0, an incremental chain still restores exactly: its
    protection kept the window."""
    def run(s, d):
        eng = _pts_engine(s)
        eng.execute(f"BACKUP TABLE t INTO '{d}'")
        eng.execute("UPDATE t SET v = 99 WHERE a = 1")
        eng.run_gc("t")
        eng.execute(f"BACKUP TABLE t INTO '{d}'")
        e2 = s.engine()
        e2.execute(f"RESTORE TABLE t FROM '{d}'")
        got = e2.execute("SELECT a, v FROM t ORDER BY a").rows
        assert got == eng.execute("SELECT a, v FROM t ORDER BY a").rows
        return got
    assert both(sides, tmp_path, run) == [(1, 99)]


# -- tests/test_ttl.py -----------------------------------------------------------
def _ttl_engine(s):
    import datetime
    e = s.engine()
    e.execute("CREATE TABLE ev (id INT PRIMARY KEY, created TIMESTAMP, "
              "payload STRING)")
    now = datetime.datetime.now(datetime.timezone.utc).replace(tzinfo=None)
    old = now - datetime.timedelta(hours=2)
    e.execute(f"INSERT INTO ev VALUES "
              f"(1, timestamp '{old.isoformat(sep=' ')}', 'a'), "
              f"(2, timestamp '{now.isoformat(sep=' ')}', 'b'), "
              f"(3, timestamp '{old.isoformat(sep=' ')}', 'c')")
    return e


def test_ttl_deletes_only_expired(sides, tmp_path):
    def run(s, _d):
        eng = _ttl_engine(s)
        jid = eng.run_ttl("ev", "created", ttl_seconds=3600)
        return [eng.execute("SELECT id FROM ev").rows,
                eng.jobs.job(jid).progress["deleted"],
                eng.jobs.job(jid).status]
    assert both(sides, tmp_path, run) == [[(2,)], 2, "succeeded"]


def test_ttl_idempotent_second_pass(sides, tmp_path):
    def run(s, _d):
        eng = _ttl_engine(s)
        eng.run_ttl("ev", "created", ttl_seconds=3600)
        jid = eng.run_ttl("ev", "created", ttl_seconds=3600)
        return [eng.jobs.job(jid).progress["deleted"],
                eng.execute("SELECT count(*) FROM ev").rows]
    assert both(sides, tmp_path, run) == [0, [(1,)]]


def test_ttl_deletes_visible_to_changefeed(sides, tmp_path):
    def run(s, d):
        eng = _ttl_engine(s)
        sink_uri = f"mem://ttl-{d.name}-{id(eng)}"
        jid_cf = eng.execute(
            f"CREATE CHANGEFEED FOR ev INTO '{sink_uri}'").rows[0][0]
        sink = s.open_sink(sink_uri)
        assert _wait(lambda: len(sink.rows) >= 3)
        eng.run_ttl("ev", "created", ttl_seconds=3600)
        assert _wait(lambda: len(sink.rows) >= 5)
        deletes = [r for r in sink.rows if r["after"] is None]
        eng.execute(f"CANCEL JOB {jid_cf}")
        assert _wait(lambda: eng.jobs.job(jid_cf).status == "canceled")
        return [len(deletes), sorted(r["key"] for r in deletes)]
    assert both(sides, tmp_path, run)[0] == 2   # TTL rows reach CDC


def test_ttl_on_a_date_column(sides, tmp_path):
    """The DATE form of the cutoff literal (the reference's text): rows
    whose date is past the TTL go, the rest stay."""
    def run(s, _d):
        eng = s.engine()
        eng.execute("CREATE TABLE dd (id INT PRIMARY KEY, d DATE)")
        eng.execute("INSERT INTO dd VALUES (1, '1999-01-01'), "
                    "(2, '2200-01-01'), (3, '2001-06-30')")
        jid = eng.run_ttl("dd", "d", ttl_seconds=86_400)
        return [eng.execute("SELECT id FROM dd ORDER BY id").rows,
                eng.jobs.job(jid).progress["deleted"]]
    assert both(sides, tmp_path, run) == [[(2,)], 2]


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


# -- tests/test_jobs.py: IMPORT ----------------------------------------------------
COLUMNS = {"a": "int", "b": "float", "s": 16}


def _imp_engine(s):
    eng = s.engine()
    eng.execute("CREATE TABLE imp (a INT8 NOT NULL, b FLOAT NOT NULL, "
                "s STRING NOT NULL)")
    eng.store.set_dictionary("imp", "s", [f"v{i}" for i in range(16)])
    return eng


def _payload(total=10_000, chunk=1_000):
    return {"table": "imp", "total_rows": total, "chunk_rows": chunk,
            "seed": 42, "columns": COLUMNS}


def _registry(s, eng, session="node-1", crash_after=None, lease=10.0):
    reg = s.Registry(eng.kv, session_id=session, lease_seconds=lease)
    reg.register(s.IMPORT_JOB, lambda: s.ImportResumer(
        eng, crash_after_chunk=crash_after))
    return reg


def test_crash_mid_import_resumes_exactly_once(sides, tmp_path):
    def run(s, _d):
        eng = _imp_engine(s)
        reg1 = _registry(s, eng, session="node-1", crash_after=3, lease=0.0)
        jid = reg1.create(s.IMPORT_JOB, _payload())
        with pytest.raises(s.crash):
            reg1.run_job(jid)
        rec = reg1.job(jid)
        # four chunks landed, the checkpoint recorded three
        trace = [rec.status, rec.progress["chunks_done"],
                 eng.execute("SELECT count(*) AS c FROM imp").rows]
        reg2 = _registry(s, eng, session="node-2")
        trace += [reg2.run_job(jid).status,
                  eng.execute("SELECT count(*) AS c FROM imp").rows,
                  eng.execute("SELECT sum(a) AS s FROM imp").rows[0][0]]
        return trace
    full = sum(int(sides[0].synthetic_chunk(42, i, 1_000, COLUMNS)["a"]
                   .sum()) for i in range(10))
    assert both(sides, tmp_path, run) == [
        "running", 3, [(4_000,)], "succeeded", [(10_000,)], full]


def test_adopt_and_run_all_picks_up_pending(sides, tmp_path):
    def run(s, _d):
        eng = _imp_engine(s)
        reg = _registry(s, eng)
        ids = [reg.create(s.IMPORT_JOB, _payload(total=2_000, chunk=500))
               for _ in range(2)]
        done = reg.adopt_and_run_all()
        return [{r.id for r in done} == set(ids),
                [r.status for r in done],
                eng.execute("SELECT count(*) AS c FROM imp").rows]
    assert both(sides, tmp_path, run) == [
        True, ["succeeded"] * 2, [(4_000,)]]


def test_partial_final_chunk_not_double_ingested(sides, tmp_path):
    """Chunks of 30, 30, 30 and 10 rows; the crash fires after the last,
    partial one, which a resume must not ingest again."""
    def run(s, _d):
        eng = _imp_engine(s)
        reg1 = _registry(s, eng, session="node-1", crash_after=3, lease=0.0)
        jid = reg1.create(s.IMPORT_JOB, _payload(total=100, chunk=30))
        with pytest.raises(s.crash):
            reg1.run_job(jid)
        trace = [eng.execute("SELECT count(*) AS c FROM imp").rows]
        reg2 = _registry(s, eng, session="node-2")
        trace += [reg2.run_job(jid).status,
                  eng.execute("SELECT count(*) AS c FROM imp").rows,
                  eng.execute("SELECT s, count(*), sum(a) FROM imp GROUP BY "
                              "s ORDER BY s").rows]
        return trace
    got = both(sides, tmp_path, run)
    assert got[:3] == [[(100,)], "succeeded", [(100,)]]


@pytest.mark.parametrize("seed,index,rows", [(42, 0, 1_000), (42, 3, 777),
                                             (7, 11, 500_000)])
def test_synthetic_chunk_equals_the_reference(sides, seed, index, rows):
    got = sides[0].synthetic_chunk(seed, index, rows, COLUMNS)
    want = sides[1].synthetic_chunk(seed, index, rows, COLUMNS)
    assert list(got) == list(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


# -- TPC-H lineitem through BACKUP, TTL and RESTORE --------------------------------
def test_lineitem_backup_ttl_restore_q1(sides, tmp_path):
    """lineitem at sf 0.01 (20,000 rows) backed up, a TTL pass over
    l_shipdate that deletes its first days, and an incremental layer, on
    both packages: the rows deleted and Q1 over the source are equal on
    both and equal the numpy oracle over the remaining rows (INT and
    DECIMAL exact, the averages within rel 1e-12 of each other). The
    port then restores the collection into a fresh engine, where Q1
    equals its source's and launches kernel 1 (its plain version here)
    once. The reference's own RESTORE reads its file's arrays again for
    every row, so at this size it takes minutes: its restores run in the
    small cases above."""
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl

    def run(s, d):
        tp = s.tpch
        eng = s.engine()
        tp.load(eng, sf=0.01, rows=20_000, tables=("lineitem",))
        eng.execute(f"BACKUP TABLE lineitem INTO '{d}'")
        ship = tp.gen_lineitem(0.01, rows=20_000)["l_shipdate"]
        day = int(np.sort(ship)[300])    # about 300 rows at or before it
        now_s = eng.clock.now().wall // 10 ** 9
        ttl = now_s - (day * 86_400 + 43_200)
        jid = eng.run_ttl("lineitem", "l_shipdate", ttl)
        deleted = eng.jobs.job(jid).progress["deleted"]
        eng.execute(f"BACKUP TABLE lineitem INTO '{d}'")
        rows[s.name] = eng.execute(tp.Q1).rows
        if s.port:
            e2 = s.engine()
            e2.execute(f"RESTORE TABLE lineitem FROM '{d}'")
            tgl.PLAIN_CALLS = 0
            rows["restored"] = e2.execute(tp.Q1).rows
            plain.append(tgl.PLAIN_CALLS)
        return [deleted, int((ship <= day).sum())]
    rows: dict = {}
    plain: list = []
    got = both(sides, tmp_path, run)
    assert got[0] == got[1] and 100 <= got[0] <= 2_000
    assert plain == [1] and rows["restored"] == rows["port"]
    from cockroach_tpu_torch.models import tpch
    li = tpch.gen_lineitem(0.01, rows=20_000)
    keep = li["l_shipdate"] > int(np.sort(li["l_shipdate"])[300])
    li = {k: v[keep] for k, v in li.items()}
    want = tpch.ref_q1(li)
    for side in ("port", "ref"):
        q1 = rows[side]
        assert [tuple(r[:2]) for r in q1] == [tuple(w[:2]) for w in want]
        for r, w in zip(q1, want):
            assert r[9] == w[9]                       # count_order
            for a, b in zip(r[2:4], w[2:4]):          # exact in cents
                assert round(a * 100) == round(b * 100)
            for a, b in zip(r[4:9], w[4:9]):          # the oracle's floats
                assert abs(a - b) <= 1e-9 * abs(b)
    for r, w in zip(rows["port"], rows["ref"]):
        assert r[:6] + r[9:] == w[:6] + w[9:]
        for a, b in zip(r[6:9], w[6:9]):
            assert abs(a - b) <= 1e-12 * abs(b)


def test_chip_smoke_phase16_on_the_cpu():
    """chip_smoke.py's phase 16 at a small size on a CPU engine: every
    check it makes on the card but the kernel-vs-plain ones (the plain
    versions count their launches here)."""
    import chip_smoke
    out = chip_smoke.jobs_phase_alone(0.01, "cpu", rows=20_000)
    # Q1 after the TTL, three timed; the restored Q1, three timed; the
    # IMPORT's GROUP BY through kernel 1's route
    assert out["launches"] == {"groupagg_large": 9, "groupagg": 0}
    assert 1_000 <= out["rows_deleted"] <= 20_000
    assert out["feed_events"]["supplier"] == 101     # 100 rows, 1 UPDATE
    assert out["lane_cdc_declines"] >= 1
    assert out["incremental_bytes"] < out["full_bytes"]
    assert [j[1:3] for j in out["jobs"]] == [
        ("changefeed", "canceled")] * 2 + [
        ("backup", "succeeded"), ("row-ttl", "succeeded"),
        ("backup", "succeeded"), ("IMPORT", "succeeded")]
