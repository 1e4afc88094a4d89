"""The port's write path against the JAX Engine, both loaded by SQL.

The same statements run in the same order through the reference Engine
and the port's ``Engine(device="cpu")``: INSERT VALUES, INSERT ...
SELECT, UPSERT, UPDATE and DELETE, column defaults, NOT NULL, the
duplicate primary key, CHECK, FOREIGN KEY and FK RESTRICT, TRUNCATE and
DROP TABLE; then transactions: read-your-writes in the overlay (the
compiled path, the primary-key point and range paths), ROLLBACK, the
COMMIT of an aborted txn, and a read-refresh failure that surfaces as
"restart transaction". Each statement's outcome must be equal: a
SELECT's rows (as multisets where it has no ORDER BY; FLOAT8 within rel
1e-12), a write's tag and row count, an error's text.

The row codec's keys and values are bit-equal to the reference's for
the same tables, and the vectorized pk-key encoder equals the codec
row by row. Finally TPC-H's refresh pair (RF1 in one transaction with
a Q6 that reads its own writes, RF2, an UPDATE of l_discount, an
INSERT rolled back) runs at sf 0.01 with 20,000 lineitem rows through
both engines, and Q1, Q6, Q14 and Q3 equal the reference's rows after
it; the port's Q1 goes through kernel 1's plain version. DECIMAL, INT,
DATE and STRING values compare exactly.
"""

import re

import numpy as np
import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
from cockroach_tpu_torch.sql.types import Family
from tests.test_torch_groupagg_large import reference_modules

FLOAT_REL = 1e-12

SCRIPT = [
    ("a", "CREATE TABLE parent (id INT PRIMARY KEY, name STRING NOT NULL, "
          "score DECIMAL(8,2) DEFAULT 1.25, born DATE, "
          "CHECK (score >= 0))"),
    ("a", "CREATE TABLE child (cid INT PRIMARY KEY, pid INT REFERENCES "
          "parent(id), qty INT NOT NULL DEFAULT 7, CHECK (qty < 100))"),
    ("a", "CREATE TABLE nopk (a INT, b STRING, f FLOAT)"),
    ("a", "CREATE TABLE bad (x INT, CHECK (y > 0))"),
    ("a", "CREATE TABLE badfk (x INT REFERENCES nosuch(id))"),
    ("a", "INSERT INTO parent VALUES (1, 'a', 3.50, '1999-12-31'), "
          "(2, 'b', 0.00, NULL), (3, 'c', 10.25, '2020-02-29')"),
    ("a", "INSERT INTO parent (id, name) VALUES (5, 'e')"),
    ("a", "INSERT INTO parent VALUES (1, 'dup', 1.00, NULL)"),
    ("a", "INSERT INTO parent (id, name) VALUES (9, NULL)"),
    ("a", "INSERT INTO parent VALUES (10, 'neg', -1.00, NULL)"),
    ("a", "INSERT INTO parent VALUES (11, 'x', 1.00)"),
    ("a", "INSERT INTO child VALUES (1, 1, 3), (2, 2, 4)"),
    ("a", "INSERT INTO child (cid, pid) VALUES (3, 3)"),
    ("a", "INSERT INTO child VALUES (4, 99, 1)"),
    ("a", "INSERT INTO child (cid, pid) VALUES (5, NULL)"),
    ("a", "INSERT INTO child VALUES (6, 5, 100)"),
    ("a", "SELECT * FROM parent ORDER BY id"),
    ("a", "SELECT * FROM child ORDER BY cid"),
    ("a", "DELETE FROM parent WHERE id = 1"),
    ("a", "UPDATE parent SET id = 100 WHERE id = 2"),
    ("a", "UPDATE parent SET score = score + 1.5 WHERE born IS NULL"),
    ("a", "UPDATE parent SET score = score - 100 WHERE id = 3"),
    ("a", "UPDATE parent SET name = NULL WHERE id = 3"),
    ("a", "UPSERT INTO parent VALUES (3, 'cc', 2.00, '2001-01-01'), "
          "(6, 'f', 0.50, NULL)"),
    ("a", "UPDATE parent SET id = 7 WHERE id = 6"),
    ("a", "UPDATE parent SET id = 5 WHERE id = 7"),
    ("a", "SELECT id, name, score, born FROM parent ORDER BY id"),
    ("a", "INSERT INTO nopk SELECT id, name, 0.5 FROM parent WHERE id < 4"),
    ("a", "INSERT INTO nopk VALUES (7, 'z', -0.0), (NULL, NULL, NULL), "
          "(8, 'y', 2.5)"),
    ("a", "DELETE FROM nopk WHERE a = 2"),
    ("a", "UPDATE nopk SET b = 'w', f = f * 2 WHERE a IS NULL OR a > 7"),
    ("a", "SELECT a, b, f FROM nopk"),
    ("a", "SELECT b, count(*), sum(a) FROM nopk GROUP BY b ORDER BY b"),
    # an open txn: read-your-writes through every read path
    ("t", "BEGIN"),
    ("t", "INSERT INTO parent VALUES (20, 't', 4.00, '2010-10-10')"),
    ("t", "UPDATE parent SET score = 9.75 WHERE id = 3"),
    ("t", "DELETE FROM child WHERE cid = 5"),
    ("t", "SELECT count(*), sum(score) FROM parent"),
    ("a", "SELECT count(*), sum(score) FROM parent"),
    ("t", "SELECT name, score FROM parent WHERE id = 20"),
    ("t", "SELECT id, score FROM parent WHERE id >= 3 ORDER BY id LIMIT 3"),
    ("t", "SELECT p.name, c.qty FROM child c JOIN parent p ON c.pid = p.id "
          "ORDER BY c.cid"),
    ("t", "ROLLBACK"),
    ("a", "SELECT id, score FROM parent ORDER BY id"),
    ("a", "SELECT cid FROM child ORDER BY cid"),
    # a failed statement aborts the txn; its COMMIT rolls back
    ("t", "BEGIN"),
    ("t", "INSERT INTO parent VALUES (30, 'u', 1.00, NULL)"),
    ("t", "INSERT INTO parent VALUES (3, 'dup', 1.00, NULL)"),
    ("t", "SELECT count(*) FROM parent"),
    ("t", "COMMIT"),
    ("a", "SELECT count(*) FROM parent"),
    # a committed txn
    ("t", "BEGIN"),
    ("t", "INSERT INTO child VALUES (8, 5, 1)"),
    ("t", "INSERT INTO parent VALUES (40, 'v', 1.00, NULL)"),
    ("t", "INSERT INTO child VALUES (9, 40, 2)"),
    ("t", "DELETE FROM nopk WHERE b = 'w'"),
    ("t", "COMMIT"),
    ("a", "SELECT id, name FROM parent ORDER BY id"),
    ("a", "SELECT cid, pid, qty FROM child ORDER BY cid"),
    ("a", "SELECT a, b FROM nopk"),
    # a read refreshed past a concurrent commit: restart transaction
    ("t", "BEGIN"),
    ("t", "SELECT count(*) FROM nopk"),
    ("a", "INSERT INTO nopk VALUES (50, 'late', 1.0)"),
    ("a", "SELECT count(*) FROM parent"),
    ("t", "INSERT INTO parent VALUES (60, 'mine', 1.00, NULL)"),
    ("t", "COMMIT"),
    ("a", "SELECT a, b FROM nopk WHERE a >= 50"),
    ("a", "SELECT id FROM parent WHERE id >= 40 ORDER BY id"),
    # non-transactional DDL
    ("t", "BEGIN"),
    ("t", "INSERT INTO nopk VALUES (60, 'open', 1.0)"),
    ("a", "TRUNCATE nopk"),
    ("t", "ROLLBACK"),
    ("a", "TRUNCATE nopk"),
    ("a", "SELECT count(*) FROM nopk"),
    ("a", "INSERT INTO nopk VALUES (1, 'again', 1.0)"),
    ("a", "SELECT a, b FROM nopk"),
    ("a", "DROP TABLE parent"),
    ("a", "TRUNCATE parent"),
    ("a", "DROP TABLE child"),
    ("a", "DROP TABLE parent"),
    ("a", "DROP TABLE IF EXISTS parent"),
    ("a", "DROP TABLE parent"),
]

# the statements that must fail on both engines (their texts compared)
MUST_FAIL = {
    "INSERT INTO parent VALUES (1, 'dup'": "duplicate key value",
    "INSERT INTO parent (id, name) VALUES (9, NULL)": "null in non-null",
    "INSERT INTO parent VALUES (10, 'neg'": "check constraint",
    "INSERT INTO child VALUES (4, 99, 1)": "violates foreign key",
    "INSERT INTO child VALUES (6, 5, 100)": "check constraint",
    "DELETE FROM parent WHERE id = 1": "violates foreign key",
    "UPDATE parent SET id = 100 WHERE id = 2": "violates foreign key",
    "UPDATE parent SET score = score - 100": "check constraint",
    "UPDATE parent SET name = NULL": "null in non-null",
    "UPDATE parent SET id = 5 WHERE id = 7": "duplicate key",
    "INSERT INTO parent VALUES (3, 'dup'": "duplicate key value",
    "COMMIT": "restart transaction: read refresh failed",
}


def _outcome(eng, sessions, who, sql):
    s = sessions[who]
    try:
        res = eng.execute(sql, s)
    except Exception as e:   # the error text is what is compared
        return ("error", str(e))
    if res.tag == "SELECT" or res.names:
        return ("rows", res.rows, [t.family for t in res.types])
    return ("done", res.tag, res.row_count)


def _run_script(eng, script):
    sessions = {"a": eng.session(), "t": eng.session()}
    for s in sessions.values():
        s.vars.set("distsql", "off")
    return [_outcome(eng, sessions, who, sql) for who, sql in script]


@pytest.fixture(scope="module")
def reference_script():
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        e = jeng.Engine()
        try:
            return _run_script(e, SCRIPT)
        finally:
            e.close()


def _canon(rows, ordered):
    return rows if ordered else sorted(rows, key=repr)


def _same(got, want, sql):
    assert got[0] == want[0], (sql, got, want)
    if got[0] != "rows":
        assert got == want, sql
        return
    ordered = "ORDER BY" in sql
    g_rows, w_rows = _canon(got[1], ordered), _canon(want[1], ordered)
    assert len(g_rows) == len(w_rows), (sql, g_rows, w_rows)
    for g_row, w_row in zip(g_rows, w_rows):
        for g, w, fam in zip(g_row, w_row, got[2]):
            if fam == Family.FLOAT and g is not None and w is not None:
                assert g == pytest.approx(w, rel=FLOAT_REL), (sql, g, w)
            else:
                assert g == w and type(g) is type(w), (sql, g_row, w_row)


def test_script_equals_reference(reference_script):
    got = _run_script(Engine(device="cpu"), SCRIPT)
    assert len(got) == len(reference_script)
    for (who, sql), g, w in zip(SCRIPT, got, reference_script):
        _same(g, w, sql)


def test_script_exercises_every_failure(reference_script):
    """The script's failures are the ones it was written to provoke,
    and only those, on the reference too."""
    failed = [sql for (_w, sql), o in zip(SCRIPT, reference_script)
              if o[0] == "error"]
    for prefix, text in MUST_FAIL.items():
        hits = [sql for sql in failed if sql.startswith(prefix)]
        assert hits, prefix
        if text is not None:
            errs = [o[1] for (_w, sql), o in zip(SCRIPT, reference_script)
                    if sql.startswith(prefix) and o[0] == "error"]
            assert any(text in e for e in errs), (prefix, errs)
    texts = [o[1] for o in reference_script if o[0] == "error"]
    assert any(t.startswith("restart transaction") for t in texts)
    assert any("current transaction is aborted" in t for t in texts)
    assert ("done", "ROLLBACK", 0) in reference_script


ROWENC_DDL = ("CREATE TABLE rk (k INT, s STRING, d DATE, m DECIMAL(10,2), "
              "f FLOAT, b BOOL, t TIMESTAMP, PRIMARY KEY (k, s))")
ROWENC_ROWS = ("INSERT INTO rk VALUES "
               "(-9223372036854775807, '', '1969-12-31', -0.01, -0.0, true, "
               "'1970-01-01 00:00:00'), "
               "(0, 'a\\x00b', '2024-02-29', 12345678.90, 1.5e300, false, "
               "'2038-01-19 03:14:08'), "
               "(42, 'zz''q', NULL, NULL, NULL, NULL, NULL)")


def _codec_bytes(store, table):
    """(key, value) bytes of every live row, by the table's codec."""
    td = store.table(table)
    out = []
    for chunk in td.chunks:
        for ri in range(chunk.n):
            row = store.extract_row(td, chunk, ri)
            out.append((td.codec.key(row), td.codec.encode_value(row),
                        store.row_key(td, chunk, ri)))
    return sorted(out)


def test_row_codec_bytes_equal_reference():
    stmts = [ROWENC_DDL, ROWENC_ROWS, "CREATE TABLE rn (a INT, b STRING)",
             "INSERT INTO rn VALUES (1, 'x'), (NULL, 'y'), (3, NULL)"]
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        je = jeng.Engine()
        try:
            for st in stmts:
                je.execute(st)
            je.store.seal("rk")
            je.store.seal("rn")
            want = {t: _codec_bytes(je.store, t) for t in ("rk", "rn")}
            want_ids = {t: je.store.table(t).schema.table_id
                        for t in ("rk", "rn")}
        finally:
            je.close()
    pe = Engine(device="cpu")
    for st in stmts:
        pe.execute(st)
    for t in ("rk", "rn"):
        assert pe.store.table(t).schema.table_id == want_ids[t]
        assert _codec_bytes(pe.store, t) == want[t]


def test_batch_row_keys_equal_the_codec():
    """The vectorized pk-key encode equals row_key, row by row, for
    synthetic rowids and for multi-column int-family keys."""
    e = Engine(device="cpu")
    e.execute("CREATE TABLE kk (a INT, d DATE, v INT, PRIMARY KEY (a, d))")
    rng = np.random.default_rng(3)
    vals = ", ".join(f"({int(a)}, '{1900 + int(y)}-01-01', 1)" for a, y in
                     zip(rng.integers(-2**62, 2**62, 300),
                         rng.permutation(300)))
    e.execute(f"INSERT INTO kk VALUES {vals}")
    e.execute("CREATE TABLE syn (v INT)")
    e.execute("INSERT INTO syn VALUES " + ", ".join(
        f"({i})" for i in range(500)))
    e.execute("DELETE FROM syn WHERE v < 100")
    for t in ("kk", "syn"):
        td = e.store.table(t)
        for chunk in td.chunks:
            ris = np.arange(chunk.n)
            assert e.store._batch_row_keys(td, chunk, ris) == [
                e.store.row_key(td, chunk, int(ri)) for ri in ris]
    assert len(e.store.ensure_pk_index("syn")) == 400


def test_rewritten_table_misses_the_exec_cache():
    """A run after a write misses the exec cache. TRUNCATE and DROP +
    CREATE give the table new dictionaries, and its generation never
    returns to an earlier value: refilled with the same row count and
    dictionary size, it reads its own strings through execute() and
    through a Prepared made before the TRUNCATE. (The reference hands
    back the dropped table's strings here: ROADMAP Queue 3.)"""
    e = Engine(device="cpu")
    ddl = "CREATE TABLE t (k INT PRIMARY KEY, s STRING, m DECIMAL(6,2))"
    q = "SELECT s, m FROM t ORDER BY k"
    e.execute(ddl)
    e.execute("INSERT INTO t VALUES (1, 'a', 1.10), (2, 'b', 2.20)")
    s = e.session()
    p = e.prepare(q, s)
    assert e.execute(q, s).rows == p.run().rows == [("a", 1.1), ("b", 2.2)]
    hits = e.plan_cache["hit"]
    assert e.execute(q, s).rows == [("a", 1.1), ("b", 2.2)]
    assert e.plan_cache["hit"] == hits + 1
    steps = [
        (["UPDATE t SET m = 9.99 WHERE k = 2"], [("a", 1.1), ("b", 9.99)]),
        (["TRUNCATE t", "INSERT INTO t VALUES (1, 'b', 3.30), (2, 'a', 4.40)"],
         [("b", 3.3), ("a", 4.4)]),
        (["DROP TABLE t", ddl,
          "INSERT INTO t VALUES (1, 'y', 5.50), (2, 'x', 6.60)"],
         [("y", 5.5), ("x", 6.6)]),
    ]
    for writes, want in steps:
        for w in writes:
            e.execute(w, s)
        miss = e.plan_cache["miss"]
        assert e.execute(q, s).rows == want, writes
        assert e.plan_cache["miss"] == miss + 1, writes
        assert p.run().rows == want, writes
        hits = e.plan_cache["hit"]
        assert e.execute(q, s).rows == want, writes
        assert e.plan_cache["hit"] == hits + 1, writes


# -- TPC-H's refresh pair at sf 0.01 -------------------------------------

SF = 0.01
ROWS = 20_000
RF_ORDERS = 60
TABLES = ("lineitem", "part", "orders", "customer")


def _refresh_script():
    orders, lineitem = tpch.gen_refresh(SF, n_orders=RF_ORDERS)
    old = tpch.rf2_orderkeys(SF, n_orders=RF_ORDERS)
    keys = ", ".join(str(int(k)) for k in old)
    upd = int(tpch.gen_lineitem(SF, rows=ROWS)["l_orderkey"][123])
    script = [("t", "BEGIN")]
    script += [("t", s) for s in tpch.insert_statements("orders", orders)]
    script += [("t", s) for s in
               tpch.insert_statements("lineitem", lineitem, batch=100)]
    script += [("t", tpch.Q6), ("a", tpch.Q6), ("t", "COMMIT"),
               ("a", f"DELETE FROM lineitem WHERE l_orderkey IN ({keys})"),
               ("a", f"DELETE FROM orders WHERE o_orderkey IN ({keys})"),
               ("a", "UPDATE lineitem SET l_discount = 0.04 "
                     f"WHERE l_orderkey = {upd}"),
               ("a", tpch.Q6), ("t", "BEGIN"),
               ("t", tpch.insert_statements("lineitem", lineitem)[0]),
               ("t", "ROLLBACK"),
               ("a", tpch.Q6), ("a", tpch.Q1), ("a", tpch.Q14),
               ("a", tpch.Q3)]
    return script


def _load(eng, mod):
    mod.load(eng, sf=SF, rows=ROWS, tables=TABLES)


@pytest.fixture(scope="module")
def refresh_reference():
    script = _refresh_script()
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch") as (jeng, jtpch):
        e = jeng.Engine()
        try:
            _load(e, jtpch)
            return script, _run_script(e, script)
        finally:
            e.close()


def test_refresh_pair_equals_reference(refresh_reference):
    script, want = refresh_reference
    eng = Engine(device="cpu")
    _load(eng, tpch)
    sessions = {"a": eng.session(), "t": eng.session()}
    got = []
    for who, sql in script:
        calls0 = tgl.PLAIN_CALLS
        got.append(_outcome(eng, sessions, who, sql))
        if sql == tpch.Q1:
            q1_calls = tgl.PLAIN_CALLS - calls0
    for (who, sql), g, w in zip(script, got, want):
        _same(g, w, sql)
    assert q1_calls == 1   # Q1 through kernel 1's plain version
    q6 = [o[1] for (_w, sql), o in zip(script, got) if sql == tpch.Q6]
    # the txn's Q6 read its own writes; the one outside did not; the
    # rolled-back insert changed nothing
    assert q6[0] != q6[1] and q6[2] == q6[3]
    assert all(o[0] != "error" for o in got)
    deleted = [o for (_w, sql), o in zip(script, got)
               if sql.startswith("DELETE")]
    assert deleted[0][2] > 0 and deleted[1] == ("done", "DELETE",
                                               RF_ORDERS)
