"""EXPLAIN, EXPLAIN ANALYZE and the SHOW statements of the port's Engine
against the JAX Engine.

- EXPLAIN of TPC-H Q1, Q3, Q6, Q14, Q15 (a view's CTE), a CTE statement
  and a primary-key point read equals the reference's rows line for
  line: rule trace, access paths, memo summary, the ``index scan``
  line and the plan tree with its estimates. The reference loads every
  TPC-H table (lineitem capped at 5,000 rows, the others at sf 0.01)
  and its store is carried into the port's ``Engine(device="cpu")``,
  where the same ANALYZE runs.
- EXPLAIN ANALYZE of Q1 has the reference's shape: the
  ``planning/execution`` spans, the total and the rows returned, and
  the plan with the same estimates and actual rows; only the times
  differ, the reference's ``xla compile`` line has no counterpart
  (the port compiles no XLA), and the port times a table's upload
  inside the statement in an ``upload`` line. Each operator's device
  ms adds up to no more than the total. EXPLAIN ANALYZE of a
  non-SELECT is rejected.
- SHOW <var> (a session variable, else a cluster setting), SHOW ALL,
  SHOW TABLES, SHOW COLUMNS and SHOW CREATE TABLE (of a table with a
  CHECK and a foreign key, and of a view) give the reference's rows on
  tables made by the same SQL. SHOW ALL lists the variables the port
  reads, each with the reference's value.
"""

import re

import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.exec.session import EngineError
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from tests.test_torch_engine import _store_arrays
from tests.test_torch_groupagg_large import reference_modules

ROWS = 5_000

KV = ("CREATE TABLE kv (k INT8 NOT NULL PRIMARY KEY, v INT8)",
      "INSERT INTO kv VALUES (1, 10), (5, 50), (9, 90)")
EXPLAINED = {
    "q1": tpch.Q1, "q3": tpch.QUERIES["q3"], "q6": tpch.Q6,
    "q14": tpch.Q14, "q15": tpch.QUERIES["q15"],
    "cte": ("WITH big AS (SELECT o_custkey, sum(o_totalprice) AS tot "
            "FROM orders GROUP BY o_custkey) SELECT count(*) FROM big "
            "WHERE tot > 1000"),
    "derived": ("SELECT n, count(*) FROM (SELECT n_regionkey AS n FROM "
                "nation) AS x GROUP BY n ORDER BY n"),
    "pk_point": "SELECT v FROM kv WHERE k = 5",
}

SHOW_SETUP = (
    "CREATE TABLE parent (id INT8 NOT NULL PRIMARY KEY, name STRING)",
    "CREATE TABLE child (id INT8 NOT NULL PRIMARY KEY, "
    "pid INT8 REFERENCES parent (id), qty INT8, price DECIMAL(10,2), "
    "day DATE, CHECK (qty >= 0))",
    "CREATE VIEW expensive AS SELECT id, price FROM child "
    "WHERE price > 10",
    "CREATE VIEW named (a, b) AS SELECT id, name FROM parent",
    "SET CLUSTER SETTING sql.trace.slow_statement.threshold = 0.25",
)
SHOWS = ("SHOW TABLES", "SHOW COLUMNS FROM child",
         "SHOW CREATE TABLE child", "SHOW CREATE TABLE parent",
         "SHOW CREATE TABLE expensive", "SHOW CREATE TABLE named",
         "SHOW hash_group_capacity", "SHOW tracing",
         "SHOW sql.trace.slow_statement.threshold",
         "SHOW sql.exec.hbm_budget_bytes", "SHOW INDEXES FROM child",
         "SHOW JOBS", "SHOW ZONE CONFIGURATION FOR TABLE child")


@pytest.fixture(scope="module")
def engines():
    """(reference rows per statement, the port's TPC-H engine, the
    port's SHOW engine)."""
    show = Engine(device="cpu")
    for stmt in SHOW_SETUP:
        show.execute(stmt)
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch") as (jeng, jtpch):
        e = jeng.Engine()
        e2 = jeng.Engine()
        try:
            jtpch.load(e, sf=0.01, rows=ROWS, tables=jtpch.ALL_TABLES)
            for stmt in KV:
                e.execute(stmt)
            port = Engine(device="cpu", store=store_from_arrays(
                _store_arrays(e.store, {**jtpch.DDL, "kv": KV[0]})))
            for t in [*jtpch.ALL_TABLES, "kv"]:
                port.execute(f"ANALYZE {t}")
            out = {}
            s = e.session()
            s.vars.set("distsql", "off")
            for name, sql in EXPLAINED.items():
                out[name] = e.execute("EXPLAIN " + sql, session=s).rows
            out["analyze_q1"] = e.execute("EXPLAIN ANALYZE " + tpch.Q1,
                                          session=s).rows
            for stmt in SHOW_SETUP:
                e2.execute(stmt)
            for sql in SHOWS:
                out[sql] = e2.execute(sql).rows
            out["SHOW ALL"] = dict(e2.execute("SHOW ALL").rows)
        finally:
            e.close()
            e2.close()
    return out, port, show


@pytest.mark.parametrize("name", list(EXPLAINED))
def test_explain_matches_reference(engines, name):
    ref, port, _ = engines
    got = port.execute("EXPLAIN " + EXPLAINED[name]).rows
    assert got == ref[name]
    if name == "pk_point":
        assert any(r[0].startswith("index scan kv@primary") for r in got)


_DEVICE = re.compile(r"  \(device=[^)]*\)")
_MS = re.compile(r"[0-9.]+ms")


def _analyze_parts(rows):
    """(span names in order, the total line without times, the plan
    lines without the device annotations, device ms per plan line)."""
    lines = [r[0] for r in rows]
    i = lines.index("plan:")
    spans = [ln.split(":")[0].strip() for ln in lines[1:i]
             if not ln.strip().startswith("total")]
    total = next(ln for ln in lines if ln.strip().startswith("total"))
    plan = lines[i + 1:]
    dev = [float(m.group(1)) for ln in plan
           for m in [re.search(r"device=([0-9.]+)ms", ln)] if m]
    return spans, _MS.sub("", total), [_DEVICE.sub("", ln) for ln in plan], \
        dev, float(re.search(r"total: ([0-9.]+)ms", total).group(1))


def test_explain_analyze_has_reference_shape(engines):
    ref, port, _ = engines
    got = port.execute("EXPLAIN ANALYZE " + tpch.Q1).rows
    r_spans, r_total, r_plan, _, _ = _analyze_parts(ref["analyze_q1"])
    spans, total, plan, dev, total_ms = _analyze_parts(got)
    assert total == r_total == "  total: , rows returned: 4"
    assert plan == r_plan
    assert "actual rows=4" in plan[0]
    # the port's spans are the reference's less its XLA compile; the
    # port also opens the "upload" span the reference's list names
    # (a table copied to the device inside the statement) and prints
    # its own compile line (plan builds, kernel library loads)
    assert "xla compile" in r_spans and "xla compile" not in spans
    assert {"plan", "dispatch", "materialize"} <= set(spans) <= \
        set(r_spans) | {"upload", "plan build and kernel load"}
    assert len(dev) == len(plan) and all(d >= 0 for d in dev)
    assert sum(dev) <= total_ms


def test_explain_analyze_runs_the_statement_once(engines):
    """One run: the aggregate's count of plain-version calls (the
    kernel 1 path on the CPU) rises by one, and the main query's plan
    is the rendered one."""
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    _, port, _ = engines
    port.execute(tpch.Q1)
    before = tgl.PLAIN_CALLS
    port.execute("EXPLAIN ANALYZE " + tpch.Q1)
    assert tgl.PLAIN_CALLS == before + 1


def test_explain_analyze_non_select_rejected(engines):
    _, port, _ = engines
    with pytest.raises(EngineError, match="can only EXPLAIN ANALYZE "
                                          "SELECT"):
        port.execute("EXPLAIN ANALYZE INSERT INTO kv VALUES (2, 20)")


@pytest.mark.parametrize("sql", SHOWS)
def test_show_matches_reference(engines, sql):
    ref, _, show = engines
    assert show.execute(sql).rows == ref[sql]


def test_show_all_lists_the_ports_variables(engines):
    ref, _, show = engines
    got = dict(show.execute("SHOW ALL").rows)
    assert got and set(got) <= set(ref["SHOW ALL"])
    assert {k: ref["SHOW ALL"][k] for k in got} == got
    assert got["tracing"] == "off"


def test_show_unknown_and_not_ported(engines, tmp_path):
    _, _, show = engines
    with pytest.raises(EngineError, match="unknown cluster setting"):
        show.execute("SHOW no_such_thing")
    with pytest.raises(EngineError, match="does not exist"):
        show.execute("SHOW CREATE TABLE nope")
    # BACKUP and RESTORE are ported: each refuses what it cannot do
    # before it writes anything
    d = tmp_path / "empty"
    for sql, text in ((f"BACKUP TABLE nope INTO '{d}'",
                       "table 'nope' does not exist"),
                      (f"RESTORE TABLE child FROM '{d}'",
                       f"RESTORE failed: no backup found in '{d}'")):
        with pytest.raises(EngineError) as exc:
            show.execute(sql)
        assert str(exc.value) == text
