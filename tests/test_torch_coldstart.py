"""The port's cold-start plane (exec/coldstart.py) against the JAX
package's.

Ladders: ``ShapeLadder.bucket/budget/rungs`` equal the reference's for
every valid (min_rows, steps_per_octave) over row counts from 1 to 2^22,
every rung a multiple of 128, the default ladder the power-of-two
padding above 1,024 rows; invalid ladders raise the reference's errors.
TPC-H Q1, Q6 and Q12 on the reference's store (sf 0.01, lineitem capped
at 20,000 rows) give the reference Engine's rows under the default
ladder and under a finer one. The shapes journal and prewarm round-trip
(the journaled session variables replayed), prewarm is off by default,
a second process serves its first statement from the exec cache after
its prewarm, a prewarm failure is counted and logged (a kernel error
raises), the compile split reaches /_status/statements and EXPLAIN
ANALYZE, and the port's default cache root is never created here.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cockroach_tpu.exec import coldstart as rcs
from cockroach_tpu_torch.exec import coldstart as tcs
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.server.node import _statements_payload
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from tests.test_torch_engine import _assert_rows_equal, _store_arrays
from tests.test_torch_groupagg_large import reference_modules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DEFAULT_ROOT_EXISTED = os.path.exists(tcs.default_cache_root())

QUERIES = {"q1": tpch.Q1, "q6": tpch.Q6, "q12": tpch.Q12}
VALID = [(mr, s) for mr in (1 << e for e in range(7, 17))
         for s in (1, 2, 4, 8) if mr // s >= 128]
INVALID = [(64, 1), (100, 1), (1000, 2), (128, 2), (1024, 3), (1024, 16),
           (1024, 0), (256, 4)]


def _sweep() -> np.ndarray:
    rng = np.random.default_rng(7)
    edges = [v for e in range(7, 23) for v in ((1 << e) - 1, 1 << e,
                                               (1 << e) + 1)]
    return np.unique(np.concatenate([
        np.arange(1, 5000), edges, rng.integers(1, 1 << 22, 3000)]))


def test_ladders_equal_the_reference():
    ns = [int(n) for n in _sweep()]
    for mr, s in VALID:
        t, r = tcs.ShapeLadder(mr, s), rcs.ShapeLadder(mr, s)
        got = [t.bucket(n) for n in ns]
        assert got == [r.bucket(n) for n in ns], (mr, s)
        assert all(b % 128 == 0 and b >= n for b, n in zip(got, ns))
        for top in (1, 1000, 5000, 1 << 20, 1 << 22):
            assert t.rungs(top) == r.rungs(top), (mr, s, top)
            assert t.budget(top) == r.budget(top) == len(t.rungs(top))
    default = tcs.ShapeLadder()
    assert default == tcs.ShapeLadder(1024, 1)
    for n in ns:
        want = 1024 if n <= 1024 else 1 << (n - 1).bit_length()
        assert default.bucket(n) == want


@pytest.mark.parametrize("mr,s", INVALID)
def test_invalid_ladders_raise_the_reference_errors(mr, s):
    with pytest.raises(ValueError) as want:
        rcs.ShapeLadder(mr, s)
    with pytest.raises(ValueError) as got:
        tcs.ShapeLadder(mr, s)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def reference():
    """The reference's store as arrays and its rows of QUERIES."""
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch") as (jeng, jtpch):
        e = jeng.Engine()
        try:
            jtpch.load(e, sf=0.01, rows=20_000,
                       tables=("lineitem", "orders"))
            rows = {q: e.execute(sql).rows for q, sql in QUERIES.items()}
            return _store_arrays(e.store, jtpch.DDL), rows
        finally:
            e.close()


@pytest.mark.parametrize("ladder", [(1024, 1), (256, 2)])
def test_rows_under_both_ladders_equal_the_reference(reference, ladder):
    arrays, want = reference
    e = Engine(device="cpu", store=store_from_arrays(arrays))
    e.settings.set("sql.exec.shape_bucket.min_rows", ladder[0])
    e.settings.set("sql.exec.shape_bucket.steps_per_octave", ladder[1])
    try:
        for q, sql in QUERIES.items():
            _assert_rows_equal(e.execute(sql).rows, want[q])
        n = e.store.table("lineitem").row_count
        padded = {b.n for (t, _), (_, b) in e._device_tables.items()
                  if t == "lineitem"}
        assert padded == {tcs.ShapeLadder(*ladder).bucket(n)}
    finally:
        e.close()


def _engine(root, rows: int = 5000) -> Engine:
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (k INT PRIMARY KEY, v INT, g INT)")
    e.store.insert_columns("t", {"k": np.arange(rows),
                                 "v": (np.arange(rows) * 13) % 500,
                                 "g": np.arange(rows) % 7}, e.clock.now())
    assert e._compile_cache_dir.startswith(str(root))
    return e


GROUPED = "SELECT g, sum(v), min(v), max(k) FROM t GROUP BY g ORDER BY g"
FILTERED = "SELECT count(*) FROM t WHERE v < 100"


def test_journal_and_prewarm_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv(tcs.ENV_VAR, str(tmp_path))
    a = _engine(tmp_path)
    s = a.session()
    a.execute("SET hash_group_capacity = 256", s)
    a.execute("SET sort_normalized = off", s)
    want = a.execute(GROUPED, s).rows
    a.execute(GROUPED, s)          # a hit journals nothing
    a.execute(FILTERED)
    d = a._compile_cache_dir
    entries = tcs.journal_entries(d, 8)
    assert entries == rcs.journal_entries(d, 8)
    assert sorted(entries) == sorted([
        (GROUPED, 0, {"hash_group_capacity": 256,
                      "sort_normalized": "off"}),
        (FILTERED, 0, {})])
    assert tcs.journal_top(d, 1) == rcs.journal_top(d, 1)
    a.close()

    b = _engine(tmp_path)
    b.settings.set("sql.exec.compile_cache.prewarm", 8)
    assert b.prewarm() == 2
    m0 = b.plan_cache["miss"]
    s2 = b.session()
    b.execute("SET hash_group_capacity = 256", s2)
    b.execute("SET sort_normalized = off", s2)
    assert b.execute(GROUPED, s2).rows == want
    assert b.execute(FILTERED).rows == [(1000,)]
    assert b.plan_cache["miss"] == m0   # both warmed under their vars
    assert b.execute(GROUPED).rows == want   # default vars: another plan
    assert b.plan_cache["miss"] == m0 + 1
    b.close()


def test_prewarm_is_off_by_default(tmp_path, monkeypatch):
    monkeypatch.setenv(tcs.ENV_VAR, str(tmp_path))
    e = _engine(tmp_path)
    e.execute(GROUPED)
    assert e.settings.get("sql.exec.compile_cache.prewarm") == 0
    assert e.prewarm() == 0 and e.plan_cache["miss"] == 1
    assert e.prewarm(top_k=4) == 1
    e.close()


_CHILD = r"""
import json, sys
import numpy as np
from cockroach_tpu_torch.exec.engine import Engine
e = Engine(device="cpu")
e.execute("CREATE TABLE t (k INT PRIMARY KEY, v INT, g INT)")
e.store.insert_columns("t", {"k": np.arange(5000),
                             "v": (np.arange(5000) * 13) % 500,
                             "g": np.arange(5000) % 7}, e.clock.now())
e.settings.set("sql.exec.compile_cache.prewarm", int(sys.argv[1]))
warmed = e.prewarm()
h0, m0 = e.plan_cache["hit"], e.plan_cache["miss"]
rows = e.execute(sys.argv[2]).rows
print(json.dumps({"warmed": warmed, "hit": e.plan_cache["hit"] - h0,
                  "miss": e.plan_cache["miss"] - m0,
                  "rows": [list(map(int, r)) for r in rows]}))
"""


def test_second_process_serves_its_first_statement_warm(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv(tcs.ENV_VAR, str(tmp_path))
    a = _engine(tmp_path)
    want = [list(r) for r in a.execute(GROUPED).rows]
    a.close()
    env = dict(os.environ, PYTHONPATH=REPO)
    for prewarm, hit in ((8, 1), (0, 0)):
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, str(prewarm), GROUPED],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got == {"warmed": 1 if prewarm else 0, "hit": hit,
                       "miss": 1 - hit, "rows": want}


def test_prewarm_failure_is_counted_not_swallowed(tmp_path, monkeypatch):
    monkeypatch.setenv(tcs.ENV_VAR, str(tmp_path))
    e = _engine(tmp_path)
    e.execute(GROUPED)
    tcs.journal_record(e._compile_cache_dir, "SELECT count(*) FROM gone")
    errors = e.metrics.get("exec.compile.prewarm_errors")
    warmed = e.metrics.get("exec.compile.prewarmed")
    e0, w0 = errors.value(), warmed.value()
    assert e.prewarm(top_k=8) == 1
    assert (errors.value(), warmed.value()) == (e0 + 1, w0 + 1)

    from cockroach_tpu_torch.exec import session as S

    def broken(self, read_ts=None):
        raise RuntimeError("groupagg_large launch failed: injected")
    monkeypatch.setattr(S.Prepared, "dispatch", broken)
    with pytest.raises(RuntimeError, match="injected"):
        e.prewarm(top_k=8)
    e.close()


def test_compile_split_reaches_statements_and_explain(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv(tcs.ENV_VAR, str(tmp_path))
    e = _engine(tmp_path)
    builds = e.metrics.get("exec.compile.plan_builds")
    b0 = builds.value()
    e.execute(GROUPED)
    e.execute(GROUPED)
    assert builds.value() == b0 + 1
    st = [s for s in _statements_payload(e)["statements"]
          if s["fingerprint"].startswith("SELECT g, sum(v)")]
    assert len(st) == 1 and st[0]["count"] == 2
    assert 0 < st[0]["mean_compile_s"] < st[0]["total_compile_s"]
    assert st[0]["mean_exec_s"] >= 0
    lines = [r[0] for r in e.execute("EXPLAIN ANALYZE SELECT g, count(*) "
                                     "FROM t WHERE v > 3 GROUP BY g").rows]
    line = [ln for ln in lines if "plan build and kernel load" in ln]
    assert len(line) == 1 and float(line[0].split(":")[1][:-2]) > 0
    lines = [r[0] for r in e.execute("EXPLAIN ANALYZE SELECT g, count(*) "
                                     "FROM t WHERE v > 3 GROUP BY g").rows]
    assert not any("plan build and kernel load" in ln for ln in lines)
    for name in ("exec.compile.cache_hit", "exec.compile.cache_miss",
                 "exec.compile.seconds"):
        assert e.metrics.get(name) is not None
    e.close()


def test_cache_root_resolution_and_hermetic_default(tmp_path, monkeypatch):
    e = Engine(device="cpu")
    try:
        assert e._compile_cache_dir == tcs.cache_dir(
            os.environ[tcs.ENV_VAR], e.device)
        assert os.path.basename(e._compile_cache_dir).startswith("cpu-torch")
        e.settings.set("sql.exec.compile_cache.dir", str(tmp_path / "s"))
        assert tcs.resolve_cache_root(e.settings) == str(tmp_path / "s")
        e.settings.set("sql.exec.compile_cache.dir", "off")
        assert tcs.resolve_cache_root(e.settings) is None
    finally:
        e.close()
    monkeypatch.setenv(tcs.ENV_VAR, "off")
    e = Engine(device="cpu")
    assert e._compile_cache_dir is None and e.prewarm(top_k=4) == 0
    e.close()
    blocker = tmp_path / "a-file"
    blocker.write_text("not a directory")
    monkeypatch.setenv(tcs.ENV_VAR, str(blocker))
    e = Engine(device="cpu")     # an unusable root: the engine runs cold
    assert e._compile_cache_dir is None
    assert e.execute("SELECT 1 + 1").rows == [(2,)]
    e.close()
    monkeypatch.delenv(tcs.ENV_VAR)
    assert tcs.resolve_cache_root() == tcs.default_cache_root()
    assert tcs.default_cache_root().endswith(
        os.path.join(".cache", "cockroach_tpu_torch"))
    assert _DEFAULT_ROOT_EXISTED or \
        not os.path.exists(tcs.default_cache_root())


def test_chip_smoke_phase17_on_the_cpu():
    """chip_smoke.py's phase 17 at a small size on a CPU engine: every
    check it makes on the card but the kernel-vs-plain ones (the plain
    versions count their calls here)."""
    import chip_smoke
    out = chip_smoke.coldstart_phase_alone(0.01, "cpu", rows=20_000)
    assert out["gate"]["promoted"] == ["int_minmax"]
    # the MIN/MAX GROUP BY, Q2, and Q1 at the shipped and tuned points
    assert out["launches"] == {"groupagg_large": 4, "groupagg": 0}
    assert out["minmax_queries"]["q2"]["launches"] == 1
    assert (out["plan_shape_cache"]["misses"],
            out["plan_shape_cache"]["hits"]) == (1, 4)
    assert len(out["sweep"]["points"]) == 6
    warm, cold = out["coldstart"]["warmed"], out["coldstart"]["unwarmed"]
    assert (warm["warmed"], warm["q1_hit"], cold["q1_hit"]) == (2, 1, 0)
