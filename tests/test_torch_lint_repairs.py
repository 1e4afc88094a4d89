"""The two faults of the port that graftlint's first run over it found.

- Three session variables the port reads (``index_scan``,
  ``index_lookup_limit``, ``oltp_batch``) were not registered in its
  SessionVars, so ``SHOW`` of each raised "unknown cluster setting" where
  the reference answers, and ``SHOW ALL`` left them out. Their SHOW rows
  are held against the reference Engine's.
- ``ops/hashtable.py`` kept the round count of the last build in a
  module global that the plan compiler read into a statement's route
  right after its build: two threads building at once could each read
  the other's count. Two sessions on two threads now build tables that
  need different round counts at the same moment, and each route keeps
  its own.
"""

import threading

import numpy as np
import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.exec.session import EngineError
from cockroach_tpu_torch.ops import hashtable
from tests.test_torch_groupagg_large import reference_modules

REPAIRED = ("index_scan", "index_lookup_limit", "oltp_batch")
# what SHOW ALL listed on the port before the repair
BEFORE = {"pallas_groupagg", "distsql", "hash_group_capacity",
          "sort_normalized", "optimizer", "optimizer_rules",
          "optimizer_sketch_stats", "streaming", "streaming_page_rows",
          "streaming_pipeline", "spill", "admission_priority", "tracing",
          "application_name", "pallas_autotune", "plan_shape_cache"}


@pytest.fixture(scope="module")
def engines():
    """(the port's Engine on the CPU, the reference's Engine)."""
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        ref = jeng.Engine()
        try:
            yield Engine(device="cpu"), ref
        finally:
            ref.close()


@pytest.mark.parametrize("var", REPAIRED)
def test_show_of_a_repaired_variable_matches_reference(engines, var):
    port, ref = engines
    got, want = port.execute(f"SHOW {var}"), ref.execute(f"SHOW {var}")
    assert got.names == want.names == [var]
    assert got.rows == want.rows


def test_show_all_lists_the_repaired_variables(engines):
    port, ref = engines
    got = dict(port.execute("SHOW ALL").rows)
    want = dict(ref.execute("SHOW ALL").rows)
    assert set(got) == BEFORE | set(REPAIRED)
    assert {v: got[v] for v in REPAIRED} == {v: want[v] for v in REPAIRED}
    assert got == {k: want[k] for k in got}


def test_session_set_of_index_lookup_limit_matches_reference(engines):
    """SET in a session changes that session's SHOW on both engines; a
    SET with no session runs in a session of its own and leaves the
    default."""
    for eng in engines:
        s = eng.session()
        eng.execute("SET index_lookup_limit = 8", s)
        assert eng.execute("SHOW index_lookup_limit", s).rows == [(8,)]
        eng.execute("SET index_lookup_limit = 8")
        assert eng.execute("SHOW index_lookup_limit").rows == [(4096,)]


def test_oltp_batch_keeps_its_value_check(engines):
    port, _ = engines
    s = port.session()
    with pytest.raises(EngineError, match="invalid value for oltp_batch"):
        port.execute("SET oltp_batch = maybe", s)
    port.execute("SET oltp_batch = off", s)
    assert port.execute("SHOW oltp_batch", s).rows == [("off",)]


def test_hashtable_keeps_no_module_round_count():
    assert not hasattr(hashtable, "ROUNDS")


def test_concurrent_builds_keep_their_own_round_counts(monkeypatch):
    """Two sessions on two threads group by hash at the same moment: one
    table of 3 widely spread keys (one round), one of 3,000 distinct keys
    in 8,192 slots (several rounds). Every build waits for the other to
    finish before either returns, so a count kept anywhere but the
    build's own return value would be read after the other's write."""
    e = Engine(device="cpu")
    e.execute("CREATE TABLE few (k INT8, v INT8)")
    e.execute("INSERT INTO few VALUES " + ",".join(
        f"({(i % 3) << 40}, {i})" for i in range(3000)))
    e.execute("CREATE TABLE wide (k INT8, v INT8)")
    e.execute("INSERT INTO wide VALUES " + ",".join(
        f"({i * 1000003}, {i})" for i in range(3000)))
    jobs = {"few": (e.session(), "SELECT k, sum(v) FROM few GROUP BY k"),
            "wide": (e.session(), "SELECT k, sum(v) FROM wide GROUP BY k")}
    jobs["wide"][0].vars.set("hash_group_capacity", 8192)
    solo = {}
    for name, (s, sql) in jobs.items():
        assert len(e.execute(sql, s).rows) == (3 if name == "few" else 3000)
        assert e.last_exec["group_ids"] == 1
        solo[name] = e.last_exec["group_ids_rounds"]
    assert solo["few"] != solo["wide"]

    barrier = threading.Barrier(2, timeout=30)
    orig = hashtable.build
    tl = threading.local()

    def build(*args, **kwargs):
        out = orig(*args, **kwargs)
        if not getattr(tl, "waited", False):
            tl.waited = True
            barrier.wait()
        return out
    monkeypatch.setattr(hashtable, "build", build)

    got, errors = {}, []

    def run(name):
        s, sql = jobs[name]
        try:
            rows = e.execute(sql, s).rows
            got[name] = (len(rows), e.last_exec["group_ids_rounds"])
        except Exception as ex:  # noqa: BLE001 - reported below
            errors.append(ex)
            barrier.abort()
    threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert got == {"few": (3, solo["few"]), "wide": (3000, solo["wide"])}
    assert np.unique([r for _, r in got.values()]).size == 2
