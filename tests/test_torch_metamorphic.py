"""Metamorphic constants and invariant checks of the port.

Under ``COCKROACH_TPU_METAMORPHIC=<seed>`` the port's registered
constants (the columnstore's chunk size, the session default of
``streaming_page_rows``) take seeded values from their legal ranges,
as in the reference; results must not move. Here the module's
generator is seeded in process: TPC-H Q1, Q6 and a grouped ship-mode
query over lineitem appended through INSERT statements into chunks of
64 to 256 rows give the rows of the default 2^20-row chunks,
and ``utils/invariants.validate_table`` holds after INSERT, UPDATE,
DELETE and TRUNCATE on a perturbed store. Without the variable every
constant is its production default.
"""

import random

import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.storage.columnstore import ColumnStore
from cockroach_tpu_torch.utils import invariants, metamorphic
from cockroach_tpu_torch.utils.settings import SessionVars

QUERIES = {"q1": tpch.Q1, "q6": tpch.Q6,
           "by_mode": ("SELECT l_shipmode, count(*) AS c, "
                       "sum(l_extendedprice) AS s, max(l_discount) AS d "
                       "FROM lineitem GROUP BY l_shipmode "
                       "ORDER BY l_shipmode")}


@pytest.fixture()
def perturbed(monkeypatch):
    """A seeded generator in place of the environment's."""
    def seed(n):
        monkeypatch.setattr(metamorphic, "_rng", random.Random(n))
        monkeypatch.setattr(metamorphic, "chosen", {})
    return seed


def test_defaults_without_the_variable():
    if metamorphic.is_active():
        pytest.skip("COCKROACH_TPU_METAMORPHIC is set")
    assert ColumnStore().chunk_rows == 1 << 20
    assert SessionVars().get("streaming_page_rows") == 1 << 21


def test_seeded_constants_are_in_range_and_recorded(perturbed):
    perturbed(7)
    rows = ColumnStore().chunk_rows
    page = SessionVars().get("streaming_page_rows")
    assert 1 << 6 <= rows <= 1 << 20 and rows & (rows - 1) == 0
    assert 1 << 12 <= page <= 1 << 21 and page & (page - 1) == 0
    assert metamorphic.chosen == {"columnstore.chunk_rows": rows,
                                  "sql.streaming_page_rows": page}
    # one value a name, however often it is read
    assert ColumnStore().chunk_rows == rows


def _loaded(store=None) -> Engine:
    """lineitem through INSERT statements (appends fill chunks of the
    store's chunk size; a bulk ingest is one chunk a call)."""
    e = Engine(device="cpu", store=store)
    e.execute(tpch.DDL["lineitem"])
    for stmt in tpch.insert_statements(
            "lineitem", tpch.gen_lineitem(0.01, rows=600)):
        e.execute(stmt)
    return e


@pytest.fixture(scope="module")
def baseline():
    e = _loaded()
    return {q: e.execute(sql).rows for q, sql in QUERIES.items()}


@pytest.mark.parametrize("seed", [1, 2])
def test_tpch_rows_do_not_move_with_the_chunk_size(perturbed, baseline,
                                                   seed):
    perturbed(seed)
    # the draw capped at 2^8 rows so the 600 rows span several chunks
    rows = min(metamorphic.metamorphic_pow2(
        "columnstore.chunk_rows", 1 << 20, 6, 20), 1 << 8)
    e = _loaded(ColumnStore(chunk_rows=rows))
    assert len(e.store.table("lineitem").chunks) >= 600 // rows
    for q, sql in QUERIES.items():
        assert e.execute(sql).rows == baseline[q], q
    invariants.validate_table(e.store, "lineitem")


def test_validate_table_after_dml(perturbed):
    perturbed(3)
    e = Engine(device="cpu", store=ColumnStore(chunk_rows=64))
    e.execute("CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, v INT8, "
              "s STRING)")
    e.execute("INSERT INTO t VALUES " + ", ".join(
        f"({i}, {i * 3}, 's{i % 7}')" for i in range(300)))
    invariants.validate_table(e.store, "t")
    e.execute("UPDATE t SET v = v + 1 WHERE k < 150")
    e.execute("DELETE FROM t WHERE k % 5 = 0")
    e.execute("INSERT INTO t VALUES (1000, 1, 'new')")
    invariants.validate_table(e.store, "t")
    assert e.execute("SELECT count(*), sum(v) FROM t").rows == [
        (241, sum(i * 3 + (i < 150) for i in range(300) if i % 5) + 1)]
    e.execute("TRUNCATE t")
    invariants.validate_table(e.store, "t")
    assert invariants.expensive_enabled()


def test_validate_table_catches_a_broken_chunk():
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (k INT8, v INT8)")
    e.execute("INSERT INTO t VALUES (1, 2), (3, 4)")
    ch = e.store.table("t").chunks[-1]
    ch.mvcc_del[0] = ch.mvcc_ts[0] - 1
    with pytest.raises(AssertionError, match="deletion before write"):
        invariants.validate_table(e.store, "t")
