"""The column store's mutation and sketch calls and the clock's helpers on
the port, against the reference.

- ``ColumnStore.delete_where`` and ``update_where`` over the same seeded
  chunks (NULLs, a dictionary STRING column, two ingest timestamps)
  leave the same row versions as the reference's: each version's rowid,
  values and [ts, del) window, so every read timestamp sees the same
  rows; they return the same counts.
- ``ColumnStore.seal``: the port publishes in sealed chunks only, so it
  changes nothing and keeps the table's generation (the reference's
  seal of a table with nothing buffered); an unknown table raises.
- ``Chunk.distinct_sketch`` gives the reference's estimate.
- ``Clock.now_int`` and ``Timestamp.is_empty`` as in the reference.
"""

import numpy as np
import pytest

from cockroach_tpu_torch.sql import types as PT
from cockroach_tpu_torch.storage import columnstore as PC
from cockroach_tpu_torch.storage import hlc as PH
from tests.test_torch_groupagg_large import reference_modules


def _store(C, T, H, seed):
    s = C.ColumnStore(chunk_rows=64)
    s.create_table(T.TableSchema(
        "t", [T.ColumnSchema("k", T.INT8, nullable=False),
              T.ColumnSchema("s", T.STRING),
              T.ColumnSchema("v", T.FLOAT8)], ["k"], table_id=101))
    rng = np.random.default_rng(seed)
    for part, ts in ((0, 10), (1, 20)):
        n = 50
        k = np.arange(part * n, (part + 1) * n, dtype=np.int64)
        s.insert_columns(
            "t", {"k": k,
                  "s": np.array([f"s{int(x)}" for x in
                                 rng.integers(0, 7, n)], dtype=object),
                  "v": rng.random(n)},
            H.Timestamp(ts, 0),
            valid={"v": rng.random(n) > 0.1})
    return s


def _mutate(s, H):
    deleted = s.delete_where(
        "t", lambda c: c.valid["v"] & (c.data["v"] < 0.2),
        H.Timestamp(30, 0))

    def assign(c, m):
        data = {cn: c.data[cn][m].copy() for cn in c.data}
        valid = {cn: c.valid[cn][m].copy() for cn in c.valid}
        data["v"] = data["v"] * 2 + 1
        valid["v"] = np.ones(int(m.sum()), dtype=bool)
        return data, valid
    updated = s.update_where("t", lambda c: c.data["k"] % 3 == 0, assign,
                             H.Timestamp(40, 0))
    return deleted, updated


def _versions(s):
    """Every row version: (rowid, k, s, v or None, ts, del)."""
    td = s.table("t")
    out = []
    for c in td.chunks:
        strs = td.dictionaries["s"].decode_array(c.data["s"])
        for i in range(c.n):
            out.append((int(c.rowid[i]), int(c.data["k"][i]),
                        str(strs[i]) if c.valid["s"][i] else None,
                        float(c.data["v"][i]) if c.valid["v"][i] else None,
                        int(c.mvcc_ts[i]), int(c.mvcc_del[i])))
    return sorted(out)


@pytest.fixture(scope="module")
def reference():
    with reference_modules("cockroach_tpu.storage.columnstore",
                           "cockroach_tpu.sql.types",
                           "cockroach_tpu.storage.hlc") as (C, T, H):
        s = _store(C, T, H, seed=5)
        before = _versions(s)
        sketch = s.table("t").chunks[0].distinct_sketch("k").estimate()
        counts = _mutate(s, H)
        return {"before": before, "counts": counts,
                "after": _versions(s), "sketch": sketch,
                "empty": (
                    H.Timestamp(0, 0).is_empty, H.Timestamp(0, 1).is_empty,
                    H.Timestamp(5, 0).is_empty)}


def test_delete_and_update_where_match_the_reference(reference):
    s = _store(PC, PT, PH, seed=5)
    assert _versions(s) == reference["before"]
    counts = _mutate(s, PH)
    assert counts == reference["counts"] and all(counts)
    assert _versions(s) == reference["after"]
    td = s.table("t")
    assert td.pk_index is None
    for ts in (15, 25, 35, 45):
        tsi = PH.Timestamp(ts, 0).to_int()
        live = sum(int(c.live_mask(tsi).sum()) for c in td.chunks)
        want = sum(1 for v in reference["after"] if v[4] <= tsi < v[5])
        assert live == want
    for c in td.chunks:
        assert c.stats_ready()


def test_mutations_move_the_generation():
    s = _store(PC, PT, PH, seed=6)
    g0 = s.table("t").generation
    s.delete_where("t", lambda c: c.data["k"] < 0, PH.Timestamp(30, 0))
    g1 = s.table("t").generation
    s.update_where("t", lambda c: c.data["k"] < 0, None,
                   PH.Timestamp(31, 0))
    assert g0 < g1 < s.table("t").generation


def test_seal_changes_nothing():
    s = _store(PC, PT, PH, seed=7)
    td = s.table("t")
    gen, chunks, versions = td.generation, list(td.chunks), _versions(s)
    s.seal("t")
    assert td.generation == gen and td.chunks == chunks
    assert _versions(s) == versions
    with pytest.raises(KeyError):
        s.seal("missing")


def test_distinct_sketch_matches_the_reference(reference):
    s = _store(PC, PT, PH, seed=5)
    c = s.table("t").chunks[0]
    assert c.distinct_sketch("k").estimate() == reference["sketch"]
    assert c.distinct_sketch("nope") is None


def test_clock_now_int_and_is_empty(reference):
    clock = PH.Clock()
    a = clock.now_int()
    b = clock.now_int()
    assert isinstance(a, int) and a < b
    assert PH.Timestamp.from_int(b) > PH.Timestamp.from_int(a)
    assert (PH.Timestamp(0, 0).is_empty, PH.Timestamp(0, 1).is_empty,
            PH.Timestamp(5, 0).is_empty) == reference["empty"] == (
        True, False, False)
