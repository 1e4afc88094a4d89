"""Distributed hash-strategy GROUP BY over the CPU shard mesh against the
reference's 8-device host mesh (tests/test_dist_hash_groupby.py's
cases).

A GROUP BY without a dense bound groups shard-locally through the device
hash table, exchanges each partial group to hash(key) % 8 with the
all-to-all shuffle (parallel/shuffle.py), merges each shard's 1/8 of the
groups and all_gathers the disjoint results (exec/compile.py
_compile_hash_dist_aggregate). Both engines ingest the same seeded
arrays; each query runs on the port's mesh, on the port with
``distsql = off`` and on the reference's mesh. INT results bit-exact,
FLOAT8 within rel 1e-9. The 100,000-group case runs distributed on
both; past ``hash_group_capacity`` both re-run partition by partition
(the port's partitions side by side on two 4-slot sub-meshes).

The reference's test draws keys from 0..n_keys-1, a span both planners
group densely (a single INT key spanning at most 2^21 values), so its
GROUP BYs never reach the hash strategy. Here the keys are spread by
SPREAD (key * 4,194,305, a span past 2^21) so that every case takes the
hash route through the exchange; the reference's own 100,000-key table
runs too, densely (kernel 1 on every shard, in both engines).
"""

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
from cockroach_tpu_torch.parallel.distagg import analyze
from cockroach_tpu_torch.parallel.mesh import make_mesh
from cockroach_tpu_torch.sql import plan as P

CPU8 = [torch.device("cpu")] * 8
# table -> (rows, distinct keys, spread), the sizes of
# tests/test_dist_hash_groupby.py
SPREAD = (1 << 22) + 1
TABLES = {"hg3k": (20_000, 3_000, SPREAD), "hg500": (20_000, 500, SPREAD),
          "hg100k": (300_000, 100_000, SPREAD),
          "hg100k_dense": (300_000, 100_000, 1),
          "hg200": (10_000, 200, SPREAD), "hg2k": (5_000, 2_000, SPREAD)}
QUERIES = {
    "sum_count": ("hg3k", "SELECT k, sum(v) AS s, count(*) AS c FROM hg3k "
                          "GROUP BY k ORDER BY k", None),
    "avg_min_max": ("hg500", "SELECT k, avg(f) AS a, min(v) AS mn, "
                             "max(v) AS mx FROM hg500 GROUP BY k ORDER BY k",
                    None),
    "groups_100k": ("hg100k", "SELECT k, sum(v) AS s FROM hg100k "
                              "GROUP BY k", None),
    "groups_100k_dense": ("hg100k_dense", "SELECT k, sum(v) AS s FROM "
                                          "hg100k_dense GROUP BY k", None),
    "having_sort": ("hg200", "SELECT k, count(*) AS c FROM hg200 GROUP BY k "
                             "HAVING count(*) > 40 ORDER BY c DESC, k "
                             "LIMIT 10", None),
    "overflow": ("hg2k", "SELECT k, sum(v) AS s FROM hg2k GROUP BY k", 1024),
}


def _columns(n_rows: int, n_keys: int, spread: int) -> dict:
    rng = np.random.default_rng(7)
    return {"k": rng.integers(0, n_keys, size=n_rows).astype(np.int64)
            * spread,
            "v": rng.integers(-1000, 1000, size=n_rows).astype(np.int64),
            "f": rng.random(n_rows)}


def _load(eng) -> None:
    for t, (n, keys, spread) in TABLES.items():
        eng.execute(f"CREATE TABLE {t} (k INT8 NOT NULL, v INT8, f FLOAT)")
        eng.store.insert_columns(t, _columns(n, keys, spread),
                                 eng.clock.now())


def _sessions(eng, cap):
    out = []
    for dist in ("auto", "off"):
        s = eng.session()
        s.vars.set("distsql", dist)
        if cap is not None:
            s.vars.set("hash_group_capacity", cap)
        out.append(s)
    return out


@pytest.fixture(scope="module")
def reference():
    # imported here: the card-only case runs without the reference
    from tests.test_torch_groupagg_large import reference_modules
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        e = jeng.Engine()
        try:
            assert e.mesh is not None and e.mesh.size == 8
            _load(e)
            out = {}
            for q, (_t, sql, cap) in QUERIES.items():
                for s, dist in zip(_sessions(e, cap), ("auto", "off")):
                    out[q, dist] = e.execute(sql, s).rows
        finally:
            e.close()
    return out


@pytest.fixture(scope="module")
def port():
    e = Engine(device="cpu", mesh=make_mesh(CPU8))
    _load(e)
    yield e
    e.close()


def _run_both(eng, q):
    _t, sql, cap = QUERIES[q]
    s_dist, s_local = _sessions(eng, cap)
    calls = eng.metrics.counter("exec.allreduce.calls")
    c0 = calls.value()
    dist = eng.execute(sql, s_dist).rows
    route = dict(eng.last_exec)
    assert calls.value() > c0  # it ran distributed
    local = eng.execute(sql, s_local).rows
    return dist, local, route


def test_analyzer_accepts_hash_groupby(port):
    node = port._plan_sql("SELECT k, sum(v) AS s FROM hg3k GROUP BY k",
                          port.session())[0]
    d = analyze(node)
    assert d.ok, d.reason
    # a hash-strategy aggregate: no dense bound
    assert isinstance(node, P.Aggregate) and node.max_groups == 0


def test_sum_count_by_int_key(reference, port):
    traced = port.metrics.get("exec.movement.exchange.traced.bytes")
    b0 = traced.value()
    dist, local, route = _run_both(port, "sum_count")
    assert len(dist) == len(local) > 2500
    assert dist == local == reference["sum_count", "auto"]
    # the local table and the merge table: two group_ids a shard
    assert route["group_ids"] == 2
    assert traced.value() > b0


def test_avg_min_max_merge(reference, port):
    dist, local, _ = _run_both(port, "avg_min_max")
    want = reference["avg_min_max", "auto"]
    assert len(dist) == len(local) == len(want)
    for rd, rl, rw in zip(dist, local, want):
        assert rd[0] == rl[0] == rw[0]
        assert rd[1] == pytest.approx(rl[1], rel=1e-9)
        assert rd[1] == pytest.approx(rw[1], rel=1e-9)
        assert rd[2:] == rl[2:] == rw[2:]


@pytest.mark.parametrize("q", ["groups_100k", "groups_100k_dense"])
def test_100k_groups_distribute(reference, port, q):
    """A 100,000-group aggregation runs distributed (by hash through the
    exchange, and densely through kernel 1 on every shard) and matches
    the single-device run and the reference's mesh."""
    before = tgl.PLAIN_CALLS
    dist, local, route = _run_both(port, q)
    if q == "groups_100k":
        assert route["group_ids"] == 2
    else:
        assert route["group_ids"] == 0 and tgl.PLAIN_CALLS - before == 9
    assert len(dist) == len(local) > 90_000
    assert sorted(dist) == sorted(local) == sorted(reference[q, "auto"])


def test_having_and_sort_above_hash_dist(reference, port):
    dist, local, _ = _run_both(port, "having_sort")
    assert dist == local == reference["having_sort", "auto"]


def test_capacity_overflow_spills(reference, port):
    """More distinct keys than half the table's slots: the distributed
    and the single-device plan both re-run partition by partition, and
    the distributed partitions run on the pool's two 4-slot sub-meshes
    side by side."""
    sweeps = port.metrics.counter("exec.spill.submesh_sweeps")
    n0 = sweeps.value()
    dist, local, route = _run_both(port, "overflow")
    assert route["partitioned"] and sweeps.value() > n0
    assert len(dist) == len(local) > 1_500
    assert sorted(dist) == sorted(local) == sorted(
        reference["overflow", "auto"]) == sorted(
        reference["overflow", "off"])


@pytest.mark.gpu
def test_hash_groupby_on_card_matches_local():
    """Four shard slots on one card: the hash route through the exchange
    gives the card's own local rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    e = Engine(mesh=make_mesh([torch.device("cuda", 0)] * 4))
    try:
        _load(e)
        dist, local, route = _run_both(e, "sum_count")
        assert route["group_ids"] == 2 and dist == local
    finally:
        e.close()
