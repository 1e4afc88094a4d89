"""The port's spill tier against the reference Engine, on the CPU.

The reference Engine (cockroach_tpu, no mesh) loads the ``fact`` and
``dim`` tables of tests/test_spill_operators.py (6,000 fact rows with
duplicate, NULL and scattered join keys, INT64 extremes in a sort-only
column; 1,500 dim rows with NULL keys) and runs each statement twice:
at an ample budget with ``spill = off`` (resident) and at a 64 KiB
budget with ``spill = auto`` (a partitioned external hash join, or an
external merge sort), pages of 2,048 rows, as that file's A/B does. It
also renders its placement verdict for a matrix of (statement, budget,
spill mode). Its store is carried into the port (``store_from_arrays``)
and every run repeats on ``Engine(device="cpu")``. The port's spilled
rows must equal the reference's spilled rows and the port's resident
rows, in order: the join parity cases (inner, left, filtered) and the
reference's six ORDER BY cases (INT64 extremes under DESC and NULLS
FIRST, LIMIT/OFFSET) plus an empty selection. The verdicts must agree
at budgets clear of both engines' thresholds. ``spill = off`` at the
small budget is a MemoryQuotaError at the build's upload. The host
helpers the tier shares with the reference, ``radix_partition_ids`` and
``merge_lanes_host``, must be bit-equal to the reference's on seeded
inputs.
"""

import numpy as np
import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.ops import join as tjoin
from cockroach_tpu_torch.ops import sortkey as tsortkey
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from cockroach_tpu_torch.utils.mon import MemoryQuotaError
from tests.test_torch_groupagg_large import reference_modules
from tests.test_torch_stream import carry

AMPLE = 12 << 30
TINY = 1 << 16
I64_MIN = -(2 ** 63)
I64_MAX = 2 ** 63 - 1
FACT_DDL = "CREATE TABLE fact (k INT8, g INT8 NOT NULL, v INT8, x INT8)"
DIM_DDL = "CREATE TABLE dim (k INT8, w INT8)"

JOIN_Q = ("SELECT g, SUM(v) AS sv, SUM(w) AS sw, COUNT(*) AS c "
          "FROM fact JOIN dim ON fact.k = dim.k GROUP BY g ORDER BY g")
JOINS = {
    "inner": JOIN_Q,
    "left": ("SELECT g, COUNT(*) AS c, COUNT(w) AS cw, SUM(w) AS sw "
             "FROM fact LEFT JOIN dim ON fact.k = dim.k GROUP BY g "
             "ORDER BY g"),
    "filtered": ("SELECT COUNT(*) AS c, MIN(v) AS lo, MAX(w) AS hi "
                 "FROM fact JOIN dim ON fact.k = dim.k "
                 "WHERE v > 0 AND w < 40"),
}
SORTS = [
    "SELECT k, v FROM fact ORDER BY v DESC, k LIMIT 37",
    "SELECT k, v FROM fact ORDER BY v NULLS FIRST, k DESC "
    "LIMIT 50 OFFSET 13",
    "SELECT g, v FROM fact WHERE v > -50 ORDER BY g DESC, v",
    "SELECT v FROM fact ORDER BY v",
    "SELECT k, x FROM fact ORDER BY x DESC NULLS FIRST, k LIMIT 64",
    "SELECT x FROM fact ORDER BY x LIMIT 8",
    # an empty selection
    "SELECT k, v FROM fact WHERE v > 9000 ORDER BY v LIMIT 5",
]
STREAM_Q = "SELECT g, SUM(v) AS s FROM fact GROUP BY g ORDER BY g"
SORT_Q = "SELECT k, v FROM fact ORDER BY v LIMIT 9"
# (statement, budget, spill mode): the verdict matrix
VERDICTS = [
    (JOIN_Q, AMPLE, "auto"), (JOIN_Q, TINY, "auto"),
    (SORT_Q, TINY, "auto"), (SORT_Q, AMPLE, "auto"),
    (STREAM_Q, TINY, "auto"), (JOIN_Q, TINY, "off"),
    (SORT_Q, TINY, "off"), (JOIN_Q, AMPLE, "on"), (SORT_Q, AMPLE, "on"),
]
CASES = [("join", k, q) for k, q in JOINS.items()] + \
    [("sort", str(i), q) for i, q in enumerate(SORTS)]


def _fact_dim(n=6000, m=1500, seed=0):
    """tests/test_spill_operators.py's fact and dim columns."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, m, n).astype(np.int64) * 7 + 3
    kv = rng.random(n) > 0.05
    g = rng.integers(0, 8, n).astype(np.int64)
    v = rng.integers(-100, 100, n).astype(np.int64)
    vv = rng.random(n) > 0.1
    x = rng.integers(I64_MIN // 2, I64_MAX // 2, n).astype(np.int64)
    x[:4] = (I64_MIN, I64_MAX, 0, -1)
    xv = rng.random(n) > 0.1
    dk = np.arange(m, dtype=np.int64) * 7 + 3
    dkv = rng.random(m) > 0.05
    dw = rng.integers(0, 50, m).astype(np.int64)
    dwv = rng.random(m) > 0.2
    return ({"k": k, "g": g, "v": v, "x": x},
            {"k": kv, "v": vv, "x": xv},
            {"k": dk, "w": dw}, {"k": dkv, "w": dwv})


def _session(eng):
    s = eng.session()
    s.vars.set("distsql", "off")
    s.vars.set("streaming_page_rows", 2048)
    return s


def _ab(eng, s, sql):
    """(spill off at an ample budget, spill auto at TINY) rows."""
    eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)
    s.vars.set("spill", "off")
    base = eng.execute(sql, s).rows
    eng.settings.set("sql.exec.hbm_budget_bytes", TINY)
    s.vars.set("spill", "auto")
    try:
        got = eng.execute(sql, s).rows
    finally:
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)
        s.vars.set("spill", "off")
    return base, got


def _verdicts(eng, s):
    out = []
    for sql, budget, mode in VERDICTS:
        eng.settings.set("sql.exec.hbm_budget_bytes", budget)
        s.vars.set("spill", mode)
        try:
            out.append(eng.stream_verdict(sql, s))
        finally:
            eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)
            s.vars.set("spill", "off")
    return out


def _run_all(eng):
    s = _session(eng)
    rows = {(kind, key): _ab(eng, s, sql) for kind, key, sql in CASES}
    return rows, _verdicts(eng, s)


@pytest.fixture(scope="module")
def reference():
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.ops.join",
                           "cockroach_tpu.ops.sortkey") as (
            jeng, jjoin, jsortkey):
        e = jeng.Engine(mesh=None)
        try:
            e.execute(FACT_DDL)
            e.execute(DIM_DDL)
            fcols, fvalid, dcols, dvalid = _fact_dim()
            e.store.insert_columns("fact", fcols, e.clock.now(),
                                   valid=fvalid)
            e.store.insert_columns("dim", dcols, e.clock.now(),
                                   valid=dvalid)
            e.execute("ANALYZE fact")
            e.execute("ANALYZE dim")
            rows, verdicts = _run_all(e)
            arrays = carry(e.store, {"fact": FACT_DDL, "dim": DIM_DDL})
        finally:
            e.close()
        yield rows, verdicts, arrays, jjoin, jsortkey


@pytest.fixture(scope="module")
def port(reference):
    eng = Engine(device="cpu", store=store_from_arrays(reference[2]))
    rows, verdicts = _run_all(eng)
    return eng, rows, verdicts


@pytest.mark.parametrize("kind,key", [(c[0], c[1]) for c in CASES])
def test_spilled_rows_match_reference_and_resident(reference, port,
                                                   kind, key):
    ref_base, ref_got = reference[0][kind, key]
    base, got = port[1][kind, key]
    assert got == ref_got
    assert got == base
    assert base == ref_base
    if kind == "join" and key == "inner":
        assert len(base) == 8


def test_spill_routes_and_partitions(port):
    """The A/B really spilled: the join sweeps partitions, the sort
    merges runs."""
    eng, _, _ = port
    s = _session(eng)
    eng.settings.set("sql.exec.hbm_budget_bytes", TINY)
    s.vars.set("spill", "auto")
    try:
        p = eng.prepare(JOIN_Q, s)
        assert p.spill is not None and p.spill.kind == "join"
        assert p.spill.nparts >= 2
        p.run()
        assert eng.last_exec["paging"]["route"] == "spill-join"
        assert eng.last_exec["paging"]["partitions"] == p.spill.nparts
        eng.execute(SORTS[0], s)
        assert eng.last_exec["paging"]["route"] == "spill-sort"
        assert eng.last_exec["paging"]["pages"] == 3  # 6000 / 2048
    finally:
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)
        s.vars.set("spill", "off")


def test_verdict_matrix(reference, port):
    want = ["resident", "spill-join", "spill-sort", "resident",
            "stream-scan", "stream-scan", "resident", "spill-join",
            "spill-sort"]
    assert reference[1] == want
    assert port[2] == want


def test_working_set_sets_the_verdict_thresholds(port):
    """Engine.working_set is the reckoning the verdicts read: the join
    streams one byte under its resident working set and spills one
    byte under its spill floor."""
    eng, _, _ = port
    s = _session(eng)
    s.vars.set("spill", "auto")
    try:
        ws = eng.working_set(JOIN_Q, s)
        assert ws["spill_floor"] == ws["builds"] + ws["page_window"]
        assert 0 < ws["spill_floor"] < ws["probe_resident"] \
            < ws["resident"]
        for budget, want in ((ws["probe_resident"], "resident"),
                             (ws["probe_resident"] - 1, "stream-scan"),
                             (ws["spill_floor"], "stream-scan"),
                             (ws["spill_floor"] - 1, "spill-join")):
            eng.settings.set("sql.exec.hbm_budget_bytes", budget)
            assert eng.stream_verdict(JOIN_Q, s) == want, budget
        # a plan that cannot page has no page terms
        assert set(eng.working_set(SORT_Q, s)) == {"resident", "builds"}
    finally:
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)
        s.vars.set("spill", "off")


def test_spill_off_raises_quota_error(port):
    eng, _, _ = port
    eng.drop_device_cache()
    s = _session(eng)
    eng.settings.set("sql.exec.hbm_budget_bytes", TINY)
    s.vars.set("spill", "off")
    try:
        with pytest.raises(MemoryQuotaError):
            eng.execute(JOIN_Q, s)
    finally:
        eng.settings.set("sql.exec.hbm_budget_bytes", AMPLE)


@pytest.mark.parametrize("nparts", [1, 2, 16, 256])
def test_radix_partition_ids_bit_equal(reference, nparts):
    jjoin = reference[3]
    rng = np.random.default_rng(nparts)
    n = 5000
    a = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64)
    a[:3] = (I64_MIN, I64_MAX, -1)
    b = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    va = rng.random(n) > 0.1
    vb = rng.random(n) > 0.1
    for cols, valids in (([a], [va]), ([a, b], [va, vb]), ([b], [vb])):
        got = tjoin.radix_partition_ids(cols, valids, nparts)
        want = jjoin.radix_partition_ids(cols, valids, nparts)
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < nparts
    # an int32 and an int64 column holding equal values partition alike
    np.testing.assert_array_equal(
        tjoin.radix_partition_ids([b], [vb], nparts),
        tjoin.radix_partition_ids([b.astype(np.int64)], [vb], nparts))


@pytest.mark.parametrize("lanes", [1, 3])
def test_merge_lanes_host_bit_equal(reference, lanes):
    jsortkey = reference[4]
    rng = np.random.default_rng(lanes)
    runs = []
    for k in (7, 0, 300, 41):
        r = rng.integers(0, 1 << 63, (lanes, k), dtype=np.uint64) \
            * np.uint64(2)
        r[:, ::5] = np.uint64(0xFFFFFFFFFFFFFFFF)
        # each run is sorted on its lanes, as the device leaves it
        order = np.lexsort(tuple(reversed(list(r)))) if k else []
        runs.append(r[:, order])
    want = jsortkey.merge_lanes_host(runs)
    np.testing.assert_array_equal(tsortkey.merge_lanes_host(runs), want)
    # the port's lanes are int64 bit patterns: the same order
    np.testing.assert_array_equal(
        tsortkey.merge_lanes_host([r.view(np.int64) for r in runs]), want)


def test_host_page_iter_and_partition_indices(reference):
    """The spill tier's host paging and partition index lists against
    the reference's (exec/spill.py)."""
    with reference_modules("cockroach_tpu.exec.spill") as (jspill,):
        from cockroach_tpu_torch.exec import spill as tspill
        rng = np.random.default_rng(5)
        cols = {"a": rng.integers(0, 100, 1000), "b": rng.random(1000)}
        for n, page in ((1000, 128), (1000, 1000), (0, 64), (999, 1)):
            got = list(tspill.host_page_iter(n, cols, page))
            want = list(jspill.host_page_iter(n, cols, page))
            assert [g[0] for g in got] == [w[0] for w in want]
            for (_, g), (_, w) in zip(got, want):
                for c in cols:
                    np.testing.assert_array_equal(g[c], w[c])
        pids = rng.integers(0, 8, 5000)
        for got, want in zip(tspill._partition_indices(pids, 8),
                             jspill._partition_indices(pids, 8)):
            np.testing.assert_array_equal(got, want)
