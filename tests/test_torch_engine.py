"""TPC-H Q1, Q6 and Q14 through the port's Engine against the JAX Engine.

The reference Engine (cockroach_tpu) loads a 50K-row TPC-H slice
(lineitem and part) and a small ``px`` table of STRING, FLOAT, DECIMAL
and INT columns, and runs Q1, Q6 and Q14 under ``pallas_groupagg =
auto`` and ``off``, Q1 and the FLOAT8 variants Q1F and Q6F under
``on``, and the ``px`` queries of tests/test_pallas_kernels.py under
``on`` and ``off``. Its store is then read out into numpy arrays
(schema DDL, physical columns, validity, MVCC bounds, dictionaries) and
carried into the port's ``Engine(device="cpu")`` through
``store_from_arrays``, so both engines scan the same row versions. Rows
must be equal, floats within rel 1e-12 (float64 sums in different
orders), except where a kernel accumulates in f32 (``on`` over FLOAT
arguments): there within rel 1e-5, counts exact. Each test also checks
that both engines routed the query to the kernel it names (the port's
kernel wrappers take their plain versions on the CPU and count them).

The reference runs inside ``reference_modules`` (from
test_torch_groupagg_large), which lets its Pallas modules import under
newer jax releases and unloads them afterwards.
"""

import numpy as np
import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.exec.session import EngineError
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.ops.cuda import groupagg as tg
from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from tests.test_torch_groupagg_large import reference_modules

ROWS = 50_000
MODES = ("auto", "off")


def _store_arrays(store, ddl: dict) -> dict:
    """A reference ColumnStore as the numpy arrays store_from_arrays
    takes."""
    out = {}
    for name, td in store.tables.items():
        chunks = td.chunks
        cols = [c.name for c in td.schema.columns]
        out[name] = {
            "ddl": ddl[name],
            "columns": {c: np.concatenate([k.data[c] for k in chunks])
                        for c in cols},
            "valid": {c: np.concatenate([k.valid[c] for k in chunks])
                      for c in cols},
            "mvcc_ts": np.concatenate([k.mvcc_ts for k in chunks]),
            "mvcc_del": np.concatenate([k.mvcc_del for k in chunks]),
            "dictionaries": {c: list(d.values)
                             for c, d in td.dictionaries.items()},
        }
    return out


PX_DDL = "CREATE TABLE px (g STRING, f FLOAT, d DECIMAL(10,2), i INT)"

# the px queries of tests/test_pallas_kernels.py, plus INT and DECIMAL
# MIN/MAX (the large-G kernel's high-limb path under `on`)
PX = {
    # small-G kernel under `on`
    "float": ("SELECT g, count(*) AS c, sum(f) AS s, avg(f) AS a, "
              "min(f) AS lo, max(f) AS hi FROM px GROUP BY g ORDER BY g"),
    # no count(*): liveness needs a COUNT slot of its own (group k9's
    # every f is NULL, so its sum's paired count is 0)
    "null_group": "SELECT g, sum(f) AS s FROM px GROUP BY g ORDER BY g",
    "ungrouped": ("SELECT count(*) AS c, avg(f) AS a, min(f) AS lo, "
                  "max(f) AS hi FROM px WHERE i >= 0"),
    # large-G kernel under `on`: exact, equal to `off`
    "decimal": "SELECT g, sum(d) AS s FROM px GROUP BY g ORDER BY g",
    "int_minmax": ("SELECT g, min(i) AS lo, max(i) AS hi, min(d) AS dlo, "
                   "max(d) AS dhi FROM px GROUP BY g ORDER BY g"),
}
PX_SMALL = ("float", "null_group", "ungrouped")
# two aggregate arguments that reach distinct LIKE tables over the same
# dictionary column: INT sums, so `auto` takes the large-G kernel
LIKE_CASE = ("SELECT l_returnflag, "
             "sum(CASE WHEN l_shipmode LIKE '%AIR%' THEN 1 ELSE 0 END) AS a, "
             "sum(CASE WHEN l_shipmode LIKE 'TRUCK%' THEN 1 ELSE 0 END) "
             "AS t, sum(CASE WHEN l_shipmode LIKE '%AIR%' THEN 1 ELSE 0 "
             "END) AS a2 FROM lineitem GROUP BY l_returnflag "
             "ORDER BY l_returnflag")
# a group whose FLOAT argument is NULL in every row
PX_NULL_GROUP = ("INSERT INTO px VALUES ('k9', NULL, 1.00, 5), "
                 "('k9', NULL, 2.50, NULL), ('k9', NULL, 4.00, 7)")


def _px_insert(rng) -> str:
    vals = []
    for _ in range(200):
        f = "NULL" if rng.random() < 0.05 else \
            f"{float(rng.normal() * 10):.6f}"
        i = "NULL" if rng.random() < 0.05 else \
            str(int(rng.integers(-(1 << 50), 1 << 50)))
        vals.append(f"('k{int(rng.integers(0, 3))}', {f}, "
                    f"{float(rng.random() * 100):.2f}, {i})")
    return "INSERT INTO px VALUES " + ", ".join(vals)


@pytest.fixture(scope="module")
def reference():
    """The reference's rows per (query, mode), its kernel builds per
    (query, mode), and its store as arrays."""
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch",
                           "cockroach_tpu.ops.pallas.groupagg") as (
            jeng, jtpch, jpg):
        e = jeng.Engine()
        try:
            jtpch.load(e, sf=0.01, rows=ROWS)
            e.execute(PX_DDL)
            e.execute(_px_insert(np.random.default_rng(3)))
            e.execute(PX_NULL_GROUP)
            runs = [(q, m, sql) for q, sql in
                    (("q1", jtpch.Q1), ("q6", jtpch.Q6),
                     ("q14", jtpch.Q14)) for m in MODES]
            runs += [("q1", "on", jtpch.Q1), ("q1f", "on", tpch.Q1F),
                     ("q6f", "on", tpch.Q6F), ("like_case", "auto",
                                               LIKE_CASE)]
            runs += [(f"px_{q}", m, sql) for q, sql in PX.items()
                     for m in ("on", "off")]
            out = {}
            for q, mode, sql in runs:
                s = e.session()
                s.vars.set("distsql", "off")
                s.vars.set("pallas_groupagg", mode)
                b0 = {k: jpg.BUILDS.value(k) for k in ("small", "large")}
                rows = e.execute(sql, session=s).rows
                out[q, mode] = {
                    "rows": rows,
                    **{f"{k}_builds": jpg.BUILDS.value(k) - b0[k]
                       for k in b0}}
            arrays = _store_arrays(e.store, {**jtpch.DDL, "px": PX_DDL})
        finally:
            e.close()
    return out, arrays


@pytest.fixture(scope="module")
def port(reference):
    _, arrays = reference
    return Engine(device="cpu", store=store_from_arrays(arrays))


def _run(eng, sql, mode):
    s = eng.session()
    eng.execute(f"SET pallas_groupagg = {mode}", s)
    return eng.execute(sql, s).rows


def _assert_rows_equal(got, want, rel=1e-12):
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row)
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=rel), (g_row, w_row)
            else:
                assert g == w, (g_row, w_row)


def test_carried_store_matches(reference, port):
    _, arrays = reference
    for name, t in arrays.items():
        td = port.store.table(name)
        assert td.row_count == len(t["mvcc_ts"])
        for c, d in t["dictionaries"].items():
            assert td.dictionaries[c].values == d


@pytest.mark.parametrize("mode", MODES)
def test_q6_matches_reference(reference, port, mode):
    ref, _ = reference
    _assert_rows_equal(_run(port, tpch.Q6, mode), ref["q6", mode]["rows"])


@pytest.mark.parametrize("mode", MODES)
def test_q1_matches_reference(reference, port, mode):
    ref, _ = reference
    before = tgl.PLAIN_CALLS
    got = _run(port, tpch.Q1, mode)
    _assert_rows_equal(got, ref["q1", mode]["rows"])
    assert len(got) == 4
    if mode == "auto":
        # both engines routed Q1's dense GROUP BY to their kernel
        assert tgl.PLAIN_CALLS == before + 1
        assert ref["q1", mode]["large_builds"] >= 1
    else:
        assert tgl.PLAIN_CALLS == before
        assert ref["q1", mode]["large_builds"] == 0


def test_q1_off_keeps_exact_sums_and_counts(port):
    # DECIMAL sums and counts are exact on both paths; only the float
    # averages may differ in the last bits
    auto, off = (_run(port, tpch.Q1, m) for m in MODES)
    for a, o in zip(auto, off):
        assert a[:6] == o[:6] and a[9] == o[9]


def test_q1_q6_match_numpy_oracle(port):
    li = tpch.gen_lineitem(0.01, rows=ROWS)
    assert _run(port, tpch.Q6, "auto")[0][0] == pytest.approx(
        tpch.ref_q6(li), rel=1e-9)
    got = _run(port, tpch.Q1, "auto")
    want = tpch.ref_q1(li)
    assert len(got) == len(want)
    for g_row, w_row in zip(got, want):
        assert g_row[:2] == w_row[:2]
        for g, w in zip(g_row[2:], w_row[2:]):
            assert g == pytest.approx(w, rel=1e-6)


def test_set_pallas_groupagg_on_is_not_ported(port):
    # `on` is ported now: SET accepts it, and only the three modes
    with pytest.raises(EngineError, match="auto, on or off"):
        port.execute("SET pallas_groupagg = always")
    s = port.session()
    port.execute("SET pallas_groupagg = on", s)
    assert s.vars.get("pallas_groupagg") == "on"


@pytest.mark.parametrize("mode", MODES)
def test_q14_matches_reference(reference, port, mode):
    ref, _ = reference
    got = _run(port, tpch.Q14, mode)
    _assert_rows_equal(got, ref["q14", mode]["rows"])
    li = tpch.gen_lineitem(0.01, rows=ROWS)
    assert got[0][0] == pytest.approx(
        tpch.ref_q14(li, tpch.gen_part(0.01)), rel=1e-9)


def test_q14_direct_and_hash_paths_agree(port):
    # the engine direct-addresses Q14's join on p_partkey; with that
    # decision taken away the hash-table path must give the same answer
    from cockroach_tpu_torch.exec import engine as E
    from cockroach_tpu_torch.ops import hashtable
    want = _run(port, tpch.Q14, "auto")
    orig = E.Engine._maybe_direct_join
    orig_build = hashtable.build
    rounds = []

    def build(*args, **kwargs):
        out = orig_build(*args, **kwargs)
        rounds.append(out[3])
        return out
    E.Engine._maybe_direct_join = lambda self, join, b, stored: None
    hashtable.build = build
    try:
        got = _run(port, tpch.Q14, "auto")
    finally:
        E.Engine._maybe_direct_join = orig
        hashtable.build = orig_build
    assert rounds and max(rounds) >= 1
    _assert_rows_equal(got, want)


@pytest.mark.parametrize("query", ["q1f", "q6f"])
def test_float_queries_on_small_kernel(reference, port, query):
    ref, _ = reference
    sql = tpch.Q1F if query == "q1f" else tpch.Q6F
    before = tg.PLAIN_CALLS
    got = _run(port, sql, "on")
    assert tg.PLAIN_CALLS == before + 1
    assert ref[query, "on"]["small_builds"] >= 1
    # f32 accumulation: counts exact, sums and averages within rel 1e-5
    _assert_rows_equal(got, ref[query, "on"]["rows"], rel=1e-5)
    li = tpch.gen_lineitem(0.01, rows=ROWS)
    if query == "q6f":
        assert got[0][0] == pytest.approx(tpch.ref_q6(li), rel=1e-5)
    else:
        _assert_rows_equal(got, tpch.ref_q1(li), rel=1e-5)


def test_q1_on_equals_auto(reference, port):
    ref, _ = reference
    before = (tg.PLAIN_CALLS, tgl.PLAIN_CALLS)
    on = _run(port, tpch.Q1, "on")
    # DECIMAL aggregates stay off the small kernel, on the large one
    assert (tg.PLAIN_CALLS, tgl.PLAIN_CALLS) == (before[0], before[1] + 1)
    assert on == _run(port, tpch.Q1, "auto")
    _assert_rows_equal(on, ref["q1", "on"]["rows"])
    assert ref["q1", "on"]["small_builds"] == 0


@pytest.mark.parametrize("query", list(PX))
def test_px_queries(reference, port, query):
    ref, _ = reference
    sql = PX[query]
    before = (tg.PLAIN_CALLS, tgl.PLAIN_CALLS)
    on = _run(port, sql, "on")
    small = query in PX_SMALL
    assert (tg.PLAIN_CALLS - before[0], tgl.PLAIN_CALLS - before[1]) == \
        ((1, 0) if small else (0, 1))
    assert ref[f"px_{query}", "on"]["small_builds" if small
                                    else "large_builds"] >= 1
    off = _run(port, sql, "off")
    _assert_rows_equal(off, ref[f"px_{query}", "off"]["rows"])
    if small:
        _assert_rows_equal(on, ref[f"px_{query}", "on"]["rows"], rel=1e-5)
        _assert_rows_equal(on, off, rel=1e-5)
    else:
        # exact paths: bit-equal to `off`, and equal to the reference
        assert on == off
        _assert_rows_equal(on, ref[f"px_{query}", "on"]["rows"])


def test_like_case_sums_on_one_dictionary_column(reference, port):
    # distinct LIKE tables over l_shipmode side by side reach the
    # large-G kernel under `auto`; the repeated argument is folded
    ref, _ = reference
    before = tgl.PLAIN_CALLS
    got = _run(port, LIKE_CASE, "auto")
    assert tgl.PLAIN_CALLS == before + 1
    assert ref["like_case", "auto"]["large_builds"] >= 1
    _assert_rows_equal(got, ref["like_case", "auto"]["rows"])
    assert all(r[1] == r[3] and r[1] > 0 and r[2] > 0 for r in got)
    assert got == _run(port, LIKE_CASE, "off")


def test_duplicate_build_keys_raise_cleanly():
    # duplicate build keys expand the join K ways, up to the reference's
    # limit of 32, and up to 64 for a small probe side (TPC-H Q13 at
    # SF1 needs about 36); past that the join is refused with the
    # reference's message, whichever side the planner builds on (both
    # repeat their keys 65 times or more)
    e = Engine(device="cpu")
    e.execute("CREATE TABLE a (x INT8 NOT NULL, y INT8 NOT NULL)")
    e.execute("CREATE TABLE b (x INT8 NOT NULL, z INT8 NOT NULL)")
    ts = e.clock.now()
    e.store.insert_columns("a", {"x": np.arange(160) % 2,
                                 "y": np.arange(160)}, ts)
    e.store.insert_columns("b", {"x": np.arange(130) % 2,
                                 "z": np.arange(130)}, ts)
    with pytest.raises(EngineError, match=r"duplicate rows per key .*"
                       r"\(limit 32, or 64 .*\); make the lower-"
                       "multiplicity table the build side"):
        e.execute("SELECT sum(y) AS s, sum(z) AS t FROM a, b "
                  "WHERE a.x = b.x")


def test_wide_expansion_refused_past_the_row_bound(monkeypatch):
    # K between 33 and 64 is accepted only while the probe side's padded
    # rows times K stay within MAX_WIDE_EXPANDED_ROWS (8192 here): 40
    # orders per customer over 100 customers (128 padded rows, 5,120
    # expanded) run, over 300 customers (512 padded, 20,480) are refused;
    # padded rows follow the shape ladder, here from 128 rows
    monkeypatch.setattr(Engine, "MAX_WIDE_EXPANDED_ROWS", 1 << 13)
    e = Engine(device="cpu")
    e.settings.set("sql.exec.shape_bucket.min_rows", 128)
    e.execute("CREATE TABLE small (ck INT8 NOT NULL)")
    e.execute("CREATE TABLE big (ck INT8 NOT NULL)")
    e.execute("CREATE TABLE o (ok INT8 NOT NULL, ock INT8 NOT NULL)")
    ts = e.clock.now()
    e.store.insert_columns("small", {"ck": np.arange(1, 101)}, ts)
    e.store.insert_columns("big", {"ck": np.arange(1, 301)}, ts)
    ock = np.repeat(np.arange(1, 41), 40)
    e.store.insert_columns("o", {"ok": np.arange(len(ock)), "ock": ock}, ts)
    for t in ("small", "big", "o"):
        e.execute(f"ANALYZE {t}")
    sql = ("SELECT count(*) AS n, count(ok) AS m FROM {} "
           "LEFT JOIN o ON ck = ock")
    assert e.execute(sql.format("small")).rows == [(40 * 40 + 60,
                                                    40 * 40)]
    assert e.last_exec["all"]["expansions"] == [40]
    with pytest.raises(EngineError, match=r"has up to 40 duplicate rows "
                       r"per key .*\(limit 32, or 64 while the expanded "
                       r"rows stay within 8192\); make the lower-"
                       "multiplicity table the build side"):
        e.execute(sql.format("big"))


def test_engine_roundtrip_from_sql():
    # CREATE TABLE, bulk ingest, ANALYZE and a dense GROUP BY on the
    # port alone, past the kernel's 4096-row threshold
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (k STRING NOT NULL, v DECIMAL(10,2), "
              "q INT8 NOT NULL)")
    n = 5000
    rng = np.random.default_rng(3)
    k = rng.choice(["x", "y", "z"], size=n).astype(object)
    v = np.round(rng.uniform(-100, 100, size=n), 2)
    q = rng.integers(-10**12, 10**12, size=n)
    valid = {"v": rng.random(n) < 0.9}
    e.store.insert_columns("t", {"k": k, "v": v, "q": q}, e.clock.now(),
                           valid=valid)
    e.execute("ANALYZE t")
    before = tgl.PLAIN_CALLS
    rows = e.execute("SELECT k, sum(v) AS sv, sum(q) AS sq, count(v) AS c,"
                     " count(*) AS n FROM t GROUP BY k ORDER BY k").rows
    assert tgl.PLAIN_CALLS == before + 1
    cents = np.round(v * 100).astype(np.int64)
    for key, sv, sq, c, cnt in rows:
        m = k == key
        mv = m & valid["v"]
        assert sv == pytest.approx(int(cents[mv].sum()) / 100, abs=1e-9)
        assert sq == int(q[m].sum())
        assert c == int(mv.sum()) and cnt == int(m.sum())


def test_group_of_null_arguments_is_live(reference, port, monkeypatch):
    # the small kernel's launch says which groups are live: with no
    # count(*) in the plan it counts one more slot, whose mask is sel
    # itself, and never a SUM's paired count
    ref, _ = reference
    calls = []

    def recording(gid, sel, values, masks, num_groups, ops):
        calls.append((sel, masks, ops))
        return kernel(gid, sel, values, masks, num_groups, ops)

    kernel = tg.dense_group_aggregate
    monkeypatch.setattr(tg, "dense_group_aggregate", recording)
    got = _run(port, PX["null_group"], "on")
    (sel, masks, ops), = calls
    assert ops == (tg.SUM, tg.COUNT, tg.COUNT) and masks[2] is sel
    assert ("k9", None) in got
    _assert_rows_equal(got, ref["px_null_group", "on"]["rows"], rel=1e-5)


def test_q1f_reads_liveness_from_its_kernel(reference, port, monkeypatch):
    # Q1F's count(*) slot gives its groups' liveness: no separate
    # group_count scatter on the small-G path (the plain path has one)
    from cockroach_tpu_torch.ops import agg as aggops
    counted = []
    group_count = aggops.group_count
    monkeypatch.setattr(aggops, "group_count",
                        lambda *a: counted.append(1) or group_count(*a))
    before = tg.PLAIN_CALLS
    on = _run(port, tpch.Q1F, "on")
    assert tg.PLAIN_CALLS == before + 1 and counted == []
    ref, _ = reference
    _assert_rows_equal(on, ref["q1f", "on"]["rows"], rel=1e-5)
    _run(port, tpch.Q1F, "off")
    assert counted


# ---------------------------------------------------------------------------
# faults the port repairs where the reference raises: held to numpy
# oracles (the reference is no oracle for them)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sb_engine():
    """A table of STRING, BOOL and INT columns with NULLs in both."""
    rng = np.random.default_rng(7)
    n = 400
    words = np.array(["apple", "b", "banana", "c", "cherry", "d", "date",
                      "e", "fig", ""], dtype=object)
    s = words[rng.integers(0, len(words), n)]
    sv = rng.random(n) > 0.1
    b = rng.random(n) > 0.5
    bv = rng.random(n) > 0.15
    g = rng.integers(0, 6, n).astype(np.int64)
    eng = Engine(device="cpu")
    eng.execute("CREATE TABLE sb (s STRING, b BOOL, g INT)")
    eng.store.insert_columns("sb", {"s": s, "b": b, "g": g},
                             eng.clock.now(), valid={"s": sv, "b": bv})
    return eng, s, sv, b, bv, g


@pytest.mark.parametrize("lo,hi,negated", [("b", "d", False),
                                           ("banana", "cherry", False),
                                           ("", "c", False),
                                           ("b", "d", True)])
def test_string_between_compares_through_dictionary(sb_engine, lo, hi,
                                                    negated):
    eng, s, sv, _, _, g = sb_engine
    op = "NOT BETWEEN" if negated else "BETWEEN"
    got = eng.execute(f"SELECT g, count(*) AS c FROM sb WHERE s {op} "
                      f"'{lo}' AND '{hi}' GROUP BY g ORDER BY g").rows
    inside = np.array([lo <= x <= hi for x in s])
    keep = sv & (~inside if negated else inside)
    want = [(int(k), int((g[keep] == k).sum()))
            for k in np.unique(g[keep])]
    assert got == want


def test_min_max_over_bool(sb_engine):
    eng, _, _, b, bv, g = sb_engine
    got = eng.execute("SELECT g, min(b) AS lo, max(b) AS hi, "
                      "count(b) AS c FROM sb GROUP BY g ORDER BY g").rows
    want = []
    for k in range(6):
        m = (g == k) & bv
        want.append((k, bool(b[m].min()), bool(b[m].max()), int(m.sum())))
    assert got == want
    assert all(isinstance(r[1], bool) for r in got)
    got = eng.execute("SELECT min(b) AS lo, max(b) AS hi FROM sb "
                      "WHERE g = 2").rows
    m = (g == 2) & bv
    assert got == [(bool(b[m].min()), bool(b[m].max()))]


def test_decorrelated_statement_hits_exec_cache():
    """Decorrelation names its derived tables per statement, so a
    second execute of Q4 (EXISTS) and Q22 (scalar subquery, NOT EXISTS)
    compiles nothing: every plan it runs, the main query's included,
    hits the exec cache, with the same rows."""
    eng = Engine(device="cpu")
    tpch.load(eng, sf=0.01, rows=20_000, tables=tpch.ALL_TABLES)
    s = eng.session()
    for q in (tpch.Q4, tpch.Q22):
        first = eng.execute(q, s).rows
        hits, misses = eng.plan_cache["hit"], eng.plan_cache["miss"]
        again = eng.execute(q, s).rows
        assert again == first
        assert eng.plan_cache["miss"] == misses
        assert eng.plan_cache["hit"] > hits
