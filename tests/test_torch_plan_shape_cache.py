"""The statement-shape plan cache of the port against the JAX package's.

``shape_text`` must give the reference's strings for the 22 TPC-H texts
and for literal variants of them; ``parameterize`` must lift the same
values (numpy scalars of the same dtype) from the plans both engines
bind for the same statements over the same table; ``plan_fingerprint``
must induce the same equal/unequal relation over those plans (the
relation is compared, not the hash values). Through the engines:
literal-varying statements of one shape share one exec-cache entry in
both, the results track the literal (equal to the reference's and to a
session with ``plan_shape_cache = off``), a literal that changes the
plan's shape misses, ``off`` keys by text again, and a ``Prepared``
made before a write misses after it.
"""

import re

import pytest

from cockroach_tpu.exec import planparam as rpp
from cockroach_tpu_torch.exec import planparam as tpp
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.sql import parser
from tests.test_torch_groupagg_large import reference_modules

DDL = ("CREATE TABLE t (k INT PRIMARY KEY, v INT, g INT, "
       "d DECIMAL(10,2), dt DATE, f FLOAT8)")
ROWS = 2500

# statements over t: literal variants of a few shapes, and shapes a
# literal changes (LIMIT, an IN list, a rounding digit)
STATEMENTS = [
    "SELECT g, sum(v) FROM t WHERE v > 10 GROUP BY g ORDER BY g",
    "SELECT g, sum(v) FROM t WHERE v > 77 GROUP BY g ORDER BY g",
    "SELECT g, sum(v) FROM t WHERE v >= 77 GROUP BY g ORDER BY g",
    "SELECT count(*) FROM t WHERE d BETWEEN 1.25 AND 3.50 AND g = 2",
    "SELECT count(*) FROM t WHERE d BETWEEN 0.75 AND 2.00 AND g = 1",
    "SELECT sum(d) FROM t WHERE dt >= date '1995-01-01' "
    "AND dt < date '1995-01-01' + interval '1 year'",
    "SELECT sum(d) FROM t WHERE dt >= date '1996-03-01' "
    "AND dt < date '1996-03-01' + interval '1 year'",
    "SELECT max(f) FROM t WHERE f < 0.5 AND NOT (v = 3)",
    "SELECT max(f) FROM t WHERE f < 0.25 AND NOT (v = 9)",
    "SELECT v FROM t WHERE v > 10 ORDER BY v, k LIMIT 5",
    "SELECT v FROM t WHERE v > 99 ORDER BY v, k LIMIT 5",
    "SELECT v FROM t WHERE v > 10 ORDER BY v, k LIMIT 7",
    "SELECT count(*) FROM t WHERE v IN (1, 2, 3)",
    "SELECT count(*) FROM t WHERE v IN (4, 5, 6)",
    "SELECT g, min(v), max(d) FROM t WHERE round(d, 1) > 1.5 GROUP BY g",
    "SELECT g, min(v), max(d) FROM t WHERE round(d, 2) > 1.5 GROUP BY g",
]


def _insert_sql() -> str:
    vals = ",".join(
        f"({i}, {(i * 13) % 500}, {i % 4}, {(i * 7) % 400 / 100:.2f}, "
        f"date '1994-01-01' + interval '{(i * 3) % 1100} day', "
        f"{((i * 37) % 1000) / 1000})" for i in range(ROWS))
    return f"INSERT INTO t (k, v, g, d, dt, f) VALUES {vals}"


@pytest.fixture(scope="module")
def engines():
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        ref = jeng.Engine()
        port = Engine(device="cpu")
        try:
            for e in (ref, port):
                e.execute(DDL)
                e.execute(_insert_sql())
            yield ref, port
        finally:
            ref.close()
            port.close()


def _ref_misses(ref) -> int:
    c = ref.metrics.get("sql.plan.cache.miss")
    return 0 if c is None else c.value()


def _variant(sql: str) -> str:
    """Every integer literal one larger (quoted ones too)."""
    return re.sub(r"(?<![\w.])(\d+)(?![\w])",
                  lambda m: str(int(m.group(1)) + 1), sql)


@pytest.mark.parametrize("q", sorted(tpch.QUERIES))
def test_shape_text_equals_the_reference(q):
    sql = tpch.QUERIES[q]
    for text in (sql, _variant(sql)):
        assert tpp.shape_text(text) == rpp.shape_text(text)
    assert tpp.shape_text(_variant(sql)) == tpp.shape_text(sql)


def _plans(ref, port):
    out = []
    for sql in STATEMENTS:
        s = port.session()
        pnode, _ = port._plan(parser.parse(sql), s, port._read_ts(s))
        rnode, _ = ref._plan(ref._parse_cached(sql), ref.session())
        out.append((sql, pnode, rnode))
    return out


def test_parameterize_lifts_the_reference_values(engines):
    ref, port = engines
    lifted = 0
    for sql, pnode, rnode in _plans(ref, port):
        _, pv = tpp.parameterize(pnode)
        _, rv = rpp.parameterize(rnode)
        assert (pv is None) == (rv is None), sql
        if pv is None:
            continue
        lifted += 1
        assert [(v.item(), v.dtype) for v in pv] == \
            [(v.item(), v.dtype) for v in rv], sql
        assert tpp.run_values(pv) == tuple(v.item() for v in rv)
    assert lifted >= 10


def test_plan_fingerprint_relation_equals_the_reference(engines):
    ref, port = engines
    pf, rf = [], []
    for _sql, pnode, rnode in _plans(ref, port):
        pf.append(tpp.plan_fingerprint(tpp.parameterize(pnode)[0]))
        rf.append(rpp.plan_fingerprint(rpp.parameterize(rnode)[0]))
    n = len(STATEMENTS)
    rel = [[pf[i] == pf[j] for j in range(n)] for i in range(n)]
    assert rel == [[rf[i] == rf[j] for j in range(n)] for i in range(n)]
    # literal variants share a fingerprint; LIMIT and IN lists do not
    assert pf[0] == pf[1] and pf[0] != pf[2]
    assert pf[9] == pf[10] != pf[11] and pf[12] != pf[13]


def test_literal_variants_share_one_entry_in_both(engines):
    ref, port = engines
    q = "SELECT g, sum(v), count(*) FROM t WHERE v > {} GROUP BY g ORDER BY g"
    rs, ps = ref.session(), port.session()
    assert port.execute(q.format(17), ps).rows == \
        ref.execute(q.format(17), rs).rows
    r0, p0 = _ref_misses(ref), port.plan_cache["miss"]
    for lit in (23, 99, 250, 444):
        assert port.execute(q.format(lit), ps).rows == \
            ref.execute(q.format(lit), rs).rows
    assert _ref_misses(ref) == r0
    assert port.plan_cache["miss"] == p0
    assert port.metrics.get("sql.plan.cache.hit").value() >= 4


def test_results_track_the_literal(engines):
    ref, port = engines
    s, off = port.session(), port.session()
    off.vars.set("plan_shape_cache", "off")
    q = ("SELECT g, count(*), min(v), sum(d) FROM t WHERE v > {} "
         "AND dt < date '{}' GROUP BY g ORDER BY g")
    port.execute(q.format(100, "1995-01-01"), s)
    for lit, day in ((3, "1994-06-01"), (250, "1996-02-29"),
                     (498, "1997-01-01")):
        got = port.execute(q.format(lit, day), s).rows
        assert got == port.execute(q.format(lit, day), off).rows
        assert got == ref.execute(q.format(lit, day)).rows


def test_shape_changing_literal_misses(engines):
    _, port = engines
    s = port.session()
    q = "SELECT v FROM t WHERE v > {} ORDER BY v, k LIMIT {}"
    port.execute(q.format(10, 5), s)
    m0 = port.plan_cache["miss"]
    port.execute(q.format(99, 5), s)   # a literal only: hit
    assert port.plan_cache["miss"] == m0
    port.execute(q.format(10, 7), s)   # the shape changed: miss
    assert port.plan_cache["miss"] == m0 + 1


def test_off_restores_text_keying(engines):
    ref, port = engines
    q = "SELECT max(v) FROM t WHERE v < {}"
    for e in (ref, port):
        s = e.session()
        s.vars.set("plan_shape_cache", "off")
        e.execute(q.format(400), s)
        m0 = _ref_misses(e) if e is ref else e.plan_cache["miss"]
        e.execute(q.format(401), s)
        m1 = _ref_misses(e) if e is ref else e.plan_cache["miss"]
        assert m1 == m0 + 1


def test_prepared_before_a_write_misses_after_it():
    e = Engine(device="cpu")
    e.execute(DDL)
    e.execute(_insert_sql())
    q = "SELECT g, sum(v), max(k) FROM t WHERE v > {} GROUP BY g ORDER BY g"
    p = e.prepare(q.format(50))
    want = p.run().rows
    m0 = e.plan_cache["miss"]
    e.execute(q.format(60))            # another literal: shares the plan
    assert e.plan_cache["miss"] == m0
    e.execute(f"INSERT INTO t (k, v, g) VALUES ({ROWS}, 499, 0)")
    got = p.run().rows
    assert e.plan_cache["miss"] == m0 + 1
    assert got[0][1] == want[0][1] + 499 and got[0][2] == ROWS
    assert got[1:] == want[1:]
    m1 = e.plan_cache["miss"]
    e.execute(q.format(70))            # the new generation's entry: hit
    assert e.plan_cache["miss"] == m1
    e.close()
