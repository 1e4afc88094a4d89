"""Adaptive partial aggregation of the port's flows against the
reference's (tests/test_adaptive_agg.py's cases).

Each data node checks, at flow setup, whether the partial-aggregate
stage reduces its shard: when the estimated group count approaches the
shard's row count it ships raw source rows, and the gateway folds them
through the same combine-exact aggregate (distsql/physical.py
raw_merge). The port's rows with the adaptive stage on and off are held
against each other, against the reference's gateway over reference
nodes on the same shards and against one reference engine, all exactly
(every eligible aggregate here is an integer one).
"""

import numpy as np
import pytest

import cockroach_tpu_torch.distsql.node as pnode
import cockroach_tpu_torch.kvserver.transport as ptr
from cockroach_tpu_torch.distsql import physical
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.sql import parser
from cockroach_tpu_torch.sql.planner import Planner
from tests.test_torch_distsql_flows import reference

ROWS = 1500
DDL = ("CREATE TABLE t (id INT PRIMARY KEY, k INT, s STRING, "
       "v INT, f FLOAT)")
HIGH = (10_0003, 10_0003, 10_0003)
MIXED = (5, 10_0003, 10_0003)
LOW = (7, 7, 7)
FUZZ_SEED = 7
AGGSETS = ["count(*), sum(v)", "min(v), max(id)",
           "sum(id), count(*), max(v)"]

QUERIES = [
    ("SELECT k, count(*), sum(v), min(v), max(v) FROM t GROUP BY k "
     "ORDER BY k LIMIT 60"),
    "SELECT s, count(*), sum(v) FROM t GROUP BY s ORDER BY s LIMIT 60",
    "SELECT k, min(id), max(id) FROM t GROUP BY k ORDER BY k LIMIT 40",
]


def _cols(ids: np.ndarray, keyspace: int) -> dict:
    return {
        "id": ids.astype(np.int64),
        "k": (ids * 7919 % keyspace).astype(np.int64),
        "s": np.array([f"u{j * 13 % keyspace}" for j in ids]),
        "v": (ids % 97).astype(np.int64),
        "f": (ids % 97).astype(np.float64) / 7.0,
    }


def _fuzz_cases():
    rng = np.random.default_rng(FUZZ_SEED)
    out = []
    for trial in range(3):
        ks = tuple(int(rng.choice([3, 40, 9973, 10_0003]))
                   for _ in range(3))
        q = (f"SELECT k, {AGGSETS[trial]} FROM t GROUP BY k "
             "ORDER BY k LIMIT 50")
        out.append((ks, q))
    return out


def _build(node_mod, transport_mod, make_engine, adaptive, keyspaces):
    """3 data nodes and a gateway; each shard's group-key cardinality
    is set by its keyspace (small keyspace -> few groups -> partials)."""
    transport = transport_mod.LocalTransport()
    nodes, engines = [], []
    for i in range(4):
        eng = make_engine()
        eng.execute(DDL)
        if i > 0:
            lo, hi = (i - 1) * ROWS // 3, i * ROWS // 3
            eng.store.insert_columns(
                "t", _cols(np.arange(lo, hi), keyspaces[i - 1]),
                eng.clock.now())
        engines.append(eng)
        nodes.append(node_mod.DistSQLNode(i, eng, transport))
    gw = node_mod.Gateway(nodes[0], [1, 2, 3], adaptive_agg=adaptive)
    return gw, engines


def _oracle(make_engine, keyspaces):
    eng = make_engine()
    eng.execute(DDL)
    for i, ks in enumerate(keyspaces):
        lo, hi = i * ROWS // 3, (i + 1) * ROWS // 3
        eng.store.insert_columns("t", _cols(np.arange(lo, hi), ks),
                                 eng.clock.now())
    return eng


def _port(adaptive, keyspaces=HIGH):
    return _build(pnode, ptr, lambda: Engine(device="cpu"), adaptive,
                  keyspaces)


def _msum(engines, name) -> float:
    return sum(m.value() for e in engines
               if (m := e.metrics.get(name)) is not None)


@pytest.fixture(scope="module")
def ref():
    """The reference's rows: its adaptive gateway and one engine, per
    (keyspaces, query) the cases below run."""
    out = {}
    with reference() as (jeng, jnode, jtr, _jt):
        def run(ks, qs):
            gw, _e = _build(jnode, jtr, jeng.Engine, True, ks)
            one = _oracle(jeng.Engine, ks)
            for q in qs:
                out[(ks, q)] = (gw.run(q).rows, one.execute(q).rows)
        run(HIGH, QUERIES)
        run(MIXED, QUERIES[:1])
        run(LOW, QUERIES[:1])
        for ks, q in _fuzz_cases():
            run(ks, [q])
    return out


def _against_ref(got, ref, ks, q):
    ref_gw, ref_one = ref[(ks, q)]
    assert got == ref_gw
    assert got == ref_one


class TestParity:
    @pytest.mark.parametrize("qi", range(len(QUERIES)))
    def test_bit_identical_and_ships_raw(self, ref, qi):
        q = QUERIES[qi]
        gw_on, e_on = _port(True)
        gw_off, e_off = _port(False)
        got_on = gw_on.run(q)
        got_off = gw_off.run(q)
        assert got_on.rows == got_off.rows
        _against_ref(got_on.rows, ref, HIGH, q)
        # near-unique keys: every shard flips, the gateway folds once
        assert _msum(e_on, "exec.agg.adaptive.ship_raw") == 3
        assert _msum(e_on, "distsql.agg.raw_folds") == 1
        assert _msum(e_off, "exec.agg.adaptive.ship_raw") == 0

    def test_mixed_shards_fold_both_forms(self, ref):
        gw_on, e_on = _port(True, MIXED)
        gw_off, _ = _port(False, MIXED)
        q = QUERIES[0]
        got = gw_on.run(q).rows
        assert got == gw_off.run(q).rows
        _against_ref(got, ref, MIXED, q)
        assert _msum(e_on, "exec.agg.adaptive.partial") == 1
        assert _msum(e_on, "exec.agg.adaptive.ship_raw") == 2
        assert _msum(e_on, "distsql.agg.raw_folds") == 1

    def test_low_cardinality_keeps_partials(self, ref):
        gw_on, e_on = _port(True, LOW)
        q = QUERIES[0]
        _against_ref(gw_on.run(q).rows, ref, LOW, q)
        assert _msum(e_on, "exec.agg.adaptive.partial") == 3
        assert _msum(e_on, "exec.agg.adaptive.ship_raw") == 0

    def test_fuzzed_parity(self, ref):
        for ks, q in _fuzz_cases():
            gw_on, _ = _port(True, ks)
            gw_off, _ = _port(False, ks)
            got = gw_on.run(q).rows
            assert got == gw_off.run(q).rows, (ks, q)
            _against_ref(got, ref, ks, q)


class TestBytesMoved:
    def test_high_cardinality_ships_fewer_bytes(self):
        q = QUERIES[0]
        gw_on, e_on = _port(True)
        gw_off, e_off = _port(False)
        assert gw_on.run(q).rows == gw_off.run(q).rows
        sent_on = _msum(e_on, "shuffle.bytes.sent")
        sent_off = _msum(e_off, "shuffle.bytes.sent")
        assert sent_on < sent_off, (sent_on, sent_off)


class TestEligibility:
    def _stage(self, sql: str):
        eng = Engine(device="cpu")
        eng.execute(DDL)
        node, _ = Planner(eng.catalog_view(int_ranges=False),
                          use_memo=False).plan_select(parser.parse(sql))
        return physical.split(node)

    def test_float_sum_not_eligible(self):
        st = self._stage("SELECT k, sum(f) FROM t GROUP BY k")
        assert st.stage == "partial_agg" and st.raw_local is None

    def test_avg_not_eligible(self):
        st = self._stage("SELECT k, avg(v) FROM t GROUP BY k")
        assert st.stage == "partial_agg" and st.raw_local is None

    def test_int_aggs_eligible(self):
        st = self._stage(
            "SELECT s, count(*), sum(v), min(v) FROM t GROUP BY s")
        assert st.raw_local is not None
        assert st.raw_columns == ["t.s", "t.v"]
        assert "t.s" in st.raw_strings
        assert st.raw_merge is not None

    def test_dict_code_hazard_blocks_raw(self):
        st = self._stage("SELECT k, min(s) FROM t GROUP BY k")
        if st.stage == "partial_agg":
            assert st.raw_local is None

    def test_combine_exact_unit(self):
        from cockroach_tpu_torch.sql.bound import BCol, BoundAgg
        from cockroach_tpu_torch.sql.types import FLOAT8, INT8
        ok = [BoundAgg("count_rows", None, INT8),
              BoundAgg("sum_int", BCol("x", INT8), INT8),
              BoundAgg("min", BCol("x", INT8), INT8)]
        assert physical.combine_exact(ok)
        assert not physical.combine_exact(
            ok + [BoundAgg("sum", BCol("y", FLOAT8), FLOAT8)])
        assert not physical.combine_exact(
            [BoundAgg("avg", BCol("x", INT8), INT8)])

    def test_avg_splits_exactly(self):
        """The port's AVG over INT splits into an exact SUM and a COUNT
        (the reference sums FLOAT8 casts): the local stage stays in
        kernel 1's exact envelope."""
        st = self._stage("SELECT k, avg(v) FROM t GROUP BY k")
        assert [a.func for a in st.local.aggs] == ["sum_int", "count"]
        st = self._stage("SELECT k, avg(f) FROM t GROUP BY k")
        assert [a.func for a in st.local.aggs] == ["sum", "count"]
        assert st.local.aggs[0].type.family.name == "FLOAT"
