"""Host-level shuffle flows of the port against the reference's
(tests/test_shuffle_flows.py's cases, less the one over TCP sockets,
which waits for the socket fabric).

Both lineitem and part are row-sharded over three data nodes, nothing
replicated: a join co-partitions both sides by hash of the join key
(distsql/shuffle.py) and a GROUP BY under ``prefer_shuffle`` runs two
exchange stages. The port's rows are held against the reference's
gateway over reference nodes on the same arrays and against one
reference engine (DECIMAL/FLOAT8 within rel 1e-9, the rest exact).
``_hash_col`` and ``partition_buckets`` are held bit for bit against
the reference's on seeded arrays with NULLs, strings of mixed widths and
negative ints, so rows route to the same nodes as the reference's.
"""

import numpy as np
import pytest

from cockroach_tpu_torch.distsql import shuffle as shfl
from cockroach_tpu_torch.distsql.node import DistSQLNode, Gateway
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.kvserver.transport import LocalTransport
from cockroach_tpu_torch.models import tpch
from tests.test_torch_distsql_flows import (TPCH_DDL, assert_rows_close,
                                            build_fabric, oracle_engine,
                                            port_engine, reference)

ROWS = 3000

JOIN_ROWS = ("SELECT l_orderkey, p_name FROM lineitem "
             "JOIN part ON l_partkey = p_partkey "
             "WHERE l_quantity < 3 ORDER BY l_orderkey, p_name LIMIT 20")
JOIN_AGG = ("SELECT p_brand, count(*), sum(l_quantity) FROM lineitem "
            "JOIN part ON l_partkey = p_partkey "
            "GROUP BY p_brand ORDER BY p_brand")
GROUP_INT = ("SELECT l_linenumber, count(*), avg(l_extendedprice) "
             "FROM lineitem GROUP BY l_linenumber ORDER BY l_linenumber")
SHARDED = {"q14": tpch.Q14, "join_rows": JOIN_ROWS, "join_agg": JOIN_AGG}
SHUFFLED = {"q1": tpch.Q1, "group_int": GROUP_INT}

FACT_DDL = "CREATE TABLE fact (f_id INT PRIMARY KEY, f_key INT, f_val INT)"
DIM_DDL = "CREATE TABLE dim (d_id INT PRIMARY KEY, d_key INT, d_val INT)"
DUP_Q = "SELECT count(*), sum(d_val) FROM fact JOIN dim ON f_key = d_key"


def _tables():
    return {"lineitem": tpch.gen_lineitem(0.01, rows=ROWS),
            "part": tpch.gen_part(0.01)}


def _dup_tables():
    n_f, n_d = 40, 30
    return {"fact": {"f_id": np.arange(n_f), "f_key": np.arange(n_f) % 10,
                     "f_val": np.arange(n_f) * 7},
            "dim": {"d_id": np.arange(n_d), "d_key": np.arange(n_d) % 10,
                    "d_val": np.arange(n_d) * 11}}


@pytest.fixture(scope="module")
def ref_rows():
    tabs, dup = _tables(), _dup_tables()
    with reference() as (jeng, jnode, jtr, _jt):
        def mk(_i):
            return jeng.Engine()
        gw, nodes, _e, _t = build_fabric(jnode, jtr, mk, TPCH_DDL, tabs)
        gw2 = jnode.Gateway(nodes[0], [1, 2, 3], prefer_shuffle=True)
        one = oracle_engine(mk, TPCH_DDL, tabs)
        out = {k: (gw.run(q).rows, one.execute(q).rows)
               for k, q in SHARDED.items()}
        out.update({k: (gw2.run(q).rows, one.execute(q).rows)
                    for k, q in SHUFFLED.items()})
        out["q1_names"] = list(one.execute(tpch.Q1).names)
        dgw, _n, _e, _t = build_fabric(jnode, jtr, mk, [FACT_DDL, DIM_DDL],
                                       dup, n_data=2)
        out["dup"] = (dgw.run(DUP_Q).rows,
                      oracle_engine(mk, [FACT_DDL, DIM_DDL], dup)
                      .execute(DUP_Q).rows)
    return out


@pytest.fixture(scope="module")
def sharded():
    import cockroach_tpu_torch.distsql.node as pnode
    import cockroach_tpu_torch.kvserver.transport as ptr
    gw, nodes, engines, _t = build_fabric(pnode, ptr, port_engine,
                                          TPCH_DDL, _tables())
    return gw, nodes, engines


def _graph_flows(engines) -> float:
    return sum(m.value() for e in engines
               if (m := e.metrics.get("distsql.flows.graph")) is not None)


class TestShardedJoin:
    @pytest.mark.parametrize("name", ["q14", "join_rows", "join_agg"])
    def test_sharded_both_sides(self, sharded, ref_rows, name):
        """Q14 (LIKE over the build side pushed below the exchange), a
        row join carrying a string payload through the exchange, and an
        aggregate above the join: rows equal the reference's."""
        gw, _nodes, engines = sharded
        before = _graph_flows(engines)
        got = gw.run(SHARDED[name])
        assert_rows_close(got.rows, ref_rows[name][0])
        assert_rows_close(got.rows, ref_rows[name][1])
        assert _graph_flows(engines) == before + 1

    def test_graph_flow_ran(self, sharded):
        """The statements above took the multi-stage path on every
        data node."""
        gw, nodes, _e = sharded
        gw.run(tpch.Q14)
        assert all(n.flows_run > 0 for n in nodes[1:])
        assert all(not n.registry._inboxes for n in nodes)


class TestShuffleGroupBy:
    def test_groupby_two_exchange_stages(self, sharded, ref_rows):
        gw, nodes, _e = sharded
        gw2 = Gateway(nodes[0], [1, 2, 3], prefer_shuffle=True)
        got = gw2.run(tpch.Q1)
        assert list(got.names) == ref_rows["q1_names"]
        assert_rows_close(got.rows, ref_rows["q1"][0])
        assert_rows_close(got.rows, ref_rows["q1"][1])

    def test_groupby_int_keys(self, sharded, ref_rows):
        gw, nodes, _e = sharded
        gw2 = Gateway(nodes[0], [1, 2, 3], prefer_shuffle=True)
        got = gw2.run(GROUP_INT)
        assert_rows_close(got.rows, ref_rows["group_int"][0])
        assert_rows_close(got.rows, ref_rows["group_int"][1])


class TestPartitionHash:
    def test_deterministic_and_total(self):
        rng = np.random.default_rng(0)
        cols = {"k": rng.integers(0, 50, 1000),
                "s": np.array([f"v{i % 7}" for i in range(1000)],
                              dtype="S")}
        valid = {"k": rng.random(1000) < 0.9,
                 "s": np.ones(1000, dtype=bool)}
        b1 = shfl.partition_buckets(cols, valid, ["k", "s"], 3)
        b2 = shfl.partition_buckets(
            {k: v.copy() for k, v in cols.items()},
            {k: v.copy() for k, v in valid.items()}, ["k", "s"], 3)
        np.testing.assert_array_equal(b1, b2)
        assert set(np.unique(b1)) <= {0, 1, 2}

    def test_equal_keys_same_bucket_across_splits(self):
        ks = np.arange(100, dtype=np.int64) % 13
        valid = np.ones(100, dtype=bool)
        all_b = shfl.partition_buckets({"k": ks}, {"k": valid}, ["k"], 4)
        half_b = shfl.partition_buckets({"k": ks[50:]},
                                        {"k": valid[50:]}, ["k"], 4)
        np.testing.assert_array_equal(all_b[50:], half_b)

    def test_null_keys_single_bucket(self):
        ks = np.arange(64, dtype=np.int64)
        valid = np.zeros(64, dtype=bool)
        b = shfl.partition_buckets({"k": ks}, {"k": valid}, ["k"], 8)
        assert len(set(b.tolist())) == 1

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_hash_and_buckets_equal_the_references(self, seed):
        """Bit for bit against the reference's _hash_col and
        partition_buckets: NULLs, strings of mixed widths (and the same
        string at two batch widths), negative and extreme ints, -0.0,
        NaN, for 1 to 7 buckets."""
        from cockroach_tpu.distsql import shuffle as jshfl
        rng = np.random.default_rng(seed)
        n = 500
        words = np.array(["", "a", "ab", "abc", "longer string",
                          "x" * 40, "zzz"], dtype=object)
        s = np.array([w.encode("latin1") for w in
                      words[rng.integers(0, len(words), n)]], dtype="S")
        cols = {"i": rng.integers(-(1 << 62), 1 << 62, n),
                "neg": -rng.integers(0, 1000, n).astype(np.int32),
                "f": np.where(rng.random(n) < 0.1, -0.0,
                              rng.normal(size=n)),
                "s": s,
                "u": s.astype(str),
                "b": rng.random(n) < 0.5}
        cols["f"][:3] = [np.nan, 0.0, -0.0]
        valid = {k: rng.random(n) < 0.85 for k in cols}
        for k in cols:
            np.testing.assert_array_equal(
                shfl._hash_col(cols[k], valid[k]),
                jshfl._hash_col(cols[k], valid[k]))
        # the same strings in a batch padded to a wider S dtype
        wide = np.array(list(s) + [b"w" * 64], dtype="S")[:n]
        np.testing.assert_array_equal(
            shfl._hash_col(wide, valid["s"]),
            jshfl._hash_col(s, valid["s"]))
        for keys in (["i"], ["s", "neg"], ["f", "u", "b"], list(cols)):
            for nb in range(1, 8):
                np.testing.assert_array_equal(
                    shfl.partition_buckets(cols, valid, keys, nb),
                    jshfl.partition_buckets(cols, valid, keys, nb))


class TestDuplicateBuildKeys:
    def test_expand_measured_from_exchange_data(self, ref_rows):
        """A build side with 3 rows per key arriving on an exchange: the
        receiving node measures the multiplicity and expands."""
        import cockroach_tpu_torch.distsql.node as pnode
        import cockroach_tpu_torch.kvserver.transport as ptr
        gw, _n, _e, _t = build_fabric(pnode, ptr, port_engine,
                                      [FACT_DDL, DIM_DDL], _dup_tables(),
                                      n_data=2)
        got = gw.run(DUP_Q)
        assert_rows_close(got.rows, ref_rows["dup"][0])
        assert_rows_close(got.rows, ref_rows["dup"][1])


def test_graph_flow_leaves_no_inbox():
    """A graph flow of a GROUP BY and of a join leaves no inbox in any
    node's registry and no producer credit state."""
    transport = LocalTransport()
    nodes = []
    li = tpch.gen_lineitem(0.01, rows=600)
    part = tpch.gen_part(0.01)
    for i in range(3):
        e = Engine(device="cpu")
        for ddl in TPCH_DDL:
            e.execute(ddl)
        if i:
            lo, hi = (i - 1) * 300, i * 300
            e.store.insert_columns("lineitem",
                                   {k: v[lo:hi] for k, v in li.items()},
                                   e.clock.now())
            np_ = len(part["p_partkey"])
            plo, phi = (i - 1) * np_ // 2, i * np_ // 2
            e.store.insert_columns("part",
                                   {k: v[plo:phi] for k, v in part.items()},
                                   e.clock.now())
        nodes.append(DistSQLNode(i, e, transport))
    gw = Gateway(nodes[0], [1, 2], prefer_shuffle=True)
    gw.run(GROUP_INT)
    gw.run(tpch.Q14)
    for n in nodes:
        assert not n.registry._inboxes
        assert not n.acks and not n._producing and not n._graphs
