"""Data movement on the port's DistSQL flows, against the reference
(tests/test_movement.py's fakedist cases, test_join_skipping.py's
remote-skip and wire-frame cases, test_membership.py's merge_partials
overflow cases), and the hierarchical merge tree against the flat
fan-in.

- Overlapped exchange: the double-buffered send returns the same rows
  as compute-then-ship, and every producer accounts its frame bytes in
  ``exec.movement.exchange.bytes``.
- A squeezed node: its lineitem shard does not fit its budget, so the
  node pages it through the stream tier's pages, rows unchanged.
- Join-induced skipping: the gateway derives a key frame from the
  replicated build side; data nodes drop non-matching chunks host-side.
- merge_partials refuses int64/uint64 sums that would wrap.
"""

import numpy as np
import pytest

import cockroach_tpu_torch.distsql.node as pnode
import cockroach_tpu_torch.kvserver.transport as ptr
from cockroach_tpu_torch.distsql.physical import (MergeUnsupported,
                                                  merge_partials)
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.models import tpch
from tests.test_torch_distsql_flows import (TPCH_DDL, assert_rows_close,
                                            build_fabric, oracle_engine,
                                            port_engine, reference)

ROWS = 6000
SQUEEZED = 2
Q6_COLS = frozenset({"l_quantity", "l_extendedprice", "l_discount",
                     "l_shipdate"})
Q14_PART_COLS = frozenset({"p_partkey", "p_type"})
TREE_Q = ("SELECT l_returnflag, l_linestatus, count(*) AS c, "
          "sum(l_quantity) AS sq, min(l_orderkey) AS mo FROM lineitem "
          "GROUP BY l_returnflag, l_linestatus "
          "ORDER BY l_returnflag, l_linestatus")


def _fuzz_queries(n: int) -> list[str]:
    """Randomized single-table aggregations and row selections (the
    reference's generator and seed)."""
    out = []
    rng = np.random.default_rng(20260805)
    for _ in range(n):
        qty = int(rng.integers(5, 45))
        disc = round(float(rng.uniform(0.01, 0.09)), 2)
        out.append(
            "SELECT l_returnflag, l_linestatus, "
            "sum(l_quantity) AS sq, sum(l_extendedprice) AS se, "
            "count(*) AS c FROM lineitem "
            f"WHERE l_quantity < {qty} AND l_discount >= {disc} "
            "GROUP BY l_returnflag, l_linestatus "
            "ORDER BY l_returnflag, l_linestatus")
        lo = int(rng.integers(1, ROWS))
        out.append(
            "SELECT l_orderkey, l_quantity FROM lineitem "
            f"WHERE l_orderkey >= {lo} "
            "ORDER BY l_orderkey, l_linenumber LIMIT 50")
    return out


def _tables():
    return {"lineitem": tpch.gen_lineitem(0.01, rows=ROWS),
            "part": tpch.gen_part(0.01)}


@pytest.fixture(scope="module")
def ref_rows():
    tabs = _tables()
    qs = _fuzz_queries(2) + [tpch.Q1, tpch.Q6, tpch.Q14, TREE_Q]
    with reference() as (jeng, jnode, jtr, _jt):
        def mk(_i):
            return jeng.Engine()
        gw, _n, _e, _t = build_fabric(jnode, jtr, mk, TPCH_DDL, tabs,
                                      replicated={"part"})
        one = oracle_engine(mk, TPCH_DDL, tabs)
        return {q: (gw.run(q, chunk_rows=97).rows, one.execute(q).rows)
                for q in qs}


@pytest.fixture(scope="module")
def fakedist():
    gw, _n, engines, _t = build_fabric(pnode, ptr, port_engine, TPCH_DDL,
                                       _tables(), replicated={"part"})
    return gw, engines


def _squeezed_budget(eng) -> int:
    """Between the replicated part table's bytes and one lineitem
    shard's: the build side stays resident, the probe shard cannot."""
    part = eng._table_device_bytes(eng.store.table("part"), Q14_PART_COLS)
    li = eng._table_device_bytes(eng.store.table("lineitem"), Q6_COLS)
    assert part < li
    return (part + li) // 2


@pytest.fixture(scope="module")
def fakedist_squeezed():
    gw, _n, engines, _t = build_fabric(pnode, ptr, port_engine, TPCH_DDL,
                                       _tables(), replicated={"part"})
    e = engines[SQUEEZED]
    e.settings.set("sql.exec.hbm_budget_bytes", str(_squeezed_budget(e)))
    return gw, engines


def _check(got, ref_rows, q):
    assert_rows_close(got, ref_rows[q][0])
    assert_rows_close(got, ref_rows[q][1])


class TestOverlappedExchange:
    def test_fuzzed_bit_parity_vs_frame_exchange(self, fakedist, ref_rows):
        gw, _engines = fakedist
        assert gw.overlap is True   # the shipped default
        for q in _fuzz_queries(2):
            gw.overlap = True
            over = gw.run(q, chunk_rows=97).rows
            gw.overlap = False
            serial = gw.run(q, chunk_rows=97).rows
            gw.overlap = True
            assert over == serial, q
            _check(over, ref_rows, q)

    def test_exchange_bytes_accounted(self, fakedist, ref_rows):
        gw, engines = fakedist
        before = [e.metrics.snapshot().get(
            "exec.movement.exchange.bytes", 0) for e in engines[1:]]
        _check(gw.run(tpch.Q1).rows, ref_rows, tpch.Q1)
        after = [e.metrics.snapshot().get(
            "exec.movement.exchange.bytes", 0) for e in engines[1:]]
        assert all(a > b for a, b in zip(after, before))


class TestDistributedSpill:
    def test_beyond_budget_join_completes(self, fakedist_squeezed,
                                          ref_rows):
        gw, engines = fakedist_squeezed
        e2 = engines[SQUEEZED]
        before = e2.metrics.snapshot().get(
            "exec.movement.dist_spill_fallbacks", 0)
        _check(gw.run(tpch.Q14).rows, ref_rows, tpch.Q14)
        snap = e2.metrics.snapshot()
        assert snap.get("exec.movement.dist_spill_fallbacks", 0) > before
        assert snap.get("exec.stream.pages", 0) > 0

    def test_beyond_budget_agg_flows(self, fakedist_squeezed, ref_rows):
        gw, engines = fakedist_squeezed
        _check(gw.run(tpch.Q6).rows, ref_rows, tpch.Q6)
        assert engines[SQUEEZED].metrics.snapshot().get(
            "exec.movement.overlap_seconds", 0) > 0

    def test_overlap_off_arm_also_pages(self, fakedist_squeezed, ref_rows):
        gw, engines = fakedist_squeezed
        e2 = engines[SQUEEZED]
        before = e2.metrics.snapshot().get(
            "exec.movement.dist_spill_fallbacks", 0)
        gw.overlap = False
        try:
            got = gw.run(tpch.Q6)
        finally:
            gw.overlap = True
        _check(got.rows, ref_rows, tpch.Q6)
        assert e2.metrics.snapshot().get(
            "exec.movement.dist_spill_fallbacks", 0) > before


def _counter(eng, name):
    m = eng.metrics.get(name)
    return m.value() if m is not None else 0


T_DDL = "CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, v INT8)"
D_DDL = "CREATE TABLE d (k INT8 NOT NULL PRIMARY KEY, w INT8)"
DIST_Q = "SELECT count(*), sum(v) FROM t JOIN d ON t.k = d.k"


def _skip_fabric(node_mod, transport_mod, make_engine):
    """3 data nodes, each holding 4 chunks of 500 keys of t, and a
    60-row replicated d whose keys all lie in node 1's second chunk."""
    transport = transport_mod.LocalTransport()
    nodes, engines = [], []
    dk = np.arange(100, 160, dtype=np.int64)
    for i in range(4):
        eng = make_engine()
        eng.execute(T_DDL)
        eng.execute(D_DDL)
        ts = eng.clock.now()
        if i > 0:
            base = (i - 1) * 20000
            for c in range(4):
                lo = base + c * 500
                k = np.arange(lo, lo + 500, dtype=np.int64)
                eng.store.insert_columns("t", {"k": k, "v": k % 97}, ts)
        eng.store.insert_columns("d", {"k": dk, "w": dk * 2}, ts)
        engines.append(eng)
        nodes.append(node_mod.DistSQLNode(i, eng, transport))
    gw = node_mod.Gateway(nodes[0], [1, 2, 3], replicated_tables={"d"})
    return gw, engines


class TestDistSQLJoinFilter:
    def test_remote_chunks_skip_host_side(self):
        with reference() as (jeng, jnode, jtr, _jt):
            rgw, _re = _skip_fabric(jnode, jtr, jeng.Engine)
            ref = rgw.run(DIST_Q).rows
        gw, engines = _skip_fabric(pnode, ptr, lambda: Engine(device="cpu"))
        got = gw.run(DIST_Q)
        assert got.rows == ref
        allk = np.concatenate([np.arange((i - 1) * 20000 + c * 500,
                                         (i - 1) * 20000 + c * 500 + 500)
                               for i in range(1, 4) for c in range(4)])
        hit = allk[(allk >= 100) & (allk < 160)]
        assert got.rows == [(len(hit), int((hit % 97).sum()))]
        # the gateway derived the frame from its replicated build copy
        assert _counter(engines[0], "exec.skip.joinfilter.filters") >= 1
        # only node 1 holds the matching chunk: nodes 2 and 3 skip all 4
        # of their chunks, node 1 skips 3 of 4
        per_node = [_counter(e, "exec.skip.joinfilter.chunks")
                    for e in engines]
        assert sum(per_node) == 11, per_node

    def test_wire_frame_roundtrip(self):
        """The port's frames equal the reference's and read back in
        either package."""
        from cockroach_tpu.exec.joinfilter import JoinFilter as JF
        from cockroach_tpu_torch.exec.joinfilter import JoinFilter
        rng = np.random.default_rng(5)
        keys = np.unique(rng.integers(0, 1 << 30, size=300,
                                      dtype=np.int64))
        f = JoinFilter("t", "k", lo=int(keys[0]), hi=int(keys[-1]),
                       keys=keys)
        g = JoinFilter.from_wire(f.to_wire())
        assert (g.table, g.col, g.lo, g.hi) == ("t", "k", f.lo, f.hi)
        assert np.array_equal(g.keys, keys)
        assert f.to_wire() == JF("t", "k", lo=int(keys[0]),
                                 hi=int(keys[-1]), keys=keys).to_wire()
        big = np.arange(100_000, dtype=np.int64)
        wire = JoinFilter("t", "k", lo=0, hi=99_999, keys=big).to_wire()
        assert wire == JF("t", "k", lo=0, hi=99_999, keys=big).to_wire()
        h = JoinFilter.from_wire(wire)
        assert h.keys is None and h.bloom is not None
        assert bool(np.all(h.bloom.might_contain(big[:4096])))


def _pchunk(groups, partials):
    g = np.asarray(groups)
    p = np.asarray(partials)
    n = len(g)
    return (n, {"g": g, "__p0": p},
            {"g": np.ones(n, bool), "__p0": np.ones(n, bool)})


class TestMergeOverflow:
    def test_int64_sum_overflow_raises(self):
        big = np.iinfo(np.int64).max - 10
        a = _pchunk(["x"], np.array([big], np.int64))
        b = _pchunk(["x"], np.array([100], np.int64))
        with pytest.raises(MergeUnsupported, match="overflow"):
            merge_partials([a, b], ["g"], {"__p0": "sum"})

    def test_int64_negative_overflow_raises(self):
        small = np.iinfo(np.int64).min + 10
        a = _pchunk(["x"], np.array([small], np.int64))
        b = _pchunk(["x"], np.array([-100], np.int64))
        with pytest.raises(MergeUnsupported, match="overflow"):
            merge_partials([a, b], ["g"], {"__p0": "sum"})

    def test_near_max_sum_stays_exact(self):
        near = np.iinfo(np.int64).max // 2
        a = _pchunk(["x"], np.array([near], np.int64))
        b = _pchunk(["x"], np.array([near], np.int64))
        k, cols, _valid = merge_partials([a, b], ["g"], {"__p0": "sum"})
        assert k == 1
        assert cols["__p0"].dtype == np.int64
        assert cols["__p0"][0] == 2 * near

    def test_uint64_overflow_raises(self):
        big = np.iinfo(np.uint64).max - 1
        a = _pchunk(["x"], np.array([big], np.uint64))
        b = _pchunk(["x"], np.array([5], np.uint64))
        with pytest.raises(MergeUnsupported, match="overflow"):
            merge_partials([a, b], ["g"], {"__p0": "sum"})

    def test_merge_equals_the_references(self):
        """merge_partials over seeded chunks with NULL keys and NULL
        partials: the reference's result, array for array."""
        from cockroach_tpu.distsql.physical import merge_partials as jmp
        rng = np.random.default_rng(11)
        chunks = []
        for _ in range(4):
            n = int(rng.integers(0, 30))
            chunks.append((n,
                           {"g": rng.integers(0, 5, n),
                            "s": np.array([b"a", b"bb", b""])[
                                rng.integers(0, 3, n)],
                            "__p0": rng.integers(-9, 9, n),
                            "__p1": rng.normal(size=n)},
                           {"g": rng.random(n) < 0.8,
                            "s": rng.random(n) < 0.9,
                            "__p0": rng.random(n) < 0.9,
                            "__p1": np.ones(n, bool)}))
        funcs = {"__p0": "sum_int", "__p1": "max"}
        k, cols, valid = merge_partials(chunks, ["g", "s"], funcs)
        jk, jcols, jvalid = jmp(chunks, ["g", "s"], funcs)
        assert k == jk
        for c in cols:
            np.testing.assert_array_equal(cols[c], jcols[c])
            np.testing.assert_array_equal(valid[c], jvalid[c])


class TestMergeTree:
    def test_fanout_two_tree_equals_flat_fan_in(self, ref_rows):
        """merge_fanout=2 over three data nodes: node 1 absorbs nodes 2
        and 3's partial streams and ships one merged stream; the rows
        equal the flat fan-in's and the reference's."""
        gw, nodes, engines, _t = build_fabric(
            pnode, ptr, port_engine, TPCH_DDL, _tables(),
            replicated={"part"}, merge_fanout=2)
        flat = pnode.Gateway(nodes[0], [1, 2, 3],
                             replicated_tables={"part"})
        got = gw.run(TREE_Q).rows
        assert got == flat.run(TREE_Q).rows
        _check(got, ref_rows, TREE_Q)
        assert _counter(engines[1], "exec.multihost.flows.merged") == 1
        assert _counter(engines[0], "distsql.flows.tree") == 1
        # a merge that is not combine-exact (a FLOAT8 AVG) keeps the
        # flat fan-in under the same gateway
        q1 = gw.run(tpch.Q1).rows
        _check(q1, ref_rows, tpch.Q1)
        assert _counter(engines[0], "distsql.flows.tree") == 1
        for n in nodes:
            assert not n.registry._inboxes
