"""DistSQL flows of the port against the reference's
(tests/test_distsql_flows.py's cases).

The fakedist model of the reference's logic tests: lineitem split over
three in-process data nodes, ``part`` replicated, a gateway (node 0)
holding no lineitem rows, flows over the in-process transport. The port's
``Gateway`` runs over port nodes made with ``Engine(device="cpu")``; its
rows are held against the reference's ``Gateway`` over reference nodes on
the same sliced arrays, and against one reference ``Engine`` over the
whole table. DECIMAL and FLOAT8 results are compared within rel 1e-9
(the reference's own flow tests compare floats so; AVG adds in another
order), everything else exactly.

Also here: the serde bytes held byte for byte against the reference's
encoder; the leaseholder-partitioned flows over a kvserver.Cluster and
the replan after a node's death, each case run on both packages (flows
over socket transports are tests/test_torch_rpc_fabric.py's); a node on a
two-slot CPU shard mesh; Q1 whose per-node DECIMAL partials pass 2^31
merged exactly; kernel 1 routed once per data node (its plain version
on the CPU, its launch on the card).
"""

import contextlib

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.distsql import serde
from cockroach_tpu_torch.distsql.flow import FlowSpec
from cockroach_tpu_torch.distsql.node import (DistSQLNode, FlowError,
                                              Gateway)
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.kvserver.transport import LocalTransport
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
from cockroach_tpu_torch.parallel.mesh import make_mesh

ROWS = 6000
FLOAT_REL = 1e-9
PLAIN_Q = ("SELECT l_orderkey, l_quantity FROM lineitem "
           "WHERE l_quantity < 3 ORDER BY l_orderkey, l_quantity LIMIT 17")


def _slice(cols: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in cols.items()}


def bounds(n: int, parts: int) -> list:
    return [n * i // parts for i in range(parts + 1)]


def assert_rows_close(got, want, rel=FLOAT_REL):
    assert len(got) == len(want)
    for rg, rw in zip(got, want):
        assert len(rg) == len(rw)
        for a, b in zip(rg, rw):
            if isinstance(a, float) and b is not None:
                assert b == pytest.approx(a, rel=rel)
            else:
                assert a == b


@contextlib.contextmanager
def reference():
    """The reference's engine, flow node, transport and tpch modules."""
    from tests.test_torch_groupagg_large import reference_modules
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.distsql.node",
                           "cockroach_tpu.kvserver.transport",
                           "cockroach_tpu.models.tpch") as mods:
        yield mods


def build_fabric(node_mod, transport_mod, make_engine, ddls, tables,
                 replicated=(), n_data=3, **gw_kw):
    """A gateway (node 0, no sharded rows) over ``n_data`` data nodes:
    each table of ``tables`` ({name: arrays}) is split in contiguous
    slices over the data nodes, unless it is in ``replicated`` (then
    every node, the gateway too, holds it whole). Works for either
    package: ``node_mod``/``transport_mod`` are its distsql.node and
    kvserver.transport modules."""
    transport = transport_mod.LocalTransport()
    nodes, engines = [], []
    for i in range(n_data + 1):
        eng = make_engine(i)
        for ddl in ddls:
            eng.execute(ddl)
        ts = eng.clock.now()
        for name, cols in tables.items():
            if name in replicated:
                eng.store.insert_columns(name, cols, ts)
            elif i > 0:
                n = len(next(iter(cols.values())))
                b = bounds(n, n_data)
                if b[i] > b[i - 1]:
                    eng.store.insert_columns(
                        name, _slice(cols, b[i - 1], b[i]), ts)
        engines.append(eng)
        nodes.append(node_mod.DistSQLNode(i, eng, transport))
    gw = node_mod.Gateway(nodes[0], list(range(1, n_data + 1)),
                          replicated_tables=set(replicated), **gw_kw)
    return gw, nodes, engines, transport


def oracle_engine(make_engine, ddls, tables):
    eng = make_engine(0)
    for ddl in ddls:
        eng.execute(ddl)
    for name, cols in tables.items():
        eng.store.insert_columns(name, cols, eng.clock.now())
    return eng


def port_engine(_i=0):
    return Engine(device="cpu")


TPCH_DDL = [tpch.DDL["lineitem"], tpch.DDL["part"]]

QUERIES = {"q6": tpch.Q6, "q1": tpch.Q1, "q14": tpch.Q14,
           "plain": PLAIN_Q}


@pytest.fixture(scope="module")
def tables():
    return {"lineitem": tpch.gen_lineitem(0.01, rows=ROWS),
            "part": tpch.gen_part(0.01)}


@pytest.fixture(scope="module")
def ref_rows(tables):
    """The reference's rows per query: its gateway over its fakedist
    fabric, and one reference engine over the whole tables."""
    with reference() as (jeng, jnode, jtr, _jtpch):
        def mk(_i):
            return jeng.Engine()
        gw, _n, _e, _t = build_fabric(jnode, jtr, mk, TPCH_DDL, tables,
                                      replicated={"part"})
        oracle = oracle_engine(mk, TPCH_DDL, tables)
        out = {}
        for name, sql in QUERIES.items():
            out[name] = (gw.run(sql).rows, oracle.execute(sql).rows)
        out["q6_chunk1"] = (gw.run(tpch.Q6, chunk_rows=1).rows,
                            out["q6"][1])
        out["q1_names"] = list(oracle.execute(tpch.Q1).names)
        return out


@pytest.fixture(scope="module")
def fakedist(tables):
    import cockroach_tpu_torch.distsql.node as pnode
    import cockroach_tpu_torch.kvserver.transport as ptr
    gw, nodes, engines, _t = build_fabric(pnode, ptr, port_engine,
                                          TPCH_DDL, tables,
                                          replicated={"part"})
    return gw, nodes, engines


def _check(gw, ref_rows, name, sql, **kw):
    got = gw.run(sql, **kw)
    ref_gw, ref_one = ref_rows[name]
    assert_rows_close(got.rows, ref_gw)
    assert_rows_close(got.rows, ref_one)
    return got


class TestFlows:
    def test_q6_partial_agg(self, fakedist, ref_rows):
        _check(fakedist[0], ref_rows, "q6", tpch.Q6)

    def test_q1_grouped_partial_agg(self, fakedist, ref_rows):
        got = _check(fakedist[0], ref_rows, "q1", tpch.Q1)
        assert list(got.names) == ref_rows["q1_names"]

    def test_q14_join_flow(self, fakedist, ref_rows):
        _check(fakedist[0], ref_rows, "q14", tpch.Q14)

    def test_plain_select_rows_stage(self, fakedist, ref_rows):
        _check(fakedist[0], ref_rows, "plain", PLAIN_Q)

    def test_small_chunks_stream(self, fakedist, ref_rows):
        _check(fakedist[0], ref_rows, "q6_chunk1", tpch.Q6, chunk_rows=1)

    def test_gateway_plan_errors_surface_directly(self, fakedist):
        from cockroach_tpu_torch.sql.binder import BindError
        with pytest.raises(BindError):
            fakedist[0].run("SELECT no_such_col FROM lineitem")

    def test_remote_error_propagates(self):
        """A failure on a data node travels back as flow metadata."""
        transport = LocalTransport()
        ok = Engine(device="cpu")
        tpch.load(ok, sf=0.01, rows=100)
        broken = Engine(device="cpu")       # no lineitem table at all
        n1 = DistSQLNode(1, ok, transport)
        DistSQLNode(2, broken, transport)
        gw = Gateway(n1, [1, 2])
        with pytest.raises(FlowError, match="lineitem"):
            gw.run(tpch.Q6)


def _two_node_fabric(rows=300):
    transport = LocalTransport()
    data = Engine(device="cpu")
    tpch.load(data, sf=0.01, rows=rows)
    gw_eng = Engine(device="cpu")   # schema only: the gateway holds no rows
    gw_eng.execute(tpch.DDL["lineitem"])
    gw_eng.execute(tpch.DDL["part"])
    gw_node = DistSQLNode(0, gw_eng, transport)
    data_node = DistSQLNode(1, data, transport)
    return transport, gw_node, data_node


class TestFlowControl:
    """Credit backpressure, the cancel broadcast and fail-fast on a
    tripped peer (the analogues of gRPC stream windows and flow context
    cancellation, colrpc/outbox.go and flowinfra/flow.go)."""

    def test_backpressure_bounds_inflight_chunks(self):
        transport, gw_node, data_node = _two_node_fabric(rows=240)
        gw = Gateway(gw_node, [1], window=2)
        q = ("SELECT l_orderkey, l_quantity FROM lineitem "
             "WHERE l_quantity < 10 ORDER BY l_orderkey, l_quantity "
             "LIMIT 50")
        got = gw.run(q, chunk_rows=1)
        want = data_node.engine.execute(q)
        assert_rows_close(got.rows, want.rows)
        assert 0 < data_node.max_outstanding <= 2
        # producer-side credit state is cleaned up after the flow
        assert data_node.acks == {}

    def test_cancel_races_ahead_of_setup_flow(self):
        transport, gw_node, data_node = _two_node_fabric(rows=50)
        spec = FlowSpec("f-cancelled", gateway=0, stage="rows",
                        sql="SELECT l_orderkey FROM lineitem",
                        stream_id=0)
        transport.send(0, 1, ("cancel_flow", "f-cancelled"))
        transport.send(0, 1, ("setup_flow", spec.to_wire()))
        for _ in range(10):
            if transport.deliver_all() == 0:
                break
        assert data_node.flows_cancelled == 1
        assert data_node.flows_run == 0
        inbox = gw_node.registry.inbox("f-cancelled", 0)
        assert not inbox.eof and not inbox.chunks

    def test_gateway_broadcasts_cancel_on_remote_error(self):
        transport = LocalTransport()
        ok = Engine(device="cpu")
        tpch.load(ok, sf=0.01, rows=100)
        broken = Engine(device="cpu")
        n1 = DistSQLNode(1, ok, transport)
        n2 = DistSQLNode(2, broken, transport)
        gw = Gateway(n1, [1, 2])
        with pytest.raises(FlowError, match="lineitem"):
            gw.run(tpch.Q6)
        for _ in range(10):
            if transport.deliver_all() == 0:
                break
        assert len(n1.cancelled_flows) == 1
        assert len(n2.cancelled_flows) == 1

    def test_late_chunks_after_release_are_dropped(self):
        transport, gw_node, data_node = _two_node_fabric(rows=50)
        gw = Gateway(gw_node, [1])
        got = gw.run("SELECT count(*) FROM lineitem")
        assert got.rows[0][0] == 50
        assert len(gw_node.cancelled_flows) == 1
        dead = next(iter(gw_node.cancelled_flows))
        transport.send(1, 0, ("flow_stream", dead, 0, b"x", False, None))
        for _ in range(10):
            if transport.deliver_all() == 0:
                break
        assert (dead, 0) not in gw_node.registry._inboxes
        assert data_node.acks == {}

    def test_gateway_fails_fast_on_tripped_peer(self):
        transport, gw_node, data_node = _two_node_fabric(rows=50)

        class Monitor:
            def healthy(self, n):
                return n != 1

        gw = Gateway(gw_node, [1], monitor=Monitor())
        with pytest.raises(FlowError, match="unhealthy"):
            gw.run("SELECT count(*) FROM lineitem")
        transport.deliver_all()
        assert data_node.flows_run == 0


def _serde_cases():
    rng = np.random.default_rng(0)
    yield (50, {"a": rng.integers(0, 100, 50).astype(np.int64),
                "b": rng.random(50),
                "c": rng.integers(0, 2, 50).astype(bool)},
           {"a": rng.integers(0, 2, 50).astype(bool),
            "b": np.ones(50, dtype=bool),
            "c": np.zeros(50, dtype=bool)})
    yield (0, {"a": np.zeros(0, dtype=np.int64)},
           {"a": np.zeros(0, dtype=bool)})
    yield (4, {"s": np.array([b"x", b"", b"longer", b"yy"]),
               "i": np.array([-3, 2**40, -2**62, 0], dtype=np.int64),
               "f": np.array([-0.0, np.nan, 1.5, -np.inf]),
               "d": np.array([1, 2, 3, 4], dtype=np.int32)},
           {"s": np.array([True, False, True, True])})


class TestSerde:
    def test_roundtrip(self):
        n, cols, valid = next(_serde_cases())
        raw = serde.encode_columns(n, cols, valid)
        n2, c2, v2 = serde.decode_columns(raw)
        assert n2 == 50
        for k in cols:
            np.testing.assert_array_equal(cols[k], c2[k])
            np.testing.assert_array_equal(valid[k], v2[k])

    def test_empty(self):
        raw = serde.encode_columns(
            0, {"a": np.zeros(0, dtype=np.int64)},
            {"a": np.zeros(0, dtype=bool)})
        n, c2, _ = serde.decode_columns(raw)
        assert n == 0 and len(c2["a"]) == 0

    def test_bad_magic(self):
        with pytest.raises(ValueError):
            serde.decode_columns(b"XXXX1234")

    def test_bytes_equal_the_references(self):
        """The wire format is the reference's, byte for byte, for the
        same numpy input; a torch batch's bytes equal those of its
        numpy arrays."""
        from cockroach_tpu.distsql import serde as jserde
        from cockroach_tpu_torch.ops.batch import ColumnBatch
        for n, cols, valid in _serde_cases():
            assert serde.encode_columns(n, cols, valid) == \
                jserde.encode_columns(n, cols, valid)
        rng = np.random.default_rng(3)
        k = rng.integers(-50, 50, 40).astype(np.int64)
        f = rng.random(40)
        v = rng.random(40) < 0.8
        sel = rng.random(40) < 0.5
        b = ColumnBatch.from_dict(
            {"k": torch.tensor(k), "f": torch.tensor(f)},
            {"k": torch.tensor(v)}, sel=torch.tensor(sel))

        class NpBatch:
            names = ("k", "f")
            data = (k, f)
            valid = (v, np.ones(40, dtype=bool))
        NpBatch.sel = sel
        assert serde.batch_to_bytes(b) == jserde.batch_to_bytes(NpBatch)


class TestFlowTracing:
    """Remote flow recordings ship back to the gateway and stitch into
    the live statement capture."""

    def test_flow_spans_stitched_under_capture(self, fakedist, ref_rows):
        from cockroach_tpu_torch.utils import tracing
        gw = fakedist[0]
        with tracing.capture("stmt") as rec:
            got = gw.run(tpch.Q1)
        assert_rows_close(got.rows, ref_rows["q1"][1])
        flows = rec.find_all("flow")
        assert {s.tags["node"] for s in flows} == {1, 2, 3}
        assert all(s.span_id for s in flows)

    def test_no_capture_runs_untraced(self, fakedist, ref_rows):
        from cockroach_tpu_torch.utils import tracing
        assert tracing.current_span() is None
        got = fakedist[0].run(tpch.Q6)
        assert_rows_close(got.rows, ref_rows["q6"][1])

    def test_explain_analyze_through_gateway(self, fakedist, ref_rows):
        res = fakedist[0].run("EXPLAIN ANALYZE " + tpch.Q1)
        assert res.tag == "EXPLAIN ANALYZE"
        text = "\n".join(r[0] for r in res.rows)
        assert f"rows returned: {len(ref_rows['q1'][1])}" in text
        assert "explain-analyze" in text
        for nid in (1, 2, 3):
            assert f"node={nid}" in text

    def test_explain_analyze_debug_stitches_node_profiles(self, fakedist):
        import json
        res = fakedist[0].run("EXPLAIN ANALYZE (DEBUG) " + tpch.Q6)
        bundle = json.loads(res.rows[0][0])
        assert bundle["rows_returned"] == 1
        nodes = {op.get("node") for op in bundle["profile"]["ops"]}
        assert {1, 2, 3} <= nodes
        assert bundle["device_time_s"] > 0


def _pkg(ref_mods=None):
    """The modules a cluster fabric needs, of the port (no argument)
    or of the reference (``reference()``'s modules, held open by the
    caller), and an engine factory of that package on the CPU."""
    import importlib
    pkg = "cockroach_tpu" if ref_mods is not None else "cockroach_tpu_torch"
    mods = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "exec.engine", "distsql.node", "kvserver.transport",
        "kvserver.cluster", "kv.rowfetch", "models.tpch")}
    kw = {} if ref_mods is not None else {"device": "cpu"}
    return mods, (lambda: mods["exec.engine"].Engine(**kw))


def _rows_of(engine, table):
    """All storage-logical rows of a table."""
    store = engine.store
    td = store.table(table)
    return [store.extract_row(td, chunk, ri)
            for chunk in td.chunks for ri in range(chunk.n)]


def cluster_fabric(mods, make, rows, with_part=True, monitor=None,
                   **gw_kw):
    """The reference's leaseholder fabric: a 3-store Cluster holding
    lineitem (and part) in ranges, lineitem's span split in three;
    DistSQLNodes 0 (gateway) to 3 over one LocalTransport, each with
    the cluster; an oracle engine over the same rows."""
    tp = mods["models.tpch"]
    oracle = make()
    tp.load(oracle, sf=0.01, rows=rows)
    c = mods["kvserver.cluster"].Cluster(n_nodes=3)
    transport = mods["kvserver.transport"].LocalTransport()
    nodes = []
    for i in range(4):
        e = make()
        e.execute(tp.DDL["lineitem"])
        if with_part:
            e.execute(tp.DDL["part"])
        nodes.append(mods["distsql.node"].DistSQLNode(i, e, transport,
                                                      cluster=c))
    RangeTable = mods["kv.rowfetch"].RangeTable
    rt_li = RangeTable(c, nodes[0].engine.store.table("lineitem").schema)
    lo, hi = rt_li.codec.span()
    rt_p = None
    if with_part:
        rt_p = RangeTable(c, nodes[0].engine.store.table("part").schema)
        lo = min(lo, rt_p.codec.span()[0])
        hi = max(hi, rt_p.codec.span()[1])
    c.create_range(lo, hi, replicas=[1, 2, 3])
    c.pump_until(lambda: c.ensure_lease(1) is not None)
    rt_li.insert_rows(_rows_of(oracle, "lineitem"))
    if with_part:
        rt_p.insert_rows(_rows_of(oracle, "part"))
    s0, _s1 = rt_li.codec.span()
    for frac in (b"\x40", b"\x80"):
        c.split_range(s0 + frac)
    c.pump(10)
    gw = mods["distsql.node"].Gateway(nodes[0], [1, 2, 3], cluster=c,
                                      monitor=monitor, **gw_kw)
    return c, gw, oracle, rt_li, nodes, transport


LH_ROWS = 900
LH_AGG = ("SELECT count(*), sum(l_quantity) FROM lineitem "
          "WHERE l_quantity < 30")


def _lh_scenario(kind, mods, make):
    """One case of the reference's TestLeaseholderPartitionedFlows on
    one package: (the gateway's rows, the oracle's rows, the span
    partition's node count)."""
    tp = mods["models.tpch"]
    c, gw, oracle, rt_li, _nodes, _t = cluster_fabric(mods, make, LH_ROWS)
    if kind == "agg":
        q = LH_AGG
    elif kind == "join":
        q = tp.Q14
    else:
        # move every lease to store 2: the partition collapses to one
        # node, coverage stays exactly-once
        for rid, desc in list(c.descriptors.items()):
            lh = c.leaseholder(rid)
            if lh is not None and lh != 2 and 2 in desc.replicas:
                c.transfer_lease(rid, 2)
        c.pump(10)
        q = "SELECT count(*) FROM lineitem"
    parts = rt_li.partition_spans()
    return gw.run(q).rows, oracle.execute(q).rows, len(parts)


class TestLeaseholderPartitionedFlows:
    """Cluster mode: the Gateway partitions scans by range leaseholder
    (PartitionSpans) and each node materializes its assignment from the
    committed range data before running its stage. Each case runs on
    both packages over the same generated rows; the port's gateway rows
    equal its oracle's and the reference gateway's."""

    @pytest.mark.parametrize("kind", ["agg", "join", "lease_moves"])
    def test_leaseholder_partitioned(self, kind):
        with reference() as ref_mods:
            want, want_oracle, _ = _lh_scenario(kind, *_pkg(ref_mods))
        got, oracle_rows, nparts = _lh_scenario(kind, *_pkg())
        assert nparts >= 1
        assert_rows_close(got, oracle_rows)
        assert_rows_close(got, want)
        if kind == "lease_moves":
            assert nparts == 1 and got == want


def _replan_scenario(mid_flow: bool, mods, make):
    """The reference's TestFlowReplanOnFailure on one package: node 3
    dies (before the flow's scheduling check, or only after it, found by
    the gateway's mid-flow breaker poll); the statement replans on the
    survivors. Returns (rows before, rows after, oracle rows, monitor
    calls)."""
    q = ("SELECT count(*) FROM lineitem" if mid_flow
         else "SELECT count(*), sum(l_quantity) FROM lineitem")
    state = {"calls": 0, "sick": set()}

    class Monitor:
        def healthy(self, n):
            state["calls"] += 1
            if not mid_flow:
                return n not in state["sick"]
            # calls 1-3: the live-set probe; 4-6: the scheduling-time
            # check. Staying healthy through both forces the failure
            # onto the MID-FLOW poll
            return n != 3 or state["calls"] <= 6

    c, gw, oracle, _rt, _nodes, transport = cluster_fabric(
        mods, make, 600, with_part=False, monitor=Monitor(),
        **({"flow_timeout": 10.0} if mid_flow else {}))
    before = None
    if not mid_flow:
        before = gw.run(q).rows
        state["sick"].add(3)
    transport.stop_node(3)
    for rid in list(c.descriptors):
        if c.leaseholder(rid) == 3:
            c.transfer_lease(rid, 1)
    c.pump(10)
    if mid_flow:
        state["calls"] = 0
    after = gw.run(q).rows
    return before, after, oracle.execute(q).rows, state["calls"]


class TestFlowReplanOnFailure:
    """A read-only flow that loses a data node replans over the
    surviving nodes instead of erroring (the reference re-plans around
    dead nodes, distsql_running.go:375), on both packages."""

    @pytest.mark.parametrize("mid_flow", [False, True],
                             ids=["node_death", "mid_flow_death"])
    def test_replans_on_survivors(self, mid_flow):
        with reference() as ref_mods:
            r_before, r_after, r_oracle, _ = _replan_scenario(
                mid_flow, *_pkg(ref_mods))
        before, after, want, calls = _replan_scenario(mid_flow, *_pkg())
        if not mid_flow:
            assert before[0][0] == want[0][0] == r_before[0][0]
        assert_rows_close(after, want)
        assert_rows_close(after, r_after)
        assert r_after[0][0] == r_oracle[0][0]
        if mid_flow:
            assert calls > 6    # the mid-flow poll actually ran


class TestNodeOnAMesh:
    def test_node_on_a_two_slot_cpu_mesh(self, tables, ref_rows):
        """A data node on a shard mesh of its own runs its stage over
        the mesh (probe spine sharded, partials merged by the mesh's
        collectives); the rows are the reference's."""
        import cockroach_tpu_torch.distsql.node as pnode
        import cockroach_tpu_torch.kvserver.transport as ptr
        cpu = torch.device("cpu")

        def mk(i):
            if i == 2:
                e = Engine(mesh=make_mesh(devices=[cpu, cpu]))
                e.settings.set("sql.exec.submesh.size", "off")
                return e
            return Engine(device="cpu")
        gw, nodes, engines, _t = build_fabric(pnode, ptr, mk, TPCH_DDL,
                                              tables, replicated={"part"})
        before = engines[2].metrics.snapshot().get(
            "exec.allreduce.calls", 0)
        for name in ("q1", "q6", "q14"):
            got = gw.run(QUERIES[name])
            assert_rows_close(got.rows, ref_rows[name][1])
        after = engines[2].metrics.snapshot().get("exec.allreduce.calls", 0)
        assert after > before


LW_DDL = "CREATE TABLE lw (g STRING, v DECIMAL(15,2), n INT8)"
LW_Q = ("SELECT g, sum(v) AS s, sum(n) AS sn, count(*) AS c FROM lw "
        "GROUP BY g ORDER BY g")


def _lw_tables():
    # 3 x 8192 rows of 99,999,999.99 in group "a": each node's DECIMAL
    # partial (scaled ints) passes 2^31 many times over, as does the sum
    # of the INT column; the merge at the gateway adds them in int64
    n = 3 * 8192
    g = np.array(["a"] * (n - 30) + ["b"] * 30, dtype=object)
    return {"lw": {"g": g,
                   "v": np.full(n, 9_999_999_999, dtype=np.int64),
                   "n": np.full(n, (1 << 31) - 1, dtype=np.int64)}}


class TestExactMerge:
    def test_decimal_partials_past_2_31_merge_exactly(self):
        import cockroach_tpu_torch.distsql.node as pnode
        import cockroach_tpu_torch.kvserver.transport as ptr
        tabs = _lw_tables()
        gw, _n, _e, _t = build_fabric(pnode, ptr, port_engine, [LW_DDL],
                                      tabs)
        with reference() as (jeng, jnode, jtr, _jt):
            mk = (lambda _i: jeng.Engine())
            rgw, _rn, _re, _rt = build_fabric(jnode, jtr, mk, [LW_DDL],
                                              tabs)
            ref = rgw.run(LW_Q).rows
            one = oracle_engine(mk, [LW_DDL], tabs).execute(LW_Q).rows
        got = gw.run(LW_Q).rows
        n_a = 3 * 8192 - 30
        assert got[0][0] == "a" and got[0][3] == n_a
        assert got[0][2] == n_a * ((1 << 31) - 1)
        assert got[0][1] == pytest.approx(n_a * 99_999_999.99, rel=1e-12)
        assert_rows_close(got, ref)
        assert_rows_close(got, one)


class TestKernelRoute:
    def test_kernel1_once_per_data_node(self):
        """Q1's local stage goes through kernel 1's wrapper once on each
        data node holding at least AUTO_MIN_ROWS rows (its plain version
        on these CPU tensors); the gateway's final stage over a few rows
        per node takes the plain scatters."""
        import cockroach_tpu_torch.distsql.node as pnode
        import cockroach_tpu_torch.kvserver.transport as ptr
        n = 4 * 5000
        tabs = {"lineitem": tpch.gen_lineitem(0.01, rows=n)}
        gw, _n, _e, _t = build_fabric(pnode, ptr, port_engine,
                                      [tpch.DDL["lineitem"]], tabs,
                                      n_data=4)
        one = oracle_engine(port_engine, [tpch.DDL["lineitem"]], tabs)
        want = one.execute(tpch.Q1).rows
        gw.run(tpch.Q1)     # warm: the parity gate's first-use fuzz
        before = tgl.PLAIN_CALLS
        got = gw.run(tpch.Q1).rows
        assert tgl.PLAIN_CALLS - before == 4
        assert_rows_close(got, want)


@pytest.mark.gpu
def test_gateway_over_four_nodes_on_the_card():
    """Four data nodes and a gateway on cuda:0: kernel 1 launches once
    per node for Q1, rows equal one engine's over the whole table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import cockroach_tpu_torch.distsql.node as pnode
    import cockroach_tpu_torch.kvserver.transport as ptr
    n = 4 * 8192
    tabs = {"lineitem": tpch.gen_lineitem(0.01, rows=n)}

    def mk(_i):
        return Engine(device="cuda:0")
    gw, _n, _e, _t = build_fabric(pnode, ptr, mk, [tpch.DDL["lineitem"]],
                                  tabs, n_data=4)
    want = oracle_engine(mk, [tpch.DDL["lineitem"]], tabs).execute(
        tpch.Q1).rows
    gw.run(tpch.Q1)     # warm: the parity gate's first-use fuzz
    before = tgl.LAUNCHES
    got = gw.run(tpch.Q1).rows
    assert tgl.LAUNCHES - before == 4
    assert_rows_close(got, want)
