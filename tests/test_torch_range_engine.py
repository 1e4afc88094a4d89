"""The port's SQL on raft-replicated ranges (``Engine(cluster=...)``,
kv/rangekv.py, kv/disttxn.py, kv/rowfetch.py, the scan plane's
generation tokens in exec/dml.py) against the reference's.

1. The reference's own cases, tests/test_range_engine.py (14: DDL and
   DML on ranges, explicit txns, sequences and the catalog across
   gateways, node kills, splits, unique indexes, write conflicts, open
   snapshots and AS OF SYSTEM TIME across a refresh, schema evolution,
   two Nodes over pgwire) and tests/test_sql_on_ranges.py (5:
   ``RangeTable`` round trips, materialization, leaseholder
   partitioning, node kills), run on the port's modules with every
   ``Engine`` on the CPU (``reference_cases`` of test_torch_ranges.py).
   Each assertion holds the port to the rows the reference asserts.
2. A differential script runs the same statements on a reference
   ``Engine(cluster=c)`` and a port ``Engine(cluster=c, device="cpu")``
   (each over its own seeded Cluster) and compares every result: two
   gateways, an UPDATE seen through the generation token, AS OF SYSTEM
   TIME across the refresh, a stopped leaseholder and a fresh gateway.
   TPC-H Q1, Q6 and Q14 over ranges split in four then equal the
   reference's rows and a local port engine's, Q1 through kernel 1's
   plain version.
3. One ``gpu`` case runs Q1 on a cluster-backed engine on the card,
   through kernel 1, against a CPU engine over the same cluster.
"""

from __future__ import annotations

import pytest
import torch

from cockroach_tpu_torch.exec.engine import Engine as PortEngine
from cockroach_tpu_torch.kvserver.cluster import Cluster as PortCluster


def _sibling(name: str):
    """A sibling test module, loaded by its path: the card's machine may
    have another package named ``tests``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_sibling_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


reference_cases = _sibling("test_torch_ranges").reference_cases


class CpuEngine(PortEngine):
    """The port's Engine on the CPU (the reference's cases build theirs
    with no device, which on the port means the card)."""

    def __init__(self, *args, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(*args, **kw)


reference_cases("test_range_engine.py", globals(), replace=(
    ("Node(NodeConfig(node_id=1, cluster=cluster))",
     "Node(NodeConfig(node_id=1, cluster=cluster, device='cpu'))"),
    ("Node(NodeConfig(node_id=2, cluster=cluster))",
     "Node(NodeConfig(node_id=2, cluster=cluster, device='cpu'))"),
), bind={"Engine": CpuEngine})
reference_cases("test_sql_on_ranges.py", globals(),
                bind={"Engine": CpuEngine})


# -- differential: the same statements on both packages ----------------------

@pytest.fixture(scope="module")
def ref():
    """The reference's engine and cluster modules, held imported (the
    reference engine loads its kernels at its first statement)."""
    from tests.test_torch_groupagg_large import reference_modules
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.kvserver.cluster") as mods:
        yield mods


def _clusters(ref):
    """(cluster, gateway factory) of each package, reference first: a
    3-node Cluster of one seed, its keyspace one range with a lease."""
    re_, rc = ref
    out = []
    for Cluster, Engine, kw in ((rc.Cluster, re_.Engine, {}),
                                (PortCluster, PortEngine,
                                 {"device": "cpu"})):
        c = Cluster(n_nodes=3, seed=3)
        c.create_range(b"\x00", b"\xff")
        c.pump_until(lambda: c.leaseholder(1) is not None)
        out.append((c, lambda c=c, E=Engine, kw=kw: E(cluster=c, **kw)))
    return out


def _rows(res):
    return [tuple(str(v) if not isinstance(v, (int, float, str, type(None)))
                  else v for v in r) for r in res.rows]


def _script(c, make):
    """Statements through gateways A and B of one cluster; the results,
    in order."""
    out = []
    a, b = make(), make()
    a.execute("CREATE TABLE acct (id INT8 NOT NULL PRIMARY KEY, "
              "bal DECIMAL(12,2) NOT NULL, region STRING)")
    a.execute("INSERT INTO acct VALUES " + ",".join(
        f"({i}, {100 + i}.25, '{'eu' if i % 2 else 'us'}')"
        for i in range(60)))
    q = ("SELECT region, sum(bal) AS s, count(*) AS n FROM acct "
         "GROUP BY region ORDER BY region")
    out.append(_rows(a.execute(q)))
    out.append(_rows(b.execute(q)))
    ts = a.clock.now().wall
    a.execute("UPDATE acct SET bal = bal + 1 WHERE id < 10")
    out.append(_rows(b.execute(q)))                       # the token
    out.append(_rows(b.execute(
        f"SELECT region, sum(bal) AS s, count(*) AS n FROM acct "
        f"AS OF SYSTEM TIME {ts} GROUP BY region ORDER BY region")))
    b.execute("DELETE FROM acct WHERE id >= 50")
    out.append(_rows(a.execute(q)))
    victim = c.leaseholder(1)
    c.stop_node(victim)
    c.pump(60)
    fresh = make()
    out.append(_rows(fresh.execute(q)))
    fresh.execute("INSERT INTO acct VALUES (1000, 1.00, 'ap')")
    out.append(_rows(a.execute(q)))
    return out


def test_statement_script_matches_the_reference(ref):
    (rc, rmake), (pc, pmake) = _clusters(ref)
    want = _script(rc, rmake)
    got = _script(pc, pmake)
    assert got == want
    assert got[2] != got[0]          # the UPDATE moved B's answer
    assert got[3] == got[0]          # AS OF reads below it


# raft is host code whose cost per write grows with the range's log
# (every proposal re-sends to each follower once per append stream still
# in flight), so the loads through SQL stay small: 600 lineitem rows in
# four ranges, the parts p_partkey <= 200. Q1 runs under
# pallas_groupagg = on, kernel 1's route at any row count.
TPCH_ROWS = 600
PART_ROWS = 200
INSERT_BATCH = 1000


def _lit(v):
    import numpy as np
    if isinstance(v, (str, np.str_)):
        return "'" + str(v).replace("'", "''") + "'"
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(int(v))


def tpch_sql_rows(rows: int, part_rows: int, sf: float = 0.01):
    """lineitem (``rows`` rows) and the first ``part_rows`` parts of the
    generators at ``sf`` as SQL literal columns, dates as ISO
    strings."""
    import datetime

    from cockroach_tpu_torch.models import tpch
    li = tpch.gen_lineitem(sf, rows=rows)
    epoch = datetime.date(1970, 1, 1)
    for c in ("l_shipdate", "l_commitdate", "l_receiptdate"):
        li[c] = [str(epoch + datetime.timedelta(days=int(d)))
                 for d in li[c]]
    part = {k: v[:part_rows] for k, v in tpch.gen_part(sf).items()}
    return li, part


def insert_tables(eng, tables, batch: int = INSERT_BATCH) -> None:
    """INSERT each (name, columns) in statements of ``batch`` rows."""
    for table, cols in tables:
        names = list(cols)
        n = len(cols[names[0]])
        for lo in range(0, n, batch):
            eng.execute(
                f"INSERT INTO {table} ({', '.join(names)}) VALUES "
                + ", ".join("(" + ", ".join(_lit(cols[c][i])
                                              for c in names) + ")"
                            for i in range(lo, min(n, lo + batch))))


def lineitem_splits(eng, rows: int, pieces: int = 4) -> list:
    """Keys that cut lineitem's synthetic-rowid span into ``pieces``
    ranges of about equal rows (rowids are allocated from 0)."""
    from cockroach_tpu_torch.sql.rowenc import RowCodec
    codec = RowCodec(eng.store.table("lineitem").schema)
    return [codec.key_from_pk((rows * k // pieces,))
            for k in range(1, pieces)]


@pytest.fixture(scope="module")
def tpch_rows():
    return tpch_sql_rows(TPCH_ROWS, PART_ROWS)


def test_tpch_on_split_ranges_matches_the_reference(ref, tpch_rows):
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    li, part = tpch_rows
    engines = {}
    for name, (c, make) in zip(("ref", "port"), _clusters(ref)):
        eng = make()
        eng.execute(tpch.DDL["lineitem"])
        eng.execute(tpch.DDL["part"])
        for key in lineitem_splits(eng, TPCH_ROWS):
            c.split_range(key)
        insert_tables(eng, (("lineitem", li), ("part", part)))
        engines[name] = (c, eng)
    pc, port = engines["port"]
    assert len(pc.descriptors) >= 4
    local = PortEngine(device="cpu")
    local.execute(tpch.DDL["lineitem"])
    local.execute(tpch.DDL["part"])
    insert_tables(local, (("lineitem", li), ("part", part)))
    sessions = {}
    for name, eng in (("ref", engines["ref"][1]), ("port", port),
                      ("local", local)):
        sessions[name] = eng.session()
        eng.execute("SET pallas_groupagg = on", sessions[name])
    for q in ("q1", "q6", "q14"):
        sql = tpch.QUERIES[q]
        want = _rows(engines["ref"][1].execute(sql, sessions["ref"]))
        p0 = tgl.PLAIN_CALLS
        got = _rows(port.execute(sql, sessions["port"]))
        calls = tgl.PLAIN_CALLS - p0
        assert got == _rows(local.execute(sql, sessions["local"]))
        if q == "q1":
            # the keys, DECIMAL sums and counts exactly; the AVGs are
            # float folds whose order differs between the packages
            assert [r[:6] + r[9:] for r in got] == \
                [r[:6] + r[9:] for r in want]
            for g, w in zip(got, want):
                assert g[6:9] == pytest.approx(w[6:9], rel=1e-12)
            assert calls == 1
        else:
            assert got[0][0] == pytest.approx(want[0][0], rel=1e-9)


@pytest.mark.gpu
def test_q1_on_ranges_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    c = PortCluster(n_nodes=3)
    c.create_range(b"\x00", b"\xff")
    c.pump_until(lambda: c.leaseholder(1) is not None)
    card = PortEngine(cluster=c)
    card.execute(tpch.DDL["lineitem"])
    li, _part = tpch_sql_rows(TPCH_ROWS, PART_ROWS)
    insert_tables(card, (("lineitem", li),))
    s = card.session()
    card.execute("SET pallas_groupagg = on", s)
    n0 = tgl.LAUNCHES
    got = card.execute(tpch.Q1, s).rows
    assert tgl.LAUNCHES - n0 == 1
    cpu = PortEngine(cluster=c, device="cpu")
    s2 = cpu.session()
    cpu.execute("SET pallas_groupagg = on", s2)
    want = cpu.execute(tpch.Q1, s2).rows
    # keys, DECIMAL sums and counts exactly; the AVGs are float folds
    # whose order differs between the card and the CPU
    assert [r[:6] + r[9:] for r in got] == [r[:6] + r[9:] for r in want]
    for g, w in zip(got, want):
        assert g[6:9] == pytest.approx(w[6:9], rel=1e-12)
