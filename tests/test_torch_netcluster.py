"""The port's raft over TCP (kvserver/netcluster.py) against the
reference's.

1. The reference's own cases run on the port's modules
   (``reference_cases`` of test_torch_ranges.py), each assertion holding
   the port to the value the reference asserts:
   - tests/test_netcluster.py: the 4 cases of ``TestNetCluster``
     (bootstrap, join and up-replication; a write on one node read on
     another; replication to every store; a leaseholder's death losing
     nothing), and ``test_three_os_processes`` (``slow``, as in the
     reference), which drives ``python -m cockroach_tpu_torch start
     --device cpu`` three times;
   - tests/test_netcluster_partition.py: the partitioned leaseholder
     fails closed;
   - tests/test_fault_injection.py: ``TestNetClusterFaultMatrix``;
   - tests/test_advice_regressions.py: ``TestCrossGatewayTxnPush``'s 2
     cases (a live foreign txn is not aborted; a committed record is
     honoured).
2. One seeded statement script runs through a reference three-node
   NetCluster behind ``Engine(cluster=n1)`` and through a port one
   behind ``Engine(cluster=n1, device="cpu")``: DDL, INSERTs, an UPDATE,
   reads on node 3, a stopped leaseholder, then a read and a write on a
   survivor. Both give equal rows at every step.
3. A mixed cluster: a port NetCluster joins, over TCP, a cluster that a
   reference NetCluster bootstrapped, is up-replicated onto, and serves
   the reference node's writes (raw keys and SQL rows) while the
   reference node reads the port's. The port claims the reference's
   bytes on the wire; a mismatch would show here.
"""

from __future__ import annotations

import time

import pytest

from cockroach_tpu_torch.exec.engine import Engine as PortEngine
from tests.test_torch_ranges import reference_cases


reference_cases("test_netcluster.py", globals(), replace=(
    ('[sys.executable, "-m", "cockroach_tpu", "start",',
     '[sys.executable, "-m", "cockroach_tpu_torch", "start", '
     '"--device", "cpu",'),
))
reference_cases("test_netcluster_partition.py", globals())
reference_cases("test_fault_injection.py", globals(),
                only=("TestNetClusterFaultMatrix",))
reference_cases("test_advice_regressions.py", globals(),
                only=("TestCrossGatewayTxnPush",))


# -- the two packages side by side -------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The reference's engine and NetCluster modules, held imported."""
    from tests.test_torch_groupagg_large import reference_modules
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.kvserver.netcluster") as mods:
        yield mods


def _port_modules():
    from cockroach_tpu_torch.kvserver import netcluster
    return PortEngine, netcluster.NetCluster


def _mk3(NetCluster):
    """Three NetClusters of one package over TCP, the bootstrap range on
    all three (the reference tests' ``_mk3``)."""
    n1 = NetCluster(1)
    n1.bootstrap()
    n2 = NetCluster(2, join={1: n1.addr})
    n2.join()
    n3 = NetCluster(3, join={1: n1.addr})
    n3.join()
    deadline = time.time() + 20
    while time.time() < deadline:
        n1.replicate_queue_scan()
        if sorted(n1.descriptors[1].replicas) == [1, 2, 3]:
            break
        time.sleep(0.05)
    assert sorted(n1.descriptors[1].replicas) == [1, 2, 3]
    return {1: n1, 2: n2, 3: n3}


def _rows(res):
    return [tuple(str(v) if not isinstance(v, (int, float, str, type(None)))
                  else v for v in r) for r in res.rows]


def _retry(fn, timeout: float = 60.0):
    """``fn()`` until it returns: a statement right after a node's death
    may meet the old lease until a survivor takes it."""
    deadline = time.time() + timeout
    while True:
        try:
            return fn()
        except Exception:
            if time.time() > deadline:
                raise
            time.sleep(0.2)


SCRIPT_ROWS = 48
SCRIPT_SEED = 19


def _script(Engine, NetCluster, kw) -> list:
    """The seeded statement script on one package's three-node cluster;
    every result, in order."""
    import numpy as np
    rng = np.random.default_rng(SCRIPT_SEED)
    bal = rng.integers(0, 100_000, SCRIPT_ROWS)
    region = rng.choice(["eu", "us", "ap"], SCRIPT_ROWS)
    q = ("SELECT region, sum(bal) AS s, count(*) AS n, min(id) AS lo "
         "FROM acct GROUP BY region ORDER BY region")
    ns = _mk3(NetCluster)
    out = []
    try:
        a = Engine(cluster=ns[1], **kw)
        a.execute("CREATE TABLE acct (id INT8 NOT NULL PRIMARY KEY, "
                  "bal DECIMAL(12,2) NOT NULL, region STRING)")
        half = SCRIPT_ROWS // 2
        for lo, hi in ((0, half), (half, SCRIPT_ROWS)):
            a.execute("INSERT INTO acct VALUES " + ",".join(
                f"({i}, {bal[i] / 100:.2f}, '{region[i]}')"
                for i in range(lo, hi)))
        out.append(_rows(a.execute(q)))
        a.execute("UPDATE acct SET bal = bal + 1.5 WHERE id % 3 = 0")
        out.append(_rows(a.execute(q)))
        c = Engine(cluster=ns[3], **kw)
        out.append(_rows(c.execute(q)))
        out.append(_rows(c.execute(
            "SELECT id, bal FROM acct WHERE id < 6 ORDER BY id")))
        victim = ns[1].ensure_lease(1)
        assert victim is not None
        out.append(("victim", victim))
        ns[victim].stop()
        survivor = min(n for n in ns if n != victim)
        s = Engine(cluster=ns[survivor], **kw)
        out.append(_retry(lambda: _rows(s.execute(q))))
        _retry(lambda: s.execute(
            "INSERT INTO acct VALUES (1000, 7.25, 'ap')"))
        out.append(_rows(s.execute(q)))
        other = max(n for n in ns if n != victim)
        t = Engine(cluster=ns[other], **kw)
        out.append(_retry(lambda: _rows(t.execute(
            "SELECT count(*), sum(bal) FROM acct"))))
    finally:
        for n in ns.values():
            n.stop()
    return out


def test_statement_script_matches_the_reference(ref):
    re_, rnc = ref
    want = _script(re_.Engine, rnc.NetCluster, {})
    Engine, NetCluster = _port_modules()
    got = _script(Engine, NetCluster, {"device": "cpu"})
    assert got == want
    assert got[1] != got[0]          # the UPDATE moved the sums
    assert got[-1][0][0] == SCRIPT_ROWS + 1


def test_port_node_joins_a_reference_cluster(ref):
    re_, rnc = ref
    Engine, NetCluster = _port_modules()
    r1 = rnc.NetCluster(1)
    r1.bootstrap()
    p2 = NetCluster(2, join={1: r1.addr})
    try:
        p2.join()
        deadline = time.time() + 20
        while time.time() < deadline:
            r1.replicate_queue_scan()
            if sorted(r1.descriptors[1].replicas) == [1, 2]:
                break
            time.sleep(0.05)
        assert sorted(r1.descriptors[1].replicas) == [1, 2]
        assert str(p2.version.active) == str(r1.version.active)
        # raw keys both ways, routed over the fabric
        r1.put(b"\x01ref", b"from the reference")
        assert p2.get(b"\x01ref") == b"from the reference"
        p2.put(b"\x01port", b"from the port")
        assert r1.get(b"\x01port") == b"from the port"
        # the port's replica applied the reference leader's entries
        assert p2.pump_until(lambda: p2.store.replicas[1].mvcc.get(
            b"\x01ref", p2.clock.now(), inconsistent=True) is not None)
        # SQL: the reference writes, the port's engine reads equal rows
        re_eng = re_.Engine(cluster=r1)
        re_eng.execute("CREATE TABLE mix (k INT8 NOT NULL PRIMARY KEY, "
                       "v DECIMAL(10,2), s STRING)")
        re_eng.execute("INSERT INTO mix VALUES " + ",".join(
            f"({i}, {i * 3}.25, 's{i % 4}')" for i in range(24)))
        q = ("SELECT s, sum(v), count(*) FROM mix GROUP BY s "
             "ORDER BY s")
        pe = Engine(cluster=p2, device="cpu")
        assert _rows(pe.execute(q)) == _rows(re_eng.execute(q))
        pe.execute("UPDATE mix SET v = v + 1 WHERE k < 8")
        assert _rows(re_eng.execute(q)) == _rows(pe.execute(q))
    finally:
        p2.stop()
        r1.stop()


# -- chip_smoke.py phase 23's failover retry ---------------------------------

@pytest.mark.parametrize("error, transient, retried", [
    ("pg:r1: not leaseholder (try n2)", "read", True),
    ("pg:r1: no reachable leaseholder for read", "read", True),
    ("refused", "read", True),
    ("pg:r1: propose timed out (tried [2]); fate unknown", "read", True),
    ("pg:r1: propose timed out (tried [2]); fate unknown", "write", False),
    ("pg:relation \"lineitem\" does not exist", "read", False),
    ("wrong", "read", False),
])
def test_phase23_retries_only_a_moving_lease(error, transient, retried):
    """Phase 23 asks a statement again only for a moving lease's errors
    and a refused connection; a wrong answer (the AssertionError of its
    check) and any other error end the run on the first attempt."""
    import chip_smoke
    from cockroach_tpu_torch.server.miniclient import PgError
    calls = []

    def fn():
        calls.append(1)
        if len(calls) > 1:
            return "rows"
        if error.startswith("pg:"):
            raise PgError({"M": error[3:]})
        if error == "refused":
            raise ConnectionRefusedError("connection refused")
        raise AssertionError("Q1 differs from the oracle")

    kinds = {"read": chip_smoke.NC_TRANSIENT_READ,
             "write": chip_smoke.NC_TRANSIENT}
    if retried:
        res, seen = chip_smoke._nc_retry(fn, "q1", transient=kinds[transient],
                                         timeout=5.0)
        assert res == "rows" and sum(seen.values()) == 1
    else:
        with pytest.raises((PgError, AssertionError)):
            chip_smoke._nc_retry(fn, "q1", transient=kinds[transient],
                                 timeout=5.0)
    assert len(calls) == (2 if retried else 1)


@pytest.mark.parametrize("error, retried", [
    ("r1: no reachable leaseholder for read", True),
    ("lease", True),
    ("CUDA error: an illegal memory access", False),
])
def test_phase23_retries_an_in_process_moving_lease(error, retried):
    """Node 4's Q1 runs in this process: the range plane's own
    RuntimeError (or NotLeaseholderError) of a moving lease is asked
    again, any other RuntimeError ends the run on the first attempt."""
    import chip_smoke
    from cockroach_tpu_torch.kvserver.cluster import NotLeaseholderError
    calls = []

    def fn():
        calls.append(1)
        if len(calls) > 1:
            return "rows"
        if error == "lease":
            raise NotLeaseholderError(1, 2)
        raise RuntimeError(error)

    if retried:
        res, seen = chip_smoke._nc_retry(
            fn, "q1", transient=chip_smoke.NC_TRANSIENT_READ, timeout=5.0)
        assert res == "rows" and sum(seen.values()) == 1
    else:
        with pytest.raises(RuntimeError, match="illegal memory"):
            chip_smoke._nc_retry(fn, "q1",
                                 transient=chip_smoke.NC_TRANSIENT_READ,
                                 timeout=5.0)
    assert len(calls) == (2 if retried else 1)

