"""The port's in-process replicated KV plane (kvserver/raft.py, store.py,
cluster.py, liveness.py; kv/rangecache.py, distsender.py) against the
reference's.

1. The reference's own cases, tests/test_raft.py (raft core, leases,
   five nodes) and tests/test_ranges.py (splits and merges, replica
   changes, DistSender), run unchanged on the port's modules: the test
   file's source is compiled with its ``cockroach_tpu.`` imports pointed
   at ``cockroach_tpu_torch.`` (``reference_cases``), so each of its
   assertions holds the port to the values the reference asserts.
2. One differential case drives the reference's ``Cluster`` and the
   port's with the same seed through the same puts, splits, lease
   transfers, node stops and restarts, and compares their range
   descriptors, leaseholders, raft terms and raw ``scan`` bytes after
   every step: both draw from their own seeded RNG in the same order, so
   they must elect, split and hand leases over identically.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_REF_IMPORT = re.compile(r"\bcockroach_tpu\.")


def reference_cases(ref_file: str, namespace: dict, replace=(),
                    bind=None, only=None) -> None:
    """Compile tests/<ref_file> with every ``cockroach_tpu.`` module path
    rewritten to ``cockroach_tpu_torch.`` (and each (old, new) pair of
    ``replace`` applied to its text), run it as a module of its own, and
    copy its test classes, test functions and fixtures into
    ``namespace`` (the calling test module's globals), so pytest collects
    the reference's cases against the port. ``bind`` maps names of that
    module to replacements installed after it ran (e.g. an Engine class
    bound to the CPU). ``only``, when given, names the test classes and
    functions to copy; the file's other cases are left out."""
    src = (ROOT / "tests" / ref_file).read_text()
    src = _REF_IMPORT.sub("cockroach_tpu_torch.", src)
    for old, new in replace:
        assert old in src, (ref_file, old)
        src = src.replace(old, new)
    mod = {"__name__": namespace["__name__"],
           "__file__": str(ROOT / "tests" / ref_file)}
    exec(compile(src, f"{ref_file} (on the port)", "exec"), mod)
    mod.update(bind or {})
    if only is not None:
        missing = set(only) - set(mod)
        assert not missing, (ref_file, missing)
    for name, obj in mod.items():
        if name.startswith("__"):
            continue
        if name.startswith(("Test", "test_")):
            if only is not None and name not in only:
                continue
            # a case of two reference files under one name would hide one
            assert name not in namespace, (ref_file, name)
        elif name in namespace:
            continue    # a helper: each case reads its own module's
        namespace[name] = obj


reference_cases("test_raft.py", globals())
reference_cases("test_ranges.py", globals())


# -- differential: the same seeded script on both Clusters ------------------

def _cluster_mod(pkg):
    return importlib.import_module(f"{pkg}.kvserver.cluster")


def _state(c) -> dict:
    """What must agree: every range's descriptor and leaseholder, each
    live replica's raft term and leadership, and the raw bytes a scan of
    the whole keyspace returns."""
    out = {"ranges": [], "raft": []}
    for rid, d in sorted(c.descriptors.items()):
        out["ranges"].append((rid, d.start_key, d.end_key,
                              tuple(d.replicas), c.leaseholder(rid)))
    for nid, s in sorted(c.stores.items()):
        if nid in c.down:
            continue
        for rid, rep in sorted(s.replicas.items()):
            out["raft"].append((nid, rid, rep.raft.term,
                                rep.raft.is_leader()))
    out["scan"] = [(k, v) for k, v in c.scan(b"a", b"z")]
    return out


def _drive(pkg: str) -> list:
    Cluster = _cluster_mod(pkg).Cluster
    c = Cluster(n_nodes=5, seed=7)
    c.create_range(b"a", b"z", replicas=[1, 2, 3])
    assert c.pump_until(lambda: c.ensure_lease(1) is not None)
    states = [_state(c)]
    for i in range(40):
        c.put(b"k%02d" % i, b"v%d" % i)
    states.append(_state(c))
    c.split_range(b"k20")
    c.split_range(b"k10")
    c.pump(5)
    states.append(_state(c))
    rid = c.range_for_key(b"k25").range_id
    target = [n for n in c.descriptors[rid].replicas
              if n != c.leaseholder(rid)][0]
    c.transfer_lease(rid, target)
    c.pump(5)
    for i in range(40, 60):
        c.put(b"k%02d" % (i % 40), b"w%d" % i)
    states.append(_state(c))
    victim = c.leaseholder(c.range_for_key(b"k05").range_id)
    c.stop_node(victim)
    c.pump(c.liveness.ttl + 2)
    c.put(b"k05", b"after-stop")
    states.append(_state(c))
    c.restart_node(victim)
    c.pump(30)
    c.put(b"k33", b"after-restart")
    c.pump(10)
    states.append(_state(c))
    return states


def test_seeded_clusters_agree_step_by_step():
    ref = _drive("cockroach_tpu")
    port = _drive("cockroach_tpu_torch")
    assert len(ref) == len(port)
    for step, (r, p) in enumerate(zip(ref, port)):
        assert p == r, f"step {step}"
    # the script moved something: splits, a transferred lease, writes
    assert len(port[-1]["ranges"]) == 3
    assert len(port[-1]["scan"]) == 40


# -- a reference fault the port repairs: a leader's empty snapshot -----------

def _snapshot_join(pkg: str) -> dict:
    """Range r1 on node 1 alone takes 200 values of 8,000 bytes (past the
    1 MiB raft log, so node 1 compacts it), nodes 2 and 3 join by
    snapshot, node 1 stops, and node 4 joins through the new leader,
    whose own log starts at the snapshot it restored. Which keys each
    new replica holds."""
    Cluster = _cluster_mod(pkg).Cluster
    c = Cluster(n_nodes=4, seed=5)
    c.create_range(b"a", b"z", replicas=[1])
    assert c.pump_until(lambda: c.ensure_lease(1) is not None)
    for i in range(200):
        c.put(b"k%04d" % i, b"x" * 8000)
    assert c.stores[1].replicas[1].raft.log.snapshot_index > 0
    for n in (2, 3):
        c.change_replicas(1, add=n)
        c.pump(50)
    c.stop_node(1)
    c.pump(c.liveness.ttl + 30)
    c.put(b"after", b"1")
    c.change_replicas(1, add=4)
    c.pump(80)
    ts = c.clock.now()
    return {n: [k for k in (b"k0000", b"k0199", b"after")
                if c.stores[n].replicas[1].mvcc.get(
                    k, ts, inconsistent=True) is not None]
            for n in (2, 3, 4)}


def test_leader_restored_from_a_snapshot_sends_its_state():
    """The reference's raft keeps a snapshot's state only on the node
    that compacted its log: a node whose log starts at a snapshot it
    restored sends, once it leads, an empty snapshot to a follower that
    needs the compacted prefix, and that follower silently holds none of
    the keys written before it. The port's raft keeps the restored
    snapshot's state (kvserver/raft.py ``_handle_snapshot``)."""
    every = [b"k0000", b"k0199", b"after"]
    assert _snapshot_join("cockroach_tpu_torch") == {
        2: every, 3: every, 4: every}
    lost = _snapshot_join("cockroach_tpu")[4]
    assert b"k0000" not in lost and b"after" in lost
