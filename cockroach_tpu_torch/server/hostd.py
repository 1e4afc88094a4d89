"""Per-host dispatcher process for a multi-host pod
(cockroach_tpu/server/hostd.py).

``python -m cockroach_tpu_torch.server.hostd --process-id I
--num-processes N --coordinator H:P`` joins the pod rendezvous
(parallel/multihost.py: a TCPStore served by host 0), builds this
host's engine with its OWN shard of the generated tables (host-owned
TableReader placement: host i holds rows ``[i*R/N, (i+1)*R/N)`` of
lineitem, part replicated), wires a framed SocketTransport to every
peer through the coordinator's KV store, and then:

- host 0 (the gateway) runs the requested statements through a
  ``Gateway`` whose ``merge_fanout`` arranges the partial-agg streams
  into the host merge tree, and prints ONE JSON line of results and
  per-host metrics to stdout;
- every other host pumps its transport, serving SetupFlow and
  merge-tree traffic, until the gateway posts the ``done`` key.

The engine runs on the card unless ``--device cpu`` asks for the CPU
(``--device cuda``, the default, raises without a card). ``--sf``
picks the generators' scale factor (default 0.01, the reference's);
``--rows`` caps lineitem's rows (default: the reference's 600 at sf
0.01, every row the generator makes at any other scale). With ``--sf 1``
each host cuts its shard from the full SF1 lineitem, made by the same
generator and seed as a single SF1 engine's.

Fault modes (``--fault``) let the cross-host ladder kill a dispatcher
or drop a merge link deterministically.

``--elastic`` switches to the DYNAMIC pod: no TCPStore, no fixed
--num-processes. Host 0 founds the pod (serves the socket KV
coordinator, writes its address to --kv-addr-file), waits for
--initial-hosts members, bootstraps the shard-lease table and runs the
statement loop; every other host points --kv-addr at the coordinator
and either joins the founding set or, with --late-join, joins a RUNNING
pod, streaming its new shards from their live owners before the lease
flip. --drain-after makes a worker leave in an orderly drain mid-run,
and --mem-fault injects membership-plane faults (delayed heartbeats,
stale-epoch lease claims). ``--sf`` and ``--rows`` work as in the
static mode: shard s of lineitem is rows ``[s*R/NSH, (s+1)*R/NSH)`` of
the generator at that scale and the single engine's seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from cockroach_tpu_torch.parallel import multihost

# combine-exact aggregate statement for the merge-tree ladder: Q1's
# AVGs are float folds in the reference (order-dependent, so flat
# fan-in by design), so the "groupby" rung is the Q1 pricing summary
# restricted to its exact sums + count
GROUPBY_SQL = (
    "SELECT l_returnflag, l_linestatus, "
    "sum(l_quantity) AS sum_qty, "
    "sum(l_extendedprice) AS sum_base_price, "
    "count(*) AS count_order "
    "FROM lineitem WHERE l_shipdate <= DATE '1998-09-02' "
    "GROUP BY l_returnflag, l_linestatus "
    "ORDER BY l_returnflag, l_linestatus")

# the reference's prefixes, and the socket fabric's frame counters
_METRIC_KEYS = ("shuffle.bytes.", "exec.multihost.", "distsql.flows",
                "exec.movement.exchange", "exec.agg.adaptive",
                "cluster.membership.", "exec.lease.",
                "exec.movement.rebalance", "distsql.degrade.",
                "distsql.failover.", "rpc.frames.")

REFERENCE_SF = 0.01
REFERENCE_ROWS = 600


def _queries():
    from cockroach_tpu_torch.models import tpch
    return {"q6": tpch.Q6, "groupby": GROUPBY_SQL, "join": tpch.Q14}


def _jsonable(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, (int, float, str)) or v is None:
        return v
    return str(v)      # Decimal/date render exactly; tests compare str


def _metric_slice(eng) -> dict:
    try:
        snap = eng.metrics.snapshot()
    except Exception:
        return {}
    return {k: v for k, v in snap.items()
            if isinstance(v, (int, float))
            and any(k.startswith(p) for p in _METRIC_KEYS)}


def _lineitem_rows(sf: float, rows) -> int | None:
    """lineitem's row cap: ``rows`` as given, else the reference's 600
    at its scale factor, else None (every generated row)."""
    if rows is not None:
        return rows
    return REFERENCE_ROWS if sf == REFERENCE_SF else None


def _build_engine(pid: int, nprocs: int, rows, sf: float = REFERENCE_SF,
                  device=None):
    """This host's engine over its OWN contiguous shard of lineitem
    (host-owned TableReader placement); part replicated. String columns
    ingest as codes under the generator's dictionaries (the rows are
    the object path's)."""
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    eng = Engine(device=device)
    eng.execute(tpch.DDL["lineitem"])
    eng.execute(tpch.DDL["part"])
    for cn, vals in tpch.LINEITEM_DICTS.items():
        eng.store.set_dictionary("lineitem", cn, vals)
    li = tpch.gen_lineitem(sf, rows=rows, encoded=True)
    n = len(li["l_orderkey"])
    lo, hi = pid * n // nprocs, (pid + 1) * n // nprocs
    ts = eng.clock.now()
    eng.store.insert_columns(
        "lineitem", {k: v[lo:hi] for k, v in li.items()}, ts)
    eng.store.insert_columns("part", tpch.gen_part(sf), ts)
    return eng, n


def _wire_transport(eng, topo, fault: str):
    """SocketTransport to every peer, addresses exchanged through the
    coordinator KV store."""
    from cockroach_tpu_torch.rpc.context import (FaultInjector,
                                                 SocketTransport)
    injector = None
    if fault == "drop-link" and topo.process_id == topo.num_processes - 1:
        # the highest host drops every frame toward its merge parent:
        # the parent's merge wait (or the gateway's idle deadline)
        # must turn that silence into FlowUnavailable, not a hang
        injector = FaultInjector(seed=topo.process_id)
        parent = topo.parent()
        injector.set_rule(topo.process_id,
                          0 if parent is None else parent, drop=1.0)
    transport = SocketTransport(topo.process_id, injector=injector)
    transport.attach_metrics(eng.metrics)
    host, port = transport.addr
    multihost.publish_flow_addr(host, port)
    for pid, addr in multihost.peer_flow_addrs().items():
        if pid != topo.process_id:
            transport.connect(pid, addr)
    multihost.register_teardown(transport.close)
    return transport


def _await_done() -> None:
    """Dead-dispatcher host: no serving, just wait for the gateway to
    finish so the pod tears down in one coordinated wave."""
    while multihost.kv_try_get("done") is None:
        time.sleep(0.01)


def _serve(transport) -> None:
    """Worker-host pump loop: deliver flow traffic until the gateway
    posts the done key (polled without blocking, so a frame never waits
    on the poll)."""
    while True:
        moved = transport.deliver_all()
        if moved or transport.pending():
            continue
        if multihost.kv_try_get("done") is not None:
            return
        time.sleep(0.005)


def _run_gateway(eng, transport, topo, args) -> dict:
    from cockroach_tpu_torch.distsql.node import DistSQLNode, Gateway
    own = DistSQLNode(0, eng, transport)
    gw = Gateway(own, list(range(topo.num_processes)),
                 replicated_tables={"part"},
                 flow_timeout=args.flow_timeout,
                 merge_fanout=args.fanout)
    out = {"hosts": topo.num_processes, "rows": args.rows,
           "fanout": args.fanout, "results": {}, "timings": {}}
    names = [q for q in args.queries.split(",") if q]
    qs = _queries()
    for name in names:
        best = first = None
        try:
            # repeat > 1 is the bench's warm-timing lever: the first
            # run pays planning and kernel loads on every host, later
            # runs measure the flow itself; best-of keeps the rate
            # honest
            for _ in range(max(1, args.repeat)):
                t0 = time.monotonic()
                res = gw.run(qs[name])
                dt = time.monotonic() - t0
                first = dt if first is None else first
                best = dt if best is None else min(best, dt)
        except Exception as e:     # noqa: BLE001 (the harness asserts
            # on this shape: a dead dispatcher must yield a clean,
            # typed error line, never a hang or a traceback on stdout)
            out["results"][name] = {
                "error": f"{type(e).__name__}: {e}"}
            continue
        out["results"][name] = {
            "names": list(res.names),
            "rows": [[_jsonable(v) for v in r] for r in res.rows]}
        out["timings"][name] = {"elapsed_s": best, "first_s": first,
                                "rows_per_s": args.rows / best}
    return out


def _gather_peer_metrics(topo) -> dict:
    out = {}
    for pid in range(1, topo.num_processes):
        try:
            out[str(pid)] = json.loads(
                multihost.kv_get(f"hostmetrics/{pid}", timeout_s=20.0))
        except Exception:
            out[str(pid)] = None    # died mid-run (fault ladder)
    return out


# ---------------------------------------------------------------------------
# elastic pod: dynamic membership + shard leases
# ---------------------------------------------------------------------------

def _elastic_recover(sf: float, rows, nshards: int):
    """Deterministic shard regeneration, the durable-storage stand-in
    every elastic host agrees on: shard s of lineitem is rows
    [s*R/NSH, (s+1)*R/NSH) of the seeded generator (encoded string
    columns, under tpch.LINEITEM_DICTS). The generator runs once per
    process, at the first shard asked for."""
    from cockroach_tpu_torch.models import tpch
    made: dict = {}

    def recover(table: str, sid: int) -> dict:
        assert table == "lineitem", table
        if not made:
            made.update(tpch.gen_lineitem(sf, rows=rows, encoded=True))
        n = len(made["l_orderkey"])
        lo = sid * n // nshards
        hi = (sid + 1) * n // nshards
        return {k: v[lo:hi] for k, v in made.items()}
    return recover


def _install_mem_faults(args) -> None:
    if args.mem_fault == "none":
        return
    f = multihost.MembershipFaults(
        heartbeat_delay_s=(args.liveness_window * 2.0
                           if args.mem_fault == "delayed-heartbeat"
                           else 0.0),
        stale_epoch_claims=(args.mem_fault == "stale-epoch"),
        hosts=(args.process_id,))
    multihost.install_membership_faults(f)


def connect_posted_peers(transport, known: set) -> None:
    """Connect ``transport`` to every host whose flow address is posted
    in the pod's KV and whose id is not in ``known`` (then added)."""
    for sid, raw in multihost.kv_list("flowaddr/").items():
        pid = int(sid)
        if pid not in known and raw:
            h, _, p = raw.rpartition(":")
            transport.connect(pid, (h, int(p)))
            known.add(pid)


def elastic_serve_step(transport, pod, known: set):
    """One pass of an elastic host's serve loop: connect newly posted
    peers, deliver the transport's frames, and run the idle-time lease
    reconcile unless a flow is producing. Returns None if the reconcile
    failed (the coordinator may be gone: the pod is tearing down), else
    whether frames moved or are pending."""
    connect_posted_peers(transport, known)
    moved = transport.deliver_all()
    if pod.node is None or not pod.node._producing:
        try:
            pod.reconcile()
        except Exception:   # noqa: BLE001 — reported to the caller
            return None
    return bool(moved or transport.pending())


def _elastic_serve(transport, pod, known: set, drain_after: float):
    """Elastic worker pump: flow traffic and the idle-time lease
    reconcile, until the gateway posts ``done`` (or the drain deadline
    lands)."""
    drain_at = (time.monotonic() + drain_after
                if drain_after > 0 else None)
    while True:
        busy = elastic_serve_step(transport, pod, known)
        if busy is None:
            return
        if drain_at is not None and time.monotonic() > drain_at:
            pod.drain_pod()
            return
        if busy:
            continue
        if multihost.kv_try_get("done"):
            return
        time.sleep(0.005)


def _elastic_main(args, device) -> int:
    from cockroach_tpu_torch.distsql import leases as L
    from cockroach_tpu_torch.distsql.node import DistSQLNode, Gateway
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.rpc.context import SocketTransport
    from cockroach_tpu_torch.server.node import membership_status
    from cockroach_tpu_torch.storage.hlc import Timestamp

    hid = args.process_id
    founder = not args.kv_addr
    eng = Engine(device=device)
    eng.execute(tpch.DDL["lineitem"])
    eng.execute(tpch.DDL["part"])
    eng.store.insert_columns("part", tpch.gen_part(args.sf),
                             Timestamp(1, 0))
    mem = multihost.init_elastic(
        hid, kv_addr=args.kv_addr, serve_kv=founder,
        fanout=max(1, args.fanout), metrics=eng.metrics,
        heartbeat_interval=args.heartbeat_interval,
        liveness_window=args.liveness_window)
    if founder and args.kv_addr_file:
        with open(args.kv_addr_file, "w") as f:
            f.write(multihost.elastic_kv_addr())
    _install_mem_faults(args)

    transport = SocketTransport(hid)
    transport.attach_metrics(eng.metrics)
    host, port = transport.addr
    multihost.kv_set(f"flowaddr/{hid}", f"{host}:{port}")
    multihost.register_teardown(transport.close)
    node = DistSQLNode(hid, eng, transport)
    keeper = L.ShardKeeper(eng)
    keeper.register_table("lineitem", tpch.DDL["lineitem"],
                          dictionaries=tpch.LINEITEM_DICTS)
    leases = L.ShardLeases(mem, metrics=eng.metrics)
    pod = L.ElasticPod(hid, mem, leases, keeper, node=node,
                       recover=_elastic_recover(args.sf, args.rows,
                                                args.nshards))

    known = {hid}
    if not founder:
        mem.start_heartbeat()
        if args.late_join:
            connect_posted_peers(transport, known)
            pod.join_pod(timeout_s=args.flow_timeout)
        else:
            mem.join()
        _elastic_serve(transport, pod, known, args.drain_after)
        try:
            multihost.kv_set(f"hostmetrics/{hid}",
                             json.dumps(_metric_slice(eng)))
        except Exception:
            pass
        time.sleep(0.2)
        eng.close()
        return 0

    # founder = gateway: wait for the founding member set, bootstrap the
    # lease table, then run the statement loop under churn
    mem.join()
    mem.start_heartbeat()
    deadline = time.monotonic() + args.flow_timeout
    while len(mem.view().live) < args.initial_hosts:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"elastic pod: {len(mem.view().live)} of "
                f"{args.initial_hosts} founding hosts joined")
        time.sleep(0.01)
    owners = sorted(mem.view().live)[:args.initial_hosts]
    pod.bootstrap("lineitem", tpch.DDL["lineitem"], args.nshards, owners)
    connect_posted_peers(transport, known)
    gw = Gateway(node, pod.data_nodes(),
                 replicated_tables={"part"},
                 flow_timeout=args.flow_timeout,
                 merge_fanout=args.fanout, elastic=pod)
    out = {"hosts": args.initial_hosts, "rows": args.rows,
           "fanout": args.fanout, "elastic": True, "sf": args.sf,
           "heartbeat_interval": args.heartbeat_interval,
           "liveness_window": args.liveness_window,
           "results": {}, "timings": {}, "runs": []}
    qs = _queries()
    names = [q for q in args.queries.split(",") if q]
    for name in names:
        best = first = None
        rows_out, consistent = None, True
        try:
            for _ in range(max(1, args.repeat)):
                connect_posted_peers(transport, known)
                pod.maybe_reconcile()
                e0 = mem.epoch()
                t0 = time.monotonic()
                res = gw.run(qs[name])
                dt = time.monotonic() - t0
                first = dt if first is None else first
                best = dt if best is None else min(best, dt)
                # the epochs around the run and the data hosts of each
                # (owners of some shard): a harness holds the hosts'
                # kernel launches against them
                e1 = mem.epoch()
                out["runs"].append({
                    "query": name, "seconds": dt,
                    "epoch_before": e0, "epoch_after": e1,
                    "owners_before": sorted(leases.view_at(e0)
                                            .owners("lineitem")),
                    "owners_after": sorted(leases.view_at(e1)
                                           .owners("lineitem"))})
                got = [[_jsonable(v) for v in r] for r in res.rows]
                if rows_out is None:
                    rows_out = got
                elif got != rows_out:
                    consistent = False
                if args.statement_gap > 0:
                    time.sleep(args.statement_gap)
        except Exception as e:  # noqa: BLE001 — the harness asserts shape
            out["results"][name] = {
                "error": f"{type(e).__name__}: {e}"}
            continue
        out["results"][name] = {"names": list(res.names),
                                "rows": rows_out,
                                "runs": max(1, args.repeat),
                                "consistent": consistent}
        out["timings"][name] = {"elapsed_s": best, "first_s": first,
                                "rows_per_s": args.rows / best}
    out["membership"] = membership_status()
    out["metrics"] = {"0": _metric_slice(eng)}
    multihost.kv_set("done", "1")
    for pid in sorted(int(s) for s in
                      multihost.kv_list("flowaddr/").keys()):
        if pid == hid:
            continue
        try:
            out["metrics"][str(pid)] = json.loads(
                multihost.kv_get(f"hostmetrics/{pid}", timeout_s=5.0))
        except Exception:
            out["metrics"][str(pid)] = None   # died or drained early
    print(json.dumps(out), flush=True)
    eng.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cockroach_tpu_torch.server.hostd")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--fanout", type=int,
                    default=multihost.DEFAULT_FANOUT,
                    help="merge-tree fanout; 0 = flat fan-in (A/B)")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (default cuda: raises "
                    "without a card; cpu runs the plain PyTorch path)")
    ap.add_argument("--sf", type=float, default=REFERENCE_SF,
                    help="TPC-H scale factor of the generated tables")
    ap.add_argument("--rows", type=int, default=None,
                    help="lineitem rows before sharding (default: 600 at "
                    "sf 0.01, else all of them)")
    ap.add_argument("--queries", default="q6,groupby,join")
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs per query; timings keep the best "
                    "(warm) one and the first")
    ap.add_argument("--flow-timeout", type=float, default=60.0)
    ap.add_argument("--fault", default="none",
                    choices=["none", "dispatcher-death", "drop-link"])
    # -- elastic pod ---------------------------------------------------
    ap.add_argument("--elastic", action="store_true",
                    help="dynamic-membership pod: shard leases, "
                    "online join/drain, statement failover")
    ap.add_argument("--kv-addr", default="",
                    help="elastic coordinator host:port (empty = "
                    "found the pod and serve the KV)")
    ap.add_argument("--kv-addr-file", default="",
                    help="founder writes its coordinator address "
                    "here for late joiners")
    ap.add_argument("--nshards", type=int, default=8)
    ap.add_argument("--initial-hosts", type=int, default=2,
                    help="founder bootstraps leases once this many "
                    "members joined")
    ap.add_argument("--late-join", action="store_true",
                    help="join a RUNNING pod: stream shards from "
                    "live owners, then flip")
    ap.add_argument("--drain-after", type=float, default=0.0,
                    help="worker drains out of the pod after this "
                    "many seconds (0 = never)")
    ap.add_argument("--statement-gap", type=float, default=0.0,
                    help="sleep between gateway statements (gives "
                    "churn a window to land mid-run)")
    ap.add_argument("--heartbeat-interval", type=float, default=0.1)
    ap.add_argument("--liveness-window", type=float, default=1.0)
    ap.add_argument("--mem-fault", default="none",
                    choices=["none", "delayed-heartbeat",
                             "stale-epoch"])
    args = ap.parse_args(argv)

    device = None if args.device == "cuda" else args.device
    if args.elastic:
        args.rows = _lineitem_rows(args.sf, args.rows)
        if args.rows is None:
            from cockroach_tpu_torch.models import tpch
            args.rows = int(tpch.LINEITEM_PER_SF * args.sf)
        return _elastic_main(args, device)

    topo = multihost.init_distributed(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        fanout=max(1, args.fanout))
    eng, args.rows = _build_engine(topo.process_id, topo.num_processes,
                                   _lineitem_rows(args.sf, args.rows),
                                   args.sf, device)
    transport = _wire_transport(eng, topo, args.fault)
    multihost.barrier("ready")
    dead = (args.fault == "dispatcher-death"
            and topo.process_id == topo.num_processes - 1)
    if dead:
        # kill the SERVING plane, not the process: closing the
        # listener drops every inbound SetupFlow/merge frame exactly
        # like a crashed dispatcher, while the store client stays up
        # (the control plane dying is a different fault than the data
        # plane dying, and this mode tests the latter)
        transport.close()

    if topo.is_gateway:
        out = _run_gateway(eng, transport, topo, args)
        out["metrics"] = {"0": _metric_slice(eng)}
        multihost.kv_set("done", "1")
        out["metrics"].update(_gather_peer_metrics(topo))
        print(json.dumps(out), flush=True)
    else:
        from cockroach_tpu_torch.distsql.node import DistSQLNode
        DistSQLNode(topo.process_id, eng, transport)
        if dead:
            _await_done()
        else:
            _serve(transport)
        multihost.kv_set(f"hostmetrics/{topo.process_id}",
                         json.dumps(_metric_slice(eng)))
    # the coordinator (process 0) serves the KV store until every host
    # has closed (multihost's shutdown barrier)
    eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
