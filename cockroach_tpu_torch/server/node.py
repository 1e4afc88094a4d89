"""Node lifecycle: assemble the engine and serve clients.

The port of cockroach_tpu/server/node.py (the reference's pkg/server:
``NewServer`` server.go:203 wires the subsystems, ``AcceptClients``
server.go:1915 opens the pgwire listener). A Node owns an Engine on its
device (``cuda`` unless ``NodeConfig.device`` names another; with no card
and no device it raises), the pgwire server, the HTTP status server, the
cluster fabric when ``NodeConfig.rpc_port`` is set (a SocketTransport
with gossip of the cluster settings and node addresses, and a
PeerMonitor's heartbeats, on one background loop) and an optional
maintenance loop (orphaned jobs, MVCC GC, intents, time series; off
unless ``NodeConfig.maintenance_interval`` is set); ``start()`` brings
them up and returns once the SQL listener is bound.

Status endpoints: ``/healthz``, ``/_status/statements`` (per-fingerprint
statement statistics), ``/_status/tenants`` (application_name-keyed
rollups), ``/ts/query`` and ``/ts/metrics`` (the KV-backed time-series
DB, server/ts.py), the Prometheus text at ``/metrics`` and
``/_status/vars``, ``/debug/tracez`` (the engine's ring of slow
statements' trace recordings) and ``/_status/stmtdiag`` (GET: armed
requests and captured bundles; POST ``{"sql": ...}`` or
``{"fingerprint": ...}``: arm one) with ``/_status/stmtdiag/<id>`` (one
bundle), ``/_status/membership`` (this host's view of an elastic pod:
epoch, live set, suspects and the shard-lease assignment; ``{"elastic":
false}`` outside one) and ``/_debug/ranges`` (the range descriptors and
leaseholders of ``NodeConfig.cluster``, a kvserver.Cluster or
NetCluster whose replicated ranges the node's engine serves its tables
from; several Nodes handed one Cluster, or one NetCluster a process,
serve the same data) and ``/_status/nodes`` (this node and its fabric
peers' health, round trip and clock offset; without a fabric, its
NetCluster's peers by their replicated liveness). Over a NetCluster
(``enable_cluster_status``, called by ``start()``), ``?cluster=1`` on
``/debug/tracez``, ``/_status/statements`` and ``/_status/tenants``
fans out to every live peer over the cluster's "status" RPC, each peer
bounded by ``timeout=`` seconds (default 2), and merges: a peer that is
down or does not answer in time marks the result ``partial``.
"""

from __future__ import annotations

import http.server
import json
import threading
from dataclasses import dataclass
from urllib.parse import parse_qs, urlparse

from .. import __version__
from ..exec.engine import Engine
from ..utils import log
from .pgwire import PgServer
from .ts import TimeSeriesDB


@dataclass
class NodeConfig:
    listen_host: str = "127.0.0.1"
    listen_port: int = 0          # 0 = ephemeral (tests); CLI default 26257
    http_port: int | None = 0     # status/metrics; None disables
    load_tpch_sf: float | None = None  # demo mode: preload TPC-H tables
    # cluster fabric: this node's id + RPC port, and peer addresses to
    # join ({node_id: (host, port)}); rpc_port None disables the fabric
    node_id: int = 1
    rpc_port: int | None = None
    join: dict | None = None
    gossip_interval: float = 0.2
    # tests: a shared rpc.FaultInjector (seeded nemesis schedule for the
    # socket fabric); None = faults off
    fault_injector: object = None
    # background maintenance every this many seconds: orphaned-job
    # adoption, an MVCC GC pass over every user table, the
    # abandoned-intent sweep and the tsdb record + rollup pass; None
    # disables
    maintenance_interval: float | None = None
    # pgwire password gate: {user: cleartext password}; None = insecure
    # mode (the reference's --insecure), every user accepted
    auth: dict | None = None
    # TLS: directory holding node.crt/node.key (cli.py `cert` creates
    # them); None serves plaintext only
    certs_dir: str | None = None
    auth_method: str = "cleartext"
    # the engine's device: None = the CUDA card (raises without one)
    device: str | None = None
    # raft-replicated data plane: a kvserver.Cluster shared by the nodes
    # of one logical cluster, or this process's NetCluster. With this
    # set, the node's engine serves DML, the catalog and jobs from
    # replicated ranges (kv/rangekv.py) instead of a node-local store
    cluster: object = None


# -- cluster-wide status fan-out ----------------------------------------
# The payload builders are module-level so any NetCluster participant can
# serve them over the fabric's "status" RPC, including engines embedded
# in tests or tools that never construct a Node. A Node wires its own
# engine in through enable_cluster_status().

def _statements_payload(engine) -> dict:
    """The /_status/statements body: raw totals and the log2 latency
    buckets beside the derived means and quantiles, so a fan-out merge
    recombines fingerprints exactly instead of averaging averages."""
    return {"statements": [{
        "fingerprint": s.fingerprint,
        "count": s.count,
        "total_latency_s": s.total_latency_s,
        "mean_latency_s": s.mean_latency_s,
        "max_latency_s": s.max_latency_s,
        "p50_latency_s": s.p50_latency_s,
        "p95_latency_s": s.p95_latency_s,
        "p99_latency_s": s.p99_latency_s,
        "latency_buckets": list(s.latency_buckets),
        "total_compile_s": s.total_compile_s,
        "mean_compile_s": s.mean_compile_s,
        "mean_exec_s": s.mean_exec_s,
        "total_rows": s.total_rows,
        "failures": s.failures,
    } for s in engine.sqlstats.all()]}


def _tracez_payload(engine) -> dict:
    """The /debug/tracez body: the slow-statement ring (spans in the
    wire format of utils/tracing.py span_to_wire)."""
    return {"traces": list(engine.slow_traces)}


def _tenants_payload(engine) -> dict:
    """The /_status/tenants body: application_name-keyed rollups."""
    return {"tenants": [t.to_wire() for t in engine.sqlstats.tenants()]}


def membership_status() -> dict:
    """The /_status/membership body: this host's view of the elastic
    pod (epoch'd live set, per-member state and incarnation, heartbeat
    suspects, and the shard-lease assignment at the current epoch, read
    through the epoch-guarded LeaseView, never the raw lease records).
    ``{"elastic": false}`` when the pod is static or single-process
    (pkg/server/status.go NodesLiveness analogue)."""
    from ..parallel import multihost
    mem = multihost.membership()
    if mem is None:
        return {"elastic": False}
    view = mem.view()
    out = {
        "elastic": True,
        "host_id": mem.host_id,
        "incarnation": mem.incarnation,
        "epoch": view.epoch,
        "live": sorted(view.live),
        "members": {str(h): dict(view.members.get(str(h), {}))
                    for h in view.live},
        "suspects": sorted(mem.suspects(view.live)),
        "expelled": bool(mem.expelled()),
    }
    try:
        from ..distsql.leases import ShardLeases
        lv = ShardLeases(mem).view_at(view.epoch)
        out["leases"] = {
            t: {str(s): o for s, o in sorted(lv.assignment(t).items())}
            for t in sorted(lv.assignments)}
    except Exception:   # noqa: BLE001 — the lease table may not exist yet
        out["leases"] = {}
    return out


def register_status_sources(cluster, engine) -> None:
    """Expose this engine's tracez/statements/tenants payloads to peers
    over the NetCluster "status" RPC (the server side of ?cluster=1)."""
    cluster.status_handlers["tracez"] = lambda: _tracez_payload(engine)
    cluster.status_handlers["statements"] = \
        lambda: _statements_payload(engine)
    cluster.status_handlers["tenants"] = lambda: _tenants_payload(engine)


def _fanout_status(cluster, what: str,
                   timeout: float) -> tuple[dict, bool]:
    """Collect ``what`` payloads from every live peer. Liveness-gated (a
    node the cluster already believes dead costs nothing), each peer
    bounded by ``timeout``; a skipped or failed peer marks the result
    partial instead of failing the scrape."""
    results: dict[int, dict] = {}
    partial = False
    live = set(cluster.live_peers())
    with cluster._mu:
        known = sorted(cluster._peers)
    for nid in known:
        if nid == cluster.node_id:
            continue
        if nid not in live:
            partial = True
            continue
        try:
            results[nid] = cluster.call(nid, "status", {"what": what},
                                        timeout=timeout)
        except Exception:
            partial = True
    return results, partial


def _merge_tracez(own_id: int, local: dict, remote: dict,
                  partial: bool) -> dict:
    """Every node's slow-statement ring, each entry tagged with its
    node."""
    traces = [dict(t, node=own_id) for t in local["traces"]]
    for nid, payload in sorted(remote.items()):
        traces.extend(dict(t, node=nid)
                      for t in payload.get("traces", []))
    return {"traces": traces, "cluster": True, "partial": partial,
            "nodes": sorted([own_id, *remote])}


def _merge_statements(own_id: int, local: dict, remote: dict,
                      partial: bool) -> dict:
    """Per-fingerprint exact merge: sum the totals and bucket arrays,
    take the max of maxes, then re-derive means and quantiles from the
    combined values."""
    from ..utils.metric import buckets_quantile
    merged: dict[str, dict] = {}

    def fold(payload):
        for s in payload.get("statements", []):
            m = merged.get(s["fingerprint"])
            if m is None:
                merged[s["fingerprint"]] = dict(s)
                continue
            for k in ("count", "total_latency_s", "total_compile_s",
                      "total_rows", "failures"):
                m[k] += s[k]
            m["max_latency_s"] = max(m["max_latency_s"],
                                     s["max_latency_s"])
            m["latency_buckets"] = [
                a + b for a, b in zip(m["latency_buckets"],
                                      s["latency_buckets"])]

    fold(local)
    for _, payload in sorted(remote.items()):
        fold(payload)
    for m in merged.values():
        n = m["count"] or 1
        m["mean_latency_s"] = m["total_latency_s"] / n
        m["mean_compile_s"] = m["total_compile_s"] / n
        m["mean_exec_s"] = max(0.0, m["mean_latency_s"]
                               - m["mean_compile_s"])
        for q, k in ((0.50, "p50_latency_s"), (0.95, "p95_latency_s"),
                     (0.99, "p99_latency_s")):
            m[k] = buckets_quantile(m["latency_buckets"], q)
    stmts = sorted(merged.values(), key=lambda m: -m["total_latency_s"])
    return {"statements": stmts, "cluster": True, "partial": partial,
            "nodes": sorted([own_id, *remote])}


def _merge_tenants(own_id: int, local: dict, remote: dict,
                   partial: bool) -> dict:
    """Per-tenant exact merge: counters and seconds sum across nodes;
    hbm_bytes_held is a per-node high-water, so the cluster view takes
    the max (the tenant held at most that much on any one node)."""
    merged: dict[str, dict] = {}

    def fold(payload):
        for t in payload.get("tenants", []):
            m = merged.get(t["app_name"])
            if m is None:
                merged[t["app_name"]] = dict(t)
                continue
            for k in ("statements", "failures", "rows", "wall_seconds",
                      "device_seconds", "bytes_moved", "stall_seconds"):
                m[k] += t[k]
            m["hbm_bytes_held"] = max(m["hbm_bytes_held"],
                                      t["hbm_bytes_held"])

    fold(local)
    for _, payload in sorted(remote.items()):
        fold(payload)
    tenants = sorted(merged.values(), key=lambda m: -m["device_seconds"])
    return {"tenants": tenants, "cluster": True, "partial": partial,
            "nodes": sorted([own_id, *remote])}


_FANOUT = {"/debug/tracez": ("tracez", _tracez_payload, _merge_tracez),
           "/_status/statements": ("statements", _statements_payload,
                                   _merge_statements),
           "/_status/tenants": ("tenants", _tenants_payload,
                                _merge_tenants)}


def ranges_payload(cluster) -> dict:
    """The /_debug/ranges body: every range's descriptor and leaseholder
    (the ``cockroach debug`` analogue); no ranges without a cluster."""
    if cluster is None:
        return {"ranges": []}
    return {"ranges": [{
        "range_id": rid,
        "start": desc.start_key.decode("latin1"),
        "end": desc.end_key.decode("latin1"),
        "replicas": list(desc.replicas),
        "leaseholder": cluster.leaseholder(rid),
    } for rid, desc in sorted(cluster.descriptors.items())]}


class Node:
    def __init__(self, config: NodeConfig | None = None):
        self.config = config or NodeConfig()
        self.engine = Engine(device=self.config.device,
                             cluster=self.config.cluster)
        self.store = self.engine.store
        self.settings = self.engine.settings
        self.clock = self.engine.clock
        self.pg: PgServer | None = None
        self._http = None
        self._maint_stop = None
        self._started = False
        # metrics recorded into the KV plane by the maintenance loop
        self.tsdb = TimeSeriesDB(self.engine.kv, self.engine.metrics)
        # the engine's registry (schema-change, changefeed, backup,
        # restore and TTL resumers registered) and IMPORT's: the
        # maintenance loop adopts an orphaned job of any type through it
        from ..jobs import IMPORT_JOB, ImportResumer
        self.jobs = self.engine.jobs
        self.jobs.session_id = f"node-{self.config.node_id}"
        self.jobs.register(IMPORT_JOB, lambda: ImportResumer(self.engine))
        # the cluster fabric (_start_fabric) and the NetCluster serving
        # this node's status payloads to peers (enable_cluster_status)
        self.rpc = None
        self.gossip = None
        self.peer_monitor = None
        self._gossip_stop = None
        self._status_cluster = None
        self._maint_errors = self.engine.metrics.counter(
            "node.maintenance.errors",
            "maintenance-loop steps that raised (each is logged)")

    @property
    def sql_addr(self) -> tuple[str, int]:
        assert self.pg is not None, "node not started"
        return self.pg.addr

    @property
    def http_addr(self) -> tuple[str, int]:
        assert self._http is not None, "status server not started"
        return self._http.server_address[:2]

    def _nodes_payload(self) -> dict:
        """The /_status/nodes body (pkg/server/status.go Nodes, the
        backing of `node status`): this node and its fabric view. Without
        a fabric of its own, a node over a NetCluster lists that
        cluster's peers, healthy while their replicated liveness record
        is unexpired (``NetCluster.live_peers``; no round trip or clock
        offset is measured there)."""
        mon, c = self.peer_monitor, self._status_cluster
        peers = {}
        if mon is not None:
            ids = set(mon.misses) | set(mon.rtt_ns)
            peers = {str(p): {"healthy": mon.healthy(p),
                              "rtt_ns": mon.rtt_ns.get(p),
                              "clock_offset_ns": mon.offset_ns.get(p)}
                     for p in sorted(ids)}
        elif c is not None:
            live = set(c.live_peers())
            with c._mu:
                known = sorted(p for p in c._peers if p != c.node_id)
            peers = {str(p): {"healthy": p in live, "rtt_ns": None,
                              "clock_offset_ns": None} for p in known}
        return {"node_id": self.config.node_id, "version": __version__,
                "sql_addr": list(self.sql_addr),
                "tables": sorted(self.store.tables), "peers": peers}

    def _status_body(self, path: str, qs: dict):
        """(body, content type) of a GET, or None for a 404."""
        eng = self.engine
        c = self._status_cluster
        if path in _FANOUT and c is not None \
                and qs.get("cluster", ["0"])[0] == "1":
            what, local, merge = _FANOUT[path]
            remote, partial = _fanout_status(
                c, what, float(qs.get("timeout", ["2.0"])[0]))
            payload = merge(c.node_id, local(eng), remote, partial)
            return (json.dumps(payload, default=str).encode(),
                    "application/json")
        if path in ("/metrics", "/_status/vars"):
            return (eng.metrics.to_prometheus().encode(),
                    "text/plain; version=0.0.4")
        if path == "/ts/query":
            pts = self.tsdb.query(
                qs["name"][0], int(qs.get("start", ["0"])[0]),
                int(qs.get("end", [str(2**62)])[0]),
                downsample_s=int(qs.get("downsample", ["10"])[0]),
                agg=qs.get("agg", ["avg"])[0],
                rate=qs.get("rate", ["0"])[0] == "1")
            payload = pts
        elif path == "/ts/metrics":
            payload = self.tsdb.list_metrics()
        elif path == "/healthz":
            payload = {"status": "ok", "version": __version__,
                       "tables": len(self.store.tables),
                       "hbm_used_bytes": eng.hbm.used}
        elif path == "/_status/statements":
            payload = _statements_payload(eng)
        elif path == "/_status/tenants":
            payload = _tenants_payload(eng)
        elif path == "/debug/tracez":
            payload = _tracez_payload(eng)
        elif path == "/_status/nodes":
            payload = self._nodes_payload()
        elif path == "/_status/membership":
            payload = membership_status()
        elif path == "/_debug/ranges":
            payload = ranges_payload(self.config.cluster)
        elif path == "/_status/stmtdiag":
            payload = eng.stmtdiag.summary()
        elif path.startswith("/_status/stmtdiag/"):
            payload = eng.stmtdiag.get(int(path.rsplit("/", 1)[1]))
            if payload is None:
                return None
        else:
            return None
        return (json.dumps(payload, default=str).encode(),
                "application/json")

    def _start_status_server(self):
        """The status/metrics HTTP endpoint (pkg/server/status)."""
        node = self

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code: int, body: bytes,
                       ctype: str = "text/plain"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                try:
                    out = node._status_body(url.path, parse_qs(url.query))
                except (KeyError, ValueError) as ex:
                    self._reply(400, str(ex).encode())
                    return
                if out is None:
                    self._reply(404, b"not found")
                    return
                self._reply(200, *out)

            def do_POST(self):
                path = urlparse(self.path).path
                if path != "/_status/stmtdiag":
                    self._reply(404, b"not found")
                    return
                # arm a statement fingerprint: the next matching
                # execution captures a diagnostics bundle. Body:
                # {"sql": "..."} or {"fingerprint": "..."}
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if "fingerprint" in req:
                        out = node.engine.stmtdiag.arm(
                            str(req["fingerprint"]), is_fingerprint=True)
                    else:
                        out = node.engine.stmtdiag.arm(str(req["sql"]))
                except (KeyError, ValueError) as ex:
                    self._reply(400, str(ex).encode())
                    return
                self._reply(200, json.dumps(out).encode(),
                            "application/json")

        class Srv(http.server.ThreadingHTTPServer):
            daemon_threads = True

        self._http = Srv((self.config.listen_host, self.config.http_port),
                         H)
        threading.Thread(target=self._http.serve_forever,
                         kwargs={"poll_interval": 0.05},
                         name="status-http", daemon=True).start()

    def _start_fabric(self):
        """RPC listener + gossip loop (pkg/rpc, pkg/gossip): cluster
        settings set on any node converge on all of them, and a
        PeerMonitor's heartbeats, per-peer breakers and clock-offset
        checks ride the same loop (pkg/rpc/heartbeat.go)."""
        from ..rpc import Gossip, SocketTransport
        from ..rpc.gossip import wire_settings
        from ..rpc.heartbeat import PeerMonitor

        cfg = self.config
        self.rpc = SocketTransport(cfg.node_id, cfg.listen_host,
                                   cfg.rpc_port,
                                   injector=cfg.fault_injector)
        peers = [cfg.node_id]
        for nid, addr in (cfg.join or {}).items():
            self.rpc.connect(nid, tuple(addr))
            peers.append(nid)
        self.gossip = Gossip(cfg.node_id, self.rpc, peers=peers)
        self.peer_monitor = PeerMonitor(cfg.node_id, self.rpc)
        # extensible fabric dispatch: the monitor and gossip consume their
        # own payloads (handle() returns False otherwise); other
        # subsystems add themselves under a message "kind"
        self.rpc_handlers: dict[str, object] = {}

        def dispatch(frm, msg):
            if self.peer_monitor.handle(frm, msg):
                return
            if self.gossip.handle(frm, msg):
                return
            kind = msg.get("kind") if isinstance(msg, dict) else None
            h = self.rpc_handlers.get(kind)
            if h is not None:
                h(frm, msg)

        self.rpc.register(cfg.node_id, dispatch)
        wire_settings(self.gossip, self.settings)
        self.gossip.add_info(f"node:{cfg.node_id}:sql_addr",
                             list(self.sql_addr))
        stop = self._gossip_stop = threading.Event()
        # locals, not self.*: stop() clears the attributes while the
        # loop may still be mid-tick
        rpc, gossip, monitor = self.rpc, self.gossip, self.peer_monitor

        def loop():
            while not stop.is_set():
                gossip.tick()
                monitor.tick()
                rpc.deliver_all()
                stop.wait(cfg.gossip_interval)

        self._gossip_thread = threading.Thread(target=loop, name="gossip",
                                               daemon=True)
        self._gossip_thread.start()

    def connect_peer(self, node_id: int, rpc_addr) -> None:
        """Late join: learn a peer after startup."""
        assert self.rpc is not None, "the fabric is not started"
        self.rpc.connect(node_id, tuple(rpc_addr))
        if node_id not in self.gossip.peers:
            self.gossip.peers.append(node_id)

    def enable_cluster_status(self, cluster=None) -> "Node":
        """Join the cluster-wide status plane: serve this node's
        tracez/statements/tenants to peers over ``cluster``'s fabric and
        honour ?cluster=1 on the HTTP endpoints by fanning out over it.
        Default: the NodeConfig's cluster (``start()`` calls this; only a
        NetCluster, which has status handlers, takes part)."""
        c = cluster if cluster is not None else self.config.cluster
        if c is None or not hasattr(c, "status_handlers"):
            return self
        register_status_sources(c, self.engine)
        self._status_cluster = c
        return self

    def start(self) -> "Node":
        if self._started:
            return self
        self.enable_cluster_status()
        if self.config.load_tpch_sf is not None:
            from ..models import tpch
            tpch.load(self.engine, sf=self.config.load_tpch_sf)
        self.pg = PgServer(self.engine, self.config.listen_host,
                           self.config.listen_port, version=__version__,
                           auth=self.config.auth,
                           certs_dir=self.config.certs_dir,
                           auth_method=self.config.auth_method).start()
        if self.config.http_port is not None:
            self._start_status_server()
        if self.config.rpc_port is not None:
            self._start_fabric()
        if self.config.maintenance_interval is not None:
            self._start_maintenance()
        self._started = True
        log.structured(log.OPS, "node_start", node_id=self.config.node_id,
                       sql_addr="%s:%d" % self.pg.addr)
        return self

    def _start_maintenance(self):
        """Orphaned-job adoption (the reference's registry.go:1508
        adoption loop), MVCC GC passes (mvcc_gc_queue), the
        abandoned-intent sweep and the time-series passes, on a
        background cadence."""
        stop = self._maint_stop = threading.Event()

        def loop():
            while not stop.wait(self.config.maintenance_interval):
                self.maintain_once()

        self._maint_thread = threading.Thread(target=loop, daemon=True,
                                              name="node-maintenance")
        self._maint_thread.start()

    def maintain_once(self) -> None:
        """One maintenance pass (the loop's body; tests tick it). A step
        that raises is counted in ``node.maintenance.errors`` and logged,
        and the pass goes on with the next step (job failures also land
        in their records)."""
        self._maint_step("jobs", self.jobs.adopt_and_run_all)
        for name in list(self.engine.store.tables):
            if not name.startswith("__"):
                self._maint_step(f"gc {name}", self.engine.run_gc, name)
        self._maint_step("intents",
                         self.engine.kv.store.intent_resolver.clean_span)
        if self.engine.cluster is not None:
            # aged-out aborted txn records (gc/gc.go)
            self._maint_step("txn records",
                             self.engine.cluster.gc_txn_records)
        self._maint_step("tsdb", self._ts_pass)

    def _maint_step(self, what: str, fn, *args) -> None:
        try:
            fn(*args)
        except Exception as e:
            self._maint_errors.inc()
            log.error(log.OPS, "maintenance step %s failed: %s", what, e)

    def _ts_pass(self) -> None:
        self.tsdb.record()
        self.run_ts_maintenance()

    def run_ts_maintenance(self) -> None:
        """One tsdb rollup/prune pass with the fine-slab retention of
        ``timeseries.retention.seconds``."""
        self.tsdb.maintain(retention_fine_s=int(
            self.settings.get("timeseries.retention.seconds")))

    def stop(self):
        if self._maint_stop is not None:
            self._maint_stop.set()
            self._maint_thread.join(timeout=5)
            self._maint_stop = None
        if self._gossip_stop is not None:
            self._gossip_stop.set()
            self._gossip_thread.join(timeout=5)
            self._gossip_stop = None
        if self.rpc is not None:
            self.rpc.close()
            self.rpc = None
        if self.pg is not None:
            self.pg.stop()
            self.pg = None
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        if self._started:
            log.structured(log.OPS, "node_stop",
                           node_id=self.config.node_id)
        self._started = False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
