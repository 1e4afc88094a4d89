"""Node lifecycle: assemble the engine and serve clients.

The port of cockroach_tpu/server/node.py, single node (the reference's
pkg/server: ``NewServer`` server.go:203 wires the subsystems,
``AcceptClients`` server.go:1915 opens the pgwire listener). A Node owns
an Engine on its device (``cuda`` unless ``NodeConfig.device`` names
another; with no card and no device it raises), the pgwire server, the
HTTP status server and an optional maintenance loop (orphaned jobs, MVCC
GC, intents, time series; off unless
``NodeConfig.maintenance_interval`` is set); ``start()`` brings
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
leaseholders of ``NodeConfig.cluster``, a kvserver.Cluster whose
replicated ranges the node's engine serves its tables from; several
Nodes handed one Cluster serve the same data). The socket cluster
fabric (rpc, gossip, the status fan-out: tracez's ``?cluster=1``) and
``/_status/nodes`` are not ported yet: each answers 404 with "not yet
ported".
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

# endpoints of the reference's status server that need subsystems the
# port does not have yet (the socket cluster fabric)
NOT_PORTED = ("/_status/nodes",)


@dataclass
class NodeConfig:
    listen_host: str = "127.0.0.1"
    listen_port: int = 0          # 0 = ephemeral (tests); CLI default 26257
    http_port: int | None = 0     # status/metrics; None disables
    load_tpch_sf: float | None = None  # demo mode: preload TPC-H tables
    node_id: int = 1
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
    # of one logical cluster. With this set, the node's engine serves
    # DML, the catalog and jobs from replicated ranges (kv/rangekv.py)
    # instead of a node-local store
    cluster: object = None


def _statements_payload(engine) -> dict:
    """The /_status/statements body: raw totals and the log2 latency
    buckets beside the derived means and quantiles."""
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
        self.jobs.register(IMPORT_JOB, lambda: ImportResumer(self.engine))
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

    def _status_body(self, path: str, qs: dict):
        """(body, content type) of a GET, or None for a 404."""
        eng = self.engine
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
            if qs.get("cluster", ["0"])[0] == "1":
                raise NotImplementedError(
                    "/debug/tracez?cluster=1: the fan-out across peers is "
                    "not yet ported")
            payload = _tracez_payload(eng)
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

            def _not_ported(self, path: str) -> bool:
                if path in NOT_PORTED:
                    self._reply(404, f"{path}: not yet ported".encode())
                    return True
                return False

            def do_GET(self):
                url = urlparse(self.path)
                if self._not_ported(url.path):
                    return
                try:
                    out = node._status_body(url.path, parse_qs(url.query))
                except NotImplementedError as ex:
                    self._reply(404, f"{ex}".encode())
                    return
                except (KeyError, ValueError) as ex:
                    self._reply(400, str(ex).encode())
                    return
                if out is None:
                    self._reply(404, b"not found")
                    return
                self._reply(200, *out)

            def do_POST(self):
                path = urlparse(self.path).path
                if self._not_ported(path):
                    return
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

    def start(self) -> "Node":
        if self._started:
            return self
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
        if self.pg is not None:
            self.pg.stop()
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
