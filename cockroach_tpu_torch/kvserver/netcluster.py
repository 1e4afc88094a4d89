"""Raft on the wire: a multi-process replicated cluster over TCP
(cockroach_tpu/kvserver/netcluster.py).

``NetCluster`` is the deployment form of the in-process ``Cluster``:
each OS process owns ONE Store; raft messages, proposals, lease
acquisition, liveness heartbeats, snapshots, and MVCC reads all ride
the socket RPC fabric (rpc/context.py), and N separate
``python -m cockroach_tpu_torch start --join`` processes
bootstrap/join into one replicated cluster.

Reference shape being rebuilt: the raft transport as a first-class RPC
service (pkg/kv/kvserver/raft_transport.go:152,183), node bootstrap /
join (pkg/server/node.go:303, server/init.go:517), and the DistSender
routing loop's NotLeaseholder retry (kv/kvclient/kvcoord/
dist_sender.go:795). Liveness is LINEARIZED: every node proposes its
``{epoch, expiration}`` record onto the system range holding
``LIVENESS_KEY`` (the reference stores the same records in a system
range, liveness.go:185), so lease validity is judged against a
raft-replicated record, not a per-observer gossip view. A partitioned
leaseholder cannot renew through quorum; its record expires on every
copy — including its own — and it fails CLOSED (exactly one valid
leaseholder across a split). Gossip heartbeats remain as a bring-up /
freshness hint, and the liveness range itself stays on the gossip
check (its renewals would otherwise need the very lease being
validated — the reference breaks the same cycle with expiration
leases there). Remaining design differences:

- Range descriptors propagate via generation-versioned broadcasts
  (higher generation wins) + the join snapshot, standing in for the
  meta ranges.
- One HLC per process, merged on every fabric message (hlc.Update),
  like the reference's clock propagation.

The drive model stays the deterministic tick/ready/step core
(kvserver/raft.py) — a per-process pump thread provides real time the
way the reference's raft scheduler goroutines do. Constants, timeouts,
the retry policy and the retry RNG's seed are the reference's, so both
packages make the same retries and draws.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..rpc.context import FaultInjector, SocketTransport
from ..rpc.retry import RetryPolicy
from ..utils import tracing
from ..utils.circuit import Breaker, BreakerTrippedError
from ..storage.hlc import MAX_TIMESTAMP, Clock, Timestamp
from ..storage.mvcc import TxnMeta, WriteIntentError, WriteTooOldError
from .cluster import (AmbiguousResultError, Cluster, NotLeaseholderError)
from .clusterversion import (BINARY_VERSION, ClusterVersion,
                             IncompatibleVersionError, Version)
from .liveness import NodeLiveness
from .raft import Entry, Message, MsgType, Snapshot
from .store import RangeDescriptor, Store, _dec_ts, _enc_ts


# ---------------------------------------------------------------------------
# raft payload <-> wire codec (rpc/context.py frames JSON + raw bytes)
# ---------------------------------------------------------------------------

def _msg_to_wire(m: Message) -> dict:
    d = {"t": m.type.value, "f": m.frm, "to": m.to, "tm": m.term,
         "li": m.log_index, "lt": m.log_term, "c": m.commit,
         "g": m.granted, "s": m.success, "mi": m.match_index,
         "e": [[e.term, e.index, e.data] for e in m.entries]}
    if m.snapshot is not None:
        d["sn"] = [m.snapshot.index, m.snapshot.term, m.snapshot.data]
    return d


def _wire_to_msg(d: dict) -> Message:
    sn = d.get("sn")
    return Message(
        type=MsgType(d["t"]), frm=d["f"], to=d["to"], term=d["tm"],
        log_index=d["li"], log_term=d["lt"],
        entries=[Entry(t, i, bytes(b)) for t, i, b in d["e"]],
        commit=d["c"], granted=d["g"], success=d["s"],
        match_index=d["mi"],
        snapshot=Snapshot(sn[0], sn[1], bytes(sn[2])) if sn else None)


def _payload_to_wire(payload) -> dict:
    range_id, (kind, body) = payload
    if kind == "msg":
        body = _msg_to_wire(body)
    return {"r": range_id, "k": kind, "b": body}


def _wire_to_payload(d: dict):
    body = d["b"]
    if d["k"] == "msg":
        body = _wire_to_msg(body)
    return (d["r"], (d["k"], body))


def _desc_to_wire(desc: RangeDescriptor) -> dict:
    return {"id": desc.range_id,
            "start": desc.start_key.decode("latin1"),
            "end": desc.end_key.decode("latin1"),
            "replicas": list(desc.replicas),
            "gen": desc.generation}


def _wire_to_desc(d: dict) -> RangeDescriptor:
    return RangeDescriptor(d["id"], d["start"].encode("latin1"),
                           d["end"].encode("latin1"),
                           list(d["replicas"]), generation=d["gen"])


class _RaftWire:
    """The LocalTransport facade the local Store speaks; every send
    becomes a framed fabric message (the raft_transport.go service)."""

    def __init__(self, nc: "NetCluster"):
        self.nc = nc
        self.handler = None
        self.sent = 0

    def register(self, node_id: int, handler) -> None:
        self.handler = handler

    def send(self, frm: int, to: int, payload) -> None:
        self.sent += 1
        self.nc._send(to, {"k": "raft", "p": _payload_to_wire(payload),
                           "hlc": self.nc.clock.now().to_int()})


class _RemoteMVCC:
    """MVCC read surface of a remote leaseholder (kv/rangekv.py and
    the txn push path consume exactly these five calls)."""

    def __init__(self, nc: "NetCluster", node_id: int, desc):
        self.nc = nc
        self.node_id = node_id
        self.desc = desc

    def _read(self, args: dict):
        args["range_id"] = self.desc.range_id
        return self.nc._route_read(self.desc, args,
                                   first=self.node_id)

    def get(self, key: bytes, read_ts: Timestamp, txn=None,
            inconsistent: bool = False):
        r = self._read({"op": "get", "key": key.decode("latin1"),
                        "ts": read_ts.to_int(),
                        "txn": txn.to_json().decode() if txn else None,
                        "inconsistent": inconsistent})
        if r is None:
            return None
        from ..storage.mvcc import MVCCValue
        return MVCCValue(key=key, ts=Timestamp.from_int(r["ts"]),
                         value=(bytes(r["value"])
                                if r["value"] is not None else None))

    def scan(self, start: bytes, end: bytes, read_ts: Timestamp,
             txn=None, max_keys: int = 0, inconsistent: bool = False,
             intents_out=None):
        r = self._read({"op": "scan", "start": start.decode("latin1"),
                        "end": end.decode("latin1"),
                        "ts": read_ts.to_int(),
                        "txn": txn.to_json().decode() if txn else None,
                        "max_keys": max_keys,
                        "inconsistent": inconsistent})
        from ..storage.mvcc import MVCCValue
        out = []
        for item in r["values"]:
            out.append(MVCCValue(
                key=bytes(item["key"]),
                ts=Timestamp.from_int(item["ts"]),
                value=(bytes(item["value"])
                       if item["value"] is not None else None)))
        if intents_out is not None:
            for k, meta in r.get("intents", []):
                intents_out.append(
                    (bytes(k), TxnMeta.from_json(bytes(meta))))
        return out

    def committed_versions(self, lo: bytes, hi: bytes):
        """Committed (non-provisional) raw versions in [lo, hi) —
        the scan-plane materialization feed (exec/dml.py)."""
        r = self._read({"op": "versions", "lo": lo.decode("latin1"),
                        "hi": hi.decode("latin1")})
        return [(bytes(k), tsi,
                 bytes(v) if v is not None else None)
                for k, tsi, v in r]

    def _meta(self, key: bytes) -> Optional[TxnMeta]:
        r = self._read({"op": "meta", "key": key.decode("latin1")})
        return TxnMeta.from_json(bytes(r)) if r is not None else None

    def has_writes_between(self, start: bytes, end: bytes,
                           t0: Timestamp, t1: Timestamp,
                           exclude_txn=None) -> bool:
        return self._read({
            "op": "writes_between", "start": start.decode("latin1"),
            "end": end.decode("latin1"), "t0": t0.to_int(),
            "t1": t1.to_int(), "exclude_txn": exclude_txn})


class RemoteReplica:
    """Leaseholder stub for a range whose lease lives on another
    process. propose_and_wait and the mvcc reads route over the
    fabric; everything else is deliberately absent (loud failure)."""

    def __init__(self, nc: "NetCluster", node_id: int, desc):
        self.nc = nc
        self.node_id = node_id
        self.desc = desc
        self.mvcc = _RemoteMVCC(nc, node_id, desc)

    def read(self, op: dict):
        """The op-dict read surface (Replica.read) over the fabric;
        bytes results come back intact through the frame codec."""
        r = self.nc._route_read(
            self.desc, {"op": "rep_read", "range_id":
                        self.desc.range_id, "body": op},
            first=self.node_id)
        if isinstance(r, dict) and r.get("__bytes__") is not None:
            return bytes(r["__bytes__"])
        if isinstance(r, list):
            return [tuple(bytes(x) if isinstance(x, (bytes, bytearray))
                          else x for x in item) if
                    isinstance(item, list) else item for item in r]
        return r


class _TimeoutError(RuntimeError):
    pass


class NetCluster(Cluster):
    """One process's view of a socket-replicated cluster.

    Reuses the in-process Cluster's replica/lease/propose machinery
    for the LOCAL store and overrides routing so remote leaseholders
    are RPC stubs. The deterministic pump becomes a background thread;
    propose waits become event waits signaled at apply time."""

    PUMP_INTERVAL = 0.005
    HEARTBEAT_EVERY = 4       # pump iterations between live broadcasts
    CALL_TIMEOUT = 15.0
    # per-ATTEMPT timeouts for routed requests: short enough that one
    # dead peer costs a couple of seconds, not CALL_TIMEOUT; the
    # per-peer breaker then fails subsequent attempts fast (see
    # ROBUSTNESS.md). Proposes get longer — raft commit is real work.
    READ_ATTEMPT_TIMEOUT = 2.0
    PROPOSE_ATTEMPT_TIMEOUT = 5.0
    PEER_BREAKER_COOLDOWN = 2.0
    ROUTE_POLICY = RetryPolicy(max_attempts=8, base_backoff=0.01,
                               max_backoff=0.25, deadline=None)
    # replicated liveness (a linearized control plane): each
    # node proposes {epoch, expiration} onto the system range holding
    # LIVENESS_KEY instead of trusting per-observer gossip expiry
    # (liveness.go:185 keeps the same record in a system range). A
    # partitioned leaseholder cannot renew through quorum, so its
    # record expires on every copy — including its own — and it FAILS
    # CLOSED (serving checks compare the replicated record).
    LIVENESS_KEY = b"\x00"
    LIVE_TTL_NS = 2_000_000_000          # 2s
    LIVE_HB_EVERY = 16                   # pump iterations (~80ms)

    def __init__(self, node_id: int, host: str = "127.0.0.1",
                 port: int = 0, join: dict | None = None,
                 clock: Clock | None = None, liveness_ttl: int = 40,
                 injector: FaultInjector | None = None):
        # deliberately NOT calling Cluster.__init__ (it builds N local
        # stores); replicate the attributes it sets
        self.node_id = node_id
        self.clock = clock or Clock()
        self.liveness = NodeLiveness(ttl_ticks=liveness_ttl)
        self.descriptors = {}
        self.down = set()
        self.breakers = {}
        # per-PEER breakers (the reference's per-replica breakers,
        # replica_circuit_breaker.go): a peer that times out trips its
        # breaker, and routed requests fail fast to the NEXT replica
        # instead of eating a full timeout serially. Inbound traffic
        # from the peer heals it (plus a cooldown half-open trial).
        self.peer_breakers: dict[int, Breaker] = {}
        self.range_load = {}
        self._next_range_id = 1
        self._retry_rng = random.Random(0xC0C0 ^ node_id)
        self.rpc = SocketTransport(node_id, host, port,
                                   injector=injector)
        self.wire = _RaftWire(self)
        self.stores = {node_id: Store(node_id, self.wire,
                                      clock=self.clock,
                                      liveness=self.liveness)}
        self.store = self.stores[node_id]
        self.liveness.heartbeat(node_id)
        self._mu = threading.RLock()
        self._raft_inbox = []
        self._calls: dict[str, dict] = {}
        self._lease_cache: dict[int, int] = {}
        self._peers: dict[int, tuple] = {}
        self._stop = threading.Event()
        self._pump_thread = None
        self._svc = ThreadPoolExecutor(max_workers=8,
                                       thread_name_prefix=f"nc{node_id}")
        self.rpc.register(node_id, self._dispatch)
        self._join_seeds = dict(join or {})
        self._hb_inflight = threading.Event()
        # cluster-wide status fan-out (server/node.py): named payload
        # providers served to peers over the "status" RPC method
        # (register_status_sources); empty dict = nothing to serve
        self.status_handlers: dict[str, object] = {}
        # mixed-version gating (kvserver/clusterversion.py): `binary`
        # overridable in tests to simulate an old/new binary
        self.version = ClusterVersion()

    # -- lifecycle ---------------------------------------------------------
    @property
    def addr(self):
        return self.rpc.addr

    def bootstrap(self, start: bytes = b"\x00",
                  end: bytes = b"\xff") -> None:
        """First node: create the initial keyspace range with this
        node as its only replica (server/init.go bootstrap)."""
        # a fresh cluster starts at the bootstrapping binary's version
        self.version.active = self.version.binary
        with self._mu:
            desc = RangeDescriptor(self._next_range_id, start, end,
                                   [self.node_id])
            self._next_range_id += 1
            self.descriptors[desc.range_id] = desc
            self.store.create_replica(desc)
        self.start()
        # win the single-member election + take the lease
        deadline = time.time() + 10
        while time.time() < deadline:
            with self._mu:
                rep = self.store.replicas[desc.range_id]
                if rep.raft.is_leader():
                    break
            time.sleep(0.02)
        self.ensure_lease(desc.range_id)

    def join(self) -> None:
        """Dial the seed(s), install the cluster snapshot, announce
        ourselves, and ask to be replicated onto."""
        self.start()
        for nid, addr in self._join_seeds.items():
            self.rpc.connect(int(nid), tuple(addr))
            self._peers[int(nid)] = tuple(addr)
        last = None
        for nid in list(self._join_seeds):
            try:
                r = self.call(int(nid), "join",
                              {"node_id": self.node_id,
                               "addr": list(self.addr),
                               "binary_version":
                                   str(self.version.binary)})
            except IncompatibleVersionError:
                raise
            except RuntimeError as e:
                last = e
                continue
            # joiner-side version check: refuse clusters running
            # features this binary does not have
            cv = r.get("cluster_version")
            if cv is not None:
                self.version.check_cluster(Version.parse(cv))
                self.version.active = Version.parse(cv)
            with self._mu:
                for pd in r["peers"]:
                    pid, paddr = pd["id"], tuple(pd["addr"])
                    if pid != self.node_id:
                        self.rpc.connect(pid, paddr)
                        self._peers[pid] = paddr
                for dd in r["descs"]:
                    self._install_desc(_wire_to_desc(dd))
                self._next_range_id = max(self._next_range_id,
                                          r["next_range_id"])
                # a REJOINING node may already be a member of ranges:
                # re-materialize local replicas so raft can catch us up
                # (snapshot or log replay from the leader)
                for desc in self.descriptors.values():
                    if self.node_id in desc.replicas and \
                            desc.range_id not in self.store.replicas:
                        self.store.create_replica(desc)
            return
        raise RuntimeError(f"join failed: {last}")

    def start(self) -> None:
        if self._pump_thread is not None:
            return
        self._stop.clear()
        self._pump_thread = threading.Thread(
            target=self._pump_loop, name=f"nc-pump-{self.node_id}",
            daemon=True)
        self._pump_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=5)
            self._pump_thread = None
        self._svc.shutdown(wait=False)
        self.rpc.close()

    # -- fabric ------------------------------------------------------------
    def _send(self, to: int, msg: dict) -> None:
        self.rpc.send(self.node_id, to, msg)

    def _broadcast(self, msg: dict) -> None:
        for nid in list(self._peers):
            self._send(nid, msg)

    def _dispatch(self, frm: int, msg) -> None:
        """Runs on the pump thread (rpc.deliver_all)."""
        if not isinstance(msg, dict):
            return
        # any traffic from a peer proves it is reachable again: heal
        # its breaker so routing stops failing fast to other replicas
        b = self.peer_breakers.get(frm)
        if b is not None and b.tripped:
            b.reset()
        hlc = msg.get("hlc")
        if hlc:
            self.clock.update(Timestamp.from_int(hlc))
        k = msg.get("k")
        if k == "raft":
            with self._mu:
                if self.wire.handler is not None:
                    self.wire.handler(frm, _wire_to_payload(msg["p"]))
            return
        if k == "live":
            with self._mu:
                rec = self.liveness.records.get(frm)
                if rec is None:
                    self.liveness.heartbeat(frm)
                    rec = self.liveness.records[frm]
                rec.epoch = max(rec.epoch, msg["epoch"])
                rec.expiration = self.liveness.now + self.liveness.ttl
            return
        if k == "desc":
            with self._mu:
                self._install_desc(_wire_to_desc(msg["d"]))
                self._next_range_id = max(self._next_range_id,
                                          msg.get("next_range_id", 0))
            return
        if k == "cv":
            try:
                v = Version.parse(msg["v"])
                if v <= self.version.binary and \
                        v > self.version.active:
                    self.version.active = v
            except (ValueError, KeyError):
                pass
            return
        if k == "peer":
            pid, paddr = msg["id"], tuple(msg["addr"])
            if pid != self.node_id and pid not in self._peers:
                self.rpc.connect(pid, paddr)
                self._peers[pid] = paddr
            return
        if k == "req":
            self._svc.submit(self._serve_req, frm, msg)
            return
        if k == "resp":
            slot = self._calls.pop(msg["id"], None)
            if slot is not None:
                slot["resp"] = msg
                slot["ev"].set()
            return

    def _install_desc(self, desc: RangeDescriptor) -> None:
        cur = self.descriptors.get(desc.range_id)
        if cur is None or desc.generation > cur.generation:
            self.descriptors[desc.range_id] = desc
            self._next_range_id = max(self._next_range_id,
                                      desc.range_id + 1)
            self._lease_cache.pop(desc.range_id, None)
            # membership changes materialize/remove the local replica
            if self.node_id in desc.replicas and \
                    desc.range_id not in self.store.replicas:
                self.store.create_replica(desc)
            if self.node_id not in desc.replicas and \
                    desc.range_id in self.store.replicas:
                self.store.remove_replica(desc.range_id)

    def _announce_desc(self, desc: RangeDescriptor) -> None:
        self._broadcast({"k": "desc", "d": _desc_to_wire(desc),
                         "next_range_id": self._next_range_id,
                         "hlc": self.clock.now().to_int()})

    # -- pump --------------------------------------------------------------
    def _pump_loop(self) -> None:
        from ..utils import log
        it = 0
        while not self._stop.is_set():
            it += 1
            # a single raised exception must not kill the ONLY thread
            # driving raft/liveness/delivery — that would wedge the
            # node silently (alive process, dead replica). Log and
            # keep pumping; the failed message/tick is retried or
            # superseded by raft's own retransmission.
            try:
                with self._mu:
                    self.liveness.tick()
                    self.liveness.heartbeat(self.node_id)
                    self.store.tick()
                    self.store.handle_ready_all()
                if it % self.HEARTBEAT_EVERY == 0:
                    epoch = self.liveness.epoch_of(self.node_id)
                    self._broadcast({"k": "live", "epoch": epoch,
                                     "hlc": self.clock.now().to_int()})
                if it % self.LIVE_HB_EVERY == 0 and \
                        self.version.is_active(
                            "replicated_liveness") and \
                        not self._hb_inflight.is_set():
                    # replicated heartbeat: proposed off-thread (the
                    # propose blocks on raft commit, and THIS thread
                    # must keep pumping for that commit to happen)
                    self._hb_inflight.set()
                    self._svc.submit(self._liveness_heartbeat)
                self.rpc.deliver_all()
                with self._mu:
                    self.store.handle_ready_all()
            except Exception as exc:
                log.error(log.OPS,
                          "netcluster pump iteration failed (n%d): "
                          "%s: %s", self.node_id,
                          type(exc).__name__, exc)
            self._stop.wait(self.PUMP_INTERVAL)

    def pump(self, iterations: int = 1) -> None:
        """Compatibility shim: background pump owns progress; callers
        that pumped inline just yield."""
        time.sleep(self.PUMP_INTERVAL * iterations)

    def pump_until(self, cond, max_iter: int = 500) -> bool:
        deadline = time.time() + max(max_iter * self.PUMP_INTERVAL, 5.0)
        while time.time() < deadline:
            with self._mu:
                if cond():
                    return True
            time.sleep(self.PUMP_INTERVAL)
        with self._mu:
            return cond()

    # -- request/response --------------------------------------------------
    def peer_breaker(self, nid: int) -> Breaker:
        b = self.peer_breakers.get(nid)
        if b is None:
            b = Breaker(f"n{self.node_id}->n{nid}", threshold=1,
                        cooldown=self.PEER_BREAKER_COOLDOWN)
            self.peer_breakers[nid] = b
        return b

    def attach_metrics(self, reg) -> None:
        """Surface this node's fabric + breaker state in a
        MetricRegistry: transport frame counters, aggregate breaker
        counters, and a per-peer gauge family refreshed by a
        collector (peers appear dynamically as the cluster grows)."""
        self.rpc.attach_metrics(reg)
        reg.func_counter(
            "breaker.peer.trips",
            lambda: sum(b.trip_count
                        for b in self.peer_breakers.values()),
            "total peer-breaker trips on this node")
        reg.func_gauge(
            "breaker.peer.tripped.current",
            lambda: sum(1 for b in self.peer_breakers.values()
                        if b.tripped),
            "peer breakers currently open")
        reg.func_gauge(
            "breaker.peer.failures",
            lambda: sum(b.failures
                        for b in self.peer_breakers.values()),
            "consecutive failures across peer breakers")

        def _per_peer():
            for nid, b in list(self.peer_breakers.items()):
                reg.gauge(f"breaker.peer.n{nid}.tripped",
                          "1 while this peer's breaker is open").set(
                    1.0 if b.tripped else 0.0)
                reg.gauge(f"breaker.peer.n{nid}.trips",
                          "trips of this peer's breaker").set(
                    b.trip_count)
        reg.add_collector(_per_peer)

    def call(self, to: int, method: str, args: dict,
             timeout: float = None):
        b = self.peer_breaker(to)
        b.check()                 # BreakerTrippedError: fail fast
        rid = uuid.uuid4().hex[:16]
        slot = {"ev": threading.Event()}
        self._calls[rid] = slot
        req = {"k": "req", "id": rid, "m": method, "a": args,
               "hlc": self.clock.now().to_int()}
        # piggyback the active trace context so the remote node can
        # record its handler under our trace and ship the subtree back
        tc = tracing.trace_context()
        if tc is not None:
            req["tc"] = tc
        self._send(to, req)
        if not slot["ev"].wait(timeout or self.CALL_TIMEOUT):
            self._calls.pop(rid, None)
            b.report_failure()
            raise _TimeoutError(f"rpc {method} to n{to} timed out")
        b.report_success()
        resp = slot["resp"]
        if resp.get("sp"):
            tracing.attach_remote(resp["sp"])
        if resp.get("ok"):
            return resp.get("result")
        raise self._decode_err(resp["err"])

    @staticmethod
    def _decode_err(e: dict) -> Exception:
        t = e.get("type")
        if t == "not_leaseholder":
            return NotLeaseholderError(e.get("range_id"),
                                       e.get("hint"))
        if t == "write_intent":
            return WriteIntentError(
                bytes(e["key"]), TxnMeta.from_json(bytes(e["meta"])))
        if t == "write_too_old":
            return WriteTooOldError.with_actual(
                bytes(e["key"]), Timestamp.from_int(e["actual_ts"]))
        if t == "ambiguous":
            return AmbiguousResultError(e.get("msg", ""))
        if t == "key":
            return KeyError(e.get("msg", ""))
        if t == "version":
            return IncompatibleVersionError(e.get("msg", ""))
        return RuntimeError(e.get("msg", "remote error"))

    @staticmethod
    def _encode_err(exc: Exception) -> dict:
        if isinstance(exc, NotLeaseholderError):
            return {"type": "not_leaseholder",
                    "range_id": exc.range_id, "hint": exc.hint}
        if isinstance(exc, WriteIntentError):
            return {"type": "write_intent", "key": exc.key,
                    "meta": exc.txn_meta.to_json()}
        if isinstance(exc, WriteTooOldError):
            return {"type": "write_too_old", "key": exc.key,
                    "actual_ts": exc.actual_ts.to_int()}
        if isinstance(exc, AmbiguousResultError):
            return {"type": "ambiguous", "msg": str(exc)}
        if isinstance(exc, KeyError):
            return {"type": "key", "msg": str(exc)}
        if isinstance(exc, IncompatibleVersionError):
            return {"type": "version", "msg": str(exc)}
        return {"type": "runtime",
                "msg": f"{type(exc).__name__}: {exc}"}

    def _serve_req(self, frm: int, msg: dict) -> None:
        # when the caller sent a trace context, serve under a local
        # recording and ship the finished subtree back on the response
        # (the reference piggybacks recordings on BatchResponse)
        tc = msg.get("tc")
        rec = None
        try:
            # record only when the caller set the per-statement
            # recording-request bit (SET tracing = cluster / EXPLAIN
            # ANALYZE); a bare context correlates but stays dark here
            if tc and tc.get("rec"):
                with tracing.capture(f"rpc:{msg['m']}", remote_ctx=tc,
                                     node=self.node_id) as rec:
                    result = self._serve(frm, msg["m"], msg["a"])
            else:
                result = self._serve(frm, msg["m"], msg["a"])
            out = {"k": "resp", "id": msg["id"], "ok": True,
                   "result": result,
                   "hlc": self.clock.now().to_int()}
        except Exception as exc:   # serialized back to the caller
            out = {"k": "resp", "id": msg["id"], "ok": False,
                   "err": self._encode_err(exc),
                   "hlc": self.clock.now().to_int()}
        if rec is not None:
            out["sp"] = tracing.span_to_wire(rec)
        self._send(frm, out)

    # -- the service (server side of the stubs) ----------------------------
    def _serve(self, frm: int, method: str, args: dict):
        if method == "join":
            return self._serve_join(args)
        if method == "propose":
            return self._serve_propose(args)
        if method == "read":
            return self._serve_read(args)
        if method == "create_replica":
            with self._mu:
                desc = _wire_to_desc(args["desc"])
                if desc.range_id not in self.store.replicas:
                    self.store.create_replica(desc)
            return True
        if method == "remove_replica":
            with self._mu:
                self.store.remove_replica(args["range_id"])
            return True
        if method == "replicate_me":
            return self.replicate_queue_scan()
        if method == "status":
            h = self.status_handlers.get(args.get("what"))
            if h is None:
                raise RuntimeError(
                    f"no status source {args.get('what')!r} on "
                    f"n{self.node_id}")
            return h()
        raise RuntimeError(f"unknown method {method!r}")

    def _serve_join(self, args: dict):
        nid, addr = int(args["node_id"]), tuple(args["addr"])
        # dial the joiner FIRST: the refusal below must be deliverable
        # (a connection is not membership — the peer broadcast that
        # admits the node into the gossip mesh only happens on accept)
        self.rpc.connect(nid, addr)
        bv = args.get("binary_version")
        if bv is not None:
            # seed-side admission: binaries older than the minimum
            # supported version cannot apply this cluster's commands
            self.version.check_join(Version.parse(bv))
        with self._mu:
            self.rpc.connect(nid, addr)
            self._peers[nid] = addr
            self.liveness.heartbeat(nid)
            peers = [{"id": self.node_id, "addr": list(self.addr)}]
            for pid, paddr in self._peers.items():
                if pid != nid:
                    peers.append({"id": pid, "addr": list(paddr)})
            descs = [_desc_to_wire(d)
                     for d in self.descriptors.values()]
            nri = self._next_range_id
        self._broadcast({"k": "peer", "id": nid, "addr": list(addr),
                         "hlc": self.clock.now().to_int()})
        return {"peers": peers, "descs": descs, "next_range_id": nri,
                "cluster_version": str(self.version.active)}

    def _serve_propose(self, args: dict):
        rid = args["range_id"]
        cmd = args["cmd"]
        with self._mu:
            rep = self.store.replicas.get(rid)
            desc = self.descriptors.get(rid)
        if rep is None:
            raise NotLeaseholderError(
                rid, desc.replicas[0] if desc else None)
        if not self._lease_valid(rep):
            lh = self._try_local_lease(rid)
            if lh != self.node_id:
                tracing.event("lease-check", range_id=rid, ok=False,
                              holder=lh or rep.lease.holder)
                raise NotLeaseholderError(rid, lh or rep.lease.holder)
        tracing.event("lease-check", range_id=rid, ok=True,
                      holder=self.node_id)
        return self._local_propose(rep, cmd)

    def _serve_read(self, args: dict):
        rid = args["range_id"]
        with self._mu:
            rep = self.store.replicas.get(rid)
        if rep is None or not self._lease_valid(rep):
            hint = rep.lease.holder if rep is not None else None
            tracing.event("lease-check", range_id=rid, ok=False,
                          holder=hint)
            raise NotLeaseholderError(rid, hint)
        tracing.event("lease-check", range_id=rid, ok=True,
                      holder=self.node_id)
        txn = (TxnMeta.from_json(args["txn"].encode())
               if args.get("txn") else None)
        op = args["op"]
        with self._mu:
            if op == "rep_read":
                r = rep.read(args["body"])
                if isinstance(r, bytes):
                    return {"__bytes__": r}
                return r
            if op == "get":
                mv = rep.mvcc.get(args["key"].encode("latin1"),
                                  Timestamp.from_int(args["ts"]),
                                  txn=txn,
                                  inconsistent=args.get("inconsistent",
                                                        False))
                return None if mv is None else {
                    "ts": mv.ts.to_int(), "value": mv.value}
            if op == "scan":
                intents: list = []
                vals = rep.mvcc.scan(
                    args["start"].encode("latin1"),
                    args["end"].encode("latin1"),
                    Timestamp.from_int(args["ts"]), txn=txn,
                    max_keys=args.get("max_keys", 0),
                    inconsistent=args.get("inconsistent", False),
                    intents_out=intents)
                return {"values": [{"key": v.key, "ts": v.ts.to_int(),
                                    "value": v.value} for v in vals],
                        "intents": [[k, m.to_json()]
                                    for k, m in intents]}
            if op == "meta":
                meta = rep.mvcc._meta(args["key"].encode("latin1"))
                return meta.to_json() if meta is not None else None
            if op == "versions":
                return [list(t) for t in rep.mvcc.committed_versions(
                    args["lo"].encode("latin1"),
                    args["hi"].encode("latin1"))]
            if op == "writes_between":
                return rep.mvcc.has_writes_between(
                    args["start"].encode("latin1"),
                    args["end"].encode("latin1"),
                    Timestamp.from_int(args["t0"]),
                    Timestamp.from_int(args["t1"]),
                    exclude_txn=args.get("exclude_txn"))
        raise RuntimeError(f"unknown read op {op!r}")

    def finalize_version(self, v: "Version" = None) -> None:
        """Ratchet the cluster's active version and broadcast it (the
        SET CLUSTER SETTING version finalization; pkg/upgrade runs
        migrations here — our feature gates flip behavior instead)."""
        v = v or self.version.binary
        self.version.activate(v)
        self._broadcast({"k": "cv", "v": str(v),
                         "hlc": self.clock.now().to_int()})

    # -- replicated liveness ------------------------------------------
    def _liveness_heartbeat(self) -> None:
        """Propose this node's {epoch, expiration} onto the system
        range (runs on the service executor; see pump loop)."""
        try:
            now = self.clock.now().to_int()
            with self._mu:
                cur = self.store.repl_liveness.get(self.node_id)
            if cur is None:
                ep = max(1, self.liveness.epoch_of(self.node_id))
            elif cur[1] < now:
                # our record lapsed (partition/stall): rejoin at a NEW
                # epoch so leases taken under the old one stay fenced
                ep = cur[0] + 1
            else:
                ep = cur[0]
            self._propose_liveness({"kind": "live_hb",
                                    "node": self.node_id, "epoch": ep,
                                    "exp": now + self.LIVE_TTL_NS})
        except Exception:
            pass                 # retried on the next beat
        finally:
            self._hb_inflight.clear()

    def _propose_liveness(self, cmd: dict):
        desc = None
        with self._mu:
            for d in self.descriptors.values():
                if d.start_key <= self.LIVENESS_KEY < d.end_key:
                    desc = d
                    break
        if desc is None:
            return None
        with self._mu:
            rep = self.store.replicas.get(desc.range_id)
        # the gossip-level lease check on purpose: a live_hb proposal
        # must not require a replicated-liveness-valid lease (that is
        # the record it renews — the reference breaks the same cycle
        # by keeping the liveness range itself on expiration leases)
        if rep is not None and rep.holds_lease():
            return self._local_propose(rep, cmd, timeout=3.0)
        return self._route_propose(desc, dict(cmd), timeout=1.0)

    def _holder_live(self, holder: int, lease_epoch: int) -> bool:
        """Is `holder`'s lease at `lease_epoch` backed by a current
        liveness record? The REPLICATED record is authoritative once
        present; gossip covers bring-up."""
        rec = self.store.repl_liveness.get(holder)
        if rec is not None:
            ep, exp = rec
            return ep == lease_epoch and \
                exp >= self.clock.now().to_int()
        return self.liveness.is_live(holder) and \
            self.liveness.epoch_of(holder) == lease_epoch

    def live_peers(self) -> list[int]:
        """Peers worth an RPC right now: every connected peer whose
        replicated liveness record is unexpired at this clock (gossip
        liveness covers bring-up, before the replicated plane runs).
        Gates the status fan-out so a scrape never waits a timeout on
        a node the cluster already believes dead."""
        now = self.clock.now().to_int()
        out = []
        with self._mu:
            peers = list(self._peers)
            recs = dict(self.store.repl_liveness)
        for nid in peers:
            rec = recs.get(nid)
            if rec is not None:
                if rec[1] >= now:
                    out.append(nid)
            elif self.liveness.is_live(nid):
                out.append(nid)
        return out

    def _lease_valid(self, rep) -> bool:
        """Serving-side check: beyond holds_lease()'s gossip view, the
        holder's replicated record must be unexpired at this node's
        clock — a partitioned ex-leaseholder cannot renew it through
        quorum, so it fails closed here after the TTL. The range
        holding the liveness records themselves is exempt (renewals
        ride it; the reference keeps that range on expiration leases
        for the same circularity)."""
        if not rep.holds_lease():
            return False
        d = rep.desc
        if d.start_key <= self.LIVENESS_KEY < d.end_key:
            return True
        rec = self.store.repl_liveness.get(self.node_id)
        if rec is None:
            return True          # replicated plane not active yet
        ep, exp = rec
        return ep == rep.lease.epoch and \
            exp >= self.clock.now().to_int()

    # -- lease + routing ---------------------------------------------------
    def leaseholder(self, range_id: int) -> Optional[int]:
        with self._mu:
            rep = self.store.replicas.get(range_id)
            if rep is not None and rep.lease.holder:
                h = rep.lease.holder
                if self._holder_live(h, rep.lease.epoch):
                    return h
                return None
        return self._lease_cache.get(range_id)

    def _try_local_lease(self, range_id: int) -> Optional[int]:
        """Acquire locally when the record is vacant/fenced and we can
        (raft leader acquires immediately, like the reference)."""
        with self._mu:
            rep = self.store.replicas.get(range_id)
        if rep is None:
            return None
        if self._lease_valid(rep):
            return self.node_id
        with self._mu:
            holder = rep.lease.holder
            holder_ok = (holder and holder != self.node_id
                         and self._holder_live(holder,
                                               rep.lease.epoch))
        if holder_ok:
            return holder
        if self.acquire_lease(range_id, self.node_id, max_iter=300):
            return self.node_id
        return None

    def ensure_lease(self, range_id: int) -> Optional[int]:
        lh = self.leaseholder(range_id)
        if lh is not None:
            return lh
        return self._try_local_lease(range_id)

    def acquire_lease(self, range_id: int, node_id: int,
                      max_iter: int = 500) -> bool:
        assert node_id == self.node_id, \
            "NetCluster acquires leases only for its own store"
        with self._mu:
            rep = self.store.replicas.get(range_id)
            rec = self.store.repl_liveness.get(node_id)
        if rep is None:
            return False
        is_live_range = (rep.desc.start_key <= self.LIVENESS_KEY
                         < rep.desc.end_key)
        if not is_live_range and rec is not None \
                and rec[1] < self.clock.now().to_int():
            # our replicated record lapsed: a lease under the stale
            # epoch would be born fenced — renew (and epoch-bump)
            # first, synchronously. (Not for the liveness range
            # itself: the renewal NEEDS that lease.)
            self._liveness_heartbeat()
            with self._mu:
                rec = self.store.repl_liveness.get(node_id)
        epoch = rec[0] if rec is not None \
            else self.liveness.epoch_of(node_id)
        try:
            self._local_propose(rep, {
                "kind": "lease", "holder": node_id, "epoch": epoch},
                timeout=max(max_iter * self.PUMP_INTERVAL, 3.0))
        except (RuntimeError, AmbiguousResultError):
            return False
        with self._mu:
            return rep.holds_lease()

    def _leaseholder_replica(self, key: bytes):
        desc = self.range_for_key(key)
        if desc is None:
            raise KeyError(f"no range for key {key!r}")
        b = self.breaker(desc.range_id)
        b.check()
        self.range_load[desc.range_id] = \
            self.range_load.get(desc.range_id, 0) + 1
        # local fast path
        with self._mu:
            rep = self.store.replicas.get(desc.range_id)
        if rep is not None:
            lh = self._try_local_lease(desc.range_id)
            if lh == self.node_id:
                return rep
            if lh is not None:
                self._lease_cache[desc.range_id] = lh
                return RemoteReplica(self, lh, desc)
        hint = self._lease_cache.get(desc.range_id)
        order = ([hint] if hint in desc.replicas else []) + \
            [n for n in desc.replicas if n != hint]
        target = next((n for n in order if n != self.node_id),
                      None)
        if target is None:
            b.report_failure()
            raise RuntimeError(f"r{desc.range_id}: no leaseholder")
        return RemoteReplica(self, target, desc)

    def propose_and_wait(self, rep, cmd: dict, max_iter: int = 500):
        if isinstance(rep, RemoteReplica):
            return self._route_propose(rep.desc, cmd,
                                       first=rep.node_id)
        return self._local_propose(rep, cmd)

    def _local_propose(self, rep, cmd: dict, timeout: float = 10.0):
        out = {}
        ev = threading.Event()

        def cb(result):
            out["result"] = result
            ev.set()

        # raft lifecycle span events, proposer-side (apply itself
        # runs on the pump thread, so the commit is observed here —
        # the waiter callback fires at apply time)
        tracing.event("raft-propose", range_id=rep.desc.range_id,
                      kind=str(cmd.get("kind", "batch")),
                      node=self.node_id)
        reached = False
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._mu:
                ok = rep.propose(cmd, cb)
            if ok:
                reached = True
                if ev.wait(min(3.0, max(deadline - time.time(),
                                        0.05))):
                    tracing.event("raft-apply",
                                  range_id=rep.desc.range_id,
                                  node=self.node_id)
                    return out["result"]
            else:
                time.sleep(self.PUMP_INTERVAL * 4)
        with self._mu:
            rep._waiters.pop(cmd.get("_id", ""), None)
            applied = cmd.get("_id", "") in rep._applied_ids
        if applied or reached:
            raise AmbiguousResultError(
                "proposal handed to raft but not observed to commit")
        raise RuntimeError("proposal did not commit (quorum lost?)")

    def _route_propose(self, desc, cmd: dict, first: int = None,
                       timeout: float = None):
        """DistSender's NotLeaseholder retry loop over the fabric.

        The dedup id is assigned CLIENT-side before the first ship:
        a propose whose response times out may still have committed,
        and a retry on another replica with a fresh server-assigned id
        would double-apply — with the caller's id, the apply-time
        dedup window (store.py _applied_ids, replicated state) makes
        the retry idempotent."""
        if "_id" not in cmd:
            cmd["_id"] = f"{self.node_id}.{uuid.uuid4().hex[:16]}"
        timed_out = False
        tried = []
        attempt = 0
        nid = first if first is not None else \
            (self._lease_cache.get(desc.range_id)
             or desc.replicas[0])
        for _ in range(2 * len(desc.replicas) + 2):
            if nid is None or nid in tried:
                nid = next((n for n in desc.replicas
                            if n not in tried), None)
                if nid is None:
                    break
            if nid == self.node_id:
                with self._mu:
                    rep = self.store.replicas.get(desc.range_id)
                if rep is not None and \
                        self._try_local_lease(desc.range_id) \
                        == self.node_id:
                    return self._local_propose(rep, cmd)
                tried.append(nid)
                nid = None
                continue
            try:
                with tracing.span("rpc-attempt", node=nid,
                                  attempt=attempt, method="propose"):
                    r = self.call(nid, "propose",
                                  {"range_id": desc.range_id,
                                   "cmd": cmd},
                                  timeout=(timeout or
                                           self.PROPOSE_ATTEMPT_TIMEOUT))
                self._lease_cache[desc.range_id] = nid
                return r
            except NotLeaseholderError as e:
                tried.append(nid)
                nid = e.hint
            except BreakerTrippedError:
                # peer known-dead: fail fast to the next replica,
                # no wait at all (the point of the breaker)
                tracing.event("breaker-skip", node=nid,
                              method="propose")
                tried.append(nid)
                nid = None
                continue
            except _TimeoutError:
                timed_out = True
                tried.append(nid)
                nid = None
            attempt += 1
            time.sleep(self.ROUTE_POLICY.backoff(attempt,
                                                 self._retry_rng))
        if timed_out:
            # some attempt reached a peer and may still commit
            raise AmbiguousResultError(
                f"r{desc.range_id}: propose timed out "
                f"(tried {tried}); fate unknown")
        raise RuntimeError(
            f"r{desc.range_id}: no reachable leaseholder "
            f"(tried {tried})")

    def _route_read(self, desc, args: dict, first: int = None):
        tried = []
        attempt = 0
        nid = first if first is not None else \
            self._lease_cache.get(desc.range_id, desc.replicas[0])
        for _ in range(2 * len(desc.replicas) + 2):
            if nid is None or nid in tried:
                nid = next((n for n in desc.replicas
                            if n not in tried), None)
                if nid is None:
                    break
            if nid == self.node_id:
                # the lease may have moved HERE mid-retry (failover);
                # serve locally if our replica now holds it
                try:
                    return self._serve_read(args)
                except NotLeaseholderError as e:
                    tried.append(nid)
                    nid = e.hint
                continue
            try:
                with tracing.span("rpc-attempt", node=nid,
                                  attempt=attempt, method="read"):
                    r = self.call(nid, "read", args,
                                  timeout=self.READ_ATTEMPT_TIMEOUT)
                self._lease_cache[desc.range_id] = nid
                return r
            except NotLeaseholderError as e:
                tried.append(nid)
                nid = e.hint
            except BreakerTrippedError:
                tracing.event("breaker-skip", node=nid, method="read")
                tried.append(nid)   # fail fast to the next replica
                nid = None
                continue
            except _TimeoutError:
                tried.append(nid)
                nid = None
            attempt += 1
            time.sleep(self.ROUTE_POLICY.backoff(attempt,
                                                 self._retry_rng))
        raise RuntimeError(
            f"r{desc.range_id}: no reachable leaseholder for read")

    # -- membership / replication ------------------------------------------
    def _store_create_replica(self, nid: int,
                              desc: RangeDescriptor) -> None:
        if nid == self.node_id:
            with self._mu:
                if desc.range_id not in self.store.replicas:
                    self.store.create_replica(desc)
            return
        self.call(nid, "create_replica", {"desc": _desc_to_wire(desc)})

    def _store_remove_replica(self, nid: int, range_id: int) -> None:
        if nid == self.node_id:
            with self._mu:
                self.store.remove_replica(range_id)
            return
        try:
            self.call(nid, "remove_replica", {"range_id": range_id})
        except RuntimeError:
            pass  # dead node: the husk is collected when it rejoins

    def change_replicas(self, range_id: int, add: int = None,
                        remove: int = None) -> None:
        """Config change over the fabric: learner creation via RPC,
        the change itself through raft (replica_command.go)."""
        desc = self.descriptors[range_id]
        new = [n for n in desc.replicas if n != remove]
        if add is not None and add not in new:
            new.append(add)
        if remove is not None and not new:
            raise RuntimeError(f"r{range_id}: cannot remove last replica")
        newgen = desc.generation + 1
        if add is not None:
            self._store_create_replica(add, RangeDescriptor(
                range_id, desc.start_key, desc.end_key, list(new),
                newgen))
        rep_lh = self._leaseholder_replica(desc.start_key)
        self.propose_and_wait(rep_lh, {
            "kind": "change_replicas", "replicas": new,
            "generation": newgen})
        with self._mu:
            desc.replicas = new
            desc.generation = newgen
        if remove is not None:
            self._store_remove_replica(remove, range_id)
        self._announce_desc(desc)

    def replicate_queue_scan(self, target: int = 3) -> list[str]:
        """Up-replicate under-replicated ranges onto live peers."""
        actions = []
        with self._mu:
            live = sorted(n for n in
                          set(self._peers) | {self.node_id}
                          if self.liveness.is_live(n))
            descs = list(self.descriptors.values())
        for d in descs:
            live_members = [n for n in d.replicas if n in live]
            candidates = [n for n in live if n not in d.replicas]
            dead = [n for n in d.replicas if n not in live]
            if dead and len(live_members) > len(d.replicas) // 2 \
                    and candidates:
                addn = candidates[0]
                self.change_replicas(d.range_id, add=addn)
                self.change_replicas(d.range_id, remove=dead[0])
                actions.append(
                    f"r{d.range_id}: replace n{dead[0]} with n{addn}")
            elif len(d.replicas) < min(target, len(live)) \
                    and candidates:
                addn = candidates[0]
                self.change_replicas(d.range_id, add=addn)
                actions.append(f"r{d.range_id}: add n{addn}")
        return actions

    def split_range(self, key: bytes) -> RangeDescriptor:
        lhs = self.range_for_key(key)
        if lhs is None:
            raise KeyError(f"no range for {key!r}")
        if lhs.start_key == key:
            return lhs
        with self._mu:
            new_id = self._next_range_id
            self._next_range_id += 1
        rep = self._leaseholder_replica(lhs.start_key)
        self.propose_and_wait(rep, {
            "kind": "split", "key": key.decode("latin1"),
            "new_range_id": new_id})
        with self._mu:
            rhs = RangeDescriptor(new_id, key, lhs.end_key,
                                  list(lhs.replicas),
                                  generation=lhs.generation + 1)
            self.descriptors[new_id] = rhs
            lhs.end_key = key
            lhs.generation += 1
        self._announce_desc(lhs)
        self._announce_desc(rhs)
        return rhs

    def gc_txn_records(self, ttl_ns: int = int(3600e9)) -> int:
        """Local-leaseholder slice of the txn-record GC sweep: each
        node collects aged ABORTED records for the ranges it leads
        (the distributed form of the gc queue's per-leaseholder
        processing). The record filtering is the shared base-class
        sweep; only replica selection and the propose step differ."""
        n = 0
        now = self.clock.now().wall
        seen: set[bytes] = set()
        with self._mu:
            reps = [r for r in self.store.replicas.values()
                    if r.holds_lease()]
        for rep in reps:
            n += self._gc_replica_txn_records(
                rep, now, ttl_ns, seen,
                lambda r, cmd: self._local_propose(r, cmd))
        return n

    # surfaces of the in-process harness that have no meaning here
    def check_replica_consistency(self, range_id: int) -> None:
        return

    def tick_closed_ts(self) -> None:
        with self._mu:
            self.store.broadcast_closed_ts()
