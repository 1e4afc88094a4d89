"""Multi-host pod runtime: rendezvous, host topology, merge tree
(cockroach_tpu/parallel/multihost.py, its static half).

The sanctioned home for every cross-host rendezvous entry point.
Division of labour, as in the reference:

- **control plane**: rendezvous, host identity, address exchange and
  barriers ride a coordinator KV store. The reference uses
  jax.distributed's coordinator; the port uses
  ``torch.distributed.TCPStore`` with host 0 as its master (it needs no
  card and no collective backend, so it works on every machine,
  localhost included);
- **data plane**: cross-host rows ride the framed SocketTransport and
  DistSQL flows (rpc/context.py, distsql/), with partial aggregates
  merged up a host tree (``FlowSpec.merge_to/merge_children``) instead
  of fanning flat into the gateway;
- **device collectives** stay inside each process: ``global_mesh()``
  returns this process's cards (the reference's CPU rule; on a TPU pod
  the reference builds a hybrid ICI+DCN mesh, which the port does not).

The TCPStore has no conditional write and no key listing, so
``kv_cas`` and ``kv_list`` raise on it, as the reference's do on the
jax.distributed store. The degenerate pod (``num_processes == 1``)
keeps an in-process dict store that has both.

The elastic pod (``init_elastic``) runs a coordinator of its own: host 0
serves a small threaded TCP KV store (``_KVServer``: get, set, cas and
list, one JSON line each way) and every host, founding or late-joining,
reaches it through the ``kv_*`` entry points, which then support
``kv_cas`` and ``kv_list``. Membership is epoch'd (``Membership``), so
hosts can join or drain while statements run.

The per-host dispatcher process entry point is server/hostd.py.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

KV_PREFIX = "cockroach_tpu"
DEFAULT_FANOUT = 2
_KV_TIMEOUT_S = 60.0
# how long host 0 keeps serving the TCPStore at shutdown for the hosts
# that have not yet left (one that crashed never does)
_SHUTDOWN_WAIT_S = 30.0


@dataclass(frozen=True)
class HostTopology:
    """One host's view of the pod: who am I, how many of us, where is
    the coordinator, and the merge-tree shape."""

    process_id: int
    num_processes: int
    coordinator: str = ""
    fanout: int = DEFAULT_FANOUT

    @property
    def is_gateway(self) -> bool:
        return self.process_id == 0

    def parent(self) -> Optional[int]:
        return tree_parent(self.process_id, self.fanout)

    def children(self) -> list:
        return tree_children(self.process_id, self.num_processes,
                             self.fanout)


# module-global runtime state: one topology per process, guarded so
# back-to-back engines (and back-to-back tests in one process) never
# inherit a stale rendezvous; Engine.close tears this down.
_LOCK = threading.RLock()
_TOPOLOGY: Optional[HostTopology] = None
_STORE = None                 # the TCPStore of a pod of several hosts
_LOCAL_KV: dict = {}          # single-process fallback KV store
_TEARDOWNS: list = []         # cross-host dispatcher/pump teardown fns
_ELASTIC_CLIENT = None        # _KVClient to the elastic coordinator
_ELASTIC_SERVER = None        # _KVServer when this host coordinates
_MEMBERSHIP = None            # this host's Membership, when elastic
_MEMBERSHIP_FAULTS = None     # installed MembershipFaults (tests)


def topology() -> Optional[HostTopology]:
    return _TOPOLOGY


def is_active() -> bool:
    return _TOPOLOGY is not None


def num_hosts() -> int:
    m = _MEMBERSHIP
    if m is not None:
        try:
            return max(1, len(m.view().live))
        except Exception:
            pass        # KV torn down mid-scrape: fall through
    t = _TOPOLOGY
    return t.num_processes if t is not None else 1


def membership():
    """This host's Membership when the pod is elastic, else None."""
    return _MEMBERSHIP


def membership_faults():
    """The installed MembershipFaults, or None (production path)."""
    return _MEMBERSHIP_FAULTS


def install_membership_faults(faults) -> None:
    """Install (or clear, with None) membership-plane fault injection,
    the parallel/shuffle.install_link_faults idiom for the control
    plane: delayed or dropped heartbeats and stale-epoch lease claims.
    Consulted by Membership heartbeat loops and the shard-lease
    transition path (distsql/leases.py)."""
    global _MEMBERSHIP_FAULTS
    with _LOCK:
        _MEMBERSHIP_FAULTS = faults


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=max(float(seconds), 0.001))


def init_distributed(coordinator: str = "", num_processes: int = 1,
                     process_id: int = 0,
                     fanout: int = DEFAULT_FANOUT) -> HostTopology:
    """Join (or create) the pod rendezvous. Idempotent: re-initializing
    with the same shape returns the live topology; a different shape
    while live is a programming error (stale rendezvous: call
    shutdown_distributed first).

    With several processes, host 0 serves the TCPStore on the
    coordinator's ``host:port`` and waits (up to the KV timeout) until
    every host has connected; the others connect to it.
    ``num_processes == 1`` is the degenerate pod: no coordinator is
    contacted and the KV store is an in-process dict."""
    global _TOPOLOGY, _STORE
    with _LOCK:
        if _TOPOLOGY is not None:
            if (_TOPOLOGY.num_processes == num_processes
                    and _TOPOLOGY.process_id == process_id):
                return _TOPOLOGY
            raise RuntimeError(
                "multihost already initialized as "
                f"{_TOPOLOGY.process_id}/{_TOPOLOGY.num_processes}; "
                "shutdown_distributed() before re-joining with "
                f"{process_id}/{num_processes}")
        topo = HostTopology(process_id=int(process_id),
                            num_processes=int(num_processes),
                            coordinator=coordinator,
                            fanout=max(1, int(fanout)))
        if topo.num_processes > 1:
            host, _, port = coordinator.rpartition(":")
            if not host or not port:
                raise ValueError(f"coordinator {coordinator!r}: want "
                                 "host:port")
            from torch.distributed import TCPStore
            _STORE = TCPStore(host, int(port),
                              world_size=topo.num_processes,
                              is_master=topo.is_gateway,
                              timeout=_timeout(_KV_TIMEOUT_S),
                              wait_for_workers=True)
        _TOPOLOGY = topo
        return topo


def _leave_store(s, topo: HostTopology) -> None:
    """The shutdown barrier of a pod on a TCPStore (jax.distributed's
    shutdown holds one too): every host counts itself out, and host 0,
    which serves the store, waits up to _SHUTDOWN_WAIT_S for the last
    one. Without it host 0 could leave a barrier it arrived at last and
    take the store down while another host has yet to read that
    barrier's release."""
    try:
        n = int(s.add(_full("shutdown/left"), 1))
        if n == topo.num_processes:
            s.set(_full("shutdown/all"), "1")
        if topo.is_gateway:
            s.wait([_full("shutdown/all")], _timeout(_SHUTDOWN_WAIT_S))
    except Exception:
        pass  # a host that crashed never leaves; the store goes anyway


def shutdown_distributed() -> None:
    """Tear down the pod runtime: run registered cross-host teardowns
    (dispatcher pumps, transports), count this host out of the store
    (host 0 waits for every host to, then stops serving it), release
    the store client, and clear the topology. Idempotent and safe when
    never initialized, so Engine.close can always call it."""
    global _TOPOLOGY, _STORE, _MEMBERSHIP, _ELASTIC_CLIENT
    global _ELASTIC_SERVER
    with _LOCK:
        teardowns, _TEARDOWNS[:] = list(_TEARDOWNS), []
        for fn in reversed(teardowns):
            try:
                fn()
            except Exception:
                pass  # teardown is best-effort; state reset must win
        if _MEMBERSHIP is not None:
            try:
                _MEMBERSHIP.stop_heartbeat()
            except Exception:
                pass
            _MEMBERSHIP = None
        for closer in (_ELASTIC_CLIENT, _ELASTIC_SERVER):
            if closer is not None:
                try:
                    closer.close()
                except Exception:
                    pass
        _ELASTIC_CLIENT = _ELASTIC_SERVER = None
        store, topo = _STORE, _TOPOLOGY
        _STORE = None
        _TOPOLOGY = None
        _LOCAL_KV.clear()
    # outside the lock: host 0 may wait there for the other hosts; the
    # store is released when this frame lets go of it
    if store is not None and topo is not None:
        _leave_store(store, topo)


def register_teardown(fn: Callable[[], None]) -> None:
    """Register a cross-host resource (flow transport, pump thread)
    for shutdown_distributed to reap: run LIFO, errors swallowed."""
    with _LOCK:
        _TEARDOWNS.append(fn)


# ---------------------------------------------------------------------------
# coordinator KV store: address exchange + barriers
# ---------------------------------------------------------------------------

def _full(key: str) -> str:
    return f"{KV_PREFIX}/{key}"


def kv_set(key: str, value: str) -> None:
    e = _ELASTIC_CLIENT
    if e is not None:
        e.set(_full(key), str(value))
        return
    s = _STORE
    if s is None:
        with _LOCK:
            _LOCAL_KV[_full(key)] = str(value)
        return
    s.set(_full(key), str(value))


def kv_get(key: str, timeout_s: float = _KV_TIMEOUT_S) -> str:
    """The key's value, waiting up to ``timeout_s`` for it to be set
    (KeyError past that)."""
    e = _ELASTIC_CLIENT
    if e is not None:
        deadline = time.monotonic() + timeout_s
        while True:
            v = e.try_get(_full(key))
            if v is not None:
                return v
            if time.monotonic() > deadline:
                raise KeyError(key)
            time.sleep(0.01)
    s = _STORE
    if s is None:
        return _LOCAL_KV[_full(key)]
    try:
        s.wait([_full(key)], _timeout(timeout_s))
    except Exception as e:      # the store's timeout error
        raise KeyError(key) from e
    return s.get(_full(key)).decode()


def kv_try_get(key: str) -> Optional[str]:
    """Non-blocking read: the value, or None when unset. Membership
    scans poll with this (a missing heartbeat must read as silence,
    not a stall)."""
    e = _ELASTIC_CLIENT
    if e is not None:
        return e.try_get(_full(key))
    s = _STORE
    if s is None:
        with _LOCK:
            return _LOCAL_KV.get(_full(key))
    if not s.check([_full(key)]):
        return None
    return s.get(_full(key)).decode()


def kv_cas(key: str, expect: Optional[str], new: str) -> bool:
    """Atomic compare-and-set: write ``new`` iff the key currently
    holds ``expect`` (None = key absent). The epoch bump primitive:
    membership and lease transitions serialize on it, so a stale-epoch
    claim loses instead of double-owning a shard. Only the in-process
    and elastic stores support it: a static pod's TCPStore refuses, as
    the reference's jax.distributed store does (elastic pods run a
    coordinator of their own)."""
    e = _ELASTIC_CLIENT
    if e is not None:
        return e.cas(_full(key), expect, new)
    s = _STORE
    if s is None:
        with _LOCK:
            cur = _LOCAL_KV.get(_full(key))
            if cur != expect:
                return False
            _LOCAL_KV[_full(key)] = str(new)
            return True
    raise RuntimeError(
        "kv_cas requires the elastic (or in-process) KV backend; the "
        "pod's TCPStore has no conditional write")


def kv_list(prefix: str) -> dict:
    """{suffix: value} for every key under ``prefix`` (membership and
    lease-table scans): the in-process and elastic stores, like
    kv_cas."""
    e = _ELASTIC_CLIENT
    if e is not None:
        full = _full(prefix)
        return {k[len(full):]: v for k, v in e.list(full).items()}
    s = _STORE
    if s is None:
        full = _full(prefix)
        with _LOCK:
            return {k[len(full):]: v for k, v in _LOCAL_KV.items()
                    if k.startswith(full)}
    raise RuntimeError(
        "kv_list requires the elastic (or in-process) KV backend")


def barrier(name: str, timeout_s: float = _KV_TIMEOUT_S) -> None:
    """Wait until every host of the pod reached barrier ``name``: each
    arrival adds one to a counter; the last arrival of a round sets
    that round's release key, which everyone waits on. A name may be
    used again (each round has its own key). A no-op in the degenerate
    pod, and in an elastic one (its hosts rendezvous through membership
    epochs)."""
    if _ELASTIC_CLIENT is not None:
        return
    s, t = _STORE, _TOPOLOGY
    if s is None or t is None:
        return
    n = int(s.add(_full(f"barrier/{name}/count"), 1))
    rnd = (n - 1) // t.num_processes
    release = _full(f"barrier/{name}/release/{rnd}")
    if n % t.num_processes == 0:
        s.set(release, "1")
    try:
        s.wait([release], _timeout(timeout_s))
    except Exception as e:
        raise TimeoutError(
            f"barrier {name!r}: not every one of {t.num_processes} hosts "
            f"arrived within {timeout_s}s") from e


def publish_flow_addr(host: str, port: int) -> None:
    """Announce this host's DistSQL SocketTransport listener."""
    t = _TOPOLOGY
    if t is None:
        raise RuntimeError("multihost not initialized")
    kv_set(f"flowaddr/{t.process_id}", f"{host}:{port}")


def peer_flow_addrs(timeout_s: float = _KV_TIMEOUT_S) -> dict:
    """{process_id: (host, port)} for every host in the pod: blocks
    until each peer has published."""
    t = _TOPOLOGY
    if t is None:
        raise RuntimeError("multihost not initialized")
    out = {}
    for pid in range(t.num_processes):
        raw = kv_get(f"flowaddr/{pid}", timeout_s)
        host, _, port = raw.rpartition(":")
        out[pid] = (host, int(port))
    return out


# ---------------------------------------------------------------------------
# device mesh: host-local
# ---------------------------------------------------------------------------

def global_mesh(device=None) -> list:
    """The devices of the pod-wide mesh as this process sees them:
    its own cards, one slot each (raises without one), or ``[device]``
    when the caller names a device. Device collectives stay inside the
    host; the cross-host reduction rides the DistSQL merge tree (the
    reference's rule on the CPU; its TPU pods build a hybrid ICI+DCN
    mesh instead, which the port does not)."""
    if device is not None:
        return [torch.device(device)]
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("global_mesh: no CUDA device; pass device= "
                           "explicitly (e.g. 'cpu')")
    return [torch.device("cuda", i) for i in range(count)]


def addressable(device) -> bool:
    """Whether this process can place tensors on ``device``."""
    d = torch.device(device)
    if d.type == "cpu":
        return True
    if d.type == "cuda":
        idx = 0 if d.index is None else d.index
        return torch.cuda.is_available() and \
            idx < torch.cuda.device_count()
    return False


# ---------------------------------------------------------------------------
# merge tree: deterministic parent/children over host process ids
# ---------------------------------------------------------------------------

def tree_parent(pid: int, fanout: int = DEFAULT_FANOUT) -> Optional[int]:
    """Parent host in the k-ary merge tree (None for the root/gateway).
    Heap layout: parent(i) = (i-1)//fanout."""
    if pid <= 0:
        return None
    return (pid - 1) // max(1, fanout)


def tree_children(pid: int, n: int,
                  fanout: int = DEFAULT_FANOUT) -> list:
    """Child hosts of ``pid`` in an n-host pod (heap layout)."""
    f = max(1, fanout)
    kids = [f * pid + 1 + j for j in range(f)]
    return [k for k in kids if k < n]


def merge_depth(n: int, fanout: int = DEFAULT_FANOUT) -> int:
    """Tree height: hops a partial chunk takes worst-case to reach the
    gateway (1 for flat fan-in of <= fanout hosts)."""
    depth, pid = 0, n - 1
    while pid > 0:
        pid = tree_parent(pid, fanout)
        depth += 1
    return depth


# ---------------------------------------------------------------------------
# elastic pod: socket KV coordinator + dynamic membership 
# ---------------------------------------------------------------------------
# A static pod's store pins num_processes at rendezvous, so a host can
# never JOIN it. Elastic pods therefore run their own coordinator: host
# 0 serves a small threaded TCP KV store (get/set/cas/list, JSON lines)
# and every host, founding or late-joining, talks to it through the
# kv_* entry points above. The data plane is unchanged (framed
# SocketTransport flows); device collectives stay host-local.

class _KVServer:
    """Threaded TCP KV coordinator: one JSON request per line, one
    response per line. Linearizable by construction (every op runs
    under one lock), which is what gives kv_cas its meaning."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._data: dict = {}
        self._mu = threading.Lock()
        self._sock = socket.create_server((host, port))
        self.addr = self._sock.getsockname()[:2]
        self._closed = False
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn) -> None:
        f = conn.makefile("rwb")
        try:
            for line in f:
                try:
                    req = json.loads(line)
                except ValueError:
                    break
                resp = self._apply(req)
                f.write(json.dumps(resp).encode() + b"\n")
                f.flush()
        except (OSError, ValueError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _apply(self, req: dict) -> dict:
        op, k = req.get("op"), req.get("k")
        with self._mu:
            if op == "set":
                self._data[k] = req["v"]
                return {"ok": True}
            if op == "get":
                return {"ok": True, "v": self._data.get(k)}
            if op == "cas":
                cur = self._data.get(k)
                if cur != req.get("expect"):
                    return {"ok": False, "v": cur}
                self._data[k] = req["v"]
                return {"ok": True}
            if op == "list":
                return {"ok": True,
                        "kv": {kk: vv for kk, vv in self._data.items()
                               if kk.startswith(k)}}
        return {"ok": False, "error": f"bad op {op!r}"}

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class _KVClient:
    """One connection to the elastic coordinator; requests serialize
    on a lock (the membership/lease planes are low-rate control
    traffic — simplicity beats pipelining here)."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0):
        self._mu = threading.Lock()
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._f = self._sock.makefile("rwb")

    def _request(self, req: dict) -> dict:
        with self._mu:
            self._f.write(json.dumps(req).encode() + b"\n")
            self._f.flush()
            line = self._f.readline()
        if not line:
            raise ConnectionError("elastic KV coordinator gone")
        return json.loads(line)

    def set(self, k: str, v: str) -> None:
        self._request({"op": "set", "k": k, "v": str(v)})

    def try_get(self, k: str) -> Optional[str]:
        return self._request({"op": "get", "k": k}).get("v")

    def cas(self, k: str, expect: Optional[str], new: str) -> bool:
        return bool(self._request({"op": "cas", "k": k,
                                   "expect": expect,
                                   "v": str(new)}).get("ok"))

    def list(self, prefix: str) -> dict:
        return self._request({"op": "list",
                              "k": prefix}).get("kv", {})

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


@dataclass
class MembershipFaults:
    """Control-plane fault injection (install_membership_faults) —
    the membership analogue of shuffle.install_link_faults. Fields
    apply only to hosts listed in ``hosts`` (empty = all)."""

    heartbeat_delay_s: float = 0.0   # each beat sleeps first
    heartbeat_drop: int = 0          # swallow the next N beats
    stale_epoch_claims: bool = False  # lease transitions bid epoch-1
    hosts: tuple = ()                # affected host ids (() = all)

    def applies(self, host_id: int) -> bool:
        return not self.hosts or host_id in self.hosts


@dataclass(frozen=True)
class MemberView:
    """One epoch's converged member view: every host that reads epoch
    ``e`` resolves the SAME live set, because the view is written to
    the KV *before* the epoch CAS that publishes it."""

    epoch: int
    live: tuple
    members: dict = field(default_factory=dict, compare=False)


class Membership:
    """Join/leave epochs with heartbeat liveness over the pod KV —
    the gossip-style generalization of server/node.py's live_peers
    gate. Every transition (join, drain, leave, expel) writes the
    next epoch's full member view under ``mb/view/<e+1>`` and then
    CASes ``mb/epoch`` from e to e+1; losers of the race recompute
    and retry, so concurrent churn converges without a coordinator
    thread. Heartbeats (``mb/hb/<id>``) are wall-clock-stamped and
    incarnation-tagged: a host that rejoins with the same id bumps
    its incarnation, and beats from the old incarnation are ignored
    (no zombie can keep a dead member alive)."""

    HEARTBEAT_INTERVAL_S = 0.25
    LIVENESS_WINDOW_S = 2.0

    def __init__(self, host_id: int, addr: str = "", metrics=None,
                 heartbeat_interval: Optional[float] = None,
                 liveness_window: Optional[float] = None):
        self.host_id = int(host_id)
        self.addr = addr
        self.interval = float(heartbeat_interval
                              if heartbeat_interval is not None
                              else self.HEARTBEAT_INTERVAL_S)
        self.window = float(liveness_window
                            if liveness_window is not None
                            else self.LIVENESS_WINDOW_S)
        self.incarnation = 0
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        self._metrics = metrics
        if metrics is not None:
            self.m_epoch = metrics.gauge(
                "cluster.membership.epoch",
                "current pod membership epoch as last observed by "
                "this host's membership plane")
            self.m_live = metrics.gauge(
                "cluster.membership.live",
                "live members in the last observed epoch view")
            self.m_joins = metrics.counter(
                "cluster.membership.joins",
                "membership join transitions this host performed")
            self.m_expels = metrics.counter(
                "cluster.membership.expels",
                "members this host expelled after heartbeat silence")
            self.m_rejoins = metrics.counter(
                "cluster.membership.rejoins",
                "joins that re-used an existing member id (new "
                "incarnation fences the old one's leases)")
            self.m_beats = metrics.counter(
                "cluster.membership.heartbeats",
                "liveness heartbeats this host published")

    # -- KV records -------------------------------------------------
    def _member_key(self, hid: int) -> str:
        return f"mb/member/{hid}"

    def _read_members(self) -> dict:
        out = {}
        for suffix, raw in kv_list("mb/member/").items():
            try:
                out[int(suffix)] = json.loads(raw)
            except (ValueError, TypeError):
                continue
        return out

    def epoch(self) -> int:
        return int(kv_try_get("mb/epoch") or 0)

    def view(self, epoch: Optional[int] = None) -> MemberView:
        """The epoch'd member view. With no argument, the CURRENT
        epoch's; with one, that epoch's (walks to the newest view at
        or below it, since not every epoch rewrites every record)."""
        e = self.epoch() if epoch is None else int(epoch)
        probe = e
        while probe > 0:
            raw = kv_try_get(f"mb/view/{probe}")
            if raw is not None:
                d = json.loads(raw)
                v = MemberView(epoch=e, live=tuple(d["live"]),
                               members=d.get("members", {}))
                self._note_view(v)
                return v
            probe -= 1
        return MemberView(epoch=e, live=())

    def _note_view(self, v: MemberView) -> None:
        if self._metrics is not None:
            self.m_epoch.set(v.epoch)
            self.m_live.set(len(v.live))

    def _transition(self, mutate) -> int:
        """Run one membership transition: mutate the member records,
        publish the resulting view for epoch e+1, CAS the epoch.
        Retries until its CAS wins (concurrent churn converges)."""
        while True:
            e = self.epoch()
            before = self._read_members()
            members = mutate(dict(before))
            # write only the records this mutation changed: a losing
            # racer that rewrote EVERY record would clobber the
            # winner's concurrent transition with its stale read
            for hid, rec in members.items():
                if before.get(hid) != rec:
                    kv_set(self._member_key(hid), json.dumps(rec))
            live = sorted(h for h, r in members.items()
                          if r.get("state") in ("live", "draining"))
            view = {"live": live,
                    "members": {str(h): members[h] for h in live}}
            kv_set(f"mb/view/{e + 1}", json.dumps(view))
            if kv_cas("mb/epoch", str(e) if e else None, str(e + 1)):
                self._note_view(MemberView(e + 1, tuple(live)))
                return e + 1

    # -- lifecycle --------------------------------------------------
    def join(self) -> int:
        """Enter the pod (state=live). Re-using an id that already has
        a member record — a crashed host coming back — bumps the
        incarnation so the old life's heartbeats and lease claims are
        fenced, not merged."""
        raw = kv_try_get(self._member_key(self.host_id))
        prev = json.loads(raw) if raw else None
        rejoin = prev is not None
        self.incarnation = (1 if prev is None
                            else int(prev.get("inc", 0)) + 1)
        self.beat()     # liveness (new incarnation) predates visibility

        def mutate(members: dict) -> dict:
            members[self.host_id] = {"state": "live",
                                     "inc": self.incarnation,
                                     "addr": self.addr}
            return members
        e = self._transition(mutate)
        if self._metrics is not None:
            self.m_joins.inc()
            if rejoin:
                self.m_rejoins.inc()
        return e

    def drain(self) -> int:
        """Announce an orderly exit: still serving (state=draining,
        still in the live view) but planners stop placing NEW shard
        leases here; leave() completes the exit once leases moved."""
        def mutate(members: dict) -> dict:
            rec = dict(members.get(self.host_id)
                       or {"inc": self.incarnation, "addr": self.addr})
            rec["state"] = "draining"
            members[self.host_id] = rec
            return members
        return self._transition(mutate)

    def leave(self) -> int:
        def mutate(members: dict) -> dict:
            rec = dict(members.get(self.host_id)
                       or {"inc": self.incarnation, "addr": self.addr})
            rec["state"] = "left"
            members[self.host_id] = rec
            return members
        e = self._transition(mutate)
        self.stop_heartbeat()
        return e

    def expel(self, hid: int) -> int:
        """Convict a silent member (state=dead): called by the
        failover path after its heartbeat went stale. The epoch bump
        is what fences the dead host's in-flight lease claims."""
        def mutate(members: dict) -> dict:
            rec = dict(members.get(hid) or {"inc": 0, "addr": ""})
            rec["state"] = "dead"
            members[hid] = rec
            return members
        e = self._transition(mutate)
        if self._metrics is not None:
            self.m_expels.inc()
        return e

    # -- liveness ---------------------------------------------------
    def beat(self) -> None:
        """Publish one liveness heartbeat (wall-clock stamped: hosts
        are separate processes, so monotonic clocks don't compare)."""
        f = _MEMBERSHIP_FAULTS
        if f is not None and f.applies(self.host_id):
            if f.heartbeat_drop > 0:
                f.heartbeat_drop -= 1
                return
            if f.heartbeat_delay_s > 0:
                time.sleep(f.heartbeat_delay_s)
        kv_set(f"mb/hb/{self.host_id}",
               json.dumps({"inc": self.incarnation, "t": time.time()}))
        if self._metrics is not None:
            self.m_beats.inc()

    def alive(self, hid: int, now: Optional[float] = None) -> bool:
        """Heartbeat-liveness of one member: fresh beat, matching
        incarnation, and a live/draining record in the current view."""
        v = self.view()
        if hid not in v.live:
            return False
        rec = v.members.get(str(hid), {})
        raw = kv_try_get(f"mb/hb/{hid}")
        if raw is None:
            return False
        hb = json.loads(raw)
        if int(hb.get("inc", -1)) != int(rec.get("inc", -2)):
            return False
        now = time.time() if now is None else now
        return (now - float(hb.get("t", 0.0))) <= self.window

    def suspects(self, hids) -> list:
        """The subset of ``hids`` whose heartbeats have gone stale —
        failover conviction candidates."""
        return [h for h in hids
                if h != self.host_id and not self.alive(h)]

    def expelled(self) -> bool:
        """Has some OTHER host convicted us? (Our record is dead, or
        a rejoin under our id outran us.) A live host that sees this
        must re-join with a fresh incarnation, not keep serving."""
        raw = kv_try_get(self._member_key(self.host_id))
        if raw is None:
            return False
        rec = json.loads(raw)
        return (rec.get("state") == "dead"
                or int(rec.get("inc", 0)) != self.incarnation)

    def start_heartbeat(self) -> None:
        if self._hb_thread is not None:
            return
        self._hb_stop.clear()

        def loop():
            while not self._hb_stop.wait(self.interval):
                try:
                    self.beat()
                except Exception:
                    return      # KV gone: the pod is tearing down
        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()
        t, self._hb_thread = self._hb_thread, None
        if t is not None:
            t.join(timeout=2.0)


def init_elastic(host_id: int, kv_addr: str = "",
                 serve_kv: bool = False,
                 fanout: int = DEFAULT_FANOUT,
                 metrics=None,
                 heartbeat_interval: Optional[float] = None,
                 liveness_window: Optional[float] = None) -> Membership:
    """Join (or found, with serve_kv) an ELASTIC pod: no TCPStore, no
    fixed num_processes; the kv_* entry points
    route to the socket coordinator and membership is epoch'd, so
    hosts can join or drain while statements run. Returns this host's
    Membership (not yet joined — callers join once their shards are
    streamed, so a joining host becomes visible only when servable).

    The degenerate in-process form (no kv_addr, no serve_kv) rides the
    _LOCAL_KV dict: N Membership instances in ONE process share it,
    which is exactly what the fast-lane churn tests need."""
    global _ELASTIC_CLIENT, _ELASTIC_SERVER, _MEMBERSHIP, _TOPOLOGY
    server = client = None
    if serve_kv:
        server = _KVServer()
        kv_addr = "%s:%d" % server.addr
    if kv_addr:
        h, _, p = kv_addr.rpartition(":")
        client = _KVClient(h or "127.0.0.1", int(p))
    m = Membership(host_id, metrics=metrics,
                   heartbeat_interval=heartbeat_interval,
                   liveness_window=liveness_window)
    with _LOCK:
        if _ELASTIC_SERVER is None:
            _ELASTIC_SERVER = server
        if client is not None:
            _ELASTIC_CLIENT = client
        _MEMBERSHIP = m
        if _TOPOLOGY is None:
            _TOPOLOGY = HostTopology(process_id=int(host_id),
                                     num_processes=1,
                                     coordinator=kv_addr,
                                     fanout=max(1, int(fanout)))
    return m


def elastic_kv_addr() -> str:
    """host:port of the coordinator this host serves ('' when it
    doesn't) — founding host 0 publishes this for late joiners."""
    s = _ELASTIC_SERVER
    return "%s:%d" % s.addr if s is not None else ""


def env_topology() -> Optional[HostTopology]:
    """Topology from COCKROACH_TPU_MULTIHOST_* env vars (hostd's
    children and bench subprocesses pass identity this way), or None
    when unset."""
    n = os.environ.get("COCKROACH_TPU_MULTIHOST_PROCS")
    if n is None:
        return None
    return HostTopology(
        process_id=int(os.environ.get("COCKROACH_TPU_MULTIHOST_ID", "0")),
        num_processes=int(n),
        coordinator=os.environ.get("COCKROACH_TPU_MULTIHOST_COORD", ""),
        fanout=int(os.environ.get("COCKROACH_TPU_MULTIHOST_FANOUT",
                                  str(DEFAULT_FANOUT))))
