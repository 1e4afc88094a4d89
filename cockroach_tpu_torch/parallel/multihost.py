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

The elastic pod (the reference's ``Membership``, ``_KVServer`` and
``init_elastic``, ``:404-844``) is not ported yet: its module state
stays here as ``None`` so that ``num_hosts`` and
``shutdown_distributed`` read and reset it as the reference does.

The per-host dispatcher process entry point is server/hostd.py.
"""

from __future__ import annotations

import datetime
import os
import threading
from dataclasses import dataclass
from typing import Callable, Optional

import torch

KV_PREFIX = "cockroach_tpu"
DEFAULT_FANOUT = 2
_KV_TIMEOUT_S = 60.0


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
_MEMBERSHIP = None            # the elastic pod's Membership (not ported)


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


def shutdown_distributed() -> None:
    """Tear down the pod runtime: run registered cross-host teardowns
    (dispatcher pumps, transports), release the store client (host 0's
    also stops serving it), and clear the topology. Idempotent and safe
    when never initialized, so Engine.close can always call it."""
    global _TOPOLOGY, _STORE, _MEMBERSHIP
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
        _STORE = None
        _TOPOLOGY = None
        _LOCAL_KV.clear()


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
    s = _STORE
    if s is None:
        with _LOCK:
            _LOCAL_KV[_full(key)] = str(value)
        return
    s.set(_full(key), str(value))


def kv_get(key: str, timeout_s: float = _KV_TIMEOUT_S) -> str:
    """The key's value, waiting up to ``timeout_s`` for it to be set
    (KeyError past that)."""
    s = _STORE
    if s is None:
        return _LOCAL_KV[_full(key)]
    try:
        s.wait([_full(key)], _timeout(timeout_s))
    except Exception as e:      # the store's timeout error
        raise KeyError(key) from e
    return s.get(_full(key)).decode()


def kv_try_get(key: str) -> Optional[str]:
    """Non-blocking read: the value, or None when unset."""
    s = _STORE
    if s is None:
        with _LOCK:
            return _LOCAL_KV.get(_full(key))
    if not s.check([_full(key)]):
        return None
    return s.get(_full(key)).decode()


def kv_cas(key: str, expect: Optional[str], new: str) -> bool:
    """Atomic compare-and-set: write ``new`` iff the key currently
    holds ``expect`` (None = key absent). Only the in-process store
    supports it: a pod of several hosts refuses, as the reference's
    does on the jax.distributed store (its elastic pods, which need
    CAS, run a coordinator of their own)."""
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
    """{suffix: value} for every key under ``prefix``: the in-process
    store only, like kv_cas."""
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
    pod."""
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
