"""Gossip: eventually-consistent cluster info propagation
(cockroach_tpu/rpc/gossip.py, ported as it stands).

The analogue of pkg/gossip (gossip.go:217 Gossip, AddInfo/GetInfo
:895,943): a per-node info store of (key -> value, timestamp, origin)
entries merged by highest (timestamp, origin), exchanged with peers in
rounds. Carries what the reference gossips first: node addresses,
cluster settings (Settings.on_change -> gossip ->
Settings.apply_snapshot on every other node), store descriptors.

Transport-agnostic: rides anything with the LocalTransport interface
(send/register/deliver_all) — the in-process queue for deterministic
tests or rpc.SocketTransport across processes. Rounds are explicit
``tick()`` calls (a Node wires them to a background loop), which may
run on a different thread than add_info callers (pgwire sessions), so
the info store is lock-guarded.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Optional

KIND = "__gossip__"


class Gossip:
    def __init__(self, node_id: int, transport, peers: list[int],
                 now: Callable[[], float] = time.time,
                 fanout: int = 2):
        self.node_id = node_id
        self.transport = transport
        self.peers = [p for p in peers if p != node_id]
        self.now = now
        self.fanout = max(1, fanout)
        # key -> (value, ts, origin); (ts, origin) totally orders
        # entries so concurrent same-ts writes on two nodes converge
        # (higher node id wins) instead of diverging forever
        self.infos: dict[str, tuple] = {}
        self._mu = threading.Lock()
        self._watchers: list[Callable[[str, object], None]] = []
        self._rr = itertools.count()

    # -- info store ----------------------------------------------------------
    def add_info(self, key: str, value, ts: Optional[float] = None) -> None:
        t = self.now() if ts is None else ts
        with self._mu:
            cur = self.infos.get(key)
            if cur is not None and t <= cur[1]:
                # a local write must always win locally (and then
                # propagate): bump past the resident entry rather than
                # silently losing the update to a clock-resolution tie
                t = cur[1] + 1e-6
            self.infos[key] = (value, t, self.node_id)
        self._notify(key, value)

    def get_info(self, key: str):
        with self._mu:
            e = self.infos.get(key)
        return e[0] if e is not None else None

    def on_update(self, fn: Callable[[str, object], None]) -> None:
        self._watchers.append(fn)

    def _notify(self, key: str, value) -> None:
        for w in self._watchers:
            w(key, value)

    # -- exchange ------------------------------------------------------------
    def handle(self, frm: int, msg) -> bool:
        """Merge an incoming gossip payload; returns True if it was a
        gossip message (dispatchers route non-gossip elsewhere)."""
        if not (isinstance(msg, dict) and msg.get("kind") == KIND):
            return False
        updated = []
        with self._mu:
            for key, (value, ts, origin) in msg["infos"].items():
                cur = self.infos.get(key)
                if cur is None or (ts, origin) > (cur[1], cur[2]):
                    self.infos[key] = (value, ts, origin)
                    updated.append((key, value))
        for key, value in updated:
            self._notify(key, value)
        return True

    def tick(self) -> None:
        """One round: push the full info map to `fanout` peers, round-
        robin (the reference pushes deltas along a connected overlay;
        full-state push keeps convergence trivially correct at our
        cluster sizes)."""
        if not self.peers:
            return
        with self._mu:
            payload = {"kind": KIND,
                       "infos": {k: [v, ts, o]
                                 for k, (v, ts, o) in self.infos.items()}}
        for _ in range(min(self.fanout, len(self.peers))):
            peer = self.peers[next(self._rr) % len(self.peers)]
            self.transport.send(self.node_id, peer, payload)


def wire_settings(gossip: Gossip, settings) -> None:
    """Propagate cluster settings through gossip (SET CLUSTER SETTING
    on any node converges everywhere; the reference's system-config
    gossip). Suppression of the publish-back loop is per-key: the
    gossip thread applying remote setting X must not swallow a
    concurrent local SET of setting Y from a pgwire thread."""
    applying: set[str] = set()

    def on_change(name, value):
        if name in applying:
            return  # change came FROM gossip; don't re-publish
        gossip.add_info(f"setting:{name}", value)

    def on_gossip(key, value):
        if not key.startswith("setting:"):
            return
        name = key.split(":", 1)[1]
        applying.add(name)
        try:
            settings.set(name, value)
        except Exception:
            pass  # unknown/invalid on this node's version: skip
        finally:
            applying.discard(name)

    settings.on_change(on_change)
    gossip.on_update(on_gossip)
