"""Fabric liveness: RPC heartbeats, peer breakers, clock-skew checks
(cockroach_tpu/rpc/heartbeat.py, ported as it stands).

The analogue of pkg/rpc/heartbeat.go (PingRequest/PingResponse on
every connection) and pkg/rpc/clock_offset.go (RemoteClockMonitor):
each node periodically pings its peers over the same fabric its
subsystems use; a peer that misses enough rounds trips a per-peer
breaker (so callers fail fast instead of queueing into a dead
connection), and a restarted peer heals the breaker on its first
successful round — no operator action. Pong timestamps yield a
clock-offset estimate (the midpoint method the reference uses); peers
whose offset exceeds the bound are marked unhealthy, the fabric-level
guard behind the HLC's monotonicity assumptions.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

PING = "rpc_ping"
PONG = "rpc_pong"


class LivenessMonitor:
    """Adapter: expose a kvserver liveness view through the
    ``healthy(node)`` surface the DistSQL gateway consumes (its
    ``monitor`` slot), so flow scheduling and the mid-flow fail-fast
    poll judge producers by the same records lease validity uses
    (kvserver/liveness.py) instead of needing a second heartbeat
    plane. Accepts anything with ``is_live(node_id)`` — a
    NodeLiveness, or a Cluster via its ``.liveness``."""

    def __init__(self, liveness):
        self.liveness = getattr(liveness, "liveness", liveness)

    def healthy(self, peer: int) -> bool:
        return bool(self.liveness.is_live(peer))


class PeerMonitor:
    """Heartbeats for one node's view of its peers.

    Wire into the node's fabric dispatch (server/node.py): ``handle``
    consumes PING/PONG messages (returns False for anything else), and
    the gossip loop calls ``tick`` each interval.
    """

    def __init__(self, node_id: int, transport,
                 now_ns: Optional[Callable[[], int]] = None,
                 miss_limit: int = 3,
                 max_offset_ns: int = 500_000_000):
        self.node_id = node_id
        self.transport = transport
        self.now_ns = now_ns or time.monotonic_ns
        self.wall_ns = time.time_ns
        self.miss_limit = miss_limit
        self.max_offset_ns = max_offset_ns
        # peer -> state
        self.misses: dict[int, int] = {}
        self.rtt_ns: dict[int, int] = {}
        self.offset_ns: dict[int, int] = {}
        self._awaiting: dict[int, int] = {}   # peer -> ping send time
        self.skewed: set[int] = set()
        self._m_rtt = None                    # attach_metrics installs

    def attach_metrics(self, reg) -> None:
        """rpc.heartbeat.* in a MetricRegistry: an RTT histogram fed
        per PONG plus live gauges over the peer state maps."""
        self._m_rtt = reg.histogram(
            "rpc.heartbeat.rtt.seconds",
            "heartbeat round-trip time per PONG")
        reg.func_gauge("rpc.heartbeat.unhealthy.peers",
                       lambda: len(self.tripped_peers()),
                       "peers past the miss limit or skewed")
        reg.func_gauge("rpc.heartbeat.skewed.peers",
                       lambda: len(self.skewed),
                       "peers with clock offset beyond the bound")

    # -- health --------------------------------------------------------------
    def healthy(self, peer: int) -> bool:
        """False once the peer missed ``miss_limit`` rounds or its
        clock offset exceeds the bound (tripped breaker)."""
        if peer in self.skewed:
            return False
        return self.misses.get(peer, 0) < self.miss_limit

    def tripped_peers(self) -> list[int]:
        return sorted(p for p in self.misses
                      if not self.healthy(p))

    # -- the heartbeat round -------------------------------------------------
    def tick(self, peers=None) -> None:
        """One round: count the previous round's unanswered pings as
        misses, then ping every peer."""
        targets = list(peers if peers is not None
                       else getattr(self.transport, "_peers", {}))
        for p in list(self._awaiting):
            self.misses[p] = self.misses.get(p, 0) + 1
            del self._awaiting[p]
        for p in targets:
            if p == self.node_id:
                continue
            t0 = self.now_ns()
            self._awaiting[p] = t0
            self.misses.setdefault(p, 0)
            self.transport.send(self.node_id, p, {
                "kind": PING, "t_mono": t0, "t_wall": self.wall_ns()})

    def handle(self, frm: int, msg) -> bool:
        if not isinstance(msg, dict):
            return False
        kind = msg.get("kind")
        if kind == PING:
            self.transport.send(self.node_id, frm, {
                "kind": PONG, "t_mono": msg["t_mono"],
                "their_wall": msg["t_wall"],
                "my_wall": self.wall_ns()})
            return True
        if kind == PONG:
            now = self.now_ns()
            rtt = now - int(msg["t_mono"])
            self.rtt_ns[frm] = rtt
            if self._m_rtt is not None:
                self._m_rtt.observe(rtt / 1e9)
            # midpoint clock-offset estimate (clock_offset.go): the
            # remote read happened ~rtt/2 after our send
            est = int(msg["my_wall"]) - (int(msg["their_wall"])
                                         + rtt // 2)
            self.offset_ns[frm] = est
            if abs(est) > self.max_offset_ns:
                self.skewed.add(frm)
            else:
                self.skewed.discard(frm)
                # a successful, in-bounds round heals the breaker:
                # restarted peers reintegrate with no operator action
                self.misses[frm] = 0
            self._awaiting.pop(frm, None)
            return True
        return False
