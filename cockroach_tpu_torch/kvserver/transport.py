"""In-process message transport with fault injection
(cockroach_tpu/kvserver/transport.py).

Plays the role of the reference's gRPC raft transport
(``pkg/kv/kvserver/raft_transport.go``) for in-process clusters, the
way ``testcluster.StartTestCluster`` wires N real servers over real RPC
in one process (``pkg/testutils/testcluster/testcluster.go:58``).

Deterministic: messages are queued and delivered when the cluster pump
drains them; tests can drop, delay, or partition traffic (the analogue
of the reference's TestingKnobs raft-message filters,
``pkg/kv/kvserver/testing_knobs.go``).
"""

from __future__ import annotations

import random
from collections import deque
from typing import Callable, Optional


class LocalTransport:
    def __init__(self, rng: Optional[random.Random] = None):
        self._handlers: dict[int, Callable] = {}
        self._queues: dict[int, deque] = {}
        self._partitions: set[frozenset] = set()
        self._down: set[int] = set()
        self._drop_prob = 0.0
        self._rng = rng or random.Random(0)
        self.sent = 0
        self.delivered = 0
        self.dropped = 0

    def register(self, node_id: int, handler: Callable) -> None:
        if node_id in self._handlers and \
                self._handlers[node_id] is not handler:
            # A Store and a DistSQL node sharing one transport would
            # silently clobber each other's delivery; demand distinct
            # transports (or explicit re-registration of the same
            # handler, which restart paths legitimately do).
            raise ValueError(
                f"transport: node {node_id} already registered with a "
                "different handler")
        self._handlers[node_id] = handler
        self._queues.setdefault(node_id, deque())

    # -- fault injection -------------------------------------------
    def partition(self, a: int, b: int) -> None:
        self._partitions.add(frozenset((a, b)))

    def heal(self, a: Optional[int] = None, b: Optional[int] = None) -> None:
        if a is None:
            self._partitions.clear()
        else:
            self._partitions.discard(frozenset((a, b)))

    def stop_node(self, node_id: int) -> None:
        self._down.add(node_id)
        self._queues[node_id].clear()

    def restart_node(self, node_id: int) -> None:
        self._down.discard(node_id)

    def set_drop_prob(self, p: float) -> None:
        self._drop_prob = p

    def _blocked(self, frm: int, to: int) -> bool:
        if frm in self._down or to in self._down:
            return True
        return frozenset((frm, to)) in self._partitions

    # -- delivery ---------------------------------------------------
    def send(self, frm: int, to: int, msg) -> None:
        self.sent += 1
        if to not in self._handlers or self._blocked(frm, to) or \
                (self._drop_prob and self._rng.random() < self._drop_prob):
            self.dropped += 1
            return
        self._queues[to].append((frm, msg))

    def deliver_all(self) -> int:
        """Drain every queue once; returns messages delivered."""
        n = 0
        for node_id, q in self._queues.items():
            batch, q2 = list(q), q
            q2.clear()
            for frm, msg in batch:
                if self._blocked(frm, node_id) or node_id in self._down:
                    self.dropped += 1
                    continue
                self._handlers[node_id](frm, msg)
                n += 1
        self.delivered += n
        return n

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())


class ChaosTransport(LocalTransport):
    """LocalTransport with a seeded adversarial delivery schedule:
    per-queue message REORDERING, DUPLICATION, and DELAY (requeue for a
    later pump). The raft/MVCC planes must converge to identical state
    regardless — the in-process stand-in for the reference's kvnemesis
    + raft message-race coverage, which our strictly-FIFO default
    transport cannot exercise."""

    def __init__(self, seed: int = 0, p_dup: float = 0.1,
                 p_delay: float = 0.15, shuffle: bool = True):
        super().__init__(rng=random.Random(seed))
        self.p_dup = p_dup
        self.p_delay = p_delay
        self.shuffle = shuffle

    def deliver_all(self) -> int:
        n = 0
        for node_id, q in self._queues.items():
            batch = list(q)
            q.clear()
            if self.shuffle:
                self._rng.shuffle(batch)
            for frm, msg in batch:
                if self._blocked(frm, node_id) or node_id in self._down:
                    self.dropped += 1
                    continue
                if self._rng.random() < self.p_delay:
                    q.append((frm, msg))  # deliver on a later pump
                    continue
                self._handlers[node_id](frm, msg)
                n += 1
                if self._rng.random() < self.p_dup:
                    self._handlers[node_id](frm, msg)  # duplicate
                    n += 1
        self.delivered += n
        return n
